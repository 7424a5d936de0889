import numpy as np
import pytest

from portbench import control, harness, reference
from portbench.builders import deployments

from .test_inputs import config


@pytest.fixture(scope="module")
def setup():
    inp = deployments.Inputs(config("delta_50k"), 4)
    cat = reference.Catalog(inp.records)
    pods = inp.cell_pods(0)
    nodes, cost = control.pack(cat, inp.counts(0), inp.demand, inp.pool(0), "alloc")
    return inp, cat, pods, control._names(nodes, pods), cost


def check(setup, nodes, cost=None):
    inp, cat, pods, _, c = setup
    return reference.check_plan(cat, pods, inp.demand, inp.pool(0), nodes, [],
                                c if cost is None else cost)


def failing(numbers):
    return [k for k, v in numbers.items() if v > harness.LIMITS[k]]


def test_allocatable_packer_passes(setup):
    assert failing(check(setup, setup[3])) == []


def test_one_pod_dropped_fails(setup):
    nodes = [list(n) for n in setup[3]]
    nodes[0][5] = nodes[0][5][1:]
    assert failing(check(setup, [tuple(n) for n in nodes])) == ["misplaced"]


def test_one_pod_twice_fails(setup):
    nodes = [list(n) for n in setup[3]]
    nodes[1][5] = nodes[1][5] + nodes[0][5][:1]
    assert "misplaced" in failing(check(setup, [tuple(n) for n in nodes]))


def test_one_node_over_allocatable_fails(setup):
    inp, cat, pods, nodes, _ = setup
    nodes = [list(n) for n in nodes]
    # the first node of a deployment that spans two nodes is full: one more
    # pod of the deployment, moved from its second node, goes over
    i = next(i for i in range(len(nodes) - 1)
             if pods[nodes[i][5][0]] == pods[nodes[i + 1][5][0]])
    moved = nodes[i + 1][5][0]
    nodes[i + 1][5] = nodes[i + 1][5][1:]
    nodes[i][5] = nodes[i][5] + [moved]
    assert failing(check(setup, [tuple(n) for n in nodes])) == ["over_alloc"]


def test_node_on_an_unknown_offering_or_pool_fails(setup):
    nodes = [list(n) for n in setup[3]]
    nodes[0][2] = "zone-z"
    nodes[1][0] = "another-pool"
    assert check(setup, [tuple(n) for n in nodes])["bad_nodes"] == 2


def test_reported_cost_must_be_the_catalogs(setup):
    assert failing(check(setup, setup[3], cost=setup[4] * 1.0001)) == ["cost_gap"]


def test_control_breaks_the_allocatable_guarantee(setup):
    """The control, the packer filling nodes to capacity, fails the check."""
    inp, cat, pods, _, _ = setup
    nodes, cost = control.pack(cat, inp.counts(0), inp.demand, inp.pool(0), "capacity")
    numbers = check(setup, control._names(nodes, pods), cost)
    assert failing(numbers) == ["over_alloc"]
    assert numbers["over_alloc"] > 0


def test_encode_gap_counts_pods_by_request_shape(setup):
    inp, _, pods, _, _ = setup
    per_shape = {}
    for name, d in pods.items():
        key = (inp.demand[d, 0] / 1000.0, float(inp.demand[d, 1]))
        per_shape[key] = per_shape.get(key, 0) + 1
    groups = [(c, m, n) for (c, m), n in per_shape.items()]
    assert reference.encode_gap(pods, inp.demand, groups) == 0
    groups[0] = (groups[0][0], groups[0][1], groups[0][2] - 3)
    assert reference.encode_gap(pods, inp.demand, groups) == 3


def test_lower_bound_is_below_any_feasible_plan(setup):
    inp, cat, _, _, cost = setup
    lb = cat.lower_bound(inp.counts(0), inp.demand)
    assert 0 < lb <= cost
    assert cat.lower_bound(2 * inp.counts(0), inp.demand) == pytest.approx(2 * lb)
    assert np.isfinite(lb)


def test_roofline_shapes_come_from_the_raw_counts(setup):
    """S is the node count of the reference packer's plan: no plan of the
    program's enters the roofline's count."""
    inp, cat, _, nodes, _ = setup
    G, O, S = cat.shapes(inp.counts(0), inp.demand)
    assert S == len(nodes)
    assert O == len(cat.price)
    assert G == len({tuple(r) for r in inp.demand[inp.counts(0) > 0].tolist()})
    assert cat.shapes(2 * inp.counts(0), inp.demand)[2] >= S
