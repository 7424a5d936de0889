"""The kernel path end to end on the CPU: the port's ``encode`` and
``TorchSolver(device="cpu")._solve_kernel`` against the JAX package's
``encode`` and ``TPUSolver(auto_mesh=False)._solve_kernel`` on the same pods,
catalog and existing nodes, built with each package's API.

Both must open the same nodes (instance type, zone, capacity type, and the
pods on each), report the same unschedulable pods and cost the same to 1e-9
relative; the port's plan must validate and come from the kernel path. The
race around it (``TorchSolver.solve``) is held to the reference in
``test_torch_race.py``.
"""

import functools

import numpy as np
import pytest
import torch

import bench
from karpenter_tpu.solver import TPUSolver
from karpenter_tpu.solver import encode as ref_encode
from karpenter_tpu_torch import configs
from karpenter_tpu_torch.solver import TorchSolver, encode, validate
from karpenter_tpu_torch.solver import torch_solver as ts


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run on small tensors, as fast on one intra-op
    thread; the other cores stay free for the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plan(result):
    nodes = sorted(
        (n.option.instance_type.name, n.option.zone, n.option.capacity_type,
         tuple(sorted(n.pod_names)))
        for n in result.new_nodes
    )
    existing = {k: sorted(v) for k, v in result.existing_assignments.items()}
    return nodes, existing, sorted(result.unschedulable)


def _ref_existing(n):
    """``n`` in-flight nodes with bound capacity, as ``bench.config_20k_repack``
    builds them, for both packages."""
    import karpenter_tpu.api as rapi
    import karpenter_tpu_torch.api as papi
    from karpenter_tpu.cloudprovider import generate_catalog as rcat
    from karpenter_tpu.solver import ExistingNode as RNode
    from karpenter_tpu_torch.cloudprovider import generate_catalog as pcat
    from karpenter_tpu_torch.solver import ExistingNode as PNode

    out = []
    for api, cat, EN in ((rapi, rcat(n_types=40), RNode), (papi, pcat(n_types=40), PNode)):
        wk = api.labels
        rng = np.random.default_rng(7)
        mids = [it for it in cat if 8 <= it.capacity["cpu"] <= 32]
        nodes = []
        for i in range(n):
            it = mids[int(rng.integers(0, len(mids)))]
            node = api.Node(
                meta=api.ObjectMeta(name=f"node-{i}", labels={
                    **it.requirements.labels(), wk.ZONE: ["zone-a", "zone-b", "zone-c"][i % 3],
                    wk.PROVISIONER_NAME: "default", wk.INSTANCE_TYPE: it.name,
                }),
                capacity=it.capacity, allocatable=it.allocatable(), ready=True,
                unschedulable=i % 5 == 0,
            )
            remaining = it.allocatable() * (1.0 - float(rng.uniform(0.5, 0.9)))
            nodes.append(EN(node=node, remaining=remaining))
        out.append(nodes)
    return out


def _small_topology():
    """``config_10k_topology`` at a tenth of its pods."""
    def shapes(api):
        wk = api.labels
        rows = []
        for i in range(8):
            rows.append((f"svc{i}", 120, ["250m", "500m"][i % 2], ["512Mi", "1Gi"][i % 2], {
                "labels": {"app": f"svc{i}"},
                "spread": [api.TopologySpreadConstraint(max_skew=1, topology_key=wk.ZONE,
                                                        label_selector={"app": f"svc{i}"})],
            }))
        for i in range(4):
            rows.append((f"db{i}", 10, "1", "4Gi", {
                "labels": {"app": f"db{i}"},
                "affinity": [api.PodAffinityTerm(label_selector={"app": f"db{i}"},
                                                 topology_key=wk.HOSTNAME, anti=True)],
            }))
        return rows
    return shapes


def _small_crossgroup():
    """``config_10k_crossgroup`` at a tenth of its pods."""
    def shapes(api):
        wk = api.labels
        rows = []
        for i in range(4):
            rows.append((f"db{i}", 15, "1", "2Gi", {"labels": {"app": f"db{i}", "tier": "data"}}))
            rows.append((f"web{i}", 60, "250m", "512Mi", {
                "labels": {"app": f"web{i}"},
                "affinity": [api.PodAffinityTerm({"app": f"db{i}"}, wk.HOSTNAME)],
            }))
        front = [api.TopologySpreadConstraint(max_skew=1, topology_key=wk.ZONE,
                                              label_selector={"tier": "front"})]
        for i in range(4):
            rows.append((f"front{i}", 150, ["250m", "500m"][i % 2], ["512Mi", "1Gi"][i % 2], {
                "labels": {"app": f"front{i}", "tier": "front"}, "spread": front}))
        rows.append(("filler", 100, "500m", "1Gi", {}))
        return rows
    return shapes


def _build(shapes_fn, n_types, existing=()):
    import karpenter_tpu.api as rapi
    import karpenter_tpu_torch.api as papi
    from karpenter_tpu.cloudprovider import generate_catalog as rcat
    from karpenter_tpu_torch.cloudprovider import generate_catalog as pcat

    def pods(api, rows):
        return [
            api.Pod(meta=api.ObjectMeta(name=f"{p}-{j}", labels=dict(kw.get("labels", {}))),
                    requests=api.Resources(cpu=cpu, memory=mem),
                    topology_spread=list(kw.get("spread", [])),
                    affinity_terms=list(kw.get("affinity", [])))
            for p, n, cpu, mem, kw in rows for j in range(n)
        ]

    ex_r, ex_p = existing if existing else ([], [])
    ref = ref_encode(pods(rapi, shapes_fn(rapi)),
                     [(rapi.Provisioner(meta=rapi.ObjectMeta(name="default")), rcat(n_types=n_types))], ex_r)
    port = encode(pods(papi, shapes_fn(papi)),
                  [(papi.Provisioner(meta=papi.ObjectMeta(name="default")), pcat(n_types=n_types))], ex_p)
    return ref, port


def _case(name):
    if name == "full_2k":
        ref = ref_encode(*bench._config_full(2000, 40))
        port = encode(*configs.config_full(2000, 40))
        return ref, port
    if name == "topology_1k":
        return _build(_small_topology(), 60)
    if name == "crossgroup_1k":
        return _build(_small_crossgroup(), 60)
    if name == "existing_nodes":
        def rows(api):
            return [("a", 300, "250m", "512Mi", {}), ("b", 200, "500m", "1Gi", {}),
                    ("c", 100, "1", "2Gi", {})]
        return _build(rows, 40, existing=_ref_existing(60))
    if name == "topology_10k":
        return ref_encode(*bench.config_10k_topology()), encode(*configs.config_10k_topology())
    raise ValueError(name)


@pytest.mark.parametrize(
    "name", ["full_2k", "topology_1k", "crossgroup_1k", "existing_nodes", "topology_10k"]
)
def test_slice_matches_reference(name):
    ref_problem, problem = _case(name)
    expect = TPUSolver(auto_mesh=False)._solve_kernel(ref_problem)
    before = dict(ts.LAUNCHES)
    got = TorchSolver(device="cpu")._solve_kernel(problem)
    assert ts.LAUNCHES == before  # CPU tensors take the plain versions
    assert expect.stats["backend"] == 1.0
    assert got.stats["backend"] == 1.0
    assert validate(problem, got) == []
    assert _plan(got) == _plan(expect)
    assert got.cost == pytest.approx(expect.cost, rel=1e-9)
    if name == "topology_10k":
        assert got.cost == pytest.approx(configs.REFERENCE_COSTS["10k_topology"], rel=1e-9)
    if name == "existing_nodes":
        assert got.existing_assignments and got.new_nodes


def test_slot_budget_regrows_like_the_reference():
    """On the kernel path, 50k_full exhausts its first slot budget (S=1024)
    and solves at S=2048, at the JAX package's cost. The port's CPU path
    alone: the reference run at this size is pinned by
    test_reference_costs_are_pinned."""
    problem = encode(*configs.config_50k_full())
    solver = TorchSolver(device="cpu")
    assert solver._estimate_slots(problem) == 1024
    result = solver._solve_kernel(problem)
    assert result.stats["slots"] == 2048.0
    assert result.cost == pytest.approx(configs.REFERENCE_COSTS["50k_full"], rel=1e-9)
    assert not result.unschedulable
    assert validate(problem, result) == []


def _jax_cell(pods, prov):
    """A cell of ``configs.config_cells`` rebuilt with the JAX package's API."""
    import karpenter_tpu.api as rapi
    from karpenter_tpu.cloudprovider import generate_catalog as rcat

    rpods = [rapi.Pod(meta=rapi.ObjectMeta(name=p.name), requests=rapi.Resources(p.requests.to_dict()),
                      node_selector=dict(p.node_selector)) for p in pods]
    rprov = rapi.Provisioner(meta=rapi.ObjectMeta(name=prov.name), labels=dict(prov.labels))
    return (rpods, [(rprov, rcat(n_types=60))])


@functools.lru_cache(maxsize=None)
def _fleet_after_three_rounds():
    cells, provs, _ = configs.config_cells()
    for r in range(3):
        configs.churn_cells(cells, r)
    return cells, provs


def _cells_config(c):
    """Cell ``c`` of the 500k-pod fleet after churn rounds 0-2: cell 19 is
    still a seed cell, cells 0, 4 and 8 were churned once, in rounds 0, 1
    and 2."""
    def make():
        cells, provs = _fleet_after_three_rounds()
        return _jax_cell(list(cells[c].values()), provs[c])
    return make


def _delta_after_rounds():
    """``configs.config_delta_reconcile`` after its churn rounds, rebuilt
    with the JAX package's API."""
    import karpenter_tpu.api as rapi
    from karpenter_tpu.cloudprovider import generate_catalog as rcat

    pods, _, churn_round = configs.config_delta_reconcile()
    for r in range(configs.DELTA_ROUNDS):
        removed, added = churn_round(r)
        gone = {p.name for p in removed}
        pods = [p for p in pods if p.name not in gone] + added
    rpods = [rapi.Pod(meta=rapi.ObjectMeta(name=p.name), requests=rapi.Resources(p.requests.to_dict()))
             for p in pods]
    return rpods, [(rapi.Provisioner(meta=rapi.ObjectMeta(name="default")), rcat(n_types=400))]


def _controller_seed():
    """The provisioning controller's seed-round problem on
    ``configs.config_controller_reconcile``, rebuilt with the JAX package's
    cluster and fake provider: the pending pods, the provider's instance
    types for its one provisioner, no existing nodes."""
    from test_torch_controller import controller_config

    cluster, provider, _, _ = controller_config("karpenter_tpu", 50_000, 400)
    provs = [(p, provider.get_instance_types(p)) for p in cluster.provisioners.values()]
    return cluster.pending_pods(), provs, cluster.existing_capacity(), cluster.daemonsets()


def _operator_seed():
    """The operator's seed-round problem on ``configs.config_operator``,
    rebuilt with the JAX package's cluster, fake provider and price
    refresh."""
    from test_torch_operator import REF, operator_seed

    return operator_seed(REF)


def _http_seed():
    """The operator's seed-round problem over the wire on
    ``configs.config_http_tier``, rebuilt with the JAX package's cluster,
    cloud service and HTTP provider."""
    from test_torch_http_operator import REF, http_seed

    return http_seed(REF)


def _consolidation_sim():
    """The first what-if of a deprovisioning pass on
    ``configs.config_consolidation()``, rebuilt with the JAX package's
    cluster and fake provider: every node of the 2,000-node fleet excluded,
    its 20,000 pods against the provider's instance types, no existing
    nodes."""
    from test_torch_deprovisioning import REF, bench_fleet, pkg_mod

    cluster, provider = bench_fleet(pkg_mod(REF), 2000, 10)[:2]
    # one pass over the pods, in the order each node's ``pods_on_node`` gives
    on_node = {}
    for p in cluster.pods.values():
        if p.node_name is not None and not p.is_daemonset:
            on_node.setdefault(p.node_name, []).append(p)
    pods = [p for n in cluster.managed_nodes() for p in on_node.get(n.name, ())]
    return pods, [(p, provider.get_instance_types(p)) for p in cluster.provisioners.values()], []


@pytest.mark.parametrize("name,make", [
    ("50k_full", bench.config_50k_full),
    ("10k_topology", bench.config_10k_topology),
    ("10k_crossgroup", bench.config_10k_crossgroup),
    ("cells_seed", _cells_config(19)),
    ("cells_r0", _cells_config(0)),
    ("cells_r1", _cells_config(4)),
    ("cells_r2", _cells_config(8)),
    ("delta_r8", _delta_after_rounds),
    ("controller_seed", _controller_seed),
    ("consolidation_20k", _consolidation_sim),
    ("operator_seed", _operator_seed),
    ("http_seed", _http_seed),
])
def test_reference_costs_are_pinned(name, make):
    """The constants chip_smoke.py holds the card's answers to are what the
    JAX package computes on the CPU."""
    result = TPUSolver(auto_mesh=False)._solve_kernel(ref_encode(*make()))
    assert result.cost == configs.REFERENCE_COSTS[name]


def test_unsupported_shape_and_empty_problems():
    """A shape the tensor path cannot express is answered by the greedy
    oracle, as in the reference; an empty problem opens nothing."""
    problem = encode(*configs.config_full(200, 10))
    problem.rel_unsupported = "cyclic required affinity"
    result = TorchSolver(device="cpu").solve(problem)
    assert result.stats["backend"] == 0.0 and result.stats["fallback"] == 1.0
    assert validate(problem, result) == [] and not result.unschedulable
    from karpenter_tpu_torch.api import ObjectMeta, Provisioner
    from karpenter_tpu_torch.cloudprovider import generate_catalog

    empty = encode([], [(Provisioner(meta=ObjectMeta(name="d")), generate_catalog(n_types=5))], [])
    assert TorchSolver(device="cpu").solve(empty).stats["backend"] == 1.0
