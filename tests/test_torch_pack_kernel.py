"""The port's plain packing program against the JAX package's XLA program.

Inputs come from the reference ``TPUSolver._prepare``, cross into torch
through ``pack_inputs_from_numpy``, and run through
``jax_solver._shared_precompute`` / ``pack_solve_fused`` and the port's
``shared_precompute_ref`` / ``pack_solve_fused_ref`` on the CPU.

Tolerances: unit counts, flags and every integer of the result buffer are
exact. ``lam`` and ``val_pair`` agree to rtol 1e-6. Member costs are f32 sums
over the slots, added in a different order by XLA and by torch, so they agree
to rtol 1e-5; where the two lowest member costs lie within 1e-6 of each other
the winner may differ, and the decoded plans are then held to equal cost
(1e-9 relative) and a clean validation instead.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_tpu.api import (
    Node, ObjectMeta, Pod, PodAffinityTerm, Provisioner, Resources, TopologySpreadConstraint,
)
from karpenter_tpu.api import labels as wk
from karpenter_tpu.cloudprovider import generate_catalog
from karpenter_tpu.solver import ExistingNode, TPUSolver, encode, validate
from karpenter_tpu.solver.jax_solver import (
    BucketKey, _shared_precompute, pack_solve_fused, unpack_solve_fused,
)
from karpenter_tpu_torch.solver import torch_solver as ts

IBIG = 1 << 30
K = 8


def _pods(shapes):
    return [
        Pod(
            meta=ObjectMeta(name=f"{prefix}-{j}", labels=dict(kw.get("labels", {}))),
            requests=Resources(cpu=cpu, memory=mem),
            node_selector=dict(kw.get("node_selector", {})),
            topology_spread=list(kw.get("spread", [])),
            affinity_terms=list(kw.get("affinity", [])),
        )
        for prefix, n, cpu, mem, kw in shapes
        for j in range(n)
    ]


def _random_shapes(seed, n, extra=lambda i: {}):
    rng = np.random.default_rng(seed)
    cpus = ["100m", "250m", "500m", "1", "2"]
    mems = ["256Mi", "512Mi", "1Gi", "2Gi", "4Gi"]
    return [
        (f"g{i}", int(rng.integers(5, 60)), cpus[int(rng.integers(0, 5))],
         mems[int(rng.integers(0, 5))], extra(i))
        for i in range(n)
    ]


def _existing(seed, catalog, n=10):
    rng = np.random.default_rng(seed)
    mids = [it for it in catalog if 4 <= it.capacity["cpu"] <= 16]
    out = []
    for i in range(n):
        it = mids[int(rng.integers(0, len(mids)))]
        node = Node(
            meta=ObjectMeta(name=f"node-{i}", labels={
                **it.requirements.labels(), wk.ZONE: ["zone-a", "zone-b", "zone-c"][i % 3],
                wk.PROVISIONER_NAME: "default", wk.INSTANCE_TYPE: it.name,
            }),
            capacity=it.capacity, allocatable=it.allocatable(), ready=True,
        )
        out.append(ExistingNode(node=node, remaining=it.allocatable() * float(rng.uniform(0.2, 0.7))))
    return out


def _spread(app, key=wk.ZONE, skew=1):
    return [TopologySpreadConstraint(max_skew=skew, topology_key=key, label_selector={"app": app})]


def _problem(case):
    cat = generate_catalog(n_types=30)
    existing = []
    if case in ("plain", "padded", "exhaustion"):
        shapes = _random_shapes(1, 7)
    elif case == "zone_quotas":
        shapes = _random_shapes(2, 6, lambda i: {"labels": {"app": f"s{i}"}, "spread": _spread(f"s{i}")})
    elif case == "node_cap":
        shapes = _random_shapes(3, 6, lambda i: {
            "labels": {"app": f"a{i}"},
            "affinity": [PodAffinityTerm({"app": f"a{i}"}, wk.HOSTNAME, anti=True)],
        } if i % 2 else {"labels": {"app": f"h{i}"}, "spread": _spread(f"h{i}", wk.HOSTNAME, 3)})
    elif case == "colocate":
        shapes = [(f"c{i}", 3 + i, "250m", "256Mi", {
            "labels": {"app": f"c{i}"}, "affinity": [PodAffinityTerm({"app": f"c{i}"}, wk.HOSTNAME)],
        }) for i in range(4)] + _random_shapes(4, 3)
    elif case == "reserve":
        shapes = []
        for i in range(2):
            shapes.append((f"db{i}", 10, "1", "2Gi", {"labels": {"app": f"db{i}"}}))
            shapes.append((f"web{i}", 30, "500m", "1Gi", {
                "labels": {"app": f"web{i}"},
                "affinity": [PodAffinityTerm({"app": f"db{i}"}, wk.HOSTNAME)],
            }))
    elif case == "existing":
        shapes = _random_shapes(5, 6)
        existing = _existing(5, cat)
    elif case == "relations":
        shapes = [
            ("db", 12, "1", "2Gi", {"labels": {"app": "db", "tier": "data"}}),
            ("web", 40, "250m", "512Mi", {"labels": {"app": "web"},
                                          "affinity": [PodAffinityTerm({"app": "db"}, wk.HOSTNAME)]}),
            ("batch", 20, "500m", "1Gi", {"labels": {"app": "batch"},
                                          "affinity": [PodAffinityTerm({"tier": "data"}, wk.ZONE, anti=True)]}),
            ("front", 60, "250m", "512Mi", {"labels": {"app": "front"}, "spread": _spread("front")}),
        ]
    else:
        raise ValueError(case)
    prov = Provisioner(meta=ObjectMeta(name="default"))
    return encode(_pods(shapes), [(prov, cat)], existing)


# One fixed lattice shape per E keeps the XLA compiles few.
def _bucket(problem, s_new=128):
    return BucketKey(G=16, O=256, E=64 if problem.E else 1, S=s_new, Z=4, R=3, K=K)


_jit_shared = jax.jit(_shared_precompute, static_argnums=(1, 2))


def _run_both(problem, bucket):
    solver = TPUSolver(auto_mesh=False)
    inputs, orders, alphas, looks, rsvs, swaps, s_new, nz = solver._prepare(problem, bucket=bucket)
    tensors = ts.pack_inputs_from_numpy(
        dict(inputs._asdict(), orders=orders, alphas=alphas, looks=looks, rsvs=rsvs, swaps=swaps), "cpu"
    )
    jin = jax.tree.map(jnp.asarray, inputs)
    sj = _jit_shared(jin, s_new, nz)
    st = ts.shared_precompute_ref(tensors[0], s_new, nz)
    bj = np.asarray(pack_solve_fused(jin, orders, alphas, looks, rsvs, swaps, s_new=s_new, n_zones=nz))
    bt = ts.pack_solve_fused_ref(*tensors, s_new, nz).numpy()
    return solver, inputs, orders, swaps, s_new, sj, st, bj, bt


def _costs(buf):
    return np.frombuffer(buf[4 : 4 + 2 * K].tobytes(), np.float32).astype(np.float64)


def _decode(solver, problem, buf, orders, swaps, s_new, inputs):
    order, _, _, _, new_opt, new_active, ys = unpack_solve_fused(
        buf, K, s_new, inputs.count.shape[0], inputs.ex_valid.shape[0], orders, swaps
    )
    return solver._decode(problem, order, new_opt, new_active, ys)


def assert_fused_agree(problem, solver, inputs, orders, swaps, s_new, bj, bt):
    cj, ct = _costs(bj), _costs(bt)
    np.testing.assert_allclose(ct, cj, rtol=1e-5, atol=0)
    ints_j = np.delete(bj, np.s_[4 : 4 + 2 * K])
    ints_t = np.delete(bt, np.s_[4 : 4 + 2 * K])
    if np.array_equal(ints_j, ints_t):
        return
    low = np.sort(cj)
    assert low[1] - low[0] <= 1e-6 * low[0], "buffers differ away from a near-tie"
    rj = _decode(solver, problem, bj, orders, swaps, s_new, inputs)
    rt = _decode(solver, problem, bt, orders, swaps, s_new, inputs)
    assert rt.cost == pytest.approx(rj.cost, rel=1e-9)
    assert validate(problem, rt) == []


def _assert_shared(sj, st):
    for f in ("units", "units_rsv", "rsv_group", "zone_limited", "exok_pad"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(sj, f)), err_msg=f)
    for f in ("lam", "val_pair"):
        np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(getattr(sj, f)), rtol=1e-6, atol=0,
                                   err_msg=f)


@functools.lru_cache(maxsize=None)
def _case(case):
    problem = _problem(case)
    s_new = 8 if case == "exhaustion" else 128
    return problem, _run_both(problem, _bucket(problem, s_new))


# what each case must reach in the inputs, so that it tests what it is named for
FEATURE = {
    "plain": lambda i, s: True,
    "padded": lambda i, s: True,
    "zone_quotas": lambda i, s: (i.quota < IBIG).any(),
    "node_cap": lambda i, s: (i.node_cap[i.count > 0] < IBIG).all(),
    "colocate": lambda i, s: i.colocate.any(),
    "reserve": lambda i, s: (i.demand_units != i.demand).any(),
    "existing": lambda i, s: i.ex_valid.sum() == 10,
    "relations": lambda i, s: i.rel_host_need.any() and i.rel_zone_forbid.any(),
    "exhaustion": lambda i, s: True,
}


@pytest.mark.parametrize("case", list(FEATURE))
def test_shared_precompute_matches_reference(case):
    problem, (solver, inputs, orders, swaps, s_new, sj, st, bj, bt) = _case(case)
    assert FEATURE[case](inputs, s_new)
    _assert_shared(sj, st)


@pytest.mark.parametrize("case", list(FEATURE))
def test_fused_solve_matches_reference(case):
    problem, (solver, inputs, orders, swaps, s_new, sj, st, bj, bt) = _case(case)
    assert_fused_agree(problem, solver, inputs, orders, swaps, s_new, bj, bt)
    exhausted = bt[4 + 2 * K : 4 + 4 * K].astype(bool)
    if case == "exhaustion":
        assert exhausted.any() and bt[3] > 0
    else:
        assert not exhausted.any() and bt[3] == 0


def test_padded_bucket_gives_the_natural_answer():
    problem, (solver, inputs, orders, swaps, s_new, sj, st, bj, bt) = _case("padded")
    natural = TPUSolver(auto_mesh=False)
    ninputs, norders, nalphas, nlooks, nrsvs, nswaps, ns_new, nnz = natural._prepare(problem)
    assert (ninputs.count.shape[0], ninputs.price.shape[0]) != (inputs.count.shape[0], inputs.price.shape[0])
    tensors = ts.pack_inputs_from_numpy(
        dict(ninputs._asdict(), orders=norders, alphas=nalphas, looks=nlooks, rsvs=nrsvs, swaps=nswaps),
        "cpu",
    )
    bn = ts.pack_solve_fused_ref(*tensors, ns_new, nnz).numpy()
    rn = _decode(natural, problem, bn, norders, nswaps, ns_new, ninputs)
    rp = _decode(solver, problem, bt, orders, swaps, s_new, inputs)
    assert rp.cost == pytest.approx(rn.cost, rel=1e-9)
    assert sorted(n.option_index for n in rp.new_nodes) == sorted(n.option_index for n in rn.new_nodes)
    assert sorted(rp.unschedulable) == sorted(rn.unschedulable)
    assert validate(problem, rp) == []


def test_member_phases_match_reference_members():
    """The K2 and K3 wrappers on CPU tensors: phase 1 and the seeded phase 2
    reproduce the reference buffer's flags and costs, and the epilogue the
    whole buffer."""
    problem, (solver, inputs, orders, swaps, s_new, sj, st, bj, bt) = _case("reserve")
    _, _, alphas, looks, rsvs, _, _, nz = solver._prepare(problem, bucket=_bucket(problem))
    inp, o, a, l, r, sw = ts.pack_inputs_from_numpy(
        dict(inputs._asdict(), orders=orders, alphas=alphas, looks=looks, rsvs=rsvs, swaps=swaps), "cpu"
    )
    assert r.any()
    m1 = ts.pack_member(inp, st, o, a, l, r, s_new, nz)
    m2 = ts.pack_member(inp, st, o, a, l, r, s_new, nz, swaps=sw, seed_costs=m1.cost)
    np.testing.assert_array_equal(torch.cat([m1.exhausted, m2.exhausted]).numpy(),
                                  bt[4 + 2 * K : 4 + 4 * K].astype(bool))
    np.testing.assert_allclose(torch.cat([m1.cost, m2.cost]).numpy(), _costs(bj), rtol=1e-5)
    assert torch.equal(ts.pack_epilogue(m1, m2), torch.from_numpy(bt))


def test_fma_matches_xla_contraction():
    """XLA on the CPU contracts ``c - a*b`` into one fused multiply-add;
    ``torch_solver._fma`` reproduces that rounding, which plain f32 does not."""
    rng = np.random.default_rng(0)
    a, b, c = (rng.random(20000, dtype=np.float32) * s for s in (4, 1, 2))
    xla = np.asarray(jax.jit(lambda a, b, c: c - a * b)(a, b, c))
    ta, tb, tc = (torch.from_numpy(x) for x in (a, b, c))
    assert np.array_equal(ts._fma(ta, -tb, tc).numpy(), xla)
    assert not np.array_equal((tc - ta * tb).numpy(), xla)


def test_fma_rounds_once_near_halfway_points():
    """Products a hair off half an f32 ulp of ``c``, and products many
    binades away from ``c``: the exact sum needs more than f64's 53 bits, so
    an f64 add followed by a cast to f32 rounds twice and lands on the wrong
    side of the halfway point, where ``_fma`` must not."""
    rng = np.random.default_rng(1)
    n = 4000
    c = (rng.random(n, dtype=np.float32) + np.float32(1)) * np.exp2(rng.integers(-20, 20, n)).astype(np.float32)
    half_ulp = (np.spacing(c) / 2).astype(np.float32)
    eps = np.float32(2.0**-23)
    a = half_ulp * (np.float32(1) + eps)  # a*|b| = half_ulp * (1 - 2**-46)
    b = np.where(rng.random(n) < 0.5, np.float32(1) - eps, eps - np.float32(1)).astype(np.float32)
    wide = np.exp2(rng.integers(-60, 60, (3, n))).astype(np.float32) * rng.random((3, n), dtype=np.float32)
    a, b, c = (np.concatenate([x, w]) for x, w in zip((a, b, c), wide))
    xla = np.asarray(jax.jit(lambda a, b, c: c - a * b)(a, b, c))
    ta, tb, tc = (torch.from_numpy(x) for x in (a, b, c))
    assert np.array_equal(ts._fma(ta, -tb, tc).numpy(), xla)
    twice = (tc.double() - ta.double() * tb.double()).float().numpy()
    assert not np.array_equal(twice, xla)  # the cases do reach double rounding
    # c + 2**6 - 2**-40 with c's last bit odd: below the halfway point
    one = ts._fma(torch.tensor([np.float32(64 * (1 + 2.0**-23))]),
                  torch.tensor([np.float32(1 - 2.0**-23)]),
                  torch.tensor([np.float32(2.0**30 + 2.0**7)]))
    assert one.item() == 2.0**30 + 2.0**7
