"""The multi-device tier on the CPU: ``karpenter_tpu_torch.parallel.mesh``
against ``karpenter_tpu.parallel.mesh``, and the meshed chain
(``torch_solver.pack_solve_meshed``, ``solver/meshed.py``) against the
un-meshed one.

A mesh here is logical shards of the CPU (one device named several times),
as conftest's 8 virtual CPU devices are the JAX package's. The rule table,
specs, shape parsing and paddings must equal the reference's on every leaf
and shape case of ``tests/test_mesh_superproblem.py::TestPartitionRules``.
The meshed plain chain must equal the port's un-meshed chain bit for bit at
1D 2/4/8 shards and 2D 2x1/4x1/2x2, and the JAX package's un-meshed
``pack_solve_fused`` / ``pack_solve_fleet`` with member costs to rtol 1e-5
and every integer equal (the tolerance of ``test_torch_fleet.py``).
``TorchSolver(mesh=<1D, 8 shards>, device="cpu")._solve_kernel`` answers
what the JAX package's default ``TPUSolver()._solve_kernel`` answers on the
8 virtual devices (K rounded up alike): cost to 1e-9 relative, equal
placements. A superproblem round through ``stage_fleet`` on a 2x2 mesh
answers what the un-meshed fleet answers (digests, placements).
"""

from __future__ import annotations

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from karpenter_tpu import parallel as ref_parallel
from karpenter_tpu.solver import TPUSolver
from karpenter_tpu.solver.jax_solver import PackInputs as RefInputs
from karpenter_tpu.solver.jax_solver import pack_solve_fleet as ref_pack_solve_fleet
from karpenter_tpu.solver.jax_solver import pack_solve_fused as ref_pack_solve_fused
from karpenter_tpu_torch import configs
from karpenter_tpu_torch import parallel
from karpenter_tpu_torch.solver import TorchSolver, encode, stage_fleet, validate
from karpenter_tpu_torch.solver import meshed
from karpenter_tpu_torch.solver import torch_solver as ts
from karpenter_tpu_torch.solver.solver import problem_digest

MEMBER_ARRAYS = ("orders", "alphas", "looks", "rsvs", "swaps")
LEAVES = ts.PackInputs._fields + MEMBER_ARRAYS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run on small tensors, as fast on one intra-op
    thread; the other cores stay free for the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(n: int):
    return parallel.make_mesh(n, devices=["cpu"] * n)


def cpu_mesh2d(shape):
    return parallel.make_mesh2d(shape, devices=["cpu"] * (shape[0] * shape[1]))


# ---------------------------------------------------------------------------
# The rule table and the shapes, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("leaf", LEAVES)
def test_rule_table_matches_reference_on_every_leaf(leaf):
    for shape in ((4, 8), (8,), (1,), (), (64, 4), (8, 64)):
        assert tuple(parallel.match_partition_rules(leaf, shape)) == tuple(
            ref_parallel.match_partition_rules(leaf, shape)), shape
    for shape in ((2, 4, 8), (2,), (2, 1), (3, 64, 4)):
        got = parallel.match_partition_rules(leaf, shape, batch=True)
        assert tuple(got) == tuple(ref_parallel.match_partition_rules(leaf, shape, batch=True))
        assert tuple(got)[0] == parallel.FLEET_AXIS


def test_rule_table_cases_of_the_reference():
    with pytest.raises(ValueError, match="Partition rule not found"):
        parallel.match_partition_rules("brand_new_leaf", (4, 8))
    assert parallel.match_partition_rules("brand_new_leaf", ()) == parallel.PartitionSpec()
    assert parallel.match_partition_rules("brand_new_leaf", (1,)) == parallel.PartitionSpec()
    assert tuple(parallel.match_partition_rules("count", (2,), batch=True)) == (parallel.FLEET_AXIS,)
    assert tuple(parallel.match_partition_rules("alloc", (64, 4))) == (parallel.OPTIONS_AXIS,)
    assert tuple(parallel.match_partition_rules("compat", (8, 64))) == (None, parallel.OPTIONS_AXIS)
    assert tuple(parallel.match_partition_rules("alloc", (2, 64, 4), batch=True)) == (
        parallel.FLEET_AXIS, parallel.OPTIONS_AXIS)
    assert [r for r, _ in parallel.PARTITION_RULES] == [r for r, _ in ref_parallel.PARTITION_RULES]
    assert [tuple(s) for _, s in parallel.PARTITION_RULES] == [
        tuple(s) for _, s in ref_parallel.PARTITION_RULES]


@pytest.mark.parametrize("shape", [(2, 1), (4, 1), (2, 2), (4, 2), (1, 2)])
def test_mesh_sharding_and_labels_match_reference(shape):
    mesh, ref_mesh = cpu_mesh2d(shape), ref_parallel.make_mesh2d(shape)
    assert parallel.is_mesh2d(mesh) and parallel.mesh_axes_label(mesh) == ref_parallel.mesh_axes_label(ref_mesh)
    for leaf in LEAVES:
        for dims in ((3, 4), (4, 4), (8, 64), (64, 4), (8,), (6, 8, 64)):
            for batch in (False, True):
                if batch and len(dims) < 2:
                    continue
                got = parallel.mesh_sharding(mesh, leaf, dims, batch=batch).spec
                want = ref_parallel.mesh_sharding(ref_mesh, leaf, dims, batch=batch).spec
                assert tuple(got) == tuple(want), (leaf, dims, batch)
    for o in (2, 8, 24, 64, 1000):
        assert parallel.shard_aligned_options(o, mesh) == ref_parallel.shard_aligned_options(o, ref_mesh)
    assert parallel.round_up_portfolio(5, mesh) == 5


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_parse_round_up_and_fleet_shardings_match_reference(n):
    for value in ("auto", "4x2", "1x1", "2x1", "8x1", None):
        assert parallel.parse_mesh_shape(value, n) == ref_parallel.parse_mesh_shape(value, n)
    mesh, ref_mesh = cpu_mesh(n), ref_parallel.make_mesh(n)
    assert not parallel.is_mesh2d(mesh)
    for k in (1, 5, 8, 12):
        assert parallel.round_up_portfolio(k, mesh) == ref_parallel.round_up_portfolio(k, ref_mesh)
        assert parallel.round_up_portfolio(k, None) == k
        assert parallel.shard_aligned_options(k, mesh) == k
    for b in (1, 2, 4, 6, 8, 16):
        got = parallel.fleet_shardings(mesh, b)
        want = ref_parallel.fleet_shardings(ref_mesh, b)
        assert [tuple(s.spec) for s in got] == [tuple(s.spec) for s in want], b


def test_placement_blocks_reassemble():
    """A placed leaf holds each shard's block; the blocks make the leaf."""
    rng = np.random.default_rng(3)
    mesh = cpu_mesh2d((2, 2))
    compat = rng.random((3, 8, 16)) < 0.5
    placed = parallel.device_put(compat, parallel.mesh_sharding(mesh, "compat", compat.shape, batch=True))
    # 3 rows do not divide the fleet axis: dim 0 replicates, the columns split
    assert tuple(placed.spec) == (None, None, parallel.OPTIONS_AXIS)
    assert [tuple(t.shape) for t in placed.shards] == [(3, 8, 8)] * 4
    assert torch.equal(placed.full(), torch.from_numpy(compat))


# ---------------------------------------------------------------------------
# The meshed chain against the un-meshed one
# ---------------------------------------------------------------------------

def _problems():
    """Small problems, built in both packages: plain, topology (zone
    spread, hostname anti-affinity), and existing nodes."""
    from test_torch_solver import _build, _ref_existing, _small_topology

    def plain(api):
        return [("a", 90, "250m", "512Mi", {}), ("b", 60, "500m", "1Gi", {}),
                ("c", 40, "1", "2Gi", {}), ("d", 30, "2", "4Gi", {})]

    def small_topology(api):
        return [r for r in _small_topology()(api)][:4]

    def existing(api):
        return [("a", 100, "250m", "512Mi", {}), ("b", 60, "500m", "1Gi", {})]

    return {
        "plain": _build(plain, 24),
        "topology": _build(small_topology, 24),
        "existing": _build(existing, 24, existing=_ref_existing(12)),
    }


_CACHE: dict = {}


def _prepared(name):
    """``(port tensors, reference arrays, S, Z)`` of one small problem at
    the natural bucket, both packages padding alike."""
    if name not in _CACHE:
        ref_problem, problem = _problems()[name]
        prep = TorchSolver(device="cpu")._prepare(problem)
        ref_prep = TPUSolver(auto_mesh=False)._prepare(ref_problem)
        fields, members, S, nz = prep[0], prep[1:6], prep[6], prep[7]
        for f in RefInputs._fields:
            assert np.array_equal(fields[f], np.asarray(getattr(ref_prep[0], f))), f
        tensors = ts.pack_inputs_from_numpy(dict(fields, **dict(zip(MEMBER_ARRAYS, members))), "cpu")
        _CACHE[name] = (tensors, ref_prep[:6], S, nz)
    return _CACHE[name]


def _place(mesh, tensors, batch=None):
    inputs, *members = tensors
    if parallel.is_mesh2d(mesh):
        if batch is None:
            return parallel.shard_problem2d(mesh, inputs, *members)
        return parallel.shard_superproblem(mesh, batch, inputs, *members)
    if batch is None:
        return parallel.shard_portfolio(mesh, inputs, *members)
    return parallel.shard_fleet(mesh, batch, inputs, *members)


def _hold_to_reference(buf: np.ndarray, ref_buf: np.ndarray, K: int) -> None:
    costs = np.frombuffer(buf[4 : 4 + 2 * K].tobytes(), np.float32)
    ref_costs = np.frombuffer(ref_buf[4 : 4 + 2 * K].tobytes(), np.float32)
    np.testing.assert_allclose(costs, ref_costs, rtol=1e-5, atol=0)
    assert np.array_equal(np.delete(buf, np.s_[4 : 4 + 2 * K]), np.delete(ref_buf, np.s_[4 : 4 + 2 * K]))


MESHES = [("1d", 2), ("1d", 4), ("1d", 8), ("2d", (2, 1)), ("2d", (4, 1)), ("2d", (2, 2))]


@pytest.mark.parametrize("name", ["plain", "topology", "existing"])
@pytest.mark.parametrize("kind,shape", MESHES, ids=[f"{k}-{s}" for k, s in MESHES])
def test_meshed_chain_equals_unmeshed_bit_for_bit(name, kind, shape):
    tensors, ref_arrays, S, nz = _prepared(name)
    want = ts.pack_solve_fused(*tensors, S, nz)
    mesh = cpu_mesh(shape) if kind == "1d" else cpu_mesh2d(shape)
    got = ts.pack_solve_meshed(mesh, *_place(mesh, tensors), S, nz)
    assert torch.equal(got, want)
    ref_buf = np.asarray(ref_pack_solve_fused(
        RefInputs(*(jnp.asarray(np.asarray(a)) for a in ref_arrays[0])),
        *(jnp.asarray(a) for a in ref_arrays[1:6]), s_new=S, n_zones=nz))
    _hold_to_reference(got.numpy(), ref_buf, tensors[1].shape[0])


@pytest.mark.parametrize("kind,shape", [("1d", 2), ("1d", 4), ("2d", (2, 2)), ("2d", (4, 1)),
                                        ("2d", (2, 1)), ("1d", 3)])
def test_meshed_fleet_equals_unmeshed_bit_for_bit(kind, shape):
    """Three distinct problems and a pad row of one bucket, stacked: the 1D
    mesh splits the rows (or replicates them, at 3 shards), the 2D mesh
    splits rows over ``fleet`` and columns over ``options``."""
    rows, ref_rows = [], []
    probs = _problems()
    solver, ref_solver = TorchSolver(device="cpu"), TPUSolver(auto_mesh=False)
    keys = [solver._bucket_key(p) for _, p in probs.values()]
    key = keys[0]._replace(G=max(k.G for k in keys), O=max(k.O for k in keys),
                           E=max(k.E for k in keys), S=max(k.S for k in keys), Z=max(k.Z for k in keys))
    for ref_p, p in probs.values():
        prep = solver._prepare(p, bucket=key)
        rows.append(dict(prep[0], **dict(zip(MEMBER_ARRAYS, prep[1:6]))))
        ref_prep = ref_solver._prepare(ref_p, bucket=key)
        ref_rows.append(ref_prep[:6])
    pad, *pad_members = ts.fleet_padding(key)
    rows.append(dict(pad, **dict(zip(MEMBER_ARRAYS, pad_members))))
    stacked = ts.pack_inputs_from_numpy({f: np.stack([r[f] for r in rows]) for f in rows[0]}, "cpu")
    want = ts.pack_solve_fleet(*stacked, key.S, key.Z)
    mesh = cpu_mesh(shape) if kind == "1d" else cpu_mesh2d(shape)
    got = ts.pack_solve_meshed(mesh, *_place(mesh, stacked, batch=4), key.S, key.Z)
    assert torch.equal(got, want)
    from karpenter_tpu.solver.jax_solver import fleet_padding as ref_fleet_padding

    ref_rows.append(ref_fleet_padding(key))
    ref_buf = np.asarray(ref_pack_solve_fleet(
        RefInputs(*(jnp.asarray(np.stack([np.asarray(getattr(r[0], f)) for r in ref_rows]))
                    for f in RefInputs._fields)),
        *(jnp.asarray(np.stack([r[i] for r in ref_rows])) for i in range(1, 6)),
        s_new=key.S, n_zones=key.Z))
    for b in range(4):
        _hold_to_reference(got[b].numpy(), ref_buf[b], key.K)


def test_member_argmin_takes_the_first_nan_then_the_lowest_index():
    """The 1D mesh's member argmin (``mesh_seed`` over every shard's
    phase-1 members) picks as ``torch.argmin`` over the whole portfolio: the
    first NaN, else the first minimum, across shards."""
    G, kl, n = 5, 2, 4
    rng = np.random.default_rng(5)
    orders = torch.from_numpy(rng.permuted(np.tile(np.arange(G, dtype=np.int32), (n, 1, kl, 1)), axis=-1))
    alphas = torch.from_numpy(rng.random((n, 1, kl)).astype(np.float32))
    looks = torch.from_numpy(rng.random((n, 1, kl)) < 0.5)
    rsvs = torch.from_numpy(rng.random((n, 1, kl)) < 0.5)
    swaps = torch.from_numpy(np.tile(np.arange(G, dtype=np.int32), (1, kl, 1)))
    nan = float("nan")
    for costs in ([3.0, 1.0, 1.0, 2.0, 1.0, 5.0, 1.0, 9.0], [3.0, 1.0, nan, 2.0, nan, 5.0, 0.0, 9.0],
                  [1.0] * 8, [9.0, 9.0, 9.0, 9.0, 9.0, 9.0, 9.0, 0.5]):
        c = torch.tensor(costs, dtype=torch.float32).reshape(n, 1, kl)
        o2, a2, l2, r2, b1 = meshed.mesh_seed(list(c), list(orders), list(alphas), list(looks),
                                              list(rsvs), swaps)
        j = int(torch.argmin(c.reshape(-1)))
        assert int(b1[0, 0]) == j == int(jnp.argmin(jnp.asarray(c.reshape(-1).numpy())))
        assert torch.equal(o2[0, 0], orders[j // kl, 0, j % kl])
        assert float(a2[0, 0]) == float(alphas[j // kl, 0, j % kl])
        assert bool(l2[0, 1]) == bool(looks[j // kl, 0, j % kl])
        assert bool(r2[0, 1]) == bool(rsvs[j // kl, 0, j % kl])


# ---------------------------------------------------------------------------
# The solver on a mesh against the JAX package's
# ---------------------------------------------------------------------------

def _plan(result):
    nodes = sorted(
        (n.option.instance_type.name, n.option.zone, n.option.capacity_type,
         tuple(sorted(n.pod_names)))
        for n in result.new_nodes
    )
    existing = {k: sorted(v) for k, v in result.existing_assignments.items()}
    return nodes, existing, sorted(result.unschedulable)


@pytest.mark.parametrize("name", ["plain", "topology", "existing"])
def test_meshed_solver_answers_the_reference_default_solver(name):
    """The reference's default ``TPUSolver()`` builds the 1D mesh over
    conftest's 8 virtual devices and rounds K up to 8; the port's solver on
    a 1D mesh of 8 CPU shards does the same."""
    ref_problem, problem = _problems()[name]
    ref_solver = TPUSolver()
    expect = ref_solver._solve_kernel(ref_problem)
    assert ref_solver.mesh is not None and ref_solver.mesh.devices.size == 8
    got = TorchSolver(device="cpu", mesh=cpu_mesh(8))._solve_kernel(problem)
    assert got.stats["backend"] == 1.0 and expect.stats["backend"] == 1.0
    assert validate(problem, got) == []
    assert _plan(got) == _plan(expect)
    assert got.cost == pytest.approx(expect.cost, rel=1e-9)
    # K rounds up to the mesh's size
    assert TorchSolver(device="cpu", portfolio=5, mesh=cpu_mesh(8))._bucket_key(problem).K == 8
    unmeshed = TorchSolver(device="cpu")._solve_kernel(problem)
    assert _plan(unmeshed) == _plan(got) and unmeshed.cost == got.cost


def test_one_card_or_cpu_builds_no_mesh():
    solver = TorchSolver(device="cpu", mesh_shape=(2, 2))
    assert solver._ensure_mesh() is None and solver.auto_mesh is False
    assert TorchSolver(device="cpu")._ensure_mesh() is None
    assert parallel.parse_mesh_shape("auto") is None  # no card in this process


def _super_cells(n_cells=4, n_pods=4000):
    cells, provs, catalog = configs.config_mesh_superproblem(n_pods=n_pods, n_cells=n_cells)
    return [encode(list(cells[c].values()), [(provs[c], catalog)]) for c in range(n_cells)]


@pytest.mark.parametrize("shape", [(2, 2), (2, 1)])
def test_superproblem_round_equals_the_unmeshed_fleet(shape):
    """One round of four cells through ``stage_fleet`` on a 2D mesh of CPU
    shards (superproblem mode) and on the un-meshed fleet: the same rows,
    digests and placements."""
    mesh = cpu_mesh2d(shape)
    results = {}
    for arm in ("super", "fleet"):
        problems = _super_cells()
        if arm == "super":
            solver = TorchSolver(device="cpu", mesh=mesh, latency_budget_s=1.0)
            stats = stage_fleet([(solver, p) for p in problems], max_batch=2,
                                superproblem_max_cells=4)
            assert stats["superproblems"] == 1 and stats["mesh_axes"] == f"{shape[0]}x{shape[1]}"
            assert stats["cells_batched"] == 4
        else:
            solver = TorchSolver(device="cpu", latency_budget_s=1.0)
            stats = stage_fleet([(solver, p) for p in problems], max_batch=4)
            assert stats["superproblems"] == 0 and stats["dispatches"] == 1
        rows = [p.__dict__["_fleet_dispatch"] for p in problems]
        bufs = [r.shared.materialize()[r.row] for r in rows]
        solved = [solver._solve_kernel(p) for p in problems]
        results[arm] = (bufs, [problem_digest(p) for p in problems], [_plan(r) for r in solved],
                        [r.cost for r in solved])
        for p, r in zip(problems, solved):
            assert validate(p, r) == []
    for got, want in zip(results["super"][0], results["fleet"][0]):
        assert np.array_equal(got, want)
    assert results["super"][1:] == results["fleet"][1:]


def test_mesh_superproblem_config_matches_the_bench_defaults():
    defaults = {k: v.default for k, v in inspect.signature(bench.bench_mesh_superproblem).parameters.items()}
    for k in ("n_pods", "n_cells", "n_types", "churn_cells", "superproblem_max_cells", "fleet_max_batch"):
        assert configs.MESH_SUPERPROBLEM[k] == defaults[k], k
    cells, provs, catalog = configs.config_mesh_superproblem(n_pods=4000)
    assert len(cells) == len(provs) == defaults["n_cells"]
    assert sum(map(len, cells)) == 4000 and len(catalog) == defaults["n_types"]
    assert [p.name for p in provs][:2] == ["mesh-00", "mesh-01"]
    events = configs.churn_mesh_cells(cells, 0, n_pods=4000)
    assert list(events) == [0, 1, 2, 3] and all(len(r) == len(a) == 2 for r, a in events.values())


@pytest.fixture(autouse=True)
def _fresh_admission_table():
    """Each case starts with the port's dispatch-latency table empty, as a
    new process does: the table is process-wide, as the reference's is, and
    a synchronous pass on the CPU times the plain chain (seconds), which
    would turn a later case's race away."""
    from karpenter_tpu_torch.solver.torch_solver import AOT_CACHE as table

    table.clear()
    yield
    table.clear()
