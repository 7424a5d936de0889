"""The fleet path of the sharded round on the CPU, against the JAX package.

Cells come from ``configs.config_cells`` at 1,250 pods a cell (the 500k-pod
fleet's shapes: 12 deployments node-selected onto the cell's provisioner,
60 instance types) and from ``configs.churn_cells``; the JAX package's side
is the same pods rebuilt with its API.

Tolerances: ``bucket_fleet``, ``fleet_padding`` and the prepared arrays are
exact. The fleet buffer is held to the JAX package's ``pack_solve_fleet``
row by row with the rule of ``test_torch_pack_kernel.py``: every integer
exact, member costs to rtol 1e-5 (f32 sums in another order). Within the
port everything is exact: the device-stacked and host-stacked buffers are
equal, and a fleet row is the fleet-free chain's buffer; kernel costs agree
with the JAX package's ``_solve_kernel`` to 1e-9 relative. Each cell's
``solve`` races its row against the host answer, as the reference's does: a
row that ran out of slots with pods left loses.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import karpenter_tpu.api as rapi
from karpenter_tpu.cloudprovider import generate_catalog as rcat
from karpenter_tpu.solver import TPUSolver
from karpenter_tpu.solver import encode as ref_encode
from karpenter_tpu.solver.jax_solver import BucketKey as RefKey
from karpenter_tpu.solver.jax_solver import PackInputs as RefInputs
from karpenter_tpu.solver.jax_solver import bucket_fleet as ref_bucket_fleet
from karpenter_tpu.solver.jax_solver import fleet_padding as ref_fleet_padding
from karpenter_tpu.solver.jax_solver import pack_solve_fleet as ref_pack_solve_fleet
from karpenter_tpu_torch import configs
from karpenter_tpu_torch.solver import TorchSolver, encode, stage_fleet, validate
from karpenter_tpu_torch.solver import torch_solver as ts

PER_CELL = 1250
MEMBERS = ("orders", "alphas", "looks", "rsvs", "swaps")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run on small tensors, as fast on one intra-op
    thread; the other cores stay free for the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cells(n_cells):
    return configs.config_cells(n_pods=PER_CELL * n_cells, n_cells=n_cells)


def _churn(cells, r):
    return configs.churn_cells(cells, r, n_pods=PER_CELL * len(cells))


def _encode(cells, provs, catalog, c):
    return encode(list(cells[c].values()), [(provs[c], catalog)])


def _ref_encode(cells, provs, c):
    pods = [rapi.Pod(meta=rapi.ObjectMeta(name=p.name), requests=rapi.Resources(p.requests.to_dict()),
                     node_selector=dict(p.node_selector)) for p in cells[c].values()]
    prov = rapi.Provisioner(meta=rapi.ObjectMeta(name=provs[c].name), labels=dict(provs[c].labels))
    return ref_encode(pods, [(prov, rcat(n_types=60))])


@functools.lru_cache(maxsize=None)
def _ref_cost(cells_key):
    """The JAX package's cost of a cell; ``cells_key`` is (n_cells, rounds
    of churn applied, cell)."""
    n_cells, rounds, c = cells_key
    cells, provs, _ = _cells(n_cells)
    for r in range(rounds):
        _churn(cells, r)
    return TPUSolver(auto_mesh=False)._solve_kernel(_ref_encode(cells, provs, c)).cost


def _leaves(solver, problem):
    fields, *members = solver._prepare(problem)[:6]
    return dict(fields, **dict(zip(MEMBERS, members)))


def _changed_rows(old, new):
    diff = old != new
    return int(diff.sum() if old.ndim == 1 else diff.reshape(old.shape[0], -1).any(axis=1).sum())


def _buffer(problem):
    slot = problem.__dict__["_fleet_dispatch"]
    return slot.shared.materialize()[slot.row].copy()


def test_bucket_fleet_and_padding_match_reference():
    for b in range(0, 40):
        assert ts.bucket_fleet(b) == ref_bucket_fleet(b), b
    for dims in ((16, 512, 1, 64, 4, 3, 8), (8, 8, 64, 16, 1, 2, 4)):
        key, ref_key = ts.BucketKey(*dims, B=4), RefKey(*dims, B=4)
        assert key.label() == ref_key.label() and key._replace(B=1).label() == ref_key._replace(B=1).label()
        fields, *members = ts.fleet_padding(key)
        ref_inputs, *ref_members = ref_fleet_padding(ref_key)
        assert list(fields) == list(RefInputs._fields)
        for f in RefInputs._fields:
            got, want = fields[f], np.asarray(getattr(ref_inputs, f))
            assert got.dtype == want.dtype and np.array_equal(got, want), f
        for name, got, want in zip(MEMBERS, members, ref_members):
            assert got.dtype == want.dtype and np.array_equal(got, want), name


def test_pack_solve_fleet_matches_reference_row_by_row():
    """Three distinct cells (seed, churned once, churned twice) and a pad
    row: B=4 through the port's fleet solve and the JAX package's."""
    cells, provs, catalog = _cells(4)
    port_problems, ref_problems = [], []
    for r in range(3):
        port_problems.append(_encode(cells, provs, catalog, 0))
        ref_problems.append(_ref_encode(cells, provs, 0))
        _churn(cells, r)
    solver, ref_solver = TorchSolver(device="cpu"), TPUSolver(auto_mesh=False)
    key = solver._bucket_key(port_problems[0])._replace(S=128)
    ref_key = RefKey(*key[:7])
    rows, ref_rows = [], []
    for p, rp in zip(port_problems, ref_problems):
        assert solver._estimate_slots(p) == ref_solver._estimate_slots(rp)  # the natural bucket
        prep = solver._prepare(p, bucket=key)
        ref_prep = ref_solver._prepare(rp, bucket=ref_key)
        for f in RefInputs._fields:  # the two packages pad identically
            assert np.array_equal(prep[0][f], np.asarray(getattr(ref_prep[0], f))), f
        for got, want in zip(prep[1:6], ref_prep[1:6]):
            assert np.array_equal(got, want)
        rows.append(prep[:6])
        ref_rows.append(ref_prep[:6])
    rows.append(ts.fleet_padding(key))
    ref_rows.append(ref_fleet_padding(ref_key))
    fields = {f: np.stack([r[0][f] for r in rows]) for f in ts.PackInputs._fields}
    fields.update({m: np.stack([r[i] for r in rows]) for i, m in enumerate(MEMBERS, 1)})
    buf = ts.pack_solve_fleet(*ts.pack_inputs_from_numpy(fields, "cpu"), key.S, key.Z).numpy()
    ref_inputs = RefInputs(*(jnp.asarray(np.stack([np.asarray(getattr(r[0], f)) for r in ref_rows]))
                             for f in RefInputs._fields))
    ref_buf = np.asarray(ref_pack_solve_fleet(
        ref_inputs, *(jnp.asarray(np.stack([r[i] for r in ref_rows])) for i in range(1, 6)),
        s_new=key.S, n_zones=key.Z,
    ))
    assert buf.shape == ref_buf.shape and buf.shape[0] == 4
    K = key.K
    for b in range(4):
        costs = np.frombuffer(buf[b, 4 : 4 + 2 * K].tobytes(), np.float32)
        ref_costs = np.frombuffer(ref_buf[b, 4 : 4 + 2 * K].tobytes(), np.float32)
        np.testing.assert_allclose(costs, ref_costs, rtol=1e-5, atol=0)
        assert np.array_equal(np.delete(buf[b], np.s_[4 : 4 + 2 * K]),
                              np.delete(ref_buf[b], np.s_[4 : 4 + 2 * K])), b
        # row b is the B=1 buffer of problem b
        single = ts.pack_solve_fused(*ts.pack_inputs_from_numpy(
            dict(rows[b][0], **dict(zip(MEMBERS, rows[b][1:6]))), "cpu"), key.S, key.Z)
        assert np.array_equal(single.numpy(), buf[b])
    assert buf[3, 3] == 0 and not costs.any()  # the pad row places nothing and costs 0
    assert len({bytes(buf[b]) for b in range(3)}) == 3  # the rows are distinct problems


def test_stage_fleet_device_and_host_stacks_match_serial_and_reference(monkeypatch):
    """The controller's flow (per-cell solvers, prestage, stage_fleet,
    solve) over a seed round and a churn round, against the bench's fleet
    arm (one shared solver, host-stacked) and each cell's fleet-free
    chain; each cell's race takes the row only if it placed every pod and
    beat the host answer. Admission reads the round trip alone: the seed
    round's kernel-only solves time the plain chain on the CPU (seconds),
    which would turn the churn round's prestage and fleet away
    (``test_torch_admission.py`` holds the admission)."""
    monkeypatch.setattr(ts.AOT_CACHE, "predicted_dispatch_s", lambda *args, **kw: None)
    n = 4
    cells, provs, catalog = _cells(n)
    clones = [TorchSolver(device="cpu") for _ in range(n)]
    previous = {}
    for rnd in (None, 0):
        dirty = list(range(n)) if rnd is None else _churn(cells, rnd)
        problems = [_encode(cells, provs, catalog, c) for c in dirty]
        for c, p in zip(dirty, problems):
            clones[c].prestage(p)
            assert clones[c]._resident(p) is not None
            if c in previous:
                # the restage moved exactly the rows an independent diff finds
                info = clones[c]._stager.last_round
                assert info["restage"] >= 1 and info["full"] == 0
                old, new = (_leaves(clones[c], q) for q in (previous[c], p))
                for name in new:
                    rows = _changed_rows(old[name], new[name])
                    assert info["rows"].get(name, 0) == rows, name
            previous[c] = p
        stats = stage_fleet([(clones[c], p) for c, p in zip(dirty, problems)], max_batch=16)
        assert stats["dispatches"] == 1 and stats["cells_batched"] == n
        assert stats["device_stacked"] == 1 and stats["buckets"][0].endswith("b4")
        assert any(t[0] == "fleetpad" for t in clones[dirty[0]]._stager._entries)

        shared = TorchSolver(device="cpu")
        copies = [_encode(cells, provs, catalog, c) for c in dirty]
        host_stats = stage_fleet([(shared, p) for p in copies], max_batch=16)
        assert host_stats["dispatches"] == 1 and host_stats["device_stacked"] == 0
        assert not any(t[0] == "fleetpad" for t in shared._stager._entries)
        assert any(t[0] == "fleet" for t in shared._stager._entries)
        for p, q in zip(problems, copies):
            assert np.array_equal(_buffer(p), _buffer(q))

        ref_cost = _ref_cost((n, 0 if rnd is None else rnd + 1, dirty[0]))
        for c, p, q in zip(dirty, problems, copies):
            row = _buffer(p)
            key = p.__dict__["_fleet_dispatch"].shared.key
            fields, *members = clones[c]._prepare(p, bucket=key._replace(B=1))[:6]
            alone = ts.pack_solve_fused(*ts.pack_inputs_from_numpy(
                dict(fields, **dict(zip(MEMBERS, members))), "cpu"), key.S, key.Z).numpy()
            assert np.array_equal(row, alone)  # the row is the fleet-free chain's buffer
            got = clones[c].solve(p)
            assert "_fleet_dispatch" not in p.__dict__ and p.__dict__["_fleet_b"] == 4
            unplaced = int(row[3])
            assert p.__dict__.get("_race_kernel_lost", False) == (got.stats["backend"] != 1.0)
            if unplaced > 0:
                assert got.stats["backend"] == 2.0  # the row lost to the host LP
            elif got.stats["backend"] == 1.0:
                assert got.stats["fleet_b"] == 4.0  # the row won its race
            assert validate(p, got) == [] and validate(q, shared.solve(q)) == []
            serial = TorchSolver(device="cpu")._solve_kernel(_encode(cells, provs, catalog, c))
            assert serial.cost == pytest.approx(ref_cost, rel=1e-9)


def test_exhausted_row_continues_per_cell_like_the_serial_solve(monkeypatch):
    """A slot budget far too small: every fleet row runs out of slots with
    pods left over and loses its race to the host answer, with no second
    pass, as the fleet-free race's exhausted dispatch does (and as the
    reference's ``_poll_fleet`` does)."""
    from karpenter_tpu_torch.solver import solver as solver_mod

    cells, provs, catalog = _cells(3)
    problems = [_encode(cells, provs, catalog, c) for c in range(3)]
    for p in problems:
        p.__dict__["_est_slots"] = (1 << 15, 16)
    solver = TorchSolver(device="cpu")
    stats = stage_fleet([(solver, p) for p in problems])
    assert stats["dispatches"] == 1 and stats["buckets"] == ["g16o512e1s16z4r3k8b4"]
    chains = []
    fused = solver_mod.pack_solve_fused
    monkeypatch.setattr(solver_mod, "pack_solve_fused", lambda *a: chains.append(a) or fused(*a))
    for c, p in enumerate(problems):
        assert int(_buffer(p)[3]) > 0  # the row left pods unplaced
        got = solver.solve(p)
        assert chains == []  # no second pass
        assert got.stats["backend"] == 2.0 and p.__dict__["_race_kernel_lost"]
        assert "fleet_b" not in got.stats and not got.unschedulable
        assert validate(p, got) == []
        fresh = _encode(cells, provs, catalog, c)
        fresh.__dict__["_est_slots"] = (1 << 15, 16)
        serial = TorchSolver(device="cpu").solve(fresh)
        assert len(chains) == 1  # the fleet-free race dispatches once, then loses alike
        chains.clear()
        assert serial.stats["backend"] == 2.0 and fresh.__dict__["_race_kernel_lost"]
        assert validate(fresh, serial) == []


def test_chunks_follow_max_batch():
    """Five same-bucket cells at max_batch=4: one B=4 dispatch and one lone
    cell left to its own race; every cell's plan is valid."""
    cells, provs, catalog = _cells(5)
    problems = [_encode(cells, provs, catalog, c) for c in range(5)]
    solver = TorchSolver(device="cpu")
    before = dict(ts.LAUNCHES)
    stats = stage_fleet([(solver, p) for p in problems], max_batch=4)
    assert ts.LAUNCHES == before  # CPU tensors take the plain versions
    assert stats == {"dispatches": 1, "cells_batched": 4, "eligible": 5,
                     "buckets": ["g16o512e1s64z4r3k8b4"], "device_stacked": 0,
                     "superproblems": 0, "mesh_axes": ""}
    assert [("_fleet_dispatch" in p.__dict__) for p in problems] == [True] * 4 + [False]
    assert stage_fleet([(solver, problems[4])])["dispatches"] == 0
    assert [p.__dict__.get("_fleet_b") for p in problems] == [4] * 4 + [None]
    assert [p.__dict__.get("_budget_share") for p in problems] == [0.25] * 4 + [None]
    for p in problems:
        assert validate(p, solver.solve(p)) == []


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
