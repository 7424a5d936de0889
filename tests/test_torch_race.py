"""The solve race of ``TorchSolver.solve`` on the CPU, against the JAX
package's ``TPUSolver.solve``.

On the CPU the kernel chain runs as its plain PyTorch versions, inside the
dispatch, so the race's outcome does not depend on timing: a dispatched
buffer is always ready at the first poll. Both packages' process-wide
caches are cleared before each case (``test_torch_host.reset_caches``), and
each package encodes its own copy of the same pods.

Tolerances: costs to 1e-9 relative. In quality mode the port's answer must
be the reference's (winner backend and cost); in latency mode each side's
answer must be the cheaper of its two competitors, and race memory must
record a lost kernel exactly when it lost.
"""

import math

import numpy as np
import pytest
import torch

import bench
from karpenter_tpu.solver import TPUSolver
from karpenter_tpu.solver import encode as ref_encode
from karpenter_tpu.solver.jax_solver import AOT_CACHE
from karpenter_tpu_torch import configs
from karpenter_tpu_torch.solver import TorchSolver, encode, stage_fleet, validate
from karpenter_tpu_torch.solver import solver as solver_mod
from karpenter_tpu_torch.solver import torch_solver as ts
from karpenter_tpu_torch.solver.solver import KERNEL_BOARD
from test_torch_fleet import _cells, _encode
from test_torch_host import reset_caches
from test_torch_solver import _case

QUALITY = dict(latency_budget_s=5.0, quality_race=True)


@pytest.fixture(autouse=True)
def _fresh_caches():
    reset_caches()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    reset_caches()


@pytest.fixture
def chains(monkeypatch):
    """Counts the fused chains the solver module enqueues (single problems
    and fleets); on the CPU ``LAUNCHES`` stays at 0, since no kernel runs."""
    calls = {"fused": 0, "fleet": 0}
    fused, fleet = solver_mod.pack_solve_fused, solver_mod.pack_solve_fleet

    def count_fused(*args):
        calls["fused"] += 1
        return fused(*args)

    def count_fleet(*args):
        calls["fleet"] += 1
        return fleet(*args)

    monkeypatch.setattr(solver_mod, "pack_solve_fused", count_fused)
    monkeypatch.setattr(solver_mod, "pack_solve_fleet", count_fleet)
    return calls


#: the device round trip both races' admissions read: the CPU's, unloaded
#: (the measured one is ~1e-5 s), far inside the 0.1 s budget
PINNED_RTT_S = 1e-4


@pytest.fixture
def pinned_admission(monkeypatch):
    """Both races admit a dispatch on a measured latency: their bucket's
    dispatch latency, an average of the kernel solves timed before (each
    package's ``AOT_CACHE.predicted_dispatch_s``), or else their process
    round trip (``device_rtt``). On a loaded worker one slow sample (a
    kernel solve past the 0.1 s budget) turns the dispatch away, and the
    race answers from the host alone. Both packages' inputs are pinned to an
    unloaded CPU's round trip, so that every run admits the dispatch as an
    unloaded one does."""
    monkeypatch.setattr(TorchSolver, "_device_rtt_s", PINNED_RTT_S)
    monkeypatch.setattr(TPUSolver, "_device_rtt_s", PINNED_RTT_S)
    monkeypatch.setattr(AOT_CACHE, "predicted_dispatch_s", lambda *args, **kw: None)
    monkeypatch.setattr(ts.AOT_CACHE, "predicted_dispatch_s", lambda *args, **kw: None)


@pytest.mark.parametrize("name,winner", [
    ("full_2k", 2.0), ("topology_1k", 1.0), ("crossgroup_1k", 1.0), ("existing_nodes", 1.0),
])
def test_quality_race_matches_reference(name, winner):
    """Quality mode: the kernel answers synchronously beside the host
    competitor, and the cheaper validated answer wins: the host LP on the
    LP-safe 2,000 pods, the kernel on the others."""
    ref, port = _case(name)
    # the reference compiles a cold bucket inline with ``quality_sync``; the
    # port's buckets are warm from construction, so it has no such option
    want = TPUSolver(auto_mesh=False, quality_sync=True, **QUALITY).solve(ref)
    got = TorchSolver(device="cpu", **QUALITY).solve(port)
    assert got.stats["backend"] == want.stats["backend"] == winner
    assert got.cost == pytest.approx(want.cost, rel=1e-9)
    assert sorted(got.unschedulable) == sorted(want.unschedulable)
    assert validate(port, got) == []
    assert "fallback" not in got.stats


def _competitors(solver, problem, kernel_cost):
    """Run ``solver.solve(problem)`` in latency mode, recording the host
    competitor's cost as the race compares it. Returns the result, the host
    cost, and whether the kernel should have won."""
    seen = {}
    poll = solver._poll_dispatch

    def spy(p, dispatched, deadline, host_cost):
        seen["host"] = host_cost
        seen["dispatched"] = dispatched is not None
        return poll(p, dispatched, deadline, host_cost)

    solver._poll_dispatch = spy
    result = solver.solve(problem)
    assert seen["dispatched"], "the race did not dispatch the kernel"
    return result, seen["host"], kernel_cost < seen["host"]


@pytest.mark.parametrize("name", ["full_2k", "topology_1k", "existing_nodes"])
def test_latency_race_takes_the_cheaper_competitor(name, chains, pinned_admission):
    """Latency mode (budget 0.1 s): the kernel is dispatched before the host
    path, and the answer is the cheaper of the two competitors. The kernel
    competitor's cost is the kernel-only solve of a fresh copy (no slot
    budget regrow is needed on these problems). The reference's bucket is
    compiled first so that it dispatches too; a reference dispatch that
    misses its deadline leaves the race to its host answer. The latencies
    that admit the dispatch are pinned (``pinned_admission``)."""
    ref, port = _case(name)
    ref_copy, port_copy = _case(name)
    kernel = TorchSolver(device="cpu")._solve_kernel(port_copy)
    assert kernel.stats["fused_passes"] == 1.0
    chains["fused"] = 0
    solver = TorchSolver(device="cpu")
    got, host_cost, kernel_wins = _competitors(solver, port, kernel.cost)
    assert chains["fused"] == 1
    assert got.cost == pytest.approx(min(host_cost, kernel.cost), rel=1e-9)
    assert (got.stats["backend"] == 1.0) == kernel_wins
    assert port.__dict__.get("_race_kernel_lost", False) == (not kernel_wins)
    assert (port.__dict__.get("_race_kernel_result") is not None) == kernel_wins
    assert "_race_miss_count" not in port.__dict__
    assert validate(port, got) == []

    ref_solver = TPUSolver(auto_mesh=False)
    ref_solver.warm_problem(ref)
    ref_kernel = TPUSolver(auto_mesh=False)._solve_kernel(ref_copy)
    want, ref_host, ref_kernel_wins = _competitors(ref_solver, ref, ref_kernel.cost)
    if "_race_miss_count" in ref.__dict__:
        assert want.stats["backend"] != 1.0 and want.cost == pytest.approx(ref_host, rel=1e-9)
    else:
        assert want.cost == pytest.approx(min(ref_host, ref_kernel.cost), rel=1e-9)
        assert ref.__dict__.get("_race_kernel_lost", False) == (not ref_kernel_wins)
    assert ref_kernel.cost == pytest.approx(kernel.cost, rel=1e-9)
    if name == "full_2k":
        # the LP-safe problem: the host fast path wins, as in the reference
        assert got.stats["backend"] == want.stats["backend"] == 2.0


@pytest.mark.parametrize("name", ["full_2k", "topology_1k"])
def test_repeat_solve_dispatches_no_kernel(name, chains):
    """Race memory: a repeat solve of a problem whose kernel lost returns
    the host answer without dispatching; one whose kernel won replays the
    cached kernel answer against the host plan."""
    _, port = _case(name)
    solver = TorchSolver(device="cpu")
    first = solver.solve(port)
    assert chains["fused"] == 1
    lost = port.__dict__.get("_race_kernel_lost", False)
    launches = dict(ts.LAUNCHES)
    again = solver.solve(port)
    assert chains["fused"] == 1 and ts.LAUNCHES == launches
    assert again.cost <= first.cost + 1e-9
    if lost:
        assert again.stats["backend"] != 1.0
    else:
        assert port.__dict__["_race_kernel_result"] is not None
    assert validate(port, again) == []


def test_unsupported_shape_is_answered_by_the_greedy_oracle(chains):
    """A constraint shape the tensor path cannot express goes to
    ``GreedySolver``, as in the reference; no kernel runs."""
    port = encode(*configs.config_full(200, 10))
    ref = ref_encode(*bench._config_full(200, 10))
    for p in (port, ref):
        p.rel_unsupported = "cyclic required affinity"
    got = TorchSolver(device="cpu").solve(port)
    want = TPUSolver(auto_mesh=False).solve(ref)
    assert got.stats["backend"] == want.stats["backend"] == 0.0
    assert got.stats["fallback"] == want.stats["fallback"] == 1.0
    assert got.cost == pytest.approx(want.cost, rel=1e-9)
    assert chains == {"fused": 0, "fleet": 0}
    assert validate(port, got) == []


def test_breaker_opens_on_non_finite_plans_and_recovers(monkeypatch, chains):
    """Three non-finite kernel plans open the bucket's breaker: the kernel
    is then not dispatched and the greedy oracle answers; after the
    recovery timeout the next solve is the half-open probe, and its valid
    plan closes the breaker."""
    now = [1000.0]
    KERNEL_BOARD.configure(failure_threshold=3, recovery_timeout_s=30.0, clock=lambda: now[0])
    _, port = _case("topology_1k")
    solver = TorchSolver(device="cpu")
    label = solver._bucket_key(port).label()
    unpack = solver_mod.unpack_solve_fused

    def nonfinite(*args):
        order, unplaced, costs, *rest = unpack(*args)
        return (order, unplaced, np.full_like(costs, np.nan), *rest)

    monkeypatch.setattr(solver_mod, "unpack_solve_fused", nonfinite)
    for i in range(3):
        assert KERNEL_BOARD.allows(label)
        assert solver._solve_kernel(port) is None
    assert chains["fused"] == 3
    assert KERNEL_BOARD.state(label) == "open" and not KERNEL_BOARD.allows(label)
    assert KERNEL_BOARD.failures == {"nonfinite-plan": 3}
    # open: no dispatch
    assert solver._solve_kernel(port) is None and chains["fused"] == 3
    now[0] += 31.0
    assert KERNEL_BOARD.state(label) == "half-open" and KERNEL_BOARD.allows(label)
    monkeypatch.setattr(solver_mod, "unpack_solve_fused", unpack)
    probe = solver._solve_kernel(port)
    assert probe is not None and probe.stats["backend"] == 1.0 and chains["fused"] == 4
    assert KERNEL_BOARD.state(label) == "closed"
    assert validate(port, probe) == []


def test_quarantined_bucket_is_answered_by_the_greedy_oracle():
    """With the bucket's breaker open, a quality-mode solve of a shape the
    host paths cannot answer falls back to the greedy oracle."""
    KERNEL_BOARD.configure(failure_threshold=1, recovery_timeout_s=1e9)
    _, port = _case("topology_1k")
    solver = TorchSolver(device="cpu", latency_budget_s=5.0)
    KERNEL_BOARD.fail(solver._bucket_key(port).label(), "invalid-plan")
    got = solver.solve(port)
    assert got.stats["backend"] == 0.0 and got.stats["fallback"] == 1.0
    assert validate(port, got) == []


def test_stage_fleet_admission():
    """stage_fleet batches only what the per-cell race would dispatch, and
    stamps each batched problem's fleet width and round-budget share."""
    cells, provs, catalog = _cells(8)
    problems = [_encode(cells, provs, catalog, c) for c in range(8)]
    solver, quality = TorchSolver(device="cpu"), TorchSolver(device="cpu", latency_budget_s=5.0)
    tiny = encode(*configs.config_full(100, 10))
    lost, cached, skipped = problems[2], problems[3], problems[4]
    solver._mark_kernel_lost(lost)
    cached.__dict__["_race_kernel_result"] = object()
    cached.__dict__["_race_memory_at"] = float("inf")
    skipped.__dict__["_fleet_skip"] = True
    entries = [(solver, problems[0]), (solver, problems[1]), (solver, lost), (solver, cached),
               (solver, skipped), (quality, problems[5]), (solver, tiny), (solver, tiny)]
    stats = stage_fleet(entries)
    assert stats["eligible"] == 2 and stats["cells_batched"] == 2 and stats["dispatches"] == 1
    assert stats["buckets"][0].endswith("b2")
    for p in problems[:2]:
        assert "_fleet_dispatch" in p.__dict__
        assert p.__dict__["_fleet_b"] == 2 and p.__dict__["_budget_share"] == 0.5
    for p in problems[2:6] + [tiny]:
        assert "_fleet_dispatch" not in p.__dict__ and "_fleet_b" not in p.__dict__

    # a device round trip beyond the latency budget: nothing is batched
    slow = TorchSolver(device="cpu", latency_budget_s=1e-12)
    fresh = [_encode(cells, provs, catalog, c) for c in (6, 7)]
    stats = stage_fleet([(slow, p) for p in fresh])
    assert stats["eligible"] == 2 and stats["dispatches"] == 0
    # an open race breaker: nothing is eligible
    solver._race_fails = 3
    assert stage_fleet([(solver, p) for p in fresh])["eligible"] == 0
    # the race-outcome memory expires after its TTL
    short = TorchSolver(device="cpu", race_memory_ttl_s=0.0)
    short._mark_kernel_lost(fresh[0])
    fresh[0].__dict__["_race_memory_at"] -= 1.0
    assert stage_fleet([(short, p) for p in fresh])["cells_batched"] == 2
    assert "_race_kernel_lost" not in fresh[0].__dict__


def test_rtt_probe_and_device_rtt():
    x = torch.tensor([0, 1, -1, 7, 2**31 - 1, -2**31, 42, 5], dtype=torch.int32)
    want = torch.tensor([1, 2, 0, 8, -2**31, -2**31 + 1, 43, 6], dtype=torch.int32)
    assert torch.equal(ts.rtt_probe_ref(x), want)
    assert torch.equal(ts.rtt_probe(x), want)  # a CPU tensor takes the plain version
    solver = TorchSolver(device="cpu")
    launches = dict(ts.LAUNCHES)
    rtt = solver.device_rtt()
    assert math.isfinite(rtt) and 0.0 <= rtt < 1.0
    assert TorchSolver._device_rtt_s == rtt and solver.device_rtt() == rtt
    assert TorchSolver(device="cpu").device_rtt() == rtt  # once per process
    assert ts.LAUNCHES == launches
