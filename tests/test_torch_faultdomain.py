"""The solver's fault domain on the CPU: the port's device-fault seams held
against the JAX package's (``tests/test_solver_faultdomain.py``).

Twin solvers, ``TPUSolver(auto_mesh=False, quality_sync=True,
aot_precompile=False)`` and ``TorchSolver(device="cpu")``, both in quality
mode, solve the same problems (pod sizes from numpy seeds) under the same
``DeviceFaultPlan``. For each of the six kinds they must book the same
``karpenter_tpu_kernel_faults_total`` kinds, leave their breakers in the
same states, consume the same faults, and answer from the same backend with
a valid plan. The reference pre-compiles no bucket in the background
(``aot_precompile=False``): a background compile consults the compile seam
at a time of its own. The port compiles nothing per shape; its compile seam
is consulted at a bucket label's first dispatch and at the first after the
label's breaker opened (``KernelBreakerBoard.first_dispatch``), so a bucket
is made cold in both packages by evicting the reference's executable and
forgetting the port's builds.

A small storm of controller rounds binds no invalid pod and recovers, in
both packages alike. A non-injected launch error still raises out of
``solve`` and ``reconcile``: only the injected ``InjectedDeviceError`` is
evidence. The seams at the port's fleet dispatch, which the reference's
fleet path does not have, are held on the port alone.
"""

from __future__ import annotations

import importlib
import time
from types import SimpleNamespace

import numpy as np
import pytest

from karpenter_tpu.solver import TPUSolver
from karpenter_tpu.solver import jax_solver as J
from karpenter_tpu_torch.solver import TorchSolver
from test_torch_controller import (  # noqa: F401  (fixtures)
    PACKAGES,
    _fresh_caches,
    _host_paths_run_dry,
    hold_fits,
)

REF, PORT = PACKAGES
#: the reference's storm order (``TestFaultStorm``)
STORM = ("garbage-result", "nan-result", "staging-corruption", "device-oom", "dispatch-hang",
         "compile-error")
KINDS = ("compile-error", "dispatch-hang", "device-oom", "nan-result", "garbage-result",
         "staging-corruption")
#: the kind the reference books each fault as
BOOKED = {"compile-error": "compile-error", "dispatch-hang": "dispatch-timeout",
          "device-oom": "device-oom", "nan-result": "nonfinite-plan",
          "garbage-result": "invalid-plan", "staging-corruption": "invalid-plan"}


def pkg_mod(pkg: str) -> SimpleNamespace:
    imp = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
    return SimpleNamespace(
        pkg=pkg, api=imp("api"), settings=imp("api.settings"), cloud=imp("cloudprovider"),
        state=imp("state"), prov=imp("controllers.provisioning"), faults=imp("utils.faults"),
        metrics=imp("utils.metrics"), solver=imp("solver.solver"), encode=imp("solver.encode"),
        validate=imp("solver.validate"), cache=imp("utils.cache"),
    )


MODS = {pkg: pkg_mod(pkg) for pkg in PACKAGES}


@pytest.fixture(autouse=True)
def _clean_fault_state():
    """No installed plan and a fresh board in both packages, before and
    after every case."""
    for m in MODS.values():
        m.faults.install_device_faults(None)
        m.solver.KERNEL_BOARD.configure(failure_threshold=3, recovery_timeout_s=30.0,
                                        clock=time.monotonic)
    yield
    for m in MODS.values():
        m.faults.install_device_faults(None)
        m.solver.KERNEL_BOARD.configure(failure_threshold=3, recovery_timeout_s=30.0,
                                        clock=time.monotonic)


def make_solver(pkg: str, **kw):
    kw.setdefault("latency_budget_s", 30.0)
    kw.setdefault("dispatch_timeout_s", 0.3)
    if pkg == REF:
        return TPUSolver(auto_mesh=False, quality_sync=True, aot_precompile=False, **kw)
    return TorchSolver(device="cpu", **kw)


def make_cold(pkg: str, solver, problem) -> None:
    """The problem's bucket (every bucket, for None) has no executable: the
    next dispatch compiles (the reference) or consults the compile seam
    (the port)."""
    if pkg == REF:
        if problem is None:
            J.AOT_CACHE.clear()
        else:
            J.AOT_CACHE.evict_bucket(solver._bucket_key(problem).label())
    else:
        MODS[PORT].solver.KERNEL_BOARD.forget_builds()


def rows(seed: int, n: int = 60):
    rng = np.random.default_rng(seed)
    cpu = rng.choice([250, 500, 1000, 1500], size=n)
    mem = rng.choice([256, 512, 1024, 2048], size=n)
    return [(int(c), int(mb)) for c, mb in zip(cpu, mem)]


def problem_of(pkg: str, seed: int, prefix: str, n: int = 60):
    """The same pods and provisioner in package ``pkg``, encoded."""
    m = MODS[pkg]
    api = m.api
    pods = [api.Pod(meta=api.ObjectMeta(name=f"{prefix}-{i}", owner_kind="ReplicaSet"),
                    requests=api.Resources(cpu=f"{c}m", memory=f"{mb}Mi"))
            for i, (c, mb) in enumerate(rows(seed, n))]
    prov = api.Provisioner(meta=api.ObjectMeta(name="default"))
    catalog = m.cloud.generate_catalog(n_types=12)
    return m.encode.encode(pods, [(prov, catalog)])


def faults_booked(pkg: str) -> dict:
    series = MODS[pkg].metrics.KERNEL_FAULTS
    with series._lock:
        return {dict(k)["kind"]: v for k, v in series._values.items()}


def delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}


def plan_for(pkg: str, kind: str, n: int = 1):
    f = MODS[pkg].faults
    return f.DeviceFaultPlan().script([f.DeviceFault(kind=kind, hang_s=5.0)] * n)


def solve_under(pkg: str, solver, problem, plan):
    """One solve with ``plan`` installed: what it booked, consumed and
    answered."""
    m = MODS[pkg]
    before = faults_booked(pkg)
    m.faults.install_device_faults(plan)
    t0 = time.perf_counter()
    try:
        result = solver.solve(problem)
    finally:
        m.faults.install_device_faults(None)
    return dict(
        booked=delta(before, faults_booked(pkg)),
        fired=[f.kind for _, f in plan.log] if plan is not None else [],
        pending=plan.pending() if plan is not None else 0,
        states=sorted(m.solver.KERNEL_BOARD.states().values()),
        backend=result.stats.get("backend"),
        fallback=result.stats.get("fallback"),
        unschedulable=sorted(result.unschedulable),
        violations=m.validate.validate(problem, result),
        cost=result.cost,
        seconds=time.perf_counter() - t0,
    )


def resident_alloc(pkg: str, solver) -> np.ndarray:
    """The host copy of ``alloc`` the solver's stager holds for its one
    resident cell (what the device copy was uploaded from)."""
    (entry,) = [e for tag, e in solver._stager._entries.items() if tag[0] == "cell"]
    return np.array(entry.host["alloc"])


def assert_twins(got: dict, want: dict) -> None:
    cost_got, cost_want = got.pop("cost"), want.pop("cost")
    got.pop("seconds"), want.pop("seconds")
    assert got == want
    assert cost_got == pytest.approx(cost_want, rel=1e-9)


@pytest.mark.parametrize("kind", KINDS)
def test_each_kind_is_booked_and_answered_as_the_reference(kind):
    """One fault of ``kind`` on a solve: the same kind booked, the same
    faults consumed, the same breaker states, the same backend and cost,
    and a valid plan with every pod placed; then a clean solve of a fresh
    problem of the same shape answers alike, and after a staging corruption
    it restages ``alloc`` (the self-heal)."""
    out = {}
    for pkg in PACKAGES:
        solver = make_solver(pkg)
        warm = problem_of(pkg, 1, "warm")
        solver.solve(warm)  # the bucket is built; the faulted solve dispatches at once
        problem = problem_of(pkg, 2, f"df-{kind}")
        if kind == "compile-error":
            make_cold(pkg, solver, problem)
        faulted = solve_under(pkg, solver, problem, plan_for(pkg, kind))
        resident = resident_alloc(pkg, solver)
        clean_problem = problem_of(pkg, 2, f"clean-{kind}")
        clean = solve_under(pkg, solver, clean_problem, None)
        true_alloc = np.asarray(clean_problem.__dict__["_prep_memo"][1][0]["alloc"]
                                if pkg == PORT else solver._prepare(clean_problem)[0].alloc)
        out[pkg] = (faulted, clean, (resident, resident_alloc(pkg, solver), true_alloc))
    (f_port, c_port, a_port), (f_ref, c_ref, a_ref) = out[PORT], out[REF]
    assert f_port["booked"] == {BOOKED[kind]: 1.0}
    assert f_port["fired"] == [kind] and f_port["pending"] == 0
    assert f_port["violations"] == [] and f_port["unschedulable"] == []
    if kind == "dispatch-hang":
        assert f_port["seconds"] < 4.0  # the deadline rescued it, not the 5 s hang
    assert_twins(f_port, f_ref)
    assert c_port["booked"] == {} and c_port["violations"] == []
    assert_twins(c_port, c_ref)
    for before, after, true in (a_port, a_ref):
        # the stager's resident copy of alloc: 4x the truth after the
        # corruption, the truth again after the next clean round (the leaf
        # restaged: the self-heal)
        assert np.array_equal(after, true)
        assert np.array_equal(before, true * 4.0 if kind == "staging-corruption" else true)


@pytest.mark.parametrize("threshold", [1, 2])
def test_breaker_transitions_match_reference(threshold):
    """Garbage plans open the bucket's breaker; an open bucket is not
    dispatched (its fault stays unfired) and the host answers; past the
    recovery timeout a clean half-open probe closes it. The same states,
    faults and answers round by round, on each package's ``FakeClock``."""
    trace = {}
    for pkg in PACKAGES:
        m = MODS[pkg]
        clock = m.cache.FakeClock(start=1000.0)
        m.solver.KERNEL_BOARD.configure(failure_threshold=threshold, recovery_timeout_s=5.0,
                                        clock=clock.now)
        solver = make_solver(pkg)
        steps = []
        for r, kind in enumerate(["garbage-result"] * threshold + ["garbage-result", None]):
            if r == threshold + 1:
                clock.step(6.0)  # past the recovery timeout: the next dispatch probes
            plan = plan_for(pkg, kind) if kind else None
            steps.append(solve_under(pkg, solver, problem_of(pkg, 3, f"br{r}"), plan))
        trace[pkg] = steps
    for got, want in zip(trace[PORT], trace[REF]):
        assert got["violations"] == [] and got["unschedulable"] == []
        assert_twins(got, want)
    states = [s["states"] for s in trace[PORT]]
    assert states[threshold - 1] == ["open"]
    assert trace[PORT][threshold]["pending"] == 1  # quarantined: not dispatched
    assert states[-1] == ["closed"]


@pytest.mark.parametrize("n_faults, threshold", [(3, 5), (3, 2)])
def test_compile_seam_fires_as_often_as_the_references(n_faults, threshold):
    """The same compile-error script gives the same count of
    ``compile-error``: the seam is consulted only while the bucket is
    unbuilt (a failed build leaves it unbuilt; the breaker opening forgets
    it), never on every dispatch."""
    counts = {}
    for pkg in PACKAGES:
        m = MODS[pkg]
        clock = m.cache.FakeClock(start=1000.0)
        m.solver.KERNEL_BOARD.configure(failure_threshold=threshold, recovery_timeout_s=5.0,
                                        clock=clock.now)
        solver = make_solver(pkg)
        first = problem_of(pkg, 4, "ce-cold")
        make_cold(pkg, solver, first)
        plan = plan_for(pkg, "compile-error", n_faults)
        before = faults_booked(pkg)
        m.faults.install_device_faults(plan)
        states = []
        try:
            for r in range(6):
                if r == 4:
                    clock.step(6.0)
                problem = first if r == 0 else problem_of(pkg, 4, f"ce{r}")
                result = solver.solve(problem)
                assert not result.unschedulable
                states.append(sorted(m.solver.KERNEL_BOARD.states().values()))
        finally:
            m.faults.install_device_faults(None)
        counts[pkg] = (delta(before, faults_booked(pkg)), plan.pending(), states)
    assert counts[PORT] == counts[REF]
    assert counts[PORT][0]["compile-error"] >= min(n_faults, threshold)


# ---------------------------------------------------------------------------
# Controller rounds under a storm
# ---------------------------------------------------------------------------

def audit(m, cluster) -> int:
    """Bindings that break allocatable, taints or labels (the reference's
    ``TestFaultStorm._audit``)."""
    Requirements = importlib.import_module(f"{m.pkg}.api.requirements").Requirements
    tolerates_all = importlib.import_module(f"{m.pkg}.api.taints").tolerates_all
    bad = 0
    by_node = {}
    for pod in cluster.pods.values():
        if pod.node_name is not None:
            by_node.setdefault(pod.node_name, []).append(pod)
    for node_name, pods in by_node.items():
        node = cluster.nodes.get(node_name)
        if node is None:
            bad += len(pods)
            continue
        total = m.api.Resources(pods=len(pods))
        surface = Requirements.from_labels(node.meta.labels)
        for pod in pods:
            total = total + pod.requests
            if not tolerates_all(list(pod.tolerations), tuple(node.taints)):
                bad += 1
            elif not any(surface.compatible(t) for t in pod.scheduling_requirement_terms()):
                bad += 1
        if not total.fits(node.allocatable):
            bad += 1
    return bad


def controller(pkg: str):
    m = MODS[pkg]
    cluster = m.state.Cluster()
    provider = m.cloud.FakeCloudProvider(catalog=m.cloud.generate_catalog(n_types=12))
    provider.create_batched = None
    ctl = m.prov.ProvisioningController(
        cluster, provider, solver=make_solver(pkg),
        settings=m.settings.Settings(batch_idle_duration=0, batch_max_duration=0),
    )
    cluster.add_provisioner(m.api.Provisioner(meta=m.api.ObjectMeta(name="default")))
    return m, cluster, ctl


def add_pods(m, cluster, prefix, seed, n=30):
    """``n`` pods of sizes from ``seed``, or of 1 CPU and 1 GiB each when
    ``seed`` is None."""
    sizes = rows(seed, n) if seed is not None else [(1000, 1024)] * n
    for i, (c, mb) in enumerate(sizes):
        cluster.add_pod(m.api.Pod(meta=m.api.ObjectMeta(name=f"{prefix}-{i}",
                                                        owner_kind="ReplicaSet"),
                                  requests=m.api.Resources(cpu=f"{c}m", memory=f"{mb}Mi")))


class TestFaultStorm:
    def test_storm_binds_no_invalid_pod_and_recovers_as_the_reference(self):
        """Six storm rounds, one kind each, then clean rounds: every round
        binds every pod with zero invalid bindings, the breaker trips during
        the storm and the board reads healthy again after it, and both
        packages book the same kinds round by round."""
        per_round = {}
        for pkg in PACKAGES:
            m, cluster, ctl = controller(pkg)
            # each package's FakeClock: every round after the first starts
            # past the recovery timeout, so its first dispatch is the
            # half-open probe whatever the round's wall time was
            clock = m.cache.FakeClock(start=1000.0)
            m.solver.KERNEL_BOARD.configure(failure_threshold=2, recovery_timeout_s=5.0,
                                            clock=clock.now)
            tripped = False
            rounds = []
            for r, kind in enumerate(STORM):
                clock.step(6.0)
                # the reference's storm: 30 pods of 1 CPU and 1 GiB a round,
                # so that every round lands on the buckets the clean rounds
                # after the storm probe and close
                add_pods(m, cluster, f"storm{r}", None)
                if kind == "compile-error":
                    make_cold(pkg, ctl.solver, None)
                before = faults_booked(pkg)
                m.faults.install_device_faults(plan_for(pkg, kind))
                try:
                    result = ctl.reconcile()
                finally:
                    m.faults.install_device_faults(None)
                assert audit(m, cluster) == 0, f"{pkg}: invalid binding in round {r}"
                hold_fits(cluster)
                assert not result.unschedulable and not cluster.pending_pods()
                tripped |= any(s != "closed" for s in m.solver.KERNEL_BOARD.states().values())
                rounds.append((kind, delta(before, faults_booked(pkg))))
            assert tripped, f"{pkg}: the storm never tripped the kernel breaker"
            for k in range(3):
                clock.step(6.0)
                add_pods(m, cluster, f"rec{k}", None)
                ctl.reconcile()
                if m.solver.KERNEL_BOARD.health() == 1.0:
                    break
            assert m.solver.KERNEL_BOARD.health() == 1.0
            assert audit(m, cluster) == 0 and not cluster.pending_pods()
            per_round[pkg] = rounds
        assert per_round[PORT] == per_round[REF]
        booked = {k for _, d in per_round[PORT] for k in d}
        assert booked <= set(BOOKED.values()) and booked


# ---------------------------------------------------------------------------
# What stays loud
# ---------------------------------------------------------------------------

def _broken(*args, **kwargs):
    raise RuntimeError("kernel launch failed")


def _bad_config(*args, **kwargs):
    raise ValueError("kernel launch failed: bad launch configuration")


@pytest.mark.parametrize("mode, wrapper", [("quality", _broken), ("latency", _broken),
                                           ("quality", _bad_config)],
                         ids=["quality", "latency", "quality-valueerror"])
def test_non_injected_launch_error_raises_out_of_solve(monkeypatch, mode, wrapper):
    """A real launch error is a fault of the program: with a plan of every
    kind installed, it still raises out of ``solve`` (quality mode's
    synchronous kernel and latency mode's raced dispatch alike), whatever
    its type, and is booked as no fault. Only ``InjectedDeviceError`` is
    caught."""
    psolver = MODS[PORT].solver
    monkeypatch.setattr(psolver, "pack_solve_fused", wrapper)
    solver = make_solver(PORT) if mode == "quality" else TorchSolver(
        device="cpu", latency_budget_s=1.0)
    problem = problem_of(PORT, 5, "loud", n=40 if mode == "quality" else 600)
    f = MODS[PORT].faults
    plan = f.DeviceFaultPlan().garbage_result(1).nan_result(1).staging_corruption(1)
    f.install_device_faults(plan)
    before = faults_booked(PORT)
    try:
        with pytest.raises((RuntimeError, ValueError), match="kernel launch failed"):
            solver.solve(problem)
    finally:
        f.install_device_faults(None)
    assert delta(before, faults_booked(PORT)) == {}


def test_non_injected_launch_error_raises_out_of_reconcile(monkeypatch):
    psolver = MODS[PORT].solver
    monkeypatch.setattr(psolver, "pack_solve_fused", _broken)
    m, cluster, ctl = controller(PORT)
    add_pods(m, cluster, "loud", 6, n=40)
    m.faults.install_device_faults(plan_for(PORT, "device-oom"))
    try:
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            ctl.reconcile()
    finally:
        m.faults.install_device_faults(None)
    assert cluster.nodes == {} and len(cluster.pending_pods()) == 40


# ---------------------------------------------------------------------------
# The port's own seams: the fleet dispatch
# ---------------------------------------------------------------------------

def fleet_entries(n_cells=2):
    entries = []
    for c in range(n_cells):
        solver = TorchSolver(device="cpu", latency_budget_s=1.0)
        entries.append((solver, problem_of(PORT, 20, f"cell{c}", n=600)))
    return entries


@pytest.mark.parametrize("kind, booked", [("device-oom", "device-oom"),
                                          ("compile-error", "compile-error")])
def test_fleet_dispatch_fault_books_and_cells_race_alone(kind, booked):
    """An injected OOM or compile failure at the fleet dispatch is booked
    on the fleet bucket, the chunk is not dispatched, and each cell then
    races on its own and answers validly."""
    board = MODS[PORT].solver.KERNEL_BOARD
    board.forget_builds()
    entries = fleet_entries()
    f = MODS[PORT].faults
    plan = f.DeviceFaultPlan().script([f.DeviceFault(kind=kind)])
    f.install_device_faults(plan)
    before = faults_booked(PORT)
    try:
        stats = MODS[PORT].solver.stage_fleet(entries)
        assert stats["dispatches"] == 0 and stats["eligible"] == 2
        assert all("_fleet_dispatch" not in p.__dict__ for _, p in entries)
        assert delta(before, faults_booked(PORT)) == {booked: 1.0}
        for solver, problem in entries:
            result = solver.solve(problem)
            assert MODS[PORT].validate.validate(problem, result) == []
    finally:
        f.install_device_faults(None)
    assert plan.pending() == 0


def test_fleet_dispatch_hang_is_a_miss_and_the_host_answers():
    """A hung fleet buffer is never ready inside the race's deadline: every
    cell's poll misses, the batch is abandoned, and the host answers."""
    entries = fleet_entries()
    f = MODS[PORT].faults
    f.install_device_faults(f.DeviceFaultPlan().dispatch_hang(seconds=30.0))
    try:
        stats = MODS[PORT].solver.stage_fleet(entries)
        assert stats["dispatches"] == 1
        shared = entries[0][1].__dict__["_fleet_dispatch"].shared
        for solver, problem in entries:
            result = solver.solve(problem)
            assert result.stats["backend"] != 1.0
            assert MODS[PORT].validate.validate(problem, result) == []
            assert problem.__dict__["_race_miss_count"] == 1
        assert shared.abandoned and shared.copies == 0
    finally:
        f.install_device_faults(None)


# ---------------------------------------------------------------------------
# Faults armed by time, as the soak arms them
# ---------------------------------------------------------------------------

#: the soak timeline's device-fault kinds (``ChurnScript.generate``)
SOAK_KINDS = ("compile-error", "staging-corruption", "nan-result", "garbage-result",
              "device-oom")


@pytest.mark.parametrize("kind", SOAK_KINDS)
def test_timed_fault_fires_and_books_as_the_reference(kind):
    """The soak's operator arms its faults by time (``DeviceFaultPlan.at``)
    and a fault fires only when a later round consults its seam. Twin
    latency-mode solvers (the operator's mode) solve a first 600-pod round
    before the fault arms and a second, on the same bucket, after: the
    reference and the port fire and book alike. A ``compile-error`` armed
    for a bucket already built meets no seam and stays pending in both;
    a ``staging-corruption`` fires at the second round's restage; a
    ``nan-result`` or ``garbage-result`` fires on the kernel's answer even
    though the host path wins the race; each fired fault is booked under
    the reference's kind."""
    out = {}
    for pkg in PACKAGES:
        m = MODS[pkg]
        if pkg == REF:
            solver = TPUSolver(auto_mesh=False, aot_precompile=False, latency_budget_s=1.0)
        else:
            solver = TorchSolver(device="cpu", latency_budget_s=1.0)
        now = [0.0]
        plan = m.faults.DeviceFaultPlan(clock=lambda: now[0])
        plan.at(5.0, m.faults.DeviceFault(kind=kind))
        first = problem_of(pkg, 1, "armed1", n=600)
        if pkg == REF:
            solver.warm_problem(first, wait=True)  # latency mode dispatches built buckets only
        m.faults.install_device_faults(plan)
        try:
            b0 = faults_booked(pkg)
            r1 = solver.solve(first)
            b1 = faults_booked(pkg)
            now[0] = 10.0  # past the arming time: the next consult pops it
            second = problem_of(pkg, 2, "armed2", n=600)
            r2 = solver.solve(second)
        finally:
            m.faults.install_device_faults(None)
        out[pkg] = dict(
            first=delta(b0, b1), fired=[f.kind for _, f in plan.log],
            booked=delta(b1, faults_booked(pkg)), pending=plan.pending(),
            backends=(r1.stats.get("backend"), r2.stats.get("backend")),
            valid=m.validate.validate(second, r2),
        )
    assert out[PORT] == out[REF]
    got = out[PORT]
    assert got["first"] == {} and got["valid"] == []
    if kind == "compile-error":
        assert got["fired"] == [] and got["booked"] == {} and got["pending"] == 1
    else:
        assert got["fired"] == [kind] and got["pending"] == 0
        assert got["booked"] == {BOOKED[kind]: 1.0}


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
