"""The sharded provisioning round on the CPU: the port's
``ProvisioningController`` with ``cell_sharding_enabled`` against the JAX
package's on twin clusters.

Each package builds its own cluster, provider and settings from the same
rows (pod sizes from a numpy seed) and solves with a test-side solver
subclass whose default construction is what the test wants, because the
sharded round builds its per-cell clones by default construction:
``TPUSolver(auto_mesh=False, ...)`` (a default ``TPUSolver`` would build the
8-virtual-device portfolio mesh of ``tests/conftest.py``) and
``TorchSolver(device="cpu", ...)``. Both run in quality mode, so the race's
winner does not depend on timing, except in the fleet case, which needs
latency mode to batch. The host paths polish without their deadlines
(``_host_paths_run_dry``, shared with ``test_torch_controller.py``), and
machines launch one at a time in plan order (``create_batched = None``):
node names come from a process-wide sequence and enter the next round's
digests. Both packages' fake providers read a clock held still
(``_fake_provider_clock``): their catalog cache keys on the minute, and a
round on the far side of a minute boundary gets a new instance-type list,
which no clean cell's cached solve matches.

After every round the two packages must agree on the unschedulable, bound
and pending pods, the launched nodes as a multiset of (instance type, zone,
capacity type, sorted pod names), the round's cost (1e-9 relative), every
cell's problem digest and encode mode, the round's stats (cells, reused
cells, residue pods, fleet dispatches and batched cells), its
"sharded-round" decision record and each launched node's explanation in the
decision log (with its rejected alternatives). The cases are the reference's
``TestShardedEquivalence`` and ``TestCleanCellReuse`` ones
(``tests/test_cells.py``), a fleet round, and the port at 1 and 4 workers.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

from karpenter_tpu.solver import TPUSolver
from karpenter_tpu.solver import jax_solver as J
from karpenter_tpu.solver.solver import GreedySolver as RefGreedy
from karpenter_tpu_torch.solver import TorchSolver
from karpenter_tpu_torch.solver.solver import GreedySolver as PortGreedy
from test_torch_controller import (  # noqa: F401  (fixtures)
    PACKAGES,
    QUALITY,
    _fresh_caches,
    _host_paths_run_dry,
    hold_fits,
    mixed_rows,
    outcome,
    pkg_mod,
)

STATS = ("cells", "cells_reused", "residue_pods", "fleet_dispatches", "fleet_cells_batched")


class RefQuality(TPUSolver):
    def __init__(self, **kw):
        super().__init__(**{"auto_mesh": False, "quality_sync": True, **QUALITY, **kw})


class PortQuality(TorchSolver):
    def __init__(self, **kw):
        super().__init__(**{"device": "cpu", **QUALITY, **kw})


# latency mode, the longest budget that keeps it: the JAX package admits a
# fleet only when its measured dispatch time is inside the budget, and on a
# loaded machine its CPU dispatches can take longer than the default 0.1 s
LATENCY = dict(latency_budget_s=1.0)


class RefLatency(TPUSolver):
    def __init__(self, **kw):
        super().__init__(**{"auto_mesh": False, **LATENCY, **kw})


class PortLatency(TorchSolver):
    def __init__(self, **kw):
        super().__init__(**{"device": "cpu", **LATENCY, **kw})


SOLVERS = {
    "quality": {"karpenter_tpu": RefQuality, "karpenter_tpu_torch": PortQuality},
    "latency": {"karpenter_tpu": RefLatency, "karpenter_tpu_torch": PortLatency},
    # the decomposition contract is exact for the greedy oracle, as in the
    # reference's own test: a joint LP may break ties between equal-cost
    # packings otherwise than two cells' LPs do
    "greedy": {"karpenter_tpu": RefGreedy, "karpenter_tpu_torch": PortGreedy},
}


@pytest.fixture(autouse=True, scope="module")
def _reference_executables_dropped():
    """The JAX package's executable cache is process-wide and keeps each
    bucket's measured dispatch time, which its race admission reads: the
    fleet case's latency-mode rounds must not leave their buckets, or their
    dispatch times, to a later test file on this worker."""
    yield
    J.AOT_CACHE.wait_idle(timeout=300)
    J.AOT_CACHE.clear()


@pytest.fixture(autouse=True)
def _fake_provider_clock(monkeypatch):
    """Hold ``time.time()`` still for both packages' ``cloudprovider.fake``
    (it stamps launches and keys the catalog cache on
    ``int(time.time() // 60)``). Clean-cell reuse keys on the catalog list's
    identity, so two rounds that straddled a minute rebuilt the list and
    missed reuse: ``test_quiet_cells_reuse_cached_solves`` failed so under
    load, and fails so on demand when the clock steps across a minute
    between its rounds."""
    import types

    import karpenter_tpu.cloudprovider.fake as rfake
    import karpenter_tpu_torch.cloudprovider.fake as pfake

    now = time.time()
    pinned = types.SimpleNamespace(time=lambda: now)
    for mod in (rfake, pfake):
        monkeypatch.setattr(mod, "time", pinned)


@pytest.fixture(autouse=True)
def _decision_logs():
    from karpenter_tpu.utils.decisions import DECISIONS as RDEC
    from karpenter_tpu_torch.utils.decisions import DECISIONS as PDEC

    for log in (RDEC, PDEC):
        log.configure(2048)
        log.clear()
    yield {"karpenter_tpu": RDEC, "karpenter_tpu_torch": PDEC}
    for log in (RDEC, PDEC):
        log.clear()


class Env:
    """One package's cluster, provider and sharded controller."""

    def __init__(self, pkg, mode="quality", n_types=12, sharded=True, **settings_kw):
        m = self.m = pkg_mod(pkg)
        self.pkg = pkg
        self.cluster = m.state.Cluster()
        self.provider = m.cloud.FakeCloudProvider(catalog=m.cloud.generate_catalog(n_types=n_types))
        self.provider.create_batched = None
        settings = m.settings.Settings(batch_idle_duration=0, batch_max_duration=0,
                                       cell_sharding_enabled=sharded, **settings_kw)
        self.ctl = m.prov.ProvisioningController(
            self.cluster, self.provider, solver=SOLVERS[mode][pkg](), settings=settings)

    def prov(self, name, pool, **kw):
        api = self.m.api
        self.cluster.add_provisioner(api.Provisioner(
            meta=api.ObjectMeta(name=name), labels={"pool": pool}, **kw))

    def pods(self, prefix, rows, pool=None):
        api = self.m.api
        for i, (cpu, mem) in enumerate(rows):
            self.cluster.add_pod(api.Pod(
                meta=api.ObjectMeta(name=f"{prefix}-{i}", owner_kind="ReplicaSet"),
                requests=api.Resources(cpu=f"{cpu}m", memory=f"{mem}Mi"),
                node_selector={"pool": pool} if pool else {},
            ))

    def reconcile(self):
        result = self.ctl.reconcile()
        hold_fits(self.cluster)
        return result


def twins(mode="quality", **kw):
    return {pkg: Env(pkg, mode, **kw) for pkg in PACKAGES}


def round_view(env, result, log):
    """What a sharded round must give the same in both packages."""
    out = outcome(env.m, env.cluster, env.provider, result)
    solve = result.solve
    if solve is not None:
        out["cost"] = solve.cost
        out["digest"] = solve.problem_digest
        out["stats"] = {k: solve.stats.get(k) for k in STATS}
    router = env.ctl.cells
    out["cells"] = [(s["name"], s["pods"], s["digest"], s["encode_mode"], s["unschedulable"])
                    for s in router.last_round]
    out["router_mode"] = (router.last_mode, router.last_full_reason)
    out["records"] = [(r.outcome, r.details) for r in log.query(kind="cell")]
    # each launched node's explanation, with its rejected alternatives
    out["nominations"] = sorted(
        repr(sorted((k, v) for k, v in r.details.items() if k != "machine"))
        for r in log.query(kind="nomination", limit=1 << 20))
    log.clear()
    return out


def reconcile_twins(envs, logs):
    views, results = {}, {}
    for pkg, env in envs.items():
        results[pkg] = env.reconcile()
        views[pkg] = round_view(env, results[pkg], logs[pkg])
    ref, got = views["karpenter_tpu"], views["karpenter_tpu_torch"]
    cost_ref, cost_got = ref.pop("cost", None), got.pop("cost", None)
    ref.pop("price"), got.pop("price")
    assert got == ref
    if cost_ref is not None:
        assert cost_got == pytest.approx(cost_ref, rel=1e-9, abs=1e-12)
    assert "rejected" not in " ".join(got["verdicts"])
    return results["karpenter_tpu_torch"], got


def bindings(env):
    """pod -> (instance type, zone, capacity type) of its node."""
    wk = env.m.wk
    out = {}
    for pod in env.cluster.pods.values():
        node = env.cluster.nodes.get(pod.node_name) if pod.node_name else None
        if node is not None:
            lab = node.meta.labels
            out[pod.meta.name] = (lab[wk.INSTANCE_TYPE], lab[wk.ZONE], lab[wk.CAPACITY_TYPE])
    return out


@pytest.mark.parametrize("seed", range(2))
def test_single_feasible_cells_match_flat_and_reference(seed, _decision_logs):
    """Every pod single-feasible: the port's sharded rounds equal the JAX
    package's, and place and cost what the port's flat rounds do (the
    greedy oracle solves, as in the reference's test)."""
    rng = np.random.default_rng(seed)
    envs = twins("greedy", cell_shard_workers=2)
    flats = {pkg: Env(pkg, "greedy", sharded=False) for pkg in PACKAGES}
    for env in [*envs.values(), *flats.values()]:
        env.prov("cell-a", "a")
        env.prov("cell-b", "b")
    serial = 0
    for _ in range(3):
        adds = []
        for _ in range(int(rng.integers(2, 6))):
            serial += 1
            adds.append((f"eq{serial}", "ab"[int(rng.integers(0, 2))],
                         mixed_rows(int(rng.integers(0, 1 << 30)), int(rng.integers(20, 80)))))
        for env in [*envs.values(), *flats.values()]:
            for prefix, pool, rows in adds:
                env.pods(prefix, rows, pool)
        # each package's flat controller launches after its sharded one, so
        # the machine names the two packages hand out stay in step
        res, view = reconcile_twins(envs, _decision_logs)
        assert view["stats"]["cells"] == 2.0 and view["stats"]["residue_pods"] == 0.0
        for pkg in PACKAGES:
            flat = flats[pkg].reconcile()
            assert bindings(flats[pkg]) == bindings(envs[pkg])
            assert sorted(flat.unschedulable) == view["unschedulable"]
            assert flat.solve.cost == pytest.approx(res.solve.cost, rel=1e-9, abs=1e-12)


def test_residue_pods_place_via_arbitration(_decision_logs):
    envs = twins()
    for env in envs.values():
        env.prov("cell-a", "a")
        env.prov("cell-b", "b")
        env.pods("res", mixed_rows(41, 30))  # feasible in both cells: residue
        env.pods("cell", mixed_rows(42, 40), "a")
    res, view = reconcile_twins(envs, _decision_logs)
    assert not view["unschedulable"] and not view["pending"]
    assert view["stats"]["cells"] == 1.0 and view["stats"]["residue_pods"] == 30.0
    assert [r[0] for r in view["records"]] == ["sharded-round"]


def test_arbitration_never_double_books_existing(_decision_logs):
    """A warm round builds cell-a's nodes; then cell and residue pods
    compete for what they left free. ``hold_fits`` checks every node."""
    envs = twins()
    for env in envs.values():
        env.prov("cell-a", "a")
        env.prov("cell-b", "b")
        env.pods("warm", [(500, 512)] * 4, "a")
    reconcile_twins(envs, _decision_logs)
    for env in envs.values():
        env.pods("cellpod", [(500, 512)] * 2, "a")
        env.pods("respod", [(500, 512)] * 2)
    _, view = reconcile_twins(envs, _decision_logs)
    assert not view["pending"]


def test_cell_overflow_solves_flat(_decision_logs):
    envs = twins(cell_max_pods=2)
    for env in envs.values():
        env.prov("cell-a", "a")
        env.pods("of", mixed_rows(51, 5), "a")
    _, view = reconcile_twins(envs, _decision_logs)
    assert not view["pending"]
    assert view["router_mode"] == ("full", "cell-overflow")
    assert "stats" in view and view["stats"]["cells"] is None  # the flat solve's stats


def test_quiet_cells_reuse_cached_solves(_decision_logs):
    envs = twins()
    for env in envs.values():
        env.prov("cell-a", "a")
        env.prov("cell-b", "b")
        env.pods("stuck-a", [(10**8, 128)], "a")  # fits no instance type
        env.pods("stuck-b", [(10**8, 128)], "b")
    _, first = reconcile_twins(envs, _decision_logs)
    assert first["stats"]["cells_reused"] == 0.0
    _, second = reconcile_twins(envs, _decision_logs)
    assert second["stats"]["cells_reused"] == 2.0
    assert second["digest"] == first["digest"]
    assert [c[3] for c in second["cells"]] == ["reused", "reused"]
    for env in envs.values():
        env.pods("fresh-b", [(250, 256)] * 3, "b")
    _, third = reconcile_twins(envs, _decision_logs)
    assert third["stats"]["cells_reused"] == 1.0
    assert [c[3] for c in third["cells"]] == ["reused", "delta"]


def test_exhausted_pool_lends_its_pods_to_the_residue(_decision_logs):
    """A cell whose provisioner's limits are used up cascades its pods
    through the residue, sessionless; the residue session stays empty."""
    envs = twins()
    for env in envs.values():
        env.prov("cell-a", "a", limits=env.m.api.Resources(cpu="0.001"))
        env.prov("cell-b", "b")
        env.pods("loan", [(250, 256)] * 2, "a")
        env.pods("ok", [(250, 256)] * 3, "b")
    _, view = reconcile_twins(envs, _decision_logs)
    assert view["unschedulable"] == ["loan-0", "loan-1"]
    # the first cascade round solves both cells; cell-a's launch is refused
    # by its limits, and the next cascade round lends its pods to the residue
    rounds = sorted((d["cells"], d["residue_pods"]) for _, d in view["records"])
    assert rounds == [(0, 2), (2, 0)]
    router = envs["karpenter_tpu_torch"].ctl.cells
    residue = router._sessions.get(envs["karpenter_tpu_torch"].m.state.cells.RESIDUE)
    assert residue is None or not residue.ordered_pods()
    names = [p.name for p in router.ordered_pods()]
    assert len(names) == len(set(names))


def fleet_envs(workers=2, pkgs=PACKAGES):
    """Three cells of 500 pods each (above ``race_min_pods``), in latency
    mode so that ``stage_fleet`` batches them."""
    envs = {pkg: Env(pkg, "latency", cell_shard_workers=workers) for pkg in pkgs}
    for env in envs.values():
        for c, pool in enumerate("abc"):
            env.prov(f"cell-{pool}", pool)
            env.pods(f"f{pool}", mixed_rows(60 + c, 500), pool)
    return envs


def fleet_rounds(envs, check):
    """The fleet case's rounds: a seed round, then one that adds 500 pods
    to each of two of the three cells."""
    check(envs)
    for env in envs.values():
        for pool in "ab":
            env.pods(f"g{pool}", mixed_rows(70, 500), pool)
    check(envs)


def warm_reference():
    """The JAX package compiles a bucket in the background and admits it to
    the race only once it is resident: run the fleet rounds on throwaway
    twins until every bucket they use, fleet buckets included, is warm."""
    for _ in range(2):
        fleet_rounds(fleet_envs(pkgs=("karpenter_tpu",)),
                     lambda envs: (envs["karpenter_tpu"].reconcile(),
                                   J.AOT_CACHE.wait_idle(timeout=300)))
    # the throwaway rounds took machine names: start the sequence over, as
    # the port's is, since names enter the next round's digests
    ref = pkg_mod("karpenter_tpu").prov
    ref._machine_ids = ref.MachineNameSeq()


def test_fleet_round_matches_reference(_decision_logs):
    warm_reference()
    _decision_logs["karpenter_tpu"].clear()
    seen = []

    def check(envs):
        _, view = reconcile_twins(envs, _decision_logs)
        assert not view["pending"] and not view["unschedulable"]
        seen.append(view["stats"])

    fleet_rounds(fleet_envs(), check)
    assert seen[0]["fleet_dispatches"] == 1.0 and seen[0]["fleet_cells_batched"] == 3.0
    assert seen[1]["cells"] == 2.0  # cell c's pods are all bound: it has no cell
    assert seen[1]["fleet_dispatches"] == 1.0 and seen[1]["fleet_cells_batched"] == 2.0


def phase_series(env) -> dict:
    """``karpenter_tpu_solve_phase_seconds``: observations per (phase,
    mode) series."""
    import importlib

    hist = importlib.import_module(f"{env.pkg}.utils.metrics").SOLVE_PHASE
    with hist._lock:
        return dict(hist._totals)


def test_fleet_rounds_emit_the_references_solve_phase_series(_decision_logs):
    """Twin sharded rounds observe the same ``solve_phase_seconds`` series
    as many times each, the fleet path's ``{phase="stage", mode="sharded"}``
    among them (one observation a fleet dispatch)."""
    warm_reference()
    _decision_logs["karpenter_tpu"].clear()
    moved = []

    def check(envs):
        before = {pkg: phase_series(env) for pkg, env in envs.items()}
        reconcile_twins(envs, _decision_logs)
        delta = {}
        for pkg, env in envs.items():
            after = phase_series(env)
            delta[pkg] = {k: n - before[pkg].get(k, 0) for k, n in after.items()
                          if n != before[pkg].get(k, 0)}
        assert delta["karpenter_tpu_torch"] == delta["karpenter_tpu"]
        moved.append(delta["karpenter_tpu_torch"])

    fleet_rounds(fleet_envs(), check)
    stage = (("mode", "sharded"), ("phase", "stage"))
    assert [d.get(stage) for d in moved] == [1, 1]


def test_port_answers_alike_at_one_and_four_workers(_decision_logs):
    """Worker count changes the wall clock, never the answer: the fleet
    rounds on the port at 1 and at 4 workers."""
    port = "karpenter_tpu_torch"
    views = {}
    for workers in (1, 4):
        pkg_mod(port).prov._machine_ids = pkg_mod(port).prov.MachineNameSeq()
        rounds = []

        def check(envs):
            env = envs[port]
            result = env.reconcile()
            rounds.append(round_view(env, result, _decision_logs[port]))

        fleet_rounds(fleet_envs(workers, (port,)), check)
        views[workers] = rounds
    for one, four in zip(views[1], views[4]):
        assert [r[1].pop("workers") for r in one["records"]] == [1]
        assert [r[1].pop("workers") for r in four["records"]] == [4]
        assert one == four
    assert views[1][0]["stats"]["fleet_dispatches"] == 1.0


def cells_config(pkg, n_pods, n_cells):
    """``configs.config_controller_cells`` in package ``pkg``: the port's
    own, or its twin built with the JAX package's API (the same
    provisioners, pod names, requests and order, the same churn), each
    solving with the package's quality-mode solver."""
    from karpenter_tpu_torch import configs

    cluster, provider, settings, churn = configs.config_controller_cells(n_pods, n_cells)
    if pkg == "karpenter_tpu":
        m = pkg_mod(pkg)
        api = m.api
        twin, twin_churn = cluster, churn
        cluster = m.state.Cluster()
        for p in sorted(twin.provisioners.values(), key=lambda p: p.name):
            cluster.add_provisioner(api.Provisioner(meta=api.ObjectMeta(name=p.name),
                                                    labels=dict(p.labels)))

        def convert(p):
            return api.Pod(meta=api.ObjectMeta(name=p.name),
                           requests=api.Resources(p.requests.to_dict()),
                           node_selector=dict(p.node_selector))

        for p in twin.pods.values():
            cluster.add_pod(convert(p))
        provider = m.cloud.FakeCloudProvider(catalog=m.cloud.generate_catalog(n_types=60))
        for subnet in provider.subnets:
            subnet.available_ips = 1 << 20
        settings = m.settings.Settings(
            batch_idle_duration=0, batch_max_duration=0, cell_sharding_enabled=True,
            cell_shard_workers=settings.cell_shard_workers,
            fleet_max_batch=settings.fleet_max_batch)

        def churn(r):
            events = twin_churn(r)
            for removed, added in events.values():
                for p in removed:
                    cluster.delete_pod(p.name)
                for p in added:
                    cluster.add_pod(convert(p))
            return events

    provider.create_batched = None
    env = Env.__new__(Env)
    env.m, env.pkg, env.cluster, env.provider = pkg_mod(pkg), pkg, cluster, provider
    env.ctl = env.m.prov.ProvisioningController(cluster, provider, solver=SOLVERS["quality"][pkg](),
                                                settings=settings)
    return env, churn


def test_controller_cells_config_matches_reference(_decision_logs):
    """``config_controller_cells`` at 2,000 pods in 8 cells, a seed round
    and three churn rounds, in both packages. What the chip's
    ``controller_sharded`` phase expects of a churn round comes from here:
    only the churned cells have pending pods, so a churn round has 4 cells
    and reuses none (every other cell's pods were bound, so it has no cell
    this round); round 0's cells were seeded in the seed round and
    delta-encode, later rounds' cells emptied out and start afresh."""
    envs, churns = {}, {}
    for pkg in PACKAGES:
        envs[pkg], churns[pkg] = cells_config(pkg, 2000, 8)
    views = []
    for rnd in ["seed", 0, 1, 2]:
        if rnd != "seed":
            for pkg in PACKAGES:
                churns[pkg](rnd)
        _, view = reconcile_twins(envs, _decision_logs)
        assert not view["pending"] and not view["unschedulable"], rnd
        views.append(view)
    assert [v["stats"]["cells"] for v in views] == [8.0, 4.0, 4.0, 4.0]
    assert all(v["stats"]["cells_reused"] == 0.0 for v in views)
    assert [sorted({c[3] for c in v["cells"]}) for v in views] == [
        ["full"], ["delta"], ["full"], ["full"]]
    assert [v["router_mode"] for v in views[2:]] == [("full", "first-encode")] * 2


# ---------------------------------------------------------------------------
# the locks the fan-out needs
# ---------------------------------------------------------------------------

def hammer(fn, threads=8, calls=2000):
    """``fn(t)`` ``calls`` times on each of ``threads`` threads at once, with
    a short switch interval so that a lost update would show."""
    import sys
    import threading

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    barrier = threading.Barrier(threads)

    def run(t):
        barrier.wait(timeout=60)
        for _ in range(calls):
            fn(t)

    workers = [threading.Thread(target=run, args=(t,)) for t in range(threads)]
    try:
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    return threads * calls


def test_launch_counts_are_exact_across_threads(monkeypatch):
    from karpenter_tpu_torch.solver import torch_solver as ts

    monkeypatch.setattr(ts, "LAUNCHES", dict.fromkeys(ts.LAUNCHES, 0))
    monkeypatch.setattr(ts, "BATCHED", dict.fromkeys(ts.BATCHED, 0))
    n = hammer(lambda t: (ts._count("pack_member", 1 + t % 2), ts._count("stage_patch")),
               calls=20000)
    assert ts.LAUNCHES["pack_member"] == n and ts.LAUNCHES["stage_patch"] == n
    assert ts.BATCHED["pack_member"] == n // 2


def test_kernel_library_loads_once_across_threads(monkeypatch):
    import ctypes
    import time

    from karpenter_tpu_torch.solver import _build

    calls = []

    def build():
        calls.append("build")
        time.sleep(0.05)  # a build long enough for every thread to ask
        return "libkts.so"

    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: SimpleLib(path))
    monkeypatch.setattr(_build, "bind", lambda lib: lib)
    libs = []
    hammer(lambda t: libs.append(_build.load_kernels()), calls=5)
    assert calls == ["build"] and len({id(lib) for lib in libs}) == 1


class SimpleLib:
    def __init__(self, path):
        self.path = path


def test_fleet_buffer_copies_to_the_host_once():
    from karpenter_tpu_torch.solver import solver as solver_mod

    copies = []

    class Pending:
        events = None

        def is_ready(self):
            return True

        def materialize(self):
            copies.append(1)
            return np.arange(12, dtype=np.int32).reshape(3, 4)

    shared = solver_mod._FleetBuffer(Pending(), None, 0.0, 3)
    rows = []
    hammer(lambda t: rows.append(shared.materialize()[t % 3].tolist()), calls=200)
    assert copies == [1] and shared.copies == 1
    assert sorted({tuple(r) for r in rows}) == [(0, 1, 2, 3), (4, 5, 6, 7), (8, 9, 10, 11)]


def test_breakers_and_stager_keep_exact_books():
    from karpenter_tpu_torch.solver.solver import KernelBreakerBoard
    from karpenter_tpu_torch.solver.staging import DeviceStager

    board = KernelBreakerBoard(failure_threshold=10**9)
    n = hammer(lambda t: board.fail(f"b{t % 2}", "invalid-plan"), calls=20000)
    assert board.failures == {"invalid-plan": n}
    assert board._set.get("b0")._failures + board._set.get("b1")._failures == n
    stager = DeviceStager(device="cpu")
    leaves = [{"x": np.full((64, 4), t, np.float32)} for t in range(8)]
    n = hammer(lambda t: stager.stage(("cell", t), leaves[t]), calls=50)
    assert stager.stats["hits"] + stager.stats["staged_leaves"] == n
    assert stager.stats["staged_leaves"] == 8  # one upload a tag, then hits
    off = DeviceStager(device="cpu", enabled=False)
    out = off.stage(("cell",), leaves[0])
    assert np.array_equal(out["x"].numpy(), leaves[0]["x"]) and off.resident_bytes() == 0


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
