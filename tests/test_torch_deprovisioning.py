"""The deprovisioning round on the CPU: the port's ``DeprovisioningController``
against the JAX package's on twin clusters.

Each package builds its own cluster, provider and settings from the same
rows. Both controllers get their package's provisioning solver, in latency
mode as a provisioning controller runs it (``TorchSolver(device="cpu")``
and ``TPUSolver(auto_mesh=False, quality_sync=True)``), and both build a
quality-mode solver beside it for what-ifs of at least
``quality_min_pods`` pods. Two things make the reference's sweep depend on
timing, and the tests take both out:

* its quality ``TPUSolver(quality_sync=False)`` answers from the host until
  XLA has compiled a bucket, so the tests swap it for a
  ``TPUSolver(auto_mesh=False, quality_race=True, quality_sync=True)``
  with the same budget, which compiles inline;
* the multi-node prefix search stops at ``consolidation_timeout``, so the
  tests give it an hour (``SWEEP_BUDGET_S``), except where a case sets its
  own budget.

The host paths polish without their deadlines (``_host_paths_run_dry``,
shared with ``test_torch_controller.py``), and machines launch one at a
time in plan order (``create_batched = None``): a replacement's name comes
from a process-wide sequence, and a later pass's candidates include it.

The clusters here are tens of nodes, so the tests pass ``quality_min_pods=
QUALITY_MIN_PODS`` (50) in place of the controller's 500: the multi-node
search's large prefixes then run on the quality solver, the port's through
the plain versions of its kernels. Actions are compared by reason, node
names, replacements (a multiset of instance type, zone, capacity type and
sorted pod names), savings (1e-9 relative), evicted gang members and
gangs; the cluster by its nodes as the same multiset and its pending pods;
the decision log by its consolidation verdicts.

The cases are those of ``tests/test_deprovisioning.py``, the gang cases of
``tests/test_gang_scheduling.py`` and ``tests/test_slice_topology.py``,
``configs.config_consolidation(30, 3)`` run to quiescence, the sweep fixture
``configs.config_sweep`` at 1 and 4 workers, a quality sim's kernel cost,
and the ``TestDrift`` and ``TestGarbageCollect`` cases of
``tests/test_aux_controllers.py`` on the port.
"""

from __future__ import annotations

import importlib
import threading
import time
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest

import bench
from karpenter_tpu.solver import TPUSolver
from karpenter_tpu.solver import jax_solver as J
from karpenter_tpu_torch.solver import TorchSolver
from test_torch_controller import (  # noqa: F401  (fixtures)
    PACKAGES,
    _fresh_caches,
    _host_paths_run_dry,
    hold_fits,
)

SWEEP_BUDGET_S = 3600.0
QUALITY_MIN_PODS = 50
QUALITY_BUDGET_S = 2.0
REF, PORT = PACKAGES


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the whole module, module fixtures included
    (the twins of ``consolidation_twins`` are built before any function
    fixture runs): the parallel sweep's worker threads each run the plain
    versions, and a full run shares the cores among its workers."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _reference_executables_dropped():
    """The JAX package's executable cache is process-wide and keeps each
    bucket's measured dispatch time: leave neither to a later file."""
    yield
    J.AOT_CACHE.wait_idle(timeout=300)
    J.AOT_CACHE.clear()


@pytest.fixture(autouse=True)
def _decision_logs():
    from karpenter_tpu.utils.decisions import DECISIONS as RDEC
    from karpenter_tpu_torch.utils.decisions import DECISIONS as PDEC

    for log in (RDEC, PDEC):
        log.configure(2048)
        log.clear()
    yield {REF: RDEC, PORT: PDEC}
    for log in (RDEC, PDEC):
        log.clear()


def pkg_mod(pkg: str) -> SimpleNamespace:
    """The names a deprovisioning round is built from, in package ``pkg``."""
    imp = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
    return SimpleNamespace(
        pkg=pkg, api=imp("api"), wk=imp("api.labels"), settings=imp("api.settings"),
        cloud=imp("cloudprovider"), state=imp("state"), prov=imp("controllers.provisioning"),
        term=imp("controllers.termination"), deprov=imp("controllers.deprovisioning"),
        ctl=imp("controllers"), cache=imp("utils.cache"), metrics=imp("utils.metrics"),
        decisions=imp("utils.decisions"), solver=imp("solver.solver"), encode=imp("solver.encode"),
    )


def main_solver(pkg: str, **kw):
    """The provisioning controller's solver, in latency mode."""
    if pkg == REF:
        return TPUSolver(auto_mesh=False, quality_sync=True, **kw)
    return TorchSolver(device="cpu", **kw)


def deprovisioner(m, cluster, provider, term, settings, clock, solver, **kw):
    """``DeprovisioningController`` of package ``m`` on ``solver``, its
    reference quality solver swapped for one that compiles inline."""
    kw.setdefault("quality_min_pods", QUALITY_MIN_PODS)
    d = m.deprov.DeprovisioningController(cluster, provider, term, solver=solver,
                                          settings=settings, clock=clock, **kw)
    if m.pkg == REF and d.quality_solver is not None:
        q = TPUSolver(
            portfolio=solver.portfolio, seed=solver.seed, auto_mesh=False,
            latency_budget_s=QUALITY_BUDGET_S, warmup_spike_s=solver.warmup_spike_s,
            quality_race=True, quality_sync=True, dispatch_timeout_s=solver.dispatch_timeout_s,
        )
        q.risk_penalty = d.quality_solver.risk_penalty
        d.quality_solver = q
    return d


def make_pod(m, name, cpu="100m", memory="128Mi", owner="ReplicaSet", labels=None,
             group=None, min_members=None):
    pod = m.api.Pod(
        meta=m.api.ObjectMeta(name=name, labels=dict(labels or {}), owner_kind=owner),
        requests=m.api.Resources(cpu=cpu, memory=memory),
    )
    if group is not None:
        pod.meta.annotations[m.wk.POD_GROUP] = group
        if min_members is not None:
            pod.meta.annotations[m.wk.POD_GROUP_MIN_MEMBERS] = str(min_members)
    return pod


def make_pods(m, n, prefix="pod", **kw):
    return [make_pod(m, f"{prefix}-{i}", **kw) for i in range(n)]


class Env:
    """One package's cluster, provider, provisioning, termination and
    deprovisioning controllers, as ``tests/test_deprovisioning.py``'s
    ``make_env`` builds them."""

    def __init__(self, pkg, provisioner_kw=None, validation_ttl=0.0, n_types=40,
                 greedy_provisioning=False, clock_start=10_000.0, **settings_kw):
        m = self.m = pkg_mod(pkg)
        self.pkg = pkg
        self.cluster = m.state.Cluster()
        self.provider = m.cloud.FakeCloudProvider(catalog=m.cloud.generate_catalog(n_types=n_types))
        self.provider.create_batched = None
        settings_kw.setdefault("consolidation_timeout", SWEEP_BUDGET_S)
        self.settings = m.settings.Settings(
            batch_idle_duration=0, batch_max_duration=0,
            consolidation_validation_ttl=validation_ttl, stabilization_window=0.0, **settings_kw,
        )
        self.clock = m.cache.FakeClock(start=clock_start)
        solver = main_solver(pkg)
        prov_solver = m.solver.GreedySolver() if greedy_provisioning else solver
        self.prov_ctl = m.prov.ProvisioningController(self.cluster, self.provider,
                                                      settings=self.settings, solver=prov_solver)
        self.term = m.term.TerminationController(self.cluster, self.provider, clock=self.clock)
        self.deprov = deprovisioner(m, self.cluster, self.provider, self.term, self.settings,
                                    self.clock, solver)
        self.cluster.add_provisioner(m.api.Provisioner(meta=m.api.ObjectMeta(name="default"),
                                                       **(provisioner_kw or {})))
        self.log = []

    def add(self, pods):
        for p in pods:
            self.cluster.add_pod(p)

    def note(self, key, value):
        self.log.append((key, value))
        return value

    def act(self, key, action):
        self.note(key, action_row(self.m, action))
        return action


def spec_rows(specs):
    return sorted(Counter(
        (s.option.instance_type.name, s.option.zone, s.option.capacity_type,
         tuple(sorted(s.pod_names))) for s in specs).items())


def action_row(m, action):
    if action is None:
        return None
    return dict(reason=action.reason, nodes=list(action.nodes),
                replacements=spec_rows(action.replacements), savings=action.savings,
                evict=list(action.evict_pods), gangs=list(action.gangs))


def cluster_rows(m, cluster):
    wk = m.wk
    nodes = Counter()
    for node in cluster.nodes.values():
        lab = node.meta.labels
        nodes[(lab.get(wk.INSTANCE_TYPE), lab.get(wk.ZONE), lab.get(wk.CAPACITY_TYPE),
               tuple(sorted(p.name for p in cluster.pods_on_node(node.name))))] += 1
    return dict(nodes=sorted(nodes.items()), pending=sorted(p.name for p in cluster.pending_pods()))


def fleet_cost(deprov, cluster):
    return sum(deprov._node_price(n) for n in cluster.nodes.values())


def assert_same(got, want, where=""):
    """Equal observations, floats to 1e-9 relative."""
    if isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-9, abs=1e-12), where
    elif isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), (where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    else:
        assert got == want, (where, got, want)


def sparse_two_nodes(E, n_pods_a=1, n_pods_b=2):
    """``tests/test_deprovisioning.py``'s ``_sparse_two_nodes``: two
    mid-size nodes launched through the provider, each holding a few small
    pods, consolidatable onto one."""
    m, cluster, provider = E.m, E.cluster, E.provider
    api, wk = m.api, m.wk
    prov = next(iter(cluster.provisioners.values()))
    it = [it for it in provider.catalog if 3 <= it.capacity["cpu"] <= 6][0]
    nodes = []
    for i, n_pods in enumerate((n_pods_a, n_pods_b)):
        machine = api.Machine(
            meta=api.ObjectMeta(name=f"sparse-{i}", labels=dict(prov.labels)),
            provisioner_name=prov.name,
            requirements=api.Requirements([
                api.Requirement.in_values(wk.INSTANCE_TYPE, [it.name]),
                api.Requirement.in_values(wk.ZONE, ["zone-a"]),
                api.Requirement.in_values(wk.CAPACITY_TYPE, [wk.CAPACITY_TYPE_ON_DEMAND]),
            ]),
            requests=api.Resources(cpu="500m"),
        )
        machine = provider.create(machine)
        cluster.add_machine(machine)
        node = m.prov.register_node(cluster, machine, prov)
        for j in range(n_pods):
            pod = cluster.add_pod(make_pod(m, f"sp-{i}-{j}", cpu="250m", memory="256Mi"))
            cluster.bind_pod(pod.name, node.name)
        nodes.append(node)
    return nodes


# -- the cases of tests/test_deprovisioning.py, run in one package each ------


def case_empty_node_deleted_after_ttl(pkg):
    E = Env(pkg, provisioner_kw=dict(ttl_seconds_after_empty=30))
    wk = E.m.wk
    E.add(make_pods(E.m, 5, cpu="500m"))
    E.prov_ctl.reconcile()
    node_name = next(iter(E.cluster.nodes))
    for p in list(E.cluster.pods.values()):
        E.cluster.delete_pod(p.name)
    assert E.act("stamp", E.deprov.reconcile()) is None
    assert wk.EMPTINESS_TIMESTAMP_ANNOTATION in E.cluster.nodes[node_name].meta.annotations
    E.clock.step(31)
    action = E.act("delete", E.deprov.reconcile())
    assert action is not None and action.reason == "emptiness"
    assert node_name not in E.cluster.nodes
    return E


def case_emptiness_cleared_when_pod_lands(pkg):
    E = Env(pkg, provisioner_kw=dict(ttl_seconds_after_empty=30))
    wk = E.m.wk
    E.add(make_pods(E.m, 2, cpu="250m"))
    E.prov_ctl.reconcile()
    node_name = next(iter(E.cluster.nodes))
    for p in list(E.cluster.pods.values()):
        E.cluster.delete_pod(p.name)
    E.act("stamp", E.deprov.reconcile())
    E.cluster.add_pod(make_pod(E.m, "back", cpu="100m"))
    E.prov_ctl.reconcile()
    E.clock.step(31)
    assert E.act("after", E.deprov.reconcile()) is None
    assert wk.EMPTINESS_TIMESTAMP_ANNOTATION not in E.cluster.nodes[node_name].meta.annotations
    return E


def case_expired_node_replaced(pkg):
    E = Env(pkg, provisioner_kw=dict(ttl_seconds_until_expired=3600))
    E.add(make_pods(E.m, 4, cpu="500m"))
    E.prov_ctl.reconcile()
    node_name = next(iter(E.cluster.nodes))
    E.cluster.nodes[node_name].meta.creation_timestamp = E.clock.now() - 3700
    action = E.act("expire", E.deprov.reconcile())
    assert action.reason == "expiration"
    assert node_name not in E.cluster.nodes
    assert E.cluster.pending_pods()
    E.prov_ctl.reconcile()
    assert not E.cluster.pending_pods()
    return E


def case_drifted_node_deprovisioned(pkg):
    E = Env(pkg)
    wk = E.m.wk
    E.add(make_pods(E.m, 3, cpu="500m"))
    E.prov_ctl.reconcile()
    node_name = next(iter(E.cluster.nodes))
    E.cluster.nodes[node_name].meta.annotations[wk.VOLUNTARY_DISRUPTION_ANNOTATION] = "drifted"
    action = E.act("drift", E.deprov.reconcile())
    assert action.reason == "drift"
    assert node_name not in E.cluster.nodes
    return E


def case_drift_disabled_by_gate(pkg):
    E = Env(pkg)
    wk = E.m.wk
    E.deprov.settings.drift_enabled = False
    E.add(make_pods(E.m, 3, cpu="500m"))
    E.prov_ctl.reconcile()
    node_name = next(iter(E.cluster.nodes))
    E.cluster.nodes[node_name].meta.annotations[wk.VOLUNTARY_DISRUPTION_ANNOTATION] = "drifted"
    assert E.act("drift", E.deprov.reconcile()) is None
    return E


def sparse_env(pkg, validation_ttl=0.0, **kw):
    E = Env(pkg, provisioner_kw=dict(consolidation_enabled=True), validation_ttl=validation_ttl,
            **kw)
    sparse_two_nodes(E)
    return E


def case_consolidation_takes_an_action(pkg):
    E = sparse_env(pkg)
    assert len(E.cluster.nodes) == 2
    action = E.act("act", E.deprov.reconcile())
    assert action is not None and action.reason.startswith("consolidation")
    assert len(E.cluster.nodes) < 2 + (1 if action.replacement else 0) + 1
    return E


def case_no_consolidation_while_pending(pkg):
    E = sparse_env(pkg)
    E.cluster.add_pod(make_pod(E.m, "pending-1", cpu="100m"))
    assert E.act("act", E.deprov.reconcile()) is None
    return E


def case_do_not_evict_blocks(pkg):
    E = sparse_env(pkg)
    for p in E.cluster.pods.values():
        p.meta.annotations[E.m.wk.DO_NOT_EVICT_ANNOTATION] = "true"
    assert E.act("act", E.deprov.reconcile()) is None
    return E


def case_do_not_consolidate_node_blocks(pkg):
    E = sparse_env(pkg)
    for n in E.cluster.nodes.values():
        n.meta.annotations[E.m.wk.DO_NOT_CONSOLIDATE_ANNOTATION] = "true"
    assert E.act("act", E.deprov.reconcile()) is None
    return E


def case_controllerless_pod_blocks_node(pkg):
    E = Env(pkg, provisioner_kw=dict(consolidation_enabled=True))
    E.cluster.add_pod(make_pod(E.m, "orphan", owner=None, cpu="100m"))
    E.prov_ctl.reconcile()
    assert E.act("act", E.deprov.reconcile()) is None
    return E


def case_validation_window_aborts_on_new_pods(pkg):
    E = sparse_env(pkg, validation_ttl=15.0)
    assert E.act("plan", E.deprov.reconcile()) is None
    E.note("pending", action_row(E.m, E.deprov.pending_action))
    assert E.deprov.pending_action is not None
    E.cluster.add_pod(make_pod(E.m, "burst", cpu="100m"))
    E.clock.step(16)
    assert E.act("validate", E.deprov.reconcile()) is None
    assert E.deprov.pending_action is None
    assert E.deprov.recorder.events("DeprovisioningAborted")
    return E


def case_validation_window_executes_when_stable(pkg):
    E = sparse_env(pkg, validation_ttl=15.0)
    assert E.act("plan", E.deprov.reconcile()) is None
    E.clock.step(16)
    action = E.act("validate", E.deprov.reconcile())
    assert action is not None and action.reason.startswith("consolidation")
    return E


def case_all_pods_survive_consolidation(pkg):
    E = sparse_env(pkg)
    pods_before = set(E.cluster.pods)
    for i in range(5):
        if E.act(f"pass {i}", E.deprov.reconcile()) is None:
            E.prov_ctl.reconcile()
    E.prov_ctl.reconcile()
    assert set(E.cluster.pods) == pods_before
    assert not E.cluster.pending_pods()
    return E


def case_drift_action_carries_replacements(pkg):
    E = Env(pkg)
    E.add(make_pods(E.m, 4, cpu="500m"))
    E.prov_ctl.reconcile()
    n_nodes = len(E.cluster.nodes)
    for node in E.cluster.nodes.values():
        node.meta.annotations[E.m.wk.VOLUNTARY_DISRUPTION_ANNOTATION] = "drifted"
    action = E.act("drift", E.deprov.reconcile())
    assert action is not None and action.reason == "drift"
    assert action.replacements
    assert len(E.cluster.nodes) >= n_nodes
    E.prov_ctl.reconcile()
    assert not E.cluster.pending_pods()
    return E


def case_consolidation_waits_for_stability(pkg):
    E = Env(pkg, provisioner_kw=dict(consolidation_enabled=True))
    E.deprov.settings = E.m.settings.Settings(
        batch_idle_duration=0, batch_max_duration=0, consolidation_validation_ttl=0,
        stabilization_window=300.0, consolidation_timeout=SWEEP_BUDGET_S,
    )
    sparse_two_nodes(E)
    assert E.act("inside", E.deprov.reconcile()) is None
    E.clock.step(301)
    action = E.act("after", E.deprov.reconcile())
    assert action is not None and action.reason.startswith("consolidation")
    return E


def case_max_savings_subset_preferred(pkg):
    E = sparse_env(pkg)
    action = E.act("act", E.deprov._consolidation())
    assert action is not None and action.savings > 0
    return E


def case_spot_nodes_deletable_in_multi_node_subset(pkg):
    E = Env(pkg, provisioner_kw=dict(consolidation_enabled=True))
    for n in sparse_two_nodes(E, n_pods_a=0, n_pods_b=0):
        n.meta.labels[E.m.wk.CAPACITY_TYPE] = E.m.wk.CAPACITY_TYPE_SPOT
    action = E.act("act", E.deprov._consolidation())
    assert action is not None and action.reason == "consolidation-delete"
    assert len(action.nodes) >= 2
    return E


def case_exhausted_budget_truncates_multi_node_sweep(pkg):
    E = sparse_env(pkg, consolidation_timeout=0.0)
    before = E.m.metrics.CONSOLIDATION_SWEEP_TRUNCATED.value()
    assert E.act("multi", E.deprov._try_multi_node(E.deprov._consolidatable())) is None
    assert E.m.metrics.CONSOLIDATION_SWEEP_TRUNCATED.value() == before + 1
    action = E.act("act", E.deprov.reconcile())
    assert action is not None and action.reason.startswith("consolidation")
    return E


def case_generous_budget_keeps_multi_node_result(pkg):
    E = sparse_env(pkg, consolidation_timeout=30.0)
    assert E.act("multi", E.deprov._try_multi_node(E.deprov._consolidatable())) is not None
    return E


def case_replacement_over_ceiling_is_infeasible(pkg):
    E = Env(pkg, provisioner_kw=dict(consolidation_enabled=True))
    E.cluster.add_pod(make_pod(E.m, "big", cpu="2", memory="4Gi"))
    E.prov_ctl.reconcile()
    (node,) = E.cluster.nodes.values()
    pods = [p for p in E.cluster.pods.values() if not p.is_daemonset]
    fits, reps = E.deprov._simulate(pods, exclude=[node.name], price_ceiling=1e-9)
    E.note("tight", (fits, spec_rows(reps)))
    assert not fits
    fits, reps = E.deprov._simulate(pods, exclude=[node.name], price_ceiling=1e9)
    E.note("generous", (fits, spec_rows(reps)))
    assert fits and all(r.option.price < 1e9 for r in reps)
    return E


def case_simulations_reuse_provider_type_lists(pkg):
    E = Env(pkg, provisioner_kw=dict(consolidation_enabled=True))
    with pytest.MonkeyPatch.context() as mp:
        # the provider's type cache keys on a 60 s staleness bucket
        mp.setattr(time, "time", lambda: 1_000_000.0)
        E.cluster.add_pod(make_pod(E.m, "w", cpu="250m"))
        E.prov_ctl.reconcile()
        (node,) = E.cluster.nodes.values()
        pods = [p for p in E.cluster.pods.values() if not p.is_daemonset]
        seen = []
        orig = E.deprov.solver.solve_pods

        def spy(pods_a, provisioners, **kw):
            seen.append(tuple(id(t) for _, t in provisioners))
            return orig(pods_a, provisioners, **kw)

        mp.setattr(E.deprov.solver, "solve_pods", spy)
        E.note("first", E.deprov._simulate(pods, exclude=[node.name], price_ceiling=1e9)[0])
        E.note("second", E.deprov._simulate(pods, exclude=[node.name], price_ceiling=1e9)[0])
    assert len(seen) == 2 and seen[0] == seen[1]
    return E


def case_small_solves_never_dispatch_kernel(pkg):
    """``TestTinyProblemRacePolicy``: a solve under the race floor (a
    consolidation what-if) touches no device, on repeat solves too."""
    E = Env(pkg)
    m = E.m
    pods = make_pods(m, 40, cpu="250m")
    prov = m.api.Provisioner(meta=m.api.ObjectMeta(name="default"))
    problem = m.encode.encode(pods, [(prov, m.cloud.generate_catalog(n_types=10))])
    s = main_solver(pkg, portfolio=4)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(s, "_dispatch_async", lambda pr: calls.append(pr) or None)
        r, r2 = s.solve(problem), s.solve(problem)
    assert calls == []
    assert not r.unschedulable and not r2.unschedulable
    E.note("costs", (r.cost, r2.cost, r.stats["backend"]))
    return E


# -- gang cases (tests/test_gang_scheduling.py, tests/test_slice_topology.py)


def case_gang_hosting_node_is_not_consolidatable(pkg):
    E = Env(pkg, n_types=20, greedy_provisioning=True, clock_start=0.0)
    E.cluster.provisioners["default"].consolidation_enabled = True
    for i in range(2):
        E.cluster.add_pod(make_pod(E.m, f"g-{i}", cpu="100m", memory="1Gi", group="tj",
                                   min_members=2))
    E.prov_ctl.reconcile()
    assert all(E.cluster.pods[f"g-{i}"].node_name for i in range(2))
    assert E.note("candidates", [n.name for n in E.deprov._consolidatable()]) == []
    blocked = [r for r in E.m.decisions.DECISIONS.query(kind="consolidation")
               if r.outcome == "blocked"]
    assert blocked and "gang member" in blocked[0].reason
    return E


def split_gang_env(pkg, slice_topology=True):
    """``tests/test_slice_topology.py``'s ``_split_gang_cluster``: g-0 and a
    filler on one node, g-1 alone on another, the filler deleted: the sweep
    can delete one node by moving the gang whole."""
    E = Env(pkg, n_types=20, greedy_provisioning=True, clock_start=1e6,
            slice_topology_enabled=slice_topology)
    E.cluster.provisioners["default"].consolidation_enabled = True
    E.cluster.add_pod(make_pod(E.m, "g-0", cpu="300m", memory="128Mi", group="tj", min_members=2))
    E.cluster.add_pod(make_pod(E.m, "filler", cpu="500m", memory="128Mi"))
    E.prov_ctl.reconcile()
    E.cluster.add_pod(make_pod(E.m, "g-1", cpu="300m", memory="128Mi", group="tj", min_members=2))
    E.prov_ctl.reconcile()
    assert E.cluster.pods["g-0"].node_name != E.cluster.pods["g-1"].node_name
    E.cluster.delete_pod("filler")
    return E


def case_sweep_moves_gang_whole(pkg):
    E = split_gang_env(pkg)
    action = E.act("act", E.deprov.reconcile())
    assert action is not None and len(action.nodes) == 1
    assert action.gangs == ["tj"] and len(action.evict_pods) == 1
    assert [m for m in ("g-0", "g-1") if E.cluster.pods[m].node_name] == []
    rec = [r for r in E.m.decisions.DECISIONS.query(kind="consolidation")
           if r.outcome == "acted"][0]
    assert rec.details["gangs_moved_whole"] == ["tj"]
    result = E.prov_ctl.reconcile()
    homes = {E.cluster.pods[m].node_name for m in ("g-0", "g-1")}
    assert None not in homes and len(homes) == 1
    assert not result.gang_deferred
    return E


def case_gang_fence_stands_without_subsystem(pkg):
    E = split_gang_env(pkg, slice_topology=False)
    assert E.note("candidates", [n.name for n in E.deprov._consolidatable()]) == []
    blocked = [r for r in E.m.decisions.DECISIONS.query(kind="consolidation")
               if r.outcome == "blocked"]
    assert blocked and "gang member" in blocked[0].reason
    return E


def case_unmovable_gang_blocks_node(pkg):
    E = split_gang_env(pkg)
    E.cluster.pods["g-1"].meta.annotations[E.m.wk.DO_NOT_EVICT_ANNOTATION] = "true"
    assert E.note("candidates", [n.name for n in E.deprov._consolidatable()]) == []
    blocked = [r for r in E.m.decisions.DECISIONS.query(kind="consolidation")
               if r.outcome == "blocked"]
    assert blocked and "do-not-evict" in blocked[0].reason
    return E


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


def verdicts(m):
    return sorted((r.outcome, r.reason, r.node, r.pod)
                  for r in m.decisions.DECISIONS.query(kind="consolidation"))


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_matches_reference(name):
    """Each case holds the reference test's own assertions in both packages,
    and the two must act alike: the same actions, the same cluster after,
    the same consolidation verdicts in the decision log."""
    out = {}
    for pkg in PACKAGES:
        E = CASES[name](pkg)
        hold_fits(E.cluster)
        out[pkg] = dict(log=E.log, cluster=cluster_rows(E.m, E.cluster), verdicts=verdicts(E.m),
                        backends=dict(E.deprov.sweep_backend_counts))
    assert_same(out[PORT], out[REF], name)


def test_quality_solver_keeps_the_callers_device():
    """The quality solver and the sweep's clones are ``TorchSolver``s on the
    main solver's device, carrying its settings; a greedy main solver gets
    no quality solver, as in the reference."""
    E = Env(PORT)
    s, q = E.deprov.solver, E.deprov.quality_solver
    assert isinstance(q, TorchSolver) and q.device.type == "cpu"
    assert q.latency_budget_s == QUALITY_BUDGET_S and q.quality_race
    assert (q.portfolio, q.seed, q.dispatch_timeout_s) == (s.portfolio, s.seed, s.dispatch_timeout_s)
    assert q._stager.capacity_bytes == s._stager.capacity_bytes
    pool = E.deprov._sweep_solver_pool(3)
    assert len(pool) == 3
    for base, qual in pool:
        assert isinstance(base, TorchSolver) and base.device.type == "cpu"
        assert not base.quality_race and base.latency_budget_s == s.latency_budget_s
        assert isinstance(qual, TorchSolver) and qual.quality_race
        assert qual.latency_budget_s == QUALITY_BUDGET_S and base is not s and qual is not q
    m = E.m
    greedy = m.deprov.DeprovisioningController(E.cluster, E.provider, E.term,
                                               settings=E.settings, clock=E.clock)
    assert greedy.quality_solver is None and type(greedy.solver).__name__ == "GreedySolver"


# -- config_consolidation to quiescence ---------------------------------------


def bench_fleet(m, n_nodes, pods_per_node, n_types=100, seed=13):
    """``bench.bench_consolidation``'s fleet (``bench.py:1457-1514``) built
    with package ``m``'s API, step by step as the bench builds it, with the
    subnets ``config_consolidation`` gives."""
    api, wk = m.api, m.wk
    provider = m.cloud.FakeCloudProvider(catalog=m.cloud.generate_catalog(n_types=n_types))
    for s in provider.subnets:
        s.available_ips = 1 << 20
    cluster = m.state.Cluster()
    settings = m.settings.Settings(batch_idle_duration=0, batch_max_duration=0,
                                   consolidation_validation_ttl=0, stabilization_window=0)
    clock = m.cache.FakeClock(start=100_000.0)
    prov = api.Provisioner(meta=api.ObjectMeta(name="default"), consolidation_enabled=True)
    cluster.add_provisioner(prov)
    rng = np.random.default_rng(seed)
    mids = [it for it in provider.catalog if 6 <= it.capacity["cpu"] <= 20]
    for i in range(n_nodes):
        it = mids[int(rng.integers(0, len(mids)))]
        machine = api.Machine(
            meta=api.ObjectMeta(name=f"frag-{i}", labels=dict(prov.labels)),
            provisioner_name=prov.name,
            requirements=api.Requirements([
                api.Requirement.in_values(wk.INSTANCE_TYPE, [it.name]),
                api.Requirement.in_values(wk.ZONE, [["zone-a", "zone-b", "zone-c"][i % 3]]),
                api.Requirement.in_values(wk.CAPACITY_TYPE, [wk.CAPACITY_TYPE_ON_DEMAND]),
            ]),
            requests=api.Resources(cpu="1"),
        )
        machine = provider.create(machine)
        cluster.add_machine(machine)
        node = m.prov.register_node(cluster, machine, prov)
        for j in range(pods_per_node):
            app = f"svc{j}"
            pod = api.Pod(
                meta=api.ObjectMeta(name=f"fp-{i}-{j}", owner_kind="ReplicaSet",
                                    labels={"app": app}),
                requests=api.Resources(cpu="200m", memory="256Mi"),
                topology_spread=[api.TopologySpreadConstraint(
                    max_skew=2, topology_key=wk.ZONE, label_selector={"app": app})],
            )
            cluster.add_pod(pod)
            cluster.bind_pod(pod.name, node.name)
    return cluster, provider, settings, clock, prov


def consolidation_config(pkg, n_nodes, pods_per_node):
    """``configs.config_consolidation`` in package ``pkg``: the port's own,
    or the JAX package's twin built as the bench builds it."""
    from karpenter_tpu_torch import configs

    if pkg == PORT:
        return configs.config_consolidation(n_nodes, pods_per_node)
    return bench_fleet(pkg_mod(pkg), n_nodes, pods_per_node)


def fleet_rows(m, cluster):
    wk = m.wk
    return [(n.name, n.meta.labels[wk.INSTANCE_TYPE], n.zone(), n.capacity_type(),
             str(n.allocatable.get("cpu")), tuple(p.name for p in cluster.pods_on_node(n.name)))
            for n in cluster.nodes.values()]


def test_consolidation_config_is_the_bench_fleet():
    """``configs.config_consolidation`` builds the bench's fleet: the same
    nodes (name, type, zone, capacity type, allocatable), the same pods on
    each, the same settings, in the JAX package's twin and in the port's
    own API step by step."""
    got = consolidation_config(PORT, 40, 4)
    rows = fleet_rows(pkg_mod(PORT), got[0])
    assert rows == fleet_rows(pkg_mod(PORT), bench_fleet(pkg_mod(PORT), 40, 4)[0])
    ref = consolidation_config(REF, 40, 4)
    assert rows == fleet_rows(pkg_mod(REF), ref[0])
    for key in ("consolidation_validation_ttl", "stabilization_window", "consolidation_timeout",
                "batch_idle_duration", "batch_max_duration"):
        assert getattr(got[2], key) == getattr(ref[2], key), key
    assert got[2].consolidation_timeout == 2.0 and got[3].now() == ref[3].now() == 100_000.0
    assert len({r[1] for r in rows}) > 1 and {r[2] for r in rows} == {"zone-a", "zone-b", "zone-c"}


class QualitySims:
    """Wraps a quality solver's ``solve_pods``: the problem of each sim it
    answers (its intern slot) and how it was answered."""

    def __init__(self, deprov):
        self.solver = deprov.quality_solver
        self.sims = []
        solve_pods = self.solver.solve_pods

        def recording(pods, provs, **kw):
            result = solve_pods(pods, provs, **kw)
            self.sims.append((list(pods), provs, list(kw.get("existing", ())), result))
            return result

        self.solver.solve_pods = recording


def consolidation_env(pkg, n_nodes, pods_per_node, workers=4):
    m = pkg_mod(pkg)
    cluster, provider, settings, clock, _ = consolidation_config(pkg, n_nodes, pods_per_node)
    provider.create_batched = None
    settings.consolidation_timeout = SWEEP_BUDGET_S
    settings.consolidation_sweep_workers = workers
    prov_ctl = m.prov.ProvisioningController(cluster, provider, settings=settings,
                                             solver=main_solver(pkg))
    term = m.term.TerminationController(cluster, provider, clock=clock)
    deprov = deprovisioner(m, cluster, provider, term, settings, clock, prov_ctl.solver)
    return SimpleNamespace(m=m, cluster=cluster, provider=provider, settings=settings,
                           clock=clock, prov_ctl=prov_ctl, term=term, deprov=deprov,
                           sims=QualitySims(deprov))


def run_to_quiescence(E, max_passes=40):
    """``bench.bench_consolidation``'s loop: each pass deprovisions,
    rebinds the evicted pods and finishes terminations, then steps the
    clock 30 s; it ends on a pass that neither acted nor parked a plan."""
    rows = []
    for _ in range(max_passes):
        action = E.deprov.reconcile()
        E.prov_ctl.reconcile()
        E.term.reconcile()
        E.clock.step(30)
        hold_fits(E.cluster)
        assert not E.cluster.pending_pods()
        rows.append(dict(action=action_row(E.m, action), backends=dict(E.deprov.sweep_backend_counts),
                         cost=fleet_cost(E.deprov, E.cluster), nodes=len(E.cluster.nodes)))
        if action is None and E.deprov.pending_action is None:
            break
    return rows


@pytest.fixture(scope="module")
def consolidation_twins():
    """``config_consolidation(30, 3)`` to quiescence in both packages (at 4
    sweep workers; ``quality_min_pods`` 50, so the multi-node search's
    prefixes of 17 nodes and more run on the quality solver)."""
    from test_torch_host import reset_caches

    out = {}
    for pkg in PACKAGES:
        reset_caches()
        pkg_mod(pkg).prov._machine_ids = pkg_mod(pkg).prov.MachineNameSeq()
        E = consolidation_env(pkg, 30, 3)
        before = fleet_cost(E.deprov, E.cluster)
        out[pkg] = (E, before, run_to_quiescence(E))
    reset_caches()
    return out


def test_consolidation_config_matches_reference_pass_by_pass(consolidation_twins):
    """Each pass's action, sweep backends and fleet $/h, and the final
    nodes, in both packages; the fleet gets cheaper and every pod stays
    bound."""
    (r_env, r_before, r_rows), (p_env, p_before, p_rows) = (
        consolidation_twins[REF], consolidation_twins[PORT])
    assert p_before == pytest.approx(r_before, rel=1e-9)
    assert_same(p_rows, r_rows, "passes")
    assert_same(cluster_rows(p_env.m, p_env.cluster), cluster_rows(r_env.m, r_env.cluster))
    acted = [r for r in p_rows if r["action"] is not None]
    assert acted and all(r["action"]["savings"] > 0 for r in acted)
    assert p_rows[-1]["cost"] < p_before
    costs = [p_before] + [r["cost"] for r in p_rows]
    assert all(b <= a * (1 + 1e-12) for a, b in zip(costs, costs[1:]))
    assert all(p.node_name for p in p_env.cluster.pods.values())
    assert p_env.sims.sims, "no sim reached the quality solver"


def test_quality_sims_match_reference(consolidation_twins):
    """Every quality sim of the twin runs: the same pods, the same problem
    digest, the same cost and backend; and the first one's kernel-only cost
    in the port equals the JAX package's to 1e-9."""
    from karpenter_tpu.solver.solver import problem_digest as r_digest
    from karpenter_tpu_torch.solver.solver import problem_digest as p_digest

    r_sims, p_sims = consolidation_twins[REF][0].sims.sims, consolidation_twins[PORT][0].sims.sims
    assert len(p_sims) == len(r_sims) > 0
    for (rp, _, rx, rr), (pp, _, px, pr) in zip(r_sims, p_sims):
        assert [p.name for p in pp] == [p.name for p in rp] and len(px) == len(rx)
        assert pr.problem_digest == rr.problem_digest
        assert pr.cost == pytest.approx(rr.cost, rel=1e-9)
        assert pr.stats["backend"] == rr.stats["backend"]
    from karpenter_tpu.solver import encode as r_encode
    from karpenter_tpu_torch.solver import encode

    problem, r_problem = encode(*p_sims[0][:3]), r_encode(*r_sims[0][:3])
    assert p_digest(problem) == r_digest(r_problem)
    assert p_digest(problem).hex() == p_sims[0][3].problem_digest
    got = TorchSolver(device="cpu")._solve_kernel(problem)
    want = TPUSolver(auto_mesh=False)._solve_kernel(r_problem)
    assert got.cost == pytest.approx(want.cost, rel=1e-9)


def test_sim_of_500_pods_costs_the_reference():
    """A what-if at the controller's own ``quality_min_pods`` (500 pods:
    ``config_consolidation_sim(100, 5)``, the whole fleet excluded): the
    port's kernel-only cost equals the JAX package's to 1e-9, on problems
    of equal digest."""
    from karpenter_tpu.solver import encode as r_encode
    from karpenter_tpu.solver.solver import problem_digest as r_digest
    from karpenter_tpu_torch import configs
    from karpenter_tpu_torch.solver import encode
    from karpenter_tpu_torch.solver.solver import problem_digest

    pods, provs, existing = configs.config_consolidation_sim(100, 5)
    assert len(pods) == 500 and existing == []
    r_cluster, r_provider = bench_fleet(pkg_mod(REF), 100, 5)[:2]
    r_pods = [p for n in r_cluster.managed_nodes() for p in r_cluster.pods_on_node(n.name)]
    r_provs = [(p, r_provider.get_instance_types(p)) for p in r_cluster.provisioners.values()]
    problem, r_problem = encode(pods, provs, existing), r_encode(r_pods, r_provs, [])
    assert problem_digest(problem) == r_digest(r_problem)
    got = TorchSolver(device="cpu")._solve_kernel(problem)
    want = TPUSolver(auto_mesh=False)._solve_kernel(r_problem)
    assert got.cost == pytest.approx(want.cost, rel=1e-9)
    assert not got.unschedulable


# -- the sweep fixture at 1 and 4 workers -------------------------------------

SWEEP = dict(n_candidates=8, pods_per_cand=40, fleet_nodes=10)


def sweep_fixture(pkg, workers):
    if pkg == PORT:
        from karpenter_tpu_torch import configs

        deprov = configs.config_sweep(workers, device="cpu", **SWEEP)
    else:
        deprov = bench._sweep_fixture(workers, **SWEEP)
    return deprov


def test_sweep_fixture_same_action_at_1_and_4_workers():
    """``config_sweep`` and the bench's ``_sweep_fixture`` at a small size:
    one ``_consolidation()`` each, at 1 and 4 workers in both packages. All
    four choose the on-demand node of tiny pods, deleted; the sweep ran in
    parallel at 4 workers."""
    from karpenter_tpu.utils import metrics as RM
    from karpenter_tpu_torch.utils import metrics as PM

    actions = {}
    for pkg, metrics in ((REF, RM), (PORT, PM)):
        for workers in (1, 4):
            deprov = sweep_fixture(pkg, workers)
            assert deprov.quality_solver is None and deprov.sweep_workers == workers
            before = metrics.CONSOLIDATION_SWEEP_CANDIDATES.value({"mode": "parallel"})
            action = deprov._consolidation()
            ran = metrics.CONSOLIDATION_SWEEP_CANDIDATES.value({"mode": "parallel"}) - before
            assert (ran > 0) == (workers > 1), (pkg, workers, ran)
            actions[pkg, workers] = action_row(pkg_mod(pkg), action)
    want = actions[REF, 1]
    assert want["reason"] == "consolidation-delete" and want["nodes"] == ["cand-2000"]
    for key, got in actions.items():
        assert_same(got, want, str(key))


# -- no sweep error is swallowed ----------------------------------------------


def test_sweep_worker_error_raises_out_of_reconcile():
    """A clone's ``solve_pods`` raising on a sweep worker thread (as a
    kernel launch error would) raises out of ``reconcile()``."""
    from karpenter_tpu_torch import configs

    deprov = configs.config_sweep(4, device="cpu", **SWEEP)
    threads = []

    def broken(*a, **kw):
        threads.append(threading.current_thread().name)
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    for base, _ in deprov._sweep_solver_pool(4):
        base.solve_pods = broken
    with pytest.raises(RuntimeError, match="illegal memory access"):
        deprov.reconcile()
    assert threads and any(t != threading.main_thread().name for t in threads)


def test_clone_errors_raise_and_only_a_type_error_leaves_the_sweep_serial(monkeypatch):
    """A solver that cannot be cloned by construction (``TypeError``) leaves
    the sweep serial, as in the reference; any other error of a clone's
    construction (a CUDA error on the card) raises out of ``reconcile()``."""
    from karpenter_tpu_torch import configs
    from karpenter_tpu_torch.controllers import deprovisioning as pd

    deprov = configs.config_sweep(4, device="cpu", **SWEEP)

    def no_clone(s):
        raise TypeError("needs arguments")

    monkeypatch.setattr(pd.DeprovisioningController, "_clone_solver", staticmethod(no_clone))
    assert deprov._sweep_solver_pool(4) is None
    action = deprov.reconcile()
    assert action is not None and action.nodes == ["cand-2000"]

    deprov = configs.config_sweep(4, device="cpu", **SWEEP)

    def cuda_error(s):
        raise RuntimeError("CUDA error: out of memory")

    monkeypatch.setattr(pd.DeprovisioningController, "_clone_solver", staticmethod(cuda_error))
    with pytest.raises(RuntimeError, match="out of memory"):
        deprov.reconcile()


# -- tests/test_aux_controllers.py's TestDrift and TestGarbageCollect --------


@pytest.fixture
def aux_env():
    m = pkg_mod(PORT)
    cluster = m.state.Cluster()
    provider = m.cloud.FakeCloudProvider(catalog=m.cloud.generate_catalog(n_types=40))
    ctl = m.prov.ProvisioningController(
        cluster, provider, solver=main_solver(PORT),
        settings=m.settings.Settings(batch_idle_duration=0, batch_max_duration=0),
    )
    cluster.add_provisioner(m.api.Provisioner(meta=m.api.ObjectMeta(name="default")))
    for p in make_pods(m, 4, cpu="500m"):
        cluster.add_pod(p)
    ctl.reconcile()
    return m, cluster, provider


class TestDrift:
    def test_image_rotation_annotates_nodes(self, aux_env):
        m, cluster, provider = aux_env
        drift = m.ctl.DriftController(cluster, provider)
        assert drift.reconcile() == []
        provider.rotate_image()
        drifted = drift.reconcile()
        assert drifted
        for name in drifted:
            node = cluster.nodes[name]
            assert node.meta.annotations[m.wk.VOLUNTARY_DISRUPTION_ANNOTATION] == "drifted"
        assert drift.reconcile() == []

    def test_gate_off(self, aux_env):
        m, cluster, provider = aux_env
        drift = m.ctl.DriftController(cluster, provider,
                                      settings=m.settings.Settings(drift_enabled=False))
        provider.rotate_image()
        assert drift.reconcile() == []


class TestGarbageCollect:
    def test_orphan_instance_collected_after_min_age(self, aux_env):
        m, cluster, provider = aux_env
        gc = m.ctl.GarbageCollectionController(
            cluster, provider, clock=m.cache.FakeClock(start=time.time() + 3600))
        machine = m.api.Machine(meta=m.api.ObjectMeta(name="stray"), provisioner_name="ghost",
                                requests=m.api.Resources(cpu="100m"))
        machine = provider.create(machine)
        assert machine.name not in cluster.machines
        result = gc.reconcile()
        instance_id = machine.status.provider_id.rsplit("/", 1)[-1]
        assert instance_id in result["collected"]
        assert all(i.id != instance_id for i in provider.instances.values())

    def test_adoptable_instance_linked(self, aux_env):
        m, cluster, provider = aux_env
        gc = m.ctl.GarbageCollectionController(
            cluster, provider, clock=m.cache.FakeClock(start=time.time() + 3600))
        machine = m.api.Machine(meta=m.api.ObjectMeta(name="adoptme"), provisioner_name="default",
                                requests=m.api.Resources(cpu="100m"))
        machine = provider.create(machine)
        instance_id = machine.status.provider_id.rsplit("/", 1)[-1]
        result = gc.reconcile()
        assert instance_id in result["adopted"]
        assert instance_id in cluster.machines
        assert gc.reconcile() == {"adopted": [], "collected": []}

    def test_tracked_machines_untouched(self, aux_env):
        m, cluster, provider = aux_env
        gc = m.ctl.GarbageCollectionController(
            cluster, provider, clock=m.cache.FakeClock(start=time.time() + 3600))
        n = len(provider.instances)
        assert gc.reconcile() == {"adopted": [], "collected": []}
        assert len(provider.instances) == n
