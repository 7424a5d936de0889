"""The interruption controller on the CPU: the port's
``InterruptionController`` against the JAX package's on twin clusters.

Each package builds its own cluster, provider, provisioning, termination
and interruption controllers from the same rows, and each case runs in
both. The cases are those of ``tests/test_interruption.py`` (the
provisioning controller on each package's latency-mode solver,
``TPUSolver(auto_mesh=False, quality_sync=True)`` and
``TorchSolver(device="cpu")``) and the rebalance and reclaim cases of
``tests/test_spot_pools.py`` that use no flight recorder (the
interruption-to-provisioning fast path, the reclaim's risk and ICE
feedback, the 10k-message storm at three seeds, and the proactive
rebalance: replacement before drain, the deadline fallback, a reclaim
winning the race), on ``GreedySolver`` as there. Messages are handled on
one worker in both packages (``WORKERS = 1``), so the drained pods re-pend
in message order; one case runs at the default ten workers and compares
its outcome as sets.

After each call a case records what the call returned and the cluster:
its nodes as a multiset of (instance type, zone, capacity type, sorted pod
names), the pending pods, the offerings marked unavailable, the
risk-cache observations of every pool it touched, the pending
rebalances and the round's rebalance actions in canonical order
(``_sorted_actions``). The two packages' records must be equal.
"""

from __future__ import annotations

import importlib
import json
import math
import random
from collections import Counter
from types import SimpleNamespace

import pytest

from karpenter_tpu.solver import TPUSolver
from karpenter_tpu_torch.solver import TorchSolver
from test_torch_controller import (  # noqa: F401  (fixtures)
    PACKAGES,
    _fresh_caches,
    _host_paths_run_dry,
    hold_fits,
)
from test_torch_deprovisioning import assert_same

REF, PORT = PACKAGES


def pkg_mod(pkg: str) -> SimpleNamespace:
    imp = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
    return SimpleNamespace(
        pkg=pkg, api=imp("api"), wk=imp("api.labels"), settings=imp("api.settings"),
        cloud=imp("cloudprovider"), state=imp("state"), intr=imp("controllers.interruption"),
        prov=imp("controllers.provisioning"), term=imp("controllers.termination"),
        cache=imp("utils.cache"), risk=imp("utils.riskcache"), decisions=imp("utils.decisions"),
        metrics=imp("utils.metrics"), solver=imp("solver.solver"),
    )


@pytest.fixture(autouse=True)
def _decision_logs():
    logs = [pkg_mod(pkg).decisions.DECISIONS for pkg in PACKAGES]
    for log in logs:
        log.configure(2048)
        log.clear()
    yield
    for log in logs:
        log.clear()


@pytest.fixture
def one_worker(monkeypatch):
    for pkg in PACKAGES:
        monkeypatch.setattr(pkg_mod(pkg).intr.InterruptionController, "WORKERS", 1)


def spot_warning(instance_id):
    return {"version": "0", "source": "cloud.compute",
            "detail-type": "Spot Instance Interruption Warning",
            "detail": {"instance-id": instance_id}}


def rebalance_rec(instance_id):
    return {"version": "0", "source": "cloud.compute",
            "detail-type": "Instance Rebalance Recommendation",
            "detail": {"instance-id": instance_id}}


def iid(node):
    return node.provider_id.rsplit("/", 1)[-1]


def make_pods(m, n, prefix="pod", cpu="100m", memory="128Mi"):
    return [m.api.Pod(meta=m.api.ObjectMeta(name=f"{prefix}-{i}", owner_kind="ReplicaSet"),
                      requests=m.api.Resources(cpu=cpu, memory=memory)) for i in range(n)]


class Env:
    """``tests/test_interruption.py``'s ``env`` fixture (``spot=False``) or
    ``tests/test_spot_pools.py``'s ``spot_env`` (``spot=True``: spot
    management on, a risk cache on the provider, ``GreedySolver``, the
    provider handed to the controller for proactive rebalances)."""

    def __init__(self, pkg, spot=False, n_pods=6, n_types=None, proactive=True):
        m = self.m = pkg_mod(pkg)
        self.pkg = pkg
        self.cluster = m.state.Cluster()
        n_types = n_types or (20 if spot else 40)
        self.provider = m.cloud.FakeCloudProvider(catalog=m.cloud.generate_catalog(n_types=n_types))
        self.provider.create_batched = None
        self.clock = m.cache.FakeClock(1000.0 if spot else 0.0)
        self.risk = None
        if spot:
            self.settings = m.settings.Settings(batch_idle_duration=0, batch_max_duration=0,
                                                spot_enabled=True, interruption_penalty_cost=0.0)
            self.risk = m.risk.InterruptionRiskCache(
                halflife_s=self.settings.risk_decay_halflife_s, clock=self.clock)
            self.provider.attach_risk_cache(self.risk)
            solver = m.solver.GreedySolver()
        else:
            self.settings = m.settings.Settings(batch_idle_duration=0, batch_max_duration=0)
            solver = (TPUSolver(auto_mesh=False, quality_sync=True) if pkg == REF
                      else TorchSolver(device="cpu"))
        self.ctl = m.prov.ProvisioningController(self.cluster, self.provider, solver=solver,
                                                 settings=self.settings)
        self.term = m.term.TerminationController(self.cluster, self.provider, clock=self.clock)
        self.queue = m.intr.FakeQueue()
        kw = {}
        if spot:
            kw = dict(risk_cache=self.risk, provisioning=self.ctl,
                      provider=self.provider if proactive else None,
                      settings=self.settings, clock=self.clock)
        self.intr = m.intr.InterruptionController(
            self.cluster, self.queue, self.term,
            unavailable_offerings=self.provider.unavailable_offerings, **kw)
        self.cluster.add_provisioner(m.api.Provisioner(meta=m.api.ObjectMeta(name="default")))
        for p in make_pods(m, n_pods, prefix="sp" if spot else "pod", cpu="500m",
                           memory="512Mi" if spot else "128Mi"):
            self.cluster.add_pod(p)
        self.log = []
        self.pools = set()

    def note(self, key, value):
        self.log.append((key, value))
        return value

    def reconcile(self):
        result = self.ctl.reconcile()
        hold_fits(self.cluster)
        self.note("provisioning", (sorted(result.bound), sorted(result.unschedulable)))
        self.note("state", self.state())
        return result

    def interrupt_round(self, **kw):
        handled = self.intr.reconcile(**kw)
        self.note("handled", handled)
        self.note("actions", self.intr._sorted_actions())
        self.note("state", self.state())
        return handled

    def pool(self, node):
        wk = self.m.wk
        lab = node.meta.labels
        pool = (lab[wk.INSTANCE_TYPE], lab[wk.ZONE], lab[wk.CAPACITY_TYPE])
        self.pools.add(pool[:2])
        return pool

    def state(self):
        cluster, wk = self.cluster, self.m.wk
        nodes = Counter()
        for node in cluster.nodes.values():
            nodes[self.pool(node) + (
                tuple(sorted(p.name for p in cluster.pods_on_node(node.name))),)] += 1
        out = dict(nodes=sorted(nodes.items()),
                   pending=sorted(p.name for p in cluster.pending_pods()),
                   ice=sorted(self.provider.unavailable_offerings.entries()),
                   rebalances=sorted((r.node, r.pool) for r in self.intr._rebalances.values()),
                   queue=len(self.queue))
        if self.risk is not None:
            out["risk"] = sorted(
                (it, z, ct, self.risk.observations(it, z, ct))
                for it, z in self.pools for ct in (wk.CAPACITY_TYPE_SPOT, wk.CAPACITY_TYPE_ON_DEMAND))
        return out

    def spot_node(self):
        return next(n for n in sorted(self.cluster.nodes.values(), key=lambda n: n.name)
                    if self.pool(n)[2] == self.m.wk.CAPACITY_TYPE_SPOT)

    def first_node(self):
        return sorted(self.cluster.nodes.values(), key=lambda n: n.name)[0]


def run_twins(case):
    logs = {}
    for pkg in PACKAGES:
        env = case(pkg)
        try:
            logs[pkg] = list(env.log)
        finally:
            env.intr.close(wait=True)
    assert_same(logs[PORT], logs[REF], case.__name__)
    return logs[PORT]


# -- tests/test_interruption.py ----------------------------------------------


def case_spot_interruption_drains_and_marks_ice(pkg):
    e = Env(pkg)
    e.reconcile()
    node = e.first_node()
    it, zone = node.instance_type(), node.zone()
    e.queue.send(spot_warning(iid(node)))
    assert e.interrupt_round() == 1 and len(e.queue) == 0
    assert node.name not in e.cluster.nodes
    assert e.provider.unavailable_offerings.is_unavailable(it, zone, "spot")
    assert e.cluster.pending_pods()
    e.reconcile()
    assert not e.cluster.pending_pods()
    return e


def case_rebalance_is_event_only(pkg):
    e = Env(pkg)
    e.reconcile()
    node = e.first_node()
    e.queue.send(rebalance_rec(iid(node)))
    e.interrupt_round()
    assert node.name in e.cluster.nodes and e.intr.recorder.events("rebalance")
    return e


def case_state_change_only_for_actionable_states(pkg):
    e = Env(pkg)
    e.reconcile()
    node = e.first_node()
    for state in ("running", "terminated"):
        e.queue.send({"version": "0", "source": "cloud.compute",
                      "detail-type": "Instance State-change Notification",
                      "detail": {"instance-id": iid(node), "state": state}})
        e.interrupt_round()
        assert (node.name in e.cluster.nodes) == (state == "running")
    return e


def case_scheduled_change_drains(pkg):
    e = Env(pkg)
    e.reconcile()
    node = e.first_node()
    e.queue.send({"version": "0", "source": "cloud.health", "detail-type": "Scheduled Change",
                  "resources": [f"arn:::instance/{iid(node)}"]})
    e.interrupt_round()
    assert node.name not in e.cluster.nodes
    return e


def case_unknown_and_garbage_messages_are_noops(pkg):
    e = Env(pkg)
    e.reconcile()
    n_nodes = len(e.cluster.nodes)
    e.queue.send({"version": "9", "source": "wat", "detail-type": "???"})
    e.queue.send_raw("not json")
    e.interrupt_round()
    assert len(e.cluster.nodes) == n_nodes and len(e.queue) == 0
    return e


def case_message_for_unknown_instance_ignored(pkg):
    e = Env(pkg)
    e.reconcile()
    n_nodes = len(e.cluster.nodes)
    e.queue.send(spot_warning("i-99999999"))
    e.interrupt_round()
    assert len(e.cluster.nodes) == n_nodes
    return e


# -- tests/test_spot_pools.py: the fast path and the reclaim ------------------


def case_rounds_to_replacement_is_one(pkg):
    e = Env(pkg, spot=True, n_pods=6)
    e.reconcile()
    e.reconcile()  # settle the session so that the next round can be delta
    e.cluster._watchers.remove(e.ctl._on_event)  # note_interrupted is the only channel
    node = e.first_node()
    victims = [p.name for p in e.cluster.pods_on_node(node.name)]
    assert victims
    e.queue.send(spot_warning(iid(node)))
    e.interrupt_round()
    assert node.name not in e.cluster.nodes
    assert set(victims) <= e.ctl._pending_seen and e.ctl.batcher.ready()
    e.reconcile()
    assert not e.cluster.pending_pods()
    assert e.note("mode", e.ctl.encode_session.last_mode) == "delta"
    return e


def case_reclaim_feeds_risk_cache_and_ice(pkg):
    e = Env(pkg, spot=True, n_pods=4)
    e.reconcile()
    node = e.first_node()
    it, zone, _ = e.pool(node)
    e.queue.send(spot_warning(iid(node)))
    e.interrupt_round()
    spot = e.m.wk.CAPACITY_TYPE_SPOT
    assert e.risk.observations(it, zone, spot) == 1
    assert e.risk.probability(it, zone, spot) > e.m.risk.SPOT_PRIOR
    assert e.provider.unavailable_offerings.is_unavailable(it, zone, spot)
    e.note("probability", e.risk.probability(it, zone, spot))
    return e


def storm_case(seed):
    def case_mixed_storm(pkg):
        """``TestInterruptionStorm``: 10k messages of duplicated reclaims,
        rebalance hints, state changes, ghosts and garbage; every reclaim
        counts once, no pod drains twice, the queue drains in
        ceil(N / batch) rounds."""
        rng = random.Random(seed)
        e = Env(pkg, spot=True, n_pods=0, proactive=False)
        m = e.m
        for p in make_pods(m, 12, prefix="storm", cpu="500m", memory="512Mi"):
            e.cluster.add_pod(p)
        e.reconcile()
        nodes = sorted(e.cluster.nodes.values(), key=lambda n: n.name)
        spot_nodes = [n for n in nodes if e.pool(n)[2] == m.wk.CAPACITY_TYPE_SPOT]
        assert len(spot_nodes) >= 2
        reclaim = spot_nodes[: max(2, len(spot_nodes) // 2)]
        hinted = spot_nodes[len(reclaim):]
        victims = {p.name for n in reclaim for p in e.cluster.pods_on_node(n.name)}
        bodies = []
        for n in reclaim:
            bodies += [json.dumps(spot_warning(iid(n)))] * 400
        for n in hinted:
            bodies += [json.dumps(rebalance_rec(iid(n)))] * rng.randrange(50, 150)
        while len(bodies) < 9_000:
            roll = rng.random()
            if roll < 0.4:
                bodies.append("}}} not json")
            elif roll < 0.7:
                bodies.append(json.dumps(spot_warning(f"i-ghost{rng.randrange(50)}")))
            else:
                bodies.append(json.dumps({
                    "version": "0", "source": "cloud.compute",
                    "detail-type": "Instance State-change Notification",
                    "detail": {"instance-id": f"i-ghost{rng.randrange(50)}", "state": "running"},
                }))
        bodies += ["{broken"] * (10_000 - len(bodies))
        rng.shuffle(bodies)
        for b in bodies:
            e.queue.send_raw(b)
        evictions = Counter()

        def watcher(event, obj):
            if event == "MODIFIED" and isinstance(obj, m.api.Pod) and obj.is_pending():
                evictions[obj.name] += 1

        e.cluster.watch(watcher)
        rounds = 0
        while len(e.queue):
            assert e.interrupt_round(max_messages=200) > 0
            rounds += 1
        assert rounds == math.ceil(10_000 / 200)
        assert all(n.name not in e.cluster.nodes for n in reclaim)
        assert all(n.name in e.cluster.nodes for n in hinted)
        assert set(evictions) == victims and set(evictions.values()) == {1}
        e.reconcile()
        assert not e.cluster.pending_pods()
        return e

    case_mixed_storm.__name__ = f"case_mixed_storm_{seed}"
    return case_mixed_storm


# -- tests/test_spot_pools.py: the proactive rebalance ------------------------


def case_replacement_launched_before_drain_then_gated(pkg):
    e = Env(pkg, spot=True, n_pods=4)
    e.reconcile()
    node = e.spot_node()
    e.queue.send(rebalance_rec(iid(node)))
    n_before = len(e.cluster.nodes)
    e.interrupt_round()
    assert node.name in e.cluster.nodes and len(e.cluster.nodes) == n_before + 1
    pending = e.intr._rebalances[node.name]
    assert e.pool(e.cluster.nodes[pending.replacement]) != e.pool(node)
    e.interrupt_round()
    assert node.name not in e.cluster.nodes and pending.replacement in e.cluster.nodes
    assert not e.intr._rebalances
    outcomes = [r.outcome for r in e.m.decisions.DECISIONS.query(kind="rebalance", limit=10)]
    assert {"replacement-launched", "drained-after-replacement"} <= set(outcomes)
    e.note("outcomes", outcomes)
    e.reconcile()
    assert not e.cluster.pending_pods()
    return e


def case_deadline_fallback_inside_notice_window(pkg):
    e = Env(pkg, spot=True, n_pods=4)
    e.reconcile()
    node = e.spot_node()
    e.queue.send(rebalance_rec(iid(node)))
    e.interrupt_round()
    e.cluster.nodes[e.intr._rebalances[node.name].replacement].ready = False
    e.clock.step(121.0)
    e.interrupt_round()
    assert node.name not in e.cluster.nodes
    outcomes = [r.outcome for r in e.m.decisions.DECISIONS.query(kind="rebalance", limit=10)]
    assert "deadline-drain" in outcomes
    e.note("outcomes", outcomes)
    return e


def case_reclaim_wins_race_with_pending_rebalance(pkg):
    e = Env(pkg, spot=True, n_pods=4)
    e.reconcile()
    node = e.spot_node()
    e.queue.send(rebalance_rec(iid(node)))
    e.interrupt_round()
    assert node.name in e.intr._rebalances
    e.queue.send(spot_warning(iid(node)))
    e.interrupt_round()
    assert node.name not in e.cluster.nodes and node.name not in e.intr._rebalances
    return e


CASES = [
    case_spot_interruption_drains_and_marks_ice,
    case_rebalance_is_event_only,
    case_state_change_only_for_actionable_states,
    case_scheduled_change_drains,
    case_unknown_and_garbage_messages_are_noops,
    case_message_for_unknown_instance_ignored,
    case_rounds_to_replacement_is_one,
    case_reclaim_feeds_risk_cache_and_ice,
    storm_case(0),
    storm_case(1),
    storm_case(2),
    case_replacement_launched_before_drain_then_gated,
    case_deadline_fallback_inside_notice_window,
    case_reclaim_wins_race_with_pending_rebalance,
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[len("case_"):])
def test_interruption_matches_reference(case, one_worker):
    log = run_twins(case)
    assert any(key == "handled" for key, _ in log)


def test_parallel_batch_matches_reference_as_sets():
    """At the default ten workers (``tests/test_operator_surface.py``'s
    parallel batch, with duplicates and garbage mixed in): the same nodes
    drain, the same pools are marked, and the same pods re-pend, compared
    as sets."""
    out = {}
    for pkg in PACKAGES:
        e = Env(pkg, spot=True, n_pods=30, proactive=False)
        try:
            assert e.intr.WORKERS == 10
            e.reconcile()
            nodes = sorted(e.cluster.nodes.values(), key=lambda n: n.name)
            for n in nodes:
                e.queue.send(spot_warning(iid(n)))
            for n in nodes[:3]:
                e.queue.send(spot_warning(iid(n)))
            e.queue.send_raw("{not json")
            e.queue.send({"version": "9", "source": "unknown", "detail-type": "???"})
            e.queue.send(rebalance_rec("i-ghost"))
            handled = 0
            while len(e.queue):
                handled += e.intr.reconcile(max_messages=100)
            assert not e.cluster.nodes
            out[pkg] = (handled, sorted(p.name for p in e.cluster.pending_pods()),
                        sorted(e.provider.unavailable_offerings.entries()),
                        sorted((it, z, e.risk.observations(it, z, "spot")) for it, z in e.pools))
        finally:
            e.intr.close(wait=True)
    assert out[PORT] == out[REF]
    assert out[PORT][1] and out[PORT][2]


def test_close_joins_the_worker_pool():
    e = Env(PORT, spot=True, n_pods=12, proactive=False)
    e.reconcile()
    for n in list(e.cluster.nodes.values()):
        e.queue.send(spot_warning(iid(n)))
    e.intr.reconcile(max_messages=100)
    pool = e.intr._pool
    assert pool is not None
    e.intr.close(wait=True)
    assert e.intr._pool is None and pool._shutdown


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
