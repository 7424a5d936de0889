"""The operator on the CPU: the port's ``Operator`` against the JAX package's
on twin clusters, and the port's entry point, HTTP surface, leader election,
context discovery and state scrapers.

Each package builds its own cluster, provider, settings and clock from the
same rows, and each case runs in both. The JAX package's operator gets
``TPUSolver(auto_mesh=False, quality_sync=True)`` (a default ``TPUSolver``
builds the eight-device mesh), and its deprovisioning quality solver is
swapped for one that compiles inline, as ``test_torch_deprovisioning.py``
does; the port's operator builds its own default solver with
``device="cpu"``. The host paths polish without their deadlines
(``_host_paths_run_dry``), machines launch one at a time in plan order
(``create_batched = None``), and the multi-node consolidation search gets an
hour. The interruption controller handles its messages on one worker in
both packages (``WORKERS = 1``): with more, the order of the drained nodes'
pods, and with it the next digest, follows the threads.

Only ``step()``-driven flows on a ``FakeClock`` are compared. After each
step a case records the cluster's nodes as a multiset of (instance type,
zone, capacity type, image, launch-template name, sorted pod names), the
pending pods, the provider's instance count, and what the step's
controllers returned: the interruption messages handled, the provisioning
round's bound and unschedulable pods, and the deprovisioning action. The
two packages' records must be equal, floats to 1e-9 relative. ``run()`` and
``main()`` are held by their behaviour: cadence, backoff and the order of
the shutdown steps.

``Operator.new`` reconfigures process-wide state in both packages; the
``_process_state`` fixture restores what a later test file could see (the
cost ledgers' refreshers on the metrics registry, the decision log, the
lifecycle tracker, the garbage collector's frozen heap and thresholds).
"""

from __future__ import annotations

import gc
import importlib
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from collections import Counter
from types import SimpleNamespace

import pytest

from karpenter_tpu.solver import TPUSolver
from test_torch_controller import (  # noqa: F401  (fixtures)
    PACKAGES,
    _fresh_caches,
    _host_paths_run_dry,
    hold_fits,
)
from test_torch_deprovisioning import action_row, assert_same

REF, PORT = PACKAGES
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP_BUDGET_S = 3600.0
QUALITY_BUDGET_S = 2.0
CLOCK_START = 1_700_000_000.0


def pkg_mod(pkg: str) -> SimpleNamespace:
    """The names an operator is built from, in package ``pkg``."""
    imp = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
    return SimpleNamespace(
        pkg=pkg, api=imp("api"), wk=imp("api.labels"), objects=imp("api.objects"),
        settings=imp("api.settings"), cloud=imp("cloudprovider"),
        pricing=imp("cloudprovider.pricing"), state=imp("state"), operator=imp("operator"),
        intr=imp("controllers.interruption"), prov=imp("controllers.provisioning"),
        kit=imp("controllers.kit"), scrapers=imp("controllers.metricsscraper"),
        cache=imp("utils.cache"), metrics=imp("utils.metrics"), decisions=imp("utils.decisions"),
        lifecycle=imp("utils.lifecycle"), costledger=imp("utils.costledger"),
        solver=imp("solver.solver"), encode=imp("solver.encode"), context=imp("context"),
        leader=imp("utils.leaderelection"), http=imp("utils.httpserver"),
        fr=imp("utils.flightrecorder"), main=imp("__main__"),
    )


@pytest.fixture(autouse=True)
def _process_state():
    """Leave no operator's process-wide state to a later test: the cost
    ledgers' pre-scrape refreshers (one per ``Operator.new``), the decision
    log, the flight recorder, the lifecycle tracker, and the heap that
    ``run()`` froze."""
    mods = {pkg: pkg_mod(pkg) for pkg in PACKAGES}
    before = {pkg: list(m.metrics.REGISTRY._refreshers) for pkg, m in mods.items()}
    threshold = gc.get_threshold()
    for m in mods.values():
        m.decisions.DECISIONS.configure(2048)
        m.decisions.DECISIONS.clear()
    yield mods
    for pkg, m in mods.items():
        reg = m.metrics.REGISTRY
        with reg._lock:
            reg._refreshers[:] = [
                fn for fn in reg._refreshers
                if any(fn is old for old in before[pkg])
                or not isinstance(getattr(fn, "__self__", None), m.costledger.CostLedger)
            ]
        m.decisions.DECISIONS.clear()
        m.fr.FLIGHT.configure(m.fr.FlightRecorder.DEFAULT_CAPACITY)
        m.fr.FLIGHT.clear()
        m.lifecycle.LIFECYCLE.configure(enabled=True, retention=4096)
    gc.unfreeze()
    gc.set_threshold(*threshold)


@pytest.fixture
def one_worker(monkeypatch):
    for pkg in PACKAGES:
        monkeypatch.setattr(pkg_mod(pkg).intr.InterruptionController, "WORKERS", 1)


def new_operator(m, provider, settings, clock=None, solver=None, **kw):
    """``Operator.new`` of package ``m``: the reference on an un-meshed
    ``TPUSolver`` with an inline-compiling quality solver, the port on the
    default solver it builds for ``device="cpu"`` unless ``solver`` is
    given."""
    if m.pkg == REF:
        solver = solver or TPUSolver(auto_mesh=False, quality_sync=True,
                                     dispatch_timeout_s=settings.kernel_dispatch_timeout_s)
        op = m.operator.Operator.new(provider=provider, settings=settings, solver=solver,
                                     clock=clock, **kw)
        d = op.deprovisioning
        if d.quality_solver is not None:
            q = TPUSolver(
                portfolio=solver.portfolio, seed=solver.seed, auto_mesh=False,
                latency_budget_s=QUALITY_BUDGET_S, warmup_spike_s=solver.warmup_spike_s,
                quality_race=True, quality_sync=True,
                dispatch_timeout_s=solver.dispatch_timeout_s,
            )
            q.risk_penalty = d.quality_solver.risk_penalty
            d.quality_solver = q
        return op
    if solver is not None:
        kw["solver"] = solver
    else:
        kw["device"] = "cpu"
    return m.operator.Operator.new(provider=provider, settings=settings, clock=clock, **kw)


def make_pod(m, name, cpu="100m", memory="128Mi", labels=None, spread=(), affinity=(),
             owner="ReplicaSet"):
    return m.api.Pod(
        meta=m.api.ObjectMeta(name=name, labels=dict(labels or {}), owner_kind=owner),
        requests=m.api.Resources(cpu=cpu, memory=memory),
        topology_spread=list(spread), affinity_terms=list(affinity),
    )


def make_pods(m, n, prefix="pod", **kw):
    return [make_pod(m, f"{prefix}-{i}", **kw) for i in range(n)]


def spot_warning(instance_id):
    return {"version": "0", "source": "cloud.compute",
            "detail-type": "Spot Instance Interruption Warning",
            "detail": {"instance-id": instance_id}}


def iid(node):
    return node.provider_id.rsplit("/", 1)[-1]


class Twin:
    """One package's operator as ``tests/test_e2e_lifecycle.py``'s
    ``make_operator`` builds it, with its controllers' answers recorded."""

    def __init__(self, pkg, provisioner_kw=None, n_types=40, template=None, **settings_kw):
        m = self.m = pkg_mod(pkg)
        self.pkg = pkg
        settings_kw.setdefault("consolidation_timeout", SWEEP_BUDGET_S)
        settings_kw.setdefault("interruption_queue_name", "interruption-queue")
        self.settings = m.settings.Settings(
            batch_idle_duration=0, batch_max_duration=0, consolidation_validation_ttl=0,
            stabilization_window=0.0, **settings_kw,
        )
        self.clock = m.cache.FakeClock(start=CLOCK_START)
        self.provider = m.cloud.FakeCloudProvider(catalog=m.cloud.generate_catalog(n_types=n_types))
        self.provider.create_batched = None
        self.op = new_operator(m, self.provider, self.settings, self.clock)
        if template is not None:
            self.op.cluster.add_node_template(m.objects.NodeTemplate(
                meta=m.api.ObjectMeta(name=template), image_family="al2",
                subnet_selector={"karpenter.tpu/discovery": "cluster"},
                security_group_selector={"karpenter.tpu/discovery": "cluster"},
            ))
            provisioner_kw = dict(provisioner_kw or {}, node_template_ref=template)
        self.op.cluster.add_provisioner(m.api.Provisioner(
            meta=m.api.ObjectMeta(name="default"), **(provisioner_kw or {})))
        self.log = []
        self._instrument()

    def _instrument(self):
        op, log = self.op, self.log
        deprov, prov = op.deprovisioning.reconcile, op.provisioning.reconcile

        def deprovisioning():
            action = deprov()
            log.append(("deprovisioning", action_row(self.m, action)))
            return action

        def provisioning():
            result = prov()
            log.append(("provisioning", sorted(result.bound), sorted(result.unschedulable)))
            return result

        op.deprovisioning.reconcile = deprovisioning
        op.provisioning.reconcile = provisioning
        if op.interruption is not None:
            intr = op.interruption.reconcile

            def interruption(*a, **kw):
                handled = intr(*a, **kw)
                log.append(("interruption", handled))
                return handled

            op.interruption.reconcile = interruption

    @property
    def cluster(self):
        return self.op.cluster

    def add(self, pods):
        for p in pods:
            self.cluster.add_pod(p)

    def step(self, n=1):
        for _ in range(n):
            self.op.step()
            hold_fits(self.cluster)
            self.log.append(("state", self.state()))

    def state(self):
        wk, cluster = self.m.wk, self.cluster
        nodes = Counter()
        for node in cluster.nodes.values():
            lab = node.meta.labels
            machine = cluster.machine_for_node(node)
            inst = self.provider.instance_for(machine) if machine is not None else None
            nodes[(lab.get(wk.INSTANCE_TYPE), lab.get(wk.ZONE), lab.get(wk.CAPACITY_TYPE),
                   inst.image_id if inst else None, inst.launch_template if inst else None,
                   tuple(sorted(p.name for p in cluster.pods_on_node(node.name))))] += 1
        ledger = self.op.costledger.debug_payload()
        return dict(nodes=sorted(nodes.items()),
                    pending=sorted(p.name for p in cluster.pending_pods()),
                    instances=len(self.provider.instances),
                    ledger=(ledger["total_dollars"], ledger["ondemand_dollars"],
                            ledger["savings"], ledger["losses"]))

    def interrupt(self, nodes):
        for node in nodes:
            self.op.interruption.queue.send(spot_warning(iid(node)))


def run_twins(case):
    """``case(pkg)`` in both packages; their records must be equal."""
    logs = {}
    for pkg in PACKAGES:
        twin = case(pkg)
        try:
            logs[pkg] = list(twin.log)
        finally:
            twin.op.close()
    assert_same(logs[PORT], logs[REF], case.__name__)
    return logs[PORT]


# -- the cases of tests/test_e2e_lifecycle.py and test_drift_template_e2e.py --


def case_provision_interrupt_reprovision(pkg):
    t = Twin(pkg)
    t.add(make_pods(t.m, 8, cpu="500m"))
    t.step()
    assert not t.cluster.pending_pods() and t.cluster.nodes
    t.interrupt(list(t.cluster.nodes.values()))
    t.step(2)
    assert not t.cluster.pending_pods()
    assert all(p.node_name is not None for p in t.cluster.pods.values())
    return t


def case_drift_flows_into_replacement(pkg):
    t = Twin(pkg)
    t.add(make_pods(t.m, 4, cpu="500m"))
    t.step()
    t.provider.rotate_image()
    t.step(4)
    assert not t.cluster.pending_pods()
    for node in t.cluster.nodes.values():
        machine = t.cluster.machine_for_node(node)
        assert machine is None or not t.provider.is_machine_drifted(machine)
    return t


def case_full_empty_scale_down_to_zero(pkg):
    t = Twin(pkg, provisioner_kw=dict(ttl_seconds_after_empty=30))
    t.add(make_pods(t.m, 5, cpu="500m"))
    t.step()
    assert t.cluster.nodes
    for p in list(t.cluster.pods.values()):
        t.cluster.delete_pod(p.name)
    t.step()
    t.clock.step(31)
    t.step()
    assert not t.cluster.nodes and not t.provider.instances
    return t


def case_runaway_scale_up_guard(pkg):
    t = Twin(pkg, provisioner_kw=dict(consolidation_enabled=True,
                                      limits=pkg_mod(pkg).api.Resources(cpu=64)))
    for r in range(10):
        t.add(make_pods(t.m, 30, prefix=f"r{r}", cpu="1", memory="1Gi"))
        t.step()
    total = sum(n.capacity["cpu"] for n in t.cluster.nodes.values())
    biggest = max((n.capacity["cpu"] for n in t.cluster.nodes.values()), default=0)
    assert total <= 64 + biggest and len(t.cluster.nodes) < 35
    return t


def zone_skew(m, cluster, app):
    zones = {n.meta.labels.get(m.wk.ZONE) for n in cluster.nodes.values()}
    counts = {z: 0 for z in zones if z}
    for p in cluster.pods.values():
        if p.meta.labels.get("app") == app and p.node_name in cluster.nodes:
            counts[cluster.nodes[p.node_name].meta.labels[m.wk.ZONE]] += 1
    return max(counts.values()) - min(counts.values()) if counts else 0


def case_spread_and_colocation(pkg):
    t = Twin(pkg)
    m, api = t.m, t.m.api
    spread = [api.TopologySpreadConstraint(max_skew=1, topology_key=m.wk.ZONE,
                                           label_selector={"app": "svc"})]
    t.add(make_pods(m, 90, prefix="svc", cpu="500m", labels={"app": "svc"}, spread=spread))
    t.add(make_pods(m, 6, prefix="db", cpu="1", memory="2Gi", labels={"app": "db"}))
    t.add(make_pods(m, 24, prefix="web", cpu="250m", labels={"app": "web"}, affinity=[
        api.PodAffinityTerm(label_selector={"app": "db"}, topology_key=m.wk.HOSTNAME)]))
    t.step(3)
    assert not t.cluster.pending_pods() and zone_skew(m, t.cluster, "svc") <= 1
    db_nodes = {p.node_name for p in t.cluster.pods.values() if p.meta.labels.get("app") == "db"}
    assert all(p.node_name in db_nodes for p in t.cluster.pods.values()
               if p.meta.labels.get("app") == "web")
    return t


def case_consolidation_preserves_zone_spread(pkg):
    t = Twin(pkg, provisioner_kw=dict(consolidation_enabled=True))
    m = t.m
    spread = [m.api.TopologySpreadConstraint(max_skew=1, topology_key=m.wk.ZONE,
                                             label_selector={"app": "svc"})]
    t.add(make_pods(m, 36, prefix="svc", cpu="250m", labels={"app": "svc"}, spread=spread))
    t.step()
    assert not t.cluster.pending_pods() and zone_skew(m, t.cluster, "svc") <= 1
    t.interrupt(sorted(t.cluster.nodes.values(), key=lambda n: n.name)[::2])
    for _ in range(6):
        t.step()
        if not t.cluster.pending_pods():
            assert zone_skew(m, t.cluster, "svc") <= 1
    assert not t.cluster.pending_pods() and zone_skew(m, t.cluster, "svc") <= 1
    return t


def case_template_drift_replacement(pkg):
    t = Twin(pkg, n_types=20, template="al2-tpl", interruption_queue_name=None)
    for i in range(6):
        t.cluster.add_pod(make_pod(t.m, f"p-{i}", cpu="250m", memory="512Mi"))
    t.step()
    assert all(p.node_name for p in t.cluster.pods.values())
    old = set(t.cluster.nodes)
    images = {t.provider.instance_for(mc).image_id for mc in t.cluster.machines.values()}
    assert images and all(img.startswith("img-al2-") for img in images)
    new_img = t.provider.rotate_image("al2", "standard")
    assert set(t.op.drift.reconcile()) == old
    for _ in range(20):
        t.step()
        t.clock.step(30)
        live = set(t.cluster.nodes)
        if live and not (live & old):
            break
    assert all(p.node_name for p in t.cluster.pods.values()) and not (set(t.cluster.nodes) & old)
    for mc in t.cluster.machines.values():
        assert t.provider.instance_for(mc).image_id == new_img
    return t


def case_restart_adoption(pkg):
    """``tests/test_runtime.py``'s restart: a second operator over the same
    cloud adopts the first one's instances and deletes none."""
    t = Twin(pkg, n_types=15, interruption_queue_name=None)
    t.add(make_pods(t.m, 4, cpu="250m", memory="512Mi"))
    t.step()
    before = set(t.provider.instances)
    assert before
    t.op.close()
    m = t.m
    t.op = new_operator(m, t.provider, t.settings, t.clock)
    t.op.cluster.add_provisioner(m.api.Provisioner(meta=m.api.ObjectMeta(name="default")))
    t.step()
    assert t.cluster.machines and set(t.provider.instances) == before
    t.log.append(("adopted", len(t.cluster.machines)))
    return t


TWIN_CASES = [
    case_provision_interrupt_reprovision,
    case_drift_flows_into_replacement,
    case_full_empty_scale_down_to_zero,
    case_runaway_scale_up_guard,
    case_spread_and_colocation,
    case_consolidation_preserves_zone_spread,
    case_template_drift_replacement,
    case_restart_adoption,
]


@pytest.mark.parametrize("case", TWIN_CASES, ids=lambda c: c.__name__[len("case_"):])
def test_operator_steps_match_reference(case, one_worker):
    log = run_twins(case)
    assert any(kind == "provisioning" for kind, *_ in log)


def test_interruption_default_workers_match_as_sets():
    """At the default ten workers the drained nodes' pods re-pend in thread
    order; the outcome compared as sets is still the reference's."""
    out = {}
    for pkg in PACKAGES:
        t = Twin(pkg)
        try:
            assert t.op.interruption.WORKERS == 10
            t.add(make_pods(t.m, 40, cpu="1", memory="1Gi"))
            t.step()
            t.interrupt(sorted(t.cluster.nodes.values(), key=lambda n: n.name))
            t.step(3)
            assert not t.cluster.pending_pods()
            out[pkg] = (sorted(p.name for p in t.cluster.pods.values()),
                        len(t.op.interruption.queue), t.provider.unavailable_offerings.seqnum,
                        sorted(k for k, *_ in t.log))
        finally:
            t.op.close()
    assert out[PORT] == out[REF]


def test_caller_supplied_empty_queue_is_used():
    """``FakeQueue`` has ``__len__``: an empty caller queue is falsy and must
    not be replaced."""
    m = pkg_mod(PORT)
    queue = m.intr.FakeQueue()
    op = m.operator.Operator.new(
        provider=m.cloud.FakeCloudProvider(catalog=m.cloud.generate_catalog(n_types=10)),
        settings=m.settings.Settings(interruption_queue_name="q"), queue=queue, device="cpu",
    )
    try:
        assert op.interruption.queue is queue
    finally:
        op.close()


# -- what Operator.new builds ------------------------------------------------


def test_default_solver_is_the_card_unless_asked():
    import torch

    from karpenter_tpu_torch.solver import TorchSolver

    m = pkg_mod(PORT)
    provider = m.cloud.FakeCloudProvider(catalog=m.cloud.generate_catalog(n_types=5))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            m.operator.Operator.new(provider=provider)
    settings = m.settings.Settings(device_staging_enabled=False, device_staging_capacity_mb=64,
                                   kernel_dispatch_timeout_s=3.0)
    op = m.operator.Operator.new(provider=provider, settings=settings, device="cpu")
    try:
        solver = op.provisioning.solver
        assert isinstance(solver, TorchSolver) and solver.device.type == "cpu"
        assert solver.dispatch_timeout_s == 3.0
        assert solver._stager.enabled is False and solver._stager.capacity_bytes == 64 << 20
        assert isinstance(op.deprovisioning.quality_solver, TorchSolver)
        assert op.deprovisioning.quality_solver.device.type == "cpu"
        assert op.deprovisioning.costs is op.costledger and op.interruption is None
        assert op.nodetemplate is not None and op.pricing is not None
        ref = pkg_mod(REF)
        assert [s.name for s in op.scrapers] == [
            s.name for s in ref.scrapers.build_scrapers(ref.state.Cluster())]
    finally:
        op.close()


def test_aot_cache_capacity_is_read_from_the_settings():
    """``Operator.new`` sizes each package's process-wide AOT cache from
    ``aot_cache_capacity``: the reference's executables and their dispatch
    latencies, the port's dispatch latencies alone."""
    from karpenter_tpu.solver.jax_solver import AOT_CACHE as ref_table
    from karpenter_tpu_torch.solver.torch_solver import AOT_CACHE as port_table

    tables = {REF: ref_table, PORT: port_table}
    before = {pkg: t.capacity for pkg, t in tables.items()}
    try:
        for pkg in PACKAGES:
            m = pkg_mod(pkg)
            provider = m.cloud.FakeCloudProvider(catalog=m.cloud.generate_catalog(n_types=5))
            op = new_operator(m, provider, m.settings.Settings(aot_cache_capacity=48))
            op.close()
        assert ref_table.capacity == port_table.capacity == 48
    finally:
        for pkg, t in tables.items():
            t.configure(capacity=before[pkg])


@pytest.mark.parametrize("settings_kw", [dict(mesh_enabled=True)], ids=["mesh"])
def test_unported_settings_raise(settings_kw, one_worker):
    """``mesh_enabled`` is honoured as the reference honours it, not
    refused: the operator resolves ``mesh_shape`` through
    ``parse_mesh_shape``, which is None below two cards (this process sees
    none), so its solver builds no mesh, and a step binds what the
    reference's operator binds."""

    def case_mesh_enabled(pkg):
        t = Twin(pkg, **settings_kw)
        t.add(make_pods(t.m, 12, cpu="500m"))
        t.step()
        assert not t.cluster.pending_pods() and t.settings.mesh_enabled
        if pkg == PORT:
            solver = t.op.provisioning.solver
            assert solver.mesh_shape is None and solver._ensure_mesh() is None
        return t

    run_twins(case_mesh_enabled)


def test_federation_settings_wire_the_arbiter_link():
    """``federation_enabled`` builds the reference's ``FederationClient``
    for ``arbiter_endpoint`` (over HTTP), hands it to provisioning and
    interruption, late-binds ``/debug/federation`` to its status, and adds
    the ``federation-summary`` heartbeat at ``summary_interval_s``, as the
    JAX package's operator does."""
    from karpenter_tpu_torch.federation.client import HTTPArbiterTransport

    mods = {pkg: pkg_mod(pkg) for pkg in PACKAGES}
    ops = {}
    for pkg, m in mods.items():
        settings = m.settings.Settings(
            cluster_name="us-east", federation_enabled=True,
            arbiter_endpoint="http://127.0.0.1:1", summary_interval_s=7.0,
            interruption_queue_name="q", batch_idle_duration=0, batch_max_duration=0)
        provider = m.cloud.FakeCloudProvider(catalog=m.cloud.generate_catalog(n_types=5))
        ops[pkg] = new_operator(m, provider, settings)
    op = ops[PORT]
    try:
        fed = op.federation
        assert fed is not None and fed.cluster_name == "us-east"
        assert isinstance(fed.transport, HTTPArbiterTransport)
        assert fed.transport.endpoint == "http://127.0.0.1:1"
        assert op.provisioning.federation is fed and op.interruption.federation is fed
        assert fed.status() == ops[REF].federation.status()
        names = {}
        for pkg, o in ops.items():
            stop = threading.Event()
            stop.set()  # the loop builds its controllers and returns
            o._run_loop(stop, 0.01)
            names[pkg] = [c.name for c in o.controllers]
        assert names[PORT] == names[REF]
        beats = [c for c in op.controllers if c.name == "federation-summary"]
        assert [c.interval for c in beats] == [7.0]
    finally:
        for o in ops.values():
            o.close()


def test_profiling_enabled_starts_the_sampler_and_stop_profiler_stops_it(tmp_path):
    """``profiling_enabled`` starts the continuous sampler at the settings'
    rate and turns tracemalloc's allocators on, as the reference's operator
    does; the sentinel is configured from the settings with its baselines
    under ``aot_cache_dir``; ``close()``'s ``stop-profiler`` step ends the
    sampler thread."""
    from karpenter_tpu_torch.utils import profiling, runtimehealth

    m, op = port_operator(profiling_enabled=True, profiling_sample_hz=97.0,
                          perf_sentinel_mad_k=4, aot_cache_dir=str(tmp_path))
    try:
        assert profiling.PROFILER.running and profiling.PROFILER._hz == 97.0
        assert runtimehealth._memory_profiling
        snap = profiling.SENTINEL.snapshot()
        assert snap["enabled"] and snap["sentinel_enabled"] and snap["mad_k"] == 4
        assert snap["baseline_path"] == str(tmp_path / profiling.BASELINE_FILENAME)
        deadline = time.time() + 10
        while profiling.PROFILER.samples == 0 and time.time() < deadline:
            time.sleep(0.02)
        assert profiling.PROFILER.samples > 0
    finally:
        op.close()
    assert not profiling.PROFILER.running
    runtimehealth.install(memory_profiling=False)
    profiling.configure()


def test_device_fault_script_installs_its_plan(monkeypatch):
    """``Operator.new`` arms ``device_fault_script`` as the process's device
    fault plan, as the reference's does (``tests/test_solver_faultdomain.py``'s
    ``test_operator_installs_plan_from_settings``), in both packages."""
    pending = {}
    for pkg in PACKAGES:
        m = pkg_mod(pkg)
        faults = importlib.import_module(f"{pkg}.utils.faults")
        provider = m.cloud.FakeCloudProvider(catalog=m.cloud.generate_catalog(n_types=5))
        settings = m.settings.Settings(
            batch_idle_duration=0, batch_max_duration=0,
            device_fault_script="t=0,kind=garbage-result,n=2;t=0,kind=dispatch-hang,hang=0.5",
        )
        op = new_operator(m, provider, settings)
        try:
            plan = faults._DEVICE_PLAN
            pending[pkg] = (plan.pending("result"), plan.pending("dispatch"), plan.serialize())
        finally:
            op.close()
            faults.install_device_faults(None)
    assert pending[PORT] == pending[REF] == (
        2, 1, "t=0,kind=garbage-result;t=0,kind=garbage-result;t=0,kind=dispatch-hang,hang=0.5")


def test_kernel_telemetry_matches_reference():
    """The operator's ``/metrics`` serves the kernel board's and the
    stager's series: after the same steps on twin operators whose solvers
    run the kernel in quality mode, ``karpenter_tpu_kernel_faults_total``,
    ``karpenter_tpu_kernel_backend_health`` and
    ``karpenter_tpu_device_staging_total`` moved alike in both packages, and
    the board reads healthy."""
    from karpenter_tpu_torch.solver import TorchSolver

    from test_torch_controller import QUALITY

    moved = {}
    for pkg in PACKAGES:
        m = pkg_mod(pkg)
        series = (m.metrics.KERNEL_FAULTS, m.metrics.DEVICE_STAGING)
        before = [dict(s._values) for s in series]
        settings = m.settings.Settings(batch_idle_duration=0, batch_max_duration=0)
        provider = m.cloud.FakeCloudProvider(catalog=m.cloud.generate_catalog(n_types=30))
        provider.create_batched = None
        solver = (TPUSolver(auto_mesh=False, quality_sync=True, **QUALITY) if pkg == REF
                  else TorchSolver(device="cpu", **QUALITY))
        op = new_operator(m, provider, settings, m.cache.FakeClock(start=CLOCK_START),
                          solver=solver)
        try:
            op.cluster.add_provisioner(m.api.Provisioner(meta=m.api.ObjectMeta(name="default")))
            spread = [m.api.TopologySpreadConstraint(max_skew=1, topology_key=m.wk.ZONE,
                                                     label_selector={"app": "s"})]
            for r in range(3):
                for p in make_pods(m, 40, prefix=f"r{r}", cpu="250m", labels={"app": "s"},
                                   spread=spread):
                    op.cluster.add_pod(p)
                op.step()
                assert not op.cluster.pending_pods()
            body = m.metrics.REGISTRY.exposition()
        finally:
            op.close()
        assert "karpenter_tpu_kernel_backend_health 1" in body
        assert m.solver.KERNEL_BOARD.health() == 1.0
        assert set(m.solver.KERNEL_BOARD.states().values()) <= {"closed"}
        moved[pkg] = [
            {k: v - old.get(k, 0.0) for k, v in s._values.items() if v != old.get(k, 0.0)}
            for s, old in zip(series, before)
        ] + [m.metrics.KERNEL_BACKEND_HEALTH.value()]
    assert moved[PORT] == moved[REF]
    assert moved[PORT][1], "the kernel path staged nothing"


def test_kernel_board_health_and_faults():
    """The board's gauge is the closed share of the buckets it has seen,
    and each piece of evidence counts under its kind."""
    from karpenter_tpu_torch.solver.solver import KernelBreakerBoard
    from karpenter_tpu_torch.utils import metrics

    board = KernelBreakerBoard(failure_threshold=2)
    before = metrics.KERNEL_FAULTS.value({"kind": "invalid-plan"})
    assert board.health() == 1.0 and board.states() == {}
    board.ok("a")
    board.fail("b", "invalid-plan")
    assert board.health() == 1.0 and board.states() == {"a": "closed", "b": "closed"}
    board.fail("b", "invalid-plan")
    assert board.states()["b"] == "open" and board.health() == 0.5
    assert metrics.KERNEL_BACKEND_HEALTH.value() == 0.5
    assert metrics.KERNEL_FAULTS.value({"kind": "invalid-plan"}) == before + 2
    board.reset()
    assert metrics.KERNEL_BACKEND_HEALTH.value() == 1.0


# -- run(), close() and the controller kit -----------------------------------


def port_operator(n_types=10, **settings_kw):
    m = pkg_mod(PORT)
    provider = m.cloud.FakeCloudProvider(catalog=m.cloud.generate_catalog(n_types=n_types))
    op = m.operator.Operator.new(provider=provider, settings=m.settings.Settings(**settings_kw),
                                 device="cpu")
    op.cluster.add_provisioner(m.api.Provisioner(meta=m.api.ObjectMeta(name="default")))
    return m, op


def run_in_thread(op, **kw):
    stop = threading.Event()
    t = threading.Thread(target=op.run, args=(stop,), kwargs=kw)
    t.start()
    return stop, t


def test_run_loop_binds_and_stops():
    m, op = port_operator(batch_idle_duration=0, batch_max_duration=0)
    for p in make_pods(m, 6, cpu="250m"):
        op.cluster.add_pod(p)
    stop, t = run_in_thread(op, tick=0.01)
    deadline = time.time() + 30
    try:
        while time.time() < deadline and op.cluster.pending_pods():
            time.sleep(0.05)
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive() and not op.cluster.pending_pods()
    names = [c.name for c in op.controllers]
    assert names[:4] == ["provisioning", "deprovisioning", "termination", "nodetemplate"]
    assert "pricing" in names and "gcmaintain" in names and names[-3:] == [
        s.name for s in op.scrapers]
    cadence = {c.name: c.interval for c in op.controllers}
    assert cadence["drift"] == cadence["nodetemplate"] == 300.0


def test_run_loop_survives_crashing_controller():
    m, op = port_operator(batch_idle_duration=0.01, batch_max_duration=0.05)
    boom = {"n": 0}

    def exploding():
        boom["n"] += 1
        raise RuntimeError("drift crashed")

    op.drift.reconcile = exploding
    stop, t = run_in_thread(op, tick=0.02)
    try:
        op.cluster.add_pod(make_pod(m, "p-0", cpu="250m", memory="512Mi"))
        deadline = time.time() + 20
        while time.time() < deadline and (not op.cluster.pods["p-0"].node_name or boom["n"] < 1):
            time.sleep(0.05)
        assert op.cluster.pods["p-0"].node_name is not None and boom["n"] >= 1
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()
    drift = next(c for c in op.controllers if c.name == "drift")
    assert drift.consecutive_errors >= 1
    assert m.metrics.RECONCILE_ERRORS.value({"controller": "drift"}) >= 1


def test_close_order_and_guarded_steps(monkeypatch):
    """``close()`` stops the sampling profiler, joins the interruption
    workers, flushes the flight recorder's dumps, releases the lease, and
    stops the HTTP server last, even when a step fails."""
    m, op = port_operator(interruption_queue_name="q")
    calls = []
    op.interruption.close = lambda wait=False: calls.append(("interruption", wait))
    monkeypatch.setattr(m.fr.FLIGHT, "flush_dumps", lambda: calls.append(("flush",)) or [])

    class Elector:
        def release(self):
            calls.append(("lease",))
            raise OSError("lease volume gone")

    class Server:
        def stop(self):
            calls.append(("http",))

    from karpenter_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling.PROFILER, "stop", lambda: calls.append(("profiler",)))
    op.elector, op.http_server = Elector(), Server()
    op.close()
    assert calls == [("profiler",), ("interruption", True), ("flush",), ("lease",), ("http",)]


def test_operator_new_configures_the_flight_recorder(tmp_path):
    """``Operator.new`` sizes the process's flight recorder and its dump
    directory from settings, as the reference's does; 0 turns it off."""
    got = {}
    for pkg in PACKAGES:
        m = pkg_mod(pkg)
        provider = m.cloud.FakeCloudProvider(catalog=m.cloud.generate_catalog(n_types=5))
        for capacity, dump_dir in ((7, str(tmp_path)), (0, "")):
            settings = m.settings.Settings(flight_recorder_capacity=capacity,
                                           flight_recorder_dump_dir=dump_dir)
            op = new_operator(m, provider, settings)
            try:
                got.setdefault(pkg, []).append(
                    (m.fr.FLIGHT.capacity, m.fr.FLIGHT.enabled, m.fr.FLIGHT.dump_dir))
            finally:
                op.close()
    assert got[PORT] == got[REF] == [(7, True, str(tmp_path)), (0, False, None)]


def test_run_serves_http_and_late_binds_debug_views():
    m, op = port_operator(batch_idle_duration=0, batch_max_duration=0)
    stop, t = run_in_thread(op, http_port=0, tick=0.01)
    try:
        deadline = time.time() + 10
        while time.time() < deadline and getattr(op, "http_server", None) is None:
            time.sleep(0.02)
        port = op.http_server.port
        assert get(port, "/metrics")[0] == 200
        costs = json.loads(get(port, "/debug/costs")[1])
        assert "total_dollars" in costs and "conservation" in costs
        assert json.loads(get(port, "/debug/cells")[1])["enabled"] is False
        assert json.loads(get(port, "/debug/federation")[1]) == {"enabled": False}
    finally:
        stop.set()
        t.join(timeout=10)
    with pytest.raises(OSError):
        get(port, "/healthz")


# -- the HTTP surface (tests/test_operator_surface.py) ------------------------


def get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
        return r.status, r.read().decode()


def status_of(port, path):
    try:
        return get(port, path)[0]
    except urllib.error.HTTPError as e:
        return e.code


@pytest.fixture
def server():
    servers = []

    def start(**kw):
        srv = pkg_mod(PORT).http.OperatorHTTPServer(port=0, **kw).start()
        servers.append(srv)
        return srv

    yield start
    for srv in servers:
        srv.stop()


def test_debug_index_is_the_reference_table_less_the_unported_routes(server):
    ref = pkg_mod(REF).http.DEBUG_ROUTES
    port = pkg_mod(PORT).http.DEBUG_ROUTES
    left_out = set()  # /debug/profile and /debug/perf came with the profiler
    assert port == {k: v for k, v in ref.items() if k not in left_out}
    srv = server()
    index = json.loads(get(srv.port, "/debug")[1])["routes"]
    assert [r["path"] for r in index] == list(port)


@pytest.mark.parametrize("path, status", [
    ("/metrics", 200), ("/healthz", 200), ("/readyz", 200), ("/leaderz", 200),
    ("/debug", 200), ("/debug/", 200), ("/debug/traces", 200), ("/debug/events", 200),
    ("/debug/decisions?limit=5", 200), ("/debug/cells", 200), ("/debug/lifecycle", 200),
    ("/debug/lifecycle?pod=nobody", 404), ("/debug/federation", 200), ("/debug/slo", 200),
    ("/debug/costs", 200), ("/debug/flightrecorder", 200), ("/debug/flightrecorder/c-1", 404),
    ("/debug/profile", 200), ("/debug/profile?status=1", 200), ("/debug/perf", 200),
    ("/nope", 404),
])
def test_endpoint_status(server, path, status):
    srv = server()
    assert status_of(srv.port, path) == status


def test_probes_follow_their_checks(server):
    ready, leader = {"ok": False}, {"ok": False}
    srv = server(ready_check=lambda: ready["ok"], leader_check=lambda: leader["ok"])
    assert status_of(srv.port, "/healthz") == 200
    assert status_of(srv.port, "/readyz") == 503 and status_of(srv.port, "/leaderz") == 503
    ready["ok"] = leader["ok"] = True
    assert status_of(srv.port, "/readyz") == 200 and status_of(srv.port, "/leaderz") == 200


def test_metrics_exposition_parses(server):
    srv = server()
    status, body = get(srv.port, "/metrics")
    assert status == 200 and "karpenter_tpu_pods_scheduled_total" in body
    for line in body.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            assert name.startswith("karpenter_tpu_")
            float(value)


# -- leader election (tests/test_runtime.py) ----------------------------------


def test_lease_single_holder_and_expiry(tmp_path):
    LeaderElector = pkg_mod(PORT).leader.LeaderElector
    lease = str(tmp_path / "lease")
    a = LeaderElector(lease, identity="a", lease_duration=5.0)
    b = LeaderElector(lease, identity="b", lease_duration=5.0)
    assert a.try_acquire() and not b.try_acquire()
    a.release()
    assert b.try_acquire()
    b.release()
    c = LeaderElector(lease, identity="c", lease_duration=0.1)
    assert c.try_acquire()
    time.sleep(0.15)
    d = LeaderElector(lease, identity="d", lease_duration=5.0)
    assert d.try_acquire() and not c.try_acquire()
    d.release()
    assert not os.path.exists(lease)


def test_lease_racing_contenders_yield_one_leader(tmp_path):
    LeaderElector = pkg_mod(PORT).leader.LeaderElector
    lease = str(tmp_path / "lease")
    electors = [LeaderElector(lease, identity=f"c{i}", lease_duration=5.0) for i in range(8)]
    barrier = threading.Barrier(len(electors))
    results = [False] * len(electors)

    def contend(i):
        barrier.wait()
        results[i] = electors[i].try_acquire()

    threads = [threading.Thread(target=contend, args=(i,)) for i in range(len(electors))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sum(results) == 1
    electors[results.index(True)].release()


def test_lease_lost_fires_on_lost(tmp_path):
    LeaderElector = pkg_mod(PORT).leader.LeaderElector
    lease = str(tmp_path / "lease")
    lost = threading.Event()
    a = LeaderElector(lease, identity="a", lease_duration=5.0, renew_interval=0.05,
                      on_lost=lost.set)
    assert a.acquire()
    with open(lease, "w") as f:
        json.dump({"holder": "b", "renewed": time.time(), "duration": 5.0}, f)
    assert lost.wait(timeout=5.0) and not a.is_leader
    a._stop.set()


# -- context discovery --------------------------------------------------------


def test_discover_wires_cluster_identity_as_the_reference_does():
    names = {}
    for pkg in PACKAGES:
        m = pkg_mod(pkg)
        provider = m.cloud.FakeCloudProvider(catalog=m.cloud.generate_catalog(n_types=10))
        ctx = m.context.OperatorContext.discover(provider=provider,
                                                 settings=m.settings.Settings(cluster_name="blue"))
        assert ctx.cluster_info.name == "blue" and ctx.region == "zone"
        assert provider.launch_template_provider.cluster.name == "blue"
        tpl = m.objects.NodeTemplate(meta=m.api.ObjectMeta(name="t"), image_family="al2")
        names[pkg] = [c.name for c in provider.launch_template_provider.ensure_all(
            tpl, provider.catalog[:4])]
        with pytest.raises(m.context.ConnectivityError):
            m.context.OperatorContext.discover(provider=m.cloud.FakeCloudProvider(catalog=[]),
                                               settings=m.settings.Settings())
    assert names[PORT] == names[REF] and names[PORT]


# -- the entry point ----------------------------------------------------------


def test_parser_is_the_references_plus_device():
    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs, a.const)
                for a in parser._actions}

    ref = flags(pkg_mod(REF).main.build_parser())
    port = flags(pkg_mod(PORT).main.build_parser())
    assert port.pop("device") == (("--device",), "cuda", None, None, None)
    assert port == ref
    args = pkg_mod(PORT).main.build_parser().parse_args(
        ["--cluster-name", "x", "--metrics-port", "0", "--leader-elect", "--log-format", "json",
         "--batch-idle-duration", "0.1", "--device", "cpu"])
    assert args.cluster_name == "x" and args.leader_elect and args.device == "cpu"


def run_main(monkeypatch, argv, until, limit=60.0):
    """``main(argv)`` on the CPU in a thread (signal handlers stubbed: they
    install only on the main thread), stopped through the event its
    handler would set once ``until()`` holds. Returns main's exit code."""
    entry = pkg_mod(PORT).main
    created = []
    real_event = threading.Event

    class TrackedEvent(real_event):
        def __init__(self):
            super().__init__()
            created.append(self)

    monkeypatch.setattr(signal, "signal", lambda *a, **k: None)
    monkeypatch.setattr(threading, "Event", TrackedEvent)
    rc = {}
    t = threading.Thread(target=lambda: rc.setdefault("rc", entry.main(
        [*argv, "--device", "cpu", "--metrics-port", "-1", "--tick", "0.05"])))
    t.start()
    try:
        deadline = time.time() + limit
        while time.time() < deadline and not (created and until()):
            assert t.is_alive(), "main returned early"
            time.sleep(0.05)
        assert until(), "main never did what the case waits for"
    finally:
        for e in created:
            e.set()
        t.join(timeout=60)
    assert not t.is_alive()
    return rc.get("rc")


def http_pod(w, name):
    return w.api.Pod(meta=w.api.ObjectMeta(name=name, owner_kind="ReplicaSet"),
                     requests=w.api.Resources(cpu="250m", memory="512Mi"))


def test_cloud_endpoint_flag_runs_against_a_live_cloud(monkeypatch):
    """``--cloud-endpoint``: the operator's provider is an
    ``HTTPCloudProvider`` on that service (discovery and the loops call it
    over the wire)."""
    from test_torch_apiserver import pkg_mod as wire_mod

    w = wire_mod(PORT)
    svc = w.httpcloud.CloudHTTPService(w.cloud.generate_catalog(n_types=10)).start()
    try:
        rc = run_main(monkeypatch, ["--cloud-endpoint", svc.endpoint],
                      lambda: "/v1/instance-types" in svc.request_log
                      and "/v1/instances" in svc.request_log)
    finally:
        svc.stop()
    assert rc == 0


def test_cluster_endpoint_flag_reconciles_a_live_store(monkeypatch):
    """``--cluster-endpoint``: the operator reconciles the API server's
    store through ``HTTPCluster``; pods written there get bound there."""
    from test_torch_apiserver import pkg_mod as wire_mod

    w = wire_mod(PORT)
    store = w.state.Cluster()
    store.add_provisioner(w.api.Provisioner(meta=w.api.ObjectMeta(name="default")))
    for i in range(3):
        store.add_pod(http_pod(w, f"live-{i}"))
    api = w.apiserver.ClusterAPIServer(backing=store).start()
    try:
        rc = run_main(monkeypatch, ["--cluster-endpoint", api.endpoint],
                      lambda: all(p.node_name for p in store.pods.values()) and store.nodes)
    finally:
        api.stop()
    assert rc == 0 and len(store.machines) == len(store.nodes)


def test_serve_cluster_api_flag_answers_a_list(monkeypatch):
    """``--serve-cluster-api PORT`` serves the operator's own store: a
    list answers, a pod posted there is bound by the operator, and the
    listener is gone after shutdown."""
    from test_torch_apiserver import free_port, request
    from test_torch_apiserver import pkg_mod as wire_mod

    w = wire_mod(PORT)
    port = free_port()
    endpoint = f"http://127.0.0.1:{port}"
    seen = {}

    def served():
        try:
            status, body = request(endpoint, "GET", "/api/pods")
        except OSError:
            return False
        if status != 200 or "items" not in body:
            return False
        if "posted" not in seen:
            request(endpoint, "POST", "/api/provisioners",
                    w.codec.to_wire(w.api.Provisioner(meta=w.api.ObjectMeta(name="default"))))
            seen["posted"] = request(endpoint, "POST", "/api/pods",
                                     w.codec.to_wire(http_pod(w, "served-0")))[0]
            return False
        pod = request(endpoint, "GET", "/api/pods/served-0")[1]
        return bool(pod.get("nodeName"))

    rc = run_main(monkeypatch, ["--serve-cluster-api", str(port)], served)
    assert rc == 0 and seen["posted"] == 201
    with pytest.raises(OSError):
        request(endpoint, "GET", "/api/pods")


def test_serve_cluster_api_with_cluster_endpoint_warns_and_serves_nothing(monkeypatch, capsys):
    """A client of ``--cluster-endpoint`` owns no store: ``--serve-cluster-api``
    is ignored with the reference's warning."""
    from test_torch_apiserver import free_port, request
    from test_torch_apiserver import pkg_mod as wire_mod

    w = wire_mod(PORT)
    api = w.apiserver.ClusterAPIServer().start()
    port = free_port()
    err = []

    def warned():
        err.append(capsys.readouterr().err)
        return "--serve-cluster-api ignored" in "".join(err)

    try:
        rc = run_main(monkeypatch, ["--cluster-endpoint", api.endpoint,
                                    "--serve-cluster-api", str(port)], warned)
    finally:
        api.stop()
    assert rc == 0
    with pytest.raises(OSError):
        request(f"http://127.0.0.1:{port}", "GET", "/api/pods")


def test_main_runs_and_stops(monkeypatch):
    """``main()`` on the CPU with the in-process store and fake cloud, run
    for a moment and stopped through the event its handler would set."""
    start = time.time()
    assert run_main(monkeypatch, [], lambda: time.time() - start > 0.3) == 0


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_entrypoint_subprocess_serves_probes_and_stops_on_sigterm(tmp_path):
    """``python -m karpenter_tpu_torch --device cpu`` with a file lease:
    /healthz, /readyz and /leaderz answer 200, /metrics carries the
    kernel board's gauge, and SIGTERM stops it with exit code 0 and the
    lease released."""
    lease, port = str(tmp_path / "lease"), free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "karpenter_tpu_torch", "--device", "cpu", "--leader-elect",
         "--leader-elect-lease", lease, "--metrics-port", str(port), "--metrics-bind",
         "127.0.0.1", "--tick", "0.05"],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=open(tmp_path / "stderr", "w"),
    )
    try:
        deadline = time.time() + 60
        while time.time() < deadline:
            try:
                if all(get(port, p)[0] == 200 for p in ("/healthz", "/readyz", "/leaderz")):
                    break
            except (urllib.error.URLError, ConnectionError, OSError):
                assert proc.poll() is None, (tmp_path / "stderr").read_text()
                time.sleep(0.1)
        else:
            raise AssertionError("the entry point never answered its probes")
        body = get(port, "/metrics")[1]
        assert "karpenter_tpu_kernel_backend_health" in body
        assert os.path.exists(lease)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        assert not os.path.exists(lease)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# -- the state scrapers -------------------------------------------------------


def test_scrapers_exposition_matches_reference():
    """After the same steps, the scrapers' node, pod and provisioner series
    are the reference's."""
    bodies = {}
    for pkg in PACKAGES:
        t = Twin(pkg, interruption_queue_name=None)
        try:
            t.add(make_pods(t.m, 12, cpu="500m", memory="1Gi"))
            t.step()
            names = [s.name for s in t.op.scrapers]
            body = t.m.metrics.REGISTRY.exposition()
        finally:
            t.op.close()
        keep = tuple(f"karpenter_tpu_{g}" for g in (
            "nodes_allocatable", "nodes_total_pod_requests", "nodes_utilization",
            "pods_state", "provisioner_usage", "provisioner_limit"))
        bodies[pkg] = (names, sorted(line for line in body.splitlines()
                                     if line.startswith(keep)))
    assert bodies[PORT] == bodies[REF]
    assert bodies[PORT][1], "no scraper series"


# -- the operator phase's configuration ---------------------------------------


def operator_cluster(m, n_pods):
    """``configs.config_operator``'s cluster, built in package ``m``."""
    from karpenter_tpu_torch import configs

    cluster = m.state.Cluster()
    cluster.add_node_template(m.objects.NodeTemplate(
        meta=m.api.ObjectMeta(name=configs.OPERATOR_TEMPLATE), image_family="al2",
        subnet_selector={"karpenter.tpu/discovery": "cluster"},
        security_group_selector={"karpenter.tpu/discovery": "cluster"},
    ))
    cluster.add_provisioner(m.api.Provisioner(
        meta=m.api.ObjectMeta(name="default"),
        requirements=m.api.Requirements([m.api.Requirement.in_values(
            m.wk.CAPACITY_TYPE, [m.wk.CAPACITY_TYPE_SPOT, m.wk.CAPACITY_TYPE_ON_DEMAND])]),
        node_template_ref=configs.OPERATOR_TEMPLATE,
    ))
    per = n_pods // 30 + 1
    names = [(f"d{shape}-{i}", shape) for shape in range(30) for i in range(per)][:n_pods]
    for name, shape in names:
        cluster.add_pod(m.api.Pod(meta=m.api.ObjectMeta(name=name, owner_kind="ReplicaSet"),
                                  requests=m.api.Resources(configs._cell_requests(shape).to_dict())))
    return cluster


def operator_seed(pkg, n_pods=50_000, n_types=400):
    """``configs.config_operator_seed()`` built in package ``pkg``."""
    m = pkg_mod(pkg)
    cluster = operator_cluster(m, n_pods)
    provider = m.cloud.FakeCloudProvider(catalog=m.cloud.generate_catalog(n_types=n_types))
    m.pricing.PricingController(provider.pricing,
                                clock=m.cache.FakeClock(start=100_000.0)).reconcile()
    provs = [(p, provider.get_instance_types(p)) for p in cluster.provisioners.values()]
    return cluster.pending_pods(), provs, []


def test_config_operator_seed_is_the_operators_first_round(one_worker):
    """The seed problem ``chip_smoke.py`` pins is the one the operator's
    first step solves, and the JAX package encodes it alike; the operator
    phase's storm then re-binds every drained pod in the step that drained
    it. At 2,000 pods and 60 types."""
    from karpenter_tpu_torch import configs

    m = pkg_mod(PORT)
    digests = {pkg: m.solver.problem_digest(pkg_mod(pkg).encode.encode(
        *operator_seed(pkg, 2000, 60))).hex() for pkg in (PORT,)}
    ref = pkg_mod(REF)
    digests[REF] = ref.solver.problem_digest(ref.encode.encode(*operator_seed(REF, 2000, 60))).hex()
    assert digests[PORT] == digests[REF]
    assert digests[PORT] == m.solver.problem_digest(
        m.encode.encode(*configs.config_operator_seed(2000, 60))).hex()

    cluster, provider, settings, clock = configs.config_operator(2000, 60)
    provider.create_batched = None
    op = m.operator.Operator.new(provider, settings, cluster=cluster, clock=clock, device="cpu")
    seen = []
    solve_pods = op.provisioning.solver.solve_pods

    def recording(pods, provs, existing=(), daemonsets=(), **kw):
        result = solve_pods(pods, provs, existing=existing, daemonsets=daemonsets, **kw)
        full = m.encode.encode(kw["session"].ordered_pods(), provs, existing, daemonsets)
        seen.append(m.solver.problem_digest(full).hex())
        return result

    op.provisioning.solver.solve_pods = recording
    try:
        op.step()
        assert seen == [digests[PORT]] and not cluster.pending_pods()
        hold_fits(cluster)
        machines = list(cluster.machines.values())
        assert all(provider.instance_for(mc).launch_template for mc in machines)
        assert all(provider.instance_for(mc).image_id.startswith("img-al2-") for mc in machines)
        spot = sorted((n for n in cluster.nodes.values()
                       if n.meta.labels.get(m.wk.CAPACITY_TYPE) == m.wk.CAPACITY_TYPE_SPOT),
                      key=lambda n: n.name)
        assert spot
        targets = spot[: max(2, len(spot) // 10)]
        for n in targets:
            op.interruption.queue.send(spot_warning(iid(n)))
        while len(op.interruption.queue):
            before = set(cluster.nodes)
            op.step()
            clock.step(5)
            assert not cluster.pending_pods()
            hold_fits(cluster)
            for name in set(cluster.nodes) - before:
                node = cluster.nodes[name]
                assert not provider.unavailable_offerings.is_unavailable(
                    node.instance_type(), node.zone(), node.meta.labels[m.wk.CAPACITY_TYPE])
        gone = {iid(n) for n in targets}
        assert not gone & set(provider.instances)
    finally:
        op.close()


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
