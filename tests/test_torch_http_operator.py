"""The operator over the wire on the CPU: the port's ``ClusterAPIServer``,
``HTTPCluster``, ``CloudHTTPService`` and ``HTTPCloudProvider`` under its
``Operator``, against the JAX package's.

* Twin operators over the wire: each package's API server, cloud service
  and operator (``HTTPCluster`` + ``HTTPCloudProvider``) on twin clusters,
  step by step, as ``tests/test_torch_operator.py`` runs them in process
  (the reference on ``TPUSolver(auto_mesh=False, quality_sync=True)``, the
  port on ``device="cpu"``, host paths without deadlines, one interruption
  worker). After each step a case records, from the server's store and the
  cloud's instances, the nodes as a multiset of (instance type, zone,
  capacity type, image, sorted pod names), the pending pods and the
  instance count, and what the step's controllers returned: the
  interruption messages handled, the round's bound and unschedulable pods,
  and the deprovisioning action. Launches over HTTP go one at a time in
  plan order (the HTTP provider has no batched create), so node names are
  the same in both packages. The records must be equal.
* The watch intake's backpressure (``tests/test_soak.py:221-260``).
* The state scrapers over an ``HTTPCluster`` (``tests/test_observability.py:278``).
* One trace across the operator, the API server and the cloud
  (``tests/test_decision_observability.py:667``).
* The HA pair (``tests/test_leader_ha.py``): the port's state tier and two
  leader-elected replicas of ``python -m karpenter_tpu_torch --device cpu``,
  on free ports.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from collections import Counter

import pytest

from test_torch_apiserver import free_port, no_sleep_policy, wait_for
from test_torch_apiserver import pkg_mod as wire_mod
from test_torch_controller import (  # noqa: F401  (fixtures)
    PACKAGES,
    _fresh_caches,
    _host_paths_run_dry,
    hold_fits,
)
from test_torch_deprovisioning import assert_same
from test_torch_operator import (  # noqa: F401  (fixtures)
    CLOCK_START,
    ROOT,
    SWEEP_BUDGET_S,
    Twin,
    _process_state,
    iid,
    make_pod,
    make_pods,
    new_operator,
    one_worker,
    pkg_mod,
    spot_warning,
)

REF, PORT = PACKAGES


class WireTwin:
    """One package's operator over the wire: its own API server over a
    store, its own cloud service, and ``Operator.new(provider=
    HTTPCloudProvider, cluster=HTTPCluster)``, with its controllers'
    answers recorded as ``Twin`` records them."""

    def __init__(self, pkg, provisioner_kw=None, n_types=40, **settings_kw):
        m = self.m = pkg_mod(pkg)
        w = self.w = wire_mod(pkg)
        settings_kw.setdefault("consolidation_timeout", SWEEP_BUDGET_S)
        settings_kw.setdefault("interruption_queue_name", "interruption-queue")
        self.settings = m.settings.Settings(
            batch_idle_duration=0, batch_max_duration=0, consolidation_validation_ttl=0,
            stabilization_window=0.0, **settings_kw,
        )
        self.clock = m.cache.FakeClock(start=CLOCK_START)
        self.store = m.state.Cluster()
        self.api = w.apiserver.ClusterAPIServer(backing=self.store).start()
        self.svc = w.httpcloud.CloudHTTPService(m.cloud.generate_catalog(n_types=n_types)).start()
        self.provider = w.httpcloud.HTTPCloudProvider(self.svc.endpoint)
        self.client = m.state.HTTPCluster(self.api.endpoint)
        self.op = new_operator(m, self.provider, self.settings, self.clock, cluster=self.client)
        self.client.add_provisioner(m.api.Provisioner(
            meta=m.api.ObjectMeta(name="default"), **(provisioner_kw or {})))
        self.log = []
        Twin._instrument(self)

    @property
    def cluster(self):
        return self.op.cluster

    def add(self, pods):
        for p in pods:
            self.client.add_pod(p)

    def step(self, n=1):
        for _ in range(n):
            self.op.step()
            hold_fits(self.store)
            self.log.append(("state", self.state()))

    def state(self):
        wk, store = self.m.wk, self.store
        instances = dict(self.svc.instances)
        nodes = Counter()
        for node in store.nodes.values():
            lab = node.meta.labels
            inst = instances.get(node.provider_id.rsplit("/", 1)[-1]) if node.provider_id else None
            nodes[(lab.get(wk.INSTANCE_TYPE), lab.get(wk.ZONE), lab.get(wk.CAPACITY_TYPE),
                   inst.image_id if inst else None,
                   tuple(sorted(p.name for p in store.pods_on_node(node.name))))] += 1
        audit = self.svc.launch_audit()
        assert not audit["duplicate_tokens"] and not audit["untokened"]
        return dict(nodes=sorted(nodes.items()),
                    pending=sorted(p.name for p in store.pending_pods()),
                    cache_pending=sorted(p.name for p in self.cluster.pending_pods()),
                    instances=len(instances), machines=len(store.machines))

    def interrupt(self, nodes):
        for node in nodes:
            self.op.interruption.queue.send(spot_warning(iid(node)))

    def close(self):
        self.op.close()
        self.client.close()
        self.api.stop()
        self.svc.stop()


def run_wire_twins(case):
    logs = {}
    for pkg in PACKAGES:
        twin = case(pkg)
        try:
            logs[pkg] = list(twin.log)
        finally:
            twin.close()
    assert_same(logs[PORT], logs[REF], case.__name__)
    return logs[PORT]


def case_provision_interrupt_reprovision(pkg):
    t = WireTwin(pkg)
    t.add(make_pods(t.m, 8, cpu="500m"))
    t.step()
    assert not t.store.pending_pods() and t.store.nodes
    t.interrupt(sorted(t.store.nodes.values(), key=lambda n: n.name))
    t.step(2)
    assert not t.store.pending_pods()
    assert all(p.node_name is not None for p in t.store.pods.values())
    assert t.provider.unavailable_offerings.seqnum > 0
    return t


def case_scale_to_zero(pkg):
    t = WireTwin(pkg, provisioner_kw=dict(ttl_seconds_after_empty=30),
                 interruption_queue_name=None)
    t.add(make_pods(t.m, 5, cpu="500m"))
    t.step()
    assert t.store.nodes
    for p in list(t.store.pods.values()):
        t.client.delete_pod(p.name)
    t.step()
    t.clock.step(31)
    t.step()
    assert not t.store.nodes and not t.svc.instances
    return t


def case_consolidation(pkg):
    t = WireTwin(pkg, provisioner_kw=dict(consolidation_enabled=True),
                 interruption_queue_name=None)
    t.add(make_pods(t.m, 12, cpu="1", memory="1Gi"))
    t.step()
    n_before = len(t.store.nodes)
    for name in sorted(t.store.pods)[:8]:
        t.client.delete_pod(name)
    for _ in range(5):
        t.step()
        t.clock.step(30)
    assert len(t.store.nodes) <= n_before and not t.store.pending_pods()
    return t


def case_spot_and_on_demand_mix(pkg):
    m = pkg_mod(pkg)
    t = WireTwin(pkg, provisioner_kw=dict(requirements=m.api.Requirements([
        m.api.Requirement.in_values(m.wk.CAPACITY_TYPE,
                                    [m.wk.CAPACITY_TYPE_SPOT, m.wk.CAPACITY_TYPE_ON_DEMAND])])))
    t.add(make_pods(m, 30, prefix="a", cpu="1", memory="2Gi"))
    t.add(make_pods(m, 20, prefix="b", cpu="250m", memory="512Mi"))
    t.step()
    t.interrupt(sorted(t.store.nodes.values(), key=lambda n: n.name)[:2])
    t.step(2)
    assert not t.store.pending_pods()
    return t


WIRE_CASES = [
    case_provision_interrupt_reprovision,
    case_scale_to_zero,
    case_consolidation,
    case_spot_and_on_demand_mix,
]


@pytest.mark.parametrize("case", WIRE_CASES, ids=lambda c: c.__name__[len("case_"):])
def test_operators_over_the_wire_match_reference(case, one_worker):
    log = run_wire_twins(case)
    assert any(kind == "provisioning" for kind, *_ in log)


# -- the watch intake's backpressure (tests/test_soak.py:221-260) --------------


def test_widen_coalesces_to_newest_per_object():
    deltas = {}
    for pkg in PACKAGES:
        w = wire_mod(pkg)
        api = w.apiserver.ClusterAPIServer().start()
        try:
            client = w.state.HTTPCluster(api.endpoint, watch=False, queue_capacity=64)
            client._widened = True
            base = w.metrics.BACKPRESSURE_EVENTS.value({"action": "widen"})
            pod = w.api.Pod(meta=w.api.ObjectMeta(name="w-1"),
                            requests=w.api.Resources(cpu="100m", memory="64Mi"))
            wires = []
            for v in (5, 6, 7):
                pod.meta.resource_version = v
                wires.append({"resourceVersion": v, "event": "MODIFIED", "kind": "pods",
                              "object": w.codec.to_wire(pod)})
            client._apply_events(wires)
            deltas[pkg] = (w.metrics.BACKPRESSURE_EVENTS.value({"action": "widen"}) - base,
                           client.pods["w-1"].meta.resource_version)
            client.close()
        finally:
            api.stop()
    assert deltas[PORT] == deltas[REF] == (2, 7)


def test_overflow_sheds_and_relists():
    w = wire_mod(PORT)
    api = w.apiserver.ClusterAPIServer().start()
    writer = w.state.HTTPCluster(api.endpoint, watch=False)
    client = w.state.HTTPCluster(api.endpoint, queue_capacity=8)
    try:
        base = w.metrics.BACKPRESSURE_EVENTS.value({"action": "shed"})
        with client.quiesce():
            for i in range(40):
                writer.add_pod(w.api.Pod(meta=w.api.ObjectMeta(name=f"shed-{i}"),
                                         requests=w.api.Resources(cpu="50m", memory="32Mi")))
            assert wait_for(lambda: w.metrics.BACKPRESSURE_EVENTS.value({"action": "shed"}) > base,
                            timeout=20), "intake overflow never shed"
        assert wait_for(lambda: len(client.pods) == 40, timeout=20)
    finally:
        client.close()
        writer.close()
        api.stop()


def test_quiesce_holds_remote_events_until_release():
    w = wire_mod(PORT)
    api = w.apiserver.ClusterAPIServer().start()
    writer = w.state.HTTPCluster(api.endpoint, watch=False)
    client = w.state.HTTPCluster(api.endpoint)
    try:
        with client.quiesce():
            writer.add_pod(w.api.Pod(meta=w.api.ObjectMeta(name="q-1"),
                                     requests=w.api.Resources(cpu="50m", memory="32Mi")))
            time.sleep(1.0)
            assert "q-1" not in client.pods
        assert wait_for(lambda: "q-1" in client.pods)
    finally:
        client.close()
        writer.close()
        api.stop()


# -- the state scrapers over the wire (tests/test_observability.py:278) --------


def seed_cluster(m, cluster):
    """``tests/test_observability.py``'s ``_seed_cluster``."""
    wk = m.wk
    prov = m.api.Provisioner(meta=m.api.ObjectMeta(name="default"))
    prov.limits = m.api.Resources(cpu=64)
    cluster.add_provisioner(prov)
    node = m.api.Node(
        meta=m.api.ObjectMeta(name="obs-node-1", labels={
            wk.PROVISIONER_NAME: "default", wk.ZONE: "zone-a",
            wk.INSTANCE_TYPE: "tpu-std-4", wk.CAPACITY_TYPE: "spot"}),
        capacity=m.api.Resources(cpu=4, memory="16Gi", pods=32),
        allocatable=m.api.Resources(cpu=4, memory="15Gi", pods=32), ready=True,
    )
    cluster.add_node(node)
    cluster.add_pod(make_pod(m, "obs-bound", cpu="1", memory="2Gi"))
    cluster.bind_pod("obs-bound", node.name)
    cluster.add_pod(make_pod(m, "obs-pending", cpu="1"))


def test_scrapers_over_http_cluster_match_reference():
    """The scrapers read ``HTTPCluster``'s informer cache as they read an
    in-process store: the same series in both packages, with the values
    ``tests/test_observability.py`` asserts."""
    keep = tuple(f"karpenter_tpu_{g}" for g in (
        "nodes_allocatable", "nodes_total_pod_requests", "nodes_utilization",
        "pods_state", "provisioner_usage", "provisioner_limit"))
    bodies = {}
    for pkg in PACKAGES:
        m, w = pkg_mod(pkg), wire_mod(pkg)
        server = w.apiserver.ClusterAPIServer().start()
        client = w.state.HTTPCluster(server.endpoint, watch=False)
        try:
            seed_cluster(m, client)
            for s in m.scrapers.build_scrapers(client):
                s.scrape()
            bodies[pkg] = sorted(line for line in m.metrics.REGISTRY.exposition().splitlines()
                                 if line.startswith(keep) and 'node_name="obs-node-1"' in line)
        finally:
            client.close()
            server.stop()
    assert bodies[PORT] == bodies[REF]
    values = {(line.split("{")[0], 'resource_type="cpu"' in line): line.rsplit(" ", 1)[1]
              for line in bodies[PORT]}
    assert values[("karpenter_tpu_nodes_utilization", True)] == "0.25"
    assert values[("karpenter_tpu_nodes_total_pod_requests", True)] == "1"
    assert values[("karpenter_tpu_nodes_allocatable", True)] == "4"


# -- one trace across three tiers (tests/test_decision_observability.py:667) ---


def trace_env(fault_plan=None):
    import importlib

    from karpenter_tpu_torch.solver import TorchSolver

    w = wire_mod(PORT)
    prov_mod = importlib.import_module(f"{PORT}.controllers.provisioning")
    store = w.state.Cluster()
    api = w.apiserver.ClusterAPIServer(backing=store).start()
    svc = w.httpcloud.CloudHTTPService(w.cloud.generate_catalog(n_types=20),
                                       fault_plan=fault_plan).start()
    cluster = w.state.HTTPCluster(api.endpoint, watch=False, retry_policy=no_sleep_policy(w))
    provider = w.httpcloud.HTTPCloudProvider(svc.endpoint, retry_policy=no_sleep_policy(w))
    controller = prov_mod.ProvisioningController(
        cluster, provider, settings=w.settings.Settings(batch_idle_duration=0, batch_max_duration=0),
        solver=TorchSolver(device="cpu"))
    cluster.add_provisioner(w.api.Provisioner(meta=w.api.ObjectMeta(name="default")))
    return w, api, svc, cluster, controller


def reconcile_trace(controller):
    import importlib

    kit = importlib.import_module(f"{PORT}.controllers.kit")
    TRACER = importlib.import_module(f"{PORT}.utils.tracing").TRACER
    loop = kit.SingletonController("provisioning", controller.reconcile)
    assert loop.run_if_due() and loop.consecutive_errors == 0
    root = TRACER.last_trace("reconcile.provisioning")
    assert root is not None
    return TRACER, root, root.trace_id, root.attrs["reconcile_id"]


def test_single_trace_spans_client_apiserver_and_cloud():
    from karpenter_tpu_torch.utils.httpserver import OperatorHTTPServer

    w, api, svc, cluster, controller = trace_env()
    try:
        for p in make_pods(w, 4, prefix="e2e", cpu="500m", memory="1Gi"):
            cluster.add_pod(p)
        TRACER, root, trace_id, reconcile_id = reconcile_trace(controller)
        joined = TRACER.export(trace_id=trace_id)
        names = [t["name"] for t in joined]
        api_spans = [t for t in joined if t["name"].startswith("apiserver.")]
        cloud_spans = [t for t in joined if t["name"].startswith("cloud.")]
        assert "reconcile.provisioning" in names and api_spans and cloud_spans, names
        assert all(t["attrs"]["reconcile_id"] == reconcile_id for t in api_spans + cloud_spans)
        flat = root.flat()
        assert any("cloud.client./v1/run-instances" in k for k in flat)
        assert any("apiserver.client" in k for k in flat)
        server = OperatorHTTPServer(port=0).start()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{server.port}/debug/decisions?pod=e2e-0") as r:
                out = json.loads(r.read())
        finally:
            server.stop()
        rec = [d for d in out["decisions"] if d["kind"] == "placement"][0]
        assert rec["outcome"] == "new-node" and rec["trace_id"] == trace_id
        assert rec["reconcile_id"] == reconcile_id
        assert len(rec["details"]["rejected_alternatives"]) >= 1
    finally:
        cluster.close()
        api.stop()
        svc.stop()


def test_trace_survives_retried_faulted_call():
    w = wire_mod(PORT)
    plan = w.faults.FaultPlan().fail("/v1/run-instances", 2, status=503)
    w, api, svc, cluster, controller = trace_env(fault_plan=plan)
    try:
        for p in make_pods(w, 3, prefix="flt", cpu="500m", memory="1Gi"):
            cluster.add_pod(p)
        TRACER, root, trace_id, reconcile_id = reconcile_trace(controller)
        assert plan.pending() == 0

        def find(span, name):
            return ([span] if span.name == name else []) + [
                s for c in span.children for s in find(c, name)]

        launches = find(root, "cloud.client./v1/run-instances")
        assert launches and sum(e["name"] == "rpc.retry" for s in launches for e in s.events) == 2
        cloud = [t for t in TRACER.export(trace_id=trace_id) if t["name"].startswith("cloud.")]
        assert any(t["name"] == "cloud.POST /v1/run-instances" for t in cloud)
        assert all(t["attrs"]["reconcile_id"] == reconcile_id for t in cloud)
        assert len([p for p in cluster.pods.values() if p.node_name]) == 3
    finally:
        cluster.close()
        api.stop()
        svc.stop()


# -- the HA pair (tests/test_leader_ha.py) --------------------------------------


def http_status(url):
    try:
        with urllib.request.urlopen(url, timeout=2.0) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code
    except Exception:
        return None


def test_two_replicas_one_leader_failover(tmp_path):
    """The port's state tier in a subprocess and two leader-elected
    replicas of ``python -m karpenter_tpu_torch --device cpu``: exactly one
    leads and binds, the standby takes over after the leader's SIGKILL and
    binds the next pods, no pod is bound twice, and the survivor exits 0 on
    SIGTERM."""
    w = wire_mod(PORT)
    env = dict(os.environ, PYTHONPATH=ROOT)
    api_port = free_port()
    procs, logs = [], []

    def spawn(args, log):
        logs.append(open(log, "w"))
        procs.append(subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT, env=env,
                                      stdout=logs[-1], stderr=subprocess.STDOUT))
        return procs[-1]

    cloud = w.httpcloud.CloudHTTPService(w.cloud.generate_catalog(n_types=20)).start()
    client = None
    try:
        spawn(["karpenter_tpu_torch.state.apiserver", "--port", str(api_port)],
              tmp_path / "apiserver.log")
        api = f"http://127.0.0.1:{api_port}"
        assert wait_for(lambda: http_status(f"{api}/version") == 200, timeout=60)
        client = w.state.HTTPCluster(api)
        client.add_provisioner(w.api.Provisioner(meta=w.api.ObjectMeta(name="default")))
        ports = (free_port(), free_port())
        replicas = [spawn(["karpenter_tpu_torch", "--device", "cpu", "--leader-elect",
                           "--leader-elect-lease", str(tmp_path / "lease"),
                           "--leader-lease-duration", "3", "--leader-renew-interval", "0.5",
                           "--cluster-endpoint", api, "--cloud-endpoint", cloud.endpoint,
                           "--metrics-port", str(p), "--metrics-bind", "127.0.0.1",
                           "--batch-idle-duration", "0", "--batch-max-duration", "0",
                           "--tick", "0.1"], tmp_path / f"replica-{p}.log") for p in ports]

        def leading():
            return [http_status(f"http://127.0.0.1:{p}/leaderz") == 200 for p in ports]

        assert wait_for(lambda: all(http_status(f"http://127.0.0.1:{p}/healthz") == 200
                                    for p in ports), timeout=90), "replicas never came up"
        assert wait_for(lambda: sum(leading()) == 1, timeout=30), leading()
        for _ in range(10):
            assert sum(leading()) <= 1
            time.sleep(0.1)
        leader = leading().index(True)
        for i in range(3):
            client.add_pod(make_pod(w, f"a-{i}", cpu="250m", memory="512Mi"))
        assert wait_for(lambda: len(client.pods) == 3 and all(
            p.node_name for p in client.pods.values()), timeout=60)
        replicas[leader].kill()
        replicas[leader].wait(timeout=10)
        standby = 1 - leader
        assert wait_for(lambda: http_status(f"http://127.0.0.1:{ports[standby]}/leaderz") == 200,
                        timeout=20), "standby never took leadership"
        assert http_status(f"http://127.0.0.1:{ports[standby]}/readyz") == 200
        for i in range(2):
            client.add_pod(make_pod(w, f"b-{i}", cpu="250m", memory="512Mi"))
        assert wait_for(lambda: len(client.pods) == 5 and all(
            p.node_name for p in client.pods.values()), timeout=60), "new leader never bound"
        with urllib.request.urlopen(f"{api}/watch?since=0&timeout=0", timeout=5) as r:
            events = json.loads(r.read())["events"]
        nodes_of = {}
        for ev in events:
            if ev["kind"] == "pods" and ev["object"].get("nodeName"):
                nodes_of.setdefault(ev["object"]["meta"]["name"], set()).add(
                    ev["object"]["nodeName"])
        assert len(nodes_of) == 5 and all(len(v) == 1 for v in nodes_of.values())
        assert not cloud.launch_audit()["duplicate_tokens"]
        replicas[standby].send_signal(signal.SIGTERM)
        assert replicas[standby].wait(timeout=30) == 0
    finally:
        if client is not None:
            client.close()
        for proc in procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for proc in procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        for f in logs:
            f.close()
        cloud.stop()


# -- the http_tier phase's configuration ----------------------------------------


def http_seed(pkg, n_pods=10_000, n_types=400):
    """``configs.config_http_seed()`` built in package ``pkg``: the
    operator cluster's pending pods and an ``HTTPCloudProvider``'s instance
    types from that package's ``CloudHTTPService``."""
    from test_torch_operator import operator_cluster

    m, w = pkg_mod(pkg), wire_mod(pkg)
    cluster = operator_cluster(m, n_pods)
    svc = w.httpcloud.CloudHTTPService(m.cloud.generate_catalog(n_types=n_types)).start()
    try:
        provider = w.httpcloud.HTTPCloudProvider(svc.endpoint)
        provs = [(p, provider.get_instance_types(p)) for p in cluster.provisioners.values()]
    finally:
        svc.stop()
    return cluster.pending_pods(), provs, []


def test_config_http_seed_is_the_first_round_over_the_wire(one_worker):
    """The seed problem ``chip_smoke.py``'s http_tier phase pins is the one
    the port's operator over the wire solves first, the JAX package's own
    HTTP tier gives the same problem, and it is not the in-process seed (the
    HTTP cloud serves no price refresh). Then every pod of the server's
    store is bound and the cloud's instances are its machines. At 2,000
    pods and 60 types."""
    from karpenter_tpu_torch import configs

    m, ref = pkg_mod(PORT), pkg_mod(REF)
    digest = m.solver.problem_digest(m.encode.encode(*configs.config_http_seed(2000, 60))).hex()
    assert digest == ref.solver.problem_digest(ref.encode.encode(*http_seed(REF, 2000, 60))).hex()
    assert digest != m.solver.problem_digest(
        m.encode.encode(*configs.config_operator_seed(2000, 60))).hex()
    store, svc, settings, clock = configs.config_http_tier(2000, 60)
    w = wire_mod(PORT)
    svc.start()
    api = w.apiserver.ClusterAPIServer(backing=store).start()
    cluster = w.state.HTTPCluster(api.endpoint, queue_capacity=settings.watch_queue_capacity)
    op = m.operator.Operator.new(provider=w.httpcloud.HTTPCloudProvider(svc.endpoint),
                                 settings=settings, cluster=cluster, clock=clock, device="cpu")
    seen = []
    solve_pods = op.provisioning.solver.solve_pods

    def recording(pods, provs, existing=(), daemonsets=(), **kw):
        result = solve_pods(pods, provs, existing=existing, daemonsets=daemonsets, **kw)
        full = m.encode.encode(kw["session"].ordered_pods(), provs, existing, daemonsets)
        seen.append(m.solver.problem_digest(full).hex())
        return result

    op.provisioning.solver.solve_pods = recording
    try:
        assert op.pricing is None and op.costledger is None
        assert isinstance(op.interruption.queue, w.httpcloud.HTTPQueue)
        op.step()
        assert seen == [digest] and not store.pending_pods()
        hold_fits(store)
        assert set(svc.instances) == {mc.status.provider_id.rsplit("/", 1)[-1]
                                      for mc in store.machines.values()}
        assert op.provisioning.encode_session.last_mode == "full"
    finally:
        op.close()
        cluster.close()
        api.stop()
        svc.stop()
