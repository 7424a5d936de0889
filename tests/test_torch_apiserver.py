"""The port's cluster API server and HTTP cluster against the JAX package's.

``karpenter_tpu_torch/state/{apiserver,httpcluster}.py`` are copies of the
JAX package's modules. Here each runs against the other across the wire:

* ``TestServerProtocol`` and ``TestApiserverCells`` are the cases of
  ``tests/test_apiserver.py`` and ``tests/test_cells.py::TestApiserverCells``
  for three pairs of (client, server) packages: the port against itself,
  the port's ``HTTPCluster`` against the reference's ``ClusterAPIServer``,
  and the reference's ``HTTPCluster`` against the port's server;
* ``test_wire_answers_match_reference`` sends the same raw requests to both
  packages' servers (lists, watches, ``?cell=`` lists and streams, binds,
  409/404/400) and holds the answers equal, ids and timestamps masked;
* the verb and relist rules: POST is create (409 on an existing name), PUT
  is replace (404 on a missing name, MODIFIED in the watch log), a
  malformed body is a 400, and a relist emits one ``RESYNCED`` and no
  per-object ``DELETED``; each package answers alike;
* ``TestOperatorOverWire``: the port's operator on ``device="cpu"`` through
  the wire, against both packages' servers.

Every server listens on port 0.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import socket
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

PACKAGES = ("karpenter_tpu", "karpenter_tpu_torch")
REF, PORT = PACKAGES
#: (client package, server package)
PAIRS = [(PORT, PORT), (PORT, REF), (REF, PORT)]
PAIR_IDS = ["port-port", "port-client-ref-server", "ref-client-port-server"]


def pkg_mod(pkg: str) -> SimpleNamespace:
    imp = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
    return SimpleNamespace(
        pkg=pkg, api=imp("api"), wk=imp("api.labels"), objects=imp("api.objects"),
        admission=imp("api.admission"), codec=imp("api.codec"), settings=imp("api.settings"),
        state=imp("state"), apiserver=imp("state.apiserver"), cells=imp("state.cells"),
        httpcluster=imp("state.httpcluster"), cloud=imp("cloudprovider"),
        httpcloud=imp("cloudprovider.httpcloud"), iface=imp("cloudprovider.interface"),
        subnet=imp("cloudprovider.subnet"), operator=imp("operator"),
        cache=imp("utils.cache"), metrics=imp("utils.metrics"), faults=imp("utils.faults"),
        res=imp("utils.resilience"), tracing=imp("utils.tracing"),
    )


def make_pod(m, name, cpu="100m", memory="128Mi", node_selector=None, owner="ReplicaSet",
             daemonset=False, labels=None):
    return m.api.Pod(
        meta=m.api.ObjectMeta(name=name, labels=dict(labels or {}), owner_kind=owner),
        requests=m.api.Resources(cpu=cpu, memory=memory),
        node_selector=dict(node_selector or {}), is_daemonset=daemonset,
    )


def make_pods(m, n, prefix="pod", **kw):
    return [make_pod(m, f"{prefix}-{i}", **kw) for i in range(n)]


def make_provisioner(m, name="default", requirements=None, **kw):
    return m.api.Provisioner(meta=m.api.ObjectMeta(name=name),
                             requirements=m.api.Requirements(list(requirements or [])), **kw)


def prov_a(m):
    return make_provisioner(m, "cell-a", labels={"pool": "a"})


def prov_b(m):
    return make_provisioner(m, "cell-b", labels={"pool": "b"})


def pod_in(m, pool, name, **kw):
    return make_pod(m, name, node_selector={"pool": pool}, **kw)


def no_sleep_policy(m, **kw):
    kw.setdefault("max_attempts", 4)
    return m.res.RetryPolicy(sleep=lambda s: None, **kw)


def wait_for(predicate, timeout=8.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return False


def close_all(*clients):
    """Close HTTP clients together: each close waits out its watch
    thread's long poll (up to 5 s), so stop them all first."""
    for c in clients:
        c._stop.set()
    for c in clients:
        c.close()


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(params=PAIRS, ids=PAIR_IDS)
def wire(request):
    """A server of one package (``S``), a client of another (``C``); the
    client reads its own writes and does not watch."""
    C, S = pkg_mod(request.param[0]), pkg_mod(request.param[1])
    server = S.apiserver.ClusterAPIServer(latency_s=0.001).start()
    client = C.state.HTTPCluster(server.endpoint, watch=False)
    try:
        yield SimpleNamespace(C=C, S=S, server=server, client=client)
    finally:
        client.close()
        server.stop()


# -- tests/test_apiserver.py::TestServerProtocol, across packages -------------


class TestServerProtocol:
    def test_crud_and_list(self, wire):
        C, server, client = wire.C, wire.server, wire.client
        client.add_provisioner(make_provisioner(C))
        pod = client.add_pod(make_pod(C, "p1"))
        assert pod.meta.resource_version > 0
        c2 = C.state.HTTPCluster(server.endpoint, watch=False)
        assert [p.name for p in c2.pending_pods()] == ["p1"]
        assert "default" in c2.provisioners
        c2.close()
        assert client.delete_pod("p1") is not None
        assert client.delete_pod("p1") is None  # 404 -> None

    def test_watch_propagates_between_clients(self, wire):
        C, client = wire.C, wire.client
        c2 = C.state.HTTPCluster(wire.server.endpoint)
        try:
            client.add_pod(make_pod(C, "w1"))
            assert wait_for(lambda: "w1" in c2.pods)
            client.bind_pod("w1", "node-x")
            assert wait_for(lambda: c2.pods["w1"].node_name == "node-x")
            client.delete_pod("w1")
            assert wait_for(lambda: "w1" not in c2.pods)
        finally:
            c2.close()

    def test_watch_callbacks_fire_like_informers(self, wire):
        C, client = wire.C, wire.client
        events = []
        client.watch(lambda ev, obj: events.append((ev, type(obj).__name__)))
        client.add_pod(make_pod(C, "e1"))
        assert ("ADDED", "Pod") in events
        client.bind_pod("e1", "n")
        assert ("MODIFIED", "Pod") in events
        client.delete_pod("e1")
        assert ("DELETED", "Pod") in events

    def test_admission_rejection_is_http_422(self, wire):
        C, client = wire.C, wire.client
        bad = C.api.Provisioner(meta=C.api.ObjectMeta(name="bad"), consolidation_enabled=True,
                                ttl_seconds_after_empty=30)
        with pytest.raises(C.admission.AdmissionError) as err:
            client.add_provisioner(bad)
        assert "mutually exclusive" in str(err.value)
        assert "bad" not in client.provisioners and "bad" not in wire.server.backing.provisioners

    def test_admission_defaulting_applies_server_side(self, wire):
        C = wire.C
        prov = C.api.Provisioner(meta=C.api.ObjectMeta(name="d"),
                                 taints=[C.api.Taint(key="k", effect="", value="v")])
        assert wire.client.add_provisioner(prov).taints[0].effect == "NoSchedule"

    def test_update_round_trips_and_keeps_instance_live(self, wire):
        C, client = wire.C, wire.client
        client.add_provisioner(make_provisioner(C))
        pod = client.add_pod(make_pod(C, "u1"))
        pod.meta.annotations["x"] = "1"
        client.update(pod)
        assert client.pods["u1"] is pod
        c2 = C.state.HTTPCluster(wire.server.endpoint, watch=False)
        assert c2.pods["u1"].meta.annotations == {"x": "1"}
        c2.close()

    def test_watch_gone_triggers_relist_then_streams(self, wire):
        C, server, client = wire.C, wire.server, wire.client
        c2 = C.state.HTTPCluster(server.endpoint)
        try:
            with server._events_cv:
                server._events = []
                server._seq += 100
                server._log_floor = server._seq
            client.add_pod(make_pod(C, "g1"))
            assert wait_for(lambda: "g1" in c2.pods)
            client.add_pod(make_pod(C, "g2"))
            assert wait_for(lambda: "g2" in c2.pods)
        finally:
            c2.close()

    def test_delta_relist_skips_quiet_kinds(self, wire):
        C, S, client = wire.C, wire.S, wire.client
        client.add_pod(make_pod(C, "dr-1"))
        client.relist()
        events = []
        client.watch(lambda ev, obj: events.append(ev))
        client.relist()
        assert "RESYNCED" not in events
        wire.server.backing.add_pod(make_pod(S, "dr-2"))
        time.sleep(0.1)
        client.relist()
        assert "RESYNCED" in events and "dr-2" in client.pods

    def test_version_reports_kind_versions(self, wire):
        wire.client.add_pod(make_pod(wire.C, "kv-1"))
        kv = wire.client._call("GET", "/version").get("kindVersions")
        assert kv is not None and kv.get("pods", 0) >= 1

    def test_unknown_kind_and_method(self, wire):
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{wire.server.endpoint}/api/widgets", timeout=5)
        assert err.value.code == 404


# -- tests/test_cells.py::TestApiserverCells, across packages -----------------


def test_cell_index_classifies_and_moves():
    """The port's ``CellIndex`` (which the server's ``?cell=`` paths read)
    against the reference's, on the same events."""
    seen = {}
    for pkg in PACKAGES:
        m = pkg_mod(pkg)
        backing = m.state.Cluster()
        backing.add_provisioner(prov_a(m))
        backing.add_provisioner(prov_b(m))
        idx = m.cells.CellIndex(backing)
        pa, px = pod_in(m, "a", "ci-a"), make_pod(m, "ci-x")
        rows = [idx.event_cells("pods", pa), idx.event_cells("pods", px)]
        backing.add_pod(pa)
        backing.add_pod(px)
        idx.event_cells("pods", pa)
        idx.event_cells("pods", px)
        rows += [sorted(idx.members("pods", "cell-a")), sorted(idx.members("pods", "residue"))]
        rows.append(idx.event_cells("pods", pod_in(m, "b", "ci-a")))
        rows += [sorted(idx.members("pods", "cell-b")), sorted(idx.members("pods", "cell-a"))]
        rows.append(idx.event_cells("pods", make_pod(m, "ds", daemonset=True)))
        seen[pkg] = rows
    assert seen[PORT] == seen[REF]
    assert seen[PORT][0] == (("cell-a",), "cell-a") and seen[PORT][4] == (("cell-a", "cell-b"), "cell-b")


@pytest.fixture(params=PAIRS, ids=PAIR_IDS)
def cells_wire(request):
    C, S = pkg_mod(request.param[0]), pkg_mod(request.param[1])
    backing = S.state.Cluster()
    backing.add_provisioner(prov_a(S))
    backing.add_provisioner(prov_b(S))
    server = S.apiserver.ClusterAPIServer(backing).start()
    try:
        yield SimpleNamespace(C=C, S=S, backing=backing, server=server)
    finally:
        server.stop()


class TestApiserverCells:
    def test_indexed_list_and_watch_filtering(self, cells_wire):
        C, S, backing, srv = cells_wire.C, cells_wire.S, cells_wire.backing, cells_wire.server
        backing.add_pod(pod_in(S, "a", "al-a"))
        backing.add_pod(pod_in(S, "b", "al-b"))
        backing.add_pod(make_pod(S, "al-x"))
        ca = C.state.HTTPCluster(srv.endpoint, cell="cell-a", watch=False)
        cf = C.state.HTTPCluster(srv.endpoint, watch=False)
        try:
            assert sorted(ca.pods) == ["al-a"]
            assert sorted(ca.provisioners) == ["cell-a", "cell-b"]
            assert sorted(cf.pods) == ["al-a", "al-b", "al-x"]
        finally:
            ca.close()
            cf.close()

    def test_cell_watch_stream_delivers_own_cell_only(self, cells_wire):
        C, S, backing, srv = cells_wire.C, cells_wire.S, cells_wire.backing, cells_wire.server
        ca = C.state.HTTPCluster(srv.endpoint, cell="cell-a")
        cb = C.state.HTTPCluster(srv.endpoint, cell="cell-b")
        try:
            backing.add_pod(pod_in(S, "a", "wt-a"))
            backing.add_pod(pod_in(S, "b", "wt-b"))
            assert wait_for(lambda: "wt-a" in ca.pods and "wt-b" in cb.pods)
            time.sleep(0.5)
            assert "wt-b" not in ca.pods and "wt-a" not in cb.pods
            assert ca._bookmark >= cb._bookmark - 1
        finally:
            close_all(ca, cb)

    def test_moved_pod_reaches_both_streams(self, cells_wire):
        C, S, backing, srv = cells_wire.C, cells_wire.S, cells_wire.backing, cells_wire.server
        pod = pod_in(S, "a", "mv-0")
        backing.add_pod(pod)
        ca = C.state.HTTPCluster(srv.endpoint, cell="cell-a")
        cb = C.state.HTTPCluster(srv.endpoint, cell="cell-b")
        try:
            assert "mv-0" in ca.pods and "mv-0" not in cb.pods
            backing.update(dataclasses.replace(pod, node_selector={"pool": "b"}))
            assert wait_for(lambda: "mv-0" in cb.pods and "mv-0" not in ca.pods)
        finally:
            close_all(ca, cb)


# -- the wire, answer by answer ------------------------------------------------

MASKED = ("incarnation", "uid", "creationTimestamp")


def mask(obj):
    if isinstance(obj, dict):
        return {k: ("<masked>" if k in MASKED else mask(v)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [mask(v) for v in obj]
    return obj


def request(endpoint, method, path, body=None, raw=None):
    """One raw request: ``(status, decoded JSON body)``."""
    data = raw if raw is not None else (json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(f"{endpoint}{path}", data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def wire_script(m, endpoint):
    """The same requests, built from package ``m``'s objects."""
    w = m.codec.to_wire
    out = []

    def send(method, path, body=None, raw=None):
        out.append((method, path, *request(endpoint, method, path, body, raw)))

    send("POST", "/api/provisioners", w(prov_a(m)))
    send("POST", "/api/provisioners", w(prov_b(m)))
    send("POST", "/api/pods", w(pod_in(m, "a", "w-a")))
    send("POST", "/api/pods", w(pod_in(m, "b", "w-b")))
    send("POST", "/api/pods", w(make_pod(m, "w-x")))
    send("POST", "/api/pods", w(make_pod(m, "w-x", cpu="2")))  # 409: create only
    send("PUT", "/api/pods/w-missing", w(make_pod(m, "w-missing")))  # 404: replace only
    send("PUT", "/api/pods/w-x", w(make_pod(m, "w-other")))  # 400: name mismatch
    send("PUT", "/api/pods/w-x", w(make_pod(m, "w-x", cpu="2")))
    send("POST", "/api/pods", raw=b"{not json")  # 400: malformed body
    send("POST", "/api/pods/w-a/bind", {})  # 400: no nodeName
    send("POST", "/api/pods/w-missing/bind", {"nodeName": "n1"})  # 404
    send("POST", "/api/pods/w-a/bind", {"nodeName": "n1"})
    send("POST", "/api/provisioners", w(m.api.Provisioner(
        meta=m.api.ObjectMeta(name="bad"), consolidation_enabled=True,
        ttl_seconds_after_empty=30)))  # 422: admission
    send("GET", "/api/pods/w-a")
    send("GET", "/api/pods")
    send("GET", "/api/pods?cell=cell-a")
    send("GET", "/api/pods?cell=residue")
    send("GET", "/api/provisioners?cell=cell-b")
    send("GET", "/watch?since=0&timeout=0")
    send("GET", "/watch?since=0&timeout=0&cell=cell-a")
    send("GET", "/watch?since=0&timeout=0&limit=2")
    send("GET", "/watch?since=99999&timeout=0")  # ahead of the log: gone
    send("DELETE", "/api/pods/w-b")
    send("DELETE", "/api/pods/w-b")  # 404
    send("GET", "/watch?since=0&timeout=0&cell=cell-b")  # the delete reaches cell-b's stream
    send("GET", "/api/widgets")
    send("GET", "/nowhere")
    send("PUT", "/api/pods")  # 405 on the collection
    send("GET", "/version")
    return out


def test_wire_answers_match_reference():
    answers = {}
    for pkg in PACKAGES:
        m = pkg_mod(pkg)
        server = m.apiserver.ClusterAPIServer().start()
        try:
            answers[pkg] = mask(wire_script(m, server.endpoint))
        finally:
            server.stop()
    assert answers[PORT] == answers[REF]
    statuses = [status for _, _, status, _ in answers[PORT]]
    assert statuses[5:14] == [409, 404, 400, 200, 400, 400, 404, 200, 422]
    assert answers[PORT][5][3]["reason"] == "AlreadyExists"
    assert answers[PORT][22][3] == {"gone": True}


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_route_template_keys_both_ends_alike(pair):
    C, S = pkg_mod(pair[0]), pkg_mod(pair[1])
    for path in ("/api/pods", "/api/pods/my-pod-42", "/api/pods/my-pod-42/bind",
                 "/api/machines/m-1", "/watch?since=9&timeout=5", "/version", "/"):
        assert C.httpcluster.HTTPCluster._route(path) == S.apiserver.route_template(path)


# -- the verb and relist rules: each package answers alike ---------------------


def verbs_case(m):
    """POST over an existing name, PUT over a missing one, a PUT's watch
    event, and a malformed body."""
    backing = m.state.Cluster()
    server = m.apiserver.ClusterAPIServer(backing).start()
    try:
        w = m.codec.to_wire
        e = server.endpoint
        rows = [request(e, "POST", "/api/pods", w(make_pod(m, "v1")))[0]]
        status, body = request(e, "POST", "/api/pods", w(make_pod(m, "v1", cpu="3")))
        rows.append((status, body.get("reason")))
        rows.append(str(backing.pods["v1"].requests.to_dict()))  # not overwritten
        rows.append(request(e, "PUT", "/api/pods/v2", w(make_pod(m, "v2")))[0])
        rows.append("v2" in backing.pods)
        rows.append(request(e, "PUT", "/api/pods/v1", w(make_pod(m, "v1", cpu="2")))[0])
        log = request(e, "GET", "/watch?since=0&timeout=0")[1]["events"]
        rows.append([(ev["event"], ev["object"]["meta"]["name"]) for ev in log])
        rows.append(request(e, "POST", "/api/pods", raw=b"\xff{")[:2])
        rows.append(request(e, "PUT", "/api/pods/v1", raw=b"[1, 2")[:2])
        return rows
    finally:
        server.stop()


def test_verbs_answer_as_the_reference():
    rows = {pkg: verbs_case(pkg_mod(pkg)) for pkg in PACKAGES}
    assert rows[PORT] == rows[REF]
    assert rows[PORT][1] == (409, "AlreadyExists") and rows[PORT][3] == 404
    assert rows[PORT][4] is False and rows[PORT][5] == 200
    assert rows[PORT][6] == [("ADDED", "v1"), ("MODIFIED", "v1")]
    assert rows[PORT][7] == (400, {"error": "malformed JSON request body"})


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_relist_emits_one_resynced_and_no_deleted(pair):
    """A relist that drops objects the server deleted replaces the cache
    wholesale and tells watchers once (``RESYNCED``, obj None): no
    per-object DELETED events."""
    rows = {}
    for client_pkg, server_pkg in (pair, (REF, REF)):
        C, S = pkg_mod(client_pkg), pkg_mod(server_pkg)
        backing = S.state.Cluster()
        server = S.apiserver.ClusterAPIServer(backing).start()
        try:
            for i in range(3):
                backing.add_pod(make_pod(S, f"r-{i}"))
            client = C.state.HTTPCluster(server.endpoint, watch=False)
            events = []
            client.watch(lambda ev, obj: events.append((ev, getattr(obj, "name", None))))
            backing.delete_pod("r-1")
            backing.add_pod(make_pod(S, "r-3"))
            client.relist()
            rows[(client_pkg, server_pkg)] = (events, sorted(client.pods))
            client.close()
        finally:
            server.stop()
    got, want = rows[tuple(pair)], rows[(REF, REF)]
    assert got == want == ([("RESYNCED", None)], ["r-0", "r-2", "r-3"])


# -- tests/test_apiserver.py::TestOperatorOverWire, the port's operator ---------


def operator_over_wire(server_pkg):
    C, S = pkg_mod(PORT), pkg_mod(server_pkg)
    server = S.apiserver.ClusterAPIServer(latency_s=0.001).start()
    cluster = C.state.HTTPCluster(server.endpoint)
    settings = C.settings.Settings(batch_idle_duration=0, batch_max_duration=0,
                                   consolidation_validation_ttl=0, stabilization_window=0.0,
                                   interruption_queue_name="q")
    clock = C.cache.FakeClock(start=time.time())
    op = C.operator.Operator.new(
        provider=C.cloud.FakeCloudProvider(catalog=C.cloud.generate_catalog(n_types=30)),
        settings=settings, clock=clock, cluster=cluster, device="cpu")
    return C, server, cluster, op, clock


@pytest.mark.parametrize("server_pkg", PACKAGES, ids=["ref-server", "port-server"])
def test_full_lifecycle_through_the_wire(server_pkg):
    C, server, cluster, op, clock = operator_over_wire(server_pkg)
    try:
        cluster.add_provisioner(make_provisioner(C, consolidation_enabled=True))
        for p in make_pods(C, 8, cpu="500m"):
            cluster.add_pod(p)
        op.step()
        store = server.backing
        assert not cluster.pending_pods() and cluster.nodes
        assert len(store.nodes) == len(cluster.nodes) and not store.pending_pods()
        assert all(p.node_name is not None for p in store.pods.values())
        assert store.machines and all(m.status.registered and m.status.initialized
                                      for m in store.machines.values())
        for name in [p.name for p in list(cluster.pods.values())][:6]:
            cluster.delete_pod(name)
        n_before = len(cluster.nodes)
        for _ in range(8):
            op.step()
            clock.step(30)
        assert len(cluster.nodes) <= n_before and not cluster.pending_pods()
        assert len(store.nodes) == len(cluster.nodes)
        for node in list(cluster.nodes.values()):
            op.interruption.queue.send({
                "version": "0", "source": "cloud.compute",
                "detail-type": "Spot Instance Interruption Warning",
                "detail": {"instance-id": node.provider_id.rsplit("/", 1)[-1]},
            })
        op.step()
        op.step()
        assert not cluster.pending_pods()
        assert all(p.node_name is not None for p in store.pods.values())
    finally:
        op.close()
        cluster.close()
        server.stop()


@pytest.mark.parametrize("server_pkg", PACKAGES, ids=["ref-server", "port-server"])
def test_admission_rejection_reaches_operator_wiring(server_pkg):
    C, server, cluster, op, _ = operator_over_wire(server_pkg)
    try:
        with pytest.raises(C.admission.AdmissionError):
            cluster.add_provisioner(C.api.Provisioner(
                meta=C.api.ObjectMeta(name="w"),
                requirements=C.api.Requirements(
                    [C.api.Requirement.in_values(C.wk.PROVISIONER_NAME, ["x"])])))
    finally:
        op.close()
        cluster.close()
        server.stop()


# -- resilience over the apiserver wire (tests/test_resilience.py) ------------


def test_apiserver_call_retries_5xx():
    m = pkg_mod(PORT)
    srv = m.apiserver.ClusterAPIServer().start()
    try:
        hc = m.state.HTTPCluster(srv.endpoint, watch=False, retry_policy=no_sleep_policy(m))
        plan = m.faults.FaultPlan().fail("/api/pods", 2, status=503)
        hc._transport = m.faults.ScriptedTransport(plan, hc._http_transport)
        hc.add_pod(make_pod(m, "r-0"))
        assert plan.pending() == 0 and len(srv.backing.pods) == 1
        hc.close()
    finally:
        srv.stop()


def test_watch_survives_server_restart():
    """Kill the API server under a live watch: the watch thread warns once,
    reconnects on the policy's backoff and resyncs from a server restarted
    on the same port over the same store."""
    import logging

    m = pkg_mod(PORT)
    store = m.state.Cluster()
    srv = m.apiserver.ClusterAPIServer(backing=store).start()
    port = int(srv.endpoint.rsplit(":", 1)[-1])
    hc = m.state.HTTPCluster(srv.endpoint, retry_policy=no_sleep_policy(m, max_attempts=2),
                             timeout_s=2.0)
    records = []

    class Capture(logging.Handler):
        def emit(self, record):
            records.append(record)

    log = logging.getLogger("karpenter_tpu.httpcluster")
    handler, old_level = Capture(level=logging.DEBUG), log.level
    log.addHandler(handler)
    log.setLevel(logging.DEBUG)
    try:
        srv.stop()
        assert wait_for(lambda: sum("watch disconnected" in r.getMessage() for r in records) >= 3,
                        timeout=8)
        fails = [r for r in records if "watch disconnected" in r.getMessage()]
        assert sum(r.levelno == logging.WARNING for r in fails) == 1
        srv2 = m.apiserver.ClusterAPIServer(backing=store, port=port).start()
        try:
            store.add_pod(make_pod(m, "after-restart"))
            assert wait_for(lambda: "after-restart" in hc.pods, timeout=10)
        finally:
            srv2.stop()
    finally:
        log.removeHandler(handler)
        log.setLevel(old_level)
        hc.close()
