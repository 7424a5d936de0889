"""The port's HTTP cloud (``karpenter_tpu_torch/cloudprovider/httpcloud.py``)
against the JAX package's.

* ``TestConformance``, ``TestHTTPSpecifics`` and ``TestDiscoveryConformance``
  are the ``[http]`` cases of ``tests/test_provider_conformance.py`` for
  three pairs of (client, server) packages: the port's
  ``HTTPCloudProvider`` against its own ``CloudHTTPService`` and against the
  reference's, and the reference's provider against the port's service.
* ``test_clouds_side_by_side``: each package's provider against its own
  service on one catalog gives the same instance types (names, offerings,
  prices) and the same launches for the same machines.
* The HTTP cases of ``tests/test_resilience.py`` (``:253-450``, ``:566``)
  on the port: retries, the breaker, idempotent ``run_instances`` (and the
  503 of a launch still in flight), the service's own fault plan, and a
  provisioning round that survives transient 5xx.
* The port's own: a catalog refresh that fails serves the last catalog
  (the reference's raises).

Every service listens on port 0.
"""

from __future__ import annotations

import threading
import time

import pytest

from test_torch_apiserver import PACKAGES, PAIR_IDS, PAIRS, PORT, REF, make_pods, pkg_mod


def machine(m, name="m-0", cpu="500m", reqs=()):
    return m.api.Machine(meta=m.api.ObjectMeta(name=name), provisioner_name="default",
                         requirements=m.api.Requirements(list(reqs)),
                         requests=m.api.Resources(cpu=cpu))


def labels(m, mc):
    wk = m.wk
    return (mc.meta.labels[wk.INSTANCE_TYPE], mc.meta.labels[wk.ZONE],
            mc.meta.labels[wk.CAPACITY_TYPE])


def no_sleep_policy(m, **kw):
    kw.setdefault("max_attempts", 4)
    return m.res.RetryPolicy(sleep=lambda s: None, **kw)


@pytest.fixture(scope="module")
def services():
    """One long-lived service per package over its own 30-type catalog."""
    out = {}
    for pkg in PACKAGES:
        m = pkg_mod(pkg)
        out[pkg] = m.httpcloud.CloudHTTPService(m.cloud.generate_catalog(n_types=30),
                                                latency_s=0.001).start()
    yield out
    for svc in out.values():
        svc.stop()


def reset(S, svc):
    svc.instances.clear()
    svc.insufficient_capacity_pools.clear()
    svc.current_images["default"] = "image-001"
    svc._history = [(0.0, {})]
    svc.subnet_provider = S.subnet.SubnetProvider(svc.subnets)


@pytest.fixture(params=PAIRS, ids=PAIR_IDS)
def cloud(request, services):
    C, S = pkg_mod(request.param[0]), pkg_mod(request.param[1])
    svc = services[S.pkg]
    reset(S, svc)
    return C, S, svc, C.httpcloud.HTTPCloudProvider(svc.endpoint)


# -- tests/test_provider_conformance.py, the [http] cases ---------------------


class TestConformance:
    def test_create_fills_status_and_labels(self, cloud):
        C, _, _, provider = cloud
        mc = provider.create(machine(C))
        assert mc.status.launched and mc.status.provider_id.startswith("http:///")
        assert all(labels(C, mc)) and mc.meta.labels[C.wk.PROVISIONER_NAME] == "default"
        assert 0 < mc.status.allocatable["cpu"] <= mc.status.capacity["cpu"]

    def test_launches_cheapest_compatible_offering(self, cloud):
        C, _, svc, provider = cloud
        it_name, zone, ct = labels(C, provider.create(machine(C, cpu="500m")))
        price = {(it.name, o.zone, o.capacity_type): o.price
                 for it in svc.catalog for o in it.offerings}
        cheapest = min(o.price for it in svc.catalog
                       if C.api.Resources(cpu="500m").fits(
                           next(i for i in provider._catalog() if i.name == it.name).allocatable())
                       for o in it.offerings if o.available)
        assert price[(it_name, zone, ct)] == pytest.approx(cheapest, rel=1e-6)

    def test_capacity_type_pinning(self, cloud):
        C, _, _, provider = cloud
        wk = C.wk
        mc = provider.create(machine(C, reqs=[C.api.Requirement.in_values(
            wk.CAPACITY_TYPE, [wk.CAPACITY_TYPE_ON_DEMAND])]))
        assert mc.meta.labels[wk.CAPACITY_TYPE] == wk.CAPACITY_TYPE_ON_DEMAND
        assert provider.create(machine(C, "m-1")).meta.labels[wk.CAPACITY_TYPE] == \
            wk.CAPACITY_TYPE_SPOT

    def test_zone_pinning(self, cloud):
        C, _, _, provider = cloud
        mc = provider.create(machine(C, reqs=[C.api.Requirement.in_values(C.wk.ZONE, ["zone-b"])]))
        assert mc.meta.labels[C.wk.ZONE] == "zone-b"

    def test_ice_fallback_lands_elsewhere_and_masks(self, cloud):
        C, _, _, provider = cloud
        key = labels(C, provider.create(machine(C)))
        provider.set_insufficient_capacity(*key)
        assert labels(C, provider.create(machine(C, "m-1"))) != key
        for it in provider.get_instance_types(C.api.Provisioner(meta=C.api.ObjectMeta(name="default"))):
            if it.name == key[0]:
                assert not any(o.available and o.zone == key[1] and o.capacity_type == key[2]
                               for o in it.offerings)

    def test_exhaustion_raises_ice_with_offerings(self, cloud):
        C, _, _, provider = cloud
        wk = C.wk
        reqs = [C.api.Requirement.in_values(wk.ZONE, ["zone-a"]),
                C.api.Requirement.in_values(wk.CAPACITY_TYPE, [wk.CAPACITY_TYPE_ON_DEMAND])]
        compatible = {labels(C, provider.create(machine(C, "probe", cpu="15", reqs=reqs)))[0]}
        for it in provider.get_instance_types(C.api.Provisioner(meta=C.api.ObjectMeta(name="default"))):
            if C.api.Resources(cpu="15").fits(it.allocatable()):
                compatible.add(it.name)
        for name in compatible:
            provider.set_insufficient_capacity(name, "zone-a", wk.CAPACITY_TYPE_ON_DEMAND)
        with pytest.raises(C.iface.InsufficientCapacityError) as ei:
            provider.create(machine(C, "m-1", cpu="15", reqs=reqs))
        assert isinstance(ei.value.offerings, list)

    def test_get_list_delete_roundtrip(self, cloud):
        C, _, _, provider = cloud
        mc = provider.create(machine(C))
        got = provider.get(mc.status.provider_id)
        assert got.status.provider_id == mc.status.provider_id and labels(C, got) == labels(C, mc)
        assert len(provider.list()) == 1
        provider.delete(mc)
        assert provider.list() == []
        with pytest.raises(C.iface.MachineNotFoundError):
            provider.delete(mc)
        with pytest.raises(C.iface.MachineNotFoundError):
            provider.get(mc.status.provider_id)

    def test_delete_many_partial_results(self, cloud):
        C, _, _, provider = cloud
        a, b = provider.create(machine(C, "a")), provider.create(machine(C, "b"))
        provider.delete(a)
        results = provider.delete_many([a, b])
        assert isinstance(results[0], C.iface.MachineNotFoundError) and results[1] is None
        assert provider.list() == []

    def test_image_drift_detected(self, cloud):
        C, _, _, provider = cloud
        mc = provider.create(machine(C))
        assert provider.is_machine_drifted(mc) is False
        provider.rotate_image("default", "image-002")
        assert provider.is_machine_drifted(mc) is True

    def test_batched_terminate_coalesces(self, cloud):
        C, _, svc, provider = cloud
        machines = [provider.create(machine(C, f"m-{i}")) for i in range(8)]
        before = svc.request_log.count("/v1/terminate")
        threads = [threading.Thread(target=provider.delete_batched, args=(mc,)) for mc in machines]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert svc.request_log.count("/v1/terminate") == before + 1
        assert provider.list() == []

    def test_batched_describe_coalesces(self, cloud):
        C, _, svc, provider = cloud
        machines = [provider.create(machine(C, f"m-{i}")) for i in range(6)]
        before = svc.request_log.count("/v1/describe")
        out = [None] * len(machines)

        def fetch(i):
            out[i] = provider.get_batched(machines[i].status.provider_id)

        threads = [threading.Thread(target=fetch, args=(i,)) for i in range(len(machines))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert svc.request_log.count("/v1/describe") == before + 1
        assert all(o is not None and not isinstance(o, Exception) for o in out)

    def test_provisioner_requirements_filter_types(self, cloud):
        C, _, _, provider = cloud
        prov = C.api.Provisioner(meta=C.api.ObjectMeta(name="pinned"), requirements=C.api.Requirements(
            [C.api.Requirement.in_values(C.wk.INSTANCE_CATEGORY, ["c"])]))
        types = provider.get_instance_types(prov)
        assert types and all(it.requirements.labels()[C.wk.INSTANCE_CATEGORY] == "c" for it in types)


class TestHTTPSpecifics:
    def test_fresh_client_lists_preexisting_instances(self, cloud):
        C, _, svc, seeder = cloud
        mc = seeder.create(machine(C))
        fresh = C.httpcloud.HTTPCloudProvider(svc.endpoint)
        assert [x.status.provider_id for x in fresh.list()] == [mc.status.provider_id]
        assert fresh.get(mc.status.provider_id).meta.creation_timestamp > 0
        seeder.delete(mc)

    def test_one_wire_call_per_launch_with_server_side_fallback(self, cloud):
        C, _, svc, provider = cloud
        key = labels(C, provider.create(machine(C)))
        provider.set_insufficient_capacity(*key)
        before = svc.request_log.count("/v1/run-instances")
        second = provider.create(machine(C, "m-1"))
        assert svc.request_log.count("/v1/run-instances") == before + 1
        assert labels(C, second) != key and provider.unavailable_offerings.is_unavailable(*key)


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_eventual_consistency_window(pair):
    C, S = pkg_mod(pair[0]), pkg_mod(pair[1])
    svc = S.httpcloud.CloudHTTPService(S.cloud.generate_catalog(n_types=10),
                                       consistency_lag_s=1.0).start()
    try:
        p = C.httpcloud.HTTPCloudProvider(svc.endpoint)
        mc = p.create(machine(C))
        with pytest.raises(C.iface.MachineNotFoundError):
            p.get(mc.status.provider_id)
        time.sleep(1.3)
        assert p.get(mc.status.provider_id).status.provider_id == mc.status.provider_id
        p.delete(mc)
        assert p.list()
        time.sleep(1.3)
        assert p.list() == []
    finally:
        svc.stop()


def test_unreachable_backend_raises_provider_error():
    m = pkg_mod(PORT)
    p = m.httpcloud.HTTPCloudProvider("http://127.0.0.1:9", timeout_s=0.2)
    with pytest.raises(m.iface.CloudProviderError):
        p.list()
    assert p.liveness_probe() is False


class TestDiscoveryConformance:
    def test_security_group_selector(self, cloud):
        provider = cloud[3]
        groups = provider.describe_security_groups({"karpenter.tpu/discovery": "cluster"})
        assert sorted(g.id for g in groups) == ["sg-default", "sg-nodes"]
        assert [g.id for g in provider.describe_security_groups({"role": "node"})] == ["sg-nodes"]
        assert provider.describe_security_groups({"role": "nope"}) == []

    def test_wildcard_selector_matches_key_presence(self, cloud):
        provider = cloud[3]
        assert [g.id for g in provider.describe_security_groups({"role": "*"})] == ["sg-nodes"]
        assert len(provider.describe_subnets({"zone": "*"})) >= 2
        assert provider.describe_images({"nosuchtag": "*"}) == []

    def test_subnet_selector(self, cloud):
        provider = cloud[3]
        subnets = provider.describe_subnets({"karpenter.tpu/discovery": "cluster"})
        assert subnets and all(s.id.startswith("subnet-") for s in subnets)
        assert [s.zone for s in provider.describe_subnets({"zone": subnets[0].zone})] == \
            [subnets[0].zone]

    def test_image_selector_newest_first(self, cloud):
        imgs = cloud[3].describe_images({"family": "al2"})
        assert imgs and all(i.tags.get("family") == "al2" for i in imgs)
        assert [i.created for i in imgs] == sorted((i.created for i in imgs), reverse=True)

    def test_nodetemplate_controller_resolves_against_either_backend(self, cloud):
        import importlib

        C, provider = cloud[0], cloud[3]
        NodeTemplateController = importlib.import_module(
            f"{C.pkg}.controllers.nodetemplate").NodeTemplateController
        cluster = C.state.Cluster()
        cluster.add_node_template(C.objects.NodeTemplate(
            meta=C.api.ObjectMeta(name="t"),
            subnet_selector={"karpenter.tpu/discovery": "cluster"},
            security_group_selector={"role": "node"}, image_selector={"family": "al2"}))
        ctl = NodeTemplateController(cluster, provider)
        assert ctl.reconcile() == ["t"]
        t = cluster.node_templates["t"]
        assert t.resolved_security_groups == ["sg-nodes"]
        assert t.resolved_subnets and all(s.startswith("subnet-") for s in t.resolved_subnets)
        assert t.resolved_images and all(i.startswith("img-al2") for i in t.resolved_images)
        assert ctl.reconcile() == []


# -- the two clouds side by side ------------------------------------------------


def test_clouds_side_by_side():
    """Each package's provider against its own service on one catalog: the
    same instance types (names, offerings with availability and prices)
    for every provisioner, the same launches for the same machines, the
    same answers after an ICE mark, and the same terminations."""
    seen = {}
    for pkg in PACKAGES:
        m = pkg_mod(pkg)
        wk = m.wk
        svc = m.httpcloud.CloudHTTPService(m.cloud.generate_catalog(n_types=60)).start()
        try:
            p = m.httpcloud.HTTPCloudProvider(svc.endpoint)
            provs = [
                m.api.Provisioner(meta=m.api.ObjectMeta(name="default")),
                m.api.Provisioner(meta=m.api.ObjectMeta(name="od"), requirements=m.api.Requirements([
                    m.api.Requirement.in_values(wk.CAPACITY_TYPE, [wk.CAPACITY_TYPE_ON_DEMAND])])),
                m.api.Provisioner(meta=m.api.ObjectMeta(name="c"), requirements=m.api.Requirements([
                    m.api.Requirement.in_values(wk.INSTANCE_CATEGORY, ["c", "m"])])),
            ]
            rows = []
            for prov in provs:
                rows.append([(it.name, sorted((o.zone, o.capacity_type, o.price, o.available)
                                              for o in it.offerings),
                              sorted(it.capacity.to_dict().items()))
                             for it in p.get_instance_types(prov)])
            launched = []
            for i, (cpu, reqs) in enumerate([
                ("500m", []), ("2", []), ("15", [m.api.Requirement.in_values(wk.ZONE, ["zone-c"])]),
                ("1", [m.api.Requirement.in_values(wk.CAPACITY_TYPE, [wk.CAPACITY_TYPE_ON_DEMAND])]),
                ("4", [m.api.Requirement.in_values(wk.INSTANCE_CATEGORY, ["m"])]),
            ]):
                launched.append(p.create(machine(m, f"m-{i}", cpu=cpu, reqs=reqs)))
            rows.append([labels(m, mc) for mc in launched])
            p.set_insufficient_capacity(*labels(m, launched[0]))
            again = p.create(machine(m, "m-ice", cpu="500m"))
            rows.append((labels(m, again), p.unavailable_offerings.seqnum,
                         [(it.name, [o.available for o in it.offerings])
                          for it in p.get_instance_types(provs[0])]))
            rows.append([type(e).__name__ if e else None for e in p.delete_many(launched[:2] * 2)])
            rows.append(sorted(labels(m, mc) for mc in p.list()))
            audit = svc.launch_audit()
            rows.append((audit["launches"], audit["tokens"], audit["duplicate_tokens"]))
            seen[pkg] = rows
        finally:
            svc.stop()
    assert seen[PORT] == seen[REF]


# -- tests/test_resilience.py's HTTP cases (:253-450, :566), on the port --------


@pytest.fixture
def port_cloud():
    m = pkg_mod(PORT)
    svc = m.httpcloud.CloudHTTPService(m.cloud.generate_catalog(n_types=20)).start()
    try:
        yield m, svc, m.httpcloud.HTTPCloudProvider(svc.endpoint, retry_policy=no_sleep_policy(m))
    finally:
        svc.stop()


class TestHTTPTransports:
    def test_cloud_call_retries_5xx(self, port_cloud):
        m, _, provider = port_cloud
        plan = m.faults.FaultPlan().fail("/v1/instance-types", 2, status=503)
        provider._transport = m.faults.ScriptedTransport(plan, provider._http_transport)
        assert provider._catalog() and plan.pending() == 0

    def test_cloud_call_retries_connection_errors(self, port_cloud):
        m, _, provider = port_cloud
        plan = m.faults.FaultPlan().script("/v1/images", [m.faults.Fault(kind="error", status=0)] * 2)
        provider._transport = m.faults.ScriptedTransport(plan, provider._http_transport)
        assert provider.liveness_probe()

    def test_failed_catalog_refresh_serves_the_last_catalog(self, port_cloud):
        """A refresh that exhausts its retries keeps serving the catalog the
        provider last fetched and is tried again a TTL later; a provider
        that never fetched one raises, as the boot's connectivity check
        wants."""
        m, svc, provider = port_cloud
        first = provider._catalog()
        provider.catalog_ttl_s = 0.2
        time.sleep(0.25)
        plan = m.faults.FaultPlan().fail("/v1/instance-types", 4, status=503)
        transport = m.faults.ScriptedTransport(plan, provider._http_transport)
        provider._transport = transport
        assert provider._catalog() is first and plan.pending() == 0
        assert transport.calls.count("/v1/instance-types") == 4
        assert provider.get_instance_types(None)  # not tried again before the TTL
        assert transport.calls.count("/v1/instance-types") == 4
        time.sleep(0.25)
        assert provider._catalog() is not first
        assert transport.calls.count("/v1/instance-types") == 5
        fresh = m.httpcloud.HTTPCloudProvider(svc.endpoint, retry_policy=no_sleep_policy(m))
        fresh._transport = m.faults.ScriptedTransport(
            m.faults.FaultPlan().fail("/v1/instance-types", 4, status=503), fresh._http_transport)
        with pytest.raises(m.iface.CloudProviderError):
            fresh._catalog()

    def test_cloud_terminal_4xx_does_not_retry(self, port_cloud):
        m, _, provider = port_cloud
        plan = m.faults.FaultPlan().fail("/v1/images", 1, status=403)
        transport = m.faults.ScriptedTransport(plan, provider._http_transport)
        provider._transport = transport
        with pytest.raises(m.iface.CloudProviderError):
            provider._current_images()
        assert transport.calls.count("/v1/images") == 1

    def test_cloud_breaker_opens_on_sustained_failure(self, port_cloud):
        m, _, provider = port_cloud
        clock = m.cache.FakeClock()
        provider.breakers = m.res.BreakerSet("cloud", failure_threshold=3, clock=clock.now)
        plan = m.faults.FaultPlan().fail("/v1/images", 50, status=500)
        provider._transport = m.faults.ScriptedTransport(plan, provider._http_transport)
        with pytest.raises(m.iface.CloudProviderError):
            provider._current_images()
        assert provider.breakers.get("/v1/images").state == "open"
        before = plan.pending("/v1/images")
        assert provider.liveness_probe() is False and plan.pending("/v1/images") == before
        plan._scripts.clear()
        clock.step(11)
        assert provider.liveness_probe() is True
        assert provider.breakers.get("/v1/images").state == "closed"


def run_body(svc, name, token):
    it = svc.catalog[0]
    return {"name": name, "provisioner_name": "default", "client_token": token,
            "overrides": [[it.name, it.offerings[0].zone, it.offerings[0].capacity_type]]}


@pytest.mark.parametrize("pkg", PACKAGES, ids=["ref", "port"])
def test_run_instances_idempotency_matches_reference(pkg):
    """``run_instances`` is idempotent on the client token, a token still
    in flight answers a retryable 503 (``LaunchInFlight``), and a fresh
    token is a new launch; both services answer alike."""
    m = pkg_mod(pkg)
    svc = m.httpcloud.CloudHTTPService(m.cloud.generate_catalog(n_types=20))
    first = svc.run_instances(run_body(svc, "prov-1", "tok-1"))
    replay = svc.run_instances(run_body(svc, "prov-1", "tok-1"))
    assert first["instance"]["id"] == replay["instance"]["id"] and len(svc.instances) == 1
    fresh = svc.run_instances(run_body(svc, "prov-1", "tok-2"))
    assert fresh["instance"]["id"] != first["instance"]["id"] and len(svc.instances) == 2
    svc._launch_tokens["tok-race"] = m.httpcloud._PENDING
    with pytest.raises(m.httpcloud.LaunchInFlight):
        svc.run_instances(run_body(svc, "prov-2", "tok-race"))
    assert svc.handle("/v1/run-instances", run_body(svc, "prov-2", "tok-race"))[0] == 503
    svc._launch_tokens.pop("tok-race")
    assert "instance" in svc.run_instances(run_body(svc, "prov-2", "tok-race"))
    audit = svc.launch_audit()
    assert audit["launches"] == 3 and audit["tokens"] == 3 and not audit["duplicate_tokens"]


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_server_side_fault_plan_over_real_http(pair):
    """The service consumes its own fault plan: real 5xx on the wire, real
    retries in the client, counted in the client's metrics."""
    C, S = pkg_mod(pair[0]), pkg_mod(pair[1])
    plan = S.faults.FaultPlan().fail("/v1/instance-types", 2, status=502)
    svc = S.httpcloud.CloudHTTPService(S.cloud.generate_catalog(n_types=10), fault_plan=plan).start()
    try:
        labels_ = {"service": "cloud", "endpoint": "/v1/instance-types"}
        before = C.metrics.RPC_RETRIES.value(labels_)
        provider = C.httpcloud.HTTPCloudProvider(svc.endpoint, retry_policy=no_sleep_policy(C))
        assert len(provider._catalog()) == 10 and plan.pending() == 0
        assert C.metrics.RPC_RETRIES.value(labels_) - before == 2
    finally:
        svc.stop()


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_capacity_fault_feeds_the_client_ice_cache(pair):
    """A scripted capacity fault on ``/v1/run-instances`` comes back as the
    all-offerings-exhausted answer, and the client marks what it asked."""
    C, S = pkg_mod(pair[0]), pkg_mod(pair[1])
    plan = S.faults.FaultPlan().capacity_error("/v1/run-instances", 1)
    svc = S.httpcloud.CloudHTTPService(S.cloud.generate_catalog(n_types=10), fault_plan=plan).start()
    try:
        provider = C.httpcloud.HTTPCloudProvider(svc.endpoint)
        with pytest.raises(C.iface.InsufficientCapacityError):
            provider.create(machine(C))
        assert provider.unavailable_offerings.seqnum > 0 and not svc.instances
        key = labels(C, provider.create(machine(C, "m-1")))
        assert not provider.unavailable_offerings.is_unavailable(*key)
    finally:
        svc.stop()


def test_http_provider_survives_transient_create_errors():
    """A provisioning round over the HTTP cloud absorbs two 503s on
    ``/v1/run-instances`` with no reconcile-loop failure."""
    m = pkg_mod(PORT)
    import importlib

    kit = importlib.import_module(f"{PORT}.controllers.kit")
    prov_mod = importlib.import_module(f"{PORT}.controllers.provisioning")
    from karpenter_tpu_torch.solver import TorchSolver

    plan = m.faults.FaultPlan().fail("/v1/run-instances", 2, status=503)
    svc = m.httpcloud.CloudHTTPService(m.cloud.generate_catalog(n_types=20), fault_plan=plan).start()
    try:
        provider = m.httpcloud.HTTPCloudProvider(svc.endpoint, retry_policy=no_sleep_policy(m))
        cluster = m.state.Cluster()
        controller = prov_mod.ProvisioningController(
            cluster, provider, settings=m.settings.Settings(batch_idle_duration=0,
                                                            batch_max_duration=0),
            solver=TorchSolver(device="cpu"))
        controller.retry_policy = no_sleep_policy(m)
        cluster.add_provisioner(m.api.Provisioner(meta=m.api.ObjectMeta(name="default")))
        for pod in make_pods(m, 20, cpu="500m", memory="1Gi"):
            cluster.add_pod(pod)
        loop = kit.SingletonController("provisioning", controller.reconcile)
        assert loop.run_if_due() and loop.consecutive_errors == 0
        assert all(p.node_name for p in cluster.pods.values()) and plan.pending() == 0
    finally:
        svc.stop()


def test_interruption_queue_over_the_wire_keeps_raw_bodies():
    """``HTTPQueue`` is the service's queue across the wire: bodies arrive
    byte for byte (garbage too), receive counts rise, and delete removes."""
    m = pkg_mod(PORT)
    svc = m.httpcloud.CloudHTTPService(m.cloud.generate_catalog(n_types=5)).start()
    try:
        q = m.httpcloud.HTTPCloudProvider(svc.endpoint).queue
        q.send({"detail-type": "x"})
        q.send_raw("{not json")
        assert len(q) == 2 == len(svc.queue)
        msgs = q.receive(10)
        assert sorted(msg.body for msg in msgs) == ['{"detail-type": "x"}', "{not json"]
        for msg in msgs:
            q.delete(msg.id)
        assert len(q) == 0
    finally:
        svc.stop()


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
