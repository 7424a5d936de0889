"""The flight recorder on the CPU: the port's wire codec, recorder and
capsules against the JAX package's.

* Codec: for every kind ``codec.from_wire`` knows, twin objects built in
  both packages from a numpy seed encode to equal wire dicts, and the
  port's ``from_wire(to_wire(x))`` gives ``x`` back (through JSON). The
  instance-type wire, ICE state included, is equal across packages and
  lossless, and an encode's ``problem_digest`` survives the round trip
  (the reference's ``TestInstanceTypeCodec``).
* Recorder: the reference's ``TestRecorder`` cases on the port (ring
  bounds, capacity 0, suppression, idle rounds, the error trigger, the wire
  cache, decisions past the decision ring's capacity, the per-thread
  network guard, the capsule metrics), and the ``breaker-open`` trigger.
* Twin capsules: the same round on twin clusters in both packages gives
  equal capsules, on ``GreedySolver`` and on the quality solvers
  (``TPUSolver(auto_mesh=False, quality_sync=True, latency_budget_s=30)``
  against ``TorchSolver(latency_budget_s=30, device="cpu")``: no deadline
  picks a race's winner, and the host paths polish without theirs,
  ``_host_paths_run_dry``). Masked before the comparison: the capsule id,
  its timestamp, ``reconcile_id`` and ``trace_id`` (also per decision, with
  each decision's timestamp), the lifecycle marks, ``aot_solves``, the
  solver's name, each cell's seconds (``lag_s``, ``solve_s``), and of each
  captured object its ``uid`` and ``creationTimestamp`` (uids come from a
  per-package counter, creation timestamps from the wall clock). Rounds: flat, delta, unschedulable, a
  mid-round ICE cascade, sharded (``note_cells``), gang-deferred,
  validation-rejected, deprovisioning (planned, then matured) and
  rebalance.
* The HTTP surface (``/debug/flightrecorder``), the anomaly dumps and
  ``flush_dumps`` (``Operator.new``'s ``FLIGHT.configure`` and the
  shutdown step are in ``tests/test_torch_operator.py``).

Every test resets ``FLIGHT`` and ``DECISIONS`` in both packages, as the
reference's fixture does. The replay of these capsules is
``tests/test_torch_replay.py``.
"""

from __future__ import annotations

import gzip
import importlib
import json
import os
import socket
import threading
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

from karpenter_tpu.solver import TPUSolver
from karpenter_tpu_torch.solver import TorchSolver
from test_torch_controller import (  # noqa: F401  (fixtures)
    PACKAGES,
    _fresh_caches,
    _host_paths_run_dry,
    hold_fits,
    mixed_rows,
)

REF, PORT = PACKAGES
QUALITY_BUDGET_S = 30.0


def pkg_mod(pkg: str) -> SimpleNamespace:
    """What a recorded round is built from, in package ``pkg``."""
    imp = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
    return SimpleNamespace(
        pkg=pkg, api=imp("api"), wk=imp("api.labels"), settings=imp("api.settings"),
        codec=imp("api.codec"), cloud=imp("cloudprovider"), types=imp("cloudprovider.types"),
        state=imp("state"), prov=imp("controllers.provisioning"),
        deprov=imp("controllers.deprovisioning"), term=imp("controllers.termination"),
        cache=imp("utils.cache"), decisions=imp("utils.decisions"), metrics=imp("utils.metrics"),
        fr=imp("utils.flightrecorder"), resilience=imp("utils.resilience"),
        http=imp("utils.httpserver"), solver=imp("solver.solver"), encode=imp("solver.encode"),
        replay=imp("replay"),
    )


def reset_rings():
    for pkg in PACKAGES:
        m = pkg_mod(pkg)
        m.decisions.DECISIONS.configure(2048)
        m.decisions.DECISIONS.clear()
        m.fr.FLIGHT.configure(32)
        m.fr.FLIGHT.clear()


@pytest.fixture(autouse=True)
def _fresh_rings():
    reset_rings()
    yield
    reset_rings()


def roundtrip(capsule):
    """A capsule through JSON, as a disk dump or an HTTP fetch carries it."""
    return json.loads(json.dumps(capsule, default=str))


# -- twin objects ---------------------------------------------------------------


def twin_objects(m, seed: int) -> dict:
    """One object of every kind ``codec.from_wire`` knows, with every
    encoded field set from a numpy seed (so both packages build the same)."""
    api, wk = m.api, m.wk
    rng = np.random.default_rng(seed)
    pick = lambda xs: xs[int(rng.integers(0, len(xs)))]  # noqa: E731

    def meta(name, **kw):
        return api.ObjectMeta(
            name=name, namespace=pick(["default", "team-a"]), uid=f"uid-{name}-{seed}",
            labels={"app": pick(["web", "db"]), "tier": str(int(rng.integers(0, 3)))},
            annotations={"note": pick(["", "x"])} if rng.random() < 0.5 else {},
            finalizers=["karpenter.sh/termination"] if rng.random() < 0.5 else [],
            creation_timestamp=float(rng.integers(1, 10**6)),
            deletion_timestamp=float(rng.integers(1, 10**6)) if rng.random() < 0.3 else None,
            owner_kind=pick([None, "ReplicaSet", "DaemonSet"]),
            resource_version=int(rng.integers(0, 100)), **kw,
        )

    def reqs():
        out = [api.Requirement.in_values(wk.ZONE, ["zone-a", pick(["zone-b", "zone-c"])]),
               api.Requirement.from_operator(wk.CAPACITY_TYPE, "NotIn", ["spot"])]
        if rng.random() < 0.5:
            out.append(api.Requirement.from_operator("karpenter.k8s.aws/instance-cpu", "Gt",
                                                     [str(int(rng.integers(1, 8)))]))
        if rng.random() < 0.5:
            out.append(api.Requirement.from_operator("karpenter.k8s.aws/instance-cpu", "Lt",
                                                     [str(int(rng.integers(16, 64)))]))
        return api.Requirements(out)

    def res():
        return api.Resources(cpu=f"{int(rng.integers(1, 4000))}m",
                             memory=f"{int(rng.integers(1, 8192))}Mi")

    def taints():
        return [api.Taint(key=pick(["gpu", "dedicated"]), value=pick(["", "ml"]),
                          effect=pick(["NoSchedule", "NoExecute"]))
                for _ in range(int(rng.integers(0, 3)))]

    def kubelet():
        return api.KubeletConfiguration(
            cluster_dns=["10.0.0.10"] if rng.random() < 0.5 else None,
            max_pods=int(rng.integers(10, 110)) if rng.random() < 0.5 else None,
            pods_per_core=int(rng.integers(1, 10)) if rng.random() < 0.5 else None,
            kube_reserved=res() if rng.random() < 0.5 else None,
            system_reserved=res() if rng.random() < 0.5 else None,
            eviction_hard={"memory.available": "100Mi"} if rng.random() < 0.5 else {},
            eviction_soft={"nodefs.available": "10%"} if rng.random() < 0.5 else {},
        )

    pod = api.Pod(
        meta=meta(f"pod-{seed}"), requests=res(),
        node_selector={"pool": pick(["a", "b"])} if rng.random() < 0.7 else {},
        required_affinity_terms=[reqs() for _ in range(int(rng.integers(0, 2)))],
        preferred_affinity_terms=[(int(rng.integers(1, 100)), reqs())
                                  for _ in range(int(rng.integers(0, 2)))],
        volume_zones=["zone-a"] if rng.random() < 0.5 else [],
        tolerations=[api.Toleration(key="gpu", operator=pick(["Equal", "Exists"]),
                                    value=pick(["", "ml"]), effect=pick(["", "NoSchedule"]),
                                    toleration_seconds=pick([None, 30]))],
        topology_spread=[api.TopologySpreadConstraint(
            max_skew=int(rng.integers(1, 3)), topology_key=wk.ZONE,
            when_unsatisfiable=pick(["DoNotSchedule", "ScheduleAnyway"]),
            label_selector={"app": "web"})],
        affinity_terms=[api.PodAffinityTerm(label_selector={"app": "db"},
                                            topology_key=wk.HOSTNAME, anti=bool(rng.random() < 0.5))],
        priority=int(rng.integers(0, 1000)), node_name=pick([None, "node-1"]),
        phase=pick(["Pending", "Running"]), is_daemonset=bool(rng.random() < 0.3),
    )
    if rng.random() < 0.5:
        pod.meta.annotations[wk.POD_GROUP] = "train"
        pod.meta.annotations[wk.POD_GROUP_MIN_MEMBERS] = "4"
    node = api.Node(
        meta=meta(f"node-{seed}"), provider_id=f"fake:///zone-a/i-{seed:08d}",
        capacity=res(), allocatable=res(), taints=taints(),
        unschedulable=bool(rng.random() < 0.3), ready=bool(rng.random() < 0.7),
        machine_name=pick([None, f"machine-{seed}"]),
    )
    machine = api.Machine(
        meta=meta(f"machine-{seed}"), provisioner_name="default", requirements=reqs(),
        requests=res(), taints=taints(), kubelet=kubelet(),
        node_template_ref=pick([None, "al2-tpl"]),
        status=api.MachineStatus(provider_id=f"fake:///zone-a/i-{seed:08d}", capacity=res(),
                                 allocatable=res(), launched=bool(rng.random() < 0.5),
                                 registered=bool(rng.random() < 0.5),
                                 initialized=bool(rng.random() < 0.5)),
    )
    provisioner = api.Provisioner(
        meta=meta(f"prov-{seed}"), requirements=reqs(), labels={"pool": pick(["a", "b"])},
        annotations={"owner": "team"} if rng.random() < 0.5 else {}, taints=taints(),
        startup_taints=taints(), kubelet=kubelet(), limits=pick([None, res(), api.Resources()]),
        consolidation_enabled=bool(rng.random() < 0.5),
        ttl_seconds_after_empty=pick([None, 30]), ttl_seconds_until_expired=pick([None, 3600]),
        weight=int(rng.integers(0, 100)), node_template_ref=pick([None, "al2-tpl"]),
    )
    template = api.NodeTemplate(
        meta=meta(f"tpl-{seed}"), image_family=pick(["al2", "bottlerocket", "default"]),
        image_selector={"name": "img-*"} if rng.random() < 0.5 else {},
        subnet_selector={"karpenter.sh/discovery": "c"},
        security_group_selector={"karpenter.sh/discovery": "c"},
        instance_profile=pick([None, "profile"]), user_data=pick([None, "#!/bin/bash"]),
        tags={"team": "ml"} if rng.random() < 0.5 else {},
        block_device_mappings=[api.BlockDeviceMapping(
            device_name="/dev/xvda", volume_size_gib=int(rng.integers(20, 200)),
            volume_type=pick(["ssd", "gp3"]), encrypted=bool(rng.random() < 0.5),
            delete_on_termination=bool(rng.random() < 0.5))],
        detailed_monitoring=bool(rng.random() < 0.5),
        metadata_options={"httpTokens": "required"} if rng.random() < 0.5 else {},
        resolved_subnets=["subnet-1"], resolved_security_groups=["sg-1"],
        resolved_images=["img-al2-standard-001"] if rng.random() < 0.5 else [],
    )
    pdb = api.PodDisruptionBudget(
        meta=meta(f"pdb-{seed}"), selector={"app": "web"},
        min_available=pick([None, 1, "50%"]), max_unavailable=pick([None, 2]),
    )
    return {"pods": pod, "nodes": node, "machines": machine, "provisioners": provisioner,
            "nodetemplates": template, "poddisruptionbudgets": pdb}


KINDS = ("pods", "nodes", "machines", "provisioners", "nodetemplates", "poddisruptionbudgets")


def test_codec_knows_the_reference_kinds():
    assert tuple(pkg_mod(PORT).codec.KINDS) == tuple(pkg_mod(REF).codec.KINDS) == KINDS


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kind", KINDS)
def test_codec_wire_equals_reference_and_round_trips(kind, seed):
    ref, port = pkg_mod(REF), pkg_mod(PORT)
    want = ref.codec.to_wire(twin_objects(ref, seed)[kind])
    obj = twin_objects(port, seed)[kind]
    assert port.codec.kind_of(obj) == kind
    wire = port.codec.to_wire(obj)
    assert wire == want
    back = port.codec.from_wire(kind, roundtrip(wire))
    assert port.codec.to_wire(back) == wire
    # the reference decodes the port's wire to the same object
    assert ref.codec.to_wire(ref.codec.from_wire(kind, roundtrip(wire))) == want


def masked_provider(m, n_types=10):
    provider = m.cloud.FakeCloudProvider(catalog=m.cloud.generate_catalog(n_types=n_types))
    first = provider.catalog[0]
    provider.unavailable_offerings.mark_unavailable(
        first.name, first.offerings[0].zone, first.offerings[0].capacity_type)
    return provider


def test_instance_type_wire_equals_reference_with_ice_state():
    wires = {}
    for pkg in PACKAGES:
        m = pkg_mod(pkg)
        provider = masked_provider(m)
        types = provider.get_instance_types(m.api.Provisioner(meta=m.api.ObjectMeta(name="default")))
        wires[pkg] = [m.types.instance_type_to_wire(it) for it in types]
    assert wires[PORT] == wires[REF]
    assert any(not o["available"] for it in wires[PORT] for o in it["offerings"])


def test_instance_type_codec_lossless_including_ice_state():
    """The reference's ``test_lossless_round_trip_including_ice_state`` on
    the port."""
    m = pkg_mod(PORT)
    provider = masked_provider(m)
    types = provider.get_instance_types(m.api.Provisioner(meta=m.api.ObjectMeta(name="default")))
    rebuilt = [m.types.instance_type_from_wire(roundtrip(m.types.instance_type_to_wire(it)))
               for it in types]
    for a, b in zip(types, rebuilt):
        assert a.name == b.name
        assert a.capacity.to_dict() == b.capacity.to_dict()
        assert a.overhead.total().to_dict() == b.overhead.total().to_dict()
        assert a.offerings == b.offerings
        assert sorted((r.key, r.complement, tuple(sorted(r.values))) for r in a.requirements) \
            == sorted((r.key, r.complement, tuple(sorted(r.values))) for r in b.requirements)
    assert [o for it in rebuilt for o in it.offerings if not o.available]


def test_encode_digest_survives_codec_round_trip():
    """A from-scratch encode of codec-round-tripped inputs has the digest of
    the original's, in the port, and that digest is the reference's; the
    pods carry gang annotations and priorities."""
    digests = {}
    for pkg in PACKAGES:
        m = pkg_mod(pkg)
        rng = np.random.default_rng(6)
        pods = []
        for i, (cpu, mem) in enumerate(mixed_rows(6, 12)):
            p = m.api.Pod(meta=m.api.ObjectMeta(name=f"dig-{i}", uid=f"u{i}", creation_timestamp=1.0),
                          requests=m.api.Resources(cpu=f"{cpu}m", memory=f"{mem}Mi"))
            if rng.random() < 0.5:
                p.priority = int(rng.choice([1, 50, 1000]))
            if rng.random() < 0.5:
                p.meta.annotations[m.wk.POD_GROUP] = f"g{int(rng.integers(0, 3))}"
                if rng.random() < 0.5:
                    p.meta.annotations[m.wk.POD_GROUP_MIN_MEMBERS] = "4"
            pods.append(p)
        prov = m.api.Provisioner(meta=m.api.ObjectMeta(name="default"))
        types = m.cloud.FakeCloudProvider(catalog=m.cloud.generate_catalog(n_types=10)) \
            .get_instance_types(prov)
        original = m.solver.problem_digest(m.encode.encode(pods, [(prov, types)]))
        pods2 = [m.codec.pod_from_wire(roundtrip(m.codec.pod_to_wire(p))) for p in pods]
        prov2 = m.codec.provisioner_from_wire(roundtrip(m.codec.provisioner_to_wire(prov)))
        types2 = [m.types.instance_type_from_wire(roundtrip(m.types.instance_type_to_wire(t)))
                  for t in types]
        assert m.solver.problem_digest(m.encode.encode(pods2, [(prov2, types2)])) == original
        digests[pkg] = original
    assert digests[PORT] == digests[REF]


def test_gang_fields_stay_off_the_wire_when_unset():
    m = pkg_mod(PORT)
    plain = m.api.Pod(meta=m.api.ObjectMeta(name="plain"))
    wire = m.codec.pod_to_wire(plain)
    assert "priority" not in wire and "annotations" not in wire["meta"]
    member = m.api.Pod(meta=m.api.ObjectMeta(name="member"), priority=100)
    member.meta.annotations[m.wk.POD_GROUP] = "train"
    member.meta.annotations[m.wk.POD_GROUP_MIN_MEMBERS] = "8"
    wire = m.codec.pod_to_wire(member)
    assert wire["priority"] == 100 and wire["meta"]["annotations"][m.wk.POD_GROUP] == "train"
    back = m.codec.pod_from_wire(roundtrip(wire))
    assert (back.priority, back.pod_group(), back.pod_group_min_members()) == (100, "train", 8)


# -- the recorder (the reference's TestRecorder) --------------------------------


def env(m, n_pods=6, n_types=20, provisioner=None, solver=None, **settings_kw):
    """The reference test's ``_env``: one provisioner, ``n_pods`` pods of
    500m/1Gi, a closed batch window, a ``GreedySolver``."""
    cluster = m.state.Cluster()
    provider = m.cloud.FakeCloudProvider(catalog=m.cloud.generate_catalog(n_types=n_types))
    provider.create_batched = None
    settings = m.settings.Settings(batch_idle_duration=0, batch_max_duration=0, **settings_kw)
    ctl = m.prov.ProvisioningController(cluster, provider, solver=solver or m.solver.GreedySolver(),
                                        settings=settings)
    cluster.add_provisioner(provisioner or m.api.Provisioner(meta=m.api.ObjectMeta(name="default")))
    for i in range(n_pods):
        cluster.add_pod(m.api.Pod(meta=m.api.ObjectMeta(name=f"fr-{i}", owner_kind="ReplicaSet"),
                                  requests=m.api.Resources(cpu="500m", memory="1Gi")))
    return cluster, provider, ctl


@pytest.fixture
def port():
    return pkg_mod(PORT)


def test_ring_bounds_and_eviction(port):
    rec = port.fr.FlightRecorder(capacity=2)
    for _ in range(4):
        cap = rec.begin("t")
        cap._inputs = {"objects": {}}
        cap.finish()
    listed = rec.list()
    assert len(listed) == 2
    assert all(rec.get(c["id"]) is not None for c in listed)


def test_capacity_zero_disables(port):
    assert port.fr.FlightRecorder(capacity=0).begin("t") is None
    cluster, provider, ctl = env(port)
    port.fr.FLIGHT.configure(0)
    ctl.reconcile()
    assert port.fr.FLIGHT.list() == []


def test_suppression_blocks_recording(port):
    with port.fr.suppressed():
        assert port.fr.FLIGHT.begin("t") is None
    cap = port.fr.FLIGHT.begin("t")
    assert cap is not None
    cap.finish()


def test_idle_rounds_commit_nothing(port):
    cluster, provider, ctl = env(port, n_pods=0, n_types=5)
    ctl.reconcile()
    assert port.fr.FLIGHT.list() == []


def test_reconcile_error_commits_capsule_with_trigger(port):
    cluster, provider, ctl = env(port, n_pods=2)

    def boom(*a, **k):
        raise RuntimeError("injected solve failure")

    ctl.solver.solve_pods = boom
    with pytest.raises(RuntimeError):
        ctl.reconcile()
    listed = port.fr.FLIGHT.list()
    assert listed and "reconcile-error" in listed[0]["anomalies"]
    assert "injected solve failure" in port.fr.FLIGHT.get(listed[0]["id"])["outputs"]["error"]


def test_wire_cache_reuses_unchanged_objects(port):
    cluster, provider, ctl = env(port, n_pods=4)
    ctl.reconcile()
    first = port.fr.FLIGHT.latest("provisioning")
    cluster.add_pod(port.api.Pod(meta=port.api.ObjectMeta(name="fr-new"),
                                 requests=port.api.Resources(cpu="100m", memory="128Mi")))
    ctl.reconcile()
    second = port.fr.FLIGHT.latest("provisioning")
    assert second["id"] != first["id"]
    assert second["inputs"]["objects"]["provisioners"][0] \
        is first["inputs"]["objects"]["provisioners"][0]
    # the provider's seqnum cache hands back the same list: its wire is shared
    assert second["inputs"]["instance_types"]["default"] \
        is first["inputs"]["instance_types"]["default"]


def test_capsule_decisions_survive_ring_overflow(port):
    port.decisions.DECISIONS.configure(8)
    cluster, provider, ctl = env(port, n_pods=30, n_types=10)
    ctl.reconcile()
    capsule = port.fr.FLIGHT.latest("provisioning")
    placements = [d for d in capsule["outputs"]["decisions"] if d["kind"] == "placement"]
    assert len(placements) >= 30
    assert len(port.decisions.DECISIONS.query(limit=100)) <= 8


def test_capsule_decisions_captured_with_audit_ring_disabled(port):
    port.decisions.DECISIONS.configure(0)
    cluster, provider, ctl = env(port, n_pods=3)
    ctl.reconcile()
    capsule = port.fr.FLIGHT.latest("provisioning")
    assert [d for d in capsule["outputs"]["decisions"] if d["kind"] == "placement"]
    assert port.decisions.DECISIONS.query(limit=100) == []
    report = port.replay.replay_capsule(roundtrip(capsule), solver="greedy", device="cpu")
    assert report["match"] is True


def test_network_guard_is_per_thread(port):
    server = socket.socket()
    server.bind(("127.0.0.1", 0))
    server.listen(1)
    address = server.getsockname()
    results = {}

    def other_thread_connect():
        s = socket.socket()
        try:
            s.connect(address)
            results["other"] = "ok"
        except Exception as e:  # noqa: BLE001
            results["other"] = f"{type(e).__name__}: {e}"
        finally:
            s.close()

    try:
        with port.replay._NoNetwork():
            with pytest.raises(RuntimeError, match="offline replay"):
                socket.create_connection(address)
            t = threading.Thread(target=other_thread_connect)
            t.start()
            t.join(timeout=10)
        assert results["other"] == "ok"
        s = socket.socket()
        s.connect(address)
        s.close()
    finally:
        server.close()


def test_capsule_metrics_counted(port):
    labels = {"controller": "provisioning"}
    before = port.metrics.FLIGHTRECORDER_CAPSULES.value(labels)
    n_capture = port.metrics.FLIGHTRECORDER_CAPTURE.count()
    cluster, provider, ctl = env(port, n_pods=2)
    ctl.reconcile()
    assert port.metrics.FLIGHTRECORDER_CAPSULES.value(labels) == before + 1
    assert port.metrics.FLIGHTRECORDER_CAPTURE.count() == n_capture + 1


def test_breaker_opening_mid_round_is_an_anomaly(port):
    """Both packages count a closed/half-open -> open transition once, and
    a capsule whose round saw one carries the ``breaker-open`` trigger."""
    for pkg in PACKAGES:
        res = pkg_mod(pkg).resilience
        t = [0.0]
        breaker = res.CircuitBreaker(failure_threshold=2, recovery_timeout_s=5.0, clock=lambda: t[0])
        n0 = res.breaker_open_count()
        breaker.record_failure()
        assert res.breaker_open_count() == n0
        breaker.record_failure()
        breaker.record_failure()  # already open: no new transition
        assert res.breaker_open_count() == n0 + 1
        t[0] = 6.0
        assert breaker.state == "half-open"
        breaker.record_failure()  # the failed probe reopens
        assert res.breaker_open_count() == n0 + 2
    cluster, provider, ctl = env(port, n_pods=2)
    solve_pods = ctl.solver.solve_pods

    def tripping(*a, **k):
        b = port.resilience.CircuitBreaker(failure_threshold=1)
        b.record_failure()
        return solve_pods(*a, **k)

    ctl.solver.solve_pods = tripping
    ctl.reconcile()
    assert "breaker-open" in port.fr.FLIGHT.latest("provisioning")["anomalies"]


# -- twin capsules ---------------------------------------------------------------


def mask(capsule: dict) -> dict:
    """The capsule less what differs between two processes by design
    (module docstring)."""
    c = roundtrip(capsule)
    for key in ("id", "timestamp", "reconcile_id", "trace_id", "solver"):
        c.pop(key, None)
    c["outputs"].pop("lifecycle", None)
    c["outputs"].pop("aot_solves", None)
    for d in c["outputs"].get("decisions", []):
        for key in ("timestamp", "reconcile_id", "trace_id"):
            d.pop(key, None)
    for summaries in c.get("cells", []):
        for cell in summaries:
            for key in ("lag_s", "solve_s"):
                cell.pop(key, None)
    for objs in c.get("inputs", {}).get("objects", {}).values():
        for wire in objs:
            wire["meta"].pop("uid", None)
            wire["meta"].pop("creationTimestamp", None)
    return c


def solver_for(mode: str, pkg: str):
    m = pkg_mod(pkg)
    if mode == "greedy":
        return m.solver.GreedySolver()
    if pkg == REF:
        return TPUSolver(auto_mesh=False, quality_sync=True, latency_budget_s=QUALITY_BUDGET_S)
    return TorchSolver(latency_budget_s=QUALITY_BUDGET_S, device="cpu")


def pods(m, cluster, prefix, rows, **kw):
    for i, (cpu, mem) in enumerate(rows):
        pod = m.api.Pod(
            meta=m.api.ObjectMeta(name=f"{prefix}-{i}", owner_kind="ReplicaSet",
                                  annotations=dict(kw.get("annotations", {}))),
            requests=m.api.Resources(cpu=f"{cpu}m", memory=f"{mem}Mi"),
            node_selector=dict(kw.get("node_selector", {})),
        )
        cluster.add_pod(pod)


def round_flat(m, mode):
    cluster, provider, ctl = env(m, n_pods=0, solver=solver_for(mode, m.pkg))
    pods(m, cluster, "flat", mixed_rows(71, 40))
    ctl.reconcile()
    return [m.fr.FLIGHT.latest("provisioning")]


def round_delta(m, mode):
    cluster, provider, ctl = env(m, n_pods=0, solver=solver_for(mode, m.pkg))
    pods(m, cluster, "seed", mixed_rows(72, 30))
    ctl.reconcile()
    pods(m, cluster, "churn", mixed_rows(73, 6))
    ctl.reconcile()
    capsule = m.fr.FLIGHT.latest("provisioning")
    assert capsule["encode_mode"] == "delta"
    return [capsule]


def round_unschedulable(m, mode):
    cluster, provider, ctl = env(m, n_pods=2, solver=solver_for(mode, m.pkg))
    cluster.add_pod(m.api.Pod(meta=m.api.ObjectMeta(name="fr-impossible"),
                              requests=m.api.Resources({"cpu": 0.1, "example.com/fpga": 4})))
    result = ctl.reconcile()
    assert "fr-impossible" in result.unschedulable
    capsule = m.fr.FLIGHT.latest("provisioning")
    assert "unschedulable-pods" in capsule["anomalies"]
    return [capsule]


def round_ice(m, mode):
    """The offering the first solve picks is out of capacity: the launch
    fails, and the round re-solves on a refreshed catalog."""
    probe_cluster, _, probe = env(m, n_pods=4, solver=solver_for(mode, m.pkg))
    chosen = probe.reconcile().solve.new_nodes[0].option
    m.fr.FLIGHT.clear()
    cluster, provider, ctl = env(m, n_pods=4, solver=solver_for(mode, m.pkg))
    provider.set_insufficient_capacity(chosen.instance_type.name, chosen.zone, chosen.capacity_type)
    result = ctl.reconcile()
    assert result.bound
    capsule = m.fr.FLIGHT.latest("provisioning")
    assert len(capsule["outputs"]["problem_digests"]) > 1
    assert any(d.get("outcome") == "ice-failed" for d in capsule["outputs"]["decisions"])
    return [capsule]


def round_sharded(m, mode):
    cell = lambda pool: m.api.Provisioner(meta=m.api.ObjectMeta(name=f"cell-{pool}"),  # noqa: E731
                                          labels={"pool": pool})
    cluster, provider, ctl = env(m, n_pods=0, solver=solver_for(mode, m.pkg), provisioner=cell("a"),
                                 cell_sharding_enabled=True, cell_shard_workers=1)
    cluster.add_provisioner(cell("b"))
    pods(m, cluster, "ca", mixed_rows(74, 20), node_selector={"pool": "a"})
    pods(m, cluster, "cb", mixed_rows(75, 20), node_selector={"pool": "b"})
    ctl.reconcile()
    capsule = m.fr.FLIGHT.latest("provisioning")
    assert len(capsule["cells"]) == 1 and len(capsule["cells"][0]) == 2
    return [capsule]


def round_gang(m, mode):
    cluster, provider, ctl = env(m, n_pods=0, solver=solver_for(mode, m.pkg))
    pods(m, cluster, "plain", mixed_rows(76, 10))
    pods(m, cluster, "short", [(1000, 1024)] * 2,
         annotations={m.wk.POD_GROUP: "short", m.wk.POD_GROUP_MIN_MEMBERS: "3"})
    ctl.reconcile()
    capsule = m.fr.FLIGHT.latest("provisioning")
    assert "gang-deferred" in capsule["anomalies"]
    assert capsule["outputs"]["gang_deferred"] == ["short-0", "short-1"]
    return [capsule]


def round_validation(m, mode):
    """The solver doubles the first spec's pods once: the firewall rejects
    the plan and the fallback re-solves (``tests/test_solver_faultdomain.py``)."""
    solver = solver_for(mode, m.pkg)
    solve_pods = solver.solve_pods
    corrupt = [1]

    def corrupting(*a, **k):
        result = solve_pods(*a, **k)
        if corrupt[0] and result.new_nodes:
            corrupt[0] = 0
            spec = result.new_nodes[0]
            result.new_nodes[0] = type(spec)(option=spec.option,
                                             pod_names=list(spec.pod_names) * 2)
        return result

    solver.solve_pods = corrupting
    cluster, provider, ctl = env(m, n_pods=8, solver=solver)
    result = ctl.reconcile()
    assert len(result.bound) == 8
    capsule = m.fr.FLIGHT.latest("provisioning")
    assert "validation-rejected" in capsule["anomalies"]
    assert len(capsule["outputs"]["problem_digests"]) >= 2
    return [capsule]


def round_deprovisioning(m, mode):
    """A consolidation planned for the validation TTL, then executed once
    it matured: two capsules (the reference's planned/matured case)."""
    clock = m.cache.FakeClock(1000.0)
    cluster, provider, ctl = env(
        m, n_pods=6, solver=solver_for(mode, m.pkg),
        provisioner=m.api.Provisioner(meta=m.api.ObjectMeta(name="default"),
                                      consolidation_enabled=True))
    ctl.reconcile()
    victim = sorted(cluster.nodes)[0]
    for p in list(cluster.pods_on_node(victim)):
        cluster.delete_pod(p.name)
    settings = m.settings.Settings(stabilization_window=0, consolidation_validation_ttl=15)
    term = m.term.TerminationController(cluster, provider, clock=clock)
    dep = m.deprov.DeprovisioningController(cluster, provider, term, solver=ctl.solver,
                                            settings=settings, clock=clock)
    assert dep.reconcile() is None and dep.pending_action is not None
    planned = m.fr.FLIGHT.latest("deprovisioning")
    assert planned["outputs"]["planned"]["reason"] == "consolidation-delete"
    clock.step(16)
    assert dep.reconcile() is not None
    matured = m.fr.FLIGHT.latest("deprovisioning")
    assert matured["inputs"]["had_pending_action"] is not None
    return [planned, matured]


def round_rebalance(m, mode):
    """A rebalance recommendation for a spot node: the replacement is
    launched first (one capsule), then the original drained (another)."""
    from test_torch_interruption import Env as SpotEnv
    from test_torch_interruption import iid, rebalance_rec

    E = SpotEnv(m.pkg, spot=True, n_pods=4)
    if mode != "greedy":
        E.ctl.solver = solver_for(mode, m.pkg)
    E.ctl.reconcile()
    node = next(n for n in E.cluster.nodes.values()
                if n.meta.labels.get(m.wk.CAPACITY_TYPE) == m.wk.CAPACITY_TYPE_SPOT)
    E.queue.send(rebalance_rec(iid(node)))
    E.intr.reconcile()
    first = m.fr.FLIGHT.latest("rebalance")
    E.intr.reconcile()
    second = m.fr.FLIGHT.latest("rebalance")
    assert [a["action"] for a in first["outputs"]["rebalance_actions"]] == ["replacement-launched"]
    assert [a["action"] for a in second["outputs"]["rebalance_actions"]] \
        == ["drained-after-replacement"]
    return [first, second]


ROUNDS = {
    "flat": round_flat, "delta": round_delta, "unschedulable": round_unschedulable,
    "ice": round_ice, "sharded": round_sharded, "gang": round_gang,
    "validation": round_validation, "deprovisioning": round_deprovisioning,
    "rebalance": round_rebalance,
}


def twin_capsules(name, mode):
    """The round ``name`` in each package on fresh rings: its capsules."""
    out = {}
    for pkg in PACKAGES:
        reset_rings()
        pkg_mod(pkg).prov._machine_ids = pkg_mod(pkg).prov.MachineNameSeq()
        out[pkg] = ROUNDS[name](pkg_mod(pkg), mode)
    return out


@pytest.mark.parametrize("mode", ["greedy", "quality"])
@pytest.mark.parametrize("name", list(ROUNDS))
def test_twin_capsules_equal(name, mode):
    caps = twin_capsules(name, mode)
    assert len(caps[PORT]) == len(caps[REF])
    for got, want in zip(caps[PORT], caps[REF]):
        assert got.get("solver") in (None, "GreedySolver", "TorchSolver")
        assert "aot_solves" not in got["outputs"]  # the port's solver stamps no AOT stats
        assert mask(got) == mask(want)


# -- the HTTP surface and the operator -------------------------------------------


def get(port_no, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port_no}{path}", timeout=10) as r:
        return r.status, r.headers, r.read()


def test_debug_flightrecorder_list_fetch_404_and_dump(port, tmp_path):
    cluster, provider, ctl = env(port, n_pods=1)
    cluster.add_pod(port.api.Pod(meta=port.api.ObjectMeta(name="fr-stuck"),
                                 requests=port.api.Resources({"cpu": 0.1, "example.com/fpga": 1})))
    port.fr.FLIGHT.configure(32, dump_dir=str(tmp_path / "auto"))
    ctl.reconcile()  # unschedulable: an anomaly, dumped at commit
    dumps = list((tmp_path / "auto").glob("capsule-*.json.gz"))
    assert len(dumps) == 1
    assert "unschedulable-pods" in port.replay.load_capsule(str(dumps[0]))["anomalies"]
    server = port.http.OperatorHTTPServer(port=0).start()
    try:
        listing = json.loads(get(server.port, "/debug/flightrecorder")[2])["capsules"]
        assert listing and listing[0]["controller"] == "provisioning"
        cid = listing[0]["id"]
        status, headers, payload = get(server.port, f"/debug/flightrecorder/{cid}")
        assert status == 200 and headers["Content-Encoding"] == "gzip"
        capsule = json.loads(gzip.decompress(payload))
        assert capsule["id"] == cid and capsule["outputs"]["problem_digests"]
        with pytest.raises(urllib.error.HTTPError) as err:
            get(server.port, "/debug/flightrecorder/no-such-capsule")
        assert err.value.code == 404
        port.fr.FLIGHT.configure(32, dump_dir=str(tmp_path / "manual"))
        path = json.loads(get(server.port, f"/debug/flightrecorder/{cid}?dump=1")[2])["path"]
        assert os.path.exists(path) and path.startswith(str(tmp_path / "manual"))
    finally:
        server.stop()


def test_flush_dumps_writes_pending_anomalies(port, tmp_path):
    cluster, provider, ctl = env(port, n_pods=1)
    cluster.add_pod(port.api.Pod(meta=port.api.ObjectMeta(name="fr-stuck"),
                                 requests=port.api.Resources({"cpu": 0.1, "example.com/fpga": 1})))
    ctl.reconcile()  # no dump dir yet: nothing written
    port.fr.FLIGHT.configure(32, dump_dir=str(tmp_path))
    written = port.fr.FLIGHT.flush_dumps()
    assert len(written) == 1 and os.path.exists(written[0])
    assert port.fr.FLIGHT.flush_dumps() == []  # already on disk


# -- a round over the wire, replayed offline (tests/test_flightrecorder.py:707-773) --


@pytest.mark.parametrize("pkg", PACKAGES, ids=["ref-recorded", "port-recorded"])
def test_live_http_reconcile_replays_offline_identically(pkg):
    """A provisioning round over ``HTTPCluster`` and ``HTTPCloudProvider``
    (package ``pkg``'s API server and cloud service), its capsule fetched
    gzipped from ``/debug/flightrecorder/<id>``; with both servers stopped,
    the port's ``replay_capsule`` re-runs it offline (its network guard on)
    and matches: digests, placements and unschedulable pods."""
    import importlib

    from test_torch_apiserver import no_sleep_policy
    from test_torch_apiserver import pkg_mod as wire_mod

    m, w = pkg_mod(pkg), wire_mod(pkg)
    kit = importlib.import_module(f"{pkg}.controllers.kit")
    solver = (TorchSolver(device="cpu") if pkg == PORT
              else TPUSolver(auto_mesh=False, quality_sync=True))
    store = w.state.Cluster()
    api = w.apiserver.ClusterAPIServer(backing=store).start()
    svc = w.httpcloud.CloudHTTPService(w.cloud.generate_catalog(n_types=20)).start()
    cluster = w.state.HTTPCluster(api.endpoint, watch=False, retry_policy=no_sleep_policy(w))
    provider = w.httpcloud.HTTPCloudProvider(svc.endpoint, retry_policy=no_sleep_policy(w))
    try:
        controller = m.prov.ProvisioningController(
            cluster, provider, solver=solver,
            settings=m.settings.Settings(batch_idle_duration=0, batch_max_duration=0))
        cluster.add_provisioner(m.api.Provisioner(meta=m.api.ObjectMeta(name="default")))
        for i in range(5):
            cluster.add_pod(m.api.Pod(meta=m.api.ObjectMeta(name=f"e2e-{i}", owner_kind="ReplicaSet"),
                                      requests=m.api.Resources(cpu="500m", memory="1Gi")))
        loop = kit.SingletonController("provisioning", controller.reconcile)
        assert loop.run_if_due() and loop.consecutive_errors == 0
        assert not store.pending_pods() and len(svc.instances) == len(store.machines)
        server = m.http.OperatorHTTPServer(port=0).start()
        try:
            listing = json.loads(get(server.port, "/debug/flightrecorder")[2])["capsules"]
            cid = listing[0]["id"]
            assert cid.startswith("provisioning.") and listing[0]["trace_id"]
            capsule = json.loads(gzip.decompress(get(server.port, f"/debug/flightrecorder/{cid}")[2]))
        finally:
            server.stop()
    finally:
        cluster.close()
        api.stop()
        svc.stop()
    report = pkg_mod(PORT).replay.replay_capsule(capsule, device="cpu")
    diffs = report["diffs"]
    assert diffs["digests_match"] and diffs["placements_match"], diffs
    assert diffs["unschedulable_match"] and report["match"]
    assert set(report["replayed"]["placements"]) == {f"e2e-{i}" for i in range(5)}



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
