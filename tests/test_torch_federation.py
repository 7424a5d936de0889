"""Multi-cluster federation on the CPU: the port's ``federation/`` held
against the JAX package's (``tests/test_federation.py``).

The reference's thirteen classes, each run on the port and, wherever the
two packages can be given the same inputs, on both:

* the pure verdict: equal verdicts and ``verdict_digest``s for the same
  inputs, the reference's cases and numpy-seeded random rounds (summaries,
  duplicated tokens, region lists, gang sizes, degraded requests, leases
  before the round);
* the live arbiter: the same outcomes, epochs and state under the same
  numpy-seeded sequence of intake, loss, sweeps, leases and fences;
* the client, region affinity and failover clones, on twin objects;
* the fleet: twin storm fleets (``bench.bench_federation_storm``'s
  parameters) with equal round costs, verdict digests and capsules (masked
  for uids and timestamps), and ``configs.federation_storm`` equal to the
  reference's bench report; the port replays each package's federation
  capsules with ``match``, through ``replay_capsule`` and its CLI;
* metrics, the churn timeline, the settings and ``/debug/federation``;
* HTTP: each package's client against the other package's
  ``ArbiterHTTPServer``;
* the operator: twin operators federated over ``DirectArbiterTransport``
  act alike step by step.

Tolerance is exact wherever the reference is exact (verdicts, digests,
leases, outcomes, capsules, fleet costs). The twin fleets launch one
machine at a time in plan order (``create_batched`` off, the ``one_launch``
fixture), as every twin test of the port does: on the launch threads, node
names follow the threads, and names enter digests, the storm's choice of
victims and the order of cost sums.
"""

from __future__ import annotations

import copy
import importlib
import json
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

import bench
from test_torch_flightrecorder import mask
from test_torch_operator import (  # noqa: F401  (fixtures)
    CLOCK_START,
    _process_state,
    new_operator,
    one_worker,
)

REF, PORT = PACKAGES = ("karpenter_tpu", "karpenter_tpu_torch")


def pkg_mod(pkg: str) -> SimpleNamespace:
    imp = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
    return SimpleNamespace(
        pkg=pkg, wk=imp("api.labels"), objects=imp("api.objects"), res=imp("api.resources"),
        settings=imp("api.settings"), cloud=imp("cloudprovider"), state=imp("state"),
        arbiter=imp("federation.arbiter"), client=imp("federation.client"),
        fleet=imp("federation.fleet"), server=imp("federation.server"), fed=imp("federation"),
        replay=imp("replay"), churn=imp("soak.churn"), gang=imp("solver.gang"),
        metrics=imp("utils.metrics"), cache=imp("utils.cache"), fr=imp("utils.flightrecorder"),
        http=imp("utils.httpserver"), prov=imp("controllers.provisioning"),
        decisions=imp("utils.decisions"), operator=imp("operator"),
    )


M = {pkg: pkg_mod(pkg) for pkg in PACKAGES}
P, R = M[PORT], M[REF]


@pytest.fixture(autouse=True)
def _fresh_state():
    """Rings sized as the reference's fleet tests size them, node names from
    a fresh sequence (they enter sub-capsule digests), and no arbiter left
    exporting to a later test."""
    for m in M.values():
        m.fr.FLIGHT.configure(64)
        m.fr.FLIGHT.clear()
        m.decisions.DECISIONS.clear()
        m.prov._machine_ids = m.prov.MachineNameSeq()
    yield
    for m in M.values():
        m.arbiter.install_federation_exporter(None)
        m.fr.FLIGHT.configure(m.fr.FlightRecorder.DEFAULT_CAPACITY)
        m.fr.FLIGHT.clear()


def roundtrip(obj):
    return json.loads(json.dumps(obj, default=str))


def _summary(cluster, seq=1, price=0.1, headroom=10, risk_peak=0.0, region=None):
    return {
        "cluster": cluster, "region": region or cluster, "seq": seq,
        "marginal_price": price, "risk_peak": risk_peak, "headroom": headroom,
    }


def _inputs(summaries, requests, epoch=1, leases_before=(), now=100.0, ttl=30.0):
    return {
        "epoch": epoch,
        "summaries": {s["cluster"]: s for s in summaries},
        "available": {s["cluster"]: True for s in summaries},
        "leases_before": list(leases_before),
        "requests": list(requests),
        "now": now,
        "lease_ttl_s": ttl,
    }


def _req(token, cluster="us-east", regions=("*",), units=1, **extra):
    return {
        "token": token, "unit": token, "cluster": cluster,
        "regions": list(regions), "units": units, **extra,
    }


def twin_verdicts(inputs):
    """Both packages' verdicts on the same inputs; they must be equal."""
    port = P.arbiter.arbiter_verdict(copy.deepcopy(inputs))
    ref = R.arbiter.arbiter_verdict(copy.deepcopy(inputs))
    assert port == ref
    assert port["digest"] == P.arbiter.verdict_digest(port) == R.arbiter.verdict_digest(ref)
    return port


# ---------------------------------------------------------------------------
# the pure verdict
# ---------------------------------------------------------------------------

LEASE_A = {"token": "t/a", "target": "us-east", "epoch": 1, "expires_at": 500.0}
VERDICT_CASES = {
    "cheapest": (
        _inputs([_summary("us-east", price=0.2), _summary("eu-west", price=0.1)],
                [_req("t/a"), _req("t/b")]),
        lambda v: all(a["target"] == "eu-west" for a in v["assignments"])),
    "idempotent-token": (
        _inputs([_summary("us-east", price=0.2), _summary("eu-west", price=0.1)],
                [_req("t/a"), _req("t/a")]),
        lambda v: [a["outcome"] for a in v["assignments"]] == ["granted", "renewed"]
        and {a["target"] for a in v["assignments"]} == {"eu-west"}),
    "renewal-pins": (
        _inputs([_summary("us-east", price=0.9), _summary("eu-west", price=0.1)],
                [_req("t/a")], leases_before=[LEASE_A]),
        lambda v: (v["assignments"][0]["outcome"], v["assignments"][0]["target"])
        == ("renewed", "us-east")),
    "expired-and-fenced": (
        _inputs([_summary("us-east", price=0.9), _summary("eu-west", price=0.1)],
                [_req("t/a"), _req("t/b")], epoch=2,
                leases_before=[dict(LEASE_A, expires_at=50.0), dict(LEASE_A, token="t/b")]),
        lambda v: [(a["outcome"], a["target"]) for a in v["assignments"]]
        == [("granted", "eu-west")] * 2),
    "degraded-local": (
        _inputs([_summary("us-east"), _summary("eu-west")],
                [_req("t/a", cluster="us-west", degraded=True)]),
        lambda v: (v["assignments"][0]["outcome"], v["assignments"][0]["target"])
        == ("degraded-local", "us-west")),
    "no-capacity": (
        _inputs([_summary("us-east", headroom=0)],
                [_req("t/a"), _req("t/b", regions=("ap-south",))]),
        lambda v: all(a["outcome"] == "no-capacity" and a["target"] is None
                      for a in v["assignments"])),
    "region-affinity": (
        _inputs([_summary("us-east", price=0.9), _summary("eu-west", price=0.1)],
                [_req("t/a", regions=("us-east",))]),
        lambda v: v["assignments"][0]["target"] == "us-east"),
    "headroom-gates-gangs": (
        _inputs([_summary("us-east", price=0.9, headroom=8),
                 _summary("eu-west", price=0.1, headroom=2)], [_req("t/gang", units=4)]),
        lambda v: v["assignments"][0]["target"] == "us-east"),
    "risk-inflates-price": (
        _inputs([_summary("us-east", price=0.10, risk_peak=0.8),
                 _summary("eu-west", price=0.12)], [_req("t/a")]),
        lambda v: v["assignments"][0]["target"] == "eu-west"),
    "ties-break-on-name": (
        _inputs([_summary("us-east", price=0.1), _summary("eu-west", price=0.1)],
                [_req("t/a")]),
        lambda v: v["assignments"][0]["target"] == "eu-west"),
    "rebalance-hysteresis": (
        _inputs([_summary("us-east", price=0.1, risk_peak=0.7),
                 _summary("us-west", price=0.1, risk_peak=0.3),
                 _summary("eu-west", price=0.2, risk_peak=0.05)], []),
        lambda v: v["rebalance"] == [{"from": "us-east", "to": "eu-west",
                                      "reason": "risk-spike", "risk": 0.7}]),
}


def random_inputs(seed: int) -> dict:
    """One round's verdict inputs drawn from a numpy seed: 2-5 members with
    prices, risk and headroom (some unavailable), 0-12 requests with
    repeated tokens, region lists, gang sizes and degraded entries, and
    leases before the round at this epoch or an older one."""
    rng = np.random.default_rng(seed)
    names = ["us-east", "us-west", "eu-west", "ap-south", "sa-east"][: int(rng.integers(2, 6))]
    summaries = [
        _summary(n, seq=int(rng.integers(1, 9)), price=round(float(rng.uniform(0.01, 1.0)), 4),
                 headroom=None if rng.random() < 0.2 else int(rng.integers(0, 12)),
                 risk_peak=round(float(rng.choice([0.0, 0.1, 0.3, 0.6, 0.9])), 3))
        for n in names
    ]
    epoch = int(rng.integers(1, 4))
    inputs = _inputs(summaries, [], epoch=epoch, now=float(rng.integers(50, 200)))
    for n in names:
        inputs["available"][n] = bool(rng.random() < 0.8)
    tokens = [f"{rng.choice(names)}/u{i}" for i in range(int(rng.integers(1, 8)))]
    for _ in range(int(rng.integers(0, 13))):
        tok = str(rng.choice(tokens))
        regions = ["*"] if rng.random() < 0.5 else list(rng.choice(names + ["mars"], size=2))
        extra = {"degraded": True} if rng.random() < 0.15 else {}
        if rng.random() < 0.3:
            extra["gang"] = tok.split("/")[1]
        inputs["requests"].append(_req(tok, cluster=tok.split("/")[0], regions=regions,
                                       units=int(rng.integers(1, 6)), **extra))
    for tok in tokens[: int(rng.integers(0, len(tokens) + 1))]:
        inputs["leases_before"].append({
            "token": tok, "target": str(rng.choice(names)),
            "epoch": int(rng.choice([epoch, max(1, epoch - 1)])),
            "expires_at": float(rng.integers(50, 300)),
        })
    return inputs


class TestArbiterVerdict:
    @pytest.mark.parametrize("case", list(VERDICT_CASES))
    def test_reference_cases_give_equal_verdicts(self, case):
        inputs, check = VERDICT_CASES[case]
        verdict = twin_verdicts(inputs)
        assert check(verdict)
        assert twin_verdicts(inputs) == verdict  # deterministic

    @pytest.mark.parametrize("seed", range(12))
    def test_random_rounds_give_equal_digests(self, seed):
        inputs = random_inputs(seed)
        verdict = twin_verdicts(inputs)
        assert len(verdict["assignments"]) == len(inputs["requests"])
        # the wire form (a capsule on disk) gives the same digest
        assert P.arbiter.arbiter_verdict(roundtrip(inputs))["digest"] == verdict["digest"]

    def test_digest_sensitive_to_epoch_and_request_order(self):
        summaries = [_summary("us-east", price=0.2), _summary("eu-west", price=0.1)]
        base = twin_verdicts(_inputs(summaries, [_req("t/a"), _req("t/b")]))
        bumped = twin_verdicts(_inputs(summaries, [_req("t/a"), _req("t/b")], epoch=2))
        reordered = twin_verdicts(_inputs(summaries, [_req("t/b"), _req("t/a")]))
        assert len({base["digest"], bumped["digest"], reordered["digest"]}) == 3


# ---------------------------------------------------------------------------
# the live arbiter
# ---------------------------------------------------------------------------

def arbiters(stale_s=15.0, ttl=30.0):
    out = {}
    for pkg, m in M.items():
        clock = m.cache.FakeClock(0.0)
        out[pkg] = (m.arbiter.FederationArbiter(lease_ttl_s=ttl, summary_stale_s=stale_s,
                                                clock=clock), clock)
    return out


class TestArbiterIntake:
    def test_adversarial_delivery_converges_in_both(self):
        seen = {}
        for pkg, (arb, clock) in arbiters().items():
            clusters = ("us-east", "us-west", "eu-west")
            deliveries = []
            for c in clusters:
                for seq in range(1, 6):
                    s = _summary(c, seq=seq, price=0.1 + seq / 100.0)
                    s["epoch"] = max(1, seq - 2)
                    deliveries.append(s)
                    if seq % 2 == 0:
                        deliveries.append(dict(s))
            deliveries = deliveries[1::2] + deliveries[0::2][::-1]
            outcomes = []
            for s in deliveries:
                outcomes.append(arb.submit_summary(s)["outcome"])
                clock.step(0.01)
            members = arb.state()["members"]
            assert {c: m["seq"] for c, m in members.items()} == {c: 5 for c in clusters}
            assert all(members[c]["marginal_price"] == pytest.approx(0.15) for c in clusters)
            assert arb.epoch == 1
            seen[pkg] = (outcomes, arb.state())
        assert seen[PORT] == seen[REF]

    @pytest.mark.parametrize("seed", range(6))
    def test_random_operation_sequences_agree(self, seed):
        """The same numpy-seeded sequence of summaries, losses, sweeps,
        clock steps, leases, confirms and rounds on twin arbiters: every
        answer, the epoch and the exported state are equal."""
        trace = {}
        for pkg, (arb, clock) in arbiters(stale_s=8.0, ttl=12.0).items():
            rng = np.random.default_rng(seed)
            names = ["us-east", "us-west", "eu-west"]
            seqs = {n: 0 for n in names}
            out = []
            arb.begin_round()
            for _ in range(60):
                op = int(rng.integers(0, 7))
                name = str(rng.choice(names))
                if op == 0:
                    seqs[name] += int(rng.integers(-1, 3))
                    out.append(arb.submit_summary(_summary(
                        name, seq=seqs[name], price=round(float(rng.uniform(0.05, 0.5)), 3),
                        headroom=int(rng.integers(0, 6)),
                        risk_peak=round(float(rng.choice([0.0, 0.3, 0.7])), 2))))
                elif op == 1:
                    out.append(arb.declare_lost(name))
                elif op == 2:
                    out.append(arb.sweep_lost())
                elif op == 3:
                    clock.step(float(rng.integers(1, 6)))
                elif op == 4:
                    out.append(arb.request_lease(_req(
                        f"{name}/u{int(rng.integers(0, 4))}", cluster=name,
                        units=int(rng.integers(1, 4)))))
                elif op == 5:
                    out.append(arb.confirm_lease(
                        f"{name}/u{int(rng.integers(0, 4))}",
                        None if rng.random() < 0.7 else int(rng.integers(1, 4))))
                else:
                    out.append(arb.round_capsule_parts(
                        [_req(f"{name}/d", cluster=name, degraded=True)]))
                    arb.begin_round()
            trace[pkg] = roundtrip((out, arb.state(), arb.epoch, arb.summary_ages()))
        assert trace[PORT] == trace[REF]

    def test_declare_lost_and_rejoin_bump_the_epoch(self):
        arb, _ = arbiters()[PORT]
        arb.submit_summary(_summary("us-east", seq=1))
        e0 = arb.epoch
        assert arb.declare_lost("us-east") is True
        assert arb.declare_lost("us-east") is False
        assert arb.epoch == e0 + 1
        assert arb.submit_summary(_summary("us-east", seq=2))["outcome"] == "accepted"
        assert arb.epoch == e0 + 2

    def test_staleness_sweep_and_fencing(self):
        arb, clock = arbiters(stale_s=15.0)[PORT]
        arb.submit_summary(_summary("us-east", seq=1, price=0.1))
        arb.submit_summary(_summary("eu-west", seq=1, price=0.2))
        assert arb.request_lease(_req("us-west/web-0", cluster="us-west"))["outcome"] == "granted"
        assert arb.confirm_lease("us-west/web-0")["outcome"] == "confirmed"
        clock.step(10.0)
        arb.submit_summary(_summary("eu-west", seq=2))
        clock.step(10.0)
        e0 = arb.epoch
        assert arb.sweep_lost() == ["us-east"] and arb.epoch == e0 + 1
        assert arb.sweep_lost() == []
        assert arb.confirm_lease("us-west/web-0") == {
            "outcome": "fenced", "valid": False, "epoch": arb.epoch}
        assert arb.confirm_lease("nope")["outcome"] == "unknown"

    def test_lease_outcomes_land_on_the_ports_counter(self):
        arb, _ = arbiters()[PORT]
        arb.submit_summary(_summary("us-east", seq=1))
        before = P.metrics.FEDERATION_LEASES.value({"outcome": "granted"})
        arb.request_lease(_req("us-east/m", cluster="us-east"))
        assert P.metrics.FEDERATION_LEASES.value({"outcome": "granted"}) == before + 1


# ---------------------------------------------------------------------------
# the client
# ---------------------------------------------------------------------------

def make_client(m, name="us-east", **kw):
    clock = m.cache.FakeClock(0.0)
    arb = m.arbiter.FederationArbiter(clock=clock)
    transport = m.client.DirectArbiterTransport(arb)
    cluster = m.state.Cluster()
    cluster.add_provisioner(m.objects.Provisioner(meta=m.objects.ObjectMeta(name="default")))
    client = m.client.FederationClient(
        name, transport=transport, clock=clock,
        provider=m.cloud.FakeCloudProvider(catalog=m.cloud.generate_catalog(n_types=4)),
        cluster=cluster, recovery_timeout_s=kw.pop("recovery_timeout_s", 5.0),
        breaker_clock=clock.now, **kw,
    )
    return client, transport, arb, clock


def client_script(m) -> list:
    """The reference's client cases as one script: pushes, leases,
    confirms, a partition, the degraded log, the breakers, a heal."""
    client, transport, arb, clock = make_client(m)
    out = [client.mint_token("train-42"), client.push_summary(launch_headroom=10), client.mode]
    lease = client.request_lease("web-0", ["*"])
    out += [lease, client.confirm(lease["token"]), client.epoch_seen == arb.epoch]
    transport.partitioned = True
    for i in range(4):
        out.append(client.push_summary())
        out.append(client.request_lease(f"pod-{i}", ["*"], gang=None))
    out += [client.mode, client.drain_degraded_log(), client.drain_degraded_log(),
            client.confirm("us-east/web-0"), client.status()]
    transport.partitioned = False
    clock.step(6.0)
    out += [client.push_summary(), client.mode, client.last_error,
            arb.state()["members"]["us-east"]["seq"] == client._seq, client.status()]
    return roundtrip(out)


class TestFederationClient:
    def test_twin_clients_answer_alike(self):
        port, ref = client_script(P), client_script(R)
        assert port == ref
        assert port[0] == "us-east/train-42" and port[1] is True and port[2] == "federated"
        assert port[3]["target"] == "us-east" and port[4] is True
        status = port[-1]
        assert set(status["breakers"]) == set(P.client.ROUTES)
        assert status["mode"] == "federated" and port[-3] is None

    def test_partition_degrades_to_local_autonomy(self):
        client, transport, _, _ = make_client(P)
        client.push_summary(launch_headroom=10)
        transport.partitioned = True
        assert client.push_summary() is False and client.mode == "degraded"
        assert client.request_lease("web-0", ["*"], gang=None) is None
        log = client.drain_degraded_log()
        assert len(log) == 1 and log[0]["degraded"] is True
        assert log[0]["token"] == "us-east/web-0"
        assert client.confirm("us-east/web-0") is False

    def test_breaker_cardinality_bounded_by_route_templates(self):
        client, transport, _, _ = make_client(P)
        transport.partitioned = True
        for i in range(8):
            client.push_summary()
            client.request_lease(f"pod-{i}", ["*"])
        assert set(client.status()["breakers"]) == set(P.client.ROUTES)
        assert client.breakers.get(P.client.ROUTE_SUMMARY).state == "open"

    @pytest.mark.parametrize("seed", range(3))
    def test_build_summary_equal_on_twin_catalogs(self, seed):
        rng = np.random.default_rng(seed)
        n_types, headroom = int(rng.integers(2, 12)), int(rng.integers(0, 20))
        out = []
        for m in (P, R):
            cluster = m.state.Cluster()
            cluster.add_provisioner(m.objects.Provisioner(meta=m.objects.ObjectMeta(name="default")))
            provider = m.cloud.FakeCloudProvider(catalog=m.cloud.generate_catalog(n_types=n_types))
            out.append(m.client.build_summary("us-east", "us-east", seq=2, epoch=1,
                                              provider=provider, cluster=cluster,
                                              launch_headroom=headroom))
        assert out[0] == out[1]
        assert 0 < out[0]["marginal_price"] < 1e17 and out[0]["headroom"] == headroom
        bare = P.client.build_summary("us-east", "us-east", seq=1, epoch=1)
        assert bare == R.client.build_summary("us-east", "us-east", seq=1, epoch=1)
        assert bare["marginal_price"] == 1e18 and bare["headroom"] == 0


class TestRegionAffinity:
    def _pod(self, m, name="p", annotations=None, labels=None):
        return m.objects.Pod(
            meta=m.objects.ObjectMeta(name=name, annotations=dict(annotations or {}),
                                      labels=dict(labels or {})),
            requests=m.res.Resources(cpu="100m", memory="128Mi"),
        )

    @pytest.mark.parametrize("raw", [None, " us-east , eu-west ", " , ", "*", "any", "us-west"])
    @pytest.mark.parametrize("where", ["annotation", "label"])
    def test_affinity_equal_in_both(self, raw, where):
        got = []
        for m in (P, R):
            kw = {} if raw is None else {f"{where}s": {m.wk.REGION_AFFINITY: raw}}
            got.append(m.client.region_affinity(self._pod(m, **kw)))
        assert got[0] == got[1]
        if raw == " us-east , eu-west ":
            assert got[0] == ["us-east", "eu-west"]

    def test_gang_affinity_is_first_annotated_member_name_sorted(self):
        for m in (P, R):
            pods = [
                self._pod(m, "c-late", annotations={m.wk.REGION_AFFINITY: "eu-west"}),
                self._pod(m, "a-first"),
                self._pod(m, "b-mid", annotations={m.wk.REGION_AFFINITY: "us-east"}),
            ]
            assert m.client.gang_region_affinity(pods) == ["us-east"]
            assert m.client.gang_region_affinity([self._pod(m, "a"), self._pod(m, "b")]) is None


class TestFailoverClone:
    def _bound_member(self, m, name, gang="train"):
        wk = m.wk
        pod = m.objects.Pod(
            meta=m.objects.ObjectMeta(
                name=name, labels={wk.POD_GROUP: gang},
                annotations={wk.POD_GROUP_MIN_MEMBERS: "2", wk.REGION_AFFINITY: "*"},
                owner_kind="Job"),
            requests=m.res.Resources(cpu="500m", memory="512Mi"),
        )
        pod.node_selector = {wk.ZONE: "us-east-1a", "team": "ml"}
        pod.node_name = "node-1"
        pod.phase = "Running"
        return pod

    def test_clones_equal_in_both(self):
        wire = []
        for m in (P, R):
            pod = self._bound_member(m, "train-0")
            clone = m.gang.failover_clone(pod, "us-east")
            assert clone.meta.uid != pod.meta.uid
            assert clone.phase == "Pending" and clone.node_name is None
            assert m.wk.ZONE not in clone.node_selector
            assert clone.node_selector["team"] == "ml"
            assert clone.meta.annotations[m.wk.FAILOVER_FROM] == "us-east"
            assert pod.node_name == "node-1" and pod.phase == "Running"
            codec = importlib.import_module(f"{m.pkg}.api.codec")
            w = codec.to_wire(clone)
            w["meta"].pop("uid", None)
            w["meta"].pop("creationTimestamp", None)
            wire.append(w)
        assert wire[0] == wire[1]

    def test_regional_failover_gangs_complete_and_sorted(self):
        for m in (P, R):
            pods = [self._bound_member(m, "b-1", gang="b"), self._bound_member(m, "a-1", gang="a"),
                    self._bound_member(m, "a-0", gang="a"),
                    m.objects.Pod(meta=m.objects.ObjectMeta(name="lone"),
                                  requests=m.res.Resources(cpu="100m"))]
            gangs = m.gang.regional_failover_gangs(pods, "us-east")
            assert list(gangs) == ["a", "b"]
            assert [p.meta.name for p in gangs["a"]] == ["a-0", "a-1"]
            assert all(p.phase == "Pending" for p in gangs["a"])


# ---------------------------------------------------------------------------
# the federated fleet
# ---------------------------------------------------------------------------

@pytest.fixture
def one_launch(monkeypatch):
    """Launches one machine at a time in plan order, in both packages."""
    for m in M.values():
        monkeypatch.setattr(m.cloud.FakeCloudProvider, "create_batched", None)


def _fleet(m, **kw):
    kw.setdefault("n_types", 6)
    kw.setdefault("settings_overrides", {"interruption_penalty_cost": 0.5})
    return m.fleet.FederatedFleet(**kw)


def replay_all(fleet, m):
    return fleet.replay_all(device="cpu") if m is P else fleet.replay_all()


def storm(m, gang_size=4, lone_pods=9, rounds=12, n_types=12, round_s=10.0,
          storm_fraction=0.5):
    """``bench.bench_federation_storm``'s fleet and timeline in package
    ``m``: three regions, a spot storm, a partition with a mid-partition
    gang, a blackout held past the sweep, a heal. Returns the fleet and the
    per-round pending counts."""
    regions = ("us-east", "us-west", "eu-west")
    fleet = m.fleet.FederatedFleet(regions=regions, n_types=n_types, round_s=round_s,
                                   settings_overrides={"interruption_penalty_cost": 0.5})
    for region in regions:
        fleet.add_gang(region, f"gang-{region}", members=gang_size, regions="*")
        fleet.add_pods(region, f"web-{region}", lone_pods)
    script = m.churn.federation_storm_script("us-east", "eu-west", "us-west", round_s=round_s,
                                             rounds=rounds, storm_fraction=storm_fraction)
    pending = []
    for r in range(rounds):
        if r == 2:
            fleet.add_gang("us-west", "gang-degraded", members=gang_size, regions="*")
        for ev in script.due(now=r * round_s):
            region = str(ev.get("region"))
            if ev.kind == "region-blackout":
                fleet.blackout(region)
            elif ev.kind == "region-heal":
                fleet.heal(region)
            elif ev.kind == "arbiter-partition":
                fleet.partition(region)
            elif ev.kind == "arbiter-heal":
                fleet.heal_partition(region)
            elif ev.kind == "regional-spot-storm":
                fleet.storm_spot(region, float(ev.get("fraction", 0.5)))
        fleet.run_round()
        pending.append(fleet.pending_total())
    return fleet, pending


def masked_fleet_capsule(capsule):
    c = roundtrip(capsule)
    c["sub_capsules"] = [dict(s, capsule=mask(s["capsule"])) for s in c["sub_capsules"]]
    return c


class TestFederatedFleet:
    def test_twin_storm_fleets_are_equal_round_by_round(self, one_launch):
        fleets = {}
        for pkg, m in M.items():
            m.prov._machine_ids = m.prov.MachineNameSeq()
            fleets[pkg] = storm(m)
        (port, p_pending), (ref, r_pending) = fleets[PORT], fleets[REF]
        assert p_pending == r_pending and max(p_pending) == 0
        assert port.costs == ref.costs
        assert [c["outputs"]["verdict"]["digest"] for c in port.capsules] == [
            c["outputs"]["verdict"]["digest"] for c in ref.capsules]
        assert [masked_fleet_capsule(c) for c in port.capsules] == [
            masked_fleet_capsule(c) for c in ref.capsules]
        assert port.failover_gangs == ref.failover_gangs and port.failover_gangs
        assert port.degraded_rounds == ref.degraded_rounds >= 1
        assert port.audit_violations == ref.audit_violations == []
        assert all(port.gang_whole_in_one_cluster(g) for g in port.failover_gangs)
        # the port replays both packages' federation capsules with match
        for fleet in (port, ref):
            for capsule in fleet.capsules:
                report = P.replay.replay_capsule(roundtrip(capsule), device="cpu")
                assert report["match"], report["diffs"]

    def test_configs_storm_equals_the_references_bench(self, one_launch):
        from karpenter_tpu_torch import configs

        P.prov._machine_ids = P.prov.MachineNameSeq()
        report, fleet = configs.federation_storm(device="cpu")
        R.prov._machine_ids = R.prov.MachineNameSeq()
        want = bench.bench_federation_storm()
        assert report == want
        assert report["fed_zero_unschedulable"] and report["fed_gangs_reentered_whole"]
        assert report["within_cost_band"] and report["fed_replay_all_matched"]
        assert report["audit_violations"] == 0 and len(fleet.capsules) == 12

    def test_steady_state_binds_everything_and_replays(self):
        fleet = _fleet(P)
        fleet.add_gang("us-east", "train", members=3)
        fleet.add_pods("us-west", "web", 4)
        for _ in range(2):
            fleet.run_round()
        assert fleet.pending_total() == 0 and fleet.gang_whole_in_one_cluster("train")
        assert fleet.audit_violations == []
        reports = replay_all(fleet, P)
        assert reports and all(r["match"] for r in reports)

    def test_partition_degrades_locally_and_heals(self):
        fleet = _fleet(P)
        fleet.add_pods("us-east", "seed", 2)
        fleet.run_round()
        fleet.partition("us-west")
        fleet.add_gang("us-west", "cut-off", members=2, regions="*")
        fleet.run_round()
        assert fleet.degraded_rounds >= 1
        assert fleet.regions["us-west"].client.mode == "degraded"
        assert fleet.gang_whole_in_one_cluster("cut-off") and fleet.pending_total() == 0
        fleet.heal_partition("us-west")
        fleet.run_round()
        assert fleet.regions["us-west"].client.mode == "federated"
        degraded = [r for r in replay_all(fleet, P)
                    if r["diffs"].get("degraded_assignments", 0) > 0]
        assert degraded and all(r["match"] for r in degraded)

    def test_blackout_fails_gangs_over_whole_and_heal_fences(self):
        fleet = _fleet(P)
        fleet.add_gang("eu-west", "train", members=3, regions="*")
        fleet.add_pods("eu-west", "solo", 2, regions="*")
        fleet.run_round()
        epoch_before = fleet.arbiter.epoch
        fleet.blackout("eu-west")
        for _ in range(3):
            fleet.run_round()
        assert fleet.arbiter.epoch > epoch_before and "train" in fleet.failover_gangs
        assert fleet.gang_whole_in_one_cluster("train") and fleet.pending_total() == 0
        refugees = [p for rc in fleet.regions.values() if not rc.blacked_out
                    for p in rc.cluster.pods.values()
                    if p.meta.annotations.get(P.wk.FAILOVER_FROM) == "eu-west"]
        assert len(refugees) == 5
        lost_epoch = fleet.arbiter.epoch
        fleet.heal("eu-west")
        fleet.run_round()
        assert fleet.arbiter.epoch > lost_epoch
        assert fleet.regions["eu-west"].cluster.pods == {}
        assert fleet.gang_whole_in_one_cluster("train") and fleet.audit_violations == []
        reports = replay_all(fleet, P)
        assert all(r["match"] for r in reports)
        assert any(r["epoch"] == fleet.arbiter.epoch for r in reports)


# ---------------------------------------------------------------------------
# federated replay: counterfactuals, the CLI, both packages' capsules
# ---------------------------------------------------------------------------

def captured_capsule(m):
    fleet = _fleet(m)
    fleet.add_gang("us-east", "train", members=2, regions="*")
    capsule = fleet.run_round()
    granted = [a for a in capsule["outputs"]["verdict"]["assignments"]
               if a["outcome"] in ("granted", "renewed")]
    assert granted
    return roundtrip(capsule), granted[0]["target"]


class TestFederatedReplayOverrides:
    @pytest.mark.parametrize("source", PACKAGES)
    def test_counterfactuals_on_either_packages_capsule(self, source):
        capsule, target = captured_capsule(M[source])
        replay = P.replay.replay_capsule
        report = replay(dict(capsule), overrides=[f"cluster.{target}.available=false"],
                        device="cpu")
        assert report["counterfactual"] is True
        assert all(a["target"] != target
                   for a in report["replayed"]["verdict"]["assignments"])
        report = replay(dict(capsule), overrides=[f"cluster.{target}.risk.*=0.9"], device="cpu")
        assert any(d["from"] == target for d in report["replayed"]["verdict"]["rebalance"])
        # the same counterfactual in the reference: the same verdict
        want = R.replay.replay_capsule(dict(capsule),
                                       overrides=[f"cluster.{target}.risk.*=0.9"])
        assert report["replayed"]["verdict"] == want["replayed"]["verdict"]

    def test_bad_selectors_rejected(self):
        capsule, _ = captured_capsule(P)
        with pytest.raises(P.replay.OverrideError, match="unknown cluster"):
            P.replay.replay_capsule(dict(capsule), overrides=["cluster.mars.available=false"],
                                    device="cpu")
        with pytest.raises(P.replay.OverrideError, match="available or risk"):
            P.replay.replay_capsule(dict(capsule), overrides=["cluster.us-east.color=blue"],
                                    device="cpu")
        sub = capsule["sub_capsules"][0]["capsule"]
        with pytest.raises(P.replay.OverrideError, match="federation capsules only"):
            P.replay.replay_capsule(dict(sub), overrides=["cluster.us-east.available=false"],
                                    device="cpu")

    @pytest.mark.parametrize("source", PACKAGES)
    def test_cli_replays_either_packages_capsule(self, source, tmp_path, capsys):
        capsule, _ = captured_capsule(M[source])
        path = tmp_path / "fed.json"
        path.write_text(json.dumps(capsule))
        assert P.replay.main([str(path), "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "(federation): MATCH" in out and "sub_capsules_match=True" in out
        assert "verdict digest:" in out
        # a tampered verdict diverges: exit 2
        capsule["outputs"]["verdict"]["digest"] = "0" * 64
        path.write_text(json.dumps(capsule))
        assert P.replay.main([str(path), "--device", "cpu"]) == 2


# ---------------------------------------------------------------------------
# metrics exporter, churn DSL, settings, /debug, HTTP
# ---------------------------------------------------------------------------

class TestFederationMetrics:
    def test_summary_age_series_track_and_prune_members(self):
        metrics = P.metrics
        clock = P.cache.FakeClock(0.0)
        arb = P.arbiter.FederationArbiter(clock=clock)
        arb.submit_summary(_summary("us-east", seq=1))
        clock.step(4.0)
        arb.submit_summary(_summary("eu-west", seq=1))
        clock.step(2.0)
        metrics.REGISTRY.exposition()
        assert metrics.FEDERATION_SUMMARY_AGE.value({"cluster": "us-east"}) == pytest.approx(6.0)
        assert metrics.FEDERATION_SUMMARY_AGE.value({"cluster": "eu-west"}) == pytest.approx(2.0)
        assert metrics.FEDERATION_EPOCH.value() == float(arb.epoch)
        arb2 = P.arbiter.FederationArbiter(clock=clock)
        arb2.submit_summary(_summary("ap-south", seq=1))
        metrics.REGISTRY.exposition()
        exposed = metrics.FEDERATION_SUMMARY_AGE.collect()
        assert any("ap-south" in line for line in exposed)
        assert not any("us-east" in line for line in exposed)
        P.arbiter.install_federation_exporter(None)
        metrics.REGISTRY.exposition()
        assert not any("cluster" in line for line in metrics.FEDERATION_SUMMARY_AGE.collect()
                       if not line.startswith("#"))


class TestFederationChurn:
    def test_storm_script_equal_in_both_and_guarded(self):
        def gen(m):
            return [(e.t, e.kind, dict(e.params)) for e in m.churn.federation_storm_script(
                "us-east", "eu-west", "us-west", round_s=10.0, rounds=12,
                clock=lambda: 0.0).due(now=1e9)]

        events = gen(P)
        assert events == gen(R)
        kinds = [k for _, k, _ in events]
        assert kinds.count("region-blackout") == kinds.count("region-heal") == 1
        with pytest.raises(ValueError, match="does not fit"):
            P.churn.federation_storm_script("us-east", "eu-west", "us-west", round_s=10.0,
                                            rounds=5, clock=lambda: 0.0)


class TestFederationSettings:
    def test_enabled_requires_endpoint_and_knob_ranges(self):
        S = P.settings.Settings
        S(federation_enabled=True, arbiter_endpoint="http://a:1").validate()
        with pytest.raises(ValueError, match="arbiterEndpoint"):
            S(federation_enabled=True).validate()
        with pytest.raises(ValueError, match="leaseTtlS"):
            S(lease_ttl_s=0).validate()
        with pytest.raises(ValueError, match="summaryIntervalS"):
            S(summary_interval_s=-1).validate()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as r:
        return json.loads(r.read())


class TestDebugFederationEndpoint:
    def test_serves_client_status_when_wired_and_disabled_otherwise(self):
        clock = P.cache.FakeClock(0.0)
        arb = P.arbiter.FederationArbiter(clock=clock)
        client = P.client.FederationClient(
            "us-east", transport=P.client.DirectArbiterTransport(arb), clock=clock)
        client.push_summary(launch_headroom=2)
        for federation, want in ((client.status, "federated"), (None, None)):
            server = P.http.OperatorHTTPServer(port=0, federation=federation).start()
            try:
                payload = _get(server.port, "/debug/federation")
                if want is None:
                    assert payload == {"enabled": False}
                else:
                    assert payload["enabled"] is True and payload["mode"] == want
                    assert set(payload["breakers"]) == set(P.client.ROUTES)
            finally:
                server.stop()


@pytest.mark.parametrize("client_pkg, server_pkg",
                         [(PORT, PORT), (PORT, REF), (REF, PORT)],
                         ids=["port-port", "port-client-ref-server", "ref-client-port-server"])
class TestArbiterHTTPServerE2E:
    def test_client_drives_the_real_wire(self, client_pkg, server_pkg):
        cm, sm = M[client_pkg], M[server_pkg]
        clock = sm.cache.FakeClock(0.0)
        arb = sm.arbiter.FederationArbiter(clock=clock)
        server = sm.server.ArbiterHTTPServer(arb, port=0).start()
        try:
            arb.submit_summary(_summary("eu-west", seq=1, price=0.02))
            client = cm.client.FederationClient("us-east", endpoint=server.endpoint,
                                                clock=cm.cache.FakeClock(0.0))
            assert client.push_summary() is True
            lease = client.request_lease("train", ["*"], gang="train", units=2)
            assert lease is not None and lease["target"] == "eu-west"
            assert client.confirm(lease["token"]) is True
            state = _get(server.port, "/v1/state")
            assert set(state["members"]) == {"us-east", "eu-west"}
            assert [le["token"] for le in state["leases"]] == ["us-east/train"]
            arb.declare_lost("eu-west")
            assert client.confirm(lease["token"]) is False
            assert client.epoch_seen == arb.epoch
            with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/healthz") as r:
                assert r.read() == b"ok\n"
        finally:
            server.stop()

    def test_missing_token_and_unknown_routes_rejected(self, client_pkg, server_pkg):
        sm = M[server_pkg]
        server = sm.server.ArbiterHTTPServer(sm.arbiter.FederationArbiter(
            clock=sm.cache.FakeClock(0.0)), port=0).start()
        try:
            req = urllib.request.Request(f"http://127.0.0.1:{server.port}/v1/lease",
                                         data=b"{}", method="POST",
                                         headers={"Content-Type": "application/json"})
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(req)
            assert err.value.code == 400
            with pytest.raises(urllib.error.HTTPError) as err:
                _get(server.port, "/v1/nope")
            assert err.value.code == 404
        finally:
            server.stop()


# ---------------------------------------------------------------------------
# operator wiring
# ---------------------------------------------------------------------------

def federated_twin(m, arbiter, name, pods, **settings_kw):
    """One package's operator with ``federation_enabled``, its client on
    ``DirectArbiterTransport(arbiter)`` (the operator builds an HTTP client
    for ``arbiter_endpoint``; the twin swaps the transport, as the fleet
    harness does), ``pods`` pending."""
    settings = m.settings.Settings(
        cluster_name=name, federation_enabled=True, arbiter_endpoint="http://127.0.0.1:1",
        interruption_queue_name="q", batch_idle_duration=0, batch_max_duration=0,
        consolidation_validation_ttl=0, stabilization_window=0.0, **settings_kw)
    clock = m.cache.FakeClock(start=CLOCK_START)
    provider = m.cloud.FakeCloudProvider(catalog=m.cloud.generate_catalog(n_types=12))
    provider.create_batched = None
    op = new_operator(m, provider, settings, clock)
    op.federation.transport = m.client.DirectArbiterTransport(arbiter)
    # breakers on the arbiter's fake clock: the heal's probe is then a step
    # of that clock, not ten seconds of the wall's
    op.federation.breakers = importlib.import_module(f"{m.pkg}.utils.resilience").BreakerSet(
        "federation-arbiter", failure_threshold=3, recovery_timeout_s=10.0,
        clock=arbiter.clock.now)
    op.cluster.add_provisioner(m.objects.Provisioner(meta=m.objects.ObjectMeta(name="default")))
    for pod in pods:
        op.cluster.add_pod(pod)
    return op


def affinity_pods(m, prefix, n, seed, regions="*"):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ann = {m.wk.REGION_AFFINITY: regions} if rng.random() < 0.7 else {}
        out.append(m.objects.Pod(
            meta=m.objects.ObjectMeta(name=f"{prefix}-{i}", annotations=ann,
                                      owner_kind="ReplicaSet"),
            requests=m.res.Resources(cpu=f"{int(rng.choice([250, 500, 1000]))}m",
                                     memory=f"{int(rng.choice([256, 512, 1024]))}Mi")))
    return out


class TestOperatorWiring:
    def test_new_wires_client_into_the_control_loops(self):
        settings = P.settings.Settings(
            cluster_name="us-east", federation_enabled=True,
            arbiter_endpoint="http://127.0.0.1:1", interruption_queue_name="q",
            batch_idle_duration=0, batch_max_duration=0)
        op = P.operator.Operator.new(
            provider=P.cloud.FakeCloudProvider(catalog=P.cloud.generate_catalog(n_types=4)),
            settings=settings, device="cpu")
        try:
            assert op.federation is not None and op.federation.cluster_name == "us-east"
            assert op.provisioning.federation is op.federation
            assert op.interruption.federation is op.federation
            assert isinstance(op.federation.transport, P.client.HTTPArbiterTransport)
        finally:
            op.close()

    def test_disabled_by_default(self):
        op = P.operator.Operator.new(
            provider=P.cloud.FakeCloudProvider(catalog=P.cloud.generate_catalog(n_types=4)),
            settings=P.settings.Settings(batch_idle_duration=0, batch_max_duration=0),
            device="cpu")
        try:
            assert op.federation is None and op.provisioning.federation is None
        finally:
            op.close()

    def test_twin_federated_operators_step_alike(self, one_worker, one_launch):
        """Twin operators in each package, federated through their own
        package's arbiter over ``DirectArbiterTransport``: the same leases,
        outcomes, degraded log, bindings and epochs step by step, through a
        partition of the arbiter link and its heal."""
        trace = {}
        for pkg, m in M.items():
            m.prov._machine_ids = m.prov.MachineNameSeq()
            clock = m.cache.FakeClock(0.0)
            arbiter = m.arbiter.FederationArbiter(clock=clock)
            op = federated_twin(m, arbiter, "us-east", affinity_pods(m, "web", 40, 7))
            steps = []
            try:
                for s in range(4):
                    if s == 1:
                        op.federation.transport.partitioned = True
                        for pod in affinity_pods(m, f"late{s}", 12, 8 + s):
                            op.cluster.add_pod(pod)
                    if s == 3:
                        op.federation.transport.partitioned = False
                        clock.step(11.0)
                        for pod in affinity_pods(m, f"late{s}", 12, 8 + s):
                            op.cluster.add_pod(pod)
                    op.federation.push_summary(launch_headroom=100)
                    arbiter.begin_round()
                    op.step()
                    status = op.federation.status()
                    bound = sorted((p.name, p.node_name is not None)
                                   for p in op.cluster.pods.values())
                    _, verdict = arbiter.round_capsule_parts(op.federation.drain_degraded_log())
                    steps.append(roundtrip(dict(
                        mode=status["mode"], leases=status["leases"], epoch=arbiter.epoch,
                        verdict=verdict, bound=bound, pending=len(op.cluster.pending_pods()),
                        nodes=len(op.cluster.nodes))))
            finally:
                op.close()
            trace[pkg] = steps
        assert trace[PORT] == trace[REF]
        modes = [s["mode"] for s in trace[PORT]]
        assert modes[1] == "degraded" and modes[-1] == "federated"
        assert any(a["outcome"] == "degraded-local"
                   for s in trace[PORT] for a in s["verdict"]["assignments"])
        assert trace[PORT][-1]["pending"] == 0


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
