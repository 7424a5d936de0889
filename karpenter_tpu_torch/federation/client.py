"""FederationClient: one cluster's advisory link to the global arbiter.

A copy of ``karpenter_tpu/federation/client.py``, with no difference: it
rides the port's ``utils/resilience.py``, and its wire is the reference's,
so each package's client talks to the other package's ``ArbiterHTTPServer``.

Every arbiter dependency rides the resilience stack (``utils/
resilience``): jittered retries under a per-route circuit breaker. The
breaker set is keyed by route TEMPLATE ("POST /v1/summary", "POST
/v1/lease", ...), NOT by concrete URL — the HTTPCluster hardening: raw
per-token paths would mint one breaker per pod, each seeing ~1 call, so no
breaker could ever accumulate enough consecutive failures to open and the
degradation path would never engage. With template keys the breaker
cardinality is the (tiny, fixed) route count per cluster.

Degradation contract: any failure — transport error, retries exhausted,
breaker open — flips the client to ``degraded`` and every answer becomes
"schedule locally". The provisioning gate treats a degraded client exactly
like no client at all, so a partitioned cluster behaves byte-for-byte like
today's single-cluster system. Degraded routing decisions are logged
(``drain_degraded_log``) so the fleet can fold them into the federation
capsule — degraded rounds replay too.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional, Sequence

from ..api import labels as wk
from ..utils.cache import Clock
from ..utils.resilience import (
    BreakerSet,
    CircuitOpenError,
    RetryPolicy,
    resilient_call,
)

#: the arbiter's route templates — the full breaker key space per cluster
ROUTE_SUMMARY = "POST /v1/summary"
ROUTE_LEASE = "POST /v1/lease"
ROUTE_CONFIRM = "POST /v1/lease/confirm"
ROUTE_STATE = "GET /v1/state"
ROUTES = (ROUTE_SUMMARY, ROUTE_LEASE, ROUTE_CONFIRM, ROUTE_STATE)


class FederationUnavailable(Exception):
    """The arbiter could not be reached (transport failure or open breaker);
    the caller must fall back to local autonomy."""


def region_affinity(pod) -> Optional[List[str]]:
    """The pod's ``karpenter.tpu/region-affinity`` requirement: a comma-
    separated region list, or "*"/"any" for anywhere. None (no annotation
    and no label) means the pod is single-region — the federation gate never
    touches it. Whitespace-tolerant; empty values read as absent."""
    raw = pod.meta.annotations.get(wk.REGION_AFFINITY) or pod.meta.labels.get(
        wk.REGION_AFFINITY
    )
    if not raw:
        return None
    regions = [r.strip() for r in str(raw).split(",") if r.strip()]
    return regions or None


def gang_region_affinity(pods: Sequence) -> Optional[List[str]]:
    """A gang's affinity is its name-sorted first annotated member's (the
    gang_adjacency_mode convention — deterministic under conflicts)."""
    for p in sorted(pods, key=lambda p: p.meta.name):
        regions = region_affinity(p)
        if regions is not None:
            return regions
    return None


def build_summary(
    cluster_name: str,
    region: str,
    seq: int,
    epoch: int,
    provider=None,
    cluster=None,
    risk_cache=None,
    launch_headroom: Optional[int] = None,
    clock: Optional[Clock] = None,
    cost_ledger=None,
) -> Dict:
    """One capacity summary: the cluster's residue marginal price (cheapest
    available offering — the same crude dual the sharded arbitration orders cells
    by), per-zone price breakdown, risk-cache pool estimates, launch
    headroom, and — when the cluster runs a cost ledger — its realized
    spend/burn so the arbiter routes on actual burn rather than marginal
    price alone. Pure read — nothing here mutates provider or cluster state
    (the ledger settle only closes its own open segments at "now")."""
    marginal = float("inf")
    per_zone: Dict[str, float] = {}
    if provider is not None and cluster is not None:
        for prov in cluster.provisioners.values():
            for it in provider.get_instance_types(prov):
                for o in it.offerings:
                    if not o.available:
                        continue
                    if o.price < marginal:
                        marginal = o.price
                    cur = per_zone.get(o.zone)
                    if cur is None or o.price < cur:
                        per_zone[o.zone] = o.price
    risk: Dict[str, float] = {}
    risk_peak = 0.0
    if risk_cache is not None:
        for it_name, zone, ct, p in risk_cache.entries():
            risk[f"{it_name}/{zone}/{ct}"] = round(p, 6)
            risk_peak = max(risk_peak, p)
    summary = {
        "cluster": cluster_name,
        "region": region,
        "seq": int(seq),
        "epoch": int(epoch),
        "marginal_price": (
            round(marginal, 6) if marginal != float("inf") else None
        ),
        "per_zone_price": {z: round(p, 6) for z, p in sorted(per_zone.items())},
        "risk": dict(sorted(risk.items())),
        "risk_peak": round(risk_peak, 6),
        "headroom": launch_headroom,
    }
    if cost_ledger is not None:
        summary["cost"] = cost_ledger.federation_fields()
    if clock is not None:
        summary["time"] = round(clock.now(), 6)
    if summary["marginal_price"] is None:
        # a cluster with no available offerings cannot host anything
        summary["marginal_price"] = float("1e18")
        summary["headroom"] = 0
    return summary


class HTTPArbiterTransport:
    """Default transport: the route template plus endpoint base URL become a
    stdlib urllib call. Kept trivially small — all resilience lives in the
    client's retry/breaker layer, exactly like HTTPCluster."""

    def __init__(self, endpoint: str, timeout_s: float = 5.0):
        self.endpoint = endpoint.rstrip("/")
        self.timeout_s = timeout_s

    def __call__(self, route: str, body: Optional[Dict]) -> Dict:
        method, _, path = route.partition(" ")
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            f"{self.endpoint}{path}", data=data, method=method,
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                return json.loads(resp.read() or b"{}")
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            raise ConnectionError(f"arbiter {route}: {e}") from e


class DirectArbiterTransport:
    """In-process transport for the fleet harness and tests: dispatches
    route templates straight onto a FederationArbiter, with a partition
    switch that fails every call like a dead network would — the breaker
    and degradation paths exercise for real, minus the sockets."""

    def __init__(self, arbiter):
        self.arbiter = arbiter
        self.partitioned = False

    def __call__(self, route: str, body: Optional[Dict]) -> Dict:
        if self.partitioned:
            raise ConnectionError(f"arbiter {route}: partitioned")
        if route == ROUTE_SUMMARY:
            return self.arbiter.submit_summary(body or {})
        if route == ROUTE_LEASE:
            return self.arbiter.request_lease(body or {})
        if route == ROUTE_CONFIRM:
            return self.arbiter.confirm_lease(
                (body or {}).get("token", ""), (body or {}).get("epoch")
            )
        if route == ROUTE_STATE:
            return self.arbiter.state()
        raise ValueError(f"unknown arbiter route {route!r}")


class FederationClient:
    """Per-cluster arbiter link: pushes summaries, requests/confirms leases,
    degrades to local autonomy behind its breaker set."""

    def __init__(
        self,
        cluster_name: str,
        region: Optional[str] = None,
        endpoint: str = "",
        transport: Optional[Callable] = None,
        settings=None,
        clock: Optional[Clock] = None,
        provider=None,
        cluster=None,
        risk_cache=None,
        retry_policy: Optional[RetryPolicy] = None,
        failure_threshold: int = 3,
        recovery_timeout_s: float = 10.0,
        breaker_clock=None,
        cost_ledger=None,
    ):
        self.cluster_name = cluster_name
        self.region = region or cluster_name
        self.clock = clock or Clock()
        self.provider = provider
        self.cluster = cluster
        self.risk_cache = risk_cache
        self.cost_ledger = cost_ledger
        self.lease_ttl_s = (
            float(getattr(settings, "lease_ttl_s", 30.0)) if settings else 30.0
        )
        if transport is None:
            transport = HTTPArbiterTransport(endpoint) if endpoint else None
        self.transport = transport
        # fewer attempts than the apiserver path: the arbiter is ADVISORY —
        # blocking a reconcile on a long retry ladder against a dead arbiter
        # would violate "schedules exactly like the single-cluster system"
        self.retry_policy = retry_policy or RetryPolicy(max_attempts=2)
        # route-TEMPLATE breaker keys, per cluster (this object is per
        # cluster): bounded cardinality, and every summary/lease failure
        # lands on the same breaker so it can actually trip
        breaker_kw = {"clock": breaker_clock} if breaker_clock is not None else {}
        self.breakers = BreakerSet(
            "federation-arbiter", failure_threshold=failure_threshold,
            recovery_timeout_s=recovery_timeout_s, **breaker_kw,
        )
        self._seq = 0
        self._token_seq = 0
        self.epoch_seen = 0
        self.leases: Dict[str, Dict] = {}
        self.last_error: Optional[str] = None
        self._degraded_log: List[Dict] = []
        self.summaries_pushed = 0
        self.summaries_failed = 0

    # -- transport with resilience -------------------------------------------
    def _call(self, route: str, body: Optional[Dict]) -> Dict:
        if self.transport is None:
            raise FederationUnavailable("no arbiter transport configured")
        breaker = self.breakers.get(route)
        try:
            result = resilient_call(
                lambda: self.transport(route, body),
                policy=self.retry_policy,
                breaker=breaker,
                service="federation-arbiter",
                endpoint=route,
            )
        except CircuitOpenError as e:
            self.last_error = f"breaker-open {route}"
            raise FederationUnavailable(str(e)) from e
        except Exception as e:
            self.last_error = f"{type(e).__name__}: {e}"
            raise FederationUnavailable(str(e)) from e
        self.last_error = None
        if "epoch" in result:
            self.epoch_seen = int(result["epoch"])
        return result

    @property
    def mode(self) -> str:
        """"federated" or "degraded" — degraded while ANY route breaker is
        OPEN or the last call failed. Half-open does not count: it means
        the recovery timeout elapsed and the next call is a probe — an
        idle route must not pin a healed cluster degraded forever."""
        if self.last_error is not None:
            return "degraded"
        for route in ROUTES:
            if self.breakers.get(route).state == "open":
                return "degraded"
        return "federated"

    # -- summaries -------------------------------------------------------------
    def push_summary(self, launch_headroom: Optional[int] = None) -> bool:
        """Build and push one capacity summary; False (degraded) on any
        failure. The seq increments even on failure — the arbiter must
        never mistake a post-partition push for a stale retransmit."""
        self._seq += 1
        summary = build_summary(
            self.cluster_name, self.region, self._seq, self.epoch_seen,
            provider=self.provider, cluster=self.cluster,
            risk_cache=self.risk_cache, launch_headroom=launch_headroom,
            clock=self.clock, cost_ledger=self.cost_ledger,
        )
        try:
            self._call(ROUTE_SUMMARY, summary)
        except FederationUnavailable:
            self.summaries_failed += 1
            return False
        self.summaries_pushed += 1
        return True

    def tick(self) -> None:
        """Operator-loop cadence hook (``summary_interval_s``)."""
        self.push_summary()

    # -- leases ----------------------------------------------------------------
    def mint_token(self, unit: str) -> str:
        """Stable per-unit client token: retries of the same unit reuse it
        (arbiter-side idempotence), distinct units never collide."""
        return f"{self.cluster_name}/{unit}"

    def request_lease(
        self,
        unit: str,
        regions: Sequence[str],
        gang: Optional[str] = None,
        units: int = 1,
    ) -> Optional[Dict]:
        """A placement lease for one unit (pod or whole gang), or None when
        the arbiter is unreachable (degraded → schedule locally) or has no
        capacity. Degraded decisions are logged for the federation capsule."""
        token = self.mint_token(unit)
        req = {
            "token": token, "unit": unit, "cluster": self.cluster_name,
            "gang": gang, "regions": list(regions), "units": int(units),
        }
        try:
            result = self._call(ROUTE_LEASE, req)
        except FederationUnavailable:
            self._degraded_log.append({**req, "degraded": True})
            return None
        if result.get("outcome") in ("granted", "renewed"):
            lease = result.get("lease") or {
                "token": token, "target": result.get("target"),
                "epoch": result.get("epoch", self.epoch_seen),
            }
            self.leases[token] = lease
            return lease
        return None

    def confirm(self, token: str) -> bool:
        """Fence check before any launch on behalf of a lease. Unreachable
        arbiter → NOT confirmed: a remote launch without a live fence is
        exactly the double-launch the epoch exists to prevent (a LOCAL
        launch needs no confirmation — local autonomy is always safe)."""
        lease = self.leases.get(token)
        body = {"token": token, "epoch": lease["epoch"] if lease else None}
        try:
            result = self._call(ROUTE_CONFIRM, body)
        except FederationUnavailable:
            return False
        if not result.get("valid", False):
            self.leases.pop(token, None)
            return False
        return True

    def drain_degraded_log(self) -> List[Dict]:
        """The round's degraded (locally-authorized) routing decisions —
        folded into the federation capsule so degraded rounds replay."""
        out, self._degraded_log = self._degraded_log, []
        return out

    # -- advisory risk feed ----------------------------------------------------
    def note_regional_risk(self, kind: str, pool) -> None:
        """Interruption-controller hook: realized reclaims/rebalances feed
        the NEXT summary (through the shared risk cache) — nothing to send
        eagerly, but the hook point keeps the coupling explicit and lets
        tests observe the feed."""
        # the risk cache the summary reads is the same object the
        # interruption controller records into; this is intentionally a
        # no-op beyond bookkeeping
        self._last_risk_note = (kind, tuple(pool))

    # -- observability ---------------------------------------------------------
    def status(self) -> Dict:
        """The /debug/federation payload."""
        return {
            "enabled": True,
            "cluster": self.cluster_name,
            "region": self.region,
            "mode": self.mode,
            "epoch_seen": self.epoch_seen,
            "summaries_pushed": self.summaries_pushed,
            "summaries_failed": self.summaries_failed,
            "last_error": self.last_error,
            "breakers": {
                route: self.breakers.get(route).state for route in ROUTES
            },
            "leases": [
                dict(lease) for _, lease in sorted(self.leases.items())
            ],
        }
