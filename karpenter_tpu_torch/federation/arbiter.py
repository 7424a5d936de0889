"""FederationArbiter: summaries in, epoch-fenced placement leases out.

A copy of ``karpenter_tpu/federation/arbiter.py``, with no difference: the
pure verdict (``arbiter_verdict``), its digest and the arbiter's state
machine are the reference's, so either package's federation capsule
replays here byte for byte. Its metrics are the port's ``FEDERATION_*``
series (``utils/metrics.py``).

The arbiter is deliberately small and deliberately PURE at its core: one
round's routing verdict is a deterministic function of (member summaries,
availability, epoch, the ordered request list, the pre-round lease table,
now) — ``arbiter_verdict`` — and the live request path runs the same
``_process_request`` the replay does, so a recorded federation capsule
replays byte-identically including degraded (arbiter-partitioned) rounds.

Summary intake is defensive by construction: each cluster stamps its
summaries with a monotonically increasing ``seq``, and the arbiter drops
duplicates, reordered deliveries and stale retransmits on the floor
(outcome ``stale-seq``) — the partition/reorder property test feeds it
adversarial delivery schedules and asserts the member view converges to the
per-cluster maxima.

Lease fencing: ``epoch`` bumps on every membership transition (lost region,
rejoined region). A lease carries the epoch it was minted under plus a TTL;
``confirm_lease`` rejects any lease from another epoch (``fenced``) or past
its expiry (``expired``). Requests are idempotent on their client token — a
retried RPC gets the SAME lease back (``renewed``), never a second target.
"""

from __future__ import annotations

import hashlib
import json
import threading
from typing import Dict, List, Optional, Tuple

from ..utils import metrics
from ..utils.cache import Clock

#: default knobs (settings lease_ttl_s / summary_interval_s feed the real
#: operator wiring; the fleet/tests pass explicit values)
DEFAULT_LEASE_TTL_S = 30.0
DEFAULT_SUMMARY_STALE_S = 30.0
#: a member whose risk-cache peak estimate crosses this is a rebalance
#: source; a target must sit below half of it (hysteresis — two mid-risk
#: regions must not ping-pong capacity at the threshold)
RISK_SPIKE_THRESHOLD = 0.5


def _canonical(obj) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


def verdict_digest(verdict: Dict) -> str:
    """sha256 over the canonical verdict body (assignments + rebalance +
    epoch) — the byte-identity the federated replay compares."""
    body = {
        "epoch": verdict.get("epoch"),
        "assignments": verdict.get("assignments", []),
        "rebalance": verdict.get("rebalance", []),
    }
    return hashlib.sha256(_canonical(body)).hexdigest()


def _score(summary: Dict) -> float:
    """Risk-adjusted marginal price: the cluster's cheapest-offering dual
    inflated by its peak pool-risk estimate. Deterministic and unitless
    enough for ordering — the arbiter ranks, it does not bill."""
    price = float(summary.get("marginal_price", float("inf")))
    risk = float(summary.get("risk_peak", 0.0))
    return price * (1.0 + risk)


def _choose_target(
    summaries: Dict[str, Dict],
    available: Dict[str, bool],
    regions: List[str],
    units: int,
) -> Optional[str]:
    """The cheapest available, eligible, non-exhausted cluster; ties break on
    name so the verdict is order-free of dict iteration."""
    wildcard = not regions or "*" in regions or "any" in regions
    candidates: List[Tuple[float, str]] = []
    for name, s in summaries.items():
        if not available.get(name, False):
            continue
        if not wildcard and s.get("region", name) not in regions:
            continue
        headroom = s.get("headroom")
        if headroom is not None and headroom < max(units, 1):
            continue
        candidates.append((_score(s), name))
    if not candidates:
        return None
    return min(candidates)[1]


def _process_request(
    state: Dict,
    req: Dict,
    now: float,
    lease_ttl_s: float,
) -> Dict:
    """One lease request against the (mutable) round state. Shared verbatim
    by the live arbiter and the capsule replay — the only place routing
    outcomes are decided. ``state`` = {"epoch", "summaries", "available",
    "leases": {token: lease}}."""
    token = req["token"]
    out = {
        "token": token,
        "unit": req.get("unit", token),
        "home": req.get("cluster", ""),
        "gang": req.get("gang"),
    }
    if req.get("degraded"):
        # the requesting cluster was partitioned from the arbiter this
        # round: it scheduled locally on its own authority. Recorded so the
        # verdict (and its digest) covers degraded rounds byte-identically.
        out["outcome"] = "degraded-local"
        out["target"] = req.get("cluster", "")
        return out
    epoch = state["epoch"]
    existing = state["leases"].get(token)
    if (
        existing is not None
        and existing["epoch"] == epoch
        and existing["expires_at"] > now
    ):
        out["outcome"] = "renewed"
        out["target"] = existing["target"]
        out["lease"] = existing
        return out
    target = _choose_target(
        state["summaries"], state["available"],
        list(req.get("regions", ["*"])), int(req.get("units", 1)),
    )
    if target is None:
        out["outcome"] = "no-capacity"
        out["target"] = None
        return out
    lease = {
        "token": token,
        "target": target,
        "epoch": epoch,
        "expires_at": round(now + lease_ttl_s, 6),
    }
    state["leases"][token] = lease
    out["outcome"] = "granted"
    out["target"] = target
    out["lease"] = lease
    return out


def _rebalance_directives(
    summaries: Dict[str, Dict], available: Dict[str, bool]
) -> List[Dict]:
    """Proactive cross-region rebalance: every available member whose peak
    risk estimate spiked above threshold pairs with the cheapest available
    member at < half the threshold (hysteresis). Advisory — consumers move
    NEW capacity, never drain on the arbiter's word alone."""
    calm = {
        n: s for n, s in summaries.items()
        if available.get(n, False)
        and float(s.get("risk_peak", 0.0)) < RISK_SPIKE_THRESHOLD / 2.0
    }
    out: List[Dict] = []
    for name in sorted(summaries):
        s = summaries[name]
        if not available.get(name, False):
            continue
        risk = float(s.get("risk_peak", 0.0))
        if risk < RISK_SPIKE_THRESHOLD:
            continue
        targets = {n: s2 for n, s2 in calm.items() if n != name}
        if not targets:
            continue
        to = min((_score(s2), n) for n, s2 in targets.items())[1]
        out.append({
            "from": name, "to": to, "reason": "risk-spike",
            "risk": round(risk, 6),
        })
    return out


def arbiter_verdict(inputs: Dict) -> Dict:
    """The PURE round verdict the federated replay re-runs: rebuilds the
    arbiter's decision state from recorded inputs and processes the recorded
    requests in recorded order. ``inputs`` = {"epoch", "summaries",
    "available", "leases_before", "requests", "now", "lease_ttl_s"}."""
    state = {
        "epoch": int(inputs["epoch"]),
        "summaries": dict(inputs.get("summaries", {})),
        "available": dict(inputs.get("available", {})),
        "leases": {
            lease["token"]: dict(lease)
            for lease in inputs.get("leases_before", [])
        },
    }
    now = float(inputs.get("now", 0.0))
    ttl = float(inputs.get("lease_ttl_s", DEFAULT_LEASE_TTL_S))
    assignments = [
        _process_request(state, dict(req), now, ttl)
        for req in inputs.get("requests", [])
    ]
    verdict = {
        "epoch": state["epoch"],
        "assignments": assignments,
        "rebalance": _rebalance_directives(
            state["summaries"], state["available"]
        ),
    }
    verdict["digest"] = verdict_digest(verdict)
    return verdict


class _Member:
    __slots__ = ("summary", "seq", "received_at", "available", "ever_lost")

    def __init__(self) -> None:
        self.summary: Dict = {}
        self.seq = -1
        self.received_at = float("-inf")
        self.available = True
        self.ever_lost = False


class FederationArbiter:
    """The global brain: per-cluster summary registry, monotonic epoch, the
    epoch+TTL-fenced lease table, and per-round capsule bookkeeping.

    Thread-safe (the HTTP surface serves it from a threading server) but
    deterministic under any serialization of calls: intake is idempotent per
    (cluster, seq), leases idempotent per token."""

    def __init__(
        self,
        lease_ttl_s: float = DEFAULT_LEASE_TTL_S,
        summary_stale_s: float = DEFAULT_SUMMARY_STALE_S,
        clock: Optional[Clock] = None,
    ):
        self.lease_ttl_s = float(lease_ttl_s)
        self.summary_stale_s = float(summary_stale_s)
        self.clock = clock or Clock()
        self.epoch = 1
        self._members: Dict[str, _Member] = {}
        self._leases: Dict[str, Dict] = {}
        self._lock = threading.RLock()
        # per-round capsule feed: every request processed since the last
        # begin_round(), in arrival order, plus the round's input snapshot
        self._round_requests: List[Dict] = []
        self._round_assignments: List[Dict] = []
        self._round_inputs: Optional[Dict] = None
        metrics.FEDERATION_EPOCH.set(float(self.epoch))
        install_federation_exporter(self)

    # -- membership / intake -------------------------------------------------
    def register(self, cluster: str) -> None:
        with self._lock:
            self._members.setdefault(cluster, _Member())

    def submit_summary(self, summary: Dict) -> Dict:
        """Summary intake with reorder/duplicate defense: only a seq
        strictly above the member's high-water mark is accepted. A summary
        from a lost member is its rejoin signal (epoch bump)."""
        cluster = summary.get("cluster", "")
        if not cluster:
            return {"outcome": "rejected", "epoch": self.epoch}
        with self._lock:
            member = self._members.setdefault(cluster, _Member())
            seq = int(summary.get("seq", 0))
            if seq <= member.seq:
                metrics.FEDERATION_LEASES.inc({"outcome": "stale-seq"})
                return {"outcome": "stale-seq", "epoch": self.epoch}
            member.seq = seq
            member.summary = dict(summary)
            member.received_at = self.clock.now()
            if not member.available:
                # a lost region is talking again: membership transition,
                # fence every outstanding lease behind a fresh epoch
                member.available = True
                self._bump_epoch()
            return {"outcome": "accepted", "epoch": self.epoch}

    def declare_lost(self, cluster: str) -> bool:
        """Mark a member lost (blackout detection or the staleness sweep).
        Bumps the epoch — every outstanding lease is fenced."""
        with self._lock:
            member = self._members.get(cluster)
            if member is None or not member.available:
                return False
            member.available = False
            member.ever_lost = True
            self._bump_epoch()
            return True

    def sweep_lost(self, now: Optional[float] = None) -> List[str]:
        """Declare every member whose last summary is older than
        ``summary_stale_s`` lost. Explicitly called (fleet round loop /
        server heartbeat path) — no background thread, so tests and the
        replay own the timeline."""
        now = self.clock.now() if now is None else now
        newly_lost = []
        with self._lock:
            for name in sorted(self._members):
                member = self._members[name]
                if (
                    member.available
                    and now - member.received_at > self.summary_stale_s
                ):
                    newly_lost.append(name)
            for name in newly_lost:
                self._members[name].available = False
                self._members[name].ever_lost = True
            if newly_lost:
                self._bump_epoch()
        return newly_lost

    def _bump_epoch(self) -> None:
        self.epoch += 1
        metrics.FEDERATION_EPOCH.set(float(self.epoch))

    # -- leases ----------------------------------------------------------------
    def _state(self) -> Dict:
        return {
            "epoch": self.epoch,
            "summaries": {
                n: m.summary for n, m in self._members.items() if m.summary
            },
            "available": {n: m.available for n, m in self._members.items()},
            "leases": self._leases,
        }

    def request_lease(self, req: Dict) -> Dict:
        """Route one multi-region-eligible unit (pod or whole gang) to the
        globally-cheapest cluster. Idempotent per token; outcomes land on
        the ``karpenter_tpu_federation_leases_total{outcome}`` counter and
        in the current round's capsule feed."""
        with self._lock:
            now = self.clock.now()
            result = _process_request(
                self._state(), dict(req), now, self.lease_ttl_s
            )
            metrics.FEDERATION_LEASES.inc({"outcome": result["outcome"]})
            self._round_requests.append(dict(req))
            self._round_assignments.append(result)
            return result

    def confirm_lease(self, token: str, epoch: Optional[int] = None) -> Dict:
        """The fence: a launch on behalf of a lease must confirm it first.
        Any lease minted under another epoch is dead (``fenced``) — this is
        what makes a healed partition unable to double-launch."""
        with self._lock:
            lease = self._leases.get(token)
            if lease is None:
                outcome = "unknown"
            elif lease["epoch"] != self.epoch or (
                epoch is not None and epoch != self.epoch
            ):
                outcome = "fenced"
            elif lease["expires_at"] <= self.clock.now():
                outcome = "expired"
            else:
                outcome = "confirmed"
            metrics.FEDERATION_LEASES.inc({"outcome": outcome})
            return {
                "outcome": outcome,
                "valid": outcome == "confirmed",
                "epoch": self.epoch,
            }

    # -- round capsule feed ---------------------------------------------------
    def begin_round(self) -> None:
        """Snapshot the round's decision inputs (summaries, availability,
        pre-round leases) BEFORE any request lands — the capsule records
        exactly what the verdict function needs to replay the round."""
        with self._lock:
            now = self.clock.now()
            self._round_requests = []
            self._round_assignments = []
            self._round_inputs = {
                "epoch": self.epoch,
                "summaries": {
                    n: dict(m.summary)
                    for n, m in self._members.items() if m.summary
                },
                "available": {
                    n: m.available for n, m in self._members.items()
                },
                "leases_before": [
                    dict(lease) for _, lease in sorted(self._leases.items())
                ],
                "now": round(now, 6),
                "lease_ttl_s": self.lease_ttl_s,
            }

    def round_capsule_parts(
        self, degraded_requests: List[Dict] = ()
    ) -> Tuple[Dict, Dict]:
        """(inputs, verdict) for the round since ``begin_round``. Degraded
        requests (clusters that scheduled locally behind an open breaker —
        the arbiter never saw them) are appended so the verdict, and hence
        the capsule digest, covers degraded-mode rounds too."""
        with self._lock:
            inputs = dict(self._round_inputs or {"epoch": self.epoch})
            inputs["requests"] = [
                dict(r) for r in self._round_requests
            ] + [dict(r) for r in degraded_requests]
        verdict = arbiter_verdict(inputs)
        return inputs, verdict

    # -- state export ----------------------------------------------------------
    def state(self) -> Dict:
        with self._lock:
            now = self.clock.now()
            return {
                "epoch": self.epoch,
                "lease_ttl_s": self.lease_ttl_s,
                "members": {
                    n: {
                        "available": m.available,
                        "seq": m.seq,
                        "summary_age_s": (
                            round(now - m.received_at, 3)
                            if m.received_at > float("-inf") else None
                        ),
                        "risk_peak": m.summary.get("risk_peak"),
                        "marginal_price": m.summary.get("marginal_price"),
                        # realized burn from the member's cost ledger (None
                        # for clusters not running one): the operator's view
                        # of where the fleet's money actually goes
                        "cost": m.summary.get("cost"),
                    }
                    for n, m in sorted(self._members.items())
                },
                "leases": [
                    dict(lease) for _, lease in sorted(self._leases.items())
                ],
                "rebalance": _rebalance_directives(
                    {n: m.summary for n, m in self._members.items()},
                    {n: m.available for n, m in self._members.items()},
                ),
            }

    def summary_ages(self) -> Dict[str, float]:
        with self._lock:
            now = self.clock.now()
            return {
                n: max(now - m.received_at, 0.0)
                for n, m in self._members.items()
                if m.received_at > float("-inf")
            }


# -- metrics exporter ---------------------------------------------------------
# one arbiter exports at a time (tests construct many short-lived ones); the
# pre-scrape refresher reads whatever the current one is and replace_series
# prunes departed clusters' summary-age series atomically.
_EXPORTED: Dict[str, Optional[FederationArbiter]] = {"arbiter": None}
_REFRESHER_INSTALLED = False


def install_federation_exporter(arbiter: Optional[FederationArbiter]) -> None:
    global _REFRESHER_INSTALLED
    _EXPORTED["arbiter"] = arbiter
    if not _REFRESHER_INSTALLED:
        metrics.REGISTRY.add_refresher(_refresh_federation_metrics)
        _REFRESHER_INSTALLED = True


def _refresh_federation_metrics() -> None:
    arbiter = _EXPORTED["arbiter"]
    if arbiter is None:
        metrics.FEDERATION_SUMMARY_AGE.replace_series({})
        return
    metrics.FEDERATION_EPOCH.set(float(arbiter.epoch))
    metrics.FEDERATION_SUMMARY_AGE.replace_series({
        metrics.series_key({"cluster": name}): age
        for name, age in arbiter.summary_ages().items()
    })
