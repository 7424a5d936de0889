"""Interruption-risk cache: per-capacity-pool reclaim-probability estimates.

KubePACS (PAPERS.md) shows spot-heavy clusters staying available when the
scheduler treats interruption risk as a first-class signal instead of
reacting after the eviction. This module is that signal's home: a
**capacity pool** is one ``(instance_type, zone, capacity_type)`` triple,
and for each pool the cache blends a static prior (spot pools are
reclaimable, on-demand pools are not) with *realized* interruption events
fed by the interruption controller — spot reclaims weigh heavily,
rebalance recommendations (the cloud's "rising risk" hint) weigh less —
and decays the evidence over a configurable halflife so a pool that
stopped churning earns its way back to the prior.

The estimate is a shrinkage blend, deterministic and clock-injectable::

    w = sum(event_weight * 0.5 ** ((now - event_time) / halflife))
    p = prior + (P_MAX - prior) * w / (w + PRIOR_STRENGTH)

so zero evidence yields exactly the prior, evidence saturates toward
``P_MAX`` (never 1.0 — the solver's risk cost must stay finite-ordered),
and the decay is pure arithmetic on a stored (weight, timestamp) pair per
pool — no background threads, no per-event lists.

Consumers: the cloud providers stamp ``Offering.interruption_probability``
from here (so the probabilities ride the same seqnum-cached instance-type
lists the ICE mask does), the solver prices ``price + p * penalty``, and
the rebalance controller reads pool risk when choosing replacement
capacity. ``version`` bumps on every write, mirroring the
UnavailableOfferings seqnum contract, so downstream catalog caches
invalidate.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from .cache import Clock

PoolKey = Tuple[str, str, str]  # (instance_type, zone, capacity_type)

#: default reclaim prior for spot pools with no observed evidence — the
#: analogue of the static price table: wrong in detail, right in ordering
SPOT_PRIOR = 0.05
#: probability ceiling: evidence saturates here, never at 1.0
P_MAX = 0.9
#: pseudo-observations behind the prior — how much realized evidence it
#: takes to move the estimate halfway from the prior to P_MAX
PRIOR_STRENGTH = 3.0
#: event weights: a realized reclaim is strong evidence, a rebalance
#: recommendation is the cloud hedging
WEIGHT_INTERRUPTION = 1.0
WEIGHT_REBALANCE = 0.25

DEFAULT_HALFLIFE_S = 600.0


class InterruptionRiskCache:
    """Decayed per-pool interruption evidence -> probability estimates."""

    def __init__(
        self,
        halflife_s: float = DEFAULT_HALFLIFE_S,
        spot_prior: float = SPOT_PRIOR,
        clock: Optional[Clock] = None,
    ):
        self.halflife_s = max(float(halflife_s), 1e-9)
        self.spot_prior = spot_prior
        self._clock = clock or Clock()
        self._lock = threading.Lock()
        # pool -> (decayed weight, as-of timestamp, observation count)
        self._evidence: Dict[PoolKey, Tuple[float, float, int]] = {}
        # test/forensics pins: a pinned pool ignores evidence
        self._pinned: Dict[PoolKey, float] = {}
        self.version = 0  # seqnum: bumps on every write (catalog cache key)

    # -- priors -------------------------------------------------------------
    def prior(self, capacity_type: str) -> float:
        from ..api import labels as wk

        return self.spot_prior if capacity_type == wk.CAPACITY_TYPE_SPOT else 0.0

    # -- evidence intake ----------------------------------------------------
    def _record(self, key: PoolKey, weight: float, now: Optional[float]) -> None:
        now = self._clock.now() if now is None else now
        with self._lock:
            w, t, n = self._evidence.get(key, (0.0, now, 0))
            w = w * 0.5 ** (max(now - t, 0.0) / self.halflife_s)
            self._evidence[key] = (w + weight, now, n + 1)
            self.version += 1

    def record_interruption(
        self, instance_type: str, zone: str, capacity_type: str,
        now: Optional[float] = None,
    ) -> None:
        """A realized reclaim in this pool (the 2-minute warning arrived)."""
        self._record((instance_type, zone, capacity_type), WEIGHT_INTERRUPTION, now)

    def record_rebalance(
        self, instance_type: str, zone: str, capacity_type: str,
        now: Optional[float] = None,
    ) -> None:
        """A rebalance recommendation: elevated-risk hint, not a reclaim."""
        self._record((instance_type, zone, capacity_type), WEIGHT_REBALANCE, now)

    # -- estimates ----------------------------------------------------------
    def _weight(self, key: PoolKey, now: float) -> float:
        ent = self._evidence.get(key)
        if ent is None:
            return 0.0
        w, t, _ = ent
        return w * 0.5 ** (max(now - t, 0.0) / self.halflife_s)

    def probability(
        self, instance_type: str, zone: str, capacity_type: str,
        now: Optional[float] = None,
    ) -> float:
        """Blended reclaim-probability estimate for one pool in [0, P_MAX]."""
        key = (instance_type, zone, capacity_type)
        with self._lock:
            pinned = self._pinned.get(key)
            if pinned is not None:
                return pinned
            now = self._clock.now() if now is None else now
            w = self._weight(key, now)
        prior = self.prior(capacity_type)
        if w <= 0.0:
            return prior
        return prior + (P_MAX - prior) * w / (w + PRIOR_STRENGTH)

    def observations(self, instance_type: str, zone: str, capacity_type: str) -> int:
        """Total events ever recorded for the pool (undecayed counter — the
        interruption-storm tests assert exactly-once accounting on this)."""
        with self._lock:
            ent = self._evidence.get((instance_type, zone, capacity_type))
            return ent[2] if ent is not None else 0

    # -- pins (replay counterfactuals / tests) ------------------------------
    def pin_probability(
        self, instance_type: str, zone: str, capacity_type: str, p: float
    ) -> None:
        """Pin one pool's estimate, overriding prior and evidence — a test /
        forensics hook for holding a pool at a known probability. (The replay
        CLI's ``--override risk.<it>/<zone>/<ct>=p`` does NOT route through
        here: byte-identical replays serve the capsule's recorded catalog, so
        the override edits the captured offerings' ``interruptionProbability``
        wire directly — see ``replay._apply_risk_override``.)"""
        with self._lock:
            self._pinned[(instance_type, zone, capacity_type)] = float(p)
            self.version += 1

    def entries(self) -> List[Tuple[str, str, str, float]]:
        """Live (instance_type, zone, capacity_type, probability) rows for
        pools with recorded evidence or pins (forensics / capsule context)."""
        with self._lock:
            keys = set(self._evidence) | set(self._pinned)
        return [(it, z, ct, self.probability(it, z, ct)) for it, z, ct in sorted(keys)]

    def flush(self) -> None:
        with self._lock:
            self._evidence.clear()
            self._pinned.clear()
            self.version += 1
