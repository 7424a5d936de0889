"""SLO burn-rate engine over the pod-lifecycle tracker's completions.

Classic multi-window error-budget burn (the SRE-workbook alerting shape):
every completed pod-ready latency is judged against a configured objective
(``slo_pod_ready_p99_s`` / ``slo_pod_ready_target_frac``, Settings ->
operator -> ConfigMap) and lands as a good/bad count in a coarse time-
bucketed ring. Two windows read the ring:

* ``fast`` (5 min) — catches a sharp regression within minutes;
* ``slow`` (1 h)  — the budget view, smooths transient blips.

Burn rate is the standard normalization: ``bad_fraction / (1 - target)``
— 1.0 means the error budget is being spent exactly at the rate that
exhausts it over the objective period, >1 is overspend. Zero traffic in a
window is zero burn (an idle cluster is not violating anything). Budget
remaining is judged over the slow window: ``1 - bad / allowed_bad``
(negative = overspent, 1.0 = untouched).

Exported by a registry pre-scrape refresher as
``karpenter_tpu_slo_burn_rate{slo,window}`` and
``karpenter_tpu_slo_budget_remaining{slo}``; ``/debug/slo`` renders the
same snapshot as JSON. The clock is injectable (``configure(clock=...)``)
so the window roll-off math tests under a FakeClock.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from . import metrics

#: (window label, window length in seconds) — multi-window burn, SRE-style
WINDOWS: Tuple[Tuple[str, float], ...] = (("fast", 300.0), ("slow", 3600.0))

#: bucket width of the good/bad ring; coarse on purpose — the engine holds
#: slow-window/_BUCKET_S entries per objective, not one per observation
_BUCKET_S = 10.0


class SloEngine:
    """Process-global engine (configured by the operator, like DECISIONS).
    Objectives map name -> (threshold_s, target_frac); unknown-objective
    observations are no-ops so the tracker never needs to know whether an
    SLO is configured."""

    def __init__(self):
        self._lock = threading.Lock()
        self._objectives: Dict[str, Tuple[float, float]] = {}
        # per objective: deque of [bucket_index, good, bad], oldest first
        self._buckets: Dict[str, "collections.deque"] = {}
        self._clock: Callable[[], float] = time.monotonic

    def configure(
        self,
        objectives: Optional[Dict[str, Tuple[float, float]]] = None,
        clock: Optional[Callable[[], float]] = None,
    ) -> None:
        with self._lock:
            self._objectives = dict(objectives or {})
            self._buckets = {name: collections.deque() for name in self._objectives}
            if clock is not None:
                self._clock = clock

    # -- recording ----------------------------------------------------------
    def observe_latency(self, slo: str, seconds: float) -> None:
        obj = self._objectives.get(slo)
        if obj is None:
            return
        self.record(slo, good=seconds <= obj[0])

    def record(self, slo: str, good: bool) -> None:
        if slo not in self._objectives:
            return
        with self._lock:
            now = self._clock()
            idx = int(now // _BUCKET_S)
            ring = self._buckets[slo]
            if ring and ring[-1][0] == idx:
                cell = ring[-1]
            else:
                cell = [idx, 0, 0]
                ring.append(cell)
            cell[1 if good else 2] += 1
            # roll off buckets the slow window can no longer see
            horizon = idx - int(WINDOWS[-1][1] // _BUCKET_S) - 1
            while ring and ring[0][0] < horizon:
                ring.popleft()

    # -- reading ------------------------------------------------------------
    def _counts(self, slo: str, window_s: float) -> Tuple[int, int]:
        """(good, bad) within the trailing window. Caller holds the lock."""
        ring = self._buckets.get(slo)
        if not ring:
            return 0, 0
        floor = int((self._clock() - window_s) // _BUCKET_S)
        good = bad = 0
        for idx, g, b in ring:
            if idx > floor:
                good += g
                bad += b
        return good, bad

    def burn_rate(self, slo: str, window_s: float) -> float:
        obj = self._objectives.get(slo)
        if obj is None:
            return 0.0
        with self._lock:
            good, bad = self._counts(slo, window_s)
        total = good + bad
        if total == 0:
            return 0.0  # idle is not a violation
        budget_frac = max(1e-9, 1.0 - obj[1])
        return (bad / total) / budget_frac

    def budget_remaining(self, slo: str) -> float:
        """Error budget left over the slow window: 1.0 untouched, 0 spent,
        negative overspent. No traffic means the budget is intact."""
        obj = self._objectives.get(slo)
        if obj is None:
            return 1.0
        with self._lock:
            good, bad = self._counts(slo, WINDOWS[-1][1])
        total = good + bad
        if total == 0:
            return 1.0
        allowed = max(1e-9, (1.0 - obj[1]) * total)
        return 1.0 - bad / allowed

    def snapshot(self) -> Dict:
        """/debug/slo payload: per objective, the thresholds plus per-window
        traffic and burn."""
        out: Dict = {"objectives": {}}
        for name, (threshold, target) in sorted(self._objectives.items()):
            windows = {}
            for label, length in WINDOWS:
                with self._lock:
                    good, bad = self._counts(name, length)
                windows[label] = {
                    "good": good,
                    "bad": bad,
                    "burn_rate": round(self.burn_rate(name, length), 6),
                }
            out["objectives"][name] = {
                "threshold_s": threshold,
                "target_frac": target,
                "windows": windows,
                "budget_remaining": round(self.budget_remaining(name), 6),
            }
        return out

    # -- metric export ------------------------------------------------------
    def refresh_metrics(self) -> None:
        for name in list(self._objectives):
            for label, length in WINDOWS:
                metrics.SLO_BURN_RATE.set(
                    self.burn_rate(name, length), {"slo": name, "window": label}
                )
            metrics.SLO_BUDGET_REMAINING.set(
                self.budget_remaining(name), {"slo": name}
            )


SLO = SloEngine()

_hook_lock = threading.Lock()
_hook_registered = False


def install_exporter() -> None:
    """Register the pre-scrape gauge refresher once (idempotent — operators
    reconfigure across tests but the registry hook must not stack)."""
    global _hook_registered
    with _hook_lock:
        if not _hook_registered:
            metrics.REGISTRY.add_refresher(SLO.refresh_metrics)
            _hook_registered = True
