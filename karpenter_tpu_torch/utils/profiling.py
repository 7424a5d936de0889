"""Continuous profiler + perf-regression sentinel: WHY did the round get slower.

The port's copy of the JAX package's ``utils/profiling.py``. The stack can
already answer "why was this pod placed there" (decisions), "what happened
yesterday" (flight recorder), "where did the time go per pod" (lifecycle)
and "where did the money go" (cost ledger), but not "why did the round get
slower", which a permanently-hot pipeline asks continuously: there is no
offline bench window to catch a regression in. Three cooperating parts:

* :class:`SamplingProfiler` — a background thread walking
  ``sys._current_frames()`` at a configurable low rate (default ~19 Hz, an
  odd number so the sampler never phase-locks with periodic work),
  aggregating into a bounded collapsed-stack table (LRU-capped distinct
  stacks, evicted counts preserved under ``<evicted>`` so totals stay
  lossless) with per-thread-role tagging (reconcile loop / watch applier /
  hostpool workers / SerialBackground). Exported at ``/debug/profile`` as
  collapsed-stack text and speedscope JSON, with start/stop and
  ``?seconds=`` on-demand windows. The thread exists only while sampling:
  steady-state overhead is zero when disabled.

* :class:`PhaseBaselineStore` — rolling per-``(phase, mode)`` and
  per-bucket latency baselines (p50/p99 + MAD bands), warmed from the
  first N clean rounds and persisted as JSON so an operator restart does
  not re-learn what "normal" means.

* :class:`PerfSentinel` — the online regression detector wired into the
  operator loop: every provisioning round it compares each phase's live
  EWMA (a 0.7/0.3 blend) against the baseline MAD band; K consecutive
  out-of-band rounds trip it. A trip emits
  ``karpenter_tpu_perf_regression_total{phase}``, writes a DecisionRecord
  naming the offending phase + bucket with baseline-vs-observed numbers,
  opens an on-demand profile window, and — once the window closes — dumps
  a flight-recorder anomaly capsule (``TRIGGER_PERF_REGRESSION``) with the
  collapsed profile attached as a forensic field (excluded from replay
  byte-match like ``aot_solves``). After a trip the sentinel holds until
  the EWMA stays in-band for K consecutive rounds, then re-arms — one
  regression is one trip, not a trip per round until someone restarts the
  operator.

The observation taps (:func:`note_phase` from every ``solve_phase_seconds``
observe site, :func:`note_bucket_dispatch` from every point where the
solver learns a dispatch's host-clock time) are a single enabled-check when
the sentinel is off.

One difference from the reference is deliberate. The baselines default to
``~/.cache/karpenter_tpu_torch/``, not the JAX package's XLA cache
directory: they time this card's kernels and must never be read against a
TPU's. The resolution order is the reference's: the configured directory
(``settings.aot_cache_dir``, which the operator passes), then
``KARPENTER_TPU_COMPILE_CACHE_DIR``, then the default.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Tuning constants (module-level so tests and the bench guard can reference
# the same numbers the production path uses).
# ---------------------------------------------------------------------------

#: default sampling rate — deliberately odd (prime) so the sampler never
#: phase-locks with 10/20/100 Hz periodic work and systematically misses it
DEFAULT_SAMPLE_HZ = 19.0

#: distinct collapsed stacks kept (LRU); evicted counts fold into <evicted>
MAX_STACKS = 2048

#: frames kept per stack — adversarial recursion truncates, not explodes
MAX_STACK_DEPTH = 96

#: MAD multiplier for the baseline band: trip when ewma > p50 + 6*MAD
MAD_MULTIPLIER = 6.0

#: band floor as a fraction of p50 — micro-phases with near-zero MAD must
#: not trip on scheduler jitter
BAND_FLOOR_FRACTION = 0.5

#: absolute band floor in seconds (0.2 ms)
BAND_FLOOR_SECONDS = 2e-4

#: per-key warmup reservoir (samples kept while learning the baseline)
WARMUP_RESERVOIR = 4096

#: trip-history ring on /debug/perf
TRIP_HISTORY = 32

#: seconds of profile captured after a trip before the capsule is assembled
DEFAULT_PROFILE_WINDOW_S = 2.0

#: baseline persistence filename
BASELINE_FILENAME = "phase_baselines.json"


def _default_baseline_dir() -> str:
    """The env override, then ``~/.cache/karpenter_tpu_torch`` (the
    configured directory, when there is one, comes first in
    :func:`configure`). The reference defaults to its XLA cache directory;
    the port keeps its baselines apart, because they time this card's
    kernels."""
    return (
        os.environ.get("KARPENTER_TPU_COMPILE_CACHE_DIR")
        or os.path.join(os.path.expanduser("~"), ".cache", "karpenter_tpu_torch")
    )


# ---------------------------------------------------------------------------
# Thread-role tagging
# ---------------------------------------------------------------------------

def thread_role(name: str) -> str:
    """Map a thread name to the role prefix its collapsed stacks carry.

    The interesting split in THIS process: the reconcile loop (MainThread —
    the operator runs rounds on the main thread), the cluster watch/apply
    threads, hostpool solve workers, and SerialBackground lanes (the AOT
    pre-compiler names its lane ``aot-precompile``). Unknown threads keep
    their own name so nothing hides under ``other``."""
    if name == "MainThread":
        return "reconcile"
    low = name.lower()
    if "watch" in low or "apply" in low:
        return "watch-applier"
    if "hostpool" in low or "host-worker" in low:
        return "hostpool"
    if "precompile" in low or low == "background" or "serialbackground" in low:
        return "background"
    return name


class SamplingProfiler:
    """Low-rate ``sys._current_frames()`` sampler with a bounded
    collapsed-stack table. One instance per process (module-global
    :data:`PROFILER`); ``start``/``stop`` are idempotent and thread-safe."""

    def __init__(self, max_stacks: int = MAX_STACKS, max_depth: int = MAX_STACK_DEPTH):
        self._lock = threading.Lock()
        self._max_stacks = max_stacks
        self._max_depth = max_depth
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._hz = DEFAULT_SAMPLE_HZ
        self._deadline: Optional[float] = None  # monotonic window end; None = continuous
        self._stacks: "OrderedDict[str, int]" = OrderedDict()
        self.samples = 0
        self.evicted_samples = 0
        self.evicted_stacks = 0
        self.windows = 0

    # -- control ------------------------------------------------------------
    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self, hz: Optional[float] = None) -> bool:
        """Start continuous sampling; returns False when already running
        (idempotent — a second start never spawns a second thread)."""
        with self._lock:
            if hz is not None and hz > 0:
                self._hz = float(hz)
            self._deadline = None  # continuous overrides any pending window
            return self._spawn_locked()

    def start_window(self, seconds: float, hz: Optional[float] = None) -> bool:
        """Sample for ``seconds`` then self-stop (the on-demand
        ``?seconds=`` window and the sentinel's trip capture). Extends an
        active window; a no-op while continuous sampling runs (continuous
        already covers the window)."""
        seconds = max(0.0, float(seconds))
        with self._lock:
            if hz is not None and hz > 0:
                self._hz = float(hz)
            if self.running and self._deadline is None:
                return False  # continuous mode subsumes the window
            due = time.monotonic() + seconds
            self._deadline = max(self._deadline or 0.0, due)
            self.windows += 1
            return self._spawn_locked()

    def _spawn_locked(self) -> bool:
        if self.running:
            return False
        self._stop_evt = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="perf-profiler", daemon=True
        )
        self._thread.start()
        return True

    def stop(self, join_timeout: float = 2.0) -> None:
        """Stop sampling (idempotent); the aggregated table survives for
        export until :meth:`reset`."""
        with self._lock:
            thread = self._thread
            evt = self._stop_evt
        if thread is None:
            return
        evt.set()
        thread.join(timeout=join_timeout)
        with self._lock:
            if self._thread is thread:
                self._thread = None
                self._deadline = None

    def reset(self) -> None:
        with self._lock:
            self._stacks.clear()
            self.samples = 0
            self.evicted_samples = 0
            self.evicted_stacks = 0

    # -- sampling loop ------------------------------------------------------
    def _run(self) -> None:
        evt = self._stop_evt
        while True:
            with self._lock:
                period = 1.0 / max(self._hz, 0.1)
                deadline = self._deadline
            if deadline is not None and time.monotonic() >= deadline:
                with self._lock:
                    # re-check under the lock: a racing start() may have
                    # switched to continuous or extended the window
                    if self._deadline is not None and time.monotonic() >= self._deadline:
                        self._deadline = None
                        if self._thread is threading.current_thread():
                            self._thread = None
                        return
                continue
            if evt.wait(period):
                return
            try:
                self._sample_once()
            except Exception:
                # a sampler crash must never take the operator down; stop
                # sampling instead of spinning on a broken frame walk
                with self._lock:
                    if self._thread is threading.current_thread():
                        self._thread = None
                return

    def _sample_once(self) -> None:
        me = threading.get_ident()
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        collapsed: List[str] = []
        for tid, frame in frames.items():
            if tid == me:
                continue
            parts: List[str] = []
            depth = 0
            f = frame
            while f is not None and depth < self._max_depth:
                code = f.f_code
                mod = os.path.splitext(os.path.basename(code.co_filename))[0]
                parts.append(f"{mod}.{code.co_name}")
                f = f.f_back
                depth += 1
            if f is not None:
                parts.append("<truncated>")
            parts.reverse()
            role = thread_role(names.get(tid, f"thread-{tid}"))
            collapsed.append(role + ";" + ";".join(parts))
        del frames  # drop frame references promptly
        self._ingest(collapsed)

    def _ingest(self, collapsed: List[str]) -> None:
        """Fold one sample's collapsed stacks into the bounded LRU table
        (factored out so the bound/eviction invariants are directly
        testable without racing real threads)."""
        with self._lock:
            for key in collapsed:
                self.samples += 1
                if key in self._stacks:
                    self._stacks[key] += 1
                    self._stacks.move_to_end(key)
                    continue
                while len(self._stacks) >= self._max_stacks:
                    _, count = self._stacks.popitem(last=False)
                    self.evicted_stacks += 1
                    self.evicted_samples += count
                self._stacks[key] = 1

    # -- export -------------------------------------------------------------
    def collapsed(self) -> str:
        """Brendan-Gregg collapsed-stack text: ``role;frame;frame count``
        per line, heaviest first (feed straight into flamegraph.pl)."""
        with self._lock:
            rows = sorted(self._stacks.items(), key=lambda kv: -kv[1])
            evicted = self.evicted_samples
        lines = [f"{stack} {count}" for stack, count in rows]
        if evicted:
            lines.append(f"<evicted> {evicted}")
        return "\n".join(lines)

    def speedscope(self) -> Dict:
        """The same table as a speedscope 'sampled' profile document."""
        with self._lock:
            rows = list(self._stacks.items())
        frame_index: Dict[str, int] = {}
        frames: List[Dict] = []
        samples: List[List[int]] = []
        weights: List[int] = []
        for stack, count in rows:
            idxs = []
            for name in stack.split(";"):
                if name not in frame_index:
                    frame_index[name] = len(frames)
                    frames.append({"name": name})
                idxs.append(frame_index[name])
            samples.append(idxs)
            weights.append(count)
        total = sum(weights)
        return {
            "$schema": "https://www.speedscope.app/file-format-schema.json",
            "shared": {"frames": frames},
            "profiles": [
                {
                    "type": "sampled",
                    "name": "karpenter-tpu",
                    "unit": "none",
                    "startValue": 0,
                    "endValue": total,
                    "samples": samples,
                    "weights": weights,
                }
            ],
        }

    def snapshot(self) -> Dict:
        with self._lock:
            deadline = self._deadline
            return {
                "running": self.running,
                "continuous": self.running and deadline is None,
                "sample_hz": self._hz,
                "samples": self.samples,
                "distinct_stacks": len(self._stacks),
                "evicted_stacks": self.evicted_stacks,
                "evicted_samples": self.evicted_samples,
                "windows": self.windows,
                "window_remaining_s": (
                    max(0.0, deadline - time.monotonic()) if deadline is not None else None
                ),
            }


# ---------------------------------------------------------------------------
# Phase baselines
# ---------------------------------------------------------------------------

def _phase_key(phase: str, mode: str) -> str:
    return f"{phase}|{mode}"


def _bucket_key(label: str) -> str:
    return f"bucket|{label}"


class _KeyState:
    """Per-(phase,mode) / per-bucket learning + live state."""

    __slots__ = (
        "warmup", "rounds_seen", "baseline", "ewma", "fresh",
        "out_streak", "in_streak", "state", "last_observed",
    )

    def __init__(self):
        self.warmup: Deque[float] = deque(maxlen=WARMUP_RESERVOIR)
        self.rounds_seen = 0
        self.baseline: Optional[Dict] = None  # {p50, p99, mad, n}
        self.ewma: Optional[float] = None
        self.fresh = False
        self.out_streak = 0
        self.in_streak = 0
        self.state = "warming"  # warming | armed | tripped
        self.last_observed: Optional[float] = None


def _band_hi(baseline: Dict) -> float:
    p50 = baseline["p50"]
    mad = baseline["mad"]
    return p50 + max(
        MAD_MULTIPLIER * mad, BAND_FLOOR_FRACTION * p50, BAND_FLOOR_SECONDS
    )


class PhaseBaselineStore:
    """Rolling baselines, persisted as JSON in the baseline directory.

    A key's baseline freezes after ``baseline_rounds`` rounds carrying fresh
    observations: p50/p99 of the warmup reservoir plus the MAD around p50.
    Persisted baselines reload as already-warm — a restarted operator does
    not spend another N rounds re-learning normal (and does not false-trip
    on the first post-restart rounds either, because the sentinel state
    machine still warms its EWMA before arming)."""

    def __init__(self):
        self._path: Optional[str] = None
        self.baseline_rounds = 20

    def configure(self, path: Optional[str], baseline_rounds: int) -> None:
        self._path = path
        self.baseline_rounds = max(1, int(baseline_rounds))

    @property
    def path(self) -> Optional[str]:
        return self._path

    def freeze(self, key: str, st: _KeyState) -> None:
        """Compute and install the frozen baseline for ``key``."""
        xs = sorted(st.warmup)
        if not xs:
            return
        p50 = statistics.median(xs)
        p99 = xs[min(len(xs) - 1, int(0.99 * (len(xs) - 1)))]
        mad = statistics.median(abs(x - p50) for x in xs)
        st.baseline = {"p50": p50, "p99": p99, "mad": mad, "n": len(xs)}
        st.warmup.clear()

    # -- persistence --------------------------------------------------------
    def save(self, states: Dict[str, _KeyState]) -> Optional[str]:
        if not self._path:
            return None
        doc = {
            "version": 1,
            "baseline_rounds": self.baseline_rounds,
            "baselines": {
                key: st.baseline for key, st in states.items() if st.baseline
            },
        }
        try:
            os.makedirs(os.path.dirname(self._path), exist_ok=True)
            tmp = f"{self._path}.tmp.{os.getpid()}"
            with open(tmp, "w") as fh:
                json.dump(doc, fh, sort_keys=True, indent=1)
            os.replace(tmp, self._path)
        except OSError:
            return None  # baselines are advisory; persistence must not wedge
        return self._path

    def load(self) -> Dict[str, Dict]:
        if not self._path:
            return {}
        try:
            with open(self._path) as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            return {}
        out = {}
        for key, base in (doc.get("baselines") or {}).items():
            if isinstance(base, dict) and {"p50", "p99", "mad"} <= set(base):
                out[key] = base
        return out


# ---------------------------------------------------------------------------
# The sentinel
# ---------------------------------------------------------------------------

#: EWMA blend — the reference's constants (its AOTCache.note_dispatch blend)
EWMA_KEEP = 0.7
EWMA_NEW = 0.3


class PerfSentinel:
    """Online per-phase regression detection at round granularity.

    ``note_phase``/``note_bucket`` are called from hot paths (possibly from
    hostpool worker threads) and do minimal work under a lock; ``tick()``
    runs once per provisioning round on the operator loop and does the
    band math, trip bookkeeping, and capsule assembly."""

    def __init__(
        self,
        profiler: SamplingProfiler,
        store: PhaseBaselineStore,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._lock = threading.Lock()
        self.profiler = profiler
        self.store = store
        self.clock = clock
        self.enabled = False          # master: taps are no-ops when False
        self.sentinel_enabled = False  # trip logic (baselines still learn)
        self.mad_k = 3
        self.profile_window_s = DEFAULT_PROFILE_WINDOW_S
        self._states: Dict[str, _KeyState] = {}
        self.trips: Deque[Dict] = deque(maxlen=TRIP_HISTORY)
        self.trips_total = 0
        self.rounds = 0
        self._pending_capsule: Optional[Dict] = None
        self._dirty_baselines = False

    # -- configuration ------------------------------------------------------
    def configure(
        self,
        *,
        enabled: bool,
        sentinel_enabled: bool,
        mad_k: int,
        baseline_rounds: int,
        baseline_path: Optional[str],
        profile_window_s: float = DEFAULT_PROFILE_WINDOW_S,
        clock: Optional[Callable[[], float]] = None,
    ) -> None:
        with self._lock:
            self.enabled = bool(enabled)
            self.sentinel_enabled = bool(sentinel_enabled)
            self.mad_k = max(1, int(mad_k))
            self.profile_window_s = max(0.0, float(profile_window_s))
            if clock is not None:
                self.clock = clock
            self.store.configure(baseline_path, baseline_rounds)
            for key, base in self.store.load().items():
                st = self._states.setdefault(key, _KeyState())
                st.baseline = base
                st.state = "armed"

    def reset(self) -> None:
        with self._lock:
            self._states.clear()
            self.trips.clear()
            self.trips_total = 0
            self.rounds = 0
            self._pending_capsule = None
            self._dirty_baselines = False

    # -- observation taps ---------------------------------------------------
    def note_phase(self, phase: str, mode: str, seconds: float) -> None:
        self._note(_phase_key(phase, mode or "full"), seconds)

    def note_bucket(self, label: str, seconds: float) -> None:
        self._note(_bucket_key(label), seconds)

    def _note(self, key: str, seconds: float) -> None:
        if seconds < 0 or seconds != seconds:  # negative / NaN guards
            return
        with self._lock:
            st = self._states.setdefault(key, _KeyState())
            st.fresh = True
            st.last_observed = seconds
            if st.baseline is None:
                st.warmup.append(seconds)
            st.ewma = (
                seconds if st.ewma is None
                else EWMA_KEEP * st.ewma + EWMA_NEW * seconds
            )

    # -- round boundary -----------------------------------------------------
    def tick(self) -> List[Dict]:
        """One provisioning round completed: advance warmups, evaluate
        bands, trip / re-arm, and flush any due capsule. Returns the trips
        fired THIS round (the bench detection gate asserts on them).
        Idle rounds (no fresh observations for a key) do not advance that
        key's warmup, trip streak, or recovery streak."""
        fired: List[Dict] = []
        with self._lock:
            if not self.enabled:
                return fired
            self.rounds += 1
            for key, st in self._states.items():
                if not st.fresh:
                    continue
                st.fresh = False
                if st.baseline is None:
                    st.rounds_seen += 1
                    if st.rounds_seen >= self.store.baseline_rounds and st.warmup:
                        self.store.freeze(key, st)
                        st.state = "armed"
                        self._dirty_baselines = True
                    continue
                if not self.sentinel_enabled or st.ewma is None:
                    continue
                band = _band_hi(st.baseline)
                if st.ewma > band:
                    st.out_streak += 1
                    st.in_streak = 0
                    if st.state == "armed" and st.out_streak >= self.mad_k:
                        fired.append(self._trip_locked(key, st, band))
                else:
                    st.in_streak += 1
                    st.out_streak = 0
                    if st.state == "tripped" and st.in_streak >= self.mad_k:
                        st.state = "armed"
            dirty = self._dirty_baselines
            self._dirty_baselines = False
            pending = self._maybe_take_pending_locked()
        if dirty:
            self.store.save(self._states)
        for trip in fired:
            self._emit(trip)
        if pending is not None:
            self._assemble_capsule(pending)
        return fired

    # -- trip machinery -----------------------------------------------------
    def _worst_bucket_locked(self) -> Tuple[str, float]:
        """The bucket key with the largest band exceedance ratio — the
        attribution half of 'which phase, which bucket'. Buckets whose
        baseline never froze (the race path right-censors fast dispatches,
        so a quick device feeds no latency samples) fall back to the
        slowest recently-observed bucket with ratio 0.0 — best-effort
        attribution beats an empty field in the DecisionRecord."""
        worst, ratio = "", 0.0
        for key, st in self._states.items():
            if not key.startswith("bucket|") or st.baseline is None or st.ewma is None:
                continue
            band = _band_hi(st.baseline)
            if band <= 0:
                continue
            r = st.ewma / band
            if r > ratio:
                worst, ratio = key.split("|", 1)[1], r
        if not worst:
            slowest = 0.0
            for key, st in self._states.items():
                if (
                    key.startswith("bucket|")
                    and st.last_observed is not None
                    and st.last_observed > slowest
                ):
                    worst, slowest = key.split("|", 1)[1], st.last_observed
        return worst, ratio

    def _trip_locked(self, key: str, st: _KeyState, band: float) -> Dict:
        st.state = "tripped"
        phase, _, mode = key.partition("|")
        bucket, bucket_ratio = self._worst_bucket_locked()
        trip = {
            "time": self.clock(),
            "phase": phase,
            "mode": mode,
            "bucket": bucket,
            "bucket_band_ratio": round(bucket_ratio, 3),
            "observed_ewma_s": st.ewma,
            "band_hi_s": band,
            "baseline": dict(st.baseline or {}),
            "k": self.mad_k,
            "round": self.rounds,
        }
        self.trips.append(trip)
        self.trips_total += 1
        # open the forensic profile window now; the capsule is assembled
        # once the window has had time to observe the slow path
        if self._pending_capsule is None:
            self._pending_capsule = {
                "due": self.clock() + self.profile_window_s,
                "trip": trip,
            }
        return trip

    def _maybe_take_pending_locked(self) -> Optional[Dict]:
        pending = self._pending_capsule
        if pending is not None and self.clock() >= pending["due"]:
            self._pending_capsule = None
            return pending
        return None

    def _emit(self, trip: Dict) -> None:
        """Metrics + decision record + profile window for one trip (outside
        the sentinel lock: these take their own locks)."""
        from . import metrics
        from .decisions import DECISIONS

        metrics.PERF_REGRESSION.inc({"phase": trip["phase"]})
        base = trip["baseline"]
        DECISIONS.record(
            "perf",
            "regression",
            reason=(
                f"phase {trip['phase']} ({trip['mode']}) ewma "
                f"{trip['observed_ewma_s']:.6f}s exceeded baseline band "
                f"{trip['band_hi_s']:.6f}s for {trip['k']} rounds"
            ),
            details={
                "phase": trip["phase"],
                "mode": trip["mode"],
                "bucket": trip["bucket"],
                "observed_ewma_s": trip["observed_ewma_s"],
                "band_hi_s": trip["band_hi_s"],
                "baseline_p50_s": base.get("p50"),
                "baseline_p99_s": base.get("p99"),
                "baseline_mad_s": base.get("mad"),
            },
        )
        if self.profile_window_s > 0:
            self.profiler.start_window(self.profile_window_s)

    def _assemble_capsule(self, pending: Dict) -> None:
        """Dump the perf-regression anomaly capsule: the latest provisioning
        capsule (the round that regressed), re-identified, with the trigger
        anomaly and the collapsed profile attached as forensic outputs.
        Replay compares only the fixed output key set, so the extra
        ``profile``/``perf_regression`` fields are ignored byte-for-byte —
        the same contract ``aot_solves`` rides."""
        import copy

        from . import flightrecorder as fr

        base = fr.FLIGHT.latest("provisioning") or fr.FLIGHT.latest()
        if base is None:
            return  # recorder off/empty: the trip history still has the data
        trip = pending["trip"]
        capsule = copy.deepcopy(base)
        capsule["id"] = f"{base['id']}.perf{self.trips_total}"
        anomalies = list(capsule.get("anomalies", []))
        if fr.TRIGGER_PERF_REGRESSION not in anomalies:
            anomalies.append(fr.TRIGGER_PERF_REGRESSION)
        capsule["anomalies"] = anomalies
        outputs = dict(capsule.get("outputs", {}))
        outputs["profile"] = self.profiler.collapsed().splitlines()
        outputs["perf_regression"] = {
            k: trip[k]
            for k in (
                "phase", "mode", "bucket", "observed_ewma_s", "band_hi_s",
                "baseline", "k", "round",
            )
        }
        capsule["outputs"] = outputs
        fr.FLIGHT.commit_external(capsule)
        trip["capsule"] = capsule["id"]

    # -- export -------------------------------------------------------------
    def snapshot(self) -> Dict:
        """The /debug/perf document: per-key baseline, live EWMA, band and
        streaks, plus the trip history ring."""
        with self._lock:
            phases, buckets = {}, {}
            for key, st in self._states.items():
                doc = {
                    "state": st.state,
                    "ewma_s": st.ewma,
                    "last_observed_s": st.last_observed,
                    "baseline": st.baseline,
                    "band_hi_s": _band_hi(st.baseline) if st.baseline else None,
                    "rounds_seen": st.rounds_seen,
                    "out_streak": st.out_streak,
                    "in_streak": st.in_streak,
                }
                if key.startswith("bucket|"):
                    buckets[key.split("|", 1)[1]] = doc
                else:
                    phases[key] = doc
            return {
                "enabled": self.enabled,
                "sentinel_enabled": self.sentinel_enabled,
                "mad_k": self.mad_k,
                "baseline_rounds": self.store.baseline_rounds,
                "baseline_path": self.store.path,
                "rounds": self.rounds,
                "trips_total": self.trips_total,
                "trips": list(self.trips),
                "phases": phases,
                "buckets": buckets,
            }


# ---------------------------------------------------------------------------
# Process globals + the hot-path taps
# ---------------------------------------------------------------------------

PROFILER = SamplingProfiler()
BASELINES = PhaseBaselineStore()
SENTINEL = PerfSentinel(PROFILER, BASELINES)


def configure(
    *,
    profiling_enabled: bool = False,
    sample_hz: float = DEFAULT_SAMPLE_HZ,
    baseline_rounds: int = 20,
    sentinel_enabled: bool = True,
    mad_k: int = 3,
    baseline_dir: Optional[str] = None,
    profile_window_s: float = DEFAULT_PROFILE_WINDOW_S,
    clock: Optional[Callable[[], float]] = None,
) -> None:
    """Operator boot: wire the settings family into the process globals.

    ``profiling_enabled`` starts the CONTINUOUS sampler (and, in the
    operator, also turns tracemalloc on via runtimehealth — one switch
    family). The sentinel's taps and round evaluation are governed by
    ``sentinel_enabled``; on-demand ``?seconds=`` windows work regardless."""
    directory = baseline_dir or _default_baseline_dir()
    SENTINEL.configure(
        enabled=sentinel_enabled or profiling_enabled,
        sentinel_enabled=sentinel_enabled,
        mad_k=mad_k,
        baseline_rounds=baseline_rounds,
        baseline_path=os.path.join(directory, BASELINE_FILENAME),
        profile_window_s=profile_window_s,
        clock=clock,
    )
    if profiling_enabled:
        PROFILER.start(hz=sample_hz)
    else:
        with PROFILER._lock:
            PROFILER._hz = float(sample_hz) if sample_hz > 0 else DEFAULT_SAMPLE_HZ


def note_phase(phase: str, mode: str, seconds: float) -> None:
    """Tap beside every ``solve_phase_seconds`` observation — one attribute
    read when the sentinel is off."""
    s = SENTINEL
    if not s.enabled:
        return
    s.note_phase(phase, mode, seconds)


def note_bucket_dispatch(label: str, seconds: float) -> None:
    """Tap at every point where the solver learns a dispatch's host-clock
    time (``AOT_CACHE.note_dispatch`` makes every call) — the per-bucket
    attribution feed."""
    s = SENTINEL
    if not s.enabled:
        return
    s.note_bucket(label, seconds)


def sentinel_tick() -> List[Dict]:
    """Round boundary (called by the operator loop after each provisioning
    reconcile)."""
    return SENTINEL.tick()
