"""Pod-lifecycle latency attribution: the per-pod stage waterfall.

The streaming-scheduler goal (rounds -> streaming scheduler) regrades the product on
**pod-ready latency, not solve p50** — but until this subsystem the system
could only report pod-ready p99 as one opaque number while fine-grained
timing stopped at the solver's phase histogram. The tracker stamps a
monotonic per-pod timeline across every boundary a pending pod crosses:

``intake``           watch first-seen (the HTTP informer applier or the
                     controller's pod_event callback, whichever fires first)
``batch_flushed``    the reconcile read the pod out of the batch window
``cell_routed``      the cell router assigned it a partition (sharded mode)
``solve_dispatch``   a cascade round's solve started over its batch
``encode_start`` /   the EncodeSession (re)encoded the problem
``encode_done``
``solve_result``     the solve answered (``backend=`` kernel/host/greedy)
``validated``        the pre-bind validation firewall passed its plan
``launch_issued`` /  cloud-provider create dispatched / node registered
``node_ready``       (only for pods placed on NEW nodes)
``bound``            the bind landed — the timeline completes here

Each segment between consecutive marks is attributed to the stage named by
the ARRIVING mark (``batch_flushed`` ends the ``batch_wait`` segment,
``solve_result`` ends the ``solve`` segment, ...), so per-stage durations
sum to the end-to-end pod-ready latency BY CONSTRUCTION — no sampling gap
to reconcile. Stages split into *waiting* (``batch_wait``, ``solve_wait``,
``encode_wait``, ``launch_wait``) and *in-stage work* (everything else):
the queue-delay decomposition the streaming refactor will attack.

Completion (at bind) feeds the SLO burn-rate engine (utils/slo.py), buffers
the sample for ``karpenter_tpu_pod_lifecycle_stage_seconds`` /
``karpenter_tpu_pod_ready_seconds`` (folded into the histograms by a
registry pre-scrape refresher — the bind path pays one deque append per
pod; the scrape thread pays the label-key and bucket arithmetic), and
retains a bounded ring of completed waterfalls for
``/debug/lifecycle?pod=`` and the flight recorder's forensic capsule
output. In-flight entries for pods DELETED before they bound are
pruned by a registry pre-scrape hook (the WeakSet pattern) so
churned pods never leak tracker memory.

Replay isolation mirrors the flight recorder's: the replay harness re-runs
controllers under :class:`suppressed`, so a replayed round never stamps the
live tracker or double-counts the SLO.
"""

from __future__ import annotations

import collections
import threading
import time
import weakref
from typing import Callable, Dict, Iterable, List, Optional

from . import metrics, tracing
from .logging import context_fields

#: stage classification for the queue-delay decomposition: segments ending
#: at these marks are time the pod spent WAITING between stages; all other
#: segments are time spent inside a stage doing work
WAIT_STAGES = frozenset({"batch_wait", "encode_wait", "solve_wait", "launch_wait"})

#: arriving mark -> attributed stage name for the segment it closes
_SEGMENT_FOR_MARK = {
    "batch_flushed": "batch_wait",
    "cell_routed": "route",
    "solve_dispatch": "solve_wait",
    "encode_start": "encode_wait",
    "encode_done": "encode",
    "solve_result": "solve",
    "validated": "validate",
    "launch_issued": "launch_wait",
    "node_ready": "launch",
    "bound": "bind",
}

#: thread-local mark suppression: the replay harness re-runs controllers
#: that would otherwise stamp the LIVE tracker with replayed timelines
_suppress = threading.local()


class suppressed:
    """Context manager disabling lifecycle marks on this thread."""

    def __enter__(self):
        self._prev = getattr(_suppress, "on", False)
        _suppress.on = True
        return self

    def __exit__(self, *exc):
        _suppress.on = self._prev
        return False


class _Entry:
    __slots__ = ("marks", "attrs")

    def __init__(self, t0: float):
        self.marks: List[tuple] = [("intake", t0)]
        self.attrs: Dict[str, str] = {}


def _segments(marks: List[tuple]) -> Dict[str, float]:
    """Aggregate the mark timeline into per-stage durations. Marks with no
    mapping (a future mark name) fold into ``other`` rather than silently
    breaking the stages-sum-to-e2e invariant."""
    stages: Dict[str, float] = {}
    for (_, prev_t), (mark, t) in zip(marks, marks[1:]):
        stage = _SEGMENT_FOR_MARK.get(mark, "other")
        stages[stage] = stages.get(stage, 0.0) + max(0.0, t - prev_t)
    return stages


def _render(raw: tuple) -> Dict:
    """Expand a compact completion tuple into the full waterfall record.
    Completion stores raws and renders on READ (debug endpoints, snapshot,
    metric flush) so the bind path never pays the segment aggregation and
    dict assembly per pod."""
    pod, node, trace_id, reconcile_id, marks, backend, wall = raw
    t0 = marks[0][1]
    stages = _segments(marks)
    return {
        "pod": pod,
        "node": node,
        "trace_id": trace_id,
        "reconcile_id": reconcile_id,
        "e2e_s": max(0.0, marks[-1][1] - t0),
        "stages": stages,
        "wait_s": sum(v for k, v in stages.items() if k in WAIT_STAGES),
        "work_s": sum(v for k, v in stages.items() if k not in WAIT_STAGES),
        "backend": backend,
        "marks": [[m, t - t0] for m, t in marks],
        "completed_at": wall,
    }


class LifecycleTracker:
    """Process-global per-pod timeline store (configured by the operator,
    like DECISIONS / FLIGHT). All mutators are cheap no-ops while disabled
    or suppressed; marks on untracked pods (bound pods re-encoded by a
    deprovisioning simulation, replay feeds) are no-ops too."""

    def __init__(self, enabled: bool = True, retention: int = 4096):
        self._lock = threading.Lock()
        self._enabled = enabled
        self._inflight: Dict[str, _Entry] = {}
        self._completed: "collections.OrderedDict[str, Dict]" = collections.OrderedDict()
        self._retention = retention
        # completions since the last flight-recorder drain; bounded so a
        # recorder-disabled operator can never grow it without bound
        self._round: "collections.deque[Dict]" = collections.deque(maxlen=256)
        # (stages, e2e) samples awaiting histogram fold-in at the next
        # scrape; bounded far above any realistic binds-per-scrape-interval
        self._obs: "collections.deque[tuple]" = collections.deque(maxlen=131072)
        self._clock: Callable[[], float] = time.monotonic

    # -- configuration ------------------------------------------------------
    def configure(
        self,
        enabled: bool = True,
        retention: int = 4096,
        clock: Optional[Callable[[], float]] = None,
    ) -> None:
        with self._lock:
            self._enabled = enabled
            self._retention = max(0, int(retention))
            if clock is not None:
                self._clock = clock
            self._inflight.clear()
            self._completed.clear()
            self._round.clear()
            self._obs.clear()

    @property
    def enabled(self) -> bool:
        return self._enabled and not getattr(_suppress, "on", False)

    # -- marks --------------------------------------------------------------
    def intake(self, pod_name: str) -> None:
        """First-seen for a pending pod; first call per pending epoch wins
        (the applier and the controller callback both stamp it — whichever
        fires first starts the clock)."""
        if not self.enabled:
            return
        with self._lock:
            if pod_name not in self._inflight:
                self._inflight[pod_name] = _Entry(self._clock())

    def mark(self, pod_name: str, mark: str, **attrs: str) -> None:
        if not self.enabled:
            return
        now = self._clock()
        with self._lock:
            entry = self._inflight.get(pod_name)
            if entry is None:
                return
            entry.marks.append((mark, now))
            if attrs:
                entry.attrs.update(attrs)

    def mark_many(self, pod_names: Iterable[str], mark: str, **attrs: str) -> None:
        if not self.enabled:
            return
        now = self._clock()
        with self._lock:
            for name in pod_names:
                entry = self._inflight.get(name)
                if entry is None:
                    continue
                entry.marks.append((mark, now))
                if attrs:
                    entry.attrs.update(attrs)

    # -- completion ---------------------------------------------------------
    def complete(self, pod_name: str, node: str = "") -> Optional[Dict]:
        raws = self._complete_raw([pod_name], node)
        return _render(raws[0]) if raws else None

    def complete_many(self, pod_names: Iterable[str], node: str = "") -> int:
        """The binds landed: close each timeline, buffer the histogram
        sample, feed the SLO engine, and retain the compact record. Batched
        per bind loop so the clock, trace-id and log-context lookups
        amortize across the round (identical for every pod it bound), and
        the stored form is the raw mark timeline — segment aggregation and
        dict assembly happen on READ (:func:`_render`), not per bind.
        Returns the number of timelines closed."""
        return len(self._complete_raw(pod_names, node))

    def _complete_raw(self, pod_names: Iterable[str], node: str) -> List[tuple]:
        if not self.enabled:
            return []
        now = self._clock()
        wall = time.time()
        trace_id = tracing.current_trace_id()
        reconcile_id = str(context_fields().get("reconcile_id", ""))
        out: List[tuple] = []
        e2es: List[float] = []
        with self._lock:
            for pod_name in pod_names:
                entry = self._inflight.pop(pod_name, None)
                if entry is None:
                    continue
                entry.marks.append(("bound", now))
                raw = (
                    pod_name, node, trace_id, reconcile_id,
                    entry.marks, entry.attrs.get("backend", ""), wall,
                )
                if self._retention:
                    self._completed[pod_name] = raw
                    while len(self._completed) > self._retention:
                        self._completed.popitem(last=False)
                self._round.append(raw)
                self._obs.append(entry.marks)
                out.append(raw)
                e2es.append(max(0.0, now - entry.marks[0][1]))
        from . import slo

        for e2e in e2es:
            slo.SLO.observe_latency("pod_ready_p99", e2e)
        return out

    def flush_observations(self) -> None:
        """Fold buffered completion timelines into the stage/e2e histograms.
        Registered as a registry pre-scrape refresher: every exposition
        flushes first, so ``/metrics`` is always current, while the per-pod
        bind path stays one deque append — the scrape thread pays the
        segment aggregation and bucket arithmetic."""
        with self._lock:
            if not self._obs:
                return
            batch = list(self._obs)
            self._obs.clear()
        for marks in batch:
            for stage, dur in _segments(marks).items():
                metrics.POD_LIFECYCLE_STAGE.observe(dur, {"stage": stage})
            metrics.POD_READY.observe(max(0.0, marks[-1][1] - marks[0][1]))

    def discard(self, pod_name: str) -> None:
        """Drop an in-flight entry (the pod was deleted before it bound)."""
        with self._lock:
            self._inflight.pop(pod_name, None)

    def prune_inflight(self, keep: Iterable[str], grace_s: float = 30.0) -> int:
        """Drop in-flight entries not in ``keep`` (the pre-scrape hook's
        path: pods no live cluster still holds as pending have churned
        away). ``grace_s`` protects entries with a recent mark: a pod mid-
        bind leaves the pending set a beat before complete() fires, and a
        scrape landing in that window must not eat its waterfall. Returns
        the number pruned."""
        keep_set = set(keep)
        with self._lock:
            cutoff = self._clock() - grace_s
            stale = [
                n for n, e in self._inflight.items()
                if n not in keep_set and e.marks[-1][1] < cutoff
            ]
            for n in stale:
                del self._inflight[n]
        return len(stale)

    def drain_round(self) -> List[Dict]:
        """Completions since the last drain — the flight recorder's forensic
        capsule output (excluded from replay byte-match like aot_solves).
        Compact form: the raw mark timeline plus correlation ids, NOT the
        rendered waterfall — the capsule is evidence, and marks are the
        source of truth the offline reader derives stages from."""
        with self._lock:
            raws = list(self._round)
            self._round.clear()
        out = []
        for pod, node, trace_id, reconcile_id, marks, backend, _ in raws:
            t0 = marks[0][1]
            out.append({
                "pod": pod, "node": node, "trace_id": trace_id,
                "reconcile_id": reconcile_id, "backend": backend,
                "marks": [[m, t - t0] for m, t in marks],
            })
        return out

    # -- introspection (/debug/lifecycle) -----------------------------------
    def waterfall(self, pod_name: str) -> Optional[Dict]:
        """One pod's waterfall: the completed record when it bound, else the
        in-flight timeline measured against now."""
        with self._lock:
            done = self._completed.get(pod_name)
            if done is not None:
                return dict(_render(done), state="completed")
            entry = self._inflight.get(pod_name)
            if entry is None:
                return None
            now = self._clock()
            t0 = entry.marks[0][1]
            stages = _segments(entry.marks + [("now", now)])
            return {
                "pod": pod_name,
                "state": "in-flight",
                "e2e_s": max(0.0, now - t0),
                "stages": stages,
                "wait_s": sum(v for k, v in stages.items() if k in WAIT_STAGES),
                "work_s": sum(v for k, v in stages.items() if k not in WAIT_STAGES),
                "backend": entry.attrs.get("backend", ""),
                "marks": [[m, t - t0] for m, t in entry.marks],
            }

    def snapshot(self, limit: int = 64) -> Dict:
        """Summary payload: recent completions (newest first) + in-flight
        population, with the aggregate stage totals the dominant-stage
        question reads."""
        with self._lock:
            raws = list(self._completed.values())[-limit:][::-1]
            inflight = len(self._inflight)
        completed = [_render(r) for r in raws]
        totals: Dict[str, float] = {}
        for rec in completed:
            for stage, dur in rec["stages"].items():
                totals[stage] = totals.get(stage, 0.0) + dur
        return {
            "enabled": self._enabled,
            "inflight": inflight,
            "completed": completed,
            "stage_totals_s": {k: round(v, 6) for k, v in sorted(totals.items())},
            "dominant_stage": max(totals, key=totals.get) if totals else "",
        }

    def completed_count(self) -> int:
        with self._lock:
            return len(self._completed)


LIFECYCLE = LifecycleTracker()

# every exposition folds the pending samples in first; module import runs
# once per process, so the hook cannot stack
metrics.REGISTRY.add_refresher(LIFECYCLE.flush_observations)


# -- pre-scrape pruning hook (satellite: deleted pods must not leak) ---------
#: live clusters enrolled for pruning; weakly held so an abandoned test
#: cluster never pins itself (the ICE-cache / scraper-staleness pattern)
_live_clusters: "weakref.WeakSet" = weakref.WeakSet()
_hook_lock = threading.Lock()
_hook_registered = False


def track_cluster_for_pruning(cluster) -> None:
    """Enroll a cluster whose pending set defines which in-flight timelines
    are still live; registers the registry pre-scrape pruner once."""
    global _hook_registered
    with _hook_lock:
        _live_clusters.add(cluster)
        if not _hook_registered:
            metrics.REGISTRY.add_refresher(prune_stale_entries)
            _hook_registered = True


def prune_stale_entries() -> None:
    """Registry pre-scrape refresher: drop in-flight timelines for pods no
    live cluster still holds as pending (deleted mid-flight, or bound via a
    path that bypassed the provisioning bind). No-op with no live cluster —
    a bare-tracker unit test must not have its entries swept."""
    clusters = list(_live_clusters)
    if not clusters:
        return
    keep: set = set()
    for cluster in clusters:
        try:
            keep.update(p.name for p in cluster.pending_pods())
        except Exception:
            # a cluster mid-teardown must not wedge the scrape
            continue
    LIFECYCLE.prune_inflight(keep)
