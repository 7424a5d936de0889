"""Invariant monitor: the soak's continuously-asserted regression oracle.

The port's copy of the JAX package's ``soak/monitor.py``; its one
difference is that the offline replay goes through the port's
``replay_capsule`` on the soak's device.

The harness churns; this module watches. It holds its own informer client
against the apiserver (pod-ready latency, pending population), scrapes the
operator's ``/metrics`` on a sampler thread (reconcile loop lag, resident
set size, backpressure counters, process start time), and at settle time
renders the whole run into a report whose ``violations`` list must be empty:

* **pod-ready p99** — add-to-bind latency per pod (pods the script deletes
  before they bind are dropped, not counted as failures) under a budget;
* **reconcile loop lag** — the max sampled
  ``karpenter_tpu_reconcile_loop_lag_seconds`` under a budget;
* **flat memory** — least-squares slope of windowed
  ``karpenter_tpu_process_memory_bytes`` samples, segmented on
  ``karpenter_tpu_process_start_time_seconds`` (an operator restart resets
  RSS; regressing across the reset would hide — or invent — a leak) with a
  warmup fraction excluded per segment;
* **zero permanently-unschedulable pods** — the pending population drains
  to zero within the settle window once churn stops;
* **zero duplicate launches** — the cloud's reservation log
  (``CloudHTTPService.launch_audit``) shows no client token that committed
  two instances, and no machine pair shares a provider id;
* **no orphaned machines** — every live cloud instance is represented by an
  in-cluster Machine (the GC/link path's contract across operator crashes);
* **byte-identical replay** — every anomaly capsule the operator dumped
  along the way replays to a MATCH via the real replay harness
  (``karpenter_tpu_torch.replay.replay_capsule``), offline;
* **ledger conservation** — every ``/debug/costs`` poll is a settle point:
  the cost ledger's per-consumer attributed spend must equal its metered
  total within f64 tolerance at EVERY sample, and the windowed burn rate
  must stay under a sanity budget while the churn generator runs;
* **perf-sentinel discipline** — ``karpenter_tpu_perf_regression_total``
  and ``/debug/perf`` are scraped throughout; a run that declares
  ``perf_trips_expected=False`` (a clean calibrated soak) must end with
  ZERO sentinel trips, and one declaring ``perf_trips_expected=True`` (an
  injected ``dispatch-hang`` slowdown) must end with at least one — and
  with warmed baselines, so the positive assertion can never pass
  vacuously on a sentinel that never armed.
"""

from __future__ import annotations

import glob
import os
import re
import threading
import time
import urllib.request
from typing import Dict, List, Optional, Tuple

_PROM_LINE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(-?[0-9.eE+-]+|NaN|[+-]Inf)$"
)
_PROM_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_metrics(text: str) -> List[Tuple[str, Dict[str, str], float]]:
    """Minimal Prometheus text-format reader (the monitor consumes the
    operator's own exposition — round-trip compliance is pinned by the
    metrics tests, so a strict line regex is enough here)."""
    out = []
    for line in text.splitlines():
        m = _PROM_LINE.match(line.strip())
        if m is None:
            continue
        try:
            value = float(m.group(3))
        except ValueError:
            continue
        labels = dict(_PROM_LABEL.findall(m.group(2) or ""))
        out.append((m.group(1), labels, value))
    return out


def memory_slope_bps(
    samples: List[Tuple[float, float, float]], warmup_frac: float = 0.25,
    min_samples: int = 8, min_warmup_s: float = 30.0,
    min_span_s: float = 20.0,
) -> Tuple[float, int]:
    """Max least-squares RSS slope (bytes/second) across process
    incarnations. ``samples`` are (t, start_time, rss); segmentation on
    start_time keeps a restart's RSS reset out of the regression, and the
    per-segment warmup — the larger of ``warmup_frac`` of the segment and
    ``min_warmup_s`` — keeps warmup from reading as a leak: every segment
    starts with a process BOOT by definition, and a fresh
    CPython+torch+scipy operator's native arenas climb for ~45 s before
    flattening (measured: a mature incarnation under identical churn holds
    slope ~0). A fraction of a SHORT post-restart segment is not enough to
    exclude that. Returns (max slope across qualifying segments, segments
    used); (0.0, 0) when nothing qualifies."""
    segments: Dict[float, List[Tuple[float, float]]] = {}
    for t, start, rss in samples:
        segments.setdefault(start, []).append((t, rss))
    best, used = 0.0, 0
    for points in segments.values():
        points.sort()
        span = points[-1][0] - points[0][0]
        cutoff = points[0][0] + max(span * warmup_frac, min_warmup_s)
        points = [p for p in points if p[0] >= cutoff]
        # a slope needs a window: a segment whose post-warmup span is
        # shorter than min_span_s (a kill landing near the end of a short
        # run) measures ramp noise, not a trend — skip it rather than read
        # a few seconds of allocator climb as a production leak
        if len(points) < min_samples or points[-1][0] - points[0][0] < min_span_s:
            continue
        n = len(points)
        mean_t = sum(t for t, _ in points) / n
        mean_v = sum(v for _, v in points) / n
        var = sum((t - mean_t) ** 2 for t, _ in points)
        if var <= 0:
            continue
        slope = sum((t - mean_t) * (v - mean_v) for t, v in points) / var
        used += 1
        if used == 1 or slope > best:
            best = slope
    return (best if used else 0.0), used


def _percentile(values: List[float], q: float) -> Optional[float]:
    if not values:
        return None
    ordered = sorted(values)
    idx = min(len(ordered) - 1, max(0, int(round(q * (len(ordered) - 1)))))
    return ordered[idx]


class InvariantMonitor:
    """Wire it to the soak: ``attach(cluster)`` registers the watch callback
    on the monitor's informer client, ``note_added`` is called by the
    injector at pod-create time, ``start_sampling(metrics_url)`` runs the
    operator scrape loop, and ``report(...)`` renders the verdict."""

    def __init__(
        self,
        ready_p99_budget_s: float = 60.0,
        loop_lag_budget_s: float = 20.0,
        mem_slope_budget_bps: float = 262_144.0,
        sample_interval_s: float = 1.0,
        cost_burn_budget_per_hr: float = 10_000.0,
    ):
        self.ready_p99_budget_s = ready_p99_budget_s
        self.loop_lag_budget_s = loop_lag_budget_s
        self.mem_slope_budget_bps = mem_slope_budget_bps
        self.sample_interval_s = sample_interval_s
        # sanity bound, not a spend SLO: the scaled soak fleet is tens of
        # fake nodes at single-digit $/hr — a burn rate past this means the
        # ledger double-counts, not that the bill is real
        self.cost_burn_budget_per_hr = cost_burn_budget_per_hr
        self._lock = threading.Lock()
        self._added: Dict[str, float] = {}     # pod -> add wall time
        self.ready_latencies: List[float] = []
        self.mem_samples: List[Tuple[float, float, float]] = []
        self.loop_lag_max_s = 0.0
        self.backpressure: Dict[str, float] = {}
        # lifecycle stage attribution, scraped from the operator's
        # karpenter_tpu_pod_lifecycle_stage_seconds histogram: cumulative
        # _sum/_count per stage label (max across scrapes — counters only
        # grow within one incarnation)
        self.stage_sums: Dict[str, float] = {}
        self.stage_counts: Dict[str, float] = {}
        self.start_times_seen: set = set()
        # cost-ledger conservation sampling (/debug/costs settle points)
        self.cost_samples = 0
        self.cost_total_dollars = 0.0
        self.cost_burn_max_per_hr = 0.0
        self.cost_conservation_max_err = 0.0
        self.cost_conservation_violations: List[str] = []
        # perf-regression sentinel (utils/profiling.py): max trip count per
        # phase label across scrapes, plus /debug/perf arming telemetry so
        # the expected-trip assertion cannot pass against a sentinel that
        # never warmed a baseline
        self.perf_trips: Dict[str, float] = {}
        self.perf_samples = 0
        self.perf_phases_armed_max = 0
        self.scrape_failures = 0
        self._cluster = None
        self._stop = threading.Event()
        self._sampler: Optional[threading.Thread] = None

    # -- pod-ready latency ---------------------------------------------------
    def note_added(self, name: str, t: Optional[float] = None) -> None:
        with self._lock:
            self._added[name] = time.monotonic() if t is None else t

    def attach(self, cluster) -> None:
        """Register on the monitor's own informer client (an HTTPCluster):
        binds complete latency samples; deletes retract them; a RESYNC
        (apiserver restart, shed-and-relist) completes any pod the relisted
        cache shows bound — the bind happened inside the outage window."""
        self._cluster = cluster
        cluster.watch(self._on_event)

    def _complete(self, name: str, now: float) -> None:
        t_add = self._added.pop(name, None)
        if t_add is not None:
            self.ready_latencies.append(now - t_add)

    def _on_event(self, event: str, obj) -> None:
        now = time.monotonic()
        with self._lock:
            if event == "RESYNCED":
                if self._cluster is None:
                    return
                for name in list(self._added):
                    pod = self._cluster.pods.get(name)
                    if pod is not None and pod.node_name is not None:
                        self._complete(name, now)
                return
            name = getattr(getattr(obj, "meta", None), "name", None)
            if name is None or name not in self._added:
                return
            if event == "DELETED":
                self._added.pop(name, None)  # scripted delete, not a failure
            elif getattr(obj, "node_name", None) is not None:
                self._complete(name, now)

    def pending_tracked(self) -> int:
        with self._lock:
            return len(self._added)

    # -- operator metrics sampling ------------------------------------------
    def sample_operator(self, metrics_url: str) -> bool:
        try:
            with urllib.request.urlopen(metrics_url, timeout=2.0) as resp:
                text = resp.read().decode()
        except Exception:
            self.scrape_failures += 1
            return False
        now = time.monotonic()
        rss = start = None
        for name, labels, value in parse_metrics(text):
            if name == "karpenter_tpu_process_memory_bytes" and not labels:
                rss = value
            elif name == "karpenter_tpu_process_start_time_seconds":
                start = value
            elif name == "karpenter_tpu_reconcile_loop_lag_seconds":
                self.loop_lag_max_s = max(self.loop_lag_max_s, value)
            elif name == "karpenter_tpu_backpressure_events_total":
                action = labels.get("action", "")
                self.backpressure[action] = max(
                    self.backpressure.get(action, 0.0), value
                )
            elif name == "karpenter_tpu_pod_lifecycle_stage_seconds_sum":
                stage = labels.get("stage", "")
                self.stage_sums[stage] = max(
                    self.stage_sums.get(stage, 0.0), value
                )
            elif name == "karpenter_tpu_pod_lifecycle_stage_seconds_count":
                stage = labels.get("stage", "")
                self.stage_counts[stage] = max(
                    self.stage_counts.get(stage, 0.0), value
                )
            elif name == "karpenter_tpu_perf_regression_total":
                phase = labels.get("phase", "")
                self.perf_trips[phase] = max(
                    self.perf_trips.get(phase, 0.0), value
                )
        if rss is not None and start is not None:
            self.mem_samples.append((now, start, rss))
            self.start_times_seen.add(start)
        self._sample_costs(metrics_url)
        self._sample_perf(metrics_url)
        return True

    def _sample_costs(self, metrics_url: str) -> None:
        """Poll ``/debug/costs`` on the same operator: every poll settles the
        ledger, so the conservation verdict is asserted at a REAL settle
        point, not between segment closes. A disabled ledger (or an operator
        predating it) samples nothing — the soak's verdict then simply
        carries zero cost samples rather than a false violation."""
        import json as _json

        base = metrics_url.rsplit("/metrics", 1)[0]
        try:
            with urllib.request.urlopen(f"{base}/debug/costs", timeout=2.0) as resp:
                payload = _json.loads(resp.read().decode())
        except Exception:
            return
        conservation = payload.get("conservation")
        if conservation is None:
            return  # ledger disabled
        self.cost_samples += 1
        self.cost_total_dollars = max(
            self.cost_total_dollars, float(payload.get("total_dollars", 0.0))
        )
        burn = float(payload.get("windowed", {}).get("burn_per_hr", 0.0))
        self.cost_burn_max_per_hr = max(self.cost_burn_max_per_hr, burn)
        err = float(conservation.get("max_abs_error", 0.0))
        self.cost_conservation_max_err = max(self.cost_conservation_max_err, err)
        if not conservation.get("ok", True) and len(
            self.cost_conservation_violations
        ) < 5:
            self.cost_conservation_violations.append(
                f"attributed != metered: max_abs_error={err:.3e} "
                f"tolerance={conservation.get('tolerance')}"
            )

    def _sample_perf(self, metrics_url: str) -> None:
        """Poll ``/debug/perf``: how many phase/bucket baselines are armed.
        The expected-trip soak assertion requires at least one armed
        baseline — otherwise "the fault tripped the sentinel" would be
        vacuously checkable against a sentinel that never warmed."""
        import json as _json

        base = metrics_url.rsplit("/metrics", 1)[0]
        try:
            with urllib.request.urlopen(f"{base}/debug/perf", timeout=2.0) as resp:
                payload = _json.loads(resp.read().decode())
        except Exception:
            return
        if not payload.get("enabled"):
            return
        self.perf_samples += 1
        armed = sum(
            1
            for doc in payload.get("phases", {}).values()
            if doc.get("baseline")
        )
        self.perf_phases_armed_max = max(self.perf_phases_armed_max, armed)

    def start_sampling(self, metrics_url: str) -> None:
        def loop() -> None:
            while not self._stop.wait(self.sample_interval_s):
                self.sample_operator(metrics_url)

        self._sampler = threading.Thread(target=loop, daemon=True)
        self._sampler.start()

    def stop_sampling(self) -> None:
        self._stop.set()
        if self._sampler is not None:
            self._sampler.join(timeout=5)

    # -- offline capsule replay ---------------------------------------------
    def replay_dumped_capsules(
        self, dump_dir: str, limit: int = 0, device: str = "cuda"
    ) -> Dict:
        """Replay every anomaly capsule the operator dumped, through the real
        offline harness, and demand byte-identical MATCH verdicts. Capsules
        that captured no inputs (a reconcile that failed before capture) are
        skipped, not failed — there is nothing to replay. ``limit`` > 0 caps
        the count (newest first) for time-boxed runs; the default replays
        everything, which is the acceptance criterion. ``device`` places
        the replay's ``TorchSolver`` (the port's addition)."""
        from ..replay import load_capsule, replay_capsule

        paths = sorted(
            glob.glob(os.path.join(dump_dir, "capsule-*.json.gz")),
            key=os.path.getmtime,
            reverse=True,
        )
        if limit > 0:
            paths = paths[:limit]
        out = {"found": len(paths), "replayed": 0, "skipped": 0,
               "matched": 0, "mismatched": [], "errors": []}
        for path in paths:
            try:
                capsule = load_capsule(path)
            except (OSError, ValueError) as e:
                out["errors"].append(f"{os.path.basename(path)}: load: {e}")
                continue
            if not capsule.get("inputs", {}).get("objects"):
                out["skipped"] += 1
                continue
            try:
                report = replay_capsule(capsule, device=device)
            except Exception as e:
                out["errors"].append(
                    f"{os.path.basename(path)}: {type(e).__name__}: {e}"
                )
                continue
            out["replayed"] += 1
            if report.get("match"):
                out["matched"] += 1
            else:
                out["mismatched"].append(capsule.get("id", os.path.basename(path)))
        return out

    # -- verdict -------------------------------------------------------------
    def report(
        self,
        pending_end: int,
        launch_audit: Dict,
        orphan_instances: List[str],
        replay: Optional[Dict] = None,
        events_total: int = 0,
        duration_s: float = 0.0,
        restarts: Optional[Dict] = None,
        perf_trips_expected: Optional[bool] = None,
    ) -> Dict:
        slope, segments = memory_slope_bps(self.mem_samples)
        p50 = _percentile(self.ready_latencies, 0.50)
        p99 = _percentile(self.ready_latencies, 0.99)
        # dominant lifecycle stage: where the aggregate pod wall-clock went
        # (scraped stage _sum totals) — a p99 violation names its suspect
        # instead of just tripping
        dominant = (
            max(self.stage_sums, key=self.stage_sums.get)
            if self.stage_sums else ""
        )
        violations: List[str] = []
        if p99 is not None and p99 > self.ready_p99_budget_s:
            blame = (
                f" (dominant stage: {dominant}, "
                f"{self.stage_sums[dominant]:.1f}s total)"
                if dominant else ""
            )
            violations.append(
                f"pod-ready p99 {p99:.1f}s > budget "
                f"{self.ready_p99_budget_s}s{blame}"
            )
        if self.loop_lag_max_s > self.loop_lag_budget_s:
            violations.append(
                f"reconcile loop lag {self.loop_lag_max_s:.1f}s > budget "
                f"{self.loop_lag_budget_s}s"
            )
        if slope > self.mem_slope_budget_bps:
            violations.append(
                f"memory slope {slope / 1024:.0f} KiB/s > budget "
                f"{self.mem_slope_budget_bps / 1024:.0f} KiB/s (leak)"
            )
        if pending_end != 0:
            violations.append(
                f"{pending_end} pods still pending after settle "
                "(permanently unschedulable)"
            )
        if launch_audit.get("duplicate_tokens"):
            violations.append(
                f"duplicate launches: {launch_audit['duplicate_tokens']}"
            )
        if orphan_instances:
            violations.append(
                f"{len(orphan_instances)} orphaned cloud instances: "
                f"{sorted(orphan_instances)[:5]}"
            )
        if self.cost_conservation_violations:
            violations.append(
                f"cost-ledger conservation broke at "
                f"{len(self.cost_conservation_violations)} settle points: "
                f"{self.cost_conservation_violations[:3]}"
            )
        if self.cost_burn_max_per_hr > self.cost_burn_budget_per_hr:
            violations.append(
                f"cost burn rate {self.cost_burn_max_per_hr:.1f}$/hr > "
                f"sanity budget {self.cost_burn_budget_per_hr:.1f}$/hr "
                "(ledger double-count, not a real bill)"
            )
        perf_trips_total = sum(self.perf_trips.values())
        if perf_trips_expected is False and perf_trips_total > 0:
            violations.append(
                f"perf sentinel false-tripped on a clean run: "
                f"{ {k: int(v) for k, v in sorted(self.perf_trips.items())} }"
            )
        elif perf_trips_expected is True:
            # non-vacuous: the positive case must show the sentinel both
            # ARMED (warmed baselines observed on /debug/perf) and TRIPPED
            if self.perf_phases_armed_max == 0:
                violations.append(
                    "perf sentinel never armed a baseline — the injected "
                    "slowdown assertion is vacuous"
                )
            if perf_trips_total == 0:
                violations.append(
                    "injected dispatch-hang slowdown did not trip the perf "
                    "sentinel"
                )
        if replay is not None:
            if replay.get("mismatched"):
                violations.append(
                    f"{len(replay['mismatched'])} anomaly capsules diverged "
                    f"on replay: {replay['mismatched'][:5]}"
                )
            if replay.get("errors"):
                violations.append(
                    f"{len(replay['errors'])} capsules failed to replay: "
                    f"{replay['errors'][:3]}"
                )
        return {
            "duration_s": round(duration_s, 2),
            "events_total": events_total,
            "events_per_s": (
                round(events_total / duration_s, 1) if duration_s > 0 else 0.0
            ),
            "pod_ready_samples": len(self.ready_latencies),
            "pod_ready_p50_s": round(p50, 3) if p50 is not None else None,
            "pod_ready_p99_s": round(p99, 3) if p99 is not None else None,
            "dominant_stage": dominant,
            "stage_totals_s": {
                k: round(v, 3) for k, v in sorted(self.stage_sums.items())
            },
            "stage_counts": {
                k: int(v) for k, v in sorted(self.stage_counts.items())
            },
            "loop_lag_max_s": round(self.loop_lag_max_s, 3),
            "mem_slope_bytes_per_s": round(slope, 1),
            "mem_segments": segments,
            "mem_samples": len(self.mem_samples),
            "operator_incarnations": len(self.start_times_seen),
            "backpressure": {k: int(v) for k, v in sorted(self.backpressure.items())},
            "pending_end": pending_end,
            "launch_audit": {
                k: v for k, v in launch_audit.items() if k != "duplicate_tokens"
            },
            "duplicate_tokens": launch_audit.get("duplicate_tokens", {}),
            "orphan_instances": sorted(orphan_instances),
            "cost": {
                "samples": self.cost_samples,
                "total_dollars": round(self.cost_total_dollars, 6),
                "burn_max_per_hr": round(self.cost_burn_max_per_hr, 6),
                "conservation_max_abs_error": self.cost_conservation_max_err,
                "conservation_ok": not self.cost_conservation_violations,
            },
            "perf": {
                "trips": {k: int(v) for k, v in sorted(self.perf_trips.items())},
                "trips_total": int(perf_trips_total),
                "trips_expected": perf_trips_expected,
                "samples": self.perf_samples,
                "phases_armed_max": self.perf_phases_armed_max,
            },
            "replay": replay,
            "restarts": restarts or {},
            "violations": violations,
            "ok": not violations,
        }
