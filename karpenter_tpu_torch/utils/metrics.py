"""Prometheus-style in-process metrics registry.

Mirrors the reference's metric catalog shape (counters/histograms with label
dimensions — upstream ``pkg/controllers/interruption/metrics.go:31-66``,
``designs/metrics.md:199-247``) plus the STATE gauges its
``pkg/controllers/metrics/{pod,node,provisioner}`` scrapers maintain
(``karpenter_pods_state``, ``karpenter_nodes_allocatable``,
``karpenter_provisioner_usage``/``limit``). Exposition is text-format
(version 0.0.4) compliant — ``# HELP``/``# TYPE`` lines, label-value
escaping, artifact-free number rendering — so the registry backs the real
``/metrics`` scrape endpoint (utils/httpserver.py) and external parsers
round-trip it.
"""

from __future__ import annotations

import math
import threading
from bisect import bisect_right
from contextlib import contextmanager
from time import perf_counter
from typing import Dict, List, Optional, Sequence, Tuple

_DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

#: schedulable-latency shape: pod-created -> bound spans seconds-to-minutes,
#: not the sub-second solver-latency shape of _DEFAULT_BUCKETS
_LATENCY_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 300.0)

LabelKey = Tuple[Tuple[str, str], ...]


def _key(labels: Optional[Dict[str, str]]) -> LabelKey:
    return tuple(sorted((labels or {}).items()))


def series_key(labels: Dict[str, str]) -> LabelKey:
    """Prebuild a series key for ``Gauge.set_series`` (sorted label tuple —
    the registry's canonical series identity)."""
    return tuple(sorted(labels.items()))


def _fmt_value(v: float) -> str:
    """Render a sample value without Python float artifacts: integral values
    as integers (``1`` not ``1.0``), others via repr (shortest round-trip
    form, so ``0.1`` never renders as ``0.1000000000000000055``)."""
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _esc_label(value: str) -> str:
    """Label-value escaping per the text format: backslash, double-quote and
    line-feed must be escaped or the line is unparseable. Guarded fast path:
    virtually no real label value needs escaping, and exposition renders
    every label of every series per scrape."""
    s = str(value)
    if "\\" in s or '"' in s or "\n" in s:
        s = s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    return s


def _esc_help(text: str) -> str:
    """HELP-line escaping: backslash and line-feed only (the text format
    leaves quotes alone on comment lines)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(k: LabelKey, le: Optional[str] = None) -> str:
    items = list(k) + ([("le", le)] if le is not None else [])
    if not items:
        return ""
    parts = [f'{name}="{_esc_label(value)}"' for name, value in items]
    return "{" + ",".join(parts) + "}"


#: rendered-label-string memo bound (series keys repeat scrape over scrape;
#: the cache resets rather than grows past this, bounding label churn)
_FMT_CACHE_MAX = 32768


def _fmt_cached(cache: Dict, k: LabelKey, le: Optional[str] = None) -> str:
    key = (k, le)
    s = cache.get(key)
    if s is None:
        if len(cache) >= _FMT_CACHE_MAX:
            cache.clear()
        s = cache[key] = _fmt(k, le)
    return s


class Counter:
    kind = "counter"

    def __init__(self, name: str, help: str = "", registry: "Registry | None" = None):
        self.name = name
        self.help = help
        self._values: Dict[LabelKey, float] = {}
        self._fmt_cache: Dict = {}
        self._lock = threading.Lock()
        if registry is not None:
            registry.register(self)

    def inc(self, labels: Optional[Dict[str, str]] = None, value: float = 1.0) -> None:
        k = _key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value

    def value(self, labels: Optional[Dict[str, str]] = None) -> float:
        return self._values.get(_key(labels), 0.0)

    def clear(self) -> None:
        """Drop every labeled series (series for deleted objects must not
        linger forever)."""
        with self._lock:
            self._values.clear()

    def replace_series(self, values: Dict[LabelKey, float]) -> None:
        """Atomically publish a full new series set (keys from
        ``series_key``): the state scrapers build the next view off-lock and
        swap it in one step, so a concurrent /metrics exposition never sees
        an empty or half-populated gauge — and stale series drop with the
        same swap."""
        with self._lock:
            self._values = dict(values)

    def prune_series(self, keep) -> int:
        """Drop every series whose label dict fails ``keep`` (the registry's
        pre-scrape staleness hooks use this so gauges fed between scraper
        passes never expose series for objects that no longer exist).
        Returns the number of series dropped."""
        with self._lock:
            dead = [k for k in self._values if not keep(dict(k))]
            for k in dead:
                del self._values[k]
        return len(dead)

    def _header(self) -> List[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {_esc_help(self.help)}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        return lines

    def collect(self) -> List[str]:
        # insertion order, not sorted: the text format doesn't require sorted
        # series, and sorting thousands of state-gauge series every scrape is
        # the single biggest exposition cost
        with self._lock:
            items = list(self._values.items())
        lines = self._header()
        name, cache = self.name, self._fmt_cache
        for k, v in items:
            lines.append(f"{name}{_fmt_cached(cache, k)} {_fmt_value(v)}")
        return lines


class Gauge(Counter):
    kind = "gauge"

    def set(self, value: float, labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._values[_key(labels)] = value

    def set_series(self, key: LabelKey, value: float) -> None:
        """Hot-path set with a prebuilt series key (``series_key``): the
        state scrapers emit the same label set into several gauges per
        resource — building and sorting the key once, not per gauge, is a
        third of a large-fleet scrape pass."""
        with self._lock:
            self._values[key] = value


class Histogram:
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        buckets: Sequence[float] = _DEFAULT_BUCKETS,
        registry: "Registry | None" = None,
    ):
        self.name = name
        self.help = help
        self.buckets = list(buckets)
        self._counts: Dict[LabelKey, List[int]] = {}
        self._sums: Dict[LabelKey, float] = {}
        self._totals: Dict[LabelKey, int] = {}
        self._fmt_cache: Dict = {}
        self._lock = threading.Lock()
        if registry is not None:
            registry.register(self)

    def observe(self, value: float, labels: Optional[Dict[str, str]] = None) -> None:
        k = _key(labels)
        with self._lock:
            if k not in self._counts:
                self._counts[k] = [0] * len(self.buckets)
                self._sums[k] = 0.0
                self._totals[k] = 0
            i = bisect_right(self.buckets, value)
            for j in range(i, len(self.buckets)):
                self._counts[k][j] += 1
            self._sums[k] += value
            self._totals[k] += 1

    def count(self, labels: Optional[Dict[str, str]] = None) -> int:
        return self._totals.get(_key(labels), 0)

    @contextmanager
    def time(self, labels: Optional[Dict[str, str]] = None):
        """Context manager observing the elapsed wall time."""
        t0 = perf_counter()
        try:
            yield
        finally:
            self.observe(perf_counter() - t0, labels)

    def sum(self, labels: Optional[Dict[str, str]] = None) -> float:
        return self._sums.get(_key(labels), 0.0)

    def collect(self) -> List[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {_esc_help(self.help)}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        with self._lock:
            snapshot = [
                (k, list(counts), self._sums[k], self._totals[k])
                for k, counts in self._counts.items()
            ]
        name, cache = self.name, self._fmt_cache
        for k, counts, total_sum, total in snapshot:
            for b, c in zip(self.buckets, counts):
                lines.append(f"{name}_bucket{_fmt_cached(cache, k, le=_fmt_value(b))} {c}")
            lines.append(f'{name}_bucket{_fmt_cached(cache, k, le="+Inf")} {total}')
            lines.append(f"{name}_sum{_fmt_cached(cache, k)} {_fmt_value(total_sum)}")
            lines.append(f"{name}_count{_fmt_cached(cache, k)} {total}")
        return lines


class Registry:
    def __init__(self) -> None:
        self._collectors: List = []
        self._refreshers: List = []
        self._lock = threading.Lock()

    def register(self, collector) -> None:
        with self._lock:
            self._collectors.append(collector)

    def add_refresher(self, fn) -> None:
        """Register a pre-scrape hook: called at the start of every
        exposition so gauges fed from expiring state (e.g. the ICE cache)
        render CURRENT values. Refreshers are not collectors — they emit no
        series of their own."""
        with self._lock:
            self._refreshers.append(fn)

    def collectors(self) -> List:
        with self._lock:
            return list(self._collectors)

    def exposition(self) -> str:
        with self._lock:
            refreshers = list(self._refreshers)
        for fn in refreshers:
            fn()
        lines: List[str] = []
        for c in self.collectors():
            lines.extend(c.collect())
        return "\n".join(lines) + "\n"


# Global default registry + the framework metric catalog (names mirror the
# reference's karpenter_* metrics, designs/metrics.md).
REGISTRY = Registry()

# -- action counters/timers (what the controllers DID) -----------------------
PODS_SCHEDULED = Counter(
    "karpenter_tpu_pods_scheduled_total",
    help="Pods bound to a node by the provisioning controller.",
    registry=REGISTRY,
)
PODS_UNSCHEDULABLE = Gauge(
    "karpenter_tpu_pods_unschedulable",
    help="Pods the last provisioning pass could not place on any offering.",
    registry=REGISTRY,
)
GANG_VERDICTS = Counter(
    "karpenter_tpu_gang_verdicts_total",
    help="Gang-gate verdicts per pod group per round, labeled by outcome: "
         "admitted, deferred (atomic placement impossible), "
         "deferred-insufficient-members (below quorum), admitted-preemption "
         "(placed after evicting victims).",
    registry=REGISTRY,
)
PREEMPTION_EVICTIONS = Counter(
    "karpenter_tpu_preemption_evictions_total",
    help="Pods evicted by the preemption planner to place higher-priority "
         "demand, labeled by preemptor kind (gang or pod).",
    registry=REGISTRY,
)
GANG_HOP_DISTANCE = Histogram(
    "karpenter_tpu_gang_hop_distance",
    help="Mean pairwise ICI hop distance of each admitted gang's placement "
         "(solver/topology.py metric: ring-metric hops inside a torus, "
         "CROSS_POD/CROSS_ZONE constants across domains/zones). Observed "
         "once per gang admission while slice topology is enabled; the "
         "histogram p50 is the bench's adjacency headline.",
    registry=REGISTRY,
    buckets=(0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0),
)
PREEMPT_OR_LAUNCH = Counter(
    "karpenter_tpu_preempt_or_launch_total",
    help="Preempt-or-launch cost decisions, labeled by verdict: evict (the "
         "victim price delta plus restart tax undercut the launch price), "
         "launch (fresh capacity was cheaper), or evict-unpriced (no launch "
         "plan existed, the last-resort regime).",
    registry=REGISTRY,
)
NODES_CREATED = Counter(
    "karpenter_tpu_nodes_created_total",
    help="Nodes launched, labeled by owning provisioner.",
    registry=REGISTRY,
)
NODES_TERMINATED = Counter(
    "karpenter_tpu_nodes_terminated_total",
    help="Nodes drained and deleted by the termination controller.",
    registry=REGISTRY,
)
SOLVE_DURATION = Histogram(
    "karpenter_tpu_solve_duration_seconds",
    help="End-to-end solver latency (encode, backend race, decode, validate).",
    registry=REGISTRY,
)
SOLVE_PHASE = Histogram(
    "karpenter_tpu_solve_phase_seconds",
    help="Solver phase latency (encode/presolve/stage/solve/decode/"
         "validate/gather), labeled by phase and by the round's encode "
         "mode (delta/full) — the continuous view of the incremental-"
         "encode win; {phase=stage} separates host-to-device staging from "
         "encode and solve, {phase=validate} is the placement-validation "
         "firewall's per-evaluation cost (budgeted < 5% of round p50), "
         "and {phase=gather} is the meshed tier's once-per-fleet cross-"
         "device result assembly.",
    registry=REGISTRY,
)
RECONCILE_DURATION = Histogram(
    "karpenter_tpu_controller_reconcile_duration_seconds",
    help="Reconcile wall time per controller loop.",
    registry=REGISTRY,
)
RECONCILE_ERRORS = Counter(
    "karpenter_tpu_controller_reconcile_errors_total",
    help="Reconcile crashes per controller (each backs that loop off exponentially).",
    registry=REGISTRY,
)
PROVISIONING_DURATION = Histogram(
    "karpenter_tpu_provisioning_duration_seconds",
    help="Full provisioning pass latency: solve plus launch plus bind.",
    registry=REGISTRY,
)
DEPROVISIONING_ACTIONS = Counter(
    "karpenter_tpu_deprovisioning_actions_total",
    help="Executed deprovisioning actions (delete/replace), labeled by action.",
    registry=REGISTRY,
)
CONSOLIDATION_SWEEP = Histogram(
    "karpenter_tpu_consolidation_sweep_seconds",
    help="Consolidation sweep duration (the multi-node prefix search and the "
         "single-node candidate scan each observe one sample per pass).",
    registry=REGISTRY,
)
CONSOLIDATION_SWEEP_TRUNCATED = Counter(
    "karpenter_tpu_consolidation_sweep_truncated_total",
    help="Consolidation sweeps cut short by the wall-clock budget.",
    registry=REGISTRY,
)
INTERRUPTION_MESSAGES = Counter(
    "karpenter_tpu_interruption_messages_total",
    help="Interruption queue messages processed, labeled by message kind.",
    registry=REGISTRY,
)
RISK_OBSERVATIONS = Counter(
    "karpenter_tpu_risk_observations_total",
    help="Realized capacity-pool risk events fed into the interruption-risk "
         "cache, labeled by kind (interruption: a reclaim landed; rebalance: "
         "the cloud recommended moving off the pool).",
    registry=REGISTRY,
)
REBALANCE_ACTIONS = Counter(
    "karpenter_tpu_rebalance_actions_total",
    help="Proactive rebalance-controller actions, labeled by action: "
         "replacement-launched (capacity opened before draining), "
         "drained-after-replacement (replacement Ready, original drained), "
         "deadline-drain (notice window expired before the replacement was "
         "Ready; plain cordon-and-drain), immediate-drain (no replacement "
         "pool available).",
    registry=REGISTRY,
)
SPOT_DIVERSIFICATION = Counter(
    "karpenter_tpu_spot_diversification_total",
    help="Spot-pool diversification gate verdicts per unit per round, "
         "labeled by outcome: respread (over-cap members stripped and "
         "re-solved with the pool masked) or accepted (cap exceeded but "
         "enforcement yielded — placement outranks spread).",
    registry=REGISTRY,
)
# multi-cluster federation (federation/arbiter.py): lease routing outcomes,
# the fencing epoch, and per-cluster summary freshness. Summary-age series
# are replaced wholesale by the pre-scrape refresher (replace_series), so a
# cluster that leaves the federation takes its series with it.
FEDERATION_LEASES = Counter(
    "karpenter_tpu_federation_leases_total",
    help="Federation arbiter lease outcomes, labeled by outcome: granted "
         "(fresh lease minted), renewed (idempotent re-request of a valid "
         "lease), no-capacity, degraded-local (cluster scheduled on local "
         "authority behind an open arbiter breaker), confirmed / fenced / "
         "expired / unknown (lease confirmation verdicts — fenced means an "
         "epoch bump invalidated the lease), stale-seq (summary intake "
         "dropped a duplicate or reordered delivery).",
    registry=REGISTRY,
)
FEDERATION_EPOCH = Gauge(
    "karpenter_tpu_federation_epoch",
    help="Current federation fencing epoch; bumps on every membership "
         "transition (region lost or rejoined) and invalidates every "
         "outstanding placement lease.",
    registry=REGISTRY,
)
FEDERATION_SUMMARY_AGE = Gauge(
    "karpenter_tpu_federation_summary_age_seconds",
    help="Age of each member cluster's last accepted capacity summary, "
         "labeled by cluster (pre-scrape refreshed; stale members past the "
         "staleness window are declared lost by the arbiter sweep).",
    registry=REGISTRY,
)
CLOUDPROVIDER_DURATION = Histogram(
    "karpenter_tpu_cloudprovider_duration_seconds",
    help="Cloud provider API call latency, labeled by method.",
    registry=REGISTRY,
)
CLOUDPROVIDER_ERRORS = Counter(
    "karpenter_tpu_cloudprovider_errors_total",
    help="Cloud provider API call failures.",
    registry=REGISTRY,
)
# pattern column generation (solver/patterns.py, solver/topo.py): improved
# plans RETURNED (cached or freshly built) and the savings they delivered
PATTERN_IMPROVEMENTS = Counter(
    "karpenter_tpu_pattern_improvements_total",
    help="Improved packing plans returned by the pattern column generator.",
    registry=REGISTRY,
)
PATTERN_SAVINGS = Counter(
    "karpenter_tpu_pattern_savings_dollars_total",
    help="Cumulative $/hr saved by pattern-generated plans over the baseline plan.",
    registry=REGISTRY,
)
# AOT executable cache (solver/jax_solver.py AOTCache): bucketed kernel
# executables served/compiled/evicted — the cold-solve amortization layer
AOT_CACHE_EVENTS = Counter(
    "karpenter_tpu_aot_cache_events_total",
    help="Kernel executable-cache events, labeled by event: hit (dispatch "
         "served by a resident bucket executable), miss (bucket not "
         "resident), compile (an executable was built — or loaded from the "
         "on-disk compilation cache), evict (LRU capacity eviction).",
    registry=REGISTRY,
)
# solver fault domain (solver/validate.py firewall + the kernel-backend
# circuit breaker in solver/solver.py)
SOLVER_VALIDATION = Counter(
    "karpenter_tpu_solver_validation_total",
    help="Placement-validation firewall verdicts on solver plans before "
         "bind, labeled by outcome: accepted, rejected (the plan violated a "
         "hard constraint and the round re-solved on the fallback backend), "
         "rejected-final (the fallback plan was ALSO invalid — the round "
         "bound nothing).",
    registry=REGISTRY,
)
VALIDATION_VIOLATIONS = Counter(
    "karpenter_tpu_validation_violations_total",
    help="Individual firewall violations by code: capacity, compat, "
         "taints, double-placement, unknown-pod, unknown-node, gang-split, "
         "slice-adjacency, diversification, launch-limits.",
    registry=REGISTRY,
)
KERNEL_FAULTS = Counter(
    "karpenter_tpu_kernel_faults_total",
    help="Device-path failures observed by the kernel backend, labeled by "
         "kind: compile-error, dispatch-timeout, dispatch-error, "
         "device-oom, invalid-plan (count-level validation rejected the "
         "kernel answer), nonfinite-plan (NaN/Inf costs).",
    registry=REGISTRY,
)
KERNEL_BACKEND_HEALTH = Gauge(
    "karpenter_tpu_kernel_backend_health",
    help="Health score of the kernel backend: the fraction of consulted "
         "executable-bucket breakers currently closed (1.0 = fully "
         "healthy; 0.0 = every bucket quarantined, all solves degraded to "
         "the host paths). Per-bucket breaker state is in "
         "karpenter_tpu_rpc_breaker_state{service=\"kernel\"}.",
    registry=REGISTRY,
)
# delta-aware device staging (solver/staging.py DeviceStager): problem
# tensors kept resident on device across rounds — the cold-solve data
# movement layer
DEVICE_STAGING = Counter(
    "karpenter_tpu_device_staging_total",
    help="Device staging-cache events, labeled by event: hit (a problem "
         "tensor served from device residency, zero transfer), restage (a "
         "leaf patched by scatter-updating only its churned rows), evict "
         "(capacity eviction), invalidate (residency dropped: bucket "
         "growth, shape/axes change, settings flip).",
    registry=REGISTRY,
)
# incremental reconcile encoding (solver/session.py EncodeSession)
ENCODE_MODE = Counter(
    "karpenter_tpu_encode_mode_total",
    help="Encodes by mode: delta (row/column patch of the previous round) "
         "vs full (first encode, structural change, or fallback).",
    registry=REGISTRY,
)
ENCODE_FULL_REASONS = Counter(
    "karpenter_tpu_encode_full_reasons_total",
    help="Why an EncodeSession round fell back to a full encode "
         "(first-encode, axes-changed, zones-changed, pod-set-desync, "
         "weight-degate, periodic-resync, relist, provisioner-change, ...).",
    registry=REGISTRY,
)
# fleet dispatch (solver stage_fleet + the provisioning sharded path)
FLEET_DISPATCH = Counter(
    "karpenter_tpu_fleet_dispatch_total",
    help="Batched kernel device calls fired by fleet dispatch, labeled by "
         "the fleet executable bucket (the B-suffixed shape label); each "
         "call solved up to B same-bucket cell problems at once.",
    registry=REGISTRY,
)
MESH_DISPATCH = Counter(
    "karpenter_tpu_mesh_dispatch_total",
    help="Superproblem dispatches onto the 2D (options x fleet) device "
         "mesh, labeled by the mesh axes (e.g. 4x2) — each one solved a "
         "whole same-bucket batch of cells as ONE multi-chip device "
         "program; zero while mesh_enabled is off or on single-device "
         "hosts.",
    registry=REGISTRY,
)
FLEET_ROUND_DISPATCHES = Gauge(
    "karpenter_tpu_fleet_round_dispatches",
    help="Batched device dispatches the last sharded provisioning round "
         "issued (O(distinct buckets); cells the fleet could not batch — "
         "tiny, cold bucket, race memory — dispatch per-cell and are not "
         "counted here).",
    registry=REGISTRY,
)
# cell-sharded control plane (state/cells.py + the provisioning sharded path)
CELLS_TOTAL = Gauge(
    "karpenter_tpu_cells_total",
    help="Cells in the current control-plane partition (0 while cell "
         "sharding is off or before the first sharded round).",
    registry=REGISTRY,
)
CELL_PODS = Gauge(
    "karpenter_tpu_cell_pods",
    help="Pending pods routed to each cell in the last sharded round, "
         "labeled by bounded cell id (small integer index in sorted-key "
         "order, not the cell name; 'residue' is the cross-cell class).",
    registry=REGISTRY,
)
CONSOLIDATION_SWEEP_CANDIDATES = Counter(
    "karpenter_tpu_consolidation_sweep_candidates_total",
    help="Single-node consolidation what-if simulations evaluated, labeled "
         "by execution mode (serial/parallel).",
    registry=REGISTRY,
)

# -- cluster-state gauges (what the cluster IS — maintained by the
# controllers/metricsscraper scrapers, mirroring the reference's
# pkg/controllers/metrics/{node,pod,provisioner} controllers) ---------------
NODES_ALLOCATABLE = Gauge(
    "karpenter_tpu_nodes_allocatable",
    help="Node allocatable per resource, labeled by node identity "
         "(provisioner/zone/instance-type/capacity-type/phase).",
    registry=REGISTRY,
)
NODES_POD_REQUESTS = Gauge(
    "karpenter_tpu_nodes_total_pod_requests",
    help="Sum of resource requests of pods bound to the node, per resource.",
    registry=REGISTRY,
)
NODES_UTILIZATION = Gauge(
    "karpenter_tpu_nodes_utilization",
    help="Requested/allocatable ratio per node and resource (0 to 1; >1 means overcommit).",
    registry=REGISTRY,
)
PODS_STATE = Gauge(
    "karpenter_tpu_pods_state",
    help="Pod count by phase, owner kind and hosting provisioner.",
    registry=REGISTRY,
)
POD_SCHEDULE_LATENCY = Histogram(
    "karpenter_tpu_pods_schedule_latency_seconds",
    help="Pod-created to pod-bound latency, labeled by hosting provisioner.",
    buckets=_LATENCY_BUCKETS,
    registry=REGISTRY,
)
PROVISIONER_USAGE = Gauge(
    "karpenter_tpu_provisioner_usage",
    help="Capacity footprint of a provisioner's nodes per resource (compared against limits).",
    registry=REGISTRY,
)
PROVISIONER_LIMIT = Gauge(
    "karpenter_tpu_provisioner_limit",
    help="Provisioner resource ceiling per resource, when spec.limits is set.",
    registry=REGISTRY,
)
STATE_SCRAPE_DURATION = Histogram(
    "karpenter_tpu_state_scrape_duration_seconds",
    help="Wall time of one state-scraper pass, labeled by scraper.",
    registry=REGISTRY,
)

# -- RPC resilience (utils/resilience.py: retries, breakers, ICE cache) ------
RPC_REQUESTS = Counter(
    "karpenter_tpu_rpc_requests_total",
    help="RPC calls through the resilience layer by service, endpoint and "
         "outcome (ok/terminal/exhausted/deadline).",
    registry=REGISTRY,
)
RPC_RETRIES = Counter(
    "karpenter_tpu_rpc_retries_total",
    help="Retries of transient RPC failures (429/5xx/connection errors), "
         "by service and endpoint.",
    registry=REGISTRY,
)
RPC_BREAKER_STATE = Gauge(
    "karpenter_tpu_rpc_breaker_state",
    help="Circuit breaker state per service and endpoint "
         "(0=closed, 1=open, 2=half-open).",
    registry=REGISTRY,
)
RPC_BREAKER_TRANSITIONS = Counter(
    "karpenter_tpu_rpc_breaker_transitions_total",
    help="Circuit breaker state transitions by service, endpoint and target state.",
    registry=REGISTRY,
)
RPC_OFFERING_UNAVAILABLE = Gauge(
    "karpenter_tpu_rpc_offering_unavailable",
    help="Offerings currently masked by the insufficient-capacity (ICE) cache, "
         "labeled by instance type, zone and capacity type (1 while masked).",
    registry=REGISTRY,
)

# -- decision audit log (utils/decisions.py) ---------------------------------
DECISIONS_TOTAL = Counter(
    "karpenter_tpu_decisions_total",
    help="Scheduling decisions recorded in the audit log, labeled by kind "
         "(placement/nomination/consolidation) and outcome.",
    registry=REGISTRY,
)

# -- flight recorder (utils/flightrecorder.py, /debug/flightrecorder) --------
FLIGHTRECORDER_CAPSULES = Counter(
    "karpenter_tpu_flightrecorder_capsules_total",
    help="Reconcile capsules committed to the flight-recorder ring, labeled "
         "by controller.",
    registry=REGISTRY,
)
FLIGHTRECORDER_ANOMALIES = Counter(
    "karpenter_tpu_flightrecorder_anomalies_total",
    help="Anomaly triggers stamped on flight-recorder capsules "
         "(reconcile-error, unschedulable-pods, full-encode fallback, "
         "breaker-open), labeled by trigger.",
    registry=REGISTRY,
)
FLIGHTRECORDER_CAPTURE = Histogram(
    "karpenter_tpu_flightrecorder_capture_seconds",
    help="Wall time spent capturing one capsule's inputs (snapshot "
         "serialization rides the reconcile hot path; the bench guard holds "
         "it under 5% of the round p50).",
    registry=REGISTRY,
)
FLIGHTRECORDER_DUMPS = Counter(
    "karpenter_tpu_flightrecorder_dumps_total",
    help="Capsules written to disk, labeled by trigger (anomaly/manual).",
    registry=REGISTRY,
)

# -- runtime health (utils/runtimehealth.py) ---------------------------------
RECONCILE_LOOP_LAG = Gauge(
    "karpenter_tpu_reconcile_loop_lag_seconds",
    help="Scheduled-vs-actual start delta of the last reconcile, per "
         "INTERVAL-scheduled controller loop (scrapers, drift, GC, ...): "
         "how late the kit ran a due controller — loop contention shows up "
         "here before latency histograms. Every-tick controllers emit no "
         "lag series (they have no schedule to be late against).",
    registry=REGISTRY,
)
PROCESS_MEMORY = Gauge(
    "karpenter_tpu_process_memory_bytes",
    help="Operator process resident set size, refreshed pre-scrape "
         "(utils/runtimehealth.py).",
    registry=REGISTRY,
)
TRACEMALLOC_TOP = Gauge(
    "karpenter_tpu_tracemalloc_top_bytes",
    help="Top allocation sites by live bytes (file:lineno), exported only "
         "when settings.profiling_enabled turns tracemalloc on.",
    registry=REGISTRY,
)

# -- continuous profiler + perf-regression sentinel (utils/profiling.py) -----
PERF_REGRESSION = Counter(
    "karpenter_tpu_perf_regression_total",
    help="Perf-sentinel trips, labeled by the regressing solve phase: the "
         "phase's live EWMA stayed outside its baseline MAD band for "
         "settings.perf_sentinel_mad_k consecutive rounds. Each trip also "
         "writes a DecisionRecord (kind=perf), opens an on-demand profile "
         "window and dumps a perf-regression flight-recorder capsule — "
         "start at /debug/perf, then /debug/profile.",
    registry=REGISTRY,
)
PROFILER_SAMPLES = Gauge(
    "karpenter_tpu_profiler_samples_total",
    help="Stack samples aggregated by the sampling profiler since process "
         "start (0 when the profiler never ran — the zero-overhead-when-"
         "disabled invariant is observable). Refreshed pre-scrape.",
    registry=REGISTRY,
)
PROCESS_START_TIME = Gauge(
    "karpenter_tpu_process_start_time_seconds",
    help="Unix timestamp the operator process started (set once at "
         "runtimehealth install). A changed value between scrapes means the "
         "scrape target restarted — the soak monitor segments its memory-"
         "slope regression on it so a restart's RSS reset never reads as a "
         "negative (or masked) leak.",
    registry=REGISTRY,
)
BACKPRESSURE_EVENTS = Counter(
    "karpenter_tpu_backpressure_events_total",
    help="Watch-intake backpressure actions by the informer client "
         "(state/httpcluster.py), labeled by action: 'widen' counts events "
         "coalesced away by the widened apply batch window under sustained "
         "lag; 'shed' counts events dropped when the bounded intake queue "
         "overflowed and the client fell back to shed-and-relist.",
    registry=REGISTRY,
)

# -- pod lifecycle attribution (utils/lifecycle.py, utils/slo.py) ------------
POD_LIFECYCLE_STAGE = Histogram(
    "karpenter_tpu_pod_lifecycle_stage_seconds",
    help="Per-stage duration of a completed pod's lifecycle waterfall "
         "(intake -> batch -> solve -> validate -> launch -> bind), labeled "
         "by stage; wait stages (batch_wait/solve_wait/encode_wait/"
         "launch_wait) are time spent queued BETWEEN stages, the rest time "
         "inside one. Stage durations sum to pod_ready_seconds by "
         "construction.",
    buckets=_LATENCY_BUCKETS,
    registry=REGISTRY,
)
POD_READY = Histogram(
    "karpenter_tpu_pod_ready_seconds",
    help="End-to-end pod-ready latency: watch intake first-seen to bind, "
         "observed once per completed lifecycle waterfall "
         "(utils/lifecycle.py) — the streaming-frontier product metric.",
    buckets=_LATENCY_BUCKETS,
    registry=REGISTRY,
)
BATCH_WAIT = Histogram(
    "karpenter_tpu_batch_wait_seconds",
    help="Time requests spend waiting in a batch window before execution, "
         "labeled by batcher: 'pod' is the provisioning batch window's "
         "arming delay (the largest known pod-ready contributor), 'rpc' the "
         "cloud-API request batcher's per-request queue time.",
    buckets=_LATENCY_BUCKETS,
    registry=REGISTRY,
)
SLO_BURN_RATE = Gauge(
    "karpenter_tpu_slo_burn_rate",
    help="Error-budget burn rate per SLO and window (fast=5m, slow=1h): "
         "bad-fraction / (1 - target); 1.0 spends the budget exactly at "
         "exhaustion rate, >1 is overspend, idle traffic reads 0.",
    registry=REGISTRY,
)
SLO_BUDGET_REMAINING = Gauge(
    "karpenter_tpu_slo_budget_remaining",
    help="Fraction of the SLO's error budget left over the slow window "
         "(1.0 untouched, 0 spent, negative overspent).",
    registry=REGISTRY,
)

# -- cost ledger -------------------------------------------------------------
COST_DOLLARS = Counter(
    "karpenter_tpu_cost_dollars_total",
    help="Realized spend metered by the cost ledger: node-seconds times the "
         "launch-time offering price, integrated continuously from cluster "
         "watch events, labeled by provisioner and capacity type (bounded "
         "labels; per-pod/per-gang attribution lives on /debug/costs).",
    registry=REGISTRY,
)
COST_SAVINGS = Counter(
    "karpenter_tpu_cost_savings_dollars_total",
    help="Counterfactual streams from the cost ledger, labeled by source: "
         "'spot' is on-demand sticker minus metered spend on spot capacity, "
         "'consolidation' is executed-action savings accrued over the "
         "ledger window, 'interruption_loss' is dollars LOST to reclaims "
         "(restart tax + re-launch price deltas; monotonic like the rest).",
    registry=REGISTRY,
)

# -- event stream ------------------------------------------------------------
EVENTS_TOTAL = Counter(
    "karpenter_tpu_events_total",
    help="Recorder events published, labeled by event type and reason.",
    registry=REGISTRY,
)
