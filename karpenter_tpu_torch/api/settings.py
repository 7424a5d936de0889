"""Global settings.

Reference: the ``karpenter-global-settings`` ConfigMap injected into ctx
(upstream ``pkg/apis/settings/settings.go:40-93``): cluster identity, batch
tuning (batchIdleDuration 1s / batchMaxDuration 10s), vmMemoryOverheadPercent
(0.075), feature gates (driftEnabled), interruption queue name.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Dict, Optional


@dataclass
class Settings:
    cluster_name: str = "karpenter-tpu"
    cluster_endpoint: str = ""
    batch_idle_duration: float = 1.0  # settings.md:41-47
    batch_max_duration: float = 10.0
    vm_memory_overhead_percent: float = 0.075
    interruption_queue_name: Optional[str] = None
    drift_enabled: bool = True
    node_name_convention: str = "resource-name"  # or ip-name
    tags: Dict[str, str] = field(default_factory=dict)
    # deprovisioning knobs (reference designs/consolidation.md:59-67)
    consolidation_validation_ttl: float = 15.0
    stabilization_window: float = 300.0
    # wall-clock budget for the multi-node consolidation sweep: each subset is
    # a full reschedule simulation, so the search degrades to fewer subsets
    # under load instead of running unbounded as the fleet grows. 0 disables
    # the multi-node sweep entirely (single-node consolidation still runs).
    consolidation_timeout: float = 2.0
    # cadence of the state-observability scrapers (controllers/metricsscraper)
    # on the operator loop; 0 scrapes every tick
    metrics_scrape_interval: float = 10.0
    # RPC resilience knobs (utils/resilience.py): attempts per call through
    # the retry layer (1 disables retries), consecutive failures before an
    # endpoint's circuit opens, and how long an insufficient-capacity
    # offering stays masked (reference: 3m ICE TTL, cache.go:20-36)
    rpc_retry_max_attempts: int = 4
    rpc_breaker_failure_threshold: int = 5
    insufficient_capacity_ttl: float = 180.0
    # incremental encoding (solver/session.py EncodeSession): delta-encode
    # steady-state reconciles from watch-event dirty sets, with a forced
    # full encode every N delta rounds as an out-of-band-mutation backstop.
    # encode_delta_enabled=false pins every encode to the full path.
    encode_delta_enabled: bool = True
    encode_full_resync_every: int = 64
    # consolidation sweep worker pool: per-candidate what-if simulations fan
    # out across this many threads (the LP/numpy host solves release the
    # GIL). 0 sizes from the host's CPU count; 1 forces the serial sweep.
    consolidation_sweep_workers: int = 0
    # scheduling-decision audit ring (utils/decisions.py, /debug/decisions):
    # most-recent records retained; 0 disables decision recording entirely
    decision_log_capacity: int = 2048
    # reconcile flight recorder (utils/flightrecorder.py,
    # /debug/flightrecorder): bounded ring of per-reconcile capsules — the
    # complete round input (cluster snapshot, instance-type/offering lists
    # with ICE state, settings) plus recorded outputs (problem digests,
    # actions, decisions) for offline replay via `python -m
    # karpenter_tpu.replay`. 0 disables recording entirely.
    flight_recorder_capacity: int = 32
    # directory capsules are dumped to (gzip JSON) on anomaly triggers —
    # reconcile error, unschedulable pods, full-encode fallback, breaker
    # open — and on-demand via /debug/flightrecorder/<id>?dump=1. Empty
    # disables automatic dumping (capsules stay fetchable over HTTP).
    flight_recorder_dump_dir: str = ""
    # continuous profiling (utils/profiling.py + utils/runtimehealth.py):
    # ONE switch for both diagnosis profilers — the sampling CPU profiler
    # (background sys._current_frames() walker aggregating collapsed stacks
    # on /debug/profile) and tracemalloc allocation-site tracking
    # (karpenter_tpu_tracemalloc_top_bytes). Measurable overhead, off by
    # default; on-demand /debug/profile?seconds= windows work either way,
    # and the process carries zero profiling threads while this is off.
    profiling_enabled: bool = False
    # sampling rate of the CPU profiler, Hz. Deliberately odd (prime) by
    # default so the sampler never phase-locks with periodic 10/20/100 Hz
    # work; the bench profiler_overhead guard budgets < 5% of round p50 at
    # this default rate.
    profiling_sample_hz: float = 19.0
    # rounds of fresh observations a (phase, mode) / AOT-bucket key needs
    # before its latency baseline (p50/p99 + MAD band) freezes; baselines
    # persist next to the AOT disk cache so restarts skip re-warming.
    profiling_baseline_rounds: int = 20
    # online perf-regression sentinel (utils/profiling.py): compares each
    # phase's live EWMA against its baseline MAD band every provisioning
    # round, and on a sustained exit emits
    # karpenter_tpu_perf_regression_total{phase}, writes a kind=perf
    # DecisionRecord, opens a profile window and dumps a perf-regression
    # flight-recorder capsule. Cheap (band math at round cadence), on by
    # default.
    perf_sentinel_enabled: bool = True
    # consecutive out-of-band rounds before the sentinel trips (and
    # consecutive in-band rounds before a tripped phase re-arms) — the K in
    # "K rounds of sustained regression", not the MAD multiplier.
    perf_sentinel_mad_k: int = 3
    # gang scheduling (solver/gang.py + the provisioning gang gate):
    # all-or-nothing pod groups with rank-aware single-zone repacking.
    # A no-op on batches without pod-group keys, so it defaults on.
    gang_scheduling_enabled: bool = True
    # priority preemption (controllers/preemption.py): unschedulable
    # higher-priority gangs/pods evict the cheapest lower-priority victims
    # (victim gangs whole) and bind onto the freed capacity in-round.
    preemption_enabled: bool = True
    # consecutive deferral rounds before a still-pending gang escalates to a
    # GangWaitExceeded warning event (it keeps deferring either way —
    # all-or-nothing is not negotiable); 0 disables the escalation.
    gang_max_wait_rounds: int = 8
    # TPU slice topology (solver/topology.py): when enabled AND the catalog
    # carries ICI-coordinate offerings, the gang gate scores placements by
    # torus hop distance (adjacency replan onto one ICI domain, compact
    # coordinate remap) and preempt-or-launch joins the cascade as one cost
    # decision. Off by default: sliceless clusters see byte-identical
    # behavior (and a topology-enabled operator on a sliceless catalog
    # degrades to the zone-granular gate).
    slice_topology_enabled: bool = False
    # hop-count penalty: a gang plan is charged price * (1 + frac *
    # mean_pairwise_hops). The default makes one cross-zone pair
    # (CROSS_ZONE_HOPS=16) cost the same 10% premium the zone-granular
    # scatter penalty charged per extra zone: 0.00625 * 16 = 0.10.
    slice_hop_penalty_frac: float = 0.00625
    # thrash budget for victim-gang restart boosting: a gang evicted whole
    # by the preemption planner re-enters Pending with one priority tier of
    # VICTIM-side protection — it cannot be re-evicted by an equal-priority
    # preemptor — for this many reconciles. (Deliberately not a preemptor
    # boost: empowering the evicted gang against equal-priority peers would
    # let two equal-tier gangs displace each other in a cycle.) 0 disables.
    gang_restart_boost_rounds: int = 4
    # risk-aware spot capacity pools (utils/riskcache.py + the rebalance
    # controller): when enabled, offerings carry live interruption
    # probabilities, the solver prices price + p * interruption_penalty_cost,
    # the diversification gate respreads groups concentrated in one spot
    # pool, and rebalance recommendations launch replacement capacity BEFORE
    # draining. Off by default: plain clusters see byte-identical behavior.
    spot_enabled: bool = False
    # $-hours equivalent cost of one interruption (drain + reschedule + the
    # work lost inside the 2-minute notice): the solver's risk penalty is
    # p_interrupt * this, added to each offering's price objective.
    interruption_penalty_cost: float = 10.0
    # max fraction of a pod group's (or gang's) members the solver may land
    # in any single SPOT capacity pool; 1.0 disables the diversification gate.
    spot_diversification_max_frac: float = 0.5
    # halflife of realized-interruption evidence in the risk cache: a pool
    # that stops churning decays back toward its prior at this rate.
    risk_decay_halflife_s: float = 600.0
    # cell-sharded control plane (state/cells.py + the provisioning sharded
    # solve path): partition cluster state into cells by (provisioner,
    # zone/topology domain), run per-cell delta encodes + solves
    # concurrently, and place the cross-cell residue in a global
    # arbitration pass. Off by default: flat-mode behavior (and its metric
    # series) stays byte-identical.
    cell_sharding_enabled: bool = False
    # worker threads the per-cell solves fan out across (each cell gets its
    # own solver clone + EncodeSession either way). 0 sizes from the host's
    # CPU count; 1 forces serial cell solves (identical answers, the
    # serial-equality discipline).
    cell_shard_workers: int = 0
    # degenerate-partition guardrail: a round where any single cell holds
    # more than this many pods falls back to the flat single-session solve
    # (one giant cell pays sharding overhead for no decomposition win).
    # 0 disables the guardrail.
    cell_max_pods: int = 0
    # fleet dispatch (solver stage_fleet + the sharded provisioning round):
    # group per-cell kernel dispatches by executable bucket and batch each
    # group into ONE vmapped device call — O(distinct buckets) device calls
    # per sharded round instead of O(cells). The batched member program is
    # bit-identical to the per-cell one, so answers never change; flat mode
    # and host-only backends are unaffected.
    fleet_dispatch_enabled: bool = True
    # cap on cells batched into one fleet dispatch; the effective chunk
    # width is the largest power of two <= this (the compiled batch axis is
    # pow2-bucketed like every other kernel axis).
    fleet_max_batch: int = 16
    # 2D meshed solver tier (parallel.mesh make_mesh2d): shard the kernel's
    # option columns across an ``options`` device axis and the superproblem
    # batch across a ``fleet`` axis, so one sharded round solves as ONE
    # multi-chip device program. Off (the default): today's behavior — a 1D
    # portfolio mesh when multiple devices are present, else single device,
    # byte-identical round digests.
    mesh_enabled: bool = False
    # mesh shape as "OPTIONSxFLEET" device counts (e.g. "4x2"), or "auto"
    # to derive one from the local device count (fleet axis 2 when >= 4
    # devices, else 1). Ignored unless mesh_enabled; a shape the host
    # cannot satisfy (fewer devices) degrades to the meshless path.
    mesh_shape: str = "auto"
    # cap on same-bucket cells entering ONE superproblem dispatch (the
    # sharded batch axis of the meshed kernel). Only consulted on a 2D
    # mesh; the effective width is the largest power of two <= this.
    superproblem_max_cells: int = 64
    # AOT kernel executable cache (solver/jax_solver.py AOTCache): kernel
    # solves dispatch pre-built per-bucket executables; this enables the
    # persistent on-disk XLA compilation cache so a restarted operator
    # starts warm. Off: in-process caching only (cold processes re-compile).
    aot_cache_enabled: bool = True
    # on-disk compilation cache directory; empty uses the per-user default
    # (~/.cache/karpenter_tpu/xla, overridable via
    # KARPENTER_TPU_COMPILE_CACHE_DIR).
    aot_cache_dir: str = ""
    # resident compiled executables kept in-process (LRU-evicted past this;
    # an executable is tens of MB, and a sweep storm must not grow the
    # registry without bound).
    aot_cache_capacity: int = 32
    # background pre-compile pool: warm the likely-next shape buckets
    # (observed shape distribution from the encode session + pattern ring)
    # off the reconcile thread, so a novel batch lands on a built executable.
    # Also gates the race path's cold-bucket background builds — false means
    # NO speculative executable compiles at all (the host path answers novel
    # shapes; the chaos soak runs this way so compile-arena growth cannot
    # mask a real leak).
    aot_precompile_enabled: bool = True
    # delta-aware device staging (solver/staging.py DeviceStager): problem
    # tensors stay resident on device across reconcile rounds, keyed by
    # padded-shape tag; a delta round scatter-updates only its churned rows
    # instead of re-copying the whole pytree, and donated dispatches clone
    # the resident master device-side. Disabled: every dispatch re-uploads
    # everything (the correctness-control path the staging property tests
    # compare against). Events: karpenter_tpu_device_staging_total{event}.
    device_staging_enabled: bool = True
    # resident staged tensor budget per solver (MiB); LRU-evicted past it.
    device_staging_capacity_mb: int = 256
    # donate problem-tensor device buffers on kernel dispatch: XLA reuses
    # the input allocation for outputs, cutting the device round-trip on
    # cold one-shot solves. Repeat dispatches re-stage inputs from host, so
    # leave off when the workload re-solves identical problems through the
    # device path (race memory usually absorbs those either way).
    aot_donate_inputs: bool = False
    # placement validation firewall (solver/validate.py validate_bind_plan):
    # every solver plan — whatever backend produced it — is re-checked
    # against cluster-level hard constraints (resource fit incl. daemonset
    # overhead, requirements/taints, gang atomicity, slice-adjacency pins,
    # spot-diversification caps) before any bind; an invalid plan is
    # rejected with per-violation DecisionRecords and the round re-solves
    # on the fallback backend. Off trusts the backends (the pre-fault-domain
    # behavior); the clean-path overhead is gated < 5% of round p50.
    solver_validation_enabled: bool = True
    # hard deadline on a synchronous kernel dispatch fetch: a hung device
    # answer raises after this long and the host fallback completes the
    # round instead of blocking it. 0 disables the deadline.
    kernel_dispatch_timeout_s: float = 2.0
    # consecutive device-path failures (invalid/non-finite plans, dispatch
    # timeouts, compile errors) before an executable bucket's kernel
    # breaker opens — the suspect executable is evicted (quarantine) and
    # solves degrade to host-lp/greedy until the half-open re-compile probe
    # proves the backend healthy again.
    kernel_breaker_failure_threshold: int = 3
    # scripted device-fault timeline (utils/faults.py DeviceFaultPlan.parse
    # wire format: "t=SECONDS,kind=KIND[,n=N][,hang=S];...") installed at
    # operator boot — the chaos soak's device-path fault storms. Empty (the
    # production state) installs nothing.
    device_fault_script: str = ""
    # leader election (utils/leaderelection.py): when enabled the operator
    # blocks on the lease before running reconcile loops and releases it on
    # clean shutdown, so a standby replica takes over within the lease TTL.
    # The CLI --leader-elect flag ORs with this setting; the lease path must
    # point at storage every replica shares (see deploy/render.py HA notes).
    leader_election_enabled: bool = False
    leader_election_lease_path: str = "/tmp/karpenter-tpu-leader"
    # watch-intake backpressure (state/httpcluster.py): bound on the
    # fetched-but-unapplied informer event queue. Under sustained lag the
    # applier widens its batch window and coalesces per-object; overflowing
    # the bound sheds the queue and relists (cost O(cluster), memory O(1))
    # instead of growing without bound. Surfaced as
    # karpenter_tpu_backpressure_events_total{action}.
    watch_queue_capacity: int = 8192
    # cadence of the machine garbage-collection / orphan-adoption loop
    # (reference: 5m). Soak/chaos runs shrink it so instances orphaned by an
    # operator crash are adopted or collected within the run.
    garbage_collect_interval: float = 300.0
    # pod-lifecycle latency attribution (utils/lifecycle.py,
    # /debug/lifecycle): per-pod stage waterfalls from watch intake to bind,
    # feeding karpenter_tpu_pod_lifecycle_stage_seconds{stage} and
    # karpenter_tpu_pod_ready_seconds. Off disables all marks (the bench
    # overhead guard's control arm).
    lifecycle_tracking_enabled: bool = True
    # completed waterfalls retained for /debug/lifecycle?pod= and the soak
    # monitor's dominant-stage attribution; 0 keeps none (histograms and the
    # SLO engine still observe every completion).
    lifecycle_retention: int = 4096
    # pod-ready SLO objective (utils/slo.py): a completed pod counts GOOD
    # when its intake-to-bind latency is <= this many seconds...
    slo_pod_ready_p99_s: float = 60.0
    # ...and the objective targets this fraction of pods good; the error
    # budget is (1 - target), burned as karpenter_tpu_slo_burn_rate{slo,
    # window} over fast (5m) and slow (1h) windows.
    slo_pod_ready_target_frac: float = 0.99
    # cost ledger (utils/costledger.py): when enabled the operator meters
    # realized spend (node-seconds x launch-time offering price) from
    # cluster watch events, attributes it per provisioner/cell/gang/pod
    # with a conservation invariant, and serves /debug/costs plus the
    # karpenter_tpu_cost_* metrics.
    cost_ledger_enabled: bool = True
    # the ledger's rolling-window width: the /debug/costs burn-rate window
    # default, and the accrual horizon for consolidation-savings and
    # re-launch-delta streams (a savings claim older than one window is
    # stale — the fleet has churned under it).
    cost_ledger_window_s: float = 3600.0
    # multi-cluster federation (federation/): when enabled the operator runs
    # a FederationClient against arbiter_endpoint — pushing capacity
    # summaries every summary_interval_s and routing multi-region-eligible
    # pods (karpenter.tpu/region-affinity) through placement leases. Every
    # arbiter dependency is ADVISORY: an unreachable arbiter degrades this
    # cluster to full local autonomy behind a circuit breaker.
    federation_enabled: bool = False
    # the global arbiter's base URL (e.g. "http://arbiter:8100"); required
    # when federation is enabled.
    arbiter_endpoint: str = ""
    # placement-lease TTL: a lease older than this (or minted under an older
    # federation epoch) is fenced — a healed partition cannot double-launch
    # against it.
    lease_ttl_s: float = 30.0
    # cadence of capacity-summary pushes to the arbiter; also bounds how
    # stale the arbiter's view of this cluster can be before its staleness
    # sweep declares the region lost.
    summary_interval_s: float = 10.0

    def validate(self) -> None:
        if not self.cluster_name:
            raise ValueError("cluster_name is required")
        if self.batch_idle_duration < 0 or self.batch_max_duration < self.batch_idle_duration:
            raise ValueError("invalid batch durations")
        if not 0 <= self.vm_memory_overhead_percent < 1:
            raise ValueError("vmMemoryOverheadPercent must be in [0,1)")
        if self.consolidation_timeout < 0:
            raise ValueError("consolidationTimeout must be >= 0 (0 disables the multi-node sweep)")
        if self.metrics_scrape_interval < 0:
            raise ValueError("metricsScrapeInterval must be >= 0 (0 scrapes every tick)")
        if self.rpc_retry_max_attempts < 1:
            raise ValueError("rpcRetryMaxAttempts must be >= 1 (1 disables retries)")
        if self.rpc_breaker_failure_threshold < 1:
            raise ValueError("rpcBreakerFailureThreshold must be >= 1")
        if self.insufficient_capacity_ttl < 0:
            raise ValueError("insufficientCapacityTTL must be >= 0")
        if self.encode_full_resync_every < 0:
            raise ValueError(
                "encodeFullResyncEvery must be >= 0 (0 disables the periodic full encode)"
            )
        if self.consolidation_sweep_workers < 0:
            raise ValueError(
                "consolidationSweepWorkers must be >= 0 (0 = auto-size from CPU count)"
            )
        if self.decision_log_capacity < 0:
            raise ValueError(
                "decisionLogCapacity must be >= 0 (0 disables decision recording)"
            )
        if self.flight_recorder_capacity < 0:
            raise ValueError(
                "flightRecorderCapacity must be >= 0 (0 disables the flight recorder)"
            )
        if self.gang_max_wait_rounds < 0:
            raise ValueError(
                "gangMaxWaitRounds must be >= 0 (0 disables the wait escalation)"
            )
        if self.profiling_sample_hz <= 0 or self.profiling_sample_hz > 1000:
            raise ValueError(
                "profilingSampleHz must be in (0, 1000] (a kHz sampler is a "
                "tracer, not a profiler)"
            )
        if self.profiling_baseline_rounds < 1:
            raise ValueError("profilingBaselineRounds must be >= 1")
        if self.perf_sentinel_mad_k < 1:
            raise ValueError(
                "perfSentinelMadK must be >= 1 (consecutive out-of-band "
                "rounds before a trip)"
            )
        if self.interruption_penalty_cost < 0:
            raise ValueError("interruptionPenaltyCost must be >= 0")
        if self.slice_hop_penalty_frac < 0:
            raise ValueError(
                "sliceHopPenaltyFrac must be >= 0 (0 scores adjacency free)"
            )
        if self.gang_restart_boost_rounds < 0:
            raise ValueError(
                "gangRestartBoostRounds must be >= 0 (0 disables the boost)"
            )
        if not 0 < self.spot_diversification_max_frac <= 1:
            raise ValueError(
                "spotDiversificationMaxFrac must be in (0, 1] (1.0 disables the gate)"
            )
        if self.risk_decay_halflife_s <= 0:
            raise ValueError("riskDecayHalflifeS must be > 0")
        if self.cell_shard_workers < 0:
            raise ValueError(
                "cellShardWorkers must be >= 0 (0 = auto-size from CPU count)"
            )
        if self.cell_max_pods < 0:
            raise ValueError(
                "cellMaxPods must be >= 0 (0 disables the guardrail)"
            )
        if self.fleet_max_batch < 2:
            raise ValueError(
                "fleetMaxBatch must be >= 2 (a 1-wide fleet is a per-cell "
                "dispatch; use fleet_dispatch_enabled=false to disable)"
            )
        if self.superproblem_max_cells < 2:
            raise ValueError(
                "superproblemMaxCells must be >= 2 (a 1-cell superproblem "
                "is a fleet dispatch; use mesh_enabled=false to disable)"
            )
        if self.mesh_shape != "auto":
            parts = self.mesh_shape.lower().split("x")
            if len(parts) != 2 or not all(
                p.isdigit() and int(p) >= 1 for p in parts
            ):
                raise ValueError(
                    'meshShape must be "auto" or "OxF" device counts '
                    '(e.g. "4x2")'
                )
        if self.aot_cache_capacity < 1:
            raise ValueError("aotCacheCapacity must be >= 1")
        if self.device_staging_capacity_mb < 1:
            raise ValueError("deviceStagingCapacityMb must be >= 1")
        if self.kernel_dispatch_timeout_s < 0:
            raise ValueError(
                "kernelDispatchTimeoutS must be >= 0 (0 disables the deadline)"
            )
        if self.kernel_breaker_failure_threshold < 1:
            raise ValueError("kernelBreakerFailureThreshold must be >= 1")
        if self.device_fault_script:
            from ..utils.faults import DeviceFaultPlan

            DeviceFaultPlan.parse(self.device_fault_script)  # loud on malformed
        if self.leader_election_enabled and not self.leader_election_lease_path:
            raise ValueError(
                "leaderElectionLeasePath is required when leader election is enabled"
            )
        if self.watch_queue_capacity < 1:
            raise ValueError("watchQueueCapacity must be >= 1")
        if self.garbage_collect_interval <= 0:
            raise ValueError("garbageCollectInterval must be > 0")
        if self.lifecycle_retention < 0:
            raise ValueError(
                "lifecycleRetention must be >= 0 (0 keeps no completed waterfalls)"
            )
        if self.slo_pod_ready_p99_s <= 0:
            raise ValueError("sloPodReadyP99S must be > 0")
        if not 0 < self.slo_pod_ready_target_frac < 1:
            raise ValueError("sloPodReadyTargetFrac must be in (0, 1)")
        if self.cost_ledger_window_s <= 0:
            raise ValueError("costLedgerWindowS must be > 0")
        if self.federation_enabled and not self.arbiter_endpoint:
            raise ValueError(
                "arbiterEndpoint is required when federation is enabled"
            )
        if self.lease_ttl_s <= 0:
            raise ValueError("leaseTtlS must be > 0")
        if self.summary_interval_s <= 0:
            raise ValueError("summaryIntervalS must be > 0")

    # -- config system (reference: karpenter-global-settings ConfigMap,
    # settings.go:40-93; env/flag ingestion in the operator bootstrap) -------

    _ENV_PREFIX = "KARPENTER_TPU_"

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None) -> "Settings":
        """Build settings from KARPENTER_TPU_* environment variables
        (CLUSTER_NAME, BATCH_IDLE_DURATION, INTERRUPTION_QUEUE_NAME, ...),
        falling back to defaults — the 12-factor face of the reference's
        global-settings ConfigMap. Unknown KARPENTER_TPU_* keys are an error:
        a misspelled override silently falling back to a default is the worst
        possible config failure mode."""
        import os

        env = dict(os.environ if env is None else env)
        s = cls()
        known = {cls._ENV_PREFIX + f.name.upper(): f.name for f in fields(cls)}
        unknown = [
            k for k in env
            if k.startswith(cls._ENV_PREFIX) and k not in known
        ]
        if unknown:
            raise ValueError(
                f"unknown settings env vars: {sorted(unknown)}; known: {sorted(known)}"
            )
        updates: Dict[str, object] = {
            name: _coerce(key, env[key], getattr(s, name))
            for key, name in known.items()
            if key in env
        }
        s.apply(updates)
        return s

    def apply(self, updates: Dict[str, object]) -> "Settings":
        """Live-config update (the ConfigMap watcher analogue): set the given
        fields, validate the result atomically (all-or-nothing)."""
        candidate = Settings(**{**self.__dict__, **updates})
        candidate.validate()
        for k, v in updates.items():
            setattr(self, k, v)
        return self


_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


def _coerce(key: str, raw: str, current) -> object:
    raw = raw.strip()
    if isinstance(current, bool):
        if raw.lower() in _TRUE:
            return True
        if raw.lower() in _FALSE:
            return False
        raise ValueError(f"{key}: invalid boolean {raw!r} (use true/false)")
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, int) and current is not None:
        return int(raw)
    if isinstance(current, dict):
        import json

        return json.loads(raw)
    if raw == "" and current is None:
        return None
    return raw
