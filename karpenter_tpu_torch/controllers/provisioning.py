"""Provisioning controller: pending pods -> batch -> solve -> launch -> bind.

A copy of ``karpenter_tpu/controllers/provisioning.py``'s flat and sharded
rounds, solving through the PyTorch solver (``TorchSolver`` by default, on
the card). Left out until their slices are ported (``ROADMAP.md``, Queue 1):
the flight-recorder capsule (item 7), the federation gate and
``profiling.note_phase`` (item 9), and the multi-device tier (item 10). The
constructor refuses settings that turn on what is left out.

The rebuild of core's provisioning controller + ``Scheduler.Solve()`` call path
(reference call stack in SURVEY §3.2): a batcher windows pending pods (idle 1s /
max 10s, upstream ``website/.../settings.md:41-47``), the solver packs the
batch onto existing in-flight capacity plus the cheapest feasible new offerings, and
each new node spec becomes a Machine that the cloud provider launches
(``CloudProvider.Create``, upstream ``pkg/cloudprovider/cloudprovider.go:79``).

Provisioner resource limits gate scale-up (``designs/limits.md``); insufficient
capacity errors fall back offering-by-offering inside the provider and, if
exhausted, leave pods pending for the next cycle with the ICE cache masking the
failed offerings.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..api import labels as wk
from ..api.objects import Machine, Node, ObjectMeta, Pod, Provisioner
from ..api.requirements import Requirement, Requirements
from ..api.resources import Resources, merge
from ..api.settings import Settings
from ..api.taints import tolerates_all
from ..cloudprovider.interface import CloudProvider, CloudProviderError, InsufficientCapacityError
from ..cloudprovider.types import InstanceType
from ..solver import diversify
from ..solver import gang as gangmod
from ..solver import topology
from ..solver.validate import (
    PlanViolation,
    scripted_next as fw_scripted_next,
    validate_bind_plan,
)
from ..solver.encode import ExistingNode
from ..solver.gang import Gang
from ..solver.result import NewNodeSpec, SolveResult
from ..solver.session import EncodeSession
from ..solver.solver import GreedySolver, Solver, TorchSolver
from ..state.cluster import Cluster
from ..utils import metrics
from ..utils.decisions import DECISIONS
from ..utils.lifecycle import LIFECYCLE, track_cluster_for_pruning
from ..utils.events import Recorder
from ..utils.resilience import RetryPolicy, retry_policy_from_settings
from .preemption import MAX_PREEMPTORS_PER_ROUND, PreemptionPlanner, Preemptor

class MachineNameSeq:
    """Monotonic machine-name counter. Not a bare ``itertools.count``: the
    flight recorder snapshots the upcoming value per capsule (``peek``) and
    the replay harness launches from a PRIVATE sequence pinned to it — a
    node launched mid-round enters later solve rounds' problem digests by
    NAME, so replayed names must reproduce the recorded ones exactly."""

    def __init__(self, start: int = 1):
        import threading

        self._n = start
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            n = self._n
            self._n += 1
            return n

    def peek(self) -> int:
        return self._n

    def advance_past(self, n: int) -> None:
        """Never emit a value <= n again. Crash-restart re-adoption: a fresh
        operator process starts this sequence at 1, but the cluster it
        relists may already hold ``<prov>-<N>`` machines/nodes from the
        previous incarnation — re-minting those names silently REPLACES the
        live objects (a new machine steals an old node's identity, the old
        instance leaks as an orphan). The controller seeds the sequence past
        every adopted name before its first launch."""
        with self._lock:
            self._n = max(self._n, n + 1)


_machine_ids = MachineNameSeq()


def seed_machine_names(cluster, seq: Optional[MachineNameSeq] = None) -> int:
    """Advance the machine-name sequence past every ``...-<N>`` machine or
    node name the (re)listed cluster already holds. Called at controller
    construction — after an operator crash the relisted store IS the previous
    incarnation's state, and name collisions there corrupt identity (see
    MachineNameSeq.advance_past). Returns the floor applied."""
    best = 0
    with cluster._lock:
        names = list(cluster.machines) + list(cluster.nodes)
    for name in names:
        tail = name.rsplit("-", 1)[-1]
        if tail.isdigit():
            best = max(best, int(tail))
    if best:
        (seq or _machine_ids).advance_past(best)
    return best


class PodBatcher:
    """Windows pending-pod arrivals: fire after `idle` seconds of quiet or `max`
    seconds total (reference batchIdleDuration/batchMaxDuration)."""

    def __init__(self, idle: float = 1.0, max_duration: float = 10.0):
        self.idle = idle
        self.max_duration = max_duration
        self._first: Optional[float] = None
        self._last: Optional[float] = None
        # monotonically increasing arrival counter: reconcile snapshots it
        # before reading pending pods, and reset(gen) is a no-op if pods
        # arrived after the snapshot — those were NOT in the solved batch and
        # must keep their window armed.
        self.generation = 0

    def note_arrival(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        if self._first is None:
            self._first = now
        self._last = now
        self.generation += 1

    def ready(self, now: Optional[float] = None) -> bool:
        if self._first is None:
            return False
        now = time.monotonic() if now is None else now
        return (now - self._last) >= self.idle or (now - self._first) >= self.max_duration

    def reset(self, upto_generation: Optional[int] = None) -> None:
        if upto_generation is not None and self.generation != upto_generation:
            return  # arrivals landed mid-reconcile; keep the window armed
        self._first = None
        self._last = None


@dataclass
class ProvisioningResult:
    machines: List[Machine]
    nodes: List[Node]
    bound: Dict[str, str]  # pod name -> node name
    unschedulable: List[str]
    solve: Optional[SolveResult] = None
    # gang members the gate deferred this round (all-or-nothing: below quorum
    # or no atomic placement) — deliberately NOT in ``unschedulable``, which
    # carries per-pod infeasibility; gangs wait by design
    gang_deferred: List[str] = field(default_factory=list)
    # placement-validation firewall events, one per evaluation this round
    # (verdict accepted/rejected/rejected-final, backend, violations) —
    # captured into flight-recorder capsules and compared by replay, so a
    # backend-degraded round reproduces including the fallback decision
    validation_events: List[Dict] = field(default_factory=list)


@dataclass
class GangGateOutcome:
    """One cascade round's gang-gate verdicts (see _gang_gate)."""

    solve: SolveResult  # the gated (possibly stripped/swapped) result shell
    deferred: List[str]  # member names stripped this round
    admitted: List[str]  # member names whose gang fully placed
    admitted_gangs: List[str]
    capacity_deferred: List[str]  # gang names deferred for capacity (quorum met)
    # per admitted gang: the zone set / scatter / price-delta details the
    # final ``gang-admitted`` verdict carries — emitted only once the round
    # ends with every member actually BOUND (launch failures can still split
    # a gate-admitted gang; _finalize_gangs rolls those back instead)
    admitted_details: Dict[str, Dict] = field(default_factory=dict)


class ProvisioningController:
    def __init__(
        self,
        cluster: Cluster,
        provider: CloudProvider,
        solver: Optional[Solver] = None,
        settings: Optional[Settings] = None,
        recorder: Optional[Recorder] = None,
    ):
        self.cluster = cluster
        self.provider = provider
        # federation, the multi-device tier and the solver's device-fault
        # seams are not ported yet: a setting that turns one on must not be
        # ignored
        for flag, item in (
            ("federation_enabled", "federation, Queue 1 item 9"),
            ("mesh_enabled", "the multi-device tier, Queue 1 item 10"),
        ):
            if getattr(settings, flag, False):
                raise NotImplementedError(
                    f"{flag}: not ported to the PyTorch controller yet "
                    f"(ROADMAP.md, {item})"
                )
        if settings is not None and settings.device_fault_script:
            raise NotImplementedError(
                "device_fault_script: the PyTorch solver applies no device "
                "faults yet (ROADMAP.md, Queue 1 item 4)"
            )
        self.solver = solver or TorchSolver()
        self.settings = settings or Settings()
        self.recorder = recorder or Recorder()
        self.batcher = PodBatcher(
            idle=self.settings.batch_idle_duration, max_duration=self.settings.batch_max_duration
        )
        # transient launch failures (throttle/5xx through the provider seam)
        # retry in-round with jittered backoff instead of failing the whole
        # reconcile and stalling on the kit's loop-level backoff
        self.retry_policy = retry_policy_from_settings(self.settings)
        # risk-priced objective (spot capacity pools): the solver adds
        # p_interrupt * penalty to every offering's price when enabled
        if self.settings.spot_enabled:
            self.solver.risk_penalty = self.settings.interruption_penalty_cost
        # machine-name sequence; the replay harness pins a private one to
        # the recorded capsule's snapshot so launched-node names reproduce.
        # Seed the process-global sequence past names the cluster already
        # holds: a crash-restarted operator relists its predecessor's
        # machines, and re-minting their names steals live identities.
        seed_machine_names(cluster)
        self.machine_ids: Optional[MachineNameSeq] = None
        self._pending_seen: set = set()
        # delta-aware encoder state: watch events below feed its dirty sets,
        # so steady-state reconciles patch the previous round's encoding
        # instead of re-walking the cluster (ARCHITECTURE.md "EncodeSession")
        self.encode_session = EncodeSession(
            full_resync_every=self.settings.encode_full_resync_every,
            enabled=self.settings.encode_delta_enabled,
        )
        # cell-sharded control plane (state/cells.py): when enabled, the
        # router — not the flat session — is the watch-event intake; each
        # cell owns an EncodeSession and a solver clone, solves fan out
        # over parallel/hostpool workers, and the cross-cell residue is
        # placed by a global arbitration pass over per-cell summaries
        self.cells = None
        self._cell_solvers: Dict[tuple, Solver] = {}
        # clean-cell solve reuse: cell key -> (input signature, strong ref
        # to the catalog list anchoring its id(), cached SolveResult). A
        # cell with no routed events since its last solve AND an identical
        # input signature provably encodes to the identical problem (the
        # delta==full digest contract), so its cached solve is the answer —
        # this is what keeps a sharded churn round O(churned cells)
        self._cell_solve_cache: Dict[tuple, tuple] = {}
        if self.settings.cell_sharding_enabled:
            from ..state.cells import CellRouter

            self.cells = CellRouter(
                full_resync_every=self.settings.encode_full_resync_every,
                delta_enabled=self.settings.encode_delta_enabled,
            )
        # gang gate state: consecutive deferral RECONCILES per gang (the
        # gang_max_wait_rounds escalation), reset on admission; _ticked is
        # the per-reconcile guard so cascade re-solves within one reconcile
        # count as a single wait
        self._gang_wait: Dict[str, int] = {}
        self._gang_wait_ticked: set = set()
        # placement-validation firewall state: the per-reconcile event list
        # (shared by reference with the round's ProvisioningResult), the
        # fallback backend a rejected plan re-solves on, and the identity of
        # the last plan the backend-level check accepted (the pre-bind check
        # skips re-validating an object it already cleared — the clean path
        # pays ONE validation per round, the <5%-overhead budget)
        self._fw_events: List[Dict] = []
        self._fw_fallback: Optional[GreedySolver] = None
        self._fw_clean: Optional[SolveResult] = None
        self._fw_eval_s: float = 0.0
        self.preemption = PreemptionPlanner(cluster, self.solver, self.recorder)
        # victim-gang restart boost (thrash budget): gang name -> reconciles
        # of +1-tier protection left. Set when a plan evicts a gang whole,
        # ticked down once per reconcile, expired entries dropped — bounded
        # by construction (every entry starts at gang_restart_boost_rounds).
        self._gang_restart_boost: Dict[str, int] = {}
        # multi-cluster federation is not ported: both stay None, and this
        # controller IS the single-cluster system
        self.federation = None
        self.federation_transfer: Optional[Callable[[List[Pod], str], bool]] = None
        cluster.watch(self._on_event)
        # lifecycle pruning: in-flight waterfalls for pods this cluster no
        # longer holds as pending are swept pre-scrape (deleted mid-flight)
        track_cluster_for_pruning(cluster)

    @property
    def _intake(self):
        """The active dirty-set intake: the cell router when sharding is
        on, else the flat EncodeSession (both expose pod_event /
        mark_structural)."""
        return self.cells if self.cells is not None else self.encode_session

    def _on_event(self, event: str, obj) -> None:
        # ADDED covers fresh pods; MODIFIED covers pods that became pending
        # again (drain evictions unbind them) so the batch window — not a
        # pending-pods poll — is the single trigger for provisioning
        # (reference: pod controller -> provisioner.Trigger, SURVEY §3.2).
        # Only the TRANSITION into pending arms the window: status-only
        # MODIFIED heartbeats on an already-pending pod must not bump the
        # batch generation (that would void reset() and busy-loop reconciles).
        if event == "RESYNCED":
            # cache relist (HTTPCluster watch-gone recovery): individual
            # events may have been skipped — incremental state is suspect.
            # The arrival-dedup set resets too: a DELETE the relist absorbed
            # (shed-and-relist backpressure, apiserver restart) would leave a
            # stale name that silently swallows note_arrival for a LATER pod
            # re-created under the same name — its batch window then never
            # arms and the pod waits on the slow retry poll.
            self._pending_seen.clear()
            # machines another incarnation launched during the outage are in
            # the relisted cache now; the name floor must move past them
            seed_machine_names(self.cluster, self.machine_ids)
            self._intake.mark_structural("relist")
            return
        if event in ("ADDED", "MODIFIED") and isinstance(obj, (Machine, Node)):
            # name-floor maintenance for HA standbys: while this replica
            # waits for leadership its informer streams the LEADER'S
            # launches — on takeover the sequence must already be past them
            # or the first launch steals a live machine's name (the boot-time
            # seed only covered construction-time state)
            tail = obj.meta.name.rsplit("-", 1)[-1]
            if tail.isdigit():
                (self.machine_ids or _machine_ids).advance_past(int(tail))
            return
        if not isinstance(obj, Pod) or obj.is_daemonset:
            return
        if event == "DELETED":
            self._pending_seen.discard(obj.name)
            self._intake.pod_event("DELETED", obj)
            return
        if event in ("ADDED", "MODIFIED"):
            # mirror pending_pods()' membership predicate exactly: the
            # session's dirty set must track the same population the
            # reconcile batch reads, or every round falls back to full
            in_batch = obj.is_pending() and obj.meta.deletion_timestamp is None
            self._intake.pod_event("ADDED" if in_batch else "DELETED", obj)
            if in_batch:
                if obj.name not in self._pending_seen:
                    self._pending_seen.add(obj.name)
                    self.batcher.note_arrival()
                # first-seen-wins: the HTTP applier may have stamped it
                # already; in-process mode this IS the intake boundary
                LIFECYCLE.intake(obj.name)
            else:
                self._pending_seen.discard(obj.name)

    def note_interrupted(self, pods: Sequence[Pod]) -> None:
        """Interruption fast path (controllers/interruption.py): pods a
        reclaimed node just drained are dirtied into the delta encoder and
        arm the batch window SYNCHRONOUSLY, instead of waiting for the
        eviction's watch event to trickle through an async informer — the
        next provisioning round re-solves them immediately, so
        rounds-to-replacement is 1, not 1-plus-watch-latency."""
        for pod in pods:
            if pod.is_pending() and pod.meta.deletion_timestamp is None:
                self._intake.pod_event("ADDED", pod)
                if pod.name not in self._pending_seen:
                    self._pending_seen.add(pod.name)
                    self.batcher.note_arrival()
                LIFECYCLE.intake(pod.name)

    # -- the reconcile loop body -------------------------------------------
    def reconcile(self) -> ProvisioningResult:
        from ..utils.tracing import span

        with span("provisioning.reconcile"):
            # The WHOLE round runs under cluster.quiesce(): against an
            # HTTP-backed cluster, remote watch events landing mid-round
            # queue in the bounded intake instead of racing the encoder's
            # reads. No flight-recorder capsule is captured (not ported).
            with self.cluster.quiesce():
                return self._reconcile(None)

    def _reconcile(self, cap=None) -> ProvisioningResult:
        t0 = time.perf_counter()
        batch_gen = self.batcher.generation
        batch_armed = self.batcher._first
        pods = self.cluster.pending_pods()
        if pods:
            if batch_armed is not None:
                # the pod batch window's arming delay — the single largest
                # known pod-ready contributor, finally visible on /metrics
                metrics.BATCH_WAIT.observe(
                    max(0.0, time.monotonic() - batch_armed), {"batcher": "pod"}
                )
            names = [p.name for p in pods]
            for n in names:
                # backstop for pods seeded before the watch delivered them
                # (idempotent: first-seen-wins)
                LIFECYCLE.intake(n)
            LIFECYCLE.mark_many(names, "batch_flushed")
        self._fw_events = []
        self._fw_clean = None
        self._fw_eval_s = 0.0
        result = ProvisioningResult(
            machines=[], nodes=[], bound={}, unschedulable=[],
            # shared by reference: firewall evaluations below append here
            validation_events=self._fw_events,
        )
        if not pods:
            self.batcher.reset(upto_generation=batch_gen)
            return result

        provisioners = sorted(
            self.cluster.provisioners.values(), key=lambda p: -p.weight
        )
        if not provisioners:
            result.unschedulable = [p.name for p in pods]
            # the most basic "why is nothing scheduling" answer must reach
            # the audit log too — this early return skips the end-of-pass
            # verdict loop
            for i, name in enumerate(result.unschedulable):
                DECISIONS.record(
                    "placement", "unschedulable", pod=name,
                    reason="no provisioners configured",
                    value=float(len(result.unschedulable)) if i == 0 else 0.0,
                )
            metrics.PODS_UNSCHEDULABLE.set(len(result.unschedulable))
            self.batcher.reset(upto_generation=batch_gen)
            return result

        daemonsets = self.cluster.daemonsets()
        # gangs in this batch (empty dict when the feature is off or no pod
        # carries a pod-group key — the gate is then a no-op)
        gangs: Dict[str, Gang] = (
            gangmod.collect_gangs(pods)
            if self.settings.gang_scheduling_enabled
            else {}
        )
        self._gang_wait_ticked.clear()  # new reconcile: each gang may tick once
        # restart-boost bookkeeping: the protected set is built BEFORE the
        # tick-down, so a boost of N protects exactly N subsequent
        # reconciles (building it after dropped the last protected round —
        # rounds=1 would have protected nothing)
        self.preemption.restart_boosted = set(self._gang_restart_boost)
        if self._gang_restart_boost:
            self._gang_restart_boost = {
                k: v - 1 for k, v in self._gang_restart_boost.items() if v > 1
            }
        if len(self._gang_wait) > 512:
            # bound the wait map: gangs that vanished without ever admitting
            # (cancelled jobs, deleted members) would otherwise accrete one
            # entry each, forever, in a long-lived operator
            live = {g for p in self.cluster.pods.values() if (g := p.pod_group())}
            self._gang_wait = {
                k: v for k, v in self._gang_wait.items() if k in live
            }

        # Pool cascade (reference: provisioners are tried highest-weight-first
        # and a pool that cannot host — limits reached, zone coverage too
        # narrow — is skipped for the next one): each round solves the still-
        # pending pods against the non-exhausted pools; a round that exhausts
        # a pool's limits re-solves without it. A round whose launches ICE
        # re-solves too (bounded by _ICE_RETRIES): the failed offerings are in
        # the unavailable cache by then, so the next solve degrades to the
        # next-cheapest feasible offering instead of failing the round.
        batch = list(pods)
        exhausted: set = set()
        ice_retries = 0
        # gangs the gate deferred for CAPACITY (quorum met, no atomic
        # placement) — the preemption planner's work list after the cascade
        capacity_gangs: Dict[str, Gang] = {}
        # per-gang admission details from the LAST gate round that fully
        # placed it — the final gang-admitted verdict's payload
        gang_admit_details: Dict[str, Dict] = {}
        # why each pod ended the pass unschedulable (the audit-log reason):
        # limits exhaustion and catalog infeasibility are DIFFERENT root
        # causes and must not be conflated in /debug/decisions
        unsched_reason: Dict[str, str] = {}
        # spot-pool diversification (solver/diversify.py): units computed
        # once per reconcile from the full batch; pools the gate masked for
        # respreading accumulate here and apply to later rounds' catalogs
        div_units = (
            diversify.collect_units(
                pods, gangs, self.settings.spot_diversification_max_frac
            )
            if self.settings.spot_enabled
            else []
        )
        div_masked: set = set()
        div_retries = 0
        div_fallback = False  # placement-over-diversification escape taken
        # gangs admitted by evicting victims (in-cascade preempt-or-launch
        # or the post-cascade last resort): their gang-admitted verdict is
        # emitted at the decision point, so _finalize_gangs skips them
        preempted_gangs: set = set()
        for round_no in range(
            max(len(provisioners), 1) + 1 + self._ICE_RETRIES
            + self._DIVERSIFY_RETRIES + 1
        ):
            # instance-type lists refresh each round: an ICE mark from the
            # previous round's launches must mask the offering NOW, not next
            # reconcile (get_instance_types is seqnum-cached — cheap when
            # nothing changed)
            round_provs = [
                (p, self.provider.get_instance_types(p))
                for p in provisioners if p.name not in exhausted
            ]
            if div_masked:
                # respread rounds solve against the catalog minus the
                # overweight pools (round 0 is always unmasked, so the
                # capsule's recorded catalog is the clean one — replay
                # re-derives the same masks from the same gate decisions)
                round_provs = [
                    (p, diversify.mask_pools(types, div_masked))
                    for p, types in round_provs
                ]
            if cap is not None and round_no == 0:
                # complete round input, captured BEFORE anything mutates:
                # the instance-type lists carry the ICE mask as offering
                # availability, so replay solves against the same catalog
                cap.capture_inputs(
                    cluster=self.cluster, provisioner_types=round_provs,
                    settings=self.settings, provider=self.provider,
                    solver=self.solver,
                )
            if not round_provs or not batch:
                for p in batch:
                    result.unschedulable.append(p.name)
                    unsched_reason[p.name] = (
                        "every eligible provisioner is at its resource limits"
                    )
                    self.recorder.publish(
                        "FailedScheduling",
                        "every eligible provisioner is at its resource limits",
                        object_name=p.name, object_kind="Pod", type="Warning",
                    )
                break
            round_existing = self.cluster.existing_capacity()
            if div_masked:
                # a respread round must not rebind stripped pods onto the
                # overweight pool's free EXISTING capacity either
                round_existing = diversify.filter_existing(round_existing, div_masked)
            solve = self._solve_round(
                batch, provisioners, round_provs, round_existing,
                daemonsets, cap,
            )
            if result.solve is None:
                result.solve = solve
                if cap is not None:
                    # the canonical pod order the session(s) actually
                    # encoded — a replay's from-scratch encode of exactly
                    # this order is digest-identical to this round's
                    # (delta) encode; in sharded mode this is the per-cell
                    # concatenation in cell order, and the same partition
                    # re-derives from the same inputs on replay
                    intake = self._intake
                    cap.set_batch_order(
                        [p.meta.name for p in intake.ordered_pods()]
                    )
                    cap.note_encode_mode(
                        intake.last_mode, intake.last_full_reason
                    )
            metrics.SOLVE_DURATION.observe(solve.stats.get("total_s", 0.0))
            if gangs:
                # all-or-nothing gate BEFORE anything binds: partial gang
                # placements are stripped (and scattered full placements
                # rank-aware repacked) on a fresh result shell — the solver
                # may have served this SolveResult from a cache, so its lists
                # are never mutated in place
                gate = self._gang_gate(solve, gangs, round_provs, daemonsets, cap)
                solve = gate.solve
                admitted = set(gate.admitted)
                result.gang_deferred = [
                    n for n in result.gang_deferred if n not in admitted
                ]
                for name in gate.deferred:
                    if name not in result.gang_deferred:
                        result.gang_deferred.append(name)
                for gname in gate.admitted_gangs:
                    capacity_gangs.pop(gname, None)
                for gname in gate.capacity_deferred:
                    capacity_gangs[gname] = gangs[gname]
                    gang_admit_details.pop(gname, None)
                gang_admit_details.update(gate.admitted_details)
                # preempt-or-launch: an admitted gang about to open FRESH
                # capacity may instead evict cheaper victims and bind onto
                # the freed nodes — one cost decision inside the cascade,
                # not a last resort after it
                solve, pol = self._preempt_or_launch(
                    solve, gangs, gate.admitted_gangs, result, cap
                )
                preempted_gangs |= pol
            div_stripped = False
            if div_units:
                # spot-pool concentration gate, after the gang gate (it must
                # judge the placements that will actually bind): members over
                # the per-pool cap are stripped and re-solve next round with
                # the overweight pool masked
                enforce = div_retries < self._DIVERSIFY_RETRIES and not div_fallback
                div = diversify.gate(solve, div_units, self.cluster, enforce=enforce)
                for v in div.verdicts:
                    outcome_name = "accepted" if v["accepted"] else "respread"
                    metrics.SPOT_DIVERSIFICATION.inc({"outcome": outcome_name})
                    DECISIONS.record_coalesced(
                        "diversification", outcome_name, pod=v["unit"],
                        reason=(
                            f"spot pool {v['pool']} holds {v['members']} members "
                            f"(cap {v['cap']})"
                        ),
                        details=dict(v),
                    )
                if div.strip:
                    solve = div.solve
                    div_masked |= div.mask
                    div_stripped = True
            # placement validation firewall, pre-bind layer: the GATED plan
            # (gang gate, preempt-or-launch, diversification strips applied)
            # is the one about to bind — re-verify the post-gate invariants
            # (gang atomicity, slice-adjacency pins, diversification caps)
            # plus, for any object the backend layer did not already clear,
            # the full fit checks. A violation here binds NOTHING: zero
            # invalid bindings is the contract, a wasted round the cost.
            solve = self._prebind_firewall(
                solve, batch, round_provs, round_existing, daemonsets,
                gangs, div_units,
                check_div=(
                    div_retries < self._DIVERSIFY_RETRIES and not div_fallback
                ),
            )
            LIFECYCLE.mark_many([p.name for p in batch], "validated")
            limit_hit, ice_failed = self._apply_solve(solve, result, round_provs)
            retry_ice = bool(ice_failed) and ice_retries < self._ICE_RETRIES
            if retry_ice:
                ice_retries += 1
            if div_stripped:
                div_retries += 1
            if limit_hit or retry_ice or div_stripped:
                exhausted |= limit_hit
                # EVERYTHING still pending gets another round against the
                # remaining pools — both the limit-blocked specs' pods and the
                # pods this solve called unschedulable (their infeasibility may
                # have come from the weight gate pinning them to the exhausted
                # pool)
                pending_again = [
                    q for q in batch
                    if (qq := self.cluster.pods.get(q.name)) is not None
                    and qq.is_pending()
                ]
                if pending_again:
                    names = {q.name for q in pending_again}
                    result.unschedulable = [
                        n for n in result.unschedulable if n not in names
                    ]
                    batch = pending_again
                    continue
            if (
                solve.unschedulable and div_masked and not div_fallback
                and self._mask_stranded(
                    solve.unschedulable, div_masked, round_provs
                )
            ):
                # placement outranks spread: a pod the diversification-masked
                # catalog cannot host gets one re-solve against the full
                # catalog with the gate disabled — zero unschedulable pods is
                # the contract, concentration the lesser evil. Only pods the
                # masking could actually have stranded count: a pod no masked
                # pool can host is unschedulable for catalog reasons, and
                # unmasking + re-solving cannot save it (it would otherwise
                # buy a wasted extra solve round and disarm the gate every
                # reconcile it stays pending)
                div_fallback = True
                div_masked.clear()
                pending_again = [
                    q for q in batch
                    if (qq := self.cluster.pods.get(q.name)) is not None
                    and qq.is_pending()
                ]
                if pending_again:
                    names = {q.name for q in pending_again}
                    result.unschedulable = [
                        n for n in result.unschedulable if n not in names
                    ]
                    batch = pending_again
                    continue
            result.unschedulable.extend(solve.unschedulable)
            for name in solve.unschedulable:
                self.recorder.publish(
                    "FailedScheduling", "no feasible instance offering", object_name=name,
                    object_kind="Pod", type="Warning",
                )
            break
        # Preemption: higher-priority demand that survived EVERY cascade round
        # (a capacity-deferred or launch-blocked gang, or an unschedulable
        # prioritized pod) may displace cheaper lower-priority victims and
        # bind in this same round.
        if self.settings.preemption_enabled and (
            result.unschedulable or result.gang_deferred or capacity_gangs
        ):
            preempted_gangs |= self._run_preemption(
                result, gangs, capacity_gangs, cap
            )
        # All-or-nothing epilogue: launch failures (limits, ICE, cloud
        # errors) can split a gate-admitted gang AFTER the gate ran — roll
        # those bindings back so a gang is never partially placed, and emit
        # the gang-admitted verdict only for gangs that actually bound whole.
        if gangs:
            self._finalize_gangs(gangs, result, gang_admit_details, preempted_gangs)
        # final per-pod unschedulable verdicts for the audit log (the pods
        # that survived every cascade round unplaced); metric inc'd once
        for i, name in enumerate(result.unschedulable):
            DECISIONS.record(
                "placement", "unschedulable", pod=name,
                reason=unsched_reason.get(name, "no feasible instance offering"),
                value=float(len(result.unschedulable)) if i == 0 else 0.0,
            )
        metrics.PODS_UNSCHEDULABLE.set(float(len(result.unschedulable)))
        metrics.PROVISIONING_DURATION.observe(time.perf_counter() - t0)
        self.batcher.reset(upto_generation=batch_gen)
        return result

    def _mask_stranded(self, names, masked, round_provs) -> bool:
        """True when some unschedulable pod could plausibly have landed on a
        diversification-masked pool — the only case where dropping the masks
        and burning the fallback re-solve can help. Deliberately conservative
        (requests-fit + label-surface checks, the same cheap approximation
        ``rejected_alternatives`` uses): when in doubt the fallback runs,
        because zero unschedulable pods outranks the extra solve round."""
        pods = [p for p in (self.cluster.pods.get(n) for n in names) if p is not None]
        if not pods:
            return False
        for prov, types in round_provs:
            prov_reqs = Requirements.from_labels(prov.labels).intersect(
                prov.requirements
            )
            for it in types:
                pools = [m for m in masked if m[0] == it.name]
                if not pools or not it.requirements.compatible(prov_reqs):
                    continue
                alloc = it.allocatable()
                for pod in pods:
                    if not pod.requests.fits(alloc):
                        continue
                    if not tolerates_all(list(pod.tolerations), tuple(prov.taints)):
                        continue
                    terms = pod.scheduling_requirement_terms()
                    for _, zone, ct in pools:
                        surface = it.requirements.add(
                            Requirement.in_values(wk.ZONE, [zone]),
                            Requirement.in_values(wk.CAPACITY_TYPE, [ct]),
                        ).intersect(prov_reqs)
                        if any(surface.compatible(term) for term in terms):
                            return True
        return False

    # -- placement validation firewall (solver fault domain, layer 1) -------
    @staticmethod
    def _backend_name(solve: SolveResult) -> str:
        stats = solve.stats or {}
        if stats.get("fallback"):
            return "greedy"
        # backend stamp values: 0=greedy oracle, 1=kernel, 2=host LP/topo,
        # 3=host FFD (see the solver backends' stats contracts)
        code = stats.get("backend")
        if code == 1.0:
            return "kernel"
        if code == 0.0:
            return "greedy"
        return "host"

    def _firewall_eval(
        self, solve, batch, round_provs, round_existing, daemonsets,
        *, check_fit: bool = True, gangs=None, div_units=(), check_div=False,
    ) -> List[PlanViolation]:
        """One firewall evaluation: the recorded verdict when a replay
        script is active (transient device faults cannot be recomputed
        offline — the capsule's decision IS the input), the real
        cluster-level re-check otherwise. Overhead lands in
        solve_phase_seconds{phase="validate"}."""
        scripted = fw_scripted_next()
        if scripted is not None:
            if scripted.get("verdict") == "accepted":
                return []
            return [
                PlanViolation(
                    code=v.get("code", ""), detail=v.get("detail", ""),
                    pod=v.get("pod", ""), node=v.get("node", ""),
                )
                for v in scripted.get("violations", [])
            ]
        t0 = time.perf_counter()
        violations = validate_bind_plan(
            solve,
            batch=batch,
            round_provs=round_provs,
            round_existing=round_existing,
            daemonsets=daemonsets,
            cluster=self.cluster,
            gangs=gangs,
            check_gangs=bool(gangs),
            slice_topology=self.settings.slice_topology_enabled,
            div_units=div_units,
            check_diversification=check_div,
            check_fit=check_fit,
        )
        spent = time.perf_counter() - t0
        self._fw_eval_s += spent
        metrics.SOLVE_PHASE.observe(spent, {"phase": "validate", "mode": "full"})
        return violations

    def _note_fw_event(
        self, verdict: str, backend: str, violations, fallback: str = "",
    ) -> None:
        event: Dict = {
            "round": len(self._fw_events), "verdict": verdict,
            "backend": backend,
        }
        if violations:
            event["violations"] = [v.to_dict() for v in violations]
        if fallback:
            event["fallback"] = fallback
        self._fw_events.append(event)
        metrics.SOLVER_VALIDATION.inc({"outcome": verdict})
        for i, v in enumerate(violations):
            metrics.VALIDATION_VIOLATIONS.inc({"code": v.code})
            DECISIONS.record(
                "validation", "rejected", pod=v.pod, node=v.node,
                reason=f"{v.code}: {v.detail}", details=v.to_dict(),
                value=float(len(violations)) if i == 0 else 0.0,
            )

    def _backend_firewall(
        self, solve, batch, round_provs, round_existing, daemonsets, cap,
    ) -> SolveResult:
        """Reject a backend answer that violates hard constraints and
        re-solve the round on the fallback backend (greedy oracle); a
        kernel-produced invalid plan also indicts its executable bucket on
        the kernel breaker. Both backends invalid → the round binds nothing
        (pods stay pending; next reconcile runs against a quarantined
        kernel, so the host paths answer)."""
        if not self.settings.solver_validation_enabled:
            return solve
        backend = self._backend_name(solve)
        violations = self._firewall_eval(
            solve, batch, round_provs, round_existing, daemonsets
        )
        if not violations:
            self._note_fw_event("accepted", backend, [])
            # a STRONG reference, never a bare id(): the gates may drop
            # the accepted object, and a recycled id on its replacement
            # would falsely skip the pre-bind fit checks
            self._fw_clean = solve
            return solve
        bucket = (solve.stats or {}).get("bucket")
        if backend == "kernel" and isinstance(bucket, str):
            # plausible-but-invalid kernel plan that slipped past the
            # count-level validator: quarantine the kernel's bucket (the
            # PyTorch solver stamps it as ``bucket``)
            from ..solver.solver import KERNEL_BOARD

            KERNEL_BOARD.fail(bucket, "invalid-plan")
        self._note_fw_event("rejected", backend, violations, fallback="greedy")
        self.recorder.publish(
            "PlanRejected",
            f"{backend} plan rejected by the validation firewall "
            f"({len(violations)} violations); re-solving on greedy",
            type="Warning",
        )
        fb = self._fw_fallback
        if fb is None:
            fb = self._fw_fallback = GreedySolver()
        fb.risk_penalty = getattr(self.solver, "risk_penalty", 0.0)
        solve2 = fb.solve_pods(
            batch, round_provs, existing=round_existing, daemonsets=daemonsets
        )
        if cap is not None:
            cap.add_digest(solve2.problem_digest, stats=solve2.stats)
        violations2 = self._firewall_eval(
            solve2, batch, round_provs, round_existing, daemonsets
        )
        if violations2:
            self._note_fw_event("rejected-final", "greedy", violations2)
            self.recorder.publish(
                "PlanRejected",
                "fallback plan rejected too — binding nothing this round",
                type="Warning",
            )
            return SolveResult(
                unschedulable=[p.name for p in batch],
                stats={"validation_rejected": 1.0},
            )
        self._note_fw_event("accepted", "greedy", [])
        self._fw_clean = solve2
        solve2.stats["validation_fallback"] = 1.0
        return solve2

    def _prebind_firewall(
        self, solve, batch, round_provs, round_existing, daemonsets,
        gangs, div_units, check_div: bool,
    ) -> SolveResult:
        """Last fence before ``_apply_solve`` binds: the gates only STRIP
        placements, so an object the backend layer cleared needs only the
        post-gate invariants (gang atomicity, slice-adjacency pins,
        diversification caps) re-verified; a swapped/rebuilt object gets the
        full fit checks too. Any violation refuses the bind wholesale —
        an invalid binding must never reach cluster state."""
        if not self.settings.solver_validation_enabled:
            return solve
        check_fit = solve is not self._fw_clean
        if not check_fit and not gangs and not div_units:
            return solve  # already cleared; nothing post-gate to verify
        violations = self._firewall_eval(
            solve, batch, round_provs, round_existing, daemonsets,
            check_fit=check_fit, gangs=gangs, div_units=div_units,
            check_div=check_div,
        )
        if not violations:
            self._note_fw_event("accepted", "gated", [])
            return solve
        self._note_fw_event("rejected-final", "gated", violations)
        self.recorder.publish(
            "PlanRejected",
            f"gated plan rejected pre-bind ({len(violations)} violations); "
            "binding nothing this round",
            type="Warning",
        )
        names = {n for spec in solve.new_nodes for n in spec.pod_names}
        for assigned in solve.existing_assignments.values():
            names.update(assigned)
        return SolveResult(
            unschedulable=sorted(set(solve.unschedulable) | names),
            stats={**(solve.stats or {}), "validation_rejected": 1.0},
        )

    def _trial_firewall(
        self, plan, batch: Sequence[Pod], base_existing=None,
    ) -> bool:
        """Validate a preemption trial BEFORE its victims are evicted: the
        trial binds through ``_apply_solve`` with no fit re-check, and an
        eviction cannot be undone — so a fault-corrupted trial plan must be
        refused here, which costs the preemptor one deferred round, never
        an invalid binding. Capacity is judged against the freed-capacity
        view (victims' requests handed back) over the SAME base the trial
        solved onto: ``base_existing`` is the in-cascade consumed-net view
        (existing capacity minus the round's still-unbound assignments);
        the post-cascade path passes nothing, where live cluster capacity
        — binds already applied — IS that view."""
        if not self.settings.solver_validation_enabled:
            return True
        from .preemption import freed_existing_view

        freed = freed_existing_view(
            base_existing if base_existing is not None
            else self.cluster.existing_capacity(),
            set(plan.victim_names),
        )
        round_provs = [
            (p, self.provider.get_instance_types(p))
            for p in self.cluster.provisioners.values()
        ]
        violations = self._firewall_eval(
            plan.result, batch, round_provs, freed, self.cluster.daemonsets()
        )
        if not violations:
            self._note_fw_event("accepted", "trial", [])
            return True
        self._note_fw_event("rejected-final", "trial", violations)
        self.recorder.publish(
            "PlanRejected",
            f"preemption trial rejected by the validation firewall "
            f"({len(violations)} violations); victims NOT evicted",
            type="Warning",
        )
        return False

    # -- cell-sharded solve path -------------------------------------------
    def _solve_round(
        self, batch, provisioners, round_provs, round_existing, daemonsets, cap
    ) -> SolveResult:
        """One cascade round's solve. Flat mode is the single delta session
        with one digest. Sharded mode partitions the batch into cells, fans
        per-cell solves out over a host worker pool (per-cell solver clones
        + EncodeSessions), then runs the global arbitration pass over the
        residue."""
        batch_names = [p.name for p in batch]
        LIFECYCLE.mark_many(batch_names, "solve_dispatch")
        if self.cells is None:
            solve = self.solver.solve_pods(
                batch, round_provs, existing=round_existing,
                daemonsets=daemonsets, session=self.encode_session,
            )
            if cap is not None:
                cap.add_digest(solve.problem_digest, stats=solve.stats)
        else:
            solve = self._solve_round_sharded(
                batch, provisioners, round_provs, round_existing, daemonsets,
                cap,
            )
        # placement validation firewall, backend layer: whatever backend
        # answered (kernel, host LP, greedy, the sharded merge), the plan is
        # re-checked against cluster-level hard constraints before the gates
        # consume it; an invalid plan re-solves on the fallback backend
        solve = self._backend_firewall(
            solve, batch, round_provs, round_existing, daemonsets, cap
        )
        # the backend that produced the plan the gates will consume — a
        # firewall fallback re-solve stamps the FALLBACK backend, the one
        # whose answer actually placed the pod
        LIFECYCLE.mark_many(
            batch_names, "solve_result", backend=self._backend_name(solve)
        )
        return solve

    def _solve_round_sharded(
        self, batch, provisioners, round_provs, round_existing, daemonsets, cap
    ) -> SolveResult:
        """Cell-decomposed solve: per-cell delta encodes + solves run
        concurrently (serial-equality discipline: worker count never
        changes the answer, only wall-clock), then the ARBITRATION pass
        places the cross-cell residue against the full catalog with the
        cells' existing-node consumption subtracted, and the merged launch
        list is ordered by per-cell marginal price so launch-limit
        contention between cells resolves toward the cheapest capacity
        first. The partition uses the reconcile's FULL provisioner set (a
        pool exhausted mid-cascade keeps its cell; its pods just route to
        the residue for the rest of the round) so the cell basis — and the
        per-cell digest streams — stay stable across cascade rounds.

        A copy of the reference's round, with these differences: no
        flight-recorder capsule is stamped (``cap`` stays None until
        ``ROADMAP.md`` Queue 1 item 7) and no ``profiling.note_phase`` is
        taken (item 9); ``stage_fleet`` takes no superproblem width, since
        the multi-device tier is not ported (item 10; ``mesh_enabled`` makes
        the constructor raise). A worker's exception, a kernel's launch
        error among them, re-raises here through ``map_all``."""
        import hashlib

        from ..parallel.hostpool import default_workers, map_all
        from ..state.cells import RESIDUE, cell_name
        from ..utils.metrics import series_key

        t0 = time.perf_counter()
        router = self.cells
        plan = router.plan_round(batch, provisioners)
        LIFECYCLE.mark_many([p.name for p in batch], "cell_routed")
        if (
            self.settings.cell_max_pods
            and plan.max_cell_pods > self.settings.cell_max_pods
        ):
            # degenerate-partition guardrail: one giant cell gains nothing
            # from decomposition; solve flat (sessionless, so this round
            # pays a full encode) and stamp the router with the reason.
            # Solved in the router's canonical per-cell order — the batch
            # order a capsule records — so a replay's from-scratch encode
            # of the recorded order reproduces this digest
            metrics.ENCODE_FULL_REASONS.inc({"reason": "cell-overflow"})
            router.last_mode, router.last_full_reason = "full", "cell-overflow"
            solve = self.solver.solve_pods(
                router.ordered_pods(), round_provs, existing=round_existing,
                daemonsets=daemonsets,
            )
            return solve
        provs_by_name = {p.name: (p, types) for p, types in round_provs}
        # cell ids are positions in the PARTITION's sorted cell list — the
        # same numbering /debug/cells and the {cell} memory series use — so
        # an exhausted cell dropping out of this round's solves never
        # renumbers its neighbors across surfaces
        cell_ids = {key: i for i, (key, _) in enumerate(plan.cells)}
        residue_pods: List[Pod] = list(plan.residue)
        works = []
        borrowed = False
        for key, cell_pods in plan.cells:
            entry = provs_by_name.get(key[0])
            if entry is None:
                # the cell's pool is exhausted this cascade round: its pods
                # cascade through the residue against the remaining pools.
                # They stay members of their HOME cell's session — the
                # residue solve goes sessionless for the round (see below),
                # so neither session's membership (and neither canonical
                # order) is disturbed by the loan
                residue_pods.extend(cell_pods)
                borrowed = True
            else:
                works.append((key, cell_pods, [entry]))
        live_cells = {key for key, _, _ in works}
        ex_by_cell: Dict[tuple, List[ExistingNode]] = {}
        for e in round_existing:
            ex_by_cell.setdefault(
                router.map.node_cell(e.node, live_cells), []
            ).append(e)
        solvers = [self._cell_solver(key) for key, _, _ in works]
        workers = default_workers(self.settings.cell_shard_workers, cap=8)
        if any(s is self.solver for s in solvers):
            workers = 1  # clone construction failed: shared solver, serial

        # -- clean-cell reuse ------------------------------------------------
        # A cell is CLEAN when no event routed into it since its last solve
        # (plan.dirty) and every other solve_pods input is unchanged: the
        # provisioner spec (rv), the catalog list (identity — the provider's
        # seqnum cache returns the same object until pricing/ICE/risk move;
        # the cached strong ref keeps that id() from being recycled), the
        # cell's existing capacity (node rv + bound-pod names pin each
        # column exactly as the session does) and the daemonset overhead.
        # An unchanged problem provably re-encodes to the same digest (the
        # delta==full contract), so the cached result IS this round's
        # answer. A clean cell's cached result is normally action-free (any
        # bind from its last solve routed a pod DELETE into it; an ICE'd
        # launch bumped the catalog seqnum) — the one exception, a launch
        # lost to a transient cloud error, reuses the same plan and simply
        # retries it, exactly what a re-solve of the unchanged problem
        # would do. Decided serially BEFORE the fan-out, so worker count
        # never changes the answer (the serial-equality discipline).
        ds_sig = tuple(sorted(
            (d.meta.name, d.meta.resource_version) for d in daemonsets
        )) if daemonsets else ()

        def cell_sig(key, prov, types):
            return (
                prov.meta.resource_version,
                id(types),
                ds_sig,
                tuple(sorted(
                    (e.node.name, e.node.meta.resource_version,
                     tuple(sorted(p.meta.name for p in e.pods)))
                    for e in ex_by_cell.get(key, ())
                )),
            )

        sigs = [cell_sig(key, provs[0][0], provs[0][1])
                for key, _, provs in works]
        reused: Dict[int, SolveResult] = {}
        for i, (key, _, _) in enumerate(works):
            hit = self._cell_solve_cache.get(key)
            if key not in plan.dirty and hit is not None and hit[0] == sigs[i]:
                reused[i] = hit[2]

        # -- fleet dispatch ---------------------------------------------------
        # Encode every dirty cell FIRST (serial — encodes serialize on
        # ENCODE_LOCK anyway, and each cell's session/digest is untouched by
        # the reordering), group the encoded problems by bucket, and launch
        # ONE batched kernel chain per bucket chunk before any per-cell
        # solve runs: the card computes the whole fleet while the host paths
        # execute, and the round pays O(distinct buckets) dispatches instead
        # of O(cells). Each batched row is bit-identical to the per-cell
        # chain's buffer, so every downstream contract (race comparison,
        # flat==sharded) holds unchanged.
        # Clean-cell reuse stays decided above (reused cells never encode or
        # dispatch) and the residue arbitration below is untouched.
        staged: Dict[int, object] = {}
        fleet_stats = None
        # the gauge reflects THIS round: a quiet round (nothing to batch)
        # must read 0, not the previous round's count (the stale-series
        # class the per-cell lag gauges prune for)
        metrics.FLEET_ROUND_DISPATCHES.set(0.0)
        if (
            self.settings.fleet_dispatch_enabled
            and len(works) - len(reused) >= 2
        ):
            from ..solver.solver import stage_fleet

            for i, (key, cell_pods, cell_provs) in enumerate(works):
                if i in reused:
                    continue
                staged[i] = solvers[i].encode_for_staging(
                    cell_pods, cell_provs,
                    existing=ex_by_cell.get(key, []),
                    daemonsets=daemonsets,
                    session=router.session(key),
                )
                # encode/H2D overlap: pad and stage this cell's tensors NOW
                # on its clone, so that they are resident by dispatch time
                # and stage_fleet stacks the chunk on the card
                solvers[i].prestage(staged[i])
            fleet_stats = stage_fleet(
                [(solvers[i], staged[i]) for i in sorted(staged)],
                max_batch=self.settings.fleet_max_batch,
            )
            metrics.FLEET_ROUND_DISPATCHES.set(
                float(fleet_stats["dispatches"])
            )

        def one(i, work):
            if i in reused:
                return reused[i], 0.0, 0.0
            key, cell_pods, cell_provs = work
            t_start = time.perf_counter()
            res = solvers[i].solve_pods(
                cell_pods, cell_provs,
                existing=ex_by_cell.get(key, []),
                daemonsets=daemonsets,
                session=router.session(key),
                pre_encoded=staged.get(i),
            )
            return res, t_start - t0, time.perf_counter() - t_start

        outs = map_all(one, works, workers)
        cell_results = [o[0] for o in outs]

        # -- global arbitration pass ----------------------------------------
        residue_solve = None
        if residue_pods:
            t_arb = time.perf_counter()
            adjusted = self._consume_existing(
                round_existing, cell_results, batch
            )
            # a round with borrowed exhausted-cell pods solves the residue
            # SESSIONLESS: feeding the loaned pods into the residue session
            # would desync its membership from the true residue class (a
            # non-benign pod-set-desync full fallback) and double-list them
            # in the canonical batch order the capsule records
            residue_solve = self.solver.solve_pods(
                residue_pods, round_provs, existing=adjusted,
                daemonsets=daemonsets,
                session=None if borrowed else router.session(RESIDUE),
            )
            arb_s = time.perf_counter() - t_arb
            metrics.SOLVE_PHASE.observe(
                arb_s, {"phase": "arbitrate", "mode": "sharded"}
            )

        # -- serial merge (deterministic: cell order, then residue) ---------
        marginals = [
            _marginal_price(types for _, types in work[2])
            for work in works
        ]
        summaries: List[Dict] = []
        modes: List[Tuple[str, str]] = []
        pods_series: Dict = {}
        digest_h = hashlib.sha256()
        merged = SolveResult()
        launch_order = sorted(
            range(len(works)), key=lambda i: (marginals[i], i)
        )
        for i in launch_order:
            merged.new_nodes.extend(cell_results[i].new_nodes)
        for i, (work, out) in enumerate(zip(works, outs)):
            key, cell_pods, cell_provs = work
            res, lag_s, solve_s = out
            session = router.session(key)
            if i not in reused:
                if len(self._cell_solve_cache) > 256:
                    # bound: cells churned away by repartitions leave entries
                    self._cell_solve_cache.clear()
                self._cell_solve_cache[key] = (sigs[i], cell_provs[0][1], res)
            # the cell's problem is now solved (or validly reused): events
            # only re-dirty it through plan_round on this same thread, so
            # clearing the flag here races nothing
            router.mark_clean(key)
            for node_name, names in res.existing_assignments.items():
                merged.existing_assignments.setdefault(
                    node_name, []
                ).extend(names)
            merged.unschedulable.extend(res.unschedulable)
            merged.cost += res.cost
            for stat in ("encode_s", "lower_bound"):
                merged.stats[stat] = (
                    merged.stats.get(stat, 0.0) + res.stats.get(stat, 0.0)
                )
            digest_h.update(bytes.fromhex(res.problem_digest or "00"))
            # a reused cell is the purest delta round (zero changed inputs);
            # the session's own last_mode is stale for it, and a 0-second
            # sample would pollute the solve-phase histogram
            mode = "reused" if i in reused else session.last_mode
            modes.append(
                ("delta", "") if i in reused
                else (session.last_mode, session.last_full_reason)
            )
            if i not in reused:
                metrics.SOLVE_PHASE.observe(
                    solve_s, {"phase": "cell", "mode": session.last_mode}
                )
            cid = cell_ids[key]
            metrics.RECONCILE_LOOP_LAG.set(
                max(lag_s, 0.0),
                {"controller": "provisioning", "cell": str(cid)},
            )
            pods_series[series_key({"cell": str(cid)})] = float(len(cell_pods))
            summaries.append({
                "cell": cid,
                "name": cell_name(key),
                "pods": len(cell_pods),
                "digest": res.problem_digest,
                "cost": round(res.cost, 5),
                "unschedulable": len(res.unschedulable),
                "marginal_price": (
                    None if marginals[i] == float("inf")
                    else round(marginals[i], 5)
                ),
                "dual_bound": round(res.stats.get("lower_bound", 0.0), 5),
                "encode_mode": mode,
                "lag_s": round(max(lag_s, 0.0), 4),
                "solve_s": round(solve_s, 4),
            })
        if residue_solve is not None:
            merged.new_nodes.extend(residue_solve.new_nodes)
            for node_name, names in residue_solve.existing_assignments.items():
                merged.existing_assignments.setdefault(
                    node_name, []
                ).extend(names)
            merged.unschedulable.extend(residue_solve.unschedulable)
            merged.cost += residue_solve.cost
            for stat in ("encode_s", "lower_bound"):
                merged.stats[stat] = (
                    merged.stats.get(stat, 0.0)
                    + residue_solve.stats.get(stat, 0.0)
                )
            digest_h.update(
                bytes.fromhex(residue_solve.problem_digest or "00")
            )
            if borrowed:
                # sessionless loan round: a full encode with no session
                # state to stamp (benign — not a fallback anomaly)
                rmode, rreason = "full", ""
            else:
                rsession = router.session(RESIDUE)
                rmode, rreason = rsession.last_mode, rsession.last_full_reason
            modes.append((rmode, rreason))
            pods_series[series_key({"cell": "residue"})] = float(
                len(residue_pods)
            )
            summaries.append({
                "cell": "residue",
                "name": "residue",
                "pods": len(residue_pods),
                "digest": residue_solve.problem_digest,
                "cost": round(residue_solve.cost, 5),
                "unschedulable": len(residue_solve.unschedulable),
                "encode_mode": rmode,
            })
        merged.existing_assignments = {
            k: list(v) for k, v in merged.existing_assignments.items()
        }
        merged.problem_digest = digest_h.hexdigest()
        merged.stats["total_s"] = time.perf_counter() - t0
        merged.stats["cells"] = float(len(works))
        merged.stats["cells_reused"] = float(len(reused))
        merged.stats["residue_pods"] = float(len(residue_pods))
        if fleet_stats is not None:
            merged.stats["fleet_dispatches"] = float(fleet_stats["dispatches"])
            merged.stats["fleet_cells_batched"] = float(
                fleet_stats["cells_batched"]
            )
        router.note_round_modes(modes)
        router.last_round = summaries
        metrics.CELLS_TOTAL.set(float(len(works)))
        metrics.CELL_PODS.replace_series(pods_series)
        # drop {cell} lag series for cells this round no longer has (the
        # gauge is shared with other controllers' series, so prune — never
        # replace — and only this controller's cell-labeled series)
        live_cell_ids = {str(cell_ids[key]) for key, _, _ in works}
        metrics.RECONCILE_LOOP_LAG.prune_series(
            lambda d: (
                d.get("controller") != "provisioning"
                or "cell" not in d
                or d["cell"] in live_cell_ids
            )
        )
        # plain record, not coalesced: every round emits exactly one
        DECISIONS.record(
            "cell", "sharded-round",
            reason=(
                f"{len(works)} cells, {len(residue_pods)} cross-cell pods"
            ),
            details={
                "cells": len(works),
                "residue_pods": len(residue_pods),
                "workers": workers,
                **(
                    {
                        "fleet_dispatches": fleet_stats["dispatches"],
                        "fleet_cells_batched": fleet_stats["cells_batched"],
                    }
                    if fleet_stats is not None
                    else {}
                ),
            },
        )
        return merged

    def _consume_existing(
        self, existing, cell_results, batch
    ) -> List[ExistingNode]:
        """Existing capacity as the arbitration pass sees it: the per-cell
        solves' existing-node assignments subtracted (remaining shrunk, the
        placed pods added to the topology seeds), so the residue can never
        double-book a node a cell already filled."""
        import dataclasses

        consumed: Dict[str, List[str]] = {}
        for res in cell_results:
            for node_name, names in res.existing_assignments.items():
                consumed.setdefault(node_name, []).extend(names)
        if not consumed:
            return list(existing)
        by_name = {p.meta.name: p for p in batch}
        out: List[ExistingNode] = []
        for e in existing:
            names = consumed.get(e.node.name)
            if not names:
                out.append(e)
                continue
            pods = [by_name[n] for n in names if n in by_name]
            used = merge([p.requests + Resources(pods=1) for p in pods])
            out.append(dataclasses.replace(
                e,
                remaining=(e.remaining - used).clamp_min_zero(),
                pods=e.pods + tuple(pods),
            ))
        return out

    def _cell_solver(self, key) -> Solver:
        s = self._cell_solvers.get(key)
        if s is None:
            if len(self._cell_solvers) > 256:
                # bound: cells churned away by repartitions leave clones
                self._cell_solvers.clear()
            s = self._clone_solver()
            if s is None:
                s = self.solver  # shared: the round degrades to serial
            self._cell_solvers[key] = s
        return s

    def _clone_solver(self) -> Optional[Solver]:
        """A per-cell solver of the configured type. Clones are what make
        the fan-out safe (device caches, interning and race memory are
        per-instance); a solver that cannot be default-constructed — e.g.
        the replay harness's digest tap — shares the main instance and the
        round runs serial, which keeps answers (and replayed digest
        sequences) identical.

        Differs from the reference in two ways. A ``TorchSolver``'s clone
        is built on the main solver's device: ``type(self.solver)()`` would
        build a card solver beside a CPU one, which raises without CUDA.
        And only a ``TypeError`` (a solver whose constructor needs
        arguments) falls back to sharing: the reference's ``except
        Exception`` would turn a CPU round serial without a word, and on
        the card hide a CUDA error. No mesh fields are carried: the
        multi-device tier is not ported."""
        try:
            if isinstance(self.solver, TorchSolver):
                clone = type(self.solver)(device=self.solver.device)
            else:
                clone = type(self.solver)()
        except TypeError:
            return None
        clone.risk_penalty = getattr(self.solver, "risk_penalty", 0.0)
        # staging policy rides along: per-cell stagers are private, but the
        # operator's enable/capacity choice must bind every clone
        st = getattr(self.solver, "_stager", None)
        if st is not None and hasattr(clone, "_stager"):
            clone._stager.enabled = st.enabled
            clone._stager.capacity_bytes = st.capacity_bytes
        if hasattr(self.solver, "dispatch_timeout_s") and hasattr(
            clone, "dispatch_timeout_s"
        ):
            clone.dispatch_timeout_s = self.solver.dispatch_timeout_s
        return clone

    # -- /debug/cells -------------------------------------------------------
    def cell_status(self, pod: Optional[str] = None) -> Dict:
        """The /debug/cells payload: the current partition, the last
        sharded round's per-cell summaries, and — with ``pod=`` — which
        cell owns a pod and why (runbook workflow 7)."""
        from ..state.cells import RESIDUE, cell_name

        out: Dict = {"enabled": self.cells is not None, "cells": []}
        if self.cells is None:
            return out
        router = self.cells
        with router._lock:
            keys = router.map.cell_keys()
            counts: Dict = {}
            for e in router.map._pods.values():
                counts[e.cell] = counts.get(e.cell, 0) + 1
            out["cells"] = [
                {"id": i, "name": cell_name(k), "pending_pods": counts.get(k, 0)}
                for i, k in enumerate(keys)
            ]
            out["residue"] = {"pending_pods": counts.get(RESIDUE, 0)}
            out["last_round"] = list(router.last_round)
            if pod:
                entry: Dict = {"pod": pod}
                cell = router.map.cell_of(pod)
                if cell is not None:
                    entry["cell"] = cell_name(cell)
                    pe = router.map._pods.get(pod)
                    if pe is not None:
                        entry["feasible_provisioners"] = list(pe.feas)
                        entry["zone_pin"] = pe.zone
                        entry["gang"] = pe.gang
                        if cell == RESIDUE:
                            entry["why_residue"] = (
                                f"feasible in {len(pe.feas)} cells"
                                if len(pe.feas) != 1
                                else "gang members span cells"
                            )
                else:
                    p = self.cluster.pods.get(pod)
                    if p is not None and p.node_name:
                        node = self.cluster.nodes.get(p.node_name)
                        if node is not None:
                            entry["cell"] = cell_name(
                                router.map.node_cell(node)
                            )
                            entry["bound_to"] = p.node_name
                out["owner"] = entry
        return out

    def cell_memory_bytes(self) -> Dict[str, float]:
        """Per-cell encoder footprint for the {cell}-aware memory scrape."""
        return self.cells.memory_bytes() if self.cells is not None else {}

    #: bounded in-round re-solves after ICE launch failures: each retry has
    #: the failed offering(s) freshly masked, so one retry normally lands the
    #: next-cheapest offering; a storm falls back to the next reconcile
    _ICE_RETRIES = 2
    #: bounded in-round respread re-solves after the spot-diversification
    #: gate strips over-concentrated members; each retry masks at least one
    #: more pool, and the placement-over-diversification fallback runs last
    _DIVERSIFY_RETRIES = 3

    # -- gang scheduling ----------------------------------------------------
    def _gang_gate(
        self,
        solve: SolveResult,
        gangs: Dict[str, Gang],
        round_provs,
        daemonsets,
        cap,
    ) -> "GangGateOutcome":
        """All-or-nothing + rank-aware gate between solve and bind.

        Per gang (deterministic name order): below quorum or partially placed
        -> every member's placement is STRIPPED and the gang defers whole
        (``gang-deferred-insufficient-members`` / ``gang-deferred`` verdicts);
        fully placed but zone-scattered on pure fresh nodes -> a bounded
        single-zone replan (solver/gang.py) swaps in topology-adjacent
        placement when it beats the scatter-penalized cost; fully placed ->
        ``gang-admitted`` with the zone set and price delta. Returns a NEW
        SolveResult shell — the input (possibly cache-shared) is not mutated.
        """
        node_zone = lambda name: (  # noqa: E731 — tiny closure over the store
            n.zone() if (n := self.cluster.nodes.get(name)) is not None else ""
        )
        strip: set = set()
        deferred: List[str] = []
        admitted: List[str] = []
        admitted_gangs: List[str] = []
        capacity_deferred: List[str] = []
        admitted_details: Dict[str, Dict] = {}
        drop_spec_idx: set = set()
        swap_specs: List[NewNodeSpec] = []
        digest_sink = cap.add_digest if cap is not None else None
        # slice-adjacency scoring is active only when BOTH the setting is on
        # and the round's catalog actually carries ICI coordinates — a
        # topology-enabled operator on a sliceless catalog is the zone-
        # granular gate, byte for byte
        slice_active = self.settings.slice_topology_enabled and (
            topology.catalog_has_slices(round_provs)
        )
        # coordinates claimed by gangs admitted EARLIER IN THIS PASS: their
        # swapped specs are staged (not yet cluster nodes), so without this
        # accumulator two gangs replanned into the same cheapest domain
        # would window onto colliding slice locations
        pass_occupied: Dict[Tuple[str, str], set] = {}

        def occupied_lookup(zone: str, domain: str) -> frozenset:
            return self._occupied_coords(zone, domain) | frozenset(
                pass_occupied.get((zone, domain), ())
            )

        def claim_coords(specs) -> None:
            for s in specs:
                opt = s.option
                if opt.slice_pod and opt.slice_coord is not None:
                    pass_occupied.setdefault(
                        (opt.zone, opt.slice_pod), set()
                    ).add(opt.slice_coord)
        for name in sorted(gangs):
            g = gangs[name]
            # judge only the members still unbound: a mid-cascade round must
            # not re-defer (or roll back) a gang whose members an EARLIER
            # round already bound — it heals the remainder instead
            unbound = [p for p in g.pods if p.node_name is None]
            if not unbound:
                continue  # fully bound by an earlier round: nothing to judge
            bound = gangmod.bound_members(self.cluster, name)
            g_round = Gang(
                name=name, pods=unbound, min_members=g.min_members,
                priority=g.priority,
            )
            unbound_names = g_round.member_names
            placement = gangmod.gang_placement(solve, g_round, node_zone)
            alive = len(unbound) + len(bound)
            if alive < g.min_members:
                strip.update(unbound_names)
                deferred.extend(sorted(unbound_names))
                self._note_gang_deferral(
                    g, "gang-deferred-insufficient-members",
                    f"{alive}/{g.min_members} members present",
                    {"members": alive, "min_members": g.min_members},
                )
                continue
            if placement.unplaced:
                strip.update(unbound_names)
                deferred.extend(sorted(unbound_names))
                capacity_deferred.append(name)
                self._note_gang_deferral(
                    g, "gang-deferred",
                    "insufficient capacity for atomic placement",
                    {
                        "members": len(g.pods),
                        "unplaced": len(placement.unplaced),
                    },
                )
                continue
            # fully placed: rank-aware packing for pure fresh-node gangs
            # (only when the WHOLE gang is being placed this round — already-
            # bound members pin their zones/slices and are never repacked).
            # With slice topology active the score is ICI hop distance
            # (adjacency replan onto one domain, compact coordinate remap);
            # otherwise the zone-granular scatter replan runs verbatim.
            price_delta = 0.0
            zones = set(placement.zones)
            zones.update(z for p in bound if (z := node_zone(p.node_name or "")))
            hop_mean: Optional[float] = None
            domains: List[str] = []
            did_slice = False
            # the gang's replan outcome is staged locally and folded into
            # the shared drop/swap sets only at ADMISSION — a required-mode
            # deferral below must discard the swap, or the swapped specs
            # (which bypass the per-spec strip filter) would bind a gang
            # the gate just deferred
            gang_drop: set = set()
            gang_swap: List[NewNodeSpec] = []
            if slice_active and bound:
                # scale-up of a RUNNING adjacency-required gang: new
                # members must join the bound members' home domain. A
                # solver plan that leaves it gets one pinned replan
                # (budget bypassed — required is a constraint, not a
                # preference); failing that, the new members defer. A gang
                # running on non-slice capacity has no satisfiable home —
                # the annotation is inert for it, like the CPU-gang case.
                mode = gangmod.gang_adjacency_mode(g_round)
                if mode == "required" and gangmod.wants_slices(g_round):
                    home = {
                        (n.zone(), n.slice_pod())
                        for p in bound
                        if (n := self.cluster.nodes.get(p.node_name or ""))
                        is not None
                    }
                    anchored = len(home) == 1 and next(iter(home))[1] != ""
                    if anchored:
                        locs = set()
                        for node_name, names_ in solve.existing_assignments.items():
                            if unbound_names & set(names_):
                                n = self.cluster.nodes.get(node_name)
                                locs.add(
                                    (n.zone(), n.slice_pod())
                                    if n is not None
                                    else ("", "")
                                )
                        for spec in solve.new_nodes:
                            if unbound_names & set(spec.pod_names):
                                locs.add(
                                    (spec.option.zone, spec.option.slice_pod)
                                )
                        ok = locs <= home
                        if ok and placement.pure and placement.pure_spec_idx:
                            # in-domain already, but the solver stacks
                            # price-equal coordinates arbitrarily: remap
                            # the new members' specs onto free slots so
                            # they never collide with the running members'
                            zone_h, dom_h = next(iter(home))
                            remapped = topology.remap_compact(
                                [
                                    solve.new_nodes[i]
                                    for i in placement.pure_spec_idx
                                ],
                                round_provs,
                                occupied=occupied_lookup(zone_h, dom_h),
                            )
                            if remapped is not None:
                                gang_drop = set(placement.pure_spec_idx)
                                gang_swap = remapped
                        if not ok and placement.pure:
                            replan = gangmod.slice_adjacency_replan(
                                self.solver, g_round, placement.cost, [],
                                round_provs,
                                self.settings.slice_hop_penalty_frac,
                                daemonsets=daemonsets,
                                digest_sink=digest_sink,
                                occupied_lookup=occupied_lookup,
                                enforce_budget=False,
                                restrict=home,
                            )
                            if replan is not None:
                                _domain, specs, cost, _hops = replan
                                gang_drop = set(placement.pure_spec_idx)
                                gang_swap = specs
                                price_delta = round(
                                    cost - placement.cost, 5
                                )
                                ok = True
                        if not ok:
                            strip.update(unbound_names)
                            deferred.extend(sorted(unbound_names))
                            capacity_deferred.append(name)
                            self._note_gang_deferral(
                                g, "gang-deferred",
                                "scale-up members cannot join the running "
                                "gang's slice domain (slice-adjacency: "
                                "required)",
                                {
                                    "members": len(g.pods),
                                    "domains": sorted(
                                        d for _, d in home if d
                                    ),
                                },
                            )
                            continue
            if slice_active and placement.pure and not bound:
                pts = [
                    topology.spec_point(solve.new_nodes[i].option)
                    for i in placement.pure_spec_idx
                ]
                hop_mean, _ = topology.plan_hop_stats(pts)
                domains = sorted(
                    {p.slice_pod for p in pts if p.slice_pod}
                )
                mode = gangmod.gang_adjacency_mode(g_round)
                slice_eligible = mode != "none" and gangmod.wants_slices(g_round)
                if slice_eligible and hop_mean > 0:
                    replan = gangmod.slice_adjacency_replan(
                        self.solver, g_round, placement.cost, pts, round_provs,
                        self.settings.slice_hop_penalty_frac,
                        daemonsets=daemonsets, digest_sink=digest_sink,
                        occupied_lookup=occupied_lookup,
                        # required mode: adjacency is a hard constraint —
                        # the best single-domain plan wins whatever it
                        # costs against the incumbent (a budget-filtered
                        # None would defer the gang forever while feasible
                        # adjacent capacity exists)
                        enforce_budget=(mode != "required"),
                    )
                    if replan is not None:
                        # only a SUCCESSFUL slice swap supersedes the
                        # zone replan: a budget-rejected slice replan must
                        # still fall through to the single-zone repack a
                        # multi-zone scatter would otherwise get
                        did_slice = True
                        domain, specs, cost, hop_mean = replan
                        gang_drop = set(placement.pure_spec_idx)
                        gang_swap = specs
                        price_delta = round(cost - placement.cost, 5)
                        zones = {specs[0].option.zone} if specs else zones
                        domains = [domain]
                # "required" binds only slice-CONSUMING gangs: a CPU gang
                # annotated required can never be slice-adjacent, and
                # deferring it forever would be a silent permanent-Pending
                # trap for a one-line annotation mistake (the annotation is
                # simply inert for it, like "preferred")
                if mode == "required" and slice_eligible and (
                    len(domains) != 1
                    or len(zones) > 1
                    or hop_mean is None
                    or hop_mean >= topology.CROSS_POD_HOPS
                ):
                    # adjacency is a hard constraint for this gang: no
                    # single-domain plan exists this round, so it waits
                    # (all-or-nothing discipline, now in the ICI dimension)
                    strip.update(unbound_names)
                    deferred.extend(sorted(unbound_names))
                    capacity_deferred.append(name)
                    self._note_gang_deferral(
                        g, "gang-deferred",
                        "no adjacent single-slice-domain placement "
                        "(slice-adjacency: required)",
                        {"members": len(g.pods), "domains": domains},
                    )
                    continue
            if not did_slice and placement.pure and len(zones) > 1 and not bound:
                replan = gangmod.rank_aware_replan(
                    self.solver, g, placement.cost, zones, round_provs,
                    daemonsets=daemonsets, digest_sink=digest_sink,
                )
                if replan is not None:
                    zone, specs, cost = replan
                    gang_drop = set(placement.pure_spec_idx)
                    gang_swap = specs
                    price_delta = round(cost - placement.cost, 5)
                    zones = {zone}
                    if hop_mean is not None:
                        # the hop detail must describe the SWAPPED plan, not
                        # the scattered one the zone replan just replaced
                        hop_mean, _ = topology.plan_hop_stats(
                            [topology.spec_point(s.option) for s in specs]
                        )
                        domains = sorted(
                            {
                                s.option.slice_pod
                                for s in specs
                                if s.option.slice_pod
                            }
                        )
            drop_spec_idx.update(gang_drop)
            swap_specs.extend(gang_swap)
            # register the admitted gang's slice locations so LATER gangs
            # in this same pass window around them (their specs are staged,
            # not yet cluster nodes)
            claim_coords(
                gang_swap
                if gang_swap
                else [solve.new_nodes[i] for i in placement.pure_spec_idx]
            )
            admitted.extend(sorted(unbound_names))
            admitted_gangs.append(name)
            admitted_details[name] = {
                "members": len(g.pods),
                "zones": sorted(zones),
                "scattered": len(zones) > 1,
                "price_delta": price_delta,
            }
            if slice_active and hop_mean is not None:
                admitted_details[name]["hop_mean"] = round(hop_mean, 4)
                admitted_details[name]["slice_domains"] = domains
                metrics.GANG_HOP_DISTANCE.observe(hop_mean)
        if not strip and not drop_spec_idx:
            return GangGateOutcome(
                solve, deferred, admitted, admitted_gangs, capacity_deferred,
                admitted_details,
            )
        new_nodes: List[NewNodeSpec] = []
        for idx, spec in enumerate(solve.new_nodes):
            if idx in drop_spec_idx:
                continue  # replaced by the rank-aware single-zone specs
            names = [n for n in spec.pod_names if n not in strip]
            if not names:
                continue
            if len(names) == len(spec.pod_names):
                new_nodes.append(spec)
            else:
                new_nodes.append(
                    NewNodeSpec(
                        option=spec.option, pod_names=names,
                        option_index=spec.option_index,
                    )
                )
        new_nodes.extend(swap_specs)
        existing: Dict[str, List[str]] = {}
        for node_name, pod_names in solve.existing_assignments.items():
            names = [n for n in pod_names if n not in strip]
            if names:
                existing[node_name] = names
        gated = SolveResult(
            new_nodes=new_nodes,
            existing_assignments=existing,
            unschedulable=[n for n in solve.unschedulable if n not in strip],
            cost=sum(s.option.price for s in new_nodes),
            stats=dict(solve.stats),
            problem_digest=solve.problem_digest,
        )
        return GangGateOutcome(
            gated, deferred, admitted, admitted_gangs, capacity_deferred,
            admitted_details,
        )

    def _occupied_coords(self, zone: str, domain: str) -> frozenset:
        """Slice coordinates live nodes already hold in (zone, domain): the
        adjacency remap windows around them — a physical slice hosts one
        node, so successive gangs in one domain must not collide. Pure
        function of cluster state, so replay re-derives it byte-for-byte."""
        return frozenset(
            c
            for n in self.cluster.nodes.values()
            if n.zone() == zone
            and n.slice_pod() == domain
            and (c := n.slice_coord()) is not None
        )

    def _note_gang_deferral(
        self, g: Gang, outcome: str, reason: str, details: Dict
    ) -> None:
        # one wait tick per RECONCILE, not per cascade round: limit-hit/ICE
        # re-solve rounds re-judge a still-deferred gang several times within
        # a single reconcile, and each is the same wait, not a new one
        if g.name in self._gang_wait_ticked:
            waited = self._gang_wait.get(g.name, 1)
        else:
            waited = self._gang_wait.get(g.name, 0) + 1
            self._gang_wait[g.name] = waited
            self._gang_wait_ticked.add(g.name)
            # escalate exactly once when the wait budget is crossed: the gang
            # keeps deferring (all-or-nothing is not negotiable) but operators
            # get the same FailedScheduling signal an unschedulable pod would
            if waited == self.settings.gang_max_wait_rounds:
                self.recorder.publish(
                    "GangWaitExceeded",
                    f"gang {g.name} still pending after {waited} rounds: {reason}",
                    object_name=g.name, object_kind="PodGroup", type="Warning",
                )
        metrics.GANG_VERDICTS.inc({"outcome": outcome.replace("gang-", "", 1)})
        DECISIONS.record_coalesced(
            "gang", outcome, pod=g.name, reason=reason,
            details={**details, "wait_rounds": waited},
        )

    # -- preemption ---------------------------------------------------------
    def _priority_floor(self) -> Optional[int]:
        """Lowest priority among bound workload pods — the entitlement bar a
        preemptor must clear strictly (None when nothing is bound)."""
        floor = None
        for p in self.cluster.pods.values():
            if p.node_name is not None and not p.is_daemonset:
                if floor is None or p.priority < floor:
                    floor = p.priority
        return floor

    def _note_gang_evicted(self, plan) -> None:
        """Start the restart-boost clock for every gang this plan evicted
        whole (bounded by settings.gang_restart_boost_rounds; 0 disables)."""
        rounds = self.settings.gang_restart_boost_rounds
        if rounds <= 0:
            return
        for gname in plan.victim_gangs:
            self._gang_restart_boost[gname] = rounds
            self.preemption.restart_boosted.add(gname)

    def _preempt_or_launch(
        self,
        solve: SolveResult,
        gangs: Dict[str, Gang],
        admitted_gangs,
        result: ProvisioningResult,
        cap,
    ) -> Tuple[SolveResult, set]:
        """One cost decision per admitted gang about to open fresh capacity:
        evict cost (victim price delta + restart tax, PreemptionPlan.
        evict_cost) vs. launch cost (the gang's pure new-node price). When
        eviction wins, the plan executes, the gang binds onto the freed
        capacity in this same round, and its launch specs are stripped from
        the solve — "Priority Matters" preemption folded into the packing
        objective instead of a post-cascade last resort. Gated with slice
        topology (the topology-aware packing objective); the last-resort
        path (_run_preemption) stays on regardless.

        Returns the (possibly stripped) solve and the gang names admitted
        via eviction. Every trial digest flows to the capsule, and both
        verdicts land in karpenter_tpu_preempt_or_launch_total + the
        decision log, so the choice replays and explains itself."""
        if not (
            self.settings.preemption_enabled
            and self.settings.slice_topology_enabled
            and admitted_gangs
        ):
            return solve, set()
        floor = self._priority_floor()
        if floor is None:
            return solve, set()
        node_zone = lambda name: (  # noqa: E731
            n.zone() if (n := self.cluster.nodes.get(name)) is not None else ""
        )
        digest_sink = cap.add_digest if cap is not None else None
        preempted: set = set()
        strip_idx: set = set()
        candidates = sorted(
            (g for g in admitted_gangs if g in gangs),
            key=lambda n: (-gangs[n].priority, n),
        )
        attempts = 0
        for gname in candidates:
            if attempts >= MAX_PREEMPTORS_PER_ROUND:
                break
            g = gangs[gname]
            unbound = [p for p in g.pods if p.node_name is None]
            if not unbound:
                continue
            g_round = Gang(
                name=gname, pods=unbound, min_members=g.min_members,
                priority=g.priority,
            )
            placement = gangmod.gang_placement(solve, g_round, node_zone)
            # only PURE fresh-node plans can be cancelled cleanly: shared
            # specs / existing reuse launch for other pods regardless, so
            # there is no launch cost to trade away
            if placement.unplaced or not placement.pure or placement.cost <= 0:
                continue
            if g.priority <= floor:
                continue  # nothing strictly below it to evict
            launch_cost = placement.cost
            attempts += 1
            # the trial must see existing capacity NET of this round's
            # still-unbound existing assignments: _apply_solve binds them
            # with no fit re-check AFTER this decision, so a trial claiming
            # the same free capacity would overcommit the node
            consumed: Dict[str, Resources] = {}
            for node_name, pod_names in solve.existing_assignments.items():
                reqs = [
                    q.requests + Resources(pods=1)
                    for n in pod_names
                    if (q := self.cluster.pods.get(n)) is not None
                ]
                if reqs:
                    consumed[node_name] = merge(reqs)
            base = []
            for e in self.cluster.existing_capacity():
                c = consumed.get(e.node.name)
                base.append(
                    e if c is None else ExistingNode(
                        node=e.node,
                        remaining=(e.remaining - c).clamp_min_zero(),
                        pods=e.pods,
                    )
                )
            self.preemption.base_existing = base
            try:
                plan = self.preemption.plan(
                    Preemptor(
                        name=gname, pods=unbound, priority=g.priority,
                        is_gang=True,
                    ),
                    digest_sink=digest_sink,
                )
            finally:
                self.preemption.base_existing = None
            if plan is None or plan.evict_cost() >= launch_cost - 1e-9:
                metrics.PREEMPT_OR_LAUNCH.inc({"verdict": "launch"})
                DECISIONS.record_coalesced(
                    "preemption", "preempt-or-launch-launch", pod=gname,
                    reason="fresh capacity undercuts eviction",
                    details={
                        "launch_cost": round(launch_cost, 5),
                        "evict_cost": (
                            round(plan.evict_cost(), 5) if plan is not None else None
                        ),
                    },
                )
                continue
            # validated against the SAME consumed-net base the trial solved
            # onto: the round's still-unbound existing assignments bind with
            # no fit re-check after this, so judging against raw cluster
            # capacity would miss exactly the overcommit class at stake
            if not self._trial_firewall(plan, g.pods, base_existing=base):
                continue  # invalid trial: keep the launch specs instead
            # eviction wins: execute, bind the trial, cancel the launches
            self.preemption.execute(plan)
            self._note_gang_evicted(plan)
            for victim in plan.victim_names:
                result.bound.pop(victim, None)
            self._apply_solve(plan.result, result, ())
            strip_idx.update(placement.pure_spec_idx)
            preempted.add(gname)
            self._gang_wait.pop(gname, None)
            metrics.PREEMPT_OR_LAUNCH.inc({"verdict": "evict"})
            metrics.GANG_VERDICTS.inc({"outcome": "admitted-preemption"})
            DECISIONS.record(
                "gang", "gang-admitted", pod=gname,
                reason="preempt-or-launch: eviction undercut fresh capacity",
                details={
                    "members": len(g.pods),
                    "victims": plan.victim_names,
                    "launch_cost": round(launch_cost, 5),
                    "evict_cost": round(plan.evict_cost(), 5),
                    "price_delta": plan.price_delta,
                },
            )
        if not strip_idx:
            return solve, preempted
        new_nodes = [
            spec for idx, spec in enumerate(solve.new_nodes)
            if idx not in strip_idx
        ]
        stripped = SolveResult(
            new_nodes=new_nodes,
            existing_assignments=dict(solve.existing_assignments),
            unschedulable=list(solve.unschedulable),
            cost=sum(s.option.price for s in new_nodes),
            stats=dict(solve.stats),
            problem_digest=solve.problem_digest,
        )
        return stripped, preempted

    def _run_preemption(
        self,
        result: ProvisioningResult,
        gangs: Dict[str, Gang],
        capacity_gangs: Dict[str, Gang],
        cap,
    ) -> set:
        """Displace lower-priority victims for the round's still-unplaced
        higher-priority demand, highest priority first, bounded per round.
        Gangs preempt WHOLE (their trial solve places every pending member or
        the plan is rejected) — a gang member never preempts as a singleton.
        Returns the names of gangs admitted via preemption."""
        floor = self._priority_floor()
        if floor is None:
            return set()  # nothing bound, nothing to evict
        launch_blocked = set(result.unschedulable)
        preemptors: List[Preemptor] = []
        # a gang preempts as a unit only when CAPACITY blocked it — the gate
        # deferred it with quorum met (capacity_gangs) or launches failed
        # after admission (members in unschedulable). A quorum-deferred gang
        # (members only in gang_deferred) must NEVER preempt: evicting
        # victims to bind a sub-quorum gang is the exact partial-placement
        # failure gang scheduling exists to prevent.
        for gname in sorted(gangs):
            g = gangs[gname]
            if gname not in capacity_gangs and not (g.member_names & launch_blocked):
                continue
            pending = [
                q for n in sorted(g.member_names)
                if (q := self.cluster.pods.get(n)) is not None and q.is_pending()
            ]
            alive = len(pending) + len(gangmod.bound_members(self.cluster, gname))
            if alive < g.min_members:
                continue  # belt-and-braces: below quorum, never preempt
            # preemptor priority is the gang's OWN: the restart boost is
            # victim-side protection only (an evicted gang empowered to
            # displace equal-priority peers would cycle — see
            # preemption.RESTART_BOOST)
            if pending and g.priority > floor:
                preemptors.append(
                    Preemptor(
                        name=gname, pods=pending, priority=g.priority,
                        is_gang=True,
                    )
                )
        gang_members = {n for g in gangs.values() for n in g.member_names}
        for name in sorted(set(result.unschedulable)):
            pod = self.cluster.pods.get(name)
            if (
                pod is not None and pod.is_pending()
                and name not in gang_members and pod.priority > floor
            ):
                preemptors.append(
                    Preemptor(name=name, pods=[pod], priority=pod.priority)
                )
        preemptors.sort(key=lambda p: (-p.priority, p.name))
        digest_sink = cap.add_digest if cap is not None else None
        preempted_gangs: set = set()
        for pre in preemptors[:MAX_PREEMPTORS_PER_ROUND]:
            plan = self.preemption.plan(pre, digest_sink=digest_sink)
            if plan is None:
                DECISIONS.record_coalesced(
                    "preemption", "infeasible", pod=pre.name,
                    reason="no eligible lower-priority victim set frees "
                           "enough compatible capacity",
                )
                continue
            if not self._trial_firewall(plan, pre.pods):
                continue  # invalid trial: the demand stays deferred
            self.preemption.execute(plan)
            self._note_gang_evicted(plan)
            # last-resort regime: no launch plan existed for this demand, so
            # the cost decision is eviction vs. nothing — counted separately
            # from the in-cascade priced verdicts
            metrics.PREEMPT_OR_LAUNCH.inc({"verdict": "evict-unpriced"})
            # victims bound EARLIER THIS RECONCILE (e.g. fresh serving churn
            # the cascade just placed) are Pending again: drop them from the
            # round's bound map so the result/capsule agrees with cluster
            # state and _finalize_gangs never mistakes a preempted victim
            # gang for a launch-failure partial placement
            for victim in plan.victim_names:
                result.bound.pop(victim, None)
            # the accepted trial IS the post-eviction placement: bind it
            self._apply_solve(plan.result, result, ())
            placed = {p.meta.name for p in pre.pods}
            result.unschedulable = [
                n for n in result.unschedulable if n not in placed
            ]
            result.gang_deferred = [
                n for n in result.gang_deferred if n not in placed
            ]
            if pre.is_gang:
                preempted_gangs.add(pre.name)
                self._gang_wait.pop(pre.name, None)
                metrics.GANG_VERDICTS.inc({"outcome": "admitted-preemption"})
                DECISIONS.record(
                    "gang", "gang-admitted", pod=pre.name,
                    reason="admitted after preemption",
                    details={
                        "members": len(pre.pods),
                        "victims": plan.victim_names,
                        "price_delta": plan.price_delta,
                    },
                )
        return preempted_gangs

    def _finalize_gangs(
        self,
        gangs: Dict[str, Gang],
        result: ProvisioningResult,
        admit_details: Dict[str, Dict],
        preempted_gangs: set,
    ) -> None:
        """End-of-round all-or-nothing enforcement. A gang some of whose
        members bound while others could not (a launch failure split a
        gate-admitted gang across specs) has its fresh bindings ROLLED BACK —
        the pods return to Pending through the eviction path (watch events
        keep the delta encoder's dirty set exact) and the gang defers whole.
        Gangs that bound completely get their ``gang-admitted`` verdict here,
        where "admitted" provably means "running"."""
        from .termination import evict_pod

        unsched = set(result.unschedulable)
        for name in sorted(gangs):
            g = gangs[name]
            members = g.member_names
            bound_now = sorted(n for n in members if n in result.bound)
            if not bound_now:
                if members & unsched:
                    # launches failed for the WHOLE gang (limits/ICE/cloud
                    # errors after the gate admitted it): nothing bound, but
                    # the gang must still explain itself as deferred — its
                    # members wait by design, they are not per-pod infeasible
                    result.unschedulable = [
                        n for n in result.unschedulable if n not in members
                    ]
                    for n in sorted(members):
                        if n not in result.gang_deferred:
                            result.gang_deferred.append(n)
                    self._note_gang_deferral(
                        g, "gang-deferred",
                        "launch failures blocked atomic placement",
                        {"members": len(g.pods)},
                    )
                continue
            still_pending = sorted(
                n for n in members
                if (q := self.cluster.pods.get(n)) is not None and q.is_pending()
            )
            if still_pending:
                for n in bound_now:
                    pod = self.cluster.pods.get(n)
                    if pod is not None and pod.node_name is not None:
                        # requeue_unowned: this is a rollback of a bind made
                        # THIS round, not an eviction — an unowned member is
                        # un-placed, never deleted (deleting it would leave
                        # the gang permanently below quorum)
                        evict_pod(
                            self.cluster, pod, self.recorder,
                            reason=f"gang {name} partial placement rolled back",
                            requeue_unowned=True,
                        )
                    result.bound.pop(n, None)
                result.unschedulable = [
                    n for n in result.unschedulable if n not in members
                ]
                for n in sorted(members):
                    if n not in result.gang_deferred:
                        result.gang_deferred.append(n)
                self._note_gang_deferral(
                    g, "gang-deferred",
                    "partial placement rolled back (launch failures)",
                    {"members": len(g.pods), "rolled_back": len(bound_now)},
                )
                continue
            if name in preempted_gangs:
                continue  # verdict already emitted by the preemption path
            metrics.GANG_VERDICTS.inc({"outcome": "admitted"})
            DECISIONS.record(
                "gang", "gang-admitted", pod=name,
                details=admit_details.get(name, {"members": len(g.pods)}),
            )
            self._gang_wait.pop(name, None)

    def _bind(self, pod_name: str, node_name: str) -> bool:
        """Bind a pod and synchronously retire it from the delta session's
        encoded set. The controller must not depend on watch delivery to
        learn about its OWN binds: cascade re-solves within one reconcile
        (gang/diversification strips, ICE retries) encode the shrunken batch
        immediately, and an async informer delivering the MODIFIED event a
        beat late would desync the session into a full-encode fallback.
        The later watch event collapses idempotently in pod_event.

        A pod DELETED between solve and bind (deploy scale-down racing the
        round — constant under soak churn) surfaces as a 404/KeyError from
        the bind: that pod simply no longer needs placing. Swallowing it
        keeps the round's REMAINING binds and launches; aborting the whole
        reconcile for one vanished pod cost every sibling its placement and
        a kit backoff (the chaos soak hit this as a reconcile-error storm)."""
        try:
            self.cluster.bind_pod(pod_name, node_name)
        except KeyError:
            LIFECYCLE.discard(pod_name)
            return False  # in-process store: pod gone
        except RuntimeError as e:
            if "404" in str(e):
                # HTTP-mode not-found; retire it from the session too — the
                # DELETED watch event may have been consumed pre-quiesce
                self._pending_seen.discard(pod_name)
                LIFECYCLE.discard(pod_name)
                return False
            raise
        pod = self.cluster.pods.get(pod_name)
        if pod is not None:
            self._intake.pod_event("DELETED", pod)
        self._pending_seen.discard(pod_name)
        return True

    def _apply_solve(
        self,
        solve: SolveResult,
        result: ProvisioningResult,
        round_provs: Sequence[Tuple[Provisioner, Sequence[InstanceType]]] = (),
    ) -> Tuple[set, set]:
        """Bind existing-node assignments and launch new nodes for one solve,
        honoring provisioner limits. Returns (provisioners whose limits
        blocked specs, pods whose launch failed with insufficient capacity) —
        the caller cascades to other pools / re-solves with the ICE mask.
        Every verdict lands in the decision audit log (utils/decisions.py)."""
        for node_name, pod_names in solve.existing_assignments.items():
            names = list(pod_names)
            bound_here = []
            for i, pod_name in enumerate(names):
                if self._bind(pod_name, node_name):
                    bound_here.append(pod_name)
                result.bound[pod_name] = node_name
                metrics.PODS_SCHEDULED.inc()
                DECISIONS.record(
                    "placement", "existing-node", pod=pod_name, node=node_name,
                    value=float(len(names)) if i == 0 else 0.0,
                )
            LIFECYCLE.complete_many(bound_here, node=node_name)

        # limits phase is serial: accounting is order-dependent
        usage: Dict[str, Resources] = {}
        launchable: List[NewNodeSpec] = []
        limit_hit: set = set()
        for spec in solve.new_nodes:
            prov = spec.option.provisioner
            if prov.limits is not None:
                used = usage.get(prov.name)
                if used is None:
                    used = self.cluster.provisioner_usage(prov.name)
                projected = used + spec.option.instance_type.capacity
                if projected.any_exceeds(prov.limits):
                    self.recorder.publish(
                        "LimitExceeded",
                        f"provisioner {prov.name} resource limits reached",
                        object_name=prov.name,
                        object_kind="Provisioner",
                        type="Warning",
                    )
                    limit_hit.add(prov.name)
                    result.unschedulable.extend(spec.pod_names)
                    DECISIONS.record(
                        "nomination", "limit-blocked",
                        reason=f"provisioner {prov.name} resource limits reached",
                        details={
                            "provisioner": prov.name,
                            "instance_type": spec.instance_type_name,
                            "pods": len(list(spec.pod_names)),
                        },
                    )
                    continue
                usage[prov.name] = projected
            launchable.append(spec)

        # launch phase: concurrent workers feed the provider's CreateFleet
        # batcher, so same-shape machines coalesce into one cloud call
        # (reference: parallel machine launches + createfleet.go batching)
        for spec in launchable:
            LIFECYCLE.mark_many(spec.pod_names, "launch_issued")
        outcomes = self._launch_all(launchable)
        ice_failed: set = set()
        # rejected_alternatives reads of a pod only its scheduling terms,
        # tolerations and requests, and walks every offering of every pool
        # of the round: a sharded round passes all its cells' pools, so one
        # call costs O(pools x offerings). Its answer is memoized for this
        # batch (the round's offerings are immutable) on what it reads, so
        # a round with many nodes of one pod shape walks the catalog once a
        # shape and chosen offering. The reference calls it per node; the
        # records are the same.
        from ..state.cells import pod_feas_key

        alternatives_memo: Dict[tuple, List[Dict[str, object]]] = {}
        penalty = getattr(self.solver, "risk_penalty", 0.0)

        def alternatives(pod: Pod, chosen) -> List[Dict[str, object]]:
            key = (pod_feas_key(pod), pod.requests, chosen.instance_type.name, chosen.zone,
                   chosen.capacity_type, chosen.price,
                   getattr(chosen, "interruption_probability", 0.0))
            hit = alternatives_memo.get(key)
            if hit is None:
                hit = alternatives_memo[key] = rejected_alternatives(
                    pod, chosen, round_provs, penalty=penalty)
            return [dict(entry) for entry in hit]

        for spec, outcome in zip(launchable, outcomes):
            prov = spec.option.provisioner
            if isinstance(outcome, InsufficientCapacityError):
                # offerings exhausted even after in-provider fallback: the ICE
                # cache masks them, and the caller re-solves this round so the
                # pods degrade to the next-cheapest offering (instance.go:
                # 400-406); past the retry budget they stay pending with the
                # mask applied next cycle
                ice_failed.update(spec.pod_names)
                result.unschedulable.extend(spec.pod_names)
                DECISIONS.record(
                    "nomination", "ice-failed", reason=str(outcome),
                    details={
                        "provisioner": prov.name,
                        "instance_type": spec.instance_type_name,
                        "zone": spec.option.zone,
                        "capacity_type": spec.option.capacity_type,
                        "pods": len(list(spec.pod_names)),
                    },
                )
                continue
            if isinstance(outcome, BaseException):
                # Any launch failure (cloud API outage, throttling, SDK error) is
                # retryable next cycle — it must not abort the rest of the batch.
                metrics.CLOUDPROVIDER_ERRORS.inc()
                self.recorder.publish(
                    "LaunchFailed", str(outcome), object_name=machineless_name(spec), type="Warning"
                )
                result.unschedulable.extend(spec.pod_names)
                DECISIONS.record(
                    "nomination", "launch-failed", reason=str(outcome),
                    details={
                        "provisioner": prov.name,
                        "instance_type": spec.instance_type_name,
                        "pods": len(list(spec.pod_names)),
                    },
                )
                continue
            machine, node = outcome
            result.machines.append(machine)
            result.nodes.append(node)
            metrics.NODES_CREATED.inc({"provisioner": prov.name})
            pods = list(spec.pod_names)
            LIFECYCLE.mark_many(pods, "node_ready")
            # one placement explanation per SPEC, shared by its pods: the
            # chosen offering plus the top-k rejected cheaper alternatives
            # with reject reasons — the "/debug/decisions?pod=" answer to
            # "why THIS instance type"
            details = {
                "instance_type": spec.option.instance_type.name,
                "zone": spec.option.zone,
                "capacity_type": spec.option.capacity_type,
                "price": round(spec.option.price, 5),
                "provisioner": prov.name,
                "machine": machine.name,
            }
            representative = self.cluster.pods.get(pods[0]) if pods else None
            if representative is not None and round_provs:
                details["rejected_alternatives"] = alternatives(representative, spec.option)
            DECISIONS.record(
                "nomination", "launched", node=node.name,
                details={**details, "pods": len(pods)},
            )
            bound_here = []
            for i, pod_name in enumerate(pods):
                if self._bind(pod_name, node.name):
                    bound_here.append(pod_name)
                result.bound[pod_name] = node.name
                metrics.PODS_SCHEDULED.inc()
                DECISIONS.record(
                    "placement", "new-node", pod=pod_name, node=node.name,
                    details=details,
                    value=float(len(pods)) if i == 0 else 0.0,
                )
            LIFECYCLE.complete_many(bound_here, node=node.name)
        return limit_hit, ice_failed

    def _launch(self, spec: NewNodeSpec, create_fn=None) -> Tuple[Machine, Node]:
        requests = merge([self._pod_requests(n) for n in spec.pod_names])
        return launch_from_spec(
            self.cluster, self.provider, spec, requests, create_fn=create_fn,
            retry_policy=self.retry_policy, machine_ids=self.machine_ids,
        )

    def _launch_all(self, specs: List[NewNodeSpec]) -> List[object]:
        """Launch every spec, returning (machine, node) or the exception per
        spec. Multiple specs launch on a worker pool through the provider's
        batched-create path when it has one; a single spec (or a provider
        without batching) launches inline."""
        if not specs:
            return []
        create_fn = getattr(self.provider, "create_batched", None)

        def one(spec: NewNodeSpec, fn=None) -> object:
            try:
                return self._launch(spec, create_fn=fn)
            except Exception as e:
                return e

        if len(specs) == 1 or create_fn is None:
            return [one(spec) for spec in specs]

        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(10, len(specs))) as pool:
            return list(pool.map(lambda s: one(s, create_fn), specs))

    def _pod_requests(self, pod_name: str) -> Resources:
        pod = self.cluster.pods.get(pod_name)
        return pod.requests if pod else Resources()


def _marginal_price(types_iter) -> float:
    """Cheapest AVAILABLE offering price in a cell's catalog — the cell's
    price summary the arbitration pass orders launches by (its crude dual:
    the marginal cost of one more unit of capacity in that cell)."""
    best = float("inf")
    for types in types_iter:
        for it in types:
            for o in it.offerings:
                if o.available and o.price < best:
                    best = o.price
    return best


def machineless_name(spec: NewNodeSpec) -> str:
    return f"{spec.option.provisioner.name}/{spec.instance_type_name}"


def rejected_alternatives(
    pod: Pod,
    chosen,
    round_provs: Sequence[Tuple[Provisioner, Sequence[InstanceType]]],
    k: int = 3,
    penalty: float = 0.0,
) -> List[Dict[str, object]]:
    """The audit log's "why not something cheaper" answer: the top-``k``
    offerings CHEAPER than the chosen one, each classified by reject reason —
    ``provisioner`` (the provisioner's own spec excludes the offering — it
    was never a launch candidate), ``requirements`` (pod scheduling terms
    can't land on that node surface), ``taints`` (untolerated provisioner
    taint), ``ice`` (masked by the insufficient-capacity cache), ``capacity``
    (the pod alone doesn't fit its allocatable), or ``packing`` (individually
    compatible AND cheaper, but the joint cost-minimizing solve still
    preferred the chosen mix). When
    nothing cheaper exists (the chosen offering was the floor) the next
    pricier offering is reported with reason ``price`` so a placement record
    always carries at least one alternative on any multi-offering catalog.

    Classification is a per-pod approximation of the encoder's compat row —
    deliberately cheap (one representative pod per node spec, label-surface
    checks only), because it runs on the provisioning hot path.

    ``penalty`` is the solver's risk penalty: cheaper/pricier is judged on
    the RISK-ADJUSTED price ``price + interruption_probability * penalty``
    the solve actually optimized, so a risky spot offering the solver priced
    out reports reason ``price`` (its effective price lost) instead of
    masquerading as a ``packing`` reject of a nominally-cheaper sticker."""
    terms = pod.scheduling_requirement_terms()
    tolerations = list(pod.tolerations)
    chosen_key = (chosen.instance_type.name, chosen.zone, chosen.capacity_type)
    chosen_eff = chosen.price + getattr(chosen, "interruption_probability", 0.0) * penalty
    cheaper: List[Tuple[float, Dict[str, object]]] = []
    # only the single cheapest pricier offering is ever reported (the
    # no-cheaper-exists fallback), so track a scalar min instead of
    # accumulating the whole catalog tail
    best_pricier: Optional[Tuple[float, Dict[str, object]]] = None
    for prov, types in round_provs:
        # the surface the pod's terms are matched against must include the
        # provisioner's own SPEC requirements, not just its labels — an
        # offering the spec excludes was never a launch candidate at all
        # (build_options would not have minted it) and must not be reported
        # as a solver choice
        prov_reqs = Requirements.from_labels(prov.labels).intersect(
            prov.requirements
        )
        # exclusion must mirror build_options, which intersects the
        # provisioner's REQUIREMENTS AND LABELS into every option — a zone
        # pinned via labels excludes other-zone offerings just as a spec
        # requirement does
        prov_zone = prov_reqs.get(wk.ZONE)
        prov_ct = prov_reqs.get(wk.CAPACITY_TYPE)
        taints_ok = tolerates_all(tolerations, tuple(prov.taints))
        for it in types:
            prov_compatible = it.requirements.compatible(prov_reqs)
            fits = pod.requests.fits(it.allocatable())
            for o in it.offerings:
                if (it.name, o.zone, o.capacity_type) == chosen_key:
                    continue
                o_eff = o.price + o.interruption_probability * penalty
                entry_prices: Dict[str, object] = {"price": round(o.price, 5)}
                if penalty:
                    entry_prices["effective_price"] = round(o_eff, 5)
                excluded = (
                    not prov_compatible
                    or not prov_zone.has(o.zone)
                    or not prov_ct.has(o.capacity_type)
                )
                if excluded:
                    if o_eff < chosen_eff:
                        cheaper.append((o_eff, {
                            "instance_type": it.name, "zone": o.zone,
                            "capacity_type": o.capacity_type,
                            **entry_prices,
                            "reason": "provisioner",
                        }))
                    continue
                if o_eff >= chosen_eff:
                    # pricier offerings need no compat analysis — "price" is
                    # the reject reason by definition (risk-adjusted when a
                    # penalty is in force: a risky spot sticker-bargain that
                    # effectively cost more LOST ON PRICE)
                    if best_pricier is None or o_eff < best_pricier[0]:
                        best_pricier = (o_eff, {
                            "instance_type": it.name, "zone": o.zone,
                            "capacity_type": o.capacity_type,
                            **entry_prices, "reason": "price",
                        })
                    continue
                if not o.available:
                    reason = "ice"
                elif not fits:
                    reason = "capacity"
                elif not taints_ok:
                    reason = "taints"
                else:
                    surface = it.requirements.add(
                        Requirement.in_values(wk.ZONE, [o.zone]),
                        Requirement.in_values(wk.CAPACITY_TYPE, [o.capacity_type]),
                    ).intersect(prov_reqs)
                    if not any(surface.compatible(term) for term in terms):
                        reason = "requirements"
                    else:
                        reason = "packing"
                cheaper.append((o_eff, {
                    "instance_type": it.name, "zone": o.zone,
                    "capacity_type": o.capacity_type,
                    **entry_prices, "reason": reason,
                }))
    cheaper.sort(key=lambda t: t[0])
    out = [entry for _, entry in cheaper[:k]]
    if not out and best_pricier is not None:
        out = [best_pricier[1]]
    return out


def launch_from_spec(
    cluster: Cluster,
    provider: CloudProvider,
    spec: NewNodeSpec,
    requests: Resources,
    create_fn=None,
    retry_policy: Optional[RetryPolicy] = None,
    machine_ids: Optional[MachineNameSeq] = None,
) -> Tuple[Machine, Node]:
    """Launch one machine for a solver node spec and register its node. Shared by
    the provisioning loop and consolidation replacements (which the reference also
    routes through CloudProvider.Create).

    ``retry_policy`` retries TRANSIENT create failures (TransientCloudError /
    retryable-flagged errors) in-round; insufficient capacity stays terminal —
    the ICE cache plus the in-provider fallback walk own that path."""
    option = spec.option
    prov = option.provisioner
    name = f"{prov.name}-{(machine_ids or _machine_ids).next()}"
    machine_reqs = [
        Requirement.in_values(wk.INSTANCE_TYPE, [option.instance_type.name]),
        Requirement.in_values(wk.ZONE, [option.zone]),
        Requirement.in_values(wk.CAPACITY_TYPE, [option.capacity_type]),
    ]
    if option.slice_pod:
        # slice-placed spec: the machine pins its ICI domain (and coordinate,
        # when the plan chose one) so the provider launches at exactly that
        # slice location and the node carries the matching labels
        from ..solver.topology import format_coord

        machine_reqs.append(Requirement.in_values(wk.SLICE_POD, [option.slice_pod]))
        if option.slice_coord is not None:
            machine_reqs.append(
                Requirement.in_values(
                    wk.SLICE_COORD, [format_coord(option.slice_coord)]
                )
            )
    machine = Machine(
        meta=ObjectMeta(name=name, labels=dict(prov.labels)),
        provisioner_name=prov.name,
        requirements=Requirements(machine_reqs),
        requests=requests,
        taints=list(prov.taints),
        kubelet=prov.kubelet,
        node_template_ref=prov.node_template_ref,
    )
    t0 = time.perf_counter()
    create = create_fn or provider.create
    if retry_policy is not None:
        machine = retry_policy.call(
            lambda: create(machine), service="provider", endpoint="create"
        )
    else:
        machine = create(machine)
    metrics.CLOUDPROVIDER_DURATION.observe(time.perf_counter() - t0, {"method": "create"})
    cluster.add_machine(machine)
    node = register_node(cluster, machine, prov)
    return machine, node


def register_node(cluster: Cluster, machine: Machine, provisioner: Provisioner) -> Node:
    """Machine -> Node registration (the kubelet's role in a real cluster; core's
    machine lifecycle launch->registration->initialization, SURVEY §2.2)."""
    node = Node(
        meta=ObjectMeta(
            name=machine.name,
            labels=dict(machine.meta.labels),
            finalizers=[wk.TERMINATION_FINALIZER],
        ),
        provider_id=machine.status.provider_id,
        capacity=machine.status.capacity,
        allocatable=machine.status.allocatable,
        taints=list(machine.taints) + list(provisioner.startup_taints),
        ready=True,
        machine_name=machine.name,
    )
    machine.status.registered = True
    machine.status.initialized = True
    # announce the status transition: against the apiserver-backed cluster
    # (HTTPCluster) this PUTs the machine so the authoritative store and
    # other watchers see registered/initialized flip — in-process it is a
    # version bump on the shared object (reference: the machine lifecycle
    # controller patches Machine status through the apiserver)
    cluster.update(machine)
    cluster.add_node(node)
    return node
