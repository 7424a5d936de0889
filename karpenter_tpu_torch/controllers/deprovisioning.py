"""Deprovisioning orchestrator: expiration -> drift -> emptiness -> consolidation.

Rebuild of core's deprovisioning controller (reference behavior spec:
``designs/deprovisioning.md:3-37``, ``designs/consolidation.md``,
``website/.../concepts/deprovisioning.md:64-95``):

* a single orchestrator runs the deprovisioners in order and takes ONE action per
  loop (empty nodes delete in parallel as one action);
* consolidation ranks candidates by disruption cost (fewer pods, pod deletion
  cost, priority, remaining node lifetime — ``consolidation.md:25-36``);
* delete is allowed when every pod re-schedules onto remaining capacity; replace
  additionally allows ONE cheaper new node; **spot nodes are delete-only, never
  replaced** (``deprovisioning.md:83-85``);
* every action passes a validation TTL (15s, ``consolidation.md:59-67``): the plan
  is re-verified after the window and dropped if the cluster moved;
* blockers: do-not-evict pods, controllerless pods, violated PDBs, the node-level
  do-not-consolidate annotation (``consolidation.md:44-52``).

The consolidation feasibility check reuses the SAME solver as provisioning — the
multi-node repack is just ``solve`` with the candidate's pods as pending demand,
the surviving nodes as existing capacity, and (for replace) the price-bounded
option set. That solve is the second half of the BASELINE north star.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..api import labels as wk
from ..api.objects import Node, Pod, Provisioner
from ..api.resources import Resources, merge
from ..api.settings import Settings
from ..cloudprovider.interface import CloudProvider
from ..cloudprovider.types import InstanceType, Offering
from ..solver.encode import ExistingNode
from ..solver.solver import GreedySolver, Solver, TorchSolver
from ..state.cluster import Cluster
from ..utils import metrics
from ..utils.cache import Clock
from ..utils.decisions import DECISIONS
from ..utils.events import Recorder
from .provisioning import launch_from_spec
from .termination import TerminationController


@dataclass
class PlannedAction:
    reason: str  # expiration | drift | emptiness | consolidation-delete | consolidation-replace
    nodes: List[str]
    replacements: List[object] = field(default_factory=list)  # NewNodeSpec list
    created: float = 0.0
    savings: float = 0.0  # $/hr reclaimed (consolidation actions)
    # gang-whole consolidation (slice-topology subsystem): members of the
    # candidate node's gangs that sit on OTHER nodes — evicted at execute
    # time so the whole gang re-enters Pending together and the provisioning
    # gang gate re-places it atomically (all-or-nothing + rollback). Empty
    # for every non-gang action (legacy wire/replay identity unchanged).
    evict_pods: List[str] = field(default_factory=list)
    #: the gangs this action moves whole (audit/decision detail)
    gangs: List[str] = field(default_factory=list)

    @property
    def replacement(self) -> Optional[object]:
        return self.replacements[0] if self.replacements else None


class DeprovisioningController:
    def __init__(
        self,
        cluster: Cluster,
        provider: CloudProvider,
        termination: TerminationController,
        solver: Optional[Solver] = None,
        settings: Optional[Settings] = None,
        recorder: Optional[Recorder] = None,
        clock: Optional[Clock] = None,
        quality_budget_s: float = 2.0,
        quality_min_pods: int = 500,
    ):
        self.cluster = cluster
        self.provider = provider
        self.termination = termination
        self.solver = solver or GreedySolver()
        self.settings = settings or Settings()
        self.recorder = recorder or Recorder()
        self.clock = clock or Clock()
        # cost-ledger hook (operator wiring): every EXECUTED action reports
        # its $/hr savings so consolidation ROI is a realized stream
        self.costs = None
        # risk-priced objective: consolidation what-ifs must price spot risk
        # the same way provisioning does, or the sweep would "save" money by
        # repacking onto pools the next solve refuses
        if self.settings.spot_enabled:
            self.solver.risk_penalty = self.settings.interruption_penalty_cost
        from ..utils.resilience import retry_policy_from_settings

        # replacement launches retry transient failures like provisioning does
        self.retry_policy = retry_policy_from_settings(self.settings)
        # Quality-budget sweep solver: consolidation is not latency-critical
        # (15s validation TTL, out-of-band cadence), so LARGE repack
        # simulations get a quality-mode TorchSolver — the kernel chain runs
        # beside the host competitor under a generous budget and the cheaper
        # validated plan wins. Small candidate sims keep the latency-tuned
        # solver (its tiny gate skips the device).
        #
        # Differs from the reference: the quality solver is built on the
        # caller's device and takes no mesh and no quality_sync. The
        # multi-device tier is not ported, and a TorchSolver loads its kernel
        # library in __init__, so it has nothing to warm in the background.
        self.quality_min_pods = quality_min_pods
        self.quality_solver: Optional[Solver] = None
        if quality_budget_s > 1.0 and isinstance(self.solver, TorchSolver):
            self.quality_solver = TorchSolver(
                portfolio=self.solver.portfolio,
                seed=self.solver.seed,
                latency_budget_s=quality_budget_s,
                warmup_spike_s=self.solver.warmup_spike_s,
                quality_race=True,
                dispatch_timeout_s=self.solver.dispatch_timeout_s,
                device=self.solver.device,
            )
            self.quality_solver._stager.enabled = self.solver._stager.enabled
            self.quality_solver._stager.capacity_bytes = self.solver._stager.capacity_bytes
            self.quality_solver.risk_penalty = self.solver.risk_penalty
        # sweep solves attributed by winning backend (observability for the
        # "which engine answered" question; surfaced by the benchmark).
        # Guarded by _counts_lock: parallel sweep workers report here.
        self.sweep_backend_counts: Dict[str, int] = {}
        self._counts_lock = threading.Lock()
        # Parallel single-node sweep: the per-candidate
        # what-if simulations are independent reads of one snapshot, so they
        # fan out across a bounded worker pool (parallel/hostpool.py) with
        # per-worker solver clones — encode serializes on ENCODE_LOCK, the
        # LP/numpy solve releases the GIL. first_hit() preserves the serial
        # sweep's chosen action exactly (lowest-index hit wins).
        from ..parallel.hostpool import default_workers

        self.sweep_workers = default_workers(self.settings.consolidation_sweep_workers)
        self._worker_solvers: Optional[List[tuple]] = None  # lazy clones
        self.pending_action: Optional[PlannedAction] = None
        # gang-aware sweep state (reset per _consolidatable pass): nodes
        # hosting movable gangs (single-node sweep only — the multi-node
        # prefix search keeps its bounded non-gang scope) and the per-gang
        # movability memo (bound_members + PDB vets are O(cluster pods))
        self._gang_hosts: set = set()
        self._gang_movable_memo: Optional[Dict[str, Optional[tuple]]] = None
        # machine-name sequence override (replay harness; None = global)
        self.machine_ids = None
        # flight-recorder round state (set per reconcile pass)
        self._capsule = None
        self._planned_this_round: Optional[PlannedAction] = None
        # sweep-scoped existing-capacity snapshot (see _consolidation)
        self._sweep_capacity = None
        # sweep-scoped bound-pod and daemonset views from the same snapshot:
        # the serial sweep re-scanned the whole pod map once per candidate
        self._sweep_pods: Optional[Dict[str, list]] = None
        self._sweep_daemonsets: Optional[list] = None
        # Stabilization window (designs/consolidation.md:59-67): consolidation
        # waits until the node population has been quiet for the whole window.
        self._last_node_change = float("-inf")
        cluster.watch(self._on_event)

    def _on_event(self, event: str, obj) -> None:
        if isinstance(obj, Node) and event in ("ADDED", "DELETED"):
            self._last_node_change = self.clock.now()

    # ------------------------------------------------------------------
    def reconcile(self) -> Optional[PlannedAction]:
        """One orchestrator pass. Returns the action executed this pass (if
        any). Noteworthy passes — an action executed, a plan parked for the
        validation TTL, or a matured plan aborted — commit a flight-recorder
        capsule whose inputs were captured BEFORE execution mutated the
        cluster, so the pass replays offline (``karpenter_tpu_torch/replay.py``)."""
        from ..utils.flightrecorder import FLIGHT

        cap = FLIGHT.begin("deprovisioning")
        self._capsule = cap
        self._planned_this_round = None
        # quiesce for the whole pass (see provisioning.reconcile): remote
        # watch events applying between the capsule's pre-execution capture
        # and the sweep's cluster reads would break offline replay
        try:
            with self.cluster.quiesce():
                action = self._reconcile()
                if cap is not None and cap.captured:
                    cap.set_outputs_action(action, planned=self._planned_this_round)
        except BaseException as e:
            # finish() must ALWAYS run (it releases the builder's thread-
            # local decision tee), whatever escapes the pass
            if cap is not None:
                cap.finish(error=e)
            raise
        finally:
            self._capsule = None
        if cap is not None:
            cap.finish()
        return action

    def _capture_round_input(self, had_pending: Optional[PlannedAction] = None) -> None:
        """Capture the capsule input at the decision point (idle sweeps never
        pay for a snapshot): the cluster as the planner saw it, per-
        provisioner instance types, the pinned clock, and the stabilization
        state replay needs to reproduce the window check."""
        cap = self._capsule
        if cap is None or cap.captured:
            return
        from ..utils.flightrecorder import action_to_wire

        now = self.clock.now()
        window = self.settings.stabilization_window
        remaining = (
            max(0.0, window - (now - self._last_node_change)) if window > 0 else 0.0
        )
        cap.capture_inputs(
            cluster=self.cluster,
            provisioner_types=[
                (p, self.provider.get_instance_types(p))
                for p in self.cluster.provisioners.values()
            ],
            settings=self.settings,
            provider=self.provider,
            solver=self.solver,
            clock_now=now,
            extra={
                "stabilization_remaining": remaining,
                "had_pending_action": action_to_wire(had_pending),
            },
        )

    def _reconcile(self) -> Optional[PlannedAction]:
        if self.pending_action is not None:
            return self._maybe_execute_pending()

        for method in (self._expiration, self._drift, self._emptiness, self._consolidation):
            action = method()
            if action is not None:
                self._capture_round_input()
                action.created = self.clock.now()
                if self.settings.consolidation_validation_ttl > 0 and action.reason.startswith(
                    "consolidation"
                ):
                    # plan now, validate after the TTL window (15s semantics)
                    self.pending_action = action
                    self._planned_this_round = action
                    self.recorder.publish(
                        "DeprovisioningPlanned", f"{action.reason}: {action.nodes}",
                        object_kind="Deprovisioner",
                    )
                    DECISIONS.record(
                        "consolidation", "planned", reason=action.reason,
                        node=action.nodes[0] if action.nodes else "",
                        details={"nodes": list(action.nodes),
                                 "savings": round(action.savings, 5)},
                    )
                    return None
                self._execute(action)
                return action
        return None

    def _maybe_execute_pending(self) -> Optional[PlannedAction]:
        action = self.pending_action
        if self.clock.now() - action.created < self.settings.consolidation_validation_ttl:
            return None  # still inside the validation window
        self.pending_action = None
        # matured plan: capture the pre-validation cluster — both the abort
        # and the execute verdict are worth replaying
        self._capture_round_input(had_pending=action)
        if not self._still_valid(action):
            self.recorder.publish(
                "DeprovisioningAborted", f"{action.reason} invalidated during validation window",
                object_kind="Deprovisioner", type="Warning",
            )
            DECISIONS.record(
                "consolidation", "aborted", reason=action.reason,
                node=action.nodes[0] if action.nodes else "",
                details={"nodes": list(action.nodes),
                         "blocked_by": "cluster moved during validation window"},
            )
            return None
        self._execute(action)
        return action

    # -- deprovisioners, in orchestrator order --------------------------
    def _candidates(self) -> List[Node]:
        out = []
        for node in self.cluster.managed_nodes():
            if node.meta.deletion_timestamp is not None or not node.ready:
                continue
            out.append(node)
        return out

    def _expiration(self) -> Optional[PlannedAction]:
        now = self.clock.now()
        for node in self._candidates():
            prov = self._provisioner_of(node)
            if prov is None or prov.ttl_seconds_until_expired is None:
                continue
            if now - node.meta.creation_timestamp > prov.ttl_seconds_until_expired:
                action = self._replace_action("expiration", node)
                if action is not None:
                    return action
        return None

    def _drift(self) -> Optional[PlannedAction]:
        if not self.settings.drift_enabled:
            return None
        for node in self._candidates():
            if node.meta.annotations.get(wk.VOLUNTARY_DISRUPTION_ANNOTATION) == "drifted":
                action = self._replace_action("drift", node)
                if action is not None:
                    return action
        return None

    def _replace_action(self, reason: str, node: Node) -> Optional[PlannedAction]:
        """Drift/expiration action: provision replacement capacity BEFORE the node
        drains (the reference launches replacement nodes for drifted/expired nodes
        before terminating) — no price ceiling, as many new nodes as the workload
        needs. If the pods cannot be rescheduled at all, defer rather than strand."""
        pods = [p for p in self.cluster.pods_on_node(node.name) if not p.is_daemonset]
        if not pods:
            return PlannedAction(reason=reason, nodes=[node.name])
        # Don't pre-launch paid capacity for a drain that can never complete:
        # PDB-blocked or do-not-evict pods defer the action instead.
        for pod in pods:
            if pod.meta.annotations.get(wk.DO_NOT_EVICT_ANNOTATION) == "true":
                return None
            if self.termination._pdb_blocks(pod):
                return None
        fits, replacements = self._simulate(
            pods, exclude=[node.name], price_ceiling=None, max_new=None
        )
        if not fits:
            self.recorder.publish(
                "DeprovisioningBlocked", f"{reason}: pods cannot be rescheduled",
                object_name=node.name, object_kind="Node", type="Warning",
            )
            return None
        return PlannedAction(reason=reason, nodes=[node.name], replacements=replacements)

    def _emptiness(self) -> Optional[PlannedAction]:
        """ttlSecondsAfterEmpty: stamp empty nodes, delete the ones past TTL —
        all together, as one parallel action (deprovisioning.md:27-33)."""
        now = self.clock.now()
        expired: List[str] = []
        for node in self._candidates():
            prov = self._provisioner_of(node)
            if prov is None or prov.ttl_seconds_after_empty is None:
                continue
            workload = [
                p for p in self.cluster.pods_on_node(node.name) if not p.is_daemonset
            ]
            stamp = node.meta.annotations.get(wk.EMPTINESS_TIMESTAMP_ANNOTATION)
            if workload:
                if stamp is not None:
                    del node.meta.annotations[wk.EMPTINESS_TIMESTAMP_ANNOTATION]
                    self.cluster.update(node)
                continue
            if stamp is None:
                node.meta.annotations[wk.EMPTINESS_TIMESTAMP_ANNOTATION] = str(now)
                self.cluster.update(node)
                continue
            if now - float(stamp) >= prov.ttl_seconds_after_empty:
                expired.append(node.name)
        if expired:
            return PlannedAction(reason="emptiness", nodes=expired)
        return None

    # -- consolidation ---------------------------------------------------
    def _consolidation(self) -> Optional[PlannedAction]:
        if self.cluster.pending_pods():
            # cluster still provisioning; wait for stability. Coalesced: this
            # verdict repeats every pass and must not flood the ring.
            DECISIONS.record_coalesced(
                "consolidation", "deferred", reason="pending-pods",
            )
            return None
        if (
            self.settings.stabilization_window > 0
            and self.clock.now() - self._last_node_change < self.settings.stabilization_window
        ):
            # node population still settling (consolidation.md:59-67)
            DECISIONS.record_coalesced(
                "consolidation", "deferred", reason="stabilization-window",
                details={"window_s": self.settings.stabilization_window},
            )
            return None
        candidates = self._consolidatable()
        if not candidates:
            return None
        candidates.sort(key=self._disruption_cost)
        # The whole sweep is a READ-ONLY what-if over one cluster snapshot
        # (the chosen action executes after), so the existing-capacity view is
        # computed once here instead of once per candidate simulation —
        # rebuilding it was the dominant cost of a 200-node sweep. The bound-
        # pod view rides the same snapshot (ExistingNode.pods already excludes
        # daemonsets, matching the per-candidate filter).
        self._sweep_capacity = self.cluster.existing_capacity()
        self._sweep_pods = {e.node.name: list(e.pods) for e in self._sweep_capacity}
        self._sweep_daemonsets = self.cluster.daemonsets()
        try:
            # multi-node first (2..N cheapest-to-disrupt prefix), then single
            # — gang-hosting nodes only join the single-node sweep, where
            # the whole-gang move semantics are defined
            multi = self._try_multi_node(
                [n for n in candidates if n.name not in self._gang_hosts]
            )
            if multi is not None:
                return multi
            action = self._single_node_sweep(candidates)
            if action is None:
                # the whole sweep declined: the "why didn't consolidation
                # fire" answer is "every candidate's pods need pricier-or-
                # equal capacity elsewhere" (coalesced — repeats per pass)
                DECISIONS.record_coalesced(
                    "consolidation", "no-action", reason="no-cheaper-fit",
                    details={"candidates": len(candidates)},
                )
            return action
        finally:
            self._sweep_capacity = None
            self._sweep_pods = None
            self._sweep_daemonsets = None

    def _single_node_sweep(self, candidates: List[Node]) -> Optional[PlannedAction]:
        """Per-candidate simulations across the worker pool; identical chosen
        action to the serial scan (first_hit returns the lowest-index hit)."""
        from ..parallel.hostpool import first_hit

        # Prime the encoder's full-roster requirement table HERE, after the
        # multi-node prefix search: every single-node simulation's roster is
        # the snapshot minus its candidate, so each sim DERIVES its table by
        # column deletion instead of rebuilding it. Priming before the
        # multi-node pass would be wasted — its k>=2-exclusion rosters can't
        # derive and would overwrite the base with an underivable one.
        from ..solver.encode import ENCODE_LOCK, _get_surface_table, _node_surface

        with ENCODE_LOCK:
            _get_surface_table([_node_surface(e.node) for e in self._sweep_capacity])

        workers = min(self.sweep_workers, len(candidates))
        solvers = self._sweep_solver_pool(workers) if workers > 1 else None
        if solvers is None:
            workers = 1
        mode = "parallel" if workers > 1 else "serial"
        t0 = time.monotonic()

        def try_one(i: int, node: Node) -> Optional[PlannedAction]:
            metrics.CONSOLIDATION_SWEEP_CANDIDATES.inc({"mode": mode})
            pair = solvers[i % workers] if solvers is not None else None
            return self._try_single_node(node, solvers=pair)

        _, action = first_hit(try_one, candidates, workers)
        metrics.CONSOLIDATION_SWEEP.observe(time.monotonic() - t0)
        return action

    def _sweep_solver_pool(self, workers: int) -> Optional[List[tuple]]:
        """Per-worker (solver, quality_solver) clones — solve_pods is
        single-threaded per Solver instance (intern slots, device caches), so
        concurrent simulations each need their own. None when the configured
        solver can't be cloned (custom injected solver): sweep stays serial."""
        cached = self._worker_solvers
        if cached is not None and len(cached) >= workers:
            return cached[:workers]
        # Differs from the reference, which catches every Exception here:
        # only a solver that cannot be constructed this way (a TypeError)
        # leaves the sweep serial, so a CUDA error raises out of reconcile()
        try:
            pool = [
                (self._clone_solver(self.solver), self._clone_solver(self.quality_solver))
                for _ in range(workers)
            ]
        except TypeError:
            return None
        self._worker_solvers = pool
        return pool

    @staticmethod
    def _clone_solver(s: Optional[Solver]) -> Optional[Solver]:
        if s is None:
            return None
        if isinstance(s, TorchSolver):
            # Differs from the reference: the clone is built on the solver's
            # own device (a CPU solver's clones stay on the CPU, a card
            # solver's on the card) and takes no mesh and no quality_sync
            clone = TorchSolver(
                portfolio=s.portfolio,
                seed=s.seed,
                max_slots=s.max_slots,
                latency_budget_s=s.latency_budget_s,
                warmup_spike_s=s.warmup_spike_s,
                quality_race=s.quality_race,
                dispatch_timeout_s=s.dispatch_timeout_s,
                device=s.device,
            )
            clone._stager.enabled = s._stager.enabled
            clone._stager.capacity_bytes = s._stager.capacity_bytes
        elif isinstance(s, GreedySolver):
            clone = GreedySolver()
        else:
            clone = type(s)()  # a solver type with a zero-arg constructor
        # risk-priced objective must agree across workers, or a parallel
        # sweep's sims would diverge from the serial action on spot catalogs
        clone.risk_penalty = s.risk_penalty
        return clone

    def _gang_movable(self, group: str) -> Optional[Tuple[str, str]]:
        """Can gang ``group`` be moved WHOLE by a sweep? Returns None when
        yes, else (blocking pod, reason). Every bound member — wherever it
        sits — must be owned, evictable, PDB-clear, and on a MANAGED node
        (a member on capacity we don't control can never be re-placed by our
        gang gate, so the gang is not ours to move). Memoized per pass."""
        memo = self._gang_movable_memo
        if memo is not None and group in memo:
            return memo[group]
        from ..solver import gang as gangmod
        from .termination import pdb_blocks

        managed = {n.name for n in self.cluster.managed_nodes()}
        blocker: Optional[Tuple[str, str]] = None
        members = gangmod.bound_members(self.cluster, group)
        # CUMULATIVE PDB accounting (the preemption planner's discipline):
        # the move evicts every member together, so each member's check
        # counts the gang's earlier members as already-disrupted — a PDB
        # every member clears alone must not be blown by the whole move
        planned: set = set()
        for m in members:
            if m.meta.annotations.get(wk.DO_NOT_EVICT_ANNOTATION) == "true":
                blocker = (m.name, "gang member carries do-not-evict")
                break
            if not m.owned():
                blocker = (m.name, "controllerless gang member cannot be recreated")
                break
            if m.node_name not in managed:
                blocker = (m.name, "gang member on unmanaged node")
                break
            if pdb_blocks(self.cluster, m, planned=planned):
                blocker = (m.name, "gang member pod disruption budget violated")
                break
            planned.add(m.meta.name)
        if memo is not None:
            memo[group] = blocker
        return blocker

    @property
    def _gang_moves_enabled(self) -> bool:
        """Gang-whole consolidation rides the slice-topology subsystem
        switch: with it off, gang-hosting nodes stay fenced off (a cost
        sweep must never split an atomic group, and
        moving one whole needs the topology-aware gate to re-place it
        well)."""
        return (
            self.settings.gang_scheduling_enabled
            and self.settings.slice_topology_enabled
        )

    def _consolidatable(self) -> List[Node]:
        out = []
        self._gang_hosts = set()
        self._gang_movable_memo = {}
        for node in self._candidates():
            prov = self._provisioner_of(node)
            if prov is None or not prov.consolidation_enabled:
                continue
            if node.meta.annotations.get(wk.DO_NOT_CONSOLIDATE_ANNOTATION) == "true":
                continue
            pods = [p for p in self.cluster.pods_on_node(node.name) if not p.is_daemonset]
            blocker = None  # (blocking pod, reason) — the audit log's answer
            hosts_gang = False
            for pod in pods:
                if pod.meta.annotations.get(wk.DO_NOT_EVICT_ANNOTATION) == "true":
                    blocker = (pod.name, "do-not-evict annotation")
                    break
                if not pod.owned():
                    blocker = (pod.name, "controllerless pod cannot be recreated")
                    break
                if self.settings.gang_scheduling_enabled and (g := pod.pod_group()):
                    if not self._gang_moves_enabled:
                        # conservative: consolidation re-places pods
                        # one at a time, which would transiently drop a gang
                        # below quorum — an atomic pod group moves only via
                        # preemption (whole) or its own controller
                        blocker = (pod.name, "gang member (atomic pod group)")
                        break
                    # gang-aware sweep: the node is a candidate iff every
                    # hosted gang can move WHOLE (all members, cluster-wide)
                    hosts_gang = True
                    blocker = self._gang_movable(g)
                    if blocker is not None:
                        break
                    continue  # the whole-gang vet covers this pod's checks
                if self.termination._pdb_blocks(pod):
                    blocker = (pod.name, "pod disruption budget violated")
                    break
            if blocker is None:
                if hosts_gang:
                    self._gang_hosts.add(node.name)
                out.append(node)
            else:
                # coalesced: the same blocker repeats every pass until the
                # pod moves — one ring entry with a bumped count
                DECISIONS.record_coalesced(
                    "consolidation", "blocked", node=node.name,
                    pod=blocker[0], reason=blocker[1],
                )
        return out

    def _disruption_cost(self, node: Node) -> float:
        """consolidation.md:25-36 ranking: fewer pods first, then pod-deletion
        cost, pod priority, and sooner-to-expire nodes first. A gang-hosting
        node's cost also counts the CROSS-NODE members its move would evict
        — whole-gang moves disrupt more than the node's own pod count
        shows, so plain nodes are tried first."""
        pods = [p for p in self.cluster.pods_on_node(node.name) if not p.is_daemonset]
        cost = float(len(pods))
        if node.name in self._gang_hosts:
            _, remote, _ = self._gang_movers(node.name, pods)
            cost += float(len(remote))
        cost += sum(max(p.deletion_cost(), 0.0) for p in pods) / 1000.0
        cost += sum(max(p.priority, 0) for p in pods) / 1e6
        prov = self._provisioner_of(node)
        if prov is not None and prov.ttl_seconds_until_expired:
            age = self.clock.now() - node.meta.creation_timestamp
            remaining = max(prov.ttl_seconds_until_expired - age, 0.0)
            cost *= remaining / prov.ttl_seconds_until_expired
        return cost

    def _gang_movers(self, node_name: str, pods: Sequence[Pod]):
        """Whole-gang move set for a candidate node: (movers, remote_names,
        gang_names). ``movers`` is the node's own workload plus every OTHER
        node's members of the gangs it hosts — the set one simulation must
        re-place together for the move to be atomic; ``remote_names`` are the
        cross-node members the action evicts at execute time."""
        groups = sorted({g for p in pods if (g := p.pod_group())})
        if not groups:
            return list(pods), [], []
        from ..solver import gang as gangmod

        here = {p.meta.name for p in pods}
        movers = list(pods)
        remote: List[str] = []
        for g in groups:
            for m in gangmod.bound_members(self.cluster, g):
                if m.meta.name not in here:
                    movers.append(m)
                    remote.append(m.meta.name)
        return movers, remote, groups


    def _try_single_node(self, node: Node, solvers: Optional[tuple] = None):
        if self._sweep_pods is not None:
            pods = self._sweep_pods.get(node.name, [])
        else:
            pods = [p for p in self.cluster.pods_on_node(node.name) if not p.is_daemonset]
        if not pods:
            return PlannedAction(
                reason="consolidation-delete", nodes=[node.name],
                savings=self._node_price(node),
            )
        price = self._node_price(node)
        remote: List[str] = []
        gangs: List[str] = []
        movers: Sequence[Pod] = pods
        if node.name in self._gang_hosts:
            # gang-whole move: the simulation re-places the node's pods AND
            # the hosted gangs' cross-node members together, against the
            # fleet with those members' requests freed — one replacement
            # plan for the whole gang, never a partial placement
            movers, remote, gangs = self._gang_movers(node.name, pods)
        fits, replacements = self._simulate(
            movers, exclude=[node.name], price_ceiling=price, solvers=solvers,
            freed=remote,
        )
        if not fits:
            return None
        if not replacements:
            return PlannedAction(
                reason="consolidation-delete", nodes=[node.name], savings=price,
                evict_pods=remote, gangs=gangs,
            )
        # replacement required: spot nodes are delete-only (deprovisioning.md:83-85)
        if node.capacity_type() == wk.CAPACITY_TYPE_SPOT:
            return None
        return PlannedAction(
            reason="consolidation-replace", nodes=[node.name],
            replacements=replacements,
            savings=price - sum(r.option.price for r in replacements),
            evict_pods=remote, gangs=gangs,
        )

    def _try_multi_node(self, candidates: List[Node]):
        """Delete a subset of the cheapest-to-disrupt nodes together, allowing one
        cheaper replacement (designs/deprovisioning.md one-cheaper-replacement).
        Every prefix size is evaluated and the MAX-SAVINGS feasible subset wins —
        not the first feasible one. Spot nodes may be deleted in a subset; they
        only rule out the replacement variant (deprovisioning.md:83-85).

        The sweep is DEADLINE-BOUNDED (settings.consolidation_timeout): each
        prefix is a full reschedule simulation, so on a large fleet the search
        degrades to fewer (largest-first) subsets instead of stalling the
        deprovisioning loop; truncation is counted and the sweep duration
        observed in karpenter_tpu_consolidation_sweep_seconds."""
        best = None
        t0 = time.monotonic()
        deadline = t0 + self.settings.consolidation_timeout
        # Subset cap: the reference bounds the search to a small heuristic
        # subset because every prefix is a full scheduler re-simulation and
        # its packer is single-threaded greedy (designs/consolidation.md).
        # With a quality-budget solver present, fleet-scale simulations are
        # what the solver is FOR — the sweep evaluates every prefix down from
        # the whole candidate list (largest first, deadline-bounded), finding
        # one big repack action where the reference needs many small ones.
        cap = 25 if self.quality_solver is None else len(candidates)
        for k in range(min(len(candidates), cap), 1, -1):
            if time.monotonic() >= deadline:
                metrics.CONSOLIDATION_SWEEP_TRUNCATED.inc()
                DECISIONS.record_coalesced(
                    "consolidation", "truncated",
                    reason="consolidation-timeout budget exhausted",
                    details={"budget_s": self.settings.consolidation_timeout,
                             "remaining_prefixes": k - 1},
                )
                break
            action = self._evaluate_subset(candidates[:k])
            if action is None:
                continue
            if best is None or action.savings > best.savings + 1e-9:
                best = action
        metrics.CONSOLIDATION_SWEEP.observe(time.monotonic() - t0)
        return best

    def _evaluate_subset(self, subset: List[Node]) -> Optional[PlannedAction]:
        pods = [
            p
            for n in subset
            for p in self.cluster.pods_on_node(n.name)
            if not p.is_daemonset
        ]
        total_price = sum(self._node_price(n) for n in subset)
        fits, replacements = self._simulate(
            pods, exclude=[n.name for n in subset], price_ceiling=total_price
        )
        has_spot = any(n.capacity_type() == wk.CAPACITY_TYPE_SPOT for n in subset)
        if has_spot and (not fits or replacements):
            # Spot nodes are delete-only: a subset that needs replacement (or is
            # infeasible because of its spot members' pods) retries without them
            # — spot-free subsets are not prefixes, so this is a distinct search.
            subset = [n for n in subset if n.capacity_type() != wk.CAPACITY_TYPE_SPOT]
            if len(subset) < 2:
                return None
            pods = [
                p
                for n in subset
                for p in self.cluster.pods_on_node(n.name)
                if not p.is_daemonset
            ]
            total_price = sum(self._node_price(n) for n in subset)
            fits, replacements = self._simulate(
                pods, exclude=[n.name for n in subset], price_ceiling=total_price
            )
        if not fits:
            return None
        savings = total_price - sum(r.option.price for r in replacements)
        if savings <= 1e-9:
            return None
        return PlannedAction(
            reason="consolidation-replace" if replacements else "consolidation-delete",
            nodes=[n.name for n in subset],
            replacements=replacements,
            savings=savings,
        )

    def _simulate(
        self,
        pods: Sequence[Pod],
        exclude: Sequence[str],
        price_ceiling: Optional[float] = None,
        max_new: Optional[int] = 1,
        solvers: Optional[tuple] = None,
        freed: Sequence[str] = (),
    ) -> Tuple[bool, List[object]]:
        """Re-schedule simulation: can `pods` land on the remaining nodes, plus at
        most `max_new` new nodes (each strictly cheaper than `price_ceiling`, when
        one is set)?

        The ceiling is checked on the RESULT first: the cost-minimizing solve
        usually opens the cheapest fitting node, so most simulations keep the
        provider's instance-type list identity-stable and the encoder's
        identity-validated caches (launch options, requirement tables) hit
        instead of rebuilding per candidate. Only when that fast path rejects
        on price does the simulation re-run against a ceiling-FILTERED catalog
        — that is the one case where the answers can genuinely differ (e.g. a
        preferred affinity satisfiable only on an over-ceiling node: the
        filtered catalog makes the pod initially unschedulable, the relaxation
        pass sheds the preference, and an under-ceiling replacement appears).

        Returns (feasible, replacement_specs). Conservative: any unschedulable pod
        or more than `max_new` new nodes means infeasible (never strand a pod).
        `max_new=None` lifts the cap (drift/expiration replacements).
        """
        capacity = self._sweep_capacity
        if capacity is None:
            capacity = self.cluster.existing_capacity()
        excluded = set(exclude)
        existing = [e for e in capacity if e.node.name not in excluded]
        if freed:
            # gang-whole moves: cross-node members' requests are handed back
            # (their nodes survive; the members re-place with the batch) —
            # the preemption planner's shared freed-capacity idiom
            from .preemption import freed_existing_view

            existing = freed_existing_view(existing, set(freed))
        provisioners = [
            (prov, self.provider.get_instance_types(prov))
            for prov in self.cluster.provisioners.values()
        ]
        pods = list(pods)
        base, quality = (
            solvers if solvers is not None else (self.solver, self.quality_solver)
        )
        solver = base
        if quality is not None and len(pods) >= self.quality_min_pods:
            solver = quality
        daemonsets = (
            self._sweep_daemonsets
            if self._sweep_daemonsets is not None
            else self.cluster.daemonsets()
        )
        result = solver.solve_pods(
            pods, provisioners, existing=existing, daemonsets=daemonsets,
            phase_mode="sim",
        )
        backend = {0.0: "greedy", 1.0: "kernel", 2.0: "host-lp", 3.0: "host-ffd"}.get(
            result.stats.get("backend"), "oracle"
        )
        with self._counts_lock:
            self.sweep_backend_counts[backend] = (
                self.sweep_backend_counts.get(backend, 0) + 1
            )
        over_ceiling = price_ceiling is not None and any(
            n.option.price >= price_ceiling - 1e-9 for n in result.new_nodes
        )
        if price_ceiling is not None and (over_ceiling or result.unschedulable):
            # slow path: pre-filter the catalog and let relaxation work
            # against only under-ceiling options (old semantics). Runs on ANY
            # fast-path divergence — over-ceiling replacement OR stranded
            # pods — because heuristic packers are not monotone in the option
            # set: an over-ceiling node can attract pods and strand one that
            # the filtered catalog places fine. Skipped when the filter drops
            # nothing: the re-solve would see the identical catalog.
            filtered = []
            dropped = False
            for prov in self.cluster.provisioners.values():
                types = []
                for it in self.provider.get_instance_types(prov):
                    kept = [
                        o for o in it.offerings
                        if o.available and o.price < price_ceiling - 1e-9
                    ]
                    # only a PRICE drop changes what the encoder would see —
                    # unavailable offerings are skipped by the encoder anyway
                    if any(
                        o.available and o.price >= price_ceiling - 1e-9
                        for o in it.offerings
                    ):
                        dropped = True
                    if kept:
                        types.append(it.with_offerings(kept))
                filtered.append((prov, types))
            if dropped:
                result = solver.solve_pods(
                    pods, filtered, existing=existing, daemonsets=daemonsets,
                    phase_mode="sim",
                )
                over_ceiling = False
        if result.unschedulable:
            return False, []
        if max_new is not None and len(result.new_nodes) > max_new:
            return False, []
        if over_ceiling:
            return False, []
        return True, list(result.new_nodes)

    def _still_valid(self, action: PlannedAction) -> bool:
        nodes = [self.cluster.nodes.get(n) for n in action.nodes]
        if any(n is None or n.meta.deletion_timestamp is not None for n in nodes):
            return False
        if self.cluster.pending_pods():
            return False
        pods = [
            p
            for n in nodes
            for p in self.cluster.pods_on_node(n.name)
            if not p.is_daemonset
        ]
        # gang-whole moves re-validate the FULL move set: cross-node members
        # still bound re-place with the batch (vanished ones simply shrink
        # it); any member that moved onto the candidate node is already in
        # ``pods``
        here = {p.meta.name for p in pods}
        remote = []
        for name in action.evict_pods:
            p = self.cluster.pods.get(name)
            if p is not None and p.node_name is not None and p.meta.name not in here:
                pods.append(p)
                remote.append(name)
        price = sum(self._node_price(n) for n in nodes)
        fits, replacements = self._simulate(
            pods, exclude=action.nodes, price_ceiling=price, freed=remote
        )
        if not fits:
            return False
        if not action.replacements and replacements:
            return False  # a delete plan now needs capacity: abort
        return True

    # -- execution -------------------------------------------------------
    def _execute(self, action: PlannedAction) -> None:
        for replacement in action.replacements:
            # launch replacements BEFORE draining the old nodes, as the
            # reference does (replacement-node timeout semantics)
            pods = replacement.pod_names
            requests = merge(
                [self.cluster.pods[n].requests for n in pods if n in self.cluster.pods]
            )
            launch_from_spec(
                self.cluster, self.provider, replacement, requests,
                retry_policy=self.retry_policy, machine_ids=self.machine_ids,
            )
        if action.evict_pods:
            # gang-whole move: evict the gangs' cross-node members in the
            # same pass the candidate node drains, so the entire group
            # re-enters Pending together and the provisioning gang gate
            # re-places it all-or-nothing (its rollback owns any launch
            # split). requeue_unowned is belt-and-braces — movability vetted
            # ownership, but a racing controller change must not delete.
            from .termination import evict_pod

            for name in action.evict_pods:
                pod = self.cluster.pods.get(name)
                if pod is not None and pod.node_name is not None:
                    evict_pod(
                        self.cluster, pod, self.recorder,
                        reason=f"consolidation: gang moved whole "
                               f"({', '.join(action.gangs)})",
                        requeue_unowned=True,
                    )
        for name in action.nodes:
            self.termination.delete_node(name)
        self.termination.reconcile()
        metrics.DEPROVISIONING_ACTIONS.inc({"reason": action.reason})
        if self.costs is not None:
            self.costs.note_consolidation(action, now=self.clock.now())
        self.recorder.publish(
            "Deprovisioned", f"{action.reason}: {action.nodes}", object_kind="Deprovisioner"
        )
        details = {
            "nodes": list(action.nodes),
            "replacements": [
                r.option.instance_type.name for r in action.replacements
            ],
            "savings": round(action.savings, 5),
        }
        if action.gangs:
            details["gangs_moved_whole"] = list(action.gangs)
            details["evicted_members"] = list(action.evict_pods)
        DECISIONS.record(
            "consolidation", "acted", reason=action.reason,
            node=action.nodes[0] if action.nodes else "",
            details=details,
        )

    # -- helpers ---------------------------------------------------------
    def _provisioner_of(self, node: Node) -> Optional[Provisioner]:
        name = node.provisioner_name()
        return self.cluster.provisioners.get(name) if name else None

    def _node_price(self, node: Node) -> float:
        it_name = node.instance_type()
        for it in self.provider.get_instance_types(None):
            if it.name == it_name:
                for o in it.offerings:
                    if o.zone == node.zone() and o.capacity_type == node.capacity_type():
                        return o.price
        return float("inf")
