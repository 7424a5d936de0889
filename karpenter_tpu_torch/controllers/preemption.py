"""Priority preemption planner: make room for what matters most.

When a higher-priority gang (or pod) survives the whole pool cascade
unschedulable, reporting ``FailedScheduling`` and waiting is the wrong answer
on a full cluster — "Priority Matters" (arXiv:2511.08373) shows priority
tiers recovering substantial usage by letting latency-critical work displace
batch work. This planner computes the cheapest-to-evict set of lower-priority
victims, executes the evictions through the termination path
(:func:`..controllers.termination.evict_pod` — owned victims return to
Pending and re-enter the batch window + delta-encode dirty sets as ordinary
watch events), and hands back a placement the caller binds in the SAME
reconcile round.

Plan mechanics:

* **Victim units.** A victim is a singleton bound pod — or a whole gang: a
  bound gang is one indivisible unit, because evicting one member leaves a
  sub-quorum gang burning capacity (the exact failure mode gang scheduling
  exists to prevent). A unit is eligible only when EVERY member has priority
  strictly below the preemptor's, is owned (unowned pods cannot be recreated),
  tolerates eviction (no ``do-not-evict``), and clears its PDBs.
* **Cheapest first.** Units order by (highest member priority, summed
  pod-deletion-cost, member count, name): the planner prefers evicting the
  least-entitled, cheapest, smallest victims, deterministically.
* **Trial solves.** Victims accrue greedily; after each unit the preemptor is
  re-solved against the cluster's existing capacity with the victims' requests
  freed (``provisioners=[]`` — preemption places onto freed capacity; if a new
  node could have opened, the cascade would already have opened it). The first
  feasible victim set wins. Every trial's problem digest flows to the flight
  recorder, so an offline replay re-runs the identical trial sequence.
* **Verdicts.** Each executed eviction emits a ``preemption``/``preempted-by``
  DecisionRecord naming the preemptor, the full victim list, and the price
  delta (new-node cost of the preemption re-solve minus nothing — normally 0,
  the preemptor lands entirely on freed capacity), so ``/debug/decisions`` and
  the flight recorder answer "why was my pod preempted" byte-reproducibly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..api import labels as wk
from ..api.objects import Pod
from ..api.resources import Resources, merge
from ..solver.encode import ExistingNode
from ..solver.result import SolveResult
from ..state.cluster import Cluster
from ..utils import metrics
from ..utils.decisions import DECISIONS
from ..utils.events import Recorder
from .termination import evict_pod, pdb_blocks

#: bounded work per reconcile: preemptors attempted, and victim units tried
#: per preemptor (each accrual is one trial solve)
MAX_PREEMPTORS_PER_ROUND = 4
MAX_VICTIM_UNITS = 16

#: restart tax per evicted pod ($/hr-equivalents): the drain + reschedule +
#: lost-work cost the preempt-or-launch comparison charges on top of the
#: trial's price delta, so "evict for free" never beats a genuinely cheap
#: launch just because victims carry no pod-deletion-cost
RESTART_TAX_PER_POD = 0.02

#: effective-priority bump for a restart-boosted victim gang (one tier),
#: applied to its VICTIM-side entitlement ONLY: freshly re-placed after an
#: eviction, it cannot be re-evicted by an equal-priority preemptor while
#: the gang_restart_boost_rounds budget runs. Deliberately NOT applied to
#: the gang's preemptor-side priority — a boosted gang that could evict
#: equal-priority peers would let two equal-tier gangs displace each other
#: in a cycle, the exact thrash the budget exists to prevent.
RESTART_BOOST = 1


def freed_existing_view(
    existing: Sequence[ExistingNode], freed_names: Set[str]
) -> List[ExistingNode]:
    """``existing`` with the named pods' requests handed back (their nodes
    stay; only the pods move) — the shared trial-capacity idiom of the
    preemption planner and the gang-whole consolidation sweep."""
    if not freed_names:
        return list(existing)
    out: List[ExistingNode] = []
    for e in existing:
        gone = [p for p in e.pods if p.meta.name in freed_names]
        if not gone:
            out.append(e)
            continue
        freed = merge([p.requests + Resources(pods=1) for p in gone])
        out.append(
            ExistingNode(
                node=e.node,
                remaining=e.remaining + freed,
                pods=tuple(p for p in e.pods if p.meta.name not in freed_names),
            )
        )
    return out


@dataclass
class Preemptor:
    """One unit of unschedulable higher-priority demand: a deferred gang's
    pending members, or a single unschedulable prioritized pod."""

    name: str
    pods: List[Pod]
    priority: int
    is_gang: bool = False

    @property
    def kind(self) -> str:
        return "gang" if self.is_gang else "pod"


@dataclass
class VictimUnit:
    """An indivisible eviction unit: one bound pod, or a bound gang whole."""

    name: str
    pods: List[Pod]
    priority: int  # HIGHEST member priority (the unit's entitlement)
    deletion_cost: float

    def sort_key(self) -> tuple:
        return (self.priority, self.deletion_cost, len(self.pods), self.name)


@dataclass
class PreemptionPlan:
    preemptor: Preemptor
    victims: List[VictimUnit]
    result: SolveResult  # the feasible trial: binds onto freed capacity
    price_delta: float = 0.0  # new-node cost of the re-solve (normally 0)
    eviction_cost: float = 0.0  # summed victim pod-deletion-cost

    @property
    def victim_names(self) -> List[str]:
        return [p.meta.name for u in self.victims for p in u.pods]

    @property
    def victim_gangs(self) -> List[str]:
        """Names of gangs evicted whole by this plan (restart-boost targets)."""
        return [
            u.name[len("gang/"):] for u in self.victims
            if u.name.startswith("gang/")
        ]

    def evict_cost(self) -> float:
        """The preempt-or-launch price of executing this plan: the trial's
        new-node price delta, a flat restart tax per evicted pod, and the
        victims' pod-deletion-cost scaled to $-hours (the same 1/1000 the
        consolidation disruption ranking uses)."""
        n = sum(len(u.pods) for u in self.victims)
        return self.price_delta + RESTART_TAX_PER_POD * n + self.eviction_cost / 1000.0


class PreemptionPlanner:
    def __init__(self, cluster: Cluster, solver, recorder: Optional[Recorder] = None):
        self.cluster = cluster
        self.solver = solver
        self.recorder = recorder or Recorder()
        # gangs under an active restart boost (evicted whole by an earlier
        # plan, still inside the gang_restart_boost_rounds thrash budget):
        # the provisioning controller refreshes this set every reconcile
        self.restart_boosted: Set[str] = set()
        # caller-staged capacity view for trial solves (None = read the live
        # cluster): the in-cascade preempt-or-launch sets it per decision so
        # a trial can never claim capacity the round's solve already
        # assigned to other pods (double-booking)
        self.base_existing: Optional[List[ExistingNode]] = None

    def boosted_priority(self, base: int, gang: Optional[str]) -> int:
        """Effective priority of a gang under the restart boost."""
        if gang is not None and gang in self.restart_boosted:
            return base + RESTART_BOOST
        return base

    # -- candidate victims --------------------------------------------------
    def _victim_units(self, preemptor: Preemptor) -> List[VictimUnit]:
        managed = {n.name for n in self.cluster.managed_nodes()}
        own_members = {p.meta.name for p in preemptor.pods}
        by_gang: Dict[str, List[Pod]] = {}
        unmanaged_gangs: Set[str] = set()
        singles: List[Pod] = []
        for p in self.cluster.pods.values():
            if p.node_name is None:
                continue
            if p.is_daemonset or p.meta.name in own_members:
                continue
            g = p.pod_group()
            if g is not None:
                if p.node_name in managed:
                    by_gang.setdefault(g, []).append(p)
                else:
                    # a member on an UNMANAGED node can never be evicted by
                    # us, so the gang can never be evicted whole — the whole
                    # unit is off the table (evicting just the managed
                    # members would leave a sub-quorum remnant)
                    unmanaged_gangs.add(g)
            elif p.node_name in managed:
                singles.append(p)
        for g in unmanaged_gangs:
            by_gang.pop(g, None)
        units: List[VictimUnit] = []
        for p in singles:
            units.append(
                VictimUnit(
                    name=p.meta.name, pods=[p], priority=p.priority,
                    deletion_cost=max(p.deletion_cost(), 0.0),
                )
            )
        for g, members in by_gang.items():
            members.sort(key=lambda p: p.meta.name)
            units.append(
                VictimUnit(
                    name=f"gang/{g}", pods=members,
                    # restart-boosted gangs carry one extra tier of
                    # entitlement: freshly re-placed after an eviction, they
                    # cannot be re-evicted by an equal-priority preemptor
                    # while the thrash budget runs
                    priority=self.boosted_priority(
                        max(p.priority for p in members), g
                    ),
                    deletion_cost=sum(max(p.deletion_cost(), 0.0) for p in members),
                )
            )
        # priority filter + sort are cheap; the PDB vet is O(cluster pods)
        # per member, so it runs LAZILY down the sorted order and stops at
        # the unit cap — identical selection, bounded PDB checks (at most
        # MAX_VICTIM_UNITS eligible units are ever tried anyway)
        units = [u for u in units if u.priority < preemptor.priority]
        units.sort(key=VictimUnit.sort_key)
        eligible: List[VictimUnit] = []
        for u in units:
            if self._evictable(u):
                eligible.append(u)
                if len(eligible) >= MAX_VICTIM_UNITS:
                    break
        return eligible

    def _evictable(self, unit: VictimUnit, planned: Set[str] = frozenset()) -> bool:
        """Whole-unit eviction legality given ``planned`` pods already slated
        by the accruing plan: each member's PDB check counts the plan's prior
        victims AND the unit's own earlier members as disrupted, so a 3-pod
        gang unit (or several singletons under one budget) cannot collectively
        blow a maxUnavailable its members would each clear alone."""
        acc: Set[str] = set(planned)
        for p in unit.pods:
            if p.meta.annotations.get(wk.DO_NOT_EVICT_ANNOTATION) == "true":
                return False
            if not p.owned():
                return False  # cannot be recreated: never a preemption victim
            if pdb_blocks(self.cluster, p, planned=acc):
                return False
            acc.add(p.meta.name)
        return True

    # -- trial capacity -----------------------------------------------------
    def _freed_existing(self, victim_names: Set[str]) -> List[ExistingNode]:
        """The cluster's existing capacity with the victims' requests handed
        back — exactly the view the re-solve will see once the evictions
        execute, so the accepted trial IS the final placement. When the
        caller staged a base view (``base_existing`` — the in-cascade
        preempt-or-launch passes capacity NET of the round's still-unbound
        existing assignments), victims free capacity on top of it."""
        base = (
            self.base_existing
            if self.base_existing is not None
            else self.cluster.existing_capacity()
        )
        return freed_existing_view(base, victim_names)

    # -- planning -----------------------------------------------------------
    def plan(self, preemptor: Preemptor, digest_sink=None) -> Optional[PreemptionPlan]:
        """Greedy cheapest-first victim accrual with a trial solve per step;
        None when no eligible victim set frees enough compatible capacity."""
        units = self._victim_units(preemptor)
        if not units:
            return None
        selected: List[VictimUnit] = []
        names: Set[str] = set()
        for unit in units:
            # re-vet against the victims already accrued: a unit that clears
            # its PDBs alone may violate them combined with earlier victims
            # under the same budget (eligibility only shrinks as the plan
            # grows, so the initial per-unit vet stays a valid pre-filter)
            if names and not self._evictable(unit, planned=names):
                continue
            selected.append(unit)
            names.update(p.meta.name for p in unit.pods)
            trial = self.solver.solve_pods(
                preemptor.pods, [], existing=self._freed_existing(names),
                session=None, phase_mode="sim",
            )
            if digest_sink is not None:
                digest_sink(trial.problem_digest)
            if not trial.unschedulable:
                return PreemptionPlan(
                    preemptor=preemptor,
                    victims=selected,
                    result=trial,
                    price_delta=round(float(trial.cost), 5),
                    eviction_cost=sum(u.deletion_cost for u in selected),
                )
        return None

    # -- execution ----------------------------------------------------------
    def execute(self, plan: PreemptionPlan) -> None:
        """Evict every victim through the termination path and emit the
        ``preempted-by`` verdicts. After this returns, the cluster's existing
        capacity equals the accepted trial's view — the caller binds
        ``plan.result`` in the same round."""
        preemptor = plan.preemptor
        victim_names = plan.victim_names
        for unit in plan.victims:
            for pod in unit.pods:
                node = pod.node_name or ""
                evict_pod(
                    self.cluster, pod, self.recorder,
                    reason=f"preempted by {preemptor.kind} {preemptor.name}",
                )
                metrics.PREEMPTION_EVICTIONS.inc(
                    {"preemptor": preemptor.kind}
                )
                DECISIONS.record(
                    "preemption", "preempted-by", pod=pod.meta.name, node=node,
                    reason=f"preempted by {preemptor.kind} {preemptor.name}",
                    details={
                        "preemptor": preemptor.name,
                        "preemptor_priority": preemptor.priority,
                        "victim_priority": pod.priority,
                        "victims": victim_names,
                        "price_delta": plan.price_delta,
                        "eviction_cost": plan.eviction_cost,
                    },
                )
