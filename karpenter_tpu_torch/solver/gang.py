"""Gang scheduling model: all-or-nothing pod groups + rank-aware placement.

A TPU-slice training job is useless at 7/8 ranks ("Rank-Aware Resource
Scheduling for Tightly-Coupled MPI Workloads on Kubernetes"): its pods name a
gang with the ``karpenter.tpu/pod-group`` key (label or annotation) and a
``pod-group-min-members`` quorum, and the provisioning controller's gang gate
admits the gang only as a unit — every pending member places in one round or
none do (the gate strips partial placements before anything binds).

This module owns the model side:

* :func:`collect_gangs` partitions a pending batch into gangs (membership via
  ``Pod.pod_group``; gang members bucket into their own solver groups because
  the gang key is part of the scheduling signature — ``encode._signature``'s
  gang component, mirrored in the native encoder);
* :func:`gang_placement` reads a solve result back into per-gang placement
  state (placed/unplaced members, the zones they landed in, the new-node
  specs that are *pure* gang carriers);
* :func:`rank_aware_replan` is the topology half: a gang whose cost-minimal
  placement scattered across zones is re-solved once per candidate zone with
  the members pinned (``topology.kubernetes.io/zone`` nodeSelector on
  clones — live pods are never mutated, same discipline as the relaxation
  machinery), and the cheapest single-zone plan replaces the scattered one
  when it costs no more than the scatter penalty — the "Priority Matters" /
  rank-aware papers' cost model of cross-slice communication. The zone split
  reuses the encoder's own topology vocabulary (option zones, existing-node
  zones) rather than inventing a parallel one.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..api import labels as wk
from ..api.objects import Pod
from .result import NewNodeSpec, SolveResult

#: accepted cost premium, per extra zone the scattered placement spans, for
#: moving a gang onto one zone: a plan scattered over Z zones is charged
#: ``SCATTER_PENALTY_FRAC * (Z - 1)`` of its own price, and the single-zone
#: replan wins whenever it beats the penalized cost. 10%/zone approximates
#: the cross-slice communication tax the rank-aware MPI literature measures.
SCATTER_PENALTY_FRAC = 0.10

#: zone candidates tried per gang replan — bounded work on the reconcile path
MAX_REPLAN_ZONES = 6


@dataclass
class Gang:
    """One pod group's pending members (name-sorted: deterministic iteration
    for the gate, the preemption planner, and replay)."""

    name: str
    pods: List[Pod]
    min_members: int = 1
    priority: int = 0  # entitlement: the WEAKEST member's priority

    @property
    def member_names(self) -> Set[str]:
        return {p.meta.name for p in self.pods}


def collect_gangs(pods: Sequence[Pod]) -> Dict[str, Gang]:
    """Partition a pending batch into gangs, keyed by pod-group name. The
    quorum is the max of the members' ``min-members`` annotations (any member
    may carry it); entitlement is the min of member priorities (a gang is
    only as preemption-worthy as its weakest rank)."""
    by_group: Dict[str, List[Pod]] = {}
    for p in pods:
        g = p.pod_group()
        if g:
            by_group.setdefault(g, []).append(p)
    gangs: Dict[str, Gang] = {}
    for name, members in by_group.items():
        members.sort(key=lambda p: p.meta.name)
        gangs[name] = Gang(
            name=name,
            pods=members,
            min_members=max(p.pod_group_min_members() for p in members),
            priority=min(p.priority for p in members),
        )
    return gangs


def bound_members(cluster, group: str) -> List[Pod]:
    """Members of ``group`` already bound to a node (they count toward the
    quorum and are the unit preemption must evict whole)."""
    out = [
        p
        for p in cluster.pods.values()
        if p.node_name is not None and p.pod_group() == group
    ]
    out.sort(key=lambda p: p.meta.name)
    return out


#: node-selector keys that are coordinates of the REGION a pod ran in, not
#: of the workload: a failover clone crossing regions must shed them or it
#: arrives unschedulable (the new region has different zones/ICI domains)
_REGIONAL_SELECTOR_KEYS = (
    wk.ZONE,
    wk.HOSTNAME,
    wk.SLICE_POD,
    wk.SLICE_COORD,
)


def failover_clone(pod: Pod, from_region: Optional[str] = None) -> Pod:
    """A fresh PENDING copy of a (possibly bound) pod for cross-region
    movement: new identity (uid, resource_version), no node binding, the
    regional coordinate pins stripped, and — when ``from_region`` is given
    (the blackout-failover path; plain federation transfers pass None) — a
    ``failover-from`` annotation for observability. Gang labels/annotations
    (and hence min-members and region-affinity) survive verbatim — gang
    atomicity crosses the region boundary intact."""
    from ..api.objects import new_uid

    clone = dataclasses.replace(pod)
    annotations = dict(pod.meta.annotations)
    if from_region:
        annotations[wk.FAILOVER_FROM] = from_region
    clone.meta = dataclasses.replace(
        pod.meta,
        uid=new_uid(),
        labels=dict(pod.meta.labels),
        annotations=annotations,
        finalizers=[],
        deletion_timestamp=None,
        resource_version=0,
    )
    clone.node_selector = {
        k: v
        for k, v in pod.node_selector.items()
        if k not in _REGIONAL_SELECTOR_KEYS
    }
    clone.node_name = None
    clone.phase = "Pending"
    clone.__dict__.pop("_sched_sig", None)
    return clone


def regional_failover_gangs(
    pods: Sequence[Pod], from_region: str
) -> Dict[str, List[Pod]]:
    """The whole-gang failover set for a lost region: every gang with at
    least one member in ``pods`` re-enters as a COMPLETE list of fresh
    pending clones (bound and pending members alike — a gang must never
    cross regions partially). Keyed by gang name, members name-sorted;
    lone (gangless) pods are not this function's business — the fleet
    re-creates them individually."""
    by_group: Dict[str, List[Pod]] = {}
    for p in pods:
        g = p.pod_group()
        if g:
            by_group.setdefault(g, []).append(p)
    out: Dict[str, List[Pod]] = {}
    for name in sorted(by_group):
        members = sorted(by_group[name], key=lambda p: p.meta.name)
        out[name] = [failover_clone(p, from_region) for p in members]
    return out


@dataclass
class GangPlacement:
    """One gang's view of a solve result."""

    placed: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    # pod name -> ("existing"|"new", node/zone info is in the maps below)
    unplaced: List[str] = field(default_factory=list)
    zones: Set[str] = field(default_factory=set)
    #: indices into solve.new_nodes of specs carrying ONLY this gang's pods
    pure_spec_idx: List[int] = field(default_factory=list)
    #: True when every placed member sits on a pure new-node spec (no
    #: existing-node reuse, no spec shared with foreign pods) — the only
    #: shape the rank-aware swap may rebuild without disturbing other pods
    pure: bool = True
    cost: float = 0.0  # summed price of the pure specs


def gang_placement(solve: SolveResult, gang: Gang, node_zone) -> GangPlacement:
    """Read one gang's placement out of a solve result. ``node_zone`` maps an
    existing node name to its zone (callers pass ``cluster.nodes`` lookups)."""
    members = gang.member_names
    out = GangPlacement()
    seen: Set[str] = set()
    for node_name, pod_names in solve.existing_assignments.items():
        hit = [n for n in pod_names if n in members]
        if hit:
            out.pure = False  # reuses shared capacity: never rebuilt
            z = node_zone(node_name)
            if z:
                out.zones.add(z)
            for n in hit:
                out.placed[n] = ("existing", node_name)
                seen.add(n)
    for idx, spec in enumerate(solve.new_nodes):
        names = list(spec.pod_names)
        hit = [n for n in names if n in members]
        if not hit:
            continue
        out.zones.add(spec.option.zone)
        for n in hit:
            out.placed[n] = ("new", spec.option.zone)
            seen.add(n)
        if len(hit) == len(names):
            out.pure_spec_idx.append(idx)
            out.cost += spec.option.price
        else:
            out.pure = False  # spec shared with foreign pods
    out.unplaced = sorted(members - seen)
    if any(kind == "existing" for kind, _ in out.placed.values()):
        out.pure = False
    return out


def _zone_pinned_clone(pod: Pod, zone: str) -> Pod:
    """A copy of ``pod`` with the zone folded into its nodeSelector. Clones,
    never live pods: the replan is a what-if, and a live pod's signature
    cache / selector must survive it untouched."""
    clone = dataclasses.replace(pod)
    clone.node_selector = {**pod.node_selector, wk.ZONE: zone}
    clone.__dict__.pop("_sched_sig", None)
    return clone


def candidate_zones(round_provs) -> List[str]:
    """Zones any available offering can open a node in, sorted by the
    cheapest available price there (cheapest zone first, then name for
    determinism) — the replan tries the most economical zones first."""
    best: Dict[str, float] = {}
    for _prov, types in round_provs:
        for it in types:
            for o in it.offerings:
                if not o.available:
                    continue
                cur = best.get(o.zone)
                if cur is None or o.price < cur:
                    best[o.zone] = o.price
    return sorted(best, key=lambda z: (best[z], z))[:MAX_REPLAN_ZONES]


def _slice_pinned_clone(pod: Pod, domain: str) -> Pod:
    """A copy of ``pod`` with the ICI domain folded into its nodeSelector —
    the slice analogue of ``_zone_pinned_clone`` (the slice-pod key is part
    of every slice offering's requirement surface, so the clone is
    compatible with exactly that domain's options)."""
    clone = dataclasses.replace(pod)
    clone.node_selector = {**pod.node_selector, wk.SLICE_POD: domain}
    clone.__dict__.pop("_sched_sig", None)
    return clone


def gang_adjacency_mode(gang: Gang) -> str:
    """The gang's slice-adjacency policy from the per-pod annotation
    (``karpenter.tpu/slice-adjacency``): "preferred" (default — the replan
    swaps in an adjacent plan when it wins on penalized cost), "required"
    (the gang defers until a single-domain plan exists) or "none" (opt out
    of adjacency scoring). Deterministic under conflicting members: the
    name-sorted first annotated member wins."""
    for p in gang.pods:  # pods are name-sorted (collect_gangs)
        v = p.meta.annotations.get(wk.SLICE_ADJACENCY, "")
        if v in ("required", "none", "preferred"):
            return v
    return "preferred"


def wants_slices(gang: Gang) -> bool:
    """Adjacency replanning only makes sense for gangs that consume TPU
    chips — a CPU gang pinned onto slice capacity would pay accelerator
    prices for nothing (the budget check would reject it anyway; this gate
    saves the doomed trial solves)."""
    from ..api.resources import GPU_TPU

    return any(p.requests.get(GPU_TPU) > 0 for p in gang.pods)


def slice_adjacency_replan(
    solver,
    gang: Gang,
    scattered_cost: float,
    scattered_points,
    round_provs,
    hop_penalty_frac: float,
    daemonsets: Sequence[Pod] = (),
    digest_sink=None,
    max_domains: int = MAX_REPLAN_ZONES,
    occupied_lookup=None,
    enforce_budget: bool = True,
    restrict=None,
) -> Optional[Tuple[str, List[NewNodeSpec], float, float]]:
    """Repack a gang onto ONE ICI domain, scored by torus hop distance.

    The incumbent (scattered) plan is charged
    ``cost * (1 + hop_penalty_frac * mean_hops)`` — the hop-count penalty
    that replaces the flat 10%-per-zone scatter fraction: cross-zone pairs
    cost CROSS_ZONE_HOPS, cross-domain pairs CROSS_POD_HOPS, intra-domain
    pairs their ring-metric distance. Candidate domains are tried
    cheapest-first (bounded); each trial pins member clones to the domain,
    solves, then remaps the resulting nodes onto a compact coordinate
    window (topology.remap_compact) so "one domain" also means "adjacent
    slices" — windowed around the coordinates live nodes already hold
    (``occupied_lookup(zone, domain) -> frozenset``; a physical slice hosts
    one node, so a second gang in a half-full domain packs the free ball).
    Returns ``(domain, specs, cost, mean_hops)`` for the best plan whose
    penalized score beats the incumbent's, or None. Every trial's problem
    digest flows to ``digest_sink`` for byte-faithful replay.

    ``enforce_budget=False`` (the adjacency-REQUIRED mode) keeps the
    cheapest-first search but accepts the best single-domain plan whatever
    it costs relative to the incumbent: for a required gang adjacency is a
    hard constraint, and a budget-filtered None here would defer it forever
    while feasible adjacent capacity exists. ``restrict`` limits the
    candidate (zone, domain) pairs — the scale-up path pins the search to a
    running gang's home domain."""
    from . import topology

    inc_hops, _ = topology.plan_hop_stats(scattered_points)
    budget = scattered_cost * (1.0 + hop_penalty_frac * inc_hops)
    best: Optional[Tuple[str, List[NewNodeSpec], float, float]] = None
    best_score = None
    candidates = topology.candidate_domains(round_provs)[:max_domains]
    if restrict is not None:
        candidates = [c for c in candidates if c in restrict]
    for zone, domain in candidates:
        clones = [_slice_pinned_clone(p, domain) for p in gang.pods]
        trial = solver.solve_pods(
            clones, round_provs, existing=(), daemonsets=daemonsets,
            session=None, phase_mode="sim",
        )
        if digest_sink is not None:
            digest_sink(trial.problem_digest)
        if trial.unschedulable or trial.existing_assignments:
            continue
        occupied = (
            occupied_lookup(zone, domain)
            if occupied_lookup is not None
            else frozenset()
        )
        specs = topology.remap_compact(
            list(trial.new_nodes), round_provs, occupied=occupied
        )
        if specs is None:
            # topology drifted mid-round (or plan outgrew the torus): keep
            # the solver's own coordinate choices rather than invent options
            specs = list(trial.new_nodes)
        cost = sum(s.option.price for s in specs)
        hops, _ = topology.plan_hop_stats(
            [topology.spec_point(s.option) for s in specs]
        )
        score = cost * (1.0 + hop_penalty_frac * hops)
        if enforce_budget and score > budget + 1e-9:
            continue
        if best_score is None or score < best_score - 1e-9:
            best = (domain, specs, cost, hops)
            best_score = score
    return best


def rank_aware_replan(
    solver,
    gang: Gang,
    scattered_cost: float,
    scattered_zones: Set[str],
    round_provs,
    daemonsets: Sequence[Pod] = (),
    digest_sink=None,
) -> Optional[Tuple[str, List[NewNodeSpec], float]]:
    """Try to repack a scattered gang onto one zone's fresh nodes. Returns
    ``(zone, new_specs, cost)`` for the cheapest feasible single-zone plan
    that beats the scatter-penalized incumbent, or None (the scattered
    placement stands). Every trial solve's problem digest is reported through
    ``digest_sink`` so flight-recorder replay compares the full sequence."""
    budget = scattered_cost * (
        1.0 + SCATTER_PENALTY_FRAC * max(len(scattered_zones) - 1, 0)
    )
    best: Optional[Tuple[str, List[NewNodeSpec], float]] = None
    for zone in candidate_zones(round_provs):
        clones = [_zone_pinned_clone(p, zone) for p in gang.pods]
        # phase_mode="sim": what-if solves must not pollute the
        # delta-vs-full phase histogram (the consolidation-sweep convention)
        trial = solver.solve_pods(
            clones, round_provs, existing=(), daemonsets=daemonsets,
            session=None, phase_mode="sim",
        )
        if digest_sink is not None:
            digest_sink(trial.problem_digest)
        if trial.unschedulable or trial.existing_assignments:
            continue
        cost = sum(s.option.price for s in trial.new_nodes)
        if cost > budget + 1e-9:
            continue
        if best is None or cost < best[2] - 1e-9:
            best = (zone, list(trial.new_nodes), cost)
    return best
