"""Spot-pool diversification gate: cap per-group concentration in one pool.

Risk-aware pricing (encode.py: ``price + interruption_probability *
penalty``) makes the solver prefer stable pools, but price alone cannot
stop it from landing an entire deployment (or gang) in the single cheapest
spot pool — one reclaim wave then takes every replica at once, which is
exactly the correlated failure KubePACS diversifies against. This module
is the between-solve-and-bind enforcement (the gang gate's sibling): after
each solve it checks, per pod group and per gang, what fraction of the
unit's members landed in any single SPOT capacity pool
(``(instance_type, zone, capacity_type)``); members over the cap are
STRIPPED from the result and the overweight pool is masked for the
cascade's re-solve round, so the excess respreads onto the next-best pools
— which may well be other spot pools, at other risk coordinates.

On-demand pools are never capped (reclaims there are not correlated
events), singleton units are exempt (a cap below one member is
meaningless), and the controller falls back to placement-over-
diversification when masking would strand a pod: zero unschedulable pods
outranks spread.

Per-pod override: the ``karpenter.tpu/spot-diversification-max-frac``
annotation tightens/loosens the global fraction for its group, or opts the
group out entirely with ``none``. The annotation is part of the scheduling
signature (encode._signature), so carriers never bucket with plain pods.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..api import labels as wk
from ..api.objects import Pod
from .result import NewNodeSpec, SolveResult

PoolKey = Tuple[str, str, str]  # (instance_type, zone, capacity_type)


@dataclass
class DiversificationUnit:
    """One all-replicas-together failure domain the cap applies to: a gang
    (by pod-group name) or a scheduling-signature group of size >= 2."""

    name: str
    member_names: Set[str]
    max_frac: Optional[float]  # per-pod annotation override; None = global
    is_gang: bool = False

    @property
    def size(self) -> int:
        return len(self.member_names)


@dataclass
class GateOutcome:
    solve: SolveResult  # the (possibly stripped) result shell
    strip: Set[str] = field(default_factory=set)  # pod names stripped
    mask: Set[PoolKey] = field(default_factory=set)  # pools to mask for re-solve
    verdicts: List[Dict] = field(default_factory=list)  # per-unit audit details


def unit_max_frac(rep: Pod, global_frac: float) -> Optional[float]:
    """The unit's effective cap fraction: the representative's annotation
    override when present (``none`` opts out -> None means *no cap* here),
    the global setting otherwise."""
    ann = rep.meta.annotations or {}
    raw = ann.get(wk.SPOT_DIVERSIFICATION)
    if raw is None:
        return global_frac if global_frac < 1.0 else None
    if str(raw).lower() == "none":
        return None
    try:
        frac = float(raw)
    except ValueError:
        return global_frac if global_frac < 1.0 else None
    return frac if 0.0 < frac < 1.0 else None


def collect_units(
    batch: Sequence[Pod], gangs: Dict[str, object], global_frac: float
) -> List[DiversificationUnit]:
    """The batch's diversification units: every gang, plus every
    scheduling-signature group of size >= 2 whose members are not gang
    members (gang identity is already folded into the signature, so the
    two populations cannot overlap within one bucket)."""
    from .encode import _group_members

    units: List[DiversificationUnit] = []
    gang_members: Set[str] = set()
    for name in sorted(gangs):
        g = gangs[name]
        gang_members.update(g.member_names)
        frac = unit_max_frac(g.pods[0], global_frac)
        if frac is None:
            continue
        units.append(
            DiversificationUnit(
                name=name,
                member_names=set(g.member_names),
                max_frac=frac,
                is_gang=True,
            )
        )
    for members in _group_members(list(batch)):
        if len(members) < 2 or members[0].meta.name in gang_members:
            continue
        frac = unit_max_frac(members[0], global_frac)
        if frac is None:
            continue
        units.append(
            DiversificationUnit(
                name=f"group/{members[0].meta.name}",
                member_names={p.meta.name for p in members},
                max_frac=frac,
            )
        )
    return units


def _node_pool(cluster, node_name: str) -> Optional[PoolKey]:
    node = cluster.nodes.get(node_name)
    return None if node is None else node.capacity_pool()


def gate(
    solve: SolveResult,
    units: Sequence[DiversificationUnit],
    cluster,
    enforce: bool = True,
) -> GateOutcome:
    """Check every unit's per-spot-pool concentration against its cap and
    strip the excess (this round's placements only — members bound in
    earlier rounds count toward usage but are never unwound here). Returns
    a NEW result shell when anything stripped; the input is not mutated."""
    if not units:
        return GateOutcome(solve)
    # pod -> pool for this round's placements (spot pools only)
    pod_pool: Dict[str, Tuple[PoolKey, bool]] = {}  # name -> (pool, from_new_spec)
    for spec in solve.new_nodes:
        if spec.option.capacity_type != wk.CAPACITY_TYPE_SPOT:
            continue
        pool = spec.option.pool
        for name in spec.pod_names:
            pod_pool[name] = (pool, True)
    for node_name, pod_names in solve.existing_assignments.items():
        pool = _node_pool(cluster, node_name)
        if pool is None or pool[2] != wk.CAPACITY_TYPE_SPOT:
            continue
        for name in pod_names:
            pod_pool[name] = (pool, False)

    strip: Set[str] = set()
    mask: Set[PoolKey] = set()
    verdicts: List[Dict] = []
    for unit in units:
        # usage per pool: this round's placements plus members ALREADY bound
        # to spot nodes by earlier rounds (they count, but cannot be stripped)
        usage: Dict[PoolKey, List[Tuple[str, bool, bool]]] = {}
        for name in unit.member_names:
            ent = pod_pool.get(name)
            if ent is not None:
                usage.setdefault(ent[0], []).append((name, ent[1], True))
                continue
            pod = cluster.pods.get(name)
            if pod is not None and pod.node_name is not None:
                pool = _node_pool(cluster, pod.node_name)
                if pool is not None and pool[2] == wk.CAPACITY_TYPE_SPOT:
                    usage.setdefault(pool, []).append((name, False, False))
        cap = max(1, math.ceil(unit.max_frac * unit.size))
        for pool in sorted(usage):
            members = usage[pool]
            if len(members) <= cap:
                continue
            mask.add(pool)
            if not enforce:
                verdicts.append({
                    "unit": unit.name, "pool": "/".join(pool),
                    "members": len(members), "cap": cap, "stripped": 0,
                    "accepted": True,
                })
                continue
            # strippable = placed THIS round (earlier-round binds stand)
            strippable = sorted(name for name, _, this_round in members if this_round)
            if unit.is_gang:
                # a gang respreads WHOLE: strip every member this round's
                # solve placed (any pool) so the all-or-nothing unit
                # re-solves atomically against the masked catalog — never
                # member-by-member, which would recreate the partial
                # placement the gang gate exists to prevent
                placed = set()
                for spec in solve.new_nodes:
                    placed.update(n for n in spec.pod_names if n in unit.member_names)
                for pods in solve.existing_assignments.values():
                    placed.update(n for n in pods if n in unit.member_names)
                to_strip = sorted(placed)
            else:
                # prefer stripping new-spec placements (cheap to not-launch)
                strippable.sort(
                    key=lambda n: (not pod_pool.get(n, (None, False))[1], n)
                )
                to_strip = strippable[: len(members) - cap]
            strip.update(to_strip)
            verdicts.append({
                "unit": unit.name, "pool": "/".join(pool),
                "members": len(members), "cap": cap,
                "stripped": len(to_strip), "accepted": False,
            })
    if not strip:
        return GateOutcome(solve, set(), mask if not enforce else set(), verdicts)
    return GateOutcome(strip_result(solve, strip), strip, mask, verdicts)


def strip_result(solve: SolveResult, strip: Set[str]) -> SolveResult:
    """A new SolveResult shell with ``strip`` pods removed from every
    placement (specs that empty out are dropped); the input — possibly
    cache-shared — is never mutated. Same shape as the gang gate's strip."""
    new_nodes: List[NewNodeSpec] = []
    for spec in solve.new_nodes:
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
    existing: Dict[str, List[str]] = {}
    for node_name, pod_names in solve.existing_assignments.items():
        names = [n for n in pod_names if n not in strip]
        if names:
            existing[node_name] = names
    return SolveResult(
        new_nodes=new_nodes,
        existing_assignments=existing,
        unschedulable=[n for n in solve.unschedulable if n not in strip],
        cost=sum(s.option.price for s in new_nodes),
        stats=dict(solve.stats),
        problem_digest=solve.problem_digest,
    )


def filter_existing(existing: Sequence[object], pools: Set[PoolKey]) -> List[object]:
    """Existing-capacity entries minus nodes in masked pools: a respread
    re-solve must not rebind the stripped pods onto the overweight pool's
    free EXISTING capacity either — that was the thrash the first version
    of this gate looped on."""
    if not pools:
        return list(existing)
    return [e for e in existing if e.node.capacity_pool() not in pools]


def mask_pools(
    instance_types: Sequence[object], pools: Set[PoolKey]
) -> List[object]:
    """The catalog with ``pools``' offerings marked unavailable — the
    cascade's re-solve then cannot land the respread pods back in the
    overweight pool. Identity-stable when nothing matches, so the encoder's
    option caches keep hitting on unmasked rounds."""
    if not pools:
        return list(instance_types)
    out = []
    for it in instance_types:
        hit = any(
            (it.name, o.zone, o.capacity_type) in pools and o.available
            for o in it.offerings
        )
        if not hit:
            out.append(it)
            continue
        out.append(
            it.with_offerings([
                replace(o, available=False)
                if (it.name, o.zone, o.capacity_type) in pools
                else o
                for o in it.offerings
            ])
        )
    return out
