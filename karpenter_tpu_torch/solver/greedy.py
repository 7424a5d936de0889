"""Greedy first-fit-decreasing packer — the reference-semantics oracle.

Implements the same algorithm the reference's ``Scheduler.Solve()`` runs
(upstream ``designs/bin-packing.md:16-43``): pods sorted by dominant resource
descending, first-fit onto existing in-flight capacity then already-opened new
nodes, else open the cheapest feasible instance offering. Constraint checks
(topology spread, pod (anti-)affinity) are evaluated exactly against the evolving
assignment, which makes this packer the correctness oracle for the kernel backend and
the fallback for constraint shapes the tensor path doesn't support.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api import labels as wk
from ..api.objects import Pod
from .encode import EncodedProblem, LaunchOption, PodGroup
from .result import NewNodeSpec, SolveResult


@dataclass
class _SimNode:
    rem: np.ndarray  # remaining capacity [R]
    zone: str
    existing_name: Optional[str] = None  # set for in-flight nodes
    option_index: Optional[int] = None  # set for new nodes
    pods: List[Pod] = field(default_factory=list)

    def host_id(self) -> str:
        return self.existing_name or f"new-{id(self)}"


def _dominant_size(demand_row: np.ndarray, norm: np.ndarray) -> float:
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.where(norm > 0, demand_row / norm, 0.0)
    return float(np.max(frac))


class GreedyPacker:
    def __init__(self, problem: EncodedProblem):
        self.p = problem
        # Existing nodes start WITH their bound pods, so spread/affinity checks
        # count cluster-wide domain occupancy, not just the in-batch placements
        # (their resources are already excluded from ex_rem).
        self.nodes: List[_SimNode] = [
            _SimNode(rem=problem.ex_rem[i].astype(np.float64).copy(), zone=e.node.zone() or "",
                     existing_name=e.name, pods=list(e.pods))
            for i, e in enumerate(problem.existing)
        ]
        self._seed_counts = [len(e.pods) for e in problem.existing]
        self.n_existing = len(self.nodes)
        # admission-symmetry fast path: scan the anti-term inventory once so
        # constraint-free problems skip the per-placement reverse checks
        carriers = [g.pods[0] for g in problem.groups] + [
            p for e in problem.existing for p in e.pods
        ]
        self._any_anti_host = any(
            t.anti and t.topology_key == wk.HOSTNAME
            for p in carriers
            for t in p.affinity_terms
        )
        # zone-level symmetry runs off incremental per-(zone, term) carrier
        # counts, not a rescan of every pod in the zone per placement (that
        # is quadratic in batch size): unique anti-zone terms by signature,
        # counts seeded from bound pods and bumped by _try_place.
        self._anti_zone_terms: Dict[tuple, object] = {}
        for p in carriers:
            for t in p.affinity_terms:
                if t.anti and t.topology_key == wk.ZONE:
                    sig = tuple(sorted(dict(t.label_selector).items()))
                    self._anti_zone_terms.setdefault(sig, t)
        self._zone_carriers: Dict[tuple, int] = {}  # (zone, sig) -> carriers
        for node in self.nodes:
            for q in node.pods:
                self._bump_zone_carriers(q, node.zone)

    def _bump_zone_carriers(self, pod: Pod, zone: str) -> None:
        if not self._anti_zone_terms:
            return
        for t in pod.affinity_terms:
            if t.anti and t.topology_key == wk.ZONE:
                sig = tuple(sorted(dict(t.label_selector).items()))
                key = (zone, sig)
                self._zone_carriers[key] = self._zone_carriers.get(key, 0) + 1

    # -- constraint checks against the evolving assignment ------------------
    def _spread_ok(self, pod: Pod, node: _SimNode) -> bool:
        # effective_spread: DoNotSchedule plus still-active promoted
        # ScheduleAnyway constraints (relaxation happens via pod clones)
        for c in pod.effective_spread():
            # Zone domains include every zone in the problem (empty zones count 0);
            # hostname domains always admit a fresh empty node, so min stays 0.
            counts: Dict[str, int] = (
                {z: 0 for z in self.p.zones} if c.topology_key == wk.ZONE else {}
            )
            for n in self.nodes:
                key = n.host_id() if c.topology_key == wk.HOSTNAME else n.zone
                counts.setdefault(key, 0)
                counts[key] += sum(1 for q in n.pods if c.selects(q))
            key = node.host_id() if c.topology_key == wk.HOSTNAME else node.zone
            # selfMatchNum: the incoming pod only counts toward the skew when
            # the constraint's selector matches the pod itself
            new_count = counts.get(key, 0) + (1 if c.selects(pod) else 0)
            min_count = 0 if c.topology_key == wk.HOSTNAME else min(counts.values(), default=0)
            if new_count - min_count > c.max_skew:
                return False
        return True

    def _affinity_ok(self, pod: Pod, node: _SimNode) -> bool:
        # admission symmetry (k8s InterPodAffinity): a pod may not join a
        # domain holding a pod whose required ANTI term selects it
        if self._any_anti_host:
            for other in node.pods:
                for t2 in other.affinity_terms:
                    if t2.anti and t2.topology_key == wk.HOSTNAME and t2.selects(pod):
                        return False
        for sig, t2 in self._anti_zone_terms.items():
            if self._zone_carriers.get((node.zone, sig), 0) and t2.selects(pod):
                return False
        for term in pod.affinity_terms:
            matching_domains = set()
            any_match = False
            for n in self.nodes:
                if any(term.selects(q) for q in n.pods):
                    any_match = True
                    matching_domains.add(
                        n.host_id() if term.topology_key == wk.HOSTNAME else n.zone
                    )
            key = node.host_id() if term.topology_key == wk.HOSTNAME else node.zone
            if term.anti:
                if key in matching_domains:
                    return False
            else:
                # Required affinity: restrict to matching domains once one exists;
                # the first matching pod bootstraps anywhere.
                if any_match and key not in matching_domains:
                    return False
        return True

    def _fits(self, demand: np.ndarray, node: _SimNode) -> bool:
        return bool(np.all(demand <= node.rem + 1e-9))

    def _try_place(self, pod: Pod, gi: int, demand: np.ndarray, node: _SimNode, ni: int) -> bool:
        if node.existing_name is not None:
            if not self.p.ex_compat[gi, ni]:  # existing nodes occupy indices [0, E)
                return False
        else:
            if not self.p.compat[gi, node.option_index]:
                return False
        if not self._fits(demand, node):
            return False
        if not self._spread_ok(pod, node):
            return False
        if not self._affinity_ok(pod, node):
            return False
        node.rem -= demand
        node.pods.append(pod)
        self._bump_zone_carriers(pod, node.zone)
        return True

    def solve(self) -> SolveResult:
        p = self.p
        # FFD order: dominant resource fraction, descending (bin-packing.md:28-43).
        norm = p.alloc.max(axis=0) if p.O else np.ones(p.demand.shape[1])
        norm = np.where(norm > 0, norm, 1.0)
        pod_order: List[Tuple[float, int, Pod]] = []
        for gi, g in enumerate(p.groups):
            size = _dominant_size(p.demand[gi], norm)
            for pod in g.pods:
                pod_order.append((size, gi, pod))
        pod_order.sort(key=lambda t: -t[0])

        unschedulable: List[str] = []
        # Unplaced count per group: opening a node for a pod sizes the node by the
        # TRUE marginal cost of the group's remaining pods (ceil(remaining/units) x
        # price), mirroring how the reference packs the batch into a hypothetical
        # node and then picks the cheapest instance type that holds it — not
        # "cheapest node that fits one pod", which shreds batches across minimum
        # nodes (bin-packing.md:16-43). Sizing uses the co-packing demand
        # (encode.sizing_demand): providers of hostname-affinity requirers
        # reserve room for them, as the reference's hypothetical node does.
        from .encode import sizing_demand

        size_d = sizing_demand(p)
        remaining = {gi: g.count for gi, g in enumerate(p.groups)}
        units_cache: Dict[int, np.ndarray] = {}
        for size, gi, pod in pod_order:
            demand = p.demand[gi].astype(np.float64)
            placed = False
            for ni, node in enumerate(self.nodes):
                if self._try_place(pod, gi, demand, node, ni):
                    placed = True
                    break
            if placed:
                remaining[gi] -= 1
                continue
            units = units_cache.get(gi)
            if units is None:
                sd = size_d[gi].astype(np.float64)
                with np.errstate(divide="ignore", invalid="ignore"):
                    per_axis = np.where(
                        sd[None, :] > 0,
                        np.floor(p.alloc / np.maximum(sd[None, :], 1e-30) + 1e-9),
                        np.inf,
                    )
                units = np.min(per_axis, axis=1)
                units = np.where(np.isfinite(units), units, 0).astype(np.int64)
                if size_d is not p.demand:
                    # a reserve so large it zeroes a real fit degrades to one
                    # provider pod per node (max requirer headroom)
                    with np.errstate(divide="ignore", invalid="ignore"):
                        real_axis = np.where(
                            demand[None, :] > 0,
                            np.floor(p.alloc / np.maximum(demand[None, :], 1e-30) + 1e-9),
                            np.inf,
                        )
                    real_units = np.min(real_axis, axis=1)
                    real_units = np.where(np.isfinite(real_units), real_units, 0)
                    units = np.where((units == 0) & (real_units > 0), 1, units)
                units_cache[gi] = units
            want = max(remaining[gi], 1)
            with np.errstate(divide="ignore", invalid="ignore"):
                total = np.where(units > 0, -(-want // np.maximum(units, 1)) * p.price, np.inf)
            total = np.where(p.compat[gi], total, np.inf)
            # cheapest true cost first; larger capacity breaks ties
            opt_order = sorted(
                np.flatnonzero(np.isfinite(total)).tolist(),
                key=lambda j: (total[j], -int(units[j])),
            )
            for j in opt_order:
                node = _SimNode(
                    rem=p.alloc[j].astype(np.float64).copy(),
                    zone=p.options[j].zone,
                    option_index=j,
                )
                # must pass all constraint checks on the fresh node too
                self.nodes.append(node)
                if self._try_place(pod, gi, demand, node, len(self.nodes) - 1):
                    placed = True
                    break
                self.nodes.pop()
            if placed:
                remaining[gi] -= 1
            else:
                unschedulable.append(pod.name)

        new_nodes = [
            NewNodeSpec(option=p.options[n.option_index], pod_names=[q.name for q in n.pods])
            for n in self.nodes[self.n_existing:]
            if n.pods
        ]
        existing_assignments = {
            n.existing_name: [q.name for q in n.pods[self._seed_counts[i]:]]
            for i, n in enumerate(self.nodes[: self.n_existing])
            if len(n.pods) > self._seed_counts[i]
        }
        cost = float(sum(s.price for s in new_nodes))
        return SolveResult(
            new_nodes=new_nodes,
            existing_assignments=existing_assignments,
            unschedulable=unschedulable,
            cost=cost,
            stats={"backend": 0.0, "nodes_opened": float(len(new_nodes))},
        )
