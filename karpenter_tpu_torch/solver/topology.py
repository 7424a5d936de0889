"""TPU slice-topology model: ICI-coordinate offerings + torus hop metric.

A TPU slice is not a zone. Chips inside one "TPU pod" (an ICI domain) talk
over the inter-chip interconnect — a 3D torus whose per-hop latency is orders
of magnitude below the data-center network — while slices in different pods
(or zones) pay DCN prices for every all-reduce. The rank-aware MPI literature
("Rank-Aware Resource Scheduling for Tightly-Coupled MPI Workloads on
Kubernetes") prices exactly this: placement quality for a gang is the hop
distance between its ranks, not the number of zones it spans.

This module owns the topology vocabulary the rest of the stack shares:

* **Coordinates.** An offering (cloudprovider/types.Offering) may carry a
  ``slice_pod`` (ICI-domain id) and a torus ``slice_coord`` (x, y, z); nodes
  launched from it carry the same pair as ``karpenter.tpu/slice-*`` labels,
  so nodeSelector pinning, encoder node surfaces, and capsule replay all see
  one vocabulary. Everything is sparse: non-slice offerings/nodes are
  byte-identical to the pre-topology world.
* **Synthesis.** :func:`zone_torus` derives a deterministic per-zone torus
  layout (domain count + dims keyed on the zone name), and
  :func:`with_slice_topology` expands a catalog's accelerator offerings into
  per-coordinate offerings — the FakeCloudProvider/catalog analogue of a real
  TPU API's topology descriptors. Same zone, same layout, every process: the
  flight recorder's byte-equality depends on it.
* **Metric.** :func:`hop_distance` is the per-axis ring (torus Manhattan)
  metric inside a domain; cross-domain and cross-zone pairs pay the
  :data:`CROSS_POD_HOPS` / :data:`CROSS_ZONE_HOPS` DCN constants. The gang
  gate's adjacency replan scores plans by :func:`plan_hop_stats` mean hops
  and charges ``slice_hop_penalty_frac * mean_hops`` of the plan price —
  the hop-count penalty that replaces the earlier flat 10%-per-extra-zone
  scatter fraction when topology is enabled.
* **Compaction.** :func:`compact_window` picks the n-coordinate ball that
  minimizes pairwise hops; the replan remaps a domain-pinned plan's nodes
  onto it, so "gang admitted in one domain" also means "on adjacent slices".
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..api import labels as wk
from ..api.requirements import Requirement
from ..api.resources import GPU_TPU
from ..cloudprovider.types import InstanceType, Offering

Coord = Tuple[int, int, int]

#: DCN tax for gang members in the same zone but different ICI domains —
#: every cross-pod pair counts this many hops, dwarfing any intra-torus path
CROSS_POD_HOPS = 8
#: cross-AZ pairs pay double the cross-pod tax (the zone-scatter regime,
#: expressed in the hop vocabulary)
CROSS_ZONE_HOPS = 16

#: torus shapes a zone's ICI domains draw from (deterministic per zone)
_TORUS_SHAPES: Tuple[Coord, ...] = ((2, 2, 1), (2, 2, 2), (4, 2, 1), (4, 2, 2))

#: ICI domains synthesized per zone — two, so intra-zone cross-pod scatter
#: exists and adjacency has something to beat without leaving the zone
PODS_PER_ZONE = 2


def format_coord(coord: Coord) -> str:
    return "-".join(str(c) for c in coord)


def parse_coord(raw: str) -> Optional[Coord]:
    parts = raw.split("-")
    if len(parts) != 3:
        return None
    try:
        x, y, z = (int(p) for p in parts)
    except ValueError:
        return None
    return (x, y, z)


@dataclass(frozen=True)
class TorusSpec:
    """One zone's synthesized slice layout: ICI-domain ids sharing one torus
    shape. (Real fleets mix shapes; one shape per zone keeps the synthetic
    universe small while still exercising every metric path.)"""

    zone: str
    pods: Tuple[str, ...]
    dims: Coord

    def coords(self) -> List[Coord]:
        x, y, z = self.dims
        return [(i, j, k) for i in range(x) for j in range(y) for k in range(z)]


def zone_torus(zone: str, pods_per_zone: int = PODS_PER_ZONE) -> TorusSpec:
    """Deterministic torus layout for a zone: the shape is keyed on the zone
    NAME (sha256, like catalog price jitter), so every process — operator,
    bench, offline replay — synthesizes the identical layout."""
    h = int(hashlib.sha256(f"slice-torus/{zone}".encode()).hexdigest()[:8], 16)
    dims = _TORUS_SHAPES[h % len(_TORUS_SHAPES)]
    pods = tuple(f"{zone}/pod-{i}" for i in range(pods_per_zone))
    return TorusSpec(zone=zone, pods=pods, dims=dims)


def hop_distance(a: Coord, b: Coord, dims: Coord) -> int:
    """ICI hops between two coordinates of one torus: per-axis ring metric
    (wraparound links are what make it a torus, not a mesh)."""
    total = 0
    for ai, bi, di in zip(a, b, dims):
        if not di:
            continue
        d = abs(ai - bi) % di
        total += min(d, di - d)
    return total


def compact_window(
    n: int, dims: Coord, exclude: frozenset = frozenset()
) -> List[Coord]:
    """The n FREE coordinates of a torus forming the most compact ball
    (best anchor's nearest-n by hop distance, pairwise-hop tiebreak, then
    lexicographic — deterministic). ``exclude`` holds coordinates already
    occupied by live nodes: a physical slice hosts one node, so a second
    gang packed into a half-full domain must window around the occupants,
    not collide with them. Greedy anchor search is optimal enough for the
    tiny tori here: the replan only needs "adjacent", not "provably
    minimal". Returns fewer than n when the domain has fewer free slots."""
    x, y, z = dims
    free = sorted(
        c
        for c in (
            (i, j, k) for i in range(x) for j in range(y) for k in range(z)
        )
        if c not in exclude
    )
    if len(free) <= n:
        return free
    best: Optional[List[Coord]] = None
    best_score: Optional[Tuple[int, List[Coord]]] = None
    for anchor in free:
        cand = sorted(
            free, key=lambda c: (hop_distance(c, anchor, dims), c)
        )[:n]
        score = sum(
            hop_distance(a, b, dims)
            for i, a in enumerate(cand)
            for b in cand[i + 1:]
        )
        key = (score, sorted(cand))
        if best_score is None or key < best_score:
            best = cand
            best_score = key
    return best or []


# ---------------------------------------------------------------------------
# Catalog synthesis
# ---------------------------------------------------------------------------

def is_slice_type(it: InstanceType) -> bool:
    """Slice coordinates only make sense for TPU-accelerator instance types."""
    return it.capacity.get(GPU_TPU) > 0


def with_slice_topology(
    catalog: Sequence[InstanceType],
    pods_per_zone: int = PODS_PER_ZONE,
) -> List[InstanceType]:
    """Expand a catalog's TPU-type offerings into per-(ICI-domain, coordinate)
    offerings carrying slice identity, one per slice location per original
    (zone, capacity-type) offering — the "ICI-coordinate offerings" the
    adjacency-aware solver chooses between. Prices/availability are copied
    verbatim (a coordinate is not a price point; the pool price feed and ICE
    mask stay keyed on the (type, zone, ct) triple). Non-TPU types pass
    through unchanged (same objects — identity caches keep hitting).

    Deliberate width trade-off: coordinate-granular offerings multiply the
    TPU types' option columns by domains x torus size (price-equal columns
    the solver picks among arbitrarily, with remap_compact choosing the
    final coordinates). Domain-granular offerings would encode smaller, but
    the coordinate-specific option must EXIST in the round catalog for the
    remap/launch/replay identity chain (spec option -> machine requirement
    -> node labels -> capsule wire) to stay closed — and only TPU types pay
    the width, bounded by the tiny synthetic tori."""
    out: List[InstanceType] = []
    for it in catalog:
        if not is_slice_type(it):
            out.append(it)
            continue
        tori: Dict[str, TorusSpec] = {}
        offerings: List[Offering] = []
        domains: Set[str] = set()
        coords: Set[str] = set()
        for o in it.offerings:
            if o.slice_pod:  # already expanded
                offerings.append(o)
                domains.add(o.slice_pod)
                if o.slice_coord is not None:
                    coords.add(format_coord(o.slice_coord))
                continue
            torus = tori.get(o.zone)
            if torus is None:
                torus = tori[o.zone] = zone_torus(o.zone, pods_per_zone)
            for pod_id in torus.pods:
                domains.add(pod_id)
                for coord in torus.coords():
                    coords.add(format_coord(coord))
                    offerings.append(
                        Offering(
                            zone=o.zone,
                            capacity_type=o.capacity_type,
                            price=o.price,
                            available=o.available,
                            interruption_probability=o.interruption_probability,
                            slice_pod=pod_id,
                            slice_coord=coord,
                        )
                    )
        # the TYPE surface must declare the slice keys (In over every value it
        # offers) or a slice-pinned machine requirement would reject the type
        # outright at launch (In never tolerates absence)
        reqs = it.requirements.add(
            Requirement.in_values(wk.SLICE_POD, sorted(domains)),
            Requirement.in_values(wk.SLICE_COORD, sorted(coords)),
        )
        from dataclasses import replace

        out.append(replace(it, requirements=reqs, offerings=offerings))
    return out


def catalog_has_slices(
    provisioners: Sequence[Tuple[object, Sequence[InstanceType]]]
) -> bool:
    """Does any offering in the round's catalog carry slice coordinates?
    Cheap gate for the adjacency replan: a topology-enabled operator on a
    sliceless catalog must behave exactly like the zone-only model."""
    return any(
        o.slice_pod
        for _, types in provisioners
        for it in types
        for o in it.offerings
    )


# ---------------------------------------------------------------------------
# Plan scoring
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PlacePoint:
    """Where one gang-carrying node sits in the topology. ``coord`` is None
    for capacity without slice identity (non-TPU nodes) — such a point is
    cross-pod to everything, including other coordless points in its zone
    (no ICI link can be assumed between unlabeled hosts)."""

    zone: str
    slice_pod: str = ""
    coord: Optional[Coord] = None


def point_hops(a: PlacePoint, b: PlacePoint) -> int:
    if a.zone != b.zone:
        return CROSS_ZONE_HOPS
    if not a.slice_pod and not b.slice_pod:
        # two coordless nodes in one zone: the pre-topology baseline
        # charged single-zone plans nothing, and non-slice workloads must
        # keep that behavior under a topology-enabled operator
        return 0
    if not a.slice_pod or not b.slice_pod or a.slice_pod != b.slice_pod:
        return CROSS_POD_HOPS
    if a.coord is None or b.coord is None:
        return CROSS_POD_HOPS
    if a.coord == b.coord:
        # two DISTINCT nodes claiming one slice location is contention (a
        # physical slice hosts one node); scored as a cross-pod pair so the
        # compact remap — which always assigns distinct coordinates — wins
        return CROSS_POD_HOPS
    return hop_distance(a.coord, b.coord, zone_torus(a.zone).dims)


def plan_hop_stats(points: Sequence[PlacePoint]) -> Tuple[float, int]:
    """(mean, max) pairwise hop distance over a gang's placement points —
    the adjacency score. A single-node plan (or empty) scores (0.0, 0):
    every rank shares an ICI domain with itself."""
    n = len(points)
    if n < 2:
        return 0.0, 0
    total = 0
    worst = 0
    pairs = 0
    for i in range(n):
        for j in range(i + 1, n):
            h = point_hops(points[i], points[j])
            total += h
            worst = max(worst, h)
            pairs += 1
    return total / pairs, worst


def spec_point(option) -> PlacePoint:
    """Placement point of a solver LaunchOption / NewNodeSpec option."""
    return PlacePoint(
        zone=option.zone,
        slice_pod=getattr(option, "slice_pod", "") or "",
        coord=getattr(option, "slice_coord", None),
    )


def node_point(node) -> PlacePoint:
    """Placement point of an existing Node (slice identity from labels)."""
    return PlacePoint(
        zone=node.zone(), slice_pod=node.slice_pod(), coord=node.slice_coord()
    )


def candidate_domains(round_provs) -> List[Tuple[str, str]]:
    """(zone, ICI-domain) pairs any AVAILABLE slice offering can open a node
    in, ordered by the cheapest available price there (then name): the
    adjacency replan tries the most economical domains first — the same
    discipline as gang.candidate_zones."""
    best: Dict[Tuple[str, str], float] = {}
    for _prov, types in round_provs:
        for it in types:
            for o in it.offerings:
                if not o.available or not o.slice_pod:
                    continue
                key = (o.zone, o.slice_pod)
                cur = best.get(key)
                if cur is None or o.price < cur:
                    best[key] = o.price
    return sorted(best, key=lambda k: (best[k], k))


def remap_compact(specs, round_provs, occupied: frozenset = frozenset()) -> Optional[list]:
    """Rewrite a single-domain plan's nodes onto a compact coordinate window.

    ``specs`` are NewNodeSpecs whose options all share one (zone, domain).
    Coordinates within a domain are cost-equal (with_slice_topology copies
    the pool price to every coordinate), so the solver's coordinate choice is
    arbitrary — possibly K nodes on one coordinate. This picks the most
    compact K-coordinate ball of FREE locations (``occupied`` = coordinates
    live nodes already hold in this domain; a physical slice hosts one
    node) and rewrites each spec onto the coordinate-specific option, in
    deterministic (spec order x window order). Returns the remapped spec
    list, or None when the domain lacks free slots / a coordinate's option
    is missing from the round catalog (topology drifted mid-round: keep the
    solver's plan rather than invent options)."""
    from .result import NewNodeSpec

    if not specs:
        return []
    zone = specs[0].option.zone
    domain = specs[0].option.slice_pod
    dims = zone_torus(zone).dims
    window = compact_window(len(specs), dims, exclude=occupied)
    if len(window) < len(specs):
        return None  # more nodes than free slice locations: not remappable
    # option index over the round catalog: (prov, type, zone, ct, domain,
    # coord) -> the coordinate-specific offering's option is reconstructed
    # from the SAME offering objects build_options flattens, so the swapped
    # spec launches exactly like a solver-chosen one
    remapped = []
    for spec, coord in zip(specs, window):
        opt = spec.option
        if opt.slice_coord == coord:
            remapped.append(spec)
            continue
        target = None
        for _prov, types in round_provs:
            # by NAME, not identity: the encoder's content-keyed option
            # cache legitimately serves options embedding an equal-content
            # provisioner object from an earlier build
            if _prov.name != opt.provisioner.name:
                continue
            for it in types:
                if it.name != opt.instance_type.name:
                    continue
                for o in it.offerings:
                    if (
                        o.available
                        and o.zone == zone
                        and o.capacity_type == opt.capacity_type
                        and o.slice_pod == domain
                        and o.slice_coord == coord
                    ):
                        target = o
                        break
                if target is not None:
                    break
            if target is not None:
                break
        if target is None:
            return None
        import dataclasses

        from ..api.requirements import Requirements

        # REPLACE the slice keys, never intersect: the source option's
        # surface already carries In[<old coord>], and Requirements'
        # constructor intersects same-key requirements — add() would yield
        # an empty (unsatisfiable) SLICE_COORD set on the swapped surface
        new_reqs = Requirements(
            [
                r
                for r in opt.node_requirements
                if r.key not in (wk.SLICE_POD, wk.SLICE_COORD)
            ]
            + [
                Requirement.in_values(wk.SLICE_POD, [domain]),
                Requirement.in_values(wk.SLICE_COORD, [format_coord(coord)]),
            ]
        )
        new_opt = dataclasses.replace(
            opt,
            price=target.price,
            node_requirements=new_reqs,
            slice_pod=domain,
            slice_coord=coord,
        )
        remapped.append(
            NewNodeSpec(option=new_opt, pod_names=spec.pod_names, option_index=None)
        )
    return remapped
