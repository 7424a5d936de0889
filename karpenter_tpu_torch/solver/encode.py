"""Tensor encoders: pods / instance offerings / constraints -> device-ready arrays.

This replaces the reference scheduler's per-pod object walk
(``Scheduler.Solve()``, behavior at upstream ``designs/bin-packing.md:16-43``)
with a tensor encoding designed for the TPU:

* Pending pods are **deduplicated into groups** by full scheduling signature
  (requests, requirement terms, tolerations, spread, affinity, labels). Real fleets
  are deployment-shaped, so 50k pods typically collapse to tens-hundreds of groups —
  the solver scans groups, not pods, keeping the hot loop short and static-shaped.
* Instance types × zones × capacity-types flatten into **launch options** with an
  allocatable vector (minus daemonset overhead, as the reference accounts daemonsets
  per candidate node), a price, and an availability mask (the ICE cache surfaces
  here as unavailable offerings, upstream ``pkg/cache/unavailableofferings.go``).
* Constraint checks (requirements algebra, taints, zone) are precomputed into a
  boolean ``compat[G, O]`` mask — the requirements set-algebra runs once on host,
  never inside jit.

Assignment-dependent constraints (topology spread, anti-affinity) become per-group
scalar caps interpreted inside the packing scan (see ``torch_solver.py``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field, fields as dataclass_fields
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api import labels as wk
from ..api.objects import Node, Pod, Provisioner
from ..api.requirements import Requirement, Requirements
from ..api.resources import CPU, EPHEMERAL_STORAGE, MEMORY, PODS, Resources
from ..api.taints import Taint, tolerates_all
from ..cloudprovider.types import InstanceType
from ..native import load_encoder

BIG_CAP = 1 << 30  # "unlimited" per-node / per-zone count cap

# Serializes every encode (full or delta) process-wide: the module's memo
# caches (vocab codes, per-surface columns, option/table generations) are
# mutated by table builds, and the parallel consolidation sweep runs
# concurrent solve_pods calls whose encodes would otherwise race — two
# threads minting the same vocab string different codes silently corrupts
# compat masks. The solve itself (LP, FFD, kernel) runs OUTSIDE this lock,
# so the sweep's numpy/scipy work still parallelizes.
ENCODE_LOCK = threading.RLock()


# ---------------------------------------------------------------------------
# Pod grouping
# ---------------------------------------------------------------------------

@dataclass
class PodGroup:
    pods: List[Pod]
    requests: Resources  # per-pod requests
    terms: List[Requirements]  # OR'd requirement terms
    tolerations: tuple
    node_cap: int = BIG_CAP  # max pods of this group per node (hostname spread / anti-affinity)
    zone_cap: int = BIG_CAP  # max pods of this group per zone (zone anti-affinity)
    zone_skew: int = 0  # >0: zone topology-spread maxSkew (DoNotSchedule)
    colocate: bool = False  # required self pod-affinity on hostname

    @property
    def count(self) -> int:
        return len(self.pods)


_EMPTY: tuple = ()


def _sorted_items(d) -> tuple:
    """Canonical tuple of a (usually tiny) mapping without paying sorted() for
    the 0/1-entry cases that dominate real pod specs."""
    n = len(d)
    if n == 0:
        return _EMPTY
    if n == 1:
        return tuple(d.items())
    return tuple(sorted(d.items()))


def _items_t(d) -> tuple:
    """Insertion-ordered items tuple. Grouping keys tolerate order sensitivity:
    pods stamped from the same controller template serialize their maps in one
    order (k8s object maps are canonically sorted), and a key-order mismatch
    merely splits one group into two equivalent ones — never an incorrect
    grouping. Skipping sorted() here is ~40% of the 50k cold-encode budget."""
    return tuple(d.items()) if d else _EMPTY


def _spread_sig(c) -> tuple:
    """Per-constraint signature cached ON the constraint object: pods stamped
    from one controller template share constraint objects (and our own
    apiserver store hands out shared specs), so the sort+tuple work runs once
    per template instead of once per pod. Constraints are treated immutable
    after first encode, like the pod fields under ``_signature``."""
    s = c.__dict__.get("_sig")
    if s is None:
        s = (c.max_skew, c.topology_key, c.when_unsatisfiable,
             _sorted_items(c.label_selector))
        c.__dict__["_sig"] = s
    return s


def _aff_sig(t) -> tuple:
    s = t.__dict__.get("_sig")
    if s is None:
        s = (t.topology_key, t.anti, _sorted_items(t.label_selector))
        t.__dict__["_sig"] = s
    return s


def _signature(pod: Pod) -> tuple:
    """Scheduling-identity key, built from raw fields (no Requirements objects —
    that construction cost dominates 50k-pod encodes) and cached on the pod, so
    re-encoding the same pods across reconcile cycles is near-free. Every
    component short-circuits on the empty case: at 50k pods the difference
    between ~13us and ~3us per signature is the whole cold-encode budget.

    CONTRACT: pods are treated as immutable in their scheduling-relevant
    fields after first encode. Any code that mutates labels/requests/
    constraints in place MUST pop ``pod.__dict__['_sched_sig']`` (the
    relaxation machinery does; see Pod.relax_preferences)."""
    cached = pod.__dict__.get("_sched_sig")
    if cached is not None:
        return cached
    req_terms = _EMPTY
    if pod.required_affinity_terms:
        req_terms = tuple(
            tuple(sorted((r.key, r.complement, tuple(sorted(r.values)), r.greater_than, r.less_than)
                         for r in term))
            for term in pod.required_affinity_terms
        )
    soft = _EMPTY
    if pod.preferred_affinity_terms:
        soft = tuple(
            (w, tuple(sorted((r.key, r.complement, tuple(sorted(r.values)),
                              r.greater_than, r.less_than) for r in term)))
            for w, term in pod.active_preferred_terms()
        )
    vz = tuple(pod.volume_zones) if pod.volume_zones else _EMPTY
    tol = _EMPTY
    if pod.tolerations:
        tol = tuple(sorted((t.key, t.operator, t.value, t.effect) for t in pod.tolerations))
    spread = _EMPTY
    if pod.topology_spread:
        spread = tuple(sorted(_spread_sig(c) for c in pod.effective_spread()))
    aff = _EMPTY
    if pod.affinity_terms:
        aff = tuple(sorted(_aff_sig(t) for t in pod.affinity_terms))
    # Gang/priority/pool-policy component: a gang member (annotation-form
    # pod-group; the label form already rides the label surface), a
    # prioritized pod, or a spot-diversification carrier must never bucket
    # with an otherwise-identical plain pod — the gang gate's all-or-nothing
    # unit, the preemption planner's entitlement and the diversification
    # gate's per-group pool caps all key off group purity. Absent for the
    # plain-pod common case, so existing signatures (and problem digests)
    # are unchanged. The native encoder defers these pods to this function
    # (encoder.c: gang/priority/spot-div check).
    gang = _EMPTY
    ann = pod.meta.annotations
    if pod.priority or (
        ann
        and (
            wk.POD_GROUP in ann
            or wk.SPOT_DIVERSIFICATION in ann
            or wk.SLICE_ADJACENCY in ann
        )
    ):
        gang = (
            pod.priority,
            ann.get(wk.POD_GROUP, ""),
            ann.get(wk.POD_GROUP_MIN_MEMBERS, ""),
            ann.get(wk.SPOT_DIVERSIFICATION, ""),
            ann.get(wk.SLICE_ADJACENCY, ""),
        )
    sig = (
        _items_t(pod.requests.items_mapping()),
        _items_t(pod.node_selector),
        req_terms,
        tol,
        spread,
        aff,
        _items_t(pod.meta.labels),
        soft,
        vz,
    )
    if gang is not _EMPTY:
        sig = sig + (gang,)
    pod.__dict__["_sched_sig"] = sig
    return sig


def _group_members(pods: Sequence[Pod]) -> List[List[Pod]]:
    """Bucket pods by scheduling signature, first-seen order. Uses the native
    C hot loop (karpenter_tpu_torch/native/encoder.c) when it builds — the
    per-pod signature walk is the 50k cold-encode bottleneck — with this
    pure-Python loop as the behavioral reference and fallback."""
    enc = load_encoder()
    if enc is not None:
        return enc.group_pods(list(pods), _signature)
    buckets: Dict[tuple, List[Pod]] = {}
    member_lists: List[List[Pod]] = []
    for pod in pods:
        sig = _signature(pod)
        members = buckets.get(sig)
        if members is None:
            members = buckets[sig] = []
            member_lists.append(members)
        members.append(pod)
    return member_lists


def derive_group(members: List[Pod]) -> PodGroup:
    """One signature bucket -> PodGroup with the per-group placement caps
    derived from the representative's spread/affinity constraints (members
    are scheduling-identical, so any representative derives the same caps)."""
    pod = members[0]
    node_cap = BIG_CAP
    zone_cap = BIG_CAP
    zone_skew = 0
    colocate = False
    for c in pod.effective_spread():
        if not c.selects(pod):
            continue
        if c.topology_key == wk.HOSTNAME:
            # Conservative: capping each node at maxSkew keeps |max-min| <= skew
            # for any node population (min can stay 0 on fresh nodes).
            node_cap = min(node_cap, max(1, c.max_skew))
        elif c.topology_key == wk.ZONE:
            # TIGHTEST applicable skew: every constraint (hard and
            # promoted-soft) is validated independently, so the quota must
            # honor the strictest one, not the loosest
            zone_skew = c.max_skew if zone_skew == 0 else min(zone_skew, c.max_skew)
    for t in pod.affinity_terms:
        if not t.selects(pod):
            continue  # cross-group affinity handled only by the greedy fallback
        if t.anti and t.topology_key == wk.HOSTNAME:
            node_cap = min(node_cap, 1)
        elif t.anti and t.topology_key == wk.ZONE:
            # at most one pod of the group per zone
            node_cap = min(node_cap, 1)
            zone_cap = min(zone_cap, 1)
        elif not t.anti and t.topology_key == wk.HOSTNAME:
            colocate = True
    return PodGroup(
        pods=members,
        requests=pod.requests,
        terms=pod.scheduling_requirement_terms(),  # representative only
        tolerations=tuple(pod.tolerations),
        node_cap=node_cap,
        zone_cap=zone_cap,
        zone_skew=zone_skew,
        colocate=colocate,
    )


def group_pods(pods: Sequence[Pod]) -> List[PodGroup]:
    """Deduplicate pods into scheduling-identical groups and derive the per-group
    placement caps from spread/affinity constraints."""
    return [derive_group(members) for members in _group_members(pods)]


# ---------------------------------------------------------------------------
# Launch options
# ---------------------------------------------------------------------------

@dataclass
class LaunchOption:
    """One concrete way to open a node: (provisioner, instance type, zone, capacity type)."""

    provisioner: Provisioner
    instance_type: InstanceType
    zone: str
    capacity_type: str
    price: float  # the REAL hourly price (billing, savings, reports)
    node_requirements: Requirements  # label surface the resulting node will carry
    taints: Tuple[Taint, ...]
    allocatable: Resources  # after daemonset overhead
    # capacity-pool risk axis: the offering's interruption-probability
    # estimate and its expected-interruption cost (p * penalty). The solver
    # objective is price + risk_cost; ``price`` itself stays the real price
    # so launch decisions, consolidation savings and audit records report
    # what the cluster actually pays.
    interruption_probability: float = 0.0
    risk_cost: float = 0.0
    # TPU slice-topology axis (solver/topology.py): the ICI domain and torus
    # coordinate of the offering's chips. Sparse — ""/None on every
    # non-slice option, so legacy encodes are untouched; the gang gate's
    # adjacency replan scores gang plans by the hop distance between these.
    slice_pod: str = ""
    slice_coord: Optional[tuple] = None

    @property
    def effective_price(self) -> float:
        return self.price + self.risk_cost

    @property
    def pool(self) -> tuple:
        return (self.instance_type.name, self.zone, self.capacity_type)


_options_cache: Dict[tuple, tuple] = {}
_table_cache: Dict[int, tuple] = {}


def _get_option_table(options: List[LaunchOption]) -> "_ReqTable":
    """Requirement table for an option list, cached by list identity (the
    options cache returns the same list object until inputs change)."""
    entry = _table_cache.get(id(options))
    if entry is not None and entry[0] is options and entry[2] == _VOCAB_GEN:
        return entry[1]
    table = _ReqTable([o.node_requirements for o in options])
    _table_cache.clear()
    _table_cache[id(options)] = (options, table, _VOCAB_GEN)
    return table


def build_options(
    provisioners: Sequence[Tuple[Provisioner, Sequence[InstanceType]]],
    daemonsets: Sequence[Pod] = (),
    risk_penalty: float = 0.0,
) -> List[LaunchOption]:
    """Flatten (provisioner x instance type x available offering) into launch options.

    The daemonset overhead of each option is subtracted up front, mirroring how the
    reference's scheduler accounts daemonset resources per candidate node
    (designs/bin-packing.md; website concepts/scheduling.md 'daemonsets').

    Results are cached per (provisioner identity, instance-type list identity,
    daemonset identity) — the analogue of the reference's seqnum-keyed
    instance-type caches (``pkg/providers/instancetype/instancetype.go:95-107``):
    providers return the SAME list object until something changes, so warm
    reconcile cycles skip the whole flatten.
    """
    key = (
        tuple(
            (id(p), p.meta.resource_version, id(types))
            for p, types in provisioners
        ),
        tuple(id(d) for d in daemonsets),
        risk_penalty,  # the penalty scales every option's risk_cost
    )
    cached = _options_cache.get(key)
    if (
        cached is not None
        and all(
            co[0] is p and co[1] is t
            for co, (p, t) in zip(cached[0], provisioners)
        )
        # pin + re-verify daemonset identity too: id() alone can be recycled
        # onto a different pod after GC, silently serving stale overhead
        and len(cached[1]) == len(daemonsets)
        and all(cd is d for cd, d in zip(cached[1], daemonsets))
    ):
        return cached[2]
    # Identity miss (fresh objects): fall back to CONTENT equality — a
    # provider may rebuild its instance-type lists with identical data (cache
    # invalidation, process restart), and re-flattening 2310 offerings plus
    # rebuilding the requirement table costs ~50ms the launch options don't
    # actually depend on. The content key covers everything the options are
    # built from: type spec surface + offerings + provisioner generation.
    ckey = _options_content_key(provisioners, daemonsets) + (risk_penalty,)
    ccached = _options_content_cache.get(ckey)
    if ccached is not None:
        # refresh the identity cache so the NEXT call hits the cheap path
        _options_cache.clear()
        _options_cache[key] = (
            [(p, t) for p, t in provisioners],
            list(daemonsets),
            ccached,
        )
        return ccached

    options: List[LaunchOption] = []
    offering_reqs: Dict[tuple, Requirements] = {}  # (zone, ct, prov) interning
    for provisioner, instance_types in provisioners:
        prov_reqs = provisioner.requirements.intersect(
            Requirements.from_labels(provisioner.labels)
        )
        taints = tuple(provisioner.taints)
        for it in instance_types:
            merged = it.requirements.intersect(prov_reqs)
            if merged.is_empty_any():
                continue
            alloc = it.allocatable()
            zone_req = merged.get(wk.ZONE)
            ct_req = merged.get(wk.CAPACITY_TYPE)
            for offering in it.offerings:
                if not offering.available:
                    continue
                if not zone_req.has(offering.zone):
                    continue
                if not ct_req.has(offering.capacity_type):
                    continue
                okey = (
                    offering.zone, offering.capacity_type, provisioner.name,
                    offering.slice_pod, offering.slice_coord,
                )
                oreq = offering_reqs.get(okey)
                if oreq is None:
                    reqs = [
                        Requirement.in_values(wk.ZONE, [offering.zone]),
                        Requirement.in_values(wk.CAPACITY_TYPE, [offering.capacity_type]),
                        Requirement.in_values(wk.PROVISIONER_NAME, [provisioner.name]),
                    ]
                    if offering.slice_pod:
                        # slice identity rides the node label surface: a
                        # slice-pinned pod (nodeSelector on the slice keys)
                        # is compatible with exactly its domain's options
                        from .topology import format_coord

                        reqs.append(
                            Requirement.in_values(wk.SLICE_POD, [offering.slice_pod])
                        )
                        if offering.slice_coord is not None:
                            reqs.append(
                                Requirement.in_values(
                                    wk.SLICE_COORD,
                                    [format_coord(offering.slice_coord)],
                                )
                            )
                    oreq = Requirements(reqs)
                    offering_reqs[okey] = oreq
                node_reqs = merged.intersect(oreq)
                if daemonsets:
                    ds = _daemonset_overhead(daemonsets, node_reqs, taints, alloc)
                    effective = alloc if ds.is_zero() else (alloc - ds).clamp_min_zero()
                else:
                    effective = alloc
                options.append(
                    LaunchOption(
                        provisioner=provisioner,
                        instance_type=it,
                        zone=offering.zone,
                        capacity_type=offering.capacity_type,
                        price=offering.price,
                        node_requirements=node_reqs,
                        taints=taints,
                        allocatable=effective,
                        interruption_probability=offering.interruption_probability,
                        risk_cost=offering.interruption_probability * risk_penalty,
                        slice_pod=offering.slice_pod,
                        slice_coord=offering.slice_coord,
                    )
                )
    _options_cache.clear()  # hold one generation; stale keys pin dead objects
    _options_cache[key] = (
        [(p, t) for p, t in provisioners],
        list(daemonsets),
        options,
    )
    _options_content_cache.clear()
    _options_content_cache[ckey] = options
    return options


_options_content_cache: Dict[tuple, list] = {}


def _options_content_key(
    provisioners: Sequence[Tuple[Provisioner, Sequence[InstanceType]]],
    daemonsets: Sequence[Pod],
) -> tuple:
    """Value-equality key over everything build_options reads: per type the
    name + capacity + offering tuples, per provisioner its generation, and
    the daemonsets' scheduling signatures (their overhead feeds allocatable).
    ~3ms at 400 types — vs ~50ms of re-flattening it guards."""
    prov_part = []
    for p, types in provisioners:
        type_part = tuple(_type_sig(it) for it in types)
        prov_part.append((_provisioner_sig(p), type_part))
    ds_part = tuple(_signature(d) for d in daemonsets)
    return (tuple(prov_part), ds_part)


def _type_sig(it: InstanceType) -> tuple:
    """Value signature of one InstanceType, stashed on the object and
    validated against the identity of every component it reads (requirements,
    offerings, capacity, overhead — all replaced wholesale on change via
    ``with_offerings``/``dataclasses.replace``, Offering itself frozen). A
    catalog provider that serves cached InstanceType objects then pays ~a dict
    lookup per type for the whole content key instead of re-flattening
    requirements and offerings every encode."""
    cached = it.__dict__.get("_content_sig")
    if (
        cached is not None
        and cached[0] is it.requirements
        and cached[1] is it.capacity
        and cached[2] is it.overhead
        and len(cached[3]) == len(it.offerings)
        and all(a is b for a, b in zip(cached[3], it.offerings))
    ):
        return cached[4]
    sig = (
        it.name,
        tuple(sorted(it.capacity.items())),
        # allocatable folds in the overhead math — a changed
        # kube-reserved/eviction threshold MUST miss the cache
        tuple(sorted(it.allocatable().items())),
        tuple(
            sorted(
                (r.key, r.complement, tuple(sorted(r.values)),
                 r.greater_than, r.less_than)
                for r in it.requirements
            )
        ),
        tuple(
            (o.zone, o.capacity_type, o.price, o.available,
             o.interruption_probability, o.slice_pod, o.slice_coord)
            for o in it.offerings
        ),
    )
    it.__dict__["_content_sig"] = (
        it.requirements, it.capacity, it.overhead, tuple(it.offerings), sig,
    )
    return sig


def _provisioner_sig(p: Provisioner) -> tuple:
    """Value signature over EVERY Provisioner field a cached LaunchOption's
    embedded provisioner object is later read for (requirements/labels/taints
    at option build; weight at the gate; kubelet/startupTaints/limits/
    node_template_ref at launch) — a content hit must be safe to serve to all
    of them."""
    req_sig = tuple(
        sorted(
            (r.key, r.complement, tuple(sorted(r.values)), r.greater_than, r.less_than)
            for r in p.requirements
        )
    )
    return (
        p.name,
        p.weight,
        req_sig,
        tuple(sorted(p.labels.items())),
        tuple(t.as_tuple() for t in p.taints),
        tuple(t.as_tuple() for t in p.startup_taints),
        _kubelet_sig(p.kubelet),
        tuple(sorted(p.limits.items())) if p.limits is not None else None,
        p.consolidation_enabled,
        p.ttl_seconds_after_empty,
        p.ttl_seconds_until_expired,
        p.node_template_ref,
    )


def _kubelet_sig(kc) -> tuple:
    """Every KubeletConfiguration field, rendered hashable generically so a
    future field addition is covered automatically (the cached provisioner's
    whole kubelet object rides onto launched Machines)."""
    out = []
    for f in dataclass_fields(kc):
        v = getattr(kc, f.name)
        if isinstance(v, dict):
            v = tuple(sorted(v.items()))
        elif isinstance(v, list):
            v = tuple(v)
        elif isinstance(v, Resources):
            v = tuple(sorted(v.items()))
        out.append((f.name, v))
    return tuple(out)


def _daemonset_overhead(
    daemonsets: Sequence[Pod], node_reqs: Requirements, taints: Tuple[Taint, ...], alloc: Resources
) -> Resources:
    total = Resources()
    for ds in daemonsets:
        if not tolerates_all(list(ds.tolerations), taints):
            continue
        if not any(node_reqs.compatible(term) for term in ds.scheduling_requirement_terms()):
            continue
        if not ds.requests.fits(alloc):
            continue
        total = total + ds.requests + Resources(pods=1)
    return total


# ---------------------------------------------------------------------------
# Vectorized requirement evaluation
# ---------------------------------------------------------------------------

_VOCAB: Dict[str, int] = {}  # process-wide string->code table for label values
_VOCAB_GEN = 0  # bumped when the vocab is compacted; tables built against an
# older generation must not be reused (their code arrays reference dead ids)
_VOCAB_MAX = 1 << 20  # compaction bound: hostname-valued labels are unbounded
# in a long-lived operator (advisor round-2 finding)


def _code(value: str) -> int:
    c = _VOCAB.get(value)
    if c is None:
        c = len(_VOCAB)
        _VOCAB[value] = c
    return c


def _maybe_compact_vocab() -> None:
    """Compact the vocab at a BUILD BOUNDARY only — clearing mid-build would
    mix code generations inside one table (stale codes numerically colliding
    with fresh ones), silently corrupting compat masks."""
    global _VOCAB_GEN
    if len(_VOCAB) >= _VOCAB_MAX:
        _VOCAB.clear()
        _VOCAB_GEN += 1
        _table_cache.clear()
        _surface_cols.clear()
        _ex_table_cache.clear()
        _value_props.clear()  # entries embed vocab codes


_surface_cols: Dict[int, tuple] = {}  # id(surface) -> (pin, vocab gen, cols)
_SURFACE_COLS_MAX = 200_000  # bound: one entry per live interned surface

_value_props: Dict[str, tuple] = {}


def _make_value_props(v: str) -> tuple:
    """(cplx, code, num) for a singleton value, memoized per VALUE string:
    label values repeat across thousands of surfaces, and the numeric parse
    costs a raised ValueError for every non-numeric value — ~45% of a
    first-contact 1,500-node surface-table build before this memo."""
    props = _value_props.get(v)
    if props is None:
        try:
            num = float(int(v))
        except ValueError:
            num = np.nan
        props = (False, _code(v), num)
        if len(_value_props) >= _VOCAB_MAX:
            _value_props.clear()
        _value_props[v] = props
    return props


def _surface_columns(reqs: Requirements) -> list:
    """Column contributions of one requirement surface: [(key, (cplx, code,
    num))]. Memoized by surface identity so a _ReqTable rebuild over N mostly
    unchanged surfaces (the per-reconcile existing-node roster, the launch
    options of an unchanged catalog) is a dict hit per surface instead of
    re-deriving singleton codes requirement by requirement. Entries embed
    vocab codes, so a compaction invalidates them (generation check)."""
    e = _surface_cols.get(id(reqs))
    if e is not None and e[0] is reqs and e[1] == _VOCAB_GEN:
        return e[2]
    cols = []
    # friend access to the keyed dict: the public iterator + single_value()
    # per requirement costs ~2x this whole loop at 3,810-surface first
    # contact (complement/multi-value checks inlined)
    for key, r in reqs._by_key.items():
        vals = r.values
        if not r.complement and len(vals) == 1:
            props = _make_value_props(next(iter(vals)))
        else:
            props = (True, -1, np.nan)
        cols.append((key, props))
    if len(_surface_cols) >= _SURFACE_COLS_MAX:
        _surface_cols.clear()
    _surface_cols[id(reqs)] = (reqs, _VOCAB_GEN, cols)
    return cols


class _ReqTable:
    """Column-oriented view of N requirement surfaces (launch options or nodes)
    for vectorized compatibility checks.

    Per label key: ``has[N]`` (key defined), ``codes[N]`` (singleton-In value
    code, -1 otherwise), ``nums[N]`` (numeric value for Gt/Lt, NaN otherwise),
    ``cplx[N]`` (defined but not a singleton In — NotIn/multi-value sets fall
    back to the exact set-algebra per entry). Replaces N x G python
    ``Requirements.compatible`` calls with a handful of numpy ops per group.
    """

    def __init__(self, surfaces: Sequence[Requirements]):
        self.n = len(surfaces)
        self.surfaces = list(surfaces)
        self.keys: Dict[str, tuple] = {}
        # Per-surface column contributions are memoized module-wide
        # (_surface_columns): surfaces are heavily shared AND stable across
        # encodes (interned node surfaces, cached launch options), so a warm
        # rebuild is a dict hit per surface plus the vectorized scatter below.
        per_key: Dict[str, tuple] = {}  # key -> (idx list, props list)
        for i, reqs in enumerate(surfaces):
            for key, props in _surface_columns(reqs):
                bucket = per_key.get(key)
                if bucket is None:
                    bucket = per_key[key] = ([], [])
                bucket[0].append(i)
                bucket[1].append(props)
        for key, (idxs, props) in per_key.items():
            has = np.zeros(self.n, bool)
            codes = np.full(self.n, -1, np.int64)
            nums = np.full(self.n, np.nan)
            cplx = np.zeros(self.n, bool)
            idx = np.asarray(idxs, np.int64)
            cplx_v, code_v, num_v = zip(*props)
            has[idx] = True
            codes[idx] = np.asarray(code_v, np.int64)
            nums[idx] = np.asarray(num_v, np.float64)
            cplx[idx] = np.asarray(cplx_v, bool)
            self.keys[key] = (has, codes, nums, cplx)

    def without_index(self, k: int) -> "_ReqTable":
        """A new table over the same surfaces minus entry ``k`` — a handful
        of np.delete column slices instead of a full rebuild. The
        consolidation sweep evaluates N rosters that are each the full
        fleet minus one candidate; deriving them from one full-roster table
        removes the per-simulation rebuild from the encode hot path."""
        t = _ReqTable.__new__(_ReqTable)
        t.n = self.n - 1
        t.surfaces = self.surfaces[:k] + self.surfaces[k + 1:]
        t.keys = {
            key: tuple(np.delete(a, k) for a in arrs)
            for key, arrs in self.keys.items()
        }
        return t

    def eval_requirement(self, r: Requirement) -> np.ndarray:
        """ok[N]: can an entry's surface co-exist with requirement ``r``?"""
        entry = self.keys.get(r.key)
        if entry is None:
            return np.full(self.n, r.tolerates_absence())
        has, codes, nums, cplx = entry
        out = np.full(self.n, r.tolerates_absence())
        value_codes = np.array(
            [_VOCAB[v] for v in r.values if v in _VOCAB], dtype=np.int64
        )
        base = np.isin(codes, value_codes)
        if r.complement:
            base = ~base
            if r.greater_than != float("-inf") or r.less_than != float("inf"):
                with np.errstate(invalid="ignore"):
                    base &= (nums > r.greater_than) & (nums < r.less_than)
        sel = has & ~cplx
        out[sel] = base[sel]
        if cplx.any():
            for i in np.flatnonzero(cplx):
                ours = self.surfaces[i].get(r.key)
                out[i] = not ours.intersect(r).is_empty()
        return out

    def eval_terms(self, terms: Sequence[Requirements]) -> np.ndarray:
        """ok[N]: OR over terms of AND over each term's requirements."""
        if not terms:
            return np.ones(self.n, bool)
        out = np.zeros(self.n, bool)
        for term in terms:
            ok = np.ones(self.n, bool)
            for r in term:
                ok &= self.eval_requirement(r)
                if not ok.any():
                    break
            out |= ok
            if out.all():
                break
        return out


# ---------------------------------------------------------------------------
# Existing (in-flight) capacity
# ---------------------------------------------------------------------------

_ex_table_cache: Dict[tuple, tuple] = {}  # surface-id roster -> (pins, table, gen)
_ex_table_base: Optional[tuple] = None  # (pins, table, gen): last FULLY-built table


def _get_surface_table(surfaces: Sequence[Requirements]) -> "_ReqTable":
    """Requirement table over the existing-node roster, cached by the ordered
    tuple of surface identities. Node surfaces are interned by name
    (_node_surface), so an unchanged roster — the common consecutive-reconcile
    case, including a re-listed set of value-equal Node objects — hits without
    rebuilding; any add/remove/label-change produces a different key and
    rebuilds from the per-surface column memo (delta cost, not full re-derive).
    One-generation cache, like _options_cache: stale keys would pin dead
    surface objects.

    A second BASE slot keeps the last fully-built table: a roster that is the
    base minus exactly one entry (every consolidation-sweep simulation) is
    DERIVED by column deletion instead of rebuilt — the base survives the
    one-generation churn of the per-roster slot, so a 160-candidate sweep
    builds one table and derives 160."""
    global _ex_table_base
    key = tuple(map(id, surfaces))
    e = _ex_table_cache.get(key)
    if (
        e is not None
        and e[2] == _VOCAB_GEN
        and all(a is b for a, b in zip(e[0], surfaces))
    ):
        return e[1]
    table = None
    base = _ex_table_base
    if base is not None and base[2] == _VOCAB_GEN and len(base[0]) == len(surfaces) + 1:
        pins = base[0]
        missing = -1
        j = 0
        for i, p in enumerate(pins):
            if j < len(surfaces) and p is surfaces[j]:
                j += 1
            elif missing < 0:
                missing = i
            else:
                missing = -1  # more than one difference: no derivation
                break
        if missing >= 0 and j == len(surfaces):
            table = base[1].without_index(missing)
    if table is None:
        table = _ReqTable(surfaces)
        _ex_table_base = (list(surfaces), table, _VOCAB_GEN)
    _ex_table_cache.clear()
    _ex_table_cache[key] = (list(surfaces), table, _VOCAB_GEN)
    return table


@dataclass
class ExistingNode:
    node: Node
    remaining: Resources  # allocatable minus bound pod requests (incl. daemonsets)
    # Pods already bound to the node: they seed topology domain counts (zone
    # spread levels, hostname anti-affinity occupancy) so a second
    # provisioning cycle can't violate DoNotSchedule constraints the first
    # cycle satisfied. The reference's scheduler seeds its topology tracker
    # from the cluster the same way.
    pods: Tuple[Pod, ...] = ()

    @property
    def name(self) -> str:
        return self.node.name


# ---------------------------------------------------------------------------
# The encoded problem
# ---------------------------------------------------------------------------

@dataclass
class EncodedProblem:
    groups: List[PodGroup]
    options: List[LaunchOption]
    existing: List[ExistingNode]
    resource_axes: List[str]
    zones: List[str]
    # arrays (numpy, host-side; the solver moves them to device)
    demand: np.ndarray  # [G, R] float32, per-pod demand
    count: np.ndarray  # [G] int32
    alloc: np.ndarray  # [O, R] float32
    price: np.ndarray  # [O] float32
    opt_zone: np.ndarray  # [O] int32
    compat: np.ndarray  # [G, O] bool
    node_cap: np.ndarray  # [G] int32
    zone_cap: np.ndarray  # [G] int32
    zone_skew: np.ndarray  # [G] int32
    colocate: np.ndarray  # [G] bool
    ex_rem: np.ndarray  # [E, R] float32
    ex_zone: np.ndarray  # [E] int32
    ex_compat: np.ndarray  # [G, E] bool
    # Cluster-wide topology seeds from already-bound pods (None when E==0 or
    # no group carries topology constraints): spread domain counts, zone
    # anti-affinity occupancy, and the raw (host, zone, pod) list the
    # validator re-checks constraints against.
    zone_seed: Optional[np.ndarray] = None  # [G, Z] int32 spread-selector matches
    zone_occupied: Optional[np.ndarray] = None  # [G, Z] int32 anti-selector matches
    seed_pods: List[tuple] = field(default_factory=list)  # (host, zone, Pod)
    # group indices whose compat was actually NARROWED by the provisioner
    # weight gate — the degate fallback only makes sense for these
    weight_gated_groups: List[int] = field(default_factory=list)
    # Cross-group relation bits (round-4 verdict item 1): per-term presence
    # bitmasks let the kernel enforce pod (anti-)affinity whose selector
    # matches OTHER groups' labels (and bound pods). All-zero when no
    # cross-group terms exist. See _build_relations for the bit protocol.
    rel_set: Optional[np.ndarray] = None  # [G] i32 bits a placement sets on its domain
    rel_host_forbid: Optional[np.ndarray] = None  # [G] i32 node bits that forbid placement
    rel_host_need: Optional[np.ndarray] = None  # [G] i32 node bits ALL required
    rel_zone_forbid: Optional[np.ndarray] = None  # [G] i32
    rel_zone_need: Optional[np.ndarray] = None  # [G] i32
    rel_slot_bits: Optional[np.ndarray] = None  # [E] i32 seed bits per existing node
    rel_zone_bits: Optional[np.ndarray] = None  # [Z] i32 seed bits per zone
    rel_layer: Optional[np.ndarray] = None  # [G] i32 scan-order layer (providers first)
    rel_unsupported: Optional[str] = None  # reason the tensor path must defer to the oracle
    # Per-group member lists of the first hard zone-spread constraint's
    # selector (which groups it counts, incl. self) — joint quota families
    zone_spread_members: List[List[int]] = field(default_factory=list)

    @property
    def G(self) -> int:
        return len(self.groups)

    @property
    def O(self) -> int:
        return len(self.options)

    @property
    def E(self) -> int:
        return len(self.existing)


def _resource_axes(groups: Sequence[PodGroup], options: Sequence[LaunchOption]) -> List[str]:
    axes = [CPU, MEMORY, PODS]
    extra = set()
    for g in groups:
        extra.update(g.requests.keys())
    for axis in (EPHEMERAL_STORAGE,):
        if axis in extra:
            axes.append(axis)
    for name in sorted(extra - set(axes) - {EPHEMERAL_STORAGE}):
        axes.append(name)
    return axes


def _vector(r: Resources, axes: Sequence[str], pods: float = 0.0) -> np.ndarray:
    v = np.array([r.get(a) for a in axes], dtype=np.float64)
    pods_idx = axes.index(PODS)
    v[pods_idx] = max(v[pods_idx], pods)
    return v


_opt_zone_set_cache: Dict[int, tuple] = {}  # id(options) -> (pin, zone set)


def _option_zone_set(options: Sequence[LaunchOption]) -> set:
    """Zone set of an option list, cached by list identity (the options
    builder returns the same list object until inputs change; a steady-state
    delta encode calls this every round)."""
    e = _opt_zone_set_cache.get(id(options))
    if e is not None and e[0] is options:
        return e[1]
    zones = {o.zone for o in options}
    _opt_zone_set_cache.clear()
    _opt_zone_set_cache[id(options)] = (options, zones)
    return zones


def zone_list(
    options: Sequence[LaunchOption], existing: Sequence[ExistingNode]
) -> List[str]:
    return sorted(
        _option_zone_set(options)
        | {e.node.zone() for e in existing if e.node.zone()}
    )


def _group_arrays(groups: Sequence[PodGroup], axes: Sequence[str]):
    """Per-group tensor rows (demand, count, topology caps)."""
    G, R = len(groups), len(axes)
    demand = np.zeros((G, R), dtype=np.float64)
    count = np.zeros((G,), dtype=np.int32)
    node_cap = np.zeros((G,), dtype=np.int64)
    zone_cap = np.zeros((G,), dtype=np.int64)
    zone_skew = np.zeros((G,), dtype=np.int32)
    colocate = np.zeros((G,), dtype=bool)
    for i, g in enumerate(groups):
        demand[i] = _vector(g.requests, axes, pods=1.0)
        count[i] = g.count
        node_cap[i] = min(g.node_cap, BIG_CAP)
        zone_cap[i] = min(g.zone_cap, BIG_CAP)
        zone_skew[i] = g.zone_skew
        colocate[i] = g.colocate
    return demand, count, node_cap, zone_cap, zone_skew, colocate


_opt_array_cache: Dict[tuple, tuple] = {}  # (id(options), axes, zones) -> arrays


def _option_arrays(
    options: Sequence[LaunchOption], axes: Sequence[str], zone_index: Dict[str, int]
):
    """Per-option tensors (alloc/price/zone), cached by (option-list
    identity, axes, zone order): a consolidation sweep encodes hundreds of
    problems against the SAME cached option list, and this loop was ~1/3 of
    each simulation's encode before the cache. Returned arrays are shared —
    callers must not mutate them (encode stages treat them as inputs; the
    only writes happen on the float32 copies _finalize makes)."""
    key = (id(options), tuple(axes), tuple(sorted(zone_index, key=zone_index.get)))
    e = _opt_array_cache.get(key)
    if e is not None and e[0] is options:
        return e[1]
    O, R = len(options), len(axes)
    alloc = np.zeros((O, R), dtype=np.float64)
    price = np.zeros((O,), dtype=np.float64)
    opt_zone = np.zeros((O,), dtype=np.int32)
    for j, o in enumerate(options):
        alloc[j] = _vector(o.allocatable, axes)
        # the solve OBJECTIVE is the risk-adjusted effective price: the real
        # price plus the expected-interruption penalty (0 when risk is off),
        # so a cheap-but-reclaimable spot pool loses to a slightly pricier
        # stable one exactly when the expected disruption cost says it should
        price[j] = o.price + o.risk_cost
        opt_zone[j] = zone_index[o.zone]
    _opt_array_cache.clear()
    _opt_array_cache[key] = (options, (alloc, price, opt_zone))
    return alloc, price, opt_zone


_opt_weight_cache: Dict[int, tuple] = {}  # id(options) -> (pin, weights)


def _option_weights(options: Sequence[LaunchOption]) -> np.ndarray:
    """Per-option provisioner weights, cached by list identity — the gate
    reads them every encode and the list is identity-stable between option
    rebuilds."""
    e = _opt_weight_cache.get(id(options))
    if e is not None and e[0] is options:
        return e[1]
    w = np.array([o.provisioner.weight for o in options], np.int64)
    _opt_weight_cache.clear()
    _opt_weight_cache[id(options)] = (options, w)
    return w


def _taint_index(options: Sequence[LaunchOption]) -> Dict[tuple, np.ndarray]:
    """Option indices bucketed by taint tuple: taints come from the
    provisioner, so distinct tuples are few — one tolerates_all() call per
    (group, taint-set) instead of per (group, option)."""
    taint_groups: Dict[tuple, list] = {}
    for j, o in enumerate(options):
        taint_groups.setdefault(o.taints, []).append(j)
    return {t: np.asarray(idx) for t, idx in taint_groups.items()}


def _compat_row(
    g: PodGroup,
    opt_table: "_ReqTable",
    taint_index: Dict[tuple, np.ndarray],
    alloc: np.ndarray,
    axes: Sequence[str],
) -> np.ndarray:
    """PRE-weight-gate compatibility of one group against every option."""
    O = alloc.shape[0]
    tol_ok = np.zeros(O, bool)
    tols = list(g.tolerations)
    for taints, idx in taint_index.items():
        if tolerates_all(tols, taints):
            tol_ok[idx] = True
    req_ok = opt_table.eval_terms(g.terms)
    per_pod = _vector(g.requests, axes, pods=1.0)
    cap_ok = ~np.any(per_pod[None, :] > alloc + 1e-9, axis=1)
    return tol_ok & req_ok & cap_ok


def _req_class_key(g: PodGroup) -> Optional[tuple]:
    """Content key of everything ``scheduling_requirement_terms`` derives
    from, read off the representative's cached scheduling signature:
    (node_selector, required terms, active soft terms, volume zones). Groups
    whose reps share these four components provably build value-identical
    ``terms``, so one requirement-table evaluation serves them all. None when
    the signature is not cached (the caller then evaluates uncached)."""
    sig = g.pods[0].__dict__.get("_sched_sig") if g.pods else None
    if sig is None or len(sig) < 9:
        return None
    return (sig[1], sig[2], sig[7], sig[8])


def _class_rows(
    groups: Sequence[PodGroup],
    table: "_ReqTable",
    taint_groups: Dict[tuple, object],
    n_cols: int,
    base_mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Toleration & requirement compatibility of every group against one
    column axis (launch options or existing nodes), built columnar: one
    toleration evaluation per distinct toleration tuple, one
    requirement-term evaluation per distinct term CLASS (``_req_class_key``)
    — deployment-shaped fleets share both across most groups, so the
    per-group python loop collapses to a handful of vectorized passes.
    ``base_mask`` (e.g. node schedulability) is ANDed into every row; the
    caller ANDs in its capacity pass via ``_cap_and``. Row-for-row equal to
    the per-group ``_compat_row`` reference (property-tested)."""
    out = np.zeros((len(groups), n_cols), dtype=bool)
    if not len(groups) or not n_cols:
        return out
    tol_rows: Dict[tuple, np.ndarray] = {}
    req_rows: Dict[tuple, np.ndarray] = {}
    for i, g in enumerate(groups):
        tol_ok = tol_rows.get(g.tolerations)
        if tol_ok is None:
            tol_ok = np.zeros(n_cols, bool)
            tols = list(g.tolerations)
            for taints, idx in taint_groups.items():
                if tolerates_all(tols, taints):
                    tol_ok[np.asarray(idx)] = True
            tol_rows[g.tolerations] = tol_ok
        rkey = _req_class_key(g)
        req_ok = req_rows.get(rkey) if rkey is not None else None
        if req_ok is None:
            req_ok = table.eval_terms(g.terms)
            if rkey is not None:
                req_rows[rkey] = req_ok
        row = tol_ok & req_ok
        out[i] = row if base_mask is None else row & base_mask
    return out


def _cap_and(out: np.ndarray, demand: np.ndarray, cap: np.ndarray) -> None:
    """AND the per-pod capacity check into ``out`` IN PLACE: one broadcast
    pass of demand[G, R] against cap[N, R], chunked so the [g, N, R]
    intermediate stays bounded (~8M elements per block)."""
    G = out.shape[0]
    N, R = cap.shape[0], cap.shape[1] if cap.ndim == 2 else 1
    if not G or not N:
        return
    step = max(1, (8 << 20) // max(N * max(R, 1), 1))
    for lo in range(0, G, step):
        hi = min(G, lo + step)
        out[lo:hi] &= ~np.any(
            demand[lo:hi, None, :] > cap[None, :, :] + 1e-9, axis=2
        )


def _compat_rows(
    groups: Sequence[PodGroup],
    opt_table: "_ReqTable",
    taint_index: Dict[tuple, np.ndarray],
    alloc: np.ndarray,
    demand: np.ndarray,
) -> np.ndarray:
    """PRE-weight-gate compatibility of EVERY group against every option,
    built columnar: ``_class_rows`` for tolerations + term classes,
    ``_cap_and`` for the chunked capacity plane."""
    compat = _class_rows(groups, opt_table, taint_index, alloc.shape[0])
    _cap_and(compat, demand, alloc)
    return compat


def _apply_weight_gate(
    groups: Sequence[PodGroup],
    options: Sequence[LaunchOption],
    compat: np.ndarray,
    weight_degate: frozenset,
) -> List[int]:
    """Provisioner weight priority: when a group is compatible with options
    from provisioners of different weights, only the HIGHEST weight's
    options stay eligible — weights are a strict preference order (the
    reference tries provisioners highest-weight-first), not a tiebreak the
    price ordering may override. Existing-capacity reuse is not gated.
    ``weight_degate`` lists pods whose groups fall back to ALL weights —
    the controller's next-pool pass when the preferred pool cannot host
    them (limits exhausted, zone coverage too narrow for a spread).
    MUTATES compat rows; returns the indices of narrowed groups."""
    O = len(options)
    opt_weight = _option_weights(options)
    weight_gated_groups: List[int] = []
    if O and opt_weight.size and opt_weight.min() != opt_weight.max():
        for i, g in enumerate(groups):
            row = compat[i]
            if not row.any():
                continue
            if weight_degate and any(p.name in weight_degate for p in g.pods):
                continue
            best_w = opt_weight[row].max()
            narrowed = row & (opt_weight == best_w)
            if narrowed.sum() < row.sum():
                weight_gated_groups.append(i)
            compat[i] = narrowed
    return weight_gated_groups


def _node_env(
    existing: Sequence[ExistingNode],
    provisioners: Sequence[Tuple[Provisioner, Sequence[InstanceType]]],
):
    """Per-node scheduling environment: (schedulable[E], effective taint
    tuple per node). Startup taints are ignored in scheduling simulation
    (the reference scheduler's taint filter, website concepts/scheduling.md
    "startup taints"): a workload daemon strips them after bootstrap, so
    treating them as permanent would exclude non-tolerating pods from this
    capacity forever and drive perpetual scale-up."""
    schedulable = np.array(
        [
            not e.node.unschedulable and e.node.meta.deletion_timestamp is None
            for e in existing
        ],
        dtype=bool,
    )
    startup_by_prov: Dict[str, set] = {
        p.name: {(t.key, t.value, t.effect) for t in p.startup_taints}
        for p, _ in provisioners
        if p.startup_taints
    }
    eff_taints: List[tuple] = []
    for e in existing:
        taints = tuple(e.node.taints)
        startup = startup_by_prov.get(e.node.provisioner_name() or "")
        if startup:
            taints = tuple(
                t for t in taints if (t.key, t.value, t.effect) not in startup
            )
        eff_taints.append(taints)
    return schedulable, eff_taints


def _existing_arrays(
    groups: Sequence[PodGroup],
    existing: Sequence[ExistingNode],
    provisioners: Sequence[Tuple[Provisioner, Sequence[InstanceType]]],
    zone_index: Dict[str, int],
    axes: Sequence[str],
    demand: np.ndarray,
):
    """PRE-topology-seed existing-capacity arrays (ex_rem, ex_zone, ex_compat)."""
    G, E, R = len(groups), len(existing), len(axes)
    ex_rem = np.zeros((E, R), dtype=np.float64)
    ex_zone = np.zeros((E,), dtype=np.int32)
    if not E:
        return ex_rem, ex_zone, np.zeros((G, E), dtype=bool)
    axes_t = tuple(axes)
    for k, e in enumerate(existing):
        # remaining-vector memo on the ExistingNode: a consolidation sweep
        # encodes the SAME capacity snapshot objects across every candidate
        # simulation, and re-deriving E vectors per sim was ~20% of its
        # encode. Keyed by (axes, remaining identity) — a fresh reconcile
        # builds fresh ExistingNodes, so staleness can't leak across rounds.
        memo = e.__dict__.get("_rem_vec")
        if memo is not None and memo[0] == axes_t and memo[1] is e.remaining:
            ex_rem[k] = memo[2]
        else:
            row = _vector(e.remaining, axes)
            e.__dict__["_rem_vec"] = (axes_t, e.remaining, row)
            ex_rem[k] = row
        ex_zone[k] = zone_index.get(e.node.zone(), 0)
    ex_table = _get_surface_table([_node_surface(e.node) for e in existing])
    schedulable, eff_taints = _node_env(existing, provisioners)
    ex_taint_groups: Dict[tuple, list] = {}
    for k, taints in enumerate(eff_taints):
        ex_taint_groups.setdefault(taints, []).append(k)
    # columnar build: the same _class_rows/_cap_and passes the
    # option plane uses, with node schedulability as the base mask
    ex_compat = _class_rows(
        groups, ex_table, ex_taint_groups, E, base_mask=schedulable
    )
    _cap_and(ex_compat, demand, ex_rem)
    return ex_rem, ex_zone, ex_compat


def _finalize(
    groups: List[PodGroup],
    options: List[LaunchOption],
    existing: Sequence[ExistingNode],
    axes: List[str],
    zones: List[str],
    zone_index: Dict[str, int],
    demand: np.ndarray,
    count: np.ndarray,
    node_cap: np.ndarray,
    zone_cap: np.ndarray,
    zone_skew: np.ndarray,
    colocate: np.ndarray,
    alloc: np.ndarray,
    price: np.ndarray,
    opt_zone: np.ndarray,
    compat: np.ndarray,
    ex_rem: np.ndarray,
    ex_zone: np.ndarray,
    ex_compat: np.ndarray,
    weight_degate: frozenset,
) -> EncodedProblem:
    """Shared tail of every encode, full or delta: weight gate, topology
    seeds, cross-group relations, assembly. ``compat``/``ex_compat`` arrive
    PRE-gate/PRE-seed and are mutated here — delta callers pass copies of
    their cached arrays (the cached pre-state must survive the round)."""
    weight_gated_groups = _apply_weight_gate(groups, options, compat, weight_degate)
    zone_seed, zone_occupied, seed_pods = _topology_seeds(
        groups, existing, zone_index, ex_compat, compat
    )
    relations = _build_relations(groups, existing, zone_index)
    zone_spread_members = _zone_spread_members(groups)

    return EncodedProblem(
        groups=groups,
        options=options,
        existing=list(existing),
        resource_axes=axes,
        zones=zones,
        demand=demand.astype(np.float32),
        count=count.astype(np.int32),
        alloc=alloc.astype(np.float32),
        price=price.astype(np.float32),
        # copy: the cached option arrays are shared across encodes and the
        # problem must own its tensors
        opt_zone=opt_zone.copy(),
        compat=compat,
        node_cap=np.minimum(node_cap, BIG_CAP).astype(np.int32),
        zone_cap=np.minimum(zone_cap, BIG_CAP).astype(np.int32),
        zone_skew=zone_skew,
        colocate=colocate,
        ex_rem=ex_rem.astype(np.float32),
        ex_zone=ex_zone,
        ex_compat=ex_compat,
        zone_seed=zone_seed,
        zone_occupied=zone_occupied,
        seed_pods=seed_pods,
        weight_gated_groups=weight_gated_groups,
        rel_set=relations[0],
        rel_host_forbid=relations[1],
        rel_host_need=relations[2],
        rel_zone_forbid=relations[3],
        rel_zone_need=relations[4],
        rel_slot_bits=relations[5],
        rel_zone_bits=relations[6],
        rel_layer=relations[7],
        rel_unsupported=relations[8],
        zone_spread_members=zone_spread_members,
    )


def encode(
    pods: Sequence[Pod],
    provisioners: Sequence[Tuple[Provisioner, Sequence[InstanceType]]],
    existing: Sequence[ExistingNode] = (),
    daemonsets: Sequence[Pod] = (),
    weight_degate: frozenset = frozenset(),
    risk_penalty: float = 0.0,
) -> EncodedProblem:
    with ENCODE_LOCK:
        # The ONLY vocab compaction boundary: every table built or reused
        # inside one encode must share a code generation with the vocab that
        # eval reads.
        _maybe_compact_vocab()
        groups = group_pods(pods)
        options = build_options(provisioners, daemonsets, risk_penalty)

        axes = _resource_axes(groups, options)
        zones = zone_list(options, existing)
        zone_index = {z: i for i, z in enumerate(zones)}

        demand, count, node_cap, zone_cap, zone_skew, colocate = _group_arrays(
            groups, axes
        )
        alloc, price, opt_zone = _option_arrays(options, axes, zone_index)

        # -- compat masks, columnar over BOTH axes ------------------------
        opt_table = _get_option_table(options)
        taint_index = _taint_index(options)
        compat = _compat_rows(groups, opt_table, taint_index, alloc, demand)

        ex_rem, ex_zone, ex_compat = _existing_arrays(
            groups, existing, provisioners, zone_index, axes, demand
        )

        return _finalize(
            groups, options, existing, axes, zones, zone_index,
            demand, count, node_cap, zone_cap, zone_skew, colocate,
            alloc, price, opt_zone, compat, ex_rem, ex_zone, ex_compat,
            weight_degate,
        )


def equivalent_affinity_term(t, pod: Pod) -> bool:
    """Does ``pod`` carry a required (anti-)affinity term identical to ``t``?
    Used to seed OWNER presence bits from bound pods: k8s required
    anti-affinity is symmetric at admission time — a new selector-matching pod
    may not join a domain holding a pod that carries the term."""
    for t2 in pod.affinity_terms:
        if (
            t2.anti == t.anti
            and t2.topology_key == t.topology_key
            and dict(t2.label_selector) == dict(t.label_selector)
        ):
            return True
    return False


#: usable relation bits (int32, sign bit excluded)
MAX_REL_BITS = 31


def _build_relations(
    groups: Sequence[PodGroup],
    existing: Sequence[ExistingNode],
    zone_index: Dict[str, int],
):
    """Cross-group (anti-)affinity as presence bitmasks — the tensor path's
    encoding of selectors that reach across pod groups (round-4 verdict 1).

    Bit protocol, per cross-reaching required term:

    * ``bit_sel`` is set on a node/zone once a pod MATCHING the term's
      selector is placed there (or is already bound there — seeds);
    * anti terms also allocate ``bit_owner``, set where the term's OWNER
      group's pods land (or where a bound pod CARRYING the same term sits),
      because k8s required anti-affinity is symmetric: the owner avoids
      ``bit_sel`` domains, and every matching group avoids ``bit_owner``
      domains;
    * required (non-anti) cross terms make the owner placeable only in
      domains with ``bit_sel`` present (hostname terms therefore cannot open
      fresh nodes — providers place first, see ``rel_layer``).

    Self-only terms keep their existing encodings (node_cap / zone_cap /
    colocate); a term with no in-batch match and no bound match is vacuous
    (the k8s bootstrap rule for required affinity).

    Returns (set_mask, host_forbid, host_need, zone_forbid, zone_need,
    slot_bits[E], zone_bits[Z], layer[G], unsupported_reason|None).
    """
    G = len(groups)
    Z = max(len(zone_index), 1)
    E = len(existing)
    reps = [g.pods[0] for g in groups]
    set_mask = np.zeros(G, np.int32)
    host_forbid = np.zeros(G, np.int32)
    host_need = np.zeros(G, np.int32)
    zone_forbid = np.zeros(G, np.int32)
    zone_need = np.zeros(G, np.int32)
    slot_bits = np.zeros(E, np.int32)
    zone_bits = np.zeros(Z, np.int32)
    layer = np.zeros(G, np.int32)
    unsupported = None
    next_bit = 0
    need_edges: List[Tuple[int, int]] = []  # (requirer, provider)

    def alloc_bit() -> Optional[int]:
        nonlocal next_bit
        if next_bit >= MAX_REL_BITS:
            return None
        b = 1 << next_bit
        next_bit += 1
        return b

    for gi, rep in enumerate(reps):
        # Spread shapes the tensor path cannot express go straight to the
        # oracle instead of paying a doomed kernel dispatch + validation:
        # hostname-key spread counting other groups, and spread whose
        # selector does not match the pod itself (group_pods derives no cap
        # for those, so the kernel would run unconstrained).
        for c in rep.effective_spread():
            matches_other = any(
                gj != gi and c.selects(reps[gj]) for gj in range(G)
            )
            if c.topology_key == wk.HOSTNAME and matches_other:
                unsupported = "cross-group hostname spread"
            elif not c.selects(rep) and matches_other:
                unsupported = "spread selector not matching its own pod"
        for t in rep.affinity_terms:
            matched = [gj for gj in range(G) if gj != gi and t.selects(reps[gj])]
            seed_nodes = [
                k for k, e in enumerate(existing) if any(t.selects(p) for p in e.pods)
            ]
            if not matched and not seed_nodes:
                continue  # self-only / vacuous: existing encodings cover it
            if t.topology_key not in (wk.HOSTNAME, wk.ZONE):
                unsupported = f"cross-group term on topology key {t.topology_key!r}"
                continue
            if not t.anti and t.selects(rep):
                # self+cross required affinity: own placements satisfy the
                # term (colocate / self-pinning covers it) — no bits needed
                continue
            is_host = t.topology_key == wk.HOSTNAME
            bit_sel = alloc_bit()
            bit_owner = alloc_bit() if t.anti else 0
            if bit_sel is None or bit_owner is None:
                unsupported = f"more than {MAX_REL_BITS} relation bits"
                break
            # selector presence: matching groups + matching bound pods
            for gj in matched:
                set_mask[gj] |= bit_sel
            if t.selects(rep):
                set_mask[gi] |= bit_sel
            for k in seed_nodes:
                slot_bits[k] |= bit_sel
                zi = zone_index.get(existing[k].node.zone() or "")
                if zi is not None:
                    zone_bits[zi] |= bit_sel
            if t.anti:
                # symmetric: owner avoids selector domains; matchers avoid
                # owner domains (instance: "A never with B" blocks both sides)
                set_mask[gi] |= bit_owner
                for k, e in enumerate(existing):
                    if any(equivalent_affinity_term(t, p) for p in e.pods):
                        slot_bits[k] |= bit_owner
                        zi = zone_index.get(e.node.zone() or "")
                        if zi is not None:
                            zone_bits[zi] |= bit_owner
                if is_host:
                    host_forbid[gi] |= bit_sel
                    for gj in matched:
                        host_forbid[gj] |= bit_owner
                else:
                    zone_forbid[gi] |= bit_sel
                    for gj in matched:
                        zone_forbid[gj] |= bit_owner
            else:
                if is_host:
                    host_need[gi] |= bit_sel
                else:
                    zone_need[gi] |= bit_sel
                for gj in matched:
                    need_edges.append((gi, gj))
        if unsupported and "relation bits" in unsupported:
            break

    # Anti terms CARRIED BY BOUND PODS also protect their domains (k8s
    # admission symmetry): a group the term selects may not join the carrier's
    # node/zone. Dedupe by term signature; one bit marks the carrier domains.
    if existing and unsupported is None:
        seen: Dict[tuple, int] = {}
        for k, e in enumerate(existing):
            for p in e.pods:
                for t in p.affinity_terms:
                    if not t.anti or t.topology_key not in (wk.HOSTNAME, wk.ZONE):
                        continue
                    matched = [gj for gj in range(G) if t.selects(reps[gj])]
                    if not matched:
                        continue
                    sig = (
                        t.topology_key,
                        tuple(sorted(dict(t.label_selector).items())),
                    )
                    bit = seen.get(sig)
                    if bit is None:
                        bit = alloc_bit()
                        if bit is None:
                            unsupported = f"more than {MAX_REL_BITS} relation bits"
                            break
                        seen[sig] = bit
                        for gj in matched:
                            if t.topology_key == wk.HOSTNAME:
                                host_forbid[gj] |= bit
                            else:
                                zone_forbid[gj] |= bit
                    slot_bits[k] |= bit
                    if t.topology_key == wk.ZONE:
                        zi = zone_index.get(e.node.zone() or "")
                        if zi is not None:
                            zone_bits[zi] |= bit
                if unsupported and "relation bits" in unsupported:
                    break
            if unsupported and "relation bits" in unsupported:
                break

    # provider-before-requirer layers: a requirer's layer exceeds every
    # provider's so portfolio orders place providers first; a cycle (A needs
    # B needs A) cannot be linearized by the grouped scan — oracle handles it
    for _ in range(G):
        changed = False
        for req, prov in need_edges:
            want = layer[prov] + 1
            if layer[req] < want:
                layer[req] = want
                changed = True
        if not changed:
            break
    else:
        if need_edges:
            unsupported = "cyclic cross-group required affinity"
    if need_edges and unsupported is None:
        # A requirer can only live in its providers' reserved headroom, so
        # (a) each family is INTERLEAVED — provider(s), then its requirer,
        # immediately: a later provider filling an earlier family's leftovers
        # would eat reserve its own requirer then misses — and (b) groups
        # outside the relations go last (most-constrained-first).
        by_req: Dict[int, List[int]] = {}
        for req, prov in need_edges:
            by_req.setdefault(req, []).append(prov)
        interleaved = np.full(G, -1, np.int64)
        for fi, req in enumerate(sorted(by_req)):
            for prov in by_req[req]:
                if interleaved[prov] < 0:
                    interleaved[prov] = 2 * fi
                else:
                    interleaved[prov] = min(interleaved[prov], 2 * fi)
            interleaved[req] = 2 * fi + 1
        if all(interleaved[req] > interleaved[prov] for req, prov in need_edges):
            tail = int(interleaved.max()) + 1
            layer = np.where(interleaved >= 0, interleaved, tail).astype(np.int32)
        else:
            # shared providers across families broke the interleave: keep the
            # plain topological layers, uninvolved groups still go last
            involved = {g for e in need_edges for g in e}
            tail = int(layer[list(involved)].max()) + 1
            for g in range(G):
                if g not in involved:
                    layer[g] = tail

    return (
        set_mask, host_forbid, host_need, zone_forbid, zone_need,
        slot_bits, zone_bits, layer, unsupported,
    )


def _zone_spread_members(groups: Sequence[PodGroup]) -> List[List[int]]:
    """Per group: which groups its first hard zone-spread constraint counts
    (incl. itself). Drives joint water-fill quota families — a selector that
    also matches OTHER groups' pods must budget zones for the family total,
    and constraint-less members inherit the family cap."""
    reps = [g.pods[0] for g in groups]
    out: List[List[int]] = []
    for gi, g in enumerate(groups):
        members: List[int] = []
        if g.zone_skew > 0:
            rep = reps[gi]
            for c in rep.effective_spread():
                if c.topology_key == wk.ZONE and c.selects(rep):
                    members = [gj for gj, r in enumerate(reps) if c.selects(r)]
                    break
        out.append(members)
    return out


def sizing_demand(problem: "EncodedProblem") -> np.ndarray:
    """Per-pod NODE-SIZING demand [G, R]: the real demand, plus — for groups
    that PROVIDE a hostname-affinity requirer's only landing spots — the
    requirers' total demand spread over the provider pods. The reference
    sizes an in-flight node by packing all co-schedulable pending pods
    (designs/bin-packing.md:16-43); this is that co-packing at group
    granularity. Capacity checks keep using ``problem.demand``."""
    if problem.rel_host_need is None or not problem.rel_host_need.any():
        return problem.demand  # identity signals "no reserve needed"
    demand = problem.demand.astype(np.float64)
    out = demand.copy()
    G = problem.G
    for q in range(G):
        hn = int(problem.rel_host_need[q])
        if hn == 0 or problem.count[q] == 0:
            continue
        providers = [
            p for p in range(G)
            if p != q and (int(problem.rel_set[p]) & hn) == hn
        ]
        tot = float(sum(problem.count[p] for p in providers))
        if tot > 0:
            for p in providers:
                out[p] += (problem.count[q] / tot) * demand[q]
    return out


_node_surface_intern: Dict[str, tuple] = {}  # node name -> (labels copy, surface)
_labels_surface_intern: Dict[tuple, Requirements] = {}  # label items -> surface
_NODE_SURFACE_MAX = 100_000  # bound for a long-lived operator's name churn


def _node_surface(node: Node) -> Requirements:
    """The node's label surface as Requirements, cached on the node: 2000
    in-flight nodes cost ~85ms of Requirement construction per encode
    otherwise, every reconcile. Invalidation keys on the labels dict identity
    — node labels are stamped once at registration; any code replacing the
    dict gets a fresh surface automatically.

    A second, name-keyed intern layer serves value-equal re-listed Node
    objects (informer refresh, restart re-adoption): a dict-equality check on
    the labels (~1us) replaces full Requirement construction (~90us), and —
    because the SAME surface object comes back — the downstream roster/table
    caches keyed by surface identity keep hitting too."""
    cached = node.__dict__.get("_req_surface")
    if cached is not None and cached[0] is node.meta.labels:
        return cached[1]
    labels = node.meta.labels
    entry = _node_surface_intern.get(node.name)
    if entry is not None and entry[0] == labels:
        surface = entry[1]
    else:
        # content-level intern: fleet nodes share label SETS (type, zone,
        # provisioner, capacity-type...), so first contact with 1,500 nodes
        # builds one surface per distinct label set, not per node — and the
        # shared object keeps every identity-keyed downstream memo hitting
        content_key = tuple(sorted(labels.items()))
        surface = _labels_surface_intern.get(content_key)
        if surface is None:
            surface = Requirements.from_labels(labels)
            if len(_labels_surface_intern) >= _NODE_SURFACE_MAX:
                _labels_surface_intern.clear()
            _labels_surface_intern[content_key] = surface
        if len(_node_surface_intern) >= _NODE_SURFACE_MAX:
            _node_surface_intern.clear()
        # store a copy: in-place mutation of the caller's dict must not be
        # able to desynchronize the comparison reference
        _node_surface_intern[node.name] = (dict(labels), surface)
    node.__dict__["_req_surface"] = (labels, surface)
    return surface


def _topology_seeds(
    groups: Sequence[PodGroup],
    existing: Sequence[ExistingNode],
    zone_index: Dict[str, int],
    ex_compat: np.ndarray,
    compat: np.ndarray,
):
    """Seed topology constraints from pods already bound in the cluster.

    Three effects, mirroring how the reference scheduler's topology tracker
    counts existing cluster pods (website concepts/scheduling.md topology):

    * zone spread: per-zone counts of selector-matching bound pods feed the
      solver's zone quotas (water-filled so new pods level the domains);
    * hostname spread / anti-affinity: an existing node already hosting a
      selector-matching pod is masked incompatible (conservative — the node
      may have residual skew headroom, but a mask can never violate);
    * required self-affinity (colocate): once matching pods exist, the group
      is pinned to their nodes — no new node may open for it.

    Returns (zone_seed [G, Z] | None, zone_occupied [G, Z] | None,
    seed_pods [(host, zone, Pod)]). MUTATES ex_compat/compat masks in place.
    """
    G = len(groups)
    Z = max(len(zone_index), 1)
    topo = [
        i
        for i, g in enumerate(groups)
        if g.zone_skew > 0 or g.node_cap < BIG_CAP or g.zone_cap < BIG_CAP or g.colocate
    ]
    if not existing or not topo:
        return None, None, []
    seed_pods = [
        (e.name, e.node.zone() or "", p) for e in existing for p in e.pods
    ]
    if not seed_pods:
        return None, None, []
    zone_seed = np.zeros((G, Z), np.int32)
    zone_occupied = np.zeros((G, Z), np.int32)
    for i in topo:
        rep = groups[i].pods[0]
        # per-zone spread seeds (first DoNotSchedule zone constraint drives
        # the quota; the validator checks every constraint independently)
        for c in rep.effective_spread():
            if c.topology_key == wk.ZONE and c.selects(rep):
                for _, zone, p in seed_pods:
                    zi = zone_index.get(zone)
                    if zi is not None and c.selects(p):
                        zone_seed[i, zi] += 1
                break
        # hostname-capped groups: occupied nodes are off-limits
        host_sels = [
            c.selects
            for c in rep.effective_spread()
            if c.topology_key == wk.HOSTNAME and c.selects(rep)
        ]
        colocate_sel = None
        for t in rep.affinity_terms:
            if not t.selects(rep):
                continue
            if t.anti and t.topology_key == wk.HOSTNAME:
                host_sels.append(t.selects)
            elif t.anti and t.topology_key == wk.ZONE:
                for _, zone, p in seed_pods:
                    zi = zone_index.get(zone)
                    if zi is not None and t.selects(p):
                        zone_occupied[i, zi] += 1
            elif not t.anti and t.topology_key == wk.HOSTNAME:
                colocate_sel = t.selects
        if host_sels:
            for k, e in enumerate(existing):
                if any(sel(p) for p in e.pods for sel in host_sels):
                    ex_compat[i, k] = False
        if colocate_sel is not None:
            hosting = np.array(
                [any(colocate_sel(p) for p in e.pods) for e in existing], bool
            )
            if hosting.any():
                ex_compat[i] &= hosting
                compat[i, :] = False  # pinned to the existing domain
    return zone_seed, zone_occupied, seed_pods
