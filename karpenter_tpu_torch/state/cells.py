"""Cell-partitioned control plane: deterministic sharding of cluster state
(a copy of ``karpenter_tpu/state/cells.py``).

One flat reconcile loop pays O(cluster) every round even when churn is
local — the ceiling that keeps the operator at ~50k pods. CvxCluster
(PAPERS.md) shows granular allocation problems decomposing into
near-independent subproblems plus a cheap coupling pass; a Karpenter-style
cluster has exactly that structure: pods and nodes partition naturally by
(provisioner, zone/topology domain), and only a small residue of pods is
feasible in more than one cell.

This module owns the partitioning layer:

* :func:`feasible_provisioners` / :func:`zone_pin` — the deterministic,
  deliberately OPTIMISTIC per-pod feasibility test (a pod is never excluded
  from a provisioner the flat solver could have used, so "feasible in
  exactly one cell" is a sound routing decision and everything else lands
  in the cross-cell residue);
* :class:`CellMap` — the incremental pod→cell assignment engine: one cell
  per provisioner, refined into per-zone subcells when EVERY unit of that
  provisioner's population pins a single zone (zone-pinned pods never share
  nodes across zones, so the refinement is exact); gangs are one unit and
  pin whole to one cell (or the residue) so the gang gate and the
  spot-diversification gate keep their invariants;
* :class:`CellRouter` — the provisioning controller's sharding state:
  per-cell :class:`~karpenter_tpu_torch.solver.session.EncodeSession` instances
  fed by the same watch-event dirty sets the flat path uses, where a pod
  changing cells is just a DELETED/ADDED delta pair (the delta==full
  digest contract holds per cell);
* :class:`CellIndex` — the apiserver's per-object cell classifier
  (provisioner-level cells only: a pure function of the object and the
  provisioner set, so per-cell watch streams stay consistent without
  cross-object coupling) plus the name index behind ``GET /api/{kind}?cell=``.

Decomposition contract (property-tested in tests/test_cells.py, and the
port held to the JAX package's in tests/test_torch_cells.py): on
scenarios where every pod is single-feasible, the union of per-cell solves
is placement- and cost-identical to the flat solve, and each cell's delta
encode is digest-identical to a from-scratch full encode of that cell's
canonical inputs.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from ..api import labels as wk
from ..api.objects import Node, Pod, Provisioner
from ..api.requirements import Requirements
from ..api.taints import tolerates_all

#: a cell's identity: (provisioner name, zone) — zone "*" when the cell
#: spans the provisioner's whole topology (the unrefined case)
CellKey = Tuple[str, str]

#: the cross-cell residue class: pods feasible in zero or 2+ cells, gangs
#: whose members disagree, and nodes whose provisioner left the cluster
RESIDUE: CellKey = ("~", "residue")

#: cluster attribute of each kind ``CellIndex`` lists: a copy of the API
#: server's table (``karpenter_tpu/state/apiserver.py``), which comes with
#: ``ROADMAP.md`` Queue 1 item 6
_COLLECTIONS = {
    "pods": "pods",
    "nodes": "nodes",
    "machines": "machines",
    "provisioners": "provisioners",
    "nodetemplates": "node_templates",
    "poddisruptionbudgets": "pdbs",
}


def cell_name(key: CellKey) -> str:
    if key == RESIDUE:
        return "residue"
    prov, zone = key
    return prov if zone == "*" else f"{prov}/{zone}"


# ---------------------------------------------------------------------------
# Feasibility (optimistic by design)
# ---------------------------------------------------------------------------

def _prov_surface(prov: Provisioner) -> Requirements:
    """The provisioner-level requirement surface (labels + spec
    requirements), cached on the object by resource version."""
    cached = prov.__dict__.get("_cell_surface")
    if cached is not None and cached[0] == prov.meta.resource_version:
        return cached[1]
    surface = Requirements.from_labels(prov.labels).intersect(prov.requirements)
    prov.__dict__["_cell_surface"] = (prov.meta.resource_version, surface)
    return surface


def _surface_allows(surface: Requirements, term: Requirements) -> bool:
    """Optimistic compatibility: only keys the PROVISIONER defines can
    exclude (an undefined key — zone, instance-type, capacity-type — may be
    supplied by some instance type, so absence never excludes). This keeps
    the feasible set a superset of the truth, which is the safe direction
    for partitioning: a pod single-feasible here is provably infeasible
    everywhere else."""
    for req in term:
        if surface.has(req.key):
            if surface.get(req.key).intersect(req).is_empty():
                return False
    return True


def feasible_provisioners(
    pod: Pod, provisioners: Sequence[Provisioner]
) -> Tuple[str, ...]:
    """Names of the provisioners this pod could possibly land in, in the
    caller's (deterministic) order."""
    out = []
    tolerations = list(pod.tolerations)
    terms = pod.scheduling_requirement_terms()
    for prov in provisioners:
        if not tolerates_all(tolerations, tuple(prov.taints)):
            continue
        surface = _prov_surface(prov)
        if any(_surface_allows(surface, term) for term in terms):
            out.append(prov.name)
    return tuple(out)


def pod_feas_key(pod: Pod) -> tuple:
    """Content key of everything the feasibility test and the zone pin
    read: the pod's requirement terms and tolerations. Pods sharing a key
    — every replica of a deployment — route identically, which is what
    lets :class:`CellMap` classify a churn burst in O(distinct shapes)
    instead of O(pods x provisioners)."""
    return (
        tuple(
            tuple(sorted(
                (r.key, r.complement, tuple(sorted(r.values)),
                 r.greater_than, r.less_than)
                for r in term
            ))
            for term in pod.scheduling_requirement_terms()
        ),
        tuple(sorted(
            (t.key, t.operator, t.value, t.effect)
            for t in pod.tolerations
        )),
    )


def zone_pin(pod: Pod) -> Optional[str]:
    """The single zone this pod's required terms pin it to, or None. A pod
    is pinned only when EVERY term resolves to the same single zone —
    spread/anti-affinity pods are unpinned by construction (they carry no
    zone requirement)."""
    zone: Optional[str] = None
    for term in pod.scheduling_requirement_terms():
        if not term.has(wk.ZONE):
            return None
        v = term.get(wk.ZONE).single_value()
        if v is None or (zone is not None and v != zone):
            return None
        zone = v
    return zone


# ---------------------------------------------------------------------------
# Incremental assignment engine
# ---------------------------------------------------------------------------

class _PodEntry:
    __slots__ = ("rv", "feas", "zone", "gang", "cell")

    def __init__(self, rv: int, feas: Tuple[str, ...], zone: Optional[str],
                 gang: Optional[str]):
        self.rv = rv
        self.feas = feas
        self.zone = zone
        self.gang = gang
        self.cell: Optional[CellKey] = None  # None until first settled


class _Unit:
    """One pinning unit: a plain pod, or a whole gang (pinned together so
    the all-or-nothing gate only ever judges placements from ONE solve)."""

    __slots__ = ("members", "feas", "zone")

    def __init__(self):
        self.members: Set[str] = set()
        self.feas: Tuple[str, ...] = ()
        self.zone: Optional[str] = None


#: a move the router mirrors into its sessions: (pod name, old cell or
#: None for a fresh pod, new cell)
Move = Tuple[str, Optional[CellKey], CellKey]


class CellMap:
    """Incremental pod → cell assignment over a fixed provisioner basis.

    Pure bookkeeping — no sessions, no locks (callers own both). Mutations
    are O(unit) plus O(flipped family): the zone-subdivision state of a
    provisioner family only changes when its count of zone-UNPINNED units
    crosses zero, and only then do that family's units re-settle."""

    def __init__(self, provisioners: Iterable[Provisioner] = ()) -> None:
        self.provisioners: List[Provisioner] = sorted(
            provisioners, key=lambda p: p.name
        )
        self._pods: Dict[str, _PodEntry] = {}
        # feasibility memo keyed by pod content (terms + tolerations): the
        # provisioner basis is fixed per CellMap (a basis change rebuilds
        # the map), so equal-shaped pods always classify identically
        self._feas_cache: Dict[tuple, Tuple[Tuple[str, ...], Optional[str]]] = {}
        self._units: Dict[str, _Unit] = {}  # unit key: pod name or "gang:<g>"
        self._by_prov: Dict[str, Set[str]] = {}  # prov -> unit keys pinned to it
        self._unpinned: Dict[str, int] = {}  # prov -> zone-unpinned unit count
        self._subdivided: Dict[str, bool] = {}  # prov -> settled-as-subdivided
        self._dirty_units: Set[str] = set()
        self._touched_provs: Set[str] = set()

    @staticmethod
    def basis_sig(provisioners: Iterable[Provisioner]) -> tuple:
        """Content signature of the partition basis: any provisioner
        add/remove/spec change voids every assignment (taints and
        requirement surfaces are what feasibility reads)."""
        return tuple(sorted(
            (p.name, p.meta.resource_version) for p in provisioners
        ))

    # -- queries ------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._pods)

    def names(self) -> Set[str]:
        return set(self._pods)

    def cell_of(self, name: str) -> Optional[CellKey]:
        e = self._pods.get(name)
        return e.cell if e is not None else None

    def cell_keys(self) -> List[CellKey]:
        """Sorted distinct non-residue cells with members."""
        return sorted({
            e.cell for e in self._pods.values()
            if e.cell is not None and e.cell != RESIDUE
        })

    def node_cell(self, node: Node, cells: Optional[Set[CellKey]] = None) -> CellKey:
        """The cell whose solve may use this node's capacity. Nodes whose
        provisioner is gone — or whose cell has no pending pods this round,
        when ``cells`` narrows to the round's live cells — fall to the
        residue, whose arbitration solve sees every node."""
        prov = node.provisioner_name()
        if prov is None or all(p.name != prov for p in self.provisioners):
            return RESIDUE
        if self._subdivided.get(prov, False):
            key: CellKey = (prov, node.zone() or "*")
        else:
            key = (prov, "*")
        if cells is not None and key not in cells:
            return RESIDUE
        return key

    # -- mutation -----------------------------------------------------------
    def upsert(self, pod: Pod) -> List[Move]:
        """Add or refresh one pod; returns every resulting move, this pod's
        (possibly same-cell) placement first."""
        name = pod.meta.name
        entry = self._pods.get(name)
        fkey = pod_feas_key(pod)
        hit = self._feas_cache.get(fkey)
        if hit is None:
            if len(self._feas_cache) > 8192:
                self._feas_cache.clear()  # bound: pathological shape churn
            hit = (feasible_provisioners(pod, self.provisioners), zone_pin(pod))
            self._feas_cache[fkey] = hit
        feas, zpin = hit
        gang = pod.pod_group()
        if entry is None:
            entry = _PodEntry(pod.meta.resource_version, feas, zpin, gang)
            self._pods[name] = entry
            self._unit_add(name, entry)
        elif (entry.feas, entry.zone, entry.gang) == (feas, zpin, gang):
            entry.rv = pod.meta.resource_version
            # identical partition identity: no repartition work; the caller
            # still swaps the fresh object into the owning session
            return [(name, entry.cell, entry.cell)] if entry.cell else self._settle()
        else:
            self._unit_remove(name, entry)
            entry.rv, entry.feas, entry.zone, entry.gang = (
                pod.meta.resource_version, feas, zpin, gang
            )
            self._unit_add(name, entry)
        moves = self._settle()
        moves.sort(key=lambda m: (m[0] != name, m[0]))
        return moves

    def remove(self, name: str) -> Tuple[Optional[CellKey], List[Move]]:
        entry = self._pods.pop(name, None)
        if entry is None:
            return None, []
        self._unit_remove(name, entry)
        return entry.cell, self._settle()

    # -- internals ----------------------------------------------------------
    @staticmethod
    def _unit_key(name: str, entry: _PodEntry) -> str:
        return f"gang:{entry.gang}" if entry.gang else name

    def _unit_add(self, name: str, entry: _PodEntry) -> None:
        key = self._unit_key(name, entry)
        unit = self._units.get(key)
        if unit is None:
            unit = self._units[key] = _Unit()
        unit.members.add(name)
        self._refresh_unit(key, unit)

    def _unit_remove(self, name: str, entry: _PodEntry) -> None:
        key = self._unit_key(name, entry)
        unit = self._units.get(key)
        if unit is None:
            return
        unit.members.discard(name)
        if not unit.members:
            self._account(key, unit, remove=True)
            del self._units[key]
            self._dirty_units.discard(key)
            return
        self._refresh_unit(key, unit)

    def _refresh_unit(self, key: str, unit: _Unit) -> None:
        """Recompute a unit's aggregate feasibility/zone and re-account it.
        A gang aggregates: assigned to a provisioner only when EVERY member
        is single-feasible in the SAME one; zone-pinned only when every
        member pins the same zone."""
        self._account(key, unit, remove=True)
        feas: Optional[Tuple[str, ...]] = None
        zone: Optional[str] = None
        first = True
        for m in unit.members:
            e = self._pods.get(m)
            if e is None:
                continue
            if feas is None:
                feas = e.feas
            elif e.feas != feas:
                feas = ()
            if first:
                zone, first = e.zone, False
            elif e.zone != zone:
                zone = None
        unit.feas = feas if feas is not None and len(feas) == 1 else ()
        unit.zone = zone
        self._account(key, unit, remove=False)
        self._dirty_units.add(key)

    def _account(self, key: str, unit: _Unit, remove: bool) -> None:
        if len(unit.feas) != 1:
            return
        prov = unit.feas[0]
        self._touched_provs.add(prov)
        if remove:
            self._by_prov.get(prov, set()).discard(key)
            if unit.zone is None:
                self._unpinned[prov] = max(self._unpinned.get(prov, 0) - 1, 0)
        else:
            self._by_prov.setdefault(prov, set()).add(key)
            if unit.zone is None:
                self._unpinned[prov] = self._unpinned.get(prov, 0) + 1

    def _unit_cell(self, unit: _Unit) -> CellKey:
        if len(unit.feas) != 1:
            return RESIDUE
        prov = unit.feas[0]
        if unit.zone is not None and self._subdivided.get(prov, False):
            return (prov, unit.zone)
        return (prov, "*")

    def _settle(self) -> List[Move]:
        """Assign cells to the dirty units; a provisioner family whose
        zone-subdivision state flipped re-settles whole (that is the one
        cross-unit coupling in the partition)."""
        for prov in list(self._touched_provs):
            want = (
                self._unpinned.get(prov, 0) == 0
                and bool(self._by_prov.get(prov))
            )
            if self._subdivided.get(prov, False) != want:
                self._subdivided[prov] = want
                self._dirty_units.update(self._by_prov.get(prov, ()))
        self._touched_provs.clear()
        moves: List[Move] = []
        for key in sorted(self._dirty_units):
            unit = self._units.get(key)
            if unit is None:
                continue
            cell = self._unit_cell(unit)
            for m in sorted(unit.members):
                e = self._pods.get(m)
                if e is None or e.cell == cell:
                    continue
                moves.append((m, e.cell, cell))
                e.cell = cell
        self._dirty_units.clear()
        return moves


# ---------------------------------------------------------------------------
# Controller-side router: per-cell EncodeSessions over the dirty-set wire
# ---------------------------------------------------------------------------

class RoundPlan:
    """One sharded round's batch split: ``cells`` is the deterministic
    (sorted-key) list of (cell, pods) the solves fan out over; ``residue``
    is the cross-cell class the global arbitration pass places; ``dirty``
    is the set of cells touched by events since their last ``mark_clean``
    — a cell NOT in it provably encodes to its previous problem digest
    (same members, same objects; the delta==full contract), which is what
    lets the controller reuse that cell's cached solve and keep a churn
    round O(churned cells), not O(cluster)."""

    __slots__ = ("cells", "residue", "dirty")

    def __init__(self, cells: List[Tuple[CellKey, List[Pod]]],
                 residue: List[Pod], dirty: frozenset = frozenset()):
        self.cells = cells
        self.residue = residue
        self.dirty = dirty

    @property
    def max_cell_pods(self) -> int:
        return max((len(p) for _, p in self.cells), default=0)


class CellRouter:
    """The provisioning controller's sharding state: the incremental
    :class:`CellMap` plus one :class:`EncodeSession` per cell (and one for
    the residue), fed by the same watch-event stream the flat path's single
    session consumes. A pod changing cells — including across a
    provisioner-change repartition — is routed as a DELETED delta to the
    old cell's session and an ADDED delta to the new one's, so the
    delta==full digest contract holds per cell.

    Thread contract mirrors EncodeSession: ``pod_event``/``mark_structural``
    are watch-thread safe (they queue); ``plan_round`` runs on the
    reconcile thread and applies the queue."""

    def __init__(self, full_resync_every: int = 64, delta_enabled: bool = True):
        from ..solver.session import EncodeSession

        self._session_cls = EncodeSession
        self._full_resync_every = full_resync_every
        self._delta_enabled = delta_enabled
        self._lock = threading.RLock()
        self.map = CellMap()
        self._basis_sig: Optional[tuple] = None
        self._ops: Dict[str, Tuple[str, Optional[Pod]]] = {}
        self._structural: Optional[str] = None
        self._sessions: Dict[CellKey, object] = {}
        self._members: Dict[str, Pod] = {}
        self._seq: Dict[str, int] = {}
        self._next_seq = 0
        # incremental per-cell membership (insertion order mirrors each
        # session's arrival order): plan_round reads these instead of
        # classifying the whole batch, so a round costs O(churn), and
        # per-cell dirty flags record which cells' problems may have moved
        self._cell_members: Dict[CellKey, Dict[str, Pod]] = {}
        self._dirty_cells: Set[CellKey] = set()
        # split-list memo: the per-cell pod list handed out by plan_round,
        # rebuilt only while the cell is dirty (membership mutations always
        # dirty their cell first, and rebuilds REPLACE the list — a prior
        # round's plan never mutates underneath its consumer). This keeps
        # the steady-state split O(churned cells), not O(cluster).
        self._list_cache: Dict[CellKey, List[Pod]] = {}
        #: aggregated encode mode of the last round (for the capsule stamp)
        self.last_mode = "none"
        self.last_full_reason = ""
        #: last sharded round's per-cell summaries (/debug/cells payload)
        self.last_round: List[Dict] = []

    # -- dirty intake (watch threads) ---------------------------------------
    def pod_event(self, event: str, pod: Pod) -> None:
        """Same per-name op collapse as EncodeSession.pod_event — the router
        is the sharded path's intake for the identical event stream."""
        with self._lock:
            name = pod.meta.name
            if event == "DELETED":
                prior = self._ops.pop(name, None)
                if prior is not None and prior[0] == "add" and name not in self._members:
                    return  # queued add never routed: cancels out entirely
                self._ops[name] = ("del", pod)
            else:
                self._ops.pop(name, None)
                self._ops[name] = ("add", pod)

    def mark_structural(self, reason: str) -> None:
        with self._lock:
            self._structural = reason

    # -- round planning (reconcile thread) ----------------------------------
    def plan_round(self, batch: Sequence[Pod],
                   provisioners: Sequence[Provisioner]) -> RoundPlan:
        """Flush queued events, repartition if the provisioner basis moved,
        reconcile membership against the batch (the same safety net the
        session's pod-set-desync check provides), and split the batch."""
        with self._lock:
            structural = self._structural
            self._structural = None
            sig = CellMap.basis_sig(provisioners)
            if sig != self._basis_sig:
                self._basis_sig = sig
                self._repartition(provisioners)
            if structural:
                for s in self._sessions.values():
                    s.mark_structural(structural)
                self._dirty_cells.update(self._cell_members)
            ops = list(self._ops.items())
            self._ops.clear()
            for name, (op, pod) in ops:
                if op == "del":
                    self._apply_del(name, pod)
                else:
                    self._apply_add(name, pod)
            # membership safety net: the batch is authoritative (exactly the
            # population pending_pods() returned); any drift — missed events
            # after a relist, out-of-band mutation — reconciles here as
            # deltas and the per-cell sessions re-sync on their own checks.
            # A structural round (relist) reconciles even on EQUAL counts:
            # a one-in/one-out swap during a watch outage leaves the counts
            # matching while both the departed and the new pod are wrong
            if structural or len(batch) != len(self.map):
                batch_names = {p.meta.name for p in batch}
                for name in sorted(self.map.names() - batch_names):
                    self._apply_del(name, self._members.get(name))
                for p in batch:
                    ent = self._members.get(p.meta.name)
                    if ent is None or ent is not p:
                        self._apply_add(p.meta.name, p)
            # the split reads the incrementally-maintained per-cell
            # membership (kept in lockstep by _route/_apply_del), not an
            # O(batch) classification pass — this is what keeps a sharded
            # round's fixed cost proportional to churn, not cluster size
            by_cell = {k: v for k, v in self._cell_members.items() if v}
            residue_members = by_cell.pop(RESIDUE, {})
            residue = list(residue_members.values())
            cells = []
            for k in sorted(by_cell):
                lst = self._list_cache.get(k)
                if lst is None or k in self._dirty_cells:
                    lst = self._list_cache[k] = list(by_cell[k].values())
                cells.append((k, lst))
            # sessions for cells that emptied out completely drop with their
            # last member; bound memory on long-lived operators
            live = set(by_cell) | {RESIDUE}
            for key in [k for k in self._sessions if k not in live]:
                del self._sessions[key]
                self._cell_members.pop(key, None)
                self._list_cache.pop(key, None)
                self._dirty_cells.discard(key)
            return RoundPlan(cells, residue, frozenset(self._dirty_cells))

    def session(self, key: CellKey):
        with self._lock:
            s = self._sessions.get(key)
            if s is None:
                s = self._sessions[key] = self._session_cls(
                    full_resync_every=self._full_resync_every,
                    enabled=self._delta_enabled,
                )
            return s

    def ordered_pods(self) -> List[Pod]:
        """Concatenated per-cell canonical orders (sorted cell keys, residue
        last) — the sharded analogue of EncodeSession.ordered_pods, and what
        the flight recorder captures as the round's batch order."""
        out: List[Pod] = []
        with self._lock:
            for key in self.map.cell_keys() + [RESIDUE]:
                s = self._sessions.get(key)
                if s is not None:
                    # a cell with nothing solved this round still has its
                    # queued deletes applied, or its order (and thus the
                    # capsule's batch order) would list departed pods
                    s.flush_pending()
                    out.extend(s.ordered_pods())
        return out

    def note_round_modes(self, modes: List[Tuple[str, str]]) -> None:
        """Aggregate per-cell encode modes into the capsule's round stamp:
        delta only when EVERY touched session took the delta path."""
        from ..utils.flightrecorder import _BENIGN_FULL_REASONS

        if not modes:
            self.last_mode, self.last_full_reason = "none", ""
            return
        fulls = [(m, r) for m, r in modes if m == "full"]
        if not fulls:
            self.last_mode, self.last_full_reason = "delta", ""
            return
        self.last_mode = "full"
        bad = [r for _, r in fulls if r not in _BENIGN_FULL_REASONS]
        self.last_full_reason = bad[0] if bad else fulls[0][1]

    def memory_bytes(self) -> Dict[str, float]:
        """Per-cell encoder-state footprint (the {cell}-aware memory scrape
        runtimehealth exports only when sharding is on)."""
        out: Dict[str, float] = {}
        with self._lock:
            keys = self.map.cell_keys()
            for i, key in enumerate(keys + [RESIDUE]):
                s = self._sessions.get(key)
                if s is None:
                    continue
                cid = "residue" if key == RESIDUE else str(i)
                out[cid] = float(s.approx_bytes())
        return out

    # -- internals ----------------------------------------------------------
    def _apply_add(self, name: str, pod: Pod) -> None:
        if name not in self._members:
            self._seq[name] = self._next_seq
            self._next_seq += 1
        self._members[name] = pod
        for m, old, new in self.map.upsert(pod):
            obj = pod if m == name else self._members.get(m)
            if obj is None:
                continue
            self._route(m, old, new, obj)

    def _apply_del(self, name: str, pod: Optional[Pod]) -> None:
        old, moves = self.map.remove(name)
        obj = self._members.pop(name, None) or pod
        self._seq.pop(name, None)
        if old is not None and obj is not None:
            self.session(old).pod_event("DELETED", obj)
            self._cell_members.get(old, {}).pop(name, None)
            self._dirty_cells.add(old)
        for m, mold, mnew in moves:
            mobj = self._members.get(m)
            if mobj is not None:
                self._route(m, mold, mnew, mobj)

    def mark_clean(self, key: CellKey) -> None:
        """The controller solved (or validly reused) this cell's problem:
        until the next event routes into it, the cell's encode is provably
        unchanged and its solve may be served from cache."""
        with self._lock:
            self._dirty_cells.discard(key)

    def _route(self, name: str, old: Optional[CellKey], new: CellKey, pod: Pod) -> None:
        if old is not None and old != new:
            self.session(old).pod_event("DELETED", pod)
            self._cell_members.get(old, {}).pop(name, None)
            self._dirty_cells.add(old)
        self.session(new).pod_event("ADDED", pod)
        members = self._cell_members.setdefault(new, {})
        # a re-add (same cell, fresh object or signature change) moves the
        # pod to the end — mirroring the session's delete-plus-fresh-add
        # re-bucketing, so the split's per-cell order tracks the session's
        members.pop(name, None)
        members[name] = pod
        self._dirty_cells.add(new)

    def _repartition(self, provisioners: Sequence[Provisioner]) -> None:
        """Provisioner basis changed: rebuild the map and route every pod
        whose cell moved as a DELETED/ADDED delta pair — a repartition is a
        burst of ordinary deltas, not a wholesale session rebuild."""
        old = {name: self.map.cell_of(name) for name in self.map.names()}
        self.map = CellMap(provisioners)
        for name in sorted(self._members, key=self._seq.get):
            self.map.upsert(self._members[name])
        for name in sorted(self._members, key=self._seq.get):
            new = self.map.cell_of(name) or RESIDUE
            prior = old.get(name)
            if prior != new:
                self._route(name, prior, new, self._members[name])


# ---------------------------------------------------------------------------
# Apiserver-side classifier + name index (GET /api/{kind}?cell=)
# ---------------------------------------------------------------------------

class CellIndex:
    """Per-object cell classification for the apiserver's ``?cell=`` list
    filter and per-cell watch streams.

    Server cells are PROVISIONER-LEVEL only ("default", ..., "residue"): a
    pure function of the object and the provisioner set, so per-cell watch
    filtering never depends on other objects' state (the router's per-zone
    refinement stays a solver-internal concern). Config kinds and daemonset
    pods classify as ``""`` — delivered to every cell's stream and included
    in every filtered list."""

    FILTERABLE = ("pods", "nodes", "machines")

    def __init__(self, backing) -> None:
        self.backing = backing
        self._lock = threading.Lock()
        self._sig: Optional[tuple] = None
        self._provs: List[Provisioner] = []
        self._obj_cells: Dict[Tuple[str, str], str] = {}
        self._index: Dict[Tuple[str, str], Set[str]] = {}  # (kind, cell) -> names
        self._indexed_kinds: Set[str] = set()
        # feasibility memo (pod content -> cell), basis-scoped like
        # CellMap's: the event hot path classifies a churn burst in
        # O(distinct pod shapes), not O(events x provisioners)
        self._feas_memo: Dict[tuple, str] = {}

    def _refresh_locked(self) -> None:
        provs = list(self.backing.provisioners.values())
        sig = CellMap.basis_sig(provs)
        if sig != self._sig:
            self._sig = sig
            self._provs = sorted(provs, key=lambda p: p.name)
            self._obj_cells.clear()
            self._index.clear()
            self._indexed_kinds.clear()
            self._feas_memo.clear()

    def _classify(self, kind: str, obj) -> str:
        if kind == "pods":
            if obj.is_daemonset:
                return ""
            if obj.node_name is not None:
                node = self.backing.nodes.get(obj.node_name)
                prov = node.provisioner_name() if node is not None else None
                return prov if prov and any(
                    p.name == prov for p in self._provs
                ) else "residue"
            fkey = pod_feas_key(obj)
            hit = self._feas_memo.get(fkey)
            if hit is None:
                feas = feasible_provisioners(obj, self._provs)
                hit = feas[0] if len(feas) == 1 else "residue"
                if len(self._feas_memo) > 8192:
                    self._feas_memo.clear()  # bound: pathological shape churn
                self._feas_memo[fkey] = hit
            return hit
        prov = (
            obj.provisioner_name()
            if kind == "nodes"
            else getattr(obj, "provisioner_name", None)
        )
        if prov and any(p.name == prov for p in self._provs):
            return prov
        return "residue"

    def event_cells(
        self, kind: str, obj, deleted: bool = False
    ) -> Tuple[Tuple[str, ...], str]:
        """``(deliver, current)``: the cells a watch event must reach — the
        object's current cell plus the one it just left (a pod moving cells
        must be seen by both streams, or the old cell's informer cache goes
        stale) — and the cell the object NOW belongs to, so the server can
        deliver the transition to the old cell's stream as an eviction
        (every later event is tagged with the new cell only; without the
        rewrite the old cell's cache would hold the mover forever).
        ``((), "")`` means every cell (config kinds, daemonsets)."""
        if kind not in self.FILTERABLE:
            return (), ""
        with self._lock:
            self._refresh_locked()
            key = (kind, obj.meta.name)
            old = self._obj_cells.get(key)
            cell = self._classify(kind, obj)
            if deleted:
                self._obj_cells.pop(key, None)
            else:
                self._obj_cells[key] = cell
            if kind in self._indexed_kinds:
                if old is not None and old != cell:
                    self._index.get((kind, old), set()).discard(obj.meta.name)
                if deleted:
                    self._index.get((kind, cell), set()).discard(obj.meta.name)
                else:
                    self._index.setdefault((kind, cell), set()).add(obj.meta.name)
            cells = {c for c in (old, cell) if c}
            if not cells or cell == "":
                return (), ""
            return tuple(sorted(cells)), cell

    def members(self, kind: str, cell: str) -> Set[str]:
        """Names in the cell (plus the every-cell class) — the indexed list
        path, built lazily per (kind, partition epoch) and maintained by
        ``event_cells`` so a filtered list costs O(cell), not O(cluster)."""
        if kind not in self.FILTERABLE:
            return set()
        with self._lock:
            self._refresh_locked()
            if kind not in self._indexed_kinds:
                coll = getattr(self.backing, _COLLECTIONS[kind])
                # snapshot under the STORE lock: writers mutate the dict
                # under it, and a resize mid-iteration would blow up this
                # build (no inversion risk — nothing takes the store lock
                # and then calls into the index)
                with self.backing._lock:
                    objs = list(coll.values())
                for obj in objs:
                    c = self._classify(kind, obj)
                    self._obj_cells[(kind, obj.meta.name)] = c
                    self._index.setdefault((kind, c), set()).add(obj.meta.name)
                self._indexed_kinds.add(kind)
            return set(self._index.get((kind, cell), ())) | set(
                self._index.get((kind, ""), ())
            )
