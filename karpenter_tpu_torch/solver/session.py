"""EncodeSession: delta-aware encoding across reconcile rounds.

A full ``encode()`` re-derives everything from the live cluster every round
— at 50k pods the per-pod signature walk plus the compat masks dominate the
reconcile hot path even when only a handful of pods changed. CvxCluster
(PAPERS.md) shows the structural win available by exploiting problem
similarity across rounds; this module realizes it for the encoder: a
session retains the previous round's group records, pre-gate compat rows,
option tables and existing-node columns, consumes dirty-sets fed by watch
events (pod add/delete/modify, node add/remove, provisioner/offering
change, ICE-mask flips arrive as option-list changes), and re-encodes only
the affected rows/columns. Anything it cannot patch falls back to a full
encode; ``last_mode``, ``last_full_reason`` and ``stats`` say which path
each round took.

Equivalence contract (property-tested in tests/test_torch_session.py):
after any sequence of mutations, the session's encode is content-identical
(same ``problem_digest``) to a from-scratch ``encode()`` of the session's
canonically-ordered pod list — so the solver's problem interning, race
memory and banked pattern pools behave identically on both paths.

Canonical order: pods are stamped with a session arrival sequence (re-adds
and signature-changing modifications move to the end, like a fresh watch
event would); groups order by their earliest member. The session therefore
owns pod order — callers pass the current pod set for a cardinality check,
not for ordering.

Object-mutation contract: the session trusts ``meta.resource_version`` to
pin node content and watch events to report pod changes — both hold for
anything routed through ``Cluster.update``/watch (in-process and HTTP
mode). Out-of-band in-place mutation is caught only by the periodic forced
full encode (``full_resync_every``).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api.objects import Pod, Provisioner
from ..api.taints import tolerates_all
from ..cloudprovider.types import InstanceType
from .encode import (
    ENCODE_LOCK,
    _group_members,
    EncodedProblem,
    ExistingNode,
    PodGroup,
    _compat_row,
    _compat_rows,
    _existing_arrays,
    _finalize,
    _get_option_table,
    _get_surface_table,
    _group_arrays,
    _maybe_compact_vocab,
    _node_env,
    _node_surface,
    _option_arrays,
    _ReqTable,
    _resource_axes,
    _signature,
    _taint_index,
    _vector,
    build_options,
    derive_group,
    group_pods,
    zone_list,
)


class _GroupRec:
    """Session-cached state of one pod group (one scheduling signature)."""

    __slots__ = (
        "sig", "members", "first_seq", "caps", "template",
        "demand_row", "compat_row", "row_idx", "cached_group",
    )

    def __init__(self, sig: tuple, template: PodGroup):
        self.sig = sig
        # insertion-ordered name -> pod: dict order IS arrival order (re-adds
        # re-insert at the end), so ``list(members.values())`` reproduces the
        # member order a full encode of the canonical pod list would bucket
        self.members: Dict[str, Pod] = {}
        self.first_seq = 0
        # representative-derived fields, valid for every member (signature-
        # identical pods derive identical caps/terms/tolerations/requests).
        # pods=[] so the template never pins removed pod objects — and never
        # aliases a returned problem's group.
        self.template = dataclasses.replace(template, pods=[])
        self.caps = (
            template.node_cap, template.zone_cap,
            template.zone_skew, template.colocate,
        )
        self.demand_row: Optional[np.ndarray] = None  # float64 [R] (view)
        self.compat_row: Optional[np.ndarray] = None  # PRE-gate bool [O] (view)
        self.row_idx: Optional[int] = None  # row in last round's matrices
        self.cached_group: Optional[PodGroup] = None  # valid while membership unchanged

    def fresh_group(self) -> PodGroup:
        """The group to hand this round's problem. Copy-on-write: while
        membership is unchanged the previous round's PodGroup is reused
        (its pods list is final — nothing mutates it), so a steady-state
        encode only rebuilds the few groups the churn touched; any
        membership mutation clears the cache and the next encode builds a
        NEW PodGroup — problems cache decode state (lazy name lists,
        digests) against their group objects, so a shared group must never
        change content under an interned problem."""
        if self.cached_group is None:
            self.cached_group = dataclasses.replace(
                self.template, pods=list(self.members.values())
            )
        return self.cached_group


class _NodeRec:
    __slots__ = ("sig", "rem_row", "col_idx")

    def __init__(self, sig: tuple, rem_row: np.ndarray):
        self.sig = sig
        self.rem_row = rem_row  # float64 [R], owned (never a matrix view)
        self.col_idx: Optional[int] = None  # column in last round's ex matrix


def _existing_sig(e: ExistingNode) -> tuple:
    """Content pin for one existing-capacity entry. ``resource_version``
    covers every node-object field (labels, taints, cordon, deletion — all
    writes bump it); remaining + bound-pod names cover the capacity view
    recomputed per reconcile."""
    return (
        e.node.meta.resource_version,
        tuple(sorted(e.remaining.items())),
        tuple(p.name for p in e.pods),
        e.node.unschedulable,
        e.node.meta.deletion_timestamp is None,
    )


class _FullNeeded(Exception):
    """Raised inside the delta path when the round cannot be patched."""


def _option_patch_key(o) -> tuple:
    """Identity of everything a compat COLUMN depends on besides allocatable
    (compared separately): the requirement-surface inputs and the taints.
    The id() components are safe from recycling because the session keeps the
    previous option list alive until the patch completes — the old list's
    LaunchOptions pin the provisioner and requirement objects the old keys
    reference."""
    return (
        id(o.provisioner),
        o.provisioner.meta.resource_version,
        id(o.instance_type.requirements),
        o.zone,
        o.capacity_type,
        # slice identity: coordinate-expanded options share every other
        # component, and colliding keys would mispatch compat columns
        o.slice_pod,
        o.slice_coord,
        tuple(t.as_tuple() for t in o.taints),
    )


class EncodeSession:
    """Persistent encoder state for one reconcile loop.

    Thread contract: the dirty-intake methods (``pod_event``,
    ``mark_structural``) are safe from watch threads; ``encode`` runs on the
    reconcile thread and serializes with every other encode in the process
    via ``ENCODE_LOCK``.
    """

    def __init__(self, full_resync_every: int = 64, enabled: bool = True):
        self.enabled = enabled
        self.full_resync_every = max(int(full_resync_every), 0)
        self.last_mode: str = "none"
        self.last_full_reason: str = ""
        self.stats: Dict[str, int] = {"full": 0, "delta": 0}
        self._lock = threading.RLock()
        # queued dirty ops, per pod name (latest op wins; a delete of a
        # queued-but-never-encoded add cancels out). Re-inserting moves the
        # entry to the end so flush order tracks the latest event's arrival.
        self._ops: Dict[str, Tuple[str, Optional[Pod]]] = {}
        self._force_full: Optional[str] = "first-encode"
        self._deltas_since_full = 0
        # pod-side state
        self._seq: Dict[str, int] = {}  # name -> arrival seq
        self._next_seq = 0
        self._by_sig: Dict[tuple, _GroupRec] = {}
        self._pod_rec: Dict[str, _GroupRec] = {}
        # round-cached encode surfaces
        self._axes: Optional[List[str]] = None
        self._zones: Optional[List[str]] = None
        self._zone_index: Dict[str, int] = {}
        self._options: Optional[list] = None
        self._opt_cols: Dict[tuple, int] = {}  # option patch key -> column
        self._alloc: Optional[np.ndarray] = None  # float64 [O, R]
        self._price: Optional[np.ndarray] = None
        self._opt_zone: Optional[np.ndarray] = None
        self._order: List[_GroupRec] = []  # row order of the cached matrices
        self._demand: Optional[np.ndarray] = None  # float64 [G, R]
        self._compat: Optional[np.ndarray] = None  # PRE-gate [G, O]
        self._nodes: Dict[str, _NodeRec] = {}
        self._ex_compat: Optional[np.ndarray] = None  # PRE-seed [G, E]
        # observed problem-shape history (G, O, E, zones, axes) -> (slot
        # budget, fleet width) the solver's bucket last used (slots None
        # until a solve reports it via ``note_bucket_slots``) — the
        # pre-warm hint source. The fleet width rides along so the
        # background worker pre-builds the BATCHED executables the sharded
        # steady state actually dispatches, not just their B=1 shapes. The
        # session sees every round's shape, and unlike the process-wide
        # pattern ring (churned by sweep clones' shapes) this history is the
        # reconcile loop's OWN recent buckets. Bounded; most-recent-kept.
        self._shape_hints: Dict[
            Tuple[int, int, int, int, int], Tuple[Optional[int], int]
        ] = {}

    # -- dirty intake -------------------------------------------------------
    def pod_event(self, event: str, pod: Pod) -> None:
        """Feed one watch event for a pod entering, changing inside, or
        leaving the encoded set. ADDED/MODIFIED re-queue the object (a
        modification that keeps the scheduling signature swaps the object in
        place; one that changes it re-buckets at the end of the canonical
        order, exactly as a delete + fresh add would); DELETED queues a
        removal — a pod leaving the set for ANY reason (bound, deleted,
        phase change) should arrive as DELETED from the session's point of
        view."""
        with self._lock:
            name = pod.meta.name
            if event == "DELETED":
                prior = self._ops.pop(name, None)
                if prior is not None and prior[0] == "add" and name not in self._seq:
                    return  # queued add never encoded: cancels out entirely
                self._ops[name] = ("del", None)
            else:
                self._ops.pop(name, None)
                self._ops[name] = ("add", pod)

    def mark_structural(self, reason: str) -> None:
        """Force the next encode to run full: relist/resync, provisioner
        spec change, or any caller-side doubt about incremental state."""
        with self._lock:
            self._force_full = reason

    # -- encode -------------------------------------------------------------
    def encode(
        self,
        pods: Sequence[Pod],
        provisioners: Sequence[Tuple[Provisioner, Sequence[InstanceType]]],
        existing: Sequence[ExistingNode] = (),
        daemonsets: Sequence[Pod] = (),
        weight_degate: frozenset = frozenset(),
        risk_penalty: float = 0.0,
    ) -> EncodedProblem:
        with self._lock, ENCODE_LOCK:
            _maybe_compact_vocab()
            problem = None
            reason = self._full_reason(weight_degate)
            if reason is None:
                try:
                    problem = self._delta_encode(
                        pods, provisioners, existing, daemonsets, risk_penalty
                    )
                except _FullNeeded as e:
                    reason = str(e)
            if reason is not None:
                problem = self._full_encode(
                    pods, provisioners, existing, daemonsets, weight_degate,
                    risk_penalty,
                )
                self.last_mode, self.last_full_reason = "full", reason
                self.stats["full"] += 1
                self._deltas_since_full = 0
            else:
                self.last_mode, self.last_full_reason = "delta", ""
                self.stats["delta"] += 1
                self._deltas_since_full += 1
            # mode stamp: downstream solver phases label their samples with
            # this round's encode mode
            problem.__dict__["_encode_mode"] = self.last_mode
            self._note_shape(problem)
            return problem

    def _note_shape(self, problem: EncodedProblem) -> None:
        dims = (
            problem.G, problem.O, problem.E,
            len(problem.zones), len(problem.resource_axes),
        )
        hints = self._shape_hints
        # re-insert most-recent, keep known (S, fleet width)
        entry = hints.pop(dims, (None, 1))
        hints[dims] = entry
        while len(hints) > 8:
            hints.pop(next(iter(hints)))

    def note_bucket_slots(
        self, dims: Tuple[int, int, int, int, int], slots: int, fleet: int = 1
    ) -> None:
        """The solver reports which slot budget ``dims`` actually solved
        with — a hint without it cannot be pre-compiled (the bucket's S is a
        solver-side estimate the session cannot derive) — plus the fleet
        width the dispatch batched at (1 = un-batched), so the hint
        pre-builds the executable variant the next such round will call."""
        with self._lock:
            if dims in self._shape_hints:
                # an un-batched (fleet=1) round keeps the learned width:
                # cells solve alone whenever they churn alone, and that
                # must not stop the pre-compiler building the batched
                # variant the next multi-cell round dispatches
                prior = self._shape_hints[dims][1]
                width = int(fleet) if int(fleet) > 1 else prior
                self._shape_hints[dims] = (slots, max(width or 1, 1))

    def shape_hints(
        self,
    ) -> List[Tuple[int, int, int, int, int, Optional[int], int]]:
        """Recent distinct problem shapes this session encoded (oldest
        first), each with the solver-reported slot budget (or None) and
        the last fleet width — the hints a solver's pre-warm hook would
        read. The port's ``Solver._prewarm`` is a no-op and nothing calls
        ``note_bucket_slots`` yet, so every slot budget here is None."""
        with self._lock:
            return [dims + entry for dims, entry in self._shape_hints.items()]

    def flush_pending(self) -> None:
        """Apply queued pod ops to the membership records without encoding —
        the cell router calls this before reading ``ordered_pods`` of a
        session whose cell had nothing to solve this round (its queued
        deletes must still land, or the canonical order goes stale)."""
        with self._lock, ENCODE_LOCK:
            self._flush_ops()

    def ordered_pods(self) -> List[Pod]:
        """The session's canonical pod sequence (arrival order): a full
        ``encode()`` of exactly this list is the delta path's equivalence
        oracle."""
        with self._lock:
            out = [
                (self._seq[name], pod)
                for rec in self._by_sig.values()
                for name, pod in rec.members.items()
            ]
            out.sort(key=lambda t: t[0])
            return [p for _, p in out]

    def approx_bytes(self) -> int:
        """Approximate footprint of the session's cached encode state (the
        numpy matrices dominate) — the per-cell memory signal the sharded
        control plane exports through runtimehealth."""
        with self._lock:
            total = 0
            for arr in (
                self._alloc, self._price, self._opt_zone,
                self._demand, self._compat, self._ex_compat,
            ):
                if arr is not None:
                    total += arr.nbytes
            for rec in self._nodes.values():
                total += rec.rem_row.nbytes
            # rough per-pod bookkeeping overhead (seq + member dict slots)
            total += 96 * len(self._seq)
            return total

    # -- internals ----------------------------------------------------------
    def _full_reason(self, weight_degate: frozenset) -> Optional[str]:
        if not self.enabled:
            return "disabled"
        if self._force_full is not None:
            reason, self._force_full = self._force_full, None
            return reason
        if weight_degate:
            return "weight-degate"
        if (
            self.full_resync_every
            and self._deltas_since_full >= self.full_resync_every
        ):
            return "periodic-resync"
        return None

    def _full_encode(
        self, pods, provisioners, existing, daemonsets, weight_degate,
        risk_penalty=0.0,
    ):
        """Full pipeline, capturing the pre-gate/pre-seed state the delta
        path patches next round. Mirrors encode() stage by stage."""
        self._ops.clear()
        pods = list(pods)
        groups = group_pods(pods)
        options = build_options(provisioners, daemonsets, risk_penalty)
        axes = _resource_axes(groups, options)
        zones = zone_list(options, existing)
        zone_index = {z: i for i, z in enumerate(zones)}
        demand, count, node_cap, zone_cap, zone_skew, colocate = _group_arrays(
            groups, axes
        )
        alloc, price, opt_zone = _option_arrays(options, axes, zone_index)
        opt_table = _get_option_table(options)
        taint_index = _taint_index(options)
        G, O = len(groups), len(options)
        compat = _compat_rows(groups, opt_table, taint_index, alloc, demand)
        ex_rem, ex_zone, ex_compat = _existing_arrays(
            groups, existing, provisioners, zone_index, axes, demand
        )

        # -- capture session state (before _finalize mutates the masks) ------
        self._seq = {}
        self._next_seq = 0
        self._by_sig = {}
        self._pod_rec = {}
        for p in pods:
            self._seq[p.meta.name] = self._next_seq
            self._next_seq += 1
        self._axes = axes
        self._zones = zones
        self._zone_index = zone_index
        self._options = options
        self._opt_cols = {_option_patch_key(o): j for j, o in enumerate(options)}
        self._alloc = alloc
        self._price = price
        self._opt_zone = opt_zone
        self._demand = demand.copy()
        self._compat = compat.copy()
        self._order = []
        for i, g in enumerate(groups):
            sig = g.pods[0].__dict__.get("_sched_sig") or _signature(g.pods[0])
            rec = _GroupRec(sig, g)
            for p in g.pods:
                rec.members[p.meta.name] = p
                self._pod_rec[p.meta.name] = rec
            rec.first_seq = self._seq[g.pods[0].meta.name]
            rec.demand_row = self._demand[i]
            rec.compat_row = self._compat[i]
            rec.row_idx = i
            # the full encode's own group is this round's final content:
            # safe to serve as the cached group until membership changes
            rec.cached_group = g
            self._by_sig[sig] = rec
            self._order.append(rec)
        self._nodes = {}
        for k, e in enumerate(existing):
            nrec = _NodeRec(_existing_sig(e), ex_rem[k].copy())
            nrec.col_idx = k
            self._nodes[e.node.name] = nrec
        self._ex_compat = ex_compat.copy()

        return _finalize(
            groups, options, existing, axes, zones, zone_index,
            demand, count, node_cap, zone_cap, zone_skew, colocate,
            alloc, price, opt_zone, compat, ex_rem, ex_zone, ex_compat,
            weight_degate,
        )

    def _flush_ops(self) -> None:
        """Apply the queued pod ops to the group records: removals first,
        then additions bucketed through the native encoder's hot loop (one
        C pass + one signature per BUCKET, not per pod — the adjacency fast
        path only stamps run leaders with ``_sched_sig``). Per-name op
        collapse in ``pod_event`` guarantees at most one op per pod, so
        dels-before-adds is order-equivalent to event order: a del never
        consumes an arrival sequence, and re-adds still land at the end.
        Bucketing tolerates the same key-order variance ``_items_t`` does —
        value-equal pods may merge into one group where a key-order mismatch
        would have split them into two equivalent ones; never an incorrect
        grouping."""
        if not self._ops:
            return
        ops = list(self._ops.items())
        self._ops.clear()
        adds: List[Pod] = []
        for name, (op, pod) in ops:
            if op == "del":
                old = self._pod_rec.get(name)
                if old is not None:
                    self._remove_member(old, name)
            else:
                adds.append(pod)
        if not adds:
            return
        # the SAME native-or-python bucketing a full encode uses — the delta
        # path's grouping can never drift from the behavioral reference
        for members in _group_members(adds):
            leader = members[0]
            sig = leader.__dict__.get("_sched_sig") or _signature(leader)
            rec = self._by_sig.get(sig)
            if rec is None:
                rec = _GroupRec(sig, derive_group([leader]))
                rec.first_seq = self._next_seq
                self._by_sig[sig] = rec
            rec.cached_group = None
            rec_members = rec.members
            pod_rec, seq = self._pod_rec, self._seq
            for pod in members:
                name = pod.meta.name
                old = pod_rec.get(name)
                if old is not None:
                    if old.sig == sig:
                        # same scheduling identity: swap the object in place
                        # (position in the member dict — and thus canonical
                        # order — is preserved, as a full encode would see)
                        if old.members[name] is not pod:
                            old.members[name] = pod
                            old.cached_group = None
                        continue
                    self._remove_member(old, name)  # old.sig != sig: never rec
                rec_members[name] = pod
                pod_rec[name] = rec
                seq[name] = self._next_seq
                self._next_seq += 1

    def _remove_member(self, rec: _GroupRec, name: str) -> None:
        del rec.members[name]
        del self._pod_rec[name]
        del self._seq[name]
        rec.cached_group = None
        if not rec.members:
            del self._by_sig[rec.sig]
        else:
            rec.first_seq = self._seq[next(iter(rec.members))]

    def _delta_encode(self, pods, provisioners, existing, daemonsets, risk_penalty=0.0):
        self._flush_ops()
        if len(pods) != len(self._seq):
            raise _FullNeeded("pod-set-desync")

        recs = sorted(self._by_sig.values(), key=lambda r: r.first_seq)
        groups = [r.fresh_group() for r in recs]
        # risk_penalty scales every option's risk_cost, so a changed penalty
        # (settings flip) yields a NEW option list here — the option-axis
        # patch below then rebuilds the price array; compat columns are
        # risk-independent and keep their patch-key reuse.
        options = build_options(provisioners, daemonsets, risk_penalty)

        axes = _resource_axes(groups, options)
        if axes != self._axes:
            raise _FullNeeded("axes-changed")
        zones = zone_list(options, existing)
        if zones != self._zones:
            raise _FullNeeded("zones-changed")
        zone_index = self._zone_index

        # -- option axis: reuse, or patch compat by column -------------------
        if options is not self._options:
            self._patch_options(options, axes)
        alloc, price, opt_zone = self._alloc, self._price, self._opt_zone
        O = len(options)

        # -- group rows ------------------------------------------------------
        G, R = len(recs), len(axes)
        fresh = [r for r in recs if r.compat_row is None]
        if fresh:
            opt_table = _get_option_table(options)
            taint_index = _taint_index(options)
            for r in fresh:
                tmpl = r.template
                r.demand_row = _vector(tmpl.requests, axes, pods=1.0)
                r.compat_row = (
                    _compat_row(tmpl, opt_table, taint_index, alloc, axes)
                    if O
                    else np.zeros(0, dtype=bool)
                )
        fresh_ids = {id(r) for r in fresh}
        demand = (
            np.stack([r.demand_row for r in recs])
            if recs else np.zeros((0, R), np.float64)
        )
        compat = (
            np.stack([r.compat_row for r in recs]).reshape(G, O)
            if recs else np.zeros((0, O), bool)
        )
        count = np.fromiter((len(r.members) for r in recs), np.int32, count=G)
        node_cap = np.fromiter((r.caps[0] for r in recs), np.int64, count=G)
        zone_cap = np.fromiter((r.caps[1] for r in recs), np.int64, count=G)
        zone_skew = np.fromiter((r.caps[2] for r in recs), np.int32, count=G)
        colocate = np.fromiter((r.caps[3] for r in recs), bool, count=G)

        # -- existing axis ---------------------------------------------------
        ex_rem, ex_zone, ex_compat = self._patch_existing(
            existing, recs, demand, provisioners, axes, zone_index, fresh_ids
        )

        # -- persist the new pre-state; every cached row becomes a view into
        # the LATEST matrices (a row view pinning its original backing matrix
        # would otherwise keep one dead [G, O] alive per surviving group) ----
        self._demand = demand.copy()
        self._compat = compat.copy()
        self._ex_compat = ex_compat.copy()
        for i, r in enumerate(recs):
            r.row_idx = i
            r.demand_row = self._demand[i]
            r.compat_row = self._compat[i]
        self._order = recs
        return _finalize(
            groups, options, existing, axes, zones, zone_index,
            demand, count, node_cap, zone_cap, zone_skew, colocate,
            alloc, price, opt_zone, compat, ex_rem, ex_zone, ex_compat,
            frozenset(),
        )

    def _patch_options(self, options: list, axes) -> None:
        """The option list changed (offering/price/ICE flip, daemonset or
        pool-set change): rebuild the option-axis arrays and patch compat
        COLUMNS — a column whose patch key matches and whose allocatable row
        is unchanged keeps its cached values; everything else re-evaluates,
        for every cached group, against just those options."""
        alloc, price, opt_zone = _option_arrays(options, axes, self._zone_index)
        old_cols, old_alloc, old_compat = self._opt_cols, self._alloc, self._compat
        O = len(options)
        new_cols = {_option_patch_key(o): j for j, o in enumerate(options)}
        src = np.full(O, -1, np.int64)
        for key, j in new_cols.items():
            k = old_cols.get(key)
            if k is not None and np.array_equal(alloc[j], old_alloc[k]):
                src[j] = k
        kept = src >= 0
        G_old = old_compat.shape[0] if old_compat is not None else 0
        compat = np.zeros((G_old, O), dtype=bool)
        if kept.any() and G_old:
            compat[:, kept] = old_compat[:, src[kept]]
        fresh_cols = np.flatnonzero(~kept)
        if fresh_cols.size and G_old:
            sub = [options[j] for j in fresh_cols]
            table = _ReqTable([o.node_requirements for o in sub])
            sub_taints = _taint_index(sub)
            sub_alloc = alloc[fresh_cols]
            for r in self._order:
                if r.compat_row is None or r.row_idx is None:
                    continue
                row = _compat_row(r.template, table, sub_taints, sub_alloc, axes)
                compat[r.row_idx, fresh_cols] = row
        # re-slice the cached per-group rows out of the patched matrix
        self._compat = compat
        for r in self._order:
            if r.compat_row is not None and r.row_idx is not None:
                r.compat_row = compat[r.row_idx]
        self._options = options
        self._opt_cols = new_cols
        self._alloc, self._price, self._opt_zone = alloc, price, opt_zone

    def _patch_existing(
        self, existing, recs, demand, provisioners, axes, zone_index, fresh_ids
    ):
        """Diff the existing-capacity roster against the cached node columns:
        unchanged nodes (same node version, remaining, bound pods) keep their
        column; changed/new nodes re-evaluate one column across all groups;
        fresh GROUPS evaluate one full row across all nodes."""
        E, R = len(existing), len(axes)
        G = len(recs)
        ex_rem = np.zeros((E, R), np.float64)
        ex_zone = np.zeros((E,), np.int32)
        ex_compat = np.zeros((G, E), dtype=bool)
        if not E:
            self._nodes = {}
            return ex_rem, ex_zone, ex_compat
        old_nodes, old_ex = self._nodes, self._ex_compat
        new_nodes: Dict[str, _NodeRec] = {}
        src = np.full(E, -1, np.int64)
        dirty: List[int] = []
        for k, e in enumerate(existing):
            name = e.node.name
            sig = _existing_sig(e)
            rec = old_nodes.get(name)
            if rec is not None and rec.sig == sig and rec.col_idx is not None:
                src[k] = rec.col_idx
                ex_rem[k] = rec.rem_row
            else:
                rec = _NodeRec(sig, _vector(e.remaining, axes))
                ex_rem[k] = rec.rem_row
                dirty.append(k)
            ex_zone[k] = zone_index.get(e.node.zone(), 0)
            rec.col_idx = k
            new_nodes[name] = rec
        # survivor block in one gather: rows are surviving groups (their old
        # row index), columns the unchanged nodes (their old column index)
        kept = np.flatnonzero(src >= 0)
        surv_pos = [
            i for i, r in enumerate(recs)
            if id(r) not in fresh_ids and r.row_idx is not None
        ]
        if kept.size and surv_pos and old_ex is not None and old_ex.size:
            old_rows = np.asarray([recs[i].row_idx for i in surv_pos])
            ex_compat[np.ix_(np.asarray(surv_pos), kept)] = old_ex[
                np.ix_(old_rows, src[kept])
            ]
        # dirty node columns: evaluate across every group
        if dirty:
            sub = [existing[k] for k in dirty]
            table = _ReqTable([_node_surface(e.node) for e in sub])
            schedulable, eff_taints = _node_env(sub, provisioners)
            tol_memo: Dict[tuple, np.ndarray] = {}
            rem_sub = ex_rem[dirty]
            cols = np.asarray(dirty)
            for i, r in enumerate(recs):
                tmpl = r.template
                tol_ok = tol_memo.get(tmpl.tolerations)
                if tol_ok is None:
                    tols = list(tmpl.tolerations)
                    tol_ok = np.array(
                        [tolerates_all(tols, t) for t in eff_taints], bool
                    )
                    tol_memo[tmpl.tolerations] = tol_ok
                req_ok = table.eval_terms(tmpl.terms)
                cap_ok = ~np.any(demand[i][None, :] > rem_sub + 1e-9, axis=1)
                ex_compat[i, cols] = schedulable & tol_ok & req_ok & cap_ok
        # fresh group rows: evaluate across the whole roster (idempotent with
        # the dirty-column pass for the overlap)
        fresh_pos = [i for i, r in enumerate(recs) if id(r) in fresh_ids]
        if fresh_pos:
            roster_table = _get_surface_table(
                [_node_surface(e.node) for e in existing]
            )
            schedulable, eff_taints = _node_env(existing, provisioners)
            ex_taint_groups: Dict[tuple, list] = {}
            for k, taints in enumerate(eff_taints):
                ex_taint_groups.setdefault(taints, []).append(k)
            for i in fresh_pos:
                tmpl = recs[i].template
                tol_ok = np.zeros(E, bool)
                tols = list(tmpl.tolerations)
                for taints, idx in ex_taint_groups.items():
                    if tolerates_all(tols, taints):
                        tol_ok[np.asarray(idx)] = True
                req_ok = roster_table.eval_terms(tmpl.terms)
                cap_ok = ~np.any(demand[i][None, :] > ex_rem + 1e-9, axis=1)
                ex_compat[i] = schedulable & tol_ok & req_ok & cap_ok
        self._nodes = new_nodes
        return ex_rem, ex_zone, ex_compat
