"""Scheduling-decision audit log: WHY did the controllers do what they did.

Constraint-based packers are opaque in production: the metrics say a node
launched and a pod bound, but not why THAT instance type won, which cheaper
offerings were rejected (and whether the reason was a requirements mismatch,
an ICE mask, capacity, or plain price), or why consolidation looked at a node
and declined to act. This module is the explainability layer the
Priority-Matters / KubePACS line of work calls out as table stakes for
operating such a system: a bounded ring of structured decision records,
emitted by the provisioning and deprovisioning controllers, exported on the
operator's ``/debug/decisions`` endpoint with filtering by pod / node /
reconcile id / trace id, and counted in
``karpenter_tpu_decisions_total{kind,outcome}``.

Record kinds:

* ``placement`` — one pod's verdict for one round: bound to a new or
  existing node (with the chosen instance type/zone/price and the top-k
  rejected cheaper alternatives, each with its reject reason), or
  unschedulable.
* ``nomination`` — one solver node spec's verdict: launched, blocked by a
  provisioner limit, failed with insufficient capacity, or failed at launch.
* ``consolidation`` — the deprovisioner's verdicts: acted / planned /
  aborted / blocked (with the blocking pod), deferred (stabilization window,
  pending pods), or no-action sweeps.

Every record auto-captures the active ``reconcile_id`` (from the structured-
log context the controller kit opens) and the active ``trace_id`` (from the
tracing stack), so a decision joins its log lines AND its span tree on
``/debug/traces`` — the three "why" workflows in docs/observability.md walk
exactly that join.

Retention is a ring (``capacity`` most recent records): an operator records
one placement per pod per round, so an unbounded list is a fast leak.
High-frequency repeat verdicts (consolidation deferred on the stabilization
window every tick) coalesce into one record with a bumped ``count`` instead
of flooding the ring.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

from . import metrics, tracing
from .logging import context_fields

#: thread-local write redirect: the replay harness re-runs real controllers,
#: whose module-level ``DECISIONS.record(...)`` calls would otherwise write
#: phantom verdicts into the LIVE audit ring (and concurrently-admitted live
#: records would leak into the replay's capture window)
_redirect = threading.local()

#: thread-local tee: callers that need EVERY record a round admits — the
#: flight recorder's capsule assembly — collect into side buffers, immune to
#: ring eviction (a 5k-pod round overflows a 2048 ring before the round
#: ends) and to records admitted concurrently from other threads
_tee = threading.local()


class tee_decisions:
    """Collect every record THIS thread admits (through any DecisionLog)
    into a list for the duration. Stacks; coalesced bumps of pre-existing
    records are not re-collected (they are not new admissions)."""

    def __init__(self):
        self.records: List[DecisionRecord] = []

    def __enter__(self) -> "tee_decisions":
        bufs = getattr(_tee, "bufs", None)
        if bufs is None:
            bufs = _tee.bufs = []
        bufs.append(self.records)
        return self

    def __exit__(self, *exc):
        # remove by IDENTITY, not list.remove()'s == matching: two stacked
        # empty buffers are value-equal, and popping the wrong one would
        # silently detach the outer tee
        bufs = getattr(_tee, "bufs", None)
        if bufs is not None:
            for i, buf in enumerate(bufs):
                if buf is self.records:
                    del bufs[i]
                    break
        return False


class redirect_decisions:
    """Route this thread's DECISIONS writes into ``log`` for the duration."""

    def __init__(self, log: "DecisionLog"):
        self._log = log

    def __enter__(self) -> "DecisionLog":
        self._prev = getattr(_redirect, "log", None)
        _redirect.log = self._log
        return self._log

    def __exit__(self, *exc):
        _redirect.log = self._prev
        return False


@dataclass
class DecisionRecord:
    kind: str  # placement | nomination | consolidation
    outcome: str
    pod: str = ""
    node: str = ""
    reason: str = ""
    reconcile_id: str = ""
    trace_id: str = ""
    timestamp: float = field(default_factory=time.time)
    count: int = 1  # coalesced repeats (see record_coalesced)
    details: Dict = field(default_factory=dict)
    seq: int = 0  # ring admission sequence (eviction detection), not serialized

    def to_dict(self) -> Dict:
        out = {
            "kind": self.kind,
            "outcome": self.outcome,
            "timestamp": round(self.timestamp, 3),
        }
        for key in ("pod", "node", "reason", "reconcile_id", "trace_id"):
            value = getattr(self, key)
            if value:
                out[key] = value
        if self.count > 1:
            out["count"] = self.count
        if self.details:
            out["details"] = dict(self.details)
        return out


class DecisionLog:
    DEFAULT_CAPACITY = 2048
    #: coalesce-key map bound: the map pins record objects, so the LEAST
    #: RECENTLY BUMPED key is evicted past this (never a full reset — with
    #: more distinct repeating verdicts than the cap, a reset would collapse
    #: coalescing entirely and every pass would flood the ring)
    _COALESCE_MAX = 256

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._ring: Deque[DecisionRecord] = deque(maxlen=max(capacity, 1))
        self.enabled = capacity > 0
        self._coalesce: "OrderedDict[tuple, DecisionRecord]" = OrderedDict()
        self._next_seq = 0  # monotonically counts ring admissions

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    def configure(self, capacity: int) -> None:
        """Resize the ring (settings.decision_log_capacity); 0 disables
        recording entirely (the bench overhead guard's off mode)."""
        with self._lock:
            self.enabled = capacity > 0
            if capacity > 0 and capacity != self._ring.maxlen:
                self._ring = deque(self._ring, maxlen=capacity)
            self._coalesce.clear()

    def record(
        self,
        kind: str,
        outcome: str,
        *,
        pod: str = "",
        node: str = "",
        reason: str = "",
        details: Optional[Dict] = None,
        value: float = 1.0,
    ) -> Optional[DecisionRecord]:
        """Append one record, auto-capturing reconcile/trace correlation ids,
        and count it in karpenter_tpu_decisions_total. ``value`` batches the
        metric increment: a per-pod loop over one node spec incs the counter
        once with the pod count (value=N on the first record, 0 after), so a
        50k-pod round pays one labeled inc per spec, not per pod."""
        target = getattr(_redirect, "log", None)
        if target is not None and target is not self:
            return target.record(
                kind, outcome, pod=pod, node=node, reason=reason,
                details=details, value=value,
            )
        bufs = getattr(_tee, "bufs", ())
        if not self.enabled and not bufs:
            return None
        rec = DecisionRecord(
            kind=kind, outcome=outcome, pod=pod, node=node, reason=reason,
            reconcile_id=str(context_fields().get("reconcile_id", "")),
            trace_id=tracing.current_trace_id(),
            details=details if details is not None else {},
        )
        # the tee observes admissions INDEPENDENT of the audit ring's
        # enabled state: a disabled ring (capacity 0) must not silently
        # empty flight-recorder capsules — replay's ICE pre-seed reads
        # ice-failed nominations from the capsule's decision list
        for buf in bufs:
            buf.append(rec)
        if not self.enabled:
            return rec
        with self._lock:
            rec.seq = self._next_seq
            self._next_seq += 1
            self._ring.append(rec)
        if value:
            metrics.DECISIONS_TOTAL.inc({"kind": kind, "outcome": outcome}, value)
        return rec

    def record_coalesced(
        self,
        kind: str,
        outcome: str,
        *,
        pod: str = "",
        node: str = "",
        reason: str = "",
        details: Optional[Dict] = None,
    ) -> Optional[DecisionRecord]:
        """Like record(), but an identical repeat verdict (same kind/outcome/
        pod/node/reason) bumps the existing record's count and timestamp
        instead of appending — the per-tick "consolidation deferred:
        stabilization window" stream must not push real placements out of
        the ring. The metric still counts every occurrence."""
        target = getattr(_redirect, "log", None)
        if target is not None and target is not self:
            return target.record_coalesced(
                kind, outcome, pod=pod, node=node, reason=reason, details=details,
            )
        if not self.enabled:
            # a disabled ring has no coalesce state; active tees still see
            # each occurrence as a plain record
            return self.record(
                kind, outcome, pod=pod, node=node, reason=reason,
                details=details, value=0.0,
            )
        key = (kind, outcome, pod, node, reason)
        with self._lock:
            prior = self._coalesce.get(key)
            # EVICTION GUARD: a coalesced record pushed out of the ring by
            # other traffic must not keep absorbing bumps invisibly — the
            # admission-sequence check is O(1) (evicted iff at least maxlen
            # newer admissions happened); a fresh record re-enters the ring
            if prior is not None and (
                self._next_seq - prior.seq >= (self._ring.maxlen or 1)
            ):
                del self._coalesce[key]
                prior = None
            if prior is not None:
                prior.count += 1
                prior.timestamp = time.time()
                prior.reconcile_id = str(context_fields().get("reconcile_id", ""))
                prior.trace_id = tracing.current_trace_id()
                if details:
                    prior.details.update(details)
                self._coalesce.move_to_end(key)
                metrics.DECISIONS_TOTAL.inc({"kind": kind, "outcome": outcome})
                return prior
        rec = self.record(
            kind, outcome, pod=pod, node=node, reason=reason, details=details
        )
        if rec is not None:
            with self._lock:
                self._coalesce[key] = rec
                self._coalesce.move_to_end(key)
                while len(self._coalesce) > self._COALESCE_MAX:
                    self._coalesce.popitem(last=False)
        return rec

    def query(
        self,
        pod: Optional[str] = None,
        node: Optional[str] = None,
        reconcile_id: Optional[str] = None,
        trace_id: Optional[str] = None,
        kind: Optional[str] = None,
        limit: int = 256,
    ) -> List[DecisionRecord]:
        """Newest-first filtered view (the /debug/decisions payload)."""
        with self._lock:
            records = list(self._ring)
        out: List[DecisionRecord] = []
        for rec in reversed(records):
            if pod is not None and rec.pod != pod:
                continue
            if node is not None and rec.node != node:
                continue
            if reconcile_id is not None and rec.reconcile_id != reconcile_id:
                continue
            if trace_id is not None and rec.trace_id != trace_id:
                continue
            if kind is not None and rec.kind != kind:
                continue
            out.append(rec)
            if len(out) >= limit:
                break
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._coalesce.clear()


#: process-wide default log (controllers and the debug HTTP surface import
#: this, like TRACER and REGISTRY)
DECISIONS = DecisionLog()
