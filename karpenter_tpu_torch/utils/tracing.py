"""Lightweight tracing/profiling for the control loops.

The reference exposes pprof profiling behind an operator flag and times its
cloud-provider calls through a metrics decorator
(``karpenter_cloudprovider_duration_seconds``). This module is the tracing
side of that observability story, TPU-control-plane shaped:

* ``span("solve.encode")`` context-managers nest into a thread-local stack,
  producing a tree of timed spans per operation;
* every span carries W3C-trace-context identity — a 128-bit ``trace_id``
  minted at (or adopted by) the root and shared by the whole tree, plus a
  64-bit ``span_id`` per span and the parent's id — so a trace can CROSS a
  process boundary: the HTTP clients inject ``current_traceparent()`` as a
  ``traceparent`` header, and the apiserver / cloud HTTP services open a
  ``server_span`` that adopts the caller's trace id (and the originating
  ``reconcile_id``), stitching one reconcile's client, apiserver and cloud
  spans into a single trace on ``/debug/traces``;
* spans carry bounded EVENT lists (``add_event``): the resilience layer
  stamps retries and breaker transitions onto the active span, so a slow
  round is attributable (which call retried, which circuit opened) at a
  glance;
* the last completed ROOT span tree per name is kept in true LRU order
  (re-recording a name refreshes it; the stalest name is evicted), exported
  as JSON on the operator's ``/debug/traces`` endpoint;
* per-span child lists are capped (``max_children``) so a pathological loop
  recording thousands of sub-spans cannot balloon a trace tree — overflow is
  counted on the parent instead of stored;
* always-on cheap (perf_counter + list append); no-op when disabled.

Controllers wrap their reconcile bodies (the controller kit stamps a
``reconcile_id`` correlation attr shared with the structured logger); the
solver wraps encode/solve/decode/validate, which is how "where did the 100ms
go" questions get answered without a profiler attached (spans show up in
SolveResult.stats via the solver's timings too).
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_state = threading.local()

#: per-span event cap, same spirit as max_children: a retry storm must not
#: balloon one span into an unbounded event list
_MAX_EVENTS = 64


def _trace_id() -> str:
    return os.urandom(16).hex()


def _span_id() -> str:
    return os.urandom(8).hex()


def format_traceparent(trace_id: str, span_id: str) -> str:
    """W3C trace-context header value (version 00, sampled)."""
    return f"00-{trace_id}-{span_id}-01"


def parse_traceparent(value: Optional[str]) -> Optional[Tuple[str, str]]:
    """(trace_id, parent_span_id) from a ``traceparent`` header, or None for
    anything malformed — a bad header must degrade to a fresh trace, never
    fail the request."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) < 4:
        return None
    _, trace_id, span_id = parts[0], parts[1], parts[2]
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


@dataclass
class Span:
    name: str
    start: float
    end: float = 0.0
    children: List["Span"] = field(default_factory=list)
    attrs: Dict[str, object] = field(default_factory=dict)
    children_dropped: int = 0  # overflow beyond the tracer's max_children cap
    trace_id: str = ""
    span_id: str = ""
    parent_span_id: str = ""
    events: List[Dict] = field(default_factory=list)
    events_dropped: int = 0

    @property
    def duration_ms(self) -> float:
        return (self.end - self.start) * 1e3

    def add_event(self, name: str, **attrs) -> None:
        """Point-in-time annotation (retry, breaker trip) on this span."""
        if len(self.events) >= _MAX_EVENTS:
            self.events_dropped += 1
            return
        ev: Dict[str, object] = {
            "name": name,
            "at_ms": round((time.perf_counter() - self.start) * 1e3, 3),
        }
        if attrs:
            ev.update(attrs)
        self.events.append(ev)

    def to_dict(self) -> Dict:
        out = {"name": self.name, "ms": round(self.duration_ms, 3)}
        if self.trace_id:
            out["trace_id"] = self.trace_id
        if self.span_id:
            out["span_id"] = self.span_id
        if self.parent_span_id:
            out["parent_span_id"] = self.parent_span_id
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        if self.events:
            out["events"] = [dict(e) for e in self.events]
        if self.events_dropped:
            out["events_dropped"] = self.events_dropped
        if self.children:
            out["children"] = [c.to_dict() for c in self.children]
        if self.children_dropped:
            out["children_dropped"] = self.children_dropped
        return out

    def flat(self, prefix: str = "") -> Dict[str, float]:
        """{dotted.path: ms} for metrics/stats export."""
        path = f"{prefix}.{self.name}" if prefix else self.name
        out = {path: round(self.duration_ms, 3)}
        for c in self.children:
            out.update(c.flat(path))
        return out


class Tracer:
    def __init__(
        self,
        enabled: bool = True,
        keep: int = 64,
        max_children: int = 128,
        keep_traces: int = 32,
        max_trace_roots: int = 512,
    ):
        self.enabled = enabled
        self.keep = keep
        self.max_children = max_children
        self.keep_traces = keep_traces
        self.max_trace_roots = max_trace_roots
        self._lock = threading.Lock()
        # root span name -> (most recent tree, wall-clock recorded_at), kept
        # in LRU order: recording moves the name to most-recent, eviction
        # drops the least-recently-RECORDED name (not merely insertion order)
        self._last: "OrderedDict[str, Tuple[Span, float]]" = OrderedDict()
        # trace id -> [ [(root, recorded_at), ...], dropped ]: the per-name
        # LRU above keeps only the LAST root per route, so a reconcile's 50
        # bind round-trips would survive as one span — this index retains
        # EVERY root of the `keep_traces` most recent traces (roots capped at
        # `max_trace_roots`, overflow counted), making /debug/traces?trace_id=
        # a complete distributed trace rather than a per-route sample
        self._by_trace: "OrderedDict[str, list]" = OrderedDict()

    @contextmanager
    def span(self, name: str, **attrs):
        with self._span(name, None, None, attrs) as s:
            yield s

    @contextmanager
    def server_span(self, name: str, traceparent: Optional[str] = None, **attrs):
        """Service-side root span adopting the caller's trace context: the
        span joins the caller's trace (same ``trace_id``, caller's span as
        parent) when a valid ``traceparent`` header is presented, and starts
        a fresh trace otherwise — the request is never rejected over a bad
        header."""
        remote = parse_traceparent(traceparent)
        trace_id = parent = None
        if remote is not None:
            trace_id, parent = remote
        with self._span(name, trace_id, parent, attrs) as s:
            yield s

    @contextmanager
    def _span(self, name, trace_id, parent_span_id, attrs):
        if not self.enabled:
            yield None
            return
        stack: List[Span] = getattr(_state, "stack", None) or []
        _state.stack = stack
        if stack:
            # nested: inherit the tree's trace id, parent is the enclosing span
            trace_id = stack[-1].trace_id
            parent_span_id = stack[-1].span_id
        elif trace_id is None:
            trace_id = _trace_id()  # fresh root: mint a trace
        s = Span(
            name=name,
            start=time.perf_counter(),
            attrs=dict(attrs),
            trace_id=trace_id,
            span_id=_span_id(),
            parent_span_id=parent_span_id or "",
        )
        stack.append(s)
        try:
            yield s
        finally:
            s.end = time.perf_counter()
            stack.pop()
            if stack:
                parent = stack[-1]
                if len(parent.children) < self.max_children:
                    parent.children.append(s)
                else:
                    parent.children_dropped += 1
            else:
                with self._lock:
                    at = time.time()
                    self._last[name] = (s, at)
                    self._last.move_to_end(name)
                    while len(self._last) > self.keep:
                        self._last.popitem(last=False)
                    entry = self._by_trace.get(s.trace_id)
                    if entry is None:
                        entry = self._by_trace[s.trace_id] = [[], 0]
                    self._by_trace.move_to_end(s.trace_id)
                    if len(entry[0]) < self.max_trace_roots:
                        entry[0].append((s, at))
                    else:
                        entry[1] += 1
                    while len(self._by_trace) > self.keep_traces:
                        self._by_trace.popitem(last=False)

    def last_trace(self, name: str) -> Optional[Span]:
        with self._lock:
            entry = self._last.get(name)
            return entry[0] if entry is not None else None

    def last_flat(self, name: str) -> Dict[str, float]:
        s = self.last_trace(name)
        return s.flat() if s is not None else {}

    def traces(self) -> List[Tuple[str, Span, float]]:
        """(name, root span, recorded_at) most-recently-recorded first."""
        with self._lock:
            return [(n, s, at) for n, (s, at) in reversed(self._last.items())]

    def trace_roots(self, trace_id: str) -> List[Tuple[Span, float]]:
        """Every retained (root span, recorded_at) of one trace, newest
        first — served from the per-trace index, so same-route roots within
        a trace do not shadow each other."""
        with self._lock:
            entry = self._by_trace.get(trace_id)
            return list(reversed(entry[0])) if entry is not None else []

    def export(self, trace_id: Optional[str] = None) -> List[Dict]:
        """JSON-ready dump of retained root span trees, most recent first —
        the payload of the operator's /debug/traces endpoint. ``trace_id``
        narrows to ALL roots of one distributed trace (the cross-process
        join: client reconcile + every apiserver + cloud server span sharing
        the propagated id), via the per-trace index."""
        if trace_id is not None:
            return [
                {"recorded_at": round(at, 3), **s.to_dict()}
                for s, at in self.trace_roots(trace_id)
            ]
        return [
            {"recorded_at": round(at, 3), **s.to_dict()}
            for _, s, at in self.traces()
        ]


#: process-wide default tracer (controllers/solver import this)
TRACER = Tracer()


def span(name: str, **attrs):
    return TRACER.span(name, **attrs)


def current_span() -> Optional[Span]:
    stack = getattr(_state, "stack", None)
    return stack[-1] if stack else None


def current_trace_id() -> str:
    """Trace id of the active span tree ('' outside any span) — the
    cross-link key decision-audit records carry."""
    s = current_span()
    return s.trace_id if s is not None else ""


def current_traceparent() -> Optional[str]:
    """The ``traceparent`` header value the HTTP clients inject, binding the
    outgoing request to the active span. None outside any span."""
    s = current_span()
    if s is None or not s.trace_id:
        return None
    return format_traceparent(s.trace_id, s.span_id)


def add_event(name: str, **attrs) -> None:
    """Stamp an event on the active span; no-op outside any span. The
    resilience layer calls this for retries and breaker transitions."""
    s = current_span()
    if s is not None:
        s.add_event(name, **attrs)
