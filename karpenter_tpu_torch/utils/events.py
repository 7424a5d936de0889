"""Kubernetes-style event recording.

Reference: core's events.Recorder used by every controller (e.g.
upstream ``pkg/controllers/interruption/events/events.go``) to surface
user-visible decisions as k8s Events.

Retention is a RING BUFFER (``capacity`` most recent events): an operator
lives for months and publishes an event per scheduling decision, so an
unbounded list is a slow memory leak. The full history still leaves a
trail two ways — every publish feeds ``karpenter_tpu_events_total{type,
reason}`` through a default sink (the counter survives ring eviction), and
the recent window serves the operator's ``/debug/events`` endpoint.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, List, Optional

from . import metrics


@dataclass(frozen=True)
class Event:
    reason: str
    message: str
    object_name: str = ""
    object_kind: str = ""
    type: str = "Normal"  # Normal | Warning
    timestamp: float = field(default_factory=time.time)

    def to_dict(self) -> dict:
        return {
            "type": self.type,
            "reason": self.reason,
            "message": self.message,
            "objectName": self.object_name,
            "objectKind": self.object_kind,
            "timestamp": round(self.timestamp, 3),
        }


def _count_event(event: Event) -> None:
    metrics.EVENTS_TOTAL.inc({"type": event.type, "reason": event.reason})


class Recorder:
    #: default ring size: large enough that tests and debug snapshots see a
    #: meaningful window, small enough to bound a long-lived operator
    DEFAULT_CAPACITY = 1024

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        self._events: Deque[Event] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._sinks: List[Callable[[Event], None]] = [_count_event]

    @property
    def capacity(self) -> int:
        return self._events.maxlen or 0

    def publish(
        self,
        reason: str,
        message: str,
        object_name: str = "",
        object_kind: str = "",
        type: str = "Normal",
    ) -> None:
        event = Event(reason=reason, message=message, object_name=object_name,
                      object_kind=object_kind, type=type)
        with self._lock:
            self._events.append(event)
            sinks = list(self._sinks)
        for sink in sinks:
            sink(event)

    def subscribe(self, sink: Callable[[Event], None]) -> None:
        with self._lock:
            self._sinks.append(sink)

    def events(self, reason: Optional[str] = None) -> List[Event]:
        with self._lock:
            return [e for e in self._events if reason is None or e.reason == reason]

    def recent(self, limit: int = 256) -> List[Event]:
        """The newest ``limit`` events, newest first (/debug/events payload)."""
        with self._lock:
            out = list(self._events)
        out.reverse()
        return out[:limit]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
