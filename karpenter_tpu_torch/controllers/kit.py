"""Controller kit: singleton reconcilers with cadence + error backoff.

Rebuild of karpenter-core's controller kit surface
(``corecontroller.{Controller, NewSingletonManagedBy}`` — poll-style
singleton controllers with a requeue interval, plus controller-runtime's
exponential error backoff). Every loop the operator drives is wrapped in a
``SingletonController``: a crash in one controller backs that controller off
(1s doubling to 5m) and is logged/counted instead of killing the whole run
loop, and per-loop cadences (drift/GC/nodetemplate at 5m, termination every
tick) live in ONE place instead of ad-hoc timestamp math.

Every reconcile also gets a CORRELATION ID: the kit opens a structured-log
context (every log line inside the reconcile carries ``reconcile_id``) and a
root trace span ``reconcile.<name>`` stamped with the same id, so a slow
reconcile found in the logs joins to its span tree on ``/debug/traces`` and
to its ``karpenter_tpu_controller_reconcile_duration_seconds`` sample.
"""

from __future__ import annotations

import itertools
import logging
import time
from typing import Callable, Optional

from ..utils import metrics
from ..utils.logging import get_logger, kv, log_context
from ..utils.tracing import TRACER

BASE_BACKOFF = 1.0
MAX_BACKOFF = 300.0

_reconcile_seq = itertools.count(1)


class SingletonController:
    """Wraps a reconcile callable with cadence and failure backoff."""

    def __init__(
        self,
        name: str,
        reconcile: Callable[[], object],
        interval: float = 0.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.name = name
        self._reconcile = reconcile
        self.interval = interval
        self._clock = clock
        self._next = 0.0
        self._backoff = BASE_BACKOFF
        self.consecutive_errors = 0
        self._log = get_logger(f"controller.{name}")

    def due(self, now: Optional[float] = None) -> bool:
        return (self._clock() if now is None else now) >= self._next

    def run_if_due(self, now: Optional[float] = None) -> bool:
        """Run when due; on success schedule the next interval, on failure
        back off exponentially (reference: workqueue rate-limiter semantics).
        Returns True when the reconcile ran (successfully or not)."""
        now = self._clock() if now is None else now
        if now < self._next:
            return False
        if self.interval > 0 and self._next > 0:
            # scheduled-vs-actual start delta: how late the loop got to a due
            # controller. Interval-0 controllers are skipped — they are due
            # every tick by design, so their delta would just re-report the
            # run loop's sleep as a permanent false "lag" floor.
            metrics.RECONCILE_LOOP_LAG.set(
                max(0.0, now - self._next), {"controller": self.name}
            )
        reconcile_id = f"{self.name}.{next(_reconcile_seq)}"
        try:
            with log_context(reconcile_id=reconcile_id), \
                 TRACER.span(f"reconcile.{self.name}", reconcile_id=reconcile_id), \
                 metrics.RECONCILE_DURATION.time({"controller": self.name}):
                self._reconcile()
        except Exception as e:
            self.consecutive_errors += 1
            metrics.RECONCILE_ERRORS.inc({"controller": self.name})
            kv(self._log, logging.ERROR, "reconcile failed",
               controller=self.name, reconcile_id=reconcile_id,
               consecutive=self.consecutive_errors,
               error=f"{type(e).__name__}: {e}")
            self._log.debug("reconcile traceback", exc_info=True)
            self._next = now + self._backoff
            self._backoff = min(self._backoff * 2, MAX_BACKOFF)
            return True
        self.consecutive_errors = 0
        self._backoff = BASE_BACKOFF
        self._next = now + self.interval
        return True
