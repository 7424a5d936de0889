"""Circuit breakers (``karpenter_tpu/utils/resilience.py``, the breaker part).

:class:`CircuitBreaker` is closed → open → half-open:
``failure_threshold`` consecutive failures open the circuit; once
``recovery_timeout_s`` has elapsed it reads half-open, and then one success
closes it and one failure reopens it. :class:`BreakerSet` keeps one breaker
per endpoint, created lazily with shared thresholds.

The solver's kernel breaker board rides these: it reads ``state`` to gate a
dispatch and books each outcome. Not thread-safe: nothing in the port calls
a breaker from two threads.
"""

from __future__ import annotations

import time
from typing import Callable, Dict


class CircuitBreaker:
    """closed → open → half-open breaker.

    * closed: ``failure_threshold`` CONSECUTIVE failures open it.
    * open: reads open until ``recovery_timeout_s`` elapses, then half-open.
    * half-open: a success closes the breaker, a failure reopens it.
    """

    def __init__(
        self,
        failure_threshold: int = 5,
        recovery_timeout_s: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.failure_threshold = failure_threshold
        self.recovery_timeout_s = recovery_timeout_s
        self._clock = clock
        self._state = "closed"
        self._failures = 0
        self._opened_at = 0.0

    @property
    def state(self) -> str:
        if self._state == "open" and self._clock() - self._opened_at >= self.recovery_timeout_s:
            self._state = "half-open"
        return self._state

    def record_success(self) -> None:
        self._failures = 0
        self._state = "closed"

    def record_failure(self) -> None:
        self._failures += 1
        if self._state == "half-open":
            self._opened_at = self._clock()
            self._state = "open"  # a failed probe reopens
        elif self._state == "closed" and self._failures >= self.failure_threshold:
            self._opened_at = self._clock()
            self._state = "open"


class BreakerSet:
    """Per-endpoint circuit breakers, created lazily and sharing thresholds."""

    def __init__(
        self,
        failure_threshold: int = 5,
        recovery_timeout_s: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.failure_threshold = failure_threshold
        self.recovery_timeout_s = recovery_timeout_s
        self._clock = clock
        self._breakers: Dict[str, CircuitBreaker] = {}

    def get(self, endpoint: str) -> CircuitBreaker:
        b = self._breakers.get(endpoint)
        if b is None:
            b = self._breakers[endpoint] = CircuitBreaker(
                failure_threshold=self.failure_threshold,
                recovery_timeout_s=self.recovery_timeout_s,
                clock=self._clock,
            )
        return b
