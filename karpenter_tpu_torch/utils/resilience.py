"""RPC resilience: the retry policy, its error table, and circuit breakers
(``karpenter_tpu/utils/resilience.py``, without the breakers' call gate).

* :func:`is_retryable` — the error-classification table. Throttles (429),
  server errors (5xx), connection failures and timeouts are retryable;
  client errors (other 4xx), admission rejections and insufficient-capacity
  errors are terminal (ICE is handled by the offerings cache, not by
  hammering the same pool).
* :class:`RetryPolicy` — exponential backoff with FULL jitter
  (``delay = rand() * min(cap, base * 2**attempt)``), a per-attempt timeout
  hint for transports and a total deadline that aborts a retry loop which
  would otherwise overshoot the caller's budget. ``sleep``/``clock``/``rng``
  are injectable so tests run scripted schedules without real sleeps. The
  provisioning controller retries transient launch failures through it.
* :class:`CircuitBreaker` is closed → open → half-open:
  ``failure_threshold`` consecutive failures open the circuit; once
  ``recovery_timeout_s`` has elapsed it reads half-open, and then one
  success closes it and one failure reopens it. :class:`BreakerSet` keeps
  one breaker per endpoint, created lazily with shared thresholds. The
  solver's kernel breaker board rides these: it reads ``state`` to gate a
  dispatch and books each outcome. Both are thread-safe, one lock each, as
  the reference's are: the sharded round's per-cell solver clones book
  evidence from several host threads at once. Every transition to open
  bumps a process-wide count (:func:`breaker_open_count`), which the flight
  recorder reads around a reconcile for its ``breaker-open`` trigger.
"""

from __future__ import annotations

import http.client
import random
import threading
import time
import urllib.error
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from . import metrics, tracing

# -- error classification ----------------------------------------------------

#: HTTP statuses worth retrying: throttle + server-side failures.
RETRYABLE_HTTP_STATUSES = frozenset({429, 500, 502, 503, 504})


def is_retryable(exc: BaseException) -> bool:
    """The error-classification table (docs/ARCHITECTURE.md "Resilience").

    An explicit ``retryable`` attribute on the exception wins — that is how
    ``TransientCloudError`` (retryable) and ``CircuitOpenError`` /
    ``AdmissionError`` (terminal) short-circuit the structural checks.
    """
    flagged = getattr(exc, "retryable", None)
    if flagged is not None:
        return bool(flagged)
    if isinstance(exc, urllib.error.HTTPError):
        return exc.code in RETRYABLE_HTTP_STATUSES or exc.code >= 500
    if isinstance(exc, (urllib.error.URLError, ConnectionError, TimeoutError)):
        return True  # unreachable / reset / timed out: the request may never
        # have been processed; socket.timeout is an alias of TimeoutError
    if isinstance(exc, http.client.HTTPException):
        return True  # BadStatusLine/RemoteDisconnected: server died mid-reply
    return False


class CircuitOpenError(Exception):
    """Fail-fast signal: the breaker is open, the call was never attempted.

    Terminal for retry loops (``retryable = False``) — retrying against an
    open circuit is exactly the hammering the breaker exists to stop."""

    retryable = False


# -- retry policy ------------------------------------------------------------


@dataclass
class RetryPolicy:
    """Exponential backoff + full jitter with per-attempt and total deadlines.

    ``attempt_timeout_s`` is a hint transports apply to each individual
    attempt (the urlopen timeout); ``total_deadline_s`` bounds the whole
    retry loop including backoff sleeps. ``sleep``/``clock``/``rng`` are
    injectable for deterministic tests.
    """

    max_attempts: int = 4
    base_backoff_s: float = 0.05
    max_backoff_s: float = 2.0
    total_deadline_s: float = 30.0
    attempt_timeout_s: Optional[float] = None
    sleep: Callable[[float], None] = time.sleep
    clock: Callable[[], float] = time.monotonic
    rng: Callable[[], float] = random.random

    def backoff(self, attempt: int) -> float:
        """Full-jitter delay for the given 0-based completed-attempt count."""
        cap = min(self.max_backoff_s, self.base_backoff_s * (2 ** attempt))
        return self.rng() * cap

    def call(
        self,
        fn: Callable[[], object],
        *,
        classify: Callable[[BaseException], bool] = is_retryable,
        service: str = "",
        endpoint: str = "",
        on_retry: Optional[Callable[[BaseException, int], None]] = None,
    ):
        """Run ``fn`` retrying retryable failures. Raises the last error when
        attempts or the total deadline run out; terminal errors raise at
        once. Each retry is counted in ``karpenter_tpu_rpc_retries_total``."""
        labels = {"service": service, "endpoint": endpoint}
        start = self.clock()
        attempt = 0
        while True:
            try:
                result = fn()
            except BaseException as e:  # noqa: BLE001 - classified below
                if not classify(e):
                    metrics.RPC_REQUESTS.inc({**labels, "outcome": "terminal"})
                    raise
                attempt += 1
                if attempt >= self.max_attempts:
                    metrics.RPC_REQUESTS.inc({**labels, "outcome": "exhausted"})
                    raise
                delay = self.backoff(attempt - 1)
                remaining = self.total_deadline_s - (self.clock() - start)
                if remaining <= delay:
                    # total-deadline abort: sleeping would overshoot the
                    # caller's budget, so surface the failure now
                    metrics.RPC_REQUESTS.inc({**labels, "outcome": "deadline"})
                    raise
                metrics.RPC_RETRIES.inc(labels)
                # stamp the retry on the active trace span (no-op outside a
                # span): a slow round's trace shows WHICH call retried and why
                tracing.add_event(
                    "rpc.retry", service=service, endpoint=endpoint,
                    attempt=attempt, error=f"{type(e).__name__}: {e}",
                )
                if on_retry is not None:
                    on_retry(e, attempt)
                if delay > 0:
                    self.sleep(delay)
                continue
            metrics.RPC_REQUESTS.inc({**labels, "outcome": "ok"})
            return result


# -- circuit breaker ---------------------------------------------------------

#: process-wide count of closed/half-open -> open transitions, across every
#: breaker instance. The flight recorder snapshots it around a reconcile: a
#: delta means a circuit opened mid-round — one of its anomaly dump triggers.
_open_events = 0
_open_events_lock = threading.Lock()


def breaker_open_count() -> int:
    return _open_events


def _count_open() -> None:
    global _open_events
    with _open_events_lock:
        _open_events += 1


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
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0
        self._opened_at = 0.0

    @property
    def state(self) -> str:
        with self._lock:
            if self._state == "open" and self._clock() - self._opened_at >= self.recovery_timeout_s:
                self._state = "half-open"
            return self._state

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._state = "closed"

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._state == "half-open":
                self._opened_at = self._clock()
                self._state = "open"  # a failed probe reopens
                _count_open()
            elif self._state == "closed" and self._failures >= self.failure_threshold:
                self._opened_at = self._clock()
                self._state = "open"
                _count_open()


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
        self._lock = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}

    def get(self, endpoint: str) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get(endpoint)
            if b is None:
                b = self._breakers[endpoint] = CircuitBreaker(
                    failure_threshold=self.failure_threshold,
                    recovery_timeout_s=self.recovery_timeout_s,
                    clock=self._clock,
                )
            return b

    def breakers(self) -> Dict[str, CircuitBreaker]:
        """Snapshot of the lazily-created per-endpoint breakers — the
        kernel-backend health score aggregates their states."""
        with self._lock:
            return dict(self._breakers)


def retry_policy_from_settings(settings) -> RetryPolicy:
    """Build the shared policy from operator settings (api/settings.py)."""
    return RetryPolicy(max_attempts=int(getattr(settings, "rpc_retry_max_attempts", 4)))
