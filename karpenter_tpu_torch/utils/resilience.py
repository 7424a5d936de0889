"""RPC resilience: the retry policy, its error table, circuit breakers and
their composition (a copy of ``karpenter_tpu/utils/resilience.py``).

The upstream provider survives a flaky EC2 control plane by retrying
throttled/5xx calls with backoff (the AWS SDK's adaptive retryer under
``pkg/providers/...``) and by remembering capacity failures per offering
(``pkg/cache/unavailableofferings.go``). Every RPC edge of the port
(``cloudprovider/httpcloud.py``, ``state/httpcluster.py``) gets the same
three pieces:

* :func:`is_retryable` — the error-classification table. Throttles (429),
  server errors (5xx), connection failures and timeouts are retryable;
  client errors (other 4xx), admission rejections and insufficient-capacity
  errors are terminal (ICE is handled by the offerings cache, not by
  hammering the same pool).
* :class:`RetryPolicy` — exponential backoff with FULL jitter
  (``delay = rand() * min(cap, base * 2**attempt)``), a per-attempt timeout
  hint for transports and a total deadline that aborts a retry loop which
  would otherwise overshoot the caller's budget. ``sleep``/``clock``/``rng``
  are injectable so the fault-injection tests run scripted schedules
  without real sleeps.
* :class:`CircuitBreaker` — closed→open→half-open with a probe budget:
  ``failure_threshold`` consecutive failures open the circuit, calls then
  fail fast (``CircuitOpenError``, classified terminal so retry loops stop
  immediately) until ``recovery_timeout_s`` elapses; half-open admits at
  most ``half_open_probes`` concurrent probes — one success closes the
  circuit, one failure reopens it. :class:`BreakerSet` keeps one breaker
  per endpoint; the solver's kernel breaker board rides one too. Every
  transition to open bumps a process-wide count
  (:func:`breaker_open_count`), which the flight recorder reads around a
  reconcile for its ``breaker-open`` trigger.

State is exported through the ``karpenter_tpu_rpc_*`` metrics (requests by
outcome, retries, breaker state/transitions) labeled by service + endpoint.
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

#: gauge encoding of breaker state (karpenter_tpu_rpc_breaker_state)
_STATE_VALUE = {"closed": 0.0, "open": 1.0, "half-open": 2.0}

#: process-wide count of closed/half-open -> open transitions, across every
#: breaker instance. The flight recorder snapshots it around a reconcile: a
#: delta means a circuit opened mid-round — one of its anomaly dump triggers.
_open_events = 0
_open_events_lock = threading.Lock()


def breaker_open_count() -> int:
    return _open_events


class CircuitBreaker:
    """closed → open → half-open breaker with a half-open probe budget.

    * closed: calls pass; ``failure_threshold`` CONSECUTIVE failures open it.
    * open: calls raise :class:`CircuitOpenError` without touching the wire
      until ``recovery_timeout_s`` elapses, then the breaker goes half-open.
    * half-open: at most ``half_open_probes`` in-flight probes are admitted;
      a probe success closes the breaker, a probe failure reopens it.
    """

    def __init__(
        self,
        service: str = "",
        endpoint: str = "",
        failure_threshold: int = 5,
        recovery_timeout_s: float = 10.0,
        half_open_probes: int = 1,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.service = service
        self.endpoint = endpoint
        self.failure_threshold = failure_threshold
        self.recovery_timeout_s = recovery_timeout_s
        self.half_open_probes = half_open_probes
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0
        self._opened_at = 0.0
        self._probes_inflight = 0
        self._publish_locked()

    # -- state accounting (all under the lock) ------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open_locked()
            return self._state

    def _labels(self) -> Dict[str, str]:
        return {"service": self.service, "endpoint": self.endpoint}

    def _publish_locked(self) -> None:
        metrics.RPC_BREAKER_STATE.set(_STATE_VALUE[self._state], self._labels())

    def _transition_locked(self, to: str) -> None:
        if to == self._state:
            return
        self._state = to
        if to == "open":
            global _open_events
            with _open_events_lock:
                _open_events += 1
        metrics.RPC_BREAKER_TRANSITIONS.inc({**self._labels(), "to": to})
        # breaker trips ride the active trace span too (no-op outside one):
        # an attributable "circuit opened mid-reconcile" beats a bare metric
        tracing.add_event(
            "breaker.transition", service=self.service, endpoint=self.endpoint,
            to=to, failures=self._failures,
        )
        self._publish_locked()

    def _maybe_half_open_locked(self) -> None:
        if (
            self._state == "open"
            and self._clock() - self._opened_at >= self.recovery_timeout_s
        ):
            self._transition_locked("half-open")
            self._probes_inflight = 0

    def _admit(self) -> None:
        """Gate one call; raises CircuitOpenError when the circuit denies it.
        In half-open state the probe budget is reserved here and settled in
        record_success/record_failure."""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == "closed":
                return
            if self._state == "half-open" and self._probes_inflight < self.half_open_probes:
                self._probes_inflight += 1
                return
            raise CircuitOpenError(
                f"circuit open for {self.service}:{self.endpoint} "
                f"({self._failures} consecutive failures)"
            )

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probes_inflight = 0
            self._transition_locked("closed")

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._state == "half-open":
                self._probes_inflight = max(0, self._probes_inflight - 1)
                self._opened_at = self._clock()
                self._transition_locked("open")  # failed probe reopens
            elif self._state == "closed" and self._failures >= self.failure_threshold:
                self._opened_at = self._clock()
                self._transition_locked("open")

    def call(
        self,
        fn: Callable[[], object],
        classify: Callable[[BaseException], bool] = is_retryable,
    ):
        """Run ``fn`` under the breaker, feeding its outcome back. Only
        failures the classifier deems retryable (server/connection class)
        count toward opening the circuit: a streak of 4xx client errors from
        a healthy server must not trip the breaker — nor does it reset the
        consecutive-failure count."""
        self._admit()
        try:
            result = fn()
        except CircuitOpenError:
            raise
        except BaseException as e:
            if classify(e):
                self.record_failure()
            elif self._state == "half-open":
                # a terminal answer still proves the server is reachable:
                # settle the probe as a recovery rather than leaking budget
                self.record_success()
            raise
        self.record_success()
        return result


class BreakerSet:
    """Per-endpoint circuit breakers for one service, created lazily and
    sharing thresholds — a 5xx storm on /v1/run-instances must not take
    /v1/describe down with it."""

    def __init__(
        self,
        service: str,
        failure_threshold: int = 5,
        recovery_timeout_s: float = 10.0,
        half_open_probes: int = 1,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.service = service
        self.failure_threshold = failure_threshold
        self.recovery_timeout_s = recovery_timeout_s
        self.half_open_probes = half_open_probes
        self._clock = clock
        self._lock = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}

    def get(self, endpoint: str) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get(endpoint)
            if b is None:
                b = self._breakers[endpoint] = CircuitBreaker(
                    service=self.service,
                    endpoint=endpoint,
                    failure_threshold=self.failure_threshold,
                    recovery_timeout_s=self.recovery_timeout_s,
                    half_open_probes=self.half_open_probes,
                    clock=self._clock,
                )
            return b

    def breakers(self) -> Dict[str, CircuitBreaker]:
        """Snapshot of the lazily-created per-endpoint breakers — the
        kernel-backend health score aggregates their states."""
        with self._lock:
            return dict(self._breakers)


def resilient_call(
    fn: Callable[[], object],
    *,
    policy: RetryPolicy,
    breaker: Optional[CircuitBreaker] = None,
    service: str = "",
    endpoint: str = "",
    classify: Callable[[BaseException], bool] = is_retryable,
):
    """Retry + breaker composition used by the HTTP transports: every attempt
    feeds the breaker, and an opening breaker ends the retry loop at once
    (CircuitOpenError is terminal)."""
    attempt = fn if breaker is None else (lambda: breaker.call(fn, classify=classify))
    return policy.call(attempt, classify=classify, service=service, endpoint=endpoint)


def retry_policy_from_settings(settings) -> RetryPolicy:
    """Build the shared policy from operator settings (api/settings.py)."""
    return RetryPolicy(max_attempts=int(getattr(settings, "rpc_retry_max_attempts", 4)))


def breaker_set_from_settings(service: str, settings) -> BreakerSet:
    return BreakerSet(
        service,
        failure_threshold=int(getattr(settings, "rpc_breaker_failure_threshold", 5)),
    )
