"""The RPC half of the port's resilience layer against the JAX package's.

The cases of ``tests/test_resilience.py``'s classification table, retry
policy, circuit breaker and ``resilient_call`` (``:40-237``) run in both
packages on the same scripted faults under an injected ``FakeClock``. Each
case records what it observes: the breaker's state after every call, the
error each call raised (by class name), the calls that reached the wire,
the breaker's transitions as ``karpenter_tpu_rpc_breaker_transitions_total``
counts them, its state gauge, and how far ``breaker_open_count`` (the flight
recorder's ``breaker-open`` trigger) moved. The two packages' records must
be equal.
"""

from __future__ import annotations

import importlib
import urllib.error
from types import SimpleNamespace

import pytest

PACKAGES = ("karpenter_tpu", "karpenter_tpu_torch")
REF, PORT = PACKAGES


def pkg_mod(pkg: str) -> SimpleNamespace:
    imp = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
    return SimpleNamespace(
        pkg=pkg, res=imp("utils.resilience"), cache=imp("utils.cache"),
        iface=imp("cloudprovider.interface"), faults=imp("utils.faults"),
        metrics=imp("utils.metrics"), settings=imp("api.settings"),
    )


class Recorder:
    """What one case saw, in one package."""

    def __init__(self, m, case):
        self.m, self.case, self.rows = m, case, []
        self.open0 = m.res.breaker_open_count()

    def call(self, fn, *args, **kw):
        """Run ``fn``; record its answer or the class of what it raised."""
        try:
            out = fn(*args, **kw)
        except Exception as e:  # noqa: BLE001 - the class is the observation
            self.rows.append(("raised", type(e).__name__))
            return None
        self.rows.append(("returned", out))
        return out

    def note(self, *row):
        self.rows.append(row)

    def breaker(self, b):
        """The breaker's state and what its metrics say of it."""
        labels = {"service": b.service, "endpoint": b.endpoint}
        self.rows.append(("state", b.state, self.m.metrics.RPC_BREAKER_STATE.value(labels)))

    def done(self, *breakers):
        for b in breakers:
            for to in ("open", "half-open", "closed"):
                self.rows.append(("transitions", b.endpoint, to, self.m.metrics.RPC_BREAKER_TRANSITIONS
                                  .value({"service": b.service, "endpoint": b.endpoint, "to": to})))
        self.rows.append(("opened", self.m.res.breaker_open_count() - self.open0))
        return self.rows


def no_sleep_policy(m, **kw):
    kw.setdefault("max_attempts", 4)
    return m.res.RetryPolicy(sleep=lambda s: None, **kw)


def breaker(m, case, **kw):
    clock = m.cache.FakeClock()
    return clock, m.res.CircuitBreaker("twin", f"/{case}", clock=clock.now, **kw)


def failing(m):
    def fn():
        raise m.iface.TransientCloudError("down")
    return fn


# -- the cases (tests/test_resilience.py:40-237) ------------------------------


def case_classification_table(m, rec):
    http = urllib.error.HTTPError
    errors = [
        http("u", 429, "throttle", None, None), http("u", 500, "ise", None, None),
        http("u", 503, "unavailable", None, None), urllib.error.URLError("refused"),
        ConnectionResetError("reset"), TimeoutError("slow"),
        m.iface.TransientCloudError("injected"), http("u", 404, "nope", None, None),
        http("u", 422, "admission", None, None), m.iface.CloudProviderError("unclassified"),
        m.iface.InsufficientCapacityError("ice"), m.res.CircuitOpenError("open"),
        ValueError("bug"),
    ]
    rec.note("retryable", [m.res.is_retryable(e) for e in errors])


def case_retry_then_succeed(m, rec):
    plan = m.faults.FaultPlan().fail("ep", 2)
    calls = []

    def fn():
        calls.append(1)
        fault = plan.next("ep")
        if fault is not None:
            raise m.iface.TransientCloudError(f"injected {fault.status}")
        return "ok"

    rec.call(no_sleep_policy(m).call, fn)
    rec.note("calls", len(calls), [f.status for _, f in plan.log])


def case_terminal_error_no_retry(m, rec):
    calls = []

    def fn():
        calls.append(1)
        raise m.iface.InsufficientCapacityError("ice")

    rec.call(no_sleep_policy(m).call, fn)
    rec.note("calls", len(calls))


def case_attempts_exhausted(m, rec):
    calls = []

    def fn():
        calls.append(1)
        raise m.iface.TransientCloudError("always")

    rec.call(no_sleep_policy(m, max_attempts=3).call, fn)
    rec.note("calls", len(calls))


def case_total_deadline_abort(m, rec):
    clock = m.cache.FakeClock(start=0.0)
    policy = m.res.RetryPolicy(
        max_attempts=10, base_backoff_s=1.0, max_backoff_s=1.0, total_deadline_s=2.5,
        sleep=clock.step, clock=clock.now, rng=lambda: 1.0,
    )
    calls = []

    def fn():
        calls.append(1)
        clock.step(0.1)
        raise m.iface.TransientCloudError("always")

    rec.call(policy.call, fn)
    rec.note("calls", len(calls), clock.now())


def case_backoff_is_jittered_exponential(m, rec):
    policy = m.res.RetryPolicy(base_backoff_s=0.1, max_backoff_s=0.4, rng=lambda: 1.0)
    rec.note("backoff", [policy.backoff(i) for i in range(4)],
             m.res.RetryPolicy(base_backoff_s=0.1, rng=lambda: 0.0).backoff(3))


def case_opens_after_threshold_and_fails_fast(m, rec):
    _, b = breaker(m, "opens", failure_threshold=3, recovery_timeout_s=10)
    for _ in range(3):
        rec.call(b.call, failing(m))
        rec.breaker(b)
    calls = []
    rec.call(b.call, lambda: calls.append(1))
    rec.note("wire", calls)
    rec.breaker(b)
    rec.done(b)


def case_half_open_probe_recovers(m, rec):
    clock, b = breaker(m, "recovers", failure_threshold=2, recovery_timeout_s=10)
    for _ in range(2):
        rec.call(b.call, failing(m))
    clock.step(11)
    rec.breaker(b)
    rec.call(b.call, lambda: "probe-ok")
    rec.breaker(b)
    rec.done(b)


def case_half_open_probe_failure_reopens(m, rec):
    clock, b = breaker(m, "reopens", failure_threshold=2, recovery_timeout_s=10)
    for _ in range(2):
        rec.call(b.call, failing(m))
    clock.step(11)
    rec.call(b.call, failing(m))
    rec.breaker(b)
    clock.step(11)
    rec.breaker(b)
    rec.done(b)


def case_half_open_probe_budget(m, rec):
    clock, b = breaker(m, "budget", failure_threshold=1, recovery_timeout_s=5, half_open_probes=1)
    rec.call(b.call, failing(m))
    clock.step(6)
    rec.call(b._admit)  # probe 1 holds the budget
    rec.call(b._admit)  # probe 2 over budget
    b.record_success()
    rec.breaker(b)
    rec.done(b)


def case_breaker_ends_retry_loop(m, rec):
    _, b = breaker(m, "retry-loop", failure_threshold=2, recovery_timeout_s=60)
    calls = []

    def fn():
        calls.append(1)
        raise m.iface.TransientCloudError("down")

    rec.call(m.res.resilient_call, fn, policy=no_sleep_policy(m, max_attempts=10), breaker=b,
             service="twin", endpoint="/retry-loop")
    rec.note("calls", len(calls))
    rec.breaker(b)
    rec.done(b)


def case_terminal_errors_do_not_trip_the_breaker(m, rec):
    _, b = breaker(m, "terminal", failure_threshold=2, recovery_timeout_s=10)

    def rejected():
        raise urllib.error.HTTPError("u", 422, "admission", None, None)

    for _ in range(5):
        rec.call(b.call, rejected)
    rec.breaker(b)
    rec.call(b.call, failing(m))
    rec.call(b.call, rejected)
    rec.call(b.call, failing(m))
    rec.breaker(b)
    rec.done(b)


def case_terminal_answer_settles_a_half_open_probe(m, rec):
    """A 4xx during half-open proves the server reachable: the probe
    settles as a recovery (``CircuitBreaker.call``)."""
    clock, b = breaker(m, "settles", failure_threshold=1, recovery_timeout_s=5)
    rec.call(b.call, failing(m))
    clock.step(6)

    def rejected():
        raise urllib.error.HTTPError("u", 404, "nope", None, None)

    rec.call(b.call, rejected)
    rec.breaker(b)
    rec.done(b)


def case_breaker_set_isolates_endpoints(m, rec):
    clock = m.cache.FakeClock()
    bs = m.res.BreakerSet("svc", failure_threshold=1, clock=clock.now)
    rec.call(bs.get("/a").call, failing(m))
    rec.breaker(bs.get("/a"))
    rec.breaker(bs.get("/b"))
    rec.call(bs.get("/b").call, lambda: "ok")
    rec.note("same", bs.get("/a") is bs.get("/a"))
    rec.done(bs.get("/a"), bs.get("/b"))


def case_breaker_set_from_settings(m, rec):
    s = m.settings.Settings(rpc_breaker_failure_threshold=7, rpc_retry_max_attempts=6)
    bs = m.res.breaker_set_from_settings("cloud", s)
    b = bs.get("/v1/images")
    rec.note("set", bs.service, b.service, b.endpoint, b.failure_threshold, b.half_open_probes,
             b.recovery_timeout_s, m.res.retry_policy_from_settings(s).max_attempts)


def case_resilient_call_without_a_breaker(m, rec):
    plan = m.faults.FaultPlan().fail("ep", 2)

    def fn():
        if plan.next("ep") is not None:
            raise m.iface.TransientCloudError("injected")
        return "ok"

    rec.call(m.res.resilient_call, fn, policy=no_sleep_policy(m), service="twin",
             endpoint="/no-breaker")
    rec.note("retries", m.metrics.RPC_RETRIES.value({"service": "twin", "endpoint": "/no-breaker"}))


CASES = [
    case_classification_table,
    case_retry_then_succeed,
    case_terminal_error_no_retry,
    case_attempts_exhausted,
    case_total_deadline_abort,
    case_backoff_is_jittered_exponential,
    case_opens_after_threshold_and_fails_fast,
    case_half_open_probe_recovers,
    case_half_open_probe_failure_reopens,
    case_half_open_probe_budget,
    case_breaker_ends_retry_loop,
    case_terminal_errors_do_not_trip_the_breaker,
    case_terminal_answer_settles_a_half_open_probe,
    case_breaker_set_isolates_endpoints,
    case_breaker_set_from_settings,
    case_resilient_call_without_a_breaker,
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[len("case_"):])
def test_resilience_matches_reference(case):
    rows = {}
    for pkg in PACKAGES:
        m = pkg_mod(pkg)
        rec = Recorder(m, case.__name__)
        case(m, rec)
        rows[pkg] = rec.rows
    assert rows[PORT] == rows[REF]
    assert rows[PORT]


def test_breaker_opens_bump_the_recorders_count_once_each():
    """``breaker_open_count`` moves once per transition to open, wherever
    the breaker opens: the threshold, a failed half-open probe."""
    m = pkg_mod(PORT)
    clock, b = breaker(m, "count", failure_threshold=2, recovery_timeout_s=5)
    n0 = m.res.breaker_open_count()
    for _ in range(3):  # the third call fails fast: no second opening
        with pytest.raises((m.iface.TransientCloudError, m.res.CircuitOpenError)):
            b.call(failing(m))
    assert m.res.breaker_open_count() == n0 + 1
    clock.step(6)
    with pytest.raises(m.iface.TransientCloudError):
        b.call(failing(m))
    assert m.res.breaker_open_count() == n0 + 2 and b.state == "open"
