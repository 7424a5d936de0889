"""Generic windowed request batcher.

Reference: upstream ``pkg/batcher/batcher.go:29-35`` — hash-bucketed requests
wait for an idle window (35ms for CreateFleet) up to a max window (1s) or max items
(1000), then one merged backend call fans results back out per caller
(``createfleet.go:33-110``).

The TPU-native build keeps the same shape because the purpose is identical: surviving
cloud API throttling by aggregating N logically-identical RPCs into one.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, Generic, Hashable, List, Optional, Sequence, TypeVar

from . import metrics

Req = TypeVar("Req")
Resp = TypeVar("Resp")


@dataclass
class BatcherOptions:
    idle_timeout: float = 0.035
    max_timeout: float = 1.0
    max_items: int = 1000


class Batcher(Generic[Req, Resp]):
    """Aggregates identical requests into one executor call.

    ``request_hasher`` buckets requests that may be merged; ``batch_executor``
    receives the full bucket and must return one response per request, in order.
    ``add`` blocks until its response is ready (callers run on their own threads,
    like the reference's goroutines).
    """

    def __init__(
        self,
        request_hasher: Callable[[Req], Hashable],
        batch_executor: Callable[[Sequence[Req]], Sequence[Resp]],
        options: BatcherOptions = BatcherOptions(),
    ):
        self._hasher = request_hasher
        self._executor = batch_executor
        self._options = options
        self._lock = threading.Lock()
        self._buckets: Dict[Hashable, "_Bucket[Req, Resp]"] = {}

    def add(self, request: Req) -> Resp:
        key = self._hasher(request)
        while True:
            with self._lock:
                bucket = self._buckets.get(key)
                if bucket is None or bucket.closed:
                    bucket = _Bucket(self._options, self._executor)
                    bucket.on_done = (lambda b=bucket, k=key: self._forget(k, b))
                    self._buckets[key] = bucket
                waiter = bucket.try_put(request)
            if waiter is not None:
                return waiter.wait()
            # The bucket closed between our lookup and put — retry with a fresh one.

    def _forget(self, key: Hashable, bucket: "_Bucket") -> None:
        with self._lock:
            if self._buckets.get(key) is bucket:
                del self._buckets[key]


class _Waiter(Generic[Resp]):
    def __init__(self) -> None:
        self._event = threading.Event()
        self._response: Optional[Resp] = None
        self._error: Optional[BaseException] = None

    def resolve(self, response: Resp) -> None:
        self._response = response
        self._event.set()

    def fail(self, error: BaseException) -> None:
        self._error = error
        self._event.set()

    def wait(self) -> Resp:
        self._event.wait()
        if self._error is not None:
            raise self._error
        return self._response  # type: ignore[return-value]


class _Bucket(Generic[Req, Resp]):
    def __init__(
        self,
        options: BatcherOptions,
        executor: Callable[[Sequence[Req]], Sequence[Resp]],
    ):
        self._options = options
        self._executor = executor
        self.on_done: Callable[[], None] = lambda: None
        self._lock = threading.Lock()
        self._requests: List[Req] = []
        self._put_times: List[float] = []
        self._waiters: List[_Waiter[Resp]] = []
        self._trigger = threading.Event()
        self.closed = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._started = False

    def try_put(self, request: Req) -> Optional[_Waiter[Resp]]:
        """Add a request; returns None if the bucket already closed (caller retries
        on a fresh bucket — closing and putting race on the bucket lock)."""
        with self._lock:
            if self.closed:
                return None
            waiter: _Waiter[Resp] = _Waiter()
            self._requests.append(request)
            self._put_times.append(_now())
            self._waiters.append(waiter)
            self._trigger.set()
            if len(self._requests) >= self._options.max_items:
                self.closed = True
            if not self._started:
                self._started = True
                self._thread.start()
            return waiter

    def _run(self) -> None:
        # Wait until the bucket has gone idle (no new request within idle_timeout),
        # hit max_timeout, or filled to max_items — then execute once.
        deadline = _now() + self._options.max_timeout
        while True:
            self._trigger.clear()
            if self.closed:
                break
            remaining = deadline - _now()
            if remaining <= 0:
                break
            got_new = self._trigger.wait(timeout=min(self._options.idle_timeout, remaining))
            if not got_new:
                break  # idle window elapsed
        with self._lock:
            self.closed = True
            requests = list(self._requests)
            put_times = list(self._put_times)
            waiters = list(self._waiters)
        self.on_done()
        # per-request window queue time, observed as the merged call starts
        # (karpenter_tpu_batch_wait_seconds{batcher="rpc"})
        start = _now()
        for t in put_times:
            metrics.BATCH_WAIT.observe(max(0.0, start - t), {"batcher": "rpc"})
        try:
            responses = self._executor(requests)
            if len(responses) != len(requests):
                raise RuntimeError(
                    f"batch executor returned {len(responses)} responses for {len(requests)} requests"
                )
            for waiter, response in zip(waiters, responses):
                waiter.resolve(response)
        except BaseException as e:  # propagate executor failure to every caller
            for waiter in waiters:
                waiter.fail(e)


def _now() -> float:
    import time

    return time.monotonic()
