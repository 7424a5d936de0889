"""Host-side worker pool for embarrassingly-parallel controller work
(a copy of ``karpenter_tpu/parallel/hostpool.py``).

Work that is many independent solves rather than one tensor program: the
sharded provisioning round's per-cell solves (``map_all``) and the
consolidation sweep's per-candidate what-if simulations (``first_hit``).
A thread pool avoids process-spawn and pickling costs
and parallelizes whatever portions of a solve drop the GIL (large numpy
kernels, BLAS-threaded LP builds); encode portions serialize on
``solver.encode.ENCODE_LOCK`` and stay correct. CAVEAT, measured: this
environment's scipy HiGHS holds the GIL for the whole solve, so on small
simulations thread fan-out only pays off when the host has spare cores for
the overlapping pure-numpy stages — ``default_workers`` therefore refuses
to auto-parallelize cramped hosts, and the bench reports the machine's raw
process-scaling headroom next to the sweep numbers.

``first_hit`` preserves SERIAL SEMANTICS exactly: the returned hit is the
lowest-index item whose function result is not None — the same item a
serial first-match scan would have chosen — and evaluation stops within one
chunk of the hit, so a hit near the front doesn't pay for the whole list.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Hashable, List, Optional, Sequence, Tuple, TypeVar

T = TypeVar("T")
R = TypeVar("R")


class SerialBackground:
    """One daemon worker draining a bounded, key-deduplicated task queue —
    the off-thread lane for work that must never run concurrently with
    itself and must never block the reconcile thread.

    ``submit(key, fn)`` enqueues ``fn`` unless an identical ``key`` is
    already queued or running; a full queue drops the task (background tasks are
    hints, not obligations). The worker thread starts lazily on the first
    submit and is joined at interpreter exit, so a task is never killed
    half done at process teardown."""

    def __init__(self, name: str = "background", maxsize: int = 32):
        self.name = name
        self._queue: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._lock = threading.Lock()
        self._pending: set = set()
        self._thread: Optional[threading.Thread] = None
        self._idle = threading.Event()
        self._idle.set()

    def submit(self, key: Hashable, fn: Callable[[], object]) -> bool:
        """Queue ``fn`` under ``key``; False when deduped or the queue is
        full. Exceptions inside ``fn`` are swallowed (background hints must
        never take the process down)."""
        with self._lock:
            if key in self._pending:
                return False
            try:
                self._queue.put_nowait((key, fn))
            except queue.Full:
                return False
            self._pending.add(key)
            self._idle.clear()
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name=self.name, daemon=True
                )
                _register_background_thread(self._thread)
                self._thread.start()
        return True

    def _run(self) -> None:
        while True:
            try:
                key, fn = self._queue.get(timeout=5.0)
            except queue.Empty:
                with self._lock:
                    if self._queue.empty():
                        # exit while holding the lock, clearing the thread
                        # slot so a racing submit provably restarts a worker
                        self._thread = None
                        self._idle.set()
                        return
                continue
            try:
                fn()
            except Exception:
                pass
            finally:
                with self._lock:
                    self._pending.discard(key)
                    if self._queue.empty() and not self._pending:
                        self._idle.set()

    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the queue to drain; True when idle."""
        return self._idle.wait(timeout)


_background_threads: List[threading.Thread] = []


def _register_background_thread(thread: threading.Thread) -> None:
    if not _background_threads:
        import atexit

        atexit.register(_join_background_threads)
    _background_threads.append(thread)
    if len(_background_threads) > 16:
        _background_threads[:] = [t for t in _background_threads if t.is_alive()]


def _join_background_threads() -> None:
    for t in _background_threads:
        if t.is_alive():
            t.join(timeout=120)


def default_workers(setting: int = 0, cap: int = 8) -> int:
    """Resolve a worker-count setting: 0 sizes from the host, anything else
    is taken literally; 1 means serial. Auto mode only goes parallel with
    >= 4 cores: thread fan-out of CPU-bound solves needs real core headroom
    to beat GIL handoff costs, and on 1-2 core hosts it measurably LOSES —
    operators who know their solve stack releases the GIL can force a count
    explicitly."""
    if setting > 0:
        return setting
    cpus = os.cpu_count() or 1
    if cpus < 4:
        return 1
    return max(1, min(cap, cpus))


def map_all(
    fn: Callable[[int, T], R],
    items: Sequence[T],
    workers: int,
) -> List[R]:
    """Evaluate ``fn(i, item)`` for EVERY item and return results in index
    order — the fan-out primitive for the cell-sharded control plane's
    per-cell solves (each item is one cell; the index selects a per-cell
    resource such as a solver clone). Unlike ``first_hit`` there is no
    early exit: every cell's solve must complete before the round merges.

    ``workers <= 1`` is a plain serial loop (no pool, no threads) with
    identical results — the serial-equality discipline of the sweep:
    parallelism may only change wall-clock, never the answer."""
    if workers <= 1 or len(items) <= 1:
        return [fn(i, item) for i, item in enumerate(items)]
    with ThreadPoolExecutor(max_workers=min(workers, len(items))) as pool:
        return list(
            pool.map(lambda t: fn(t[0], t[1]), list(enumerate(items)))
        )


def first_hit(
    fn: Callable[[int, T], Optional[R]],
    items: Sequence[T],
    workers: int,
) -> Tuple[Optional[int], Optional[R]]:
    """Lowest-index ``(i, fn(i, item))`` with a non-None result, or
    ``(None, None)``. ``fn`` receives (index, item) — the index selects a
    per-worker resource (e.g. a solver clone) via ``index % workers``.

    With ``workers <= 1`` this is a plain serial scan (no pool, no threads).
    Otherwise items evaluate in index-ordered chunks of ``workers`` with a
    barrier between chunks: results inside a chunk are examined in index
    order, so the chosen hit is identical to the serial scan's; at most one
    chunk of evaluations runs past the winning index.
    """
    if workers <= 1 or len(items) <= 1:
        for i, item in enumerate(items):
            out = fn(i, item)
            if out is not None:
                return i, out
        return None, None
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for base in range(0, len(items), workers):
            chunk = items[base : base + workers]
            results: List[Optional[R]] = list(
                pool.map(lambda t: fn(t[0], t[1]),
                         [(base + k, item) for k, item in enumerate(chunk)])
            )
            for k, out in enumerate(results):
                if out is not None:
                    return base + k, out
    return None, None
