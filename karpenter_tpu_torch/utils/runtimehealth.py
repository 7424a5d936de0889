"""Runtime-health gauges: process memory and allocator hot spots.

The flight recorder (utils/flightrecorder.py) retains whole-cluster capsules
and the decision/trace rings retain history — operator memory must be
observable or "bounded" is a hope, not a property. This module feeds two
gauges through registry pre-scrape refreshers (the same hook the ICE gauge
and scraper staleness pruner use):

* ``karpenter_tpu_process_memory_bytes`` — resident set size, read from
  ``/proc/self/statm`` (falling back to ``resource.getrusage`` off Linux);
  always on, effectively free.
* ``karpenter_tpu_tracemalloc_top_bytes{site}`` — the top allocation sites
  by live bytes, exported only when ``install(memory_profiling=True)``
  turns tracemalloc on (tracemalloc costs real CPU/memory; it is a
  diagnosis tool, not a default). The reference's operator turns it on with
  ``settings.profiling_enabled``, which the port's operator refuses until
  the profiler is ported (``ROADMAP.md``, Queue 1 item 9).

``karpenter_tpu_reconcile_loop_lag_seconds`` (the third runtime-health
signal) is fed directly by the controller kit at dispatch time — lag is a
property of the loop, not of a scrape.
"""

from __future__ import annotations

import os
import time
import weakref
from typing import Optional

from . import metrics
from .metrics import REGISTRY, Registry, series_key

#: registries already carrying the refresher (install() is called per
#: Operator.new; the hook must not stack). A WeakSet, not an id() set: a
#: fresh registry can reuse a dead one's id and would be silently skipped.
_installed: "weakref.WeakSet" = weakref.WeakSet()

_PAGESIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096

#: top-N allocation sites exported (bounded label cardinality)
TOP_ALLOCATORS = 5

#: process start stamp (exported as karpenter_tpu_process_start_time_seconds;
#: module import time IS process start for the operator's purposes — restart
#: detection only needs the value to change across incarnations)
_START_TIME = time.time()

_memory_profiling = False

#: cell-aware memory scrape hook (sharded control plane only): a WEAK
#: reference to a callable returning {cell id: encoder-state bytes}. None —
#: the flat-mode default — keeps the process_memory_bytes exposition
#: byte-identical to the single-series shape dashboards already graph; when
#: set (the operator wires it only under settings.cell_sharding_enabled)
#: the gauge gains one {cell="<id>"} series per cell carrying that cell's
#: encoder footprint. Weak so a module global never pins a stopped
#: operator's controller (and its per-cell encoder matrices) in memory.
_cell_bytes_ref = None


def rss_bytes() -> float:
    """Resident set size of this process, in bytes."""
    try:
        with open("/proc/self/statm") as f:
            return float(f.read().split()[1]) * _PAGESIZE
    except (OSError, IndexError, ValueError):
        try:
            import resource
            import sys

            # ru_maxrss units differ by platform: BYTES on macOS, KiB on
            # Linux/BSD — scaling unconditionally would over-report 1024x
            # on the one platform that actually takes this branch
            scale = 1.0 if sys.platform == "darwin" else 1024.0
            return float(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * scale
        except Exception:
            return 0.0


def enable_memory_profiling() -> None:
    """Turn tracemalloc on (1 frame: the allocation site, not the stack —
    deep traces multiply the profiler's own memory cost)."""
    global _memory_profiling
    import tracemalloc

    if not tracemalloc.is_tracing():
        tracemalloc.start(1)
    _memory_profiling = True


def disable_memory_profiling() -> None:
    global _memory_profiling
    import tracemalloc

    _memory_profiling = False
    if tracemalloc.is_tracing():
        tracemalloc.stop()
    metrics.TRACEMALLOC_TOP.replace_series({})


def _refresh() -> None:
    series = {(): rss_bytes()}
    fn = _cell_bytes_ref() if _cell_bytes_ref is not None else None
    if fn is not None:
        try:
            for cid, nbytes in fn().items():
                series[series_key({"cell": str(cid)})] = float(nbytes)
        except Exception:
            pass  # a scrape must never fail on the cell hook
    # full swap (not .set): cells that vanished leave the exposition, and
    # with no hook this publishes exactly the one unlabeled series
    metrics.PROCESS_MEMORY.replace_series(series)
    # the reference also sets PROFILER_SAMPLES from the sampling profiler
    # here; the profiler is not ported (ROADMAP.md, Queue 1 item 9)
    if not _memory_profiling:
        return
    import tracemalloc

    if not tracemalloc.is_tracing():
        return
    stats = tracemalloc.take_snapshot().statistics("lineno")[:TOP_ALLOCATORS]
    series = {}
    for stat in stats:
        frame = stat.traceback[0]
        site = f"{os.path.basename(frame.filename)}:{frame.lineno}"
        series[series_key({"site": site})] = float(stat.size)
    # full swap: sites that fell out of the top-N leave the exposition
    metrics.TRACEMALLOC_TOP.replace_series(series)


def install(
    registry: Optional[Registry] = None,
    memory_profiling: bool = False,
    cell_bytes=None,
) -> None:
    """Register the pre-scrape refresher once per registry and apply the
    profiling setting (idempotent — Operator.new calls this on every build).
    ``cell_bytes`` installs the {cell}-aware memory scrape (see
    ``_cell_bytes_ref``); passing None restores the flat single-series
    exposition."""
    global _cell_bytes_ref
    registry = registry or REGISTRY
    if registry not in _installed:
        _installed.add(registry)
        registry.add_refresher(_refresh)
    metrics.PROCESS_START_TIME.set(_START_TIME)
    if cell_bytes is None:
        _cell_bytes_ref = None
    else:
        try:
            # weak for the normal bound-method hook: a dead controller's
            # series simply stop; plain functions fall back to a strong ref
            _cell_bytes_ref = weakref.WeakMethod(cell_bytes)
        except TypeError:
            _cell_bytes_ref = lambda fn=cell_bytes: fn
    if memory_profiling:
        enable_memory_profiling()
    elif _memory_profiling:
        disable_memory_profiling()
