"""Garbage-collector tuning for the latency-sensitive solve path.

A 50k-pod problem holds ~10^5 long-lived Python objects (pods, groups, options,
encoded tensors). CPython's generational GC rescans that heap on every gen-2
collection, which lands as a ~150ms pause in the middle of a solve — measured
as periodic 240ms outliers on an otherwise ~95ms p50 (the reference's Go
runtime takes concurrent-GC pauses <1ms, so it never had to care;
upstream ``cmd/controller/main.go`` does no GC tuning).

``freeze_long_lived()`` is the standard CPython remedy: move everything
currently reachable into the permanent generation (``gc.freeze``) so gen-2
scans only see objects allocated after the freeze, and raise the gen-2
threshold so full collections are rare. Call it after the long-lived state is
built: operator startup after the first reconcile, bench after warmup.
"""

from __future__ import annotations

import gc

_frozen = False


def freeze_long_lived(gen2_multiplier: int = 64) -> None:
    """Freeze the current heap into the permanent generation and make gen-2
    collections ``gen2_multiplier``x rarer. Idempotent-ish: refreezing later
    moves newly created long-lived objects too (cheap, safe).

    The multiplier is deliberately aggressive: with ``maintain()`` running in
    the operator's idle windows, auto gen-2 collections should essentially
    never fire mid-solve — a steady stream of 50k-pod batches retains enough
    learned state (interned problems, pattern pools) that an auto gen-2 scan
    costs ~300ms, measured as rare 4x outliers on an ~85ms cold solve."""
    global _frozen
    gc.collect()
    gc.freeze()
    if not _frozen:
        g0, g1, g2 = gc.get_threshold()
        gc.set_threshold(g0, g1, max(g2 * gen2_multiplier, g2))
        _frozen = True


def maintain() -> None:
    """Idle-window GC maintenance: run the full collection at a moment nobody
    is waiting on it. The provisioning loop has natural idle time (the
    reference batches pods at 1s-idle/10s-max windows,
    ``website/.../settings.md:41-47``); spending it here keeps full-GC pauses
    out of the latency-sensitive solve path (the auto gen-2 threshold is set
    high by ``freeze_long_lived``). Deliberately does NOT freeze: freezing
    live transients (cache entries about to rotate out, in-flight reconcile
    state) would exempt them from cycle collection forever — only the
    startup baseline is frozen, once."""
    gc.collect()
