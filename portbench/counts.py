"""The yardstick's arithmetic: the card's published peaks, the kernels'
operations and bytes counted from a problem's shapes, and the host's
garbage-collector clock.

``bound``, ``k1_op_count`` and ``k2_op_count`` are frozen copies of
``chip_smoke.py:403-410`` and ``chip_smoke.py:492-504``, and ``GcClock`` of
``chip_smoke.gc_seconds`` (``chip_smoke.py:1810-1831``). They take shapes,
never the kernel's launches, passes or its own slot doubling: a later change
to how the chain does its work cannot change what the work is counted as.
"""

from __future__ import annotations

import gc
import time

#: NVIDIA H100 SXM, published dense peaks at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: portfolio members a chain runs (the port's ``TorchSolver.portfolio``
#: default when this benchmark was written), and f32/int32 words
PORTFOLIO_K = 8
WORD = 4


def bound(bytes_moved: float, ops: float) -> float:
    """The least seconds the card could take: the larger of bytes over the
    memory bandwidth and operations over the f32 rate."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def k1_op_count(G: int, O: int, R: int) -> int:
    """K1's f32 operations: unit counts, residuals and the val_pair table."""
    return 2 * G * O * R * 3 + G * O * G * R * 5 + G * O * G * 3


def k2_op_count(G: int, O: int, E: int, R: int, S: int, K: int = PORTFOLIO_K) -> int:
    """One K2 launch's operations: per member the steps of the groups with
    pods, three option sweeps and one slot sweep each. The lookahead
    members' price sweeps are not counted (which members look ahead is the
    program's choice), so this is a floor of the work."""
    return K * G * (3 * 2 * O * 3 + (E + S) * (4 * R + 20))


def input_bytes(G: int, O: int, R: int) -> int:
    """A problem's arrays as the chain reads them once: demand, count,
    alloc, price, option zone (words) and the compatibility mask (bytes)."""
    return WORD * (G * R + G + O * R + 2 * O) + G * O


def k2_bytes(G: int, O: int, E: int, R: int, S: int, K: int = PORTFOLIO_K) -> int:
    """One K2 launch: the inputs and K1's unit table read once, each
    member's assignment counts and slot options written once."""
    return input_bytes(G, O, R) + WORD * G * O + K * WORD * (G * (E + S) + S)


def k1_bytes(G: int, O: int, R: int) -> int:
    """K1: the inputs read once, the unit table and the val_pair table written."""
    return input_bytes(G, O, R) + WORD * (G * O + G * O * G)


def chain_least_s(G: int, O: int, E: int, R: int, S: int) -> tuple:
    """(least seconds of K2's two launches, least seconds of the whole
    K1-K2-K2-K3 chain) for one problem. K3 reads the members' costs and
    writes one plan: counted with the bytes of one member's plan."""
    k2 = 2 * bound(k2_bytes(G, O, E, R, S), k2_op_count(G, O, E, R, S))
    k3 = bound(WORD * (2 * PORTFOLIO_K + G * (E + S) + S), 0)
    return k2, bound(k1_bytes(G, O, R), k1_op_count(G, O, R)) + k2 + k3


class GcClock:
    """Host seconds spent in CPython's cyclic garbage collector since
    ``start()``, read with ``seconds``."""

    def __init__(self):
        self.seconds = 0.0
        self._t = []

    def _track(self, phase, info):
        if phase == "start":
            self._t.append(time.perf_counter())
        elif self._t:
            self.seconds += time.perf_counter() - self._t.pop()

    def start(self):
        gc.callbacks.append(self._track)

    def stop(self):
        if self._track in gc.callbacks:
            gc.callbacks.remove(self._track)
