"""DeviceStager: delta-aware device residency of problem tensors
(``karpenter_tpu/solver/staging.py``), and the two staging kernels.

The stager keeps the last staged tensors of each padded-shape tag resident
on the device and, for each new round of leaves (numpy arrays):

* **hit**: a leaf byte-identical to the retained host copy is served from
  residency, nothing moves;
* **restage**: a leaf whose churn is confined to at most half of its axis-0
  rows gets only those rows: one host-to-device copy of the churned rows,
  then ``stage_patch`` scatters them into the resident tensor in place;
* **full**: any other leaf is one host-to-device copy; a shape, dtype or
  leaf-set change of a tag drops its residency first (an invalidate).

A leaf is reused only when its bytes equal the retained host copy, so a
stale tensor can never serve a changed problem. A restage patches the
resident tensor in place: the tensors a tag handed out earlier change with
it, so a caller holds one problem per tag at a time (``TorchSolver`` keeps
one problem resident). Patches and uploads run on the current stream; a
chain on another stream that reads resident tensors hands its last event to
``fence``, and the stager's next write waits for it.

``fleet_stack`` builds the ``[B, ...]`` leaves of a fleet chunk on the device
from B resident problems and the pad row (``stage_fleet``'s device-side
stack). Both kernels are in ``csrc/staging.cu``; their plain versions are
``index_copy_`` and ``torch.stack``, taken only for CPU tensors. Launches
count in ``torch_solver.LAUNCHES``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import metrics
from . import torch_solver as ts


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def stage_patch_ref(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``dst[idx[j]] = src[j]`` along axis 0, in place."""
    return dst.index_copy_(0, idx, src)


def stage_patch(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Scatter the rows ``src`` into ``dst`` at the axis-0 rows ``idx``
    (int64), in place. Repeated indices must carry equal rows. The kernel on
    CUDA tensors, ``index_copy_`` on CPU tensors. The kernel does not check
    ``idx``: every index must lie in ``[0, len(dst))``, which the caller
    checks on the host (``DeviceStager._patch`` does)."""
    if dst.device.type == "cpu":
        return stage_patch_ref(dst, idx, src)
    dev = dst.device
    n = idx.shape[0] if idx.dim() == 1 else -1
    ts._check("src", src, dst.dtype, (n,) + tuple(dst.shape[1:]), dev)
    ts._check("idx", idx, torch.int64, (n,), dev)
    if not dst.is_contiguous() or dst.dim() == 0:
        raise ValueError("stage_patch: dst must be contiguous with an axis 0")
    if n == 0:
        return dst
    from ._build import load_kernels

    return _launch_stage_patch(load_kernels(), dst, idx, src, ts._stream())


def _launch_stage_patch(lib, dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor, stream):
    row_bytes = dst[0].numel() * dst.element_size()
    rc = lib.kts_stage_patch(ts._ptr(dst), ts._ptr(src), ts._ptr(idx), idx.shape[0], row_bytes,
                             stream)
    ts._count("stage_patch")
    ts._raise_on(lib, rc, "stage_patch")
    return dst


def fleet_stack_ref(rows: Sequence[Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {name: torch.stack([r[name] for r in rows]) for name in rows[0]}


def fleet_stack(rows: Sequence[Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Stack B problems' leaves (a mapping of leaf name to tensor per row;
    rows may repeat, as pad rows do) into ``[B, ...]`` tensors: one kernel
    launch for every leaf and row on CUDA tensors, ``torch.stack`` on CPU
    tensors."""
    dev = next(iter(rows[0].values())).device
    if dev.type == "cpu":
        return fleet_stack_ref(rows)
    from ._build import load_kernels

    return _launch_fleet_stack(load_kernels(), rows, ts._stream())


def _launch_fleet_stack(lib, rows: Sequence[Mapping[str, torch.Tensor]], stream):
    dev = next(iter(rows[0].values())).device
    out, table = {}, []
    for name, t0 in rows[0].items():
        for b, r in enumerate(rows):
            x = r[name]
            if x.shape != t0.shape or x.dtype != t0.dtype or x.device != dev or not x.is_contiguous():
                ts._check(f"{name}[{b}]", x, t0.dtype, tuple(t0.shape), dev)
        out[name] = torch.empty((len(rows),) + tuple(t0.shape), dtype=t0.dtype, device=dev)
        nbytes = t0.numel() * t0.element_size()
        if nbytes:
            base = out[name].data_ptr()
            table.extend((r[name].data_ptr(), base + b * nbytes, nbytes) for b, r in enumerate(rows))
    if not table:
        return out
    # the (source, destination, bytes) table goes to the device on the
    # launch's stream, from pinned memory, without waiting for the card
    table_d = torch.tensor(table, dtype=torch.int64)
    if dev.type == "cuda":
        table_d = table_d.pin_memory().to(dev, non_blocking=True)
    rc = lib.kts_fleet_stack(ts._ptr(table_d), len(table), max(e[2] for e in table), stream)
    ts._count("fleet_stack")
    ts._raise_on(lib, rc, "fleet_stack")
    return out


# ---------------------------------------------------------------------------
# The stager
# ---------------------------------------------------------------------------

class _Entry:
    __slots__ = ("host", "dev", "nbytes")

    def __init__(self):
        self.host: Dict[str, np.ndarray] = {}
        self.dev: Dict[str, torch.Tensor] = {}
        self.nbytes = 0


class DeviceStager:
    """Per-solver device staging cache. Thread-safe, one lock per stager, as
    the reference's is: solver clones each own a private stager, but
    ``stage_fleet`` stages through a clone's stager from the controller
    thread. ``enabled=False`` keeps nothing resident: every leaf is uploaded
    whole on every call."""

    #: restage only when at most this fraction of axis-0 rows churned: past
    #: it a full-leaf upload is cheaper than the scatter's bookkeeping
    RESTAGE_FRAC = 0.5

    def __init__(self, capacity_mb: int = 256, device="cuda", enabled: bool = True):
        self.device = torch.device(device)
        self.enabled = enabled
        self.capacity_bytes = int(capacity_mb) << 20
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self.stats: Dict[str, int] = {
            "hits": 0, "restages": 0, "restaged_rows": 0,
            "invalidates": 0, "evicts": 0, "staged_leaves": 0,
            # transfer actually paid against what a stager-less solver would
            # have uploaded (hit_rate = 1 - transferred / total)
            "bytes_total": 0, "bytes_transferred": 0,
        }
        # the last stage() call's outcome: leaf counts per event, churned
        # rows per restaged leaf, and its bytes
        self.last_round: Dict[str, object] = {}
        self._fence: Optional[torch.cuda.Event] = None

    def fence(self, event: "torch.cuda.Event") -> None:
        """Order the stager's next write after ``event``: a chain on another
        stream that reads resident tensors records it after its launches,
        and the next ``stage`` or ``invalidate`` makes the current stream
        wait on it before it patches, uploads or drops a resident leaf, so
        that no leaf is overwritten under a chain still reading it."""
        with self._lock:
            self._fence = event

    def _wait_fence(self) -> None:
        # called with the lock held
        if self._fence is not None:
            torch.cuda.current_stream(self.device).wait_event(self._fence)
            self._fence = None

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        # copy=True: on the CPU a tensor must not share the caller's memory
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device, copy=True)

    def stage(self, tag: tuple, leaves: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Device tensors for ``leaves``, reusing or patching the resident
        entry of ``tag`` where the bytes allow. ``tag`` must pin every static
        of the padded shape (bucket dims, K, fleet width)."""
        if not self.enabled:
            # fresh tensors every call: nothing resident is overwritten
            return {k: self._upload(np.asarray(v)) for k, v in leaves.items()}
        with self._lock:
            self._wait_fence()
            round_info: Dict[str, object] = {
                "hit": 0, "restage": 0, "full": 0, "rows": {},
                "bytes_total": 0, "bytes_transferred": 0,
            }
            entry = self._entries.get(tag)
            fresh = False
            if entry is None or any(
                (old := entry.host.get(k)) is None
                or old.shape != np.shape(v)
                or old.dtype != np.asarray(v).dtype
                for k, v in leaves.items()
            ) or set(entry.host) != set(leaves):
                # structural change (bucket growth, axes change) or first
                # contact: residency for this tag starts over
                if entry is not None:
                    self.stats["invalidates"] += 1
                    metrics.DEVICE_STAGING.inc({"event": "invalidate"})
                entry = _Entry()
                fresh = True
            out: Dict[str, torch.Tensor] = {}
            hits = restages = 0
            bytes_total = bytes_moved = 0
            for name, new in leaves.items():
                new = np.asarray(new)
                bytes_total += new.nbytes
                if not fresh:
                    old_host = entry.host[name]
                    if np.array_equal(old_host, new):
                        out[name] = entry.dev[name]
                        hits += 1
                        continue
                    patched = self._patch(entry.dev[name], old_host, new)
                    if patched is not None:
                        dev, rows = patched
                        out[name] = dev
                        entry.dev[name] = dev
                        # a private host copy: the caller's array may change
                        entry.host[name] = new.copy()
                        restages += 1
                        round_info["rows"][name] = rows
                        self.stats["restaged_rows"] += rows
                        bytes_moved += (new.nbytes // max(new.shape[0], 1)) * rows
                        continue
                dev = self._upload(new)
                out[name] = dev
                entry.dev[name] = dev
                entry.host[name] = new.copy()
                round_info["full"] += 1
                self.stats["staged_leaves"] += 1
                bytes_moved += new.nbytes
            entry.nbytes = sum(a.nbytes for a in entry.host.values())
            self._entries.pop(tag, None)
            self._entries[tag] = entry  # most recent at the end
            self._evict()
            self.stats["hits"] += hits
            self.stats["restages"] += restages
            self.stats["bytes_total"] += bytes_total
            self.stats["bytes_transferred"] += bytes_moved
            round_info["hit"] = hits
            round_info["restage"] = restages
            round_info["bytes_total"] = bytes_total
            round_info["bytes_transferred"] = bytes_moved
            self.last_round = round_info
        if hits:
            metrics.DEVICE_STAGING.inc({"event": "hit"}, hits)
        if restages:
            metrics.DEVICE_STAGING.inc({"event": "restage"}, restages)
        return out

    def _patch(self, old_dev: torch.Tensor, old_host: np.ndarray, new: np.ndarray
               ) -> Optional[Tuple[torch.Tensor, int]]:
        """Scatter the churned axis-0 rows into the resident tensor when they
        are a minority. Returns (tensor, churned row count), or None: the
        caller uploads the leaf whole."""
        if new.ndim == 0 or new.shape[0] == 0:
            return None
        diff = old_host != new
        # NaN != NaN, so a row holding NaN always restages: never a stale reuse
        changed = (
            np.flatnonzero(diff)
            if new.ndim == 1
            else np.flatnonzero(diff.reshape(new.shape[0], -1).any(axis=1))
        )
        if changed.size == 0 or changed.size > max(1, int(new.shape[0] * self.RESTAGE_FRAC)):
            return None
        rows = int(changed.size)
        # the kernel trusts its indices, so they are checked here, where they
        # are still on the host (flatnonzero: ascending, none negative)
        if changed[-1] >= old_dev.shape[0]:
            raise ValueError(f"stage_patch: row {int(changed[-1])} is outside the resident "
                             f"leaf of {old_dev.shape[0]} rows")
        # the index set is padded to a power of two with repeats of its first
        # row, as the reference pads it; repeats write equal bytes
        width = 1 << (rows - 1).bit_length() if rows > 1 else 1
        if width != rows:
            changed = np.concatenate([changed, np.full(width - rows, changed[0], changed.dtype)])
        idx = self._upload(changed.astype(np.int64))
        src = self._upload(new[changed])
        return stage_patch(old_dev, idx, src), rows

    # -- bookkeeping --------------------------------------------------------
    def _evict(self) -> None:
        # called with the lock held
        total = sum(e.nbytes for e in self._entries.values())
        while total > self.capacity_bytes and len(self._entries) > 1:
            _, evicted = self._entries.popitem(last=False)
            total -= evicted.nbytes
            self.stats["evicts"] += 1
            metrics.DEVICE_STAGING.inc({"event": "evict"})

    def invalidate(self) -> None:
        """Drop all residency (a settings change, an explicit cache clear)."""
        with self._lock:
            self._wait_fence()
            if self._entries:
                self.stats["invalidates"] += len(self._entries)
                metrics.DEVICE_STAGING.inc({"event": "invalidate"}, len(self._entries))
            self._entries.clear()

    def resident_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values())

    def hit_rate(self) -> float:
        """Byte-weighted fraction of staged traffic served from residency
        (1.0: nothing crossed the host link)."""
        with self._lock:
            total = self.stats["bytes_total"]
            if not total:
                return 0.0
            return 1.0 - self.stats["bytes_transferred"] / total
