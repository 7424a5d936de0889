"""DeviceStager: delta-aware device residency of problem tensors
(``karpenter_tpu/solver/staging.py``), and the two staging kernels.

The stager keeps the last staged tensors of each padded-shape tag resident
on the device and, for each new round of leaves (numpy arrays):

* **hit**: a leaf byte-identical to the retained host copy is served from
  residency, nothing moves;
* **restage**: a leaf whose churn is confined to at most half of its axis-0
  rows gets only those rows, scattered into the resident tensor in place.
  All restaged leaves of one call go together (``stage_patches``): for each
  device, one host-to-device copy of every leaf's churned rows and indices
  and one launch of the ``stage_patch`` kernel;
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

import ctypes
import threading
from collections import OrderedDict
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import faults, metrics
from . import torch_solver as ts


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

#: stage() calls that patched on a card, one for each device they patched,
#: and the host-to-device copies their patches made: with
#: ``LAUNCHES["stage_patch"]``, what shows that a restage is one copy and one
#: launch for each device
RESTAGES: Dict[str, int] = {"calls": 0, "copies": 0}
_RESTAGE_LOCK = threading.Lock()
_ALIGN = 16  # byte alignment of every segment of a packed patch buffer


def _restaged(key: str) -> None:
    with _RESTAGE_LOCK:
        RESTAGES[key] += 1


def _row_bytes(t: torch.Tensor) -> int:
    return (t.numel() // max(t.shape[0], 1)) * t.element_size()


def stage_patch_ref(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``dst[idx[j]] = src[j]`` along axis 0, in place."""
    return dst.index_copy_(0, idx, src)


def stage_patch(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Scatter the rows ``src`` into ``dst`` at the axis-0 rows ``idx``
    (int64), in place: one leaf's patch, a batch of one through the kernel
    that ``stage_patches`` launches. Repeated indices must carry equal rows.
    The kernel on CUDA tensors, ``index_copy_`` on CPU tensors. The kernel
    does not check ``idx``: every index must lie in ``[0, len(dst))``, which
    the caller checks on the host (``DeviceStager`` does)."""
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

    with torch.cuda.device(dev):
        return _launch_stage_patch(load_kernels(), dst, idx, src, ts._stream(dev))


def _launch_stage_patch(lib, dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor, stream):
    table = np.array([[dst.data_ptr(), idx.data_ptr(), src.data_ptr(), idx.shape[0],
                       _row_bytes(dst)]], np.int64)
    _run_stage_patch(lib, table, stream)
    return dst


def _run_stage_patch(lib, table: np.ndarray, stream) -> int:
    launches = ctypes.c_int(0)
    rc = lib.kts_stage_patch(table.ctypes.data, table.shape[0], stream, ctypes.byref(launches))
    ts._count("stage_patch", n=launches.value)
    ts._raise_on(lib, rc, "stage_patch")
    return launches.value


def patch_layout(patches) -> Tuple[np.ndarray, int]:
    """Where each patch ``(dst, idx, src)`` lies in the packed buffer: its
    indices' and its rows' byte offsets (``[n, 2]``), each a multiple of 16,
    and the buffer's size."""
    offs = np.empty((len(patches), 2), np.int64)
    at = 0
    for i, (_, idx, src) in enumerate(patches):
        offs[i, 0] = at
        at += -(-idx.nbytes // _ALIGN) * _ALIGN
        offs[i, 1] = at
        at += -(-src.nbytes // _ALIGN) * _ALIGN
    return offs, at


def pack_patches(patches, offs: np.ndarray, buf: np.ndarray) -> None:
    """Write every patch's indices (int64) and rows (their dtype's bytes, in
    index order) into ``buf`` (uint8) at ``patch_layout``'s offsets."""
    for (_, idx, src), (io, so) in zip(patches, offs):
        buf[io:io + idx.nbytes] = idx.view(np.uint8)
        buf[so:so + src.nbytes] = src.reshape(-1).view(np.uint8)


def stage_patches(patches: Sequence[Tuple[torch.Tensor, np.ndarray, np.ndarray]]) -> int:
    """Scatter every patch ``(dst, idx, src)`` of one device, in place: the
    host rows ``src`` (``dst``'s dtype and row shape, contiguous) into the
    resident tensor ``dst`` at the axis-0 rows ``idx`` (int64, host). On
    CUDA tensors: every patch's indices and rows packed into one pinned host
    buffer, one copy of it to the card on the current stream and one launch
    of the kernel (a second only past a table's 128 entries); ``index_copy_``
    on CPU tensors. Returns the launches made. The kernel trusts the
    indices: the caller checks them (``DeviceStager`` does)."""
    if not patches:
        return 0
    dev = patches[0][0].device
    for dst, idx, src in patches:
        if dst.device != dev or not dst.is_contiguous() or dst.dim() == 0:
            raise ValueError(f"stage_patches: every dst must be contiguous on {dev}")
        if idx.dtype != np.int64 or idx.ndim != 1 or src.shape != idx.shape + tuple(dst.shape[1:]):
            raise ValueError(f"stage_patches: idx {idx.dtype}{idx.shape} and src {src.shape} do "
                             f"not fit rows of {tuple(dst.shape)}")
        if src.dtype.itemsize != dst.element_size() or not src.flags.c_contiguous:
            raise ValueError(f"stage_patches: src {src.dtype} is not contiguous {dst.dtype}")
    if dev.type == "cpu":
        for dst, idx, src in patches:
            stage_patch_ref(dst, torch.from_numpy(idx), torch.from_numpy(src))
        return 0
    from ._build import load_kernels

    with torch.cuda.device(dev):
        return _launch_stage_patches(load_kernels(), patches, ts._stream(dev))


def _launch_stage_patches(lib, patches, stream) -> int:
    dev = patches[0][0].device
    offs, total = patch_layout(patches)
    # A block of the caching host allocator. The non_blocking copy below
    # records an event on the stream for it (copy_kernel_cuda calls the
    # allocator's record_event), and free() puts the block back on the free
    # list only once that event has completed (CachingHostAllocator.h), so
    # no later call gets this memory while the copy may still read it.
    host = torch.empty(total, dtype=torch.uint8, pin_memory=dev.type == "cuda")
    pack_patches(patches, offs, host.numpy())
    # on the current stream, after the stager's fence; the device buffer goes
    # back to the stream-ordered allocator behind the launch that reads it.
    # On the CPU (the emulated kernel) the buffer is the host one.
    buf = host.to(dev, non_blocking=True)
    if dev.type == "cuda":
        _restaged("copies")
    base = buf.data_ptr()
    table = np.empty((len(patches), 5), np.int64)
    for i, (dst, idx, _) in enumerate(patches):
        table[i] = (dst.data_ptr(), base + offs[i, 0], base + offs[i, 1], idx.shape[0],
                    _row_bytes(dst))
    return _run_stage_patch(lib, table, stream)


def fleet_stack_ref(rows: Sequence[Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {name: torch.stack([r[name] for r in rows]) for name in rows[0]}


def fleet_stack(rows: Sequence[Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Stack B problems' leaves (a mapping of leaf name to tensor per row;
    rows may repeat, as pad rows do) into ``[B, ...]`` tensors: one kernel
    launch for every leaf and row on CUDA tensors (more only past a table's
    room, which no fleet chunk of 16 rows reaches), ``torch.stack`` on CPU
    tensors."""
    dev = next(iter(rows[0].values())).device
    if dev.type == "cpu":
        return fleet_stack_ref(rows)
    from ._build import load_kernels

    with torch.cuda.device(dev):
        return _launch_fleet_stack(load_kernels(), rows, ts._stream(dev))


def _launch_fleet_stack(lib, rows: Sequence[Mapping[str, torch.Tensor]], stream):
    first = rows[0]
    names = list(first)
    dev = next(iter(first.values())).device
    # the launch's table: each leaf's output and row bytes, and each (leaf,
    # row)'s source address, read once from each distinct row (pad rows
    # repeat one); it goes to the card as the kernel's parameter
    sources = {}
    for b, r in enumerate(rows):
        if id(r) in sources:
            continue
        for name, t0 in first.items():
            x = r[name]
            if x.shape != t0.shape or x.dtype != t0.dtype or x.device != dev or not x.is_contiguous():
                ts._check(f"{name}[{b}]", x, t0.dtype, tuple(t0.shape), dev)
        sources[id(r)] = np.fromiter((r[name].data_ptr() for name in names), np.int64, len(names))
    out = {name: torch.empty((len(rows),) + tuple(t.shape), dtype=t.dtype, device=dev)
           for name, t in first.items()}
    leaves = np.empty((len(names), 2), np.int64)
    leaves[:, 0] = np.fromiter((t.data_ptr() for t in out.values()), np.int64, len(names))
    leaves[:, 1] = np.fromiter((t.numel() * t.element_size() for t in first.values()), np.int64,
                               len(names))
    srcs = np.ascontiguousarray(np.stack([sources[id(r)] for r in rows], axis=1))
    launches = ctypes.c_int(0)
    rc = lib.kts_fleet_stack(leaves.ctypes.data, srcs.ctypes.data, len(names), len(rows), stream,
                             ctypes.byref(launches))
    ts._count("fleet_stack", n=launches.value)
    ts._raise_on(lib, rc, "fleet_stack")
    return out


# ---------------------------------------------------------------------------
# The stager
# ---------------------------------------------------------------------------

def _changed_rows(old: np.ndarray, new: np.ndarray) -> np.ndarray:
    """The axis-0 rows where ``new`` differs from ``old``, ascending. NaN !=
    NaN, so a row holding NaN always restages: never a stale reuse."""
    diff = old != new
    return np.flatnonzero(diff if new.ndim == 1 else diff.reshape(new.shape[0], -1).any(axis=1))


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
        # the last stage() call's patches: devices patched, patches (a
        # placed leaf's shard blocks each one) and stage_patch launches
        self.last_patch: Dict[str, int] = {"devices": 0, "entries": 0, "launches": 0}
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

    def stage(self, tag: tuple, leaves: Mapping[str, np.ndarray], put=None) -> Dict[str, torch.Tensor]:
        """Device tensors for ``leaves``, reusing or patching the resident
        entry of ``tag`` where the bytes allow. ``tag`` must pin every static
        of the padded shape (bucket dims, K, fleet width).

        ``put(name, array)`` places a full upload in place of the plain
        copy to the stager's device: the meshed tier passes the rule table's
        placement (``parallel.mesh.device_put``), and the leaf is then a
        ``Placed`` with one tensor per shard. A hit serves it as it lies, and
        a restage patches each shard's block on the shard that holds it,
        only where that block's rows changed. Every patch of the call goes
        in one ``stage_patches`` for each device it lies on.

        The device-fault seam (``utils/faults.py``, site ``"staging"``) is
        the reference's: a scripted ``staging-corruption`` multiplies
        ``alloc`` (or the first non-empty float leaf) by 4 on its way to the
        device, leaving the caller's dict untouched. The corrupted bytes are
        what the stager keeps as the leaf's host copy, so the next clean
        round's true bytes differ and the leaf restages: the self-heal."""
        fault = faults.device_fault("staging")
        if fault is not None:
            # an inflated node capacity makes the kernel overpack, a
            # violation no cost comparison can mask
            leaves = dict(leaves)
            victim = "alloc" if "alloc" in leaves else next(
                (k for k, v in leaves.items()
                 if np.asarray(v).dtype.kind == "f" and np.asarray(v).size),
                None,
            )
            if victim is not None:
                corrupted = np.asarray(leaves[victim]).copy()
                corrupted *= 4.0
                leaves[victim] = corrupted
        upload = (lambda k, v: put(k, v)) if put is not None else (lambda k, v: self._upload(v))
        if not self.enabled:
            # fresh tensors every call: nothing resident is overwritten
            return {k: upload(k, np.asarray(v)) for k, v in leaves.items()}
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
            # every restaged leaf's patches (shard blocks of a placed leaf
            # too), launched together once every leaf's outcome is known
            patches, restaged = [], {}
            for name, new in leaves.items():
                new = np.asarray(new)
                bytes_total += new.nbytes
                if not fresh:
                    old_host = entry.host[name]
                    if np.array_equal(old_host, new):
                        out[name] = entry.dev[name]
                        hits += 1
                        continue
                    plan = (self._plan_placed if put is not None else self._plan)(
                        entry.dev[name], old_host, new)
                    if plan is not None:
                        rows, leaf_patches = plan
                        patches += leaf_patches
                        out[name] = entry.dev[name]
                        restaged[name] = new
                        restages += 1
                        round_info["rows"][name] = rows
                        bytes_moved += (new.nbytes // max(new.shape[0], 1)) * rows
                        continue
                dev = upload(name, new)
                out[name] = dev
                entry.dev[name] = dev
                entry.host[name] = new.copy()
                round_info["full"] += 1
                self.stats["staged_leaves"] += 1
                bytes_moved += new.nbytes
            self.last_patch = self._launch_patches(patches)
            for name, new in restaged.items():
                # a private host copy: the caller's array may change
                entry.host[name] = new.copy()
                self.stats["restaged_rows"] += round_info["rows"][name]
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

    def _launch_patches(self, patches) -> Dict[str, int]:
        """``stage_patches`` for each device the patches lie on; counts each
        device patched on a card as one restaging call (``RESTAGES``).
        Returns the call's ``last_patch``."""
        by_device: Dict[torch.device, list] = {}
        for p in patches:
            by_device.setdefault(p[0].device, []).append(p)
        launches = 0
        for dev, group in by_device.items():
            launches += stage_patches(group)
            if dev.type == "cuda":
                _restaged("calls")
        return {"devices": len(by_device), "entries": len(patches), "launches": launches}

    def _churned(self, old_host: np.ndarray, new: np.ndarray) -> Optional[np.ndarray]:
        """The churned axis-0 rows of a leaf (ascending) when they are a
        minority; None: the leaf goes up whole."""
        if new.ndim == 0 or new.shape[0] == 0:
            return None
        changed = _changed_rows(old_host, new)
        if changed.size == 0 or changed.size > max(1, int(new.shape[0] * self.RESTAGE_FRAC)):
            return None
        return changed

    @staticmethod
    def _patch_of(dst: torch.Tensor, changed: np.ndarray, new: np.ndarray):
        """The patch ``(dst, indices, rows)`` writing ``new``'s rows
        ``changed`` into ``dst``. The reference pads the index set to a power
        of two to bound XLA's compiled variants; the kernel compiles nothing
        per shape, so the churned rows go as they are."""
        # the kernel trusts its indices, so they are checked here, where they
        # are still on the host (ascending, none negative)
        if changed[-1] >= dst.shape[0]:
            raise ValueError(f"stage_patch: row {int(changed[-1])} is outside the resident "
                             f"leaf of {dst.shape[0]} rows")
        return dst, changed.astype(np.int64), np.ascontiguousarray(new[changed])

    def _plan(self, old_dev: torch.Tensor, old_host: np.ndarray, new: np.ndarray):
        """The restage of a resident leaf: (churned row count, its patch),
        or None: the caller uploads the leaf whole."""
        changed = self._churned(old_host, new)
        if changed is None:
            return None
        return int(changed.size), [self._patch_of(old_dev, changed, new)]

    def _plan_placed(self, placed, old_host: np.ndarray, new: np.ndarray):
        """``_plan`` of a placed leaf. Whether it restages is the whole
        leaf's call, as in the reference; then each shard whose block
        changed restages its own block's churned rows where it lies.
        Returns (churned rows of the whole leaf, the shards' patches), or
        None: the caller places the leaf whole."""
        changed = self._churned(old_host, new)
        if changed is None:
            return None
        patches = []
        for i, t in enumerate(placed.shards):
            sl = placed.sharding.slices(new.shape, i)
            block = _changed_rows(old_host[sl], new[sl])
            if block.size:
                patches.append(self._patch_of(t, block, new[sl]))
        return int(changed.size), patches

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
