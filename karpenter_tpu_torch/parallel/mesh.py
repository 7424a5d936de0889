"""Device-mesh distribution of the solver portfolio
(``karpenter_tpu/parallel/mesh.py``).

Two mesh generations, as in the JAX package:

* the **1D portfolio mesh** (``make_mesh``): portfolio members shard over a
  single ``portfolio`` axis, problem tensors replicate, and a fleet
  dispatch's batch rows split over the same axis when they divide it; and
* the **2D meshed solver tier** (``make_mesh2d``): an ``options`` x
  ``fleet`` mesh where the option columns of the problem tensors partition
  across ``options`` and the superproblem batch rows (same-bucket cells of a
  sharded round) across ``fleet``. Which leaf lands on which axis is decided
  by the rule table over leaf names (``PARTITION_RULES``); an unmatched leaf
  is a hard error.

A ``Mesh`` is the axis names and an array of ``torch.device`` entries. The
entries may repeat a device: each entry is a *logical shard* with its own
CUDA stream, which is how the tier runs on one card (and, on the CPU, in the
tests), as the JAX package runs it on virtual CPU devices. ``make_mesh`` and
``make_mesh2d`` default to every visible card, once each.

A placed leaf (``Placed``) holds one tensor per mesh entry: the slice of the
leaf its entry owns under the leaf's ``PartitionSpec``, a whole copy on every
entry for a replicated dim. The meshed chain (``torch_solver.pack_solve_meshed``)
runs each shard's kernels on that shard's stream and exchanges between
shards by event-ordered device copies; nothing goes through the host.
"""

from __future__ import annotations

import math
import re
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

PORTFOLIO_AXIS = "portfolio"

#: 2D meshed-tier axes: option/candidate columns x superproblem batch rows
OPTIONS_AXIS = "options"
FLEET_AXIS = "fleet"


class PartitionSpec(tuple):
    """One mesh axis name (or None) per dim of a leaf, as
    ``jax.sharding.PartitionSpec``; dims past its length replicate."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec

#: The sharding-rule table of the meshed solver tier, in match-first order:
#: ``(leaf-name regex, PartitionSpec over the leaf's OWN dims)``. Option-axis
#: tensors shard their O dim on ``options``; everything group-, existing-,
#: zone- or scalar-shaped replicates; the portfolio member arrays replicate
#: too (on the 2D tier the parallel axis is the option axis, not K). The
#: superproblem batch dim is not in the table: ``match_partition_rules``
#: prefixes ``fleet`` for batched leaves.
PARTITION_RULES: Tuple[Tuple[str, PartitionSpec], ...] = (
    # option-axis problem tensors: O leads
    (r"^(alloc|price|opt_zone|opt_valid)$", P(OPTIONS_AXIS)),
    # compat is [G, O]: O is dim 1
    (r"^compat$", P(None, OPTIONS_AXIS)),
    # group-axis tensors, per-group zone quotas, relation bitmasks: replicate
    (r"^(demand|demand_units|count|node_cap|quota|colocate)$", P()),
    # existing-capacity slots and their relation bits: replicate
    (r"^(ex_rem|ex_zone|ex_compat|ex_valid)$", P()),
    (r"^rel_", P()),
    # portfolio member arrays (orders/alphas/looks/rsvs/swaps): replicate
    (r"^(orders|alphas|looks|rsvs|swaps)$", P()),
)


def match_partition_rules(
    name: str,
    shape: Sequence[int],
    batch: bool = False,
    rules: Sequence[Tuple[str, PartitionSpec]] = PARTITION_RULES,
) -> PartitionSpec:
    """The PartitionSpec for one problem-tensor leaf, by name.

    Scalars (and 1-element leaves) are never partitioned. ``batch=True``
    treats dim 0 as the superproblem batch axis (sharded on ``fleet``) and
    matches the rule against the remaining dims. A leaf whose name no rule
    covers raises."""
    shape = tuple(shape)
    inner = shape[1:] if batch else shape
    lead = (FLEET_AXIS,) if batch else ()
    if len(inner) == 0 or int(np.prod(inner, dtype=np.int64)) <= 1:
        return P(*lead) if lead else P()
    for rule, spec in rules:
        if re.search(rule, name):
            return P(*(lead + tuple(spec)))
    raise ValueError(f"Partition rule not found for param: {name}")


class Mesh:
    """Named axes over an array of devices (``jax.sharding.Mesh``'s
    shape). ``devices`` may name one device several times: each entry is a
    logical shard. Each shard on a card gets its own stream, made at first
    use (``stream``)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.empty(np.shape(devices), dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(np.asarray(devices, dtype=object)[idx])
        if arr.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {arr.shape} for axes {tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self._streams: Optional[List] = None
        # a sharded round's clones share one mesh and may dispatch from
        # several threads
        self._lock = threading.Lock()

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat(self) -> List[torch.device]:
        """The entries in row-major order: shard i of a placed leaf."""
        return list(self.devices.reshape(-1))

    def stream(self, i: int):
        """Shard i's CUDA stream (None for a CPU shard)."""
        with self._lock:
            if self._streams is None:
                self._streams = [
                    torch.cuda.Stream(d) if d.type == "cuda" else None for d in self.flat()
                ]
        return self._streams[i]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.flat()]})"


class NamedSharding:
    """A mesh and the PartitionSpec of one leaf on it."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    def slices(self, shape: Sequence[int], i: int) -> Tuple[slice, ...]:
        """The index of shard i's block of a leaf of ``shape``."""
        coords = dict(zip(self.mesh.axis_names, np.unravel_index(i, self.mesh.devices.shape)))
        sizes = self.mesh.shape
        out = []
        for d, n in enumerate(shape):
            ax = self.spec[d] if d < len(self.spec) else None
            if ax is None:
                out.append(slice(None))
            else:
                c, k = int(coords[ax]), sizes[ax]
                out.append(slice(c * n // k, (c + 1) * n // k))
        return tuple(out)


class Placed:
    """A leaf placed on a mesh: one tensor per mesh entry (``shards``), the
    block its entry owns under ``sharding.spec``. ``shape`` and ``dtype`` are
    the whole leaf's."""

    __slots__ = ("sharding", "shape", "dtype", "shards")

    def __init__(self, sharding: NamedSharding, shape, dtype, shards: Sequence[torch.Tensor]):
        self.sharding = sharding
        self.shape = tuple(shape)
        self.dtype = dtype
        self.shards = list(shards)

    @property
    def spec(self) -> PartitionSpec:
        return self.sharding.spec

    def full(self) -> torch.Tensor:
        """The whole leaf on the CPU, assembled from the shards (tests)."""
        out = torch.empty(self.shape, dtype=self.dtype)
        for i, t in enumerate(self.shards):
            out[self.sharding.slices(self.shape, i)] = t.cpu()
        return out


def device_put(arr, sharding: NamedSharding) -> Placed:
    """Place ``arr`` (a numpy array or a tensor) by ``sharding``: a copy of
    each shard's block on that shard's device."""
    t = arr if torch.is_tensor(arr) else torch.from_numpy(np.ascontiguousarray(arr))
    shards = []
    for i, dev in enumerate(sharding.mesh.flat()):
        block = t[sharding.slices(t.shape, i)]
        shards.append(block.to(dev, copy=True).contiguous())
    return Placed(sharding, t.shape, t.dtype, shards)


def _fit_spec_to_mesh(mesh: Mesh, spec: PartitionSpec, shape: Sequence[int]) -> PartitionSpec:
    """Drop sharded axes a leaf cannot honor: a dim that does not divide its
    mesh axis evenly (or an axis of size 1) replicates instead."""
    sizes = mesh.shape
    out = []
    for i, ax in enumerate(tuple(spec)):
        n = sizes.get(ax, 1)
        if ax is None or n <= 1 or i >= len(shape) or shape[i] % n != 0:
            out.append(None)
        else:
            out.append(ax)
    return P(*out)


def mesh_sharding(
    mesh: Mesh, name: str, shape: Sequence[int], batch: bool = False
) -> NamedSharding:
    """Rule-table sharding for one leaf on a 2D mesh."""
    spec = match_partition_rules(name, shape, batch=batch)
    return NamedSharding(mesh, _fit_spec_to_mesh(mesh, spec, shape))


def is_mesh2d(mesh) -> bool:
    """True when ``mesh`` is the 2D meshed-tier (options x fleet) mesh."""
    return mesh is not None and OPTIONS_AXIS in getattr(mesh, "axis_names", ())


def device_count() -> int:
    """Distinct cards visible to this process (0 without CUDA)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def parse_mesh_shape(
    value: Optional[str], n_devices: Optional[int] = None
) -> Optional[Tuple[int, int]]:
    """Resolve the ``mesh_shape`` setting to an ``(options, fleet)`` tuple.

    ``"auto"`` splits the local cards: all of them on the option axis below
    4, a fleet axis of 2 from 4 up. An explicit ``"OxF"`` is taken verbatim.
    None when fewer than 2 distinct cards are visible: the meshed tier is
    multi-device, and one card keeps the meshless path (logical shards of one
    card are built explicitly, ``make_mesh2d(shape, devices=...)``)."""
    if n_devices is None:
        n_devices = device_count()
    if n_devices < 2:
        return None
    if value is None or value == "auto":
        f = 2 if n_devices >= 4 else 1
        return (n_devices // f, f)
    o, _, f = value.partition("x")
    shape = (int(o), int(f))
    if shape[0] < 1 or shape[1] < 1 or shape[0] * shape[1] < 2:
        return None
    return shape


def _devices(devices) -> list:
    if devices is not None:
        return [torch.device(d) for d in devices]
    return [torch.device("cuda", i) for i in range(device_count())]


def make_mesh2d(shape: Tuple[int, int], devices=None) -> Mesh:
    """The 2D meshed-tier mesh: ``shape = (options, fleet)`` entries of
    ``devices`` (default: every visible card), which may repeat a device."""
    devs = _devices(devices)
    o, f = shape
    if o * f > len(devs):
        raise ValueError(f"mesh shape {o}x{f} needs {o * f} devices, have {len(devs)}")
    arr = np.empty((o, f), dtype=object)
    for i, d in enumerate(devs[: o * f]):
        arr[i // f, i % f] = d
    return Mesh(arr, (OPTIONS_AXIS, FLEET_AXIS))


def mesh_axes_label(mesh: Mesh) -> str:
    """``"4x2"``-style axes label for metrics and stats."""
    sizes = mesh.shape
    return f"{sizes.get(OPTIONS_AXIS, 1)}x{sizes.get(FLEET_AXIS, 1)}"


_MEMBER_NAMES = ("orders", "alphas", "looks", "rsvs", "swaps")


def _as_tensor(x):
    return x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def shard_problem2d(mesh: Mesh, inputs, *member_arrays):
    """Place a single (B=1) problem onto the 2D mesh per the rule table."""
    fields = type(inputs)._fields
    placed = type(inputs)(*[
        device_put(_as_tensor(getattr(inputs, f)),
                   mesh_sharding(mesh, f, np.shape(getattr(inputs, f))))
        for f in fields
    ])
    members = tuple(
        device_put(_as_tensor(a), mesh_sharding(mesh, n, np.shape(a)))
        for n, a in zip(_MEMBER_NAMES, member_arrays)
    )
    return (placed,) + members


def shard_superproblem(mesh: Mesh, b: int, inputs, *member_arrays):
    """Place a stacked superproblem (leading batch axis ``b``) onto the 2D
    mesh: batch rows split over ``fleet``, option columns over ``options``,
    per the rule table."""
    fields = type(inputs)._fields
    placed = type(inputs)(*[
        device_put(_as_tensor(getattr(inputs, f)),
                   mesh_sharding(mesh, f, np.shape(getattr(inputs, f)), batch=True))
        for f in fields
    ])
    members = tuple(
        device_put(_as_tensor(a), mesh_sharding(mesh, n, np.shape(a), batch=True))
        for n, a in zip(_MEMBER_NAMES, member_arrays)
    )
    return (placed,) + members


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """The 1D portfolio mesh over the first ``n_devices`` entries of
    ``devices`` (default: every visible card), which may repeat a device."""
    devs = _devices(devices)
    n = n_devices or len(devs)
    if len(devs) < n:
        raise ValueError(f"need {n} devices, have {len(devs)}")
    arr = np.empty((n,), dtype=object)
    for i, d in enumerate(devs[:n]):
        arr[i] = d
    return Mesh(arr, (PORTFOLIO_AXIS,))


def shard_portfolio(mesh: Mesh, inputs, orders, alphas, looks, rsvs, swaps):
    """Place portfolio members across the mesh; problem tensors replicate.
    K must divide by the mesh size (``round_up_portfolio``)."""
    member = NamedSharding(mesh, P(PORTFOLIO_AXIS))
    replicated = NamedSharding(mesh, P())
    placed = type(inputs)(*[device_put(_as_tensor(x), replicated) for x in inputs])
    return (placed,) + tuple(
        device_put(_as_tensor(a), member) for a in (orders, alphas, looks, rsvs, swaps)
    )


def round_up_portfolio(k: int, mesh: Optional[Mesh]) -> int:
    # the 2D meshed tier replicates the member arrays (its parallel axis is
    # the option axis, not K), so no rounding applies there
    if mesh is None or is_mesh2d(mesh):
        return k
    d = mesh.size
    return ((k + d - 1) // d) * d


def shard_aligned_options(o_bucket: int, mesh: Optional[Mesh]) -> int:
    """Shard-aligned option padding: the padded O bucket must divide the
    ``options`` axis evenly or the rule table degrades that leaf to
    replication."""
    if not is_mesh2d(mesh):
        return o_bucket
    n = mesh.shape.get(OPTIONS_AXIS, 1)
    return math.lcm(o_bucket, max(n, 1))


def fleet_shardings(mesh: Mesh, b: int) -> Tuple[NamedSharding, NamedSharding]:
    """Shardings for a fleet dispatch on the 1D mesh (B same-bucket problems
    stacked along a leading batch axis): the batch axis shards across the
    mesh when B divides the mesh size, else everything replicates. Returns
    ``(member, replicated)``; for a fleet both roles share one placement."""
    if b % mesh.size == 0:
        s = NamedSharding(mesh, P(PORTFOLIO_AXIS))
        return s, s
    r = NamedSharding(mesh, P())
    return r, r


def shard_fleet(mesh: Mesh, b: int, inputs, *member_arrays):
    """Place stacked fleet inputs (a PackInputs of ``[b, ...]`` leaves plus
    the member arrays) onto the 1D mesh per ``fleet_shardings``."""
    member, _ = fleet_shardings(mesh, b)
    placed = type(inputs)(*[device_put(_as_tensor(x), member) for x in inputs])
    return (placed,) + tuple(device_put(_as_tensor(a), member) for a in member_arrays)
