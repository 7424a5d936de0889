"""Resource quantities and resource-vector arithmetic.

The reference models pod demand and node capacity as ``v1.ResourceList`` maps and
compares them with ``resources.Fits`` (used at
upstream ``pkg/cloudprovider/cloudprovider.go:267-272``). Capacity vectors carry
cpu / memory / ephemeral-storage / pods plus extended accelerator resources
(upstream ``pkg/providers/instancetype/types.go:133-147``).

This module is the TPU-native equivalent: quantities are parsed once at the API edge
into plain floats (millicpu-free: cpu is in cores as float, memory in bytes), so the
solver's tensor encoders can lift them straight into device arrays without string
parsing in any hot path.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterable, Mapping, Union

# Canonical resource names (kubernetes core/v1 names).
CPU = "cpu"
MEMORY = "memory"
EPHEMERAL_STORAGE = "ephemeral-storage"
PODS = "pods"
# Extended resources the framework knows natively. Anything else still works as an
# opaque extended resource; these just get fast-path slots in the solver encoding.
GPU_TPU = "google.com/tpu"
GPU_NVIDIA = "nvidia.com/gpu"
GPU_AMD = "amd.com/gpu"

_SUFFIX = {
    # binary (powers of 1024)
    "Ki": 1024.0,
    "Mi": 1024.0**2,
    "Gi": 1024.0**3,
    "Ti": 1024.0**4,
    "Pi": 1024.0**5,
    "Ei": 1024.0**6,
    # decimal
    "n": 1e-9,
    "u": 1e-6,
    "m": 1e-3,
    "k": 1e3,
    "M": 1e6,
    "G": 1e9,
    "T": 1e12,
    "P": 1e15,
    "E": 1e18,
    "": 1.0,
}

_QTY_RE = re.compile(r"^([+-]?[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)([A-Za-z]{0,2})$")

Quantity = Union[int, float, str]


def parse_quantity(value: Quantity) -> float:
    """Parse a kubernetes resource quantity ('100m', '1536Mi', '2') to a float.

    cpu '100m' -> 0.1 cores; memory '1Gi' -> 1073741824.0 bytes.
    """
    if isinstance(value, (int, float)):
        return float(value)
    s = value.strip()
    m = _QTY_RE.match(s)
    if not m:
        raise ValueError(f"invalid quantity: {value!r}")
    number, suffix = m.groups()
    if suffix not in _SUFFIX:
        raise ValueError(f"invalid quantity suffix: {value!r}")
    return float(number) * _SUFFIX[suffix]


def format_quantity(name: str, value: float) -> str:
    """Human-readable rendering for logs/metrics (not round-trip exact)."""
    if name == MEMORY or name == EPHEMERAL_STORAGE:
        for suffix, mult in (("Gi", 1024.0**3), ("Mi", 1024.0**2), ("Ki", 1024.0)):
            if value >= mult:
                return f"{value / mult:.6g}{suffix}"
        return f"{value:.6g}"
    return f"{value:.6g}"


class Resources:
    """An immutable resource vector: name -> float amount.

    Missing names are zero. Supports +, -, scalar *, max, and ``fits``.
    """

    __slots__ = ("_r", "_hash")

    def __init__(self, quantities: Mapping[str, Quantity] | None = None, **kw: Quantity):
        r: Dict[str, float] = {}
        for src in (quantities or {}), kw:
            for k, v in src.items():
                k = EPHEMERAL_STORAGE if k == "ephemeral_storage" else k
                r[k] = r.get(k, 0.0) + parse_quantity(v)
        # Drop exact zeros so equality/iteration treat absent and zero the same.
        self._r = {k: v for k, v in r.items() if v != 0.0}

    # -- accessors ---------------------------------------------------------
    def get(self, name: str) -> float:
        return self._r.get(name, 0.0)

    def __getitem__(self, name: str) -> float:
        return self._r.get(name, 0.0)

    def keys(self) -> Iterable[str]:
        return self._r.keys()

    def items(self):
        return self._r.items()

    def items_mapping(self):
        """The raw backing dict (read-only by convention) — lets hot paths use
        len()/items() without the method-call-per-item cost."""
        return self._r

    def to_dict(self) -> Dict[str, float]:
        return dict(self._r)

    def is_zero(self) -> bool:
        return not self._r

    # -- arithmetic --------------------------------------------------------
    def __add__(self, other: "Resources") -> "Resources":
        out = dict(self._r)
        for k, v in other._r.items():
            out[k] = out.get(k, 0.0) + v
        return Resources(out)

    def __sub__(self, other: "Resources") -> "Resources":
        out = dict(self._r)
        for k, v in other._r.items():
            out[k] = out.get(k, 0.0) - v
        return Resources(out)

    def __mul__(self, scalar: float) -> "Resources":
        return Resources({k: v * scalar for k, v in self._r.items()})

    __rmul__ = __mul__

    def clamp_min_zero(self) -> "Resources":
        return Resources({k: max(v, 0.0) for k, v in self._r.items()})

    def max(self, other: "Resources") -> "Resources":
        keys = set(self._r) | set(other._r)
        return Resources({k: max(self.get(k), other.get(k)) for k in keys})

    def ceil(self) -> "Resources":
        return Resources({k: math.ceil(v) for k, v in self._r.items()})

    # -- comparisons -------------------------------------------------------
    def fits(self, capacity: "Resources") -> bool:
        """True if every requested amount is <= the capacity's amount.

        Mirrors ``resources.Fits`` used by the reference's instance-type filter
        (upstream ``pkg/cloudprovider/cloudprovider.go:270``).
        """
        return all(v <= capacity.get(k) + 1e-9 for k, v in self._r.items())

    def any_exceeds(self, limit: "Resources") -> bool:
        """True if any amount in self exceeds the corresponding amount in limit,
        for keys that limit defines (used by Provisioner resource limits,
        upstream designs/limits.md)."""
        return any(self.get(k) > v + 1e-9 for k, v in limit.items())

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Resources) and self._r == other._r

    def __hash__(self) -> int:
        h = getattr(self, "_hash", None)
        if h is None:
            h = hash(tuple(sorted(self._r.items())))
            object.__setattr__(self, "_hash", h)
        return h

    def __bool__(self) -> bool:
        return bool(self._r)

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={format_quantity(k, v)}" for k, v in sorted(self._r.items()))
        return f"Resources({inner})"


ZERO = Resources()


def merge(items: Iterable[Resources]) -> Resources:
    out = Resources()
    for it in items:
        out = out + it
    return out
