"""Synthetic instance-type catalog generator.

Plays the role of the reference's generated DescribeInstanceTypes dataset
(upstream ``pkg/fake/zz_generated.describe_instance_types.go``) plus the
static fallback price tables (``zz_generated.pricing.go``): a deterministic,
parameterizable universe of instance types × zones × capacity types the fake
provider and the benchmarks draw from.

Shapes mirror real cloud fleets: CPU categories at 2/4/8 GiB-per-vCPU ratios across
generations and sizes, storage-dense types with local NVMe, and TPU accelerator
types. On-demand prices are uniform across zones; spot prices vary by zone, sitting
at roughly 30% of on-demand (as in the reference's spot-vs-OD ordering logic,
upstream ``pkg/providers/instance/instance.go:486-508``).
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence

from ..api import labels as wk
from ..api.objects import KubeletConfiguration
from ..api.resources import (
    CPU,
    EPHEMERAL_STORAGE,
    GPU_NVIDIA,
    GPU_TPU,
    MEMORY,
    PODS,
    Resources,
)
from .types import (
    GIB,
    MIB,
    InstanceType,
    Offering,
    compute_overhead,
    instance_type_requirements,
    pods_capacity,
)

DEFAULT_ZONES = ("zone-a", "zone-b", "zone-c")

# size-name -> vCPU count
_SIZES = {
    "small": 1,
    "medium": 2,
    "large": 4,
    "xlarge": 8,
    "2xlarge": 16,
    "3xlarge": 24,
    "4xlarge": 32,
    "6xlarge": 48,
    "8xlarge": 64,
    "12xlarge": 96,
    "16xlarge": 128,
    "24xlarge": 192,
    "32xlarge": 256,
}

# category -> (GiB memory per vCPU, $ per vCPU-hour base)
_CATEGORIES = {
    "c": (2.0, 0.044),   # compute-optimized
    "m": (4.0, 0.050),   # general purpose
    "r": (8.0, 0.062),   # memory-optimized
    "d": (4.0, 0.058),   # storage-dense (local NVMe)
    "i": (8.0, 0.069),   # storage+memory (large local NVMe)
    "h": (2.0, 0.048),   # hpc, high bandwidth
    "x": (16.0, 0.086),  # extreme memory
    "t": (4.0, 0.042),   # burstable
}

_GENERATIONS = ("4", "5", "6", "7")

# TPU accelerator types: name -> (chips, vcpus, mem GiB, $/h on-demand)
_ACCEL = {
    "tpu-v5e.1chip": (1, 24, 48.0, 1.20),
    "tpu-v5e.4chip": (4, 112, 192.0, 4.80),
    "tpu-v5e.8chip": (8, 224, 384.0, 9.60),
    "tpu-v5p.1chip": (1, 28, 64.0, 2.10),
    "tpu-v5p.4chip": (4, 120, 256.0, 8.40),
}


def _jitter(name: str, zone: str, lo: float, hi: float) -> float:
    """Deterministic pseudo-random factor in [lo, hi] keyed on (name, zone)."""
    h = int(hashlib.sha256(f"{name}/{zone}".encode()).hexdigest()[:8], 16)
    return lo + (hi - lo) * (h / 0xFFFFFFFF)


def _network_spec(vcpus: int) -> tuple:
    """(ENIs, IPv4-per-ENI, bandwidth Mbps) — smooth stand-in for the reference's
    generated vpc-limits table (zz_generated.vpclimits.go)."""
    enis = min(15, 2 + vcpus // 8)
    ips = min(50, 4 + 3 * enis)
    bandwidth = min(100_000, 750 * vcpus)
    return enis, ips, bandwidth


def make_instance_type(
    name: str,
    category: str,
    generation: str,
    size: str,
    vcpus: int,
    memory_gib: float,
    od_price: float,
    zones: Sequence[str],
    *,
    accelerator: str = "",
    accelerator_count: int = 0,
    local_nvme_gib: int = 0,
    kubelet: Optional[KubeletConfiguration] = None,
    vm_memory_overhead_percent: float = 0.075,
    spot: bool = True,
    arch: str = "amd64",
) -> InstanceType:
    enis, ips, bandwidth = _network_spec(vcpus)
    pods = pods_capacity(enis, ips, vcpus, kubelet)
    # VM overhead haircut on memory, as the reference applies at capacity
    # construction (upstream pkg/providers/instancetype/types.go:133-147
    # with vmMemoryOverheadPercent from settings).
    memory_bytes = memory_gib * GIB * (1.0 - vm_memory_overhead_percent)
    storage_bytes = (local_nvme_gib or 20) * GIB
    capacity = {
        CPU: float(vcpus),
        MEMORY: memory_bytes,
        EPHEMERAL_STORAGE: storage_bytes,
        PODS: float(pods),
    }
    if accelerator:
        capacity[GPU_TPU if accelerator.startswith("tpu") else GPU_NVIDIA] = float(
            accelerator_count
        )
    offerings: List[Offering] = []
    for zone in zones:
        offerings.append(Offering(zone=zone, capacity_type=wk.CAPACITY_TYPE_ON_DEMAND, price=od_price))
        if spot:
            spot_price = od_price * _jitter(name, zone, 0.25, 0.40)
            offerings.append(
                Offering(zone=zone, capacity_type=wk.CAPACITY_TYPE_SPOT, price=spot_price)
            )
    requirements = instance_type_requirements(
        name,
        arch=arch,
        zones=list(zones),
        capacity_types=[wk.CAPACITY_TYPE_ON_DEMAND] + ([wk.CAPACITY_TYPE_SPOT] if spot else []),
        category=category,
        family=f"{category}{generation}",
        generation=generation,
        size=size,
        cpu_cores=vcpus,
        memory_mib=int(memory_gib * 1024),
        pods=pods,
        network_bandwidth_mbps=bandwidth,
        accelerator_name=accelerator,
        accelerator_count=accelerator_count,
        local_nvme_gib=local_nvme_gib,
    )
    return InstanceType(
        name=name,
        requirements=requirements,
        offerings=offerings,
        capacity=Resources(capacity),
        overhead=compute_overhead(vcpus, memory_bytes, storage_bytes, pods, kubelet),
    )


def _accelerator_types(
    zones: Sequence[str], kubelet: Optional[KubeletConfiguration] = None
) -> List[InstanceType]:
    return [
        make_instance_type(
            name,
            "tpu",
            "5",
            name.split(".")[1],
            vcpus,
            mem,
            price,
            zones,
            accelerator=name.split(".")[0],
            accelerator_count=chips,
            kubelet=kubelet,
        )
        for name, (chips, vcpus, mem, price) in _ACCEL.items()
    ]


_catalog_cache: Dict[tuple, List[InstanceType]] = {}


def generate_catalog(
    n_types: Optional[int] = None,
    zones: Sequence[str] = DEFAULT_ZONES,
    kubelet: Optional[KubeletConfiguration] = None,
    include_accelerators: bool = True,
    slice_topology: bool = False,
) -> List[InstanceType]:
    """Deterministic catalog; ``n_types`` samples evenly across the size spectrum
    so a truncated catalog still spans small through large types.

    The output is memoized per parameter set (default kubelet only): this is
    static data, and serving the SAME InstanceType objects across calls is
    what a production types provider does (the reference's seqnum-keyed cache,
    ``pkg/providers/instancetype/instancetype.go:95-107``) — it lets the
    encoder's identity-validated caches short-circuit. Callers get a fresh
    list (shallow copy) so list-level mutation can't leak between them."""
    cache_key = None
    if kubelet is None:
        cache_key = (n_types, tuple(zones), include_accelerators, slice_topology)
        hit = _catalog_cache.get(cache_key)
        if hit is not None:
            return list(hit)
    out: List[InstanceType] = []
    for gen in _GENERATIONS:
        gen_discount = 1.0 - 0.04 * (int(gen) - 5)  # newer generations slightly cheaper
        for cat, (gib_per_vcpu, base) in _CATEGORIES.items():
            for size, vcpus in _SIZES.items():
                if cat == "t" and vcpus > 8:
                    continue  # burstable caps out small
                mem = gib_per_vcpu * vcpus
                price = (base * vcpus + 0.004 * mem) * gen_discount
                nvme = vcpus * 75 if cat == "d" else (vcpus * 120 if cat == "i" else 0)
                out.append(
                    make_instance_type(
                        f"{cat}{gen}.{size}",
                        cat,
                        gen,
                        size,
                        vcpus,
                        mem,
                        round(price, 5),
                        zones,
                        local_nvme_gib=nvme,
                        kubelet=kubelet,
                    )
                )
    if include_accelerators:
        out.extend(_accelerator_types(zones, kubelet))
    if n_types is not None and n_types < len(out):
        # Sample evenly across the size spectrum so a truncated catalog still
        # spans small through large types (not just the N smallest).
        ranked = sorted(out, key=lambda it: (it.capacity[CPU], it.name))
        if n_types == 1:
            out = [ranked[0]]
        else:
            # step > 1 under the n_types < len(out) guard, so indices are distinct
            step = (len(ranked) - 1) / (n_types - 1)
            out = [ranked[round(i * step)] for i in range(n_types)]
    if slice_topology:
        # ICI-coordinate offerings for the TPU types (solver/topology.py):
        # each accelerator (zone, ct) offering expands into per-(domain,
        # coordinate) offerings whose slice identity the solver can target.
        # AFTER the n_types sampling (n_types counts TYPES, not offerings),
        # with the accelerator types force-included past the sampling — a
        # sliced catalog without slices would be a silent no-op. An explicit
        # include_accelerators=False still wins: the caller asked for a
        # TPU-less universe, and the expansion is then a deliberate no-op.
        from ..solver.topology import with_slice_topology

        if include_accelerators:
            have = {it.name for it in out}
            out = out + [
                it for it in _accelerator_types(zones, kubelet)
                if it.name not in have
            ]
        out = with_slice_topology(out)
    if cache_key is not None:
        _catalog_cache[cache_key] = out
        return list(out)
    return out


def catalog_by_name(catalog: Sequence[InstanceType]) -> Dict[str, InstanceType]:
    return {it.name: it for it in catalog}
