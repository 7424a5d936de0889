"""InstanceType / Offering model and node-overhead math.

Rebuilds the reference's instance-type surface
(upstream ``pkg/providers/instancetype/types.go``):

* ``InstanceType{name, requirements, offerings, capacity, overhead}`` (types.go:50-65)
* capacity vector cpu/memory(-VM overhead)/ephemeral-storage/pods/accelerators
  (types.go:133-147)
* overhead = kube-reserved (stepped CPU %, 11MiB/pod + 255MiB) + system-reserved +
  eviction threshold (types.go:241-324)
* ENI-limited pod density ``ENIs*(IPs-1)+2`` (types.go:237-239)
* ~20 well-known requirement labels (types.go:67-122)

Overhead math is table-driven and golden-tested (tests/test_instancetype.py) because
packing-efficiency numbers are meaningless if allocatable is wrong (SURVEY §7.3).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from ..api import labels as wk
from ..api.objects import KubeletConfiguration
from ..api.requirements import Requirement, Requirements
from ..api.resources import CPU, EPHEMERAL_STORAGE, MEMORY, PODS, Resources, parse_quantity

MIB = 1024.0**2
GIB = 1024.0**3


@dataclass(frozen=True)
class Offering:
    """One purchasable (zone, capacity-type) combination of an instance type.

    Reference: cloudprovider.Offering built per zone x capacity-type x price x
    availability (upstream pkg/providers/instancetype/instancetype.go:120-148).

    ``interruption_probability`` is the risk axis of the capacity pool this
    offering draws from: the provider stamps it from the interruption-risk
    cache (utils/riskcache.py) the same way ``available`` bakes in the ICE
    mask, so the estimate rides the seqnum-cached instance-type lists and
    the flight recorder captures it per round. 0.0 (the on-demand/disabled
    value) keeps legacy constructions and problem digests unchanged.

    ``slice_pod``/``slice_coord`` are the TPU slice-topology axis
    (solver/topology.py): the ICI domain ("TPU pod") this offering's chips
    belong to and the torus (x, y, z) coordinate inside it. Both are sparse —
    empty/None for every non-slice offering, so legacy catalogs, wire
    capsules and problem digests are byte-identical — and both ride the
    launched node as ``karpenter.tpu/slice-*`` labels.
    """

    zone: str
    capacity_type: str
    price: float
    available: bool = True
    interruption_probability: float = 0.0
    slice_pod: str = ""
    slice_coord: Optional[Tuple[int, int, int]] = None

    def pool_key(self, instance_type_name: str) -> "CapacityPool":
        return (instance_type_name, self.zone, self.capacity_type)


#: one capacity pool: the (instance_type, zone, capacity_type) triple that
#: shares a price feed, an ICE mask and an interruption-risk estimate
CapacityPool = tuple


@dataclass(frozen=True)
class Overhead:
    kube_reserved: Resources = field(default_factory=Resources)
    system_reserved: Resources = field(default_factory=Resources)
    eviction_threshold: Resources = field(default_factory=Resources)

    def total(self) -> Resources:
        return self.kube_reserved + self.system_reserved + self.eviction_threshold


@dataclass
class InstanceType:
    name: str
    requirements: Requirements
    offerings: List[Offering]
    capacity: Resources
    overhead: Overhead = field(default_factory=Overhead)

    def allocatable(self) -> Resources:
        return (self.capacity - self.overhead.total()).clamp_min_zero()

    def available_offerings(self) -> List[Offering]:
        return [o for o in self.offerings if o.available]

    def cheapest_price(self, zones: Optional[Sequence[str]] = None,
                       capacity_types: Optional[Sequence[str]] = None) -> Optional[float]:
        prices = [
            o.price
            for o in self.offerings
            if o.available
            and (zones is None or o.zone in zones)
            and (capacity_types is None or o.capacity_type in capacity_types)
        ]
        return min(prices) if prices else None

    def with_offerings(self, offerings: List[Offering]) -> "InstanceType":
        return replace(self, offerings=offerings)


# ---------------------------------------------------------------------------
# Pod-density / overhead formulas (reference types.go:237-324)
# ---------------------------------------------------------------------------

def eni_limited_pods(enis: int, ipv4_per_eni: int) -> int:
    """ENI-limited pod density: ENIs*(IPs-1)+2 (types.go:237-239)."""
    return enis * (ipv4_per_eni - 1) + 2


def pods_capacity(
    enis: int,
    ipv4_per_eni: int,
    cpu_cores: float,
    kubelet: Optional[KubeletConfiguration] = None,
    eni_limited_density: bool = True,
) -> int:
    """Max pods for a node (types.go:133-147 'pods' resource resolution).

    Priority: kubelet.maxPods override > ENI-limited formula (when enabled) > 110;
    then podsPerCore caps it when set (types.go:344-352).
    """
    kubelet = kubelet or KubeletConfiguration()
    if kubelet.max_pods is not None:
        count = kubelet.max_pods
    elif eni_limited_density:
        count = eni_limited_pods(enis, ipv4_per_eni)
    else:
        count = 110
    if kubelet.pods_per_core:
        count = min(count, int(kubelet.pods_per_core * math.ceil(cpu_cores)))
    return max(count, 0)


def kube_reserved(
    cpu_cores: float, pods: int, kubelet: Optional[KubeletConfiguration] = None
) -> Resources:
    """Kube-reserved defaults (types.go:254-288), overridable via kubelet config.

    CPU: stepped fractions of cores — 6% of the first core, 1% of the second,
    0.5% of cores 3-4, 0.25% of anything above 4.
    Memory: 255MiB + 11MiB per pod.  Ephemeral storage: 1Gi.
    """
    kubelet = kubelet or KubeletConfiguration()
    cpu_m = 0.0
    remaining = cpu_cores
    for step_cores, fraction in ((1.0, 0.06), (1.0, 0.01), (2.0, 0.005), (math.inf, 0.0025)):
        take = min(remaining, step_cores)
        if take <= 0:
            break
        cpu_m += take * fraction
        remaining -= take
    defaults = Resources(
        {CPU: cpu_m, MEMORY: (255 + 11 * pods) * MIB, EPHEMERAL_STORAGE: GIB}
    )
    if kubelet.kube_reserved is not None:
        merged = defaults.to_dict()
        merged.update(kubelet.kube_reserved.to_dict())
        return Resources(merged)
    return defaults


def system_reserved(kubelet: Optional[KubeletConfiguration] = None) -> Resources:
    """System-reserved: empty by default, fully user-specified (types.go:241-252)."""
    kubelet = kubelet or KubeletConfiguration()
    return kubelet.system_reserved or Resources()


def _parse_threshold(value: str, capacity: float) -> float:
    value = value.strip()
    if value.endswith("%"):
        return capacity * float(value[:-1]) / 100.0
    return parse_quantity(value)


def eviction_threshold(
    memory_capacity: float,
    storage_capacity: float,
    kubelet: Optional[KubeletConfiguration] = None,
) -> Resources:
    """Eviction threshold (types.go:290-324): default memory.available=100Mi and
    nodefs.available=10%; hard and soft thresholds combine by max; percentage
    values resolve against capacity."""
    kubelet = kubelet or KubeletConfiguration()
    signals = {"memory.available": "100Mi", "nodefs.available": "10%"}
    out: Dict[str, float] = {}
    for signal, default in signals.items():
        cap = memory_capacity if signal == "memory.available" else storage_capacity
        overrides = [
            source[signal]
            for source in (kubelet.eviction_soft, kubelet.eviction_hard)
            if signal in source
        ]
        # Hard and soft thresholds combine by max; defaults apply when unset.
        values = overrides or [default]
        out[signal] = max(_parse_threshold(v, cap) for v in values)
    return Resources({MEMORY: out["memory.available"], EPHEMERAL_STORAGE: out["nodefs.available"]})


def compute_overhead(
    cpu_cores: float,
    memory_capacity: float,
    storage_capacity: float,
    pods: int,
    kubelet: Optional[KubeletConfiguration] = None,
) -> Overhead:
    return Overhead(
        kube_reserved=kube_reserved(cpu_cores, pods, kubelet),
        system_reserved=system_reserved(kubelet),
        eviction_threshold=eviction_threshold(memory_capacity, storage_capacity, kubelet),
    )


# ---------------------------------------------------------------------------
# Requirement-label construction (types.go:67-122)
# ---------------------------------------------------------------------------

def instance_type_requirements(
    name: str,
    *,
    arch: str = "amd64",
    os: str = "linux",
    zones: Sequence[str] = (),
    capacity_types: Sequence[str] = (wk.CAPACITY_TYPE_ON_DEMAND,),
    category: str = "",
    family: str = "",
    generation: str = "",
    size: str = "",
    cpu_cores: int = 0,
    memory_mib: int = 0,
    pods: int = 0,
    network_bandwidth_mbps: int = 0,
    accelerator_name: str = "",
    accelerator_count: int = 0,
    accelerator_memory_mib: int = 0,
    local_nvme_gib: int = 0,
    hypervisor: str = "nitro",
    extra: Mapping[str, str] | None = None,
) -> Requirements:
    """Build the well-known requirement set every instance type exposes.

    Mirrors computeRequirements (upstream pkg/providers/instancetype/
    types.go:67-122): one In-requirement per well-known label so pod nodeSelectors,
    Gt/Lt numeric constraints, and provisioner requirements all intersect against it.
    """
    reqs = [
        Requirement.in_values(wk.INSTANCE_TYPE, [name]),
        Requirement.in_values(wk.ARCH, [arch]),
        Requirement.in_values(wk.OS, [os]),
        Requirement.in_values(wk.ZONE, list(zones)),
        Requirement.in_values(wk.CAPACITY_TYPE, list(capacity_types)),
    ]
    def add(key: str, value) -> None:
        if value:
            reqs.append(Requirement.in_values(key, [str(value)]))

    add(wk.INSTANCE_CATEGORY, category)
    add(wk.INSTANCE_FAMILY, family)
    add(wk.INSTANCE_GENERATION, generation)
    add(wk.INSTANCE_SIZE, size)
    add(wk.INSTANCE_CPU, cpu_cores)
    add(wk.INSTANCE_MEMORY, memory_mib)
    add(wk.INSTANCE_PODS, pods)
    add(wk.INSTANCE_NETWORK_BANDWIDTH, network_bandwidth_mbps)
    add(wk.INSTANCE_ACCELERATOR_NAME, accelerator_name)
    add(wk.INSTANCE_ACCELERATOR_COUNT, accelerator_count)
    add(wk.INSTANCE_GPU_MEMORY, accelerator_memory_mib)
    add(wk.INSTANCE_LOCAL_NVME, local_nvme_gib)
    add(wk.INSTANCE_HYPERVISOR, hypervisor)
    for k, v in (extra or {}).items():
        reqs.append(Requirement.in_values(k, [v]))
    return Requirements(reqs)
