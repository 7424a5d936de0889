"""The instance-type catalog as plain records.

A frozen copy of ``karpenter_tpu_torch/cloudprovider/catalog.py:43-272``
(``generate_catalog`` with the default kubelet, ``make_instance_type``,
``_jitter``, ``_network_spec``) and of the overhead formulas in
``karpenter_tpu_torch/cloudprovider/types.py:189-297`` (``eni_limited_pods``,
``pods_capacity``, ``kube_reserved``, ``eviction_threshold``). Each record
holds the numbers a node of the type offers: capacity, the reserved
overhead, and one price per (zone, capacity type). The adapter hands these
numbers to the program, and the reference checks plans against them.
"""

from __future__ import annotations

import hashlib
import math

MIB = 1024.0**2
GIB = 1024.0**3
ON_DEMAND, SPOT = "on-demand", "spot"
ZONES = ("zone-a", "zone-b", "zone-c")

SIZES = {
    "small": 1, "medium": 2, "large": 4, "xlarge": 8, "2xlarge": 16, "3xlarge": 24,
    "4xlarge": 32, "6xlarge": 48, "8xlarge": 64, "12xlarge": 96, "16xlarge": 128,
    "24xlarge": 192, "32xlarge": 256,
}
# category -> (GiB memory per vCPU, $ per vCPU-hour base)
CATEGORIES = {
    "c": (2.0, 0.044), "m": (4.0, 0.050), "r": (8.0, 0.062), "d": (4.0, 0.058),
    "i": (8.0, 0.069), "h": (2.0, 0.048), "x": (16.0, 0.086), "t": (4.0, 0.042),
}
GENERATIONS = ("4", "5", "6", "7")
# accelerator types: name -> (chips, vcpus, memory GiB, $/h on-demand)
ACCEL = {
    "tpu-v5e.1chip": (1, 24, 48.0, 1.20),
    "tpu-v5e.4chip": (4, 112, 192.0, 4.80),
    "tpu-v5e.8chip": (8, 224, 384.0, 9.60),
    "tpu-v5p.1chip": (1, 28, 64.0, 2.10),
    "tpu-v5p.4chip": (4, 120, 256.0, 8.40),
}
VM_MEMORY_OVERHEAD = 0.075


def jitter(name: str, zone: str, lo: float, hi: float) -> float:
    h = int(hashlib.sha256(f"{name}/{zone}".encode()).hexdigest()[:8], 16)
    return lo + (hi - lo) * (h / 0xFFFFFFFF)


def kube_reserved(cpu_cores: float, pods: int) -> dict:
    cpu, remaining = 0.0, cpu_cores
    for step, fraction in ((1.0, 0.06), (1.0, 0.01), (2.0, 0.005), (math.inf, 0.0025)):
        take = min(remaining, step)
        if take <= 0:
            break
        cpu += take * fraction
        remaining -= take
    return {"cpu": cpu, "memory": (255 + 11 * pods) * MIB, "ephemeral-storage": GIB}


def record(name, category, generation, size, vcpus, memory_gib, od_price, zones,
           accelerator="", accelerator_count=0, local_nvme_gib=0) -> dict:
    enis = min(15, 2 + vcpus // 8)
    ips = min(50, 4 + 3 * enis)
    bandwidth = min(100_000, 750 * vcpus)
    pods = enis * (ips - 1) + 2
    memory = memory_gib * GIB * (1.0 - VM_MEMORY_OVERHEAD)
    storage = (local_nvme_gib or 20) * GIB
    capacity = {"cpu": float(vcpus), "memory": memory, "ephemeral-storage": storage,
                "pods": float(pods)}
    if accelerator:
        key = "google.com/tpu" if accelerator.startswith("tpu") else "nvidia.com/gpu"
        capacity[key] = float(accelerator_count)
    offerings = []
    for zone in zones:
        offerings.append((zone, ON_DEMAND, od_price))
        offerings.append((zone, SPOT, od_price * jitter(name, zone, 0.25, 0.40)))
    return dict(
        name=name, category=category, generation=generation, size=size, vcpus=vcpus,
        memory_mib=int(memory_gib * 1024), pods=pods, bandwidth=bandwidth,
        accelerator=accelerator, accelerator_count=accelerator_count,
        local_nvme_gib=local_nvme_gib, capacity=capacity,
        kube_reserved=kube_reserved(float(vcpus), pods),
        eviction={"memory": 100 * MIB, "ephemeral-storage": storage * 10 / 100.0},
        offerings=offerings,
    )


def catalog(n_types: int, zones=ZONES) -> list:
    """``generate_catalog(n_types)``'s types, in its order, as records."""
    out = []
    for gen in GENERATIONS:
        discount = 1.0 - 0.04 * (int(gen) - 5)
        for cat, (gib_per_vcpu, base) in CATEGORIES.items():
            for size, vcpus in SIZES.items():
                if cat == "t" and vcpus > 8:
                    continue
                mem = gib_per_vcpu * vcpus
                price = (base * vcpus + 0.004 * mem) * discount
                nvme = vcpus * 75 if cat == "d" else (vcpus * 120 if cat == "i" else 0)
                out.append(record(f"{cat}{gen}.{size}", cat, gen, size, vcpus, mem,
                                  round(price, 5), zones, local_nvme_gib=nvme))
    for name, (chips, vcpus, mem, price) in ACCEL.items():
        out.append(record(name, "tpu", "5", name.split(".")[1], vcpus, mem, price, zones,
                          accelerator=name.split(".")[0], accelerator_count=chips))
    if n_types < len(out):
        ranked = sorted(out, key=lambda r: (r["capacity"]["cpu"], r["name"]))
        if n_types == 1:
            return [ranked[0]]
        step = (len(ranked) - 1) / (n_types - 1)
        out = [ranked[round(i * step)] for i in range(n_types)]
    return out


def allocatable(rec: dict, axes=("cpu", "memory", "pods")) -> list:
    """Capacity less the reserved overhead, per axis, never below 0."""
    return [max(rec["capacity"].get(a, 0.0) - rec["kube_reserved"].get(a, 0.0)
                - rec["eviction"].get(a, 0.0), 0.0) for a in axes]
