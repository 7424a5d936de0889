"""Builds the program's objects from the benchmark's raw records: one
``Pod`` a pod record, one ``Provisioner`` a cell, one ``InstanceType`` a
catalog record, with the record's capacity, overhead and prices."""

from __future__ import annotations

from karpenter_tpu_torch.api import ObjectMeta, Pod, Provisioner, Resources
from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.cloudprovider.types import (
    InstanceType, Offering, Overhead, instance_type_requirements,
)

POOL_LABEL = "bench.pool"


def instance_type(rec: dict) -> InstanceType:
    zones = sorted({z for z, _, _ in rec["offerings"]})
    cts = [ct for ct in (wk.CAPACITY_TYPE_ON_DEMAND, wk.CAPACITY_TYPE_SPOT)
           if any(o[1] == ct for o in rec["offerings"])]
    reqs = instance_type_requirements(
        rec["name"], zones=zones, capacity_types=cts, category=rec["category"],
        family=f"{rec['category']}{rec['generation']}", generation=rec["generation"],
        size=rec["size"], cpu_cores=rec["vcpus"], memory_mib=rec["memory_mib"],
        pods=rec["pods"], network_bandwidth_mbps=rec["bandwidth"],
        accelerator_name=rec["accelerator"], accelerator_count=rec["accelerator_count"],
        local_nvme_gib=rec["local_nvme_gib"],
    )
    return InstanceType(
        name=rec["name"], requirements=reqs,
        offerings=[Offering(zone=z, capacity_type=ct, price=price)
                   for z, ct, price in rec["offerings"]],
        capacity=Resources(rec["capacity"]),
        overhead=Overhead(kube_reserved=Resources(rec["kube_reserved"]),
                          eviction_threshold=Resources(rec["eviction"])),
    )


class Program:
    """The program's view of one configuration's inputs: the instance
    types, one provisioner a cell, and each cell's live pods, name -> Pod,
    in the order the cell's encode session keeps (old pods, then added)."""

    def __init__(self, inputs):
        self.inputs = inputs
        self.types = [instance_type(r) for r in inputs.records]
        self.requests = [Resources(cpu=c, memory=m) for c, m in inputs.shapes]
        self.provisioners = []
        for c in range(inputs.n_cells):
            if inputs.config["cell_pools"]:
                p = Provisioner(meta=ObjectMeta(name=inputs.pool(c)),
                                labels={POOL_LABEL: f"p{c}"})
                p.meta.resource_version = c + 1
            else:
                p = Provisioner(meta=ObjectMeta(name=inputs.pool(c)))
            self.provisioners.append(p)
        self.pods = []
        for c in range(inputs.n_cells):
            self.pods.append({name: self.pod(c, name, d)
                              for d, names in enumerate(inputs.live[c]) for name in names})

    def pod(self, c: int, name: str, d: int) -> Pod:
        sel = {POOL_LABEL: f"p{c}"} if self.inputs.config["cell_pools"] else {}
        return Pod(meta=ObjectMeta(name=name), requests=self.requests[d], node_selector=sel)

    def provs(self, c: int) -> list:
        return [(self.provisioners[c], self.types)]

    def churn(self, c: int, removed, added) -> tuple:
        """Apply a churn event list to cell ``c``: returns the removed and
        the added ``Pod`` objects, the watch events a session is fed."""
        pods = self.pods[c]
        gone = [pods.pop(name) for name in removed]
        new = [self.pod(c, name, d) for name, d in added]
        pods.update((q.meta.name, q) for q in new)
        return gone, new
