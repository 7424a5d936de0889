"""NodeScraper: per-node capacity/utilization gauges.

Reference: karpenter-core's node metrics controller maintains
``karpenter_nodes_allocatable``, ``karpenter_nodes_total_pod_requests`` and
friends, labeled by the node's scheduling identity (designs/metrics.md).
"""

from __future__ import annotations

from ...api.objects import Node
from ...api.resources import Resources, merge
from ...utils import metrics


def node_phase(node: Node) -> str:
    """The node's lifecycle phase as a metric label: Terminating beats
    Cordoned beats Ready/NotReady (same precedence the termination flow
    moves a node through)."""
    if node.meta.deletion_timestamp is not None:
        return "Terminating"
    if node.unschedulable:
        return "Cordoned"
    return "Ready" if node.ready else "NotReady"


_POD_SLOT = Resources(pods=1)  # hoisted: one allocation, not one per pod per scrape


class NodeScraper:
    """Scrapes every node into allocatable / requested / utilization gauges."""

    name = "metrics.node"

    def __init__(self, cluster):
        self.cluster = cluster

    def scrape(self) -> int:
        with metrics.STATE_SCRAPE_DURATION.time({"scraper": "node"}):
            snap = self.cluster.state_snapshot()
            by_node = snap.pods_by_node()
            # build the next view off-lock, publish atomically at the end
            # (replace_series): a /metrics exposition concurrent with this
            # loop must never see an empty or half-populated fleet, and the
            # swap also drops series for deleted nodes
            alloc_view, req_view, util_view = {}, {}, {}
            for node in snap.nodes:
                # the per-node series key is built ONCE per resource and
                # shared by all three gauges — this loop is the scrape hot
                # path at fleet scale
                key = metrics.series_key({
                    "node_name": node.name,
                    "provisioner": node.provisioner_name() or "",
                    "zone": node.zone(),
                    "instance_type": node.instance_type(),
                    "capacity_type": node.capacity_type(),
                    "phase": node_phase(node),
                    "resource_type": "",
                })
                slot = next(
                    i for i, (name, _) in enumerate(key) if name == "resource_type"
                )
                requested = merge(
                    [p.requests + _POD_SLOT for p in by_node.get(node.name, ())]
                )
                # iterate the allocatable surface (cpu/memory/pods plus any
                # accelerator extended resources the instance type carries)
                for resource, alloc in node.allocatable.items():
                    series = key[:slot] + (("resource_type", resource),) + key[slot + 1:]
                    req = requested.get(resource)
                    alloc_view[series] = alloc
                    req_view[series] = req
                    if alloc > 0:
                        util_view[series] = req / alloc
            metrics.NODES_ALLOCATABLE.replace_series(alloc_view)
            metrics.NODES_POD_REQUESTS.replace_series(req_view)
            metrics.NODES_UTILIZATION.replace_series(util_view)
            return len(snap.nodes)

    # the operator's controller kit drives scrapers like any reconciler
    reconcile = scrape
