"""ProvisionerScraper: usage vs. limit gauges per provisioner.

Reference: karpenter-core's provisioner metrics controller maintains
``karpenter_provisioner_usage`` / ``karpenter_provisioner_limit``
(designs/metrics.md, designs/limits.md) — the pair an operator alerts on
before scale-up starts failing with LimitExceeded.
"""

from __future__ import annotations

from ...api.resources import Resources
from ...utils import metrics


class ProvisionerScraper:
    """Scrapes each provisioner's capacity footprint against its limits."""

    name = "metrics.provisioner"

    def __init__(self, cluster):
        self.cluster = cluster

    def scrape(self) -> int:
        with metrics.STATE_SCRAPE_DURATION.time({"scraper": "provisioner"}):
            snap = self.cluster.state_snapshot()
            usage = {}
            for node in snap.nodes:
                pname = node.provisioner_name()
                if pname is not None:
                    usage[pname] = usage.get(pname, Resources()) + node.capacity
            usage_view, limit_view = {}, {}
            for prov in snap.provisioners:
                used = usage.get(prov.name, Resources())
                limits = prov.limits
                # emit usage over the union of used and limited resources so
                # a limited-but-unused resource reads 0, not absent — the
                # usage/limit pair must always be joinable
                resources = set(used.keys()) | (set(limits.keys()) if limits else set())
                for resource in resources:
                    series = metrics.series_key(
                        {"provisioner": prov.name, "resource_type": resource}
                    )
                    usage_view[series] = used.get(resource)
                    if limits is not None and limits.get(resource) > 0:
                        limit_view[series] = limits.get(resource)
            # atomic swaps: exposition never catches a half-populated view
            metrics.PROVISIONER_USAGE.replace_series(usage_view)
            metrics.PROVISIONER_LIMIT.replace_series(limit_view)
            return len(snap.provisioners)

    reconcile = scrape
