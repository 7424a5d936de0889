"""PodScraper: pod-state gauge + schedulable-latency histogram.

Reference: karpenter-core's pod metrics controller maintains
``karpenter_pods_state`` (phase/owner/provisioner breakdown) and the
scheduling-latency signal cost-efficiency work reads (designs/metrics.md).
"""

from __future__ import annotations

import time
from typing import Dict, Set

from ...api.objects import Pod
from ...utils import metrics


class PodScraper:
    """Scrapes pods into ``karpenter_tpu_pods_state`` and observes
    pod-created -> bound latency from cluster watch events.

    Latency is event-driven rather than scraped: a poll can miss a pod that
    binds and is deleted between passes, and would observe the same bind
    repeatedly. The watch fires exactly once per transition (keyed by object
    uid, so a recreated same-name pod counts again).
    """

    name = "metrics.pod"

    def __init__(self, cluster, clock: "callable" = time.time):
        self.cluster = cluster
        self._clock = clock
        self._bound_seen: Set[str] = set()
        cluster.watch(self._on_event)

    # -- watch: schedulable latency -----------------------------------------
    def _on_event(self, event: str, obj) -> None:
        if not isinstance(obj, Pod):
            return
        if event == "DELETED":
            self._bound_seen.discard(obj.meta.uid)
            return
        if obj.node_name is None or obj.meta.uid in self._bound_seen:
            return
        self._bound_seen.add(obj.meta.uid)
        latency = max(0.0, self._clock() - obj.meta.creation_timestamp)
        node = self.cluster.nodes.get(obj.node_name)
        provisioner = (node.provisioner_name() or "") if node is not None else ""
        metrics.POD_SCHEDULE_LATENCY.observe(latency, {"provisioner": provisioner})

    # -- scrape: pod state breakdown ----------------------------------------
    def scrape(self) -> int:
        with metrics.STATE_SCRAPE_DURATION.time({"scraper": "pod"}):
            snap = self.cluster.state_snapshot()
            node_prov = {n.name: n.provisioner_name() or "" for n in snap.nodes}
            counts: Dict[tuple, int] = {}
            for pod in snap.pods:
                key = (
                    pod.phase,
                    pod.meta.owner_kind or "",
                    node_prov.get(pod.node_name, "") if pod.node_name else "",
                )
                counts[key] = counts.get(key, 0) + 1
            # one atomic swap: a concurrent exposition sees the old view or
            # the new one, never a half-built breakdown
            metrics.PODS_STATE.replace_series({
                metrics.series_key(
                    {"phase": phase, "owner": owner, "provisioner": provisioner}
                ): float(n)
                for (phase, owner, provisioner), n in counts.items()
            })
            return len(snap.pods)

    reconcile = scrape
