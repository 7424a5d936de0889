"""State-observability scrapers: periodic cluster-state -> gauge controllers.

The reference devotes an entire controller group to STATE observability —
karpenter-core's ``pkg/controllers/metrics/{pod,node,provisioner}`` scrape
the cluster into ``karpenter_pods_state``, ``karpenter_nodes_allocatable``
and the provisioner usage/limit gauges (``designs/metrics.md``). The action
counters in ``utils/metrics.py`` say what the controllers DID; these
scrapers say what the cluster IS — the signal an operator watching
``/metrics`` needs to answer "what is the cluster's shape and utilization
right now".

Three scrapers, each a plain reconcile callable the operator registers on
its loop through the controller kit (so they inherit cadence, error backoff,
reconcile metrics and correlation ids like every other controller):

* :class:`NodeScraper` — per-node allocatable / pod-requested / utilization
  gauges labeled by provisioner, zone, instance type, capacity type, phase;
* :class:`PodScraper` — ``karpenter_tpu_pods_state`` by phase/owner/
  provisioner plus the pod-created -> bound schedulable-latency histogram
  (fed by cluster watch events, so a bind is observed exactly once);
* :class:`ProvisionerScraper` — usage vs. limit gauges per provisioner,
  mirroring ``karpenter_provisioner_usage``/``karpenter_provisioner_limit``.

All three read through ``Cluster.state_snapshot()`` — one consistent view
per pass — which works identically against the embedded store and the
HTTP informer cache (``state/httpcluster.py`` subclasses ``Cluster``).

Staleness: the scrapers replace their gauge series atomically per pass, but
a pass only runs every ``metrics_scrape_interval`` seconds — on a shrinking
cluster, ``/metrics`` scraped between passes reports GHOST series for nodes
and provisioners that are already gone. ``build_scrapers`` therefore also
registers a registry PRE-SCRAPE hook (the same pattern as the ICE-gauge
refresher in ``utils/cache.py``) that prunes state-gauge series whose
node/provisioner no longer exists in ANY live scraped cluster, so every
exposition reflects the current population regardless of scraper cadence.
"""

from __future__ import annotations

import threading
import weakref
from typing import List

from ...utils import metrics
from .node import NodeScraper
from .pod import PodScraper
from .provisioner import ProvisionerScraper

# -- pre-scrape staleness pruning -------------------------------------------
# All scraped clusters feed ONE registered refresher (registered once per
# process); dead clusters fall out of the weak set, and with no live cluster
# the hook no-ops rather than wiping series it cannot judge.

_live_clusters: "weakref.WeakSet" = weakref.WeakSet()
_hook_lock = threading.Lock()
_hook_registered = False
#: (node names, provisioner names) at the last prune: the population check
#: is O(objects) while the prune itself is O(total series) — on a steady
#: cluster every scrape short-circuits after the cheap comparison
_last_pruned_names = None

#: gauges keyed by node_name / provisioner label (the prunable state gauges)
_NODE_GAUGES = (
    metrics.NODES_ALLOCATABLE,
    metrics.NODES_POD_REQUESTS,
    metrics.NODES_UTILIZATION,
)
_PROVISIONER_GAUGES = (metrics.PROVISIONER_USAGE, metrics.PROVISIONER_LIMIT)


def prune_stale_state_series() -> None:
    """Drop state-gauge series for nodes/provisioners absent from every live
    scraped cluster (the registry calls this before each exposition). The
    walk over every gauge series only runs when the NAME POPULATION moved
    since the last prune — a steady fleet's scrapes pay one cheap set
    comparison, not an O(total-series) sweep per exposition."""
    global _last_pruned_names
    clusters = list(_live_clusters)
    if not clusters:
        return
    nodes: set = set()
    provisioners: set = set()
    for cluster in clusters:
        with cluster._lock:
            nodes.update(cluster.nodes.keys())
            provisioners.update(cluster.provisioners.keys())
    names = (frozenset(nodes), frozenset(provisioners))
    if names == _last_pruned_names:
        return  # nothing appeared or disappeared: no series can be stale
    _last_pruned_names = names
    for gauge in _NODE_GAUGES:
        gauge.prune_series(lambda labels: labels.get("node_name") in nodes)
    for gauge in _PROVISIONER_GAUGES:
        gauge.prune_series(lambda labels: labels.get("provisioner") in provisioners)
    # pods_state series carry the HOSTING provisioner ("" for unbound pods —
    # never prunable by name); drop breakdowns for deleted provisioners
    metrics.PODS_STATE.prune_series(
        lambda labels: not labels.get("provisioner")
        or labels.get("provisioner") in provisioners
    )


def _track_for_pruning(cluster) -> None:
    global _hook_registered
    with _hook_lock:
        _live_clusters.add(cluster)
        if not _hook_registered:
            metrics.REGISTRY.add_refresher(prune_stale_state_series)
            _hook_registered = True


def build_scrapers(cluster) -> List:
    """The operator's default scraper set, in scrape order. Also enrolls the
    cluster in the pre-scrape staleness pruner (see module docstring)."""
    _track_for_pruning(cluster)
    return [NodeScraper(cluster), PodScraper(cluster), ProvisionerScraper(cluster)]


__all__ = [
    "NodeScraper",
    "PodScraper",
    "ProvisionerScraper",
    "build_scrapers",
    "prune_stale_state_series",
]
