"""Node termination finalizer: cordon -> drain -> delete instance -> remove node.

Reference behavior (``website/.../concepts/deprovisioning.md:9-16``, SURVEY §2.2
termination controller row): every managed node carries a termination finalizer; on
node deletion the controller cordons, evicts non-daemonset pods respecting PDBs and
grace, calls ``CloudProvider.Delete``, then removes the node object.

Eviction simulates the kube eviction API: owned pods return to Pending (their
controller recreates them), unowned pods are deleted outright. PDB-blocked
evictions defer to the next reconcile, exactly like the eviction queue's retry.
"""

from __future__ import annotations

import threading
import time
from typing import AbstractSet, List, Optional

from ..api import labels as wk
from ..api.objects import Node, Pod
from ..cloudprovider.interface import CloudProvider, MachineNotFoundError
from ..state.cluster import Cluster
from ..utils import metrics
from ..utils.cache import Clock
from ..utils.events import Recorder


def evict_pod(
    cluster: Cluster,
    pod: Pod,
    recorder: Recorder,
    reason: str = "evicted",
    requeue_unowned: bool = False,
) -> None:
    """The kube eviction-API semantics, shared by node drain and the
    preemption planner: an owned pod returns to Pending (its controller
    recreates it — the unbind fires a MODIFIED watch event, so the delta
    encoder's dirty set and the batch window both see it re-enter the pending
    population); an unowned pod is deleted outright (a DELETED event).
    ``requeue_unowned`` is for rolling back a bind made THIS round (the gang
    partial-placement epilogue): nothing ran yet, so even an unowned pod is
    simply un-placed rather than destroyed."""
    if pod.owned() or requeue_unowned:
        pod.node_name = None
        pod.phase = "Pending"
        cluster.update(pod)
    else:
        cluster.delete_pod(pod.name)
    recorder.publish("Evicted", reason, object_name=pod.name, object_kind="Pod")


def pdb_blocks(cluster: Cluster, pod: Pod, planned: AbstractSet[str] = frozenset()) -> bool:
    """Eviction-API accounting: an eviction is allowed only while it keeps the
    budget satisfied, counting pods ALREADY disrupted (selected but not bound
    to a node) against maxUnavailable — so draining N nodes at once cannot
    take every replica of a maxUnavailable=1 budget in one pass. Shared by
    drain, consolidation candidate filtering, and preemption victim vetting;
    ``planned`` names pods an in-flight plan has already slated for eviction,
    counted as disrupted so a multi-victim preemption plan cannot collectively
    blow a budget its victims would each clear alone."""
    for pdb in cluster.pdbs_for_pod(pod):
        selected = [p for p in cluster.pods.values() if pdb.selects(p)]
        healthy = sum(
            1 for p in selected
            if p.node_name is not None and p.name not in planned
        )
        unavailable = len(selected) - healthy
        if pdb.min_available is not None and healthy - 1 < pdb.min_available:
            return True
        if pdb.max_unavailable is not None and unavailable + 1 > pdb.max_unavailable:
            return True
    return False


class TerminationController:
    def __init__(
        self,
        cluster: Cluster,
        provider: CloudProvider,
        recorder: Optional[Recorder] = None,
        clock: Optional[Clock] = None,
    ):
        self.cluster = cluster
        self.provider = provider
        self.recorder = recorder or Recorder()
        self.clock = clock or Clock()
        # names of nodes awaiting finalization: reconcile visits ONLY these
        # instead of scanning every node (O(all-nodes) per pass turns a
        # 15k-node interruption storm into O(N^2)). Watch-maintained so nodes
        # ADOPTED mid-deletion (restart with a deletion_timestamp already set)
        # are picked up too; seeded for nodes that predate this controller.
        self._pending: set = {
            n.name for n in cluster.nodes.values()
            if n.meta.deletion_timestamp is not None
        }
        self._pending_lock = threading.Lock()
        cluster.watch(self._on_event)

    def _on_event(self, event: str, obj) -> None:
        if not isinstance(obj, Node):
            return
        with self._pending_lock:
            if event == "DELETED":
                self._pending.discard(obj.name)
            elif obj.meta.deletion_timestamp is not None:
                self._pending.add(obj.name)

    def delete_node(self, name: str) -> bool:
        """Mark a node for deletion (the `kubectl delete node` moment); the
        finalizer keeps the object alive until drain + instance delete finish."""
        node = self.cluster.nodes.get(name)
        if node is None:
            return False
        if node.meta.deletion_timestamp is None:
            node.meta.deletion_timestamp = self.clock.now()
            self.cluster.update(node)  # MODIFIED event enqueues it in _pending
        return True

    def reconcile(self) -> List[str]:
        """Advance every deleting node through the finalizer; returns names of
        nodes fully removed this pass. Cordon/drain run per node; instance
        teardown is AGGREGATED across the pass into one provider
        ``delete_many`` call — a 200-node consolidation or interruption storm
        issues a handful of TerminateInstances batches, not 200 singles
        (reference: terminateinstances.go batches at 100ms/1s/500)."""
        removed = []
        teardown: List[Node] = []
        with self._pending_lock:
            pending = sorted(self._pending)
        for name in pending:
            node = self.cluster.nodes.get(name)
            if node is None or node.meta.deletion_timestamp is None:
                with self._pending_lock:
                    self._pending.discard(name)
                continue
            if wk.TERMINATION_FINALIZER not in node.meta.finalizers:
                self.cluster.delete_node(node.name)  # DELETED event de-queues
                removed.append(node.name)
                continue
            if self._cordon_and_drain(node):
                teardown.append(node)
        removed.extend(self._teardown(teardown))
        return removed

    # -- finalizer steps ---------------------------------------------------
    def _cordon_and_drain(self, node: Node) -> bool:
        """True when the node is fully drained and ready for instance teardown."""
        if not node.unschedulable:
            node.unschedulable = True  # cordon
            self.cluster.update(node)
            self.recorder.publish("Cordoned", "cordoned for termination",
                                  object_name=node.name, object_kind="Node")
        blocked = self._drain(node)
        return not blocked  # blocked: retry next reconcile (eviction queue semantics)

    def _teardown(self, nodes: List[Node]) -> List[str]:
        """Delete the instances behind ``nodes`` (one batched provider call),
        then drop finalizers and node objects for the successes. A failed
        delete leaves its node pending for the next pass."""
        if not nodes:
            return []
        machines = [self.cluster.machine_for_node(n) for n in nodes]
        with_machine = [(n, m) for n, m in zip(nodes, machines) if m is not None]
        results = self.provider.delete_many([m for _, m in with_machine])
        failed: set = set()
        for (node, machine), err in zip(with_machine, results):
            if err is not None and not isinstance(err, MachineNotFoundError):
                # transient cloud failure: keep the node pending and retry
                self.recorder.publish(
                    "TerminationFailed", f"instance delete failed: {err}",
                    object_name=node.name, object_kind="Node", type="Warning",
                )
                failed.add(node.name)
                continue
            self.cluster.delete_machine(machine.name)
        removed = []
        for node in nodes:
            if node.name in failed:
                continue
            node.meta.finalizers = [
                f for f in node.meta.finalizers if f != wk.TERMINATION_FINALIZER
            ]
            self.cluster.delete_node(node.name)
            metrics.NODES_TERMINATED.inc({"provisioner": node.provisioner_name() or ""})
            self.recorder.publish("Terminated", "node terminated",
                                  object_name=node.name, object_kind="Node")
            removed.append(node.name)
        return removed

    def _drain(self, node: Node) -> List[Pod]:
        """Evict all evictable pods; returns pods still blocking the drain."""
        blocked: List[Pod] = []
        for pod in self.cluster.pods_on_node(node.name):
            if pod.is_daemonset:
                continue  # daemonsets die with the node
            if self._pdb_blocks(pod):
                blocked.append(pod)
                continue
            self._evict(pod)
        return blocked

    def _pdb_blocks(self, pod: Pod) -> bool:
        return pdb_blocks(self.cluster, pod)

    def _evict(self, pod: Pod) -> None:
        evict_pod(self.cluster, pod, self.recorder, reason=f"evicted from {pod.name}")
