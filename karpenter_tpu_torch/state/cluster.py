"""In-memory cluster state: the apiserver-shaped object store + capacity model.

Two reference roles merged into one subsystem:

* the kube-apiserver object store the controllers reconcile against (the tests'
  envtest environment, SURVEY §4 — nodes are plain objects, no kubelets), and
* core's ``state.Cluster`` in-memory model of nodes/pods/bindings that drives
  scheduling and consolidation (``state.NewCluster`` at
  upstream ``cmd/controller/main.go:60``).

Watch callbacks give controllers the reconcile-trigger shape of controller-runtime
informers without the network layer.
"""

from __future__ import annotations

import contextlib
import threading
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from ..api import labels as wk
from ..api.objects import (
    Machine,
    Node,
    Pod,
    PodDisruptionBudget,
    Provisioner,
    NodeTemplate,
)
from ..api.resources import Resources, merge
from ..solver.encode import ExistingNode

# (event_type, obj): ADDED|MODIFIED|DELETED carry the object; RESYNCED
# carries obj=None and means the cache was rebuilt wholesale (HTTPCluster
# relist) — incremental consumers must treat their event-derived state as
# suspect. Watchers MUST type-check obj rather than assume a kind.
WatchFn = Callable[[str, object], None]


@dataclass(frozen=True)
class StateSnapshot:
    """One consistent read of the cluster's shape, taken under the store lock.

    The read API the state-observability scrapers
    (``controllers/metricsscraper``) consume: because ``HTTPCluster``
    subclasses ``Cluster``, the same call reads the embedded store in-process
    and the informer cache in apiserver mode — scrapers never special-case
    the backend. Object references alias the live store (snapshot the SET,
    not deep copies); the store version stamps the view for debugging.
    """

    nodes: Tuple[Node, ...]
    pods: Tuple[Pod, ...]
    machines: Tuple[Machine, ...]
    provisioners: Tuple[Provisioner, ...]
    resource_version: int = 0
    # the config kinds ride the same locked read: the flight recorder's
    # capsule capture must see ONE store version across every kind, not a
    # snapshot torn by a concurrent watch-thread write
    node_templates: Tuple[NodeTemplate, ...] = ()
    pdbs: Tuple[PodDisruptionBudget, ...] = ()

    def pods_by_node(self) -> Dict[str, List[Pod]]:
        out: Dict[str, List[Pod]] = {}
        for p in self.pods:
            if p.node_name is not None:
                out.setdefault(p.node_name, []).append(p)
        return out


class Cluster:
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self.pods: Dict[str, Pod] = {}
        self.nodes: Dict[str, Node] = {}
        self.machines: Dict[str, Machine] = {}
        self.provisioners: Dict[str, Provisioner] = {}
        self.node_templates: Dict[str, NodeTemplate] = {}
        self.pdbs: Dict[str, PodDisruptionBudget] = {}
        self._watchers: List[WatchFn] = []
        self._version = 0

    # -- store primitives --------------------------------------------------
    def _emit(self, event: str, obj) -> None:
        for w in list(self._watchers):
            w(event, obj)

    def watch(self, fn: WatchFn) -> None:
        with self._lock:
            self._watchers.append(fn)

    def unwatch(self, fn: WatchFn) -> None:
        """Detach a watch callback (no-op when absent): a stopped apiserver
        incarnation must stop feeding its dead event log — a chaos soak
        restarts the listener over the same backing store, and leaked
        callbacks would accrete one dead log per restart. Equality, NOT
        identity: every ``obj.method`` access mints a fresh bound-method
        object, so an ``is`` comparison against the registration can never
        match — ``==`` compares (receiver, function), which does."""
        with self._lock:
            self._watchers = [w for w in self._watchers if w != fn]

    @contextlib.contextmanager
    def quiesce(self):
        """Hold the cluster view stable for one reconcile round. The
        in-process store needs nothing: controllers and writers share one
        thread of control per round. ``HTTPCluster`` overrides this to pause
        its remote-event applier — without it, watch events landing between
        the flight recorder's input capture and the encoder's reads make the
        recorded problem digest irreproducible from the capsule (the chaos
        soak caught exactly that race under sustained churn)."""
        yield

    def _put(self, coll: Dict[str, object], obj, name: str) -> None:
        with self._lock:
            event = "MODIFIED" if name in coll else "ADDED"
            self._version += 1
            obj.meta.resource_version = self._version
            coll[name] = obj
        self._emit(event, obj)

    def _delete(self, coll: Dict[str, object], name: str):
        with self._lock:
            obj = coll.pop(name, None)
            if obj is not None:
                # deletes advance the store version too: a watch client must
                # be able to order a DELETED event against later writes (the
                # apiserver surface replays events by resourceVersion)
                self._version += 1
                obj.meta.resource_version = self._version
        if obj is not None:
            self._emit("DELETED", obj)
        return obj

    # -- typed accessors ---------------------------------------------------
    def add_pod(self, pod: Pod) -> Pod:
        self._put(self.pods, pod, pod.name)
        return pod

    def delete_pod(self, name: str) -> Optional[Pod]:
        return self._delete(self.pods, name)

    def add_node(self, node: Node) -> Node:
        self._put(self.nodes, node, node.name)
        return node

    def delete_node(self, name: str) -> Optional[Node]:
        return self._delete(self.nodes, name)

    def add_machine(self, machine: Machine) -> Machine:
        self._put(self.machines, machine, machine.name)
        return machine

    def delete_machine(self, name: str) -> Optional[Machine]:
        return self._delete(self.machines, name)

    def add_provisioner(self, provisioner: Provisioner) -> Provisioner:
        # admission chain (defaulting + validation) — the write chokepoint a
        # webhook occupies in the reference (webhooks.go:34-63)
        from ..api.admission import admit_provisioner

        admit_provisioner(provisioner)
        self._put(self.provisioners, provisioner, provisioner.name)
        return provisioner

    def delete_provisioner(self, name: str) -> Optional[Provisioner]:
        return self._delete(self.provisioners, name)

    def add_node_template(self, t: NodeTemplate) -> NodeTemplate:
        from ..api.admission import admit_node_template

        admit_node_template(t)
        self._put(self.node_templates, t, t.name)
        return t

    def add_pdb(self, pdb: PodDisruptionBudget) -> PodDisruptionBudget:
        self._put(self.pdbs, pdb, pdb.meta.name)
        return pdb

    def update(self, obj) -> None:
        """Re-announce a mutated object (bump version, fire watches)."""
        if isinstance(obj, Pod):
            obj.invalidate_scheduling_cache()  # scheduling identity may have changed
            self._put(self.pods, obj, obj.name)
        elif isinstance(obj, Node):
            obj.invalidate_scheduling_cache()  # label surface may have changed
            self._put(self.nodes, obj, obj.name)
        elif isinstance(obj, Machine):
            self._put(self.machines, obj, obj.name)
        elif isinstance(obj, Provisioner):
            self._put(self.provisioners, obj, obj.name)
        elif isinstance(obj, NodeTemplate):
            self._put(self.node_templates, obj, obj.name)
        else:
            raise TypeError(f"unknown object {type(obj)}")

    # -- queries (the scheduling-relevant views) ---------------------------
    def state_snapshot(self) -> StateSnapshot:
        """Consistent point-in-time view for the metrics scrapers."""
        with self._lock:
            return StateSnapshot(
                nodes=tuple(self.nodes.values()),
                pods=tuple(self.pods.values()),
                machines=tuple(self.machines.values()),
                provisioners=tuple(self.provisioners.values()),
                resource_version=self._version,
                node_templates=tuple(self.node_templates.values()),
                pdbs=tuple(self.pdbs.values()),
            )

    def pending_pods(self) -> List[Pod]:
        with self._lock:
            return [
                p
                for p in self.pods.values()
                if p.is_pending() and not p.is_daemonset and p.meta.deletion_timestamp is None
            ]

    def daemonsets(self) -> List[Pod]:
        """Daemonset pod templates (one representative per daemonset)."""
        with self._lock:
            return [p for p in self.pods.values() if p.is_daemonset and p.node_name is None]

    def bind_pod(self, pod_name: str, node_name: str) -> None:
        with self._lock:
            pod = self.pods[pod_name]
            pod.node_name = node_name
            pod.phase = "Running"
            # bindings are writes: version them so watch clients order them
            self._version += 1
            pod.meta.resource_version = self._version
        self._emit("MODIFIED", pod)

    def pods_on_node(self, node_name: str) -> List[Pod]:
        with self._lock:
            return [p for p in self.pods.values() if p.node_name == node_name]

    def node_remaining(self, node: Node) -> Resources:
        """Allocatable minus the requests of everything bound to the node."""
        bound = merge([p.requests + Resources(pods=1) for p in self.pods_on_node(node.name)])
        return (node.allocatable - bound).clamp_min_zero()

    def managed_nodes(self, provisioner: Optional[str] = None) -> List[Node]:
        with self._lock:
            out = []
            for n in self.nodes.values():
                pname = n.provisioner_name()
                if pname is None:
                    continue
                if provisioner is not None and pname != provisioner:
                    continue
                out.append(n)
            return out

    def existing_capacity(self) -> List[ExistingNode]:
        """In-flight capacity view for the solver: every managed node with its
        remaining allocatable and its bound pods. Cordoned/deleting nodes are
        included — the encoder marks them unschedulable (no NEW placements)
        but their bound pods still seed topology domain counts. ONE pass over
        the pod map feeds both the seed lists and the remaining-resource
        computation (N nodes x P pods would otherwise scan P per node)."""
        with self._lock:
            by_node: Dict[str, List[Pod]] = {}
            for p in self.pods.values():
                if p.node_name is not None:
                    by_node.setdefault(p.node_name, []).append(p)
        out = []
        for n in self.managed_nodes():
            bound = by_node.get(n.name, ())
            used = merge([p.requests + Resources(pods=1) for p in bound])
            out.append(
                ExistingNode(
                    node=n,
                    remaining=(n.allocatable - used).clamp_min_zero(),
                    pods=tuple(p for p in bound if not p.is_daemonset),
                )
            )
        return out

    def provisioner_usage(self, provisioner: str) -> Resources:
        """Total capacity footprint of a provisioner's nodes — compared against
        Provisioner.limits (reference designs/limits.md)."""
        return merge([n.capacity for n in self.managed_nodes(provisioner)])

    def machine_for_node(self, node: Node) -> Optional[Machine]:
        with self._lock:
            if node.machine_name:
                return self.machines.get(node.machine_name)
            for m in self.machines.values():
                if m.status.provider_id and m.status.provider_id == node.provider_id:
                    return m
        return None

    def pdbs_for_pod(self, pod: Pod) -> List[PodDisruptionBudget]:
        with self._lock:
            return [b for b in self.pdbs.values() if b.selects(pod)]
