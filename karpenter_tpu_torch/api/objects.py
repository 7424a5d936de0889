"""Core API objects.

Native-Python analogues of the kubernetes + karpenter objects the reference operates
on: Pod, Node, PDB (kube core/v1), and the CRDs — Provisioner
(upstream ``pkg/apis/crds/karpenter.sh_provisioners.yaml:43-316``), Machine
(used throughout upstream ``pkg/cloudprovider/cloudprovider.go:79-145``), and
NodeTemplate (the cloud-neutral analogue of AWSNodeTemplate,
upstream ``pkg/apis/v1alpha1/awsnodetemplate.go:50-77``).

Objects are mutable dataclasses managed by the in-memory cluster store
(`karpenter_tpu.state`); controllers read/patch them exactly as the reference's
reconcilers do through the apiserver.
"""

from __future__ import annotations

import itertools
import time as _time
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from . import labels as wk
from .requirements import Requirement, Requirements
from .resources import Resources
from .taints import Taint, Toleration

_uid_counter = itertools.count(1)


def new_uid(prefix: str = "uid") -> str:
    return f"{prefix}-{next(_uid_counter)}"


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = field(default_factory=lambda: new_uid())
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    finalizers: List[str] = field(default_factory=list)
    creation_timestamp: float = field(default_factory=_time.time)
    deletion_timestamp: Optional[float] = None
    owner_kind: Optional[str] = None  # e.g. "ReplicaSet", "DaemonSet", None=controllerless
    resource_version: int = 0


@dataclass(frozen=True)
class TopologySpreadConstraint:
    max_skew: int
    topology_key: str  # zone | hostname | capacity-type
    when_unsatisfiable: str = "DoNotSchedule"  # or ScheduleAnyway
    label_selector: Mapping[str, str] = field(default_factory=dict)

    def selects(self, pod: "Pod") -> bool:
        return all(pod.meta.labels.get(k) == v for k, v in self.label_selector.items())


@dataclass(frozen=True)
class PodAffinityTerm:
    label_selector: Mapping[str, str]
    topology_key: str
    anti: bool = False  # True => anti-affinity

    def selects(self, pod: "Pod") -> bool:
        return all(pod.meta.labels.get(k) == v for k, v in self.label_selector.items())


@dataclass
class Pod:
    meta: ObjectMeta
    requests: Resources = field(default_factory=Resources)
    node_selector: Dict[str, str] = field(default_factory=dict)
    # Required node affinity: list of OR'd Requirements terms (each term AND'd inside).
    required_affinity_terms: List[Requirements] = field(default_factory=list)
    preferred_affinity_terms: List[Tuple[int, Requirements]] = field(default_factory=list)
    # Zones allowed by the pod's bound persistent volumes (PV topology: the
    # reference scheduler folds PV nodeAffinity into the pod's requirements —
    # website concepts/scheduling.md "persistent volume topology"). Empty =
    # unconstrained.
    volume_zones: List[str] = field(default_factory=list)
    tolerations: List[Toleration] = field(default_factory=list)
    topology_spread: List[TopologySpreadConstraint] = field(default_factory=list)
    affinity_terms: List[PodAffinityTerm] = field(default_factory=list)  # required only
    priority: int = 0
    node_name: Optional[str] = None  # bound node
    phase: str = "Pending"
    is_daemonset: bool = False

    @property
    def name(self) -> str:
        return self.meta.name

    def _soft_constraint_count(self) -> int:
        return len(self.preferred_affinity_terms) + sum(
            1 for c in self.topology_spread if c.when_unsatisfiable != "DoNotSchedule"
        )

    def has_relaxable_constraints(self) -> bool:
        return self.__dict__.get("_relax_level", 0) < self._soft_constraint_count()

    def active_preferred_terms(self) -> List[Tuple[int, Requirements]]:
        """Preferred terms still in force at this pod's relaxation level:
        the ``_relax_level`` lowest-weight terms are dropped (the reference
        scheduler relaxes preferences one at a time, weakest first, only
        while the pod cannot schedule)."""
        prefs = self.preferred_affinity_terms
        if not prefs:
            return []
        level = self.__dict__.get("_relax_level", 0)
        if level >= len(prefs):
            return []
        return sorted(prefs, key=lambda t: t[0])[level:]

    def effective_spread(self) -> List["TopologySpreadConstraint"]:
        """Topology spread constraints in force: DoNotSchedule always; a
        ScheduleAnyway constraint is PROMOTED to hard (the reference honors
        soft spreads until the pod cannot schedule, then relaxes them AFTER
        the pod's preferred affinities are exhausted — relaxation list order:
        preferences weakest-first, then soft spreads)."""
        spread = self.topology_spread
        if all(c.when_unsatisfiable == "DoNotSchedule" for c in spread):
            return spread  # hot-path fast path: nothing soft, nothing to split
        hard = [c for c in spread if c.when_unsatisfiable == "DoNotSchedule"]
        soft = [c for c in spread if c.when_unsatisfiable != "DoNotSchedule"]
        over = self.__dict__.get("_relax_level", 0) - len(self.preferred_affinity_terms)
        if over > 0:
            soft = soft[over:]
        return hard + soft

    def scheduling_requirement_terms(self) -> List[Requirements]:
        """OR'd requirement terms: nodeSelector AND'd into each affinity term.

        Mirrors how core's scheduler folds nodeSelector + requiredDuringScheduling
        node affinity into scheduling requirements, with PV topology zones
        folded in as a zone requirement, and preferredDuringScheduling terms
        treated as REQUIRED until relaxed (website concepts/scheduling.md
        "preferences"); see ``active_preferred_terms``.
        """
        base = Requirements.from_labels(self.node_selector)
        if self.volume_zones:
            base = base.add(Requirement.in_values(wk.ZONE, self.volume_zones))
        for _, term in self.active_preferred_terms():
            base = base.intersect(term)
        if not self.required_affinity_terms:
            return [base]
        return [base.intersect(term) for term in self.required_affinity_terms]

    def relax_preferences(self) -> bool:
        """IN-PLACE relaxation of the weakest still-active soft constraint
        (preferred affinities weakest-first, then ScheduleAnyway spreads).
        Solvers use ``relaxed_clone`` instead so live pods stay untouched;
        this is the mutating form for callers that own the pod. Returns True
        when something was relaxed."""
        if self.has_relaxable_constraints():
            self.__dict__["_relax_level"] = self.__dict__.get("_relax_level", 0) + 1
            self.__dict__.pop("_sched_sig", None)  # grouping key changed
            return True
        return False

    def invalidate_scheduling_cache(self) -> None:
        """Drop the cached scheduling signature; call after mutating any
        scheduling-relevant field in place (cluster.update does)."""
        self.__dict__.pop("_sched_sig", None)

    def relaxed_clone(self) -> "Pod":
        """A copy of this pod with one more preference relaxed — solvers use
        clones so a what-if simulation (consolidation) or a transient
        unschedulability never permanently strips a LIVE pod's preferences."""
        import dataclasses

        clone = dataclasses.replace(self)
        clone.__dict__["_relax_level"] = self.__dict__.get("_relax_level", 0) + 1
        return clone

    def deletion_cost(self) -> float:
        try:
            return float(self.meta.annotations.get("controller.kubernetes.io/pod-deletion-cost", 0))
        except ValueError:
            return 0.0

    def pod_group(self) -> Optional[str]:
        """Gang membership key (label preferred, annotation fallback); None
        for pods outside any gang. Both forms are scheduling identity: the
        label rides the signature's label surface, the annotation is folded
        in explicitly (encode._signature's gang component)."""
        return self.meta.labels.get(wk.POD_GROUP) or self.meta.annotations.get(
            wk.POD_GROUP
        )

    def pod_group_min_members(self) -> int:
        """The gang's all-or-nothing quorum (>=1). An unparseable or missing
        annotation degrades to 1 — the gang still places atomically, it just
        never waits for absent members."""
        try:
            return max(int(self.meta.annotations.get(wk.POD_GROUP_MIN_MEMBERS, 1)), 1)
        except (TypeError, ValueError):
            return 1

    def is_pending(self) -> bool:
        return self.phase == "Pending" and self.node_name is None

    def owned(self) -> bool:
        return self.meta.owner_kind is not None


@dataclass
class Node:
    meta: ObjectMeta
    provider_id: str = ""
    capacity: Resources = field(default_factory=Resources)
    allocatable: Resources = field(default_factory=Resources)
    taints: List[Taint] = field(default_factory=list)
    unschedulable: bool = False
    ready: bool = False
    machine_name: Optional[str] = None

    @property
    def name(self) -> str:
        return self.meta.name

    @property
    def labels(self) -> Dict[str, str]:
        return self.meta.labels

    def invalidate_scheduling_cache(self) -> None:
        """Drop the cached requirement surface; call after mutating the
        node's labels in place (cluster.update does)."""
        self.__dict__.pop("_req_surface", None)

    def zone(self) -> str:
        return self.meta.labels.get(wk.ZONE, "")

    def capacity_type(self) -> str:
        return self.meta.labels.get(wk.CAPACITY_TYPE, wk.CAPACITY_TYPE_ON_DEMAND)

    def instance_type(self) -> str:
        return self.meta.labels.get(wk.INSTANCE_TYPE, "")

    def capacity_pool(self) -> Tuple[str, str, str]:
        """The node's ``(instance_type, zone, capacity_type)`` capacity-pool
        key — the unit of risk accounting (riskcache), diversification
        masking and pool pricing. Unset labels yield ``""`` (unlike
        ``capacity_type()``, which defaults to on-demand for scheduling): an
        unlabeled node must never alias a real pool's evidence."""
        labels = self.meta.labels
        return (
            labels.get(wk.INSTANCE_TYPE, ""),
            labels.get(wk.ZONE, ""),
            labels.get(wk.CAPACITY_TYPE, ""),
        )

    def provisioner_name(self) -> Optional[str]:
        return self.meta.labels.get(wk.PROVISIONER_NAME)

    def slice_pod(self) -> str:
        """ICI-domain id of the TPU slice this node draws chips from, or ""
        for non-slice nodes (slice coordinates ride the node as labels —
        sparse on the wire like every unset label)."""
        return self.meta.labels.get(wk.SLICE_POD, "")

    def slice_coord(self) -> Optional[Tuple[int, int, int]]:
        """Torus (x, y, z) coordinate inside the node's ICI domain, or None
        when the node carries no (or a malformed) slice-coord label."""
        raw = self.meta.labels.get(wk.SLICE_COORD)
        if not raw:
            return None
        from ..solver.topology import parse_coord

        return parse_coord(raw)


@dataclass
class KubeletConfiguration:
    """Per-provisioner kubelet tuning affecting allocatable + pod density.

    Reference: provisioner CRD kubeletConfiguration
    (karpenter.sh_provisioners.yaml) and its use in overhead math
    (upstream pkg/providers/instancetype/types.go:241-340).
    """

    cluster_dns: Optional[List[str]] = None  # list of DNS IPs (k8s clusterDNS)
    max_pods: Optional[int] = None
    pods_per_core: Optional[int] = None
    kube_reserved: Optional[Resources] = None
    system_reserved: Optional[Resources] = None
    eviction_hard: Dict[str, str] = field(default_factory=dict)  # e.g. {"memory.available": "100Mi"}
    eviction_soft: Dict[str, str] = field(default_factory=dict)


@dataclass
class Provisioner:
    """Pool definition: constraints + limits + deprovisioning policy.

    Reference: Provisioner CRD spec (SURVEY §2.2; karpenter.sh_provisioners.yaml).
    """

    meta: ObjectMeta
    requirements: Requirements = field(default_factory=Requirements)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    taints: List[Taint] = field(default_factory=list)
    startup_taints: List[Taint] = field(default_factory=list)
    kubelet: KubeletConfiguration = field(default_factory=KubeletConfiguration)
    limits: Optional[Resources] = None  # cost/resource ceiling (designs/limits.md)
    consolidation_enabled: bool = False
    ttl_seconds_after_empty: Optional[int] = None
    ttl_seconds_until_expired: Optional[int] = None
    weight: int = 0
    node_template_ref: Optional[str] = None

    @property
    def name(self) -> str:
        return self.meta.name

    def validate(self) -> None:
        if self.consolidation_enabled and self.ttl_seconds_after_empty is not None:
            raise ValueError(
                f"provisioner {self.name}: consolidation.enabled and ttlSecondsAfterEmpty "
                "are mutually exclusive"
            )
        for key in self.requirements.keys():
            if key in wk.RESTRICTED_LABELS:
                raise ValueError(f"provisioner {self.name}: restricted label {key}")


@dataclass
class MachineStatus:
    provider_id: str = ""
    capacity: Resources = field(default_factory=Resources)
    allocatable: Resources = field(default_factory=Resources)
    launched: bool = False
    registered: bool = False
    initialized: bool = False


@dataclass
class Machine:
    """Intermediate machine object bridging scheduler decisions to cloud instances.

    Reference: Machine CRD lifecycle launch -> registration -> initialization
    (SURVEY §2.2; upstream pkg/cloudprovider/cloudprovider.go:79-145).
    """

    meta: ObjectMeta
    provisioner_name: str = ""
    requirements: Requirements = field(default_factory=Requirements)
    requests: Resources = field(default_factory=Resources)  # sum of scheduled pod requests
    taints: List[Taint] = field(default_factory=list)
    kubelet: KubeletConfiguration = field(default_factory=KubeletConfiguration)
    node_template_ref: Optional[str] = None
    status: MachineStatus = field(default_factory=MachineStatus)

    @property
    def name(self) -> str:
        return self.meta.name


@dataclass
class BlockDeviceMapping:
    device_name: str
    volume_size_gib: int = 20
    volume_type: str = "ssd"
    encrypted: bool = True
    delete_on_termination: bool = True


@dataclass
class NodeTemplate:
    """Cloud/infra template resolved at launch time.

    Cloud-neutral analogue of AWSNodeTemplate
    (upstream pkg/apis/v1alpha1/awsnodetemplate.go:50-77, provider.go:24-76):
    image discovery by family or selector, network placement by selector, userdata,
    block devices, tags. Status carries resolved concrete ids, maintained by the
    nodetemplate controller (upstream pkg/controllers/nodetemplate).
    """

    meta: ObjectMeta
    image_family: str = "default"  # strategy name; reference amiFamily resolver.go:72-79
    image_selector: Dict[str, str] = field(default_factory=dict)
    subnet_selector: Dict[str, str] = field(default_factory=dict)
    security_group_selector: Dict[str, str] = field(default_factory=dict)
    instance_profile: Optional[str] = None
    user_data: Optional[str] = None
    tags: Dict[str, str] = field(default_factory=dict)
    block_device_mappings: List[BlockDeviceMapping] = field(default_factory=list)
    detailed_monitoring: bool = False
    metadata_options: Dict[str, str] = field(default_factory=dict)
    # status (resolved by the nodetemplate controller)
    resolved_subnets: List[str] = field(default_factory=list)
    resolved_security_groups: List[str] = field(default_factory=list)
    resolved_images: List[str] = field(default_factory=list)

    @property
    def name(self) -> str:
        return self.meta.name


@dataclass
class PodDisruptionBudget:
    meta: ObjectMeta
    selector: Dict[str, str] = field(default_factory=dict)
    min_available: Optional[int] = None
    max_unavailable: Optional[int] = None

    def selects(self, pod: Pod) -> bool:
        return all(pod.meta.labels.get(k) == v for k, v in self.selector.items())
