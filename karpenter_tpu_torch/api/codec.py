"""Wire codecs for the API objects: dataclasses <-> JSON-safe dicts.

A copy of ``karpenter_tpu/api/codec.py``. The reference's cluster API server
(``state/apiserver.py``, ``ROADMAP.md`` Queue 1 item 6) speaks these over
HTTP the way kube controllers exchange typed objects with the apiserver
(upstream ``cmd/controller/main.go:33-71`` wires everything through
controller-runtime's client; the object schemas live in
``pkg/apis/{v1alpha1,v1alpha5}``); in the port the flight recorder's
capsules (``utils/flightrecorder.py``) and the offline replay
(``replay.py``) are what use them. Round-trips are exact for every
scheduling-relevant field: the replay decodes what the capture encoded and
the solver must group/solve identically on either side.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .objects import (
    BlockDeviceMapping,
    KubeletConfiguration,
    Machine,
    MachineStatus,
    Node,
    NodeTemplate,
    ObjectMeta,
    Pod,
    PodAffinityTerm,
    PodDisruptionBudget,
    Provisioner,
    TopologySpreadConstraint,
)
from .requirements import Requirement, Requirements
from .resources import Resources
from .taints import Taint, Toleration

_NEG_INF = float("-inf")
_POS_INF = float("inf")


# -- leaves -----------------------------------------------------------------
#
# Encoders are SPARSE where the decoder's default equals the omitted value:
# empty label maps, zero priorities, default phases etc. stay off the wire.
# Every decoder already tolerates absence (``d.get(key, default)``), so the
# round trip is unchanged — what changes is cost: pods dominate both the
# apiserver payloads and the flight recorder's per-reconcile input capture,
# and a minimal pod's wire shrinks from ~27 entries to ~6. Fields whose
# empty value is semantically DISTINCT from absent (e.g. a provisioner's
# ``limits={}`` vs ``limits=None`` — the solver's provisioner signature
# tells them apart) are never pruned.

def _meta_to(m: ObjectMeta) -> Dict:
    out = {"name": m.name, "resourceVersion": m.resource_version}
    if m.namespace != "default":
        out["namespace"] = m.namespace
    if m.uid:
        out["uid"] = m.uid
    if m.labels:
        out["labels"] = dict(m.labels)
    if m.annotations:
        out["annotations"] = dict(m.annotations)
    if m.finalizers:
        out["finalizers"] = list(m.finalizers)
    if m.creation_timestamp:
        out["creationTimestamp"] = m.creation_timestamp
    if m.deletion_timestamp is not None:
        out["deletionTimestamp"] = m.deletion_timestamp
    if m.owner_kind is not None:
        out["ownerKind"] = m.owner_kind
    return out


def _meta_from(d: Dict) -> ObjectMeta:
    return ObjectMeta(
        name=d["name"],
        namespace=d.get("namespace", "default"),
        uid=d.get("uid", ""),
        labels=dict(d.get("labels", {})),
        annotations=dict(d.get("annotations", {})),
        finalizers=list(d.get("finalizers", [])),
        creation_timestamp=d.get("creationTimestamp", 0.0),
        deletion_timestamp=d.get("deletionTimestamp"),
        owner_kind=d.get("ownerKind"),
        resource_version=d.get("resourceVersion", 0),
    )


def _resources_to(r: Resources) -> Dict[str, float]:
    return r.to_dict()


def _resources_from(d: Optional[Dict]) -> Resources:
    return Resources(d or {})


def _req_to(r: Requirement) -> Dict:
    out = {"key": r.key, "complement": r.complement, "values": sorted(r.values)}
    if r.greater_than != _NEG_INF:
        out["greaterThan"] = r.greater_than
    if r.less_than != _POS_INF:
        out["lessThan"] = r.less_than
    return out


def _req_from(d: Dict) -> Requirement:
    return Requirement(
        d["key"],
        d.get("complement", False),
        frozenset(d.get("values", [])),
        d.get("greaterThan", _NEG_INF),
        d.get("lessThan", _POS_INF),
    )


def _reqs_to(rs: Requirements) -> List[Dict]:
    return [_req_to(r) for r in rs]


def _reqs_from(items: Optional[List[Dict]]) -> Requirements:
    return Requirements(_req_from(d) for d in (items or []))


def _taint_to(t: Taint) -> Dict:
    return {"key": t.key, "value": t.value, "effect": t.effect}


def _taint_from(d: Dict) -> Taint:
    return Taint(key=d["key"], effect=d.get("effect", "NoSchedule"), value=d.get("value", ""))


def _tol_to(t: Toleration) -> Dict:
    return {
        "key": t.key, "operator": t.operator, "value": t.value,
        "effect": t.effect, "tolerationSeconds": t.toleration_seconds,
    }


def _tol_from(d: Dict) -> Toleration:
    return Toleration(
        key=d.get("key", ""), operator=d.get("operator", "Equal"),
        value=d.get("value", ""), effect=d.get("effect", ""),
        toleration_seconds=d.get("tolerationSeconds"),
    )


def _kubelet_to(k: KubeletConfiguration) -> Dict:
    return {
        "clusterDNS": k.cluster_dns,
        "maxPods": k.max_pods,
        "podsPerCore": k.pods_per_core,
        "kubeReserved": _resources_to(k.kube_reserved) if k.kube_reserved else None,
        "systemReserved": _resources_to(k.system_reserved) if k.system_reserved else None,
        "evictionHard": dict(k.eviction_hard),
        "evictionSoft": dict(k.eviction_soft),
    }


def _kubelet_from(d: Optional[Dict]) -> KubeletConfiguration:
    d = d or {}
    return KubeletConfiguration(
        cluster_dns=d.get("clusterDNS"),
        max_pods=d.get("maxPods"),
        pods_per_core=d.get("podsPerCore"),
        kube_reserved=_resources_from(d["kubeReserved"]) if d.get("kubeReserved") else None,
        system_reserved=_resources_from(d["systemReserved"]) if d.get("systemReserved") else None,
        eviction_hard=dict(d.get("evictionHard", {})),
        eviction_soft=dict(d.get("evictionSoft", {})),
    )


# -- kinds ------------------------------------------------------------------

def pod_to_wire(p: Pod) -> Dict:
    out = {"meta": _meta_to(p.meta), "requests": _resources_to(p.requests)}
    if p.node_selector:
        out["nodeSelector"] = dict(p.node_selector)
    if p.required_affinity_terms:
        out["requiredAffinityTerms"] = [_reqs_to(t) for t in p.required_affinity_terms]
    if p.preferred_affinity_terms:
        out["preferredAffinityTerms"] = [
            [w, _reqs_to(t)] for w, t in p.preferred_affinity_terms
        ]
    if p.volume_zones:
        out["volumeZones"] = list(p.volume_zones)
    if p.tolerations:
        out["tolerations"] = [_tol_to(t) for t in p.tolerations]
    if p.topology_spread:
        out["topologySpread"] = [
            {
                "maxSkew": c.max_skew,
                "topologyKey": c.topology_key,
                "whenUnsatisfiable": c.when_unsatisfiable,
                "labelSelector": dict(c.label_selector),
            }
            for c in p.topology_spread
        ]
    if p.affinity_terms:
        out["affinityTerms"] = [
            {
                "labelSelector": dict(t.label_selector),
                "topologyKey": t.topology_key,
                "anti": t.anti,
            }
            for t in p.affinity_terms
        ]
    if p.priority:
        out["priority"] = p.priority
    if p.node_name is not None:
        out["nodeName"] = p.node_name
    if p.phase != "Pending":
        out["phase"] = p.phase
    if p.is_daemonset:
        out["isDaemonset"] = p.is_daemonset
    return out


def pod_from_wire(d: Dict) -> Pod:
    return Pod(
        meta=_meta_from(d["meta"]),
        requests=_resources_from(d.get("requests")),
        node_selector=dict(d.get("nodeSelector", {})),
        required_affinity_terms=[_reqs_from(t) for t in d.get("requiredAffinityTerms", [])],
        preferred_affinity_terms=[
            (int(w), _reqs_from(t)) for w, t in d.get("preferredAffinityTerms", [])
        ],
        volume_zones=list(d.get("volumeZones", [])),
        tolerations=[_tol_from(t) for t in d.get("tolerations", [])],
        topology_spread=[
            TopologySpreadConstraint(
                max_skew=c["maxSkew"],
                topology_key=c["topologyKey"],
                when_unsatisfiable=c.get("whenUnsatisfiable", "DoNotSchedule"),
                label_selector=dict(c.get("labelSelector", {})),
            )
            for c in d.get("topologySpread", [])
        ],
        affinity_terms=[
            PodAffinityTerm(
                label_selector=dict(t.get("labelSelector", {})),
                topology_key=t["topologyKey"],
                anti=t.get("anti", False),
            )
            for t in d.get("affinityTerms", [])
        ],
        priority=d.get("priority", 0),
        node_name=d.get("nodeName"),
        phase=d.get("phase", "Pending"),
        is_daemonset=d.get("isDaemonset", False),
    )


def node_to_wire(n: Node) -> Dict:
    out = {
        "meta": _meta_to(n.meta),
        "providerId": n.provider_id,
        "capacity": _resources_to(n.capacity),
        "allocatable": _resources_to(n.allocatable),
        "ready": n.ready,
    }
    if n.taints:
        out["taints"] = [_taint_to(t) for t in n.taints]
    if n.unschedulable:
        out["unschedulable"] = n.unschedulable
    if n.machine_name is not None:
        out["machineName"] = n.machine_name
    return out


def node_from_wire(d: Dict) -> Node:
    return Node(
        meta=_meta_from(d["meta"]),
        provider_id=d.get("providerId", ""),
        capacity=_resources_from(d.get("capacity")),
        allocatable=_resources_from(d.get("allocatable")),
        taints=[_taint_from(t) for t in d.get("taints", [])],
        unschedulable=d.get("unschedulable", False),
        ready=d.get("ready", False),
        machine_name=d.get("machineName"),
    )


def machine_to_wire(m: Machine) -> Dict:
    return {
        "meta": _meta_to(m.meta),
        "provisionerName": m.provisioner_name,
        "requirements": _reqs_to(m.requirements),
        "requests": _resources_to(m.requests),
        "taints": [_taint_to(t) for t in m.taints],
        "kubelet": _kubelet_to(m.kubelet),
        "nodeTemplateRef": m.node_template_ref,
        "status": {
            "providerId": m.status.provider_id,
            "capacity": _resources_to(m.status.capacity),
            "allocatable": _resources_to(m.status.allocatable),
            "launched": m.status.launched,
            "registered": m.status.registered,
            "initialized": m.status.initialized,
        },
    }


def machine_from_wire(d: Dict) -> Machine:
    s = d.get("status", {})
    return Machine(
        meta=_meta_from(d["meta"]),
        provisioner_name=d.get("provisionerName", ""),
        requirements=_reqs_from(d.get("requirements")),
        requests=_resources_from(d.get("requests")),
        taints=[_taint_from(t) for t in d.get("taints", [])],
        kubelet=_kubelet_from(d.get("kubelet")),
        node_template_ref=d.get("nodeTemplateRef"),
        status=MachineStatus(
            provider_id=s.get("providerId", ""),
            capacity=_resources_from(s.get("capacity")),
            allocatable=_resources_from(s.get("allocatable")),
            launched=s.get("launched", False),
            registered=s.get("registered", False),
            initialized=s.get("initialized", False),
        ),
    )


def provisioner_to_wire(p: Provisioner) -> Dict:
    return {
        "meta": _meta_to(p.meta),
        "requirements": _reqs_to(p.requirements),
        "labels": dict(p.labels),
        "annotations": dict(p.annotations),
        "taints": [_taint_to(t) for t in p.taints],
        "startupTaints": [_taint_to(t) for t in p.startup_taints],
        "kubelet": _kubelet_to(p.kubelet),
        "limits": _resources_to(p.limits) if p.limits is not None else None,
        "consolidationEnabled": p.consolidation_enabled,
        "ttlSecondsAfterEmpty": p.ttl_seconds_after_empty,
        "ttlSecondsUntilExpired": p.ttl_seconds_until_expired,
        "weight": p.weight,
        "nodeTemplateRef": p.node_template_ref,
    }


def provisioner_from_wire(d: Dict) -> Provisioner:
    return Provisioner(
        meta=_meta_from(d["meta"]),
        requirements=_reqs_from(d.get("requirements")),
        labels=dict(d.get("labels", {})),
        annotations=dict(d.get("annotations", {})),
        taints=[_taint_from(t) for t in d.get("taints", [])],
        startup_taints=[_taint_from(t) for t in d.get("startupTaints", [])],
        kubelet=_kubelet_from(d.get("kubelet")),
        limits=_resources_from(d["limits"]) if d.get("limits") is not None else None,
        consolidation_enabled=d.get("consolidationEnabled", False),
        ttl_seconds_after_empty=d.get("ttlSecondsAfterEmpty"),
        ttl_seconds_until_expired=d.get("ttlSecondsUntilExpired"),
        weight=d.get("weight", 0),
        node_template_ref=d.get("nodeTemplateRef"),
    )


def node_template_to_wire(t: NodeTemplate) -> Dict:
    return {
        "meta": _meta_to(t.meta),
        "imageFamily": t.image_family,
        "imageSelector": dict(t.image_selector),
        "subnetSelector": dict(t.subnet_selector),
        "securityGroupSelector": dict(t.security_group_selector),
        "instanceProfile": t.instance_profile,
        "userData": t.user_data,
        "tags": dict(t.tags),
        "blockDeviceMappings": [
            {
                "deviceName": b.device_name,
                "volumeSizeGib": b.volume_size_gib,
                "volumeType": b.volume_type,
                "encrypted": b.encrypted,
                "deleteOnTermination": b.delete_on_termination,
            }
            for b in t.block_device_mappings
        ],
        "detailedMonitoring": t.detailed_monitoring,
        "metadataOptions": dict(t.metadata_options),
        "resolvedSubnets": list(t.resolved_subnets),
        "resolvedSecurityGroups": list(t.resolved_security_groups),
        "resolvedImages": list(t.resolved_images),
    }


def node_template_from_wire(d: Dict) -> NodeTemplate:
    return NodeTemplate(
        meta=_meta_from(d["meta"]),
        image_family=d.get("imageFamily", "default"),
        image_selector=dict(d.get("imageSelector", {})),
        subnet_selector=dict(d.get("subnetSelector", {})),
        security_group_selector=dict(d.get("securityGroupSelector", {})),
        instance_profile=d.get("instanceProfile"),
        user_data=d.get("userData"),
        tags=dict(d.get("tags", {})),
        block_device_mappings=[
            BlockDeviceMapping(
                device_name=b["deviceName"],
                volume_size_gib=b.get("volumeSizeGib", 20),
                volume_type=b.get("volumeType", "ssd"),
                encrypted=b.get("encrypted", True),
                delete_on_termination=b.get("deleteOnTermination", True),
            )
            for b in d.get("blockDeviceMappings", [])
        ],
        detailed_monitoring=d.get("detailedMonitoring", False),
        metadata_options=dict(d.get("metadataOptions", {})),
        resolved_subnets=list(d.get("resolvedSubnets", [])),
        resolved_security_groups=list(d.get("resolvedSecurityGroups", [])),
        resolved_images=list(d.get("resolvedImages", [])),
    )


def pdb_to_wire(b: PodDisruptionBudget) -> Dict:
    return {
        "meta": _meta_to(b.meta),
        "selector": dict(b.selector),
        "minAvailable": b.min_available,
        "maxUnavailable": b.max_unavailable,
    }


def pdb_from_wire(d: Dict) -> PodDisruptionBudget:
    return PodDisruptionBudget(
        meta=_meta_from(d["meta"]),
        selector=dict(d.get("selector", {})),
        min_available=d.get("minAvailable"),
        max_unavailable=d.get("maxUnavailable"),
    )


# kind registry: wire kind name -> (type, encode, decode)
KINDS = {
    "pods": (Pod, pod_to_wire, pod_from_wire),
    "nodes": (Node, node_to_wire, node_from_wire),
    "machines": (Machine, machine_to_wire, machine_from_wire),
    "provisioners": (Provisioner, provisioner_to_wire, provisioner_from_wire),
    "nodetemplates": (NodeTemplate, node_template_to_wire, node_template_from_wire),
    "poddisruptionbudgets": (PodDisruptionBudget, pdb_to_wire, pdb_from_wire),
}

KIND_OF_TYPE = {t: kind for kind, (t, _e, _d) in KINDS.items()}


def to_wire(obj) -> Dict:
    kind = KIND_OF_TYPE[type(obj)]
    return KINDS[kind][1](obj)


def kind_of(obj) -> str:
    return KIND_OF_TYPE[type(obj)]


def from_wire(kind: str, d: Dict):
    return KINDS[kind][2](d)
