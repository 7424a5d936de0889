from . import labels
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
    new_uid,
)
from .requirements import Requirement, Requirements
from .resources import Resources, merge, parse_quantity
from .taints import Taint, Toleration, tolerates_all

__all__ = [
    "labels",
    "BlockDeviceMapping",
    "KubeletConfiguration",
    "Machine",
    "MachineStatus",
    "Node",
    "NodeTemplate",
    "ObjectMeta",
    "Pod",
    "PodAffinityTerm",
    "PodDisruptionBudget",
    "Provisioner",
    "TopologySpreadConstraint",
    "new_uid",
    "Requirement",
    "Requirements",
    "Resources",
    "merge",
    "parse_quantity",
    "Taint",
    "Toleration",
    "tolerates_all",
]
