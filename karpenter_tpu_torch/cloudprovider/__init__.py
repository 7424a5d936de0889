from .catalog import DEFAULT_ZONES, catalog_by_name, generate_catalog, make_instance_type
from .fake import FakeCloudProvider
from .interface import (
    CloudProvider,
    CloudProviderError,
    InsufficientCapacityError,
    Instance,
    MachineNotFoundError,
)
from .types import (
    InstanceType,
    Offering,
    Overhead,
    compute_overhead,
    eni_limited_pods,
    eviction_threshold,
    instance_type_requirements,
    kube_reserved,
    pods_capacity,
    system_reserved,
)

__all__ = [
    "DEFAULT_ZONES",
    "catalog_by_name",
    "generate_catalog",
    "make_instance_type",
    "FakeCloudProvider",
    "CloudProvider",
    "CloudProviderError",
    "InsufficientCapacityError",
    "Instance",
    "MachineNotFoundError",
    "InstanceType",
    "Offering",
    "Overhead",
    "compute_overhead",
    "eni_limited_pods",
    "eviction_threshold",
    "instance_type_requirements",
    "kube_reserved",
    "pods_capacity",
    "system_reserved",
]
