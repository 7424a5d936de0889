from .deprovisioning import DeprovisioningController, PlannedAction
from .drift import DriftController
from .garbagecollect import GarbageCollectionController
from .provisioning import PodBatcher, ProvisioningController, ProvisioningResult, register_node
from .termination import TerminationController

__all__ = [
    "DeprovisioningController",
    "PlannedAction",
    "DriftController",
    "GarbageCollectionController",
    "PodBatcher",
    "ProvisioningController",
    "ProvisioningResult",
    "register_node",
    "TerminationController",
]
