from .deprovisioning import DeprovisioningController, PlannedAction
from .drift import DriftController
from .garbagecollect import GarbageCollectionController
from .interruption import FakeQueue, InterruptionController, ParserRegistry
from .nodetemplate import NodeTemplateController
from .provisioning import PodBatcher, ProvisioningController, ProvisioningResult, register_node
from .termination import TerminationController

__all__ = [
    "DeprovisioningController",
    "PlannedAction",
    "DriftController",
    "GarbageCollectionController",
    "FakeQueue",
    "InterruptionController",
    "ParserRegistry",
    "NodeTemplateController",
    "PodBatcher",
    "ProvisioningController",
    "ProvisioningResult",
    "register_node",
    "TerminationController",
]
