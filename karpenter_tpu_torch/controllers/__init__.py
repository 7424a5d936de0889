from .provisioning import PodBatcher, ProvisioningController, ProvisioningResult, register_node
from .termination import TerminationController

__all__ = [
    "PodBatcher",
    "ProvisioningController",
    "ProvisioningResult",
    "register_node",
    "TerminationController",
]
