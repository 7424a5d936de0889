from .encode import EncodedProblem, ExistingNode, LaunchOption, PodGroup, build_options, encode, group_pods
from .result import NewNodeSpec, SolveResult
from .solver import Solver, TorchSolver, stage_fleet
from .staging import DeviceStager
from .validate import validate

__all__ = [
    "EncodedProblem",
    "ExistingNode",
    "LaunchOption",
    "PodGroup",
    "build_options",
    "encode",
    "group_pods",
    "NewNodeSpec",
    "SolveResult",
    "Solver",
    "TorchSolver",
    "DeviceStager",
    "stage_fleet",
    "validate",
]
