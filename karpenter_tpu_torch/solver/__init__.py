from .bounds import best_lower_bound, fractional_lower_bound, lp_lower_bound
from .encode import EncodedProblem, ExistingNode, LaunchOption, PodGroup, build_options, encode, group_pods
from .result import NewNodeSpec, SolveResult
from .session import EncodeSession
from .solver import GreedySolver, Solver, TorchSolver, lower_bound, problem_digest, stage_fleet
from .staging import DeviceStager
from .validate import validate

__all__ = [
    "EncodedProblem",
    "ExistingNode",
    "LaunchOption",
    "PodGroup",
    "build_options",
    "encode",
    "EncodeSession",
    "group_pods",
    "NewNodeSpec",
    "SolveResult",
    "GreedySolver",
    "Solver",
    "TorchSolver",
    "DeviceStager",
    "stage_fleet",
    "problem_digest",
    "lower_bound",
    "best_lower_bound",
    "fractional_lower_bound",
    "lp_lower_bound",
    "validate",
]
