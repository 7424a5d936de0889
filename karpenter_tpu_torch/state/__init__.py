from .cells import CellRouter
from .cluster import Cluster, StateSnapshot

__all__ = ["CellRouter", "Cluster", "StateSnapshot"]
