from .cluster import Cluster, StateSnapshot

__all__ = ["Cluster", "StateSnapshot"]
