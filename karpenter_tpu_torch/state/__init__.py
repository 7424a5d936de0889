from .cells import CellRouter
from .cluster import Cluster, StateSnapshot
from .apiserver import ClusterAPIServer
from .httpcluster import HTTPCluster

__all__ = ["CellRouter", "Cluster", "ClusterAPIServer", "HTTPCluster", "StateSnapshot"]
