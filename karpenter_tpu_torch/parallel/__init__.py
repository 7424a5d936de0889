"""Host-side parallelism. The device mesh of the JAX package
(``parallel/mesh.py``) is not ported: it needs several cards (``ROADMAP.md``,
Queue 1 item 10)."""

from .hostpool import SerialBackground, default_workers, first_hit, map_all

__all__ = ["SerialBackground", "default_workers", "first_hit", "map_all"]
