"""Utilities of the port: copies of the parts of ``karpenter_tpu/utils``
that the solver and the provisioning controller need."""
from .batcher import Batcher, BatcherOptions
from .cache import (
    DEFAULT_TTL,
    INSTANCE_TYPES_ZONES_TTL,
    UNAVAILABLE_OFFERINGS_TTL,
    Clock,
    FakeClock,
    TTLCache,
    UnavailableOfferings,
)

__all__ = [
    "Batcher",
    "BatcherOptions",
    "DEFAULT_TTL",
    "INSTANCE_TYPES_ZONES_TTL",
    "UNAVAILABLE_OFFERINGS_TTL",
    "Clock",
    "FakeClock",
    "TTLCache",
    "UnavailableOfferings",
]
