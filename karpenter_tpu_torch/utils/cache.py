"""TTL caches and the unavailable-offerings (ICE) cache.

Reference: upstream ``pkg/cache/cache.go:20-36`` (TTLs: default 1m, unavailable
offerings 3m, instance types+zones 5m) and ``unavailableofferings.go:31-80`` (keyed
``capacityType:instanceType:zone`` with a seqnum that invalidates downstream caches).
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Callable, Dict, Generic, Iterator, Optional, Tuple, TypeVar

DEFAULT_TTL = 60.0
UNAVAILABLE_OFFERINGS_TTL = 180.0
INSTANCE_TYPES_ZONES_TTL = 300.0

K = TypeVar("K")
V = TypeVar("V")


class Clock:
    """Injectable clock so tests can step time (reference uses clock.Clock)."""

    def now(self) -> float:
        return time.time()


class FakeClock(Clock):
    def __init__(self, start: float = 0.0):
        self._now = start

    def now(self) -> float:
        return self._now

    def step(self, seconds: float) -> None:
        self._now += seconds


class TTLCache(Generic[K, V]):
    def __init__(self, ttl: float = DEFAULT_TTL, clock: Optional[Clock] = None):
        self.ttl = ttl
        self._clock = clock or Clock()
        self._data: Dict[K, Tuple[float, V]] = {}
        self._lock = threading.Lock()

    def get(self, key: K) -> Optional[V]:
        with self._lock:
            item = self._data.get(key)
            if item is None:
                return None
            expires, value = item
            if self._clock.now() >= expires:
                del self._data[key]
                return None
            return value

    def set(self, key: K, value: V, ttl: Optional[float] = None) -> None:
        with self._lock:
            self._data[key] = (self._clock.now() + (ttl or self.ttl), value)

    def delete(self, key: K) -> None:
        with self._lock:
            self._data.pop(key, None)

    def get_or_compute(self, key: K, compute: Callable[[], V]) -> V:
        value = self.get(key)
        if value is None:
            value = compute()
            self.set(key, value)
        return value

    def flush(self) -> None:
        with self._lock:
            self._data.clear()

    def keys(self) -> Iterator[K]:
        now = self._clock.now()
        with self._lock:
            return iter([k for k, (exp, _) in self._data.items() if now < exp])


class UnavailableOfferings:
    """Blacklist of offerings that recently failed with insufficient capacity.

    Reference: pkg/cache/unavailableofferings.go — MarkUnavailable inserts
    ``capacityType:instanceType:zone`` with a 3m TTL and bumps a seqnum so
    instance-type caches keyed on it recompute availability masks.
    """

    def __init__(self, ttl: float = UNAVAILABLE_OFFERINGS_TTL, clock: Optional[Clock] = None):
        self._clock = clock or Clock()
        self._cache: TTLCache[str, bool] = TTLCache(ttl, self._clock)
        self.seqnum = 0
        self._lock = threading.Lock()
        _track_for_gauge(self)

    @staticmethod
    def _key(capacity_type: str, instance_type: str, zone: str) -> str:
        return f"{capacity_type}:{instance_type}:{zone}"

    def is_unavailable(self, instance_type: str, zone: str, capacity_type: str) -> bool:
        return self._cache.get(self._key(capacity_type, instance_type, zone)) is not None

    def mark_unavailable(
        self, instance_type: str, zone: str, capacity_type: str, reason: str = ""
    ) -> None:
        with self._lock:
            self._cache.set(self._key(capacity_type, instance_type, zone), True)
            self.seqnum += 1
        self._publish_gauge()

    def set_ttl(self, ttl: float) -> None:
        """Retarget the ICE TTL (settings.insufficient_capacity_ttl): applies
        to subsequent marks; live entries keep their original expiry."""
        self._cache.ttl = ttl

    def entries(self) -> list:
        """Live (instance_type, zone, capacity_type) entries, expiry applied."""
        out = []
        for key in self._cache.keys():
            capacity_type, instance_type, zone = key.split(":", 2)
            out.append((instance_type, zone, capacity_type))
        return out

    def _publish_gauge(self) -> None:
        publish_offering_gauge()

    def flush(self) -> None:
        with self._lock:
            self._cache.flush()
            self.seqnum += 1
        self._publish_gauge()


# -- karpenter_tpu_rpc_offering_unavailable export ---------------------------
# All live UnavailableOfferings instances feed ONE merged gauge, refreshed on
# mark/flush AND at scrape time (a registry pre-scrape refresher), so expired
# entries leave /metrics even while the operator is idle — no mark required.

_live_caches: "weakref.WeakSet[UnavailableOfferings]" = weakref.WeakSet()
_gauge_lock = threading.Lock()
_refresher_registered = False


def publish_offering_gauge() -> None:
    """Swap the merged live mask of every tracked cache into the gauge —
    full replace, so expired/flushed entries drop with the same swap."""
    from . import metrics

    series: Dict = {}
    with _gauge_lock:
        caches = list(_live_caches)
    for cache in caches:
        for it, z, ct in cache.entries():
            series[
                metrics.series_key(
                    {"instance_type": it, "zone": z, "capacity_type": ct}
                )
            ] = 1.0
    metrics.RPC_OFFERING_UNAVAILABLE.replace_series(series)


def _track_for_gauge(cache: "UnavailableOfferings") -> None:
    global _refresher_registered
    from . import metrics

    with _gauge_lock:
        _live_caches.add(cache)
        if not _refresher_registered:
            metrics.REGISTRY.add_refresher(publish_offering_gauge)
            _refresher_registered = True
