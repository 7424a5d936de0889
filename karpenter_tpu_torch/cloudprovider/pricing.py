"""Pricing provider: live per-(type, zone) spot prices with static fallback.

Rebuild of the reference's pricing subsystem
(upstream ``pkg/providers/pricing/pricing.go``): on-demand prices from
the pricing API refreshed slowly (``:177-283``, 12h), spot prices per
(instance type, zone) refreshed fast (``:381-437``, 1h), and a generated
static price table as the fallback when the API is unreachable
(``zz_generated.pricing.go``, loaded at ``pricing.go:85``).

The fake backend has no pricing API; refreshes advance a deterministic
random walk per (type, zone) — enough to drive everything the reference's
live prices drive: price-ordered launch choices, consolidation-on-price-drop,
and cache invalidation through a monotonically increasing ``version`` seqnum
(the analogue of the reference's cache-key seqnums).
"""

from __future__ import annotations

import hashlib
import math
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..api import labels as wk
from .types import InstanceType

SPOT_REFRESH_INTERVAL = 3600.0  # pricing.go:64 spot updates hourly
ON_DEMAND_REFRESH_INTERVAL = 12 * 3600.0  # on-demand updates 12-hourly


def _walk(name: str, zone: str, tick: int) -> float:
    """Deterministic multiplicative drift in [0.75, 1.25] for a given tick —
    the fake's stand-in for the spot market moving between refreshes."""
    h = hashlib.blake2s(f"{name}|{zone}|{tick}".encode(), digest_size=8).digest()
    u = int.from_bytes(h, "big") / float(1 << 64)
    return 0.75 + 0.5 * u


class PricingProvider:
    """Price book over a catalog: static fallback + refreshable live prices."""

    def __init__(self, catalog: Sequence[InstanceType]):
        self._lock = threading.Lock()
        self._tick = 0
        self._od_tick = 0
        self.version = 0  # seqnum: bumps on every successful refresh
        self.api_available = True  # fake outage switch
        self.last_spot_update: float = 0.0
        self.last_od_update: float = 0.0
        self._set_fallback(catalog)

    def _set_fallback(self, catalog: Sequence[InstanceType]) -> None:
        """(Re)build the static fallback tables from a catalog — captured the
        way the reference bakes zz_generated.pricing.go at codegen time —
        and reset live prices onto them. Callers hold the lock or own init."""
        self._fallback_od: Dict[str, float] = {}
        self._fallback_spot: Dict[Tuple[str, str], float] = {}
        for it in catalog:
            for o in it.offerings:
                if o.capacity_type == wk.CAPACITY_TYPE_ON_DEMAND:
                    self._fallback_od[it.name] = o.price
                else:
                    self._fallback_spot[(it.name, o.zone)] = o.price
        self._od: Dict[str, float] = dict(self._fallback_od)
        self._spot: Dict[Tuple[str, str], float] = dict(self._fallback_spot)

    # -- lookups (pricing.go OnDemandPrice/SpotPrice) -----------------------
    def on_demand_price(self, instance_type: str) -> Optional[float]:
        with self._lock:
            return self._od.get(instance_type, self._fallback_od.get(instance_type))

    def spot_price(self, instance_type: str, zone: str) -> Optional[float]:
        with self._lock:
            key = (instance_type, zone)
            return self._spot.get(key, self._fallback_spot.get(key))

    def price(self, instance_type: str, zone: str, capacity_type: str) -> Optional[float]:
        if capacity_type == wk.CAPACITY_TYPE_SPOT:
            return self.spot_price(instance_type, zone)
        return self.on_demand_price(instance_type)

    # -- refresh loops (pricing.go:177-283 od, :381-437 spot) ---------------
    def update_spot_prices(self, now: float = 0.0) -> bool:
        """One spot refresh: every (type, zone) pair re-quotes around its
        fallback anchor. Returns False (prices untouched — the fallback/last
        table keeps serving) when the pricing API is down, as the reference
        does on DescribeSpotPriceHistory errors."""
        if not self.api_available:
            return False
        with self._lock:
            self._tick += 1
            for key, anchor in self._fallback_spot.items():
                self._spot[key] = round(anchor * _walk(key[0], key[1], self._tick), 6)
            self.version += 1
            self.last_spot_update = now
        return True

    def update_on_demand_prices(self, now: float = 0.0) -> bool:
        if not self.api_available:
            return False
        with self._lock:
            # on-demand moves far less than spot: +-2% around the anchor.
            # Its own tick — consecutive OD refreshes must re-quote, not
            # replay the last spot generation's walk.
            self._od_tick += 1
            for name, anchor in self._fallback_od.items():
                drift = _walk(name, "od", self._od_tick)
                self._od[name] = round(anchor * (0.98 + 0.04 * (drift - 0.75) / 0.5), 6)
            self.version += 1
            self.last_od_update = now
        return True

    def set_spot_price(self, instance_type: str, zone: str, price: float) -> None:
        """Test/injection hook: pin one spot price (and invalidate caches)."""
        with self._lock:
            self._spot[(instance_type, zone)] = price
            self.version += 1

    def set_on_demand_price(self, instance_type: str, price: float) -> None:
        """Test/injection hook: pin one on-demand price (and invalidate caches)."""
        with self._lock:
            self._od[instance_type] = price
            self.version += 1

    def reset_to_fallback(self) -> None:
        with self._lock:
            self._od = dict(self._fallback_od)
            self._spot = dict(self._fallback_spot)
            self.version += 1

    def reload(self, catalog: Sequence[InstanceType]) -> None:
        """Re-anchor on a new catalog IN PLACE — object identity is preserved
        so controllers holding a reference (PricingController) keep driving
        the live price book after a catalog swap."""
        with self._lock:
            self._set_fallback(catalog)
            self.version += 1


@dataclass(frozen=True)
class PoolQuote:
    """The live view of one capacity pool: what it costs right now and how
    likely the cloud is to take it back. ``risk_cost(penalty)`` is the
    expected-interruption term the solver adds to the price objective."""

    instance_type: str
    zone: str
    capacity_type: str
    price: Optional[float]
    interruption_probability: float

    def risk_cost(self, penalty: float) -> float:
        return self.interruption_probability * penalty


class CapacityPoolProvider:
    """Joins the live price book with the interruption-risk cache into one
    per-pool quote surface — the capacity-pool abstraction the providers
    stamp onto offerings. ``version`` covers both inputs, so any
    price-refresh OR risk write invalidates downstream seqnum-keyed
    instance-type caches exactly like the ICE seqnum does."""

    def __init__(self, pricing: PricingProvider, risk=None):
        self.pricing = pricing
        self.risk = risk  # Optional[InterruptionRiskCache]; None = risk off

    @property
    def version(self) -> int:
        return self.pricing.version + (self.risk.version if self.risk is not None else 0)

    def probability(self, instance_type: str, zone: str, capacity_type: str) -> float:
        if self.risk is None:
            return 0.0
        return self.risk.probability(instance_type, zone, capacity_type)

    def quote(self, instance_type: str, zone: str, capacity_type: str) -> PoolQuote:
        return PoolQuote(
            instance_type=instance_type,
            zone=zone,
            capacity_type=capacity_type,
            price=self.pricing.price(instance_type, zone, capacity_type),
            interruption_probability=self.probability(
                instance_type, zone, capacity_type
            ),
        )


class PricingController:
    """Refresh cadence loop (the reference runs pricing.Provider's
    updateSpotPricing/updateOnDemandPricing on tickers inside its controller
    manager; here the operator's slow loop calls reconcile)."""

    def __init__(self, pricing: PricingProvider, clock=None):
        import time as _time

        self.pricing = pricing
        self._now = clock or (lambda: _time.monotonic())

    def reconcile(self) -> List[str]:
        now = self._now() if callable(self._now) else self._now.now()
        updated = []
        if now - self.pricing.last_spot_update >= SPOT_REFRESH_INTERVAL:
            if self.pricing.update_spot_prices(now):
                updated.append("spot")
        if now - self.pricing.last_od_update >= ON_DEMAND_REFRESH_INTERVAL:
            if self.pricing.update_on_demand_prices(now):
                updated.append("on-demand")
        return updated
