"""Subnet provider: zonal selection by free IPs with in-flight accounting.

Rebuild of the reference's subnet provider
(upstream ``pkg/providers/subnet/subnet.go``): ``ZonalSubnetsForLaunch``
(``:90``) picks, per zone, the subnet with the most available IPs among the
template's resolved subnets; ``UpdateInflightIPs`` (``:129``) deducts IPs for
launches the cloud's subnet describe hasn't observed yet, so a burst of
launches can't oversubscribe a small subnet between refreshes. A refresh
(the reference re-describes subnets on its poll) reconciles the counters
against ground truth and clears the in-flight set.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

from .interface import InsufficientCapacityError, Subnet


class SubnetProvider:
    def __init__(self, subnets: Sequence[Subnet]):
        self._lock = threading.Lock()
        self._subnets: Dict[str, Subnet] = {s.id: s for s in subnets}
        self._inflight: Dict[str, int] = {}  # subnet id -> IPs consumed unrefreshed

    def all(self) -> List[Subnet]:
        return list(self._subnets.values())

    def free_ips(self, subnet_id: str) -> int:
        with self._lock:
            s = self._subnets.get(subnet_id)
            if s is None:
                return 0
            return max(s.available_ips - self._inflight.get(subnet_id, 0), 0)

    def zonal_subnet_for_launch(
        self, zone: str, eligible_ids: Optional[Sequence[str]] = None, need_ips: int = 1
    ) -> Subnet:
        """The most-free-IP subnet in ``zone`` among ``eligible_ids`` (all
        known subnets when None), atomically reserving ``need_ips`` in-flight
        IPs. Raises InsufficientCapacityError when no eligible subnet in the
        zone has enough free IPs (subnet.go:90 + the launch path's
        fleet-error mapping)."""
        with self._lock:
            pool = [
                s
                for s in self._subnets.values()
                if s.zone == zone and (eligible_ids is None or s.id in eligible_ids)
            ]
            best: Optional[Subnet] = None
            best_free = -1
            for s in pool:
                free = s.available_ips - self._inflight.get(s.id, 0)
                if free > best_free:
                    best, best_free = s, free
            if best is None or best_free < need_ips:
                raise InsufficientCapacityError(
                    f"no subnet in {zone} has {need_ips} free IPs",
                    reason="ip-exhaustion",
                )
            self._inflight[best.id] = self._inflight.get(best.id, 0) + need_ips
            return best

    def release_inflight(self, subnet_id: str, n: int = 1) -> None:
        """Give back a reservation whose launch failed before consuming IPs."""
        with self._lock:
            cur = self._inflight.get(subnet_id, 0)
            if cur <= n:
                self._inflight.pop(subnet_id, None)
            else:
                self._inflight[subnet_id] = cur - n

    def commit(self, subnet_id: str, n: int = 1) -> None:
        """A reserved launch materialized: the cloud's count now reflects it,
        so move the consumption from in-flight to the describe-backed number
        (UpdateInflightIPs' removal path, subnet.go:129-185)."""
        with self._lock:
            s = self._subnets.get(subnet_id)
            if s is not None:
                s.available_ips = max(s.available_ips - n, 0)
            cur = self._inflight.get(subnet_id, 0)
            if cur <= n:
                self._inflight.pop(subnet_id, None)
            else:
                self._inflight[subnet_id] = cur - n

    def release_ip(self, subnet_id: str, n: int = 1) -> None:
        """Instance terminated: its IPs return to the subnet."""
        with self._lock:
            s = self._subnets.get(subnet_id)
            if s is not None:
                s.available_ips += n

    def refresh(self) -> None:
        """Drop stale in-flight reservations (a crashed launch never commits);
        the reference's periodic subnet describe serves the same role."""
        with self._lock:
            self._inflight.clear()
