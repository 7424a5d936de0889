"""CostLedger: continuous spend metering with conservation-checked attribution.

Every optimizing layer of this system reasons about dollars — risk-priced
objectives, consolidation savings estimates, preempt-or-launch verdicts,
federation marginal-price routing — but none of them METER realized spend.
This module is the money layer of the observability stack (metrics → traces
→ capsules → latency → cost): it integrates node-seconds × offering price
continuously from cluster-state watch events and attributes every metered
dollar to the consumers that incurred it.

Mechanics:

* a node's meter opens at watch ``ADDED`` and closes at ``DELETED``; the
  price is PINNED from the launch-time offering triple
  (``Node.capacity_pool()`` → ``PricingProvider.price``) together with the
  on-demand sticker price for the same instance type, so later price-book
  refreshes never rewrite history;
* the meter is segmented on residency changes: any pod bind/unbind against
  a tracked node closes the node's open segment at the pre-change resident
  set before the set mutates. Within a segment, dollars split by each
  resident pod's **dominant-resource share** of node allocatable
  (max over resources of request/allocatable — the DRF numerator), shares
  normalized when oversubscribed, and the un-requested remainder lands on
  the explicit ``(idle)`` consumer. The idle share is computed as
  ``segment_dollars - Σ pod_shares`` — conservation holds BY CONSTRUCTION,
  not by reconciliation;
* attribution is simultaneously rolled up per-provisioner, per-cell
  (provisioner/zone), per-gang (``Pod.pod_group()``; ``-`` for standalone
  pods) and per-pod (the per-tenant seam; bounded by eviction into an
  ``(evicted)`` aggregate so the map cannot grow without bound);
* counterfactual streams ride the same segments: every segment also accrues
  at the on-demand sticker rate, so ``spot savings = on-demand − metered``
  is a live gauge; executed consolidation ``PlannedAction.savings`` ($/hr)
  accrue as bounded-horizon rate streams; interruption reclaims charge the
  ``interruption_penalty_cost`` restart tax plus the re-launch price delta.

The ledger is wall-clock agnostic (injectable clock) and settles lazily:
``settle()`` closes every open segment at "now" and is called before every
scrape (metrics refresher), every ``/debug/costs`` render, and every
federation summary — so readers always see fully-attributed totals.

``round_cost_delta`` is the capsule-facing PURE function: given the round's
launched nodes and a price book it derives the round's spend-rate delta with
no ledger state at all, so flight-recorder capture and offline replay
(including ``--override offerings=...=price:`` counterfactuals) reproduce it
byte-identically from capsule inputs alone.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

from ..api import labels as wk

#: per-pod attribution map bound: beyond this many tracked pods the
#: smallest-spend entries collapse into the ``(evicted)`` aggregate (the
#: dollars are conserved; only the per-pod resolution is dropped)
POD_ROLLUP_CAP = 4096

#: idle/residual consumer key in the gang/pod partitions
IDLE = "(idle)"
#: eviction aggregate in the per-pod partition
EVICTED = "(evicted)"
#: gang bucket for pods that belong to no gang
NO_GANG = "-"

#: conservation tolerance: partitions accumulate the same per-segment
#: dollars in different dict orders, so they agree up to f64 associativity
CONSERVATION_TOL = 1e-6


def _dominant_share(requests, allocatable) -> float:
    """Dominant-resource fraction of ``allocatable`` claimed by ``requests``
    (the DRF numerator): max over resources of request/allocatable, clamped
    to [0, 1]. Resources the node does not expose contribute nothing."""
    share = 0.0
    for name, req in requests.items():
        if req <= 0:
            continue
        alloc = allocatable.get(name, 0.0)
        if alloc > 0:
            share = max(share, req / alloc)
    return min(share, 1.0)


def round_cost_delta(nodes, pricing) -> Dict:
    """PURE per-round cost delta for flight-recorder capsules: the spend
    rate the round's launched nodes add, at the actual offering price and at
    the on-demand counterfactual, per capacity type. Deterministic given the
    same nodes + price book (sorted keys, fixed rounding) — capture computes
    it from the live catalog, replay from the capsule catalog, and the two
    must agree byte-for-byte because the capsule's instance-type wires carry
    the capture-time prices."""
    actual = ondemand = 0.0
    per_ct: Dict[str, float] = {}
    for node in nodes:
        it, zone, ct = node.capacity_pool()
        price = pricing.price(it, zone, ct)
        price = float(price) if price is not None else 0.0
        od = pricing.on_demand_price(it)
        od = float(od) if od is not None else price
        actual += price
        ondemand += od
        per_ct[ct] = per_ct.get(ct, 0.0) + price
    return {
        "nodes": len(list(nodes)),
        "actual_per_hr": round(actual, 6),
        "ondemand_per_hr": round(ondemand, 6),
        "savings_per_hr": round(ondemand - actual, 6),
        "per_capacity_type": {
            ct: round(v, 6) for ct, v in sorted(per_ct.items())
        },
    }


@dataclass
class _NodeMeter:
    """One tracked node: pinned identity + the open segment's state."""

    name: str
    instance_type: str
    zone: str
    capacity_type: str
    provisioner: str
    price: float      # $/hr, pinned at ADDED from the offering triple
    od_price: float   # $/hr on-demand sticker for the same instance type
    allocatable: Dict[str, float]
    seg_start: float
    #: resident pod -> (dominant share, gang)
    residents: Dict[str, Tuple[float, str]] = field(default_factory=dict)


@dataclass
class _RateStream:
    """A bounded-horizon $/hr stream (consolidation savings, re-launch
    deltas): accrues into ``bucket`` until ``until``; settle() advances
    ``accrued_to`` and drops the stream once the horizon passes."""

    rate_per_hr: float
    accrued_to: float
    until: float
    bucket: str  # "consolidation" | "relaunch_delta"


class CostLedger:
    """Meters realized spend from cluster watch events and attributes it.

    Thread-safe: watch callbacks (informer threads), the metrics refresher
    (scrape thread) and debug/federation readers all serialize on one lock.
    """

    def __init__(self, cluster, pricing, settings=None, clock=None,
                 window_s: Optional[float] = None):
        self.cluster = cluster
        self.pricing = pricing
        self.settings = settings
        self.clock = clock
        if window_s is None:
            window_s = getattr(settings, "cost_ledger_window_s", 3600.0)
        self.window_s = float(window_s)
        self._lock = threading.RLock()
        self._meters: Dict[str, _NodeMeter] = {}
        self._pod_node: Dict[str, str] = {}  # resident pod -> node name
        # cumulative partitions (dollars); each accumulates the SAME
        # per-segment dollars, so each sums to total up to f64 associativity
        self.total_dollars = 0.0
        self.ondemand_dollars = 0.0
        self.by_provisioner: Dict[str, float] = {}
        self.by_provisioner_ct: Dict[Tuple[str, str], float] = {}
        self.by_cell: Dict[str, float] = {}
        self.by_gang: Dict[str, float] = {}
        self.by_pod: Dict[str, Dict] = {}  # pod -> {dollars, gang, provisioner}
        # counterfactual / savings / loss streams (cumulative dollars)
        self.savings_spot = 0.0
        self.savings_consolidation = 0.0
        self.loss_restart_tax = 0.0
        self.loss_relaunch = 0.0
        self.reclaims = 0
        self.consolidation_actions = 0
        self._streams: List[_RateStream] = []
        # windowed burn-rate samples: (t, total, ondemand) cumulative marks
        self._window: Deque[Tuple[float, float, float]] = deque()
        self._last_sample_t: Optional[float] = None
        self._attached = False
        self._registered_refresher = False

    # -- wiring --------------------------------------------------------------
    def attach(self) -> "CostLedger":
        """Register the watch callback and seed meters from current state
        (nodes that predate the ledger meter from attach time — their
        earlier life is unobservable and stays unmetered, not guessed)."""
        if not self._attached:
            self._attached = True
            self.cluster.watch(self._on_event)
            with self._lock:
                self._resync(self._now())
        return self

    def register_refresher(self, registry) -> None:
        """Pre-scrape hook: settle, then atomically publish the bounded-label
        series (the ``publish_offering_gauge`` idiom)."""
        if not self._registered_refresher:
            self._registered_refresher = True
            registry.add_refresher(self.publish_metrics)

    def _now(self) -> float:
        if self.clock is not None:
            return self.clock.now()
        import time

        return time.time()

    # -- watch intake --------------------------------------------------------
    def _on_event(self, event: str, obj) -> None:
        from ..api.objects import Node, Pod

        with self._lock:
            now = self._now()
            if event == "RESYNCED":
                self._resync(now)
                return
            if isinstance(obj, Node):
                if event == "ADDED":
                    self._open_meter(obj, now)
                elif event == "DELETED":
                    self._close_meter(obj.meta.name, now)
            elif isinstance(obj, Pod):
                self._on_pod(event, obj, now)

    def _pin_prices(self, node) -> Tuple[float, float]:
        it, zone, ct = node.capacity_pool()
        try:
            price = self.pricing.price(it, zone, ct)
        except Exception:
            price = None
        try:
            od = self.pricing.on_demand_price(it)
        except Exception:
            od = None
        price = float(price) if price is not None else 0.0
        od = float(od) if od is not None else price
        return price, od

    def _open_meter(self, node, now: float) -> None:
        name = node.meta.name
        if name in self._meters:
            return
        it, zone, ct = node.capacity_pool()
        price, od = self._pin_prices(node)
        alloc = {k: float(v) for k, v in node.allocatable.items()}
        meter = _NodeMeter(
            name=name, instance_type=it, zone=zone, capacity_type=ct,
            provisioner=node.provisioner_name() or "", price=price,
            od_price=od, allocatable=alloc, seg_start=now,
        )
        # adopt pods already bound to the node (bind events can precede the
        # node ADD when a relist interleaves them)
        for pod in self.cluster.pods_on_node(name):
            meter.residents[pod.meta.name] = (
                _dominant_share(pod.requests, alloc),
                pod.pod_group() or NO_GANG,
            )
            self._pod_node[pod.meta.name] = name
        self._meters[name] = meter

    def _close_meter(self, name: str, now: float) -> None:
        meter = self._meters.pop(name, None)
        if meter is None:
            return
        self._accrue_segment(meter, now)
        for pod in meter.residents:
            self._pod_node.pop(pod, None)

    def _on_pod(self, event: str, pod, now: float) -> None:
        name = pod.meta.name
        prev_node = self._pod_node.get(name)
        next_node = None if event == "DELETED" else pod.node_name
        if prev_node == next_node:
            return
        if prev_node is not None:
            meter = self._meters.get(prev_node)
            if meter is not None and name in meter.residents:
                self._accrue_segment(meter, now)
                meter.residents.pop(name, None)
            self._pod_node.pop(name, None)
        if next_node is not None:
            meter = self._meters.get(next_node)
            if meter is not None:
                self._accrue_segment(meter, now)
                meter.residents[name] = (
                    _dominant_share(pod.requests, meter.allocatable),
                    pod.pod_group() or NO_GANG,
                )
                self._pod_node[name] = next_node

    def _resync(self, now: float) -> None:
        """Reconcile tracked meters against the relisted cache: nodes that
        vanished inside the outage window close at the resync point (their
        exact deletion time is unobservable); new nodes open; residency
        rebuilds from the relisted pod set."""
        live = dict(self.cluster.nodes)
        for name in [n for n in self._meters if n not in live]:
            self._close_meter(name, now)
        for name, node in live.items():
            if name not in self._meters:
                self._open_meter(node, now)
        # rebuild residency (binds that happened inside the outage window)
        by_node: Dict[str, List] = {}
        for pod in self.cluster.pods.values():
            if pod.node_name is not None:
                by_node.setdefault(pod.node_name, []).append(pod)
        for name, meter in self._meters.items():
            current = {p.meta.name for p in by_node.get(name, [])}
            if current != set(meter.residents):
                self._accrue_segment(meter, now)
                for gone in set(meter.residents) - current:
                    self._pod_node.pop(gone, None)
                meter.residents = {
                    p.meta.name: (
                        _dominant_share(p.requests, meter.allocatable),
                        p.pod_group() or NO_GANG,
                    )
                    for p in by_node.get(name, [])
                }
                for p in by_node.get(name, []):
                    self._pod_node[p.meta.name] = name

    # -- accrual (the conservation core) ------------------------------------
    def _accrue_segment(self, meter: _NodeMeter, now: float) -> None:
        """Close the node's open segment at ``now`` and attribute it. Every
        partition receives the SAME ``dollars``; the pod/gang split charges
        shares and pushes the exact remainder onto ``(idle)`` — conservation
        is arithmetic identity, not a reconciliation pass."""
        dt_hr = max(0.0, now - meter.seg_start) / 3600.0
        meter.seg_start = now
        if dt_hr == 0.0:
            return
        dollars = meter.price * dt_hr
        od_dollars = meter.od_price * dt_hr
        self.total_dollars += dollars
        self.ondemand_dollars += od_dollars
        prov = meter.provisioner
        self.by_provisioner[prov] = self.by_provisioner.get(prov, 0.0) + dollars
        ct_key = (prov, meter.capacity_type)
        self.by_provisioner_ct[ct_key] = (
            self.by_provisioner_ct.get(ct_key, 0.0) + dollars
        )
        cell = f"{prov}/{meter.zone}"
        self.by_cell[cell] = self.by_cell.get(cell, 0.0) + dollars
        if meter.capacity_type == wk.CAPACITY_TYPE_SPOT:
            self.savings_spot += od_dollars - dollars
        # pod shares: normalize only when oversubscribed; exact remainder → idle
        total_frac = sum(frac for frac, _ in meter.residents.values())
        scale = 1.0 / total_frac if total_frac > 1.0 else 1.0
        attributed = 0.0
        for pod_name, (frac, gang) in meter.residents.items():
            share = dollars * frac * scale
            attributed += share
            self.by_gang[gang] = self.by_gang.get(gang, 0.0) + share
            ent = self.by_pod.get(pod_name)
            if ent is None:
                ent = self.by_pod[pod_name] = {
                    "dollars": 0.0, "gang": gang, "provisioner": prov,
                }
            ent["dollars"] += share
            ent["gang"] = gang
            ent["provisioner"] = prov
        idle = dollars - attributed
        if idle != 0.0:
            self.by_gang[IDLE] = self.by_gang.get(IDLE, 0.0) + idle
            ent = self.by_pod.get(IDLE)
            if ent is None:
                ent = self.by_pod[IDLE] = {
                    "dollars": 0.0, "gang": IDLE, "provisioner": "",
                }
            ent["dollars"] += idle
        if len(self.by_pod) > POD_ROLLUP_CAP:
            self._evict_pods()

    def _evict_pods(self) -> None:
        """Collapse the smallest-spend per-pod entries into ``(evicted)``:
        the dollars stay in the partition (conservation), only the per-pod
        resolution of the long tail is dropped."""
        keep = POD_ROLLUP_CAP // 2
        victims = sorted(
            (k for k in self.by_pod if k not in (IDLE, EVICTED)),
            key=lambda k: self.by_pod[k]["dollars"],
        )[: max(0, len(self.by_pod) - keep)]
        if not victims:
            return
        agg = self.by_pod.get(EVICTED)
        if agg is None:
            agg = self.by_pod[EVICTED] = {
                "dollars": 0.0, "gang": EVICTED, "provisioner": "",
            }
        for k in victims:
            agg["dollars"] += self.by_pod.pop(k)["dollars"]

    # -- savings / loss streams ---------------------------------------------
    def note_consolidation(self, action, now: Optional[float] = None) -> None:
        """An EXECUTED deprovisioning action: its ``savings`` ($/hr
        reclaimed) accrues as realized consolidation savings for one ledger
        window — past that horizon the fleet has churned and the claim would
        be stale, so the stream expires rather than compounds forever."""
        if action is None or not getattr(action, "savings", 0.0):
            return
        with self._lock:
            t = self._now() if now is None else now
            self.consolidation_actions += 1
            self._streams.append(_RateStream(
                rate_per_hr=float(action.savings), accrued_to=t,
                until=t + self.window_s, bucket="consolidation",
            ))

    def note_reclaim(self, pool: Tuple[str, str, str],
                     now: Optional[float] = None) -> None:
        """An exactly-once spot reclaim: charge the restart tax (the same
        ``interruption_penalty_cost`` the risk-priced objective uses, so the
        solver's assumed cost and the ledger's realized cost reconcile)."""
        with self._lock:
            self.reclaims += 1
            tax = float(getattr(self.settings, "interruption_penalty_cost", 10.0))
            self.loss_restart_tax += tax

    def note_relaunch(self, old_price_per_hr: float, new_price_per_hr: float,
                      now: Optional[float] = None) -> None:
        """A replacement launched for reclaimed/rebalanced capacity: any
        price regression (new > old) accrues as an interruption loss stream
        over one ledger window."""
        delta = float(new_price_per_hr) - float(old_price_per_hr)
        if delta <= 0:
            return
        with self._lock:
            t = self._now() if now is None else now
            self._streams.append(_RateStream(
                rate_per_hr=delta, accrued_to=t, until=t + self.window_s,
                bucket="relaunch_delta",
            ))

    def _advance_streams(self, now: float) -> None:
        live: List[_RateStream] = []
        for s in self._streams:
            upto = min(now, s.until)
            if upto > s.accrued_to:
                accrued = s.rate_per_hr * (upto - s.accrued_to) / 3600.0
                if s.bucket == "consolidation":
                    self.savings_consolidation += accrued
                else:
                    self.loss_relaunch += accrued
                s.accrued_to = upto
            if now < s.until:
                live.append(s)
        self._streams = live

    # -- settle / readers ----------------------------------------------------
    def settle(self, now: Optional[float] = None) -> float:
        """Close every open segment and advance rate streams to ``now``;
        every reader calls this first so totals are fully attributed at each
        settle point. Returns the settle time."""
        with self._lock:
            t = self._now() if now is None else now
            for meter in self._meters.values():
                self._accrue_segment(meter, t)
            self._advance_streams(t)
            if self._last_sample_t is None or t - self._last_sample_t >= 1.0:
                self._window.append(
                    (t, self.total_dollars, self.ondemand_dollars)
                )
                self._last_sample_t = t
                cutoff = t - 2.0 * self.window_s
                while len(self._window) > 2 and self._window[0][0] < cutoff:
                    self._window.popleft()
            return t

    def conservation(self) -> Dict:
        """Max absolute disagreement between the partitions and the metered
        total. By construction this is f64 associativity noise; anything
        past ``CONSERVATION_TOL`` (relative) is a real attribution bug."""
        with self._lock:
            total = self.total_dollars
            sums = {
                "provisioner": sum(self.by_provisioner.values()),
                "capacity_type": sum(self.by_provisioner_ct.values()),
                "cell": sum(self.by_cell.values()),
                "gang": sum(self.by_gang.values()),
                "pod": sum(e["dollars"] for e in self.by_pod.values()),
            }
            err = max(
                (abs(s - total) for s in sums.values()), default=0.0
            )
            tol = CONSERVATION_TOL * max(1.0, abs(total))
            return {
                "total_dollars": total,
                "partition_sums": {k: v for k, v in sorted(sums.items())},
                "max_abs_error": err,
                "tolerance": tol,
                "ok": err <= tol,
            }

    def _windowed(self, now: float, window: float) -> Dict:
        """Spend inside the trailing window, from the cumulative marks: the
        delta against the newest mark at or before ``now - window``."""
        base_t, base_total, base_od = None, 0.0, 0.0
        for t, tot, od in self._window:
            if t <= now - window:
                base_t, base_total, base_od = t, tot, od
            else:
                break
        if base_t is None and self._window:
            base_t, base_total, base_od = self._window[0]
        span = (now - base_t) if base_t is not None else 0.0
        d_total = self.total_dollars - base_total
        d_od = self.ondemand_dollars - base_od
        return {
            "window_s": round(min(window, span) if span else window, 3),
            "dollars": round(d_total, 9),
            "ondemand_dollars": round(d_od, 9),
            "burn_per_hr": (
                round(d_total / (span / 3600.0), 6) if span > 0 else 0.0
            ),
        }

    def debug_payload(self, provisioner: Optional[str] = None,
                      cell: Optional[str] = None, gang: Optional[str] = None,
                      window: Optional[float] = None,
                      top_pods: int = 20) -> Dict:
        """The ``/debug/costs`` rollup: cumulative totals, counterfactual
        and savings streams, windowed burn rate, the per-consumer
        partitions (filterable), the conservation verdict, and
        ``/debug/decisions`` cross-links for each consumer row."""
        t = self.settle()
        with self._lock:
            win = float(window) if window else self.window_s
            by_prov = {
                k: round(v, 9) for k, v in sorted(self.by_provisioner.items())
                if provisioner is None or k == provisioner
            }
            by_cell = {
                k: round(v, 9) for k, v in sorted(self.by_cell.items())
                if cell is None or k == cell
            }
            by_gang = {
                k: round(v, 9) for k, v in sorted(self.by_gang.items())
                if gang is None or k == gang
            }
            pods = sorted(
                (
                    (k, e) for k, e in self.by_pod.items()
                    if (provisioner is None or e["provisioner"] == provisioner)
                    and (gang is None or e["gang"] == gang)
                ),
                key=lambda kv: kv[1]["dollars"], reverse=True,
            )[: max(0, int(top_pods))]
            return {
                "time": t,
                "total_dollars": round(self.total_dollars, 9),
                "ondemand_dollars": round(self.ondemand_dollars, 9),
                "savings": {
                    "spot": round(self.savings_spot, 9),
                    "consolidation": round(self.savings_consolidation, 9),
                },
                "losses": {
                    "restart_tax": round(self.loss_restart_tax, 9),
                    "relaunch_delta": round(self.loss_relaunch, 9),
                    "reclaims": self.reclaims,
                },
                "consolidation_actions": self.consolidation_actions,
                "windowed": self._windowed(t, win),
                "by_provisioner": {
                    k: {
                        "dollars": v,
                        "decisions": f"/debug/decisions?q={k}",
                    }
                    for k, v in by_prov.items()
                },
                "by_cell": by_cell,
                "by_gang": {
                    k: {
                        "dollars": v,
                        "decisions": f"/debug/decisions?q={k}",
                    }
                    for k, v in by_gang.items()
                },
                "top_pods": [
                    {
                        "pod": k,
                        "dollars": round(e["dollars"], 9),
                        "gang": e["gang"],
                        "provisioner": e["provisioner"],
                    }
                    for k, e in pods
                ],
                "nodes_metered": len(self._meters),
                "conservation": self.conservation(),
            }

    def federation_fields(self) -> Dict:
        """Realized-burn fields folded into the federation summary so the
        arbiter routes on actual spend, not marginal price alone."""
        t = self.settle()
        with self._lock:
            win = self._windowed(t, self.window_s)
            return {
                "total_dollars": round(self.total_dollars, 6),
                "burn_per_hr": win["burn_per_hr"],
                "savings_dollars": round(
                    self.savings_spot + self.savings_consolidation, 6
                ),
                "loss_dollars": round(
                    self.loss_restart_tax + self.loss_relaunch, 6
                ),
            }

    # -- metrics -------------------------------------------------------------
    def publish_metrics(self) -> None:
        """Pre-scrape refresher: settle, then swap full bounded-label series
        atomically (provisioner × capacity_type for spend; a fixed source
        enum for savings/losses — never pod or node names)."""
        from . import metrics

        self.settle()
        with self._lock:
            cost = {
                metrics.series_key(
                    {"provisioner": prov, "capacity_type": ct}
                ): round(v, 9)
                for (prov, ct), v in self.by_provisioner_ct.items()
            }
            savings = {
                metrics.series_key({"source": "spot"}):
                    round(self.savings_spot, 9),
                metrics.series_key({"source": "consolidation"}):
                    round(self.savings_consolidation, 9),
                metrics.series_key({"source": "interruption_loss"}):
                    round(self.loss_restart_tax + self.loss_relaunch, 9),
            }
        metrics.COST_DOLLARS.replace_series(cost)
        metrics.COST_SAVINGS.replace_series(savings)
