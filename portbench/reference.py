"""The plain reference: NumPy checks of a plan against the raw inputs, and
the benchmark's own lower bound on a problem's cost. It imports nothing of
the program and reads only the raw records and the plan.

``lower_bound`` is a frozen copy of the per-axis fractional covering bound
(``karpenter_tpu_torch/solver/bounds.py:29-56``, ``fractional_lower_bound``),
worked from the raw counts and catalog records instead of the program's
encoded arrays.

A plan is handed in as plain data: ``nodes`` is a list of ``(pool, type,
zone, capacity type, price, [pod names])`` and ``unplaced`` the names the
program reported unschedulable.
"""

from __future__ import annotations

import numpy as np

from . import catalog as cat

AXES = ("cpu", "memory", "pods")
#: the numbers a check compares that add up over problems; the others
#: (``cost_gap``) take the worst
SUMMED = ("misplaced", "over_alloc", "bad_nodes", "encode_gap")
#: the share of an axis by which a node may exceed its allocatable through
#: float32 rounding: the program packs in normalized float32 and states this
#: allowance (``CAP_RTOL`` in ``karpenter_tpu_torch/solver/validate.py``)
ROUNDING = 5e-4
#: the limits of the numbers the check compares (PERF.md gives the readings
#: each was set from)
LIMITS = {"misplaced": 0, "over_alloc": 0, "bad_nodes": 0, "encode_gap": 0, "cost_gap": 1e-6}


class Catalog:
    """The records, indexed: allocatable per type in the demand's units
    (millicores, bytes, pods) and the price of each offering."""

    def __init__(self, records):
        self.alloc = {}
        self.capacity = {}
        self.price = {}
        for rec in records:
            a = cat.allocatable(rec, AXES)
            self.alloc[rec["name"]] = np.array([a[0] * 1000.0, a[1], a[2]], dtype=np.float64)
            c = [rec["capacity"].get(k, 0.0) for k in AXES]
            self.capacity[rec["name"]] = np.array([c[0] * 1000.0, c[1], c[2]], dtype=np.float64)
            for zone, ct, price in rec["offerings"]:
                self.price[(rec["name"], zone, ct)] = float(price)
        names = list(self.alloc)
        self._alloc = np.stack([self.alloc[n] for n in names])
        self._best = [min(p for (t, _, _), p in self.price.items() if t == n) for n in names]

    def lower_bound(self, counts: np.ndarray, demand: np.ndarray) -> float:
        """The fractional covering bound of one problem: for each axis the
        total demand priced at the cheapest rate any offering gives for
        that axis, the largest over the axes."""
        total = (demand.astype(np.float64) * counts[:, None]).sum(axis=0)
        prices = np.array(self._best)
        best = 0.0
        for r in range(len(AXES)):
            caps = self._alloc[:, r]
            ok = caps > 0
            if not np.any(ok) or total[r] <= 0:
                continue
            best = max(best, float(total[r] * np.min(prices[ok] / caps[ok])))
        return best

    def per_node(self, demand: np.ndarray, table: str = "alloc") -> tuple:
        """The reference packer's choice for each deployment: the type with
        the lowest price a pod, where a node holds ``k`` pods, the fewest
        any axis of the type's ``table`` (``alloc``: allocatable;
        ``capacity``: the whole machine) holds. Returns (type index a
        deployment, ``k`` a deployment, best offering a type)."""
        names = list(self.alloc)
        room = np.stack([getattr(self, table)[n] for n in names])
        best = {}
        for (t, z, ct), p in self.price.items():
            if t not in best or p < best[t][0]:
                best[t] = (p, z, ct)
        price = np.array([best[n][0] for n in names])
        k = np.floor(room[None, :, :] / demand[:, None, :]).min(axis=2).astype(np.int64)
        j = np.argmin(np.where(k >= 1, price / np.maximum(k, 1), np.inf), axis=1)
        return j, k[np.arange(len(demand)), j], [best[n] for n in names]

    def shapes(self, counts: np.ndarray, demand: np.ndarray) -> tuple:
        """A problem's (G, O, S) for the roofline, from its raw counts
        alone: G the distinct request shapes with pods, O the offerings a
        pool may launch, S the nodes of the reference packer's plan at
        allocatable. Nothing the program plans enters them."""
        live = counts > 0
        _, k, _ = self.per_node(demand)
        G = len({tuple(row) for row in demand[live].tolist()})
        return G, len(self.price), int(np.ceil(counts[live] / k[live]).sum())


def check_plan(catalog: Catalog, pods: dict, demand: np.ndarray, pool: str, nodes,
               unplaced, reported_cost: float) -> dict:
    """One problem's plan against its raw pods (name -> deployment):
    ``misplaced`` counts pods not placed exactly once and placements of
    unknown pods; ``over_alloc`` counts nodes whose pods exceed their type's
    allocatable on some axis by more than ``ROUNDING`` of it;
    ``bad_nodes`` counts nodes on another pool or on an offering the
    catalog lacks; ``cost_gap`` is the reported $/h's distance from the
    catalog's prices of the plan's nodes, as a share of the latter."""
    seen = dict.fromkeys(pods, 0)
    unknown = 0
    over = 0
    bad = 0
    priced = 0.0
    for node_pool, itype, zone, ct, _price, names in nodes:
        price = catalog.price.get((itype, zone, ct))
        if price is None or node_pool != pool:
            bad += 1
        else:
            priced += price
        per_dep = np.zeros(len(demand), dtype=np.int64)
        for name in names:
            d = pods.get(name)
            if d is None:
                unknown += 1
                continue
            seen[name] += 1
            per_dep[d] += 1
        used = per_dep @ demand
        alloc = catalog.alloc.get(itype)
        if alloc is None:
            continue
        over += int(np.any(used > alloc * (1 + ROUNDING)))
    counts = np.fromiter(seen.values(), dtype=np.int64, count=len(seen))
    misplaced = int((counts != 1).sum()) + unknown
    gap = abs(reported_cost - priced) / priced if priced > 0 else float(reported_cost != 0)
    return {"misplaced": misplaced, "over_alloc": over, "bad_nodes": bad,
            "cost_gap": gap}


def encode_gap(pods: dict, demand: np.ndarray, groups) -> int:
    """The program's encode against the raw pods: ``groups`` is a list of
    (cpu cores, memory bytes, count) the program encoded. Pods of the same
    requests form one group; the gap is the sum over request shapes of the
    difference in pod counts."""
    want: dict = {}
    per_dep = np.bincount(np.fromiter(pods.values(), dtype=np.int64, count=len(pods)),
                          minlength=len(demand))
    for d, n in enumerate(per_dep):
        if n:
            key = (int(demand[d, 0]), int(demand[d, 1]))
            want[key] = want.get(key, 0) + int(n)
    got: dict = {}
    for cpu, mem, n in groups:
        key = (int(round(cpu * 1000)), int(round(mem)))
        got[key] = got.get(key, 0) + int(n)
    return sum(abs(want.get(k, 0) - got.get(k, 0)) for k in set(want) | set(got))


def merge(total: dict, one: dict) -> dict:
    """Fold one problem's numbers into a run's: counts add, shares take the worst."""
    for k, v in one.items():
        total[k] = total.get(k, 0) + v if k in SUMMED else max(total.get(k, 0.0), v)
    return total
