"""Solver backends behind one interface.

``TorchSolver`` is the port's counterpart of the JAX package's ``TPUSolver``
kernel path: pad the encoded problem onto its bucket lattice, run the fused
two-phase portfolio solve (``torch_solver.pack_solve_fused``: three CUDA
kernels on the card, their plain PyTorch versions on the CPU), gate the raw
answer with the count-level validator and decode it. The host race
competitors of the reference are not part of this package yet, so the
kernel answers every round; a problem the tensor path cannot express, or a
kernel plan that fails validation, raises instead of falling back.
"""

from __future__ import annotations

import abc
import math
import time
from typing import List, Optional

import numpy as np
import torch

from .encode import EncodedProblem, sizing_demand
from .result import NameSlice, NewNodeSpec, SolveResult
from .torch_solver import (
    BucketKey,
    bucket_existing,
    bucket_groups,
    bucket_key,
    bucket_options,
    bucket_zones,
    make_orders,
    pack_inputs_from_numpy,
    pack_solve_fused,
    unpack_solve_fused,
)
from .validate import validate_counts


def _next_pow2(n: int, floor: int = 8) -> int:
    return max(floor, 1 << (max(n, 1) - 1).bit_length())


_IBIG = 1 << 30


def _water_fill(count: int, seeds: np.ndarray, avail: np.ndarray) -> np.ndarray:
    """Distribute ``count`` new pods over available zones so final levels
    (seed + new) are as equal as possible — the DoNotSchedule-optimal split
    when domains already hold pods. Returns per-zone quotas summing exactly
    to ``count`` (so a quota-exhausting placement realizes the level set)."""
    Z = seeds.shape[0]
    out = np.zeros(Z, np.int64)
    idx = np.flatnonzero(avail)
    if idx.size == 0 or count <= 0:
        return out
    s = seeds[idx].astype(np.int64)
    order = np.argsort(s, kind="stable")
    ss = s[order]
    n = ss.size
    csum = np.concatenate([[0], np.cumsum(ss)])
    L = None
    for k in range(1, n + 1):
        nxt = ss[k] if k < n else None
        cap = None if nxt is None else k * int(nxt) - int(csum[k])
        if cap is None or cap >= count:
            L = -(-(count + int(csum[k])) // k)  # ceil
            break
    base = np.maximum(L - 1 - ss, 0)
    r = count - int(base.sum())
    new = base.copy()
    bump = np.flatnonzero(ss <= L - 1)[: max(r, 0)]
    new[bump] += 1
    out[idx[order]] = new
    return out


def _zone_quotas(problem: EncodedProblem, n_zones: int) -> np.ndarray:
    """Per-(group, zone) NEW-pod quotas for the kernel: water-filled spread
    targets over cluster-wide seeds, min'd with zone anti-affinity headroom
    (zone_cap minus matching occupancy). IBIG = unlimited."""
    G = problem.G
    quota = np.full((G, n_zones), _IBIG, np.int64)
    if G == 0:
        return quota.astype(np.int32)
    spread = problem.zone_skew > 0
    capped = problem.zone_cap < _IBIG
    if not spread.any() and not capped.any():
        return quota.astype(np.int32)
    # zone availability: any compatible option or existing node in the zone
    avail = np.zeros((G, n_zones), bool)
    for z in range(n_zones):
        opt_in_zone = problem.opt_zone == z
        if opt_in_zone.any():
            avail[:, z] |= problem.compat[:, opt_in_zone].any(axis=1)
        if problem.E:
            ex_in_zone = problem.ex_zone == z
            if ex_in_zone.any():
                avail[:, z] |= problem.ex_compat[:, ex_in_zone].any(axis=1)
    seeds = problem.zone_seed
    occupied = problem.zone_occupied
    families = problem.zone_spread_members or [[] for _ in range(G)]
    done_families: set = set()
    for g in range(G):
        if spread[g]:
            s = (
                seeds[g, :n_zones].astype(np.int64)
                if seeds is not None
                else np.zeros(n_zones, np.int64)
            )
            fam = [m for m in families[g] if m != g]
            if fam:
                # CROSS-GROUP spread: water-fill the family TOTAL and split each
                # zone's cap among members proportionally to their counts, in
                # canonical (sorted) member order, one pass per family
                members = sorted([g] + fam)
                key = tuple(members)
                if key not in done_families:
                    done_families.add(key)
                    total = int(sum(problem.count[m] for m in members))
                    avail_joint = np.any(avail[members], axis=0)
                    joint = _water_fill(total, s, avail_joint)
                    for m, share in zip(
                        members,
                        _split_family_caps(
                            joint, [int(problem.count[m]) for m in members],
                            [avail[m] for m in members],
                        ),
                    ):
                        quota[m] = np.minimum(quota[m], share)
            else:
                quota[g] = np.minimum(
                    quota[g], _water_fill(int(problem.count[g]), s, avail[g])
                )
        if capped[g]:
            occ = (
                occupied[g, :n_zones].astype(np.int64)
                if occupied is not None
                else np.zeros(n_zones, np.int64)
            )
            quota[g] = np.minimum(
                quota[g], np.maximum(int(problem.zone_cap[g]) - occ, 0)
            )
    return np.clip(quota, 0, _IBIG).astype(np.int32)


def _split_family_caps(
    joint: np.ndarray, counts: List[int], avails: List[np.ndarray]
) -> List[np.ndarray]:
    """Split a family's per-zone joint caps among members: floor-proportional
    to each member's count, then top-ups drawn from a SHARED remaining-cap
    pool (so member shares can never sum past the joint cap in any zone).
    Members with fewer available zones top up first."""
    total = sum(counts)
    if total <= 0:
        return [np.zeros_like(joint) for _ in counts]
    shares = [
        np.where(av, (joint * c) // total, 0) for c, av in zip(counts, avails)
    ]
    rem = joint - np.sum(shares, axis=0)
    order = sorted(range(len(counts)), key=lambda i: int(avails[i].sum()))
    for i in order:
        want = counts[i] - int(shares[i].sum())
        if want <= 0:
            continue
        head = np.where(avails[i], rem, 0)
        for z in np.argsort(-head, kind="stable"):
            if want <= 0:
                break
            take = min(int(head[z]), want)
            shares[i][z] += take
            rem[z] -= take
            want -= take
    return shares


class Solver(abc.ABC):
    @abc.abstractmethod
    def solve(self, problem: EncodedProblem) -> SolveResult: ...


class TorchSolver(Solver):
    """The portfolio packing kernel on one device.

    ``device`` defaults to the card: ``TorchSolver()`` raises when CUDA is
    absent rather than running on the CPU. ``device="cpu"`` runs the plain
    PyTorch versions of the kernels (the tests' path)."""

    def __init__(
        self,
        portfolio: int = 8,
        seed: int = 0,
        max_slots: int = 1 << 15,
        device="cuda",
    ):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TorchSolver: CUDA is not available (pass device='cpu' for the CPU)")
        self.portfolio = portfolio
        self.seed = seed
        self.max_slots = max_slots
        self.device = device

    def solve(self, problem: EncodedProblem) -> SolveResult:
        if problem.G == 0:
            return SolveResult(stats={"backend": 1.0})
        if problem.O == 0 and problem.E == 0:
            return SolveResult(
                unschedulable=[p.name for g in problem.groups for p in g.pods],
                stats={"backend": 1.0},
            )
        if problem.rel_unsupported is not None:
            raise NotImplementedError(
                f"constraint shape outside the tensor path: {problem.rel_unsupported}"
            )
        return self._solve_kernel(problem)

    def _solve_kernel(self, problem: EncodedProblem) -> SolveResult:
        t0 = time.perf_counter()
        fields, orders, alphas, looks, rsvs, swaps, s_new, n_zones = self._prepare(problem)
        k = orders.shape[0]
        t1 = time.perf_counter()
        tensors = pack_inputs_from_numpy(
            dict(fields, orders=orders, alphas=alphas, looks=looks, rsvs=rsvs, swaps=swaps),
            self.device,
        )
        unpacked, s_new, passes = self._run_fused(tensors, orders, swaps, s_new, n_zones)
        order, unplaced, costs, exhausted, new_opt, new_active, ys = unpacked
        if not np.isfinite(np.asarray(costs, dtype=np.float64)).all():
            raise RuntimeError("kernel returned non-finite member costs")
        t2 = time.perf_counter()
        violations = validate_counts(problem, order, new_opt, new_active, ys)
        if violations:
            raise RuntimeError(f"kernel plan failed validation: {violations[:5]}")
        t3 = time.perf_counter()
        result = self._decode(problem, order, new_opt, new_active, ys)
        t4 = time.perf_counter()
        # host-clock phases: padding and portfolio construction; upload, the
        # fused passes and their result copies; count-level validation; decode
        result.stats.update(
            prepare_s=t1 - t0, device_s=t2 - t1, validate_s=t3 - t2, decode_s=t4 - t3,
            solve_s=t2 - t0, backend=1.0, fused_passes=float(passes),
        )
        idx = int(np.argmin(costs))
        result.stats["portfolio_phase"] = float(idx >= k)
        result.stats["portfolio_best"] = float(idx % k)
        result.stats["validated_counts"] = 1.0
        result.stats["slots"] = float(s_new)
        result.stats["bucket"] = self._bucket_key(problem, s_new).label()
        return result

    def _run_fused(self, tensors, orders: np.ndarray, swaps: np.ndarray, s_new: int, n_zones: int):
        """The fused solve on ``tensors`` (``pack_inputs_from_numpy`` output),
        doubling the slot budget while members ran out of slots. Returns the
        unpacked result, the slot budget it was solved at and the number of
        fused passes it took."""
        inputs = tensors[0]
        k, Gp, Ep = orders.shape[0], inputs.count.shape[0], inputs.ex_valid.shape[0]
        passes = 0
        while True:
            passes += 1
            buf = pack_solve_fused(*tensors, s_new, n_zones).cpu().numpy()
            unpacked = unpack_solve_fused(buf, k, s_new, Gp, Ep, orders, swaps)
            _, unplaced, _, exhausted, _, _, _ = unpacked
            # grow S only when members actually ran out of slots; leftover pods
            # with free slots are genuinely unschedulable
            if exhausted.any() and unplaced > 0 and s_new < self.max_slots:
                s_new *= 2
                continue
            return unpacked, s_new, passes

    def _bucket_key(self, problem: EncodedProblem, s_new: Optional[int] = None) -> BucketKey:
        return bucket_key(
            problem.G, problem.O, problem.E,
            self._estimate_slots(problem) if s_new is None else s_new,
            max(len(problem.zones), 1), len(problem.resource_axes), self.portfolio,
        )

    # -- encoding to padded arrays --------------------------------------------
    def _prepare(self, problem: EncodedProblem, bucket: Optional[BucketKey] = None):
        """Pad the encoded problem onto its bucket's lattice shape.

        ``bucket`` overrides the lattice dimensions (must dominate the real
        dims): a problem solved on a larger bucket gives the same answer as
        on its natural one. Returns ``(fields, orders, alphas, looks, rsvs,
        swaps, s_new, Zp)`` with ``fields`` the ``PackInputs`` arrays as
        numpy."""
        G, O, E, R = problem.G, problem.O, problem.E, len(problem.resource_axes)
        Gp = bucket.G if bucket else bucket_groups(G)
        Op = bucket.O if bucket else bucket_options(O)
        Ep = bucket.E if bucket else bucket_existing(E)
        n_zones = max(len(problem.zones), 1)
        # padded zone columns carry IBIG quotas and no option or slot maps to
        # them, so a want routed there can never open a node
        Zp = bucket.Z if bucket else bucket_zones(n_zones)

        scale = problem.alloc.max(axis=0) if O else np.ones(R, np.float32)
        if E:
            scale = np.maximum(scale, problem.ex_rem.max(axis=0))
        scale = np.where(scale > 0, scale, 1.0).astype(np.float32)

        demand = np.zeros((Gp, R), np.float32)
        demand[:G] = problem.demand / scale
        count = np.zeros((Gp,), np.int32)
        count[:G] = problem.count
        node_cap = np.full((Gp,), _IBIG, np.int32)
        node_cap[:G] = problem.node_cap
        quota = np.full((Gp, Zp), _IBIG, np.int32)
        quota[:G, :n_zones] = _zone_quotas(problem, n_zones)
        colocate = np.zeros((Gp,), bool)
        colocate[:G] = problem.colocate
        compat = np.zeros((Gp, Op), bool)
        compat[:G, :O] = problem.compat
        alloc = np.zeros((Op, R), np.float32)
        price = np.full((Op,), np.float32(1e30))
        opt_zone = np.zeros((Op,), np.int32)
        opt_valid = np.zeros((Op,), bool)
        ex_rem = np.zeros((Ep, R), np.float32)
        ex_zone = np.zeros((Ep,), np.int32)
        ex_valid = np.zeros((Ep,), bool)
        ex_compat = np.zeros((Gp, Ep), bool)
        if E:
            ex_rem[:E] = problem.ex_rem / scale
            ex_zone[:E] = problem.ex_zone
            ex_valid[:E] = True
            ex_compat[:G, :E] = problem.ex_compat
        alloc[:O] = problem.alloc / scale
        price[:O] = problem.price
        opt_zone[:O] = problem.opt_zone
        opt_valid[:O] = True
        # cross-group relation bits (zeros when inactive: the masks are no-ops)
        rel = {
            name: np.zeros((n,), np.int32)
            for name, n in (
                ("rel_set", Gp), ("rel_host_forbid", Gp), ("rel_host_need", Gp),
                ("rel_zone_forbid", Gp), ("rel_zone_need", Gp),
                ("rel_slot_bits", Ep), ("rel_zone_bits", Zp),
            )
        }
        if problem.rel_set is not None and G:
            for name in ("rel_set", "rel_host_forbid", "rel_host_need",
                         "rel_zone_forbid", "rel_zone_need"):
                rel[name][:G] = getattr(problem, name)
            if E:
                rel["rel_slot_bits"][:E] = problem.rel_slot_bits
            nz = min(n_zones, len(problem.rel_zone_bits))
            rel["rel_zone_bits"][:nz] = problem.rel_zone_bits[:nz]
        # provider node-sizing reserve: hostname-affinity requirers can only
        # live on their providers' nodes, so the providers' sizing demand
        # carries the requirers' demand spread over provider pods
        demand_units = demand
        sd = sizing_demand(problem)
        if sd is not problem.demand:
            demand_units = np.zeros((Gp, R), np.float32)
            demand_units[:G] = sd / scale
        fields = dict(
            demand=demand, demand_units=demand_units, count=count, node_cap=node_cap,
            quota=quota, colocate=colocate, compat=compat, alloc=alloc, price=price,
            opt_zone=opt_zone, opt_valid=opt_valid, ex_rem=ex_rem, ex_zone=ex_zone,
            ex_compat=ex_compat, ex_valid=ex_valid, **rel,
        )

        sizes = np.zeros((Gp,), np.float64)
        sizes[:G] = (problem.demand / scale).max(axis=1)
        layer = None
        if problem.rel_layer is not None and problem.rel_layer.any():
            layer = np.full((Gp,), np.iinfo(np.int32).max, np.int64)
            layer[:G] = problem.rel_layer  # padding groups sort last
        orders, alphas, looks, rsvs, swaps = make_orders(
            sizes, count.astype(np.float64), self.portfolio, self.seed, layer=layer,
            has_reserve=demand_units is not demand,
        )
        s_new = bucket.S if bucket else self._estimate_slots(problem)
        return fields, orders, alphas, looks, rsvs, swaps, s_new, Zp

    def _estimate_slots(self, problem: EncodedProblem) -> int:
        if problem.O == 0:
            return 8
        # nodes if each group used its best-capacity compatible option alone,
        # with units capped by node_cap and colocate needing the whole group
        G = problem.G
        units_all = np.zeros((G, problem.O), np.float64)
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            for r in range(len(problem.resource_axes)):
                d = problem.demand[:, r : r + 1]
                c = problem.alloc[:, r][None, :]
                frac = np.where(d > 0, np.floor(np.where(d > 0, c / np.maximum(d, 1e-30), np.inf)), np.inf)
                units_all = frac if r == 0 else np.minimum(units_all, frac)
        units_all = np.where(np.isfinite(units_all), units_all, 0.0)
        units_all = np.minimum(units_all, problem.node_cap[:, None].astype(np.float64))
        units_all = np.where(
            problem.colocate[:, None],
            np.where(units_all >= problem.count[:, None], units_all, 0.0),
            units_all,
        )
        total = 0
        for gi in range(G):
            ok = problem.compat[gi]
            if not np.any(ok):
                continue
            best_units = np.max(np.where(ok, units_all[gi], 0))
            if best_units > 0:
                total += math.ceil(problem.count[gi] / best_units)
        # headroom: portfolio variance + per-(group, zone-bucket) tails
        est = int(total * 1.5) + 2 * G + 16
        return min(_next_pow2(est, floor=16), self.max_slots)

    # -- decode --------------------------------------------------------------
    def _decode(
        self,
        problem: EncodedProblem,
        order: np.ndarray,
        new_opt: np.ndarray,
        new_active: np.ndarray,
        ys: np.ndarray,
    ) -> SolveResult:
        E = problem.E
        s_new = new_opt.shape[0]
        # slot columns are [existing (padded) | new]
        Ep = ys.shape[1] - s_new
        group_names = problem.__dict__.get("_group_names")
        if group_names is None:
            from .result import LazyNames

            group_names = [LazyNames(g.pods) for g in problem.groups]
            problem.__dict__["_group_names"] = group_names
        new_segs: List[List[tuple]] = [[] for _ in range(s_new)]
        ex_segs: dict = {}
        unschedulable: List[str] = []
        # only walk nonzero placements: ys is [T, Ep+S] and mostly zeros
        rows, cols = np.nonzero(ys)
        placements_by_row: dict = {}
        for t, s in zip(rows.tolist(), cols.tolist()):
            placements_by_row.setdefault(t, []).append(s)
        for t, slots in placements_by_row.items():
            g = int(order[t])
            if g >= problem.G:
                continue
            names_g = group_names[g]
            cursor = 0
            for s in sorted(slots):
                if s < Ep and s >= E:
                    # padding slot: leaving the cursor put reports them unschedulable
                    continue
                n = int(ys[t, s])
                seg = (names_g, cursor, n)
                cursor += n
                if s < Ep:
                    ex_segs.setdefault(problem.existing[s].name, []).append(seg)
                else:
                    new_segs[s - Ep].append(seg)
            if cursor < problem.groups[g].count:
                unschedulable.extend(names_g[cursor:])
        # groups with zero placements anywhere are wholly unschedulable
        placed_rows = set(placements_by_row)
        for t in range(ys.shape[0]):
            g = int(order[t])
            if g < problem.G and t not in placed_rows:
                unschedulable.extend(group_names[g])

        existing_assignments = {k: NameSlice(v) for k, v in ex_segs.items()}
        new_nodes = []
        cost = 0.0
        for s in range(s_new):
            if not new_active[s] or not new_segs[s]:
                continue
            j = int(new_opt[s])
            option = problem.options[j]
            new_nodes.append(
                NewNodeSpec(option=option, pod_names=NameSlice(new_segs[s]), option_index=j)
            )
            cost += option.price
        return SolveResult(
            new_nodes=new_nodes,
            existing_assignments=existing_assignments,
            unschedulable=unschedulable,
            cost=cost,
            stats={"nodes_opened": float(len(new_nodes))},
        )
