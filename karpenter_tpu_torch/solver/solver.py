"""Solver backends behind one interface.

``TorchSolver`` is the port's counterpart of the JAX package's ``TPUSolver``
kernel path: pad the encoded problem onto its bucket lattice, keep its
tensors resident on the device through a ``DeviceStager``, run the fused
two-phase portfolio solve (``torch_solver.pack_solve_fused``: three CUDA
kernels on the card, their plain PyTorch versions on the CPU), gate the raw
answer with the count-level validator and decode it. The host race
competitors of the reference are not part of this package yet, so the
kernel answers every round; a problem the tensor path cannot express, or a
kernel plan that fails validation, raises instead of falling back.

``stage_fleet`` is the sharded round's fleet dispatch: the dirty cells'
problems, each with the solver that will solve it, are grouped by bucket
and each chunk is solved in one batched call (``pack_solve_fleet``); each
cell's ``solve`` then decodes its row.
"""

from __future__ import annotations

import abc
import math
import time
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .encode import EncodedProblem, sizing_demand
from .result import NameSlice, NewNodeSpec, SolveResult
from .staging import DeviceStager, fleet_stack
from .torch_solver import (
    BucketKey,
    PackInputs,
    bucket_existing,
    bucket_fleet,
    bucket_groups,
    bucket_key,
    bucket_options,
    bucket_zones,
    fleet_padding,
    make_orders,
    pack_solve_fleet,
    pack_solve_fused,
    unpack_solve_fused,
)
from .validate import validate_counts

_MEMBER_LEAVES = ("orders", "alphas", "looks", "rsvs", "swaps")


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


class _FleetBuffer:
    """The ``[B, L]`` device buffer of one fleet dispatch, shared by the
    cells batched into it. The first cell that reads it copies it to the
    host once; every later cell reads that copy. On the card, two events
    around the dispatch give its device time."""

    __slots__ = ("buf", "key", "events", "_host")

    def __init__(self, buf: torch.Tensor, key: BucketKey, events=None):
        self.buf = buf
        self.key = key  # the fleet bucket (B > 1)
        self.events = events
        self._host: Optional[np.ndarray] = None

    def materialize(self) -> np.ndarray:
        if self._host is None:
            self._host = self.buf.cpu().numpy()
        return self._host

    def device_ms(self) -> Optional[float]:
        """Device time of the dispatch (None on the CPU); after materialize."""
        return None if self.events is None else self.events[0].elapsed_time(self.events[1])


class _FleetDispatch:
    """One cell's share of a fleet dispatch: the shared buffer, this
    problem's row and what unpacking it needs. Attached to the problem by
    ``stage_fleet``; popped by ``solve``."""

    __slots__ = ("shared", "row", "orders", "swaps", "s_new")

    def __init__(self, shared, row, orders, swaps, s_new):
        self.shared = shared
        self.row = row
        self.orders = orders
        self.swaps = swaps
        self.s_new = s_new


def _fleet_eligible(problem: Optional[EncodedProblem]) -> bool:
    return (
        problem is not None and problem.G > 0
        and not (problem.O == 0 and problem.E == 0)
        and problem.rel_unsupported is None
    )


def stage_fleet(
    entries: Sequence[Tuple["TorchSolver", EncodedProblem]], max_batch: int = 16,
) -> dict:
    """Batch same-bucket kernel dispatches into single device calls.

    ``entries`` pairs each freshly encoded problem with the solver that will
    solve it (the sharded round's per-cell clones, or one shared solver).
    Problems are grouped by bucket; each group is cut into chunks of the
    largest power of two <= ``max_batch``, each chunk is padded to its pow2
    fleet width with inert rows and solved in one ``pack_solve_fleet`` call.
    Each batched problem carries a ``_fleet_dispatch`` handle that its
    ``solve`` consumes instead of dispatching on its own. A lone cell is left
    to its own solve.

    A chunk whose every problem is resident on its solver's device (after
    ``prestage``) is stacked on the device by ``fleet_stack`` from the
    resident rows and the pad row, staged once under ``("fleetpad",) +
    fleet_key``; otherwise the chunk is stacked on the host and staged
    through the first solver's stager under ``("fleet",) + fleet_key``.

    Returns ``dispatches``, ``cells_batched``, ``eligible``, the fleet
    ``buckets`` and how many chunks were ``device_stacked``."""
    stats = {"dispatches": 0, "cells_batched": 0, "eligible": 0, "buckets": [],
             "device_stacked": 0}
    if max_batch < 2 or len(entries) < 2:
        return stats
    width_cap = 1 << (int(max_batch).bit_length() - 1)
    groups: "OrderedDict[BucketKey, list]" = OrderedDict()
    for solver, problem in entries:
        if not _fleet_eligible(problem):
            continue
        stats["eligible"] += 1
        groups.setdefault(solver._bucket_key(problem), []).append((solver, problem))
    for key, members in groups.items():
        for base in range(0, len(members), width_cap):
            chunk = members[base : base + width_cap]
            if len(chunk) < 2:
                continue
            fleet_key = key._replace(B=bucket_fleet(len(chunk)))
            stats["device_stacked"] += _stage_fleet_chunk(chunk, key, fleet_key)
            stats["dispatches"] += 1
            stats["cells_batched"] += len(chunk)
            stats["buckets"].append(fleet_key.label())
    return stats


def _stage_fleet_chunk(chunk, key: BucketKey, fleet_key: BucketKey) -> bool:
    """Stack one chunk along the batch axis, dispatch it, and attach each
    problem's row. Returns whether the stack was built on the device."""
    B = fleet_key.B
    owner = chunk[0][0]
    preps = [solver._prepare(problem, bucket=key) for solver, problem in chunk]
    resident = [solver._resident(problem) for solver, problem in chunk]
    pad_fields, *pad_members = fleet_padding(key)
    pad = {**pad_fields, **dict(zip(_MEMBER_LEAVES, pad_members))}
    device_side = all(e is not None for e in resident)
    if device_side:
        # every row is already on the device: stack it there, with the pad
        # row staged once per fleet bucket, so no byte crosses the host link
        # twice
        pad_d = owner._stager.stage(("fleetpad",) + tuple(fleet_key), pad)
        rows = [
            {**e[1]._asdict(), **dict(zip(_MEMBER_LEAVES, e[4:9]))} for e in resident
        ]
        staged = fleet_stack(rows + [pad_d] * (B - len(rows)))
    else:
        # host stack through the owner's stager: a repeat round whose chunk
        # lines up the same cells re-uploads only the churned rows
        rows = [{**prep[0], **dict(zip(_MEMBER_LEAVES, prep[1:6]))} for prep in preps]
        rows += [pad] * (B - len(rows))
        staged = owner._stager.stage(
            ("fleet",) + tuple(fleet_key), {f: np.stack([r[f] for r in rows]) for f in pad}
        )
    args = (PackInputs(*(staged[f] for f in PackInputs._fields)),) + tuple(
        staged[f] for f in _MEMBER_LEAVES
    )
    events = None
    if owner.device.type == "cuda":
        events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        events[0].record()
    buf = pack_solve_fleet(*args, key.S, key.Z)
    if events is not None:
        events[1].record()
    shared = _FleetBuffer(buf, fleet_key, events)
    for row, ((_, problem), prep) in enumerate(zip(chunk, preps)):
        problem.__dict__["_fleet_dispatch"] = _FleetDispatch(shared, row, prep[1], prep[5], key.S)
    return device_side


class TorchSolver(Solver):
    """The portfolio packing kernel on one device.

    ``device`` defaults to the card: ``TorchSolver()`` raises when CUDA is
    absent rather than running on the CPU. ``device="cpu"`` runs the plain
    PyTorch versions of the kernels (the tests' path).

    The solver keeps one problem resident on its device (``_device_inputs``:
    staged through its ``DeviceStager`` under the tag ``("cell", Gp, Op, Ep,
    Zp, R, K)``, so the next problem of that shape moves only its churned
    rows). ``prestage`` stages a problem ahead of its solve; the sharded
    round gives each cell its own solver so that every dirty cell stays
    resident until ``stage_fleet``."""

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
        self._stager = DeviceStager(device=device)
        self._device_cache: dict = {}

    def solve(self, problem: EncodedProblem) -> SolveResult:
        # a fleet handle is consumed once, popped even where it is not read,
        # so that it can never serve a later solve of the same problem
        slot = problem.__dict__.pop("_fleet_dispatch", None)
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
        if slot is not None:
            return self._solve_fleet_row(problem, slot)
        return self._solve_kernel(problem)

    def prestage(self, problem: EncodedProblem) -> None:
        """Pad and stage this problem's tensors now, without solving: the
        sharded round calls it right after each cell's encode, so that
        ``stage_fleet`` finds every dirty cell resident and stacks the chunk
        on the device. A no-op for problems the kernel would not solve."""
        if _fleet_eligible(problem):
            self._device_inputs(problem)

    def _solve_fleet_row(self, problem: EncodedProblem, slot: _FleetDispatch) -> SolveResult:
        """Decode this problem's row of a fleet dispatch. A row whose members
        ran out of slots with pods left over goes on alone at twice the slot
        budget, exactly as the fleet-free solve would after its first pass."""
        t0 = time.perf_counter()
        key = slot.shared.key
        raw = slot.shared.materialize()[slot.row]
        unpacked = unpack_solve_fused(
            raw, slot.orders.shape[0], slot.s_new, key.G, key.E, slot.orders, slot.swaps
        )
        _, unplaced, _, exhausted, _, _, _ = unpacked
        if exhausted.any() and unplaced > 0 and slot.s_new < self.max_slots:
            result = self._solve_kernel(problem, s_new=2 * slot.s_new, passes=1)
            result.stats["fleet_exhausted"] = 1.0
        else:
            t1 = time.perf_counter()
            result = self._finish(problem, unpacked, slot.s_new, 1, t0, t0, t1)
            result.stats["fleet_exhausted"] = 0.0
        result.stats["fleet_b"] = float(key.B)
        result.stats["fleet_bucket"] = key.label()
        return result

    def _solve_kernel(self, problem: EncodedProblem, s_new: Optional[int] = None,
                      passes: int = 0) -> SolveResult:
        """Solve on the resident tensors from ``s_new`` slots (default: the
        problem's current budget), doubling while members run out."""
        t0 = time.perf_counter()
        (inputs, orders, swaps, orders_d, alphas_d, looks_d, rsvs_d, swaps_d,
         s_cached, n_zones) = self._device_inputs(problem)
        if s_new is not None and s_new != s_cached:
            self._set_slots(problem, s_new)
        t1 = time.perf_counter()
        unpacked, s_new, n = self._run_fused(
            (inputs, orders_d, alphas_d, looks_d, rsvs_d, swaps_d), orders, swaps,
            s_cached if s_new is None else s_new, n_zones, problem,
        )
        t2 = time.perf_counter()
        return self._finish(problem, unpacked, s_new, passes + n, t0, t1, t2)

    def _finish(self, problem, unpacked, s_new: int, passes: int, t0, t1, t2) -> SolveResult:
        """Gate the kernel's answer with the count-level validator, decode
        it, and record its stats."""
        order, unplaced, costs, exhausted, new_opt, new_active, ys = unpacked
        if not np.isfinite(np.asarray(costs, dtype=np.float64)).all():
            raise RuntimeError("kernel returned non-finite member costs")
        k = len(costs) // 2
        violations = validate_counts(problem, order, new_opt, new_active, ys)
        if violations:
            raise RuntimeError(f"kernel plan failed validation: {violations[:5]}")
        t3 = time.perf_counter()
        result = self._decode(problem, order, new_opt, new_active, ys)
        t4 = time.perf_counter()
        # host-clock phases: padding, portfolio construction and staging; the
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

    def _run_fused(self, tensors, orders: np.ndarray, swaps: np.ndarray, s_new: int,
                   n_zones: int, problem: Optional[EncodedProblem] = None):
        """The fused solve on ``tensors`` (``(PackInputs, orders, alphas,
        looks, rsvs, swaps)`` on the device), doubling the slot budget while
        members ran out of slots; the resident entry of ``problem`` follows
        the budget. Returns the unpacked result, the slot budget it was
        solved at and the number of fused passes it took."""
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
                if problem is not None:
                    self._set_slots(problem, s_new)
                continue
            return unpacked, s_new, passes

    # -- residency --------------------------------------------------------------
    def _resident(self, problem: EncodedProblem):
        """This problem's device-cache entry, or None."""
        cached = self._device_cache.get(id(problem))
        return cached if cached is not None and cached[0] is problem else None

    def _set_slots(self, problem: EncodedProblem, s_new: int) -> None:
        cached = self._device_cache.get(id(problem))
        if cached is not None and cached[0] is problem:
            self._device_cache[id(problem)] = cached[:9] + (s_new,) + cached[10:]

    def _device_inputs(self, problem: EncodedProblem):
        """The problem's tensors on the device, cached by problem identity.
        The entry holds the problem itself, so a recycled ``id()`` can never
        alias another problem onto its tensors, and the host-side orders, so
        a row is always decoded with its own. Entry layout: ``(problem,
        inputs_d, orders, swaps, orders_d, alphas_d, looks_d, rsvs_d,
        swaps_d, s_new, n_zones)``; returns it without the problem."""
        cached = self._resident(problem)
        if cached is not None:
            return cached[1:]
        fields, orders, alphas, looks, rsvs, swaps, s_new, n_zones = self._prepare(problem)
        leaves = dict(fields, orders=orders, alphas=alphas, looks=looks, rsvs=rsvs, swaps=swaps)
        Gp, R = fields["demand"].shape
        tag = ("cell", Gp, fields["price"].shape[0], fields["ex_valid"].shape[0],
               fields["rel_zone_bits"].shape[0], R, orders.shape[0])
        staged = self._stager.stage(tag, leaves)
        entry = (
            problem, PackInputs(*(staged[f] for f in PackInputs._fields)), orders, swaps,
            *(staged[f] for f in _MEMBER_LEAVES), s_new, n_zones,
        )
        self._device_cache.clear()  # hold at most one problem resident
        self._device_cache[id(problem)] = entry
        return entry[1:]

    def _cached_s_new(self, problem: EncodedProblem) -> int:
        """The problem's current slot budget: the resident entry's (grown by
        the doubling), else the estimate."""
        cached = self._resident(problem)
        return cached[9] if cached is not None else self._estimate_slots(problem)

    def _bucket_key(self, problem: EncodedProblem, s_new: Optional[int] = None) -> BucketKey:
        return bucket_key(
            problem.G, problem.O, problem.E,
            self._cached_s_new(problem) if s_new is None else s_new,
            max(len(problem.zones), 1), len(problem.resource_axes), self.portfolio,
        )

    # -- encoding to padded arrays --------------------------------------------
    def _prepare(self, problem: EncodedProblem, bucket: Optional[BucketKey] = None):
        """Pad the encoded problem onto its bucket's lattice shape.

        ``bucket`` overrides the lattice dimensions (must dominate the real
        dims): a problem solved on a larger bucket gives the same answer as
        on its natural one. Returns ``(fields, orders, alphas, looks, rsvs,
        swaps, s_new, Zp)`` with ``fields`` the ``PackInputs`` arrays as
        numpy.

        Memoized on the problem per (lattice dims, solver knobs), so that
        ``prestage`` and ``stage_fleet`` do not pad twice; the arrays are
        shared and must not be written. The slot budget shapes no array."""
        s_new = bucket.S if bucket else self._estimate_slots(problem)
        memo_key = (
            bucket.G if bucket else bucket_groups(problem.G),
            bucket.O if bucket else bucket_options(problem.O),
            bucket.E if bucket else bucket_existing(problem.E),
            bucket.Z if bucket else bucket_zones(max(len(problem.zones), 1)),
            self.seed, self.portfolio,
        )
        memo = problem.__dict__.get("_prep_memo")
        if memo is not None and memo[0] == memo_key:
            return memo[1] + (s_new, memo[2])
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
        out = (fields, orders, alphas, looks, rsvs, swaps)
        problem.__dict__["_prep_memo"] = (memo_key, out, Zp)
        return out + (s_new, Zp)

    def _estimate_slots(self, problem: EncodedProblem) -> int:
        # memoized on the problem: deterministic per content and slot cap,
        # and every bucket-key computation reads it
        cached = problem.__dict__.get("_est_slots")
        if cached is not None and cached[0] == self.max_slots:
            return cached[1]
        est = self._estimate_slots_uncached(problem)
        problem.__dict__["_est_slots"] = (self.max_slots, est)
        return est

    def _estimate_slots_uncached(self, problem: EncodedProblem) -> int:
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
