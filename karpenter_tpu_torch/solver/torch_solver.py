"""PyTorch counterpart of ``karpenter_tpu/solver/jax_solver.py``.

The packing program is the JAX package's: a shared precompute of per-(group,
option) unit counts and the lookahead value table, a two-phase portfolio of
grouped first-fit-decreasing members (K host orderings, then K permutations
of the phase-1 winner), and one int32 result buffer whose layout
``unpack_solve_fused`` decodes. See the JAX module for the algorithm.

On the card the program is three hand-written CUDA kernels
(``csrc/pack_solve.cu``):

* ``shared_precompute`` (K1) replaces ``_shared_precompute``;
* ``pack_member`` (K2) replaces the vmapped ``_pack_member``, launched once
  per phase: a grid-wide kernel for the lookahead members' prices, then the
  scan, one block per member with its per-step state in shared memory;
* ``pack_epilogue`` (K3) replaces the argmin and buffer packing of
  ``_pack_solve_fused_impl``.

``rtt_probe`` (``csrc/probe.cu``) is the device round trip the race's
admission measures (``TorchSolver.device_rtt``).

Every kernel also takes a leading batch axis B: ``pack_solve_fleet`` solves B
stacked problems of one bucket in the same four launches, as the JAX
package's ``pack_solve_fleet`` runs the B=1 program under ``vmap``; row b of
its ``[B, L]`` buffer equals the B=1 buffer of problem b, and a
``fleet_padding`` row costs 0. A wrapper given unbatched tensors launches
with B=1.

``pack_solve_meshed`` is the same solve over the shards of a device mesh
(``parallel/mesh.py``; the chain and its kernels' wrappers in
``meshed.py``): the 1D portfolio mesh splits the members, the 2D options x
fleet mesh the option columns and a superproblem's rows. Its design rule is
what ``_pin`` and ``mesh_constraints`` guarantee in the JAX package: the
option-axis values (``units``, ``units_rsv``, ``val_pair``, the lookahead
prices, the step scores) stay split by option columns and are never
gathered whole. ``BucketKey``'s ``MO``/``MF`` carry the mesh shape.

Beside each kernel sits its plain PyTorch version (``*_ref``): the member
axis is a batch dimension and the scan a Python loop over T; a batch runs
row by row. A wrapper takes the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises. ``LAUNCHES`` counts kernel
launches per wrapper (the staging kernels' wrappers in ``staging.py`` count
there too), ``BATCHED`` the launches among them with B > 1.

Numerics follow what XLA computes, including where it contracts a multiply
and an add into one fused multiply-add (``_fma``): the residual capacity
``alloc - units*d``, the slot updates ``rem - n*d``, the lookahead price
``price - 0.9*val`` and the mixed cost ``n_full*price + tail``, and the
member cost ``sum + unplaced*penalty``. Every other product and sum is
rounded on its own, as in the kernels, which are built with ``--fmad=false``.
"""

from __future__ import annotations

import ctypes
import threading
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

INF = np.float32(1e30)
IBIG = np.int32(1 << 30)
UNPLACED_PENALTY = np.float32(1e6)  # per-pod cost penalty for infeasible members

# Lookahead members discount an option's price by at most this fraction of the
# residual-capacity value, and never below this floor fraction of the price.
LOOKAHEAD_DISCOUNT = np.float32(0.9)
LOOKAHEAD_FLOOR = np.float32(0.25)
TIE_BAND = np.float32(1.0001)

_INF = float(INF)
_IBIG = int(IBIG)

#: kernel launches per wrapper, for showing that a run went through the card
LAUNCHES: Dict[str, int] = {
    "shared_precompute": 0, "pack_member": 0, "pack_epilogue": 0,
    "stage_patch": 0, "fleet_stack": 0, "rtt_probe": 0,
}
#: the launches of the packing kernels with a batch of more than one problem
BATCHED: Dict[str, int] = {"shared_precompute": 0, "pack_member": 0, "pack_epilogue": 0}
# the sharded round's per-cell solves launch from several host threads, and
# ``+= 1`` on a dict entry is a read, an add and a store: one lock keeps the
# counts exact
_COUNT_LOCK = threading.Lock()


class PackInputs(NamedTuple):
    demand: torch.Tensor  # [G, R] f32 per-pod demand (normalized)
    demand_units: torch.Tensor  # [G, R] f32 node-sizing demand (with requirer reserve)
    count: torch.Tensor  # [G] i32
    node_cap: torch.Tensor  # [G] i32
    quota: torch.Tensor  # [G, Z] i32 per-zone new-pod quota, IBIG = unlimited
    colocate: torch.Tensor  # [G] bool
    compat: torch.Tensor  # [G, O] bool
    alloc: torch.Tensor  # [O, R] f32 (normalized)
    price: torch.Tensor  # [O] f32
    opt_zone: torch.Tensor  # [O] i32
    opt_valid: torch.Tensor  # [O] bool
    ex_rem: torch.Tensor  # [E, R] f32 (normalized)
    ex_zone: torch.Tensor  # [E] i32
    ex_compat: torch.Tensor  # [G, E] bool
    ex_valid: torch.Tensor  # [E] bool
    rel_set: torch.Tensor  # [G] i32 bits a group's placement sets on its domain
    rel_host_forbid: torch.Tensor  # [G] i32
    rel_host_need: torch.Tensor  # [G] i32
    rel_zone_forbid: torch.Tensor  # [G] i32
    rel_zone_need: torch.Tensor  # [G] i32
    rel_slot_bits: torch.Tensor  # [E] i32 seed bits of existing nodes
    rel_zone_bits: torch.Tensor  # [Z] i32 seed bits per zone


_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool
_FIELD_DTYPES = {
    "demand": _F32, "demand_units": _F32, "count": _I32, "node_cap": _I32,
    "quota": _I32, "colocate": _BOOL, "compat": _BOOL, "alloc": _F32,
    "price": _F32, "opt_zone": _I32, "opt_valid": _BOOL, "ex_rem": _F32,
    "ex_zone": _I32, "ex_compat": _BOOL, "ex_valid": _BOOL, "rel_set": _I32,
    "rel_host_forbid": _I32, "rel_host_need": _I32, "rel_zone_forbid": _I32,
    "rel_zone_need": _I32, "rel_slot_bits": _I32, "rel_zone_bits": _I32,
}
_MEMBER_DTYPES = {
    "orders": _I32, "alphas": _F32, "looks": _BOOL, "rsvs": _BOOL, "swaps": _I32,
}


class Shared(NamedTuple):
    """Order-independent precompute, shared by every portfolio member."""

    units: torch.Tensor  # [G, O] i32 pods per fresh node
    units_rsv: torch.Tensor  # [G, O] i32 reserve-sized variant
    rsv_group: torch.Tensor  # [G] bool
    lam: torch.Tensor  # [G] f32 cheapest per-pod rate
    quota: torch.Tensor  # [G, Z] i32
    zone_limited: torch.Tensor  # [G] bool
    val_pair: torch.Tensor  # [G, O, G'] f32 residual value of (g,o) nodes to g'
    exok_pad: torch.Tensor  # [G, E+S] bool
    is_new: torch.Tensor  # [E+S] bool


class MemberOut(NamedTuple):
    """One phase's K member results (the vmapped ``_pack_member`` outputs)."""

    cost: torch.Tensor  # [K] f32
    unplaced: torch.Tensor  # [K] i32
    exhausted: torch.Tensor  # [K] bool
    new_opt: torch.Tensor  # [K, S] i32
    new_active: torch.Tensor  # [K, S] bool
    ys: torch.Tensor  # [K, T, E+S] i32


def pack_inputs_from_numpy(fields: dict, device) -> Tuple[PackInputs, torch.Tensor, ...]:
    """Carry a packed problem across: ``fields`` holds the ``PackInputs``
    arrays as numpy (the JAX package's ``_prepare`` output, field by field)
    plus ``orders``, ``alphas``, ``looks``, ``rsvs`` and ``swaps``, either of
    one problem or stacked ``[B, ...]`` for a fleet. Returns ``(PackInputs,
    orders, alphas, looks, rsvs, swaps)`` as contiguous tensors of the
    reference dtypes on ``device``."""

    def put(name, dtype):
        arr = np.ascontiguousarray(np.asarray(fields[name]))
        return torch.from_numpy(arr).to(device=device, dtype=dtype).contiguous()

    inputs = PackInputs(**{f: put(f, dt) for f, dt in _FIELD_DTYPES.items()})
    members = tuple(put(f, dt) for f, dt in _MEMBER_DTYPES.items())
    return (inputs,) + members


def _row(nt, b: int):
    """Row ``b`` of a batched NamedTuple of tensors."""
    return type(nt)(*(x[b] for x in nt))


def _stack(items: Sequence):
    """Stack NamedTuples of tensors along a new leading batch axis."""
    return type(items[0])(*(torch.stack(xs) for xs in zip(*items)))


def _batch(inputs: PackInputs) -> Optional[int]:
    """B for stacked inputs, None for one problem."""
    return inputs.demand.shape[0] if inputs.demand.dim() == 3 else None


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """``a*b + c`` correctly rounded to f32, as XLA's contracted multiply-add
    and CUDA's ``__fmaf_rn``. The product of two f32 values is exact in f64;
    the f64 sum is made round-to-odd (its lost part, from a two-sum, pushes
    an even last bit one step towards the exact value), and an f64
    round-to-odd value rounds to f32 as the exact value would."""
    b = b.double() if torch.is_tensor(b) else float(b)
    p = a.double() * b
    c = c.double()
    s = p + c
    bv = s - p
    lost = (p - (s - bv)) + (c - bv)  # s + lost == p + c exactly
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(lost > 0, torch.full_like(s, float("inf")), torch.full_like(s, float("-inf")))
    return torch.where((lost != 0) & even, torch.nextafter(s, toward), s).float()


def _cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cumsum(x, dim, dtype=_I32)


def _isum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.sum(x, dim, dtype=_I32)


def _ceil_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return -torch.div(-a, b, rounding_mode="floor")


def _units(rem: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """How many whole pods of per-pod demand d fit in each remaining vector."""
    safe = torch.where(d > 0, rem / torch.clamp(d, min=1e-30), _INF)
    u = torch.floor(safe.amin(-1) + 1e-4)
    return torch.clamp(u, 0, float(_IBIG)).to(_I32)


def sized_units_ref(inputs: PackInputs, dd: torch.Tensor) -> torch.Tensor:
    """[G, O] whole pods of per-pod demand ``dd`` a fresh node of each
    option holds."""
    safe = torch.where(
        dd[:, None, :] > 0,
        inputs.alloc[None, :, :] / torch.clamp(dd[:, None, :], min=1e-30),
        _INF,
    )
    return torch.clamp(torch.floor(safe.amin(-1) + 1e-4), 0, float(_IBIG)).to(_I32)


def finish_units_ref(inputs: PackInputs, un: torch.Tensor) -> torch.Tensor:
    """Unit counts capped by node_cap, 0 where the option cannot take the
    group, and all-or-nothing for colocated groups."""
    ok = inputs.compat & inputs.opt_valid[None, :]
    un = torch.minimum(un, inputs.node_cap[:, None])
    un = torch.where(ok, un, 0)
    return torch.where(inputs.colocate[:, None], torch.where(un >= inputs.count[:, None], un, 0), un)


def val_pair_ref(inputs: PackInputs, units: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """[G, O, G'] residual value of a (g, o) node to group g': its whole
    pods of g' times g''s cheapest per-pod rate."""
    R = inputs.demand.shape[1]
    d = inputs.demand
    ok = inputs.compat & inputs.opt_valid[None, :]
    resid = _fma(-units.float()[:, :, None], d[:, None, :], inputs.alloc[None, :, :])  # [G, O, R]
    u2 = None
    for r in range(R):
        dr = d[:, r]
        ur = torch.where(
            dr[None, None, :] > 0,
            torch.floor(resid[:, :, r : r + 1] / torch.clamp(dr, min=1e-30)[None, None, :] + 1e-4),
            _INF,
        )
        u2 = ur if u2 is None else torch.minimum(u2, ur)
    u2 = torch.clamp(u2, 0, float(_IBIG))
    u2 = torch.minimum(u2, inputs.node_cap[None, None, :].float())
    val_pair = torch.where(ok.T[None, :, :] & (u2 > 0), u2 * lam[None, None, :], 0.0)
    return val_pair.contiguous()  # the transposed mask can leave o fastest


def shared_precompute_ref(inputs: PackInputs, s_new: int, n_zones: int) -> Shared:
    G, R = inputs.demand.shape
    E = inputs.ex_rem.shape[0]
    dev = inputs.demand.device
    ok = inputs.compat & inputs.opt_valid[None, :]
    units_raw = sized_units_ref(inputs, inputs.demand)
    units_rsv = sized_units_ref(inputs, inputs.demand_units)
    row_fits = ((units_rsv > 0) & ok).any(1, keepdim=True)
    units_rsv = torch.where(~row_fits & (units_raw > 0), units_raw, units_rsv)
    units = finish_units_ref(inputs, units_raw)
    units_rsv = finish_units_ref(inputs, units_rsv)

    rate = torch.where(units > 0, inputs.price[None, :] / torch.clamp(units.float(), min=1.0), _INF)
    lam_raw = rate.amin(1)
    lam = torch.where(lam_raw < _INF, lam_raw, 0.0)

    zone_limited = (inputs.quota < _IBIG).any(1)
    ex_ok = inputs.ex_compat & inputs.ex_valid[None, :]
    val_pair = val_pair_ref(inputs, units, lam)

    exok_pad = torch.cat([ex_ok, torch.zeros((G, s_new), dtype=_BOOL, device=dev)], 1)
    is_new = torch.arange(E + s_new, device=dev) >= E
    rsv_group = (inputs.demand_units != inputs.demand).any(1)
    return Shared(
        units=units, units_rsv=units_rsv, rsv_group=rsv_group, lam=lam,
        quota=inputs.quota, zone_limited=zone_limited, val_pair=val_pair,
        exok_pad=exok_pad, is_new=is_new,
    )


def _argmin_tiebreak(score: torch.Tensor, units_f: torch.Tensor, alpha: torch.Tensor):
    """Row-wise argmin over options with the portfolio tiebreak: within 0.01%
    of the best score, alpha >= 1 members prefer the larger node, alpha < 1
    the smaller one; first index on exact ties."""
    best = score.amin(-1, keepdim=True)
    cand = score <= best * float(TIE_BAND)
    pref = torch.where(alpha[:, None] >= 1.0, units_f, -units_f)  # [K, O]
    idx = torch.argmax(torch.where(cand, pref[:, None, :], -_INF), -1)
    return idx, best[..., 0]


def _lookahead_prices(inputs: PackInputs, shared: Shared, orders, looks) -> torch.Tensor:
    """price_t[k, t, o]: the price a member scores option o with at step t."""
    K, T = orders.shape
    G = inputs.count.shape[0]
    price = inputs.price
    price_t = price[None, None, :].expand(K, T, price.shape[0]).clone()
    steps = torch.arange(T, dtype=_I32, device=price.device)
    for k in range(K):
        if not bool(looks[k]):
            continue
        order = orders[k].long()
        pos = torch.zeros((G,), dtype=_I32, device=price.device)
        pos[order] = steps
        later = pos[None, :] > steps[:, None]  # [T, G']
        val_t = torch.where(later[:, None, :], shared.val_pair[order], 0.0).amax(-1)
        price_t[k] = torch.maximum(
            _fma(val_t, -float(LOOKAHEAD_DISCOUNT), price[None, :]),
            float(LOOKAHEAD_FLOOR) * price[None, :],
        )
    return price_t


def pack_member_ref(
    inputs: PackInputs, shared: Shared, orders, alphas, looks, rsvs,
    s_new: int, n_zones: int,
) -> MemberOut:
    """K portfolio members at once: grouped FFD over ``orders[k]`` with
    bucketed node opening (``jax_solver._pack_member`` under vmap)."""
    K, T = orders.shape
    R = inputs.demand.shape[1]
    O = inputs.price.shape[0]
    E = inputs.ex_rem.shape[0]
    NS = E + s_new
    Z = n_zones
    dev = inputs.demand.device

    price_t = _lookahead_prices(inputs, shared, orders, looks)
    zidx = torch.arange(Z, dtype=_I32, device=dev)
    opt_bucket_ok = torch.cat(
        [inputs.opt_zone[None, :] == zidx[:, None], torch.ones((1, O), dtype=_BOOL, device=dev)]
    )  # [Zb, O]

    def tile(x):
        return x[None].repeat((K,) + (1,) * x.dim())

    zeros_i = torch.zeros((s_new,), dtype=_I32, device=dev)
    slot_rem = tile(torch.cat([inputs.ex_rem, torch.zeros((s_new, R), dtype=_F32, device=dev)]))
    slot_opt = torch.full((K, NS), -1, dtype=_I32, device=dev)
    slot_zone = tile(torch.cat([inputs.ex_zone, zeros_i]))
    slot_active = tile(torch.cat([inputs.ex_valid, torch.zeros((s_new,), dtype=_BOOL, device=dev)]))
    slot_bits = tile(torch.cat([inputs.rel_slot_bits, zeros_i]))
    zone_bits = tile(inputs.rel_zone_bits[:Z])
    unplaced = torch.zeros((K,), dtype=_I32, device=dev)
    exhausted = torch.zeros((K,), dtype=_BOOL, device=dev)
    ys = torch.zeros((K, T, NS), dtype=_I32, device=dev)
    is_new = shared.is_new[None, :]
    zero_col = torch.zeros((K, 1), dtype=_I32, device=dev)

    for t in range(T):
        g = orders[:, t].long()
        d = inputs.demand[g]  # [K, R]
        cnt = inputs.count[g][:, None]  # [K, 1]
        cap = inputs.node_cap[g][:, None]
        coloc = inputs.colocate[g][:, None]
        u = torch.where(rsvs[:, None], shared.units_rsv[g], shared.units[g])  # [K, O]
        pe = price_t[:, t]  # [K, O]
        hf = inputs.rel_host_forbid[g][:, None]
        hn = inputs.rel_host_need[g][:, None]
        zf = inputs.rel_zone_forbid[g][:, None]
        zn = inputs.rel_zone_need[g][:, None]
        zone_rel_ok = ((zone_bits & zf) == 0) & ((zone_bits & zn) == zn)  # [K, Z]
        q = torch.where(zone_rel_ok, shared.quota[g], 0)  # [K, Z]
        zl = (shared.zone_limited[g][:, None] | (zf != 0) | (zn != 0))  # [K, 1]

        # ---- fill open capacity (existing nodes first, then opened slots) ----
        opt_c = slot_opt.clamp(0, O - 1).long()
        comp_new = torch.gather(inputs.compat[g], 1, opt_c) & (slot_opt >= 0) & slot_active
        comp = torch.where(is_new, comp_new, shared.exok_pad[g])
        zb_slot = torch.gather(zone_bits, 1, slot_zone.long())
        rel_ok = (
            ((slot_bits & hf) == 0)
            & ((slot_bits & hn) == hn)
            & ((zb_slot & zf) == 0)
            & ((zb_slot & zn) == zn)
        )
        comp = comp & rel_ok
        d_fit = torch.where((rsvs & shared.rsv_group[g])[:, None], inputs.demand_units[g], d)
        fit = torch.where(comp, torch.minimum(_units(slot_rem, d_fit[:, None, :]), cap), 0)
        zmask = slot_zone[:, None, :] == zidx[None, :, None]  # [K, Z, NS]
        zfit = torch.where(zmask, fit[:, None, :], 0)
        before_z = _cumsum(zfit, 2) - zfit
        allow = torch.clamp(q[:, :, None] - before_z, min=0)
        fit_q = _isum(torch.where(zmask, torch.minimum(fit[:, None, :], allow), 0), 1)
        fit = torch.where(zl, fit_q, fit)
        fit = torch.where(coloc, torch.where(fit >= cnt, cnt, 0), fit)
        place = torch.minimum(torch.clamp(cnt - (_cumsum(fit, 1) - fit), min=0), fit)
        left = cnt - _isum(place, 1)[:, None]  # [K, 1]
        slot_rem = _fma(place.float()[:, :, None], -d[:, None, :], slot_rem)
        placed_z = _isum(torch.where(zmask, place[:, None, :], 0), 2)  # [K, Z]

        # ---- bucket wants -------------------------------------------------
        want_z = torch.minimum(torch.clamp(q - placed_z, min=0), left)
        before_w = _cumsum(want_z, 1) - want_z
        want_z = torch.clamp(torch.minimum(want_z, left - before_w), min=0)
        want = torch.where(
            zl,
            torch.cat([want_z, zero_col], 1),
            torch.cat([torch.zeros_like(want_z), left], 1),
        )  # [K, Zb]
        want = torch.where(hn == 0, want, 0)

        # ---- per-bucket option choice: lump vs mixed ----------------------
        safe_u = torch.clamp(u, min=1)[:, None, :]
        units_f = u.float()
        okb = opt_bucket_ok[None] & (u > 0)[:, None, :]  # [K, Zb, O]
        wb = want[:, :, None]
        k_all = _ceil_div(wb, safe_u)
        lump_score = torch.where(okb & (wb > 0), k_all.float() * pe[:, None, :], _INF)
        o_lump, cost_lump = _argmin_tiebreak(lump_score, units_f, alphas)
        rate = torch.where(
            okb & (u[:, None, :] <= wb),
            (pe / torch.clamp(units_f, min=1.0))[:, None, :],
            _INF,
        )
        o_rate, best_rate = _argmin_tiebreak(rate, units_f, alphas)
        c_rate = torch.gather(u, 1, o_rate)  # [K, Zb]
        n_full = torch.div(want, torch.clamp(c_rate, min=1), rounding_mode="floor")
        rem = want - n_full * c_rate
        rem_k = _ceil_div(rem[:, :, None], safe_u)
        rem_score = torch.where(okb & (rem[:, :, None] > 0), rem_k.float() * pe[:, None, :], _INF)
        o_tail, tail_best = _argmin_tiebreak(rem_score, units_f, alphas)
        tail_cost = torch.where(rem > 0, tail_best, 0.0)
        cost_mixed = torch.where(
            best_rate < _INF,
            _fma(n_full.float(), torch.gather(pe, 1, o_rate), tail_cost),
            _INF,
        )
        lump = cost_lump <= cost_mixed
        feasible = (want > 0) & (torch.minimum(cost_lump, cost_mixed) < _INF)

        # ---- segments: (full/lump) + tail per bucket ----------------------
        segA_opt = torch.where(lump, o_lump, o_rate)
        segA_c = torch.clamp(torch.gather(u, 1, segA_opt), min=1)
        segA_want = torch.where(feasible, torch.where(lump, want, n_full * c_rate), 0)
        segB_c = torch.clamp(torch.gather(u, 1, o_tail), min=1)
        segB_want = torch.where(feasible & ~lump, rem, 0)
        seg_opt = torch.cat([segA_opt, o_tail], 1)  # [K, 2Zb]
        seg_c = torch.cat([segA_c, segB_c], 1)
        seg_want = torch.cat([segA_want, segB_want], 1)
        seg_n = _ceil_div(seg_want, seg_c)
        seg_start = _cumsum(seg_n, 1) - seg_n
        total_open = _isum(seg_n, 1)[:, None]

        # ---- allocate free slots to segments ------------------------------
        free = is_new & ~slot_active
        fr = _cumsum(free.to(_I32), 1)  # 1-based rank among free slots
        take = free & (fr <= total_open)
        r0 = fr - 1
        sid = _isum((r0[:, :, None] >= seg_start[:, None, :]).to(_I32), 2) - 1
        sid = sid.clamp(0, seg_n.shape[1] - 1).long()
        o_i = torch.gather(seg_opt, 1, sid)
        c_i = torch.gather(seg_c, 1, sid)
        pos_i = r0 - torch.gather(seg_start, 1, sid)
        fill = torch.where(
            take,
            torch.minimum(torch.clamp(torch.gather(seg_want, 1, sid) - pos_i * c_i, min=0), c_i),
            0,
        )
        opened = _isum(fill, 1)[:, None]
        slot_rem = torch.where(
            take[:, :, None],
            _fma(fill.float()[:, :, None], -d[:, None, :], inputs.alloc[o_i]),
            slot_rem,
        )
        slot_opt = torch.where(take, o_i.to(_I32), slot_opt)
        slot_zone = torch.where(take, inputs.opt_zone[o_i], slot_zone)
        slot_active = slot_active | take
        left = left - opened
        unplaced = unplaced + left[:, 0]
        exhausted = exhausted | ((left[:, 0] > 0) & (total_open[:, 0] > _isum(free.to(_I32), 1)))
        yt = place + fill
        ys[:, t] = yt
        # publish this group's presence bits on every domain it landed in
        sm = inputs.rel_set[g][:, None]
        slot_bits = torch.where(yt > 0, slot_bits | sm, slot_bits)
        zmask2 = slot_zone[:, None, :] == zidx[None, :, None]
        zplaced2 = _isum(torch.where(zmask2, yt[:, None, :], 0), 2)
        zone_bits = torch.where(zplaced2 > 0, zone_bits | sm, zone_bits)

    new_opt = slot_opt[:, E:].contiguous()
    new_active = slot_active[:, E:] & (new_opt >= 0)
    node_prices = torch.where(new_active, inputs.price[new_opt.clamp(0, O - 1).long()], 0.0)
    cost = _fma(unplaced.float(), float(UNPLACED_PENALTY), node_prices.sum(1))
    return MemberOut(cost, unplaced, exhausted, new_opt, new_active, ys)


def phase2_members(orders, alphas, looks, rsvs, swaps, c1):
    """Phase-2 members: the phase-1 winner's order permuted by each swap
    pattern, all under the winner's scoring config."""
    b1 = torch.argmin(c1)
    K = orders.shape[0]
    return (
        orders[b1][swaps.long()],
        alphas[b1].expand(K).contiguous(),
        looks[b1].expand(K).contiguous(),
        rsvs[b1].expand(K).contiguous(),
    )


def pack_epilogue_ref(m1: MemberOut, m2: MemberOut) -> torch.Tensor:
    """Global argmin over both phases (first index wins) and the packed
    [4 + 2K + 2K + S + S + T*(E+S)] int32 buffer of ``_pack_solve_fused_impl``."""
    k = m1.cost.shape[0]
    costs = torch.cat([m1.cost, m2.cost])
    best = int(torch.argmin(costs))
    b1 = int(torch.argmin(m1.cost))
    phase, bk = int(best >= k), best - k if best >= k else best
    win = m2 if phase else m1
    dev = costs.device
    head = torch.tensor([phase, b1, bk, int(win.unplaced[bk])], dtype=_I32, device=dev)
    return torch.cat([
        head,
        costs.view(_I32),
        torch.cat([m1.exhausted, m2.exhausted]).to(_I32),
        win.new_opt[bk],
        win.new_active[bk].to(_I32),
        win.ys[bk].reshape(-1),
    ])


def pack_solve_fused_ref(
    inputs: PackInputs, orders, alphas, looks, rsvs, swaps, s_new: int, n_zones: int,
) -> torch.Tensor:
    """Full two-phase solve in plain PyTorch (``_pack_solve_fused_impl``)."""
    shared = shared_precompute_ref(inputs, s_new, n_zones)
    m1 = pack_member_ref(inputs, shared, orders, alphas, looks, rsvs, s_new, n_zones)
    orders2, alphas2, looks2, rsvs2 = phase2_members(orders, alphas, looks, rsvs, swaps, m1.cost)
    m2 = pack_member_ref(inputs, shared, orders2, alphas2, looks2, rsvs2, s_new, n_zones)
    return pack_epilogue_ref(m1, m2)


def pack_solve_fleet_ref(
    inputs: PackInputs, orders, alphas, looks, rsvs, swaps, s_new: int, n_zones: int,
) -> torch.Tensor:
    """B stacked problems, solved one row at a time by
    ``pack_solve_fused_ref``: the ``[B, L]`` buffer of ``pack_solve_fleet``."""
    return torch.stack([
        pack_solve_fused_ref(_row(inputs, b), orders[b], alphas[b], looks[b], rsvs[b],
                             swaps[b], s_new, n_zones)
        for b in range(orders.shape[0])
    ])


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _ptr(x: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if x is None else x.data_ptr())


def _check(name: str, x: torch.Tensor, dtype, shape, device) -> None:
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _dims(inputs: PackInputs):
    G, R = inputs.demand.shape[-2:]
    return G, inputs.price.shape[-1], inputs.ex_rem.shape[-2], R, inputs.rel_zone_bits.shape[-1]


def _lead(inputs: PackInputs) -> tuple:
    b = _batch(inputs)
    return () if b is None else (b,)


def _check_inputs(inputs: PackInputs, n_zones: int) -> None:
    G, O, E, R, Z = _dims(inputs)
    lead = _lead(inputs)
    shapes = {
        "demand": (G, R), "demand_units": (G, R), "count": (G,), "node_cap": (G,),
        "quota": (G, Z), "colocate": (G,), "compat": (G, O), "alloc": (O, R),
        "price": (O,), "opt_zone": (O,), "opt_valid": (O,), "ex_rem": (E, R),
        "ex_zone": (E,), "ex_compat": (G, E), "ex_valid": (E,), "rel_set": (G,),
        "rel_host_forbid": (G,), "rel_host_need": (G,), "rel_zone_forbid": (G,),
        "rel_zone_need": (G,), "rel_slot_bits": (E,), "rel_zone_bits": (Z,),
    }
    dev = inputs.demand.device
    for f in PackInputs._fields:
        _check(f, getattr(inputs, f), _FIELD_DTYPES[f], lead + shapes[f], dev)
    if n_zones != Z:
        raise ValueError(f"n_zones={n_zones} but the zone axis holds {Z}")
    if R > 8 or Z > 32 or G > 65535 or min(G, O, R, Z) < 1 or (lead and not 1 <= lead[0] <= 65535):
        raise ValueError(
            f"kernels take R <= 8, Z <= 32, G <= 65535, 1 <= B <= 65535, none empty; "
            f"got G={G} O={O} R={R} Z={Z} B={lead}"
        )


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.kts_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def _stream(device: Optional[torch.device] = None) -> ctypes.c_void_p:
    """The current stream of ``device`` (of the current device when None;
    a device with its index skips the lookup of the current one)."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _count(name: str, B: int = 1, n: int = 1) -> None:
    """Count ``n`` launches of wrapper ``name`` at batch width ``B``; every
    wrapper counts here, where it launches its kernel, and nowhere else."""
    with _COUNT_LOCK:
        LAUNCHES[name] += n
        if B > 1:
            BATCHED[name] += n


def _unsqueeze(nt):
    """One problem's NamedTuple of tensors as a batch of one."""
    return type(nt)(*(x.unsqueeze(0) for x in nt))


def shared_precompute(inputs: PackInputs, s_new: int, n_zones: int) -> Shared:
    """K1 on CUDA tensors; the plain version on CPU tensors. ``inputs`` may
    be one problem or a ``[B, ...]`` stack."""
    if inputs.demand.device.type == "cpu":
        if _batch(inputs) is None:
            return shared_precompute_ref(inputs, s_new, n_zones)
        return _stack([shared_precompute_ref(_row(inputs, b), s_new, n_zones)
                       for b in range(_batch(inputs))])
    _check_inputs(inputs, n_zones)
    from ._build import load_kernels

    return _launch_shared_precompute(load_kernels(), inputs, s_new, _stream())


def _launch_shared_precompute(lib, inputs: PackInputs, s_new: int, stream) -> Shared:
    unbatched = _batch(inputs) is None
    if unbatched:
        inputs = _unsqueeze(inputs)
    B = inputs.demand.shape[0]
    G, O, E, R, Z = _dims(inputs)
    dev = inputs.demand.device
    units = torch.empty((B, G, O), dtype=_I32, device=dev)
    units_rsv = torch.empty((B, G, O), dtype=_I32, device=dev)
    rsv_group = torch.empty((B, G), dtype=_BOOL, device=dev)
    lam = torch.empty((B, G), dtype=_F32, device=dev)
    zone_limited = torch.empty((B, G), dtype=_BOOL, device=dev)
    val_pair = torch.empty((B, G, O, G), dtype=_F32, device=dev)
    exok_pad = torch.empty((B, G, E + s_new), dtype=_BOOL, device=dev)
    is_new = torch.empty((B, E + s_new), dtype=_BOOL, device=dev)
    # scratch: k1_units' partial minima and flags, which k1_val_pair reduces
    scratch = torch.empty((int(lib.kts_shared_precompute_scratch(B, G, O)),), dtype=torch.uint8,
                          device=dev)
    rc = lib.kts_shared_precompute(
        _ptr(inputs.demand), _ptr(inputs.demand_units), _ptr(inputs.count),
        _ptr(inputs.node_cap), _ptr(inputs.quota), _ptr(inputs.colocate),
        _ptr(inputs.compat), _ptr(inputs.alloc), _ptr(inputs.price),
        _ptr(inputs.opt_valid), _ptr(inputs.ex_compat), _ptr(inputs.ex_valid),
        _ptr(units), _ptr(units_rsv), _ptr(rsv_group), _ptr(lam),
        _ptr(zone_limited), _ptr(val_pair), _ptr(exok_pad), _ptr(is_new), _ptr(scratch),
        B, G, O, E, R, Z, s_new, stream,
    )
    _count("shared_precompute", B)  # one call: k1_units, then k1_val_pair
    _raise_on(lib, rc, "shared_precompute")
    out = Shared(units, units_rsv, rsv_group, lam, inputs.quota, zone_limited,
                 val_pair, exok_pad, is_new)
    return _row(out, 0) if unbatched else out


def pack_member(
    inputs: PackInputs, shared: Shared, orders, alphas, looks, rsvs,
    s_new: int, n_zones: int, swaps=None, seed_costs=None,
) -> MemberOut:
    """K2: one phase of K members. With ``seed_costs`` (phase 2) member k
    scans ``orders[argmin(seed_costs)][swaps[k]]`` under the seed's config,
    derived on the device. Every argument may carry a leading batch axis B
    (then all do), and a row's phase 2 takes its own row's seed. The plain
    version on CPU tensors."""
    B = _batch(inputs)
    if inputs.demand.device.type == "cpu":
        if B is not None:
            return _stack([
                pack_member(_row(inputs, b), _row(shared, b), orders[b], alphas[b], looks[b],
                            rsvs[b], s_new, n_zones,
                            None if seed_costs is None else swaps[b],
                            None if seed_costs is None else seed_costs[b])
                for b in range(B)
            ])
        if seed_costs is not None:
            orders, alphas, looks, rsvs = phase2_members(orders, alphas, looks, rsvs, swaps, seed_costs)
        return pack_member_ref(inputs, shared, orders, alphas, looks, rsvs, s_new, n_zones)
    _check_inputs(inputs, n_zones)
    G, O, E, R, Z = _dims(inputs)
    lead = _lead(inputs)
    K = orders.shape[-2]
    NS = E + s_new
    dev = inputs.demand.device
    _check("orders", orders, _I32, lead + (K, G), dev)
    _check("alphas", alphas, _F32, lead + (K,), dev)
    _check("looks", looks, _BOOL, lead + (K,), dev)
    _check("rsvs", rsvs, _BOOL, lead + (K,), dev)
    if seed_costs is not None:
        _check("swaps", swaps, _I32, lead + (K, G), dev)
        _check("seed_costs", seed_costs, _F32, lead + (K,), dev)
    for name, shape, dt in (
        ("units", (G, O), _I32), ("units_rsv", (G, O), _I32), ("rsv_group", (G,), _BOOL),
        ("zone_limited", (G,), _BOOL), ("val_pair", (G, O, G), _F32),
        ("exok_pad", (G, NS), _BOOL), ("quota", (G, Z), _I32),
    ):
        _check(name, getattr(shared, name), dt, lead + shape, dev)
    from ._build import load_kernels

    return _launch_pack_member(
        load_kernels(), inputs, shared, orders, alphas, looks, rsvs, s_new,
        swaps if seed_costs is not None else None, seed_costs, _stream(),
    )


def pack_member_scratch(lib, G: int, O: int, R: int, Z: int, NS: int,
                        smem_limit: Optional[int] = None) -> int:
    """Bytes of global scratch one member of K2 needs: 0 when the scan keeps
    its staged groups and per-step state in shared memory, else what spills
    (the state, then the groups too), which the same code then reads from
    global memory. The plan is the kernels' own (``kts_pack_member_scratch``),
    against the card's opt-in limit of shared memory a block less the scan's
    static shared memory; ``smem_limit`` plans against a smaller limit in
    its place, which is how the tests force each placement."""
    n = int(lib.kts_pack_member_scratch(G, O, R, Z, NS, smem_limit or 0))
    if n == -1:
        raise RuntimeError("pack_member: cannot read the device's shared memory limits")
    if n < 0:
        where = f"{smem_limit} bytes" if smem_limit else "the card's opt-in limit"
        raise RuntimeError(f"pack_member: no memory plan fits G={G} groups, Z={Z} zones "
                           f"in {where} of shared memory a block")
    return n


def _launch_pack_member(
    lib, inputs: PackInputs, shared: Shared, orders, alphas, looks, rsvs, s_new: int,
    swaps, seed_costs, stream, smem_limit: Optional[int] = None,
) -> MemberOut:
    unbatched = _batch(inputs) is None
    if unbatched:
        inputs, shared = _unsqueeze(inputs), _unsqueeze(shared)
        orders, alphas, looks, rsvs = (x.unsqueeze(0) for x in (orders, alphas, looks, rsvs))
        swaps, seed_costs = (None if x is None else x.unsqueeze(0) for x in (swaps, seed_costs))
    G, O, E, R, Z = _dims(inputs)
    B, K = orders.shape[0], orders.shape[1]
    NS = E + s_new
    dev = inputs.demand.device
    cost = torch.empty((B, K), dtype=_F32, device=dev)
    unplaced = torch.empty((B, K), dtype=_I32, device=dev)
    exhausted = torch.empty((B, K), dtype=_BOOL, device=dev)
    new_opt = torch.empty((B, K, s_new), dtype=_I32, device=dev)
    new_active = torch.empty((B, K, s_new), dtype=_BOOL, device=dev)
    ys = torch.empty((B, K, G, NS), dtype=_I32, device=dev)
    # scratch: the lookahead members' prices, and what of the scan's memory
    # does not fit in shared memory
    price_t = torch.empty((B, K, G, O), dtype=_F32, device=dev)
    scratch = pack_member_scratch(lib, G, O, R, Z, NS, smem_limit)
    state = torch.empty((B, K, scratch), dtype=torch.uint8, device=dev) if scratch else None
    rc = lib.kts_pack_member(
        _ptr(inputs.demand), _ptr(inputs.demand_units), _ptr(inputs.count),
        _ptr(inputs.node_cap), _ptr(inputs.colocate), _ptr(inputs.compat),
        _ptr(inputs.alloc), _ptr(inputs.price), _ptr(inputs.opt_zone),
        _ptr(inputs.ex_rem), _ptr(inputs.ex_zone), _ptr(inputs.ex_valid),
        _ptr(inputs.rel_set), _ptr(inputs.rel_host_forbid), _ptr(inputs.rel_host_need),
        _ptr(inputs.rel_zone_forbid), _ptr(inputs.rel_zone_need),
        _ptr(inputs.rel_slot_bits), _ptr(inputs.rel_zone_bits),
        _ptr(shared.units), _ptr(shared.units_rsv), _ptr(shared.rsv_group),
        _ptr(shared.quota), _ptr(shared.zone_limited), _ptr(shared.val_pair),
        _ptr(shared.exok_pad),
        _ptr(orders), _ptr(alphas), _ptr(looks), _ptr(rsvs),
        _ptr(swaps), _ptr(seed_costs),
        _ptr(cost), _ptr(unplaced), _ptr(exhausted), _ptr(new_opt), _ptr(new_active),
        _ptr(ys), _ptr(price_t), _ptr(state),
        B, K, G, O, E, R, Z, s_new, smem_limit or 0, stream,
    )
    _count("pack_member", B)  # one call: k2_prices, then k2_scan
    _raise_on(lib, rc, "pack_member")
    out = MemberOut(cost, unplaced, exhausted, new_opt, new_active, ys)
    return _row(out, 0) if unbatched else out


def pack_epilogue(m1: MemberOut, m2: MemberOut) -> torch.Tensor:
    """K3: the cross-phase argmin and result buffer, ``[L]`` for one problem
    or ``[B, L]`` for a batch. The plain version on CPU tensors."""
    batched = m1.cost.dim() == 2
    if m1.cost.device.type == "cpu":
        if not batched:
            return pack_epilogue_ref(m1, m2)
        return torch.stack([pack_epilogue_ref(_row(m1, b), _row(m2, b))
                            for b in range(m1.cost.shape[0])])
    K, T, NS = m1.ys.shape[-3:]
    S = m1.new_opt.shape[-1]
    lead = tuple(m1.cost.shape[:-1])
    dev = m1.cost.device
    for m in (m1, m2):
        _check("cost", m.cost, _F32, lead + (K,), dev)
        _check("unplaced", m.unplaced, _I32, lead + (K,), dev)
        _check("exhausted", m.exhausted, _BOOL, lead + (K,), dev)
        _check("new_opt", m.new_opt, _I32, lead + (K, S), dev)
        _check("new_active", m.new_active, _BOOL, lead + (K, S), dev)
        _check("ys", m.ys, _I32, lead + (K, T, NS), dev)
    from ._build import load_kernels

    return _launch_pack_epilogue(load_kernels(), m1, m2, _stream())


def _launch_pack_epilogue(lib, m1: MemberOut, m2: MemberOut, stream) -> torch.Tensor:
    unbatched = m1.cost.dim() == 1
    if unbatched:
        m1, m2 = _unsqueeze(m1), _unsqueeze(m2)
    B, K, T, NS = m1.ys.shape
    S = m1.new_opt.shape[2]
    buf = torch.empty((B, 4 + 4 * K + 2 * S + T * NS), dtype=_I32, device=m1.cost.device)
    rc = lib.kts_pack_epilogue(
        _ptr(m1.cost), _ptr(m1.unplaced), _ptr(m1.exhausted), _ptr(m1.new_opt),
        _ptr(m1.new_active), _ptr(m1.ys),
        _ptr(m2.cost), _ptr(m2.unplaced), _ptr(m2.exhausted), _ptr(m2.new_opt),
        _ptr(m2.new_active), _ptr(m2.ys),
        _ptr(buf), B, K, T, NS, S, stream,
    )
    _count("pack_epilogue", B)
    _raise_on(lib, rc, "pack_epilogue")
    return buf[0] if unbatched else buf


def pack_solve_fused(
    inputs: PackInputs, orders, alphas, looks, rsvs, swaps, s_new: int, n_zones: int,
) -> torch.Tensor:
    """The whole two-phase solve: K1, K2 (phase 1), K2 (phase 2), K3 on the
    current stream for CUDA tensors, with no host sync between them; the
    plain version for CPU tensors. With ``[B, ...]`` arguments the same four
    launches solve the whole batch and return a ``[B, L]`` buffer."""
    if inputs.demand.device.type == "cpu":
        if _batch(inputs) is not None:
            return pack_solve_fleet_ref(inputs, orders, alphas, looks, rsvs, swaps, s_new, n_zones)
        return pack_solve_fused_ref(inputs, orders, alphas, looks, rsvs, swaps, s_new, n_zones)
    shared = shared_precompute(inputs, s_new, n_zones)
    m1 = pack_member(inputs, shared, orders, alphas, looks, rsvs, s_new, n_zones)
    m2 = pack_member(inputs, shared, orders, alphas, looks, rsvs, s_new, n_zones,
                     swaps=swaps, seed_costs=m1.cost)
    return pack_epilogue(m1, m2)


def pack_solve_fleet(
    inputs: PackInputs, orders, alphas, looks, rsvs, swaps, s_new: int, n_zones: int,
) -> torch.Tensor:
    """Fleet dispatch (``jax_solver.pack_solve_fleet``): B shape-identical
    problems stacked on a leading axis, solved in one K1, K2, K2, K3 chain.
    Row b of the ``[B, L]`` buffer equals the B=1 buffer of problem b;
    ``fleet_padding`` rows pack nothing and cost 0."""
    if _batch(inputs) is None:
        raise ValueError("pack_solve_fleet takes [B, ...] stacked inputs")
    return pack_solve_fused(inputs, orders, alphas, looks, rsvs, swaps, s_new, n_zones)


def pack_solve_meshed(
    mesh, inputs: PackInputs, orders, alphas, looks, rsvs, swaps, s_new: int, n_zones: int,
) -> torch.Tensor:
    """The two-phase solve over the shards of ``mesh``
    (``parallel.mesh.Mesh``): ``inputs`` and the member arrays are placed
    leaves (``parallel.mesh.Placed``, from ``shard_portfolio``,
    ``shard_fleet``, ``shard_problem2d``, ``shard_superproblem`` or the
    stager's mesh placement), of one problem or a ``[B, ...]`` stack. On the
    1D mesh the members split over the shards (a fleet's rows split
    instead); on the 2D mesh the option columns split over ``options`` and a
    superproblem's rows over ``fleet``. Returns the ``[L]`` or ``[B, L]``
    buffer of ``pack_solve_fused`` on the first shard's device, equal to the
    un-meshed chain's bit for bit; the caller's current stream is ordered
    after it. See ``meshed.py``."""
    from .meshed import solve_meshed

    return solve_meshed(mesh, inputs, orders, alphas, looks, rsvs, swaps, s_new, n_zones)


def rtt_probe_ref(x: torch.Tensor) -> torch.Tensor:
    return x + 1


def rtt_probe(x: torch.Tensor) -> torch.Tensor:
    """``x + 1`` on a 1-D int32 tensor: the probe kernel on a CUDA tensor,
    launched on the current stream; the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return rtt_probe_ref(x)
    _check("x", x, _I32, (x.shape[0] if x.dim() == 1 else -1,), x.device)
    from ._build import load_kernels

    return _launch_rtt_probe(load_kernels(), x, _stream())


def _launch_rtt_probe(lib, x: torch.Tensor, stream) -> torch.Tensor:
    y = torch.empty_like(x)
    rc = lib.kts_rtt_probe(_ptr(x), _ptr(y), x.numel(), stream)
    _count("rtt_probe")
    _raise_on(lib, rc, "rtt_probe")
    return y


def unpack_solve_fused(
    buf: np.ndarray, k: int, s_new: int, g: int, e_pad: int,
    orders: np.ndarray, swaps: np.ndarray,
):
    """Host-side unpacking of the fused buffer; reconstructs the winning
    order (phase-1 member, or the phase-1 winner's order permuted by the
    winning swap pattern)."""
    phase, b1, bk, unplaced = int(buf[0]), int(buf[1]), int(buf[2]), int(buf[3])
    off = 4
    costs = np.frombuffer(buf[off : off + 2 * k].tobytes(), dtype=np.float32)
    off += 2 * k
    exhausted = buf[off : off + 2 * k].astype(bool)
    off += 2 * k
    new_opt = buf[off : off + s_new]
    off += s_new
    new_active = buf[off : off + s_new].astype(bool)
    off += s_new
    ys = buf[off:].reshape(g, e_pad + s_new)
    order = orders[bk] if phase == 0 else orders[b1][swaps[bk]]
    return order, unplaced, costs, exhausted, new_opt, new_active, ys


# ---------------------------------------------------------------------------
# Bucketed shape lattice and portfolio construction
# ---------------------------------------------------------------------------

def _pow2(n: int, floor: int = 8) -> int:
    return max(floor, 1 << (max(n, 1) - 1).bit_length())


def bucket_groups(g: int) -> int:
    return _pow2(g, 8)


def bucket_options(o: int) -> int:
    return _pow2(o, 8)


def bucket_existing(e: int) -> int:
    # E=0 keeps a single padding column; with existing capacity a coarse
    # floor keeps a consolidation sweep on a handful of shapes
    return _pow2(e, 64) if e else 1


def bucket_zones(z: int) -> int:
    return _pow2(max(z, 1), 1)


def bucket_fleet(b: int) -> int:
    """Fleet (batched-cell) axis bucket: pow2 with floor 2, so a sharded
    round's varying dirty-cell count lands on a handful of fleet widths.
    B=1 stays 1."""
    return 1 if b <= 1 else _pow2(b, 2)


class BucketKey(NamedTuple):
    """The padded-dimension tuple one problem shape quantizes to."""

    G: int  # padded group rows
    O: int  # padded option columns
    E: int  # padded existing-capacity slots
    S: int  # new-node slot budget
    Z: int  # padded zone axis
    R: int  # resource axes
    K: int  # portfolio members
    # fleet width: B > 1 keys a dispatch of B stacked problems of this shape;
    # B == 1 is the single-problem solve and keeps the plain label
    B: int = 1
    # meshed-tier dims: the (options, fleet) mesh shape a dispatch is split
    # over; (1, 1) is the un-meshed solve and keeps the plain label
    MO: int = 1
    MF: int = 1

    def label(self) -> str:
        base = f"g{self.G}o{self.O}e{self.E}s{self.S}z{self.Z}r{self.R}k{self.K}"
        if self.B > 1:
            base = f"{base}b{self.B}"
        if self.MO > 1 or self.MF > 1:
            base = f"{base}m{self.MO}x{self.MF}"
        return base


def bucket_key(g: int, o: int, e: int, s_new: int, z: int, r: int, k: int) -> BucketKey:
    return BucketKey(
        G=bucket_groups(g), O=bucket_options(o), E=bucket_existing(e),
        S=s_new, Z=bucket_zones(z), R=r, K=k,
    )


class _AOTEntry:
    """One resident bucket: the EWMA of its measured dispatch latency, the
    samples it has learned and the last of them."""

    __slots__ = ("dispatch_ewma", "samples", "last_s")

    def __init__(self):
        self.dispatch_ewma: Optional[float] = None
        self.samples = 0
        self.last_s: Optional[float] = None


class AOTCache:
    """The live half of the JAX package's ``AOTCache``: per bucket, the
    EWMA of the measured time from a dispatch to its result being ready on
    the host, which the race's admission reads in place of the process's
    device round trip (``TorchSolver._race_dispatch_affordable``,
    ``stage_fleet``).

    The reference's entry also holds the bucket's compiled executable. The
    port compiles nothing per shape (one kernel library serves every
    bucket), so this table holds only the dispatch-latency half: an entry
    is made at a bucket's first dispatch (``KernelBreakerBoard.
    first_dispatch``, where the reference compiles), learns ``0.7 * old +
    0.3 * new`` from every sample after the first, which it takes as is,
    and goes when its label's breaker opens (``evict_bucket``) or when the
    least recently dispatched of more than ``capacity`` entries is dropped.
    Keys are the reference's: the bucket key (with the 2D mesh's stamp),
    ``donate`` (always False: the port donates no buffer) and the mesh's
    axes and shape. ``refusals`` counts, by bucket label, the dispatches
    that admission turned away, with the prediction and the last sample
    that set it. Process-wide, as the reference's is: every solver and
    clone shares ``AOT_CACHE``."""

    def __init__(self, capacity: int = 32):
        self.capacity = capacity
        self._lock = threading.RLock()
        self._entries: "OrderedDict[tuple, _AOTEntry]" = OrderedDict()
        self.stats: Dict[str, int] = {"hits": 0, "misses": 0, "evictions": 0}
        self.refusals: Dict[str, list] = {}

    def configure(self, capacity: Optional[int] = None) -> None:
        with self._lock:
            if capacity is not None:
                self.capacity = max(int(capacity), 1)
                self._evict_over_capacity()

    @staticmethod
    def _ckey(key: BucketKey, donate: bool = False, mesh=None) -> tuple:
        if mesh is None:
            return (key, bool(donate), 0)
        return (key, bool(donate), (tuple(mesh.axis_names), tuple(mesh.devices.shape)))

    def resident(self, key: BucketKey, mesh=None) -> bool:
        """Whether the bucket has an entry; a dispatch's lookup (a hit moves
        it to the end of the LRU order)."""
        ck = self._ckey(key, False, mesh)
        with self._lock:
            if ck not in self._entries:
                self.stats["misses"] += 1
                return False
            self._entries.move_to_end(ck)
            self.stats["hits"] += 1
            return True

    def build(self, key: BucketKey, mesh=None) -> None:
        """Make the bucket's entry (no sample yet); the reference compiles
        here."""
        ck = self._ckey(key, False, mesh)
        with self._lock:
            if ck not in self._entries:
                self._entries[ck] = _AOTEntry()
            self._entries.move_to_end(ck)
            self._evict_over_capacity()

    def _evict_over_capacity(self) -> None:
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.stats["evictions"] += 1
            self._count("evict")

    def evict_bucket(self, label: str) -> int:
        """Drop every variant (mesh) of the bucket with this label: its
        breaker opened. Returns how many entries went."""
        with self._lock:
            victims = [ck for ck in self._entries if ck[0].label() == label]
            for ck in victims:
                del self._entries[ck]
            self.stats["evictions"] += len(victims)
        for _ in victims:
            self._count("evict")
        return len(victims)

    @staticmethod
    def _count(event: str) -> None:
        from ..utils import metrics

        metrics.AOT_CACHE_EVENTS.inc({"event": event})

    def note_dispatch(self, key: BucketKey, seconds: float, donate: bool = False,
                      mesh=None) -> None:
        """One measured dispatch of the bucket: the perf sentinel's
        per-bucket feed always, the EWMA once the bucket has an entry."""
        from ..utils import profiling

        profiling.note_bucket_dispatch(key.label(), seconds)
        ck = self._ckey(key, donate, mesh)
        with self._lock:
            entry = self._entries.get(ck)
            if entry is None:
                return
            if entry.dispatch_ewma is None:
                entry.dispatch_ewma = seconds
            else:
                entry.dispatch_ewma = 0.7 * entry.dispatch_ewma + 0.3 * seconds
            entry.samples += 1
            entry.last_s = seconds

    def predicted_dispatch_s(self, key: BucketKey, donate: bool = False,
                             mesh=None) -> Optional[float]:
        """The bucket's dispatch-latency EWMA, or None when it has no entry
        or no sample yet (the caller falls back to the round trip)."""
        ck = self._ckey(key, donate, mesh)
        with self._lock:
            entry = self._entries.get(ck)
            return None if entry is None else entry.dispatch_ewma

    def note_refusal(self, key: BucketKey, predicted_s: float, mesh=None) -> None:
        """Admission turned a dispatch of the bucket away on ``predicted_s``."""
        ck = self._ckey(key, False, mesh)
        with self._lock:
            entry = self._entries.get(ck)
            row = self.refusals.setdefault(key.label(), [0, None, None])
            row[0] += 1
            row[1] = predicted_s
            row[2] = None if entry is None else entry.last_s

    def table(self) -> List[tuple]:
        """``(label, ewma, samples, last sample)`` of every entry, oldest
        first."""
        with self._lock:
            return [(ck[0].label(), e.dispatch_ewma, e.samples, e.last_s)
                    for ck, e in self._entries.items()]

    def stats_dict(self) -> Dict[str, object]:
        with self._lock:
            return {
                **self.stats,
                "resident": len(self._entries),
                "capacity": self.capacity,
                "buckets": [ck[0].label() for ck in self._entries],
                "refusals": {label: row[0] for label, row in self.refusals.items()},
            }

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.refusals.clear()
            self.stats.update(hits=0, misses=0, evictions=0)


#: process-wide: every solver and clone shares one table
AOT_CACHE = AOTCache()


def make_orders(
    sizes: np.ndarray, count: np.ndarray, k: int, seed: int = 0,
    layer: Optional[np.ndarray] = None, has_reserve: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Portfolio construction: K × (group ordering, tiebreak exponent,
    lookahead) plus K phase-2 swap patterns, from numpy's
    ``default_rng(seed)`` so that orders match the JAX package bit for bit.

    Member 0 is plain FFD (size-descending), member 1 FFD with lookahead;
    the others perturb the ordering with multiplicative noise, sweep the
    tiebreak preference and alternate lookahead. ``swaps[0]`` is the
    identity, the rest compose 1..4 random transpositions."""
    g = sizes.shape[0]
    rng = np.random.default_rng(seed)
    orders = np.empty((k, g), dtype=np.int32)
    alphas = np.empty((k,), dtype=np.float32)
    looks = np.zeros((k,), dtype=bool)
    base_alphas = [1.0, 1.0, 0.85, 0.85, 1.15, 0.7, 1.0, 0.9]
    # noise covers only the real (count > 0) prefix, so that orders do not
    # depend on how far the group axis was padded
    n_real = max(int(np.count_nonzero(count)), 1)
    for i in range(k):
        if i in (0, 1):
            key = -sizes
        elif i in (2, 3):
            key = -sizes * count  # total-footprint descending
        else:
            noise = np.ones(g)
            noise[:n_real] = rng.uniform(0.6, 1.4, size=n_real)
            key = -sizes * noise
        perm = np.argsort(key, kind="stable").astype(np.int32)
        if layer is not None:
            # providers (lower layer) are scanned before their requirers
            perm = perm[np.argsort(layer[perm], kind="stable")]
        orders[i] = perm
        alphas[i] = base_alphas[i % len(base_alphas)]
        looks[i] = i % 2 == 1
    swaps = np.tile(np.arange(g, dtype=np.int32), (k, 1))
    for i in range(1, k):
        for _ in range(1 + int(rng.integers(0, 4))):
            a, b = rng.integers(0, n_real, size=2)
            swaps[i, [a, b]] = swaps[i, [b, a]]
    # reserve-sized members: half the portfolio sizes provider nodes with
    # requirer headroom when hostname-affinity requirers exist
    rsvs = np.zeros((k,), bool)
    if has_reserve:
        rsvs[::2] = True
    return orders, alphas, looks, rsvs, swaps


def fleet_padding(key: BucketKey):
    """One inert fleet row for padding a batch up to its pow2 width: a
    zero-pod problem on ``key``'s shape (count all zero, no valid options at
    INF price, no existing slots, IBIG quotas). Every scan step places,
    wants and opens nothing, so its member costs are 0 and it cannot touch
    the real rows. Orders and swaps are the identity. Returns ``(fields,
    orders, alphas, looks, rsvs, swaps)`` as numpy, ``fields`` holding the
    ``PackInputs`` arrays as ``TorchSolver._prepare`` does."""
    G, O, E, Z, R, K = key.G, key.O, key.E, key.Z, key.R, key.K
    fields = dict(
        demand=np.zeros((G, R), np.float32),
        demand_units=np.zeros((G, R), np.float32),
        count=np.zeros((G,), np.int32),
        node_cap=np.full((G,), IBIG, np.int32),
        quota=np.full((G, Z), IBIG, np.int32),
        colocate=np.zeros((G,), bool),
        compat=np.zeros((G, O), bool),
        alloc=np.zeros((O, R), np.float32),
        price=np.full((O,), INF, np.float32),
        opt_zone=np.zeros((O,), np.int32),
        opt_valid=np.zeros((O,), bool),
        ex_rem=np.zeros((E, R), np.float32),
        ex_zone=np.zeros((E,), np.int32),
        ex_compat=np.zeros((G, E), bool),
        ex_valid=np.zeros((E,), bool),
        **{f: np.zeros((n,), np.int32) for f, n in (
            ("rel_set", G), ("rel_host_forbid", G), ("rel_host_need", G),
            ("rel_zone_forbid", G), ("rel_zone_need", G), ("rel_slot_bits", E),
            ("rel_zone_bits", Z),
        )},
    )
    ident = np.tile(np.arange(G, dtype=np.int32), (K, 1))
    return (fields, ident, np.ones((K,), np.float32), np.zeros((K,), bool),
            np.zeros((K,), bool), ident.copy())
