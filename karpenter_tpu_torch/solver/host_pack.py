"""Host-side topology-aware packer: one grouped-FFD member in numpy.

The race competitor for NON-LP-safe shapes: a slow device link's round
trip must never be the latency floor, so the same grouped FFD the kernel
runs per member (``torch_solver.pack_member``) runs here as
a single host member in a few milliseconds. Semantics match the kernel step
for step — per-group caps, zone quotas, colocation, relation bitmasks,
reserve sizing — so its output feeds the same count-level validator and
decoder. The kernel, when it answers inside the budget, usually wins on cost
(32 members + lookahead + phase-2 search); this member guards latency.

Reference baseline being beaten: the single-threaded per-POD Go loop
(upstream ``designs/bin-packing.md:16-43``) — this runs per GROUP
with vectorized slot arithmetic, so 10k pods cost ~a dozen steps.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

IBIG = np.int64(1 << 30)
LOOKAHEAD_DISCOUNT = 0.9
LOOKAHEAD_FLOOR = 0.25


class HostShared(NamedTuple):
    """Order-independent precompute shared by every host member (the numpy
    mirror of torch_solver.shared_precompute)."""

    units: np.ndarray  # [G, O] i64 (reserve-sized when the problem has one)
    lam: np.ndarray  # [G] f64 cheapest per-pod rate
    val_pair: np.ndarray  # [G, O, G'] f64 residual value (lookahead)


def host_shared(inputs) -> HostShared:
    demand = np.asarray(inputs.demand, np.float64)
    demand_units = np.asarray(inputs.demand_units, np.float64)
    count = np.asarray(inputs.count, np.int64)
    node_cap = np.asarray(inputs.node_cap, np.int64)
    colocate = np.asarray(inputs.colocate, bool)
    compat = np.asarray(inputs.compat, bool)
    alloc = np.asarray(inputs.alloc, np.float64)
    price = np.asarray(inputs.price, np.float64)
    opt_valid = np.asarray(inputs.opt_valid, bool)
    has_reserve = bool((demand_units != demand).any())
    ok = compat & opt_valid[None, :]

    def sized(dd):
        with np.errstate(divide="ignore", invalid="ignore"):
            safe = np.where(
                dd[:, None, :] > 0,
                alloc[None, :, :] / np.maximum(dd[:, None, :], 1e-30),
                np.inf,
            )
            u = np.floor(np.min(safe, axis=2) + 1e-4)
        return np.clip(np.where(np.isfinite(u), u, IBIG), 0, IBIG).astype(np.int64)

    units_raw = sized(demand)
    if has_reserve:
        units = sized(demand_units)
        row_fits = ((units > 0) & ok).any(axis=1, keepdims=True)
        units = np.where(~row_fits & (units_raw > 0), units_raw, units)
    else:
        units = units_raw
    units = np.minimum(units, node_cap[:, None])
    units = np.where(ok, units, 0)
    units = np.where(colocate[:, None], np.where(units >= count[:, None], units, 0), units)

    units_f = units.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        rate = np.where(units > 0, price[None, :] / np.maximum(units_f, 1.0), np.inf)
    lam_raw = rate.min(axis=1)
    lam = np.where(np.isfinite(lam_raw), lam_raw, 0.0)

    # lookahead value table (small: G is group count, not pod count)
    resid = alloc[None, :, :] - units_f[:, :, None] * demand[:, None, :]  # [G, O, R]
    with np.errstate(divide="ignore", invalid="ignore"):
        u2 = None
        for r in range(demand.shape[1]):
            dr = demand[:, r]
            ur = np.where(
                dr[None, None, :] > 0,
                np.floor(resid[:, :, r : r + 1] / np.maximum(dr[None, None, :], 1e-30) + 1e-4),
                np.inf,
            )
            u2 = ur if u2 is None else np.minimum(u2, ur)
    u2 = np.clip(np.where(np.isfinite(u2), u2, IBIG), 0, IBIG)
    u2 = np.minimum(u2, node_cap[None, None, :].astype(np.float64))
    val_pair = np.where(ok.T[None, :, :] & (u2 > 0), u2 * lam[None, None, :], 0.0)
    return HostShared(units=units, lam=lam, val_pair=val_pair)


def _pick(score: np.ndarray, units: np.ndarray, alpha: float) -> int:
    """Argmin with the kernel's tiebreak: within 0.01% of best, alpha >= 1
    prefers the larger node, alpha < 1 the smaller."""
    best = score.min()
    if not np.isfinite(best):
        return int(np.argmin(score))
    cand = score <= best * 1.0001
    pref = units if alpha >= 1.0 else -units
    return int(np.argmax(np.where(cand, pref, -np.inf)))


def _units_rows(rem: np.ndarray, d: np.ndarray) -> np.ndarray:
    """Whole pods of per-pod demand d fitting in each remaining vector."""
    with np.errstate(divide="ignore", invalid="ignore"):
        safe = np.where(d[None, :] > 0, rem / np.maximum(d[None, :], 1e-30), np.inf)
    u = np.floor(np.min(safe, axis=1) + 1e-4)
    return np.clip(np.where(np.isfinite(u), u, IBIG), 0, IBIG).astype(np.int64)


def _greedy_fill(fit: np.ndarray, want: int) -> np.ndarray:
    before = np.cumsum(fit) - fit
    return np.clip(want - before, 0, fit)


def host_pack(
    inputs,
    shared: HostShared,
    order: np.ndarray,
    s_new: int,
    n_zones: int,
    alpha: float = 1.0,
    look: bool = False,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, int]]:
    """Run one FFD member over ``order``; returns (new_opt, new_active,
    ys[T, E+S], unplaced) in the kernel's output convention, or None when the
    slot budget is exhausted (caller may retry with more slots)."""
    demand = np.asarray(inputs.demand, np.float64)
    demand_units = np.asarray(inputs.demand_units, np.float64)
    count = np.asarray(inputs.count, np.int64)
    node_cap = np.asarray(inputs.node_cap, np.int64)
    quota = np.asarray(inputs.quota, np.int64)
    colocate = np.asarray(inputs.colocate, bool)
    compat = np.asarray(inputs.compat, bool)
    alloc = np.asarray(inputs.alloc, np.float64)
    price = np.asarray(inputs.price, np.float64)
    opt_zone = np.asarray(inputs.opt_zone, np.int64)
    opt_valid = np.asarray(inputs.opt_valid, bool)
    ex_rem = np.asarray(inputs.ex_rem, np.float64)
    ex_zone = np.asarray(inputs.ex_zone, np.int64)
    ex_compat = np.asarray(inputs.ex_compat, bool)
    ex_valid = np.asarray(inputs.ex_valid, bool)
    rel_set = np.asarray(inputs.rel_set, np.int64)
    rel_hf = np.asarray(inputs.rel_host_forbid, np.int64)
    rel_hn = np.asarray(inputs.rel_host_need, np.int64)
    rel_zf = np.asarray(inputs.rel_zone_forbid, np.int64)
    rel_zn = np.asarray(inputs.rel_zone_need, np.int64)

    G, R = demand.shape
    O = price.shape[0]
    E = ex_rem.shape[0]
    NS = E + s_new
    T = order.shape[0]

    has_reserve = bool((demand_units != demand).any())
    units = shared.units

    # lookahead effective prices per scan position (kernel price_t): an
    # option's price is discounted by the residual value its nodes offer to
    # groups LATER in this member's order
    if look:
        pos = np.zeros(G, np.int64)
        pos[order] = np.arange(T)
        later = pos[None, :] > np.arange(T)[:, None]  # [T, G']
        vp = shared.val_pair[order]  # [T, O, G']
        val_t = np.max(np.where(later[:, None, :], vp, 0.0), axis=-1)  # [T, O]
        price_t = np.maximum(
            price[None, :] - LOOKAHEAD_DISCOUNT * val_t, LOOKAHEAD_FLOOR * price[None, :]
        )
    else:
        price_t = np.broadcast_to(price[None, :], (T, O))

    # slot state
    slot_rem = np.zeros((NS, R), np.float64)
    slot_rem[:E] = ex_rem
    slot_opt = np.full(NS, -1, np.int64)
    slot_zone = np.zeros(NS, np.int64)
    slot_zone[:E] = ex_zone
    slot_active = np.zeros(NS, bool)
    slot_active[:E] = ex_valid
    slot_bits = np.zeros(NS, np.int64)
    slot_bits[:E] = np.asarray(inputs.rel_slot_bits, np.int64)
    zone_bits = np.asarray(inputs.rel_zone_bits, np.int64)[:n_zones].copy()
    is_new = np.arange(NS) >= E
    cursor = E  # next free new slot

    ys = np.zeros((T, NS), np.int64)
    unplaced = 0

    for t in range(T):
        g = int(order[t])
        cnt = int(count[g])
        if cnt <= 0:
            continue
        d = demand[g]
        cap = int(node_cap[g])
        hf, hn, zf, zn = int(rel_hf[g]), int(rel_hn[g]), int(rel_zf[g]), int(rel_zn[g])
        zone_rel_ok = ((zone_bits & zf) == 0) & ((zone_bits & zn) == zn)
        q = np.where(zone_rel_ok, quota[g], 0)
        zl = bool((quota[g] < IBIG).any()) or zf != 0 or zn != 0
        d_fit = demand_units[g] if (has_reserve and (demand_units[g] != d).any()) else d

        # ---- fill open capacity ----
        comp = np.zeros(NS, bool)
        comp[:E] = ex_compat[g] & ex_valid
        nz = np.flatnonzero(is_new & slot_active & (slot_opt >= 0))
        if nz.size:
            comp[nz] = compat[g, slot_opt[nz]]
        fit = np.zeros(NS, np.int64)
        sub = np.flatnonzero(comp)
        if sub.size:
            rel_ok = (
                ((slot_bits[sub] & hf) == 0)
                & ((slot_bits[sub] & hn) == hn)
                & ((zone_bits[slot_zone[sub]] & zf) == 0)
                & ((zone_bits[slot_zone[sub]] & zn) == zn)
            )
            sub = sub[rel_ok]
        if sub.size:
            fit[sub] = np.minimum(_units_rows(slot_rem[sub], d_fit), cap)
        if zl:
            for z in range(n_zones):
                zidx = np.flatnonzero((slot_zone == z) & (fit > 0))
                if zidx.size:
                    allowed = int(q[z])
                    c = np.cumsum(fit[zidx])
                    over = c > allowed
                    if over.any():
                        first = int(np.argmax(over))
                        before = int(c[first] - fit[zidx[first]])
                        fit[zidx[first]] = max(allowed - before, 0)
                        fit[zidx[first + 1:]] = 0
        if colocate[g]:
            fit = np.where(fit >= cnt, cnt, 0)
        place = _greedy_fill(fit, cnt)
        placed = int(place.sum())
        if placed:
            slot_rem -= place[:, None] * d[None, :]
            ys[t] += place
        left = cnt - placed

        # ---- open new nodes ----
        if left > 0 and hn == 0:
            if zl:
                placed_z = np.bincount(
                    slot_zone, weights=place.astype(np.float64), minlength=n_zones
                )[:n_zones].astype(np.int64)
                wants = [(z, int(min(max(q[z] - placed_z[z], 0), left))) for z in range(n_zones)]
                # consume left across zones in order
                acc = 0
                adj = []
                for z, w in wants:
                    w = min(w, left - acc)
                    adj.append((z, max(w, 0)))
                    acc += max(w, 0)
                wants = adj
            else:
                wants = [(None, left)]
            pe = price_t[t]
            for z, want in wants:
                if want <= 0:
                    continue
                u = units[g]
                okb = (u > 0) & opt_valid
                if z is not None:
                    okb &= opt_zone == z
                if not okb.any():
                    continue
                uu = np.where(okb, u, 0)
                with np.errstate(divide="ignore", invalid="ignore"):
                    lump = np.where(okb, np.ceil(want / np.maximum(uu, 1)) * pe, np.inf)
                jl = _pick(lump, uu, alpha)
                best = (lump[jl], [(jl, want)])
                rate_ok = okb & (uu <= want)
                if rate_ok.any():
                    rate = np.where(rate_ok, pe / np.maximum(uu, 1), np.inf)
                    jr = _pick(rate, uu, alpha)
                    n_full = want // int(uu[jr])
                    rem_w = want - n_full * int(uu[jr])
                    mixed_cost = n_full * pe[jr]
                    pieces = [(jr, n_full * int(uu[jr]))]
                    if rem_w > 0:
                        tail = np.where(okb, np.ceil(rem_w / np.maximum(uu, 1)) * pe, np.inf)
                        jt = _pick(tail, uu, alpha)
                        mixed_cost += tail[jt]
                        pieces.append((jt, rem_w))
                    if mixed_cost < best[0]:
                        best = (mixed_cost, pieces)
                if not np.isfinite(best[0]):
                    continue
                for j, amount in best[1]:
                    uj = int(uu[j])
                    while amount > 0:
                        if cursor >= NS:
                            return None  # slot budget exhausted
                        take = min(uj, amount)
                        slot_rem[cursor] = alloc[j] - take * d
                        slot_opt[cursor] = j
                        slot_zone[cursor] = opt_zone[j]
                        slot_active[cursor] = True
                        ys[t, cursor] += take
                        cursor += 1
                        amount -= take
                        left -= take
        unplaced += max(left, 0)

        # ---- publish relation bits ----
        sm = int(rel_set[g])
        if sm:
            touched = ys[t] > 0
            slot_bits[touched] |= sm
            zs = np.unique(slot_zone[touched])
            zone_bits[zs] |= sm

    new_opt = slot_opt[E:].astype(np.int32)
    new_active = (slot_active[E:] & (new_opt >= 0)).astype(bool)
    return new_opt, new_active, ys, unplaced
