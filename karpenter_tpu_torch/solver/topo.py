"""Topology-aware plan improvement: zone-decomposed pattern CG for spread shapes.

The FFD portfolio (kernel + ``host_pack``) lands ~2% above the zone-split LP
bound on spread-heavy mixes — first-fit cannot see that a 2.0-cpu pod pair
strands 0.42 cpu on a 3.92-cpu node thousands of times. The LP-safe path
fixes that with pattern column generation (``patterns.py``), but topology
constraints (zone spread, hostname anti-affinity caps) are outside the plain
master LP.

This module brings patterns to those shapes by DECOMPOSING on the structure
the constraints already impose:

  * zone spread fixes per-(group, zone) demand: the kernel's own water-filled
    quotas (``solver._zone_quotas``) ARE the split, so each zone becomes an
    independent subproblem over that zone's launch options;
  * per-node caps (hostname anti-affinity / spread ``maxSkew``) are natural
    PATTERN constraints: a pattern is feasible iff k[g] <= node_cap[g] — the
    formulation that is awkward for an assignment LP is trivial here;
  * per-zone: CG with cap-respecting pricing, FLOOR the master (vertex
    solutions keep the bulk; giant-node columns round coarsely, which is why
    flooring only the bulk is safe and the rest is NOT rounded), and hand the
    combined residual to the existing ``host_pack`` FFD portfolio with counts
    and quotas patched down — FFD is excellent on the small remainder;
  * finish with a capped, zone-preserving ruin-recreate: kill low value
    density nodes, refill their pods into surviving same-zone slack, open
    right-sized replacement nodes; every round is accepted only if counts
    stay exact and cost strictly drops.

The result replaces the incumbent only when the full name-level validator
passes — topology constraints are subtle, and a cheaper-but-invalid plan must
never escape. Unsupported shapes (existing capacity, colocation, cross-group
relation bits) return None and the incumbent stands.

Like ``patterns.py``, the work is gated to REPEAT solves of a problem and the
finished plan is cached per problem object, so steady-state reconciles return
the improved answer in ~ms while one-shot solves pay nothing.
"""

from __future__ import annotations

import time
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils import metrics
from .encode import EncodedProblem
from .host import Opened, _units_rate, plan_cost

try:  # pragma: no cover - scipy is baked into the image
    from scipy.optimize import linprog

    _HAVE_SCIPY = True
except Exception:  # pragma: no cover
    _HAVE_SCIPY = False

_IBIG = np.int64(1 << 30)

# id(problem) -> (problem, entry); bounded FIFO like patterns._pool_cache so
# alternating stable problems keep their plans. entry is a _Finished (built
# plan), None (deterministic failure — incumbent stands permanently), or
# ("transient", attempts) — a failure that may succeed on retry (residual
# pack under load, deadline cut); bounded retries, then permanent.
_STATE_CACHE_MAX = 4
_TRANSIENT_RETRIES = 2
_state_cache: Dict[int, tuple] = {}
_seen: "weakref.WeakValueDictionary[int, EncodedProblem]" = weakref.WeakValueDictionary()


class _Finished:
    """A built-and-validated topology plan cached per problem: the decoded
    result for replay, plus the raw (opt_arr, ys_arr) plan arrays so the plan
    can transfer to content-similar problems (group-signature remap)."""

    __slots__ = ("result", "cost", "opt_arr", "ys_arr", "savings_counted", "won")

    def __init__(self, result, cost, opt_arr, ys_arr):
        self.result = result
        self.cost = cost
        self.opt_arr = opt_arr
        self.ys_arr = ys_arr
        # PATTERN_SAVINGS counts each problem's delta ONCE: a steady-state
        # reconcile loop replaying the cached plan must not re-count the same
        # dollars every cycle
        self.savings_counted = False
        # True once this plan beat a REAL FFD incumbent on this problem. The
        # pre-FFD probe (infinite incumbent) may only short-circuit the FFD
        # with won plans — a built-or-transferred plan can come out WORSE
        # than FFD, and delivering it unconditionally would regress repeat
        # solves (caught by the pattern fuzz test).
        self.won = False


def _deliver(finished: "_Finished", incumbent_cost: float):
    """Return a fresh stats shell of the cached result when it beats the
    incumbent, and mark a plan that beat a real incumbent as won; metric
    bookkeeping (improvements per delivery, savings once)."""
    import dataclasses

    if finished.cost >= incumbent_cost - 1e-9:
        return None
    # delivery rate counts EVERY solve served by the closer, probe included;
    # the dollar delta needs a real incumbent and counts once per problem
    metrics.PATTERN_IMPROVEMENTS.inc()
    if incumbent_cost != float("inf"):
        finished.won = True  # beat a real incumbent; probes may now trust it
        if not finished.savings_counted:
            finished.savings_counted = True
            metrics.PATTERN_SAVINGS.inc(value=incumbent_cost - finished.cost)
    return dataclasses.replace(finished.result, stats=dict(finished.result.stats))


def _supported(problem: EncodedProblem) -> bool:
    if problem.O == 0:
        return False
    if np.any(problem.colocate):
        return False
    if problem.E and np.any(problem.zone_cap.astype(np.int64) < _IBIG):
        # zone anti-affinity occupancy against a fixed existing assignment
        # would need a recompute this path doesn't do
        return False
    # Hostname-level cross-group COLOCATION (consumer requires provider on its
    # node) is pattern-expressible: a pattern hosting a consumer must also
    # contain a covering provider. Everything else relational — host forbids,
    # zone-level needs/forbids, seeded bits from bound pods — stays with the
    # FFD/kernel paths.
    rel_unsupported = any(
        a is not None and np.any(a)
        for a in (
            problem.rel_host_forbid, problem.rel_zone_forbid,
            problem.rel_zone_need, problem.rel_slot_bits, problem.rel_zone_bits,
        )
    )
    if rel_unsupported:
        return False
    hn = problem.rel_host_need
    rs = problem.rel_set
    if hn is not None and np.any(hn):
        if rs is None:
            return False
        # every needed bit must be coverable by some provider group
        all_set = int(np.bitwise_or.reduce(rs.astype(np.int64)))
        if int(np.bitwise_or.reduce(hn.astype(np.int64))) & ~all_set:
            return False
    return True


def _coverage_maps(problem: EncodedProblem):
    """(hn[G], set_[G]) as int64 arrays (all zeros when no relations)."""
    G = problem.G
    hn = (
        problem.rel_host_need.astype(np.int64)
        if problem.rel_host_need is not None
        else np.zeros(G, np.int64)
    )
    rs = (
        problem.rel_set.astype(np.int64)
        if problem.rel_set is not None
        else np.zeros(G, np.int64)
    )
    return hn, rs


def _apportion(share: np.ndarray, total: int) -> np.ndarray:
    """Largest-remainder apportionment of ``total`` along ``share`` (sums to
    exactly ``total``)."""
    out = np.floor(share * total).astype(np.int64)
    residue = int(total - out.sum())
    for z in np.argsort(-(share * total - out), kind="stable")[:residue]:
        out[z] += 1
    return out


def _zone_split(problem: EncodedProblem, quota: np.ndarray) -> Optional[np.ndarray]:
    """Per-(group, zone) demand [G, Z]. Spread groups take their water-filled
    quota verbatim (it sums exactly to count); free / zone-capped groups are
    split along the relaxed assignment LP's flows, capped by quota."""
    from .host import lp_solve

    G = problem.G
    Z = quota.shape[1]
    count = problem.count.astype(np.int64)
    rem_gz = np.zeros((G, Z), np.int64)
    lp_free: List[int] = []
    for g in range(G):
        q = quota[g]
        if (q < _IBIG).all() and q.sum() == count[g]:
            rem_gz[g] = q
        else:
            lp_free.append(g)
    if lp_free:
        plan = lp_solve(problem, count.copy(), [], topk=8)
        if not hasattr(plan, "cols"):
            return None
        zone_of_col = problem.opt_zone[plan.cols]
        for g in lp_free:
            mask = plan.active[plan.gi] == g
            flows = np.zeros(Z)
            np.add.at(flows, zone_of_col[plan.oi[mask]], plan.x[mask])
            if flows.sum() <= 0:
                flows = np.ones(Z)
            share = flows / flows.sum()
            az = np.minimum(_apportion(share, int(count[g])), quota[g])
            over = int(count[g] - az.sum())
            zi = 0
            while over > 0 and zi < 4 * Z:
                z = zi % Z
                head = int(quota[g][z] - az[z])
                t = min(head, over)
                az[z] += t
                over -= t
                zi += 1
            if over > 0:
                return None  # quota-infeasible split; incumbent stands
            rem_gz[g] = az
    # Colocation coupling: a consumer pod needs a covering provider ON ITS
    # NODE, so zones with no provider pods cannot host the consumer. Move
    # stranded consumer demand into provider-present zones (proportionally).
    hn, rs = _coverage_maps(problem)
    for g in np.flatnonzero(hn):
        provs = np.flatnonzero((rs & int(hn[g])) != 0)
        prov_z = rem_gz[provs].sum(axis=0)
        bad = (prov_z == 0) & (rem_gz[g] > 0)
        if not bad.any():
            continue
        move = int(rem_gz[g][bad].sum())
        rem_gz[g][bad] = 0
        good = np.flatnonzero(prov_z > 0)
        if good.size == 0:
            return None
        share = prov_z[good] / prov_z[good].sum()
        add = _apportion(share, move)
        capped = np.minimum(add, np.maximum(quota[g][good] - rem_gz[g][good], 0))
        if capped.sum() < add.sum():
            return None  # quota blocks the coupled split
        rem_gz[g][good] += add
    return rem_gz


def _greedy_pattern(
    problem, o: int, weights: np.ndarray, caps: np.ndarray,
    cap_extra: Optional[np.ndarray] = None,
) -> np.ndarray:
    d = problem.demand.astype(np.float64)
    a = problem.alloc.astype(np.float64)[o].copy()
    G = problem.G
    k = np.zeros(G, np.int64)
    compat = problem.compat[:, o]
    caps = caps if cap_extra is None else np.minimum(caps, cap_extra)
    hn, rs = _coverage_maps(problem)
    covered = 0
    for _ in range(64):
        ok_rel = (hn & ~covered) == 0  # consumer addable only when covered
        fm = (
            np.all(d <= a[None, :] + 1e-12, axis=1)
            & compat & (weights > 0) & (k < caps) & ok_rel
        )
        if not fm.any():
            # try opening coverage: add ONE provider pod for the
            # best-weighted blocked consumer, then retry
            blocked = (
                np.all(d <= a[None, :] + 1e-12, axis=1)
                & compat & (weights > 0) & (k < caps) & ~ok_rel
            )
            if not blocked.any():
                break
            g_c = int(np.argmax(np.where(blocked, weights, -1)))
            need = int(hn[g_c]) & ~covered
            provs = np.flatnonzero((rs & need) != 0)
            added = False
            for g_p in provs[np.argsort(d[provs].sum(axis=1))]:
                if (
                    compat[g_p] and k[g_p] < caps[g_p]
                    and np.all(d[g_p] <= a + 1e-12)
                ):
                    k[g_p] += 1
                    a -= d[g_p]
                    covered |= int(rs[g_p])
                    added = True
                    break
            if not added:
                break
            continue
        g = int(np.argmax(np.where(fm, weights, -1)))
        with np.errstate(divide="ignore", invalid="ignore"):
            m = np.min(np.where(d[g] > 0, a / np.maximum(d[g], 1e-30), np.inf))
        m = max(1, int(min(np.floor(m + 1e-9), caps[g] - k[g])) // 2)
        k[g] += m
        a -= d[g] * m
        covered |= int(rs[g])
    return k


def _price_patterns_capped(
    problem, cols: np.ndarray, duals: np.ndarray, caps: np.ndarray,
    cap_extra: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Vectorized dual-guided knapsack with per-group caps (patterns.py's
    pricing plus the node_cap constraint). ``cap_extra`` further limits per
    pattern (e.g. to remaining demand for repair nodes)."""
    d = problem.demand.astype(np.float64)
    a = problem.alloc.astype(np.float64)[cols].copy()
    compat = problem.compat[:, cols].T
    O, G = compat.shape
    lim = caps if cap_extra is None else np.minimum(caps, cap_extra)
    k = np.zeros((O, G), np.int64)
    pos = duals > 0
    live = np.ones(O, bool)
    hn, rs = _coverage_maps(problem)
    has_rel = bool(np.any(hn))
    covered = np.zeros(O, np.int64)  # per-pattern union of set bits
    for _ in range(48):
        fits = np.all(d[None, :, :] <= a[:, None, :] + 1e-12, axis=2)
        fits &= compat & pos[None, :] & (k < lim[None, :])
        if has_rel:
            # a consumer may only join a pattern whose providers cover it; a
            # blocked consumer's value is instead ATTRIBUTED to adding its
            # cheapest covering provider (amortized over the consumer dual)
            uncovered = (hn[None, :] & ~covered[:, None]) != 0
            blocked = fits & uncovered
            fits &= ~uncovered
            if blocked.any():
                for oi, g_c in zip(*np.nonzero(blocked)):
                    need = int(hn[g_c]) & ~int(covered[oi])
                    provs = np.flatnonzero((rs & need) != 0)
                    for g_p in provs:
                        if (
                            compat[oi, g_p]
                            and k[oi, g_p] < lim[g_p]
                            and np.all(d[g_p] <= a[oi] + 1e-12)
                        ):
                            k[oi, g_p] += 1
                            a[oi] -= d[g_p]
                            covered[oi] |= int(rs[g_p])
                            break
                # recompute fits with the new coverage
                fits = np.all(d[None, :, :] <= a[:, None, :] + 1e-12, axis=2)
                fits &= compat & pos[None, :] & (k < lim[None, :])
                fits &= (hn[None, :] & ~covered[:, None]) == 0
        live &= fits.any(axis=1)
        if not live.any():
            break
        scale = np.maximum(a, 1e-9)
        lf = np.max(d[None, :, :] / scale[:, None, :], axis=2)
        w = np.where(fits, duals[None, :] / np.maximum(lf, 1e-9), -1.0)
        gs = np.argmax(w, axis=1)
        ok = live & (np.take_along_axis(w, gs[:, None], 1)[:, 0] > 0)
        if not ok.any():
            break
        dsel = d[gs]
        with np.errstate(divide="ignore", invalid="ignore"):
            m = np.min(np.where(dsel > 0, a / np.maximum(dsel, 1e-30), np.inf), axis=1)
        m = np.where(np.isfinite(m), np.floor(m + 1e-9), 0)
        room = lim[gs] - k[np.arange(O), gs]
        m = (np.minimum(np.maximum(1, m // 4), room) * ok).astype(np.int64)
        np.add.at(k, (np.arange(O), gs), m)
        a -= dsel * m[:, None]
        covered |= np.where(m > 0, rs[gs], 0)
        live &= m > 0
    return k


def _zone_bulk(
    problem, z: int, rem_z: np.ndarray, caps: np.ndarray, deadline: Optional[float]
) -> Tuple[List[Opened], np.ndarray]:
    """CG on zone z's demand; FLOOR the converged master (the integral bulk at
    LP rate); overserve trimmed to exactness. The fractional remainder is NOT
    rounded here — the caller's FFD pass owns it."""
    G = problem.G
    d = problem.demand.astype(np.float64)
    price = problem.price.astype(np.float64)
    units, rate = _units_rate(problem)
    cols_z = np.flatnonzero(problem.opt_zone == z)
    cand = set()
    for g in np.flatnonzero(rem_z > 0):
        rz = rate[g, cols_z]
        finite = np.isfinite(rz)
        kt = min(10, int(finite.sum()))
        if kt:
            idx = np.argpartition(rz, kt - 1)[:kt]
            cand.update(int(cols_z[j]) for j in idx if np.isfinite(rz[j]))
    if not cand:
        return [], np.zeros(G, np.int64)
    cols = np.array(sorted(cand), np.int64)

    pats: List[Tuple[int, np.ndarray]] = []
    seen: set = set()

    def add(o, k):
        key = (int(o), k.tobytes())
        if key not in seen and k.sum() > 0:
            seen.add(key)
            pats.append((int(o), k.astype(np.int64)))
            return 1
        return 0

    for o in cols:
        for w in (d[:, 0], d[:, 1], rem_z.astype(float)):
            add(o, _greedy_pattern(problem, o, np.where(rem_z > 0, w, 0), caps,
                                   cap_extra=rem_z))
    hn_seed, _rs_seed = _coverage_maps(problem)
    for g in np.flatnonzero(rem_z > 0):
        if hn_seed[g]:
            continue  # a consumer-only pattern violates colocation by design
        for o in cols:
            if problem.compat[g, o]:
                u = int(min(units[g, o], caps[g], rem_z[g]))
                if u >= 1:
                    k = np.zeros(G, np.int64)
                    k[g] = u
                    add(o, k)
    act = np.flatnonzero(rem_z > 0)

    def master():
        A = np.stack([k for _, k in pats], axis=1).astype(np.float64)
        c = np.array([price[o] for o, _ in pats])
        return linprog(
            c, A_ub=-A[act], b_ub=-rem_z[act].astype(np.float64),
            bounds=[(0.0, None)] * len(pats), method="highs-ds",
        )

    res = master()
    if res.status != 0:
        return [], np.zeros(G, np.int64)
    for _ in range(10):
        if deadline is not None and time.perf_counter() > deadline:
            break
        duals = np.zeros(G)
        duals[act] = -np.asarray(res.ineqlin.marginals)
        # patterns never hold more than the remaining demand: a giant node
        # carrying a fraction of a small remainder prices at a terrible
        # rate, so the master picks right-sized columns whose counts floor
        # cleanly instead of x<1 giants that floor to nothing
        K = _price_patterns_capped(problem, cols, duals, caps, cap_extra=rem_z)
        vals = K @ duals
        fresh = 0
        for oi in np.flatnonzero(vals > price[cols] * (1 + 1e-6)):
            fresh += add(int(cols[oi]), K[oi])
        if fresh == 0:
            break
        res2 = master()
        if res2.status != 0:
            # res is now STALE relative to the grown pattern list (x shorter
            # than the column set) — flooring it would shape-mismatch
            return [], np.zeros(G, np.int64)
        res = res2

    x = np.asarray(res.x)
    n_int = np.floor(x + 1e-9).astype(np.int64)
    K_all = np.stack([k for _, k in pats], axis=1).astype(np.int64)
    served = K_all @ n_int
    over = np.maximum(served - rem_z, 0)
    per_opt: Dict[int, List[np.ndarray]] = {}
    for (o, k), n in zip(pats, n_int):
        if n > 0:
            per_opt.setdefault(o, []).append(np.repeat(k[:, None], n, axis=1))
    opens: List[Opened] = []
    served_exact = np.zeros(G, np.int64)
    hn, rs = _coverage_maps(problem)
    # trim consumers before providers, and never strip the LAST covering
    # provider pod from a node that still hosts dependent consumers
    trim_order = sorted(range(G), key=lambda g: (rs[g] != 0, g))
    for o, blocks in per_opt.items():
        ys = np.concatenate(blocks, axis=1)
        for g in trim_order:
            if over[g] == 0 or not ys[g].any():
                continue
            row = ys[g].copy()
            if rs[g]:
                # per-node floor: a dependent consumer present -> keep >= 1
                dependents = np.flatnonzero((hn & int(rs[g])) != 0)
                needed = (ys[dependents].sum(axis=0) > 0).astype(np.int64)
                avail = np.maximum(row - needed, 0)
            else:
                avail = row
            cum = np.cumsum(avail)
            drop = np.minimum(avail, np.maximum(0, over[g] - (cum - avail)))
            ys[g] = row - drop
            over[g] -= int(drop.sum())
        if over.any():
            # pod-level trim blocked (e.g. the last covering provider under
            # dependent consumers): peel WHOLE nodes hosting overserved
            # groups — conservative, the freed pods rejoin the remainder
            for g in np.flatnonzero(over):
                while over[g] > 0 and ys[g].any():
                    j = int(np.argmax(ys[g] > 0))
                    over_g = ys[:, j].copy()
                    ys[:, j] = 0
                    over = np.maximum(over - over_g, 0)
        keep = ys.sum(axis=0) > 0
        ys = ys[:, keep]
        if ys.shape[1]:
            opens.append(Opened(option=o, nodes=ys.shape[1], ys=ys))
            served_exact += ys.sum(axis=1)
    return opens, served_exact


def _residual_greedy(
    problem, res_count: np.ndarray, res_quota: np.ndarray, caps: np.ndarray
):
    """Coverage-aware single-node best-fill for residuals the FFD strands —
    typically consumer-heavy dregs whose providers the FFD packed too densely
    to leave rider room. Quota-bounded groups are placed zone by zone; free
    groups (colocation pairs included) pick the best option across all zones.
    Returns [(option, contents[G])] or None when anything remains."""
    G = problem.G
    price = problem.price.astype(np.float64)
    d = problem.demand.astype(np.float64)
    value = d[:, 0] + d[:, 1] / 2**30
    n_zones = int(problem.opt_zone.max()) + 1 if problem.O else 1
    remaining = res_count.astype(np.int64).copy()
    quota_fin = res_quota < _IBIG
    nodes: List[Tuple[int, np.ndarray]] = []

    def fill(cols: np.ndarray, lim: np.ndarray) -> np.ndarray:
        placed = np.zeros(G, np.int64)
        guard = 0
        while lim.sum() > 0 and guard < 512:
            guard += 1
            wl = np.where(lim > 0, value, 0.0)
            K = _price_patterns_capped(problem, cols, wl, caps, cap_extra=lim)
            K_lim = np.minimum(K, lim[None, :])
            util = (K_lim @ value) / np.maximum(price[cols], 1e-9)
            oi = int(np.argmax(util))
            if util[oi] <= 0:
                break
            kk = K_lim[oi]
            nodes.append((int(cols[oi]), kk.copy()))
            placed += kk
            lim -= kk
        return placed

    for z in range(n_zones):
        zone_lim = np.where(
            quota_fin[:, z], np.minimum(res_quota[:, z], remaining), 0
        ).astype(np.int64)
        if zone_lim.sum() == 0:
            continue
        cols_z = np.flatnonzero(problem.opt_zone == z)
        remaining -= fill(cols_z, zone_lim)
    free_lim = np.where(quota_fin.any(axis=1), 0, remaining).astype(np.int64)
    if free_lim.sum():
        remaining -= fill(np.arange(problem.O), free_lim)
    if remaining.sum() > 0:
        return None
    return nodes


def _residual_ffd(solver, problem, res_count: np.ndarray, res_quota: np.ndarray):
    """Pack the residual demand with the host FFD portfolio on count/quota
    patched inputs. Returns a list of (option, contents[G]) single nodes, or
    None when no member places everything."""
    from .host_pack import host_pack, host_shared

    G = problem.G
    from .torch_solver import PackInputs

    fields, orders, alphas, looks, rsvs, swaps, s_new, n_zones = solver._prepare(problem)
    inputs = PackInputs(**fields)  # numpy leaves, as host_pack reads them
    cnt2 = np.asarray(inputs.count).copy()
    cnt2[:G] = res_count.astype(cnt2.dtype)
    # n_zones is the PADDED zone axis (bucket lattice); the residual quota
    # covers only the real zones — padded columns keep their prepared IBIG
    nz = min(max(len(problem.zones), 1), res_quota.shape[1])
    q2 = np.asarray(inputs.quota).copy()
    q2[:G, :nz] = np.clip(
        res_quota[:, :nz], 0, np.iinfo(q2.dtype).max
    ).astype(q2.dtype)
    # existing slots are OFF: with E > 0 the incumbent's existing placements
    # are pinned by the caller — the residual may only open new nodes
    ex_off = np.zeros_like(np.asarray(inputs.ex_valid))
    inputs2 = inputs._replace(count=cnt2, quota=q2, ex_valid=ex_off)
    shared = host_shared(inputs2)
    price = problem.price.astype(np.float64)
    orders_np = np.asarray(orders)
    alphas_np = np.asarray(alphas)
    looks_np = np.asarray(looks)
    best = None
    for mi in range(orders_np.shape[0]):
        out = host_pack(
            inputs2, shared, orders_np[mi], s_new, n_zones,
            alpha=float(alphas_np[mi]), look=bool(looks_np[mi]),
        )
        if out is None:
            continue
        new_opt, new_active, ys, unplaced = out
        if unplaced > 0:
            continue
        act = np.flatnonzero(new_active)
        cost_m = float(price[new_opt[act]].sum())
        if best is None or cost_m < best[0]:
            best = (cost_m, new_opt, new_active, ys, orders_np[mi])
    if best is None:
        return None
    _, new_opt, new_active, ys_slots, order_used = best
    # ys columns cover [Ep existing (padded) slots] + [s_new new slots], while
    # new_opt/new_active index the NEW slots only — offset by the PADDED
    # existing count, not problem.E
    ep = ys_slots.shape[1] - new_opt.shape[0]
    nodes = []
    for j in np.flatnonzero(new_active):
        k = np.zeros(G, np.int64)
        for t in range(order_used.shape[0]):
            g = int(order_used[t])
            if g < G and ys_slots[t, ep + j]:
                k[g] += int(ys_slots[t, ep + j])
        if k.sum():
            nodes.append((int(new_opt[j]), k))
    return nodes


def _capped_rr(
    problem, opt_arr: np.ndarray, ys_arr: np.ndarray, caps: np.ndarray,
    deadline: Optional[float], rounds: int = 8, frac: float = 0.10,
):
    """Zone-preserving, cap-respecting ruin-recreate on flattened node arrays.
    Freed pods re-enter THEIR zone (quota totals unchanged); refills respect
    per-node caps; a round is accepted only when every freed pod is placed
    (counts exact) AND cost strictly drops."""
    d = problem.demand.astype(np.float64)
    alloc = problem.alloc.astype(np.float64)
    price = problem.price.astype(np.float64)
    units, rate = _units_rate(problem)
    lam = rate.min(axis=1)
    lam = np.where(np.isfinite(lam), lam, 0.0)
    G = problem.G
    Z = int(problem.opt_zone.max()) + 1 if problem.O else 1
    hn, rs = _coverage_maps(problem)  # loop-invariant

    for _ in range(rounds):
        if deadline is not None and time.perf_counter() > deadline:
            break
        N = opt_arr.shape[0]
        if N <= 1:
            break
        dens = (lam @ ys_arr) / np.maximum(price[opt_arr], 1e-12)
        kkill = max(4, int(N * frac))
        kill_idx = np.argsort(dens, kind="stable")[:kkill]
        keep = np.ones(N, bool)
        keep[kill_idx] = False
        freed_z = np.zeros((G, Z), np.int64)
        for j in kill_idx:
            freed_z[:, problem.opt_zone[opt_arr[j]]] += ys_arr[:, j]
        trial_ys = ys_arr[:, keep].copy()
        trial_opt = opt_arr[keep]
        new_nodes: List[Tuple[int, np.ndarray]] = []
        placed_all = True
        slack = alloc[trial_opt] - (trial_ys.T.astype(np.float64) @ d)
        fill_order = np.argsort(-(d[:, 0] + d[:, 1] / 2**30), kind="stable")
        # per-kept-node coverage (union of set bits of hosted groups)
        node_cov = np.zeros(trial_opt.shape[0], np.int64)
        if np.any(rs):
            for g in np.flatnonzero(rs):
                node_cov |= np.where(trial_ys[g] > 0, int(rs[g]), 0)
        for z in range(Z):
            rem_v = freed_z[:, z].copy()
            if rem_v.sum() == 0:
                continue
            zmask = problem.opt_zone[trial_opt] == z
            for j in np.flatnonzero(zmask):
                if rem_v.sum() == 0:
                    break
                a = slack[j]
                for g in fill_order:
                    if rem_v[g] <= 0 or not problem.compat[g, trial_opt[j]]:
                        continue
                    if hn[g] and (int(hn[g]) & ~int(node_cov[j])):
                        continue  # consumer: node lacks a covering provider
                    while (
                        rem_v[g] > 0
                        and trial_ys[g, j] < caps[g]
                        and np.all(d[g] <= a + 1e-12)
                    ):
                        trial_ys[g, j] += 1
                        a -= d[g]
                        rem_v[g] -= 1
                        if rs[g]:
                            node_cov[j] |= int(rs[g])
            cols_z = np.flatnonzero(problem.opt_zone == z)
            guard = 0
            while rem_v.sum() > 0 and guard < 512:
                guard += 1
                wl = np.where(rem_v > 0, lam, 0.0)
                K = _price_patterns_capped(
                    problem, cols_z, wl, caps, cap_extra=np.maximum(rem_v, 0)
                )
                K_lim = np.minimum(K, rem_v[None, :])
                util = (K_lim @ lam) / np.maximum(price[cols_z], 1e-9)
                oi = int(np.argmax(util))
                if util[oi] <= 0:
                    break
                new_nodes.append((int(cols_z[oi]), K_lim[oi].copy()))
                rem_v -= K_lim[oi]
            if rem_v.sum() > 0:
                placed_all = False
                break
        if not placed_all:
            break
        new_cost = float(price[trial_opt].sum()) + sum(price[o] for o, _ in new_nodes)
        if new_cost >= float(price[opt_arr].sum()) - 1e-9:
            break
        if new_nodes:
            opt_arr = np.concatenate(
                [trial_opt, np.asarray([o for o, _ in new_nodes], np.int64)]
            )
            ys_arr = np.concatenate(
                [trial_ys, np.stack([k for _, k in new_nodes], axis=1)], axis=1
            )
        else:
            opt_arr, ys_arr = trial_opt, trial_ys
    return opt_arr, ys_arr


def _topo_sigs(problem: EncodedProblem) -> List[tuple]:
    """Per-group content signature for plan transfer: demand, compat, AND
    every topology-relevant per-group field — matched groups must behave
    identically under spread/anti-affinity/colocation, not just pack the
    same. Family structure is checked separately (indices don't survive a
    byte signature)."""
    sigs = problem.__dict__.get("_topo_sigs")
    if sigs is None:
        d = np.ascontiguousarray(problem.demand)
        c = np.ascontiguousarray(problem.compat)
        zs = problem.zone_seed
        rel = [
            (
                getattr(problem, fld).astype(np.int64)
                if getattr(problem, fld) is not None
                else np.zeros(problem.G, np.int64)
            )
            for fld in (
                "rel_set", "rel_host_forbid", "rel_host_need",
                "rel_zone_forbid", "rel_zone_need",
            )
        ]
        sigs = [
            (
                d[g].tobytes(), c[g].tobytes(),
                int(problem.node_cap[g]), int(problem.zone_cap[g]),
                int(problem.zone_skew[g]), bool(problem.colocate[g]),
                zs[g].tobytes() if zs is not None else b"",
                tuple(int(r[g]) for r in rel),
            )
            for g in range(problem.G)
        ]
        problem.__dict__["_topo_sigs"] = sigs
    return sigs


def _group_is_plain(problem: EncodedProblem, g: int) -> bool:
    """True when group g carries no topology/relational constraints — the
    only groups the transfer path may pack as quota-free extras."""
    if (
        problem.zone_skew[g] > 0
        or problem.zone_cap[g] < _IBIG
        or problem.node_cap[g] < _IBIG
        or problem.colocate[g]
    ):
        return False
    for fld in (
        "rel_set", "rel_host_forbid", "rel_host_need",
        "rel_zone_forbid", "rel_zone_need",
    ):
        v = getattr(problem, fld)
        if v is not None and v[g]:
            return False
    fams = problem.zone_spread_members
    return not (fams and fams[g])


def _similar_transfer(
    problem: EncodedProblem,
    solver,
    incumbent_cost: float,
    deadline: Optional[float],
) -> Optional[_Finished]:
    """Transfer a content-similar problem's finished topology plan to this
    one (one-shot topology efficiency): remap the
    plan's group rows by signature, trim shrunken groups, FFD-pack grown/new
    plain groups into the leftover quota, then run the FULL validation gate.
    A plan that doesn't survive validation is simply not used — the transfer
    can never make a result worse, only cheaper."""
    if problem.E:
        return None
    from .patterns import _options_digest

    my_dig = None
    my_sigs = None
    count = problem.count.astype(np.int64)
    if count.sum() <= 0:
        return None
    for _k, (old, entry) in list(_state_cache.items()):
        if deadline is not None and time.perf_counter() >= deadline:
            return None  # transfer is budget-bounded work, not a spike
        if old is problem or not isinstance(entry, _Finished):
            continue
        if old.E or old.zones != problem.zones:
            continue
        if my_dig is None:
            my_dig = _options_digest(problem)
        if _options_digest(old) != my_dig:
            continue
        if my_sigs is None:
            my_sigs = _topo_sigs(problem)
        old_index: Dict[tuple, List[int]] = {}
        for i, s in enumerate(_topo_sigs(old)):
            old_index.setdefault(s, []).append(i)
        mapping = np.full(problem.G, -1, np.int64)
        for g, s in enumerate(my_sigs):
            cands = old_index.get(s)
            if cands:
                mapping[g] = cands.pop()
        matched = mapping >= 0
        if count[matched].sum() / count.sum() < 0.85:
            continue
        # family consistency: a matched spread family must map member-for-
        # member onto the donor's family, and every unmatched group must be
        # constraint-free (they get packed as plain extras)
        fams = problem.zone_spread_members or [[] for _ in range(problem.G)]
        old_fams = old.zone_spread_members or [[] for _ in range(old.G)]
        ok = True
        for g in np.flatnonzero(matched):
            if problem.zone_skew[g] > 0 or fams[g]:
                mem_new = sorted(set([g] + list(fams[g])))
                if any(mapping[m] < 0 for m in mem_new):
                    ok = False
                    break
                og = int(mapping[g])
                if sorted(int(mapping[m]) for m in mem_new) != sorted(
                    set([og] + list(old_fams[og]))
                ):
                    ok = False
                    break
        if ok:
            for g in np.flatnonzero(~matched):
                if not _group_is_plain(problem, g):
                    ok = False
                    break
        if not ok:
            continue
        ys_old = entry.ys_arr
        opt_arr = entry.opt_arr.copy()
        ys = np.zeros((problem.G, ys_old.shape[1]), np.int64)
        ys[matched] = ys_old[mapping[matched]]
        # trim groups whose count shrank, front-to-back
        sums = ys.sum(axis=1)
        for g in np.flatnonzero(sums > count):
            over = int(sums[g] - count[g])
            row = ys[g]
            cum = np.cumsum(row)
            drop = np.minimum(row, np.maximum(0, over - (cum - row)))
            ys[g] = row - drop
        extras = count - ys.sum(axis=1)
        caps = np.minimum(problem.node_cap.astype(np.int64), _IBIG)
        if extras.sum() > 0:
            from .solver import _zone_quotas

            n_zones = len(problem.zones)
            quota = _zone_quotas(problem, n_zones).astype(np.int64)
            used_gz = np.zeros((problem.G, n_zones), np.int64)
            zs_of = problem.opt_zone[opt_arr]
            for z in range(n_zones):
                colmask = zs_of == z
                if colmask.any():
                    used_gz[:, z] = ys[:, colmask].sum(axis=1)
            res_quota = np.where(
                quota < _IBIG, np.maximum(quota - used_gz, 0), quota
            )
            # a handful of extra pods doesn't justify a full FFD portfolio
            # run — the single-node best-fill handles dregs directly. The
            # FFD only runs while budget remains (probe contract: bounded).
            packed = None
            if extras.sum() > 64 and (
                deadline is None or time.perf_counter() < deadline
            ):
                packed = _residual_ffd(solver, problem, extras.copy(), res_quota)
            if packed is None:
                packed = _residual_greedy(problem, extras.copy(), res_quota, caps)
            if packed is None:
                continue
            for o, k in packed:
                opt_arr = np.append(opt_arr, o)
                ys = np.concatenate([ys, k[:, None].astype(np.int64)], axis=1)
        assigned = np.zeros((problem.G, problem.E), np.int64)
        finished = _finalize_plan(
            problem, opt_arr, ys, assigned, count, caps, deadline, rr=False,
        )
        if finished is not None:
            return finished
    return None


def topo_improve(
    problem: EncodedProblem,
    solver,
    incumbent_cost: float,
    deadline: Optional[float] = None,
    min_pods: int = 2000,
    incumbent=None,
    probe_only: bool = False,
):
    """Build a zone-decomposed pattern plan for a topology-constrained problem
    and return a validated SolveResult when it strictly beats
    ``incumbent_cost``; None otherwise.

    With existing capacity (E > 0) the ``incumbent`` result's existing-node
    assignments are kept FIXED — they already passed validation — and only
    the new-node remainder is pattern-rebuilt, with zone quotas re-watered
    over seeds augmented by those assignments.

    Engages from the SECOND solve of the same problem (one-shot solves pay
    ~nothing); the finished plan — or the fact that the build could not beat
    FFD — is cached per problem, so the bounded build spike happens at most
    once and steady-state re-solves are a dict hit."""
    if not _HAVE_SCIPY or not _supported(problem):
        return None
    if problem.count.sum() < min_pods:
        return None
    if problem.E and incumbent is None:
        return None
    key = id(problem)
    transient_attempts = 0
    cached = _state_cache.get(key)
    if cached is not None and cached[0] is problem:
        entry = cached[1]
        if entry is None:
            return None  # deterministic failure; incumbent stands permanently
        if isinstance(entry, _Finished):
            if probe_only and not entry.won:
                return None  # never beat a real FFD incumbent: probe can't trust it
            # fresh shell per return: callers stamp stats (total_solve_s) on
            # what we hand them, never on the cached object
            return _deliver(entry, incumbent_cost)
        # ("transient", n): retry the build a bounded number of times — a
        # residual pack that failed under load may succeed now (transient
        # failures must not disable the path for the process lifetime)
        transient_attempts = entry[1]
        if transient_attempts >= _TRANSIENT_RETRIES:
            return None
    elif _seen.get(key) is not problem:
        # first sight: free, unless a content-similar problem's finished plan
        # transfers — then the one-shot solve gets the improved plan too
        # (one-shot efficiency). A probe_only call
        # (the pre-FFD fast check) must not register the sighting: the
        # engage-from-second-solve contract counts REAL solve attempts, or
        # every first solve would pay the build spike.
        transferred = _similar_transfer(problem, solver, incumbent_cost, deadline)
        if transferred is not None:
            from .patterns import _cache_put

            _cache_put(_state_cache, key, (problem, transferred), _STATE_CACHE_MAX)
            if probe_only:
                # bank it, but let the FFD run once: the transferred plan is
                # delivered by the regular call below only if it actually
                # beats this problem's own FFD (then `won` lets future
                # probes short-circuit)
                return None
            return _deliver(transferred, incumbent_cost)
        if not probe_only:
            _seen[key] = problem
        return None
    if probe_only:
        # no finished plan to hand out: the real path (FFD + build) owns the
        # rest of this solve — a probe never pays the build spike
        return None
    # one-time build, bounded like the pattern-CG warmup spike: steady-state
    # latency is the contract, a single bounded spike buys the optimal plan.
    # The budget must cover a COMPLETE build (zone CG levels + residual FFD +
    # capped ruin-recreate, measured <=1.3s at 10k): a starved build caches a
    # worse-than-incumbent plan permanently. The spike is capped by the
    # solver's warmup_spike_s (0 disables it — an operator with a strict
    # latency SLO then simply keeps the FFD answer).
    spike = min(1.5, float(getattr(solver, "warmup_spike_s", 1.5)))
    if deadline is not None and spike > 0:
        deadline = max(deadline, time.perf_counter() + spike)

    from .solver import _zone_quotas  # local import: solver imports this module's caller

    G = problem.G
    count = problem.count.astype(np.int64)
    caps = np.minimum(problem.node_cap.astype(np.int64), _IBIG)
    n_zones = len(problem.zones)

    def finish(entry, transient: bool = False):
        from .patterns import _cache_put

        if entry is None and transient:
            # bounded retry budget instead of a permanent None: the failure
            # may not reproduce (load, deadline cut)
            _cache_put(
                _state_cache, key,
                (problem, ("transient", transient_attempts + 1)),
                _STATE_CACHE_MAX,
            )
            return None
        _cache_put(_state_cache, key, (problem, entry), _STATE_CACHE_MAX)
        if entry is None:
            return None
        return _deliver(entry, incumbent_cost)

    assigned = np.zeros((G, problem.E), np.int64)
    split_problem = problem
    if problem.E:
        # pin the incumbent's existing-node placements; rebuild only the rest
        name_to_g = {
            p.name: gi for gi, grp in enumerate(problem.groups) for p in grp.pods
        }
        e_index = {e.name: ei for ei, e in enumerate(problem.existing)}
        assigned_gz = np.zeros((G, n_zones), np.int64)
        for node_name, pod_names in (incumbent.existing_assignments or {}).items():
            ei = e_index.get(node_name)
            if ei is None:
                return finish(None)
            z = int(problem.ex_zone[ei])  # the encoder's own zone mapping
            for pn in pod_names:
                gi = name_to_g.get(pn)
                if gi is None:
                    return finish(None)
                assigned[gi, ei] += 1
                assigned_gz[gi, z] += 1
        count = count - assigned.sum(axis=1)
        if (count < 0).any():
            return finish(None)
        # re-water the spread quotas over seeds AUGMENTED by the pinned
        # assignments (family members count toward each other's selectors)
        seed_add = np.zeros((G, n_zones), np.int64)
        fams = problem.zone_spread_members or [[] for _ in range(G)]
        for g in range(G):
            if problem.zone_skew[g] > 0:
                members = sorted(set([g] + list(fams[g])))
                seed_add[g] = assigned_gz[members].sum(axis=0)
        base_seed = (
            problem.zone_seed[:, :n_zones].astype(np.int64)
            if problem.zone_seed is not None
            else np.zeros((G, n_zones), np.int64)
        )
        import dataclasses as _dc

        split_problem = _dc.replace(
            problem,
            count=count.astype(problem.count.dtype),
            zone_seed=(base_seed + seed_add).astype(np.int32),
        )
    quota = _zone_quotas(split_problem, n_zones).astype(np.int64)

    rem_gz = _zone_split(split_problem, quota)
    if rem_gz is None:
        return finish(None)

    bulk_opens: List[Opened] = []
    bulk_gz = np.zeros((G, n_zones), np.int64)
    for z in range(n_zones):
        rem_z = rem_gz[:, z].copy()
        # iterate the floor: each CG pass floors its master's integral bulk
        # and the next pass re-prices the shrunken remainder — colocation
        # pairs stay inside pattern nodes at every level, so the FFD only
        # ever sees dregs it can actually place
        for _level in range(3):
            if rem_z.sum() == 0:
                break
            opens_z, served_z = _zone_bulk(problem, z, rem_z.copy(), caps, deadline)
            if np.any(served_z > rem_z):
                return finish(None)
            if served_z.sum() == 0:
                break
            bulk_opens.extend(opens_z)
            bulk_gz[:, z] += served_z
            rem_z -= served_z

    res_count = count - bulk_gz.sum(axis=1)
    if (res_count < 0).any():
        return finish(None)
    # pair-consistency: residual consumers need residual providers (the FFD
    # packs the residual in isolation and cannot see bulk nodes). Return
    # whole provider-hosting bulk nodes to the residual until covered.
    hn, rs = _coverage_maps(problem)
    for g in np.flatnonzero(hn):
        provs = np.flatnonzero((rs & int(hn[g])) != 0)
        guard = 0
        while res_count[g] > 0 and res_count[provs].sum() == 0 and guard < 64:
            guard += 1
            moved = False
            for oi, op in enumerate(bulk_opens):
                ys = op.placements(G)
                cols_with = np.flatnonzero(ys[provs].sum(axis=0) > 0)
                if cols_with.size == 0:
                    continue
                j = int(cols_with[0])
                contents = ys[:, j].copy()
                z = int(problem.opt_zone[op.option])
                bulk_gz[:, z] -= contents
                res_count += contents
                ys2 = np.delete(ys, j, axis=1)
                if ys2.shape[1]:
                    bulk_opens[oi] = Opened(option=op.option, nodes=ys2.shape[1], ys=ys2)
                else:
                    bulk_opens.pop(oi)
                moved = True
                break
            if not moved:
                return finish(None)
    res_quota = np.where(
        quota[:, :n_zones] < _IBIG,
        np.maximum(quota[:, :n_zones] - bulk_gz, 0),
        quota[:, :n_zones],
    )
    nodes: List[Tuple[int, np.ndarray]] = []
    if res_count.sum() > 0:
        packed = _residual_ffd(solver, problem, res_count, res_quota)
        if packed is None:
            # consumer-heavy dregs the FFD strands: coverage-aware best-fill
            packed = _residual_greedy(problem, res_count, res_quota, caps)
        if packed is None:
            # residual pack can fail under load / a cut deadline: transient
            return finish(None, transient=True)
        nodes = packed

    # flatten: bulk columns + residual single nodes
    cols_o: List[int] = []
    ks: List[np.ndarray] = []
    for op in bulk_opens:
        ys = op.placements(G)
        for j in range(ys.shape[1]):
            cols_o.append(op.option)
            ks.append(ys[:, j])
    for o, k in nodes:
        cols_o.append(o)
        ks.append(k)
    if not ks:
        return finish(None)
    entry = _finalize_plan(
        problem, np.asarray(cols_o, np.int64), np.stack(ks, axis=1),
        assigned, count, caps, deadline,
    )
    return finish(entry)


def _finalize_plan(
    problem: EncodedProblem,
    opt_arr: np.ndarray,
    ys_arr: np.ndarray,
    assigned: np.ndarray,
    count: np.ndarray,
    caps: np.ndarray,
    deadline: Optional[float],
    rr: bool = True,
) -> Optional[_Finished]:
    """Capped ruin-recreate polish, exactness gate, count gate, decode and
    FULL name-level validation of a flattened (opt_arr, ys_arr) plan.
    Returns a cacheable _Finished or None. ``count`` is the NEW-node demand
    (problem.count minus pinned existing assignments)."""
    G = problem.G
    if rr:
        opt_arr, ys_arr = _capped_rr(problem, opt_arr, ys_arr, caps, deadline)

    if not np.array_equal(ys_arr.sum(axis=1), count):
        return None
    per_opt: Dict[int, List[np.ndarray]] = {}
    for j in range(opt_arr.shape[0]):
        if ys_arr[:, j].sum() > 0:
            per_opt.setdefault(int(opt_arr[j]), []).append(ys_arr[:, j])
    opens = [
        Opened(option=o, nodes=len(cs), ys=np.stack(cs, axis=1))
        for o, cs in per_opt.items()
    ]
    from .host import _check_counts, _decode
    from .validate import validate

    leftover = np.zeros(G, np.int64)
    if _check_counts(problem, assigned, opens, leftover):
        return None
    result = _decode(problem, assigned, opens, leftover)
    if validate(problem, result) != []:
        return None
    cost = plan_cost(problem, opens)
    result.stats["backend"] = 2.0
    result.stats["topo_patterns"] = 1.0
    result.stats["validated_counts"] = 1.0
    return _Finished(result, cost, opt_arr, ys_arr)
