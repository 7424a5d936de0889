"""Host fast path: vectorized grouped packing + LP polish for LP-safe problems.

Why this exists (and why it is part of the kernel-first design, not a retreat
from it): the group-deduplicated tensor encoding (``encode.py``) shrinks 50k pods to
tens of *groups*, so the control-plane-sized remainder of the problem — an
O(G x O') transportation LP over the option columns the rate analysis prunes —
solves in tens of milliseconds on host, while the kernel carries the parts
an LP cannot express (topology spread, anti-affinity, colocation, per-node
caps) and the wide portfolio search. ``TorchSolver`` runs both and returns the
cheapest validated result; through a slow device link the host path also
bounds end-to-end latency.

The reference has no analogue: its scheduler is a single greedy pass
(upstream ``designs/bin-packing.md:16-43``) that truncates to 60
instance types (``pkg/providers/instance/instance.go:55``). Holding the full
pods x types x zones problem and polishing it near-optimal is the capability
this rebuild adds.

Pipeline (all numpy, float64):
  1. ``refill_existing`` — first-fit the groups onto in-flight capacity
     (vectorized over nodes per group).
  2. ``config_greedy`` — set-cover greedy over (option, multi-group mix)
     configurations: each round builds, for every option in parallel, the best
     value-density mix of remaining groups, then opens the option with the best
     price/value ratio. This is what co-locates cpu-heavy with mem-heavy groups
     to saturate both axes (single-group packing strands the non-binding axis).
  3. ``lp_polish`` — prune columns to each group's top-rate options plus the
     greedy's picks, solve the small transportation LP (HiGHS), round down to
     uniform per-node mixes, and recurse the fractional leftovers through
     1.-2. Rounding can only add boundary nodes, and the result is validated
     like any other solve output.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .encode import EncodedProblem
from .result import NameSlice, NewNodeSpec, SolveResult

_EPS = 1e-9


def plan_cost(problem: "EncodedProblem", opens) -> float:
    """Total hourly price of a list of Opened node blocks."""
    price = problem.price
    return sum(op.nodes * float(price[op.option]) for op in opens)


def _fit_rows(cap: np.ndarray, dg: np.ndarray) -> np.ndarray:
    """Whole pods of per-pod demand ``dg`` fitting in each capacity row.

    Clamped at zero: capacity rows can be epsilon-NEGATIVE (a node packed to
    float-exact capacity leaves alloc - load ~ -1e-7), and a negative fit fed
    into the cumulative first-fit produces negative takes that still sum to
    the wanted count — a silently corrupt plan."""
    with np.errstate(divide="ignore", invalid="ignore"):
        fit = np.min(
            np.where(dg[None, :] > 0, np.floor(cap / np.maximum(dg[None, :], 1e-30) + _EPS), np.inf),
            axis=1,
        )
    return np.maximum(np.where(np.isfinite(fit), fit, 0.0), 0.0)


def lp_safe(problem: EncodedProblem) -> bool:
    """True when every group's constraints are expressible in the LP: plain
    resource demands + compat masks only. Spread/anti-affinity/colocation caps
    — and cross-group relation bits (incl. seeds) — are per-assignment
    constraints the LP relaxation would silently violate."""
    from .encode import BIG_CAP

    rel_active = any(
        a is not None and np.any(a)
        for a in (
            problem.rel_set, problem.rel_host_forbid, problem.rel_host_need,
            problem.rel_zone_forbid, problem.rel_zone_need,
            problem.rel_slot_bits, problem.rel_zone_bits,
        )
    )
    return bool(
        not rel_active
        and np.all(problem.node_cap >= BIG_CAP)
        and np.all(problem.zone_cap >= BIG_CAP)
        and np.all(problem.zone_skew == 0)
        and not np.any(problem.colocate)
    )


def _units_matrix(demand: np.ndarray, alloc: np.ndarray, compat: np.ndarray) -> np.ndarray:
    """units[g, o] = whole pods of group g per node of option o (0 if none)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        per = np.where(
            demand[:, None, :] > 0,
            np.floor(alloc[None, :, :] / np.maximum(demand[:, None, :], 1e-30) + _EPS),
            np.inf,
        )
    units = np.min(per, axis=2)
    units = np.where(np.isfinite(units), units, 0.0)
    return units * compat


def _units_rate(problem: EncodedProblem) -> Tuple[np.ndarray, np.ndarray]:
    """(units, per-pod rate) for the full option set, cached on the problem —
    lp_polish and config_greedy both need it and problems are re-solved
    (consolidation sweeps, steady-state reconciles)."""
    cached = problem.__dict__.get("_units_rate")
    if cached is None:
        units = _units_matrix(
            problem.demand.astype(np.float64),
            problem.alloc.astype(np.float64),
            problem.compat,
        )
        with np.errstate(divide="ignore"):
            rate = np.where(
                units > 0,
                problem.price.astype(np.float64)[None, :] / np.maximum(units, 1.0),
                np.inf,
            )
        cached = (units, rate)
        problem.__dict__["_units_rate"] = cached
    return cached


def refill_existing(
    problem: EncodedProblem, rem_counts: np.ndarray, ex_rem: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Shape-matched best-fit of groups (dominant-size descending) onto
    existing capacity: each group consumes the nodes whose remaining mem/cpu
    RATIO matches its own first (mem-heavy pods drain mem-rich fragments,
    cpu-heavy pods cpu-rich ones), tightest within a ratio band. Plain
    front-to-back first-fit stranded whole fragments whose ratio no remaining
    pod could tile — the repack-efficiency gap vs the LP bound.

    Returns (placements [G, E] int64, rem_counts', ex_rem'). Keeps the
    reference scheduler's existing-capacity-first preference, vectorized over
    nodes per group (no per-pod loop).
    """
    G, E = problem.G, problem.E
    placements = np.zeros((G, E), np.int64)
    if E == 0 or G == 0:
        return placements, rem_counts, ex_rem
    d = problem.demand.astype(np.float64)
    axes = problem.resource_axes
    from ..api.resources import CPU, MEMORY

    ci, mi = axes.index(CPU), axes.index(MEMORY)
    scale = np.maximum(problem.alloc.max(axis=0), 1e-30) if problem.O else np.ones(d.shape[1])
    order = np.argsort(-np.max(d / scale, axis=1), kind="stable")
    for g in order:
        want = int(rem_counts[g])
        if want <= 0:
            continue
        dg = d[g]
        fit = (_fit_rows(ex_rem, dg) * problem.ex_compat[g]).astype(np.int64)
        with np.errstate(divide="ignore"):
            node_ratio = np.log(np.maximum(ex_rem[:, mi], 1.0)) - np.log(
                np.maximum(ex_rem[:, ci], 1e-3)
            )
        pod_ratio = np.log(max(dg[mi], 1.0)) - np.log(max(dg[ci], 1e-3))
        mismatch = np.round(np.abs(node_ratio - pod_ratio), 1)
        node_order = np.lexsort(
            (np.max(ex_rem / scale[None, :], axis=1), mismatch)
        )
        fit_o = fit[node_order]
        before = np.cumsum(fit_o) - fit_o
        take_o = np.clip(want - before, 0, fit_o)
        take = np.zeros(E, np.int64)
        take[node_order] = take_o
        placements[g] = take
        ex_rem = ex_rem - take[:, None].astype(np.float64) * dg[None, :]
        rem_counts[g] = want - int(take.sum())
    return placements, rem_counts, ex_rem


@dataclass
class Opened:
    option: int
    nodes: int
    mix: Optional[np.ndarray] = None  # [G] pods of each group per node (uniform)
    ys: Optional[np.ndarray] = None  # [G, nodes] per-node placements (non-uniform)

    def placements(self, G: int) -> np.ndarray:
        if self.ys is not None:
            return self.ys
        return np.repeat(self.mix[:, None], self.nodes, axis=1)


def config_greedy(
    problem: EncodedProblem,
    rem: np.ndarray,
    lam: Optional[np.ndarray] = None,
    max_rounds: int = 256,
    opt_subset: Optional[np.ndarray] = None,
) -> Tuple[List[Opened], np.ndarray, float]:
    """Set-cover greedy over node configurations. Each round evaluates, fully
    vectorized over the O options, the best-density mix of the remaining
    groups, then opens k identical nodes of the winning (option, mix).
    ``opt_subset`` restricts the search to a pruned candidate column set
    (tail packing after an LP round only needs the LP's own columns)."""
    G = problem.G
    d = problem.demand.astype(np.float64)
    if opt_subset is None:
        opt_subset = np.arange(problem.O)
    alloc = problem.alloc.astype(np.float64)[opt_subset]
    price = problem.price.astype(np.float64)[opt_subset]
    compat = problem.compat[:, opt_subset]
    O = len(opt_subset)
    rem = rem.astype(np.int64).copy()
    opens: List[Opened] = []
    cost = 0.0
    if O == 0 or rem.sum() == 0:
        return opens, rem, cost

    if opt_subset.size == problem.O and np.array_equal(opt_subset, np.arange(problem.O)):
        units, full_rate = _units_rate(problem)
    else:
        units = _units_matrix(d, alloc, compat)
        full_rate = None
    if lam is None:
        if full_rate is None:
            with np.errstate(divide="ignore"):
                full_rate = np.where(
                    units > 0, price[None, :] / np.maximum(units, 1.0), np.inf
                )
        lam = full_rate.min(axis=1)  # cheapest achievable per-pod cost
        lam = np.where(np.isfinite(lam), lam, 0.0)
    # value density: lam per fraction-of-node consumed (dominant axis)
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.max(
            np.where(alloc[None, :, :] > 0, d[:, None, :] / np.maximum(alloc[None, :, :], 1e-30), np.inf),
            axis=2,
        )
    dens = np.where(compat & np.isfinite(frac) & (frac > 0), lam[:, None] / frac, -np.inf)
    order = np.argsort(-dens, axis=0).T  # [O, G]: per-option group fill order
    oidx = np.arange(O)

    for _ in range(max_rounds):
        if rem.sum() == 0:
            break
        capleft = alloc.copy()
        mix = np.zeros((O, G), np.int64)
        for rank in range(G):
            g = order[:, rank]
            dg = d[g]
            with np.errstate(divide="ignore", invalid="ignore"):
                fit = np.min(
                    np.where(dg > 0, np.floor(capleft / np.maximum(dg, 1e-30) + _EPS), np.inf),
                    axis=1,
                )
            fit = np.where(np.isfinite(fit), fit, 0.0)
            take = (np.minimum(fit, rem[g]) * compat[g, oidx]).astype(np.int64)
            mix[oidx, g] += take
            capleft -= take[:, None] * dg
        value = mix @ lam
        with np.errstate(divide="ignore", invalid="ignore"):
            score = np.where(value > 0, price / value, np.inf)
        o = int(np.argmin(score))
        if not np.isfinite(score[o]):
            break  # remaining groups have no compatible option
        m = mix[o]
        gsel = m > 0
        k = max(int(np.min(rem[gsel] // m[gsel])), 1)
        m = np.minimum(m, rem)  # k==1 tail may overshoot a group's remainder
        rem -= k * m
        cost += k * price[o]
        opens.append(Opened(option=int(opt_subset[o]), nodes=k, mix=m))
    return opens, rem, cost


@dataclass
class _LPPlan:
    """Fractional transportation-LP solution, kept so that multiple rounding
    strategies can be tried without re-solving the LP (the LP is ~70% of the
    host solve; a rounding pass is ~20%)."""

    cols: np.ndarray  # [Op] option ids of the pruned columns
    active: np.ndarray  # [Ga] group ids with remaining demand
    gi: np.ndarray  # [nx] arc group index (into active)
    oi: np.ndarray  # [nx] arc column index (into cols)
    x: np.ndarray  # [nx] fractional pods per arc
    n: np.ndarray  # [Op] fractional nodes per column
    fun: float  # LP objective — the fractional optimum over pruned columns


def lp_polish(
    problem: EncodedProblem,
    rem: np.ndarray,
    greedy_opens: List[Opened],
    topk: int = 16,
    time_limit: float = 5.0,
    mode: str = "nearest",
) -> Optional[Tuple[List[Opened], np.ndarray, float, np.ndarray]]:
    """Solve the pruned-column transportation LP for the remaining demand and
    round it to integral nodes (see ``lp_solve`` / ``lp_round``)."""
    plan = lp_solve(problem, rem, greedy_opens, topk=topk, time_limit=time_limit)
    if plan is None:
        return None
    if isinstance(plan, tuple):
        return plan  # trivial empty case
    opens, leftover, cost = lp_round(problem, rem, plan, mode=mode)
    return opens, leftover, cost, plan.cols


def topk_rate_options(rate: np.ndarray, active: np.ndarray, topk: int) -> set:
    """Candidate column pruning shared by the LP pipeline and the similarity
    fast path: each active group contributes its ``topk`` best per-pod-rate
    options (finite rates only)."""
    cand: set = set()
    for g in active:
        finite = np.isfinite(rate[g])
        k = min(topk, int(finite.sum()))
        if k:
            idx = np.argpartition(rate[g], k - 1)[:k]
            cand.update(int(j) for j in idx if np.isfinite(rate[g, j]))
    return cand


def lp_solve(
    problem: EncodedProblem,
    rem: np.ndarray,
    greedy_opens: List[Opened],
    topk: int = 16,
    time_limit: float = 5.0,
):
    """Solve the pruned-column transportation LP for the remaining demand.
    Column pruning (top-``topk`` rate options per group + the greedy's picks)
    empirically reproduces the full-LP optimum at a tiny fraction of the solve
    time (topk=16 closes the last efficiency point over 12 at 50k scale:
    906.4 -> 902.4 vs an 860.2 bound). Returns an ``_LPPlan``, an empty-case
    tuple, or None when scipy/HiGHS is unavailable or fails (callers keep the
    greedy result)."""
    try:
        from scipy import sparse
        from scipy.optimize import linprog
    except Exception:  # pragma: no cover
        return None

    G, O, R = problem.G, problem.O, len(problem.resource_axes)
    active = np.flatnonzero(rem > 0)
    if active.size == 0 or O == 0:
        return [], rem.copy(), 0.0, np.zeros(0, np.int64)
    d = problem.demand.astype(np.float64)
    alloc = problem.alloc.astype(np.float64)
    price = problem.price.astype(np.float64)
    units, rate = _units_rate(problem)
    # groups with NO compatible option can never be placed: excluding them
    # keeps the LP feasible and leaves their demand as leftover
    # (unschedulable) instead of poisoning the whole batch into the greedy
    # fallback — one untolerating pod must not cost every other pod the LP
    possible = np.isfinite(rate[active]).any(axis=1)
    active = active[possible]
    if active.size == 0:
        return None

    cand = {op.option for op in greedy_opens}
    cand |= topk_rate_options(rate, active, topk)
    cols = sorted(cand)
    if not cols:
        return None
    Op = len(cols)
    al = alloc[cols]
    pr = price[cols]
    cm = problem.compat[np.ix_(active, cols)]
    Ga = active.size

    gi, oi = np.nonzero(cm)
    # drop dominated pairs: an option whose per-pod rate for g is >5x g's best
    # rate never appears in a near-optimal basis, and column count drives the
    # HiGHS solve time
    sub_rate = rate[np.ix_(active, cols)]
    best_g = np.min(np.where(np.isfinite(sub_rate), sub_rate, np.inf), axis=1)
    keep = sub_rate[gi, oi] <= best_g[gi] * 5.0 + 1e-12
    gi, oi = gi[keep], oi[keep]
    nx = gi.shape[0]
    if nx == 0:
        return None
    c = np.concatenate([np.zeros(nx), pr])
    a_eq = sparse.csr_matrix((np.ones(nx), (gi, np.arange(nx))), shape=(Ga, nx + Op))
    b_eq = rem[active].astype(np.float64)
    rows, ccols, vals = [], [], []
    for r in range(R):
        dd = d[active[gi], r]
        nz = dd > 0
        rows.append(oi[nz] * R + r)
        ccols.append(np.flatnonzero(nz))
        vals.append(dd[nz])
    n_rows = (np.arange(Op)[:, None] * R + np.arange(R)[None, :]).flatten()
    n_cols = nx + np.repeat(np.arange(Op), R)
    a_ub = sparse.coo_matrix(
        (
            np.concatenate(vals + [-al.flatten()]),
            (np.concatenate(rows + [n_rows]), np.concatenate(ccols + [n_cols])),
        ),
        shape=(Op * R, nx + Op),
    ).tocsr()
    # scalar bounds + minimal options: scipy validates list-of-tuples bounds and
    # every option entry per call (~10ms of pure parse at this column count)
    res = linprog(
        c,
        A_ub=a_ub,
        b_ub=np.zeros(Op * R),
        A_eq=a_eq,
        b_eq=b_eq,
        bounds=(0, None),
        method="highs",
        options={"time_limit": time_limit},
    )
    if not res.success:
        return None
    return _LPPlan(
        cols=np.asarray(cols, np.int64),
        active=active,
        gi=gi,
        oi=oi,
        x=res.x[:nx],
        n=res.x[nx:],
        fun=float(res.fun),
    )


def lp_round(
    problem: EncodedProblem,
    rem: np.ndarray,
    plan: _LPPlan,
    mode: str = "nearest",
) -> Tuple[List[Opened], np.ndarray, float]:
    """Round a fractional LP plan to integral nodes: uniform base mix per node
    (provably feasible — the fractional uniform mix x/n fits the node), plus
    STAGGERED round-robin distribution of the integral extras — keeping every
    node near the LP's complementary mix. Front-to-back concentration would
    strand the non-binding axis of early nodes and overflow thousands of pods.

    ``mode`` picks the node-count rounding: "floor" leaves each column's
    fractional remainder to the tail packer; "nearest" keeps the extra node
    when frac > 0.5 (one node costs p_j; tail-packing ~frac*units leftover
    pods costs ~2*frac*p_j). Neither dominates — callers race both roundings
    off one LP solve when the latency budget allows."""
    G = problem.G
    d = problem.demand.astype(np.float64)
    alloc = problem.alloc.astype(np.float64)
    price = problem.price.astype(np.float64)
    cols = plan.cols
    active, gi, oi, x, n = plan.active, plan.gi, plan.oi, plan.x, plan.n
    Op = len(cols)
    pr = price[cols]

    opens: List[Opened] = []
    cost = 0.0
    placed = np.zeros(G, np.int64)
    for j in range(Op):
        nodes = int(np.floor(n[j] + 1e-7))
        if mode == "nearest" and n[j] - nodes > 0.5:
            nodes += 1
        if nodes <= 0:
            continue
        xo = np.zeros(G, np.int64)
        sel = oi == j
        xo[active[gi[sel]]] = np.floor(x[sel] + 1e-7).astype(np.int64)
        xo = np.minimum(xo, rem - placed)
        if xo.sum() == 0:
            continue
        # Uniform base mix floor(x/n) per node (provably feasible: the
        # fractional uniform mix x/n fits), then capacity-aware placement of
        # the integral extras into verified headroom. Keeping nodes near the
        # LP's complementary mix matters more than concentrating crumbs:
        # density-greedy or front-to-back fills exhaust one group early and
        # strand the non-binding axis of whole node ranges.
        # Divisor max(n_j, nodes): with nodes rounded UP, xo/nodes keeps
        # base*nodes <= xo (no overshoot past the group's demand) and the mix
        # still fits (smaller than the feasible fractional mix xo/n_j); with
        # nodes rounded DOWN, xo/n_j is the capacity-feasible choice.
        base = np.floor(xo / max(n[j], nodes, 1e-9) + 1e-9).astype(np.int64)
        ys = np.repeat(base[:, None], nodes, axis=1)
        cap = alloc[cols[j]][None, :] - (base.astype(np.float64) @ d)[None, :]
        cap = np.repeat(cap, nodes, axis=0)  # [N, R]
        order_g = np.argsort(-np.max(d / np.maximum(d.max(axis=0), 1e-30), axis=1), kind="stable")
        for g in order_g:
            r = int(xo[g] - base[g] * nodes)
            if r <= 0:
                continue
            dg = d[g]
            while r > 0:
                fits = np.all(cap >= dg[None, :] - 1e-9, axis=1)
                elig = np.flatnonzero(fits)[:r]
                if elig.size == 0:
                    break
                ys[g, elig] += 1
                cap[elig] -= dg[None, :]
                r -= elig.size
        used = ys.any(axis=0)
        n_used = int(used.sum())
        if n_used == 0:
            continue
        ys = ys[:, used]
        opens.append(Opened(option=cols[j], nodes=n_used, ys=ys))
        cost += n_used * pr[j]
        placed += ys.sum(axis=1)
    leftover = rem - placed
    return opens, leftover, cost


def ruin_recreate(
    problem: EncodedProblem,
    opens: List[Opened],
    cols: np.ndarray,
    frac: float = 0.08,
    rounds: int = 2,
) -> List[Opened]:
    """Local search on the open-node portfolio: free the lowest value-density
    nodes (pod value at cheapest-rate prices / node price) and repack their
    pods into remaining headroom + right-sized tail nodes. Recovers the
    LP-rounding integrality loss far more robustly than tuning the LP basis —
    rounded vertices of the degenerate transportation optimum vary wildly in
    roundability, but a density-guided repack converges from any of them
    (50k: 0.949-0.951 -> 0.962+; round 3 adds <0.0002, so the default stops
    at 2, ~15ms). Keeps a result only when strictly cheaper and complete, so
    it can never regress the input."""
    units, rate = _units_rate(problem)
    lam = rate.min(axis=1)
    lam = np.where(np.isfinite(lam), lam, 0.0)
    price = problem.price.astype(np.float64)
    col_set = np.asarray(
        sorted(set(np.asarray(cols).tolist()) | {op.option for op in opens}), np.int64
    )

    def total(ops: List[Opened]) -> float:
        return sum(op.nodes * price[op.option] for op in ops)

    for _ in range(rounds):
        dens_all = []
        metas = []
        for i, op in enumerate(opens):
            ys = op.placements(problem.G)
            dens = (lam @ ys) / max(price[op.option], 1e-12)
            dens_all.append(dens)
            metas.append(ys)
        if not metas:
            break
        alld = np.concatenate(dens_all)
        k = max(1, int(alld.size * frac))
        if alld.size <= 1:
            break
        thresh = np.partition(alld, k - 1)[k - 1]
        freed = np.zeros(problem.G, np.int64)
        new_opens: List[Opened] = []
        killed = 0
        for op, ys, dens in zip(opens, metas, dens_all):
            kill = dens <= thresh
            n_kill = int(kill.sum())
            if killed + n_kill > k:  # cap total kills at k across all options
                idx = np.flatnonzero(kill)[: k - killed]
                kill = np.zeros_like(kill)
                kill[idx] = True
                n_kill = int(kill.sum())
            if n_kill:
                freed += ys[:, kill].sum(axis=1)
                ys = ys[:, ~kill]
                killed += n_kill
            if ys.shape[1] > 0:
                new_opens.append(Opened(option=op.option, nodes=ys.shape[1], ys=ys))
        if freed.sum() == 0:
            break
        tails, left, _ = _finish_leftovers(problem, freed, new_opens, opt_subset=col_set)
        cand = new_opens + tails
        if left.sum() == 0 and total(cand) < total(opens) - 1e-9:
            opens = cand
        else:
            break
    return opens


def evacuate_into_existing(
    problem: EncodedProblem,
    placements: np.ndarray,
    opens: List[Opened],
    ex_rem: np.ndarray,
    rounds: int = 3,
) -> Tuple[np.ndarray, List[Opened]]:
    """Plan compaction: delete NEW nodes whose whole pod load relocates into
    leftover EXISTING fragments OR other new nodes' headroom. The LP bound
    tiles headroom fractionally; rounding can't, so slack scatters across
    fragments and tail nodes while whole nodes carry pods that slack could
    hold. Worst-value-density nodes are evacuated first; a node is removed
    only when every pod relocates, so the result is strictly cheaper or
    unchanged."""
    if not opens:
        return placements, opens
    G = problem.G
    E = problem.E
    d = problem.demand.astype(np.float64)
    price = problem.price.astype(np.float64)
    units, rate = _units_rate(problem)
    lam = rate.min(axis=1)
    lam = np.where(np.isfinite(lam), lam, 0.0)
    alloc = problem.alloc.astype(np.float64)

    # flatten the plan: slot arrays over [E existing] + [N new nodes]
    new_opt: List[int] = []
    new_ys: List[np.ndarray] = []
    for op in opens:
        ys = op.placements(G)
        for j in range(ys.shape[1]):
            new_opt.append(op.option)
            new_ys.append(ys[:, j].astype(np.int64))
    N = len(new_opt)
    if N == 0:
        return placements, opens
    opt_arr = np.asarray(new_opt, np.int64)
    ys_arr = np.stack(new_ys, axis=1)
    new_rem = alloc[opt_arr].copy() - (ys_arr.T.astype(np.float64) @ d)
    alive = np.ones(N, bool)

    for _ in range(rounds):
        moved = False
        dens = (lam @ ys_arr) / np.maximum(price[opt_arr], 1e-12)
        # candidate cap (ruin_recreate-style): only the lowest-density slice
        # pays the trial cost — a tight plan where nothing evacuates must not
        # spend ~10% of the solve discovering that, node by node
        n_try = max(4, int(alive.sum() * 0.15))
        tried = 0
        # cheap aggregate prefilter: total slack must cover the node's load
        slack_total = (ex_rem.sum(axis=0) if E else 0.0) + new_rem[alive].sum(axis=0)
        for j in np.argsort(dens):
            if tried >= n_try:
                break
            if not alive[j]:
                continue
            y = ys_arr[:, j]
            groups = np.flatnonzero(y)
            if groups.size == 0:
                alive[j] = False
                continue
            load = y.astype(np.float64) @ d
            own_slack = new_rem[j]
            if np.any(load > slack_total - own_slack + 1e-9):
                continue
            tried += 1
            trial_ex = ex_rem.copy()
            trial_new = new_rem.copy()
            takes_ex = []
            takes_new = []
            okay = True
            others = alive.copy()
            others[j] = False
            for g in groups:
                want = int(y[g])
                dg = d[g]
                fit_ex = _fit_rows(trial_ex, dg) if E else np.zeros(0)
                fit_ex = (fit_ex * problem.ex_compat[g]).astype(np.int64) if E else fit_ex.astype(np.int64)
                fit_new = np.where(
                    others & problem.compat[g, opt_arr], _fit_rows(trial_new, dg), 0.0
                ).astype(np.int64)
                fit_all = np.concatenate([fit_ex, fit_new])
                before = np.cumsum(fit_all) - fit_all
                take = np.clip(want - before, 0, fit_all)
                if int(take.sum()) < want:
                    okay = False
                    break
                te, tn = take[:E], take[E:]
                if E:
                    trial_ex -= te[:, None].astype(np.float64) * dg[None, :]
                trial_new -= tn[:, None].astype(np.float64) * dg[None, :]
                takes_ex.append((g, te))
                takes_new.append((g, tn))
            if not okay:
                continue
            ex_rem = trial_ex
            new_rem = trial_new
            for g, te in takes_ex:
                placements[g] += te
            for g, tn in takes_new:
                ys_arr[g] += tn
            ys_arr[:, j] = 0
            alive[j] = False
            moved = True
        if not moved:
            break

    # rebuild the Opened list from surviving slots
    out: Dict[int, List[np.ndarray]] = {}
    for j in range(N):
        if alive[j] and ys_arr[:, j].sum() > 0:
            out.setdefault(int(opt_arr[j]), []).append(ys_arr[:, j])
    opens2 = [
        Opened(option=o, nodes=len(colmns), ys=np.stack(colmns, axis=1))
        for o, colmns in out.items()
    ]
    return placements, opens2


def solve_host(
    problem: EncodedProblem,
    deadline: Optional[float] = None,
    spike_s: float = 1.5,
) -> Optional[SolveResult]:
    """Full host pipeline for LP-safe problems. Returns None when the problem
    has constraint shapes only the kernel handles (spread/affinity/colocate).

    ``deadline`` (perf_counter timestamp) bounds the ADAPTIVE tail: once a
    complete feasible plan exists, leftover latency budget is spent closing
    the integrality gap (pattern column generation, varied-fraction
    ruin-recreate) instead of returning early at a fixed polish depth."""
    if not lp_safe(problem):
        return None
    t0 = time.perf_counter()
    # Warm-solve cache: repeat solves of the SAME problem (benchmark loops,
    # steady-state reconciles of an unchanged cluster) skip the deterministic
    # pipeline — refill, LP, rounding races, base ruin-recreate — and spend
    # their whole budget on the adaptive tail below. placements/ex_rem are
    # snapshot copies because evacuate_into_existing mutates them in place.
    warm = problem.__dict__.get("_host_warm")
    if warm is not None:
        placements, rem, ex_rem, plan_obj, best = warm
        placements = placements.copy()
        rem = rem.copy()
        ex_rem = ex_rem.copy()
    else:
        rem = problem.count.astype(np.int64).copy()
        ex_rem = problem.ex_rem.astype(np.float64).copy()
        placements, rem, ex_rem = refill_existing(problem, rem, ex_rem)

        best: Optional[Tuple[List[Opened], np.ndarray, float]] = None
        # Similar-problem fast path: a fresh batch that is a near-copy of a
        # recently learned one (steady-state reconciles: same catalog, a few
        # pods changed) reuses the learned pattern pool instead of re-running
        # the assignment-LP pipeline — cheaper AND at the converged pool's
        # efficiency. Validated like any other plan.
        from .patterns import similar_warm_start

        sim = similar_warm_start(problem, rem, deadline=deadline)
        if sim is not None:
            s_opens, s_cost, s_cols, s_fun, s_left = sim
            best = (s_opens, s_left, s_cost)
            plan_obj = _LPPlan(
                cols=s_cols, active=np.flatnonzero(rem > 0),
                gi=np.zeros(0, np.int64), oi=np.zeros(0, np.int64),
                x=np.zeros(0), n=np.zeros(0), fun=s_fun,
            )
            # copies in: a failed fast path must not leave evacuation's
            # in-place placement moves behind for the pipeline retry
            result = _finalize_host(
                problem, placements.copy(), rem.copy(), ex_rem.copy(),
                plan_obj, best, deadline, t0, spike_s,
            )
            if result is not None:
                result.stats["similar_warm"] = 1.0
                return result
            best = None  # fast path failed the count gate; run the pipeline
        plan = lp_solve(problem, rem, [], topk=8)
        if isinstance(plan, tuple):  # no remaining demand
            plan_obj = None
            best = (plan[0], plan[1], plan[2])
        else:
            plan_obj = plan
        if plan_obj is not None:
            # Race roundings (and, while the budget allows, a second column
            # pruning) off LP solves: "nearest" usually wins at scale, "floor"
            # at small scale, and the pruning level shifts the fractional
            # basis — none dominates. A rounding+tail pass costs ~20% of the
            # LP, a small-problem re-LP a few ms; every later candidate runs
            # only while elapsed time stays inside the latency budget or the
            # integrality gap is still large.
            def try_round(plan: _LPPlan, mode: str) -> None:
                nonlocal best
                lp_opens, lp_left, lp_cost = lp_round(problem, rem, plan, mode=mode)
                if lp_left.sum() > 0:
                    # boundary residue: fill opened headroom, right-size tails
                    tail_opens, lp_left, tail_cost = _finish_leftovers(
                        problem, lp_left, lp_opens, opt_subset=plan.cols
                    )
                    lp_opens = lp_opens + tail_opens
                    lp_cost += tail_cost
                if (
                    best is None
                    or lp_left.sum() < best[1].sum()
                    or (lp_left.sum() == best[1].sum() and lp_cost < best[2])
                ):
                    best = (lp_opens, lp_left, lp_cost)

            def gap_bad() -> bool:
                if best is None or best[1].sum() > 0:
                    return True
                return best[2] / max(plan_obj.fun, 1e-12) > 1.06

            n_pods = int(rem.sum())
            try_round(plan_obj, "nearest")
            if n_pods <= 20_000 or gap_bad():
                try_round(plan_obj, "floor")
            if n_pods <= 2_000 or gap_bad():
                plan2 = lp_solve(problem, rem, [], topk=12)
                if isinstance(plan2, _LPPlan):
                    try_round(plan2, "floor")
                    try_round(plan2, "nearest")
            if best is not None and best[1].sum() == 0 and best[0]:
                # density-guided local search recovers rounding loss —
                # skipped when a cold pipeline has already burned the budget
                # (the adaptive tail's banked pattern pool recovers more on
                # the next solve anyway)
                if deadline is None or time.perf_counter() < deadline:
                    rr_opens = ruin_recreate(problem, best[0], plan_obj.cols)
                    rr_cost = plan_cost(problem, rr_opens)
                    if rr_cost < best[2] - 1e-9:
                        best = (rr_opens, best[1], rr_cost)
        if best is None or best[1].sum() > 0:
            # LP unavailable or failed to place everything: greedy baseline
            g_opens, g_left, g_cost = config_greedy(problem, rem)
            if best is None or g_left.sum() < best[1].sum() or (
                g_left.sum() == best[1].sum() and g_cost < best[2]
            ):
                best = (g_opens, g_left, g_cost)

    return _finalize_host(
        problem, placements, rem, ex_rem, plan_obj, best, deadline, t0, spike_s
    )


def _finalize_host(
    problem: EncodedProblem,
    placements: np.ndarray,
    rem: np.ndarray,
    ex_rem: np.ndarray,
    plan_obj,
    best: Optional[Tuple[List[Opened], np.ndarray, float]],
    deadline: Optional[float],
    t0: float,
    spike_s: float = 1.5,
) -> Optional[SolveResult]:
    """Shared tail of every host path: adaptive polish (pattern CG +
    ruin-recreate sweep), warm-state snapshot, existing-fragment evacuation,
    the count-level feasibility gate, and decode."""
    if best is None:
        return None
    # A plan is "complete" for polish/warm purposes when every leftover pod
    # is STRUCTURALLY unschedulable (no compatible option anywhere): those
    # pods stay unschedulable no matter what, and their presence must not
    # disable the adaptive tail or force a full re-pipeline every reconcile.
    left = best[1]
    complete = left.sum() == 0
    rem_eff = rem
    if not complete:
        _, rate = _units_rate(problem)
        hopeless = ~np.isfinite(rate).any(axis=1)
        if not np.any(left[~hopeless]):
            complete = True
            rem_eff = (rem - left).astype(rem.dtype)
    if plan_obj is not None and complete and best[0]:
        # -- adaptive tail ----------------------------------------------------
        # pattern column generation: per-node integer patterns close the
        # rounding gap the assignment LP cannot see (patterns.py; 50k:
        # 0.9625 -> 0.972 efficiency); deadline-aware, pool-cached, and only
        # engaged from the second solve of a problem
        from .patterns import pattern_improve

        if not problem.__dict__.get("_repack_owned", False):
            improved = pattern_improve(
                problem, rem_eff, best[0], best[2], plan_obj.cols, plan_obj.fun,
                deadline=deadline, spike_s=spike_s,
            )
            if improved is not None:
                best = (improved[0], best[1], improved[1])
        if problem.E:
            # joint existing+new pattern CG (repack.py): re-decides how much
            # each existing bin absorbs TOGETHER with the new-node patterns —
            # the sequential refill-then-LP decomposition is the repack
            # efficiency floor. Gated like the other
            # closers; adopted only when cheaper and count-exact.
            from .repack import repack_improve

            rp = repack_improve(
                problem, best[2], placements, best[0], plan_obj.cols,
                deadline=deadline, spike_s=spike_s, incumbent_left=best[1],
            )
            if rp is not None:
                new_plc, new_opens, new_cost = rp
                if not _check_counts(problem, new_plc, new_opens, best[1]):
                    placements = new_plc
                    best = (new_opens, best[1], new_cost)
                    # the joint plan OWNS this problem now: the refill-
                    # decomposition state (rem, pattern pool's cached plan)
                    # no longer matches the placements, so rem is rebased and
                    # pattern_improve stays out — its cached rounding covers
                    # the old remainder and would poison the count gate
                    problem.__dict__["_repack_owned"] = True
                    rem = (
                        problem.count.astype(np.int64) - placements.sum(axis=1)
                    ).astype(rem.dtype)
                    # existing headroom moved with the new placements
                    ex_rem = problem.ex_rem.astype(np.float64) - (
                        placements.T.astype(np.float64)
                        @ problem.demand.astype(np.float64)
                    )
        # leftover-budget polish: varied ruin fractions explore different
        # kill thresholds; each round kept only if strictly cheaper; stops at
        # the deadline or when improvement dries up — no fixed round cap.
        # Exhaustion memo: a dry sweep is not re-paid until the cost changes.
        if problem.__dict__.pop("_patterns_warmup_solve", False) and deadline is not None:
            # the pattern warmup already blew this solve's budget once —
            # finish the whole adaptation (frac sweep included) in the same
            # spike instead of leaking a second slow solve
            deadline = max(deadline, time.perf_counter() + min(0.1, spike_s))
        if (
            deadline is not None
            and problem.__dict__.get("_rr_exhausted_at") != best[2]
        ):
            rr_est = 0.02
            no_gain = 0
            for frac in (0.2, 0.1, 0.14, 0.08, 0.25, 0.12, 0.3, 0.06):
                if no_gain >= 3 or time.perf_counter() + rr_est > deadline:
                    break
                t_rr = time.perf_counter()
                cand = ruin_recreate(
                    problem, best[0], plan_obj.cols, frac=frac, rounds=1
                )
                rr_est = max(0.005, time.perf_counter() - t_rr)
                c_cand = plan_cost(problem, cand)
                if c_cand < best[2] - 1e-9:
                    best = (cand, best[1], c_cand)
                    no_gain = 0
                else:
                    no_gain += 1
            if no_gain >= 3:
                # memoize only a sweep that ran DRY — a deadline cut (or a
                # sweep that never started) must retry on the next solve
                problem.__dict__["_rr_exhausted_at"] = best[2]

    if complete:
        # snapshot BEFORE evacuate mutates placements/ex_rem in place
        problem.__dict__["_host_warm"] = (
            placements.copy(), rem.copy(), ex_rem.copy(), plan_obj, best,
        )

    if problem.E and best[0]:
        # stranded-fragment recovery: delete new nodes whose load fits into
        # leftover existing headroom (strictly cheaper or no-op)
        placements, opens2 = evacuate_into_existing(
            problem, placements, best[0], ex_rem
        )
        best = (
            opens2,
            best[1],
            plan_cost(problem, opens2),
        )

    errors = _check_counts(problem, placements, best[0], best[1])
    if errors:
        # should be unreachable (every stage is capacity-checked); bail to the
        # kernel path rather than emit an infeasible plan — and drop the warm
        # snapshot so the next solve re-derives instead of replaying the bug
        problem.__dict__.pop("_host_warm", None)
        return None
    result = _decode(problem, placements, best[0], best[1])
    result.stats["solve_s"] = time.perf_counter() - t0
    result.stats["backend"] = 2.0  # host fast path
    result.stats["validated_counts"] = 1.0
    return result


def _check_counts(
    problem: EncodedProblem,
    placements: np.ndarray,
    opens: List[Opened],
    leftover: np.ndarray,
) -> List[str]:
    """Arithmetic feasibility gate on the count matrices — the same invariants
    as ``validate.validate`` (capacity, compat, completeness) checked directly
    on the [G, N] placements instead of 50k pod-name strings. ``_decode``'s
    name slicing is a deterministic expansion of these counts (unit-tested
    against the name-level validator)."""
    errors: List[str] = []
    d = problem.demand.astype(np.float64)
    total = np.zeros(problem.G, np.int64)
    if problem.E:
        used = placements.T.astype(np.float64) @ d  # [E, R]
        if np.any(used > problem.ex_rem * (1 + 5e-4) + 1e-6):
            errors.append("existing node over remaining capacity")
        if placements.size and np.any(placements[~problem.ex_compat.astype(bool)] != 0):
            errors.append("incompatible placement on existing node")
        total += placements.sum(axis=1)
    for op in opens:
        ys = op.placements(problem.G)
        load = ys.T.astype(np.float64) @ d  # [N, R]
        if np.any(load > problem.alloc[op.option][None, :] * (1 + 5e-4) + 1e-6):
            errors.append(f"option {op.option} node over capacity")
        bad = ~problem.compat[:, op.option]
        if np.any(ys[bad] != 0):
            errors.append(f"incompatible group on option {op.option}")
        total += ys.sum(axis=1)
    if np.any(total + leftover != problem.count):
        errors.append("placement counts do not cover demand exactly")
    return errors


def _finish_leftovers(
    problem: EncodedProblem,
    leftover: np.ndarray,
    opens: List[Opened],
    opt_subset: Optional[np.ndarray] = None,
) -> Tuple[List[Opened], np.ndarray, float]:
    """Place LP-rounding residue into the opened nodes' leftover headroom, then
    open right-sized nodes for what remains (config greedy on the tail)."""
    d = problem.demand.astype(np.float64)
    alloc = problem.alloc.astype(np.float64)
    rem = leftover.astype(np.int64).copy()
    for op in opens:
        if rem.sum() == 0:
            break
        ys = op.placements(problem.G)  # [G, N]
        cap = alloc[op.option][None, :] - ys.T.astype(np.float64) @ d  # [N, R]
        changed = False
        for g in np.argsort(-np.max(d / np.maximum(d.max(axis=0), 1e-30), axis=1), kind="stable"):
            want = int(rem[g])
            if want <= 0 or not problem.compat[g, op.option]:
                continue
            dg = d[g]
            fit = _fit_rows(cap, dg).astype(np.int64)
            before = np.cumsum(fit) - fit
            take = np.clip(want - before, 0, fit)
            taken = int(take.sum())
            if taken == 0:
                continue
            ys = ys.copy() if not changed else ys
            ys[g] += take
            cap -= take[:, None].astype(np.float64) * dg[None, :]
            rem[g] -= taken
            changed = True
        if changed:
            op.ys = ys
            op.mix = None
    tail_opens, tail_left, tail_cost = config_greedy(problem, rem, opt_subset=opt_subset)
    if tail_left.sum() > 0 and opt_subset is not None:
        # pruned columns couldn't finish (e.g. a group's only compatible
        # options fell outside the LP candidate set): retry unrestricted
        more_opens, tail_left, more_cost = config_greedy(problem, tail_left)
        tail_opens += more_opens
        tail_cost += more_cost
    return tail_opens, tail_left, tail_cost


def _decode(
    problem: EncodedProblem,
    placements: np.ndarray,
    opens: List[Opened],
    leftover: np.ndarray,
) -> SolveResult:
    """Expand (option, nodes, mix) configurations into per-node pod lists.

    Emits ``NameSlice`` views (lazy (namelist, start, count) segments) instead
    of copying name strings per node: the decision the solver is timed on is
    the (option, counts) plan; 50k string copies only ever matter for nodes
    that actually get bound, and the view materializes then.
    """
    G = problem.G
    cursor = np.zeros(G, np.int64)
    group_names = problem.__dict__.get("_group_names")
    if group_names is None:
        from .result import LazyNames

        group_names = [LazyNames(g.pods) for g in problem.groups]
        problem.__dict__["_group_names"] = group_names
    existing_assignments = {}
    for e in range(problem.E):
        segs = []
        for g in range(G):
            n = int(placements[g, e])
            if n:
                segs.append((group_names[g], int(cursor[g]), n))
                cursor[g] += n
        if segs:
            existing_assignments[problem.existing[e].name] = NameSlice(segs)

    new_nodes: List[NewNodeSpec] = []
    cost = 0.0
    for op in opens:
        option = problem.options[op.option]
        ys = op.placements(G)  # [G, N]
        n_nodes = ys.shape[1]
        # per-group integer counts clamped to remaining pods
        actives = []
        for g in np.flatnonzero(ys.any(axis=1)):
            avail = int(problem.count[g] - cursor[g])
            before = np.cumsum(ys[g]) - ys[g]
            counts = np.clip(np.minimum(ys[g], avail - before), 0, None).tolist()
            taken = int(sum(counts))
            actives.append((counts, group_names[g], [int(cursor[g])]))
            cursor[g] += taken
        for i in range(n_nodes):
            segs = []
            for counts, namelist, cur in actives:
                c = counts[i]
                if c:
                    segs.append((namelist, cur[0], c))
                    cur[0] += c
            if segs:
                new_nodes.append(
                    NewNodeSpec(
                        option=option, pod_names=NameSlice(segs), option_index=op.option
                    )
                )
                cost += option.price

    unschedulable: List[str] = []
    for g in range(G):
        if cursor[g] < problem.count[g]:
            unschedulable.extend(p.name for p in problem.groups[g].pods[cursor[g] :])
    return SolveResult(
        new_nodes=new_nodes,
        existing_assignments=existing_assignments,
        unschedulable=unschedulable,
        cost=cost,
        stats={"nodes_opened": float(len(new_nodes))},
    )
