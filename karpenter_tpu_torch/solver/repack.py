"""Joint existing+new pattern CG for repack shapes (E > 0).

The LP-safe pipeline handles existing capacity SEQUENTIALLY: an integral
refill consumes the in-flight nodes, then the assignment LP + pattern CG
optimize the new-node remainder. Measured on the 20k-repack benchmark, that
decomposition is the efficiency floor: after ANY
integral refill the remainder's fractional optimum sits ~2.5% above the full
LP bound, because the bound tiles the 1,500 existing bins fractionally while
the refill commits to one integral mix per bin before the new-node trade-off
is known.

This module closes the loop with a JOINT cutting-stock master over two
column families:

* option patterns — integer node contents for a new node of one launch
  option, priced at the option's hourly cost (same columns as
  ``patterns.py``);
* bin patterns — integer contents packed into one EXISTING node's remaining
  capacity, priced at 0, with a ≤1-per-bin side constraint (each in-flight
  node is a single bin).

The master chooses how much of each group to serve from existing room vs new
nodes simultaneously; dual-guided pricing (vectorized across options and
across bin clusters, plus exact-ish pairwise level sweeps) generates
improving columns for both families. Rounding floors the cluster-pattern
multiplicities onto distinct member bins, floors the option patterns, and
repairs the crumbs with the host pipeline's own tail machinery. The result
replaces the incumbent only when strictly cheaper AND the count gate passes.

Measured honesty note (20k-repack config): the sequential pipeline's answer
sits within ~0.03% of the converged joint master (84.53 vs 84.51), i.e. the
decomposition loss is nearly all BOUND looseness (fractional bin tiling),
not solver gap — see ``bounds.best_lower_bound``. This module still earns
its keep on fleets where the refill heuristic misjudges the existing/new
trade-off; when it cannot undercut the incumbent it caches that verdict and
costs steady state nothing.

Reference behavior being beaten: the consolidation loop's per-node greedy
re-simulation (upstream ``designs/consolidation.md:25-36``); the
reference has no joint packing optimization at all.

Like the other closers this is gated to REPEAT solves (plus similarity
transfer of the finished placement via the state cache) and its one-time
build is bounded by the solver's warmup spike.
"""

from __future__ import annotations

import time
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils import metrics
from .encode import EncodedProblem
from .host import Opened, _finish_leftovers, plan_cost, refill_existing, _units_rate

try:  # pragma: no cover - scipy is baked into the image
    from scipy import sparse
    from scipy.optimize import linprog

    _HAVE_SCIPY = True
except Exception:  # pragma: no cover
    _HAVE_SCIPY = False

_STATE_CACHE_MAX = 4
_TRANSIENT_RETRIES = 2
_state_cache: Dict[int, tuple] = {}
_seen: "weakref.WeakValueDictionary[int, EncodedProblem]" = weakref.WeakValueDictionary()


class _RepackPlan:
    """Finished joint plan: existing placements + new-node opens + cost."""

    __slots__ = ("placements", "opens", "cost", "savings_counted")

    def __init__(self, placements, opens, cost):
        self.placements = placements
        self.opens = opens
        self.cost = cost
        self.savings_counted = False


def _price_pair_patterns(
    problem: EncodedProblem,
    cluster_cap: np.ndarray,
    duals: np.ndarray,
    mu: np.ndarray,
    compat: np.ndarray,
    active: np.ndarray,
    levels: int = 6,
) -> List[Tuple[int, np.ndarray]]:
    """Two-group mix pricing, vectorized across clusters: for every ordered
    active pair (g1, g2) and a sweep of g1 fill levels, pack n1 pods of g1
    then max-fill g2 into the remainder. Returns the improving (cluster,
    contents) columns (reduced cost > mu). Complements the greedy knapsack,
    whose bulk heuristic misses complementary two-group mixes."""
    d = problem.demand.astype(np.float64)
    C, R = cluster_cap.shape
    G = d.shape[0]
    out: List[Tuple[int, np.ndarray]] = []
    pos = [g for g in active if duals[g] > 0]
    best_val = mu.copy() + 1e-9  # must strictly beat the bin dual
    best_pat = [None] * C
    with np.errstate(divide="ignore", invalid="ignore"):
        fill_all = np.min(
            np.where(
                d[None, :, :] > 0,
                np.floor(cluster_cap[:, None, :] / np.maximum(d[None, :, :], 1e-30) + 1e-9),
                np.inf,
            ),
            axis=2,
        )
    fill_all = np.where(np.isfinite(fill_all), fill_all, 0.0) * compat
    for g1 in pos:
        f1 = fill_all[:, g1]  # [C]
        for lv in range(1, levels + 1):
            n1 = np.floor(f1 * lv / levels).astype(np.int64)
            rem_cap = cluster_cap - n1[:, None] * d[g1][None, :]
            for g2 in pos:
                if g2 == g1:
                    continue
                with np.errstate(divide="ignore", invalid="ignore"):
                    n2 = np.min(
                        np.where(
                            d[g2][None, :] > 0,
                            np.floor(rem_cap / np.maximum(d[g2][None, :], 1e-30) + 1e-9),
                            np.inf,
                        ),
                        axis=1,
                    )
                n2 = np.where(np.isfinite(n2), n2, 0.0)
                n2 = np.maximum(n2, 0.0) * compat[:, g2]
                val = duals[g1] * n1 + duals[g2] * n2
                better = val > best_val
                for ci in np.flatnonzero(better):
                    k = np.zeros(G, np.int64)
                    k[g1] = n1[ci]
                    k[g2] = int(n2[ci])
                    if k.sum() > 0:
                        best_val[ci] = val[ci]
                        best_pat[ci] = k
    for ci, k in enumerate(best_pat):
        if k is not None:
            out.append((ci, k))
    return out


def _cluster_bins(problem: EncodedProblem, ex_rem: np.ndarray):
    """Group existing bins into capacity clusters keyed on the SOLVER-
    relevant equivalence: the per-group integer fill vector (whole pods of
    each group the bin's remaining capacity holds alone) plus the compat
    column. Bins with identical fill vectors admit the same single-group
    patterns and nearly the same mixes, so the element-wise MIN capacity over
    members — the cluster's shared capacity every pattern must fit — loses
    only sub-pod dust. Returns (cluster_cap [C, R], cluster_compat [G, C],
    members: list of member-index arrays)."""
    E = ex_rem.shape[0]
    d = problem.demand.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        fills = np.min(
            np.where(
                d[None, :, :] > 0,
                np.floor(ex_rem[:, None, :] / np.maximum(d[None, :, :], 1e-30) + 1e-9),
                np.inf,
            ),
            axis=2,
        )  # [E, G]
    fills = np.where(np.isfinite(fills), fills, 0.0).astype(np.int32)
    keys: Dict[tuple, List[int]] = {}
    ex_compat = problem.ex_compat
    for e in range(E):
        keys.setdefault(
            (fills[e].tobytes(), ex_compat[:, e].tobytes()), []
        ).append(e)
    members = [np.asarray(v, np.int64) for v in keys.values()]
    cluster_cap = np.stack([ex_rem[m].min(axis=0) for m in members], axis=0)
    cluster_compat = np.stack(
        [ex_compat[:, m[0]] for m in members], axis=1
    )
    return cluster_cap, cluster_compat, members


class _JointPool:
    """Two column families, parallel lists. Option columns carry an option
    id; cluster columns carry the bin-cluster index they occupy."""

    def __init__(self, G: int):
        self.G = G
        self.opt_ids: List[int] = []
        self.opt_contents: List[np.ndarray] = []
        self.cl_ids: List[int] = []
        self.cl_contents: List[np.ndarray] = []
        self._seen: set = set()
        self.converged = False

    def add_opt(self, option: int, k: np.ndarray) -> bool:
        if k.sum() <= 0:
            return False
        key = ("o", int(option), k.tobytes())
        if key in self._seen:
            return False
        self._seen.add(key)
        self.opt_ids.append(int(option))
        self.opt_contents.append(k.astype(np.int64))
        return True

    def add_cluster(self, c: int, k: np.ndarray) -> bool:
        if k.sum() <= 0:
            return False
        key = ("c", int(c), k.tobytes())
        if key in self._seen:
            return False
        self._seen.add(key)
        self.cl_ids.append(int(c))
        self.cl_contents.append(k.astype(np.int64))
        return True


def _solve_joint_master(
    pool: _JointPool,
    price: np.ndarray,
    rem: np.ndarray,
    active: np.ndarray,
    sizes: np.ndarray,
):
    """Master LP: min price·y  s.t.  A y + B w >= rem[active],
    sum_{q in cluster c} w_q <= size_c, y,w >= 0."""
    n_opt = len(pool.opt_ids)
    n_cl = len(pool.cl_ids)
    A = (
        np.stack(pool.opt_contents, axis=1)
        if n_opt
        else np.zeros((pool.G, 0))
    )
    B = (
        np.stack(pool.cl_contents, axis=1)
        if n_cl
        else np.zeros((pool.G, 0))
    )
    cover = np.concatenate([A[active], B[active]], axis=1)
    c_vec = np.concatenate(
        [price[np.asarray(pool.opt_ids, np.int64)], np.zeros(n_cl)]
    )
    C = sizes.shape[0]
    cl_mat = sparse.csr_matrix(
        (np.ones(n_cl), (pool.cl_ids, n_opt + np.arange(n_cl))),
        shape=(C, n_opt + n_cl),
    )
    a_ub = sparse.vstack([sparse.csr_matrix(-cover), cl_mat]).tocsr()
    b_ub = np.concatenate([
        -rem[active].astype(np.float64), sizes.astype(np.float64),
    ])
    res = linprog(
        c_vec, A_ub=a_ub, b_ub=b_ub, bounds=(0, None), method="highs",
        options={"time_limit": 5.0},
    )
    return res, n_opt


def repack_improve(
    problem: EncodedProblem,
    incumbent_cost: float,
    incumbent_placements: np.ndarray,
    incumbent_opens: List[Opened],
    cols,
    deadline: Optional[float] = None,
    min_pods: int = 4000,
    spike_s: float = 1.5,
    incumbent_left: Optional[np.ndarray] = None,
) -> Optional[Tuple[np.ndarray, List[Opened], float]]:
    """Joint existing+new pattern CG. Returns (placements, opens, cost)
    strictly cheaper than ``incumbent_cost``, or None. Engages from the
    third solve of a problem (bounded one-time spike); finished plans are
    cached per problem and replayed in ~ms. ``incumbent_left`` is the
    incumbent's unschedulable leftover: the joint plan targets exactly
    count - leftover, or it could never pass the caller's count gate."""
    if not _HAVE_SCIPY or problem.E == 0 or problem.G == 0:
        return None
    rem = problem.count.astype(np.int64)
    if incumbent_left is not None:
        rem = rem - incumbent_left.astype(np.int64)
    if rem.sum() < min_pods:
        return None
    key = id(problem)
    transient_attempts = 0
    cached = _state_cache.get(key)
    if cached is not None and cached[0] is problem:
        entry = cached[1]
        if entry is None:
            return None
        if isinstance(entry, _RepackPlan):
            return _deliver(entry, incumbent_cost)
        transient_attempts = entry[1]
        if transient_attempts >= _TRANSIENT_RETRIES:
            return None
    elif _seen.get(key) is not problem:
        _seen[key] = problem
        return None
    else:
        # engage from the THIRD solve: pattern CG's one-time convergence
        # (second solve) must settle first, or this build could adopt a plan
        # cheaper than a half-converged incumbent and lock the better
        # pattern answer out for the problem's lifetime
        sightings = problem.__dict__.get("_repack_sightings", 0) + 1
        problem.__dict__["_repack_sightings"] = sightings
        if sightings < 2:
            return None
    spike = min(1.5, float(spike_s))
    if deadline is not None and spike > 0:
        deadline = max(deadline, time.perf_counter() + spike)

    from .patterns import _cache_put

    def finish(entry, transient: bool = False):
        if entry is None and transient:
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

    G, E = problem.G, problem.E
    price = problem.price.astype(np.float64)
    d = problem.demand.astype(np.float64)
    ex_rem0 = problem.ex_rem.astype(np.float64)
    units, rate = _units_rate(problem)
    active = np.flatnonzero(rem > 0)
    if active.size == 0:
        return finish(None)

    cluster_cap, cluster_compat, members = _cluster_bins(problem, ex_rem0)
    C = len(members)
    sizes = np.asarray([len(m) for m in members], np.int64)
    cluster_of = np.zeros(E, np.int64)
    for ci, m in enumerate(members):
        cluster_of[m] = ci

    pool = _JointPool(G)
    # seeds: the incumbent's own columns — master starts near incumbent cost.
    # A bin's incumbent pattern seeds its CLUSTER only when it fits the
    # cluster's shared (min) capacity.
    for op in incumbent_opens:
        ys = op.placements(G)
        for k in np.unique(ys.T, axis=0):
            pool.add_opt(op.option, k)
    for e in range(E):
        k = incumbent_placements[:, e]
        if k.sum() > 0:
            ci = int(cluster_of[e])
            if np.all(k.astype(np.float64) @ d <= cluster_cap[ci] + 1e-9):
                pool.add_cluster(ci, k)
    # single-group max-fill patterns for every (cluster, group): the
    # workhorse columns for absorbing one group into fragments — the greedy
    # pricing's bulk mixes alone converge prematurely without them
    with np.errstate(divide="ignore", invalid="ignore"):
        fill = np.min(
            np.where(
                d[None, :, :] > 0,
                np.floor(cluster_cap[:, None, :] / np.maximum(d[None, :, :], 1e-30) + 1e-9),
                np.inf,
            ),
            axis=2,
        )  # [C, G]
    fill = np.where(np.isfinite(fill), fill, 0.0) * cluster_compat.T
    for ci in range(C):
        for g in active:
            n = int(fill[ci, g])
            if n > 0:
                k = np.zeros(G, np.int64)
                k[g] = n
                pool.add_cluster(ci, k)
    res, n_opt = _solve_joint_master(pool, price, rem, active, sizes)
    if res.status != 0:
        return finish(None, transient=True)
    from .patterns import _price_patterns, price_patterns_core

    cols_arr = np.unique(np.asarray(cols, np.int64))
    iter_cost = 0.02
    while not pool.converged:
        now = time.perf_counter()
        if deadline is not None and now + iter_cost > deadline:
            break
        t_it = now
        duals = np.zeros(G)
        n_cov = active.size
        marg = np.asarray(res.ineqlin.marginals)
        duals[active] = marg[:n_cov] * -1.0
        mu = np.maximum(marg[n_cov:] * -1.0, 0.0)  # [C]
        fresh = 0
        # price option patterns (same machinery as patterns.py)
        K = _price_patterns(problem, cols_arr, duals)
        vals = K @ duals
        for oi in np.flatnonzero(vals > price[cols_arr] * (1 + 1e-6)):
            fresh += pool.add_opt(int(cols_arr[oi]), K[oi])
        # price cluster patterns: reduced cost = dual value - mu_c. The
        # greedy knapsack alone converges prematurely on mixes, so pairwise
        # level-sweeps (exact for two-group mixes at a few fill levels) run
        # alongside it — G is group-deduplicated and small, so this is cheap.
        KB = price_patterns_core(
            d, cluster_cap.copy(), cluster_compat.T, duals
        )
        bvals = KB @ duals
        for ci in np.flatnonzero(bvals > mu + 1e-9):
            fresh += pool.add_cluster(int(ci), KB[ci])
        for ci, k in _price_pair_patterns(
            problem, cluster_cap, duals, mu, cluster_compat.T, active
        ):
            fresh += pool.add_cluster(ci, k)
        if fresh == 0:
            pool.converged = True
            break
        res2, n_opt = _solve_joint_master(pool, price, rem, active, sizes)
        if res2.status != 0:
            return finish(None, transient=True)
        res = res2
        iter_cost = max(iter_cost * 0.5, time.perf_counter() - t_it)

    if res.fun >= incumbent_cost * 0.999:
        # the joint master can't meaningfully undercut the incumbent —
        # rounding adds ~0.1-0.3% back, so a better integer plan is out of
        # reach. Cache the verdict: steady state pays this build exactly
        # once. (Measured on the 20k-repack config the sequential pipeline
        # is already within ~0.03% of the converged joint master — see
        # bounds.best_lower_bound's looseness note.)
        return finish(None)

    # ---- rounding ----------------------------------------------------------
    x = np.asarray(res.x)
    y = x[:n_opt]
    w = x[n_opt:]
    # cluster patterns: floor the multiplicities (sum of floors can't exceed
    # the cluster size), assign each kept pattern to a distinct member bin —
    # feasible by construction against the cluster's min capacity
    placements = np.zeros((G, E), np.int64)
    next_member = [0] * C
    order_w = np.argsort(-w)
    for q in order_w:
        n = int(np.floor(w[q] + 1e-9))
        if n <= 0:
            continue
        ci = pool.cl_ids[q]
        k = pool.cl_contents[q]
        m = members[ci]
        while n > 0 and next_member[ci] < len(m):
            placements[:, m[next_member[ci]]] = k
            next_member[ci] += 1
            n -= 1
    served_ex = placements.sum(axis=1)
    # option patterns: floor, then trim overserve vs what's left after bins
    n_int = np.floor(y + 1e-9).astype(np.int64)
    rem_new = np.maximum(rem - served_ex, 0)
    opens: List[Opened] = []
    over = -rem_new.copy()  # track served - demand
    per_option: Dict[int, List[np.ndarray]] = {}
    for (o, k), n in zip(zip(pool.opt_ids, pool.opt_contents), n_int):
        if n > 0:
            per_option.setdefault(o, []).append(np.repeat(k[:, None], n, axis=1))
    for o, blocks in per_option.items():
        ys = np.concatenate(blocks, axis=1)
        over += ys.sum(axis=1)
        opens.append(Opened(option=o, nodes=ys.shape[1], ys=ys))
    # trim option-pattern overserve down to exact counts
    overserve = np.maximum(over, 0)
    if overserve.any():
        for op in opens:
            if not overserve.any():
                break
            ys = op.placements(G).copy()
            for g in np.flatnonzero(overserve):
                if not ys[g].any():
                    continue
                row = ys[g]
                cum = np.cumsum(row)
                drop = np.minimum(row, np.maximum(0, overserve[g] - (cum - row)))
                ys[g] = row - drop
                overserve[g] -= int(drop.sum())
            keep = ys.sum(axis=0) > 0
            op.ys = ys[:, keep]
            op.mix = None
            op.nodes = int(keep.sum())
        opens = [op for op in opens if op.nodes > 0]
    # trim bin overserve too (a cluster pattern may overshoot a group's
    # count once option floors are in)
    total = placements.sum(axis=1)
    for op in opens:
        total += op.placements(G).sum(axis=1)
    bin_over = np.maximum(total - rem, 0)
    if bin_over.any():
        for e in range(E):
            if not bin_over.any():
                break
            col = placements[:, e]
            if not col.any():
                continue
            for g in np.flatnonzero(bin_over):
                take = min(int(col[g]), int(bin_over[g]))
                if take:
                    col[g] -= take
                    bin_over[g] -= take
            placements[:, e] = col
    # leftovers: crumbs the floors dropped — refill into leftover existing
    # room first, then headroom/tail via the host machinery
    total = placements.sum(axis=1)
    for op in opens:
        total += op.placements(G).sum(axis=1)
    left = (rem - total).astype(np.int64)
    if (left < 0).any():
        return finish(None)
    if left.sum() > 0:
        ex_left = ex_rem0 - placements.T.astype(np.float64) @ d
        more, left, ex_left = refill_existing(problem, left, np.maximum(ex_left, 0.0))
        placements += more
    if left.sum() > 0:
        tail_cols = np.unique(
            np.concatenate([
                np.asarray(pool.opt_ids, np.int64),
                np.unique(np.asarray(cols, np.int64)),
            ])
        ) if pool.opt_ids else np.unique(np.asarray(cols, np.int64))
        tails, left, _ = _finish_leftovers(problem, left, opens, opt_subset=tail_cols)
        opens = opens + tails
    if left.sum() > 0:
        return finish(None, transient=True)

    cost = plan_cost(problem, opens)
    entry = _RepackPlan(placements, opens, cost)
    return finish(entry)


def _deliver(entry: _RepackPlan, incumbent_cost: float):
    if entry.cost >= incumbent_cost - 1e-9:
        return None
    metrics.PATTERN_IMPROVEMENTS.inc()
    if not entry.savings_counted:
        entry.savings_counted = True
        metrics.PATTERN_SAVINGS.inc(value=incumbent_cost - entry.cost)
    # copies out: the caller's finalize path mutates placements in place
    return entry.placements.copy(), list(entry.opens), entry.cost
