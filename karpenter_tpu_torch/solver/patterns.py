"""Pattern-based column generation: the integrality-gap closer for LP-safe solves.

The assignment LP (``host.lp_solve``) prices FRACTIONAL pod->option flows, so
its optimum assumes every node can be packed perfectly. Real nodes hold whole
pods, and the rounding loss concentrates where pod demand vectors don't tile a
node's allocatable vector (a 2.0-cpu pod pair on a 3.92-cpu node strands 0.42
cpu per node, thousands of times). ``lp_round``+``ruin_recreate`` recover part
of that, plateauing ~3.5% above the LP bound on the 50k north-star mix.

This module attacks the gap with the classic cutting-stock formulation: columns
are integer NODE PATTERNS (how many pods of each group one node of one launch
option hosts), the master LP picks pattern multiplicities covering demand at
minimum price, and new patterns are priced in by a dual-guided greedy knapsack
per option (vectorized across options). Because pattern columns are integer by
construction, flooring the master's solution loses only O(#patterns) pods —
repaired by the same tail machinery the LP path uses — instead of a per-node
epsilon times thousands of nodes. Measured on the 50k config: 0.9625 -> 0.972
efficiency vs the assignment-LP bound.

The reference has no analogue (its scheduler is a single-pass first-fit,
upstream ``designs/bin-packing.md:16-43``); this is capability the
framework adds on top of parity, and it must stay inside the solve's latency
budget: the CG loop is deadline-aware, and the learned pattern pool is cached
per problem content so warm re-solves skip straight to a converged master.
"""

from __future__ import annotations

import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import metrics
from .encode import EncodedProblem
from .host import Opened, _finish_leftovers, _fit_rows, plan_cost

try:  # pragma: no cover - scipy is baked into the image
    from scipy.optimize import linprog

    _HAVE_SCIPY = True
except Exception:  # pragma: no cover
    _HAVE_SCIPY = False


# Pool cache: warm re-solves of the same problem reuse the learned columns
# (warm-start CG) instead of re-pricing from scratch. Bounded FIFO with room
# for a FEW problems — a reconcile loop alternating two stable pools must not
# thrash each other's pools and re-pay the warmup spike every solve. Entries
# pin their problem; the bound keeps that to a handful of encodes.
_POOL_CACHE_MAX = 4
_pool_cache: Dict[int, tuple] = {}


def _count_improvement(savings: float, pool: "Optional[_Pool]" = None) -> None:
    """Metric semantics (the reference's): PATTERN_IMPROVEMENTS counts every
    solve that hands back a pattern-improved plan (cached or computed — the
    delivery rate); PATTERN_SAVINGS counts each problem's dollar delta ONCE,
    on first delivery, so a steady-state reconcile loop replaying the cached
    plan doesn't scale the cumulative-dollars metric with reconcile
    frequency."""
    metrics.PATTERN_IMPROVEMENTS.inc()
    if pool is None or not pool.savings_counted:
        metrics.PATTERN_SAVINGS.inc(value=savings)
        if pool is not None:
            pool.savings_counted = True


def _cache_put(cache: Dict[int, tuple], key: int, value: tuple, cap: int) -> None:
    if key not in cache and len(cache) >= cap:
        try:
            cache.pop(next(iter(cache)))
        except (StopIteration, KeyError, RuntimeError):
            pass  # concurrent evictor/mutator got there first
    cache[key] = value

# Problems seen once: CG only engages from the SECOND solve of the same
# problem — a one-shot solve (consolidation trial, cold batch) must not pay
# pricing cycles it can never amortize. Weak values: a dead problem's entry
# vanishes, so a recycled id() can never masquerade as previously seen.
_seen_problems: "weakref.WeakValueDictionary[int, EncodedProblem]" = (
    weakref.WeakValueDictionary()
)


def _group_sigs(problem: EncodedProblem) -> List[tuple]:
    """Per-group content signature: (demand row, compat row) bytes. Two groups
    with equal signatures pack identically on any node of any option, so
    learned patterns transfer between them across problems."""
    sigs = problem.__dict__.get("_group_sigs")
    if sigs is None:
        d = np.ascontiguousarray(problem.demand)
        c = np.ascontiguousarray(problem.compat)
        sigs = [(d[g].tobytes(), c[g].tobytes()) for g in range(problem.G)]
        problem.__dict__["_group_sigs"] = sigs
    return sigs


def _options_digest(problem: EncodedProblem) -> bytes:
    """Digest of the option table as the pattern machinery sees it (alloc,
    price, zone). Pools only transfer between problems whose option tables
    are bit-identical — pattern feasibility is per-option capacity."""
    dig = problem.__dict__.get("_opts_digest")
    if dig is None:
        import hashlib

        h = hashlib.sha256()
        h.update(np.ascontiguousarray(problem.alloc).tobytes())
        h.update(np.ascontiguousarray(problem.price).tobytes())
        h.update(np.ascontiguousarray(problem.opt_zone).tobytes())
        dig = h.digest()
        problem.__dict__["_opts_digest"] = dig
    return dig


def similar_warm_start(
    problem: EncodedProblem,
    rem: np.ndarray,
    deadline: Optional[float] = None,
    min_matched_frac: float = 0.85,
):
    """Cold-solve fast path: reuse a content-SIMILAR problem's learned pattern
    pool. A steady-state cluster's fresh batches are
    near-copies of the last batch — same option table, mostly the same pod
    groups, a few pods added/removed — but they encode to NEW problem objects
    that identity-keyed learning can't see. This remaps a cached pool's
    pattern contents onto the new problem's groups (matched by group
    signature), solves the pattern master LP over the remapped columns, and
    rounds — skipping the assignment-LP pipeline entirely, at the converged
    pool's efficiency instead of the cold pipeline's.

    Returns ``(opens, cost, cols, master_fun, leftover)`` with leftover == 0
    (``_round_pool`` guarantees exact coverage or refuses), or None when no
    cached pool is similar enough. The remapped pool is cached under the new
    problem so subsequent solves refine it by normal CG. Every returned plan
    still passes ``solve_host``'s ``_check_counts`` gate."""
    if not _HAVE_SCIPY or problem.G == 0:
        return None
    active = np.flatnonzero(rem > 0)
    if active.size == 0:
        return None
    if deadline is not None and time.perf_counter() >= deadline:
        return None
    key = id(problem)
    my_dig = None
    my_sigs = None
    donor_pool = None
    for ent_key, (old_problem, old_pool) in list(_pool_cache.items()):
        if ent_key == key or old_problem is problem:
            continue  # identity hits are pattern_improve's job
        if not old_pool.contents:
            continue
        if my_dig is None:
            my_dig = _options_digest(problem)
        if _options_digest(old_problem) != my_dig:
            continue
        # remap old group indices -> new by signature, ONE-TO-ONE: two new
        # groups sharing a signature must not both claim the same donor
        # group, or every remapped pattern would double that content and
        # overshoot node capacity (caught by _check_counts, but the poisoned
        # pool would be banked). Duplicate-signature groups pack identically,
        # so which one gets the donor is immaterial; the others fall through
        # to the singleton-pattern seeding below.
        if my_sigs is None:
            my_sigs = _group_sigs(problem)
        old_index: Dict[tuple, List[int]] = {}
        for i, s in enumerate(_group_sigs(old_problem)):
            old_index.setdefault(s, []).append(i)
        mapping = np.full(problem.G, -1, np.int64)
        for g, s in enumerate(my_sigs):
            cands = old_index.get(s)
            if cands:
                mapping[g] = cands.pop()
        matched = mapping[active] >= 0
        total = float(rem[active].sum())
        if total <= 0 or float(rem[active[matched]].sum()) / total < min_matched_frac:
            continue
        pool = _Pool(problem.G)
        got = mapping >= 0
        for opt, content in zip(old_pool.options, old_pool.contents):
            k = np.zeros(problem.G, np.int64)
            k[got] = content[mapping[got]]
            pool.add(opt, k)
        if pool.contents:
            donor_pool = pool
            break
    if donor_pool is None:
        return None
    pool = donor_pool
    price = problem.price.astype(np.float64)
    # feasibility: every active group needs at least one covering column —
    # unmatched groups get a best-rate single-group full-node pattern.
    # Groups with NO compatible option are structurally unschedulable: they
    # leave as leftover instead of aborting the fast path (one untolerating
    # pod must not cost the rest of the batch the learned plan).
    from .host import _units_rate

    units, rate = _units_rate(problem)
    covered = pool.matrix().sum(axis=1) > 0
    impossible = np.zeros(problem.G, bool)
    for g in active:
        if covered[g]:
            continue
        finite = np.isfinite(rate[g])
        if not finite.any():
            impossible[g] = True
            continue
        j = int(np.argmin(np.where(finite, rate[g], np.inf)))
        k = np.zeros(problem.G, np.int64)
        k[g] = max(int(units[g, j]), 1)
        pool.add(j, k)
    leftover = np.where(impossible, rem, 0).astype(rem.dtype)
    rem = rem - leftover
    active = np.flatnonzero(rem > 0)
    if active.size == 0:
        return None
    res = _solve_master(pool, price, rem, active)
    if res.status != 0:
        return None
    cols = np.unique(np.asarray(pool.options, np.int64))
    # top-rate options per group joined in: the rounding tail may need
    # right-sized nodes the donor's columns don't cover
    from .host import topk_rate_options

    extra = topk_rate_options(rate, active, 8)
    cols = np.unique(np.concatenate([cols, np.asarray(sorted(extra), np.int64)]))
    rounded = _round_pool(problem, pool, np.asarray(res.x), rem, cols)
    if rounded is None:
        return None
    # bank the remapped pool for this problem: the next solve's
    # pattern_improve resumes CG from it — needs_reprice forces that CG past
    # the gap gate, whose lp_bound on warm replays is this restricted master
    # fun (it tracks the stale pool, not the true optimum)
    pool.needs_reprice = True
    _cache_put(_pool_cache, key, (problem, pool), _POOL_CACHE_MAX)
    _seen_problems[key] = problem
    opens, cost = rounded
    return opens, cost, cols, float(res.fun), leftover


class _Pool:
    """Pattern pool for one problem: parallel lists of option ids and [G]
    integer content vectors, deduplicated."""

    def __init__(self, G: int):
        self.G = G
        self.options: List[int] = []
        self.contents: List[np.ndarray] = []
        self._seen: set = set()
        self.converged = False
        # similarity-remapped pools must run at least one full CG pricing
        # cycle before the gap gate may trust their master objective
        self.needs_reprice = False
        # savings metric counted at most once per problem (see _count_improvement)
        self.savings_counted = False
        # rounded integer plan cached once CG converges: warm re-solves of the
        # same problem return it for the cost of one dict hit
        self.rounded: Optional[Tuple[List[Opened], float]] = None
        self.round_est = 0.04  # measured rounding cost, refined per call

    def add(self, option: int, k: np.ndarray) -> bool:
        if k.sum() <= 0:
            return False
        key = (int(option), k.tobytes())
        if key in self._seen:
            return False
        self._seen.add(key)
        self.options.append(int(option))
        self.contents.append(k.astype(np.int64))
        return True

    def matrix(self) -> np.ndarray:
        return np.stack(self.contents, axis=1).astype(np.float64)  # [G, P]


def _seed_pool(problem: EncodedProblem, opens: Sequence[Opened]) -> _Pool:
    """Seed with the incumbent solution's distinct node mixes: the master LP
    starts at <= the incumbent's cost, so CG can only improve on it."""
    pool = _Pool(problem.G)
    for op in opens:
        ys = op.placements(problem.G)
        for k in np.unique(ys.T, axis=0):
            pool.add(op.option, k)
    return pool


def _price_patterns(
    problem: EncodedProblem,
    cols: np.ndarray,
    duals: np.ndarray,
    max_steps: int = 48,
) -> np.ndarray:
    """Dual-guided greedy knapsack, vectorized over the candidate options:
    each step every option adds a bulk of the group with the best dual value
    per unit of its (dynamically) scarcest remaining resource. Returns
    [len(cols), G] integer contents."""
    return price_patterns_core(
        problem.demand.astype(np.float64),
        problem.alloc.astype(np.float64)[cols].copy(),
        problem.compat[:, cols].T,
        duals,
        max_steps,
    )


def price_patterns_core(
    d: np.ndarray,
    a: np.ndarray,
    compat: np.ndarray,
    duals: np.ndarray,
    max_steps: int = 48,
) -> np.ndarray:
    """The knapsack body, shared with repack.py's bin-cluster pricing:
    capacity rows ``a`` [N, R] and ``compat`` [N, G] can be launch options or
    existing-bin clusters — the pricing mathematics is identical."""
    O, G = compat.shape
    k = np.zeros((O, G), np.int64)
    live = np.ones(O, bool)
    pos = duals > 0
    for _ in range(max_steps):
        fits = np.all(d[None, :, :] <= a[:, None, :] + 1e-12, axis=2)
        fits &= compat & pos[None, :]
        live &= fits.any(axis=1)
        if not live.any():
            break
        scale = np.maximum(a, 1e-9)
        load_frac = np.max(d[None, :, :] / scale[:, None, :], axis=2)  # [O, G]
        w = np.where(fits, duals[None, :] / np.maximum(load_frac, 1e-9), -1.0)
        g_star = np.argmax(w, axis=1)  # [O]
        ok = live & (np.take_along_axis(w, g_star[:, None], 1)[:, 0] > 0)
        if not ok.any():
            break
        dsel = d[g_star]  # [O, R]
        with np.errstate(divide="ignore", invalid="ignore"):
            m = np.min(
                np.where(dsel > 0, a / np.maximum(dsel, 1e-30), np.inf), axis=1
            )
        m = np.where(np.isfinite(m), np.floor(m + 1e-9), 0)
        # bulk a quarter of what fits: geometric fill keeps steps ~log while
        # leaving room for the weight ranking to re-mix as capacity shrinks
        m = (np.maximum(1, m // 4) * ok).astype(np.int64)
        np.add.at(k, (np.arange(O), g_star), m)
        a -= dsel * m[:, None]
        live &= m > 0
    return k


def _solve_master(pool: _Pool, price: np.ndarray, rem: np.ndarray, active: np.ndarray):
    A = pool.matrix()
    c = np.array([price[o] for o in pool.options])
    return linprog(
        c,
        A_ub=-A[active],
        b_ub=-rem[active].astype(np.float64),
        bounds=[(0.0, None)] * len(pool.options),
        method="highs",
    )


def _round_pool(
    problem: EncodedProblem,
    pool: _Pool,
    x: np.ndarray,
    rem: np.ndarray,
    cols: np.ndarray,
) -> Optional[Tuple[List[Opened], float]]:
    """Floor the master solution, peel redundant nodes, trim per-node contents
    to EXACT demand, and tail-pack the remainder. Counts must balance exactly
    — the host path's _check_counts requires total + leftover == count."""
    price = problem.price.astype(np.float64)
    n_int = np.floor(x + 1e-9).astype(np.int64)
    K = pool.matrix().astype(np.int64)  # [G, P]
    served = K @ n_int

    # peel: most expensive columns first, drop whole nodes while coverage holds
    order = np.argsort(-price[np.asarray(pool.options)])
    for j in order:
        while n_int[j] > 0 and np.all(served - K[:, j] >= np.minimum(rem, served)):
            served -= K[:, j]
            n_int[j] -= 1

    # materialize per-node contents, then trim overserve down to exact counts
    per_option: Dict[int, List[np.ndarray]] = {}
    for (o, k), n in zip(zip(pool.options, pool.contents), n_int):
        if n > 0:
            per_option.setdefault(o, []).append(np.repeat(k[:, None], n, axis=1))
    over = np.maximum(served - rem, 0).astype(np.int64)
    opens: List[Opened] = []
    for o, blocks in per_option.items():
        ys = np.concatenate(blocks, axis=1)
        if over.any():
            for g in np.flatnonzero(over):
                if over[g] == 0 or not ys[g].any():
                    continue
                row = ys[g]
                cum = np.cumsum(row)
                drop = np.minimum(row, np.maximum(0, over[g] - (cum - row)))
                ys[g] = row - drop
                over[g] -= int(drop.sum())
        keep = ys.sum(axis=0) > 0
        ys = ys[:, keep]
        if ys.shape[1]:
            opens.append(Opened(option=o, nodes=ys.shape[1], ys=ys))
    if over.any():  # exactness unreachable — refuse rather than miscount
        return None

    # leftover from the trimmed opens, exactly
    placed = np.zeros(problem.G, np.int64)
    for op in opens:
        placed += op.placements(problem.G).sum(axis=1)
    left = (rem - placed).astype(np.int64)
    if (left < 0).any():
        return None
    if left.sum() > 0:
        tails, left, _ = _finish_leftovers(problem, left, opens, opt_subset=cols)
        opens = opens + tails
        if left.sum() > 0:
            return None
    cost = plan_cost(problem, opens)
    return opens, cost


def pattern_improve(
    problem: EncodedProblem,
    rem: np.ndarray,
    incumbent: Sequence[Opened],
    incumbent_cost: float,
    cols: Sequence[int],
    lp_bound: float,
    deadline: Optional[float] = None,
    min_pods: int = 4000,
    gap_threshold: float = 1.012,
    spike_s: float = 1.5,
) -> Optional[Tuple[List[Opened], float]]:
    """Improve the incumbent open-node plan by pattern CG, within ``deadline``.

    Returns (opens, cost) strictly cheaper than ``incumbent_cost``, or None.
    Gated: only worth the master/pricing cycles when the demand is large and
    the incumbent sits measurably above the LP bound — EXCEPT when the pool
    came from a similarity remap (``needs_reprice``): its master objective is
    a restricted bound that tracks the stale pool, not the true LP optimum,
    so the gap gate would permanently mask drift-induced inefficiency."""
    if not _HAVE_SCIPY or not incumbent:
        return None
    key = id(problem)
    cached = _pool_cache.get(key)
    if cached is not None and cached[0] is not problem:
        cached = None
    reprice = cached is not None and getattr(cached[1], "needs_reprice", False)
    if rem.sum() < min_pods:
        return None
    if incumbent_cost <= lp_bound * gap_threshold and not reprice:
        return None
    now = time.perf_counter()
    if deadline is not None and now >= deadline:
        return None

    price = problem.price.astype(np.float64)
    active = np.flatnonzero(rem > 0)
    if active.size == 0:
        return None
    cols = np.unique(np.asarray(cols, np.int64))

    if cached is not None:
        pool = cached[1]
        if pool.converged and pool.rounded is not None:
            opens, cost = pool.rounded
            if cost < incumbent_cost - 1e-9:
                _count_improvement(incumbent_cost - cost, pool)
                return opens, cost
            return None
    else:
        if _seen_problems.get(key) is not problem:
            _seen_problems[key] = problem  # first sight: free, no CG yet
            return None
        pool = _seed_pool(problem, incumbent)
        _cache_put(_pool_cache, key, (problem, pool), _POOL_CACHE_MAX)
        # One-time converge budget: the first banking solve of a repeated
        # problem may exceed the per-solve deadline (bounded), the way the
        # first solve pays jit compile — every subsequent solve then returns
        # the converged, rounded plan in ~ms. Steady-state latency is the
        # contract; a single bounded warmup spike is not. The flag lets the
        # caller extend its own polish deadline the same one time.
        spike = min(0.25, float(spike_s))
        if deadline is not None and spike > 0:
            deadline = max(deadline, time.perf_counter() + spike)
            problem.__dict__["_patterns_warmup_solve"] = True

    res = _solve_master(pool, price, rem, active)
    if res.status != 0:
        return None
    iter_cost = 0.020  # first-iteration estimate; refined by measurement
    while not pool.converged:
        now = time.perf_counter()
        # iterations bank columns in the pool even when no time remains to
        # round this solve — the next solve of the same problem resumes from
        # them, so warmup converges across calls under a tight budget
        if deadline is not None and now + iter_cost > deadline:
            break
        t_it = now
        duals = np.zeros(problem.G)
        duals[active] = -np.asarray(res.ineqlin.marginals)
        K = _price_patterns(problem, cols, duals)
        vals = K @ duals
        fresh = 0
        for oi in np.flatnonzero(vals > price[cols] * (1 + 1e-6)):
            fresh += pool.add(int(cols[oi]), K[oi])
        if fresh == 0:
            pool.converged = True
            pool.needs_reprice = False  # pricing ran dry: master fun is honest now
            break
        pool.rounded = None  # new columns supersede any cached rounding
        res2 = _solve_master(pool, price, rem, active)
        if res2.status != 0:
            # res is now STALE relative to the grown pool (x shorter than the
            # column set) — rounding it would shape-mismatch; bail this solve,
            # the banked columns retry on the next one
            return None
        res = res2
        iter_cost = max(iter_cost * 0.5, time.perf_counter() - t_it)

    if res.fun >= incumbent_cost * 0.997:
        # rounding costs real time and adds ~0.1-0.3% over the master's
        # objective — a master that isn't meaningfully below the incumbent
        # cannot produce a strictly better integer plan, so don't try
        return None
    if deadline is not None and time.perf_counter() + pool.round_est > deadline:
        return None  # columns are banked; round on a later solve's budget
    t_round = time.perf_counter()
    rounded = _round_pool(problem, pool, np.asarray(res.x), rem, cols)
    pool.round_est = max(0.01, time.perf_counter() - t_round)
    if rounded is None:
        return None
    if pool.converged:
        pool.rounded = rounded
    opens, cost = rounded
    if cost < incumbent_cost - 1e-9:
        _count_improvement(incumbent_cost - cost, pool)
        return opens, cost
    return None
