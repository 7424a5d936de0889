"""Solution feasibility validator.

The invariant gate for every solver backend: capacity never exceeded, every
placement compatible (requirements + taints), topology spread skew respected,
anti-affinity/colocation honored. The kernel's output is validated before it is
decoded; in the port a violation raises, since no greedy oracle is ported yet.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np

from ..api import labels as wk
from .encode import EncodedProblem
from .result import SolveResult


# Relative capacity tolerance: the packing kernel runs in normalized f32, so unit
# counts can overshoot true capacity by float noise (~1e-4 of a node). That is far
# inside the kubelet reserve margins; anything beyond it is a real violation.
CAP_RTOL = 5e-4


def validate(problem: EncodedProblem, result: SolveResult) -> List[str]:
    """Returns a list of violation descriptions; empty means feasible."""
    violations: List[str] = []
    pod_by_name: Dict[str, tuple] = {}
    for gi, g in enumerate(problem.groups):
        for pod in g.pods:
            pod_by_name[pod.name] = (gi, pod)

    # host -> (zone, [(gi, pod)]) for every placement
    placements: List[tuple] = []  # (host_id, zone, gi, pod)

    # -- new nodes: capacity + compat -----------------------------------
    option_index_by_id = {id(o): j for j, o in enumerate(problem.options)}
    for idx, spec in enumerate(result.new_nodes):
        j = spec.option_index
        if j is None:
            j = option_index_by_id.get(id(spec.option))
        if j is None:
            violations.append(f"new node {idx} references an unknown launch option")
            continue
        host = f"new-{idx}"
        group_counts: Dict[int, int] = defaultdict(int)
        for name in spec.pod_names:
            if name not in pod_by_name:
                violations.append(f"unknown pod {name} on {host}")
                continue
            gi, pod = pod_by_name[name]
            group_counts[gi] += 1
            placements.append((host, spec.option.zone, gi, pod))
        used = np.zeros(len(problem.resource_axes), dtype=np.float64)
        for gi, n in group_counts.items():
            if not problem.compat[gi, j]:
                violations.append(f"group {gi} incompatible with option {j} on {host}")
            used += problem.demand[gi] * n
        over = used > problem.alloc[j] * (1 + CAP_RTOL) + 1e-6
        if np.any(over):
            axes = [problem.resource_axes[k] for k in np.where(over)[0]]
            violations.append(f"{host} over capacity on {axes}")

    # -- existing nodes: remaining capacity + compat --------------------
    ex_index = {e.name: i for i, e in enumerate(problem.existing)}
    for node_name, names in result.existing_assignments.items():
        if node_name not in ex_index:
            violations.append(f"unknown existing node {node_name}")
            continue
        k = ex_index[node_name]
        group_counts = defaultdict(int)
        for name in names:
            if name not in pod_by_name:
                violations.append(f"unknown pod {name} on existing node {node_name}")
                continue
            gi, pod = pod_by_name[name]
            group_counts[gi] += 1
            placements.append((node_name, problem.existing[k].node.zone(), gi, pod))
        used = np.zeros(len(problem.resource_axes), dtype=np.float64)
        for gi, n in group_counts.items():
            if not problem.ex_compat[gi, k]:
                violations.append(f"group {gi} incompatible with existing node {node_name}")
            used += problem.demand[gi] * n
        over = used > problem.ex_rem[k] * (1 + CAP_RTOL) + 1e-6
        if np.any(over):
            axes = [problem.resource_axes[kk] for kk in np.where(over)[0]]
            violations.append(f"existing {node_name} over capacity on {axes}")

    # -- completeness ----------------------------------------------------
    placed_names = {p.name for _, _, _, p in placements}
    all_names = set(pod_by_name)
    missing = all_names - placed_names - set(result.unschedulable)
    if missing:
        violations.append(f"{len(missing)} pods neither placed nor reported unschedulable")
    double = [n for n, c in _count_names(result).items() if c > 1]
    if double:
        violations.append(f"pods placed more than once: {double[:5]}")

    # -- topology spread / anti-affinity / colocation --------------------
    # Selector matching depends only on group labels, so aggregate placements to
    # (group, host, zone) counts once and evaluate constraints at group level.
    agg: Dict[tuple, int] = defaultdict(int)  # (gi, host, zone) -> count
    for host, zone, gi, _ in placements:
        agg[(gi, host, zone or "")] += 1
    violations.extend(check_topology(problem, agg))
    return violations


def check_topology(problem: EncodedProblem, agg: Dict[tuple, int]) -> List[str]:
    """Topology constraint checks over (group, host, zone) -> count aggregates.

    Shared by the name-level validator above and the count-level kernel-path
    validator below; selector matching only depends on group labels, so the
    aggregate view is exact. Pods already bound in the cluster
    (``problem.seed_pods``) count toward every domain — a placement that only
    looks balanced against the in-batch pods is still a violation if the
    cluster's existing occupancy tips the skew."""
    violations: List[str] = []
    reps = [g.pods[0] for g in problem.groups]
    seed_pods = problem.seed_pods or []
    # Per-problem memo: seed scans are O(bound pods) with a Python selector
    # call each — compute once per (constraint, axis) for the problem's
    # lifetime, not on every kernel solve (validate_counts is hot-path).
    memo = problem.__dict__.setdefault("_seed_count_memo", {})

    def seed_counts(owner, selects, key_is_host: bool, tag: str = "") -> Dict[str, int]:
        key = (id(owner), key_is_host, tag)
        cached = memo.get(key)
        if cached is not None:
            return cached
        out: Dict[str, int] = defaultdict(int)
        for host, zone, p in seed_pods:
            if selects(p):
                out[host if key_is_host else zone] += 1
        memo[key] = out
        return out

    for gi, g in enumerate(problem.groups):
        rep = reps[gi]
        for c in rep.effective_spread():
            # the skew counts selector-matching pods of groups that THEMSELVES
            # carry an equivalent constraint (plus bound pods): a non-carrying
            # matching service is only admission-checked at ITS OWN placements
            # (k8s enforces spread at the carrying pod's admission), so its
            # in-batch pods cannot retroactively violate this group's skew
            selected_groups = [
                gj
                for gj, r in enumerate(reps)
                if c.selects(r)
                and (
                    gj == gi
                    or any(
                        c2.topology_key == c.topology_key
                        and dict(c2.label_selector) == dict(c.label_selector)
                        for c2 in r.effective_spread()
                    )
                )
            ]
            new_counts: Dict[str, int] = defaultdict(int)
            for (gj, host, zone), n in agg.items():
                if gj in selected_groups:
                    key = host if c.topology_key == wk.HOSTNAME else zone
                    new_counts[key] += n
            counts: Dict[str, int] = defaultdict(int, new_counts)
            if seed_pods:
                for key, n in seed_counts(c, c.selects, c.topology_key == wk.HOSTNAME).items():
                    counts[key] += n
            # Only domains receiving new pods OF THE CONSTRAINT CARRIER can
            # violate: k8s enforces a spread at the carrying pod's admission
            # only — a non-carrying matching service legally piling into some
            # other domain afterwards is not this group's violation. Counts
            # still include every selector-matching pod (the cross-group
            # semantics); pre-existing seed skew is likewise not fixable by a
            # scale-up batch.
            own_domains = {
                (host if c.topology_key == wk.HOSTNAME else zone)
                for (gj, host, zone), n in agg.items()
                if gj == gi and n > 0
            }
            if own_domains:
                if c.topology_key == wk.HOSTNAME:
                    worst = max(counts[k] for k in own_domains)
                    if worst > c.max_skew:
                        violations.append(
                            f"group {gi} hostname spread skew {worst} > {c.max_skew}"
                        )
                if c.topology_key == wk.ZONE:
                    floor_ = min([counts.get(z, 0) for z in problem.zones] or [0])
                    worst = max(counts[k] for k in own_domains)
                    if worst - floor_ > c.max_skew:
                        violations.append(
                            f"group {gi} zone spread skew {worst - floor_} > {c.max_skew}"
                        )
        for term in rep.affinity_terms:
            my_domains = {
                (host if term.topology_key == wk.HOSTNAME else zone)
                for (gj, host, zone), n in agg.items()
                if gj == gi and n > 0
            }
            key_is_host = term.topology_key == wk.HOSTNAME
            cross_groups = [
                gj for gj, r in enumerate(reps) if gj != gi and term.selects(r)
            ]
            # domains holding pods the selector matches, excluding gi's own
            # (the self-match cases have their own checks below)
            cross_domains: Dict[str, int] = defaultdict(int)
            for (gj, host, zone), n in agg.items():
                if gj in cross_groups:
                    cross_domains[host if key_is_host else zone] += n
            if seed_pods:
                for key, n in seed_counts(term, term.selects, key_is_host).items():
                    cross_domains[key] += n
            if term.anti:
                # cross-group / seeded anti-affinity is symmetric: no domain
                # may hold both gi's pods and selector-matching pods
                bad = my_domains & {k for k, n in cross_domains.items() if n > 0}
                if bad:
                    violations.append(
                        f"group {gi} anti-affinity shares {sorted(bad)[:3]} with matching pods"
                    )
                if seed_pods and cross_groups:
                    # ...including domains where a BOUND pod carries this term
                    # (k8s admission symmetry): matching groups may not join
                    from .encode import equivalent_affinity_term

                    owner_seeded = seed_counts(
                        term,
                        lambda p: equivalent_affinity_term(term, p),
                        key_is_host,
                        tag="owner",
                    )
                    cross_new = {
                        (host if key_is_host else zone)
                        for (gj, host, zone), n in agg.items()
                        if gj in cross_groups and n > 0
                    }
                    bad2 = cross_new & {k for k, n in owner_seeded.items() if n > 0}
                    if bad2:
                        violations.append(
                            f"matching pods joined anti-affinity domains {sorted(bad2)[:3]} of group {gi}"
                        )
                if term.selects(rep):
                    domain_counts: Dict[str, int] = defaultdict(int)
                    for (gj, host, zone), n in agg.items():
                        if gj == gi:
                            key = host if key_is_host else zone
                            domain_counts[key] += n
                    if seed_pods:
                        for key, n in seed_counts(term, term.selects, key_is_host).items():
                            domain_counts[key] += n
                    for key, n in domain_counts.items():
                        if n > 1:
                            violations.append(f"group {gi} anti-affinity violated in {key}")
            elif term.selects(rep):
                if len(my_domains) > 1:
                    violations.append(
                        f"group {gi} required self-affinity split across {len(my_domains)}"
                    )
                elif seed_pods and my_domains:
                    seeded = set(seed_counts(term, term.selects, key_is_host))
                    if seeded and not my_domains <= seeded:
                        violations.append(
                            f"group {gi} required self-affinity outside the existing domain"
                        )
            else:
                # cross-group REQUIRED affinity: every domain receiving gi's
                # pods must hold a selector-matching pod. Vacuous when nothing
                # matches anywhere (the k8s bootstrap rule).
                if any(n > 0 for n in cross_domains.values()):
                    bare = my_domains - {
                        k for k, n in cross_domains.items() if n > 0
                    }
                    if bare:
                        violations.append(
                            f"group {gi} required affinity unmet in {sorted(bare)[:3]}"
                        )
    return violations


def validate_counts(
    problem: EncodedProblem,
    order: np.ndarray,
    new_opt: np.ndarray,
    new_active: np.ndarray,
    ys: np.ndarray,
) -> List[str]:
    """Count-level feasibility gate for the kernel's raw output — the same
    invariants as ``validate`` (capacity, compat, completeness, topology)
    checked on the [T, E+S] assignment-count matrix before any name decode.
    Name expansion of 10k+ pods costs more than the solve's device round-trip;
    the decode is a deterministic slicing of these counts (the name-level
    validator cross-checks it in tests)."""
    violations: List[str] = []
    G, E = problem.G, problem.E
    # ys columns are [existing (padded to s_ex) | new]; infer the split
    Ep = ys.shape[1] - new_opt.shape[0]
    T = ys.shape[0]
    d = problem.demand.astype(np.float64)

    # counts[g, slot]: scan rows mapped back to group ids (padding rows dropped)
    gidx = np.asarray(order[:T], dtype=np.int64)
    real = gidx < G
    counts = np.zeros((G, ys.shape[1]), np.int64)
    np.add.at(counts, gidx[real], ys[real])

    placed = counts.sum(axis=1)
    if np.any(placed > problem.count):
        violations.append("group placed more pods than demanded")
    if np.any(counts[:, E:Ep]):
        # existing-slot PADDING columns (E..Ep pow2 pad, or the single E==0
        # column): pods assigned there have no node — decode skips the
        # column and reports them unschedulable, so a kernel placing there
        # is emitting an invalid plan (ex_valid should have masked it)
        violations.append("pods assigned to an existing-node padding slot")

    # existing nodes: remaining capacity + compat
    if E:
        ex_counts = counts[:, :E]
        used = ex_counts.T.astype(np.float64) @ d  # [E, R]
        if np.any(used > problem.ex_rem * (1 + CAP_RTOL) + 1e-6):
            violations.append("existing node over remaining capacity")
        if np.any(ex_counts[~problem.ex_compat.astype(bool)] != 0):
            violations.append("incompatible placement on existing node")

    # new slots: capacity + compat against each slot's option
    new_counts = counts[:, Ep:]
    active = np.asarray(new_active, bool) & (new_counts.sum(axis=0) > 0)
    if np.any(new_counts[:, ~np.asarray(new_active, bool)] != 0):
        violations.append("pods assigned to an inactive slot")
    if np.any(active):
        raw_opts = np.asarray(new_opt, np.int64)[active]
        if np.any((raw_opts < 0) | (raw_opts >= problem.O)):
            violations.append("active slot references an unknown launch option")
            return violations
        opts = raw_opts
        load = new_counts[:, active].T.astype(np.float64) @ d  # [S', R]
        if np.any(load > problem.alloc[opts] * (1 + CAP_RTOL) + 1e-6):
            violations.append("new node over capacity")
        if np.any((new_counts[:, active] > 0) & ~problem.compat[:, opts]):
            violations.append("incompatible group on new node")

    # topology aggregates without name expansion
    agg: Dict[tuple, int] = {}
    gs, ss = np.nonzero(counts)
    for g, s in zip(gs.tolist(), ss.tolist()):
        if s < Ep:
            if s >= E:
                continue
            host = problem.existing[s].name
            zone = problem.existing[s].node.zone() or ""
        else:
            host = f"new-{s - Ep}"
            j = int(new_opt[s - Ep])
            zone = problem.options[j].zone if 0 <= j < problem.O else ""
        agg[(g, host, zone)] = int(counts[g, s])
    violations.extend(check_topology(problem, agg))
    return violations


def _count_names(result: SolveResult) -> Dict[str, int]:
    counts: Dict[str, int] = defaultdict(int)
    for spec in result.new_nodes:
        for n in spec.pod_names:
            counts[n] += 1
    for names in result.existing_assignments.values():
        for n in names:
            counts[n] += 1
    return counts
