"""Solution feasibility validator.

The invariant gate for every solver backend: capacity never exceeded, every
placement compatible (requirements + taints), topology spread skew respected,
anti-affinity/colocation honored. The kernel's output is validated before it is
decoded, and ``validate_bind_plan`` re-checks any backend's plan against the
cluster-level objects before the provisioning controller binds it.
"""

from __future__ import annotations

import math
import threading
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..api import labels as wk
from ..api.objects import Pod
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


# ---------------------------------------------------------------------------
# Placement validation firewall (solver fault domain, layer 1)
#
# The validators above check a plan against the ENCODED problem — which is
# exactly what a corrupted device path can no longer be trusted about
# indirectly. ``validate_bind_plan`` re-checks every placement of a
# SolveResult against the CLUSTER-LEVEL objects (pods, instance types,
# existing-node remaining capacity, daemonsets, gangs, diversification
# units, provisioner limits) with no dependence on the solve's own tensors:
# a miscompiled kernel, a torn device staging buffer, or a numerically
# degenerate answer produces a plan this function rejects, and the round
# re-solves on the next backend instead of corrupting cluster state
# (CvxCluster-style independent feasibility checking of each subproblem's
# answer; Karpenter's core likewise never binds a placement it cannot
# re-verify).
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PlanViolation:
    """One hard-constraint violation found in a solver plan pre-bind."""

    code: str  # capacity | compat | taints | double-placement | unknown-pod
    #         | unknown-node | launch-option | gang-split | slice-adjacency
    #         | diversification | launch-limits
    detail: str
    pod: str = ""
    node: str = ""

    def to_dict(self) -> Dict:
        out = {"code": self.code, "detail": self.detail}
        if self.pod:
            out["pod"] = self.pod
        if self.node:
            out["node"] = self.node
        return out


def _fully_relaxed(pod: Pod) -> Pod:
    """The pod with every sheddable PREFERENCE dropped: ``solve_pods``'
    relaxation pass legally places a pod that sheds its preferred affinity,
    so the firewall judges hard constraints only — a placement is invalid
    iff even the fully-relaxed pod is incompatible with it."""
    p = pod
    for _ in range(16):  # bounded: each clone sheds one preference
        if not p.has_relaxable_constraints():
            return p
        p = p.relaxed_clone()
    return p


def _fits_tol(total, cap) -> bool:
    """Per-axis fit under the SAME relative tolerance the count-level
    validator grants (CAP_RTOL): the kernel packs in normalized f32, so a
    plan validate_counts accepts as float noise must not be false-rejected
    here — a marginal clean round would otherwise book breaker evidence
    against a healthy executable."""
    return all(
        v <= cap.get(k) * (1 + CAP_RTOL) + 1e-6 for k, v in total.items()
    )


def _over_axes(total, cap) -> List[str]:
    return sorted(
        k for k, v in total.items() if v > cap.get(k) * (1 + CAP_RTOL) + 1e-6
    )


def _surface_ok(pod: Pod, surface, taints, memo: Dict, relaxed: Dict) -> Optional[str]:
    """None when ``pod`` may schedule onto a node with this label surface +
    taints; else the violation code. Memoized per (surface identity, taint
    CONTENT, scheduling signature) — pods of one encode group share the
    verdict. The taint component is by value, not id(): the per-node
    effective-taint tuples are ephemeral, and a recycled id must never
    serve one node's verdict for another's taints (surfaces are safe to key
    by identity — they are content-interned and long-lived)."""
    from ..api.taints import tolerates_all

    sig = pod.__dict__.get("_sched_sig")
    key = (
        id(surface),
        tuple((t.key, t.value, t.effect) for t in taints),
        sig if sig is not None else pod.meta.name,
    )
    hit = memo.get(key)
    if hit is not None:
        return hit or None
    code = ""
    if not tolerates_all(list(pod.tolerations), tuple(taints)):
        code = "taints"
    else:
        terms = pod.scheduling_requirement_terms()
        if not any(surface.compatible(t) for t in terms):
            # hard-vs-preference split: retry with every preference shed —
            # only a pod whose REQUIRED terms cannot match is a violation
            rp = relaxed.get(pod.meta.name)
            if rp is None:
                rp = relaxed[pod.meta.name] = _fully_relaxed(pod)
            if rp is pod or not any(
                surface.compatible(t) for t in rp.scheduling_requirement_terms()
            ):
                code = "compat"
    memo[key] = code
    return code or None


def _placement_groups(pods: List[Pod]) -> List[tuple]:
    """(representative, count) per scheduling-signature group — capacity
    sums cost O(groups), not O(pods)."""
    by_sig: Dict[object, list] = {}
    for p in pods:
        sig = p.__dict__.get("_sched_sig")
        key = sig if sig is not None else ("pod", p.meta.name)
        ent = by_sig.get(key)
        if ent is None:
            by_sig[key] = [p, 1]
        else:
            ent[1] += 1
    return [(rep, n) for rep, n in by_sig.values()]


def validate_bind_plan(
    solve: SolveResult,
    *,
    batch: Sequence[Pod],
    round_provs: Sequence[tuple],
    round_existing: Sequence[object] = (),
    daemonsets: Sequence[Pod] = (),
    cluster=None,
    gangs: Optional[Dict[str, object]] = None,
    check_gangs: bool = False,
    slice_topology: bool = False,
    div_units: Sequence[object] = (),
    check_diversification: bool = False,
    check_limits: bool = False,
    check_fit: bool = True,
    max_violations: int = 64,
) -> List[PlanViolation]:
    """Re-check a solver plan's placements against cluster-level hard
    constraints; empty list means the plan is safe to bind.

    Always checked: per-node resource fit (instance allocatable minus an
    INDEPENDENTLY recomputed daemonset overhead for new nodes; live
    ``remaining`` for existing nodes), per-pod requirements/labels and
    taint tolerations against the landing surface, double placement, and
    unknown pod/node/option references. ``check_gangs`` adds all-or-nothing
    atomicity (and, under ``slice_topology``, the slice-adjacency pin for
    ``required``-mode gangs); ``check_diversification`` adds the per-unit
    spot-pool caps — both meaningful only AFTER the gates ran, which is why
    they are flags, not defaults. ``check_limits`` adds provisioner launch
    limits; the provisioning cascade leaves it off because its own serial
    limit gate (``_apply_solve``) owns the limit-then-cascade semantics —
    a plan over limits there is re-solved against the next pool by design,
    not rejected as corrupt. ``check_fit=False`` skips the per-placement
    fit/compat work (the pre-bind layer re-verifying only post-gate
    invariants on an object the backend layer already cleared — gates only
    strip placements, they cannot un-fit one).
    """
    from .encode import _daemonset_overhead
    from ..api.resources import Resources

    violations: List[PlanViolation] = []

    def add(code: str, detail: str, pod: str = "", node: str = "") -> bool:
        if len(violations) < max_violations:
            violations.append(PlanViolation(code, detail, pod=pod, node=node))
        return len(violations) < max_violations

    pods_by_name: Dict[str, Pod] = {p.meta.name: p for p in batch}
    prov_names = {prov.meta.name for prov, _ in round_provs}
    compat_memo: Dict = {}
    relaxed_memo: Dict[str, Pod] = {}
    placed_count: Dict[str, int] = defaultdict(int)

    # -- new nodes ----------------------------------------------------------
    alloc_memo: Dict[int, object] = {}  # id(option) -> effective allocatable
    for idx, spec in enumerate(solve.new_nodes):
        opt = spec.option
        host = f"new-{idx}({opt.instance_type.name}/{opt.zone})"
        if check_fit and opt.provisioner.meta.name not in prov_names:
            add(
                "launch-option",
                f"spec references provisioner {opt.provisioner.meta.name!r} "
                "absent from this round",
                node=host,
            )
        members: List[Pod] = []
        for name in spec.pod_names:
            placed_count[name] += 1
            pod = pods_by_name.get(name)
            if pod is None:
                add("unknown-pod", "pod not in this batch", pod=name, node=host)
                continue
            members.append(pod)
            if not check_fit:
                continue
            code = _surface_ok(
                pod, opt.node_requirements, opt.taints, compat_memo, relaxed_memo
            )
            if code:
                add(code, f"pod cannot schedule onto {host}", pod=name, node=host)
        if not check_fit:
            continue
        eff = alloc_memo.get(id(opt))
        if eff is None:
            # independent capacity basis: raw instance allocatable minus a
            # re-derived daemonset overhead — never the encoder's alloc row
            raw = opt.instance_type.allocatable()
            ds = _daemonset_overhead(
                daemonsets, opt.node_requirements, tuple(opt.taints), raw
            )
            eff = alloc_memo[id(opt)] = raw - ds
        total = Resources(pods=len(members))
        for rep, n in _placement_groups(members):
            total = total + rep.requests * n
        if not _fits_tol(total, eff):
            add(
                "capacity",
                f"{len(members)} pods exceed allocatable on "
                f"{_over_axes(total, eff)}",
                node=host,
            )

    # -- existing nodes -----------------------------------------------------
    ex_by_name = {e.name: e for e in round_existing}
    # startup taints are ignored in scheduling simulation (the reference's
    # taint filter: a workload daemon strips them after bootstrap) — the
    # firewall judges the same EFFECTIVE taints the scheduler did, or every
    # pod landing on a freshly-bootstrapping node would false-reject
    startup_by_prov = {
        p.meta.name: {(t.key, t.value, t.effect) for t in p.startup_taints}
        for p, _ in round_provs
        if getattr(p, "startup_taints", None)
    }
    for node_name, names in solve.existing_assignments.items():
        ex = ex_by_name.get(node_name)
        if ex is None:
            add("unknown-node", "existing node absent from this round", node=node_name)
            for name in names:
                placed_count[name] += 1
            continue
        surface = None
        eff_taints: tuple = ()
        if check_fit:
            # the shared label-surface cache (labels-identity invalidated;
            # cluster.update pops it on in-place label mutation)
            from .encode import _node_surface

            surface = _node_surface(ex.node)
            eff_taints = tuple(ex.node.taints)
            startup = startup_by_prov.get(ex.node.provisioner_name() or "")
            if startup:
                eff_taints = tuple(
                    t for t in eff_taints
                    if (t.key, t.value, t.effect) not in startup
                )
        members = []
        for name in names:
            placed_count[name] += 1
            pod = pods_by_name.get(name)
            if pod is None:
                add("unknown-pod", "pod not in this batch", pod=name, node=node_name)
                continue
            members.append(pod)
            if not check_fit:
                continue
            code = _surface_ok(
                pod, surface, eff_taints, compat_memo, relaxed_memo
            )
            if code:
                add(
                    code, "pod cannot schedule onto existing node",
                    pod=name, node=node_name,
                )
        if not check_fit:
            continue
        total = Resources(pods=len(members))
        for rep, n in _placement_groups(members):
            total = total + rep.requests * n
        if not _fits_tol(total, ex.remaining):
            add(
                "capacity",
                f"{len(members)} pods exceed remaining capacity on "
                f"{_over_axes(total, ex.remaining)}",
                node=node_name,
            )

    # -- double placement ---------------------------------------------------
    for name, n in placed_count.items():
        if n > 1:
            add("double-placement", f"pod placed {n} times", pod=name)

    # -- gang atomicity + slice-adjacency pins (post-gate invariants) -------
    if check_gangs and gangs:
        from . import gang as gangmod

        for gname in sorted(gangs):
            g = gangs[gname]
            placed = [n for n in g.member_names if placed_count.get(n)]
            if placed and len(placed) < len(g.pods):
                add(
                    "gang-split",
                    f"gang {gname} placed {len(placed)}/{len(g.pods)} members "
                    "(all-or-nothing)",
                    pod=sorted(set(g.member_names) - set(placed))[0],
                )
                continue
            if (
                placed
                and slice_topology
                and gangmod.wants_slices(g)
                and gangmod.gang_adjacency_mode(g) == "required"
            ):
                domains = set()
                sliced = True
                member_set = set(g.member_names)
                for spec in solve.new_nodes:
                    if any(n in member_set for n in spec.pod_names):
                        if spec.option.slice_pod:
                            domains.add((spec.option.zone, spec.option.slice_pod))
                        else:
                            sliced = False
                for node_name, names in solve.existing_assignments.items():
                    if any(n in member_set for n in names):
                        node = (
                            cluster.nodes.get(node_name) if cluster is not None
                            else None
                        )
                        if node is not None and node.slice_pod():
                            domains.add((node.zone(), node.slice_pod()))
                        else:
                            sliced = False
                # a sliceless catalog (or mixed capacity) is the gate's own
                # inert case; only an actually-sliced multi-domain placement
                # breaks the pin
                if sliced and len(domains) > 1:
                    add(
                        "slice-adjacency",
                        f"required-adjacency gang {gname} spans "
                        f"{len(domains)} ICI domains",
                        pod=sorted(g.member_names)[0],
                    )

    # -- spot-diversification caps (post-gate invariant) --------------------
    if check_diversification and div_units:
        for unit in div_units:
            usage: Dict[tuple, int] = defaultdict(int)
            for spec in solve.new_nodes:
                if spec.option.capacity_type != wk.CAPACITY_TYPE_SPOT:
                    continue
                hit = sum(1 for n in spec.pod_names if n in unit.member_names)
                if hit:
                    usage[spec.option.pool] += hit
            if cluster is not None:
                this_round = {
                    n for spec in solve.new_nodes for n in spec.pod_names
                } | {
                    n for names in solve.existing_assignments.values()
                    for n in names
                }
                for node_name, names in solve.existing_assignments.items():
                    node = cluster.nodes.get(node_name)
                    if node is None:
                        continue
                    pool = node.capacity_pool()
                    if pool[2] != wk.CAPACITY_TYPE_SPOT:
                        continue
                    hit = sum(1 for n in names if n in unit.member_names)
                    if hit:
                        usage[pool] += hit
                # members bound by EARLIER rounds count toward the cap too
                for name in unit.member_names:
                    if name in this_round:
                        continue
                    pod = cluster.pods.get(name)
                    if pod is not None and pod.node_name is not None:
                        node = cluster.nodes.get(pod.node_name)
                        if node is not None:
                            pool = node.capacity_pool()
                            if pool[2] == wk.CAPACITY_TYPE_SPOT:
                                usage[pool] += 1
            cap_n = max(1, math.ceil(unit.max_frac * unit.size))
            for pool in sorted(usage):
                if usage[pool] > cap_n:
                    add(
                        "diversification",
                        f"unit {unit.name} holds {usage[pool]} members in spot "
                        f"pool {'/'.join(pool)} (cap {cap_n})",
                        pod=sorted(unit.member_names)[0],
                    )

    # -- provisioner launch limits ------------------------------------------
    if check_limits and cluster is not None:
        projected: Dict[str, object] = {}
        for spec in solve.new_nodes:
            prov = spec.option.provisioner
            if prov.limits is None:
                continue
            used = projected.get(prov.meta.name)
            if used is None:
                used = cluster.provisioner_usage(prov.meta.name)
            projected[prov.meta.name] = used + spec.option.instance_type.capacity
        for pname, used in projected.items():
            prov = next(
                (p for p, _ in round_provs if p.meta.name == pname), None
            )
            if prov is not None and prov.limits is not None and used.any_exceeds(
                prov.limits
            ):
                add(
                    "launch-limits",
                    f"plan projects provisioner {pname} past its limits",
                    node=pname,
                )

    return violations


# ---------------------------------------------------------------------------
# Scripted verdicts (replay determinism): a capsule that recorded a
# validation rejection came from a TRANSIENT device fault the offline
# replay cannot reproduce — the replay harness installs the recorded
# verdict sequence and the firewall consumes it in call order instead of
# recomputing, so the round's fallback decision (and every digest and
# placement downstream of it) replays byte-identically. Mirrors how
# CapsuleCloudProvider replays recorded launch failures.
# ---------------------------------------------------------------------------

_SCRIPT = threading.local()


@contextmanager
def scripted_verdicts(events: Sequence[Dict]):
    prev = getattr(_SCRIPT, "queue", None)
    _SCRIPT.queue = list(events)
    try:
        yield
    finally:
        _SCRIPT.queue = prev


def scripted_next() -> Optional[Dict]:
    """The next recorded firewall verdict, or None when no script is active
    (the live path) or the script is exhausted (the replay diverged into
    more firewall calls than the recorded round made — compute live; the
    event-list comparison will surface the divergence)."""
    queue = getattr(_SCRIPT, "queue", None)
    if not queue:
        return None
    return queue.pop(0)
