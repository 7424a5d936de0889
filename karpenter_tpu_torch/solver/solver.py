"""Solver backends behind one interface.

``TorchSolver`` is the port's counterpart of the JAX package's ``TPUSolver``:
pad the encoded problem onto its bucket lattice, keep its tensors resident
on the device through a ``DeviceStager``, run the fused two-phase portfolio
solve (``torch_solver.pack_solve_fused``: four kernel launches on the card,
their plain PyTorch versions on the CPU), and race it against the host
paths (``host``, ``host_pack``, ``topo``, ``patterns``, ``repack``) with the
reference's dispatch policy: the cheaper validated answer wins. Shapes the
tensor path cannot express are answered by ``GreedySolver``.

Two differences from the reference are deliberate. A card solver loads its
kernel library when it is constructed, and the host competitors load with
this module, so every bucket and host path is warm from the first solve.
And a launch or build error of the port's own kernels raises:
it is a fault of the program, not device evidence for the breaker to book
while a host answer hides it.

The device-fault seams are the reference's (``utils/faults.py``): a
scripted dispatch hang, device OOM, NaN or garbage result, staging
corruption or compile failure becomes breaker evidence of a named kind and
a host answer, never a binding. Only the injected ``InjectedDeviceError``
is caught. The port compiles nothing per shape, so the compile seam is
consulted where the reference compiles: at a bucket's first dispatch, when
``AOT_CACHE`` has no entry for it (``KernelBreakerBoard.first_dispatch``).

The race admits a dispatch as the reference does, on the bucket's measured
dispatch latency (``AOT_CACHE``, the live half of the reference's
``AOTCache``), or on the device round trip while the bucket has none.

``stage_fleet`` is the sharded round's fleet dispatch: the dirty cells'
problems, each with the solver that will solve it, are grouped by bucket
and each chunk is solved in one batched call (``pack_solve_fleet``); each
cell's ``solve`` then polls its row in its race.

The multi-device tier is the reference's: a ``TorchSolver`` with a mesh
(``parallel.mesh``) solves over its shards (``pack_solve_meshed``), the 1D
portfolio mesh splitting the members, the 2D options x fleet mesh the option
columns and, in ``stage_fleet``'s superproblem mode, the batch rows.
``auto_mesh`` builds a mesh only from two cards up, so one card keeps the
meshless path; a mesh of logical shards of one card is passed explicitly.

``Solver.solve_pods`` is what a controller calls: encode (through an
``EncodeSession`` when one is given), intern the problem by content
(``problem_digest``), solve, then re-solve with relaxed preferences and
with the weight gate dropped while pods stay unschedulable.
``encode_for_staging`` and ``TorchSolver.solve_fleet`` are the sharded
controller's flow: every cell is encoded first, the fleet is staged, then
each cell is solved.
"""

from __future__ import annotations

import abc
import dataclasses
import hashlib
import math
import threading
import time
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..api.objects import Pod, Provisioner
from ..cloudprovider.types import InstanceType
from ..native import load_encoder
from ..utils import faults, metrics, profiling
from ..utils.resilience import BreakerSet
# the cheap per-axis bound for the hot path; the tight LP bound lives in bounds.py
from .bounds import fractional_lower_bound as lower_bound
from .encode import EncodedProblem, ExistingNode, _provisioner_sig, encode, sizing_demand
from .greedy import GreedyPacker
# the host competitors load with the solver, not at a first solve: their
# scipy import takes seconds, which no solve's budget can pay
from .host import solve_host
from .host_pack import host_pack, host_shared
from .result import NameSlice, NewNodeSpec, SolveResult
from .staging import DeviceStager, fleet_stack
from .topo import topo_improve
from .torch_solver import (
    AOT_CACHE,
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
    pack_solve_meshed,
    rtt_probe,
    unpack_solve_fused,
)
from .validate import validate_counts

_MEMBER_LEAVES = ("orders", "alphas", "looks", "rsvs", "swaps")


def _next_pow2(n: int, floor: int = 8) -> int:
    return max(floor, 1 << (max(n, 1) - 1).bit_length())


def _observe_phase(problem: EncodedProblem, phase: str, seconds: float) -> None:
    """Solver phase histogram sample, labeled with the round's encode mode
    (stamped by EncodeSession / solve_pods; plain full encodes default) —
    karpenter_tpu_solve_phase_seconds{phase,mode}."""
    mode = problem.__dict__.get("_encode_mode", "full")
    profiling.note_phase(phase, mode, seconds)
    metrics.SOLVE_PHASE.observe(
        seconds,
        {"phase": phase, "mode": mode},
    )


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


# ---------------------------------------------------------------------------
# Problem identity
# ---------------------------------------------------------------------------

_options_blob_cache: dict = {}  # id(options) -> (pin, provisioner sigs, blob)


def _options_digest_blob(options) -> bytes:
    """The digest's option-identity section (per-option identity lines plus
    the full provisioner signatures), rendered once per option LIST — the
    options builder returns the same list object until inputs change, and a
    changed provisioner spec changes its resource_version and thus rebuilds
    the list, so identity + the embedded provisioner-sig pins cover content."""
    seen_prov: dict = {}
    for o in options:
        seen_prov.setdefault(id(o.provisioner), o.provisioner)
    prov_sigs = tuple(_provisioner_sig(p) for p in seen_prov.values())
    e = _options_blob_cache.get(id(options))
    if e is not None and e[0] is options and e[1] == prov_sigs:
        return e[2]
    parts = []
    for o in options:
        # slice identity is SPARSE in the digest line: two options differing
        # only in ICI coordinates have identical compat/price rows, so the
        # array bytes alone cannot tell their orderings apart — but a
        # sliceless catalog's lines (the pre-topology world) stay unchanged
        line = f"{o.instance_type.name}\x1f{o.zone}\x1f{o.capacity_type}\x1f{o.provisioner.name}"
        if o.slice_pod:
            line += f"\x1f{o.slice_pod}\x1f{o.slice_coord}"
        parts.append(line + "\x1e")
    for sig in prov_sigs:
        parts.append(repr(sig))
    blob = "".join(parts).encode()
    _options_blob_cache.clear()  # one generation: stale keys pin dead lists
    _options_blob_cache[id(options)] = (options, prov_sigs, blob)
    return blob


def problem_digest(problem: EncodedProblem) -> bytes:
    """Strong content digest of an encoded problem, cached on the problem.

    Covers everything ``_problems_content_equal`` compares — shapes, every
    array, pod NAMES per group, seed pods, existing-node names, option
    identities, and the full provisioner signatures — so digest equality is
    content equality (sha256; collision risk is negligible next to cosmic
    rays). Interning compares digests instead of walking 50k pod names per
    cached slot, a walk whose cost grew with every slot filled."""
    cached = problem.__dict__.get("_digest")
    if cached is not None:
        return cached
    h = hashlib.sha256()
    h.update(
        repr((
            problem.G, problem.O, problem.E,
            problem.resource_axes, problem.zones,
            problem.rel_unsupported, problem.zone_spread_members,
            problem.weight_gated_groups,
        )).encode()
    )
    for fld in (
        "demand", "count", "alloc", "price", "opt_zone", "compat",
        "node_cap", "zone_cap", "zone_skew", "colocate",
        "ex_rem", "ex_zone", "ex_compat",
    ):
        h.update(np.ascontiguousarray(getattr(problem, fld)).tobytes())
    for fld in (
        "zone_seed", "zone_occupied", "rel_set", "rel_host_forbid",
        "rel_host_need", "rel_zone_forbid", "rel_zone_need",
        "rel_slot_bits", "rel_zone_bits", "rel_layer",
    ):
        v = getattr(problem, fld)
        h.update(b"\x00" if v is None else np.ascontiguousarray(v).tobytes())
    # names in bulk: one native join per group (one C pass in place of the
    # Python join and walk), memoized on the group — a PodGroup's pods list
    # is final once built (the session's copy-on-write contract), so
    # consecutive digests of a retained group are a dict hit
    enc = load_encoder()
    for g in problem.groups:
        blob = g.__dict__.get("_name_blob")
        if blob is None:
            if enc is not None:
                blob = enc.join_names(g.pods, "\x1f")
            else:
                blob = "\x1f".join([p.meta.name for p in g.pods]).encode()
            g.__dict__["_name_blob"] = blob
        h.update(blob)
        h.update(b"\x1e")
    if problem.seed_pods:
        h.update(
            "\x1e".join(
                [f"{host}\x1f{zone}\x1f{p.meta.name}" for host, zone, p in problem.seed_pods]
            ).encode()
        )
    if problem.existing:
        h.update("\x1e".join([e.node.meta.name for e in problem.existing]).encode())
    h.update(_options_digest_blob(problem.options))
    digest = h.digest()
    problem.__dict__["_digest"] = digest
    return digest


def _problems_content_equal(a: EncodedProblem, b: EncodedProblem) -> bool:
    """TEST ORACLE for ``problem_digest`` — not called on the hot path.

    Field-by-field content equality between two encoded problems, including
    the pod NAMES each group expands to (a reused problem's result decodes
    the OLD pod objects' names — renamed pods must miss). Interning compares
    digests instead (O(1) per slot); ``tests/test_torch_session.py``
    cross-checks that digest equality and this definition agree, so any
    future EncodedProblem field must be added to BOTH or the test that
    perturbs it will catch the drift."""
    if (a.G, a.O, a.E) != (b.G, b.O, b.E):
        return False
    if a.resource_axes != b.resource_axes or a.zones != b.zones:
        return False
    for fld in (
        "demand", "count", "alloc", "price", "opt_zone", "compat",
        "node_cap", "zone_cap", "zone_skew", "colocate",
        "ex_rem", "ex_zone", "ex_compat",
    ):
        if not np.array_equal(getattr(a, fld), getattr(b, fld)):
            return False
    for fld in (
        "zone_seed", "zone_occupied", "rel_set", "rel_host_forbid",
        "rel_host_need", "rel_zone_forbid", "rel_zone_need",
        "rel_slot_bits", "rel_zone_bits", "rel_layer",
    ):
        va, vb = getattr(a, fld), getattr(b, fld)
        if (va is None) != (vb is None):
            return False
        if va is not None and not np.array_equal(va, vb):
            return False
    if a.rel_unsupported != b.rel_unsupported:
        return False
    if a.zone_spread_members != b.zone_spread_members:
        return False
    if a.weight_gated_groups != b.weight_gated_groups:
        return False
    for ga, gb in zip(a.groups, b.groups):
        if len(ga.pods) != len(gb.pods):
            return False
        if any(pa.name != pb.name for pa, pb in zip(ga.pods, gb.pods)):
            return False
    if len(a.seed_pods) != len(b.seed_pods):
        return False
    for (ha, za, pa), (hb, zb, pb) in zip(a.seed_pods, b.seed_pods):
        if ha != hb or za != zb or pa.name != pb.name:
            return False
    for ea, eb in zip(a.existing, b.existing):
        if ea.name != eb.name:
            return False
    for oa, ob in zip(a.options, b.options):
        if (
            oa.instance_type.name != ob.instance_type.name
            or oa.zone != ob.zone
            or oa.capacity_type != ob.capacity_type
            or oa.provisioner.name != ob.provisioner.name
            or oa.slice_pod != ob.slice_pod
            or oa.slice_coord != ob.slice_coord
        ):
            return False
    # FULL provisioner signatures: a reused problem's options hand their
    # embedded Provisioner objects to launch and limit enforcement, so any
    # spec field those paths read (limits, labels, taints, kubelet,
    # node_template_ref, ...) must match even when no encoded array changed
    def uniq_provs(p):
        seen, out = set(), []
        for o in p.options:
            if id(o.provisioner) not in seen:
                seen.add(id(o.provisioner))
                out.append(o.provisioner)
        return out

    pa, pb = uniq_provs(a), uniq_provs(b)
    if len(pa) != len(pb):
        return False
    for x, y in zip(pa, pb):
        if x is not y and _provisioner_sig(x) != _provisioner_sig(y):
            return False
    return True


class Solver(abc.ABC):
    #: per-interruption disruption cost ($-hours) scaling each offering's
    #: expected-interruption term in the price objective: the encoder builds
    #: options with risk_cost = interruption_probability * risk_penalty. Set
    #: from settings by the controllers (0.0 = risk-neutral, the legacy
    #: objective); every encode this solver drives — initial, relax, degate,
    #: trial solves — uses the same value, preserving delta==full digests.
    risk_penalty: float = 0.0

    @abc.abstractmethod
    def solve(self, problem: EncodedProblem) -> SolveResult: ...

    def _prewarm(self, problem: EncodedProblem, session=None) -> None:
        """Backend hook: called by ``solve_pods`` right after the encode so a
        device-backed solver can prepare likely next shapes. Host-only
        backends have nothing to warm, and neither, so far, has the port's
        ``TorchSolver``: its kernels are built once for every shape."""

    def prestage(self, problem: EncodedProblem) -> None:
        """Backend hook: stage this problem's tensors ahead of its solve.
        Host-only backends have nothing to stage."""

    def _intern_problem(self, problem: EncodedProblem) -> EncodedProblem:
        """Return the PREVIOUS encode's problem object when this one is
        content-identical — every reconcile re-encodes, producing fresh
        objects, but the per-problem learning (banked pattern pools, cached
        rounded plans, race outcome memory, device residency) keys on
        problem identity. Without interning, a steady-state operator whose
        cluster is momentarily unchanged would pay the pattern warmup on
        every cycle and never reach the learned plan. A few slots: the
        steady state being optimized is consecutive reconciles of the same
        batch.

        Thread-safety/staleness contract: ``solve_pods`` is single-threaded
        per Solver instance. On an intern hit the cached problem's embedded
        objects (groups, options, existing, seed_pods) are REPLACED by the
        fresh encode's, so any consumer reading non-encoded fields — launch
        paths reading option.provisioner, limit enforcement, decode — always
        sees this reconcile's live objects, never a stale generation."""
        slots = getattr(self, "_interned_problems", None)
        if slots is None:
            slots = self._interned_problems = []
        digest = problem_digest(problem)
        for cached in slots:
            if problem_digest(cached) == digest:
                # refresh embedded objects: content-equal by digest (names,
                # option identities, provisioner sigs all covered), so the
                # learned state stays valid while object references go live
                cached.groups = problem.groups
                cached.options = problem.options
                cached.existing = problem.existing
                cached.seed_pods = problem.seed_pods
                # drop the name cache too: it pins the PRIOR generation's pod
                # objects (names are equal, but the memory must free)
                cached.__dict__.pop("_group_names", None)
                return cached
        slots.append(problem)
        if len(slots) > 4:
            # a few slots: hypothetical solves sharing this solver must not
            # evict the provisioning batch's learning
            slots.pop(0)
        return problem

    def encode_for_staging(
        self,
        pods: Sequence[Pod],
        provisioners: Sequence[Tuple[Provisioner, Sequence[InstanceType]]],
        existing: Sequence[ExistingNode] = (),
        daemonsets: Sequence[Pod] = (),
        session=None,
        phase_mode: str = "full",
    ) -> EncodedProblem:
        """``solve_pods``' encode stage alone: encode (delta-aware through
        the session) + intern, with the spent encode time stamped on the
        problem so a later ``solve_pods(..., pre_encoded=problem)`` books it
        into ``encode_s``. The fleet-dispatch path encodes every dirty cell
        FIRST, stages the fleet, and fires the batched kernel dispatches
        before any per-cell solve runs — the device computes the whole
        fleet while the host paths execute."""
        t0 = time.perf_counter()
        if session is not None:
            fresh = session.encode(
                pods, provisioners, existing, daemonsets,
                risk_penalty=self.risk_penalty,
            )
        else:
            fresh = encode(
                pods, provisioners, existing, daemonsets,
                risk_penalty=self.risk_penalty,
            )
            fresh.__dict__["_encode_mode"] = phase_mode
            _observe_phase(fresh, "encode", time.perf_counter() - t0)
        problem = self._intern_problem(fresh)
        problem.__dict__["_encode_mode"] = fresh.__dict__.get(
            "_encode_mode", "full"
        )
        problem.__dict__["_pre_encode_s"] = time.perf_counter() - t0
        return problem

    def solve_fleet(
        self, requests: Sequence[dict], max_batch: int = 16
    ) -> List[SolveResult]:
        """Solve several independent problems (``requests`` are
        ``solve_pods`` kwarg dicts) as one fleet. Host-only backends have
        nothing to batch; the base implementation is the serial loop (and
        the equality oracle for the batched path)."""
        return [self.solve_pods(**req) for req in requests]

    def solve_pods(
        self,
        pods: Sequence[Pod],
        provisioners: Sequence[Tuple[Provisioner, Sequence[InstanceType]]],
        existing: Sequence[ExistingNode] = (),
        daemonsets: Sequence[Pod] = (),
        session=None,
        phase_mode: str = "full",
        pre_encoded: Optional[EncodedProblem] = None,
    ) -> SolveResult:
        """``session`` (an EncodeSession) makes the INITIAL encode delta-
        aware: the session patches the previous round's arrays instead of
        re-walking the cluster. The relaxation/degate re-encodes below stay
        on the full path — they solve transient CLONES whose identities must
        never enter the session's incremental state.

        ``phase_mode`` labels this round's karpenter_tpu_solve_phase_seconds
        samples when no session owns the mode: real sessionless rounds are
        "full"; consolidation what-if simulations pass "sim" so hundreds of
        microsecond sweep solves per pass cannot swamp the delta-vs-full
        comparison the histogram exists for.

        ``pre_encoded`` hands in a problem ``encode_for_staging`` already
        produced (the fleet-dispatch path encodes before staging); the
        encode stage is skipped and the staged encode time is credited."""
        from ..utils.tracing import span

        t0 = time.perf_counter()
        encode_s = 0.0
        with span("solve", pods=len(pods)):
            with span("solve.encode"):
                if pre_encoded is not None:
                    fresh = pre_encoded
                    encode_s += fresh.__dict__.pop("_pre_encode_s", 0.0)
                elif session is not None:
                    fresh = session.encode(
                        pods, provisioners, existing, daemonsets,
                        risk_penalty=self.risk_penalty,
                    )
                else:
                    fresh = encode(
                        pods, provisioners, existing, daemonsets,
                        risk_penalty=self.risk_penalty,
                    )
                    fresh.__dict__["_encode_mode"] = phase_mode
                    _observe_phase(fresh, "encode", time.perf_counter() - t0)
                problem = self._intern_problem(fresh)
                # an intern hit returns the CACHED object: carry this round's
                # encode mode over so its phase samples are labeled correctly
                problem.__dict__["_encode_mode"] = fresh.__dict__.get(
                    "_encode_mode", "full"
                )
            encode_s += time.perf_counter() - t0
            self._prewarm(problem, session)
            # anchor the latency budget at ENTRY (before encode): the budget
            # is an end-to-end contract, so a fresh batch's encode time comes
            # out of the polish budget, not on top of it
            problem.__dict__["_entry_t"] = t0
            with span("solve.backend"):
                # the round's ONE {phase="solve"} sample: backend internals
                # (host race members, kernel, fallback) must not each emit
                # their own, or solve counts outrun encode counts and the
                # delta-vs-full comparison this histogram exists for skews
                t_backend = time.perf_counter()
                result = self.solve(problem)
                _observe_phase(problem, "solve", time.perf_counter() - t_backend)
            # Preference relaxation (the reference scheduler's relaxation
            # pass): preferred node affinity is honored as a hard constraint
            # first; a pod that cannot schedule sheds its weakest still-active
            # preference (one per round) and the batch re-solves — soft
            # constraints may never strand a pod. Relaxation happens on
            # CLONES: live cluster pods keep their preferences, so a what-if
            # simulation or transient failure never mutates real state.
            work = None
            total_relaxed = 0
            while result.unschedulable:
                if work is None:
                    work = list(pods)
                    index = {p.name: i for i, p in enumerate(work)}
                relaxed_round = 0
                for name in result.unschedulable:
                    i = index.get(name)
                    if i is None:
                        continue
                    p = work[i]
                    if p.has_relaxable_constraints():
                        work[i] = p.relaxed_clone()
                        relaxed_round += 1
                if relaxed_round == 0:
                    break
                total_relaxed += relaxed_round
                with span("solve.relax", pods=relaxed_round):
                    t_enc = time.perf_counter()
                    problem = encode(
                        work, provisioners, existing, daemonsets,
                        risk_penalty=self.risk_penalty,
                    )
                    encode_s += time.perf_counter() - t_enc
                    problem.__dict__["_entry_t"] = t0
                    result = self.solve(problem)
            # Final fallback: the weight gate pins each group to its highest-
            # weight compatible pool; a group can be per-pod compatible yet
            # JOINTLY infeasible there (e.g. a zone spread needing zones the
            # pool doesn't cover). Re-solve with the gate dropped for the
            # still-failing pods — the weight preference yields before a pod
            # strands (reference: next-pool fallback in the weight cascade).
            gated_names: set = set()
            if result.unschedulable and problem.weight_gated_groups:
                for gi in problem.weight_gated_groups:
                    gated_names.update(p.name for p in problem.groups[gi].pods)
            if result.unschedulable and gated_names.intersection(result.unschedulable):
                # only retry when a FAILING pod's group was actually narrowed
                # by the weight gate — otherwise the re-solve provably returns
                # the same result at full cost
                degate = frozenset(result.unschedulable)
                with span("solve.degate", pods=len(degate)):
                    t_enc = time.perf_counter()
                    problem2 = encode(
                        work or pods, provisioners, existing, daemonsets,
                        weight_degate=degate,
                        risk_penalty=self.risk_penalty,
                    )
                    encode_s += time.perf_counter() - t_enc
                    problem2.__dict__["_entry_t"] = t0
                    result2 = self.solve(problem2)
                if len(result2.unschedulable) < len(result.unschedulable):
                    result, problem = result2, problem2
                    result.stats["weight_degated_pods"] = float(len(degate))
            if total_relaxed:
                result.stats["relaxed_pods"] = float(total_relaxed)
        result.stats["encode_s"] = encode_s
        # staging (accrued across prestage and the solve's own staging) and
        # the observed dispatch latency, separable from encode
        stage_s = problem.__dict__.pop("_stage_s", 0.0)
        if stage_s:
            result.stats["stage_s"] = stage_s
        dispatch_s = problem.__dict__.pop("_dispatch_s", 0.0)
        if dispatch_s:
            result.stats["dispatch_s"] = dispatch_s
        result.stats["total_s"] = time.perf_counter() - t0
        result.stats["lower_bound"] = lower_bound(problem)
        # digest of the problem the returned result actually decodes (the
        # relax/degate paths may have replaced the initial encode): cached by
        # interning on the common path, so the stamp costs a dict lookup
        result.problem_digest = problem_digest(problem).hex()
        return result


class GreedySolver(Solver):
    """Reference-semantics FFD (single ordering, host CPU)."""

    def solve(self, problem: EncodedProblem) -> SolveResult:
        t0 = time.perf_counter()
        result = GreedyPacker(problem).solve()
        result.stats["solve_s"] = time.perf_counter() - t0
        result.stats["backend"] = 0.0
        return result


def _tensor_path_unsupported(problem: EncodedProblem) -> Optional[str]:
    """Constraint shapes the tensor path cannot express: relation-bit
    exhaustion, non-hostname/zone topology keys, and cyclic required-affinity
    families. The greedy oracle answers them."""
    return problem.rel_unsupported


# ---------------------------------------------------------------------------
# Kernel-backend circuit breaker
# ---------------------------------------------------------------------------

class KernelDispatchTimeout(Exception):
    """A kernel dispatch missed its deadline: the buffer never became ready.
    The host paths own the round; the breaker books the evidence."""


class KernelBreakerBoard:
    """Per-bucket circuit breakers for the device path, riding
    ``utils.resilience``'s closed → open → half-open machinery.

    Evidence: a bucket whose kernels produced an INVALID plan (the
    count-level validator rejected it), a NON-FINITE plan, or a synchronous
    fetch that timed out records a failure; a validated answer records
    success. An open bucket does not dispatch until ``recovery_timeout_s``
    has passed; the next dispatch is then the half-open probe. The port
    builds one kernel library per source hash, not one executable per
    bucket: quarantine blocks the label and evicts its entries from
    ``AOT_CACHE`` (``evict_bucket``), so that the probe's dispatch consults
    the compile seam again, as the reference's goes through a compile, and
    admission forgets the bucket's measured latency.
    ``failures`` counts the evidence by kind, as
    ``karpenter_tpu_kernel_faults_total{kind}`` does; the health gauge
    (``karpenter_tpu_kernel_backend_health``) is the fraction of consulted
    buckets currently closed.

    Process-global: bucket evidence from any solver indicts the bucket, the
    sharded round's per-cell clones booking it from several threads; the
    breakers lock themselves, and the board's lock guards its rebuild and
    ``failures``. ``configure``/``reset`` serve the operator and tests."""

    def __init__(self, failure_threshold: int = 3, recovery_timeout_s: float = 30.0):
        self._lock = threading.Lock()
        self._make(failure_threshold, recovery_timeout_s, time.monotonic)

    def _make(self, failure_threshold, recovery_timeout_s, clock) -> None:
        self.failure_threshold = int(failure_threshold)
        self.recovery_timeout_s = float(recovery_timeout_s)
        self._clock = clock
        self._set = BreakerSet(
            "kernel",
            failure_threshold=self.failure_threshold,
            recovery_timeout_s=self.recovery_timeout_s, clock=clock,
        )
        self.failures: Dict[str, int] = {}

    def configure(self, failure_threshold: Optional[int] = None,
                  recovery_timeout_s: Optional[float] = None, clock=None) -> None:
        """Rebuild the board with new thresholds (operator settings, a test
        clock). Existing breaker state is dropped deliberately."""
        with self._lock:
            self._make(
                failure_threshold if failure_threshold is not None else self.failure_threshold,
                recovery_timeout_s if recovery_timeout_s is not None else self.recovery_timeout_s,
                clock if clock is not None else self._clock,
            )
        self._publish()

    def reset(self) -> None:
        self.configure()

    def first_dispatch(self, key: BucketKey, mesh=None) -> None:
        """The compile seam (``utils/faults.py``, site ``"compile"``). The
        port compiles nothing per shape, so the seam is consulted where the
        reference compiles: at a dispatch of a bucket that has no entry in
        ``AOT_CACHE`` (its first in the process, the first after its
        breaker opened, or after the table's LRU dropped it), which then
        makes the entry. A scripted ``compile-error`` raises
        ``InjectedDeviceError`` there, and no entry is made, so the next
        dispatch consults the seam again (the reference's failed compile
        leaves no executable either)."""
        if AOT_CACHE.resident(key, mesh):
            return
        if faults.device_fault("compile") is not None:
            raise faults.InjectedDeviceError(
                f"injected compile failure for bucket {key.label()}"
            )
        AOT_CACHE.build(key, mesh)

    def forget_builds(self) -> None:
        """Every bucket counts as never dispatched again: ``AOT_CACHE`` is
        emptied (tests: the reference's counterpart is a cold AOT cache)."""
        AOT_CACHE.clear()

    def allows(self, label: str) -> bool:
        """True when the bucket may dispatch: breaker closed, or half-open
        (the dispatch is the probe)."""
        allowed = self._set.get(label).state != "open"
        self._publish()
        return allowed

    def state(self, label: str) -> str:
        return self._set.get(label).state

    def ok(self, label: str) -> None:
        """A validated, finite kernel answer from this bucket. Ignored while
        the breaker is OPEN: a stale in-flight answer from before the
        quarantine must not cut the recovery timeout short (reading
        ``state`` turns open into half-open once the timeout has passed, so
        a genuine probe success still lands)."""
        breaker = self._set.get(label)
        if breaker.state != "open":
            breaker.record_success()
        self._publish()

    def fail(self, label: str, kind: str) -> None:
        """Device-path failure evidence of one ``kind``; the transition to
        open evicts the label's entries from ``AOT_CACHE`` (the reference's
        quarantine eviction)."""
        metrics.KERNEL_FAULTS.inc({"kind": kind})
        with self._lock:
            self.failures[kind] = self.failures.get(kind, 0) + 1
        breaker = self._set.get(label)
        before = breaker.state
        breaker.record_failure()
        if breaker.state == "open" and before != "open":
            AOT_CACHE.evict_bucket(label)
        self._publish()

    def health(self) -> float:
        """Fraction of consulted buckets whose breaker is closed (1.0 when
        nothing has ever been consulted — a healthy idle backend)."""
        breakers = self._set.breakers()
        if not breakers:
            return 1.0
        closed = sum(1 for b in breakers.values() if b.state == "closed")
        return closed / len(breakers)

    def states(self) -> dict:
        return {label: b.state for label, b in self._set.breakers().items()}

    def _publish(self) -> None:
        metrics.KERNEL_BACKEND_HEALTH.set(self.health())


#: process-wide board
KERNEL_BOARD = KernelBreakerBoard()


# ---------------------------------------------------------------------------
# Results on their way to the host
# ---------------------------------------------------------------------------

class _Pending:
    """A packed result buffer on its way to the host.

    On the card: two timing events around the chain that computed it, a copy
    into pinned host memory enqueued on the same stream, and an event after
    that copy. ``is_ready`` queries the event and never waits;
    ``materialize`` waits on it and reads the pinned copy. The handle holds
    the device buffer and the pinned copy until then. On the CPU the buffer
    is already computed."""

    __slots__ = ("buf", "host", "events", "done")

    def __init__(self, buf: torch.Tensor, host=None, events=None, done=None):
        self.buf = buf
        self.host = host
        self.events = events
        self.done = done

    @classmethod
    def enqueue(cls, run, device: torch.device, stream=None) -> "_Pending":
        """Run ``run()`` (which launches kernels and returns their result
        buffer) on ``stream`` (default: the current stream), and enqueue the
        copy to the host behind it."""
        if device.type != "cuda":
            return cls(run())
        with torch.cuda.stream(stream or torch.cuda.current_stream(device)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            buf = run()
            end.record()
            host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
            host.copy_(buf, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        return cls(buf, host, (start, end), done)

    def is_ready(self) -> bool:
        return self.done is None or self.done.query()

    def materialize(self) -> np.ndarray:
        if self.done is None:
            return self.buf.numpy()
        self.done.synchronize()
        return self.host.numpy()

    def device_ms(self) -> Optional[float]:
        """Device time of the chain (None on the CPU); once ready."""
        return None if self.events is None else self.events[0].elapsed_time(self.events[1])


def _fetch_bounded(buf: _Pending, timeout_s: float) -> np.ndarray:
    """Fetch a dispatched buffer with a deadline: polls readiness and raises
    :class:`KernelDispatchTimeout` instead of blocking the round on a hung
    device. ``timeout_s <= 0`` disables the deadline."""
    if timeout_s > 0:
        deadline = time.perf_counter() + timeout_s
        while not buf.is_ready():
            if time.perf_counter() >= deadline:
                raise KernelDispatchTimeout(f"kernel dispatch not ready within {timeout_s}s")
            time.sleep(0.0005)
    return buf.materialize()


class _HungBuffer:
    """An injected dispatch hang: wraps a dispatch's ``_Pending`` so that it
    reports not ready until the scripted hang has passed, and
    ``materialize`` sleeps out the rest. The chain itself still runs on the
    card, and the stager's fence (set by ``_launch_chain`` on the chain's
    own event) still orders the next restage after it. A test and chaos
    artifact: production buffers are never wrapped."""

    __slots__ = ("_inner", "_until")

    def __init__(self, inner: _Pending, until: float):
        self._inner = inner
        self._until = until

    @property
    def events(self):
        return self._inner.events

    @property
    def done(self):
        return self._inner.done

    def is_ready(self) -> bool:
        if time.perf_counter() < self._until:
            return False
        return self._inner.is_ready()

    def materialize(self) -> np.ndarray:
        remaining = self._until - time.perf_counter()
        if remaining > 0:
            time.sleep(remaining)
        return self._inner.materialize()

    def device_ms(self) -> Optional[float]:
        return self._inner.device_ms()


def _apply_dispatch_fault(pending: _Pending):
    """Dispatch-site fault seam (``utils/faults.py``): raises
    ``InjectedDeviceError`` on an injected device OOM, wraps the buffer on
    an injected hang, returns it untouched otherwise."""
    fault = faults.device_fault("dispatch")
    if fault is None:
        return pending
    if fault.kind == "device-oom":
        raise faults.InjectedDeviceError(
            "injected RESOURCE_EXHAUSTED: device out of memory"
        )
    hang = fault.hang_s if fault.hang_s == fault.hang_s else float("inf")
    return _HungBuffer(pending, time.perf_counter() + min(hang, 3600.0))


def _injected_kind(error: Exception) -> str:
    """The breaker kind of an ``InjectedDeviceError``: the dispatch seam's
    OOM, else the compile seam's failure (the reference's classification)."""
    return "device-oom" if "RESOURCE_EXHAUSTED" in str(error) else "compile-error"


def _apply_result_fault(unpacked):
    """Result-site fault seam, applied to the UNPACKED kernel answer
    (order, unplaced, costs, exhausted, new_opt, new_active, ys):

    * ``nan-result``     — costs become non-finite (the breaker's
      nonfinite-plan detection must refuse to decode it);
    * ``garbage-result`` — assignment counts are corrupted into a
      plausible-shaped overpack that claims an impossibly cheap plan, so
      that it wins the cost race and the count validator must stop it."""
    fault = faults.device_fault("result")
    if fault is None:
        return unpacked
    order, unplaced, costs, exhausted, new_opt, new_active, ys = unpacked
    if fault.kind == "nan-result":
        costs = np.full_like(np.asarray(costs, dtype=np.float64), np.nan)
    elif fault.kind == "garbage-result":
        ys = np.asarray(ys).copy()
        ys[ys > 0] = ys[ys > 0] * 3 + 1  # overpacks every used slot
        unplaced = 0  # "everything placed"
        costs = np.full_like(np.asarray(costs, dtype=np.float64), 1e-6)
    return order, unplaced, costs, exhausted, new_opt, new_active, ys


class _Dispatch(NamedTuple):
    """One problem's asynchronous kernel dispatch and what unpacking it
    needs."""

    pending: _Pending
    orders: np.ndarray
    swaps: np.ndarray
    s_new: int
    n_zones: int
    inputs: PackInputs
    key: BucketKey
    t_dispatch: float


class _FleetBuffer:
    """The ``[B, L]`` buffer of one fleet dispatch, shared by the cells
    batched into it, whose solves may run on several threads. The first cell
    that reads it copies it to the host once, under the lock; every later
    cell reads that copy. ``abandoned`` is set when a cell's poll gave up at
    its deadline: siblings then take it only if it is ready, and never wait
    on it. ``copies`` counts the host copies (one a dispatch). A fleet feeds
    the fleet bucket's dispatch latency (``AOT_CACHE``, keyed on the B-wide
    bucket, so that it never moves the B=1 bucket's) at most once: the
    first observed transition, or the first poll that gave up."""

    __slots__ = ("pending", "key", "mesh", "t_dispatch", "width", "abandoned", "copies", "_lock",
                 "_host", "_ewma_done")

    def __init__(self, pending, key: BucketKey, t_dispatch: float, width: int, mesh=None):
        self.pending = pending
        self.key = key  # the fleet bucket (B > 1)
        self.mesh = mesh  # the mesh the dispatch was split over, or None
        self.t_dispatch = t_dispatch
        self.width = width  # real cells batched (<= key.B; the rest is padding)
        self.abandoned = False
        self.copies = 0
        self._lock = threading.Lock()
        self._host: Optional[np.ndarray] = None
        self._ewma_done = False

    def is_ready(self) -> bool:
        with self._lock:
            if self._host is not None:
                return True
        return self.pending.is_ready()

    def note_ready(self, observed_at: float) -> None:
        """The dispatch-to-ready latency of the first poll that observed the
        transition (a buffer ready at the first look times nothing), unless
        this fleet has fed its sample already."""
        with self._lock:
            if self._ewma_done:
                return
            self._ewma_done = True
        AOT_CACHE.note_dispatch(self.key, observed_at - self.t_dispatch, mesh=self.mesh)

    def note_miss(self, observed_at: float) -> None:
        """A poll gave up before the buffer was ready: the time since the
        dispatch is a pessimistic sample (a floor on the true latency), fed
        as ``note_ready`` feeds, so that the next round's ``stage_fleet``
        backs this fleet bucket off on its own evidence while its cells
        still race one by one."""
        self.note_ready(observed_at)

    def materialize(self) -> np.ndarray:
        with self._lock:
            if self._host is None:
                t0 = time.perf_counter()
                self._host = self.pending.materialize()
                self.copies += 1
                if self.mesh is not None:
                    # the wait for a meshed dispatch's [B, L] result, which
                    # the shards gathered on the first one: the meshed
                    # tier's {phase=gather}
                    gather_s = time.perf_counter() - t0
                    profiling.note_phase("gather", "sharded", gather_s)
                    metrics.SOLVE_PHASE.observe(gather_s, {"phase": "gather", "mode": "sharded"})
            return self._host

    def device_ms(self) -> Optional[float]:
        """Device time of the dispatch (None on the CPU); once ready."""
        return self.pending.device_ms()


class _FleetDispatch:
    """One cell's share of a fleet dispatch: the shared buffer, this
    problem's row and what unpacking it needs. Attached to the problem by
    ``stage_fleet``; popped by ``solve``."""

    __slots__ = ("shared", "row", "orders", "swaps", "s_new", "n_zones")

    def __init__(self, shared, row, orders, swaps, s_new, n_zones):
        self.shared = shared
        self.row = row
        self.orders = orders
        self.swaps = swaps
        self.s_new = s_new
        self.n_zones = n_zones


def stage_fleet(
    entries: Sequence[Tuple["TorchSolver", EncodedProblem]], max_batch: int = 16,
    superproblem_max_cells: int = 0,
) -> dict:
    """Batch same-bucket kernel dispatches into single device calls.

    ``entries`` pairs each freshly encoded problem with the solver that will
    solve it (the sharded round's per-cell clones, or one shared solver).
    Problems are grouped by bucket; each group is cut into chunks of the
    largest power of two <= ``max_batch``, each chunk is padded to its pow2
    fleet width with inert rows and solved in one ``pack_solve_fleet`` call.
    Each batched problem carries a ``_fleet_dispatch`` handle that its
    ``solve`` polls in the race instead of dispatching on its own. A lone
    cell is left to its own solve.

    Problems the per-cell race would not dispatch are skipped: tiny ones,
    shapes only the greedy oracle takes, quality-mode solvers, problems whose
    race memory says the kernel lost or already answered, problems whose
    last fleet row went unread (``_fleet_skip``), and solvers whose race
    breaker is open. So are chunks whose predicted dispatch latency is not
    inside the owner's budget (the reference's ladder: the fleet bucket's
    measured latency, else the B=1 bucket's, else ``device_rtt``), and
    quarantined fleet buckets.

    A chunk whose every problem is resident on its solver's device (after
    ``prestage``) is stacked on the device by ``fleet_stack`` from the
    resident rows and the pad row, staged once under ``("fleetpad",) +
    fleet_key``; otherwise the chunk is stacked on the host and staged
    through the first solver's stager under ``("fleet",) + fleet_key``.

    **Superproblem mode** (the 2D meshed tier): when a group's owner holds
    a 2D (options x fleet) mesh and ``superproblem_max_cells >= 2``, the
    chunk width cap is raised to ``superproblem_max_cells``, and the batch
    is padded up to the mesh's fleet-axis multiple: same-bucket cells are
    solved as ONE meshed dispatch (rows split over ``fleet``, option columns
    over ``options``), staged through the owner's stager under ``("super",
    axes) + fleet_key`` with the rule table's placement. On the 1D mesh the
    stacked chunk is placed by ``shard_fleet``.

    Returns ``dispatches``, ``cells_batched``, ``eligible``, the fleet
    ``buckets``, how many chunks were ``device_stacked``, and the meshed
    tier's ``superproblems`` (2D-mesh dispatches) and ``mesh_axes``."""
    from ..parallel import FLEET_AXIS, is_mesh2d, mesh_axes_label

    stats = {"dispatches": 0, "cells_batched": 0, "eligible": 0, "buckets": [],
             "device_stacked": 0, "superproblems": 0, "mesh_axes": ""}
    if max_batch < 2 or len(entries) < 2:
        return stats
    width_cap = 1 << (int(max_batch).bit_length() - 1)
    super_cap = (1 << (int(superproblem_max_cells).bit_length() - 1)
                 if superproblem_max_cells >= 2 else 0)
    groups: "OrderedDict[BucketKey, list]" = OrderedDict()
    for solver, problem in entries:
        if problem is None or problem.G == 0:
            continue
        if not hasattr(solver, "_bucket_key"):
            continue  # host-only backend (greedy oracle): nothing to batch
        if problem.O == 0 and problem.E == 0:
            continue
        if _tensor_path_unsupported(problem) is not None:
            continue
        if solver.latency_budget_s > 1.0:
            continue  # quality mode solves synchronously; nothing to race
        if int(problem.count.sum()) < solver.race_min_pods:
            continue  # tiny problems never race the device
        solver._expire_race_memory(problem)
        if problem.__dict__.get("_race_kernel_lost", False):
            continue
        if problem.__dict__.get("_race_kernel_result") is not None:
            continue
        if problem.__dict__.get("_fleet_skip", False):
            # this problem's last fleet row went unread (a cached plan served
            # its solve): restaging would pay for a dispatch nobody polls
            continue
        if solver._race_fails >= 3:
            continue  # open race breaker: the per-cell half-open probe retries
        stats["eligible"] += 1
        groups.setdefault(solver._bucket_key(problem), []).append((solver, problem))
    cleared: set = set()
    for key, members in groups.items():
        # superproblem width: on a 2D mesh the batch axis is a device axis
        # (rows split over ``fleet``), so the operator's superproblem budget
        # caps it, not the host-stack fleet cap
        group_mesh = members[0][0]._ensure_mesh()
        group_2d = is_mesh2d(group_mesh)
        cap = max(width_cap, super_cap) if group_2d and super_cap else width_cap
        for base in range(0, len(members), cap):
            chunk = members[base : base + cap]
            if len(chunk) < 2:
                continue  # a lone cell dispatches in its own race
            B = bucket_fleet(len(chunk))
            if group_2d:
                # pad the batch up to the fleet axis so that the rows split
                # (padding rows are inert: over-padding never changes answers)
                B = max(B, group_mesh.shape.get(FLEET_AXIS, 1))
            fleet_key = key._replace(B=B)
            owner = chunk[0][0]
            # admission on measured latency: the fleet bucket's own, else
            # the B=1 bucket's, else the process's device round trip
            mesh = owner._ensure_mesh()
            pred = AOT_CACHE.predicted_dispatch_s(fleet_key, mesh=mesh)
            if pred is None:
                pred = AOT_CACHE.predicted_dispatch_s(key, mesh=mesh)
            if pred is None:
                pred = owner.device_rtt()
            if pred >= owner.latency_budget_s:
                AOT_CACHE.note_refusal(fleet_key, pred, mesh=mesh)
                continue
            if not KERNEL_BOARD.allows(fleet_key.label()):
                continue  # quarantined fleet bucket: the cells race one by one
            try:
                stacked = _stage_fleet_chunk(chunk, key, fleet_key, cleared)
            except faults.InjectedDeviceError as e:
                # an injected device OOM or compile failure at the fleet
                # dispatch is booked as at a cell's, and the cells race one
                # by one (the reference's fleet path consults no seam: it
                # dispatches only executables its background worker built)
                KERNEL_BOARD.fail(fleet_key.label(), _injected_kind(e))
                continue
            stats["device_stacked"] += stacked
            stats["dispatches"] += 1
            stats["cells_batched"] += len(chunk)
            stats["buckets"].append(fleet_key.label())
            if group_2d:
                axes = mesh_axes_label(group_mesh)
                stats["superproblems"] += 1
                stats["mesh_axes"] = axes
                metrics.MESH_DISPATCH.inc({"axes": axes})
    return stats


def _stage_fleet_chunk(chunk, key: BucketKey, fleet_key: BucketKey, cleared: set) -> bool:
    """Stack one chunk along the batch axis, dispatch it, and attach each
    problem's row. Returns whether the stack was built on the device. On
    the owner's mesh the host-stacked chunk is placed by ``shard_fleet``
    (1D) or staged with the rule table's placement (2D, a superproblem),
    and the dispatch is ``pack_solve_meshed``."""
    from ..parallel import is_mesh2d, mesh_axes_label, mesh_sharding, shard_fleet
    from ..parallel.mesh import device_put

    B = fleet_key.B
    owner = chunk[0][0]
    mesh = owner._ensure_mesh()
    preps = []
    for solver, problem in chunk:
        prep = solver._prepare(problem, bucket=key)
        # seed the host competitor's cache with the padded arrays, cleared
        # once per solver per staging pass, so that one shared solver keeps
        # every problem it stages
        with solver._cache_lock:
            if id(solver) not in cleared:
                cleared.add(id(solver))
                solver._host_cache.clear()
            solver._host_cache[id(problem)] = (problem, PackInputs(**prep[0]), *prep[1:4],
                                              prep[6], prep[7], [None])
        preps.append(prep)
    t_stage = time.perf_counter()
    resident = [solver._resident(problem) for solver, problem in chunk]
    pad_fields, *pad_members = fleet_padding(key)
    pad = {**pad_fields, **dict(zip(_MEMBER_LEAVES, pad_members))}
    device_side = mesh is None and all(e is not None for e in resident)
    if mesh is not None:
        rows = [{**prep[0], **dict(zip(_MEMBER_LEAVES, prep[1:6]))} for prep in preps]
        rows += [pad] * (B - len(rows))
        leaves = {f: np.stack([r[f] for r in rows]) for f in pad}
        if not is_mesh2d(mesh):
            placed = shard_fleet(mesh, B, PackInputs(*(leaves[f] for f in PackInputs._fields)),
                                 *(leaves[f] for f in _MEMBER_LEAVES))
            staged = dict(zip(PackInputs._fields, placed[0]))
            staged.update(zip(_MEMBER_LEAVES, placed[1:]))
        else:
            # superproblem staging: the stacked leaves route through the
            # owner's stager under a mesh-labelled tag, each full upload
            # placed by the rule table with the batch axis on ``fleet``; a
            # repeat round restages only churned rows, each on its shard
            staged = owner._stager.stage(
                ("super", mesh_axes_label(mesh)) + tuple(fleet_key), leaves,
                put=lambda name, arr: device_put(
                    arr, mesh_sharding(mesh, name, np.shape(arr), batch=True)),
            )
    elif device_side:
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
    stage_s = time.perf_counter() - t_stage
    profiling.note_phase("stage", "sharded", stage_s)
    metrics.SOLVE_PHASE.observe(stage_s, {"phase": "stage", "mode": "sharded"})
    KERNEL_BOARD.first_dispatch(fleet_key, mesh)
    t_dispatch = time.perf_counter()
    if mesh is not None:
        run = lambda: pack_solve_meshed(mesh, *args, key.S, key.Z)  # noqa: E731
    else:
        run = lambda: pack_solve_fleet(*args, key.S, key.Z)  # noqa: E731
    pending = _apply_dispatch_fault(_Pending.enqueue(run, owner.device))
    shared = _FleetBuffer(pending, fleet_key, t_dispatch, len(chunk), mesh)
    for row, ((_, problem), prep) in enumerate(zip(chunk, preps)):
        problem.__dict__["_fleet_dispatch"] = _FleetDispatch(
            shared, row, prep[1], prep[5], key.S, key.Z
        )
        # the fleet width this problem was dispatched at (the handle above is
        # popped by solve)
        problem.__dict__["_fleet_b"] = B
        # round-budget share: batched cells split one round budget for the
        # host path's adaptive polish (floored in solve); the kernel answer
        # does not depend on it
        problem.__dict__["_budget_share"] = 1.0 / len(chunk)
    return device_side


class TorchSolver(Solver):
    """The portfolio packing kernel on one device, raced against the host
    paths.

    ``device`` defaults to the card: ``TorchSolver()`` raises when CUDA is
    absent rather than running on the CPU, and loads (building if needed)
    the kernel library, so that no build ever lands inside a solve's budget.
    ``device="cpu"`` runs the plain PyTorch versions of the kernels (the
    tests' path).

    Dispatch policy, the reference's (``solve``):

    * In latency mode (``latency_budget_s <= 1``) the fused kernel chain is
      enqueued on the solver's side stream BEFORE the host path starts, so
      the card computes while the host path runs; the kernel is polled
      until the deadline, and the cheaper validated answer wins. Race
      memory (``race_memory_ttl_s``) remembers per problem a kernel that
      lost, missed twice, or won; three missed deadlines in a row open the
      race breaker, which re-probes every ``_race_retry_interval_s``.
    * LP-safe problems take the host fast path (``host.solve_host``); other
      shapes take the numpy FFD member (``_solve_host_pack``) and the
      zone-decomposed pattern CG (``topo.topo_improve``).
    * In quality mode the kernel runs synchronously beside the host path
      (``quality_race`` builds the host competitor for non-LP-safe shapes
      too). Every bucket of the port is warm from construction, so the
      kernel always answers inline.
    * Shapes the tensor path cannot express go to ``GreedySolver``.

    ``backend`` in a result's stats: 0 greedy oracle, 1 kernel, 2 host fast
    path (LP, patterns, topology CG), 3 host FFD member.

    The solver keeps one problem resident on its device (``_device_inputs``:
    staged through its ``DeviceStager`` under the tag ``("cell", Gp, Op, Ep,
    Zp, R, K)``, so the next problem of that shape moves only its churned
    rows). ``prestage`` stages a problem ahead of its solve; the sharded
    round gives each cell its own solver so that every dirty cell stays
    resident until ``stage_fleet``.

    ``mesh`` (``parallel.mesh.Mesh``) solves over a device mesh: on the 1D
    portfolio mesh K rounds up to the mesh size and the members split over
    the shards (placed by ``shard_portfolio``, outside the stager); on the
    2D options x fleet mesh the option padding aligns to the options axis,
    the bucket key carries the mesh dims (``MO``, ``MF``), and the problem is
    staged per shard through the stager under ``("cell2d", axes, ...)``.
    Without one, ``auto_mesh`` builds one at first use when this solver is
    on a card and at least two cards are visible: a 2D mesh of
    ``mesh_shape`` (options, fleet) when given and the cards suffice, else
    the 1D mesh over every card; below two cards, none, as the reference
    builds none below two devices. ``superproblem_max_cells`` caps a 2D
    mesh's superproblem width (``solve_fleet``)."""

    #: problems below this many pods never race the device in latency mode
    #: (the host paths answer in single-digit ms); shared by the per-cell
    #: race and the fleet staging admission
    race_min_pods: int = 450

    #: floor (seconds) on a fleet cell's share of the host-polish budget: the
    #: share never starves the host pipeline below its base LP, rounding and
    #: first ruin-recreate pass
    fleet_host_floor_s: float = 0.045

    _device_rtt_s: Optional[float] = None  # class-level: one probe per process
    # the first probe may come from any of the sharded round's worker threads
    _rtt_lock = threading.Lock()

    def __init__(
        self,
        portfolio: int = 8,
        seed: int = 0,
        max_slots: int = 1 << 15,
        latency_budget_s: float = 0.1,
        warmup_spike_s: float = 1.5,
        race_memory_ttl_s: float = 30.0,
        quality_race: bool = False,
        dispatch_timeout_s: float = 2.0,
        device="cuda",
        mesh=None,
        auto_mesh: bool = True,
        mesh_shape=None,
        superproblem_max_cells: int = 64,
    ):
        device = torch.device(device)
        self._side = None
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("TorchSolver: CUDA is not available (pass device='cpu' for the CPU)")
            from ._build import load_kernels

            load_kernels()
            self._side = torch.cuda.Stream(device)
        self.portfolio = portfolio
        self.seed = seed
        self.max_slots = max_slots
        self.latency_budget_s = latency_budget_s
        # cap on the one-time deadline extension the adaptive closers
        # (patterns.py CG warmup, topo.py plan build) may take on the first
        # repeat solve of a problem; 0 disables warmup spikes
        self.warmup_spike_s = warmup_spike_s
        # per-problem race memory expires after this long: a kernel that
        # lost is consulted again, a cached winning answer recomputed
        self.race_memory_ttl_s = race_memory_ttl_s
        self.quality_race = quality_race
        # deadline on a synchronous kernel fetch: a hung dispatch raises
        # KernelDispatchTimeout and the host answers; 0 waits without one
        self.dispatch_timeout_s = dispatch_timeout_s
        self.device = device
        self._stager = DeviceStager(device=device)
        self._device_cache: dict = {}
        self._host_cache: dict = {}  # numpy inputs for the host FFD competitor
        # guards both caches: stage_fleet seeds a solver's caches from the
        # controller thread while the solver may be solving on a worker
        self._cache_lock = threading.Lock()
        self._fallback = GreedySolver()
        self._race_fails = 0
        # race breaker half-open probe: with >= 3 missed deadlines the device
        # is still re-probed once per interval
        self._race_retry_interval_s = 5.0
        self._race_retry_at = 0.0
        self.mesh = mesh
        self.auto_mesh = auto_mesh
        self.mesh_shape = mesh_shape
        self.superproblem_max_cells = superproblem_max_cells

    def _ensure_mesh(self):
        """The solver's mesh, built at first use (``auto_mesh``) when this
        solver is on a card and two or more cards are visible; None below
        two, so that one card keeps the meshless path."""
        if self.mesh is None and self.auto_mesh:
            from ..parallel.mesh import device_count, make_mesh, make_mesh2d

            self.auto_mesh = False  # probe once
            n = device_count() if self.device.type == "cuda" else 0
            if self.mesh_shape is not None:
                o, f = self.mesh_shape
                if 1 < o * f <= n:
                    self.mesh = make_mesh2d((o, f))
            elif n > 1:
                self.mesh = make_mesh()
        return self.mesh

    def _mesh_stamp(self, key: BucketKey) -> BucketKey:
        """On the 2D meshed tier, the bucket key's mesh dims (MO, MF) and
        shard-aligned option padding: a meshed dispatch lives in its own key
        space, and O must divide the options axis."""
        from ..parallel import FLEET_AXIS, OPTIONS_AXIS, is_mesh2d, shard_aligned_options

        mesh = self._ensure_mesh()
        if not is_mesh2d(mesh):
            return key
        sizes = mesh.shape
        return key._replace(O=shard_aligned_options(key.O, mesh), MO=sizes.get(OPTIONS_AXIS, 1),
                            MF=sizes.get(FLEET_AXIS, 1))

    def _options_pad(self, o: int) -> int:
        """The option axis's padding: the pow2 bucket, aligned to the 2D
        mesh's options axis when there is one (``_mesh_stamp`` grows the key
        alike)."""
        from ..parallel import shard_aligned_options

        return shard_aligned_options(bucket_options(o), self._ensure_mesh())

    def _portfolio_k(self) -> int:
        """K: the portfolio rounded up to the 1D mesh's size."""
        from ..parallel import round_up_portfolio

        return round_up_portfolio(self.portfolio, self._ensure_mesh())

    # -- the race -----------------------------------------------------------
    def device_rtt(self) -> float:
        """Measured round trip of a minimal kernel call: ``rtt_probe`` on
        ``int32[8]`` launched on the current stream and read back to the
        host (a real device-to-host read), median of 3 after one warm call.
        Measured once per process and kept at class level."""
        if TorchSolver._device_rtt_s is None:
            with TorchSolver._rtt_lock:
                if TorchSolver._device_rtt_s is None:
                    x = torch.zeros((8,), dtype=torch.int32, device=self.device)
                    rtt_probe(x).cpu()
                    samples = []
                    for _ in range(3):
                        t0 = time.perf_counter()
                        rtt_probe(x).cpu()
                        samples.append(time.perf_counter() - t0)
                    TorchSolver._device_rtt_s = sorted(samples)[1]
        return TorchSolver._device_rtt_s

    @staticmethod
    def _mark_kernel_lost(problem: EncodedProblem) -> None:
        problem.__dict__["_race_kernel_lost"] = True
        problem.__dict__["_race_memory_at"] = time.monotonic()
        problem.__dict__.pop("_race_kernel_result", None)

    def _expire_race_memory(self, problem: EncodedProblem) -> None:
        """Race outcomes are conditions, not facts: after the TTL, a lost
        race re-races and a cached winning result is recomputed."""
        at = problem.__dict__.get("_race_memory_at")
        if at is not None and time.monotonic() - at > self.race_memory_ttl_s:
            for k in ("_race_kernel_lost", "_race_kernel_result", "_race_miss_count",
                      "_race_memory_at"):
                problem.__dict__.pop(k, None)

    def solve(self, problem: EncodedProblem) -> SolveResult:
        t0 = time.perf_counter()
        # end-to-end anchor: when solve_pods stamped its entry time (this
        # solve follows a fresh encode), deadlines count from THERE — encode
        # spent part of the budget already. Popped so that a later direct
        # solve(problem) cannot see a stale stamp and zero its budget.
        t_anchor = problem.__dict__.pop("_entry_t", t0)
        # a fleet handle is consumed once, popped even on paths that will not
        # poll it, so that it can never serve a later solve of the problem
        fleet_slot = problem.__dict__.pop("_fleet_dispatch", None)
        # fleet cells split one round budget for host-path polish, floored
        # so that the host pipeline always reaches its base pass
        budget_share = problem.__dict__.pop("_budget_share", 1.0)
        host_budget_s = max(
            self.latency_budget_s * budget_share,
            min(self.latency_budget_s, self.fleet_host_floor_s),
        )
        if problem.G == 0:
            return SolveResult(stats={"backend": 1.0})
        if problem.O == 0 and problem.E == 0:
            return SolveResult(
                unschedulable=[p.name for g in problem.groups for p in g.pods],
                stats={"backend": 1.0},
            )
        if _tensor_path_unsupported(problem) is not None:
            result = self._fallback.solve(problem)
            result.stats["fallback"] = 1.0
            return result

        quality = self.latency_budget_s > 1.0
        dispatched = None
        # per-problem race memory: a kernel that already lost on THIS
        # problem is not waited on again until the memory expires
        self._expire_race_memory(problem)
        kernel_hopeless = problem.__dict__.get("_race_kernel_lost", False)
        # tiny problems never race the device: the host answers in ms
        tiny = int(problem.count.sum()) < self.race_min_pods
        # a kernel answer that won on this problem is replayed against the
        # (still improving) host plan instead of dispatching again
        kernel_cached = problem.__dict__.get("_race_kernel_result")
        # pre-FFD probe: a finished topology pattern plan stands in as the
        # host answer without running the FFD, and no dispatch is fired
        topo_fast = None
        if not quality and not tiny:
            try:
                topo_fast = topo_improve(
                    problem, self, float("inf"),
                    deadline=t_anchor + self.latency_budget_s * 0.85,
                    probe_only=True,
                )
            except Exception:
                topo_fast = None
        if (
            not quality
            and not tiny
            and not kernel_hopeless
            and kernel_cached is None
            and topo_fast is None
        ):
            if fleet_slot is not None:
                # the kernel for this problem is already in flight as one row
                # of a fleet dispatch: poll that
                dispatched = fleet_slot
            elif self._race_dispatch_affordable(problem, refusal=True):
                # enqueue the kernel BEFORE the host path runs: the card
                # computes while the host path does, and the poll below pays
                # only the leftover wait
                dispatched = self._dispatch_async(problem)
        if fleet_slot is not None and dispatched is not fleet_slot:
            # the fleet row goes unread: stage_fleet stops paying for it on
            # repeat rounds of this problem
            problem.__dict__["_fleet_skip"] = True
        t_host = time.perf_counter()
        host_result = topo_fast
        if host_result is None:
            try:
                # adaptive polish on the budget left after a feasible plan:
                # quality mode gets a fixed cap, fleet cells their share
                host_deadline = t_anchor + min(host_budget_s * 0.85, 0.5)
                host_result = solve_host(
                    problem, deadline=host_deadline, spike_s=self.warmup_spike_s
                )
            except Exception:
                host_result = None  # any host-path failure falls to the kernel
        if host_result is None and (not quality or self.quality_race):
            # non-LP-safe shapes: the numpy grouped-FFD member is the host
            # competitor, so the device's round trip is never the latency floor
            try:
                host_result = self._solve_host_pack(problem)
            except Exception:
                host_result = None
            if host_result is not None and not host_result.unschedulable:
                # zone-decomposed pattern CG: engages on repeat solves and
                # replaces the FFD answer only when strictly cheaper and valid
                try:
                    improved = topo_improve(
                        problem, self, host_result.cost,
                        deadline=t_anchor + host_budget_s * 0.85,
                        incumbent=host_result,
                    )
                    if improved is not None:
                        host_result = improved
                except Exception:
                    pass  # the FFD answer stands
        host_s = time.perf_counter() - t_host
        if host_result is not None:
            # comparisons carry the kernel's unplaced penalty, so a host plan
            # that strands pods never beats a complete kernel plan on price
            host_cmp = host_result.cost + 1e6 * len(host_result.unschedulable)
            t_poll = time.perf_counter()
            if quality:
                kernel_result = self._solve_kernel(problem)
            elif kernel_hopeless or tiny:
                kernel_result = None
            elif kernel_cached is not None:
                # a fresh shell each time: callers holding earlier returns
                # keep their stats
                kernel_result = dataclasses.replace(
                    kernel_cached, stats=dict(kernel_cached.stats)
                )
            else:
                kernel_result = self._poll_dispatch(
                    problem, dispatched, deadline=t_anchor + self.latency_budget_s,
                    host_cost=host_cmp,
                )
            race = {"race_host_s": host_s, "race_poll_s": time.perf_counter() - t_poll}
            device_ms = problem.__dict__.pop("_dispatch_device_ms", None)
            if device_ms is not None:
                race["dispatch_device_ms"] = device_ms
            if kernel_result is not None and (
                kernel_result.cost + 1e6 * len(kernel_result.unschedulable) < host_cmp
            ):
                if not quality and kernel_cached is None:
                    # cache a private copy whose stats nobody else mutates
                    problem.__dict__["_race_kernel_result"] = dataclasses.replace(
                        kernel_result, stats=dict(kernel_result.stats)
                    )
                    problem.__dict__["_race_memory_at"] = time.monotonic()
                kernel_result.stats.update(race, race_winner=1.0,
                                           total_solve_s=time.perf_counter() - t0)
                return kernel_result
            if kernel_result is not None and not quality:
                # the kernel answered in time and still lost: repeat solves
                # of this problem skip the wait
                self._mark_kernel_lost(problem)
            host_result.stats.update(race, total_solve_s=time.perf_counter() - t0)
            return host_result
        result = self._solve_kernel(problem)
        if result is None:
            result = self._fallback.solve(problem)
            result.stats["fallback"] = 1.0
        return result

    def solve_fleet(
        self, requests: Sequence[dict], max_batch: int = 16
    ) -> List[SolveResult]:
        """Multi-problem entry: encode every request first (delta-aware per
        request's session), batch same-bucket kernel dispatches into single
        device calls through ``stage_fleet``, then run each request's
        ``solve_pods``, whose race polls its fleet row in place of a
        dispatch of its own. Answers are those of the serial ``solve_pods``
        loop; only the device-call count and the wall clock change. On a 2D
        mesh the solver's superproblem cap widens the batch, so that the
        whole fleet can go as one meshed dispatch."""
        staged = [self.encode_for_staging(**req) for req in requests]
        stage_fleet([(self, p) for p in staged], max_batch=max_batch,
                    superproblem_max_cells=self.superproblem_max_cells)
        return [
            self.solve_pods(**req, pre_encoded=p)
            for req, p in zip(requests, staged)
        ]

    def _solve_host_pack(self, problem: EncodedProblem) -> Optional[SolveResult]:
        """A small portfolio of numpy FFD members (FFD / footprint orderings
        × lookahead) over the kernel's own prepared arrays: the
        topology-capable host competitor. Count-validated and decoded exactly
        like kernel output; None when invalid."""
        t0 = time.perf_counter()
        key = id(problem)
        with self._cache_lock:
            cached = self._host_cache.get(key)
        if cached is None or cached[0] is not problem:
            fields, orders, alphas, looks, _rsvs, _swaps, s_new, n_zones = self._prepare(problem)
            cached = (problem, PackInputs(**fields), orders, alphas, looks, s_new, n_zones, [None])
            with self._cache_lock:
                self._host_cache.clear()
                self._host_cache[key] = cached
        _, inputs, orders, alphas, looks, s_new, n_zones, shared_slot = cached
        if shared_slot[0] is None:
            shared_slot[0] = host_shared(inputs)
        shared = shared_slot[0]
        best = None
        best_order = None
        k = orders.shape[0]
        grown = s_new
        for mi in range(min(4, k)):
            order = orders[mi]
            sn = grown
            out = None
            while out is None and sn <= self.max_slots:
                out = host_pack(
                    inputs, shared, order, sn, n_zones,
                    alpha=float(alphas[mi]), look=bool(looks[mi]),
                )
                if out is None:
                    sn *= 2
            grown = max(grown, min(sn, self.max_slots))
            if out is None:
                continue
            new_opt, new_active, ys, unplaced = out
            cost = float(np.sum(np.asarray(inputs.price)[new_opt[new_active]])) + unplaced * 1e6
            if best is None or cost < best[0]:
                best = (cost, new_opt, new_active, ys, unplaced)
                best_order = order
        if grown > s_new:
            # persist the grown slot budget: repeat solves of a cached
            # problem do not pay the doubling ladder again
            entry = (problem, inputs, orders, alphas, looks, grown, n_zones, shared_slot)
            with self._cache_lock:
                if self._host_cache.get(key) is cached or key not in self._host_cache:
                    self._host_cache[key] = entry
        if best is None:
            return None
        _, new_opt, new_active, ys, unplaced = best
        if validate_counts(problem, best_order, new_opt, new_active, ys):
            return None
        result = self._decode(problem, best_order, new_opt, new_active, ys)
        result.stats["backend"] = 3.0  # host FFD
        result.stats["solve_s"] = time.perf_counter() - t0
        return result

    def _race_dispatch_affordable(self, problem: EncodedProblem, refusal: bool = False) -> bool:
        """Race admission: can this bucket's dispatch answer inside the
        budget? Judged by its measured dispatch latency (``AOT_CACHE``) once
        it has one, else by the process's device round trip. ``refusal``
        books a dispatch turned away (the race's own call, not
        ``prestage``'s)."""
        key, mesh = self._bucket_key(problem), self._ensure_mesh()
        pred = AOT_CACHE.predicted_dispatch_s(key, mesh=mesh)
        if pred is None:
            pred = self.device_rtt()
        if pred < self.latency_budget_s:
            return True
        if refusal:
            AOT_CACHE.note_refusal(key, pred, mesh=mesh)
        return False

    def prestage(self, problem: EncodedProblem) -> None:
        """Pad and stage this problem's tensors now, without solving: the
        sharded round calls it right after each cell's encode, so that
        ``stage_fleet`` finds every dirty cell resident and stacks the chunk
        on the device. A no-op for problems the race would not dispatch, and
        on the 1D mesh (its explicit placements are made at dispatch); the 2D
        mesh's problems stage per shard through the stager, as here."""
        from ..parallel import is_mesh2d

        mesh = self._ensure_mesh()
        if (
            problem.G == 0
            or (problem.O == 0 and problem.E == 0)
            or _tensor_path_unsupported(problem) is not None
            or self.latency_budget_s > 1.0
            or int(problem.count.sum()) < self.race_min_pods
            or (mesh is not None and not is_mesh2d(mesh))
        ):
            return
        self._expire_race_memory(problem)
        if (
            problem.__dict__.get("_race_kernel_lost", False)
            or problem.__dict__.get("_race_kernel_result") is not None
            or not self._race_dispatch_affordable(problem)
        ):
            return
        self._device_inputs(problem)

    def warm_problem(self, problem: EncodedProblem, wait: bool = True) -> BucketKey:
        """This problem's bucket (tests, benchmarks and operator warm-up
        call it before a first solve). The port has no per-bucket
        executable to compile: one kernel library serves every bucket and
        is loaded when the solver is constructed, so every bucket is warm
        already and ``wait`` changes nothing."""
        return self._bucket_key(problem)

    def _launch_chain(self, tensors, s_new: int, n_zones: int, side: bool = False) -> _Pending:
        """Enqueue K1, K2, K2, K3 on ``tensors`` and the copy of the result
        to the host, without waiting. ``side`` puts the chain on the solver's
        side stream, ordered after everything already on the current stream
        (staging copies and restage patches); the stager then orders its
        next patch or upload after the chain, so that a resident tensor the
        chain reads is never overwritten under it."""
        stream = None
        mesh = self.mesh
        if side and self._side is not None:
            stream = self._side
            stream.wait_stream(torch.cuda.current_stream(self.device))
            # the allocator must not hand a dropped input's memory to the
            # current stream while the chain still reads it
            for t in (*tensors[0], *tensors[1:]):
                for x in (t.shards if mesh is not None else (t,)):
                    if x.device.type == "cuda":
                        x.record_stream(stream)
        if mesh is not None:
            run = lambda: pack_solve_meshed(mesh, *tensors, s_new, n_zones)  # noqa: E731
        else:
            run = lambda: pack_solve_fused(*tensors, s_new, n_zones)  # noqa: E731
        pending = _Pending.enqueue(run, self.device, stream)
        if stream is not None:
            self._stager.fence(pending.done)
        return pending

    def _dispatch_async(self, problem: EncodedProblem) -> Optional[_Dispatch]:
        """Enqueue the fused kernel chain on the side stream without waiting.
        Returns the dispatch, or None when the race breaker or the bucket's
        quarantine says not to dispatch."""
        if self._race_fails >= 3:
            # the device has not answered inside the budget: the host path
            # owns it, but it is re-probed once per interval
            now = time.monotonic()
            if now < self._race_retry_at:
                return None
            self._race_retry_at = now + self._race_retry_interval_s
        (inputs, orders, swaps, orders_d, alphas_d, looks_d, rsvs_d, swaps_d,
         s_new, n_zones) = self._device_inputs(problem)
        key = self._bucket_key(problem, s_new)
        if not KERNEL_BOARD.allows(key.label()):
            return None
        t_dispatch = time.perf_counter()
        try:
            KERNEL_BOARD.first_dispatch(key, self._ensure_mesh())
            pending = _apply_dispatch_fault(self._launch_chain(
                (inputs, orders_d, alphas_d, looks_d, rsvs_d, swaps_d), s_new, n_zones,
                side=True,
            ))
        except faults.InjectedDeviceError as e:
            # an injected device OOM or compile failure is breaker evidence,
            # and the host path answers this round. Only the injected error
            # is caught: a real launch error raises (the reference's bare
            # ``except Exception`` here is deliberately not copied)
            KERNEL_BOARD.fail(key.label(), _injected_kind(e))
            return None
        return _Dispatch(pending, orders, swaps, s_new, n_zones, inputs, key, t_dispatch)

    def _poll_dispatch(self, problem: EncodedProblem, dispatched, deadline: float,
                       host_cost: float) -> Optional[SolveResult]:
        """Wait (bounded) for an in-flight dispatch and decode it only when
        its member cost already beats the host result."""
        if dispatched is None:
            return None
        if isinstance(dispatched, _FleetDispatch):
            return self._poll_fleet(problem, dispatched, deadline, host_cost)
        pending = dispatched.pending
        # a buffer ready at the first look says only that the card answered
        # sometime during the host path; a transition seen while polling
        # times the dispatch
        ready_at = None
        if pending.is_ready():
            ready_at = 0.0
        else:
            while time.perf_counter() < deadline:
                if pending.is_ready():
                    ready_at = time.perf_counter()
                    break
                time.sleep(0.0005)
        if ready_at is None:
            self._race_fails += 1
            # two deadline misses on the same problem and repeat solves stop
            # waiting on the device for it
            misses = problem.__dict__.get("_race_miss_count", 0) + 1
            problem.__dict__["_race_miss_count"] = misses
            if misses >= 2:
                self._mark_kernel_lost(problem)
            return None
        self._race_fails = 0
        problem.__dict__.pop("_race_miss_count", None)
        raw = pending.materialize()
        if ready_at:
            # an observed transition times the dispatch for the bucket's
            # admission and the sentinel (a buffer ready at the first look
            # times nothing)
            AOT_CACHE.note_dispatch(dispatched.key, ready_at - dispatched.t_dispatch,
                                    mesh=self._ensure_mesh())
            problem.__dict__["_dispatch_s"] = ready_at - dispatched.t_dispatch
        if pending.events is not None:
            problem.__dict__["_dispatch_device_ms"] = pending.device_ms()
        inputs = dispatched.inputs
        unpacked = _apply_result_fault(unpack_solve_fused(
            raw, dispatched.orders.shape[0], dispatched.s_new, inputs.count.shape[0],
            inputs.ex_valid.shape[0], dispatched.orders, dispatched.swaps,
        ))
        return self._judge(problem, unpacked, dispatched.key, host_cost)

    def _poll_fleet(self, problem: EncodedProblem, slot: _FleetDispatch, deadline: float,
                    host_cost: float) -> Optional[SolveResult]:
        """Fleet analogue of ``_poll_dispatch``: wait (bounded) on the shared
        batch buffer, take this problem's row, and decode it only when its
        cost beats the host result. The first cell's poll copies the whole
        batch; every sibling's poll then reads that copy."""
        shared = slot.shared
        ready_at = None
        if shared.is_ready():
            ready_at = 0.0
        elif not shared.abandoned:
            while time.perf_counter() < deadline:
                if shared.is_ready():
                    ready_at = time.perf_counter()
                    break
                time.sleep(0.0005)
        if ready_at is None:
            shared.abandoned = True
            # a fleet miss is bucket evidence, not device evidence: its
            # pessimistic sample backs the fleet bucket's admission off, and
            # the per-cell race breaker is left alone
            shared.note_miss(time.perf_counter())
            misses = problem.__dict__.get("_race_miss_count", 0) + 1
            problem.__dict__["_race_miss_count"] = misses
            if misses >= 2:
                self._mark_kernel_lost(problem)
            return None
        self._race_fails = 0
        problem.__dict__.pop("_race_miss_count", None)
        raw = shared.materialize()[slot.row]
        key = shared.key
        if ready_at:
            shared.note_ready(ready_at)
            problem.__dict__["_dispatch_s"] = ready_at - shared.t_dispatch
        if shared.pending.events is not None:
            problem.__dict__["_dispatch_device_ms"] = shared.device_ms()
        unpacked = _apply_result_fault(unpack_solve_fused(
            raw, slot.orders.shape[0], slot.s_new, key.G, key.E, slot.orders, slot.swaps
        ))
        result = self._judge(problem, unpacked, key, host_cost)
        if result is not None:
            result.stats["fleet_b"] = float(key.B)
            result.stats["fleet_bucket"] = key.label()
        return result

    def _judge(self, problem: EncodedProblem, unpacked, key: BucketKey,
               host_cost: float) -> Optional[SolveResult]:
        """The race's verdict on a kernel answer that arrived in time: None
        when it is non-finite (breaker evidence), leaves pods unplaced, costs
        no less than the host answer, or fails validation; else the decoded
        plan. A losing answer is remembered on the problem."""
        order, unplaced, costs, exhausted, new_opt, new_active, ys = unpacked
        label = key.label()
        if not np.isfinite(np.asarray(costs, dtype=np.float64)).all():
            # breaker evidence before any comparison: decode recomputes cost
            # from real prices and would launder a degenerate plan
            KERNEL_BOARD.fail(label, "nonfinite-plan")
            self._mark_kernel_lost(problem)
            return None
        if unplaced > 0 or costs.min() >= host_cost:
            # the device answered and lost on quality. A half-open breaker
            # still needs its probe settled: a finite, in-time, count-valid
            # answer is health evidence even when the host plan is cheaper
            if KERNEL_BOARD.state(label) != "closed":
                if validate_counts(problem, order, new_opt, new_active, ys):
                    KERNEL_BOARD.fail(label, "invalid-plan")
                else:
                    KERNEL_BOARD.ok(label)
            self._mark_kernel_lost(problem)
            return None
        if validate_counts(problem, order, new_opt, new_active, ys):
            KERNEL_BOARD.fail(label, "invalid-plan")
            self._mark_kernel_lost(problem)
            return None
        KERNEL_BOARD.ok(label)
        result = self._decode(problem, order, new_opt, new_active, ys)
        k = len(costs) // 2
        idx = int(np.argmin(costs))
        result.stats.update(
            backend=1.0, portfolio_phase=float(idx >= k), portfolio_best=float(idx % k),
            validated_counts=1.0, slots=float(new_opt.shape[0]), bucket=label,
        )
        return result

    def _solve_kernel(self, problem: EncodedProblem) -> Optional[SolveResult]:
        """Solve on the resident tensors synchronously, doubling the slot
        budget while members run out of slots. None when the bucket is
        quarantined, the plan is non-finite, or the fetch timed out; a plan
        that fails validation is answered by the greedy oracle."""
        t0 = time.perf_counter()
        (inputs, orders, swaps, orders_d, alphas_d, looks_d, rsvs_d, swaps_d,
         s_new, n_zones) = self._device_inputs(problem)
        t1 = time.perf_counter()
        try:
            run = self._run_fused(
                (inputs, orders_d, alphas_d, looks_d, rsvs_d, swaps_d), orders, swaps,
                s_new, n_zones, problem,
            )
        except KernelDispatchTimeout:
            # the host fallback answers this round instead of blocking it
            KERNEL_BOARD.fail(self._bucket_key(problem).label(), "dispatch-timeout")
            return None
        except faults.InjectedDeviceError as e:
            # an injected device OOM or compile failure: breaker evidence,
            # and the host answers. Any other error raises (the reference's
            # ``except Exception`` is deliberately not copied)
            KERNEL_BOARD.fail(self._bucket_key(problem).label(), _injected_kind(e))
            return None
        if run is None:
            return None  # quarantined bucket: the host paths answer
        unpacked, s_new, passes = run
        t2 = time.perf_counter()
        order, unplaced, costs, exhausted, new_opt, new_active, ys = unpacked
        label = self._bucket_key(problem, s_new).label()
        if not np.isfinite(np.asarray(costs, dtype=np.float64)).all():
            # refuse to decode a non-finite plan
            KERNEL_BOARD.fail(label, "nonfinite-plan")
            return None
        violations = validate_counts(problem, order, new_opt, new_active, ys)
        if violations:
            KERNEL_BOARD.fail(label, "invalid-plan")
            result = self._fallback.solve(problem)
            result.stats["fallback"] = 1.0
            result.stats["tpu_violations"] = float(len(violations))
            return result
        KERNEL_BOARD.ok(label)
        t3 = time.perf_counter()
        result = self._decode(problem, order, new_opt, new_active, ys)
        t4 = time.perf_counter()
        # host-clock phases: padding, portfolio construction and staging; the
        # fused passes and their result copies; count-level validation; decode
        result.stats.update(
            prepare_s=t1 - t0, device_s=t2 - t1, validate_s=t3 - t2, decode_s=t4 - t3,
            solve_s=t2 - t0, backend=1.0, fused_passes=float(passes),
        )
        k = len(costs) // 2
        idx = int(np.argmin(costs))
        result.stats["portfolio_phase"] = float(idx >= k)
        result.stats["portfolio_best"] = float(idx % k)
        result.stats["validated_counts"] = 1.0
        result.stats["slots"] = float(s_new)
        result.stats["bucket"] = label
        return result

    def _run_fused(self, tensors, orders: np.ndarray, swaps: np.ndarray, s_new: int,
                   n_zones: int, problem: Optional[EncodedProblem] = None):
        """The fused solve on ``tensors`` (``(PackInputs, orders, alphas,
        looks, rsvs, swaps)`` on the device), doubling the slot budget while
        members ran out of slots; with ``problem``, its resident entry
        follows the budget, a pass whose bucket is quarantined ends the
        solve (None), and each pass consults the compile seam and feeds the
        bucket's dispatch latency (``AOT_CACHE``, and the sentinel through
        it). The dispatch and result fault seams apply to every pass.
        Returns the unpacked result, the slot budget it was solved at and
        the number of fused passes it took."""
        inputs = tensors[0]
        k, Gp, Ep = orders.shape[0], inputs.count.shape[0], inputs.ex_valid.shape[0]
        passes = 0
        mesh = self._ensure_mesh()
        while True:
            key = None if problem is None else self._bucket_key(problem, s_new)
            if key is not None:
                if not KERNEL_BOARD.allows(key.label()):
                    return None
                KERNEL_BOARD.first_dispatch(key, mesh)
            passes += 1
            t_dispatch = time.perf_counter()
            buf = _fetch_bounded(
                _apply_dispatch_fault(self._launch_chain(tensors, s_new, n_zones)),
                self.dispatch_timeout_s,
            )
            if key is not None:
                dispatch_s = time.perf_counter() - t_dispatch
                AOT_CACHE.note_dispatch(key, dispatch_s, mesh=mesh)
                problem.__dict__["_dispatch_s"] = dispatch_s
            unpacked = _apply_result_fault(
                unpack_solve_fused(buf, k, s_new, Gp, Ep, orders, swaps))
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
        with self._cache_lock:
            cached = self._device_cache.get(id(problem))
        return cached if cached is not None and cached[0] is problem else None

    def _set_slots(self, problem: EncodedProblem, s_new: int) -> None:
        with self._cache_lock:
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
        # numpy copies for the host FFD competitor; its shared precompute
        # slot fills on first use
        with self._cache_lock:
            self._host_cache.clear()
            self._host_cache[id(problem)] = (
                problem, PackInputs(**fields), orders, alphas, looks, s_new, n_zones, [None],
            )
        t_stage = time.perf_counter()
        leaves = dict(fields, orders=orders, alphas=alphas, looks=looks, rsvs=rsvs, swaps=swaps)
        Gp, R = fields["demand"].shape
        tag = ("cell", Gp, fields["price"].shape[0], fields["ex_valid"].shape[0],
               fields["rel_zone_bits"].shape[0], R, orders.shape[0])
        mesh = self._ensure_mesh()
        from ..parallel import is_mesh2d, mesh_axes_label, mesh_sharding, shard_portfolio
        from ..parallel.mesh import device_put

        if mesh is not None and not is_mesh2d(mesh):
            # the 1D mesh: members split over the shards, the problem
            # replicated, placed outside the stager
            placed = shard_portfolio(mesh, PackInputs(**fields), orders, alphas, looks, rsvs, swaps)
            staged = dict(zip(PackInputs._fields, placed[0]))
            staged.update(zip(_MEMBER_LEAVES, placed[1:]))
        elif mesh is not None:
            # the 2D mesh: per-shard staging, each full upload placed by the
            # rule table, so that the resident leaves lie split over the mesh
            # and a restage moves only churned rows, each on its shard
            staged = self._stager.stage(
                ("cell2d", mesh_axes_label(mesh)) + tag[1:], leaves,
                put=lambda name, arr: device_put(arr, mesh_sharding(mesh, name, np.shape(arr))),
            )
        else:
            staged = self._stager.stage(tag, leaves)
        # accrued across prestage and the solve's own staging; solve_pods
        # reports it as ``stage_s``
        stage_s = time.perf_counter() - t_stage
        problem.__dict__["_stage_s"] = problem.__dict__.get("_stage_s", 0.0) + stage_s
        _observe_phase(problem, "stage", stage_s)
        entry = (
            problem, PackInputs(*(staged[f] for f in PackInputs._fields)), orders, swaps,
            *(staged[f] for f in _MEMBER_LEAVES), s_new, n_zones,
        )
        with self._cache_lock:
            self._device_cache.clear()  # hold at most one problem resident
            self._device_cache[id(problem)] = entry
        return entry[1:]

    def _cached_s_new(self, problem: EncodedProblem) -> int:
        """The problem's current slot budget: the resident entry's (grown by
        the doubling), else the estimate."""
        cached = self._resident(problem)
        return cached[9] if cached is not None else self._estimate_slots(problem)

    def _bucket_key(self, problem: EncodedProblem, s_new: Optional[int] = None) -> BucketKey:
        return self._mesh_stamp(bucket_key(
            problem.G, problem.O, problem.E,
            self._cached_s_new(problem) if s_new is None else s_new,
            max(len(problem.zones), 1), len(problem.resource_axes), self._portfolio_k(),
        ))

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
        k = self._portfolio_k()
        memo_key = (
            bucket.G if bucket else bucket_groups(problem.G),
            bucket.O if bucket else self._options_pad(problem.O),
            bucket.E if bucket else bucket_existing(problem.E),
            bucket.Z if bucket else bucket_zones(max(len(problem.zones), 1)),
            self.seed, k,
        )
        memo = problem.__dict__.get("_prep_memo")
        if memo is not None and memo[0] == memo_key:
            return memo[1] + (s_new, memo[2])
        t_presolve = time.perf_counter()
        G, O, E, R = problem.G, problem.O, problem.E, len(problem.resource_axes)
        Gp = bucket.G if bucket else bucket_groups(G)
        Op = bucket.O if bucket else self._options_pad(O)
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
            sizes, count.astype(np.float64), k, self.seed, layer=layer,
            has_reserve=demand_units is not demand,
        )
        out = (fields, orders, alphas, looks, rsvs, swaps)
        problem.__dict__["_prep_memo"] = (memo_key, out, Zp)
        _observe_phase(problem, "presolve", time.perf_counter() - t_presolve)
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
        t_decode = time.perf_counter()
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
        _observe_phase(problem, "decode", time.perf_counter() - t_decode)
        return SolveResult(
            new_nodes=new_nodes,
            existing_assignments=existing_assignments,
            unschedulable=unschedulable,
            cost=cost,
            stats={"nodes_opened": float(len(new_nodes))},
        )
