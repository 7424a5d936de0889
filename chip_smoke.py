"""Drive the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and nvcc, and imports nothing of JAX. ``python3 chip_smoke.py
--compare DIR`` instead times this checkout's K1 and K3 against those of
the checkout at DIR (built from its own sources), in one process, at each
config and on the fleet bucket at B=1, 4, 8 and 16, in turns DIR, this,
this, DIR, with the chain and each of its kernels (``compare``). Phases:

1. device: CUDA must be present; prints the card's name and power limit;
2. build: compiles ``karpenter_tpu_torch/solver/csrc/*.cu`` with nvcc for
   sm_90a, one nvcc per source, started together, and links them into one
   library under ``build/kernels/`` (keyed by a hash of the sources);
3. kernel parity: on each of the three flat problems below, at the slot
   budget its solve reaches, each packing kernel against its plain PyTorch
   version on the card (K1 and K3 bit for bit); the three again on 50k_full
   cut to 26 groups and 2,310 options, a multiple of none of K1's tiles;
   K3 and K2's phase-2 seed on member costs holding NaN, +-inf and ties;
   one chain's device events in a profiler trace, which must be K1, K2, K2
   and K3's own kernels and nothing else; K2 again where its per-step
   state lies in global memory: 10k_topology at S=8192, 50k_full at the least S whose state
   does not fit beside the scan's static shared memory, and 10k_topology
   with its staged groups in global memory too; K2's breakdown at 50k_full
   and 10k_topology (phase 1, phase 1 without lookahead, phase 2, member by
   member, and each of its two kernels from a profiler trace); then
   CUDA-event timings at the 50k_full shapes (one warm-up, median of five);
4. kernel-only solves: ``TorchSolver()._solve_kernel`` on 50k_full,
   10k_topology and 10k_crossgroup must validate and cost what the JAX
   package's kernel computes (the pinned costs);
5. ``rtt_probe`` against ``x + 1`` on the card, its time beside
   ``torch.add``'s, and ``device_rtt``;
6. flat race (main path): ``TorchSolver().solve`` in latency mode (budget
   0.1 s) on the same three configs, a first solve and a repeat on the same
   problem object, launch counts taken around the phase and each solve. The
   first solve must dispatch the kernel on the side stream and have it
   answer before the deadline; the repeat must launch no kernel; every plan
   must validate and cost at most the kernel-only answer; no solve may show
   a fallback, a refused kernel plan, breaker evidence or a missed deadline;
7. hazard: a side-stream dispatch held behind a spin while the same stager
   restages a churned copy of its problem in place; its buffer must be the
   plain chain's on the original inputs;
8. fleet kernel parity: five distinct cells of the 500k-pod fleet (the seed
   cell and the cells of churn rounds 0-3) and three pad rows stacked on one
   bucket (B=8): the batched K1, K2 and K3 row by row against their plain
   versions, every row of the batched chain equal to that problem's B=1
   buffer, the pad rows costing 0; the eight rows twice over at B=16, K1 and
   K3 bit for bit on every row and the chain's device events;
   ``fleet_stack`` against ``torch.stack`` and a ``stage_patch`` restage
   against ``index_copy_``; K1's breakdown (its two kernels from a
   profiler trace) at 50k_full, 10k_topology and on the fleet bucket at B=1
   and 16; then timings of
   the chain at B=1, 4, 8 and 16, of ``fleet_stack`` for a B=16 chunk and of
   one churned cell's ``stage_patch`` restage;
9. fleet race (main path): the sharded round on 20 per-cell
   ``TorchSolver``s over the 500k-pod fleet: a seed round (two dispatches,
   B=16 and B=4), two churn rounds (``stage_patch`` restages, device-side
   stacks), and one churn round through one shared solver (the host-stacked
   branch, whose buffers must equal the device-stacked ones); each cell's
   ``solve`` races its row; launch counts taken around it. After each
   round, every dispatch's ``[B, L]`` buffer is held row by row against the
   plain version on the inputs it was given, at its own B and S, and every
   device-side stack against ``torch.stack``. Every plan must validate and
   cost at most the kernel-only answer, and every row that left pods
   unplaced must have lost its race;
10. reconcile, 50k pods (main path): ``TorchSolver().solve_pods`` with an
    ``EncodeSession`` on ``configs.config_delta_reconcile``: a seed round
    (full encode), eight churn rounds fed as watch events (each must
    delta-encode), and a repeat round with no events, which must hit the
    solver's intern slot and stage nothing. Every round's problem must
    have the digest of a full encode of the session's pods, and its plan
    must validate, show nothing ``hold_race`` refuses and cost at most the
    kernel-only answer of the same problem; the last churn round's
    kernel-only cost must be the JAX package's;
11. reconcile, sharded (main path): the 500k-pod fleet afresh, each cell
    with its own session, through the controller's flow
    (``encode_for_staging`` and ``prestage`` per dirty cell, one
    ``stage_fleet``, ``solve_pods(pre_encoded=...)`` per cell) for the
    seed round and churn rounds 0-1, and through one shared solver's
    ``solve_fleet`` for round 2. Churn rounds must delta-encode, each
    cell's problem must equal a full encode of its session's pods and of
    the cell's own, the fleet widths must be the fleet race's, and every
    plan must validate and cost at most its pinned kernel-only cost. Each
    of these two phases logs its launch counts and fails unless K1, K2 and
    K3 launched in it;
12. provisioning controller (main path): ``ProvisioningController`` with
    its default ``TorchSolver()`` over ``configs.config_controller_reconcile``
    (50k pending pods, 400 types): a seed round, then eight churn rounds
    applied through the cluster, whose watch events feed the controller's
    session. Every round must bind every pending pod within its nodes'
    allocatable with no plan rejected by the firewall, solve the problem a
    full encode of the session's pods gives, in the session mode
    ``configs.CONTROLLER_CHURN_MODES`` names; the seed round's kernel-only
    cost must be the JAX package's and its plan cost at most that. K1, K2
    and K3 must launch, and on the first
    churn round's problem, at its real existing-node count, they are held
    against their plain versions (``check``), with K2's memory plan logged;
13. sharded provisioning controller (main path): ``ProvisioningController``
    with its default ``TorchSolver()`` and ``cell_sharding_enabled`` over
    ``configs.config_controller_cells`` (500k pending pods in 20 cells, 60
    types, 8 workers): a seed round, whose 20 cells must each be the
    ``config_cells`` problem, batched in two fleet dispatches (b16, b4)
    with the launches ``SHARDED_SEED_LAUNCHES`` names, then churn rounds
    0-2 in the modes ``SHARDED_CHURN_MODES`` names; every round binds every
    pending pod within allocatable, with no plan rejected, each cell's
    problem equal to a full encode of its session's pods, each fleet row
    equal to the plain chain and each fleet buffer copied to the host
    once (``sharded_round``); then the same config at 16k pods in 8 cells
    at 1 worker and at 8, which must agree on digests and launches;
14. deprovisioning (main path): ``DeprovisioningController`` on the
    provisioning controller's default ``TorchSolver()``, with its
    quality-mode ``TorchSolver`` for what-ifs of 500 pods and more, over
    ``configs.config_consolidation``, pass by pass as the JAX package's
    ``bench.bench_consolidation`` runs it: three passes on BASELINE's
    2,000-node, 20,000-pod fleet, whose first what-if (the whole fleet
    re-placed) must be ``configs.config_consolidation_sim()`` at the JAX
    package's kernel-only cost, with K1, K2 and K3 held against their plain
    versions on it; ``bench.py``'s 300 x 3 fleet to quiescence; drift on
    that cluster after an image rotation until every node runs the new
    image; and the single-node sweep fixture ``configs.config_sweep`` at 1
    worker and at 8, which must delete the same node. Every pass binds
    every pod within allocatable, never raises the fleet's $/h, shows no
    fallback, breaker evidence or missed deadline, and every quality sim
    launches K1, K2 twice and K3 and answers with a validated kernel plan;
15. the operator (main path): ``Operator.new`` with no solver given over
    ``configs.config_operator`` (50k pending pods, 400 types, spot and
    on-demand through the node template ``al2-tpl``), step by step: the seed
    round (every instance from an ``al2`` launch template, the problem
    ``configs.config_operator_seed()``'s at the JAX package's kernel-only
    cost, K1, K2 and K3 held against their plain versions on it), an
    interruption storm on the most loaded 10% of the spot nodes until the
    queue drains
    (each step re-binds what it drained, never onto an offering the storm
    marked unavailable; K1, K2, K3 and ``rtt_probe`` must launch), three
    template-drift passes after an image rotation, each replacing one node
    on the new image; then ``python -m karpenter_tpu_torch`` in a
    subprocess on the card, which must answer its probes, serve /metrics
    and exit 0 on SIGTERM with its lease released (``operator_phase``);
16. the operator's HTTP tier (main path, ``http_tier_phase``): (a) one
    operator over the wire in process: a ``ClusterAPIServer`` whose store
    is ``configs.config_http_tier()``'s (10,000 pending pods, the ``al2-tpl``
    template, the spot and on-demand provisioner), a ``CloudHTTPService``
    over 400 types, and ``Operator.new(provider=HTTPCloudProvider(...),
    cluster=HTTPCluster(...))`` with no solver given: the seed step (the
    problem ``configs.config_http_seed()``'s at the JAX package's
    kernel-only cost, K1, K2 and K3 held against their plain versions on
    it), a churn step through a second client (delta-encoded from the
    watch) and a spot interruption of the most loaded spot node over
    ``/v1/queue/*``; after each step, read from the server's store, every
    pod is bound within allocatable, no plan was rejected, no client token
    committed twice, and the cloud's instances are the store's machines;
    each step's wall is split into relist, solve, launches and binds over
    HTTP and capture; (b) the HA pair: ``python -m
    karpenter_tpu_torch.state.apiserver`` and two ``python -m
    karpenter_tpu_torch --leader-elect`` replicas on the card; exactly one
    leads and binds a wave of 1,000 pods, the standby takes over within
    one lease and one acquire poll of the leader's SIGKILL and binds a
    second wave, no pod is bound twice and no token committed twice, each
    leader's /metrics shows a closed kernel breaker (its race dispatched on
    the card) and no kernel fault, and the survivor exits 0 on SIGTERM;
17. replay (main path): the flight recorder runs at its default (on, 32
    capsules) through phases 12-16, and every controller round and
    operator step logs its capture seconds beside its wall. Five capsules
    those phases recorded (``REPLAYS``: controller_50k's seed round and
    churn round 0, the operator's first storm step, the sharded worker
    check at 1 worker, consolidation_300's pass 0) are replayed by
    ``replay_capsule(capsule, solver="torch-quality")`` on the card after
    a JSON round trip, and must match (``replay_phase``, which names the
    one divergence it allows); K1, K2 and K3 are held against their plain
    versions on the seed round's rebuilt problem; then
    ``python -m karpenter_tpu_torch.replay`` runs in a subprocess on the
    seed round's dump and, as a counterfactual, on the storm step's with
    its masked offering made available; both must exit 0;
18. one JSON line of kernel results, the card's name and power limit, and
    the device JSON as the last line.

Before any encode, the native encoder (``karpenter_tpu_torch/native``)
must have built; its build time is logged.

Any failure exits non-zero with its traceback; nothing falls back to the CPU.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import shutil
import statistics
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
PACK_KERNELS = ("shared_precompute", "pack_member", "pack_epilogue")
COST_RTOL = 1e-6  # slice costs against the JAX package's
MEMBER_COST_RTOL = 1e-5  # f32 member-cost sums, taken in another order than the plain version's
NEAR_TIE_RTOL = 1e-6  # rule for comparing fused buffers, see fused_agree()
SPIN_CYCLES = 100_000_000  # ~50 ms of GPU clock, longer than a window's host work


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, per: int = 10, reps: int = 5) -> float:
    """Device time of one call of ``fn``: median over ``reps`` windows of
    ``per`` back-to-back calls, after one warm-up call. Each window starts
    behind a spin on the card, so the host queues the calls while the card
    is busy and the events time the device alone, not the wrappers' host
    work (a plain version that synchronises inside still pays its own)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    return statistics.median(times)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: float, ops: float) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def fused_agree(buf_a, buf_b, k: int) -> str:
    """Compare two fused buffers. Integer fields must be equal, unless the
    two lowest member costs are within NEAR_TIE_RTOL (the f32 member sums
    are taken in different orders); such a near-tie returns "near-tie" and
    the caller holds the decoded plans to the slice checks instead."""
    import numpy as np

    a = buf_a.cpu().numpy()
    b = buf_b.cpu().numpy()
    costs = np.sort(np.frombuffer(a[4 : 4 + 2 * k].tobytes(), np.float32).astype(np.float64))
    cb = np.frombuffer(b[4 : 4 + 2 * k].tobytes(), np.float32).astype(np.float64)
    ca = np.frombuffer(a[4 : 4 + 2 * k].tobytes(), np.float32).astype(np.float64)
    if not np.allclose(ca, cb, rtol=MEMBER_COST_RTOL, atol=0):
        raise AssertionError(f"member costs differ: {ca} vs {cb}")
    ints_a = np.delete(a, np.s_[4 : 4 + 2 * k])
    ints_b = np.delete(b, np.s_[4 : 4 + 2 * k])
    if np.array_equal(ints_a, ints_b):
        return "equal"
    if abs(costs[1] - costs[0]) <= NEAR_TIE_RTOL * abs(costs[0]):
        return "near-tie"
    raise AssertionError(f"fused buffers differ at {np.flatnonzero(ints_a != ints_b)[:8]}")


def device_problem(ts, solver, problem, bucket=None):
    """``(PackInputs, orders, alphas, looks, rsvs, swaps)`` of a problem on
    the card, uploaded whole (the stager is the solver's own business)."""
    fields, orders, alphas, looks, rsvs, swaps, _, _ = solver._prepare(problem, bucket=bucket)
    return ts.pack_inputs_from_numpy(
        dict(fields, orders=orders, alphas=alphas, looks=looks, rsvs=rsvs, swaps=swaps), "cuda"
    )


def check(ts, name, problem, solver) -> dict:
    """Each kernel against its plain version on the card, at the slot
    budget the main path reaches on this problem. Returns what the timings
    need and the largest differences seen."""
    import torch

    _, orders, _, _, _, swaps, s_new, nz = solver._prepare(problem)
    tensors = device_problem(ts, solver, problem)
    _, S, _ = solver._run_fused(tensors, orders, swaps, s_new, nz)
    inputs, o, a, l, r, sw = tensors
    G, O, E, R, Z = ts._dims(inputs)
    K = o.shape[0]
    log(f"check {name}: G={G} O={O} E={E} R={R} Z={Z} K={K} S={S}")

    # K1, every field bit for bit
    sk = ts.shared_precompute(inputs, S, nz)
    k1_err = hold_shared(name, sk, ts.shared_precompute_ref(inputs, S, nz))

    # K2, both phases
    mk = ts.pack_member(inputs, sk, o, a, l, r, S, nz)
    mr = ts.pack_member_ref(inputs, sk, o, a, l, r, S, nz)
    mk2 = ts.pack_member(inputs, sk, o, a, l, r, S, nz, swaps=sw, seed_costs=mk.cost)
    o2, a2, l2, r2 = ts.phase2_members(o, a, l, r, sw, mk.cost)
    mr2 = ts.pack_member_ref(inputs, sk, o2, a2, l2, r2, S, nz)
    k2_err = max(hold_members(f"{name} phase 1", mk, mr), hold_members(f"{name} phase 2", mk2, mr2))

    # K3, bit for bit
    hold_epilogue(ts, name, mk, mk2)
    bk = ts.pack_epilogue(mk, mk2)
    k3_err = 0.0

    # K1-K2-K2-K3 against the whole plain program
    verdict = fused_agree(
        ts.pack_solve_fused(inputs, o, a, l, r, sw, S, nz),
        ts.pack_solve_fused_ref(inputs, o, a, l, r, sw, S, nz), K,
    )
    log(f"check {name}: K1 max_abs_err={k1_err} K2 max_abs_err={k2_err} "
        f"K3 max_abs_err={k3_err} fused={verdict}")
    return dict(tensors=tensors, S=S, nz=nz, sk=sk, mk=mk, mk2=mk2, bk=bk, errs={
        "shared_precompute": k1_err, "pack_member": k2_err, "pack_epilogue": k3_err,
    })


def k1_op_count(G: int, O: int, R: int) -> int:
    """K1's f32 operations: unit counts, residuals and the val_pair table."""
    return 2 * G * O * R * 3 + G * O * G * R * 5 + G * O * G * 3


def k2_op_count(inputs, looks, S: int) -> int:
    """One K2 launch's operations on this data: the lookahead prices of the
    members that look ahead, and per member the steps of groups with pods
    (three option sweeps and one slot sweep each)."""
    G, R = inputs.demand.shape[-2:]
    O, E = inputs.price.shape[-1], inputs.ex_rem.shape[-2]
    K = looks.shape[-1]
    t_real = int((inputs.count > 0).sum())
    return int(looks.sum()) * G * O * G * 2 + K * t_real * (3 * 2 * O * 3 + (E + S) * (4 * R + 20))


def timings(ts, c: dict, errs: dict) -> list:
    """Kernel, plain-version and bound times at one problem's shapes;
    ``errs`` holds the largest differences over every checked problem."""
    inputs, o, a, l, r, sw = c["tensors"]
    S, nz, sk, mk, mk2, bk = c["S"], c["nz"], c["sk"], c["mk"], c["mk2"], c["bk"]
    G, O, E, R, Z = ts._dims(inputs)
    K, NS = o.shape[0], E + S

    ms = {
        "shared_precompute": time_ms(lambda: ts.shared_precompute(inputs, S, nz)),
        "pack_member": time_ms(lambda: ts.pack_member(inputs, sk, o, a, l, r, S, nz)),
        "pack_epilogue": time_ms(lambda: ts.pack_epilogue(mk, mk2)),
    }
    plain_ms = {
        "shared_precompute": time_ms(lambda: ts.shared_precompute_ref(inputs, S, nz), per=1),
        "pack_member": time_ms(lambda: ts.pack_member_ref(inputs, sk, o, a, l, r, S, nz), per=1),
        "pack_epilogue": time_ms(lambda: ts.pack_epilogue_ref(mk, mk2), per=1),
    }
    fused_ms = time_ms(lambda: ts.pack_solve_fused(inputs, o, a, l, r, sw, S, nz))
    log(f"timing: fused K1+K2+K2+K3 {fused_ms:.4f} ms")
    for name in ms:
        log(f"  {name}: kernel {ms[name]:.4f} ms, plain, not a yardstick, {plain_ms[name]:.4f} ms")

    # least time for the same work: each input read once, each output written once
    k1_in = nbytes(inputs.demand, inputs.demand_units, inputs.count, inputs.node_cap,
                   inputs.quota, inputs.colocate, inputs.compat, inputs.alloc, inputs.price,
                   inputs.opt_valid, inputs.ex_compat, inputs.ex_valid)
    k1_out = nbytes(sk.units, sk.units_rsv, sk.rsv_group, sk.lam, sk.zone_limited,
                    sk.val_pair, sk.exok_pad)
    k1_ops = k1_op_count(G, O, R)
    looks_used = bool(l.any())
    k2_in = nbytes(inputs.demand, inputs.demand_units, inputs.count, inputs.node_cap,
                   inputs.colocate, inputs.compat, inputs.alloc, inputs.price,
                   inputs.opt_zone, sk.units, sk.units_rsv, sk.quota, sk.exok_pad, o, a, l, r)
    k2_in += nbytes(sk.val_pair) if looks_used else 0
    k2_out = nbytes(mk.cost, mk.unplaced, mk.exhausted, mk.new_opt, mk.new_active, mk.ys)
    k2_ops = k2_op_count(inputs, l, S)
    k3_in = nbytes(mk.cost, mk2.cost, mk.exhausted, mk2.exhausted) + nbytes(mk.new_opt[0], mk.new_active[0], mk.ys[0])
    k3_out = nbytes(bk)
    bounds = {
        "shared_precompute": bound(k1_in + k1_out, k1_ops),
        "pack_member": bound(k2_in + k2_out, k2_ops),
        "pack_epilogue": bound(k3_in + k3_out, 2 * K),
    }
    replaces = {
        "shared_precompute": "karpenter_tpu/solver/jax_solver.py:193",
        "pack_member": "karpenter_tpu/solver/jax_solver.py:295",
        "pack_epilogue": "karpenter_tpu/solver/jax_solver.py:538",
    }
    return [
        {
            "name": name, "route": "cuda",
            "source": "karpenter_tpu_torch/solver/csrc/pack_solve.cu",
            "replaces": replaces[name], "launches": None, "max_abs_err": errs[name],
            "ms": ms[name], "plain_ms": plain_ms[name], "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1], "library_ms": None,
        }
        for name in ms
    ]


def hold_shared(tag, got, want) -> float:
    """K1's outputs against the plain version's, every field bit for bit.
    Returns the largest difference (0)."""
    import torch

    for f in got._fields:
        if not torch.equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(f"{tag}: K1 {f} differs from the plain version")
    return max(max_err(got.lam, want.lam), max_err(got.val_pair, want.val_pair))


def hold_members(tag, got, want) -> float:
    """K2's outputs against the plain version's: integers equal, member costs
    within MEMBER_COST_RTOL. Returns the largest cost difference."""
    import torch

    for f in ("unplaced", "exhausted", "new_opt", "new_active", "ys"):
        if not torch.equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(f"{tag}: K2 {f} differs from the plain version")
    if not torch.allclose(got.cost, want.cost, rtol=MEMBER_COST_RTOL, atol=0):
        raise AssertionError(f"{tag}: K2 costs {got.cost.tolist()} vs {want.cost.tolist()}")
    return max_err(got.cost, want.cost)


def first_spill_s(ts, lib, inputs) -> int:
    """The least slot budget at which K2's per-step state no longer fits in
    the card's shared memory beside the scan's static shared memory."""
    G, O, E, R, Z = ts._dims(inputs)
    lo, hi = 1, 1 << 16  # the state fits at lo, not at hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if ts.pack_member_scratch(lib, G, O, R, Z, E + mid) else (mid, hi)
    return hi


def least_smem_limit(ts, lib, inputs, S: int) -> int:
    """The least shared memory a block under which K2 still has a plan: its
    partials alone in shared memory, the staged groups and the per-step
    state in global scratch."""
    G, O, E, R, Z = ts._dims(inputs)
    lo, hi = 0, 1 << 18  # no plan at lo, one at hi

    def fits(limit):
        try:
            ts.pack_member_scratch(lib, G, O, R, Z, E + S, limit)
            return True
        except RuntimeError:
            return False

    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if fits(mid) else (mid, hi)
    return hi


def k2_global_check(ts, problems, solver) -> float:
    """K2 with its scan's memory partly in global memory, both phases
    against the plain version: 10k_topology at S=8192 (the per-step state
    there); 50k_full at the least S whose state does not fit in shared
    memory (an S at which the scan's memory fits only if its static shared
    memory is left out); and 10k_topology at S=1024 planned against the
    least shared memory that has a plan (the staged groups there too, as
    for more groups than a block's shared memory holds). Returns the largest
    cost difference."""
    from karpenter_tpu_torch.solver import _build

    lib = _build.load_kernels()
    err = 0.0
    for name, S, least in (("10k_topology", 8192, False), ("50k_full", None, False),
                           ("10k_topology", 1024, True)):
        inputs, o, a, l, r, sw = device_problem(ts, solver, problems[name][0])
        G, O, E, R, Z = ts._dims(inputs)
        S = S or first_spill_s(ts, lib, inputs)
        limit = least_smem_limit(ts, lib, inputs, S) if least else None
        scratch = ts.pack_member_scratch(lib, G, O, R, Z, E + S, limit)
        if not scratch:
            raise AssertionError(f"{name} S={S}: K2's scan memory fits in shared memory")
        sk = ts.shared_precompute(inputs, S, Z)
        m1 = ts._launch_pack_member(lib, inputs, sk, o, a, l, r, S, None, None, ts._stream(),
                                    smem_limit=limit)
        m2 = ts._launch_pack_member(lib, inputs, sk, o, a, l, r, S, sw, m1.cost, ts._stream(),
                                    smem_limit=limit)
        where = f"{name} S={S}" + (f" in {limit} B of shared memory" if least else "")
        err = max(err, hold_members(f"{where}, phase 1", m1,
                                    ts.pack_member_ref(inputs, sk, o, a, l, r, S, Z)))
        o2, a2, l2, r2 = ts.phase2_members(o, a, l, r, sw, m1.cost)
        err = max(err, hold_members(f"{where}, phase 2", m2,
                                    ts.pack_member_ref(inputs, sk, o2, a2, l2, r2, S, Z)))
        log(f"k2 global memory: {where} ({scratch} bytes of global scratch a member): "
            f"both phases equal to the plain version, max_abs_err={err}")
    return err


GROUP_FIELDS = ("demand", "demand_units", "count", "node_cap", "quota", "colocate", "ex_compat",
                "rel_set", "rel_host_forbid", "rel_host_need", "rel_zone_forbid", "rel_zone_need")
OPTION_FIELDS = ("alloc", "price", "opt_zone", "opt_valid")


def shrink(ts, tensors, G: int, O: int):
    """A problem's device tuple cut to its first G groups and O options; each
    order and swap pattern keeps its entries below G, in their order, so
    each is a permutation of range(G) again."""
    import torch

    inputs, o, a, l, r, sw = tensors
    cut = {}
    for f in inputs._fields:
        x = getattr(inputs, f)
        if f == "compat":
            x = x[:G, :O]
        elif f in GROUP_FIELDS:
            x = x[:G]
        elif f in OPTION_FIELDS:
            x = x[:O]
        cut[f] = x.contiguous()

    def keep(m):
        return torch.stack([row[row < G] for row in m]).contiguous()

    return (type(inputs)(**cut), keep(o), a, l, r, keep(sw))


def awkward_check(ts, problem, solver, G: int, O: int) -> None:
    """K1, K2 and K3 against their plain versions on a problem cut to G
    groups and O options, neither a multiple of the kernels' tiles (K1's
    256 and 64 options, its chunks of 64 groups, a warp): K1 and K3 bit for
    bit, K2's integers equal."""
    _, orders, _, _, _, swaps, s_new, nz = solver._prepare(problem)
    tensors = device_problem(ts, solver, problem)
    _, S, _ = solver._run_fused(tensors, orders, swaps, s_new, nz)
    inputs, o, a, l, r, sw = shrink(ts, tensors, G, O)
    if G % 32 == 0 or O % 64 == 0 or int((inputs.count > 0).sum()) == 0:
        raise AssertionError(f"the awkward shape G={G} O={O} is not awkward")
    sk = ts.shared_precompute(inputs, S, nz)
    hold_shared(f"awkward G={G} O={O}", sk, ts.shared_precompute_ref(inputs, S, nz))
    m1 = ts.pack_member(inputs, sk, o, a, l, r, S, nz)
    m2 = ts.pack_member(inputs, sk, o, a, l, r, S, nz, swaps=sw, seed_costs=m1.cost)
    hold_members(f"awkward G={G} O={O} phase 1", m1, ts.pack_member_ref(inputs, sk, o, a, l, r, S, nz))
    o2, a2, l2, r2 = ts.phase2_members(o, a, l, r, sw, m1.cost)
    hold_members(f"awkward G={G} O={O} phase 2", m2,
                 ts.pack_member_ref(inputs, sk, o2, a2, l2, r2, S, nz))
    hold_epilogue(ts, f"awkward G={G} O={O}", m1, m2)
    log(f"awkward shape G={G} O={O} S={S}: K1 bit-equal, K2 equal, K3 bit-equal")


def hold_epilogue(ts, tag, m1, m2) -> None:
    """K3's buffer against the plain version's, bit for bit, row by row."""
    import torch

    buf = ts.pack_epilogue(m1, m2)
    rows = [(m1, m2, buf)] if buf.dim() == 1 else [
        (ts._row(m1, b), ts._row(m2, b), buf[b]) for b in range(buf.shape[0])]
    for b, (x1, x2, got) in enumerate(rows):
        if not torch.equal(got, ts.pack_epilogue_ref(x1, x2)):
            raise AssertionError(f"{tag}: K3 buffer of row {b} differs from the plain version")


def nan_costs(K: int) -> list:
    """Phase-1 and phase-2 member costs on which a `<` scan and torch.argmin
    disagree: NaN first and later, ±inf, ties within and across phases,
    -0.0 beside +0.0."""
    nan, inf = float("nan"), float("inf")
    base = [3.0 + k for k in range(K)]

    def put(xs, at):
        out = list(xs)
        for k, v in at.items():
            out[k % K] = v
        return out

    return [
        (put(base, {1: 1.0, 2: nan, 3: 0.5, 4: nan}), base),
        (base, put(base, {0: nan, 5: -inf})),
        (put(base, {2: -inf, 6: -inf}), put(base, {1: -inf})),
        (put(base, {3: 1.0, 5: 1.0}), put(base, {0: 1.0})),
        (put(base, {1: inf, 2: 0.0}), put(base, {4: -0.0})),
        ([nan] * K, [nan] * K),
    ]


def nan_check(ts, c: dict) -> None:
    """K3, and K2's phase-2 seed, on member costs holding NaN, ±inf and ties
    (``nan_costs``): the first NaN, else the first minimum, as torch.argmin
    and jnp.argmin pick it; held against the plain versions."""
    import torch

    inputs, o, a, l, r, sw = c["tensors"]
    S, nz, sk, mk, mk2 = c["S"], c["nz"], c["sk"], c["mk"], c["mk2"]
    K = o.shape[0]
    for i, (c1, c2) in enumerate(nan_costs(K)):
        m1 = mk._replace(cost=torch.tensor(c1, dtype=torch.float32, device="cuda"))
        m2 = mk2._replace(cost=torch.tensor(c2, dtype=torch.float32, device="cuda"))
        hold_epilogue(ts, f"K3 on costs {i}", m1, m2)
        got = ts.pack_member(inputs, sk, o, a, l, r, S, nz, swaps=sw, seed_costs=m1.cost)
        o2, a2, l2, r2 = ts.phase2_members(o, a, l, r, sw, m1.cost)
        hold_members(f"K2 seeded by costs {i}", got, ts.pack_member_ref(inputs, sk, o2, a2, l2, r2, S, nz))
    log(f"nan costs: K3 and K2's phase-2 seed equal to the plain versions on {len(nan_costs(K))} "
        f"cost sets with NaN, +-inf and ties")


CHAIN_ORDER = ("k1_units", "k1_val_pair", "k2_prices", "k2_scan", "k2_prices", "k2_scan",
               "k3_pack_epilogue")


def chain_ops_check(ts, tag, args, S: int, nz: int, calls: int = 4) -> None:
    """``pack_solve_fused`` enqueues the chain's own kernels and nothing
    else: in a profiler trace of ``calls`` calls, the device events in the
    order they ran are CHAIN_ORDER once a call, with no PyTorch op, copy or
    memset between K1, K2, K2 and K3. The trace may miss the first call's
    first launches, so the events must be a tail of that sequence holding
    at least ``calls - 1`` whole chains."""
    names = [name for name, _ in device_trace(lambda: ts.pack_solve_fused(*args, S, nz), calls)]
    seq = []
    for name in names:
        part = next((p for p in CHAIN_ORDER if p in name), None)
        if part is None:
            raise AssertionError(f"{tag}: the chain enqueued {name!r} beside its kernels")
        seq.append(part)
    want = list(CHAIN_ORDER) * calls
    if len(seq) < (calls - 1) * len(CHAIN_ORDER) or seq != want[len(want) - len(seq):]:
        raise AssertionError(f"{tag}: the chain's device events ran as {seq}")
    log(f"chain {tag}: {calls} pack_solve_fused calls enqueued {CHAIN_ORDER} each and nothing "
        f"else ({len(want) - len(seq)} events of the first call not in the trace)")


def device_trace(fn, calls: int = 10):
    """The device events of ``calls`` calls of ``fn`` (after one warm-up),
    from a ``torch.profiler`` trace, in the order they ran: ``[(name, ms)]``.
    The calls queue behind a spin on the card. The trace may miss the
    events of the first call's first launches (on the card it missed one
    or two kernels of the first call in some windows): ``kernel_parts_ms``
    and ``chain_ops_check`` allow for that."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SPIN_CYCLES)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [ev for ev in prof.events()
              if str(ev.device_type).endswith("CUDA") and "spin_kernel" not in ev.name]
    events.sort(key=lambda ev: ev.time_range.start)
    return [(ev.name, ev.time_range.elapsed_us() / 1e3) for ev in events]


def kernel_parts_ms(fn, parts, calls: int = 10) -> dict:
    """Device ms per call of each ``__global__`` kernel in ``parts`` that
    ``fn`` launches (matched by name), and of everything else it enqueues
    under "other": each name's mean time a launch times its launches a
    call. Empty when the trace holds no device events."""
    total, count = {}, {}
    for name, ms in device_trace(fn, calls):
        part = next((p for p in parts if p in name), "other")
        total[part] = total.get(part, 0.0) + ms
        count[part] = count.get(part, 0) + 1
    return {p: total[p] / count[p] * max(1, round(count[p] / calls)) for p in total}


K1_PARTS = ("k1_units", "k1_val_pair")
K2_PARTS = ("k2_prices", "k2_scan")


def sass_counts(lib, parts) -> dict:
    """Instructions of each kernel in ``parts`` (summed over its instances)
    in the built library, from ``cuobjdump -sass``; empty without the tool."""
    import re

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    dump = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, cur = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            cur = next((p for p in parts if p in line), None)
        elif cur and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[cur] = counts.get(cur, 0) + 1
    return counts


def k1_breakdown(ts, problems, solver, real, key) -> dict:
    """K1's time split at 50k_full and 10k_topology (each at the slot budget
    its solve reaches) and on the fleet bucket at B=1 and B=16: the whole
    call behind a spin, then what it enqueues from a profiler trace, its
    two kernels and any other device work of the wrapper under "other".
    Returns the times."""
    shapes = {}
    for name in ("50k_full", "10k_topology"):
        problem = problems[name][0]
        _, orders, _, _, _, swaps, s_new, nz = solver._prepare(problem)
        tensors = device_problem(ts, solver, problem)
        _, S, _ = solver._run_fused(tensors, orders, swaps, s_new, nz)
        shapes[name] = (tensors[0], S, nz)
    for B in (1, 16):
        rows = stack_rows(ts, [real[i % len(real)] for i in range(B)]) if B > 1 else real[0]
        shapes[f"fleet B={B}"] = (rows[0], key.S, key.Z)
    out = {}
    for name, (inputs, S, nz) in shapes.items():
        def call():
            return ts.shared_precompute(inputs, S, nz)

        t = dict(ms=time_ms(call), parts=kernel_parts_ms(call, K1_PARTS))
        G, O, E, R, Z = ts._dims(inputs)
        log(f"k1 breakdown {name} (G={G} O={O} NS={E + S} R={R} B={ts._batch(inputs) or 1}): "
            f"call {t['ms']:.4f} ms; by kernel (profiler, ms a call) "
            f"{t['parts'] or 'no device time traced'}")
        out[name] = t
    return out


def k2_breakdown(ts, problems, solver) -> dict:
    """K2's time split at 50k_full and 10k_topology, each at the slot budget
    its solve reaches: phase 1 as the portfolio has it, phase 1 with every
    ``looks`` flag false (the lookahead prices' share), phase 2 seeded by
    phase 1's costs, and phase 1 one member at a time; then each phase's
    two kernels (the lookahead prices, the scan) alone, from a profiler
    trace. Returns the times."""
    from karpenter_tpu_torch.solver import _build

    out = {}
    for name in ("50k_full", "10k_topology"):
        problem = problems[name][0]
        _, orders, _, _, _, swaps, s_new, nz = solver._prepare(problem)
        tensors = device_problem(ts, solver, problem)
        _, S, _ = solver._run_fused(tensors, orders, swaps, s_new, nz)
        inputs, o, a, l, r, sw = tensors
        sk = ts.shared_precompute(inputs, S, nz)
        m1 = ts.pack_member(inputs, sk, o, a, l, r, S, nz)
        no_look = l.clone().fill_(False)
        t = {
            "phase1": time_ms(lambda: ts.pack_member(inputs, sk, o, a, l, r, S, nz)),
            "phase1_no_look": time_ms(lambda: ts.pack_member(inputs, sk, o, a, no_look, r, S, nz)),
            "phase2": time_ms(lambda: ts.pack_member(inputs, sk, o, a, l, r, S, nz, swaps=sw,
                                                     seed_costs=m1.cost)),
        }
        t["members"] = [
            time_ms(lambda: ts.pack_member(inputs, sk, o[k:k + 1], a[k:k + 1], l[k:k + 1],
                                           r[k:k + 1], S, nz), reps=3)
            for k in range(o.shape[0])
        ]
        t["parts1"] = kernel_parts_ms(lambda: ts.pack_member(inputs, sk, o, a, l, r, S, nz),
                                      K2_PARTS)
        t["parts2"] = kernel_parts_ms(lambda: ts.pack_member(inputs, sk, o, a, l, r, S, nz,
                                                             swaps=sw, seed_costs=m1.cost),
                                      K2_PARTS)
        steps = int((inputs.count > 0).sum())
        G, O, E, R, Z = ts._dims(inputs)
        scratch = ts.pack_member_scratch(_build.load_kernels(), G, O, R, Z, E + S)
        log(f"k2 plan {name}: {scratch} bytes of global scratch a member "
            f"({'none: all in shared memory' if not scratch else 'the rest in shared memory'})")
        log(f"k2 breakdown {name} (S={S}, {steps} steps with pods, looks {l.tolist()}): phase 1 "
            f"{t['phase1']:.4f} ms, without lookahead {t['phase1_no_look']:.4f} ms, phase 2 "
            f"{t['phase2']:.4f} ms; phase 1 member by member "
            f"{[round(x, 4) for x in t['members']]} ms; by kernel (profiler, ms a call) phase 1 "
            f"{t['parts1'] or 'no device time traced'}, phase 2 "
            f"{t['parts2'] or 'no device time traced'}")
        out[name] = dict(t, S=S, steps=steps)
    return out


def kernel_only(ts, problems, configs) -> None:
    """The kernel path alone (``TorchSolver._solve_kernel``) on the card,
    outside the race: its plans must validate and cost what the JAX package's
    kernel computes (the pinned costs the race is held under)."""
    import torch

    from karpenter_tpu_torch.solver import TorchSolver, validate

    solver = TorchSolver()
    for name, (problem, encode_s) in problems.items():
        t0 = time.perf_counter()
        result = solver._solve_kernel(problem)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        if validate(problem, result):
            raise AssertionError(f"{name}: kernel plan fails validation")
        ref = configs.REFERENCE_COSTS[name]
        if result.stats.get("backend") != 1.0 or abs(result.cost - ref) > COST_RTOL * ref:
            raise AssertionError(f"{name}: kernel-only cost {result.cost!r}, JAX package {ref!r}, "
                                 f"stats {result.stats}")
        st = result.stats
        log(f"kernel-only {name}: encode {encode_s:.4f} s, solve {solve_s:.4f} s "
            f"(prepare {st['prepare_s']:.4f}, device {st['device_s']:.4f} over "
            f"{int(st['fused_passes'])} fused passes at final S={int(st['slots'])}, validate "
            f"{st['validate_s']:.4f}, decode {st['decode_s']:.4f}), cost {result.cost!r} "
            f"(JAX package {ref!r})")


def probe_check(ts) -> dict:
    """``rtt_probe`` against its plain version on the card, its time beside
    ``torch.add(x, 1)``'s, and the solver's measured round trip."""
    import torch

    from karpenter_tpu_torch.solver import TorchSolver

    x = torch.tensor([0, 1, -1, 7, 2**31 - 1, -2**31, 42, 5], dtype=torch.int32, device="cuda")
    got, want = ts.rtt_probe(x), ts.rtt_probe_ref(x)
    if not torch.equal(got, want):
        raise AssertionError(f"rtt_probe {got.tolist()} differs from x + 1 {want.tolist()}")
    err = max_err(got, want)
    ms = time_ms(lambda: ts.rtt_probe(x))
    plain = time_ms(lambda: ts.rtt_probe_ref(x))
    library = time_ms(lambda: torch.add(x, 1))
    TorchSolver._device_rtt_s = None
    rtt = TorchSolver().device_rtt()
    TorchSolver._device_rtt_s = None  # the race path measures it again, as a new process would
    b = bound(2 * nbytes(x), 0)
    log(f"rtt_probe: equal to x + 1; kernel {ms:.6f} ms, plain {plain:.6f} ms, torch.add "
        f"{library:.6f} ms, bound {b[0]:.3e} ms ({b[1]}); device_rtt {rtt * 1e3:.4f} ms")
    return {
        "name": "rtt_probe", "route": "cuda", "source": "karpenter_tpu_torch/solver/csrc/probe.cu",
        "replaces": "karpenter_tpu/solver/solver.py:1519", "launches": None, "max_abs_err": err,
        "ms": ms, "plain_ms": plain, "bound_ms": b[0], "bound_by": b[1], "library_ms": library,
    }


def zero_counts(ts) -> None:
    for counts in (ts.LAUNCHES, ts.BATCHED):
        for k in counts:
            counts[k] = 0


def hold_race(name, problem, result, validate) -> None:
    """What no solve on the card may show: an invalid plan, a fallback, a
    kernel plan the validator refused, breaker evidence, a missed deadline."""
    from karpenter_tpu_torch.solver.solver import KERNEL_BOARD

    violations = validate(problem, result)
    if violations:
        raise AssertionError(f"{name}: plan fails validation: {violations[:5]}")
    for bad in ("fallback", "tpu_violations"):
        if bad in result.stats:
            raise AssertionError(f"{name}: {bad} in {result.stats}")
    if KERNEL_BOARD.failures:
        raise AssertionError(f"{name}: breaker evidence {KERNEL_BOARD.failures}")
    if "_race_miss_count" in problem.__dict__:
        raise AssertionError(f"{name}: the kernel missed the deadline")


def race_phase(ts, problems, configs) -> dict:
    """Main path, flat: ``TorchSolver().solve`` in latency mode (budget
    0.1 s) on each config, a first solve and a repeat on the same problem
    object; launch counts taken around the phase and around each solve."""
    import torch

    from karpenter_tpu_torch.solver import TorchSolver, validate
    from karpenter_tpu_torch.solver.solver import KERNEL_BOARD

    KERNEL_BOARD.reset()
    solver = TorchSolver()
    zero_counts(ts)
    for name, (problem, _) in problems.items():
        ref = configs.REFERENCE_COSTS[name]
        for attempt in ("first", "repeat"):
            before = dict(ts.LAUNCHES)
            t0 = time.perf_counter()
            result = solver.solve(problem)
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            moved = {k: ts.LAUNCHES[k] - before[k] for k in before}
            hold_race(f"race {name} {attempt}", problem, result, validate)
            lost = problem.__dict__.get("_race_kernel_lost", False)
            if attempt == "first":
                if min(moved[k] for k in PACK_KERNELS) < 1:
                    raise AssertionError(f"race {name}: the kernel was not dispatched: {moved}")
                if not (result.stats.get("race_winner") or lost):
                    raise AssertionError(f"race {name}: the kernel did not answer: {result.stats}")
            elif any(moved[k] for k in PACK_KERNELS):
                raise AssertionError(f"race {name}: the repeat launched a kernel: {moved}")
            if result.cost > ref * (1 + COST_RTOL):
                raise AssertionError(f"race {name}: cost {result.cost!r} above the kernel's {ref!r}")
            st = result.stats
            ready = problem.__dict__.pop("_dispatch_s", None)
            log(f"race {name} {attempt}: backend {st['backend']}, cost {result.cost!r} "
                f"(kernel-only {ref!r}), kernel {'lost' if lost else 'won'}, host path "
                f"{st.get('race_host_s', 0.0):.4f} s, poll {st.get('race_poll_s', 0.0):.6f} s, "
                f"kernel device {st.get('dispatch_device_ms')} ms, dispatch->ready "
                f"{'ready at the first poll' if ready is None else f'{ready:.6f} s'}, solve "
                f"{wall:.4f} s, launches {moved}")
    launches = dict(ts.LAUNCHES)
    for k in PACK_KERNELS + ("rtt_probe",):
        if launches[k] < 1:
            raise AssertionError(f"{k} was not launched on the flat race path: {launches}")
    # the side-stream chain again, outside the race: a first dispatch pays
    # for its stream's first allocations. The dispatch's events also count
    # the gaps while the host enqueues the launches; behind a spin they do not
    for name, (problem, _) in problems.items():
        times = []
        for _ in range(3):
            d = solver._dispatch_async(problem)
            d.pending.materialize()
            times.append(d.pending.device_ms())
        inputs, _, _, *members, s_new, nz = solver._device_inputs(problem)
        with torch.cuda.stream(solver._side):
            spun = time_ms(lambda: solver._launch_chain((inputs, *members), s_new, nz), per=3)
        log(f"race {name}: side-stream chain again, device ms {times}; behind a spin "
            f"{spun:.4f} ms at S={s_new}")
    return launches


def hazard_check(ts, configs, cells, provs, catalog) -> None:
    """A dispatch on the side stream, held behind a spin, while the same
    stager restages a churned copy of its problem in place: the dispatch's
    buffer must be the plain chain's on the ORIGINAL inputs. Without the
    stager's fence the patch would land under the waiting chain. One
    unmeasured round first fills the allocators' caches: an allocation that
    reaches cudaMalloc or cudaHostAlloc can wait for the whole card, and the
    spin would be over before the restage began."""
    import torch

    from karpenter_tpu_torch.solver import TorchSolver, encode

    solver = TorchSolver()
    work = [dict(c) for c in cells]
    a = encode_cell(encode, work, provs, catalog, 0)
    if 0 not in configs.churn_cells(work, 0):
        raise AssertionError("churn round 0 does not touch cell 0")
    b = encode_cell(encode, work, provs, catalog, 0)
    # the chain runs at A's slot budget; on B's inputs at that budget it
    # would give another buffer
    S, K, Z = solver._estimate_slots(a), solver.portfolio, solver._bucket_key(a).Z
    want_a = ts.pack_solve_fused_ref(*device_problem(ts, solver, a), S, Z)
    want_b = ts.pack_solve_fused_ref(*device_problem(ts, solver, b), S, Z)
    if torch.equal(want_a, want_b):
        raise AssertionError("the churned copy solves alike: the check would prove nothing")
    for held in (False, True):
        solver._device_inputs(a)  # A resident again (a restage back from B after the first round)
        torch.cuda.synchronize()
        if held:
            with torch.cuda.stream(solver._side):
                torch.cuda._sleep(SPIN_CYCLES)
        d = solver._dispatch_async(a)
        pending_at_restage = not d.pending.is_ready()
        t0 = time.perf_counter()
        solver._device_inputs(b)
        restage_s = time.perf_counter() - t0
        info = solver._stager.last_round
        got = torch.from_numpy(d.pending.materialize().copy())
    if not pending_at_restage:
        raise AssertionError("the chain ended before the restage began: the check would prove nothing")
    if info["restage"] < 1:
        raise AssertionError(f"the churned copy did not restage in place: {info}")
    verdict = fused_agree(got, want_a, K)
    log(f"hazard: restaged {info['rows']} while a side-stream dispatch of the original waited "
        f"behind a spin; the restage returned to the host after {restage_s:.4f} s (it waits for "
        f"the chain); the dispatch's buffer vs the plain chain on the original inputs: {verdict}")


MEMBERS = ("orders", "alphas", "looks", "rsvs", "swaps")
FLEET_S = 2048  # the slot budget every cell of the 500k-pod fleet ends at
FLEET_REPLACES = {
    "stage_patch": "karpenter_tpu/solver/staging.py:200",
    "fleet_stack": "karpenter_tpu/solver/solver.py:1283",
}


def encode_cell(encode, cells, provs, catalog, c):
    return encode(list(cells[c].values()), [(provs[c], catalog)])


def stack_rows(ts, rows):
    """Device tuples ``(PackInputs, orders, alphas, looks, rsvs, swaps)`` of
    single problems stacked into one ``[B, ...]`` batch."""
    import torch

    return (ts._stack([r[0] for r in rows]),) + tuple(
        torch.stack([r[j] for r in rows]) for j in range(1, 6)
    )


def leaf_rows(row) -> dict:
    """One device tuple as the leaf mapping the staging kernels take."""
    return {**row[0]._asdict(), **dict(zip(MEMBERS, row[1:6]))}


def changed_rows(old, new) -> int:
    diff = old != new
    return int(diff.sum() if old.ndim == 1 else diff.reshape(old.shape[0], -1).any(axis=1).sum())


def fleet_rows(ts, configs, cells, provs, catalog):
    """Five distinct cells of the 500k-pod fleet (the seed cell and the
    cells of churn rounds 0-3) on the card, on one bucket at S=FLEET_S, and
    one pad row. Returns ``(solver, problems, key, real rows, pad row)``;
    ``cells`` is left as it was."""
    from karpenter_tpu_torch.solver import TorchSolver, encode

    solver = TorchSolver(device="cuda")
    work = [dict(c) for c in cells]
    problems = {"seed": encode_cell(encode, work, provs, catalog, 0)}
    for r in range(4):
        c = configs.churn_cells(work, r)[0]
        problems[f"r{r}"] = encode_cell(encode, work, provs, catalog, c)
    key = solver._bucket_key(problems["seed"])._replace(S=FLEET_S)
    real = [device_problem(ts, solver, p, bucket=key) for p in problems.values()]
    pad_fields, *pad_members = ts.fleet_padding(key)
    pad = ts.pack_inputs_from_numpy(dict(pad_fields, **dict(zip(MEMBERS, pad_members))), "cuda")
    return solver, problems, key, real, pad


def fleet_check(ts, st, configs, cells, provs, catalog) -> dict:
    """Batched K1/K2/K3 against their plain versions row by row on five
    distinct cells and three pad rows (B=8), every row of the batched chain
    against that problem's B=1 chain; fleet_stack and stage_patch against
    theirs. ``cells`` is left as it was."""
    import numpy as np
    import torch

    solver, problems, key, real, pad = fleet_rows(ts, configs, cells, provs, catalog)
    S, nz = key.S, key.Z
    batch = real + [pad] * 3
    B = len(batch)
    inputs, o, a, l, r, sw = stack_rows(ts, batch)
    log(f"fleet check: {list(problems)} + 3 pad rows on {key._replace(B=B).label()}")

    sk = ts.shared_precompute(inputs, S, nz)
    mk = ts.pack_member(inputs, sk, o, a, l, r, S, nz)
    mk2 = ts.pack_member(inputs, sk, o, a, l, r, S, nz, swaps=sw, seed_costs=mk.cost)
    bk = ts.pack_epilogue(mk, mk2)
    fleet = ts.pack_solve_fleet(inputs, o, a, l, r, sw, S, nz)
    torch.cuda.synchronize()
    k2_err = 0.0
    for b in range(B):
        row = ts._row(inputs, b)
        sr = ts.shared_precompute_ref(row, S, nz)
        for f in ts.Shared._fields:
            # bit for bit, the pad rows' INF prices through lam and val_pair too
            if not torch.equal(getattr(sk, f)[b], getattr(sr, f)):
                raise AssertionError(f"fleet row {b}: batched K1 {f} differs from the plain version")
        skb = ts._row(sk, b)
        mr = ts.pack_member_ref(row, skb, o[b], a[b], l[b], r[b], S, nz)
        o2, a2, l2, r2 = ts.phase2_members(o[b], a[b], l[b], r[b], sw[b], mk.cost[b])
        mr2 = ts.pack_member_ref(row, skb, o2, a2, l2, r2, S, nz)
        for tag, x, y in (("phase 1", ts._row(mk, b), mr), ("phase 2", ts._row(mk2, b), mr2)):
            k2_err = max(k2_err, hold_members(f"fleet row {b}, batched {tag}", x, y))
        if not torch.equal(bk[b], ts.pack_epilogue_ref(ts._row(mk, b), ts._row(mk2, b))):
            raise AssertionError(f"fleet row {b}: batched K3 buffer differs from the plain version")
        if not torch.equal(fleet[b], ts.pack_solve_fused(*batch[b], S, nz)):
            raise AssertionError(f"fleet row {b}: batched chain differs from the B=1 chain")
        if b >= len(real):
            costs = fleet[b, 4 : 4 + 2 * key.K].view(torch.float32)
            if int(fleet[b, 3]) != 0 or bool(costs.any()):
                raise AssertionError(f"fleet pad row {b} places or costs something")
    if len({bytes(fleet[b].cpu().numpy()) for b in range(len(real))}) != len(real):
        raise AssertionError("the fleet rows are not distinct problems")
    # the eight rows twice over at B=16: K1 and K3 bit for bit on every row,
    # and the chain's launches
    args16 = stack_rows(ts, [batch[i % B] for i in range(16)])
    i16, o16, a16, l16, r16, sw16 = args16
    s16 = ts.shared_precompute(i16, S, nz)
    for b in range(16):
        hold_shared(f"fleet B=16 row {b}", ts._row(s16, b), ts.shared_precompute_ref(ts._row(i16, b), S, nz))
    n1 = ts.pack_member(i16, s16, o16, a16, l16, r16, S, nz)
    hold_epilogue(ts, "fleet B=16", n1,
                  ts.pack_member(i16, s16, o16, a16, l16, r16, S, nz, swaps=sw16, seed_costs=n1.cost))
    chain_ops_check(ts, "fleet B=16", args16, S, nz)

    rows = [leaf_rows(x) for x in batch]
    got, want = st.fleet_stack(rows), st.fleet_stack_ref(rows)
    for name in want:
        if not torch.equal(got[name], want[name]):
            raise AssertionError(f"fleet_stack {name} differs from torch.stack")

    # one churned cell's restage: the seed cell's resident leaves take the
    # rows that churn round 0 changed
    seed, churned = (solver._prepare(problems[k]) for k in ("seed", "r0"))
    old = dict(seed[0], **dict(zip(MEMBERS, seed[1:6])))
    new = dict(churned[0], **dict(zip(MEMBERS, churned[1:6])))
    patches = []
    for name in old:
        n = changed_rows(old[name], new[name])
        if 0 < n <= max(1, old[name].shape[0] // 2):
            diff = (old[name] != new[name]).reshape(old[name].shape[0], -1).any(axis=1)
            idx = np.flatnonzero(diff)
            width = 1 << (len(idx) - 1).bit_length()
            idx = np.concatenate([idx, np.full(width - len(idx), idx[0])]).astype(np.int64)
            dst = torch.from_numpy(old[name]).cuda()
            patches.append((name, dst, torch.from_numpy(idx).cuda(), torch.from_numpy(new[name][idx]).cuda()))
    if not patches:
        raise AssertionError("churn round 0 changed no leaf of the cell")
    for name, dst, idx, src in patches:
        got = st.stage_patch(dst.clone(), idx, src)
        if not (torch.equal(got, st.stage_patch_ref(dst.clone(), idx, src))
                and torch.equal(got.cpu(), torch.from_numpy(new[name]))):
            raise AssertionError(f"stage_patch {name} differs from index_copy_")
    log(f"fleet check: batched K1 bit-equal (B=8 and B=16), K2 max_abs_err={k2_err}, K3 equal "
        f"(B=8 and B=16), every row equal to its B=1 chain, pad rows cost 0; fleet_stack equal over "
        f"{len(rows)} rows x {len(rows[0])} leaves; stage_patch equal on "
        f"{[(p[0], int(p[2].shape[0])) for p in patches]}")
    return dict(real=real, key=key, rows=rows, patches=patches,
                errs={"shared_precompute": 0.0, "pack_member": k2_err, "pack_epilogue": 0.0,
                      "fleet_stack": 0.0, "stage_patch": 0.0})


def fleet_timings(ts, st, fc: dict) -> list:
    """The batched chain at B=1, 4, 8 and 16 (real rows, repeated for B > 5),
    fleet_stack for one B=16 chunk, and one churned cell's stage_patch
    restage, each beside its bound and its plain version."""
    real, key = fc["real"], fc["key"]
    S, nz = key.S, key.Z
    chain, bounds = {}, {}
    for B in (1, 4, 8, 16):
        args = stack_rows(ts, [real[i % len(real)] for i in range(B)])
        chain[B] = time_ms(lambda: ts.pack_solve_fleet(*args, S, nz) if B > 1
                           else ts.pack_solve_fused(*real[0], S, nz))
        if B == 4:
            plain4 = time_ms(lambda: ts.pack_solve_fleet_ref(*args, S, nz), per=1, reps=3)
        # least time: every input leaf read and the [B, L] buffer written
        # once, against K1's and both K2 phases' operations
        inputs, l = args[0], args[3]
        G, O, E, R, Z = ts._dims(inputs)
        buf_bytes = B * 4 * (4 + 4 * key.K + 2 * S + G * (E + S))
        bounds[B] = bound(nbytes(*args[0], *args[1:]) + buf_bytes,
                          B * k1_op_count(G, O, R) + 2 * k2_op_count(inputs, l, S))
    log("timing: fused chain " + ", ".join(
        f"B={b} {t:.4f} ms (bound {bounds[b][0]:.6f}, {bounds[b][1]})" for b, t in chain.items())
        + f"; plain at B=4 {plain4:.4f} ms")

    rows16 = [fc["rows"][i % len(real)] for i in range(16)]
    stack_bytes = 2 * sum(nbytes(*r.values()) for r in rows16)
    stack_ms = time_ms(lambda: st.fleet_stack(rows16))
    stack_plain = time_ms(lambda: st.fleet_stack_ref(rows16), per=1)
    patches = fc["patches"]
    n = len(patches)

    def patch_all(fn):
        for _, dst, idx, src in patches:
            fn(dst, idx, src)

    patch_ms = time_ms(lambda: patch_all(st.stage_patch)) / n
    patch_plain = time_ms(lambda: patch_all(st.stage_patch_ref), per=1) / n
    patch_bytes = sum(2 * nbytes(src) + nbytes(idx) for _, _, idx, src in patches) / n
    log(f"timing: fleet_stack B=16 ({len(rows16) * len(rows16[0])} rows) {stack_ms:.4f} ms, "
        f"plain torch.stack x{len(rows16[0])} {stack_plain:.4f} ms; stage_patch "
        f"{patch_ms:.4f} ms per launch over one churned cell's {n} launches, "
        f"index_copy_ {patch_plain:.4f} ms")
    out = []
    for name, ms, plain, lib, work in (
        ("stage_patch", patch_ms, patch_plain, patch_plain, patch_bytes),
        ("fleet_stack", stack_ms, stack_plain, None, stack_bytes),
    ):
        b = bound(work, 0)
        out.append({
            "name": name, "route": "cuda",
            "source": "karpenter_tpu_torch/solver/csrc/staging.cu",
            "replaces": FLEET_REPLACES[name], "launches": None,
            "max_abs_err": fc["errs"][name], "ms": ms, "plain_ms": plain,
            "bound_ms": b[0], "bound_by": b[1], "library_ms": lib,
        })
    return out


@contextlib.contextmanager
def recording(solver_mod):
    """Record what ``stage_fleet`` hands the fleet kernels: each
    ``fleet_stack`` call's rows and output, and each ``pack_solve_fleet``
    call's arguments and buffer. The solver module's two names are wrapped
    while it lasts; beneath them the wrappers launch and count as always."""
    stacks, fleets = [], []
    real_stack, real_fleet = solver_mod.fleet_stack, solver_mod.pack_solve_fleet

    def stack(rows):
        out = real_stack(rows)
        stacks.append((rows, out))
        return out

    def fleet(*args):
        buf = real_fleet(*args)
        fleets.append((args, buf))
        return buf

    solver_mod.fleet_stack, solver_mod.pack_solve_fleet = stack, fleet
    try:
        yield stacks, fleets
    finally:
        solver_mod.fleet_stack, solver_mod.pack_solve_fleet = real_stack, real_fleet


def hold_dispatches(ts, st, rnd, stacks, fleets) -> float:
    """One round's fleet dispatches against the plain versions, on the very
    inputs they were given: each device-side stack against ``torch.stack``,
    each ``[B, L]`` buffer row by row against ``pack_solve_fleet_ref`` at
    the dispatch's own B and S. Called before the next round's restage
    patches the resident rows. Returns the largest member-cost difference."""
    import torch

    for rows, out in stacks:
        want = st.fleet_stack_ref(rows)
        for name in want:
            if not torch.equal(out[name], want[name]):
                raise AssertionError(f"round {rnd}: fleet_stack {name} (B={len(rows)}) "
                                     f"differs from torch.stack")
    err, held = 0.0, []
    for args, buf in fleets:
        *tensors, S, nz = args
        B, K = buf.shape[0], tensors[1].shape[1]
        ref = ts.pack_solve_fleet_ref(*tensors, S, nz)
        verdicts = [fused_agree(buf[b], ref[b], K) for b in range(B)]
        err = max(err, max_err(buf[:, 4 : 4 + 2 * K].view(torch.float32),
                               ref[:, 4 : 4 + 2 * K].view(torch.float32)))
        held.append(f"b{B}@S{S} " + ", ".join(f"{verdicts.count(v)} {v}" for v in sorted(set(verdicts))))
    log(f"fleet round {rnd}: held against the plain versions: {len(stacks)} device-side "
        f"stacks equal to torch.stack; buffers {held}")
    return err


# round wall times of the fleet path before it raced the host (every exhausted row went on
# alone at 2S), NVIDIA H100 80GB HBM3, 700 W; PERF.md, section 5
PRE_RACE_ROUND_WALL_S = {"seed": 2.7715, 0: 0.3872, 1: 2.6833, 2: 0.3909}


def fleet_slice(ts, configs, cells, provs, catalog) -> dict:
    """Main path, fleet: the sharded round on per-cell solvers (prestage,
    stage_fleet, each cell's race), then one churn round through one shared
    solver. Launch counts are taken around it; each round's dispatches are
    held against the plain versions after its timing. Every cell's plan must
    validate and cost at most the kernel-only answer; a row that left pods
    unplaced must have lost its race. Returns the launch counts, the
    largest member-cost difference of the dispatches and each round's
    encode seconds."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.solver import TorchSolver, encode, stage_fleet, validate
    from karpenter_tpu_torch.solver import staging as st
    from karpenter_tpu_torch.solver.solver import KERNEL_BOARD

    solver_mod = importlib.import_module("karpenter_tpu_torch.solver.solver")
    n = len(cells)
    k2_err = 0.0
    KERNEL_BOARD.reset()
    TorchSolver._device_rtt_s = None  # this path measures it again, as a new process would
    zero_counts(ts)
    clones = [TorchSolver() for _ in range(n)]
    shared = TorchSolver()
    solved, previous, buffers, encode_s = [], {}, [], {}
    for rnd in ("seed", 0, 1, 2):
        t0 = time.perf_counter()
        dirty = list(range(n)) if rnd == "seed" else configs.churn_cells(cells, rnd)
        with gc_seconds() as gc_s:
            problems = [encode_cell(encode, cells, provs, catalog, c) for c in dirty]
        t1 = time.perf_counter()
        encode_s[rnd] = t1 - t0
        restaged = 0
        if rnd == 2:
            entries = [(shared, p) for p in problems]
        else:
            entries = [(clones[c], p) for c, p in zip(dirty, problems)]
            for c, p in zip(dirty, problems):
                clones[c].prestage(p)
                if c in previous:
                    info = clones[c]._stager.last_round
                    if info["restage"] < 1:
                        raise AssertionError(f"cell {c}: prestage restaged nothing: {info}")
                    old, new = (clones[c]._prepare(q) for q in (previous[c], p))
                    old = dict(old[0], **dict(zip(MEMBERS, old[1:6])))
                    new = dict(new[0], **dict(zip(MEMBERS, new[1:6])))
                    for name in new:  # the rows an independent host diff finds
                        want = changed_rows(old[name], new[name])
                        if want <= max(1, new[name].shape[0] // 2) and info["rows"].get(name, 0) != want:
                            raise AssertionError(f"cell {c}: {name} restaged {info['rows']}, diff {want}")
                    restaged += sum(info["rows"].values())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with recording(solver_mod) as (stacks, dispatched):
            stats = stage_fleet(entries, max_batch=16)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        widths = sorted(int(b.rsplit("b", 1)[1]) for b in stats["buckets"])
        want_widths, want_dev = ([4, 16], 2) if rnd == "seed" else ([4], 0 if rnd == 2 else 1)
        if widths != want_widths or stats["device_stacked"] != want_dev or stats["cells_batched"] != n * (rnd == "seed") + 4 * (rnd != "seed"):
            raise AssertionError(f"round {rnd}: stage_fleet {stats}")
        if len(stacks) != want_dev or len(dispatched) != len(want_widths):
            raise AssertionError(f"round {rnd}: recorded {len(stacks)} stacks, "
                                 f"{len(dispatched)} dispatches")
        slots = [p.__dict__["_fleet_dispatch"] for p in problems]
        fleets = {id(slot.shared): slot.shared for slot in slots}
        if rnd == 2:
            buffers = slots
        before = dict(ts.LAUNCHES)
        results = [solver.solve(p) for solver, p in entries]
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        moved = {k: ts.LAUNCHES[k] - before[k] for k in before}
        if any(moved[k] for k in PACK_KERNELS):
            raise AssertionError(f"round {rnd}: a cell's race launched a kernel of its own: {moved}")
        device_ms = sum(f.device_ms() for f in fleets.values())
        exhausted = won = 0
        for slot, p, res in zip(slots, problems, results):
            hold_race(f"fleet round {rnd}", p, res, validate)
            unplaced = int(slot.shared.materialize()[slot.row][3])
            lost = p.__dict__.get("_race_kernel_lost", False)
            exhausted += unplaced > 0
            won += res.stats.get("race_winner", 0.0) == 1.0
            if not (lost or res.stats.get("race_winner")):
                raise AssertionError(f"round {rnd}: a cell's row was never judged: {res.stats}")
            if unplaced > 0 and not lost:
                raise AssertionError(f"round {rnd}: an exhausted row did not lose its race")
        log(f"fleet round {rnd}: {len(dirty)} cells, encode {t1 - t0:.4f} s (garbage collection "
            f"{gc_s[0]:.4f} s of it), prestage "
            f"{t2 - t1:.4f} s (restaged rows {restaged}), stage_fleet {t3 - t2:.4f} s "
            f"({stats['buckets']}, device-stacked {stats['device_stacked']}), fleet device "
            f"{device_ms:.4f} ms, rows exhausted {exhausted} (each lost its race), kernel rows "
            f"won {won}, backends {sorted({r.stats['backend'] for r in results})}, host path "
            f"{sum(r.stats.get('race_host_s', 0.0) for r in results):.4f} s in all, solve "
            f"{t4 - t3:.4f} s, round wall {t4 - t0:.4f} s (before the race: {PRE_RACE_ROUND_WALL_S[rnd]} s)")
        k2_err = max(k2_err, hold_dispatches(ts, st, rnd, stacks, dispatched))
        del stacks, dispatched
        solved.extend((rnd, c, p, res) for c, p, res in zip(dirty, problems, results))
        previous.update(zip(dirty, problems))
    launches, batched = dict(ts.LAUNCHES), dict(ts.BATCHED)
    log(f"fleet slice launches {launches}, with B > 1 {batched}")
    for k in PACK_KERNELS + ("stage_patch", "fleet_stack", "rtt_probe"):
        if launches[k] < 1:
            raise AssertionError(f"{k} was not launched on the fleet path: {launches}")
    if min(batched.values()) < 1:
        raise AssertionError("a batched launch did not run on the fleet path")

    # the shared solver's host-stacked buffers against device-stacked ones of
    # the same problems on per-cell solvers
    dirty = [c for rnd, c, _, _ in solved if rnd == 2]
    copies = [encode_cell(encode, cells, provs, catalog, c) for c in dirty]
    for c, q in zip(dirty, copies):
        clones[c].prestage(q)
    if stage_fleet([(clones[c], q) for c, q in zip(dirty, copies)])["device_stacked"] != 1:
        raise AssertionError("round 2's copies did not take the device-side stack")
    for slot, q in zip(buffers, copies):
        other = q.__dict__.pop("_fleet_dispatch")
        if not np.array_equal(slot.shared.materialize()[slot.row], other.shared.materialize()[other.row]):
            raise AssertionError("host-stacked and device-stacked fleet buffers differ")

    for rnd, c, p, res in solved:
        ref = configs.REFERENCE_COSTS["cells_seed" if rnd == "seed" else f"cells_r{rnd}"]
        if res.cost > ref * (1 + COST_RTOL):
            raise AssertionError(f"round {rnd} cell {c}: cost {res.cost!r} above the kernel's {ref!r}")
    log(f"fleet slice: {len(solved)} plans valid, costs "
        f"{sorted({round(res.cost, 9) for *_, res in solved})}, each at most its kernel-only "
        f"cost")
    return launches, k2_err, encode_s


@contextlib.contextmanager
def gc_seconds():
    """Host seconds spent in CPython's cyclic garbage collector while the
    block runs (a one-element list, filled as it goes): with ~10^6 live
    pod objects a full collection takes a large share of an encode."""
    import gc

    spent, start = [0.0], []

    def track(phase, info):
        if phase == "start":
            start.append(time.perf_counter())
        elif start:
            spent[0] += time.perf_counter() - start.pop()

    gc.callbacks.append(track)
    try:
        yield spent
    finally:
        gc.callbacks.remove(track)


def moved_since(ts, before) -> dict:
    return {k: ts.LAUNCHES[k] - before[k] for k in before}


#: the capsules the replay phase replays, kept by the phases that record
#: them (``keep_capsule``): tag -> capsule; and the disk dumps of those the
#: replay CLI reads, tag -> path
CAPSULES: dict = {}
CAPSULE_PATHS: dict = {}
CAPSULE_DIR = Path(__file__).resolve().parent / "build" / "capsules"


def capture_s() -> float:
    """Seconds the flight recorder has spent capturing rounds' inputs in
    this process (``FLIGHTRECORDER_CAPTURE``'s sum): a round's capture is
    the difference across it."""
    from karpenter_tpu_torch.utils import metrics

    return metrics.FLIGHTRECORDER_CAPTURE.sum()


def peak_rss_gib() -> float:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20  # KiB on Linux


def capture_note(spent: float, wall: float) -> str:
    return f"capture {spent:.4f} s ({100.0 * spent / wall:.2f}% of the wall)"


def keep_capsule(tag: str, controller: str, since=None, dump: bool = False) -> None:
    """Keep the newest ``controller`` capsule of ``FLIGHT`` for the replay
    phase (the ring evicts it long before that phase runs); ``since`` is the
    newest one before the round, which must not be it. ``dump`` writes it to
    ``CAPSULE_DIR`` with ``FLIGHT.dump`` too, for the replay CLI."""
    from karpenter_tpu_torch.utils.flightrecorder import FLIGHT

    capsule = FLIGHT.latest(controller)
    if capsule is None or capsule is since:
        raise AssertionError(f"capsule ({tag}): the round recorded no {controller} capsule")
    CAPSULES[tag] = capsule
    pods = len(capsule["inputs"]["objects"]["pods"])
    note = f"capsule ({tag}): {capsule['id']}, {pods} pods, anomalies {capsule['anomalies']}"
    if dump:
        t0 = time.perf_counter()
        CAPSULE_PATHS[tag] = FLIGHT.dump(capsule["id"], str(CAPSULE_DIR))
        note += (f", dumped in {time.perf_counter() - t0:.2f} s to {CAPSULE_PATHS[tag]} "
                 f"({Path(CAPSULE_PATHS[tag]).stat().st_size} bytes)")
    log(note)


def hold_pack_launches(phase, launches) -> None:
    if min(launches[k] for k in PACK_KERNELS) < 1:
        raise AssertionError(f"{phase}: K1, K2 and K3 did not all launch: {launches}")


def hold_allocatable(name, cluster) -> None:
    """Each node's bound pods (one pod slot each) fit its allocatable."""
    from karpenter_tpu_torch.api import Resources

    used = {}
    for q in cluster.pods.values():
        if q.node_name is not None:
            used.setdefault(q.node_name, []).append(q.requests + Resources(pods=1))
    for node_name, reqs in used.items():
        total = reqs[0]
        for r in reqs[1:]:
            total = total + r
        if not total.fits(cluster.nodes[node_name].allocatable):
            raise AssertionError(f"{name}: node {node_name} holds more than its allocatable")


def interned(solver, result):
    """The problem ``result`` decodes, among the solver's intern slots."""
    from karpenter_tpu_torch.solver.solver import problem_digest

    found = [q for q in solver._interned_problems if problem_digest(q).hex() == result.problem_digest]
    if len(found) != 1:
        raise AssertionError(f"{len(found)} intern slots hold the problem of digest "
                             f"{result.problem_digest[:16]}")
    return found[0]


def hold_reconcile(name, solver, result, full, validate):
    """What ``solve_pods`` must give on the card: a digest equal to a full
    encode's of the same pods, the stats a controller reads, and a plan
    ``hold_race`` accepts. Returns the solved problem."""
    from karpenter_tpu_torch.solver.solver import problem_digest

    problem = interned(solver, result)
    if problem_digest(problem) != problem_digest(full):
        raise AssertionError(f"{name}: the session's problem differs from a full encode")
    missing = [k for k in ("encode_s", "total_s", "lower_bound") if k not in result.stats]
    if missing or not result.problem_digest:
        raise AssertionError(f"{name}: stats lack {missing} or the digest is unset: {result.stats}")
    hold_race(name, problem, result, validate)
    return problem


def session_delta(ts, configs) -> dict:
    """Main path, reconcile: ``TorchSolver().solve_pods`` with an
    ``EncodeSession`` on ``configs.config_delta_reconcile`` (50k pods, 1%
    churn a round): a seed round, the churn rounds fed as watch events, then
    a repeat round with no events, which must hit the solver's intern slot
    and stage nothing. Every round's problem must equal a full encode of
    ``session.ordered_pods()``, its plan must validate and cost at most the
    kernel-only answer of the same problem (a second solver), and the last
    churn round's kernel-only cost must be the JAX package's. Returns the
    launch counts of the ``solve_pods`` calls."""
    import torch

    from karpenter_tpu_torch.solver import EncodeSession, TorchSolver, encode, validate
    from karpenter_tpu_torch.solver.solver import KERNEL_BOARD

    KERNEL_BOARD.reset()
    TorchSolver._device_rtt_s = None
    pods, provs, churn_round = configs.config_delta_reconcile()
    solver, oracle, session = TorchSolver(), TorchSolver(), EncodeSession()
    launches = {k: 0 for k in ts.LAUNCHES}
    delta_s, full_s = [], []
    rounds = ["seed", *range(configs.DELTA_ROUNDS), "repeat"]
    for rnd in rounds:
        removed, added = churn_round(rnd) if isinstance(rnd, int) else ([], [])
        gone = {q.name for q in removed}
        pods = [q for q in pods if q.name not in gone] + added
        t0 = time.perf_counter()
        for q in removed:
            session.pod_event("DELETED", q)
        for q in added:
            session.pod_event("ADDED", q)
        feed_s = time.perf_counter() - t0
        if rnd == "repeat":
            staged = solver._stager.last_round
            slots = [id(q) for q in solver._interned_problems]
        before = dict(ts.LAUNCHES)
        with gc_seconds() as gc_s:
            result = solver.solve_pods(pods, provs, session=session)
            torch.cuda.synchronize()
        moved = moved_since(ts, before)
        launches = {k: launches[k] + moved[k] for k in launches}
        want_mode = "full" if rnd == "seed" else "delta"
        if session.last_mode != want_mode:
            raise AssertionError(f"delta round {rnd}: encoded {session.last_mode} "
                                 f"({session.last_full_reason}), not {want_mode}")
        t1 = time.perf_counter()
        full = encode(session.ordered_pods(), provs)
        full_enc = time.perf_counter() - t1
        problem = hold_reconcile(f"delta round {rnd}", solver, result, full, validate)
        st = result.stats
        if rnd == "repeat":
            if [id(q) for q in solver._interned_problems] != slots or id(problem) != slots[-1]:
                raise AssertionError("the repeat round missed the intern slot")
            if solver._stager.last_round is not staged or any(moved[k] for k in PACK_KERNELS):
                raise AssertionError(f"the repeat round staged or launched: {moved}")
            log(f"delta round repeat: intern hit ({len(slots)} slots), nothing staged or "
                f"launched, backend {st['backend']}, cost {result.cost!r}, encode "
                f"{st['encode_s']:.6f} s, total {st['total_s']:.6f} s")
            continue
        kernel = oracle._solve_kernel(problem)
        torch.cuda.synchronize()
        if validate(problem, kernel) or result.cost > kernel.cost * (1 + COST_RTOL):
            raise AssertionError(f"delta round {rnd}: cost {result.cost!r} above the kernel's "
                                 f"{kernel.cost!r}")
        if rnd == configs.DELTA_ROUNDS - 1:
            ref = configs.REFERENCE_COSTS["delta_r8"]
            if abs(kernel.cost - ref) > COST_RTOL * ref:
                raise AssertionError(f"delta round {rnd}: kernel-only cost {kernel.cost!r}, "
                                     f"JAX package {ref!r}")
        if isinstance(rnd, int):
            delta_s.append(feed_s + st["encode_s"])
            full_s.append(full_enc)
        log(f"delta round {rnd}: {session.last_mode}, encode {st['encode_s']:.6f} s (events "
            f"{feed_s:.6f} s; full encode of the same pods {full_enc:.6f} s), solve "
            f"{st['total_s'] - st['encode_s']:.6f} s, total {st['total_s']:.6f} s, backend "
            f"{st['backend']}, garbage collection {gc_s[0]:.6f} s, cost {result.cost!r} "
            f"(kernel-only {kernel.cost!r}), lower bound "
            f"{float(st['lower_bound'])!r}, chain device {st.get('dispatch_device_ms')} ms, launches {moved}")
    log(f"session_delta: encode p50 delta {statistics.median(delta_s) * 1e3:.4f} ms (events "
        f"included), full {statistics.median(full_s) * 1e3:.4f} ms over {len(delta_s)} churn "
        f"rounds; launches {launches}")
    hold_pack_launches("session_delta", launches)
    return launches


def session_fleet(ts, configs, fleet_encode_s) -> dict:
    """Main path, sharded controller: the cells_500k rounds of
    ``fleet_slice`` again, on a fresh fleet, through the reconcile entry
    points. 20 per-cell ``TorchSolver``s, each cell with its own
    ``EncodeSession``: ``encode_for_staging`` and ``prestage`` for every
    dirty cell, one ``stage_fleet``, then ``solve_pods(pre_encoded=...)``
    for each; the seed round and churn rounds 0-1 so, round 2 through one
    shared solver's ``solve_fleet``. Churn rounds must delta-encode; each
    cell's problem must equal a full encode of its session's pods and of
    the cell's own; the fleet widths must be ``fleet_slice``'s; every plan
    must validate and cost at most its pinned kernel-only cost. Returns the
    launch counts of the flow."""
    import torch

    from karpenter_tpu_torch.solver import EncodeSession, TorchSolver, encode, stage_fleet, validate
    from karpenter_tpu_torch.solver.solver import KERNEL_BOARD, problem_digest

    solver_mod = importlib.import_module("karpenter_tpu_torch.solver.solver")
    KERNEL_BOARD.reset()
    TorchSolver._device_rtt_s = None
    cells, provs, catalog = configs.config_cells()
    n = len(cells)
    clones = [TorchSolver() for _ in range(n)]
    shared = TorchSolver()
    sessions = [EncodeSession() for _ in range(n)]
    launches = {k: 0 for k in ts.LAUNCHES}
    for rnd in ("seed", 0, 1, 2):
        t0 = time.perf_counter()
        if rnd == "seed":
            dirty = list(range(n))
        else:
            events = configs.churn_cell_events(cells, rnd)
            dirty = list(events)
            for c, (removed, added) in events.items():
                for q in removed:
                    sessions[c].pod_event("DELETED", q)
                for q in added:
                    sessions[c].pod_event("ADDED", q)
        requests = [{"pods": list(cells[c].values()), "provisioners": [(provs[c], catalog)],
                     "session": sessions[c]} for c in dirty]
        before = dict(ts.LAUNCHES)
        with recording(solver_mod) as (_, dispatched), gc_seconds() as gc_s:
            if rnd == 2:
                owners = [shared] * len(dirty)
                results = shared.solve_fleet(requests)
                torch.cuda.synchronize()
                encode_s = sum(r.stats["encode_s"] for r in results)
                steps = f"solve_fleet {time.perf_counter() - t0:.4f} s"
            else:
                owners = [clones[c] for c in dirty]
                staged = [solver.encode_for_staging(**req) for solver, req in zip(owners, requests)]
                encode_s = sum(q.__dict__["_pre_encode_s"] for q in staged)
                t1 = time.perf_counter()
                for solver, q in zip(owners, staged):
                    solver.prestage(q)
                stage_fleet(list(zip(owners, staged)), max_batch=16)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                results = [solver.solve_pods(**req, pre_encoded=q)
                           for solver, req, q in zip(owners, requests, staged)]
                torch.cuda.synchronize()
                steps = (f"prestage + stage_fleet {t2 - t1:.4f} s, solve_pods "
                         f"{time.perf_counter() - t2:.4f} s")
        wall = time.perf_counter() - t0
        moved = moved_since(ts, before)
        launches = {k: launches[k] + moved[k] for k in launches}
        widths = sorted(buf.shape[0] for _, buf in dispatched)
        del dispatched
        if widths != ([4, 16] if rnd == "seed" else [4]):
            raise AssertionError(f"session fleet round {rnd}: fleet widths {widths}")
        ref = configs.REFERENCE_COSTS["cells_seed" if rnd == "seed" else f"cells_r{rnd}"]
        full_s = 0.0
        for c, solver, res in zip(dirty, owners, results):
            want_mode = "full" if rnd == "seed" else "delta"
            if sessions[c].last_mode != want_mode:
                raise AssertionError(f"session fleet round {rnd} cell {c}: encoded "
                                     f"{sessions[c].last_mode}, not {want_mode}")
            t1 = time.perf_counter()
            full = encode(sessions[c].ordered_pods(), [(provs[c], catalog)])
            full_s += time.perf_counter() - t1
            own = encode_cell(encode, cells, provs, catalog, c)
            if problem_digest(own) != problem_digest(full):
                raise AssertionError(f"session fleet round {rnd} cell {c}: the session's order "
                                     f"is not the cell's")
            hold_reconcile(f"session fleet round {rnd} cell {c}", solver, res, full, validate)
            if res.cost > ref * (1 + COST_RTOL):
                raise AssertionError(f"session fleet round {rnd} cell {c}: cost {res.cost!r} above "
                                     f"the kernel's {ref!r}")
        log(f"session fleet round {rnd}: {len(dirty)} cells, encode {encode_s:.4f} s in all "
            f"({'full' if rnd == 'seed' else 'delta'}; fleet_slice's full encodes "
            f"{fleet_encode_s[rnd]:.4f} s, a full encode of the same pods here {full_s:.4f} s), "
            f"{steps}, round wall {wall:.4f} s (garbage collection {gc_s[0]:.4f} s of it), fleet "
            f"widths {widths}, backends "
            f"{sorted({r.stats['backend'] for r in results})}, kernel rows won "
            f"{sum(r.stats.get('race_winner', 0.0) == 1.0 for r in results)}, costs "
            f"{sorted({round(r.cost, 9) for r in results})} (kernel-only {ref!r}), launches {moved}")
    log(f"session_fleet launches {launches}")
    hold_pack_launches("session_fleet", launches)
    return launches


def controller_round(ts, configs) -> dict:
    """Main path, provisioning controller: ``ProvisioningController(cluster,
    provider, settings=...)`` with its default ``TorchSolver()`` over
    ``configs.config_controller_reconcile`` (50k pending pods, 400 types):
    a seed round, then the churn rounds applied through the cluster's own
    calls. Each round must bind every pending pod within its nodes'
    allocatable, leave no plan rejected by the firewall, and solve a
    problem with the digest of a full encode of the session's pods, in the
    session mode ``configs.CONTROLLER_CHURN_MODES`` names; the seed round's
    kernel-only cost must be the JAX package's, and its plan cost at most
    that (a churn round's kernel-only answer is logged beside its plan: the
    race may keep a host plan dearer than the kernel's answer after a slot
    regrow, as the reference's does). The first churn round's
    problem, at its real existing-node count E, holds K1, K2 and K3 against
    their plain versions. Returns the largest differences seen there."""
    import torch

    from karpenter_tpu_torch.controllers import ProvisioningController
    from karpenter_tpu_torch.solver import TorchSolver, _build, encode, validate
    from karpenter_tpu_torch.solver.solver import KERNEL_BOARD
    from karpenter_tpu_torch.utils.flightrecorder import FLIGHT

    KERNEL_BOARD.reset()
    TorchSolver._device_rtt_s = None
    t0 = time.perf_counter()
    cluster, provider, settings, churn_round = configs.config_controller_reconcile()
    ctl = ProvisioningController(cluster, provider, settings=settings)
    solver = ctl.solver
    log(f"controller config: {len(cluster.pods)} pending pods, {len(provider.catalog)} types, "
        f"built in {time.perf_counter() - t0:.2f} s; solver on {solver.device}")
    # what each round's solve_pods was given and answered (the controller's
    # session owns the pod order), and the time inside launches, binds and
    # the decision log's rejected alternatives (one call a launched node)
    calls, spent = [], {"launch": 0.0, "bind": 0.0, "alternatives": 0.0}
    solve_pods, launch_all, bind = solver.solve_pods, ctl._launch_all, ctl._bind
    prov_mod = importlib.import_module("karpenter_tpu_torch.controllers.provisioning")
    alternatives = prov_mod.rejected_alternatives

    def recording_solve(pods, provs, existing=(), daemonsets=(), **kw):
        result = solve_pods(pods, provs, existing=existing, daemonsets=daemonsets, **kw)
        if kw.get("session") is not None:
            calls.append((kw["session"].ordered_pods(), provs, existing, daemonsets, result))
        return result

    def timed(key, fn):
        def call(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[key] += time.perf_counter() - t
        return call

    solver.solve_pods = recording_solve
    ctl._launch_all, ctl._bind = timed("launch", launch_all), timed("bind", bind)
    prov_mod.rejected_alternatives = timed("alternatives", alternatives)
    oracle = TorchSolver()
    launches = {k: 0 for k in ts.LAUNCHES}
    errs, r0 = {}, None
    for rnd in ["seed", *range(configs.DELTA_ROUNDS)]:
        name = f"controller round {rnd}"
        if rnd != "seed":
            churn_round(rnd)
        calls.clear()
        spent.update(launch=0.0, bind=0.0, alternatives=0.0)
        pending = len(cluster.pending_pods())
        before = dict(ts.LAUNCHES)
        c0, last = capture_s(), FLIGHT.latest("provisioning")
        t0 = time.perf_counter()
        with gc_seconds() as gc_s:
            result = ctl.reconcile()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        captured = capture_s() - c0
        moved = moved_since(ts, before)
        launches = {k: launches[k] + moved[k] for k in launches}
        if rnd in ("seed", 0):
            # the replay phase's capsules (a) and (b); (a) is dumped for the CLI
            keep_capsule("a" if rnd == "seed" else "b", "provisioning", since=last,
                         dump=rnd == "seed")
        # binding: every pending pod bound, within its node's allocatable
        if result.unschedulable or cluster.pending_pods() or len(result.bound) != pending:
            raise AssertionError(f"{name}: {len(result.bound)} of {pending} pods bound, "
                                 f"unschedulable {result.unschedulable[:5]}")
        hold_allocatable(name, cluster)
        bad = [e for e in result.validation_events if e["verdict"] != "accepted"]
        if bad:
            raise AssertionError(f"{name}: the firewall rejected a plan: {bad}")
        # the session: one solve, on the problem a full encode of its pods gives
        if len(calls) != 1:
            raise AssertionError(f"{name}: {len(calls)} session solves, not 1")
        order, provs, existing, daemonsets, solved = calls[0]
        mode = ctl.encode_session.last_mode
        want = "full" if rnd == "seed" else configs.CONTROLLER_CHURN_MODES[rnd]
        if mode != want:
            raise AssertionError(f"{name}: encoded {mode} ({ctl.encode_session.last_full_reason}), "
                                 f"not {want}")
        t1 = time.perf_counter()
        full = encode(order, provs, existing, daemonsets)
        full_s = time.perf_counter() - t1
        problem = hold_reconcile(name, solver, solved, full, validate)
        kernel = oracle._solve_kernel(problem)
        torch.cuda.synchronize()
        if validate(problem, kernel):
            raise AssertionError(f"{name}: the kernel-only plan fails validation")
        if rnd == "seed":
            ref = configs.REFERENCE_COSTS["controller_seed"]
            if abs(kernel.cost - ref) > COST_RTOL * ref:
                raise AssertionError(f"{name}: kernel-only cost {kernel.cost!r}, JAX package {ref!r}")
            if solved.cost > ref * (1 + COST_RTOL):
                raise AssertionError(f"{name}: cost {solved.cost!r} above the kernel's {ref!r}")
        if rnd == 0:
            r0 = problem
        st = solved.stats
        lost = problem.__dict__.get("_race_kernel_lost", False)
        log(f"{name}: {mode}, wall {wall:.4f} s, encode {st['encode_s']:.6f} s (full encode of "
            f"the same pods {full_s:.6f} s), solve {st['total_s'] - st['encode_s']:.6f} s, total "
            f"{st['total_s']:.6f} s, firewall {ctl._fw_eval_s:.4f} s, launch "
            f"{spent['launch']:.4f} s, rejected alternatives {spent['alternatives']:.4f} s, bind "
            f"{spent['bind']:.4f} s, "
            f"{len(result.nodes)} nodes launched, {len(result.bound)} pods bound, E={problem.E} "
            f"({len(cluster.nodes)} nodes in the cluster), backend {st['backend']} (kernel "
            f"{'lost' if lost else 'won' if st.get('race_winner') else 'not raced'}), chain "
            f"device {st.get('dispatch_device_ms')} ms, garbage collection {gc_s[0]:.4f} s, "
            f"{capture_note(captured, wall)}, cost {solved.cost!r} (kernel-only {kernel.cost!r}), "
            f"launches {moved}")
    solver.solve_pods, prov_mod.rejected_alternatives = solve_pods, alternatives
    log(f"controller_round launches {launches}; card {card_line()}")
    hold_pack_launches("controller_round", launches)
    # the kernels at the first churn round's real E, outside the counts
    c = check(ts, "controller_r0", r0, solver)
    G, O, E, R, Z = ts._dims(c["tensors"][0])
    scratch = ts.pack_member_scratch(_build.load_kernels(), G, O, R, Z, E + c["S"])
    log(f"controller_r0: real E={r0.E} (bucket {E}), S={c['S']}: K2's scan memory "
        + (f"spills to global memory, {scratch} bytes of global scratch a member"
           if scratch else "fits in shared memory"))
    errs = dict(c["errs"])
    del c
    return errs


#: what the seed round of ``controller_sharded`` launches: two fleet chains
#: (B=16 and B=4, each K1, K2 twice, K3) on device-side stacks, and the
#: first ``device_rtt`` probe (a warm call and three timed ones)
SHARDED_SEED_LAUNCHES = {"shared_precompute": 2, "pack_member": 4, "pack_epilogue": 2,
                         "stage_patch": 0, "fleet_stack": 2, "rtt_probe": 4}
#: what a churn round of ``config_controller_cells`` gives (the JAX
#: package's answer at 2,000 pods, ``tests/test_torch_sharded.py``): only
#: the 4 churned cells hold pending pods; round 0's cells delta-encode, and
#: later rounds' cells, emptied by the seed round's binds, start afresh
SHARDED_CHURN_MODES = {0: ("delta", ""), 1: ("full", "first-encode"), 2: ("full", "first-encode")}


class ShardedProbe:
    """What one sharded round did, gathered around ``reconcile``: every
    per-cell ``solve_pods`` call (its session's pods, provisioners,
    existing nodes and daemonsets, its result and its thread), each
    ``_FleetBuffer`` made, and host seconds spent in the round's steps.
    Installed on the classes and modules the round reads; ``close``
    restores them."""

    def __init__(self, ctl, solver_mod, prov_mod, hostpool):
        from karpenter_tpu_torch.solver import TorchSolver
        from karpenter_tpu_torch.state import CellRouter
        from karpenter_tpu_torch.utils.decisions import DECISIONS

        self.calls, self.buffers, self.records = [], [], []
        self.spent = dict.fromkeys(("plan", "encode_for_staging", "prestage", "stage_fleet",
                                    "fan_out", "arbitrate", "launch", "alternatives", "bind"), 0.0)
        self._undo = []
        probe = self

        def timed(key, fn):
            def call(*args, **kw):
                t = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    probe.spent[key] += time.perf_counter() - t
            return call

        def patch(obj, name, value):
            # an instance's method lives on its class: undo deletes the patch
            own = name in vars(obj)
            self._undo.append((obj, name, getattr(obj, name) if own else None))
            setattr(obj, name, value)

        solve_pods = TorchSolver.solve_pods

        def recording_solve(solver, pods, provs, existing=(), daemonsets=(), **kw):
            result = solve_pods(solver, pods, provs, existing=existing, daemonsets=daemonsets, **kw)
            session = kw.get("session")
            if session is not None and solver is not ctl.solver:
                probe.calls.append((session.ordered_pods(), provs, list(existing), daemonsets,
                                    result, threading.current_thread().name))
            return result

        class Buffer(solver_mod._FleetBuffer):
            __slots__ = ()

            def __init__(self, *args):
                super().__init__(*args)
                probe.buffers.append(self)

        record = DECISIONS.record

        def recording_record(kind, outcome, **kw):
            # the round's one "sharded-round" record; the ring may drop it
            # under the round's placement records
            if (kind, outcome) == ("cell", "sharded-round"):
                probe.records.append(kw.get("details"))
            return record(kind, outcome, **kw)

        patch(DECISIONS, "record", recording_record)
        patch(CellRouter, "plan_round", timed("plan", CellRouter.plan_round))
        patch(TorchSolver, "solve_pods", recording_solve)
        patch(TorchSolver, "encode_for_staging",
              timed("encode_for_staging", TorchSolver.encode_for_staging))
        patch(TorchSolver, "prestage", timed("prestage", TorchSolver.prestage))
        patch(solver_mod, "_FleetBuffer", Buffer)
        patch(solver_mod, "stage_fleet", timed("stage_fleet", solver_mod.stage_fleet))
        patch(hostpool, "map_all", timed("fan_out", hostpool.map_all))
        patch(prov_mod, "rejected_alternatives",
              timed("alternatives", prov_mod.rejected_alternatives))
        # the main solver answers only the residue's arbitration (or a
        # cell overflow) in a sharded round; the cells solve on clones
        patch(ctl.solver, "solve_pods", timed("arbitrate", ctl.solver.solve_pods))
        patch(ctl, "_launch_all", timed("launch", ctl._launch_all))
        patch(ctl, "_bind", timed("bind", ctl._bind))

    def reset(self) -> None:
        self.calls.clear()
        self.buffers.clear()
        self.records.clear()
        self.spent = dict.fromkeys(self.spent, 0.0)

    def close(self) -> None:
        for obj, name, value in reversed(self._undo):
            if value is None:
                delattr(obj, name)
            else:
                setattr(obj, name, value)
        self._undo.clear()


def sharded_round(ts, st, ctl, probe, solver_mod, name):
    """One ``reconcile`` of the sharded controller, held: every pending pod
    bound within its node's allocatable, no plan rejected by the firewall,
    each cell's problem equal to a full encode of its session's pods (with
    the round's own existing nodes and daemonsets), each fleet dispatch's
    rows and stacks equal to the plain versions and each fleet buffer
    copied to the host once. Returns the round's facts."""
    import torch

    from karpenter_tpu_torch.solver import encode
    from karpenter_tpu_torch.solver.solver import problem_digest

    cluster = ctl.cluster
    pending = len(cluster.pending_pods())
    probe.reset()
    before = dict(ts.LAUNCHES)
    c0 = capture_s()
    t0 = time.perf_counter()
    with recording(solver_mod) as (stacks, fleets), gc_seconds() as gc_s:
        result = ctl.reconcile()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    captured = capture_s() - c0
    moved = moved_since(ts, before)
    if result.unschedulable or cluster.pending_pods() or len(result.bound) != pending:
        raise AssertionError(f"{name}: {len(result.bound)} of {pending} pods bound, "
                             f"unschedulable {result.unschedulable[:5]}")
    hold_allocatable(name, cluster)
    bad = [e for e in result.validation_events if e["verdict"] != "accepted"]
    if bad:
        raise AssertionError(f"{name}: the firewall rejected a plan: {bad}")
    t1 = time.perf_counter()
    digests = {}
    for order, provs, existing, daemonsets, res, _ in probe.calls:
        full = problem_digest(encode(order, provs, existing, daemonsets)).hex()
        if full != res.problem_digest:
            raise AssertionError(f"{name}: cell {provs[0][0].name}: the session's problem "
                                 f"differs from a full encode")
        digests[provs[0][0].name] = full
    full_s = time.perf_counter() - t1
    err = hold_dispatches(ts, st, name, stacks, fleets)
    copies = [b.copies for b in probe.buffers]
    if any(c != 1 for c in copies):
        raise AssertionError(f"{name}: fleet buffers copied to the host {copies} times, not once")
    stats = result.solve.stats
    records = list(probe.records)
    cells = ctl.cells.last_round
    results = [c[4] for c in probe.calls]
    e_per_cell = [len(c[2]) for c in probe.calls]
    facts = dict(
        wall=wall, moved=moved, stats={k: stats.get(k) for k in (
            "cells", "cells_reused", "residue_pods", "fleet_dispatches", "fleet_cells_batched")},
        records=records, widths=sorted(buf.shape[0] for _, buf in fleets), digests=digests,
        modes=[(c["name"], c["encode_mode"]) for c in cells], err=err,
        costs=[c["cost"] for c in cells], copies=copies,
        threads=sorted({c[5] for c in probe.calls}),
    )
    log(f"{name}: wall {wall:.4f} s, plan_round {probe.spent['plan']:.4f} s (the router's "
        f"intake of the queued watch events and the split), encode "
        f"{stats.get('encode_s', 0.0):.4f} s (sum over cells; "
        f"encode_for_staging {probe.spent['encode_for_staging']:.4f} s of it), prestage "
        f"{probe.spent['prestage']:.4f} s + stage_fleet {probe.spent['stage_fleet']:.4f} s, "
        f"fan-out {probe.spent['fan_out']:.4f} s, arbitration {probe.spent['arbitrate']:.4f} s, "
        f"firewall {ctl._fw_eval_s:.4f} s, launch {probe.spent['launch']:.4f} s, rejected "
        f"alternatives {probe.spent['alternatives']:.4f} s, bind {probe.spent['bind']:.4f} s, "
        f"{len(result.nodes)} nodes launched, {len(result.bound)} pods bound, E per cell "
        f"{min(e_per_cell, default=0)}-{max(e_per_cell, default=0)}, backends "
        f"{sorted({r.stats.get('backend') for r in results})}, kernel rows won "
        f"{sum(r.stats.get('race_winner', 0.0) == 1.0 for r in results)}, stats {facts['stats']}, "
        f"decision record {records}, fleet widths {facts['widths']}, buffer copies {copies}, "
        f"modes {sorted(set(m for _, m in facts['modes']))}, worker threads "
        f"{len(facts['threads'])}, full encodes for the digest check {full_s:.4f} s, garbage "
        f"collection {gc_s[0]:.4f} s, {capture_note(captured, wall)}, costs "
        f"{min(facts['costs'], default=0.0)!r}-"
        f"{max(facts['costs'], default=0.0)!r}, launches {moved}; card {card_line()}")
    return facts


def controller_sharded(ts, st, configs) -> dict:
    """Main path, sharded provisioning controller: ``ProvisioningController``
    with its default ``TorchSolver()`` over ``configs.config_controller_cells``
    (500k pending pods in 20 cells of 25k, 60 types; 8 workers, fleet chunks
    of up to 16): a seed round, then churn rounds 0-2 applied through the
    cluster. Every round is held by ``sharded_round``. The seed round must
    solve 20 cells with none reused and no residue, each cell's problem
    the ``config_cells`` problem (so its cost is at most the JAX package's
    kernel-only ``cells_seed``), in two fleet dispatches of widths 4 and 16
    that batch all 20 cells, launching what ``SHARDED_SEED_LAUNCHES`` says.
    A churn round must solve the 4 churned cells (none reused, no residue)
    in the modes ``SHARDED_CHURN_MODES`` names. Then the worker check:
    ``config_controller_cells(16_000, 8)``'s seed round on twin clusters at
    1 worker and at 8, which must give equal digests and launch counts,
    each with its fleet rows equal to the plain chain and each fleet
    buffer copied to the host once. Returns the main run's launches."""
    import torch

    from karpenter_tpu_torch.controllers import ProvisioningController
    from karpenter_tpu_torch.parallel import hostpool
    from karpenter_tpu_torch.solver import TorchSolver, encode
    from karpenter_tpu_torch.solver.solver import KERNEL_BOARD, problem_digest

    solver_mod = importlib.import_module("karpenter_tpu_torch.solver.solver")
    prov_mod = importlib.import_module("karpenter_tpu_torch.controllers.provisioning")
    KERNEL_BOARD.reset()
    TorchSolver._device_rtt_s = None
    t0 = time.perf_counter()
    cluster, provider, settings, churn_round = configs.config_controller_cells()
    ctl = ProvisioningController(cluster, provider, settings=settings)
    log(f"sharded controller config: {len(cluster.pods)} pending pods in "
        f"{len(cluster.provisioners)} cells, {len(provider.catalog)} types, built in "
        f"{time.perf_counter() - t0:.2f} s; solver on {ctl.solver.device}, "
        f"{settings.cell_shard_workers} workers")
    probe = ShardedProbe(ctl, solver_mod, prov_mod, hostpool)
    launches = {k: 0 for k in ts.LAUNCHES}
    try:
        torch.cuda.reset_peak_memory_stats()
        for rnd in ["seed", 0, 1, 2]:
            name = f"sharded round {rnd}"
            if rnd != "seed":
                churn_round(rnd)
            facts = sharded_round(ts, st, ctl, probe, solver_mod, name)
            launches = {k: launches[k] + facts["moved"][k] for k in launches}
            stats = facts["stats"]
            if rnd == "seed":
                log(f"{name}: peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} "
                    f"MiB over {len(ctl._cell_solvers)} solver clones")
                want = dict(cells=20.0, cells_reused=0.0, residue_pods=0.0, fleet_dispatches=2.0,
                            fleet_cells_batched=20.0)
                if stats != want or facts["widths"] != [4, 16]:
                    raise AssertionError(f"{name}: stats {stats}, fleet widths {facts['widths']}")
                if facts["moved"] != SHARDED_SEED_LAUNCHES:
                    raise AssertionError(f"{name}: launches {facts['moved']}, not "
                                         f"{SHARDED_SEED_LAUNCHES}")
                hold_pack_launches(name, facts["moved"])
                cells, provs, catalog = configs.config_cells()
                for c, prov in enumerate(provs):
                    want_digest = problem_digest(
                        encode(list(cells[c].values()), [(prov, catalog)])).hex()
                    if facts["digests"].get(prov.name) != want_digest:
                        raise AssertionError(f"{name}: cell {prov.name}'s problem is not "
                                             f"config_cells' cell {c}")
                del cells
                ref = configs.REFERENCE_COSTS["cells_seed"]
                if max(facts["costs"]) > ref * (1 + COST_RTOL):
                    raise AssertionError(f"{name}: a cell costs {max(facts['costs'])!r}, above "
                                         f"the kernel-only {ref!r}")
            else:
                if stats["cells"] != 4.0 or stats["cells_reused"] or stats["residue_pods"]:
                    raise AssertionError(f"{name}: stats {stats}")
                mode = (ctl.cells.last_mode, ctl.cells.last_full_reason)
                if mode != SHARDED_CHURN_MODES[rnd]:
                    raise AssertionError(f"{name}: encoded {mode}, not {SHARDED_CHURN_MODES[rnd]}")
                if facts["moved"]["rtt_probe"]:
                    raise AssertionError(f"{name}: the round trip was probed again")
    finally:
        probe.close()
    log(f"controller_sharded launches {launches}")
    del ctl, cluster, provider
    # the worker check: twin clusters, 1 worker against 8
    twins = {}
    for workers in (1, 8):
        cluster, provider, settings, _ = configs.config_controller_cells(n_pods=16_000, n_cells=8)
        settings.cell_shard_workers = workers
        ctl = ProvisioningController(cluster, provider, settings=settings)
        probe = ShardedProbe(ctl, solver_mod, prov_mod, hostpool)
        try:
            twins[workers] = sharded_round(ts, st, ctl, probe, solver_mod,
                                           f"worker check, {workers} worker(s)")
            if workers == 1:
                keep_capsule("d", "provisioning")  # the replay phase's capsule (d)
        finally:
            probe.close()
        del ctl, cluster, provider
    one, eight = twins[1], twins[8]
    if one["records"][0]["workers"] != 1 or eight["records"][0]["workers"] != 8:
        raise AssertionError(f"worker check: records {one['records']} {eight['records']}")
    if len(one["threads"]) != 1 or len(eight["threads"]) < 2:
        raise AssertionError(f"worker check: solved on {one['threads']} and {eight['threads']}")
    for key in ("digests", "moved", "stats", "widths", "modes"):
        if one[key] != eight[key]:
            raise AssertionError(f"worker check: {key} differ: {one[key]} against {eight[key]}")
    if not one["stats"]["fleet_dispatches"]:
        raise AssertionError(f"worker check: no fleet dispatched: {one['stats']}")
    log(f"worker check: equal digests, launches {one['moved']}, fleet widths {one['widths']}; "
        f"costs at 1 worker {one['costs']}, at 8 {eight['costs']}")
    log(f"controller_sharded: peak RSS {peak_rss_gib():.2f} GiB")
    return launches


#: consolidation's fleets: (nodes, pods a node, passes at most). ``full`` is
#: BASELINE.md's 2,000-node, 20,000-pod repack, cut to 3 passes by time
#: (12-20 s a pass of host work); ``bench`` is ``bench.py``'s default fleet,
#: run to quiescence as the bench runs it
CONSOLIDATION_FLEETS = {"full": (2000, 10, 3), "bench": (300, 3, 40)}


class ConsolidationProbe:
    """What deprovisioning passes did, gathered around them: every
    ``solve_pods`` of a ``TorchSolver`` (the controller's, the quality
    solver's, the sweep clones', the provisioning rebinds'), with the
    launches each quality sim made (those sims run one at a time on the
    controller's thread); every kernel-only answer of a quality solver
    with its problem; every solve after which its problem carries a missed
    deadline; every restage of a resident problem (``stage_patch``), held
    at once byte for byte against the arrays a full upload of the same
    problem carries; and the host seconds of the multi-node search and the
    single-node sweep. A quality solver is the controller's
    ``quality_solver`` or a sweep clone's. Installed on ``TorchSolver`` and
    the controller; ``close`` restores them."""

    def __init__(self, ts, deprov):
        from karpenter_tpu_torch.solver import TorchSolver

        self.ts, self.deprov, self.lock, self._undo = ts, deprov, threading.Lock(), []
        self.reset()
        probe = self
        solve_pods, solve_kernel = TorchSolver.solve_pods, TorchSolver._solve_kernel
        solve, device_inputs = TorchSolver.solve, TorchSolver._device_inputs

        def recording_solve(solver, pods, provs, existing=(), daemonsets=(), **kw):
            quality = probe.is_quality(solver)
            before = dict(ts.LAUNCHES) if quality else None
            result = solve_pods(solver, pods, provs, existing=existing, daemonsets=daemonsets, **kw)
            row = dict(solver=solver, pods=len(pods), E=len(existing), result=result,
                       quality=quality, moved=moved_since(ts, before) if quality else None)
            with probe.lock:
                probe.solves.append(row)
            return result

        def recording_kernel(solver, problem):
            result = solve_kernel(solver, problem)
            if probe.is_quality(solver):
                with probe.lock:
                    probe.kernels.append((problem, result))
            return result

        def watched_solve(solver, problem):
            # the relax and degate re-solves too, whose problems no intern
            # slot holds
            result = solve(solver, problem)
            if "_race_miss_count" in problem.__dict__:
                with probe.lock:
                    probe.misses.append(int(problem.count.sum()))
            return result

        def held_inputs(solver, problem):
            staged = solver._stager.last_round
            entry = device_inputs(solver, problem)
            info = solver._stager.last_round
            if info is not staged and info["restage"]:
                probe.hold_restage(solver, problem, entry, info)
            return entry

        def timed(key, fn):
            def call(*args, **kw):
                t = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    probe.spent[key] += time.perf_counter() - t
            return call

        for obj, name, value in (
            (TorchSolver, "solve_pods", recording_solve),
            (TorchSolver, "_solve_kernel", recording_kernel),
            (TorchSolver, "solve", watched_solve),
            (TorchSolver, "_device_inputs", held_inputs),
            (deprov, "_try_multi_node", timed("multi", deprov._try_multi_node)),
            (deprov, "_single_node_sweep", timed("single", deprov._single_node_sweep)),
        ):
            own = name in vars(obj)
            self._undo.append((obj, name, getattr(obj, name) if own else None))
            setattr(obj, name, value)

    def is_quality(self, solver) -> bool:
        clones = self.deprov._worker_solvers or ()
        return solver is self.deprov.quality_solver or any(solver is q for _, q in clones)

    def hold_restage(self, solver, problem, entry, info) -> None:
        """The resident leaves a restage left, against the arrays
        ``_prepare`` gives for the problem (what a full upload copies):
        the same dtype, shape and bytes, every leaf."""
        import numpy as np

        fields, orders, alphas, looks, rsvs, swaps, _, _ = solver._prepare(problem)
        want = dict(fields, orders=orders, alphas=alphas, looks=looks, rsvs=rsvs, swaps=swaps)
        got = dict(entry[0]._asdict(), **dict(zip(MEMBERS, entry[3:8])))
        bad = []
        for name, arr in want.items():
            arr, dev = np.ascontiguousarray(arr), got[name].cpu().numpy()
            if dev.dtype != arr.dtype or dev.shape != arr.shape or dev.tobytes() != arr.tobytes():
                bad.append(name)
        if bad or set(got) != set(want):
            raise AssertionError(f"a restage of rows {info['rows']} left {bad} unlike a full "
                                 f"upload of {int(problem.count.sum())} pods")
        with self.lock:
            self.restages += 1
            self.patched += info["restage"]
            self.restaged_rows += sum(info["rows"].values())

    def reset(self) -> None:
        self.solves, self.kernels, self.misses = [], [], []
        self.restages = self.patched = self.restaged_rows = 0
        self.spent = {"multi": 0.0, "single": 0.0}

    def close(self) -> None:
        for obj, name, value in reversed(self._undo):
            if value is None:
                delattr(obj, name)
            else:
                setattr(obj, name, value)
        self._undo.clear()


def fleet_price(deprov, cluster) -> float:
    return sum(deprov._node_price(n) for n in cluster.nodes.values())


def hold_pass(ts, name, probe, launched) -> dict:
    """What every deprovisioning pass must show: no solve with a fallback,
    a refused kernel plan or a missed deadline, no breaker evidence, every
    quality sim answered by a kernel plan that validated after launching K1
    once and K2 twice at least, and every ``stage_patch`` launch of the pass
    (``launched``) a restage that ``hold_restage`` held. Returns the pass's
    sim facts."""
    from karpenter_tpu_torch.solver.solver import KERNEL_BOARD

    for row in probe.solves:
        stats = row["result"].stats
        for bad in ("fallback", "tpu_violations"):
            if bad in stats:
                raise AssertionError(f"{name}: a solve of {row['pods']} pods shows {bad}: {stats}")
    if probe.misses:
        raise AssertionError(f"{name}: the kernel missed the deadline on problems of "
                             f"{probe.misses} pods")
    if KERNEL_BOARD.failures:
        raise AssertionError(f"{name}: breaker evidence {KERNEL_BOARD.failures}")
    if launched["stage_patch"] != probe.patched:
        raise AssertionError(f"{name}: {launched['stage_patch']} stage_patch launches, "
                             f"{probe.patched} held")
    quality = [row for row in probe.solves if row["quality"]]
    if len(probe.kernels) != len(quality):
        raise AssertionError(f"{name}: {len(quality)} quality sims, {len(probe.kernels)} kernel solves")
    for (problem, kernel), row in zip(probe.kernels, quality):
        if kernel is None or kernel.stats.get("validated_counts") != 1.0 or "fallback" in kernel.stats:
            raise AssertionError(f"{name}: a quality sim of {row['pods']} pods had no validated "
                                 f"kernel plan: {kernel and kernel.stats}")
        moved = row["moved"]
        if moved["shared_precompute"] < 1 or moved["pack_member"] < 2 or moved["pack_epilogue"] < 1:
            raise AssertionError(f"{name}: a quality sim of {row['pods']} pods launched {moved}")
    device_s = sorted(k.stats["device_s"] for _, k in probe.kernels)
    return dict(
        sims=len(probe.solves), quality=len(quality), device_s=device_s,
        passes=[k.stats["fused_passes"] for _, k in probe.kernels],
        won=sum(1 for row in quality if row["result"].stats.get("backend") == 1.0),
    )


def consolidation_passes(ts, name, env, probe, max_passes, until=None, first=None, keep=None):
    """``bench.bench_consolidation``'s loop, pass by pass: ``deprov.reconcile()``,
    ``prov_ctl.reconcile()``, ``term.reconcile()``, then the clock steps 30 s.
    Each pass must leave every pod bound within its node's allocatable, the
    fleet's $/h no higher, and an executed consolidation saving money; it
    is held by ``hold_pass`` and logged. The loop ends after ``max_passes``,
    when ``until()`` holds, or (without ``until``) on a pass that neither
    acted nor parked a plan. ``first(probe)`` runs after the first pass,
    outside the launch counts. ``keep`` names the replay phase's capsule
    that the first pass's deprovisioning capsule becomes. Returns the
    launches of the passes and how many passes ran."""
    import torch

    from karpenter_tpu_torch.utils.flightrecorder import FLIGHT

    cluster, deprov = env["cluster"], env["deprov"]
    launches = {k: 0 for k in ts.LAUNCHES}
    price = fleet_price(deprov, cluster)
    restages = 0
    for i in range(max_passes):
        tag = f"{name} pass {i}"
        nodes_before, price_before = len(cluster.nodes), price
        # one scan of the cluster's pods, the unit of a pass's host work
        t0 = time.perf_counter()
        cluster.pods_on_node(next(iter(cluster.nodes)))
        scan_ms = (time.perf_counter() - t0) * 1e3
        probe.reset()
        before = dict(ts.LAUNCHES)
        c0, last = capture_s(), FLIGHT.latest("deprovisioning")
        t0 = time.perf_counter()
        with gc_seconds() as gc_s:
            action = deprov.reconcile()
            env["prov_ctl"].reconcile()
            env["term"].reconcile()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        captured = capture_s() - c0
        moved = moved_since(ts, before)
        if keep is not None and i == 0:
            keep_capsule(keep, "deprovisioning", since=last)
        launches = {k: launches[k] + moved[k] for k in launches}
        env["clock"].step(30)
        unbound = [p.name for p in cluster.pods.values() if p.node_name is None]
        if unbound:
            raise AssertionError(f"{tag}: {len(unbound)} pods unbound: {unbound[:5]}")
        hold_allocatable(tag, cluster)
        price = fleet_price(deprov, cluster)
        if price > price_before * (1 + 1e-12):
            raise AssertionError(f"{tag}: the fleet's $/h rose from {price_before!r} to {price!r}")
        if action is not None and action.reason.startswith("consolidation") and action.savings <= 0:
            raise AssertionError(f"{tag}: {action.reason} saves {action.savings!r}")
        sims = hold_pass(ts, tag, probe, moved)
        restages += probe.restages
        ds = sims["device_s"]
        log(f"{tag}: wall {wall:.4f} s, multi-node {probe.spent['multi']:.4f} s, single-node "
            f"{probe.spent['single']:.4f} s, {sims['sims']} solves ({sims['quality']} quality "
            f"sims, kernel won {sims['won']}; device_s min/median/max "
            + (f"{ds[0]:.6f}/{statistics.median(ds):.6f}/{ds[-1]:.6f}" if ds else "-")
            + f", fused passes {sims['passes']}), backends {dict(deprov.sweep_backend_counts)}, "
            f"action " + (f"{action.reason} of {len(action.nodes)} nodes, "
                          f"{len(action.replacements)} replacements "
                          f"{[r.option.instance_type.name for r in action.replacements]}, "
                          f"savings {action.savings!r}" if action is not None else "none")
            + f", nodes {nodes_before} -> {len(cluster.nodes)}, $/h {price_before!r} -> {price!r}, "
            f"launches {moved}, restages held {probe.restages} ({probe.patched} leaves, "
            f"{probe.restaged_rows} rows), garbage collection {gc_s[0]:.4f} s, "
            f"{capture_note(captured, wall)}, one pods_on_node "
            f"scan {scan_ms:.3f} ms, {threading.active_count()} threads; card {card_line()}")
        if first is not None and i == 0:
            first(probe)
        if until is not None:
            if until():
                break
        elif action is None and deprov.pending_action is None:
            break
    else:
        if until is not None:
            raise AssertionError(f"{name}: not done after {max_passes} passes")
    log(f"{name}: {i + 1} passes, {restages} restages held against a full upload")
    return launches, i + 1


def consolidation_env(configs, n_nodes, pods_per_node):
    """``configs.config_consolidation`` with the controllers
    ``bench.bench_consolidation`` builds: a ``ProvisioningController`` with
    its default ``TorchSolver()``, a ``TerminationController`` and a
    ``DeprovisioningController`` on the provisioning controller's solver."""
    from karpenter_tpu_torch.controllers import (
        DeprovisioningController, ProvisioningController, TerminationController)

    t0 = time.perf_counter()
    cluster, provider, settings, clock, _ = configs.config_consolidation(n_nodes, pods_per_node)
    prov_ctl = ProvisioningController(cluster, provider, settings=settings)
    term = TerminationController(cluster, provider, clock=clock)
    deprov = DeprovisioningController(cluster, provider, term, solver=prov_ctl.solver,
                                      settings=settings, clock=clock)
    log(f"consolidation config {n_nodes} x {pods_per_node}: {len(cluster.nodes)} nodes, "
        f"{len(cluster.pods)} pods, {len(provider.catalog)} types, $/h "
        f"{fleet_price(deprov, cluster)!r}, built in {time.perf_counter() - t0:.2f} s; solver on "
        f"{prov_ctl.solver.device}, quality solver on {deprov.quality_solver.device}")
    return dict(cluster=cluster, provider=provider, settings=settings, clock=clock,
                prov_ctl=prov_ctl, term=term, deprov=deprov)


def consolidation(ts, configs) -> dict:
    """Main path, deprovisioning: ``DeprovisioningController`` on the
    provisioning controller's default ``TorchSolver()``, with its
    quality-mode ``TorchSolver`` for what-ifs of 500 pods and more, over
    ``configs.config_consolidation``, each pass as ``bench.bench_consolidation``
    runs it (``consolidation_passes`` holds and logs each):

    (a) BASELINE's fleet (2,000 nodes, 20,000 pods), 3 passes. The first
        quality sim of the first pass re-places the whole fleet: its
        problem must be ``configs.config_consolidation_sim()``'s, its
        kernel-only cost the JAX package's ``consolidation_20k``, and on it
        K1, K2 and K3 are held against their plain versions (``check``);
    (b) ``bench.py``'s fleet (300 x 3) to quiescence, which must end with
        the fleet cheaper than it began;
    (c) drift on (b)'s cluster: ``provider.rotate_image()`` and
        ``DriftController.reconcile()``, then passes until no node carries
        the drifted annotation; every node left must run the new image;
    (d) the worker check: ``configs.config_sweep`` at 1 worker and at 8 on
        twin fixtures, one ``_consolidation()`` each, which must both delete
        the on-demand node of tiny pods.

    K1, K2 and K3 must launch over (a)-(c). Returns the launches of
    (a)-(c)'s passes and the largest differences of the kernel check."""
    import torch

    from karpenter_tpu_torch.api import labels as wk
    from karpenter_tpu_torch.controllers import DriftController
    from karpenter_tpu_torch.solver import TorchSolver, encode
    from karpenter_tpu_torch.solver.solver import KERNEL_BOARD, problem_digest

    KERNEL_BOARD.reset()
    TorchSolver._device_rtt_s = None
    launches = {k: 0 for k in ts.LAUNCHES}
    errs = {}
    n_nodes, per_node, passes = CONSOLIDATION_FLEETS["full"]
    env = consolidation_env(configs, n_nodes, per_node)
    probe = ConsolidationProbe(ts, env["deprov"])

    def hold_first_sim(probe):
        # the first quality sim: the whole fleet re-placed, E = 0
        problem, kernel = probe.kernels[0]
        want = problem_digest(encode(*configs.config_consolidation_sim(n_nodes, per_node)))
        if problem_digest(problem) != want or problem.E != 0:
            raise AssertionError("consolidation: the first sim is not config_consolidation_sim()")
        log(f"consolidation first sim: {int(problem.count.sum())} pods, G={problem.G}, "
            f"O={problem.O}, E={problem.E}, kernel-only cost {kernel.cost!r}, slots "
            f"{kernel.stats['slots']}, fused passes {kernel.stats['fused_passes']}")
        ref = configs.REFERENCE_COSTS["consolidation_20k"]
        if abs(kernel.cost - ref) > COST_RTOL * ref:
            raise AssertionError(f"consolidation: kernel-only cost {kernel.cost!r}, JAX "
                                 f"package {ref!r}")
        c = check(ts, "consolidation_20k", problem, env["deprov"].quality_solver)
        errs.update(c["errs"])

    try:
        torch.cuda.reset_peak_memory_stats()
        moved, _ = consolidation_passes(ts, "consolidation full", env, probe, passes,
                                        first=hold_first_sim)
        launches = {k: launches[k] + moved[k] for k in launches}
        log(f"consolidation full: peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; card {card_line()}")
    finally:
        probe.close()
    del env, probe

    n_nodes, per_node, passes = CONSOLIDATION_FLEETS["bench"]
    env = consolidation_env(configs, n_nodes, per_node)
    cluster, provider, deprov = env["cluster"], env["provider"], env["deprov"]
    probe = ConsolidationProbe(ts, deprov)
    try:
        start = fleet_price(deprov, cluster)
        moved, ran = consolidation_passes(ts, "consolidation bench", env, probe, passes,
                                          keep="e")
        launches = {k: launches[k] + moved[k] for k in launches}
        end = fleet_price(deprov, cluster)
        if end >= start or deprov.pending_action is not None:
            raise AssertionError(f"consolidation bench: $/h {start!r} -> {end!r} in {ran} passes")
        log(f"consolidation bench: quiescent after {ran} passes, {len(cluster.nodes)} nodes, $/h "
            f"{start!r} -> {end!r}, {provider.terminate_calls} terminate calls; card {card_line()}")

        image = provider.rotate_image()
        drifted = DriftController(cluster, provider, settings=env["settings"]).reconcile()
        if not drifted:
            raise AssertionError("consolidation drift: no node drifted")
        log(f"consolidation drift: image {image}, {len(drifted)} nodes annotated")

        def none_drifted():
            return not any(n.meta.annotations.get(wk.VOLUNTARY_DISRUPTION_ANNOTATION) == "drifted"
                           for n in cluster.nodes.values())

        moved, ran = consolidation_passes(ts, "consolidation drift", env, probe,
                                          2 * len(cluster.nodes) + 5, until=none_drifted)
        launches = {k: launches[k] + moved[k] for k in launches}
        stale = [n.name for n in cluster.nodes.values()
                 if provider.is_machine_drifted(cluster.machine_for_node(n))]
        if stale:
            raise AssertionError(f"consolidation drift: {stale[:5]} still run the old image")
        log(f"consolidation drift: {ran} passes, {len(cluster.nodes)} nodes, all on {image}")
    finally:
        probe.close()
    del env, probe, cluster, provider, deprov

    actions = {}
    for workers in (1, 8):
        deprov = configs.config_sweep(workers)
        before = dict(ts.LAUNCHES)
        t0 = time.perf_counter()
        action = deprov._consolidation()
        wall = time.perf_counter() - t0
        actions[workers] = None if action is None else (action.reason, list(action.nodes))
        log(f"consolidation worker check, {workers} worker(s): {actions[workers]}, wall "
            f"{wall:.4f} s, backends {deprov.sweep_backend_counts}, launches "
            f"{moved_since(ts, before)}")
        del deprov
    if actions[1] != actions[8] or actions[1] != ("consolidation-delete", ["cand-2000"]):
        raise AssertionError(f"consolidation worker check: {actions}")
    log(f"consolidation launches {launches}")
    hold_pack_launches("consolidation", launches)
    return dict(launches=launches, errs=errs)


#: the operator phase's cuts: the share of the seed round's spot nodes the
#: interruption storm reclaims, and the drift passes after the image
#: rotation (a whole rotation at ~900 nodes is one pass a node)
OPERATOR_STORM_FRAC = 0.10
OPERATOR_DRIFT_PASSES = 3
#: seconds the entry point's subprocess may take to answer its probes, and
#: to exit after SIGTERM
ENTRYPOINT_READY_S = 180.0
ENTRYPOINT_EXIT_S = 30.0


class OperatorProbe:
    """What each ``op.step()`` did, gathered around the operator's
    controllers: every ``solve_pods`` of the provisioning solver (the
    session's pods, the round's inputs and answer), the interruption
    messages handled and the pods they re-pended, the provisioning round's
    result and seconds, and the deprovisioning action. Installed on the
    operator's instances; nothing is restored (the operator is closed after
    the phase)."""

    def __init__(self, op):
        self.op, self.calls, self.row = op, [], {}
        solver, cluster = op.provisioning.solver, op.cluster
        solve_pods = solver.solve_pods
        prov, deprov, intr = op.provisioning.reconcile, op.deprovisioning.reconcile, None
        probe = self

        def recording_solve(pods, provs, existing=(), daemonsets=(), **kw):
            result = solve_pods(pods, provs, existing=existing, daemonsets=daemonsets, **kw)
            if kw.get("session") is not None:
                probe.calls.append((kw["session"].ordered_pods(), provs, existing, daemonsets,
                                    result))
            return result

        def provisioning():
            t = time.perf_counter()
            result = prov()
            probe.row.update(prov_s=time.perf_counter() - t, result=result)
            return result

        def deprovisioning():
            t = time.perf_counter()
            action = deprov()
            probe.row.update(deprov_s=time.perf_counter() - t, action=action)
            return action

        solver.solve_pods = recording_solve
        op.provisioning.reconcile, op.deprovisioning.reconcile = provisioning, deprovisioning
        if op.interruption is not None:
            intr = op.interruption.reconcile

            def interruption(*a, **kw):
                pending = len(cluster.pending_pods())
                t = time.perf_counter()
                handled = intr(*a, **kw)
                probe.row.update(intr_s=time.perf_counter() - t, handled=handled,
                                 repended=len(cluster.pending_pods()) - pending)
                return handled

            op.interruption.reconcile = interruption
        # the cost ledger meters every bind through the cluster's watch:
        # time its share of each step (an operator over the HTTP cloud has
        # no ledger: the provider serves no prices)
        ledger = op.costledger
        if ledger is None:
            return
        on_event = ledger._on_event

        def metered(event, obj):
            t = time.perf_counter()
            try:
                on_event(event, obj)
            finally:
                probe.row["ledger_s"] = probe.row.get("ledger_s", 0.0) + time.perf_counter() - t

        watchers = cluster._watchers
        watchers[watchers.index(on_event)] = metered

    def step(self, ts, clock_s: float = 0.0) -> dict:
        """One ``op.step()`` (then ``clock.step(clock_s)``); returns what it
        did, with its wall time and launches."""
        import torch

        self.calls.clear()
        self.row = {}
        before = dict(ts.LAUNCHES)
        c0 = capture_s()
        t0 = time.perf_counter()
        self.op.step()
        torch.cuda.synchronize()
        row = dict(self.row, wall=time.perf_counter() - t0, launches=moved_since(ts, before),
                   calls=list(self.calls), capture_s=capture_s() - c0)
        if clock_s:
            self.op.clock.step(clock_s)
        return row


def hold_operator_step(name, op, row) -> list:
    """What every operator step must show: every pod bound, within
    allocatable, no plan rejected by the firewall, and each session solve
    on the problem a full encode of its pods gives, with nothing
    ``hold_race`` refuses. Returns the solved problems."""
    from karpenter_tpu_torch.solver import encode, validate

    cluster = op.cluster
    pending = cluster.pending_pods()
    result = row.get("result")
    if pending or (result is not None and result.unschedulable):
        raise AssertionError(f"{name}: {len(pending)} pods pending after the step, "
                             f"unschedulable {result.unschedulable[:5] if result else None}")
    hold_allocatable(name, cluster)
    if result is not None:
        bad = [e for e in result.validation_events if e["verdict"] != "accepted"]
        if bad:
            raise AssertionError(f"{name}: the firewall rejected a plan: {bad}")
    problems = []
    for order, provs, existing, daemonsets, solved in row["calls"]:
        full = encode(order, provs, existing, daemonsets)
        problems.append((hold_reconcile(name, op.provisioning.solver, solved, full, validate),
                         solved))
    return problems


def fleet_line(op) -> str:
    """The fleet's nodes and $/h, and the cost ledger's settled dollars as
    ``/debug/costs`` serves them."""
    cluster, deprov = op.cluster, op.deprovisioning
    costs = op.costledger.debug_payload()
    return (f"{len(cluster.nodes)} nodes, {fleet_price(deprov, cluster)!r} $/h, ledger settled "
            f"{costs['total_dollars']!r} $ (on-demand counterfactual "
            f"{costs['ondemand_dollars']!r} $, conservation {costs['conservation']})")


def step_line(name, row, problems) -> str:
    from karpenter_tpu_torch.solver import TorchSolver

    def race(p, s):
        if s.stats.get("race_winner"):
            verdict = "kernel won"
        elif p.__dict__.get("_race_kernel_lost"):
            verdict = "kernel lost"
        elif "_race_miss_count" in p.__dict__:
            verdict = "kernel missed"
        else:
            verdict = "not raced" + (" (under race_min_pods)"
                                     if p.count.sum() < TorchSolver.race_min_pods else "")
        device = s.stats.get("dispatch_device_ms")
        return verdict + (f", chain device {device} ms" if device is not None else "")

    solves = [f"{int(p.count.sum())} pods at E={p.E}, backend {s.stats['backend']}, {race(p, s)}"
              for p, s in problems]
    return (f"{name}: wall {row['wall']:.4f} s, interruption {row.get('handled')} messages "
            f"in {row.get('intr_s', 0.0):.4f} s, {row.get('repended', 0)} pods re-pended, "
            f"provisioning {row.get('prov_s', 0.0):.4f} s ({'; '.join(solves) or 'no solve'}), "
            f"deprovisioning {row.get('deprov_s', 0.0):.4f} s "
            f"({row['action'].reason if row.get('action') else 'no action'}), cost ledger "
            f"{row.get('ledger_s', 0.0):.4f} s, {capture_note(row['capture_s'], row['wall'])}, "
            f"launches {row['launches']}")


def operator_phase(ts, configs) -> dict:
    """Main path, the operator: ``Operator.new(provider, settings,
    cluster=cluster, clock=clock)`` with no solver given, over
    ``configs.config_operator()`` (50k pending pods, 400 types, a
    provisioner allowing spot and on-demand through the node template
    ``al2-tpl``), after ``OperatorContext.discover``. Every ``op.step()`` is
    held by ``hold_operator_step`` and logged by ``step_line``.

    (a) seed: the operator's default solver and its deprovisioning quality
        solver must be ``TorchSolver``s on the card; one step resolves the
        template and binds every pod, every instance launched from an
        ``al2`` launch template; the round's problem must be
        ``configs.config_operator_seed()``'s, its kernel-only cost the JAX
        package's ``operator_seed``, and on it K1, K2 and K3 are held
        against their plain versions (``check``);
    (b) interruption storm: a spot-interruption warning for the most
        loaded ``OPERATOR_STORM_FRAC`` of the spot nodes, with 3 duplicates
        and 3 garbage messages, then steps (``clock.step(5)``) until the queue is
        empty. Each step must re-bind the pods it drained, launch no node
        on an offering the storm marked unavailable, and leave no handled
        instance in the provider. K1, K2, K3 and ``rtt_probe`` must launch
        over the storm;
    (c) template drift: ``provider.rotate_image("al2", "standard")``, then
        ``OPERATOR_DRIFT_PASSES`` steps (``clock.step(30)``), each of which
        must replace one drifted node through the template, on the new
        image, with no pod left pending;
    (d) the entry point: ``python -m karpenter_tpu_torch`` in a subprocess
        on the card with a file lease, which must answer /healthz, /readyz
        and /leaderz, serve /metrics with the kernel board's gauge and no
        reconcile error, and exit 0 on SIGTERM with the lease released.

    Returns the launches of (a)-(c) and the largest differences of the
    kernel check."""
    import torch

    from karpenter_tpu_torch.api import labels as wk
    from karpenter_tpu_torch.cloudprovider.launchtemplate import NAME_PREFIX
    from karpenter_tpu_torch.context import OperatorContext
    from karpenter_tpu_torch.operator import Operator
    from karpenter_tpu_torch.solver import TorchSolver, encode, validate
    from karpenter_tpu_torch.solver.solver import KERNEL_BOARD, problem_digest
    from karpenter_tpu_torch.utils.flightrecorder import FLIGHT

    KERNEL_BOARD.reset()
    TorchSolver._device_rtt_s = None
    t0 = time.perf_counter()
    cluster, provider, settings, clock = configs.config_operator()
    ctx = OperatorContext.discover(provider=provider, settings=settings)
    op = Operator.new(provider, settings, cluster=cluster, clock=clock)
    log(f"operator config: {len(cluster.pods)} pending pods, {len(provider.catalog)} types, "
        f"cluster {ctx.cluster_info.name} in {ctx.region}, built in "
        f"{time.perf_counter() - t0:.2f} s")
    solvers = {"provisioning": op.provisioning.solver,
               "deprovisioning quality": op.deprovisioning.quality_solver}
    for role, s in solvers.items():
        if not isinstance(s, TorchSolver) or s.device.type != "cuda":
            raise AssertionError(f"operator: the {role} solver is {s!r} on "
                                 f"{getattr(s, 'device', None)}, not a TorchSolver on the card")
    if op.costledger is None or op.interruption is None or op.nodetemplate is None:
        raise AssertionError("operator: the cost ledger, interruption or node-template "
                             "controller was not built")
    probe = OperatorProbe(op)
    oracle = TorchSolver()
    launches = {k: 0 for k in ts.LAUNCHES}
    errs = {}
    try:
        # (a) the seed round
        row = probe.step(ts)
        launches = {k: launches[k] + row["launches"][k] for k in launches}
        problems = hold_operator_step("operator seed", op, row)
        if len(problems) != 1 or len(row["result"].bound) != len(cluster.pods):
            raise AssertionError(f"operator seed: {len(problems)} solves, "
                                 f"{len(row['result'].bound)} of {len(cluster.pods)} pods bound")
        problem, solved = problems[0]
        want = problem_digest(encode(*configs.config_operator_seed()))
        if problem_digest(problem) != want:
            raise AssertionError("operator seed: the round's problem is not config_operator_seed()")
        kernel = oracle._solve_kernel(problem)
        torch.cuda.synchronize()
        if validate(problem, kernel):
            raise AssertionError("operator seed: the kernel-only plan fails validation")
        ref = configs.REFERENCE_COSTS["operator_seed"]
        if abs(kernel.cost - ref) > COST_RTOL * ref:
            raise AssertionError(f"operator seed: kernel-only cost {kernel.cost!r}, "
                                 f"JAX package {ref!r}")
        for machine in cluster.machines.values():
            inst = provider.instance_for(machine)
            if not (inst.launch_template.startswith(NAME_PREFIX) and inst.image_family == "al2"
                    and inst.image_id.startswith("img-al2-")):
                raise AssertionError(f"operator seed: {machine.name} launched from "
                                     f"{inst.launch_template!r}, image {inst.image_id}")
        templates = sorted({provider.instance_for(m).launch_template
                            for m in cluster.machines.values()})
        log(step_line("operator seed", row, problems))
        log(f"operator seed: kernel-only cost {kernel.cost!r}, plan cost {solved.cost!r}, "
            f"{len(templates)} launch templates, {fleet_line(op)}; card {card_line()}")
        c = check(ts, "operator_seed", problem, oracle)
        errs.update(c["errs"])
        del c, problems, problem, kernel

        # (b) the interruption storm
        # the most loaded spot nodes first, so that a step's ten messages
        # re-pend enough pods to race the kernel (race_min_pods)
        load = {n.name: len(cluster.pods_on_node(n.name)) for n in cluster.nodes.values()
                if n.meta.labels.get(wk.CAPACITY_TYPE) == wk.CAPACITY_TYPE_SPOT}
        spot = sorted((cluster.nodes[name] for name in load), key=lambda n: (-load[n.name], n.name))
        targets = spot[: max(1, int(len(spot) * OPERATOR_STORM_FRAC))]
        per_node = sorted(load[n.name] for n in targets)
        queue = op.interruption.queue

        def warning(node):
            return {"version": "0", "source": "cloud.compute",
                    "detail-type": "Spot Instance Interruption Warning",
                    "detail": {"instance-id": node.provider_id.rsplit("/", 1)[-1]}}

        for node in targets:
            queue.send(warning(node))
        for node in targets[:3]:
            queue.send(warning(node))
        queue.send_raw("{not json")
        queue.send_raw("}}} garbage")
        queue.send({"version": "9", "source": "unknown", "detail-type": "???"})
        target_ids = {n.provider_id.rsplit("/", 1)[-1] for n in targets}
        log(f"operator storm: {len(targets)} of {len(spot)} spot nodes ({len(cluster.nodes)} "
            f"nodes), {len(queue)} messages; pods a target node min/median/max "
            f"{per_node[0]}/{per_node[len(per_node) // 2]}/{per_node[-1]}, a spot node "
            f"{min(load.values())}/{statistics.median(load.values())}/{max(load.values())}")
        KERNEL_BOARD.reset()
        TorchSolver._device_rtt_s = None
        storm = {k: 0 for k in ts.LAUNCHES}
        steps = 0
        while len(queue):
            steps += 1
            name = f"operator storm step {steps}"
            before_nodes = set(cluster.nodes)
            last = FLIGHT.latest("provisioning")
            row = probe.step(ts, clock_s=5.0)
            storm = {k: storm[k] + row["launches"][k] for k in storm}
            problems = hold_operator_step(name, op, row)
            if steps == 1:
                # the replay phase's capsule (c), dumped for the CLI's counterfactual
                keep_capsule("c", "provisioning", since=last, dump=True)
            for node_name in set(cluster.nodes) - before_nodes:
                node = cluster.nodes[node_name]
                pool = (node.instance_type(), node.zone(), node.meta.labels[wk.CAPACITY_TYPE])
                if provider.unavailable_offerings.is_unavailable(*pool):
                    raise AssertionError(f"{name}: {node_name} launched on {pool}, marked "
                                         "unavailable by the storm")
            queued = {json.loads(m.body).get("detail", {}).get("instance-id")
                      for m in queue._messages.values() if m.body.startswith("{\"")}
            left = (target_ids - queued) & set(provider.instances)
            if left:
                raise AssertionError(f"{name}: interrupted instances {sorted(left)[:5]} still run")
            log(step_line(name, row, problems) + f"; {fleet_line(op)}")
            if steps > 4 * len(targets) + 10:
                raise AssertionError("operator storm: the queue does not drain")
        launches = {k: launches[k] + storm[k] for k in launches}
        log(f"operator storm: {steps} steps, {len(provider.unavailable_offerings.entries())} "
            f"offerings marked unavailable, launches {storm}; card {card_line()}")
        missing = [k for k in (*PACK_KERNELS, "rtt_probe") if storm[k] < 1]
        if missing:
            raise AssertionError(f"operator storm: {missing} not launched: {storm}")

        # (c) template drift, cut to OPERATOR_DRIFT_PASSES passes
        image = provider.rotate_image("al2", "standard")
        for p in range(OPERATOR_DRIFT_PASSES):
            name = f"operator drift pass {p}"
            before_nodes = set(cluster.nodes)
            row = probe.step(ts, clock_s=30.0)
            launches = {k: launches[k] + row["launches"][k] for k in launches}
            problems = hold_operator_step(name, op, row)
            action = row.get("action")
            added, removed = set(cluster.nodes) - before_nodes, before_nodes - set(cluster.nodes)
            if action is None or action.reason != "drift" or len(removed) != 1 or not added:
                raise AssertionError(f"{name}: action {action and action.reason}, "
                                     f"{len(removed)} nodes removed, {len(added)} added")
            for node_name in added:
                inst = provider.instance_for(cluster.machine_for_node(cluster.nodes[node_name]))
                if inst.image_id != image or not inst.launch_template.startswith(NAME_PREFIX):
                    raise AssertionError(f"{name}: the replacement runs {inst.image_id} from "
                                         f"{inst.launch_template!r}, not {image}")
            log(step_line(name, row, problems) + f"; {fleet_line(op)}")
        log(f"operator drift: image {image}, {OPERATOR_DRIFT_PASSES} nodes replaced; "
            f"card {card_line()}")
    finally:
        op.close()
    log(f"operator launches {launches}")
    hold_pack_launches("operator", launches)
    del op, cluster, provider, probe, oracle
    entrypoint_check()
    return dict(launches=launches, errs=errs)


def entrypoint_check() -> None:
    """``python -m karpenter_tpu_torch`` on the card in a subprocess, with a
    file lease under ``build/``: its probes must answer, ``/metrics`` must
    parse and carry the kernel board's gauge and no reconcile error, and
    SIGTERM must stop it with exit code 0 and the lease released."""
    import os
    import signal
    import socket
    import urllib.error
    import urllib.request

    root = Path(__file__).resolve().parent
    lease = root / "build" / "operator_lease"
    lease.parent.mkdir(parents=True, exist_ok=True)
    for stale in (lease, lease.with_name(lease.name + ".lock")):
        stale.unlink(missing_ok=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
            return r.status, r.read().decode()

    env = dict(os.environ, PYTHONPATH=str(root))
    err_path = lease.with_name("operator_stderr.log")
    err = open(err_path, "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "karpenter_tpu_torch", "--metrics-port", str(port),
         "--metrics-bind", "127.0.0.1", "--leader-elect", "--leader-elect-lease", str(lease),
         "--tick", "0.05"],
        cwd=root, env=env, stdout=subprocess.DEVNULL, stderr=err,
    )

    def stderr_tail() -> str:
        err.flush()
        return err_path.read_text()[-2000:]

    try:
        while True:
            try:
                if all(get(p)[0] == 200 for p in ("/healthz", "/readyz", "/leaderz")):
                    break
            except (urllib.error.URLError, ConnectionError, OSError):
                pass
            if proc.poll() is not None:
                raise AssertionError(f"entry point exited {proc.returncode} before it was "
                                     f"ready: {stderr_tail()}")
            if time.perf_counter() - t0 > ENTRYPOINT_READY_S:
                raise AssertionError("entry point: no answer to its probes")
            time.sleep(0.1)
        ready_s = time.perf_counter() - t0
        body = get("/metrics")[1]
        series = {}
        for line in body.splitlines():
            if line and not line.startswith("#"):
                key, value = line.rsplit(" ", 1)
                series[key] = float(value)
        if not series or not all(k.startswith("karpenter_") for k in series):
            raise AssertionError("entry point: /metrics holds no karpenter_ series")
        if series.get("karpenter_tpu_kernel_backend_health") != 1.0:
            raise AssertionError("entry point: the kernel board's gauge is missing or unhealthy")
        errors = {k: v for k, v in series.items()
                  if k.startswith("karpenter_tpu_controller_reconcile_errors_total") and v}
        if errors:
            raise AssertionError(f"entry point: loops recorded errors: {errors}")
        if not lease.exists():
            raise AssertionError("entry point: leader, but no lease file")
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=ENTRYPOINT_EXIT_S)
        exit_s = time.perf_counter() - t1
        if rc != 0:
            raise AssertionError(f"entry point: exit code {rc} after SIGTERM: {stderr_tail()}")
        if lease.exists():
            raise AssertionError("entry point: the lease was not released")
        log(f"entry point: ready in {ready_s:.2f} s, {len(series)} series on /metrics, exit 0 "
            f"{exit_s:.2f} s after SIGTERM; card {card_line()}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err.close()


#: the http_tier phase: (a)'s pods in the store, the pods its churn step
#: deletes and adds, and (b)'s waves; (b)'s replicas take the lease and
#: renewal of ``tests/test_leader_ha.py``
HTTP_PODS = 10_000
HTTP_CHURN = 250
HA_WAVE = 1_000
HA_LEASE_S = 3.0
HA_RENEW_S = 0.5
#: the standby's acquire loop polls the lease once a second
#: (``LeaderElector.acquire``): a takeover lands within one lease and one
#: poll of the SIGKILL
HA_POLL_S = 1.0
HA_READY_S = 300.0
HA_BIND_S = 300.0


class WireProbe(OperatorProbe):
    """``OperatorProbe`` for the operator over the wire, plus the time each
    step spends on it, from both ends of every call: the HTTP cluster's
    relists and binds, the HTTP provider's launches (``/v1/run-instances``,
    on the controller's launch threads) and queue calls, and the session
    solves. Each is kept as (calls, seconds summed over the calls, first
    start, last end), so a split reads both the summed and the spanned
    time."""

    def __init__(self, op):
        super().__init__(op)
        self.lock = threading.Lock()
        self.spent = {}
        solver, cluster, provider = op.provisioning.solver, op.cluster, op.provider
        call = provider._call
        solver.solve_pods = self.timed("solve", solver.solve_pods)
        cluster.bind_pod = self.timed("bind", cluster.bind_pod)
        cluster.relist = self.timed("relist", cluster.relist)
        launch, queue = self.timed("launch", call), self.timed("queue", call)
        other = self.timed("cloud", call)

        def cloud(path, body=None):
            if path == "/v1/run-instances":
                return launch(path, body)
            return (queue if path.startswith("/v1/queue/") else other)(path, body)

        provider._call = cloud

    def timed(self, key, fn):
        def call(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                end = time.perf_counter()
                with self.lock:
                    n, total, first, last = self.spent.get(key, (0, 0.0, t, end))
                    self.spent[key] = (n + 1, total + end - t, min(first, t), max(last, end))
        return call

    def step(self, ts, clock_s: float = 0.0) -> dict:
        self.spent = {}
        row = super().step(ts, clock_s)
        row["wire"] = dict(self.spent)
        return row


def wire_line(row) -> str:
    parts = []
    for key in ("relist", "solve", "launch", "bind", "queue", "cloud"):
        if key in row["wire"]:
            n, total, first, last = row["wire"][key]
            parts.append(f"{key} {n} calls {total:.4f} s summed, {last - first:.4f} s spanned"
                         + (f" ({1e3 * total / n:.4f} ms a bind)" if key == "bind" else ""))
    return f"wire: {'; '.join(parts) or 'no call'}; capture {row['capture_s']:.4f} s"


def instance_ids(machines) -> set:
    return {m.status.provider_id.rsplit("/", 1)[-1] for m in machines}


def hold_wire_step(name, op, store, svc, row, mode) -> list:
    """``hold_operator_step`` on the operator's informer cache (its watch
    applier paused), then the same from the server side: every pod of the API server's store bound
    within its node's allocatable, the session's encode mode, no client
    token that committed two instances (``launch_audit``), and the cloud's
    instances exactly the store's machines, one node each. A step whose
    solves all sit under ``race_min_pods`` must launch no packing kernel.
    Returns the solved problems."""
    from karpenter_tpu_torch.solver import TorchSolver

    with op.cluster.quiesce():  # the watch applier must not move the cache under the checks
        problems = hold_operator_step(name, op, row)
    pending = store.pending_pods()
    if pending:
        raise AssertionError(f"{name}: the server's store holds {len(pending)} pending pods")
    hold_allocatable(name + " (server store)", store)
    got = op.provisioning.encode_session.last_mode
    if got != mode:
        raise AssertionError(f"{name}: encoded {got} "
                             f"({op.provisioning.encode_session.last_full_reason}), not {mode}")
    audit = svc.launch_audit()
    if audit["duplicate_tokens"] or audit["untokened"]:
        raise AssertionError(f"{name}: launch audit {audit['duplicate_tokens']}, "
                             f"{audit['untokened']} launches without a token")
    machines = list(store.machines.values())
    if set(svc.instances) != instance_ids(machines) or len(store.nodes) != len(machines):
        raise AssertionError(f"{name}: {len(svc.instances)} instances, {len(machines)} machines, "
                             f"{len(store.nodes)} nodes in the store")
    small = all(p.count.sum() < TorchSolver.race_min_pods for p, _ in problems)
    if small and any(row["launches"][k] for k in PACK_KERNELS):
        raise AssertionError(f"{name}: no solve reached race_min_pods, yet the chain launched: "
                             f"{row['launches']}")
    return problems


def http_operator(ts, configs) -> dict:
    """(a) of ``http_tier_phase``: one operator over the wire, in process.
    Returns its launches and the largest differences of the kernel check."""
    import torch

    from karpenter_tpu_torch.api import ObjectMeta, Pod
    from karpenter_tpu_torch.api import labels as wk
    from karpenter_tpu_torch.cloudprovider.httpcloud import HTTPCloudProvider, HTTPQueue
    from karpenter_tpu_torch.operator import Operator
    from karpenter_tpu_torch.solver import TorchSolver, encode, validate
    from karpenter_tpu_torch.solver.solver import KERNEL_BOARD, problem_digest
    from karpenter_tpu_torch.state import ClusterAPIServer, HTTPCluster

    KERNEL_BOARD.reset()
    TorchSolver._device_rtt_s = None
    t0 = time.perf_counter()
    store, svc, settings, clock = configs.config_http_tier(HTTP_PODS)
    svc.start()
    api = ClusterAPIServer(backing=store).start()
    built_s = time.perf_counter() - t0
    clients = []
    op = None
    try:
        t0 = time.perf_counter()
        cluster = HTTPCluster(api.endpoint, queue_capacity=settings.watch_queue_capacity)
        clients.append(cluster)
        relist_s = time.perf_counter() - t0
        provider = HTTPCloudProvider(svc.endpoint)
        op = Operator.new(provider=provider, settings=settings, cluster=cluster, clock=clock)
        log(f"http_tier (a): {len(store.pods)} pending pods in the API server's store, "
            f"{len(svc.catalog)} types in the cloud service, built in {built_s:.2f} s; the "
            f"operator's first relist {relist_s:.4f} s ({len(cluster.pods)} pods cached)")
        solvers = {"provisioning": op.provisioning.solver,
                   "deprovisioning quality": op.deprovisioning.quality_solver}
        for role, s in solvers.items():
            if not isinstance(s, TorchSolver) or s.device.type != "cuda":
                raise AssertionError(f"http_tier: the {role} solver is {s!r} on "
                                     f"{getattr(s, 'device', None)}, not a TorchSolver on the card")
        if op.interruption is None or not isinstance(op.interruption.queue, HTTPQueue):
            raise AssertionError("http_tier: the interruption controller does not poll the "
                                 "service's queue over the wire")
        probe = WireProbe(op)
        oracle = TorchSolver()
        launches = {k: 0 for k in ts.LAUNCHES}

        # 1. the seed step
        name = "http seed"
        row = probe.step(ts)
        launches = {k: launches[k] + row["launches"][k] for k in launches}
        problems = hold_wire_step(name, op, store, svc, row, "full")
        if len(problems) != 1 or len(row["result"].bound) != len(store.pods):
            raise AssertionError(f"{name}: {len(problems)} solves, "
                                 f"{len(row['result'].bound)} of {len(store.pods)} pods bound")
        hold_pack_launches(name, row["launches"])
        problem, solved = problems[0]
        digest = problem_digest(problem)
        if digest == problem_digest(encode(*configs.config_operator_seed(HTTP_PODS))):
            raise AssertionError(f"{name}: the wire's problem is the in-process seed's, yet the "
                                 "HTTP cloud serves no price refresh")
        if digest != problem_digest(encode(*configs.config_http_seed(HTTP_PODS))):
            raise AssertionError(f"{name}: the round's problem is not config_http_seed()")
        kernel = oracle._solve_kernel(problem)
        torch.cuda.synchronize()
        if validate(problem, kernel):
            raise AssertionError(f"{name}: the kernel-only plan fails validation")
        ref = configs.REFERENCE_COSTS["http_seed"]
        if abs(kernel.cost - ref) > COST_RTOL * ref:
            raise AssertionError(f"{name}: kernel-only cost {kernel.cost!r}, JAX package {ref!r}")
        log(step_line(name, row, problems))
        log(f"{name}: {wire_line(row)}; kernel-only cost {kernel.cost!r} (the JAX package's "
            f"http_seed), plan cost {solved.cost!r}, {len(store.nodes)} nodes, "
            f"{len(svc.instances)} instances; card {card_line()}")
        c = check(ts, "http_seed", problem, oracle)
        errs = dict(c["errs"])
        del c, problems, problem, kernel

        # 2. churn through a second client: its writes reach the operator as
        # watch events, which its session delta-encodes
        name = "http churn"
        writer = HTTPCluster(api.endpoint, watch=False)
        clients.append(writer)
        gone = sorted(store.pods)[:HTTP_CHURN]
        added = [f"churn-{i}" for i in range(HTTP_CHURN)]
        t0 = time.perf_counter()
        for pod_name in gone:
            writer.delete_pod(pod_name)
        for i, pod_name in enumerate(added):
            writer.add_pod(Pod(meta=ObjectMeta(name=pod_name, owner_kind="ReplicaSet"),
                               requests=configs._cell_requests(i % 30)))
        writes_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        while not (all(n in cluster.pods for n in added) and not any(n in cluster.pods for n in gone)):
            if time.perf_counter() - t0 > 60:
                raise AssertionError(f"{name}: the operator's watch did not deliver the churn")
            time.sleep(0.01)
        seen_s = time.perf_counter() - t0
        row = probe.step(ts)
        launches = {k: launches[k] + row["launches"][k] for k in launches}
        problems = hold_wire_step(name, op, store, svc, row, "delta")
        if sorted(row["result"].bound) != sorted(added):
            raise AssertionError(f"{name}: bound {len(row['result'].bound)} pods, not the "
                                 f"{HTTP_CHURN} added")
        log(step_line(name, row, problems))
        log(f"{name}: {2 * HTTP_CHURN} writes through a second client in {writes_s:.4f} s, in "
            f"the operator's cache {seen_s:.4f} s later; {wire_line(row)}")

        # 3. a spot-interruption notice for the most loaded spot node, sent
        # over /v1/queue/*; its pods re-bind in the same step
        name = "http interruption"
        load = {n.name: len(store.pods_on_node(n.name)) for n in store.nodes.values()
                if n.meta.labels.get(wk.CAPACITY_TYPE) == wk.CAPACITY_TYPE_SPOT}
        target = store.nodes[min(load, key=lambda n: (-load[n], n))]
        target_id = target.provider_id.rsplit("/", 1)[-1]
        HTTPCloudProvider(svc.endpoint).queue.send({
            "version": "0", "source": "cloud.compute",
            "detail-type": "Spot Instance Interruption Warning",
            "detail": {"instance-id": target_id}})
        row = probe.step(ts)
        launches = {k: launches[k] + row["launches"][k] for k in launches}
        problems = hold_wire_step(name, op, store, svc, row, "delta")
        if row.get("handled") != 1 or row.get("repended") != load[target.name]:
            raise AssertionError(f"{name}: handled {row.get('handled')} messages, re-pended "
                                 f"{row.get('repended')} of the node's {load[target.name]} pods")
        if target.name in store.nodes or target_id in svc.instances:
            raise AssertionError(f"{name}: the interrupted node {target.name} still runs")
        log(step_line(name, row, problems))
        log(f"{name}: {target.name} held {load[target.name]} pods (spot nodes hold "
            f"{min(load.values())}-{max(load.values())}); {wire_line(row)}; "
            f"{len(svc.queue)} messages left; card {card_line()}")
        if len(svc.queue):
            raise AssertionError(f"{name}: the queue holds {len(svc.queue)} messages")
    finally:
        if op is not None:
            op.close()
        for client in clients:
            client.close()
        api.stop()
        svc.stop()
    log(f"http_tier (a) launches {launches}")
    hold_pack_launches("http_tier (a)", launches)
    return dict(launches=launches, errs=errs)


def ha_pair(configs) -> None:
    """(b) of ``http_tier_phase``: ``python -m karpenter_tpu_torch.state.apiserver``
    and two ``python -m karpenter_tpu_torch --leader-elect`` replicas on
    the card, subprocesses sharing one lease file under ``build/``, the
    state tier and an in-process ``CloudHTTPService``."""
    import os
    import signal
    import socket
    import urllib.error
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from karpenter_tpu_torch.api import ObjectMeta, Pod, Provisioner
    from karpenter_tpu_torch.cloudprovider import generate_catalog
    from karpenter_tpu_torch.cloudprovider.httpcloud import CloudHTTPService
    from karpenter_tpu_torch.state import HTTPCluster

    root = Path(__file__).resolve().parent
    work = root / "build" / "ha"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    lease = work / "lease"

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    def get(port, path):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, ""
        except (urllib.error.URLError, ConnectionError, OSError):
            return None, ""

    def series(port) -> dict:
        out = {}
        for line in get(port, "/metrics")[1].splitlines():
            if line and not line.startswith("#"):
                key, value = line.rsplit(" ", 1)
                out[key] = float(value)
        return out

    env = dict(os.environ, PYTHONPATH=str(root))
    procs, logs = {}, {}

    def spawn(tag, args):
        logs[tag] = open(work / f"{tag}.log", "w")
        procs[tag] = subprocess.Popen([sys.executable, "-m", *args], cwd=root, env=env,
                                      stdout=logs[tag], stderr=subprocess.STDOUT)

    def tail(tag) -> str:
        logs[tag].flush()
        return (work / f"{tag}.log").read_text()[-2000:]

    def wait(what, predicate, limit, tags=()):
        t0 = time.perf_counter()
        while not predicate():
            for tag in tags:
                if procs[tag].poll() is not None:
                    raise AssertionError(f"ha: {tag} exited {procs[tag].returncode} while "
                                         f"waiting for {what}: {tail(tag)}")
            if time.perf_counter() - t0 > limit:
                raise AssertionError(f"ha: no {what} within {limit} s")
            time.sleep(0.05)
        return time.perf_counter() - t0

    svc = CloudHTTPService(generate_catalog(n_types=400))
    for subnet in svc.subnets:
        subnet.available_ips = 1 << 20
    svc.start()
    api_port = free_port()
    client = None
    try:
        t0 = time.perf_counter()
        spawn("apiserver", ["karpenter_tpu_torch.state.apiserver", "--port", str(api_port)])
        api = f"http://127.0.0.1:{api_port}"
        wait("state tier", lambda: get(api_port, "/version")[0] == 200, 120, ("apiserver",))
        log(f"ha: state tier up in {time.perf_counter() - t0:.2f} s at {api}")
        client = HTTPCluster(api)
        client.add_provisioner(Provisioner(meta=ObjectMeta(name="default")))
        ports = {f"replica-{i}": free_port() for i in range(2)}
        t0 = time.perf_counter()
        for tag, port in ports.items():
            spawn(tag, ["karpenter_tpu_torch", "--leader-elect", "--leader-elect-lease", str(lease),
                        "--leader-lease-duration", str(HA_LEASE_S),
                        "--leader-renew-interval", str(HA_RENEW_S),
                        "--cluster-endpoint", api, "--cloud-endpoint", svc.endpoint,
                        "--metrics-port", str(port), "--metrics-bind", "127.0.0.1",
                        "--batch-idle-duration", "1", "--batch-max-duration", "10",
                        "--tick", "0.1"])

        def leading():
            return [tag for tag, port in ports.items() if get(port, "/leaderz")[0] == 200]

        wait("replica answering /healthz",
             lambda: all(get(p, "/healthz")[0] == 200 for p in ports.values()),
             HA_READY_S, tuple(ports))
        wait("leader", lambda: len(leading()) == 1, 60, tuple(ports))
        log(f"ha: two replicas up, one leading, {time.perf_counter() - t0:.2f} s after spawning")
        for _ in range(10):
            if len(leading()) != 1:
                raise AssertionError(f"ha: leaders {leading()}")
            time.sleep(0.1)
        leader = leading()[0]
        standby = next(tag for tag in ports if tag != leader)

        def post_wave(w):
            names = [f"wave{w}-{i}" for i in range(HA_WAVE)]
            pods = [Pod(meta=ObjectMeta(name=n, owner_kind="ReplicaSet"),
                        requests=configs._cell_requests(i % 30)) for i, n in enumerate(names)]
            t = time.perf_counter()
            with ThreadPoolExecutor(16) as pool:
                list(pool.map(client.add_pod, pods))
            posted_s = time.perf_counter() - t
            bound_s = wait(f"wave {w} bound", lambda: all(
                client.pods[n].node_name for n in names), HA_BIND_S, (leader,))
            return posted_s, bound_s

        def hold_leader(tag, wave):
            m = series(ports[tag])
            faults = {k: v for k, v in m.items() if k.startswith("karpenter_tpu_kernel_faults") and v}
            kernel = [k for k in m if k.startswith("karpenter_tpu_rpc_breaker_state")
                      and 'service="kernel"' in k]
            staging = {k: v for k, v in m.items() if k.startswith("karpenter_tpu_device_staging")}
            if faults or m.get("karpenter_tpu_kernel_backend_health") != 1.0:
                raise AssertionError(f"ha: {tag} kernel faults {faults}, backend health "
                                     f"{m.get('karpenter_tpu_kernel_backend_health')}")
            if not kernel or any(m[k] for k in kernel):
                raise AssertionError(f"ha: {tag} consulted no kernel breaker (the card never "
                                     f"dispatched) or one is open: {kernel}")
            errors = {k: v for k, v in m.items()
                      if k.startswith("karpenter_tpu_controller_reconcile_errors_total") and v}
            if errors:
                raise AssertionError(f"ha: {tag} loops recorded errors: {errors}")
            log(f"ha: {tag} after wave {wave}: kernel breakers {len(kernel)} closed "
                f"({', '.join(kernel)}), no kernel fault, staging {staging or 'no event'}")

        posted_s, bound_s = post_wave(1)
        log(f"ha: wave 1, {HA_WAVE} pods posted in {posted_s:.4f} s, all bound by {leader} "
            f"{bound_s:.4f} s later")
        hold_leader(leader, 1)
        t0 = time.perf_counter()
        procs[leader].kill()
        procs[leader].wait(timeout=30)
        killed = leader
        takeover_s = wait("takeover", lambda: get(ports[standby], "/leaderz")[0] == 200,
                          4 * (HA_LEASE_S + HA_POLL_S), (standby,))
        if takeover_s > HA_LEASE_S + HA_POLL_S + 0.5:
            raise AssertionError(f"ha: the standby took {takeover_s:.4f} s to lead, more than "
                                 f"one lease and one acquire poll")
        if get(ports[standby], "/readyz")[0] != 200:
            raise AssertionError("ha: the new leader is not ready")
        log(f"ha: {killed} SIGKILLed; {standby} leads {takeover_s:.4f} s later (lease "
            f"{HA_LEASE_S} s, renew {HA_RENEW_S} s, acquire poll {HA_POLL_S} s)")
        leader = standby
        posted_s, bound_s = post_wave(2)
        log(f"ha: wave 2, {HA_WAVE} pods posted in {posted_s:.4f} s, all bound by {leader} "
            f"{bound_s:.4f} s later")
        hold_leader(leader, 2)
        # no pod bound twice: every pod's events in the state tier's log name
        # one node at most, and the cloud committed no token twice
        status, body = get(api_port, "/watch?since=0&timeout=0")
        events = json.loads(body)["events"] if status == 200 else None
        if not events:
            raise AssertionError(f"ha: the state tier's watch log answered {status}")
        nodes_of = {}
        for ev in events:
            if ev["kind"] == "pods" and ev["object"].get("nodeName"):
                nodes_of.setdefault(ev["object"]["meta"]["name"], set()).add(
                    ev["object"]["nodeName"])
        twice = {k: v for k, v in nodes_of.items() if len(v) > 1}
        if twice or len(nodes_of) != 2 * HA_WAVE:
            raise AssertionError(f"ha: {len(nodes_of)} pods bound, bound twice: "
                                 f"{dict(list(twice.items())[:5])}")
        audit = svc.launch_audit()
        if audit["duplicate_tokens"] or audit["untokened"]:
            raise AssertionError(f"ha: launch audit {audit}")
        final = HTTPCluster(api, watch=False)
        machines = list(final.machines.values())
        final.close()
        if set(svc.instances) != instance_ids(machines):
            raise AssertionError(f"ha: {len(svc.instances)} instances, {len(machines)} machines")
        t0 = time.perf_counter()
        procs[leader].send_signal(signal.SIGTERM)
        rc = procs[leader].wait(timeout=ENTRYPOINT_EXIT_S)
        if rc != 0:
            raise AssertionError(f"ha: {leader} exited {rc} after SIGTERM: {tail(leader)}")
        log(f"ha: {len(events)} watch events, {len(nodes_of)} pods each bound once, "
            f"{audit['launches']} launches on {audit['tokens']} tokens, none twice; {leader} "
            f"exit 0 {time.perf_counter() - t0:.2f} s after SIGTERM; card {card_line()}")
    finally:
        if client is not None:
            client.close()
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in logs.values():
            f.close()
        svc.stop()


def http_tier_phase(ts, configs) -> dict:
    """Main path, the operator's HTTP tier: (a) one operator over the wire
    in process, ``Operator.new(provider=HTTPCloudProvider(svc.endpoint),
    cluster=HTTPCluster(api.endpoint), ...)`` with no solver given, over
    ``configs.config_http_tier()`` (a ``ClusterAPIServer`` whose store
    holds 10,000 pending pods, the ``al2-tpl`` template and the spot and
    on-demand provisioner; a ``CloudHTTPService`` over 400 types): the seed
    step (the problem ``configs.config_http_seed()``'s at the JAX package's
    kernel-only cost ``http_seed``, K1, K2 and K3 held against their plain
    versions on it), a churn step (``HTTP_CHURN`` pods deleted and as many
    added through a second client, delta-encoded from the watch), and an
    interruption step (a notice for the most loaded spot node over
    ``/v1/queue/*``, its pods re-bound in the same step), each held by
    ``hold_wire_step`` and split by ``WireProbe``; (b) the HA pair
    (``ha_pair``). Returns (a)'s launches and the largest differences of
    the kernel check."""
    t0 = time.perf_counter()
    out = http_operator(ts, configs)
    a_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ha_pair(configs)
    log(f"http_tier: (a) {a_s:.2f} s, (b) {time.perf_counter() - t0:.2f} s")
    return out


#: the replay phase's capsules, kept by the phases that record them:
#: (tag, what, controller kind)
REPLAYS = (
    ("a", "controller_50k seed round", "provisioning"),
    ("b", "controller_50k churn round 0", "provisioning"),
    ("c", "operator storm step 1", "provisioning"),
    ("d", "controller_cells worker check, 1 worker", "provisioning"),
    ("e", "consolidation_300 pass 0", "deprovisioning"),
)
REPLAY_CLI_S = 900.0


def replay_solves(solves) -> str:
    """The ``TorchSolver.solve`` calls of a replay: each one's pods, E,
    budget, backend and race verdict (``race_winner``), or beyond eight
    solves their count by budget, backend and verdict."""
    from collections import Counter

    rows = []
    for problem, result, budget in solves:
        st = result.stats
        verdict = ("kernel won" if st.get("race_winner") else
                   "kernel lost" if problem.__dict__.get("_race_kernel_lost") else "not raced")
        rows.append((int(problem.count.sum()), problem.E, budget, st.get("backend"),
                     st.get("race_winner"), verdict))
    if len(rows) > 8:
        counts = Counter(r[2:] for r in rows)
        return (f"{len(rows)} solves of {min(r[0] for r in rows)}-{max(r[0] for r in rows)} pods: "
                + ", ".join(f"{n} at budget {b} s, backend {be}, race_winner {w} ({v})"
                            for (b, be, w, v), n in sorted(counts.items(), key=str)))
    return "; ".join(f"{p} pods at E={e}, budget {b} s, backend {be}, race_winner {w} ({v})"
                     for p, e, b, be, w, v in rows) or "no TorchSolver solve"


def replay_cli(tag, *args) -> str:
    """``python -m karpenter_tpu_torch.replay`` on capsule ``tag``'s dump in
    a subprocess on the card: it must exit 0. Returns its summary."""
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "karpenter_tpu_torch.replay",
                          CAPSULE_PATHS[tag], *args], cwd=root, capture_output=True,
                         text=True, timeout=REPLAY_CLI_S)
    wall = time.perf_counter() - t0
    summary = "\n".join(out.stdout.strip().splitlines()[:12])
    if out.returncode != 0:
        raise AssertionError(f"replay CLI on ({tag}) {list(args)}: exit code {out.returncode}\n"
                             f"{summary}\n{out.stderr[-3000:]}")
    log(f"replay CLI on ({tag}) {list(args)}: exit 0 in {wall:.2f} s:\n{summary}")
    return summary


def replay_phase(ts, st) -> dict:
    """Main path, the offline replay: each capsule an earlier phase recorded
    on the card (``REPLAYS``; ``keep_capsule``), through a JSON round trip,
    replayed by ``replay_capsule(capsule, solver="torch-quality")``, the
    quality-mode ``TorchSolver`` on the card. A provisioning replay must
    match the record's digests, placements, unschedulable pods and
    decisions, a deprovisioning replay its action. One divergence is the
    reference's own and is allowed: a recorded latency-mode round whose
    host plan its deadline cut short, which the quality replay polishes to
    a cheaper plan on the same problems (equal digests, lower cost). Such a
    capsule is replayed again with the solver it names (``TorchSolver``,
    latency mode), which must match. Each replay's launches are counted
    alone: K1, K2 and K3 must launch in (a), (c) and (e), a batched chain
    in (d), whose rows are held against the plain chain. On the largest
    problem (a)'s replay solved, K1, K2 and K3 are held against their plain
    versions (``check``). Then the replay CLI in a subprocess on (a)'s dump
    and a counterfactual on (c)'s, the storm's masked offering made
    available again; both must exit 0. Returns the launches of the matching
    replays and the largest differences of the kernel check."""
    import torch

    from karpenter_tpu_torch.replay import replay_capsule
    from karpenter_tpu_torch.solver import TorchSolver
    from karpenter_tpu_torch.solver.solver import KERNEL_BOARD

    solver_mod = importlib.import_module("karpenter_tpu_torch.solver.solver")
    launches = {k: 0 for k in ts.LAUNCHES}
    solves, errs, rebuilt = [], {}, None
    # the offering the storm marked unavailable, for the counterfactual
    ice = CAPSULES["c"]["inputs"]["ice_entries"]
    if not ice:
        raise AssertionError("replay (c): the storm step's capsule names no masked offering")
    solve = TorchSolver.solve

    def recording_solve(solver, problem):
        result = solve(solver, problem)
        solves.append((problem, result, solver.latency_budget_s))
        return result

    def replay(tag, capsule, solver):
        KERNEL_BOARD.reset()
        TorchSolver._device_rtt_s = None
        solves.clear()
        before = dict(ts.LAUNCHES)
        t0 = time.perf_counter()
        with recording(solver_mod) as (stacks, fleets):
            report = replay_capsule(json.loads(json.dumps(capsule, default=str)), solver=solver)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        moved = moved_since(ts, before)
        diffs = {k: v for k, v in report["diffs"].items() if k != "placement_diffs"}
        rec, rep = report["recorded"].get("cost_delta"), report["replayed"].get("cost_delta")
        log(f"replay ({tag}) through {solver}: {'MATCH' if report['match'] else 'DIVERGED'} in "
            f"{wall:.4f} s, diffs {diffs}, "
            f"{len(report['diffs'].get('placement_diffs', {}))} placements differ, $/h recorded "
            f"{rec and rec['actual_per_hr']} replayed {rep and rep['actual_per_hr']}, solves "
            f"[{replay_solves(solves)}], fleet widths {sorted(b.shape[0] for _, b in fleets)}, "
            f"launches {moved}")
        return report, moved, stacks, fleets

    TorchSolver.solve = recording_solve
    try:
        for tag, what, kind in REPLAYS:
            capsule = CAPSULES.pop(tag)
            log(f"replay ({tag}): {what}, capsule {capsule['id']}, "
                f"{len(capsule['inputs']['objects']['pods'])} pods, "
                f"{len(capsule['outputs']['problem_digests'])} digests, recorded on "
                f"{capsule.get('solver')}")
            report, moved, stacks, fleets = replay(tag, capsule, "torch-quality")
            if not report["match"]:
                d = report["diffs"]
                rec = report["recorded"].get("cost_delta") or {}
                rep = report["replayed"].get("cost_delta") or {}
                cut = (kind == "provisioning" and d.get("digests_match")
                       and rep.get("actual_per_hr", float("inf"))
                       < rec.get("actual_per_hr", float("-inf")))
                if not cut:
                    raise AssertionError(f"replay ({tag}): diverged: {d}")
                log(f"replay ({tag}): the quality replay found a cheaper plan for the same "
                    f"problems: the recorded latency round's deadline cut its host plan short; "
                    f"replaying with the recorded solver")
                report, moved, stacks, fleets = replay(tag, capsule, capsule.get("solver"))
                if not report["match"]:
                    raise AssertionError(f"replay ({tag}): diverged through the recorded "
                                         f"solver too: {report['diffs']}")
            d = report["diffs"]
            if kind == "provisioning":
                held = ("digests_match", "placements_match", "unschedulable_match",
                        "decisions_match")
                if not all(d[k] for k in held):
                    raise AssertionError(f"replay ({tag}): {d}")
            elif not d["action_match"]:
                raise AssertionError(f"replay ({tag}): {d}")
            launches = {k: launches[k] + moved[k] for k in launches}
            if tag in ("a", "c", "e"):
                hold_pack_launches(f"replay ({tag})", moved)
            if tag == "d":
                if not fleets:
                    raise AssertionError(f"replay (d): no batched chain ran: {moved}")
                errs["pack_member"] = max(errs.get("pack_member", 0.0),
                                          hold_dispatches(ts, st, "replay (d)", stacks, fleets))
            if tag == "a":
                rebuilt = max(solves, key=lambda s: int(s[0].count.sum()))[0]
            del capsule, report, stacks, fleets
        solves.clear()
    finally:
        TorchSolver.solve = solve
    c = check(ts, "replay_a", rebuilt, TorchSolver())
    for k, v in c["errs"].items():
        errs[k] = max(errs.get(k, 0.0), v)
    del c, rebuilt
    log(f"replay launches {launches}; card {card_line()}")
    replay_cli("a")
    it, zone, ct = ice[0]
    summary = replay_cli("c", "--override", f"offerings={it}/{zone}/{ct}=available")
    if "counterfactual of capsule" not in summary:
        raise AssertionError(f"replay CLI on (c): not a counterfactual: {summary}")
    return dict(launches=launches, errs=errs)


def load_tree(root: Path, tag: str):
    """Another checkout's ``torch_solver`` module and kernel library, built
    from its own sources by its own ``_build`` (into its own ``build/``),
    under module names of their own."""
    import ctypes
    import importlib.util

    mods = {}
    for name in ("_build", "torch_solver"):
        path = root / "karpenter_tpu_torch" / "solver" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"{tag}_{name}", path)
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    build = mods["_build"]
    return mods["torch_solver"], build.bind(ctypes.CDLL(str(build.build())))


COMPARE_PARTS = K1_PARTS + K2_PARTS + ("k3_pack_epilogue",)


def compare(ts, other: Path) -> None:
    """This tree's K1 and K3 against those of the checkout at ``other``, in
    one process on one card: at 50k_full, 10k_topology and 10k_crossgroup
    (each at the slot budget its solve reaches) and on the fleet bucket at
    B=1, 4, 8 and 16, in turns other, this, this, other. Each turn times K1,
    K3 and the whole chain behind a spin, and each kernel of the chain from
    a profiler trace (k2_prices reads the table K1 has just written). Both
    trees' chains must give the same buffer. Logs each turn and the mean of
    each tree's two turns."""
    import torch

    from karpenter_tpu_torch import configs
    from karpenter_tpu_torch.solver import TorchSolver, _build, encode

    sides = {"other": load_tree(other, "other"), "this": (ts, _build.load_kernels())}
    solver = TorchSolver()
    shapes = {}
    for name, make in (("50k_full", configs.config_50k_full),
                       ("10k_topology", configs.config_10k_topology),
                       ("10k_crossgroup", configs.config_10k_crossgroup)):
        problem = encode(*make())
        _, orders, _, _, _, swaps, s_new, nz = solver._prepare(problem)
        tensors = device_problem(ts, solver, problem)
        _, S, _ = solver._run_fused(tensors, orders, swaps, s_new, nz)
        shapes[name] = (tensors, S)
    cells, provs, catalog = configs.config_cells()
    _, _, key, real, _ = fleet_rows(ts, configs, cells, provs, catalog)
    for B in (1, 4, 8, 16):
        shapes[f"fleet B={B}"] = (stack_rows(ts, [real[i % len(real)] for i in range(B)])
                                  if B > 1 else real[0], key.S)

    def runners(side, args, S):
        sts, lib = sides[side]
        inputs, o, a, l, r, sw = args

        def k1():
            return sts._launch_shared_precompute(lib, inputs, S, ts._stream())

        def chain():
            sh = k1()
            m1 = sts._launch_pack_member(lib, inputs, sh, o, a, l, r, S, None, None, ts._stream())
            m2 = sts._launch_pack_member(lib, inputs, sh, o, a, l, r, S, sw, m1.cost, ts._stream())
            return sts._launch_pack_epilogue(lib, m1, m2, ts._stream())

        return k1, chain

    results = {}
    for name, (args, S) in shapes.items():
        inputs, o, a, l, r, sw = args
        nz = inputs.rel_zone_bits.shape[-1]
        sk = ts.shared_precompute(inputs, S, nz)
        m1 = ts.pack_member(inputs, sk, o, a, l, r, S, nz)
        m2 = ts.pack_member(inputs, sk, o, a, l, r, S, nz, swaps=sw, seed_costs=m1.cost)
        bufs = {side: runners(side, args, S)[1]() for side in sides}
        if not torch.equal(bufs["this"], bufs["other"]):
            raise AssertionError(f"compare {name}: the two trees' chains give different buffers")
        for turn, side in enumerate(("other", "this", "this", "other")):
            sts, lib = sides[side]
            k1, chain = runners(side, args, S)
            t = {
                "k1": time_ms(k1),
                "k3": time_ms(lambda: sts._launch_pack_epilogue(lib, m1, m2, ts._stream())),
                "chain": time_ms(chain),
                **kernel_parts_ms(chain, COMPARE_PARTS),
            }
            results.setdefault(name, {}).setdefault(side, []).append(t)
            log(f"compare {name} turn {turn} {side}: " + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))
    log("compare, ms (mean of two turns; this / other):")
    for name, by in results.items():
        keys = by["this"][0].keys()
        mean = {side: {k: statistics.mean(t.get(k, 0.0) for t in by[side]) for k in keys} for side in by}
        log(f"  {name}: " + "; ".join(f"{k} {mean['this'][k]:.4f} / {mean['other'][k]:.4f}" for k in keys))


def main() -> int:
    root = Path(__file__).resolve().parent
    if not (root / "karpenter_tpu_torch" / "solver" / "csrc" / "pack_solve.cu").is_file():
        log("chip_smoke: karpenter_tpu_torch/ not found beside this script")
        return 2
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available")
        return 3
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} ({torch.cuda.device_count()} visible), {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if sys.argv[1:2] == ["--compare"]:
        from karpenter_tpu_torch.solver import torch_solver as ts

        compare(ts, Path(sys.argv[2]).resolve())
        log(card)
        return 0

    from karpenter_tpu_torch import configs
    from karpenter_tpu_torch.solver import TorchSolver, encode
    from karpenter_tpu_torch.solver import _build

    shutil.rmtree(CAPSULE_DIR, ignore_errors=True)
    from karpenter_tpu_torch.solver import staging as st
    from karpenter_tpu_torch.solver import torch_solver as ts

    t0 = time.perf_counter()
    lib = _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"({'compiled' if _build.BUILD_SECONDS else 'cached'}) -> {lib}")
    ptxas = lib.with_name("ptxas.log")
    log(ptxas.read_text().strip() if ptxas.exists() else "")
    log(f"instructions (cuobjdump -sass): "
        f"{sass_counts(lib, K1_PARTS + K2_PARTS + ('k3_pack_epilogue',)) or 'no cuobjdump'}")
    _build.load_kernels()
    from karpenter_tpu_torch import native

    t0 = time.perf_counter()
    if native.load_encoder() is None:
        raise AssertionError("the native encoder (karpenter_tpu_torch/native/encoder.c) did not build")
    log(f"native encoder: {time.perf_counter() - t0:.2f} s "
        f"({'compiled' if native.BUILD_SECONDS else 'cached'}) -> {native.module_path()}")

    problems = {}
    for name, make in (
        ("50k_full", configs.config_50k_full),
        ("10k_topology", configs.config_10k_topology),
        ("10k_crossgroup", configs.config_10k_crossgroup),
    ):
        pods, provs, existing = make()
        t0 = time.perf_counter()
        problems[name] = (encode(pods, provs, existing), time.perf_counter() - t0)

    solver = TorchSolver()
    checked = {name: check(ts, name, problem, solver) for name, (problem, _) in problems.items()}
    errs = {k: max(c["errs"][k] for c in checked.values()) for k in checked["50k_full"]["errs"]}
    awkward_check(ts, problems["50k_full"][0], solver, 26, 2310)
    nan_check(ts, checked["10k_crossgroup"])
    c = checked["50k_full"]
    chain_ops_check(ts, "50k_full", c["tensors"], c["S"], c["nz"])
    errs["pack_member"] = max(errs["pack_member"], k2_global_check(ts, problems, solver))
    k2_breakdown(ts, problems, solver)
    kernels = timings(ts, checked.pop("50k_full"), errs)
    del checked
    kernel_only(ts, problems, configs)
    kernels.append(probe_check(ts))
    # fresh problem objects for the race: the kernel-only solves above leave
    # nothing on them that the race reads, but a first solve should be one
    for name, make in (
        ("50k_full", configs.config_50k_full),
        ("10k_topology", configs.config_10k_topology),
        ("10k_crossgroup", configs.config_10k_crossgroup),
    ):
        problems[name] = (encode(*make()), problems[name][1])
    flat = race_phase(ts, problems, configs)
    log(f"flat race launches {flat}")
    problems = {name: problems[name] for name in ("50k_full", "10k_topology")}  # K1's breakdown

    t0 = time.perf_counter()
    cells, provs, catalog = configs.config_cells()
    log(f"fleet config: {sum(map(len, cells))} pods in {len(cells)} cells, "
        f"built in {time.perf_counter() - t0:.2f} s")
    hazard_check(ts, configs, cells, provs, catalog)
    fc = fleet_check(ts, st, configs, cells, provs, catalog)
    k1_breakdown(ts, problems, solver, fc["real"], fc["key"])
    del problems
    for entry in kernels:
        entry["max_abs_err"] = max(entry["max_abs_err"], fc["errs"].get(entry["name"], 0.0))
    kernels += fleet_timings(ts, st, fc)
    del fc
    fleet, k2_err, fleet_encode_s = fleet_slice(ts, configs, cells, provs, catalog)
    del cells
    session_delta(ts, configs)
    session_fleet(ts, configs, fleet_encode_s)
    controller_errs = controller_round(ts, configs)
    sharded = controller_sharded(ts, st, configs)
    consolidated = consolidation(ts, configs)
    operated = operator_phase(ts, configs)
    wired = http_tier_phase(ts, configs)
    replayed = replay_phase(ts, st)
    shutil.rmtree(CAPSULE_DIR, ignore_errors=True)
    for entry in kernels:
        entry["max_abs_err"] = max(entry["max_abs_err"], controller_errs.get(entry["name"], 0.0),
                                   consolidated["errs"].get(entry["name"], 0.0),
                                   operated["errs"].get(entry["name"], 0.0),
                                   wired["errs"].get(entry["name"], 0.0),
                                   replayed["errs"].get(entry["name"], 0.0))
    for entry in kernels:
        # the main path: the flat race, the fleet race, the sharded
        # controller's rounds, the deprovisioning passes, the operator's
        # steps, the operator's steps over the wire and the replays, each
        # counted alone
        entry["launches"] = (flat[entry["name"]] + fleet[entry["name"]] + sharded[entry["name"]]
                             + consolidated["launches"][entry["name"]]
                             + operated["launches"][entry["name"]]
                             + wired["launches"][entry["name"]]
                             + replayed["launches"][entry["name"]])
        if entry["name"] == "pack_member":
            entry["max_abs_err"] = max(entry["max_abs_err"], k2_err)
        if entry["launches"] < 1:
            raise AssertionError(f"{entry['name']} was not launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
