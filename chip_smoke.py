"""Drive the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and nvcc, and imports nothing of JAX. ``python3 chip_smoke.py
--compare DIR`` instead times this checkout's K1 and K3 against those of
the checkout at DIR (built from its own sources), in one process, at each
config and on the fleet bucket at B=1, 4, 8 and 16, in turns DIR, this,
this, DIR, with the chain and each of its kernels (``compare``);
``--compare DIR --staging`` times the staging kernels so instead, on the
card and on the host (``compare_staging``), and ``--compare DIR --mesh``
the meshed tier's K1 finish and member argmin, the un-meshed K1 and the
meshed chains (``compare_mesh``). Phases:

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
4. ``rtt_probe`` against ``x + 1`` on the card, its time beside
   ``torch.add``'s, and ``device_rtt``;
5. flat race (main path): ``TorchSolver().solve`` in latency mode (budget
   0.1 s) on the same three configs, a first solve and a repeat on the same
   problem object, launch counts taken around the phase and each solve. The
   first solve must dispatch the kernel on the side stream and have it
   answer before the deadline; the repeat must launch no kernel; every plan
   must validate and cost at most the kernel-only answer; no solve may show
   a fallback, a refused kernel plan, breaker evidence or a missed deadline.
   Then the race's admission on 50k_full's bucket (``admission_check``):
   measured in ms by synchronous solves it is admitted with the round trip
   pinned past the budget; one hung synchronous pass turns it away; the
   breaker's eviction lets its half-open probe race again;
6. kernel-only solves: ``TorchSolver()._solve_kernel`` on 50k_full,
   10k_topology and 10k_crossgroup must validate and cost what the JAX
   package's kernel computes (the pinned costs); after the flat race, so
   that its first dispatches are admitted on the round trip;
7. hazard: a side-stream dispatch held behind a spin while the same stager
   restages a churned copy of its problem in place; its buffer must be the
   plain chain's on the original inputs;
8. fleet kernel parity: five distinct cells of the 500k-pod fleet (the seed
   cell and the cells of churn rounds 0-3) and three pad rows stacked on one
   bucket (B=8): the batched K1, K2 and K3 row by row against their plain
   versions, every row of the batched chain equal to that problem's B=1
   buffer, the pad rows costing 0; the eight rows twice over at B=16, K1 and
   K3 bit for bit on every row and the chain's device events;
   ``fleet_stack`` against ``torch.stack``, and one churned cell's
   ``stage_patch`` restage, leaf by leaf and as one batch (one copy, one
   launch), against ``index_copy_``; K1's breakdown (its two kernels from a
   profiler trace) at 50k_full, 10k_topology and on the fleet bucket at B=1
   and 16; then timings of
   the chain at B=1, 4, 8 and 16, of ``fleet_stack`` for a B=16 chunk and of
   that restage both ways (the per-leaf sequence it replaced), each on the
   card and on the host;
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
   unplaced must have lost its race. Then a b2 fleet whose polls give up
   (an injected hang) must back its fleet bucket off in the next
   ``stage_fleet`` while its cells race alone (``fleet_admission_check``);
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
11a. the meshed tier (main path, ``mesh_phase``), on logical shards of the
    one card: (a) on 50k_full at its solve's slot budget, the 1D mesh at 2
    and 4 shards and the 2D mesh at 2x1 and 4x1, each buffer equal to the
    un-meshed chain's bit for bit and timed beside it; the meshed tier's
    four wrappers against their plain versions on the card (K1's shards and
    the member argmin bit for bit, the argmin also on NaN, +-inf and ties;
    K2's shards' integers bit for bit); (b)
    ``configs.config_mesh_superproblem()`` (500k pods, 16 cells) through
    ``stage_fleet`` with per-cell sessions, a seed round and churn rounds
    0-1, on a 2x2 mesh against the meshless fleet path on copies of the
    same problems: every row bit for bit, kernel plans and digests equal,
    every plan valid, a 2x2 superproblem dispatch a round,
    ``karpenter_tpu_mesh_dispatch_total`` and ``{phase=gather}`` moved,
    then ``solve_pods`` per cell; the flat race on a 1D mesh of 4 shards
    at 50k_full (first solve and repeat, then a kernel-only solve at the
    pinned cost); (c) one sharded controller round with
    ``mesh_enabled`` on a 2x2-meshed solver and on a meshless twin (8,000
    pods, 8 cells): every pod bound within allocatable, equal digests and
    fleet dispatches; (d) ``Operator.new(mesh_enabled=True)`` on the one
    card builds no mesh (run last, after the federation phase, as
    ``mesh_one_card``: ``Operator.new`` reconfigures process-wide state).
    The four wrappers' launches are counted around (b) and (c);
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
    ``configs.config_controller_cells`` (the first ``SHARDED_CELLS`` of its
    20 cells of 25k pending pods, 60 types, 8 workers): a seed round, whose
    cells must each be the ``config_cells`` problem, batched in one fleet
    dispatch with the launches ``SHARDED_SEED_LAUNCHES`` names, then churn rounds
    in the modes ``SHARDED_CHURN_MODES`` names; every round binds every
    pending pod within allocatable, with no plan rejected, each cell's
    problem equal to a full encode of its session's pods, each fleet row
    equal to the plain chain and each fleet buffer copied to the host
    once (``sharded_round``); then the same config at 8k pods in 8 cells
    at 1 worker and at 8, which must agree on digests and launches;
14. deprovisioning (main path): ``DeprovisioningController`` on the
    provisioning controller's default ``TorchSolver()``, with its
    quality-mode ``TorchSolver`` for what-ifs of 500 pods and more, over
    ``configs.config_consolidation``, pass by pass as the JAX package's
    ``bench.bench_consolidation`` runs it: the first pass on BASELINE's
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
    marked unavailable; K1, K2, K3 and ``rtt_probe`` must launch), two
    template-drift passes after an image rotation, each replacing one node
    on the new image; then ``python -m karpenter_tpu_torch`` in a
    subprocess on the card, which must answer its probes, serve /metrics
    and exit 0 on SIGTERM with its lease released (``operator_phase``). The
    seed step's chain is stamped and traced (``ChainIssue``);
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
    ``python -m karpenter_tpu_torch.replay`` runs in two subprocesses side
    by side, on the seed round's dump and, as a counterfactual, on the storm
    step's with its masked offering made available; both must exit 0;
18. the solver's fault domain (main path, ``fault_domain_phase``):
    ``bench.bench_device_faults``' scenario (``configs.config_device_faults``,
    20,000 pods a round on a fresh ``TorchSolver(dispatch_timeout_s=0.5)``):
    a storm of six rounds, one scripted device fault each (garbage and NaN
    plans, a compile failure, a dispatch hang, a device OOM, a staging
    corruption), each of which must fire and be booked in
    ``karpenter_tpu_kernel_faults_total`` under the JAX package's kind;
    every round binds every pod, none invalidly; the breaker opens, the
    first clean round launches K1, K2 and K3, restages the corrupted
    ``alloc`` and gives a valid kernel-only plan, and every breaker closes;
    then the validation ABBA;
19. the perf sentinel (main path, ``perf_sentinel_phase``):
    ``bench.bench_perf_sentinel``'s scenario at its defaults: no trip on
    clean rounds, a trip naming ``solve`` and a bucket within ``mad_k``
    rounds of a 0.12 s dispatch hang, its capsule carrying the trigger and
    a profile of the dispatch fetch, replayed to a match on the card;
20. the chaos soak (main path, ``soak_phase``): ``run_soak`` for 60 s at
    2,000 live pods with the operator ``python -m karpenter_tpu_torch
    --device cuda`` in a subprocess, killed and respawned once, the API
    server restarted once: no violation, every dumped capsule replayed to
    a match, no duplicate token, no orphan, and a device fault booked on
    the operator's ``/metrics``; the operator processes' launches are
    counted from files they write (``SOAK_OPERATOR``);
21. one JSON line of kernel results, the card's name and power limit, and
    the device JSON as the last line.

Each phase's wall is logged on its own line (``phase``), with the perf
sentinel's trips in it: every ``Operator.new`` turns the sentinel on, its
baselines in a fresh ``build/baselines`` (``KARPENTER_TPU_COMPILE_CACHE_DIR``
for the whole run, subprocesses included).

Before any encode, the native encoder (``karpenter_tpu_torch/native``)
must have built; its build time is logged.

Any failure exits non-zero with its traceback; nothing falls back to the CPU.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BASELINE_DIR = Path(__file__).resolve().parent / "build" / "baselines"
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
PACK_KERNELS = ("shared_precompute", "pack_member", "pack_epilogue")
COST_RTOL = 1e-6  # slice costs against the JAX package's
MEMBER_COST_RTOL = 1e-5  # f32 member-cost sums, taken in another order than the plain version's
NEAR_TIE_RTOL = 1e-6  # rule for comparing fused buffers, see fused_agree()
SPIN_CYCLES = 100_000_000  # ~50 ms of GPU clock, longer than a window's host work
#: the short spins that end every ``device_trace``, ~5 us each: the events
#: a trace may lose at its end are theirs, not the traced calls'
TAIL_SPINS, TAIL_SPIN_CYCLES = 16, 10_000


def log(*args) -> None:
    print(*args, flush=True)


#: each main-path phase's wall, seconds, in the order run (``phase``)
PHASE_WALLS: dict = {}


def child_env(**extra) -> dict:
    """The environment of an operator process this run starts: this
    process's, with the run's baseline directory as
    ``KARPENTER_TPU_AOT_CACHE_DIR`` (the ``aot_cache_dir`` setting, which
    ``Operator.new`` hands the profiler first) in place of
    ``KARPENTER_TPU_COMPILE_CACHE_DIR``: ``Settings.from_env`` (the JAX
    package's and the port's) refuses every ``KARPENTER_TPU_*`` variable
    that is not a setting, and the profiler's own override is not one."""
    env = {k: v for k, v in os.environ.items() if k != "KARPENTER_TPU_COMPILE_CACHE_DIR"}
    env["KARPENTER_TPU_AOT_CACHE_DIR"] = str(BASELINE_DIR)
    env.update(extra)
    return env


#: phases that launch stage_patch outside a stage() call (kernel checks)
DIRECT_STAGE_PATCH = ("fleet_check",)


def phase(name, fn, *args):
    """Run one main-path phase, log the race's admission table after it
    (``admission_line``), its wall on its own line, the perf
    sentinel's trips in it (the operators' sentinel is on by default) and
    its ``stage_patch`` launches in this process beside its restaging
    ``stage()`` calls and their copies, which must be equal: a restage is
    one copy and one launch for each device it patches."""
    global COUNTS_ZEROED
    from karpenter_tpu_torch.solver import torch_solver as ts
    from karpenter_tpu_torch.utils import metrics, profiling

    def trips():
        with metrics.PERF_REGRESSION._lock:
            return sum(metrics.PERF_REGRESSION._values.values())

    before = trips()
    COUNTS_ZEROED, staged0 = False, phase_counts(ts)
    refused0 = {label: row[0] for label, row in ts.AOT_CACHE.refusals.items()}
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_WALLS[name] = round(time.perf_counter() - t0, 2)
    log(admission_line(name, refused0))
    staged = {k: v - (0 if COUNTS_ZEROED else staged0[k]) for k, v in phase_counts(ts).items()}
    log(f"phase {name}: wall {PHASE_WALLS[name]} s; perf sentinel "
        f"{'on' if profiling.SENTINEL.enabled else 'off'} at its end, "
        f"{trips() - before:g} trips in this process; stage_patch {staged['launches']} launches, "
        f"{staged['calls']} restaging calls, {staged['copies']} copies; "
        f"{staged['fleet chains']} chains with B > 1")
    if name not in DIRECT_STAGE_PATCH and not staged["launches"] == staged["calls"] == staged["copies"]:
        raise AssertionError(f"phase {name}: stage_patch launches, restaging calls and copies "
                             f"differ: {staged}")
    return out


def admission_line(name, refused0) -> str:
    """The race's admission table at the end of a phase (``AOT_CACHE``: each
    bucket's dispatch-latency EWMA, samples and last sample), and the
    dispatches admission turned away in the phase, by bucket, each with
    the prediction and the last sample that set it."""
    from karpenter_tpu_torch.solver import torch_solver as ts

    def ms(x):
        return "none" if x is None else f"{x * 1e3:.4f}"

    rows = "; ".join(f"{label} {ms(ewma)} ms/{n} (last {ms(last)})"
                     for label, ewma, n, last in ts.AOT_CACHE.table())
    turned = {label: f"{row[0] - refused0.get(label, 0)} on {ms(row[1])} ms (last sample "
                     f"{ms(row[2])} ms)"
              for label, row in ts.AOT_CACHE.refusals.items() if row[0] > refused0.get(label, 0)}
    return (f"phase {name}: admission table (bucket EWMA ms/samples) [{rows or 'empty'}]; "
            f"dispatches turned away {turned or 'none'}")


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


def host_ms(fn, calls: int = 200) -> float:
    """Host time of one call of ``fn``: the median of ``calls`` calls, each
    on the host clock, with no synchronise between them (the card runs
    their work behind them), after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e3


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
    at least ``calls - 1`` whole chains; the last call's last launches are
    followed by ``device_trace``'s tail of spins, which takes any loss at
    the trace's end."""
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
    The calls queue behind a spin on the card, and ``TAIL_SPINS`` short
    spins follow them. The trace may miss the events of the first call's
    first launches (on the card it missed one or two kernels of the first
    call in some windows): ``kernel_parts_ms`` and ``chain_ops_check``
    allow for that. It may also miss the last events before the trace
    stops (one run lost the last call's last two kernels): those are the
    tail's spins, which are dropped with the leading one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SPIN_CYCLES)
        for _ in range(calls):
            fn()
        for _ in range(TAIL_SPINS):
            torch.cuda._sleep(TAIL_SPIN_CYCLES)
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
    from karpenter_tpu_torch.solver import staging as st

    global COUNTS_ZEROED
    for counts in (ts.LAUNCHES, ts.BATCHED, st.RESTAGES):
        for k in counts:
            counts[k] = 0
    COUNTS_ZEROED = True


#: set by ``zero_counts``: ``phase`` then reads the counts from 0
COUNTS_ZEROED = False


def phase_counts(ts) -> dict:
    """The counts ``phase`` logs: ``stage_patch`` launches and what the
    stagers count beside them, the ``stage()`` calls that patched on the
    card (one for each device) and the host-to-device copies of their
    patches; and the chains launched with B > 1 (K3 ends each chain
    once)."""
    from karpenter_tpu_torch.solver import staging as st

    return {"launches": ts.LAUNCHES["stage_patch"], **st.RESTAGES,
            "fleet chains": ts.BATCHED["pack_epilogue"]}


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
    admission_check(ts, solver, problems["50k_full"][0])
    return launches


#: (b) of ``admission_check``: a synchronous pass hung this long answers
#: below its fetch deadline, ``ADMISSION_TIMEOUT_S``
ADMISSION_HANG_S = 0.4
ADMISSION_TIMEOUT_S = 0.5
#: K1, K2 twice and K3: one chain
CHAIN_LAUNCHES = {"shared_precompute": 1, "pack_member": 2, "pack_epilogue": 1}


def chain_launches(moved) -> dict:
    return {k: moved.get(k, 0) for k in PACK_KERNELS}


def forget_race(problem) -> None:
    """Drop the race's memory of ``problem``, so that its next solve races."""
    for k in ("_race_kernel_lost", "_race_kernel_result", "_race_miss_count",
              "_race_memory_at", "_fleet_skip"):
        problem.__dict__.pop(k, None)


def table_row(key):
    """``(EWMA, samples, last sample)`` of the bucket's entry, or None."""
    from karpenter_tpu_torch.solver.torch_solver import AOT_CACHE

    return next((row[1:] for row in AOT_CACHE.table() if row[0] == key.label()), None)


def admission_check(ts, solver, problem) -> None:
    """The race's admission on the card, on the flat race's solver and its
    50k_full problem (a bucket that only the flat race and ``kernel_only``
    dispatch unmeshed):

    (a) three real synchronous solves (``_solve_kernel`` of fresh quality
        ``TorchSolver``s, each starting at the slot estimate, so that its
        first pass is on the race's bucket) measure the bucket in ms; with
        the round trip pinned past the budget, the next latency race is
        admitted and launches K1, K2, K2 and K3;
    (b) a synchronous solve under an injected ``dispatch-hang`` of
        ``ADMISSION_HANG_S``, below its ``ADMISSION_TIMEOUT_S`` fetch
        deadline, answers and lifts the EWMA past the budget: the next race
        launches nothing, answers from the host and is booked as turned
        away;
    (c) the breaker opening on the label (an injected device OOM at a
        synchronous dispatch, threshold 1) evicts the entry, and once the
        recovery has passed the next race, the half-open probe, falls back
        to the round trip and launches K1, K2, K2 and K3 again.

    The breaker board and the round trip are restored at the end; the
    bucket's entry holds only what (c)'s probe learned."""
    import torch

    from karpenter_tpu_torch.solver import TorchSolver, validate
    from karpenter_tpu_torch.solver.solver import KERNEL_BOARD
    from karpenter_tpu_torch.solver.torch_solver import AOT_CACHE
    from karpenter_tpu_torch.utils import faults

    key = solver._bucket_key(problem)
    label, budget = key.label(), solver.latency_budget_s
    rtt = TorchSolver._device_rtt_s
    now = [0.0]
    t_check = time.perf_counter()

    def race(tag):
        forget_race(problem)
        before = dict(ts.LAUNCHES)
        t0 = time.perf_counter()
        result = solver.solve(problem)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        moved = {k: v - before[k] for k, v in ts.LAUNCHES.items() if v != before[k]}
        if validate(problem, result):
            raise AssertionError(f"admission {tag}: the race's plan fails validation")
        log(f"admission {tag}: race on {label}: backend {result.stats['backend']}, launches "
            f"{moved}, solve {wall:.4f} s; table {table_row(key)}")
        return result, moved

    def synchronous(tag, plan=None):
        quality = TorchSolver(latency_budget_s=5.0, dispatch_timeout_s=ADMISSION_TIMEOUT_S)
        faults.install_device_faults(plan)
        try:
            t0 = time.perf_counter()
            out = quality._solve_kernel(problem)
            torch.cuda.synchronize()
        finally:
            faults.install_device_faults(None)
        answer = "no answer" if out is None else f"backend {out.stats.get('backend')}"
        log(f"admission {tag}: synchronous solve {time.perf_counter() - t0:.4f} s, {answer}; "
            f"table {table_row(key)}")
        return out

    try:
        # (a)
        for i in range(3):
            out = synchronous(f"(a) {i}")
            if out is None or out.stats.get("backend") != 1.0:
                raise AssertionError("admission (a): a synchronous solve gave no kernel answer")
        ewma, n, _ = table_row(key)
        if n < 3 or not ewma < budget:
            raise AssertionError(f"admission (a): {label} learned {n} samples, EWMA {ewma!r}")
        TorchSolver._device_rtt_s = float("inf")
        _, moved = race("(a)")
        if chain_launches(moved) != CHAIN_LAUNCHES:
            raise AssertionError(f"admission (a): the admitted race launched {moved}")
        # (b)
        hang = faults.DeviceFaultPlan().dispatch_hang(seconds=ADMISSION_HANG_S)
        if synchronous("(b) hung", hang) is None or not hang.log:
            raise AssertionError("admission (b): the hung synchronous solve did not answer")
        ewma, _, last = table_row(key)
        if not ewma >= budget:
            raise AssertionError(f"admission (b): EWMA {ewma!r} after a {last!r} s sample")
        refused = AOT_CACHE.refusals.get(label, [0])[0]
        result, moved = race("(b)")
        if moved or result.stats["backend"] == 1.0 or AOT_CACHE.refusals[label][0] != refused + 1:
            raise AssertionError(f"admission (b): the refused race launched {moved}, backend "
                                 f"{result.stats['backend']}")
        # (c)
        KERNEL_BOARD.configure(failure_threshold=1, recovery_timeout_s=1.0, clock=lambda: now[0])
        oom = faults.DeviceFaultPlan().device_oom()
        if synchronous("(c) out of memory", oom) is not None or not oom.log:
            raise AssertionError("admission (c): the injected device OOM did not fire")
        if KERNEL_BOARD.state(label) != "open" or table_row(key) is not None:
            raise AssertionError(f"admission (c): breaker {KERNEL_BOARD.state(label)}, entry "
                                 f"{table_row(key)}")
        now[0] += 2.0  # past the recovery: the next dispatch is the half-open probe
        TorchSolver._device_rtt_s = rtt
        _, moved = race("(c)")
        if chain_launches(moved) != CHAIN_LAUNCHES:
            raise AssertionError(f"admission (c): the probe launched {moved}")
    finally:
        TorchSolver._device_rtt_s = rtt
        KERNEL_BOARD.configure(failure_threshold=3, recovery_timeout_s=30.0, clock=time.monotonic)
        faults.install_device_faults(None)
    log(f"admission (a)-(c): {time.perf_counter() - t_check:.4f} s")


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
        f"behind a spin; the restage returned to the host after {restage_s:.4f} s (its copy "
        f"and launch queue on the card behind the chain's event); the dispatch's buffer vs the "
        f"plain chain on the original inputs: {verdict}")


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


def cell_patches(solver, problems):
    """One churned cell's restage: the seed cell's resident leaves on the
    card (``(name, tensor, churned rows, their new bytes)``) and the rows
    that churn round 0 changed, for every leaf that restages; and the new
    leaves."""
    import numpy as np
    import torch

    seed, churned = (solver._prepare(problems[k]) for k in ("seed", "r0"))
    old = dict(seed[0], **dict(zip(MEMBERS, seed[1:6])))
    new = dict(churned[0], **dict(zip(MEMBERS, churned[1:6])))
    patches = []
    for name in old:
        n = changed_rows(old[name], new[name])
        if 0 < n <= max(1, old[name].shape[0] // 2):
            diff = (old[name] != new[name]).reshape(old[name].shape[0], -1).any(axis=1)
            idx = np.flatnonzero(diff).astype(np.int64)
            patches.append((name, torch.from_numpy(old[name]).cuda(), idx,
                            np.ascontiguousarray(new[name][idx])))
    return patches, new


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

    # one churned cell's restage: each leaf through the one-leaf entry and
    # all of them through one batched restage (one copy, one launch)
    patches, new = cell_patches(solver, problems)
    if len(patches) < 2:
        raise AssertionError(f"churn round 0 changed {len(patches)} leaves of the cell, not several")
    for name, dst, idx, src in patches:
        idx_d, src_d = torch.from_numpy(idx).cuda(), torch.from_numpy(src).cuda()
        got = st.stage_patch(dst.clone(), idx_d, src_d)
        if not (torch.equal(got, st.stage_patch_ref(dst.clone(), idx_d, src_d))
                and torch.equal(got.cpu(), torch.from_numpy(new[name]))):
            raise AssertionError(f"stage_patch {name} differs from index_copy_")
    batch = [(dst.clone(), idx, src) for _, dst, idx, src in patches]
    before = phase_counts(ts)
    if st.stage_patches(batch) != 1 or ts.LAUNCHES["stage_patch"] - before["launches"] != 1:
        raise AssertionError("the batched restage was not one launch")
    if st.RESTAGES["copies"] - before["copies"] != 1:
        raise AssertionError("the batched restage was not one copy")
    for (name, *_), (got, _, _) in zip(patches, batch):
        if not torch.equal(got.cpu(), torch.from_numpy(new[name])):
            raise AssertionError(f"the batched stage_patch left {name} unlike index_copy_")
    log(f"fleet check: batched K1 bit-equal (B=8 and B=16), K2 max_abs_err={k2_err}, K3 equal "
        f"(B=8 and B=16), every row equal to its B=1 chain, pad rows cost 0; fleet_stack equal over "
        f"{len(rows)} rows x {len(rows[0])} leaves; stage_patch equal on "
        f"{[(p[0], int(p[2].shape[0])) for p in patches]}, one leaf a launch and all in one")
    return dict(real=real, key=key, rows=rows, patches=patches,
                errs={"shared_precompute": 0.0, "pack_member": k2_err, "pack_epilogue": 0.0,
                      "fleet_stack": 0.0, "stage_patch": 0.0})


def fleet_timings(ts, st, fc: dict, floor_ms: float) -> list:
    """The batched chain at B=1, 4, 8 and 16 (real rows, repeated for B > 5),
    fleet_stack for one B=16 chunk, and one churned cell's stage_patch
    restage, each beside its bound, the launch floor (``floor_ms``,
    ``rtt_probe``'s kernel time) and its plain version; the restage also
    as the per-leaf sequence it replaced, each way on the card and on the
    host."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.solver._build import load_kernels

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
    stack_host = host_ms(lambda: st.fleet_stack(rows16))
    log(f"timing: fleet_stack B=16 ({len(rows16) * len(rows16[0])} rows, {stack_bytes} bytes moved) "
        f"{stack_ms:.4f} ms on the card, {stack_host:.4f} ms of host a call; plain torch.stack "
        f"x{len(rows16[0])} {stack_plain:.4f} ms; launch floor (rtt_probe) {floor_ms:.6f} ms")

    # one churned cell's restage, both ways in turns: the per-leaf sequence
    # (two pageable uploads and a launch of the one-leaf entry a leaf) and
    # the batched restage (one packed copy, one launch)
    patches = fc["patches"]
    dev = patches[0][1].device
    batch = [(dst, idx, src) for _, dst, idx, src in patches]

    def per_leaf():
        for dst, idx, src in batch:
            st.stage_patch(dst, torch.from_numpy(idx).to(dev, copy=True),
                           torch.from_numpy(src).to(dev, copy=True))

    ways = {"per-leaf": per_leaf, "batched": lambda: st.stage_patches(batch)}
    restage = {}
    for way in ("per-leaf", "batched", "batched", "per-leaf"):
        restage.setdefault(way, []).append((time_ms(ways[way]), host_ms(ways[way])))
    restage = {way: tuple(statistics.mean(t[i] for t in turns) for i in (0, 1))
               for way, turns in restage.items()}
    # the kernel alone: one launch over the packed buffer already on the card
    offs, total = st.patch_layout(batch)
    packed = np.zeros(total, np.uint8)
    st.pack_patches(batch, offs, packed)
    buf = torch.from_numpy(packed).to(dev)
    table = np.array([[dst.data_ptr(), buf.data_ptr() + io, buf.data_ptr() + so, idx.shape[0],
                       st._row_bytes(dst)] for (dst, idx, _), (io, so) in zip(batch, offs)], np.int64)
    lib = load_kernels()
    patch_ms = time_ms(lambda: st._run_stage_patch(lib, table, ts._stream()))
    on_card = [(dst, torch.from_numpy(idx).to(dev), torch.from_numpy(src).to(dev))
               for dst, idx, src in batch]

    def leaf_by_leaf(fn):
        for dst, idx, src in on_card:
            fn(dst, idx, src)

    one_leaf = time_ms(lambda: leaf_by_leaf(st.stage_patch)) / len(batch)
    patch_plain = time_ms(lambda: leaf_by_leaf(st.stage_patch_ref), per=1)
    patch_bytes = sum(idx.nbytes + 2 * src.nbytes for _, idx, src in batch)
    log(f"timing: restage of one churned cell ({len(batch)} leaves, "
        f"{[(p[0], int(p[2].shape[0])) for p in patches]}, {patch_bytes} bytes moved): per-leaf "
        f"sequence {restage['per-leaf'][0]:.4f} ms on the card, {restage['per-leaf'][1]:.4f} ms "
        f"of host a call; batched {restage['batched'][0]:.4f} ms on the card, "
        f"{restage['batched'][1]:.4f} ms of host (mean of two turns each, in turns per-leaf, "
        f"batched, batched, per-leaf); the batched kernel alone {patch_ms:.4f} ms, the one-leaf "
        f"entry {one_leaf:.4f} ms a launch, index_copy_ x{len(batch)} {patch_plain:.4f} ms; "
        f"launch floor (rtt_probe) {floor_ms:.6f} ms")
    out = []
    # library_ms: no one PyTorch call patches or stacks several tensors
    for name, ms, plain, lib, work in (
        ("stage_patch", patch_ms, patch_plain, None, patch_bytes),
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
    fleet_admission_check(ts, cells, provs, catalog)
    return launches, k2_err, encode_s


#: (d) of the admission checks: the fleet seam's hang, past every deadline
ADMISSION_FLEET_HANG_S = 1.0


def fleet_admission_check(ts, cells, provs, catalog) -> None:
    """(d) A fleet whose polls gave up backs its fleet bucket off. Two cells
    of the fleet, on fresh per-cell solvers, are staged as one b2 dispatch
    (a width no other phase dispatches) whose buffer the fleet seam's
    injected hang holds past every deadline: each cell's race misses and
    answers from the host, and the fleet records one pessimistic sample.
    The next ``stage_fleet`` of the same cells (fresh problem objects)
    batches nothing and books the refusal, and each cell's race launches a
    B=1 chain of its own. The fleet bucket's entry is evicted at the end,
    and the cells' B=1 bucket's too when this check made it."""
    import torch

    from karpenter_tpu_torch.solver import TorchSolver, encode, stage_fleet, validate
    from karpenter_tpu_torch.solver.torch_solver import AOT_CACHE
    from karpenter_tpu_torch.utils import faults

    t_check = time.perf_counter()
    pair = (0, 1)
    solvers = [TorchSolver() for _ in pair]
    entries = [(s, encode_cell(encode, cells, provs, catalog, c)) for s, c in zip(solvers, pair)]
    one = solvers[0]._bucket_key(entries[0][1])
    had_one = table_row(one) is not None
    hang = faults.DeviceFaultPlan().dispatch_hang(seconds=ADMISSION_FLEET_HANG_S)
    faults.install_device_faults(hang)
    try:
        stats = stage_fleet(entries)
    finally:
        faults.install_device_faults(None)
    if stats["dispatches"] != 1 or not hang.log:
        raise AssertionError(f"admission (d): the hung fleet was not dispatched: {stats}")
    fleet_label = stats["buckets"][0]
    for s, p in entries:
        result = s.solve(p)
        if validate(p, result) or result.stats["backend"] == 1.0 or "_race_miss_count" not in p.__dict__:
            raise AssertionError(f"admission (d): a hung fleet's cell answered {result.stats}")
    row = next((r for r in AOT_CACHE.table() if r[0] == fleet_label), None)
    if row is None or row[2] != 1 or not row[1] >= solvers[0].latency_budget_s:
        raise AssertionError(f"admission (d): {fleet_label} learned {row}")
    log(f"admission (d): the hung {fleet_label} fleet missed in both cells; table {row[1:]}")
    entries = [(s, encode_cell(encode, cells, provs, catalog, c)) for s, c in zip(solvers, pair)]
    refused = AOT_CACHE.refusals.get(fleet_label, [0])[0]
    stats = stage_fleet(entries)
    if stats["dispatches"] or stats["eligible"] != len(pair) or \
            AOT_CACHE.refusals[fleet_label][0] != refused + 1:
        raise AssertionError(f"admission (d): the fleet bucket was not backed off: {stats}")
    before, batched = dict(ts.LAUNCHES), dict(ts.BATCHED)
    for s, p in entries:
        result = s.solve(p)
        if validate(p, result):
            raise AssertionError("admission (d): a cell's plan fails validation")
    torch.cuda.synchronize()
    moved = chain_launches({k: ts.LAUNCHES[k] - before[k] for k in before})
    if moved != {k: v * len(pair) for k, v in CHAIN_LAUNCHES.items()} or ts.BATCHED != batched:
        raise AssertionError(f"admission (d): the cells launched {moved}, batched "
                             f"{ {k: ts.BATCHED[k] - batched[k] for k in batched} }")
    log(f"admission (d): next stage_fleet {stats['dispatches']} dispatches of "
        f"{stats['eligible']} eligible cells; the cells launched {moved} with B=1; "
        f"{time.perf_counter() - t_check:.4f} s")
    AOT_CACHE.evict_bucket(fleet_label)
    if not had_one:
        AOT_CACHE.evict_bucket(one.label())


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


#: the meshed tier's phase (``mesh_phase``): meshes of logical shards of the
#: one card, at the shapes the phase holds the kernels at, and the sizes of
#: its controller round
MESH_KERNEL_MESHES = (("1d", 2), ("1d", 4), ("2d", (2, 1)), ("2d", (4, 1)))
MESH_SUPER_SHAPE = (2, 2)
MESH_SUPER_ROUNDS = ("seed", 0, 1)
MESH_CONTROLLER_PODS = 8_000
MESH_CONTROLLER_CELLS = 8
MESH_WRAPPERS = ("shard_precompute_part", "shard_precompute_finish", "shard_member",
                 "member_argmin")
MESH_DEVICE = "cuda:0"  # the card whose logical shards the meshes name


def logical_mesh(kind, shape):
    """A mesh of logical shards of card 0: one device named once a shard."""
    from karpenter_tpu_torch import parallel

    if kind == "1d":
        return parallel.make_mesh(shape, devices=[MESH_DEVICE] * shape)
    return parallel.make_mesh2d(shape, devices=[MESH_DEVICE] * (shape[0] * shape[1]))


def mesh_place(kind, mesh, tensors):
    from karpenter_tpu_torch import parallel

    if kind == "1d":
        return parallel.shard_portfolio(mesh, *tensors)
    return parallel.shard_problem2d(mesh, *tensors)


def event_ms(fn, reps: int = 3) -> tuple:
    """(device ms between events around one call, host ms of the call):
    medians over ``reps`` calls after a warm one. A meshed chain joins its
    shards' streams back to the caller's, so the end event follows every
    shard's work; the device time includes the card waiting on the host's
    launches."""
    import torch

    fn()
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        end.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dev.append(start.elapsed_time(end))
    return statistics.median(dev), statistics.median(host)


def first_call_ms(fn) -> tuple:
    """(device ms between events around one call, host ms of the call),
    with no warm call before it: what a first dispatch of a shape pays."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def phase_mode(meshed, mode):
    """The meshed K2 phases issued in ``mode`` (``meshed.PHASE_MODE``)."""
    saved = meshed.PHASE_MODE
    meshed.PHASE_MODE = mode
    try:
        yield
    finally:
        meshed.PHASE_MODE = saved


@contextlib.contextmanager
def plain_mesh_kernels(meshed):
    """The meshed tier's wrappers take their plain versions on the card's
    tensors (the un-meshed K1, K2 and K3 stay kernels)."""
    saved = meshed._plain
    meshed._plain = lambda t: True
    try:
        yield
    finally:
        meshed._plain = saved


def mesh_kernel_check(ts, configs) -> list:
    """(a) The meshed tier's kernels on 50k_full at the slot budget its
    solve reaches: the 1D mesh at 2 and 4 logical shards and the 2D mesh at
    2x1 and 4x1, each meshed buffer equal to the un-meshed chain's bit for
    bit and timed beside it; each new wrapper against its plain version on
    the card (K1's shard outputs and the member argmin's bit for bit, K2's
    integers bit for bit and its member costs to MEMBER_COST_RTOL), the
    member argmin also on costs holding NaN, +-inf and ties. Returns the
    ``kernels`` entries of the four wrappers (launches filled in later)."""
    import torch

    from karpenter_tpu_torch.solver import TorchSolver, encode, meshed

    solver = TorchSolver()
    problem = encode(*configs.config_50k_full())
    _, orders, _, _, _, swaps, s_new, nz = solver._prepare(problem)
    tensors = device_problem(ts, solver, problem)
    _, S, _ = solver._run_fused(tensors, orders, swaps, s_new, nz)
    inputs, o, a, l, r, sw = tensors
    G, O, E, R, Z = ts._dims(inputs)
    K = o.shape[0]
    want = ts.pack_solve_fused(*tensors, S, nz)
    base_ms = event_ms(lambda: ts.pack_solve_fused(*tensors, S, nz))
    log(f"mesh kernels on 50k_full: G={G} O={O} E={E} R={R} Z={Z} K={K} S={S}; un-meshed chain "
        f"{base_ms[0]:.4f} ms between events ({base_ms[1]:.4f} ms host; behind a spin, the "
        f"device alone: {time_ms(lambda: ts.pack_solve_fused(*tensors, S, nz)):.4f} ms)")
    for kind, shape in MESH_KERNEL_MESHES:
        mesh = logical_mesh(kind, shape)
        placed = mesh_place(kind, mesh, tensors)

        def chain():
            return ts.pack_solve_meshed(mesh, *placed, S, nz)

        def hold(got, how):
            if not torch.equal(got, want):
                at = torch.nonzero(got != want).flatten()[:8].tolist()
                raise AssertionError(f"mesh {kind} {shape} ({how}): buffer differs from the "
                                     f"un-meshed chain at {at}")

        before, paths = dict(meshed.LAUNCHES), dict(meshed.PHASE_PATHS)
        copies0 = dict(meshed.COPIES)
        got = []
        first = first_call_ms(lambda: got.append(chain()))
        hold(got[0], "phase entry")
        moved = {k: meshed.LAUNCHES[k] - before[k] for k in before}
        copied = {k: meshed.COPIES[k] - copies0[k] for k in copies0}
        hold_mesh_counts(kind, shape, moved, copied)
        dev, host = event_ms(chain, reps=5)
        paths = {k: meshed.PHASE_PATHS[k] - paths[k] for k in paths}
        log(f"mesh {kind} {shape}: buffer equal to the un-meshed chain bit for bit; {dev:.4f} ms "
            f"between events, the median of 5 calls after a warm one ({host:.4f} ms host; its "
            f"first call {first[0]:.4f} ms, {first[1]:.4f} ms host; un-meshed {base_ms[0]:.4f} ms), "
            f"launches a chain {moved}, exchange copies {copied}, K2 phases of the 7 calls by path "
            f"{paths}")
        if kind != "2d":
            continue
        # the same chain with every stage issued from Python (30-230 ms a
        # chain): one timed call after the warm one
        with phase_mode(meshed, "stages"):
            hold(chain(), "per-stage issue")
            sdev, shost = event_ms(chain, reps=1)
        log(f"mesh {kind} {shape}: per-stage issue {sdev:.4f} ms between events ({shost:.4f} ms "
            f"host), buffer bit for bit; the phase entry {sdev / dev:.2f}x faster, its first "
            f"call {sdev / first[0]:.2f}x")

    errs = {}
    # K1 on two option shards against its plain version and the un-meshed K1
    mesh = logical_mesh("2d", (2, 1))
    placed = mesh_place("2d", mesh, tensors)
    shards = [meshed._Shard(mesh, i) for i in range(2)]
    ins = [ts._unsqueeze(type(inputs)(*(p.shards[i] for p in placed[0]))) for i in range(2)]
    members = [tuple(m.shards[i].unsqueeze(0) for m in placed[1:]) for i in range(2)]
    k1 = meshed.shard_precompute_all(shards, ins, S)
    with plain_mesh_kernels(meshed):
        k1_plain = meshed.shard_precompute_all(shards, ins, S)
    whole = ts.shared_precompute(inputs, S, nz)
    for got, want_s in zip(k1, k1_plain):
        hold_shared("mesh K1 shard", ts._row(got, 0), ts._row(want_s, 0))
    for f in ("units", "units_rsv", "val_pair"):
        if not torch.equal(torch.cat([getattr(k, f)[0] for k in k1], 1), getattr(whole, f)):
            raise AssertionError(f"mesh K1: the shards' {f} is not the un-meshed K1's, split")
    if not torch.equal(k1[0].lam[0], whole.lam):
        raise AssertionError("mesh K1: lam differs from the un-meshed K1's")
    errs["shard_precompute_part"] = errs["shard_precompute_finish"] = 0.0
    # K2 on two option shards against its plain version
    m1 = meshed.shard_member_phase(shards, ins, k1, members, S)
    m2 = meshed.shard_member_phase(shards, ins, k1, members, S, [m.cost for m in m1])
    with plain_mesh_kernels(meshed):
        p1 = meshed.shard_member_phase(shards, ins, k1, members, S)
        p2 = meshed.shard_member_phase(shards, ins, k1, members, S, [m.cost for m in m1])
    errs["shard_member"] = max(
        hold_members(f"mesh K2 shard {s} phase {ph}", ts._row(g, 0), ts._row(w, 0))
        for ph, (gs, ws) in enumerate(((m1, p1), (m2, p2)), 1) for s, (g, w) in enumerate(zip(gs, ws)))
    # the member argmin in the 1D chain, and on NaN, +-inf and ties
    mesh4 = logical_mesh("1d", 4)
    placed4 = mesh_place("1d", mesh4, tensors)
    with plain_mesh_kernels(meshed):
        plain_buf = ts.pack_solve_meshed(mesh4, *placed4, S, nz)
    if not torch.equal(plain_buf, want):
        raise AssertionError("mesh 1d: the chain with the member argmin's plain version differs")
    errs["member_argmin"] = member_argmin_nan_check(meshed)
    log(f"mesh plain checks: K1 shards bit for bit (and the un-meshed K1 split), K2 shards "
        f"max_abs_err {errs['shard_member']}, member argmin bit for bit")
    return mesh_timings(ts, meshed, tensors, S, nz, shards, ins, members, k1, errs)


def hold_mesh_counts(kind, shape, moved, copied) -> None:
    """One chain on logical shards of the card: a 1D chain of n shards
    makes n + 1 member argmin launches (a seed a shard, one final pick), an
    option split of n shards one K1 part and one finish a shard; the shards
    share the card, so no exchange copies a buffer for either."""
    n = shape if kind == "1d" else shape[0]
    want = ({"member_argmin": n + 1} if kind == "1d"
            else {"shard_precompute_part": n, "shard_precompute_finish": n})
    if any(moved[k] != v for k, v in want.items()) or any(copied.values()):
        raise AssertionError(f"mesh {kind} {shape}: launches {moved} (want {want}), copies {copied} "
                             f"(want none)")


#: kernels a meshed chain's trace is split into (the longer names first: a
#: parent tree's argmin kernels share a prefix), then copies and fills
CHAIN_TRACE_PARTS = ("k1_units", "k1_val_pair_shards", "k1_val_pair", "k1_mesh_combine", "k2_prices",
                     "k2_scan", "k3_pack_epilogue", "mesh_seed_offer", "mesh_seed_pick", "mesh_seed",
                     "mesh_final_pick", "Memcpy", "Memset")


def chain_trace_split(fn, calls: int = 3) -> dict:
    """A ``torch.profiler`` trace of ``calls`` calls of a chain, each alone
    after a synchronize, with no spin in front (the card waits on the host's
    issue as in a real call), split a call: each part's device ms (kernels
    by name, copies, fills; summed over concurrent streams), ``busy`` (the
    union of the device intervals), ``window`` (the first device event's
    start to the last's end) and ``idle`` (window less busy), means over
    the calls. A one-cycle spin before each call marks where it starts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            torch.cuda._sleep(1)
            fn()
            torch.cuda.synchronize()
        for _ in range(TAIL_SPINS):
            torch.cuda._sleep(TAIL_SPIN_CYCLES)
        torch.cuda.synchronize()
    events = sorted((ev for ev in prof.events() if str(ev.device_type).endswith("CUDA")),
                    key=lambda ev: ev.time_range.start)
    windows, cur = [], None
    for ev in events:
        if "spin_kernel" in ev.name:
            cur = None
            continue
        if cur is None:
            cur = []
            windows.append(cur)
        cur.append((ev.name, ev.time_range.start, ev.time_range.end))
    windows = [w for w in windows if w][-calls:]
    out = {}
    for w in windows:
        for name, t0, t1 in w:
            part = next((p for p in CHAIN_TRACE_PARTS if p in name), "other")
            out[part] = out.get(part, 0.0) + (t1 - t0) / 1e3
        busy, end = 0.0, None
        for _, t0, t1 in sorted(w, key=lambda e: e[1]):
            if end is None or t0 > end:
                busy += t1 - t0
                end = t1
            elif t1 > end:
                busy += t1 - end
                end = t1
        window = max(t1 for _, _, t1 in w) - min(t0 for _, t0, _ in w)
        out["busy"] = out.get("busy", 0.0) + busy / 1e3
        out["window"] = out.get("window", 0.0) + window / 1e3
        out["events"] = out.get("events", 0) + len(w)
    n = max(1, len(windows))
    out = {k: round(v / n, 4) for k, v in out.items()}
    if out:
        out["idle"] = round(out["window"] - out["busy"], 4)
    return out


def k2_concurrency(ts, tensors, S, nz) -> dict:
    """What the 1D 4-shard chain's phase 1 costs the card without its
    exchanges: K2's phase 1 at 50k_full between events, all K members in
    one launch, K/4 in one launch, and four launches of K/4 members each on
    a stream of its own, issued together with nothing between them; then
    a trace of the four split as ``chain_trace_split`` splits a chain."""
    import torch

    inputs, o, a, l, r, _ = tensors
    sk = ts.shared_precompute(inputs, S, nz)
    kl = o.shape[0] // 4

    def part(s):
        cut = slice(s * kl, (s + 1) * kl)
        return ts.pack_member(inputs, sk, o[cut], a[cut], l[cut], r[cut], S, nz)

    streams = [torch.cuda.Stream() for _ in range(4)]

    def four():
        caller = torch.cuda.current_stream()
        for st in streams:
            st.wait_stream(caller)
        for s, st in enumerate(streams):
            with torch.cuda.stream(st):
                part(s)
        for st in streams:
            caller.wait_stream(st)

    out = {"all K, one launch": event_ms(lambda: ts.pack_member(inputs, sk, o, a, l, r, S, nz))[0],
           "K/4, one launch": event_ms(lambda: part(0))[0],
           "4 x K/4 on 4 streams": event_ms(four)[0]}
    log(f"K2 phase 1 concurrency at 50k_full, ms between events: {out}; the four's trace, ms: "
        f"{chain_trace_split(four)}; CUDA_DEVICE_MAX_CONNECTIONS="
        f"{os.environ.get('CUDA_DEVICE_MAX_CONNECTIONS')}")
    return out


def member_argmin_nan_check(meshed) -> float:
    """The member argmin's two kernels (each shard's seed, the root's final
    pick) against their plain versions over 4 logical shards of 2 members
    on ``nan_costs``, each kernel reading the other shards' buffers in
    place and from copies: seeds, phase-2 members and final buffers bit for
    bit, the seed and the winner jnp.argmin's."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.solver import torch_solver as ts

    n, kl, G, T, NS, S, B = 4, 2, 16, 6, 40, 12, 2
    K = n * kl
    rng = np.random.default_rng(19)
    dev = MESH_DEVICE
    orders = torch.from_numpy(rng.permuted(np.tile(np.arange(G, dtype=np.int32), (n, B, kl, 1)),
                                           axis=-1)).to(dev)
    alphas = torch.from_numpy(rng.random((n, B, kl)).astype(np.float32)).to(dev)
    looks = torch.from_numpy(rng.random((n, B, kl)) < 0.5).to(dev)
    rsvs = torch.from_numpy(rng.random((n, B, kl)) < 0.5).to(dev)
    swaps = torch.from_numpy(rng.permuted(np.tile(np.arange(G, dtype=np.int32), (n, B, kl, 1)),
                                          axis=-1)).to(dev)
    mesh = logical_mesh("1d", n)
    shards = [meshed._Shard(mesh, i) for i in range(n)]
    for c1, c2 in nan_costs(K):
        c1 = torch.tensor([c1] * B, dtype=torch.float32).reshape(B, n, kl).transpose(0, 1).contiguous().to(dev)
        c2 = torch.tensor([c2] * B, dtype=torch.float32).reshape(B, n, kl).transpose(0, 1).contiguous().to(dev)
        bufs = torch.stack([
            torch.from_numpy(rng.integers(0, 1 << 20, 4 + 4 * kl + 2 * S + T * NS).astype(np.int32))
            for _ in range(n * B)]).reshape(n, B, -1).to(dev)
        for s in range(n):
            for b in range(B):
                bufs[s, b, 0] = int(rng.integers(0, 2))
                bufs[s, b, 2] = int(rng.integers(0, kl))
                bufs[s, b, 4 : 4 + 2 * kl] = torch.cat([c1[s, b], c2[s, b]]).view(torch.int32)
                # each shard's K3 picks its own winner: make the head say so
                local = torch.cat([c1[s, b], c2[s, b]]).cpu()
                j = int(torch.argmin(local))
                bufs[s, b, 0], bufs[s, b, 2] = int(j >= kl), j % kl
        phase1 = [(c1[s], orders[s], alphas[s], looks[s], rsvs[s]) for s in range(n)]
        outs = []
        for plain, shared in ((False, True), (False, False), (True, True)):
            ctx = plain_mesh_kernels(meshed) if plain else contextlib.nullcontext()
            with ctx:
                meshed._record(shards)
                seeds = []
                for s, sh in enumerate(shards):
                    seen = meshed._read_from(sh, shards, phase1, shared, "member_argmin")
                    with meshed._on(sh):
                        seeds.append(meshed.mesh_seed(*zip(*seen), swaps[s]))
                meshed._record(shards)
                seen = meshed._read_from(shards[0], shards, [(bufs[s],) for s in range(n)], shared,
                                         "member_argmin")
                with meshed._on(shards[0]):
                    final = meshed.final_pick([b for b, in seen], seeds[0][4], kl)
                torch.cuda.synchronize()
                outs.append([x for seed in seeds for x in seed] + [final])
        for got in outs[:2]:
            for g, w in zip(got, outs[2]):
                if not torch.equal(g, w):
                    raise AssertionError("member argmin: a kernel differs from its plain version")
        flat1 = c1.transpose(0, 1).reshape(B, K).cpu()
        flat2 = c2.transpose(0, 1).reshape(B, K).cpu()
        final = outs[0][-1].cpu()
        for b in range(B):
            j = int(torch.argmin(flat1[b]))
            best = int(torch.argmin(torch.cat([flat1[b], flat2[b]])))
            if int(final[b, 1]) != j or (int(final[b, 0]), int(final[b, 2])) != (int(best >= K), best % K):
                raise AssertionError(f"member argmin: seed/winner not torch.argmin's on {flat1[b]}, {flat2[b]}")
    return 0.0


MESH_K2_PARTS = ("k2_prices", "k2m_kernel")


def argmin_calls(meshed, o, a, l, r, sw, n, S, E) -> dict:
    """One call of each member argmin kernel at 50k_full's shapes on the
    1D mesh's n shards (kl = K / n members each, random phase-1 costs, K3
    buffers of zeros): the seed on shard 0 reading every shard's phase-1
    members, the final pick reading every shard's K3 buffer."""
    import torch

    K, G = o.shape
    kl, dev = K // n, MESH_DEVICE
    member = lambda t, s: t[s * kl:(s + 1) * kl].unsqueeze(0).contiguous()  # noqa: E731
    costs = [torch.rand((1, kl), device=dev) for _ in range(n)]
    orders, alphas, looks, rsvs = ([member(t, s) for s in range(n)] for t in (o, a, l, r))
    swaps = member(sw, 0)
    bufs = [torch.zeros((1, 4 + 4 * kl + 2 * S + G * (E + S)), dtype=torch.int32, device=dev)
            for _ in range(n)]
    b1 = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    return {
        "seed": lambda: meshed.mesh_seed(costs, orders, alphas, looks, rsvs, swaps),
        "final": lambda: meshed.final_pick(bufs, b1, kl),
    }


def member_argmin_bytes(n: int, kl: int, G: int, Ll: int) -> tuple:
    """Bytes the member argmin's two kernels must move for one row, each
    input read once and each output written once: the seed on one shard
    (the n kl costs, the winner's order row, alpha, look and rsv, the
    shard's swaps; its phase-2 orders, alphas, looks, rsvs and seed out) and
    the final pick (every shard's head and 4 kl costs and flags, the seed,
    the winner's rows; the portfolio's buffer out)."""
    seed = 4 * n * kl + 4 * G + 6 + 4 * kl * G + 4 * kl * G + 6 * kl + 4
    final = 4 * n * (4 + 4 * kl) + 4 * (Ll - 4 - 4 * kl) + 4 + 4 * (Ll + 4 * kl * (n - 1))
    return seed, final


def mesh_timings(ts, meshed, tensors, S, nz, shards, ins, members, k1, errs) -> list:
    """Kernel, plain-version and bound times of the four wrappers at
    50k_full's shapes (two option shards; K2 on one shard, whole, so that a
    launch's time is its own, not an exchange's). ``shard_member``'s device
    time is its kernels' (``k2_prices``, ``k2m_kernel``) in a profiler
    trace of a phase, over the phase's launches; the phase's time between
    events, host issue included, is logged beside it."""
    import torch

    inputs, o, a, l, r, sw = tensors
    G, O, E, R, Z = ts._dims(ins[0])
    K = o.shape[0]
    dev = MESH_DEVICE
    B, nt = 1, meshed.k1_tiles(O, dev)
    part = torch.zeros((2, B, G, nt), dtype=torch.int32, device=dev)
    part_plain = torch.zeros((2, B, G, 1), dtype=torch.int32, device=dev)
    parts = torch.zeros((2, 2, B, G, nt), dtype=torch.int32, device=dev)
    parts_plain = torch.zeros((2, 2, B, G, 1), dtype=torch.int32, device=dev)
    sp = meshed.shard_precompute_part(ins[0], S, parts[0])
    meshed.shard_precompute_part(ins[1], S, parts[1])
    sp_plain = meshed.shard_precompute_part_ref(ins[0], S, parts_plain[0])
    meshed.shard_precompute_part_ref(ins[1], S, parts_plain[1])
    ms, plain_ms, bounds = {}, {}, {}
    ms["shard_precompute_part"] = time_ms(lambda: meshed.shard_precompute_part(ins[0], S, part))
    plain_ms["shard_precompute_part"] = time_ms(
        lambda: meshed.shard_precompute_part_ref(ins[0], S, part_plain), per=1)
    ms["shard_precompute_finish"] = time_ms(lambda: meshed.shard_precompute_finish(ins[0], sp, list(parts)))
    plain_ms["shard_precompute_finish"] = time_ms(
        lambda: meshed.shard_precompute_finish_ref(ins[0], sp_plain, list(parts_plain)), per=1)
    x, sk = ins[0], k1[0]
    part_in = nbytes(x.demand, x.demand_units, x.count, x.node_cap, x.quota, x.colocate, x.compat,
                     x.alloc, x.price, x.opt_valid, x.ex_compat, x.ex_valid)
    part_out = nbytes(sk.units, sk.units_rsv, sk.rsv_group, sk.zone_limited, sk.exok_pad, part)
    bounds["shard_precompute_part"] = bound(part_in + part_out, 2 * G * O * R * 3)
    fin_in = nbytes(x.demand, x.count, x.node_cap, x.colocate, x.compat, x.alloc, x.opt_valid,
                    sk.units, sk.units_rsv, parts)
    fin_out = nbytes(sk.lam, sk.val_pair, sk.units_rsv)
    bounds["shard_precompute_finish"] = bound(fin_in + fin_out, G * O * G * R * 5 + G * O * G * 3)
    # K2 on one shard holding every column: a phase's device time over its launches
    one = [shards[0]]
    whole = [ts._unsqueeze(inputs)]
    shared = [ts._unsqueeze(ts.shared_precompute(inputs, S, nz))]
    mem = [members[0]]
    launches = 2 + len(meshed.STAGES) * G


    def k2_phase():
        return meshed.shard_member_phase(one, whole, shared, mem, S)

    # the phase runs on the shard's stream, so its events and the trace's
    # spin go there too; the idle share varies with the host (a median of 9)
    with meshed._on(one[0]):
        phase_ms, _ = event_ms(k2_phase, reps=9)
        k2_parts = kernel_parts_ms(k2_phase, MESH_K2_PARTS, calls=3)
        with phase_mode(meshed, "stages"):
            stages_ms = event_ms(k2_phase, reps=3)[0]
    k2_device = sum(k2_parts.get(p, 0.0) for p in MESH_K2_PARTS)
    if k2_device <= 0.0:
        raise AssertionError(f"mesh timings: no device time of {MESH_K2_PARTS} in the trace: {k2_parts}")
    ms["shard_member"] = k2_device / launches
    log(f"mesh shard_member on one shard: a {launches}-launch phase {phase_ms:.4f} ms between events "
        f"through the phase entry (the per-stage issue {stages_ms:.4f} ms), its kernels "
        f"{k2_device:.4f} ms on the card (profiler, ms a phase: {k2_parts}); the card idle "
        f"{phase_ms - k2_device:.4f} ms of the phase ({100 * (1 - k2_device / phase_ms):.1f}%; the "
        f"per-stage issue's {100 * (1 - k2_device / stages_ms):.1f}%), "
        f"{(phase_ms - k2_device) / launches:.4f} ms a launch")
    with plain_mesh_kernels(meshed):
        pdev, _ = event_ms(lambda: meshed.shard_member_phase(one, whole, shared, mem, S), reps=1)
    plain_ms["shard_member"] = pdev / launches
    m = meshed.shard_member_phase(one, whole, shared, mem, S)[0]
    sh = shared[0]
    k2_in = nbytes(inputs.demand, inputs.demand_units, inputs.count, inputs.node_cap,
                   inputs.colocate, inputs.compat, inputs.alloc, inputs.price, inputs.opt_zone,
                   sh.units, sh.units_rsv, sh.quota, sh.exok_pad, o, a, l, r)
    k2_in += nbytes(sh.val_pair) if bool(l.any()) else 0
    k2_out = nbytes(m.cost, m.unplaced, m.exhausted, m.new_opt, m.new_active, m.ys)
    b2 = bound(k2_in + k2_out, k2_op_count(inputs, l, S))
    bounds["shard_member"] = (b2[0] / launches, b2[1])
    # the member argmin: its two kernels once each, at the 1D mesh's 4
    # shards, each reading the 4 shards' buffers through its table
    calls = argmin_calls(meshed, o, a, l, r, sw, 4, S, E)
    parts_ms = {k: time_ms(f) for k, f in calls.items()}
    with plain_mesh_kernels(meshed):
        plain_parts = {k: time_ms(f, per=1) for k, f in calls.items()}
    ms["member_argmin"] = sum(parts_ms.values()) / len(calls)
    plain_ms["member_argmin"] = sum(plain_parts.values()) / len(calls)
    arg_bytes = member_argmin_bytes(4, K // 4, G, 4 + 4 * (K // 4) + 2 * S + G * (E + S))
    bounds["member_argmin"] = (bound(sum(arg_bytes), 0)[0] / len(calls), "bytes")
    log(f"mesh timings: " + "; ".join(
        f"{k} kernel {ms[k]:.6f} ms, plain {plain_ms[k]:.6f} ms, bound {bounds[k][0]:.3e} ms "
        f"({bounds[k][1]})" for k in MESH_WRAPPERS)
        + f"; member argmin kernels {parts_ms} (plain {plain_parts}), {arg_bytes} bytes a row "
        f"(seed, final); shard_member's kernel ms a launch of a {launches}-launch phase (plain: "
        f"between events)")
    replaces = "karpenter_tpu/solver/jax_solver.py:842"
    return [
        {"name": k, "route": "cuda", "source": "karpenter_tpu_torch/solver/csrc/pack_solve.cu",
         "replaces": replaces, "launches": None, "max_abs_err": errs[k], "ms": ms[k],
         "plain_ms": plain_ms[k], "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
         "library_ms": None}
        for k in MESH_WRAPPERS
    ]


def kernel_plan(solver, problem, dispatch):
    """The plan a fleet row decodes to, and the row."""
    from karpenter_tpu_torch.solver.torch_solver import unpack_solve_fused

    shared = dispatch.shared
    row = shared.materialize()[dispatch.row]
    order, unplaced, costs, exhausted, new_opt, new_active, ys = unpack_solve_fused(
        row, dispatch.orders.shape[0], dispatch.s_new, shared.key.G, shared.key.E,
        dispatch.orders, dispatch.swaps)
    return solver._decode(problem, order, new_opt, new_active, ys), row, unplaced


def plan_key(result):
    return sorted((n.option.instance_type.name, n.option.zone, n.option.capacity_type,
                   tuple(sorted(n.pod_names))) for n in result.new_nodes)


def mesh_superproblem(ts, configs) -> dict:
    """(b) ``configs.config_mesh_superproblem()`` at full size: a seed round
    of every cell and churn round 0, each cell with its own
    ``EncodeSession``, through ``stage_fleet`` on per-cell solvers holding
    one 2x2 logical mesh (superproblem mode) and, on copies of the same
    problems, on meshless per-cell solvers (the fleet path). Every row bit
    for bit, every kernel plan and digest equal, every plan valid, a
    superproblem dispatch a round on the 2x2 axes, the mesh dispatch
    counter and ``{phase=gather}`` moved; then ``solve_pods`` on the meshed
    solvers (the race), each result held by ``hold_reconcile``."""
    import dataclasses

    import numpy as np
    import torch

    from karpenter_tpu_torch.solver import EncodeSession, TorchSolver, encode, stage_fleet, validate
    from karpenter_tpu_torch.solver.solver import KERNEL_BOARD, problem_digest
    from karpenter_tpu_torch.utils import metrics

    KERNEL_BOARD.reset()
    knobs = configs.MESH_SUPERPROBLEM
    t0 = time.perf_counter()
    cells, provs, catalog = configs.config_mesh_superproblem()
    n = len(cells)
    log(f"mesh superproblem config: {sum(map(len, cells))} pods in {n} cells, built in "
        f"{time.perf_counter() - t0:.2f} s")
    mesh = logical_mesh("2d", MESH_SUPER_SHAPE)
    supers = [TorchSolver(mesh=mesh, superproblem_max_cells=knobs["superproblem_max_cells"])
              for _ in range(n)]
    fleets = [TorchSolver() for _ in range(n)]
    sessions = [EncodeSession() for _ in range(n)]
    dispatched0 = metrics.MESH_DISPATCH.value({"axes": "2x2"})
    gathers0 = metrics.SOLVE_PHASE.count({"phase": "gather", "mode": "sharded"})
    for rnd in MESH_SUPER_ROUNDS:
        t0 = time.perf_counter()
        if rnd == "seed":
            dirty = list(range(n))
        else:
            events = configs.churn_mesh_cells(cells, rnd, knobs["churn_cells"], knobs["n_pods"],
                                              knobs["n_deploys"])
            dirty = list(events)
            for c, (removed, added) in events.items():
                for q in removed:
                    sessions[c].pod_event("DELETED", q)
                for q in added:
                    sessions[c].pod_event("ADDED", q)
        requests = [{"pods": list(cells[c].values()), "provisioners": [(provs[c], catalog)],
                     "session": sessions[c]} for c in dirty]
        owners = [supers[c] for c in dirty]
        staged = [s.encode_for_staging(**req) for s, req in zip(owners, requests)]
        copies = [dataclasses.replace(q) for q in staged]
        t1 = time.perf_counter()
        for s, q in zip(owners, staged):
            s.prestage(q)
        st_super = stage_fleet(list(zip(owners, staged)), max_batch=knobs["fleet_max_batch"],
                               superproblem_max_cells=knobs["superproblem_max_cells"])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        st_fleet = stage_fleet([(fleets[c], q) for c, q in zip(dirty, copies)],
                               max_batch=knobs["fleet_max_batch"])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if (st_super["superproblems"] < 1 or st_super["mesh_axes"] != "2x2"
                or st_super["cells_batched"] != len(dirty) or st_fleet["cells_batched"] != len(dirty)):
            raise AssertionError(f"mesh superproblem round {rnd}: stats {st_super} / {st_fleet}")
        kernel_costs = []
        for c, q, cp in zip(dirty, staged, copies):
            got, row, unplaced = kernel_plan(supers[c], q, q.__dict__["_fleet_dispatch"])
            want, row_f, _ = kernel_plan(fleets[c], cp, cp.__dict__["_fleet_dispatch"])
            if not np.array_equal(row, row_f):
                raise AssertionError(f"mesh superproblem round {rnd} cell {c}: the meshed row "
                                     f"differs from the fleet row")
            if plan_key(got) != plan_key(want) or problem_digest(q) != problem_digest(cp):
                raise AssertionError(f"mesh superproblem round {rnd} cell {c}: plans or digests differ")
            if unplaced == 0 and validate(q, got):
                raise AssertionError(f"mesh superproblem round {rnd} cell {c}: the kernel plan "
                                     f"fails validation")
            kernel_costs.append(got.cost)
        t4 = time.perf_counter()
        results = [s.solve_pods(**req, pre_encoded=q) for s, req, q in zip(owners, requests, staged)]
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        for c, s, res in zip(dirty, owners, results):
            want_mode = "full" if rnd == "seed" else "delta"
            if sessions[c].last_mode != want_mode:
                raise AssertionError(f"mesh superproblem round {rnd} cell {c}: encoded "
                                     f"{sessions[c].last_mode}, not {want_mode}")
            # a seed round's session encodes in full: its own problem is the full encode
            full = (interned(s, res) if rnd == "seed"
                    else encode(sessions[c].ordered_pods(), [(provs[c], catalog)]))
            hold_reconcile(f"mesh superproblem round {rnd} cell {c}", s, res, full, validate)
        log(f"mesh superproblem round {rnd}: {len(dirty)} cells, encode "
            f"{t1 - t0:.4f} s, prestage + meshed stage_fleet {t2 - t1:.4f} s "
            f"({st_super['dispatches']} dispatch, {st_super['buckets']}), fleet stage_fleet "
            f"{t3 - t2:.4f} s ({st_fleet['buckets']}), every row bit for bit and every kernel "
            f"plan and digest equal ({t4 - t3:.4f} s), solve_pods {t5 - t4:.4f} s; kernel plan "
            f"costs {sorted({round(x, 6) for x in kernel_costs})}, race backends "
            f"{sorted({r.stats['backend'] for r in results})}, kernel rows won "
            f"{sum(r.stats.get('race_winner', 0.0) == 1.0 for r in results)}")
    dispatched = metrics.MESH_DISPATCH.value({"axes": "2x2"}) - dispatched0
    gathers = metrics.SOLVE_PHASE.count({"phase": "gather", "mode": "sharded"}) - gathers0
    if dispatched < len(MESH_SUPER_ROUNDS) or gathers < len(MESH_SUPER_ROUNDS):
        raise AssertionError(f"mesh superproblem: mesh dispatches {dispatched}, gathers {gathers}")
    log(f"mesh superproblem: karpenter_tpu_mesh_dispatch_total{{axes=2x2}} +{dispatched:g}, "
        f"solve_phase_seconds{{phase=gather}} +{gathers} observations")
    return {"dispatches": dispatched, "gathers": gathers}


def mesh_flat(ts, configs) -> None:
    """(b) continued, the 1D mesh on the flat path: ``TorchSolver(mesh=<4
    logical shards>).solve`` on 50k_full in latency mode, a first solve and
    a repeat (the chain dispatched on the side stream over the shards, the
    member argmin picking the seed and the winner), held by ``hold_race``;
    then a kernel-only solve of a fresh problem, at the JAX package's
    pinned cost."""
    import dataclasses

    import torch

    from karpenter_tpu_torch.solver import TorchSolver, encode, meshed, validate
    from karpenter_tpu_torch.solver.solver import KERNEL_BOARD

    KERNEL_BOARD.reset()
    mesh = logical_mesh("1d", 4)
    solver = TorchSolver(mesh=mesh)
    problem = encode(*configs.config_50k_full())
    ref = configs.REFERENCE_COSTS["50k_full"]
    for attempt in ("first", "repeat"):
        before = dict(meshed.LAUNCHES)
        t0 = time.perf_counter()
        result = solver.solve(problem)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        moved = {k: meshed.LAUNCHES[k] - before[k] for k in before}
        hold_race(f"mesh flat race {attempt}", problem, result, validate)
        if result.cost > ref * (1 + COST_RTOL):
            raise AssertionError(f"mesh flat race: cost {result.cost!r} above the kernel's {ref!r}")
        if attempt == "first" and moved["member_argmin"] < 1:
            raise AssertionError(f"mesh flat race: the meshed chain was not dispatched: {moved}")
        log(f"mesh flat race {attempt} (1D, 4 shards): backend {result.stats['backend']}, cost "
            f"{result.cost!r}, kernel device {result.stats.get('dispatch_device_ms')} ms, solve "
            f"{wall:.4f} s, meshed launches {moved}")
    fresh = dataclasses.replace(problem)  # the same pods, no race memory
    got = TorchSolver(mesh=mesh)._solve_kernel(fresh)
    if validate(fresh, got) or abs(got.cost - ref) > COST_RTOL * ref:
        raise AssertionError(f"mesh flat kernel-only: cost {got.cost!r}, the JAX package's {ref!r}")
    log(f"mesh flat kernel-only (1D, 4 shards): cost {got.cost!r} (the JAX package's {ref!r}), "
        f"{got.stats['fused_passes']:g} fused passes, slots {got.stats['slots']:g}")


def mesh_controller(ts, configs) -> None:
    """(c) One sharded controller round with ``mesh_enabled`` on a solver
    holding a 2x2 logical mesh, and its meshless twin, on
    ``config_controller_cells(8,000 pods, 8 cells)``: every pod bound within
    allocatable in both, the same per-cell digests and fleet dispatches, and
    the meshed round's cells staged as a superproblem."""
    import torch

    from karpenter_tpu_torch.controllers.provisioning import ProvisioningController
    from karpenter_tpu_torch.solver import TorchSolver, meshed
    from karpenter_tpu_torch.solver.solver import KERNEL_BOARD

    KERNEL_BOARD.reset()
    seen = {}
    for arm in ("mesh", "meshless"):
        cluster, provider, settings, _ = configs.config_controller_cells(
            n_pods=MESH_CONTROLLER_PODS, n_cells=MESH_CONTROLLER_CELLS)
        settings.mesh_enabled = True
        solver = TorchSolver(mesh=logical_mesh("2d", MESH_SUPER_SHAPE) if arm == "mesh" else None)
        ctl = ProvisioningController(cluster, provider, solver=solver, settings=settings)
        before, mbefore = dict(ts.LAUNCHES), dict(meshed.LAUNCHES)
        t0 = time.perf_counter()
        res = ctl.reconcile()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        name = f"mesh controller ({arm})"
        if cluster.pending_pods() or res.unschedulable:
            raise AssertionError(f"{name}: {len(cluster.pending_pods())} pods pending")
        hold_allocatable(name, cluster)
        st = res.solve.stats
        digests = [(s["name"], s["digest"]) for s in ctl.cells.last_round]
        seen[arm] = (digests, st["fleet_dispatches"], st["fleet_cells_batched"])
        moved = {k: ts.LAUNCHES[k] - before[k] for k in before}
        mmoved = {k: meshed.LAUNCHES[k] - mbefore[k] for k in mbefore}
        log(f"{name}: {len(cluster.pods)} pods bound on {len(cluster.nodes)} nodes in {wall:.4f} s; "
            f"cells {st['cells']:g}, fleet dispatches {st['fleet_dispatches']:g}, cells batched "
            f"{st['fleet_cells_batched']:g}, superproblems {st.get('superproblems', 0.0):g}; "
            f"launches {moved}, meshed {mmoved}")
        if arm == "mesh" and st.get("superproblems", 0.0) < 1:
            raise AssertionError(f"{name}: no superproblem dispatch: {st}")
    if seen["mesh"] != seen["meshless"]:
        raise AssertionError(f"mesh controller: the meshed round differs from its twin: {seen}")


def mesh_one_card() -> None:
    """(d) ``Operator.new(settings=Settings(mesh_enabled=True))`` on this
    card: one card, so no mesh, as the reference builds none on one
    device."""
    import torch

    from karpenter_tpu_torch.api.settings import Settings
    from karpenter_tpu_torch.operator import Operator

    op = Operator.new(settings=Settings(mesh_enabled=True))
    try:
        solver = op.provisioning.solver
        if torch.cuda.device_count() == 1 and (solver.mesh_shape is not None
                                               or solver._ensure_mesh() is not None):
            raise AssertionError(f"one card built a mesh: {solver.mesh_shape}, {solver.mesh}")
        log(f"mesh one card: Operator.new(mesh_enabled=True) on {torch.cuda.device_count()} card "
            f"builds mesh_shape {solver.mesh_shape}, mesh {solver._ensure_mesh()}")
    finally:
        op.close()


def mesh_phase(ts, configs) -> tuple:
    """The meshed tier (``parallel/mesh.py``, ``solver/meshed.py``) on
    logical shards of the one card: (a) ``mesh_kernel_check``, then the main
    path, (b) ``mesh_superproblem`` and ``mesh_flat`` and (c)
    ``mesh_controller``, with the meshed wrappers' counts set to 0 just
    before (b) and read just after (c). Returns the four wrappers' kernel
    entries with their main-path launches. (d), ``mesh_one_card``, runs at
    the end of the run: ``Operator.new`` reconfigures process-wide state
    (the perf sentinel, lifecycle tracking, the decision log), which the
    phases in between must not run under."""
    from karpenter_tpu_torch.solver import meshed

    kernels = mesh_kernel_check(ts, configs)
    for k in meshed.LAUNCHES:
        meshed.LAUNCHES[k] = 0
    paths, copies0 = dict(meshed.PHASE_PATHS), dict(meshed.COPIES)
    mesh_superproblem(ts, configs)
    mesh_flat(ts, configs)
    mesh_controller(ts, configs)
    launches = dict(meshed.LAUNCHES)
    paths = {k: meshed.PHASE_PATHS[k] - paths[k] for k in paths}
    copies = {k: meshed.COPIES[k] - copies0[k] for k in copies0}
    log(f"mesh launches on the main path {launches}; exchange copies {copies}; its K2 phases by "
        f"path {paths}")
    if any(copies.values()):
        raise AssertionError(f"mesh: the main path's shards share the card, yet copied {copies}")
    if paths["stages"] or not paths["entry"]:
        raise AssertionError(f"mesh: the main path's K2 phases did not all take the phase entry: {paths}")
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
        if entry["launches"] < 1:
            raise AssertionError(f"{entry['name']} was not launched on the meshed main path")
    return kernels


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


#: the sharded controller's fleet: the first 6 of ``config_controller_cells``'
#: 20 cells of 25,000 pods (cut from 500,000 pods to keep the run inside its
#: limit: at 20 cells the seed round took 222-270 s, 168-187 s of it the
#: host's launches; at 10 cells 131 s on a slow host, whose run was at
#: 1,115 s of its 1,200 before its last two phases, against 84 s at 6)
SHARDED_PODS, SHARDED_CELLS = 150_000, 6
#: what the seed round of ``controller_sharded`` launches: one fleet chain
#: (the 6 cells in one chunk padded to B=8: K1, K2 twice, K3) on a
#: device-side stack, and the first ``device_rtt`` probe (a warm call and
#: three timed ones)
SHARDED_SEED_LAUNCHES = {"shared_precompute": 1, "pack_member": 2, "pack_epilogue": 1,
                         "stage_patch": 0, "fleet_stack": 1, "rtt_probe": 4}
#: what a churn round of ``config_controller_cells`` gives (the JAX
#: package's answer at 2,000 pods, ``tests/test_torch_sharded.py``): only
#: the 4 churned cells hold pending pods; round 0's cells delta-encode, and
#: later rounds' cells, emptied by the seed round's binds, start afresh
#: (cut to round 0 to keep the run inside its limit; rounds 1-2 encoded in
#: full, "first-encode", and ``tests/test_torch_sharded.py`` holds both modes)
SHARDED_CHURN_MODES = {0: ("delta", "")}
#: the worker check's fleet: 8 cells of 1,000 pods (cut from 2,000 a cell
#: to keep the run inside its limit; every cell still races, in one b8 fleet)
WORKER_CHECK_PODS = 8_000


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
    (``SHARDED_PODS`` pending pods in ``SHARDED_CELLS`` cells of 25k, 60
    types; 8 workers, fleet chunks of up to 16): a seed round, then the
    churn rounds of ``SHARDED_CHURN_MODES`` applied through the cluster.
    Every round is held by ``sharded_round``. The seed round must solve
    every cell with none reused and no residue, each cell's problem the
    ``config_cells`` problem (so its cost is at most the JAX package's
    kernel-only ``cells_seed``, the most of the 20 cells), in one fleet
    dispatch, its width ``SHARDED_CELLS`` padded to a power of two, that
    batches them all, launching what
    ``SHARDED_SEED_LAUNCHES`` says.
    A churn round must solve the 4 churned cells (none reused, no residue)
    in the modes ``SHARDED_CHURN_MODES`` names. Then the worker check:
    ``config_controller_cells(WORKER_CHECK_PODS, 8)``'s seed round on twin clusters at
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
    cluster, provider, settings, churn_round = configs.config_controller_cells(
        n_pods=SHARDED_PODS, n_cells=SHARDED_CELLS)
    ctl = ProvisioningController(cluster, provider, settings=settings)
    log(f"sharded controller config: {len(cluster.pods)} pending pods in "
        f"{len(cluster.provisioners)} cells, {len(provider.catalog)} types, built in "
        f"{time.perf_counter() - t0:.2f} s; solver on {ctl.solver.device}, "
        f"{settings.cell_shard_workers} workers")
    probe = ShardedProbe(ctl, solver_mod, prov_mod, hostpool)
    launches = {k: 0 for k in ts.LAUNCHES}
    try:
        torch.cuda.reset_peak_memory_stats()
        for rnd in ["seed", *SHARDED_CHURN_MODES]:
            name = f"sharded round {rnd}"
            if rnd != "seed":
                churn_round(rnd)
            facts = sharded_round(ts, st, ctl, probe, solver_mod, name)
            launches = {k: launches[k] + facts["moved"][k] for k in launches}
            stats = facts["stats"]
            if rnd == "seed":
                log(f"{name}: peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} "
                    f"MiB over {len(ctl._cell_solvers)} solver clones")
                want = dict(cells=float(SHARDED_CELLS), cells_reused=0.0, residue_pods=0.0,
                            fleet_dispatches=1.0, fleet_cells_batched=float(SHARDED_CELLS))
                if stats != want or facts["widths"] != [1 << (SHARDED_CELLS - 1).bit_length()]:
                    raise AssertionError(f"{name}: stats {stats}, fleet widths {facts['widths']}")
                if facts["moved"] != SHARDED_SEED_LAUNCHES:
                    raise AssertionError(f"{name}: launches {facts['moved']}, not "
                                         f"{SHARDED_SEED_LAUNCHES}")
                hold_pack_launches(name, facts["moved"])
                cells, provs, catalog = configs.config_cells(SHARDED_PODS, SHARDED_CELLS)
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
        cluster, provider, settings, _ = configs.config_controller_cells(
            n_pods=WORKER_CHECK_PODS, n_cells=8)
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
#: BASELINE.md's 2,000-node, 20,000-pod repack, cut to its first pass by
#: time (20.7-28.1 s a pass of host work): the pass that holds the pinned
#: ``consolidation_20k`` sim; ``bench`` is ``bench.py``'s default fleet,
#: run to quiescence as the bench runs it
CONSOLIDATION_FLEETS = {"full": (2000, 10, 1), "bench": (300, 3, 40)}


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
            info, patched = solver._stager.last_round, solver._stager.last_patch
            if info is not staged and info["restage"]:
                probe.hold_restage(solver, problem, entry, info, patched)
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

    def hold_restage(self, solver, problem, entry, info, patched) -> None:
        """The resident leaves a restage left, against the arrays
        ``_prepare`` gives for the problem (what a full upload copies):
        the same dtype, shape and bytes, every leaf. ``patched`` is the
        stager's ``last_patch``: the restage is a call for each device it
        patched."""
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
            self.calls += patched["devices"]
            self.patched += info["restage"]
            self.restaged_rows += sum(info["rows"].values())

    def reset(self) -> None:
        self.solves, self.kernels, self.misses = [], [], []
        self.restages = self.calls = self.patched = self.restaged_rows = 0
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
    once and K2 twice at least, and the pass's ``stage_patch`` launches
    (``launched``) one for each restaging call that ``hold_restage`` held,
    with every restaged leaf held byte for byte. Returns the pass's sim
    facts."""
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
    if launched["stage_patch"] != probe.calls:
        raise AssertionError(f"{name}: {launched['stage_patch']} stage_patch launches, "
                             f"{probe.calls} restaging calls held ({probe.patched} leaves)")
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
            f"launches {moved}, restages held {probe.restages} ({probe.calls} calls, {probe.patched} leaves, "
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

    (a) BASELINE's fleet (2,000 nodes, 20,000 pods), its first pass. The first
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
OPERATOR_DRIFT_PASSES = 2
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
        if device is not None:
            # the dispatch's host sample: observed (the poll saw the
            # transition) or censored (ready at the first look)
            ready = s.stats.get("dispatch_s")
            verdict += (f", chain device {device} ms, host path {s.stats.get('race_host_s', 0.0):.4f}"
                        f" s, poll {s.stats.get('race_poll_s', 0.0):.6f} s, dispatch->ready "
                        + ("censored" if ready is None else f"{ready:.6f} s observed"))
        return verdict

    solves = [f"{int(p.count.sum())} pods at E={p.E}, backend {s.stats['backend']}, {race(p, s)}"
              for p, s in problems]
    return (f"{name}: wall {row['wall']:.4f} s, interruption {row.get('handled')} messages "
            f"in {row.get('intr_s', 0.0):.4f} s, {row.get('repended', 0)} pods re-pended, "
            f"provisioning {row.get('prov_s', 0.0):.4f} s ({'; '.join(solves) or 'no solve'}), "
            f"deprovisioning {row.get('deprov_s', 0.0):.4f} s "
            f"({row['action'].reason if row.get('action') else 'no action'}), cost ledger "
            f"{row.get('ledger_s', 0.0):.4f} s, {capture_note(row['capture_s'], row['wall'])}, "
            f"launches {row['launches']}")


class ChainIssue:
    """Where one step's kernel chains spent their time on the host and on
    the card. While open it stamps the host clock at every entry and exit
    of ``_Pending.enqueue``, the solver's ``pack_solve_fused`` and the
    three wrappers it calls (K1, K2 twice, K3), records the garbage
    collector's passes (``gc.callbacks``) and what the caching allocator
    did around each enqueue (``torch.cuda.memory_stats``: device
    allocations, retries after freeing its cache), and traces the card with
    ``torch.profiler`` (device activity only). ``lines()`` says, for each
    chain, its host issue between stamps, the collector's passes inside it,
    the allocator's moves, the threads alive, and the chain's kernels on
    the card: their own time and the span from the first one's start to
    the last one's end."""

    ALLOCATOR = ("num_device_alloc", "num_device_free", "num_alloc_retries",
                 "num_sync_all_streams")

    WRAPPED = ("shared_precompute", "pack_member", "pack_epilogue")

    def __init__(self, ts):
        import gc

        import torch
        from torch.profiler import ProfilerActivity, profile

        from karpenter_tpu_torch.solver import solver as solver_mod

        self.ts, self.solver_mod, self.gc = ts, solver_mod, gc
        self.stamps, self.passes, self.threads, self.allocator = [], [], [], []
        self._saved = []
        # device activity only (the host side is stamped); the CPU's
        # activity where no card is present, so that a rehearsal runs
        self._prof = profile(activities=[ProfilerActivity.CUDA if torch.cuda.is_available()
                                         else ProfilerActivity.CPU])
        self._torch = torch
        self._gc_t = None

    def _stamp(self, what):
        self.stamps.append((what, time.perf_counter()))

    def _wrap(self, owner, name, tag):
        fn = getattr(owner, name)
        self._saved.append((owner, name, owner.__dict__[name]))
        stamp = self._stamp

        def wrapped(*a, **kw):
            stamp(f"{tag} in")
            try:
                return fn(*a, **kw)
            finally:
                stamp(f"{tag} out")

        setattr(owner, name, wrapped)

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_t = time.perf_counter()
        elif self._gc_t is not None:
            self.passes.append((info["generation"], self._gc_t, time.perf_counter()))

    def __enter__(self):
        enqueue = self.solver_mod._Pending.enqueue
        self._saved.append((self.solver_mod._Pending, "enqueue",
                            self.solver_mod._Pending.__dict__["enqueue"]))

        def allocator():
            if not self._torch.cuda.is_available():
                return {}
            stats = self._torch.cuda.memory_stats()
            return {k: stats.get(k, 0) for k in self.ALLOCATOR}

        def enq(cls, run, device, stream=None):
            before = allocator()
            self._stamp("enqueue in")
            self.threads.append(sorted(t.name for t in threading.enumerate()))
            try:
                return enqueue(run, device, stream)
            finally:
                self._stamp("enqueue out")
                after = allocator()
                self.allocator.append({k: after[k] - before[k] for k in after})

        self.solver_mod._Pending.enqueue = classmethod(enq)
        self._wrap(self.solver_mod, "pack_solve_fused", "chain")
        for name in self.WRAPPED:
            self._wrap(self.ts, name, name)
        self.gc.callbacks.append(self._on_gc)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        self.gc.callbacks.remove(self._on_gc)
        for owner, name, value in reversed(self._saved):
            setattr(owner, name, value)
        return False

    def chains(self):
        """Each chain's stamps, from its ``enqueue in`` to its ``enqueue out``."""
        out, cur = [], None
        for what, t in self.stamps:
            if what == "enqueue in":
                cur = [(what, t)]
            elif cur is not None:
                cur.append((what, t))
                if what == "enqueue out":
                    out.append(cur)
                    cur = None
        return out

    def kernels(self):
        """The chains' kernels on the card, in order: ``[(name, start_us, end_us)]``."""
        parts = ("k1_units", "k1_val_pair", "k2_prices", "k2_scan", "pack_epilogue")
        evs = [(ev.name, ev.time_range.start, ev.time_range.end) for ev in self._prof.events()
               if str(ev.device_type).endswith("CUDA") and any(p in ev.name for p in parts)]
        return sorted(evs, key=lambda e: e[1])

    def lines(self) -> list:
        out = []
        chains = self.chains()
        kernels = self.kernels()
        per = len(kernels) // max(len(chains), 1)
        for i, chain in enumerate(chains):
            t0, t1 = chain[0][1], chain[-1][1]
            steps = ", ".join(f"{what} +{(t - t0) * 1e3:.3f}" for what, t in chain)
            inside = [(g, (b - a) * 1e3) for g, a, b in self.passes if a < t1 and b > t0]
            ks = kernels[i * per:(i + 1) * per] if per else []
            own = sum((e - s) for _, s, e in ks) / 1e3
            span = (ks[-1][2] - ks[0][1]) / 1e3 if ks else None
            gaps = [round((ks[j + 1][1] - ks[j][2]) / 1e3, 4) for j in range(len(ks) - 1)]
            out.append(
                f"chain {i}: host issue {(t1 - t0) * 1e3:.3f} ms ({steps} ms); garbage "
                f"collector passes inside (generation, ms) {inside}; allocator "
                f"{self.allocator[i]}; {len(self.threads[i])} "
                f"threads {self.threads[i]}; on the card {len(ks)} kernels, own "
                f"{own:.4f} ms, first start to last end "
                f"{'none traced' if span is None else f'{span:.4f} ms'}, gaps (ms) {gaps}")
        return out


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
        # (a) the seed round, its chain's issue stamped and traced
        with ChainIssue(ts) as issue:
            row = probe.step(ts)
        for line in issue.lines():
            log(f"operator seed {line}")
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

    env = child_env(PYTHONPATH=str(root))
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

    env = child_env(PYTHONPATH=str(root))
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


def replay_cli(*runs) -> list:
    """``python -m karpenter_tpu_torch.replay`` on each run's capsule dump
    (``(tag, *args)``), the subprocesses on the card side by side: each must
    exit 0. Returns their summaries, in order."""
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    procs = [(tag, args, subprocess.Popen(
        [sys.executable, "-m", "karpenter_tpu_torch.replay", CAPSULE_PATHS[tag], *args],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for tag, *args in runs]
    summaries = []
    try:
        for tag, args, proc in procs:
            stdout, stderr = proc.communicate(timeout=REPLAY_CLI_S)
            wall = time.perf_counter() - t0
            summary = "\n".join(stdout.strip().splitlines()[:12])
            if proc.returncode != 0:
                raise AssertionError(f"replay CLI on ({tag}) {list(args)}: exit code "
                                     f"{proc.returncode}\n{summary}\n{stderr[-3000:]}")
            log(f"replay CLI on ({tag}) {list(args)}: exit 0 in {wall:.2f} s:\n{summary}")
            summaries.append(summary)
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return summaries


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
    it, zone, ct = ice[0]
    # the two CLI runs side by side, so that the phase's wall pays for one
    _, summary = replay_cli(("a",), ("c", "--override", f"offerings={it}/{zone}/{ct}=available"))
    if "counterfactual of capsule" not in summary:
        raise AssertionError(f"replay CLI on (c): not a counterfactual: {summary}")
    return dict(launches=launches, errs=errs)


#: the fault-domain phase: the breaker's threshold and recovery timeout
#: (``bench_device_faults``' own), the validation-overhead ABBA's repeats,
#: and the kind each scripted fault is booked as
#: (``karpenter_tpu_kernel_faults_total{kind}``), as the JAX package books it
FAULT_PODS = 20_000
FAULT_THRESHOLD = 3
FAULT_RECOVERY_S = 1.0
#: the validation ABBA's rounds: one ABBA cycle (cut from two to keep the
#: run inside its limit)
FAULT_ABBA_REPEATS = 4
FAULT_BOOKED = {"compile-error": "compile-error", "dispatch-hang": "dispatch-timeout",
                "device-oom": "device-oom", "nan-result": "nonfinite-plan",
                "garbage-result": "invalid-plan", "staging-corruption": "invalid-plan"}


def kernel_faults() -> dict:
    """``karpenter_tpu_kernel_faults_total`` by kind, in this process."""
    from karpenter_tpu_torch.utils import metrics

    with metrics.KERNEL_FAULTS._lock:
        return {dict(k)["kind"]: v for k, v in metrics.KERNEL_FAULTS._values.items()}


def faults_moved(before: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in kernel_faults().items()
            if v != before.get(k, 0.0)}


def invalid_bindings(cluster) -> int:
    """Bindings that break a node's allocatable (one pod slot each), taints
    or labels, re-derived from the cluster's state
    (``bench_device_faults``' own audit)."""
    from karpenter_tpu_torch.api import Resources
    from karpenter_tpu_torch.api.requirements import Requirements
    from karpenter_tpu_torch.api.taints import tolerates_all

    bad = 0
    by_node = {}
    for pod in cluster.pods.values():
        if pod.node_name is not None:
            by_node.setdefault(pod.node_name, []).append(pod)
    for node_name, pods in by_node.items():
        node = cluster.nodes.get(node_name)
        if node is None:
            bad += len(pods)
            continue
        total = Resources(pods=len(pods))
        surface = Requirements.from_labels(node.meta.labels)
        for pod in pods:
            total = total + pod.requests
            if not tolerates_all(list(pod.tolerations), tuple(node.taints)):
                bad += 1
            elif not any(surface.compatible(t) for t in pod.scheduling_requirement_terms()):
                bad += 1
        if not total.fits(node.allocatable):
            bad += 1
    return bad


def wait_breakers_not_open(board, timeout_s: float = 10.0) -> None:
    """Wait until no bucket's breaker is open (reading a state turns open
    into half-open once the recovery timeout has passed), so that the next
    dispatch is a probe that consults the seams."""
    deadline = time.monotonic() + timeout_s
    while "open" in board.states().values():
        if time.monotonic() > deadline:
            raise AssertionError(f"fault domain: breakers still open: {board.states()}")
        time.sleep(0.05)


def resident_alloc(solver):
    """The host copy of ``alloc`` the solver's stager holds for its one
    resident cell (what the card's copy was uploaded from)."""
    entries = [e for tag, e in solver._stager._entries.items() if tag[0] == "cell"]
    if len(entries) != 1:
        raise AssertionError(f"fault domain: {len(entries)} resident cells, not 1")
    return entries[0].host["alloc"].copy()


def fault_domain_phase(ts, configs) -> dict:
    """Main path, the solver's fault domain: ``bench.bench_device_faults``'
    scenario (``configs.config_device_faults()``: 20,000 pods, 60 types, a
    fresh cluster, controller and ``TorchSolver(device="cuda",
    dispatch_timeout_s=0.5)`` a round; the kernel breaker at threshold 3
    and a 1 s recovery). Two warm rounds, then six storm rounds, one
    scripted fault each (``configs.DEVICE_FAULT_STORM``), each started once
    no breaker is open, so that its dispatch consults the seams; the
    compile failure's round first forgets which buckets were built. Each
    kind must fire, and be booked as ``FAULT_BOOKED`` names it. In latency
    mode a hung dispatch is a missed race, which books no kernel fault (nor
    does the reference's ``_poll_dispatch``); the reference books
    ``dispatch-timeout`` at a synchronous fetch, so the hang's round also
    solves its own problem on the kernel path alone under a second hang,
    which must answer None within the deadline. Every storm round binds
    every pod, with no invalid binding by an audit of allocatable, taints
    and labels independent of the firewall; the breaker opens during the
    storm. Then the first clean round, on the staging round's solver (its
    stager holds the corrupted ``alloc``), must launch K1, K2 and K3,
    upload ``alloc`` again (the self-heal) and give a kernel-only plan that
    validates; clean rounds follow until every breaker is closed. Last, the
    validation ABBA (``FAULT_ABBA_REPEATS`` rounds, on and off, no faults):
    round p50s and the firewall's own share. Returns the phase's launches."""
    import statistics as stats_

    import numpy as np

    from karpenter_tpu_torch.solver import validate
    from karpenter_tpu_torch.solver.solver import KERNEL_BOARD
    from karpenter_tpu_torch.utils import faults

    make = configs.config_device_faults(n_pods=FAULT_PODS)
    n_pods = FAULT_PODS
    seq = iter(range(1 << 20))
    before_phase = dict(ts.LAUNCHES)

    def one_round(validation_on=True, solver=None):
        cluster, ctl = make(next(seq), validation_on=validation_on, solver=solver)
        t0 = time.perf_counter()
        result = ctl.reconcile()
        return cluster, ctl, result, time.perf_counter() - t0

    KERNEL_BOARD.configure(failure_threshold=FAULT_THRESHOLD, recovery_timeout_s=FAULT_RECOVERY_S)
    faults.install_device_faults(None)
    try:
        for _ in range(2):
            _, _, result, dt = one_round()
            log(f"fault domain warm round: {dt:.4f} s, {len(result.bound)} bound")
        tripped, stage_solver, storm_s = False, None, []
        for kind in configs.DEVICE_FAULT_STORM:
            wait_breakers_not_open(KERNEL_BOARD)
            if kind == "compile-error":
                KERNEL_BOARD.forget_builds()
            plan = faults.DeviceFaultPlan()
            plan.script([faults.DeviceFault(kind=kind, hang_s=5.0)])
            booked0, launched0 = kernel_faults(), dict(ts.LAUNCHES)
            faults.install_device_faults(plan)
            try:
                cluster, ctl, result, dt = one_round()
                extra = ""
                if kind == "dispatch-hang":
                    problem = interned(ctl.solver, result.solve)
                    sync = faults.DeviceFaultPlan().dispatch_hang(seconds=5.0)
                    faults.install_device_faults(sync)
                    t0 = time.perf_counter()
                    if ctl.solver._solve_kernel(problem) is not None or not sync.log:
                        raise AssertionError("fault domain: the hung kernel-only solve answered")
                    extra = f", kernel-only solve under a hang {time.perf_counter() - t0:.4f} s"
            finally:
                faults.install_device_faults(None)
            storm_s.append(dt)
            fired = [f.kind for _, f in plan.log]
            booked = faults_moved(booked0)
            bad = invalid_bindings(cluster)
            tripped |= any(s != "closed" for s in KERNEL_BOARD.states().values())
            log(f"fault domain storm {kind}: {dt:.4f} s, fired {fired}, booked {booked}, "
                f"{len(result.bound)} bound, {len(result.unschedulable)} unschedulable, "
                f"{bad} invalid bindings, breakers {sorted(KERNEL_BOARD.states().values())}, "
                f"launches {moved_since(ts, launched0)}{extra}")
            if kind not in fired:
                raise AssertionError(f"fault domain: the {kind} fault did not fire")
            if booked.get(FAULT_BOOKED[kind], 0) < 1:
                raise AssertionError(f"fault domain: {kind} was not booked as "
                                     f"{FAULT_BOOKED[kind]}: {booked}")
            if len(result.bound) != n_pods or result.unschedulable or bad:
                raise AssertionError(f"fault domain: the {kind} round bound "
                                     f"{len(result.bound)} of {n_pods} pods, {bad} invalid")
            hold_allocatable(f"fault domain {kind}", cluster)
            if kind == "staging-corruption":
                stage_solver = ctl.solver
        if not tripped:
            raise AssertionError("fault domain: the storm never opened a breaker")

        # the first clean round: on the staging round's solver, whose
        # stager holds the corrupted alloc
        corrupted = resident_alloc(stage_solver)
        wait_breakers_not_open(KERNEL_BOARD)
        launched0 = dict(ts.LAUNCHES)
        cluster, ctl, result, dt = one_round(solver=stage_solver)
        moved = moved_since(ts, launched0)
        healed = resident_alloc(stage_solver)
        problem = interned(stage_solver, result.solve)
        true_alloc = problem.__dict__["_prep_memo"][1][0]["alloc"]
        last = stage_solver._stager.last_round
        log(f"fault domain first clean round: {dt:.4f} s, launches {moved}, stager "
            f"{ {k: last.get(k) for k in ('hit', 'restage', 'full', 'rows')} }, breakers "
            f"{sorted(KERNEL_BOARD.states().values())}")
        hold_pack_launches("fault domain first clean round", moved)
        if not (np.array_equal(corrupted, true_alloc * 4.0) and np.array_equal(healed, true_alloc)):
            raise AssertionError("fault domain: the clean round did not restage alloc")
        if len(result.bound) != n_pods or invalid_bindings(cluster):
            raise AssertionError("fault domain: the first clean round did not bind every pod")
        kernel = stage_solver._solve_kernel(problem)
        if kernel is None or validate(problem, kernel) or kernel.stats.get("backend") != 1.0:
            raise AssertionError("fault domain: the clean round's kernel-only plan is invalid")
        log(f"fault domain first clean round: kernel-only cost {kernel.cost!r}, slots "
            f"{kernel.stats['slots']}")
        rounds = 1
        while KERNEL_BOARD.health() < 1.0:
            if rounds >= 10:
                raise AssertionError(
                    f"fault domain: breakers never closed: {KERNEL_BOARD.states()}")
            wait_breakers_not_open(KERNEL_BOARD)
            one_round()
            rounds += 1
        log(f"fault domain: every breaker closed after {rounds} clean rounds; "
            f"failures {KERNEL_BOARD.failures}")

        on_s, off_s, shares = [], [], []
        for flip in (True, False, False, True) * max(1, FAULT_ABBA_REPEATS // 4):
            _, ctl, result, dt = one_round(validation_on=flip)
            (on_s if flip else off_s).append(dt)
            if flip:
                shares.append(100.0 * ctl._fw_eval_s / dt)
        log(f"fault domain validation ABBA ({len(on_s) + len(off_s)} rounds): round p50 "
            f"{stats_.median(on_s):.4f} s on, {stats_.median(off_s):.4f} s off; the "
            f"firewall's share {stats_.median(shares):.3f}% (median); storm rounds p50 "
            f"{stats_.median(storm_s):.4f} s")
    finally:
        faults.install_device_faults(None)
        KERNEL_BOARD.configure(failure_threshold=3, recovery_timeout_s=30.0)
    launches = moved_since(ts, before_phase)
    log(f"fault domain launches {launches}")
    hold_pack_launches("fault domain", launches)
    return launches


#: the perf-sentinel phase, ``bench_perf_sentinel``'s defaults
SENTINEL_WARM_ROUNDS = 6
SENTINEL_SLOW_ROUNDS = 14
SENTINEL_HANG_S = 0.12
SENTINEL_MAD_K = 3
SENTINEL_DIR = Path(__file__).resolve().parent / "build" / "sentinel"


def perf_sentinel_phase(ts, configs) -> dict:
    """Main path, the perf sentinel: ``bench.bench_perf_sentinel``'s scenario
    at its defaults (``configs.config_perf_sentinel()``: 600 pods, 20 types,
    ``TorchSolver(latency_budget_s=1.0, device="cuda")``, a fresh cluster
    and controller a round). Two unmetered rounds, then the sentinel
    (``profiling.configure``: baselines in a fresh directory, 6 baseline
    rounds, ``mad_k`` 3, a 0.5 s profile window at 97 Hz) over 7 clean
    rounds, which must arm a ``solve`` baseline and trip nothing (the heap
    frozen after the first, as the operator's run loop does); then a
    0.12 s ``dispatch-hang`` on every dispatch: within ``mad_k`` rounds one
    trip must name the ``solve`` phase and a bucket label of the port, and
    the anomaly capsule it dumps must carry ``TRIGGER_PERF_REGRESSION``, a
    collapsed profile whose frames include ``_poll_dispatch`` or
    ``_fetch_bounded``, and replay to a match through ``TorchSolver`` on the
    card. Returns the phase's launches."""
    import gzip
    import re
    import statistics as stats_

    from karpenter_tpu_torch.replay import replay_capsule
    from karpenter_tpu_torch.utils import faults, profiling
    from karpenter_tpu_torch.utils.flightrecorder import (
        FLIGHT,
        TRIGGER_PERF_REGRESSION,
        FlightRecorder,
    )

    make = configs.config_perf_sentinel()
    seq = iter(range(1 << 20))
    before_phase = dict(ts.LAUNCHES)

    def one_round() -> float:
        _, ctl = make(next(seq))
        t0 = time.perf_counter()
        ctl.reconcile()
        return time.perf_counter() - t0

    import gc

    from karpenter_tpu_torch.utils.gctuning import freeze_long_lived

    shutil.rmtree(SENTINEL_DIR, ignore_errors=True)
    SENTINEL_DIR.mkdir(parents=True)
    prev_cap, prev_dump = FLIGHT.capacity, FLIGHT.dump_dir
    threshold = gc.get_threshold()
    faults.install_device_faults(None)
    profiling.PROFILER.stop()
    profiling.PROFILER.reset()
    profiling.SENTINEL.reset()
    try:
        FLIGHT.configure(max(prev_cap, 8), dump_dir=str(SENTINEL_DIR))
        one_round()
        # what the operator's run loop does after its first reconcile: a
        # full collection of the heap the earlier phases left holds the
        # interpreter lock, and a profile window it fills samples nothing
        freeze_long_lived()
        one_round()
        profiling.configure(profiling_enabled=False, sample_hz=97.0,
                            baseline_rounds=SENTINEL_WARM_ROUNDS, sentinel_enabled=True,
                            mad_k=SENTINEL_MAD_K, baseline_dir=str(SENTINEL_DIR),
                            profile_window_s=0.5)
        clean = []
        for _ in range(SENTINEL_WARM_ROUNDS + 1):
            clean.append(one_round())
            profiling.sentinel_tick()
        snap = profiling.SENTINEL.snapshot()
        armed = [k for k, doc in snap["phases"].items()
                 if k.startswith("solve|") and doc["state"] == "armed" and doc["baseline"]]
        false_trips = profiling.SENTINEL.trips_total
        log(f"perf sentinel: clean rounds p50 {stats_.median(clean):.4f} s, armed {armed}, "
            f"baselines {sorted(snap['phases'])}, false trips {false_trips}")
        if not armed or false_trips:
            raise AssertionError(f"perf sentinel: armed {armed}, {false_trips} false trips")
        plan = faults.DeviceFaultPlan().dispatch_hang(seconds=SENTINEL_HANG_S, n=100_000)
        faults.install_device_faults(plan)
        trip, detected, slow = None, None, []
        try:
            for r in range(1, SENTINEL_SLOW_ROUNDS + 1):
                slow.append(one_round())
                fired = profiling.sentinel_tick()
                if trip is None and fired:
                    trip, detected = fired[0], r
                if trip is not None and "capsule" in trip:
                    break
        finally:
            faults.install_device_faults(None)
        log(f"perf sentinel: slow rounds {[round(x, 4) for x in slow]} s, "
            f"{len(plan.log)} hangs fired, trip {trip}, detected in round {detected}; "
            f"profiler {profiling.PROFILER.snapshot()}")
        label = re.compile(r"^g\d+o\d+e\d+s\d+z\d+r\d+k\d+(b\d+)?$")
        if trip is None or detected > SENTINEL_MAD_K or trip["phase"] != "solve" \
                or not label.match(trip["bucket"] or ""):
            raise AssertionError(f"perf sentinel: trip {trip} in round {detected}")
        if "capsule" not in trip:
            raise AssertionError("perf sentinel: the trip's capsule never assembled")
        path = FlightRecorder._dump_path(trip["capsule"], str(SENTINEL_DIR))
        with gzip.open(path, "rt") as fh:
            dumped = json.load(fh)
        profile = dumped.get("outputs", {}).get("profile", [])
        in_fetch = [line for line in profile if "_poll_dispatch" in line
                    or "_fetch_bounded" in line]
        if TRIGGER_PERF_REGRESSION not in dumped.get("anomalies", []) or not in_fetch:
            raise AssertionError(f"perf sentinel: capsule anomalies {dumped.get('anomalies')}, "
                                 f"{len(profile)} profile lines, {len(in_fetch)} in the fetch: "
                                 f"{profile[:20]}")
        t0 = time.perf_counter()
        before = dict(ts.LAUNCHES)
        report = replay_capsule(json.loads(json.dumps(dumped, default=str)), device="cuda")
        log(f"perf sentinel: capsule {trip['capsule']} ({Path(path).stat().st_size} bytes), "
            f"{len(profile)} profile lines, {len(in_fetch)} in the dispatch fetch; replay "
            f"{'MATCH' if report['match'] else 'DIVERGED'} in {time.perf_counter() - t0:.2f} s, "
            f"launches {moved_since(ts, before)}")
        if not report["match"]:
            raise AssertionError(
                f"perf sentinel: the capsule diverged on replay: {report['diffs']}")
    finally:
        faults.install_device_faults(None)
        profiling.PROFILER.stop()
        profiling.PROFILER.reset()
        profiling.SENTINEL.reset()
        profiling.SENTINEL.configure(enabled=False, sentinel_enabled=False, mad_k=3,
                                     baseline_rounds=20, baseline_path=None)
        FLIGHT.configure(prev_cap, dump_dir=prev_dump)
        shutil.rmtree(SENTINEL_DIR, ignore_errors=True)
        gc.unfreeze()
        gc.set_threshold(*threshold)
    launches = moved_since(ts, before_phase)
    log(f"perf sentinel launches {launches}")
    hold_pack_launches("perf sentinel", launches)
    return launches


#: the soak phase: ``SoakConfig``'s default length and seed, at a fixed
#: rate, so that the fault timeline is the seed's and not the host's. The
#: timeline's draws depend on the rate and on ``live_pods`` (the churn
#: draws come first from one ``random.Random(seed)``), and the harness's
#: calibration (``rate_hz=0``) measured 70.0-190.2 events/s on the card's
#: host: each rate drew other bursts (PERF.md, Findings). 70.0 is the lowest
#: rate the card's host calibrated.
SOAK_DURATION_S = 60.0
SOAK_SEED = 11
SOAK_RATE_HZ = 70.0
#: the live population, sized by the load it makes: at 70 events/s the
#: churn draws only scale-ups until the population reaches 80% of it
#: (3,200 pods, ~46 s in), so pods pend at the whole rate, and with the
#: operator's own batch windows (its Settings defaults, upstream's 1 s
#: idle and 10 s max, in place of the harness's 0.1 s and 0.5 s) a round
#: holds ~700 pods, above ``race_min_pods`` (450): every round of the
#: respawned operator races the kernel chain and consults the fault seams.
#: The population then stops growing before the respawned operator's
#: memory window opens (30 s after it is ready), so the RSS budget reads a
#: plateau, not the population's growth (at 6,000 it grew to the end and
#: read 916 KiB/s). At 2,000 live pods and the harness's windows a round
#: held 5-237 pods and only the respawn's first round raced (PERF.md,
#: Findings)
SOAK_LIVE_PODS = 4000
SOAK_BATCH_IDLE_S = 1.0
SOAK_BATCH_MAX_S = 10.0
SOAK_DIR = Path(__file__).resolve().parent / "build" / "soak"
#: the kind the reference books each device fault as (in latency mode a
#: hung dispatch is a missed race and books nothing: ROADMAP.md, Queue 3)
SOAK_BOOKED = {"compile-error": "compile-error", "device-oom": "device-oom",
               "nan-result": "nonfinite-plan", "garbage-result": "invalid-plan",
               "staging-corruption": "invalid-plan", "dispatch-hang": None}
#: a fault that fired this long before a snapshot has been judged: a round
#: books its fault inside its own solve, well inside this
SOAK_SETTLED_S = 2.0

#: what the soak's operator processes run in place of ``python -m
#: karpenter_tpu_torch``: the same entry point, with a thread that writes,
#: every half second and at exit, the process's kernel launch counts
#: (``torch_solver.LAUNCHES``, empty until the entry point has imported the
#: solver after its connectivity check), the device faults its ``DeviceFaultPlan``
#: fired (``log``/``timeline``: site and kind, with the plan's clock), and
#: what it booked on ``karpenter_tpu_kernel_faults_total``, to a file of its
#: own, so that they can be read after the run
SOAK_OPERATOR = """
import json, os, sys, threading, time, runpy, atexit
from karpenter_tpu_torch.utils import faults, metrics
path = os.path.join(os.environ["CHIP_SMOKE_LAUNCH_DIR"], f"launches-{os.getpid()}.json")
lock = threading.Lock()
def dump(final=False):
    ts = sys.modules.get("karpenter_tpu_torch.solver.torch_solver")
    staging = sys.modules.get("karpenter_tpu_torch.solver.staging")
    plan = faults._DEVICE_PLAN
    with metrics.KERNEL_FAULTS._lock:
        booked = {dict(k).get("kind"): v for k, v in metrics.KERNEL_FAULTS._values.items()}
    row = {"launches": dict(getattr(ts, "LAUNCHES", {})),
           "restages": dict(getattr(staging, "RESTAGES", {})), "booked": booked,
           "final": final,
           "fired": [[t, site, f.kind] for t, site, f in list(plan.timeline)] if plan else [],
           "elapsed": plan.elapsed() if plan else 0.0,
           "pending": plan.pending() if plan else 0}
    with lock:
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(row, fh)
        os.replace(tmp, path)
def loop():
    while True:
        time.sleep(0.5)
        dump()
threading.Thread(target=loop, daemon=True).start()
atexit.register(dump, True)
sys.argv[0] = "karpenter_tpu_torch"
runpy.run_module("karpenter_tpu_torch", run_name="__main__", alter_sys=True)
"""


@contextlib.contextmanager
def counted_operators(launch_dir: Path):
    """Run the soak harness's operator processes through ``SOAK_OPERATOR``."""
    import os

    from karpenter_tpu_torch.soak import harness

    popen = harness.subprocess.Popen

    def wrapped(args, *a, **kw):
        if list(args[1:3]) == ["-m", "karpenter_tpu_torch"]:
            args = [args[0], "-c", SOAK_OPERATOR] + list(args[3:])
            env = dict(kw.get("env") or os.environ)
            env.pop("KARPENTER_TPU_COMPILE_CACHE_DIR", None)
            kw["env"] = dict(env, **child_env(CHIP_SMOKE_LAUNCH_DIR=str(launch_dir)))
        return popen(args, *a, **kw)

    harness.subprocess.Popen = wrapped
    try:
        yield
    finally:
        harness.subprocess.Popen = popen


@contextlib.contextmanager
def operator_series(seen: dict):
    """While the monitor samples the operator's ``/metrics``, also keep the
    kernel fault counts (the largest a process showed, by its start time)
    and the kernel breaker series it serves, read from the rows of the
    monitor's own scrape (a second scrape would cost the operator another
    exposition a sample)."""
    from karpenter_tpu_torch.soak import monitor

    parse = monitor.parse_metrics

    def teed(text):
        rows = parse(text)
        start = next((v for n, _, v in rows
                      if n == "karpenter_tpu_process_start_time_seconds"), None)
        for name, labels, value in rows:
            if name == "karpenter_tpu_kernel_faults_total":
                key = (start, labels.get("kind"))
                seen["faults"][key] = max(seen["faults"].get(key, 0.0), value)
            elif (name == "karpenter_tpu_rpc_breaker_state"
                  and labels.get("service") == "kernel"):
                seen["breakers"].add((labels.get("endpoint"), labels.get("state"), value))
        return rows

    monitor.parse_metrics = teed
    try:
        yield
    finally:
        monitor.parse_metrics = parse


def soak_bursts(script) -> str:
    """The timeline's device-fault and rpc bursts, for one log line."""
    dev = [(round(e.t, 2), e.get("fault_kind"), int(e.get("n", 1))) for e in script.events
           if e.kind == "device-fault-burst"]
    rpc = [(round(e.t, 2), e.get("endpoint"), int(e.get("n", 2)), int(e.get("status", 503)))
           for e in script.events if e.kind == "rpc-fault-burst"]
    kills = [(round(e.t, 2), e.get("signal")) for e in script.events
             if e.kind == "operator-restart"]
    return f"device-fault bursts {dev}; rpc bursts {rpc}; operator restarts {kills}"


def soak_faults(rows) -> tuple:
    """Per operator process (its ``SOAK_OPERATOR`` file): the faults its
    plan fired, by kind (those fired ``SOAK_SETTLED_S`` before its last
    snapshot, or all of them at a clean exit), and what it booked. Returns
    (fired by kind, booked by kind, the processes whose bookings fall short
    of their fired faults under the reference's kinds)."""
    fired_all, booked_all, short = {}, {}, []
    for pid, row in rows:
        fired = {}
        for t, _site, kind in row.get("fired", []):
            if row.get("final") or t <= row.get("elapsed", 0.0) - SOAK_SETTLED_S:
                fired[kind] = fired.get(kind, 0) + 1
        want = {}
        for kind, n in fired.items():
            booked_as = SOAK_BOOKED.get(kind, kind)
            if booked_as is not None:
                want[booked_as] = want.get(booked_as, 0) + n
        booked = {k: v for k, v in row.get("booked", {}).items() if v}
        if any(booked.get(k, 0.0) < n for k, n in want.items()):
            short.append((pid, fired, booked))
        for kind, n in fired.items():
            fired_all[kind] = fired_all.get(kind, 0) + n
        for kind, v in booked.items():
            booked_all[kind] = booked_all.get(kind, 0.0) + v
    return fired_all, booked_all, short


def soak_phase(ts) -> dict:
    """Main path, the chaos soak: ``run_soak`` from the harness's own code
    (``karpenter_tpu_torch.soak``) for ``SOAK_DURATION_S`` of churn, seed
    ``SOAK_SEED`` at the fixed ``SOAK_RATE_HZ`` (logging what the harness's
    calibration would have chosen), ``SOAK_LIVE_PODS`` live pods, the
    operator's own batch windows, the API server and the cloud in this
    process over real HTTP, the operator ``python -m karpenter_tpu_torch
    --device cuda`` in a subprocess on the card, SIGKILLed and respawned
    once (and respawned again should it exit at boot), the API server
    restarted once, the timeline's device-fault bursts in the operator's
    ``device_fault_script``. The report must show no violation, its replay
    section present with every dumped capsule matched (replayed here, on
    the card), no client token committed twice and no orphan; the
    operators must have fired at least one device fault, and every fault
    they fired must be booked on their ``karpenter_tpu_kernel_faults_total``
    under the kind the reference books it as; their ``/metrics`` must have
    shown the kernel breaker's series. Logs the timeline's bursts, the
    rate, events/s, pod-ready p99, the RSS slope, the capsules replayed and
    the faults fired and booked by kind. Returns the launches of the
    operator processes (read from ``SOAK_OPERATOR``'s files) and of the
    replays."""
    from karpenter_tpu_torch.soak import SoakConfig, run_soak
    from karpenter_tpu_torch.soak.churn import ChurnScript
    from karpenter_tpu_torch.soak.harness import calibrate_rate

    shutil.rmtree(SOAK_DIR, ignore_errors=True)
    (SOAK_DIR / "launches").mkdir(parents=True)
    t0 = time.perf_counter()
    would = calibrate_rate(SoakConfig.rate_target_hz)
    cfg = SoakConfig(duration_s=SOAK_DURATION_S, rate_hz=SOAK_RATE_HZ, seed=SOAK_SEED,
                     live_pods=SOAK_LIVE_PODS, batch_idle_s=SOAK_BATCH_IDLE_S,
                     batch_max_s=SOAK_BATCH_MAX_S, device="cuda",
                     dump_dir=str(SOAK_DIR / "dump"))
    cfg.script = ChurnScript.generate(
        seed=cfg.seed, duration_s=cfg.duration_s, rate_hz=cfg.rate_hz,
        live_pods=cfg.live_pods, operator_restarts=cfg.operator_restarts,
        apiserver_restarts=cfg.apiserver_restarts)
    log(f"soak: rate {SOAK_RATE_HZ} events/s fixed (the harness's calibration would have "
        f"chosen {would:.1f} in {time.perf_counter() - t0:.2f} s), seed {SOAK_SEED}, "
        f"{SOAK_LIVE_PODS} live pods, batch windows {SOAK_BATCH_IDLE_S}/{SOAK_BATCH_MAX_S} s; "
        f"{soak_bursts(cfg.script)}")
    seen = {"faults": {}, "breakers": set()}
    before = dict(ts.LAUNCHES)
    t0 = time.perf_counter()
    with counted_operators(SOAK_DIR / "launches"), operator_series(seen):
        report = run_soak(cfg)
    wall = time.perf_counter() - t0
    here = moved_since(ts, before)
    launches = dict(here)
    # the operator processes' stage_patch launches, restaging calls and
    # copies (this process's are held by ``phase``), held where a process
    # wrote its counts at its exit: a process killed by the churn leaves a
    # sample taken at any moment, maybe between a copy and its launch
    restaged = {"launches": 0, "calls": 0, "copies": 0}
    rows = []
    for path in sorted((SOAK_DIR / "launches").glob("launches-*.json")):
        row = json.loads(path.read_text())
        rows.append((path.stem.split("-")[-1], row))
        for k, v in row["launches"].items():
            launches[k] = launches.get(k, 0) + v
        if row["final"]:
            restaged["launches"] += row["launches"].get("stage_patch", 0)
            for k, v in row["restages"].items():
                restaged[k] += v
    log(f"soak: stage_patch in the operator processes that exited {restaged['launches']} launches, "
        f"{restaged['calls']} restaging calls, {restaged['copies']} copies")
    if not restaged["launches"] == restaged["calls"] == restaged["copies"]:
        raise AssertionError(f"soak: stage_patch launches, restaging calls and copies differ in "
                             f"the operator processes: {restaged}")
    fired, booked, short = soak_faults(rows)
    replay = report.get("replay") or {}
    all_matched = (replay.get("found") is not None and not replay.get("mismatched")
                   and not replay.get("errors"))
    scraped = {}
    for (_, kind), value in seen["faults"].items():
        scraped[kind] = scraped.get(kind, 0.0) + value
    log(f"soak: wall {wall:.2f} s, churn {report['duration_s']} s at rate {report['rate_hz']} "
        f"(target {report['rate_target_hz']}), {report['events_total']} events, "
        f"{report['events_per_s']} events/s, pod-ready p50 {report['pod_ready_p50_s']} s p99 "
        f"{report['pod_ready_p99_s']} s over {report['pod_ready_samples']} pods, loop lag max "
        f"{report['loop_lag_max_s']} s, RSS slope {report['mem_slope_bytes_per_s']} B/s over "
        f"{report['mem_segments']} segments, {report['operator_incarnations']} incarnations, "
        f"restarts {report['restarts']}, boots {report['operator_boot_s']} s, dominant stage "
        f"{report['dominant_stage']}, stage totals {report['stage_totals_s']} s")
    log(f"soak: events {report['events_by_kind']}, op failures {report['op_failures']}, "
        f"launch audit {report['launch_audit']}, perf {report['perf']}")
    log(f"soak: device faults fired {fired}, booked {booked} (the operators' /metrics showed "
        f"{scraped}); per process "
        f"{[(pid, row.get('fired'), row.get('booked'), row.get('pending')) for pid, row in rows]}")
    log(f"soak: capsules {replay}, all matched {all_matched}; kernel breaker series "
        f"{sorted(seen['breakers'], key=str)[:6]}; launches {launches} ({len(rows)} operator "
        f"processes; replays here {here})")
    if report["violations"]:
        raise AssertionError(
            f"soak: violations {report['violations']}; restarts {report['restarts']}, boots "
            f"{report['operator_boot_s']} s, loop lag max {report['loop_lag_max_s']} s, pod-ready "
            f"p50 {report['pod_ready_p50_s']} s, stage totals {report['stage_totals_s']} s "
            f"over {report['stage_counts']}")
    if not all_matched:
        raise AssertionError(f"soak: replay {replay}")
    if report["duplicate_tokens"] or report["orphan_instances"]:
        raise AssertionError(f"soak: duplicate tokens {report['duplicate_tokens']}, orphans "
                             f"{report['orphan_instances']}")
    if not fired or short or not seen["breakers"]:
        raise AssertionError(f"soak: device faults fired {fired}, booked {booked}, processes "
                             f"booking fewer than they fired {short}, kernel breakers "
                             f"{seen['breakers']}")
    shutil.rmtree(SOAK_DIR, ignore_errors=True)
    hold_pack_launches("soak", launches)
    return launches


#: the federation phase: (a) ``bench.bench_federation_storm``'s fleet at
#: its parameters (``configs.federation_storm``); (b) two operators on the
#: card federated over HTTP through an in-process ``ArbiterHTTPServer``
FED_DIR = Path(__file__).resolve().parent / "build" / "federation"
#: (b): each region's seed (pods, of which region-affine lone pods: one
#: lease each), the partitioned region's round and the healed step's
FED_SEED = {"region-a": (10_000, 2_000), "region-b": (2_000, 500)}
FED_PARTITION_PODS = 1_000
FED_HEAL_PODS = 500
FED_TYPES = 400
#: the arbiter's staleness window, and the client breakers' recovery (the
#: reference's default), both on the wall clock
FED_STALE_S = 4.0
FED_RECOVERY_S = 10.0


def federation_storm_part() -> dict:
    """(a) ``configs.federation_storm``: three regions on ``GreedySolver``
    (the reference's harness is host-only; it runs no kernel) under
    ``federation_storm_script``. It must show no unschedulable pod at any
    round end, the lost region's gangs re-entered whole, a mean cost within
    1.5x of the single-cluster oracle, no launch audit violation and every
    federation capsule replayed with ``match``; then the newest capsule
    with sub-capsules through ``python -m karpenter_tpu_torch.replay`` must
    exit 0."""
    from karpenter_tpu_torch import configs
    from karpenter_tpu_torch.utils.flightrecorder import FLIGHT

    prev = (FLIGHT.capacity, FLIGHT.dump_dir)
    t0 = time.perf_counter()
    try:
        report, fleet = configs.federation_storm(device="cuda")
        storm_s = time.perf_counter() - t0
        log(f"federation storm: {report}")
        log(f"federation storm: round costs {[round(c, 4) for c in fleet.costs]} $/h, verdict "
            f"digests {[c['outputs']['verdict']['digest'][:12] for c in fleet.capsules]}, "
            f"failed-over gangs {fleet.failover_gangs}, capsules in the ring "
            f"{sum(1 for c in FLIGHT.list() if c['controller'] == 'federation')}")
        bad = [k for k in ("fed_zero_unschedulable", "fed_gangs_reentered_whole",
                           "within_cost_band", "fed_replay_all_matched") if not report[k]]
        if bad or report["audit_violations"] or not report["gangs_failed_over"]:
            raise AssertionError(f"federation storm: {bad}, report {report}")
        capsule = [c for c in fleet.capsules if c["sub_capsules"]][-1]
        shutil.rmtree(FED_DIR, ignore_errors=True)
        path = FLIGHT.dump(capsule["id"], str(FED_DIR))
        t1 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "karpenter_tpu_torch.replay", path],
                             cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                             timeout=REPLAY_CLI_S)
        summary = "\n".join(out.stdout.strip().splitlines()[:14])
        log(f"federation storm: replay CLI on {capsule['id']} (epoch {capsule['epoch']}, "
            f"{len(capsule['sub_capsules'])} sub-capsules; {Path(path).stat().st_size} bytes): "
            f"exit {out.returncode} in {time.perf_counter() - t1:.2f} s:\n{summary}")
        if out.returncode != 0 or "(federation): MATCH" not in out.stdout:
            raise AssertionError(f"federation storm: replay CLI exit {out.returncode}\n"
                                 f"{out.stderr[-3000:]}")
        log(f"federation part (a) federation_storm: wall {time.perf_counter() - t0:.2f} s (the "
            f"storm {storm_s:.2f} s, the replay CLI {time.perf_counter() - t1:.2f} s)")
    finally:
        FLIGHT.configure(prev[0], dump_dir=prev[1])
        shutil.rmtree(FED_DIR, ignore_errors=True)
    return report


class CountingTransport:
    """An operator's arbiter transport: the HTTP one, counted by route, with
    a partition switch that fails every call as a dead network would."""

    def __init__(self, inner):
        self.inner = inner
        self.partitioned = False
        self.calls = {}

    def __call__(self, route, body):
        self.calls[route] = self.calls.get(route, 0) + 1
        if self.partitioned:
            raise ConnectionError(f"arbiter {route}: partitioned")
        return self.inner(route, body)


def federated_region(name: str, endpoint: str, device: str = "cuda"):
    """One region: an in-process cluster, a fake cloud over
    ``generate_catalog(FED_TYPES)`` with 2^20 IPs a zone, and ``Operator.new``
    with ``federation_enabled`` against ``endpoint`` on ``device``."""
    from karpenter_tpu_torch.api import ObjectMeta, Provisioner
    from karpenter_tpu_torch.api.settings import Settings
    from karpenter_tpu_torch.cloudprovider import FakeCloudProvider, generate_catalog
    from karpenter_tpu_torch.operator import Operator
    from karpenter_tpu_torch.state import Cluster

    provider = FakeCloudProvider(catalog=generate_catalog(n_types=FED_TYPES))
    for subnet in provider.subnets:
        subnet.available_ips = 1 << 20
    settings = Settings(cluster_name=name, federation_enabled=True, arbiter_endpoint=endpoint,
                        batch_idle_duration=0, batch_max_duration=0,
                        consolidation_validation_ttl=0)
    op = Operator.new(provider=provider, settings=settings, cluster=Cluster(), device=device)
    op.cluster.add_provisioner(Provisioner(meta=ObjectMeta(name="default")))
    op.federation.transport = CountingTransport(op.federation.transport)
    return op


def federated_pods(op, prefix: str, n: int, affine: int) -> None:
    """``n`` pods of ``configs.CELL_CPUS``/``CELL_MEMS`` shapes, the first
    ``affine`` of them region-affine (``karpenter.tpu/region-affinity: *``,
    one lease each)."""
    from karpenter_tpu_torch import configs
    from karpenter_tpu_torch.api import ObjectMeta, Pod, Resources
    from karpenter_tpu_torch.api import labels as wk

    for i in range(n):
        ann = {wk.REGION_AFFINITY: "*"} if i < affine else {}
        op.cluster.add_pod(Pod(
            meta=ObjectMeta(name=f"{prefix}-{i}", annotations=ann, owner_kind="ReplicaSet"),
            requests=Resources(cpu=configs.CELL_CPUS[i % 4], memory=configs.CELL_MEMS[i % 4])))


def federated_step(ts, name, op, arbiter, units: int) -> dict:
    """One operator step inside one arbiter round: the region's summary,
    the step (the gate's leases over HTTP, then the round on the card), the
    pure verdict over the round's recorded inputs held against every live
    answer and every degraded decision, and the chain's launches."""
    from karpenter_tpu_torch.federation.arbiter import arbiter_verdict

    fed, transport = op.federation, op.federation.transport
    calls = dict(transport.calls)
    fed.push_summary(launch_headroom=100_000)
    arbiter.begin_round()
    pending = len(op.cluster.pending_pods())
    existing = len(op.cluster.nodes)
    solves = []
    solve_pods = op.provisioning.solver.solve_pods

    def recorded(*a, **kw):
        result = solve_pods(*a, **kw)
        solves.append(result)
        return result

    op.provisioning.solver.solve_pods = recorded
    before = dict(ts.LAUNCHES)
    t0 = time.perf_counter()
    try:
        op.step()
    finally:
        op.provisioning.solver.solve_pods = solve_pods
    wall = time.perf_counter() - t0
    launches = moved_since(ts, before)
    degraded = fed.drain_degraded_log()
    inputs, verdict = arbiter.round_capsule_parts(degraded)
    live = list(arbiter._round_assignments)
    pure = arbiter_verdict(json.loads(json.dumps(inputs)))
    if pure["digest"] != verdict["digest"] or len(pure["assignments"]) != len(live) + len(
            degraded):
        raise AssertionError(f"federation {name}: the pure verdict differs from the round's")
    for got, want in zip(pure["assignments"], live + [None] * len(degraded)):
        if want is not None and (got["token"], got["outcome"], got["target"]) != (
                want["token"], want["outcome"], want["target"]):
            raise AssertionError(f"federation {name}: unit {got['token']}: pure {got}, live {want}")
        if want is None and got["outcome"] != "degraded-local":
            raise AssertionError(f"federation {name}: degraded unit {got}")
    if len(live) + len(degraded) != units:
        raise AssertionError(f"federation {name}: {len(live)} leased + {len(degraded)} degraded "
                             f"units, not {units}")
    made = {k: transport.calls.get(k, 0) - calls.get(k, 0) for k in transport.calls}
    bound = sum(1 for p in op.cluster.pods.values() if p.node_name is not None)
    stats = solves[0].stats if solves else {}
    hold_allocatable(f"federation {name}", op.cluster)
    if op.cluster.pending_pods():
        raise AssertionError(f"federation {name}: {len(op.cluster.pending_pods())} pods pending")
    if launches["shared_precompute"] < 1 or launches["pack_member"] < 2 or \
            launches["pack_epilogue"] < 1:
        raise AssertionError(f"federation {name}: the round did not launch K1, K2 twice and "
                             f"K3: {launches}")
    targets = {}
    for a in live:
        targets[a["target"]] = targets.get(a["target"], 0) + 1
    log(f"federation {name} ({fed.cluster_name}): {pending} pods at E={existing}, step "
        f"{wall:.4f} s; {sum(made.values())} HTTP calls {made}; {len(live)} leases "
        f"{sorted(set(a['outcome'] for a in live))} targets {targets}, {len(degraded)} degraded, "
        f"epoch {arbiter.epoch}, mode {fed.mode}; the pure verdict agrees on every unit; "
        f"backend {stats.get('backend')}, race_winner {stats.get('race_winner')}, cost "
        f"{solves[0].cost if solves else None}; {len(op.cluster.nodes)} nodes, {bound} bound; "
        f"launches {launches}")
    return dict(wall=round(wall, 4), launches=launches, degraded=len(degraded),
                leases=len(live))


def federated_operators_part(ts) -> dict:
    """(b) An ``ArbiterHTTPServer`` in this process and two
    ``Operator.new(device="cuda")`` regions federated over HTTP: a seed of
    ``FED_SEED`` pods in each, region-affine units routed by leases; a
    partition of region-a's arbiter link (its lease breaker opens, it runs
    a degraded local round, the degraded log fills, the arbiter's sweep
    declares it lost: an epoch); a heal (the breakers recover after
    ``FED_RECOVERY_S``, region-a's summary rejoins it: another epoch, and a
    lease minted before the heal is fenced); then a round on region-b at
    the new epoch. Every step's pure verdict agrees with the live one on
    every unit, and each region's every round launches K1, K2 twice and
    K3. Returns the launches."""
    from karpenter_tpu_torch.federation.arbiter import FederationArbiter
    from karpenter_tpu_torch.federation.server import ArbiterHTTPServer

    t0 = time.perf_counter()
    arbiter = FederationArbiter(summary_stale_s=FED_STALE_S)
    server = ArbiterHTTPServer(arbiter, port=0).start()
    ops = {}
    steps = {}
    try:
        for name in FED_SEED:
            ops[name] = federated_region(name, server.endpoint)
        a, b = ops["region-a"], ops["region-b"]
        for name, (n, affine) in FED_SEED.items():
            federated_pods(ops[name], f"{name}-seed", n, affine)
            steps[f"seed {name}"] = federated_step(ts, f"seed {name}", ops[name], arbiter, affine)
        old_token = next(t for t in sorted(a.federation.leases))
        a.federation.transport.partitioned = True
        federated_pods(a, "region-a-cut", FED_PARTITION_PODS, FED_PARTITION_PODS)
        steps["partition"] = federated_step(ts, "partition region-a", a, arbiter,
                                            FED_PARTITION_PODS)
        status = a.federation.status()
        if status["mode"] != "degraded" or status["breakers"]["POST /v1/lease"] != "open" or \
                steps["partition"]["degraded"] != FED_PARTITION_PODS:
            raise AssertionError(f"federation partition: {status}")
        t1 = time.perf_counter()
        epoch0 = arbiter.epoch
        lost = []
        while time.perf_counter() - t1 < FED_RECOVERY_S + 0.5 or not lost:
            b.federation.push_summary(launch_headroom=100_000)  # region-b keeps talking
            lost += arbiter.sweep_lost()
            if time.perf_counter() - t1 > 60.0:
                raise AssertionError("federation partition: the sweep never declared region-a lost")
            time.sleep(0.5)
        a.federation.transport.partitioned = False
        accepted = a.federation.push_summary(launch_headroom=100_000)
        fenced = a.federation.confirm(old_token)
        log(f"federation partition: degraded log {steps['partition']['degraded']} entries, "
            f"breakers {status['breakers']}, last error {status['last_error']}; swept lost "
            f"{lost} (epoch {epoch0} -> {arbiter.epoch - 1}); heal after "
            f"{time.perf_counter() - t1:.2f} s: region-a's summary accepted {accepted}, mode "
            f"{a.federation.mode}, epoch {arbiter.epoch}; the lease {old_token} minted before "
            f"the heal confirmed {fenced}")
        if lost != ["region-a"] or not accepted or fenced or a.federation.mode != "federated" \
                or arbiter.epoch != epoch0 + 2:
            raise AssertionError("federation heal: the epoch fence did not hold")
        federated_pods(b, "region-b-heal", FED_HEAL_PODS, FED_HEAL_PODS)
        steps["heal"] = federated_step(ts, "heal region-b", b, arbiter, FED_HEAL_PODS)
    finally:
        for op in ops.values():
            op.close()
        server.stop()
    launches = {k: sum(s["launches"][k] for s in steps.values()) for k in ts.LAUNCHES}
    log(f"federation part (b) federated_operators: wall {time.perf_counter() - t0:.2f} s, "
        f"steps {{{', '.join(f'{k!r}: {v['wall']}' for k, v in steps.items())}}}, launches "
        f"{launches}")
    return launches


def federation_phase(ts) -> dict:
    """Main path, federation: part (a) on the host (``federation_storm_part``)
    and part (b) on the card (``federated_operators_part``). Returns the
    launches of (b)."""
    federation_storm_part()
    launches = federated_operators_part(ts)
    hold_pack_launches("federation", launches)
    log(f"federation launches {launches}")
    return launches


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


def compare_staging(ts, other: Path) -> None:
    """This tree's staging kernels against those of the checkout at
    ``other``, in one process on one card, in turns other, this, this,
    other: ``fleet_stack`` of one B=16 chunk of the 500k-pod fleet, and one
    churned cell's restage as each tree's stager makes it (``other``'s
    wrapper for each leaf, its index set padded to a power of two, after
    two pageable uploads; this tree's ``stage_patches``). Each turn times
    the card behind a spin and the host per call; both trees must give the
    same bytes. The other tree's ``staging.py`` runs against this tree's
    modules, with its own kernel library."""
    import importlib.util

    import numpy as np
    import torch

    from karpenter_tpu_torch import configs
    from karpenter_tpu_torch.solver import _build
    from karpenter_tpu_torch.solver import staging as st

    _, other_lib = load_tree(other, "other")
    spec = importlib.util.spec_from_file_location(
        "karpenter_tpu_torch.solver._other_staging",
        other / "karpenter_tpu_torch" / "solver" / "staging.py")
    other_st = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other_st)
    lib = _build.load_kernels()
    cells, provs, catalog = configs.config_cells()
    solver, problems, key, real, _ = fleet_rows(ts, configs, cells, provs, catalog)
    rows16 = [leaf_rows(real[i % len(real)]) for i in range(16)]
    patches, new = cell_patches(solver, problems)
    batch = [(dst, idx, src) for _, dst, idx, src in patches]
    dev = batch[0][0].device

    def other_restage():
        for dst, idx, src in batch:
            width = 1 << (len(idx) - 1).bit_length()
            padded = np.concatenate([idx, np.full(width - len(idx), idx[0], np.int64)])
            other_st._launch_stage_patch(
                other_lib, dst, torch.from_numpy(padded).to(dev, copy=True),
                torch.from_numpy(np.ascontiguousarray(src[np.searchsorted(idx, padded)])).to(dev, copy=True),
                ts._stream())

    sides = {
        "other": {"fleet_stack": lambda: other_st._launch_fleet_stack(other_lib, rows16, ts._stream()),
                  "restage": other_restage},
        "this": {"fleet_stack": lambda: st._launch_fleet_stack(lib, rows16, ts._stream()),
                 "restage": lambda: st._launch_stage_patches(lib, batch, ts._stream())},
    }
    stacks = {side: fns["fleet_stack"]() for side, fns in sides.items()}
    for name, want in st.fleet_stack_ref(rows16).items():
        if not all(torch.equal(stacks[side][name], want) for side in sides):
            raise AssertionError(f"compare: fleet_stack {name} differs from torch.stack")
    resident = [dst.clone() for dst, _, _ in batch]
    for side, fns in sides.items():
        for (dst, _, _), was in zip(batch, resident):
            dst.copy_(was)
        fns["restage"]()
        for name, dst, _, _ in patches:
            if not torch.equal(dst.cpu(), torch.from_numpy(new[name])):
                raise AssertionError(f"compare: {side}'s restage left {name} unlike the new leaf")
    results = {}
    for turn, side in enumerate(("other", "this", "this", "other")):
        t = {}
        for what, fn in sides[side].items():
            t[f"{what} card"] = time_ms(fn)
            t[f"{what} host"] = host_ms(fn)
        results.setdefault(side, []).append(t)
        log(f"compare staging turn {turn} {side}: " + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))
    # where this tree's restage spends its host time, step by step
    offs, total = st.patch_layout(batch)
    packed = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    st.pack_patches(batch, st.patch_layout(batch)[0], packed.numpy())
    buf = packed.to(dev)
    table = np.array([[dst.data_ptr(), buf.data_ptr() + io, buf.data_ptr() + so, idx.shape[0],
                       st._row_bytes(dst)] for (dst, idx, _), (io, so) in zip(batch, offs)], np.int64)
    steps = {
        "layout and pack": lambda: st.pack_patches(batch, st.patch_layout(batch)[0], packed.numpy()),
        "pinned buffer": lambda: torch.empty(total, dtype=torch.uint8, pin_memory=True),
        "copy to the card": lambda: packed.to(dev, non_blocking=True),
        "launch": lambda: st._run_stage_patch(lib, table, ts._stream()),
    }
    log("compare staging: this tree's restage, host ms a step: " + ", ".join(
        f"{k} {host_ms(fn):.4f}" for k, fn in steps.items()))
    keys = results["this"][0].keys()
    mean = {side: {k: statistics.mean(t[k] for t in turns) for k in keys}
            for side, turns in results.items()}
    log(f"compare staging, ms (mean of two turns; this / other; fleet_stack B=16 "
        f"{len(rows16[0])} leaves, restage of {[(p[0], len(p[2])) for p in patches]}): "
        + "; ".join(f"{k} {mean['this'][k]:.4f} / {mean['other'][k]:.4f}" for k in keys))


def load_meshed(other: Path, lib):
    """The checkout at ``other``'s ``solver/meshed.py``, run against this
    tree's modules, its wrappers launching the kernels of ``lib`` (that
    checkout's library); the un-meshed K1, K2 and K3 its chains call are
    this tree's."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "karpenter_tpu_torch.solver._other_meshed", other / "karpenter_tpu_torch" / "solver" / "meshed.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._lib = lambda: lib
    return mod


def k1_ptxas(root: Path) -> dict:
    """The registers, stack and spill bytes that ptxas reported for each
    ``k1_val_pair`` kernel in the newest ``build/kernels/*/ptxas.log`` of
    the checkout at ``root``: {mangled name: "N registers, S stack, W/R
    spill"}."""
    logs = sorted((root / "build" / "kernels").glob("*/ptxas.log"), key=lambda q: q.stat().st_mtime)
    if not logs:
        return {}
    out, name = {}, None
    for line in logs[-1].read_text().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", line)
        if m:
            name = m.group(1)
        if name is None or "k1_val_pair" not in name:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name] = f"{m.group(1)} stack, {m.group(2)}/{m.group(3)} spill"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name] = f"{m.group(1)} registers, " + out.get(name, "")
    return out


def compare_mesh(ts, other: Path) -> None:
    """This tree's meshed K1 finish and member argmin against those of the
    checkout at ``other``, in one process on one card, at 50k_full (S at
    its solve's slot budget), in turns other, this, this, other: each
    kernel behind a spin and the host time of its call (the finish on the
    first of 2 option shards; the argmin's kernels on the 1D mesh's 4
    shards), the un-meshed K1 behind a spin, and the 1D 2/4 and 2D 2x1/4x1
    chains between events (the median of 5 calls after a warm one). Every
    chain of both trees must equal the un-meshed chain, and both trees' K1
    must give the same bytes. Then a profiler trace of each tree's 1D
    4-shard chain split into kernels, copies and idle, K2's phase 1 as four
    concurrent launches (``k2_concurrency``), and each tree's ptxas report
    of its ``k1_val_pair`` instances (``k1_ptxas``)."""
    import torch

    from karpenter_tpu_torch import configs
    from karpenter_tpu_torch.solver import TorchSolver, _build, encode, meshed

    other_ts, other_lib = load_tree(other, "other")
    lib = _build.load_kernels()
    mods = {"other": load_meshed(other, other_lib), "this": meshed}
    member_argmin_nan_check(meshed)
    solver = TorchSolver()
    problem = encode(*configs.config_50k_full())
    _, orders, _, _, _, swaps, s_new, nz = solver._prepare(problem)
    tensors = device_problem(ts, solver, problem)
    _, S, _ = solver._run_fused(tensors, orders, swaps, s_new, nz)
    inputs, o, a, l, r, sw = tensors
    G, O, E, R, Z = ts._dims(inputs)
    want = ts.pack_solve_fused(*tensors, S, nz)
    k1s = {"other": lambda: other_ts._launch_shared_precompute(other_lib, inputs, S, ts._stream()),
           "this": lambda: ts._launch_shared_precompute(lib, inputs, S, ts._stream())}
    got = {side: k1() for side, k1 in k1s.items()}
    for f in ("units", "units_rsv", "rsv_group", "lam", "zone_limited", "val_pair", "exok_pad", "is_new"):
        if not torch.equal(getattr(got["this"], f), getattr(got["other"], f)):
            raise AssertionError(f"compare mesh: the two trees' un-meshed K1 differ in {f}")
    chains = {}
    for kind, shape in MESH_KERNEL_MESHES:
        mesh = logical_mesh(kind, shape)
        placed = mesh_place(kind, mesh, tensors)
        chains[f"{kind} {shape}"] = (mesh, placed)
        for side, mod in mods.items():
            if not torch.equal(mod.solve_meshed(mesh, *placed, S, nz), want):
                raise AssertionError(f"compare mesh {kind} {shape}: {side}'s chain differs from the "
                                     f"un-meshed chain")
    # the finish on the first of 2 option shards, each tree's own way
    mesh2 = logical_mesh("2d", (2, 1))
    placed2 = mesh_place("2d", mesh2, (inputs,))[0]
    ins = [ts._unsqueeze(type(inputs)(*(p.shards[i] for p in placed2))) for i in range(2)]
    nt = meshed.k1_tiles(ins[0].price.shape[-1], MESH_DEVICE)
    stacked = torch.empty((2, 2, 1, G, nt), dtype=torch.int32, device=MESH_DEVICE)
    sp = [meshed.shard_precompute_part(x, S, stacked[i]) for i, x in enumerate(ins)][0]
    # the argmin's kernels on the 1D mesh's 4 shards: this tree's two, the
    # other's three (offer, pick, final) on the same members
    calls = argmin_calls(meshed, o, a, l, r, sw, 4, S, E)
    kl = o.shape[0] // 4
    member = lambda t, s: t[s * kl:(s + 1) * kl].unsqueeze(0).contiguous()  # noqa: E731
    cost, offers = torch.rand((1, kl), device=MESH_DEVICE), torch.zeros((4, 1, 5 + G), dtype=torch.int32,
                                                                       device=MESH_DEVICE)
    ol, al, ll, rl, swl = (member(t, 0) for t in (o, a, l, r, sw))
    gathered = torch.zeros((4, 1, 4 + 4 * kl + 2 * S + G * (E + S)), dtype=torch.int32, device=MESH_DEVICE)
    b1 = torch.zeros((1, 1), dtype=torch.int32, device=MESH_DEVICE)
    om = mods["other"]
    kernels = {
        "other": {"finish": lambda: om.shard_precompute_finish(ins[0], sp, stacked),
                  "offer": lambda: om.seed_offer(cost, 0, ol, al, ll, rl, offers[0]),
                  "pick": lambda: om.seed_pick(offers, swl),
                  "final": lambda: om.final_pick(gathered, b1, kl)},
        "this": {"finish": lambda: meshed.shard_precompute_finish(ins[0], sp, list(stacked)), **calls},
    }
    results = {}
    for turn, side in enumerate(("other", "this", "this", "other")):
        t = {"k1 card": time_ms(k1s[side])}
        for what, fn in kernels[side].items():
            t[f"{what} card"] = time_ms(fn)
            t[f"{what} host"] = host_ms(fn)
        for name, (mesh, placed) in chains.items():
            t[f"{name} chain"] = event_ms(lambda: mods[side].solve_meshed(mesh, *placed, S, nz), reps=5)[0]
        results.setdefault(side, []).append(t)
        log(f"compare mesh turn {turn} {side}: " + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))
    log("compare mesh, ms (mean of two turns; this / other): " + "; ".join(
        f"{k} {statistics.mean(t[k] for t in results['this']):.4f} / "
        f"{statistics.mean(t[k] for t in results['other']):.4f}"
        for k in results["this"][0] if k in results["other"][0]))
    t0 = time.perf_counter()
    for side in ("other", "this"):
        mesh, placed = chains["1d 4"]
        log(f"compare mesh {side}: 1d 4 trace, ms a chain: "
            f"{chain_trace_split(lambda: mods[side].solve_meshed(mesh, *placed, S, nz))}")
    k2_concurrency(ts, tensors, S, nz)
    log(f"compare mesh: the two traces and k2_concurrency took {time.perf_counter() - t0:.2f} s")
    for side, root in (("other", other), ("this", Path(__file__).resolve().parent)):
        log(f"compare mesh {side}: k1_val_pair's registers and spills: {k1_ptxas(root)}")


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

        if "--staging" in sys.argv[3:]:
            compare_staging(ts, Path(sys.argv[2]).resolve())
        elif "--mesh" in sys.argv[3:]:
            compare_mesh(ts, Path(sys.argv[2]).resolve())
        else:
            compare(ts, Path(sys.argv[2]).resolve())
        log(card)
        return 0

    from karpenter_tpu_torch import configs
    from karpenter_tpu_torch.solver import TorchSolver, encode
    from karpenter_tpu_torch.solver import _build

    shutil.rmtree(CAPSULE_DIR, ignore_errors=True)
    # the perf sentinel's baselines of every operator this run starts (in
    # process and in subprocesses, which get it as
    # KARPENTER_TPU_AOT_CACHE_DIR: child_env) go to a fresh directory:
    # nothing of an earlier run carries in
    shutil.rmtree(BASELINE_DIR, ignore_errors=True)
    BASELINE_DIR.mkdir(parents=True)
    os.environ["KARPENTER_TPU_COMPILE_CACHE_DIR"] = str(BASELINE_DIR)
    from karpenter_tpu_torch.solver import staging as st
    from karpenter_tpu_torch.solver import torch_solver as ts

    t0 = time.perf_counter()
    lib = _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"({'compiled' if _build.BUILD_SECONDS else 'cached'}) -> {lib}")
    ptxas = lib.with_name("ptxas.log")
    log(ptxas.read_text().strip() if ptxas.exists() else "")
    sass_parts = ("k1_val_pair_shards",) + K1_PARTS + K2_PARTS + ("k3_pack_epilogue",)
    log(f"instructions (cuobjdump -sass): {sass_counts(lib, sass_parts) or 'no cuobjdump'}")
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
    t_checks = time.perf_counter()
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
    kernels.append(probe_check(ts))
    PHASE_WALLS["kernel_checks"] = round(time.perf_counter() - t_checks, 2)
    log(f"phase kernel_checks: wall {PHASE_WALLS['kernel_checks']} s")
    # fresh problem objects for the race, a first solve each; the
    # kernel-only solves come after it, so that the race's first dispatch
    # of each bucket is admitted on the round trip, as a new process's is
    checked = dict(problems)
    for name, make in (
        ("50k_full", configs.config_50k_full),
        ("10k_topology", configs.config_10k_topology),
        ("10k_crossgroup", configs.config_10k_crossgroup),
    ):
        problems[name] = (encode(*make()), problems[name][1])
    flat = phase("flat_race", race_phase, ts, problems, configs)
    log(f"flat race launches {flat}")
    phase("kernel_only", kernel_only, ts, checked, configs)
    del checked
    problems = {name: problems[name] for name in ("50k_full", "10k_topology")}  # K1's breakdown

    t0 = time.perf_counter()
    cells, provs, catalog = configs.config_cells()
    log(f"fleet config: {sum(map(len, cells))} pods in {len(cells)} cells, "
        f"built in {time.perf_counter() - t0:.2f} s")
    phase("hazard", hazard_check, ts, configs, cells, provs, catalog)
    fc = phase("fleet_check", fleet_check, ts, st, configs, cells, provs, catalog)
    k1_breakdown(ts, problems, solver, fc["real"], fc["key"])
    del problems
    for entry in kernels:
        entry["max_abs_err"] = max(entry["max_abs_err"], fc["errs"].get(entry["name"], 0.0))
    kernels += fleet_timings(ts, st, fc, next(k["ms"] for k in kernels if k["name"] == "rtt_probe"))
    del fc
    fleet, k2_err, fleet_encode_s = phase("fleet_slice", fleet_slice, ts, configs, cells, provs,
                                          catalog)
    del cells
    phase("session_delta", session_delta, ts, configs)
    phase("session_fleet", session_fleet, ts, configs, fleet_encode_s)
    mesh_kernels = phase("mesh", mesh_phase, ts, configs)
    controller_errs = phase("controller_round", controller_round, ts, configs)
    sharded = phase("controller_sharded", controller_sharded, ts, st, configs)
    consolidated = phase("consolidation", consolidation, ts, configs)
    operated = phase("operator", operator_phase, ts, configs)
    wired = phase("http_tier", http_tier_phase, ts, configs)
    replayed = phase("replay", replay_phase, ts, st)
    shutil.rmtree(CAPSULE_DIR, ignore_errors=True)
    faulted = phase("fault_domain", fault_domain_phase, ts, configs)
    sentinel = phase("perf_sentinel", perf_sentinel_phase, ts, configs)
    soaked = phase("soak", soak_phase, ts)
    federated = phase("federation", federation_phase, ts)
    # the mesh phase's (d), last: its Operator.new reconfigures process-wide state
    phase("mesh_one_card", mesh_one_card)
    shutil.rmtree(BASELINE_DIR, ignore_errors=True)
    log(f"phase walls (s): {PHASE_WALLS}")
    for entry in kernels:
        entry["max_abs_err"] = max(entry["max_abs_err"], controller_errs.get(entry["name"], 0.0),
                                   consolidated["errs"].get(entry["name"], 0.0),
                                   operated["errs"].get(entry["name"], 0.0),
                                   wired["errs"].get(entry["name"], 0.0),
                                   replayed["errs"].get(entry["name"], 0.0))
    for entry in kernels:
        # the main path: the flat race, the fleet race, the sharded
        # controller's rounds, the deprovisioning passes, the operator's
        # steps, the operator's steps over the wire, the replays, the fault
        # domain, the perf sentinel, the soak (its operator processes and
        # its replays) and the federated operators, each counted alone
        entry["launches"] = (flat[entry["name"]] + fleet[entry["name"]] + sharded[entry["name"]]
                             + consolidated["launches"][entry["name"]]
                             + operated["launches"][entry["name"]]
                             + wired["launches"][entry["name"]]
                             + replayed["launches"][entry["name"]]
                             + faulted[entry["name"]] + sentinel[entry["name"]]
                             + soaked.get(entry["name"], 0) + federated[entry["name"]])
        if entry["name"] == "pack_member":
            entry["max_abs_err"] = max(entry["max_abs_err"], k2_err)
        if entry["launches"] < 1:
            raise AssertionError(f"{entry['name']} was not launched on the main path")
    kernels += mesh_kernels
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
