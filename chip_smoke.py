"""Drive the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and nvcc, and imports nothing of JAX. Phases:

1. device: CUDA must be present; prints the card's name and power limit;
2. build: compiles ``karpenter_tpu_torch/solver/csrc/pack_solve.cu`` with
   nvcc for sm_90a into ``build/kernels/`` (keyed by a hash of the sources);
3. kernel parity: on each of the three problems below, at the slot budget
   its solve reaches, each kernel against its plain PyTorch version on the
   card; then CUDA-event timings at the 50k_full shapes (one warm-up,
   median of five);
4. slice: port ``encode`` and ``TorchSolver(device="cuda").solve`` on
   50k_full, 10k_topology and 10k_crossgroup; every plan must validate, come
   from the kernels (launch counts taken around this phase), and cost what
   the JAX package computes;
5. one JSON line of kernel results, the card's name and power limit, and the
   device JSON as the last line.

Any failure exits non-zero with its traceback; nothing falls back to the CPU.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
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


def check(ts, name, problem, solver) -> dict:
    """Each kernel against its plain version on the card, at the slot
    budget the main path reaches on this problem. Returns what the timings
    need and the largest differences seen."""
    import torch

    fields, orders, alphas, looks, rsvs, swaps, s_new, nz = solver._prepare(problem)
    tensors = ts.pack_inputs_from_numpy(
        dict(fields, orders=orders, alphas=alphas, looks=looks, rsvs=rsvs, swaps=swaps), "cuda"
    )
    _, S, _ = solver._run_fused(tensors, orders, swaps, s_new, nz)
    inputs, o, a, l, r, sw = tensors
    G, O, E, R, Z = ts._dims(inputs)
    K = o.shape[0]
    log(f"check {name}: G={G} O={O} E={E} R={R} Z={Z} K={K} S={S}")

    # K1
    sk = ts.shared_precompute(inputs, S, nz)
    sr = ts.shared_precompute_ref(inputs, S, nz)
    torch.cuda.synchronize()
    for f in ("units", "units_rsv", "rsv_group", "zone_limited", "exok_pad"):
        if not torch.equal(getattr(sk, f), getattr(sr, f)):
            raise AssertionError(f"{name}: K1 {f} differs from the plain version")
    k1_err = max(max_err(sk.lam, sr.lam), max_err(sk.val_pair, sr.val_pair))
    if not (torch.allclose(sk.lam, sr.lam, rtol=1e-6, atol=0)
            and torch.allclose(sk.val_pair, sr.val_pair, rtol=1e-6, atol=0)):
        raise AssertionError(f"{name}: K1 lam/val_pair differ: max abs {k1_err}")

    # K2, both phases
    mk = ts.pack_member(inputs, sk, o, a, l, r, S, nz)
    mr = ts.pack_member_ref(inputs, sk, o, a, l, r, S, nz)
    mk2 = ts.pack_member(inputs, sk, o, a, l, r, S, nz, swaps=sw, seed_costs=mk.cost)
    o2, a2, l2, r2 = ts.phase2_members(o, a, l, r, sw, mk.cost)
    mr2 = ts.pack_member_ref(inputs, sk, o2, a2, l2, r2, S, nz)
    k2_err = 0.0
    for tag, x, y in (("phase 1", mk, mr), ("phase 2", mk2, mr2)):
        for f in ("unplaced", "exhausted", "new_opt", "new_active", "ys"):
            if not torch.equal(getattr(x, f), getattr(y, f)):
                raise AssertionError(f"{name}: K2 {tag} {f} differs from the plain version")
        if not torch.allclose(x.cost, y.cost, rtol=MEMBER_COST_RTOL, atol=0):
            raise AssertionError(f"{name}: K2 {tag} costs {x.cost.tolist()} vs {y.cost.tolist()}")
        k2_err = max(k2_err, max_err(x.cost, y.cost))

    # K3
    bk = ts.pack_epilogue(mk, mk2)
    br = ts.pack_epilogue_ref(mk, mk2)
    if not torch.equal(bk, br):
        raise AssertionError(f"{name}: K3 buffer differs from the plain version")
    k3_err = max_err(bk, br)

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
    k1_ops = 2 * G * O * R * 3 + G * O * G * R * 5 + G * O * G * 3
    looks_used = bool(l.any())
    k2_in = nbytes(inputs.demand, inputs.demand_units, inputs.count, inputs.node_cap,
                   inputs.colocate, inputs.compat, inputs.alloc, inputs.price,
                   inputs.opt_zone, sk.units, sk.units_rsv, sk.quota, sk.exok_pad, o, a, l, r)
    k2_in += nbytes(sk.val_pair) if looks_used else 0
    k2_out = nbytes(mk.cost, mk.unplaced, mk.exhausted, mk.new_opt, mk.new_active, mk.ys)
    t_real = int((inputs.count > 0).sum())
    k2_ops = int(l.sum()) * G * O * G * 2 + K * t_real * (3 * 2 * O * 3 + NS * (4 * R + 20))
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


def slice_phase(ts, problems, configs) -> dict:
    """The main path: TorchSolver on the card, launch counts around it."""
    import torch

    from karpenter_tpu_torch.solver import TorchSolver, validate

    solver = TorchSolver(device="cuda")
    for name in ts.LAUNCHES:
        ts.LAUNCHES[name] = 0
    results = {}
    for name, (problem, encode_s) in problems.items():
        before = dict(ts.LAUNCHES)
        t0 = time.perf_counter()
        result = solver.solve(problem)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        moved = {k: ts.LAUNCHES[k] - before[k] for k in before}
        results[name] = (problem, result, encode_s, solve_s, moved)
    launches = dict(ts.LAUNCHES)

    for name, (problem, result, encode_s, solve_s, moved) in results.items():
        violations = validate(problem, result)
        if violations:
            raise AssertionError(f"{name}: plan fails validation: {violations[:5]}")
        if result.stats.get("backend") != 1.0:
            raise AssertionError(f"{name}: backend {result.stats.get('backend')}")
        if min(moved.values()) < 1:
            raise AssertionError(f"{name}: a kernel was not launched: {moved}")
        ref = configs.REFERENCE_COSTS.get(name)
        if ref is not None and abs(result.cost - ref) > COST_RTOL * ref:
            raise AssertionError(f"{name}: cost {result.cost!r}, JAX package {ref!r}")
        # device time of the fused chain at the slot budget the solve ended on
        fields, orders, alphas, looks, rsvs, swaps, _, nz = solver._prepare(problem)
        tensors = ts.pack_inputs_from_numpy(
            dict(fields, orders=orders, alphas=alphas, looks=looks, rsvs=rsvs, swaps=swaps), "cuda"
        )
        S = int(result.stats["slots"])
        kernel_ms = time_ms(lambda: ts.pack_solve_fused(*tensors, S, nz), per=3)
        st = result.stats
        log(
            f"slice {name}: encode {encode_s:.4f} s, solve {solve_s:.4f} s "
            f"(prepare {st['prepare_s']:.4f}, device {st['device_s']:.4f} over "
            f"{int(st['fused_passes'])} fused passes, validate {st['validate_s']:.4f}, "
            f"decode {st['decode_s']:.4f}), "
            f"kernels {kernel_ms:.4f} ms at S={S}, nodes {len(result.new_nodes)}, "
            f"unschedulable {len(result.unschedulable)}, cost {result.cost!r}"
            + (f" (JAX package {ref!r})" if ref is not None else "")
            + f", launches {moved}"
        )
    return launches


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
    log(f"device: {torch.cuda.get_device_name(0)} ({torch.cuda.device_count()} visible)")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    from karpenter_tpu_torch import configs
    from karpenter_tpu_torch.solver import TorchSolver, encode
    from karpenter_tpu_torch.solver import _build
    from karpenter_tpu_torch.solver import torch_solver as ts

    t0 = time.perf_counter()
    lib_path = _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s ({'compiled' if _build.BUILD_SECONDS else 'cached'}) -> {lib_path}")
    log((lib_path.parent / "ptxas.log").read_text().strip() if (lib_path.parent / "ptxas.log").exists() else "")
    _build.load_kernels()

    problems = {}
    for name, make in (
        ("50k_full", configs.config_50k_full),
        ("10k_topology", configs.config_10k_topology),
        ("10k_crossgroup", configs.config_10k_crossgroup),
    ):
        pods, provs, existing = make()
        t0 = time.perf_counter()
        problems[name] = (encode(pods, provs, existing), time.perf_counter() - t0)

    solver = TorchSolver(device="cuda")
    checked = {name: check(ts, name, problem, solver) for name, (problem, _) in problems.items()}
    errs = {k: max(c["errs"][k] for c in checked.values()) for k in checked["50k_full"]["errs"]}
    kernels = timings(ts, checked.pop("50k_full"), errs)
    del checked
    launches = slice_phase(ts, problems, configs)
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
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
