"""The benchmark's command: runs one cell of ``BENCHMARK.json`` on the card
and prints its result as the last line of standard output.

    python3 portbench/run.py --workload delta50k.churn --seed 7 --seconds 30 --trace 0

With ``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a run whose first rounds the
profiler traces. The numbers the check compared, each beside its limit,
close both standard error and the result line.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # caches stay in the checkout, at fixed paths
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    spec = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if spec is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        print(f"{args.workload} needs {spec['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    from portbench.harness import banned_modules, run_cell

    out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), t_start=T0)
    banned = banned_modules()
    if banned:
        print(f"modules loaded that the port must not use: {banned}", file=sys.stderr)
        return 3
    for line in out["stderr"]:
        print(line, file=sys.stderr)
    print(json.dumps(out["result"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
