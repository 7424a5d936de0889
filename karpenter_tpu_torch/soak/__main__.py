"""Full-length soak CLI:
``python -m karpenter_tpu_torch.soak --duration 3600 --device cuda``.

Runs the same harness ``chip_smoke.py``'s soak phase scales down, for
wall-clock hours at production event rates. Prints the invariant report as
JSON; exit 0 when every invariant held, 1 on violations (the report's
``violations`` list names each one and ``dump_dir`` keeps the operator logs
+ anomaly capsules for ``python -m karpenter_tpu_torch.replay`` triage).
``--device`` (default ``cuda``) places the operator's solver and the
offline replay; there is no fallback to the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

from .harness import SoakConfig, run_soak


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m karpenter_tpu_torch.soak",
        description="sustained-load chaos soak over the real-HTTP stack",
    )
    p.add_argument("--duration", type=float, default=3600.0,
                   help="churn duration in seconds (default: one hour)")
    p.add_argument("--rate", type=float, default=0.0,
                   help="target aggregate churn events/second; 0 calibrates "
                        "to the box (sustainable fraction of measured "
                        "apiserver ingest, capped at 1000)")
    p.add_argument("--seed", type=int, default=11,
                   help="ChurnScript seed: identical seeds reproduce "
                        "identical event timelines")
    p.add_argument("--live-pods", type=int, default=300)
    p.add_argument("--operator-kills", type=int, default=1,
                   help="SIGKILL+restart cycles, spread over the run")
    p.add_argument("--apiserver-restarts", type=int, default=1)
    p.add_argument("--dump-dir", default="",
                   help="where operator logs + anomaly capsules land "
                        "(default: a fresh temp dir, printed in the report)")
    p.add_argument("--ready-p99-budget", type=float, default=60.0)
    p.add_argument("--lag-budget", type=float, default=20.0)
    p.add_argument("--mem-slope-budget-kib", type=float, default=64.0,
                   help="memory-slope ceiling in KiB/s (the full-length "
                        "default is tighter than the scaled bench's: hours "
                        "amortize warmup)")
    p.add_argument("--settle-timeout", type=float, default=180.0)
    p.add_argument("--replay-limit", type=int, default=0,
                   help="cap replayed anomaly capsules (0 = every one, "
                        "the acceptance criterion)")
    p.add_argument("--device", default="cuda",
                   help="device of the operator's solver and of the offline "
                        "replay (default cuda; 'cpu' runs the kernels' plain "
                        "versions)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    def spread(n: int, phase: float = 0.0) -> tuple:
        # phase staggers the two chaos kinds so a single kill and a single
        # apiserver restart land apart, not on the same instant
        return tuple(
            min(0.95, max(0.05, (i + 1) / (n + 1) + phase)) for i in range(n)
        )

    config = SoakConfig(
        duration_s=args.duration,
        rate_hz=args.rate,
        seed=args.seed,
        live_pods=args.live_pods,
        operator_restarts=tuple(
            (f, "kill") for f in spread(args.operator_kills, phase=-0.15)
        ),
        apiserver_restarts=spread(args.apiserver_restarts, phase=0.15),
        dump_dir=args.dump_dir,
        ready_p99_budget_s=args.ready_p99_budget,
        loop_lag_budget_s=args.lag_budget,
        mem_slope_budget_bps=args.mem_slope_budget_kib * 1024.0,
        settle_timeout_s=args.settle_timeout,
        replay_limit=args.replay_limit,
        device=args.device,
    )
    report = run_soak(config)
    print(json.dumps(report, indent=2, default=str))
    return 0 if report.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
