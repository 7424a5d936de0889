"""Chaos soak subsystem: the port's copy of the JAX package's ``soak/``.

This package measures the system under SUSTAINED load with injected process
failures — the harness that can falsify every other part's machinery at
once. Three parts:

* :mod:`~karpenter_tpu_torch.soak.churn` — ``ChurnScript``, the deterministic
  seedable timeline DSL unifying FaultPlan + InterruptionSchedule under one
  RNG and one injected clock;
* :mod:`~karpenter_tpu_torch.soak.harness` — ``SoakHarness``/``run_soak``, driving
  the full real-HTTP stack (apiserver + cloud services, operator as a
  separate killable process) through the timeline;
* :mod:`~karpenter_tpu_torch.soak.monitor` — ``InvariantMonitor``, the
  continuously-asserted regression oracle (pod-ready p99, loop lag, memory
  slope, zero stuck pods, zero duplicate launches, zero orphans, and
  byte-identical offline replay of every dumped anomaly capsule).

The port's differences: the operator process runs
``python -m karpenter_tpu_torch ... --device <SoakConfig.device>`` (default
``cuda``, no fallback), and the monitor replays the dumped capsules through
the port's ``replay_capsule`` on that device.

Scaled (~60–90 s) entry points: ``chip_smoke.py``'s ``soak`` phase on the
card, and ``tests/test_torch_soak.py`` on the CPU (a short run; the
full-length case is slow-marked); full length:
``python -m karpenter_tpu_torch.soak --duration 3600 --device cuda``.
"""

from .churn import ChurnEvent, ChurnScript
from .harness import SoakConfig, SoakHarness, run_soak
from .monitor import InvariantMonitor

__all__ = [
    "ChurnEvent",
    "ChurnScript",
    "InvariantMonitor",
    "SoakConfig",
    "SoakHarness",
    "run_soak",
]
