"""Multi-cluster federation: a global arbiter over regional fault domains.

A copy of ``karpenter_tpu/federation/`` under the port's names, with the
same exports. Every module names its counterpart; the one difference of
substance is in ``fleet.py`` (its replay takes a device).

"One brain, a fleet of clusters": N regional clusters each
run today's full single-cluster control plane unchanged, and a global
:class:`~karpenter_tpu_torch.federation.arbiter.FederationArbiter` trades capacity
between them on cheap per-cluster summaries — residue marginal prices (the
per-cell cheapest-offering duals the sharded arbitration already computes),
risk-cache pool estimates, and launch-limit headroom. CvxCluster (PAPERS.md)
shows this decomposition scales one level up from the in-cluster cells:
sub-solves stay local, only prices cross the wire.

The robustness contract, in order of importance:

1. **Every arbiter dependency is advisory.** A cluster that cannot reach the
   arbiter (partition, arbiter crash) degrades to full local autonomy behind
   a per-cluster circuit breaker and schedules exactly like today's
   single-cluster system. Federation can only ever ADD placement options.
2. **Leases are fenced by (epoch, TTL).** The arbiter bumps its epoch on
   every membership transition (a region declared lost, a region rejoining),
   and a lease minted under an older epoch is invalid everywhere — a healed
   partition cannot double-launch a gang against a stale lease.
3. **Gangs cross regions whole.** When a region blacks out, its bound gangs
   re-enter the federation as complete pending gangs (restart-boosted like
   preemption victims) and are routed atomically; no partial gang is ever
   bound.

Module map: ``arbiter`` (summary registry, epoch, lease table, the pure
verdict function replay re-runs), ``client`` (per-cluster summaries/leases
over the resilience stack, breaker keyed by route TEMPLATE), ``server``
(the arbiter's HTTP surface), ``fleet`` (the in-process N-region harness the
bench/soak/property tests drive).
"""

from .arbiter import FederationArbiter, arbiter_verdict, verdict_digest
from .client import FederationClient, region_affinity

__all__ = [
    "FederationArbiter",
    "FederationClient",
    "arbiter_verdict",
    "verdict_digest",
    "region_affinity",
]
