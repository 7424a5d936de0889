"""FederatedFleet: the in-process N-region harness for bench/soak/tests.

A copy of ``karpenter_tpu/federation/fleet.py``. Its regions solve on
``GreedySolver``, as the reference's do: the harness is host-only in both
packages and touches no kernel. One difference: ``replay_all`` takes the
device of the port's replay (``replay_capsule(..., device=...)``, default
``cuda`` as everywhere in the port).

One shared FakeClock drives N complete single-cluster control planes
(cluster store, fake cloud, risk cache, provisioning/termination/
interruption controllers) federated by one FederationArbiter over
DirectArbiterTransport — the whole robustness surface minus the sockets:

* ``partition(region)`` fails that region's arbiter transport like a dead
  network; the region keeps scheduling locally (degraded rounds) and its
  breaker/degraded-log paths exercise for real.
* ``blackout(region)`` is the full regional fault (apiserver + cloud down):
  the region stops reconciling AND stops summarizing; the arbiter's
  staleness sweep declares it lost (epoch bump) and the fleet fails its
  bound gangs over WHOLE to the surviving clusters, restart-boosted like
  preemption victims. ``heal(region)`` wipes the dead region's frozen
  store (its compute is gone — rejoining with failed-over pods would be
  the duplicate-launch bug) before its next summary rejoins it (another
  epoch bump fencing anything minted while it was lost).
* every round assembles a federation capsule — the arbiter's snapshot
  inputs + pure verdict (digest-stamped) + the per-cluster provisioning
  sub-capsules + the degraded decisions partitioned clusters took on
  their own authority — and commits it to the flight recorder, so
  ``replay.py`` reproduces federated rounds byte-identically.
* a per-round launch audit joins on the ``federation-token`` annotation:
  no client token may be live in two running clusters at once.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from ..api import labels as wk
from ..api.objects import ObjectMeta, Pod, Provisioner
from ..api.settings import Settings
from ..cloudprovider import FakeCloudProvider, generate_catalog
from ..controllers.interruption import FakeQueue, InterruptionController
from ..controllers.provisioning import ProvisioningController
from ..controllers.termination import TerminationController
from ..solver.gang import failover_clone, regional_failover_gangs
from ..solver.solver import GreedySolver
from ..state import Cluster
from ..utils.cache import FakeClock
from ..utils.flightrecorder import FLIGHT
from ..utils.riskcache import InterruptionRiskCache
from .arbiter import FederationArbiter
from .client import DirectArbiterTransport, FederationClient


@dataclasses.dataclass
class Region:
    """One regional fault domain: a complete single-cluster control plane
    plus its advisory arbiter link."""

    name: str
    cluster: Cluster
    provider: FakeCloudProvider
    risk: InterruptionRiskCache
    ctl: ProvisioningController
    term: TerminationController
    queue: FakeQueue
    intr: InterruptionController
    client: FederationClient
    transport: DirectArbiterTransport
    settings: Settings
    max_nodes: int = 500
    blacked_out: bool = False
    failed_over: bool = False  # gangs already moved out after a blackout

    def headroom(self) -> int:
        return max(0, self.max_nodes - len(self.cluster.nodes))


class FederatedFleet:
    """N regions + one arbiter on one fake timeline. Deterministic: region
    iteration is name-sorted everywhere, the clock only moves in
    ``run_round``, and every routing verdict is the arbiter's pure
    function of recorded inputs."""

    def __init__(
        self,
        regions: Sequence[str] = ("us-east", "us-west", "eu-west"),
        n_types: int = 12,
        round_s: float = 10.0,
        lease_ttl_s: float = 30.0,
        summary_stale_s: float = 15.0,
        max_nodes: int = 500,
        settings_overrides: Optional[Dict] = None,
    ):
        self.clock = FakeClock(0.0)
        self.settings_overrides = dict(settings_overrides or {})
        self.round_s = float(round_s)
        self.round_no = 0
        self.arbiter = FederationArbiter(
            lease_ttl_s=lease_ttl_s,
            summary_stale_s=summary_stale_s,
            clock=self.clock,
        )
        self.regions: Dict[str, Region] = {}
        self.capsules: List[Dict] = []
        self.audit_violations: List[Dict] = []
        self.costs: List[float] = []
        self.degraded_rounds = 0
        self.failover_gangs: Dict[str, str] = {}  # gang -> lost region
        for name in regions:
            self.regions[name] = self._make_region(name, n_types, max_nodes)

    def _make_region(self, name: str, n_types: int, max_nodes: int) -> Region:
        settings = Settings(
            cluster_name=name,
            batch_idle_duration=0, batch_max_duration=0,
            spot_enabled=True,
            federation_enabled=True, arbiter_endpoint="direct://arbiter",
            **self.settings_overrides,
        )
        cluster = Cluster()
        provider = FakeCloudProvider(catalog=generate_catalog(n_types=n_types))
        for s in provider.subnets:
            s.available_ips = 1 << 20
        risk = InterruptionRiskCache(
            halflife_s=settings.risk_decay_halflife_s, clock=self.clock
        )
        provider.attach_risk_cache(risk)
        ctl = ProvisioningController(
            cluster, provider, solver=GreedySolver(), settings=settings
        )
        term = TerminationController(cluster, provider, clock=self.clock)
        queue = FakeQueue()
        intr = InterruptionController(
            cluster, queue, term,
            unavailable_offerings=provider.unavailable_offerings,
            risk_cache=risk, provisioning=ctl, provider=provider,
            settings=settings, clock=self.clock,
        )
        cluster.add_provisioner(Provisioner(meta=ObjectMeta(name="default")))
        transport = DirectArbiterTransport(self.arbiter)
        client = FederationClient(
            name, region=name, transport=transport, settings=settings,
            clock=self.clock, provider=provider, cluster=cluster,
            risk_cache=risk,
            # deterministic breaker recovery on the FAKE timeline: after a
            # heal, one round's step re-arms the half-open probe instead of
            # pinning the cluster degraded for 10 wall-clock seconds
            recovery_timeout_s=self.round_s,
            breaker_clock=self.clock.now,
        )
        ctl.federation = client
        ctl.federation_transfer = (
            lambda pods, target, home=name: self._transfer(home, pods, target)
        )
        intr.federation = client
        return Region(
            name=name, cluster=cluster, provider=provider, risk=risk,
            ctl=ctl, term=term, queue=queue, intr=intr, client=client,
            transport=transport, settings=settings, max_nodes=max_nodes,
        )

    # -- workload helpers ------------------------------------------------------
    def add_gang(
        self,
        region: str,
        gang: str,
        members: int,
        cpu: str = "500m",
        memory: str = "512Mi",
        regions: str = "*",
    ) -> None:
        """A multi-region-eligible gang pending in ``region``."""
        from ..api.resources import Resources

        cluster = self.regions[region].cluster
        for i in range(members):
            cluster.add_pod(Pod(
                meta=ObjectMeta(
                    name=f"{gang}-{i}",
                    labels={wk.POD_GROUP: gang},
                    annotations={
                        wk.POD_GROUP_MIN_MEMBERS: str(members),
                        wk.REGION_AFFINITY: regions,
                    },
                    owner_kind="Job",
                ),
                requests=Resources(cpu=cpu, memory=memory),
            ))

    def add_pods(
        self,
        region: str,
        prefix: str,
        count: int,
        cpu: str = "500m",
        memory: str = "512Mi",
        regions: Optional[str] = None,
    ) -> None:
        """Plain (optionally multi-region-eligible) pods in ``region``."""
        from ..api.resources import Resources

        cluster = self.regions[region].cluster
        annotations = {wk.REGION_AFFINITY: regions} if regions else {}
        for i in range(count):
            cluster.add_pod(Pod(
                meta=ObjectMeta(
                    name=f"{prefix}-{i}", annotations=dict(annotations),
                    owner_kind="ReplicaSet",
                ),
                requests=Resources(cpu=cpu, memory=memory),
            ))

    # -- faults ---------------------------------------------------------------
    def partition(self, region: str) -> None:
        """Arbiter partition: the region cannot reach the arbiter but keeps
        all its local compute — it degrades, it does not die."""
        self.regions[region].transport.partitioned = True

    def heal_partition(self, region: str) -> None:
        self.regions[region].transport.partitioned = False

    def blackout(self, region: str) -> None:
        """Full regional fault: apiserver + cloud down. The region stops
        reconciling and summarizing; detection is the arbiter's staleness
        sweep, not an oracle bit."""
        rc = self.regions[region]
        rc.blacked_out = True
        rc.failed_over = False
        rc.transport.partitioned = True

    def heal(self, region: str) -> None:
        """The region comes back EMPTY: its compute died with the blackout,
        and anything that failed over lives elsewhere now. Wiping the frozen
        store before the rejoin summary is what keeps a healed region from
        double-running its old gangs."""
        rc = self.regions[region]
        for name in list(rc.cluster.pods):
            rc.cluster.delete_pod(name)
        for name in list(rc.cluster.nodes):
            rc.cluster.delete_node(name)
        for name in list(rc.cluster.machines):
            rc.cluster.delete_machine(name)
        rc.blacked_out = False
        rc.failed_over = False
        rc.transport.partitioned = False

    def storm_spot(self, region: str, fraction: float = 1.0) -> int:
        """Regional spot storm: reclaim warnings for ``fraction`` of the
        region's live spot nodes (name-sorted — deterministic victims)."""
        rc = self.regions[region]
        spot = sorted(
            n for n, node in rc.cluster.nodes.items()
            if node.capacity_pool()[2] == wk.CAPACITY_TYPE_SPOT
        )
        victims = spot[: int(len(spot) * fraction + 1e-9)]
        for name in victims:
            node = rc.cluster.nodes[name]
            iid = node.provider_id.rsplit("/", 1)[-1]
            rc.queue.send({
                "version": "0", "source": "cloud.compute",
                "detail-type": "Spot Instance Interruption Warning",
                "detail": {"instance-id": iid},
            })
        return len(victims)

    # -- cross-cluster movement ------------------------------------------------
    def _transfer(self, home: str, pods: List[Pod], target: str) -> bool:
        """The provisioning gate's transfer hook: physically move a leased
        unit. Synchronous and all-or-nothing per unit — the home cluster's
        capsule (captured after the gate) never sees the moved pods."""
        rc_target = self.regions.get(target)
        if rc_target is None or rc_target.blacked_out:
            return False
        rc_home = self.regions[home]
        for p in pods:
            unit = p.pod_group() or p.meta.name
            clone = failover_clone(p)
            clone.meta.annotations[wk.FEDERATION_TOKEN] = f"{home}/{unit}"
            rc_home.cluster.delete_pod(p.meta.name)
            rc_target.cluster.add_pod(clone)
        return True

    def _failover_region(self, lost: str) -> None:
        """Whole-gang failover for a region the sweep just declared lost:
        every gang re-enters the federation COMPLETE (bound and pending
        members alike) at the arbiter-chosen target, restart-boosted;
        gangless pods re-enter individually."""
        rc = self.regions[lost]
        if rc.failed_over:
            return
        rc.failed_over = True
        pods = sorted(rc.cluster.pods.values(), key=lambda p: p.meta.name)
        gangs = regional_failover_gangs(pods, lost)
        for gname in sorted(gangs):
            members = gangs[gname]
            token = f"failover/{lost}/{gname}"
            result = self.arbiter.request_lease({
                "token": token, "unit": gname, "cluster": lost,
                "gang": gname, "regions": ["*"], "units": len(members),
            })
            target = result.get("target")
            rc_target = self.regions.get(target) if target else None
            if rc_target is None or rc_target.blacked_out:
                continue  # no surviving capacity: the gang waits for one
            self.failover_gangs[gname] = lost
            for clone in members:
                clone.meta.annotations[wk.FEDERATION_TOKEN] = token
                rc_target.cluster.add_pod(clone)
            # restart-boosted like the preemption victims: the refugee
            # gang must not be first against the wall in its new home
            rc_target.ctl._gang_restart_boost[gname] = (
                rc_target.settings.gang_restart_boost_rounds
            )
        for p in pods:
            if p.pod_group():
                continue
            token = f"failover/{lost}/{p.meta.name}"
            result = self.arbiter.request_lease({
                "token": token, "unit": p.meta.name, "cluster": lost,
                "regions": ["*"], "units": 1,
            })
            target = result.get("target")
            rc_target = self.regions.get(target) if target else None
            if rc_target is None or rc_target.blacked_out:
                continue
            clone = failover_clone(p, lost)
            clone.meta.annotations[wk.FEDERATION_TOKEN] = token
            rc_target.cluster.add_pod(clone)

    # -- the round loop --------------------------------------------------------
    def run_round(self, reconciles_per_cluster: int = 6) -> Dict:
        """One federated round: staleness sweep -> summaries -> snapshot ->
        failover for newly-lost regions -> per-cluster control loops (the
        federation gate and transfers run inside provisioning) -> capsule
        assembly + launch audit + cost sample -> clock step."""
        r = self.round_no
        self.round_no += 1
        newly_lost = self.arbiter.sweep_lost()
        for name, rc in sorted(self.regions.items()):
            if not rc.blacked_out:
                rc.client.push_summary(launch_headroom=rc.headroom())
        self.arbiter.begin_round()
        for name in newly_lost:
            # failover only when the region's compute is REALLY gone: a
            # partitioned-but-alive region keeps its gangs (it schedules
            # locally; its stale leases are already fenced by the bump)
            if self.regions[name].blacked_out:
                self._failover_region(name)
        sub_capsules: List[Dict] = []

        def reconcile_cluster(name: str, rc: Region, drain_queue: bool) -> None:
            before = {c["id"] for c in FLIGHT.list()}
            if drain_queue:
                rc.intr.reconcile(max_messages=100)
                while len(rc.queue):
                    rc.intr.reconcile(max_messages=100)
            used = 0
            while rc.cluster.pending_pods() and used < reconciles_per_cluster:
                rc.ctl.reconcile()
                used += 1
            for summary in FLIGHT.list():
                if (
                    summary["id"] not in before
                    and summary["controller"] == "provisioning"
                ):
                    sub_capsules.append({
                        "cluster": name,
                        "capsule": FLIGHT.get(summary["id"]),
                    })

        for name, rc in sorted(self.regions.items()):
            if not rc.blacked_out:
                reconcile_cluster(name, rc, drain_queue=True)
        # second pass: a cluster EARLIER in the name order already finished
        # its reconciles when a later cluster's gate transferred a unit to
        # it — its controller would run again well inside a real round, so
        # same-round arrivals bind here instead of aging a round as
        # unschedulable
        for name, rc in sorted(self.regions.items()):
            if not rc.blacked_out and rc.cluster.pending_pods():
                reconcile_cluster(name, rc, drain_queue=False)
        degraded: List[Dict] = []
        for name, rc in sorted(self.regions.items()):
            degraded.extend(rc.client.drain_degraded_log())
        if degraded:
            self.degraded_rounds += 1
        inputs, verdict = self.arbiter.round_capsule_parts(degraded)
        capsule = {
            "id": f"fed.r{r}",
            "controller": "federation",
            "epoch": verdict["epoch"],
            "inputs": inputs,
            "outputs": {"verdict": verdict},
            "sub_capsules": sub_capsules,
        }
        FLIGHT.commit_external(dict(capsule))
        self.capsules.append(capsule)
        self._audit_launches(r)
        self.costs.append(self.fleet_cost())
        self.clock.step(self.round_s)
        return capsule

    # -- invariants ------------------------------------------------------------
    def _audit_launches(self, round_no: int) -> None:
        """No client token live in two RUNNING clusters at once — the
        double-launch the epoch fence exists to prevent. A blacked-out
        region's frozen store doesn't count (its compute is gone); heal
        wipes it before the region runs again."""
        holders: Dict[str, set] = {}
        for name, rc in sorted(self.regions.items()):
            if rc.blacked_out:
                continue
            for p in rc.cluster.pods.values():
                token = p.meta.annotations.get(wk.FEDERATION_TOKEN)
                if token:
                    holders.setdefault(token, set()).add(name)
        for token, clusters in sorted(holders.items()):
            if len(clusters) > 1:
                self.audit_violations.append({
                    "round": round_no, "token": token,
                    "clusters": sorted(clusters),
                })

    def pending_total(self) -> int:
        return sum(
            len(rc.cluster.pending_pods())
            for rc in self.regions.values()
            if not rc.blacked_out
        )

    def fleet_cost(self) -> float:
        total = 0.0
        for rc in self.regions.values():
            if rc.blacked_out:
                continue
            for node in rc.cluster.nodes.values():
                total += (
                    rc.provider.pricing.price(*node.capacity_pool()) or 0.0
                )
        return total

    def gang_whole_in_one_cluster(self, gang: str) -> bool:
        """True when every member of ``gang`` is BOUND and all of them sit
        in exactly one running cluster — the no-partial-gang invariant the
        failover must preserve."""
        placed: Dict[str, List[Pod]] = {}
        for name, rc in sorted(self.regions.items()):
            if rc.blacked_out:
                continue
            members = [
                p for p in rc.cluster.pods.values() if p.pod_group() == gang
            ]
            if members:
                placed[name] = members
        if len(placed) != 1:
            return False
        members = next(iter(placed.values()))
        quorum = max(p.pod_group_min_members() for p in members)
        bound = [p for p in members if p.node_name is not None]
        return len(bound) >= quorum and len(bound) == len(members)

    def replay_all(self, device: str = "cuda") -> List[Dict]:
        """Replay every captured federation capsule (degraded rounds
        included); each report's ``match`` proves byte-identity of the
        arbiter verdict AND every per-cluster sub-capsule. ``device`` is the
        port's: it places the replay's solver (the sub-capsules name
        ``GreedySolver``, which runs on the host wherever it is)."""
        from ..replay import replay_capsule

        return [replay_capsule(dict(c), device=device) for c in self.capsules]
