"""The port's provisioning controller alone, on the CPU: the counterparts of
``tests/test_provisioning.py``'s ``TestPodBatcher``, ``TestProvisioning``
and ``TestProvisionerWeightPriority`` cases, at the same sizes, with
``TorchSolver(device="cpu")`` where the reference's controller takes its
default ``TPUSolver``; then what the port refuses: a default solver without
CUDA, a kernel error hidden by a fallback, and a launch template; and
``mesh_enabled``, honoured since the multi-device tier was ported."""

from __future__ import annotations

import itertools
import threading

import pytest
import torch

from karpenter_tpu_torch.api import (
    ObjectMeta,
    Pod,
    Provisioner,
    Requirement,
    Requirements,
    Resources,
    Taint,
    Toleration,
    TopologySpreadConstraint,
)
from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.api.settings import Settings
from karpenter_tpu_torch.cloudprovider import FakeCloudProvider, generate_catalog
from karpenter_tpu_torch.controllers import PodBatcher, ProvisioningController
from karpenter_tpu_torch.solver import GreedySolver, TorchSolver
from karpenter_tpu_torch.state import Cluster

_counter = itertools.count(1)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_pod(name=None, cpu="100m", memory="128Mi", tolerations=(), spread=(),
             labels=None, daemonset=False, owner="ReplicaSet") -> Pod:
    return Pod(
        meta=ObjectMeta(name=name or f"pod-{next(_counter)}", labels=dict(labels or {}),
                        owner_kind=owner),
        requests=Resources(cpu=cpu, memory=memory),
        tolerations=list(tolerations),
        topology_spread=list(spread),
        is_daemonset=daemonset,
    )


def make_pods(n: int, prefix: str = "pod", **kw):
    return [make_pod(name=f"{prefix}-{i}", **kw) for i in range(n)]


def make_provisioner(name: str = "default", requirements=None, **kw) -> Provisioner:
    return Provisioner(meta=ObjectMeta(name=name), requirements=Requirements(requirements or []),
                       **kw)


def cpu_solver():
    return TorchSolver(device="cpu")


@pytest.fixture
def env():
    cluster = Cluster()
    provider = FakeCloudProvider(catalog=generate_catalog(n_types=60))
    controller = ProvisioningController(
        cluster, provider, solver=cpu_solver(),
        settings=Settings(batch_idle_duration=0, batch_max_duration=0),
    )
    cluster.add_provisioner(make_provisioner())
    return cluster, provider, controller


class TestPodBatcher:
    def test_idle_window(self):
        b = PodBatcher(idle=1.0, max_duration=10.0)
        assert not b.ready(now=0)
        b.note_arrival(now=0.0)
        assert not b.ready(now=0.5)
        assert b.ready(now=1.1)

    def test_max_window_caps_stream(self):
        b = PodBatcher(idle=1.0, max_duration=10.0)
        t = 0.0
        b.note_arrival(now=t)
        while t < 9.9:  # continuous arrivals never go idle
            t += 0.5
            b.note_arrival(now=t)
            assert not b.ready(now=t + 0.1) or t >= 10.0 - 1e-9
        b.note_arrival(now=10.0)
        assert b.ready(now=10.05)


class TestProvisioning:
    def test_end_to_end_small(self, env):
        cluster, provider, controller = env
        for pod in make_pods(50, cpu="250m", memory="512Mi"):
            cluster.add_pod(pod)
        result = controller.reconcile()
        assert result.unschedulable == []
        assert len(result.bound) == 50
        assert len(cluster.nodes) == len(result.nodes) > 0
        assert len(provider.instances) == len(result.nodes)
        for pod_name, node_name in result.bound.items():
            assert node_name in cluster.nodes
        for node in cluster.nodes.values():
            used = Resources()
            for p in cluster.pods_on_node(node.name):
                used = used + p.requests
            assert used.fits(node.allocatable)

    def test_end_to_end_1k_mixed(self, env):
        cluster, provider, controller = env
        for pod in make_pods(700, "web", cpu="250m", memory="512Mi"):
            cluster.add_pod(pod)
        for pod in make_pods(300, "db", cpu="1", memory="4Gi"):
            cluster.add_pod(pod)
        result = controller.reconcile()
        assert result.unschedulable == []
        assert len(result.bound) == 1000
        assert all(not p.is_pending() for p in cluster.pods.values())

    def test_existing_capacity_reused(self, env):
        cluster, provider, controller = env
        for pod in make_pods(10, "first", cpu="250m", memory="256Mi"):
            cluster.add_pod(pod)
        controller.reconcile()
        n_nodes = len(cluster.nodes)
        assert n_nodes > 0
        # a second tiny wave fits in the remaining capacity of wave-1 nodes
        for pod in make_pods(3, "second", cpu="50m", memory="64Mi"):
            cluster.add_pod(pod)
        r2 = controller.reconcile()
        assert len(cluster.nodes) == n_nodes
        assert r2.machines == []
        assert len(r2.bound) == 3
        assert controller.encode_session.last_mode == "delta"

    def test_no_provisioner_leaves_pending(self):
        cluster = Cluster()
        provider = FakeCloudProvider(catalog=generate_catalog(n_types=10))
        controller = ProvisioningController(cluster, provider, solver=cpu_solver(),
                                            settings=Settings())
        cluster.add_pod(make_pod())
        result = controller.reconcile()
        assert len(result.unschedulable) == 1
        assert cluster.nodes == {}

    def test_provisioner_limits_cap_scaleup(self, env):
        cluster, provider, controller = env
        prov = cluster.provisioners["default"]
        prov.limits = Resources(cpu=4)  # room for only a couple of small nodes
        cluster.update(prov)
        for pod in make_pods(200, cpu="500m", memory="512Mi"):
            cluster.add_pod(pod)
        result = controller.reconcile()
        total_cpu = sum(n.capacity["cpu"] for n in cluster.nodes.values())
        if cluster.nodes:
            assert total_cpu <= 4 + max(n.capacity["cpu"] for n in cluster.nodes.values())
        assert result.unschedulable  # the rest stayed pending
        assert controller.recorder.events("LimitExceeded")

    def test_tainted_provisioner_and_tolerating_pods(self, env):
        cluster, provider, controller = env
        cluster.delete_provisioner("default")
        cluster.add_provisioner(make_provisioner(name="gpu", taints=[Taint(key="accel", value="tpu")]))
        cluster.add_pod(make_pod(name="plain"))
        cluster.add_pod(make_pod(name="tol", tolerations=[Toleration(key="accel", operator="Exists")]))
        result = controller.reconcile()
        assert "plain" in result.unschedulable
        assert result.bound.get("tol")
        node = cluster.nodes[result.bound["tol"]]
        assert any(t.key == "accel" for t in node.taints)

    def test_ice_offerings_masked_next_cycle(self, env):
        cluster, provider, controller = env
        for pod in make_pods(5, cpu="250m"):
            cluster.add_pod(pod)
        r1 = controller.reconcile()
        assert r1.unschedulable == []

    def test_daemonset_overhead_reserved(self, env):
        cluster, provider, controller = env
        ds = make_pod(name="log-agent", cpu="200m", memory="256Mi", daemonset=True, owner="DaemonSet")
        cluster.add_pod(ds)
        for pod in make_pods(20, cpu="500m", memory="512Mi"):
            cluster.add_pod(pod)
        result = controller.reconcile()
        assert result.unschedulable == []
        for node in cluster.nodes.values():
            used = Resources()
            for p in cluster.pods_on_node(node.name):
                used = used + p.requests
            assert (used + ds.requests).fits(node.allocatable)

    def test_greedy_solver_backend_works_too(self):
        cluster = Cluster()
        provider = FakeCloudProvider(catalog=generate_catalog(n_types=30))
        controller = ProvisioningController(cluster, provider, solver=GreedySolver(), settings=Settings())
        cluster.add_provisioner(make_provisioner())
        for pod in make_pods(30, cpu="250m"):
            cluster.add_pod(pod)
        result = controller.reconcile()
        assert result.unschedulable == []
        assert len(result.bound) == 30


class TestProvisionerWeightPriority:
    def test_higher_weight_provisioner_wins_even_when_pricier(self):
        """Weights are a strict preference order, not overridable by price."""
        catalog = generate_catalog(n_types=40)
        provider = FakeCloudProvider(catalog=catalog)
        cluster = Cluster()
        big = sorted(catalog, key=lambda t: -t.capacity["cpu"])[0]
        cluster.add_provisioner(Provisioner(
            meta=ObjectMeta(name="priority"), weight=50,
            requirements=Requirements([Requirement.in_values(wk.INSTANCE_TYPE, [big.name])]),
        ))
        cluster.add_provisioner(Provisioner(meta=ObjectMeta(name="default"), weight=0))
        ctl = ProvisioningController(cluster, provider, solver=cpu_solver())
        cluster.add_pod(Pod(meta=ObjectMeta(name="p"), requests=Resources(cpu="250m", memory="256Mi")))
        res = ctl.reconcile()
        assert not res.unschedulable
        node = cluster.nodes[cluster.pods["p"].node_name]
        assert node.provisioner_name() == "priority"
        assert node.instance_type() == big.name

    def test_incompatible_high_weight_falls_to_lower(self):
        provider = FakeCloudProvider(catalog=generate_catalog(n_types=20))
        cluster = Cluster()
        cluster.add_provisioner(Provisioner(meta=ObjectMeta(name="gated"), weight=50,
                                            taints=[Taint(key="team", value="ml")]))
        cluster.add_provisioner(Provisioner(meta=ObjectMeta(name="default"), weight=0))
        ctl = ProvisioningController(cluster, provider, solver=cpu_solver())
        cluster.add_pod(Pod(meta=ObjectMeta(name="p"), requests=Resources(cpu="250m", memory="256Mi")))
        res = ctl.reconcile()
        assert not res.unschedulable
        assert cluster.nodes[cluster.pods["p"].node_name].provisioner_name() == "default"

    def test_limit_exhausted_pool_falls_to_next_weight(self):
        provider = FakeCloudProvider(catalog=generate_catalog(n_types=20))
        cluster = Cluster()
        cluster.add_provisioner(Provisioner(meta=ObjectMeta(name="prio"), weight=50,
                                            limits=Resources(cpu="0.001")))
        cluster.add_provisioner(Provisioner(meta=ObjectMeta(name="default"), weight=0))
        ctl = ProvisioningController(cluster, provider, solver=cpu_solver())
        cluster.add_pod(Pod(meta=ObjectMeta(name="p"), requests=Resources(cpu="250m", memory="256Mi")))
        res = ctl.reconcile()
        assert not res.unschedulable
        assert cluster.nodes[cluster.pods["p"].node_name].provisioner_name() == "default"

    def test_narrow_zone_high_weight_pool_degates_for_spread(self):
        provider = FakeCloudProvider(catalog=generate_catalog(n_types=20))
        cluster = Cluster()
        cluster.add_provisioner(Provisioner(
            meta=ObjectMeta(name="narrow"), weight=50,
            requirements=Requirements([Requirement.in_values(wk.ZONE, ["zone-a"])]),
        ))
        cluster.add_provisioner(Provisioner(meta=ObjectMeta(name="default"), weight=0))
        ctl = ProvisioningController(cluster, provider, solver=cpu_solver())
        for i in range(3):
            cluster.add_pod(make_pod(
                name=f"sp-{i}", cpu="250m", memory="256Mi", labels={"app": "wide"},
                spread=[TopologySpreadConstraint(max_skew=1, topology_key=wk.ZONE,
                                                 label_selector={"app": "wide"})],
            ))
        res = ctl.reconcile()
        assert not res.unschedulable, res.unschedulable
        zones = {cluster.nodes[p.node_name].zone() for p in cluster.pods.values()}
        assert len(zones) == 3


class TestNoFallback:
    def test_default_solver_is_the_card(self):
        cluster, provider = Cluster(), FakeCloudProvider(catalog=generate_catalog(n_types=5))
        if torch.cuda.is_available():
            assert ProvisioningController(cluster, provider).solver.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                ProvisioningController(cluster, provider)

    @pytest.mark.parametrize("kw", [
        {"cell_sharding_enabled": True, "mesh_enabled": True},
    ])
    def test_unported_settings_refuse_to_construct(self, kw):
        """``mesh_enabled`` with cell sharding is not refused: the
        controller constructs and binds, on a solver with no mesh (none is
        built without a second card) and on one with an explicit mesh of
        2x2 logical CPU shards, whose sharded round stages its cells as one
        superproblem. Both bind every pod onto the same nodes."""
        from karpenter_tpu_torch import configs, parallel

        plans = {}
        for arm in ("meshless", "mesh"):
            cluster, provider, settings, _ = configs.config_controller_cells(
                n_pods=2000, n_cells=4, n_types=20)
            provider.create_batched = None
            for k, v in kw.items():
                setattr(settings, k, v)
            mesh = parallel.make_mesh2d((2, 2), devices=["cpu"] * 4) if arm == "mesh" else None
            solver = TorchSolver(device="cpu", mesh=mesh)
            assert arm == "mesh" or solver._ensure_mesh() is None
            ctl = ProvisioningController(cluster, provider, solver=solver, settings=settings)
            res = ctl.reconcile()
            assert not cluster.pending_pods() and not res.unschedulable
            assert res.solve.stats["superproblems"] == (1.0 if arm == "mesh" else 0.0)
            plans[arm] = sorted(
                (n.meta.labels.get(wk.INSTANCE_TYPE), n.meta.labels.get(wk.ZONE),
                 tuple(sorted(p.name for p in cluster.pods_on_node(n.name))))
                for n in cluster.nodes.values())
        assert plans["mesh"] == plans["meshless"]

    def test_federation_gate_routes_leased_units(self):
        """``federation_enabled`` constructs, and the gate routes each
        region-affine unit (a lone pod, or a gang whole) by its lease: a
        unit leased elsewhere and confirmed moves through
        ``federation_transfer`` and leaves the round; one leased home, a
        pod without the affinity, and everything while the arbiter link is
        down stay local and bind here."""
        from karpenter_tpu_torch.federation.arbiter import FederationArbiter
        from karpenter_tpu_torch.federation.client import (
            DirectArbiterTransport, FederationClient)
        from karpenter_tpu_torch.utils.cache import FakeClock

        settings = Settings(federation_enabled=True, arbiter_endpoint="http://localhost:1",
                            cluster_name="home", batch_idle_duration=0, batch_max_duration=0)
        cluster = Cluster()
        cluster.add_provisioner(Provisioner(meta=ObjectMeta(name="default")))
        ctl = ProvisioningController(cluster, FakeCloudProvider(catalog=generate_catalog(n_types=5)),
                                     solver=cpu_solver(), settings=settings)
        clock = FakeClock(0.0)
        arbiter = FederationArbiter(clock=clock)
        transport = DirectArbiterTransport(arbiter)
        ctl.federation = FederationClient("home", transport=transport, clock=clock)
        moved = []

        def transfer(pods, target):  # the fleet's: the unit leaves this cluster
            moved.append((target, sorted(p.name for p in pods)))
            for p in pods:
                cluster.delete_pod(p.name)
            return True

        ctl.federation_transfer = transfer
        # "away" is the cheaper member for a unit that may go anywhere
        arbiter.submit_summary({"cluster": "home", "region": "home", "seq": 1,
                                "marginal_price": 0.5, "risk_peak": 0.0, "headroom": 100})
        arbiter.submit_summary({"cluster": "away", "region": "away", "seq": 1,
                                "marginal_price": 0.1, "risk_peak": 0.0, "headroom": 100})

        def pod(name, regions=None, gang=None):
            ann = {wk.REGION_AFFINITY: regions} if regions else {}
            labels = {}
            if gang:
                labels[wk.POD_GROUP] = gang
                ann[wk.POD_GROUP_MIN_MEMBERS] = "2"
            return Pod(meta=ObjectMeta(name=name, annotations=ann, labels=labels,
                                       owner_kind="ReplicaSet"),
                       requests=Resources(cpu="250m", memory="256Mi"))

        for p in (pod("anywhere", "*"), pod("stay", "home"), pod("plain"),
                  pod("g-0", "*", gang="g"), pod("g-1", "*", gang="g")):
            cluster.add_pod(p)
        result = ctl.reconcile()
        assert moved == [("away", ["g-0", "g-1"]), ("away", ["anywhere"])]
        assert sorted(result.bound) == ["plain", "stay"]
        transport.partitioned = True
        cluster.add_pod(pod("cut-off", "*"))
        result = ctl.reconcile()
        assert sorted(result.bound) == ["cut-off"] and len(moved) == 2
        assert ctl.federation.mode == "degraded"
        assert [r["token"] for r in ctl.federation.drain_degraded_log()] == ["home/cut-off"]

    def test_device_fault_script_fails_validation(self):
        """A malformed script fails validation loudly; a well-formed one is
        accepted now that the solver has its device-fault seams."""
        for bad in ("t=0,kind=bogus", "t=0", "t=0,kind=nan-result,n=x"):
            with pytest.raises(ValueError):
                Settings().apply({"device_fault_script": bad})
        settings = Settings().apply({"device_fault_script": "t=0,kind=compile-error"})
        assert settings.device_fault_script == "t=0,kind=compile-error"

    def test_device_fault_script_constructs_and_its_faults_are_evidence(self, monkeypatch):
        """A controller takes a script now; installed, its faults land in
        the solver's seams as breaker evidence, and the round still binds
        every pod."""
        from karpenter_tpu_torch.solver.solver import KERNEL_BOARD
        from karpenter_tpu_torch.utils import faults

        script = "t=0,kind=garbage-result"
        settings = Settings(batch_idle_duration=0, batch_max_duration=0,
                            device_fault_script=script)
        cluster = Cluster()
        controller = ProvisioningController(
            cluster, FakeCloudProvider(catalog=generate_catalog(n_types=20)),
            solver=TorchSolver(device="cpu", latency_budget_s=30.0), settings=settings,
        )
        cluster.add_provisioner(make_provisioner())
        for pod in make_pods(40, cpu="1", memory="1Gi"):
            cluster.add_pod(pod)
        KERNEL_BOARD.reset()
        faults.install_device_faults(faults.DeviceFaultPlan.parse(script))
        try:
            result = controller.reconcile()
        finally:
            plan = faults.install_device_faults(None)
        assert [s for s, _ in plan.log] == ["result"]
        assert KERNEL_BOARD.failures == {"invalid-plan": 1}
        assert len(result.bound) == 40 and not result.unschedulable
        KERNEL_BOARD.reset()

    def test_kernel_error_raises_out_of_reconcile(self, env, monkeypatch):
        """A launch error of the port's kernels is a fault of the program:
        no firewall, gate or provider guard between ``reconcile`` and
        ``solve_pods`` may turn it into an answer."""
        from karpenter_tpu_torch.solver import solver as solver_mod

        def broken(*args, **kwargs):
            raise RuntimeError("kernel launch failed")

        monkeypatch.setattr(solver_mod, "pack_solve_fused", broken)
        cluster, provider, controller = env
        # above ``race_min_pods``, so the race dispatches the kernel chain
        for pod in make_pods(600, cpu="250m", memory="512Mi",
                             labels={"app": "s"},
                             spread=[TopologySpreadConstraint(max_skew=1, topology_key=wk.ZONE,
                                                              label_selector={"app": "s"})]):
            cluster.add_pod(pod)
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            controller.reconcile()
        assert cluster.nodes == {} and len(cluster.pending_pods()) == 600

    def test_kernel_error_on_a_worker_thread_raises_out_of_reconcile(self, monkeypatch):
        """The sharded round solves its cells on host threads; a kernel's
        launch error on one of them re-raises on the controller's thread."""
        from karpenter_tpu_torch.solver import solver as solver_mod

        def broken(*args, **kwargs):
            raise RuntimeError("kernel launch failed")

        monkeypatch.setattr(solver_mod, "pack_solve_fused", broken)
        cluster = Cluster()
        settings = Settings(batch_idle_duration=0, batch_max_duration=0,
                            cell_sharding_enabled=True, cell_shard_workers=2,
                            fleet_dispatch_enabled=False)
        controller = ProvisioningController(
            cluster, FakeCloudProvider(catalog=generate_catalog(n_types=10)),
            solver=cpu_solver(), settings=settings)
        threads = []
        real_solve = TorchSolver.solve

        def solve(self, problem):
            threads.append(threading.current_thread())
            return real_solve(self, problem)

        monkeypatch.setattr(TorchSolver, "solve", solve)
        spread = [TopologySpreadConstraint(max_skew=1, topology_key=wk.ZONE,
                                           label_selector={"app": "s"})]
        for pool in "ab":
            cluster.add_provisioner(Provisioner(meta=ObjectMeta(name=f"cell-{pool}"),
                                                labels={"pool": pool}))
            # above ``race_min_pods``: each cell's race dispatches the chain
            for pod in make_pods(600, prefix=pool, cpu="250m", memory="512Mi",
                                 labels={"app": "s"}, spread=spread):
                pod.node_selector = {"pool": pool}
                cluster.add_pod(pod)
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            controller.reconcile()
        assert threads and threading.main_thread() not in threads
        assert cluster.nodes == {} and len(cluster.pending_pods()) == 1200

    def test_launch_template_names_its_item(self):
        # the launch templates came with the operator's slice: the fake
        # builds its provider on first use and keeps it
        from karpenter_tpu_torch.cloudprovider.launchtemplate import LaunchTemplateProvider

        provider = FakeCloudProvider(catalog=generate_catalog(n_types=5))
        lt = provider.launch_template_provider
        assert isinstance(lt, LaunchTemplateProvider)
        assert provider.launch_template_provider is lt


@pytest.fixture(autouse=True)
def _fresh_admission_table():
    """Each case starts with the port's dispatch-latency table empty, as a
    new process does: the table is process-wide, as the reference's is, and
    a synchronous pass on the CPU times the plain chain (seconds), which
    would turn a later case's race away."""
    from karpenter_tpu_torch.solver.torch_solver import AOT_CACHE as table

    table.clear()
    yield
    table.clear()
