"""The port's provisioning controller alone, on the CPU: the counterparts of
``tests/test_provisioning.py``'s ``TestPodBatcher``, ``TestProvisioning``
and ``TestProvisionerWeightPriority`` cases, at the same sizes, with
``TorchSolver(device="cpu")`` where the reference's controller takes its
default ``TPUSolver``; then what the port refuses: a default solver without
CUDA, settings that turn on what is not ported, a kernel error hidden by a
fallback, and a launch template."""

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
        {"federation_enabled": True, "arbiter_endpoint": "http://localhost:1"},
        {"device_fault_script": "t=0,kind=compile-error"},
    ])
    def test_unported_settings_refuse_to_construct(self, kw):
        settings = Settings()
        for k, v in kw.items():
            setattr(settings, k, v)
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            ProvisioningController(Cluster(), FakeCloudProvider(catalog=generate_catalog(n_types=5)),
                                   solver=cpu_solver(), settings=settings)

    def test_device_fault_script_fails_validation(self):
        with pytest.raises(ValueError, match="applies no device faults"):
            Settings().apply({"device_fault_script": "t=0,kind=compile-error"})

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
