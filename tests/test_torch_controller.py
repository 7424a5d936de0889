"""The provisioning controller on the CPU: one reconcile of the port's
``ProvisioningController`` against the JAX package's on twin clusters.

Each package builds its own cluster, provider and settings from the same
rows (pod sizes drawn from a numpy seed). The port solves with
``TorchSolver(device="cpu")``, the reference with ``TPUSolver(auto_mesh=
False, quality_sync=True)``, both in quality mode (``latency_budget_s=5``,
``quality_race=True``), so the race's winner does not depend on timing.
After a reconcile the two must agree on the unschedulable pods, the bound
pods, the launched nodes as a multiset of (instance type, zone, capacity
type, sorted pod names) and the $/h of the launched nodes (1e-9 relative).
Node names and instance IDs are not compared: machines launch on a thread
pool, so names follow launch order, which differs between runs. The
host paths polish without their deadlines here (``_host_paths_run_dry``),
so a plan does not depend on how far a polish got on a loaded machine.

The clusters: plain mixed pods, a tainted pool reached by a nodeSelector
and a toleration, zone topology spread, one gang, and a priority
preemption. Then ``configs.config_controller_reconcile`` at a small size
(1,500 pods, 60 types) in both packages: a seed round and four churn rounds
applied through the cluster's own calls, each round with the same encode
mode and problem digest in both, and the port's problem equal to a full
encode of the session's pods. There the machines launch one at a time
(the provider's batched create is switched off), so node names, which
enter the next round's digest, are the same in both packages.

Both packages keep process-wide telemetry (``utils.metrics``,
``DECISIONS``, ``LIFECYCLE``): these are two registries, one per package,
so a count read from one never includes the other's rounds.
"""

from __future__ import annotations

import importlib
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from karpenter_tpu.solver import TPUSolver
from karpenter_tpu_torch.solver import TorchSolver
from test_torch_host import reset_caches

QUALITY = dict(latency_budget_s=5.0, quality_race=True)
PACKAGES = ("karpenter_tpu", "karpenter_tpu_torch")


def _without_deadline(fn):
    def call(*args, **kw):
        kw["deadline"] = None
        return fn(*args, **kw)
    return call


@pytest.fixture(autouse=True, scope="module")
def _host_paths_run_dry():
    """Both packages' host paths polish without their deadlines, as
    ``test_torch_host.py`` holds them: a polish cut at a deadline stops
    wherever the machine's load lets it, and two runs of one package then
    give different plans. The race, the gates and the launches are as
    they run everywhere else."""
    import karpenter_tpu.solver.host as rhost
    import karpenter_tpu.solver.topo as rtopo
    import karpenter_tpu_torch.solver.solver as psolver

    with pytest.MonkeyPatch.context() as mp:
        # the reference imports both inside ``solve``, the port with its module
        mp.setattr(rhost, "solve_host", _without_deadline(rhost.solve_host))
        mp.setattr(rtopo, "topo_improve", _without_deadline(rtopo.topo_improve))
        mp.setattr(psolver, "solve_host", _without_deadline(psolver.solve_host))
        mp.setattr(psolver, "topo_improve", _without_deadline(psolver.topo_improve))
        yield


@pytest.fixture(autouse=True)
def _fresh_caches():
    reset_caches()
    for pkg in PACKAGES:
        pkg_mod(pkg).prov._machine_ids = pkg_mod(pkg).prov.MachineNameSeq()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    reset_caches()


def pkg_mod(pkg: str) -> SimpleNamespace:
    """The names a cluster is built from, in package ``pkg``."""
    imp = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
    return SimpleNamespace(
        api=imp("api"), wk=imp("api.labels"), settings=imp("api.settings"),
        cloud=imp("cloudprovider"), state=imp("state"), prov=imp("controllers.provisioning"),
    )


def make_solver(pkg: str):
    if pkg == "karpenter_tpu":
        return TPUSolver(auto_mesh=False, quality_sync=True, **QUALITY)
    return TorchSolver(device="cpu", **QUALITY)


def new_env(pkg: str, n_types: int = 60, settings_kw=None):
    m = pkg_mod(pkg)
    cluster = m.state.Cluster()
    provider = m.cloud.FakeCloudProvider(catalog=m.cloud.generate_catalog(n_types=n_types))
    settings = m.settings.Settings(batch_idle_duration=0, batch_max_duration=0, **(settings_kw or {}))
    return m, cluster, provider, settings


def mixed_rows(seed: int, n: int):
    """(cpu millicores, memory MiB) of ``n`` pods, from a numpy seed."""
    rng = np.random.default_rng(seed)
    cpu = rng.choice([100, 250, 500, 1000, 2000], size=n)
    mem = rng.choice([128, 256, 512, 1024, 4096], size=n)
    return [(int(c), int(mb)) for c, mb in zip(cpu, mem)]


def add_pods(m, cluster, prefix, rows, **kw):
    for i, (cpu, mem) in enumerate(rows):
        labels = dict(kw.get("labels", {}))
        pod = m.api.Pod(
            meta=m.api.ObjectMeta(name=f"{prefix}-{i}", labels=labels, owner_kind="ReplicaSet"),
            requests=m.api.Resources(cpu=f"{cpu}m", memory=f"{mem}Mi"),
            node_selector=dict(kw.get("node_selector", {})),
            tolerations=list(kw.get("tolerations", [])),
            topology_spread=list(kw.get("spread", [])),
        )
        pod.priority = kw.get("priority", 0)
        for k, v in kw.get("annotations", {}).items():
            pod.meta.annotations[k] = v
        cluster.add_pod(pod)


def cluster_mixed(pkg):
    m, cluster, provider, settings = new_env(pkg)
    cluster.add_provisioner(m.api.Provisioner(meta=m.api.ObjectMeta(name="default")))
    add_pods(m, cluster, "mix", mixed_rows(11, 1500))
    return m, cluster, provider, settings


def cluster_tainted(pkg):
    m, cluster, provider, settings = new_env(pkg)
    api = m.api
    cluster.add_provisioner(api.Provisioner(meta=api.ObjectMeta(name="default")))
    cluster.add_provisioner(api.Provisioner(
        meta=api.ObjectMeta(name="ml"), labels={"team": "ml"},
        taints=[api.Taint(key="accel", value="tpu", effect="NoSchedule")],
    ))
    add_pods(m, cluster, "plain", mixed_rows(12, 400))
    add_pods(m, cluster, "ml", mixed_rows(13, 200), node_selector={"team": "ml"},
             tolerations=[api.Toleration(key="accel", operator="Exists")])
    # selects the tainted pool without tolerating it: no node can take it
    add_pods(m, cluster, "stray", mixed_rows(14, 3), node_selector={"team": "ml"})
    return m, cluster, provider, settings


def cluster_spread(pkg):
    m, cluster, provider, settings = new_env(pkg)
    api, wk = m.api, m.wk
    cluster.add_provisioner(api.Provisioner(meta=api.ObjectMeta(name="default")))
    for app, seed in (("web", 21), ("api", 22), ("cache", 23)):
        spread = [api.TopologySpreadConstraint(max_skew=1, topology_key=wk.ZONE,
                                               label_selector={"app": app})]
        add_pods(m, cluster, app, mixed_rows(seed, 300), labels={"app": app}, spread=spread)
    add_pods(m, cluster, "free", mixed_rows(24, 300))
    return m, cluster, provider, settings


def cluster_gang(pkg):
    m, cluster, provider, settings = new_env(pkg)
    api, wk = m.api, m.wk
    cluster.add_provisioner(api.Provisioner(meta=api.ObjectMeta(name="default")))
    add_pods(m, cluster, "plain", mixed_rows(31, 500))
    add_pods(m, cluster, "train", [(4000, 8192)] * 6, priority=50,
             annotations={wk.POD_GROUP: "train", wk.POD_GROUP_MIN_MEMBERS: "6"})
    # below its quorum: the gate defers it whole
    add_pods(m, cluster, "short", [(1000, 1024)] * 2,
             annotations={wk.POD_GROUP: "short", wk.POD_GROUP_MIN_MEMBERS: "3"})
    return m, cluster, provider, settings


def cluster_preemption(pkg):
    """``tests/test_preemption.py``'s saturated cluster: two full nodes of
    low-priority pods and a provisioner ceiling that blocks any launch, then
    one high-priority pod and one high-priority gang."""
    m, cluster, provider, settings = new_env(pkg, n_types=20)
    api, wk = m.api, m.wk
    cluster.add_provisioner(api.Provisioner(meta=api.ObjectMeta(name="default"),
                                            limits=api.Resources(cpu=0.5)))
    for ni in range(2):
        node = api.Node(
            meta=api.ObjectMeta(name=f"n{ni}", labels={
                wk.PROVISIONER_NAME: "default", wk.ZONE: "zone-a", wk.INSTANCE_TYPE: "t"}),
            allocatable=api.Resources(cpu=4, memory="8Gi", pods=20),
            capacity=api.Resources(cpu=4, memory="8Gi", pods=20),
            ready=True,
        )
        cluster.add_node(node)
        add_pods(m, cluster, f"low-{ni}", [(1000, 1024)] * 4, priority=0)
        for pi in range(4):
            cluster.bind_pod(f"low-{ni}-{pi}", node.name)
    add_pods(m, cluster, "critical", [(1000, 1024)], priority=1000)
    add_pods(m, cluster, "urgent", [(1000, 1024)] * 3, priority=100,
             annotations={wk.POD_GROUP: "urgent", wk.POD_GROUP_MIN_MEMBERS: "3"})
    return m, cluster, provider, settings


CLUSTERS = {
    "mixed": cluster_mixed,
    "tainted": cluster_tainted,
    "spread": cluster_spread,
    "gang": cluster_gang,
    "preemption": cluster_preemption,
}


def launched(m, cluster, provider, result):
    """The round's new nodes as (instance type, zone, capacity type, sorted
    pod names) rows, and their $/h."""
    wk = m.wk
    rows, price = Counter(), 0.0
    for node in result.nodes:
        lab = node.meta.labels
        key = (lab[wk.INSTANCE_TYPE], lab[wk.ZONE], lab[wk.CAPACITY_TYPE])
        rows[key + (tuple(sorted(p.name for p in cluster.pods_on_node(node.name))),)] += 1
        price += provider.pricing.price(*key)
    return rows, price


def outcome(m, cluster, provider, result) -> dict:
    rows, price = launched(m, cluster, provider, result)
    return dict(
        unschedulable=sorted(result.unschedulable), bound=sorted(result.bound),
        gang_deferred=sorted(result.gang_deferred), nodes=rows, price=price,
        pending=sorted(p.name for p in cluster.pending_pods()),
        verdicts=[e["verdict"] for e in result.validation_events],
    )


def hold_fits(cluster):
    """Every node's bound pods fit its allocatable."""
    for node in cluster.nodes.values():
        used = None
        for p in cluster.pods_on_node(node.name):
            used = p.requests if used is None else used + p.requests
        assert used is None or used.fits(node.allocatable), node.name


def reconcile_both(build):
    """One reconcile of each package's controller on its own twin cluster."""
    out = {}
    for pkg in PACKAGES:
        m, cluster, provider, settings = build(pkg)
        ctl = m.prov.ProvisioningController(cluster, provider, solver=make_solver(pkg),
                                            settings=settings)
        result = ctl.reconcile()
        hold_fits(cluster)
        out[pkg] = (m, cluster, provider, ctl, result)
    return out


def assert_same(ref: dict, got: dict):
    for key in ("unschedulable", "bound", "gang_deferred", "pending", "verdicts", "nodes"):
        assert got[key] == ref[key], key
    assert got["price"] == pytest.approx(ref["price"], rel=1e-9, abs=1e-12)


@pytest.mark.parametrize("name", sorted(CLUSTERS))
def test_reconcile_matches_reference(name):
    both = reconcile_both(CLUSTERS[name])
    outs = {pkg: outcome(*both[pkg][:3], both[pkg][4]) for pkg in PACKAGES}
    ref, got = outs["karpenter_tpu"], outs["karpenter_tpu_torch"]
    assert_same(ref, got)
    r_res, p_res = both["karpenter_tpu"][4], both["karpenter_tpu_torch"][4]
    assert p_res.solve.problem_digest == r_res.solve.problem_digest
    assert p_res.solve.cost == pytest.approx(r_res.solve.cost, rel=1e-9, abs=1e-12)
    assert "rejected" not in " ".join(got["verdicts"])
    if name == "mixed":
        assert not got["unschedulable"] and len(got["bound"]) == 1500
    if name == "tainted":
        assert got["unschedulable"] == ["stray-0", "stray-1", "stray-2"]
        cluster = both["karpenter_tpu_torch"][1]
        for pod, node in p_res.bound.items():
            if pod.startswith("ml-"):
                assert any(t.key == "accel" for t in cluster.nodes[node].taints)
    if name == "gang":
        assert got["gang_deferred"] == ["short-0", "short-1"]
        assert all(f"train-{i}" in p_res.bound for i in range(6))
    if name == "preemption":
        assert "critical-0" in p_res.bound and all(f"urgent-{i}" in p_res.bound for i in range(3))
        evicted = [p for p in got["pending"] if p.startswith("low-")]
        assert len(evicted) == 4 and not got["nodes"]


def test_gang_and_preemption_verdicts_match_reference():
    """The decision log's gang and preemption verdicts of the preemption
    cluster, one log per package."""
    from karpenter_tpu.utils.decisions import DECISIONS as RDEC
    from karpenter_tpu_torch.utils.decisions import DECISIONS as PDEC

    assert RDEC is not PDEC
    for log in (RDEC, PDEC):
        log.configure(2048)
        log.clear()
    reconcile_both(cluster_preemption)
    verdicts = {}
    for pkg, log in (("karpenter_tpu", RDEC), ("karpenter_tpu_torch", PDEC)):
        verdicts[pkg] = sorted((r.kind, r.outcome, r.pod) for r in log.query()
                               if r.kind in ("gang", "preemption"))
        log.clear()
    assert verdicts["karpenter_tpu_torch"] == verdicts["karpenter_tpu"]
    assert ("gang", "gang-admitted", "urgent") in verdicts["karpenter_tpu_torch"]


def controller_config(pkg: str, n_pods: int, n_types: int):
    """``configs.config_controller_reconcile`` in package ``pkg``: the
    port's own, or its twin built with the JAX package's API (the same pod
    names, requests and order, the same churn)."""
    from karpenter_tpu_torch import configs

    if pkg == "karpenter_tpu_torch":
        return configs.config_controller_reconcile(n_pods=n_pods, n_types=n_types)
    m = pkg_mod(pkg)
    api = m.api
    twin, provider, _, twin_churn = configs.config_controller_reconcile(n_pods=n_pods, n_types=0)
    cluster = m.state.Cluster()
    cluster.add_provisioner(api.Provisioner(meta=api.ObjectMeta(name="default")))

    def convert(p):
        return api.Pod(meta=api.ObjectMeta(name=p.name), requests=api.Resources(p.requests.to_dict()))

    for p in twin.pods.values():
        cluster.add_pod(convert(p))
    provider = m.cloud.FakeCloudProvider(catalog=m.cloud.generate_catalog(n_types=n_types))
    settings = m.settings.Settings(batch_idle_duration=0, batch_max_duration=0)

    def churn_round(r):
        # the twin picks the pods; this cluster applies the same change
        removed, added = twin_churn(r)
        for p in removed:
            cluster.delete_pod(p.name)
        added = [convert(p) for p in added]
        for p in added:
            cluster.add_pod(p)
        return removed, added

    return cluster, provider, settings, churn_round


def test_churn_rounds_match_reference():
    """The controller's session over a seed round and four churn rounds:
    the same encode modes and digests in both packages (full, then
    ``configs.CONTROLLER_CHURN_MODES``), the same plans, and the port's
    problem equal to a full encode of the session's pods."""
    from karpenter_tpu_torch import configs
    from karpenter_tpu_torch.solver import encode
    from karpenter_tpu_torch.solver.solver import problem_digest

    envs = {}
    for pkg in PACKAGES:
        m = pkg_mod(pkg)
        cluster, provider, settings, churn = controller_config(pkg, 1500, 60)
        # launch one spec at a time, in the plan's order: a node's name
        # enters the next round's digest, and names taken on the launch
        # thread pool follow the threads' order
        provider.create_batched = None
        solver = make_solver(pkg)
        ctl = m.prov.ProvisioningController(cluster, provider, solver=solver, settings=settings)
        calls = []
        if pkg == "karpenter_tpu_torch":
            solve_pods = solver.solve_pods

            def recording(pods, provs, existing=(), daemonsets=(), **kw):
                result = solve_pods(pods, provs, existing=existing, daemonsets=daemonsets, **kw)
                full = encode(kw["session"].ordered_pods(), provs, existing, daemonsets)
                calls.append((problem_digest(full).hex(), len(existing)))
                return result

            solver.solve_pods = recording
        envs[pkg] = (m, cluster, provider, ctl, churn, calls)
    modes = {pkg: [] for pkg in PACKAGES}
    for rnd in ["seed", 0, 1, 2, 3]:
        outs, digests = {}, {}
        for pkg in PACKAGES:
            m, cluster, provider, ctl, churn, calls = envs[pkg]
            if rnd != "seed":
                churn(rnd)
            result = ctl.reconcile()
            hold_fits(cluster)
            outs[pkg] = outcome(m, cluster, provider, result)
            modes[pkg].append(ctl.encode_session.last_mode)
            digests[pkg] = result.solve.problem_digest
            assert not result.unschedulable and not cluster.pending_pods(), (pkg, rnd)
        assert_same(outs["karpenter_tpu"], outs["karpenter_tpu_torch"])
        assert digests["karpenter_tpu_torch"] == digests["karpenter_tpu"], rnd
        full_digest, n_existing = envs["karpenter_tpu_torch"][5][-1]
        assert full_digest == digests["karpenter_tpu_torch"], rnd
        if rnd != "seed":
            assert n_existing > 0
    want = ["full", *configs.CONTROLLER_CHURN_MODES[:4]]
    assert modes["karpenter_tpu"] == want
    assert modes["karpenter_tpu_torch"] == want
