"""Problem configurations built with the port's own API.

The shape tables are copied from the JAX package's benchmark harness
(``bench.py``), so the same seed gives the same pods and catalog in both
packages. Each function returns ``(pods, [(provisioner, instance_types)],
existing_nodes)``, the arguments of ``solver.encode``.
"""

from __future__ import annotations

import functools

import numpy as np

from .api import ObjectMeta, PodAffinityTerm, Pod, Provisioner, Resources, TopologySpreadConstraint
from .api import labels as wk
from .cloudprovider import generate_catalog


def pods_from_shapes(shapes):
    """``shapes``: (name prefix, count, cpu, memory, extras) rows; extras may
    hold labels, node_selector, tolerations, spread and affinity."""
    out = []
    for prefix, n, cpu, mem, kw in shapes:
        for j in range(n):
            out.append(
                Pod(
                    meta=ObjectMeta(name=f"{prefix}-{j}", labels=dict(kw.get("labels", {}))),
                    requests=Resources(cpu=cpu, memory=mem),
                    node_selector=dict(kw.get("node_selector", {})),
                    tolerations=list(kw.get("tolerations", [])),
                    topology_spread=list(kw.get("spread", [])),
                    affinity_terms=list(kw.get("affinity", [])),
                )
            )
    return out


def config_10k_topology():
    """10k pods: eight services under zone topology spread and four
    databases under hostname anti-affinity (``bench.config_10k_topology``)."""
    spread = lambda app: [
        TopologySpreadConstraint(max_skew=1, topology_key=wk.ZONE, label_selector={"app": app})
    ]
    anti = lambda app: [
        PodAffinityTerm(label_selector={"app": app}, topology_key=wk.HOSTNAME, anti=True)
    ]
    shapes = []
    for i in range(8):
        app = f"svc{i}"
        shapes.append(
            (app, 1200, ["250m", "500m"][i % 2], ["512Mi", "1Gi"][i % 2],
             {"labels": {"app": app}, "spread": spread(app)})
        )
    for i in range(4):
        app = f"db{i}"
        shapes.append(
            (app, 100, "1", "4Gi", {"labels": {"app": app}, "affinity": anti(app)})
        )
    prov = Provisioner(meta=ObjectMeta(name="default"))
    return pods_from_shapes(shapes), [(prov, generate_catalog(n_types=150))], []


def config_10k_crossgroup():
    """10k pods with cross-group constraints: web services colocated with
    their database at hostname, and a frontend tier whose zone spread counts
    all four frontend services jointly (``bench.config_10k_crossgroup``)."""
    shapes = []
    for i in range(4):
        shapes.append(
            (f"db{i}", 150, "1", "2Gi", {"labels": {"app": f"db{i}", "tier": "data"}})
        )
        shapes.append(
            (f"web{i}", 600, "250m", "512Mi",
             {"labels": {"app": f"web{i}"},
              "affinity": [PodAffinityTerm({"app": f"db{i}"}, wk.HOSTNAME)]})
        )
    front_spread = [
        TopologySpreadConstraint(max_skew=1, topology_key=wk.ZONE,
                                 label_selector={"tier": "front"})
    ]
    for i in range(4):
        shapes.append(
            (f"front{i}", 1500, ["250m", "500m"][i % 2], ["512Mi", "1Gi"][i % 2],
             {"labels": {"app": f"front{i}", "tier": "front"}, "spread": front_spread})
        )
    shapes.append(("filler", 1000, "500m", "1Gi", {}))
    prov = Provisioner(meta=ObjectMeta(name="default"))
    return pods_from_shapes(shapes), [(prov, generate_catalog(n_types=150))], []


def config_full(n_pods: int = 50_000, n_types: int = 400, seed: int = 11):
    """The north-star mix at a parameterized scale: 40 deployment-shaped pod
    groups over ``n_types`` instance types x 3 zones, spot-price weighted
    (``bench._config_full``)."""
    cat = generate_catalog(n_types=n_types)
    rng = np.random.default_rng(seed)
    shapes = []
    remaining = n_pods
    lo = max(n_pods * 300 // 50_000, 8)
    hi = max(n_pods * 2500 // 50_000, 16)
    cpus = ["100m", "250m", "500m", "1", "2", "4"]
    mems = ["256Mi", "512Mi", "1Gi", "2Gi", "4Gi", "8Gi"]
    for i in range(40):
        n = int(rng.integers(lo, hi))
        n = min(n, remaining - (39 - i))
        remaining -= n
        sel = {}
        if i % 5 == 0:
            sel[wk.ZONE] = ["zone-a", "zone-b", "zone-c"][i % 3]
        shapes.append(
            (f"s{i}", n, cpus[int(rng.integers(0, 6))], mems[int(rng.integers(0, 6))],
             {"node_selector": sel})
        )
    if remaining > 0:
        shapes.append(("tail", remaining, "250m", "512Mi", {}))
    prov = Provisioner(meta=ObjectMeta(name="default"))
    return pods_from_shapes(shapes), [(prov, cat)], []


def config_50k_full():
    """50k pods x 400 instance types x 3 zones (``bench.config_50k_full``)."""
    return config_full(50_000, 400)


CELL_CPUS = ["100m", "250m", "500m", "1", "2", "4"]
CELL_MEMS = ["256Mi", "512Mi", "1Gi", "2Gi", "4Gi", "8Gi"]


@functools.lru_cache(maxsize=None)
def _cell_requests(shape: int) -> Resources:
    # one immutable vector per deployment shape: parsing it per pod would be
    # most of the set-up time of 500k pods
    return Resources(cpu=CELL_CPUS[shape % 6], memory=CELL_MEMS[(shape // 2) % 6])


def _cell_pod(cell: int, name: str, shape: int) -> Pod:
    return Pod(meta=ObjectMeta(name=name), requests=_cell_requests(shape),
               node_selector={"bench.pool": f"p{cell}"})


def config_cells(n_pods: int = 500_000, n_cells: int = 20, n_types: int = 60, n_deploys: int = 12):
    """The sharded control plane's fleet (``bench.bench_cell_decompose``):
    ``n_pods`` deployment-shaped pods in ``n_cells`` cells, each node-selected
    onto its own provisioner ``cell-NN`` over one shared catalog, with
    ``n_deploys`` deployments per cell. Returns ``(cells, provisioners,
    catalog)``: ``cells[c]`` maps pod name to pod in creation order, and a
    cell's problem is ``encode(list(cells[c].values()), [(provisioners[c],
    catalog)])``."""
    catalog = generate_catalog(n_types=n_types)
    provs = []
    for c in range(n_cells):
        p = Provisioner(meta=ObjectMeta(name=f"cell-{c:02d}"), labels={"bench.pool": f"p{c}"})
        p.meta.resource_version = c + 1
        provs.append(p)
    per_cell = n_pods // n_cells
    per_dep = per_cell // n_deploys + 1
    cells = []
    for c in range(n_cells):
        pods = {}
        for d in range(n_deploys):
            for i in range(per_dep):
                if len(pods) >= per_cell:
                    break
                name = f"c{c}-d{d}-{i}"
                pods[name] = _cell_pod(c, name, d)
        cells.append(pods)
    return cells, provs, catalog


def churn_cell_events(cells, r: int, per_round: int = 4, n_pods: int = 500_000,
                      n_deploys: int = 12) -> dict:
    """Churn round ``r`` of ``bench.bench_cell_decompose``, applied in place
    to ``cells`` (``config_cells`` output) after rounds 0..r-1: in each of
    ``per_round`` cells, 1% of the cell's pods move from deployment
    ``d{r}`` to ``d{r+5}`` (removed from the one, added as new pods of the
    other's shape, at the end of the cell). Returns ``{cell: (removed pods,
    added pods)}`` for the round's dirty cells, in churn order: the watch
    events a cell's ``EncodeSession`` is fed."""
    n_cells = len(cells)
    n_churn = max(n_pods // n_cells // 100, 1)
    serial = r * per_round * n_churn  # pods added by the earlier rounds
    churned = [(r * per_round + j) % n_cells for j in range(per_round)]
    down, up = r % n_deploys, (r + 5) % n_deploys
    events = {}
    for c in churned:
        pods = cells[c]
        removed = [pods.pop(name) for name in
                   [n for n in pods if n.startswith(f"c{c}-d{down}-")][:n_churn]]
        added = []
        for i in range(n_churn):
            name = f"c{c}-up{serial}-{i}"
            pods[name] = _cell_pod(c, name, up)
            added.append(pods[name])
        serial += n_churn
        events[c] = (removed, added)
    return events


def churn_cells(cells, r: int, per_round: int = 4, n_pods: int = 500_000, n_deploys: int = 12):
    """``churn_cell_events`` without the events: returns the round's dirty
    cells."""
    return list(churn_cell_events(cells, r, per_round, n_pods, n_deploys))


DELTA_ROUNDS = 8


def config_delta_reconcile(n_pods: int = 50_000, n_types: int = 400):
    """The incremental-encode scenario (``bench.bench_delta_reconcile``):
    ``n_pods`` pods in 30 deployments over the 6 cpu x 6 memory shapes, one
    provisioner over ``generate_catalog(n_types)``, and 1% of the pods
    replaced each round: half of it deleted from deployment ``d{r % 30}``,
    as many added to ``d{(r + 7) % 30}``. The bench runs ``DELTA_ROUNDS``
    rounds.

    Returns ``(pods, [(provisioner, instance_types)], churn_round)``:
    ``churn_round(r)``, called for r = 0, 1, ... in turn, returns round
    r's ``(removed, added)`` pods. The pods after a round are the previous
    ones less ``removed``, with ``added`` at the end, which is also the
    order an ``EncodeSession`` fed the round's events keeps."""
    cat = generate_catalog(n_types=n_types)
    prov = Provisioner(meta=ObjectMeta(name="default"))
    n_deploys = 30

    def mkpod(name, shape):
        return Pod(meta=ObjectMeta(name=name), requests=_cell_requests(shape))

    per = n_pods // n_deploys + 1
    pods = [mkpod(f"d{shape}-{i}", shape) for shape in range(n_deploys) for i in range(per)][:n_pods]
    n_churn = max(int(n_pods * 0.01) // 2, 1)
    live = {p.meta.name: p for p in pods}
    state = {"round": 0, "serial": 0}

    def churn_round(r: int):
        if r != state["round"]:
            raise ValueError(f"churn rounds run in turn: round {state['round']} is next, not {r}")
        down, up = r % n_deploys, (r + 7) % n_deploys
        removed = [p for name, p in live.items() if name.startswith(f"d{down}-")][:n_churn]
        added = [mkpod(f"up{state['serial'] + i}-d{up}", up) for i in range(n_churn)]
        for p in removed:
            del live[p.meta.name]
        live.update((p.meta.name, p) for p in added)
        state["round"] += 1
        state["serial"] += n_churn
        return removed, added

    return pods, [(prov, cat)], churn_round


def config_controller_reconcile(n_pods: int = 50_000, n_types: int = 400):
    """``config_delta_reconcile`` as a cluster, for the provisioning
    controller: a ``Cluster`` holding one provisioner and the ``n_pods``
    pods as pending pods (30 deployments over the 6 cpu x 6 memory shapes,
    in the same order), a ``FakeCloudProvider`` over
    ``generate_catalog(n_types)``, and ``Settings`` whose batch window is
    closed (a reconcile solves whatever is pending). A reconcile round is
    ``ProvisioningController(cluster, provider, settings=settings)
    .reconcile()``; the controller takes the cluster's watch events.

    Returns ``(cluster, provider, settings, churn_round)``:
    ``churn_round(r)``, called for r = 0, 1, ... in turn, applies round r
    through the cluster's own calls, so the watch events reach the
    controller: it deletes 1% / 2 of the pods (250 at 50k) of deployment
    ``d{r % 30}`` and adds as many pending pods to ``d{(r + 7) % 30}``,
    and returns ``(removed, added)``. ``DELTA_ROUNDS`` rounds make the
    bench's run."""
    from .api.settings import Settings
    from .cloudprovider.fake import FakeCloudProvider
    from .state.cluster import Cluster

    n_deploys = 30
    cluster = Cluster()
    cluster.add_provisioner(Provisioner(meta=ObjectMeta(name="default")))

    def mkpod(name, shape):
        return Pod(meta=ObjectMeta(name=name), requests=_cell_requests(shape))

    per = n_pods // n_deploys + 1
    names = [(f"d{shape}-{i}", shape) for shape in range(n_deploys) for i in range(per)][:n_pods]
    for name, shape in names:
        cluster.add_pod(mkpod(name, shape))
    provider = FakeCloudProvider(catalog=generate_catalog(n_types=n_types))
    settings = Settings(batch_idle_duration=0, batch_max_duration=0)
    n_churn = max(int(n_pods * 0.01) // 2, 1)
    state = {"round": 0, "serial": 0}

    def churn_round(r: int):
        if r != state["round"]:
            raise ValueError(f"churn rounds run in turn: round {state['round']} is next, not {r}")
        down, up = r % n_deploys, (r + 7) % n_deploys
        removed = [p for name, p in list(cluster.pods.items())
                   if name.startswith(f"d{down}-")][:n_churn]
        added = [mkpod(f"up{state['serial'] + i}-d{up}", up) for i in range(n_churn)]
        for p in removed:
            cluster.delete_pod(p.name)
        for p in added:
            cluster.add_pod(p)
        state["round"] += 1
        state["serial"] += n_churn
        return removed, added

    return cluster, provider, settings, churn_round


#: the operator phase's node template (``config_operator``): family ``al2``
#: over the fake provider's discovery-tagged subnets and security groups
OPERATOR_TEMPLATE = "al2-tpl"


def _operator_cluster(n_pods: int):
    """The cluster of ``config_operator``: ``config_controller_reconcile``'s
    pending pods, owned by ReplicaSets (a drained pod then re-pends, where an
    unowned one would be deleted), one provisioner allowing spot and
    on-demand through the node template, and the template itself."""
    from .api.objects import NodeTemplate
    from .api.requirements import Requirement, Requirements
    from .state.cluster import Cluster

    n_deploys = 30
    cluster = Cluster()
    cluster.add_node_template(NodeTemplate(
        meta=ObjectMeta(name=OPERATOR_TEMPLATE), image_family="al2",
        subnet_selector={"karpenter.tpu/discovery": "cluster"},
        security_group_selector={"karpenter.tpu/discovery": "cluster"},
    ))
    cluster.add_provisioner(Provisioner(
        meta=ObjectMeta(name="default"),
        requirements=Requirements([Requirement.in_values(
            wk.CAPACITY_TYPE, [wk.CAPACITY_TYPE_SPOT, wk.CAPACITY_TYPE_ON_DEMAND])]),
        node_template_ref=OPERATOR_TEMPLATE,
    ))
    per = n_pods // n_deploys + 1
    names = [(f"d{shape}-{i}", shape) for shape in range(n_deploys) for i in range(per)][:n_pods]
    for name, shape in names:
        cluster.add_pod(Pod(meta=ObjectMeta(name=name, owner_kind="ReplicaSet"),
                            requests=_cell_requests(shape)))
    return cluster


def config_operator(n_pods: int = 50_000, n_types: int = 400):
    """``config_controller_reconcile``'s cluster at the same size, for the
    operator (``Operator.new(provider, settings, cluster=cluster,
    clock=clock)`` then ``op.step()``), with these changes: the pods are
    owned by ReplicaSets; the provisioner allows spot and on-demand and
    references the ``NodeTemplate`` ``al2-tpl`` of family ``al2``, with the
    subnet and security-group selectors of
    ``tests/test_drift_template_e2e.py``; the provider's subnets hold 2^20
    IPs a zone; the settings close the batch window and the consolidation
    and stabilization windows and name an interruption queue, with
    everything else at its default (the cost ledger on, spot management
    off).

    Returns ``(cluster, provider, settings, clock)``, ``clock`` a
    ``FakeClock``."""
    from .api.settings import Settings
    from .cloudprovider.fake import FakeCloudProvider
    from .utils.cache import FakeClock

    cluster = _operator_cluster(n_pods)
    provider = FakeCloudProvider(catalog=generate_catalog(n_types=n_types))
    for subnet in provider.subnets:
        subnet.available_ips = 1 << 20
    settings = Settings(batch_idle_duration=0, batch_max_duration=0,
                        consolidation_validation_ttl=0, stabilization_window=0,
                        interruption_queue_name="karpenter-tpu")
    return cluster, provider, settings, FakeClock(start=100_000.0)


def config_operator_seed(n_pods: int = 50_000, n_types: int = 400):
    """The operator's seed round on ``config_operator(n_pods, n_types)``:
    ``(pods, provisioners, existing)``, the pending pods in the cluster's
    order, ``[(provisioner, the fake provider's instance types)]`` and no
    existing nodes, as the provisioning controller hands them to
    ``solve_pods``: a fresh provider (no offering is marked unavailable)
    whose prices took the operator's first refresh (its pricing loop runs
    before provisioning in the first ``step``)."""
    from .cloudprovider.pricing import PricingController

    cluster, provider, _, clock = config_operator(n_pods, n_types)
    PricingController(provider.pricing, clock=clock).reconcile()
    provs = [(p, provider.get_instance_types(p)) for p in cluster.provisioners.values()]
    return cluster.pending_pods(), provs, []


def config_http_tier(n_pods: int = 10_000, n_types: int = 400):
    """``config_operator``'s deployment over the wire: the cluster becomes
    the store a ``ClusterAPIServer(backing=store)`` serves, and the cloud a
    ``CloudHTTPService`` over ``generate_catalog(n_types)`` whose subnets
    hold 2^20 IPs a zone (not started). The operator is then
    ``Operator.new(provider=HTTPCloudProvider(svc.endpoint),
    cluster=HTTPCluster(api.endpoint), settings=settings, clock=clock)``.
    Over the wire there is no price refresh and no cost ledger: the HTTP
    provider has no ``pricing`` (the reference's operator builds neither for
    it). The settings are ``config_operator``'s with the watch intake sized
    for the seed round's burst (``watch_queue_capacity`` 2^16): binding
    ``n_pods`` pods and launching their nodes writes one event a bind and
    several a node, more than the default 8,192 from 10,000 pods on, while
    the round holds the informer still; an intake that overflows sheds and
    relists, which sends the next round to a full encode. The operator's ``HTTPCluster`` takes the capacity from the
    settings, as ``python -m karpenter_tpu_torch`` gives it.

    Returns ``(store, service, settings, clock)``."""
    from .cloudprovider.httpcloud import CloudHTTPService

    from .api.settings import Settings
    from .utils.cache import FakeClock

    store = _operator_cluster(n_pods)
    service = CloudHTTPService(generate_catalog(n_types=n_types))
    for subnet in service.subnets:
        subnet.available_ips = 1 << 20
    settings = Settings(batch_idle_duration=0, batch_max_duration=0,
                        consolidation_validation_ttl=0, stabilization_window=0,
                        interruption_queue_name="karpenter-tpu",
                        watch_queue_capacity=1 << 16)
    return store, service, settings, FakeClock(start=100_000.0)


def config_http_seed(n_pods: int = 10_000, n_types: int = 400):
    """The operator's seed round over the wire on ``config_http_tier(n_pods,
    n_types)``: ``(pods, provisioners, existing)`` as the provisioning
    controller hands them to ``solve_pods``: the store's pending pods and
    ``[(provisioner, an HTTPCloudProvider's instance types)]`` from a fresh
    service (started on a free local port for the one catalog call, then
    stopped), no existing nodes."""
    from .cloudprovider.httpcloud import HTTPCloudProvider

    store, service, _, _ = config_http_tier(n_pods, n_types)
    service.start()
    try:
        provider = HTTPCloudProvider(service.endpoint)
        provs = [(p, provider.get_instance_types(p)) for p in store.provisioners.values()]
    finally:
        service.stop()
    return store.pending_pods(), provs, []


def config_controller_cells(n_pods: int = 500_000, n_cells: int = 20, n_types: int = 60,
                            n_deploys: int = 12):
    """``config_cells`` as a cluster, for the sharded provisioning
    controller (``bench.bench_cell_decompose``'s cluster, nothing cut): a
    ``Cluster`` holding the ``n_cells`` provisioners ``cell-NN`` (labels
    ``bench.pool: pNN``; the cluster sets resource versions) and the
    ``n_pods`` pods as pending pods, cell by cell in ``config_cells``'
    order, a ``FakeCloudProvider`` over ``generate_catalog(n_types)`` whose
    subnets hold 2^20 IPs a zone, and ``Settings`` with a closed batch
    window and cell sharding on (8 workers, fleet chunks of up to 16 cells).

    Returns ``(cluster, provider, settings, churn_round)``:
    ``churn_round(r)``, called for r = 0, 1, ... in turn, applies
    ``churn_cell_events``' round r through ``cluster.delete_pod`` and
    ``add_pod`` (in each of 4 cells, 1% of the cell's pods move from
    deployment ``d{r}`` to ``d{r+5}``) and returns its events."""
    from .api.settings import Settings
    from .cloudprovider.fake import FakeCloudProvider
    from .state.cluster import Cluster

    cells, provs, catalog = config_cells(n_pods, n_cells, n_types, n_deploys)
    cluster = Cluster()
    for p in provs:
        cluster.add_provisioner(p)
    for pods in cells:
        for p in pods.values():
            cluster.add_pod(p)
    provider = FakeCloudProvider(catalog=catalog)
    # ~40,000 nodes: the fake provider's default subnets hold 4,096 IPs a
    # zone, so size them as the JAX package's bench sizes them for its large
    # fleets (``bench.py``: ``available_ips = 1 << 20``)
    for subnet in provider.subnets:
        subnet.available_ips = 1 << 20
    settings = Settings(batch_idle_duration=0, batch_max_duration=0, cell_sharding_enabled=True,
                        cell_shard_workers=8, fleet_max_batch=16)
    state = {"round": 0}

    def churn_round(r: int):
        if r != state["round"]:
            raise ValueError(f"churn rounds run in turn: round {state['round']} is next, not {r}")
        events = churn_cell_events(cells, r, n_pods=n_pods, n_deploys=n_deploys)
        for removed, added in events.values():
            for p in removed:
                cluster.delete_pod(p.name)
            for p in added:
                cluster.add_pod(p)
        state["round"] += 1
        return events

    return cluster, provider, settings, churn_round


def _fleet_node(cluster, provider, prov, name: str, it, zone: str, capacity_type: str):
    """Launch one machine of type ``it`` in ``zone`` through the fake
    provider and register its node, as ``bench.py``'s fleets do."""
    from .api import Machine, Requirement, Requirements
    from .controllers.provisioning import register_node

    machine = Machine(
        meta=ObjectMeta(name=name, labels=dict(prov.labels)),
        provisioner_name=prov.name,
        requirements=Requirements([
            Requirement.in_values(wk.INSTANCE_TYPE, [it.name]),
            Requirement.in_values(wk.ZONE, [zone]),
            Requirement.in_values(wk.CAPACITY_TYPE, [capacity_type]),
        ]),
        requests=Resources(cpu="1"),
    )
    machine = provider.create(machine)
    cluster.add_machine(machine)
    return register_node(cluster, machine, prov)


ZONES = ("zone-a", "zone-b", "zone-c")


def config_consolidation(n_nodes: int = 2000, pods_per_node: int = 10, n_types: int = 100,
                         seed: int = 13):
    """``bench.bench_consolidation``'s fragmented fleet (``bench.py:1457-1514``)
    as a function: ``n_nodes`` on-demand nodes of 6-20 vCPU, their types
    drawn by ``np.random.default_rng(seed)``, over three zones in turn, each
    holding ``pods_per_node`` pods of 200m / 256Mi (pod ``j`` of a node is
    app ``svc{j}``, spread over zones with ``max_skew=2``). The provider
    sells ``generate_catalog(n_types)`` from subnets of 2^20 IPs a zone; the
    provisioner ``default`` has consolidation on; ``Settings`` closes the
    batch window and sets no validation TTL and no stabilization window,
    everything else at its default (``consolidation_timeout`` 2 s). The
    defaults are the 2,000-node, 20,000-pod repack of ``BASELINE.md``;
    ``config_consolidation(300, 3)`` is ``bench.py``'s default run.

    Returns ``(cluster, provider, settings, clock, provisioner)``, the clock
    a ``FakeClock`` at 100,000 s."""
    from .api.settings import Settings
    from .cloudprovider.fake import FakeCloudProvider
    from .state.cluster import Cluster
    from .utils.cache import FakeClock

    provider = FakeCloudProvider(catalog=generate_catalog(n_types=n_types))
    for subnet in provider.subnets:
        subnet.available_ips = 1 << 20
    cluster = Cluster()
    settings = Settings(batch_idle_duration=0, batch_max_duration=0,
                        consolidation_validation_ttl=0, stabilization_window=0)
    clock = FakeClock(start=100_000.0)
    prov = Provisioner(meta=ObjectMeta(name="default"), consolidation_enabled=True)
    cluster.add_provisioner(prov)
    rng = np.random.default_rng(seed)
    mids = [it for it in provider.catalog if 6 <= it.capacity["cpu"] <= 20]
    for i in range(n_nodes):
        it = mids[int(rng.integers(0, len(mids)))]
        node = _fleet_node(cluster, provider, prov, f"frag-{i}", it, ZONES[i % 3],
                           wk.CAPACITY_TYPE_ON_DEMAND)
        for j in range(pods_per_node):
            app = f"svc{j}"
            pod = Pod(
                meta=ObjectMeta(name=f"fp-{i}-{j}", owner_kind="ReplicaSet", labels={"app": app}),
                requests=Resources(cpu="200m", memory="256Mi"),
                topology_spread=[TopologySpreadConstraint(
                    max_skew=2, topology_key=wk.ZONE, label_selector={"app": app})],
            )
            cluster.add_pod(pod)
            cluster.bind_pod(pod.name, node.name)
    return cluster, provider, settings, clock, prov


def config_consolidation_sim(n_nodes: int = 2000, pods_per_node: int = 10):
    """The first what-if of a deprovisioning pass on ``config_consolidation``:
    the multi-node prefix search starts from the whole fleet, so every node
    is excluded and its pods re-placed against the provider's instance
    types with no existing node. Returns ``(pods, provisioners, [])``, the
    arguments of ``encode``, in the order the controller passes them (the
    nodes in the cluster's order, each node's pods in the cluster's)."""
    cluster, provider, _, _, _ = config_consolidation(n_nodes, pods_per_node)
    # one pass over the pods, in the order each node's ``pods_on_node`` gives
    on_node: dict = {}
    for p in cluster.pods.values():
        if p.node_name is not None and not p.is_daemonset:
            on_node.setdefault(p.node_name, []).append(p)
    pods = [p for n in cluster.managed_nodes() for p in on_node.get(n.name, ())]
    provs = [(prov, provider.get_instance_types(prov)) for prov in cluster.provisioners.values()]
    return pods, provs, []


def config_sweep(workers: int, n_candidates: int = 160, pods_per_cand: int = 40,
                 fleet_nodes: int = 200, device="cuda"):
    """``bench._sweep_fixture`` (``bench.py:1219-1332``): the single-node
    consolidation sweep's worst case. ``n_candidates - 1`` spot nodes whose
    1-vCPU pods fit nowhere in the fleet's headroom (any solver opens a new
    node for them, and a spot node is never replaced, so no action), one
    on-demand node ``cand-2000`` whose ``pods_per_cand + 10`` tiny pods
    drain into the headroom (a delete), ranked last by disruption cost, so
    the sweep scans every candidate; a protected fleet of ``fleet_nodes``
    utilized nodes and 6 headroom nodes rides along as existing capacity.
    The multi-node search is off (``consolidation_timeout=0``) and the
    sweep runs on ``workers`` threads.

    Returns a ``DeprovisioningController`` on ``TorchSolver(portfolio=8,
    device=device)`` with no quality solver (``quality_budget_s=0``); its
    ``cluster``, ``provider`` and ``settings`` are the fixture's."""
    from .api.settings import Settings
    from .cloudprovider.fake import FakeCloudProvider
    from .controllers.deprovisioning import DeprovisioningController
    from .controllers.termination import TerminationController
    from .solver.solver import TorchSolver
    from .state.cluster import Cluster
    from .utils.cache import FakeClock

    provider = FakeCloudProvider(catalog=generate_catalog(n_types=100))
    for subnet in provider.subnets:
        subnet.available_ips = 1 << 20
    cluster = Cluster()
    settings = Settings(batch_idle_duration=0, batch_max_duration=0,
                        consolidation_validation_ttl=0, stabilization_window=0,
                        consolidation_timeout=0, consolidation_sweep_workers=workers)
    clock = FakeClock(start=100_000.0)
    prov = Provisioner(meta=ObjectMeta(name="default"), consolidation_enabled=True)
    cluster.add_provisioner(prov)
    term = TerminationController(cluster, provider, clock=clock)
    deprov = DeprovisioningController(
        cluster, provider, term, solver=TorchSolver(portfolio=8, device=device),
        settings=settings, clock=clock, quality_budget_s=0.0,
    )
    mids = sorted([it for it in provider.catalog if 14 <= it.capacity["cpu"] <= 20],
                  key=lambda t: t.name)
    big = sorted([it for it in provider.catalog if it.capacity["cpu"] >= 30],
                 key=lambda t: t.name)

    def mknode(i, it, ct, protect=False):
        node = _fleet_node(cluster, provider, prov, f"cand-{i}", it, ZONES[i % 3], ct)
        if protect:
            node.meta.annotations[wk.DO_NOT_CONSOLIDATE_ANNOTATION] = "true"
            cluster.update(node)
        return node

    def bind(name, node, cpu, mem):
        pod = Pod(meta=ObjectMeta(name=name, owner_kind="ReplicaSet"),
                  requests=Resources(cpu=cpu, memory=mem))
        cluster.add_pod(pod)
        cluster.bind_pod(pod.name, node.name)

    shapes = [("250m", "512Mi"), ("500m", "1Gi"), ("1", "2Gi"), ("750m", "1536Mi"),
              ("300m", "768Mi"), ("100m", "256Mi"), ("1500m", "2Gi"), ("400m", "1Gi")]
    for i in range(n_candidates - 1):
        node = mknode(i, mids[i % len(mids)], wk.CAPACITY_TYPE_SPOT)
        for j in range(pods_per_cand):
            bind(f"sp-{i}-{j}", node, *shapes[j % len(shapes)])
    # utilized fleet: protected nodes with < 0.2 vCPU left, existing capacity
    # every simulation scans and no landing spot for a candidate's pods
    for i in range(fleet_nodes):
        node = mknode(3000 + i, mids[(i * 7) % len(mids)], wk.CAPACITY_TYPE_ON_DEMAND, protect=True)
        bind(f"fleet-{i}", node, str(float(node.allocatable.get("cpu")) - 0.15), "1Gi")
    # headroom: big on-demand nodes with ~1.5 vCPU free, room for the tiny
    # pods and never for a spot candidate's 1-vCPU pods
    for i in range(6):
        node = mknode(1000 + i, big[i % len(big)], wk.CAPACITY_TYPE_ON_DEMAND, protect=True)
        bind(f"fill-{i}", node, str(float(node.allocatable.get("cpu")) - 1.5), "1Gi")
    last = mknode(2000, mids[0], wk.CAPACITY_TYPE_ON_DEMAND)
    for j in range(pods_per_cand + 10):  # the most pods: ranked last
        bind(f"tiny-{j}", last, "100m", "64Mi")
    return deprov


#: The controller session's encode mode in each churn round of
#: ``config_controller_reconcile`` (the seed round encodes in full): what
#: the JAX package's controller gives on the same churn at a small size,
#: which ``tests/test_torch_controller.py`` holds both packages to.
CONTROLLER_CHURN_MODES = ("delta",) * DELTA_ROUNDS


#: JAX-package costs of ``TPUSolver(auto_mesh=False)._solve_kernel`` on these
#: configs, measured on a CPU; the port must reproduce them. ``cells_seed`` is
#: any cell of ``config_cells()``, ``cells_rN`` a cell churned in round N;
#: ``delta_r8`` is ``config_delta_reconcile()`` after its ``DELTA_ROUNDS``
#: churn rounds; ``controller_seed`` is the provisioning controller's
#: seed-round problem on ``config_controller_reconcile()`` (its pending
#: pods, the fake provider's instance types, no existing nodes);
#: ``consolidation_20k`` is ``config_consolidation_sim()``, the first
#: what-if of a deprovisioning pass on ``config_consolidation()``;
#: ``operator_seed`` is ``config_operator_seed()``, the operator's seed
#: round on ``config_operator()`` (a different problem from
#: ``controller_seed``: spot offerings and the first price refresh);
#: ``http_seed`` is ``config_http_seed()``, the operator's seed round over
#: the wire on ``config_http_tier()`` (the JAX package's own HTTP cloud and
#: cluster give the same problem; the HTTP cloud serves no price refresh).
REFERENCE_COSTS = {
    "50k_full": 1017.0072868143582,
    "10k_topology": 59.197231399244934,
    "10k_crossgroup": 57.778294472270225,
    "cells_seed": 449.9105739783382,
    "cells_r0": 460.99796498948336,
    "cells_r1": 451.0820446316647,
    "cells_r2": 448.2557354797225,
    "cells_r3": 448.28029736577486,
    "delta_r8": 851.7806135309604,
    "controller_seed": 843.6097242015434,
    "consolidation_20k": 55.288573398301494,
    "operator_seed": 705.7113230000035,
    "http_seed": 167.73068867890268,
}
