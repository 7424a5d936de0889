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
#: pods, the fake provider's instance types, no existing nodes).
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
}
