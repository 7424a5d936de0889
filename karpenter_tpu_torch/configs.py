"""Problem configurations built with the port's own API.

The shape tables are copied from the JAX package's benchmark harness
(``bench.py``), so the same seed gives the same pods and catalog in both
packages. Each function returns ``(pods, [(provisioner, instance_types)],
existing_nodes)``, the arguments of ``solver.encode``.
"""

from __future__ import annotations

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


#: JAX-package costs of ``TPUSolver(auto_mesh=False)._solve_kernel`` on these
#: configs, measured on a CPU; the port must reproduce them
REFERENCE_COSTS = {
    "50k_full": 1017.0072868143582,
    "10k_topology": 59.197231399244934,
    "10k_crossgroup": 57.778294472270225,
}
