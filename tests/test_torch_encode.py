"""The port's encoder against the JAX package's: the same pods, catalog and
existing nodes, built with each package's own API from one seed, must encode
to exactly equal arrays."""

import dataclasses
import importlib

import numpy as np
import pytest

PACKAGES = ("karpenter_tpu", "karpenter_tpu_torch")


def _pkg(root):
    api = importlib.import_module(f"{root}.api")
    return (
        api,
        importlib.import_module(f"{root}.cloudprovider"),
        importlib.import_module(f"{root}.solver.encode"),
    )


def _pods(api, shapes):
    out = []
    for prefix, n, cpu, mem, kw in shapes:
        for j in range(n):
            out.append(
                api.Pod(
                    meta=api.ObjectMeta(name=f"{prefix}-{j}", labels=dict(kw.get("labels", {}))),
                    requests=api.Resources(cpu=cpu, memory=mem),
                    node_selector=dict(kw.get("node_selector", {})),
                    tolerations=list(kw.get("tolerations", [])),
                    topology_spread=list(kw.get("spread", [])),
                    affinity_terms=list(kw.get("affinity", [])),
                )
            )
    return out


def _random_shapes(rng, n_groups, extra=lambda i: {}):
    cpus = ["100m", "250m", "500m", "1", "2"]
    mems = ["256Mi", "512Mi", "1Gi", "2Gi", "4Gi"]
    return [
        (f"g{i}", int(rng.integers(3, 40)), cpus[int(rng.integers(0, 5))],
         mems[int(rng.integers(0, 5))], extra(i))
        for i in range(n_groups)
    ]


def scenario(root, name, seed=3):
    api, cp, enc = _pkg(root)
    wk = api.labels
    rng = np.random.default_rng(seed)
    cat = cp.generate_catalog(n_types=24)
    prov = api.Provisioner(meta=api.ObjectMeta(name="default"))
    existing = []
    if name == "node_selector":
        zones = ["zone-a", "zone-b", "zone-c"]
        shapes = _random_shapes(
            rng, 8,
            lambda i: {"node_selector": {wk.ZONE: zones[i % 3]}} if i % 2 else
            {"node_selector": {wk.CAPACITY_TYPE: "on-demand"}} if i % 3 == 0 else {},
        )
        provs = [(prov, cat)]
    elif name == "taints":
        provs, tols = [], {}
        for team in ("web", "batch"):
            provs.append((api.Provisioner(meta=api.ObjectMeta(name=team),
                                          taints=[api.Taint(key="team", value=team)]), cat))
            tols[team] = [api.Toleration(key="team", operator="Equal", value=team)]
        shapes = _random_shapes(
            rng, 6, lambda i: {"tolerations": tols[("web", "batch")[i % 2]]} if i < 5 else {}
        )
    elif name == "zone_spread":
        shapes = _random_shapes(rng, 5, lambda i: {
            "labels": {"app": f"s{i}"},
            "spread": [api.TopologySpreadConstraint(
                max_skew=1 + i % 2, topology_key=wk.ZONE, label_selector={"app": f"s{i}"})],
        })
        provs = [(prov, cat)]
    elif name == "anti_affinity":
        shapes = _random_shapes(rng, 4, lambda i: {
            "labels": {"app": f"d{i}"},
            "affinity": [api.PodAffinityTerm(
                label_selector={"app": f"d{i}"}, topology_key=wk.HOSTNAME, anti=True)],
        })
        provs = [(prov, cat)]
    elif name == "crossgroup":
        # web i rides on db i's nodes; the front tier spreads jointly
        shapes = []
        for i in range(2):
            shapes.append((f"db{i}", 12, "1", "2Gi", {"labels": {"app": f"db{i}", "tier": "data"}}))
            shapes.append((f"web{i}", 40, "250m", "512Mi", {
                "labels": {"app": f"web{i}"},
                "affinity": [api.PodAffinityTerm({"app": f"db{i}"}, wk.HOSTNAME)],
            }))
        front = [api.TopologySpreadConstraint(max_skew=1, topology_key=wk.ZONE,
                                              label_selector={"tier": "front"})]
        for i in range(2):
            shapes.append((f"front{i}", 60, "500m", "1Gi", {
                "labels": {"app": f"front{i}", "tier": "front"}, "spread": front}))
        provs = [(prov, cat)]
    elif name == "existing":
        mids = [it for it in cat if 4 <= it.capacity["cpu"] <= 32]
        spread = [api.TopologySpreadConstraint(max_skew=1, topology_key=wk.ZONE,
                                               label_selector={"app": "s0"})]
        for i in range(9):
            it = mids[int(rng.integers(0, len(mids)))]
            zone = ["zone-a", "zone-b", "zone-c"][i % 3]
            node = api.Node(
                meta=api.ObjectMeta(
                    name=f"node-{i}",
                    labels={**it.requirements.labels(), wk.ZONE: zone,
                            wk.PROVISIONER_NAME: "default", wk.INSTANCE_TYPE: it.name},
                ),
                capacity=it.capacity, allocatable=it.allocatable(), ready=True,
                unschedulable=i == 4,
            )
            bound = tuple(_pods(api, [(f"b{i}", i % 3, "250m", "512Mi",
                                       {"labels": {"app": "s0"}, "spread": spread})]))
            remaining = it.allocatable() * float(rng.uniform(0.2, 0.8))
            existing.append(enc.ExistingNode(node=node, remaining=remaining, pods=bound))
        shapes = _random_shapes(rng, 5)
        shapes.append(("s0", 30, "250m", "512Mi", {"labels": {"app": "s0"}, "spread": spread}))
        provs = [(prov, cat)]
    else:
        raise ValueError(name)
    return enc.encode(_pods(api, shapes), provs, existing)


SCENARIOS = ("node_selector", "taints", "zone_spread", "anti_affinity", "crossgroup", "existing")
SKIP_FIELDS = {"groups", "options", "existing", "seed_pods"}  # object graphs, not arrays


@pytest.mark.parametrize("name", SCENARIOS)
def test_encoded_arrays_equal(name):
    ref, port = (scenario(root, name) for root in PACKAGES)
    assert (ref.G, ref.O, ref.E) == (port.G, port.O, port.E)
    assert ref.G > 0 and ref.O > 0
    for f in dataclasses.fields(ref):
        if f.name in SKIP_FIELDS:
            continue
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if isinstance(a, np.ndarray):
            assert isinstance(b, np.ndarray), f.name
            assert a.dtype == b.dtype, f.name
            assert np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    assert [o.instance_type.name for o in ref.options] == [o.instance_type.name for o in port.options]
    assert [[p.name for p in g.pods] for g in ref.groups] == [[p.name for p in g.pods] for g in port.groups]


def test_scenarios_exercise_their_constraint():
    """Each scenario reaches the encoder feature it is named for."""
    p = {name: scenario("karpenter_tpu_torch", name) for name in SCENARIOS}
    assert not p["node_selector"].compat.all()
    assert not p["taints"].compat.all()
    assert (p["zone_spread"].zone_skew > 0).all()
    assert (p["anti_affinity"].node_cap == 1).all()
    assert p["crossgroup"].rel_set is not None and p["crossgroup"].rel_host_need.any()
    assert p["existing"].E == 9 and p["existing"].zone_seed is not None
