"""The port's ``EncodeSession`` and native encoder on the CPU, against the
JAX package's on twin inputs.

Each package builds its own pods, nodes and catalog from the same seeded
choices (``random.Random(seed)``), and both sessions are fed the same
events. After every step the port's delta encode must have the digest of
the port's full encode of ``session.ordered_pods()`` and of the reference
session's encode, and ``_problems_content_equal`` must agree with the
digest. The native grouping loop must bucket pods exactly as the
pure-Python loop does, and ``join_names`` must give the Python join's
bytes.
"""

import dataclasses
import random

import pytest

import karpenter_tpu.api as rapi
import karpenter_tpu_torch.api as papi
from karpenter_tpu.cloudprovider import generate_catalog as rcat
from karpenter_tpu.solver import EncodeSession as RefSession
from karpenter_tpu.solver import ExistingNode as RefNode
from karpenter_tpu.solver import encode as ref_encode
from karpenter_tpu.solver.solver import problem_digest as ref_digest
from karpenter_tpu_torch.cloudprovider import generate_catalog as pcat
from karpenter_tpu_torch.native import load_encoder
from karpenter_tpu_torch.solver import EncodeSession, ExistingNode, encode
from karpenter_tpu_torch.solver.encode import _group_members, _signature
from karpenter_tpu_torch.solver.solver import _problems_content_equal, problem_digest

# (api, generate_catalog, ExistingNode, EncodeSession, encode, problem_digest)
REF = (rapi, rcat, RefNode, RefSession, ref_encode, ref_digest)
PORT = (papi, pcat, ExistingNode, EncodeSession, encode, problem_digest)


def make_pod(api, name, cpu="100m", memory="128Mi", labels=None, node_selector=None,
             tolerations=(), spread=(), affinity=()):
    return api.Pod(
        meta=api.ObjectMeta(name=name, labels=dict(labels or {}), owner_kind="ReplicaSet"),
        requests=api.Resources(cpu=cpu, memory=memory),
        node_selector=dict(node_selector or {}),
        tolerations=list(tolerations),
        topology_spread=list(spread),
        affinity_terms=list(affinity),
    )


# ---------------------------------------------------------------------------
# native / python encoder parity (fuzz)
# ---------------------------------------------------------------------------

def _random_pod(rng: random.Random, i: int):
    """A pod sampled across the simple/complex signature split the native
    encoder specializes on: most pods are plain requests(+labels), a tail
    carries tolerations / spread / affinity / selectors that force the C
    path's python-signature callback."""
    wk = papi.labels
    cpu = rng.choice(["100m", "250m", "500m", "1", "2"])
    mem = rng.choice(["128Mi", "512Mi", "1Gi", "2Gi"])
    labels = {}
    if rng.random() < 0.6:
        labels["app"] = f"app{rng.randrange(4)}"
    kw = {}
    roll = rng.random()
    if roll < 0.15:
        kw["tolerations"] = [papi.Toleration(key="team", operator="Equal", value=f"t{rng.randrange(2)}")]
    elif roll < 0.3:
        kw["spread"] = [papi.TopologySpreadConstraint(
            max_skew=1 + rng.randrange(2), topology_key=wk.ZONE,
            label_selector={"app": f"app{rng.randrange(4)}"})]
    elif roll < 0.4:
        kw["affinity"] = [papi.PodAffinityTerm(
            label_selector={"app": f"app{rng.randrange(4)}"}, topology_key=wk.HOSTNAME, anti=True)]
    elif roll < 0.5:
        kw["node_selector"] = {wk.ZONE: rng.choice(["zone-a", "zone-b", "zone-c"])}
    return make_pod(papi, f"fz-{i}", cpu=cpu, memory=mem, labels=labels, **kw)


def _python_groups(pods):
    """The pure-Python bucketing (``_group_members``' fallback loop), run
    standalone so that the test controls which path computes."""
    buckets, order = {}, []
    for pod in pods:
        sig = _signature(pod)
        members = buckets.get(sig)
        if members is None:
            members = buckets[sig] = []
            order.append(members)
        members.append(pod)
    return order


def test_native_encoder_builds_under_the_build_directory():
    from karpenter_tpu_torch import native

    enc = load_encoder()
    assert enc is not None, "the host C compiler could not build karpenter_tpu_torch/native/encoder.c"
    assert enc.__name__ == "karpenter_tpu_torch.native._encoder"
    path = native.module_path()
    assert path.parent.parent == native.BUILD_ROOT and path.exists()


@pytest.mark.parametrize("seed", range(5))
def test_native_python_grouping_parity_fuzz(seed):
    """The native ``group_pods`` and the pure-Python loop bucket pods
    identically across the simple/complex signature split, and the
    signatures either stamps interoperate."""
    enc = load_encoder()
    assert enc is not None
    rng = random.Random(seed)
    pods = [_random_pod(rng, i) for i in range(300)]
    expected = [[p.meta.name for p in g] for g in _python_groups(pods)]
    # the native path must derive its own signatures and land in the same buckets
    for p in pods:
        p.__dict__.pop("_sched_sig", None)
    got = [[p.meta.name for p in g] for g in enc.group_pods(pods, _signature)]
    assert got == expected
    again = [[p.meta.name for p in g] for g in _group_members(pods)]
    assert again == expected


@pytest.mark.parametrize("seed", range(3))
def test_join_names_matches_python_join(seed):
    enc = load_encoder()
    rng = random.Random(seed)
    pods = [make_pod(papi, f"n{rng.randrange(10**6)}-é{i}") for i in range(rng.randrange(0, 50))]
    assert enc.join_names(pods, "\x1f") == "\x1f".join(p.meta.name for p in pods).encode()


# ---------------------------------------------------------------------------
# delta-vs-full equivalence (property test), against the reference session
# ---------------------------------------------------------------------------

SHAPES = [("100m", "128Mi"), ("250m", "512Mi"), ("1", "2Gi"), ("2", "4Gi")]


def _mk_node(pkg, i, it, version=1):
    api, _, EN = pkg[0], pkg[1], pkg[2]
    wk = api.labels
    node = api.Node(
        meta=api.ObjectMeta(name=f"en-{i}", labels={
            **it.requirements.labels(), wk.ZONE: ["zone-a", "zone-b", "zone-c"][i % 3],
            wk.PROVISIONER_NAME: "default", wk.INSTANCE_TYPE: it.name,
        }),
        capacity=it.capacity, allocatable=it.allocatable(), ready=True,
    )
    node.meta.resource_version = version
    return EN(node=node, remaining=it.allocatable() * 0.5)


class _Side:
    """One package's half of a twin run: its catalog, provisioner, nodes,
    pods and session."""

    def __init__(self, pkg, n_types, full_resync_every=64):
        self.pkg = pkg
        api, gen, _, Session, self.encode_fn, self.digest = pkg
        self.api = api
        self.cat = gen(n_types=n_types)
        self.types = list(self.cat)
        self.prov = api.Provisioner(meta=api.ObjectMeta(name="default"))
        self.prov.meta.resource_version = 1
        self.nodes = []
        self.pods = []
        self.session = Session(full_resync_every=full_resync_every)

    def provs(self):
        return [(self.prov, list(self.types))]

    def encode(self):
        return self.session.encode(self.pods, self.provs(), existing=list(self.nodes))

    def oracle(self):
        return self.encode_fn(self.session.ordered_pods(), self.provs(), existing=list(self.nodes))


@pytest.mark.parametrize("seed", range(6))
def test_random_mutation_sequences(seed):
    """Any sequence of pod, node and offering mutations gives a delta
    encode whose digest is the port's full encode's of the canonical pod
    order and the reference session's, with content equality agreeing."""
    rng = random.Random(seed)
    sides = [_Side(PORT, 8, full_resync_every=0), _Side(REF, 8, full_resync_every=0)]
    for side in sides:
        side.nodes = [_mk_node(side.pkg, i, side.cat[i % len(side.cat)], version=i + 1) for i in range(6)]
    serial = 0
    for _ in range(40):
        serial += 1
        cpu, mem = rng.choice(SHAPES)
        for side in sides:
            side.pods.append(make_pod(side.api, f"pp-{serial}", cpu=cpu, memory=mem))
    for side in sides:
        side.encode()
    next_version = 100
    modes = []
    for step in range(12):
        op = rng.randrange(6)
        if op == 0 and sides[0].pods:  # delete a pod
            i = rng.randrange(len(sides[0].pods))
            for side in sides:
                side.session.pod_event("DELETED", side.pods.pop(i))
        elif op == 1:  # add pods
            for _ in range(rng.randrange(1, 4)):
                serial += 1
                cpu, mem = rng.choice(SHAPES)
                for side in sides:
                    p = make_pod(side.api, f"pp-{serial}", cpu=cpu, memory=mem)
                    side.pods.append(p)
                    side.session.pod_event("ADDED", p)
        elif op == 2 and sides[0].pods:  # modify a pod (signature change)
            i = rng.randrange(len(sides[0].pods))
            cpu, mem = rng.choice(SHAPES)
            for side in sides:
                newp = dataclasses.replace(side.pods[i], requests=side.api.Resources(cpu=cpu, memory=mem))
                side.pods[i] = newp
                side.session.pod_event("MODIFIED", newp)
        elif op == 3 and len(sides[0].nodes) > 1:  # remove a node
            k = rng.randrange(len(sides[0].nodes))
            for side in sides:
                side.nodes.pop(k)
        elif op == 4:  # add a node / change a node's remaining
            if rng.random() < 0.5:
                next_version += 1
                for side in sides:
                    side.nodes.append(_mk_node(side.pkg, 50 + step, side.cat[step % len(side.cat)],
                                               next_version))
            elif sides[0].nodes:
                k = rng.randrange(len(sides[0].nodes))
                for side in sides:
                    side.nodes[k] = dataclasses.replace(side.nodes[k],
                                                        remaining=side.nodes[k].remaining * 0.7)
        else:  # offering availability flip (the ICE-mask path)
            ti = rng.randrange(len(sides[0].types))
            oi = rng.randrange(len(sides[0].types[ti].offerings))
            for side in sides:
                it = side.types[ti]
                flipped = [dataclasses.replace(o, available=not o.available) if k == oi else o
                           for k, o in enumerate(it.offerings)]
                side.types[ti] = it.with_offerings(flipped)
        port, ref = sides
        delta = port.encode()
        modes.append(port.session.last_mode)
        oracle = port.oracle()
        want = ref.encode()
        assert port.session.last_mode == ref.session.last_mode
        assert problem_digest(delta) == problem_digest(oracle), (
            f"seed={seed} step={step} op={op} mode={port.session.last_mode} "
            f"reason={port.session.last_full_reason}")
        assert _problems_content_equal(delta, oracle)
        assert problem_digest(delta) == ref_digest(want)
        assert [p.name for p in port.session.ordered_pods()] == [p.name for p in ref.session.ordered_pods()]
    assert "delta" in modes


def test_delta_actually_engages():
    """Steady pod churn on an unchanged catalog takes the delta path (the
    equivalence test would pass on a session that always ran full)."""
    cat = pcat(n_types=8)
    prov = papi.Provisioner(meta=papi.ObjectMeta(name="default"))
    pods = [make_pod(papi, f"de-{i}", cpu="250m") for i in range(50)]
    session = EncodeSession()
    session.encode(pods, [(prov, cat)])
    assert session.last_mode == "full" and session.last_full_reason == "first-encode"
    session.pod_event("DELETED", pods[0])
    extra = make_pod(papi, "de-extra", cpu="1")
    session.pod_event("ADDED", extra)
    problem = session.encode(pods[1:] + [extra], [(prov, cat)])
    assert session.last_mode == "delta"
    assert session.stats == {"full": 1, "delta": 1}
    assert problem.__dict__["_encode_mode"] == "delta"
    assert [p.name for p in session.ordered_pods()] == [p.name for p in pods[1:] + [extra]]
    assert session.approx_bytes() > 0
    assert session.shape_hints()[-1] == (problem.G, problem.O, problem.E, len(problem.zones),
                                         len(problem.resource_axes), None, 1)


def test_weight_gate_equivalence():
    """Two pools of different weights: the weight gate runs fresh on every
    delta encode over the cached pre-gate rows, here as in the reference."""
    problems = []
    for api, gen, _, Session, enc, digest in (PORT, REF):
        cat = gen(n_types=6)
        provs = [(api.Provisioner(meta=api.ObjectMeta(name="hi"), weight=10), cat),
                 (api.Provisioner(meta=api.ObjectMeta(name="lo"), weight=1), cat)]
        pods = [make_pod(api, f"wg-{i}", cpu="250m") for i in range(20)]
        session = Session()
        session.encode(pods, provs)
        session.pod_event("DELETED", pods[0])
        delta = session.encode(pods[1:], provs)
        assert session.last_mode == "delta"
        oracle = enc(session.ordered_pods(), provs)
        assert digest(delta) == digest(oracle)
        assert delta.weight_gated_groups == oracle.weight_gated_groups
        problems.append((delta, digest))
    (port, pd), (ref, rd) = problems
    assert pd(port) == rd(ref)
    assert port.weight_gated_groups == ref.weight_gated_groups


def test_desync_falls_back_to_full():
    """A pod set the session was never told about (missed events) is not
    delta-encoded: the cardinality check forces a full encode."""
    cat = pcat(n_types=6)
    prov = papi.Provisioner(meta=papi.ObjectMeta(name="default"))
    pods = [make_pod(papi, f"ds-{i}") for i in range(10)]
    session = EncodeSession()
    session.encode(pods, [(prov, cat)])
    sneaky = pods + [make_pod(papi, "ds-sneaky")]  # no event fed
    problem = session.encode(sneaky, [(prov, cat)])
    assert session.last_mode == "full"
    assert session.last_full_reason == "pod-set-desync"
    assert problem.count.sum() == len(sneaky)


def test_structural_mark_forces_full():
    cat = pcat(n_types=6)
    prov = papi.Provisioner(meta=papi.ObjectMeta(name="default"))
    pods = [make_pod(papi, f"st-{i}") for i in range(5)]
    session = EncodeSession()
    session.encode(pods, [(prov, cat)])
    session.mark_structural("relist")
    session.encode(pods, [(prov, cat)])
    assert session.last_mode == "full"
    assert session.last_full_reason == "relist"
    session.encode(pods, [(prov, cat)])
    assert session.last_mode == "delta"


def test_cell_churn_events_keep_the_session_order():
    """``configs.churn_cell_events`` feeds a cell's session: after each
    churn round the session delta-encodes, its canonical order is the
    cell's dict order (so the pinned ``cells_rN`` costs apply to it), and
    its digest is a full encode's."""
    from karpenter_tpu_torch import configs

    cells, provs, catalog = configs.config_cells(n_pods=4 * 600, n_cells=4)
    args = [(provs[0], catalog)]
    session = EncodeSession()
    session.encode(list(cells[0].values()), args)
    churned = 0
    for r in range(3):
        events = configs.churn_cell_events(cells, r, per_round=2, n_pods=4 * 600)
        assert list(events) == configs.churn_cells([{} for _ in cells], r, per_round=2, n_pods=4 * 600)
        if 0 not in events:
            continue
        churned += 1
        removed, added = events[0]
        assert len(removed) == len(added) == 6
        for p in removed:
            session.pod_event("DELETED", p)
        for p in added:
            session.pod_event("ADDED", p)
        problem = session.encode(list(cells[0].values()), args)
        assert session.last_mode == "delta"
        assert [p.name for p in session.ordered_pods()] == list(cells[0])
        assert problem_digest(problem) == problem_digest(encode(list(cells[0].values()), args))
    assert churned == 2
