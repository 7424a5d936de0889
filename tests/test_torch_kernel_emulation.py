"""The CUDA kernels' own source, run on the CPU.

``csrc/pack_solve.cu``, ``csrc/staging.cu`` and ``csrc/probe.cu`` are
compiled with the host C++ compiler against ``tests/cuda_emu/cuda_runtime.h``,
which runs each block's
threads as OS threads with real barriers and warp exchanges, and with the
blocks cut to 64 threads so that every block-wide scan and reduction spans
several chunks. The kernels' launch entry points (``torch_solver._launch_*``,
``staging._launch_*``) then run on CPU tensors and must reproduce the plain
PyTorch versions: every integer output exactly, lam and val_pair exactly,
member costs to rtol 1e-6 (block sums add in another order than torch's),
staged bytes exactly. The meshed tier's kernels run the same way over
logical CPU shards (``solver/meshed.py``'s exchanges as copies between
them): each against its plain version, and the meshed chains against the
emulated un-meshed chain bit for bit. This checks the kernels' logic only;
that nvcc builds them and that they run on the card is chip_smoke.py's job.
"""

import ctypes
import os
import re
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_tpu_torch import configs
from karpenter_tpu_torch.api import (
    Node, ObjectMeta, PodAffinityTerm, Provisioner, TopologySpreadConstraint,
)
from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.cloudprovider import generate_catalog
from karpenter_tpu_torch.solver import ExistingNode, TorchSolver, encode
from karpenter_tpu_torch.solver import _build, staging
from karpenter_tpu_torch.solver import torch_solver as ts

TESTS = Path(__file__).resolve().parent
NULL_STREAM = ctypes.c_void_p(0)


@pytest.fixture(autouse=True, scope="module")
def _two_cores():
    """The emulator runs each block's threads as OS threads that meet at
    barriers: confined to two cores they finish several times sooner than
    spread over many, and leave the other cores to the suite's other
    workers. The plain versions take one intra-op thread."""
    threads, cpus = torch.get_num_threads(), os.sched_getaffinity(0)
    torch.set_num_threads(1)
    os.sched_setaffinity(0, sorted(cpus)[:2])
    yield
    os.sched_setaffinity(0, cpus)
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernels")
    out = tmp_path_factory.mktemp("emu")
    units = []
    for name in _build.SOURCES:
        src = (_build.CSRC / name).read_text()
        src = re.sub(r"(\w+)<<<(.*?)>>>\((\w+)\);", r"emu_launch(\1, \2, \3);", src, flags=re.S)
        src = re.sub(r"extern __shared__ __align__\(16\) unsigned char (\w+)\[\];",
                     r"unsigned char* \1 = emu_dynamic_smem();", src)
        src, n = re.subn(r"constexpr int (k\w*Threads) = \d+;", r"constexpr int \1 = 64;", src)
        # few blocks, so that the grid-stride loops wrap
        src = re.sub(r"constexpr long long kMaxBlocks = \d+;", "constexpr long long kMaxBlocks = 2;", src)
        # K1's val_pair tiles and group chunks cut small, so that a problem
        # of a few dozen options and groups spans several of each
        src = re.sub(r"constexpr int kK1PairTile = \d+;", "constexpr int kK1PairTile = 16;", src)
        src = re.sub(r"constexpr int kK1PairChunk = \d+;", "constexpr int kK1PairChunk = 8;", src)
        # k1_units' tiles capped at 2, so that a tile spans several blocks' options;
        # k1_val_pair's blocks of several groups g from 100 blocks on, so that the
        # batched problems take them and the single ones one group a block
        src = re.sub(r"constexpr int kK1MaxTiles = \d+;", "constexpr int kK1MaxTiles = 2;", src)
        src = re.sub(r"constexpr int kK1PairRowsFrom = \d+;", "constexpr int kK1PairRowsFrom = 100;", src)
        assert n >= 1 and "<<<" not in src and "extern __shared__" not in src
        units.append(out / f"{Path(name).stem}.cpp")
        units[-1].write_text(src)
    # one library from every source, as nvcc builds it
    lib = out / "libkts_emu.so"
    subprocess.run(
        [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
         f"-I{TESTS / 'cuda_emu'}", "-o", str(lib), *map(str, units)],
        check=True, capture_output=True, timeout=300,
    )
    return _build.bind(ctypes.CDLL(str(lib)))


def _small_topology():
    spread = lambda app: [TopologySpreadConstraint(max_skew=1, topology_key=wk.ZONE,
                                                   label_selector={"app": app})]
    anti = lambda app: [PodAffinityTerm(label_selector={"app": app}, topology_key=wk.HOSTNAME,
                                        anti=True)]
    shapes = [(f"svc{i}", 60, ["250m", "500m"][i % 2], ["512Mi", "1Gi"][i % 2],
               {"labels": {"app": f"svc{i}"}, "spread": spread(f"svc{i}")}) for i in range(3)]
    shapes += [(f"db{i}", 10, "1", "4Gi", {"labels": {"app": f"db{i}"}, "affinity": anti(f"db{i}")})
               for i in range(2)]
    return shapes, []


def _small_crossgroup():
    shapes = []
    for i in range(2):
        shapes.append((f"db{i}", 15, "1", "2Gi", {"labels": {"app": f"db{i}", "tier": "data"}}))
        shapes.append((f"web{i}", 60, "250m", "512Mi", {
            "labels": {"app": f"web{i}"},
            "affinity": [PodAffinityTerm({"app": f"db{i}"}, wk.HOSTNAME)]}))
    front = [TopologySpreadConstraint(max_skew=1, topology_key=wk.ZONE,
                                      label_selector={"tier": "front"})]
    for i in range(2):
        shapes.append((f"front{i}", 90, "250m", "512Mi",
                       {"labels": {"app": f"front{i}", "tier": "front"}, "spread": front}))
    return shapes, []


def _existing():
    cat = generate_catalog(n_types=12)
    mids = [it for it in cat if 4 <= it.capacity["cpu"] <= 16]
    nodes = []
    for i in range(6):
        it = mids[i % len(mids)]
        node = Node(meta=ObjectMeta(name=f"node-{i}", labels={
            **it.requirements.labels(), wk.ZONE: ["zone-a", "zone-b", "zone-c"][i % 3],
            wk.PROVISIONER_NAME: "default", wk.INSTANCE_TYPE: it.name}),
            capacity=it.capacity, allocatable=it.allocatable(), ready=True)
        nodes.append(ExistingNode(node=node, remaining=it.allocatable() * 0.4))
    shapes = [("a", 40, "250m", "512Mi", {}), ("b", 30, "500m", "1Gi", {}),
              ("c", 20, "1", "2Gi", {"labels": {"app": "c"}, "spread": [TopologySpreadConstraint(
                  max_skew=1, topology_key=wk.ZONE, label_selector={"app": "c"})]})]
    return shapes, nodes


def _plain():
    return [("x", 40, "1", "2Gi", {}), ("y", 60, "500m", "1Gi", {}), ("z", 30, "2", "4Gi", {})], []


def _ties():
    # on-demand prices are equal across zones: options tie exactly, and the
    # lower index must win every argmin
    od = {"node_selector": {wk.CAPACITY_TYPE: "on-demand"}}
    return [("x", 40, "1", "2Gi", od), ("y", 60, "500m", "1Gi", od), ("z", 30, "2", "4Gi", od)], []


def _relations():
    # a colocated group (required self-affinity on hostname), and zone-key
    # affinity and anti-affinity across groups (zone need and forbid words)
    return [
        ("co", 6, "250m", "256Mi", {"labels": {"app": "co"},
                                    "affinity": [PodAffinityTerm({"app": "co"}, wk.HOSTNAME)]}),
        ("zb", 20, "500m", "1Gi", {"labels": {"app": "zb"}}),
        ("za", 20, "500m", "1Gi", {"labels": {"app": "za"},
                                   "affinity": [PodAffinityTerm({"app": "zb"}, wk.ZONE, anti=True)]}),
        ("zc", 15, "1", "2Gi", {"labels": {"app": "zc"},
                                "affinity": [PodAffinityTerm({"app": "zb"}, wk.ZONE)]}),
    ], []


CASES = {"topology": _small_topology, "crossgroup": _small_crossgroup, "existing": _existing,
         "exhaustion": _plain, "ties": _ties, "relations": _relations}


def _inputs(case):
    shapes, existing = CASES[case]()
    problem = encode(configs.pods_from_shapes(shapes),
                     [(Provisioner(meta=ObjectMeta(name="default")),
                       generate_catalog(n_types=12))], existing)
    fields, orders, alphas, looks, rsvs, swaps, s_new, nz = TorchSolver(device="cpu")._prepare(problem)
    tensors = ts.pack_inputs_from_numpy(
        dict(fields, orders=orders, alphas=alphas, looks=looks, rsvs=rsvs, swaps=swaps), "cpu"
    )
    return tensors, (8 if case == "exhaustion" else s_new), nz


MemberFields = ts.MemberOut._fields


def _assert_members(got, want):
    for f in ("unplaced", "exhausted", "new_opt", "new_active", "ys"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    torch.testing.assert_close(got.cost, want.cost, rtol=1e-6, atol=0)


def _zones_opened_in_one_step(inputs, m) -> int:
    """The most zones any one step of any member opened fresh slots in: a
    fresh slot takes its first pods at that step."""
    E = inputs.ex_rem.shape[0]
    zones = inputs.opt_zone[m.new_opt.clamp(min=0).long()]
    ys = m.ys[:, :, E:]
    before = ys.cumsum(dim=1) - ys  # pods each slot took at earlier steps
    opened = (ys > 0) & (before == 0)
    return max(len(set(zones[k][opened[k, t]].tolist()))
               for k in range(ys.shape[0]) for t in range(ys.shape[1]))


#: warps a block of the emulated kernels holds (their 64 threads)
EMU_WARPS = 2


def _k2_regions(G, O, R, Z, NS):
    """Bytes of K2's scan's three memory regions, as pack_solve.cu lays them
    out: the per-warp partials, the staged groups, one member's per-step
    state."""
    r16 = lambda b: (b + 15) // 16 * 16
    return (EMU_WARPS * (Z + 1) * 12 * 4, r16(G * (1 + 10 + 2 * R + Z) * 4),
            r16(8 * O) + r16(NS * (6 + R) * 4))


def _spill_limits(lib, G, O, R, Z, NS):
    """The shared-memory limits at which the scan keeps its state (spill 1),
    then its groups too (spill 2), in global scratch, each checked against
    the scratch bytes the kernels' own plan asks for."""
    part, groups, state = _k2_regions(G, O, R, Z, NS)
    static = lib.emu_static_smem()
    limits = {1: static + part + groups, 2: static + part}
    assert ts.pack_member_scratch(lib, G, O, R, Z, NS) == 0
    assert ts.pack_member_scratch(lib, G, O, R, Z, NS, static + part + groups + state) == 0
    assert ts.pack_member_scratch(lib, G, O, R, Z, NS, limits[1]) == state
    assert ts.pack_member_scratch(lib, G, O, R, Z, NS, limits[2]) == groups + state
    return limits


@pytest.mark.parametrize("case", ["topology", "crossgroup", "existing", "exhaustion", "ties",
                                  "relations"])
def test_emulated_kernels_match_plain_versions(emulated, case):
    (inputs, o, a, l, r, sw), S, nz = _inputs(case)
    sk = ts._launch_shared_precompute(emulated, inputs, S, NULL_STREAM)
    sr = ts.shared_precompute_ref(inputs, S, nz)
    for f in ("units", "units_rsv", "rsv_group", "lam", "zone_limited", "val_pair", "exok_pad"):
        assert torch.equal(getattr(sk, f), getattr(sr, f)), f

    m1 = ts._launch_pack_member(emulated, inputs, sk, o, a, l, r, S, None, None, NULL_STREAM)
    _assert_members(m1, ts.pack_member_ref(inputs, sr, o, a, l, r, S, nz))
    m2 = ts._launch_pack_member(emulated, inputs, sk, o, a, l, r, S, sw, m1.cost, NULL_STREAM)
    o2, a2, l2, r2 = ts.phase2_members(o, a, l, r, sw, m1.cost)
    _assert_members(m2, ts.pack_member_ref(inputs, sr, o2, a2, l2, r2, S, nz))

    buf = ts._launch_pack_epilogue(emulated, m1, m2, NULL_STREAM)
    assert torch.equal(buf, ts.pack_epilogue_ref(m1, m2))
    if case == "exhaustion":
        assert bool(torch.cat([m1.exhausted, m2.exhausted]).any())
    if case == "existing":
        assert bool(inputs.ex_valid.any()) and bool(m1.ys[:, :, :6].any())
    if case == "crossgroup":
        assert bool(r.any()) and bool(inputs.rel_host_need.any())
    if case == "topology":
        # zone-limited groups open fresh slots from several zone buckets in one step
        assert bool(sr.zone_limited.any()) and _zones_opened_in_one_step(inputs, m1) >= 2
    if case == "relations":
        assert bool(inputs.colocate.any())
        assert bool(inputs.rel_zone_forbid.any()) and bool(inputs.rel_zone_need.any())


@pytest.mark.parametrize("case", ["topology", "crossgroup", "existing", "relations"])
def test_emulated_k2_state_in_global_memory(emulated, case):
    """K2's scan with its per-step state in global scratch, and with its
    staged groups there too (as on the card when they do not fit in shared
    memory): the same code, the plain version's outputs, both phases."""
    (inputs, o, a, l, r, sw), S, nz = _inputs(case)
    G, O, E, R, Z = ts._dims(inputs)
    sr = ts.shared_precompute_ref(inputs, S, nz)
    for spill, limit in _spill_limits(emulated, G, O, R, Z, E + S).items():
        m1 = ts._launch_pack_member(emulated, inputs, sr, o, a, l, r, S, None, None, NULL_STREAM,
                                    smem_limit=limit)
        _assert_members(m1, ts.pack_member_ref(inputs, sr, o, a, l, r, S, nz))
        m2 = ts._launch_pack_member(emulated, inputs, sr, o, a, l, r, S, sw, m1.cost, NULL_STREAM,
                                    smem_limit=limit)
        o2, a2, l2, r2 = ts.phase2_members(o, a, l, r, sw, m1.cost)
        _assert_members(m2, ts.pack_member_ref(inputs, sr, o2, a2, l2, r2, S, nz))


def test_emulated_k2_plan_counts_static_shared_memory(emulated):
    """The card's opt-in limit caps a block's static and dynamic shared
    memory together. At the widths of 50k_full (G=32, O=4096, R=3, Z=4),
    every NS whose scan memory fits under the limit only when the scan's
    static shared memory is left out must put its state in global memory;
    groups that do not fit at all go there too. A run at a limit inside that
    window launches, and matches the plain version."""
    static = emulated.emu_static_smem()
    assert static > 0
    optin = 232448  # the emulated card's, as an H100's
    G, O, R, Z = 32, 4096, 3, 4
    part, groups, state0 = _k2_regions(G, O, R, Z, 0)
    first = next(ns for ns in range(4096, 8192)
                 if part + groups + _k2_regions(G, O, R, Z, ns)[2] + static > optin)
    window = [ns for ns in range(first, first + 128)
              if part + groups + _k2_regions(G, O, R, Z, ns)[2] <= optin]
    assert len(window) >= 40
    assert ts.pack_member_scratch(emulated, G, O, R, Z, first - 1) == 0
    for ns in window:
        assert ts.pack_member_scratch(emulated, G, O, R, Z, ns) == _k2_regions(G, O, R, Z, ns)[2]
    big = 4096  # groups alone over the limit
    assert part + _k2_regions(big, O, R, Z, 0)[1] + static > optin
    assert ts.pack_member_scratch(emulated, big, O, R, Z, 2048) == sum(_k2_regions(big, O, R, Z, 2048)[1:])
    with pytest.raises(RuntimeError, match="G=32 groups"):
        ts.pack_member_scratch(emulated, G, O, R, Z, 2048, static + part - 1)

    (inputs, o, a, l, r, sw), S, nz = _inputs("existing")
    G, O, E, R, Z = ts._dims(inputs)
    part, groups, state = _k2_regions(G, O, R, Z, E + S)
    limit = part + groups + state  # fits without the static bytes only
    assert ts.pack_member_scratch(emulated, G, O, R, Z, E + S, limit) == state
    sr = ts.shared_precompute_ref(inputs, S, nz)
    m1 = ts._launch_pack_member(emulated, inputs, sr, o, a, l, r, S, None, None, NULL_STREAM,
                                smem_limit=limit)
    _assert_members(m1, ts.pack_member_ref(inputs, sr, o, a, l, r, S, nz))


def test_emulated_k2_tie_band_prefers_by_alpha(emulated):
    """One group of 8 pods and two options of 2 and 4 pods a node at the same
    per-pod rate, every other option priced out: lump and rate scores tie
    exactly, and only the portfolio's preference decides. Members with
    alpha >= 1 must open the larger nodes, the others the smaller ones."""
    (inputs, o, a, l, r, sw), S, nz = _inputs("ties")
    g = int(torch.argmax(inputs.count))
    small, large = (int(x) for x in torch.nonzero(inputs.compat[g] & inputs.opt_valid)[:2, 0])
    count = torch.zeros_like(inputs.count)
    count[g] = 8
    price = torch.ones_like(inputs.price)
    price[small], price[large] = 2e-3, 4e-3
    inputs = inputs._replace(count=count, price=price)
    sr = ts.shared_precompute_ref(inputs, S, nz)
    units = sr.units.clone()
    units[g, small], units[g, large] = 2, 4
    sr = sr._replace(units=units, units_rsv=units)
    m1 = ts._launch_pack_member(emulated, inputs, sr, o, a, l, r, S, None, None, NULL_STREAM)
    want = ts.pack_member_ref(inputs, sr, o, a, l, r, S, nz)
    _assert_members(m1, want)
    for k in range(o.shape[0]):
        opened = set(want.new_opt[k][want.new_active[k]].tolist())
        assert opened == ({large} if float(a[k]) >= 1.0 else {small}), (k, float(a[k]), opened)


def test_emulated_k2_wrapping_fit_sums(emulated):
    """A group that demands nothing fits 2^30 pods on every open slot, so the
    int32 sums of its fits wrap, as the plain version's cumsum does: K2 then
    sums its places instead of taking min(count, total fit)."""
    (inputs, o, a, l, r, sw), S, nz = _inputs("existing")
    g = int(torch.argmax(inputs.count))
    inputs = inputs._replace(demand=inputs.demand.clone(), demand_units=inputs.demand_units.clone())
    inputs.demand[g] = 0.0
    inputs.demand_units[g] = 0.0
    sr = ts.shared_precompute_ref(inputs, S, nz)
    assert int(sr.units[g].max()) == 1 << 30
    m1 = ts._launch_pack_member(emulated, inputs, sr, o, a, l, r, S, None, None, NULL_STREAM)
    _assert_members(m1, ts.pack_member_ref(inputs, sr, o, a, l, r, S, nz))


def _fleet_inputs():
    """Three distinct problems and one pad row stacked on one bucket."""
    problems = []
    for case in ("topology", "crossgroup", "ties"):
        shapes, _ = {"topology": _small_topology, "crossgroup": _small_crossgroup,
                     "ties": _ties}[case]()
        problems.append(encode(configs.pods_from_shapes(shapes),
                               [(Provisioner(meta=ObjectMeta(name="default")),
                                 generate_catalog(n_types=12))], []))
    solver = TorchSolver(device="cpu")
    keys = [solver._bucket_key(p) for p in problems]
    assert len({(k.E, k.R, k.K) for k in keys}) == 1
    key = keys[0]._replace(G=max(k.G for k in keys), O=max(k.O for k in keys),
                           Z=max(k.Z for k in keys), S=32)
    rows = [solver._prepare(p, bucket=key)[:6] for p in problems] + [ts.fleet_padding(key)]
    fields = {f: np.stack([r[0][f] for r in rows]) for f in ts.PackInputs._fields}
    for i, f in enumerate(("orders", "alphas", "looks", "rsvs", "swaps"), 1):
        fields[f] = np.stack([r[i] for r in rows])
    return ts.pack_inputs_from_numpy(fields, "cpu"), key


def test_emulated_batched_kernels_match_plain_versions(emulated):
    """B=4 (three problems and a pad row) through one launch of each kernel:
    row by row equal to the plain versions and to the B=1 launches, the pad
    row placing nothing at cost 0."""
    (inputs, o, a, l, r, sw), key = _fleet_inputs()
    S, nz = key.S, key.Z
    sk = ts._launch_shared_precompute(emulated, inputs, S, NULL_STREAM)
    sr = ts.shared_precompute(inputs, S, nz)
    for f in ts.Shared._fields:
        assert torch.equal(getattr(sk, f), getattr(sr, f)), f
    m1 = ts._launch_pack_member(emulated, inputs, sk, o, a, l, r, S, None, None, NULL_STREAM)
    _assert_members(m1, ts.pack_member(inputs, sr, o, a, l, r, S, nz))
    m2 = ts._launch_pack_member(emulated, inputs, sk, o, a, l, r, S, sw, m1.cost, NULL_STREAM)
    _assert_members(m2, ts.pack_member(inputs, sr, o, a, l, r, S, nz, swaps=sw, seed_costs=m1.cost))
    # the groups and per-step state in global scratch, each row at its own offset
    G, O, E, R, Z = ts._dims(inputs)
    limit = _spill_limits(emulated, G, O, R, Z, E + S)[2]
    g2 = ts._launch_pack_member(emulated, inputs, sk, o, a, l, r, S, sw, m1.cost, NULL_STREAM,
                                smem_limit=limit)
    for f in MemberFields:
        assert torch.equal(getattr(g2, f), getattr(m2, f)), f
    buf = ts._launch_pack_epilogue(emulated, m1, m2, NULL_STREAM)
    assert buf.shape[0] == 4
    assert torch.equal(buf, ts.pack_epilogue(m1, m2))
    assert bool(r[1].any()) and not bool(r[0].any())  # the rows differ in kind
    for b in range(3):
        row = ts._row(inputs, b)
        s1 = ts._launch_shared_precompute(emulated, row, S, NULL_STREAM)
        p1 = ts._launch_pack_member(emulated, row, s1, o[b], a[b], l[b], r[b], S, None, None,
                                    NULL_STREAM)
        p2 = ts._launch_pack_member(emulated, row, s1, o[b], a[b], l[b], r[b], S, sw[b], p1.cost,
                                    NULL_STREAM)
        assert torch.equal(ts._launch_pack_epilogue(emulated, p1, p2, NULL_STREAM), buf[b])
    assert int(buf[3, 3]) == 0 and not bool(m1.cost[3].any()) and not bool(m2.cost[3].any())


def _random_rows(B, G, O, E, R, Z, seed):
    """B distinct random problems of one shape, as stacked PackInputs. Some
    groups have no pods, some demand nothing on an axis, some options are
    invalid or fit no group; row 1's group 2 fits no option with its
    reserve, so its reserve-sized units fall back to the raw ones."""
    rng = np.random.default_rng(seed)
    demand = rng.uniform(0.05, 1.0, (B, G, R)).astype(np.float32)
    demand[rng.random((B, G, R)) < 0.1] = 0.0
    count = rng.integers(0, 60, (B, G)).astype(np.int32)
    count[:, -2:] = 0  # padded groups
    demand[:, -2:] = 0.0
    demand_units = demand.copy()
    rsv = rng.random((B, G)) < 0.3
    demand_units[rsv] += rng.uniform(0.0, 2.0, (int(rsv.sum()), R)).astype(np.float32)
    demand[1, 2] = [0.1] * R
    demand_units[1, 2] = [100.0] * R  # no option holds a pod and its reserve
    node_cap = np.where(rng.random((B, G)) < 0.3, rng.integers(1, 6, (B, G)), 1 << 30).astype(np.int32)
    quota = np.where(rng.random((B, G, Z)) < 0.3, rng.integers(0, 40, (B, G, Z)), 1 << 30).astype(np.int32)
    quota[0] = 1 << 30  # row 0 has no zone-limited group
    compat = rng.random((B, G, O)) < 0.7
    compat[:, 3] = False  # a group no option takes: lam 0
    opt_valid = rng.random((B, O)) < 0.9
    ex_valid = rng.random((B, E)) < 0.8
    fields = dict(
        demand=demand, demand_units=demand_units, count=count, node_cap=node_cap, quota=quota,
        colocate=rng.random((B, G)) < 0.3, compat=compat,
        alloc=rng.uniform(0.0, 8.0, (B, O, R)).astype(np.float32),
        price=rng.uniform(0.01, 3.0, (B, O)).astype(np.float32),
        opt_zone=rng.integers(0, Z, (B, O)).astype(np.int32), opt_valid=opt_valid,
        ex_rem=rng.uniform(0.0, 4.0, (B, E, R)).astype(np.float32),
        ex_zone=rng.integers(0, Z, (B, E)).astype(np.int32),
        ex_compat=rng.random((B, G, E)) < 0.5, ex_valid=ex_valid,
        **{f: np.zeros((B, n), np.int32) for f, n in (
            ("rel_set", G), ("rel_host_forbid", G), ("rel_host_need", G), ("rel_zone_forbid", G),
            ("rel_zone_need", G), ("rel_slot_bits", E), ("rel_zone_bits", Z))},
    )
    return ts.PackInputs(**{f: torch.from_numpy(np.ascontiguousarray(v)).to(ts._FIELD_DTYPES[f])
                            for f, v in fields.items()})


@pytest.mark.parametrize("B, G, O, R", [(3, 13, 150, 3), (2, 9, 70, 4)])
def test_emulated_k1_tiles_match_plain_version(emulated, B, G, O, R):
    """K1 where its tilings bite. At (3, 13, 150, 3): O = 150 options over
    three blocks' worth of k1_units' options (64 in the emulation) in two
    tiles (its tiles capped at 2 there), and ten of k1_val_pair's tiles
    (16), the last of each partial; G = 13 groups over two chunks (8) of the
    table's groups g' and four blocks of four rows g, a multiple of neither
    a warp nor a tile; B = 3 distinct rows. At (2, 9, 70, 4): four resources
    (the kernels' instances for any R; three has its own) and one group g a
    k1_val_pair block. Every field equals the plain version's, bit for bit,
    row by row. Row 1 has a group no option fits with its reserve, whose
    fallback to the raw units crosses every tile."""
    E, Z, S = 5, 3, 40
    inputs = _random_rows(B, G, O, E, R, Z, seed=11 + R)
    sk = ts._launch_shared_precompute(emulated, inputs, S, NULL_STREAM)
    for b in range(B):
        sr = ts.shared_precompute_ref(ts._row(inputs, b), S, Z)
        for f in ts.Shared._fields:
            assert torch.equal(getattr(sk, f)[b], getattr(sr, f)), (b, f)
    # what the rows reach, so that the test covers what it is named for
    row = ts._row(inputs, 1)
    ok = row.compat & row.opt_valid[None, :]
    assert not bool(((ts._units(row.alloc[None], row.demand_units[2][None, None]) > 0) & ok[2]).any())
    assert bool(sk.units_rsv[1, 2].any()) and torch.equal(sk.units_rsv[1, 2], sk.units[1, 2])
    assert float(sk.lam[0, 3]) == 0.0 and bool(sk.lam.gt(0).any(1).all())
    assert bool(sk.zone_limited[1:].any()) and not bool(sk.zone_limited[0].any())
    assert bool(sk.rsv_group.any()) and bool(sk.exok_pad.any()) and bool(sk.val_pair.gt(0).any())


#: member costs on which a `<` scan and torch.argmin disagree: NaN first and
#: later, NaN at the minimum's place, +-inf, ties within and across phases,
#: -0.0 beside +0.0, every cost NaN
NAN, INF = float("nan"), float("inf")
COST_SETS = [
    ([3.0, 1.0, NAN, 0.5, NAN, 4.0, 5.0, 6.0], [2.0] * 8),
    ([2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0], [5.0, NAN, 1.0, 1.0, 6.0, 7.0, 8.0, 9.0]),
    ([3.0, -INF, 4.0, -INF, 5.0, INF, 6.0, 7.0], [INF, -INF, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]),
    ([3.0, 1.0, 4.0, 1.0, 5.0, 6.0, 7.0, 8.0], [1.0, 9.0, 1.0, 9.0, 9.0, 9.0, 9.0, 9.0]),
    ([3.0, INF, 0.0, 4.0, 5.0, 6.0, 7.0, 8.0], [9.0, 9.0, 9.0, -0.0, 9.0, 9.0, 9.0, 9.0]),
    ([NAN] * 8, [NAN] * 8),
]


def _members(K, T, NS, S, B, seed):
    """B rows of two phases' member outputs of the given widths, random."""
    rng = np.random.default_rng(seed)

    def one():
        return ts.MemberOut(
            cost=torch.from_numpy(rng.uniform(1.0, 9.0, (B, K)).astype(np.float32)),
            unplaced=torch.from_numpy(rng.integers(0, 50, (B, K)).astype(np.int32)),
            exhausted=torch.from_numpy(rng.random((B, K)) < 0.5),
            new_opt=torch.from_numpy(rng.integers(-1, 99, (B, K, S)).astype(np.int32)),
            new_active=torch.from_numpy(rng.random((B, K, S)) < 0.5),
            ys=torch.from_numpy(rng.integers(0, 1 << 20, (B, K, T, NS)).astype(np.int32)),
        )

    return one(), one()


def test_emulated_k3_alignment_and_nan_costs(emulated):
    """K3 on buffers whose ys region starts 16-byte aligned with its source
    and on ones where it does not (row by row, at several widths, over
    several of its blocks), on member costs with NaN, +-inf and ties: equal
    to the plain version, whose argmin is jnp.argmin's, bit for bit."""
    aligned = set()
    for K, T, NS, S in ((8, 20, 33, 6), (8, 16, 40, 7), (3, 21, 31, 5), (5, 9, 64, 4)):
        B = 3
        m1, m2 = _members(K, T, NS, S, B, seed=K * T + NS)
        L = 4 + 4 * K + 2 * S + T * NS
        assert L > 256  # several of the emulated K3's 256-int tiles
        assert m1.ys.data_ptr() % 16 == 0 and m2.ys.data_ptr() % 16 == 0
        sets = [(c1[:K], c2[:K]) for c1, c2 in COST_SETS] + [(None, None)]
        for c1, c2 in sets:
            if c1 is not None:
                rep = lambda c: torch.tensor([c] * B, dtype=torch.float32)
                m1, m2 = m1._replace(cost=rep(c1)), m2._replace(cost=rep(c2))
            buf = ts._launch_pack_epilogue(emulated, m1, m2, NULL_STREAM)
            for b in range(B):
                want = ts.pack_epilogue_ref(ts._row(m1, b), ts._row(m2, b))
                assert torch.equal(buf[b], want), (K, T, NS, S, c1, b)
                costs = np.concatenate([m1.cost[b].numpy(), m2.cost[b].numpy()])
                best = int(jnp.argmin(jnp.asarray(costs)))
                assert (int(buf[b, 0]), int(buf[b, 2])) == (int(best >= K), best % K)
                assert int(buf[b, 1]) == int(jnp.argmin(jnp.asarray(costs[:K])))
                bk = int(buf[b, 2])
                src = (m2 if buf[b, 0] else m1).ys[b, bk]
                dst_off = (b * L + 4 + 4 * K + 2 * S) * 4
                src_off = (b * K + bk) * T * NS * 4
                aligned.add((dst_off - src_off) % 16 == 0)
                assert torch.equal(buf[b, L - T * NS:], src.reshape(-1))
    assert aligned == {True, False}


def test_emulated_k2_phase2_seed_takes_first_nan(emulated):
    """K2's phase 2 seeded by phase-1 costs holding NaN: the seed is the
    first NaN, as phase2_members' torch.argmin and jnp.argmin pick it, and
    the outputs are the plain version's. The costs are chosen so that a
    `<` scan picks another member, whose phase 2 differs."""
    (inputs, o, a, l, r, sw), S, nz = _inputs("exhaustion")
    sr = ts.shared_precompute_ref(inputs, S, nz)
    for costs in ([0.5, 3.0, 3.0, 3.0, 3.0, NAN, 3.0, 3.0], [2.0, NAN, 1.0, 3.0, 4.0, 5.0, 6.0, 7.0]):
        seed = torch.tensor(costs, dtype=torch.float32)
        first_nan = costs.index(next(c for c in costs if c != c))
        assert int(torch.argmin(seed)) == int(jnp.argmin(jnp.asarray(costs))) == first_nan
        got = ts._launch_pack_member(emulated, inputs, sr, o, a, l, r, S, sw, seed, NULL_STREAM)
        o2, a2, l2, r2 = ts.phase2_members(o, a, l, r, sw, seed)
        want = ts.pack_member_ref(inputs, sr, o2, a2, l2, r2, S, nz)
        _assert_members(got, want)
        # the member a `<` scan seeds from gives another phase 2
        lt = 0
        for j in range(1, len(costs)):
            lt = j if costs[j] < costs[lt] else lt
        assert lt != first_nan
        onehot = torch.full_like(seed, 9.0)
        onehot[lt] = 0.0
        other = ts.pack_member_ref(inputs, sr, *ts.phase2_members(o, a, l, r, sw, onehot), S, nz)
        assert any(not torch.equal(getattr(other, f), getattr(want, f)) for f in MemberFields)


def test_emulated_staging_kernels_match_plain_versions(emulated):
    rng = np.random.default_rng(3)
    for shape, dtype in (((16, 512), np.bool_), ((16,), np.int32), ((512, 3), np.float32),
                         ((8, 3), np.float32)):
        dst = torch.from_numpy((rng.random(shape) * 100).astype(dtype))
        idx = torch.from_numpy(np.array([5, 1, 6, 5], np.int64) % shape[0])
        src = torch.from_numpy((rng.random((4,) + shape[1:]) * 100).astype(dtype))
        src[3] = src[0]  # a pow2 pad repeats the first row
        want = staging.stage_patch_ref(dst.clone(), idx, src)
        got = staging._launch_stage_patch(emulated, dst.clone(), idx, src, NULL_STREAM)
        assert torch.equal(got, want), (shape, dtype)

    rows = [{"a": torch.from_numpy(rng.random((16, 3)).astype(np.float32)),
             "b": torch.from_numpy(rng.random(7) < 0.5),
             "c": torch.from_numpy(rng.integers(0, 99, (5, 512)).astype(np.int32))}
            for _ in range(3)]
    rows.append(rows[2])  # pad rows repeat one staged row
    want = staging.fleet_stack_ref(rows)
    got = staging._launch_fleet_stack(emulated, rows, NULL_STREAM)
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def _patch_leaves(rng):
    """Resident leaves of 1-D and N-D shapes, of bool, int8, int16, int32
    and float32, with rows of 1, 4, 5, 12, 14, 16 and 512 bytes, one of them
    a view one byte off its allocation, so that every width of copy (16-byte
    vectors, words, bytes) and every unaligned edge runs."""
    shapes = (((16, 512), np.bool_), ((16,), np.int32), ((512, 3), np.float32),
              ((8, 3), np.float32), ((9, 5), np.int8), ((6, 7), np.int16), ((10, 4), np.float32),
              ((11,), np.int8))
    leaves = [torch.from_numpy((rng.random(shape) * 100).astype(dtype)) for shape, dtype in shapes]
    # contiguous, its first byte at an odd address
    leaves.append(torch.from_numpy(rng.integers(0, 99, 65).astype(np.int8))[1:].view(8, 8))
    return leaves


def _patch_of(rng, dst):
    n = dst.shape[0]
    idx = np.sort(rng.choice(n, size=int(rng.integers(1, n // 2 + 1)), replace=False)).astype(np.int64)
    src = np.ascontiguousarray((rng.random((len(idx),) + tuple(dst.shape[1:])) * 100)
                               .astype(dst.numpy().dtype))
    return idx, src


def test_emulated_batched_stage_patch_matches_index_copy(emulated):
    """One launch patches every leaf of a call from one packed buffer, as
    ``index_copy_`` would leaf by leaf; past a table's 128 entries, a second
    launch takes the rest."""
    rng = np.random.default_rng(11)
    leaves = _patch_leaves(rng)
    for copies, launches in ((1, 1), (15, 2)):
        dsts = [leaf.clone() for leaf in leaves for _ in range(copies)]
        patches = [(dst, *_patch_of(rng, dst)) for dst in dsts]
        want = [staging.stage_patch_ref(dst.clone(), torch.from_numpy(idx), torch.from_numpy(src))
                for dst, idx, src in patches]
        before = ts.LAUNCHES["stage_patch"]
        assert staging._launch_stage_patches(emulated, patches, NULL_STREAM) == launches
        assert ts.LAUNCHES["stage_patch"] - before == launches
        for (dst, _, _), w in zip(patches, want):
            assert torch.equal(dst, w), (tuple(dst.shape), dst.dtype)


@pytest.mark.parametrize("B", [4, 16])
def test_emulated_fleet_stack_matches_torch_stack(emulated, B):
    """B rows of a leaf set with 1-D and N-D leaves, rows of 15 bytes and of
    none, pad rows repeating one row: one launch, equal to ``torch.stack``."""
    rng = np.random.default_rng(B)
    real = [{"a": torch.from_numpy(rng.random((16, 3)).astype(np.float32)),
             "b": torch.from_numpy(rng.random(7) < 0.5),
             "c": torch.from_numpy(rng.integers(0, 99, (5, 512)).astype(np.int32)),
             "d": torch.from_numpy(rng.integers(0, 99, (3, 5)).astype(np.int8)),
             "e": torch.zeros((0, 4), dtype=torch.float32)}
            for _ in range(min(B, 5))]
    rows = [real[i] for i in range(len(real))] + [real[-1]] * (B - len(real))
    before = ts.LAUNCHES["fleet_stack"]
    got = staging._launch_fleet_stack(emulated, rows, NULL_STREAM)
    assert ts.LAUNCHES["fleet_stack"] - before == 1
    want = staging.fleet_stack_ref(rows)
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_emulated_fleet_stack_splits_a_large_table(emulated):
    """A table past one launch's room (64 leaf segments, 3,800 row sources)
    is split over launches: 70 leaves, then 4,000 rows of one leaf, both
    equal to ``torch.stack``."""
    rng = np.random.default_rng(7)
    many = [{f"l{k}": torch.from_numpy(rng.integers(0, 99, 1 + k % 5).astype(np.int16))
             for k in range(70)} for _ in range(4)]
    distinct = [{"x": torch.from_numpy(rng.integers(0, 99, 1).astype(np.int32))} for _ in range(3)]
    tall = [distinct[b % 3] for b in range(4000)]
    for rows, launches in ((many, 2), (tall, 2)):
        before = ts.LAUNCHES["fleet_stack"]
        got = staging._launch_fleet_stack(emulated, rows, NULL_STREAM)
        assert ts.LAUNCHES["fleet_stack"] - before == launches
        want = staging.fleet_stack_ref(rows)
        for name in want:
            assert torch.equal(got[name], want[name]), name


def test_emulated_rtt_probe_matches_plain_version(emulated):
    """``x + 1`` with int32 wrap-around, on the probe's own ``int32[8]``
    (one block, most threads idle) and on 300 values (ten blocks of 32, the
    last one partial)."""
    rng = np.random.default_rng(5)
    for n in (8, 300):
        x = torch.from_numpy(rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32))
        x[0], x[-1] = 2**31 - 1, -1
        got = ts._launch_rtt_probe(emulated, x, NULL_STREAM)
        assert torch.equal(got, ts.rtt_probe_ref(x)), n


# ---------------------------------------------------------------------------
# The meshed tier's kernels (solver/meshed.py) on logical CPU shards
# ---------------------------------------------------------------------------

from karpenter_tpu_torch import parallel  # noqa: E402
from karpenter_tpu_torch.solver import meshed  # noqa: E402


@pytest.fixture
def emulated_chain(emulated, monkeypatch):
    """Every wrapper of the chains launches the emulated kernels on CPU
    tensors: the meshed tier's (``meshed._plain`` answers no) and the
    un-meshed K1, K2 and K3 the chains call."""
    monkeypatch.setattr(meshed, "_plain", lambda t: False)
    monkeypatch.setattr(meshed, "_lib", lambda: emulated)
    monkeypatch.setattr(ts, "_stream", lambda: NULL_STREAM)
    monkeypatch.setattr(ts, "shared_precompute",
                        lambda i, s, z: ts._launch_shared_precompute(emulated, i, s, NULL_STREAM))
    monkeypatch.setattr(ts, "pack_member", lambda i, sh, o, a, l, r, s, z, swaps=None, seed_costs=None:
                        ts._launch_pack_member(emulated, i, sh, o, a, l, r, s, swaps, seed_costs,
                                               NULL_STREAM))
    monkeypatch.setattr(ts, "pack_epilogue",
                        lambda m1, m2: ts._launch_pack_epilogue(emulated, m1, m2, NULL_STREAM))

    def fused(i, o, a, l, r, sw, s, z):
        sh = ts.shared_precompute(i, s, z)
        m1 = ts.pack_member(i, sh, o, a, l, r, s, z)
        return ts.pack_epilogue(m1, ts.pack_member(i, sh, o, a, l, r, s, z, swaps=sw, seed_costs=m1.cost))

    monkeypatch.setattr(ts, "pack_solve_fused", fused)
    return fused


MESH_CASES = [("topology", "2d", (2, 1)), ("existing", "2d", (2, 1)), ("crossgroup", "2d", (2, 2)),
              ("ties", "1d", 2), ("exhaustion", "1d", 4), ("ties", "super", (2, 2))]


@pytest.mark.parametrize("case,kind,shape", MESH_CASES, ids=[f"{c}-{k}-{s}" for c, k, s in MESH_CASES])
def test_emulated_meshed_chain_equals_emulated_unmeshed(emulated_chain, case, kind, shape):
    """The emulated kernels over logical shards (each shard's launches, the
    exchanges as copies between them) answer what the emulated un-meshed
    chain answers, bit for bit: both sum member costs with k2_scan's
    partition of the emulated 64-thread blocks."""
    (inputs, o, a, l, r, sw), S, nz = _inputs(case)
    members = (o, a, l, r, sw)
    if kind == "super":
        # two rows: the fleet axis splits them, each row's columns split
        stack = lambda x: torch.stack([x, x]).contiguous()  # noqa: E731
        inputs, members = type(inputs)(*map(stack, inputs)), tuple(map(stack, members))
    want = emulated_chain(inputs, *members, S, nz)
    if kind == "1d":
        mesh = parallel.make_mesh(shape, devices=["cpu"] * shape)
        placed = parallel.shard_portfolio(mesh, inputs, *members)
    else:
        mesh = parallel.make_mesh2d(shape, devices=["cpu"] * (shape[0] * shape[1]))
        placed = (parallel.shard_superproblem(mesh, 2, inputs, *members) if kind == "super"
                  else parallel.shard_problem2d(mesh, inputs, *members))
    got = ts.pack_solve_meshed(mesh, *placed, S, nz)
    assert torch.equal(got, want)


def _split(inputs, n):
    """The option columns of one problem split over n shards, as
    ``shard_problem2d`` places them, batched as B=1."""
    mesh = parallel.make_mesh2d((n, 1), devices=["cpu"] * n)
    placed = parallel.shard_problem2d(mesh, inputs)[0]
    return [ts._unsqueeze(type(inputs)(*(p.shards[i] for p in placed))) for i in range(n)]


@pytest.mark.parametrize("case", ["topology", "existing", "relations", "ties"])
def test_emulated_shard_kernels_match_plain_versions(emulated, case, monkeypatch):
    """K1's part and finish and K2's stages on each of two option shards,
    against their plain versions run through the same exchanges: K1's
    outputs and every integer of K2's exactly, member costs to rtol 1e-6
    (block sums add in another order than torch's)."""
    (inputs, o, a, l, r, sw), S, nz = _inputs(case)
    shards = [meshed._Shard(parallel.make_mesh(2, devices=["cpu", "cpu"]), i) for i in range(2)]
    ins = _split(inputs, 2)
    members = [tuple(x.unsqueeze(0) for x in (o, a, l, r, sw))] * 2
    plain_k1 = meshed.shard_precompute_all(shards, ins, S)
    plain_m1 = meshed.shard_member_phase(shards, ins, plain_k1, members, S)
    plain_m2 = meshed.shard_member_phase(shards, ins, plain_k1, members, S, [m.cost for m in plain_m1])
    monkeypatch.setattr(meshed, "_plain", lambda t: False)
    monkeypatch.setattr(meshed, "_lib", lambda: emulated)
    monkeypatch.setattr(ts, "_stream", lambda: NULL_STREAM)
    k1 = meshed.shard_precompute_all(shards, ins, S)
    for got, want in zip(k1, plain_k1):
        for f in ("units", "units_rsv", "rsv_group", "lam", "zone_limited", "val_pair", "exok_pad"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    # the shards' K1 is the un-meshed K1's, split by columns
    whole = ts.shared_precompute_ref(inputs, S, nz)
    assert torch.equal(torch.cat([k.units[0] for k in k1], 1), whole.units)
    assert torch.equal(torch.cat([k.val_pair[0] for k in k1], 1), whole.val_pair)
    assert torch.equal(k1[0].lam[0], whole.lam)
    m1 = meshed.shard_member_phase(shards, ins, k1, members, S)
    for got, want in zip(m1, plain_m1):
        _assert_members(ts._row(got, 0), ts._row(want, 0))
    # phase 2 seeded from the plain phase 1, so that both scan alike
    m2 = meshed.shard_member_phase(shards, ins, k1, members, S, [m.cost for m in plain_m1])
    for got, want in zip(m2, plain_m2):
        _assert_members(ts._row(got, 0), ts._row(want, 0))


def _cpu_shards(n):
    return [meshed._Shard(parallel.make_mesh(n, devices=["cpu"] * n), i) for i in range(n)]


def test_emulated_member_argmin_on_nan_and_ties(emulated, monkeypatch):
    """The 1D mesh's member argmin (each shard's seed, the root's final
    pick) against its plain versions on costs holding NaN, +-inf and ties
    spread over four shards, each kernel reading the other shards' buffers
    in place and, with ``_shared_regions`` answering no, copies of them
    (counted in ``meshed.COPIES``): the seed and the winner are
    jnp.argmin's over the whole portfolio."""
    n, kl, G, T, NS, S, B = 4, 2, 5, 3, 9, 4, 2
    K = n * kl
    rng = np.random.default_rng(11)
    orders = torch.from_numpy(rng.permuted(np.tile(np.arange(G, dtype=np.int32), (n, B, kl, 1)), axis=-1))
    alphas = torch.from_numpy(rng.random((n, B, kl)).astype(np.float32))
    looks = torch.from_numpy(rng.random((n, B, kl)) < 0.5)
    rsvs = torch.from_numpy(rng.random((n, B, kl)) < 0.5)
    swaps = torch.from_numpy(rng.permuted(np.tile(np.arange(G, dtype=np.int32), (n, B, kl, 1)), axis=-1))
    shards = _cpu_shards(n)
    m1s, m2s = _members(kl, T, NS, S, B, seed=7)
    for c1, c2 in COST_SETS:
        c1 = torch.tensor([c1[:K]] * B, dtype=torch.float32).reshape(B, n, kl).transpose(0, 1).contiguous()
        c2 = torch.tensor([c2[:K]] * B, dtype=torch.float32).reshape(B, n, kl).transpose(0, 1).contiguous()
        # each shard's K3 buffer over its members
        bufs = [torch.stack([ts.pack_epilogue_ref(ts._row(m1s._replace(cost=c1[s]), b),
                                                  ts._row(m2s._replace(cost=c2[s]), b))
                             for b in range(B)]) for s in range(n)]
        phase1 = [(c1[s], orders[s], alphas[s], looks[s], rsvs[s]) for s in range(n)]
        outs = {}
        for mode in ("plain", "in place", "copies"):
            monkeypatch.setattr(meshed, "_plain", lambda t: mode == "plain")
            monkeypatch.setattr(meshed, "_lib", lambda: emulated)
            monkeypatch.setattr(ts, "_stream", lambda: NULL_STREAM)
            shared = mode != "copies"
            copies = dict(meshed.COPIES)
            seeds = [meshed.mesh_seed(*zip(*meshed._read_from(sh, shards, phase1, shared, "member_argmin")),
                                      swaps[s]) for s, sh in enumerate(shards)]
            seen = meshed._read_from(shards[0], shards, [(b,) for b in bufs], shared, "member_argmin")
            outs[mode] = (seeds, meshed.final_pick([b for b, in seen], seeds[0][4], kl))
            assert meshed.COPIES["member_argmin"] - copies["member_argmin"] == (
                0 if shared else 5 * n * (n - 1) + (n - 1)), mode
        for mode in ("in place", "copies"):
            for got, want in zip(outs[mode][0], outs["plain"][0]):
                for g, w in zip(got, want):
                    assert torch.equal(g, w), mode
            assert torch.equal(outs[mode][1], outs["plain"][1]), mode
        final = outs["in place"][1]
        flat1 = c1.transpose(0, 1).reshape(B, K)
        flat2 = c2.transpose(0, 1).reshape(B, K)
        for b in range(B):
            j = int(jnp.argmin(jnp.asarray(flat1[b].numpy())))
            assert all(int(seed[4][b, 0]) == j for seed in outs["in place"][0]) and j == int(final[b, 1])
            for s, seed in enumerate(outs["in place"][0]):
                assert torch.equal(seed[0][b], orders[j // kl, b, j % kl][swaps[s, b].long()])
            best = int(jnp.argmin(jnp.asarray(np.concatenate([flat1[b].numpy(), flat2[b].numpy()]))))
            assert (int(final[b, 0]), int(final[b, 2])) == (int(best >= K), best % K)
            costs = final[b, 4 : 4 + 2 * K].view(torch.float32)
            assert torch.equal(costs.view(torch.int32), torch.cat([flat1[b], flat2[b]]).view(torch.int32))


@pytest.mark.parametrize("case,n", [("topology", 2), ("relations", 4)])
def test_emulated_k1_finish_reads_the_partials_in_place_or_copied(emulated, monkeypatch, case, n):
    """K1 over n option shards, each shard's finish one launch reading every
    shard's partials through its table: in place, and with
    ``_shared_regions`` answering no, from copies (counted in
    ``meshed.COPIES``). Both equal the plain versions' and the un-meshed
    K1's, split by columns, bit for bit."""
    (inputs, o, a, l, r, sw), S, nz = _inputs(case)
    shards = _cpu_shards(n)
    ins = _split(inputs, n)
    plain = meshed.shard_precompute_all(shards, ins, S)
    whole = ts.shared_precompute_ref(inputs, S, nz)
    _on_emulated_shards(emulated, monkeypatch)
    for shared in (True, False):
        monkeypatch.setattr(meshed, "_shared_regions", lambda shards: shared)
        copies = meshed.COPIES["shard_precompute_finish"]
        launches = dict(meshed.LAUNCHES)
        k1 = meshed.shard_precompute_all(shards, ins, S)
        assert meshed.COPIES["shard_precompute_finish"] - copies == (0 if shared else n * (n - 1))
        assert {k: meshed.LAUNCHES[k] - launches[k] for k in launches} == {
            "shard_precompute_part": n, "shard_precompute_finish": n, "shard_member": 0, "member_argmin": 0}
        for got, want in zip(k1, plain):
            for f in ("units", "units_rsv", "rsv_group", "lam", "zone_limited", "val_pair", "exok_pad"):
                assert torch.equal(getattr(got, f), getattr(want, f)), (shared, f)
        assert torch.equal(torch.cat([k.val_pair[0] for k in k1], 1), whole.val_pair)
        assert torch.equal(torch.cat([k.units_rsv[0] for k in k1], 1), whole.units_rsv)
        assert all(torch.equal(k.lam[0], whole.lam) for k in k1)


def test_emulated_k1_finish_reduces_the_partials_of_forty_shards(emulated):
    """The finish's table of 40 buffers, more than a warp has lanes: each
    lane loops over the shards for its tile, and the reduction (a min, an
    any) equals the un-meshed K1's over one buffer bit for bit. The real
    partials are dealt over the 40 buffers, the rest of each buffer neutral
    (+inf, no fit); a table past the kernel's 64 shards is refused."""
    (inputs, o, a, l, r, sw), S, nz = _inputs("existing")
    x = ts._unsqueeze(inputs)
    B, G, O = 1, x.demand.shape[1], x.price.shape[-1]
    nt = int(emulated.kts_k1_tiles(O))
    part = torch.empty((2, B, G, nt), dtype=torch.int32)
    sp = meshed._launch_shard_precompute_part(emulated, x, S, part, NULL_STREAM)
    one = meshed._launch_shard_precompute_finish(emulated, x, sp, [part], NULL_STREAM)
    rng = np.random.default_rng(3)
    owner = torch.from_numpy(rng.integers(0, 40, size=(B, G, nt)))
    parts = []
    for i in range(40):
        p = torch.empty_like(part)
        p[0] = torch.where(owner == i, part[0], torch.tensor(1e30, dtype=torch.float32).view(torch.int32))
        p[1] = torch.where(owner == i, part[1], 0)
        parts.append(p)
    many = meshed._launch_shard_precompute_finish(emulated, x, sp, parts, NULL_STREAM)
    for f in ("lam", "units_rsv", "val_pair"):
        assert torch.equal(getattr(many, f), getattr(one, f)), f
    whole = ts.shared_precompute_ref(inputs, S, nz)
    assert torch.equal(one.val_pair[0], whole.val_pair) and torch.equal(one.lam[0], whole.lam)
    with pytest.raises(RuntimeError, match="shard_precompute_finish"):
        ts._raise_on(emulated, emulated.kts_k1_finish(*([None] * 12), meshed._table(parts * 2), 80,
                                                      B, G, O, 0, 3, 4, S, NULL_STREAM),
                     "shard_precompute_finish")


# ---------------------------------------------------------------------------
# The meshed K2 phase entry (``kts_k2m_phase``: one library call a phase)
# ---------------------------------------------------------------------------

#: (case, 2D mesh shape, where the shards sit: on one card (the regions
#: shared, the senders' rows read in place), or each on a card of its own,
#: with peer access (the regions shared) or without (each shard's own copy,
#: the exchanges copies into the receivers' rows)); sixteen shards go past any
#: fixed count of shards
PHASE_CASES = [("topology", (2, 1), "one card"), ("existing", (4, 1), "one card"),
               ("crossgroup", (2, 2), "copies"), ("relations", (2, 1), "peer"),
               ("ties", (16, 1), "one card")]


def _meshed(case, shape):
    """A case's problem placed once on a 2D mesh of CPU shards, and its chain."""
    (inputs, o, a, l, r, sw), S, nz = _inputs(case)
    members = (o, a, l, r, sw)
    mesh = parallel.make_mesh2d(shape, devices=["cpu"] * (shape[0] * shape[1]))
    placed = parallel.shard_problem2d(mesh, inputs, *members)
    return (inputs, members, S, nz), lambda: ts.pack_solve_meshed(mesh, *placed, S, nz)


def _on_emulated_shards(emulated, monkeypatch):
    monkeypatch.setattr(meshed, "_plain", lambda t: False)
    monkeypatch.setattr(meshed, "_lib", lambda: emulated)
    monkeypatch.setattr(ts, "_stream", lambda: NULL_STREAM)


@pytest.mark.parametrize("case,shape,cards", PHASE_CASES,
                         ids=[f"{c}-{s}-{w.replace(' ', '-')}" for c, s, w in PHASE_CASES])
def test_emulated_phase_entry_equals_per_stage_issue(emulated_chain, monkeypatch, case, shape, cards):
    """The phase entry issues each meshed K2 phase in one call (every
    shard's launches, events and waits from C): with the shards on one card
    (the senders' rows read in place), and each on a card of its own, with
    peer access (the shared regions read in place) and without (each
    shard's own copy, the exchanges copies into the receivers' rows). Every
    meshed buffer equals the emulated un-meshed chain's bit for bit, as
    does the per-stage issue's (``shard_member_step`` and ``_all_gather``
    from Python) on two shards and across cards. The 1D meshes (which run no K2 phase of their own) and a
    superproblem's phases take the phase entry in
    ``test_emulated_meshed_chain_equals_emulated_unmeshed``."""
    (inputs, members, S, nz), chain = _meshed(case, shape)
    want = emulated_chain(inputs, *members, S, nz)
    if cards != "one card":
        monkeypatch.setattr(meshed, "_device_index", lambda sh: sh.index)
        monkeypatch.setattr(meshed, "_shared_regions", lambda shards: cards == "peer")
    # the per-stage issue beside the entry where it is cheap to emulate
    for mode in ("stages", "entry") if shape[0] * shape[1] <= 2 or cards == "copies" else ("entry",):
        monkeypatch.setattr(meshed, "PHASE_MODE", mode)
        paths = dict(meshed.PHASE_PATHS)
        assert torch.equal(chain(), want), mode
        moved = {k: meshed.PHASE_PATHS[k] - paths[k] for k in paths}
        # a phase 1 and a phase 2 a chain
        assert moved == {k: 2 * (k == mode) for k in paths}, mode


def test_emulated_phase_entry_seeded_by_nan_and_ties(emulated, monkeypatch):
    """Phase 2 on two option shards seeded by phase-1 costs holding NaN,
    +-inf and ties (``COST_SETS``): the phase entry answers what the
    per-stage issue of the same kernels answers, bit for bit, and what the
    plain versions answer (member costs to rtol 1e-6)."""
    (inputs, o, a, l, r, sw), S, nz = _inputs("exhaustion")
    n, K = 2, o.shape[0]
    shards = [meshed._Shard(parallel.make_mesh(n, devices=["cpu"] * n), i) for i in range(n)]
    ins = _split(inputs, n)
    members = [tuple(x.unsqueeze(0) for x in (o, a, l, r, sw))] * n
    k1 = meshed.shard_precompute_all(shards, ins, S)
    _on_emulated_shards(emulated, monkeypatch)
    for c1, _ in COST_SETS:
        seed = [torch.tensor([c1[:K]], dtype=torch.float32)] * n
        outs = {}
        for mode in ("stages", "entry"):
            monkeypatch.setattr(meshed, "PHASE_MODE", mode)
            outs[mode] = meshed.shard_member_phase(shards, ins, k1, members, S, seed)
        for g, w in zip(outs["entry"], outs["stages"]):
            for f in MemberFields:
                assert torch.equal(getattr(g, f), getattr(w, f)), (c1, f)
        monkeypatch.setattr(meshed, "_plain", lambda t: True)
        plain = meshed.shard_member_phase(shards, ins, k1, members, S, seed)
        monkeypatch.setattr(meshed, "_plain", lambda t: False)
        for g, w in zip(outs["entry"], plain):
            _assert_members(ts._row(g, 0), ts._row(w, 0))


def test_emulated_phase_entry_counts_its_launches(emulated, monkeypatch):
    """A phase adds ``phase_launches(n, G)`` to ``LAUNCHES["shard_member"]``
    whichever way it is issued: each shard's begin and end and
    ``len(STAGES)`` launches a step, 4 G n + 2 n (five a step until the
    apply stage was folded into the next fill). The phase entry counts its
    launches where it makes them, in C."""
    (inputs, o, a, l, r, sw), S, nz = _inputs("ties")
    n, G = 2, o.shape[1]
    assert meshed.STAGES == ("fill", "pick", "tail", "tail_pick")
    assert meshed.phase_launches(n, G) == 4 * G * n + 2 * n
    shards = [meshed._Shard(parallel.make_mesh(n, devices=["cpu"] * n), i) for i in range(n)]
    ins = _split(inputs, n)
    members = [tuple(x.unsqueeze(0) for x in (o, a, l, r, sw))] * n
    _on_emulated_shards(emulated, monkeypatch)
    k1 = meshed.shard_precompute_all(shards, ins, S)
    for mode in ("entry", "stages"):
        monkeypatch.setattr(meshed, "PHASE_MODE", mode)
        before, paths = meshed.LAUNCHES["shard_member"], dict(meshed.PHASE_PATHS)
        meshed.shard_member_phase(shards, ins, k1, members, S)
        assert meshed.LAUNCHES["shard_member"] - before == meshed.phase_launches(n, G), mode
        assert {k: meshed.PHASE_PATHS[k] - paths[k] for k in paths} == {
            k: int(k == mode) for k in paths}, mode


def test_emulated_phase_entry_raises_on_a_refused_phase(emulated, monkeypatch):
    """A phase the entry refuses (here a shard whose arguments name another
    shard) raises, launches nothing and counts nothing: no fallback to the
    per-stage issue."""
    (inputs, o, a, l, r, sw), S, nz = _inputs("ties")
    n = 2
    shards = [meshed._Shard(parallel.make_mesh(n, devices=["cpu"] * n), i) for i in range(n)]
    ins = _split(inputs, n)
    members = [tuple(x.unsqueeze(0) for x in (o, a, l, r, sw))] * n
    _on_emulated_shards(emulated, monkeypatch)
    k1 = meshed.shard_precompute_all(shards, ins, S)
    args = meshed._k2m_args

    def misplaced(ms):
        ptrs, dims = args(ms)
        return ptrs, dims[:-1] + [0]  # every shard says it is shard 0

    monkeypatch.setattr(meshed, "_k2m_args", misplaced)
    before, paths = dict(meshed.LAUNCHES), dict(meshed.PHASE_PATHS)
    with pytest.raises(RuntimeError, match="shard_member phase"):
        meshed.shard_member_phase(shards, ins, k1, members, S)
    assert meshed.LAUNCHES == before and meshed.PHASE_PATHS == paths
