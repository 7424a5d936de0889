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
staged bytes exactly. This checks the kernels' logic only; that nvcc builds
them and that they run on the card is chip_smoke.py's job.
"""

import ctypes
import os
import re
import shutil
import subprocess
from pathlib import Path

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
        src, n = re.subn(r"constexpr int (k\w*Threads) = \d+;", r"constexpr int \1 = 64;", src)
        # few blocks, so that the grid-stride loops wrap
        src = re.sub(r"constexpr long long kMaxBlocks = \d+;", "constexpr long long kMaxBlocks = 2;", src)
        assert n >= 1 and "<<<" not in src
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


def _inputs(case):
    shapes, existing = {"topology": _small_topology, "crossgroup": _small_crossgroup,
                        "existing": _existing, "exhaustion": _plain, "ties": _ties}[case]()
    problem = encode(configs.pods_from_shapes(shapes),
                     [(Provisioner(meta=ObjectMeta(name="default")),
                       generate_catalog(n_types=12))], existing)
    fields, orders, alphas, looks, rsvs, swaps, s_new, nz = TorchSolver(device="cpu")._prepare(problem)
    tensors = ts.pack_inputs_from_numpy(
        dict(fields, orders=orders, alphas=alphas, looks=looks, rsvs=rsvs, swaps=swaps), "cpu"
    )
    return tensors, (8 if case == "exhaustion" else s_new), nz


def _assert_members(got, want):
    for f in ("unplaced", "exhausted", "new_opt", "new_active", "ys"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    torch.testing.assert_close(got.cost, want.cost, rtol=1e-6, atol=0)


@pytest.mark.parametrize("case", ["topology", "crossgroup", "existing", "exhaustion", "ties"])
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
