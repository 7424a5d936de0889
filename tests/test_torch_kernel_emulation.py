"""The CUDA kernels' own source, run on the CPU.

``csrc/pack_solve.cu`` is compiled with the host C++ compiler against
``tests/cuda_emu/cuda_runtime.h``, which runs each block's threads as OS
threads with real barriers and warp exchanges, and with the blocks cut to 64
threads so that every block-wide scan and reduction spans several chunks.
The kernels' launch entry points (``torch_solver._launch_*``) then run on CPU
tensors and must reproduce the plain PyTorch versions: every integer output
exactly, lam and val_pair exactly, member costs to rtol 1e-6 (block sums add
in another order than torch's). This checks the kernels' logic only; that
nvcc builds them and that they run on the card is chip_smoke.py's job.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from karpenter_tpu_torch import configs
from karpenter_tpu_torch.api import (
    Node, ObjectMeta, PodAffinityTerm, Provisioner, TopologySpreadConstraint,
)
from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.cloudprovider import generate_catalog
from karpenter_tpu_torch.solver import ExistingNode, TorchSolver, encode
from karpenter_tpu_torch.solver import _build
from karpenter_tpu_torch.solver import torch_solver as ts

TESTS = Path(__file__).resolve().parent
NULL_STREAM = ctypes.c_void_p(0)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernels")
    src = (_build.CSRC / "pack_solve.cu").read_text()
    src = re.sub(r"(\w+)<<<(.*?)>>>\((\w+)\);", r"emu_launch(\1, \2, \3);", src, flags=re.S)
    src, n = re.subn(r"constexpr int kK(\d)Threads = \d+;", r"constexpr int kK\1Threads = 64;", src)
    assert n == 3 and "<<<" not in src
    out = tmp_path_factory.mktemp("emu")
    (out / "pack_solve.cpp").write_text(src)
    lib = out / "libpack_solve_emu.so"
    subprocess.run(
        [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
         f"-I{TESTS / 'cuda_emu'}", "-o", str(lib), str(out / "pack_solve.cpp")],
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
