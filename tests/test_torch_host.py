"""The port's host race competitors against the JAX package's, on the CPU.

The same pods, catalog and existing nodes are encoded by each package
(``test_torch_solver._case``); each host competitor then runs on its own
package's problem: ``host.solve_host`` with no deadline (the deterministic
pipeline) and on a repeat solve with a far deadline (the adaptive tail:
pattern CG, the joint existing+new repack master, the ruin-recreate sweep),
``_solve_host_pack`` (the numpy FFD members), ``topo.topo_improve`` (the
zone-decomposed pattern CG) and ``GreedySolver``. Costs must agree to 1e-9
relative and the new nodes must be equal as a multiset of (option name, pod
count). Both packages' process-wide caches are cleared before each case.
"""

import time
from collections import Counter

import pytest
import torch

import karpenter_tpu.solver.patterns as rpatterns
import karpenter_tpu.solver.repack as rrepack
import karpenter_tpu.solver.topo as rtopo
import karpenter_tpu_torch.solver.patterns as ppatterns
import karpenter_tpu_torch.solver.repack as prepack
import karpenter_tpu_torch.solver.topo as ptopo
import bench
from karpenter_tpu.solver import TPUSolver
from karpenter_tpu.solver import encode as ref_encode
from karpenter_tpu.solver.host import solve_host as ref_solve_host
from karpenter_tpu.solver.solver import KERNEL_BOARD as REF_BOARD
from karpenter_tpu.solver.solver import GreedySolver as RefGreedy
from karpenter_tpu_torch import configs
from karpenter_tpu_torch.solver import TorchSolver, encode, validate
from karpenter_tpu_torch.solver.host import solve_host
from karpenter_tpu_torch.solver.solver import KERNEL_BOARD, GreedySolver
from karpenter_tpu_torch.solver.torch_solver import AOT_CACHE
from test_torch_solver import _build, _case, _ref_existing

CASES = ["full_2k", "topology_1k", "crossgroup_1k", "existing_nodes"]


def reset_caches():
    """Both packages' process-wide solver state: pattern pools, the repack
    and topology plan caches, the kernel breaker boards and the measured
    device round trip; and the port's dispatch-latency table (the
    reference's executables stay: recompiling them would cost each case
    seconds)."""
    for patterns, repack, topo in ((rpatterns, rrepack, rtopo), (ppatterns, prepack, ptopo)):
        patterns._pool_cache.clear()
        patterns._seen_problems.clear()
        for mod in (repack, topo):
            mod._state_cache.clear()
            mod._seen.clear()
    KERNEL_BOARD.reset()
    REF_BOARD.reset()
    AOT_CACHE.clear()
    TorchSolver._device_rtt_s = None
    TPUSolver._device_rtt_s = None


@pytest.fixture(autouse=True)
def _fresh_caches():
    reset_caches()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    reset_caches()


def node_multiset(result):
    return Counter((n.option.instance_type.name, n.option.zone, n.option.capacity_type,
                    len(n.pod_names)) for n in result.new_nodes)


def assert_same(got, want):
    if want is None:
        assert got is None
        return
    assert got is not None
    assert got.cost == pytest.approx(want.cost, rel=1e-9)
    assert node_multiset(got) == node_multiset(want)
    assert sorted(got.unschedulable) == sorted(want.unschedulable)
    assert got.stats["backend"] == want.stats["backend"]


@pytest.mark.parametrize("name", CASES)
def test_solve_host_matches_reference(name):
    ref, port = _case(name)
    got, want = solve_host(port, deadline=None), ref_solve_host(ref, deadline=None)
    assert_same(got, want)
    if want is not None:
        assert validate(port, got) == []
    else:
        assert name in ("topology_1k", "crossgroup_1k")  # not LP-safe


@pytest.mark.parametrize("name", ["full_5k", "existing_5k"])
def test_repeat_solve_host_adaptive_tail_matches_reference(name):
    """Repeat solves of a problem engage the closers: pattern CG (from
    4,000 pods, on the second solve) and, with existing nodes, the joint
    existing+new repack master (on the third) before
    ``evacuate_into_existing``. A far deadline lets each run to its end."""
    if name == "full_5k":
        ref, port = ref_encode(*bench._config_full(5000, 40)), encode(*configs.config_full(5000, 40))
    else:
        def rows(api):
            return [("a", 2000, "250m", "512Mi", {}), ("b", 1500, "500m", "1Gi", {}),
                    ("c", 1000, "1", "2Gi", {})]
        ref, port = _build(rows, 40, existing=_ref_existing(60))
    for _ in range(3):
        far = time.perf_counter() + 600.0
        got, want = solve_host(port, deadline=far), ref_solve_host(ref, deadline=far)
        assert_same(got, want)
    assert validate(port, got) == []
    if name == "existing_5k":
        assert got.existing_assignments
        assert id(port) in prepack._state_cache and id(ref) in rrepack._state_cache
    else:
        assert id(port) in ppatterns._pool_cache and id(ref) in rpatterns._pool_cache


def _pattern_counters():
    from karpenter_tpu.utils import metrics as rmetrics
    from karpenter_tpu_torch.utils import metrics as pmetrics

    return {pkg: (m.PATTERN_IMPROVEMENTS.value(), m.PATTERN_SAVINGS.value())
            for pkg, m in (("ref", rmetrics), ("port", pmetrics))}


@pytest.mark.parametrize("closer", ["patterns", "repack", "topo"])
def test_pattern_counters_move_as_the_references(closer):
    """``karpenter_tpu_pattern_improvements_total`` counts every solve a
    closer improved and ``karpenter_tpu_pattern_savings_dollars_total`` each
    problem's saving once, in both packages alike: pattern CG on repeat
    solves of full_5k, the existing+new repack master on 5,300 pods over
    200 existing nodes, the zone-decomposed topology CG on topology_1k."""
    before = _pattern_counters()
    if closer == "topo":
        ref, port = _case("topology_1k")
        solver, ref_solver = TorchSolver(device="cpu"), TPUSolver(auto_mesh=False)
        inc, ref_inc = solver._solve_host_pack(port), ref_solver._solve_host_pack(ref)
        for _ in range(3):
            far = time.perf_counter() + 600.0
            ptopo.topo_improve(port, solver, inc.cost, deadline=far, min_pods=0, incumbent=inc)
            rtopo.topo_improve(ref, ref_solver, ref_inc.cost, deadline=far, min_pods=0,
                               incumbent=ref_inc)
    else:
        if closer == "patterns":
            ref = ref_encode(*bench._config_full(5000, 40))
            port = encode(*configs.config_full(5000, 40))
        else:
            # 200 existing nodes: the joint master beats the refill-then-LP
            # incumbent here (at 60 it engages and finds nothing cheaper)
            def rows(api):
                return [("a", 3000, "100m", "256Mi", {}), ("b", 1500, "750m", "3Gi", {}),
                        ("c", 800, "2", "1Gi", {})]
            ref, port = _build(rows, 40, existing=_ref_existing(200))
        for _ in range(5):
            far = time.perf_counter() + 600.0
            solve_host(port, deadline=far)
            ref_solve_host(ref, deadline=far)
    after = _pattern_counters()
    moved = {k: (after[k][0] - before[k][0], after[k][1] - before[k][1]) for k in after}
    assert moved["port"][0] == moved["ref"][0] >= 1
    assert moved["port"][1] == pytest.approx(moved["ref"][1], rel=1e-9)
    assert moved["port"][1] > 0


def test_solve_host_50k_pinned():
    """The 50k_full host fast path with no deadline: the JAX package's
    ``solve_host`` gives 893.7080351044854 on this problem."""
    problem = encode(*configs.config_50k_full())
    result = solve_host(problem, deadline=None)
    assert result.cost == pytest.approx(893.7080351044854, rel=1e-9)
    assert not result.unschedulable and result.stats["backend"] == 2.0
    assert validate(problem, result) == []


@pytest.mark.parametrize("name", CASES)
def test_solve_host_pack_matches_reference(name):
    ref, port = _case(name)
    got = TorchSolver(device="cpu")._solve_host_pack(port)
    want = TPUSolver(auto_mesh=False)._solve_host_pack(ref)
    assert_same(got, want)
    assert got.stats["backend"] == 3.0
    assert validate(port, got) == []


@pytest.mark.parametrize("name", ["topology_1k", "crossgroup_1k"])
def test_topo_improve_matches_reference(name):
    """The zone-decomposed pattern CG with a far deadline, from its second
    call on a problem (the first only registers the problem): the same
    plan as the reference's, cheaper than the FFD incumbent."""
    ref, port = _case(name)
    solver, ref_solver = TorchSolver(device="cpu"), TPUSolver(auto_mesh=False)
    inc, ref_inc = solver._solve_host_pack(port), ref_solver._solve_host_pack(ref)
    for _ in range(2):
        far = time.perf_counter() + 600.0
        got = ptopo.topo_improve(port, solver, inc.cost, deadline=far, min_pods=0, incumbent=inc)
        want = rtopo.topo_improve(ref, ref_solver, ref_inc.cost, deadline=far, min_pods=0,
                                  incumbent=ref_inc)
        assert_same(got, want)
    assert got is not None and got.cost < inc.cost
    assert validate(port, got) == []


def _crossgroup_small(api):
    """Colocation and a joint spread at 144 pods: the greedy oracle checks
    every constraint against the evolving plan, pod by pod, and takes
    minutes on crossgroup_1k."""
    wk = api.labels
    rows = []
    for i in range(2):
        rows.append((f"db{i}", 8, "1", "2Gi", {"labels": {"app": f"db{i}", "tier": "data"}}))
        rows.append((f"web{i}", 24, "250m", "512Mi", {
            "labels": {"app": f"web{i}"},
            "affinity": [api.PodAffinityTerm({"app": f"db{i}"}, wk.HOSTNAME)],
        }))
    front = [api.TopologySpreadConstraint(max_skew=1, topology_key=wk.ZONE,
                                          label_selector={"tier": "front"})]
    for i in range(2):
        rows.append((f"front{i}", 40, "250m", "512Mi", {
            "labels": {"app": f"front{i}", "tier": "front"}, "spread": front}))
    return rows


@pytest.mark.parametrize("name", ["full_2k", "topology_1k", "crossgroup_small", "existing_nodes"])
def test_greedy_solver_matches_reference(name):
    ref, port = _build(_crossgroup_small, 40) if name == "crossgroup_small" else _case(name)
    got, want = GreedySolver().solve(port), RefGreedy().solve(ref)
    assert_same(got, want)
    assert got.stats["backend"] == 0.0
    assert validate(port, got) == []
