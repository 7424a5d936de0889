"""The reconcile entry points on the CPU: ``Solver.solve_pods``,
``encode_for_staging``, ``TorchSolver.solve_fleet``, problem interning and
the bounds, against the JAX package's on twin inputs.

Each package builds its own pods, provisioners and catalog from the same
rows. Both solvers run in quality mode (``latency_budget_s=5``,
``quality_race=True``; the reference with ``quality_sync=True``, which
compiles a cold bucket inline): the answer must have the reference's
backend, cost (1e-9 relative), problem digest, ``lower_bound`` (1e-12
relative), and relaxed and weight-degated pod counts. The three bounds
are held to 1e-9 relative. The fleet and latency-mode checks run the port
alone against its own serial loop.
"""

import time

import pytest
import torch

import bench
import karpenter_tpu.api as rapi
import karpenter_tpu_torch.api as papi
from karpenter_tpu.cloudprovider import generate_catalog as rcat
from karpenter_tpu.solver import TPUSolver
from karpenter_tpu.solver import bounds as rbounds
from karpenter_tpu.solver import encode as ref_encode
from karpenter_tpu_torch import configs
from karpenter_tpu_torch.cloudprovider import generate_catalog as pcat
from karpenter_tpu_torch.solver import (
    TorchSolver,
    best_lower_bound,
    encode,
    fractional_lower_bound,
    lp_lower_bound,
    validate,
)
from karpenter_tpu_torch.solver import solver as solver_mod
from karpenter_tpu_torch.solver.solver import _problems_content_equal, problem_digest
from test_torch_host import reset_caches
from test_torch_race import chains  # noqa: F401  (fixture)
from test_torch_solver import _small_topology

QUALITY = dict(latency_budget_s=5.0, quality_race=True)


@pytest.fixture(autouse=True)
def _fresh_caches():
    reset_caches()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    reset_caches()


def _rows_pods(api, rows):
    return [
        api.Pod(meta=api.ObjectMeta(name=f"{p}-{j}", labels=dict(kw.get("labels", {}))),
                requests=api.Resources(cpu=cpu, memory=mem),
                topology_spread=list(kw.get("spread", [])),
                affinity_terms=list(kw.get("affinity", [])))
        for p, n, cpu, mem, kw in rows for j in range(n)
    ]


def _relax_pods(api):
    """One pod whose only preference names a zone no offering has
    (``test_topology_seeding``'s relaxation case)."""
    wk = api.labels
    return [api.Pod(
        meta=api.ObjectMeta(name="soft"),
        requests=api.Resources(cpu="250m", memory="256Mi"),
        preferred_affinity_terms=[
            (1, api.Requirements([api.Requirement.in_values(wk.ZONE, ["zone-on-the-moon"])]))
        ],
    )]


def _degate_args(api, gen):
    """A weight-50 pool covering one zone and a weight-0 pool covering all
    three, and three pods under a hard zone spread
    (``test_provisioning``'s narrow-zone case, at the solver)."""
    wk = api.labels
    cat = gen(n_types=20)
    narrow = api.Provisioner(
        meta=api.ObjectMeta(name="narrow"), weight=50,
        requirements=api.Requirements([api.Requirement.in_values(wk.ZONE, ["zone-a"])]),
    )
    wide = api.Provisioner(meta=api.ObjectMeta(name="default"), weight=0)
    pods = [api.Pod(
        meta=api.ObjectMeta(name=f"sp-{i}", labels={"app": "wide"}),
        requests=api.Resources(cpu="250m", memory="256Mi"),
        topology_spread=[api.TopologySpreadConstraint(
            max_skew=1, topology_key=wk.ZONE, label_selector={"app": "wide"})],
    ) for i in range(3)]
    return pods, [(narrow, cat), (wide, cat)]


def _twin(name):
    """``solve_pods`` arguments ``(pods, provisioners)`` for the JAX
    package and for the port."""
    if name == "lp_safe_2k":
        ref, port = bench._config_full(2000, 40), configs.config_full(2000, 40)
        return ref[:2], port[:2]
    if name == "topology_1k":
        out = []
        for api, gen in ((rapi, rcat), (papi, pcat)):
            prov = api.Provisioner(meta=api.ObjectMeta(name="default"))
            out.append((_rows_pods(api, _small_topology()(api)), [(prov, gen(n_types=60))]))
        return tuple(out)
    if name == "relax":
        return tuple(
            (_relax_pods(api), [(api.Provisioner(meta=api.ObjectMeta(name="default")), gen(n_types=30))])
            for api, gen in ((rapi, rcat), (papi, pcat))
        )
    if name == "degate":
        return _degate_args(rapi, rcat), _degate_args(papi, pcat)
    raise ValueError(name)


@pytest.mark.parametrize("name,winner,relaxed,degated", [
    ("lp_safe_2k", 2.0, None, None),
    ("topology_1k", 1.0, None, None),
    ("relax", None, 1.0, None),
    ("degate", None, None, 2.0),
])
def test_solve_pods_matches_reference(name, winner, relaxed, degated):
    ref_args, port_args = _twin(name)
    want = TPUSolver(auto_mesh=False, quality_sync=True, **QUALITY).solve_pods(*ref_args)
    got = TorchSolver(device="cpu", **QUALITY).solve_pods(*port_args)
    assert got.stats["backend"] == want.stats["backend"]
    if winner is not None:
        assert got.stats["backend"] == winner
    assert got.cost == pytest.approx(want.cost, rel=1e-9)
    assert sorted(got.unschedulable) == sorted(want.unschedulable) == []
    assert got.problem_digest == want.problem_digest != ""
    assert got.stats["lower_bound"] == pytest.approx(want.stats["lower_bound"], rel=1e-12)
    assert got.stats.get("relaxed_pods") == want.stats.get("relaxed_pods") == relaxed
    assert got.stats.get("weight_degated_pods") == want.stats.get("weight_degated_pods") == degated
    for key in ("encode_s", "total_s"):
        assert got.stats[key] > 0
    assert "fallback" not in got.stats


@pytest.mark.parametrize("name", ["lp_safe_2k", "topology_1k", "relax", "degate"])
def test_bounds_match_reference(name):
    (rp, rprovs), (pp, pprovs) = _twin(name)
    ref, port = ref_encode(rp, rprovs), encode(pp, pprovs)
    for mine, theirs in ((fractional_lower_bound, rbounds.fractional_lower_bound),
                         (lp_lower_bound, rbounds.lp_lower_bound),
                         (best_lower_bound, rbounds.best_lower_bound)):
        got, want = mine(port), theirs(ref)
        assert (got is None) == (want is None)
        if want is not None:
            assert got == pytest.approx(want, rel=1e-9, abs=1e-12)
    assert solver_mod.lower_bound is fractional_lower_bound


# ---------------------------------------------------------------------------
# problem identity and interning
# ---------------------------------------------------------------------------

def _small(n=6, rename=None, cpu="250m"):
    pods = [papi.Pod(meta=papi.ObjectMeta(name=f"pod-{i}", owner_kind="ReplicaSet"),
                     requests=papi.Resources(cpu=cpu, memory="128Mi")) for i in range(n)]
    if rename is not None:
        pods[rename].meta.name = "renamed-pod"
    return pods, [(papi.Provisioner(meta=papi.ObjectMeta(name="default")), pcat(n_types=5))]


def test_identical_content_same_digest():
    a, b = encode(*_small()), encode(*_small())
    assert _problems_content_equal(a, b)
    assert problem_digest(a) == problem_digest(b)


def test_renamed_pod_changes_digest():
    a, b = encode(*_small()), encode(*_small(rename=2))
    assert not _problems_content_equal(a, b)
    assert problem_digest(a) != problem_digest(b)


def test_changed_demand_changes_digest():
    a, b = encode(*_small(cpu="250m")), encode(*_small(cpu="300m"))
    assert not _problems_content_equal(a, b)
    assert problem_digest(a) != problem_digest(b)


def test_digest_matches_reference_digest():
    from karpenter_tpu.solver.solver import problem_digest as ref_digest

    (rp, rprovs), (pp, pprovs) = _twin("topology_1k")
    assert problem_digest(encode(pp, pprovs)) == ref_digest(ref_encode(rp, rprovs))


def test_intern_refreshes_embedded_objects():
    """On an intern hit the cached problem hands back THIS encode's live
    objects (groups, options), not the prior generation's."""
    s = TorchSolver(portfolio=4, device="cpu")
    a, b = encode(*_small()), encode(*_small())
    assert s._intern_problem(a) is a
    assert s._intern_problem(b) is a
    assert a.groups is b.groups
    assert a.options is b.options
    for i in range(5):
        s._intern_problem(encode(*_small(n=7 + i)))
    assert len(s._interned_problems) == 4 and a not in s._interned_problems


def test_intern_hit_keeps_the_problem_resident(chains):
    """A repeat round of the same content interns onto the resident problem:
    its dispatch reads the tensors already staged, with no stage call."""
    pods, provs = configs.config_full(1000, 20)[:2]
    solver = TorchSolver(device="cpu")
    first = solver.solve_pods(pods, provs)
    (problem,) = solver._interned_problems
    assert solver._resident(problem) is not None and chains["fused"] == 1
    staged = solver._stager.last_round
    # forget the race's outcome so that the repeat dispatches again
    for k in ("_race_kernel_lost", "_race_kernel_result", "_race_miss_count", "_race_memory_at"):
        problem.__dict__.pop(k, None)
    again = solver.solve_pods(*configs.config_full(1000, 20)[:2])
    assert solver._interned_problems == [problem]
    assert chains["fused"] == 2
    assert solver._stager.last_round is staged
    assert again.problem_digest == first.problem_digest == problem_digest(problem).hex()
    assert again.cost == pytest.approx(first.cost, rel=1e-9)


# ---------------------------------------------------------------------------
# the fleet flow
# ---------------------------------------------------------------------------

def _fleet_requests(tag):
    prov = papi.Provisioner(meta=papi.ObjectMeta(name="default"))
    provs = [(prov, pcat(n_types=6))]
    return [
        {"pods": [papi.Pod(meta=papi.ObjectMeta(name=f"{tag}{i}-{j}", labels={"app": f"e{i}"}),
                           requests=papi.Resources(cpu="250m", memory="128Mi"))
                  for j in range(8 + i)],
         "provisioners": provs}
        for i in range(3)
    ]


def _placements(result):
    return sorted((n.option.instance_type.name, n.option.zone, tuple(sorted(n.pod_names)))
                  for n in result.new_nodes)


def test_solve_fleet_matches_serial_solve_pods(chains):
    """The batched entry answers what the serial loop answers, in one fleet
    chain where the loop takes one chain a problem."""
    fleet = TorchSolver(portfolio=4, device="cpu")
    fleet.race_min_pods = 0
    serial = TorchSolver(portfolio=4, device="cpu")
    serial.race_min_pods = 0
    out_fleet = fleet.solve_fleet(_fleet_requests("a"))
    assert chains == {"fused": 0, "fleet": 1}
    out_serial = [serial.solve_pods(**r) for r in _fleet_requests("a")]
    assert chains == {"fused": 3, "fleet": 1}
    for a, b in zip(out_fleet, out_serial):
        assert a.cost == pytest.approx(b.cost, rel=1e-9)
        assert sorted(a.unschedulable) == sorted(b.unschedulable)
        assert _placements(a) == _placements(b)
        assert a.problem_digest == b.problem_digest
    for r in out_fleet:
        if r.stats["backend"] == 1.0:
            assert r.stats["fleet_b"] == 4.0  # the kernel's answer came from the fleet row


def test_pre_encoded_solve_pods_identical_digest():
    """encode_for_staging + solve_pods(pre_encoded=...) gives the one-shot
    solve_pods' digest and cost, and books the staged encode time."""
    pods, provs = _small()
    s1, s2 = TorchSolver(portfolio=4, device="cpu"), TorchSolver(portfolio=4, device="cpu")
    staged = s1.encode_for_staging(pods, provs)
    assert staged.__dict__["_encode_mode"] == "full" and staged.__dict__["_pre_encode_s"] > 0
    r1 = s1.solve_pods(pods, provs, pre_encoded=staged)
    r2 = s2.solve_pods(pods, provs)
    assert r1.problem_digest == r2.problem_digest
    assert r1.cost == pytest.approx(r2.cost, rel=1e-9)
    assert r1.stats["encode_s"] > 0 and "_pre_encode_s" not in staged.__dict__


def test_session_rounds_through_solve_pods():
    """solve_pods with a session: a churn round delta-encodes, and its
    answer and digest are those of a sessionless solve of the same pods."""
    from karpenter_tpu_torch.solver import EncodeSession

    pods, provs, churn_round = configs.config_delta_reconcile(n_pods=1200, n_types=20)
    session = EncodeSession()
    solver = TorchSolver(device="cpu")
    solver.solve_pods(pods, provs, session=session)
    assert session.last_mode == "full"
    removed, added = churn_round(0)
    for p in removed:
        session.pod_event("DELETED", p)
    for p in added:
        session.pod_event("ADDED", p)
    gone = {p.name for p in removed}
    pods = [p for p in pods if p.name not in gone] + added
    got = solver.solve_pods(pods, provs, session=session)
    assert session.last_mode == "delta"
    (last,) = [p for p in solver._interned_problems if p.__dict__["_encode_mode"] == "delta"]
    want = TorchSolver(device="cpu").solve_pods(session.ordered_pods(), provs)
    assert got.problem_digest == want.problem_digest == problem_digest(last).hex()
    assert got.cost == pytest.approx(want.cost, rel=1e-9)
    assert validate(last, got) == []


# ---------------------------------------------------------------------------
# the latency budget counts from solve_pods' entry
# ---------------------------------------------------------------------------

def test_deadlines_count_from_entry(monkeypatch):
    seen = []
    host = solver_mod.solve_host

    def record(problem, deadline=None, spike_s=1.5):
        seen.append(deadline)
        return host(problem, deadline=deadline, spike_s=spike_s)

    monkeypatch.setattr(solver_mod, "solve_host", record)
    solver = TorchSolver(device="cpu")
    stamps = []
    solve = solver.solve

    def stamped(problem):
        stamps.append(problem.__dict__.get("_entry_t"))
        return solve(problem)

    solver.solve = stamped
    pods, provs = _small(n=40)
    solver.solve_pods(pods, provs)
    budget = min(solver.latency_budget_s * 0.85, 0.5)
    (entry,) = stamps
    assert seen == [entry + budget]
    (problem,) = solver._interned_problems
    assert "_entry_t" not in problem.__dict__  # popped by the solve
    t_before = time.perf_counter()
    solver.solve(problem)
    t_after = time.perf_counter()
    assert stamps[1] is None and len(seen) == 2
    assert t_before + budget <= seen[1] <= t_after + budget


def test_warm_problem_returns_the_bucket():
    problem = encode(*_small())
    solver = TorchSolver(device="cpu")
    assert solver.warm_problem(problem) == solver.warm_problem(problem, wait=False) == solver._bucket_key(problem)
