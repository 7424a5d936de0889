"""Offline replay on the CPU: ``karpenter_tpu_torch.replay`` against the
JAX package's capsules and its own.

* Cross replay: every round of ``test_torch_flightrecorder.ROUNDS`` is
  recorded by each package (on ``GreedySolver``, then on the quality
  solvers), and the port's ``replay_capsule`` on each capsule, after a JSON
  round trip, reports ``match`` (``greedy``, or ``tpu-quality`` and
  ``torch-quality``, which both map to ``TorchSolver(latency_budget_s=30,
  device="cpu")``). ``main([path, "--device", "cpu"])`` on the capsule's
  disk dump, which replays it with the solver the capsule names (set to
  the replay's: a quality solver's capsule names ``TPUSolver`` or
  ``TorchSolver``, which replay in latency mode), exits 0.
* The reference's ``TestReplayDeterminism`` checks that are not per round
  (the live decision ring stays clean, the batch order rebuilds) and its
  ``TestCounterfactuals`` (an offering mask diverts a placement, a raised
  limit schedules a blocked pod, ``limits.<r>=none`` removes one ceiling,
  a settings override, bad overrides), on the port.
* A ``federation`` capsule of either package replays: the arbiter's pure
  verdict and every sub-capsule, through ``replay_capsule`` and the CLI
  (``tests/test_torch_federation.py`` holds the rest of it).
* What the port refuses: without CUDA, the default ``device="cuda"``.
"""

from __future__ import annotations

import json

import pytest
import torch

from karpenter_tpu_torch.solver import TorchSolver

from test_torch_controller import (  # noqa: F401  (fixtures)
    PACKAGES,
    _fresh_caches,
    _host_paths_run_dry,
)
from test_torch_flightrecorder import (  # noqa: F401  (fixtures)
    ROUNDS,
    _fresh_rings,
    env,
    pkg_mod,
    roundtrip,
    twin_capsules,
)

REF, PORT = PACKAGES


@pytest.fixture
def port():
    return pkg_mod(PORT)


def replay_solver(mode: str, pkg: str) -> str:
    if mode == "greedy":
        return "greedy"
    return "tpu-quality" if pkg == REF else "torch-quality"


@pytest.mark.parametrize("source", PACKAGES)
@pytest.mark.parametrize("mode", ["greedy", "quality"])
@pytest.mark.parametrize("name", list(ROUNDS))
def test_port_replays_capsule(name, mode, source, tmp_path, capsys):
    capsules = twin_capsules(name, mode)[source]
    m = pkg_mod(PORT)
    for i, capsule in enumerate(capsules):
        report = m.replay.replay_capsule(roundtrip(capsule), solver=replay_solver(mode, source),
                                         device="cpu")
        assert report["match"] is True, report["diffs"]
        assert not report["counterfactual"] and not report["truncated_by_error"]
        if capsule["controller"] == "provisioning":
            assert report["diffs"]["digests_match"] and report["diffs"]["decisions_match"]
        # the CLI replays with the solver the capsule names: name the one
        # the round was recorded on (a quality solver's capsule says
        # "TPUSolver"/"TorchSolver", which replay in latency mode)
        path = tmp_path / f"capsule-{i}.json"
        path.write_text(json.dumps(dict(capsule, solver=replay_solver(mode, source)), default=str))
        assert m.replay.main([str(path), "--device", "cpu"]) == 0
        assert "MATCH" in capsys.readouterr().out


def test_replay_does_not_pollute_live_decision_ring(port):
    cluster, provider, ctl = env(port, n_pods=3)
    ctl.reconcile()
    capsule = roundtrip(port.fr.FLIGHT.latest("provisioning"))
    live_before = len(port.decisions.DECISIONS.query(limit=10000))
    n_capsules = len(port.fr.FLIGHT.list())
    report = port.replay.replay_capsule(capsule, solver="greedy", device="cpu")
    assert report["match"] is True and report["replayed"]["decisions"]
    live_after = port.decisions.DECISIONS.query(limit=10000)
    assert len(live_after) == live_before
    assert not any(r.reconcile_id.startswith("replay.") for r in live_after)
    assert len(port.fr.FLIGHT.list()) == n_capsules  # no capsule of the replay


def test_batch_order_reconstruction_preserves_canonical_order(port):
    cluster, provider, ctl = env(port, n_pods=5)
    ctl.reconcile()
    capsule = roundtrip(port.fr.FLIGHT.latest("provisioning"))
    rebuilt = port.replay.build_cluster(capsule)
    assert [p.name for p in rebuilt.pending_pods()] == capsule["inputs"]["batch_order"]


def test_replay_cli_end_to_end(port, tmp_path, capsys):
    cluster, provider, ctl = env(port, n_pods=3)
    ctl.reconcile()
    path = port.fr.FLIGHT.dump(port.fr.FLIGHT.list()[0]["id"], str(tmp_path))
    assert path.endswith(".json.gz")
    rc = port.replay.main([path, "--device", "cpu", "--solver", "greedy", "--explain", "pod=fr-0"])
    out = capsys.readouterr().out
    assert rc == 0 and "MATCH" in out and "pod fr-0" in out
    rc = port.replay.main([path, "--device", "cpu", "--solver", "greedy", "--json"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0 and report["match"] is True
    assert port.replay.main([str(tmp_path / "missing.json.gz"), "--device", "cpu"]) == 1


# -- counterfactuals (the reference's TestCounterfactuals) --------------------------


def test_offering_mask_diverts_placement(port):
    cluster, provider, ctl = env(port, n_pods=4)
    ctl.reconcile()
    capsule = roundtrip(port.fr.FLIGHT.latest("provisioning"))
    chosen = capsule["outputs"]["placements"]["fr-0"]
    override = (f"offerings={chosen['instance_type']}/{chosen['zone']}/"
                f"{chosen['capacity_type']}=unavailable")
    report = port.replay.replay_capsule(capsule, overrides=[override], solver="greedy",
                                        device="cpu")
    assert report["counterfactual"] is True
    replayed = report["replayed"]["placements"].get("fr-0")
    assert replayed is not None
    assert (replayed["instance_type"], replayed["zone"], replayed["capacity_type"]) \
        != (chosen["instance_type"], chosen["zone"], chosen["capacity_type"])


def test_limit_raise_schedules_blocked_pod(port):
    prov = port.api.Provisioner(meta=port.api.ObjectMeta(name="default"),
                                limits=port.api.Resources(cpu="1"))
    cluster, provider, ctl = env(port, n_pods=0, provisioner=prov)
    for i in range(4):
        cluster.add_pod(port.api.Pod(meta=port.api.ObjectMeta(name=f"blocked-{i}"),
                                     requests=port.api.Resources(cpu="900m", memory="512Mi")))
    assert ctl.reconcile().unschedulable
    capsule = roundtrip(port.fr.FLIGHT.latest("provisioning"))
    report = port.replay.replay_capsule(capsule, overrides=["provisioner.default.limits.cpu=100"],
                                        solver="greedy", device="cpu")
    assert report["counterfactual"] is True and report["replayed"]["unschedulable"] == []


def test_limits_none_removes_only_the_named_resource(port):
    prov = port.api.Provisioner(meta=port.api.ObjectMeta(name="default"),
                                limits=port.api.Resources(cpu="1", memory="1Gi"))
    cluster, provider, ctl = env(port, n_pods=1, provisioner=prov)
    ctl.reconcile()
    capsule = roundtrip(port.fr.FLIGHT.latest("provisioning"))
    out = port.replay.apply_overrides(capsule, ["provisioner.default.limits.cpu=none"])
    limits = out["inputs"]["objects"]["provisioners"][0]["limits"]
    assert "cpu" not in limits and "memory" in limits
    out2 = port.replay.apply_overrides(out, ["provisioner.default.limits.memory=none"])
    assert out2["inputs"]["objects"]["provisioners"][0]["limits"] is None


def test_settings_override_round_trips(port):
    cluster, provider, ctl = env(port, n_pods=2)
    ctl.reconcile()
    capsule = roundtrip(port.fr.FLIGHT.latest("provisioning"))
    report = port.replay.replay_capsule(capsule, overrides=["settings.encode_delta_enabled=false"],
                                        solver="greedy", device="cpu")
    assert report["counterfactual"] is True and report["diffs"]["digests_match"] is True


@pytest.mark.parametrize("bad", [
    "settings.no_such_field=1",
    "offerings=ghost/zone/ct=unavailable",
    "provisioner.ghost.limits.cpu=1",
    "nonsense=1",
    "settings.batch_max_duration=abc",
    "offerings=*/*/spot=price:cheap",
    "provisioner.default.weight=heavy",
    "provisioner.default.limits.cpu=lots",
    "risk.a/b=0.5",
    "risk.*/*/on-demand=1.5",
    "cluster.us-east.available=false",
])
def test_bad_overrides_rejected(bad, port, tmp_path, capsys):
    """Each bad override raises ``OverrideError`` in both packages, and the
    port's CLI exits 1 on it."""
    captured = {}
    for pkg in PACKAGES:
        m = pkg_mod(pkg)
        cluster, provider, ctl = env(m, n_pods=1)
        ctl.reconcile()
        captured[pkg] = roundtrip(m.fr.FLIGHT.latest("provisioning"))
        with pytest.raises(m.replay.OverrideError):
            m.replay.apply_overrides(captured[pkg], [bad])
    path = tmp_path / "capsule.json"
    path.write_text(json.dumps(captured[PORT]))
    assert port.replay.main([str(path), "--device", "cpu", "--override", bad]) == 1
    assert "bad override" in capsys.readouterr().err


def test_counterfactual_unmasks_an_ice_offering(port):
    """The override the card's storm replay uses: an offering the recorded
    round saw ICE-masked, made available again, runs as a counterfactual."""
    from test_torch_flightrecorder import round_ice

    capsule = roundtrip(round_ice(port, "greedy")[0])
    masked = {(o["zone"], o["capacityType"], it["name"])
              for types in capsule["inputs"]["instance_types"].values()
              for it in types for o in it["offerings"] if not o["available"]}
    ice = [d["details"] for d in capsule["outputs"]["decisions"] if d.get("outcome") == "ice-failed"]
    assert ice
    sel = f"{ice[0]['instance_type']}/{ice[0]['zone']}/{ice[0]['capacity_type']}"
    assert (ice[0]["zone"], ice[0]["capacity_type"], ice[0]["instance_type"]) not in masked
    report = port.replay.replay_capsule(capsule, overrides=[f"offerings={sel}=available"],
                                        solver="greedy", device="cpu")
    assert report["counterfactual"] is True and report["replayed"]["placements"]


# -- federation capsules ----------------------------------------------------------------


@pytest.mark.parametrize("source", PACKAGES)
def test_federation_capsule_replays(source, port, tmp_path, capsys):
    """A federated round of either package's ``FederatedFleet`` (a gang
    routed by lease, a region partitioned from the arbiter with a degraded
    decision) replays in the port: the verdict's digest and every
    sub-capsule match, and the CLI exits 0 and prints the federation
    report."""
    import importlib

    fleet_mod = importlib.import_module(f"{source}.federation.fleet")
    fr = importlib.import_module(f"{source}.utils.flightrecorder")
    fr.FLIGHT.configure(64)
    fleet = fleet_mod.FederatedFleet(n_types=6,
                                     settings_overrides={"interruption_penalty_cost": 0.5})
    fleet.add_gang("us-east", "train", members=2, regions="*")
    fleet.partition("us-west")
    fleet.add_pods("us-west", "cut", 2, regions="*")
    capsule = json.loads(json.dumps(fleet.run_round(), default=str))
    assert capsule["controller"] == "federation" and capsule["sub_capsules"]
    report = port.replay.replay_capsule(capsule, device="cpu")
    assert report["match"] is True, report["diffs"]
    assert report["diffs"]["verdict_match"] and report["diffs"]["sub_capsules_match"]
    assert report["diffs"]["degraded_assignments"] == 2
    path = tmp_path / "fed.json"
    path.write_text(json.dumps(capsule))
    assert port.replay.main([str(path), "--device", "cpu"]) == 0
    assert "(federation): MATCH" in capsys.readouterr().out


# -- what the port refuses -----------------------------------------------------------


def test_solver_names_of_both_packages(port):
    make = port.replay._make_solver
    for name in ("TPUSolver", "tpu", "TorchSolver", "torch", "unknown"):
        s = make({}, name, device="cpu")
        assert type(s).__name__ == "TorchSolver" and s.latency_budget_s == 0.1
    for name in ("tpu-quality", "torch-quality"):
        s = make({}, name, device="cpu")
        assert type(s).__name__ == "TorchSolver" and s.latency_budget_s == 30.0
        assert s.device.type == "cpu"
    assert type(make({"solver": "GreedySolver"}, None, device="cpu")).__name__ == "GreedySolver"
    assert type(make({"solver": "TPUSolver"}, None, device="cpu")).__name__ == "TorchSolver"


def test_replay_defaults_to_the_card(port):
    cluster, provider, ctl = env(port, n_pods=2)
    ctl.reconcile()
    capsule = roundtrip(port.fr.FLIGHT.latest("provisioning"))
    capsule["solver"] = "TorchSolver"
    if torch.cuda.is_available():
        assert port.replay.replay_capsule(capsule)["match"] is True
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port.replay.replay_capsule(capsule)


def test_sharded_fleet_round_replays_on_cell_clones(port, monkeypatch):
    """A sharded round whose cells raced in one fleet (per-cell clones of a
    latency-mode ``TorchSolver``) replays through ``torch-quality``: the
    cells solve on clones again, so the fleet is batched again, and the
    round matches (``config_controller_cells`` at 4,000 pods in 8 cells,
    above ``race_min_pods`` a cell)."""
    from karpenter_tpu_torch import configs
    from karpenter_tpu_torch.solver import solver as solver_mod

    fleets = []
    fleet = solver_mod.pack_solve_fleet

    def counting(*a, **k):
        fleets.append(1)
        return fleet(*a, **k)

    monkeypatch.setattr(solver_mod, "pack_solve_fleet", counting)
    cluster, provider, settings, _ = configs.config_controller_cells(n_pods=4000, n_cells=8)
    ctl = port.prov.ProvisioningController(cluster, provider, settings=settings,
                                           solver=TorchSolver(device="cpu"))
    result = ctl.reconcile()
    assert result.solve.stats["fleet_dispatches"] >= 1 and fleets
    capsule = roundtrip(port.fr.FLIGHT.latest("provisioning"))
    assert len(capsule["cells"][0]) == 8 and len(capsule["outputs"]["problem_digests"]) == 8
    recorded = len(fleets)
    report = port.replay.replay_capsule(capsule, solver="torch-quality", device="cpu")
    assert report["match"] is True, report["diffs"]
    assert len(fleets) - recorded == recorded


@pytest.fixture(autouse=True)
def _fresh_admission_table():
    """Each case starts with the port's dispatch-latency table empty, as a
    new process does: the table is process-wide, as the reference's is, and
    a synchronous pass on the CPU times the plain chain (seconds), which
    would turn a later case's race away."""
    from karpenter_tpu_torch.solver.torch_solver import AOT_CACHE as table

    table.clear()
    yield
    table.clear()
