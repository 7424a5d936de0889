"""The port's chaos soak on the CPU, held against the JAX package's
``soak/``.

The pure halves are compared across packages on numpy-seeded arguments:
``ChurnScript.generate`` (every event, the summary, the device-fault script
and the projected interruption schedule), ``federation_storm_script``,
``parse_metrics`` (on synthetic text and on each package's own operator
exposition), ``memory_slope_bps`` and the monitor's verdict. Then one short
soak of the port runs end to end on the CPU through its CLI with
``--device cpu``: the real HTTP stack, the operator in a subprocess killed
and respawned once, the API server restarted once; it must end with zero
violations. The full-length scaled soak (75 s of churn at a calibrated
rate) is slow-marked, as the reference's ``TestScaledSoak`` is.
"""

from __future__ import annotations

import importlib
import json
import math
import time

import numpy as np
import pytest

REF, PORT = PACKAGES = ("karpenter_tpu", "karpenter_tpu_torch")


def soak_mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.soak.{name}")


def events_of(script) -> list:
    return [e.to_dict() for e in script.events]


def generate_args(seed: int) -> dict:
    """``ChurnScript.generate`` arguments drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    return dict(
        seed=int(rng.integers(1 << 30)),
        duration_s=float(rng.uniform(10.0, 90.0)),
        rate_hz=float(rng.choice([20.0, 150.0, 600.0])),
        live_pods=int(rng.integers(30, 2500)),
        reclaim_every_s=float(rng.uniform(5.0, 20.0)),
        ice_every_s=float(rng.uniform(8.0, 25.0)),
        rpc_burst_every_s=float(rng.uniform(4.0, 15.0)),
        device_fault_every_s=float(rng.uniform(3.0, 20.0)),
        operator_restarts=((float(rng.uniform(0.1, 0.5)), str(rng.choice(["kill", "term"]))),),
        apiserver_restarts=(float(rng.uniform(0.5, 0.9)),),
    )


@pytest.mark.parametrize("seed", range(6))
def test_churn_timelines_equal_the_references(seed):
    args = generate_args(seed)
    scripts = {pkg: soak_mod(pkg, "churn").ChurnScript.generate(**args) for pkg in PACKAGES}
    port, ref = scripts[PORT], scripts[REF]
    assert events_of(port) == events_of(ref)
    assert port.summary() == ref.summary()
    assert port.total_weight() == ref.total_weight()
    wire = port.device_fault_script()
    assert wire == ref.device_fault_script()
    assert any(e.kind == "device-fault-burst" for e in port.events)
    # the wire parses into the same plan in both packages
    plans = {pkg: importlib.import_module(f"{pkg}.utils.faults").DeviceFaultPlan.parse(wire)
             for pkg in PACKAGES}
    assert plans[PORT].serialize() == plans[REF].serialize()
    assert plans[PORT].pending() == plans[REF].pending() > 0
    for round_s in (0.5, 1.0, 3.0):
        sched = {pkg: s.interruption_schedule(round_s=round_s) for pkg, s in scripts.items()}
        assert [(w.round_no, w.pool, w.fraction) for w in sched[PORT].waves] == [
            (w.round_no, w.pool, w.fraction) for w in sched[REF].waves]
        assert [(p.round_no, p.instance_type, p.zone, p.factor) for p in sched[PORT].spikes] == [
            (p.round_no, p.instance_type, p.zone, p.factor) for p in sched[REF].spikes]


def test_device_fault_script_of_the_soak_default_matches_reference():
    """The harness's own default timeline (``SoakConfig``'s seed, 60 s)
    carries the same device-fault bursts in both packages, at the rates
    the card's soak runs."""
    for rate in (50.0, 400.0, 1000.0):
        args = dict(seed=11, duration_s=60.0, rate_hz=rate, live_pods=2000,
                    operator_restarts=((0.25, "kill"),), apiserver_restarts=(0.6,))
        wires = {pkg: soak_mod(pkg, "churn").ChurnScript.generate(**args).device_fault_script()
                 for pkg in PACKAGES}
        assert wires[PORT] == wires[REF] and wires[PORT]


@pytest.mark.parametrize("seed", range(4))
def test_federation_storm_script_equals_the_references(seed):
    """The federation storm timeline (seedless; its arguments from a numpy
    seed), or the same refusal when it does not fit its rounds."""
    rng = np.random.default_rng(100 + seed)
    regions = [f"region-{c}" for c in "abc"]
    rng.shuffle(regions)
    kw = dict(storm_region=regions[0], blackout_region=regions[1],
              partition_region=regions[2], round_s=float(rng.uniform(2.0, 12.0)),
              rounds=int(rng.integers(8, 14)), storm_fraction=float(rng.uniform(0.2, 0.8)))
    out = {}
    for pkg in PACKAGES:
        fn = soak_mod(pkg, "churn").federation_storm_script
        try:
            out[pkg] = ("ok", events_of(fn(**kw)))
        except ValueError as e:
            out[pkg] = ("error", str(e))
    assert out[PORT] == out[REF]


def test_churn_builder_and_due_order_match_reference():
    seen = {}
    for pkg in PACKAGES:
        churn = soak_mod(pkg, "churn")
        s = churn.ChurnScript(seed=9)
        s.at(1.0).deploy_up("a", 5)
        s.at(2.0).ice(("*", "zone-a", "spot"), duration_s=3.0)
        s.at(4.0).operator_restart(signal="term")
        s.at(6.0).device_fault_burst("nan-result", n=2)
        s.at(7.0).region_blackout("region-a", 5.0)
        first = [e.to_dict() for e in s.due(now=4.0)]
        rest = [e.to_dict() for e in s.due(now=20.0)]
        seen[pkg] = (first, rest, s.device_fault_script(), s.pending())
        with pytest.raises(ValueError):
            churn.ChurnEvent(t=0.0, kind="meteor-strike")
    assert seen[PORT] == seen[REF]


SYNTHETIC = (
    "# HELP x y\n# TYPE x gauge\n"
    'x{controller="gc"} 1.5\n'
    'karpenter_tpu_kernel_faults_total{kind="dispatch-timeout"} 2\n'
    "karpenter_tpu_process_memory_bytes 123456\n"
    'y{a="b\\"c",d="e"} -3e-05\n'
    "z NaN\nw +Inf\n"
    "bad line\n"
)


def _exposition(pkg: str) -> str:
    metrics = importlib.import_module(f"{pkg}.utils.metrics")
    metrics.KERNEL_FAULTS.inc({"kind": "invalid-plan"}, 0)
    return metrics.REGISTRY.exposition()


def _nan_safe(rows):
    return [(n, l, "nan" if isinstance(v, float) and math.isnan(v) else v) for n, l, v in rows]


def test_parse_metrics_equals_the_references():
    """The monitor's Prometheus reader: the same triples from synthetic
    text in both packages, and each package reads the other's exposition
    as it reads its own."""
    parse = {pkg: soak_mod(pkg, "monitor").parse_metrics for pkg in PACKAGES}
    assert _nan_safe(parse[PORT](SYNTHETIC)) == _nan_safe(parse[REF](SYNTHETIC))
    for pkg in PACKAGES:
        text = _exposition(pkg)
        assert _nan_safe(parse[PORT](text)) == _nan_safe(parse[REF](text))
        assert any(name.startswith("karpenter_tpu_") for name, _, _ in parse[PORT](text))


@pytest.mark.parametrize("seed", range(5))
def test_memory_slope_equals_the_references(seed):
    """Seeded RSS samples over one to three incarnations, a linear leak or
    none, with noise: the same slope and qualifying segments."""
    rng = np.random.default_rng(seed)
    samples, t = [], 0.0
    for inc in range(int(rng.integers(1, 4))):
        leak = float(rng.choice([0.0, rng.uniform(1e3, 1e6)]))
        base = float(rng.uniform(1e8, 5e8))
        for k in range(int(rng.integers(10, 120))):
            t += float(rng.uniform(0.5, 1.5))
            samples.append((t, float(inc + 1), base + leak * k + float(rng.normal(0, 2e4))))
    out = {pkg: soak_mod(pkg, "monitor").memory_slope_bps(samples) for pkg in PACKAGES}
    assert out[PORT] == out[REF]


@pytest.mark.parametrize("case", ["violations", "clean", "perf-expected", "perf-clean"])
def test_monitor_verdict_equals_the_references(case):
    reports = {}
    for pkg in PACKAGES:
        mon = soak_mod(pkg, "monitor").InvariantMonitor(
            ready_p99_budget_s=1.0, loop_lag_budget_s=1.0, mem_slope_budget_bps=100.0)
        kw = dict(pending_end=0, launch_audit={}, orphan_instances=[])
        if case == "violations":
            mon.ready_latencies = [5.0] * 10
            mon.loop_lag_max_s = 9.0
            mon.mem_samples = [(float(t), 1.0, 1e8 + t * 1e6) for t in range(60)]
            mon.stage_sums = {"solve": 3.0, "launch": 7.5}
            kw = dict(pending_end=3, launch_audit={"duplicate_tokens": {"tok": ["i-1", "i-2"]}},
                      orphan_instances=["i-9"],
                      replay={"found": 1, "mismatched": ["c1"], "errors": ["x: boom"]})
        elif case == "clean":
            mon.ready_latencies = [0.1] * 50
        else:
            mon.perf_trips = {"solve": 1.0} if case == "perf-expected" else {"cell": 2.0}
            mon.perf_phases_armed_max = 3
            kw["perf_trips_expected"] = case == "perf-expected"
        reports[pkg] = mon.report(events_total=500, duration_s=10.0, **kw)
    assert reports[PORT] == reports[REF]
    assert reports[PORT]["ok"] == (case in ("clean", "perf-expected"))


def test_port_soak_config_adds_only_the_device():
    import dataclasses

    fields = {pkg: {f.name: f.default for f in dataclasses.fields(
        soak_mod(pkg, "harness").SoakConfig) if f.default is not dataclasses.MISSING}
        for pkg in PACKAGES}
    assert fields[PORT].pop("device") == "cuda"
    assert fields[PORT] == fields[REF]


def test_cli_parser_is_the_references_plus_device():
    parsers = {pkg: soak_mod(pkg, "__main__").build_parser() for pkg in PACKAGES}
    opts = {pkg: sorted((a.dest, a.default) for a in p._actions if a.dest != "help")
            for pkg, p in parsers.items()}
    assert ("device", "cuda") in opts[PORT]
    assert [o for o in opts[PORT] if o[0] != "device"] == opts[REF]


def test_short_port_soak_on_the_cpu_has_zero_violations(tmp_path, capsys):
    """``python -m karpenter_tpu_torch.soak --device cpu`` at a short
    length: 10 s of churn at 60 events/s over ~40 live pods, one operator
    SIGKILL and respawn, one API server restart, the operator (``python -m
    karpenter_tpu_torch --device cpu``) in a subprocess; the report has no
    violation, every anomaly capsule replays, nothing launched twice and no
    instance is orphaned."""
    from karpenter_tpu_torch.soak.__main__ import main

    t0 = time.monotonic()
    rc = main(["--duration", "10", "--rate", "60", "--live-pods", "40", "--device", "cpu",
               "--settle-timeout", "30", "--dump-dir", str(tmp_path)])
    report = json.loads(capsys.readouterr().out)
    assert report["violations"] == [] and report["ok"] and rc == 0
    assert report["restarts"]["operator_kill"] == 1 and report["restarts"]["apiserver"] == 1
    assert report["operator_incarnations"] == 2
    assert report["duplicate_tokens"] == {} and report["orphan_instances"] == []
    assert report["pending_end"] == 0 and report["pod_ready_samples"] > 0
    replay = report["replay"]
    assert replay["found"] is not None and not replay["mismatched"] and not replay["errors"]
    assert (tmp_path / "operator-0.log").exists() and (tmp_path / "operator-1.log").exists()
    assert time.monotonic() - t0 < 60.0


@pytest.mark.slow
def test_scaled_port_soak_end_to_end():
    """The reference's scaled acceptance soak on the port, on the CPU: 75 s
    of churn at a box-calibrated rate, one SIGKILL and one API server
    restart, zero violations, a judged memory window and every capsule
    replayed to a match."""
    from karpenter_tpu_torch.soak import SoakConfig, run_soak

    report = run_soak(SoakConfig(duration_s=75.0, rate_hz=0.0, rate_target_hz=1000.0, seed=11,
                                 operator_restarts=((0.25, "kill"),), apiserver_restarts=(0.6,),
                                 device="cpu"))
    assert report["restarts"]["operator_kill"] >= 1 and report["restarts"]["apiserver"] >= 1
    assert report["duration_s"] >= 60.0
    assert report["events_per_s"] >= max(100.0, 0.5 * report["rate_hz"])
    assert report["mem_segments"] >= 1
    assert report["replay"]["mismatched"] == [] and report["replay"]["errors"] == []
    assert report["ok"], report["violations"]


# ---------------------------------------------------------------------------
# The fixed rate, and the respawn of an operator that exits at boot
# ---------------------------------------------------------------------------

#: the rates the harness calibrated on the card's host for the card run's
#: soak (seed 11, 60 s, 2,000 live pods)
CARD_RATES = (70.0, 99.1, 109.7, 136.8, 190.2)


def bursts(script) -> list:
    return [(round(e.t, 3), e.kind, e.get("fault_kind"), e.get("endpoint"), e.get("n"),
             e.get("status")) for e in script.events
            if e.kind in ("device-fault-burst", "rpc-fault-burst")]


def test_fault_timeline_follows_the_rate_at_a_fixed_seed():
    """The reason the card run fixes the soak's rate: at one seed the
    device-fault and rpc bursts (kinds, times, endpoints, counts) change
    with the rate the harness calibrates, in both packages alike, and are
    the same on every generation at a fixed rate."""
    timelines = {}
    for rate in CARD_RATES:
        per_pkg = [bursts(soak_mod(pkg, "churn").ChurnScript.generate(
            seed=11, duration_s=60.0, rate_hz=rate, live_pods=2000,
            operator_restarts=((0.25, "kill"),), apiserver_restarts=(0.6,)))
            for pkg in PACKAGES]
        assert per_pkg[0] == per_pkg[1]
        timelines[rate] = per_pkg[0]
    device = {rate: [b for b in t if b[1] == "device-fault-burst"] for rate, t in timelines.items()}
    assert len({tuple(d) for d in device.values()}) == len(CARD_RATES)
    assert len({tuple(t) for t in timelines.values()}) == len(CARD_RATES)
    again = bursts(soak_mod(PORT, "churn").ChurnScript.generate(
        seed=11, duration_s=60.0, rate_hz=70.0, live_pods=2000,
        operator_restarts=((0.25, "kill"),), apiserver_restarts=(0.6,)))
    assert again == timelines[70.0]


class _Metrics:
    """A stand-in ``/metrics`` that answers once ``ready()`` is true."""

    def __init__(self, ready):
        import http.server
        import threading

        outer = self
        self.ready = ready

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                body = b"karpenter_tpu_process_start_time_seconds 1\n"
                self.send_response(200 if outer.ready() else 503)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    @property
    def port(self):
        return self.server.server_address[1]

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


def boot_harness(tmp_path, exits: int):
    """A port harness whose operator spawns are processes that exit at once
    (code 1, a boot log ending in the 503 the boot check saw) ``exits``
    times, then one that stays up and serves ``/metrics``."""
    import subprocess
    import sys

    harness = soak_mod(PORT, "harness")
    h = harness.SoakHarness(harness.SoakConfig(rate_hz=60.0, duration_s=5.0, live_pods=10,
                                               restart_delay_s=0.05, boot_timeout_s=20.0,
                                               device="cpu", dump_dir=str(tmp_path)))
    spawns = []
    served = _Metrics(lambda: len(spawns) > exits)
    h.operator_port = served.port

    def spawn():
        (tmp_path / f"operator-{h._incarnation}.log").write_text(
            "ConnectivityError: cloud provider unreachable: HTTP Error 503\n")
        h._incarnation += 1
        spawns.append(1)
        code = "import sys; sys.exit(1)" if len(spawns) <= exits else "import time; time.sleep(60)"
        h.operator = subprocess.Popen([sys.executable, "-c", code])

    h._spawn_operator = spawn
    return h, served, spawns


@pytest.mark.parametrize("exits", [1, 3])
def test_operator_that_exits_at_boot_is_respawned(tmp_path, exits):
    """An operator that exits before it is ready is respawned after
    ``restart_delay_s``, each respawn counted under
    ``restarts["operator_boot_exit"]``, until one boots (within the bound
    of ``BOOT_RESPAWNS``)."""
    h, served, spawns = boot_harness(tmp_path, exits)
    try:
        h._spawn_operator()
        assert h._boot_operator() is True
        assert h.restarts["operator_boot_exit"] == exits and len(spawns) == exits + 1
        assert h.boot_failure is None
    finally:
        h.operator.kill()
        served.stop()


def test_operator_exiting_past_the_bound_fails_with_its_reason(tmp_path):
    """Past ``BOOT_RESPAWNS`` respawns the boot gives up with the reason
    ``operator_boot_exit`` and the log's tail; ``run()`` then puts that
    reason first among the violations and does not wait out the settle."""
    harness = soak_mod(PORT, "harness")
    h, served, spawns = boot_harness(tmp_path, exits=harness.BOOT_RESPAWNS + 1)
    try:
        h._spawn_operator()
        assert h._boot_operator() is False
        assert h.restarts["operator_boot_exit"] == harness.BOOT_RESPAWNS
        assert len(spawns) == harness.BOOT_RESPAWNS + 1
        assert h.boot_failure.startswith("operator_boot_exit:")
        assert "HTTP Error 503" in h.boot_failure
    finally:
        served.stop()


def test_soak_respawns_an_operator_killed_by_503s_at_boot(tmp_path):
    """End to end on the CPU: the SIGKILLed operator's respawn meets a
    scripted burst of four 503s on ``/v1/instance-types`` at boot (its
    boot check retries four times, then exits, as the reference's does);
    the harness respawns it, the respawn boots, and the soak ends with no
    violation and the exit counted under ``operator_boot_exit``."""
    harness = soak_mod(PORT, "harness")
    script = soak_mod(PORT, "churn").ChurnScript()
    script.at(0.2).deploy_up("app-a", 12)
    script.at(2.0).operator_restart("kill")
    script.at(2.0).rpc_fault_burst("/v1/instance-types", n=4, status=503)
    script.at(3.0).deploy_up("app-b", 8)
    script.at(5.0).deploy_down("app-a", 12)
    report = harness.run_soak(harness.SoakConfig(
        duration_s=6.0, rate_hz=60.0, script=script, device="cpu", settle_timeout_s=30.0,
        dump_dir=str(tmp_path)))
    assert report["restarts"]["operator_boot_exit"] == 1, report["restarts"]
    assert report["restarts"]["operator_kill"] == 1
    assert report["violations"] == [] and report["ok"]
    assert "503" in (tmp_path / "operator-1.log").read_text()
    assert report["operator_incarnations"] == 2


def test_soak_provisions_through_a_catalog_outage_after_boot(tmp_path):
    """End to end on the CPU: ten 503s queue on ``/v1/instance-types``
    after the operator booted. Its next catalog refresh, a TTL after the
    boot's, exhausts its retries, the endpoint's breaker opens, and each
    half-open probe draws one more of the queued faults. The operator goes
    on provisioning with the catalog it last fetched, so the pods created
    after the refresh failed bind before the settle deadline, and the soak
    ends with no violation (a round that failed on the refresh backed the
    provisioner off for a minute and more)."""
    harness = soak_mod(PORT, "harness")
    script = soak_mod(PORT, "churn").ChurnScript()
    script.at(0.2).deploy_up("app-a", 12)
    script.at(1.0).rpc_fault_burst("/v1/instance-types", n=10, status=503)
    script.at(12.0).deploy_up("app-b", 8)
    script.at(14.0).deploy_down("app-a", 12)
    report = harness.run_soak(harness.SoakConfig(
        duration_s=15.0, rate_hz=60.0, script=script, device="cpu", settle_timeout_s=20.0,
        dump_dir=str(tmp_path)))
    assert report["violations"] == [] and report["ok"], report["violations"]
    assert report["pending_end"] == 0 and report["pod_ready_samples"] >= 20
    assert report["restarts"]["operator_boot_exit"] == 0
    assert "instance-type refresh failed" in (tmp_path / "operator-0.log").read_text()


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
