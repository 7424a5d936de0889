"""The port's profiler and perf sentinel on the CPU, held against the JAX
package's ``utils/profiling.py``.

Twin ``PerfSentinel``s, one per package, each on its own package's
``FakeClock``, are fed the same ``note_phase`` / ``note_bucket`` sequence,
drawn from numpy seeds: warm rounds, idle rounds, and a slowdown of one
phase and one bucket. After every tick the two packages must have fired the
same trips (same round, same phase, mode and bucket, the same floats), and
their ``/debug/perf`` documents must be equal. The sampling profilers,
given the same collapsed stacks, export the same collapsed text and the
same speedscope document, and the two packages' HTTP servers answer
``/debug/profile`` and ``/debug/perf`` alike. The port's one deliberate
difference, where its baselines live, is held on its own; so is the
perf-regression capsule, which must replay through the port's
``replay_capsule``.
"""

from __future__ import annotations

import importlib
import json
import os
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

REF, PORT = PACKAGES = ("karpenter_tpu", "karpenter_tpu_torch")


def pkg_mod(pkg: str) -> SimpleNamespace:
    imp = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
    return SimpleNamespace(
        pkg=pkg, profiling=imp("utils.profiling"), cache=imp("utils.cache"),
        metrics=imp("utils.metrics"), decisions=imp("utils.decisions"),
        fr=imp("utils.flightrecorder"), http=imp("utils.httpserver"),
    )


def _reset(m) -> None:
    m.decisions.DECISIONS.configure(2048)
    m.decisions.DECISIONS.clear()
    m.fr.FLIGHT.configure(32)
    m.fr.FLIGHT.clear()
    m.profiling.PROFILER.stop()
    m.profiling.PROFILER.reset()
    m.profiling.SENTINEL.reset()


@pytest.fixture(autouse=True)
def _fresh_perf_state():
    mods = [pkg_mod(p) for p in PACKAGES]
    for m in mods:
        _reset(m)
    yield
    for m in mods:
        _reset(m)
        m.profiling.SENTINEL.configure(
            enabled=False, sentinel_enabled=False, mad_k=3,
            baseline_rounds=20, baseline_path=None,
        )


def twin_sentinels(tmp_path, mad_k=3, baseline_rounds=5, window=0.0):
    """One fresh ``PerfSentinel`` per package, each with its own baseline
    file and its own package's ``FakeClock`` at the same start."""
    out = {}
    for pkg in PACKAGES:
        m = pkg_mod(pkg)
        fake = m.cache.FakeClock(start=100.0)
        s = m.profiling.PerfSentinel(
            m.profiling.SamplingProfiler(), m.profiling.PhaseBaselineStore()
        )
        d = tmp_path / pkg
        d.mkdir(exist_ok=True)
        s.configure(
            enabled=True, sentinel_enabled=True, mad_k=mad_k,
            baseline_rounds=baseline_rounds,
            baseline_path=str(d / "phase_baselines.json"),
            profile_window_s=window, clock=fake.now,
        )
        out[pkg] = (s, fake)
    return out


def _snapshot(s) -> dict:
    doc = s.snapshot()
    doc.pop("baseline_path")  # one directory per package
    return doc


PHASES = (("encode", "delta"), ("solve", "full"), ("validate", "full"), ("cell", "delta"))
BUCKETS = ("g8o64e8s256z4r3k8", "g16o128e8s512z4r3k8", "g8o64e8s256z4r3k8b4")


def scenario(seed: int):
    """Rounds of notes from a numpy seed: ``warm`` clean rounds, a few idle
    rounds, clean rounds again, then a slowdown of one phase and one bucket
    by a seeded factor. Each round is a list of ("phase", phase, mode, s) and
    ("bucket", label, s) notes; an idle round is an empty list."""
    rng = np.random.default_rng(seed)
    base = {p: float(rng.uniform(0.002, 0.05)) for p in PHASES}
    bbase = {b: float(rng.uniform(0.0005, 0.01)) for b in BUCKETS}
    slow_phase = PHASES[int(rng.integers(len(PHASES)))]
    slow_bucket = BUCKETS[int(rng.integers(len(BUCKETS)))]
    factor = float(rng.uniform(20.0, 80.0))

    def round_(slow: bool):
        notes = []
        for p in PHASES:
            if rng.random() < 0.2 and not (slow and p == slow_phase):
                continue  # this phase did not run this round
            v = base[p] * float(1.0 + 0.05 * rng.standard_normal())
            if slow and p == slow_phase:
                v *= factor
            notes.append(("phase", p[0], p[1], max(v, 1e-6)))
        for b in BUCKETS:
            if rng.random() < 0.3 and not (slow and b == slow_bucket):
                continue
            v = bbase[b] * float(1.0 + 0.05 * rng.standard_normal())
            if slow and b == slow_bucket:
                v *= factor
            notes.append(("bucket", b, max(v, 1e-6)))
        return notes

    rounds = [round_(False) for _ in range(int(rng.integers(8, 12)))]
    rounds += [[] for _ in range(int(rng.integers(0, 3)))]
    rounds += [round_(False) for _ in range(3)]
    rounds += [round_(True) for _ in range(8)]
    return rounds, slow_phase


def feed(s, notes) -> None:
    for note in notes:
        if note[0] == "phase":
            s.note_phase(note[1], note[2], note[3])
        else:
            s.note_bucket(note[1], note[2])


@pytest.mark.parametrize("seed", range(6))
def test_twin_sentinels_trip_on_the_same_round_and_key(tmp_path, seed):
    rounds, slow_phase = scenario(seed)
    twins = twin_sentinels(tmp_path, mad_k=3, baseline_rounds=5)
    fired = {pkg: [] for pkg in PACKAGES}
    for r, notes in enumerate(rounds):
        for pkg in PACKAGES:
            s, fake = twins[pkg]
            feed(s, notes)
            fired[pkg].append(s.tick())
            fake.step(1.0)
        assert fired[PORT][r] == fired[REF][r], f"round {r}"
        assert _snapshot(twins[PORT][0]) == _snapshot(twins[REF][0]), f"round {r}"
    trips = [t for ts in fired[PORT] for t in ts]
    # not vacuous: the slowed phase tripped during the slowdown
    assert any(t["phase"] == slow_phase[0] and t["mode"] == slow_phase[1] for t in trips)
    assert all(t["round"] > len(rounds) - 8 for t in trips)
    # the persisted baselines agree too
    docs = {
        pkg: json.loads((tmp_path / pkg / "phase_baselines.json").read_text())
        for pkg in PACKAGES
    }
    assert docs[PORT] == docs[REF]


@pytest.mark.parametrize("mad_k", [1, 2, 4])
def test_twin_sentinels_rearm_and_trip_again_alike(tmp_path, mad_k):
    """Slow, recover, slow again: one regression is one trip until K
    in-band rounds re-arm the key, in both packages."""
    twins = twin_sentinels(tmp_path, mad_k=mad_k, baseline_rounds=4)
    values = [0.010] * 5 + [1.0] * 6 + [0.010] * (mad_k + 2) + [1.0] * 4
    fired = {pkg: [] for pkg in PACKAGES}
    for v in values:
        for pkg in PACKAGES:
            s, _ = twins[pkg]
            s.note_phase("solve", "full", v)
            s.note_bucket("g8o64e8s256z4r3k8", v / 10)
            fired[pkg].append(s.tick())
    assert fired[PORT] == fired[REF]
    assert twins[PORT][0].trips_total == twins[REF][0].trips_total >= 2


def test_trip_emission_matches_reference(tmp_path):
    """A trip writes the same DecisionRecord and moves
    ``karpenter_tpu_perf_regression_total`` alike in both packages."""
    twins = twin_sentinels(tmp_path, mad_k=2)
    got = {}
    for pkg in PACKAGES:
        m = pkg_mod(pkg)
        s, _ = twins[pkg]
        before = m.metrics.PERF_REGRESSION.value({"phase": "solve"})
        for _ in range(5):
            s.note_phase("solve", "full", 0.010)
            s.note_bucket("g8o64e8s256z4r3k8", 0.001)
            s.tick()
        for _ in range(2):
            s.note_phase("solve", "full", 1.0)
            s.note_bucket("g8o64e8s256z4r3k8", 0.5)
            s.tick()
        recs = m.decisions.DECISIONS.query(kind="perf")
        got[pkg] = (
            m.metrics.PERF_REGRESSION.value({"phase": "solve"}) - before,
            sorted((r.outcome, r.reason, json.dumps(r.details, sort_keys=True))
                   for r in recs),
        )
    assert got[PORT] == got[REF]
    assert got[PORT][0] == 1 and got[PORT][1]


def _stacks(seed: int, n: int = 400):
    rng = np.random.default_rng(seed)
    roles = ("reconcile", "hostpool", "watch-applier", "background", "grpc-poller-7")
    frames = [f"mod{i}.f{j}" for i in range(6) for j in range(4)]
    out = []
    for _ in range(n):
        depth = int(rng.integers(1, 6))
        out.append(";".join([roles[int(rng.integers(len(roles)))]]
                            + [frames[int(rng.integers(len(frames)))] for _ in range(depth)]))
    return out


@pytest.mark.parametrize("seed, max_stacks", [(0, 2048), (1, 16), (2, 4)])
def test_collapsed_and_speedscope_formats_match_reference(seed, max_stacks):
    """The same collapsed stacks, ingested in the same batches, give the
    same collapsed text (heaviest first, with the ``<evicted>`` line under
    LRU pressure), the same speedscope document and the same snapshot."""
    stacks = _stacks(seed)
    out = {}
    for pkg in PACKAGES:
        p = pkg_mod(pkg).profiling.SamplingProfiler(max_stacks=max_stacks)
        for i in range(0, len(stacks), 7):
            p._ingest(stacks[i:i + 7])
        out[pkg] = (p.collapsed(), p.speedscope(), p.snapshot())
    assert out[PORT] == out[REF]
    assert out[PORT][2]["samples"] == len(stacks)


def test_thread_roles_match_reference():
    names = ("MainThread", "watch-0", "cluster-apply-2", "hostpool-worker-3",
             "aot-precompile", "background", "SerialBackground-1", "perf-profiler",
             "grpc-poller-7", "launch_0")
    roles = {pkg: [pkg_mod(pkg).profiling.thread_role(n) for n in names] for pkg in PACKAGES}
    assert roles[PORT] == roles[REF]


def test_module_constants_match_reference():
    keys = ("DEFAULT_SAMPLE_HZ", "MAX_STACKS", "MAX_STACK_DEPTH", "MAD_MULTIPLIER",
            "BAND_FLOOR_FRACTION", "BAND_FLOOR_SECONDS", "WARMUP_RESERVOIR", "TRIP_HISTORY",
            "DEFAULT_PROFILE_WINDOW_S", "BASELINE_FILENAME", "EWMA_KEEP", "EWMA_NEW")
    vals = {pkg: [getattr(pkg_mod(pkg).profiling, k) for k in keys] for pkg in PACKAGES}
    assert vals[PORT] == vals[REF]


def test_baseline_directory_is_the_ports_own(monkeypatch, tmp_path):
    """The one deliberate difference: with no configured directory and no
    ``KARPENTER_TPU_COMPILE_CACHE_DIR``, the port's baselines default to
    ``~/.cache/karpenter_tpu_torch``, never the JAX package's XLA cache;
    the env override and a configured directory win, in the reference's
    order."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("KARPENTER_TPU_COMPILE_CACHE_DIR", raising=False)
    port, ref = (pkg_mod(p).profiling for p in (PORT, REF))
    assert port._default_baseline_dir() == str(tmp_path / ".cache" / "karpenter_tpu_torch")
    assert ref._default_baseline_dir() == str(tmp_path / ".cache" / "karpenter_tpu" / "xla")
    port.configure()
    assert port.SENTINEL.store.path == str(
        tmp_path / ".cache" / "karpenter_tpu_torch" / port.BASELINE_FILENAME)
    monkeypatch.setenv("KARPENTER_TPU_COMPILE_CACHE_DIR", str(tmp_path / "env"))
    port.configure()
    assert port.SENTINEL.store.path == str(tmp_path / "env" / port.BASELINE_FILENAME)
    port.configure(baseline_dir=str(tmp_path / "cfg"))
    assert port.SENTINEL.store.path == str(tmp_path / "cfg" / port.BASELINE_FILENAME)


def test_taps_are_noops_while_disabled():
    prof = pkg_mod(PORT).profiling
    prof.SENTINEL.configure(enabled=False, sentinel_enabled=False, mad_k=3,
                            baseline_rounds=5, baseline_path=None)
    prof.note_phase("solve", "full", 0.5)
    prof.note_bucket_dispatch("g8o64", 0.5)
    assert prof.sentinel_tick() == []
    assert prof.SENTINEL.snapshot()["phases"] == {}


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


@pytest.fixture
def servers():
    srvs = {pkg: pkg_mod(pkg).http.OperatorHTTPServer(port=0).start() for pkg in PACKAGES}
    yield srvs
    for pkg, srv in srvs.items():
        srv.stop()
        pkg_mod(pkg).profiling.PROFILER.stop()


def test_debug_perf_answers_like_the_reference(servers, tmp_path):
    """The process sentinels, configured alike and fed the same rounds,
    serve the same ``/debug/perf`` document (less the baseline path)."""
    rounds, _ = scenario(7)
    for pkg in PACKAGES:
        m = pkg_mod(pkg)
        fake = m.cache.FakeClock(start=100.0)
        m.profiling.configure(sentinel_enabled=True, mad_k=3, baseline_rounds=5,
                              baseline_dir=str(tmp_path / pkg), profile_window_s=0.0,
                              clock=fake.now)
        for notes in rounds:
            for note in notes:
                if note[0] == "phase":
                    m.profiling.note_phase(note[1], note[2], note[3])
                else:
                    m.profiling.note_bucket_dispatch(note[1], note[2])
            m.profiling.sentinel_tick()
            fake.step(1.0)
    docs = {}
    for pkg, srv in servers.items():
        status, ctype, body = _get(srv.port, "/debug/perf")
        doc = json.loads(body)
        assert doc.pop("baseline_path").startswith(str(tmp_path / pkg))
        docs[pkg] = (status, ctype, doc)
    assert docs[PORT] == docs[REF]
    assert docs[PORT][2]["trips_total"] >= 1


def test_debug_profile_answers_like_the_reference(servers):
    """``/debug/profile``: status, start/stop, the collapsed text and the
    speedscope document of the same table, in both packages."""
    stacks = _stacks(3, n=60)
    answers = {}
    for pkg, srv in servers.items():
        prof = pkg_mod(pkg).profiling
        got = []
        for q in ("?status=1", "?start=1", "?stop=1"):
            status, ctype, body = _get(srv.port, "/debug/profile" + q)
            doc = json.loads(body)
            got.append((status, ctype, doc["running"], doc["continuous"]))
        prof.PROFILER.reset()
        prof.PROFILER._ingest(stacks)
        for q in ("", "?format=speedscope"):
            got.append(_get(srv.port, "/debug/profile" + q))
        status, ctype, body = _get(srv.port, "/debug/profile?reset=1&status=1")
        got.append((status, ctype, json.loads(body)["samples"]))
        answers[pkg] = got
    assert answers[PORT] == answers[REF]
    assert answers[PORT][1][2] is True and answers[PORT][2][2] is False
    assert answers[PORT][-1][2] == 0


def test_debug_profile_window_samples_the_live_process(servers):
    srv = servers[PORT]
    status, ctype, body = _get(srv.port, "/debug/profile?seconds=0.3&reset=1")
    assert status == 200 and ctype == "text/plain" and ";" in body
    assert not pkg_mod(PORT).profiling.PROFILER.running


def test_perf_capsule_replays_through_the_port(tmp_path):
    """A trip after a real port round assembles the perf-regression capsule
    from the recorder's latest provisioning capsule; its ``profile`` and
    ``perf_regression`` outputs stay outside the replay comparison, so it
    replays to a match through the port's ``replay_capsule``."""
    from karpenter_tpu_torch.api import ObjectMeta, Pod, Provisioner, Resources
    from karpenter_tpu_torch.api.settings import Settings
    from karpenter_tpu_torch.cloudprovider import FakeCloudProvider, generate_catalog
    from karpenter_tpu_torch.controllers.provisioning import ProvisioningController
    from karpenter_tpu_torch.replay import replay_capsule
    from karpenter_tpu_torch.solver import GreedySolver
    from karpenter_tpu_torch.state import Cluster

    m = pkg_mod(PORT)
    m.fr.FLIGHT.configure(8, dump_dir=str(tmp_path))
    cluster = Cluster()
    controller = ProvisioningController(
        cluster, FakeCloudProvider(catalog=generate_catalog(n_types=20)),
        solver=GreedySolver(), settings=Settings(batch_idle_duration=0, batch_max_duration=0),
    )
    cluster.add_provisioner(Provisioner(meta=ObjectMeta(name="default")))
    for i in range(6):
        cluster.add_pod(Pod(meta=ObjectMeta(name=f"perf-{i}", owner_kind="ReplicaSet"),
                            requests=Resources(cpu="500m", memory="1Gi")))
    controller.reconcile()
    base = m.fr.FLIGHT.latest("provisioning")
    assert base is not None
    s, _ = twin_sentinels(tmp_path, mad_k=2)[PORT]
    fired = []
    for v in [0.010] * 5 + [1.0] * 2:
        s.note_phase("solve", "full", v)
        fired = s.tick()
    assert fired and fired[0]["capsule"] == f"{base['id']}.perf1"
    capsule = m.fr.FLIGHT.get(fired[0]["capsule"])
    assert m.fr.TRIGGER_PERF_REGRESSION in capsule["anomalies"]
    assert capsule["outputs"]["perf_regression"]["phase"] == "solve"
    assert isinstance(capsule["outputs"]["profile"], list)
    assert os.path.exists(m.fr.FlightRecorder._dump_path(capsule["id"], str(tmp_path)))
    report = replay_capsule(json.loads(json.dumps(capsule, default=str)), solver="greedy",
                            device="cpu")
    assert report["match"], report
