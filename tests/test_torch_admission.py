"""Race admission by each bucket's measured dispatch latency, on the CPU,
against the JAX package's.

The port's ``AOT_CACHE`` (``torch_solver.AOTCache``) is the live half of
the reference's ``AOTCache``: per bucket, the EWMA of the measured time from
a dispatch to its result on the host, which the flat race
(``_race_dispatch_affordable``) and ``stage_fleet``'s ladder admit on, and
which feeds the perf sentinel. Each case gives both packages the same
entries and the same samples: reference entries are made as the reference's
own tests make them (an ``_AOTEntry`` under ``_ckey``), the port's at a
bucket's first dispatch (``build``).

Tolerances: predictions equal to 1e-12 at every step; the sentinels'
per-bucket documents equal to 1e-12; admission decisions, fleet stats and
race backends equal.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import karpenter_tpu.solver.jax_solver as J
from karpenter_tpu.solver import TPUSolver
from karpenter_tpu.solver import solver as ref_solver_mod
from karpenter_tpu.solver.solver import KERNEL_BOARD as REF_BOARD
from karpenter_tpu.utils import cache as ref_cache_mod
from karpenter_tpu.utils import metrics as ref_metrics
from karpenter_tpu.utils import profiling as ref_profiling
from karpenter_tpu_torch.solver import TorchSolver, validate
from karpenter_tpu_torch.solver import solver as solver_mod
from karpenter_tpu_torch.solver import torch_solver as ts
from karpenter_tpu_torch.solver.solver import KERNEL_BOARD
from karpenter_tpu_torch.utils import cache as port_cache_mod
from karpenter_tpu_torch.utils import metrics as port_metrics
from karpenter_tpu_torch.utils import profiling as port_profiling
from test_torch_fleet import _cells, _encode, _ref_encode
from test_torch_host import reset_caches
from test_torch_solver import _case

TOL = 1e-12
BUDGET_S = 0.1
PINNED_RTT_S = 1e-4  # an unloaded CPU's round trip, far inside the budget


@pytest.fixture(autouse=True)
def _fresh_state():
    reset_caches()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    reset_caches()


def pin_rtt(monkeypatch, seconds: float) -> None:
    monkeypatch.setattr(TorchSolver, "_device_rtt_s", seconds)
    monkeypatch.setattr(TPUSolver, "_device_rtt_s", seconds)


def same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return abs(a - b) <= TOL * max(1.0, abs(a))


# ---------------------------------------------------------------------------
# the tables
# ---------------------------------------------------------------------------

KEY = dict(G=8, O=64, E=8, S=256, Z=4, R=3, K=8)
#: mesh stand-ins: ``_ckey`` reads only the axis names and the devices' shape
MESHES = {None: None, "p2": SimpleNamespace(axis_names=("portfolio",), devices=np.empty((2,))),
          "p4": SimpleNamespace(axis_names=("portfolio",), devices=np.empty((4,)))}
KEYS = {"b1": {}, "b8": {"B": 8}, "s512": {"S": 512}, "g16": {"G": 16}}


def twin_key(name):
    fields = dict(KEY, **KEYS[name])
    return J.BucketKey(**fields), ts.BucketKey(**fields)


class TwinTables:
    """A fresh reference ``AOTCache`` and a fresh port ``AOTCache`` driven by
    one script of operations."""

    def __init__(self, capacity: int = 32):
        self.ref = J.AOTCache(capacity=capacity)
        self.ref.configure(persist=False)
        self.port = ts.AOTCache(capacity=capacity)

    def build(self, name, mesh=None):
        rk, pk = twin_key(name)
        m = MESHES[mesh]
        ck = self.ref._ckey(rk, False, m)
        with self.ref._lock:  # as ``compile`` lands an executable
            if ck not in self.ref._entries:
                self.ref._entries[ck] = J._AOTEntry("exe", 0.0)
            self.ref._entries.move_to_end(ck)
            self.ref._evict_over_capacity()
        self.port.build(pk, m)

    def use(self, name, mesh=None):
        rk, pk = twin_key(name)
        assert (self.ref.get(rk, mesh=MESHES[mesh]) is not None) == self.port.resident(
            pk, MESHES[mesh])

    def note(self, name, seconds, mesh=None):
        rk, pk = twin_key(name)
        self.ref.note_dispatch(rk, seconds, mesh=MESHES[mesh])
        self.port.note_dispatch(pk, seconds, mesh=MESHES[mesh])

    def evict(self, name):
        rk, pk = twin_key(name)
        assert self.ref.evict_bucket(rk.label()) == self.port.evict_bucket(pk.label())

    def capacity(self, n):
        self.ref.configure(capacity=n)
        self.port.configure(capacity=n)

    def hold(self):
        """Every key and mesh variant predicts alike in both tables."""
        for name in KEYS:
            rk, pk = twin_key(name)
            for mesh in MESHES:
                want = self.ref.predicted_dispatch_s(rk, mesh=MESHES[mesh])
                got = self.port.predicted_dispatch_s(pk, mesh=MESHES[mesh])
                assert same(want, got), (name, mesh, want, got)
        assert self.ref.stats["evictions"] == self.port.stats["evictions"]
        assert self.ref.stats_dict()["buckets"] == self.port.stats_dict()["buckets"]


def samples(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return [float(x) for x in rng.lognormal(mean=-5.0, sigma=1.2, size=n)]


def script_before_entry(t, seed):
    t.note("b1", 0.003)  # no entry yet: nothing learned
    t.hold()
    t.build("b1")  # an entry with no sample predicts nothing
    t.hold()
    for s in samples(seed, 3):
        t.note("b1", s)
        t.hold()


def script_blend(t, seed):
    t.build("b1")
    t.build("s512")
    for i, s in enumerate(samples(seed, 40)):
        t.note("b1" if i % 3 else "s512", s)
        t.hold()


def script_fleet_width(t, seed):
    t.build("b1")
    t.build("b8")
    t.note("b1", 0.002)
    t.note("b8", 9.0)  # a slow B=8 dispatch leaves the B=1 bucket alone
    t.hold()
    for s in samples(seed, 10):
        t.note("b8", s * 50)
        t.hold()
    assert same(t.port.predicted_dispatch_s(twin_key("b1")[1]), 0.002)


def script_evict_variants(t, seed):
    for mesh in MESHES:
        t.build("b1", mesh)
        t.note("b1", samples(seed, 1)[0], mesh)
    t.build("b8")
    t.note("b8", 0.004)
    t.hold()
    t.evict("b1")  # every mesh variant of the label goes; B=8 is another label
    t.hold()
    assert t.port.predicted_dispatch_s(twin_key("b8")[1]) == pytest.approx(0.004)
    t.evict("b1")  # nothing left to evict
    t.hold()


def script_lru(t, seed):
    t.capacity(2)
    for name, s in zip(("b1", "b8"), samples(seed, 2)):
        t.build(name)
        t.note(name, s)
        t.hold()
    t.use("b1")  # b1 is now the most recently dispatched
    t.build("s512")  # over capacity: the least recent, b8, goes
    t.hold()
    t.use("b1")
    t.build("g16")
    t.hold()
    t.capacity(1)
    t.hold()
    t.capacity(32)


SCRIPTS = {"before_entry": script_before_entry, "blend": script_blend,
           "fleet_width": script_fleet_width, "evict_variants": script_evict_variants,
           "lru": script_lru}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_tables_predict_alike(script, seed):
    """The same operations give equal predictions at every step, equal
    evictions, and equal ``evict`` events on each package's
    ``karpenter_tpu_aot_cache_events_total``."""
    evict = {"event": "evict"}
    ref0 = ref_metrics.AOT_CACHE_EVENTS.value(evict)
    port0 = port_metrics.AOT_CACHE_EVENTS.value(evict)
    t = TwinTables()
    SCRIPTS[script](t, seed)
    t.hold()
    assert (ref_metrics.AOT_CACHE_EVENTS.value(evict) - ref0
            == port_metrics.AOT_CACHE_EVENTS.value(evict) - port0
            == t.port.stats["evictions"])


# ---------------------------------------------------------------------------
# the flat race
# ---------------------------------------------------------------------------

def twin_flat(name):
    """Twin latency solvers and the same problem in each package, the
    bucket's entry made in both tables."""
    ref_problem, problem = _case(name)
    ref = TPUSolver(auto_mesh=False, portfolio=4, latency_budget_s=BUDGET_S)
    port = TorchSolver(device="cpu", portfolio=4, latency_budget_s=BUDGET_S)
    rkey, pkey = ref._bucket_key(ref_problem), port._bucket_key(problem)
    assert rkey.label() == pkey.label()
    ck = J.AOT_CACHE._ckey(rkey, ref._donate(), None)
    with J.AOT_CACHE._lock:
        J.AOT_CACHE._entries[ck] = J._AOTEntry("exe", 0.0)
    ts.AOT_CACHE.build(pkey)
    return SimpleNamespace(ref=ref, port=port, ref_problem=ref_problem, problem=problem,
                           rkey=rkey, pkey=pkey)


def note_both(t, seconds: float) -> None:
    J.AOT_CACHE.note_dispatch(t.rkey, seconds, donate=t.ref._donate())
    ts.AOT_CACHE.note_dispatch(t.pkey, seconds)


@pytest.fixture
def ref_table():
    """The reference's process-wide table, with this case's entries taken out
    again afterwards (its compiled executables stay)."""
    before = set(J.AOT_CACHE._entries)
    yield
    with J.AOT_CACHE._lock:
        for ck in set(J.AOT_CACHE._entries) - before:
            del J.AOT_CACHE._entries[ck]


@pytest.fixture
def chains(monkeypatch):
    """Counts the fused chains the port's solver module enqueues."""
    calls = {"fused": 0, "fleet": 0}
    fused, fleet = solver_mod.pack_solve_fused, solver_mod.pack_solve_fleet

    def count_fused(*args):
        calls["fused"] += 1
        return fused(*args)

    def count_fleet(*args):
        calls["fleet"] += 1
        return fleet(*args)

    monkeypatch.setattr(solver_mod, "pack_solve_fused", count_fused)
    monkeypatch.setattr(solver_mod, "pack_solve_fleet", count_fleet)
    return calls


@pytest.mark.parametrize("name", ["full_2k", "topology_1k"])
def test_flat_race_admits_on_the_bucket_ewma(name, monkeypatch, chains, ref_table):
    """With the round trip pinned to infinity, a bucket measured at 1 ms is
    admitted; after 20 samples of 10 s it is refused in both packages: the
    port enqueues no chain, and both answer from the same host backend."""
    t = twin_flat(name)
    pin_rtt(monkeypatch, float("inf"))
    note_both(t, 0.001)
    assert t.ref._race_dispatch_affordable(t.ref_problem) is True
    assert t.port._race_dispatch_affordable(t.problem) is True
    for _ in range(20):
        note_both(t, 10.0)
    assert same(J.AOT_CACHE.predicted_dispatch_s(t.rkey, donate=t.ref._donate()),
                ts.AOT_CACHE.predicted_dispatch_s(t.pkey))
    assert t.ref._race_dispatch_affordable(t.ref_problem) is False
    assert t.port._race_dispatch_affordable(t.problem) is False
    want = t.ref.solve(t.ref_problem)
    got = t.port.solve(t.problem)
    assert chains == {"fused": 0, "fleet": 0}
    assert got.stats["backend"] == want.stats["backend"] != 1.0
    assert validate(t.problem, got) == []
    assert ts.AOT_CACHE.stats_dict()["refusals"] == {t.pkey.label(): 1}


def test_breaker_open_drops_the_entry(monkeypatch, ref_table):
    """The transition to open evicts the label's entry in both packages:
    admission then falls back to the round trip."""
    t = twin_flat("full_2k")
    note_both(t, 10.0)
    pin_rtt(monkeypatch, PINNED_RTT_S)
    assert not t.ref._race_dispatch_affordable(t.ref_problem)
    assert not t.port._race_dispatch_affordable(t.problem)
    evict = {"event": "evict"}
    ref0 = ref_metrics.AOT_CACHE_EVENTS.value(evict)
    port0 = port_metrics.AOT_CACHE_EVENTS.value(evict)
    label = t.pkey.label()
    for _ in range(KERNEL_BOARD.failure_threshold):
        REF_BOARD.fail(label, "invalid-plan")
        KERNEL_BOARD.fail(label, "invalid-plan")
    assert REF_BOARD.state(label) == KERNEL_BOARD.state(label) == "open"
    assert J.AOT_CACHE.predicted_dispatch_s(t.rkey, donate=t.ref._donate()) is None
    assert ts.AOT_CACHE.predicted_dispatch_s(t.pkey) is None
    assert (ref_metrics.AOT_CACHE_EVENTS.value(evict) - ref0
            == port_metrics.AOT_CACHE_EVENTS.value(evict) - port0 == 1)
    assert t.ref._race_dispatch_affordable(t.ref_problem)
    assert t.port._race_dispatch_affordable(t.problem)
    pin_rtt(monkeypatch, float("inf"))
    assert not t.ref._race_dispatch_affordable(t.ref_problem)
    assert not t.port._race_dispatch_affordable(t.problem)


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------

N_CELLS = 2


@pytest.fixture(scope="module")
def fleet_exe():
    """The reference's fleet executable for the twin cells' bucket, compiled
    once: its ``stage_fleet`` dispatches only resident executables. Yields
    the reference's B=1 and fleet keys."""
    cells, provs, _ = _cells(N_CELLS)
    solver = TPUSolver(auto_mesh=False, latency_budget_s=BUDGET_S)
    key = solver._bucket_key(_ref_encode(cells, provs, 0))
    fleet_key = key._replace(B=J.bucket_fleet(N_CELLS))
    J.AOT_CACHE.compile(fleet_key)
    yield key, fleet_key
    J.AOT_CACHE.evict_bucket(fleet_key.label())


def twin_fleet_entries():
    """The same cells encoded in each package, each on a latency solver of
    its own."""
    cells, provs, catalog = _cells(N_CELLS)
    ref = [(TPUSolver(auto_mesh=False, latency_budget_s=BUDGET_S), _ref_encode(cells, provs, c))
           for c in range(N_CELLS)]
    port = [(TorchSolver(device="cpu", latency_budget_s=BUDGET_S), _encode(cells, provs, catalog, c))
            for c in range(N_CELLS)]
    return ref, port


def reset_fleet_table(fleet_exe) -> None:
    """No measured latency on either package's B=1 or fleet bucket (the
    reference's fleet executable stays resident)."""
    key, fleet_key = fleet_exe
    with J.AOT_CACHE._lock:
        J.AOT_CACHE._entries.pop(J.AOT_CACHE._ckey(key, False, None), None)
        J.AOT_CACHE._entries[J.AOT_CACHE._ckey(fleet_key, False, None)].dispatch_ewma = None
    ts.AOT_CACHE.clear()


def twin_stage(ref_entries, port_entries):
    want = ref_solver_mod.stage_fleet(ref_entries)
    got = solver_mod.stage_fleet(port_entries)
    for k in ("dispatches", "eligible", "buckets"):
        assert want[k] == got[k], (k, want, got)
    return got


def seed_entry(fleet_exe, which: str, seconds: float) -> None:
    """A measured latency on both packages' B=1 or fleet bucket."""
    key, fleet_key = fleet_exe
    rk = fleet_key if which == "fleet" else key
    pk = ts.BucketKey(*rk)
    ck = J.AOT_CACHE._ckey(rk, False, None)
    with J.AOT_CACHE._lock:
        J.AOT_CACHE._entries.setdefault(ck, J._AOTEntry("exe", 0.0))
    ts.AOT_CACHE.build(pk)
    J.AOT_CACHE.note_dispatch(rk, seconds)
    ts.AOT_CACHE.note_dispatch(pk, seconds)


@pytest.mark.parametrize("rung, seconds, rtt, admitted", [
    ("fleet", 0.001, float("inf"), True),  # the fleet bucket's own latency first
    ("fleet", 10.0, PINNED_RTT_S, False),
    ("b1", 0.001, float("inf"), True),  # else the B=1 bucket's
    ("b1", 10.0, PINNED_RTT_S, False),
    ("rtt", None, PINNED_RTT_S, True),  # else the round trip
    ("rtt", None, float("inf"), False),
])
def test_fleet_ladder(fleet_exe, monkeypatch, rung, seconds, rtt, admitted):
    """Twin ``stage_fleet`` calls on the same cells and the same samples give
    equal dispatches, eligible cells and fleet buckets at each rung of the
    reference's ladder."""
    reset_fleet_table(fleet_exe)
    pin_rtt(monkeypatch, rtt)
    if rung != "rtt":
        seed_entry(fleet_exe, rung, seconds)
    stats = twin_stage(*twin_fleet_entries())
    assert stats["eligible"] == N_CELLS
    assert stats["dispatches"] == int(admitted)
    refused = ts.AOT_CACHE.stats_dict()["refusals"]
    assert refused == ({} if admitted else {fleet_exe[1].label(): 1})


def test_fleet_miss_backs_the_fleet_bucket_off(fleet_exe, monkeypatch, chains):
    """A fleet whose polls gave up records one pessimistic sample on the
    fleet bucket in both packages: the next round's ``stage_fleet`` batches
    nothing, and each cell still races alone (the port enqueues its B=1
    chain)."""
    reset_fleet_table(fleet_exe)
    pin_rtt(monkeypatch, PINNED_RTT_S)
    ref_entries, port_entries = twin_fleet_entries()
    assert twin_stage(ref_entries, port_entries)["dispatches"] == 1
    assert chains["fleet"] == 1
    with monkeypatch.context() as m:
        m.setattr(ref_solver_mod._FleetBuffer, "is_ready", lambda self: False)
        m.setattr(solver_mod._FleetBuffer, "is_ready", lambda self: False)
        for entries in (ref_entries, port_entries):
            for solver, problem in entries:
                result = solver.solve(problem)
                assert result.stats["backend"] != 1.0
                assert problem.__dict__["_race_miss_count"] == 1
    _, fleet_key = fleet_exe
    want = J.AOT_CACHE.predicted_dispatch_s(fleet_key)
    got = ts.AOT_CACHE.predicted_dispatch_s(ts.BucketKey(*fleet_key))
    assert want >= BUDGET_S and got >= BUDGET_S
    assert [r[1:3] for r in ts.AOT_CACHE.table() if r[0] == fleet_key.label()] == [(got, 1)]
    ref_entries, port_entries = twin_fleet_entries()
    stats = twin_stage(ref_entries, port_entries)
    assert stats["dispatches"] == 0 and stats["eligible"] == N_CELLS
    for (rs, rp), (ps, pp) in zip(ref_entries, port_entries):
        assert rs._race_dispatch_affordable(rp) and ps._race_dispatch_affordable(pp)
        assert ps.solve(pp).stats.get("fleet_b") is None
    assert chains == {"fused": N_CELLS, "fleet": 1}


# ---------------------------------------------------------------------------
# the sentinel
# ---------------------------------------------------------------------------

PKGS = {"ref": (J, ref_solver_mod, ref_profiling, ref_cache_mod),
        "port": (ts, solver_mod, port_profiling, port_cache_mod)}


@pytest.fixture
def twin_sentinels(tmp_path):
    """Each package's process-wide sentinel, on, with its own baseline file
    and its own ``FakeClock``; off again afterwards."""
    for tag, (_, _, prof, cache) in PKGS.items():
        prof.SENTINEL.reset()
        d = tmp_path / tag
        d.mkdir()
        prof.SENTINEL.configure(enabled=True, sentinel_enabled=True, mad_k=3,
                                baseline_rounds=3, baseline_path=str(d / "b.json"),
                                profile_window_s=0.0, clock=cache.FakeClock(start=100.0).now)
    yield
    for _, _, prof, _ in PKGS.values():
        prof.SENTINEL.reset()
        prof.SENTINEL.configure(enabled=False, sentinel_enabled=False, mad_k=3,
                                baseline_rounds=20, baseline_path=None)


def fleet_buffer(tag, key, t_dispatch):
    mod, smod, _, _ = PKGS[tag]
    if tag == "ref":
        return smod._FleetBuffer(None, key, None, t_dispatch, N_CELLS)
    return smod._FleetBuffer(None, key, t_dispatch, N_CELLS)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sentinels_learn_the_same_dispatches(twin_sentinels, seed):
    """Rounds of flat samples and of fleets, each fleet noted by two polls
    (an observed transition or a poll that gave up, then another): twin
    sentinels fed by the two packages' tables hold equal per-bucket
    baselines. A fleet feeds one sample, its miss's pessimistic one
    included; the tables' fleet bucket learns the same."""
    rng = np.random.default_rng(seed)
    fields = dict(KEY, S=512)
    keys = {tag: (mod.BucketKey(**fields), mod.BucketKey(**fields, B=8))
            for tag, (mod, *_) in PKGS.items()}
    tables = {"ref": J.AOTCache(), "port": ts.AOTCache()}
    tables["ref"].configure(persist=False)
    for tag, (mod, smod, _, _) in PKGS.items():
        for k in keys[tag]:
            if tag == "ref":
                tables[tag]._entries[tables[tag]._ckey(k, False, None)] = J._AOTEntry("exe", 0.0)
            else:
                tables[tag].build(k)
    for r in range(8):
        flat = [float(x) for x in rng.lognormal(-6.0, 0.5, size=3)]
        t0, first, second = 50.0 + r, float(rng.uniform(0.001, 0.02)), float(rng.uniform(0.3, 1.0))
        miss = r in (4, 6)
        for tag, (mod, smod, prof, _) in PKGS.items():
            one, fleet = keys[tag]
            for s in flat:
                tables[tag].note_dispatch(one, s)
            buf = fleet_buffer(tag, fleet, t0)
            smod.AOT_CACHE, saved = tables[tag], smod.AOT_CACHE
            try:
                (buf.note_miss if miss else buf.note_ready)(t0 + (second if miss else first))
                buf.note_ready(t0 + second)  # a sibling's poll: the fleet fed already
            finally:
                smod.AOT_CACHE = saved
            prof.SENTINEL.tick()
    docs = {tag: prof.SENTINEL.snapshot()["buckets"] for tag, (_, _, prof, _) in PKGS.items()}
    assert sorted(docs["ref"]) == sorted(docs["port"]) == sorted(
        {k.label() for k in keys["port"]})
    for label, want in docs["ref"].items():
        got = docs["port"][label]
        assert got["state"] == want["state"] and got["rounds_seen"] == want["rounds_seen"]
        for f in ("ewma_s", "last_observed_s", "band_hi_s"):
            assert same(want[f], got[f]), (label, f)
        for f in want["baseline"] or {}:
            assert same(want["baseline"][f], got["baseline"][f]), (label, f)
    for tag in PKGS:
        one, fleet = keys[tag]
        assert tables[tag].predicted_dispatch_s(fleet) is not None
    assert same(tables["ref"].predicted_dispatch_s(keys["ref"][1]),
                tables["port"].predicted_dispatch_s(keys["port"][1]))
    assert tables["port"].table()[1][2] == 8  # one sample a fleet


def test_fleet_buffers_feed_once():
    """``note_ready`` and ``note_miss`` feed a fleet's sample at most once,
    whichever comes first."""
    key = ts.BucketKey(**KEY, B=8)
    table = ts.AOTCache()
    table.build(key)
    saved, solver_mod.AOT_CACHE = solver_mod.AOT_CACHE, table
    try:
        buf = solver_mod._FleetBuffer(None, key, 10.0, N_CELLS)
        buf.note_miss(10.25)
        buf.note_ready(10.01)
        buf.note_miss(10.5)
    finally:
        solver_mod.AOT_CACHE = saved
    assert table.table() == [(key.label(), 0.25, 1, 0.25)]
    assert math.isclose(table.predicted_dispatch_s(key), 0.25)
