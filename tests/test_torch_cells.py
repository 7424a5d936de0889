"""The port's cell partitioner and host pool against the JAX package's.

``karpenter_tpu_torch/state/cells.py`` and ``parallel/hostpool.py`` are
copies of the JAX package's modules. Here the same event streams, drawn from
numpy seeds, go through a ``CellRouter`` of each package: pod adds, deletes,
relabels that move a pod between cells, zone-pinned pools that split into
per-zone cells, gangs (whose members disagree on a cell, sending the gang to
the residue), and provisioner changes that repartition. After every step the
two routers must give the same ``plan_round`` cells and residue, the same
dirty set, ``cell_of``, ``ordered_pods`` and ``memory_bytes`` keys, and each
cell's session the same digest for its delta encode, which must also equal
a full encode of the session's pods. ``map_all`` and ``first_hit`` must
answer the same in both packages at 1 and 4 workers.
"""

from __future__ import annotations

import importlib
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

PACKAGES = ("karpenter_tpu", "karpenter_tpu_torch")
ZONES = ("zone-a", "zone-b", "zone-c")
CPUS = ("100m", "250m", "500m", "1")


def pkg_mod(pkg: str) -> SimpleNamespace:
    imp = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
    solver_mod = imp("solver.solver")
    return SimpleNamespace(
        api=imp("api"), wk=imp("api.labels"), cells=imp("state.cells"),
        encode=imp("solver.encode").encode, digest=solver_mod.problem_digest,
        catalog=imp("cloudprovider").generate_catalog(n_types=6),
        hostpool=imp("parallel.hostpool"),
    )


MODS = {pkg: pkg_mod(pkg) for pkg in PACKAGES}


def make_prov(m, spec):
    """``spec``: (name, pool label, taint key or None, resource version)."""
    name, pool, taint, rv = spec
    api = m.api
    prov = api.Provisioner(
        meta=api.ObjectMeta(name=name), labels={"pool": pool},
        taints=[api.Taint(key=taint, value="x", effect="NoSchedule")] if taint else [],
    )
    prov.meta.resource_version = rv
    return prov


def make_pod(m, spec):
    """``spec``: (name, pool or None, cpu index, zone or None, gang or None,
    tolerated taint or None)."""
    name, pool, cpu, zone, gang, tol = spec
    api, wk = m.api, m.wk
    sel = {}
    if pool is not None:
        sel["pool"] = pool
    if zone is not None:
        sel[wk.ZONE] = zone
    labels = {wk.POD_GROUP: gang} if gang else {}
    pod = api.Pod(
        meta=api.ObjectMeta(name=name, labels=labels, owner_kind="ReplicaSet"),
        requests=api.Resources(cpu=CPUS[cpu], memory="128Mi"),
        node_selector=sel,
        tolerations=[api.Toleration(key=tol, operator="Exists")] if tol else [],
    )
    if gang:
        pod.meta.annotations[wk.POD_GROUP_MIN_MEMBERS] = "2"
    return pod


class Twin:
    """One package's router and the objects built for it."""

    def __init__(self, pkg: str):
        self.m = MODS[pkg]
        self.router = self.m.cells.CellRouter()
        self.pods = {}
        self.provs = {}

    def prov(self, spec):
        self.provs[spec[0]] = make_prov(self.m, spec)

    def event(self, kind, spec):
        pod = make_pod(self.m, spec)
        if kind == "DELETED":
            pod = self.pods.pop(spec[0])
        else:
            self.pods[spec[0]] = pod
        self.router.pod_event(kind, pod)

    def plan(self, order):
        provs = [self.provs[n] for n in sorted(self.provs)]
        return self.router.plan_round([self.pods[n] for n in order], provs)

    def encode_cells(self, plan):
        """Each planned cell's (and the residue's) delta digest and a full
        encode's of its session's pods."""
        out = {}
        provs = [self.provs[n] for n in sorted(self.provs)]
        work = [(key, pods, [(self.provs[key[0]], self.m.catalog)]) for key, pods in plan.cells]
        if plan.residue:
            work.append((self.m.cells.RESIDUE, plan.residue,
                         [(p, self.m.catalog) for p in provs]))
        for key, pods, entry in work:
            session = self.router.session(key)
            delta = session.encode(pods, entry)
            full = self.m.encode(session.ordered_pods(), entry)
            out[key] = (self.m.digest(delta).hex(), self.m.digest(full).hex(),
                        session.last_mode)
            self.router.mark_clean(key)
        return out


def event_stream(seed: int, steps: int = 8):
    """Per step: ``(provisioner specs to (re)apply, [(event, pod spec)])``,
    from a numpy seed."""
    rng = np.random.default_rng(seed)
    provs = {"cell-a": ("cell-a", "a", None, 1), "cell-b": ("cell-b", "b", None, 2),
             "cell-c": ("cell-c", "c", "dedicated", 3)}
    rv = 3
    live, serial, out = {}, 0, []
    for step in range(steps):
        prov_ops = list(provs.values()) if step == 0 else []
        if step and rng.random() < 0.3:
            # a provisioner change: a new pool, or a relabel of pool b that
            # makes its pods cross-cell with pool a
            rv += 1
            if "cell-d" not in provs:
                provs["cell-d"] = ("cell-d", "d", None, rv)
            else:
                name, pool, taint, _ = provs["cell-b"]
                provs["cell-b"] = (name, "a" if pool == "b" else "b", taint, rv)
            prov_ops = list(provs.values())
        events = []
        for _ in range(int(rng.integers(3, 9))):
            serial += 1
            name = f"p{serial}"
            kind = rng.random()
            if kind < 0.15:
                spec = (name, None, int(rng.integers(0, 4)), None, None, None)  # residue
            elif kind < 0.3:
                # pool c is tainted and zone-pinned: its cell splits by zone
                spec = (name, "c", int(rng.integers(0, 4)), ZONES[int(rng.integers(0, 3))], None,
                        "dedicated")
            elif kind < 0.4:
                gang = f"g{int(rng.integers(0, 3))}"
                pool = "a" if rng.random() < 0.7 else "b"
                spec = (name, pool, 1, None, gang, None)
            else:
                pool = "abd"[int(rng.integers(0, 3))] if "cell-d" in provs else "ab"[
                    int(rng.integers(0, 2))]
                zone = ZONES[int(rng.integers(0, 3))] if rng.random() < 0.2 else None
                spec = (name, pool, int(rng.integers(0, 4)), zone, None, None)
            live[name] = spec
            events.append(("ADDED", spec))
        names = sorted(live, key=lambda n: int(n[1:]))
        for name in [names[i] for i in rng.permutation(len(names))[: int(rng.integers(0, 3))]]:
            events.append(("DELETED", live.pop(name)))
        if live and rng.random() < 0.6:
            # a relabel (MODIFIED): the pod moves to another pool's cell
            name = sorted(live, key=lambda n: int(n[1:]))[int(rng.integers(0, len(live)))]
            old = live[name]
            if old[1] in ("a", "b") and old[4] is None:
                live[name] = (name, "b" if old[1] == "a" else "a") + old[2:]
                events.append(("MODIFIED", live[name]))
        order = sorted(live, key=lambda n: int(n[1:]))
        out.append((prov_ops, events, order))
    return out


def plan_view(m, router, plan, names):
    return dict(
        cells=[(key, [p.meta.name for p in pods]) for key, pods in plan.cells],
        residue=[p.meta.name for p in plan.residue],
        dirty=sorted(plan.dirty),
        cell_of={n: router.map.cell_of(n) for n in names},
        ordered=[p.meta.name for p in router.ordered_pods()],
        cell_names=[m.cells.cell_name(key) for key, _ in plan.cells],
    )


@pytest.mark.parametrize("seed", range(4))
def test_router_matches_reference(seed):
    twins = {pkg: Twin(pkg) for pkg in PACKAGES}
    saw = {"zones": False, "residue": False, "delta": False}
    for step, (prov_ops, events, order) in enumerate(event_stream(seed)):
        views, digests = {}, {}
        for pkg, twin in twins.items():
            for spec in prov_ops:
                twin.prov(spec)
            for kind, spec in events:
                twin.event(kind, spec)
            plan = twin.plan(order)
            views[pkg] = plan_view(twin.m, twin.router, plan, order)
            digests[pkg] = twin.encode_cells(plan)
            mem = twin.router.memory_bytes()
            views[pkg]["memory_keys"] = sorted(mem)
            assert all(v >= 0 for v in mem.values())
        assert views["karpenter_tpu_torch"] == views["karpenter_tpu"], (seed, step)
        assert digests["karpenter_tpu_torch"] == digests["karpenter_tpu"], (seed, step)
        for key, (delta, full, _) in digests["karpenter_tpu_torch"].items():
            assert delta == full, (seed, step, key)
        view = views["karpenter_tpu_torch"]
        saw["zones"] |= any(k[1] != "*" for k, _ in view["cells"])
        saw["residue"] |= bool(view["residue"])
        saw["delta"] |= any(mode == "delta" for *_, mode in digests["karpenter_tpu_torch"].values())
    # every seed reaches per-zone cells, the residue and delta encodes
    assert all(saw.values()), saw


def test_feasibility_helpers_match_reference():
    """``feasible_provisioners``, ``zone_pin``, ``pod_feas_key`` and
    ``cell_name`` on every pod of a stream, in both packages."""
    specs = [spec for _, events, _ in event_stream(7) for _, spec in events]
    provs_spec = [("cell-a", "a", None, 1), ("cell-b", "b", None, 2),
                  ("cell-c", "c", "dedicated", 3), ("cell-d", "d", None, 4)]
    got = {}
    for pkg in PACKAGES:
        m = MODS[pkg]
        provs = [make_prov(m, s) for s in provs_spec]
        rows = []
        for spec in specs:
            pod = make_pod(m, spec)
            rows.append((m.cells.feasible_provisioners(pod, provs), m.cells.zone_pin(pod),
                         m.cells.pod_feas_key(pod)))
        rows.append([m.cells.cell_name(k) for k in
                     (("cell-a", "*"), ("cell-c", "zone-b"), m.cells.RESIDUE)])
        got[pkg] = rows
    assert got["karpenter_tpu_torch"] == got["karpenter_tpu"]


def test_benign_full_reasons_match_flight_recorder():
    """The router reads the benign full-encode reasons from the port's
    flight recorder, whose tuple is the reference's; it keeps no copy."""
    from karpenter_tpu.utils.flightrecorder import _BENIGN_FULL_REASONS
    from karpenter_tpu_torch.utils import flightrecorder

    assert flightrecorder._BENIGN_FULL_REASONS == _BENIGN_FULL_REASONS
    assert not hasattr(MODS["karpenter_tpu_torch"].cells, "_BENIGN_FULL_REASONS")
    for pkg in PACKAGES:
        router = MODS[pkg].cells.CellRouter()
        router.note_round_modes([("delta", ""), ("full", "first-encode"), ("full", "desync")])
        assert (router.last_mode, router.last_full_reason) == ("full", "desync")


def _square(i, x):
    time.sleep(0.001 * ((7 * i) % 3))  # finish out of order
    return (i, x * x, threading.current_thread() is threading.main_thread())


def _hit(i, x):
    return None if x % 7 != 3 else (i, x)


@pytest.mark.parametrize("workers", [1, 4])
def test_hostpool_matches_reference(workers):
    items = list(range(23))
    got = {}
    for pkg in PACKAGES:
        pool = MODS[pkg].hostpool
        squares = pool.map_all(_square, items, workers)
        on_main = {row[2] for row in squares}
        assert on_main == ({True} if workers == 1 else {False})
        got[pkg] = (
            [row[:2] for row in squares],
            pool.first_hit(_hit, items, workers),
            pool.first_hit(lambda i, x: None, items, workers),
            pool.default_workers(3), pool.default_workers(0, cap=2) <= 2,
        )
    assert got["karpenter_tpu_torch"] == got["karpenter_tpu"]
    assert got["karpenter_tpu_torch"][1] == (3, (3, 3))
    assert got["karpenter_tpu_torch"][0] == [(i, i * i) for i in items]


def test_map_all_reraises_a_workers_exception():
    """A worker's exception reaches the caller: the sharded round's fan-out
    has no ``except`` around it, so a kernel's error on a worker thread
    raises out of ``reconcile``."""
    pool = MODS["karpenter_tpu_torch"].hostpool

    def boom(i, x):
        if i == 5:
            raise RuntimeError("kernel launch failed")
        return x

    with pytest.raises(RuntimeError, match="kernel launch failed"):
        pool.map_all(boom, list(range(8)), 4)
