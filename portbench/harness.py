"""Runs one cell: set-up, the measured window, the check and the metrics.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``. Its configuration
(``configs/<config>.json``) gives the sizes the raw inputs are made from and
names its builder (``builders/<builder>.py``), which makes them; its traffic
(``traffic/<traffic>.json``) gives the parameters of the rounds and names its
generator (``generators/<generator>.py``), which plays them; each metric is
read by ``metrics/<name>.py``. All are found by name. The loop is closed: one controller
plans a round, and the next round starts when that plan returns. The window
is the sum of the rounds' spans, each from the round's first watch event to
the return of the last ``solve_pods``; the harness's own work between rounds
(making the next round's pods, keeping a checked round's plan) is outside it.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np

from . import counts, reference, trace as tracing

ROOT = Path(__file__).resolve().parent
BANNED = ("jax", "jaxlib", "flax", "karpenter_tpu")
LIMITS = reference.LIMITS
#: the most dirty cells one ``stage_fleet`` dispatch stacks
FLEET_MAX_BATCH = 16


def banned_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its relatives' or the
    JAX package's, compared as whole names."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(BANNED))


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_part(kind: str, name: str):
    """``builders/<name>.py`` or ``generators/<name>.py``, as a module."""
    if not name.isidentifier():
        raise ValueError(f"{kind} {name!r} is not a module name")
    return importlib.import_module(f"{__package__}.{kind}.{name}")


def load_metric(name: str):
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Round:
    """What one round leaves for the metrics: its span, pods, stats, costs
    and each problem's raw counts for the lower bound."""

    __slots__ = ("span", "pods", "stats", "cost", "counts", "gc_s", "staged", "shapes")

    def __init__(self):
        self.stats, self.counts, self.shapes = [], [], []
        self.cost = 0.0
        self.gc_s = 0.0
        self.staged = 0


class Cell:
    """One cell's program state: the inputs and the program's objects (from
    the configuration's builder), the traffic's generator, one solver and
    encode session a cell of the configuration, and the round loop."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: str,
                 traced: bool = False):
        from karpenter_tpu_torch.solver import EncodeSession, TorchSolver

        self.traffic = traffic
        self.traced = traced
        self.builder = load_part("builders", config["builder"])
        self.inputs = self.builder.Inputs(config, seed)
        self.gen = load_part("generators", traffic["generator"]).Traffic(traffic, self.inputs)
        self.program = self.builder.Program(self.inputs)
        n = self.inputs.n_cells
        self.solvers = [TorchSolver(device=device, latency_budget_s=config["latency_budget_s"])
                        for _ in range(n)]
        self.sessions = [EncodeSession() if self.gen.session else None for _ in range(n)]
        self.catalog = reference.Catalog(self.inputs.records)
        self.rounds = []
        self.checks = {}
        self.failed = 0
        self.attempted = 0
        self.errors = []
        self.gc = counts.GcClock()

    # -- spans ------------------------------------------------------------
    @contextlib.contextmanager
    def part(self, label: str):
        """A harness span of the round: in a traced run a range in the
        profiler's timeline, named ``portbench.<label>``."""
        if self.traced:
            import torch

            with torch.profiler.record_function(f"portbench.{label}"):
                yield
        else:
            yield

    # -- rounds -----------------------------------------------------------
    def seed_round(self):
        """Every cell solved once in full: what a controller does at start."""
        self.solve_cells({c: None for c in range(self.inputs.n_cells)})

    def next_events(self) -> dict:
        """The traffic's next round, applied to the raw state and the
        program's objects (outside the window), as the generator hands it
        to its ``solve``."""
        return self.gen.apply(self.program, self.gen.next_round())

    def solve(self, events: dict) -> list:
        return self.gen.solve(self, events)

    def solve_cells(self, events: dict, workers: int = 1) -> list:
        """Feed each cell's watch events (``{cell: (removed Pods, added
        Pods)}``, or None for none) to its session, then plan every cell of
        ``events``: one ``solve_pods``, or, for several cells, their
        encodes, one ``stage_fleet`` and the cells' solves fanned out over
        ``workers`` host threads."""
        from karpenter_tpu_torch.parallel.hostpool import map_all
        from karpenter_tpu_torch.solver import stage_fleet

        prog = self.program
        cells = list(events)
        with self.part("feed"):
            for c in cells:
                if events[c] is not None and self.sessions[c] is not None:
                    removed, added = events[c]
                    for q in removed:
                        self.sessions[c].pod_event("DELETED", q)
                    for q in added:
                        self.sessions[c].pod_event("ADDED", q)
            pods = {c: list(prog.pods[c].values()) for c in cells}
        if len(cells) == 1:
            c = cells[0]
            with self.part("solve_pods"):
                res = self.solvers[c].solve_pods(pods[c], prog.provs(c), session=self.sessions[c])
            return [(c, res, None)]
        owners = [self.solvers[c] for c in cells]
        with self.part("encode_for_staging"):
            staged = [s.encode_for_staging(pods[c], prog.provs(c), session=self.sessions[c])
                      for s, c in zip(owners, cells)]
        with self.part("stage_fleet"):
            for s, q in zip(owners, staged):
                s.prestage(q)
            stage_fleet(list(zip(owners, staged)), max_batch=FLEET_MAX_BATCH)
        with self.part("solve_pods"):
            results = map_all(
                lambda i, c: owners[i].solve_pods(pods[c], prog.provs(c), session=self.sessions[c],
                                                  pre_encoded=staged[i]),
                cells, workers)
        return list(zip(cells, results, staged))

    def play(self, events: dict, keep: bool) -> Round:
        """One round of the window; ``keep`` snapshots its raw pods and
        plans for the check."""
        rnd = Round()
        staged0 = self._staged()
        gc0 = self.gc.seconds
        t0 = time.perf_counter()
        try:
            with self.part("round"):
                solved = self.solve(events)
        except Exception as exc:  # a round that raises counts as failed
            rnd.span, rnd.pods = time.perf_counter() - t0, 0
            self.attempted += len(events)
            self.failed += len(events)
            self.errors.append(f"round {len(self.rounds)}: {type(exc).__name__}: {exc}")
            self.rounds.append(rnd)
            return rnd
        rnd.span = time.perf_counter() - t0
        rnd.gc_s = self.gc.seconds - gc0
        rnd.staged = self._staged() - staged0
        rnd.pods = 0
        self.attempted += len(solved)
        for c, res, problem in solved:
            rnd.pods += len(self.program.pods[c])
            rnd.cost += float(res.cost)
            rnd.stats.append(dict(res.stats))
            rnd.counts.append(self.inputs.counts(c))
        self.rounds.append(rnd)
        if keep:
            for c, res, problem in solved:
                self._check(c, res, problem)
        return rnd

    def _staged(self) -> int:
        return sum(s._stager.stats["bytes_transferred"] for s in self.solvers
                   if getattr(s, "_stager", None) is not None)

    def _check(self, c: int, res, problem) -> None:
        """Hold one problem's plan and encode to the reference."""
        one = self.builder.check(self, c, res, problem)
        if any(one[k] > LIMITS[k] for k in one):
            self.failed += 1
        reference.merge(self.checks, one)

    # -- the run ----------------------------------------------------------
    def measure(self, seconds: float, trace_rounds: int) -> dict:
        """The window: rounds until their spans add up to ``seconds``. In
        a traced run the profiler covers the first ``trace_rounds`` rounds.
        The checked rounds are drawn from the seed."""
        rng = np.random.default_rng([self.inputs.seed, 0x636B])
        expect = max(int(seconds * self.traffic["rounds_per_s"]), 1)
        keep = set(rng.choice(expect, min(self.traffic["check_rounds"], expect),
                              replace=False).tolist())
        keep.add(0)
        prof = tracing.Profiler() if self.traced else None
        window = 0.0
        i = 0
        self.gc.start()
        try:
            while window < seconds:
                events = self.next_events()
                if prof is not None and i == 0:
                    prof.start()
                rnd = self.play(events, keep=i in keep)
                window += rnd.span
                i += 1
                if prof is not None and prof.running and (i >= trace_rounds or window >= seconds):
                    prof.stop()
        finally:
            self.gc.stop()
            if prof is not None and prof.running:
                prof.stop()
        return {"window_s": window, "trace": prof.summary if prof is not None else None}


def run_cell(bench: dict, name: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_start: float = None, config_override: dict = None) -> dict:
    """Set up, measure and check one cell. Returns the contract's result
    object and the check's lines for standard error."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    spec = next(w for w in bench["workloads"] if w["name"] == name)
    cfg_entry = next(c for c in bench["configs"] if c["name"] == spec["config"])
    config = load_json(ROOT.parent / cfg_entry["file"])
    config.update(config_override or {})
    traffic = load_json(ROOT / "traffic" / f"{spec['traffic']}.json")
    cell = Cell(config, traffic, seed, device, traced)
    from karpenter_tpu_torch.utils.gctuning import freeze_long_lived

    cell.seed_round()
    # the operator freezes the heap after its first reconcile
    freeze_long_lived()
    for _ in range(traffic["warmup_rounds"]):
        cell.solve(cell.next_events())
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    out = cell.measure(seconds, traffic["trace_rounds"])
    if device == "cuda":
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated())
        kind, count = torch.cuda.get_device_name(0), spec["chips"]
    else:
        peak, kind, count = 0, "cpu", 0
    # the program's state goes before the reference's bounds are worked out
    rounds, demand = cell.rounds, cell.inputs.demand
    lbs = [[cell.catalog.lower_bound(n, demand) for n in r.counts] for r in rounds]
    for r in rounds:
        r.shapes = [cell.catalog.shapes(n, demand) for n in r.counts]
    run = Run(rounds, lbs, setup_s, out["window_s"], out["trace"])
    del cell.solvers, cell.sessions, cell.program
    kinds = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in bench[kinds]:
        if name not in m.get("workloads", [name]):
            continue
        value = load_metric(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {k: {"value": cell.checks.get(k, 0), "limit": LIMITS[k]} for k in LIMITS}
    lost = [t.name for t in threading.enumerate()
            if t is not threading.main_thread() and not t.daemon]
    correct = (cell.failed == 0 and not cell.errors and bool(cell.checks)
               and all(v["value"] <= v["limit"] for v in checks.values()))
    result = {"correct": correct, "attempted": cell.attempted, "failed": cell.failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if device == "cuda" else "cpu", "kind": kind,
                         "count": count, "memory_peak_bytes": peak}}
    if traced and out["trace"] is not None:
        result["device"]["busy_s"] = out["trace"]["busy_s"]
        result["device"]["window_s"] = out["trace"]["window_s"]
        result["breakdown"] = out["trace"]["breakdown"]
    result["checks"] = checks
    lines = [f"error: {e}" for e in cell.errors[:5]] + [f"threads left: {lost}"] * bool(lost)
    lines += [f"check {k}: {v['value']!r} limit {v['limit']!r}" for k, v in checks.items()]
    return {"result": result, "stderr": lines}


class Run:
    """What the metric readers read."""

    def __init__(self, rounds, lbs, setup_s, window_s, trace):
        self.rounds = rounds
        self.lbs = lbs
        self.setup_s = setup_s
        self.window_s = window_s
        self.trace = trace
