"""The check's control and planted faults, read at a cell's own size.

    python3 portbench/control.py --workload delta50k.churn --seeds 11,12,13 --rounds 4

For each seed it builds the cell as a run does and reads the numbers the
check compares under each mode, ``--rounds`` checked rounds a mode:

- ``capacity``: the control. The program's place is taken by the reference
  packer (``pack``), a plain per-deployment packer that fills each node to
  its type's capacity, the reserved overhead forgotten. It breaks the
  configuration's guarantee that every node stays within its type's
  allocatable; packing to allocatable, the same packer keeps it.
- ``stale``: ``solve_pods`` returns the plan of the call before, the
  round's answer left as it was.
- ``half``: half of the plan's nodes left out.
- ``type``: one node's instance type altered to the catalog's smallest.
- ``zone``: one node's zone altered to one the catalog does not offer.
- ``price``: the plan's reported $/h altered by 0.1%.
- ``encode``: one pod taken from the first group where the encode's
  problem is interned.

Prints one JSON line a seed: the numbers of each mode, and those of the
program's own rounds (``sound``).
"""

from __future__ import annotations

import contextlib
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MODES = ("sound", "capacity", "stale", "half", "type", "zone", "price", "encode")


def pack(catalog, counts, demand, pool: str, table: str = "alloc"):
    """The reference packer: each deployment's pods on the offering with the
    lowest price a pod, filled ``k`` to a node (``reference.Catalog.per_node``
    with ``table``: ``alloc``, allocatable; ``capacity``, the whole machine,
    the reserved overhead forgotten). Returns the plan's nodes, with
    placeholder pod names ``"<deployment>:<i>"``, and its $/h."""
    names = list(catalog.alloc)
    j, k, best = catalog.per_node(demand, table)
    nodes, cost = [], 0.0
    for d, n in enumerate(counts):
        if n <= 0:
            continue
        p, z, ct = best[j[d]]
        for i in range(0, int(n), int(k[d])):
            take = min(int(k[d]), int(n) - i)
            nodes.append((pool, names[j[d]], z, ct, p, [f"{d}:{q}" for q in range(i, i + take)]))
            cost += p
    return nodes, cost


@contextlib.contextmanager
def planted(mode: str, smallest: str):
    """Plant a fault in the program's solver for the block."""
    from karpenter_tpu_torch.solver.solver import Solver

    orig_solve, orig_intern = Solver.solve_pods, Solver._intern_problem
    last = {}

    def solve(self, *a, **kw):
        res = orig_solve(self, *a, **kw)
        if mode == "stale":
            prev = last.get("plan")
            last["plan"] = res
            return prev if prev is not None else res
        if mode == "half":
            res.new_nodes = res.new_nodes[: len(res.new_nodes) // 2]
        elif mode == "type" and res.new_nodes:
            node = copy.copy(res.new_nodes[0])
            node.option = copy.copy(node.option)
            node.option.instance_type = copy.copy(node.option.instance_type)
            node.option.instance_type.name = smallest
            res.new_nodes[0] = node
        elif mode == "zone" and res.new_nodes:
            node = copy.copy(res.new_nodes[0])
            node.option = copy.copy(node.option)
            node.option.zone = "zone-x"
            res.new_nodes[0] = node
        elif mode == "price":
            res.cost *= 1.001
        return res

    def intern(self, problem):
        problem = orig_intern(self, problem)
        if mode == "encode" and problem.G:
            problem.count = problem.count.copy()
            problem.count[0] -= 1
        return problem

    Solver.solve_pods, Solver._intern_problem = solve, intern
    try:
        yield
    finally:
        Solver.solve_pods, Solver._intern_problem = orig_solve, orig_intern


def readings(workload: str, seed: int, rounds: int, device: str = "cuda",
             config_override: dict = None, modes=MODES) -> dict:
    """The numbers the check compares, by mode, for one seed."""
    from portbench import harness, reference

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = next(w for w in bench["workloads"] if w["name"] == workload)
    entry = next(c for c in bench["configs"] if c["name"] == spec["config"])
    config = harness.load_json(ROOT / entry["file"])
    config.update(config_override or {})
    traffic = harness.load_json(harness.ROOT / "traffic" / f"{spec['traffic']}.json")
    cell = harness.Cell(config, traffic, seed, device)
    cell.seed_round()
    smallest = min(cell.inputs.records, key=lambda r: r["capacity"]["cpu"])["name"]
    out = {}
    for mode in modes:
        cell.checks, cell.failed = {}, 0
        fault = planted(mode, smallest) if mode not in ("sound", "capacity") else contextlib.nullcontext()
        with fault:
            for _ in range(rounds):
                events = cell.next_events()
                if mode != "capacity":
                    cell.play(events, keep=True)
                    continue
                for c in events:
                    pods = cell.inputs.cell_pods(c)
                    nodes, cost = pack(cell.catalog, cell.inputs.counts(c), cell.inputs.demand,
                                       cell.inputs.pool(c), "capacity")
                    reference.merge(cell.checks, reference.check_plan(
                        cell.catalog, pods, cell.inputs.demand, cell.inputs.pool(c),
                        _names(nodes, pods), [], cost))
                # the program's sessions still follow the cluster
                cell.solve(events)
        out[mode] = dict(cell.checks)
    return out


def _names(nodes, pods: dict):
    """Give the packer's placeholder pods the cell's real names, deployment
    by deployment."""
    by_dep = {}
    for name, d in pods.items():
        by_dep.setdefault(d, []).append(name)
    out = []
    for pool, t, z, ct, p, names in nodes:
        real = []
        for ph in names:
            d, q = ph.split(":")
            real.append(by_dep[int(d)][int(q)])
        out.append((pool, t, z, ct, p, real))
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--modes", default=",".join(MODES))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("the control is read on the card", file=sys.stderr)
        return 2
    for seed in args.seeds.split(","):
        t0 = time.perf_counter()
        r = readings(args.workload, int(seed), args.rounds, modes=args.modes.split(","))
        print(json.dumps({"workload": args.workload, "seed": int(seed), "readings": r,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
