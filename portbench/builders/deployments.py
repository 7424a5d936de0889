"""Configurations of deployments: each cell a pool of pods in deployments of
one request shape each, over one instance-type catalog. Makes the raw inputs
from a configuration's sizes and ``--seed``, the program's objects from them
(``adapter.Program``), and checks a plan against the raw inputs.

The deployments and their shapes are frozen copies of the port's
``configs.config_delta_reconcile`` (``karpenter_tpu_torch/configs.py:277-316``:
30 deployments over the 6 cpu x 6 memory shapes) and ``configs.config_cells``
(``configs.py:127-209``: 20 cells of 12 deployments).

A builder module gives ``Inputs(config, seed)``, ``Program(inputs)`` and
``check(cell, c, result, problem)``; the harness uses nothing else of it.
"""

from __future__ import annotations

import collections

import numpy as np

from .. import catalog as cat, reference
from ..adapter import Program  # noqa: F401  (the builder's program objects)

_BINARY = {"Ki": 1024, "Mi": 1024**2, "Gi": 1024**3}


def milli_cpu(q: str) -> int:
    return int(q[:-1]) if q.endswith("m") else int(float(q) * 1000)


def mem_bytes(q: str) -> int:
    return int(q[:-2]) * _BINARY[q[-2:]] if q[-2:] in _BINARY else int(q)


class Inputs:
    """A configuration's raw state from the seed: the catalog records, one
    pool (provisioner) a cell, the deployments' shapes, and each cell's live
    pods, oldest first, per deployment."""

    def __init__(self, config: dict, seed: int):
        self.config = config
        self.seed = int(seed)
        self.n_cells = config["n_cells"]
        self.n_deploys = config["n_deploys"]
        self.records = cat.catalog(config["n_types"], tuple(config["zones"]))
        cpus, mems = config["cpus"], config["mems"]
        # deployment d's requests, as the port's configs shape them
        self.shapes = [(cpus[d % len(cpus)], mems[(d // 2) % len(mems)])
                       for d in range(self.n_deploys)]
        self.demand = np.array([[milli_cpu(c), mem_bytes(m), 1] for c, m in self.shapes],
                               dtype=np.int64)
        per_cell = config["n_pods"] // self.n_cells
        per_dep = per_cell // self.n_deploys + 1
        self.live = []
        for c in range(self.n_cells):
            deps, n = [collections.deque() for _ in range(self.n_deploys)], 0
            for d in range(self.n_deploys):
                for i in range(per_dep):
                    if n >= per_cell:
                        break
                    deps[d].append(f"c{c}-d{d}-{i}")
                    n += 1
            self.live.append(deps)
        self.serial = 0

    def pool(self, c: int) -> str:
        """The name of cell ``c``'s provisioner."""
        return f"cell-{c:02d}" if self.config["cell_pools"] else "default"

    def cell_pods(self, c: int) -> dict:
        """Cell ``c``'s live pods, name -> deployment, in no particular order."""
        return {name: d for d, names in enumerate(self.live[c]) for name in names}

    def counts(self, c: int) -> np.ndarray:
        return np.array([len(names) for names in self.live[c]], dtype=np.int64)


def check(cell, c: int, res, problem) -> dict:
    """Hold one problem's plan and encode to the reference: the numbers of
    ``reference.LIMITS``."""
    from karpenter_tpu_torch.solver.solver import problem_digest

    inp = cell.inputs
    pods = inp.cell_pods(c)
    nodes = [(n.option.provisioner.meta.name, n.instance_type_name, n.option.zone,
              n.option.capacity_type, n.price, list(n.pod_names)) for n in res.new_nodes]
    for node, names in res.existing_assignments.items():
        nodes.append(("existing", node, "", "", 0.0, list(names)))
    one = reference.check_plan(cell.catalog, pods, inp.demand, inp.pool(c), nodes,
                               list(res.unschedulable), float(res.cost))
    if problem is None:
        slots = getattr(cell.solvers[c], "_interned_problems", [])
        problem = next((p for p in reversed(slots)
                        if problem_digest(p).hex() == res.problem_digest), None)
    if problem is None:
        one["encode_gap"] = len(pods)
    else:
        groups = [(float(problem.demand[g, 0]), float(problem.demand[g, 1]),
                   int(problem.count[g])) for g in range(problem.G)]
        one["encode_gap"] = reference.encode_gap(pods, inp.demand, groups)
    return one
