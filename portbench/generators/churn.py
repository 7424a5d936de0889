"""Churn: each round moves a share of some cells' pods from one deployment
to another, fed to each cell's encode session as watch events.

A frozen copy of the schedules of the port's ``configs.config_delta_reconcile``
(``karpenter_tpu_torch/configs.py:277-316``: 1% of the pods replaced a round,
half deleted from one deployment and as many added to the deployment 7
further on) and ``configs.churn_cell_events`` (``configs.py:127-209``: 1% of
4 cells' pods moved from deployment ``d{r}`` to ``d{r+5}`` a round).

The traffic file's parameters: ``cells_per_round`` (k), ``churn_share`` (the
share of a cell's pods deleted, and as many added, a round) and
``up_offset``; ``workers``, the host threads the cells' solves fan out over
where a round has several cells. Round r churns cells ``((r + o) k + j) mod
n_cells`` for j < k, removing the oldest pods of deployment ``(r + o) mod D``
and adding as many to deployment ``(r + o + up_offset) mod D``. The seed
draws only the start ``o``: every seed plays the same moves, in another
order.

A generator module gives ``Traffic(params, inputs)`` with ``session`` (the
cells keep encode sessions), ``next_round()`` (round r's raw events, applied
to the raw inputs), ``apply(program, raw)`` (the same, to the program's
objects: what the harness hands ``solve``) and ``solve(cell, events)``
(inside the window: returns ``[(cell index, result, staged problem or
None)]``).
"""

from __future__ import annotations

import numpy as np


class Traffic:
    session = True

    def __init__(self, params: dict, inputs):
        self.p = params
        self.inp = inputs
        rng = np.random.default_rng([inputs.seed, 0x7072])
        self.step = int(rng.integers(0, inputs.n_cells * inputs.n_deploys))
        self.r = 0

    def next_round(self) -> dict:
        """``{cell: (removed names, [(name, deployment)] added)}``."""
        inp, p, r = self.inp, self.p, self.r + self.step
        self.r += 1
        D, k = inp.n_deploys, p["cells_per_round"]
        n = max(int(inp.config["n_pods"] // inp.n_cells * p["churn_share"]), 1)
        down, up = r % D, (r + p["up_offset"]) % D
        events = {}
        for j in range(k):
            c = (r * k + j) % inp.n_cells
            names = inp.live[c][down]
            removed = [names.popleft() for _ in range(min(n, len(names)))]
            added = [(f"c{c}-u{inp.serial + i}-d{up}", up) for i in range(n)]
            inp.serial += n
            inp.live[c][up].extend(name for name, _ in added)
            events[c] = (removed, added)
        return events

    def apply(self, program, raw: dict) -> dict:
        """``{cell: (removed Pods, added Pods)}``, the watch events."""
        return {c: program.churn(c, *ev) for c, ev in raw.items()}

    def solve(self, cell, events: dict) -> list:
        return cell.solve_cells(events, workers=self.p.get("workers", 1))
