"""Cells solved over chains launched in the traced rounds: the problems of
the rounds whose chains ran, over the ``k3_pack_epilogue`` launches (one a
chain, whatever its batch)."""


def read(run):
    t = run.trace
    if not t:
        return None
    cells = chains = 0
    for r, launches in zip(run.rounds, t["per_round"]):
        k3 = sum(n for name, n in launches.items() if "k3_pack_epilogue" in name)
        if k3:
            cells += len(r.stats)
            chains += k3
    return cells / chains if chains else None
