"""The race's host path (``stats["race_host_s"]``), mean per race, in ms."""


def read(run):
    xs = [s["race_host_s"] for r in run.rounds for s in r.stats if "race_host_s" in s]
    return sum(xs) / len(xs) * 1e3 if xs else None
