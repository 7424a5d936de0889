"""The share of races that the kernel's plan won (``stats["backend"]`` 1),
in %, over the problems that raced the host path (``race_host_s`` set)."""


def read(run):
    races = [s for r in run.rounds for s in r.stats if "race_host_s" in s]
    if not races:
        return None
    return 100.0 * sum(s.get("backend") == 1.0 for s in races) / len(races)
