"""Host ms spent in CPython's garbage collector, mean per round."""


def read(run):
    return sum(r.gc_s for r in run.rounds) / len(run.rounds) * 1e3
