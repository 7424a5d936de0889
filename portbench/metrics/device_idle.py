"""The share of the traced rounds' time in which no operation ran on the
card, in %, from the ``torch.profiler`` timeline."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
