"""The plans' $/h summed over the window over the sum of the problems'
fractional lower bounds, which the benchmark works out from the raw counts
and catalog records after the window (``reference.Catalog.lower_bound``)."""


def read(run):
    cost = sum(r.cost for r in run.rounds if r.counts)
    bound = sum(sum(lbs) for lbs in run.lbs)
    return cost / bound if bound > 0 else None
