"""The 95th percentile of the rounds' spans, from the round's first watch
event to the return of its last ``solve_pods``, over all rounds of the
window (rounds that raised included)."""

import numpy as np


def read(run):
    return float(np.percentile([r.span for r in run.rounds], 95)) * 1e3
