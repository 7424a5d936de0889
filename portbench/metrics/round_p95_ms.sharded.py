"""``round_p95_ms``, read in the cells whose windows hold too few rounds for it
to stand as an end-to-end metric."""

from portbench.harness import load_metric

read = load_metric("round_p95_ms")
