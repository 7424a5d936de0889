"""The chain's share of its roofline, in %: the least time of K1, K2, K2
and K3 for every chain in the traced rounds, over the device time of the
chain's kernels and the staging kernels (``stage_patch``, ``fleet_stack``)."""

from portbench import roofline


def read(run):
    return roofline.share(run, 1, roofline.CHAIN)
