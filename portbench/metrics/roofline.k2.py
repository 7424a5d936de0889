"""K2's share of its roofline, in %: the least time of the two K2 launches
of every chain in the traced rounds, over ``k2_prices`` + ``k2_scan``'s
device time."""

from portbench import roofline


def read(run):
    return roofline.share(run, 0, roofline.K2)
