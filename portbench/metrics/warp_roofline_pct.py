"""The warpAffine stage's share of its bytes bound (the u8 image read once
and written once), from its device time alone in the trace."""

from portbench.roofline import stage_share


def read(run):
    return stage_share(run, "warp")
