"""The GaussianBlur 5x5 stage's share of its bytes bound (the u8 plane read
once and written once), from its device time alone in the trace."""

from portbench.roofline import stage_share


def read(run):
    return stage_share(run, "blur")
