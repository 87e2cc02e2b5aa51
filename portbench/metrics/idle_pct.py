"""The share of the traced window that no kernel, copy or fill covers: the
union of the device's intervals in the trace, over the window."""

from portbench import trace


def read(run):
    return trace.idle_pct(run.trace)
