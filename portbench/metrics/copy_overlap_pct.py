"""The share of host-to-card copy time during which a kernel also runs on
the card, from the trace's intervals."""

from portbench.trace import overlap, union


def read(run):
    if run.trace is None or run.trace.window() is None:
        return None
    lo, hi = run.trace.window()
    copies = [(s, e) for name, s, e, _ in run.trace.copies if "HtoD" in name and lo <= s < hi]
    secs = sum(e - s for s, e in copies)
    if secs <= 0:
        return None
    kernels = union([(s, e) for _, s, e, _ in run.trace.kernels if lo <= s < hi])
    return 100.0 * sum(overlap(c, kernels) for c in copies) / secs
