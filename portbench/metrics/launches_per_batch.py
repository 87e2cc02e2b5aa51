"""Kernel launches in the traced window, over the batches it completed (an
exact count: copies and fills are not kernels)."""


def read(run):
    n = run.counters.get("traced_batches")
    if run.trace is None or run.trace.window() is None or not n:
        return None
    lo, hi = run.trace.window()
    launches = sum(1 for _, s, _, _ in run.trace.kernels if lo <= s < hi)
    return launches / n if launches else None
