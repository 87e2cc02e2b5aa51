"""Bytes copied host to card in the traced window, over the summed time of
the host-to-card copies, in GB/s."""


def _h2d(run):
    lo, hi = run.trace.window()
    return [(s, e, b) for name, s, e, b in run.trace.copies
            if "HtoD" in name and lo <= s < hi]


def read(run):
    if run.trace is None or run.trace.window() is None:
        return None
    copies = _h2d(run)
    secs = sum(e - s for s, e, _ in copies)
    nbytes = sum(b for _, _, b in copies)
    return nbytes / secs / 1e9 if secs > 0 and nbytes > 0 else None
