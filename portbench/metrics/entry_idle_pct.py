"""The share of the traced window in which the card was idle and the work
that ended the gap was enqueued from inside a root span after the gap
began, on the host's clock: the card waiting on the program's own host
work (enqueue, a sync, an upload).  The window's edges do not count."""

from portbench.attribution import attribution


def read(run):
    att = attribution(run)
    return att.entry_idle_pct() if att else None
