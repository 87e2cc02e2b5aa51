"""The median host ms of the entry's root span (``entry.<function>``) a
batch, with no profiler running (the port's own host buffer): the
program's launch path, a batch."""

from portbench.attribution import attribution


def read(run):
    att = attribution(run)
    return att.enqueue_ms if att else None
