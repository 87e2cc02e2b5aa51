"""Host-to-card copies enqueued inside the entry's root span, a batch,
each attributed by launch to its op (``to_device`` of a warp's map
vectors, a resize's tables)."""

from portbench.attribution import attribution


def read(run):
    att = attribution(run)
    return att.uploads_per_batch() if att else None
