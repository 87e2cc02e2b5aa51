"""Device ms a batch of the work attributed, by launch, to ``cvtColor``
stages (direct children of the entry's root span)."""

from portbench.attribution import STAGES, attribution


def read(run):
    att = attribution(run)
    return att.device_ms(STAGES["color"]) if att else None
