"""Operations inside the entry that made the host wait for the card, counted
with torch's sync debug mode over a few batches, per batch; the harness's
own waits are outside the count."""


def read(run):
    n = run.counters.get("sync_batches")
    if not n or "host_syncs" not in run.counters:
        return None
    return run.counters["host_syncs"] / n
