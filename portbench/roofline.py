"""Roofline shares of a stage: the least time the card could take for the
stage's bytes (each input byte read once, each output byte written once,
from the configuration's file) at the card's published bandwidth, over the
stage's measured device time: the median of its calls alone
(``harness.time_stages``)."""

from __future__ import annotations

import json
import statistics
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks(device_kind: str):
    """The published peaks of the card whose name contains a key of
    ``peaks.json``, or None for a card the table does not hold."""
    with open(PEAKS) as f:
        table = json.load(f)
    return next((v for k, v in table.items() if k in device_kind), None)


def stage_share(run, stage: str):
    """The stage's share of its bytes bound, in %, or None without a timed
    stage or the card's peaks."""
    p = peaks(run.device_kind)
    times = run.counters.get("stage_s", {}).get(stage)
    if p is None or not times:
        return None
    t = statistics.median(times)
    read, written = run.cell.config["bytes_per_frame"]["stages"][stage]
    nbytes = (read + written) * int(run.cell.traffic["batch"])
    return 100.0 * nbytes / p["hbm_bytes_per_s"] / t
