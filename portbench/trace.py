"""The reduction of one ``torch.profiler`` trace to intervals: device
kernels, copies and fills on the card's timeline (CUPTI's clock), and the
harness's own host spans (``record_function``) on the host's, both in
seconds.  The two clocks can be offset by a tenth of a millisecond or so,
so host spans only bound long stretches of device work (the window);
a stage alone is timed on the device's clock (``harness.time_stages``).
The metric readers and the run's breakdown read these."""

from __future__ import annotations

import json
from pathlib import Path

# the trace's categories of work on the device
KERNEL, COPY, FILL = "kernel", "gpu_memcpy", "gpu_memset"
SPAN = "user_annotation"


class Trace:
    """Complete events of a Chrome trace, grouped by category.

    ``kernels``, ``copies`` and ``fills`` are ``(name, start, end, bytes)``
    tuples (bytes 0 where the trace gives none), ``spans`` are ``(name,
    start, end)``; times in seconds."""

    def __init__(self, events):
        self.kernels, self.copies, self.fills, self.spans = [], [], [], []
        lists = {KERNEL: self.kernels, COPY: self.copies, FILL: self.fills}
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            start = float(ev["ts"]) * 1e-6
            end = start + float(ev["dur"]) * 1e-6
            cat = ev.get("cat")
            if cat in lists:
                nbytes = int((ev.get("args") or {}).get("bytes", 0) or 0)
                lists[cat].append((ev.get("name", ""), start, end, nbytes))
            elif cat == SPAN:
                self.spans.append((ev.get("name", ""), start, end))
        for group in (self.kernels, self.copies, self.fills, self.spans):
            group.sort(key=lambda t: t[1])

    @classmethod
    def load(cls, path: Path) -> "Trace":
        with open(path) as f:
            return cls(json.load(f).get("traceEvents", []))

    def spans_named(self, name: str):
        return [(s, e) for n, s, e in self.spans if n == name]

    def window(self):
        """The traced window: the harness's ``window`` span, or None."""
        w = self.spans_named("window")
        return w[0] if w else None

    def device(self, lo: float, hi: float, groups=None):
        """Device intervals of `groups` (default: kernels, copies and fills)
        that start in [lo, hi), clipped to it."""
        groups = groups or (self.kernels, self.copies, self.fills)
        return [(max(s, lo), min(e, hi)) for g in groups for _, s, e, _ in g
                if lo <= s < hi]


def union(intervals):
    """Merge (start, end) intervals into disjoint sorted ones."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def covered(intervals) -> float:
    """Seconds covered by the union of `intervals`."""
    return sum(e - s for s, e in union(intervals))


def overlap(interval, merged) -> float:
    """Seconds of `interval` that the disjoint `merged` intervals cover."""
    s0, e0 = interval
    return sum(max(0.0, min(e, e0) - max(s, s0)) for s, e in merged)


def gaps(merged, lo: float, hi: float):
    """The idle (start, end) gaps of [lo, hi) between disjoint `merged`."""
    out, t = [], lo
    for s, e in merged:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def idle_pct(trace):
    """The share of the traced window, in %, that no kernel, copy or fill
    covers; None where nothing ran on the device in it."""
    if trace is None or trace.window() is None:
        return None
    lo, hi = trace.window()
    busy = covered(trace.device(lo, hi))
    return 100.0 * (1.0 - busy / (hi - lo)) if busy > 0 else None

