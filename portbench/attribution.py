"""The card's work matched to the program's own spans, by launch.

The program (``opencv_tpu_torch``) opens a span (a ``record_function``
while a profiler runs) at its layer boundaries: one root span a call of an
entry (``entry.<function>``, one batch), one at each public op it calls
(``cvtColor``, ``GaussianBlur``, ``resize``, ``warpAffine``,
``warpPerspective``; ``totals`` for the 4K entry's reductions).  A
*stage* is a direct child span of a root; spans nested inside a stage stay
in its path.

Each kernel, copy and fill in a ``torch.profiler`` trace carries the
correlation id of the CUDA API call on the host that enqueued it,
and that call sits inside the program's spans on the host's own clock, so
the work is put under the innermost span around its launch with no clock
offset in the match.  Work with no launch record (a launch CUPTI did not
see) stays unattributed and is listed by name in the summary.

The offset between the two clocks is measured in every trace as the least
(device start - launch start) over the pairs matched by id: no work starts
on the card before its launch began.  The device's times are shifted by it
before a gap on the card is set against the host's timeline
(``entry_idle_pct``), so that reading is the same whatever the offset; it
takes the fastest launch of the window as instant (a few us early).

The harness's ``Trace`` keeps neither launch records nor correlation ids,
so ``attribution(run)`` traces a window of its own in a traced run (the
same loop, traffic and number of batches, right after the harness's), and
reports what it found on standard error, one line.  Before that window it
runs as many batches with no profiler and the port's own host buffer on
(``opencv_tpu_torch.utils.trace.start()``: two clock reads a span, no
``record_function``), and reads the enqueue time of a batch from the root
spans there, as the profiler's own cost on every op would inflate it.
"""

from __future__ import annotations

import bisect
import json
import os
import statistics
import sys
import tempfile
from dataclasses import dataclass, field

KERNEL, COPY, FILL = "kernel", "gpu_memcpy", "gpu_memset"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN = "user_annotation"
ROOT = "entry."            # the root span of one call of an entry
STAGES = {"color": ("cvtColor",), "resize": ("resize",),
          "warp": ("warpAffine", "warpPerspective")}
RESOLUTION = 1e-9          # s: the trace's clock step; a shorter gap is rounding
SEED = 0                   # the attribution window's frames (noise; no op reads their values)


@dataclass
class Span:
    name: str
    start: float
    end: float
    tid: object
    parent: int | None = None


@dataclass
class Work:
    """One kernel, copy or fill on the card; times in seconds."""
    cat: str
    name: str
    start: float
    end: float
    corr: object = None
    launch: float | None = None    # host time of the call that enqueued it
    path: tuple = ()               # span indices around the launch, outermost first


def root_spans(spans) -> list:
    """Indices of the outermost ``entry.*`` spans among `spans`."""
    out = []
    for i, s in enumerate(spans):
        p, nested = s.parent, False
        while p is not None:
            nested = nested or spans[p].name.startswith(ROOT)
            p = spans[p].parent
        if s.name.startswith(ROOT) and not nested:
            out.append(i)
    return out


def parse(events):
    """``(spans, launches, work)`` of a Chrome trace's events: spans sorted
    with their parents set, launches by correlation id as (start, tid)."""
    spans, launches, work = [], {}, []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        start = float(ev["ts"]) * 1e-6
        end = start + float(ev["dur"]) * 1e-6
        cat, args = ev.get("cat"), ev.get("args") or {}
        if cat == SPAN:
            spans.append(Span(ev.get("name", ""), start, end, ev.get("tid")))
        elif cat in LAUNCH_CATS and "correlation" in args:
            c = args["correlation"]
            if c not in launches or start < launches[c][0]:
                launches[c] = (start, ev.get("tid"))
        elif cat in (KERNEL, COPY, FILL):
            work.append(Work(cat, ev.get("name", ""), start, end, args.get("correlation")))
    spans.sort(key=lambda s: (s.start, -s.end))
    stacks = {}
    for i, s in enumerate(spans):
        st = stacks.setdefault(s.tid, [])
        while st and spans[st[-1]].end < s.start:
            st.pop()
        s.parent = st[-1] if st else None
        st.append(i)
    work.sort(key=lambda w: w.start)
    return spans, launches, work


class _Finder:
    """The innermost span around a host time, on a thread."""

    def __init__(self, spans):
        self.spans = spans
        self.by_tid = {}
        for i, s in enumerate(spans):
            self.by_tid.setdefault(s.tid, []).append(i)
        self.starts = {t: [spans[i].start for i in ix] for t, ix in self.by_tid.items()}

    def path(self, t: float, tid) -> tuple:
        tids = [tid] if tid in self.by_tid else list(self.by_tid)
        for k in tids:
            ix = self.by_tid[k]
            j = bisect.bisect_right(self.starts[k], t) - 1
            i = ix[j] if j >= 0 else None
            while i is not None and self.spans[i].end < t:
                i = self.spans[i].parent
            if i is not None:
                out = []
                while i is not None:
                    out.append(i)
                    i = self.spans[i].parent
                return tuple(reversed(out))
        return ()


@dataclass
class Attribution:
    spans: list
    work: list
    offset: float | None           # least (device start - launch start), s
    window: tuple | None           # the harness loop's ``window`` span
    roots: list = field(default_factory=list)
    enqueue_ms: float | None = None    # median host ms of a root span, unprofiled

    def __post_init__(self):
        self._roots = set(self.roots)

    def root_of(self, w: Work):
        """The root span of the work's path, where it is one of the window's."""
        r = next((i for i in w.path if self.spans[i].name.startswith(ROOT)), None)
        return r if r in self._roots else None

    def stage_of(self, w: Work):
        """The name of the direct child of the root on the work's path,
        ``""`` for work in the root's own body, None outside a root."""
        r = self.root_of(w)
        if r is None:
            return None
        k = w.path.index(r)
        return self.spans[w.path[k + 1]].name if k + 1 < len(w.path) else ""

    @property
    def batches(self) -> int:
        return len(self.roots)

    def device_ms(self, names) -> float | None:
        """Device ms a batch of the work whose stage is one of `names`."""
        if not self.batches:
            return None
        secs = sum(w.end - w.start for w in self.work if self.stage_of(w) in names)
        return 1e3 * secs / self.batches

    def uploads(self) -> dict:
        """Host-to-card copies enqueued inside a root span, by stage (the
        innermost op around each is in ``summary``)."""
        out = {}
        for w in self.work:
            if w.cat == COPY and "HtoD" in w.name and self.root_of(w) is not None:
                st = self.stage_of(w) or "(entry)"
                out[st] = out.get(st, 0) + 1
        return out

    def uploads_per_batch(self) -> float | None:
        return sum(self.uploads().values()) / self.batches if self.batches else None

    def _aligned(self):
        shift = -self.offset if self.offset is not None else 0.0
        return [(w.start + shift, w.end + shift, w) for w in self.work]

    def gaps(self):
        """Idle gaps of the card inside the window on the host's clock:
        ``(start, end, work that ended it or None)``."""
        if self.window is None:
            return []
        lo, hi = self.window
        ivs = sorted(((s, e, w) for s, e, w in self._aligned() if lo <= s < hi),
                     key=lambda iv: iv[:2])
        out, t = [], lo
        for s, e, w in ivs:
            if s > t + RESOLUTION:
                out.append((t, s, w))
            t = max(t, min(e, hi))
        if hi > t:
            out.append((t, hi, None))
        return out

    def waits_on_program(self, gap) -> bool:
        """Whether the work that ended `gap` was enqueued from inside a root
        span after the gap began: the card waited on the program's host work.
        The window's edges are not: before its first work (the profiler's
        start and the first enqueue) and after its last."""
        s, _, w = gap
        return (w is not None and s > self.window[0] and w.launch is not None
                and w.launch > s and self.root_of(w) is not None)

    def entry_idle_pct(self) -> float | None:
        if self.window is None or not self.batches:
            return None
        lo, hi = self.window
        idle = sum(e - s for s, e, w in self.gaps() if self.waits_on_program((s, e, w)))
        return 100.0 * idle / (hi - lo)

    def summary(self) -> dict:
        n = max(self.batches, 1)
        by_stage, missing = {}, {}
        for w in self.work:
            st = self.stage_of(w)
            if st is None:
                missing[w.name[:60]] = missing.get(w.name[:60], 0) + 1
                continue
            by_stage[st or "(entry)"] = by_stage.get(st or "(entry)", 0.0) + (w.end - w.start)
        busy, gaps, by_cause = 0.0, self.gaps(), {}
        if self.window is not None:
            busy = (self.window[1] - self.window[0]) - sum(e - s for s, e, _ in gaps)
            for g in gaps:
                c = self.cause(g)
                by_cause[c] = by_cause.get(c, 0.0) + 100.0 * (g[1] - g[0]) / (
                    self.window[1] - self.window[0])
        top = sorted(gaps, key=lambda g: g[0] - g[1])[:10]

        def label(g):
            w, c = g[2], self.cause(g)
            if c == "window edge":
                return c
            return (self.spans[w.path[-1]].name if w.path else "(no span)") + f" ({c})"

        return {"offset_us": None if self.offset is None else self.offset * 1e6,
                "batches": self.batches, "work": len(self.work),
                "unattributed": missing, "enqueue_ms": self.enqueue_ms,
                "busy_ms_per_batch": 1e3 * busy / n,
                "stage_ms": {k: 1e3 * v / n for k, v in sorted(by_stage.items())},
                "uploads_per_batch": {k: v / n for k, v in sorted(self.uploads().items())},
                "entry_idle_pct": self.entry_idle_pct(),
                "idle_pct_by_cause": by_cause,
                "idle_gaps_us": [[label(g), (g[1] - g[0]) * 1e6] for g in top]}

    def cause(self, gap) -> str:
        """Why the card sat idle in `gap`: the window's edge, a wait on the
        program (``entry_idle_pct``), work enqueued outside any entry, or
        work enqueued before the gap began (the card's own launch gap)."""
        s, _, w = gap
        if w is None or s <= self.window[0]:
            return "window edge"
        if self.waits_on_program(gap):
            return "program"
        return "outside the entry" if self.root_of(w) is None else "enqueued before"


def attribute(events) -> Attribution:
    """Attribute each device event of a Chrome trace's `events`."""
    spans, launches, work = parse(events)
    finder = _Finder(spans)
    for w in work:
        if w.corr in launches:
            w.launch, tid = launches[w.corr]
            w.path = finder.path(w.launch, tid)
    by_id = [w.start - w.launch for w in work if w.launch is not None]
    win = next(((s.start, s.end) for s in spans if s.name == "window"), None)
    roots = root_spans(spans)
    if win is not None:
        roots = [i for i in roots if win[0] <= spans[i].start < win[1]]
    return Attribution(spans=spans, work=work, offset=min(by_id) if by_id else None,
                       window=win, roots=roots)


def root_seconds(run_batches) -> list:
    """The host seconds of each outermost ``entry.*`` span that the port's
    own host buffer records over a call of `run_batches()`, with no
    profiler: the program's enqueue time of each batch."""
    from opencv_tpu_torch.utils import trace as port_trace

    was, n0 = port_trace.is_enabled(), len(port_trace.events())
    port_trace.start()
    try:
        run_batches()
    finally:
        if not was:
            port_trace.stop()
    return [ev["dur"] * 1e-6 for ev in port_trace.events()[n0:]
            if ev["name"].startswith(ROOT) and ev["args"]["depth"] == 0]


def _windows(run) -> tuple:
    """``(events, roots)``: the Chrome trace events of a traced window of
    the run's cell, and the host seconds of each root span in an unprofiled
    window before it.  Each is its loop over a ring of its traffic from
    ``SEED``, warmed over the ring at the window's depth, for
    ``trace_batches`` batches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import harness, loops

    cell, traffic = run.cell, run.cell.traffic
    device = torch.device("cuda", 0)
    ring = loops.ring_on(traffic, harness.make_frames(cell.config, traffic, SEED, device),
                         device)
    loop, entry = loops.LOOPS[traffic["loop"]], cell.adapter.call
    dropped = lambda i, slot, out: None                         # noqa: E731

    def batches(n):
        loop(entry, ring, traffic, device, lambda i: i >= n, dropped)
        torch.cuda.synchronize(device)

    batches(len(ring) + int(traffic["depth"]))
    roots = root_seconds(lambda: batches(int(traffic["trace_batches"])))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loop(entry, ring, traffic, device, lambda i: i >= int(traffic["trace_batches"]),
             dropped)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", []), roots
    finally:
        os.unlink(path)


_LAST: list = []           # [(run, Attribution or None)]: the readers of one run share it


def attribution(run) -> Attribution | None:
    """The attribution of a traced run's own window on the card, or None
    where there is nothing to attribute: no trace, no card, or a program
    with no root span in the harness's trace (one without these spans)."""
    if _LAST and _LAST[0][0] is run:
        return _LAST[0][1]
    att = None
    if (run.trace is not None and run.device_kind != "cpu"
            and any(n.startswith(ROOT) for n, _, _ in run.trace.spans)):
        events, roots = _windows(run)
        att = attribute(events)
        att.enqueue_ms = 1e3 * statistics.median(roots) if roots else None
        print("attribution: " + json.dumps(att.summary()), file=sys.stderr)
    _LAST[:] = [(run, att)]
    return att

