"""One run of one cell: set-up, the measured window, the check of what the
window produced against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

- ``configs/<config>.json``: the sizes as run, with the limits of the
  comparison; ``configs/<config>.py``: the call into the program
  (``call``, ``outputs``, ``stages``); ``reference/<config>.py``: the
  plain reference (``forward(x, cfg, low="")``);
- ``traffic/<traffic>.json``: a loop kind of ``loops.py`` and its
  parameters;
- ``metrics/<metric>.py``: ``read(run)``, which returns the metric's value
  or None where the run has nothing for it to read.  A metric named
  ``<quantity>.<cells>`` (a quantity split by the cells that report it,
  each with its own bound) reads ``metrics/<quantity>.py`` unless it has a
  file of its own.

The measurement's own settings are the constants below, the same in every
cell.
"""

from __future__ import annotations

import importlib.util
import json
import os
import random
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from portbench import check, loops
from portbench.trace import Trace, covered, gaps, union

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the top-level modules that may not be loaded in a run (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "opencv_tpu")
L2_FLUSH_BYTES = 256 << 20
SAMPLE = 3              # completed batches the check compares, drawn from the seed
SYNC_BATCHES = 12       # batches over which host syncs are counted
STAGE_REPEATS = 10      # calls of each stage alone in the traced run
# the card spins this many clock cycles (some 2.5 ms on an H100) before each
# timed stage call, while the host enqueues the call behind it
SPIN_CYCLES = 5_000_000


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"portbench_{path.parent.name}_{path.stem}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


@dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    adapter: object
    reference: object
    per_layer: list
    end_to_end: list


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell `name` of BENCHMARK.json with its files loaded."""
    bench = bench or benchmark()
    wl = {w["name"]: w for w in bench["workloads"]}.get(name)
    if wl is None:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
    conf = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    with open(ROOT / conf["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{wl['traffic']}.json") as f:
        traffic = json.load(f)

    def reports(metric):
        return name in metric.get("workloads", [name])

    return Cell(workload=wl, config=config, traffic=traffic,
                adapter=load_module(HERE / "configs" / f"{wl['config']}.py"),
                reference=load_module(HERE / "reference" / f"{wl['config']}.py"),
                per_layer=[m for m in bench["per_layer"] if reports(m)],
                end_to_end=[m for m in bench["end_to_end"] if reports(m)])


def make_frames(config: dict, traffic: dict, seed: int, device) -> list:
    """The ring of ``traffic["ring"]`` distinct batches of uniform random u8
    frames, drawn from `seed` on `device` in one call."""
    f = config["frame"]
    shape = (int(traffic["ring"]), int(traffic["batch"]), f["height"], f["width"], f["channels"])
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2 ** 64)
    frames = torch.randint(0, 256, shape, dtype=torch.uint8, generator=g, device=device)
    return list(frames.unbind(0))


class Sampler:
    """A uniform sample of ``k`` completed batches' outputs, drawn from the
    seed (reservoir sampling), kept on the card until the check."""

    def __init__(self, k: int, seed: int, outputs):
        self.k, self.rng, self.outputs = k, random.Random(seed), outputs
        self.seen, self.kept = 0, []

    def __call__(self, i, slot, out):
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append((i, slot, self.outputs(out)))
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.kept[j] = (i, slot, self.outputs(out))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def count_syncs(run_loop, entry) -> int:
    """The operations inside `entry` that made the host wait for the card,
    over a run of `run_loop(entry)`: torch's sync debug mode is on during
    each call of the entry only, so the loop's own waits are not counted
    (the counting of ``count_syncs`` in chip_smoke.py)."""
    import warnings

    def watched(x):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            return entry(x)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run_loop(watched)
    return sum("synchroniz" in str(c.message) for c in caught)


@dataclass
class Run:
    """What a metric reader reads."""
    cell: Cell
    device_kind: str
    trace: Trace | None = None
    counters: dict = field(default_factory=dict)


def _for(n):
    return lambda i: i >= n


def _until(deadline):
    return lambda i: time.perf_counter() >= deadline


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
             entry=None) -> dict:
    """One run; returns the result object.  `entry` replaces the
    configuration's call (the tests plant faults with it)."""
    cfg, traffic = cell.config, cell.traffic
    entry = entry or cell.adapter.call
    loop = loops.LOOPS[traffic["loop"]]
    phases = {"imports": time.perf_counter() - t0}
    frames = make_frames(cfg, traffic, seed, device)
    ring = loops.ring_on(traffic, frames, device)
    phases["inputs"] = time.perf_counter() - t0
    del frames      # a host-fed ring holds its own pinned copy
    dropped = lambda i, slot, out: None                     # noqa: E731

    # warm-up: every ring slot, at the window's depth
    loop(entry, ring, traffic, device, _for(len(ring) + int(traffic["depth"])), dropped)
    phases["warm-up"] = time.perf_counter() - t0
    run = Run(cell=cell, device_kind=_device_kind(device))
    stage_inputs = None
    if trace:
        stage_inputs = cell.adapter.stages(cfg, ring[0].to(device))
        for fn in stage_inputs.values():
            fn()
        if device.type == "cuda":
            run.counters["host_syncs"] = count_syncs(
                lambda e: loop(e, ring, traffic, device, _for(SYNC_BATCHES), dropped), entry)
            run.counters["sync_batches"] = SYNC_BATCHES
    _sync(device)

    sampler = Sampler(SAMPLE, seed, cell.adapter.outputs)
    setup_peak = _peak(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if trace:
        prof, window = _traced(entry, ring, traffic, device, loop, sampler)
        run.trace = prof
        run.counters["traced_batches"] = len(window.done)
    else:
        window = loop(entry, ring, traffic, device, _until(time.perf_counter() + seconds),
                      sampler)
    setup_s = window.start - t0
    window_peak = _peak(device)
    if trace:       # after the peak is read: the stages' inputs and flush are not the window's
        run.counters["stage_s"] = time_stages(stage_inputs, device)
    print("setup: " + ", ".join(f"{k} done at {v:.3f} s" for k, v in phases.items())
          + f", window at {setup_s:.3f} s", file=sys.stderr)
    stage_inputs = None

    # the check, once the window has closed and its peak is read
    numbers, failed = check.compare(cell, [(ring[slot], outs) for _, slot, outs in sampler.kept],
                                    device)
    correct = bool(sampler.kept) and not check.failures(numbers, cfg["limits"])
    result = {"correct": correct, "attempted": len(window.done), "failed": failed}
    if trace:
        result["metrics"] = _per_layer(run)
    else:
        result["metrics"] = _end_to_end(cell, window, setup_s, window_peak)
    result["device"] = {"platform": "gpu" if device.type == "cuda" else device.type,
                        "kind": run.device_kind, "count": 1,
                        "memory_peak_bytes": max(setup_peak, window_peak)}
    if trace:
        lo, hi = run.trace.window()
        busy = covered(run.trace.device(lo, hi))
        result["device"].update(busy_s=busy, window_s=hi - lo)
        result["breakdown"] = breakdown(run.trace)
    result["checks"] = {k: {"value": v, "limit": cfg["limits"][k]} for k, v in numbers.items()}
    return result


def _device_kind(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def _traced(entry, ring, traffic, device, loop, sampler):
    """The traced window: ``trace_batches`` batches through the loop."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        window = loop(entry, ring, traffic, device, _for(int(traffic["trace_batches"])), sampler)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        trace = Trace.load(Path(path))
    finally:
        os.unlink(path)
    return trace, window


def time_stages(stages: dict, device) -> dict:
    """Each stage called alone ``STAGE_REPEATS`` times, with the L2 cache
    flushed before each call: the seconds of each call, by stage.

    On the card a call is timed between two CUDA events on the device's own
    clock, so no host clock enters it.  The card spins while the host
    enqueues the event, the call and the second event behind the spin, so
    the time is the card's work alone, every launch of the call in it, and
    not the host's enqueue (a wait for the card inside the call would still
    count).  On the CPU (tests) a call is timed by the host's clock."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    out = {}
    for name, fn in stages.items():
        times = []
        for _ in range(STAGE_REPEATS):
            flush.zero_()
            if device.type == "cuda":
                torch.cuda._sleep(SPIN_CYCLES)
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                fn()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) * 1e-3)
            else:
                t = time.perf_counter()
                fn()
                times.append(time.perf_counter() - t)
        out[name] = times
    del flush
    return out


def _end_to_end(cell: Cell, window, setup_s: float, peak: int) -> dict:
    f = cell.config["frame"]
    frames = len(window.done) * int(cell.traffic["batch"])
    secs = window.end - window.start
    lat_ms = sorted(t * 1e3 for _, _, t in window.done)
    p95 = statistics.quantiles(lat_ms, n=20, method="inclusive")[-1] if len(lat_ms) > 1 \
        else lat_ms[0]
    values = {"mpx_per_s": frames * f["height"] * f["width"] / 1e6 / secs,
              "batch_p95_ms": p95,
              "peak_device_gib": peak / 2 ** 30,
              "setup_s": setup_s}
    # a metric named <quantity>.<cells> (a quantity split by the cells that
    # report it, each with its own bound) reads its quantity
    return {m["name"]: {"value": values[m["name"].split(".")[0]], "unit": m["unit"]}
            for m in cell.end_to_end}


def reader(name: str) -> Path:
    """The reader file of the per-layer metric `name`: its own, or its
    quantity's (the part before the first dot)."""
    own = HERE / "metrics" / f"{name}.py"
    return own if own.exists() else HERE / "metrics" / f"{name.split('.')[0]}.py"


def _per_layer(run: Run) -> dict:
    out = {}
    for m in run.cell.per_layer:
        value = load_module(reader(m["name"])).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def breakdown(trace: Trace) -> dict:
    """The ten device operations that took most time in the window, and its
    ten longest idle gaps, each named by the innermost harness span on the
    host (submit, wait, feed) that covers the gap's middle."""
    lo, hi = trace.window()
    ops = {}
    for name, s, e, _ in trace.kernels + trace.copies + trace.fills:
        if lo <= s < hi:
            ops[name] = ops.get(name, 0.0) + (min(e, hi) - s)
    device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps(union(trace.device(lo, hi)), lo, hi), key=lambda g: g[0] - g[1])[:10]
    host = [(n, s, e) for n, s, e in trace.spans if n in ("submit", "wait", "feed")]
    labelled = []
    for s, e in idle:
        mid = (s + e) / 2
        inner = [(hs, n) for n, hs, he in host if hs <= mid <= he]
        labelled.append([max(inner)[1] if inner else "host", e - s])
    return {"device_ops": [[n[:200], t] for n, t in device_ops], "idle_gaps": labelled}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
