#!/usr/bin/env python3
"""The cost of the port's spans (``opencv_tpu_torch.utils.trace``) on the
host that runs it.

    python3 perf/span_cost.py [--calls 1000000]

Off (no profiler, host buffer off): the ns a call that the decorator
``region`` and the context manager ``trace_region`` add to a call of an
empty function, the median of 5 rounds.  On (a ``torch.profiler`` with CPU
and, where there is a card, CUDA activity): the us a span adds, and, on
the card, the spans one batch of each benchmarked entry opens (the
flagship at (32, 1080, 1920, 3), the 4K entry at (8, 2160, 3840, 3)) and
the host ms a call of each takes with and without a profiler around it.
Prints one JSON line.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from opencv_tpu_torch import entry  # noqa: E402
from opencv_tpu_torch.utils import trace  # noqa: E402


def _ns(fn, calls: int) -> float:
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t) / calls * 1e9


def _extra_ns(fn, bare, calls: int) -> float:
    return statistics.median(_ns(fn, calls) - _ns(bare, calls) for _ in range(5))


def _with_region():
    with trace.trace_region("span_cost"):
        pass


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=1_000_000)
    calls = ap.parse_args().calls

    def bare():
        pass

    out = {"off_region_ns": _extra_ns(trace.region("span_cost")(bare), bare, calls),
           "off_trace_region_ns": _extra_ns(_with_region, bare, calls)}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts):
        out["on_span_us"] = _extra_ns(_with_region, bare, calls // 100) / 1e3
    if torch.cuda.is_available():
        out["card"] = torch.cuda.get_device_name(0)
        for name, fn, shape in (("forward", entry.forward, (32, 1080, 1920, 3)),
                                ("forward_resize_warp_4k", entry.forward_resize_warp_4k,
                                 (8, 2160, 3840, 3))):
            x = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda")
            for _ in range(3):
                fn(x)
            torch.cuda.synchronize()
            host = []
            for _ in range(10):
                t = time.perf_counter()
                fn(x)
                host.append((time.perf_counter() - t) * 1e3)
                torch.cuda.synchronize()
            with profile(activities=acts) as prof:
                on = []
                for _ in range(10):
                    t = time.perf_counter()
                    fn(x)
                    on.append((time.perf_counter() - t) * 1e3)
                    torch.cuda.synchronize()
            spans = [e for e in prof.events() if e.name.startswith(("entry.", "cvtColor",
                                                                    "GaussianBlur", "resize",
                                                                    "warp", "totals"))
                     and e.device_type == torch.autograd.DeviceType.CPU]
            out[name] = {"spans_per_call": len(spans) / 10,
                         "host_ms_off": statistics.median(host),
                         "host_ms_profiled": statistics.median(on)}
            del x
    print(json.dumps(out))


if __name__ == "__main__":
    main()
