#!/usr/bin/env python3
"""Where the port's flagship forward spends its device time, on one GPU.

    python3 perf/profile_torch_forward.py [--iters 5] [--table PATH]

Runs ``opencv_tpu_torch.entry``'s forward and fused forward on the
(8, 1080, 1920, 3) batch under ``torch.profiler`` with one
``record_function`` span per stage.  Prints, per stage, the time between
CUDA events around it (median of 20, unprofiled) beside the device time of
its torch-op kernels (profiled); the device busy share (all kernel time
over the stage spans, where a low share means the device waits on the
host); and the top kernels.  ``--table`` writes the profiler's full table
to a file.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import opencv_tpu_torch as cv  # noqa: E402
from opencv_tpu_torch import entry as E  # noqa: E402

STAGES = ("cvtColor", "GaussianBlur", "resize", "warpAffine", "fusedPreprocess", "warpFused")


def staged(imgs, marks=None):
    """Both forwards, stage by stage; `marks` collects a CUDA event after
    each stage."""
    H, W = imgs.shape[1], imgs.shape[2]
    fns = (lambda _: cv.cvtColor(imgs, cv.COLOR_BGR2GRAY),
           lambda g: cv.GaussianBlur(g, (5, 5), 0),
           lambda b: cv.resize(b, (W // 2, H // 2)),
           E.warp,
           lambda _: E.preprocess_fused(imgs),
           E.warp)
    v = None
    for name, fn in zip(STAGES, fns):
        with record_function(name):
            v = fn(v)
        if marks is not None:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--table", help="write the profiler's key_averages table here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_forward: no CUDA device", file=sys.stderr)
        return 1
    _, (imgs,) = E.entry("cuda")
    for _ in range(2):
        staged(imgs)
    torch.cuda.synchronize()
    per_stage = {s: [] for s in STAGES}
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        marks = [start]
        staged(imgs, marks)
        marks[-1].synchronize()
        for s, a, b in zip(STAGES, marks, marks[1:]):
            per_stage[s].append(a.elapsed_time(b))
    print(f"device: {torch.cuda.get_device_name(0)}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            staged(imgs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    if args.table:
        os.makedirs(os.path.dirname(os.path.abspath(args.table)), exist_ok=True)
        with open(args.table, "w") as f:
            f.write(events.table(sort_by="cuda_time_total", row_limit=40))

    def device_us(e):
        return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)

    def self_device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # a host-side stage span carries the device time of the torch ops under
    # it; kernels launched through ctypes (csrc/) are not attributed to it by
    # the profiler and show only in the kernel list
    cpu = torch.autograd.DeviceType.CPU
    spans = {e.key: e for e in events if e.key in STAGES and e.device_type == cpu}
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in STAGES]
    print(f"profiled: {args.iters} iterations, wall {wall_ms / args.iters:.4f} ms each")
    span_sum = 0.0
    for s in STAGES:
        e_ms = statistics.median(per_stage[s])
        span_sum += e_ms
        print(f"stage {s}: {e_ms:.4f} ms between its events; torch-op kernels "
              f"{device_us(spans[s]) / args.iters / 1e3:.4f} ms")
    k_iter = sum(self_device_us(e) for e in kernels) / args.iters / 1e3
    print(f"device busy share, unprofiled estimate: {k_iter / span_sum:.4f} "
          f"(kernel time {k_iter:.4f} ms per iteration over {span_sum:.4f} ms of stage spans)")
    for e in sorted(kernels, key=self_device_us, reverse=True)[:12]:
        print(f"kernel {self_device_us(e) / args.iters / 1e3:.4f} ms/iter "
              f"x{e.count // args.iters} {e.key[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
