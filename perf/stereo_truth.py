#!/usr/bin/env python3
"""The stereo-depth path on make_stereo_rig's data, on the card or the CPU:
the rendering's, the calibration's and each stage's wall on the host clock,
the SGBM path steps, the kernels' launches, the peak device memory over
the input (on the card), and the truth report (``entry.stereo_truth_report``),
in one JSON line at the end.

    python3 perf/stereo_truth.py [--device cuda|cpu] [--shape N H W C] [--threads T]

Nothing of JAX is imported.  On the CPU the full (12, 1080, 1920, 3) data
take a few minutes and about 6 GiB at StereoBM's peak (its int32 cost
volume is 1080 x 1689 x 240, 1.63 GiB); the gates of chip_smoke.py's phase
4p were set from this report."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from opencv_tpu_torch import entry as E  # noqa: E402
from opencv_tpu_torch.kernels import KERNELS  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shape", type=int, nargs=4, default=list(E.SHAPE_STEREO))
    ap.add_argument("--threads", type=int, default=0, help="torch threads (0: torch's default)")
    args = ap.parse_args()
    if args.threads:
        torch.set_num_threads(args.threads)
    cuda = args.device != "cpu"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    shape = tuple(args.shape)
    t0 = time.perf_counter()
    data = E.make_stereo_rig(shape)
    render_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rig = E.calibrate_rig(torch.from_numpy(data["views"]).to(args.device), data["object_points"])
    sync()
    calib_s = time.perf_counter() - t0
    pair = torch.from_numpy(data["scene"]).to(args.device)
    for k in KERNELS:
        k.reset()
    if cuda:
        sync()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    st = E.stereo_state(pair, rig)
    stage_ms = {}
    for name, stage, _ in E.STEREO_STAGES:
        t0 = time.perf_counter()
        stage(st)
        sync()
        stage_ms[name] = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30 if cuda else None
    rep = E.stereo_truth_report(rig, st, data)
    print(json.dumps({"device": args.device, "shape": shape, "threads": torch.get_num_threads(),
                      "card": torch.cuda.get_device_name(0) if cuda else None,
                      "render_s": render_s, "calibrate_s": calib_s, "pairs": rig["pairs"],
                      "stage_ms": stage_ms, "peak_gib_over_input": peak,
                      "launches": {k.symbol: k.launches for k in KERNELS},
                      "report": rep}, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
