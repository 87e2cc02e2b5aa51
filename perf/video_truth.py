#!/usr/bin/env python3
"""The video-analytics path (``entry.forward_video``) on make_motion_video's
frames, on the card or the CPU: each stage's wall on the host clock and
the truth report (``entry.video_truth_report``), one JSON line at the end.

    python3 perf/video_truth.py [--device cuda|cpu] [--shape N H W C]

Nothing of JAX is imported.  On the CPU the full (8, 1080, 1920, 3) video
takes about a minute and a few GiB; the gates of chip_smoke.py's phase 4n
were set from this report."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from opencv_tpu_torch import entry as E  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shape", type=int, nargs=4, default=list(E.SHAPE_VIDEO))
    args = ap.parse_args()
    shape = tuple(args.shape)
    video, shifts, boxes = E.make_motion_video(shape)
    st = {"x": torch.from_numpy(video).to(args.device)}
    stage_ms = {}
    from opencv_tpu_torch.kernels import KERNELS
    for k in KERNELS:
        k.reset()
    for name, stage, _ in E.VIDEO_STAGES:
        t0 = time.perf_counter()
        stage(st)
        if args.device != "cpu":
            torch.cuda.synchronize()
        stage_ms[name] = (time.perf_counter() - t0) * 1e3
    rep = E.video_truth_report(st, shifts, boxes, shape)
    print(json.dumps({"device": args.device, "shape": shape, "threads": torch.get_num_threads(),
                      "stage_ms": stage_ms, "corners": len(st["corners"]),
                      "launches": {k.symbol: k.launches for k in KERNELS},
                      "shifts": st["shifts"].tolist(), "truth_shifts": shifts[1:].tolist(),
                      "report": rep}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
