#!/usr/bin/env python3
"""The photo-finishing path (``entry.forward_photo``) on make_bracket's
bracket, on the card or the CPU: each stage's wall on the host clock, the
kernels' launches and the truth report (``entry.photo_truth_report``), one
JSON line at the end.

    python3 perf/photo_truth.py [--device cuda|cpu] [--shape N H W C] [--threads T]

Nothing of JAX is imported.  On the CPU the full (3, 1080, 1920, 3)
bracket takes about 30 s with 8 threads (NL-means' 441 offsets are most of
it) and about 3 GiB; the gates of chip_smoke.py's phase 4o were set
from this report.  Where cv2 imports, the line also gives the mean and
largest |flattened - cv2.textureFlattening| on the same input and mask."""

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
    ap.add_argument("--shape", type=int, nargs=4, default=list(E.SHAPE_PHOTO))
    ap.add_argument("--threads", type=int, default=0, help="torch threads (0: torch's default)")
    args = ap.parse_args()
    if args.threads:
        torch.set_num_threads(args.threads)
    shape = tuple(args.shape)
    info = E.make_bracket(shape)
    x, face, wire = (torch.from_numpy(a).to(args.device) for a in (info[0], info[3], info[4]))
    for k in KERNELS:
        k.reset()
    st = E.photo_state(x, face, wire)
    stage_ms = {}
    for name, stage, _ in E.PHOTO_STAGES:
        t0 = time.perf_counter()
        stage(st)
        if args.device != "cpu":
            torch.cuda.synchronize()
        stage_ms[name] = (time.perf_counter() - t0) * 1e3
    rep = E.photo_truth_report(st, info)
    got, want, same = rep["align"]
    rep["align"] = (got.tolist(), want.tolist(), same)
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        ref = cv2.textureFlattening(st["detailed"].cpu().numpy(), st["face"].cpu().numpy(), None,
                                    *E.PHOTO_FLATTEN)
        d = np.abs(st["flattened"].cpu().numpy().astype(np.int32) - ref)
        rep["cv2_flatten"] = (float(d.mean()), int(d.max()))
    print(json.dumps({"device": args.device, "shape": shape, "threads": torch.get_num_threads(),
                      "stage_ms": stage_ms, "out_shape": list(st["fused"].shape),
                      "launches": {k.symbol: k.launches for k in KERNELS},
                      "routes": {k.symbol: k.routes for k in KERNELS if k.routes},
                      "planted": info[2].tolist(),
                      "median_gray": [float(np.median(f.mean(-1))) for f in info[0]],
                      "report": rep}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
