#!/usr/bin/env python3
"""Forwards of two or more checkouts of the port, on one GPU, in one run,
to tell a change from the host's spread.

    python3 perf/ab_forward.py PARENT_ROOT CHANGE_ROOT [--path flagship|decode|gauss5] [--rounds 2] [--iters N]

Each root is a directory that holds an ``opencv_tpu_torch`` package (a
``git archive`` of a commit, or the repo itself).  Every round runs the
roots in the order given and then reversed (parent, change, change,
parent), each in a fresh process that imports the package from its root,
builds its kernels, and times ``entry.forward`` and ``entry.forward_fused``
on the (8, 1080, 1920, 3) batch (``--path flagship``), or
``entry.forward_decode_color`` on NV12 (8, 1080, 1920) and ``threshold``
BINARY | OTSU on its (8, 540, 960, 1) map, with the host syncs of one call
of each (``--path decode``), or the gauss5_down2 kernel (``--path gauss5``):
``fused_gray_gauss5_down2`` at (8, 1080, 1920, 3) and (2, 1080, 1920, 3),
``gauss5_down2_u8`` at (8, 1080, 1920), ``entry.forward_fused``, and one
``x.clone()`` of the (8, 1080, 1920, 3) batch as a calibration of the memory
rate the timing reaches, each kernel first held equal to its plain version;
each with its bytes bound (input read once, output written once, 3.35
TB/s) and its share of it.  CUDA events around each call, the 50 MB L2
flushed before it, median and quartiles of ``--iters`` calls (default 200;
20 after 3 warm-ups for gauss5, ``chip_smoke.Timer``'s protocol), as the
caller sees it and with the host part held out of the window (the card
spins first, so the whole call is queued when the window opens).  Prints
one line per process and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12  # as chip_smoke.py: the H100 SXM's memory rate
# gauss5: bytes in + out of each timed call
_N8, _N2 = 8 * 1080 * 1920, 2 * 1080 * 1920
GAUSS5_BYTES = {"bgr (8,1080,1920,3)": 3 * _N8 + _N8 // 4,
                "bgr (2,1080,1920,3)": 3 * _N2 + _N2 // 4,
                "gray (8,1080,1920)": _N8 + _N8 // 4, "clone (8,1080,1920,3)": 2 * 3 * _N8}


def count_syncs(torch, fn) -> int:
    """Operations that made the host wait for the card in one call of fn
    (torch's sync debug mode)."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(c.message) for c in caught)


def child(root: str, iters: int, path: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import opencv_tpu_torch as cv
    from opencv_tpu_torch import entry as E

    if not E.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {E.__file__}, not the package under {root}")
    if path == "gauss5":
        import numpy as np
        from opencv_tpu_torch.kernels import fused_preproc as F
        rng = np.random.default_rng(0)
        x8, x2 = (torch.from_numpy(rng.integers(0, 256, (n, 1080, 1920, 3), np.uint8)).cuda()
                  for n in (8, 2))
        g8 = torch.from_numpy(rng.integers(0, 256, (8, 1080, 1920), np.uint8)).cuda()
        for x in (x8, x2):
            if not torch.equal(F.fused_gray_gauss5_down2(x), F.fused_gray_gauss5_down2_plain(x)):
                raise AssertionError(f"{root}: gauss5_down2 != plain at {tuple(x.shape)}")
        if not torch.equal(F.gauss5_down2_u8(g8), F.gauss5_down2_u8_plain(g8)):
            raise AssertionError(f"{root}: gauss5_down2 gray != plain")
        fns = (("bgr (8,1080,1920,3)", lambda: F.fused_gray_gauss5_down2(x8)),
               ("bgr (2,1080,1920,3)", lambda: F.fused_gray_gauss5_down2(x2)),
               ("gray (8,1080,1920)", lambda: F.gauss5_down2_u8(g8)),
               ("forward_fused", lambda: E.forward_fused(x8)),
               ("clone (8,1080,1920,3)", lambda: x8.clone()))
    elif path == "decode":
        forward, args = E.entry_decode_color("cuda")
        small = forward(*args)[4]
        otsu = cv.THRESH_BINARY | cv.THRESH_OTSU
        fns = (("forward_decode_color", lambda: forward(*args)),
               ("threshold OTSU", lambda: cv.threshold(small, 0, 255, otsu)))
    else:
        forward, (imgs,) = E.entry("cuda")
        fns = (("forward", lambda: forward(imgs)),
               ("forward_fused", lambda: E.forward_fused(imgs)))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    warmup = 3 if path == "gauss5" else 5

    def timed(fn, device_only):
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            flush.zero_()
            if device_only:
                torch.cuda._sleep(1_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        q1, med, q3 = statistics.quantiles(times, n=4)
        return {"median": med, "q1": q1, "q3": q3}

    out = {"root": root}
    for name, fn in fns:
        out[name] = timed(fn, False)
        out[name + " device"] = timed(fn, True)
    syncs = {name: count_syncs(torch, fn) for name, fn in fns}
    print(json.dumps({**out, "host syncs": syncs}), flush=True)


def share(name: str, v: dict) -> str:
    """', bound B ms, share S' for a gauss5 row with a bytes bound."""
    nbytes = GAUSS5_BYTES.get(name.removesuffix(" device"))
    if nbytes is None:
        return ""
    b = nbytes / HBM_BYTES_PER_S * 1e3
    return f", bound {b:.4f} ms, share {b / v['median']:.3f}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--path", choices=("flagship", "decode", "gauss5"), default="flagship")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.iters is None:
        args.iters = 20 if args.path == "gauss5" else 200
    if args.child:
        child(args.roots[0], args.iters, args.path)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    order = [r for _ in range(args.rounds) for r in args.roots + args.roots[::-1]]
    for i, root in enumerate(order):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), root, "--child",
                              "--iters", str(args.iters), "--path", args.path],
                             capture_output=True, text=True, check=True, timeout=600)
        row = json.loads(res.stdout.strip().splitlines()[-1])
        syncs = row.pop("host syncs")
        print(f"run {i + 1} {root}: " + "; ".join(
            f"{k} {v['median']:.4f} ms (q1 {v['q1']:.4f}, q3 {v['q3']:.4f}{share(k, v)})"
            for k, v in row.items() if k != "root") + f"; host syncs per call {syncs}  [{card}]",
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
