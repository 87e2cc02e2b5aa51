#!/usr/bin/env python3
"""Forwards of two or more checkouts of the port, on one GPU, in one run,
to tell a change from the host's spread.

    python3 perf/ab_forward.py PARENT_ROOT CHANGE_ROOT [--path flagship|decode] [--rounds 2] [--iters 200]

Each root is a directory that holds an ``opencv_tpu_torch`` package (a
``git archive`` of a commit, or the repo itself).  Every round runs the
roots in the order given and then reversed (parent, change, change,
parent), each in a fresh process that imports the package from its root,
builds its kernels, and times ``entry.forward`` and ``entry.forward_fused``
on the (8, 1080, 1920, 3) batch (``--path flagship``), or
``entry.forward_decode_color`` on NV12 (8, 1080, 1920) and ``threshold``
BINARY | OTSU on its (8, 540, 960, 1) map, with the host syncs of one call
of each (``--path decode``): CUDA events around each call, the 50 MB
L2 flushed before it, median and quartiles of ``--iters`` calls, as the
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
    if path == "decode":
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

    def timed(fn, device_only):
        for _ in range(5):
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--path", choices=("flagship", "decode"), default="flagship")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
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
            f"{k} {v['median']:.4f} ms (q1 {v['q1']:.4f}, q3 {v['q3']:.4f})"
            for k, v in row.items() if k != "root") + f"; host syncs per call {syncs}  [{card}]",
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
