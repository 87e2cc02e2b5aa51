#!/usr/bin/env python3
"""Forwards of two or more checkouts of the port, on one GPU, in one run,
to tell a change from the host's spread.

    python3 perf/ab_forward.py PARENT_ROOT CHANGE_ROOT [--path flagship|decode|gauss5|generic] [--rounds 2] [--iters N]

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
TB/s) and its share of it.  ``--path generic`` times ``sep_filter`` on the
rows of ``chip_smoke.py``'s phase 5 that the template does not take, or
takes as a box: ArUco's normalised boxes (``ARUCO_WINDOWS``,
BORDER_REPLICATE | BORDER_ISOLATED) and ``GENERIC_GAUSS``'s Gaussians
(REFLECT_101), each first held equal to its plain version, beside
``chip_smoke.conv_yardstick``'s ``F.conv2d``, with the route each checkout
takes and ``chip_smoke.bound`` of ``chip_smoke.sep_ops``: a box's bound
counts the running sums' operations (so it is its bytes'), and the MAC's
bound, 2 (kw + kh) operations a pixel at 67 TFLOP/s, stands beside it as
``mac bound``.  CUDA events around each call, the 50 MB L2
flushed before it, median and quartiles of ``--iters`` calls (default 200;
20 after 3 warm-ups for gauss5 and generic, ``chip_smoke.Timer``'s protocol), as the
caller sees it and with the host part held out of the window (the card
spins first, so the whole call is queued when the window opens), and the
host's enqueue time of the call in that second run (``... host``: the
host clock around the call while the card spins, so nothing waits for
it).  Prints one line per process and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

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
    elif path == "generic":
        fns, routes, bounds = generic_rows(torch, root)
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

    warmup = 3 if path in ("gauss5", "generic") else 5

    def quartiles(times):
        q1, med, q3 = statistics.quantiles(times, n=4)
        return {"median": med, "q1": q1, "q3": q3}

    def timed(fn, device_only):
        for _ in range(warmup):
            fn()
        times, host = [], []
        for _ in range(iters):
            flush.zero_()
            if device_only:
                torch.cuda._sleep(1_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            fn()
            host.append((time.perf_counter() - t0) * 1e3)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return quartiles(times), quartiles(host)

    if path == "gauss5":
        bounds = {name: {"bound": nbytes / HBM_BYTES_PER_S * 1e3}
                  for name, nbytes in GAUSS5_BYTES.items()}
    elif path != "generic":
        routes, bounds = None, {}
    out = {"root": root}
    for name, fn in fns:
        out[name] = timed(fn, False)[0]
        out[name + " device"], out[name + " host"] = timed(fn, True)
    syncs = {name: count_syncs(torch, fn) for name, fn in fns}
    print(json.dumps({**out, "host syncs": syncs, "routes": routes, "bounds": bounds}),
          flush=True)


def chip_smoke():
    """chip_smoke.py of the repo this script lies in, loaded by its path, so
    that the package each child imports stays its root's."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                   "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generic_rows(torch, root: str):
    """The sep_filter rows of ``--path generic`` (each held equal to its
    plain version) and their F.conv2d yardsticks, the route each row takes
    in this checkout, and each row's bounds."""
    import numpy as np
    from opencv_tpu_torch import constants as K
    from opencv_tpu_torch.kernels import sepfilter as S
    from opencv_tpu_torch.ops.filter import (gaussian_kernel_bitexact,
                                             gaussian_kernel_fixedpoint_ed)
    cs = chip_smoke()
    rng = np.random.default_rng(0)
    box_kw = dict(border=K.BORDER_REPLICATE | K.BORDER_ISOLATED)
    table = [(f"box {k}x{k}", cs.ARUCO_SHAPE, (1,) * k, dict(box_kw, scale=1.0 / (k * k)), True)
             for k in cs.ARUCO_WINDOWS]
    table += [(name, shape, tuple(int(v) for v in gaussian_kernel_fixedpoint_ed(
                   gaussian_kernel_bitexact(k, sigma), 8)),
               dict(shift=16, border=K.BORDER_REFLECT_101), False)
              for name, shape, k, sigma in cs.GENERIC_GAUSS]
    inputs = {shape: torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).cuda()
              for shape in dict.fromkeys(row[1] for row in table)}
    fns, routes, bounds = [], {}, {}
    for name, shape, kx, kw, box in table:
        x = inputs[shape]
        if not torch.equal(S.sep_filter_int(x, kx, kx, **kw),
                           S.sep_filter_int_plain(x, kx, kx, **kw)):
            raise AssertionError(f"{root}: sep_filter != plain at {name}")
        routes[name] = S.SEP_ROUTES[S.sep_filter_route(kx, kx)]
        n, k = x.numel(), len(kx)
        b_ms, b_by = cs.bound(2 * n, cs.sep_ops(n, k, box))
        bounds[name] = {"bound": b_ms, "by": b_by}
        if box:
            bounds[name]["mac bound"] = cs.bound(2 * n, cs.sep_ops(n, k, False))[0]
        fns.append((name, lambda x=x, kx=kx, kw=kw: S.sep_filter_int(x, kx, kx, **kw)))
        fns.append((name + " conv2d", cs.conv_yardstick(x, kx, kx, 1, "cuda")))
    return fns, routes, bounds


def share(name: str, v: dict, bounds: dict) -> str:
    """', bound B ms (by), share S' for a row with a bound, and a box's
    MAC bound beside it."""
    b = bounds.get(name.removesuffix(" device"))
    if b is None:
        return ""
    by = f" ({b['by']})" if "by" in b else ""
    mac = f", mac bound {b['mac bound']:.4f} ms" if "mac bound" in b else ""
    return f", bound {b['bound']:.4f} ms{by}, share {b['bound'] / v['median']:.3f}{mac}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--path", choices=("flagship", "decode", "gauss5", "generic"),
                    default="flagship")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.iters is None:
        args.iters = 20 if args.path in ("gauss5", "generic") else 200
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
        tail = f"; host syncs per call {row.pop('host syncs')}"
        routes, bounds = row.pop("routes"), row.pop("bounds")
        if routes is not None:
            tail += f"; routes {routes}"
        print(f"run {i + 1} {root}: " + "; ".join(
            f"{k} {v['median']:.4f} ms (q1 {v['q1']:.4f}, q3 {v['q3']:.4f}"
            f"{share(k, v, bounds)})"
            for k, v in row.items() if k != "root") + f"{tail}  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
