#!/usr/bin/env python3
"""Sweep the gauss5_down2 strip kernel's schedule and plan on one GPU,
beside the parent's kernel.

    python3 perf/sweep_gauss5.py PARENT_ROOT [--out chiprun_out/sweep_gauss5.json]

Builds one shared library per variant of ``opencv_tpu_torch/csrc/fused_preproc.cu``
(patched copies, all nvcc runs at once; the shipped source is not changed)
and one of ``PARENT_ROOT``'s, and prints what ``ptxas -v`` said of each
(registers, spills).  The variants: the shipped source; the prefetched rows
converted right after the blur row that frees their slot (a shorter load
window, fewer live registers); a minimum of 5 and of 6 resident blocks per
SM in ``__launch_bounds__`` (one wave is then 5 or 6 x 132 blocks); BGR
strips of 16 pixels; gray strips of 8.  The shipped source also runs under
plans of other band heights (blocks = 2, 0.75 and 0.5 waves).

Each (variant, plan) is first held bit-equal to the plain version at the
three main-path cases: BGR (8, 1080, 1920, 3) and (2, 1080, 1920, 3), gray
(8, 1080, 1920); then timed there (``chip_smoke.Timer``: CUDA events,
median of 20 after 3 warm-ups, L2 flushed; device-only, and with the
host's enqueue) in two rounds, forward then backward order, beside one
``x.clone()`` of the BGR batch as a calibration of the memory rate.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import Timer, bound, card_line  # noqa: E402
from opencv_tpu_torch.kernels import _build  # noqa: E402
from opencv_tpu_torch.kernels import fused_preproc as F  # noqa: E402

SRC = ROOT / "opencv_tpu_torch" / "csrc" / "fused_preproc.cu"
LATE = '''    blur_row<R>(s);
    blur_row<R + 1>(s);
    store(s, oy);
    if (more) {
      convert<R>(w[0], h[0]);
      convert<R + 1>(w[1], h[1]);
    }
'''
EARLY = '''    blur_row<R>(s);
    if (more) convert<R>(w[0], h[0]);
    blur_row<R + 1>(s);
    if (more) convert<R + 1>(w[1], h[1]);
    store(s, oy);
'''
BOUNDS = "__global__ void __launch_bounds__(32 * kWarps, 4)"
BGR_STRIP, GRAY_STRIP = "constexpr int kStripBgr = 8;", "constexpr int kStripGray = 16;"
# name: (source edits, resident blocks per SM the plan assumes, BGR strip,
# gray strip)
VARIANTS = {
    "shipped": ([], 4, 8, 16),
    "early convert": ([(LATE, EARLY)], 4, 8, 16),
    "min 5 blocks": ([(BOUNDS, BOUNDS.replace(", 4)", ", 5)"))], 5, 8, 16),
    "min 6 blocks": ([(BOUNDS, BOUNDS.replace(", 4)", ", 6)"))], 6, 8, 16),
    "bgr strip 16": ([(BGR_STRIP, BGR_STRIP.replace("8", "16"))], 4, 16, 16),
    "gray strip 8": ([(GRAY_STRIP, GRAY_STRIP.replace("16", "8"))], 4, 8, 8),
}
# plans of the shipped source beyond its own: blocks as a share of a wave
PLAN_SWEEP = [2.0, 0.75, 0.5]


def plan_of(x, has_bgr: bool, px: int, blocks: int) -> F.Plan:
    """The shipped plan of x with another strip width and block count."""
    N, H, W = x.shape[:3]
    plan = F._plan(N, H, W, has_bgr, x.data_ptr())
    gx = -(-W // (32 * px))
    units = N * gx * (H // 2)
    return plan._replace(px=px, gx=gx, blocks=blocks, band=-(-units // (F.WARPS * blocks)))


def build(parent: Path, out: Path) -> dict:
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    jobs = {}
    for name, (edits, _, _, _) in VARIANTS.items():
        src = SRC.read_text()
        for old, new in edits:
            if src.count(old) != 1:
                raise ValueError(f"variant {name}: edit {old[:40]!r} is not unique")
            src = src.replace(old, new)
        cu = out / f"{name.replace(' ', '_')}.cu"
        cu.write_text(src)
        jobs[name] = (cu, SRC.parent)
    jobs["parent"] = (parent / "opencv_tpu_torch" / "csrc" / "fused_preproc.cu",
                      parent / "opencv_tpu_torch" / "csrc")
    procs = {}
    for name, (cu, inc) in jobs.items():
        so = out / f"{name.replace(' ', '_')}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(inc), "-shared", "-o",
               str(so), str(cu)]
        procs[name] = (so, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, cmd, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{log}")
        kernels = _build.parse_ptxas(log)
        print(f"ptxas {name}: " + "; ".join(
            f"{k.split('gauss5_down2_kernel')[-1][:20]} {v.get('registers')} regs, "
            f"{v.get('spill_stores', 0)}/{v.get('spill_loads', 0)} spill B"
            for k, v in kernels.items() if "gauss5" in k), flush=True)
        fn = ctypes.CDLL(str(so)).opencv_gauss5_down2
        fn.argtypes = F.GAUSS5_DOWN2.argtypes
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "sweep_gauss5.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_gauss5: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    dev = torch.device("cuda", 0)
    _build.library()  # the error strings
    libs = build(Path(args.parent), ROOT / "opencv_tpu_torch" / "_build" / "sweep_gauss5")
    rng = np.random.default_rng(0)
    x8, x2 = (torch.from_numpy(rng.integers(0, 256, (n, 1080, 1920, 3), np.uint8)).to(dev)
              for n in (8, 2))
    g8 = torch.from_numpy(rng.integers(0, 256, (8, 1080, 1920), np.uint8)).to(dev)
    cases = [("bgr (8,1080,1920,3)", x8, True), ("bgr (2,1080,1920,3)", x2, True),
             ("gray (8,1080,1920)", g8, False)]
    taps = F._taps(0.0)

    def launch(fn, x, has_bgr, plan):
        N, H, W = x.shape[:3]
        out = torch.empty((N, H // 2, W // 2), dtype=torch.uint8, device=dev)
        a = (*taps, plan.px, plan.blocks, plan.gx, int(plan.vec))
        err = fn(x.data_ptr(), out.data_ptr(), N, H, W, int(has_bgr), (ctypes.c_int * 9)(*a),
                 _build.stream_of(x))
        if err:
            raise RuntimeError(f"launch failed: {err}")
        return out

    runs = []  # (label, variant, case, plan)
    for name, (_, per_sm, bgr_px, gray_px) in VARIANTS.items():
        for case, x, has_bgr in cases:
            plan = plan_of(x, has_bgr, bgr_px if has_bgr else gray_px, per_sm * F.SMS)
            runs.append((name, name, case, plan))
    for share in PLAN_SWEEP:
        for case, x, has_bgr in cases:
            plan = F._plan(*x.shape[:3], has_bgr, x.data_ptr())
            plan = plan_of(x, has_bgr, plan.px, int(share * F.WAVE))
            runs.append((f"shipped, {plan.blocks} blocks", "shipped", case, plan))
    for case, x, has_bgr in cases:
        runs.append(("parent", "parent", case, F._plan(*x.shape[:3], has_bgr, x.data_ptr())))
    inputs = {case: (x, has_bgr) for case, x, has_bgr in cases}
    for label, lib, case, plan in runs:
        x, has_bgr = inputs[case]
        plain = F.fused_gray_gauss5_down2_plain if has_bgr else F.gauss5_down2_u8_plain
        if not torch.equal(launch(libs[lib], x, has_bgr, plan), plain(x)):
            raise AssertionError(f"{label} {case}: kernel != plain")
    print("every variant and plan equals the plain version", flush=True)

    timer = Timer(dev)
    dev_ms, host_ms = {}, {}
    order = list(range(len(runs)))
    for rnd in (order, order[::-1]):
        for i in rnd:
            label, lib, case, plan = runs[i]
            x, has_bgr = inputs[case]
            fn = (lambda lib=lib, x=x, b=has_bgr, p=plan: launch(libs[lib], x, b, p))
            dev_ms.setdefault(i, []).append(timer(fn, device_only=True))
            host_ms.setdefault(i, []).append(timer(fn))
    rows = []
    for i, (label, lib, case, plan) in enumerate(runs):
        x, _ = inputs[case]
        nbytes = x.numel() + x.numel() // (4 * (x.shape[3] if x.ndim == 4 else 1))
        b_ms, _ = bound(nbytes, 0)
        t, th = dev_ms[i], host_ms[i]
        rows.append(dict(label=label, case=case, plan=plan._asdict(), ms=t, ms_with_host=th,
                         bound_ms=b_ms, share=b_ms / min(t)))
        print(f"{label} {case} (blocks {plan.blocks}, strip {plan.px}, band {plan.band}): "
              f"{t[0]:.4f} / {t[1]:.4f} ms (with the host's enqueue {th[0]:.4f} / {th[1]:.4f}), "
              f"bound {b_ms:.4f} ms, share {b_ms / min(t):.3f}  [{card}]", flush=True)
    t_copy = [timer(lambda: x8.clone(), device_only=True) for _ in range(2)]
    b_copy, _ = bound(2 * x8.numel(), 0)
    print(f"calibration x.clone() (8,1080,1920,3): {t_copy[0]:.4f} / {t_copy[1]:.4f} ms, bound "
          f"{b_copy:.4f} ms, share {b_copy / min(t_copy):.3f}  [{card}]", flush=True)
    rows.append(dict(label="torch clone", case="bgr (8,1080,1920,3)", ms=t_copy, bound_ms=b_copy,
                     share=b_copy / min(t_copy)))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=card, rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
