#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``opencv_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, and no result line):

1. device: a CUDA device is present; prints nvidia-smi's name and power limit;
2. build: compiles the CUDA kernels from ``opencv_tpu_torch/csrc`` (nvcc);
3. kernels: each kernel equals its plain PyTorch version bit for bit
   (``torch.equal``) at the main path's shapes and on small edge cases;
4. main path: ``entry("cuda")``'s forward and the fused forward on the
   (8, 1080, 1920, 3) batch; every kernel must have launched in that run, the
   fused path must equal the composed one, and images 0 and 1 must equal the
   CPU plain forward (exact before the warp; after it max |d| <= 1 on at most
   0.1% of pixels, the warp tolerance of the tests);
5. timing: CUDA events, median of 20 after warm-up, with L2 flushed between
   runs: each kernel beside its plain version, and the whole forwards.

The last two lines are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# (warp) max |d| allowed between GPU and CPU plain output, and the share of
# pixels that may differ: the bound tests/test_warp.py uses against cv2
WARP_ATOL = 1
WARP_MAX_FRACTION = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


class Timer:
    """CUDA-event timing: warm-up, then the median of `iters` runs, each
    after a write of 256 MiB that evicts the 50 MB L2 (outside the timed
    window)."""

    def __init__(self, device):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def check_equal(name, got, want) -> int:
    """Raise unless `got` equals `want` exactly; return max |got - want|."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} != "
                             f"{tuple(want.shape)} {want.dtype}")
    d = (got.to(torch.int64) - want.to(torch.int64)).abs()
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel != plain ({int(d.count_nonzero())} differ, "
                             f"max |d| = {int(d.max())})")
    return int(d.max())


def sep_cases(K, gauss_taps):
    """(name, shape, kwargs of sep_filter_int) for phase 3."""
    borders = {"CONSTANT": K.BORDER_CONSTANT, "REPLICATE": K.BORDER_REPLICATE,
               "REFLECT": K.BORDER_REFLECT, "WRAP": K.BORDER_WRAP,
               "REFLECT_101": K.BORDER_REFLECT_101}
    cases = [("main gauss k5 s0 REFLECT_101", (8, 1080, 1920, 1),
              dict(kx=gauss_taps(5, 0.0), ky=gauss_taps(5, 0.0), shift=16,
                   border=K.BORDER_REFLECT_101))]
    for bname, border in borders.items():
        for C in (1, 3, 4):
            for k, sigma in ((3, 0.8), (9, 2.0), (31, 5.0)):
                cases.append((f"gauss k{k} C{C} {bname}", (2, 45, 141, C),
                              dict(kx=gauss_taps(k, sigma), ky=gauss_taps(k, sigma), shift=16,
                                   border=border, border_value=7)))
        cases.append((f"gauss k31 tiny C3 {bname}", (1, 5, 7, 3),
                      dict(kx=gauss_taps(31, 5.0), ky=gauss_taps(31, 5.0), shift=16,
                           border=border)))
    cases += [
        ("constant per-channel C3", (2, 33, 70, 3),
         dict(kx=gauss_taps(5, 1.5), ky=gauss_taps(9, 2.0), shift=16,
              border=K.BORDER_CONSTANT, border_value=(11, 22, 33))),
        ("constant per-channel C4", (2, 33, 70, 4),
         dict(kx=gauss_taps(7, 1.2), ky=gauss_taps(3, 0.0), shift=16,
              border=K.BORDER_CONSTANT, border_value=(1, 2, 250, 255))),
        ("sobel dx i16", (2, 70, 90, 1),
         dict(kx=(-1, 0, 1), ky=(1, 2, 1), shift=0, out_dtype="int16")),
        ("sobel k5 dyy i16 C3 +delta", (2, 70, 90, 3),
         dict(kx=(1, 4, 6, 4, 1), ky=(1, 0, -2, 0, 1), shift=0, delta=-5, out_dtype="int16",
              border=K.BORDER_REPLICATE)),
        ("box k3 scale", (2, 70, 90, 1),
         dict(kx=(1,) * 3, ky=(1,) * 3, scale=1.0 / 9, border=K.BORDER_REFLECT_101)),
        ("box k9 scale C4", (2, 70, 90, 4),
         dict(kx=(1,) * 9, ky=(1,) * 9, scale=1.0 / 81, border=K.BORDER_REPLICATE)),
        ("odd size 1x1", (1, 1, 1, 1),
         dict(kx=gauss_taps(5, 0.0), ky=gauss_taps(5, 0.0), shift=16)),
        ("odd size 17x129 C2", (3, 17, 129, 2),
         dict(kx=gauss_taps(5, 1.1), ky=gauss_taps(5, 1.1), shift=16,
              border=K.BORDER_WRAP)),
    ]
    return cases


def main() -> int:
    # -- 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import opencv_tpu_torch as cv
    from opencv_tpu_torch import entry as E
    from opencv_tpu_torch.kernels import KERNELS, _build
    from opencv_tpu_torch.kernels.fused_preproc import (
        fused_gray_gauss5_down2, fused_gray_gauss5_down2_plain, gauss5_down2_u8,
        gauss5_down2_u8_plain)
    from opencv_tpu_torch.kernels.sepfilter import sep_filter_int, sep_filter_int_plain
    from opencv_tpu_torch.ops.filter import gaussian_kernel_bitexact, gaussian_kernel_fixedpoint_ed

    # -- 2. build
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.3f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")

    # -- 3. each kernel against its plain version, on the card
    def gauss_taps(k, sigma):
        return tuple(int(v) for v in
                     gaussian_kernel_fixedpoint_ed(gaussian_kernel_bitexact(k, sigma), 8))

    rng = np.random.default_rng(1)
    max_err = {}
    cases = sep_cases(cv, gauss_taps)
    for name, shape, kw in cases:
        x = torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(dev)
        err = check_equal(f"sep_filter {name}", sep_filter_int(x, **kw),
                          sep_filter_int_plain(x, **kw))
        if name.startswith("main"):
            max_err["sep_filter"] = err
    log(f"sep_filter: {len(cases)} cases equal to the plain version")

    imgs = torch.from_numpy(E.make_batch()).to(dev)
    n = 0
    for sigma in (0.0, 1.5):
        err = check_equal(f"gauss5_down2 bgr sigma {sigma}",
                          fused_gray_gauss5_down2(imgs, sigma),
                          fused_gray_gauss5_down2_plain(imgs, sigma))
        max_err["gauss5_down2"] = max(max_err.get("gauss5_down2", 0), err)
        n += 1
    gray = cv.cvtColor(imgs, cv.COLOR_BGR2GRAY)[..., 0].contiguous()
    check_equal("gauss5_down2 gray", gauss5_down2_u8(gray, 0.0),
                gauss5_down2_u8_plain(gray, 0.0))
    n += 1
    for shape, sigma in (((2, 98, 262, 3), 0.8), ((1, 4, 6, 3), 0.0), ((3, 34, 130, 3), 2.0)):
        x = torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(dev)
        check_equal(f"gauss5_down2 {shape}", fused_gray_gauss5_down2(x, sigma),
                    fused_gray_gauss5_down2_plain(x, sigma))
        check_equal(f"gauss5_down2 gray {shape}", gauss5_down2_u8(x[..., 1].contiguous(), sigma),
                    gauss5_down2_u8_plain(x[..., 1].contiguous(), sigma))
        n += 2
    log(f"gauss5_down2: {n} cases equal to the plain version")

    # -- 4. the main path
    forward, (imgs,) = E.entry("cuda")
    torch.cuda.synchronize()
    for k in KERNELS:
        k.launches = 0
    out = forward(imgs)
    out_fused = E.forward_fused(imgs)
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in KERNELS}
    log(f"main path launches: {launches}")
    missing = [s for s, c in launches.items() if c < 1]
    if missing:
        raise AssertionError(f"kernels not launched by the main path: {missing}")

    N, H, W, _ = E.SHAPE
    if out.shape != (N, H // 2, W // 2, 1) or out.dtype != torch.uint8:
        raise AssertionError(f"forward output {tuple(out.shape)} {out.dtype}")
    pre = E.preprocess(imgs)
    check_equal("fused preprocess vs composed", E.preprocess_fused(imgs), pre)
    check_equal("forward_fused vs forward", out_fused, out)

    cpu = imgs[:2].cpu()
    pre_cpu = E.preprocess(cpu)
    if not torch.equal(pre[:2].cpu(), pre_cpu):
        raise AssertionError("preprocess on the card != CPU plain preprocess")
    d = (out[:2].cpu().to(torch.int32) - E.warp(pre_cpu).to(torch.int32)).abs()
    n_diff = int(d.count_nonzero())
    if int(d.max()) > WARP_ATOL or n_diff > WARP_MAX_FRACTION * d.numel():
        raise AssertionError(f"forward vs CPU plain: max |d| {int(d.max())}, {n_diff} differ")
    log(f"main path: output {tuple(out.shape)} equals the CPU plain forward on images 0-1 "
        f"(preprocess exact; warp max |d| {int(d.max())}, {n_diff} of {d.numel()} differ)")

    # -- 5. timing
    timer = Timer(dev)
    kx5 = gauss_taps(5, 0.0)
    g1 = gray[..., None].contiguous()
    rows = [
        ("sep_filter", lambda: sep_filter_int(g1, kx5, kx5, shift=16),
         lambda: sep_filter_int_plain(g1, kx5, kx5, shift=16), "(8,1080,1920,1) k5"),
        ("gauss5_down2", lambda: fused_gray_gauss5_down2(imgs, 0.0),
         lambda: fused_gray_gauss5_down2_plain(imgs, 0.0), "(8,1080,1920,3) bgr"),
        ("gauss5_down2 gray", lambda: gauss5_down2_u8(gray, 0.0),
         lambda: gauss5_down2_u8_plain(gray, 0.0), "(8,1080,1920) gray"),
    ]
    times = {}
    for name, kern, plain, what in rows:
        t_plain = timer(plain)
        t_kern = timer(kern)
        times[name] = (t_kern, t_plain)
        log(f"time {name} {what}: kernel {t_kern:.4f} ms, plain {t_plain:.4f} ms  [{card}]")
    t_fwd = timer(lambda: forward(imgs))
    t_fused = timer(lambda: E.forward_fused(imgs))
    log(f"time forward (8,1080,1920,3): {t_fwd:.4f} ms  [{card}]")
    log(f"time forward_fused (8,1080,1920,3): {t_fused:.4f} ms  [{card}]")

    meta = {
        "sep_filter": ("opencv_tpu_torch/csrc/sepfilter.cu",
                       "opencv_tpu/kernels/sepfilter.py:216", "opencv_sep_filter"),
        "gauss5_down2": ("opencv_tpu_torch/csrc/fused_preproc.cu",
                         "opencv_tpu/kernels/fused_preproc.py:209", "opencv_gauss5_down2"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[sym], "max_abs_err": max_err[name],
                "ms": times[name][0], "plain_ms": times[name][1]}
               for name, (src, rep, sym) in meta.items()]
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
