#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``opencv_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, and no result line):

1. device: a CUDA device is present; prints nvidia-smi's name and power limit;
2. build: compiles the CUDA kernels from ``opencv_tpu_torch/csrc`` (nvcc);
3. kernels: each kernel (sep_filter, gauss5_down2, pyr_down) equals its
   plain PyTorch version bit for bit (``torch.equal``) on the whole batch at
   the main paths' shapes, with the taps and borders those paths give it,
   and on edge cases (borders, channel counts, odd and tiny sizes);
4. main paths, each read with the launch counts set to 0 just before it:
   a. the flagship: ``entry("cuda")``'s forward and the fused forward on the
      (8, 1080, 1920, 3) batch; sep_filter and gauss5_down2 must have
      launched, the fused path must equal the composed one, and images 0 and
      1 must equal the CPU plain forward (exact before the warp; after it
      max |d| <= 1 on at most 0.1% of pixels, the warp tolerance of the
      tests);
   b. BASELINE config 3: ``entry_pyr_corner_edge("cuda")``'s forward
      (pyrDown, cornerHarris, Sobel, Canny) on the (8, 1080, 1920, 1) batch;
      pyr_down must have launched once and sep_filter at least 3 times, and
      on images 0 and 1 pyrDown, Sobel and Canny must equal the CPU plain
      forward exactly and cornerHarris be within HARRIS_RTOL/HARRIS_ATOL;
      then Canny on the batch smoothed by GaussianBlur 7x7 sigma 2.5, exact
      against the CPU, with its hysteresis iterations and host syncs;
5. timing: CUDA events, median of 20 after warm-up, with L2 flushed between
   runs: each kernel beside its plain version, each op of config 3, and the
   whole forwards.

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
# (cornerHarris) float32 on the card vs the CPU: |d| <= HARRIS_RTOL * |ref|
# + HARRIS_ATOL * max |ref|, the bound tests/test_torch_analysis.py holds the
# port to against opencv_tpu
HARRIS_RTOL = 1e-5
HARRIS_ATOL = 1e-6


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


def check_close(name, got, want, rtol, atol) -> float:
    """Raise unless |got - want| <= rtol * |want| + atol * max |want|
    elementwise; print and return max |got - want|."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} != "
                             f"{tuple(want.shape)} {want.dtype}")
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{name}: non-finite values")
    d = (got.to(torch.float64) - want.to(torch.float64)).abs()
    ref_max = float(want.abs().max())
    bound = rtol * want.to(torch.float64).abs() + atol * ref_max
    log(f"{name}: max |d| {float(d.max()):.6g}, max |ref| {ref_max:.6g} "
        f"(rtol {rtol}, atol {atol} * max |ref|)")
    if bool((d > bound).any()):
        raise AssertionError(f"{name}: {int((d > bound).sum())} values out of tolerance")
    return float(d.max())


def pyr_cases(K):
    """(name, shape, border) for phase 3's pyr_down cases."""
    borders = {"REPLICATE": K.BORDER_REPLICATE, "REFLECT": K.BORDER_REFLECT,
               "WRAP": K.BORDER_WRAP, "REFLECT_101": K.BORDER_REFLECT_101}
    cases = [(f"main {b}", (8, 1080, 1920, 1), border) for b, border in borders.items()]
    for bname, border in borders.items():
        for C in (1, 3, 4):
            for hw in ((40, 52), (41, 53), (40, 53), (16, 16), (17, 16), (67, 261),
                       (1, 1), (2, 3), (5, 7), (9, 15)):
                cases.append((f"{hw} C{C} {bname}", (2, *hw, C), border))
    return cases


def sep_cases(K, gauss_taps):
    """(name, shape, kwargs of sep_filter_int) for phase 3."""
    borders = {"CONSTANT": K.BORDER_CONSTANT, "REPLICATE": K.BORDER_REPLICATE,
               "REFLECT": K.BORDER_REFLECT, "WRAP": K.BORDER_WRAP,
               "REFLECT_101": K.BORDER_REFLECT_101}
    main = (8, 1080, 1920, 1)
    cases = [("main gauss k5 s0 REFLECT_101", main,
              dict(kx=gauss_taps(5, 0.0), ky=gauss_taps(5, 0.0), shift=16,
                   border=K.BORDER_REFLECT_101)),
             # config 3: Sobel(x, CV_16S, 1, 0), and Canny's dx and dy
             ("main sobel dx i16 REFLECT_101", main,
              dict(kx=(-1, 0, 1), ky=(1, 2, 1), out_dtype="int16",
                   border=K.BORDER_REFLECT_101)),
             ("main canny dx i16 REPLICATE", main,
              dict(kx=(-1, 0, 1), ky=(1, 2, 1), out_dtype="int16", border=K.BORDER_REPLICATE)),
             ("main canny dy i16 REPLICATE", main,
              dict(kx=(1, 2, 1), ky=(-1, 0, 1), out_dtype="int16", border=K.BORDER_REPLICATE))]
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
    from opencv_tpu_torch.kernels.sepfilter import (
        pyr_down_u8, pyr_down_u8_plain, sep_filter_int, sep_filter_int_plain)
    from opencv_tpu_torch.ops.canny import HYST_CHECK_EVERY
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
            max_err["sep_filter"] = max(max_err.get("sep_filter", 0), err)
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

    cases = pyr_cases(cv)
    for name, shape, border in cases:
        x = torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(dev)
        err = check_equal(f"pyr_down {name}", pyr_down_u8(x, border), pyr_down_u8_plain(x, border))
        if name.startswith("main"):
            max_err["pyr_down"] = max(max_err.get("pyr_down", 0), err)
    log(f"pyr_down: {len(cases)} cases equal to the plain version")

    # -- 4a. the flagship path
    def run_counted(fn):
        """Run fn with every launch count set to 0 first; return its result
        and the counts it left."""
        torch.cuda.synchronize()
        for k in KERNELS:
            k.launches = 0
        result = fn()
        torch.cuda.synchronize()
        return result, {k.symbol: k.launches for k in KERNELS}

    forward, (imgs,) = E.entry("cuda")
    (out, out_fused), flagship = run_counted(lambda: (forward(imgs), E.forward_fused(imgs)))
    log(f"flagship path launches: {flagship}")
    missing = [s for s in ("opencv_sep_filter", "opencv_gauss5_down2") if flagship[s] < 1]
    if missing:
        raise AssertionError(f"kernels not launched by the flagship path: {missing}")

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
    log(f"flagship path: output {tuple(out.shape)} equals the CPU plain forward on images 0-1 "
        f"(preprocess exact; warp max |d| {int(d.max())}, {n_diff} of {d.numel()} differ)")

    # -- 4b. BASELINE config 3
    forward3, (x3,) = E.entry_pyr_corner_edge("cuda")
    outs3, cfg3 = run_counted(lambda: forward3(x3))
    log(f"config 3 path launches: {cfg3}")
    if cfg3["opencv_pyr_down"] != 1 or cfg3["opencv_sep_filter"] < 3:
        raise AssertionError(f"config 3 path: pyr_down must launch once and sep_filter at "
                             f"least 3 times, got {cfg3}")
    N3, H3, W3, _ = E.SHAPE_CFG3
    shapes = [(N3, (H3 + 1) // 2, (W3 + 1) // 2, 1), (N3, H3, W3, 1), (N3, H3, W3, 1),
              (N3, H3, W3, 1)]
    want_cpu = forward3(x3[:2].cpu())
    for name, got, shape, want in zip(("pyrDown", "cornerHarris", "Sobel", "Canny"),
                                      outs3, shapes, want_cpu):
        if tuple(got.shape) != shape:
            raise AssertionError(f"config 3 {name}: shape {tuple(got.shape)} != {shape}")
        if name == "cornerHarris":
            check_close("config 3 cornerHarris vs CPU, images 0-1", got[:2].cpu(), want,
                        HARRIS_RTOL, HARRIS_ATOL)
        else:
            check_equal(f"config 3 {name} vs CPU, images 0-1", got[:2].cpu(), want)
    canny_edges = int((outs3[3] > 0).sum())
    log(f"config 3: pyrDown, Sobel and Canny equal the CPU plain forward on images 0-1; "
        f"{canny_edges} Canny edge pixels in the batch; total {int(outs3[4])}")

    smooth = cv.GaussianBlur(x3, (7, 7), 2.5)
    smooth_cpu = cv.GaussianBlur(x3[:2].cpu(), (7, 7), 2.5)
    check_equal("GaussianBlur 7x7 s2.5 vs CPU, images 0-1", smooth[:2].cpu(), smooth_cpu)
    st_gpu, st_cpu = {}, {}
    edges_s = cv.Canny(smooth, 50, 150, stats=st_gpu)
    check_equal("Canny on the smoothed batch vs CPU, images 0-1", edges_s[:2].cpu(),
                cv.Canny(smooth_cpu, 50, 150, stats=st_cpu))
    st_noise = {}
    cv.Canny(x3, 50, 150, stats=st_noise)
    log(f"Canny hysteresis (check every {HYST_CHECK_EVERY}): noise batch {st_noise}; "
        f"smoothed batch {st_gpu} on the card, images 0-1 {st_cpu} on the CPU")

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
        ("pyr_down", lambda: pyr_down_u8(x3), lambda: pyr_down_u8_plain(x3),
         "(8,1080,1920,1) REFLECT_101"),
        ("sep_filter sobel", lambda: sep_filter_int(x3, (-1, 0, 1), (1, 2, 1), out_dtype="int16"),
         lambda: sep_filter_int_plain(x3, (-1, 0, 1), (1, 2, 1), out_dtype="int16"),
         "(8,1080,1920,1) Sobel dx u8->16S"),
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
    x3f = x3.to(torch.float32) / 255.0
    for name, fn in (("pyrDown", lambda: cv.pyrDown(x3)),
                     ("cornerHarris(x/255, 2, 3, 0.04)", lambda: cv.cornerHarris(x3f, 2, 3, 0.04)),
                     ("Sobel 16S dx", lambda: cv.Sobel(x3, cv.CV_16S, 1, 0)),
                     ("Canny 50/150 noise", lambda: cv.Canny(x3, 50, 150)),
                     ("Canny 50/150 smoothed", lambda: cv.Canny(smooth, 50, 150))):
        log(f"time op {name} (8,1080,1920,1): {timer(fn):.4f} ms  [{card}]")
    log(f"time forward_pyr_corner_edge (8,1080,1920,1): {timer(lambda: forward3(x3)):.4f} ms  "
        f"[{card}]")

    meta = {
        "sep_filter": ("opencv_tpu_torch/csrc/sepfilter.cu",
                       "opencv_tpu/kernels/sepfilter.py:216", "opencv_sep_filter"),
        "gauss5_down2": ("opencv_tpu_torch/csrc/fused_preproc.cu",
                         "opencv_tpu/kernels/fused_preproc.py:209", "opencv_gauss5_down2"),
        "pyr_down": ("opencv_tpu_torch/csrc/pyrdown.cu",
                     "opencv_tpu/kernels/sepfilter.py:295", "opencv_pyr_down"),
    }
    # launches: the kernel's count over both main paths (4a and 4b)
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": flagship[sym] + cfg3[sym], "max_abs_err": max_err[name],
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
