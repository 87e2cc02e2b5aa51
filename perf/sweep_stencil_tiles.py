#!/usr/bin/env python3
"""Sweep the tile constants of the stencil kernels on one GPU, and probe
their schedule.

    python3 perf/sweep_stencil_tiles.py [--out chiprun_out/sweep_stencil_tiles.json]

Builds one shared library per variant of ``opencv_tpu_torch/csrc/sepfilter.cu``
and ``csrc/pyrdown.cu`` with some ``constexpr int`` constants replaced (rows
per warp strip, staged rows) or a small code edit (a minimum of blocks per
SM in ``__launch_bounds__``), all nvcc runs at once.  The shipped sources
are not changed: a variant is a patched copy.  For each variant it holds the
kernel bit-equal to its plain version at the main paths' shapes
((8, 1080, 1920, 1): the Gaussian k5 u8 and the Sobel k3 u8 -> i16, and
pyrDown), then times it (CUDA events, median of 20, L2 flushed;
``chip_smoke.Timer``, device-only and with the host's enqueue) in two
rounds, forward then backward order, beside one ``x.clone()`` of the same
batch as a calibration of the memory rate the timing reaches.

The schedule probe builds the shipped kernels with lane 0 of every warp
recording its start and end (%globaltimer) and whether it ran the edge
path: it prints the span, the mean and longest main and edge warp, and the
start of the last main warp (a second wave of blocks shows there).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import Timer, bound, card_line  # noqa: E402
from opencv_tpu_torch.kernels import _build  # noqa: E402
from opencv_tpu_torch.kernels import sepfilter as S  # noqa: E402

CSRC = ROOT / "opencv_tpu_torch" / "csrc"

# (kernel, {constant: value}); the first of each kernel is the shipped source
# a minimum of resident blocks per SM for the register allocator
MIN_BLOCKS = {
    "sep": lambda n: [("__global__ void __launch_bounds__(32 * kWarps)\n    sep_filter_kernel",
                       f"__global__ void __launch_bounds__(32 * kWarps, {n})\n    sep_filter_kernel")],
    "pyr": lambda n: [("__global__ void __launch_bounds__(32 * kWarps)\n    pyr_down_kernel",
                       f"__global__ void __launch_bounds__(32 * kWarps, {n})\n    pyr_down_kernel")],
}
VARIANTS = [
    ("sep", {}),
    ("sep", {"kStrip": 4}),
    ("sep", {"kStrip": 16}),
    ("sep", {"kStages": 4}),
    ("sep", {"edits": MIN_BLOCKS["sep"](4)}),
    ("pyr", {}),
    ("pyr", {"kStrip": 2}),
    ("pyr", {"kStrip": 8}),
    ("pyr", {"kStages": 8}),
    ("pyr", {"edits": MIN_BLOCKS["pyr"](6)}),
]
SOURCES = {"sep": "sepfilter.cu", "pyr": "pyrdown.cu"}


def patched(kernel: str, consts: dict) -> str:
    src = (CSRC / SOURCES[kernel]).read_text()
    for old, new in consts.get("edits", ()):  # code edits of an experiment
        if src.count(old) != 1:
            raise ValueError(f"{SOURCES[kernel]}: edit {old!r} is not unique")
        src = src.replace(old, new)
    for name, value in consts.items():
        if name in ("edits", "probe"):
            continue
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
        if n != 1:
            raise ValueError(f"{SOURCES[kernel]}: no single constant {name}")
    return src


# The schedule probe: a copy of the shipped kernel in which lane 0 of every
# warp records its start and end (%globaltimer, ns), its SM and whether it
# ran the edge path, for the host to read back.
PROBE_HEAD = """
struct ProbeRec { unsigned long long t0, t1; unsigned sm, edge; };
__device__ ProbeRec g_rec[1 << 16];
__device__ unsigned g_nrec;
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t; asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t)); return t; }
__device__ __forceinline__ void probe_record(unsigned long long t0, unsigned edge) {
  if (threadIdx.x != 0) return;
  unsigned sm; asm volatile("mov.u32 %0, %smid;" : "=r"(sm));
  const unsigned i = atomicAdd(&g_nrec, 1u);
  if (i < (1u << 16)) g_rec[i] = ProbeRec{t0, gtime(), sm, edge};
}
extern "C" int probe_read(void* out, unsigned* n) {
  cudaError_t e = cudaMemcpyFromSymbol(n, g_nrec, sizeof(unsigned));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out, g_rec, sizeof(g_rec));
  unsigned zero = 0;
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_nrec, &zero, sizeof(unsigned));
  return e;
}
"""
_LOOP_END = "    step(r + 1, mB, lB, rB);\n  }\n}\n"  # the end of the main path
PROBE_EDITS = {
    "sep": [("  if (blockIdx.x == gridDim.x - 1) {\n"
             "    sep_edges<K, C, OutT>(img, out, taps, p, blockIdx.y * kWarps * kStrip);\n"
             "    return;",
             "  const unsigned long long g0 = gtime();\n  if (blockIdx.x == gridDim.x - 1) {\n"
             "    sep_edges<K, C, OutT>(img, out, taps, p, blockIdx.y * kWarps * kStrip);\n"
             "    probe_record(g0, 1);\n    return;"),
            (_LOOP_END,
             _LOOP_END.replace("  }\n}\n", "  }\n  probe_record(g0, 0);\n}\n"))],
    "pyr": [("  if (blockIdx.x == gridDim.x - 1) {\n"
             "    pyr_edges<C>(img, out, H, W, border, blockIdx.y * kWarps * kStrip);\n    return;",
             "  const unsigned long long g0 = gtime();\n  if (blockIdx.x == gridDim.x - 1) {\n"
             "    pyr_edges<C>(img, out, H, W, border, blockIdx.y * kWarps * kStrip);\n"
             "    probe_record(g0, 1);\n    return;"),
            (_LOOP_END,
             _LOOP_END.replace("  }\n}\n", "  }\n  probe_record(g0, 0);\n}\n"))],
}
PROBES = [("sep", {"probe": True}), ("pyr", {"probe": True})]


def probed(kernel: str) -> str:
    src = patched(kernel, {"edits": PROBE_EDITS[kernel]})
    return src.replace('#include "common.cuh"\n', '#include "common.cuh"\n' + PROBE_HEAD, 1)


def build(build_dir: Path) -> list:
    build_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    cmds, libs = [], []
    for i, (kernel, consts) in enumerate(VARIANTS + PROBES):
        cu = build_dir / f"v{i}_{SOURCES[kernel]}"
        cu.write_text(probed(kernel) if consts.get("probe") else patched(kernel, consts))
        so = build_dir / f"v{i}.so"
        cmds.append([nvcc, *_build.NVCC_FLAGS, "-I", str(CSRC), "-shared", "-o", str(so),
                     str(cu)])
        libs.append(so)
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    for c, p in zip(cmds, procs):
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(c)}\n{out}")
    return libs


def use(lib_path: Path, kernel: str) -> None:
    """Point the wrapper's Kernel at the variant's entry point."""
    k = S.SEP_FILTER if kernel == "sep" else S.PYR_DOWN
    fn = getattr(ctypes.CDLL(str(lib_path)), k.symbol)
    fn.argtypes = k.argtypes
    fn.restype = ctypes.c_int
    k._fn = fn


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "sweep_stencil_tiles.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_stencil_tiles: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    dev = torch.device("cuda", 0)
    _build.library()  # the error-string entry the wrapper reads
    libs = build(ROOT / "opencv_tpu_torch" / "_build" / "sweep")

    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (8, 1080, 1920, 1),
                                                           np.uint8)).to(dev)
    n1 = x.numel()
    n_half = 8 * 540 * 960
    g5 = (16, 64, 96, 64, 16)  # GaussianBlur 5x5 sigma 0 in Q8: Q8 x Q8, shift 16
    cases = {
        "sep": [("gauss k5 u8", dict(kx=g5, ky=g5, shift=16), 2 * n1, 20 * n1),
                ("sobel k3 i16", dict(kx=(-1, 0, 1), ky=(1, 2, 1), out_dtype="int16"), 3 * n1,
                 12 * n1)],
        "pyr": [("pyr_down", {}, n1 + n_half, 2 * (5 * n1 // 2 + 5 * n_half))],
    }

    def run(kernel, kw):
        return S.sep_filter_int(x, **kw) if kernel == "sep" else S.pyr_down_u8(x)

    def plain(kernel, kw):
        return S.sep_filter_int_plain(x, **kw) if kernel == "sep" else S.pyr_down_u8_plain(x)

    for i, (kernel, consts) in enumerate(VARIANTS):
        use(libs[i], kernel)
        for name, kw, _, _ in cases[kernel]:
            got = run(kernel, kw)
            torch.cuda.synchronize()
            if not torch.equal(got, plain(kernel, kw)):
                raise AssertionError(f"variant {VARIANTS[i]} {name}: kernel != plain")

    timer = Timer(dev)
    times, host = {}, {}  # device-only windows; windows with the host's enqueue
    order = list(range(len(VARIANTS)))
    for rnd in (order, order[::-1]):
        for i in rnd:
            kernel, _ = VARIANTS[i]
            use(libs[i], kernel)
            for name, kw, _, _ in cases[kernel]:
                times.setdefault((i, name), []).append(
                    timer(lambda: run(kernel, kw), device_only=True))
                host.setdefault((i, name), []).append(timer(lambda: run(kernel, kw)))
    rows = []
    for i, (kernel, consts) in enumerate(VARIANTS):
        for name, _, nbytes, ops in cases[kernel]:
            b_ms, _ = bound(nbytes, ops)
            t = times[(i, name)]
            th = host[(i, name)]
            rows.append(dict(kernel=kernel, consts={k: v for k, v in consts.items() if k != "edits"},
                             edits=bool(consts.get("edits")), case=name, ms=t, ms_with_host=th,
                             bound_ms=b_ms, share=b_ms / min(t)))
            label = ({k: v for k, v in consts.items() if k != "edits"} or "shipped",
                     len(consts.get("edits", ())))
            print(f"{kernel} {label} {name}: {t[0]:.4f} / {t[1]:.4f} ms "
                  f"(with the host's enqueue {th[0]:.4f} / {th[1]:.4f}), bound {b_ms:.4f} ms, "
                  f"share {b_ms / min(t):.3f}  [{card}]", flush=True)
    # calibration: one torch copy of the same batch (16.6 MB read, 16.6 MB
    # written, as the k5 Gaussian moves), timed the same way
    t_copy = [timer(lambda: x.clone(), device_only=True) for _ in range(2)]
    b_copy, _ = bound(2 * n1, 0)
    print(f"calibration x.clone() (8,1080,1920,1): {t_copy[0]:.4f} / {t_copy[1]:.4f} ms, "
          f"bound {b_copy:.4f} ms, share {b_copy / min(t_copy):.3f}  [{card}]", flush=True)
    rows.append(dict(kernel="torch clone", consts={}, case="copy", ms=t_copy, bound_ms=b_copy,
                     share=b_copy / min(t_copy)))
    probes = []
    for j, (kernel, _) in enumerate(PROBES):
        lib = libs[len(VARIANTS) + j]
        use(lib, kernel)
        read = ctypes.CDLL(str(lib)).probe_read
        read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        buf = np.zeros((1 << 16, 3), dtype=np.uint64)  # t0, t1, (sm, edge)
        n = ctypes.c_uint(0)
        for name, kw, _, _ in cases[kernel]:
            torch.cuda.synchronize()
            read(buf.ctypes.data, ctypes.byref(n))  # reset
            timer.flush.zero_()
            run(kernel, kw)
            torch.cuda.synchronize()
            read(buf.ctypes.data, ctypes.byref(n))
            rec = buf[:n.value].astype(np.int64)
            t0, t1, edge = rec[:, 0], rec[:, 1], rec[:, 2] >> 32
            base = int(t0.min())
            dur = (t1 - t0) / 1e3
            span = (int(t1.max()) - base) / 1e3
            main, ed = dur[edge == 0], dur[edge == 1]
            late = ((t0 - base) / 1e3)[edge == 0]
            d = dict(kernel=kernel, case=name, warps=int(n.value), span_us=span,
                     main_warp_us=[float(main.mean()), float(main.max())],
                     edge_warp_us=[float(ed.mean()), float(ed.max())] if len(ed) else None,
                     last_main_start_us=float(late.max()),
                     edge_end_us=float(((t1 - base) / 1e3)[edge == 1].max()) if len(ed) else None)
            probes.append(d)
            print(f"probe {kernel} {name}: {n.value} warps, span {span:.2f} us; main warp "
                  f"mean {main.mean():.2f} max {main.max():.2f} us, last main start "
                  f"{late.max():.2f} us; edge warp mean {ed.mean():.2f} max {ed.max():.2f} us, "
                  f"edge end {d['edge_end_us']:.2f} us", flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=card, rows=rows, probes=probes), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
