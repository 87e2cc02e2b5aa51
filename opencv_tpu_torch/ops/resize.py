"""resize (twin of ``opencv_tpu/ops/resize.py``, `cv::resize`).

Coordinate and coefficient tables depend only on shapes, so they are built
on the host in numpy (double precision, the reference's table builders,
copied from the JAX package).  The device work is a direct ``index_select``
gather along H and W plus integer or f32 MACs.  The JAX package's
phase-plan gather (strided slices instead of a gather) is a TPU workaround
and is not carried over.

Every interpolation of the JAX package:
- INTER_NEAREST (``floor(d * src/dst)``) and INTER_NEAREST_EXACT (the Q16
  centre-aligned mapping of resizeNN_bitexact, resize.cpp:1267);
- INTER_LINEAR u8: Q11 coeffs ``saturate_cast<short>(cbuf*2048)`` and the
  vertical pass ``uchar((((b0*(S0>>4))>>16) + ((b1*(S1>>4))>>16) + 2) >> 2)``
  (VResizeLinearVec_32s8u, resize.cpp:1311), with the reference's linear
  edge resets; other depths in f32; INTER_AREA upscaling is this path on
  area coordinates;
- INTER_LINEAR_EXACT u8: ufixedpoint16 Q8 weights and one final
  ``(v + 2^15) >> 16`` (resize.cpp:789), the pyramid ORB builds; other
  depths take the f32 INTER_LINEAR path, as in the JAX package;
- INTER_AREA integer-ratio downscale: exact mean, 2×2 fast path
  ``(a+b+c+d+2)>>2`` (ResizeAreaFastVec, resize.cpp:2920+); at a
  fractional ratio the DecimateAlpha span tables (computeResizeAreaTab,
  resize.cpp:3334) as two dense f32 products, run in IEEE f32 (no TF32);
- the 2×2 INTER_LINEAR downscale reroute to fast AREA (resize.cpp:4010);
- INTER_CUBIC (A = -0.75) and INTER_LANCZOS4: u8 with Q11 taps both ways
  and one ``(v + 2^21) >> 22`` (bit-equal to the JAX package, which
  chose the integer vertical pass over the reference's f32 one), other
  depths in f32.

The tables of LINEAR_EXACT, CUBIC and LANCZOS4 are built once per
(source, destination, device) and kept on the device, so a repeated
resize copies nothing from the host.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import constants as K
from ..core.arrays import to_batched, from_batched
from ..core.fixedpoint import saturate_cast
from ..utils.trace import region

__all__ = ["resize"]

COEF_BITS = 11
COEF_SCALE = 1 << COEF_BITS  # 2048


# --------------------------------------------------------------------------
# host-side coefficient builders (copies of opencv_tpu/ops/resize.py:51-129)
# --------------------------------------------------------------------------

def _interpolate_cubic(x32):
    """float32 bicubic weights, A=-0.75 (resize.cpp:964)."""
    A = np.float32(-0.75)
    x = x32.astype(np.float32)
    c0 = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1) - 4 * A
    c1 = ((A + 2) * x - (A + 3)) * x * x + 1
    c2 = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1
    c3 = np.float32(1.0) - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], axis=1)


def _interpolate_lanczos4(x32):
    """float32 Lanczos4 weights (resize.cpp:974): sin and cos in double,
    each weight stored as float32, the sum and the normalisation in
    float32."""
    s45 = 0.70710678118654752440084436210485
    cs = np.array([[1, 0], [-s45, -s45], [0, 1], [s45, -s45],
                   [-1, 0], [s45, s45], [0, -1], [-s45, s45]])
    out = np.empty((len(x32), 8), np.float32)
    for n, xf in enumerate(x32):
        x = float(np.float32(xf))
        y0 = -(x + 3) * math.pi * 0.25
        s0, c0 = math.sin(y0), math.cos(y0)
        coeffs = np.empty(8, np.float32)
        ssum = np.float32(0)
        for i in range(8):
            y0_ = np.float32(x + 3 - i)
            if abs(y0_) >= 1e-6:
                y = -float(y0_) * math.pi * 0.25
                coeffs[i] = np.float32((cs[i][0] * s0 + cs[i][1] * c0) / (y * y))
            else:
                coeffs[i] = np.float32(1e30)
            ssum = np.float32(ssum + coeffs[i])
        inv = np.float32(1.0) / ssum
        out[n] = coeffs * inv
    return out


def _coords_linear(dst_n: int, src_n: int, scale: float, area_mode: bool,
                   inv_scale: float, edge_reset: bool = True):
    """sx / fx tables for ksize=2 modes.

    ``edge_reset`` applies the reference's X-direction border resets
    (resize.cpp:4112-4124).  The Y direction has NO such resets
    (resize.cpp:4155-4167) — out-of-range rows are clipped at fetch time
    (resizeGeneric_Invoker `clip(sy...)`), which changes the fixed-point
    rounding on edge rows; replicate exactly.
    """
    dxs = np.arange(dst_n)
    if not area_mode:
        fxd = ((dxs + 0.5) * scale - 0.5).astype(np.float32)
        sx = np.floor(fxd).astype(np.int64)
        fx = (fxd - sx).astype(np.float32)
    else:
        sx = np.floor(dxs * scale).astype(np.int64)
        fx = ((dxs + 1) - (sx + 1) * inv_scale).astype(np.float32)
        fx = np.where(fx <= 0, np.float32(0), fx - np.floor(fx))
    if edge_reset:
        neg = sx < 0
        fx[neg] = 0.0
        sx[neg] = 0
        hi = sx >= src_n - 1
        fx[hi] = 0.0
        sx[hi] = src_n - 1
    return sx, fx


def _coords_ksize(dst_n: int, src_n: int):
    """sx / fx tables for cubic (ksize=4) / lanczos4 (ksize=8): no edge
    resets; taps are clamped at gather time (HResizeCubic border loop)."""
    dxs = np.arange(dst_n)
    fxd = ((dxs + 0.5) * (src_n / dst_n) - 0.5).astype(np.float32)
    sx = np.floor(fxd).astype(np.int64)
    fx = (fxd - sx).astype(np.float32)
    return sx, fx


def _q11(c):
    """saturate_cast<short>(c * 2048) with cvRound."""
    return np.clip(np.rint(c.astype(np.float64) * COEF_SCALE),
                   -32768, 32767).astype(np.int64)


def _linear_exact_coeffs(dst_n: int, src_n: int):
    """(offset, Q8 weight of tap + 1) per output index for INTER_LINEAR_EXACT
    (``opencv_tpu/ops/resize.py::_resize_linear_exact_u8``): the double
    coordinate ``scale*(v+0.5)-0.5``, cvRound64 of its fraction times 256,
    and a weight of 0 at the offset 0 or src_n-1 where the coordinate falls
    outside the first or last pair of pixels."""
    scale = src_n / dst_n  # softdouble(1/inv_scale) == double division
    fval = scale * (np.arange(dst_n, dtype=np.float64) + 0.5) - 0.5
    ival = np.floor(fval)
    inner = (ival >= 0) & (ival < src_n - 1) & (src_n > 1)
    hi = (ival >= src_n - 1) & (src_n > 1)
    off = np.where(inner, ival, np.where(hi, src_n - 1, 0)).astype(np.int64)
    c1 = np.where(inner, np.rint((fval - ival) * 256), 0).astype(np.int64)
    return off, c1


@functools.lru_cache(maxsize=64)
def _linear_exact_tables(dst_n: int, src_n: int, device: torch.device):
    """Device tensors (tap 0 index, tap 1 index, weight 0, weight 1) of
    :func:`_linear_exact_coeffs`, the indices clipped into range."""
    off, c1 = _linear_exact_coeffs(dst_n, src_n)
    t = [np.clip(off, 0, src_n - 1), np.clip(off + 1, 0, src_n - 1), 256 - c1, c1]
    return tuple(torch.from_numpy(v.astype(np.int64 if i < 2 else np.int32)).to(device)
                 for i, v in enumerate(t))


@functools.lru_cache(maxsize=64)
def _ksize_tables(dst_n: int, src_n: int, ksize: int, q11: bool, device: torch.device):
    """Device tensors of the cubic (ksize 4) or Lanczos4 (ksize 8) taps:
    (ksize, dst_n) int64 source indices clamped into range, and
    (ksize, dst_n) weights, Q11 int32 if `q11` else f32."""
    sx, fx = _coords_ksize(dst_n, src_n)
    c = (_interpolate_cubic if ksize == 4 else _interpolate_lanczos4)(fx)
    idx = np.clip(sx[None, :] - (ksize // 2 - 1) + np.arange(ksize)[:, None], 0, src_n - 1)
    w = _q11(c).astype(np.int32) if q11 else c
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(np.ascontiguousarray(w.T)).to(device))


def _area_tab(ssize, dsize, scale):
    """computeResizeAreaTab (resize.cpp:3334) as a dense (dsize, ssize)
    float32 matrix."""
    A = np.zeros((dsize, ssize), np.float32)
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1 = math.ceil(fsx1)
        sx2 = math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            A[dx, sx1 - 1] = np.float32((sx1 - fsx1) / cell)
        for sxi in range(sx1, sx2):
            A[dx, sxi] = np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            A[dx, sx2] = np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return A


# --------------------------------------------------------------------------
# device helpers
# --------------------------------------------------------------------------

def _gather(x, idx, axis):
    """Gather along `axis` with host indices clipped into range (the fetch
    clamp of the reference's resize invokers)."""
    cidx = np.clip(np.asarray(idx, np.int64), 0, x.shape[axis] - 1)
    return x.index_select(axis, torch.from_numpy(cidx).to(x.device))


def _col_const(v, device, dtype=np.int32):
    """per-output-column constant, broadcast over (N,H,W,C)."""
    return torch.from_numpy(np.asarray(v, dtype)).to(device).reshape(1, 1, -1, 1)


def _row_const(v, device, dtype=np.int32):
    return torch.from_numpy(np.asarray(v, dtype)).to(device).reshape(1, -1, 1, 1)


# --------------------------------------------------------------------------
# mode implementations (batched NHWC)
# --------------------------------------------------------------------------

def _resize_nn(x, dw, dh):
    N, H, W, C = x.shape
    xo = np.minimum(np.floor(np.arange(dw) * (W / dw)), W - 1).astype(np.int64)
    yo = np.minimum(np.floor(np.arange(dh) * (H / dh)), H - 1).astype(np.int64)
    return _gather(_gather(x, yo, 1), xo, 2)


def _resize_nn_exact(x, dw, dh):
    N, H, W, C = x.shape
    ifx = ((W << 16) + dw // 2) // dw
    ifx0 = ifx // 2 - W % 2
    ify = ((H << 16) + dh // 2) // dh
    ify0 = ify // 2 - H % 2
    xo = np.minimum((ifx * np.arange(dw) + ifx0) >> 16, W - 1)
    yo = np.minimum((ify * np.arange(dh) + ify0) >> 16, H - 1)
    return _gather(_gather(x, yo, 1), xo, 2)


def _resize_linear_u8(x, dw, dh, area_mode=False):
    """Bit-exact u8 INTER_LINEAR (Q11 + the >>4 SSE-compat vertical)."""
    N, H, W, C = x.shape
    sx, fx = _coords_linear(dw, W, W / dw, area_mode, dw / W)
    sy, fy = _coords_linear(dh, H, H / dh, area_mode, dh / H, edge_reset=False)
    ax0 = _q11(np.float32(1.0) - fx)
    ax1 = _q11(fx)
    by0 = _q11(np.float32(1.0) - fy)
    by1 = _q11(fy)

    dev = x.device
    xi = x.to(torch.int32)
    hbuf = (_gather(xi, sx, 2) * _col_const(ax0, dev)
            + _gather(xi, sx + 1, 2) * _col_const(ax1, dev))
    h0 = _gather(hbuf, sy, 1)
    h1 = _gather(hbuf, sy + 1, 1)
    b0 = _row_const(by0, dev)
    b1 = _row_const(by1, dev)
    v = (((b0 * (h0 >> 4)) >> 16) + ((b1 * (h1 >> 4)) >> 16) + 2) >> 2
    return v.clamp(0, 255).to(torch.uint8)


def _resize_linear_float(x, dw, dh, area_mode=False):
    """INTER_LINEAR for every depth but u8: f32 weights and sums, then
    ``saturate_cast`` to the input's depth."""
    N, H, W, C = x.shape
    sx, fx = _coords_linear(dw, W, W / dw, area_mode, dw / W)
    sy, fy = _coords_linear(dh, H, H / dh, area_mode, dh / H, edge_reset=False)
    dev, f32 = x.device, np.float32
    xf = x.to(torch.float32)
    h = (_gather(xf, sx, 2) * _col_const(1.0 - fx, dev, f32)
         + _gather(xf, sx + 1, 2) * _col_const(fx, dev, f32))
    v = (_gather(h, sy, 1) * _row_const(1.0 - fy, dev, f32)
         + _gather(h, sy + 1, 1) * _row_const(fy, dev, f32))
    return saturate_cast(v, x.dtype)


def _resize_linear_exact_u8(x, dw, dh):
    """Bit-exact u8 INTER_LINEAR_EXACT: Q8 × Q8 in int32 (at most 255·2^16),
    rounded once."""
    N, H, W, C = x.shape
    x0, x1, ax0, ax1 = _linear_exact_tables(dw, W, x.device)
    y0, y1, by0, by1 = _linear_exact_tables(dh, H, x.device)
    xi = x.to(torch.int32)
    h = (xi.index_select(2, x0) * ax0.reshape(1, 1, -1, 1)
         + xi.index_select(2, x1) * ax1.reshape(1, 1, -1, 1))
    v = (h.index_select(1, y0) * by0.reshape(1, -1, 1, 1)
         + h.index_select(1, y1) * by1.reshape(1, -1, 1, 1))
    return ((v + (1 << 15)) >> 16).clamp(0, 255).to(torch.uint8)


def _resize_ksize(x, dw, dh, ksize):
    """INTER_CUBIC (ksize 4) and INTER_LANCZOS4 (ksize 8), every depth.

    u8: Q11 taps horizontally with an int32 sum, then the integer Q22
    vertical pass ``(v + 2^21) >> 22`` (FixedPtCast<int,uchar,22>) for both
    kernels.  The worst case |v| for A = -0.75 is 255·2048²·1.375² =
    2.02e9 < 2^31, so int32 holds every partial sum.  Other depths: f32
    end to end, then ``saturate_cast``."""
    N, H, W, C = x.shape
    is_u8 = x.dtype == torch.uint8
    xi, wx = _ksize_tables(dw, W, ksize, is_u8, x.device)
    yi, wy = _ksize_tables(dh, H, ksize, is_u8, x.device)
    src = x.to(torch.int32 if is_u8 else torch.float32)
    h = None
    for j in range(ksize):
        t = src.index_select(2, xi[j]) * wx[j].reshape(1, 1, -1, 1)
        h = t if h is None else h + t
    v = None
    for j in range(ksize):
        t = h.index_select(1, yi[j]) * wy[j].reshape(1, -1, 1, 1)
        v = t if v is None else v + t
    if is_u8:
        return ((v + (1 << 21)) >> 22).clamp(0, 255).to(torch.uint8)
    return saturate_cast(v, x.dtype)


def _resize_area_fast(x, sx, sy, out_dtype):
    """Integer-ratio AREA: exact mean over sx×sy blocks
    (resizeAreaFast_Invoker, resize.cpp:2975).  resize() takes this path
    only when W == sx·dw and H == sy·dh exactly, so every block is whole."""
    is_int = not x.is_floating_point()
    f32 = torch.float32
    adt = torch.int32 if is_int else f32
    a = x[:, 0::sy].to(adt)
    for r in range(1, sy):
        a = a + x[:, r::sy].to(adt)
    ssum = a[:, :, 0::sx]
    for c in range(1, sx):
        ssum = ssum + a[:, :, c::sx]
    if x.dtype == torch.uint8 and sx == 2 and sy == 2:
        return ((ssum + 2) >> 2).to(out_dtype)
    inv = torch.tensor(1.0 / (sx * sy), dtype=f32)
    if is_int:
        return saturate_cast(torch.round(ssum.to(f32) * inv), out_dtype)
    return saturate_cast(ssum * inv, out_dtype)


def _resize_area_frac(x, dw, dh):
    """AREA downscale at a fractional ratio: the span tables as two dense
    f32 products (W → dw, then H → dh), as the JAX package computes them,
    in IEEE f32 on every device."""
    N, H, W, C = x.shape
    ax = torch.from_numpy(_area_tab(W, dw, W / dw)).to(x.device)
    ay = torch.from_numpy(_area_tab(H, dh, H / dh)).to(x.device)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")  # no TF32 on the card
    try:
        h = torch.einsum("nhwc,dw->nhdc", x.to(torch.float32), ax)
        v = torch.einsum("nhdc,eh->nedc", h, ay)
    finally:
        torch.set_float32_matmul_precision(prev)
    return saturate_cast(v, x.dtype)


# --------------------------------------------------------------------------
# public entry
# --------------------------------------------------------------------------

@region("resize")
def resize(src, dsize, fx: float = 0.0, fy: float = 0.0,
           interpolation: int = K.INTER_LINEAR):
    """cv2-compatible resize. ``dsize`` is (width, height) or None."""
    x, meta = to_batched(src)
    N, H, W, C = x.shape
    if dsize is None or dsize == (0, 0) or dsize == 0:
        if fx <= 0 or fy <= 0:
            raise ValueError("dsize or fx/fy required")
        dw = int(np.rint(W * fx))
        dh = int(np.rint(H * fy))
    else:
        dw, dh = int(dsize[0]), int(dsize[1])
        if dw == 0 or dh == 0:
            raise ValueError("empty dsize")
    if dw == W and dh == H:
        return from_batched(x, meta)

    interp = interpolation
    is_u8 = x.dtype == torch.uint8
    if interp == K.INTER_NEAREST:
        return from_batched(_resize_nn(x, dw, dh), meta)
    if interp == K.INTER_NEAREST_EXACT:
        return from_batched(_resize_nn_exact(x, dw, dh), meta)
    if interp == K.INTER_LINEAR_EXACT:
        if is_u8:
            return from_batched(_resize_linear_exact_u8(x, dw, dh), meta)
        interp = K.INTER_LINEAR  # other depths: the f32 path, as the JAX package
    if interp in (K.INTER_CUBIC, K.INTER_LANCZOS4):
        return from_batched(_resize_ksize(x, dw, dh, 4 if interp == K.INTER_CUBIC else 8), meta)
    if interp not in (K.INTER_LINEAR, K.INTER_AREA):
        raise ValueError(f"unknown interpolation {interpolation}")

    scale_x, scale_y = W / dw, H / dh
    iscale_x, iscale_y = int(round(scale_x)), int(round(scale_y))
    is_area_fast = (abs(scale_x - iscale_x) < np.finfo(float).eps
                    and abs(scale_y - iscale_y) < np.finfo(float).eps)

    # 2x2 INTER_LINEAR downscale is silently rerouted to fast AREA
    # (resize.cpp:4010-4012)
    if interp == K.INTER_LINEAR and is_area_fast and iscale_x == 2 and iscale_y == 2:
        interp = K.INTER_AREA

    area_mode = interp == K.INTER_AREA
    if area_mode and scale_x >= 1 and scale_y >= 1:
        if is_area_fast:
            return from_batched(_resize_area_fast(x, iscale_x, iscale_y, x.dtype), meta)
        return from_batched(_resize_area_frac(x, dw, dh), meta)
    # INTER_LINEAR, and upscale AREA emulated by bilinear with area coords
    # (resize.cpp:4106)
    if is_u8:
        return from_batched(_resize_linear_u8(x, dw, dh, area_mode), meta)
    return from_batched(_resize_linear_float(x, dw, dh, area_mode), meta)
