"""resize (twin of ``opencv_tpu/ops/resize.py``, `cv::resize`).

Coordinate and coefficient tables depend only on shapes, so they are built
on the host in numpy (double precision, the reference's table builders,
copied from the JAX package).  The device work is a direct ``index_select``
gather along H and W plus integer MACs.  The JAX package's phase-plan
gather (strided slices instead of a gather) is a TPU workaround and is not
carried over.

Ported so far:
- INTER_LINEAR u8: Q11 coeffs ``saturate_cast<short>(cbuf*2048)`` and the
  vertical pass ``uchar((((b0*(S0>>4))>>16) + ((b1*(S1>>4))>>16) + 2) >> 2)``
  (VResizeLinearVec_32s8u, resize.cpp:1311), with the reference's linear
  edge resets; also INTER_AREA upscaling, which is this path on area
  coordinates;
- INTER_AREA integer-ratio downscale: exact mean, 2×2 fast path
  ``(a+b+c+d+2)>>2`` (ResizeAreaFastVec, resize.cpp:2920+);
- the 2×2 INTER_LINEAR downscale reroute to fast AREA (resize.cpp:4010);
- INTER_LINEAR_EXACT u8: ufixedpoint16 Q8 weights and one final
  ``(v + 2^15) >> 16`` (resize.cpp:789), the pyramid ORB builds.  Its
  tables depend only on the two sizes; they are built once per
  (source, destination, device) and kept on the device, so a repeated
  resize copies nothing from the host.

Other modes raise ``NotImplementedError`` (ROADMAP.md, queue A3).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import constants as K
from ..core.arrays import to_batched, from_batched
from ..core.fixedpoint import saturate_cast

__all__ = ["resize"]

COEF_BITS = 11
COEF_SCALE = 1 << COEF_BITS  # 2048


# --------------------------------------------------------------------------
# host-side coefficient builders (copies of opencv_tpu/ops/resize.py:87-129)
# --------------------------------------------------------------------------

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


# --------------------------------------------------------------------------
# device helpers
# --------------------------------------------------------------------------

def _gather(x, idx, axis):
    """Gather along `axis` with host indices clipped into range (the fetch
    clamp of the reference's resize invokers)."""
    cidx = np.clip(np.asarray(idx, np.int64), 0, x.shape[axis] - 1)
    return x.index_select(axis, torch.from_numpy(cidx).to(x.device))


def _col_const(v, device):
    """per-output-column int32 constant, broadcast over (N,H,W,C)."""
    return torch.from_numpy(np.asarray(v, np.int32)).to(device).reshape(1, 1, -1, 1)


def _row_const(v, device):
    return torch.from_numpy(np.asarray(v, np.int32)).to(device).reshape(1, -1, 1, 1)


# --------------------------------------------------------------------------
# mode implementations (batched NHWC)
# --------------------------------------------------------------------------

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


# --------------------------------------------------------------------------
# public entry
# --------------------------------------------------------------------------

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
    if interp == K.INTER_LINEAR_EXACT:
        if x.dtype == torch.uint8:
            return from_batched(_resize_linear_exact_u8(x, dw, dh), meta)
        # the JAX package reroutes this to float INTER_LINEAR, not ported yet
        raise NotImplementedError(
            f"resize INTER_LINEAR_EXACT for {x.dtype} is not ported to opencv_tpu_torch yet "
            "(ROADMAP.md, queue A3)")
    scale_x, scale_y = W / dw, H / dh
    iscale_x, iscale_y = int(round(scale_x)), int(round(scale_y))
    is_area_fast = (abs(scale_x - iscale_x) < np.finfo(float).eps
                    and abs(scale_y - iscale_y) < np.finfo(float).eps)

    # 2x2 INTER_LINEAR downscale is silently rerouted to fast AREA
    # (resize.cpp:4010-4012)
    if interp == K.INTER_LINEAR and is_area_fast and iscale_x == 2 and iscale_y == 2:
        interp = K.INTER_AREA

    if interp == K.INTER_AREA:
        if scale_x >= 1 and scale_y >= 1:
            if not is_area_fast:
                raise NotImplementedError(
                    "resize INTER_AREA at a fractional ratio is not ported to "
                    "opencv_tpu_torch yet (ROADMAP.md, queue A3)")
            y = _resize_area_fast(x, iscale_x, iscale_y, x.dtype)
            return from_batched(y, meta)
        # upscale AREA emulated by bilinear with area coords (resize.cpp:4106)
        if x.dtype == torch.uint8:
            return from_batched(_resize_linear_u8(x, dw, dh, area_mode=True), meta)
    elif interp == K.INTER_LINEAR and x.dtype == torch.uint8:
        return from_batched(_resize_linear_u8(x, dw, dh), meta)

    raise NotImplementedError(
        f"resize interpolation {interpolation} for {x.dtype} is not ported to "
        "opencv_tpu_torch yet (ROADMAP.md, queue A3)")
