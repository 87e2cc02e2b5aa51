"""warpAffine and its transform builders (twin of ``opencv_tpu/ops/warp.py``).

The source coordinate of output pixel (i, j) is rank-1: a per-row f64
vector plus a per-column f64 vector, built on the host exactly as the JAX
package builds them.  Here they are added **in f64 on the device**; the JAX
package emulates f64 with double-float pairs because the TPU has none.
Then ``x0 = floor``, the fraction goes to f32, and the four bilinear taps
are plain gathers blended with the same f32 expression, in the same order,
as ``_remap_linear_dev`` (the TPU's pre-stacked patch operand is a gather
workaround and is not carried over).  After the blend: ``saturate_cast``,
then the BORDER_CONSTANT rule that a window lying wholly outside the image
takes the border value (remapBilinear, imgwarp.cpp:820).

CV_16S and CV_64F images take cv2 5.0's fixed-point map instead: the
coordinate in Q10, the fraction rounded to 1/32, and for CV_64F the blend
in f64.  That equals cv2 and differs from the JAX package, which takes the
exact fraction at every depth.

Ported so far: INTER_LINEAR with all five border modes and any
borderValue (with and without WARP_INVERSE_MAP).  Other interpolations,
warpPerspective and remap raise or are absent (ROADMAP.md, queue A5).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import constants as K
from ..core.arrays import to_batched, from_batched
from ..core.fixedpoint import saturate_cast

__all__ = ["warpAffine", "invertAffineTransform", "getRotationMatrix2D"]


# --------------------------------------------------------------------------
# transform builders (host, double precision; copies of
# opencv_tpu/ops/warp.py:62-84)
# --------------------------------------------------------------------------

def invertAffineTransform(M):
    """`cv::invertAffineTransform` (imgwarp.cpp)."""
    M = np.asarray(M, np.float64).reshape(2, 3)
    D = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]
    D = 1.0 / D if D != 0 else 0.0
    A11 = M[1, 1] * D
    A22 = M[0, 0] * D
    A12 = -M[0, 1] * D
    A21 = -M[1, 0] * D
    b1 = -A11 * M[0, 2] - A12 * M[1, 2]
    b2 = -A21 * M[0, 2] - A22 * M[1, 2]
    return np.array([[A11, A12, b1], [A21, A22, b2]], np.float64)


def getRotationMatrix2D(center, angle, scale):
    angle = angle * math.pi / 180.0
    a = scale * math.cos(angle)
    b = scale * math.sin(angle)
    cx, cy = float(center[0]), float(center[1])
    return np.array([
        [a, b, (1 - a) * cx - b * cy],
        [-b, a, b * cx + (1 - a) * cy],
    ], np.float64)


# --------------------------------------------------------------------------
# device remap core
# --------------------------------------------------------------------------

def _resolve_tap(coord, length, border_type):
    """Device borderInterpolate (copy.cpp:748), closed form.
    Returns (idx in [0, length), use_cval bool)."""
    bt = border_type & ~K.BORDER_ISOLATED
    L = length
    outside = (coord < 0) | (coord >= L)
    never = torch.zeros_like(outside)
    if bt == K.BORDER_REPLICATE:
        return coord.clamp(0, L - 1), never
    if bt in (K.BORDER_CONSTANT, K.BORDER_TRANSPARENT):
        return coord.clamp(0, L - 1), outside
    if bt == K.BORDER_WRAP:
        return torch.remainder(coord, L), never
    if L == 1:
        return torch.zeros_like(coord), never
    if bt == K.BORDER_REFLECT:        # period 2L: ...210|012...L-1|L-1...
        q = torch.remainder(coord, 2 * L)
        return torch.where(q < L, q, 2 * L - 1 - q), never
    if bt == K.BORDER_REFLECT_101:    # period 2L-2
        q = torch.remainder(coord, 2 * L - 2)
        return torch.where(q < L, q, 2 * L - 2 - q), never
    raise ValueError(f"unsupported border type {border_type}")


def _cval_vec(border_value, dtype, C):
    """cv::Scalar border value as f64 per channel: a scalar fills channel 0
    only, like cv2; integer images round and clip it (warp.py:_cval_vec)."""
    bval = np.zeros(4, np.float64)
    bv = (np.asarray(border_value, np.float64).reshape(-1)
          if border_value is not None else np.zeros(1))
    bval[:min(4, bv.size)] = bv[:4]
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        bval = np.clip(np.rint(bval), info.min, info.max)
    return torch.from_numpy(bval[[k & 3 for k in range(C)]])


def _remap_linear(x, x0, fx, y0, fy, border_type, border_value):
    """Bilinear remap: int64 tap planes x0/y0 and f32 fractions fx/fy of
    shape (dh, dw) → (N, dh, dw, C).  The weights are f32 products; the
    blend runs in f64 for an f64 image (as cv2's remapBilinear promotes
    them), in f32 otherwise."""
    N, H, W, C = x.shape
    dh, dw = x0.shape
    acc_dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    cval = _cval_vec(border_value, x.dtype, C).to(x.device)
    cval_t = cval.to(x.dtype).to(acc_dtype).reshape(1, 1, C)
    flat = x.reshape(N, H * W, C)

    fxf = fx.reshape(1, -1, 1)
    fyf = fy.reshape(1, -1, 1)
    wts = [w.to(acc_dtype) for w in
           ((1 - fxf) * (1 - fyf), fxf * (1 - fyf), (1 - fxf) * fyf, fxf * fyf)]
    acc = None
    for t, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        xi, xm = _resolve_tap(x0 + dx, W, border_type)
        yi, ym = _resolve_tap(y0 + dy, H, border_type)
        g = flat.index_select(1, (yi * W + xi).reshape(-1)).to(acc_dtype)
        g = torch.where((xm | ym).reshape(1, -1, 1), cval_t, g)
        term = g * wts[t]
        acc = term if acc is None else acc + term

    out = saturate_cast(acc, x.dtype).reshape(N, dh, dw, C)
    if border_type & ~K.BORDER_ISOLATED == K.BORDER_CONSTANT:
        fully_out = (x0 >= W) | (x0 + 1 < 0) | (y0 >= H) | (y0 + 1 < 0)
        out = torch.where(fully_out[None, :, :, None],
                          cval.to(x.dtype).reshape(1, 1, 1, C), out)
    return out


def _floor_frac(v):
    """floor and fraction of an f64 coordinate plane; the int is clamped
    like the JAX package's (``_floor_frac_dd``) so degenerate maps stay
    in range."""
    f = torch.floor(v)
    return f.clamp(-1e9, 1e9).to(torch.int64), (v - f).to(torch.float32)


# cv2's fixed-point map (imgwarp.cpp, WarpAffineInvoker): AB_BITS of the
# coordinate, then INTER_BITS of the fraction
AB_BITS, INTER_BITS = 10, 5


def _q5_floor_frac(col, row, device):
    """floor and Q5 fraction of the map ``row[:, None] + col[None, :]`` as
    cv2 5.0 takes it for CV_16S and CV_64F images: each part rounded to
    Q10 (``saturate_cast<int>``), their sum plus half a Q5 step shifted to
    Q5 (``X = (X0 + adelta[x]) >> (AB_BITS - INTER_BITS)``).  The other
    depths take the exact fraction (:func:`_floor_frac`), as cv2 5.0's
    warp kernels for 8U, 16U and 32F do."""
    def q10(v):
        v = np.clip(np.rint(v * (1 << AB_BITS)), -2 ** 31, 2 ** 31 - 1).astype(np.int64)
        return torch.from_numpy(v).to(device)

    half = 1 << (AB_BITS - INTER_BITS - 1)
    q = (q10(row)[:, None] + half + q10(col)[None, :]) >> (AB_BITS - INTER_BITS)
    frac = (q & ((1 << INTER_BITS) - 1)).to(torch.float32) / (1 << INTER_BITS)
    return q >> INTER_BITS, frac


def warpAffine(src, M, dsize, flags: int = K.INTER_LINEAR,
               borderMode: int = K.BORDER_CONSTANT, borderValue=0):
    """`cv::warpAffine` (imgwarp.cpp:2788). M is a host 2x3 array."""
    x, meta = to_batched(src)
    dw, dh = int(dsize[0]), int(dsize[1])
    interp = flags & K.INTER_MAX
    if interp != K.INTER_LINEAR:
        raise NotImplementedError(
            f"warpAffine interpolation {interp} is not ported to opencv_tpu_torch "
            "yet (ROADMAP.md, queue A5)")
    M = np.asarray(M, np.float64).reshape(2, 3)
    if not (flags & K.WARP_INVERSE_MAP):
        M = invertAffineTransform(M)
    m = M.ravel()

    xs = np.arange(dw, dtype=np.float64)
    ys = np.arange(dh, dtype=np.float64)

    def dev(v):
        return torch.from_numpy(v).to(x.device)

    if x.dtype in (torch.int16, torch.float64):
        # a divergence from opencv_tpu, which takes the exact fraction here
        x0, fx = _q5_floor_frac(m[0] * xs, m[1] * ys + m[2], x.device)
        y0, fy = _q5_floor_frac(m[3] * xs, m[4] * ys + m[5], x.device)
    else:
        # rank-1 map decomposition (per-row + per-column f64 vectors, as
        # opencv_tpu/ops/warp.py:925-928), reassembled in real f64
        x0, fx = _floor_frac(dev(m[1] * ys + m[2])[:, None] + dev(m[0] * xs)[None, :])
        y0, fy = _floor_frac(dev(m[4] * ys + m[5])[:, None] + dev(m[3] * xs)[None, :])
    y = _remap_linear(x, x0, fx, y0, fy, borderMode, borderValue)
    return from_batched(y, meta)
