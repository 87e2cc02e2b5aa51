"""Geometric warps: warpAffine, warpPerspective, remap, the polar warps and
the transform builders (twin of ``opencv_tpu/ops/warp.py``).

The source coordinate of output pixel (i, j) is built from per-row and
per-column f64 vectors made on the host exactly as the JAX package makes
them (rank 1 for an affine map; for a perspective map its two numerators
and its denominator).  Here they are added, and the perspective quotient
taken, **in f64 on the device**; the JAX package emulates f64 with
double-float pairs because the TPU has none, so the floor or the Q5
fraction of a coordinate can differ at a cell boundary.  The taps are
plain gathers (the TPU's pre-stacked patch operand is a gather workaround
and is not carried over); borders are resolved on the device in closed
form (the JAX package's host ``border_interpolate`` loop for user maps
included).  After the blend: ``saturate_cast``, then the BORDER_CONSTANT
rule that a window lying wholly outside the image takes the border value
(remapBilinear, imgwarp.cpp:820).

Numeric schemes, as the JAX package has them:
- NEAREST: warpAffine's AB_BITS integer grid, ``adelta[x] =
  saturate_cast<int>(M[0]*x*1024)`` and ``round_delta = 512`` in int32
  with wraparound and arithmetic ``>>`` (imgwarp.cpp:2686); warpPerspective
  rounds the f64 coordinate half to even; remap rounds f32 maps;
- LINEAR: the exact fraction of the map in f32 weights (cv2 5.0's
  floating-point bilinear).  CV_16S and CV_64F images take cv2 5.0's
  fixed-point map instead: the coordinate rounded to 1/32 (for warpAffine
  its two parts in Q10 first), and for CV_64F the blend in f64.  That
  equals cv2 and differs from the JAX package, which takes the exact
  fraction at every depth;
- CUBIC: the exact f32 fraction and separable A = -0.75 weights computed
  per pixel;
- LANCZOS4: the Q5 fraction ``floor(32 v + 0.5)`` and initInterTab2D's
  sum-corrected tables (imgwarp.cpp:216), Q15 integers for u8;
- fixed CV_16SC2 (+ CV_16UC1) remap maps: the Q5 fraction with the Q15
  bilinear tables for u8 (``(v + 16384) >> 15``), f32 weights otherwise.
  remap blends CUBIC and LANCZOS4 bilinearly, as the JAX package does.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import constants as K
from ..core.arrays import as_tensor, to_batched, from_batched, to_device
from ..core.fixedpoint import saturate_cast
from ..core.mathfuncs import fast_atan2
from ..utils.trace import region
from .resize import _interpolate_cubic, _interpolate_lanczos4

__all__ = [
    "warpAffine", "warpPerspective", "remap", "warpPolar", "linearPolar", "logPolar",
    "invertAffineTransform", "getRotationMatrix2D", "getAffineTransform",
    "getPerspectiveTransform", "WARP_POLAR_LINEAR", "WARP_POLAR_LOG",
]

INTER_BITS = 5
INTER_TAB_SIZE = 1 << INTER_BITS          # 32
INTER_TAB_SIZE2 = INTER_TAB_SIZE ** 2     # 1024
REMAP_COEF_BITS = 15
REMAP_COEF_SCALE = 1 << REMAP_COEF_BITS   # 32768
AB_BITS = max(10, INTER_BITS)
AB_SCALE = 1 << AB_BITS                   # 1024

WARP_POLAR_LINEAR = 0
WARP_POLAR_LOG = 256


# --------------------------------------------------------------------------
# transform builders (host, double precision; copies of
# opencv_tpu/ops/warp.py:62-122)
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


def getAffineTransform(src, dst):
    """The 2×3 map of three point pairs (6×6 solve)."""
    src = np.asarray(src, np.float64).reshape(3, 2)
    dst = np.asarray(dst, np.float64).reshape(3, 2)
    A = np.zeros((6, 6))
    b = np.zeros(6)
    for i in range(3):
        A[i * 2, 0:2] = src[i]
        A[i * 2, 2] = 1
        A[i * 2 + 1, 3:5] = src[i]
        A[i * 2 + 1, 5] = 1
        b[i * 2] = dst[i, 0]
        b[i * 2 + 1] = dst[i, 1]
    return np.linalg.solve(A, b).reshape(2, 3)


def getPerspectiveTransform(src, dst, solveMethod: int = K.DECOMP_LU):
    """The 3×3 homography of four point pairs (8×8 solve, M[2,2] = 1)."""
    src = np.asarray(src, np.float64).reshape(4, 2)
    dst = np.asarray(dst, np.float64).reshape(4, 2)
    A = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        A[i, 0:2] = src[i]
        A[i, 2] = 1
        A[i, 6] = -src[i, 0] * dst[i, 0]
        A[i, 7] = -src[i, 1] * dst[i, 0]
        A[i + 4, 3:5] = src[i]
        A[i + 4, 5] = 1
        A[i + 4, 6] = -src[i, 0] * dst[i, 1]
        A[i + 4, 7] = -src[i, 1] * dst[i, 1]
        b[i] = dst[i, 0]
        b[i + 4] = dst[i, 1]
    return np.append(np.linalg.solve(A, b), 1.0).reshape(3, 3)


# --------------------------------------------------------------------------
# interpolation tables (initInterTab2D, imgwarp.cpp:216; a copy of
# opencv_tpu/ops/warp.py:130-178)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _inter_tab(ksize: int):
    """(1024, k*k) float32 and sum-corrected Q15 int32 tables."""
    scale = np.float32(1.0) / INTER_TAB_SIZE
    xs = (np.arange(INTER_TAB_SIZE, dtype=np.float32) * scale)
    if ksize == 2:
        tab1 = np.stack([np.float32(1.0) - xs, xs], axis=1)
    elif ksize == 4:
        tab1 = _interpolate_cubic(xs)
    else:
        # warp lanczos: x < FLT_EPSILON shortcut (imgwarp.cpp:162)
        tab1 = _interpolate_lanczos4(xs)
        tab1[0] = 0.0
        tab1[0, 3] = 1.0
    ftab = np.empty((INTER_TAB_SIZE2, ksize * ksize), np.float32)
    itab = np.empty((INTER_TAB_SIZE2, ksize * ksize), np.int32)
    for i in range(INTER_TAB_SIZE):
        for j in range(INTER_TAB_SIZE):
            v = np.outer(tab1[i], tab1[j]).astype(np.float32)  # vy * vx
            idx = i * INTER_TAB_SIZE + j
            ftab[idx] = v.ravel()
            iv = np.clip(np.rint(v.astype(np.float64) * REMAP_COEF_SCALE),
                         -32768, 32767).astype(np.int32).reshape(ksize, ksize)
            isum = int(iv.sum())
            if isum != REMAP_COEF_SCALE:
                # initInterTab2D's correction, INCLUDING its flat-memory
                # quirk: for ksize=2 the search window (k1,k2 ∈ [k2c, k2c+2))
                # indexes past the 2x2 block — C++ reads zeros from the
                # not-yet-filled next block and writes there are overwritten
                # by the next block's fill.
                diff = isum - REMAP_COEF_SCALE
                k2c = ksize // 2
                kk = ksize * ksize
                flat = np.zeros(max(kk, (k2c + 1) * ksize + k2c + 2), np.int64)
                flat[:kk] = iv.ravel()
                Mo = mo = k2c * ksize + k2c
                for k1 in range(k2c, k2c + 2):
                    for kx in range(k2c, k2c + 2):
                        o = k1 * ksize + kx
                        if flat[o] < flat[mo]:
                            mo = o
                        elif flat[o] > flat[Mo]:
                            Mo = o
                if diff < 0:
                    flat[Mo] -= diff
                else:
                    flat[mo] -= diff
                iv = flat[:kk].reshape(ksize, ksize).astype(np.int32)
            itab[idx] = iv.ravel()
    return ftab, itab


@functools.lru_cache(maxsize=16)
def _inter_tab_dev(ksize: int, q15: bool, device: torch.device):
    """(k*k, 1024) device table of tap weights by Q5 fraction index: the
    Q15 integers if `q15`, else the f32 products."""
    ftab, itab = _inter_tab(ksize)
    return torch.from_numpy(np.ascontiguousarray((itab if q15 else ftab).T)).to(device)


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


class _Taps:
    """The taps of a window of `ksize` per axis whose top-left tap is at
    (x0 - off, y0 - off), off = max(ksize/2 - 1, 0): tap (dy, dx) of every output
    pixel as an (N, dh*dw, C) plane in `acc_dtype`, border-resolved, with
    the border value where the border mode asks for it."""

    def __init__(self, x, x0, y0, ksize, border_type, border_value, acc_dtype):
        N, H, W, C = x.shape
        self.off = max(ksize // 2 - 1, 0)
        self.ksize, self.W, self.H = ksize, W, H
        self.x0, self.y0, self.border_type = x0, y0, border_type
        self.flat = x.reshape(N, H * W, C)
        self.acc_dtype = acc_dtype
        self.cval = to_device(_cval_vec(border_value, x.dtype, C), x.device)
        self.cval_t = self.cval.to(x.dtype).to(acc_dtype).reshape(1, 1, C)
        self.xs = [_resolve_tap(x0 + (d - self.off), W, border_type) for d in range(ksize)]
        self.ys = [_resolve_tap(y0 + (d - self.off), H, border_type) for d in range(ksize)]

    def __call__(self, dy, dx):
        (xi, xm), (yi, ym) = self.xs[dx], self.ys[dy]
        g = self.flat.index_select(1, (yi * self.W + xi).reshape(-1)).to(self.acc_dtype)
        return torch.where((xm | ym).reshape(1, -1, 1), self.cval_t, g)

    def finish(self, out):
        """(N, dh*dw, C) → (N, dh, dw, C); under BORDER_CONSTANT a window
        wholly outside the image takes the border value."""
        dh, dw = self.x0.shape
        out = out.reshape(out.shape[0], dh, dw, out.shape[-1])
        if self.border_type & ~K.BORDER_ISOLATED == K.BORDER_CONSTANT:
            lo, hi = self.off, self.ksize - 1 - self.off
            fully_out = ((self.x0 - lo >= self.W) | (self.x0 + hi < 0)
                         | (self.y0 - lo >= self.H) | (self.y0 + hi < 0))
            out = torch.where(fully_out[None, :, :, None],
                              self.cval.to(out.dtype).reshape(1, 1, 1, -1), out)
        return out


def _remap_nn(x, sx, sy, border_type, border_value):
    """Nearest remap: int64 source planes sx/sy of shape (dh, dw); taps
    outside the image take the border value under BORDER_CONSTANT and
    BORDER_TRANSPARENT."""
    taps = _Taps(x, sx, sy, 1, border_type, border_value, x.dtype)
    N, dh, dw = x.shape[0], *sx.shape
    return taps(0, 0).reshape(N, dh, dw, x.shape[-1])


def _remap_linear(x, x0, fx, y0, fy, border_type, border_value):
    """Bilinear remap: int64 tap planes x0/y0 and f32 fractions fx/fy of
    shape (dh, dw) → (N, dh, dw, C).  The weights are f32 products; the
    blend runs in f64 for an f64 image (as cv2's remapBilinear promotes
    them), in f32 otherwise."""
    acc_dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    taps = _Taps(x, x0, y0, 2, border_type, border_value, acc_dtype)
    fxf = fx.reshape(1, -1, 1)
    fyf = fy.reshape(1, -1, 1)
    wts = [w.to(acc_dtype) for w in
           ((1 - fxf) * (1 - fyf), fxf * (1 - fyf), (1 - fxf) * fyf, fxf * fyf)]
    acc = None
    for t, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        term = taps(dy, dx) * wts[t]
        acc = term if acc is None else acc + term
    return taps.finish(saturate_cast(acc, x.dtype))


def _remap_linear_q5(x, x0, fq, y0, border_type, border_value):
    """Bilinear remap with a Q5 fraction index plane ``fq = fy*32 + fx``
    (fixed-point maps).  u8 takes the Q15 table products ``(32-fx)(32-fy)·32``
    (initInterTab2D's correction never fires at ksize 2) and
    ``(v + 16384) >> 15``; other depths the f32 weights of the fractions."""
    fx = (fq & (INTER_TAB_SIZE - 1))
    fy = (fq >> INTER_BITS) & (INTER_TAB_SIZE - 1)
    if x.dtype != torch.uint8:
        scale = 1.0 / INTER_TAB_SIZE
        return _remap_linear(x, x0, fx.to(torch.float32) * scale, y0,
                             fy.to(torch.float32) * scale, border_type, border_value)
    taps = _Taps(x, x0, y0, 2, border_type, border_value, torch.int32)
    fx = fx.to(torch.int32).reshape(1, -1, 1)
    fy = fy.to(torch.int32).reshape(1, -1, 1)
    wts = ((32 - fx) * (32 - fy) * 32, fx * (32 - fy) * 32, (32 - fx) * fy * 32, fx * fy * 32)
    acc = None
    for t, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        term = taps(dy, dx) * wts[t]
        acc = term if acc is None else acc + term
    out = ((acc + (1 << (REMAP_COEF_BITS - 1))) >> REMAP_COEF_BITS).clamp(0, 255)
    return taps.finish(out.to(torch.uint8))


def _cubic_weights(f):
    """Bicubic weights, A=-0.75, of an f32 fraction plane
    (interpolateCubic, imgwarp.cpp)."""
    A = -0.75
    c0 = ((A * (f + 1) - 5 * A) * (f + 1) + 8 * A) * (f + 1) - 4 * A
    c1 = ((A + 2) * f - (A + 3)) * f * f + 1
    c2 = ((A + 2) * (1 - f) - (A + 3)) * (1 - f) * (1 - f) + 1
    c3 = 1.0 - c0 - c1 - c2
    return [c0, c1, c2, c3]


def _remap_cubic(x, x0, fx, y0, fy, border_type, border_value):
    """Bicubic remap with exact f32 fractions: per row of the window the
    taps weighted by the x weights, then the rows by the y weights, f32
    sums, then ``saturate_cast``."""
    taps = _Taps(x, x0, y0, 4, border_type, border_value, torch.float32)
    wx = [w.reshape(1, -1, 1) for w in _cubic_weights(fx)]
    wy = [w.reshape(1, -1, 1) for w in _cubic_weights(fy)]
    acc = None
    for dy in range(4):
        row = None
        for dx in range(4):
            term = taps(dy, dx) * wx[dx]
            row = term if row is None else row + term
        term = row * wy[dy]
        acc = term if acc is None else acc + term
    return taps.finish(saturate_cast(acc, x.dtype))


def _remap_ktap_q5(x, x0, fqx, y0, fqy, ksize, border_type, border_value):
    """k-tap remap (LANCZOS4, k = 8) with Q5 fractions and initInterTab2D's
    tables: u8 with the sum-corrected Q15 integers and ``(v + 16384) >> 15``,
    other depths with the f32 products.  Each tap gathers its own weight
    column by fraction index, so no (pixels, k*k) plane is held."""
    is_u8 = x.dtype == torch.uint8
    acc_dtype = torch.int32 if is_u8 else torch.float32
    taps = _Taps(x, x0, y0, ksize, border_type, border_value, acc_dtype)
    tab = _inter_tab_dev(ksize, is_u8, x.device)
    fxy = (fqy * INTER_TAB_SIZE + fqx).reshape(-1)
    acc = None
    for dy in range(ksize):
        for dx in range(ksize):
            w = tab[dy * ksize + dx].index_select(0, fxy).reshape(1, -1, 1)
            term = taps(dy, dx) * w
            acc = term if acc is None else acc + term
    if is_u8:
        out = ((acc + (1 << (REMAP_COEF_BITS - 1))) >> REMAP_COEF_BITS).clamp(0, 255)
        return taps.finish(out.to(torch.uint8))
    return taps.finish(saturate_cast(acc, x.dtype))


def _floor_frac(v):
    """floor and fraction of an f64 coordinate plane; the int is clamped
    like the JAX package's (``_floor_frac_dd``) so degenerate maps stay
    in range."""
    f = torch.floor(v)
    return f.clamp(-1e9, 1e9).to(torch.int64), (v - f).to(torch.float32)


def _floor_q5(v):
    """floor and Q5 fraction of an f64 coordinate plane: ``t = floor(32 v +
    0.5)``, then ``t >> 5`` and ``t & 31`` (the JAX package's
    ``_floor_q5_dd``)."""
    t = torch.floor(v * INTER_TAB_SIZE + 0.5).clamp(-1e9, 1e9).to(torch.int64)
    return t >> INTER_BITS, t & (INTER_TAB_SIZE - 1)


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


def _warp_planes(x, interp, mx, my, border_mode, border_value):
    """The remap of an f64 coordinate plane pair for warpAffine (not
    NEAREST) and warpPerspective (not NEAREST): CUBIC, LANCZOS4, else
    LINEAR."""
    if interp == K.INTER_LANCZOS4:
        x0, fqx = _floor_q5(mx)
        y0, fqy = _floor_q5(my)
        return _remap_ktap_q5(x, x0, fqx, y0, fqy, 8, border_mode, border_value)
    x0, fx = _floor_frac(mx)
    y0, fy = _floor_frac(my)
    if interp == K.INTER_CUBIC:
        return _remap_cubic(x, x0, fx, y0, fy, border_mode, border_value)
    return _remap_linear(x, x0, fx, y0, fy, border_mode, border_value)


def _sat_i32(a):
    return np.clip(np.rint(a), -2147483648, 2147483647).astype(np.int64)


# --------------------------------------------------------------------------
# public warps
# --------------------------------------------------------------------------

@region("warpAffine")
def warpAffine(src, M, dsize, flags: int = K.INTER_LINEAR,
               borderMode: int = K.BORDER_CONSTANT, borderValue=0):
    """`cv::warpAffine` (imgwarp.cpp:2788). M is a host 2x3 array."""
    x, meta = to_batched(src)
    dw, dh = int(dsize[0]), int(dsize[1])
    interp = flags & K.INTER_MAX
    M = np.asarray(M, np.float64).reshape(2, 3)
    if not (flags & K.WARP_INVERSE_MAP):
        M = invertAffineTransform(M)
    m = M.ravel()

    xs = np.arange(dw, dtype=np.float64)
    ys = np.arange(dh, dtype=np.float64)

    def dev(v, dtype=None):
        return to_device(v if dtype is None else v.astype(dtype), x.device)

    if interp == K.INTER_NEAREST:
        # per-column adelta and per-row X0 assembled in int32 on the device:
        # the wraparound add and arithmetic >> of the C code
        i32 = np.int32
        rd = AB_SCALE // 2
        X = ((dev(_sat_i32((m[1] * ys + m[2]) * AB_SCALE) + rd, i32)[:, None]
              + dev(_sat_i32(m[0] * xs * AB_SCALE), i32)[None, :]) >> AB_BITS)
        Y = ((dev(_sat_i32((m[4] * ys + m[5]) * AB_SCALE) + rd, i32)[:, None]
              + dev(_sat_i32(m[3] * xs * AB_SCALE), i32)[None, :]) >> AB_BITS)
        y = _remap_nn(x, X.clamp(-32768, 32767).to(torch.int64),
                      Y.clamp(-32768, 32767).to(torch.int64), borderMode, borderValue)
    elif interp not in (K.INTER_CUBIC, K.INTER_LANCZOS4) and x.dtype in (torch.int16,
                                                                          torch.float64):
        # a divergence from opencv_tpu, which takes the exact fraction here
        x0, fx = _q5_floor_frac(m[0] * xs, m[1] * ys + m[2], x.device)
        y0, fy = _q5_floor_frac(m[3] * xs, m[4] * ys + m[5], x.device)
        y = _remap_linear(x, x0, fx, y0, fy, borderMode, borderValue)
    else:
        # rank-1 map decomposition (per-row + per-column f64 vectors, as
        # opencv_tpu/ops/warp.py:925-928), reassembled in real f64
        mx = dev(m[1] * ys + m[2])[:, None] + dev(m[0] * xs)[None, :]
        my = dev(m[4] * ys + m[5])[:, None] + dev(m[3] * xs)[None, :]
        y = _warp_planes(x, interp, mx, my, borderMode, borderValue)
    return from_batched(y, meta)


def _perspective_q5(xn, yn, wd):
    """cv2's fixed-point perspective map for CV_16S and CV_64F images
    (WarpPerspectiveInvoker): ``X = saturate_cast<int>(X0 * 32 / W)`` (0
    where W is 0), then ``X >> 5`` and ``X & 31``."""
    w = torch.where(wd != 0, INTER_TAB_SIZE / torch.where(wd != 0, wd, 1.0), 0.0)

    def q(v):
        t = torch.round((v * w).clamp(-2.0 ** 31, 2.0 ** 31 - 1)).to(torch.int64)
        return t >> INTER_BITS, (t & (INTER_TAB_SIZE - 1)).to(torch.float32) / INTER_TAB_SIZE

    return (*q(xn), *q(yn))


@region("warpPerspective")
def warpPerspective(src, M, dsize, flags: int = K.INTER_LINEAR,
                    borderMode: int = K.BORDER_CONSTANT, borderValue=0):
    """`cv::warpPerspective` (imgwarp.cpp:3370). M is a host 3x3 array."""
    x, meta = to_batched(src)
    dw, dh = int(dsize[0]), int(dsize[1])
    interp = flags & K.INTER_MAX
    M = np.asarray(M, np.float64).reshape(3, 3)
    if not (flags & K.WARP_INVERSE_MAP):
        M = np.linalg.inv(M)
    m = M.ravel()

    xs = np.arange(dw, dtype=np.float64)
    ys = np.arange(dh, dtype=np.float64)

    def plane(col, row):
        """row[:, None] + col[None, :] in f64 on the device."""
        return to_device(row, x.device)[:, None] + to_device(col, x.device)[None, :]

    xn = plane(m[0] * xs, m[1] * ys + m[2])
    yn = plane(m[3] * xs, m[4] * ys + m[5])
    wd = plane(m[6] * xs, m[7] * ys + m[8])
    if interp not in (K.INTER_NEAREST, K.INTER_CUBIC, K.INTER_LANCZOS4) and x.dtype in (
            torch.int16, torch.float64):
        # a divergence from opencv_tpu, which takes the exact fraction here
        x0, fx, y0, fy = _perspective_q5(xn, yn, wd)
        return from_batched(_remap_linear(x, x0, fx, y0, fy, borderMode, borderValue), meta)
    # W == 0 maps to the coordinate 0 (the JAX package's rule)
    w_zero = wd == 0
    wsafe = torch.where(w_zero, 1.0, wd)
    mx = torch.where(w_zero, 0.0, xn / wsafe)
    my = torch.where(w_zero, 0.0, yn / wsafe)
    if interp == K.INTER_NEAREST:
        # saturate_cast<int> of the f64 coordinate: half to even
        def rint16(v):
            return torch.round(v.clamp(-1e9, 1e9)).clamp(-32768, 32767).to(torch.int64)

        y = _remap_nn(x, rint16(mx), rint16(my), borderMode, borderValue)
    else:
        y = _warp_planes(x, interp, mx, my, borderMode, borderValue)
    return from_batched(y, meta)


def remap(src, map1, map2=None, interpolation: int = K.INTER_LINEAR,
          borderMode: int = K.BORDER_CONSTANT, borderValue=0):
    """`cv::remap` with float32 x/y maps (two planes, or one with two
    channels) or fixed CV_16SC2 (+ CV_16UC1) maps (imgwarp.cpp:1713).  The
    maps may be numpy arrays or tensors; they go to the image's device."""
    x, meta = to_batched(src)
    m1 = as_tensor(map1).to(x.device)
    interp = interpolation

    if m1.dtype == torch.int16:  # fixed-point maps CV_16SC2
        sx = m1[..., 0].to(torch.int64)
        sy = m1[..., 1].to(torch.int64)
        if interp == K.INTER_NEAREST:
            return from_batched(_remap_nn(x, sx, sy, borderMode, borderValue), meta)
        fq = (torch.zeros_like(sx) if map2 is None
              else as_tensor(map2).to(x.device).to(torch.int64) & (INTER_TAB_SIZE2 - 1))
        return from_batched(_remap_linear_q5(x, sx, fq, sy, borderMode, borderValue), meta)

    if map2 is not None and m1.ndim == 2 and as_tensor(map2).ndim == 2:
        mapx, mapy = m1, as_tensor(map2).to(x.device)
    else:
        mapx, mapy = m1[..., 0], m1[..., 1]

    if interp == K.INTER_NEAREST:
        def rint(v):  # saturate_cast<int> of the f32 map
            return torch.round(v.to(torch.float32).to(torch.float64)).clamp(
                -2 ** 31, 2 ** 31 - 1).to(torch.int64)

        return from_batched(_remap_nn(x, rint(mapx), rint(mapy), borderMode, borderValue),
                            meta)
    # every other interpolation blends bilinearly, as the JAX package does
    x0, fx = _floor_frac(mapx.to(torch.float64))
    y0, fy = _floor_frac(mapy.to(torch.float64))
    return from_batched(_remap_linear(x, x0, fx, y0, fy, borderMode, borderValue), meta)


def warpPolar(src, dsize, center, maxRadius, flags):
    """cv2.warpPolar (imgwarp.cpp warpPolar) of one image, (H, W) or
    (H, W, C): remap into polar (or semilog) space; WARP_INVERSE_MAP maps
    back.  The maps are built on the image's device from host vectors of
    length dw and dh, and remapped under BORDER_CONSTANT."""
    img = as_tensor(src)
    dev = img.device
    dw, dh = dsize
    if dw <= 0 and dh <= 0:
        dw = int(round(maxRadius))
        dh = int(round(maxRadius * np.pi))
    elif dh <= 0:
        dh = int(round(dw * np.pi))
    semilog = bool(flags & WARP_POLAR_LOG)
    interp = flags & K.INTER_MAX

    if not flags & K.WARP_INVERSE_MAP:
        # the reference precomputes rho scales as float32 (imgwarp.cpp:3757+)
        if semilog:
            kmag = np.log(maxRadius) / dw
            rhos = (np.exp(np.arange(dw) * kmag) - 1.0).astype(np.float32)
        else:
            rhos = (np.arange(dw) * (maxRadius / dw)).astype(np.float32)
        phis = np.arange(dh, dtype=np.float64) * (2 * np.pi / dh)
        mag = torch.from_numpy(rhos.astype(np.float64)).to(dev)[None, :]
        mapx = mag * torch.from_numpy(np.cos(phis)).to(dev)[:, None] + center[0]
        mapy = mag * torch.from_numpy(np.sin(phis)).to(dev)[:, None] + center[1]
        return remap(img, mapx.to(torch.float32), mapy.to(torch.float32), interp,
                     borderMode=K.BORDER_CONSTANT)
    # inverse: the input is the POLAR image; dsize is the output size.
    # wrap one angle row top/bottom like the reference (ANGLE_BORDER)
    ph, pw = img.shape[0], img.shape[1]
    wrapped = torch.cat([img[-1:], img, img[:1]], dim=0)
    f32 = torch.float32
    dx = (torch.arange(dw, dtype=f32, device=dev) - float(np.float32(center[0])))[None, :]
    dy = (torch.arange(dh, dtype=f32, device=dev) - float(np.float32(center[1])))[:, None]
    # cartToPolar: float32 magnitude and the fastAtan2 polynomial, radians.
    # sqrt and log are taken in f64 and rounded to f32, so each is the
    # correctly rounded f32 value (torch's CPU sqrt and log on f32 may go
    # through a vector library that is not)
    f64 = torch.float64
    mag = torch.sqrt((dx * dx + dy * dy).to(f64)).to(f32)
    angle = fast_atan2(dy, dx) * float(np.float32(np.pi / 180))
    if semilog:
        kmag = np.log(maxRadius) / pw
        bufp = torch.log((mag + 1.0).to(f64)).to(f32)
    else:
        kmag = maxRadius / pw
        bufp = mag
    # divide by device scalars: CUDA turns division by a host scalar into a
    # product with its reciprocal, which can round differently
    rho = (bufp.to(f64) / torch.full((), kmag, dtype=f64, device=dev)).to(f32)
    phi = (angle.to(f64) / torch.full((), 2 * np.pi / ph, dtype=f64, device=dev) + 1.0).to(f32)
    return remap(wrapped, rho, phi, interp, borderMode=K.BORDER_CONSTANT)


def linearPolar(src, center, maxRadius, flags):
    """`cv::linearPolar` (imgwarp.cpp:3848) — warpPolar without LOG."""
    img = as_tensor(src)
    return warpPolar(img, (img.shape[1], img.shape[0]), center, maxRadius,
                     flags & ~WARP_POLAR_LOG)


def logPolar(src, center, M, flags):
    """`cv::logPolar` (imgwarp.cpp:3854): maxRadius = exp(w / M)."""
    img = as_tensor(src)
    maxR = np.exp(img.shape[1] / M) if M > 0 else 1.0
    return warpPolar(img, (img.shape[1], img.shape[0]), center, maxR, flags | WARP_POLAR_LOG)
