"""Derivative filters: Sobel / Scharr / Laplacian / getDerivKernels /
spatialGradient (imgproc/src/deriv.cpp), twin of
``opencv_tpu/ops/deriv.py``.

Kernels are generated on the host exactly as `getSobelKernels`
(deriv.cpp:197): Pascal-triangle smoothing plus finite-difference steps;
integer kernels route through sepFilter2D's bit-exact int32 path (the
``sep_filter_int`` kernel on the card), so u8→16S Sobel is bit-exact with
the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as K
from ..core.arrays import to_batched, from_batched
from ..core.fixedpoint import saturate_cast
from .filter import _float_dtype, _resolve_ddepth, _sep_correlate_float, filter2D, sepFilter2D
from ..kernels.sepfilter import sep_correlate_int

__all__ = ["getDerivKernels", "Sobel", "Scharr", "Laplacian", "spatialGradient"]


# copy of opencv_tpu/ops/deriv.py::_sobel_1d
def _sobel_1d(order: int, ksize: int) -> np.ndarray:
    """Integer Sobel kernel via the reference's iterative construction."""
    if ksize == 1:
        return np.array([1], np.int64)
    if ksize == 3:
        return np.array({0: [1, 2, 1], 1: [-1, 0, 1], 2: [1, -2, 1]}[order], np.int64)
    ker = np.zeros(ksize + 1, np.int64)
    ker[0] = 1
    for _ in range(ksize - order - 1):
        oldval = ker[0]
        for j in range(1, ksize + 1):
            newval = ker[j] + ker[j - 1]
            ker[j - 1] = oldval
            oldval = newval
    for _ in range(order):
        oldval = -ker[0]
        for j in range(1, ksize + 1):
            newval = ker[j - 1] - ker[j]
            ker[j - 1] = oldval
            oldval = newval
    return ker[:ksize]


# copy of opencv_tpu/ops/deriv.py::getDerivKernels
def getDerivKernels(dx: int, dy: int, ksize: int, normalize: bool = False,
                    ktype=np.float32):
    """Host twin of `cv::getDerivKernels` (deriv.cpp:166); returns
    (kx, ky) as (n,1) numpy arrays."""
    if ksize <= 0:  # FILTER_SCHARR
        if not (dx >= 0 and dy >= 0 and dx + dy == 1):
            raise ValueError("Scharr kernels need dx + dy == 1")
        out = []
        for order in (dx, dy):
            k = np.array([3, 10, 3] if order == 0 else [-1, 0, 1], np.float64)
            if normalize and order == 0:
                k = k / 32.0
            out.append(k)
        kx, ky = out
    else:
        ksx = 3 if (ksize == 1 and dx > 0) else ksize
        ksy = 3 if (ksize == 1 and dy > 0) else ksize
        kx = _sobel_1d(dx, ksx).astype(np.float64)
        ky = _sobel_1d(dy, ksy).astype(np.float64)
        if normalize:
            # per-kernel scale 1/2^(ksize-order-1) (getSobelKernels tail)
            kx = kx * (1.0 / (1 << (ksx - dx - 1)))
            ky = ky * (1.0 / (1 << (ksy - dy - 1)))
    dt = np.float32 if ktype in (np.float32, K.CV_32F) else np.float64
    return kx.astype(dt).reshape(-1, 1), ky.astype(dt).reshape(-1, 1)


def Sobel(src, ddepth, dx: int, dy: int, ksize: int = 3, scale: float = 1.0,
          delta: float = 0.0, borderType: int = K.BORDER_DEFAULT):
    """`cv::Sobel` (deriv.cpp:414) — getDerivKernels → sepFilter2D."""
    ksx = 3 if (ksize == 1 and dx > 0) else ksize
    ksy = 3 if (ksize == 1 and dy > 0) else ksize
    if ksize <= 0:
        kx = np.array([3, 10, 3] if dx == 0 else [-1, 0, 1], np.float64)
        ky = np.array([3, 10, 3] if dy == 0 else [-1, 0, 1], np.float64)
    else:
        kx = _sobel_1d(dx, ksx).astype(np.float64)
        ky = _sobel_1d(dy, ksy).astype(np.float64)
    if scale != 1.0:
        # reference multiplies scale into one of the kernels (deriv.cpp:437)
        if dx == 0:
            kx = kx * scale
        else:
            ky = ky * scale
    return sepFilter2D(src, ddepth, kx, ky, delta=delta, borderType=borderType)


def Scharr(src, ddepth, dx: int, dy: int, scale: float = 1.0,
           delta: float = 0.0, borderType: int = K.BORDER_DEFAULT):
    return Sobel(src, ddepth, dx, dy, ksize=-1, scale=scale, delta=delta,
                 borderType=borderType)


def Laplacian(src, ddepth, ksize: int = 1, scale: float = 1.0,
              delta: float = 0.0, borderType: int = K.BORDER_DEFAULT):
    """`cv::Laplacian` (deriv.cpp:758): ksize<=1 uses the fixed 3x3 kernel
    [0 1 0; 1 -4 1; 0 1 0] through filter2D; larger ksize sums the two
    2nd-derivative separable passes, exactly in int32 for u8 → u8/16S."""
    x, meta = to_batched(src)
    out_dtype = _resolve_ddepth(x.dtype, ddepth)
    if ksize <= 1:
        kern = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], np.float64) * scale
        return filter2D(src, ddepth, kern, delta=delta, borderType=borderType)
    kx2 = _sobel_1d(2, ksize).astype(np.float64)
    k0 = _sobel_1d(0, ksize).astype(np.float64)
    if (x.dtype == torch.uint8 and out_dtype in (torch.int16, torch.uint8)
            and scale == 1.0 and delta == int(delta)):
        acc1 = sep_correlate_int(x, (kx2 * 256).astype(np.int64), (k0 * 256).astype(np.int64),
                                 borderType)
        acc2 = sep_correlate_int(x, (k0 * 256).astype(np.int64), (kx2 * 256).astype(np.int64),
                                 borderType)
        out = ((acc1 + (1 << 15)) >> 16) + ((acc2 + (1 << 15)) >> 16) + int(delta)
        return from_batched(saturate_cast(out, out_dtype), meta)
    work = _float_dtype(x.dtype, out_dtype)
    a1 = _sep_correlate_float(x, kx2 * scale, k0, borderType, dtype=work)
    a2 = _sep_correlate_float(x, k0 * scale, kx2, borderType, dtype=work)
    y = saturate_cast(a1 + a2 + torch.tensor(delta, dtype=work), out_dtype)
    return from_batched(y, meta)


def spatialGradient(src, ksize: int = 3, borderType: int = K.BORDER_DEFAULT):
    """`cv::spatialGradient` — Sobel dx and dy in one call (u8 → 16S)."""
    dx = Sobel(src, K.CV_16S, 1, 0, ksize, borderType=borderType)
    dy = Sobel(src, K.CV_16S, 0, 1, ksize, borderType=borderType)
    return dx, dy
