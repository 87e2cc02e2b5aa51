"""threshold / adaptiveThreshold / thresholdWithMask (twin of
``opencv_tpu/ops/thresh.py``; imgproc/src/thresh.cpp).

Thresholding is elementwise.  OTSU and TRIANGLE take one 256-bin histogram
(``hist.hist_fixed``: one scatter, with an overflow bin for the pixels a
mask leaves out) over the whole input, the batch included, as the JAX
package does (cv2 takes one per image), and pick the threshold on the
input's device, so the host never waits for it.  The Otsu and Triangle math
runs in f64 as ``thresh.cpp`` does, where the JAX package has f32: Triangle
is exact integer arithmetic in int64, and Otsu's between-class variance is
taken from the exact int64 prefix sums of the histogram.
"""

from __future__ import annotations

import math

import torch

from .. import constants as K
from ..core.arrays import as_tensor, from_batched, to_batched, to_device
from ..core.fixedpoint import saturate_cast
from .hist import hist_fixed

__all__ = ["threshold", "adaptiveThreshold", "thresholdWithMask"]

_FLT_EPSILON = 1.1920928955078125e-07


def _otsu_from_hist(hist) -> torch.Tensor:
    """getThreshVal_Otsu_8u: the first i that maximizes q1·q2·(mu1 − mu2)²
    over the bins where min(q1, q2) ≥ FLT_EPSILON and max(q1, q2) ≤
    1 − FLT_EPSILON, else 0; an f64 0-dim tensor."""
    h = hist.to(torch.int64)
    i = torch.arange(256, dtype=torch.int64, device=h.device)
    c1 = torch.cumsum(h, 0)                 # pixels in bins <= i
    s1 = torch.cumsum(i * h, 0)             # their intensity sum
    n, s = c1[-1], s1[-1]
    c2, s2 = n - c1, s - s1
    f = torch.float64
    q1 = c1.to(f) / n.to(f)
    q2 = c2.to(f) / n.to(f)
    mu1 = s1.to(f) / c1.clamp(min=1).to(f)
    mu2 = s2.to(f) / c2.clamp(min=1).to(f)
    valid = (torch.minimum(q1, q2) >= _FLT_EPSILON) & (torch.maximum(q1, q2) <= 1.0 - _FLT_EPSILON)
    sigma = torch.where(valid, q1 * q2 * (mu1 - mu2) ** 2, 0.0)
    best = torch.argmax(sigma)              # the first maximum, as `>` keeps it
    return torch.where(sigma.max() > 0, best, 0).to(f)


def _triangle_from_hist(hist) -> torch.Tensor:
    """getThreshVal_Triangle_8u: maximize a·i + b·h[i] over (left_bound,
    max_ind], with the histogram flipped when the peak sits closer to the
    left bound; int64 arithmetic, exact as the reference's doubles are."""
    h = hist.to(torch.int64)
    idx = torch.arange(256, dtype=torch.int64, device=h.device)
    nz = h > 0
    left = (torch.argmax(nz.to(torch.uint8)) - 1).clamp(min=0)
    right = (255 - torch.argmax(nz.flip(0).to(torch.uint8)) + 1).clamp(max=255)
    peak = torch.argmax(h)
    hmax = h.max()
    flip = (peak - left) < (right - peak)
    hh = torch.where(flip, h.flip(0), h)
    left_b = torch.where(flip, 255 - right, left)
    max_i = torch.where(flip, 255 - peak, peak)
    dist = hmax * idx + (left_b - max_i) * hh
    # the reference keeps thresh = left_bound unless some tempdist > 0
    dist = torch.where((idx > left_b) & (idx <= max_i), dist, -1)
    best = torch.argmax(dist)
    t = torch.where(dist.max() > 0, best, left_b) - 1
    return torch.where(flip, 255 - t, t).to(torch.float64)


def _auto_threshold(x, type: int) -> torch.Tensor:
    if x.dtype != torch.uint8:
        raise ValueError("OTSU/TRIANGLE require 8-bit input")
    hist = hist_fixed(x.to(torch.int32), 256)
    return _otsu_from_hist(hist) if type & K.THRESH_OTSU else _triangle_from_hist(hist)


def _select(gt, ttype: int, x, t, maxv, zero):
    """The five threshold types, given ``gt = x > t``."""
    pick = {K.THRESH_BINARY: (maxv, zero), K.THRESH_BINARY_INV: (zero, maxv),
            K.THRESH_TRUNC: (t, x), K.THRESH_TOZERO: (x, zero),
            K.THRESH_TOZERO_INV: (zero, x)}.get(ttype)
    if pick is None:
        raise ValueError(f"unknown threshold type {ttype}")
    return torch.where(gt, *pick)


def _scalar(v, dtype, device):
    """`v` (a number or a 0-dim tensor) as a 0-dim tensor on `device`,
    without a copy from the host: a blocking copy would wait for the queue."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype)
    return torch.full((), v, dtype=dtype, device=device)


def _apply(x, ttype: int, it, maxval):
    """`x` thresholded at `it` (a number, or a 0-dim tensor on x's device)."""
    dev = x.device
    if not x.is_floating_point():
        info = torch.iinfo(x.dtype)
        imax = _scalar(min(max(round(maxval), info.min), info.max), torch.int32, dev)
        t = _scalar(it, torch.int32, dev)
        xi = x.to(torch.int32)
        y = _select(xi > t, ttype, xi, t, imax, _scalar(0, torch.int32, dev))
        return saturate_cast(y, x.dtype)
    t = _scalar(it, x.dtype, dev)
    return _select(x > t, ttype, x, t, _scalar(maxval, x.dtype, dev), _scalar(0, x.dtype, dev))


def threshold(src, thresh: float, maxval: float, type: int):
    """`cv::threshold` — returns (retval, dst) like cv2.

    With THRESH_OTSU or THRESH_TRIANGLE, retval is the computed threshold
    as an f64 0-dim tensor on the input's device (no host sync; ``float()``
    it for cv2's number); otherwise the caller's value, floored for integer
    images as cv2 returns it."""
    x, meta = to_batched(src)
    ttype = type & K.THRESH_MASK
    if type & (K.THRESH_OTSU | K.THRESH_TRIANGLE):
        tval = _auto_threshold(x, type)
        it = torch.floor(tval) if not x.is_floating_point() else tval
    elif not x.is_floating_point():
        # integer semantics: ithresh = floor(thresh), comparisons strict >
        it = math.floor(thresh)
        tval = float(it)
    else:
        it = tval = thresh
    return tval, from_batched(_apply(x, ttype, it, maxval), meta)


def adaptiveThreshold(src, maxValue: float, adaptiveMethod: int,
                      thresholdType: int, blockSize: int, C: float):
    """`cv::adaptiveThreshold` (thresh.cpp:1590 region)."""
    from .filter import GaussianBlur, boxFilter

    x, meta = to_batched(src)
    if x.dtype != torch.uint8:
        raise ValueError("adaptiveThreshold requires 8-bit input")
    if thresholdType not in (K.THRESH_BINARY, K.THRESH_BINARY_INV):
        raise ValueError("thresholdType must be BINARY or BINARY_INV")
    border = K.BORDER_REPLICATE | K.BORDER_ISOLATED
    if adaptiveMethod == K.ADAPTIVE_THRESH_MEAN_C:
        mean = boxFilter(x, -1, (blockSize, blockSize), borderType=border)
    elif adaptiveMethod == K.ADAPTIVE_THRESH_GAUSSIAN_C:
        # the reference converts to CV_32F, blurs in float, converts back
        mean = saturate_cast(GaussianBlur(x.to(torch.float32), (blockSize, blockSize), 0,
                                          borderType=border), torch.uint8)
    else:
        raise ValueError(f"unknown adaptive method {adaptiveMethod}")
    imaxval = int(min(max(round(maxValue), 0), 255))
    idelta = math.ceil(C) if thresholdType == K.THRESH_BINARY else math.floor(C)
    above = (x.to(torch.int32) - mean.to(torch.int32)) > -idelta
    if thresholdType == K.THRESH_BINARY_INV:
        above = ~above
    return from_batched(torch.where(above, imaxval, 0).to(torch.uint8), meta)


def thresholdWithMask(src, dst, mask, thresh: float, maxval: float, type: int):
    """`cv::thresholdWithMask` (cv2 5.x): `threshold` applied only where
    mask != 0; elsewhere the pixels of `dst` (or of `src`, without one) are
    kept.  OTSU/TRIANGLE statistics are taken over the masked pixels only.
    Everything stays on the input's device; retval is as in `threshold`."""
    x = as_tensor(src)
    if mask is None or as_tensor(mask).numel() == 0:
        return threshold(src, thresh, maxval, type)
    m = to_device(as_tensor(mask), x.device) != 0
    if m.ndim < x.ndim:
        m = m[..., None]
    if type & (K.THRESH_OTSU | K.THRESH_TRIANGLE):
        if x.dtype != torch.uint8:
            raise ValueError("OTSU/TRIANGLE require 8-bit input")
        hist = hist_fixed(torch.where(m, x.to(torch.int32), 256), 256)
        tval = _otsu_from_hist(hist) if type & K.THRESH_OTSU else _triangle_from_hist(hist)
        out = _apply(x, type & K.THRESH_MASK, torch.floor(tval), maxval)
    else:
        tval, out = threshold(x, thresh, maxval, type)
        out = as_tensor(out)
    base = x if dst is None else to_device(as_tensor(dst), x.device)
    return tval, torch.where(m, out, base).to(x.dtype)
