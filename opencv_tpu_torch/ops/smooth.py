"""medianBlur / bilateralFilter / stackBlur (twin of
``opencv_tpu/ops/smooth.py``; imgproc/src/median_blur.simd.hpp,
bilateral_filter.simd.hpp, stackblur.cpp).

medianBlur runs a min/max selection network over the k² window taps:
Batcher's odd-even merge sort on k² wires, pruned to the comparators the
middle output depends on (24 for k = 3, 113 for k = 5), each a
``torch.minimum``/``torch.maximum`` of whole planes.  That is cv2's own form
for k = 3 and 5; the JAX package sorts the stacked taps, whose int64
indices alone would take 3.3 GB at (8, 1080, 1920, 1) with k = 5.
bilateralFilter accumulates the disk's taps in f32 in the JAX package's
order.  stackBlur is held to ``opencv_tpu`` bit for bit (its reference test
against cv2 is red); its big-kernel row recurrence, which the JAX package
runs on the host in numpy, runs here on the input's device.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import constants as K
from ..core.arrays import from_batched, to_batched, to_device
from ..core.borders import pad_nhwc
from ..core.fixedpoint import saturate_cast

__all__ = ["medianBlur", "bilateralFilter", "stackBlur"]


def _batcher_pairs(n: int) -> list:
    """The comparators (i, j), i < j, of Batcher's odd-even merge sort on n
    wires, for any n (Knuth, TAOCP 5.3.4, exercise 32's iterative form)."""
    pairs = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return pairs


@functools.lru_cache(maxsize=None)
def median_network(n: int) -> tuple:
    """The comparators of a network that leaves the median of n values on
    wire n // 2: Batcher's sort on n wires, pruned backwards from that wire.
    Each entry is (i, j, need_min, need_max): wire i takes min(w_i, w_j) if
    need_min, wire j takes max(w_i, w_j) if need_max."""
    live = {n // 2}
    keep = []
    for i, j in reversed(_batcher_pairs(n)):
        lo, hi = i in live, j in live
        if lo or hi:
            keep.append((i, j, lo, hi))
            live |= {i, j}
    return tuple(reversed(keep))


def _replicate_pad(x, r: int):
    """x padded by r on each side of H and W with BORDER_REPLICATE, the
    clamped indices made on x's device."""
    N, H, W, C = x.shape
    rows = torch.arange(-r, H + r, device=x.device).clamp(0, H - 1)
    cols = torch.arange(-r, W + r, device=x.device).clamp(0, W - 1)
    return x.index_select(1, rows).index_select(2, cols)


def medianBlur(src, ksize: int):
    """`cv::medianBlur` — BORDER_REPLICATE semantics (median_blur.dispatch),
    through :func:`median_network` over the k² shifted planes."""
    x, meta = to_batched(src)
    k = int(ksize)
    if k % 2 != 1 or k < 3:
        raise ValueError("medianBlur needs an odd ksize > 1")
    r = k // 2
    N, H, W, C = x.shape
    # torch has no min/max for uint16: take those in int32
    xp = _replicate_pad(x.to(torch.int32) if x.dtype == torch.uint16 else x, r)
    wires = [xp[:, j:j + H, i:i + W, :] for j in range(k) for i in range(k)]
    for i, j, need_min, need_max in median_network(k * k):
        a, b = wires[i], wires[j]
        wires[i] = torch.minimum(a, b) if need_min else None
        wires[j] = torch.maximum(a, b) if need_max else None
    return from_batched(wires[(k * k) // 2].to(x.dtype), meta)


def bilateralFilter(src, d: int, sigmaColor: float, sigmaSpace: float,
                    borderType: int = K.BORDER_DEFAULT):
    """`cv::bilateralFilter` (bilateral_filter.dispatch.cpp): f32 taps over
    the disk of radius d // 2 (or 1.5 sigmaSpace), space weight
    exp(r² · gauss_space), colour weight a table of exp(c² · gauss_color)
    over the channel sum of |diff| for u8 and exp of it otherwise; vsum and
    wsum accumulate in the JAX package's order, one op at a time."""
    x, meta = to_batched(src)
    N, H, W, C = x.shape
    if sigmaColor <= 0:
        sigmaColor = 1.0
    if sigmaSpace <= 0:
        sigmaSpace = 1.0
    gauss_color = -0.5 / (sigmaColor * sigmaColor)
    gauss_space = -0.5 / (sigmaSpace * sigmaSpace)
    radius = int(np.rint(sigmaSpace * 1.5)) if d <= 0 else d // 2
    radius = max(radius, 1)

    xf = pad_nhwc(x, radius, radius, radius, radius, borderType).to(torch.float32)
    center = xf[:, radius:radius + H, radius:radius + W, :]
    # offsets within the disk, as the reference builds its space table
    offs = []
    for j in range(-radius, radius + 1):
        for i in range(-radius, radius + 1):
            rr = math.sqrt(i * i + j * j)
            if rr <= radius:
                offs.append((j, i, float(np.float32(math.exp(rr * rr * gauss_space)))))

    is_u8 = x.dtype == torch.uint8
    if is_u8:
        lut = to_device(np.exp(np.arange(256 * C) ** 2 * gauss_color).astype(np.float32),
                        x.device)
    wsum = vsum = None
    for j, i, sw in offs:
        v = xf[:, radius + j:radius + j + H, radius + i:radius + i + W, :]
        cdiff = (v - center).abs()
        if C > 1:
            cdiff = cdiff.sum(dim=-1, keepdim=True)
        if is_u8:
            w = lut.index_select(0, cdiff.to(torch.int32).reshape(-1)).reshape(cdiff.shape) * sw
        else:
            w = torch.exp(cdiff * cdiff * float(np.float32(gauss_color))) * sw
        vsum = v * w if vsum is None else vsum + v * w
        wsum = w if wsum is None else wsum + w
    out = vsum / wsum
    return from_batched(saturate_cast(out, x.dtype) if is_u8 else out.to(x.dtype), meta)


# stackBlur's per-radius (multiplier, shift) quantization of 1/(r+1)^2
# — normative public constants (stackblur.cpp:49-87, Klingemann tables);
# copy of opencv_tpu.ops.smooth's
_STACKBLUR_MUL = np.array([
    512, 512, 456, 512, 328, 456, 335, 512, 405, 328, 271, 456, 388, 335,
    292, 512, 454, 405, 364, 328, 298, 271, 496, 456, 420, 388, 360, 335,
    312, 292, 273, 512, 482, 454, 428, 405, 383, 364, 345, 328, 312, 298,
    284, 271, 259, 496, 475, 456, 437, 420, 404, 388, 374, 360, 347, 335,
    323, 312, 302, 292, 282, 273, 265, 512, 497, 482, 468, 454, 441, 428,
    417, 405, 394, 383, 373, 364, 354, 345, 337, 328, 320, 312, 305, 298,
    291, 284, 278, 271, 265, 259, 507, 496, 485, 475, 465, 456, 446, 437,
    428, 420, 412, 404, 396, 388, 381, 374, 367, 360, 354, 347, 341, 335,
    329, 323, 318, 312, 307, 302, 297, 292, 287, 282, 278, 273, 269, 265,
    261, 512, 505, 497, 489, 482, 475, 468, 461, 454, 447, 441, 435, 428,
    422, 417, 411, 405, 399, 394, 389, 383, 378, 373, 368, 364, 359, 354,
    350, 345, 341, 337, 332, 328, 324, 320, 316, 312, 309, 305, 301, 298,
    294, 291, 287, 284, 281, 278, 274, 271, 268, 265, 262, 259, 257, 507,
    501, 496, 491, 485, 480, 475, 470, 465, 460, 456, 451, 446, 442, 437,
    433, 428, 424, 420, 416, 412, 408, 404, 400, 396, 392, 388, 385, 381,
    377, 374, 370, 367, 363, 360, 357, 354, 350, 347, 344, 341, 338, 335,
    332, 329, 326, 323, 320, 318, 315, 312, 310, 307, 304, 302, 299, 297,
    294, 292, 289, 287, 285, 282, 280, 278, 275, 273, 271, 269, 267, 265,
    263, 261, 259], np.int64)
_STACKBLUR_SHR = np.array(
    [9, 11, 12, 13, 13, 14, 14, 15, 15, 15, 15, 16, 16, 16, 16] +
    [17] * 7 + [18] * 9 + [19] * 14 + [20] * 18 + [21] * 27 +
    [22] * 48 + [23] * 75 + [24] * 100, np.int64)


def _stackblur_sums(arr, k: int, axis: int):
    """Replicate-border triangular window sums (int32) along `axis` (1 or 2);
    the input is truncated to int32 first, as the JAX package does."""
    r = k // 2
    tri = np.minimum(np.arange(1, k + 1), np.arange(k, 0, -1))
    n = arr.shape[axis]
    idx = torch.arange(-r, n + r, device=arr.device).clamp(0, n - 1)
    p = arr.index_select(axis, idx).to(torch.int32)
    total = None
    for i, w in enumerate(tri):
        t = p.narrow(axis, i, n) * int(w)
        total = t if total is None else total + t
    return total


def _simd16_end(i0: int, end: int) -> int:
    """Extent covered by a 16-lane stride loop `for(i=i0; i<=end-16;
    i+=16)` — the reference wheel's universal intrinsics are 128-bit."""
    if end - 16 < i0:
        return i0
    return i0 + ((end - 16 - i0) // 16 + 1) * 16


def _stackblur_row_big(s, radius: int):
    """The big-kernel row recurrence (stackblur.cpp:560-677) as prefix sums
    on s's device: sliding-stack diffs whose right tail advances only while
    `dist >= r`, the source's quirk.  s: (R, W, C) int64; returns the
    integer window sums (the twin of opencv_tpu's numpy version)."""
    R, W, C = s.shape
    wm = W - 1
    cols = []                                    # the columns of D, in order
    for i in range(radius):
        cols.append(s[:, min(i + 1, wm)] - s[:, 0])
    mcount = W - radius - 1
    mid = s[:, radius + 1:radius + 1 + mcount] - s[:, 0:mcount] if mcount > 0 else None
    tail = []
    q = max(mcount, 0)
    dist = W - q
    for r in range(radius):
        tail.append(s[:, wm] - s[:, min(q, wm)])
        if dist >= r:
            q += 1
            dist -= 1
    parts = [torch.stack(cols, dim=1)] if cols else []
    if mid is not None:
        parts.append(mid)
    parts.append(torch.stack(tail, dim=1))
    D = torch.cat(parts, dim=1)                  # (R, W + radius - 1, C)
    nD = W + radius + 1
    if D.shape[1] < nD:                          # the unwritten tail of D is zero
        D = torch.cat([D, D.new_zeros(R, nD - D.shape[1], C)], dim=1)
    radius_mul = (radius + 2) * (radius + 1) // 2
    sum0 = s[:, 0] * radius_mul
    for i in range(radius):
        sum0 = sum0 + s[:, min(i + 1, wm)] * (radius - i)
    diff_val0 = D[:, :radius + 1].sum(dim=1)
    E = D[:, radius + 1:radius + W] - D[:, 0:W - 1]
    zero = s.new_zeros(R, 1, C)
    diff_val = diff_val0[:, None] + torch.cat([zero, torch.cumsum(E, dim=1)], dim=1)
    return sum0[:, None] + torch.cat([zero, torch.cumsum(diff_val[:, :-1], dim=1)], dim=1)


def _stackblur_quant(S, r: int, simd, dtype):
    """u8: the SIMD lanes take (S * mul) >> shr, the scalar lanes
    trunc(S * (1/(r+1)²) in f32); other depths the f32 product, saturated
    for integers."""
    mulf = float(np.float32(1.0 / ((r + 1) * (r + 1))))
    prod = S.to(torch.float32) * mulf
    if dtype != torch.uint8:
        return prod.to(dtype) if dtype.is_floating_point else saturate_cast(prod, dtype)
    rq = min(r, 254)
    q_int = (S * int(_STACKBLUR_MUL[rq])) >> int(_STACKBLUR_SHR[rq])
    return torch.where(simd, q_int, prod.to(torch.int32)).to(torch.uint8)


def stackBlur(src, ksize):
    """`cv::stackBlur` (stackblur.cpp): separable triangular blur, bit-equal
    to ``opencv_tpu`` including its quirks: the radius clamps to (len-1)/2
    per axis; the small-kernel row branch mixes SIMD mul/shr quantization
    (16-lane blocks) with float-truncate scalar borders; the big-kernel row
    branch runs the sliding-stack recurrence (whose right tail freezes
    partway) with saturate_cast rounding; the column pass is a replicate
    triangle with the same SIMD/scalar split."""
    x, meta = to_batched(src)
    kw, kh = (ksize, ksize) if np.isscalar(ksize) else ksize
    N, H, W, C = x.shape
    dev = x.device

    def row_pass(arr):
        r = min(kw // 2, (W - 1) // 2)
        if r == 0:
            return arr
        k = 2 * r + 1
        if k <= 9 and W > k:
            e16 = _simd16_end(r * C, (W - r) * C)
            lane = torch.arange(W * C, device=dev)
            simd = ((lane >= r * C) & (lane < e16)).reshape(W, C)
            return _stackblur_quant(_stackblur_sums(arr, k, 2), r, simd, arr.dtype)
        S = _stackblur_row_big(arr.to(torch.int64).reshape(N * H, W, C), r).reshape(N, H, W, C)
        prod = S.to(torch.float32) * float(np.float32(1.0 / ((r + 1) * (r + 1))))
        if arr.dtype == torch.uint8:
            return saturate_cast(prod, torch.uint8)
        return prod.to(arr.dtype)

    def col_pass(arr):
        r = min(kh // 2, (H - 1) // 2)
        if r == 0:
            return arr
        e16 = _simd16_end(0, W * C) if r <= 254 else 0
        simd = (torch.arange(W * C, device=dev) < e16).reshape(W, C)
        return _stackblur_quant(_stackblur_sums(arr, 2 * r + 1, 1), r, simd, arr.dtype)

    out = x
    if kw > 1:
        out = row_pass(out)
    if kh > 1:
        out = col_pass(out)
    return from_batched(out, meta)
