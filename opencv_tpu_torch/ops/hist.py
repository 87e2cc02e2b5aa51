"""Histograms: calcHist / equalizeHist / compareHist / calcBackProject /
CLAHE (twin of ``opencv_tpu/ops/hist.py``; imgproc/src/histogram.cpp,
clahe.cpp).

Every histogram is one scatter: :func:`hist_fixed` adds ones into a zero
buffer with ``index_add_``, an extra bin taking what is out of range or
masked out, so nothing is read back to the host (``torch.bincount`` reads
the input's range back first).  Batched histograms (equalizeHist's per
image, CLAHE's per tile) offset each value by its image or tile.  A table
is applied by indexing it.  Where cv2 computes in float (equalizeHist's
scale, CLAHE's ``lutScale`` and its bilinear blend) the port does too, one
op at a time, so the card and the CPU round alike; where cv2 computes in
double (the bins of float input, compareHist) the port uses f64, where the
JAX package has f32.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as K
from ..core.arrays import as_tensor, from_batched, to_batched, to_device
from ..core.borders import pad_nhwc
from ..core.fixedpoint import saturate_cast

__all__ = ["calcHist", "equalizeHist", "compareHist", "calcBackProject", "createCLAHE",
           "CLAHE", "hist_fixed", "hist_per_image"]


# the most bins hist_fixed spreads its copies over (8 MB of int64 counts)
_HIST_COPY_BINS = 1 << 20


def hist_fixed(idx: torch.Tensor, n: int) -> torch.Tensor:
    """The int64 histogram of the integer values of `idx` in [0, n); a value
    of n (the overflow bin of a value out of range or masked out) is
    dropped.  One ``index_add_`` of ones on idx's device into p copies of
    the n + 1 bins, element i into copy i % p, then the sum of the copies:
    with few bins, p copies cut the atomic adds that meet on one address by
    p (p the largest of 256, 64, 16, 4 that divides idx's size and keeps
    p·(n + 1) within 2^20 bins, else 1)."""
    flat = idx.reshape(-1)
    m, dev = flat.numel(), flat.device
    p = next(c for c in (256, 64, 16, 4, 1) if m % c == 0 and c * (n + 1) <= _HIST_COPY_BINS
             or c == 1)
    if p > 1:
        copy = torch.arange(p, dtype=flat.dtype, device=dev) * (n + 1)
        flat = (flat.reshape(-1, p) + copy).reshape(-1)
    ones = torch.ones((), dtype=torch.int64, device=dev).expand(m)
    h = torch.zeros(p * (n + 1), dtype=torch.int64, device=dev).index_add_(0, flat, ones)
    return h.reshape(p, n + 1).sum(dim=0)[:n]


def _hist_images(x: torch.Tensor) -> torch.Tensor:
    """(N, 256) int64 histograms of the images of an (N, H, W, 1) u8 batch,
    from one scatter at offsets n*256 + v."""
    N = x.shape[0]
    off = torch.arange(N, dtype=torch.int32, device=x.device).reshape(N, 1) * 256
    return hist_fixed(x.reshape(N, -1).to(torch.int32) + off, N * 256).reshape(N, 256)


def hist_per_image(x: torch.Tensor) -> torch.Tensor:
    """The 256-bin histogram of each image of an (N, H, W, 1) u8 batch, as
    calcHist([img], [0], None, [256], [0, 256]) gives it, as an (N, 256)
    f32 tensor."""
    return _hist_images(x).to(torch.float32)


def _bin_index(x, hist_size: int, lo: float, hi: float):
    """(bin, in range) of each value of `x`.  u8 and u16 go through a table
    of floor(j*a + b) in f64 (histogram.cpp calcHist_8u), built on x's
    device; other depths bin floor(v*a + b) in f64 with a = n/(hi - lo) and
    b = -a*lo, as calcHist_ does, and are in range where lo <= v < hi (the
    bin clamped to [0, n)).  lo and hi are cv2's float ranges."""
    lo, hi = float(np.float32(lo)), float(np.float32(hi))
    a = hist_size / (hi - lo)
    b = -a * lo
    if x.dtype in (torch.uint8, torch.uint16):
        nvals = 256 if x.dtype == torch.uint8 else 65536
        j = torch.arange(nvals, dtype=torch.float64, device=x.device)
        tab = torch.floor(j * a + b).to(torch.int64)
        ok = (j >= lo) & (j < hi) & (tab >= 0) & (tab < hist_size)
        xi = x.to(torch.int64)
        return torch.where(ok, tab, 0)[xi].to(torch.int32), ok[xi]
    v = x.to(torch.float64)
    idx = torch.floor(v * a + b).clamp(0, hist_size - 1).to(torch.int32)
    return idx, (v >= lo) & (v < hi)


def calcHist(images, channels, mask, histSize, ranges, accumulate=False):
    """cv2-compatible calcHist with uniform bins, 1-D to n-D: a float32
    tensor of shape (histSize[0],) (cv2 5.x returns 1-D), (h0, h1), or
    histSize.  Every image of a batch counts into the one histogram."""
    imgs = [to_batched(im)[0] for im in images]

    def chan(ci):
        # channels index across the concatenated image list, cv2-style
        for im in imgs:
            if ci < im.shape[-1]:
                return im[..., ci]
            ci -= im.shape[-1]
        raise ValueError("channel index out of range")

    sizes = [int(histSize[k]) for k in range(len(channels))]
    flat_idx = valid = None
    stride = int(np.prod(sizes))
    for k, ch in enumerate(channels):
        stride //= sizes[k]
        ik, vk = _bin_index(chan(ch), sizes[k], float(ranges[2 * k]), float(ranges[2 * k + 1]))
        term = ik * stride
        flat_idx = term if flat_idx is None else flat_idx + term
        valid = vk if valid is None else valid & vk
    if mask is not None:
        m, _ = to_batched(to_device(as_tensor(mask), flat_idx.device))
        valid = valid & (m[..., 0] != 0)
    total = int(np.prod(sizes))
    h = hist_fixed(torch.where(valid, flat_idx, total), total)
    return h.to(torch.float32).reshape(sizes)


def _equalize_luts(hist, total: int) -> torch.Tensor:
    """(N, 256) u8 tables per histogram.cpp equalizeHist: i0 the first
    nonzero bin, scale = 255.f/(total - hist[i0]) in f32, lut[i <= i0] = 0,
    lut[i] = saturate(cumsum(hist[i0+1..i]) * scale); a one-valued image
    maps to i0."""
    dev = hist.device
    i0 = torch.argmax((hist > 0).to(torch.uint8), dim=1, keepdim=True)
    h0 = torch.gather(hist, 1, i0)
    idx = torch.arange(256, device=dev).reshape(1, 256)
    csum = torch.cumsum(torch.where(idx > i0, hist, 0), dim=1)
    n255 = torch.full((), 255.0, dtype=torch.float32, device=dev)
    scale = n255 / (total - h0).clamp(min=1).to(torch.float32)
    lut = saturate_cast(csum.to(torch.float32) * scale, torch.uint8)
    lut = torch.where(idx <= i0, 0, lut)
    return torch.where(h0 == total, i0.to(torch.uint8), lut).to(torch.uint8)


def equalizeHist(src):
    """`cv::equalizeHist` (histogram.cpp:3436), per image in the batch: one
    scatter gives the (N, 256) histograms, one index applies the tables."""
    x, meta = to_batched(src)
    N, H, W, C = x.shape
    if C != 1 or x.dtype != torch.uint8:
        raise ValueError("equalizeHist requires single-channel 8-bit input")
    luts = _equalize_luts(_hist_images(x), H * W)
    off = torch.arange(N, dtype=torch.int64, device=x.device).reshape(N, 1, 1, 1) * 256
    return from_batched(luts.reshape(-1)[x.to(torch.int64) + off], meta)


def compareHist(h1, h2, method: int) -> float:
    """`cv::compareHist` (histogram.cpp), accumulated in f64 as cv2 does
    (the JAX package accumulates in f32)."""
    a = as_tensor(h1).reshape(-1).to(torch.float64)
    b = to_device(as_tensor(h2), a.device).reshape(-1).to(torch.float64)
    eps = float(np.finfo(np.float64).eps)
    if method == K.HISTCMP_CORREL:
        scale = 1.0 / a.numel()
        s1, s2 = a.sum(), b.sum()
        num = (a * b).sum() - s1 * s2 * scale
        den2 = ((a * a).sum() - s1 * s1 * scale) * ((b * b).sum() - s2 * s2 * scale)
        return float(num / torch.sqrt(den2)) if abs(float(den2)) > eps else 1.0
    if method in (K.HISTCMP_CHISQR, K.HISTCMP_CHISQR_ALT):
        d = a - b
        s = a if method == K.HISTCMP_CHISQR else a + b
        ok = s.abs() > eps
        r = float(torch.where(ok, d * d / torch.where(ok, s, 1.0), 0.0).sum())
        return 2 * r if method == K.HISTCMP_CHISQR_ALT else r
    if method == K.HISTCMP_INTERSECT:
        return float(torch.minimum(a, b).sum())
    if method == K.HISTCMP_BHATTACHARYYA:
        s = float(a.sum() * b.sum())
        s = 1.0 / np.sqrt(s) if abs(s) > float(np.finfo(np.float32).eps) else 1.0
        return float(np.sqrt(max(1.0 - float(torch.sqrt(a * b).sum()) * s, 0.0)))
    if method == K.HISTCMP_KL_DIV:
        q = torch.where(b.abs() <= eps, 1e-10, b)
        ok = a.abs() > eps
        pa = torch.where(ok, a, 1.0)
        return float(torch.where(ok, pa * torch.log(pa / q), 0.0).sum())
    raise ValueError(f"unknown compareHist method {method}")


def calcBackProject(images, channels, hist, ranges, scale: float = 1.0):
    """`cv::calcBackProject` for 1-D and 2-D histograms: hist[bin] * scale
    in f32, saturated to u8 for u8 input, 0 where a value is out of range."""
    x, meta = to_batched(images[0])
    h = to_device(as_tensor(hist), x.device).to(torch.float32)
    if h.ndim == 2 and h.shape[1] == 1:
        h = h[:, 0]
    if h.ndim == 1 and len(channels) == 1:
        n = h.shape[0]
        idx, valid = _bin_index(x[..., channels[0]], n, float(ranges[0]), float(ranges[1]))
        vals = h[idx.to(torch.int64).clamp(0, n - 1)] * scale
    elif len(channels) == 2:
        n0, n1 = h.shape
        lo0, hi0, lo1, hi1 = [float(r) for r in ranges[:4]]
        i0, v0 = _bin_index(x[..., channels[0]], n0, lo0, hi0)
        i1, v1 = _bin_index(x[..., channels[1]], n1, lo1, hi1)
        flat = i0.to(torch.int64).clamp(0, n0 - 1) * n1 + i1.to(torch.int64).clamp(0, n1 - 1)
        vals = h.reshape(-1)[flat] * scale
        valid = v0 & v1
    else:
        raise NotImplementedError("calcBackProject takes 1-D and 2-D histograms")
    out = torch.where(valid, vals, 0.0)
    if x.dtype == torch.uint8:
        out = saturate_cast(out, torch.uint8)
    return from_batched(out[..., None], meta)


class CLAHE:
    """Contrast-limited adaptive histogram equalization (clahe.cpp): tile
    histograms by one scatter, clip and redistribute in int64, per-tile
    cumulative tables scaled by ``lutScale`` in f32, then per pixel the
    bilinear blend of the four surrounding tiles' tables, in f32 in the
    reference's order."""

    def __init__(self, clipLimit=40.0, tileGridSize=(8, 8)):
        self.clip_limit = clipLimit
        self.tiles = tuple(tileGridSize)

    def setClipLimit(self, v):
        self.clip_limit = v

    def setTilesGridSize(self, t):
        self.tiles = tuple(t)

    def getClipLimit(self):
        return self.clip_limit

    def getTilesGridSize(self):
        return self.tiles

    def _luts(self, xp, ty: int, tx: int, th: int, tw: int) -> torch.Tensor:
        """(N * ty * tx * 256,) f32 tables of the tiles of the padded batch."""
        N, dev = xp.shape[0], xp.device
        T, tile_area = ty * tx, th * tw
        tiles = xp.reshape(N, ty, th, tx, tw).permute(0, 1, 3, 2, 4).reshape(N * T, th * tw)
        off = torch.arange(N * T, dtype=torch.int32, device=dev).reshape(-1, 1) * 256
        hist = hist_fixed(tiles.to(torch.int32) + off, N * T * 256).reshape(N * T, 256)
        clip = max(int(self.clip_limit * tile_area / 256), 1) if self.clip_limit > 0 else 0
        if clip > 0:
            # clahe.cpp calcLut: clip, add clipped / 256 to every bin, then
            # one more to bins 0, step, 2*step, ... while residual lasts
            clipped = hist.clamp(max=clip)
            total = (hist - clipped).sum(dim=1, keepdim=True)
            redist, residual = total // 256, total % 256
            step = (256 // residual.clamp(min=1)).clamp(min=1)
            i = torch.arange(256, device=dev).reshape(1, 256)
            extra = (residual > 0) & (i % step == 0) & (i < residual * step)
            hist = clipped + redist + extra.to(torch.int64)
        # lutScale = float(histSize - 1) / tileSizeTotal, in f32
        lut_scale = (torch.full((), 255.0, dtype=torch.float32, device=dev)
                     / torch.full((), float(tile_area), dtype=torch.float32, device=dev))
        luts = saturate_cast(torch.cumsum(hist, dim=1).to(torch.float32) * lut_scale, torch.uint8)
        return luts.to(torch.float32).reshape(-1)

    def apply(self, src):
        x, meta = to_batched(src)
        N, H, W, C = x.shape
        if C != 1 or x.dtype != torch.uint8:
            raise ValueError("CLAHE takes single-channel 8-bit input")
        tx, ty = self.tiles
        # the reference pads to a multiple of the grid with REFLECT_101.
        # QUIRK, kept exactly: the pad amounts are `tiles - dim % tiles`
        # with no modulo wrap, so when only one dimension is not divisible
        # the other still gets a full `tiles`-pixel pad (clahe.cpp:374-383)
        ph = pw = 0
        if H % ty or W % tx:
            ph, pw = ty - H % ty, tx - W % tx
        xp = pad_nhwc(x, 0, ph, 0, pw, K.BORDER_REFLECT_101)[..., 0]
        th, tw = (H + ph) // ty, (W + pw) // tx
        luts = self._luts(xp, ty, tx, th, tw)

        # the blend, as clahe.cpp's interpolation body: tile coordinate
        # t = i * (1.f / tileSize) - 0.5f, t1 = floor(t) and t2 = t1 + 1
        # clamped to the grid, weight t - floor(t) unclamped, all in f32
        dev = x.device

        def axis(n, tile, count):
            one = torch.full((), 1.0, dtype=torch.float32, device=dev)
            inv = one / torch.full((), float(tile), dtype=torch.float32, device=dev)
            t = torch.arange(n, dtype=torch.float32, device=dev) * inv - 0.5
            f = torch.floor(t)
            t1 = f.to(torch.int64)
            return t1.clamp(0, count - 1), (t1 + 1).clamp(0, count - 1), t - f

        y1, y2, ya = axis(H, th, ty)
        x1, x2, xa = axis(W, tw, tx)
        ya, xa = ya.reshape(1, H, 1), xa.reshape(1, 1, W)
        ya1, xa1 = 1.0 - ya, 1.0 - xa
        base = (torch.arange(N, dtype=torch.int32, device=dev) * (ty * tx * 256)).reshape(N, 1, 1)
        pix = x[..., 0].to(torch.int32) + base

        def tap(ry, cx):
            """luts[n, tile (ry, cx), v] of every pixel, one int32 gather."""
            tile = ((ry.reshape(H, 1) * tx + cx.reshape(1, W)) * 256).to(torch.int32)
            return luts.index_select(0, (pix + tile).reshape(-1)).reshape(N, H, W)

        # (p1[ind1]*xa1 + p1[ind2]*xa)*ya1 + (p2[ind1]*xa1 + p2[ind2]*xa)*ya
        top = tap(y1, x1) * xa1 + tap(y1, x2) * xa
        bot = tap(y2, x1) * xa1 + tap(y2, x2) * xa
        out = top * ya1 + bot * ya
        return from_batched(saturate_cast(out, torch.uint8)[..., None], meta)


def createCLAHE(clipLimit=40.0, tileGridSize=(8, 8)):
    return CLAHE(clipLimit, tileGridSize)
