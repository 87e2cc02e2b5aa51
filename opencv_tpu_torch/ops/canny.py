"""Canny edge detector (imgproc/src/canny.cpp), twin of
``opencv_tpu/ops/canny.py``.

Integer Sobel (the ``sep_filter_int`` kernel on the card, BORDER_REPLICATE)
→ L1 or L2 magnitude → the Q15 sector non-maximum suppression with
TG22 = 13573 and the exact >/>= tie rules of canny.cpp:538-590 → hysteresis
as an iterated masked 3×3 dilation of the strong seeds through the
candidates, up to its fixed point.

Hysteresis and host syncs: the JAX package runs the dilation inside a
``lax.while_loop`` on the device.  Here the loop runs on the host, and
reading the changed-flag (``torch.equal``) is a host sync, so the flag is
read only every :data:`HYST_CHECK_EVERY` iterations: the state after a
group of iterations is compared with the state before it.  An iteration at
the fixed point changes nothing, so the edges are the same; the loop runs
at most ``HYST_CHECK_EVERY - 1`` iterations past the fixed point, plus the
group that confirms it.  Measured with the JAX reference on a CPU at
540×960 with thresholds 50/150, uniform noise (the input of BASELINE
config 3) converges in 2 iterations, and the same noise smoothed by
GaussianBlur 7×7 σ 2.5 in 60.  At (8, 1080, 1920, 1) on an H100 (700 W),
one iteration takes 0.24 ms; checking every 2 iterations gave the noise
batch 4 iterations and 2 syncs (3.35 ms) and the smoothed batch 84 and 42
(25.0 ms), against 3.50 / 27.73 ms for every iteration and 4.37 / 25.27
ms for every 4.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import constants as K
from ..core.arrays import to_batched, from_batched
from .deriv import Sobel

__all__ = ["Canny", "HYST_CHECK_EVERY"]

_TG22 = 13573
# dilation iterations between two reads of the changed-flag (host syncs)
HYST_CHECK_EVERY = 2


def _nms(mag, dx, dy, low):
    """Sector-based non-maximum suppression; returns the bool mask of the
    pixels that survive (candidates).  mag, dx, dy: int32 (N,H,W,1)."""
    N, H, W, C = mag.shape
    # neighbours with zero padding (the reference's mag buffers have zero
    # borders)
    pad = F.pad(mag, (0, 0, 1, 1, 1, 1))
    m_l = pad[:, 1:H + 1, 0:W, :]
    m_r = pad[:, 1:H + 1, 2:W + 2, :]
    m_u = pad[:, 0:H, 1:W + 1, :]
    m_d = pad[:, 2:H + 2, 1:W + 1, :]
    m_ul = pad[:, 0:H, 0:W, :]
    m_ur = pad[:, 0:H, 2:W + 2, :]
    m_dl = pad[:, 2:H + 2, 0:W, :]
    m_dr = pad[:, 2:H + 2, 2:W + 2, :]

    # int32 arithmetic incl. the (x<<16) overflow wrap, matching the C int
    x = dx.abs()
    y = dy.abs() << 15
    tg22x = x * _TG22
    tg67x = tg22x + (x << 16)

    horiz = y < tg22x
    vert = y > tg67x
    diag_neg = (dx ^ dy) < 0  # s = -1

    keep_h = (mag > m_l) & (mag >= m_r)
    keep_v = (mag > m_u) & (mag >= m_d)
    # s=1: m > mag_p[k-1] && m > mag_n[k+1]  (up-left / down-right)
    keep_d1 = (mag > m_ul) & (mag > m_dr)
    # s=-1: m > mag_p[k+1] && m > mag_n[k-1]
    keep_d2 = (mag > m_ur) & (mag > m_dl)

    keep = torch.where(horiz, keep_h,
                       torch.where(vert, keep_v, torch.where(diag_neg, keep_d2, keep_d1)))
    # borders participate: out-of-image neighbours read as 0 magnitude
    return keep & (mag > low)


def _dilate3(m):
    """3×3 max of an (N,H,W) u8 mask with zero padding, as two 3-tap
    passes."""
    p = F.pad(m, (1, 1, 1, 1))
    h = torch.maximum(torch.maximum(p[:, :, :-2], p[:, :, 1:-1]), p[:, :, 2:])
    return torch.maximum(torch.maximum(h[:, :-2], h[:, 1:-1]), h[:, 2:])


def _hysteresis(seeds, cands, stats=None):
    """Grow `seeds` through `cands` by masked 3×3 dilation up to the fixed
    point.  Both (N,H,W,1) bool.  If `stats` is a dict, it receives the
    iterations run and the host syncs they took."""
    cand = cands[..., 0].to(torch.uint8)
    cur = seeds[..., 0].to(torch.uint8)
    iters = syncs = 0
    while True:
        before = cur
        for _ in range(HYST_CHECK_EVERY):
            cur = cur | (_dilate3(cur) & cand)
        iters += HYST_CHECK_EVERY
        syncs += 1
        if torch.equal(cur, before):
            break
    if stats is not None:
        stats.update(iterations=iters, host_syncs=syncs)
    return cur[..., None].bool()


def Canny(image, threshold1: float, threshold2: float, apertureSize: int = 3,
          L2gradient: bool = False, *, stats=None):
    """`cv::Canny` (canny.cpp:859).  `stats` (this port's addition): a dict
    that receives the hysteresis iterations and host syncs of the call."""
    x, meta = to_batched(image)
    low_t, high_t = min(threshold1, threshold2), max(threshold1, threshold2)

    dx = Sobel(x, K.CV_16S, 1, 0, ksize=apertureSize, borderType=K.BORDER_REPLICATE)
    dy = Sobel(x, K.CV_16S, 0, 1, ksize=apertureSize, borderType=K.BORDER_REPLICATE)
    if x.shape[-1] > 1:
        # multi-channel: per-pixel channel with max L2 magnitude
        # (canny.cpp cn>1 path); argmax takes the first of equal maxima
        dxi = dx.to(torch.int32)
        dyi = dy.to(torch.int32)
        best = torch.argmax(dxi * dxi + dyi * dyi, dim=-1, keepdim=True)
        dx = torch.take_along_dim(dx, best, dim=-1)
        dy = torch.take_along_dim(dy, best, dim=-1)

    dxi = dx.to(torch.int32)
    dyi = dy.to(torch.int32)
    if L2gradient:
        low = int(math.floor(min(32767.0, low_t)))
        high = int(math.floor(min(32767.0, high_t)))
        low, high = low * low, high * high
        mag = dxi * dxi + dyi * dyi
    else:
        low = int(math.floor(low_t))
        high = int(math.floor(high_t))
        mag = dxi.abs() + dyi.abs()

    cand = _nms(mag, dxi, dyi, low)
    edges = _hysteresis(cand & (mag > high), cand, stats)
    out = edges.to(torch.uint8) * 255
    return from_batched(out, meta)
