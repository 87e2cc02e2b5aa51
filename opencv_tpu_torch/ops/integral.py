"""Integral images (twin of ``opencv_tpu/ops/integral.py``;
imgproc/src/sumpixels.dispatch.cpp).

Two cumsums, as cv2 accumulates them: each row's prefix sum added to the
row above.  ``CV_64F`` is real float64 here, and the defaults are cv2's:
sums of u8 in int32, of any other depth in float64, squared sums in
float64.  The JAX package maps ``CV_64F`` to float32, takes float input's
sums and every squared sum in float32, and sums 16-bit input in int32.

The tilted (45°-rotated) integral, t(y,x) = Σ src(m,n) for m<y,
|n-x+1| ≤ y-m-1, comes from two skewed diagonal prefix sums (see
`_tilted`), as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import constants as K
from ..core.arrays import from_batched, to_batched

__all__ = ["integral", "integral2", "integral3"]

_DEPTHS = {K.CV_32S: torch.int32, K.CV_32F: torch.float32, K.CV_64F: torch.float64}


def _sum_dtype(x, sdepth) -> torch.dtype:
    if sdepth in (-1, None):
        return torch.int32 if x.dtype == torch.uint8 else torch.float64
    return _DEPTHS[sdepth]


def _sq_dtype(sqdepth) -> torch.dtype:
    return torch.float64 if sqdepth in (-1, None) else _DEPTHS[sqdepth]


def _integral_sum(x, dt):
    """(N, H, W, C) → (N, H+1, W+1, C) in `dt`, with the zero row and column."""
    s = torch.cumsum(torch.cumsum(x.to(dt), dim=2, dtype=dt), dim=1, dtype=dt)
    return F.pad(s, (0, 0, 1, 0, 1, 0))


def _squares(x, dt):
    """x² in `dt`, exact for integer input (int64 products)."""
    if x.is_floating_point():
        xf = x.to(dt)
        return xf * xf
    xi = x.to(torch.int64)
    return (xi * xi).to(dt)


def integral(src, sdepth: int = -1):
    x, meta = to_batched(src)
    return from_batched(_integral_sum(x, _sum_dtype(x, sdepth)), meta)


def integral2(src, sdepth: int = -1, sqdepth: int = -1):
    x, meta = to_batched(src)
    s = _integral_sum(x, _sum_dtype(x, sdepth))
    dq = _sq_dtype(sqdepth)
    sq = _integral_sum(_squares(x, dq), dq)
    return from_batched(s, meta), from_batched(sq, meta)


def _tilted(x, dt):
    """Tilted integral via two skewed diagonal prefix sums.

    t(y,x) = Σ_{m<y} [P(m, clip(x+y-m-1, 0, W)) − P(m, clip(x−y+m, 0, W))]
    where P is the per-row prefix sum: two gathers along skewed diagonals
    plus cumsums over rows; O(H·(H+W)) memory.
    """
    N, H, W, C = x.shape
    dev = x.device
    # P: (N, H, W+1, C) row prefix sums with a leading zero
    P = F.pad(torch.cumsum(x.to(dt), dim=2, dtype=dt), (0, 0, 1, 0))
    D = H + W + 1
    m = np.arange(H)[:, None]
    d = np.arange(D)[None, :]

    def along_w(a, idx):
        i = torch.from_numpy(np.array(idx, np.int64)).to(dev)
        return torch.gather(a, 2, i[None, :, :, None].expand(N, H, idx.shape[1], C))

    g1 = along_w(P, np.clip(d - m - 1, 0, W))     # for diagonal u = x + y
    g2 = along_w(P, np.clip(d - H + m, 0, W))     # for diagonal v = x - y + H
    A1 = torch.cumsum(g1, dim=1, dtype=dt)        # A1[y-1] = Σ_{m<y} g1
    A2 = torch.cumsum(g2, dim=1, dtype=dt)
    ys = np.arange(1, H + 1)[:, None]
    xs = np.arange(W + 1)[None, :]
    body = along_w(A1, np.broadcast_to(xs + ys, (H, W + 1))) \
        - along_w(A2, np.broadcast_to(xs - ys + H, (H, W + 1)))
    return F.pad(body, (0, 0, 0, 0, 1, 0))


def integral3(src, sdepth: int = -1, sqdepth: int = -1):
    """sum, sqsum and tilted integrals (`cv::integral` 3-output form)."""
    x, meta = to_batched(src)
    s = _integral_sum(x, _sum_dtype(x, sdepth))
    dq = _sq_dtype(sqdepth)
    sq = _integral_sum(_squares(x, dq), dq)
    t = _tilted(x, s.dtype)
    return from_batched(s, meta), from_batched(sq, meta), from_batched(t, meta)
