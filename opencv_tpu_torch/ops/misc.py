"""Miscellaneous imgproc ops (twin of ``opencv_tpu/ops/misc.py``).

Ported so far: ``demosaicing``, which ``cvtColor`` reaches for the Bayer
codes.  The rest of the module (getRectSubPix, convertMaps,
phaseCorrelate, ...) waits for its slice (ROADMAP.md, queue A6).
"""

from __future__ import annotations

import torch

from .. import constants as K
from ..core.arrays import from_batched, to_batched
from ..core.borders import pad_nhwc
from ..core.fixedpoint import saturate_cast

__all__ = ["demosaicing"]

# (row, column) parity of the red sites per code.  Matched to the reference
# by the JAX package: BayerBG2BGR has R at (0, 0), the enum naming the
# second row's pattern.
_RED_SITE = {K.COLOR_BayerBG2BGR: (0, 0), K.COLOR_BayerGB2BGR: (0, 1),
             K.COLOR_BayerRG2BGR: (1, 1), K.COLOR_BayerGR2BGR: (1, 0)}


def demosaicing(src, code: int, dstCn: int = 0):
    """Bilinear Bayer demosaicing (demosaicing.cpp Bayer2BGR_, the
    default non-VNG path): green averaged from 4 neighbors, R/B from
    2 or 4 diagonal neighbors, with the reference's descale rounding.
    Codes other than the four BayerXX2BGR (and their RGB aliases) take the
    BayerGR parity, as in the JAX package."""
    x, meta = to_batched(src)
    N, H, W = x.shape[:3]
    p = pad_nhwc(x[..., :1].to(torch.int32), 1, 1, 1, 1, K.BORDER_REFLECT_101)[..., 0]

    def at(dy, dx):
        return p[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

    c = at(0, 0)
    h2 = (at(0, -1) + at(0, 1) + 1) >> 1
    v2 = (at(-1, 0) + at(1, 0) + 1) >> 1
    x4 = (at(-1, -1) + at(-1, 1) + at(1, -1) + at(1, 1) + 2) >> 2
    p4 = (at(0, -1) + at(0, 1) + at(-1, 0) + at(1, 0) + 2) >> 2

    ry, rx = _RED_SITE.get(code, (1, 0))
    ys = (torch.arange(H, device=x.device) % 2)[:, None]
    xs = (torch.arange(W, device=x.device) % 2)[None, :]
    is_r = (ys == ry) & (xs == rx)
    is_b = (ys == 1 - ry) & (xs == 1 - rx)
    g_row_r = ys == ry  # green pixels on red rows
    R = torch.where(is_r, c, torch.where(is_b, x4, torch.where(g_row_r, h2, v2)))
    B = torch.where(is_b, c, torch.where(is_r, x4, torch.where(g_row_r, v2, h2)))
    G = torch.where(is_r | is_b, p4, c)
    out = torch.stack([B, G, R], dim=-1)
    # the reference fills the one-pixel frame by copying the adjacent
    # computed row/column (demosaicing.cpp border handling) — rows first,
    # then columns (covers the corners)
    out[:, 0] = out[:, 1]
    out[:, H - 1] = out[:, H - 2]
    out[:, :, 0] = out[:, :, 1]
    out[:, :, W - 1] = out[:, :, W - 2]
    return from_batched(saturate_cast(out, x.dtype), meta)
