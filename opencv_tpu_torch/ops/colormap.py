"""cv::applyColorMap (twin of ``opencv_tpu/ops/colormap.py``;
imgproc/src/colormap.cpp): the 22 colormaps and user tables.

The 256x3 BGR tables are the spec (``colormap_luts.npz``, a byte copy of
the JAX package's file): the procedural maps are interpolations of anchor
arrays and the perceptual ones hardcoded tables in colormap.cpp.  A table
is queued to the input's device and read with an index.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from .. import constants as K
from ..core.arrays import as_tensor, from_batched, to_batched, to_device

__all__ = ["applyColorMap"]


@functools.lru_cache(maxsize=None)
def _luts() -> dict:
    with np.load(os.path.join(os.path.dirname(__file__), "colormap_luts.npz")) as z:
        return {int(k): z[k] for k in z.files}


def applyColorMap(src, colormap):
    """`cv::applyColorMap`.  `colormap` is a COLORMAP_* id or a user
    (256, 1, 3) / (256, 3) / (256, 1) u8 table.  BGR input is first
    converted to gray by the port's cvtColor, as colormap.cpp does."""
    if isinstance(colormap, (int, np.integer)):
        lut = _luts().get(int(colormap))
        if lut is None:
            raise ValueError(f"unknown colormap id {colormap}")
        lut = torch.from_numpy(lut)
    else:
        lut = as_tensor(colormap).to(torch.uint8).reshape(256, -1)
        if lut.shape[1] == 1:
            lut = lut.expand(256, 3)
    x, meta = to_batched(src)
    if x.shape[3] == 3:
        from .color import cvtColor
        x = cvtColor(x, K.COLOR_BGR2GRAY)
    table = to_device(lut.contiguous(), x.device)
    idx = x[..., 0].reshape(-1).to(torch.int32)
    out = table.index_select(0, idx).reshape(*x.shape[:3], 3)
    return from_batched(out, meta)
