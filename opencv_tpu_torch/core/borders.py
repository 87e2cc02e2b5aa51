"""Border handling (twin of ``opencv_tpu/core/borders.py``).

Replicates `cv::borderInterpolate` (`core/src/copy.cpp:748`) and
`cv::copyMakeBorder` semantics: CONSTANT / REPLICATE / REFLECT / WRAP /
REFLECT_101 (+ISOLATED, a no-op because tensors carry no ROI).

The index vectors are host numpy (copied from the JAX package), queued to
the device through pinned memory (``to_device``), so a pad never makes the
host wait; on the device a pad is two ``index_select`` gathers, plus a
masked fill for BORDER_CONSTANT.  The TPU's concat-of-border-segments
layout is not carried over: a GPU gathers a full index vector at memory
speed.
"""

from __future__ import annotations

import numpy as np
import torch

from .arrays import from_batched, to_batched, to_device

from ..constants import (
    BORDER_CONSTANT,
    BORDER_REPLICATE,
    BORDER_REFLECT,
    BORDER_WRAP,
    BORDER_REFLECT_101,
    BORDER_TRANSPARENT,
    BORDER_ISOLATED,
)

__all__ = ["border_interpolate", "border_index", "constant_vector", "copy_make_border",
           "pad_nhwc"]


# copy of opencv_tpu.core.borders.border_interpolate
def border_interpolate(p: int, length: int, border_type: int) -> int:
    """Host-side scalar twin of `cv::borderInterpolate` (copy.cpp:748).

    Returns the source coordinate for out-of-range coordinate ``p``, or -1
    for BORDER_CONSTANT.
    """
    bt = border_type & ~BORDER_ISOLATED
    if 0 <= p < length:
        return p
    if bt == BORDER_REPLICATE:
        return 0 if p < 0 else length - 1
    if bt in (BORDER_REFLECT, BORDER_REFLECT_101):
        delta = 1 if bt == BORDER_REFLECT_101 else 0
        if length == 1:
            return 0
        while p < 0 or p >= length:
            if p < 0:
                p = -p - 1 + delta
            else:
                p = length - 1 - (p - length) - delta
        return p
    if bt == BORDER_WRAP:
        if p < 0:
            p -= ((p - length + 1) // length) * length
        if p >= length:
            p %= length
        return p
    if bt in (BORDER_CONSTANT, BORDER_TRANSPARENT):
        return -1
    raise ValueError(f"unsupported border type {border_type}")


# copy of opencv_tpu.core.borders.border_index
def border_index(length: int, before: int, after: int, border_type: int) -> np.ndarray:
    """Index vector of length before+length+after mapping padded coords to
    source coords (-1 ⇒ constant fill)."""
    idx = np.empty(before + length + after, dtype=np.int32)
    for i in range(-before, length + after):
        idx[i + before] = border_interpolate(i, length, border_type)
    return idx


def constant_vector(value, channels: int) -> list:
    """The per-channel fill of a BORDER_CONSTANT pad: a scalar fills every
    channel, a sequence gives one value per channel (the first
    ``channels`` of it), as ``opencv_tpu``'s ``pad_nhwc`` broadcasts it."""
    v = np.asarray(value, np.float64).reshape(-1)
    if v.size > 1:
        v = v[:channels]
    return np.broadcast_to(v, (channels,)).tolist()


def pad_nhwc(x: torch.Tensor, top: int, bottom: int, left: int, right: int,
             border_type: int, value=0) -> torch.Tensor:
    """Pad an (N, H, W, C) tensor by the given border amounts."""
    if top == 0 and bottom == 0 and left == 0 and right == 0:
        return x
    bt = border_type & ~BORDER_ISOLATED
    if bt == BORDER_TRANSPARENT:
        raise ValueError("BORDER_TRANSPARENT cannot pad")
    N, H, W, C = x.shape
    ridx = border_index(H, top, bottom, bt)
    cidx = border_index(W, left, right, bt)
    y = x.index_select(1, to_device(np.maximum(ridx, 0).astype(np.int64), x.device))
    y = y.index_select(2, to_device(np.maximum(cidx, 0).astype(np.int64), x.device))
    if bt == BORDER_CONSTANT:
        val = torch.tensor(constant_vector(value, C), dtype=torch.float64).to(x.dtype)
        val = to_device(val, x.device).reshape(1, 1, 1, C)
        mask = (ridx < 0)[:, None] | (cidx < 0)[None, :]
        mask = to_device(mask, x.device)[None, :, :, None]
        y = torch.where(mask, val, y)
    return y


def copy_make_border(src, top: int, bottom: int, left: int, right: int,
                     borderType: int = BORDER_CONSTANT, value=0):
    """cv2-compatible `copyMakeBorder` over (H,W), (H,W,C) or (N,H,W,C)."""
    x, meta = to_batched(src)
    return from_batched(pad_nhwc(x, top, bottom, left, right, borderType, value), meta)
