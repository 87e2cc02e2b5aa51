"""Saturating casts and fixed-point helpers (twin of
``opencv_tpu/core/fixedpoint.py``).

Every narrowing store of the reference goes through `cv::saturate_cast<>`
and every fixed-point accumulate rounds with ``CV_DESCALE(x, n) =
(x + (1 << (n-1))) >> n``.  Float→int rounding is `cvRound`, i.e.
round-half-to-even, which is what ``torch.round`` does.

torch's uint8 arithmetic wraps, so callers widen to int32 before any
arithmetic and come back through :func:`saturate_cast`.
"""

from __future__ import annotations

import torch

__all__ = ["alpha_max", "descale", "saturate_cast"]

_INT_RANGE = {
    torch.uint8: (0, 255),
    torch.int8: (-128, 127),
    torch.uint16: (0, 65535),
    torch.int16: (-32768, 32767),
    torch.int32: (-2**31, 2**31 - 1),
}


def descale(x, n: int):
    """`CV_DESCALE`: round-half-up shift of a non-negative-biased int."""
    return (x + (1 << (n - 1))) >> n


def saturate_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Clamp-then-cast matching `cv::saturate_cast<>`.

    Integer targets clamp to the target range; float sources are rounded
    half-to-even first (`cvRound`).  Float targets are a plain cast.
    """
    if dtype in _INT_RANGE:
        lo, hi = _INT_RANGE[dtype]
        if x.is_floating_point():
            x = torch.round(x)
        return x.clamp(lo, hi).to(dtype)
    return x.to(dtype)


def alpha_max(dtype: torch.dtype):
    """Alpha-channel fill value per depth (255 / 65535 / 1.0), matching
    `cv::cvtColor` alpha conventions."""
    if dtype in _INT_RANGE:
        return _INT_RANGE[dtype][1]
    return 1.0
