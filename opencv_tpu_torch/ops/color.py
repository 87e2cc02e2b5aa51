"""cvtColor — color space conversions (twin of ``opencv_tpu/ops/color.py``).

Ported so far: the gray family (BGR/BGRA/RGB/RGBA → GRAY).  Integer inputs
use the reference's Q15 coefficients ``RY15=9798, GY15=19235, BY15=3735``
(sum exactly 2^15) with ``CV_DESCALE`` rounding in int32
(`imgproc/src/color.simd_helpers.hpp:16,22-24`); float32 inputs the float
coefficients.  Other depths raise, as in cv2.  Every other code raises
``NotImplementedError`` until its slice is ported (ROADMAP.md, queue A2).

The dispatcher mirrors `cv::cvtColor`'s switch as a registry keyed on the
public COLOR_* codes.
"""

from __future__ import annotations

import torch

from .. import constants as K
from ..core.arrays import to_batched, from_batched
from ..core.fixedpoint import descale

__all__ = ["cvtColor"]

# Q15 gray coefficients, sum == 2^15 exactly (color.simd_helpers.hpp:16,22-24)
RY15, GY15, BY15 = 9798, 19235, 3735
GRAY_SHIFT = 15
# float gray coefficients (color.hpp)
R2YF, G2YF, B2YF = 0.299, 0.587, 0.114

_REGISTRY = {}


def _register(*codes):
    def deco(fn):
        for c in codes:
            _REGISTRY[c] = fn
        return fn
    return deco


# the depths cv2's gray conversion takes (CvtHelper's VDepth = Set<CV_8U,
# CV_16U, CV_32F>, color.simd_helpers.hpp:94); the JAX package takes any
_GRAY_DTYPES = (torch.uint8, torch.uint16, torch.float32)


def _rgb_to_gray(x, r, g, b):
    if x.dtype not in _GRAY_DTYPES:
        raise ValueError(f"cvtColor to gray takes uint8, uint16 or float32 input, as cv2 does; "
                         f"got {x.dtype}")
    if not x.is_floating_point():
        xi = x.to(torch.int32)
        y = descale(xi[..., r] * RY15 + xi[..., g] * GY15 + xi[..., b] * BY15, GRAY_SHIFT)
        return y[..., None].to(x.dtype)

    def coef(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    y = x[..., r] * coef(R2YF) + x[..., g] * coef(G2YF) + x[..., b] * coef(B2YF)
    return y[..., None]


@_register(K.COLOR_BGR2GRAY, K.COLOR_BGRA2GRAY)
def _bgr2gray(x):
    return _rgb_to_gray(x, 2, 1, 0)


@_register(K.COLOR_RGB2GRAY, K.COLOR_RGBA2GRAY)
def _rgb2gray(x):
    return _rgb_to_gray(x, 0, 1, 2)


def cvtColor(src, code: int, dstCn: int = 0):
    """Convert an image (or NHWC batch) between color spaces.

    Mirrors `cv::cvtColor` (imgproc/src/color.cpp:192).
    """
    try:
        fn = _REGISTRY[code]
    except KeyError:
        raise NotImplementedError(
            f"cvtColor code {code} is not ported to opencv_tpu_torch yet "
            "(ROADMAP.md, queue A2)") from None
    x, meta = to_batched(src)
    return from_batched(fn(x), meta)
