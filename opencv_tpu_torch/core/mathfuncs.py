"""cv::fastAtan2 on tensors (mathfuncs_core.simd.hpp:36-70), shared by ORB's
keypoint angles and the inverse polar warps (the JAX package keeps a numpy
copy in each: ``features2d/orb.py::_fast_atan2`` and
``ops/warp.py::_fast_atan2_deg``)."""

from __future__ import annotations

import math

import torch

__all__ = ["fast_atan2"]

_P1 = 0.9997878412794807 * (180 / math.pi)
_P3 = -0.3258083974640975 * (180 / math.pi)
_P5 = 0.1555786518463281 * (180 / math.pi)
_P7 = -0.04432655554792128 * (180 / math.pi)
_EPS = 2.220446049250313e-16


def fast_atan2(y, x):
    """cv::fastAtan2 on float32 tensors: 7th-order polynomial, degrees in
    [0, 360).  One op at a time, so no multiply-add is fused on either
    device."""
    ax, ay = x.abs(), y.abs()
    c = torch.where(ax >= ay, ay / (ax + _EPS), ax / (ay + _EPS))
    c2 = c * c
    a = (((_P7 * c2 + _P5) * c2 + _P3) * c2 + _P1) * c
    a = torch.where(ax >= ay, a, 90.0 - a)
    a = torch.where(x < 0, 180.0 - a, a)
    return torch.where(y < 0, 360.0 - a, a)
