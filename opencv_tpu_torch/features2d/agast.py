"""AGAST corner detector (features2d/src/agast.cpp, agast_score.cpp), twin
of ``opencv_tpu/features2d/agast.py``.

The JAX package runs the dense segment test: each ring pixel is a shifted
slice of the edge-padded image, the arc test is an AND over S consecutive
ring planes for every rotation, and the response (the largest threshold
at which the pixel stays a corner, agast_score.cpp's bisection) is a
9-step vectorised bisection over that test, about 3,500 elementwise ops
per call.  The port computes the same integers in closed form on the
stacked ring planes R (n, N, H, W) of the image x:

- a bright arc from k survives threshold b iff ``min_j R[k+j] - x > b``
  over its S pixels, a dark one iff ``x - max_j R[k+j] > b``;
- so the pixel is a corner at b iff ``M > b``, with
  ``M = max(max_k minwin(R)[k] - x, x - min_k maxwin(R)[k])`` (the
  circular window min/max by doubling, as FAST's port takes it);
- the test is monotone in b, so the bisection (bmin = threshold,
  bmax = 255, 9 halvings) ends at the largest b < M: the score is M - 1
  where ``M > threshold``.

:func:`agast_dense_bisect` is the plain twin, the JAX package's bisection
in torch, which the tests hold the closed form to.  The inner-border mask
and the strict 3×3 NMS are the reference's.

Ring geometries from agast_score.cpp makeAgastOffsets:50-74; arc lengths
are the segment-test S of each variant (5 of 8, 7 of 12, 9 of 16).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import constants as K
from ..core.arrays import to_batched
from ..core.borders import pad_nhwc
from .fast import _circular_window
from .keypoint import KeyPoint

__all__ = ["AGAST", "AgastFeatureDetector", "AgastFeatureDetector_create",
           "agast_dense", "agast_dense_bisect"]

AGAST_5_8 = 0
AGAST_7_12d = 1
AGAST_7_12s = 2
OAST_9_16 = 3

# (ring offsets (x, y), arc length S, ring radius r)
_RINGS = {
    AGAST_5_8: ([(-1, 0), (-1, -1), (0, -1), (1, -1),
                 (1, 0), (1, 1), (0, 1), (-1, 1)], 5, 1),
    AGAST_7_12d: ([(-3, 0), (-2, -1), (-1, -2), (0, -3), (1, -2), (2, -1),
                   (3, 0), (2, 1), (1, 2), (0, 3), (-1, 2), (-2, 1)], 7, 3),
    AGAST_7_12s: ([(-2, 0), (-2, -1), (-1, -2), (0, -2), (1, -2), (2, -1),
                   (2, 0), (2, 1), (1, 2), (0, 2), (-1, 2), (-2, 1)], 7, 2),
    OAST_9_16: ([(-3, 0), (-3, -1), (-2, -2), (-1, -3), (0, -3), (1, -3),
                 (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3), (0, 3),
                 (-1, 3), (-2, 2), (-3, 1)], 9, 3),
}


def _ring(x, agast_type):
    """(x as int16 (N, H, W), ring planes (n, N, H, W) u8, S, r) of an
    (N, H, W) u8 tensor, the ring read from its edge-replicated copy."""
    offsets, S, r = _RINGS[agast_type]
    N, H, W = x.shape
    pad = pad_nhwc(x[..., None], r, r, r, r, K.BORDER_REPLICATE)[..., 0]
    R = torch.stack([pad[:, r + oy:r + oy + H, r + ox:r + ox + W] for ox, oy in offsets])
    return x.to(torch.int16), R, S, r


def _finish(x, score, corner0, r, nonmax):
    """The inner-border mask and the strict 3×3 NMS of the reference on the
    (N, H, W) int32 score and bool corner maps."""
    N, H, W = x.shape
    inner = torch.zeros((H, W), dtype=torch.bool, device=x.device)
    if H > 2 * r and W > 2 * r:
        inner[r:H - r, r:W - r] = True
    keep = corner0 & inner
    score = torch.where(keep, score, 0)
    if nonmax:
        p = F.pad(score, (1, 1, 1, 1))
        row3 = torch.maximum(torch.maximum(p[:, :, :W], p[:, :, 1:W + 1]), p[:, :, 2:])
        neigh = torch.maximum(torch.maximum(row3[:, :H], row3[:, 2:]),
                              torch.maximum(p[:, 1:H + 1, :W], p[:, 1:H + 1, 2:]))
        keep = keep & (score > neigh)
    return score, keep


def agast_dense(x, threshold: int, agast_type: int = OAST_9_16, nonmax: bool = True):
    """(score, keep) of an (N, H, W) u8 tensor on its device: int32 and
    bool (N, H, W) maps equal to the JAX package's ``_agast_dense``, the
    score in closed form."""
    xi, R, S, r = _ring(x, agast_type)
    bright = _circular_window(R, S, torch.minimum).amax(0).to(torch.int16) - xi
    dark = xi - _circular_window(R, S, torch.maximum).amin(0).to(torch.int16)
    M = torch.maximum(bright, dark).to(torch.int32)
    corner0 = M > int(threshold)
    return _finish(x, torch.where(corner0, M - 1, 0), corner0, r, nonmax)


def agast_dense_bisect(x, threshold: int, agast_type: int = OAST_9_16, nonmax: bool = True):
    """The plain twin of :func:`agast_dense`: the JAX package's segment test
    (an AND over every arc) and its 9-step bisection for the score."""
    xi, R, S, r = _ring(x, agast_type)
    R = R.to(torch.int16)
    n = R.shape[0]

    def is_corner(b):
        def arc(flags):
            hit = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
            for k in range(n):
                run = flags[k % n]
                for j in range(1, S):
                    run = run & flags[(k + j) % n]
                hit = hit | run
            return hit
        return arc(R > (xi + b)[None]) | arc(R < (xi - b)[None])

    corner0 = is_corner(torch.tensor(int(threshold), dtype=torch.int16, device=x.device))
    bmin = torch.full(x.shape, int(threshold), dtype=torch.int32, device=x.device)
    bmax = torch.full(x.shape, 255, dtype=torch.int32, device=x.device)
    for _ in range(9):
        btest = torch.div(bmin + bmax, 2, rounding_mode="floor")
        c = is_corner(btest.to(torch.int16))
        bmin = torch.where(c, btest, bmin)
        bmax = torch.where(c, bmax, btest)
    return _finish(x, torch.where(corner0, bmin, 0), corner0, r, nonmax)


def AGAST(image, threshold: int = 10, nonmaxSuppression: bool = True,
          type: int = OAST_9_16):
    """cv2-style AGAST: the KeyPoints of the first image."""
    x, _ = to_batched(image)
    score, keep = agast_dense(x[..., 0], int(threshold), type, bool(nonmaxSuppression))
    s = score[0].cpu().numpy()
    m = keep[0].cpu().numpy()
    ys, xs = np.nonzero(m)
    return [KeyPoint(float(xx), float(yy), 7.0, -1.0, float(s[yy, xx]))
            for yy, xx in zip(ys, xs)]


class AgastFeatureDetector:
    AGAST_5_8 = AGAST_5_8
    AGAST_7_12d = AGAST_7_12d
    AGAST_7_12s = AGAST_7_12s
    OAST_9_16 = OAST_9_16

    def __init__(self, threshold=10, nonmaxSuppression=True, type=OAST_9_16):
        self.threshold = threshold
        self.nonmaxSuppression = nonmaxSuppression
        self.type = type

    @staticmethod
    def create(threshold=10, nonmaxSuppression=True, type=OAST_9_16):
        return AgastFeatureDetector(threshold, nonmaxSuppression, type)

    def detect(self, image, mask=None):
        kps = AGAST(image, self.threshold, self.nonmaxSuppression, self.type)
        if mask is not None:
            m = np.asarray(mask)
            kps = [k for k in kps if m[int(k.pt[1]), int(k.pt[0])]]
        return kps

    def setThreshold(self, t):
        self.threshold = t

    def getThreshold(self):
        return self.threshold

    def setNonmaxSuppression(self, b):
        self.nonmaxSuppression = b

    def setType(self, t):
        self.type = t

    def getType(self):
        return self.type


def AgastFeatureDetector_create(threshold=10, nonmaxSuppression=True,
                                type=OAST_9_16):
    return AgastFeatureDetector(threshold, nonmaxSuppression, type)
