"""FAST keypoint detector (features2d/src/fast.cpp, fast_score.cpp), twin
of ``opencv_tpu/features2d/fast.py``.

The JAX package tests the contiguous arc with 2 × 16 × 9 boolean ANDs and
scores with a 16-step min/max ring over 16 int16 difference planes, about
750 elementwise ops per image.  The port computes the same integers with
fewer, larger ops on the stacked ring of u8 circle pixels ``R[k]``:

- the largest darker threshold of the arc starting at k is
  ``min_j d[k+j] = v - max_j R[k+j]`` over the arc's K+1 pixels (d = v - R),
  so ``q0 = v - min_k maxwin(R)[k]`` and ``q1 = v - max_k minwin(R)[k]``,
  with the circular window min/max taken by doubling (a few ops on the
  stacked planes).  ``cornerScore`` (fast_score.cpp) is
  ``max(q0, -q1) - 1``: its max over ``min(a_k, d_k)`` and
  ``min(a_k, d_{k+K+1})`` visits every window of K+1 exactly like this.
- a darker arc exists iff ``q0 > t``, a brighter one iff ``q1 < -t``.
- the table pre-gate (fast.cpp:205-222) pairs pixel[a] and pixel[b]; a pair
  passes for "darker" iff ``max(d_a, d_b) > t``, so the gate is
  ``v - max_pairs min(R_a, R_b) > t`` (and the twin for "brighter").  For
  the 16-pattern it is implied by the arc (an arc of 9 of 16 holds one of
  every pair k, k+8) and is skipped; for 12 and 8 its pairs wrap.

Only the interior (3 px from every edge, the reference's scan bounds)
can be a corner, and its circle never leaves the image, so no padding is
needed.  Output is a dense (score, mask) pair on the input's device; the
KeyPoint list is a host tail.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import constants as K
from ..core.arrays import to_batched
from .keypoint import KeyPoint

__all__ = ["FAST", "FastFeatureDetector", "FastFeatureDetector_create",
           "fast_response", "fast_keypoint_mask"]

# circle offsets (x, y), fast_score.cpp makeOffsets
_OFFSETS = {
    16: [(0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2),
         (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0),
         (-3, 1), (-2, 2), (-1, 3)],
    12: [(0, 2), (1, 2), (2, 1), (2, 0), (2, -1), (1, -2), (0, -2),
         (-1, -2), (-2, -1), (-2, 0), (-2, 1), (-1, 2)],
    8: [(0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0),
        (-1, 1)],
}
# the pre-gate's pixel pairs (fast.cpp:205-222), indices taken mod pattern
_GATE_PAIRS = ((0, 8), (2, 10), (4, 12), (6, 14), (1, 9), (3, 11), (5, 13), (7, 15))
# the reference's scan border, whatever the pattern (fast.cpp:99)
_BORDER = 3


def _circular_window(R, length: int, op):
    """``op``-reduction (torch.minimum or torch.maximum) of every circular
    window of `length` consecutive planes of R (p, ...): out[k] reduces
    R[k], ..., R[k+length-1 mod p]."""
    p = R.shape[0]
    m = torch.cat([R, R[:length - 1]])  # p + length - 1 planes
    span = 1
    while 2 * span <= length:  # m[k] reduces the `span` planes from k
        m = op(m[:-span], m[span:])
        span *= 2
    return op(m[:p], m[length - span:length - span + p])


def fast_response(img4d, threshold: int, pattern: int = 16):
    """Dense FAST score map for pattern sizes 16/12/8 (TYPE_9_16 /
    TYPE_7_12 / TYPE_5_8).

    img4d: (N, H, W, 1) u8 tensor.  Returns (score, is_corner) of shape
    (N, H, W, 1), int32 and bool; score is cornerScore<pattern> where
    is_corner, else 0.  Nothing within 3 px of an edge fires."""
    x = img4d
    N, H, W, C = x.shape
    assert C == 1
    score = torch.zeros((N, H, W, 1), dtype=torch.int32, device=x.device)
    is_corner = torch.zeros((N, H, W, 1), dtype=torch.bool, device=x.device)
    if H <= 2 * _BORDER or W <= 2 * _BORDER:
        return score, is_corner
    b = _BORDER
    Hc, Wc = H - 2 * b, W - 2 * b
    img = x[..., 0]
    v = img[:, b:H - b, b:W - b].to(torch.int16)
    R = torch.stack([img[:, b + oy:b + oy + Hc, b + ox:b + ox + Wc]
                     for ox, oy in _OFFSETS[pattern]])  # (p, N, Hc, Wc) u8
    arc = pattern // 2 + 1
    q0 = v - _circular_window(R, arc, torch.maximum).amin(0).to(torch.int16)
    q1 = v - _circular_window(R, arc, torch.minimum).amax(0).to(torch.int16)
    t = int(threshold)
    darker, brighter = q0 > t, q1 < -t
    if pattern != 16:
        pairs = [(a % pattern, c % pattern) for a, c in _GATE_PAIRS]
        lo = torch.stack([torch.minimum(R[a], R[c]) for a, c in pairs]).amax(0)
        hi = torch.stack([torch.maximum(R[a], R[c]) for a, c in pairs]).amin(0)
        darker &= (v - lo.to(torch.int16)) > t
        brighter &= (v - hi.to(torch.int16)) < -t
    corner = darker | brighter
    s = torch.where(corner, torch.maximum(q0, -q1) - 1, 0).to(torch.int32)
    score = F.pad(s, (b, b, b, b))[..., None]
    is_corner = F.pad(corner, (b, b, b, b))[..., None]
    return score, is_corner


def fast_keypoint_mask(img4d, threshold: int, nonmax: bool = True, pattern: int = 16):
    """(score, keypoint mask) after optional 3×3 strict NMS on the score
    map (fast.cpp nonmax over per-row score buffers): a corner is kept where
    its score exceeds all eight neighbours' (0 outside the image)."""
    score, is_corner = fast_response(img4d, threshold, pattern)
    if not nonmax:
        return score, is_corner
    s = score[..., 0].to(torch.int16)  # scores lie in -1..254
    N, H, W = s.shape
    p = F.pad(s, (1, 1, 1, 1))
    row3 = torch.maximum(torch.maximum(p[:, :, :W], p[:, :, 1:W + 1]), p[:, :, 2:])
    neigh = torch.maximum(torch.maximum(row3[:, :H], row3[:, 2:]),
                          torch.maximum(p[:, 1:H + 1, :W], p[:, 1:H + 1, 2:]))
    keep = is_corner & (s > neigh)[..., None]
    return score, keep


_TYPES = {K.FAST_FEATURE_DETECTOR_TYPE_9_16: 16,
          K.FAST_FEATURE_DETECTOR_TYPE_7_12: 12,
          K.FAST_FEATURE_DETECTOR_TYPE_5_8: 8}


def FAST(image, threshold: int = 10, nonmaxSuppression: bool = True,
         type: int = K.FAST_FEATURE_DETECTOR_TYPE_9_16):
    """cv2-style FAST returning a KeyPoint list (of the first image)."""
    x, _ = to_batched(image)
    score, keep = fast_keypoint_mask(x, threshold, nonmaxSuppression, _TYPES[type])
    s = score[0, :, :, 0].cpu().numpy()
    m = keep[0, :, :, 0].cpu().numpy()
    ys, xs = np.nonzero(m)
    return [KeyPoint(float(xx), float(yy), 7.0, -1.0, float(s[yy, xx]))
            for yy, xx in zip(ys, xs)]


class FastFeatureDetector:
    def __init__(self, threshold=10, nonmaxSuppression=True,
                 type=K.FAST_FEATURE_DETECTOR_TYPE_9_16):
        self.threshold = threshold
        self.nonmax = nonmaxSuppression
        self.type = type

    def detect(self, image, mask=None):
        kps = FAST(image, self.threshold, self.nonmax, self.type)
        if mask is not None:
            mk = np.asarray(mask)
            kps = [k for k in kps if mk[int(k.pt[1]), int(k.pt[0])]]
        return kps

    def setThreshold(self, t):
        self.threshold = t

    def getThreshold(self):
        return self.threshold


def FastFeatureDetector_create(threshold=10, nonmaxSuppression=True,
                               type=K.FAST_FEATURE_DETECTOR_TYPE_9_16):
    return FastFeatureDetector(threshold, nonmaxSuppression, type)
