"""KeyPoint container + KeyPointsFilter utilities
(features2d/src/keypoint.cpp), a copy of
``opencv_tpu/features2d/keypoint.py``.

Host-side Python and numpy: the bridge from the detectors' device output
to the cv2 KeyPoint API.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["KeyPoint", "retain_best", "run_by_image_border",
           "KeyPoint_convert", "KeyPoint_overlap"]


class KeyPoint:
    """cv2.KeyPoint-compatible plain container."""

    __slots__ = ("pt", "size", "angle", "response", "octave",
                 "class_id", "_oct_pos", "_scl_octv")

    def __init__(self, x=0.0, y=0.0, size=0.0, angle=-1.0, response=0.0,
                 octave=0, class_id=-1):
        self.pt = (float(x), float(y))
        self.size = float(size)
        self.angle = float(angle)
        self.response = float(response)
        self.octave = int(octave)
        self.class_id = int(class_id)

    def __repr__(self):
        return (f"KeyPoint(pt={self.pt}, size={self.size}, "
                f"angle={self.angle}, response={self.response}, "
                f"octave={self.octave})")


def retain_best(kps: list, n_points: int) -> list:
    """KeyPointsFilter::retainBest (keypoint.cpp): keep the n strongest;
    ties at the cut response are ALL kept (the reference nth_elements then
    extends over equal responses)."""
    if n_points >= len(kps) or n_points <= 0:
        return kps
    kps = sorted(kps, key=lambda k: -k.response)
    cut = kps[n_points - 1].response
    out = [k for k in kps if k.response > cut]
    out += [k for k in kps if k.response == cut]
    return out


def run_by_image_border(kps: list, size, border: int) -> list:
    """KeyPointsFilter::runByImageBorder."""
    w, h = size
    return [k for k in kps
            if border <= k.pt[0] < w - border and border <= k.pt[1] < h - border]


def KeyPoint_convert(keypoints, keypointIndexes=None):
    """cv::KeyPoint::convert — keypoints→(N,2) float32 points (or
    points→keypoints when given an array of 2D points)."""
    if len(keypoints) and not hasattr(keypoints[0], "pt"):
        pts = np.asarray(keypoints, np.float32).reshape(-1, 2)
        return [KeyPoint(float(x), float(y), 1.0) for x, y in pts]
    if keypointIndexes is not None:
        keypoints = [keypoints[i] for i in np.asarray(keypointIndexes,
                                                      int).ravel()]
    return np.asarray([kp.pt for kp in keypoints],
                      np.float32).reshape(-1, 2)


def KeyPoint_overlap(kp1, kp2) -> float:
    """cv::KeyPoint::overlap (keypoint.cpp): intersection-over-union of
    the two keypoint circles (radius = size/2)."""
    a, b = kp1.size * 0.5, kp2.size * 0.5
    a2, b2 = a * a, b * b
    dx = kp1.pt[0] - kp2.pt[0]
    dy = kp1.pt[1] - kp2.pt[1]
    c = math.hypot(dx, dy)
    ovrl = 0.0
    if c < a + b:
        c2 = c * c
        if c > abs(a - b):
            ca = (a2 + c2 - b2) / (2.0 * a * c)
            cb = (b2 + c2 - a2) / (2.0 * b * c)
            ca = min(1.0, max(-1.0, ca))
            cb = min(1.0, max(-1.0, cb))
            inter = (a2 * math.acos(ca) + b2 * math.acos(cb)
                     - 0.5 * math.sqrt(abs((a + b + c) * (-a + b + c)
                                           * (a - b + c) * (a + b - c))))
        else:
            inter = math.pi * min(a2, b2)
        union = math.pi * (a2 + b2) - inter
        ovrl = inter / union if union > 0 else 0.0
    return float(np.float32(ovrl))
