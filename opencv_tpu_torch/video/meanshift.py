"""meanShift / CamShift on back-projection images (video/src/camshift.cpp);
the port's copy of ``opencv_tpu/video/meanshift.py``.  The probability
image is read to the host once (a tensor on any device, or an array), and
the window moments and the window-update loop run there in f64, as the
JAX package computes them."""

from __future__ import annotations

import math

import numpy as np

from ..core.arrays import to_host

__all__ = ["meanShift", "CamShift"]


def _mean_shift(prob, window, criteria):
    H, W = prob.shape[:2]
    x, y, w, h = [int(v) for v in window]
    max_iter = int(criteria[1]) if len(criteria) > 1 else 10
    eps = float(criteria[2]) if len(criteria) > 2 else 1.0
    eps = max(eps, 0.0)
    niters = 0
    for it in range(max(max_iter, 1)):
        niters = it + 1
        x = min(max(x, 0), W - 1)
        y = min(max(y, 0), H - 1)
        w2 = max(min(w, W - x), 1)
        h2 = max(min(h, H - y), 1)
        roi = prob[y:y + h2, x:x + w2]
        m00 = roi.sum()
        if m00 <= 0:
            break
        ys, xs = np.mgrid[0:h2, 0:w2]
        cx = (roi * xs).sum() / m00
        cy = (roi * ys).sum() / m00
        dx = int(np.rint(cx - w2 * 0.5))
        dy = int(np.rint(cy - h2 * 0.5))
        nx = min(max(x + dx, 0), W - w2)
        ny = min(max(y + dy, 0), H - h2)
        moved = math.hypot(nx - x, ny - y)
        x, y = nx, ny
        if moved <= eps:
            break
    return niters, (x, y, w, h)


def meanShift(probImage, window, criteria):
    """Returns (niters, window). window = (x, y, w, h)."""
    return _mean_shift(to_host(probImage).astype(np.float64), window, criteria)


def CamShift(probImage, window, criteria):
    """Returns (rotatedRect, window)."""
    prob = to_host(probImage).astype(np.float64)
    niters, window = _mean_shift(prob, window, criteria)
    x, y, w, h = window
    roi = prob[y:y + h, x:x + w]
    m00 = roi.sum()
    if m00 <= 0:
        return ((0.0, 0.0), (0.0, 0.0), 0.0), window
    ys, xs = np.mgrid[0:h, 0:w]
    cx = (roi * xs).sum() / m00
    cy = (roi * ys).sum() / m00
    mu20 = (roi * (xs - cx) ** 2).sum() / m00
    mu02 = (roi * (ys - cy) ** 2).sum() / m00
    mu11 = (roi * (xs - cx) * (ys - cy)).sum() / m00
    common = math.sqrt((mu20 - mu02) ** 2 + 4 * mu11 ** 2)
    theta = 0.5 * math.atan2(2 * mu11, mu20 - mu02)
    l1 = math.sqrt(max((mu20 + mu02 + common) * 0.5, 0)) * 4
    l2 = math.sqrt(max((mu20 + mu02 - common) * 0.5, 0)) * 4
    center = (x + cx, y + cy)
    rect = (center, (l1, l2), math.degrees(theta))
    return rect, window
