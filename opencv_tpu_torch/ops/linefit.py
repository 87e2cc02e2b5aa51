"""cv::fitLine (imgproc/src/linefit.cpp): least-squares and robust
(IRLS) line fitting for 2-D and 3-D point sets; twin of
``opencv_tpu/ops/linefit.py``, whose host numpy this module copies.  A
tensor of points (on any device) is read back once.

Host tier (tiny data, sequential IRLS with the reference's cv::RNG
restarts).  DIST_L2 is the closed form; the robust types replicate
linefit.cpp's weight functions, 20 random restarts x 30 IRLS rounds,
and convergence tests so results track the reference closely.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import constants as K

__all__ = ["fitLine"]


class _CvRNG:
    """cv::RNG MWC generator (core/include/opencv2/core.hpp RNG)."""

    A = 4164903690

    def __init__(self, state):
        self.state = state & 0xFFFFFFFFFFFFFFFF

    def next(self):
        self.state = ((self.state & 0xFFFFFFFF) * self.A
                      + (self.state >> 32)) & 0xFFFFFFFFFFFFFFFF
        return self.state & 0xFFFFFFFF

    def uniform(self, a, b):
        return a + self.next() % (b - a)


def _fit2d_wods(pts, w=None):
    if w is None:
        x, y = pts[:, 0].mean(), pts[:, 1].mean()
        x2 = (pts[:, 0] ** 2).mean()
        y2 = (pts[:, 1] ** 2).mean()
        xy = (pts[:, 0] * pts[:, 1]).mean()
    else:
        sw = w.sum()
        x = (w * pts[:, 0]).sum() / sw
        y = (w * pts[:, 1]).sum() / sw
        x2 = (w * pts[:, 0] ** 2).sum() / sw
        y2 = (w * pts[:, 1] ** 2).sum() / sw
        xy = (w * pts[:, 0] * pts[:, 1]).sum() / sw
    dx2, dy2, dxy = x2 - x * x, y2 - y * y, xy - x * y
    t = np.float32(math.atan2(2 * dxy, dx2 - dy2) / 2)
    return np.array([math.cos(t), math.sin(t), x, y], np.float32)


def _fit3d_wods(pts, w=None):
    if w is None:
        w = np.ones(len(pts), np.float64)
    sw = w.sum()
    c = (w[:, None] * pts).sum(0) / sw
    d = pts - c
    cov = (w[:, None, None] * (d[:, :, None] * d[:, None, :])).sum(0) / sw
    evals, evecs = np.linalg.eigh(cov)
    v = evecs[:, np.argmax(evals)]
    n = np.linalg.norm(v)
    v = v / (n if n else 1.0)
    return np.concatenate([v, c]).astype(np.float32)


def _dist2d(pts, line):
    px, py = line[2], line[3]
    nx, ny = line[1], -line[0]
    d = np.abs(nx * (pts[:, 0] - px) + ny * (pts[:, 1] - py))
    return d.astype(np.float32), float(d.sum())


def _dist3d(pts, line):
    v = line[:3]
    p0 = line[3:]
    d = pts - p0
    cr = np.cross(d, v)
    dd = np.sqrt((cr * cr).sum(1))
    return dd.astype(np.float32), float(dd.sum())


def _weights(dist_type, d, param):
    eps = 1e-6
    if dist_type == K.DIST_L1:
        return (1.0 / np.maximum(np.abs(d), eps)).astype(np.float32)
    if dist_type == K.DIST_L12:
        return (1.0 / np.sqrt(1 + d.astype(np.float64) ** 2 * 0.5)) \
            .astype(np.float32)
    if dist_type == K.DIST_HUBER:
        c = param if param > 0 else 1.345
        return np.where(d < c, 1.0, c / np.maximum(d, eps)) \
            .astype(np.float32)
    if dist_type == K.DIST_FAIR:
        c = (1 / 1.3998) if param == 0 else (1 / param)
        return (1.0 / (1 + d * c)).astype(np.float32)
    if dist_type == K.DIST_WELSCH:
        c = (1 / 2.9846) if param == 0 else (1 / param)
        return np.exp(-(d.astype(np.float64) ** 2) * c * c) \
            .astype(np.float32)
    raise ValueError(f"unknown distance type {dist_type}")


def _fit_robust(pts, dist_type, param, reps, aeps, wods, calc_dist):
    count = len(pts)
    EPS = count * np.finfo(np.float32).eps
    rdelta = reps if reps != 0 else 1.0
    adelta = aeps if aeps != 0 else 0.01
    rng = _CvRNG(0xFFFFFFFFFFFFFFFF)
    dims = pts.shape[1]
    best = np.zeros(2 * dims, np.float32)
    min_err = np.inf
    for _k in range(20):
        w = np.zeros(count, np.float32)
        i = 0
        while i < min(count, 10):
            j = rng.uniform(0, count)
            if w[j] < np.finfo(np.float32).eps:
                w[j] = 1.0
                i += 1
        line = wods(pts, w)
        lineprev = None
        err = np.inf
        for _i in range(30):
            if lineprev is not None:
                t = float(np.dot(line[:dims], lineprev[:dims]))
                t = max(-1.0, min(1.0, t))
                if abs(math.acos(t)) < adelta:
                    dmax = np.abs(line[dims:] - lineprev[dims:]).max()
                    if dmax < rdelta:
                        break
            r, err = calc_dist(pts, line)
            if err < min_err:
                min_err = err
                best = line.copy()
                if err < EPS:
                    break
            w = _weights(dist_type, r, param)
            sw = w.sum()
            if abs(sw) > np.finfo(np.float32).eps:
                w = (w / sw).astype(np.float32)
            else:
                w = np.ones(count, np.float32)
            lineprev = line
            line = wods(pts, w)
        if err < min_err:
            min_err = err
            best = line.copy()
        if min_err < EPS:
            break
    return best


def fitLine(points, distType: int, param: float, reps: float, aeps: float):
    """`cv::fitLine`: returns (4,1) [vx,vy,x0,y0] for 2-D input or (6,1)
    [vx,vy,vz,x0,y0,z0] for 3-D input, float32."""
    if isinstance(points, torch.Tensor):
        points = points.detach().cpu().numpy()
    pts = np.asarray(points, np.float64)
    pts = pts.reshape(-1, pts.shape[-1])
    dims = pts.shape[1]
    assert dims in (2, 3), "points must be 2-D or 3-D"
    pts32 = pts.astype(np.float32).astype(np.float64)
    if dims == 2:
        if distType == K.DIST_L2:
            line = _fit2d_wods(pts32)
        else:
            line = _fit_robust(pts32, distType, param, reps, aeps,
                               lambda p, w=None: _fit2d_wods(p, w),
                               _dist2d)
    else:
        if distType == K.DIST_L2:
            line = _fit3d_wods(pts32)
        else:
            line = _fit_robust(pts32, distType, param, reps, aeps,
                               lambda p, w=None: _fit3d_wods(p, w),
                               _dist3d)
    return line.reshape(-1, 1).astype(np.float32)
