"""Small-geometry tail APIs (imgproc 5.x surface): rectangleIntersectionArea,
getClosestEllipsePoints, phaseCorrelateIterative, filter2Dp,
findContoursLinkRuns; twin of ``opencv_tpu/ops/geometry_extra.py``.

The first two are the JAX package's host numpy, copied.
phaseCorrelateIterative and filter2Dp run the port's phaseCorrelate and
filter2D on the input's device.  findContoursLinkRuns labels the image and
its background on the device, finds every row's runs of both label maps in
one pass (where a label starts and ends along a row), reads the runs back
once and groups them by label on the host, where the JAX package builds a
full-frame mask per component and walks its rows in Python.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.arrays import as_tensor, to_batched
from .filter import filter2D
from .misc import phaseCorrelate
from .shape import connectedComponents

__all__ = ["rectangleIntersectionArea", "getClosestEllipsePoints",
           "phaseCorrelateIterative", "filter2Dp",
           "findContoursLinkRuns"]


def rectangleIntersectionArea(a, b) -> float:
    """Intersection area of two axis-aligned (x, y, w, h) rects."""
    ax, ay, aw, ah = map(float, a)
    bx, by, bw, bh = map(float, b)
    w = min(ax + aw, bx + bw) - max(ax, bx)
    h = min(ay + ah, by + bh) - max(ay, by)
    return max(w, 0.0) * max(h, 0.0)


def getClosestEllipsePoints(ellipse_params, points):
    """For each query point, the nearest point on the ellipse boundary
    (Newton iteration on the parametric angle)."""
    (cx, cy), (w, h), ang = ellipse_params
    a, b = w / 2.0, h / 2.0
    th = np.deg2rad(ang)
    c, s = np.cos(th), np.sin(th)
    if isinstance(points, torch.Tensor):
        points = points.detach().cpu().numpy()
    pts = np.asarray(points, np.float64).reshape(-1, 2)
    # rotate queries into the ellipse frame
    dx = pts[:, 0] - cx
    dy = pts[:, 1] - cy
    qx = c * dx + s * dy
    qy = -s * dx + c * dy
    t = np.arctan2(qy * a, qx * b)
    for _ in range(60):
        ct, st = np.cos(t), np.sin(t)
        ex, ey = a * ct, b * st
        # d/dt of squared distance
        f = (ex - qx) * (-a * st) + (ey - qy) * (b * ct)
        fp = ((-a * st) ** 2 + (ex - qx) * (-a * ct)
              + (b * ct) ** 2 + (ey - qy) * (-b * st))
        step = np.where(np.abs(fp) > 1e-12, f / fp, 0.0)
        t = t - np.clip(step, -0.5, 0.5)
    ct, st = np.cos(t), np.sin(t)
    ex, ey = a * ct, b * st
    ox = c * ex - s * ey + cx
    oy = s * ex + c * ey + cy
    return np.stack([ox, oy], 1).astype(np.float32).reshape(-1, 1, 2)


def phaseCorrelateIterative(src1, src2, L2size: int = 5,
                            maxIters: int = 50):
    """cv::phaseCorrelateIterative — the subpixel phase correlation of the
    two images (the JAX package stops after its first pass), on their
    device."""
    (dx, dy), _resp = phaseCorrelate(as_tensor(src1).to(torch.float32),
                                     as_tensor(src2).to(torch.float32))
    return float(dx), float(dy)


def filter2Dp(src, kernel, anchorX: int = -1, anchorY: int = -1,
              borderType: int = 4, ddepth: int = -1, scale: float = 1.0,
              shift: float = 0.0):
    """cv::filter2Dp — filter2D with split anchor and affine finishing
    (out = filter2D(src, kernel) * scale + shift), in f64 on the input's
    device."""
    x = as_tensor(src)
    kernel = kernel if isinstance(kernel, torch.Tensor) else np.asarray(kernel)
    out = filter2D(x, ddepth, kernel, anchor=(anchorX, anchorY),
                   borderType=borderType).to(torch.float64)
    if scale != 1.0 or shift != 0.0:
        out = out * scale + shift
    if ddepth in (-1, None):
        if x.dtype == torch.uint8:
            return torch.round(out).clamp(0, 255).to(torch.uint8)
        return out.to(x.dtype)
    return out.to(torch.float32 if ddepth == 5 else torch.float64)


def _label_runs(labels: torch.Tensor) -> torch.Tensor:
    """Every row's runs of equal non-zero labels of an (H, W) label map, in
    raster order: an (R, 4) int64 tensor of (label, y, x first, x last)."""
    lab = labels.to(torch.int64)
    pad = torch.nn.functional.pad(lab, (1, 1))
    fg = lab != 0
    start = torch.nonzero(fg & (lab != pad[:, :-2]))
    end = torch.nonzero(fg & (lab != pad[:, 2:]))
    return torch.stack([lab[start[:, 0], start[:, 1]], start[:, 0], start[:, 1], end[:, 1]], 1)


def _grouped(runs: np.ndarray) -> list:
    """Split raster-ordered (label, y, x0, x1) runs by label, labels 1.. in
    order, each group's runs still in raster order."""
    runs = runs[np.argsort(runs[:, 0], kind="stable")]
    cut = np.flatnonzero(np.diff(runs[:, 0])) + 1
    return np.split(runs, cut) if len(runs) else []


def _chain(runs: np.ndarray, outer: bool) -> np.ndarray:
    """One component's contour from its raster-ordered runs: an outer
    contour walks L(top), R rows top→bottom, then L rows bottom→top; a hole
    walks R+1 of the top row's first run, L−1 rows top→bottom, then R+1
    rows bottom→top."""
    y = runs[:, 1]
    first = np.r_[True, y[1:] != y[:-1]]
    last = np.r_[y[1:] != y[:-1], True]
    ys = y[first]
    left, right = runs[first, 2], runs[last, 3]
    if outer:
        pts = [(left[0], ys[0])] + list(zip(right, ys)) + list(zip(left[1:], ys[1:]))[::-1]
    else:
        pts = ([(runs[0, 3] + 1, ys[0])] + list(zip(left - 1, ys))
               + list(zip(right[1:] + 1, ys[1:]))[::-1])
    return np.asarray(pts, np.int32).reshape(-1, 1, 2)


def findContoursLinkRuns(image):
    """cv::findContoursLinkRuns: run-endpoint contours.  Outer contour
    of a component walks L(top), R rows top→bottom, then L rows
    bottom→top; holes walk R+1(top), L−1 rows top→bottom, then R+1
    rows bottom→top (observed wheel contract).  Hierarchy is a flat
    next/prev chain with holes listed after the outer contours."""
    x, _ = to_batched(image)
    a = (x[0, :, :, 0] != 0).to(torch.uint8)
    H, W = a.shape
    _, labels = connectedComponents(a * 255, 8)
    _, blab = connectedComponents((1 - a) * 255, 4)
    fg_runs, bg_runs = _label_runs(labels), _label_runs(blab)
    host = torch.cat([fg_runs, bg_runs]).cpu().numpy()
    fg, bg = host[:len(fg_runs)], host[len(fg_runs):]
    contours = [_chain(r, True) for r in _grouped(fg)]
    # holes: background components not touching the border
    for r in _grouped(bg):
        if (r[:, 1].min() == 0 or r[:, 1].max() == H - 1 or r[:, 2].min() == 0
                or r[:, 3].max() == W - 1):
            continue
        contours.append(_chain(r, False))
    n = len(contours)
    hier = np.full((1, n, 4), -1, np.int32)
    for i in range(n):
        if i + 1 < n:
            hier[0, i, 0] = i + 1
        if i > 0:
            hier[0, i, 1] = i - 1
    return contours, hier
