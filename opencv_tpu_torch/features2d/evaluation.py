"""features2d evaluation utilities (features2d/src/evaluation.cpp):
evaluateFeatureDetector (detector repeatability under a homography),
computeRecallPrecisionCurve, getRecall, getNearestPoint; the port's copy
of ``opencv_tpu/features2d/evaluation.py`` (host numpy, as there).

The reference's elliptic-region overlap model: keypoints become isotropic
ellipses a·x² + 2b·xy + c·y² = 1, projected through the homography's local
affine linearization; overlap is a rasterized union/intersection count at
dr = min_extent/50, with greedy one-to-one matching by descending overlap.
Keypoint lists and curves are host objects; images may be tensors (only
their sizes are read).
"""

from __future__ import annotations

import numpy as np

from ..core.arrays import to_host

__all__ = ["evaluateFeatureDetector", "computeRecallPrecisionCurve",
           "getRecall", "getNearestPoint"]


def _solve_quadratic_roots(b, c):
    # x^2 - b x + c = 0 (monic), returns (x1, x2)
    d = b * b - 4 * c
    d = max(d, 0.0)
    s = np.sqrt(d)
    return (b + s) / 2, (b - s) / 2


class _EKP:
    __slots__ = ("center", "ellipse", "axes", "bbox")

    def __init__(self, center, ellipse):
        self.center = np.asarray(center, np.float64)
        self.ellipse = np.asarray(ellipse, np.float64)  # (a, b, c)
        a, b, c = self.ellipse
        ac_b2 = a * c - b * b
        x1, x2 = _solve_quadratic_roots(a + c, ac_b2)
        self.axes = (1.0 / np.sqrt(x1), 1.0 / np.sqrt(x2))
        self.bbox = (np.sqrt(c / ac_b2), np.sqrt(a / ac_b2))


def _from_keypoints(kps):
    out = []
    for kp in kps:
        rad = kp.size / 2
        fac = 1.0 / (rad * rad)
        out.append(_EKP(kp.pt, (fac, 0.0, fac)))
    return out


def _apply_h(H, p):
    z = H[2, 0] * p[0] + H[2, 1] * p[1] + H[2, 2]
    if z:
        z = 1.0 / z
        return np.array([(H[0, 0] * p[0] + H[0, 1] * p[1] + H[0, 2]) * z,
                         (H[1, 0] * p[0] + H[1, 1] * p[1] + H[1, 2]) * z])
    return np.array([np.finfo(np.float64).max] * 2)


def _linearize_at(H, p):
    p1 = H[0, 0] * p[0] + H[0, 1] * p[1] + H[0, 2]
    p2 = H[1, 0] * p[0] + H[1, 1] * p[1] + H[1, 2]
    p3 = H[2, 0] * p[0] + H[2, 1] * p[1] + H[2, 2]
    A = np.full((2, 2), np.finfo(np.float64).max)
    if p3:
        p3_2 = p3 * p3
        A[0, 0] = H[0, 0] / p3 - p1 * H[2, 0] / p3_2
        A[0, 1] = H[0, 1] / p3 - p1 * H[2, 1] / p3_2
        A[1, 0] = H[1, 0] / p3 - p2 * H[2, 0] / p3_2
        A[1, 1] = H[1, 1] / p3 - p2 * H[2, 1] / p3_2
    return A


def _project(ekp, H):
    dst_c = _apply_h(H, ekp.center)
    a, b, c = ekp.ellipse
    M = np.array([[a, b], [b, c]])
    invM = np.linalg.inv(M)
    A = _linearize_at(H, ekp.center)
    dstM = np.linalg.inv(A @ invM @ A.T)
    return _EKP(dst_c, (dstM[0, 0], dstM[0, 1], dstM[1, 1]))


def _filter_by_size(kps, size):
    w, h = size
    return [k for k in kps
            if (k.center[0] + k.bbox[0] < w and k.center[0] - k.bbox[0] > 0
                and k.center[1] + k.bbox[1] < h
                and k.center[1] - k.bbox[1] > 0)]


def _pair_overlap(kp1a, kp2a, diff):
    """Rasterized union/intersection of two origin-centred conics
    (IntersectAreaCounter, evaluation.cpp)."""
    maxx = int(np.ceil(max(kp1a.bbox[0], diff[0] + kp2a.bbox[0])))
    minx = int(np.floor(min(-kp1a.bbox[0], diff[0] - kp2a.bbox[0])))
    maxy = int(np.ceil(max(kp1a.bbox[1], diff[1] + kp2a.bbox[1])))
    miny = int(np.floor(min(-kp1a.bbox[1], diff[1] - kp2a.bbox[1])))
    mina = min(maxx - minx, maxy - miny)
    dr = mina / 50.0
    if dr <= np.finfo(np.float32).eps:
        return 0.0
    N = int(np.floor((maxx - minx) / dr))
    xs = np.float32(minx) + np.arange(N + 1, dtype=np.float32) * np.float32(dr)
    # replicate `for ry1 = miny; ry1 <= maxy; ry1 += dr` exactly
    # (float32 accumulation decides the count)
    ny = 0
    ry = np.float32(miny)
    while ry <= np.float32(maxy):
        ny += 1
        ry = np.float32(ry + np.float32(dr))
    ys = np.cumsum(np.concatenate([[np.float32(miny)],
                                   np.full(ny - 1, np.float32(dr),
                                           np.float32)])).astype(np.float32)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    X2 = X - np.float32(diff[0])
    Y2 = Y - np.float32(diff[1])
    a1, b1, c1 = kp1a.ellipse
    a2, b2, c2 = kp2a.ellipse
    e1 = a1 * X * X + 2 * b1 * X * Y + c1 * Y * Y
    e2 = a2 * X2 * X2 + 2 * b2 * X2 * Y2 + c2 * Y2 * Y2
    in1 = e1 < 1
    in2 = e2 < 1
    bna = int((in1 & in2).sum())
    bua = int((in1 | in2).sum())
    return (bna / bua) if bna > 0 else 0.0


def _one_to_one_overlaps(kps1, kps2t, common_part, min_overlap):
    overlaps = []
    for i1, kp1 in enumerate(kps1):
        max_dist = np.sqrt(kp1.axes[0] * kp1.axes[1])
        fac = 30.0 / max_dist if common_part else 3.0
        max_dist = max_dist * 4
        fac = 1.0 / (fac * fac)
        kp1a = _EKP(kp1.center, fac * kp1.ellipse)
        for i2, kp2 in enumerate(kps2t):
            diff = kp2.center - kp1.center
            if np.hypot(*diff) < max_dist:
                kp2a = _EKP(kp2.center, fac * kp2.ellipse)
                ov = _pair_overlap(kp1a, kp2a, diff)
                if ov >= min_overlap:
                    overlaps.append((ov, i1, i2))
    # sort by DESCENDING overlap (SIdx::operator< is ov > other.ov)
    overlaps.sort(key=lambda t: -t[0])
    used1, used2, out = set(), set(), []
    for (ov, i1, i2) in overlaps:
        if i1 in used1 or i2 in used2:
            continue
        used1.add(i1)
        used2.add(i2)
        out.append((ov, i1, i2))
    return out


def evaluateFeatureDetector(img1, img2, H1to2, keypoints1, keypoints2,
                            fdetector=None):
    """Returns (repeatability, correspCount) like cv2's wrapper."""
    img1 = to_host(img1)
    img2 = to_host(img2)
    H = to_host(H1to2).astype(np.float64).reshape(3, 3)
    if (not keypoints1) and fdetector is not None:
        keypoints1 = fdetector.detect(img1)
    if (not keypoints2) and fdetector is not None:
        keypoints2 = fdetector.detect(img2)
    k1 = _from_keypoints(keypoints1)
    k2 = _from_keypoints(keypoints2)
    k1t = [_project(k, H) for k in k1]
    H2to1 = np.linalg.inv(H)
    k2t = [_project(k, H2to1) for k in k2]
    sz1 = (img1.shape[1], img1.shape[0])
    sz2 = (img2.shape[1], img2.shape[0])
    k1 = _filter_by_size(k1, sz1)
    k2t = _filter_by_size(k2t, sz1)
    k2 = _filter_by_size(k2, sz2)
    min_count = min(len(k1), len(k2t))
    overlaps = _one_to_one_overlaps(k1, k2t, True, 1.0 - 0.4)
    if not overlaps:
        return -1.0, -1
    corresp = len(overlaps)
    rep = corresp / min_count if min_count else -1.0
    return float(rep), corresp


def computeRecallPrecisionCurve(matches1to2, correctMatches1to2Mask):
    all_m = []
    corresp = 0
    for row, mrow in zip(matches1to2, correctMatches1to2Mask):
        for m, ok in zip(row, np.asarray(mrow).reshape(-1)):
            all_m.append((m.distance, bool(ok)))
            corresp += 1 if ok else 0
    all_m.sort(key=lambda t: t[0])
    curve = []
    ncorrect = nfalse = 0
    for (_, ok) in all_m:
        if ok:
            ncorrect += 1
        else:
            nfalse += 1
        r = ncorrect / corresp if corresp else -1.0
        p = ncorrect / (ncorrect + nfalse) if ncorrect + nfalse else -1.0
        curve.append((1 - p, r))
    return np.asarray(curve, np.float32)


def getNearestPoint(recallPrecisionCurve, l_precision):
    if not (0 <= l_precision <= 1):
        return -1
    best, bestd = -1, np.inf
    for i, (x, _y) in enumerate(np.asarray(recallPrecisionCurve)
                                .reshape(-1, 2)):
        d = abs(l_precision - x)
        if d <= bestd:
            best, bestd = i, d
    return best


def getRecall(recallPrecisionCurve, l_precision):
    i = getNearestPoint(recallPrecisionCurve, l_precision)
    if i < 0:
        return -1.0
    return float(np.asarray(recallPrecisionCurve).reshape(-1, 2)[i, 1])
