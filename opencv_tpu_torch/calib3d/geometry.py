"""calib3d core: camera geometry (calib3d/src/calibration.cpp,
fundam.cpp, solvepnp.cpp, undistort.dispatch.cpp), twin of
``opencv_tpu/calib3d/geometry.py``.

Dense per-pixel work (initUndistortRectifyMap, undistort) builds its maps
as float64 torch on the device, in ``_distort``'s order of operations
(only +, × and ÷, so the card and the CPU agree bit for bit), and runs the
port's remap there.  The tiny-N estimation problems (homography and
fundamental RANSAC, PnP, rectification) stay host numpy float64 with the
JAX package's ``default_rng`` seeds, so they draw the same samples.

One divergence: the JAX package takes ``r2 ** 3`` with numpy's power,
which is not the correctly rounded cube and not ``r2 * r2 * r2`` either;
the device maps take the product.  The float32 maps come out equal (at
1080p too); the float64 maps ``undistort`` uses differ by an ulp on a few
pixels.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.warp import remap as _remap
from .. import constants as K

__all__ = ["Rodrigues", "projectPoints", "undistortPoints",
           "initUndistortRectifyMap", "undistort", "findHomography",
           "findFundamentalMat", "solvePnP", "solveP3P", "triangulatePoints",
           "computeCorrespondEpilines", "perspectiveTransform",
           "getOptimalNewCameraMatrix",
           "RANSAC", "LMEDS", "FM_8POINT", "FM_RANSAC",
           "USAC_DEFAULT", "USAC_PARALLEL", "USAC_FM_8PTS", "USAC_FAST",
           "USAC_ACCURATE", "USAC_PROSAC", "USAC_MAGSAC",
           "SOLVEPNP_ITERATIVE", "SOLVEPNP_EPNP", "SOLVEPNP_P3P",
           "SOLVEPNP_AP3P", "SOLVEPNP_IPPE", "SOLVEPNP_IPPE_SQUARE",
           "SOLVEPNP_SQPNP", "SOLVEPNP_MAX_COUNT"]

RANSAC = 8
LMEDS = 4
FM_7POINT = 1
FM_8POINT = 2
FM_RANSAC = 8
# 5.0 wheel numbering (the installed oracle; the 4.x reference's
# DLS/UPNP broken-implementation aliases were dropped and the enum tail
# renumbered — calib3d.hpp SolvePnPMethod).  tests/test_surface.py
# enforces value equality with the wheel.
SOLVEPNP_ITERATIVE = 0
SOLVEPNP_EPNP = 1
SOLVEPNP_P3P = 2
SOLVEPNP_AP3P = 3
SOLVEPNP_IPPE = 4
SOLVEPNP_IPPE_SQUARE = 5
SOLVEPNP_SQPNP = 6
SOLVEPNP_MAX_COUNT = 7
# USAC flags (usac/ in the reference) — here they run the LO-RANSAC
# path: standard RANSAC + iterated local optimization on inliers.
USAC_DEFAULT = 32
USAC_PARALLEL = 33
USAC_FM_8PTS = 34
USAC_FAST = 35
USAC_ACCURATE = 36
USAC_PROSAC = 37
USAC_MAGSAC = 38


def Rodrigues(src, jacobian=None):
    """Rotation vector ↔ matrix (calibration.cpp cvRodrigues2)."""
    a = np.asarray(src, np.float64)
    if a.size == 3:  # vector → matrix
        r = a.reshape(3)
        theta = np.linalg.norm(r)
        if theta < 1e-12:
            return np.eye(3), None
        k = r / theta
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = np.eye(3) + math.sin(theta) * Kx + (1 - math.cos(theta)) * (Kx @ Kx)
        return R, None
    # matrix → vector
    R = a.reshape(3, 3)
    ct = (np.trace(R) - 1) / 2
    ct = min(max(ct, -1.0), 1.0)
    theta = math.acos(ct)
    if theta < 1e-12:
        return np.zeros((3, 1)), None
    if abs(theta - math.pi) < 1e-6:
        # theta ~ pi: extract axis from R + I
        A = (R + np.eye(3)) / 2
        k = np.sqrt(np.maximum(np.diag(A), 0))
        # fix signs
        if k[0] > 0:
            k[1] = math.copysign(k[1], A[0, 1])
            k[2] = math.copysign(k[2], A[0, 2])
        return (k * theta).reshape(3, 1), None
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    v = v / (2 * math.sin(theta))
    return (v * theta).reshape(3, 1), None


def _distort(xn, yn, dist):
    """The pinhole distortion of normalized coordinates, on numpy arrays
    (the JAX package's powers) or on tensors (products)."""
    d = np.zeros(12)
    dist = np.asarray(dist, np.float64).reshape(-1) if dist is not None else np.zeros(5)
    d[:len(dist)] = dist
    k1, k2, p1, p2, k3, k4, k5, k6 = (float(v) for v in d[:8])
    r2 = xn * xn + yn * yn
    if isinstance(r2, torch.Tensor):
        sq, cube = r2 * r2, r2 * r2 * r2
    else:
        sq, cube = r2 ** 2, r2 ** 3
    radial = (1 + k1 * r2 + k2 * sq + k3 * cube) \
        / (1 + k4 * r2 + k5 * sq + k6 * cube)
    xd = xn * radial + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn
    return xd, yd


def projectPoints(objectPoints, rvec, tvec, cameraMatrix, distCoeffs,
                  jacobian=None):
    """`cv::projectPoints` (pinhole + radial/tangential distortion)."""
    obj = np.asarray(objectPoints, np.float64).reshape(-1, 3)
    R, _ = Rodrigues(np.asarray(rvec, np.float64))
    t = np.asarray(tvec, np.float64).reshape(3)
    Km = np.asarray(cameraMatrix, np.float64).reshape(3, 3)
    pc = obj @ R.T + t
    xn = pc[:, 0] / pc[:, 2]
    yn = pc[:, 1] / pc[:, 2]
    xd, yd = _distort(xn, yn, distCoeffs)
    u = Km[0, 0] * xd + Km[0, 2] + Km[0, 1] * yd
    v = Km[1, 1] * yd + Km[1, 2]
    return np.stack([u, v], axis=1).reshape(-1, 1, 2).astype(np.float64), None


def undistortPoints(src, cameraMatrix, distCoeffs, R=None, P=None,
                    criteria=(3, 5, 0.01)):
    """Iterative distortion inversion (undistort.dispatch.cpp:~390)."""
    pts = np.asarray(src, np.float64).reshape(-1, 2)
    Km = np.asarray(cameraMatrix, np.float64).reshape(3, 3)
    x = (pts[:, 0] - Km[0, 2]) / Km[0, 0]
    y = (pts[:, 1] - Km[1, 2]) / Km[1, 1]
    x0, y0 = x.copy(), y.copy()
    iters = int(criteria[1]) if len(criteria) > 1 else 5
    for _ in range(iters):
        xd, yd = _distort(x, y, distCoeffs)
        x = x - (xd - x0)
        y = y - (yd - y0)
    if R is not None:
        Rm = np.asarray(R, np.float64).reshape(3, 3)
        w = Rm[2, 0] * x + Rm[2, 1] * y + Rm[2, 2]
        xr = (Rm[0, 0] * x + Rm[0, 1] * y + Rm[0, 2]) / w
        yr = (Rm[1, 0] * x + Rm[1, 1] * y + Rm[1, 2]) / w
        x, y = xr, yr
    if P is not None:
        Pm = np.asarray(P, np.float64).reshape(3, -1)
        x = Pm[0, 0] * x + Pm[0, 1] * y + Pm[0, 2]
        y = Pm[1, 0] * x0 * 0 + Pm[1, 1] * y + Pm[1, 2]  # Pm[1,0] is 0
    return np.stack([x, y], axis=1).reshape(-1, 1, 2).astype(np.float32)


def _undistort_maps_f64(cameraMatrix, distCoeffs, R, newCameraMatrix, size, device=None):
    """The (h, w) float64 maps as tensors on `device` (the CPU by default)."""
    w, h = int(size[0]), int(size[1])
    Km = np.asarray(cameraMatrix, np.float64).reshape(3, 3)
    # a (3, 4) projection (stereoRectify's P1, P2) counts by its first
    # three columns, as in cv2; the JAX package takes (3, 3) only
    NK = (np.asarray(newCameraMatrix, np.float64).reshape(3, -1)[:, :3]
          if newCameraMatrix is not None else Km)
    Rm = (np.asarray(R, np.float64).reshape(3, 3) if R is not None
          else np.eye(3))
    A = [[float(v) for v in row] for row in np.linalg.inv(NK @ Rm)]
    Kf = [[float(v) for v in row] for row in Km]
    us = torch.arange(w, dtype=torch.float64, device=device)[None, :].expand(h, w)
    vs = torch.arange(h, dtype=torch.float64, device=device)[:, None].expand(h, w)
    x = A[0][0] * us + A[0][1] * vs + A[0][2]
    y = A[1][0] * us + A[1][1] * vs + A[1][2]
    z = A[2][0] * us + A[2][1] * vs + A[2][2]
    xn = x / z
    yn = y / z
    xd, yd = _distort(xn, yn, distCoeffs)
    mapx = Kf[0][0] * xd + Kf[0][1] * yd + Kf[0][2]
    mapy = Kf[1][1] * yd + Kf[1][2]
    return mapx, mapy


def initUndistortRectifyMap(cameraMatrix, distCoeffs, R, newCameraMatrix,
                            size, m1type=K.CV_32F, device=None):
    """Dense forward-distortion maps (undistort.dispatch.cpp
    initUndistortRectifyMap) as float32 tensors for `remap`, built on
    `device` (the CPU by default)."""
    mapx, mapy = _undistort_maps_f64(cameraMatrix, distCoeffs, R,
                                     newCameraMatrix, size, device)
    return mapx.to(torch.float32), mapy.to(torch.float32)


def undistort(src, cameraMatrix, distCoeffs, dst=None, newCameraMatrix=None):
    """`cv::undistort`: double-precision internal maps + remap, both on
    the image's device (the reference computes per-pixel doubles, not
    the f32 public maps)."""
    img = src if isinstance(src, torch.Tensor) else torch.from_numpy(np.asarray(src))
    h, w = img.shape[:2]
    mapx, mapy = _undistort_maps_f64(cameraMatrix, distCoeffs, None,
                                     newCameraMatrix, (w, h), img.device)
    return _remap(img, mapx, mapy, K.INTER_LINEAR)


def getOptimalNewCameraMatrix(cameraMatrix, distCoeffs, imageSize, alpha,
                              newImgSize=None, centerPrincipalPoint=False):
    """calib3d/src/calibration_base.cpp:1565: interpolate between the
    projections that map the inscribed / circumscribed undistort
    rectangles to the viewport."""
    Km = np.asarray(cameraMatrix, np.float64).reshape(3, 3).copy()
    w, h = imageSize
    nw, nh = newImgSize if newImgSize and newImgSize[0] else (w, h)
    inner, outer = _undistort_rectangles(Km, distCoeffs, None, None,
                                         (w, h))
    if centerPrincipalPoint:
        cx0 = Km[0, 2]
        cy0 = Km[1, 2]
        cx = (nw - 1) * 0.5
        cy = (nh - 1) * 0.5
        innK, outK = _undistort_rectangles(Km, distCoeffs, None, Km,
                                           (w, h))
        s0 = max(cx / (cx0 - innK[0]), cy / (cy0 - innK[1]),
                 cx / (innK[0] + innK[2] - cx0),
                 cy / (innK[1] + innK[3] - cy0))
        s1 = min(cx / (cx0 - outK[0]), cy / (cy0 - outK[1]),
                 cx / (outK[0] + outK[2] - cx0),
                 cy / (outK[1] + outK[3] - cy0))
        s = s0 * (1 - alpha) + s1 * alpha
        M = Km.copy()
        M[0, 0] *= s
        M[1, 1] *= s
        M[0, 2] = cx
        M[1, 2] = cy
        roi = (int(np.ceil((innK[0] - cx0) * s + cx)),
               int(np.ceil((innK[1] - cy0) * s + cy)),
               int(np.floor(innK[2] * s)), int(np.floor(innK[3] * s)))
    else:
        fx0 = (nw - 1) / inner[2]
        fy0 = (nh - 1) / inner[3]
        cx0 = -fx0 * inner[0]
        cy0 = -fy0 * inner[1]
        fx1 = (nw - 1) / outer[2]
        fy1 = (nh - 1) / outer[3]
        cx1 = -fx1 * outer[0]
        cy1 = -fy1 * outer[1]
        M = Km.copy()
        M[0, 0] = fx0 * (1 - alpha) + fx1 * alpha
        M[1, 1] = fy0 * (1 - alpha) + fy1 * alpha
        M[0, 2] = cx0 * (1 - alpha) + cx1 * alpha
        M[1, 2] = cy0 * (1 - alpha) + cy1 * alpha
        innM, _ = _undistort_rectangles(Km, distCoeffs, None, M, (w, h))
        roi = (int(np.ceil(innM[0])), int(np.ceil(innM[1])),
               int(np.floor(innM[2])), int(np.floor(innM[3])))
    x0 = max(roi[0], 0)
    y0 = max(roi[1], 0)
    x1 = min(roi[0] + roi[2], nw)
    y1 = min(roi[1] + roi[3], nh)
    return M, (x0, y0, max(x1 - x0, 0), max(y1 - y0, 0))


def perspectiveTransform(src, m):
    pts = np.asarray(src, np.float64)
    shape = pts.shape
    p = pts.reshape(-1, shape[-1])
    M = np.asarray(m, np.float64)
    if shape[-1] == 2:
        w = M[2, 0] * p[:, 0] + M[2, 1] * p[:, 1] + M[2, 2]
        x = (M[0, 0] * p[:, 0] + M[0, 1] * p[:, 1] + M[0, 2]) / w
        y = (M[1, 0] * p[:, 0] + M[1, 1] * p[:, 1] + M[1, 2]) / w
        out = np.stack([x, y], axis=1)
    else:
        ph = np.concatenate([p, np.ones((len(p), 1))], axis=1)
        q = ph @ M.T
        out = q[:, :3] / q[:, 3:4]
    return out.reshape(shape).astype(np.asarray(src).dtype)


def _dlt_homography(src, dst):
    n = len(src)
    A = np.zeros((2 * n, 9))
    for i in range(n):
        x, y = src[i]
        u, v = dst[i]
        A[2 * i] = [-x, -y, -1, 0, 0, 0, u * x, u * y, u]
        A[2 * i + 1] = [0, 0, 0, -x, -y, -1, v * x, v * y, v]
    _, _, V = np.linalg.svd(A)
    H = V[-1].reshape(3, 3)
    return H / H[2, 2] if H[2, 2] != 0 else H


def _normalize_pts(p):
    c = p.mean(axis=0)
    s = np.sqrt(2) / max(np.mean(np.linalg.norm(p - c, axis=1)), 1e-12)
    T = np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1]])
    return (p - c) * s, T


def _dlt_homography_weighted(src, dst, w=None):
    """DLT with optional per-point weights (rows scaled by sqrt(w))."""
    n = len(src)
    A = np.zeros((2 * n, 9))
    A[0::2, 0] = -src[:, 0]
    A[0::2, 1] = -src[:, 1]
    A[0::2, 2] = -1
    A[0::2, 6] = src[:, 0] * dst[:, 0]
    A[0::2, 7] = src[:, 1] * dst[:, 0]
    A[0::2, 8] = dst[:, 0]
    A[1::2, 3] = -src[:, 0]
    A[1::2, 4] = -src[:, 1]
    A[1::2, 5] = -1
    A[1::2, 6] = src[:, 0] * dst[:, 1]
    A[1::2, 7] = src[:, 1] * dst[:, 1]
    A[1::2, 8] = dst[:, 1]
    if w is not None:
        sw = np.sqrt(np.repeat(w, 2))
        A = A * sw[:, None]
    _, _, V = np.linalg.svd(A, full_matrices=False)
    return V[-1].reshape(3, 3)


def _fundamental_7pt(p1, p2):
    """7-point algorithm (fundam.cpp run7Point): null space is
    f1 + t f2; det(F)=0 gives a cubic in t with 1 or 3 real roots."""
    a, T1 = _normalize_pts(p1)
    b, T2 = _normalize_pts(p2)
    A = np.column_stack([b[:, 0] * a[:, 0], b[:, 0] * a[:, 1], b[:, 0],
                         b[:, 1] * a[:, 0], b[:, 1] * a[:, 1], b[:, 1],
                         a[:, 0], a[:, 1], np.ones(7)])
    _, _, V = np.linalg.svd(A)
    F1 = V[-1].reshape(3, 3)
    F2 = V[-2].reshape(3, 3)
    # det(F1 + t F2) = c3 t^3 + c2 t^2 + c1 t + c0
    d = lambda t: np.linalg.det(F1 + t * F2)
    # exact coefficients via polynomial interpolation at 4 nodes
    ts = np.array([0.0, 1.0, -1.0, 2.0])
    ys = np.array([d(t) for t in ts])
    Vm = np.vander(ts, 4)                # columns t^3, t^2, t, 1
    coeff = np.linalg.solve(Vm, ys)
    roots = np.roots(coeff) if abs(coeff[0]) > 1e-14 \
        else np.roots(coeff[1:])
    out = []
    for r in roots:
        if abs(r.imag) > 1e-9:
            continue
        F = F1 + float(r.real) * F2
        F = T2.T @ F @ T1
        if abs(F[2, 2]) > 1e-12:
            F = F / F[2, 2]
        out.append(F)
    return out


class _HomographyEstimator:
    """USAC estimator adapter for homographies (homography_solver.cpp +
    degeneracy.cpp HomographyDegeneracy)."""

    sample_size = 4
    dof = 2
    sigma_quantile = 3.04
    upper_inc = 0.00419

    def __init__(self, src, dst):
        self.src = src
        self.dst = dst

    def fit(self, idx):
        try:
            s, Ts = _normalize_pts(self.src[idx])
            d, Td = _normalize_pts(self.dst[idx])
            Hn = _dlt_homography(s, d)
            H = np.linalg.inv(Td) @ Hn @ Ts
            return [H / H[2, 2] if abs(H[2, 2]) > 1e-12 else H]
        except np.linalg.LinAlgError:
            return []

    def non_minimal_fit(self, idx, weights=None):
        try:
            s, Ts = _normalize_pts(self.src[idx])
            d, Td = _normalize_pts(self.dst[idx])
            Hn = _dlt_homography_weighted(s, d, weights)
            H = np.linalg.inv(Td) @ Hn @ Ts
            return H / H[2, 2] if abs(H[2, 2]) > 1e-12 else H
        except np.linalg.LinAlgError:
            return None

    def errors(self, H):
        src, dst = self.src, self.dst
        w = H[2, 0] * src[:, 0] + H[2, 1] * src[:, 1] + H[2, 2]
        w = np.where(np.abs(w) < 1e-12, 1e-12, w)
        u = (H[0, 0] * src[:, 0] + H[0, 1] * src[:, 1] + H[0, 2]) / w
        v = (H[1, 0] * src[:, 0] + H[1, 1] * src[:, 1] + H[1, 2]) / w
        return (u - dst[:, 0]) ** 2 + (v - dst[:, 1]) ** 2

    def is_sample_good(self, idx):
        # no 3 collinear of the 4 (degeneracy.cpp isSampleGood),
        # checked in both images
        for pts in (self.src[idx], self.dst[idx]):
            p = np.column_stack([pts, np.ones(len(pts))])
            for trio in ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)):
                if abs(np.linalg.det(p[list(trio)])) < 1e-7:
                    return False
        return True


class _FundamentalEstimator:
    """USAC estimator adapter for F (fundamental_solver.cpp)."""

    dof = 4
    sigma_quantile = 3.64
    upper_inc = 0.003657

    def __init__(self, p1, p2, sample_size=7):
        self.p1 = p1
        self.p2 = p2
        self.sample_size = sample_size

    def fit(self, idx):
        try:
            if self.sample_size == 7:
                return _fundamental_7pt(self.p1[idx], self.p2[idx])
            return [_fundamental_8pt(self.p1[idx], self.p2[idx])]
        except np.linalg.LinAlgError:
            return []

    def non_minimal_fit(self, idx, weights=None):
        if len(idx) < 8:
            return None
        try:
            return _fundamental_8pt(self.p1[idx], self.p2[idx])
        except np.linalg.LinAlgError:
            return None

    def errors(self, F):
        n = len(self.p1)
        l2 = np.column_stack([self.p1, np.ones(n)]) @ F.T
        num = (l2[:, 0] * self.p2[:, 0] + l2[:, 1] * self.p2[:, 1]
               + l2[:, 2]) ** 2
        den = l2[:, 0] ** 2 + l2[:, 1] ** 2
        return num / np.maximum(den, 1e-12)

    def is_sample_good(self, idx):
        return True


def findHomography(srcPoints, dstPoints, method: int = 0,
                   ransacReprojThreshold: float = 3.0, mask=None,
                   maxIters: int = 2000, confidence: float = 0.995):
    """DLT (+ normalized coords) with RANSAC (fundam.cpp / usac)."""
    src = np.asarray(srcPoints, np.float64).reshape(-1, 2)
    dst = np.asarray(dstPoints, np.float64).reshape(-1, 2)
    n = len(src)
    if n < 4:
        return None, None

    def fit(idx):
        s, Ts = _normalize_pts(src[idx])
        d, Td = _normalize_pts(dst[idx])
        Hn = _dlt_homography(s, d)
        H = np.linalg.inv(Td) @ Hn @ Ts
        return H / H[2, 2] if H[2, 2] != 0 else H

    def reproj_err(H):
        w = H[2, 0] * src[:, 0] + H[2, 1] * src[:, 1] + H[2, 2]
        u = (H[0, 0] * src[:, 0] + H[0, 1] * src[:, 1] + H[0, 2]) / w
        v = (H[1, 0] * src[:, 0] + H[1, 1] * src[:, 1] + H[1, 2]) / w
        return (u - dst[:, 0]) ** 2 + (v - dst[:, 1]) ** 2

    if method in (0,) or n == 4:
        H = fit(np.arange(n))
        return H, np.ones((n, 1), np.uint8)

    if USAC_DEFAULT <= method <= USAC_MAGSAC:
        from . import usac as U
        est = _HomographyEstimator(src, dst)
        H, inl, _ = U.ransac_solve(est, n, flag=method,
                                   threshold=ransacReprojThreshold,
                                   confidence=confidence,
                                   max_iters=maxIters)
        if H is None or inl.sum() < 4:
            return None, None
        return H, inl.astype(np.uint8).reshape(-1, 1)

    rng = np.random.default_rng(0)  # deterministic like cv::theRNG default
    best_inl = None
    best_cnt = -1
    t2 = ransacReprojThreshold ** 2
    iters = maxIters
    i = 0
    while i < iters:
        idx = rng.choice(n, 4, replace=False)
        try:
            H = fit(idx)
        except np.linalg.LinAlgError:
            i += 1
            continue
        inl = reproj_err(H) < t2
        c = int(inl.sum())
        if c > best_cnt:
            best_cnt = c
            best_inl = inl
            # adaptive iteration count
            eps = 1 - c / n
            if eps < 1:
                denom = math.log(max(1 - (1 - eps) ** 4, 1e-12))
                if denom < 0:
                    iters = min(iters, int(math.log(1 - confidence) / denom) + 1)
        i += 1
    if best_inl is None or best_cnt < 4:
        return None, None
    # local optimization: iterated refit on inliers until the inlier
    # set stabilizes (the LO step the USAC_* flags ask for; plain
    # RANSAC also benefits and matches fundam.cpp's final refit)
    rounds = 5 if method >= USAC_DEFAULT else 1
    inl = best_inl
    H = fit(np.nonzero(inl)[0])
    for _ in range(rounds):
        new_inl = reproj_err(H) < t2
        if new_inl.sum() < 4 or np.array_equal(new_inl, inl):
            inl = new_inl if new_inl.sum() >= 4 else inl
            break
        inl = new_inl
        H = fit(np.nonzero(inl)[0])
    best_inl = reproj_err(H) < t2
    return H, best_inl.astype(np.uint8).reshape(-1, 1)


def _fundamental_8pt(p1, p2):
    a, T1 = _normalize_pts(p1)
    b, T2 = _normalize_pts(p2)
    A = np.column_stack([b[:, 0] * a[:, 0], b[:, 0] * a[:, 1], b[:, 0],
                         b[:, 1] * a[:, 0], b[:, 1] * a[:, 1], b[:, 1],
                         a[:, 0], a[:, 1], np.ones(len(a))])
    _, _, V = np.linalg.svd(A)
    F = V[-1].reshape(3, 3)
    U, S, Vt = np.linalg.svd(F)
    S[2] = 0
    F = U @ np.diag(S) @ Vt
    F = T2.T @ F @ T1
    return F / F[2, 2] if abs(F[2, 2]) > 1e-12 else F


def findFundamentalMat(points1, points2, method: int = FM_RANSAC,
                       ransacReprojThreshold: float = 3.0,
                       confidence: float = 0.99, maxIters: int = 1000):
    p1 = np.asarray(points1, np.float64).reshape(-1, 2)
    p2 = np.asarray(points2, np.float64).reshape(-1, 2)
    n = len(p1)
    if n < 8:
        return None, None

    def epi_err(F):
        l2 = np.column_stack([p1, np.ones(n)]) @ F.T  # lines in img2
        num = (l2[:, 0] * p2[:, 0] + l2[:, 1] * p2[:, 1] + l2[:, 2]) ** 2
        den = l2[:, 0] ** 2 + l2[:, 1] ** 2
        return num / np.maximum(den, 1e-12)

    if method == FM_8POINT:
        F = _fundamental_8pt(p1, p2)
        return F, np.ones((n, 1), np.uint8)

    if USAC_DEFAULT <= method <= USAC_MAGSAC:
        from . import usac as U
        est = _FundamentalEstimator(
            p1, p2, sample_size=8 if method == USAC_FM_8PTS else 7)
        F, inl, _ = U.ransac_solve(est, n, flag=method,
                                   threshold=ransacReprojThreshold,
                                   confidence=confidence,
                                   max_iters=maxIters)
        if F is None or inl.sum() < 8:
            return None, None
        return F, inl.astype(np.uint8).reshape(-1, 1)

    rng = np.random.default_rng(0)
    best = None
    best_cnt = -1
    t2 = ransacReprojThreshold ** 2
    for _ in range(maxIters):
        idx = rng.choice(n, 8, replace=False)
        F = _fundamental_8pt(p1[idx], p2[idx])
        inl = epi_err(F) < t2
        if inl.sum() > best_cnt:
            best_cnt = int(inl.sum())
            best = inl
    if best is None or best_cnt < 8:
        return None, None
    F = _fundamental_8pt(p1[best], p2[best])
    return F, (epi_err(F) < t2).astype(np.uint8).reshape(-1, 1)


def solvePnP(objectPoints, imagePoints, cameraMatrix, distCoeffs,
             rvec=None, tvec=None, useExtrinsicGuess: bool = False,
             flags: int = SOLVEPNP_ITERATIVE):
    """PnP dispatch (solvepnp.cpp): ITERATIVE = DLT/homography init +
    Gauss-Newton; EPNP/P3P/AP3P/IPPE/SQPNP via the dedicated solvers in
    [[pnp]], picking the minimum-reprojection candidate."""
    obj = np.asarray(objectPoints, np.float64).reshape(-1, 3)
    img = np.asarray(imagePoints, np.float64).reshape(-1, 2)
    Km = np.asarray(cameraMatrix, np.float64).reshape(3, 3)
    und = undistortPoints(img, Km, distCoeffs).reshape(-1, 2).astype(np.float64)
    n = len(obj)

    if flags in (SOLVEPNP_EPNP, SOLVEPNP_P3P, SOLVEPNP_AP3P,
                 SOLVEPNP_IPPE, SOLVEPNP_IPPE_SQUARE, SOLVEPNP_SQPNP):
        from . import pnp as _pnp
        if flags in (SOLVEPNP_P3P, SOLVEPNP_AP3P):
            cands = _pnp.solve_p3p(obj, und)
        elif flags in (SOLVEPNP_IPPE, SOLVEPNP_IPPE_SQUARE):
            cands = _pnp.solve_ippe(obj, und)
        elif flags == SOLVEPNP_SQPNP:
            cands = _pnp.solve_sqpnp(obj, und)
        else:
            cands = _pnp.solve_epnp(obj, und)
        if not cands:
            return False, None, None
        best = None
        for Rm, t in cands:
            pc = obj @ Rm.T + t
            with np.errstate(divide="ignore", invalid="ignore"):
                pr = pc[:, :2] / pc[:, 2:3]
            e = float(np.nansum((pr - und) ** 2))
            if best is None or e < best[0]:
                best = (e, Rm, t)
        rv, _ = Rodrigues(best[1])
        return True, rv.reshape(3, 1), best[2].reshape(3, 1)

    # DLT init (needs n >= 6); for n >= 4 planar use homography init
    if useExtrinsicGuess and rvec is not None and tvec is not None:
        r = np.asarray(rvec, np.float64).reshape(3)
        t = np.asarray(tvec, np.float64).reshape(3)
    else:
        if np.ptp(obj[:, 2]) < 1e-9:  # planar
            H, _ = findHomography(obj[:, :2], und)
            h1, h2, h3 = H[:, 0], H[:, 1], H[:, 2]
            lam = 1.0 / max(np.linalg.norm(h1), 1e-12)
            r1 = h1 * lam
            r2 = h2 * lam
            r3 = np.cross(r1, r2)
            Rm = np.column_stack([r1, r2, r3])
            U, _, Vt = np.linalg.svd(Rm)
            Rm = U @ Vt
            if np.linalg.det(Rm) < 0:
                Rm = -Rm
            t = h3 * lam
            if t[2] < 0:
                Rm = np.column_stack([-Rm[:, 0], -Rm[:, 1], Rm[:, 2]])
                t = -t
            r, _ = Rodrigues(Rm)
            r = np.asarray(r).reshape(3)
        else:
            A = np.zeros((2 * n, 12))
            for i in range(n):
                X = np.append(obj[i], 1.0)
                A[2 * i, 0:4] = X
                A[2 * i, 8:12] = -und[i, 0] * X
                A[2 * i + 1, 4:8] = X
                A[2 * i + 1, 8:12] = -und[i, 1] * X
            _, _, V = np.linalg.svd(A)
            P = V[-1].reshape(3, 4)
            Rm = P[:, :3]
            U, S, Vt = np.linalg.svd(Rm)
            scale = np.mean(S)
            Rm = U @ Vt
            if np.linalg.det(Rm) < 0:
                Rm = -Rm
                scale = -scale
            t = P[:, 3] / scale
            r, _ = Rodrigues(Rm)
            r = np.asarray(r).reshape(3)

    # Gauss-Newton on normalized reprojection
    def residual(r, t):
        R, _ = Rodrigues(r)
        pc = obj @ R.T + t
        return (pc[:, :2] / pc[:, 2:3] - und).ravel()

    x = np.concatenate([r, t])
    for _ in range(20):
        f0 = residual(x[:3], x[3:])
        J = np.zeros((2 * n, 6))
        h = 1e-6
        for j in range(6):
            xp = x.copy()
            xp[j] += h
            J[:, j] = (residual(xp[:3], xp[3:]) - f0) / h
        try:
            dx = np.linalg.lstsq(J, -f0, rcond=None)[0]
        except np.linalg.LinAlgError:
            break
        x = x + dx
        if np.linalg.norm(dx) < 1e-10:
            break
    return True, x[:3].reshape(3, 1), x[3:].reshape(3, 1)


def triangulatePoints(projMatr1, projMatr2, projPoints1, projPoints2):
    P1 = np.asarray(projMatr1, np.float64).reshape(3, 4)
    P2 = np.asarray(projMatr2, np.float64).reshape(3, 4)
    p1 = np.asarray(projPoints1, np.float64).reshape(2, -1)
    p2 = np.asarray(projPoints2, np.float64).reshape(2, -1)
    n = p1.shape[1]
    out = np.zeros((4, n))
    for i in range(n):
        A = np.stack([
            p1[0, i] * P1[2] - P1[0],
            p1[1, i] * P1[2] - P1[1],
            p2[0, i] * P2[2] - P2[0],
            p2[1, i] * P2[2] - P2[1],
        ])
        _, _, V = np.linalg.svd(A)
        out[:, i] = V[-1]
    return out


def computeCorrespondEpilines(points, whichImage: int, F):
    p = np.asarray(points, np.float64).reshape(-1, 2)
    Fm = np.asarray(F, np.float64).reshape(3, 3)
    ph = np.column_stack([p, np.ones(len(p))])
    lines = ph @ (Fm.T if whichImage == 1 else Fm)
    nrm = np.sqrt(lines[:, 0] ** 2 + lines[:, 1] ** 2)
    lines = lines / np.maximum(nrm[:, None], 1e-12)
    return lines.reshape(-1, 1, 3).astype(np.float32)


def _affine_lsq(src, dst):
    """Full 6-dof affine least squares: dst ~ A src + t."""
    n = len(src)
    A = np.zeros((2 * n, 6))
    A[0::2, 0] = src[:, 0]
    A[0::2, 1] = src[:, 1]
    A[0::2, 2] = 1
    A[1::2, 3] = src[:, 0]
    A[1::2, 4] = src[:, 1]
    A[1::2, 5] = 1
    b = dst.reshape(-1)
    sol, *_ = np.linalg.lstsq(A, b, rcond=None)
    return sol.reshape(2, 3)


def _similarity_lsq(src, dst):
    """4-dof similarity: [a -b; b a] src + t (calib3d ptsetreg.cpp
    Affine2DEstimatorCallback / AffinePartial2D)."""
    n = len(src)
    A = np.zeros((2 * n, 4))
    A[0::2, 0] = src[:, 0]
    A[0::2, 1] = -src[:, 1]
    A[0::2, 2] = 1
    A[1::2, 0] = src[:, 1]
    A[1::2, 1] = src[:, 0]
    A[1::2, 3] = 1
    b = dst.reshape(-1)
    (a, bb, tx, ty), *_ = np.linalg.lstsq(A, b, rcond=None)
    return np.array([[a, -bb, tx], [bb, a, ty]])


def _estimate_affine(src, dst, fit, min_pts, method, thresh, maxIters,
                     confidence, refineIters):
    src = np.asarray(src, np.float64).reshape(-1, 2)
    dst = np.asarray(dst, np.float64).reshape(-1, 2)
    n = len(src)
    if n < min_pts:
        return None, None

    def errs(M):
        pred = src @ M[:, :2].T + M[:, 2]
        return ((pred - dst) ** 2).sum(-1)

    if n == min_pts or method == 0:
        M = fit(src, dst)
        return M, np.ones((n, 1), np.uint8)

    rng = np.random.default_rng(0)
    t2 = thresh * thresh
    best_cnt, best_inl = -1, None
    iters = int(maxIters)
    i = 0
    while i < iters:
        idx = rng.choice(n, min_pts, replace=False)
        try:
            M = fit(src[idx], dst[idx])
        except np.linalg.LinAlgError:
            i += 1
            continue
        inl = errs(M) <= t2
        c = int(inl.sum())
        if c > best_cnt:
            best_cnt, best_inl = c, inl
            # adaptive iteration bound
            w = max(c / n, 1e-9)
            need = np.log(max(1 - confidence, 1e-12)) / \
                np.log(max(1 - w ** min_pts, 1e-12))
            iters = min(iters, int(need) + 1)
        i += 1
    if best_inl is None or best_cnt < min_pts:
        return None, np.zeros((n, 1), np.uint8)
    M = fit(src[best_inl], dst[best_inl])
    for _ in range(int(refineIters)):
        inl = errs(M) <= t2
        if inl.sum() < min_pts:
            break
        M = fit(src[inl], dst[inl])
        best_inl = inl
    return M, best_inl.astype(np.uint8)[:, None]


def estimateAffine2D(from_, to, inliers=None, method=RANSAC,
                     ransacReprojThreshold: float = 3.0,
                     maxIters: int = 2000, confidence: float = 0.99,
                     refineIters: int = 10):
    """cv2.estimateAffine2D (calib3d/src/ptsetreg.cpp:862): 6-dof affine
    by RANSAC + LSQ refinement; returns (2x3 f64, inlier mask)."""
    return _estimate_affine(from_, to, _affine_lsq, 3, method,
                            ransacReprojThreshold, maxIters, confidence,
                            refineIters)


def estimateAffinePartial2D(from_, to, inliers=None, method=RANSAC,
                            ransacReprojThreshold: float = 3.0,
                            maxIters: int = 2000, confidence: float = 0.99,
                            refineIters: int = 10):
    """cv2.estimateAffinePartial2D: 4-dof similarity (rotation, uniform
    scale, translation)."""
    return _estimate_affine(from_, to, _similarity_lsq, 2, method,
                            ransacReprojThreshold, maxIters, confidence,
                            refineIters)


def _undistort_rectangles(K, dist, R, P, size):
    """Sample a grid of undistorted-rectified points; return (inner,
    outer) rectangles (calib3d getUndistortRectangles)."""
    w, h = size
    N = 9
    xs, ys = np.meshgrid(np.linspace(0, w - 1, N), np.linspace(0, h - 1, N))
    pts = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float64)
    und = undistortPoints(pts.reshape(-1, 1, 2), K, dist, R=R, P=P)
    u = np.asarray(und).reshape(-1, 2)
    gx = u[:, 0].reshape(N, N)
    gy = u[:, 1].reshape(N, N)
    ox0, oy0 = u[:, 0].min(), u[:, 1].min()
    ox1, oy1 = u[:, 0].max(), u[:, 1].max()
    ix0 = gx[:, 0].max()
    ix1 = gx[:, -1].min()
    iy0 = gy[0].max()
    iy1 = gy[-1].min()
    inner = (ix0, iy0, ix1 - ix0, iy1 - iy0)
    outer = (ox0, oy0, ox1 - ox0, oy1 - oy0)
    return inner, outer


def stereoRectify(cameraMatrix1, distCoeffs1, cameraMatrix2, distCoeffs2,
                  imageSize, R, T, flags=1024, alpha=-1,
                  newImageSize=(0, 0)):
    """cv2.stereoRectify (calib3d/src/stereo_geom.cpp:116, Bouguet):
    returns (R1, R2, P1, P2, Q, roi1, roi2)."""
    K1 = np.asarray(cameraMatrix1, np.float64)
    K2 = np.asarray(cameraMatrix2, np.float64)
    d1 = np.asarray(distCoeffs1, np.float64).ravel() if distCoeffs1 is not None else np.zeros(5)
    d2 = np.asarray(distCoeffs2, np.float64).ravel() if distCoeffs2 is not None else np.zeros(5)
    matR = np.asarray(R, np.float64)
    matT = np.asarray(T, np.float64).ravel()
    nx, ny = imageSize

    om = np.asarray(Rodrigues(matR)[0]).ravel() if matR.shape == (3, 3) \
        else matR.ravel()
    r_r, _ = Rodrigues(om * -0.5)
    t = r_r @ matT
    idx = 0 if abs(t[0]) > abs(t[1]) else 1
    c = t[idx]
    nt = np.linalg.norm(t)
    uu = np.zeros(3)
    uu[idx] = 1.0 if c > 0 else -1.0
    ww = np.cross(t, uu)
    nw = np.linalg.norm(ww)
    if nw > 0:
        ww *= np.arccos(abs(c) / nt) / nw
    wR, _ = Rodrigues(ww)
    R1o = wR @ r_r.T
    R2o = wR @ r_r
    t = R2o @ matT

    newImgSize = newImageSize if newImageSize[0] * newImageSize[1] else \
        (nx, ny)
    ratio_x = newImgSize[0] / nx / 2
    ratio_y = newImgSize[1] / ny / 2
    ratio = ratio_x if idx == 1 else ratio_y
    fc_new = (K1[idx ^ 1, idx ^ 1] + K2[idx ^ 1, idx ^ 1]) * ratio

    cc_new = []
    Z = np.zeros(3)
    for k in range(2):
        A = K1 if k == 0 else K2
        Dk = d1 if k == 0 else d2
        corners = np.array([[0, 0], [nx - 1, 0], [0, ny - 1],
                            [nx - 1, ny - 1]], np.float64)
        und = np.asarray(undistortPoints(
            corners.reshape(-1, 1, 2), A, Dk)).reshape(-1, 2)
        pts3 = np.concatenate([und, np.ones((4, 1))], axis=1)
        A_tmp = np.array([[fc_new, 0, 0], [0, fc_new, 0], [0, 0, 1.0]])
        Rk = R1o if k == 0 else R2o
        proj, _ = projectPoints(pts3, np.asarray(Rodrigues(Rk)[0]).ravel(),
                                Z, A_tmp, np.zeros(5))
        avg = np.asarray(proj).reshape(-1, 2).mean(axis=0)
        cc_new.append(np.array([(nx - 1) / 2 - avg[0],
                                (ny - 1) / 2 - avg[1]]))

    CALIB_ZERO_DISPARITY = 1024
    if flags & CALIB_ZERO_DISPARITY:
        m = (cc_new[0] + cc_new[1]) * 0.5
        cc_new[0] = cc_new[1] = m
    elif idx == 0:
        my = (cc_new[0][1] + cc_new[1][1]) * 0.5
        cc_new[0][1] = cc_new[1][1] = my
    else:
        mx = (cc_new[0][0] + cc_new[1][0]) * 0.5
        cc_new[0][0] = cc_new[1][0] = mx

    t_idx = t[idx]
    P1o = np.zeros((3, 4))
    P1o[0, 0] = P1o[1, 1] = fc_new
    P1o[0, 2] = cc_new[0][0]
    P1o[1, 2] = cc_new[0][1]
    P1o[2, 2] = 1.0
    P2o = P1o.copy()
    P2o[0, 2] = cc_new[1][0]
    P2o[1, 2] = cc_new[1][1]
    P2o[idx, 3] = t_idx * fc_new

    inner1, outer1 = _undistort_rectangles(K1, d1, R1o, P1o, (nx, ny))
    inner2, outer2 = _undistort_rectangles(K2, d2, R2o, P2o, (nx, ny))

    alpha = min(alpha, 1.0)
    cx1_0, cy1_0 = cc_new[0]
    cx2_0, cy2_0 = cc_new[1]
    cx1 = newImgSize[0] * cx1_0 / nx
    cy1 = newImgSize[1] * cy1_0 / ny
    cx2 = newImgSize[0] * cx2_0 / nx
    cy2 = newImgSize[1] * cy2_0 / ny
    s = 1.0
    if alpha >= 0:
        def smax(inner, cx, cy, cx0, cy0):
            return max(cx / (cx0 - inner[0]), cy / (cy0 - inner[1]),
                       (newImgSize[0] - 1 - cx) / (inner[0] + inner[2] - cx0),
                       (newImgSize[1] - 1 - cy) / (inner[1] + inner[3] - cy0))

        def smin(outer, cx, cy, cx0, cy0):
            return min(cx / (cx0 - outer[0]), cy / (cy0 - outer[1]),
                       (newImgSize[0] - 1 - cx) / (outer[0] + outer[2] - cx0),
                       (newImgSize[1] - 1 - cy) / (outer[1] + outer[3] - cy0))

        s0 = max(smax(inner1, cx1, cy1, cx1_0, cy1_0),
                 smax(inner2, cx2, cy2, cx2_0, cy2_0))
        s1 = min(smin(outer1, cx1, cy1, cx1_0, cy1_0),
                 smin(outer2, cx2, cy2, cx2_0, cy2_0))
        s = s0 * (1 - alpha) + s1 * alpha

    fc_new *= s
    P2o[0, 0] = P2o[1, 1] = fc_new
    P2o[0, 2] = cx2
    P2o[1, 2] = cy2
    P2o[idx, 3] *= s
    P1o[0, 0] = P1o[1, 1] = fc_new
    P1o[0, 2] = cx1
    P1o[1, 2] = cy1
    P1o[idx, 3] = 0.0

    import math
    roi1 = (math.ceil((inner1[0] - cx1_0) * s + cx1),
            math.ceil((inner1[1] - cy1_0) * s + cy1),
            math.floor(inner1[2] * s), math.floor(inner1[3] * s))
    roi2 = (math.ceil((inner2[0] - cx2_0) * s + cx2),
            math.ceil((inner2[1] - cy2_0) * s + cy2),
            math.floor(inner2[2] * s), math.floor(inner2[3] * s))

    def clip_roi(r):
        x0 = max(r[0], 0)
        y0 = max(r[1], 0)
        x1 = min(r[0] + r[2], newImgSize[0])
        y1 = min(r[1] + r[3], newImgSize[1])
        return (x0, y0, max(x1 - x0, 0), max(y1 - y0, 0))

    Qo = np.float64([
        [1, 0, 0, -cx1],
        [0, 1, 0, -cy1],
        [0, 0, 0, fc_new],
        [0, 0, -1.0 / t_idx,
         ((cx1 - cx2) if idx == 0 else (cy1 - cy2)) / t_idx],
    ])
    return R1o, R2o, P1o, P2o, Qo, clip_roi(roi1), clip_roi(roi2)


# ------------------------------------------------- two-view geometry

FM_LMEDS = 4


def findEssentialMat(points1, points2, cameraMatrix=None, method=RANSAC,
                     prob=0.999, threshold=1.0, maxIters=1000):
    """Essential matrix via normalized 8-point + constraint projection
    inside a RANSAC loop (the reference uses Nister 5-point; on
    well-conditioned data both converge to the same E up to scale)."""
    p1 = np.asarray(points1, np.float64).reshape(-1, 2)
    p2 = np.asarray(points2, np.float64).reshape(-1, 2)
    K = np.asarray(cameraMatrix, np.float64) if cameraMatrix is not None \
        else np.eye(3)
    Kinv = np.linalg.inv(K)
    n1 = (np.column_stack([p1, np.ones(len(p1))]) @ Kinv.T)[:, :2]
    n2 = (np.column_stack([p2, np.ones(len(p2))]) @ Kinv.T)[:, :2]
    n = len(n1)

    def fit(idx):
        """Returns (F rank-2 for gating, E projected onto the
        essential manifold).  Gating uses F: the equal-singular-value
        projection perturbs residuals far above the noise floor."""
        F = _fundamental_8pt(n1[idx], n2[idx])
        U, S, Vt = np.linalg.svd(F)
        s = (S[0] + S[1]) / 2
        return F, U @ np.diag([s, s, 0.0]) @ Vt

    def err(E):
        x1 = np.column_stack([n1, np.ones(n)])
        x2 = np.column_stack([n2, np.ones(n)])
        Ex1 = x1 @ E.T
        Etx2 = x2 @ E
        x2Ex1 = np.sum(x2 * Ex1, axis=1)
        # Sampson distance in normalized coords
        d = x2Ex1 ** 2 / (Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2
                          + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2 + 1e-12)
        return d

    thr_n = (threshold / ((K[0, 0] + K[1, 1]) / 2)) ** 2
    if n < 8:
        return None, None
    rng = np.random.default_rng(0)
    best = None
    # over-determined samples stabilize the 8-point minimal stage
    ssize = min(max(8, n // 4), 15, n)
    for _ in range(maxIters if method in (RANSAC, LMEDS) else 1):
        idx = rng.choice(n, ssize, replace=False) \
            if method in (RANSAC, LMEDS) else np.arange(n)
        try:
            F, E = fit(idx)
        except np.linalg.LinAlgError:
            continue
        inl = err(F) < thr_n
        if best is None or inl.sum() > best[0]:
            best = (inl.sum(), F, E, inl)
        if method not in (RANSAC, LMEDS):
            break
    cnt, F, E, inl = best
    # iterated least-squares refit on the inlier set
    for _ in range(3):
        if inl.sum() < 8:
            break
        F, E = fit(np.nonzero(inl)[0])
        inl = err(F) < thr_n
    return E / np.linalg.norm(E), inl.astype(np.uint8).reshape(-1, 1)


def _triangulate_cheirality(R, t, n1, n2):
    """Count points in front of both cameras for candidate (R, t)."""
    P1 = np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = np.hstack([R, t.reshape(3, 1)])
    good = 0
    mask = np.zeros(len(n1), bool)
    for i, (a, b) in enumerate(zip(n1, n2)):
        A = np.array([
            a[0] * P1[2] - P1[0],
            a[1] * P1[2] - P1[1],
            b[0] * P2[2] - P2[0],
            b[1] * P2[2] - P2[1],
        ])
        _, _, Vt = np.linalg.svd(A)
        X = Vt[-1]
        X = X / X[3]
        z1 = X[2]
        z2 = (P2 @ X)[2]
        if z1 > 0 and z2 > 0 and abs(X[2]) < 50:
            good += 1
            mask[i] = True
    return good, mask


def recoverPose(E, points1, points2, cameraMatrix=None, mask=None):
    """cv2.recoverPose: pick the (R, t) with best cheirality.
    Returns (ngood, R, t, mask)."""
    p1 = np.asarray(points1, np.float64).reshape(-1, 2)
    p2 = np.asarray(points2, np.float64).reshape(-1, 2)
    K = np.asarray(cameraMatrix, np.float64) if cameraMatrix is not None \
        else np.eye(3)
    Kinv = np.linalg.inv(K)
    n1 = (np.column_stack([p1, np.ones(len(p1))]) @ Kinv.T)[:, :2]
    n2 = (np.column_stack([p2, np.ones(len(p2))]) @ Kinv.T)[:, :2]
    E = np.asarray(E, np.float64)
    U, _, Vt = np.linalg.svd(E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    best = None
    for R, tt in [(R1, t), (R1, -t), (R2, t), (R2, -t)]:
        good, m = _triangulate_cheirality(R, tt, n1, n2)
        if best is None or good > best[0]:
            best = (good, R, tt, m)
    good, R, tt, m = best
    return good, R, tt.reshape(3, 1), m.astype(np.uint8).reshape(-1, 1)


def decomposeHomographyMat(H, K):
    """Homography decomposition H ~ R + t n^T (the role of
    calib3d/src/homography_decomp.cpp): candidate plane normals from
    the symmetric matrix S = H^T H - I, then (R, t) per normal by
    orthogonal-Procrustes iteration; returns (n, Rs, ts, normals)."""
    K = np.asarray(K, np.float64)
    Hn = np.linalg.inv(K) @ np.asarray(H, np.float64) @ K
    _, S, _ = np.linalg.svd(Hn)
    Hn = Hn / S[1]
    if np.linalg.det(Hn) < 0:
        Hn = -Hn

    Ss = Hn.T @ Hn - np.eye(3)
    if np.abs(Ss).max() < 1e-7:  # pure rotation
        U, _, Vt = np.linalg.svd(Hn)
        R = U @ Vt
        return 1, [R], [np.zeros((3, 1))], [np.zeros((3, 1))]

    def minor(M, row, col):
        idxr = [i for i in range(3) if i != row]
        idxc = [i for i in range(3) if i != col]
        m = M[np.ix_(idxr, idxc)]
        return -(m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0])

    M00 = minor(Ss, 0, 0)
    M11 = minor(Ss, 1, 1)
    M22 = minor(Ss, 2, 2)
    rt00 = np.sqrt(max(M00, 0))
    rt11 = np.sqrt(max(M11, 0))
    rt22 = np.sqrt(max(M22, 0))
    e01 = 1.0 if minor(Ss, 1, 2) >= 0 else -1.0
    e02 = 1.0 if minor(Ss, 1, 1) >= 0 else -1.0
    e12 = 1.0 if minor(Ss, 0, 0) >= 0 else -1.0

    k = int(np.argmax(np.abs(np.diag(Ss))))
    if k == 0:
        na = np.array([Ss[0, 0], Ss[0, 1] + rt22, Ss[0, 2] + e12 * rt11])
        nb = np.array([Ss[0, 0], Ss[0, 1] - rt22, Ss[0, 2] - e12 * rt11])
    elif k == 1:
        na = np.array([Ss[0, 1] + rt22, Ss[1, 1], Ss[1, 2] - e02 * rt00])
        nb = np.array([Ss[0, 1] - rt22, Ss[1, 1], Ss[1, 2] + e02 * rt00])
    else:
        na = np.array([Ss[0, 2] + e01 * rt11, Ss[1, 2] + rt00, Ss[2, 2]])
        nb = np.array([Ss[0, 2] - e01 * rt11, Ss[1, 2] - rt00, Ss[2, 2]])

    Rs, ts, ns = [], [], []
    for nvec in (na, nb):
        nn = np.linalg.norm(nvec)
        if nn < 1e-12:
            continue
        for sgn in (1.0, -1.0):
            nv = sgn * nvec / nn
            # fixed-point: R from Procrustes of (H - t n^T), t = (H-R) n
            t = np.zeros(3)
            R = Hn.copy()
            for _ in range(100):
                M = Hn - np.outer(t, nv)
                U, _, Vt = np.linalg.svd(M)
                D = np.diag([1, 1, np.linalg.det(U @ Vt)])
                R = U @ D @ Vt
                t_new = (Hn - R) @ nv
                if np.linalg.norm(t_new - t) < 1e-13:
                    t = t_new
                    break
                t = t_new
            if np.abs(Hn - (R + np.outer(t, nv))).max() < 1e-6:
                # dedup
                dup = any(np.abs(R - R0).max() < 1e-8
                          and np.abs(t.reshape(3, 1) - t0).max() < 1e-8
                          for R0, t0 in zip(Rs, ts))
                if not dup:
                    Rs.append(R)
                    ts.append(t.reshape(3, 1))
                    ns.append(nv.reshape(3, 1))
    if not Rs:
        U, _, Vt = np.linalg.svd(Hn)
        R = U @ Vt
        return 1, [R], [np.zeros((3, 1))], [np.zeros((3, 1))]
    return len(Rs), Rs, ts, ns


def solvePnPRansac(objectPoints, imagePoints, cameraMatrix, distCoeffs,
                   rvec=None, tvec=None, useExtrinsicGuess=False,
                   iterationsCount=100, reprojectionError=8.0,
                   confidence=0.99, inliers=None, flags=SOLVEPNP_ITERATIVE):
    """cv2.solvePnPRansac: returns (retval, rvec, tvec, inliers)."""
    obj = np.asarray(objectPoints, np.float64).reshape(-1, 3)
    img = np.asarray(imagePoints, np.float64).reshape(-1, 2)
    n = len(obj)
    if n < 4:
        return False, None, None, None
    rng = np.random.default_rng(0)

    def reproj(rv, tv):
        proj, _ = projectPoints(obj, rv, tv, cameraMatrix, distCoeffs)
        return np.linalg.norm(np.asarray(proj).reshape(-1, 2) - img,
                              axis=1)

    best = None
    for _ in range(iterationsCount):
        idx = rng.choice(n, min(6, n), replace=False)
        ok, rv, tv = solvePnP(obj[idx], img[idx], cameraMatrix,
                              distCoeffs)
        if not ok:
            continue
        e = reproj(rv, tv)
        inl = e < reprojectionError
        if best is None or inl.sum() > best[0]:
            best = (inl.sum(), rv, tv, inl)
    if best is None or best[0] < 4:
        return False, None, None, None
    _, rv, tv, inl = best
    ok, rv, tv = solvePnP(obj[inl], img[inl], cameraMatrix, distCoeffs,
                          rvec=rv, tvec=tv, useExtrinsicGuess=True)
    e = reproj(rv, tv)
    inl = e < reprojectionError
    return True, rv, tv, np.nonzero(inl)[0].reshape(-1, 1).astype(np.int32)


def convertPointsToHomogeneous(src):
    p = np.asarray(src, np.float64)
    flat = p.reshape(-1, p.shape[-1])
    out = np.concatenate([flat, np.ones((len(flat), 1))], axis=1)
    return out.reshape(-1, 1, p.shape[-1] + 1).astype(np.float32 if
        np.asarray(src).dtype == np.float32 else np.float64)


def convertPointsFromHomogeneous(src):
    p = np.asarray(src, np.float64)
    flat = p.reshape(-1, p.shape[-1])
    w = flat[:, -1:]
    w = np.where(np.abs(w) > 1e-12, w, 1.0)
    out = flat[:, :-1] / w
    return out.reshape(-1, 1, p.shape[-1] - 1).astype(np.float32 if
        np.asarray(src).dtype == np.float32 else np.float64)


def sampsonDistance(pt1, pt2, F):
    x1 = np.asarray(pt1, np.float64).ravel()
    x2 = np.asarray(pt2, np.float64).ravel()
    F = np.asarray(F, np.float64)
    Fx1 = F @ x1
    Ftx2 = F.T @ x2
    v = x2 @ F @ x1
    return float(v * v / (Fx1[0] ** 2 + Fx1[1] ** 2
                          + Ftx2[0] ** 2 + Ftx2[1] ** 2))


def estimateAffine3D(src, dst, ransacThreshold=3.0, confidence=0.99):
    """cv2.estimateAffine3D: 3D affine via RANSAC + LSQ.
    Returns (retval, (3,4) f64, inliers)."""
    a = np.asarray(src, np.float64).reshape(-1, 3)
    b = np.asarray(dst, np.float64).reshape(-1, 3)
    n = len(a)

    def fit(idx):
        A = np.concatenate([a[idx], np.ones((len(idx), 1))], axis=1)
        sol, *_ = np.linalg.lstsq(A, b[idx], rcond=None)
        return sol.T          # (3, 4)

    def errs(M):
        pred = a @ M[:, :3].T + M[:, 3]
        return np.linalg.norm(pred - b, axis=1)

    if n < 4:
        return 0, None, None
    rng = np.random.default_rng(0)
    best = None
    for _ in range(200):
        idx = rng.choice(n, 4, replace=False)
        try:
            M = fit(idx)
        except np.linalg.LinAlgError:
            continue
        inl = errs(M) <= ransacThreshold
        if best is None or inl.sum() > best[0]:
            best = (inl.sum(), inl)
    cnt, inl = best
    if cnt < 4:
        return 0, None, np.zeros((n, 1), np.uint8)
    M = fit(np.nonzero(inl)[0])
    inl = errs(M) <= ransacThreshold
    M = fit(np.nonzero(inl)[0])
    return 1, M, inl.astype(np.uint8).reshape(-1, 1)


def estimateTranslation3D(src, dst, ransacThreshold=3.0, confidence=0.99):
    a = np.asarray(src, np.float64).reshape(-1, 3)
    b = np.asarray(dst, np.float64).reshape(-1, 3)
    n = len(a)
    if n < 1:
        return 0, None, None
    rng = np.random.default_rng(0)
    best = None
    for _ in range(200):
        idx = rng.choice(n, 1)
        t = (b[idx] - a[idx]).ravel()
        inl = np.linalg.norm(a + t - b, axis=1) <= ransacThreshold
        if best is None or inl.sum() > best[0]:
            best = (inl.sum(), inl)
    _, inl = best
    t = (b[inl] - a[inl]).mean(axis=0)
    inl = np.linalg.norm(a + t - b, axis=1) <= ransacThreshold
    t = (b[inl] - a[inl]).mean(axis=0)
    return 1, t.reshape(3, 1), inl.astype(np.uint8).reshape(-1, 1)


def solveP3P(objectPoints, imagePoints, cameraMatrix, distCoeffs,
             flags=SOLVEPNP_P3P):
    """cv::solveP3P: all P3P candidates as (count, rvecs, tvecs)."""
    from . import pnp as _pnp
    obj = np.asarray(objectPoints, np.float64).reshape(-1, 3)
    img = np.asarray(imagePoints, np.float64).reshape(-1, 2)
    Km = np.asarray(cameraMatrix, np.float64).reshape(3, 3)
    und = undistortPoints(img, Km, distCoeffs).reshape(-1, 2).astype(
        np.float64)
    cands = _pnp.solve_p3p(obj, und)
    rvecs = []
    tvecs = []
    for Rm, t in cands:
        rv, _ = Rodrigues(Rm)
        rvecs.append(rv.reshape(3, 1))
        tvecs.append(t.reshape(3, 1))
    return len(rvecs), rvecs, tvecs


def _translation_lsq(src, dst):
    t = (dst - src).mean(axis=0)
    return np.array([[1.0, 0.0, t[0]], [0.0, 1.0, t[1]]], np.float64)


def estimateTranslation2D(from_, to, inliers=None, method=RANSAC,
                          ransacReprojThreshold: float = 3.0,
                          maxIters: int = 2000, confidence: float = 0.99,
                          refineIters: int = 10):
    """cv2.estimateTranslation2D: 2-dof translation via the same
    RANSAC/LSQ harness as the affine estimators (1-point samples).
    Returns the translation as a length-2 vector like the 5.x
    binding."""
    M, inl = _estimate_affine(from_, to, _translation_lsq, 1, method,
                              ransacReprojThreshold, maxIters,
                              confidence, refineIters)
    if M is None:
        return None, inl
    return M[:, 2].copy(), inl


def undistortImagePoints(src, cameraMatrix, distCoeffs, criteria=None):
    """cv::undistortImagePoints: undistort back into PIXEL coordinates
    (P = cameraMatrix)."""
    crit = criteria if criteria is not None else (3, 5, 0.01)
    out = undistortPoints(src, cameraMatrix, distCoeffs, R=None,
                          P=cameraMatrix, criteria=crit)
    return np.asarray(out, np.float32).reshape(np.asarray(src).shape)
