"""Fisheye (equidistant) camera model (calib3d/src/fisheye.cpp).

The model is theta-polynomial: r = tan-free, theta_d = theta (1 + k1
theta^2 + k2 theta^4 + k3 theta^6 + k4 theta^8).  All point transforms
are vectorized host f64; the undistort maps evaluate densely.
Twin of ``opencv_tpu/calib3d/fisheye.py``: the same numpy (the maps too,
whose arctan and hypot are numpy's), with undistortImage's remap on the
image's device.
"""

from __future__ import annotations

import numpy as np

from .geometry import Rodrigues

__all__ = ["projectPoints", "distortPoints", "undistortPoints",
           "initUndistortRectifyMap", "undistortImage",
           "estimateNewCameraMatrixForUndistortRectify"]


def _theta_d(theta, k):
    t2 = theta * theta
    return theta * (1 + k[0] * t2 + k[1] * t2 ** 2 + k[2] * t2 ** 3
                    + k[3] * t2 ** 4)


def projectPoints(objectPoints, rvec, tvec, K, D, alpha=0.0):
    """fisheye::projectPoints: returns (imagePoints (N,1,2), jacobian)."""
    obj = np.asarray(objectPoints, np.float64).reshape(-1, 3)
    R, _ = Rodrigues(np.asarray(rvec, np.float64).ravel())
    t = np.asarray(tvec, np.float64).ravel()
    Km = np.asarray(K, np.float64)
    k = np.asarray(D, np.float64).ravel()
    k = np.pad(k, (0, max(0, 4 - len(k))))[:4]

    Xc = obj @ R.T + t
    a = Xc[:, 0] / Xc[:, 2]
    b = Xc[:, 1] / Xc[:, 2]
    r = np.hypot(a, b)
    theta = np.arctan(r)
    td = _theta_d(theta, k)
    scale = np.where(r > 1e-12, td / np.maximum(r, 1e-12), 1.0)
    xd = a * scale
    yd = b * scale
    u = Km[0, 0] * (xd + alpha * yd) + Km[0, 2]
    v = Km[1, 1] * yd + Km[1, 2]
    return np.stack([u, v], -1).reshape(-1, 1, 2), None


def distortPoints(undistorted, K, D, alpha=0.0):
    """fisheye::distortPoints: normalized-plane pinhole points ->
    distorted pixel points."""
    pts = np.asarray(undistorted, np.float64).reshape(-1, 2)
    Km = np.asarray(K, np.float64)
    k = np.pad(np.asarray(D, np.float64).ravel(), (0, 4))[:4]
    x = pts[:, 0]
    y = pts[:, 1]
    r = np.hypot(x, y)
    theta = np.arctan(r)
    td = _theta_d(theta, k)
    scale = np.where(r > 1e-12, td / np.maximum(r, 1e-12), 1.0)
    xd = x * scale
    yd = y * scale
    u = Km[0, 0] * (xd + alpha * yd) + Km[0, 2]
    v = Km[1, 1] * yd + Km[1, 2]
    return np.stack([u, v], -1).reshape(np.asarray(undistorted).shape)


def _undistort_theta(theta_d, k, iters=10):
    """Invert theta_d -> theta by fixed-point Newton (fisheye.cpp
    undistortPoints loop)."""
    theta = theta_d.copy()
    for _ in range(iters):
        t2 = theta * theta
        t4 = t2 * t2
        t6 = t4 * t2
        t8 = t4 * t4
        k0t2 = k[0] * t2
        k1t4 = k[1] * t4
        k2t6 = k[2] * t6
        k3t8 = k[3] * t8
        num = theta * (1 + k0t2 + k1t4 + k2t6 + k3t8) - theta_d
        den = 1 + 3 * k0t2 + 5 * k1t4 + 7 * k2t6 + 9 * k3t8
        theta = theta - num / den
    return theta


def undistortPoints(distorted, K, D, R=None, P=None, criteria=None):
    pts = np.asarray(distorted, np.float64).reshape(-1, 2)
    Km = np.asarray(K, np.float64)
    k = np.pad(np.asarray(D, np.float64).ravel(), (0, 4))[:4]
    xd = (pts[:, 0] - Km[0, 2]) / Km[0, 0]
    yd = (pts[:, 1] - Km[1, 2]) / Km[1, 1]
    theta_d = np.hypot(xd, yd)
    theta_d_clipped = np.clip(theta_d, -np.pi / 2, np.pi / 2)
    theta = _undistort_theta(theta_d_clipped, k)
    scale = np.where(theta_d > 1e-12,
                     np.tan(theta) / np.maximum(theta_d, 1e-12), 1.0)
    x = xd * scale
    y = yd * scale
    pts3 = np.stack([x, y, np.ones_like(x)], -1)
    if R is not None and np.asarray(R).size:
        Rm = np.asarray(R, np.float64)
        if Rm.size == 3:
            Rm, _ = Rodrigues(Rm.ravel())
        pts3 = pts3 @ Rm.T
    x = pts3[:, 0] / pts3[:, 2]
    y = pts3[:, 1] / pts3[:, 2]
    if P is not None and np.asarray(P).size:
        Pm = np.asarray(P, np.float64)
        u = Pm[0, 0] * x + Pm[0, 1] * y + Pm[0, 2]
        v = Pm[1, 1] * y + Pm[1, 2]
        out = np.stack([u, v], -1)
    else:
        out = np.stack([x, y], -1)
    return out.reshape(np.asarray(distorted).shape).astype(
        np.asarray(distorted).dtype if
        np.asarray(distorted).dtype in (np.float32, np.float64)
        else np.float64)


def initUndistortRectifyMap(K, D, R, P, size, m1type=None):
    w, h = size
    Km = np.asarray(K, np.float64)
    k = np.pad(np.asarray(D, np.float64).ravel(), (0, 4))[:4]
    if R is None or not np.asarray(R).size:
        Rm = np.eye(3)
    else:
        Rm = np.asarray(R, np.float64)
        if Rm.size == 3:
            Rm, _ = Rodrigues(Rm.ravel())
    Pm = np.asarray(P, np.float64)[:3, :3] if P is not None \
        and np.asarray(P).size else Km
    iR = np.linalg.inv(Pm @ Rm)

    us, vs = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    x = iR[0, 0] * us + iR[0, 1] * vs + iR[0, 2]
    y = iR[1, 0] * us + iR[1, 1] * vs + iR[1, 2]
    wz = iR[2, 0] * us + iR[2, 1] * vs + iR[2, 2]
    x = x / wz
    y = y / wz
    r = np.hypot(x, y)
    theta = np.arctan(r)
    td = _theta_d(theta, k)
    scale = np.where(r > 1e-12, td / np.maximum(r, 1e-12), 1.0)
    u = Km[0, 0] * x * scale + Km[0, 2]
    v = Km[1, 1] * y * scale + Km[1, 2]
    return u.astype(np.float32), v.astype(np.float32)


def undistortImage(distorted, K, D, Knew=None, new_size=None):
    from ..ops.warp import remap
    from .. import constants as KK
    from ..core.arrays import as_tensor
    img = as_tensor(distorted)
    h, w = img.shape[:2]
    if new_size is not None and new_size[0]:
        w2, h2 = new_size
    else:
        w2, h2 = w, h
    Kn = Knew if Knew is not None and np.asarray(Knew).size else K
    m1, m2 = initUndistortRectifyMap(K, D, None, Kn, (w2, h2))
    return remap(img, m1, m2, KK.INTER_LINEAR)


def estimateNewCameraMatrixForUndistortRectify(K, D, image_size, R,
                                               balance=0.0, new_size=None,
                                               fov_scale=1.0):
    """fisheye::estimateNewCameraMatrixForUndistortRectify."""
    w, h = image_size
    Km = np.asarray(K, np.float64)
    balance = min(max(balance, 0.0), 1.0)
    # undistort the border midpoints
    pts = np.array([[w / 2, 0], [w, h / 2], [w / 2, h], [0, h / 2]],
                   np.float64)
    und = undistortPoints(pts.reshape(-1, 1, 2), Km, D,
                          R=np.asarray(R) if R is not None
                          and np.asarray(R).size else None)
    und = np.asarray(und, np.float64).reshape(-1, 2)
    cn = und.mean(axis=0)
    aspect = Km[0, 0] / Km[1, 1]
    # convert to identical fx (fisheye.cpp scales y by aspect)
    und[:, 1] *= aspect
    cn[1] *= aspect
    minx, miny = und.min(axis=0)
    maxx, maxy = und.max(axis=0)
    f1 = w * 0.5 / (cn[0] - minx)
    f2 = w * 0.5 / (maxx - cn[0])
    f3 = h * 0.5 * aspect / (cn[1] - miny)
    f4 = h * 0.5 * aspect / (maxy - cn[1])
    fmin = min(f1, min(f2, min(f3, f4)))
    fmax = max(f1, max(f2, max(f3, f4)))
    f = balance * fmin + (1.0 - balance) * fmax
    if fov_scale > 0:
        f *= 1.0 / fov_scale
    new_f = np.array([f, f / aspect])
    new_c = -cn * f + np.array([w, h * aspect]) * 0.5
    new_c[1] /= aspect
    if new_size is not None and new_size[0]:
        rx = new_size[0] / w
        ry = new_size[1] / h
        new_f[0] *= rx
        new_f[1] *= ry
        new_c[0] *= rx
        new_c[1] *= ry
    out = np.eye(3)
    out[0, 0] = new_f[0]
    out[1, 1] = new_f[1]
    out[0, 2] = new_c[0]
    out[1, 2] = new_c[1]
    return out
