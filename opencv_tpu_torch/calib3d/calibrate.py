"""Camera calibration (calib3d/src/calibration.cpp cvCalibrateCamera2),
twin of ``opencv_tpu/calib3d/calibrate.py``.

The reference hand-derives analytic Jacobians for its LM solver; here the
reprojection residual is a torch float64 function of the packed parameter
vector, over all views at once, and the Jacobian comes from
``torch.func.jacfwd``.  Initialization is Zhang's method (intrinsics from
the homography constraint B = K^-T K^-1, extrinsics from H = K [r1 r2 t])
in host numpy, and the Levenberg-Marquardt loop is the JAX package's numpy
loop.  The residual runs on the device of the caller's point tensors (the
CPU for numpy points, as the JAX package's loop runs on the host).

The JAX package jits the same residual under ``jax.enable_x64``, and XLA
orders and fuses its float64 arithmetic its own way: the results agree to
about 1e-9 relative (the tests hold them to 1e-6).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd

from .geometry import findHomography, Rodrigues

__all__ = ["calibrateCamera", "calibrateCameraRO", "stereoCalibrate"]


def _host64(a, cols: int) -> np.ndarray:
    """Points as a host (n, cols) float64 array (a tensor is read back)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64).reshape(-1, cols)


def _device(*point_lists) -> torch.device:
    """The device of the first tensor among the point lists, else the CPU."""
    for pts in point_lists:
        for p in pts:
            if isinstance(p, torch.Tensor):
                return p.device
    return torch.device("cpu")


def _rodrigues_t(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) of rotation vectors (..., 3)."""
    theta = torch.linalg.norm(r, dim=-1) + 1e-12
    k = r / theta[..., None]
    z = torch.zeros_like(k[..., 0])
    Kx = torch.stack([torch.stack([z, -k[..., 2], k[..., 1]], -1),
                      torch.stack([k[..., 2], z, -k[..., 0]], -1),
                      torch.stack([-k[..., 1], k[..., 0], z], -1)], -2)
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    s = torch.sin(theta)[..., None, None]
    c = (1 - torch.cos(theta))[..., None, None]
    return eye + s * Kx + c * (Kx @ Kx)


def _distorted_pixels(fx, fy, cx, cy, dist, X):
    """Pixels (..., N, 2) of camera points X (..., N, 3) under the 5-term
    distortion (k1, k2, p1, p2, k3)."""
    k1, k2, p1, p2, k3 = dist
    x = X[..., 0] / X[..., 2]
    y = X[..., 1] / X[..., 2]
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 ** 3
    xt = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yt = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return torch.stack([fx * xt + cx, fy * yt + cy], dim=-1)


def _project_t(params, obj, nviews):
    """params = [fx fy cx cy k1 k2 p1 p2 k3, (rvec tvec)*nviews].
    obj: (nviews, N, 3).  Returns (nviews, N, 2)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    poses = params[9:9 + 6 * nviews].reshape(nviews, 6)
    R = _rodrigues_t(poses[:, :3])
    X = obj @ R.transpose(-1, -2) + poses[:, None, 3:]
    return _distorted_pixels(fx, fy, cx, cy, params[4:9], X)


def _zhang_init(homographies, image_size):
    """Closed-form intrinsics from >=3 homographies (Zhang eq. 8-9)."""
    def v(H, i, j):
        return np.array([
            H[0, i] * H[0, j],
            H[0, i] * H[1, j] + H[1, i] * H[0, j],
            H[1, i] * H[1, j],
            H[2, i] * H[0, j] + H[0, i] * H[2, j],
            H[2, i] * H[1, j] + H[1, i] * H[2, j],
            H[2, i] * H[2, j]])

    V = []
    for H in homographies:
        V.append(v(H, 0, 1))
        V.append(v(H, 0, 0) - v(H, 1, 1))
    V = np.array(V)
    _, _, vt = np.linalg.svd(V)
    b11, b12, b22, b13, b23, b33 = vt[-1]
    try:
        cy = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 * b12)
        lam = b33 - (b13 * b13 + cy * (b12 * b13 - b11 * b23)) / b11
        fx = np.sqrt(lam / b11)
        fy = np.sqrt(lam * b11 / (b11 * b22 - b12 * b12))
        cx = -b13 * fx * fx / lam
        if not (np.isfinite([fx, fy, cx, cy]).all() and fx > 0 and fy > 0):
            raise FloatingPointError
    except (FloatingPointError, ZeroDivisionError):
        # fall back to a generic initialization
        w, h = image_size
        fx = fy = 1.2 * max(w, h)
        cx, cy = (w - 1) / 2, (h - 1) / 2
    return fx, fy, cx, cy


def _extrinsics_from_h(H, K):
    Kinv = np.linalg.inv(K)
    h1, h2, h3 = H[:, 0], H[:, 1], H[:, 2]
    lam = 1.0 / np.linalg.norm(Kinv @ h1)
    r1 = lam * (Kinv @ h1)
    r2 = lam * (Kinv @ h2)
    r3 = np.cross(r1, r2)
    t = lam * (Kinv @ h3)
    R = np.stack([r1, r2, r3], axis=1)
    # orthogonalize
    u, _, vt = np.linalg.svd(R)
    R = u @ vt
    if np.linalg.det(R) < 0:
        R = -R
        t = -t
    if t[2] < 0:
        # target should be in front of the camera
        R[:, :2] *= -1
        t *= -1
    rvec, _ = Rodrigues(R)
    return np.asarray(rvec).ravel(), t


def _levenberg_marquardt(residual, params: torch.Tensor, maxiter: int) -> tuple:
    """The JAX package's LM loop (lam from 1e-3, x0.3 on a gain, x10 on a
    loss, up to 10 tries a step; stop when no try gains or the gain is
    under 1e-12 of the cost) over a torch residual of the parameter
    vector: ``(params, cost)``."""
    def res_np(p):
        return residual(p).detach().cpu().numpy()

    jac = jacfwd(residual)
    lam = 1e-3
    r = res_np(params)
    cost = float(r @ r)
    for _ in range(maxiter):
        J = jac(params).detach().cpu().numpy()
        JtJ = J.T @ J
        g = J.T @ r
        improved = 0.0
        for _ in range(10):
            try:
                step = np.linalg.solve(JtJ + lam * np.diag(np.diag(JtJ) + 1e-12), g)
            except np.linalg.LinAlgError:
                lam *= 10
                continue
            cand = params - torch.from_numpy(step).to(params.device)
            rc = res_np(cand)
            cc = float(rc @ rc)
            if cc < cost:
                params = cand
                r = rc
                lam = max(lam * 0.3, 1e-12)
                improved = cost - cc
                cost = cc
                break
            lam *= 10
        else:
            break
        if improved < 1e-12 * max(cost, 1.0):
            break
    return params, cost


def _unpack_intrinsics(p, nviews):
    K = np.array([[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1.0]])
    dist = p[4:9].reshape(1, 5)
    rv_out = [p[9 + 6 * i:12 + 6 * i].reshape(3, 1) for i in range(nviews)]
    tv_out = [p[12 + 6 * i:15 + 6 * i].reshape(3, 1) for i in range(nviews)]
    return K, dist, rv_out, tv_out


def calibrateCamera(objectPoints, imagePoints, imageSize, cameraMatrix=None,
                    distCoeffs=None, rvecs=None, tvecs=None, flags=0,
                    criteria=(3, 60, 1e-10)):
    """cv2.calibrateCamera: returns (rms, K, dist (1,5), rvecs, tvecs)."""
    dev = _device(objectPoints, imagePoints)
    objs = [_host64(o, 3) for o in objectPoints]
    imgs = [_host64(p, 2) for p in imagePoints]
    nviews = len(objs)

    Hs = []
    for o, p in zip(objs, imgs):
        H, _ = findHomography(o[:, :2], p, 0)
        Hs.append(H)
    fx, fy, cx, cy = _zhang_init(Hs, imageSize)
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])

    params = [fx, fy, cx, cy, 0.0, 0.0, 0.0, 0.0, 0.0]
    for H in Hs:
        rv, tv = _extrinsics_from_h(H, K)
        params.extend(rv)
        params.extend(tv)
    params = torch.tensor(params, dtype=torch.float64, device=dev)
    obj = torch.from_numpy(np.stack(objs)).to(dev)
    target = torch.from_numpy(np.stack(imgs)).to(dev)

    def residual(p):
        return (_project_t(p, obj, nviews) - target).reshape(-1)

    maxiter = int(criteria[1]) if len(criteria) > 1 else 60
    params, cost = _levenberg_marquardt(residual, params, maxiter)
    K, dist, rv_out, tv_out = _unpack_intrinsics(params.cpu().numpy(), nviews)
    npts = sum(len(o) for o in objs)
    rms = float(np.sqrt(cost / npts))
    return rms, K, dist, rv_out, tv_out


def _compose_t(rv1, tv1, rv2, tv2):
    """Pose composition: (R2 R1, R2 t1 + t2) of (V, 3) poses and one pose,
    back to rotation vectors (away from theta = 0 and pi, where the
    optimizer stays near its initialization)."""
    R1 = _rodrigues_t(rv1)
    R2 = _rodrigues_t(rv2)
    R = R2 @ R1
    t = tv1 @ R2.T + tv2
    tr = ((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1) / 2).clamp(-1 + 1e-9, 1 - 1e-9)
    theta = torch.arccos(tr)
    axis = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                        R[..., 1, 0] - R[..., 0, 1]], -1)
    axis = axis / (2 * torch.sin(theta) + 1e-12)[..., None]
    return axis * theta[..., None], t


def _project_fixed_k(K, dist, rv, tv, obj):
    """Pixels (V, N, 2) of obj (V, N, 3) at poses rv, tv (V, 3) through the
    fixed host camera K (3, 3) and distortion dist (5,)."""
    R = _rodrigues_t(rv)
    X = obj @ R.transpose(-1, -2) + tv[:, None, :]
    return _distorted_pixels(float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2]),
                             [float(v) for v in dist], X)


def stereoCalibrate(objectPoints, imagePoints1, imagePoints2,
                    cameraMatrix1, distCoeffs1, cameraMatrix2, distCoeffs2,
                    imageSize, R=None, T=None, flags=256,
                    criteria=(3, 100, 1e-10)):
    """cv2.stereoCalibrate with CALIB_FIX_INTRINSIC (the default):
    optimize the inter-camera pose + per-view poses by LM with
    torch.func.jacfwd Jacobians.  Returns (rms, K1, d1, K2, d2, R, T, E, F)."""
    dev = _device(objectPoints, imagePoints1, imagePoints2)
    objs = [_host64(o, 3) for o in objectPoints]
    img1 = [_host64(p, 2) for p in imagePoints1]
    img2 = [_host64(p, 2) for p in imagePoints2]
    K1 = np.asarray(cameraMatrix1, np.float64)
    K2 = np.asarray(cameraMatrix2, np.float64)
    d1 = np.pad(np.asarray(distCoeffs1, np.float64).ravel(), (0, 5))[:5]
    d2 = np.pad(np.asarray(distCoeffs2, np.float64).ravel(), (0, 5))[:5]
    nviews = len(objs)

    # init: per-view poses from PnP on cam1; (R, T) from the median
    # relative pose cam1 -> cam2
    from .geometry import solvePnP
    view_params = []
    rel_rs = []
    rel_ts = []
    for o, pa, pb in zip(objs, img1, img2):
        _, rv1, tv1 = solvePnP(o, pa, K1, d1)
        _, rv2, tv2 = solvePnP(o, pb, K2, d2)
        rv1 = np.asarray(rv1).ravel()
        tv1 = np.asarray(tv1).ravel()
        rv2 = np.asarray(rv2).ravel()
        tv2 = np.asarray(tv2).ravel()
        view_params.extend([*rv1, *tv1])
        R1m, _ = Rodrigues(rv1)
        R2m, _ = Rodrigues(rv2)
        Rrel = R2m @ R1m.T
        trel = tv2 - Rrel @ tv1
        rr, _ = Rodrigues(Rrel)
        rel_rs.append(np.asarray(rr).ravel())
        rel_ts.append(trel)
    rel_r = np.median(rel_rs, axis=0)
    rel_t = np.median(rel_ts, axis=0)

    params = torch.from_numpy(np.concatenate([[*rel_r, *rel_t], view_params])).to(dev)
    obj = torch.from_numpy(np.stack(objs)).to(dev)
    t1 = torch.from_numpy(np.stack(img1)).to(dev)
    t2 = torch.from_numpy(np.stack(img2)).to(dev)

    def residual(p):
        poses = p[6:6 + 6 * nviews].reshape(nviews, 6)
        rv, tv = poses[:, :3], poses[:, 3:]
        r1 = _project_fixed_k(K1, d1, rv, tv, obj) - t1
        rv2, tv2 = _compose_t(rv, tv, p[:3], p[3:6])
        r2 = _project_fixed_k(K2, d2, rv2, tv2, obj) - t2
        # per view: camera 1's residuals, then camera 2's
        return torch.stack([r1, r2], dim=1).reshape(-1)

    maxiter = int(criteria[1]) if len(criteria) > 1 else 100
    params, cost = _levenberg_marquardt(residual, params, maxiter)

    p = params.cpu().numpy()
    Rm, _ = Rodrigues(p[:3])
    Tm = p[3:6].reshape(3, 1)
    tx = np.array([[0, -Tm[2, 0], Tm[1, 0]],
                   [Tm[2, 0], 0, -Tm[0, 0]],
                   [-Tm[1, 0], Tm[0, 0], 0]])
    E = tx @ Rm
    F = np.linalg.inv(K2).T @ E @ np.linalg.inv(K1)
    if abs(F[2, 2]) > 1e-12:
        F = F / F[2, 2]
    npts = 2 * sum(len(o) for o in objs)
    rms = float(np.sqrt(cost / npts))
    return rms, K1, d1.reshape(1, 5), K2, d2.reshape(1, 5), Rm, Tm, E, F


def calibrateCameraRO(objectPoints, imagePoints, imageSize, iFixedPoint,
                      cameraMatrix=None, distCoeffs=None, rvecs=None,
                      tvecs=None, newObjPoints=None, flags=0,
                      criteria=(3, 60, 1e-10)):
    """cv2.calibrateCameraRO (calibration.cpp:1334, Strobl's released
    object points method): when 0 < iFixedPoint < N-1, the shared
    object-point set is refined jointly with intrinsics/extrinsics,
    holding point 0, point iFixedPoint (all coordinates), and the last
    point's z fixed (calibration.cpp:398-405).

    Returns (rms, K, dist(1,5), rvecs, tvecs, newObjPoints)."""
    dev = _device(objectPoints, imagePoints)
    objs = [_host64(o, 3) for o in objectPoints]
    imgs = [_host64(p, 2) for p in imagePoints]
    nviews = len(objs)
    N = len(objs[0])
    release = 0 < iFixedPoint < N - 1
    if not release:
        rms, K, dist, rv, tv = calibrateCamera(
            objectPoints, imagePoints, imageSize, cameraMatrix,
            distCoeffs, flags=flags, criteria=criteria)
        return rms, K, dist, rv, tv, np.asarray(objs[0])

    # ---- initialize with the standard calibration
    _, K, dist, rv0, tv0 = calibrateCamera(
        objectPoints, imagePoints, imageSize, flags=flags,
        criteria=criteria)

    base = objs[0].ravel().copy()          # 3N template coordinates
    fixed = np.zeros(3 * N, bool)
    fixed[0:3] = True
    fixed[3 * iFixedPoint:3 * iFixedPoint + 3] = True
    fixed[3 * N - 1] = True                # z of the last point
    free_idx = np.nonzero(~fixed)[0]

    p0 = [K[0, 0], K[1, 1], K[0, 2], K[1, 2]] \
        + list(np.asarray(dist).ravel()[:5])
    for rv_i, tv_i in zip(rv0, tv0):
        p0 += list(np.asarray(rv_i).ravel())
        p0 += list(np.asarray(tv_i).ravel())
    p0 += list(base[free_idx])
    params = torch.from_numpy(np.asarray(p0, np.float64)).to(dev)

    target = torch.from_numpy(np.stack(imgs)).to(dev)
    base_t = torch.from_numpy(base).to(dev)
    free_t = torch.from_numpy(free_idx).to(dev)
    next_ = 9 + 6 * nviews

    def residual(p):
        obj1 = base_t.index_put((free_t,), p[next_:]).reshape(N, 3)
        obj = obj1.expand(nviews, N, 3)
        return (_project_t(p[:next_], obj, nviews) - target).reshape(-1)

    maxiter = int(criteria[1]) if len(criteria) > 1 else 60
    params, cost = _levenberg_marquardt(residual, params, maxiter)

    p = params.cpu().numpy()
    K, dist, rv_out, tv_out = _unpack_intrinsics(p, nviews)
    newobj = base.copy()
    newobj[free_idx] = p[next_:]
    npts = sum(len(o) for o in objs)
    rms = float(np.sqrt(cost / npts))
    return (rms, K, dist, rv_out, tv_out,
            newobj.reshape(N, 3).astype(np.float32))
