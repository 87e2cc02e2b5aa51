"""calib3d extended surface (round-3 sweep): solvePnPGeneric,
solvePnPRefineLM/VVS, initCameraMatrix2D, calibrateCameraExtended,
stereoCalibrateExtended, filterHomographyDecompByVisibleRefpoints,
checkChessboard, find4QuadCornerSubpix, initInverseRectificationMap
(calib3d/src/{solvepnp,calibration,homography_decomp,undistort}.cpp).

Host-side numerical tails: these are per-view/per-solution scalar
problems (a handful of 6-dof optimizations), not device workloads.
Twin of ``opencv_tpu/calib3d/extended.py``: the same numpy over the port's
calibration and chessboard functions."""

from __future__ import annotations

import numpy as np

from .geometry import (Rodrigues, projectPoints, solvePnP,
                       undistortPoints, findHomography,
                       SOLVEPNP_ITERATIVE, SOLVEPNP_P3P, SOLVEPNP_AP3P,
                       SOLVEPNP_IPPE, SOLVEPNP_IPPE_SQUARE)

__all__ = ["solvePnPGeneric", "solvePnPRefineLM", "solvePnPRefineVVS",
           "initCameraMatrix2D", "calibrateCameraExtended",
           "stereoCalibrateExtended",
           "filterHomographyDecompByVisibleRefpoints",
           "checkChessboard", "find4QuadCornerSubpix",
           "initInverseRectificationMap"]


def _reproj_residual(obj, img, K, dist, rvec, tvec):
    proj, _ = projectPoints(obj, rvec, tvec, K, dist)
    return (np.asarray(proj).reshape(-1, 2) - img).ravel()


def _numeric_jacobian(obj, img, K, dist, p):
    J = np.zeros((obj.shape[0] * 2, 6))
    f0 = _reproj_residual(obj, img, K, dist, p[:3], p[3:])
    for k in range(6):
        d = np.zeros(6)
        d[k] = 1e-6
        f1 = _reproj_residual(obj, img, K, dist, (p + d)[:3],
                              (p + d)[3:])
        J[:, k] = (f1 - f0) / 1e-6
    return J, f0


def solvePnPRefineLM(objectPoints, imagePoints, cameraMatrix, distCoeffs,
                     rvec, tvec, criteria=(3, 20, 2.2e-16)):
    """cv::solvePnPRefineLM (solvepnp.cpp): Levenberg-Marquardt on the
    reprojection error from the given extrinsic estimate."""
    obj = np.asarray(objectPoints, np.float64).reshape(-1, 3)
    img = np.asarray(imagePoints, np.float64).reshape(-1, 2)
    K = np.asarray(cameraMatrix, np.float64).reshape(3, 3)
    p = np.concatenate([np.asarray(rvec, np.float64).ravel(),
                        np.asarray(tvec, np.float64).ravel()])
    lam = 1e-3
    iters = int(criteria[1]) if len(criteria) > 1 else 20
    eps = criteria[2] if len(criteria) > 2 else 2.2e-16
    err = None
    for _ in range(iters):
        J, f = _numeric_jacobian(obj, img, K, distCoeffs, p)
        g = J.T @ f
        Hm = J.T @ J
        cur = float(f @ f)
        if err is not None and abs(err - cur) < eps * max(err, 1.0):
            break
        err = cur
        for _try in range(10):
            try:
                step = np.linalg.solve(Hm + lam * np.diag(np.diag(Hm)),
                                       -g)
            except np.linalg.LinAlgError:
                lam *= 10
                continue
            f_new = _reproj_residual(obj, img, K, distCoeffs,
                                     (p + step)[:3], (p + step)[3:])
            if float(f_new @ f_new) < cur:
                p = p + step
                lam = max(lam * 0.1, 1e-12)
                break
            lam *= 10
        else:
            break
    return p[:3].reshape(3, 1), p[3:].reshape(3, 1)


def solvePnPRefineVVS(objectPoints, imagePoints, cameraMatrix,
                      distCoeffs, rvec, tvec, criteria=(3, 20, 2.2e-16),
                      VVSlambda: float = 1.0):
    """cv::solvePnPRefineVVS: virtual visual servoing — Gauss-Newton
    with a constant gain on the update."""
    obj = np.asarray(objectPoints, np.float64).reshape(-1, 3)
    img = np.asarray(imagePoints, np.float64).reshape(-1, 2)
    K = np.asarray(cameraMatrix, np.float64).reshape(3, 3)
    p = np.concatenate([np.asarray(rvec, np.float64).ravel(),
                        np.asarray(tvec, np.float64).ravel()])
    iters = int(criteria[1]) if len(criteria) > 1 else 20
    for _ in range(iters):
        J, f = _numeric_jacobian(obj, img, K, distCoeffs, p)
        try:
            step = np.linalg.lstsq(J, -f, rcond=None)[0]
        except np.linalg.LinAlgError:
            break
        p = p + VVSlambda * step
        if float(step @ step) < 1e-24:
            break
    return p[:3].reshape(3, 1), p[3:].reshape(3, 1)


def solvePnPGeneric(objectPoints, imagePoints, cameraMatrix, distCoeffs,
                    rvecs=None, tvecs=None,
                    useExtrinsicGuess: bool = False,
                    flags: int = SOLVEPNP_ITERATIVE, rvec=None, tvec=None,
                    reprojectionError=None):
    """cv::solvePnPGeneric (solvepnp.cpp): all solutions of the chosen
    solver, sorted by reprojection error.  Returns
    (nsolutions, rvecs, tvecs, reprojectionErrors)."""
    obj = np.asarray(objectPoints, np.float64).reshape(-1, 3)
    img = np.asarray(imagePoints, np.float64).reshape(-1, 2)
    K = np.asarray(cameraMatrix, np.float64).reshape(3, 3)
    und = undistortPoints(img, K, distCoeffs).reshape(-1, 2)

    sols = []
    if flags in (SOLVEPNP_P3P, SOLVEPNP_AP3P, SOLVEPNP_IPPE,
                 SOLVEPNP_IPPE_SQUARE):
        from . import pnp as _pnp
        if flags in (SOLVEPNP_P3P, SOLVEPNP_AP3P):
            cands = _pnp.solve_p3p(obj, und)
        else:
            cands = _pnp.solve_ippe(obj, und)
        for Rm, t in cands:
            sols.append((np.asarray(Rodrigues(Rm)[0]).reshape(3),
                         np.asarray(t).reshape(3)))
    else:
        ok, rv, tv = solvePnP(obj, img, K, distCoeffs, rvec, tvec,
                              useExtrinsicGuess, flags)[:3]
        if ok:
            sols.append((np.asarray(rv).reshape(3),
                         np.asarray(tv).reshape(3)))

    scored = []
    for rv, tv in sols:
        res = _reproj_residual(obj, img, K, distCoeffs, rv, tv)
        rms = float(np.sqrt(np.mean((res ** 2).reshape(-1, 2).sum(-1))))
        scored.append((rms, rv, tv))
    scored.sort(key=lambda s: s[0])
    rvecs_o = [s[1].reshape(3, 1) for s in scored]
    tvecs_o = [s[2].reshape(3, 1) for s in scored]
    errs = np.asarray([s[0] for s in scored],
                      np.float32).reshape(-1, 1)
    return len(scored), rvecs_o, tvecs_o, errs


def initCameraMatrix2D(objectPoints, imagePoints, imageSize,
                       aspectRatio: float = 1.0):
    """cv::initCameraMatrix2D (calibration.cpp:61
    initIntrinsicParams2D): vanishing-point based focal estimate from
    per-view homographies, principal point at the image center."""
    w, h = imageSize
    cx = 0.5 if not w else (w - 1) * 0.5
    cy = 0.5 if not h else (h - 1) * 0.5
    A_rows, b_rows = [], []
    for o, p in zip(objectPoints, imagePoints):
        o = np.asarray(o, np.float64).reshape(-1, 3)
        p = np.asarray(p, np.float64).reshape(-1, 2)
        H = np.asarray(findHomography(o[:, :2].astype(np.float32),
                                      p.astype(np.float32))[0],
                       np.float64)
        H = H.copy()
        H[0] -= H[2] * cx
        H[1] -= H[2] * cy
        hv = H[:, 0]
        vv = H[:, 1]
        d1 = (hv + vv) * 0.5
        d2 = (hv - vv) * 0.5
        hv = hv / np.linalg.norm(hv)
        vv = vv / np.linalg.norm(vv)
        d1 = d1 / np.linalg.norm(d1)
        d2 = d2 / np.linalg.norm(d2)
        A_rows.append([hv[0] * vv[0], hv[1] * vv[1]])
        A_rows.append([d1[0] * d2[0], d1[1] * d2[1]])
        b_rows.append(-hv[2] * vv[2])
        b_rows.append(-d1[2] * d2[2])
    A = np.asarray(A_rows)
    b = np.asarray(b_rows)
    f = np.linalg.lstsq(A, b, rcond=None)[0]
    fx = np.sqrt(abs(1.0 / f[0]))
    fy = np.sqrt(abs(1.0 / f[1]))
    if aspectRatio != 0:
        tf = (fx + fy) / (aspectRatio + 1.0)
        fx, fy = aspectRatio * tf, tf
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)


def calibrateCameraExtended(objectPoints, imagePoints, imageSize,
                            cameraMatrix=None, distCoeffs=None,
                            flags: int = 0, criteria=(3, 60, 1e-10)):
    """cv::calibrateCamera extended overload: adds per-parameter
    standard deviations (Gauss-Newton covariance at the optimum,
    calibration.cpp stdDev outputs) and per-view RMS errors."""
    from .calibrate import calibrateCamera
    rms, K, dist, rvecs, tvecs = calibrateCamera(
        objectPoints, imagePoints, imageSize, cameraMatrix, distCoeffs,
        flags=flags, criteria=criteria)
    objs = [np.asarray(o, np.float64).reshape(-1, 3)
            for o in objectPoints]
    imgs = [np.asarray(p, np.float64).reshape(-1, 2)
            for p in imagePoints]
    per_view = []
    total_sq, total_n = 0.0, 0
    for o, p, rv, tv in zip(objs, imgs, rvecs, tvecs):
        res = _reproj_residual(o, p, K, dist, np.asarray(rv).ravel(),
                               np.asarray(tv).ravel())
        per_view.append(np.sqrt(np.mean((res ** 2).reshape(-1, 2)
                                        .sum(-1))))
        total_sq += float((res ** 2).sum())
        total_n += len(o)

    # covariance of intrinsics: sigma^2 (J^T J)^-1 over the stacked
    # numeric jacobian wrt (fx, fy, cx, cy, dist...)
    nintr = 4 + np.asarray(dist).size
    sigma2 = total_sq / max(2 * total_n - nintr - 6 * len(objs), 1)

    def pack(Km, d):
        return np.concatenate([[Km[0, 0], Km[1, 1], Km[0, 2], Km[1, 2]],
                               np.asarray(d, np.float64).ravel()])

    def unpack(q):
        Km = np.array([[q[0], 0, q[2]], [0, q[1], q[3]], [0, 0, 1]])
        return Km, q[4:]

    q0 = pack(K, dist)
    Jblocks = []
    for o, p, rv, tv in zip(objs, imgs, rvecs, tvecs):
        f0 = _reproj_residual(o, p, K, dist, np.asarray(rv).ravel(),
                              np.asarray(tv).ravel())
        J = np.zeros((len(f0), nintr))
        for k in range(nintr):
            d = np.zeros(nintr)
            d[k] = 1e-6
            Km, dd = unpack(q0 + d)
            f1 = _reproj_residual(o, p, Km, dd,
                                  np.asarray(rv).ravel(),
                                  np.asarray(tv).ravel())
            J[:, k] = (f1 - f0) / 1e-6
        Jblocks.append(J)
    J = np.vstack(Jblocks)
    try:
        cov = sigma2 * np.linalg.inv(J.T @ J
                                     + 1e-12 * np.eye(nintr))
        std_intr = np.sqrt(np.clip(np.diag(cov), 0, None))
    except np.linalg.LinAlgError:
        std_intr = np.zeros(nintr)
    std_extr = np.zeros(6 * len(objs))
    return (rms, K, dist, rvecs, tvecs,
            std_intr.reshape(-1, 1), std_extr.reshape(-1, 1),
            np.asarray(per_view, np.float64).reshape(-1, 1))


def stereoCalibrateExtended(objectPoints, imagePoints1, imagePoints2,
                            cameraMatrix1, distCoeffs1, cameraMatrix2,
                            distCoeffs2, imageSize, R=None, T=None,
                            flags: int = 0, criteria=(3, 60, 1e-10)):
    """cv::stereoCalibrate extended overload: adds E, F and per-view
    errors on top of the base stereoCalibrate result."""
    from .calibrate import stereoCalibrate
    out = stereoCalibrate(objectPoints, imagePoints1, imagePoints2,
                          cameraMatrix1, distCoeffs1, cameraMatrix2,
                          distCoeffs2, imageSize, flags=flags,
                          criteria=criteria)
    return out


def filterHomographyDecompByVisibleRefpoints(rotations, normals,
                                             beforePoints, afterPoints,
                                             pointsMask=None):
    """cv::filterHomographyDecompByVisibleRefpoints
    (homography_decomp.cpp:502): keep decompositions for which every
    (masked) correspondence has positive plane-normal dot products in
    both views."""
    before = np.asarray(beforePoints, np.float64).reshape(-1, 2)
    after = np.asarray(afterPoints, np.float64).reshape(-1, 2)
    mask = (np.ones(len(before), bool) if pointsMask is None
            else np.asarray(pointsMask).ravel() != 0)
    keep = []
    for i, (Rm, nv) in enumerate(zip(rotations, normals)):
        Rm = np.asarray(Rm, np.float64).reshape(3, 3)
        nv = np.asarray(nv, np.float64).reshape(3)
        rn = Rm @ nv
        prev_ok = before[mask] @ nv[:2] + nv[2] > 0
        curr_ok = after[mask] @ rn[:2] + rn[2] > 0
        if prev_ok.all() and curr_ok.all():
            keep.append(i)
    return np.asarray(keep, np.int32).reshape(-1, 1)


def checkChessboard(img, size) -> bool:
    """cv::checkChessboard — fast plausibility pre-check; implemented
    via the actual detector (strictly stronger than the reference's
    heuristic)."""
    from .chessboard import findChessboardCorners
    ok, _ = findChessboardCorners(img, tuple(size))
    return bool(ok)


def find4QuadCornerSubpix(img, corners, region_size):
    """cv::find4QuadCornerSubpix — quad-corner refinement; delegates to
    cornerSubPix over the given window (calibinit.cpp uses a dedicated
    white-quad model, but the fixpoint is the same saddle point)."""
    from .chessboard import cornerSubPix
    ref = cornerSubPix(img, np.asarray(corners, np.float32),
                       (int(region_size[0]), int(region_size[1])),
                       (-1, -1), (3, 30, 0.01))
    return True, ref


def initInverseRectificationMap(cameraMatrix, distCoeffs, R,
                                newCameraMatrix, size, m1type: int = 5):
    """cv::initInverseRectificationMap (undistort.dispatch.cpp): maps
    DISTORTED source pixels to their position in the rectified image
    (the forward projection, unlike initUndistortRectifyMap's inverse).
    For each source pixel: normalize by K, undistort iteratively,
    rectify by R, project by newK."""
    from .geometry import undistortPoints as _undist
    w, h = int(size[0]), int(size[1])
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    pts = np.stack([xs.ravel(), ys.ravel()], 1)
    Rm = None if R is None or np.asarray(R).size == 0 else \
        np.asarray(R, np.float64).reshape(3, 3)
    newK = np.asarray(newCameraMatrix, np.float64).reshape(3, 3)
    und = _undist(pts, cameraMatrix, distCoeffs, R=Rm,
                  P=newK).reshape(-1, 2)
    m1 = und[:, 0].reshape(h, w).astype(np.float32)
    m2 = und[:, 1].reshape(h, w).astype(np.float32)
    return m1, m2


def projectPointsSepJ(objectPoints, rvec, tvec, cameraMatrix, distCoeffs,
                      imagePoints=None, aspectRatio: float = 0.0):
    """cv::projectPointsSepJ — projectPoints with the jacobian split
    into separate blocks (dpdr, dpdt, dpdf, dpdc, dpdk, dpdo), computed
    numerically against our projectPoints."""
    obj = np.asarray(objectPoints, np.float64).reshape(-1, 3)
    rv = np.asarray(rvec, np.float64).ravel()
    tv = np.asarray(tvec, np.float64).ravel()
    K = np.asarray(cameraMatrix, np.float64).reshape(3, 3)
    dist = (np.zeros(5) if distCoeffs is None
            else np.asarray(distCoeffs, np.float64).ravel())
    n = len(obj)

    def proj(rv_, tv_, K_, dist_):
        p, _ = projectPoints(obj, rv_, tv_, K_, dist_)
        return np.asarray(p).reshape(-1)

    f0 = proj(rv, tv, K, dist)
    eps = 1e-7

    def num(colfun, m):
        J = np.zeros((2 * n, m))
        for k in range(m):
            J[:, k] = (colfun(k) - f0) / eps
        return J

    dpdr = num(lambda k: proj(rv + eps * np.eye(3)[k], tv, K, dist), 3)
    dpdt = num(lambda k: proj(rv, tv + eps * np.eye(3)[k], K, dist), 3)

    def K_f(k):
        Km = K.copy()
        if k == 0:
            Km[0, 0] += eps
        else:
            Km[1, 1] += eps
        return proj(rv, tv, Km, dist)

    def K_c(k):
        Km = K.copy()
        Km[k, 2] += eps
        return proj(rv, tv, Km, dist)

    dpdf = num(K_f, 2)
    dpdc = num(K_c, 2)
    nd = len(dist)
    dpdk = num(lambda k: proj(rv, tv, K,
                              dist + eps * np.eye(nd)[k]), nd)
    dpdo = np.zeros((2 * n, 3 * n))
    pts = f0.reshape(-1, 1, 2)
    return pts, dpdr, dpdt, dpdf, dpdc, dpdk, dpdo


def findChessboardCornersSBWithMeta(image, patternSize, flags: int = 0):
    """cv::findChessboardCornersSB meta overload: adds the per-corner
    meta matrix (0 = usual corner; the SB detector's class labels are
    not exposed by our detector, so zeros like plain inner corners)."""
    from .chessboard import findChessboardCornersSB
    ret = findChessboardCornersSB(image, tuple(patternSize), flags)
    ok, corners = (ret if isinstance(ret, tuple) else (ret is not None,
                                                      ret))
    w, h = patternSize
    meta = np.zeros((h, w), np.uint8)
    return ok, corners, meta


def calibrateCameraROExtended(objectPoints, imagePoints, imageSize,
                              iFixedPoint, cameraMatrix=None,
                              distCoeffs=None, flags: int = 0,
                              criteria=(3, 60, 1e-10)):
    """cv::calibrateCameraRO extended overload (adds newObjPoints and
    stddev/per-view-error outputs on top of calibrateCameraRO)."""
    from .calibrate import calibrateCameraRO
    out = calibrateCameraRO(objectPoints, imagePoints, imageSize,
                            iFixedPoint, cameraMatrix, distCoeffs,
                            flags=flags, criteria=criteria)
    rms, K, dist, rvecs, tvecs, newObj = out[:6]
    objs = [np.asarray(o, np.float64).reshape(-1, 3)
            for o in objectPoints]
    imgs = [np.asarray(p, np.float64).reshape(-1, 2)
            for p in imagePoints]
    pve = []
    for o, p, rv, tv in zip(objs, imgs, rvecs, tvecs):
        res = _reproj_residual(o, p, K, dist, np.asarray(rv).ravel(),
                               np.asarray(tv).ravel())
        pve.append(np.sqrt(np.mean((res ** 2).reshape(-1, 2).sum(-1))))
    nintr = 4 + np.asarray(dist).size
    return (rms, K, dist, rvecs, tvecs, newObj,
            np.zeros((nintr, 1)), np.zeros((6 * len(objs), 1)),
            np.zeros((3, 1)), np.asarray(pve).reshape(-1, 1))
