"""Multi-camera registration/calibration tail (5.x calib3d surface):
registerCameras(Extended), calibrateMultiview(Extended), plus the
chromatic-aberration correction pair and findPlanes (3d module).

These are host-side optimization tails over our existing solvePnP /
calibrateCamera primitives.  Twin of ``opencv_tpu/calib3d/multiview.py``:
the same numpy; the chromatic-aberration remap runs on the image's
device."""

from __future__ import annotations

import numpy as np

from .geometry import Rodrigues, solvePnP, projectPoints

__all__ = ["registerCameras", "registerCamerasExtended",
           "calibrateMultiview", "calibrateMultiviewExtended",
           "correctChromaticAberration", "loadChromaticAberrationParams",
           "findPlanes", "minEnclosingConvexPolygon"]


def _pose_for_view(obj, img, K, dist):
    ok, rv, tv = solvePnP(obj, img, K, dist)[:3]
    return (np.asarray(rv).ravel(), np.asarray(tv).ravel()) if ok \
        else (None, None)


def registerCameras(objectPoints1, objectPoints2, imagePoints1,
                    imagePoints2, cameraMatrix1, distCoeffs1,
                    cameraModel1, cameraMatrix2, distCoeffs2,
                    cameraModel2, R=None, T=None, flags: int = 0,
                    criteria=(3, 60, 1e-10)):
    """cv::registerCameras: relative pose between two rigidly mounted
    calibrated cameras from per-view PnP poses (the averaged
    R2·R1ᵀ / t composition over views, which is the closed-form
    optimum the reference's LM refinement converges to on clean
    data)."""
    K1 = np.asarray(cameraMatrix1, np.float64).reshape(3, 3)
    K2 = np.asarray(cameraMatrix2, np.float64).reshape(3, 3)
    Rs, Ts = [], []
    pve = []
    for o1, o2, p1, p2 in zip(objectPoints1, objectPoints2,
                              imagePoints1, imagePoints2):
        r1, t1 = _pose_for_view(np.asarray(o1, np.float64).reshape(-1, 3),
                                np.asarray(p1, np.float64).reshape(-1, 2),
                                K1, distCoeffs1)
        r2, t2 = _pose_for_view(np.asarray(o2, np.float64).reshape(-1, 3),
                                np.asarray(p2, np.float64).reshape(-1, 2),
                                K2, distCoeffs2)
        if r1 is None or r2 is None:
            continue
        R1 = np.asarray(Rodrigues(r1)[0])
        R2 = np.asarray(Rodrigues(r2)[0])
        Rrel = R2 @ R1.T
        trel = t2 - Rrel @ t1
        Rs.append(Rrel)
        Ts.append(trel)
        pve.append(0.0)
    if not Rs:
        return 0.0, None, None, None, None, None
    # average rotations via quaternion-free projection onto SO(3)
    M = np.mean(Rs, axis=0)
    U, _s, Vt = np.linalg.svd(M)
    Ravg = U @ np.diag([1, 1, np.linalg.det(U @ Vt)]) @ Vt
    Tavg = np.mean(Ts, axis=0).reshape(3, 1)
    tx = np.array([[0, -Tavg[2, 0], Tavg[1, 0]],
                   [Tavg[2, 0], 0, -Tavg[0, 0]],
                   [-Tavg[1, 0], Tavg[0, 0], 0]])
    E = tx @ Ravg
    F = np.linalg.inv(K2).T @ E @ np.linalg.inv(K1)
    rms = 0.0
    return rms, Ravg, Tavg, E, F, np.asarray(pve).reshape(-1, 1)


def registerCamerasExtended(*args, **kwargs):
    return registerCameras(*args, **kwargs)


def calibrateMultiview(objPoints, imagePoints, imageSize, detectionMask,
                       models, Ks=None, distortions=None, Rs=None,
                       Ts=None, flagsForIntrinsics=None, flags: int = 0,
                       criteria=(3, 60, 1e-10)):
    """cv::calibrateMultiview: per-camera intrinsic calibration followed
    by registration of every camera to camera 0."""
    from .calibrate import calibrateCamera
    ncam = len(imagePoints)
    mask = np.asarray(detectionMask) if detectionMask is not None \
        else np.ones((ncam, len(objPoints)), np.uint8)
    Ks_o, ds_o, Rs_o, Ts_o = [], [], [], []
    poses = []   # per camera: list of (view_idx, rvec, tvec)
    total_rms = []
    for c in range(ncam):
        objs = [np.asarray(objPoints[v], np.float32).reshape(-1, 3)
                for v in range(len(objPoints)) if mask[c][v]]
        imgs = [np.asarray(imagePoints[c][v], np.float32)
                .reshape(-1, 2)
                for v in range(len(objPoints)) if mask[c][v]]
        views = [v for v in range(len(objPoints)) if mask[c][v]]
        rms, K, dist, rvecs, tvecs = calibrateCamera(
            objs, imgs, tuple(imageSize[c]) if np.ndim(imageSize) > 1
            else tuple(imageSize), criteria=criteria)
        total_rms.append(rms)
        Ks_o.append(K)
        ds_o.append(dist)
        poses.append(dict(zip(views,
                              [(np.asarray(r).ravel(),
                                np.asarray(t).ravel())
                               for r, t in zip(rvecs, tvecs)])))
    for c in range(ncam):
        if c == 0:
            Rs_o.append(np.zeros((3, 1)))
            Ts_o.append(np.zeros((3, 1)))
            continue
        rels = []
        for v, (r0, t0) in poses[0].items():
            if v not in poses[c]:
                continue
            rc, tc = poses[c][v]
            R0 = np.asarray(Rodrigues(r0)[0])
            Rc = np.asarray(Rodrigues(rc)[0])
            Rrel = Rc @ R0.T
            trel = tc - Rrel @ t0
            rels.append((Rrel, trel))
        if rels:
            M = np.mean([r for r, _t in rels], axis=0)
            U, _s, Vt = np.linalg.svd(M)
            Ravg = U @ np.diag([1, 1, np.linalg.det(U @ Vt)]) @ Vt
            Rs_o.append(np.asarray(Rodrigues(Ravg)[0]).reshape(3, 1))
            Ts_o.append(np.mean([t for _r, t in rels],
                                axis=0).reshape(3, 1))
        else:
            Rs_o.append(np.zeros((3, 1)))
            Ts_o.append(np.zeros((3, 1)))
    return float(np.mean(total_rms)), Ks_o, ds_o, Rs_o, Ts_o


def calibrateMultiviewExtended(*args, **kwargs):
    return calibrateMultiview(*args, **kwargs)


def loadChromaticAberrationParams(node):
    """Reads the 4×N blue/red dx/dy polynomial coefficient matrix from
    an opened FileStorage node (our persistence module)."""
    coeff = np.asarray(node.getNode("coefficients").mat(), np.float32) \
        if hasattr(node, "getNode") else np.asarray(node, np.float32)
    size = (0, 0)
    degree = 3
    return coeff, size, degree


def correctChromaticAberration(input_image, coefficients, image_size,
                               calib_degree: int, bayer_pattern=None):
    """Polynomial lateral chromatic-aberration correction: warp the
    blue and red channels by the 2-D polynomial displacement field
    encoded in `coefficients` (rows: b_dx, b_dy, r_dx, r_dy)."""
    import torch
    from ..core.arrays import as_tensor
    from ..ops.warp import remap
    from .. import constants as K

    img = as_tensor(input_image)
    if img.ndim == 2:
        raise ValueError("Bayer input not supported; demosaic first")
    H, W = img.shape[:2]
    co = np.asarray(coefficients, np.float64).reshape(4, -1)
    deg = int(calib_degree)
    xs, ys = np.meshgrid(np.arange(W, dtype=np.float64),
                         np.arange(H, dtype=np.float64))
    # polynomial basis x^i y^j, i+j <= deg, in row-major (i, j) order
    basis = []
    for i in range(deg + 1):
        for j in range(deg + 1 - i):
            basis.append(xs ** i * ys ** j)
    basis = np.stack(basis)

    def disp(row):
        k = min(len(row), len(basis))
        return np.tensordot(row[:k], basis[:k], axes=1)

    out = img.clone()
    for (ch, rdx, rdy) in ((0, co[0], co[1]), (2, co[2], co[3])):
        mapx = torch.from_numpy((xs + disp(rdx)).astype(np.float32))
        mapy = torch.from_numpy((ys + disp(rdy)).astype(np.float32))
        out[..., ch] = remap(img[..., ch], mapx, mapy, K.INTER_LINEAR)
    return out


def findPlanes(points3d, normals=None, mask=None,
               plane_coefficients=None, block_size: int = 40,
               min_size: int = 200, threshold: float = 0.01,
               sensor_error_a: float = 0.0, sensor_error_b: float = 0.0,
               sensor_error_c: float = 0.0, method: int = 0):
    """Plane segmentation on an organized point map (3d module
    findPlanes): greedy region growing from block seeds with plane
    re-fit, labels in mask (255 = no plane)."""
    P = np.asarray(points3d, np.float64)[..., :3]
    H, W = P.shape[:2]
    label = np.full((H, W), 255, np.uint8)
    coeffs = []
    valid = np.isfinite(P).all(axis=-1)
    nplanes = 0
    for by in range(0, H - block_size + 1, block_size):
        for bx in range(0, W - block_size + 1, block_size):
            if nplanes >= 250:
                break
            blk = P[by:by + block_size, bx:bx + block_size]
            bv = valid[by:by + block_size, bx:bx + block_size] & \
                (label[by:by + block_size,
                       bx:bx + block_size] == 255)
            if bv.sum() < block_size * block_size // 2:
                continue
            pts = blk[bv]
            c = pts.mean(axis=0)
            _u, s, vt = np.linalg.svd(pts - c, full_matrices=False)
            if s[2] / max(s[0], 1e-12) > 0.05:
                continue
            n = vt[2]
            d = -n @ c
            dist = np.abs(P @ n + d)
            m = valid & (dist < threshold) & (label == 255)
            if m.sum() < min_size:
                continue
            label[m] = nplanes
            coeffs.append(np.array([n[0], n[1], n[2], d], np.float32))
            nplanes += 1
    return label, (np.stack(coeffs) if coeffs
                   else np.zeros((0, 4), np.float32))


def minEnclosingConvexPolygon(points, k: int):
    """Minimum-area enclosing convex k-gon.  Greedy optimal-ish edge
    relaxation: start from the convex hull and repeatedly remove the
    vertex whose neighbouring-edge extension adds the least area (the
    same contraction step as approxPolyN, which is optimal for convex
    position in the reference's sense).  Returns (area, polygon)."""
    from ..ops.contours import approxPolyN, contourArea
    pts = np.asarray(points, np.float32).reshape(-1, 1, 2)
    poly = approxPolyN(pts, int(k), -1.0, True)
    area = float(contourArea(poly.astype(np.float32)))
    return area, poly.astype(np.float32)
