"""calib3d tail APIs: composeRT, decomposeEssentialMat,
decomposeProjectionMatrix, calibrationMatrixValues, drawFrameAxes,
correctMatches, getDefaultNewCameraMatrix, filterSpeckles,
validateDisparity, getValidDisparityROI, reprojectImageTo3D,
stereoRectifyUncalibrated (calib3d/src/{calibration,fundam,
stereosgbm}.cpp), twin of ``opencv_tpu/calib3d/misc3d.py``.

The matrix functions are the JAX package's numpy.  ``filterSpeckles``
runs the native host tail (``native/hosttails.cpp::filter_speckles_i32``;
its Python loop stays as ``_filter_speckles_py``, the twin the tests hold it
to); a tensor is read back once and the result written back to its
device.  ``validateDisparity`` and ``reprojectImageTo3D`` are torch on the
disparity's device; the reprojection sums its four terms one op at a time
in float64 (no matrix product, whose order the card's and the CPU's
libraries choose), so the card and the CPU agree bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from .geometry import Rodrigues, projectPoints

__all__ = ["composeRT", "decomposeEssentialMat",
           "decomposeProjectionMatrix", "calibrationMatrixValues",
           "drawFrameAxes", "correctMatches",
           "getDefaultNewCameraMatrix", "filterSpeckles",
           "validateDisparity", "getValidDisparityROI",
           "reprojectImageTo3D", "stereoRectifyUncalibrated"]


def composeRT(rvec1, tvec1, rvec2, tvec2):
    """cv::composeRT: (R2·R1, R2·t1 + t2) back to rvec/tvec."""
    r1 = np.asarray(rvec1, np.float64).reshape(3)
    r2 = np.asarray(rvec2, np.float64).reshape(3)
    t1 = np.asarray(tvec1, np.float64).reshape(3, 1)
    t2 = np.asarray(tvec2, np.float64).reshape(3, 1)
    R1 = np.asarray(Rodrigues(r1)[0])
    R2 = np.asarray(Rodrigues(r2)[0])
    R3 = R2 @ R1
    t3 = R2 @ t1 + t2
    rvec3 = np.asarray(Rodrigues(R3)[0]).reshape(3, 1)
    return rvec3, t3


def decomposeEssentialMat(E):
    """cv::decomposeEssentialMat → (R1, R2, t)."""
    E = np.asarray(E, np.float64).reshape(3, 3)
    U, _s, Vt = np.linalg.svd(E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0, 1, 0], [-1, 0, 0], [0, 0, 1]], np.float64)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2].reshape(3, 1)
    return R1, R2, t


def decomposeProjectionMatrix(P):
    """cv::decomposeProjectionMatrix → (K, R, t4, rotX, rotY, rotZ,
    euler)."""
    P = np.asarray(P, np.float64).reshape(3, 4)
    M = P[:, :3]
    # RQ decomposition via flipped QR
    Pf = np.flipud(M).T
    Q, R = np.linalg.qr(Pf)
    Rm = np.flipud(R.T)
    Rm = np.fliplr(Rm)
    Qm = np.flipud(Q.T)
    # enforce positive diagonal of K
    S = np.diag(np.sign(np.diag(Rm)))
    K = Rm @ S
    Rrot = S @ Qm
    if np.linalg.det(Rrot) < 0:
        Rrot = -Rrot
    # camera center: P·C = 0 (homogeneous)
    _u, _s, vt = np.linalg.svd(P)
    C = vt[-1]
    t4 = C.reshape(4, 1)
    # euler angles (x, y, z) like the reference's RQDecomp3x3
    sy = np.hypot(Rrot[2, 1], Rrot[2, 2])
    ex = np.degrees(np.arctan2(Rrot[2, 1], Rrot[2, 2]))
    ey = np.degrees(np.arctan2(-Rrot[2, 0], sy))
    ez = np.degrees(np.arctan2(Rrot[1, 0], Rrot[0, 0]))
    euler = np.array([ex, ey, ez])
    K = K / K[2, 2]
    return K, Rrot, t4, None, None, None, euler


def calibrationMatrixValues(cameraMatrix, imageSize, apertureWidth,
                            apertureHeight):
    """cv::calibrationMatrixValues → (fovx, fovy, focalLength,
    principalPoint, aspectRatio)."""
    Kc = np.asarray(cameraMatrix, np.float64).reshape(3, 3)
    w, h = imageSize
    fx, fy = Kc[0, 0], Kc[1, 1]
    cx, cy = Kc[0, 2], Kc[1, 2]
    fovx = np.degrees(np.arctan2(cx, fx) + np.arctan2(w - cx, fx))
    fovy = np.degrees(np.arctan2(cy, fy) + np.arctan2(h - cy, fy))
    focal = 0.0
    pp = (0.0, 0.0)
    if apertureWidth > 0 and apertureHeight > 0:
        mx = w / apertureWidth
        my = h / apertureHeight
        focal = fx / mx
        pp = (cx / mx, cy / my)
    return float(fovx), float(fovy), float(focal), pp, float(fy / fx)


def drawFrameAxes(image, cameraMatrix, distCoeffs, rvec, tvec, length,
                  thickness: int = 3):
    """cv::drawFrameAxes: X red, Y green, Z blue."""
    from ..ops.drawing import line
    pts = np.float64([[0, 0, 0], [length, 0, 0], [0, length, 0],
                      [0, 0, length]])
    proj, _ = projectPoints(pts, rvec, tvec, cameraMatrix, distCoeffs)
    p = np.asarray(proj).reshape(-1, 2)
    o = tuple(np.round(p[0]).astype(int))
    cols = [(0, 0, 255), (0, 255, 0), (255, 0, 0)]
    for i, c in enumerate(cols):
        line(image, o, tuple(np.round(p[i + 1]).astype(int)), c,
             thickness)
    return image


def correctMatches(F, points1, points2):
    """cv::correctMatches — the Hartley–Sturm optimal triangulation
    correction (triangulate.cpp:371 cvCorrectMatches): per pair,
    translate both points to the origin, rotate both images so the
    epipoles sit on the x-axis, minimise the degree-6 polynomial cost
    over epipolar-line pencils, and map the closest line points back."""
    F0 = np.asarray(F, np.float64).reshape(3, 3)
    p1 = np.asarray(points1, np.float64).reshape(1, -1, 2).copy()
    p2 = np.asarray(points2, np.float64).reshape(1, -1, 2).copy()
    for p in range(p1.shape[1]):
        x1, y1 = p1[0, p]
        x2, y2 = p2[0, p]
        T1i = np.array([[1, 0, x1], [0, 1, y1], [0, 0, 1]], np.float64)
        T2i = np.array([[1, 0, x2], [0, 1, y2], [0, 0, 1]], np.float64)
        TFT = T2i.T @ F0 @ T1i

        def _epipole(M):
            # right null vector, normalised on its first two comps,
            # sign-fixed so the third is >= 0
            _, _, Vt = np.linalg.svd(M)
            e = Vt[2]
            e = e / np.hypot(e[0], e[1])
            return -e if e[2] < 0 else e

        e1 = _epipole(TFT)          # F e1 = 0
        e2 = _epipole(TFT.T)        # e2^T F = 0
        R1 = np.array([[e1[0], e1[1], 0], [-e1[1], e1[0], 0],
                       [0, 0, 1]], np.float64)
        R2 = np.array([[e2[0], e2[1], 0], [-e2[1], e2[0], 0],
                       [0, 0, 1]], np.float64)
        G = R2 @ TFT @ R1.T
        f1, f2 = e1[2], e2[2]
        a, b, c, d = G[1, 1], G[1, 2], G[2, 1], G[2, 2]

        # g(t) = t((at+b)^2 + f2^2 (ct+d)^2)^2
        #        - (ad-bc)(1+f1^2 t^2)^2 (at+b)(ct+d), degree 6
        k6 = b*c*c*f1**4*a - a*a*d*f1**4*c
        k5 = (f2**4*c**4 + 2*a*a*f2*f2*c*c - a*a*d*d*f1**4
              + b*b*c*c*f1**4 + a**4)
        k4 = (4*a**3*b + 2*b*c*c*f1*f1*a + 4*f2**4*c**3*d
              + 4*a*b*f2*f2*c*c + 4*a*a*f2*f2*c*d - 2*a*a*d*f1*f1*c
              - a*d*d*f1**4*b + b*b*c*f1**4*d)
        k3 = (6*a*a*b*b + 6*f2**4*c*c*d*d + 2*b*b*f2*f2*c*c
              + 2*a*a*f2*f2*d*d - 2*a*a*d*d*f1*f1 + 2*b*b*c*c*f1*f1
              + 8*a*b*f2*f2*c*d)
        k2 = (4*a*b**3 + 4*b*b*f2*f2*c*d + 4*f2**4*c*d**3 - a*a*d*c
              + b*c*c*a + 4*a*b*f2*f2*d*d - 2*a*d*d*f1*f1*b
              + 2*b*b*c*f1*f1*d)
        k1 = f2**4*d**4 + b**4 + 2*b*b*f2*f2*d*d - a*a*d*d + b*b*c*c
        k0 = -a*d*d*b + b*b*c*d
        roots = np.roots([k6, k5, k4, k3, k2, k1, k0])

        # cost at each real root vs the t=inf asymptote
        t_min = np.finfo(np.float64).max
        s_val = 1.0 / (f1*f1) + (c*c) / (a*a + f2*f2*c*c)
        for t in roots.real:
            s = (t*t) / (1 + f1*f1*t*t) + \
                ((c*t + d)**2) / ((a*t + b)**2 + f2*f2*(c*t + d)**2)
            if s < s_val:
                s_val, t_min = s, t
        t = t_min

        v1 = np.array([t*t*f1, t, t*t*f1*f1 + 1.0])
        v1 /= v1[2]
        q1 = T1i @ R1.T @ v1
        v2 = np.array([f2*(c*t + d)**2, -(a*t + b)*(c*t + d),
                       f2*f2*(c*t + d)**2 + (a*t + b)**2])
        v2 /= v2[2]
        q2 = T2i @ R2.T @ v2
        p1[0, p] = q1[:2]
        p2[0, p] = q2[:2]
    return p1, p2


def getDefaultNewCameraMatrix(cameraMatrix, imgsize=None,
                              centerPrincipalPoint: bool = False):
    Kc = np.asarray(cameraMatrix, np.float64).reshape(3, 3).copy()
    if centerPrincipalPoint and imgsize is not None:
        Kc[0, 2] = (imgsize[0] - 1) * 0.5
        Kc[1, 2] = (imgsize[1] - 1) * 0.5
    return Kc


def _filter_speckles_py(img, newVal, maxSpeckleSize: int, maxDiff):
    """The JAX package's filterSpeckles loop on a host array, kept as the
    twin of the native :func:`filterSpeckles`."""
    a = np.array(img, copy=True)
    H, W = a.shape[:2]
    labels = np.zeros((H, W), np.int32)
    md = int(maxDiff)
    nv = newVal
    cur = 0
    for y0 in range(H):
        for x0 in range(W):
            if a[y0, x0] == nv or labels[y0, x0]:
                continue
            cur += 1
            stack = [(y0, x0)]
            labels[y0, x0] = cur
            comp = []
            while stack:
                y, x = stack.pop()
                comp.append((y, x))
                v = int(a[y, x])
                for (yy, xx) in ((y + 1, x), (y - 1, x), (y, x + 1),
                                 (y, x - 1)):
                    if 0 <= yy < H and 0 <= xx < W \
                            and not labels[yy, xx] \
                            and a[yy, xx] != nv \
                            and abs(int(a[yy, xx]) - v) <= md:
                        labels[yy, xx] = cur
                        stack.append((yy, xx))
            if len(comp) <= maxSpeckleSize:
                for (y, x) in comp:
                    a[y, x] = nv
    return a


def filterSpeckles(img, newVal, maxSpeckleSize: int, maxDiff):
    """cv::filterSpeckles (stereosgbm.cpp filterSpecklesImpl:2343):
    4-connected blobs of chained-similar disparity with count <=
    maxSpeckleSize are set to newVal.  Pixels already equal to newVal
    are barriers — never labeled, never counted.

    Integer images (u8, i16, i32) only, as the native flood takes them; a
    tensor comes back as a tensor on its device, an array as an array."""
    if isinstance(img, torch.Tensor):
        out = native.filter_speckles(img.detach().cpu().numpy(), newVal, maxSpeckleSize,
                                     maxDiff)
        return torch.from_numpy(out).to(img.device)
    return native.filter_speckles(np.asarray(img), newVal, maxSpeckleSize, maxDiff)


def validateDisparity(disparity, cost, minDisparity: int,
                      numberOfDisparities: int, disp12MaxDisp: int = 1):
    """Range validation (the full left-right check needs both costs;
    out-of-range disparities are invalidated like the reference), on the
    disparity's device; an array comes back as an array."""
    if not isinstance(disparity, torch.Tensor):
        return validateDisparity(torch.from_numpy(np.array(disparity)), cost, minDisparity,
                                 numberOfDisparities, disp12MaxDisp).numpy()
    lo = minDisparity * 16
    hi = (minDisparity + numberOfDisparities) * 16
    bad = (disparity < lo) | (disparity >= hi)
    return torch.where(bad, torch.full_like(disparity, (minDisparity - 1) * 16), disparity)


def getValidDisparityROI(roi1, roi2, minDisparity: int,
                         numberOfDisparities: int, blockSize: int):
    """cv::getValidDisparityROI (stereo correspondence valid region)."""
    x1, y1, w1, h1 = roi1
    x2, y2, w2, h2 = roi2
    border = blockSize // 2
    maxD = minDisparity + numberOfDisparities - 1
    xmin = max(x1, x2 + maxD) + border
    xmax = min(x1 + w1, x2 + w2) - border
    ymin = max(y1, y2) + border
    ymax = min(y1 + h1, y2 + h2) - border
    r = (xmin, ymin, xmax - xmin, ymax - ymin)
    return r if (r[2] > 0 and r[3] > 0) else (0, 0, 0, 0)


def reprojectImageTo3D(disparity, Q, handleMissingValues: bool = False,
                       ddepth: int = -1):
    """cv::reprojectImageTo3D: per-pixel Q·[x y d 1]ᵀ, (H, W, 3) float32 on
    the disparity's device (an array comes back as an array).

    As in the JAX package, the disparity is taken as it is, whatever its
    type (its int16 branch compares the float64 copy's type, so it never
    divides by 16): pass a float disparity over 16, as OpenCV's
    stereo_match sample does."""
    if not isinstance(disparity, torch.Tensor):
        return reprojectImageTo3D(torch.from_numpy(np.array(disparity)), Q,
                                  handleMissingValues, ddepth).numpy()
    d = disparity.to(torch.float64)
    Qm = [[float(v) for v in row] for row in np.asarray(Q, np.float64).reshape(4, 4)]
    H, W = d.shape
    xs = torch.arange(W, dtype=torch.float64, device=d.device)[None, :]
    ys = torch.arange(H, dtype=torch.float64, device=d.device)[:, None]
    # the four terms in the matrix product's order, one op at a time
    out = [((xs * q[0] + ys * q[1]) + d * q[2]) + q[3] for q in Qm]
    w = torch.where(out[3] == 0, torch.full_like(out[3], 1e-12), out[3])
    xyz = torch.stack([out[i] / w for i in range(3)], dim=-1)
    if handleMissingValues:
        missing = disparity == disparity.min()
        xyz = torch.where(missing[..., None], torch.full_like(xyz, 10000.0), xyz)
    return xyz.to(torch.float32)


def stereoRectifyUncalibrated(points1, points2, F, imgSize,
                              threshold: float = 5.0):
    """cv::stereoRectifyUncalibrated (Hartley): epipole-to-infinity
    homographies H1, H2."""
    F = np.asarray(F, np.float64).reshape(3, 3)
    w, h = imgSize
    p1 = np.asarray(points1, np.float64).reshape(-1, 2)
    p2 = np.asarray(points2, np.float64).reshape(-1, 2)
    # epipole in image 2: F^T e2 = 0
    _u, _s, vt = np.linalg.svd(F.T)
    e2 = vt[-1]
    e2 = e2 / (e2[2] if abs(e2[2]) > 1e-12 else 1.0)
    cx, cy = (w - 1) * 0.5, (h - 1) * 0.5
    T = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], np.float64)
    e = T @ e2
    d = np.hypot(e[0], e[1])
    a, b = (e[0] / d, e[1] / d) if d else (1.0, 0.0)
    R = np.array([[a, b, 0], [-b, a, 0], [0, 0, 1]], np.float64)
    ex = float(R @ e @ np.array([1, 0, 0]))
    ex = (R @ e)[0]
    G = np.eye(3)
    if abs(ex) > 1e-9:
        G[2, 0] = -1.0 / ex
    H2 = np.linalg.inv(T) @ G @ R @ T
    # H1: match via least squares H1 = Ha·H2·M with M = [e]x F + e·vᵀ
    e2f = np.asarray([e2[0], e2[1], e2[2]])
    ex_m = np.array([[0, -e2f[2], e2f[1]], [e2f[2], 0, -e2f[0]],
                     [-e2f[1], e2f[0], 0]])
    M = ex_m @ F + np.outer(e2f, np.ones(3))
    H0 = H2 @ M
    # affine correction minimizing disparity
    x1 = np.concatenate([p1, np.ones((len(p1), 1))], 1) @ H0.T
    x2 = np.concatenate([p2, np.ones((len(p2), 1))], 1) @ H2.T
    x1 = x1 / x1[:, 2:3]
    x2 = x2 / x2[:, 2:3]
    A = np.stack([x1[:, 0], x1[:, 1], np.ones(len(x1))], 1)
    coef, *_ = np.linalg.lstsq(A, x2[:, 0], rcond=None)
    Ha = np.array([[coef[0], coef[1], coef[2]], [0, 1, 0], [0, 0, 1]])
    H1 = Ha @ H0
    return True, H1 / H1[2, 2], H2 / H2[2, 2]


def matMulDeriv(A, B):
    """cv::matMulDeriv (calibration_base.cpp:62): jacobians of C = A·B
    w.r.t. A and B.  d(AB)/dA = I_M ⊗ Bᵀ, d(AB)/dB = A ⊗ I_N (row index
    ordered (i1·N + i2) like the reference's flat loop)."""
    Am = np.asarray(A, np.float64)
    Bm = np.asarray(B, np.float64)
    M, L = Am.shape
    N = Bm.shape[1]
    dABdA = np.kron(np.eye(M), Bm.T)
    dABdB = np.kron(Am, np.eye(N))
    dt = np.asarray(A).dtype
    if dt == np.float32:
        return dABdA.astype(np.float32), dABdB.astype(np.float32)
    return dABdA, dABdB


def RQDecomp3x3(src, mtxR=None, mtxQ=None, Qx=None, Qy=None, Qz=None):
    """cv::RQDecomp3x3 (calibration_base.cpp:1034): RQ decomposition by
    three Givens rotations with the reference's sign disambiguation
    (diagonal of R positive except possibly the last entry).  Returns
    (eulerAngles_deg, R, Q, Qx, Qy, Qz)."""
    M = np.asarray(src, np.float64).reshape(3, 3).copy()
    eps = np.finfo(np.float64).eps

    def _givens(s_raw, c_raw):
        z = 1.0 / np.sqrt(c_raw * c_raw + s_raw * s_raw)
        return c_raw * z, s_raw * z

    s, c = (M[2, 1], M[2, 2]) if abs(M[2, 1]) > eps else (0.0, 1.0)
    c, s = _givens(s, c)
    Qx_ = np.array([[1, 0, 0], [0, c, s], [0, -s, c]], np.float64)
    R = M @ Qx_
    R[2, 1] = 0.0

    s, c = (-R[2, 0], R[2, 2]) if abs(R[2, 0]) > eps else (0.0, 1.0)
    c, s = _givens(s, c)
    Qy_ = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float64)
    M2 = R @ Qy_
    M2[2, 0] = 0.0

    s, c = (M2[1, 0], M2[1, 1]) if abs(M2[1, 0]) > eps else (0.0, 1.0)
    c, s = _givens(s, c)
    Qz_ = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], np.float64)
    R = M2 @ Qz_
    R[1, 0] = 0.0

    # sign disambiguation: R's leading diagonal entries non-negative
    if R[0, 0] < 0:
        if R[1, 1] < 0:
            R[0, 0] *= -1; R[0, 1] *= -1; R[1, 1] *= -1
            Qz_[0, 0] *= -1; Qz_[0, 1] *= -1
            Qz_[1, 0] *= -1; Qz_[1, 1] *= -1
        else:
            R[0, 0] *= -1; R[0, 2] *= -1; R[1, 2] *= -1; R[2, 2] *= -1
            Qz_ = Qz_.T.copy()
            Qy_[0, 0] *= -1; Qy_[0, 2] *= -1
            Qy_[2, 0] *= -1; Qy_[2, 2] *= -1
    elif R[1, 1] < 0:
        R[0, 1] *= -1; R[0, 2] *= -1; R[1, 1] *= -1
        R[1, 2] *= -1; R[2, 2] *= -1
        Qz_ = Qz_.T.copy()
        Qy_ = Qy_.T.copy()
        Qx_[1, 1] *= -1; Qx_[1, 2] *= -1
        Qx_[2, 1] *= -1; Qx_[2, 2] *= -1

    deg = 180.0 / np.pi
    euler = np.array([
        np.arccos(np.clip(Qx_[1, 1], -1, 1)) * (1 if Qx_[1, 2] >= 0 else -1),
        np.arccos(np.clip(Qy_[0, 0], -1, 1)) * (1 if Qy_[2, 0] >= 0 else -1),
        np.arccos(np.clip(Qz_[0, 0], -1, 1)) * (1 if Qz_[0, 1] >= 0 else -1),
    ]) * deg
    Q = Qz_.T @ Qy_.T @ Qx_.T
    return euler, R, Q, Qx_, Qy_, Qz_
