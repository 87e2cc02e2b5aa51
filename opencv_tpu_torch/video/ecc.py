"""ECC image alignment (video/src/ecc.cpp, Evangelidis & Psarakis 2008);
the port's copy of ``opencv_tpu/video/ecc.py``.

findTransformECC's per-iteration work (inverse-warp gathers, gradient
projections onto the motion Jacobian, a small linear solve) is host numpy
in f64, as in the JAX package, with the reference's update equations
(lambda illumination compensation, ecc.cpp:220-241).  The smoothing is the
port's f32 ``GaussianBlur`` and the multi-scale pyramid the port's
``pyrDown``, each read back to the host; the images may be tensors.
"""

from __future__ import annotations

import numpy as np

from ..core.arrays import to_host
from ..ops.filter import GaussianBlur
from ..ops.pyramids import pyrDown

__all__ = ["findTransformECC", "computeECC", "findTransformECCWithMask",
           "findTransformECCMultiScale", "MOTION_TRANSLATION",
           "MOTION_EUCLIDEAN", "MOTION_AFFINE", "MOTION_HOMOGRAPHY"]

MOTION_TRANSLATION = 0
MOTION_EUCLIDEAN = 1
MOTION_AFFINE = 2
MOTION_HOMOGRAPHY = 3

_NPARAMS = {MOTION_TRANSLATION: 2, MOTION_EUCLIDEAN: 3,
            MOTION_AFFINE: 6, MOTION_HOMOGRAPHY: 8}


def _gauss(img, ksize):
    if ksize <= 1:
        return img.astype(np.float32)
    return to_host(GaussianBlur(img.astype(np.float32), (ksize, ksize), 0))


def _inv_warp(img, M, hs, ws, homography, nearest=False, fill=0.0):
    """dst(x,y) = img(M [x y 1]^T) — WARP_INVERSE_MAP sampling."""
    ys, xs = np.mgrid[0:hs, 0:ws].astype(np.float64)
    if homography:
        den = M[2, 0] * xs + M[2, 1] * ys + M[2, 2]
        u = (M[0, 0] * xs + M[0, 1] * ys + M[0, 2]) / den
        v = (M[1, 0] * xs + M[1, 1] * ys + M[1, 2]) / den
    else:
        u = M[0, 0] * xs + M[0, 1] * ys + M[0, 2]
        v = M[1, 0] * xs + M[1, 1] * ys + M[1, 2]
    H, W = img.shape
    if nearest:
        ui = np.rint(u).astype(np.int64)
        vi = np.rint(v).astype(np.int64)
        inside = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
        out = np.where(inside,
                       img[np.clip(vi, 0, H - 1), np.clip(ui, 0, W - 1)],
                       fill)
        return out
    u0 = np.floor(u).astype(np.int64)
    v0 = np.floor(v).astype(np.int64)
    fu = u - u0
    fv = v - v0
    inside = (u0 >= 0) & (u0 < W - 1) & (v0 >= 0) & (v0 < H - 1)
    u0c = np.clip(u0, 0, W - 2)
    v0c = np.clip(v0, 0, H - 2)
    p00 = img[v0c, u0c]
    p01 = img[v0c, u0c + 1]
    p10 = img[v0c + 1, u0c]
    p11 = img[v0c + 1, u0c + 1]
    val = (p00 * (1 - fu) + p01 * fu) * (1 - fv) \
        + (p10 * (1 - fu) + p11 * fu) * fv
    return np.where(inside, val, fill).astype(np.float32)


def _jacobian(gx, gy, Xg, Yg, M, motion):
    w = gx.shape[1]
    if motion == MOTION_TRANSLATION:
        return np.concatenate([gx, gy], axis=1)
    if motion == MOTION_AFFINE:
        return np.concatenate([gx * Xg, gy * Xg, gx * Yg, gy * Yg,
                               gx, gy], axis=1)
    if motion == MOTION_EUCLIDEAN:
        h0, h1 = M[0, 0], M[1, 0]
        hatX = -(Xg * h1) - (Yg * h0)
        hatY = (Xg * h0) - (Yg * h1)
        return np.concatenate([gx * hatX + gy * hatY, gx, gy], axis=1)
    # homography (ecc.cpp image_jacobian_homo_ECC:51)
    h0_, h1_, h2_ = M[0, 0], M[1, 0], M[2, 0]
    h3_, h4_, h5_ = M[0, 1], M[1, 1], M[2, 1]
    h6_, h7_ = M[0, 2], M[1, 2]
    den = Xg * h2_ + Yg * h5_ + 1.0
    hatX = (-Xg * h0_ - Yg * h3_ - h6_) / den
    hatY = (-Xg * h1_ - Yg * h4_ - h7_) / den
    g1 = gx / den
    g2 = gy / den
    temp = hatX * g1 + hatY * g2
    return np.concatenate([g1 * Xg, g2 * Xg, temp * Xg,
                           g1 * Yg, g2 * Yg, temp * Yg, g1, g2], axis=1)


def _project(jac, img2, nparams):
    """project_onto_jacobian_ECC: dst[i] = sum(jac_block_i * img2)."""
    w = jac.shape[1] // nparams
    if img2.shape[1] == w:
        return np.array([np.sum(jac[:, i * w:(i + 1) * w] * img2)
                         for i in range(nparams)])
    # jacobian^T jacobian (hessian)
    H = np.empty((nparams, nparams))
    for i in range(nparams):
        bi = jac[:, i * w:(i + 1) * w]
        for j in range(i, nparams):
            H[i, j] = H[j, i] = np.sum(bi * jac[:, j * w:(j + 1) * w])
    return H


def _update_map(M, dp, motion):
    if motion == MOTION_TRANSLATION:
        M[0, 2] += dp[0]
        M[1, 2] += dp[1]
    elif motion == MOTION_AFFINE:
        M[0, 0] += dp[0]
        M[1, 0] += dp[1]
        M[0, 1] += dp[2]
        M[1, 1] += dp[3]
        M[0, 2] += dp[4]
        M[1, 2] += dp[5]
    elif motion == MOTION_HOMOGRAPHY:
        M[0, 0] += dp[0]
        M[1, 0] += dp[1]
        M[2, 0] += dp[2]
        M[0, 1] += dp[3]
        M[1, 1] += dp[4]
        M[2, 1] += dp[5]
        M[0, 2] += dp[6]
        M[1, 2] += dp[7]
    else:  # EUCLIDEAN
        theta = dp[0] + np.arcsin(np.clip(M[1, 0], -1, 1))
        M[0, 2] += dp[1]
        M[1, 2] += dp[2]
        M[0, 0] = M[1, 1] = np.cos(theta)
        M[1, 0] = np.sin(theta)
        M[0, 1] = -M[1, 0]
    return M


def findTransformECC(templateImage, inputImage, warpMatrix=None,
                     motionType=MOTION_AFFINE,
                     criteria=(3, 50, 0.001), inputMask=None,
                     gaussFiltSize=5):
    """cv2.findTransformECC (ecc.cpp:360): returns (rho, warpMatrix)."""
    tmpl = to_host(templateImage)
    img = to_host(inputImage)
    if tmpl.ndim == 3:
        tmpl = tmpl[..., 0]
    if img.ndim == 3:
        img = img[..., 0]
    hs, ws = tmpl.shape
    nparams = _NPARAMS[motionType]
    homo = motionType == MOTION_HOMOGRAPHY

    if warpMatrix is None or np.asarray(warpMatrix).size == 0:
        M = np.eye(3 if homo else 2, 3, dtype=np.float64)
    else:
        M = np.asarray(warpMatrix, np.float64).copy()
        if homo and M.shape[0] == 2:
            M = np.vstack([M, [0, 0, 1]])
    M = M.astype(np.float64)

    niter = int(criteria[1]) if len(criteria) > 1 else 50
    eps = float(criteria[2]) if len(criteria) > 2 else 1e-3

    tF = _gauss(tmpl, gaussFiltSize).astype(np.float64)
    iF = _gauss(img, gaussFiltSize).astype(np.float64)
    if inputMask is not None and to_host(inputMask).size:
        pre = (to_host(inputMask) > 0).astype(np.uint8)
        preF = _gauss(pre.astype(np.float32), gaussFiltSize).astype(
            np.float64) * (0.5 / 0.95)
        pre = np.rint(preF).astype(np.uint8)
        preF = pre.astype(np.float64)
    else:
        pre = np.ones(img.shape, np.uint8)
        preF = pre.astype(np.float64)

    gx = np.zeros_like(iF)
    gy = np.zeros_like(iF)
    gx[:, 1:-1] = (iF[:, 2:] - iF[:, :-2]) * 0.5
    gy[1:-1] = (iF[2:] - iF[:-2]) * 0.5
    # filter2D default border reflects; edges
    gx[:, 0] = (iF[:, 1] - iF[:, 1]) * 0.5
    gx[:, -1] = 0.0
    gy[0] = 0.0
    gy[-1] = 0.0
    gx *= preF
    gy *= preF

    Xg, Yg = np.meshgrid(np.arange(ws, dtype=np.float64),
                         np.arange(hs, dtype=np.float64))

    rho = -1.0
    last_rho = -eps
    for _ in range(niter):
        if abs(rho - last_rho) < eps:
            break
        iw = _inv_warp(iF, M, hs, ws, homo)
        gxw = _inv_warp(gx, M, hs, ws, homo)
        gyw = _inv_warp(gy, M, hs, ws, homo)
        maskw = _inv_warp(pre.astype(np.float64), M, hs, ws, homo,
                          nearest=True) > 0

        n = maskw.sum()
        img_mean = iw[maskw].mean()
        img_std = iw[maskw].std()
        tmp_mean = tF[maskw].mean()
        tmp_std = tF[maskw].std()
        iz = np.where(maskw, iw - img_mean, 0.0)
        tz = np.where(maskw, tF - tmp_mean, 0.0)
        tmp_norm = np.sqrt(n * tmp_std ** 2)
        img_norm = np.sqrt(n * img_std ** 2)

        jac = _jacobian(gxw.astype(np.float64), gyw.astype(np.float64),
                        Xg, Yg, M, motionType)
        hess = _project(jac, jac, nparams)
        hess_inv = np.linalg.inv(hess)

        correlation = float(np.sum(tz * iz))
        last_rho = rho
        rho = correlation / (img_norm * tmp_norm)
        if np.isnan(rho):
            raise RuntimeError("NaN encountered in ECC")

        ip = _project(jac, iz, nparams)
        tp = _project(jac, tz, nparams)
        iph = hess_inv @ ip
        lam_n = img_norm ** 2 - ip @ iph
        lam_d = correlation - tp @ iph
        if lam_d <= 0:
            raise RuntimeError(
                "ECC: correlation would decrease; images may be "
                "uncorrelated or non-overlapping")
        lam = lam_n / lam_d
        error = lam * tz - iz
        ep = _project(jac, error, nparams)
        dp = hess_inv @ ep
        M = _update_map(M, dp, motionType)

    out = M.astype(np.float32)
    return float(rho), out


def computeECC(templateImage, inputImage, inputMask=None):
    tmpl = to_host(templateImage).astype(np.float64)
    img = to_host(inputImage).astype(np.float64)
    if tmpl.ndim == 3:
        tmpl = tmpl[..., 0]
    if img.ndim == 3:
        img = img[..., 0]
    if inputMask is not None and to_host(inputMask).size:
        m = to_host(inputMask) > 0
    else:
        m = np.ones(tmpl.shape, bool)
    tz = tmpl[m] - tmpl[m].mean()
    iz = img[m] - img[m].mean()
    return float(np.sum(tz * iz)
                 / (np.linalg.norm(tz) * np.linalg.norm(iz)))


def findTransformECCWithMask(templateImage, inputImage, templateMask,
                             inputMask, warpMatrix=None,
                             motionType=MOTION_AFFINE,
                             criteria=(3, 50, 0.001),
                             gaussFiltSize: int = 5):
    """cv::findTransformECCWithMask — masked ECC (the base solver
    already supports inputMask; the template mask zeroes template
    contributions by intersecting into the input mask domain)."""
    mask = inputMask
    if templateMask is not None:
        tm = to_host(templateMask)
        mask = tm if mask is None else (
            ((to_host(mask) != 0) & (tm != 0)).astype(np.uint8) * 255)
    return findTransformECC(templateImage, inputImage, warpMatrix,
                            motionType, criteria, mask, gaussFiltSize)


def findTransformECCMultiScale(reference, sample, warpMatrix=None,
                               eccParams=None, referenceMask=None,
                               sampleMask=None):
    """cv::findTransformECCMultiScale — coarse-to-fine ECC over an
    image pyramid, scaling the translation part between levels."""
    motion = MOTION_AFFINE
    criteria = (3, 50, 0.001)
    nlevels = 3
    if eccParams is not None:
        p = list(np.asarray(eccParams).ravel())
        if len(p) >= 1:
            motion = int(p[0])
        if len(p) >= 2:
            nlevels = max(1, int(p[1]))
    ref = to_host(reference)
    smp = to_host(sample)
    pyr_r, pyr_s = [ref], [smp]
    for _ in range(nlevels - 1):
        if min(pyr_r[-1].shape[:2]) < 32:
            break
        pyr_r.append(to_host(pyrDown(pyr_r[-1])))
        pyr_s.append(to_host(pyrDown(pyr_s[-1])))
    if warpMatrix is None:
        rows = 3 if motion == MOTION_HOMOGRAPHY else 2
        warpMatrix = np.eye(3, dtype=np.float32)[:rows]
    W = np.asarray(warpMatrix, np.float32).copy()
    scale = 1.0 / (1 << (len(pyr_r) - 1))
    W[:2, 2] *= scale
    rho = -1.0
    for lvl in range(len(pyr_r) - 1, -1, -1):
        rho, W = findTransformECC(pyr_r[lvl], pyr_s[lvl], W, motion,
                                  criteria, None, 5)
        if lvl > 0:
            W = np.asarray(W, np.float32).copy()
            W[:2, 2] *= 2.0
    return rho, W
