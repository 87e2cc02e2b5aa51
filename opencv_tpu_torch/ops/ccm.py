"""Color correction model (the reference's cv::ccm module): fit a 3x3
(or 4x3 affine) matrix mapping linearized device RGB onto a reference
ColorChecker, minimizing CIEDE2000 in Lab D50; twin of
``opencv_tpu/ops/ccm.py``.

The fit (``compute``: 24 patches, numeric gradient steps) is the JAX
package's host numpy, copied, so the matrix and loss are its own bit for
bit.  ``correctImage`` runs on the image's device in f64, in the JAX
package's order: on u8 input the linearisation ``sign(x)·|x|^γ`` of x/255
has 256 values, gathered from a table numpy computes (so it is exact); then
the 3×3 (or 4×3) product, the clip, ``^(1/γ)`` and numpy's half-to-even
round.  ``^(1/γ)`` is a transcendental whose last bit the card need not
share with the CPU, so a u8 value on a .5 boundary may move by one there.

Reference patch values: the public X-Rite ColorChecker 2005 Lab(D50/2)
table (the same normative constants the reference embeds)."""

from __future__ import annotations

import numpy as np
import torch

from ..core.arrays import as_tensor, to_device
from .linalg import _host

__all__ = ["ColorCorrectionModel", "COLORCHECKER_MACBETH",
           "COLORCHECKER_VINYL", "COLORCHECKER_DIGITAL_SG",
           "CCM_LINEAR", "CCM_AFFINE", "ccm"]

COLORCHECKER_MACBETH = 0
COLORCHECKER_VINYL = 1
COLORCHECKER_DIGITAL_SG = 2
CCM_LINEAR = 0
CCM_AFFINE = 1

# X-Rite ColorChecker Classic (2005) Lab, D50/2deg
_MACBETH_LAB = np.array([
    [37.986, 13.555, 14.059], [65.711, 18.13, 17.81],
    [49.927, -4.88, -21.925], [43.139, -13.095, 21.905],
    [55.112, 8.844, -25.399], [70.719, -33.397, -0.199],
    [62.661, 36.067, 57.096], [40.02, 10.41, -45.964],
    [51.124, 48.239, 16.248], [30.325, 22.976, -21.587],
    [72.532, -23.709, 57.255], [71.941, 19.363, 67.857],
    [28.778, 14.179, -50.297], [55.261, -38.342, 31.37],
    [42.101, 53.378, 28.19], [81.733, 4.039, 79.819],
    [51.935, 49.986, -14.574], [51.038, -28.631, -28.638],
    [96.539, -0.425, 1.186], [81.257, -0.638, -0.335],
    [66.766, -0.734, -0.504], [50.867, -0.153, -0.27],
    [35.656, -0.421, -1.231], [20.461, -0.079, -0.973]])

_D50 = np.array([0.9642, 1.0, 0.8249])
# linear sRGB (D65) <-> XYZ, plus Bradford D50<->D65 adaptation
_RGB2XYZ_D65 = np.array([[0.4124564, 0.3575761, 0.1804375],
                         [0.2126729, 0.7151522, 0.0721750],
                         [0.0193339, 0.1191920, 0.9503041]])
_BRADFORD = np.array([[0.8951, 0.2664, -0.1614],
                      [-0.7502, 1.7135, 0.0367],
                      [0.0389, -0.0685, 1.0296]])


def _adapt(xyz, src_white, dst_white):
    cs = _BRADFORD @ src_white
    cd = _BRADFORD @ dst_white
    M = np.linalg.inv(_BRADFORD) @ np.diag(cd / cs) @ _BRADFORD
    return xyz @ M.T


def _lab_to_xyz(lab, white):
    L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0

    def f_inv(t):
        t3 = t ** 3
        return np.where(t3 > 0.008856, t3, (t - 16.0 / 116.0) / 7.787)

    return np.stack([f_inv(fx) * white[0], f_inv(fy) * white[1],
                     f_inv(fz) * white[2]], -1)


def _xyz_to_lab(xyz, white):
    r = xyz / white

    def f(t):
        return np.where(t > 0.008856, np.cbrt(t),
                        7.787 * t + 16.0 / 116.0)

    fx, fy, fz = f(r[..., 0]), f(r[..., 1]), f(r[..., 2])
    return np.stack([116.0 * fy - 16.0, 500.0 * (fx - fy),
                     200.0 * (fy - fz)], -1)


def _linear_rgb_to_lab_d50(rgb):
    xyz = rgb @ _RGB2XYZ_D65.T
    d65 = _RGB2XYZ_D65.sum(axis=1)
    xyz = _adapt(xyz, d65, _D50)
    return _xyz_to_lab(xyz, _D50)


def _lab_d50_to_linear_rgb(lab):
    xyz = _lab_to_xyz(lab, _D50)
    d65 = _RGB2XYZ_D65.sum(axis=1)
    xyz = _adapt(xyz, _D50, d65)
    return xyz @ np.linalg.inv(_RGB2XYZ_D65).T


def _delta_e2000(lab1, lab2):
    L1, a1, b1 = lab1[..., 0], lab1[..., 1], lab1[..., 2]
    L2, a2, b2 = lab2[..., 0], lab2[..., 1], lab2[..., 2]
    C1 = np.hypot(a1, b1)
    C2 = np.hypot(a2, b2)
    Cm = (C1 + C2) / 2
    G = 0.5 * (1 - np.sqrt(Cm ** 7 / (Cm ** 7 + 25.0 ** 7)))
    a1p, a2p = (1 + G) * a1, (1 + G) * a2
    C1p, C2p = np.hypot(a1p, b1), np.hypot(a2p, b2)
    h1p = np.degrees(np.arctan2(b1, a1p)) % 360
    h2p = np.degrees(np.arctan2(b2, a2p)) % 360
    dL = L2 - L1
    dC = C2p - C1p
    dh = h2p - h1p
    dh = np.where(dh > 180, dh - 360, np.where(dh < -180, dh + 360, dh))
    dH = 2 * np.sqrt(C1p * C2p) * np.sin(np.radians(dh) / 2)
    Lm = (L1 + L2) / 2
    Cmp = (C1p + C2p) / 2
    hsum = h1p + h2p
    hm = np.where(np.abs(h1p - h2p) > 180, (hsum + 360) / 2, hsum / 2)
    T = (1 - 0.17 * np.cos(np.radians(hm - 30))
         + 0.24 * np.cos(np.radians(2 * hm))
         + 0.32 * np.cos(np.radians(3 * hm + 6))
         - 0.20 * np.cos(np.radians(4 * hm - 63)))
    SL = 1 + 0.015 * (Lm - 50) ** 2 / np.sqrt(20 + (Lm - 50) ** 2)
    SC = 1 + 0.045 * Cmp
    SH = 1 + 0.015 * Cmp * T
    RT = (-2 * np.sqrt(Cmp ** 7 / (Cmp ** 7 + 25.0 ** 7))
          * np.sin(np.radians(60 * np.exp(-(((hm - 275) / 25) ** 2)))))
    return np.sqrt((dL / SL) ** 2 + (dC / SC) ** 2 + (dH / SH) ** 2
                   + RT * (dC / SC) * (dH / SH))


class ColorCorrectionModel:
    """cv::ccm::ColorCorrectionModel — src is an (N, 1, 3) float
    detected-patch RGB array in [0, 1]."""

    def __init__(self, src, constcolor=COLORCHECKER_MACBETH):
        self._src = _host(src).astype(np.float64).reshape(-1, 3)
        self._ref_lab = _MACBETH_LAB[:len(self._src)].copy()
        self._gamma = 2.2
        self._degree = 3
        self._ccm_type = CCM_LINEAR
        self._ccm = None
        self._loss = None
        self._weights = None
        self._mask = np.ones(len(self._src), bool)

    # -- knobs (subset honored; parity-relevant ones implemented) -----
    def setColorSpace(self, cs):
        return self

    def setCcmType(self, t):
        self._ccm_type = int(t)
        return self

    def setDistance(self, d):
        return self

    def setLinearization(self, lin):
        return self

    def setLinearizationGamma(self, g):
        self._gamma = float(g)
        return self

    def setLinearizationDegree(self, d):
        self._degree = int(d)
        return self

    def setSaturatedThreshold(self, lo, hi):
        sat = ((self._src < lo) | (self._src > hi)).any(axis=1)
        self._mask = ~sat
        return self

    def setWeightsList(self, w):
        self._weights = _host(w).astype(np.float64).ravel()
        return self

    def setWeightCoeff(self, c):
        return self

    def setInitialMethod(self, m):
        return self

    def setMaxCount(self, n):
        return self

    def setEpsilon(self, e):
        return self

    def setRGB(self, flag):
        return self

    # -- fitting ------------------------------------------------------
    def _linearize(self, rgb):
        return np.sign(rgb) * np.abs(rgb) ** self._gamma

    def compute(self):
        src_lin = self._linearize(self._src)
        ref_lin = _lab_d50_to_linear_rgb(self._ref_lab)
        m = self._mask
        A = src_lin[m]
        if self._ccm_type == CCM_AFFINE:
            A = np.hstack([A, np.ones((len(A), 1))])
        # least-squares init in linear RGB
        M0, *_ = np.linalg.lstsq(A, ref_lin[m], rcond=None)

        w = (self._weights[m] if self._weights is not None
             else np.ones(m.sum()))
        w = w / w.sum()

        def loss(Mflat):
            M = Mflat.reshape(A.shape[1], 3)
            pred = A @ M
            lab = _linear_rgb_to_lab_d50(np.clip(pred, 0, None))
            de = _delta_e2000(lab, self._ref_lab[m])
            return float((w * de ** 2).sum())

        # Nelder-free Gauss-Newton by numeric gradient descent with
        # backtracking (the reference runs LM on the same objective)
        x = M0.ravel().copy()
        f0 = loss(x)
        step = 1e-2
        for _ in range(200):
            g = np.zeros_like(x)
            for k in range(len(x)):
                d = np.zeros_like(x)
                d[k] = 1e-6
                g[k] = (loss(x + d) - f0) / 1e-6
            gn = np.linalg.norm(g)
            if gn < 1e-10:
                break
            moved = False
            s = step
            for _bt in range(20):
                x2 = x - s * g / gn
                f2 = loss(x2)
                if f2 < f0:
                    x, f0 = x2, f2
                    step = s * 1.5
                    moved = True
                    break
                s *= 0.5
            if not moved:
                break
        self._ccm = x.reshape(A.shape[1], 3)
        self._loss = float(np.sqrt(f0))
        return self

    run = compute

    def getColorCorrectionMatrix(self):
        if self._ccm is None:
            self.compute()
        return self._ccm.copy()

    getCCM = getColorCorrectionMatrix

    def getLoss(self):
        if self._ccm is None:
            self.compute()
        return float(self._loss)

    def getMask(self):
        return self._mask.reshape(-1, 1).astype(np.uint8) * 255

    def getWeights(self):
        return (self._weights if self._weights is not None
                else np.ones(len(self._src)))

    def getSrcLinearRGB(self):
        return self._linearize(self._src).reshape(-1, 1, 3)

    def getRefLinearRGB(self):
        return _lab_d50_to_linear_rgb(self._ref_lab).reshape(-1, 1, 3)

    def correctImage(self, img):
        """The corrected image, as a tensor on the image's device: u8 for u8
        input, else f64.  The last axis is the model's RGB."""
        if self._ccm is None:
            self.compute()
        a = as_tensor(img)
        dev = a.device
        f64 = torch.float64
        u8 = a.dtype == torch.uint8
        if u8:
            lin = to_device(self._linearize(np.arange(256) / 255.0), dev)[a.to(torch.int64)]
        else:
            rgb = a.to(f64)
            lin = torch.sign(rgb) * rgb.abs() ** self._gamma
        M = to_device(self._ccm, dev)
        out = lin[..., 0:1] * M[0] + lin[..., 1:2] * M[1]
        out = out + lin[..., 2:3] * M[2]
        if self._ccm.shape[0] == 4:
            out = out + M[3]
        out = out.clamp(0, 1) ** (1.0 / self._gamma)
        if u8:
            return torch.round(out * 255).clamp(0, 255).to(torch.uint8)
        return out

    def read(self, node):
        pass

    def write(self, fs):
        pass


class _CcmNS:
    ColorCorrectionModel = ColorCorrectionModel
    COLORCHECKER_MACBETH = COLORCHECKER_MACBETH
    COLORCHECKER_VINYL = COLORCHECKER_VINYL
    COLORCHECKER_DIGITAL_SG = COLORCHECKER_DIGITAL_SG
    CCM_LINEAR = CCM_LINEAR
    CCM_AFFINE = CCM_AFFINE


ccm = _CcmNS()
