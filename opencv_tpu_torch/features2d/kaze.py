"""KAZE (features2d/src/kaze/KAZEFeatures.cpp, Alcantarilla et al.
ECCV 2012 "KAZE Features"), twin of ``opencv_tpu/features2d/kaze.py``.

Shares the FED nonlinear-diffusion machinery with AKAZE
([[akaze]] module) but keeps every evolution level at full image
resolution (KAZEFeatures.cpp:98 Create_Nonlinear_Scale_Space) and
describes keypoints with the MSURF 64-float (or extended 128-float)
descriptor (KAZEFeatures.cpp:788 Get_KAZE_Descriptor_64).

The scale space, the scale-normalised derivatives and the Hessian
determinant run on the input's device in torch, batched over the images
(every float op alone, so the card and the CPU round alike); one
read-back of the levels; then the JAX package's numpy, copied, on the
host: the 3×3×3 maxima with duplicate suppression, the 3D refinement,
the orientation and the MSURF descriptor.
"""

from __future__ import annotations

import math

import numpy as np

from .keypoint import KeyPoint
from .akaze import (_fed_tau, _gaussian, _scharr, _diffusivity,
                    _nld_steps, _deriv_kernels, _sep_filter,
                    compute_kcontrast, _main_orientations, _gray_batch, _single,
                    image_levels, read_levels, to_float_image,
                    DIFF_PM_G1, DIFF_PM_G2, DIFF_WEICKERT,
                    DIFF_CHARBONNIER)

__all__ = ["KAZE", "KAZE_create", "DIFF_PM_G1", "DIFF_PM_G2", "DIFF_WEICKERT",
           "DIFF_CHARBONNIER"]


def _msurf_descriptors(levels, kpts, upright=False, extended=False):
    """MSURF 64/128 float descriptors, batched per evolution level
    (KAZEFeatures.cpp:788)."""
    vals_per = 8 if extended else 4
    dsize = 16 * vals_per
    desc = np.zeros((len(kpts), dsize), np.float32)
    by_level = {}
    for i, kp in enumerate(kpts):
        by_level.setdefault(kp.class_id, []).append(i)
    # subregion anchors: i0 in {-12,-7,-2,3} x same for j0, 9x9 samples
    anchors = [-12, -7, -2, 3]
    koff, loff = np.meshgrid(np.arange(9), np.arange(9), indexing="ij")
    koff = koff.ravel()
    loff = loff.ravel()
    for lvl_id, idxs in by_level.items():
        Lx, Ly = levels[lvl_id]
        H, W = Lx.shape
        sel = [kpts[i] for i in idxs]
        N = len(sel)
        xf = np.asarray([kp.pt[0] for kp in sel])
        yf = np.asarray([kp.pt[1] for kp in sel])
        scale = np.asarray([round(kp.size / 2.0) for kp in sel],
                           np.float64)
        if upright:
            co = np.ones(N)
            si = np.zeros(N)
        else:
            a = np.radians([kp.angle for kp in sel])
            co = np.cos(a)
            si = np.sin(a)
        out = np.zeros((N, dsize), np.float64)
        dcount = 0
        for bi, i0 in enumerate(anchors):        # row block (cx)
            for bj, j0 in enumerate(anchors):    # col block (cy)
                ks = (i0 + koff)[None, :]        # (1,81)
                ls = (j0 + loff)[None, :]
                sy = yf[:, None] + (ls * co[:, None]
                                    + ks * si[:, None]) * scale[:, None]
                sx = xf[:, None] + (-ls * si[:, None]
                                    + ks * co[:, None]) * scale[:, None]
                ky = i0 + 5
                kx = j0 + 5
                ys = yf + (kx * co + ky * si) * scale
                xs = xf + (-kx * si + ky * co) * scale
                g1 = np.exp(-((xs[:, None] - sx) ** 2
                              + (ys[:, None] - sy) ** 2)
                            / (2.0 * (2.5 * scale[:, None]) ** 2))
                y1 = np.clip(np.floor(sy).astype(np.int64), 0, H - 1)
                x1 = np.clip(np.floor(sx).astype(np.int64), 0, W - 1)
                y2 = np.clip(y1 + 1, 0, H - 1)
                x2 = np.clip(x1 + 1, 0, W - 1)
                fy = sy - np.floor(sy)
                fx = sx - np.floor(sx)
                w11 = (1 - fx) * (1 - fy)
                w21 = fx * (1 - fy)
                w12 = (1 - fx) * fy
                w22 = fx * fy
                rx = (w11 * Lx[y1, x1] + w21 * Lx[y1, x2]
                      + w12 * Lx[y2, x1] + w22 * Lx[y2, x2])
                ry = (w11 * Ly[y1, x1] + w21 * Ly[y1, x2]
                      + w12 * Ly[y2, x1] + w22 * Ly[y2, x2])
                rry = g1 * (rx * co[:, None] + ry * si[:, None])
                rrx = g1 * (-rx * si[:, None] + ry * co[:, None])
                cx = 0.5 + bi
                cy = 0.5 + bj
                g2 = math.exp(-((cx - 2.0) ** 2 + (cy - 2.0) ** 2)
                              / (2.0 * 1.5 * 1.5))
                if not extended:
                    out[:, dcount + 0] = rrx.sum(1) * g2
                    out[:, dcount + 1] = rry.sum(1) * g2
                    out[:, dcount + 2] = np.abs(rrx).sum(1) * g2
                    out[:, dcount + 3] = np.abs(rry).sum(1) * g2
                    dcount += 4
                else:
                    posy = rry >= 0
                    posx = rrx >= 0
                    out[:, dcount + 0] = np.where(posy, rrx, 0).sum(1) * g2
                    out[:, dcount + 1] = np.where(~posy, rrx, 0).sum(1) * g2
                    out[:, dcount + 2] = np.abs(
                        np.where(posy, rrx, 0)).sum(1) * g2
                    out[:, dcount + 3] = np.abs(
                        np.where(~posy, rrx, 0)).sum(1) * g2
                    out[:, dcount + 4] = np.where(posx, rry, 0).sum(1) * g2
                    out[:, dcount + 5] = np.where(~posx, rry, 0).sum(1) * g2
                    out[:, dcount + 6] = np.abs(
                        np.where(posx, rry, 0)).sum(1) * g2
                    out[:, dcount + 7] = np.abs(
                        np.where(~posx, rry, 0)).sum(1) * g2
                    dcount += 8
        nrm = np.sqrt((out ** 2).sum(axis=1, keepdims=True))
        out /= np.maximum(nrm, 1e-12)
        for k, i in enumerate(idxs):
            desc[i] = out[k]
    return desc


class KAZE:
    """cv::KAZE (features2d/src/kaze.cpp)."""

    def __init__(self, extended=False, upright=False, threshold=0.001,
                 nOctaves=4, nOctaveLayers=4, diffusivity=DIFF_PM_G2):
        self.extended = extended
        self.upright = upright
        self.threshold = threshold
        self.nOctaves = nOctaves
        self.nOctaveLayers = nOctaveLayers
        self.diffusivity = diffusivity
        self.soffset = 1.6
        self.sderivatives = 1.0

    @staticmethod
    def create(extended=False, upright=False, threshold=0.001,
               nOctaves=4, nOctaveLayers=4, diffusivity=DIFF_PM_G2):
        return KAZE(extended, upright, threshold, nOctaves,
                    nOctaveLayers, diffusivity)

    def getThreshold(self):
        return self.threshold

    def setThreshold(self, t):
        self.threshold = t

    def getExtended(self):
        return self.extended

    def getUpright(self):
        return self.upright

    def getNOctaves(self):
        return self.nOctaves

    def getNOctaveLayers(self):
        return self.nOctaveLayers

    def getDiffusivity(self):
        return self.diffusivity

    def descriptorSize(self):
        return 128 if self.extended else 64

    def descriptorType(self):
        return 5   # CV_32F

    def defaultNorm(self):
        return 4   # NORM_L2

    # ------------------------------------------------------ pipeline
    def _plan(self):
        levels = []
        for i in range(self.nOctaves):
            for j in range(self.nOctaveLayers):
                esigma = self.soffset * 2.0 ** (j / self.nOctaveLayers + i)
                levels.append(dict(octave=i, sublevel=j, esigma=esigma,
                                   sigma_size=int(round(esigma)),
                                   etime=0.5 * esigma * esigma))
        return levels

    def scale_space(self, img_f):
        """Full-resolution nonlinear scale space (KAZEFeatures.cpp:98) of a
        (B, H, W) f32 batch on its device: the plan's level dicts with
        ``Lt``, ``Lx``, ``Ly`` and ``Ldet``, each (B, H, W) f32.  A level's
        smoothed copy is the next level's conductivity input too: taken
        once."""
        plan = self._plan()
        Lt = _gaussian(img_f, self.soffset)
        kcontrast = compute_kcontrast(Lt)
        levels = []
        for i, e in enumerate(plan):
            if i == 0:
                cur = Lt
            else:
                prev = levels[i - 1]
                Lxj, Lyj = _scharr(prev["Lsmooth"])
                c = _diffusivity(Lxj, Lyj, kcontrast, self.diffusivity)
                taus = _fed_tau(e["etime"] - plan[i - 1]["etime"])
                cur = _nld_steps(prev["Lt"], c, taus)
            levels.append(dict(e, Lt=cur, Lsmooth=_gaussian(cur, self.sderivatives)))
        # scale-normalized multiscale derivatives + Hessian determinant
        # (KAZEFeatures.cpp:196 MultiscaleDerivativesKAZEInvoker)
        for e in levels:
            s = e["sigma_size"]
            kx_d, ky_d = _deriv_kernels(1, s)
            kx_y, ky_y = _deriv_kernels(0, s)
            Lsm = e.pop("Lsmooth")
            Lx = _sep_filter(Lsm, kx_d, ky_d)
            Ly = _sep_filter(Lsm, kx_y, ky_y)
            Lxx = _sep_filter(Lx, kx_d, ky_d)
            Lyy = _sep_filter(Ly, kx_y, ky_y)
            Lxy = _sep_filter(Lx, kx_y, ky_y)
            e["Lx"] = Lx * float(s)
            e["Ly"] = Ly * float(s)
            e["Ldet"] = (Lxx * Lyy - Lxy * Lxy) * float(s * s) * float(s * s)
        return levels

    def _detect(self, levels):
        """3x3x3 scale-space maxima + duplicate suppression
        (KAZEFeatures.cpp:234, :311)."""
        H, W = levels[0]["Ldet"].shape
        smax = 3.0
        kpts = []
        for li in range(1, len(levels) - 1):
            e = levels[li]
            D = e["Ldet"]
            Dl = levels[li - 1]["Ldet"]
            Du = levels[li + 1]["Ldet"]
            c = D[1:-1, 1:-1]
            ok = c > self.threshold
            ok &= c >= D[1:-1, :-2]          # left neighbor non-strict
            for (A, same) in ((D, True), (Dl, False), (Du, False)):
                for dy in (0, 1, 2):
                    for dx in (0, 1, 2):
                        if same and dy == 1 and dx == 1:
                            continue
                        ok &= c > A[dy:H - 2 + dy, dx:W - 2 + dx]
            ys, xs = np.nonzero(ok)
            order = np.lexsort((xs, ys))
            ssz2 = e["sigma_size"] ** 2
            for k in order:
                y = int(ys[k]) + 1
                x = int(xs[k]) + 1
                v = float(D[y, x])
                is_extremum = True
                repeated = -1
                for ik, kp in enumerate(kpts):
                    if kp is None or abs(kp.class_id - li) > 1:
                        continue
                    dd = (kp.pt[0] - x) ** 2 + (kp.pt[1] - y) ** 2
                    if dd < ssz2:
                        if v > kp.response:
                            repeated = ik
                        else:
                            is_extremum = False
                        break
                if not is_extremum:
                    continue
                sz = e["esigma"]
                if (round(x - smax * sz) < 0 or round(x + smax * sz) >= W
                        or round(y - smax * sz) < 0
                        or round(y + smax * sz) >= H):
                    continue
                kp = KeyPoint(x, y, sz, float(e["sublevel"]), v,
                              e["octave"], li)
                if repeated >= 0:
                    kpts[repeated] = kp
                else:
                    kpts.append(kp)
        return [k for k in kpts if k is not None]

    def _refine(self, levels, kpts):
        """3D (x, y, scale) subpixel refinement
        (KAZEFeatures.cpp:408)."""
        out = []
        for kp in kpts:
            li = kp.class_id
            D = levels[li]["Ldet"]
            Dl = levels[li - 1]["Ldet"]
            Du = levels[li + 1]["Ldet"]
            x = int(kp.pt[0])
            y = int(kp.pt[1])
            Dx = 0.5 * (D[y, x + 1] - D[y, x - 1])
            Dy = 0.5 * (D[y + 1, x] - D[y - 1, x])
            Ds = 0.5 * (Du[y, x] - Dl[y, x])
            Dxx = D[y, x + 1] + D[y, x - 1] - 2 * D[y, x]
            Dyy = D[y + 1, x] + D[y - 1, x] - 2 * D[y, x]
            Dss = Du[y, x] + Dl[y, x] - 2 * D[y, x]
            Dxy = 0.25 * (D[y + 1, x + 1] + D[y - 1, x - 1]
                          - D[y - 1, x + 1] - D[y + 1, x - 1])
            Dxs = 0.25 * (Du[y, x + 1] + Dl[y, x - 1]
                          - Du[y, x - 1] - Dl[y, x + 1])
            Dys = 0.25 * (Du[y + 1, x] + Dl[y - 1, x]
                          - Du[y - 1, x] - Dl[y + 1, x])
            A = np.array([[Dxx, Dxy, Dxs], [Dxy, Dyy, Dys],
                          [Dxs, Dys, Dss]])
            try:
                d = np.linalg.solve(A, [-Dx, -Dy, -Ds])
            except np.linalg.LinAlgError:
                continue
            if np.abs(d).max() <= 1.0:
                dsc = kp.octave + (kp.angle + d[2]) / self.nOctaveLayers
                kp.pt = (kp.pt[0] + d[0], kp.pt[1] + d[1])
                kp.size = 2.0 * self.soffset * 2.0 ** dsc
                kp.angle = 0.0
                out.append(kp)
        return out

    def host_detect(self, levels, mask=None):
        """One image's keypoints from its host levels."""
        kpts = self._refine(levels, self._detect(levels))
        if mask is not None:
            mk = np.asarray(mask)
            kpts = [k for k in kpts if mk[int(k.pt[1]), int(k.pt[0])]]
        return kpts

    def host_describe(self, levels, kpts):
        """One image's (keypoints, descriptors) from its host levels."""
        if not kpts:
            return kpts, np.zeros((0, self.descriptorSize()), np.float32)
        if not self.upright:
            by_level = {}
            for i, kp in enumerate(kpts):
                by_level.setdefault(kp.class_id, []).append(i)
            for li, idxs in by_level.items():
                e = levels[li]
                xs = np.asarray([round(kpts[i].pt[0]) for i in idxs],
                                np.int64)
                ys = np.asarray([round(kpts[i].pt[1]) for i in idxs],
                                np.int64)
                sc = np.asarray([round(kpts[i].size / 2.0) for i in idxs],
                                np.int64)
                angles = _main_orientations(e["Lx"], e["Ly"], xs, ys, sc)
                for k, i in enumerate(idxs):
                    kpts[i].angle = float(angles[k])
        else:
            for kp in kpts:
                kp.angle = 0.0
        lv = {li: (levels[li]["Lx"], levels[li]["Ly"])
              for li in range(len(levels))}
        desc = _msurf_descriptors(lv, kpts, self.upright, self.extended)
        return kpts, desc

    def levels_on_host(self, images):
        """The scale space of an (B, H, W) batch, its derivatives and
        determinants read back (the host tails read nothing else)."""
        return read_levels(self.scale_space(to_float_image(_gray_batch(images))),
                           keys=("Lx", "Ly", "Ldet"))

    def detect_and_compute_batch(self, images):
        """(B, H, W) batch (a tensor on any device, or numpy) → list of
        (keypoints, descriptors), each equal to detectAndCompute's."""
        lv = self.levels_on_host(images)
        out = []
        for b in range(lv[0]["Ldet"].shape[0]):
            levels = image_levels(lv, b)
            out.append(self.host_describe(levels, self.host_detect(levels)))
        return out

    def detect(self, image, mask=None):
        return self.host_detect(image_levels(self.levels_on_host(_single(image)), 0), mask)

    def compute(self, image, keypoints):
        levels = image_levels(self.levels_on_host(_single(image)), 0)
        return self.host_describe(levels, keypoints)

    def detectAndCompute(self, image, mask=None):
        levels = image_levels(self.levels_on_host(_single(image)), 0)
        return self.host_describe(levels, self.host_detect(levels, mask))


def KAZE_create(extended=False, upright=False, threshold=0.001,
                nOctaves=4, nOctaveLayers=4, diffusivity=DIFF_PM_G2):
    return KAZE(extended, upright, threshold, nOctaves, nOctaveLayers,
                diffusivity)
