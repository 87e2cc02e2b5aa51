"""DIS optical flow (video/src/dis_flow.cpp, Kroeger et al.); the port's
copy of ``opencv_tpu/video/dis.py``.

Dense Inverse Search: per-level sparse patch grid, inverse-compositional
gradient descent per patch with raster spatial propagation (sequential by
design: a host loop over the small patch grid), then residual-weighted
densification.  Host numpy, as in the JAX package; the pyramids and the
flow's upscaling are the port's ``resize`` (INTER_AREA on u8, INTER_LINEAR
on f32) and the per-level refinement the port's
:class:`~opencv_tpu_torch.video.variational.VariationalRefinement`, each
read back to the host.  The images may be tensors; the flow is an (H, W, 2)
f32 numpy array.
"""

from __future__ import annotations

import numpy as np

from .. import constants as K
from ..core.arrays import to_host
from ..ops.resize import resize
from .variational import VariationalRefinement

__all__ = ["DISOpticalFlow", "DISOpticalFlow_create"]

_EPS = 0.001
_INF = 1e10


def _spatial_gradient(img):
    """Sobel 3x3 pair like cv::spatialGradient (int16)."""
    p = np.pad(img.astype(np.int32), 1, mode="edge")
    gx = ((p[1:-1, 2:] - p[1:-1, :-2]) * 2
          + (p[:-2, 2:] - p[:-2, :-2]) + (p[2:, 2:] - p[2:, :-2]))
    gy = ((p[2:, 1:-1] - p[:-2, 1:-1]) * 2
          + (p[2:, :-2] - p[:-2, :-2]) + (p[2:, 2:] - p[:-2, 2:]))
    return gx.astype(np.float32), gy.astype(np.float32)


def _resize_area_u8(img, w, h):
    return to_host(resize(img, (w, h), interpolation=K.INTER_AREA))


def _resize_linear_f(img, w, h):
    return to_host(resize(img.astype(np.float32), (w, h),
                          interpolation=K.INTER_LINEAR))


class DISOpticalFlow:
    PRESET_ULTRAFAST = 0
    PRESET_FAST = 1
    PRESET_MEDIUM = 2

    def __init__(self, preset=PRESET_FAST):
        self.patch_size = 8
        self.use_mean_normalization = True
        self.use_spatial_propagation = True
        if preset == self.PRESET_ULTRAFAST:
            self.finest_scale = 2
            self.patch_stride = 4
            self.grad_descent_iter = 12
            self.variational_refinement_iter = 0
        elif preset == self.PRESET_MEDIUM:
            self.finest_scale = 1
            self.patch_stride = 3
            self.grad_descent_iter = 25
            self.variational_refinement_iter = 5
        else:
            self.finest_scale = 2
            self.patch_stride = 4
            self.grad_descent_iter = 16
            self.variational_refinement_iter = 5

    @staticmethod
    def create(preset=1):
        return DISOpticalFlow(preset)

    # parameter surface
    def setFinestScale(self, v):
        self.finest_scale = int(v)

    def getFinestScale(self):
        return self.finest_scale

    def setPatchSize(self, v):
        self.patch_size = int(v)

    def setPatchStride(self, v):
        self.patch_stride = int(v)

    def setGradientDescentIterations(self, v):
        self.grad_descent_iter = int(v)

    def setVariationalRefinementIterations(self, v):
        self.variational_refinement_iter = int(v)

    def getVariationalRefinementIterations(self):
        return self.variational_refinement_iter

    def setUseSpatialPropagation(self, v):
        self.use_spatial_propagation = bool(v)

    def setUseMeanNormalization(self, v):
        self.use_mean_normalization = bool(v)

    def _inverse_search(self, I0, I1ext, gx, gy, U, psz, pstride, bsz,
                        niter_total):
        h, w = I0.shape
        ws = 1 + (w - psz) // pstride
        hs = 1 + (h - psz) // pstride
        psz2 = psz // 2
        n = float(psz * psz)

        # per-patch structure tensor + gradient sums
        xs = np.arange(ws) * pstride
        ys = np.arange(hs) * pstride
        # patch pixel blocks: (hs, ws, psz, psz)
        def blocks(a):
            return np.lib.stride_tricks.sliding_window_view(
                a, (psz, psz))[::pstride, ::pstride][:hs, :ws]

        gxb = blocks(gx)
        gyb = blocks(gy)
        sxx = (gxb * gxb).sum((-1, -2))
        syy = (gyb * gyb).sum((-1, -2))
        sxy = (gxb * gyb).sum((-1, -2))
        sx = gxb.sum((-1, -2))
        sy = gyb.sum((-1, -2))
        if self.use_mean_normalization:
            hxx = sxx - sx * sx / n
            hyy = syy - sy * sy / n
            hxy = sxy - sx * sy / n
        else:
            hxx, hyy, hxy = sxx, syy, sxy
        det = hxx * hyy - hxy * hxy
        det = np.where(np.abs(det) < _EPS, _EPS, det)
        invH11 = hyy / det
        invH12 = -hxy / det
        invH22 = hxx / det

        I0f = I0.astype(np.float32)
        Sx = np.zeros((hs, ws), np.float32)
        Sy = np.zeros((hs, ws), np.float32)

        i_lo = bsz - psz + 1.0
        i_hi = bsz + h - 1.0
        j_lo = bsz - psz + 1.0
        j_hi = bsz + w - 1.0

        def sample(i, j, uy, ux):
            ii = min(max(i + uy + bsz, i_lo), i_hi)
            jj = min(max(j + ux + bsz, j_lo), j_hi)
            i0 = int(ii)
            j0 = int(jj)
            di = ii - i0
            dj = jj - j0
            blk = I1ext[i0:i0 + psz + 1, j0:j0 + psz + 1]
            top = blk[:psz, :psz] * (1 - dj) + blk[:psz, 1:psz + 1] * dj
            bot = blk[1:psz + 1, :psz] * (1 - dj) \
                + blk[1:psz + 1, 1:psz + 1] * dj
            return top * (1 - di) + bot * di

        def ssd(i, j, uy, ux):
            diff = sample(i, j, uy, ux) - I0f[i:i + psz, j:j + psz]
            s = diff.sum()
            s2 = (diff * diff).sum()
            if self.use_mean_normalization:
                return s2 - s * s / n
            return s2

        num_iter = 2 if self.use_spatial_propagation else 1
        inner = int(niter_total / num_iter)
        for it in range(num_iter):
            rng_is = range(hs) if it % 2 == 0 else range(hs - 1, -1, -1)
            d = 1 if it % 2 == 0 else -1
            for is_ in rng_is:
                i = is_ * pstride
                rng_js = range(ws) if it % 2 == 0 else range(ws - 1, -1, -1)
                for js in rng_js:
                    j = js * pstride
                    if it == 0:
                        Sx[is_, js] = U[i + psz2, j + psz2, 0]
                        Sy[is_, js] = U[i + psz2, j + psz2, 1]
                    best = ssd(i, j, Sy[is_, js], Sx[is_, js])
                    if self.use_spatial_propagation:
                        pj = js - d
                        if 0 <= pj < ws:
                            c = ssd(i, j, Sy[is_, pj], Sx[is_, pj])
                            if c < best:
                                best = c
                                Sx[is_, js] = Sx[is_, pj]
                                Sy[is_, js] = Sy[is_, pj]
                        pi = is_ - d
                        if 0 <= pi < hs:
                            c = ssd(i, j, Sy[pi, js], Sx[pi, js])
                            if c < best:
                                best = c
                                Sx[is_, js] = Sx[pi, js]
                                Sy[is_, js] = Sy[pi, js]
                    ux = Sx[is_, js]
                    uy = Sy[is_, js]
                    gxp = gxb[is_, js]
                    gyp = gyb[is_, js]
                    prev = _INF
                    for _ in range(inner):
                        diff = sample(i, j, uy, ux) \
                            - I0f[i:i + psz, j:j + psz]
                        s = diff.sum()
                        cur = (diff * diff).sum()
                        if self.use_mean_normalization:
                            cur -= s * s / n
                            dUx = (diff * gxp).sum() - s * sx[is_, js] / n
                            dUy = (diff * gyp).sum() - s * sy[is_, js] / n
                        else:
                            dUx = (diff * gxp).sum()
                            dUy = (diff * gyp).sum()
                        ux -= invH11[is_, js] * dUx + invH12[is_, js] * dUy
                        uy -= invH12[is_, js] * dUx + invH22[is_, js] * dUy
                        if cur >= prev:
                            break
                        prev = cur
                    if np.hypot(ux - Sx[is_, js],
                                uy - Sy[is_, js]) <= psz:
                        Sx[is_, js] = ux
                        Sy[is_, js] = uy
        return Sx, Sy

    def _densify(self, I0, I1, Sx, Sy, psz, pstride):
        h, w = I0.shape
        ws = Sx.shape[1]
        hs = Sx.shape[0]
        num_x = np.zeros((h, w), np.float64)
        num_y = np.zeros((h, w), np.float64)
        den = np.zeros((h, w), np.float64)
        I1f = I1.astype(np.float64)
        I0f = I0.astype(np.float64)
        yy0, xx0 = np.mgrid[0:psz, 0:psz]
        for is_ in range(hs):
            for js in range(ws):
                i0 = is_ * pstride
                j0 = js * pstride
                ux = Sx[is_, js]
                uy = Sy[is_, js]
                jm = np.clip(j0 + xx0 + ux, 0, w - 1 - _EPS)
                im = np.clip(i0 + yy0 + uy, 0, h - 1 - _EPS)
                jl = jm.astype(int)
                il = im.astype(int)
                fj = jm - jl
                fi = im - il
                val = (I1f[il, jl] * (1 - fj) * (1 - fi)
                       + I1f[il, jl + 1] * fj * (1 - fi)
                       + I1f[il + 1, jl] * (1 - fj) * fi
                       + I1f[il + 1, jl + 1] * fj * fi)
                diff = val - I0f[i0:i0 + psz, j0:j0 + psz]
                coef = 1.0 / np.maximum(1.0, np.abs(diff))
                num_x[i0:i0 + psz, j0:j0 + psz] += coef * ux
                num_y[i0:i0 + psz, j0:j0 + psz] += coef * uy
                den[i0:i0 + psz, j0:j0 + psz] += coef
        den = np.maximum(den, 1e-12)
        return np.stack([num_x / den, num_y / den], -1).astype(np.float32)

    def calc(self, I0, I1, flow=None):
        img0 = to_host(I0)
        img1 = to_host(I1)
        if img0.ndim == 3:
            img0 = img0[..., 0]
            img1 = img1[..., 0]
        H, W = img0.shape
        psz = self.patch_size
        coarsest = min(int(np.log2(max(W, H) / (4.0 * psz)) + 0.5),
                       int(np.log2(min(W, H) / psz)))
        coarsest = max(coarsest, self.finest_scale)

        # pyramids (INTER_AREA halving)
        I0s = {0: img0}
        I1s = {0: img1}
        cw, ch = W, H
        for lvl in range(1, coarsest + 1):
            cw //= 2
            ch //= 2
            I0s[lvl] = _resize_area_u8(I0s[lvl - 1], cw, ch)
            I1s[lvl] = _resize_area_u8(I1s[lvl - 1], cw, ch)

        bsz = 16
        U = np.zeros(I0s[coarsest].shape + (2,), np.float32)
        for lvl in range(coarsest, self.finest_scale - 1, -1):
            a = I0s[lvl]
            b = I1s[lvl]
            hh, ww = a.shape
            gx, gy = _spatial_gradient(a)
            bext = np.pad(b, bsz, mode="edge")
            Sx, Sy = self._inverse_search(a, bext.astype(np.float32),
                                          gx, gy, U, psz,
                                          self.patch_stride, bsz,
                                          self.grad_descent_iter)
            U = self._densify(a, b, Sx, Sy, psz, self.patch_stride)
            if self.variational_refinement_iter > 0:
                # per-level refinement like dis_flow.cpp:310-316
                vr = VariationalRefinement()
                vr.setAlpha(20.0)
                vr.setDelta(5.0)
                vr.setGamma(10.0)
                vr.setSorIterations(5)
                vr.setFixedPointIterations(self.variational_refinement_iter)
                u, v = vr.calcUV(a, b, U[..., 0].copy(), U[..., 1].copy())
                U = np.stack([to_host(u), to_host(v)], -1)
            if lvl > self.finest_scale:
                nh, nw = I0s[lvl - 1].shape
                U = np.stack([
                    _resize_linear_f(U[..., 0], nw, nh),
                    _resize_linear_f(U[..., 1], nw, nh)], -1) * 2.0

        out = np.stack([
            _resize_linear_f(U[..., 0], W, H),
            _resize_linear_f(U[..., 1], W, H)], -1) \
            * float(1 << self.finest_scale)
        return out.astype(np.float32)


def DISOpticalFlow_create(preset=1):
    return DISOpticalFlow(preset)
