"""HDR: exposure merging and tonemapping (photo/src/merge.cpp,
calibrate.cpp, tonemap.cpp, align.cpp), twin of ``opencv_tpu/photo/hdr.py``.

Mertens exposure fusion runs as torch on the images' device: the weights,
then the Laplacian pyramid blend over the port's ``Laplacian``, ``pyrDown``
and ``pyrUp`` (float32, the float path: no kernel), with nothing read back
until the result.  The sums across the exposures and across the three
channels are written out in numpy's order (sequential), as the JAX package
takes them in numpy; the square roots (and any power or exp of a weight
exponent other than the defaults) are taken in float64 and rounded to
float32, the correctly rounded value on every device.

Debevec and Robertson (merge and calibrate), the four tonemappers and
AlignMTB are the JAX package's numpy code, copied, over the port's
``cvtColor`` and ``resize`` on the input's device; their results are
tensors on that device.  AlignMTB reads each frame's gray plane back once,
finds the shifts on the host, and shifts and cuts the frames on their
device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as K
from ..core.arrays import as_tensor, to_host
from ..ops.color import cvtColor
from ..ops.deriv import Laplacian
from ..ops.pyramids import pyrDown, pyrUp
from ..ops.resize import resize
from .npr import _f32

__all__ = ["MergeMertens", "createMergeMertens", "MergeDebevec",
           "createMergeDebevec", "CalibrateDebevec",
           "createCalibrateDebevec", "Tonemap", "createTonemap",
           "TonemapDrago", "createTonemapDrago", "TonemapReinhard",
           "createTonemapReinhard", "AlignMTB", "createAlignMTB",
           "MergeRobertson", "createMergeRobertson",
           "CalibrateRobertson", "createCalibrateRobertson",
           "TonemapMantiuk", "createTonemapMantiuk"]


def _device(x):
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def _out(a, device) -> torch.Tensor:
    """A host result as a tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _rounded(fn, x: torch.Tensor, *args) -> torch.Tensor:
    """float32 fn(x, *args), taken in float64 and rounded."""
    return fn(x.to(torch.float64), *args).to(torch.float32)


def _csum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis in numpy's order for a few channels."""
    s = x[..., 0]
    for c in range(1, x.shape[-1]):
        s = s + x[..., c]
    return s


class MergeMertens:
    """Exposure fusion (Mertens et al.; merge.cpp MergeMertensImpl)."""

    def __init__(self, contrast_weight=1.0, saturation_weight=1.0,
                 exposure_weight=0.0):
        self.wc = contrast_weight
        self.ws = saturation_weight
        self.we = exposure_weight

    def _weight(self, im):
        """A float32 (H, W, [C]) exposure's weight map (H, W)."""
        dev = im.device
        color = im.ndim == 3
        C = im.shape[2] if color else 1
        three = _f32(C, dev)
        gray = _csum(im) / three if color else im
        # contrast: |laplacian|
        lap = Laplacian(gray, K.CV_32F).abs()
        contrast = _rounded(torch.pow, lap, self.wc) if self.wc != 1.0 else lap
        if color:
            d = im - (_csum(im) / three)[..., None]
            sat = _rounded(torch.sqrt, _csum(d * d) / three)
        else:
            sat = torch.zeros_like(gray)
        saturation = _rounded(torch.pow, sat, self.ws) if self.ws != 1.0 else sat
        w = contrast * saturation
        if self.we != 0.0:
            c = im - _f32(0.5, dev)
            e = -(_csum(c * c) if color else c * c)
            wexp = _rounded(torch.exp, e / _f32(2 * 0.2 * 0.2, dev) / three)
            w = w * _rounded(torch.pow, wexp, self.we)
        return w + _f32(1e-12, dev)

    def process(self, images, dst=None):
        imgs = [as_tensor(im) for im in images]
        dev = imgs[0].device
        imgs = [im.to(dev).to(torch.float32) / _f32(255.0, dev) for im in imgs]
        H, W = imgs[0].shape[:2]

        weights = [self._weight(im) for im in imgs]
        wsum = weights[0]
        for w in weights[1:]:
            wsum = wsum + w
        weights = [w / wsum for w in weights]

        # pyramid blending
        levels = max(int(np.floor(np.log2(min(H, W)))) - 1, 1)
        out_pyr = None
        for im, w in zip(imgs, weights):
            # gaussian pyramid of weights, laplacian pyramid of image
            wp = [w]
            ip = [im]
            for _ in range(levels):
                wp.append(pyrDown(wp[-1]))
                ip.append(pyrDown(ip[-1]))
            lap = []
            for lv in range(levels):
                up = pyrUp(ip[lv + 1])[:ip[lv].shape[0], :ip[lv].shape[1]]
                lap.append(ip[lv] - up)
            lap.append(ip[-1])
            contrib = [lap[lv] * (wp[lv][..., None] if im.ndim == 3 else wp[lv])
                       for lv in range(levels + 1)]
            if out_pyr is None:
                out_pyr = contrib
            else:
                out_pyr = [a + b for a, b in zip(out_pyr, contrib)]

        res = out_pyr[-1]
        for lv in range(levels - 1, -1, -1):
            up = pyrUp(res)[:out_pyr[lv].shape[0], :out_pyr[lv].shape[1]]
            res = up + out_pyr[lv]
        return res


def createMergeMertens(contrast_weight=1.0, saturation_weight=1.0,
                       exposure_weight=0.0):
    return MergeMertens(contrast_weight, saturation_weight, exposure_weight)


class MergeDebevec:
    """HDR radiance merge (merge.cpp MergeDebevecImpl): weighted average
    of ln(response⁻¹(Z)) - ln(dt) with the triangle weight."""

    def process(self, images, times, response=None, dst=None):
        dev = _device(images[0])
        images = [to_host(im) for im in images]
        times = np.asarray(to_host(times), np.float64).reshape(-1)
        if response is None:
            response = np.arange(256, dtype=np.float32).reshape(256, 1, 1)
            response = np.tile(response, (1, 1, 3)) / 128.0
            response = np.maximum(response, 1e-4)
        resp = np.asarray(to_host(response), np.float32).reshape(256, -1)
        w = np.minimum(np.arange(256), 255 - np.arange(256)).astype(np.float32)
        w = np.maximum(w, 0.02 * 255)
        acc = None
        wacc = None
        for im, t in zip(images, times):
            z = np.asarray(im)
            C = z.shape[2] if z.ndim == 3 else 1
            lres = np.log(resp[:, :C])  # (256, C)
            lnE = lres[z.astype(np.int64), np.arange(C)[None, None]] \
                - np.log(t)
            wz = w[z.astype(np.int64)]
            acc = wz * lnE if acc is None else acc + wz * lnE
            wacc = wz if wacc is None else wacc + wz
        return _out(np.exp(acc / np.maximum(wacc, 1e-9)).astype(np.float32), dev)


def createMergeDebevec():
    return MergeDebevec()


class CalibrateDebevec:
    """Response curve recovery (calibrate.cpp): least squares on sampled
    pixels with smoothness prior (Debevec & Malik)."""

    def __init__(self, samples=70, lambda_=10.0, random=False):
        self.samples = samples
        self.lam = lambda_

    def process(self, images, times, dst=None):
        dev = _device(images[0])
        images = [to_host(im) for im in images]
        times = np.asarray(to_host(times), np.float64).reshape(-1)
        z0 = np.asarray(images[0])
        C = z0.shape[2] if z0.ndim == 3 else 1
        H, W = z0.shape[:2]
        rng = np.random.default_rng(0)
        ys = rng.integers(0, H, self.samples)
        xs = rng.integers(0, W, self.samples)
        out = np.zeros((256, 1, C), np.float32)
        w = np.minimum(np.arange(256), 255 - np.arange(256)).astype(np.float64) + 1
        for c in range(C):
            Zs = np.stack([np.asarray(im)[ys, xs, c] if z0.ndim == 3
                           else np.asarray(im)[ys, xs] for im in images])
            P, S = Zs.shape[0], Zs.shape[1]
            A = np.zeros((P * S + 255, 256 + S))
            b = np.zeros(P * S + 255)
            k = 0
            for i in range(S):
                for j in range(P):
                    z = int(Zs[j, i])
                    A[k, z] = w[z]
                    A[k, 256 + i] = -w[z]
                    b[k] = w[z] * np.log(times[j])
                    k += 1
            A[k, 128] = 1.0
            k += 1
            for z in range(1, 255):
                A[k, z - 1] = self.lam * w[z]
                A[k, z] = -2 * self.lam * w[z]
                A[k, z + 1] = self.lam * w[z]
                k += 1
            g = np.linalg.lstsq(A, b, rcond=None)[0][:256]
            out[:, 0, c] = np.exp(g)
        return _out(out, dev)


def createCalibrateDebevec(samples=70, lambda_=10.0, random=False):
    return CalibrateDebevec(samples, lambda_, random)


class Tonemap:
    def __init__(self, gamma=1.0):
        self.gamma = gamma

    def process(self, src, dst=None):
        return _out(self._process(to_host(src)), _device(src))

    def _process(self, src):
        x = np.asarray(src, np.float32)
        mn, mx = x.min(), x.max()
        if mx > mn:
            x = (x - mn) / (mx - mn)
        return np.power(x, 1.0 / self.gamma).astype(np.float32)


def createTonemap(gamma=1.0):
    return Tonemap(gamma)


class TonemapDrago(Tonemap):
    def __init__(self, gamma=1.0, saturation=1.0, bias=0.85):
        super().__init__(gamma)
        self.saturation = saturation
        self.bias = bias

    def _process(self, src):
        img = np.asarray(src, np.float32)
        gray = img.mean(axis=-1) if img.ndim == 3 else img
        Lwa = np.exp(np.mean(np.log(np.maximum(gray, 1e-6))))
        Lw = gray / Lwa
        Lmax = Lw.max()
        c = np.log(self.bias) / np.log(0.5)
        Ld = (np.log1p(Lw) /
              np.log1p(Lmax)) / np.log(2 + 8 * ((Lw / max(Lmax, 1e-9)) ** c))
        ratio = Ld / np.maximum(gray / Lwa, 1e-9)
        out = img * (ratio[..., None] if img.ndim == 3 else ratio)
        mn, mx = out.min(), out.max()
        if mx > mn:
            out = (out - mn) / (mx - mn)
        return np.power(out, 1.0 / self.gamma).astype(np.float32)


def createTonemapDrago(gamma=1.0, saturation=1.0, bias=0.85):
    return TonemapDrago(gamma, saturation, bias)


class TonemapReinhard(Tonemap):
    def __init__(self, gamma=1.0, intensity=0.0, light_adapt=1.0,
                 color_adapt=0.0):
        super().__init__(gamma)
        self.intensity = intensity
        self.light_adapt = light_adapt
        self.color_adapt = color_adapt

    def _process(self, src):
        img = np.asarray(src, np.float32)
        gray = img.mean(axis=-1) if img.ndim == 3 else img
        logmean = np.exp(np.mean(np.log(np.maximum(gray, 1e-6))))
        key = np.float32(0.18 * (2.0 ** self.intensity))
        L = key * gray / max(logmean, 1e-9)
        Ld = L / (1 + L)
        ratio = Ld / np.maximum(gray, 1e-9)
        out = img * (ratio[..., None] if img.ndim == 3 else ratio)
        out = np.clip(out, 0, 1)
        return np.power(out, 1.0 / self.gamma).astype(np.float32)


def createTonemapReinhard(gamma=1.0, intensity=0.0, light_adapt=1.0,
                          color_adapt=0.0):
    return TonemapReinhard(gamma, intensity, light_adapt, color_adapt)


class AlignMTB:
    """Median-threshold-bitmap exposure alignment
    (photo/src/align.cpp AlignMTBImpl)."""

    def __init__(self, max_bits=6, exclude_range=4, cut=True):
        self.max_bits = max_bits
        self.exclude_range = exclude_range
        self.cut = cut

    def _median(self, img):
        hist = np.bincount(img.ravel(), minlength=256)
        thresh = img.size // 2
        csum = np.cumsum(hist)
        # reference getMedian: first bin where running sum reaches
        # half, post-incremented (align.cpp:229)
        return int(np.searchsorted(csum, thresh, side="left")) + 1

    def computeBitmaps(self, img, tb=None, eb=None):
        tb, eb = self._bitmaps(to_host(img))
        return _out(tb, _device(img)), _out(eb, _device(img))

    def _bitmaps(self, img):
        med = self._median(img)
        # compared as int32: the median is 256 where over half the pixels
        # are 255, and numpy 2.0 crashes on u8 > 256
        img = img.astype(np.int32)
        tb = (img > med).astype(np.uint8) * 255
        eb = (np.abs(img - med) > self.exclude_range).astype(np.uint8) * 255
        return tb, eb

    @staticmethod
    def shiftMat(src, shift):
        """src (a tensor, on its device, or an array) moved by shift (x, y),
        zero filled."""
        src = src if isinstance(src, torch.Tensor) else np.asarray(src)
        sx, sy = int(shift[0]), int(shift[1])
        res = src.new_zeros(src.shape) if isinstance(src, torch.Tensor) else np.zeros_like(src)
        h, w = src.shape[:2]
        ww = w - abs(sx)
        hh = h - abs(sy)
        if ww > 0 and hh > 0:
            res[max(sy, 0):max(sy, 0) + hh, max(sx, 0):max(sx, 0) + ww] = \
                src[max(-sy, 0):max(-sy, 0) + hh,
                    max(-sx, 0):max(-sx, 0) + ww]
        return res

    def calculateShift(self, img0, img1):
        img0 = to_host(img0)
        img1 = to_host(img1)
        maxlevel = int(np.log(max(img0.shape)) / np.log(2.0)) - 1
        maxlevel = min(maxlevel, self.max_bits - 1)
        pyr0 = [img0]
        pyr1 = [img1]
        for _ in range(maxlevel):
            pyr0.append(pyr0[-1][::2, ::2])
            pyr1.append(pyr1[-1][::2, ::2])
        shift = np.zeros(2, np.int64)
        for level in range(maxlevel, -1, -1):
            shift *= 2
            tb1, eb1 = self._bitmaps(pyr0[level])
            tb2, eb2 = self._bitmaps(pyr1[level])
            min_err = pyr0[level].size
            new_shift = shift.copy()
            for di in range(-1, 2):
                for dj in range(-1, 2):
                    test = shift + (di, dj)
                    stb = self.shiftMat(tb2, test)
                    seb = self.shiftMat(eb2, test)
                    diff = (tb1 ^ stb) & eb1 & seb
                    err = int(np.count_nonzero(diff))
                    if err < min_err:
                        new_shift = test.copy()
                        min_err = err
            shift = new_shift
        return (int(shift[0]), int(shift[1]))

    def process(self, src, dst=None, times=None, response=None):
        return self._align(src)[0]

    @staticmethod
    def _window(shifts, h: int, w: int):
        """(x0, y0, x1, y1): the window that every frame shifted by its
        shift covers (the cut)."""
        xs = [s[0] for s in shifts]
        ys = [s[1] for s in shifts]
        return (max(max(xs), 0), max(max(ys), 0), min(min(xs), 0) + w, min(min(ys), 0) + h)

    def _align(self, src):
        """process()'s aligned frames, with the shifts (x, y) found per
        frame."""
        src = [as_tensor(s) for s in src]
        pivot = len(src) // 2
        # reference converts with COLOR_RGB2GRAY on BGR data; each gray
        # plane is read back once
        gray_base = to_host(cvtColor(src[pivot], K.COLOR_RGB2GRAY))
        out = [None] * len(src)
        out[pivot] = src[pivot]
        shifts = []
        for i, im in enumerate(src):
            if i == pivot:
                shifts.append((0, 0))
                continue
            gray = to_host(cvtColor(im, K.COLOR_RGB2GRAY))
            sh = self.calculateShift(gray_base, gray)
            shifts.append(sh)
            out[i] = self.shiftMat(im, sh)
        if self.cut:
            x0, y0, x1, y1 = self._window(shifts, *out[0].shape[:2])
            out = [o[y0:y1, x0:x1] for o in out]
        return out, shifts

    def getMaxBits(self):
        return self.max_bits

    def setMaxBits(self, v):
        self.max_bits = v

    def getExcludeRange(self):
        return self.exclude_range

    def setExcludeRange(self, v):
        self.exclude_range = v

    def getCut(self):
        return self.cut

    def setCut(self, v):
        self.cut = v


def createAlignMTB(max_bits=6, exclude_range=4, cut=True):
    return AlignMTB(max_bits, exclude_range, cut)


def _robertson_weights():
    """hdr_common.cpp:73 RobertsonWeights."""
    i = np.arange(256, dtype=np.float32)
    q = 255.0 / 4.0
    e4 = np.exp(4.0)
    scale = e4 / (e4 - 1.0)
    shift = 1.0 / (1.0 - e4)
    v = i / q - 2.0
    return (scale * np.exp(-v * v) + shift).astype(np.float32)


class MergeRobertson:
    """photo/src/merge.cpp MergeRobertsonImpl."""

    def process(self, src, times, response=None, dst=None):
        return _out(self._process(src, times, response), _device(src[0]))

    @staticmethod
    def _process(src, times, response=None):
        imgs = [to_host(s) for s in src]
        times = np.asarray(to_host(times), np.float32).ravel()
        ch = 1 if imgs[0].ndim == 2 else imgs[0].shape[2]
        if response is None:
            response = (np.repeat(
                np.arange(256, dtype=np.float32)[:, None], ch, 1) / 128.0)
        resp = np.asarray(to_host(response), np.float32).reshape(256, -1)
        if resp.shape[1] == 1 and ch > 1:
            resp = np.repeat(resp, ch, 1)
        w = _robertson_weights()
        num = None
        den = None
        for im, t in zip(imgs, times):
            ix = im.reshape(im.shape[0], im.shape[1], -1)
            wv = w[ix]
            rv = resp[ix, np.arange(ix.shape[-1])[None, None]]
            term = t * wv * rv
            wterm = t * t * wv
            num = term if num is None else num + term
            den = wterm if den is None else den + wterm
        out = num / (den + 2.2204460492503131e-16)
        return out.reshape(imgs[0].shape).astype(np.float32)


def createMergeRobertson():
    return MergeRobertson()


class CalibrateRobertson:
    """photo/src/calibrate.cpp CalibrateRobertsonImpl."""

    def __init__(self, max_iter=30, threshold=0.01):
        self.max_iter = max_iter
        self.threshold = threshold
        self.radiance = None

    def process(self, src, times, dst=None):
        dev = _device(src[0])
        imgs = [to_host(s) for s in src]
        times = np.asarray(to_host(times), np.float32).ravel()
        ch = 1 if imgs[0].ndim == 2 else imgs[0].shape[2]
        response = (np.repeat(np.arange(256, dtype=np.float32)[:, None],
                              ch, 1) / 128.0)
        # per-intensity pixel counts
        card = np.zeros((256, ch), np.float32)
        for im in imgs:
            ix = im.reshape(-1, ch)
            for c in range(ch):
                card[:, c] += np.bincount(ix[:, c], minlength=256)
        # IEEE semantics on purpose: intensities never observed get
        # inf here and NaN in the response, matching the reference's
        # `card = 1.0 / card` MatExpr (calibrate.cpp:223)
        with np.errstate(divide="ignore", invalid="ignore"):
            inv_card = 1.0 / card
        for _ in range(self.max_iter):
            rad = MergeRobertson._process(imgs, times, response)
            self.radiance = _out(rad, dev)
            new_resp = np.zeros((256, ch), np.float32)
            radf = rad.reshape(-1, ch)
            for im, t in zip(imgs, times):
                ix = im.reshape(-1, ch)
                for c in range(ch):
                    np.add.at(new_resp[:, c], ix[:, c], t * radf[:, c])
            new_resp *= inv_card
            mid = new_resp[128].copy()
            new_resp /= mid[None, :]
            diff = np.abs(new_resp - response).sum() / ch
            response = new_resp
            if diff < self.threshold:
                break
        return _out(response.reshape(256, 1, ch).astype(np.float32), dev)

    def getRadiance(self):
        return self.radiance


def createCalibrateRobertson(max_iter=30, threshold=0.01):
    return CalibrateRobertson(max_iter, threshold)


class TonemapMantiuk(Tonemap):
    """Gradient-domain tonemap (tonemap.cpp TonemapMantiukImpl):
    multiscale contrast attenuation solved by conjugate gradients."""

    def __init__(self, gamma=1.0, scale=0.7, saturation=1.0):
        super().__init__(gamma)
        self.scale = scale
        self.saturation = saturation

    @staticmethod
    def _grad(a, pos):
        d = np.zeros_like(a)
        g = a[:, 1:] - a[:, :-1]
        if pos == 0:
            d[:, :-1] = g
        else:
            d[:, 1:] = g
            d[:, 0] = a[:, 0]
        return d

    def _resize(self, a, size):
        """The port's INTER_LINEAR resize of a host plane, on the input's
        device, read back."""
        return to_host(resize(torch.from_numpy(a).to(self._dev), size,
                              interpolation=K.INTER_LINEAR))

    def _contrast(self, src):
        levels = int(np.log(min(src.shape)) / np.log(2.0))
        xs, ys = [], []
        layer = src
        for _ in range(levels):
            xs.append(self._grad(layer, 0))
            ys.append(self._grad(layer.T, 0))
            h, w = layer.shape
            layer = self._resize(layer, (w // 2, h // 2))
        return xs, ys

    def _sum(self, xs, ys):
        s = np.zeros_like(xs[-1])
        for i in range(len(xs) - 1, -1, -1):
            gx = self._grad(xs[i], 1)
            gy = self._grad(ys[i], 1)
            h, w = xs[i].shape
            s = self._resize(s, (w, h))
            s = s + gx + gy.T
        return s

    def _product(self, x):
        xs, ys = self._contrast(x)
        return self._sum(xs, ys)

    def process(self, src, dst=None):
        self._dev = _device(src)
        img = Tonemap(1.0)._process(to_host(src))
        # reference applies COLOR_RGB2GRAY to the raw channel order
        # (tonemap.cpp:536), i.e. 0.299*ch0 + 0.587*ch1 + 0.114*ch2
        gray = np.asarray(
            0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2], np.float32)
        log_img = np.log(np.maximum(gray, 1e-4)).astype(np.float32)

        xs, ys = self._contrast(log_img)

        def map_contrast(c):
            p = 0.4185
            s = np.sign(c)
            out = s * np.abs(c) ** p * self.scale
            return np.sign(out) * np.abs(out) ** (1.0 / p)

        xs = [map_contrast(c) for c in xs]
        ys = [map_contrast(c) for c in ys]
        right = self._sum(xs, ys)

        x = log_img.copy()
        r = right - self._product(x)
        p = r.copy()
        target_norm = float((right * right).sum()) * 1e-6
        rr = float((r * r).sum())
        for _ in range(100):
            prod = self._product(p)
            alpha = rr / float((p * prod).sum())
            r = r - alpha * prod
            x = x + alpha * p
            new_rr = float((r * r).sum())
            p = r + (new_rr / rr) * p
            rr = new_rr
            if rr < target_norm:
                break
        new_lum = np.exp(x)
        ratio = (img / np.maximum(gray, 1e-12)[..., None])
        out = (np.abs(ratio) ** self.saturation
               * np.sign(ratio) * new_lum[..., None]).astype(np.float32)
        return _out(Tonemap(self.gamma)._process(out), self._dev)


def createTonemapMantiuk(gamma=1.0, scale=0.7, saturation=1.0):
    return TonemapMantiuk(gamma, scale, saturation)
