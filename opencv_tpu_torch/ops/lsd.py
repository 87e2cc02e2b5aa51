"""Line Segment Detector (imgproc/src/lsd.cpp, von Gioi et al. LSD); twin
of ``opencv_tpu/ops/lsd.py``, the JAX package's stand-in for LSD (an
aligned-density / size rule in place of the full NFA test), not cv2's.

The Gaussian prefilter and the LINEAR downscale run on the image's device
(the port's f32 ``GaussianBlur`` and ``resize``); the scaled image is read
back once and the rest is the JAX package's host numpy, copied: the 2×2
gradient, ``np.hypot``, ``np.arctan2``, the seed order ``np.argsort(-mag,
axis=None)`` (unstable on ties, which are common, so it is taken over the
whole image as there) and the region grow.  One change: the seeds that are
not usable, which the grow skips anyway, are dropped from that order before
the loop, which leaves the segments as they were (the tests hold them to
the JAX package's).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as K
from ..core.arrays import as_tensor
from .color import cvtColor
from .drawing import _Canvas, _line, line as draw_line
from .filter import GaussianBlur
from .resize import resize

__all__ = ["LineSegmentDetector", "createLineSegmentDetector",
           "LSD_REFINE_NONE", "LSD_REFINE_STD", "LSD_REFINE_ADV"]

LSD_REFINE_NONE = 0
LSD_REFINE_STD = 1
LSD_REFINE_ADV = 2


class LineSegmentDetector:
    def __init__(self, refine=LSD_REFINE_STD, scale=0.8, sigma_scale=0.6,
                 quant=2.0, ang_th=22.5, log_eps=0.0, density_th=0.7,
                 n_bins=1024):
        self.scale = scale
        self.sigma_scale = sigma_scale
        self.quant = quant
        self.ang_th = ang_th
        self.density_th = density_th

    def scaled(self, image) -> np.ndarray:
        """The f32 image the segments are found on, read back to the host:
        gray, then (scale != 1) the Gaussian prefilter and the LINEAR
        downscale (lsd.cpp:LOG_NT scale step), on the image's device."""
        img = as_tensor(image)
        if img.ndim == 3:
            img = cvtColor(img, K.COLOR_BGR2GRAY)
        H0, W0 = img.shape
        s = self.scale
        if s == 1.0:
            return img.cpu().numpy().astype(np.float32)
        sigma = self.sigma_scale / s
        ksz = int(np.ceil(sigma * 6)) | 1
        f = GaussianBlur(img.to(torch.float32), (ksz, ksz), sigma)
        return resize(f, (int(round(W0 * s)), int(round(H0 * s))),
                      interpolation=K.INTER_LINEAR).cpu().numpy()

    def detect(self, image):
        return self.segments(self.scaled(image))

    def segments(self, img_s: np.ndarray):
        """The host tail of ``detect`` on the scaled image `img_s`: returns
        ``(lines, widths, precs, nfa)``."""
        s = self.scale
        H, W = img_s.shape

        # level-line field: angle orthogonal to gradient (2x2 scheme)
        a = img_s
        gx = np.zeros((H, W))
        gy = np.zeros((H, W))
        gx[:-1, :-1] = (a[:-1, 1:] - a[:-1, :-1]
                        + a[1:, 1:] - a[1:, :-1]) / 2.0
        gy[:-1, :-1] = (a[1:, :-1] - a[:-1, :-1]
                        + a[1:, 1:] - a[:-1, 1:]) / 2.0
        mag = np.hypot(gx, gy)
        ang = np.arctan2(gx, -gy)        # level-line angle

        rho = self.quant / np.sin(np.deg2rad(self.ang_th))
        usable = mag > rho
        prec = np.deg2rad(self.ang_th)

        order = np.argsort(-mag, axis=None)
        order = order[usable.reshape(-1)[order]]
        used = np.zeros((H, W), bool)
        segs = []

        def angle_diff(t1, t2):
            d = t1 - t2
            return np.abs(np.arctan2(np.sin(d), np.cos(d)))

        min_size = max(int(0.04 * min(H, W)) + 5, 10)
        for flat in order:
            yx = np.unravel_index(flat, (H, W))
            if used[yx]:
                continue
            # region grow
            theta = ang[yx]
            sx = np.sin(theta)
            cx = np.cos(theta)
            region = [yx]
            used[yx] = True
            head = 0
            while head < len(region):
                y, x = region[head]
                head += 1
                for dy in (-1, 0, 1):
                    for dx in (-1, 0, 1):
                        ny, nx = y + dy, x + dx
                        if 0 <= ny < H and 0 <= nx < W and \
                                not used[ny, nx] and usable[ny, nx] and \
                                angle_diff(ang[ny, nx], theta) < prec:
                            used[ny, nx] = True
                            region.append((ny, nx))
                            # update region angle (running mean direction)
                            sx += np.sin(ang[ny, nx])
                            cx += np.cos(ang[ny, nx])
                            theta = np.arctan2(sx, cx)
            if len(region) < min_size:
                continue
            pts = np.array(region, np.float64)      # (n, 2) y, x
            w = mag[pts[:, 0].astype(int), pts[:, 1].astype(int)]
            cy, cxm = np.average(pts, axis=0, weights=w)
            d = pts - (cy, cxm)
            cov = (d * w[:, None]).T @ d / w.sum()
            evals, evecs = np.linalg.eigh(cov)
            main = evecs[:, np.argmax(evals)]        # (dy, dx)
            t = d @ main
            t0, t1 = t.min(), t.max()
            p0 = np.array([cxm, cy]) + t0 * main[::-1]
            p1 = np.array([cxm, cy]) + t1 * main[::-1]
            length = t1 - t0
            if length < 1:
                continue
            # density check (lsd.cpp refine step)
            perp = np.abs(d @ evecs[:, np.argmin(evals)])
            width = max(2 * np.percentile(perp, 95), 1.0)
            density = len(region) / (length * width)
            if density < self.density_th:
                continue
            segs.append([p0[0], p0[1], p1[0], p1[1], width])

        if not segs:
            return None, None, None, None
        segs = np.asarray(segs)
        lines = (segs[:, :4] / s).astype(np.float32).reshape(-1, 1, 4)
        widths = (segs[:, 4] / s).astype(np.float32).reshape(-1, 1)
        precs = np.full((len(segs), 1), self.ang_th / 180.0, np.float32)
        nfa = np.zeros((len(segs), 1), np.float64)
        return lines, widths, precs, nfa

    def drawSegments(self, image, lines):
        """Each segment in red, 1 px: a numpy image as the JAX package draws
        it, a tensor in place on its device (a gray one into a new BGR
        tensor)."""
        if isinstance(image, torch.Tensor):
            cv = _Canvas(torch.stack([image] * 3, -1) if image.ndim == 2 else image)
            for p in _segment_ends(lines):
                _line(cv, *p, (0, 0, 255), 1)
            return cv.done()
        img = np.asarray(image)
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        for p in _segment_ends(lines):
            draw_line(img, *p, (0, 0, 255), 1)
        return img


def _segment_ends(lines):
    """The rounded end points of each segment of `lines`."""
    if lines is None:
        return []
    return [((int(round(l[0])), int(round(l[1]))), (int(round(l[2])), int(round(l[3]))))
            for l in np.asarray(lines).reshape(-1, 4)]


def createLineSegmentDetector(refine=LSD_REFINE_STD, scale=0.8,
                              sigma_scale=0.6, quant=2.0, ang_th=22.5,
                              log_eps=0.0, density_th=0.7, n_bins=1024):
    return LineSegmentDetector(refine, scale, sigma_scale, quant, ang_th,
                               log_eps, density_th, n_bins)
