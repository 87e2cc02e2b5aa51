"""Corner responses and detectors: preCornerDetect / cornerHarris /
cornerMinEigenVal / cornerEigenValsAndVecs / goodFeaturesToTrack
(imgproc/src/corner.cpp, featureselect.cpp), twin of
``opencv_tpu/ops/corners.py``.

The covariance pipeline is Sobel dx, dy to CV_32F → the three per-pixel
products → an unnormalized box sum → the per-pixel response, all in plain
float32 torch: no kernel runs here (Sobel to CV_32F and a float boxFilter
take the float paths).

goodFeaturesToTrack is split as in the reference: the response, its
threshold, the 3×3-dilate local maxima and the border mask are device work
over the batch (`good_features_response`); the greedy min-distance grid
filter is a host loop over image 0 (`_gftt_host_tail`), like the
reference's sequential pass (featureselect.cpp:185-240).  Only the
candidates (positions and responses, a few thousand) leave the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as K
from ..core.arrays import to_batched, from_batched
from .deriv import Sobel
from .filter import boxFilter
from .morph import dilate

__all__ = ["cornerHarris", "cornerMinEigenVal", "cornerEigenValsAndVecs",
           "goodFeaturesToTrack", "goodFeaturesToTrackWithQuality",
           "good_features_response", "preCornerDetect"]


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def preCornerDetect(src, ksize: int, borderType: int = K.BORDER_DEFAULT):
    """cv::preCornerDetect (corner.cpp:672): Dx²·Dyy + Dy²·Dxx − 2·Dx·Dy·Dxy,
    scaled by 1/(2^(ksize−1)·[255])³."""
    x, meta = to_batched(src)
    s = from_batched(x, "nhwc")
    Dx = Sobel(s, K.CV_32F, 1, 0, ksize=ksize, borderType=borderType)
    Dy = Sobel(s, K.CV_32F, 0, 1, ksize=ksize, borderType=borderType)
    D2x = Sobel(s, K.CV_32F, 2, 0, ksize=ksize, borderType=borderType)
    D2y = Sobel(s, K.CV_32F, 0, 2, ksize=ksize, borderType=borderType)
    Dxy = Sobel(s, K.CV_32F, 1, 1, ksize=ksize, borderType=borderType)
    factor = float(1 << (ksize - 1))
    if x.dtype == torch.uint8:
        factor *= 255.0
    factor = 1.0 / (factor * factor * factor)
    out = (Dx * Dx * D2y + Dy * Dy * D2x - 2.0 * Dx * Dy * Dxy) * _f32(factor)
    return from_batched(out, meta)


def _corner_cov(x, blockSize: int, ksize: int, borderType: int):
    """Sobel-derivative covariance triplet (corner.cpp cornerEigenValsVecs).

    Returns (a, b, c) = box-summed (dx², dx·dy, dy²) · scale², f32 NHWC.
    """
    aperture = ksize if ksize > 0 else 3
    scale = float(1 << (aperture - 1)) * blockSize
    if x.dtype == torch.uint8:
        scale *= 255.0
    scale = 1.0 / scale

    src = from_batched(x, "nhwc")
    dx = Sobel(src, K.CV_32F, 1, 0, ksize=ksize, scale=scale, borderType=borderType)
    dy = Sobel(src, K.CV_32F, 0, 1, ksize=ksize, scale=scale, borderType=borderType)
    return [boxFilter(prod, -1, (blockSize, blockSize), normalize=False, borderType=borderType)
            for prod in (dx * dx, dx * dy, dy * dy)]


def cornerHarris(src, blockSize: int, ksize: int, k: float,
                 borderType: int = K.BORDER_DEFAULT):
    """Harris response `det(M) − k·trace(M)²` (corner.cpp:104-123)."""
    x, meta = to_batched(src)
    a, b, c = _corner_cov(x, blockSize, ksize, borderType)
    r = a * c - b * b - _f32(k) * (a + c) * (a + c)
    return from_batched(r, meta)


def cornerMinEigenVal(src, blockSize: int, ksize: int = 3,
                      borderType: int = K.BORDER_DEFAULT):
    """Smaller eigenvalue of M (corner.cpp:52-72)."""
    x, meta = to_batched(src)
    a, b, c = _corner_cov(x, blockSize, ksize, borderType)
    a = a * 0.5
    c = c * 0.5
    r = (a + c) - torch.sqrt((a - c) * (a - c) + b * b)
    return from_batched(r, meta)


def cornerEigenValsAndVecs(src, blockSize: int, ksize: int,
                           borderType: int = K.BORDER_DEFAULT):
    """(λ1, λ2, x1, y1, x2, y2) 6-channel output (corner.cpp calcEigenValsVecs)."""
    x, meta = to_batched(src)
    a, b, c = _corner_cov(x, blockSize, ksize, borderType)
    u = (a + c) * 0.5
    v = torch.sqrt(((a - c) * 0.5) ** 2 + b * b)
    l1 = u + v
    l2 = u - v

    # eigenvectors of [[a, b], [b, c]] for λ: (b, λ - a) normalized
    def evec(lam):
        vx = b
        vy = lam - a
        n = torch.sqrt(vx * vx + vy * vy)
        bad = n < 1e-12
        safe = torch.where(bad, torch.ones_like(n), n)
        nx = torch.where(bad, torch.ones_like(n), vx / safe)
        ny = torch.where(bad, torch.zeros_like(n), vy / safe)
        return nx, ny

    x1, y1 = evec(l1)
    x2, y2 = evec(l2)
    out = torch.cat([l1, l2, x1, y1, x2, y2], dim=-1)
    return from_batched(out, meta)


def good_features_response(src, maxCorners: int, qualityLevel: float,
                           blockSize: int = 3, gradientSize: int = 3,
                           useHarrisDetector: bool = False, k: float = 0.04,
                           mask=None):
    """Device part of goodFeaturesToTrack: returns (eig, nms_mask), where
    nms_mask marks strict 3×3 local maxima above qualityLevel·max
    (featureselect.cpp:366-440), excluding the 1-px image border."""
    x, _ = to_batched(src)
    if useHarrisDetector:
        eig = cornerHarris(x, blockSize, gradientSize, k)
    else:
        eig = cornerMinEigenVal(x, blockSize, gradientSize)
    if mask is not None:
        m, _ = to_batched(mask)
        eig = torch.where(m.to(eig.device) != 0, eig, -torch.inf)
    thr = eig.amax(dim=(1, 2, 3), keepdim=True) * _f32(qualityLevel)
    eig = torch.where(eig > thr, eig, 0.0)  # THRESH_TOZERO
    sel = (eig != 0) & (eig == dilate(eig))
    # exclude the 1-px border (the reference loops over 1..rows-2)
    inner = torch.zeros_like(sel)
    inner[:, 1:-1, 1:-1, :] = True
    return eig, sel & inner


def _gftt_host_tail(eig, sel, maxCorners: int, minDistance: float):
    """The host tail of goodFeaturesToTrack over image 0 of
    :func:`good_features_response`'s output: candidates by falling
    response, then the greedy min-distance grid filter.  Returns the
    corners [(x, y)] and their responses.  (The filter is a copy of
    ``opencv_tpu.ops.corners._gftt_host_tail``.)"""
    e0, s0 = eig[0, :, :, 0], sel[0, :, :, 0]
    pos = torch.nonzero(s0)
    vals = e0[pos[:, 0], pos[:, 1]].cpu().numpy()
    ys, xs = pos.cpu().numpy().T
    order = np.argsort(-vals, kind="stable")
    ys, xs, vals = ys[order], xs[order], vals[order]

    H, W = e0.shape
    if minDistance >= 1:
        cell = int(minDistance)
        gw = (W + cell - 1) // cell
        gh = (H + cell - 1) // cell
        grid = [[[] for _ in range(gw)] for _ in range(gh)]
        md2 = minDistance * minDistance
        out, qual = [], []
        for y, x, v in zip(ys.tolist(), xs.tolist(), vals.tolist()):
            gx, gy = x // cell, y // cell
            ok = True
            for yy in range(max(gy - 1, 0), min(gy + 2, gh)):
                for xx in range(max(gx - 1, 0), min(gx + 2, gw)):
                    for (py, px) in grid[yy][xx]:
                        if (px - x) ** 2 + (py - y) ** 2 < md2:
                            ok = False
                            break
                    if not ok:
                        break
                if not ok:
                    break
            if ok:
                grid[gy][gx].append((y, x))
                out.append((x, y))
                qual.append(v)
                if maxCorners > 0 and len(out) >= maxCorners:
                    break
    else:
        out = list(zip(xs.tolist(), ys.tolist()))
        qual = vals.tolist()
        if maxCorners > 0:
            out, qual = out[:maxCorners], qual[:maxCorners]
    return out, qual


def _gftt(image, maxCorners, qualityLevel, minDistance, mask, blockSize, gradientSize,
          useHarrisDetector, k):
    eig, sel = good_features_response(image, maxCorners, qualityLevel, blockSize, gradientSize,
                                      useHarrisDetector, k, mask)
    return _gftt_host_tail(eig, sel, maxCorners, minDistance)


def goodFeaturesToTrack(image, maxCorners: int, qualityLevel: float,
                        minDistance: float, mask=None, blockSize: int = 3,
                        gradientSize: int = 3, useHarrisDetector: bool = False,
                        k: float = 0.04):
    """cv2-compatible GFTT over image 0.  Returns an (N, 1, 2) float32 numpy
    array, or None when no corner is found."""
    out, _ = _gftt(image, maxCorners, qualityLevel, minDistance, mask, blockSize,
                   gradientSize, useHarrisDetector, k)
    if not out:
        return None
    return np.asarray(out, np.float32).reshape(-1, 1, 2)


def goodFeaturesToTrackWithQuality(image, maxCorners: int, qualityLevel: float,
                                   minDistance: float, mask=None, corners=None,
                                   qualityMeasure=None, blockSize: int = 3,
                                   gradientSize: int = 3, useHarrisDetector: bool = False,
                                   k: float = 0.04):
    """cv::goodFeaturesToTrack overload that also returns each corner's
    response (featureselect.cpp, quality output)."""
    out, qual = _gftt(image, maxCorners, qualityLevel, minDistance, mask, blockSize,
                      gradientSize, useHarrisDetector, k)
    if not out:
        return None, None
    return (np.asarray(out, np.float32).reshape(-1, 1, 2),
            np.asarray(qual, np.float32).reshape(-1, 1))
