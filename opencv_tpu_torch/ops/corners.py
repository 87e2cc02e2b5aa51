"""Corner responses: preCornerDetect / cornerHarris / cornerMinEigenVal /
cornerEigenValsAndVecs (imgproc/src/corner.cpp), twin of
``opencv_tpu/ops/corners.py``.

The covariance pipeline is Sobel dx, dy to CV_32F → the three per-pixel
products → an unnormalized box sum → the per-pixel response, all in plain
float32 torch: no kernel runs here (Sobel to CV_32F and a float boxFilter
take the float paths).  goodFeaturesToTrack needs ``ops/morph.dilate`` and
is not ported yet.
"""

from __future__ import annotations

import torch

from .. import constants as K
from ..core.arrays import to_batched, from_batched
from .deriv import Sobel
from .filter import boxFilter

__all__ = ["cornerHarris", "cornerMinEigenVal", "cornerEigenValsAndVecs", "preCornerDetect"]


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
