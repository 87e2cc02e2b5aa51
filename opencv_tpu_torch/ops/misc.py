"""Miscellaneous imgproc ops: getRectSubPix, matchShapes, phaseCorrelate,
createHanningWindow, convertMaps, demosaicing, blendLinear
(imgproc/src/samplers.cpp, matchcontours.cpp, phasecorr.cpp,
demosaicing.cpp, blend.cpp); twin of ``opencv_tpu/ops/misc.py``.

The per-pixel ops run on the input's device.  ``phaseCorrelate`` runs
there in f64 (the JAX package takes it on the host in numpy): the window,
the forward FFTs (``rfft2``: the cross-power spectrum of two real images is
Hermitian), the normalised cross-power spectrum with the reference's 1e-15
floor, the inverse, the argmax, the 5×5 wrapped weighted centroid and the
half-size wrap; only the two shifts and the response come back to the host,
as the cv2 API returns them.  :func:`phase_correlate_batch` correlates a
batch of pairs at once and leaves its result on the device.
``createHanningWindow`` and ``matchShapes`` keep the JAX package's host code.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as K
from ..core.arrays import as_tensor, from_batched, to_batched, to_device
from ..core.borders import pad_nhwc
from ..core.fixedpoint import saturate_cast
from .warp import INTER_BITS, INTER_TAB_SIZE, _floor_frac, _remap_linear

__all__ = ["getRectSubPix", "matchShapes", "phaseCorrelate", "phase_correlate_batch",
           "createHanningWindow", "convertMaps", "demosaicing", "blendLinear",
           "CONTOURS_MATCH_I1", "CONTOURS_MATCH_I2", "CONTOURS_MATCH_I3"]

CONTOURS_MATCH_I1 = 1
CONTOURS_MATCH_I2 = 2
CONTOURS_MATCH_I3 = 3


def getRectSubPix(image, patchSize, center, patchType=-1):
    """Bilinear sub-pixel patch extraction (samplers.cpp): the port's LINEAR
    remap under BORDER_REPLICATE, with the map built in f64 on the device.
    The patch keeps the image's depth (``patchType`` is ignored, as in the
    JAX package)."""
    x, meta = to_batched(image)
    w, h = int(patchSize[0]), int(patchSize[1])
    x0 = float(center[0]) - (w - 1) * 0.5
    y0 = float(center[1]) - (h - 1) * 0.5
    f64 = dict(dtype=torch.float64, device=x.device)
    mapx = (x0 + torch.arange(w, **f64))[None, :].expand(h, w)
    mapy = (y0 + torch.arange(h, **f64))[:, None].expand(h, w)
    xi, fx = _floor_frac(mapx)
    yi, fy = _floor_frac(mapy)
    return from_batched(_remap_linear(x, xi, fx, yi, fy, K.BORDER_REPLICATE, 0), meta)


def _polygon_hu(pts):
    """Hu moments of a point contour from its polygon moments (Green's
    theorem), as cv::moments takes them on contours."""
    from .contours import HuMoments

    pts = pts.reshape(-1, 2).astype(np.float64)
    x = pts[:, 0]
    y = pts[:, 1]
    xn = np.roll(x, -1)
    yn = np.roll(y, -1)
    a = x * yn - xn * y
    m00 = a.sum() / 2
    m10 = ((x + xn) * a).sum() / 6
    m01 = ((y + yn) * a).sum() / 6
    m20 = ((x * x + x * xn + xn * xn) * a).sum() / 12
    m02 = ((y * y + y * yn + yn * yn) * a).sum() / 12
    m11 = ((2 * x * y + x * yn + xn * y + 2 * xn * yn) * a).sum() / 24
    m30 = ((x ** 3 + x * x * xn + x * xn * xn + xn ** 3) * a).sum() / 20
    m03 = ((y ** 3 + y * y * yn + y * yn * yn + yn ** 3) * a).sum() / 20
    m21 = ((x * x * (3 * y + yn) + 2 * x * xn * (y + yn)
            + xn * xn * (y + 3 * yn)) * a).sum() / 60
    m12 = ((y * y * (3 * x + xn) + 2 * y * yn * (x + xn)
            + yn * yn * (x + 3 * xn)) * a).sum() / 60
    if m00 < 0:
        m00, m10, m01, m20, m11, m02, m30, m21, m12, m03 = [
            -v for v in (m00, m10, m01, m20, m11, m02, m30, m21, m12, m03)]
    cx, cy = m10 / m00, m01 / m00
    mu20 = m20 - m10 * cx
    mu11 = m11 - m10 * cy
    mu02 = m02 - m01 * cy
    mu30 = m30 - cx * (3 * mu20 + cx * m10)
    mu21 = m21 - cx * (2 * mu11 + cx * m01) - cy * mu20
    mu12 = m12 - cy * (2 * mu11 + cy * m10) - cx * mu02
    mu03 = m03 - cy * (3 * mu02 + cy * m01)
    md = {"mu20": mu20, "mu11": mu11, "mu02": mu02, "mu30": mu30,
          "mu21": mu21, "mu12": mu12, "mu03": mu03}
    for name in ["mu20", "mu11", "mu02"]:
        md["nu" + name[2:]] = md[name] / (m00 * m00)
    for name in ["mu30", "mu21", "mu12", "mu03"]:
        md["nu" + name[2:]] = md[name] / (m00 ** 2.5)
    return HuMoments(md).ravel()


def matchShapes(contour1, contour2, method: int, parameter: float = 0.0):
    """Hu-moment shape distance (matchcontours.cpp), on the host: a point
    contour through its polygon moments, an image through `moments`."""
    from .contours import HuMoments, _np
    from .shape import moments

    def hu_of(c):
        arr = _np(c)
        if arr.ndim >= 3 or (arr.ndim == 2 and arr.shape[1] == 2):
            return _polygon_hu(arr)
        return HuMoments(moments(c)).ravel()

    ha = hu_of(contour1)
    hb = hu_of(contour2)
    eps = 1e-5
    ma = np.where(np.abs(ha) > eps, np.sign(ha) * np.log10(np.abs(ha)), 0)
    mb = np.where(np.abs(hb) > eps, np.sign(hb) * np.log10(np.abs(hb)), 0)
    valid = (np.abs(ha) > eps) & (np.abs(hb) > eps)
    if method == CONTOURS_MATCH_I1:
        return float(np.sum(np.abs(1.0 / ma[valid] - 1.0 / mb[valid])))
    if method == CONTOURS_MATCH_I2:
        return float(np.sum(np.abs(ma[valid] - mb[valid])))
    return float(np.max(np.abs(ma[valid] - mb[valid])
                        / np.abs(ma[valid])) if valid.any() else 0.0)


def createHanningWindow(winSize, type=K.CV_32F):
    """Hanning window (phasecorr.cpp:601): sqrt of the separable product
    (the reference sqrt-s the 2-D window).  A host numpy array."""
    w, h = int(winSize[0]), int(winSize[1])
    wy = 0.5 * (1 - np.cos(2 * np.pi * np.arange(h) / (h - 1)))
    wx = 0.5 * (1 - np.cos(2 * np.pi * np.arange(w) / (w - 1)))
    return np.sqrt(np.outer(wy, wx)).astype(
        np.float32 if type == K.CV_32F else np.float64)


# the half-width of phaseCorrelate's weighted centroid (a 5×5 window)
_PEAK_R = 2


def phase_correlate_batch(src1, src2, window=None):
    """``phaseCorrelate`` of each pair of a batch, on the device in f64.

    `src1` and `src2` are (..., H, W) planes that broadcast against each
    other (one reference against a batch, say); `window` an (H, W) array or
    None.  Returns ``(shifts, response)``: an (..., 2) f64 tensor of cv2's
    (x, y) shifts of src2 against src1 and the (...,) peak values of the
    correlation surface, both left on the device."""
    a = as_tensor(src1)
    b = to_device(as_tensor(src2), a.device)
    a, b = a.to(torch.float64), b.to(torch.float64)
    H, W = a.shape[-2:]
    if window is not None:
        wnd = to_device(as_tensor(window), a.device).to(torch.float64)
        a, b = a * wnd, b * wnd
    P = torch.fft.rfft2(a) * torch.fft.rfft2(b).conj()
    C = torch.fft.irfft2(P / P.abs().clamp_min(1e-15), s=(H, W))
    del P
    batch = C.shape[:-2]
    flat = C.reshape(-1, H * W)
    resp, peak = flat.max(dim=1)
    py, px = peak // W, peak % W
    offs = torch.arange(-_PEAK_R, _PEAK_R + 1, device=C.device)
    ys = (py[:, None] + offs) % H
    xs = (px[:, None] + offs) % W
    patch = flat.gather(1, (ys[:, :, None] * W + xs[:, None, :]).reshape(len(flat), -1))
    patch = patch.reshape(-1, len(offs), len(offs)).clamp_min(0)
    total = patch.sum(dim=(1, 2))
    offs = offs.to(torch.float64)
    safe = torch.where(total > 0, total, 1.0)
    dy = torch.where(total > 0, (patch.sum(dim=2) * offs).sum(dim=1) / safe, 0.0)
    dx = torch.where(total > 0, (patch.sum(dim=1) * offs).sum(dim=1) / safe, 0.0)
    sy = py.to(torch.float64) + dy
    sx = px.to(torch.float64) + dx
    sy = torch.where(sy > H / 2, sy - H, sy)
    sx = torch.where(sx > W / 2, sx - W, sx)
    shifts = torch.stack([-sx, -sy], dim=-1)
    return shifts.reshape(*batch, 2), resp.reshape(batch)


def phaseCorrelate(src1, src2, window=None):
    """Translation estimation via the normalised cross-power spectrum
    (phasecorr.cpp) with the 5×5 weighted-centroid sub-pixel peak: returns
    ``((x, y), response)`` as Python floats (one read from the device)."""
    shifts, resp = phase_correlate_batch(src1, src2, window)
    host = torch.cat([shifts.reshape(2), resp.reshape(1)]).cpu().tolist()
    return (host[0], host[1]), host[2]


def convertMaps(map1, map2, dstmap1type, nninterpolation=False):
    """Float maps → CV_16SC2 (+CV_16UC1 Q5 fractions), imgwarp.cpp:1713, on
    the maps' device."""
    mx = as_tensor(map1).to(torch.float32)
    my = to_device(as_tensor(map2), mx.device).to(torch.float32)
    if nninterpolation:
        return torch.stack([torch.round(mx), torch.round(my)], dim=-1).to(torch.int16), None
    X = torch.round(mx * INTER_TAB_SIZE).to(torch.int64)
    Y = torch.round(my * INTER_TAB_SIZE).to(torch.int64)
    m1 = torch.stack([X >> INTER_BITS, Y >> INTER_BITS], dim=-1)
    m1 = m1.clamp(-32768, 32767).to(torch.int16)
    m2 = ((Y & (INTER_TAB_SIZE - 1)) * INTER_TAB_SIZE
          + (X & (INTER_TAB_SIZE - 1))).to(torch.uint16)
    return m1, m2

# (row, column) parity of the red sites per code.  Matched to the reference
# by the JAX package: BayerBG2BGR has R at (0, 0), the enum naming the
# second row's pattern.
_RED_SITE = {K.COLOR_BayerBG2BGR: (0, 0), K.COLOR_BayerGB2BGR: (0, 1),
             K.COLOR_BayerRG2BGR: (1, 1), K.COLOR_BayerGR2BGR: (1, 0)}


def demosaicing(src, code: int, dstCn: int = 0):
    """Bilinear Bayer demosaicing (demosaicing.cpp Bayer2BGR_, the
    default non-VNG path): green averaged from 4 neighbors, R/B from
    2 or 4 diagonal neighbors, with the reference's descale rounding.
    Codes other than the four BayerXX2BGR (and their RGB aliases) take the
    BayerGR parity, as in the JAX package."""
    x, meta = to_batched(src)
    N, H, W = x.shape[:3]
    p = pad_nhwc(x[..., :1].to(torch.int32), 1, 1, 1, 1, K.BORDER_REFLECT_101)[..., 0]

    def at(dy, dx):
        return p[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

    c = at(0, 0)
    h2 = (at(0, -1) + at(0, 1) + 1) >> 1
    v2 = (at(-1, 0) + at(1, 0) + 1) >> 1
    x4 = (at(-1, -1) + at(-1, 1) + at(1, -1) + at(1, 1) + 2) >> 2
    p4 = (at(0, -1) + at(0, 1) + at(-1, 0) + at(1, 0) + 2) >> 2

    ry, rx = _RED_SITE.get(code, (1, 0))
    ys = (torch.arange(H, device=x.device) % 2)[:, None]
    xs = (torch.arange(W, device=x.device) % 2)[None, :]
    is_r = (ys == ry) & (xs == rx)
    is_b = (ys == 1 - ry) & (xs == 1 - rx)
    g_row_r = ys == ry  # green pixels on red rows
    R = torch.where(is_r, c, torch.where(is_b, x4, torch.where(g_row_r, h2, v2)))
    B = torch.where(is_b, c, torch.where(is_r, x4, torch.where(g_row_r, v2, h2)))
    G = torch.where(is_r | is_b, p4, c)
    out = torch.stack([B, G, R], dim=-1)
    # the reference fills the one-pixel frame by copying the adjacent
    # computed row/column (demosaicing.cpp border handling) — rows first,
    # then columns (covers the corners)
    out[:, 0] = out[:, 1]
    out[:, H - 1] = out[:, H - 2]
    out[:, :, 0] = out[:, :, 1]
    out[:, :, W - 1] = out[:, :, W - 2]
    return from_batched(saturate_cast(out, x.dtype), meta)


def blendLinear(src1, src2, weights1, weights2):
    """`cv::blendLinear` (blend.cpp) in f32, one op at a time."""
    a, meta = to_batched(src1)
    b, _ = to_batched(src2)
    w1 = to_device(to_batched(weights1)[0], a.device).to(torch.float32)
    w2 = to_device(to_batched(weights2)[0], a.device).to(torch.float32)
    num = a.to(torch.float32) * w1 + to_device(b, a.device).to(torch.float32) * w2
    # blend.cpp adds 1e-5f to the denominator (not a clamp)
    out = num / (w1 + w2 + 1e-5)
    return from_batched(saturate_cast(out, a.dtype), meta)
