"""cvtColor — color space conversions (twin of ``opencv_tpu/ops/color.py``).

Every code of the JAX package's registry, and its Bayer codes, in plain
PyTorch on both devices (the JAX package has no Pallas kernel here).
Integer paths keep the reference's Q-format fixed-point arithmetic in int32
(int64 where OpenCV's own intermediates are 64-bit), so 8/16-bit outputs are
bit-exact:

- Gray: Q15 coefficients ``RY15=9798, GY15=19235, BY15=3735`` (sum exactly
  2^15) with ``CV_DESCALE`` rounding (`imgproc/src/color.simd_helpers.hpp:16,22-24`).
- YCrCb / YUV: Q14 coefficient sets from `color_yuv.simd.hpp`.
- XYZ: Q12 coefficients from `color_rgb.simd.hpp` (sRGB D65 matrix).
- HSV 8U: the reference's Q12 hue and saturation division tables, taken
  arithmetically (``rint(a / d) == (2a + d) // 2d``, exact for these
  denominators), so 16-bit input takes the same formula.
- Lab/Luv 8U: the reference's fixed-point/LUT pipelines over the
  softfloat-built tables in ``lab_luts.npz`` (a copy of the JAX package's
  file); Luv2RGBinteger's 48-bit intermediates are int64 here.
- 565/555 packing, YUV 4:2:0 / 4:2:2 (BT.601 studio swing, Q20 and Q14).
- Bayer codes go to :func:`..ops.misc.demosaicing`, as in `cv::cvtColor`.

Float paths divide by device tensors, never by host scalars: CUDA turns a
division by a host scalar into a product with its reciprocal, and torch's
``scalar / tensor`` is a reciprocal times the scalar, so either would leave
the card and the CPU an ulp apart.

The dispatcher mirrors `cv::cvtColor`'s switch (`imgproc/src/color.cpp:192`)
as a registry keyed on the public COLOR_* codes.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import constants as K
from ..core.arrays import as_tensor, from_batched, to_batched
from ..core.fixedpoint import alpha_max, descale, saturate_cast
from ..utils.trace import region

__all__ = ["cvtColor", "cvtColorTwoPlane"]

# Q14 coefficients, used by the YCrCb/YUV family (color.simd_helpers.hpp:19-21)
R2Y, G2Y, B2Y = 4899, 9617, 1868
YUV_SHIFT = 14
# Q15 gray coefficients, sum == 2^15 exactly (color.simd_helpers.hpp:16,22-24)
RY15, GY15, BY15 = 9798, 19235, 3735
GRAY_SHIFT = 15
# float gray coefficients (color.hpp)
R2YF, G2YF, B2YF = 0.299, 0.587, 0.114

_REGISTRY = {}
# host tables copied to a device, by (name, device); see _device_table
_DEVICE_TABLES: dict = {}


def _register(*codes):
    def deco(fn):
        for c in codes:
            _REGISTRY[c] = fn
        return fn
    return deco


def _is_int(x):
    return not x.is_floating_point()


def _c(v, like):
    """A 0-dim tensor of `like`'s dtype and device: the divisor (or the
    numerator over a tensor) of a float division, see the module docstring.
    Filled on the device: a copy from the host would wait for the queue."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


def _fill(x, value):
    return torch.full((*x.shape[:-1], 1), value, dtype=x.dtype, device=x.device)


def _stack_saturated(planes, dtype):
    """``saturate_cast(torch.stack(planes, -1), dtype)``, with each plane
    narrowed before the stack: interleaving int32 planes costs four times
    the bytes of interleaving u8 ones."""
    return torch.stack([saturate_cast(p, dtype) for p in planes], dim=-1)


def _bgr_order(b, g, r, bidx):
    """The three planes in memory order: B first when bidx == 0, R first
    when bidx == 2."""
    return [b, g, r] if bidx == 0 else [r, g, b]


# ------------------------------------------------------------ RGB family

@_register(K.COLOR_BGR2BGRA)
def _bgr2bgra(x):
    return torch.cat([x[..., :3], _fill(x, alpha_max(x.dtype))], dim=-1)


@_register(K.COLOR_BGRA2BGR)
def _bgra2bgr(x):
    return x[..., :3]


@_register(K.COLOR_BGR2RGBA)
def _bgr2rgba(x):
    return torch.cat([x[..., [2, 1, 0]], _fill(x, alpha_max(x.dtype))], dim=-1)


@_register(K.COLOR_RGBA2BGR)
def _rgba2bgr(x):
    return x[..., [2, 1, 0]]


def _reversed(x):
    # an index, not torch.flip, which has no uint16 CPU kernel
    return x[..., list(range(x.shape[-1] - 1, -1, -1))]


@_register(K.COLOR_BGR2RGB)
def _bgr2rgb(x):
    return _reversed(x)


@_register(K.COLOR_BGRA2RGBA)
def _bgra2rgba(x):
    return x[..., [2, 1, 0, 3]] if x.shape[-1] == 4 else _reversed(x)


# the depths cv2's gray conversion takes (CvtHelper's VDepth = Set<CV_8U,
# CV_16U, CV_32F>, color.simd_helpers.hpp:94); the JAX package takes any
_GRAY_DTYPES = (torch.uint8, torch.uint16, torch.float32)


def _rgb_to_gray(x, r, g, b):
    if x.dtype not in _GRAY_DTYPES:
        raise ValueError(f"cvtColor to gray takes uint8, uint16 or float32 input, as cv2 does; "
                         f"got {x.dtype}")
    if _is_int(x):
        xi = x.to(torch.int32)
        y = descale(xi[..., r] * RY15 + xi[..., g] * GY15 + xi[..., b] * BY15, GRAY_SHIFT)
        return y[..., None].to(x.dtype)
    y = x[..., r] * R2YF + x[..., g] * G2YF + x[..., b] * B2YF
    return y[..., None]


@_register(K.COLOR_BGR2GRAY, K.COLOR_BGRA2GRAY)
def _bgr2gray(x):
    return _rgb_to_gray(x, 2, 1, 0)


@_register(K.COLOR_RGB2GRAY, K.COLOR_RGBA2GRAY)
def _rgb2gray(x):
    return _rgb_to_gray(x, 0, 1, 2)


@_register(K.COLOR_GRAY2BGR)
def _gray2bgr(x):
    return x[..., :1].expand(*x.shape[:-1], 3).contiguous()


@_register(K.COLOR_GRAY2BGRA)
def _gray2bgra(x):
    return torch.cat([x[..., :1].expand(*x.shape[:-1], 3), _fill(x, alpha_max(x.dtype))], dim=-1)


# -------------------------------------------------------- YCrCb / YUV

# color_yuv.simd.hpp coefficient sets (Q14)
_YCRCB_COEFFS_I = (R2Y, G2Y, B2Y, 11682, 9241)   # R2Y,G2Y,B2Y, Cr, Cb
_YCRCB_COEFFS_F = (R2YF, G2YF, B2YF, 0.713, 0.564)
_YCRCB2RGB_I = (22987, -11698, -5636, 29049)      # Cr→R, Cr→G, Cb→G, Cb→B
_YCRCB2RGB_F = (1.403, -0.714, -0.344, 1.773)
_YUV_COEFFS_I = (R2Y, G2Y, B2Y, 14369, 8061)      # V=(R-Y)*0.877, U=(B-Y)*0.492
_YUV_COEFFS_F = (R2YF, G2YF, B2YF, 0.877, 0.492)
_YUV2RGB_I = (18678, -9519, -6472, 33292)         # V2R, V2G, U2G, U2B (Q14)
_YUV2RGB_F = (1.140, -0.581, -0.395, 2.032)


def _rgb2ycrcb(x, bidx, coeffs_i, coeffs_f, yuv_order=False):
    """yuv_order: True → (Y,U,V)=(Y,Cb,Cr) channel order (BGR2YUV)."""
    if _is_int(x):
        xi = x.to(torch.int32)
        r, g, b = xi[..., 2 - bidx], xi[..., 1], xi[..., bidx]
        C0, C1, C2, C3, C4 = coeffs_i
        # delta = ColorChannel<T>::half() << shift (color_yuv.simd.hpp:237)
        half = (128 if x.dtype == torch.uint8 else 32768) << YUV_SHIFT
        y = descale(r * C0 + g * C1 + b * C2, YUV_SHIFT)
        cr = descale((r - y) * C3 + half, YUV_SHIFT)
        cb = descale((b - y) * C4 + half, YUV_SHIFT)
        chans = [y, cb, cr] if yuv_order else [y, cr, cb]
        return _stack_saturated(chans, x.dtype)
    r, g, b = x[..., 2 - bidx], x[..., 1], x[..., bidx]
    C0, C1, C2, C3, C4 = coeffs_f
    y = r * C0 + g * C1 + b * C2
    cr = (r - y) * C3 + 0.5
    cb = (b - y) * C4 + 0.5
    chans = [y, cb, cr] if yuv_order else [y, cr, cb]
    return torch.stack(chans, dim=-1)


def _ycrcb2rgb(x, bidx, coeffs_i, coeffs_f, yuv_order=False):
    if _is_int(x):
        xi = x.to(torch.int32)
        y = xi[..., 0]
        cb, cr = (xi[..., 1], xi[..., 2]) if yuv_order else (xi[..., 2], xi[..., 1])
        C0, C1, C2, C3 = coeffs_i
        delta = {torch.uint8: 128, torch.uint16: 32768}.get(x.dtype, 0)
        b = y + descale((cb - delta) * C3, YUV_SHIFT)
        g = y + descale((cb - delta) * C2 + (cr - delta) * C1, YUV_SHIFT)
        r = y + descale((cr - delta) * C0, YUV_SHIFT)
        return _stack_saturated(_bgr_order(b, g, r, bidx), x.dtype)
    y = x[..., 0]
    cb, cr = (x[..., 1], x[..., 2]) if yuv_order else (x[..., 2], x[..., 1])
    C0, C1, C2, C3 = coeffs_f
    b = y + (cb - 0.5) * C3
    g = y + (cb - 0.5) * C2 + (cr - 0.5) * C1
    r = y + (cr - 0.5) * C0
    return torch.stack(_bgr_order(b, g, r, bidx), dim=-1)


for _code, _bidx, _fwd, _ci, _cf, _yuv in [
    (K.COLOR_BGR2YCrCb, 0, True, _YCRCB_COEFFS_I, _YCRCB_COEFFS_F, False),
    (K.COLOR_RGB2YCrCb, 2, True, _YCRCB_COEFFS_I, _YCRCB_COEFFS_F, False),
    (K.COLOR_YCrCb2BGR, 0, False, _YCRCB2RGB_I, _YCRCB2RGB_F, False),
    (K.COLOR_YCrCb2RGB, 2, False, _YCRCB2RGB_I, _YCRCB2RGB_F, False),
    (K.COLOR_BGR2YUV, 0, True, _YUV_COEFFS_I, _YUV_COEFFS_F, True),
    (K.COLOR_RGB2YUV, 2, True, _YUV_COEFFS_I, _YUV_COEFFS_F, True),
    (K.COLOR_YUV2BGR, 0, False, _YUV2RGB_I, _YUV2RGB_F, True),
    (K.COLOR_YUV2RGB, 2, False, _YUV2RGB_I, _YUV2RGB_F, True),
]:
    def _mk_ycc(bidx=_bidx, fwd=_fwd, ci=_ci, cf=_cf, yuv=_yuv):
        fn = _rgb2ycrcb if fwd else _ycrcb2rgb
        return lambda x: fn(x, bidx, ci, cf, yuv_order=yuv)
    _REGISTRY[_code] = _mk_ycc()


# ---------------------------------------------------------------- XYZ

_XYZ_SHIFT = 12
# sRGB D65 (color_rgb: Q12), rows X,Y,Z × cols R,G,B
_RGB2XYZ_I = ((1689, 1465, 739), (871, 2929, 296), (79, 488, 3892))
_RGB2XYZ_F = ((0.412453, 0.357580, 0.180423), (0.212671, 0.715160, 0.072169),
              (0.019334, 0.119193, 0.950227))
# rows R,G,B × cols X,Y,Z
_XYZ2RGB_I = ((13273, -6296, -2042), (-3970, 7684, 170), (228, -836, 4331))
_XYZ2RGB_F = ((3.240479, -1.53715, -0.498535), (-0.969256, 1.875991, 0.041556),
              (0.055648, -0.204043, 1.057311))


def _mat3(c0, c1, c2, M, shift):
    """The three rows of M applied to (c0, c1, c2): descaled int32 sums when
    `shift` is set, float sums otherwise."""
    if shift:
        return [descale(c0 * m0 + c1 * m1 + c2 * m2, shift) for m0, m1, m2 in M]
    return [c0 * m0 + c1 * m1 + c2 * m2 for m0, m1, m2 in M]


def _rgb2xyz(x, bidx):
    if _is_int(x):
        xi = x.to(torch.int32)
        out = _mat3(xi[..., 2 - bidx], xi[..., 1], xi[..., bidx], _RGB2XYZ_I, _XYZ_SHIFT)
        return _stack_saturated(out, x.dtype)
    return torch.stack(_mat3(x[..., 2 - bidx], x[..., 1], x[..., bidx], _RGB2XYZ_F, 0), dim=-1)


def _xyz2rgb(x, bidx):
    if _is_int(x):
        xi = x.to(torch.int32)
        r, g, b = _mat3(xi[..., 0], xi[..., 1], xi[..., 2], _XYZ2RGB_I, _XYZ_SHIFT)
        return _stack_saturated(_bgr_order(b, g, r, bidx), x.dtype)
    r, g, b = _mat3(x[..., 0], x[..., 1], x[..., 2], _XYZ2RGB_F, 0)
    return torch.stack(_bgr_order(b, g, r, bidx), dim=-1)


_REGISTRY[K.COLOR_BGR2XYZ] = lambda x: _rgb2xyz(x, 0)
_REGISTRY[K.COLOR_RGB2XYZ] = lambda x: _rgb2xyz(x, 2)
_REGISTRY[K.COLOR_XYZ2BGR] = lambda x: _xyz2rgb(x, 0)
_REGISTRY[K.COLOR_XYZ2RGB] = lambda x: _xyz2rgb(x, 2)


# ----------------------------------------------------------- HSV / HLS

# hue division scale, Q12 (color_hsv.simd.hpp:63-77)
_HSV_SHIFT = 12
_F32_EPS = float(np.finfo(np.float32).eps)

# sector → (b, g, r) tab indices (HSV2RGB_native, color_hsv.simd.hpp:440)
_SECTOR_DATA = ((1, 3, 0), (1, 0, 2), (3, 0, 1), (0, 2, 1), (0, 1, 3), (2, 1, 0))


def _rgb2hsv(x, bidx, hrange):
    if _is_int(x):
        xi = x.to(torch.int32)
        b, g, r = xi[..., bidx], xi[..., 1], xi[..., 2 - bidx]
        v = torch.maximum(torch.maximum(b, g), r)
        diff = v - torch.minimum(torch.minimum(b, g), r)
        # the reference's sdiv/hdiv tables, rint(a / den) taken as
        # (2a + den) // (2 den): exact, as no quotient lands on a half
        vs = v.clamp(min=1)
        sdiv = torch.where(v > 0, (2 * (255 << _HSV_SHIFT) + vs) // (2 * vs), 0)
        ds = diff.clamp(min=1)
        if hrange == 180:
            hdiv = (2 * (30 << _HSV_SHIFT) + ds) // (2 * ds)
        else:
            hdiv = (2 * (256 << _HSV_SHIFT) + 6 * ds) // (12 * ds)
        hdiv = torch.where(diff > 0, hdiv, 0)
        s = (diff * sdiv + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
        h0 = torch.where(v == r, g - b, torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
        h = (h0 * hdiv + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
        h = torch.where(h < 0, h + hrange, h)
        return _stack_saturated([h, s, v], x.dtype)
    b, g, r = x[..., bidx], x[..., 1], x[..., 2 - bidx]
    v = torch.maximum(torch.maximum(b, g), r)
    diff = v - torch.minimum(torch.minimum(b, g), r)
    s = diff / (v.abs() + _F32_EPS)
    d60 = _c(60.0, x) / (diff + _F32_EPS)
    h = torch.where(v == r, (g - b) * d60,
                    torch.where(v == g, (b - r) * d60 + 120.0, (r - g) * d60 + 240.0))
    h = torch.where(h < 0, h + 360.0, h)
    return torch.stack([h * float(np.float32(hrange / 360.0)), s, v], dim=-1)


def _sector_select(sec, tabs):
    """(b, g, r) from the 6-sector table: tabs[_SECTOR_DATA[sec][ch]]."""
    t = torch.stack(tabs, dim=-1)
    idx = _take(_device_table("sector", _SECTOR_DATA, sec.device), sec)
    return t.gather(-1, idx).unbind(-1)


def _sector(h, hscale):
    hh = h * float(np.float32(hscale))
    sector = torch.floor(hh)
    return sector.to(torch.int32) % 6, hh - sector


def _hsv2rgb_native(h, s, v, hscale):
    """HSV2RGB_native (color_hsv.simd.hpp:430): float sector math."""
    sec, frac = _sector(h, hscale)
    tabs = [v, v * (1.0 - s), v * (1.0 - s * frac), v * (1.0 - s * (1.0 - frac))]
    gray = s == 0
    return [torch.where(gray, v, c) for c in _sector_select(sec, tabs)]


def _rgb2hls_f(b, g, r, hscale):
    vmax = torch.maximum(torch.maximum(b, g), r)
    vmin = torch.minimum(torch.minimum(b, g), r)
    diff = vmax - vmin
    lum = (vmax + vmin) * 0.5
    big = diff > _F32_EPS
    safe_diff = torch.where(big, diff, 1.0)
    s = torch.where(lum < 0.5, diff / (vmax + vmin), diff / (2.0 - vmax - vmin))
    d60 = _c(60.0, diff) / safe_diff
    h = torch.where(vmax == r, (g - b) * d60,
                    torch.where(vmax == g, (b - r) * d60 + 120.0, (r - g) * d60 + 240.0))
    h = torch.where(h < 0, h + 360.0, h)
    h = torch.where(big, h, 0.0)
    s = torch.where(big, s, 0.0)
    return h * float(np.float32(hscale)), lum, s


def _hls2rgb_native(h, lum, s, hscale):
    p2 = torch.where(lum <= 0.5, lum * (1.0 + s), lum + s - lum * s)
    p1 = 2.0 * lum - p2
    sec, frac = _sector(h, hscale)
    tabs = [p2, p1, p1 + (p2 - p1) * (1.0 - frac), p1 + (p2 - p1) * frac]
    gray = s == 0
    return [torch.where(gray, lum, c) for c in _sector_select(sec, tabs)]


_INV255 = float(np.float32(1.0 / 255.0))


def _rgb2hls(x, bidx, hrange):
    if _is_int(x):
        xf = x.to(torch.float32) * _INV255
        h, lum, s = _rgb2hls_f(xf[..., bidx], xf[..., 1], xf[..., 2 - bidx], hrange / 360.0)
        return _stack_saturated([h, lum * 255.0, s * 255.0], x.dtype)
    h, lum, s = _rgb2hls_f(x[..., bidx], x[..., 1], x[..., 2 - bidx], hrange / 360.0)
    return torch.stack([h, lum, s], dim=-1)


def _inverse(native):
    """HSV2RGB / HLS2RGB from their native float sector math."""

    def conv(x, bidx, hrange):
        if _is_int(x):
            xf = x.to(torch.float32)
            b, g, r = native(xf[..., 0], xf[..., 1] * _INV255, xf[..., 2] * _INV255, 6.0 / hrange)
            return _stack_saturated([c * 255.0 for c in _bgr_order(b, g, r, bidx)], x.dtype)
        b, g, r = native(x[..., 0], x[..., 1], x[..., 2], 6.0 / hrange)
        return torch.stack(_bgr_order(b, g, r, bidx), dim=-1)

    return conv


_hsv2rgb = _inverse(_hsv2rgb_native)
_hls2rgb = _inverse(_hls2rgb_native)


def _hrange(x, full):
    """Hue range: 180 or 256 (forward) / 255 (inverse, ``"inv"``) for
    integer input, as color.cpp's dispatch sets it; 360 for float."""
    if not _is_int(x):
        return 360
    return {False: 180, True: 256, "inv": 255}[full]


for _code, _bidx, _full, _fn in [
    (K.COLOR_BGR2HSV, 0, False, _rgb2hsv), (K.COLOR_RGB2HSV, 2, False, _rgb2hsv),
    (K.COLOR_BGR2HSV_FULL, 0, True, _rgb2hsv), (K.COLOR_RGB2HSV_FULL, 2, True, _rgb2hsv),
    (K.COLOR_HSV2BGR, 0, False, _hsv2rgb), (K.COLOR_HSV2RGB, 2, False, _hsv2rgb),
    (K.COLOR_HSV2BGR_FULL, 0, "inv", _hsv2rgb), (K.COLOR_HSV2RGB_FULL, 2, "inv", _hsv2rgb),
    (K.COLOR_BGR2HLS, 0, False, _rgb2hls), (K.COLOR_RGB2HLS, 2, False, _rgb2hls),
    (K.COLOR_BGR2HLS_FULL, 0, True, _rgb2hls), (K.COLOR_RGB2HLS_FULL, 2, True, _rgb2hls),
    (K.COLOR_HLS2BGR, 0, False, _hls2rgb), (K.COLOR_HLS2RGB, 2, False, _hls2rgb),
    (K.COLOR_HLS2BGR_FULL, 0, "inv", _hls2rgb), (K.COLOR_HLS2RGB_FULL, 2, "inv", _hls2rgb),
]:
    def _mk_hsv(bidx=_bidx, full=_full, fn=_fn):
        return lambda x: fn(x, bidx, _hrange(x, full))
    _REGISTRY[_code] = _mk_hsv()


# ------------------------------------------------------------ Lab / Luv

# sRGB D65 (color_lab.cpp:100-115)
_LAB_XYZ = np.array(_RGB2XYZ_F)
_D65 = np.array([0.950456, 1.0, 1.088754])
_LAB_M = (_LAB_XYZ / _D65[:, None]).tolist()
_LAB_MI = np.linalg.inv(_LAB_XYZ / _D65[:, None]).tolist()
_LUV_MI = np.linalg.inv(_LAB_XYZ).tolist()
_UN = float(4 * _D65[0] / (_D65[0] + 15 * _D65[1] + 3 * _D65[2]))
_VN = float(9 * _D65[1] / (_D65[0] + 15 * _D65[1] + 3 * _D65[2]))
_LAB_THR = 0.008856451679035631


def _srgb_inv_gamma(x):
    return torch.where(x <= 0.04045, x / _c(12.92, x), torch.pow((x + 0.055) / _c(1.055, x), 2.4))


def _srgb_gamma(x):
    return torch.where(x <= 0.0031308, x * 12.92,
                       1.055 * torch.pow(x.clamp(min=1e-12), 1.0 / 2.4) - 0.055)


def _cbrt(t):
    return torch.sign(t) * t.abs().pow(1.0 / 3.0)


def _f_lab(t):
    # CIE f(): cbrt above (6/29)^3, linear below (color_lab.cpp splineCbrt)
    return torch.where(t > _LAB_THR, _cbrt(t), t * 7.787068965517241 + 16.0 / 116.0)


def _lightness(Y):
    return torch.where(Y > _LAB_THR, 116.0 * _cbrt(Y) - 16.0, 903.3 * Y)


def _linear_rgb(x, bidx, srgb):
    b, g, r = x[..., bidx], x[..., 1], x[..., 2 - bidx]
    if srgb:
        r, g, b = _srgb_inv_gamma(r), _srgb_inv_gamma(g), _srgb_inv_gamma(b)
    return r, g, b


def _rgb2lab_f(x, bidx, srgb=True):
    """Analytic Lab (the reference uses spline-interpolated gamma/cbrt
    tables — documented tolerance ~1e-3 on L)."""
    X, Y, Z = _mat3(*_linear_rgb(x, bidx, srgb), _LAB_M, 0)
    fx, fy, fz = _f_lab(X), _f_lab(Y), _f_lab(Z)
    return _lightness(Y), 500.0 * (fx - fy), 200.0 * (fy - fz)


def _to_rgb(X, Y, Z, Mi, bidx, srgb):
    r, g, b = _mat3(X, Y, Z, Mi, 0)
    if srgb:
        r, g, b = _srgb_gamma(r), _srgb_gamma(g), _srgb_gamma(b)
    return torch.stack(_bgr_order(b, g, r, bidx), dim=-1)


def _lab2rgb_f(L, a, bb, bidx, srgb=True):
    fy = (L + 16.0) / _c(116.0, L)
    fx = fy + a / _c(500.0, L)
    fz = fy - bb / _c(200.0, L)

    def finv(t):
        return torch.where(t > 6.0 / 29.0, t * t * t,
                           (t - 16.0 / 116.0) / _c(7.787068965517241, t))

    Y = torch.where(L > 8.0, fy * fy * fy, L / _c(903.3, L))
    return _to_rgb(finv(fx), Y, finv(fz), _LAB_MI, bidx, srgb)


def _rgb2luv_f(x, bidx, srgb=True):
    X, Y, Z = _mat3(*_linear_rgb(x, bidx, srgb), _LAB_XYZ.tolist(), 0)
    L = _lightness(Y)
    d = X + 15.0 * Y + 3.0 * Z
    dn = torch.where(d != 0, _c(1.0, d) / d, 0.0)
    return L, 13.0 * L * (4.0 * X * dn - _UN), 13.0 * L * (9.0 * Y * dn - _VN)


def _luv2rgb_f(L, u, v, bidx, srgb=True):
    Y = torch.where(L > 8.0, ((L + 16.0) / _c(116.0, L)) ** 3, L / _c(903.3, L))
    L13 = 13.0 * L.clamp(min=1e-12)
    up = u / L13 + _UN
    vp = v / L13 + _VN
    vp_safe = torch.where(vp != 0, vp, 1.0)
    X = 2.25 * Y * up / vp_safe
    Z = Y * (3.0 - 0.75 * up - 5.0 * vp) / vp_safe
    return _to_rgb(X, Y, Z, _LUV_MI, bidx, srgb)


# --- bit-exact u8 Lab/Luv: the reference's fixed-point/LUT pipelines -----
# (color_lab.cpp: RGB2Lab_b :1573, Lab2RGBinteger :2399, RGB2Luvinterpolate
# :3276, Luv2RGBinteger :3556).  The tables are platform-independent
# softfloat-built constants, a copy of the JAX package's lab_luts.npz.

_LAB_LUTS_PATH = os.path.join(os.path.dirname(__file__), "lab_luts.npz")
_LAB_LUTS = None

_LAB_SHIFT, _LAB_SHIFT2, _INVG_SHIFT = 12, 15, 12
_LAB_BASE = 1 << 14


def _lab_luts() -> dict:
    """The host tables of ``lab_luts.npz``, loaded once."""
    global _LAB_LUTS
    if _LAB_LUTS is None:
        with np.load(_LAB_LUTS_PATH) as z:
            _LAB_LUTS = {k: z[k] for k in z.files}
    return _LAB_LUTS


def _lut(name: str, device) -> torch.Tensor:
    """Table `name` of ``lab_luts.npz`` as a flat device tensor (int32;
    LvToVpl_b int64; the 33^3 trilinear LUTs as (33^3, 3))."""
    a = _lab_luts()[name]
    a = a.reshape(-1, 3) if name.endswith("LUT") else a.reshape(-1)
    return _device_table(name, a.astype(np.int64 if a.dtype == np.int64 else np.int32), device)


def _device_table(name: str, table, device) -> torch.Tensor:
    """The host table `table` on `device`, copied there once per device: a
    copy from pageable host memory waits for the queue."""
    key = (name, str(device))
    t = _DEVICE_TABLES.get(key)
    if t is None:
        t = _DEVICE_TABLES[key] = torch.from_numpy(np.asarray(table)).to(device)
    return t


def _take(tab, idx):
    """tab[idx] for an int index tensor of any shape (rows of a 2-D tab)."""
    return tab.index_select(0, idx.reshape(-1)).reshape(*idx.shape, *tab.shape[1:])


def _require_u8(x, what):
    if x.dtype != torch.uint8:
        raise ValueError(f"cvtColor {what} takes uint8 or float32 input, as cv2 does; "
                         f"got {x.dtype}")


def _rgb2lab_u8(x, bidx, srgb):
    dev = x.device
    xi = x.to(torch.int32)
    gamma = _lut("sRGBGammaTab_b" if srgb else "linearGammaTab_b", dev)
    B, G, R = (_take(gamma, xi[..., i]) for i in (bidx, 1, 2 - bidx))
    C = _lab_luts()["lab_fwd_coeffs"].tolist()          # rows X/Y/Z
    cbrt = _lut("LabCbrtTab_b", dev)
    fX, fY, fZ = (_take(cbrt, descale(R * c0 + G * c1 + B * c2, _LAB_SHIFT)) for c0, c1, c2 in C)
    lscale = (116 * 255 + 50) // 100
    lshift = -((16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100)
    Lo = descale(lscale * fY + lshift, _LAB_SHIFT2)
    ao = descale(500 * (fX - fY) + (128 << _LAB_SHIFT2), _LAB_SHIFT2)
    bo = descale(200 * (fY - fZ) + (128 << _LAB_SHIFT2), _LAB_SHIFT2)
    return _stack_saturated([Lo, ao, bo], torch.uint8)


def _inv_gamma_store(ro, go, bo, bidx, srgb):
    inv = _lut("sRGBInvGammaTab_b", ro.device) if srgb else None
    res = []
    for v in _bgr_order(bo, go, ro, bidx):
        v = v.clamp(0, (1 << _INVG_SHIFT) - 1)
        v = _take(inv, v) if srgb else ((v << 8) - v) >> _INVG_SHIFT
        res.append(v)
    return _stack_saturated(res, torch.uint8)


def _xyz_to_rgb_u8(xx, y, zz, coeffs, bidx, srgb):
    sh = _LAB_SHIFT + (14 - _INVG_SHIFT)
    ro, go, bo = _mat3(xx, y, zz, _lab_luts()[coeffs].tolist(), sh)
    return _inv_gamma_store(ro, go, bo, bidx, srgb)


def _lab2rgb_u8(x, bidx, srgb):
    dev = x.device
    xi = x.to(torch.int32)
    LL, aa, bb = xi[..., 0], xi[..., 1], xi[..., 2]
    yf = _lut("LabToYF_b", dev)
    y, ify = _take(yf, 2 * LL), _take(yf, 2 * LL + 1)
    adiv = ((5 * aa * 53687 + (1 << 7)) >> 13) - 128 * _LAB_BASE // 500
    bdiv = ((bb * 41943 + (1 << 4)) >> 9) - 128 * _LAB_BASE // 200 + 1
    ab = _lut("abToXZ_b", dev)
    min_ab = -8145
    xx = _take(ab, ify + adiv - min_ab)
    zz = _take(ab, ify - bdiv - min_ab)
    return _xyz_to_rgb_u8(xx, y, zz, "lab_inv_coeffs", bidx, srgb)


def _trilinear_lut(cx, cy, cz, lut):
    """trilinearInterpolate (color_lab.cpp:1352): coords in [0, LAB_BASE],
    cube origin at >>9, 16-step weights, CV_DESCALE by 12."""
    tx, ty, tz = cx >> 9, cy >> 9, cz >> 9           # cube origin, 0..32
    xw, yw, zw = (cx >> 5) & 15, (cy >> 5) & 15, (cz >> 5) & 15
    acc = 0
    for dp in (0, 1):
        wx = xw if dp else 16 - xw
        for dq in (0, 1):
            wy = yw if dq else 16 - yw
            for dr in (0, 1):
                wz = zw if dr else 16 - zw
                idx = ((tz + dr).clamp(max=32) * (33 * 33) + (ty + dq).clamp(max=32) * 33
                       + (tx + dp).clamp(max=32))
                acc = acc + _take(lut, idx) * (wx * wy * wz)[..., None]
    return descale(acc, 12)


def _rgb2luv_u8(x, bidx):
    """Trilinear interpolation over the 33^3 LUT (RGB2Luvinterpolate)."""
    xi = x.to(torch.int32)
    base_div = _LAB_BASE // 256                      # 64
    out = _trilinear_lut(xi[..., bidx] * base_div, xi[..., 1] * base_div,
                         xi[..., 2 - bidx] * base_div, _lut("RGB2LuvLUT", x.device))
    out = out >> 6                    # values >= 0: shift == trunc division
    return out.clamp(0, 255).to(torch.uint8)


def _rgb2lab_f32_interp(x, bidx):
    """f32 sRGB RGB2Lab: the reference's interpolated path (RGB2Lab_f,
    color_lab.cpp:2037-2050) — cvRound to the LAB_BASE grid, the same
    trilinear 33^3 LUT as u8 Luv, float rescale.  Bit-exact."""
    c = [torch.round(x[..., i].clamp(0.0, 1.0) * float(_LAB_BASE)).to(torch.int32)
         for i in (bidx, 1, 2 - bidx)]
    iv = _trilinear_lut(*c, _lut("RGB2LabLUT", x.device)).to(torch.float32)
    inv = 1.0 / _LAB_BASE               # exact power of two
    L = (iv[..., 0] * inv) * 100.0
    a = (iv[..., 1] * inv) * 256.0 - 128.0
    bb = (iv[..., 2] * inv) * 256.0 - 128.0
    return torch.stack([L, a, bb], dim=-1)


def _luv2rgb_u8(x, bidx, srgb):
    """Luv2RGBinteger with its 64-bit intermediates in int64; C++'s integer
    division truncates toward zero."""
    dev = x.device
    xi = x.to(torch.int64)
    LL, uu, vv = xi[..., 0], xi[..., 1], xi[..., 2]
    base = _LAB_BASE

    def tdiv(a, d):
        return torch.div(a, d, rounding_mode="trunc")

    y = _take(_lut("LabToYF_b", dev), 2 * LL).to(torch.int64)
    up = _take(_lut("LuToUp_b", dev), LL * 256 + uu).to(torch.int64)
    vp = _take(_lut("LvToVp_b", dev), LL * 256 + vv).to(torch.int64)
    xv = up * vp
    xo = tdiv(y * tdiv(xv, base), base)
    vpl = _take(_lut("LvToVpl_b", dev), LL * 256 + vv)
    zp = tdiv(vpl - xv * (255 // 3), base)
    zq = zp - 5 * 255 * base
    zm = tdiv(y * zq, base)
    zo = tdiv(zm, 256) + tdiv(zm, 65536)
    xo = xo.clamp(0, 2 * base)
    zo = zo.clamp(0, 2 * base)
    return _xyz_to_rgb_u8(xo, y, zo, "luv_inv_coeffs", bidx, srgb)


def _lab_fwd(x, bidx, kind, srgb=True):
    if _is_int(x):
        _require_u8(x, "to Lab/Luv")
        if kind == "lab":
            return _rgb2lab_u8(x, bidx, srgb)
        if srgb:
            return _rgb2luv_u8(x, bidx)
        # LRGB2Luv u8: the reference uses its float path here
        # (RGB2Luv_b:3415, interpolation disabled for linear RGB).
        L, A, B = _rgb2luv_f(x.to(torch.float32) * _INV255, bidx, srgb)
        return _stack_saturated([L * (255.0 / 100.0), (A + 134.0) * (255.0 / 354.0),
                                 (B + 140.0) * (255.0 / 262.0)], x.dtype)
    if kind == "lab" and srgb:
        return _rgb2lab_f32_interp(x, bidx)
    fwd = _rgb2lab_f if kind == "lab" else _rgb2luv_f
    return torch.stack(fwd(x, bidx, srgb), dim=-1).to(torch.float32)


def _lab_inv(x, bidx, kind, srgb=True):
    if _is_int(x):
        _require_u8(x, "from Lab/Luv")
        return (_lab2rgb_u8 if kind == "lab" else _luv2rgb_u8)(x, bidx, srgb)
    inv = _lab2rgb_f if kind == "lab" else _luv2rgb_f
    return inv(x[..., 0], x[..., 1], x[..., 2], bidx, srgb).to(torch.float32)


for _code, _bidx, _kind, _dir, _srgb in [
    (K.COLOR_BGR2Lab, 0, "lab", "fwd", True), (K.COLOR_RGB2Lab, 2, "lab", "fwd", True),
    (K.COLOR_Lab2BGR, 0, "lab", "inv", True), (K.COLOR_Lab2RGB, 2, "lab", "inv", True),
    (K.COLOR_BGR2Luv, 0, "luv", "fwd", True), (K.COLOR_RGB2Luv, 2, "luv", "fwd", True),
    (K.COLOR_Luv2BGR, 0, "luv", "inv", True), (K.COLOR_Luv2RGB, 2, "luv", "inv", True),
    (K.COLOR_LBGR2Lab, 0, "lab", "fwd", False), (K.COLOR_LRGB2Lab, 2, "lab", "fwd", False),
    (K.COLOR_Lab2LBGR, 0, "lab", "inv", False), (K.COLOR_Lab2LRGB, 2, "lab", "inv", False),
    (K.COLOR_LBGR2Luv, 0, "luv", "fwd", False), (K.COLOR_LRGB2Luv, 2, "luv", "fwd", False),
    (K.COLOR_Luv2LBGR, 0, "luv", "inv", False), (K.COLOR_Luv2LRGB, 2, "luv", "inv", False),
]:
    def _mk_lab(bidx=_bidx, kind=_kind, dirn=_dir, srgb=_srgb):
        fn = _lab_fwd if dirn == "fwd" else _lab_inv
        return lambda x: fn(x, bidx, kind, srgb)
    _REGISTRY[_code] = _mk_lab()


# ------------------------------------------------ packed 16-bit RGB (5x5)
# RGB2RGB5x5 / RGB5x52RGB (imgproc/src/color_rgb.simd.hpp): the packed
# pixel is a little-endian uint16 carried as CV_8UC2.

def _pack16(v):
    return torch.stack([v & 255, (v >> 8) & 255], dim=-1).to(torch.uint8)


def _unpack16(x):
    xi = x.to(torch.int32)
    return xi[..., 0] | (xi[..., 1] << 8)


def _to565(x, bidx):
    xi = x.to(torch.int32)
    b, g, r = xi[..., bidx], xi[..., 1], xi[..., 2 - bidx]
    return _pack16((b >> 3) | ((g & ~3) << 3) | ((r & ~7) << 8))


def _to555(x, bidx):
    xi = x.to(torch.int32)
    b, g, r = xi[..., bidx], xi[..., 1], xi[..., 2 - bidx]
    v = (b >> 3) | ((g & ~7) << 2) | ((r & ~7) << 7)
    if x.shape[-1] == 4:  # alpha -> bit 15 (set iff alpha != 0)
        v = v | torch.where(xi[..., 3] != 0, 0x8000, 0)
    return _pack16(v)


def _from5x5(x, bidx, acn, green555):
    v = _unpack16(x)
    b = (v << 3) & 0xF8
    g = ((v >> 2) & 0xF8) if green555 else ((v >> 3) & 0xFC)
    r = ((v >> 7) & 0xF8) if green555 else ((v >> 8) & 0xF8)
    ch = _bgr_order(b, g, r, bidx)
    if acn == 4:  # 565: opaque; 555: alpha from bit 15
        ch.append(torch.where((v & 0x8000) != 0, 255, 0) if green555 else torch.full_like(b, 255))
    return torch.stack(ch, dim=-1).to(torch.uint8)


for _code, _fn in [
    (K.COLOR_BGR2BGR565, lambda x: _to565(x, 0)), (K.COLOR_RGB2BGR565, lambda x: _to565(x, 2)),
    (K.COLOR_BGRA2BGR565, lambda x: _to565(x, 0)), (K.COLOR_RGBA2BGR565, lambda x: _to565(x, 2)),
    (K.COLOR_BGR2BGR555, lambda x: _to555(x, 0)), (K.COLOR_RGB2BGR555, lambda x: _to555(x, 2)),
    (K.COLOR_BGRA2BGR555, lambda x: _to555(x, 0)), (K.COLOR_RGBA2BGR555, lambda x: _to555(x, 2)),
    (K.COLOR_BGR5652BGR, lambda x: _from5x5(x, 0, 3, False)),
    (K.COLOR_BGR5652RGB, lambda x: _from5x5(x, 2, 3, False)),
    (K.COLOR_BGR5652BGRA, lambda x: _from5x5(x, 0, 4, False)),
    (K.COLOR_BGR5652RGBA, lambda x: _from5x5(x, 2, 4, False)),
    (K.COLOR_BGR5552BGR, lambda x: _from5x5(x, 0, 3, True)),
    (K.COLOR_BGR5552RGB, lambda x: _from5x5(x, 2, 3, True)),
    (K.COLOR_BGR5552BGRA, lambda x: _from5x5(x, 0, 4, True)),
    (K.COLOR_BGR5552RGBA, lambda x: _from5x5(x, 2, 4, True)),
]:
    _REGISTRY[_code] = _fn


@_register(K.COLOR_GRAY2BGR565)
def _gray2bgr565(x):
    t = x[..., 0].to(torch.int32)
    return _pack16((t >> 3) | ((t & ~3) << 3) | ((t & ~7) << 8))


@_register(K.COLOR_GRAY2BGR555)
def _gray2bgr555(x):
    t = x[..., 0].to(torch.int32)
    return _pack16((t >> 3) | ((t & ~7) << 2) | ((t & ~7) << 7))


def _bgr5x52gray(x, green555):
    y = _from5x5(x, 0, 3, green555).to(torch.int32)
    t = descale(y[..., 0] * BY15 + y[..., 1] * GY15 + y[..., 2] * RY15, GRAY_SHIFT)
    return t[..., None].to(torch.uint8)


_REGISTRY[K.COLOR_BGR5652GRAY] = lambda x: _bgr5x52gray(x, False)
_REGISTRY[K.COLOR_BGR5552GRAY] = lambda x: _bgr5x52gray(x, True)


# ---------------------------------------------- YUV 4:2:0 / 4:2:2 families
# ITU-R BT.601 studio-swing integer path (imgproc/src/color_yuv.simd.hpp,
# "ITUR_BT_601" constants): decode is Q20, encode to 4:2:0 is Q20, encode
# to packed 4:2:2 is Q14 with pair-summed chroma.  All products fit int32.

_ITUR_CY, _ITUR_CUB, _ITUR_CUG = 1220542, 2116026, -409993
_ITUR_CVG, _ITUR_CVR, _ITUR_SHIFT = -852492, 1673527, 20
# encoder (RGB -> YUV420): Q20
_ITUR_CRY, _ITUR_CGY, _ITUR_CBY = 269484, 528482, 102760
_ITUR_CRU, _ITUR_CGU, _ITUR_CBU = -155188, -305135, 460324
_ITUR_CGV, _ITUR_CBV = -385875, -74448
# RGB -> packed 4:2:2: Q14 (color_yuv.simd.hpp:1862-1881)
_R2Y422, _G2Y422, _B2Y422 = 4211, 8258, 1606
_R2U422, _G2U422, _B2U422 = -1212, -2384, 3596
_G2V422, _B2V422 = -3015, -582


def _yuv_to_rgb(Y, U, V, bidx, acn, shape):
    """Shared BT.601 decode.  Y is u8 at full resolution, split into its
    chroma blocks; U and V are u8 at chroma resolution with size-1 axes that
    broadcast over each block, so the chroma terms are taken once per block.
    Returns `shape` + (acn,) u8."""
    half = 1 << (_ITUR_SHIFT - 1)
    u = U.to(torch.int32) - 128
    v = V.to(torch.int32) - 128
    ruv = _ITUR_CVR * v + half
    guv = _ITUR_CVG * v + _ITUR_CUG * u + half
    buv = _ITUR_CUB * u + half
    y = (Y.to(torch.int32) - 16).clamp_(min=0).mul_(_ITUR_CY)
    out = torch.empty((*y.shape, acn), dtype=torch.uint8, device=y.device)
    for c, t in enumerate(_bgr_order(buv, guv, ruv, bidx)):
        out[..., c] = ((y + t) >> _ITUR_SHIFT).clamp_(0, 255)
    if acn == 4:
        out[..., 3] = 255
    return out.reshape(*shape, acn)


def _decode420(Y, U, V, bidx, acn):
    """Y (N, H, W) and U, V (N, H/2, W/2) u8 → (N, H, W, acn) u8."""
    N, H, W = Y.shape
    Yb = Y.reshape(N, H // 2, 2, W // 2, 2)
    Ub, Vb = (c.reshape(N, H // 2, 1, W // 2, 1) for c in (U, V))
    return _yuv_to_rgb(Yb, Ub, Vb, bidx, acn, (N, H, W))


def _split420(x, uidx, planar):
    """(N, H*3/2, W, 1) u8 → Y (N, H, W) and U, V (N, H/2, W/2)."""
    N, Hs, W = x.shape[:3]
    H = Hs * 2 // 3
    Y = x[:, :H, :, 0]
    chroma = x[:, H:, :, 0]
    if planar:  # I420 / YV12: quarter planes stacked
        a = chroma[:, : H // 4].reshape(N, H // 2, W // 2)
        q = chroma[:, H // 4:].reshape(N, H // 2, W // 2)
        U, V = (a, q) if uidx == 0 else (q, a)
    else:  # NV12 / NV21: interleaved rows
        uv = chroma.reshape(N, H // 2, W // 2, 2)
        U, V = uv[..., uidx], uv[..., 1 - uidx]
    return Y, U, V


# (uidx, bidx, acn) of the semi-planar codes, which cvtColorTwoPlane takes too
_NV_CODES = {
    K.COLOR_YUV2RGB_NV12: (0, 2, 3), K.COLOR_YUV2BGR_NV12: (0, 0, 3),
    K.COLOR_YUV2RGB_NV21: (1, 2, 3), K.COLOR_YUV2BGR_NV21: (1, 0, 3),
    K.COLOR_YUV2RGBA_NV12: (0, 2, 4), K.COLOR_YUV2BGRA_NV12: (0, 0, 4),
    K.COLOR_YUV2RGBA_NV21: (1, 2, 4), K.COLOR_YUV2BGRA_NV21: (1, 0, 4),
}

for _code, _uidx, _planar, _bidx, _acn in [
    *((c, u, False, b, a) for c, (u, b, a) in _NV_CODES.items()),
    (K.COLOR_YUV2RGB_IYUV, 0, True, 2, 3), (K.COLOR_YUV2BGR_IYUV, 0, True, 0, 3),
    (K.COLOR_YUV2RGB_YV12, 1, True, 2, 3), (K.COLOR_YUV2BGR_YV12, 1, True, 0, 3),
    (K.COLOR_YUV2RGBA_IYUV, 0, True, 2, 4), (K.COLOR_YUV2BGRA_IYUV, 0, True, 0, 4),
    (K.COLOR_YUV2RGBA_YV12, 1, True, 2, 4), (K.COLOR_YUV2BGRA_YV12, 1, True, 0, 4),
]:
    def _mk420(uidx=_uidx, planar=_planar, bidx=_bidx, acn=_acn):
        return lambda x: _decode420(*_split420(x, uidx, planar), bidx, acn)
    _REGISTRY[_code] = _mk420()


@_register(K.COLOR_YUV2GRAY_420)
def _yuv2gray420(x):
    return x[:, : x.shape[1] * 2 // 3]


def _decode422(x, yidx, uidx, bidx, acn):
    """(N, H, W, 2) packed 4:2:2 → (N, H, W, acn) u8.  Layouts: YUY2 y=0,
    u=1, v=3; YVYU y=0, u=3, v=1; UYVY y=1, u=0, v=2."""
    N, H, W = x.shape[:3]
    quad = x.reshape(N, H, W // 2, 4)
    vidx = (3 if uidx == 1 else 1) if yidx == 0 else 2
    Y = quad[..., [yidx, yidx + 2]]
    return _yuv_to_rgb(Y, quad[..., uidx:uidx + 1], quad[..., vidx:vidx + 1], bidx, acn,
                       (N, H, W))


for _code, _yidx, _uidx, _bidx, _acn in [
    (K.COLOR_YUV2RGB_YUY2, 0, 1, 2, 3), (K.COLOR_YUV2BGR_YUY2, 0, 1, 0, 3),
    (K.COLOR_YUV2RGB_YVYU, 0, 3, 2, 3), (K.COLOR_YUV2BGR_YVYU, 0, 3, 0, 3),
    (K.COLOR_YUV2RGB_UYVY, 1, 0, 2, 3), (K.COLOR_YUV2BGR_UYVY, 1, 0, 0, 3),
    (K.COLOR_YUV2RGBA_YUY2, 0, 1, 2, 4), (K.COLOR_YUV2BGRA_YUY2, 0, 1, 0, 4),
    (K.COLOR_YUV2RGBA_YVYU, 0, 3, 2, 4), (K.COLOR_YUV2BGRA_YVYU, 0, 3, 0, 4),
    (K.COLOR_YUV2RGBA_UYVY, 1, 0, 2, 4), (K.COLOR_YUV2BGRA_UYVY, 1, 0, 0, 4),
]:
    def _mk422(yidx=_yidx, uidx=_uidx, bidx=_bidx, acn=_acn):
        return lambda x: _decode422(x, yidx, uidx, bidx, acn)
    _REGISTRY[_code] = _mk422()


_REGISTRY[K.COLOR_YUV2GRAY_YUY2] = lambda x: x[..., 0:1]
_REGISTRY[K.COLOR_YUV2GRAY_UYVY] = lambda x: x[..., 1:2]


def _rgb_to_yuv420(x, bidx, vfirst):
    """(N, H, W, C) u8 → (N, H*3/2, W, 1) planar I420 (or YV12)."""
    N, H, W = x.shape[:3]
    xi = x.to(torch.int32)
    b, g, r = xi[..., bidx], xi[..., 1], xi[..., 2 - bidx]
    sh, half = _ITUR_SHIFT, 1 << (_ITUR_SHIFT - 1)
    y = (_ITUR_CRY * r + _ITUR_CGY * g + _ITUR_CBY * b + half + (16 << sh)) >> sh
    # chroma from the top-left pixel of each 2x2 block
    r2, g2, b2 = r[:, ::2, ::2], g[:, ::2, ::2], b[:, ::2, ::2]
    u = (_ITUR_CRU * r2 + _ITUR_CGU * g2 + _ITUR_CBU * b2 + half + (128 << sh)) >> sh
    v = (_ITUR_CBU * r2 + _ITUR_CGV * g2 + _ITUR_CBV * b2 + half + (128 << sh)) >> sh
    u = u.clamp(0, 255).reshape(N, H // 4, W)
    v = v.clamp(0, 255).reshape(N, H // 4, W)
    if vfirst:
        u, v = v, u
    return torch.cat([y.clamp(0, 255), u, v], dim=1).to(torch.uint8)[..., None]


for _code, _bidx, _vfirst in [
    (K.COLOR_RGB2YUV_I420, 2, False), (K.COLOR_BGR2YUV_I420, 0, False),
    (K.COLOR_RGBA2YUV_I420, 2, False), (K.COLOR_BGRA2YUV_I420, 0, False),
    (K.COLOR_RGB2YUV_YV12, 2, True), (K.COLOR_BGR2YUV_YV12, 0, True),
    (K.COLOR_RGBA2YUV_YV12, 2, True), (K.COLOR_BGRA2YUV_YV12, 0, True),
]:
    def _mkenc420(bidx=_bidx, vfirst=_vfirst):
        return lambda x: _rgb_to_yuv420(x, bidx, vfirst)
    _REGISTRY[_code] = _mkenc420()


def _rgb_to_yuv422(x, bidx, yidx, uidx):
    """(N, H, W, C) u8 → (N, H, W, 2) packed 4:2:2 (Q14 encoder)."""
    N, H, W = x.shape[:3]
    xi = x.to(torch.int32)
    b, g, r = xi[..., bidx], xi[..., 1], xi[..., 2 - bidx]
    sh = 14
    half = 1 << (sh - 1)
    y = (_R2Y422 * r + _G2Y422 * g + _B2Y422 * b + (16 << sh) + half) >> sh
    sr, sg, sb = (c[:, :, ::2] + c[:, :, 1::2] for c in (r, g, b))
    u = (_R2U422 * sr + _G2U422 * sg + _B2U422 * sb + (half * 256) + half) >> sh
    v = (_B2U422 * sr + _G2V422 * sg + _B2V422 * sb + (half * 256) + half) >> sh
    y, u, v = y.clamp(0, 255), u.clamp(0, 255), v.clamp(0, 255)
    vidx = (3 if uidx == 1 else 1) if yidx == 0 else 2
    quad = [None] * 4
    quad[yidx], quad[yidx + 2], quad[uidx], quad[vidx] = y[:, :, ::2], y[:, :, 1::2], u, v
    return torch.stack(quad, dim=-1).reshape(N, H, W, 2).to(torch.uint8)


for _code, _yidx, _uidx, _bidx in [
    (K.COLOR_RGB2YUV_YUY2, 0, 1, 2), (K.COLOR_BGR2YUV_YUY2, 0, 1, 0),
    (K.COLOR_RGBA2YUV_YUY2, 0, 1, 2), (K.COLOR_BGRA2YUV_YUY2, 0, 1, 0),
    (K.COLOR_RGB2YUV_YVYU, 0, 3, 2), (K.COLOR_BGR2YUV_YVYU, 0, 3, 0),
    (K.COLOR_RGBA2YUV_YVYU, 0, 3, 2), (K.COLOR_BGRA2YUV_YVYU, 0, 3, 0),
    (K.COLOR_RGB2YUV_UYVY, 1, 0, 2), (K.COLOR_BGR2YUV_UYVY, 1, 0, 0),
    (K.COLOR_RGBA2YUV_UYVY, 1, 0, 2), (K.COLOR_BGRA2YUV_UYVY, 1, 0, 0),
]:
    def _mkenc422(yidx=_yidx, uidx=_uidx, bidx=_bidx):
        return lambda x: _rgb_to_yuv422(x, bidx, yidx, uidx)
    _REGISTRY[_code] = _mkenc422()


# --------------------------------------------------------------- public

@region("cvtColor")
def cvtColor(src, code: int, dstCn: int = 0):
    """Convert an image (or NHWC batch) between color spaces.

    Mirrors `cv::cvtColor` (imgproc/src/color.cpp:192).  Codes outside the
    registry (the Bayer VNG/EA/GRAY/BGRA variants among them) raise
    ``NotImplementedError``, as in the JAX package."""
    if K.COLOR_BayerBG2BGR <= code <= K.COLOR_BayerGR2BGR:
        # the Bayer family goes to the demosaicing engine, as in the
        # reference's cvtColor switch (color.cpp demosaicing cases)
        from .misc import demosaicing
        return demosaicing(src, code, dstCn)
    try:
        fn = _REGISTRY[code]
    except KeyError:
        raise NotImplementedError(f"cvtColor code {code} is not implemented "
                                  "(opencv_tpu does not serve it either)") from None
    x, meta = to_batched(src)
    return from_batched(fn(x), meta)


def cvtColorTwoPlane(ysrc, uvsrc, code: int):
    """`cv::cvtColorTwoPlane` — NV12/NV21 semi-planar YUV 4:2:0 given as a
    Y plane and an interleaved UV plane.

    Takes a single image, Y (H, W) and UV (H/2, W/2, 2), as cv2 does, and,
    beyond cv2 and ``opencv_tpu``, a batch: Y (N, H, W) and UV
    (N, H/2, W/2, 2), as a hardware decoder hands frames over.  Image by
    image the result equals the JAX package's, which joins the planes on the
    host; here they stay on their device and are decoded as they lie.
    Returns (H, W, C) or (N, H, W, C) u8; `code` is one of the eight
    YUV2{BGR,RGB}{,A}_{NV12,NV21} codes, as cv2 requires."""
    if code not in _NV_CODES:
        raise ValueError(f"cvtColorTwoPlane takes the NV12/NV21 codes, got {code}")
    y, uv = as_tensor(ysrc), as_tensor(uvsrc)
    single = y.ndim == 2
    if single:
        y = y[None]
    if y.ndim != 3 or y.dtype != torch.uint8 or uv.dtype != torch.uint8:
        raise ValueError(f"cvtColorTwoPlane: Y (H, W) or (N, H, W) and UV u8 expected, got "
                         f"{tuple(y.shape)} {y.dtype} and {tuple(uv.shape)} {uv.dtype}")
    N, H, W = y.shape
    if H % 2 or W % 2 or uv.numel() != N * H * W // 2:
        raise ValueError(f"cvtColorTwoPlane: UV {tuple(uv.shape)} does not fit Y "
                         f"{tuple(y.shape)}")
    uv = uv.reshape(N, H // 2, W // 2, 2)
    uidx, bidx, acn = _NV_CODES[code]
    out = _decode420(y, uv[..., uidx], uv[..., 1 - uidx], bidx, acn)
    return out[0] if single else out
