"""Filtering family: GaussianBlur, sepFilter2D, filter2D, blur/boxFilter,
sqrBoxFilter, and the Gaussian kernel builders (twin of
``opencv_tpu/ops/filter.py``).

Bit-exact contracts reproduced:

- Gaussian kernels are generated on the host in IEEE double like the
  reference's softdouble path (`smooth.dispatch.cpp:81`
  `getGaussianKernelBitExact`) and quantized to Q8 with error-diffusion
  rounding and exact-sum center correction (`smooth.dispatch.cpp:224-258`).
- The u8 apply is the separable Q8·Q8 MAC in int32 with a single final
  round `(v + 2^15) >> 16` and saturation: the ``sep_filter_u8`` CUDA kernel
  for a CUDA tensor, its plain version otherwise.
- Other dtypes: a separable float32 correlation in plain torch.
- Auto kernel size: `cvRound(sigma*(depth==8U?3:4)*2+1) | 1`.
- sepFilter2D u8 → u8/16S with integer or Q8-representable taps, and
  boxFilter u8 with a centred anchor, take the ``sep_filter_int`` kernel
  (exact int32 MAC, shift, delta, f32 scale, saturate).
- filter2D accumulates in float like the reference (±1 on integer outputs):
  a shifted-window MAC below the DFT crossover, ``torch.fft.rfft2`` at or
  above it.  No cuDNN convolution: it runs f32 in TF32 on the card.

Where the TPU package maps ``CV_64F`` to float32, this port computes and
returns real float64.  A non-centred anchor raises NotImplementedError in
sepFilter2D and in boxFilter's float path (the JAX package ignores it
there).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import constants as K
from ..core.arrays import dtype_name, to_batched, from_batched
from ..core.borders import pad_nhwc
from ..core.dispatch import lookup
from ..core.fixedpoint import saturate_cast
from ..utils.trace import region

__all__ = ["getGaussianKernel", "GaussianBlur", "sepFilter2D", "filter2D", "blur",
           "boxFilter", "sqrBoxFilter"]


# --------------------------------------------------------------------------
# Kernel generation (host, numpy float64 == IEEE double == softdouble);
# copies of opencv_tpu/ops/filter.py:56-134
# --------------------------------------------------------------------------

def _fma(a, b, c):
    try:
        return math.fma(a, b, c)
    except AttributeError:  # pragma: no cover - python < 3.13
        return a * b + c


def gaussian_kernel_bitexact(n: int, sigma: float) -> np.ndarray:
    """Float64 Gaussian kernel, replicating `getGaussianKernelBitExact`
    (smooth.dispatch.cpp:81).  softdouble is bit-exact IEEE-754 double, so
    host float64 reproduces it."""
    if sigma <= 0:
        if n == 1:
            return np.array([1.0])
        if n == 3:
            return np.array([0.25, 0.5, 0.25])
        if n == 5:
            return np.array([0.0625, 0.25, 0.375, 0.25, 0.0625])
        if n == 7:
            return np.array([0.03125, 0.109375, 0.21875, 0.28125,
                             0.21875, 0.109375, 0.03125])
        if n == 9:
            return np.array([4, 13, 30, 51, 60, 51, 30, 13, 4]) / 256.0
    sigma_x = float(sigma) if sigma > 0 else _fma(float(n), 0.15, 0.35)
    scale2x = -0.125 / (sigma_x * sigma_x)
    n2 = (n - 1) // 2
    vals = np.empty(n2, np.float64)
    s = 0.0
    x = 1 - n
    for i in range(n2):
        t = math.exp(float(x * x) * scale2x)
        vals[i] = t
        s += t
        x += 2
    s *= 2.0
    s += 1.0
    if n % 2 == 0:
        s += 1.0
    mul1 = 1.0 / s
    out = np.empty(n, np.float64)
    for i in range(n2):
        out[i] = out[n - 1 - i] = vals[i] * mul1
    out[n2] = mul1
    if n % 2 == 0:
        out[n2 + 1] = mul1
    return out


def gaussian_kernel_fixedpoint_ed(kernel: np.ndarray, fraction_bits: int) -> np.ndarray:
    """Error-diffusion fixed-point quantization with exact-sum center
    correction (`getGaussianKernelFixedPoint_ED`, smooth.dispatch.cpp:224)."""
    n = len(kernel)
    assert n % 2 == 1
    mult = 1 << fraction_bits
    out = np.zeros(n, np.int64)
    n2 = n // 2
    err = 0.0
    total = 0
    for i in range(n2):
        adj = kernel[i] * mult + err
        v0 = int(np.rint(adj))  # cvRound == round-half-even
        err = adj - v0
        out[i] = out[n - 1 - i] = v0
        total += v0
    out[n2] = mult - 2 * total
    return out


def getGaussianKernel(ksize: int, sigma: float, ktype=np.float64):
    """cv2-compatible `getGaussianKernel` — returns an (n, 1) numpy array."""
    k = gaussian_kernel_bitexact(ksize, sigma)
    dt = np.dtype(ktype) if not isinstance(ktype, int) else (
        np.float32 if ktype == K.CV_32F else np.float64)
    return k.astype(dt).reshape(-1, 1)


def _auto_ksize(sigma: float, depth_is_8u: bool) -> int:
    mult = 3 if depth_is_8u else 4
    return int(np.rint(sigma * mult * 2 + 1)) | 1


# --------------------------------------------------------------------------
# float correlation cores (plain torch)
# --------------------------------------------------------------------------

def _sep_correlate_float(x, kx, ky, border_type, border_value=0, dtype=torch.float32):
    """Separable correlate in `dtype`, taps applied left to right as
    ``opencv_tpu/ops/filter.py::_sep_correlate_float``."""
    kw, kh = len(kx), len(ky)
    ax, ay = kw // 2, kh // 2
    xf = pad_nhwc(x, ay, kh - 1 - ay, ax, kw - 1 - ax, border_type,
                  border_value).to(dtype)
    N, H, W, C = x.shape
    h = None
    for i, c in enumerate(kx):
        term = xf[:, :, i:i + W, :] * torch.tensor(float(c), dtype=dtype)
        h = term if h is None else h + term
    v = None
    for j, c in enumerate(ky):
        term = h[:, j:j + H, :, :] * torch.tensor(float(c), dtype=dtype)
        v = term if v is None else v + term
    return v


def _anchor(anchor, kw: int, kh: int):
    return (kw // 2 if anchor[0] < 0 else anchor[0],
            kh // 2 if anchor[1] < 0 else anchor[1])


def _correlate2d_mac(x, kernel, anchor, border_type, dtype):
    """Dense 2-D correlation as kh·kw shifted-window multiply-adds in
    `dtype`, row-major over the taps.  (The JAX package's lax.conv; on the
    card a cuDNN convolution would run f32 in TF32.)"""
    kh, kw = kernel.shape
    ax, ay = _anchor(anchor, kw, kh)
    xp = pad_nhwc(x, ay, kh - 1 - ay, ax, kw - 1 - ax, border_type).to(dtype)
    H, W = x.shape[1], x.shape[2]
    acc = None
    for i in range(kh):
        for j in range(kw):
            term = xp[:, i:i + H, j:j + W, :] * torch.tensor(float(kernel[i, j]), dtype=dtype)
            acc = term if acc is None else acc + term
    return acc


def _correlate2d_fft(x, kernel, anchor, border_type, dtype):
    """Dense 2-D correlation via rfft2 for large kernels (`dftFilter2D`,
    filter.dispatch.cpp:1274).  The border is applied spatially first, so
    the circular wrap of the FFT never touches real data."""
    kh, kw = kernel.shape
    ax, ay = _anchor(anchor, kw, kh)
    xf = pad_nhwc(x, ay, kh - 1 - ay, ax, kw - 1 - ax, border_type).to(dtype)
    N, Hp, Wp, C = xf.shape
    H, W = x.shape[1], x.shape[2]
    kpad = np.zeros((Hp, Wp), np.float64)
    kpad[:kh, :kw] = kernel
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    Kf = torch.from_numpy(np.conj(np.fft.rfft2(kpad))).to(cdtype).to(x.device)
    Xf = torch.fft.rfft2(xf, dim=(1, 2))
    out = torch.fft.irfft2(Xf * Kf[None, :, :, None], s=(Hp, Wp), dim=(1, 2))
    return out[:, :H, :W, :]


# --------------------------------------------------------------------------
# GaussianBlur
# --------------------------------------------------------------------------

@region("GaussianBlur")
def GaussianBlur(src, ksize, sigmaX: float, sigmaY: float = 0.0,
                 borderType: int = K.BORDER_DEFAULT,
                 hint: int = K.ALGO_HINT_DEFAULT):
    """Gaussian smoothing, mirroring `cv::GaussianBlur`
    (imgproc/src/smooth.dispatch.cpp:609).

    u8 inputs take the bit-exact Q8 fixed-point path (default hint); other
    dtypes use separable filtering in float32, or in float64 for a float64
    input (the JAX package filters that in float32 too).
    """
    # imported here, not at the top: kernels.fused_preproc imports this module
    from ..kernels.sepfilter import sep_filter_int_plain

    x, meta = to_batched(src)
    kw, kh = (ksize if ksize is not None else (0, 0))
    if sigmaY <= 0:
        sigmaY = sigmaX
    is_8u = x.dtype == torch.uint8
    if kw <= 0 and sigmaX > 0:
        kw = _auto_ksize(sigmaX, is_8u)
    if kh <= 0 and sigmaY > 0:
        kh = _auto_ksize(sigmaY, is_8u)
    if not (kw > 0 and kw % 2 == 1 and kh > 0 and kh % 2 == 1):
        raise ValueError(f"invalid ksize {(kw, kh)}")
    sigmaX = max(sigmaX, 0.0)
    sigmaY = max(sigmaY, 0.0)

    kxf = gaussian_kernel_bitexact(kw, sigmaX)
    kyf = (kxf if (kh == kw and abs(sigmaX - sigmaY) <= np.finfo(np.float64).eps)
           else gaussian_kernel_bitexact(kh, sigmaY))

    if is_8u and hint in (K.ALGO_HINT_DEFAULT, K.ALGO_HINT_ACCURATE):
        bits = 8
        kx = gaussian_kernel_fixedpoint_ed(kxf, bits)
        ky = (kx if kyf is kxf else gaussian_kernel_fixedpoint_ed(kyf, bits))
        # dispatch ladder (CALL_HAL analogue): the CUDA kernel for a CUDA
        # tensor that its predicate takes, else the plain version
        kern = lookup("sep_filter_u8", x.device, dtype="uint8", kw=kw, kh=kh,
                      channels=x.shape[3], border=borderType, shift=2 * bits)
        if kern is not None:
            y = kern(x, kx, ky)
        else:
            y = sep_filter_int_plain(x, kx, ky, shift=2 * bits, border=borderType)
    else:
        acc = _sep_correlate_float(x, kxf, kyf, borderType, dtype=_float_dtype(x.dtype))
        y = saturate_cast(acc, x.dtype) if not x.is_floating_point() else acc.to(x.dtype)
    return from_batched(y, meta)


# --------------------------------------------------------------------------
# sepFilter2D / filter2D
# --------------------------------------------------------------------------

def _as_1d(k):
    return np.asarray(k, np.float64).reshape(-1)


_DEPTH_TO_DTYPE = {
    K.CV_8U: torch.uint8,
    K.CV_16U: torch.uint16,
    K.CV_16S: torch.int16,
    K.CV_32F: torch.float32,
    K.CV_64F: torch.float64,  # real f64 (the TPU package maps it to f32)
}


def _resolve_ddepth(src_dtype, ddepth):
    if ddepth in (-1, None):
        return src_dtype
    dt = _DEPTH_TO_DTYPE.get(ddepth)
    if dt is None:
        raise ValueError(f"unsupported ddepth {ddepth}")
    return dt


def _float_dtype(*dtypes) -> torch.dtype:
    """The float type a float path accumulates in: f64 where the input or
    the output is f64, else f32."""
    return torch.float64 if torch.float64 in dtypes else torch.float32


def sepFilter2D(src, ddepth, kernelX, kernelY, anchor=(-1, -1), delta=0.0,
                borderType: int = K.BORDER_DEFAULT):
    """Separable filtering (`cv::sepFilter2D`, filter.dispatch.cpp).

    u8→u8/16S with integer-representable behavior uses the reference's
    bit-exact scheme: integer taps as they are; fractional taps quantized
    to Q8 (`convertTo(CV_32S, 1<<8)`, filter.dispatch.cpp:288-296) when they
    round-trip, int32 accumulation and a final `(v + 2^15) >> 16`.  That is
    the ``sep_filter_int`` kernel on the card.  Other kernels and dtypes
    accumulate in float (±1 on integer outputs, perf_filter2d.cpp:39).
    """
    from ..kernels.sepfilter import sep_filter_int_plain

    x, meta = to_batched(src)
    out_dtype = _resolve_ddepth(x.dtype, ddepth)
    kx = _as_1d(kernelX)
    ky = _as_1d(kernelY)
    if _anchor(anchor, len(kx), len(ky)) != (len(kx) // 2, len(ky) // 2):
        raise NotImplementedError("sepFilter2D: only the centred anchor is ported")

    if (x.dtype == torch.uint8 and out_dtype in (torch.uint8, torch.int16)
            and delta == int(delta)):

        def _int_path(kxi, kyi, shift):
            # dispatch ladder: the CUDA kernel when its predicate takes this
            # config, else the plain version
            max_abs = (int(np.abs(kxi).sum()) * int(np.abs(kyi).sum()) * 255
                       + abs(int(delta)))
            kern = lookup("sep_filter_int", x.device, dtype="uint8",
                          kw=len(kxi), kh=len(kyi), channels=x.shape[3],
                          border=borderType, shift=shift, delta=int(delta),
                          out=dtype_name(out_dtype), max_abs_acc=max_abs)
            kxi = [int(v) for v in kxi]
            kyi = [int(v) for v in kyi]
            if kern is not None:
                return kern(x, kxi, kyi)
            return sep_filter_int_plain(x, kxi, kyi, shift=shift, delta=int(delta),
                                        out_dtype=out_dtype, border=borderType)

        # integer kernels (Sobel/Scharr/derivs): exact int32 MAC, no shift
        kxi = np.rint(kx).astype(np.int64)
        kyi = np.rint(ky).astype(np.int64)
        if np.all(kxi == kx) and np.all(kyi == ky):
            return from_batched(_int_path(kxi, kyi, 0), meta)
        # fractional kernels: bit-exact Q8 scheme mirroring
        # filter.dispatch.cpp:332-362 (validity check incl.)
        bits = 8
        kxq = np.rint(kx * (1 << bits)).astype(np.int64)
        kyq = np.rint(ky * (1 << bits)).astype(np.int64)
        eps = 10 * np.finfo(np.float32).eps * (1 << bits)
        if (np.all(np.abs(kxq - kx * (1 << bits)) <= eps)
                and np.all(np.abs(kyq - ky * (1 << bits)) <= eps)):
            return from_batched(_int_path(kxq, kyq, 2 * bits), meta)

    acc = _sep_correlate_float(x, kx, ky, borderType, dtype=_float_dtype(x.dtype, out_dtype))
    acc = acc + torch.tensor(delta, dtype=acc.dtype)
    return from_batched(saturate_cast(acc, out_dtype), meta)


def filter2D(src, ddepth, kernel, anchor=(-1, -1), delta=0.0,
             borderType: int = K.BORDER_DEFAULT):
    """Dense 2-D correlation (`cv::filter2D`, filter.dispatch.cpp:1425).

    Always accumulates in float (the reference's non-separable fixed-point
    path is disabled, filter.simd.hpp:3190-3200), so integer outputs carry
    the same ±1 tolerance contract as the reference.
    """
    x, meta = to_batched(src)
    out_dtype = _resolve_ddepth(x.dtype, ddepth)
    kern = np.asarray(kernel, np.float64)
    if kern.ndim == 1:
        kern = kern[None, :]
    work = _float_dtype(x.dtype, out_dtype)
    # large kernels go through DFT like the reference (dftFilter2D,
    # filter.dispatch.cpp:1274; crossover :1288 — 130 for 8U->8U/16S,
    # 50 otherwise; both paths share the float tolerance contract)
    dft_size = 130 if (x.dtype == torch.uint8
                       and out_dtype in (torch.uint8, torch.int16)) else 50
    if kern.shape[0] * kern.shape[1] >= dft_size:
        acc = _correlate2d_fft(x, kern, anchor, borderType, work)
    else:
        acc = _correlate2d_mac(x, kern, anchor, borderType, work)
    acc = acc + torch.tensor(delta, dtype=acc.dtype)
    return from_batched(saturate_cast(acc, out_dtype), meta)


# --------------------------------------------------------------------------
# Box filters
# --------------------------------------------------------------------------

def _box_sum_int(x, ksize, anchor, border_type):
    """Integer box sum (int32), exact.

    Small kernels use separable shift-adds; kernels over 16 taps on an axis
    use the cumsum sliding window (the JAX package's crossover)."""
    kw, kh = ksize
    ax, ay = _anchor(anchor, kw, kh)
    xi = pad_nhwc(x, ay, kh - 1 - ay, ax, kw - 1 - ax, border_type).to(torch.int32)
    H, W = x.shape[1], x.shape[2]
    if kw <= 16 and kh <= 16:
        h = xi[:, :, 0:W, :]
        for i in range(1, kw):
            h = h + xi[:, :, i:i + W, :]
        v = h[:, 0:H]
        for j in range(1, kh):
            v = v + h[:, j:j + H]
        return v
    ch = torch.cumsum(xi, dim=2, dtype=torch.int32)
    ch0 = torch.cat([torch.zeros_like(ch[:, :, :1]), ch], dim=2)
    h = ch[:, :, kw - 1:kw - 1 + W, :] - ch0[:, :, :W, :]
    cv = torch.cumsum(h, dim=1, dtype=torch.int32)
    cv0 = torch.cat([torch.zeros_like(cv[:, :1]), cv], dim=1)
    return cv[:, kh - 1:kh - 1 + H, :, :] - cv0[:, :H, :, :]


def boxFilter(src, ddepth, ksize, anchor=(-1, -1), normalize: bool = True,
              borderType: int = K.BORDER_DEFAULT):
    """`cv::boxFilter` (box_filter.dispatch.cpp): sliding-window sum with
    optional 1/(kw*kh) normalization; integer inputs sum in int32 and
    normalization rounds like `saturate_cast<T>(sum*scale)`.  u8 with a
    centred anchor takes the ``sep_filter_int`` kernel on the card."""
    x, meta = to_batched(src)
    out_dtype = _resolve_ddepth(x.dtype, ddepth)
    kw, kh = ksize
    scale = 1.0 / (kw * kh)
    work = _float_dtype(x.dtype, out_dtype)
    if not x.is_floating_point():
        if x.dtype == torch.uint8 and _anchor(anchor, kw, kh) == (kw // 2, kh // 2):
            kern = lookup("sep_filter_int", x.device, dtype="uint8", kw=kw, kh=kh,
                          channels=x.shape[3], border=borderType, shift=0, delta=0,
                          scale=scale if normalize else None,
                          out=dtype_name(out_dtype), max_abs_acc=kw * kh * 255)
            if kern is not None:
                return from_batched(kern(x, (1,) * kw, (1,) * kh), meta)
        s = _box_sum_int(x, ksize, anchor, borderType)
        if normalize:
            s = s.to(work) * torch.tensor(scale, dtype=work)
        return from_batched(saturate_cast(s, out_dtype), meta)
    if _anchor(anchor, kw, kh) != (kw // 2, kh // 2):
        raise NotImplementedError("boxFilter: only the centred anchor is ported for float input")
    s = _sep_correlate_float(x, np.ones(kw), np.ones(kh), borderType, dtype=work)
    if normalize:
        s = s * torch.tensor(scale, dtype=s.dtype)
    return from_batched(saturate_cast(s, out_dtype), meta)


def blur(src, ksize, anchor=(-1, -1), borderType: int = K.BORDER_DEFAULT):
    """`cv::blur` == normalized boxFilter with ddepth=-1."""
    return boxFilter(src, -1, ksize, anchor=anchor, normalize=True, borderType=borderType)


def sqrBoxFilter(src, ddepth, ksize, anchor=(-1, -1), normalize: bool = True,
                 borderType: int = K.BORDER_DEFAULT):
    """Box filter of squared values (`cv::sqrBoxFilter`)."""
    x, meta = to_batched(src)
    if ddepth in (-1, None):
        ddepth = K.CV_32F
    out_dtype = _resolve_ddepth(x.dtype, ddepth)
    work = _float_dtype(x.dtype, out_dtype)
    kw, kh = ksize
    if _anchor(anchor, kw, kh) != (kw // 2, kh // 2):
        raise NotImplementedError("sqrBoxFilter: only the centred anchor is ported")
    xf = x.to(work)
    s = _sep_correlate_float(xf * xf, np.ones(kw), np.ones(kh), borderType, dtype=work)
    if normalize:
        s = s * torch.tensor(1.0 / (kw * kh), dtype=s.dtype)
    return from_batched(saturate_cast(s, out_dtype), meta)
