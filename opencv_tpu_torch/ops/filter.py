"""GaussianBlur and the Gaussian kernel builders (twin of
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

sepFilter2D, filter2D and boxFilter are not ported yet (ROADMAP.md, A3).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import constants as K
from ..core.arrays import to_batched, from_batched
from ..core.borders import pad_nhwc
from ..core.dispatch import lookup
from ..core.fixedpoint import saturate_cast

__all__ = ["getGaussianKernel", "GaussianBlur"]


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
# float separable correlation (plain torch)
# --------------------------------------------------------------------------

def _sep_correlate_float(x, kx, ky, border_type, border_value=0):
    """Separable correlate in float32, taps applied left to right as
    ``opencv_tpu/ops/filter.py::_sep_correlate_float``."""
    kw, kh = len(kx), len(ky)
    ax, ay = kw // 2, kh // 2
    xf = pad_nhwc(x, ay, kh - 1 - ay, ax, kw - 1 - ax, border_type,
                  border_value).to(torch.float32)
    N, H, W, C = x.shape
    h = None
    for i, c in enumerate(kx):
        term = xf[:, :, i:i + W, :] * torch.tensor(float(c), dtype=torch.float32)
        h = term if h is None else h + term
    v = None
    for j, c in enumerate(ky):
        term = h[:, j:j + H, :, :] * torch.tensor(float(c), dtype=torch.float32)
        v = term if v is None else v + term
    return v


# --------------------------------------------------------------------------
# GaussianBlur
# --------------------------------------------------------------------------

def GaussianBlur(src, ksize, sigmaX: float, sigmaY: float = 0.0,
                 borderType: int = K.BORDER_DEFAULT,
                 hint: int = K.ALGO_HINT_DEFAULT):
    """Gaussian smoothing, mirroring `cv::GaussianBlur`
    (imgproc/src/smooth.dispatch.cpp:609).

    u8 inputs take the bit-exact Q8 fixed-point path (default hint); other
    dtypes use float32 separable filtering.
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
        acc = _sep_correlate_float(x, kxf, kyf, borderType)
        y = saturate_cast(acc, x.dtype) if not x.is_floating_point() else acc.to(x.dtype)
    return from_batched(y, meta)
