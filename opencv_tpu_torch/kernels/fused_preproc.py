"""Fused BGR→GRAY + GaussianBlur(5×5) + 2×2 AREA downsample on u8: the
CUDA kernel ``csrc/fused_preproc.cu`` and its plain PyTorch version.

Twin of ``opencv_tpu/kernels/fused_preproc.py``: ``gauss5_down2_u8`` and
``gauss5_down2_u8_db`` (gray input) and ``fused_gray_gauss5_down2`` (BGR
input, the public ``fusedPreprocessGrayBlurDown2``) are one kernel here,
with the gray conversion folded in when the input is BGR.

Bit-exact with the composed ops: Q15 gray, separable Q8·Q8 MAC with one
round ``(v + 2^15) >> 16`` and saturate, then ``(a+b+c+d+2) >> 2``.
A CPU tensor takes the plain version, a CUDA tensor the kernel, resolved
through the dispatch registry as ``gauss5_down2_u8`` (u8, 1 or 3 channels,
even H and W), which counts both in ``tier_stats()``.

The launch plan (:func:`_plan`: strip width, blocks, column groups, the
aligned path) is computed here, on the host, and handed to the C entry with
the taps; the entry refuses a plan that does not cover the image.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import constants as K
from ..core.arrays import as_tensor, dtype_name
from ..core.dispatch import lookup, register
from ..core.fixedpoint import descale
from ..ops.color import BY15, GRAY_SHIFT, GY15, RY15
from ..ops.filter import gaussian_kernel_bitexact, gaussian_kernel_fixedpoint_ed
from ._build import Kernel, stream_of
from .sepfilter import sep_filter_int_plain

__all__ = ["GAUSS5_DOWN2", "gauss5_down2_u8", "fused_gray_gauss5_down2",
           "gauss5_down2_u8_plain", "fused_gray_gauss5_down2_plain"]

_vp, _i = ctypes.c_void_p, ctypes.c_int
GAUSS5_DOWN2 = Kernel("opencv_gauss5_down2",
                      [_vp, _vp, _i, _i, _i, _i, ctypes.POINTER(ctypes.c_int), _vp])


def _taps(sigma: float) -> list:
    return [int(v) for v in gaussian_kernel_fixedpoint_ed(gaussian_kernel_bitexact(5, sigma), 8)]


# The grid is one wave: the kernel is built for 4 resident blocks of 4 warps
# on each of the H100's 132 SMs (``__launch_bounds__(128, 4)``).
SMS = 132
WARPS = 4
WAVE = 4 * SMS
MIN_RUN = 2  # output rows a warp takes at least, where the image is small


class Plan(NamedTuple):
    px: int      # pixels of a lane's strip: 8 BGR, 16 gray (csrc's kStripBgr, kStripGray)
    blocks: int  # blocks of WARPS warps
    gx: int      # column groups: ceil(W / (32 px)); a warp's columns are one group
    vec: bool    # the aligned path: 8- or 16-byte loads, one packed store a row
    band: int    # output rows a warp takes, at most


def _plan(N: int, H: int, W: int, has_bgr: bool, ptr: int) -> Plan:
    """The launch of an (N, H, W[, 3]) image whose first byte is at `ptr`:
    strips of 8 BGR pixels (24 bytes) or 16 gray ones a lane.

    The kernel's units are the N * gx * H/2 output rows of the column
    groups; warp i of the grid takes units [i * units / warps, (i + 1) *
    units / warps) (the kernel's split), so every warp of the one wave has
    the same share, whatever N is.  The aligned path needs the base and the
    row pitch (3W or W bytes) 16-byte aligned."""
    px = 8 if has_bgr else 16
    gx = -(-W // (32 * px))
    units = N * gx * (H // 2)
    blocks = max(1, min(WAVE, -(-units // (WARPS * MIN_RUN))))
    vec = ptr % 16 == 0 and W * (3 if has_bgr else 1) % 16 == 0
    return Plan(px, blocks, gx, vec, -(-units // (WARPS * blocks)))


def _check(x, ndim: int, what: str):
    if x.dtype != torch.uint8 or x.ndim != ndim or (ndim == 4 and x.shape[3] != 3):
        raise ValueError(f"{what}: expected {'(N,H,W,3)' if ndim == 4 else '(N,H,W)'} "
                         f"uint8, got {tuple(x.shape)} {x.dtype}")
    H, W = x.shape[1], x.shape[2]
    if H % 2 or W % 2:
        raise ValueError(f"{what}: H and W must be even, got {H}x{W}")


def gauss5_down2_u8_plain(gray, sigma: float = 0.0):
    """gray (N,H,W) u8 → (N,H/2,W/2) u8 on any device: GaussianBlur 5×5
    REFLECT_101, then the 2×2 AREA mean."""
    kq = _taps(sigma)
    b = sep_filter_int_plain(gray[..., None], kq, kq, shift=16,
                             border=K.BORDER_REFLECT_101)[..., 0].to(torch.int32)
    s = b[:, 0::2, 0::2] + b[:, 0::2, 1::2] + b[:, 1::2, 0::2] + b[:, 1::2, 1::2]
    return ((s + 2) >> 2).to(torch.uint8)


def fused_gray_gauss5_down2_plain(imgs, sigma: float = 0.0):
    """(N,H,W,3) BGR u8 → (N,H/2,W/2) u8 on any device."""
    xi = imgs.to(torch.int32)
    gray = descale(xi[..., 2] * RY15 + xi[..., 1] * GY15 + xi[..., 0] * BY15, GRAY_SHIFT)
    return gauss5_down2_u8_plain(gray.to(torch.uint8), sigma)


def _launch(x, sigma: float, has_bgr: bool, plan: Plan | None = None):
    N, H, W = x.shape[:3]
    x = x.contiguous()
    if plan is None:
        plan = _plan(N, H, W, has_bgr, x.data_ptr())
    out = torch.empty((N, H // 2, W // 2), dtype=torch.uint8, device=x.device)
    args = (*_taps(sigma), plan.px, plan.blocks, plan.gx, int(plan.vec))
    GAUSS5_DOWN2(x.device, x.data_ptr(), out.data_ptr(), N, H, W, int(has_bgr),
                 (ctypes.c_int * len(args))(*args), stream_of(x))
    return out


def _gauss5_down2_pred(ctx):
    return (ctx.get("dtype") == "uint8" and ctx.get("channels") in (1, 3)
            and ctx.get("height", 1) % 2 == 0 and ctx.get("width", 1) % 2 == 0)


@register("gauss5_down2_u8", _gauss5_down2_pred)
def _gauss5_down2_kernel(ctx, x, sigma):
    return _launch(x, sigma, has_bgr=ctx["channels"] == 3)


def _resolve(x, sigma: float, plain):
    """The kernel through the dispatch registry on a CUDA tensor, `plain`
    on a CPU tensor; any other device, or a CUDA tensor the predicate
    refuses, raises (no fall-through to the plain version)."""
    kern = lookup("gauss5_down2_u8", x.device, dtype=dtype_name(x.dtype),
                  channels=x.shape[3] if x.ndim == 4 else 1, height=x.shape[1], width=x.shape[2])
    if kern is not None:
        return kern(x, sigma)
    if x.device.type != "cpu":
        raise RuntimeError(f"gauss5_down2: no kernel for {tuple(x.shape)} {x.dtype} on "
                           f"{x.device}")
    return plain(x, sigma)


def gauss5_down2_u8(gray, sigma: float = 0.0):
    """gray: (N, H, W) u8 with H, W even. Returns (N, H//2, W//2) u8 ==
    resize(GaussianBlur(gray, (5,5), sigma), (W//2, H//2), INTER_AREA)."""
    gray = as_tensor(gray)
    _check(gray, 3, "gauss5_down2_u8")
    return _resolve(gray, sigma, gauss5_down2_u8_plain)


def fused_gray_gauss5_down2(imgs, sigma: float = 0.0):
    """(N, H, W, 3) BGR u8 → (N, H//2, W//2) u8: cvtColor(BGR2GRAY) +
    GaussianBlur(5×5) + 2× AREA downsample, bit-exact with the composed
    ops, in one kernel on the card."""
    imgs = as_tensor(imgs)
    _check(imgs, 4, "fused_gray_gauss5_down2")
    return _resolve(imgs, sigma, fused_gray_gauss5_down2_plain)
