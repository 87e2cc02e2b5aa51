"""Image pyramids: pyrDown / pyrUp / buildPyramid (imgproc/src/pyramids.cpp),
twin of ``opencv_tpu/ops/pyramids.py``.

Bit-exact contract: 5-tap {1,4,6,4,1}/256 kernel, int32 accumulation for
integer inputs with a single final round `(t + 128) >> 8`
(pyramids.cpp:488), BORDER_REFLECT_101, default dst size
((w+1)/2, (h+1)/2); u8 pyrDown is the ``pyr_down_u8`` kernel on the card.
pyrUp zero-stuffs: even outputs use taps {1,6,1}, odd {4,4} (per-axis sum
8), integer cast `(t + 32) >> 6`.

pyrDown refuses BORDER_CONSTANT, as ``cv::pyrDown`` does (the JAX package
pads zeros there).
"""

from __future__ import annotations

import torch

from .. import constants as K
from ..core.arrays import dtype_name, to_batched, from_batched
from ..core.borders import pad_nhwc
from ..core.dispatch import lookup
from ..core.fixedpoint import saturate_cast
from ..kernels.sepfilter import pyr_down_int_plain, pyr_down_sum

__all__ = ["pyrDown", "pyrUp", "buildPyramid"]


def _float_acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _pyr_down_nhwc(x, border_type):
    """The plain tier of pyrDown, every dtype and channel count."""
    if not x.is_floating_point():
        return pyr_down_int_plain(x, border_type)
    acc = _float_acc(x.dtype)
    v = pyr_down_sum(x, border_type, acc)
    return (v * torch.tensor(1.0 / 256, dtype=acc)).to(x.dtype)


def _pyr_up_nhwc(x, border_type):
    N, H, W, C = x.shape
    dh, dw = H * 2, W * 2
    is_int = not x.is_floating_point()
    # empirical reference semantics: REFLECT_101 on the leading edge,
    # REPLICATE on the trailing edge (last odd output row/col replicates
    # the final sample)
    xp = pad_nhwc(x, 1, 0, 1, 0, border_type)
    xp = pad_nhwc(xp, 0, 1, 0, 1, K.BORDER_REPLICATE)
    xa = xp.to(torch.int32 if is_int else _float_acc(x.dtype))
    # horizontal: even cols = s[j-1] + 6 s[j] + s[j+1]; odd = 4 (s[j] + s[j+1])
    left = xa[:, :, 0:W, :]
    center = xa[:, :, 1:W + 1, :]
    right = xa[:, :, 2:W + 2, :]
    he = left + 6 * center + right          # (N, H+2, W, C) at even cols
    ho = 4 * (center + right)               # odd col between j and j+1
    h = torch.stack([he, ho], dim=3).reshape(N, H + 2, dw, C)
    # vertical on h (which still has the +-1 row padding)
    top = h[:, 0:H, :, :]
    mid = h[:, 1:H + 1, :, :]
    bot = h[:, 2:H + 2, :, :]
    ve = top + 6 * mid + bot
    vo = 4 * (mid + bot)
    v = torch.stack([ve, vo], dim=2).reshape(N, dh, dw, C)
    if is_int:
        return saturate_cast((v + 32) >> 6, x.dtype)
    return (v * torch.tensor(1.0 / 64, dtype=v.dtype)).to(x.dtype)


def pyrDown(src, dstsize=None, borderType: int = K.BORDER_DEFAULT):
    x, meta = to_batched(src)
    if dstsize is not None:
        dw, dh = dstsize
        if (dw, dh) != ((x.shape[2] + 1) // 2, (x.shape[1] + 1) // 2):
            raise NotImplementedError("non-default pyrDown dstsize")
    if borderType & ~K.BORDER_ISOLATED == K.BORDER_CONSTANT:
        raise ValueError("pyrDown: BORDER_CONSTANT is not supported (as in cv::pyrDown)")
    # dispatch ladder: the stride-2 CUDA kernel for a CUDA tensor that its
    # predicate takes, else the plain version
    kern = lookup("pyr_down_u8", x.device, dtype=dtype_name(x.dtype),
                  channels=x.shape[3], border=borderType)
    if kern is not None:
        return from_batched(kern(x), meta)
    return from_batched(_pyr_down_nhwc(x, borderType), meta)


def pyrUp(src, dstsize=None, borderType: int = K.BORDER_DEFAULT):
    x, meta = to_batched(src)
    crop = None
    if dstsize is not None:
        dw, dh = dstsize
        W2, H2 = x.shape[2] * 2, x.shape[1] * 2
        # cv::pyrUp allows dst = 2s or 2s-1 per axis; the odd sizes are
        # exactly the even result cropped (verified vs the wheel)
        if not (W2 - (dw % 2 == 1) <= dw <= W2
                and H2 - (dh % 2 == 1) <= dh <= H2):
            raise NotImplementedError("non-default pyrUp dstsize")
        if (dw, dh) != (W2, H2):
            crop = (dh, dw)
    y = _pyr_up_nhwc(x, borderType)
    if crop is not None:
        y = y[:, :crop[0], :crop[1], :]
    return from_batched(y, meta)


def buildPyramid(src, maxlevel: int, borderType: int = K.BORDER_DEFAULT):
    out = [src]
    for _ in range(maxlevel):
        out.append(pyrDown(out[-1], borderType=borderType))
    return out
