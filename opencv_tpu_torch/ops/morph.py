"""Morphology: erode / dilate / morphologyEx / getStructuringElement
(imgproc/src/morph.dispatch.cpp), twin of ``opencv_tpu/ops/morph.py``.

Erode and dilate both scan the structuring element as it is (no
reflection), as the reference build does.  The design is the JAX
package's, in plain torch:

- a rectangular element is two 1-D sliding min/max windows, each taken by
  window doubling: ceil(log2 k) shifted combines per axis;
- any other element reduces over its nonzero shifted slices;
- N iterations of a rectangular element fold into one larger window;
- the `morphologyDefaultBorderValue()` sentinel resolves to the identity
  of the op (the dtype's max for erode, its min for dilate, ±inf for
  floats, morph.dispatch.cpp:113-127), so the constant border never wins.

All of it is exact on every dtype.  There is no CUDA kernel: the JAX package
has no Pallas tier here either (``opencv_tpu/ops/morph.py:111-114``), and
torch's pooling takes neither u8 on the card nor cv2's borders.  uint16,
which torch's CPU min/max do not take, is reduced in int32.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as K
from ..core.arrays import to_batched, from_batched
from ..core.borders import pad_nhwc

__all__ = ["erode", "dilate", "morphologyEx", "getStructuringElement",
           "morphologyDefaultBorderValue"]


def morphologyDefaultBorderValue():
    return (np.finfo(np.float64).max,) * 4


# copy of opencv_tpu.ops.morph.getStructuringElement
def getStructuringElement(shape: int, ksize, anchor=(-1, -1)) -> np.ndarray:
    """Host twin of `cv::getStructuringElement`."""
    kw, kh = int(ksize[0]), int(ksize[1])
    ax = kw // 2 if anchor[0] < 0 else anchor[0]
    ay = kh // 2 if anchor[1] < 0 else anchor[1]
    el = np.zeros((kh, kw), np.uint8)
    if shape == K.MORPH_RECT or (kw == 1 and kh == 1):
        el[:] = 1
    elif shape == K.MORPH_CROSS:
        el[ay, :] = 1
        el[:, ax] = 1
    elif shape == K.MORPH_ELLIPSE:
        r = kh // 2
        c = kw // 2
        inv_r2 = 1.0 / (r * r) if r else 0.0
        for i in range(kh):
            dy = i - r
            if abs(dy) <= r:
                dx = int(np.rint(c * np.sqrt(max(r * r - dy * dy, 0) * inv_r2))) \
                    if r else c
                j1 = max(c - dx, 0)
                j2 = min(c + dx + 1, kw)
                el[i, j1:j2] = 1
    else:
        raise ValueError(f"unknown structuring element shape {shape}")
    return el


def _identity_value(dtype: torch.dtype, is_erode: bool):
    if dtype.is_floating_point:
        return np.inf if is_erode else -np.inf
    info = torch.iinfo(dtype)
    return info.max if is_erode else info.min


def _is_default_border_value(value) -> bool:
    if value is None:
        return True
    v = np.asarray(value, np.float64).reshape(-1)
    return bool(np.all(v[:1] == np.finfo(np.float64).max))


def _wide(x):
    """x as the reference's arithmetic sees it: uint16 in int32 (torch's CPU
    uint16 has neither min/max nor subtraction), other dtypes as they are."""
    return x.to(torch.int32) if x.dtype == torch.uint16 else x


def _slide(v, k: int, axis: int, op):
    """Exact sliding min/max of width k along `axis` (valid), by window
    doubling: ceil(log2 k) shifted combines."""
    covered = 1
    while covered < k:
        s = min(covered, k - covered)
        n = v.shape[axis]
        v = op(v.narrow(axis, 0, n - s), v.narrow(axis, s, n - s))
        covered += s
    return v


def _morph_op(x, kernel, anchor, iterations, border_type, border_value, is_erode: bool):
    kernel = np.asarray(kernel) if kernel is not None else None
    if kernel is None or kernel.size == 0:
        kernel = np.ones((3, 3), np.uint8)
        anchor = (1, 1)
    kh, kw = kernel.shape
    ax = kw // 2 if anchor is None or anchor[0] < 0 else anchor[0]
    ay = kh // 2 if anchor is None or anchor[1] < 0 else anchor[1]

    is_rect = bool(np.all(kernel != 0))
    if is_rect and iterations > 1:
        # a rectangle composes exactly: N iterations of k == one k+(N-1)(k-1)
        # (morph.dispatch.cpp erode/dilate iterations folding)
        ax = ax + (iterations - 1) * ax
        ay = ay + (iterations - 1) * ay
        kw = kw + (iterations - 1) * (kw - 1)
        kh = kh + (iterations - 1) * (kh - 1)
        kernel = np.ones((kh, kw), np.uint8)
        iterations = 1

    bt = border_type & ~K.BORDER_ISOLATED
    if bt == K.BORDER_CONSTANT:
        if _is_default_border_value(border_value):
            pad_val = _identity_value(x.dtype, is_erode)
        else:
            v = np.asarray(border_value, np.float64).reshape(-1)[0]
            if x.is_floating_point():
                pad_val = v
            else:
                info = torch.iinfo(x.dtype)
                pad_val = int(np.clip(np.rint(v), info.min, info.max))
    else:
        pad_val = 0

    op = torch.minimum if is_erode else torch.maximum
    shifts = [(j, i) for j in range(kh) for i in range(kw) if kernel[j, i]]

    def one_pass(xx):
        xp = pad_nhwc(xx, ay, kh - 1 - ay, ax, kw - 1 - ax, border_type, pad_val)
        H, W = xx.shape[1], xx.shape[2]
        if is_rect:
            return _slide(_slide(xp, kw, 2, op), kh, 1, op)
        acc = None
        for j, i in shifts:
            s = xp[:, j:j + H, i:i + W, :]
            acc = s if acc is None else op(acc, s)
        return acc

    y = _wide(x)
    for _ in range(max(iterations, 1)):
        y = one_pass(y)
    return y.to(x.dtype)


def erode(src, kernel=None, anchor=(-1, -1), iterations: int = 1,
          borderType: int = K.BORDER_CONSTANT, borderValue=None):
    x, meta = to_batched(src)
    y = _morph_op(x, kernel, anchor, iterations, borderType, borderValue, is_erode=True)
    return from_batched(y, meta)


def dilate(src, kernel=None, anchor=(-1, -1), iterations: int = 1,
           borderType: int = K.BORDER_CONSTANT, borderValue=None):
    x, meta = to_batched(src)
    y = _morph_op(x, kernel, anchor, iterations, borderType, borderValue, is_erode=False)
    return from_batched(y, meta)


def morphologyEx(src, op: int, kernel, anchor=(-1, -1), iterations: int = 1,
                 borderType: int = K.BORDER_CONSTANT, borderValue=None):
    """Compound ops (morph.dispatch.cpp:935,1012).  The differences wrap in
    the input dtype, as the reference's do."""
    a = dict(anchor=anchor, iterations=iterations, borderType=borderType,
             borderValue=borderValue)
    if op == K.MORPH_ERODE:
        return erode(src, kernel, **a)
    if op == K.MORPH_DILATE:
        return dilate(src, kernel, **a)
    if op == K.MORPH_OPEN:
        return dilate(erode(src, kernel, **a), kernel, **a)
    if op == K.MORPH_CLOSE:
        return erode(dilate(src, kernel, **a), kernel, **a)
    x, meta = to_batched(src)
    if op == K.MORPH_GRADIENT:
        d = _morph_op(x, kernel, anchor, iterations, borderType, borderValue, False)
        e = _morph_op(x, kernel, anchor, iterations, borderType, borderValue, True)
        return from_batched((_wide(d) - _wide(e)).to(x.dtype), meta)
    if op == K.MORPH_TOPHAT:
        o, _ = to_batched(morphologyEx(src, K.MORPH_OPEN, kernel, **a))
        return from_batched((_wide(x) - _wide(o)).to(x.dtype), meta)
    if op == K.MORPH_BLACKHAT:
        c, _ = to_batched(morphologyEx(src, K.MORPH_CLOSE, kernel, **a))
        return from_batched((_wide(c) - _wide(x)).to(x.dtype), meta)
    if op == K.MORPH_HITMISS:
        # the image eroded by the 1s and its complement by the -1s, then
        # their min, one iteration (the reference's; cv2 takes the bitwise
        # and, which is the min on the binary images it is meant for).  A
        # part with no entries drops out, as in cv2; the JAX package fails.
        kern = np.asarray(kernel, np.int64)
        if x.is_floating_point():
            inv = -x
        else:
            inv = (torch.iinfo(x.dtype).max - _wide(x)).to(x.dtype)
        parts = [_wide(_morph_op(v, (kern == sign).astype(np.uint8), anchor, 1, borderType,
                                 borderValue, True))
                 for v, sign in ((x, 1), (inv, -1)) if (kern == sign).any()]
        if not parts:
            raise ValueError("MORPH_HITMISS needs a 1 or a -1 in the kernel")
        return from_batched(parts[0].minimum(parts[-1]).to(x.dtype), meta)
    raise ValueError(f"unknown morphology op {op}")
