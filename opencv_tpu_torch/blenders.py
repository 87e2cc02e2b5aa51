"""Stitching blenders (stitching/src/blenders.cpp), twin of
``opencv_tpu/blenders.py``.

MultiBandBlender: Burt–Adelson Laplacian-pyramid blending built from the
port's f32 ``pyrDown``/``pyrUp``.  FeatherBlender: weights from the L1
``distanceTransform`` of each mask.  Everything runs on the images' device,
and nothing is read back before the u8 result; numpy inputs run on the CPU.
Results are tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import constants as K
from .core.arrays import as_tensor
from .ops.pyramids import pyrDown, pyrUp
from .ops.shape import distanceTransform

__all__ = ["MultiBandBlender", "FeatherBlender", "blend_multiband"]


def _gauss_pyr(img, levels):
    pyr = [img]
    for _ in range(levels):
        pyr.append(pyrDown(pyr[-1]))
    return pyr


def _lap_pyr(img, levels):
    g = _gauss_pyr(img, levels)
    lap = [g[i] - pyrUp(g[i + 1]) for i in range(levels)]
    lap.append(g[levels])
    return lap


def _pad_edge(a, Hp: int, Wp: int):
    """`a` (H, W[, C]) padded at the bottom and the right to (Hp, Wp) by
    repeating its last row and column (numpy's mode "edge")."""
    H, W = a.shape[:2]
    rows = torch.arange(Hp, device=a.device).clamp_(max=H - 1)
    cols = torch.arange(Wp, device=a.device).clamp_(max=W - 1)
    return a.index_select(0, rows).index_select(1, cols)


def blend_multiband(images, masks, num_bands=5):
    """Blend len(images) aligned images with weights from masks (float in
    [0, 1], same H×W), on the first image's device; a u8 tensor."""
    images = [as_tensor(i) for i in images]
    dev = images[0].device
    masks = [as_tensor(m).to(dev) for m in masks]
    H, W = images[0].shape[:2]
    levels = min(num_bands, int(np.log2(max(min(H, W) // 16, 2))))
    # pad to a multiple of 2^levels so every pyrUp doubles exactly
    mult = 1 << levels
    Hp = (H + mult - 1) // mult * mult
    Wp = (W + mult - 1) // mult * mult
    if (Hp, Wp) != (H, W):
        images = [_pad_edge(i, Hp, Wp) for i in images]
        masks = [_pad_edge(m, Hp, Wp) for m in masks]
        return blend_multiband(images, masks, num_bands)[:H, :W]
    acc = None
    wacc = None
    for img, m in zip(images, masks):
        lap = _lap_pyr(img.to(dev, torch.float32), levels)
        wpyr = _gauss_pyr(m.to(torch.float32), levels)
        if acc is None:
            acc = [torch.zeros_like(l) for l in lap]
            wacc = [torch.zeros_like(w) for w in wpyr]
        for i in range(levels + 1):
            w = wpyr[i][..., None] if lap[i].ndim == 3 else wpyr[i]
            acc[i] += lap[i] * w
            wacc[i] += wpyr[i]
    out = None
    for i in range(levels, -1, -1):
        w = wacc[i][..., None] if acc[i].ndim == 3 else wacc[i]
        band = acc[i] / torch.clamp(w, min=1e-6)
        out = band if out is None else pyrUp(out) + band
    return torch.round(out).clamp_(0, 255).to(torch.uint8)


def _place(img, size, tl, dtype):
    """`img` on a zero canvas of `size` (H, W) at `tl` (x, y)."""
    img = as_tensor(img)
    canvas = torch.zeros(tuple(size) + tuple(img.shape[2:]), dtype=dtype, device=img.device)
    x, y = tl
    ih, iw = img.shape[:2]
    canvas[y:y + ih, x:x + iw] = img.to(dtype)
    return canvas


class MultiBandBlender:
    def __init__(self, try_gpu=False, num_bands=5, weight_type=None):
        self.num_bands = num_bands
        self._imgs = []
        self._masks = []
        self._size = None

    def prepare(self, roi_or_corners, sizes=None):
        if sizes is None:
            x, y, w, h = roi_or_corners
            self._size = (h, w)
        self._imgs = []
        self._masks = []

    def feed(self, img, mask, tl=(0, 0)):
        img = as_tensor(img)
        self._imgs.append(_place(img, self._size, tl, torch.float32))
        m = (as_tensor(mask).to(img.device) > 0).to(torch.float32)
        self._masks.append(_place(m, self._size, tl, torch.float32))

    def blend(self, dst=None, dst_mask=None):
        out = blend_multiband(self._imgs, self._masks, self.num_bands)
        mask = (torch.stack(self._masks).sum(0) > 0).to(torch.uint8) * 255
        return out, mask


class FeatherBlender:
    def __init__(self, sharpness=0.02):
        self.sharpness = sharpness
        self._imgs = []
        self._weights = []
        self._size = None

    def prepare(self, roi, sizes=None):
        x, y, w, h = roi
        self._size = (h, w)
        self._imgs = []
        self._weights = []

    def feed(self, img, mask, tl=(0, 0)):
        img = as_tensor(img)
        canvas = _place(img, self._size, tl, torch.float32)
        m = (as_tensor(mask).to(img.device) > 0).to(torch.uint8) * 255
        m = _place(m, self._size, tl, torch.uint8)
        dist = distanceTransform(m, K.DIST_L1, 3)
        self._imgs.append(canvas)
        self._weights.append(torch.clamp(dist * self.sharpness, max=1.0))

    def blend(self, dst=None, dst_mask=None):
        wsum = torch.stack(self._weights).sum(0)
        acc = torch.zeros_like(self._imgs[0])
        for img, w_ in zip(self._imgs, self._weights):
            acc += img * (w_[..., None] if img.ndim == 3 else w_)
        out = acc / torch.clamp(wsum[..., None] if acc.ndim == 3 else wsum, min=1e-6)
        mask = (wsum > 0).to(torch.uint8) * 255
        return torch.round(out).clamp_(0, 255).to(torch.uint8), mask
