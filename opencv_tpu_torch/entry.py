"""The flagship forward on the port — twin of ``__graft_entry__.py::entry``.

``forward`` is ``cvtColor(BGR2GRAY) → GaussianBlur((5,5), 0) → resize to
half size → warpAffine(getRotationMatrix2D(centre, 15°, 0.9))`` over a
batched NHWC u8 tensor; at the (8, 1080, 1920, 3) batch that is exactly
``entry()``'s chain (resize to 960×540, centre (480, 270)).
``forward_fused`` gives the same output through
``fusedPreprocessGrayBlurDown2`` → ``warpAffine``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import constants as K
from .kernels import fused_gray_gauss5_down2
from .ops.color import cvtColor
from .ops.filter import GaussianBlur
from .ops.resize import resize
from .ops.warp import getRotationMatrix2D, warpAffine

__all__ = ["SHAPE", "entry", "make_batch", "preprocess", "preprocess_fused", "warp",
           "forward", "forward_fused"]

SHAPE = (8, 1080, 1920, 3)


def make_batch(shape=SHAPE, seed: int = 0) -> np.ndarray:
    """The u8 batch of ``entry()``: numpy ``default_rng(seed)`` integers."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=shape, dtype=np.uint8)


def preprocess(imgs):
    """Gray → blur → half-size resize: (N,H,W,3) → (N,H/2,W/2,1)."""
    H, W = imgs.shape[1], imgs.shape[2]
    g = cvtColor(imgs, K.COLOR_BGR2GRAY)
    b = GaussianBlur(g, (5, 5), 0)
    return resize(b, (W // 2, H // 2))


def preprocess_fused(imgs):
    """The same as :func:`preprocess`, through the fused kernel."""
    return fused_gray_gauss5_down2(imgs, 0.0)[..., None]


def warp(r):
    """Rotate 15° and scale 0.9 about the centre, at the input's size."""
    h, w = r.shape[1], r.shape[2]
    M = getRotationMatrix2D((w / 2, h / 2), 15.0, 0.9)
    return warpAffine(r, M, (w, h))


def forward(imgs):
    return warp(preprocess(imgs))


def forward_fused(imgs):
    return warp(preprocess_fused(imgs))


def entry(device="cuda", shape=SHAPE):
    """``(forward, (imgs,))`` with the batch on `device`."""
    return forward, (torch.from_numpy(make_batch(shape)).to(device),)
