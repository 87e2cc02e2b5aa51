"""Contrast-preserving decolorization (photo/src/contrast_preserve.cpp,
Lu et al. 2012).

The solver is small dense linear algebra over per-pixel gradient
samples — 9 color monomials, a 9x9 normal system, and a bimodal-E-M
weight loop; everything vectorizes directly.

Twin of ``opencv_tpu/photo/decolor.py``: the same numpy solver, over the
port's ``resize`` and ``cvtColor``, run on the input's device and read back;
the two outputs are tensors on that device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.arrays import as_tensor, to_host
from ..ops.color import cvtColor
from ..ops.resize import resize
from .. import constants as K

__all__ = ["decolor"]

_ORDER = 2
_SIGMA = 0.02


def _gradvector(img):
    """Forward differences (kernels [1,-1]) with zero border, last
    col/row zeroed, flattened transposed, gx then gy."""
    h, w = img.shape
    gx = np.zeros_like(img)
    gx[:, :w - 1] = img[:, :w - 1] - img[:, 1:]
    # (filter2D with [1,-1] anchored right = I(x) - I(x+1)); last col 0
    gy = np.zeros_like(img)
    gy[:h - 1] = img[:h - 1] - img[1:]
    return np.concatenate([gx.T.ravel(), gy.T.ravel()])


def _combs():
    out = []
    for r in range(_ORDER + 1):
        for g in range(_ORDER + 1):
            for b in range(_ORDER + 1):
                if 0 < r + g + b <= _ORDER:
                    out.append((r, g, b))
    return out


def decolor(src, grayscale=None, color_boost=None):
    """cv2.decolor: returns (gray u8, color_boost u8 BGR)."""
    dev = as_tensor(src).device
    I = to_host(src)
    img = I.astype(np.float32) / 255.0
    h, w = img.shape[:2]

    if h + w > 800:
        f = 800.0 / (h + w)
        small = to_host(resize(torch.from_numpy(img).to(dev), (int(round(w * f)),
                                                               int(round(h * f)))))
    else:
        small = img

    bs, gs, rs = small[..., 0], small[..., 1], small[..., 2]

    # color contrast Cg from Lab gradients
    lab = to_host(cvtColor(torch.from_numpy(small).to(dev), K.COLOR_BGR2Lab))
    Cg = np.sqrt(_gradvector(lab[..., 0]) ** 2
                 + _gradvector(lab[..., 1]) ** 2
                 + _gradvector(lab[..., 2]) ** 2) / 100.0

    comb = _combs()
    poly = np.stack([_gradvector((rs ** r) * (gs ** g) * (bs ** b))
                     for (r, g, b) in comb])          # (9, M)

    # weak order alf
    Rg = _gradvector(rs)
    Gg = _gradvector(gs)
    Bg = _gradvector(bs)
    level = 0.05
    alf = ((Rg > level) & (Gg > level) & (Bg > level)).astype(np.float64) \
        - ((Rg < -level) & (Gg < -level) & (Bg < -level))

    # update matrix X: solve (P P^T) X = P diag(Cg) with DECOMP_NORMAL
    P = poly.astype(np.float32)
    A = P @ P.T
    B = P * Cg[None, :].astype(np.float32)
    An = A.T @ A
    Bn = A.T @ B
    X = np.linalg.solve(An.astype(np.float64), Bn.astype(np.float64))

    # product(comb, [.33,.33,.33]) = .33*(r+g+b); zeroed unless order-1
    wei = np.array([0.33 * (c[0] + c[1] + c[2]) if sum(c) == 1 else 0.0
                    for c in comb])

    sq = _SIGMA * _SIGMA
    E = 0.0
    pre_E = np.inf
    for _ in range(16):
        if abs(E - pre_E) <= 1e-4 and pre_E != np.inf:
            break
        pre_E = E
        val = poly.T @ wei
        tpos = val - Cg
        tneg = val + Cg
        G_pos = ((1 + alf) / 2) * np.exp(-0.5 * tpos * tpos / sq)
        G_neg = ((1 - alf) / 2) * np.exp(-0.5 * tneg * tneg / sq)
        s = G_pos + G_neg
        EXPterm = (G_pos - G_neg) / (s + (s == 0))
        wei = X @ EXPterm
        # energy (energyCalcu): -log(exp(-t+²/σ) + exp(-t-²/σ)) averaged
        val = poly.T @ wei
        tpos = val - Cg
        tneg = val + Cg
        en = -np.log(np.exp(-tpos * tpos / _SIGMA)
                     + np.exp(-tneg * tneg / _SIGMA) + 1e-300)
        E = en.sum() / len(en)

    # reconstruct gray at full resolution
    bf, gf, rf = img[..., 0], img[..., 1], img[..., 2]
    gray = np.zeros((h, w), np.float32)
    for wk, (r, g, b) in zip(wei, comb):
        gray += np.float32(wk) * (rf ** r) * (gf ** g) * (bf ** b)
    mn, mx = float(gray.min()), float(gray.max())
    gray = (gray - mn) / max(mx - mn, 1e-12)
    dst = np.clip(np.rint(gray * 255.0), 0, 255).astype(np.uint8)

    # color boost: replace L of the original's Lab with the result
    lab8 = to_host(cvtColor(torch.from_numpy(I).to(dev), K.COLOR_BGR2Lab))
    lab8 = np.stack([dst, lab8[..., 1], lab8[..., 2]], -1)
    boost = cvtColor(torch.from_numpy(lab8.astype(np.uint8)).to(dev), K.COLOR_Lab2BGR)
    return torch.from_numpy(dst).to(dev), boost
