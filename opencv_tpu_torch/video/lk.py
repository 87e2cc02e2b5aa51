"""Pyramidal Lucas-Kanade sparse optical flow (video/src/lkpyramid.cpp);
twin of ``opencv_tpu/video/lk.py``.

Every keypoint iterates in lockstep on the image's device: the (2h+1)²
windows are bilinear gathers of all points at once, the 2×2 normal
equations are solved in closed form elementwise, and each level runs all
``criteria[1]`` iterations (the JAX package computes the epsilon test and
never stops on it, so the port does not either).  The u8 pyramids of both
images come from one ``pyrDown`` of the pair per level (the ``pyr_down``
kernel on a CUDA tensor, N = 2).  ``err`` is zero and ``status`` is the
minimum-eigenvalue test of every level and the final point's bounds, as in
the JAX package.

The window sums add the 441 (at 21×21) products in a fixed binary tree
(:func:`_wsum`), the same on every device, so the card's points are the
CPU's; XLA adds them one after another (in its jitted program as fused
multiply-adds), so against the JAX package the points agree within the
bound that ROADMAP.md queue C states.  sqrt is taken in f64 and rounded
(correctly rounded on both devices), and the one division by a constant
divides by a device tensor (CUDA would multiply by the reciprocal)."""

from __future__ import annotations

import numpy as np
import torch

from ..core.arrays import as_tensor, to_device, to_host
from ..ops.pyramids import pyrDown

__all__ = ["calcOpticalFlowPyrLK", "SparsePyrLKOpticalFlow",
           "SparsePyrLKOpticalFlow_create"]

_F32 = torch.float32


def _scharr_deriv(img):
    """(H, W) f32 → dx, dy with the LK derivative kernel: [3 10 3]
    smoothing ⊗ [-1 0 1], over 32 (calcScharrDeriv), replicated borders."""
    H, W = img.shape
    p = torch.nn.functional.pad(img[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    sv = 3 * p[0:H, :] + 10 * p[1:H + 1, :] + 3 * p[2:H + 2, :]
    dx = (sv[:, 2:W + 2] - sv[:, 0:W]) * (1.0 / 32.0)
    sh = 3 * p[:, 0:W] + 10 * p[:, 1:W + 1] + 3 * p[:, 2:W + 2]
    dy = (sh[2:H + 2, :] - sh[0:H, :]) * (1.0 / 32.0)
    return dx, dy


def _bilinear_window(img, cx, cy, half: int):
    """The (2h+1)² window around the float centre (cx, cy) of every point at
    once, bilinearly interpolated with clamped taps.  img: (H, W) f32; cx,
    cy: (K,) f32 → (K, win, win) f32."""
    H, W = img.shape
    x0 = torch.floor(cx)
    y0 = torch.floor(cy)
    ax = (cx - x0)[:, None, None]
    ay = (cy - y0)[:, None, None]
    off = torch.arange(-half, half + 1, device=img.device)
    gx = (x0[:, None] + off[None, :]).to(torch.int64)        # (K, win)
    gy = (y0[:, None] + off[None, :]).to(torch.int64)
    gx0, gx1 = gx.clamp(0, W - 1), (gx + 1).clamp(0, W - 1)
    gy0, gy1 = gy.clamp(0, H - 1), (gy + 1).clamp(0, H - 1)
    flat = img.reshape(-1)

    def g(yy, xx):
        return flat[yy[:, :, None] * W + xx[:, None, :]]

    return (g(gy0, gx0) * (1 - ax) * (1 - ay) + g(gy0, gx1) * ax * (1 - ay)
            + g(gy1, gx0) * (1 - ax) * ay + g(gy1, gx1) * ax * ay)


def _wsum(a):
    """The sum of each (win, win) window of `a` (K, win, win): the values
    padded with zeros to a power of two and halved pairwise, a fixed order
    on every device."""
    v = a.reshape(a.shape[0], -1)
    n = 1 << max(v.shape[1] - 1, 0).bit_length()
    if n != v.shape[1]:
        v = torch.nn.functional.pad(v, (0, n - v.shape[1]))
    while v.shape[1] > 1:
        h = v.shape[1] // 2
        v = v[:, :h] + v[:, h:]
    return v[:, 0]


def _sqrt32(v):
    """The correctly rounded f32 square root on every device."""
    return torch.sqrt(v.to(torch.float64)).to(_F32)


def _lk_level(prev_img, next_img, dx, dy, pts_prev, guess, half: int, iters: int,
              min_eig_thresh: float):
    """One pyramid level's refinement of all K points: (points, ok)."""
    Iw = _bilinear_window(prev_img, pts_prev[:, 0], pts_prev[:, 1], half)
    Ixw = _bilinear_window(dx, pts_prev[:, 0], pts_prev[:, 1], half)
    Iyw = _bilinear_window(dy, pts_prev[:, 0], pts_prev[:, 1], half)
    a11 = _wsum(Ixw * Ixw)
    a12 = _wsum(Ixw * Iyw)
    a22 = _wsum(Iyw * Iyw)
    det = a11 * a22 - a12 * a12
    area2 = torch.full((), 2 * (2 * half + 1) ** 2, dtype=_F32, device=det.device)
    t = a11 - a22
    min_eig = (a22 + a11 - _sqrt32(t * t + 4 * a12 * a12)) / area2
    ok = (min_eig > np.float32(min_eig_thresh)) & (det > 1e-6)
    inv_det = torch.where(det != 0, torch.ones_like(det) / det, torch.zeros_like(det))
    cur = guess
    for _ in range(iters):
        Jw = _bilinear_window(next_img, cur[:, 0], cur[:, 1], half)
        it = Jw - Iw
        b1 = _wsum(it * Ixw)
        b2 = _wsum(it * Iyw)
        du = -(a22 * b1 - a12 * b2) * inv_det
        dv = -(a11 * b2 - a12 * b1) * inv_det
        delta = torch.stack([du, dv], dim=1)
        cur = cur + torch.where(ok[:, None], delta, torch.zeros_like(delta))
    return cur, ok


def _gray_u8(img):
    """(H, W) u8 of an (H, W) or (H, W, C) image: channel 0, as the JAX
    package reads its level 0."""
    t = as_tensor(img)
    return t[..., 0] if t.ndim == 3 else t


def calcOpticalFlowPyrLK(prevImg, nextImg, prevPts, nextPts=None,
                         winSize=(21, 21), maxLevel: int = 3,
                         criteria=(3, 30, 0.01), flags: int = 0,
                         minEigThreshold: float = 1e-4):
    """cv2-compatible sparse LK on the images' device.  Returns (nextPts
    (K, 1, 2) f32, status (K, 1) u8, err (K, 1) f32) as host numpy arrays:
    the points and status are read back once."""
    a = _gray_u8(prevImg)
    b = _gray_u8(nextImg).to(a.device)
    p0 = to_device(to_host(prevPts).astype(np.float32).reshape(-1, 2), a.device)
    K = p0.shape[0]
    if K == 0:
        return (np.zeros((0, 1, 2), np.float32), np.zeros((0, 1), np.uint8),
                np.zeros((0, 1), np.float32))
    H0, W0 = a.shape
    half = winSize[0] // 2
    # like buildOpticalFlowPyramid: stop when a level can't hold the window
    while maxLevel > 0 and min(H0, W0) / (2 ** maxLevel) < 3 * half:
        maxLevel -= 1
    pair = torch.stack([a, b])[..., None]
    levels = [pair[..., 0].to(_F32)]
    for _ in range(maxLevel):
        pair = pyrDown(pair)
        levels.append(pair[..., 0].to(_F32))

    iters = int(criteria[1]) if len(criteria) > 1 else 30

    guess = p0 / (2.0 ** maxLevel)
    ok_all = torch.ones(K, dtype=torch.bool, device=a.device)
    for lv in range(maxLevel, -1, -1):
        plv = p0 / (2.0 ** lv)
        prev_l, next_l = levels[lv][0], levels[lv][1]
        dx, dy = _scharr_deriv(prev_l)
        guess, ok = _lk_level(prev_l, next_l, dx, dy, plv, guess, half, iters,
                              minEigThreshold)
        ok_all = ok_all & ok
        if lv > 0:
            guess = guess * 2.0

    host = torch.cat([guess, ok_all[:, None].to(_F32)], dim=1).cpu().numpy()
    g, ok_host = host[:, :2], host[:, 2] > 0
    inb = (g[:, 0] >= 0) & (g[:, 0] < W0) & (g[:, 1] >= 0) & (g[:, 1] < H0)
    status = (ok_host & inb).astype(np.uint8).reshape(-1, 1)
    err = np.zeros((K, 1), np.float32)
    return g.reshape(-1, 1, 2).astype(np.float32), status, err


class SparsePyrLKOpticalFlow:
    """Algorithm wrapper over calcOpticalFlowPyrLK (lkpyramid.hpp)."""

    def __init__(self, winSize=(21, 21), maxLevel=3,
                 crit=(3, 30, 0.01), flags=0, minEigThreshold=1e-4):
        self._win = tuple(winSize)
        self._max = int(maxLevel)
        self._crit = crit
        self._flags = int(flags)
        self._minEig = float(minEigThreshold)

    def calc(self, prevImg, nextImg, prevPts, nextPts=None, status=None,
             err=None):
        return calcOpticalFlowPyrLK(prevImg, nextImg, prevPts, nextPts,
                                    winSize=self._win,
                                    maxLevel=self._max,
                                    criteria=self._crit,
                                    flags=self._flags,
                                    minEigThreshold=self._minEig)

    def getWinSize(self):
        return self._win

    def setWinSize(self, w):
        self._win = tuple(w)

    def getMaxLevel(self):
        return self._max

    def setMaxLevel(self, m):
        self._max = int(m)

    def getTermCriteria(self):
        return self._crit

    def setTermCriteria(self, c):
        self._crit = c

    def getFlags(self):
        return self._flags

    def setFlags(self, f):
        self._flags = int(f)

    def getMinEigThreshold(self):
        return self._minEig

    def setMinEigThreshold(self, v):
        self._minEig = float(v)

    def empty(self):
        return False

    def getDefaultName(self):
        return "SparseOpticalFlow.SparsePyrLKOpticalFlow"


def SparsePyrLKOpticalFlow_create(winSize=(21, 21), maxLevel=3,
                                  crit=(3, 30, 0.01), flags=0,
                                  minEigThreshold=1e-4):
    return SparsePyrLKOpticalFlow(winSize, maxLevel, crit, flags,
                                  minEigThreshold)
