"""Non-local means denoising (photo/src/fast_nlmeans_denoising_invoker.hpp)
and TV-L1 denoising (photo/src/denoise_tvl1.cpp), twin of
``opencv_tpu/photo/denoise.py``.

NL-means as torch on the input's device, with the JAX package's loop over
the search window's static offsets: per offset, the channel sum of the
squared differences, its template-sized box sums, the weight
``exp(-d2 / (h² · template² · C))``, and the weighted sums ``acc`` and
``wsum`` added in offset order.

The box sums are exact.  The JAX package takes them as float32 box sums of a
float32 2-D cumulative sum over the whole padded plane, which cancel badly
once the prefix sums grow (at 1080p they reach 4.5e8, and the box sums are
off by up to 151 where they average 9,927).  Here integer input takes
separable window sums of the integer squared differences (int32 for u8:
49 · 3 · 255² = 9.6e6 at most, also below 2^24 as the float32 ``d2``),
exact on every device and with no scan (an int64 prefix sum of the plane
was half the path's time on the card), and float input takes float64
window sums (close, not exact).  The weight's ``exp``
is taken in float64 and rounded to float32, so the card and the CPU weigh
alike; the JAX package's float32 ``exp`` is XLA's own and differs from it by
an ulp on some pixels.  The result equals the JAX package's where its
float32 sums are exact and those ulps do not move a rounding.

``fastNlMeansDenoisingColored`` denoises the u8 Lab planes of the port's
``cvtColor`` (L with h, a and b with hColor) as one batch of three planes,
which is the JAX package's three calls elementwise.

``denoise_TVL1`` is the JAX package's float64 numpy solver, copied.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as K
from ..core.arrays import as_tensor, from_batched, to_batched, to_device, to_host
from ..core.borders import pad_nhwc
from ..core.fixedpoint import saturate_cast
from ..ops.color import cvtColor

__all__ = ["fastNlMeansDenoising", "fastNlMeansDenoisingColored",
           "fastNlMeansDenoisingMulti", "fastNlMeansDenoisingColoredMulti",
           "denoise_TVL1", "patch_distances"]


def _window_sum(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """The sums of k consecutive elements along `dim` (valid mode), by
    doubling: windows of 1, 2, 4, ... elements, added where k's bits are
    set (k = 7: 4 adds)."""
    n_out = x.shape[dim] - k + 1
    out, off, p, span = None, 0, x, 1
    while True:
        if k & span:
            part = p.narrow(dim, off, n_out)
            out = part if out is None else out + part
            off += span
        if 2 * span > k:
            return out
        n = p.shape[dim] - span
        p = p.narrow(dim, 0, n) + p.narrow(dim, span, n)
        span *= 2


def patch_distances(center: torch.Tensor, nb: torch.Tensor, tw: int) -> torch.Tensor:
    """float32 ``d2``: the tw×tw box sums of the channel-summed squared
    differences of two (N, H + tw - 1, W + tw - 1, C) planes, as separable
    window sums: exact for integer planes (int32 where tw² · C times the
    largest square fits, else int64), float64 sums for float ones."""
    if center.is_floating_point():
        wide = torch.float64
    else:
        info = torch.iinfo(center.dtype)
        span = info.max - info.min
        wide = torch.int32 if tw * tw * center.shape[-1] * span * span < 2 ** 31 else torch.int64
    diff = center.to(wide) - nb.to(wide)
    sq = diff * diff
    s = sq[..., :1]
    for c in range(1, sq.shape[-1]):
        s = s + sq[..., c:c + 1]
    return _window_sum(_window_sum(s, tw, 1), tw, 2).to(torch.float32)


def _weight(d2: torch.Tensor, inv_h2) -> torch.Tensor:
    """float32 exp(-d2 · inv_h2), the product in float32 as the JAX package
    takes it, the exp in float64 rounded to float32."""
    return torch.exp((-d2 * inv_h2).to(torch.float64)).to(torch.float32)


def _inv_h2(hs, tw: int, C: int, n: int, device) -> torch.Tensor:
    """Each plane's float32 1 / (h² · tw² · C), shaped (n, 1, 1, 1)."""
    hs = np.broadcast_to(np.asarray(hs, np.float64), (n,))
    v = np.array([1.0 / (h * h * tw * tw * C) for h in hs], np.float32)
    return to_device(v, device).reshape(n, 1, 1, 1)


def _nl_means(base: torch.Tensor, frames, hs, tw: int, sw: int) -> torch.Tensor:
    """NL-means of `base` (N, H, W, C) over the candidate planes of
    `frames` (each like base), offset by offset in the JAX package's order;
    `hs` is h, or one h per image of the batch."""
    tr, sr = tw // 2, sw // 2
    pad = tr + sr
    N, H, W, C = base.shape
    inv_h2 = _inv_h2(hs, tw, C, N, base.device)
    bp = pad_nhwc(base, pad, pad, pad, pad, K.BORDER_REFLECT)
    center = bp[:, sr:sr + H + 2 * tr, sr:sr + W + 2 * tr, :]
    acc = wsum = None
    for f in frames:
        fp = bp if f is base else pad_nhwc(f, pad, pad, pad, pad, K.BORDER_REFLECT)
        for dy in range(-sr, sr + 1):
            for dx in range(-sr, sr + 1):
                nb = fp[:, sr + dy:sr + dy + H + 2 * tr, sr + dx:sr + dx + W + 2 * tr, :]
                wgt = _weight(patch_distances(center, nb, tw), inv_h2)
                v = nb[:, tr:tr + H, tr:tr + W, :].to(torch.float32)
                acc = v * wgt if acc is None else acc + v * wgt
                wsum = wgt if wsum is None else wsum + wgt
    return saturate_cast(acc / wsum, base.dtype)


def fastNlMeansDenoising(src, h: float = 3.0, templateWindowSize: int = 7,
                         searchWindowSize: int = 21):
    x, meta = to_batched(src)
    out = _nl_means(x, (x,), h, templateWindowSize, searchWindowSize)
    return from_batched(out, meta)


def _nl_means_lab(frames, index: int, h, hColor, tw: int, sw: int):
    """BGR u8 frames → the port's u8 Lab → NL-means of frame `index` over
    the frames, its three planes as one batch (L with h, a and b with
    hColor) → Lab → BGR."""
    planes = [torch.stack([lab[..., c] for c in range(3)])[..., None]
              for lab in (cvtColor(f, K.COLOR_BGR2Lab) for f in frames)]
    out = _nl_means(planes[index], planes, (h, hColor, hColor), tw, sw)[..., 0]
    return cvtColor(torch.stack([out[0], out[1], out[2]], dim=-1), K.COLOR_Lab2BGR)


def fastNlMeansDenoisingColored(src, h: float = 3.0, hColor: float = 3.0,
                                templateWindowSize: int = 7,
                                searchWindowSize: int = 21):
    """The reference converts to CIELab and denoises L with h and ab with
    hColor (fast_nlmeans denoising_colored)."""
    return _nl_means_lab([as_tensor(src)], 0, h, hColor, templateWindowSize,
                         searchWindowSize)


def denoise_TVL1(observations, result=None, lambda_=1.0, niters=30):
    """Primal-dual TV-L1 denoising (photo/src/denoise_tvl1.cpp:59).

    Chambolle-Pock with the reference's constants (tau=0.02,
    sigma=1/(8 tau), theta=1) and its boundary conventions: the dual
    x-component vanishes on the last column, and the x-divergence term
    is dropped at x=0.  Float64 numpy on the host; the result is a u8
    tensor on the first observation's device."""
    dev = as_tensor(observations[0]).device
    obs = [to_host(o).astype(np.float64) / 255.0 for o in observations]
    tau = 0.02
    sigma = 1.0 / (8.0 * tau)
    clambda = float(lambda_)
    X = obs[0].copy()
    H, W = X.shape
    Px = np.zeros((H, W))
    Py = np.zeros((H, W))
    Rs = [np.zeros((H, W)) for _ in obs]
    for it in range(niters):
        cs = (1 + sigma) if it == 0 else sigma
        dx = np.zeros((H, W))
        dx[:, :-1] = (X[:, 1:] - X[:, :-1]) * cs + Px[:, :-1]
        dy = (np.vstack([X[1:], X[-1:]]) - X) * cs + Py
        m = np.maximum(np.hypot(dx, dy), 1.0)
        # last column: x-component forced to 0, y normalized alone
        m[:, -1] = np.maximum(np.abs(dy[:, -1]), 1.0)
        Px = dx / m
        Px[:, -1] = 0.0
        Py = dy / m
        s = np.zeros((H, W))
        for k, ob in enumerate(obs):
            Rs[k] = np.clip(Rs[k] + sigma * (X - ob), -clambda, clambda)
            s += Rs[k]
        divx = np.zeros((H, W))
        divx[:, 1:] = Px[:, 1:] - Px[:, :-1]
        divy = Py - np.vstack([Py[:1] * 0 + Py[:1], Py[:-1]])
        divy[0] = Py[0] - Py[0]   # p_prev = row 0 itself -> zero
        x_new = X + tau * (divx + divy) - tau * s
        X = 2.0 * x_new - X
    return torch.from_numpy(np.clip(X * 255.0 + 0.5, 0, 255).astype(np.uint8)).to(dev)


def fastNlMeansDenoisingMulti(srcImgs, imgToDenoiseIndex,
                              temporalWindowSize, h=3.0,
                              templateWindowSize=7, searchWindowSize=21):
    """Temporal NL-means (photo/src/denoising.cpp
    fastNlMeansDenoisingMulti): candidate patches come from every
    frame in the temporal window, weighted against the target frame's
    patches with the same kernel as the single-frame path."""
    half_t = temporalWindowSize // 2
    lo = imgToDenoiseIndex - half_t
    hi = imgToDenoiseIndex + half_t + 1
    frames = [to_batched(srcImgs[i])[0] for i in range(lo, hi)]
    x, meta = to_batched(srcImgs[imgToDenoiseIndex])
    frames = [f.to(x.device) for f in frames]
    out = _nl_means(frames[half_t], frames, h, templateWindowSize, searchWindowSize)
    return from_batched(out, meta)


def fastNlMeansDenoisingColoredMulti(srcImgs, imgToDenoiseIndex,
                                     temporalWindowSize, h=3.0,
                                     hColor=3.0, templateWindowSize=7,
                                     searchWindowSize=21):
    """Temporal colored NL-means (photo/src/denoising.cpp): convert the
    window to CIELab, denoise the L sequence with h and the a/b
    sequences with hColor, convert back."""
    half_t = temporalWindowSize // 2
    frames = [as_tensor(f) for f in srcImgs]
    frames = [f.to(frames[imgToDenoiseIndex].device) for f in frames]
    window = frames[imgToDenoiseIndex - half_t:imgToDenoiseIndex + half_t + 1]
    return _nl_means_lab(window, half_t, h, hColor, templateWindowSize, searchWindowSize)
