"""Non-photorealistic rendering filters (photo/src/npr.cpp, npr.hpp), twin
of ``opencv_tpu/photo/npr.py``.

All four entry points ride the Gastal-Oliveira domain transform, as torch
on the image's device.

The recursive filter's first-order recurrence y[j] = V[j]·y[j-1] +
(1 − V[j])·x[j] (compute_Rfilter, npr.hpp:172) runs as the JAX package's
``lax.associative_scan`` does, written out: :func:`_associative_scan` is its
combine tree, a log-depth sequence of whole-plane ops (11 levels at 1920
columns), not a loop over the columns.  Each multiply and add rounds on its
own, as in the JAX package run op by op (``jax.disable_jit()``), so the RF
filter equals that run exactly where the powers agree; the JAX package's
jitted program lets XLA contract the combine's multiply-adds, and differs
from it in the last bits.  ``V = a^d`` is taken in float64 and rounded to
float32: the correctly rounded power, the same on every device.  XLA's
float32 power on the CPU is glibc's ``powf``, which misses it by an ulp on
about 0.1% of its inputs.

The normalized-convolution filter's box bounds (compute_boxfilter,
npr.hpp:216) are ``torch.searchsorted(..., right=True)`` over the domain
transform's prefix sums ``ct_H`` and ``ct_V``, taken in float64, as are the
image's running sums: the JAX package's float32 cumulative sums are not a
sequential loop on XLA's CPU, and an ulp there moves a box edge by a column
on some pixels (the tests state the share).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.arrays import as_tensor
from ..ops.color import cvtColor
from .. import constants as K

__all__ = ["edgePreservingFilter", "detailEnhance", "stylization",
           "pencilSketch", "RECURS_FILTER", "NORMCONV_FILTER"]

RECURS_FILTER = 1
NORMCONV_FILTER = 2

_SQRT3 = float(np.sqrt(3.0))


def _f32(v: float, device) -> torch.Tensor:
    """A float32 0-dim tensor made on `device` (a copy from the host would
    wait for the queue; a division by a host scalar on the card is a product
    with its reciprocal)."""
    return torch.full((), v, dtype=torch.float32, device=device)


def _domain_derivs(img, sigma_s, sigma_r):
    """horiz/vert domain-transform derivatives (npr.hpp init:420-455):
    1 + (sigma_s/sigma_r) * sum_c |d I|, the channels summed in order."""
    ax = (img[:, 1:] - img[:, :-1]).abs()                # (h, w-1, C)
    ay = (img[1:] - img[:-1]).abs()                      # (h-1, w, C)
    dx, dy = ax[..., 0], ay[..., 0]
    for c in range(1, img.shape[-1]):
        dx, dy = dx + ax[..., c], dy + ay[..., c]
    distx = torch.nn.functional.pad(dx, (1, 0))
    disty = torch.nn.functional.pad(dy, (0, 0, 1, 0))
    k = _f32(sigma_s / sigma_r, img.device)
    one = _f32(1.0, img.device)
    return one + k * distx, one + k * disty


def _associative_scan(a, b):
    """``lax.associative_scan`` of combine((a1, b1), (a2, b2)) = (a1·a2,
    a2·b1 + b2) along axis 1, with the JAX package's tree: combine adjacent
    pairs, scan the pairs, fill in the even elements, interleave."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = a[:, 0:-1:2] * a[:, 1::2], a[:, 1::2] * b[:, 0:-1:2] + b[:, 1::2]
    oa, ob = _associative_scan(ra, rb)
    if n % 2 == 0:
        pa, pb = oa[:, :-1], ob[:, :-1]
    else:
        pa, pb = oa, ob
    ea = pa * a[:, 2::2]
    eb = a[:, 2::2] * pb + b[:, 2::2]
    out_a, out_b = torch.empty_like(a), torch.empty_like(b)
    out_a[:, 0], out_b[:, 0] = a[:, 0], b[:, 0]
    out_a[:, 2::2], out_b[:, 2::2] = ea, eb
    out_a[:, 1::2], out_b[:, 1::2] = oa, ob
    return out_a, out_b


def _iir_scan(x, V):
    """y[j] = V[j]*y[j-1] + (1-V[j])*x[j] along axis 1 through the
    associative scan; matches the reference's in-place forward pass."""
    a = V[..., None] * torch.ones_like(x)
    b = (_f32(1.0, x.device) - V[..., None]) * x
    # first element passes through unchanged (loop starts at j=1)
    a[:, 0] = 0.0
    b[:, 0] = x[:, 0]
    return _associative_scan(a, b)[1]


def _rfilter(x, horiz, sigma_h):
    a = np.exp(np.float64(np.float32(-np.sqrt(2.0) / sigma_h)))
    base = torch.full((), float(np.float32(a)), dtype=torch.float64, device=x.device)
    V = torch.pow(base, horiz.to(torch.float64)).to(torch.float32)
    y = _iir_scan(x, V)
    # backward pass: y[j] += (y[j+1]-y[j]) * V[j+1], right to left
    Vb = torch.cat([V[:, :1] * 0, V.flip(1)[:, :-1]], dim=1)
    return _iir_scan(y.flip(1), Vb).flip(1)


def _sigma_h(sigma_s: float, i: int, iters: int) -> float:
    return sigma_s * _SQRT3 * (2.0 ** (iters - (i + 1))) / np.sqrt(4.0 ** iters - 1)


def _edge_preserving_rf(img, horiz, vert, sigma_s, iters=3):
    O = img
    for i in range(iters):
        sigma_h = _sigma_h(sigma_s, i, iters)
        O = _rfilter(O, horiz, sigma_h)
        O = _rfilter(O.transpose(0, 1), vert.T, sigma_h).transpose(0, 1)
    return O


def _box_indices(ct, radius):
    """(lo, hi) searchsorted bounds over the float64 domain transform rows
    (compute_boxfilter, npr.hpp:216): first k with ct[k] > pos."""
    h, w = ct.shape
    dom = torch.cat([ct, torch.full((h, 1), float("inf"), dtype=ct.dtype, device=ct.device)],
                    dim=1).contiguous()
    lo = torch.searchsorted(dom, (ct - radius).contiguous(), right=True)
    hi = torch.searchsorted(dom, (ct + radius).contiguous(), right=True)
    return lo, hi


def _ncfilter(x, ct, radius):
    h, w, C = x.shape
    lo, hi = _box_indices(ct, radius)
    sat = torch.cat([torch.zeros((h, 1, C), dtype=torch.float64, device=x.device),
                     torch.cumsum(x.to(torch.float64), dim=1)], dim=1)
    num = (torch.take_along_dim(sat, hi[..., None], dim=1)
           - torch.take_along_dim(sat, lo[..., None], dim=1)).to(torch.float32)
    cnt = (hi - lo).to(torch.float32)[..., None]
    return num / torch.clamp(cnt, min=1.0)


def _edge_preserving_nc(img, ct_H, ct_V, sigma_s, iters=3):
    O = img
    for i in range(iters):
        radius = _SQRT3 * _sigma_h(sigma_s, i, iters)
        O = _ncfilter(O, ct_H, radius)
        O = _ncfilter(O.transpose(0, 1), ct_V.T, radius).transpose(0, 1)
    return O


def _prep(src, sigma_s, sigma_r, need_ct):
    x = as_tensor(src)
    img = x.to(torch.float32) / _f32(255.0, x.device)
    horiz, vert = _domain_derivs(img, sigma_s, sigma_r)
    if need_ct:
        ct_H = torch.cumsum(horiz.to(torch.float64), dim=1)
        ct_V = torch.cumsum(vert.to(torch.float64), dim=0)
        return img, horiz, vert, ct_H, ct_V
    return img, horiz, vert, None, None


def _to_u8(x):
    return torch.clamp(torch.round(x * _f32(255.0, x.device)), 0, 255).to(torch.uint8)


def edgePreservingFilter(src, dst=None, flags: int = RECURS_FILTER,
                         sigma_s: float = 60, sigma_r: float = 0.4):
    """photo/src/npr.cpp:52."""
    img, horiz, vert, ct_H, ct_V = _prep(src, sigma_s, sigma_r,
                                         flags == NORMCONV_FILTER)
    if flags == NORMCONV_FILTER:
        out = _edge_preserving_nc(img, ct_H, ct_V, float(sigma_s))
    else:
        out = _edge_preserving_rf(img, horiz, vert, float(sigma_s))
    return _to_u8(out)


def detailEnhance(src, dst=None, sigma_s: float = 10, sigma_r: float = 0.15):
    """photo/src/npr.cpp:69: RF-filter the Lab L channel, amplify the
    residual by 3."""
    x = as_tensor(src)
    dev = x.device
    img = x.to(torch.float32) / _f32(255.0, dev)
    lab = cvtColor(img, K.COLOR_BGR2Lab)
    L = lab[..., 0] / _f32(255.0, dev)
    horiz, vert = _domain_derivs(L[..., None], sigma_s, sigma_r)
    res = _edge_preserving_rf(L[..., None], horiz, vert, float(sigma_s))[..., 0]
    L2 = (res + _f32(3.0, dev) * (L - res)) * _f32(255.0, dev)
    lab = torch.stack([L2, lab[..., 1], lab[..., 2]], dim=-1)
    return _to_u8(cvtColor(lab, K.COLOR_Lab2BGR))


def stylization(src, dst=None, sigma_s: float = 60, sigma_r: float = 0.45):
    """photo/src/npr.cpp:131: NC filter then scale by (1 - |Sobel grad|)."""
    from ..ops.deriv import Sobel

    img, _, _, ct_H, ct_V = _prep(src, sigma_s, sigma_r, True)
    res = _edge_preserving_nc(img, ct_H, ct_V, float(sigma_s))
    # find_magnitude (npr.hpp:134): per-channel Sobel-3 magnitudes summed;
    # the square root in float64, rounded (torch's float32 sqrt on the CPU
    # may miss the correctly rounded value by an ulp)
    mag = torch.zeros(res.shape[:2], dtype=torch.float32, device=res.device)
    for c in range(3):
        gx = Sobel(res[..., c], K.CV_32F, 1, 0, ksize=3)
        gy = Sobel(res[..., c], K.CV_32F, 0, 1, ksize=3)
        mag = mag + torch.sqrt((gx * gx + gy * gy).to(torch.float64)).to(torch.float32)
    mag = _f32(1.0, res.device) - mag
    return _to_u8(res * mag[..., None])


def pencilSketch(src, dst1=None, dst2=None, sigma_s: float = 60,
                 sigma_r: float = 0.07, shade_factor: float = 0.02):
    """photo/src/npr.cpp:105 / pencil_sketch (npr.hpp:533): the sketch is
    shade_factor * (horizontal + vertical box-filter footprint counts) at
    the first (widest) iteration radius."""
    img, _, _, ct_H, ct_V = _prep(src, sigma_s, sigma_r, True)
    radius = _SQRT3 * _sigma_h(float(sigma_s), 0, 3)
    lox, hix = _box_indices(ct_H, radius)
    loy, hiy = _box_indices(ct_V.T, radius)
    pen = _f32(shade_factor, img.device) * ((hix - lox) + (hiy - loy).T).to(torch.float32)
    sketch = _to_u8(pen)
    ycrcb = cvtColor(img, K.COLOR_BGR2YCrCb)
    ycrcb = torch.stack([torch.clamp(pen, 0, 1), ycrcb[..., 1], ycrcb[..., 2]], dim=-1)
    color = cvtColor(ycrcb, K.COLOR_YCrCb2BGR)
    return sketch, _to_u8(color)
