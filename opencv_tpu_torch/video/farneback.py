"""Dense optical flow, Farnebäck polynomial-expansion method
(video/src/optflowgf.cpp: FarnebackPolyExp:117, FarnebackUpdateMatrices:218,
FarnebackUpdateFlow_Blur:344, calc:1100); twin of
``opencv_tpu/video/farneback.py``, as eager torch on the input's device.

- the polynomial expansion is two separable passes of the {g, xg, xxg}
  kernel bank over replicated borders, each tap sum the chain of fused
  multiply-adds that XLA's CPU einsum takes (each product exact in f64,
  each step rounded to f32), so it equals the JAX package's;
- the displaced-coefficient update is a bilinear gather;
- the (winsize+1)-wide replicate box blur of the 5-channel M tensor is a
  difference of 2-D prefix sums, taken here in f64 and rounded to f32: f32
  prefixes of a whole level cancel badly, and the card's parallel scan
  rounds them in another order than the CPU's loop, so in f32 the card and
  the CPU would disagree wherever the cancellation is large; in f64 both
  agree to the last f32 bit but for rare ties.  The JAX package sums in f32
  (and jits the level, contracting multiply-adds), so the port is held to it
  under the bound of ROADMAP.md queue C;
- the 2×2 solve is elementwise.

The semantic divergence from the reference is the JAX package's: M is
refreshed from the fully updated flow, not in row stripes."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.arrays import as_tensor, to_device

__all__ = ["calcOpticalFlowFarneback", "FarnebackOpticalFlow_create"]

_F32, _F64 = torch.float32, torch.float64
_BORDER = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472], np.float32)


def _prepare_gaussian(n: int, sigma: float):
    """g / xg / xxg kernels and the four inverse-Gram entries
    (optflowgf.cpp FarnebackPrepareGaussian:60)."""
    if sigma < 1e-7:
        sigma = n * 0.3
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-x * x / (2 * sigma * sigma)).astype(np.float32)
    g = (g / g.sum()).astype(np.float32)
    xg = (x * g).astype(np.float32)
    xxg = (x * x * g).astype(np.float32)

    G = np.zeros((6, 6))
    gy = g[:, None].astype(np.float64)
    gx = g[None, :].astype(np.float64)
    xx = x[None, :] ** 2
    yy = x[:, None] ** 2
    w = gy * gx
    G[0, 0] = w.sum()
    G[1, 1] = (w * xx).sum()
    G[3, 3] = (w * xx * xx).sum()
    G[5, 5] = (w * xx * yy).sum()
    G[2, 2] = G[0, 3] = G[0, 4] = G[3, 0] = G[4, 0] = G[1, 1]
    G[4, 4] = G[3, 3]
    G[3, 4] = G[4, 3] = G[5, 5]
    invG = np.linalg.inv(G)
    return g, xg, xxg, invG[1, 1], invG[0, 3], invG[3, 3], invG[5, 5]


def _taps(kern, planes):
    """Σ_k kern[k]·planes[k] as XLA's CPU einsum ``k,khw->hw`` takes it:
    fma(kern[k], planes[k], acc) in order, each product exact in f64 and
    each step rounded to f32."""
    acc = None
    for k, c in enumerate(np.asarray(kern, np.float32)):
        t = planes(k).to(_F64) * float(c)
        acc = t.to(_F32) if acc is None else (acc.to(_F64) + t).to(_F32)
    return acc


def _pad_edge(img, top, bottom, left, right, mode="replicate"):
    return F.pad(img[None, None], (left, right, top, bottom), mode=mode)[0, 0]


def _poly_exp(img, n: int, sigma: float):
    """(H, W) f32 → (H, W, 5) expansion coefficients, in the reference's
    channel order (optflowgf.cpp:195-200): 0 ~ y, 1 ~ x, 2 ~ y², 3 ~ x²,
    4 ~ xy."""
    g, xg, xxg, ig11, ig03, ig33, ig55 = _prepare_gaussian(n, sigma)
    H, W = img.shape
    # vertical pass with replicated rows, then horizontal with replicated
    # columns
    pv = _pad_edge(img, n, n, 0, 0)
    t0, t1, t2 = (_taps(k, lambda i: pv[i:i + H]) for k in (g, xg, xxg))

    def hpass(t, kern):
        ph = _pad_edge(t, 0, 0, n, n)
        return _taps(kern, lambda i: ph[:, i:i + W])

    b1 = hpass(t0, g)
    b2 = hpass(t0, xg)
    b4 = hpass(t0, xxg)
    b3 = hpass(t1, g)
    b6 = hpass(t1, xg)
    b5 = hpass(t2, g)
    ig11, ig03, ig33, ig55 = (np.float32(v) for v in (ig11, ig03, ig33, ig55))
    return torch.stack([
        b3 * ig11,                 # y
        b2 * ig11,                 # x
        b1 * ig03 + b5 * ig33,     # y^2
        b1 * ig03 + b4 * ig33,     # x^2
        b6 * ig55,                 # xy
    ], dim=-1)


def _border_scale(n: int) -> np.ndarray:
    """The reference's down-weighting of the 5 rows or columns at each
    edge of a level of n."""
    k = min(5, n)
    s = np.ones(n, np.float32)
    s[:k] = _BORDER[:k]
    s[n - k:] = _BORDER[:k][::-1]
    return s


def _update_matrices(R0, R1, flow, scale):
    """FarnebackUpdateMatrices (optflowgf.cpp:218): the 5-channel
    normal-equation tensor M from the two expansions and the current flow;
    `scale` is the (H, W) border down-weighting."""
    H, W = flow.shape[:2]
    dev = flow.device
    ys = torch.arange(H, device=dev, dtype=torch.int32)[:, None]
    xs = torch.arange(W, device=dev, dtype=torch.int32)[None, :]
    dx = flow[..., 0]
    dy = flow[..., 1]
    fx = xs + dx
    fy = ys + dy
    x1 = torch.floor(fx)
    y1 = torch.floor(fy)
    rx = fx - x1
    ry = fy - y1
    x1i = x1.to(torch.int64)
    y1i = y1.to(torch.int64)
    valid = (x1i >= 0) & (x1i < W - 1) & (y1i >= 0) & (y1i < H - 1)
    x1c = x1i.clamp(0, W - 2)
    y1c = y1i.clamp(0, H - 2)

    flat = R1.reshape(-1, 5)
    base = y1c * W + x1c
    p00 = flat[base]
    p01 = flat[base + 1]
    p10 = flat[base + W]
    p11 = flat[base + W + 1]
    a00 = ((1 - rx) * (1 - ry))[..., None]
    a01 = (rx * (1 - ry))[..., None]
    a10 = ((1 - rx) * ry)[..., None]
    a11 = (rx * ry)[..., None]
    fetched = a00 * p00 + a01 * p01 + a10 * p10 + a11 * p11

    zero = torch.zeros((), dtype=_F32, device=dev)
    r2 = torch.where(valid, fetched[..., 0], zero)
    r3 = torch.where(valid, fetched[..., 1], zero)
    r4 = torch.where(valid, (R0[..., 2] + fetched[..., 2]) * 0.5, R0[..., 2])
    r5 = torch.where(valid, (R0[..., 3] + fetched[..., 3]) * 0.5, R0[..., 3])
    r6 = torch.where(valid, (R0[..., 4] + fetched[..., 4]) * 0.25, R0[..., 4] * 0.5)

    r2 = (R0[..., 0] - r2) * 0.5
    r3 = (R0[..., 1] - r3) * 0.5
    r2 = r2 + r4 * dy + r6 * dx
    r3 = r3 + r6 * dy + r5 * dx

    # border down-weighting (optflowgf.cpp:295-302)
    r2, r3, r4, r5, r6 = (r * scale for r in (r2, r3, r4, r5, r6))
    return torch.stack([
        r4 * r4 + r6 * r6,
        (r4 + r5) * r6,
        r5 * r5 + r6 * r6,
        r4 * r2 + r6 * r3,
        r6 * r2 + r5 * r3,
    ], dim=-1)


def _box_blur_m(M, m: int, area):
    """The replicate-border running box of FarnebackUpdateFlow_Blur: the
    window is [i-m-1, i+m] × [j-m-1, j+m] (width 2m+2), scaled by
    1/(2m+1)² as in the reference; the prefix sums in f64."""
    H, W = M.shape[:2]
    P = F.pad(M.permute(2, 0, 1)[None], (m + 1, m, m + 1, m), mode="replicate")[0]
    c = torch.cumsum(torch.cumsum(P.to(_F64), dim=1), dim=2)
    c = F.pad(c, (1, 0, 1, 0))
    k = 2 * m + 2
    s = (c[:, k:k + H, k:k + W] - c[:, k:k + H, 0:W]
         - c[:, 0:H, k:k + W] + c[:, 0:H, 0:W])
    return (s.to(_F32) / area).permute(1, 2, 0)


def _solve_flow(Mb, eps):
    g11 = Mb[..., 0]
    g12 = Mb[..., 1]
    g22 = Mb[..., 2]
    h1 = Mb[..., 3]
    h2 = Mb[..., 4]
    idet = torch.ones_like(g11) / (g11 * g22 - g12 * g12 + eps)
    return torch.stack([(g11 * h2 - g12 * h1) * idet,
                        (g22 * h1 - g12 * h2) * idet], dim=-1)


def _flow_level(I0, I1, flow, winsize: int, iters: int, poly_n: int, poly_sigma: float):
    H, W = I0.shape
    dev = I0.device
    R0 = _poly_exp(I0, poly_n, poly_sigma)
    R1 = _poly_exp(I1, poly_n, poly_sigma)
    m = winsize // 2
    scale = to_device(_border_scale(H)[:, None] * _border_scale(W)[None, :], dev)
    area = torch.full((), float((2 * m + 1) ** 2), dtype=_F32, device=dev)
    eps = torch.full((), 1e-3, dtype=_F32, device=dev)
    M = _update_matrices(R0, R1, flow, scale)
    for i in range(iters):
        flow = _solve_flow(_box_blur_m(M, m, area), eps)
        if i < iters - 1:
            M = _update_matrices(R0, R1, flow, scale)
    return flow


def _resize_linear(img, w: int, h: int):
    """float bilinear resize with INTER_LINEAR's pixel-centre convention
    (the pyramid's own; coordinates in f32 as the JAX package computes
    them)."""
    H, W = img.shape[:2]
    dev = img.device
    sx, sy = W / w, H / h
    xs = (torch.arange(w, device=dev) + 0.5) * sx - 0.5
    ys = (torch.arange(h, device=dev) + 0.5) * sy - 0.5
    x0 = torch.floor(xs).clamp(0, W - 1).to(torch.int64)
    y0 = torch.floor(ys).clamp(0, H - 1).to(torch.int64)
    x1 = (x0 + 1).clamp(0, W - 1)
    y1 = (y0 + 1).clamp(0, H - 1)
    ax = (xs - x0).clamp(0.0, 1.0)
    ay = (ys - y0).clamp(0.0, 1.0)
    i00 = img[y0[:, None], x0[None, :]]
    i01 = img[y0[:, None], x1[None, :]]
    i10 = img[y1[:, None], x0[None, :]]
    i11 = img[y1[:, None], x1[None, :]]
    if img.ndim == 2:
        axx = ax[None, :]
        ayy = ay[:, None]
    else:
        axx = ax[None, :, None]
        ayy = ay[:, None, None]
    return (i00 * (1 - axx) + i01 * axx) * (1 - ayy) + (i10 * (1 - axx) + i11 * axx) * ayy


def _gaussian_blur_f32(img, ksize: int, sigma: float):
    """The f32 Gaussian of the pyramid: REFLECT_101 borders (numpy's
    "reflect"), the taps summed as :func:`_taps`."""
    n = ksize // 2
    x = np.arange(-n, n + 1, dtype=np.float64)
    k = np.exp(-x * x / (2 * sigma * sigma))
    k = (k / k.sum()).astype(np.float32)
    H, W = img.shape
    p = _pad_edge(img, n, n, 0, 0, mode="reflect")
    v = _taps(k, lambda i: p[i:i + H])
    p = _pad_edge(v, 0, 0, n, n, mode="reflect")
    return _taps(k, lambda i: p[:, i:i + W])


def _plane_f32(a):
    t = as_tensor(a)
    if t.ndim == 3:
        t = t[..., 0]
    return t.to(_F32)


def calcOpticalFlowFarneback(prev, next, flow=None, pyr_scale=0.5, levels=5,
                             winsize=13, iterations=10, poly_n=5,
                             poly_sigma=1.1, flags=0):
    """Dense Farnebäck flow (video/src/optflowgf.cpp:1100) on the images'
    device.  Returns the (H, W, 2) float32 flow mapping prev → next, a
    tensor there."""
    p = _plane_f32(prev)
    nx = _plane_f32(next).to(p.device)
    H0, W0 = p.shape
    min_size = 32

    nlevels = 0
    scale = 1.0
    for k in range(levels):
        scale *= pyr_scale
        if W0 * scale < min_size or H0 * scale < min_size:
            break
        nlevels = k + 1

    prev_flow = None
    for k in range(nlevels, -1, -1):
        scale = pyr_scale ** k
        sigma = (1.0 / scale - 1) * 0.5
        smooth_sz = max(int(round(sigma * 5)) | 1, 3)
        w = int(round(W0 * scale))
        h = int(round(H0 * scale))

        if prev_flow is None:
            if flags & 4 and flow is not None:  # OPTFLOW_USE_INITIAL_FLOW
                f = as_tensor(flow).to(device=p.device, dtype=_F32)
                f = _resize_linear(f, w, h) * np.float32(scale)
            else:
                f = torch.zeros((h, w, 2), dtype=_F32, device=p.device)
        else:
            f = _resize_linear(prev_flow, w, h) * np.float32(1.0 / pyr_scale)

        if k > 0:
            I0 = _resize_linear(_gaussian_blur_f32(p, smooth_sz, sigma), w, h)
            I1 = _resize_linear(_gaussian_blur_f32(nx, smooth_sz, sigma), w, h)
        else:
            I0, I1 = p, nx

        f = _flow_level(I0, I1, f, winsize, iterations, poly_n, float(poly_sigma))
        prev_flow = f

    return prev_flow


class _FarnebackOpticalFlow:
    def __init__(self, numLevels=5, pyrScale=0.5, fastPyramids=False,
                 winSize=13, numIters=10, polyN=5, polySigma=1.1, flags=0):
        self.numLevels = numLevels
        self.pyrScale = pyrScale
        self.winSize = winSize
        self.numIters = numIters
        self.polyN = polyN
        self.polySigma = polySigma
        self.flags = flags

    def calc(self, I0, I1, flow=None):
        return calcOpticalFlowFarneback(
            I0, I1, flow, self.pyrScale, self.numLevels, self.winSize,
            self.numIters, self.polyN, self.polySigma, self.flags)


def FarnebackOpticalFlow_create(numLevels=5, pyrScale=0.5, fastPyramids=False,
                                winSize=13, numIters=10, polyN=5,
                                polySigma=1.1, flags=0):
    return _FarnebackOpticalFlow(numLevels, pyrScale, fastPyramids, winSize,
                                 numIters, polyN, polySigma, flags)
