"""AKAZE (features2d/src/kaze/AKAZEFeatures.cpp, Alcantarilla et al.
ICCV 2013 "Fast Explicit Diffusion for Accelerated Features in
Nonlinear Scale Spaces"), twin of ``opencv_tpu/features2d/akaze.py``.

On the input's device, in torch, batched over the images: the nonlinear
scale space (the 1.6 Gaussian, the contrast factor of each image, the
INTER_AREA octave steps, the FED diffusion cycles over the Scharr-family
conductivity), the scale-normalised derivatives and Hessian determinant
of every level, and each level's 3×3 maxima mask.  Every float op runs
alone (no fused multiply-add), and every reduction has a fixed order, so
the card and the CPU give the same bits:

- the separable filters are shifted-slice multiply-adds, taps left to
  right (a zero tap is skipped: it only adds a signed zero);
- the contrast factor's histogram bins come from thresholds found on the
  host by bisection over float32 values with the reference's own numpy
  expression (its bin is monotone in |∇|²), so the device only compares;
- a fractional INTER_AREA step sums its (at most three) taps per output
  in source order, where ``resize`` takes a matrix product.

Then one read-back of every level and mask (pinned, one host sync on the
card), and on the host the JAX package's numpy, copied: the same-scale and
cross-scale suppression, the subpixel refinement, the SURF-window
orientation (a sequential f64 ``np.add.at``) and the MLDB descriptor
(numpy's pairwise f32 sums).  The JAX package jits the conductivity, the
FED steps and the Hessian, so XLA contracts their multiply-adds: the
levels agree with it to float32 rounding, not bit for bit.

Parameter parity with AKAZEConfig.h: omax=4, nsublevels=4,
soffset=1.6, derivative_factor=1.5, diffusivity=PM_G2,
dthreshold=0.001, descriptor_channels=3, descriptor_pattern_size=10,
kcontrast percentile 0.7 over 300 bins.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import constants as K
from ..core.arrays import as_tensor, to_device
from ..ops.color import cvtColor
from ..ops.filter import GaussianBlur
from ..ops.hist import hist_fixed
from ..ops.resize import _area_tab, resize
from .keypoint import KeyPoint
from .sift import _host_views

__all__ = ["AKAZE", "AKAZE_create",
           "DESCRIPTOR_KAZE_UPRIGHT", "DESCRIPTOR_KAZE",
           "DESCRIPTOR_MLDB_UPRIGHT", "DESCRIPTOR_MLDB",
           "DIFF_PM_G1", "DIFF_PM_G2", "DIFF_WEICKERT", "DIFF_CHARBONNIER"]

DESCRIPTOR_KAZE_UPRIGHT = 2
DESCRIPTOR_KAZE = 3
DESCRIPTOR_MLDB_UPRIGHT = 4
DESCRIPTOR_MLDB = 5

DIFF_PM_G1 = 0
DIFF_PM_G2 = 1
DIFF_WEICKERT = 2
DIFF_CHARBONNIER = 3


# ---------------------------------------------------------------- FED

def _fed_tau(T, tau_max=0.25, reordering=True):
    """FED step sizes for one cycle of total time T (fed.cpp:50)."""
    n = int(math.ceil(math.sqrt(3.0 * T / tau_max + 0.25) - 0.5 - 1e-8))
    scale = 3.0 * T / (tau_max * n * (n + 1))
    c = 1.0 / (4.0 * n + 2.0)
    d = scale * tau_max / 2.0
    tauh = [d / (math.cos(math.pi * (2.0 * k + 1.0) * c) ** 2)
            for k in range(n)]
    if not reordering:
        return tauh
    kappa = n // 2
    prime = n + 1
    while not _is_prime(prime):
        prime += 1
    tau = [0.0] * n
    k = 0
    for l in range(n):
        while True:
            index = ((k + 1) * kappa) % prime - 1
            if index < n:
                break
            k += 1
        tau[l] = tauh[index]
        k += 1
    return tau


def _is_prime(m):
    if m < 2:
        return False
    if m in (2, 3, 5, 7, 11, 13):
        return True
    if m % 2 == 0 or m % 3 == 0 or m % 5 == 0 or m % 7 == 0:
        return False
    i = 11
    while i * i <= m:
        if m % i == 0 or m % (i + 2) == 0:
            return False
        i += 6
    return True


# ------------------------------------------------------- dense kernels

def _gauss_ksize(sigma):
    k = int(math.ceil(2.0 * (1.0 + (sigma - 0.8) / 0.3)))
    return k | 1


def _gaussian(img, sigma, ksize=None):
    """GaussianBlur (BORDER_REPLICATE) of a (B, H, W) f32 batch."""
    if ksize is None:
        ksize = _gauss_ksize(sigma)
    return GaussianBlur(img[..., None], (ksize, ksize), sigma,
                        borderType=K.BORDER_REPLICATE)[..., 0]


def _deriv_kernels(order_x, scale):
    """Scale-adapted Scharr-family separable kernels
    (nldiffusion_functions.cpp:329 compute_derivative_kernels)."""
    ksize = 3 + 2 * (scale - 1)
    w = 10.0 / 3.0
    norm = 1.0 / (2.0 * scale * (w + 2.0))
    smooth = np.zeros(ksize, np.float32)
    smooth[0] = norm
    smooth[ksize // 2] = w * norm
    smooth[-1] = norm
    deriv = np.zeros(ksize, np.float32)
    deriv[0] = -1.0
    deriv[-1] = 1.0
    if order_x:
        return deriv, smooth   # kx (horizontal), ky (vertical)
    return smooth, deriv


@functools.lru_cache(maxsize=256)
def _reflect_index(n: int, r: int, device: str) -> torch.Tensor:
    """Source indices of a reflect-101 pad of r on each side of n
    (numpy's and jnp.pad's "reflect"), on `device`."""
    return to_device(np.pad(np.arange(n, dtype=np.int64), r, mode="reflect"), device)


def _pad_reflect(x, r: int, axis: int):
    if r == 0:
        return x
    return x.index_select(axis, _reflect_index(x.shape[axis], r, str(x.device)))


def _conv1d(x, k, axis):
    """Correlation with taps k along `axis` of the padded x, taps applied
    left to right, one product and one sum at a time."""
    n = len(k)
    size = x.shape[axis] - (n - 1)
    out = None
    for i, c in enumerate(k):
        if c == 0 and out is not None:
            continue
        term = x.narrow(axis, i, size) * float(c)
        out = term if out is None else out + term
    return out


def _sep_filter(x, kx, ky):
    """Separable filter with reflect-101 border on (B, H, W)."""
    x = _conv1d(_pad_reflect(x, len(ky) // 2, 1), ky, 1)
    return _conv1d(_pad_reflect(x, len(kx) // 2, 2), kx, 2)


_SCHARR_SM = np.array([3.0, 10.0, 3.0], np.float32)
_SCHARR_DV = np.array([-1.0, 0.0, 1.0], np.float32)


def _scharr(x):
    """Unnormalized 3x3 Scharr pair on (B, H, W) (BORDER_DEFAULT)."""
    return _sep_filter(x, _SCHARR_DV, _SCHARR_SM), _sep_filter(x, _SCHARR_SM, _SCHARR_DV)


def _per_image(values, x):
    """A (B, 1, 1) f32 tensor of per-image host values on x's device."""
    return to_device(np.asarray(values, np.float32).reshape(-1, 1, 1), x.device)


def _diffusivity(Lx, Ly, k, diffusivity):
    """Conductivity g(|∇L|; k) (nldiffusion_functions.cpp pm_g1/g2/
    weickert/charbonnier); `k` holds each image's contrast factor."""
    k32 = np.asarray(k, np.float32)
    s = (Lx * Lx + Ly * Ly) / _per_image(k32 * k32, Lx)
    if diffusivity == DIFF_PM_G1:
        return torch.exp(-s)
    if diffusivity == DIFF_PM_G2:
        return 1.0 / (1.0 + s)
    if diffusivity == DIFF_WEICKERT:
        s2 = torch.clamp_min(s, 1e-12)
        s2 = s2 * s2
        return 1.0 - torch.exp(-3.315 / (s2 * s2))
    return 1.0 / torch.sqrt(1.0 + s)


def _edge_pad(x):
    return F.pad(x[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]


def _nld_steps(Lt, c, taus):
    """FED cycle: repeated explicit diffusion steps with per-step tau.
    Replicate padding zeroes the cross-boundary differences, which
    reproduces the reference's edge/interior stencils in one rule.  The
    conductivity's pair sums are the same in every step: taken once."""
    cp = _edge_pad(c)
    cc = cp[:, 1:-1, 1:-1]
    cxp = cc + cp[:, 1:-1, 2:]
    cxn = cp[:, 1:-1, :-2] + cc
    cyp = cc + cp[:, 2:, 1:-1]
    cyn = cp[:, :-2, 1:-1] + cc
    L = Lt
    for tau in taus:
        Lp = _edge_pad(L)
        xpos = cxp * (Lp[:, 1:-1, 2:] - L)
        xneg = cxn * (L - Lp[:, 1:-1, :-2])
        ypos = cyp * (Lp[:, 2:, 1:-1] - L)
        yneg = cyn * (L - Lp[:, :-2, 1:-1])
        L = L + float(np.float32(0.5) * np.float32(tau)) * (xpos - xneg + ypos - yneg)
    return L


def _hessian_response(Lsmooth, sigma_size):
    """Scale-normalized det-of-Hessian + first derivatives for a batch
    of sublevels sharing a sigma_size (AKAZEFeatures.cpp:590)."""
    kx_d, ky_d = _deriv_kernels(1, sigma_size)
    Lx = _sep_filter(Lsmooth, kx_d, ky_d)
    Lxx = _sep_filter(Lx, kx_d, ky_d)
    kx_y, ky_y = _deriv_kernels(0, sigma_size)
    Lxy = _sep_filter(Lx, kx_y, ky_y)
    Ly = _sep_filter(Lsmooth, kx_y, ky_y)
    Lyy = _sep_filter(Ly, kx_y, ky_y)
    s4 = float(sigma_size) ** 4
    Ldet = (Lxx * Lyy - Lxy * Lxy) * s4
    return Lx, Ly, Ldet


def _bin_thresholds(hmax: float, nbins: int, vmax) -> np.ndarray:
    """For b = 1..nbins-1, the smallest positive float32 v whose bin, by
    the reference's expression on sqrt(v), is at least b (inf where no v up
    to vmax reaches b): a bisection over the float32 bit patterns, all
    nbins-1 at once.  The bin is monotone in v, so v's bin is the number
    of thresholds at or below v."""
    def bin_of(v32):
        m = np.sqrt(v32)
        return np.minimum((nbins * (m / hmax)).astype(np.int64), nbins - 1)

    target = np.arange(1, nbins)
    top = np.float32(vmax).view(np.int32)
    lo = np.ones(nbins - 1, np.int64)
    hi = np.full(nbins - 1, int(top), np.int64)
    while (lo < hi).any():
        mid = (lo + hi) // 2
        ok = bin_of(mid.astype(np.int32).view(np.float32)) >= target
        hi = np.where(ok, mid, hi)
        lo = np.where(ok, lo, mid + 1)
    out = lo.astype(np.int32).view(np.float32).copy()
    out[bin_of(out) < target] = np.inf
    return out


def compute_kcontrast(img, perc=0.7, nbins=300):
    """Each image's 70th-percentile gradient contrast factor
    (nldiffusion_functions.cpp:229) of a (B, H, W) f32 batch, as Python
    floats equal to the JAX package's ``_compute_kcontrast``: the blur,
    the Scharr pair and |∇|² on the device, one read-back of each image's
    largest |∇|², the bin thresholds on the host, the histogram on the
    device, one read-back of it."""
    g = _gaussian(img, 1.0, 5)
    gx, gy = _scharr(g)
    gx, gy = gx[:, 1:-1, 1:-1], gy[:, 1:-1, 1:-1]
    modg = (gx * gx + gy * gy).reshape(img.shape[0], -1)
    B, n = modg.shape
    if n == 0:
        vmax = np.zeros(B, np.float32)
        hmaxes = [1.0] * B
    else:
        vmax = _host_views([[modg.amax(dim=1)]], modg.device)[0][0].copy()
        hmaxes = [math.sqrt(float(v)) for v in vmax]
    bins = torch.full(modg.shape, nbins, dtype=torch.int64, device=modg.device)
    for b in range(B):
        if hmaxes[b] == 0 or n == 0:
            continue
        t = to_device(_bin_thresholds(hmaxes[b], nbins, vmax[b]), modg.device)
        bins[b] = torch.where(modg[b] != 0, torch.bucketize(modg[b], t, right=True), nbins)
    off = torch.arange(B, dtype=torch.int64, device=modg.device)[:, None] * (nbins + 1)
    hist = hist_fixed(bins + off, B * (nbins + 1)).reshape(B, nbins + 1)[:, :nbins]
    hist = _host_views([[hist]], hist.device)[0][0]
    out = []
    for b in range(B):
        hmax = hmaxes[b]
        if hmax == 0:
            out.append(0.03)
            continue
        npoints = int(hist[b].sum())
        nthreshold = int(npoints * perc)
        cumsum = np.cumsum(hist[b])
        idx = np.searchsorted(cumsum, nthreshold)
        if cumsum[-1] < nthreshold:
            out.append(0.03)
            continue
        out.append(hmax * float(idx + 1) / nbins)
    return out


def area_resize(x, dw: int, dh: int):
    """INTER_AREA of a (B, H, W) f32 batch to dw × dh: ``resize``'s exact
    mean at an integer ratio; at a fractional one, each output the sum of
    its span table's taps in source order (rows, then columns), which
    every device rounds alike."""
    B, H, W = x.shape
    sx, sy = W / dw, H / dh
    if (abs(sx - round(sx)) < np.finfo(float).eps and abs(sy - round(sy)) < np.finfo(float).eps):
        return resize(x[..., None], (dw, dh), interpolation=K.INTER_AREA)[..., 0]

    def axis_pass(v, dn, n, axis):
        A = _area_tab(n, dn, n / dn)
        taps = max(int((A[i] != 0).sum()) for i in range(dn))
        idx = np.zeros((taps, dn), np.int64)
        wts = np.zeros((taps, dn), np.float32)
        for i in range(dn):
            nz = np.nonzero(A[i])[0]
            idx[:len(nz), i] = nz
            wts[:len(nz), i] = A[i, nz]
            idx[len(nz):, i] = nz[-1]
        shape = [1, 1, 1]
        shape[axis] = dn
        out = None
        for t in range(taps):
            term = v.index_select(axis, to_device(idx[t], v.device)) * \
                to_device(wts[t], v.device).reshape(shape)
            out = term if out is None else out + term
        return out

    return axis_pass(axis_pass(x, dw, W, 2), dh, H, 1)


def to_float_image(imgs):
    """The reference's ``_prepare`` of a (B, H, W) batch: u8 / 255 and
    u16 / 65535 in float32 (a true division on every device), else f32."""
    if imgs.dtype in (torch.uint8, torch.uint16):
        d = 255.0 if imgs.dtype == torch.uint8 else 65535.0
        return imgs.to(torch.float32) / torch.tensor(d, dtype=torch.float32, device=imgs.device)
    return imgs.to(torch.float32)


def maxima_mask(Ldet, border: int, threshold: float):
    """The reference's candidates of one level: above `threshold` and above
    all 8 neighbours, `border` px or more inside; (B, h, w) bool."""
    B, H, W = Ldet.shape
    b = border
    keep = torch.zeros(Ldet.shape, dtype=torch.bool, device=Ldet.device)
    if H > 2 * b and W > 2 * b:
        c = Ldet[:, b:H - b, b:W - b]
        m = c > torch.tensor(threshold, dtype=torch.float32, device=Ldet.device)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    m &= c > Ldet[:, b + dy:H - b + dy, b + dx:W - b + dx]
        keep[:, b:H - b, b:W - b] = m
    return keep


def read_levels(levels, masks=None, keys=("Lt", "Lx", "Ly", "Ldet")):
    """Each level's `keys` (and mask, if given) as host numpy, through one
    pinned read-back on the card: a list of dicts of (B, h, w) arrays."""
    rows = [[e[k] for k in keys] for e in levels]
    if masks is not None:
        keys = (*keys, "mask")
        rows = [r + [m] for r, m in zip(rows, masks)]
    views = _host_views(rows, rows[0][0].device)
    out = []
    for e, v in zip(levels, views):
        d = {k: e[k] for k in e if not isinstance(e[k], torch.Tensor)}
        d.update(zip(keys, v))
        out.append(d)
    return out


def image_levels(levels_np, b: int):
    """Image b's levels of :func:`read_levels`' output."""
    return [{k: (v[b] if isinstance(v, np.ndarray) else v) for k, v in e.items()}
            for e in levels_np]


# ------------------------------------------------------- sparse logic

def _suppress_same_scale(cand_yx, values, radius, shape):
    """Raster-order greedy radius suppression
    (AKAZEFeatures.cpp:695 find_neighbor_point semantics)."""
    H, W = shape
    mask = np.full((H, W), -1, np.int64)   # index of accepted point
    accepted = []
    r2 = radius * radius
    for (y, x), v in zip(cand_yx, values):
        y0 = max(y - radius, 0)
        y1 = min(y + radius, H)
        x0 = max(x - radius, 0)
        x1 = min(x + radius, W)
        sub = mask[y0:y1, x0:x1]
        hit = np.argwhere(sub >= 0)
        replaced = False
        for (dy, dx) in hit:
            ny, nx = y0 + dy, x0 + dx
            if (nx - x) ** 2 + (ny - y) ** 2 <= r2:
                j = mask[ny, nx]
                if v > accepted[j][2]:
                    mask[ny, nx] = -1
                    accepted[j] = None
                    replaced = True
                else:
                    replaced = None
                break
        if replaced is None:
            continue
        mask[y, x] = len(accepted)
        accepted.append((y, x, v))
    return [(y, x, v) for t in accepted if t is not None
            for (y, x, v) in [t]]


def _cross_scale_filter(layers):
    """Two sweeps clearing weaker duplicates in adjacent levels
    (AKAZEFeatures.cpp:808)."""
    def neighbor(pts, px, py, radius):
        for j, (y, x, v) in enumerate(pts):
            if v is None:
                continue
            if (x - px) ** 2 + (y - py) ** 2 <= radius * radius:
                return j
        return -1

    # lower-scale sweep
    for i in range(1, len(layers)):
        pts, ratio, ssize = layers[i]
        pts_prev, ratio_prev, _ = layers[i - 1]
        diff = int(ratio // ratio_prev)
        radius = ssize * diff
        for (y, x, v) in pts:
            if v is None:
                continue
            j = neighbor(pts_prev, x * diff, y * diff, radius)
            if j >= 0 and v > pts_prev[j][2]:
                pts_prev[j] = (pts_prev[j][0], pts_prev[j][1], None)
    # upper-scale sweep
    for i in range(len(layers) - 2, -1, -1):
        pts, ratio, _ = layers[i]
        pts_next, ratio_next, ssize_next = layers[i + 1]
        diff = int(ratio_next // ratio)
        for (y, x, v) in pts:
            if v is None:
                continue
            j = neighbor(pts_next, x // diff, y // diff, ssize_next)
            if j >= 0 and v > pts_next[j][2]:
                pts_next[j] = (pts_next[j][0], pts_next[j][1], None)
    return layers


# gauss25 sampling table for the SURF-style orientation window
# (AKAZEFeatures.cpp:1260): radius-6 disc, sigma-2.5 weights.
def _orient_table():
    xs, ys, ws = [], [], []
    s = 2.5
    for i in range(-6, 7):
        for j in range(-6, 7):
            if i * i + j * j < 36:
                ys.append(i)
                xs.append(j)
                ws.append(math.exp(-(i * i + j * j) / (2 * s * s))
                          / (2 * math.pi * s * s))
    return (np.asarray(xs), np.asarray(ys), np.asarray(ws, np.float32))


_OX, _OY, _OW = _orient_table()


def _main_orientations(Lx, Ly, xs, ys, scales):
    """SURF sliding-window dominant orientation, batched over the
    keypoints of one level (AKAZEFeatures.cpp:1362)."""
    H, W = Lx.shape
    px = xs[:, None] + _OX[None, :] * scales[:, None]      # (N,109)
    py = ys[:, None] + _OY[None, :] * scales[:, None]
    px = np.clip(px, 0, W - 1)
    py = np.clip(py, 0, H - 1)
    rx = _OW[None, :] * Lx[py, px]
    ry = _OW[None, :] * Ly[py, px]
    ang = np.arctan2(ry, rx) % (2 * np.pi)                 # (N,109)
    slices = 42
    sl = np.minimum((ang / (2 * np.pi / slices)).astype(np.int64),
                    slices - 1)
    N = len(xs)
    sx = np.zeros((N, slices), np.float64)
    sy = np.zeros((N, slices), np.float64)
    np.add.at(sx, (np.arange(N)[:, None], sl), rx)
    np.add.at(sy, (np.arange(N)[:, None], sl), ry)
    # circular window sums of width 7
    idx = (np.arange(slices)[:, None] + np.arange(7)[None, :]) % slices
    wx = sx[:, idx].sum(axis=2)                            # (N,42)
    wy = sy[:, idx].sum(axis=2)
    best = np.argmax(wx * wx + wy * wy, axis=1)
    bx = wx[np.arange(N), best]
    by = wy[np.arange(N), best]
    return np.degrees(np.arctan2(by, bx)) % 360.0


def _mldb_grids(pattern_size=10):
    """Cell sample offsets for the 3 MLDB grid levels
    (AKAZEFeatures.cpp:1953): per level a list of cells, each a
    (k, l) sample offset array."""
    out = []
    for lvl in range(3):
        if lvl == 0:
            step = pattern_size
        elif lvl == 1:
            step = -(-pattern_size * 2 // 3)
        else:
            step = -(-pattern_size // 2)
        cells = []
        for i in range(-pattern_size, pattern_size, step):
            for j in range(-pattern_size, pattern_size, step):
                ks, ls = np.meshgrid(np.arange(i, i + step),
                                     np.arange(j, j + step), indexing="ij")
                cells.append((ks.ravel(), ls.ravel()))
        out.append(cells)
    return out


_MLDB_GRIDS = _mldb_grids()


def _mldb_descriptors(levels, kpts, upright=False, channels=3,
                      pattern_size=10):
    """486-bit MLDB descriptors, batched per evolution level
    (AKAZEFeatures.cpp:1953 Get_MLDB_Full_Descriptor)."""
    nbits = sum((lvl + 2) ** 2 * ((lvl + 2) ** 2 - 1) // 2 * channels
                for lvl in range(3))
    desc = np.zeros((len(kpts), (nbits + 7) // 8), np.uint8)
    by_level = {}
    for i, kp in enumerate(kpts):
        by_level.setdefault(kp.class_id, []).append(i)
    for lvl_id, idxs in by_level.items():
        Lt, Lx, Ly, ratio = levels[lvl_id]
        H, W = Lt.shape
        sel = [kpts[i] for i in idxs]
        xf = np.asarray([kp.pt[0] / ratio for kp in sel])
        yf = np.asarray([kp.pt[1] / ratio for kp in sel])
        scale = np.asarray([round(0.5 * kp.size / ratio) for kp in sel],
                           np.float64)
        if upright:
            co = np.ones(len(sel))
            si = np.zeros(len(sel))
        else:
            a = np.radians([kp.angle for kp in sel])
            co = np.cos(a)
            si = np.sin(a)
        allbits = []
        for lvl in range(3):
            cells = _MLDB_GRIDS[lvl]
            vals = np.empty((len(sel), len(cells), channels))
            for ci, (ks, ls) in enumerate(cells):
                # rotated sample positions (N, S)
                sy = yf[:, None] + (ls[None] * co[:, None]
                                    + ks[None] * si[:, None]) * scale[:, None]
                sx = xf[:, None] + (-ls[None] * si[:, None]
                                    + ks[None] * co[:, None]) * scale[:, None]
                iy = np.floor(sy + 0.5).astype(np.int64)
                ix = np.floor(sx + 0.5).astype(np.int64)
                ok = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
                iy = np.clip(iy, 0, H - 1)
                ix = np.clip(ix, 0, W - 1)
                n = np.maximum(ok.sum(axis=1), 1)
                di = np.where(ok, Lt[iy, ix], 0).sum(axis=1) / n
                vals[:, ci, 0] = di
                if channels > 1:
                    rx = np.where(ok, Lx[iy, ix], 0)
                    ry = np.where(ok, Ly[iy, ix], 0)
                    if channels == 2:
                        vals[:, ci, 1] = np.hypot(rx, ry).sum(axis=1) / n
                    else:
                        rrx = (-rx * si[:, None] + ry * co[:, None])
                        rry = (rx * co[:, None] + ry * si[:, None])
                        vals[:, ci, 1] = rrx.sum(axis=1) / n
                        vals[:, ci, 2] = rry.sum(axis=1) / n
            nc = len(cells)
            iu, ju = np.triu_indices(nc, 1)
            for ch in range(channels):
                allbits.append(vals[:, iu, ch] > vals[:, ju, ch])
        bits = np.concatenate(allbits, axis=1)
        packed = np.packbits(bits, axis=1, bitorder="little")
        for k, i in enumerate(idxs):
            desc[i] = packed[k]
    return desc


# --------------------------------------------------------------- AKAZE

class AKAZE:
    """cv::AKAZE (features2d/src/akaze.cpp)."""

    def __init__(self, descriptor_type=DESCRIPTOR_MLDB, descriptor_size=0,
                 descriptor_channels=3, threshold=0.001, nOctaves=4,
                 nOctaveLayers=4, diffusivity=DIFF_PM_G2):
        self.descriptor_type = descriptor_type
        self.descriptor_size = descriptor_size
        self.descriptor_channels = descriptor_channels
        self.threshold = threshold
        self.nOctaves = nOctaves
        self.nOctaveLayers = nOctaveLayers
        self.diffusivity = diffusivity
        self.soffset = 1.6
        self.derivative_factor = 1.5

    @staticmethod
    def create(descriptor_type=DESCRIPTOR_MLDB, descriptor_size=0,
               descriptor_channels=3, threshold=0.001, nOctaves=4,
               nOctaveLayers=4, diffusivity=DIFF_PM_G2):
        return AKAZE(descriptor_type, descriptor_size, descriptor_channels,
                     threshold, nOctaves, nOctaveLayers, diffusivity)

    # getters mirroring the cv2 API
    def getThreshold(self):
        return self.threshold

    def setThreshold(self, t):
        self.threshold = t

    def getNOctaves(self):
        return self.nOctaves

    def getNOctaveLayers(self):
        return self.nOctaveLayers

    def getDiffusivity(self):
        return self.diffusivity

    def getDescriptorType(self):
        return self.descriptor_type

    def getDescriptorSize(self):
        return self.descriptor_size

    def getDescriptorChannels(self):
        return self.descriptor_channels

    def descriptorSize(self):
        if self.descriptor_type in (DESCRIPTOR_KAZE, DESCRIPTOR_KAZE_UPRIGHT):
            return 64
        return 61 if self.descriptor_channels == 3 else \
            (486 // 3 * self.descriptor_channels + 7) // 8

    def descriptorType(self):
        return 0 if self.descriptor_type >= DESCRIPTOR_MLDB_UPRIGHT else 5

    def defaultNorm(self):
        return 6 if self.descriptor_type >= DESCRIPTOR_MLDB_UPRIGHT else 4

    # ------------------------------------------------------ pipeline
    def _evolution_plan(self, H, W):
        """Level descriptors (octave, sublevel, size, esigma, sigma_size,
        etime, border) — AKAZEFeatures.cpp:46."""
        smax = 10.0 * math.sqrt(2.0)
        levels = []
        omax = self.nOctaves
        power = 1
        for i in range(omax):
            lh, lw = int(H / power), int(W / power)
            if (lw < 80 or lh < 40) and i != 0:
                break
            for j in range(self.nOctaveLayers):
                esigma = self.soffset * 2.0 ** (j / self.nOctaveLayers + i)
                sigma_size = int(round(esigma * self.derivative_factor
                                       / power))
                levels.append(dict(
                    octave=i, sublevel=j, size=(lh, lw), esigma=esigma,
                    sigma_size=sigma_size, etime=0.5 * esigma * esigma,
                    ratio=float(power),
                    border=int(round(smax * sigma_size)) + 1))
            power *= 2
        return levels

    def scale_space(self, img_f):
        """Nonlinear scale space via FED (AKAZEFeatures.cpp:432) of a
        (B, H, W) f32 batch on its device: the plan's level dicts with
        ``Lt``, ``Lx``, ``Ly`` and ``Ldet``, each (B, h, w) f32."""
        B, H, W = img_f.shape
        plan = self._evolution_plan(H, W)
        Lt = _gaussian(img_f, self.soffset)
        Lt_list = [Lt]
        Lsm_list = [Lt]
        if len(plan) > 1:
            kcontrast = compute_kcontrast(img_f)
            for i in range(1, len(plan)):
                e = plan[i]
                prev = Lt_list[i - 1]
                if e["octave"] > plan[i - 1]["octave"]:
                    lh, lw = e["size"]
                    Lt = area_resize(prev, lw, lh)
                    kcontrast = [k * 0.75 for k in kcontrast]
                else:
                    Lt = prev
                Lsmooth = _gaussian(Lt, 1.0, 5)
                Lx, Ly = _scharr(Lsmooth)
                c = _diffusivity(Lx, Ly, kcontrast, self.diffusivity)
                taus = _fed_tau(e["etime"] - plan[i - 1]["etime"])
                Lt = _nld_steps(Lt, c, taus)
                Lt_list.append(Lt)
                Lsm_list.append(Lsmooth)
        out = []
        for i, e in enumerate(plan):
            Lx, Ly, Ldet = _hessian_response(Lsm_list[i], e["sigma_size"])
            out.append(dict(e, Lt=Lt_list[i], Lx=Lx, Ly=Ly, Ldet=Ldet))
        return out

    def maxima_masks(self, levels):
        """Each level's (B, h, w) candidate mask on its device."""
        return [maxima_mask(e["Ldet"], e["border"], self.threshold) for e in levels]

    def _detect_levels(self, levels):
        layer_pts = []
        for e in levels:
            Ldet = e["Ldet"]
            Hh, Ww = Ldet.shape
            ys, xs = np.nonzero(e["mask"])  # raster order
            cand = [(int(y), int(x)) for y, x in zip(ys, xs)]
            vals = [float(Ldet[y, x]) for y, x in zip(ys, xs)]
            pts = _suppress_same_scale(cand, vals, e["sigma_size"], (Hh, Ww))
            layer_pts.append([list(p) for p in pts])
        packed = [(pts, lev["ratio"], lev["sigma_size"])
                  for pts, lev in zip(layer_pts, levels)]
        packed = _cross_scale_filter(
            [(p, r, s) for (p, r, s) in packed])
        return [p for (p, _, _) in packed]

    def _refine(self, levels, layer_pts):
        kpts = []
        for li, (e, pts) in enumerate(zip(levels, layer_pts)):
            Ldet = e["Ldet"]
            ratio = e["ratio"]
            for (y, x, v) in pts:
                if v is None:
                    continue
                Dx = 0.5 * (Ldet[y, x + 1] - Ldet[y, x - 1])
                Dy = 0.5 * (Ldet[y + 1, x] - Ldet[y - 1, x])
                Dxx = Ldet[y, x + 1] + Ldet[y, x - 1] - 2 * Ldet[y, x]
                Dyy = Ldet[y + 1, x] + Ldet[y - 1, x] - 2 * Ldet[y, x]
                Dxy = 0.25 * (Ldet[y + 1, x + 1] + Ldet[y - 1, x - 1]
                              - Ldet[y - 1, x + 1] - Ldet[y + 1, x - 1])
                det = Dxx * Dyy - Dxy * Dxy
                if abs(det) < 1e-12:
                    continue
                dx = (-Dx * Dyy + Dy * Dxy) / det
                dy = (Dx * Dxy - Dy * Dxx) / det
                if abs(dx) > 1.0 or abs(dy) > 1.0:
                    continue
                kp = KeyPoint(x * ratio + dx * ratio + 0.5 * (ratio - 1),
                              y * ratio + dy * ratio + 0.5 * (ratio - 1),
                              e["esigma"] * self.derivative_factor * 2.0,
                              0.0, float(v), e["octave"], li)
                kpts.append(kp)
        return kpts

    def host_detect(self, levels, mask=None):
        """One image's keypoints from its host levels (:func:`image_levels`)."""
        kpts = self._refine(levels, self._detect_levels(levels))
        if mask is not None:
            mk = np.asarray(mask)
            kpts = [k for k in kpts if mk[int(k.pt[1]), int(k.pt[0])]]
        return kpts

    def host_describe(self, levels, kpts):
        """One image's (keypoints, descriptors) from its host levels; sets
        each keypoint's angle unless the descriptor is upright."""
        if not kpts:
            return kpts, np.zeros((0, self.descriptorSize()), np.uint8)
        upright = self.descriptor_type == DESCRIPTOR_MLDB_UPRIGHT
        if not upright:
            by_level = {}
            for i, kp in enumerate(kpts):
                by_level.setdefault(kp.class_id, []).append(i)
            for li, idxs in by_level.items():
                e = levels[li]
                ratio = e["ratio"]
                xs = np.asarray([round(kpts[i].pt[0] / ratio)
                                 for i in idxs], np.int64)
                ys = np.asarray([round(kpts[i].pt[1] / ratio)
                                 for i in idxs], np.int64)
                sc = np.asarray([round(0.5 * kpts[i].size / ratio)
                                 for i in idxs], np.int64)
                angles = _main_orientations(e["Lx"], e["Ly"], xs, ys, sc)
                for k, i in enumerate(idxs):
                    kpts[i].angle = float(angles[k])
        lv = {li: (levels[li]["Lt"], levels[li]["Lx"], levels[li]["Ly"],
                   levels[li]["ratio"]) for li in range(len(levels))}
        desc = _mldb_descriptors(lv, kpts, upright,
                                 self.descriptor_channels)
        return kpts, desc

    def levels_on_host(self, images):
        """The scale space and masks of an (B, H, W) batch, read back."""
        levels = self.scale_space(to_float_image(_gray_batch(images)))
        return read_levels(levels, self.maxima_masks(levels))

    def detect_and_compute_batch(self, images):
        """(B, H, W) batch (a tensor on any device, or numpy) → list of
        (keypoints, descriptors): the scale space and masks of the whole
        batch on its device, one read-back, then the host tails per image;
        each equal to detectAndCompute's."""
        lv = self.levels_on_host(images)
        out = []
        for b in range(lv[0]["Lt"].shape[0]):
            levels = image_levels(lv, b)
            out.append(self.host_describe(levels, self.host_detect(levels)))
        return out

    def detect(self, image, mask=None):
        return self.host_detect(image_levels(self.levels_on_host(_single(image)), 0), mask)

    def compute(self, image, keypoints):
        levels = image_levels(self.levels_on_host(_single(image)), 0)
        return self.host_describe(levels, keypoints)

    def detectAndCompute(self, image, mask=None):
        levels = image_levels(self.levels_on_host(_single(image)), 0)
        return self.host_describe(levels, self.host_detect(levels, mask))


def _single(image) -> torch.Tensor:
    """A cv2-style image (H, W) or (H, W, 3) as a (1, H, W) gray batch."""
    img = as_tensor(image)
    if img.ndim == 3:
        img = cvtColor(img, K.COLOR_BGR2GRAY)
    return img[None]


def _gray_batch(images) -> torch.Tensor:
    imgs = as_tensor(images)
    return imgs[None] if imgs.ndim == 2 else imgs


def AKAZE_create(descriptor_type=DESCRIPTOR_MLDB, descriptor_size=0,
                 descriptor_channels=3, threshold=0.001, nOctaves=4,
                 nOctaveLayers=4, diffusivity=DIFF_PM_G2):
    return AKAZE(descriptor_type, descriptor_size, descriptor_channels,
                 threshold, nOctaves, nOctaveLayers, diffusivity)
