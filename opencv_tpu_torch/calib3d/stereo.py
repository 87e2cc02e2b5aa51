"""Stereo block matching (calib3d/src/stereobm.cpp) and semi-global
matching (calib3d/src/stereosgbm.cpp), twin of
``opencv_tpu/calib3d/stereo.py``.

Both run as torch on the device of their input tensors and return an
(H, W) int16 tensor there, with nothing of the image read back (but the
speckle pass, which runs the native host tail on one read-back of the
disparity).  Every stage is integer, so the card and the CPU agree bit
for bit, and both equal the JAX package and cv2.

- **StereoBM**: the prefilter (paired-row x-Sobel or the normalized
  response) on the device, then the JAX package's ``_bm_core`` as one
  function over an int32 (H, W1 + 2r, D) cost volume: its window sums are
  in-place int32 prefix sums (``cumsum_`` keeps the type; a plain
  ``cumsum`` of int32 widens to int64 and doubles the volume) differenced
  along each axis, the rows replicated at the border as the reference
  clamps them.  The subpixel step gathers the mirrored ends from the
  volume instead of concatenating a padded copy of it.
- **StereoSGBM**: the BT cost volume, its box sums, and the five (MODE_SGBM)
  or eight (MODE_HH) path recurrences of the JAX package's ``lax.scan`` as
  Python loops over contiguous slices: the horizontal passes over the
  columns of the volume permuted once to (W1, H, D), the vertical and
  diagonal ones over its rows.  At 540×960 with 128 disparities that is
  tens of thousands of small launches.
  The left-right check's scatter-min and scatter-max are
  ``scatter_reduce_`` with ``"amin"`` and ``"amax"``.
"""

from __future__ import annotations

import torch

from ..core.arrays import as_tensor

__all__ = ["StereoBM", "StereoBM_create", "StereoSGBM",
           "StereoSGBM_create"]


def _plane(img) -> torch.Tensor:
    """The (H, W) plane a matcher reads: the first channel of a 3-D input."""
    x = as_tensor(img)
    return x[..., 0] if x.ndim == 3 else x


def _xsobel_prefilter(img: torch.Tensor, ftzero: int) -> torch.Tensor:
    """prefilterXSobel (stereobm.cpp:210): x-Sobel over reflected rows,
    clamped to [0, 2*ftzero].  Border columns get ftzero; when the
    height is odd the unpaired last row is entirely ftzero (the
    reference processes rows in pairs).  (H, W) int32."""
    x = img.to(torch.int32)
    H, W = x.shape
    out = torch.full((H, W), ftzero, dtype=torch.int32, device=x.device)
    if H < 2 or W < 3:
        return out
    rows = torch.arange(H, device=x.device)
    up = (rows - 1).abs()                       # reflect-101 top
    dn = (H - 1) - (H - 2 - rows).abs()         # reflect-101 bottom
    d = torch.zeros((H, W), dtype=torch.int32, device=x.device)
    d[:, 1:-1] = x[:, 2:] - x[:, :-2]
    sob = d[up] + 2 * d + d[dn]
    out[:, 1:-1] = (sob + ftzero).clamp(0, 2 * ftzero)[:, 1:-1]
    out[:, 0] = ftzero
    out[:, -1] = ftzero
    if H % 2 == 1:
        out[-1, :] = ftzero
    return out


def _norm_prefilter(img: torch.Tensor, winsize: int, ftzero: int) -> torch.Tensor:
    """prefilterNorm (stereobm.cpp:128): response of the 5-point
    Laplacian-ish kernel normalized by the local window mean, clamped
    to [0, 2*ftzero].  (H, W) int32, computed in int64."""
    x = img.to(torch.int64)
    H, W = x.shape
    dev = x.device
    wsz2 = winsize // 2
    scale_g = winsize * winsize // 8
    scale_s = (1024 + scale_g) // (scale_g * 2)
    scale_g *= scale_s
    # replicate-border winsize x winsize window sum (the reference's
    # running vsum/sum scheme)
    ri = (torch.arange(-wsz2, H + wsz2, device=dev)).clamp(0, H - 1)
    ci = (torch.arange(-wsz2, W + wsz2, device=dev)).clamp(0, W - 1)
    p = x[ri][:, ci]
    c = torch.zeros((H + 2 * wsz2 + 1, W + 2 * wsz2 + 1), dtype=torch.int64, device=dev)
    c[1:, 1:] = p.cumsum(0).cumsum(1)
    k = 2 * wsz2 + 1
    s = c[k:k + H, k:k + W] - c[k:k + H, 0:W] - c[0:H, k:k + W] + c[0:H, 0:W]
    rows = torch.arange(H, device=dev)
    cols = torch.arange(W, device=dev)
    prev = x[(rows - 1).clamp(min=0)]
    nxt = x[(rows + 1).clamp(max=H - 1)]
    left = x[:, (cols - 1).clamp(min=0)]
    right = x[:, (cols + 1).clamp(max=W - 1)]
    val = ((x * 4 + left + right + prev + nxt) * scale_g - s * scale_s) >> 10
    return (val + ftzero).clamp(0, 2 * ftzero).to(torch.int32)


def _window_sum_(x: torch.Tensor, dim: int, k: int) -> torch.Tensor:
    """Sums of k consecutive entries along `dim` (length n - k + 1), from an
    in-place int32 prefix sum of `x` (which it overwrites)."""
    x.cumsum_(dim, dtype=torch.int32)
    n = x.shape[dim]
    out = x.narrow(dim, k - 1, n - k + 1).clone()
    out.narrow(dim, 1, n - k).sub_(x.narrow(dim, 0, n - k))
    return out


def _box_sep(x: torch.Tensor, wsz2: int) -> torch.Tensor:
    """The BM window sums of (H, we, ...) int32: valid along the extended
    axis 1 (to we - 2*wsz2 columns), replicate-border along axis 0 (the
    reference clamps the row index of its hsad rows).  Consumes `x`."""
    k = 2 * wsz2 + 1
    H = x.shape[0]
    hh = _window_sum_(x, 1, k)
    del x
    rows = torch.arange(-wsz2, H + wsz2, device=hh.device).clamp(0, H - 1)
    pv = hh[rows]
    del hh
    return _window_sum_(pv, 0, k)


def _far(ds: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """|d - best| > 1 over the disparities ds, as a bool volume (two
    comparisons, no integer volume of the differences)."""
    return (ds < (best - 1)[..., None]) | (ds > (best + 1)[..., None])


def _sad_volume(R, lv, rbase, ds) -> torch.Tensor:
    """|L(x) - R(x - d)| over the extended columns, (H, we, D) int32, in
    place on the gathered R."""
    cost = R[:, rbase[:, None] + ds[None, :]]
    return cost.sub_(lv[:, :, None]).abs_()


def _bm_core(L, R, ndisp, wsz, ftzero, tex_thresh, uniq, minD):
    """findStereoCorrespondenceBM (stereobm.cpp:669) as one function over the
    full image: reversed-d SAD volume + replicate box, first-min winner,
    texture/uniqueness checks, the mirrored-end integer subpixel, and the
    valid-ROI blanking of the invoker.  L, R: (H, W) int32 prefiltered."""
    H, W = L.shape
    dev = L.device
    wsz2 = wsz // 2
    lofs = max(ndisp - 1 + minD, 0)
    rofs = -min(ndisp - 1 + minD, 0)
    width1 = W - rofs - ndisp + 1
    FILT = (minD - 1) * 16

    ds = torch.arange(ndisp, device=dev)
    # window columns extended by wsz2 each side, with the reference's
    # ASYMMETRIC clamps: the left pointer clamps to width-1-lofs, the
    # right BASE clamps to width-ndisp-rofs (stereobm.cpp:787-789) —
    # these differ when minD != 0, so cost cannot just replicate-pad
    wext = torch.arange(-wsz2, width1 + wsz2, device=dev)
    lcol = lofs + wext.clamp(-lofs, W - 1 - lofs)
    rbase = rofs + wext.clamp(-rofs, W - ndisp - rofs)
    lv = L[:, lcol]                                       # (H, we)
    # the volume is made inside the call, so _box_sep holds its only
    # reference and frees it once its first window sum is taken
    sad = _box_sep(_sad_volume(R, lv, rbase, ds), wsz2)   # (H, width1, D)
    mind = torch.argmin(sad, -1)                          # first minimum
    minsad = sad.gather(-1, mind[..., None])[..., 0]

    # texture: window sum of |prefiltered L - ftzero|
    texs = _box_sep((lv - ftzero).abs(), wsz2)
    tex_ok = texs >= tex_thresh

    if uniq > 0:
        thresh = minsad + torch.div(minsad * uniq, 100, rounding_mode="floor")
        unique_ok = ~torch.any(_far(ds, mind) & (sad <= thresh[..., None]), -1)
    else:
        unique_ok = torch.ones_like(tex_ok)

    # subpixel: sad[-1] = sad[1], sad[ndisp] = sad[ndisp-2] mirror,
    # then dispDescale with C truncating division
    def g(i):
        return sad.gather(-1, i[..., None])[..., 0]

    s0 = minsad
    p = g(torch.where(mind + 1 <= ndisp - 1, mind + 1, ndisp - 2))
    n = g(torch.where(mind >= 1, mind - 1, 1))
    del sad
    denom = p + n - 2 * s0 + (p - n).abs()                # >= 0
    num = (p - n) * 256
    q = torch.where(denom > 0,
                    torch.sign(num) * torch.div(num.abs(), denom.clamp(min=1),
                                                rounding_mode="floor"),
                    torch.zeros_like(num))
    val = ((ndisp - mind.to(torch.int32) - 1 + minD) * 256 + q + 15) >> 4

    # valid-ROI blanking (FindStereoCorrespInvoker + getValidDisparityROI)
    maxD = minD + ndisp - 1
    x0 = max(0, maxD) + wsz2
    x1 = W - wsz2
    gx = lofs + torch.arange(width1, device=dev)
    gy = torch.arange(H, device=dev)
    keep = (tex_ok & unique_ok
            & (gx[None, :] >= x0) & (gx[None, :] < x1)
            & (gy[:, None] >= wsz2) & (gy[:, None] < H - wsz2))
    vals = torch.where(keep, val, FILT).to(torch.int16)
    out = torch.full((H, W), FILT, dtype=torch.int16, device=dev)
    # for minD > 0 the x range extends past the image (the reference
    # computes-then-blanks those columns); clip to what fits
    nvis = min(width1, W - lofs)
    out[:, lofs:lofs + nvis] = vals[:, :nvis]
    # reproduce the reference's row-overflow artifact: its x loop for
    # minD > 0 writes the last ROI row's rightmost (computed, un-ROI'd)
    # values into row H-wsz2 columns [0, minD); that row is below the
    # ROI and is never re-blanked (stereobm.cpp:780 dptr stride walk)
    novf = lofs + width1 - W
    if novf > 0 and wsz2 <= H - wsz2 - 1:
        r = H - wsz2 - 1
        raw = torch.where(tex_ok[r] & unique_ok[r], val[r], FILT).to(torch.int16)
        out[H - wsz2, 0:novf] = raw[width1 - novf:width1]
    return out


class StereoBM:
    """StereoBM (stereobm.cpp) — bit-exact vs the wheel: paired-row
    XSobel / normalized-response prefilter, reversed-d SAD matching,
    texture + uniqueness checks, integer subpixel, valid-ROI blanking,
    optional speckle filtering."""

    PREFILTER_NORMALIZED_RESPONSE = 0
    PREFILTER_XSOBEL = 1

    def __init__(self, numDisparities=64, blockSize=21):
        self.ndisp = numDisparities if numDisparities > 0 else 64
        self.block = blockSize
        self.minDisparity = 0
        self.prefilter_type = self.PREFILTER_XSOBEL
        self.prefilter_size = 9
        self.prefilter_cap = 31
        self.texture_threshold = 10
        self.uniqueness = 15
        self.speckleWindowSize = 0
        self.speckleRange = 0
        self.disp12MaxDiff = -1

    @staticmethod
    def create(numDisparities=64, blockSize=21):
        return StereoBM(numDisparities, blockSize)

    def setNumDisparities(self, n):
        self.ndisp = n

    def setBlockSize(self, b):
        self.block = b

    def setMinDisparity(self, m):
        self.minDisparity = m

    def setPreFilterType(self, t):
        self.prefilter_type = t

    def setPreFilterSize(self, s):
        self.prefilter_size = s

    def setPreFilterCap(self, c):
        self.prefilter_cap = c

    def setTextureThreshold(self, t):
        self.texture_threshold = t

    def setUniquenessRatio(self, u):
        self.uniqueness = u

    def setSpeckleWindowSize(self, w):
        self.speckleWindowSize = w

    def setSpeckleRange(self, r):
        self.speckleRange = r

    def setDisp12MaxDiff(self, d):
        self.disp12MaxDiff = d

    def getNumDisparities(self):
        return self.ndisp

    def getBlockSize(self):
        return self.block

    def getMinDisparity(self):
        return self.minDisparity

    def prefilter(self, img) -> torch.Tensor:
        """The (H, W) int32 prefiltered plane of one image."""
        x = _plane(img)
        if self.prefilter_type == self.PREFILTER_NORMALIZED_RESPONSE:
            return _norm_prefilter(x, self.prefilter_size, self.prefilter_cap)
        return _xsobel_prefilter(x, self.prefilter_cap)

    def compute(self, left, right) -> torch.Tensor:
        """The (H, W) int16 disparity × 16 on the inputs' device."""
        out = _bm_core(self.prefilter(left), self.prefilter(right), int(self.ndisp),
                       int(self.block), int(self.prefilter_cap),
                       int(self.texture_threshold), int(self.uniqueness),
                       int(self.minDisparity))
        if self.speckleRange >= 0 and self.speckleWindowSize > 0:
            from .misc3d import filterSpeckles
            out = filterSpeckles(out, (self.minDisparity - 1) * 16,
                                 self.speckleWindowSize,
                                 self.speckleRange)
        return out


def StereoBM_create(numDisparities=64, blockSize=21):
    return StereoBM(numDisparities, blockSize)


def StereoSGBM_create(minDisparity=0, numDisparities=16, blockSize=3,
                      P1=0, P2=0, disp12MaxDiff=0, preFilterCap=0,
                      uniquenessRatio=0, speckleWindowSize=0,
                      speckleRange=0, mode=0):
    return StereoSGBM(minDisparity, numDisparities, blockSize, P1, P2,
                      disp12MaxDiff, preFilterCap, uniquenessRatio,
                      speckleWindowSize, speckleRange, mode)


# ------------------------------------------------------------------ SGBM

MAX_COST = 1 << 28


def _shift_cols(x: torch.Tensor, right: bool) -> torch.Tensor:
    """x with its columns moved by one (right: x[:, j-1]; else x[:, j+1]),
    the edge column repeated."""
    if right:
        return torch.cat([x[:, :1], x[:, :-1]], dim=1)
    return torch.cat([x[:, 1:], x[:, -1:]], dim=1)


def _bt_prow(img: torch.Tensor, ftzero: int):
    """Clipped x-Sobel plane + raw plane (calcPixelCostBT,
    stereosgbm.cpp:173), both (H, W) int32 with border columns set to
    tab[0] = ftzero."""
    x = img.to(torch.int32)
    H, W = x.shape
    up = torch.cat([x[:1], x[:-1]], dim=0)              # row y-1 (clamp)
    dn = torch.cat([x[1:], x[-1:]], dim=0)              # row y+1 (clamp)
    sob = ((_shift_cols(x, False) - _shift_cols(x, True)) * 2
           + (_shift_cols(up, False) - _shift_cols(up, True))
           + (_shift_cols(dn, False) - _shift_cols(dn, True)))
    sob = sob.clamp(-ftzero, ftzero) + ftzero
    cols = torch.arange(W, device=x.device)
    border = ((cols == 0) | (cols == W - 1))[None, :]
    sob = torch.where(border, ftzero, sob)
    # the raw plane's border columns are preset to tab[0] = ftzero too
    # (stereosgbm.cpp:195-196 covers ALL cn*2 channels)
    raw = torch.where(border, ftzero, x)
    return sob, raw


def _bt_cost_plane(p1, p2, minD, maxD):
    """BT sampling-insensitive |p1(x) - p2(x-d)| for one plane:
    (H, width1, D) int32 where width1 = W - maxD + min(minD, 0)."""
    H, W = p1.shape
    dev = p1.device
    minX1 = max(maxD, 0)
    width1 = W + min(minD, 0) - minX1
    D = maxD - minD

    def half_range(p):
        half_l = torch.div(p + _shift_cols(p, True), 2, rounding_mode="floor")
        half_r = torch.div(p + _shift_cols(p, False), 2, rounding_mode="floor")
        return (torch.minimum(torch.minimum(half_l, half_r), p),
                torch.maximum(torch.maximum(half_l, half_r), p))

    u0, u1 = half_range(p1)
    v0, v1 = half_range(p2)
    xs = minX1 + torch.arange(width1, device=dev)       # (width1,)
    ds = minD + torch.arange(D, device=dev)             # (D,)
    xr = xs[:, None] - ds[None, :]                      # (width1, D)
    u = p1[:, xs][:, :, None]
    uu0 = u0[:, xs][:, :, None]
    uu1 = u1[:, xs][:, :, None]
    v = p2[:, xr]
    c0 = torch.maximum(u - v1[:, xr], v0[:, xr] - u).clamp(min=0)
    c1 = torch.maximum(v - uu1, uu0 - v).clamp(min=0)
    return torch.minimum(c0, c1)


def _box_volume(cost: torch.Tensor, sw2: int, sh2: int) -> torch.Tensor:
    """Replicate-border (2*sw2+1)x(2*sh2+1) box sum over (H, W1, D) int32."""
    H, W1 = cost.shape[:2]
    dev = cost.device
    ri = torch.arange(-sh2, H + sh2, device=dev).clamp(0, H - 1)
    ci = torch.arange(-sw2, W1 + sw2, device=dev).clamp(0, W1 - 1)
    rows = _window_sum_(cost[ri], 0, 2 * sh2 + 1)
    return _window_sum_(rows[:, ci], 1, 2 * sw2 + 1)


def _lr_step(Lprev, minLprev, Cp, P1: int, P2: int):
    """One SGM recurrence: L = C + min(Lp[d], Lp[d-1]+P1, Lp[d+1]+P1,
    minLp+P2) - (minLp+P2), over (..., D) int32 slices."""
    pad = torch.full(Lprev.shape[:-1] + (1,), MAX_COST, dtype=Lprev.dtype, device=Lprev.device)
    lm = torch.cat([pad, Lprev[..., :-1]], dim=-1) + P1
    lp = torch.cat([Lprev[..., 1:], pad], dim=-1) + P1
    delta = (minLprev + P2)[..., None]
    L = Cp + torch.minimum(torch.minimum(Lprev, lm), torch.minimum(lp, delta)) - delta
    return L, L.amin(-1)


def _horizontal(Ct, P1: int, P2: int, reverse: bool):
    """The left-to-right (or right-to-left) path over the columns of Ct,
    the volume as (W1, H, D): its L, (W1, H, D)."""
    W1, H, D = Ct.shape
    out = torch.empty_like(Ct)
    L = torch.zeros((H, D), dtype=Ct.dtype, device=Ct.device)
    m = torch.zeros((H,), dtype=Ct.dtype, device=Ct.device)
    for j in (range(W1 - 1, -1, -1) if reverse else range(W1)):
        L, m = _lr_step(L, m, Ct[j], P1, P2)
        out[j] = L
    return out


def _vertical(C, P1: int, P2: int, reverse: bool):
    """The N, NW and NE paths (or, reversed, S, SE and SW) over the rows
    of C (H, W1, D): their sum, (H, W1, D)."""
    H, W1, D = C.shape
    dev = C.device
    out = torch.empty_like(C)
    zw = torch.zeros((W1, D), dtype=C.dtype, device=dev)
    zm = torch.zeros((W1,), dtype=C.dtype, device=dev)
    (Ln, mn), (Lnw, mnw), (Lne, mne) = (zw, zm), (zw, zm), (zw, zm)

    def sh(a):     # previous row at x-1
        return torch.cat([torch.zeros_like(a[:1]), a[:-1]], dim=0)

    def shr(a):    # previous row at x+1
        return torch.cat([a[1:], torch.zeros_like(a[:1])], dim=0)

    for i in (range(H - 1, -1, -1) if reverse else range(H)):
        Crow = C[i]
        Ln, mn = _lr_step(Ln, mn, Crow, P1, P2)
        Lnw, mnw = _lr_step(sh(Lnw), sh(mnw), Crow, P1, P2)
        Lne, mne = _lr_step(shr(Lne), shr(mne), Crow, P1, P2)
        out[i] = Ln + Lnw + Lne
    return out


def _sgbm(left, right, minD, maxD, sw2, P1, P2, ftzero, uniq, disp12, mode_hh):
    """Semi-global matching (stereosgbm.cpp computeDisparitySGBM:495) over
    (H, W) planes; (H, W) int16 before the median and speckle passes.

    The cost volume is dense (H, W1, D); the forward paths are a loop over
    rows carrying three (W1, D) planes plus a loop over columns for the
    horizontal path; the backward horizontal path runs reversed.  MODE_HH
    adds the reverse row loop (8 paths)."""
    sob1, raw1 = _bt_prow(left, ftzero)
    sob2, raw2 = _bt_prow(right, ftzero)
    cost = _bt_cost_plane(sob1, sob2, minD, maxD) \
        + (_bt_cost_plane(raw1, raw2, minD, maxD) >> 2)
    C = _box_volume(cost, sw2, sw2) + P2      # P2 pre-added like initCBuf
    del cost
    H, W1, D = C.shape
    dev = C.device

    Ct = C.permute(1, 0, 2).contiguous()      # (W1, H, D): columns contiguous
    S = _horizontal(Ct, P1, P2, False)
    S += _horizontal(Ct, P1, P2, True)        # the backward horizontal path
    del Ct
    S = S.permute(1, 0, 2).contiguous()
    S += _vertical(C, P1, P2, False)
    if mode_hh:
        S += _vertical(C, P1, P2, True)
    del C

    best = torch.argmin(S, dim=-1)            # (H, W1), first minimum
    minS = S.gather(-1, best[..., None])[..., 0]

    # uniqueness: any d with S[d]*(100-uniq) < minS*100 and |d-best|>1
    ds = torch.arange(D, device=dev)
    bad = (S * (100 - uniq) < minS[..., None] * 100) & _far(ds, best)
    unique_ok = ~torch.any(bad, dim=-1)
    del bad

    # subpixel
    d0 = best.clamp(1, D - 2)

    def gather(idx):
        return S.gather(-1, idx[..., None])[..., 0]

    sm = gather(d0 - 1)
    sp = gather(d0 + 1)
    s0 = gather(d0)
    del S
    denom2 = (sm + sp - 2 * s0).clamp(min=1)
    # C integer division truncates toward zero (stereosgbm.cpp:936);
    # adjust the floor division on negative numerators
    num = (sm - sp) * 16 + denom2
    den = denom2 * 2
    frac = (torch.div(num, den, rounding_mode="floor")
            + ((num < 0) & (torch.remainder(num, den) != 0)).to(torch.int32))
    best = best.to(torch.int32)
    dq = torch.where((best > 0) & (best < D - 1), best * 16 + frac, best * 16)

    # LR consistency: disp2 = per-right-pixel min over x of (minS, d)
    minX1 = max(maxD, 0)
    W = left.shape[1]
    xs = torch.arange(W1, device=dev, dtype=torch.int32)
    x2 = xs[None, :] + minX1 - best - minD    # (H, W1) right-image coords
    big = torch.where(unique_ok, minS, MAX_COST)
    cols = x2.clamp(0, W - 1).to(torch.int64)
    # scatter-min the winning cost per right-image column...
    d2cost = torch.full((H, W), MAX_COST, dtype=torch.int32, device=dev)
    d2cost.scatter_reduce_(1, cols, big, reduce="amin", include_self=True)
    # ...then, among equal-cost writers, pick the largest x (the
    # reference's descending-x scan keeps the first, i.e. largest, x)
    won = big == d2cost.gather(1, cols)
    selx = torch.full((H, W), -1, dtype=torch.int32, device=dev)
    selx.scatter_reduce_(1, cols, torch.where(won, xs[None, :], -1), reduce="amax",
                         include_self=True)
    d2valid = (d2cost < MAX_COST) & (selx >= 0)
    bestx = best.gather(1, selx.clamp(0, W1 - 1).to(torch.int64))
    disp2 = torch.where(d2valid, bestx + minD, minD - 1)

    dall = dq + minD * 16
    _d = dall >> 4
    d_ = (dall + 15) >> 4
    xfull = xs[None, :] + minX1

    def gx(off):
        return (xfull - off).clamp(0, W - 1).to(torch.int64)

    d2a = disp2.gather(1, gx(_d))
    d2b = disp2.gather(1, gx(d_))
    in_a = (xfull - _d >= 0) & (xfull - _d < W)
    in_b = (xfull - d_ >= 0) & (xfull - d_ < W)
    lr_bad = in_a & (d2a >= minD) & ((d2a - _d).abs() > disp12) \
        & in_b & (d2b >= minD) & ((d2b - d_).abs() > disp12)

    INVALID = (minD - 1) * 16
    dfinal = torch.where(unique_ok & ~lr_bad, dall, INVALID)
    out = torch.full((H, W), INVALID, dtype=torch.int32, device=dev)
    out[:, minX1:minX1 + W1] = dfinal
    return out.to(torch.int16)


class StereoSGBM:
    """StereoSGBM (calib3d/src/stereosgbm.cpp).  Default MODE_SGBM
    aggregates 5 paths (W, NW, N, NE, E); MODE_HH aggregates 8."""

    MODE_SGBM = 0
    MODE_HH = 1

    def __init__(self, minDisparity=0, numDisparities=16, blockSize=3,
                 P1=0, P2=0, disp12MaxDiff=0, preFilterCap=0,
                 uniquenessRatio=0, speckleWindowSize=0, speckleRange=0,
                 mode=0):
        self.minDisparity = minDisparity
        self.numDisparities = numDisparities
        self.blockSize = max(blockSize, 1)
        self.P1 = P1
        self.P2 = P2
        self.disp12MaxDiff = disp12MaxDiff
        self.preFilterCap = preFilterCap
        self.uniquenessRatio = uniquenessRatio
        self.speckleWindowSize = speckleWindowSize
        self.speckleRange = speckleRange
        self.mode = mode

    def compute(self, left, right) -> torch.Tensor:
        """The (H, W) int16 disparity × 16 on the inputs' device."""
        lx, rx = _plane(left), _plane(right)
        P1 = self.P1 if self.P1 > 0 else 2
        P2 = max(self.P2 if self.P2 > 0 else 5, P1 + 1)
        ftzero = max(self.preFilterCap, 15) | 1
        uniq = self.uniquenessRatio if self.uniquenessRatio >= 0 else 10
        # SGBM clamps disp12MaxDiff<=0 to 1 (stereosgbm.cpp:499) —
        # unlike StereoBM, the LR check is never disabled
        disp12 = self.disp12MaxDiff if self.disp12MaxDiff > 0 else 1
        out = _sgbm(lx, rx, self.minDisparity, self.minDisparity + self.numDisparities,
                    self.blockSize // 2, int(P1), int(P2), int(ftzero), int(uniq),
                    int(disp12), self.mode == self.MODE_HH)
        # the reference post-filters every SGBM result with a 3x3
        # median, then speckle filtering (stereosgbm.cpp:2225-2229)
        from ..ops.smooth import medianBlur
        out = medianBlur(out, 3)
        if self.speckleWindowSize > 0:
            from .misc3d import filterSpeckles
            out = filterSpeckles(out, (self.minDisparity - 1) * 16,
                                 self.speckleWindowSize,
                                 16 * self.speckleRange)
        return out

