"""ORB detector + descriptor (features2d/src/orb.cpp), twin of
``opencv_tpu/features2d/orb.py``.

Per pyramid level, on the input's device: the bit-exact INTER_LINEAR_EXACT
level resize (orb.cpp:1126), FAST score maps with a lossless 1×2 pre-pool
feeding ``torch.topk``, a sparse per-candidate Harris rescore
(HarrisResponses, orb.cpp:131) and intensity-centroid moments (ICAngles,
orb.cpp:181) over one window gather per candidate, the 7×7 σ=2 descriptor
blur (orb.cpp:1228; ``sep_filter``'s CUDA kernel on the card), and
rotated-BRIEF sampling with the bits packed by shifts.  The data-dependent
tails (retainBest ties, keypoint lists) run on the host over the shipped
top rows, as in the JAX package.

Numeric contracts: scale per level ``scaleFactor^level``, level sizes
``cvRound(dim/scale)``; per-level feature budget ``nfeatures(1-f)/(1-f^n)``;
Harris blockSize=7, k=0.04, scale=(4*blockSize*255)^-1 to the 4th power;
descriptor pattern = the learned 256-pair bit_pattern_31_ (orb.cpp:380,
``orb_pattern.npy``, a copy of the JAX package's), sampled after rotation
by cos/sin(angle) with cvRound; angle = fastAtan2 (the reference's
7th-order atan polynomial).

Where the port departs from the JAX program:

- top-k runs on float32 scores (the JAX package's bf16 is a TPU
  bandwidth trick; FAST scores are exact in both).  ``torch.topk`` orders
  equal values freely, which moves only the order of keypoints of equal
  response: the tie counts ``n_ge``/``n_ge2`` force a regrow whenever ties
  reach past a pool, so the retained set is the reference's.
- the IC moments and the bit packing (two MXU matmuls there) are integer
  sums and shifts here, so no float32 matmul runs (TF32 cannot touch them);
  every moment sum is below 2^24, so it equals the JAX package's f32 dot.
- ``cos``/``sin`` of the angle are taken in float64 and rounded to float32,
  as the reference's ``(float)cos(angle)`` is, so the card and the CPU
  sample the same pattern points.
- the per-level maps (FAST, blur, pooled scores, padded image) are built
  once per batch; a regrow reruns only the candidate stage.  The device
  tables of a shape (pad indices, pattern, centroid weights) are built once
  per ORB instance and device, so a second batch does no table work.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from .. import constants as K
from ..core.arrays import as_tensor
from ..core.borders import border_index
from ..core.mathfuncs import fast_atan2 as _fast_atan2
from ..ops.color import cvtColor
from ..ops.filter import GaussianBlur
from ..ops.resize import resize
from .fast import fast_keypoint_mask
from .keypoint import KeyPoint

__all__ = ["ORB", "ORB_create", "level_sizes"]

HARRIS_K = 0.04
_PATTERN = np.load(os.path.join(os.path.dirname(__file__), "orb_pattern.npy"))
# window width of the candidate gathers (the JAX package's TPU lane width;
# it covers the 31-px patch and the Harris block's Sobel reach)
_WIN = 32


class _CvRNG:
    """cv::RNG — multiply-with-carry LCG (core/include/opencv2/core.hpp,
    A = 4164903690), needed to reproduce initializeOrbPattern exactly."""

    A = 4164903690

    def __init__(self, state=0xFFFFFFFF):
        self.state = state & 0xFFFFFFFFFFFFFFFF

    def next(self):
        self.state = ((self.state & 0xFFFFFFFF) * self.A
                      + (self.state >> 32)) & 0xFFFFFFFFFFFFFFFF
        return self.state & 0xFFFFFFFF

    def uniform(self, a, b):
        return a + self.next() % (b - a)


def _orb_pattern_for_wta(wta_k: int):
    """(P, 2) sampling points: the learned 256-pair pattern for WTA_K=2,
    or the RNG(0x12345678)-randomized tuples (initializeOrbPattern,
    orb.cpp:353) for WTA_K=3/4."""
    pat0 = _PATTERN.reshape(512, 2)
    if wta_k == 2:
        return pat0.astype(np.float32)
    ntuples = 32 * 4
    pool = 512
    rng = _CvRNG(0x12345678)
    out = np.zeros((ntuples * wta_k, 2), np.float32)
    for i in range(ntuples):
        for k in range(wta_k):
            while True:
                idx = rng.uniform(0, pool)
                pt = pat0[idx]
                dup = any((out[wta_k * i + k1] == pt).all()
                          for k1 in range(k))
                if not dup:
                    out[wta_k * i + k] = pt
                    break
    return out


def _umax_table(half_patch: int) -> np.ndarray:
    """ICAngles circular-patch column bounds (orb.cpp:855-875)."""
    umax = np.zeros(half_patch + 2, np.int64)
    vmax = int(np.floor(half_patch * math.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(half_patch * math.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(np.rint(math.sqrt(half_patch * half_patch - v * v)))
    v0 = 0
    for v in range(half_patch, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


def _ic_weight_mats(half_patch: int):
    """(rows·32,) du/dv centroid weights masked by the umax disk (IC_Angle,
    orb.cpp:99), for the moment sums over each candidate's window."""
    umax = _umax_table(half_patch)
    rows = 2 * half_patch + 1
    w10 = np.zeros((rows, _WIN), np.float32)
    w01 = np.zeros((rows, _WIN), np.float32)
    for r in range(rows):
        dv = r - half_patch
        lim = umax[abs(dv)]
        for j in range(_WIN):
            du = j - half_patch
            if abs(du) <= lim:
                w10[r, j] = du
                w01[r, j] = dv
    return w10.reshape(-1), w01.reshape(-1)


def _ref101(i, L):
    """REFLECT_101 index fold for |overhang| < L (the reference's flat
    pyramid buffer carries BORDER_REFLECT_101 margins, orb.cpp:1109+)."""
    return torch.where(i < 0, -i, torch.where(i >= L, 2 * L - 2 - i, i))


def layer_scales(scale_factor: float, nlevels: int) -> list:
    """``scaleFactor^level`` per level, the power taken in float32."""
    return [float(np.float32(scale_factor) ** lv) for lv in range(nlevels)]


def level_sizes(H: int, W: int, scale_factor: float = 1.2, nlevels: int = 8) -> list:
    """(width, height) of each pyramid level: ``cvRound(dim / scale)``."""
    return [(int(np.rint(W / s)), int(np.rint(H / s)))
            for s in layer_scales(scale_factor, nlevels)]


def _level_maps(img4d, fast_threshold: int):
    """FAST score/mask and the descriptor blur of one level (B, H, W, 1)."""
    score, keep = fast_keypoint_mask(img4d, fast_threshold, True)
    blurred = GaussianBlur(img4d, (7, 7), 2.0, 2.0, K.BORDER_REFLECT_101)
    return score, keep, blurred


class _Tables:
    """The device tables of one (H, W, device) for one ORB: level sizes,
    each level's REFLECT_101 pad indices, the pattern and the centroid
    weights."""

    def __init__(self, orb, H: int, W: int, device):
        hp = orb.patch_size // 2
        self.sizes = level_sizes(H, W, orb.scale_factor, orb.nlevels)

        def index(n, before, after):
            return torch.from_numpy(
                border_index(n, before, after, K.BORDER_REFLECT_101).astype(np.int64)).to(device)

        # numpy's "reflect" pad of the JAX package == BORDER_REFLECT_101
        self.pad = [(index(h, hp, hp), index(w, hp, _WIN - hp)) for w, h in self.sizes]
        w10, w01 = _ic_weight_mats(hp)
        self.w10 = torch.from_numpy(w10.astype(np.int32)).to(device).reshape(2 * hp + 1, _WIN)
        self.w01 = torch.from_numpy(w01.astype(np.int32)).to(device).reshape(2 * hp + 1, _WIN)
        pat = _orb_pattern_for_wta(orb.wta_k)
        self.px = torch.from_numpy(np.ascontiguousarray(pat[:, 0])).to(device)
        self.py = torch.from_numpy(np.ascontiguousarray(pat[:, 1])).to(device)


def _gather_win(flat, Hp: int, Wp: int, row0, col0, nrows: int):
    """(B, N) start coordinates in the padded (B, Hp, Wp) image `flat`
    (flattened) → (B, N, nrows, 32) int32 windows, the starts clipped so a
    window stays inside (the JAX gather's CLIP mode)."""
    B = row0.shape[0]
    dev = row0.device
    row0 = row0.clamp(0, Hp - nrows)
    col0 = col0.clamp(0, Wp - _WIN)
    start = (torch.arange(B, device=dev) * (Hp * Wp))[:, None] + row0 * Wp + col0
    offs = (torch.arange(nrows, device=dev) * Wp)[:, None] + torch.arange(_WIN, device=dev)
    return flat[start[:, :, None, None] + offs].to(torch.int32)


def _level_prepare(img4d, fast_threshold: int, et: int, pad):
    """The maps of one level that the candidate stage reads, built once per
    batch: the pooled FAST scores of the keypoints inside the edge
    threshold, which half of each pair won, the padded image of the
    candidate windows and the blurred image of the descriptors."""
    score, keep, blurred = _level_maps(img4d, fast_threshold)
    B, H, W = img4d.shape[:3]
    dev = img4d.device
    ys = torch.arange(H, device=dev)
    xs = torch.arange(W, device=dev)
    inside = (((ys >= et) & (ys < H - et))[:, None] & ((xs >= et) & (xs < W - et))[None, :])
    masked = torch.where(keep[..., 0] & inside, score[..., 0].to(torch.float32), -math.inf)
    # lossless 1x2 pre-pool: the strict 3x3 NMS makes two horizontally
    # adjacent survivors impossible, so the pair-max keeps every candidate
    # while halving top-k's input
    if W % 2:
        masked = F.pad(masked, (0, 1), value=-math.inf)
    m0, m1 = masked[:, :, 0::2], masked[:, :, 1::2]
    win1 = m1 > m0
    rows, cols = pad
    imgp = img4d[..., 0].index_select(1, rows).index_select(2, cols)
    return dict(H=H, W=W, W2=m0.shape[2], pooled=torch.where(win1, m1, m0).reshape(B, -1),
                win1=win1.reshape(B, -1), imgp=imgp.reshape(-1), Hp=imgp.shape[1],
                Wp=imgp.shape[2], blurred=blurred.reshape(-1))


def _rotated_brief(blurred, H: int, W: int, iy, ix, angle, tabs, wta_k: int):
    """Rotated BRIEF (computeOrbDescriptors, orb.cpp:220) of (B, N)
    keypoints at level pixels (iy, ix) with float32 angles in degrees, read
    from the flattened (B, H, W) blurred level: (B, N, 32) u8.  cos and sin
    are taken in float64 and rounded to float32, as the reference's
    ``(float)cos(angle)``; the pattern points fold back by REFLECT_101 (the
    reference's pyramid margins), then clamp, so keypoints given to
    ``compute`` anywhere keep the gather inside the level."""
    B, N = iy.shape
    dev = iy.device
    ang = (angle * float(np.float32(math.pi / 180.0))).to(torch.float64)
    ca = torch.cos(ang).to(torch.float32)[..., None]
    sa = torch.sin(ang).to(torch.float32)[..., None]
    px, py = tabs.px, tabs.py
    rx = torch.round(px * ca - py * sa).to(torch.int64)
    ry = torch.round(px * sa + py * ca).to(torch.int64)
    cy = _ref101(iy[..., None] + ry, H).clamp(0, H - 1)
    cx = _ref101(ix[..., None] + rx, W).clamp(0, W - 1)
    base = (torch.arange(B, device=dev) * (H * W))[:, None, None]
    v = blurred[cy * W + cx + base].to(torch.int16)  # (B, N, P)
    if wta_k == 2:
        lo = v.reshape(B, N, 256, 2)
        codes = (lo[..., 0] < lo[..., 1]).to(torch.int32)  # (B, N, 256)
        group, bits = 8, 1
    else:
        lo = v.reshape(B, N, 128, wta_k)
        if wta_k == 3:
            t0, t1, t2 = lo.unbind(-1)
            codes = torch.where(t2 > t1, torch.where(t2 > t0, 2, 0), (t1 > t0).to(torch.int64))
        else:  # wta_k == 4: tournament of 4 (orb.cpp:307)
            t0, t1, t2, t3 = lo.unbind(-1)
            codes = torch.where(torch.maximum(t0, t1) > torch.maximum(t2, t3),
                                (t1 > t0).to(torch.int64), 2 + (t3 > t2).to(torch.int64))
        codes = codes.to(torch.int32)
        group, bits = 4, 2
    shifts = torch.arange(group, dtype=torch.int32, device=dev) * bits
    return (codes.reshape(B, N, 32, group) << shifts).sum(-1).to(torch.uint8)


def _level_cand_desc(lvl, tabs, half_patch: int, n2: int, cap: int, wta_k: int, dcap: int,
                     nper: int, is_harris: bool):
    """Candidates and descriptors of one level from its prepared maps.

    Returns ``(cand, n_ge, n_ge2, desc)``: (B, dcap, 4) float32 rows of
    (response, y, x, angle) sorted by response (−inf past the last
    candidate), the tie counts at the two retainBest boundaries (the host
    regrows the pools when they reach past them), and (B, dcap, 32) u8
    descriptors."""
    pooled = lvl["pooled"]
    H, W, W2 = lvl["H"], lvl["W"], lvl["W2"]
    cap = min(cap, pooled.shape[1])
    vals, pidx = torch.topk(pooled, cap, dim=1)
    off = lvl["win1"].gather(1, pidx).to(torch.int64)
    iy = pidx // W2
    ix = (pidx % W2) * 2 + off

    dcap = min(dcap, cap)

    # tie count at the retainBest(n2) boundary over the pool: n_ge == cap
    # means the ties may reach past the pool (the host regrows it)
    boundary = vals[:, min(n2, cap) - 1]
    n_ge = torch.where(torch.isfinite(boundary), (vals >= boundary[:, None]).sum(1),
                       torch.isfinite(vals).sum(1)).to(torch.int32)

    hp = half_patch
    imgp, Hp, Wp = lvl["imgp"], lvl["Hp"], lvl["Wp"]
    if is_harris:
        # sparse HarrisResponses (orb.cpp:131): Sobel 3x3 and the 7x7 block
        # sums as exact int32 arithmetic on 9-row windows; padded row
        # iy + hp - 4 is source row iy - 4
        hpat = _gather_win(imgp, Hp, Wp, iy + hp - 4, ix, 9)  # (B, cap, 9, 32)
        right, left = hpat[:, :, :, 2:], hpat[:, :, :, :-2]
        gx = ((right[:, :, :7] + 2 * right[:, :, 1:8] + right[:, :, 2:9])
              - (left[:, :, :7] + 2 * left[:, :, 1:8] + left[:, :, 2:9]))
        top, bot = hpat[:, :, :7, 1:-1], hpat[:, :, 2:9, 1:-1]
        gy = ((bot[:, :, :, :-2] + 2 * bot[:, :, :, 1:-1] + bot[:, :, :, 2:])
              - (top[:, :, :, :-2] + 2 * top[:, :, :, 1:-1] + top[:, :, :, 2:]))
        # gx[..., j] sits at image column x + j - 14, gy[..., c] at x + c - 13:
        # keep the 7x7 block (columns x-3..x+3) of each
        gxw, gyw = gx[:, :, :, 11:18], gy[:, :, :, 10:17]
        aa = (gxw * gxw).sum((2, 3)).to(torch.float32)
        bb = (gyw * gyw).sum((2, 3)).to(torch.float32)
        cc = (gxw * gyw).sum((2, 3)).to(torch.float32)
        scale_h = np.float32(1.0 / ((1 << 2) * 7 * 255.0))
        s4 = float(np.float32(scale_h ** 4))
        k = float(np.float32(HARRIS_K))
        resp = (aa * bb - cc * cc - k * (aa + bb) * (aa + bb)) * s4
        # rescore only the tie-extended retainBest(n2) set (orb.cpp:899)
        resp = torch.where((vals >= boundary[:, None]) & torch.isfinite(vals), resp, -math.inf)
        rvals, rord = torch.topk(resp, dcap, dim=1)
        iy_d, ix_d = iy.gather(1, rord), ix.gather(1, rord)
        out_score = rvals
        boundary2 = rvals[:, min(nper, dcap) - 1]
        n_ge2 = torch.where(torch.isfinite(boundary2)[:, None], resp >= boundary2[:, None],
                            resp > -math.inf).sum(1).to(torch.int32)
    else:
        iy_d, ix_d = iy[:, :dcap], ix[:, :dcap]
        out_score = vals[:, :dcap]
        n_ge2 = n_ge

    # IC moments over the window of rows iy_d-hp..iy_d+hp (padded rows
    # iy_d..iy_d+2hp): integer sums, every one below 2^24
    patches = _gather_win(imgp, Hp, Wp, iy_d, ix_d, 2 * hp + 1)
    m10 = (patches * tabs.w10).sum((2, 3)).to(torch.float32)
    m01 = (patches * tabs.w01).sum((2, 3)).to(torch.float32)
    angle = _fast_atan2(m01, m10)
    cand = torch.stack([out_score, iy_d.to(torch.float32), ix_d.to(torch.float32), angle], -1)

    desc = _rotated_brief(lvl["blurred"], H, W, iy_d, ix_d, angle, tabs, wta_k)
    return cand, n_ge, n_ge2, desc


class ORB:
    """cv2.ORB-compatible detector/descriptor."""

    def __init__(self, nfeatures=500, scaleFactor=1.2, nlevels=8,
                 edgeThreshold=31, firstLevel=0, WTA_K=2,
                 scoreType=K.ORB_HARRIS_SCORE, patchSize=31,
                 fastThreshold=20):
        assert WTA_K in (2, 3, 4), "WTA_K must be 2, 3 or 4"
        assert firstLevel == 0, "firstLevel != 0 not implemented"
        self.wta_k = WTA_K
        self.nfeatures = nfeatures
        self.scale_factor = scaleFactor
        self.nlevels = nlevels
        self.edge_threshold = edgeThreshold
        self.patch_size = patchSize
        self.fast_threshold = fastThreshold
        self.score_type = scoreType
        self._tables = {}

    # -- cv2 API ------------------------------------------------------
    def detect(self, image, mask=None):
        return self.detectAndCompute(image, mask, compute_desc=False)[0]

    def compute(self, image, keypoints):
        return keypoints, self._describe(image, keypoints)

    def _budget(self):
        """Per-level feature budget (orb.cpp:841-849, float32 arithmetic)."""
        nlevels = self.nlevels
        factor = np.float32(1.0 / self.scale_factor)
        ndesired = np.float32(self.nfeatures * (1 - factor)
                              / (1 - factor ** np.float32(nlevels)))
        nper = []
        sumf = 0
        for lv in range(nlevels - 1):
            nper.append(int(np.rint(ndesired)))
            sumf += nper[-1]
            ndesired = np.float32(ndesired * factor)
        nper.append(max(self.nfeatures - sumf, 0))
        return nper

    def _pools(self):
        """Per level: the feature budget, the retainBest(n2) count the
        Harris rescore starts from, and the first candidate-pool and
        shipped-row sizes (budget + tie headroom; the tie counts regrow
        them only on score-tie storms)."""
        nper = self._budget()
        f = 2 if self.score_type == K.ORB_HARRIS_SCORE else 1
        n2s = [max(f * n, 1) for n in nper]
        caps = [max(f * n + 128, 256) for n in nper]
        dcaps = [min(n + 64, c) for n, c in zip(nper, caps)]
        return nper, n2s, caps, dcaps

    def _tables_for(self, H: int, W: int, device) -> _Tables:
        key = (H, W, str(device))
        if key not in self._tables:
            self._tables[key] = _Tables(self, H, W, device)
        return self._tables[key]

    def detect_and_compute_batch(self, images, compute_desc=True):
        """(B, H, W) u8 batch (a tensor on any device, or numpy) → list of
        (keypoints, descriptors) per image, descriptors as (n, 32) u8 numpy.

        The device builds every level's maps once, then the candidate stage
        of all levels; the host reads the tie counts (one sync) and regrows
        the pools of the levels whose ties reach past them, then reads the
        candidates and descriptors (:meth:`_device_rows`) and runs the
        retainBest cut and the KeyPoint packing (:meth:`_host_tail`)."""
        return self._host_tail(*self._device_rows(images), compute_desc)

    def _device_rows(self, images):
        """(L, B, rows, 4) candidates and (L, B, rows, 32) descriptors of a
        batch, as numpy (see :func:`_level_cand_desc`)."""
        x = as_tensor(images)
        if x.ndim == 2:
            x = x[None]
        if x.dtype != torch.uint8 or x.ndim != 3:
            raise ValueError(f"ORB: expected a (B, H, W) uint8 batch, got "
                             f"{tuple(x.shape)} {x.dtype}")
        tabs = self._tables_for(x.shape[1], x.shape[2], x.device)
        return self._read_rows(self._candidates(self._levels(x, tabs), tabs))

    def _levels(self, x, tabs):
        """The prepared maps of every level (:func:`_level_prepare`) of a
        (B, H, W) u8 batch, the pyramid built by INTER_LINEAR_EXACT."""
        levels = []
        cur = x[..., None]
        for lv, size in enumerate(tabs.sizes):
            if lv:
                cur = resize(cur, size, interpolation=K.INTER_LINEAR_EXACT)
            levels.append(_level_prepare(cur, self.fast_threshold, self.edge_threshold,
                                         tabs.pad[lv]))
        return levels

    def _candidates(self, levels, tabs):
        """:func:`_level_cand_desc` of every level, rerun with larger pools
        until no tie count reaches past them (one host read per pass)."""
        nper, n2s, caps, dcaps = self._pools()
        is_harris = self.score_type == K.ORB_HARRIS_SCORE
        while True:
            outs = []
            for lv, lvl in enumerate(levels):
                hw = lvl["H"] * lvl["W"]
                outs.append(_level_cand_desc(
                    lvl, tabs, self.patch_size // 2, n2s[lv], min(caps[lv], hw), self.wta_k,
                    dcap=min(dcaps[lv], caps[lv], hw), nper=max(nper[lv], 1),
                    is_harris=is_harris))
            counts = torch.stack([torch.stack([o[1] for o in outs]),
                                  torch.stack([o[2] for o in outs])]).cpu().numpy()
            n_ge, n_ge2 = counts  # (L, B) each
            over = [lv for lv in range(len(levels)) if (n_ge[lv] >= caps[lv]).any()]
            over2 = [lv for lv in range(len(levels)) if (n_ge2[lv] > dcaps[lv]).any()]
            if not over and not over2:
                return outs
            for lv in over:  # FAST tie storm: grow the candidate pool
                caps[lv] = int(max(2 * n_ge[lv].max(), 2 * caps[lv]))
            for lv in over2:  # response ties past the shipped rows
                dcaps[lv] = int(max(2 * n_ge2[lv].max(), 2 * dcaps[lv]))
                caps[lv] = max(caps[lv], dcaps[lv])

    @staticmethod
    def _read_rows(outs):
        """Every level's rows padded to the common row count, read back as
        numpy (two copies to the host)."""
        dcapmax = max(o[0].shape[1] for o in outs)
        cand_np = torch.stack([F.pad(o[0], (0, 0, 0, dcapmax - o[0].shape[1]),
                                     value=-math.inf) for o in outs]).cpu().numpy()
        desc_np = torch.stack([F.pad(o[3], (0, 0, 0, dcapmax - o[3].shape[1]))
                               for o in outs]).cpu().numpy()
        return cand_np, desc_np

    def _host_tail(self, cand_np, desc_np, compute_desc=True):
        """retainBest per (level, image) over the shipped rows, then the
        KeyPoint lists and descriptor rows: (L, B, rows, 4) candidates
        sorted by response and (L, B, rows, 32) descriptors, numpy."""
        nlevels, B = cand_np.shape[:2]
        nper = self._budget()
        finite = np.isfinite(cand_np[:, :, :, 0])          # (L, B, cap)
        ncand = finite.sum(axis=2)                          # (L, B)
        m_lb = np.zeros((nlevels, B), np.int64)
        for lv in range(nlevels):
            nl = nper[lv]
            for b in range(B):
                n = int(ncand[lv, b])
                if n == 0:
                    continue
                resp = cand_np[lv, b, :n, 0]               # sorted desc
                if n > nl:
                    cut = resp[nl - 1]
                    m_lb[lv, b] = np.searchsorted(-resp, -cut, side="right")
                else:
                    m_lb[lv, b] = n
        scales = np.asarray(layer_scales(self.scale_factor, nlevels), np.float32)
        results = []
        for b in range(B):
            ms = m_lb[:, b]
            lv_idx = np.repeat(np.arange(nlevels), ms)
            row_idx = np.concatenate(
                [np.arange(m) for m in ms]) if ms.sum() else np.zeros(0, np.int64)
            fin = cand_np[lv_idx, b, row_idx]               # (M, 4)
            sf = scales[lv_idx]
            xs = fin[:, 2] * sf
            ys = fin[:, 1] * sf
            szs = self.patch_size * sf
            all_kps = [KeyPoint(float(xs[i]), float(ys[i]), float(szs[i]),
                                float(fin[i, 3]), float(fin[i, 0]), int(lv_idx[i]))
                       for i in range(len(lv_idx))]
            desc = desc_np[lv_idx, b, row_idx]
            results.append((all_kps, desc if compute_desc else None))
        return results

    def detectAndCompute(self, image, mask=None, compute_desc=True):
        img = as_tensor(image)
        if img.ndim == 3:
            img = cvtColor(img, K.COLOR_BGR2GRAY)
        return self.detect_and_compute_batch(img[None], compute_desc=compute_desc)[0]

    # -- descriptors ---------------------------------------------------
    def _describe(self, image, keypoints):
        """Descriptors of given keypoints, on the image's device: the
        pyramid and the 7×7 blur of every level as the batch path builds
        them (``sep_filter``'s kernel on the card), then the batch path's
        sampler (:func:`_rotated_brief`) at each keypoint's level pixel,
        read back once.  The level pixel is the reference's
        ``cvRound(pt / scale)``."""
        img = as_tensor(image)
        if img.ndim == 3:
            img = cvtColor(img, K.COLOR_BGR2GRAY)
        H, W = img.shape
        tabs = self._tables_for(H, W, img.device)
        scales = layer_scales(self.scale_factor, self.nlevels)
        octave = np.asarray([k.octave for k in keypoints], np.int64)
        order, descs = [], []
        cur = img[None, ..., None]
        for lv, size in enumerate(tabs.sizes):
            if lv:
                cur = resize(cur, size, interpolation=K.INTER_LINEAR_EXACT)
            blurred = GaussianBlur(cur, (7, 7), 2.0, 2.0, K.BORDER_REFLECT_101)
            sel = np.flatnonzero(octave == lv)
            if not len(sel):
                continue
            inv = np.float32(1.0 / scales[lv])
            kps = [keypoints[i] for i in sel]
            pos = torch.tensor([[int(np.rint(k.pt[1] * inv)) for k in kps],
                                [int(np.rint(k.pt[0] * inv)) for k in kps]]).to(img.device)
            angle = torch.tensor([[k.angle for k in kps]], dtype=torch.float32).to(img.device)
            descs.append(_rotated_brief(blurred.reshape(-1), size[1], size[0], pos[:1], pos[1:],
                                        angle, tabs, self.wta_k)[0])
            order.append(sel)
        out = np.zeros((len(keypoints), 32), np.uint8)
        if descs:
            out[np.concatenate(order)] = torch.cat(descs).cpu().numpy()
        return out


def ORB_create(nfeatures=500, scaleFactor=1.2, nlevels=8, edgeThreshold=31,
               firstLevel=0, WTA_K=2, scoreType=K.ORB_HARRIS_SCORE,
               patchSize=31, fastThreshold=20):
    return ORB(nfeatures, scaleFactor, nlevels, edgeThreshold, firstLevel,
               WTA_K, scoreType, patchSize, fastThreshold)
