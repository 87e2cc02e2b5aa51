"""Background subtraction: Zivkovic's adaptive GMM (MOG2,
video/src/bgfg_gaussmix2.cpp) and the KNN subtractor
(video/src/bgfg_KNN.cpp); twin of ``opencv_tpu/video/bgsub.py``.

The per-pixel state lives on the frame's device and each ``apply`` is one
elementwise step there, as eager torch:

- MOG2 keeps (N, H, W, K) weights and variances and (N, H, W, K, C) means,
  re-sorted by weight after each update with a stable sort (JAX's argsort
  is stable; the first frames' weights tie at zero), and its first-fit and
  weakest-mode picks take the first index, as jnp.argmax / argmin do;
- KNN keeps (3·nN, H, W, C) samples and their flags; its update cadences
  draw from ``np.random.default_rng(12345)`` on the host in the JAX
  package's order, and the draws are uploaded.

Sums over channels and modes are written out in order, so the card and the
CPU add the same values the same way; against the JAX package run eagerly
the masks and states are equal, and against its jitted step (where XLA
contracts multiply-adds) they agree within ROADMAP.md queue C's bound."""

from __future__ import annotations

import numpy as np
import torch

from ..core.arrays import as_tensor, to_batched, from_batched, to_device

__all__ = ["BackgroundSubtractorMOG2", "createBackgroundSubtractorMOG2",
           "BackgroundSubtractorKNN", "createBackgroundSubtractorKNN"]

_F32 = torch.float32


def _sum_last(a):
    """Σ over the last axis, in order from the first element."""
    s = a[..., 0]
    for i in range(1, a.shape[-1]):
        s = s + a[..., i]
    return s


def _first_true(b):
    """The first index along the last axis where `b` holds (0 where none)."""
    return torch.argmax(b.to(torch.uint8), dim=-1)


def _one_hot(idx, K: int):
    return torch.nn.functional.one_hot(idx, K).to(_F32)


def _mog2_step(frame, weights, means, variances, K: int, lr, var_thresh, var_thresh_gen,
               var_init, var_min, var_max, back_ratio, shadow_thresh, detect_shadows,
               lr_ct):
    """One MOG2 update. frame: (N,H,W,C) f32; state: (N,H,W,K[,C]); the
    scalars are f32 (``lr_ct`` is lr·ct in f32, and ``lr`` a 0-dim tensor
    on the frame's device, which divides)."""
    x = frame[..., None, :]                       # (N,H,W,1,C)
    d = x - means                                  # (N,H,W,K,C)
    dist2 = _sum_last(d * d)                       # (N,H,W,K)

    fits_gen = dist2 < var_thresh_gen * variances
    fit_any = fits_gen.any(dim=-1)
    first_fit = _first_true(fits_gen)
    onehot = _one_hot(first_fit, K) * fit_any[..., None].to(_F32)

    # weight update: w += lr*(o - w) - lr*ct  (prune term)
    w = weights + lr * (onehot - weights) - lr_ct
    # mean/var update for the matched mode
    k_rate = (lr / torch.clamp(weights, min=1e-6)) * onehot
    k_rate = torch.clamp(k_rate, max=1.0)[..., None]
    means_new = means + k_rate * d
    var_new = variances + k_rate[..., 0] * (dist2 - variances)
    var_new = torch.clamp(var_new, var_min, var_max)

    # no fit → replace the weakest mode with a new one centred at x
    weakest = torch.argmin(w, dim=-1)
    repl = (_one_hot(weakest, K) * (~fit_any)[..., None].to(_F32)) > 0
    w = torch.where(repl, lr, w)
    means_new = torch.where(repl[..., None], x, means_new)
    var_new = torch.where(repl, torch.full((), var_init, dtype=_F32, device=w.device), var_new)

    # prune negative weights, renormalize
    w = torch.clamp(w, min=0.0)
    w = w / torch.clamp(_sum_last(w), min=1e-6)[..., None]

    # resort the modes by descending weight (stable)
    order = torch.sort(-w, dim=-1, stable=True).indices
    w = torch.gather(w, -1, order)
    var_new = torch.gather(var_new, -1, order)
    means_new = torch.gather(means_new, -2, order[..., None].expand_as(means_new))

    # background = the strongest modes summing to back_ratio
    cumw = torch.stack([_sum_last(w[..., :i + 1]) for i in range(K)], dim=-1)
    is_bg_mode = (cumw - w) < back_ratio
    e = x - means_new
    d2 = _sum_last(e * e)
    is_bg = ((d2 < var_thresh * var_new) & is_bg_mode).any(dim=-1)

    fg = torch.where(is_bg, 0, 255).to(torch.uint8)

    if detect_shadows:
        # shadow: a darker version of the background mode (Prati et al.)
        m0 = means_new[..., 0, :]
        num = _sum_last(frame * m0)
        den = _sum_last(m0 * m0)
        tau = num / torch.clamp(den, min=1e-6)
        r = frame - tau[..., None] * m0
        dist_sh = _sum_last(r * r)
        shadow = (~is_bg) & (tau > shadow_thresh) & (tau <= 1.0) \
            & (dist_sh < var_thresh * var_new[..., 0])
        fg = torch.where(shadow, torch.full((), 127, dtype=torch.uint8, device=fg.device), fg)

    return fg, w, means_new, var_new


class BackgroundSubtractorMOG2:
    """cv2.BackgroundSubtractorMOG2-compatible (Zivkovic GMM), its state on
    the frames' device."""

    def __init__(self, history=500, varThreshold=16.0, detectShadows=True):
        self.history = history
        self.var_threshold = float(varThreshold)
        self.detect_shadows = bool(detectShadows)
        self.nmixtures = 5
        self.background_ratio = 0.9
        self.var_init = 15.0
        self.var_min = 4.0
        self.var_max = 5 * 15.0
        self.var_threshold_gen = 9.0
        self.shadow_threshold = 0.5
        self.ct = 0.05
        self.frame_count = 0
        self._state = None

    def apply(self, image, learningRate: float = -1.0):
        """The foreground mask of `image` ((H, W), (H, W, C) or (N, H, W,
        C) u8): 0 background, 127 shadow, 255 foreground, a u8 tensor on
        the image's device in the image's layout."""
        x, meta = to_batched(image)
        f = x.to(_F32)
        N, H, W, C = f.shape
        K = self.nmixtures
        if self._state is None:
            w = torch.zeros((N, H, W, K), dtype=_F32, device=f.device)
            m = torch.zeros((N, H, W, K, C), dtype=_F32, device=f.device)
            v = torch.full((N, H, W, K), self.var_init, dtype=_F32, device=f.device)
            self._state = (w, m, v)
        self.frame_count += 1
        if learningRate < 0:
            lr = 1.0 / min(2 * self.frame_count, self.history)
        else:
            lr = learningRate
        f32 = np.float32
        w, m, v = self._state
        fg, w, m, v = _mog2_step(
            f, w, m, v, K, torch.full((), f32(lr), dtype=_F32, device=f.device),
            f32(self.var_threshold), f32(self.var_threshold_gen), f32(self.var_init),
            f32(self.var_min), f32(self.var_max), f32(self.background_ratio),
            f32(self.shadow_threshold), self.detect_shadows, f32(lr) * f32(self.ct))
        self._state = (w, m, v)
        return from_batched(fg[..., None], meta)

    def getBackgroundImage(self):
        """The strongest mode's mean of image 0, rounded to u8, on the
        state's device (None before the first frame)."""
        if self._state is None:
            return None
        w, m, v = self._state
        bg = torch.clamp(torch.round(m[..., 0, :]), 0, 255).to(torch.uint8)
        return from_batched(bg, "nhwc")[0]

    # cv2 setters/getters subset
    def setHistory(self, h):
        self.history = h

    def getHistory(self):
        return self.history

    def setVarThreshold(self, t):
        self.var_threshold = t

    def getVarThreshold(self):
        return self.var_threshold

    def setDetectShadows(self, b):
        self.detect_shadows = bool(b)

    def getDetectShadows(self):
        return self.detect_shadows


def createBackgroundSubtractorMOG2(history=500, varThreshold=16.0,
                                   detectShadows=True):
    return BackgroundSubtractorMOG2(history, varThreshold, detectShadows)


# --------------------------------------------------------------- KNN

def _knn_step(data, samples, flags, idxS, idxM, idxL, nextS, nextM, nextL,
              cS, cM, cL, fTb, fTau, nN, nkNN, detect_shadows, shadow_val):
    """One KNN background step (video/src/bgfg_KNN.cpp:345-482).

    data: (H, W, C) f32; samples: (3nN, H, W, C) f32; flags: (3nN, H, W);
    idx*/next*: (H, W) int64; c* ints.  Returns (mask, new state...)."""
    d = samples - data[None]                        # (S,H,W,C)
    dist2 = _sum_last(d * d)                        # (S,H,W)
    close = dist2 < fTb
    Pbf = close.sum(dim=0)
    Pb = (close & (flags > 0)).sum(dim=0)
    is_bg = Pb >= nkNN
    include = (is_bg | (Pbf >= nkNN)).to(_F32)

    if detect_shadows:
        num = _sum_last(samples * data[None])
        den = _sum_last(samples * samples)
        bgflag = flags > 0
        bad = (bgflag & (den == 0)).any(dim=0)
        a = num / torch.clamp(den, min=1e-12)
        cond = bgflag & (num <= den) & (num >= fTau * den)
        dd = a[..., None] * samples - data[None]
        dist2a = _sum_last(dd * dd)
        Ps = (cond & (dist2a < fTb * a * a)).sum(dim=0)
        is_shadow = (~is_bg) & (~bad) & (Ps >= nkNN)
    else:
        is_shadow = torch.zeros_like(is_bg)

    mask = torch.where(is_bg, 0, torch.where(is_shadow, shadow_val, 255)).to(torch.uint8)

    # model update: the old values gathered first, like the sequential
    # long <- mid <- short copy order of _cvUpdatePixelBackgroundNP
    S = 3 * nN

    def gather(arr, idx):
        if arr.ndim == 4:
            return torch.gather(arr, 0, idx[None, ..., None].expand(1, *arr.shape[1:]))[0]
        return torch.gather(arr, 0, idx[None])[0]

    old_mid = gather(samples, idxM + nN)
    old_mid_flag = gather(flags, idxM + nN)
    old_short = gather(samples, idxS)
    old_short_flag = gather(flags, idxS)

    upL = nextL == cL
    upM = nextM == cM
    upS = nextS == cS

    slots = torch.arange(S, device=data.device)[:, None, None]
    selL = (slots == (idxL + 2 * nN)[None]) & upL[None]
    selM = (slots == (idxM + nN)[None]) & upM[None]
    selS = (slots == idxS[None]) & upS[None]

    samples = torch.where(selL[..., None], old_mid[None], samples)
    flags = torch.where(selL, old_mid_flag[None], flags)
    samples = torch.where(selM[..., None], old_short[None], samples)
    flags = torch.where(selM, old_short_flag[None], flags)
    samples = torch.where(selS[..., None], data[None], samples)
    flags = torch.where(selS, include[None], flags)

    def bump(idx, up):
        return torch.where(up, torch.where(idx >= nN - 1, 0, idx + 1), idx)

    return (mask, samples, flags, bump(idxS, upS), bump(idxM, upM), bump(idxL, upL))


class BackgroundSubtractorKNN:
    """KNN background subtractor (video/src/bgfg_KNN.cpp): the (3·nN)
    per-pixel sample history is a dense (S, H, W, C) tensor on the frames'
    device; classification is one reduction over the sample axis and the
    three-cadence circular-buffer update a select."""

    def __init__(self, history=500, dist2Threshold=400.0,
                 detectShadows=True):
        self.history = history
        self.fTb = float(dist2Threshold)
        self.detectShadows = detectShadows
        self.nN = 7
        self.nkNN = max(1, int(round(0.1 * self.nN * 3 + 0.40)))
        self.fTau = 0.5
        self.shadow_val = 127
        self._state = None
        self._nframes = 0
        self._rng = np.random.default_rng(12345)

    def _init_state(self, shape, C, device):
        H, W = shape
        S = 3 * self.nN

        def z():
            return torch.zeros((H, W), dtype=torch.int64, device=device)

        self._state = dict(
            samples=torch.zeros((S, H, W, C), dtype=_F32, device=device),
            flags=torch.zeros((S, H, W), dtype=_F32, device=device),
            idxS=z(), idxM=z(), idxL=z(), nextS=z(), nextM=z(), nextL=z(),
        )
        self._cS = self._cM = self._cL = 0
        self._nframes = 0
        self._hw = (H, W)
        self._C = C

    def apply(self, image, learningRate=-1.0):
        """The mask of one (H, W) or (H, W, C) u8 frame: 0, the shadow value
        or 255, an (H, W) u8 tensor on the frame's device."""
        img = as_tensor(image)
        if img.ndim == 2:
            img = img[..., None]
        H, W, C = img.shape
        if self._state is None or self._hw != (H, W) or self._C != C \
                or learningRate >= 1:
            self._init_state((H, W), C, img.device)
        self._nframes += 1
        lr = learningRate if (learningRate >= 0 and self._nframes > 1) \
            else 1.0 / min(2 * self._nframes, self.history)

        # cadences from the exponential learning curve (bgfg_KNN.cpp:766-775)
        Kshort = int(np.log(0.7) / np.log(1 - lr)) + 1
        Kmid = int(np.log(0.4) / np.log(1 - lr)) - Kshort + 1
        Klong = int(np.log(0.1) / np.log(1 - lr)) - Kshort - Kmid + 1
        nShortUpdate = Kshort // self.nN + 1
        nMidUpdate = Kmid // self.nN + 1
        nLongUpdate = Klong // self.nN + 1

        st = self._state
        mask, samples, flags, idxS, idxM, idxL = _knn_step(
            img.to(_F32), st["samples"], st["flags"],
            st["idxS"], st["idxM"], st["idxL"],
            st["nextS"], st["nextM"], st["nextL"],
            self._cS, self._cM, self._cL,
            np.float32(self.fTb), np.float32(self.fTau),
            self.nN, self.nkNN, self.detectShadows, int(self.shadow_val))
        st.update(samples=samples, flags=flags, idxS=idxS, idxM=idxM, idxL=idxL)

        self._cS += 1
        self._cM += 1
        self._cL += 1

        def randu(hi):
            draw = self._rng.integers(0, max(hi, 1), self._hw, np.int32)
            return to_device(draw.astype(np.int64), img.device)

        if self._cS >= nShortUpdate:
            self._cS = 0
            st["nextS"] = randu(nShortUpdate)
        if self._cM >= nMidUpdate:
            self._cM = 0
            st["nextM"] = randu(nMidUpdate)
        if self._cL >= nLongUpdate:
            self._cL = 0
            st["nextL"] = randu(nLongUpdate)
        return mask

    def getBackgroundImage(self):
        """Each pixel's first background sample, u8, on the state's device
        (None before the first frame)."""
        st = self._state
        if st is None:
            return None
        flags = st["flags"] > 0                          # (S,H,W)
        first = _first_true(flags.permute(1, 2, 0))      # (H,W)
        any_bg = flags.any(dim=0)
        samples = st["samples"]
        bg = torch.gather(samples, 0, first[None, ..., None].expand(1, *samples.shape[1:]))[0]
        bg = torch.where(any_bg[..., None], bg, torch.zeros_like(bg)).to(torch.uint8)
        return bg[..., 0] if bg.shape[-1] == 1 else bg

    # parameter accessors mirroring the reference API
    def setHistory(self, h):
        self.history = h

    def getHistory(self):
        return self.history

    def setDist2Threshold(self, t):
        self.fTb = float(t)

    def getDist2Threshold(self):
        return self.fTb

    def setkNNSamples(self, k):
        self.nkNN = k

    def getkNNSamples(self):
        return self.nkNN

    def setNSamples(self, n):
        self.nN = n
        self._state = None

    def getNSamples(self):
        return self.nN

    def setDetectShadows(self, b):
        self.detectShadows = bool(b)

    def getDetectShadows(self):
        return self.detectShadows

    def setShadowValue(self, v):
        self.shadow_val = int(v)

    def getShadowValue(self):
        return self.shadow_val

    def setShadowThreshold(self, t):
        self.fTau = float(t)

    def getShadowThreshold(self):
        return self.fTau


def createBackgroundSubtractorKNN(history=500, dist2Threshold=400.0,
                                  detectShadows=True):
    return BackgroundSubtractorKNN(history, dist2Threshold, detectShadows)
