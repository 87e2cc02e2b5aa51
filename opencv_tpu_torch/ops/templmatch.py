"""matchTemplate, all six TM_* modes (imgproc/src/templmatch.cpp), twin of
``opencv_tpu/ops/templmatch.py``.

The JAX package's design, with two changes for the card:

- The cross-correlation takes direct taps (shifted multiply-adds in f32)
  for templates of at most 64 taps, as the reference does, and
  ``torch.fft.rfft2``/``irfft2`` in f32 over an (N, C, H, W) copy above
  that: cv2's own crossCorr strategy (templmatch.cpp:566).  No cuDNN
  convolution: on the card it would run f32 in TF32, where the reference
  asks for ``Precision.HIGHEST``.
- The window sums of x and x² are exact: an int64 cumsum for integer
  input, f64 for float input, as cv2's integrals (CV_64F) are.  The JAX
  package takes them in f32 because the TPU has no f64; at 1080p the
  running sum of x² reaches ~1.3e11, where f32 values lie 8192 apart.  The
  normalisation then runs in f64, and the result is f32.

The masked modes (matchTemplateMask, templmatch.cpp:762) take per-channel
correlations as shifted multiply-adds in f64.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as K
from ..core.arrays import to_batched, from_batched

__all__ = ["matchTemplate"]

# templates of at most this many taps take direct taps, larger ones the FFT
# (the reference's crossover, opencv_tpu/ops/templmatch.py:73)
MAX_DIRECT_TAPS = 64


def _window_sums(x, th: int, tw: int):
    """Sliding-window sums of x and x² over th×tw windows (valid), summed
    over channels, exact: (N, H-th+1, W-tw+1, 1) f64 each."""
    acc = torch.float64 if x.is_floating_point() else torch.int64
    xa = x.to(acc)
    H, W = x.shape[1] - th + 1, x.shape[2] - tw + 1

    def win(v):
        s = torch.nn.functional.pad(v.cumsum(1).cumsum(2), (0, 0, 1, 0, 1, 0))
        w = (s[:, th:th + H, tw:tw + W] - s[:, th:th + H, :W]
             - s[:, :H, tw:tw + W] + s[:, :H, :W])
        return w.sum(3, keepdim=True).to(torch.float64)

    return win(xa), win(xa * xa)


def _corr_taps(x, t, dtype):
    """Valid cross-correlation of each channel of x (N, H, W, C) with the
    same channel of t (th, tw, C), as shifted multiply-adds in `dtype`:
    (N, H-th+1, W-tw+1, C)."""
    th, tw = t.shape[0], t.shape[1]
    oh, ow = x.shape[1] - th + 1, x.shape[2] - tw + 1
    xf, tf = x.to(dtype), t.to(dtype)
    acc = None
    for i in range(th):
        for j in range(tw):
            term = xf[:, i:i + oh, j:j + ow, :] * tf[i, j]
            acc = term if acc is None else acc + term
    return acc


def _cross_corr_fft(x, t):
    """Valid cross-correlation summed over channels by rfft2 in f32."""
    N, H, W, C = x.shape
    th, tw = t.shape[0], t.shape[1]
    xf = torch.fft.rfft2(x.permute(0, 3, 1, 2).to(torch.float32).contiguous())
    tf = torch.fft.rfft2(t.permute(2, 0, 1).to(torch.float32), s=(H, W))
    corr = torch.fft.irfft2(xf * tf.conj(), s=(H, W))
    return corr[:, :, :H - th + 1, :W - tw + 1].sum(1)[..., None]


def _cross_corr(x, t):
    """Valid cross-correlation summed over channels, f32:
    (N, H-th+1, W-tw+1, 1)."""
    if t.shape[0] * t.shape[1] <= MAX_DIRECT_TAPS:
        return _corr_taps(x, t, torch.float32).sum(3, keepdim=True)
    return _cross_corr_fft(x, t)


def _template(templ, device):
    """The template as an (th, tw, C) tensor on `device`."""
    t, _ = to_batched(templ)
    return t[0].to(device)


def matchTemplate(image, templ, method: int, mask=None):
    """cv2-compatible matchTemplate; the result is (H-th+1)×(W-tw+1) f32.
    Masks follow the reference (templmatch.cpp:762 matchTemplateMask): u8
    masks are binary, float masks are weights; all six modes."""
    if mask is not None:
        return _match_template_masked(image, templ, method, mask)
    if method not in range(K.TM_SQDIFF, K.TM_CCOEFF_NORMED + 1):
        raise ValueError(f"unknown matchTemplate method {method}")
    x, meta = to_batched(image)
    t3 = _template(templ, x.device)
    th, tw, C = t3.shape
    area = float(th * tw * C)

    corr = _cross_corr(x, t3)
    if method == K.TM_CCORR:
        return from_batched(corr, meta)

    corr = corr.to(torch.float64)
    wsum, wsum2 = _window_sums(x, th, tw)
    tf = t3.to(torch.float64)
    tnorm2 = (tf * tf).sum()
    if method == K.TM_CCORR_NORMED:
        den = torch.sqrt((tnorm2 * wsum2).clamp(min=0))
        out = torch.where(den > 0, corr / den, 1.0)
    elif method in (K.TM_SQDIFF, K.TM_SQDIFF_NORMED):
        out = (wsum2 - 2.0 * corr + tnorm2).clamp(min=0)
        if method == K.TM_SQDIFF_NORMED:
            den = torch.sqrt((tnorm2 * wsum2).clamp(min=0))
            out = torch.where(den > 0, out / den, 1.0)
    else:
        tmean = tf.mean()
        num = corr - wsum * tmean
        if method == K.TM_CCOEFF:
            out = num
        else:
            tvar = ((tf - tmean) ** 2).sum()
            wvar = (wsum2 - wsum * wsum / area).clamp(min=0)
            den = torch.sqrt((tvar * wvar).clamp(min=0))
            # flat-patch guards (templmatch.cpp:1005-1016)
            out = torch.where(den > num.abs() * 1e-7, num / den,
                              torch.where(num.abs() < 1e-7, 0.0, torch.sign(num)))
    return from_batched(out.to(torch.float32), meta)


def _match_template_masked(image, templ, method, mask):
    x, meta = to_batched(image)
    f64 = torch.float64
    t3 = _template(templ, x.device).to(f64)
    C = t3.shape[2]
    m = mask.cpu().numpy() if isinstance(mask, torch.Tensor) else np.asarray(mask)
    m = (m != 0) if m.dtype == np.uint8 else m
    m = m.astype(np.float64)
    if m.ndim == 2:
        m = m[..., None]
    if m.shape[-1] == 1 and C > 1:
        m = np.repeat(m, C, axis=-1)
    mj = torch.from_numpy(m).to(x.device)
    m2 = mj * mj

    xf = x.to(f64)
    x2 = xf * xf

    def corr_pc(img, kern):
        return _corr_taps(img, kern, f64)

    def csum(v):
        return v.sum(3, keepdim=True)

    if method in (K.TM_SQDIFF, K.TM_SQDIFF_NORMED):
        # matchTemplateMask (templmatch.cpp:799-818)
        t2m2_sum = ((t3 * mj) ** 2).sum()
        temp = csum(corr_pc(x2, m2))
        out = -2.0 * csum(corr_pc(xf, t3 * m2)) + temp + t2m2_sum
        if method == K.TM_SQDIFF_NORMED:
            out = out / torch.sqrt(t2m2_sum * temp)
    elif method in (K.TM_CCORR, K.TM_CCORR_NORMED):
        out = csum(corr_pc(xf, t3 * m2))
        if method == K.TM_CCORR_NORMED:
            t2m2_sum = ((t3 * mj) ** 2).sum()
            temp = csum(corr_pc(x2, m2))
            out = out / torch.sqrt(t2m2_sum * temp)
    elif method in (K.TM_CCOEFF, K.TM_CCOEFF_NORMED):
        # per-channel Scalar sums (templmatch.cpp:839-906)
        mask_sum = mj.sum((0, 1))                        # (C,)
        mt_sum = (mj * t3).sum((0, 1))                   # (C,)
        tx = t3 - mt_sum / mask_sum
        templx_mask = m2 * tx
        corr_txm = csum(corr_pc(xf, templx_mask))
        img_mask_corr = corr_pc(xf, mj)                  # per channel
        txm_sum = templx_mask.sum((0, 1))                # (C,)
        out = corr_txm - csum(img_mask_corr * (txm_sum / mask_sum))
        if method == K.TM_CCOEFF_NORMED:
            norm_tx = torch.sqrt(((mj * tx) ** 2).sum())
            mask2_sum = m2.sum((0, 1))                   # (C,)
            norm_imgx = csum(corr_pc(x2, m2))
            img_mask2_corr = corr_pc(xf, m2)
            temp = (img_mask_corr / mask_sum
                    * (img_mask_corr * (mask2_sum / mask_sum) - 2.0 * img_mask2_corr))
            norm_imgx = torch.sqrt(norm_imgx + csum(temp))
            out = out / (norm_imgx * norm_tx)
    else:
        raise ValueError(f"unknown matchTemplate method {method}")
    return from_batched(out.to(torch.float32), meta)
