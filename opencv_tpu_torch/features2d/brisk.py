"""BRISK (features2d/src/brisk.cpp, Leutenegger et al. 2011), twin of
``opencv_tpu/features2d/brisk.py``.

Detection, batched over the images on their device: the INTER_AREA
pyramid through the port's ``resize`` and AGAST (OAST 9-16) on every
layer (:func:`.agast.agast_dense`); then one read-back of the kept
positions and scores, and on the host the JAX package's cross-scale NMS,
copied.

Description: the five f32 ``GaussianBlur``s of each image on its device;
the 60 pattern reads of every keypoint at once, as one gather from the
stacked blurs with the bilinear weights in f64 (numpy's arithmetic, term by
term); one read-back of the unrotated reads, the orientation over the 393
long pairs in the reference's order (a loop over the pairs, vectorised
over the keypoints) and the angle, the rotation and the sample points per
keypoint on the host with the reference's own numpy expressions; then the
rotated reads and the 512 short-pair bits on the device, packed MSB first.
Descriptors and angles equal the JAX package's exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as K
from ..core.arrays import as_tensor, to_device
from ..ops.color import cvtColor
from ..ops.filter import GaussianBlur
from ..ops.resize import resize
from .agast import OAST_9_16, agast_dense
from .keypoint import KeyPoint
from .sift import _host_views

__all__ = ["BRISK", "BRISK_create"]


def _pattern(scale=1.0):
    """BRISK sampling pattern: rings of points with per-point sigma."""
    radii = np.array([0.0, 2.9, 4.9, 7.4, 10.8]) * scale
    counts = [1, 10, 14, 15, 20]
    sigmas = np.array([0.55, 0.8, 1.1, 1.6, 2.3]) * scale
    pts = []
    sig = []
    for r, n, s in zip(radii, counts, sigmas):
        for k in range(n):
            a = 2 * np.pi * k / n
            pts.append((r * np.cos(a), r * np.sin(a)))
            sig.append(s)
    return np.asarray(pts), np.asarray(sig)


_PTS, _SIG = _pattern()
_N = len(_PTS)

# pair sets (paper: short < 9.75t, long > 13.67t with t = pattern scale)
_DIST = np.linalg.norm(_PTS[:, None] - _PTS[None, :], axis=-1)
_iu = np.triu_indices(_N, 1)
_SHORT = [(i, j) for i, j in zip(*_iu) if _DIST[i, j] < 9.75]
_LONG = [(i, j) for i, j in zip(*_iu) if _DIST[i, j] > 13.67]
_SHORT = _SHORT[:512]

# each long pair's offset and squared length, as the reference takes them
_LONG_D = [_PTS[j] - _PTS[i] for i, j in _LONG]
_LONG_NRM = [max(d @ d, 1e-9) for d in _LONG_D]
# the blur of each pattern point: the index of its rounded sigma
_SIG_R = np.round(_SIG, 2)
_SIGMAS = np.unique(_SIG_R)
_SIG_IDX = np.searchsorted(_SIGMAS, _SIG_R)
_SHORT_I = np.array([i for i, _ in _SHORT], np.int64)
_SHORT_J = np.array([j for _, j in _SHORT], np.int64)


class BRISK:
    def __init__(self, thresh=30, octaves=3, patternScale=1.0):
        self.thresh = thresh
        self.octaves = max(octaves, 1)
        self.patternScale = patternScale

    @staticmethod
    def create(thresh=30, octaves=3, patternScale=1.0):
        return BRISK(thresh, octaves, patternScale)

    # ------------------------------------------------------------ detection
    def pyramid(self, imgs):
        """[(layer, scale)] of an (N, H, W) u8 tensor: each layer (N, h, w)
        on its device, halved by INTER_AREA while its short side allows."""
        layers = []
        cur = imgs
        scale = 1.0
        for o in range(self.octaves):
            layers.append((cur, scale))
            h, w = cur.shape[1:3]
            if min(h, w) // 2 < 32 or o == self.octaves - 1:
                break
            cur = resize(cur[..., None], (w // 2, h // 2), interpolation=K.INTER_AREA)[..., 0]
            scale *= 2.0
        return layers

    def score_layers(self, layers):
        """AGAST's (score, keep) maps of every pyramid layer, on its device."""
        return [agast_dense(layer, self.thresh, OAST_9_16, True) for layer, _ in layers]

    def read_candidates(self, scored, scales):
        """Per image, per layer, the kept (y, x) positions in raster order
        and their scores, as host numpy: one read-back on the card."""
        flat = [k.reshape(-1) for _, k in scored]
        sizes = [f.numel() for f in flat]
        keep = torch.cat(flat)
        idx = torch.nonzero(keep)[:, 0]
        scores = torch.cat([s.reshape(-1) for s, _ in scored])[idx]
        idx_np, sc_np = _host_views([[idx, scores]], keep.device)[0]
        out = []
        B = scored[0][1].shape[0]
        start = 0
        per_layer = []
        for (s, _), n in zip(scored, sizes):
            lo, hi = np.searchsorted(idx_np, [start, start + n])
            h, w = s.shape[1:]
            loc = idx_np[lo:hi] - start
            b, rem = np.divmod(loc, h * w)
            y, x = np.divmod(rem, w)
            per_layer.append((b, y, x, sc_np[lo:hi]))
            start += n
        for img in range(B):
            rows = []
            for (b, y, x, sc), scale in zip(per_layer, scales):
                m = b == img
                rows.append((y[m], x[m], sc[m], scale))
            out.append(rows)
        return out

    def nms(self, rows, mask=None):
        """The JAX package's keypoints and cross-scale NMS over one image's
        candidates."""
        kps = []
        for ys, xs, sc, scale in rows:
            for y, x, s in zip(ys.tolist(), xs.tolist(), sc.tolist()):
                kps.append(KeyPoint(float(x * scale), float(y * scale),
                                    12.0 * scale * self.patternScale,
                                    -1.0, float(s), int(np.log2(scale))))
        # cross-scale NMS: keep the strongest within 3*scale distance
        kps.sort(key=lambda k: -k.response)
        out = []
        taken = np.zeros((0, 3))
        for k in kps:
            x, y = k.pt
            r = 3.0 * (2 ** k.octave)
            if len(out) == 0:
                out.append(k)
                taken = np.array([[x, y, r]])
                continue
            d = np.hypot(taken[:, 0] - x, taken[:, 1] - y)
            if (d > np.maximum(taken[:, 2], r)).all():
                out.append(k)
                taken = np.vstack([taken, [x, y, r]])
        if mask is not None:
            mk = np.asarray(mask)
            out = [k for k in out if mk[int(k.pt[1]), int(k.pt[0])]]
        return out

    def detect_batch(self, imgs, mask=None):
        """(N, H, W) u8 tensor → the keypoints of each image."""
        layers = self.pyramid(imgs)
        rows = self.read_candidates(self.score_layers(layers), [s for _, s in layers])
        return [self.nms(r, mask) for r in rows]

    def detect(self, image, mask=None):
        return self.detect_batch(_gray(image)[None], mask)[0]

    # ---------------------------------------------------------- description
    def blurs(self, imgs):
        """The five f32 pattern blurs of an (N, H, W) image batch, stacked
        (5, N, H, W) in the order of the rounded sigmas."""
        x = imgs.to(torch.float32)[..., None]
        out = []
        for s in _SIGMAS:
            k = max(int(2 * round(3 * s) + 1), 3)
            out.append(GaussianBlur(x, (k, k), float(s))[..., 0])
        return torch.stack(out)

    def _reads(self, blurs, img_idx, pts):
        """The reference's bilinear reads at the (K, 60, 2) f64 pattern
        points of keypoints in images `img_idx`: (K, 60) f32 on the blurs'
        device."""
        _, B, H, W = blurs.shape
        xs = np.clip(pts[..., 0], 0, W - 1)
        ys = np.clip(pts[..., 1], 0, H - 1)
        x0 = np.floor(xs).astype(int)
        y0 = np.floor(ys).astype(int)
        x1 = np.minimum(x0 + 1, W - 1)
        y1 = np.minimum(y0 + 1, H - 1)
        fx = xs - x0
        fy = ys - y0
        base = (_SIG_IDX[None, :] * B + img_idx[:, None]) * (H * W)
        idx = np.stack([base + y0 * W + x0, base + y0 * W + x1,
                        base + y1 * W + x0, base + y1 * W + x1])
        wts = np.stack([1 - fx, fx, 1 - fy, fy])
        dev = blurs.device
        g = blurs.reshape(-1)[to_device(idx.astype(np.int64), dev)].to(torch.float64)
        a, fxd, c, fyd = to_device(wts, dev).unbind(0)
        v = g[0] * a * c + g[1] * fxd * c + g[2] * a * fyd + g[3] * fxd * fyd
        return v.to(torch.float32)

    def _points(self, kps, angles=None):
        """(K, 60, 2) pattern points: unrotated (the reference's R is the
        identity, so they are the scaled pattern plus the keypoint), or
        rotated by each keypoint's angle with the reference's expression."""
        if not kps:
            return np.zeros((0, _N, 2))
        if angles is None:
            scale = np.array([(2.0 ** kp.octave) * self.patternScale for kp in kps])
            pt = np.array([kp.pt for kp in kps])
            return _PTS[None] * scale[:, None, None] + pt[:, None, :]
        out = np.empty((len(kps), _N, 2))
        for k, (kp, ang) in enumerate(zip(kps, angles)):
            scale = (2.0 ** kp.octave) * self.patternScale
            c, s = np.cos(ang), np.sin(ang)
            R = np.array([[c, -s], [s, c]])
            out[k] = (_PTS * scale) @ R.T + np.asarray(kp.pt)
        return out

    def compute_batch(self, imgs, kps_list):
        """(N, H, W) images and each image's keypoints → [(keypoints,
        (k, 64) u8 descriptors)]; sets each keypoint's angle."""
        blurs = self.blurs(imgs)
        kps = [kp for kl in kps_list for kp in kl]
        img_idx = np.concatenate([np.full(len(kl), b, np.int64)
                                  for b, kl in enumerate(kps_list)] + [np.zeros(0, np.int64)])
        if not kps:
            return [(kl, np.zeros((0, len(_SHORT) // 8), np.uint8)) for kl in kps_list]
        v0 = _host_views([[self._reads(blurs, img_idx, self._points(kps))]], blurs.device)[0][0]
        # orientation from long pairs, in the reference's order
        gx = np.zeros(len(kps))
        gy = np.zeros(len(kps))
        for (i, j), d, nrm in zip(_LONG, _LONG_D, _LONG_NRM):
            g = (v0[:, j] - v0[:, i]).astype(np.float64) / nrm
            gx += g * d[0]
            gy += g * d[1]
        angs = [np.arctan2(gy[k], gx[k]) for k in range(len(kps))]
        v = self._reads(blurs, img_idx, self._points(kps, angs))
        bits = (v[:, _SHORT_I] < v[:, _SHORT_J]).reshape(len(kps), -1, 8)
        w = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8, device=v.device)
        packed = (bits.to(torch.uint8) * w).sum(-1, dtype=torch.uint8)
        desc = _host_views([[packed]], packed.device)[0][0].copy()
        for kp, ang in zip(kps, angs):
            kp.angle = float(np.degrees(ang) % 360)
        out, start = [], 0
        for kl in kps_list:
            out.append((kl, desc[start:start + len(kl)]))
            start += len(kl)
        return out

    def compute(self, image, keypoints):
        kps = list(keypoints)
        return self.compute_batch(_gray(image)[None], [kps])[0]

    def detectAndCompute(self, image, mask=None):
        kps = self.detect(image, mask)
        return self.compute(image, kps)

    def detect_and_compute_batch(self, images):
        """(B, H, W) batch (a tensor on any device, or numpy) → list of
        (keypoints, descriptors), each equal to detectAndCompute's."""
        imgs = as_tensor(images)
        if imgs.ndim == 2:
            imgs = imgs[None]
        return self.compute_batch(imgs, self.detect_batch(imgs))

    def descriptorSize(self):
        return len(_SHORT) // 8

    def descriptorType(self):
        return 0

    def defaultNorm(self):
        return 6  # NORM_HAMMING


def _gray(image) -> torch.Tensor:
    img = as_tensor(image)
    if img.ndim == 3:
        img = cvtColor(img, K.COLOR_BGR2GRAY)
    return img


def BRISK_create(thresh=30, octaves=3, patternScale=1.0):
    return BRISK(thresh, octaves, patternScale)
