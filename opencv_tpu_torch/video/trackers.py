"""Online trackers (video/src/tracking/tracker_mil.cpp); the port's copy of
``opencv_tpu/video/trackers.py``.

TrackerMIL: Babenko's multiple-instance-learning boosting over random
Haar-like features.  Host numpy, as in the JAX package: the features of all
candidate windows are one integral-image gather batch, and the online stump
updates and the greedy MIL selection follow the reference's
ClfMilBoost/ClfOnlineStump scheme.  A colour frame becomes gray through the
port's ``cvtColor``; frames may be tensors (read back once per call).
"""

from __future__ import annotations

import numpy as np

from .. import constants as K
from ..core.arrays import to_host
from ..ops.color import cvtColor

__all__ = ["TrackerMIL", "TrackerMIL_create"]


class _HaarBank:
    """Random 2-4 rectangle Haar features in a normalized box."""

    def __init__(self, n_features, rng):
        self.rects = []   # per feature: list of (x0, y0, x1, y1, weight)
        for _ in range(n_features):
            nr = rng.integers(2, 5)
            rs = []
            for _ in range(nr):
                x0, y0 = rng.uniform(0, 0.75, 2)
                w = rng.uniform(0.1, 1 - x0)
                h = rng.uniform(0.1, 1 - y0)
                wgt = rng.uniform(-1, 1)
                rs.append((x0, y0, x0 + w, y0 + h, wgt))
            self.rects.append(rs)

    def compute(self, integral, boxes):
        """integral: (H+1, W+1) f64; boxes: (M, 4) [x, y, w, h].
        Returns (M, F)."""
        M = len(boxes)
        F = len(self.rects)
        out = np.zeros((M, F))
        bx = boxes[:, 0]
        by = boxes[:, 1]
        bw = boxes[:, 2]
        bh = boxes[:, 3]
        for fi, rs in enumerate(self.rects):
            acc = np.zeros(M)
            for (rx0, ry0, rx1, ry1, wgt) in rs:
                x0 = (bx + rx0 * bw).astype(int)
                y0 = (by + ry0 * bh).astype(int)
                x1 = np.maximum((bx + rx1 * bw).astype(int), x0 + 1)
                y1 = np.maximum((by + ry1 * bh).astype(int), y0 + 1)
                s = (integral[y1, x1] - integral[y1, x0]
                     - integral[y0, x1] + integral[y0, x0])
                acc += wgt * s / ((x1 - x0) * (y1 - y0))
            out[:, fi] = acc
        return out


class TrackerMIL:
    class Params:
        def __init__(self):
            self.samplerInitInRadius = 3.0
            self.samplerInitMaxNegNum = 65
            self.samplerSearchWinSize = 25.0
            self.samplerTrackInRadius = 4.0
            self.samplerTrackMaxPosNum = 100000
            self.samplerTrackMaxNegNum = 65
            self.featureSetNumFeatures = 250

    def __init__(self, params=None):
        self.params = params or TrackerMIL.Params()
        self._rng = np.random.default_rng(1)
        self._nsel = 50
        self._lr = 0.85

    @staticmethod
    def create(params=None):
        return TrackerMIL(params)

    def _gray(self, image):
        img = image
        if img.ndim == 3:
            img = cvtColor(img, K.COLOR_BGR2GRAY)
        return to_host(img).astype(np.float64)

    def _integral(self, gray):
        ii = np.zeros((gray.shape[0] + 1, gray.shape[1] + 1))
        ii[1:, 1:] = gray.cumsum(0).cumsum(1)
        return ii

    def _sample(self, center, radius, maxnum, H, W, inner=0.0):
        cx, cy = center
        bw, bh = self._size
        cands = []
        r = int(np.ceil(radius))
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                d2 = dx * dx + dy * dy
                if d2 > radius * radius or d2 < inner * inner:
                    continue
                x = cx + dx
                y = cy + dy
                if 0 <= x and x + bw < W and 0 <= y and y + bh < H:
                    cands.append((x, y, bw, bh))
        cands = np.asarray(cands, np.float64).reshape(-1, 4)
        if len(cands) > maxnum:
            idx = self._rng.choice(len(cands), maxnum, replace=False)
            cands = cands[idx]
        return cands

    def _update_stumps(self, feats, positive):
        mu = feats.mean(axis=0)
        sig = feats.std(axis=0) + 1e-6
        lr = self._lr
        if positive:
            if self._mu1 is None:
                self._mu1, self._sig1 = mu, sig
            else:
                self._mu1 = lr * self._mu1 + (1 - lr) * mu
                self._sig1 = lr * self._sig1 + (1 - lr) * sig
        else:
            if self._mu0 is None:
                self._mu0, self._sig0 = mu, sig
            else:
                self._mu0 = lr * self._mu0 + (1 - lr) * mu
                self._sig0 = lr * self._sig0 + (1 - lr) * sig

    def _loglik(self, feats):
        """per-feature log-likelihood ratio (M, F)."""
        p1 = -0.5 * ((feats - self._mu1) / self._sig1) ** 2 \
            - np.log(self._sig1)
        p0 = -0.5 * ((feats - self._mu0) / self._sig0) ** 2 \
            - np.log(self._sig0)
        return p1 - p0

    def _select(self, pos_feats, neg_feats):
        """Greedy MIL feature selection: maximize bag likelihood."""
        lp = self._loglik(pos_feats)      # (P, F)
        ln = self._loglik(neg_feats)      # (N, F)
        # score each feature by (mean pos ratio - mean neg ratio)
        score = lp.mean(axis=0) - ln.mean(axis=0)
        self._selected = np.argsort(-score)[:self._nsel]

    def init(self, image, boundingBox):
        gray = self._gray(image)
        H, W = gray.shape
        x, y, w, h = [int(v) for v in boundingBox]
        self._size = (w, h)
        self._pos = (x, y)
        self._bank = _HaarBank(self.params.featureSetNumFeatures,
                               self._rng)
        self._mu0 = self._mu1 = None
        ii = self._integral(gray)
        pos = self._sample((x, y), self.params.samplerInitInRadius,
                           1000, H, W)
        neg = self._sample((x, y), 1.5 * self.params.samplerSearchWinSize,
                           self.params.samplerInitMaxNegNum, H, W,
                           inner=4.0 + self.params.samplerInitInRadius)
        if len(pos) == 0 or len(neg) == 0:
            return False
        fp = self._bank.compute(ii, pos)
        fn = self._bank.compute(ii, neg)
        self._update_stumps(fp, True)
        self._update_stumps(fn, False)
        self._select(fp, fn)
        return True

    def update(self, image):
        gray = self._gray(image)
        H, W = gray.shape
        ii = self._integral(gray)
        cands = self._sample(self._pos, self.params.samplerSearchWinSize,
                             100000, H, W)
        if len(cands) == 0:
            return False, tuple(map(int, (*self._pos, *self._size)))
        feats = self._bank.compute(ii, cands)
        scores = self._loglik(feats)[:, self._selected].sum(axis=1)
        best = int(np.argmax(scores))
        self._pos = (int(cands[best, 0]), int(cands[best, 1]))
        # online update
        pos = self._sample(self._pos, self.params.samplerTrackInRadius,
                           self.params.samplerTrackMaxPosNum, H, W)
        neg = self._sample(self._pos, 1.5 * self.params.samplerSearchWinSize,
                           self.params.samplerTrackMaxNegNum, H, W,
                           inner=4.0 + self.params.samplerTrackInRadius)
        if len(pos) and len(neg):
            fp = self._bank.compute(ii, pos)
            fn = self._bank.compute(ii, neg)
            self._update_stumps(fp, True)
            self._update_stumps(fn, False)
            self._select(fp, fn)
        return True, (self._pos[0], self._pos[1], self._size[0],
                      self._size[1])


def TrackerMIL_create(params=None):
    return TrackerMIL(params)
