"""MSER region detector (features2d/src/mser.cpp), twin of
``opencv_tpu/features2d/mser.py``.

Component-tree construction is sequential pointer-chasing, so it runs on
the host in the port's native host tails (``native/hosttails.cpp``
``mser_detect``, a copy of the JAX package's): a union-find immersion over
gray levels with VLFeat-style stability selection, run on both polarities
like the reference's two passes.  A tensor on the card is read back once.
``_mser_py`` is its plain twin, which the tests hold it to; a failed build
raises, nothing falls back to it.  Region pixel lists are recovered by
flooding each (seed, level) pair.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as K
from ..ops.color import cvtColor
from ..native import mser_detect as _native_mser
from .keypoint import KeyPoint

__all__ = ["MSER", "MSER_create"]

def _mser_py(img, delta, min_area, max_area, max_variation, min_diversity):
    """The plain twin of the native ``mser_detect``: the same union-find
    immersion in Python."""
    H, W = img.shape
    N = H * W
    order = np.argsort(img.ravel(), kind="stable")
    ufp = np.full(N, -1, np.int64)
    comp_node = np.full(N, -1, np.int64)
    lvl, size, par, seed = [], [], [], []
    flat = img.ravel()

    def find(x):
        r = x
        while ufp[r] != r:
            r = ufp[r]
        while ufp[x] != r:
            ufp[x], x = r, ufp[x]
        return r

    for p in order:
        g = int(flat[p])
        ufp[p] = p
        node = len(lvl)
        lvl.append(g); size.append(1); par.append(-1); seed.append(p)
        comp_node[p] = node
        px, py = p % W, p // W
        for dx2, dy2 in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            nx, ny = px + dx2, py + dy2
            if not (0 <= nx < W and 0 <= ny < H):
                continue
            q = ny * W + nx
            if ufp[q] < 0:
                continue
            rp, rq = find(p), find(q)
            if rp == rq:
                continue
            na, nb = comp_node[rp], comp_node[rq]

            def lift(n):
                if lvl[n] == g:
                    return n
                nn = len(lvl)
                lvl.append(g); size.append(size[n]); par.append(-1)
                seed.append(seed[n])
                par[n] = nn
                return nn

            la, lb = lift(na), lift(nb)
            keep, drop, rkeep, rdrop = la, lb, rp, rq
            if size[lb] > size[la]:
                keep, drop, rkeep, rdrop = lb, la, rq, rp
            size[keep] += size[drop]
            par[drop] = keep
            ufp[rdrop] = rkeep
            comp_node[rkeep] = keep

    M = len(lvl)
    var = np.empty(M)
    for i in range(M):
        a = i
        target = lvl[i] + delta
        while par[a] >= 0 and lvl[par[a]] <= target:
            a = par[a]
        var[i] = (size[a] - size[i]) / size[i]
    child_min = np.full(M, np.inf)
    for i in range(M):
        if par[i] >= 0:
            child_min[par[i]] = min(child_min[par[i]], var[i])
    stable = np.zeros(M, bool)
    for i in range(M):
        if not (min_area <= size[i] <= max_area) or var[i] > max_variation:
            continue
        if par[i] >= 0 and lvl[par[i]] == lvl[i]:
            continue
        pv = var[par[i]] if par[i] >= 0 else np.inf
        if var[i] <= pv and var[i] <= child_min[i]:
            stable[i] = True
    for i in range(M):
        if not stable[i]:
            continue
        a = par[i]
        while a >= 0:
            if stable[a]:
                div = (size[a] - size[i]) / size[a]
                if div < min_diversity:
                    if var[a] >= var[i]:
                        stable[a] = False
                    else:
                        stable[i] = False
                        break
                else:
                    break
            a = par[a]
    idx = np.nonzero(stable)[0]
    return (np.array([seed[i] for i in idx], np.int32),
            np.array([lvl[i] for i in idx], np.int32))


def _flood_region(img, seed, level):
    """Pixels 4-connected to seed with value <= level."""
    H, W = img.shape
    sy, sx = divmod(int(seed), W)
    mask = img <= level
    out = np.zeros((H, W), bool)
    stack = [(sy, sx)]
    out[sy, sx] = True
    while stack:
        y, x = stack.pop()
        for dy2, dx2 in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            ny, nx = y + dy2, x + dx2
            if 0 <= ny < H and 0 <= nx < W and mask[ny, nx] \
                    and not out[ny, nx]:
                out[ny, nx] = True
                stack.append((ny, nx))
    ys, xs = np.nonzero(out)
    return np.stack([xs, ys], axis=1).astype(np.int32)


class MSER:
    def __init__(self, delta=5, min_area=60, max_area=14400,
                 max_variation=0.25, min_diversity=0.2, max_evolution=200,
                 area_threshold=1.01, min_margin=0.003, edge_blur_size=5):
        self.delta = delta
        self.min_area = min_area
        self.max_area = max_area
        self.max_variation = max_variation
        self.min_diversity = min_diversity
        self.pass2_only = False

    @staticmethod
    def create(delta=5, min_area=60, max_area=14400, max_variation=0.25,
               min_diversity=0.2, max_evolution=200, area_threshold=1.01,
               min_margin=0.003, edge_blur_size=5):
        return MSER(delta, min_area, max_area, max_variation,
                    min_diversity, max_evolution, area_threshold,
                    min_margin, edge_blur_size)

    def _one_pass(self, img):
        seeds, levels = _native_mser(img, self.delta, self.min_area, self.max_area,
                                     self.max_variation, self.min_diversity)
        full = img.size
        out = []
        for s, l in zip(seeds, levels):
            r = _flood_region(img, s, l)
            if len(r) < full:  # the whole frame is never a region
                out.append(r)
        return out

    def detectRegions(self, image):
        img = image
        if img.ndim == 3:
            img = cvtColor(img, K.COLOR_BGR2GRAY)
        img = img.cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)
        regions = []
        if not self.pass2_only:
            regions += self._one_pass(img)          # dark regions
        regions += self._one_pass(255 - img)        # bright regions
        bboxes = []
        for r in regions:
            x0, y0 = r.min(axis=0)
            x1, y1 = r.max(axis=0)
            bboxes.append([x0, y0, x1 - x0 + 1, y1 - y0 + 1])
        return regions, np.array(bboxes, np.int32).reshape(-1, 4)

    def detect(self, image, mask=None):
        regions, _ = self.detectRegions(image)
        kps = []
        for r in regions:
            c = r.mean(axis=0)
            size = 2.0 * np.sqrt(len(r) / np.pi)
            kps.append(KeyPoint(float(c[0]), float(c[1]), float(size)))
        if mask is not None:
            m = np.asarray(mask)
            kps = [k for k in kps if m[int(k.pt[1]), int(k.pt[0])]]
        return kps

    def setDelta(self, d):
        self.delta = d

    def getDelta(self):
        return self.delta

    def setMinArea(self, a):
        self.min_area = a

    def getMinArea(self):
        return self.min_area

    def setMaxArea(self, a):
        self.max_area = a

    def getMaxArea(self):
        return self.max_area

    def setPass2Only(self, b):
        self.pass2_only = bool(b)

    def getPass2Only(self):
        return self.pass2_only


def MSER_create(delta=5, min_area=60, max_area=14400, max_variation=0.25,
                min_diversity=0.2, max_evolution=200, area_threshold=1.01,
                min_margin=0.003, edge_blur_size=5):
    return MSER(delta, min_area, max_area, max_variation, min_diversity,
                max_evolution, area_threshold, min_margin, edge_blur_size)
