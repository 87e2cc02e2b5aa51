"""Haar cascade detection (objdetect/src/cascadedetect.cpp); twin of
``opencv_tpu/objdetect/cascade.py``.

Loads the reference's new-format cascade XMLs (stump boosted stages)
and evaluates them windows-at-once: per pyramid scale, one integral /
squared-integral pair, every surviving window's feature sums are
batched integral gathers, and stages prune the window set vectorized —
the branchy per-window loop of the reference becomes dense masked math.

The port runs it on the image's device (a numpy image is a CPU tensor):
the scaled image, its integral and squared integral in float64 (exact, as
the JAX package's numpy sums are: every value is an integer below 2^53),
the tilted integral from the port's ``integral3``, and each stage as one
gather of all its rectangles' corners for the surviving windows, their
sums and the stumps' votes in the JAX package's order, then one read of
the survivors (the compaction of the window set).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np
import torch

from .. import constants as K
from ..core.arrays import as_tensor, to_device, to_host
from ..ops.color import cvtColor
from .hog import groupRectangles

__all__ = ["CascadeClassifier"]


class _Stump:
    __slots__ = ("feat", "thr", "left", "right")


class CascadeClassifier:
    def __init__(self, filename=None):
        self._stages = None
        if filename:
            self.load(filename)

    def empty(self):
        return self._stages is None

    def load(self, filename):
        root = ET.parse(filename).getroot()
        casc = root.find("cascade")
        if casc is None:
            return False
        assert casc.find("featureType").text.strip() == "HAAR", \
            "only HAAR cascades supported"
        self._w = int(casc.find("width").text)
        self._h = int(casc.find("height").text)

        feats = []
        tilts = []
        for f in casc.find("features"):
            rects = []
            for r in f.find("rects"):
                vals = r.text.split()
                x, y, w, h = map(int, vals[:4])
                wt = float(vals[4])
                rects.append((x, y, w, h, wt))
            tilted = f.find("tilted")
            tilts.append(bool(tilted is not None and int(tilted.text)))
            feats.append(rects)
        self._features = feats
        self._tilted = tilts
        self._has_tilted = any(tilts)

        stages = []
        for st in casc.find("stages"):
            thr = float(st.find("stageThreshold").text)
            stumps = []
            for wc in st.find("weakClassifiers"):
                nodes = wc.find("internalNodes").text.split()
                leaves = [float(v) for v in
                          wc.find("leafValues").text.split()]
                s = _Stump()
                s.feat = int(nodes[2])
                s.thr = float(nodes[3])
                s.left = leaves[0]
                s.right = leaves[1]
                stumps.append(s)
            stages.append((thr, stumps))
        self._stages = stages
        return True

    def _stage_tables(self, Wp: int, n_ii: int, device) -> list:
        """Per stage: the flat corner offsets of every rectangle of its
        stumps into [ii, ti] flattened ((stumps, rects, 4) int64, tilted
        features offset by the size of ii), their weights (0 for padding),
        and the stumps' thresholds and leaves (host floats)."""
        key = (Wp, n_ii, str(device))
        if getattr(self, "_tab_key", None) != key:
            nr = max(len(f) for f in self._features)
            tabs = []
            for thr, stumps in self._stages:
                off = np.zeros((len(stumps), nr, 4), np.int64)
                wts = np.zeros((len(stumps), nr), np.float64)
                for si, st in enumerate(stumps):
                    tilted = self._tilted[st.feat]
                    for ri, (x0, y0, rw, rh, wt) in enumerate(self._features[st.feat]):
                        if tilted:
                            o = ((y0, x0), (y0 + rh, x0 - rh), (y0 + rw, x0 + rw),
                                 (y0 + rw + rh, x0 + rw - rh))
                        else:
                            o = ((y0 + rh, x0 + rw), (y0 + rh, x0), (y0, x0 + rw), (y0, x0))
                        off[si, ri] = [y * Wp + x + (n_ii if tilted else 0) for y, x in o]
                        wts[si, ri] = wt
                tabs.append((thr, to_device(off, device), to_device(wts, device),
                             [(st.thr, st.left, st.right) for st in stumps]))
            self._tab_key, self._tabs = key, tabs
        return self._tabs

    def _detect_single_scale(self, ii, ii2, H, W, step, ti=None):
        """Returns surviving window top-left coords at this scale (int64
        tensors on the integrals' device)."""
        w, h = self._w, self._h
        dev = ii.device
        Wp = W + 1
        xs = torch.arange(0, W - w + 1, step, device=dev)
        ys = torch.arange(0, H - h + 1, step, device=dev)
        X = xs[None, :].expand(len(ys), len(xs)).reshape(-1)
        Y = ys[:, None].expand(len(ys), len(xs)).reshape(-1)
        base = Y * Wp + X
        f_ii, f_ii2 = ii.reshape(-1), ii2.reshape(-1)

        def rect_sum(I, x0, y0, rw, rh):
            return (I[base + ((y0 + rh) * Wp + x0 + rw)] - I[base + ((y0 + rh) * Wp + x0)]
                    - I[base + (y0 * Wp + x0 + rw)] + I[base + (y0 * Wp + x0)])

        # variance normalization over the inner (1,1,w-2,h-2) rect
        area = (w - 2) * (h - 2)
        area_t = torch.tensor(float(area), dtype=torch.float64, device=dev)
        s1 = rect_sum(f_ii, 1, 1, w - 2, h - 2)
        s2 = rect_sum(f_ii2, 1, 1, w - 2, h - 2)
        mean = s1 / area_t
        var = s2 / area_t - mean * mean
        nf = torch.sqrt(torch.clamp(var, min=0.0))
        nf = torch.where(nf > 1e-10, nf, 1.0) * area

        I = f_ii if ti is None else torch.cat([f_ii, ti.reshape(-1)])
        idx = torch.arange(len(X), device=dev)
        for thr, off, wts, stumps in self._stage_tables(Wp, f_ii.numel(), dev):
            b = base[idx]
            c = I[b[None, None, None, :] + off[..., None]]      # (stumps, rects, 4, n)
            rs = c[:, :, 0] - c[:, :, 1] - c[:, :, 2] + c[:, :, 3]
            fv = wts[:, 0, None] * rs[:, 0]
            for r in range(1, rs.shape[1]):
                fv = fv + wts[:, r, None] * rs[:, r]
            nfa = nf[idx]
            ssum = torch.zeros(len(idx), dtype=torch.float64, device=dev)
            for si, (sthr, left, right) in enumerate(stumps):
                ssum = ssum + torch.where(fv[si] < sthr * nfa, left, right)
            idx = idx[ssum > thr - 1e-7]
            if len(idx) == 0:
                break
        return X[idx], Y[idx]

    def detectMultiScale(self, image, scaleFactor=1.1, minNeighbors=3,
                         flags=0, minSize=None, maxSize=None):
        from ..ops.integral import integral3
        from ..ops.resize import resize
        img = as_tensor(image)
        gray = cvtColor(img, K.COLOR_BGR2GRAY) if img.ndim == 3 else img
        H0, W0 = gray.shape
        rects = []
        scale = 1.0
        while True:
            w = int(round(self._w * scale))
            h = int(round(self._h * scale))
            if w > W0 or h > H0:
                break
            if (maxSize and maxSize[0] and
                    (w > maxSize[0] or h > maxSize[1])):
                break
            if not (minSize and minSize[0] and
                    (w < minSize[0] or h < minSize[1])):
                sw = int(round(W0 / scale))
                sh = int(round(H0 / scale))
                scaled = resize(gray, (sw, sh), interpolation=K.INTER_LINEAR)
                f = scaled.to(torch.float64)
                ii = torch.zeros((sh + 1, sw + 1), dtype=torch.float64, device=f.device)
                ii[1:, 1:] = f.cumsum(0).cumsum(1)
                ii2 = torch.zeros_like(ii)
                ii2[1:, 1:] = (f * f).cumsum(0).cumsum(1)
                ti = None
                if getattr(self, "_has_tilted", False):
                    _, _, t = integral3(scaled.to(torch.uint8))
                    ti = t.to(torch.float64)
                step = 1 if scale < 2 else 2
                X, Y = self._detect_single_scale(ii, ii2, sh, sw, step,
                                                 ti=ti)
                for x, y in zip(to_host(X).tolist(), to_host(Y).tolist()):
                    rects.append((int(round(x * scale)),
                                  int(round(y * scale)), w, h))
            scale *= scaleFactor
        if minNeighbors > 0:
            out, _ = groupRectangles(rects, minNeighbors, 0.2)
            return out
        return np.array(rects, np.int32).reshape(-1, 4)
