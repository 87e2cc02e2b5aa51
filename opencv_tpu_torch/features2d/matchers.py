"""Descriptor matchers (features2d/src/matchers.cpp), twin of
``opencv_tpu/features2d/matchers.py``: BFMatcher, FlannBasedMatcher and
the factories (LightGlue waits for the dnn module).

The distance matrix is computed on the descriptors' device: Hamming and
Hamming2 by XOR and a bit-trick popcount on u8 (exact), L1 by broadcasting
in float32, L2 through the reference's expansion ``q² + t² − 2qt`` with the
cross term in float64 (exact for integer descriptors, and never TF32, which
a caller's ``allow_tf32`` would give a float32 matmul on the card), cast to
float32 like the reference's float32 dot; the L2 root is numpy's.  ``argmin``/``argsort`` and the
DMatch lists run in numpy on the host, as in the reference.

FlannBasedMatcher is the JAX package's host code over the port's copy of
its FLANN indexes (``opencv_tpu_torch/flann``); descriptors given as
tensors are read back once.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as K
from ..core.arrays import as_tensor
from ..flann.index import FLANN_INDEX_KDTREE, FLANN_INDEX_LSH, Index, _host

__all__ = ["DMatch", "BFMatcher", "FlannBasedMatcher", "DescriptorMatcher_create",
           "FlannBasedMatcher_create", "hamming_distance_matrix", "hamming2_distance_matrix"]


class DMatch:
    __slots__ = ("queryIdx", "trainIdx", "imgIdx", "distance")

    def __init__(self, queryIdx=0, trainIdx=0, distance=0.0, imgIdx=0):
        self.queryIdx = int(queryIdx)
        self.trainIdx = int(trainIdx)
        self.imgIdx = int(imgIdx)
        self.distance = float(distance)

    def __repr__(self):
        return (f"DMatch(q={self.queryIdx}, t={self.trainIdx}, "
                f"d={self.distance})")


def _popcount_u8(x):
    """Set bits of each u8, by the reference's bit tricks."""
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def _xor(q, t):
    q, t = as_tensor(q), as_tensor(t)
    return torch.bitwise_xor(q.to(torch.uint8)[:, None, :], t.to(q.device, torch.uint8)[None])


def hamming_distance_matrix(q, t):
    """(Nq, Nt) int32 Hamming distances between uint8 descriptor rows."""
    return _popcount_u8(_xor(q, t)).sum(-1, dtype=torch.int32)


def hamming2_distance_matrix(q, t):
    """(Nq, Nt) NORM_HAMMING2 distances: differing 2-bit cells (core norm
    cellSize=2, used with ORB WTA_K=3/4)."""
    x = _xor(q, t)
    return _popcount_u8((x | (x >> 1)) & 0x55).sum(-1, dtype=torch.int32)


def _l2sq_matrix(q, t):
    qf = as_tensor(q).to(torch.float32)
    tf = as_tensor(t).to(qf.device, torch.float32)
    q2 = (qf * qf).sum(1, keepdim=True)
    t2 = (tf * tf).sum(1, keepdim=True)
    cross = (qf.to(torch.float64) @ tf.to(torch.float64).T).to(torch.float32)
    return torch.clamp(q2 + t2.T - 2 * cross, min=0.0)


def _l1_matrix(q, t):
    qf = as_tensor(q).to(torch.float32)
    tf = as_tensor(t).to(qf.device, torch.float32)
    return (qf[:, None, :] - tf[None]).abs().sum(-1)


class BFMatcher:
    """Brute-force matcher (`cv::BFMatcher`)."""

    def __init__(self, normType: int = K.NORM_L2, crossCheck: bool = False):
        self.norm_type = normType
        self.cross_check = crossCheck

    @staticmethod
    def create(normType: int = K.NORM_L2, crossCheck: bool = False):
        return BFMatcher(normType, crossCheck)

    def _dist(self, q, t) -> np.ndarray:
        """(Nq, Nt) float32 distances, computed on q's device, as numpy."""
        nt = self.norm_type & K.NORM_TYPE_MASK
        if nt == K.NORM_HAMMING:
            d = hamming_distance_matrix(q, t).to(torch.float32)
        elif nt == K.NORM_HAMMING2:
            d = hamming2_distance_matrix(q, t).to(torch.float32)
        elif nt == K.NORM_L2:
            # the root in numpy, as the reference takes it (torch's float32
            # sqrt on the CPU is off by an ulp on some values)
            return np.sqrt(_l2sq_matrix(q, t).cpu().numpy())
        elif nt == K.NORM_L2SQR:
            d = _l2sq_matrix(q, t)
        elif nt == K.NORM_L1:
            d = _l1_matrix(q, t)
        else:
            raise ValueError(f"unsupported norm {self.norm_type}")
        return d.cpu().numpy()

    def match(self, queryDescriptors, trainDescriptors, mask=None):
        d = self._dist(queryDescriptors, trainDescriptors)
        best = d.argmin(axis=1)
        out = [DMatch(i, int(j), float(d[i, j])) for i, j in enumerate(best)]
        if self.cross_check:
            rbest = d.argmin(axis=0)
            out = [m for m in out if rbest[m.trainIdx] == m.queryIdx]
        return out

    def knnMatch(self, queryDescriptors, trainDescriptors, k: int, mask=None):
        d = self._dist(queryDescriptors, trainDescriptors)
        idx = np.argsort(d, axis=1, kind="stable")[:, :k]
        return [[DMatch(i, int(j), float(d[i, j])) for j in row]
                for i, row in enumerate(idx)]

    def radiusMatch(self, queryDescriptors, trainDescriptors,
                    maxDistance: float, mask=None):
        d = self._dist(queryDescriptors, trainDescriptors)
        out = []
        for i in range(d.shape[0]):
            js = np.nonzero(d[i] <= maxDistance)[0]
            js = js[np.argsort(d[i, js], kind="stable")]
            out.append([DMatch(i, int(j), float(d[i, j])) for j in js])
        return out


class FlannBasedMatcher:
    """`cv::FlannBasedMatcher` (matchers.cpp) backed by the ANN indexes of
    ``opencv_tpu_torch.flann`` (randomized kd-trees by default, like the
    reference's KDTreeIndexParams(4) + SearchParams(32); pass
    {"algorithm": 6, ...} for LSH over binary descriptors)."""

    def __init__(self, indexParams=None, searchParams=None):
        self.index_params = dict(indexParams or
                                 {"algorithm": FLANN_INDEX_KDTREE,
                                  "trees": 4})
        self.search_params = dict(searchParams or {"checks": 32})
        self._index = None
        self._train = None

    @staticmethod
    def create():
        return FlannBasedMatcher()

    # -- index management (miniflann train/add semantics) ------------------
    def add(self, descriptors):
        d = _host(descriptors[0] if isinstance(descriptors, (list, tuple))
                  else descriptors)
        self._train = (d if self._train is None
                       else np.vstack([self._train, d]))
        self._index = None

    def clear(self):
        self._train = None
        self._index = None

    def train(self):
        if self._index is None and self._train is not None:
            data = self._train
            algo = int(self.index_params.get("algorithm", 1))
            if data.dtype == np.uint8 and algo != FLANN_INDEX_LSH:
                data = data.astype(np.float32)
            self._index = Index(data, dict(self.index_params))
        return self._index

    def _search(self, query, train, k):
        if train is not None:
            self.clear()
            self.add(train)
        idx_obj = self.train()
        q = _host(query)
        algo = int(self.index_params.get("algorithm", 1))
        if q.dtype == np.uint8 and algo != FLANN_INDEX_LSH:
            q = q.astype(np.float32)
        idx, dst = idx_obj.knnSearch(q, k, self.search_params)
        # FLANN reports squared L2; cv::FlannBasedMatcher exposes L2
        if q.dtype != np.uint8:
            dst = np.sqrt(np.maximum(dst, 0.0))
        return idx, dst

    def match(self, queryDescriptors, trainDescriptors=None, mask=None):
        idx, dst = self._search(queryDescriptors, trainDescriptors, 1)
        return [DMatch(i, int(idx[i, 0]), float(dst[i, 0]))
                for i in range(len(idx)) if idx[i, 0] >= 0]

    def knnMatch(self, queryDescriptors, trainDescriptors=None, k=2,
                 mask=None, compactResult=False):
        idx, dst = self._search(queryDescriptors, trainDescriptors, k)
        return [[DMatch(i, int(j), float(d)) for j, d in zip(row, drow)
                 if j >= 0]
                for i, (row, drow) in enumerate(zip(idx, dst))]

    def radiusMatch(self, queryDescriptors, trainDescriptors=None,
                    maxDistance=0.0, mask=None):
        k = min(64, len(self._train) if self._train is not None
                else len(trainDescriptors))
        idx, dst = self._search(queryDescriptors, trainDescriptors, k)
        out = []
        for i in range(len(idx)):
            out.append([DMatch(i, int(j), float(d))
                        for j, d in zip(idx[i], dst[i])
                        if j >= 0 and d <= maxDistance])
        return out


def DescriptorMatcher_create(matcherType):
    """cv::DescriptorMatcher::create — string/enum factory mapping to
    BFMatcher or FlannBasedMatcher like the reference registry."""
    name = matcherType if isinstance(matcherType, str) else {
        0: "FlannBased", 1: "BruteForce", 2: "BruteForce-L1",
        3: "BruteForce-Hamming", 5: "BruteForce-SL2",
    }.get(int(matcherType), "BruteForce")
    if name == "FlannBased":
        return FlannBasedMatcher()
    norm = {"BruteForce": K.NORM_L2, "BruteForce-SL2": K.NORM_L2SQR,
            "BruteForce-L1": K.NORM_L1,
            "BruteForce-Hamming": K.NORM_HAMMING,
            "BruteForce-Hamming(2)": K.NORM_HAMMING2}.get(
                name, K.NORM_L2)
    return BFMatcher(norm)


def FlannBasedMatcher_create():
    return FlannBasedMatcher()
