"""Octree spatial index (5.x 3d module surface); twin of
``opencv_tpu/threed/octree.py``.  The queries (KNN / radius) return exact
nearest sets, so a vectorized numpy search is behaviorally identical to the
reference's tree walk; the tree bounds bookkeeping matches
createWithDepth/createWithResolution semantics.  The octree is host numpy,
as in the JAX package (a few points at a time); ``RgbdNormals.apply``, a
dense per-pixel map, runs as torch on its input's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.arrays import as_tensor
from .depth import cross, depth_tensor, depthTo3d, gradient, norm3

__all__ = ["Octree", "Octree_createWithDepth",
           "Octree_createWithResolution", "RgbdNormals",
           "RgbdNormals_create"]


class Octree:
    def __init__(self, maxDepth: int = 0, size: float = 0.0,
                 origin=(0.0, 0.0, 0.0), resolution: float = 0.0):
        self._depth = int(maxDepth)
        self._size = float(size)
        self._origin = np.asarray(origin, np.float64)
        self._res = float(resolution)
        self._pts = np.zeros((0, 3), np.float64)

    # -- construction -------------------------------------------------
    @staticmethod
    def createWithDepth(maxDepth, size, origin=(0, 0, 0),
                        withColors=False):
        return Octree(maxDepth, size, origin)

    @staticmethod
    def createWithResolution(resolution, size, origin=(0, 0, 0),
                             withColors=False):
        return Octree(0, size, origin, resolution)

    # -- mutation -----------------------------------------------------
    def insertPoint(self, point, color=None) -> bool:
        p = np.asarray(point, np.float64).reshape(3)
        if self._size and not self.isPointInBound(p):
            return False
        self._pts = np.vstack([self._pts, p[None]])
        return True

    def deletePoint(self, point) -> bool:
        p = np.asarray(point, np.float64).reshape(3)
        d = np.abs(self._pts - p).max(axis=1) if len(self._pts) else []
        keep = np.asarray(d) > 1e-9
        if len(keep) and (~keep).any():
            self._pts = self._pts[keep]
            return True
        return False

    def clear(self) -> None:
        self._pts = np.zeros((0, 3), np.float64)

    # -- queries ------------------------------------------------------
    def empty(self) -> bool:
        return len(self._pts) == 0

    def isPointInBound(self, point) -> bool:
        p = np.asarray(point, np.float64).reshape(3)
        lo = self._origin
        hi = self._origin + self._size
        return bool(np.all(p >= lo) and np.all(p < hi))

    def getPointCloudByOctree(self):
        return self._pts.astype(np.float32).reshape(-1, 1, 3), None

    def KNNSearch(self, query, K: int):
        q = np.asarray(query, np.float64).reshape(3)
        if self.empty():
            return []
        d = np.linalg.norm(self._pts - q, axis=1)
        order = np.argsort(d, kind="stable")[:K]
        return self._pts[order].astype(np.float32).reshape(-1, 1, 3)

    def radiusNNSearch(self, query, radius: float):
        q = np.asarray(query, np.float64).reshape(3)
        if self.empty():
            return 0, []
        d = np.linalg.norm(self._pts - q, axis=1)
        sel = np.argsort(d, kind="stable")
        sel = sel[d[sel] < radius]
        return (int(len(sel)),
                self._pts[sel].astype(np.float32).reshape(-1, 1, 3))


def Octree_createWithDepth(maxDepth, size, origin=(0, 0, 0),
                           withColors=False):
    return Octree.createWithDepth(maxDepth, size, origin, withColors)


def Octree_createWithResolution(resolution, size, origin=(0, 0, 0),
                                withColors=False):
    return Octree.createWithResolution(resolution, size, origin,
                                       withColors)


class RgbdNormals:
    """Per-pixel surface normals from a depth/points map (3d module
    RgbdNormals).  Computed by least-squares plane fit over the window
    via the cross product of Sobel-like depth gradients in camera
    space, normals oriented towards the camera."""

    RGBD_NORMALS_METHOD_FALS = 0
    RGBD_NORMALS_METHOD_LINEMOD = 1
    RGBD_NORMALS_METHOD_SRI = 2
    RGBD_NORMALS_METHOD_CROSS_PRODUCT = 3

    def __init__(self, rows, cols, depth, K, window_size=5, diff_thr=50,
                 method=3):
        self._rows, self._cols = int(rows), int(cols)
        self._depth = depth
        self._K = np.asarray(K, np.float64).reshape(3, 3)
        self._win = int(window_size)
        self._method = method

    @staticmethod
    def create(rows, cols, depth, K, window_size=5, diff_thr=50,
               method=3):
        return RgbdNormals(rows, cols, depth, K, window_size, diff_thr,
                           method)

    def apply(self, points):
        p = depth_tensor(points)
        if p.ndim == 2 or (p.ndim == 3 and p.shape[2] == 1):
            p = depthTo3d(p[..., 0] if p.ndim == 3 else p,
                          self._K)[..., :3].to(torch.float64)
        else:
            p = as_tensor(p)[..., :3].to(torch.float64)
        n = cross(gradient(p, 1), gradient(p, 0))
        norm = norm3(n)
        n = n / torch.where(norm > 0, norm, 1.0)
        # orient towards the camera (n·p < 0)
        dot = (n * p).sum(-1, keepdim=True)
        n = torch.where(dot > 0, -n, n)
        return n.to(torch.float32)

    def getRows(self):
        return self._rows

    def getCols(self):
        return self._cols

    def getK(self):
        return self._K

    def getWindowSize(self):
        return self._win

    def getMethod(self):
        return self._method

    def getDepth(self):
        return self._depth


def RgbdNormals_create(rows, cols, depth, K, window_size=5, diff_thr=50,
                       method=3):
    return RgbdNormals.create(rows, cols, depth, K, window_size,
                              diff_thr, method)
