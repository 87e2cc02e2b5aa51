"""cv::Subdiv2D (imgproc/src/subdivision2d.cpp): incremental Delaunay
triangulation with Voronoi duals; twin of ``opencv_tpu/ops/subdiv2d.py``,
copied as host numpy (points given as a tensor are read to the host), so
its outputs are the JAX package's exactly.

The reference maintains a quad-edge structure updated per insertion;
here the triangulation is (re)built with Bowyer-Watson over the current
point set — the Delaunay triangulation of a point set is unique (up to
degenerate co-circular ties), so the query surface (triangles, edges,
Voronoi facets, nearest vertex) is behaviorally identical while staying
vectorizable."""

from __future__ import annotations

import numpy as np
import torch

from .linalg import _host

__all__ = ["Subdiv2D"]

PTLOC_ERROR = -2
PTLOC_OUTSIDE_RECT = -1
PTLOC_INSIDE = 0
PTLOC_VERTEX = 1
PTLOC_ON_EDGE = 2

NEXT_AROUND_ORG = 0x00
NEXT_AROUND_DST = 0x22
PREV_AROUND_ORG = 0x11
PREV_AROUND_DST = 0x33
NEXT_AROUND_LEFT = 0x13
NEXT_AROUND_RIGHT = 0x31
PREV_AROUND_LEFT = 0x20
PREV_AROUND_RIGHT = 0x02


def _circumcircle(a, b, c):
    ax, ay = a
    bx, by = b
    cx, cy = c
    d = 2 * (ax * (by - cy) + bx * (cy - ay) + cx * (ay - by))
    if abs(d) < 1e-12:
        return None, None
    ux = ((ax * ax + ay * ay) * (by - cy) + (bx * bx + by * by)
          * (cy - ay) + (cx * cx + cy * cy) * (ay - by)) / d
    uy = ((ax * ax + ay * ay) * (cx - bx) + (bx * bx + by * by)
          * (ax - cx) + (cx * cx + cy * cy) * (bx - ax)) / d
    r2 = (ax - ux) ** 2 + (ay - uy) ** 2
    return (ux, uy), r2


class Subdiv2D:
    PTLOC_ERROR = PTLOC_ERROR
    PTLOC_OUTSIDE_RECT = PTLOC_OUTSIDE_RECT
    PTLOC_INSIDE = PTLOC_INSIDE
    PTLOC_VERTEX = PTLOC_VERTEX
    PTLOC_ON_EDGE = PTLOC_ON_EDGE
    NEXT_AROUND_ORG = NEXT_AROUND_ORG
    NEXT_AROUND_DST = NEXT_AROUND_DST
    PREV_AROUND_ORG = PREV_AROUND_ORG
    PREV_AROUND_DST = PREV_AROUND_DST
    NEXT_AROUND_LEFT = NEXT_AROUND_LEFT
    NEXT_AROUND_RIGHT = NEXT_AROUND_RIGHT
    PREV_AROUND_LEFT = PREV_AROUND_LEFT
    PREV_AROUND_RIGHT = PREV_AROUND_RIGHT

    def __init__(self, rect=None):
        self._rect = None
        self._pts = []
        self._tris = None
        if rect is not None:
            self.initDelaunay(rect)

    def initDelaunay(self, rect):
        self._rect = tuple(rect)
        self._pts = []
        self._tris = None

    def insert(self, pt):
        if isinstance(pt, torch.Tensor):
            pt = _host(pt)
        if np.ndim(pt) > 1 or (hasattr(pt, "__len__") and len(pt) > 0
                               and hasattr(pt[0], "__len__")):
            for p in np.asarray(pt, np.float64).reshape(-1, 2):
                self._insert_one(tuple(p))
            return 0
        return self._insert_one((float(pt[0]), float(pt[1])))

    def _insert_one(self, p):
        x, y = p
        if self._rect is not None:
            rx, ry, rw, rh = self._rect
            if not (rx <= x <= rx + rw and ry <= y <= ry + rh):
                raise ValueError("point outside of the subdivision rect")
        self._pts.append((float(x), float(y)))
        self._tris = None
        return 4 + len(self._pts) - 1   # the reference's vertex ids
                                        # start after 4 virtual corners

    # -- Bowyer-Watson over the current point set ---------------------
    def _triangulate(self):
        if self._tris is not None:
            return
        pts = np.asarray(self._pts, np.float64)
        n = len(pts)
        self._tris = []
        if n < 3:
            return
        # super-triangle enclosing the rect (or the point bbox)
        if self._rect is not None:
            rx, ry, rw, rh = self._rect
        else:
            rx, ry = pts.min(0) - 1
            rw, rh = (pts.max(0) - pts.min(0)) + 2
        m = 3 * max(rw, rh) + 1
        cx, cy = rx + rw / 2.0, ry + rh / 2.0
        sup = np.array([[cx - m, cy - m], [cx + m, cy - m],
                        [cx, cy + m]])
        allp = np.vstack([pts, sup])
        s0, s1, s2 = n, n + 1, n + 2
        tris = [(s0, s1, s2)]
        for i in range(n):
            p = allp[i]
            bad, polygon = [], []
            for t in tris:
                cc, r2 = _circumcircle(allp[t[0]], allp[t[1]],
                                       allp[t[2]])
                if cc is not None and \
                        (p[0] - cc[0]) ** 2 + (p[1] - cc[1]) ** 2 <= r2:
                    bad.append(t)
            edges = {}
            for t in bad:
                for e in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
                    k = (min(e), max(e))
                    edges[k] = edges.get(k, 0) + 1
            polygon = [k for k, cnt in edges.items() if cnt == 1]
            tris = [t for t in tris if t not in bad]
            for (a, b) in polygon:
                tris.append((a, b, i))
        self._tris = [t for t in tris
                      if t[0] < n and t[1] < n and t[2] < n]

    # -- queries ------------------------------------------------------
    def getTriangleList(self):
        self._triangulate()
        pts = np.asarray(self._pts, np.float64)
        out = []
        for (a, b, c) in self._tris:
            out.append([pts[a][0], pts[a][1], pts[b][0], pts[b][1],
                        pts[c][0], pts[c][1]])
        return np.asarray(out, np.float32).reshape(-1, 6)

    def getEdgeList(self):
        self._triangulate()
        pts = np.asarray(self._pts, np.float64)
        seen = set()
        out = []
        for (a, b, c) in self._tris:
            for e in ((a, b), (b, c), (c, a)):
                k = (min(e), max(e))
                if k not in seen:
                    seen.add(k)
                    out.append([pts[k[0]][0], pts[k[0]][1],
                                pts[k[1]][0], pts[k[1]][1]])
        return np.asarray(out, np.float32).reshape(-1, 4)

    def getLeadingEdgeList(self):
        self._triangulate()
        return np.arange(len(self._tris), dtype=np.int32)

    def getVertex(self, vertex):
        i = vertex - 4
        if 0 <= i < len(self._pts):
            return self._pts[i], 0
        return (0.0, 0.0), 0

    def findNearest(self, pt):
        if not self._pts:
            return 0, (0.0, 0.0)
        pts = np.asarray(self._pts, np.float64)
        q = _host(pt).astype(np.float64).reshape(2)
        i = int(np.argmin(((pts - q) ** 2).sum(1)))
        return i + 4, tuple(pts[i])

    def locate(self, pt):
        self._triangulate()
        q = _host(pt).astype(np.float64).reshape(2)
        if self._rect is not None:
            rx, ry, rw, rh = self._rect
            if not (rx <= q[0] <= rx + rw and ry <= q[1] <= ry + rh):
                return PTLOC_OUTSIDE_RECT, 0, 0
        pts = np.asarray(self._pts, np.float64)
        for i, p in enumerate(pts):
            if np.hypot(p[0] - q[0], p[1] - q[1]) < 1e-9:
                return PTLOC_VERTEX, 0, i + 4
        for ti, (a, b, c) in enumerate(self._tris or []):
            pa, pb, pc = pts[a], pts[b], pts[c]
            d1 = np.cross(pb - pa, q - pa)
            d2 = np.cross(pc - pb, q - pb)
            d3 = np.cross(pa - pc, q - pc)
            neg = (d1 < 0) or (d2 < 0) or (d3 < 0)
            pos = (d1 > 0) or (d2 > 0) or (d3 > 0)
            if not (neg and pos):
                if abs(d1) < 1e-9 or abs(d2) < 1e-9 or abs(d3) < 1e-9:
                    return PTLOC_ON_EDGE, ti, 0
                return PTLOC_INSIDE, ti, 0
        return PTLOC_OUTSIDE_RECT, 0, 0

    def getVoronoiFacetList(self, idx):
        """Voronoi cells (clipped to the subdivision rect) as the duals
        of the Delaunay triangulation."""
        self._triangulate()
        pts = np.asarray(self._pts, np.float64)
        ids = (range(len(pts)) if idx is None or len(idx) == 0
               else [i - 4 if i >= 4 else i for i in np.ravel(idx)])
        facets, centers = [], []
        if self._rect is not None:
            rx, ry, rw, rh = self._rect
        else:
            rx, ry = pts.min(0) - 1
            rw, rh = (pts.max(0) - pts.min(0)) + 2
        clip = [(rx, ry), (rx + rw, ry), (rx + rw, ry + rh),
                (rx, ry + rh)]
        for i in ids:
            if not (0 <= i < len(pts)):
                continue
            # half-plane intersection: cell of site i
            cell = [np.asarray(c, np.float64) for c in clip]
            for j in range(len(pts)):
                if j == i:
                    continue
                mid = (pts[i] + pts[j]) / 2
                nrm = pts[j] - pts[i]
                cell = _clip_halfplane(cell, mid, nrm)
                if not cell:
                    break
            facets.append(np.asarray(cell, np.float32))
            centers.append(tuple(pts[i]))
        return facets, np.asarray(centers, np.float32)


def _clip_halfplane(poly, mid, nrm):
    """Keep the side where (p - mid)·nrm <= 0."""
    out = []
    m = len(poly)
    for k in range(m):
        a, b = poly[k], poly[(k + 1) % m]
        da = float((a - mid) @ nrm)
        db = float((b - mid) @ nrm)
        if da <= 0:
            out.append(a)
        if (da < 0) != (db < 0) and abs(da - db) > 1e-12:
            t = da / (da - db)
            out.append(a + t * (b - a))
    return out
