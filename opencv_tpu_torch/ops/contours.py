"""Contours & planar geometry (imgproc/src/contours*.cpp, shapedescr.cpp,
convhull.cpp, approx.cpp, rotcalipers.cpp); twin of
``opencv_tpu/ops/contours.py``.

These are the reference's host-tier algorithms: pointer-chasing border
following and tiny-polygon geometry with data-dependent output sizes.  The
JAX package runs them in numpy on the host, and so does the port: this
module is its code, copied.  A tensor argument is read back once at entry
(``.cpu().numpy()``); results are numpy arrays and Python numbers, as cv2
returns them.

findContours implements Suzuki-Abe border following with the reference's
output conventions: outer borders counterclockwise, holes clockwise,
RETR_EXTERNAL/LIST/CCOMP/TREE and CHAIN_APPROX_NONE/SIMPLE.  The raster
scan visits only the pixels where a border can start or a mark was left
(a vectorised search per row), so its cost follows the borders, not the
image; the border following is the JAX package's Python trace.
``findContours`` runs the JAX package's native scan, copied into the port's
``native/hosttails.cpp``; the Python trace stays as its plain twin.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import constants as K

__all__ = ["findContours", "contourArea", "arcLength", "boundingRect",
           "minAreaRect", "boxPoints", "convexHull", "approxPolyDP",
           "isContourConvex", "pointPolygonTest", "minEnclosingCircle",
           "fitEllipse", "HuMoments", "rotatedRectangleIntersection",
           "intersectConvexConvex", "minEnclosingTriangle",
           "fitEllipseAMS", "fitEllipseDirect", "approxPolyN",
           "INTERSECT_NONE", "INTERSECT_PARTIAL", "INTERSECT_FULL"]


def _np(a, dtype=None) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a) if dtype is None else np.asarray(a, dtype)


# Moore neighborhood in OpenCV's clockwise order starting East
_NB = [(0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0), (1, 1)]


def findContours(image, mode: int, method: int):
    """Suzuki-Abe border following; returns (contours, hierarchy) with
    cv2 conventions (contours as (N,1,2) int32 arrays of (x,y)).

    Runs the native C++ scan (``native/hosttails.cpp``) for every input;
    :func:`_find_contours_simple` is its plain Python twin.  Without a
    compiler it raises, where the JAX package falls back to Python."""
    from ..native import suzuki_contours

    img = _np(image)
    if img.ndim == 3:
        img = img[:, :, 0]
    pts, parents, _ = suzuki_contours(img)
    return _package_contours(pts, parents, mode, method)


def _trace_border(F, Wp: int, p0: int, outer: bool, nbd: int, marks: list):
    """Suzuki-Abe single-border trace on the padded label image F, flat
    (row stride Wp), from pixel p0; appends each pixel it marks to `marks`
    and returns the border's flat indices."""
    offs = [dy * Wp + dx for dy, dx in _NB]
    # initial search direction: outer borders start looking West←? per
    # Suzuki: outer → from (y, x-1) i.e. dir index 4; hole → from (y, x+1)
    start_dir = 4 if outer else 0
    pts = []
    # step 3.1: clockwise search from start_dir
    d1 = None
    for i in range(8):
        dd = (start_dir - i) % 8
        if F[p0 + offs[dd]] != 0:
            d1 = dd
            break
    if d1 is None:
        F[p0] = -nbd
        marks.append(p0)
        pts.append(p0)
        return pts
    p = p0
    d = d1
    first2 = p0 + offs[d1]
    limit = 4 * len(F)
    while True:
        # 3.3: counterclockwise search from d+1... (we search from d+1 ccw)
        examined_east_zero = False
        nd = None
        for i in range(1, 9):
            dd = (d + i) % 8
            if F[p + offs[dd]] != 0:
                nd = dd
                break
            if dd == 0:
                examined_east_zero = True
        pts.append(p)
        if examined_east_zero:
            F[p] = -nbd
            marks.append(p)
        elif F[p] == 1:
            F[p] = nbd
            marks.append(p)
        p2 = p + offs[nd]
        if p2 == p0 and p == first2:
            break
        # also handle single-start loop: returning to start from any dir
        p = p2
        d = (nd + 4) % 8
        if len(pts) > limit:
            break
    return pts


def _find_contours_simple(f, mode, method):
    H, W = f.shape
    Wp = W + 2
    fg = f != 0
    F0 = np.zeros((H + 2, Wp), np.int32)
    F0[1:-1, 1:-1] = fg
    # a border can start only at a pixel with a 0 left or right of it (the
    # trace never writes a 0); elsewhere only a mark (v != 1) a trace left
    # ahead of the scan matters, to carry lnbd.  The scan visits those
    # pixels only, in raster order, over a flat view of F.
    side_zero = np.ones_like(fg)
    side_zero[:, 1:] = ~fg[:, :-1]
    side_zero[:, :-1] |= ~fg[:, 1:]
    sy, sx = np.nonzero(fg & side_zero)
    row_at = np.searchsorted(sy, np.arange(H + 1)).tolist()
    sx = (sx + 1).tolist()
    F = memoryview(F0.reshape(-1))
    ahead = {}   # row -> columns marked by a trace that the scan has not reached

    contours = []
    parents = []
    btypes = []
    nbd = 1
    border_of = {1: (-1, "hole")}

    for y in range(1, H + 1):
        lnbd = 1
        cols = sx[row_at[y - 1]:row_at[y]]
        if y in ahead:
            cols = sorted(set(cols) | ahead.pop(y))
        i = 0
        while i < len(cols):
            x = cols[i]
            i += 1
            p = y * Wp + x
            v = F[p]
            outer = (v == 1 and F[p - 1] == 0)
            hole = (v >= 1 and F[p + 1] == 0)
            if not (outer or hole):
                if v != 1:
                    lnbd = abs(v)
                continue
            nbd += 1
            btype = "outer" if outer else "hole"
            # Suzuki decision table: differing types → parent is lnbd's
            # contour; same type → parent is lnbd's parent
            pl, ptype = border_of[lnbd]
            if btype != ptype:
                parent = pl
            else:
                parent = parents[pl][0] if pl >= 0 else -1
            marks = []
            pts = _trace_border(F, Wp, p, outer, nbd, marks)
            idx = len(contours)
            contours.append([(q % Wp - 1, q // Wp - 1) for q in pts])
            parents.append((parent, idx))
            btypes.append(btype)
            border_of[nbd] = (idx, btype)
            for q in marks:
                qy, qx = divmod(q, Wp)
                if qy > y:
                    ahead.setdefault(qy, set()).add(qx)
                elif qy == y and qx > x:
                    cols.append(qx)
            if len(cols) > i:
                cols = cols[:i] + sorted(set(cols[i:]))
            if F[p] != 1:
                lnbd = abs(F[p])

    return _package_contours(contours, [p for p, _ in parents], mode, method)


def _package_contours(contours, parent_list, mode, method):
    """cv2's (contours, hierarchy) from the borders (each a sequence of
    (x, y)) and their parents, in scan order."""
    n = len(contours)
    parent = np.asarray(parent_list, np.int32).reshape(n)
    hier = np.full((n, 4), -1, np.int32)
    if mode in (K.RETR_EXTERNAL, K.RETR_LIST):
        if mode == K.RETR_EXTERNAL:
            contours = [contours[i] for i in np.flatnonzero(parent == -1)]
            n = len(contours)
            hier = np.full((n, 4), -1, np.int32)
        hier[:-1, 0] = np.arange(1, n)
        hier[1:, 1] = np.arange(n - 1)
    elif n:
        hier[:, 3] = parent
        # next / previous among the contours of one parent, in scan order
        order = np.lexsort((np.arange(n), parent))
        same = parent[order[1:]] == parent[order[:-1]]
        hier[order[:-1][same], 0] = order[1:][same]
        hier[order[1:][same], 1] = order[:-1][same]
        # first child: the first contour in scan order under each parent
        first = order[np.r_[True, ~same]]
        first = first[parent[first] >= 0]
        hier[parent[first], 2] = first

    arrs = [np.asarray(pts, np.int32).reshape(-1, 2) for pts in contours]
    if method == K.CHAIN_APPROX_SIMPLE:
        arrs = _compress_chains(arrs)
    return [a.reshape(-1, 1, 2) for a in arrs], (hier.reshape(1, -1, 4) if n else None)


def _compress_chains(arrs):
    """CHAIN_APPROX_SIMPLE on each (k, 2) border, all at once: drop the
    points whose step in equals their step out (collinear midpoints along
    h/v/diagonal runs); a border of 2 points or fewer stays whole, and one
    that would lose every point keeps its first."""
    if not arrs:
        return arrs
    lens = np.array([len(a) for a in arrs])
    first = np.cumsum(lens) - lens
    pts = np.concatenate(arrs)
    start = np.repeat(first, lens)
    size = np.repeat(lens, lens)
    j = np.arange(len(pts)) - start
    prev = pts[start + (j - 1) % size]
    nxt = pts[start + (j + 1) % size]
    keep = ((pts - prev) != (nxt - pts)).any(axis=1) | (size <= 2)
    kept = np.add.reduceat(keep.astype(np.int64), first)
    keep[first[kept == 0]] = True
    return np.split(pts[keep], np.cumsum(np.maximum(kept, 1))[:-1])


# --------------------------------------------------------------- geometry

def contourArea(contour, oriented: bool = False):
    c = _np(contour, np.float64).reshape(-1, 2)
    x, y = c[:, 0], c[:, 1]
    a = 0.5 * np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)
    return float(a if oriented else abs(a))


def arcLength(curve, closed: bool):
    c = _np(curve, np.float64).reshape(-1, 2)
    d = np.diff(c, axis=0)
    total = float(np.sum(np.hypot(d[:, 0], d[:, 1])))
    if closed and len(c) > 1:
        total += float(np.hypot(*(c[0] - c[-1])))
    return total


def boundingRect(points):
    c = _np(points).reshape(-1, 2)
    x0 = int(np.floor(c[:, 0].min()))
    y0 = int(np.floor(c[:, 1].min()))
    x1 = int(np.ceil(c[:, 0].max()))
    y1 = int(np.ceil(c[:, 1].max()))
    return (x0, y0, x1 - x0 + 1, y1 - y0 + 1)


def convexHull(points, clockwise: bool = False, returnPoints: bool = True):
    """Andrew's monotone chain; output ordering matches cv2 (clockwise in
    image coords by default ... cv2 returns counter-clockwise for
    clockwise=False in standard axes == clockwise on screen)."""
    pts = _np(points).reshape(-1, 2)
    dt = pts.dtype
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    P = pts[order].astype(np.float64)

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower, lower_idx = [], []
    for i, p in enumerate(P):
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
            lower_idx.pop()
        lower.append(p)
        lower_idx.append(order[i])
    upper, upper_idx = [], []
    for i in range(len(P) - 1, -1, -1):
        p = P[i]
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
            upper_idx.pop()
        upper.append(p)
        upper_idx.append(order[i])
    hull_idx = lower_idx[:-1] + upper_idx[:-1]
    hull = pts[hull_idx]
    if not clockwise:
        hull = hull[::-1]
        hull_idx = hull_idx[::-1]
    if returnPoints:
        return hull.reshape(-1, 1, 2).astype(dt)
    return _np(hull_idx, np.int32).reshape(-1, 1)


def approxPolyDP(curve, epsilon: float, closed: bool):
    """Douglas-Peucker (approx.cpp).  Closed curves are re-anchored at
    the two mutually farthest points so the (arbitrary) start vertex of
    the input never survives as a spurious corner."""
    raw = _np(curve).reshape(-1, 2)
    pts = raw.astype(np.float64)
    n = len(pts)
    if n < 3:
        return _np(curve).reshape(-1, 1, 2)

    if closed:
        # anchor 0: farthest from the centroid; anchor 1: farthest from
        # anchor 0 — then rotate so anchor 0 is first
        c = pts.mean(axis=0)
        a0 = int(np.argmax(((pts - c) ** 2).sum(1)))
        pts = np.roll(pts, -a0, axis=0)
        raw = np.roll(raw, -a0, axis=0)
        a1 = int(np.argmax(((pts - pts[0]) ** 2).sum(1)))

    def dp(lo, hi, keep):
        if hi <= lo + 1:
            return
        a, b = pts[lo % n], pts[hi % n]
        seg = np.arange(lo + 1, hi) % n
        ab = b - a
        L = np.hypot(*ab)
        rel = pts[seg] - a
        if L == 0:
            d = np.hypot(rel[:, 0], rel[:, 1])
        else:
            d = np.abs(ab[0] * rel[:, 1] - ab[1] * rel[:, 0]) / L
        i = int(np.argmax(d))
        if d[i] > epsilon:
            m = lo + 1 + i
            keep[m % n] = True
            dp(lo, m, keep)
            dp(m, hi, keep)

    keep = np.zeros(n, bool)
    if closed:
        keep[0] = keep[a1] = True
        dp(0, a1, keep)
        dp(a1, n, keep)       # wraps back to index 0
    else:
        keep[0] = keep[n - 1] = True
        dp(0, n - 1, keep)
    out = raw[keep[:n]] if closed else pts[keep]
    return _np(out).reshape(-1, 1, 2).astype(
        _np(curve).dtype)


def isContourConvex(contour):
    """Strict convexity: collinear vertices count as non-convex (matches
    the reference, which rejects zero turns)."""
    c = _np(contour, np.float64).reshape(-1, 2)
    n = len(c)
    if n < 3:
        return False
    crosses = []
    for i in range(n):
        o, a, b = c[i], c[(i + 1) % n], c[(i + 2) % n]
        crosses.append((a[0] - o[0]) * (b[1] - o[1])
                       - (a[1] - o[1]) * (b[0] - o[0]))
    crosses = _np(crosses)
    return bool(np.all(crosses > 0) or np.all(crosses < 0))


def pointPolygonTest(contour, pt, measureDist: bool):
    c = _np(contour, np.float64).reshape(-1, 2)
    x, y = float(pt[0]), float(pt[1])
    n = len(c)
    inside = False
    mind = np.inf
    j = n - 1
    for i in range(n):
        xi, yi = c[i]
        xj, yj = c[j]
        if ((yi > y) != (yj > y)) and \
                (x < (xj - xi) * (y - yi) / (yj - yi) + xi):
            inside = not inside
        # distance to segment
        if measureDist:
            dx, dy = xj - xi, yj - yi
            L2 = dx * dx + dy * dy
            t = 0.0 if L2 == 0 else max(0.0, min(1.0, ((x - xi) * dx + (y - yi) * dy) / L2))
            px, py = xi + t * dx, yi + t * dy
            mind = min(mind, math.hypot(x - px, y - py))
        else:
            # on-edge check
            dx, dy = xj - xi, yj - yi
            cr = dx * (y - yi) - dy * (x - xi)
            if cr == 0 and min(xi, xj) <= x <= max(xi, xj) \
                    and min(yi, yj) <= y <= max(yi, yj):
                return 0.0
        j = i
    if not measureDist:
        return 1.0 if inside else -1.0
    return mind if inside else -mind


def minAreaRect(points):
    """Rotating calipers over the convex hull (rotcalipers.cpp)."""
    hull = convexHull(points).reshape(-1, 2).astype(np.float64)
    n = len(hull)
    if n == 1:
        return ((float(hull[0, 0]), float(hull[0, 1])), (0.0, 0.0), 0.0)
    if n == 2:
        c = hull.mean(axis=0)
        d = hull[1] - hull[0]
        return ((float(c[0]), float(c[1])), (float(np.hypot(*d)), 0.0),
                float(math.degrees(math.atan2(d[1], d[0]))))
    best = None
    for i in range(n):
        e = hull[(i + 1) % n] - hull[i]
        L = np.hypot(*e)
        if L == 0:
            continue
        ux, uy = e / L
        # rotate all points into edge frame
        R = np.array([[ux, uy], [-uy, ux]])
        q = (hull - hull[i]) @ R.T
        w = q[:, 0].max() - q[:, 0].min()
        h = q[:, 1].max() - q[:, 1].min()
        area = w * h
        if best is None or area < best[0]:
            cx = (q[:, 0].min() + q[:, 0].max()) / 2
            cy = (q[:, 1].min() + q[:, 1].max()) / 2
            center = hull[i] + np.array([cx, cy]) @ R
            angle = math.degrees(math.atan2(uy, ux))
            best = (area, (float(center[0]), float(center[1])),
                    (float(w), float(h)), angle)
    _, c, wh, ang = best
    # normalize angle to (0, 90] like cv2 4.5+
    w, h = wh
    ang = ang % 90.0
    if ang == 0:
        ang = 90.0
        w, h = h, w
    return (c, (w, h), ang)


def boxPoints(rect):
    (cx, cy), (w, h), ang = rect
    a = math.radians(ang)
    c, s = math.cos(a), math.sin(a)
    dx, dy = w / 2, h / 2
    pts = np.array([[-dx, -dy], [dx, -dy], [dx, dy], [-dx, dy]])
    R = np.array([[c, -s], [s, c]])
    out = pts @ R.T + np.array([cx, cy])
    # cv2 order: bottomLeft, topLeft, topRight, bottomRight
    out = np.array([out[3], out[0], out[1], out[2]], np.float32)
    return out


def minEnclosingCircle(points):
    """Welzl via incremental (small inputs)."""
    pts = _np(points, np.float64).reshape(-1, 2)

    def circle2(a, b):
        c = (a + b) / 2
        return c, np.hypot(*(a - b)) / 2

    def circle3(a, b, c):
        ax, ay = a
        bx, by = b
        cx, cy = c
        d = 2 * (ax * (by - cy) + bx * (cy - ay) + cx * (ay - by))
        if abs(d) < 1e-12:
            return None
        ux = ((ax**2 + ay**2) * (by - cy) + (bx**2 + by**2) * (cy - ay)
              + (cx**2 + cy**2) * (ay - by)) / d
        uy = ((ax**2 + ay**2) * (cx - bx) + (bx**2 + by**2) * (ax - cx)
              + (cx**2 + cy**2) * (bx - ax)) / d
        ctr = np.array([ux, uy])
        return ctr, np.hypot(*(a - ctr))

    rng = np.random.default_rng(0)
    P = pts[rng.permutation(len(pts))]
    c, r = P[0], 0.0
    for i in range(1, len(P)):
        if np.hypot(*(P[i] - c)) <= r + 1e-9:
            continue
        c, r = P[i], 0.0
        for j in range(i):
            if np.hypot(*(P[j] - c)) <= r + 1e-9:
                continue
            c, r = circle2(P[i], P[j])
            for k in range(j):
                if np.hypot(*(P[k] - c)) <= r + 1e-9:
                    continue
                res = circle3(P[i], P[j], P[k])
                if res is not None:
                    c, r = res
    return (float(c[0]), float(c[1])), float(r)


def fitEllipse(points):
    """Least-squares ellipse fit (fitellipse.cpp ~ Fitzgibbon)."""
    pts = _np(points, np.float64).reshape(-1, 2)
    x = pts[:, 0]
    y = pts[:, 1]
    xm, ym = x.mean(), y.mean()
    xs, ys = x - xm, y - ym
    D = np.column_stack([xs * xs, xs * ys, ys * ys, xs, ys, np.ones_like(xs)])
    _, _, V = np.linalg.svd(D, full_matrices=False)
    A = V[-1]
    a, b, c, d, e, f = A
    # convert conic to ellipse params
    den = b * b - 4 * a * c
    if den >= 0:
        raise ValueError("degenerate ellipse")
    cx = (2 * c * d - b * e) / den
    cy = (2 * a * e - b * d) / den
    num = 2 * (a * e * e + c * d * d - b * d * e + den * f)
    s = math.sqrt((a - c) ** 2 + b * b)
    w2 = num / (den * ((a + c) + s))
    h2 = num / (den * ((a + c) - s))
    if w2 <= 0 or h2 <= 0:
        raise ValueError("degenerate ellipse")
    w = 2 * math.sqrt(w2)
    h = 2 * math.sqrt(h2)
    if b == 0:
        ang = 0.0 if a < c else 90.0
    else:
        ang = math.degrees(0.5 * math.atan2(b, a - c))
    if w < h:
        w, h = h, w
        ang += 90.0
    ang = ang % 180.0
    return ((cx + xm, cy + ym), (w, h), ang)


def HuMoments(m):
    """`cv::HuMoments` from a moments dict."""
    n20, n02, n11 = m["nu20"], m["nu02"], m["nu11"]
    n30, n21, n12, n03 = m["nu30"], m["nu21"], m["nu12"], m["nu03"]
    t0 = n30 + n12
    t1 = n21 + n03
    hu = np.zeros(7)
    hu[0] = n20 + n02
    hu[1] = (n20 - n02) ** 2 + 4 * n11 * n11
    hu[2] = (n30 - 3 * n12) ** 2 + (3 * n21 - n03) ** 2
    hu[3] = t0 * t0 + t1 * t1
    hu[4] = (n30 - 3 * n12) * t0 * (t0 * t0 - 3 * t1 * t1) \
        + (3 * n21 - n03) * t1 * (3 * t0 * t0 - t1 * t1)
    hu[5] = (n20 - n02) * (t0 * t0 - t1 * t1) + 4 * n11 * t0 * t1
    hu[6] = (3 * n21 - n03) * t0 * (t0 * t0 - 3 * t1 * t1) \
        - (n30 - 3 * n12) * t1 * (3 * t0 * t0 - t1 * t1)
    return hu.reshape(7, 1)


INTERSECT_NONE = 0
INTERSECT_PARTIAL = 1
INTERSECT_FULL = 2


def _clip_poly(subject, clip):
    """Sutherland-Hodgman clip of polygon `subject` by convex `clip`."""
    def inside(p, a, b):
        return (b[0] - a[0]) * (p[1] - a[1]) \
            - (b[1] - a[1]) * (p[0] - a[0]) >= -1e-9

    def isect(p1, p2, a, b):
        d1 = _np(p2) - p1
        d2 = _np(b) - a
        denom = d1[0] * d2[1] - d1[1] * d2[0]
        if abs(denom) < 1e-12:
            return p2
        t = ((a[0] - p1[0]) * d2[1] - (a[1] - p1[1]) * d2[0]) / denom
        return (p1[0] + t * d1[0], p1[1] + t * d1[1])

    out = [tuple(p) for p in subject]
    n = len(clip)
    for i in range(n):
        a = clip[i]
        b = clip[(i + 1) % n]
        cur = out
        out = []
        for j in range(len(cur)):
            p1 = cur[j - 1]
            p2 = cur[j]
            if inside(p2, a, b):
                if not inside(p1, a, b):
                    out.append(isect(p1, p2, a, b))
                out.append(p2)
            elif inside(p1, a, b):
                out.append(isect(p1, p2, a, b))
        if not out:
            return []
    return out


def _ccw(poly):
    p = _np(poly, np.float64)
    area = 0.5 * np.sum(p[:, 0] * np.roll(p[:, 1], -1)
                        - np.roll(p[:, 0], -1) * p[:, 1])
    return p if area >= 0 else p[::-1]


def rotatedRectangleIntersection(rect1, rect2):
    """cv2.rotatedRectangleIntersection: returns (status, points)."""
    q1 = _ccw(_np(boxPoints(rect1), np.float64))
    q2 = _ccw(_np(boxPoints(rect2), np.float64))
    inter = _clip_poly(q1, q2)
    if not inter:
        return INTERSECT_NONE, None
    pts = _np(inter, np.float32)
    # dedup nearly-identical vertices like the reference
    keep = [0]
    for i in range(1, len(pts)):
        if np.linalg.norm(pts[i] - pts[keep[-1]]) > 1e-5:
            keep.append(i)
    if len(keep) > 1 and np.linalg.norm(pts[keep[-1]] - pts[keep[0]]) <= 1e-5:
        keep = keep[:-1]
    pts = pts[keep]
    a_int = abs(contourArea(pts))
    a1 = abs(contourArea(q1.astype(np.float32)))
    a2 = abs(contourArea(q2.astype(np.float32)))
    status = INTERSECT_FULL if abs(a_int - min(a1, a2)) < 1e-4 * min(a1, a2) \
        else INTERSECT_PARTIAL
    return status, pts.reshape(-1, 1, 2)


def intersectConvexConvex(p1, p2, handleNested=True):
    """cv2.intersectConvexConvex: returns (area, points)."""
    q1 = _ccw(_np(p1, np.float64).reshape(-1, 2))
    q2 = _ccw(_np(p2, np.float64).reshape(-1, 2))
    inter = _clip_poly(q1, q2)
    if not inter:
        return 0.0, None
    pts = _np(inter, np.float32)
    return float(abs(contourArea(pts))), pts.reshape(-1, 1, 2)


def minEnclosingTriangle(points):
    """cv2.minEnclosingTriangle (returns (area, triangle (3,1,2) f32)).

    Searches triangles whose sides are flush with hull edges; the true
    optimum can also have midpoint-tangent sides (O'Rourke), so the
    area may exceed the reference's by a few percent."""
    pts = _np(points, np.float64).reshape(-1, 2)
    hull = _np(convexHull(pts.astype(np.float32))).reshape(-1, 2)
    n = len(hull)
    if n < 3:
        return 0.0, None
    best = None

    def line_from(a, b):
        d = b - a
        return a, d / (np.linalg.norm(d) + 1e-300)

    # brute-force over triples of flush edges (hull is tiny in practice)
    import itertools
    for i, j, k in itertools.combinations(range(n), 3):
        trio = []
        ok = True
        lines = []
        for e in (i, j, k):
            a = hull[e]
            b = hull[(e + 1) % n]
            lines.append(line_from(a, b))
        # triangle vertices = pairwise line intersections
        tri = []
        for (a1, d1), (a2, d2) in itertools.combinations(lines, 2):
            denom = d1[0] * d2[1] - d1[1] * d2[0]
            if abs(denom) < 1e-12:
                ok = False
                break
            t = ((a2[0] - a1[0]) * d2[1] - (a2[1] - a1[1]) * d2[0]) / denom
            tri.append(a1 + t * d1)
        if not ok or len(tri) != 3:
            continue
        tri = _np(tri)
        # must contain all hull points
        def side(p, a, b):
            return (b[0] - a[0]) * (p[:, 1] - a[1]) \
                - (b[1] - a[1]) * (p[:, 0] - a[0])
        s0 = side(hull, tri[0], tri[1])
        s1 = side(hull, tri[1], tri[2])
        s2 = side(hull, tri[2], tri[0])
        ccw = contourArea(tri.astype(np.float32))
        sgn = 1 if ccw >= 0 else -1
        if (sgn * s0 >= -1e-6).all() and (sgn * s1 >= -1e-6).all() \
                and (sgn * s2 >= -1e-6).all():
            area = abs(ccw)
            if best is None or area < best[0]:
                best = (area, tri)
    if best is None:
        return 0.0, None
    area, tri = best
    return float(area), tri.astype(np.float32).reshape(3, 1, 2)


def convexityDefects(contour, convexhull):
    """`cv::convexityDefects` (imgproc/src/convhull.cpp:313): for each
    hull edge, the deepest contour point between its endpoints.
    Returns (N, 4) int32 rows [start_idx, end_idx, farthest_idx,
    fixpt_depth(<<8)] (the 5.0 wheel's shape) or None when the contour
    has <=3 points."""
    pts = _np(contour).reshape(-1, 2).astype(np.int64)
    hull = _np(convexhull).reshape(-1).astype(np.int64)
    npoints = len(pts)
    if npoints <= 3 or len(hull) < 3:
        return None
    rev = (int(hull[1] > hull[0]) + int(hull[2] > hull[1])
           + int(hull[0] > hull[2])) != 2
    hcurr = hull[0] if rev else hull[-1]
    defects = []
    for i in range(len(hull)):
        hnext = hull[len(hull) - i - 1] if rev else hull[i]
        p0 = pts[hcurr]
        p1 = pts[hnext]
        dx0 = float(p1[0] - p0[0])
        dy0 = float(p1[1] - p0[1])
        scale = 0.0 if dx0 == 0 and dy0 == 0 else \
            1.0 / math.sqrt(dx0 * dx0 + dy0 * dy0)
        deepest, depth, is_defect = -1, 0.0, False
        j = hcurr
        while True:
            j = (j + 1) % npoints
            if j == hnext:
                break
            dx = float(pts[j][0] - p0[0])
            dy = float(pts[j][1] - p0[1])
            dist = abs(-dy0 * dx + dx0 * dy) * scale
            if dist > depth:
                depth, deepest, is_defect = dist, j, True
        if is_defect:
            defects.append((int(hcurr), int(hnext), int(deepest),
                            int(np.rint(depth * 256))))
        hcurr = hnext
    if not defects:
        return np.zeros((0, 4), np.int32)
    return _np(defects, np.int32).reshape(-1, 4)


def _ellipse_box(pvec, Qv, l3_scale, c, scale, fmod_swap=True):
    """Shared ellipse-parameter extraction (shapedescr.cpp tail of
    fitEllipseAMS/Direct): center, axes, angle from the conic
    coefficients in shifted/scaled coordinates."""
    pa, pb, pc = pvec[0], pvec[1], pvec[2]
    q0, q1, q2 = Qv
    u1 = pc*q0*q0 - pb*q0*q1 + pa*q1*q1 + pb*pb*q2
    u2 = pa*pc*q2
    l1 = np.sqrt(pb*pb + (pa - pc)**2)
    l2 = pa + pc
    l3 = pb*pb - 4*pa*pc
    p1 = 2*pc*q0 - pb*q1
    p2 = 2*pa*q1 - pb*q0
    x0 = p1/l3/scale + c[0]
    y0 = p2/l3/scale + c[1]
    a = np.sqrt(2.) * np.sqrt((u1 - 4.0*u2)/((l1 - l2)*l3))/scale
    b = np.sqrt(2.) * np.sqrt(-1.0*((u1 - 4.0*u2)/((l1 + l2)*l3)))/scale
    if pb == 0:
        theta = 0.0 if pa < pc else np.pi/2.
    else:
        theta = np.pi/2. + 0.5*np.arctan2(pb, pa - pc)
    w, h = 2.0*a, 2.0*b
    if w > h:
        w, h = h, w
        ang = 90 + theta*180/np.pi     # AMS keeps the raw value here
        if fmod_swap:
            ang = np.fmod(ang, 180.0)  # Direct wraps it
    else:
        ang = np.fmod(theta*180/np.pi, 180.0)
    return ((float(np.float32(x0)), float(np.float32(y0))),
            (float(np.float32(w)), float(np.float32(h))),
            float(np.float32(ang)))


def _design_moments(pts, c, scale):
    px = (pts[:, 0] - c[0]) * scale
    py = (pts[:, 1] - c[1]) * scale
    A = np.stack([px*px, px*py, py*py, px, py,
                  np.ones_like(px)], axis=1)
    return (A.T @ A) / len(pts)


def fitEllipseAMS(points):
    """cv::fitEllipseAMS (shapedescr.cpp:514) — Taubin's approximate
    mean-square conic fit; falls back to fitEllipseDirect when the
    solution is not elliptical (parabolic degeneracies)."""
    pts = _np(points, np.float64).reshape(-1, 2)
    n = len(pts)
    if n < 5:
        raise ValueError("at least 5 points required")
    c = pts.mean(axis=0)
    s = np.abs(pts - c).sum()
    scale = 100.0 / max(s, 1.1920929e-07)
    D = _design_moments(pts, c, scale)
    dnm = D[2, 5]*(D[0, 5] + D[2, 5]) - D[1, 5]*D[1, 5]
    ddm = 4.*(D[0, 5] + D[2, 5])*(D[0, 5]*D[2, 5] - D[1, 5]*D[1, 5])
    ddmm = 2.*(D[0, 5] + D[2, 5])*(D[0, 5]*D[2, 5] - D[1, 5]*D[1, 5])
    M = np.zeros((5, 5))
    M[0, 0] = ((-D[0, 0] + D[0, 2] + D[0, 5]**2)*D[1, 5]**2
               + (-2*D[0, 1]*D[1, 5] + D[0, 5]*(D[0, 0] - D[0, 5]**2
                                                + D[1, 5]**2))*D[2, 5]
               + (D[0, 0] - D[0, 5]**2)*D[2, 5]**2) / ddm
    M[0, 1] = (D[1, 5]**2*(-D[0, 1] + D[1, 2] + D[0, 5]*D[1, 5])
               + (D[0, 1]*D[0, 5] - (D[0, 5]**2 + 2*D[1, 1])*D[1, 5]
                  + D[1, 5]**3)*D[2, 5]
               + (D[0, 1] - D[0, 5]*D[1, 5])*D[2, 5]**2) / ddm
    M[0, 2] = (-2*D[1, 2]*D[1, 5]*D[2, 5]
               - D[0, 5]*D[2, 5]**2*(D[0, 5] + D[2, 5]) + D[0, 2]*dnm
               + D[1, 5]**2*(D[2, 2] + D[2, 5]*(D[0, 5] + D[2, 5])))/ddm
    M[0, 3] = (D[1, 5]*(D[1, 5]*D[2, 3] - 2*D[1, 3]*D[2, 5])
               + D[0, 3]*dnm) / ddm
    M[0, 4] = (D[1, 5]*(D[1, 5]*D[2, 4] - 2*D[1, 4]*D[2, 5])
               + D[0, 4]*dnm) / ddm
    M[1, 0] = (-(D[0, 2]*D[0, 5]*D[1, 5])
               + (2*D[0, 1]*D[0, 5] - D[0, 0]*D[1, 5])*D[2, 5])/ddmm
    M[1, 1] = (-(D[0, 1]*D[1, 5]*D[2, 5])
               + D[0, 5]*(-(D[1, 2]*D[1, 5]) + 2*D[1, 1]*D[2, 5]))/ddmm
    M[1, 2] = (-(D[0, 2]*D[1, 5]*D[2, 5])
               + D[0, 5]*(-(D[1, 5]*D[2, 2]) + 2*D[1, 2]*D[2, 5]))/ddmm
    M[1, 3] = (-(D[0, 3]*D[1, 5]*D[2, 5])
               + D[0, 5]*(-(D[1, 5]*D[2, 3]) + 2*D[1, 3]*D[2, 5]))/ddmm
    M[1, 4] = (-(D[0, 4]*D[1, 5]*D[2, 5])
               + D[0, 5]*(-(D[1, 5]*D[2, 4]) + 2*D[1, 4]*D[2, 5]))/ddmm
    M[2, 0] = (-2*D[0, 1]*D[0, 5]*D[1, 5]
               + (D[0, 0] + D[0, 5]**2)*D[1, 5]**2
               + D[0, 5]*(-D[0, 5]**2 + D[1, 5]**2)*D[2, 5]
               - D[0, 5]**2*D[2, 5]**2
               + D[0, 2]*(-D[1, 5]**2 + D[0, 5]*(D[0, 5] + D[2, 5]))) / ddm
    M[2, 1] = (D[0, 5]**2*(D[1, 2] - D[1, 5]*D[2, 5])
               + D[1, 5]**2*(D[0, 1] - D[1, 2] + D[1, 5]*D[2, 5])
               + D[0, 5]*(D[1, 2]*D[2, 5]
                          + D[1, 5]*(-2*D[1, 1] + D[1, 5]**2
                                     - D[2, 5]**2))) / ddm
    M[2, 2] = (D[0, 5]**2*(D[2, 2] - D[2, 5]**2)
               + D[1, 5]**2*(D[0, 2] - D[2, 2] + D[2, 5]**2)
               + D[0, 5]*(-2*D[1, 2]*D[1, 5]
                          + D[2, 5]*(D[1, 5]**2 + D[2, 2]
                                     - D[2, 5]**2))) / ddm
    M[2, 3] = (D[1, 5]**2*(D[0, 3] - D[2, 3]) + D[0, 5]**2*D[2, 3]
               + D[0, 5]*(-2*D[1, 3]*D[1, 5] + D[2, 3]*D[2, 5])) / ddm
    M[2, 4] = (D[1, 5]**2*(D[0, 4] - D[2, 4]) + D[0, 5]**2*D[2, 4]
               + D[0, 5]*(-2*D[1, 4]*D[1, 5] + D[2, 4]*D[2, 5])) / ddm
    M[3] = [D[0, 3], D[1, 3], D[2, 3], D[3, 3], D[3, 4]]
    M[4] = [D[0, 4], D[1, 4], D[2, 4], D[3, 4], D[4, 4]]

    if abs(np.linalg.det(M)) <= 1e-10:
        return fitEllipse(points)   # singular → NoDirect fallback
    w, V = np.linalg.eig(M)
    w, V = w.real, V.real
    norms = np.sqrt((V**2).sum(axis=0))
    minpos = int(np.argmin(w * norms))
    pv = V[:, minpos] / norms[minpos]
    c5 = -pv[0]*D[0, 5] - pv[1]*D[1, 5] - pv[2]*D[2, 5]
    co = [pv[0], pv[1], pv[2], pv[3], pv[4], c5]
    bound = (-(co[2]*co[3]**2) + co[1]*co[3]*co[4]
             - co[0]*co[4]**2) / (co[1]**2 - 4*co[0]*co[2])
    is_ell = ((co[0] < 0 and co[2] < co[1]**2/(4.*co[0])
               and co[5] > bound)
              or (co[0] > 0 and co[2] > co[1]**2/(4.*co[0])
                  and co[5] < bound))
    if not is_ell:
        return fitEllipseDirect(points)
    return _ellipse_box(pv[:3], (pv[3], pv[4], c5), None, c, scale,
                        fmod_swap=False)


def fitEllipseDirect(points):
    """cv::fitEllipseDirect (shapedescr.cpp:712) — Fitzgibbon's direct
    least-squares conic fit with the 4ac−b²>0 ellipticity constraint."""
    pts = _np(points, np.float64).reshape(-1, 2)
    n = len(pts)
    if n < 5:
        raise ValueError("at least 5 points required")
    c = pts.mean(axis=0)
    s = np.abs(pts - c).sum()
    scale = 100.0 / max(s, 1.1920929e-07)
    D = _design_moments(pts, c, scale)
    TM = np.zeros((3, 3))
    for r_, src in enumerate((0, 1, 2)):
        TM[0, r_] = (D[src, 5]*D[3, 5]*D[4, 4] - D[src, 5]*D[3, 4]*D[4, 5]
                     - D[src, 4]*D[3, 5]*D[5, 4] + D[src, 3]*D[4, 5]*D[5, 4]
                     + D[src, 4]*D[3, 4]*D[5, 5] - D[src, 3]*D[4, 4]*D[5, 5])
        TM[1, r_] = (D[src, 5]*D[3, 3]*D[4, 5] - D[src, 5]*D[3, 5]*D[4, 3]
                     + D[src, 4]*D[3, 5]*D[5, 3] - D[src, 3]*D[4, 5]*D[5, 3]
                     - D[src, 4]*D[3, 3]*D[5, 5] + D[src, 3]*D[4, 3]*D[5, 5])
        TM[2, r_] = (D[src, 5]*D[3, 4]*D[4, 3] - D[src, 5]*D[3, 3]*D[4, 4]
                     - D[src, 4]*D[3, 4]*D[5, 3] + D[src, 3]*D[4, 4]*D[5, 3]
                     + D[src, 4]*D[3, 3]*D[5, 4] - D[src, 3]*D[4, 3]*D[5, 4])
    Ts = (-(D[3, 5]*D[4, 4]*D[5, 3]) + D[3, 4]*D[4, 5]*D[5, 3]
          + D[3, 5]*D[4, 3]*D[5, 4] - D[3, 3]*D[4, 5]*D[5, 4]
          - D[3, 4]*D[4, 3]*D[5, 5] + D[3, 3]*D[4, 4]*D[5, 5])
    M = np.zeros((3, 3))
    for j in range(3):
        M[0, j] = (D[2, j] + (D[2, 3]*TM[0, j] + D[2, 4]*TM[1, j]
                              + D[2, 5]*TM[2, j])/Ts)/2.
        M[1, j] = -D[1, j] - (D[1, 3]*TM[0, j] + D[1, 4]*TM[1, j]
                              + D[1, 5]*TM[2, j])/Ts
        M[2, j] = (D[0, j] + (D[0, 3]*TM[0, j] + D[0, 4]*TM[1, j]
                              + D[0, 5]*TM[2, j])/Ts)/2.
    if abs(np.linalg.det(M)) <= 1e-10:
        return fitEllipse(points)
    w, V = np.linalg.eig(M)
    V = V.real
    cond = 4.0*V[0]*V[2] - V[1]*V[1]
    i = int(np.argmax(cond))
    norm = np.sqrt((V[:, i]**2).sum())
    if np.prod(np.where(V[:, i] < 0, -1, 1)) <= 0:
        norm = -norm
    pv = V[:, i] / norm
    Qv = (TM @ pv) / Ts
    return _ellipse_box(pv, (Qv[0], Qv[1], Qv[2]), None, c, scale)


def approxPolyN(curve, nsides: int, epsilon_percentage: float = -1.0,
                ensure_convex: bool = True):
    """cv::approxPolyN (approx.cpp:959): greedy vertex-contraction
    bounding-polygon approximation of a convex contour down to exactly
    nsides vertices (or until the extra-area budget is exhausted)."""
    import heapq
    f32 = np.float32
    a = _np(curve)
    int_out = a.dtype.kind in "iu"
    if ensure_convex:
        pts = convexHull(a.astype(np.float32).reshape(-1, 1, 2))
        # match the reference hull's traversal orientation
        pts = _np(pts, np.float32).reshape(-1, 2)[::-1]
    else:
        if not isContourConvex(a):
            raise ValueError("curve must be convex")
        pts = a.astype(np.float32).reshape(-1, 2)
    n = len(pts)
    if n < nsides:
        raise ValueError("need at least nsides points")
    nxt = list(range(1, n)) + [0]
    prv = [n - 1] + list(range(n - 1))
    P = [(f32(x), f32(y)) for x, y in pts]
    status = [1] * n   # 1 CALCULATED, 0 RECALCULATE, -1 REMOVED
    size = n
    max_extra = (f32(epsilon_percentage) * f32(contourArea(a))
                 if epsilon_percentage != -1 else None)
    extra = f32(0)

    def recalc(v):
        p = P[v]
        q = P[nxt[v]]
        e1 = P[prv[v]]
        e2 = P[nxt[nxt[v]]]
        ce = (f32(q[0] - p[0]), f32(q[1] - p[1]))
        pe = (f32(p[0] - e1[0]), f32(p[1] - e1[1]))
        ne = (f32(e2[0] - q[0]), f32(e2[1] - q[1]))
        cross = f32(pe[0] * ne[1] - pe[1] * ne[0])
        if abs(cross) < 1e-8:
            return f32(np.finfo(np.float32).max), (f32(-1), f32(-1))
        t = f32((ce[0] * ne[1] - ce[1] * ne[0]) / cross)
        ix = f32(p[0] + pe[0] * t)
        iy = f32(p[1] + pe[1] * t)
        area = f32(0.5 * abs((q[0] - p[0]) * (iy - p[1])
                             - (ix - p[0]) * (q[1] - p[1])))
        return area, (ix, iy)

    heap = []
    if size > nsides:
        for v in range(n):
            ar, ipt = recalc(v)
            heapq.heappush(heap, (ar, v, ipt))
    while size > nsides and heap:
        ar, v, ipt = heap[0]
        if status[v] == -1:
            heapq.heappop(heap)
        elif status[v] == 0:
            heapq.heappop(heap)
            ar, ipt = recalc(v)
            heapq.heappush(heap, (ar, v, ipt))
            status[v] = 1
        else:
            if max_extra is not None:
                extra = f32(extra + ar)
                if extra > max_extra:
                    break
            size -= 1
            P[v] = ipt
            rem = nxt[v]
            v2 = nxt[rem]
            status[rem] = -1
            status[v] = 0
            status[v2] = 0
            status[prv[v]] = 0
            nxt[v] = v2
            prv[v2] = v
    out = [P[i] for i in range(n) if status[i] != -1]
    arr = _np(out, np.float32).reshape(-1, 1, 2)
    if int_out:
        arr = np.round(arr).astype(np.int32)
    return arr
