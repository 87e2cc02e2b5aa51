"""findCirclesGrid + estimateChessboardSharpness
(calib3d/src/circlesgrid.cpp, calibinit.cpp).

findCirclesGrid: blob-detect circle centers, then order them into the
(symmetric or asymmetric) grid by fitting a projective map from the
canonical grid through the detected point set (corner-anchored
homography + cell snapping), validated by full occupancy — the same
outcome as the reference's graph-based CirclesGridFinder on clean
detections.

Twin of ``opencv_tpu/calib3d/circlesgrid.py``: the same numpy over the
port's SimpleBlobDetector and convexHull."""

from __future__ import annotations

import itertools

import numpy as np

from .. import constants as K

__all__ = ["findCirclesGrid", "estimateChessboardSharpness",
           "CALIB_CB_SYMMETRIC_GRID", "CALIB_CB_ASYMMETRIC_GRID",
           "CALIB_CB_CLUSTERING"]

CALIB_CB_SYMMETRIC_GRID = 1
CALIB_CB_ASYMMETRIC_GRID = 2
CALIB_CB_CLUSTERING = 4


def _canonical_grid(w, h, asymmetric):
    if asymmetric:
        pts = [(2 * j + i % 2, i) for i in range(h) for j in range(w)]
    else:
        pts = [(j, i) for i in range(h) for j in range(w)]
    return np.asarray(pts, np.float64)


def _order_by_homography(centers, w, h, asymmetric):
    """Try corner assignments of the detected hull to the canonical
    grid corners; accept the homography that snaps every detection
    onto a distinct grid node."""
    from .geometry import findHomography

    n = w * h
    if len(centers) != n:
        return None
    canon = _canonical_grid(w, h, asymmetric)
    corners_c = [canon[0], canon[w - 1], canon[-1], canon[-w]]
    hull_idx = _convex_hull_idx(centers)
    hull = centers[hull_idx]
    # candidate image-corner quadruples: pick 4 hull points maximizing
    # spread (the grid corners are hull vertices on clean detections)
    if len(hull) < 4:
        return None
    best = None
    for quad in _corner_quads(hull):
        for roll in range(4):
            for flip in (False, True):
                q = np.roll(quad, roll, axis=0)
                if flip:
                    q = q[::-1]
                Hm, _ = findHomography(
                    np.asarray(q, np.float32),
                    np.asarray(corners_c, np.float32), 0)
                if Hm is None:
                    continue
                Hm = np.asarray(Hm, np.float64)
                ph = np.hstack([centers, np.ones((n, 1))]) @ Hm.T
                g = ph[:, :2] / ph[:, 2:3]
                snapped = np.round(g)
                err = np.abs(g - snapped).max()
                # each detection must land on a distinct canonical node
                key = {tuple(p) for p in snapped.tolist()}
                ok = len(key) == n and \
                    key == {tuple(p) for p in canon.tolist()}
                if ok and (best is None or err < best[0]):
                    lut = {tuple(p): i for i, p in
                           enumerate(snapped.tolist())}
                    order = [lut[tuple(p)] for p in canon.tolist()]
                    best = (err, order)
    if best is None:
        return None
    return centers[best[1]]


def _convex_hull_idx(pts):
    from ..ops.contours import convexHull
    h = convexHull(pts.astype(np.float32).reshape(-1, 1, 2),
                   returnPoints=False)
    return np.asarray(h).ravel()


def _corner_quads(hull, max_quads=40):
    """Largest-area quadrilaterals from hull vertices (top few)."""
    m = len(hull)
    quads = []
    for combo in itertools.combinations(range(m), 4):
        q = hull[list(combo)]
        area = 0.5 * abs(
            sum(q[i][0] * q[(i + 1) % 4][1]
                - q[(i + 1) % 4][0] * q[i][1] for i in range(4)))
        quads.append((area, q))
    quads.sort(key=lambda t: -t[0])
    return [q for _a, q in quads[:max_quads]]


def findCirclesGrid(image, patternSize, flags=CALIB_CB_SYMMETRIC_GRID,
                    blobDetector=None, parameters=None):
    """cv::findCirclesGrid → (ok, centers (N,1,2) float32 row-major
    from the grid's top-left)."""
    w, h = int(patternSize[0]), int(patternSize[1])
    if blobDetector is None:
        from ..features2d.blob import SimpleBlobDetector_create
        blobDetector = SimpleBlobDetector_create()
    kps = blobDetector.detect(image)
    centers = np.asarray([kp.pt for kp in kps], np.float64)
    if len(centers) < w * h:
        return False, None
    asym = bool(flags & CALIB_CB_ASYMMETRIC_GRID)
    if len(centers) > w * h:
        # keep the w*h blobs closest to the centroid cluster
        c = centers.mean(axis=0)
        d = np.linalg.norm(centers - c, axis=1)
        centers = centers[np.argsort(d)[:w * h]]
    ordered = _order_by_homography(centers, w, h, asym)
    if ordered is None:
        return False, None
    return True, ordered.astype(np.float32).reshape(-1, 1, 2)


def estimateChessboardSharpness(image, patternSize, corners,
                                rise_distance: float = 0.8,
                                vertical: bool = False):
    """cv::estimateChessboardSharpness (calibinit.cpp): sample the
    luminance profile along horizontal (or vertical) chessboard edges
    between neighboring corners and measure the mean 10%-90% rise
    width.  Returns (Scalar(avgSharpness, avgMinBrightness,
    avgMaxBrightness, 0), per-edge samples)."""
    from ..core.arrays import to_host
    img = to_host(image)
    if img.ndim == 3:
        img = img.mean(axis=2)
    img = img.astype(np.float64)
    w, h = int(patternSize[0]), int(patternSize[1])
    pts = np.asarray(corners, np.float64).reshape(h, w, 2)
    edges = []
    if not vertical:
        pairs = [((r, c), (r, c + 1)) for r in range(h)
                 for c in range(w - 1)]
    else:
        pairs = [((r, c), (r + 1, c)) for r in range(h - 1)
                 for c in range(w)]
    H, W = img.shape
    res = []
    for (r0, c0), (r1, c1) in pairs:
        p0, p1 = pts[r0, c0], pts[r1, c1]
        mid = (p0 + p1) / 2
        d = p1 - p0
        nrm = np.array([-d[1], d[0]])
        ln = np.linalg.norm(nrm)
        if ln < 1e-9:
            continue
        nrm /= ln
        # sample perpendicular profile through the edge midpoint
        ts = np.linspace(-3, 3, 25)
        xs = mid[0] + ts * nrm[0]
        ys = mid[1] + ts * nrm[1]
        ok = (xs >= 0) & (xs < W - 1) & (ys >= 0) & (ys < H - 1)
        if ok.sum() < 10:
            continue
        x0 = np.floor(xs[ok]).astype(int)
        y0 = np.floor(ys[ok]).astype(int)
        fx = xs[ok] - x0
        fy = ys[ok] - y0
        v = (img[y0, x0] * (1 - fx) * (1 - fy)
             + img[y0, x0 + 1] * fx * (1 - fy)
             + img[y0 + 1, x0] * (1 - fx) * fy
             + img[y0 + 1, x0 + 1] * fx * fy)
        vmin, vmax = v.min(), v.max()
        if vmax - vmin < 10:
            continue
        lo = vmin + 0.1 * (vmax - vmin)
        hi = vmin + 0.9 * (vmax - vmin)
        inside = (v > lo) & (v < hi)
        width = inside.sum() * (ts[1] - ts[0])
        res.append((width, vmin, vmax))
    if not res:
        return (0.0, 0.0, 0.0, 0.0), None
    arr = np.asarray(res)
    return ((float(arr[:, 0].mean()), float(arr[:, 1].mean()),
             float(arr[:, 2].mean()), 0.0),
            arr.astype(np.float32))
