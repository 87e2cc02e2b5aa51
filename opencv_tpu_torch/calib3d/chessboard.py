"""Chessboard corner detection (calib3d/src/calibinit.cpp) and
cornerSubPix (imgproc/src/cornersubpix.cpp), twin of
``opencv_tpu/calib3d/chessboard.py``.

The reference's detector is a long sequential quad-assembly pipeline;
this one keeps its structure — adaptive binarization, quad extraction,
shared-corner clustering, homography-based grid ordering.  The dense
stages (cvtColor, adaptiveThreshold, erode) run on the image's device and
each result the host needs is read back once: the gray image (for
cornerSubPix) and each attempt's eroded binary map (for the contours, the
port's native border following).  The quads, their clustering and the
grid are the JAX package's numpy, and cornerSubPix is the classic gradient
structure-tensor iteration, solved per corner on host f64.

findChessboardCornersSB's corner likelihood is torch float32 on the
device: one ``rfft2`` of the image and one spectrum product per kernel of
the bank.  The JAX package's jitted likelihood takes XLA's FFT, whose
rounding differs from torch's (pocketfft on the CPU, cuFFT on the card):
the maps agree within a few float32 ulps of their range, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as K
from ..core.arrays import as_tensor, to_host
from ..ops.thresh import adaptiveThreshold, threshold
from ..ops.morph import erode, getStructuringElement
from ..ops.contours import findContours, contourArea
from ..ops.color import cvtColor
from .geometry import findHomography

__all__ = ["findChessboardCorners", "drawChessboardCorners",
           "cornerSubPix", "CALIB_CB_ADAPTIVE_THRESH",
           "CALIB_CB_NORMALIZE_IMAGE", "CALIB_CB_FAST_CHECK"]

CALIB_CB_ADAPTIVE_THRESH = 1
CALIB_CB_NORMALIZE_IMAGE = 2
CALIB_CB_FILTER_QUADS = 4
CALIB_CB_FAST_CHECK = 8


def cornerSubPix(image, corners, winSize, zeroZone, criteria):
    """Iterative sub-pixel refinement: solve sum(G_i) q = sum(G_i p_i)
    with G = grad grad^T over the window (cornersubpix.cpp:40)."""
    x = as_tensor(image)
    if x.ndim == 3:
        x = cvtColor(x, K.COLOR_BGR2GRAY)
    img = to_host(x).astype(np.float64)
    H, W = img.shape
    wx, wy = winSize
    maxiter = int(criteria[1]) if len(criteria) > 1 else 30
    eps = float(criteria[2]) if len(criteria) > 2 else 1e-2

    # Gaussian-like weighting mask (the reference uses exp(-(r/w)^2))
    gx = np.arange(-wx, wx + 1) / wx
    gy = np.arange(-wy, wy + 1) / wy
    wmask = np.exp(-2.0 * (gx[None, :] ** 2 + gy[:, None] ** 2))
    if zeroZone is not None and zeroZone[0] >= 0:
        zx, zy = zeroZone
        wmask[wy - zy:wy + zy + 1, wx - zx:wx + zx + 1] = 0

    shape = tuple(corners.shape) if isinstance(corners, torch.Tensor) else np.shape(corners)
    pts = to_host(corners).astype(np.float64).reshape(-1, 2)
    out = pts.copy()
    for idx, (cx, cy) in enumerate(pts):
        q = np.array([cx, cy])
        for _ in range(maxiter):
            ix, iy = q
            x0, y0 = int(round(ix)), int(round(iy))
            if not (wx + 1 <= x0 < W - wx - 1 and wy + 1 <= y0 < H - wy - 1):
                break
            sub = img[y0 - wy - 1:y0 + wy + 2, x0 - wx - 1:x0 + wx + 2]
            dx = (sub[1:-1, 2:] - sub[1:-1, :-2]) * 0.5
            dy = (sub[2:, 1:-1] - sub[:-2, 1:-1]) * 0.5
            gxx = np.sum(wmask * dx * dx)
            gxy = np.sum(wmask * dx * dy)
            gyy = np.sum(wmask * dy * dy)
            xs = x0 + np.arange(-wx, wx + 1)[None, :] * 1.0
            ys = y0 + np.arange(-wy, wy + 1)[:, None] * 1.0
            bx = np.sum(wmask * (dx * dx * xs + dx * dy * ys))
            by = np.sum(wmask * (dx * dy * xs + dy * dy * ys))
            det = gxx * gyy - gxy * gxy
            if abs(det) < 1e-12:
                break
            qn = np.array([(gyy * bx - gxy * by) / det,
                           (gxx * by - gxy * bx) / det])
            shift = np.linalg.norm(qn - q)
            q = qn
            if shift < eps:
                break
        out[idx] = q
    return out.reshape(shape).astype(np.float32)


def _extract_quads(binary, min_area):
    """Square-ish contours via minAreaRect rectangularity (more robust
    to ragged adaptive-threshold edges than polygon approximation)."""
    from ..ops.contours import minAreaRect, boxPoints
    contours, _ = findContours(binary, K.RETR_LIST, K.CHAIN_APPROX_SIMPLE)
    quads = []
    for c in contours:
        pts = np.asarray(c).reshape(-1, 2)
        if len(pts) < 4:
            continue
        area = abs(contourArea(pts.astype(np.float32)))
        if area < min_area:
            continue
        rect = minAreaRect(pts.astype(np.float32))
        (w, h) = rect[1]
        if w <= 0 or h <= 0:
            continue
        rect_area = w * h
        if not (0.65 * rect_area <= area <= 1.1 * rect_area):
            continue
        if max(w, h) > 4.0 * min(w, h):
            continue
        quads.append(np.asarray(boxPoints(rect), np.float64))
    return quads


def findChessboardCorners(image, patternSize, corners=None, flags=1 | 2):
    """cv2.findChessboardCorners (calibinit.cpp:512): returns
    (found, corners (N,1,2) f32 row-major)."""
    cols, rows = patternSize          # inner corners per row / column
    x = as_tensor(image)
    if x.ndim == 3:
        x = cvtColor(x, K.COLOR_BGR2GRAY)
    img = to_host(x)                  # the gray image, read back once

    found_pts = None
    for attempt in range(3):
        if flags & CALIB_CB_ADAPTIVE_THRESH:
            block = max(11, (min(img.shape) // 8) | 1) + 10 * attempt
            binary = adaptiveThreshold(
                x, 255, K.ADAPTIVE_THRESH_MEAN_C, K.THRESH_BINARY,
                block | 1, 0)
        else:
            _, binary = threshold(x, 127, 255, K.THRESH_BINARY)
        # invert (black squares -> white) THEN erode to disconnect
        # diagonally-touching squares
        se = getStructuringElement(K.MORPH_RECT, (3, 3))
        inv0 = 255 - binary
        inv = to_host(erode(inv0, se, iterations=1 + attempt))

        min_area = (img.shape[0] * img.shape[1]) / (
            (cols + 3) * (rows + 3) * 20)
        quads = _extract_quads(inv, min_area)
        if len(quads) < (cols + 1) * (rows + 1) // 4:
            continue

        # cluster quad corners: inner chessboard corners are where two
        # black quads (diagonal neighbors) nearly touch
        allc = np.concatenate(quads)           # (4*nq, 2)
        used = np.zeros(len(allc), bool)
        centers = []
        # pair threshold from median quad edge length
        es = [np.linalg.norm(q[i] - q[(i + 1) % 4])
              for q in quads for i in range(4)]
        thr = np.median(es) * 0.6 + 2.0 * (attempt + 1)
        for i in range(len(allc)):
            if used[i]:
                continue
            d = np.linalg.norm(allc - allc[i], axis=1)
            near = np.nonzero((d < thr) & ~used)[0]
            if len(near) >= 2:
                centers.append(allc[near].mean(axis=0))
                used[near] = True
        centers = np.array(centers)
        if len(centers) < cols * rows:
            continue

        grid = _order_grid(centers, cols, rows)
        if grid is not None:
            found_pts = grid
            break

    if found_pts is None:
        return False, None

    refined = cornerSubPix(img, found_pts.astype(np.float32), (5, 5),
                           (-1, -1), (3, 30, 0.01))
    return True, refined.reshape(-1, 1, 2)


def _order_grid(pts, cols, rows):
    """Order candidate corners row-major via an iterated unit-grid
    homography fit seeded from the hull extremes."""
    if len(pts) < cols * rows:
        return None
    c = pts.mean(axis=0)
    d = pts - c
    # 4 extreme corners by rotated-quadrant max distance
    ang = np.arctan2(d[:, 1], d[:, 0])
    r = np.linalg.norm(d, axis=1)
    extremes = []
    for a0 in (-3 * np.pi / 4, -np.pi / 4, np.pi / 4, 3 * np.pi / 4):
        m = np.abs(np.angle(np.exp(1j * (ang - a0)))) < np.pi / 4
        if not m.any():
            return None
        extremes.append(pts[m][np.argmax(r[m])])
    tl, tr, br, bl = extremes
    unit = np.array([[0, 0], [cols - 1, 0], [cols - 1, rows - 1],
                     [0, rows - 1]], np.float64)
    H, _ = findHomography(unit, np.array([tl, tr, br, bl]), 0)
    if H is None:
        return None

    grid = np.zeros((rows, cols, 2))
    taken = np.zeros(len(pts), bool)
    uv = np.stack(np.meshgrid(np.arange(cols), np.arange(rows)), -1
                  ).reshape(-1, 2).astype(np.float64)
    proj = np.concatenate([uv, np.ones((len(uv), 1))], axis=1) @ H.T
    proj = proj[:, :2] / proj[:, 2:3]
    for k, (u, v) in enumerate(uv.astype(int)):
        dists = np.linalg.norm(pts - proj[k], axis=1)
        dists[taken] = np.inf
        j = np.argmin(dists)
        if not np.isfinite(dists[j]):
            return None
        grid[v, u] = pts[j]
        taken[j] = True
    # sanity: grid rows should be monotonic along the row direction
    spacing = np.linalg.norm(grid[0, 1] - grid[0, 0])
    errs = np.linalg.norm(grid.reshape(-1, 2) - proj, axis=1)
    if np.median(errs) > spacing:
        return None
    return grid.reshape(-1, 2)


def drawChessboardCorners(image, patternSize, corners, patternWasFound):
    """Draws on `image` in place (an array, or a tensor on any device) and
    returns it."""
    from ..ops.drawing import circle, line
    img = image if isinstance(image, torch.Tensor) else np.asarray(image)
    if corners is None:
        return img
    pts = to_host(corners).reshape(-1, 2)
    colors = [(0, 0, 255), (0, 255, 0), (255, 0, 0), (0, 255, 255)]
    for i, p in enumerate(pts):
        col = colors[i % 4] if patternWasFound else (0, 0, 255)
        circle(img, (int(round(p[0])), int(round(p[1]))), 4, col, 1)
        if patternWasFound and i + 1 < len(pts):
            q = pts[i + 1]
            line(img, (int(round(p[0])), int(round(p[1]))),
                 (int(round(q[0])), int(round(q[1]))), col, 1)
    return img


# --------------------------------------------------------------------------
# findChessboardCornersSB (calib3d/src/chessboard.cpp)
# --------------------------------------------------------------------------

CALIB_CB_EXHAUSTIVE = 16
CALIB_CB_ACCURACY = 32
CALIB_CB_LARGER = 64
CALIB_CB_MARKER = 128

__all__ += ["findChessboardCornersSB", "CALIB_CB_EXHAUSTIVE",
            "CALIB_CB_ACCURACY", "CALIB_CB_LARGER", "CALIB_CB_MARKER"]


def _corner_prototypes(radius):
    """Checkerboard-corner correlation patches: four quadrant-masked
    Gaussian kernels for the axis-aligned and the 45-degree corner
    orientations (the box-filter corner score of chessboard.cpp:
    same saddle template expressed as explicit kernels)."""
    r = radius
    u, v = np.meshgrid(np.arange(-r, r + 1), np.arange(-r, r + 1))
    dist = np.hypot(u, v)
    g = np.exp(-dist ** 2 / (2 * (r / 2.0) ** 2))
    protos = []
    for a1, a2 in ((0.0, np.pi / 2), (np.pi / 4, 3 * np.pi / 4)):
        n1 = np.array([np.cos(a1), np.sin(a1)])
        n2 = np.array([np.cos(a2), np.sin(a2)])
        s1 = u * n1[0] + v * n1[1]
        s2 = u * n2[0] + v * n2[1]
        A = g * ((s1 <= -0.1) & (s2 <= -0.1))
        B = g * ((s1 >= 0.1) & (s2 >= 0.1))
        C = g * ((s1 <= -0.1) & (s2 >= 0.1))
        D = g * ((s1 >= 0.1) & (s2 <= -0.1))
        ker = []
        for k in (A, B, C, D):
            ssum = k.sum()
            ker.append((k / ssum if ssum > 0 else k).astype(np.float32))
        protos.append(ker)
    return protos


def _corner_likelihood(gray_f: torch.Tensor) -> torch.Tensor:
    """Corner response map of the (H, W) float32 image, on its device: max
    over prototype orientations and radii of the min-based saddle score
    (Geiger-style; the role of the reference per-pixel corner energy in
    chessboard.cpp).  The whole 24-kernel bank runs in the Fourier domain:
    one rfft2 of the image, one spectrum multiply per kernel."""
    radii = (4, 6, 8)
    rmax = max(radii)
    banks = []
    for radius in radii:
        for kers in _corner_prototypes(radius):
            for k in kers:
                pad = rmax - radius
                banks.append(np.pad(k, pad))
    W = np.stack(banks)                     # (24, 17, 17)

    H, Wd = gray_f.shape
    dev = gray_f.device
    FH, FW = H + 2 * rmax, Wd + 2 * rmax
    # kernel spectra, flipped for correlation, centered at origin: host
    # numpy (float64 FFT, cast to complex64) as in the JAX package
    kpad = np.zeros((len(banks), FH, FW), np.float32)
    ksz = 2 * rmax + 1
    kpad[:, :ksz, :ksz] = W[:, ::-1, ::-1]
    kf = torch.from_numpy(np.fft.rfft2(kpad).astype(np.complex64)).to(dev)

    ri = torch.arange(-rmax, H + rmax, device=dev).clamp(0, H - 1)
    ci = torch.arange(-rmax, Wd + rmax, device=dev).clamp(0, Wd - 1)
    ip = gray_f[ri][:, ci]
    sf = torch.fft.rfft2(ip)
    o = torch.fft.irfft2(sf[None] * kf, s=(FH, FW))
    # valid region: correlation centered — offset 2*rmax
    o = o[:, 2 * rmax:2 * rmax + H, 2 * rmax:2 * rmax + Wd]
    resp = torch.zeros_like(gray_f)
    for g in range(len(banks) // 4):
        A, B, C, D = (o[4 * g + i] for i in range(4))
        mu = 0.25 * (A + B + C + D)
        s1 = torch.minimum(torch.minimum(A, B) - mu, mu - torch.minimum(C, D))
        s2 = torch.minimum(mu - torch.minimum(A, B), torch.minimum(C, D) - mu)
        resp = torch.maximum(resp, torch.maximum(s1, s2))
    return resp


def findChessboardCornersSB(image, patternSize, flags=0):
    """cv2.findChessboardCornersSB (chessboard.cpp findChessboardCornersSB):
    corner-likelihood filter bank + NMS + subpixel saddle refinement +
    homography-seeded grid assembly.  CALIB_CB_MARKER's marker-based
    origin disambiguation is not implemented (the plain row-major order
    is returned); CALIB_CB_LARGER returns only the requested grid."""
    cols, rows = patternSize
    x = as_tensor(image)
    if x.ndim == 3:
        x = cvtColor(x, K.COLOR_BGR2GRAY)
    img = to_host(x)                  # the gray image, read back once
    # a division by a 0-dim device tensor, not by a host scalar (which the
    # card takes as a product with the reciprocal)
    gray = x.to(torch.float32) / torch.tensor(255.0, device=x.device)
    Himg, Wimg = gray.shape

    resp_d = _corner_likelihood(gray)
    # non-maximum suppression: window max + greedy radius suppression
    # (plateaued responses produce ties the window max alone keeps)
    from ..ops.morph import dilate as _dil
    nms_r = 5
    se = np.ones((2 * nms_r + 1, 2 * nms_r + 1), np.uint8)
    mx = to_host(_dil(resp_d, se))
    resp = to_host(resp_d)
    thr = 0.04 if not (flags & CALIB_CB_EXHAUSTIVE) else 0.02
    cand = np.argwhere((resp >= mx - 1e-9) & (resp > thr))
    if len(cand) < cols * rows:
        return False, None
    scores = resp[cand[:, 0], cand[:, 1]]
    order = np.argsort(-scores)
    cand = cand[order][:, ::-1].astype(np.float64)   # (x, y)
    scores = scores[order]
    keep_idx = []
    taken = np.zeros(len(cand), bool)
    for i in range(len(cand)):
        if taken[i]:
            continue
        keep_idx.append(i)
        d = np.linalg.norm(cand - cand[i], axis=1)
        taken |= d <= nms_r + 1
    cand = cand[keep_idx]
    scores = scores[keep_idx]

    # drop border-adjacent candidates (cannot refine)
    keep = (cand[:, 0] > 6) & (cand[:, 0] < Wimg - 7) \
        & (cand[:, 1] > 6) & (cand[:, 1] < Himg - 7)
    cand = cand[keep]
    scores = scores[keep]
    if len(cand) < cols * rows:
        return False, None

    # subpixel saddle refinement
    refined = cornerSubPix(img, cand.astype(np.float32), (5, 5),
                           (-1, -1), (3, 30, 0.01)).reshape(-1, 2)

    # grid assembly: try with the strongest k candidates, growing k
    need = cols * rows
    tried = set()
    for kN in (need, int(need * 1.15) + 2, int(need * 1.4) + 4,
               len(refined)):
        kN = min(kN, len(refined))
        if kN in tried:
            continue
        tried.add(kN)
        grid = _order_grid(refined[:kN], cols, rows)
        if grid is None and cols != rows:
            gridT = _order_grid(refined[:kN], rows, cols)
            if gridT is not None:
                grid = gridT.reshape(rows, cols, 2)[::-1].transpose(
                    1, 0, 2).reshape(-1, 2)
        if grid is not None and not _sb_grid_regular(
                grid.reshape(rows, cols, 2)):
            grid = None
        if grid is not None:
            grid = _normalize_sb_orientation(
                grid.reshape(rows, cols, 2), img).reshape(-1, 2)
            out = grid.astype(np.float32)
            if flags & CALIB_CB_ACCURACY:
                out = cornerSubPix(img, out, (3, 3), (-1, -1),
                                   (3, 50, 1e-3)).reshape(-1, 2)
            return True, out.reshape(-1, 1, 2)
    return False, None


def _sb_grid_regular(g):
    """Projective boards vary smoothly: reject assemblies whose rows or
    columns have large second differences relative to the local edge
    length (the grid-consistency check of chessboard.cpp's grow/verify
    stages)."""
    ex = np.linalg.norm(np.diff(g, axis=1), axis=-1)
    ey = np.linalg.norm(np.diff(g, axis=0), axis=-1)
    med = np.median(np.concatenate([ex.ravel(), ey.ravel()]))
    if med < 3:
        return False
    d2x = np.linalg.norm(np.diff(g, 2, axis=1), axis=-1)
    d2y = np.linalg.norm(np.diff(g, 2, axis=0), axis=-1)
    return max(d2x.max(initial=0), d2y.max(initial=0)) < 0.35 * med


def _normalize_sb_orientation(grid, img):
    """Board orientation normalization (chessboard.cpp:1669
    normalizeOrientation(false)): right-handed corner ordering, then
    rotate so the top-left CELL is white when the cell-grid parity
    allows disambiguation.  Even-by-even cell grids stay as assembled
    (the reference's rule cannot distinguish 180-degree rotations
    there either)."""
    rows, cols = grid.shape[:2]
    x = grid[1, 2] - grid[1, 0]
    y = grid[0, 1] - grid[2, 1]
    if x[0] * y[1] - x[1] * y[0] > 0:
        grid = grid[:, ::-1]

    def cell_white(g):
        # center of the cell up-left of corner (0,0)
        dx = g[0, 1] - g[0, 0]
        dy = g[1, 0] - g[0, 0]
        c = g[0, 0] - 0.5 * (dx + dy)
        H, W = img.shape[:2]
        ix = int(round(min(max(c[0], 0), W - 1)))
        iy = int(round(min(max(c[1], 0), H - 1)))
        return img[iy, ix] >= np.mean(img)

    n_cell_cols = cols + 1
    n_cell_rows = rows + 1
    if not cell_white(grid):
        if n_cell_cols % 2 != 0 and rows == cols:
            grid = np.transpose(grid[:, ::-1], (1, 0, 2))  # rotate 90
        elif n_cell_rows % 2 != 0 or n_cell_cols % 2 != 0:
            grid = grid[::-1, ::-1]
    return grid
