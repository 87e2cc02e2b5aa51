"""Drawing primitives (imgproc/src/drawing.cpp); twin of
``opencv_tpu/ops/drawing.py``.

Rasterising is sequential host work in the reference too, and it stays on
the host here: Bresenham, the LINE_AA coverage, the scanline fill, the
ellipse polygon and the Hershey glyph walk are the JAX package's numpy
(Bresenham in closed form, the same points as its loop).  What differs is
where the pixels go, which :class:`_Canvas` decides:

- a numpy image is drawn in place and returned, by the JAX package's numpy
  expressions (a view or a read-only array is copied first, as there);
- a tensor is drawn in place on its own device.  The host collects the
  coordinates of a primitive's writes, keeps the last write of each pixel,
  and makes them as one ``index_put_``.  A LINE_AA blend reads what is
  under it, so pending writes go first; the blend gathers its pixels,
  computes ``base * (1 - a) + c * a + 0.5`` in float64 one operation at a
  time (no fused multiply-add, so the result is numpy's bit for bit), clips,
  truncates and writes them back in one ``index_put_``.  A blend must name
  each pixel once (an ``index_put_`` with repeated indices is undefined on
  CUDA), which the host checks.

The batched form (``_Canvas(batch, batch=True)`` and a ``frame`` per
primitive) lets a caller draw on many images of an (N, H, W, C) tensor with
one device write per run of plain writes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import constants as K
from ..core.arrays import to_batched, to_device

__all__ = ["line", "rectangle", "circle", "ellipse", "polylines",
           "fillPoly", "fillConvexPoly", "drawContours", "drawMarker",
           "arrowedLine", "drawKeypoints", "drawMatches", "drawMatchesKnn",
           "putText", "getTextSize", "getFontScaleFromHeight", "ellipse2Poly"]


def _as_np(img):
    a = np.asarray(img)
    if a.base is not None or not a.flags.writeable:
        a = np.array(a)
    return a


class _Canvas:
    """The image a primitive draws on (see the module's note).

    ``img`` is what the caller gets back.  For a tensor, ``t`` is its (N, H,
    W, C) view (``batch=True``: the tensor is that batch) and ``frame`` the
    image of it that the next writes go to; ``writes`` counts the device
    writes made."""

    def __init__(self, img, batch: bool = False):
        self.frame = 0
        self.writes = 0
        self._pending = []
        if isinstance(img, torch.Tensor):
            self.img = img
            self.t = img if batch else to_batched(img)[0]
            _, self.H, self.W, self.C = self.t.shape
            self._dtype = torch.empty(0, dtype=img.dtype).numpy().dtype
        else:
            self.img = _as_np(img)
            self.t = None
            self.H, self.W = self.img.shape[:2]
            self.ndim = self.img.ndim
            self.C = 1 if self.ndim == 2 else self.img.shape[2]

    def _value(self, color):
        """The pixel a plain write stores, by numpy's assignment rules."""
        v = np.zeros((1, self.C), self._dtype)
        v[0] = np.asarray(color).reshape(-1)[:self.C]
        return v[0]

    def put(self, y, x, color):
        """Write `color` at the integer points (y, x) that lie inside."""
        m = (y >= 0) & (y < self.H) & (x >= 0) & (x < self.W)
        if self.t is None:
            if self.ndim == 2:
                self.img[y[m], x[m]] = color if np.isscalar(color) else color[0]
            else:
                self.img[y[m], x[m]] = np.asarray(color).reshape(-1)[:self.C]
            return
        flat = (self.frame * self.H + y[m].astype(np.int64)) * self.W + x[m]
        if flat.size:
            self._pending.append((flat, self._value(color)))

    def fill(self, ya: int, yb: int, xa: int, xb: int, color):
        """Write `color` over rows [ya, yb) and columns [xa, xb), inside."""
        if self.t is None:
            if self.ndim == 2:
                self.img[ya:yb, xa:xb] = color if np.isscalar(color) else color[0]
            else:
                self.img[ya:yb, xa:xb] = np.asarray(color).reshape(-1)[:self.C]
            return
        ys, xs = np.mgrid[ya:yb, xa:xb]
        self.put(ys.ravel(), xs.ravel(), color)

    def flush(self):
        """Make the pending writes as one index_put_, the last write of each
        pixel kept."""
        if not self._pending:
            return
        flat = np.concatenate([f for f, _ in self._pending])
        vals = np.concatenate([np.broadcast_to(v, (len(f), self.C)) for f, v in self._pending])
        self._pending = []
        _, first = np.unique(flat[::-1], return_index=True)
        keep = len(flat) - 1 - first
        self.t.index_put_(self._indices(flat[keep]),
                          to_device(np.ascontiguousarray(vals[keep]), self.t.device))
        self.writes += 1

    def _indices(self, flat):
        """The (n, y, x) index tensors of flat pixel indices, on the image's
        device."""
        n, rest = np.divmod(flat, self.H * self.W)
        y, x = np.divmod(rest, self.W)
        dev = self.t.device
        return tuple(to_device(np.ascontiguousarray(v, np.int64), dev) for v in (n, y, x))

    def blend(self, ys, xs, alpha, color):
        """Alpha-composite `color` at integer coords with per-pixel coverage
        (the JAX package's ``_blend``)."""
        H, W = self.H, self.W
        m = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W) & (alpha > 0)
        ys, xs, a = ys[m], xs[m], alpha[m]
        if self.t is None:
            img = self.img
            if img.ndim == 2:
                c = color if np.isscalar(color) else np.asarray(color).reshape(-1)[0]
                base = img[ys, xs].astype(np.float64)
                img[ys, xs] = np.clip(base * (1 - a) + float(c) * a + 0.5, 0,
                                      255).astype(img.dtype)
            else:
                c = np.asarray(color, np.float64).reshape(-1)[:img.shape[2]]
                base = img[ys, xs].astype(np.float64)
                img[ys, xs] = np.clip(base * (1 - a)[:, None] + c[None, :]
                                      * a[:, None] + 0.5, 0, 255).astype(img.dtype)
            return
        if not ys.size:
            return
        flat = (self.frame * H + ys.astype(np.int64)) * W + xs
        if np.unique(flat).size != flat.size:
            raise ValueError("a blend names a pixel twice")
        self.flush()
        dev = self.t.device
        idx = self._indices(flat)
        a_t = to_device(np.ascontiguousarray(a, np.float64), dev)[:, None]
        oma = to_device(np.ascontiguousarray(1 - a, np.float64), dev)[:, None]
        c_t = to_device(np.asarray(color, np.float64).reshape(-1)[:self.C], dev)[None, :]
        base = self.t[idx].to(torch.float64)
        out = base * oma
        out = out + c_t * a_t
        out = (out + 0.5).clamp(0, 255).to(self.t.dtype)
        self.t.index_put_(idx, out)
        self.writes += 1

    def done(self):
        self.flush()
        return self.img


def _line_points(p0, p1):
    """8-connected Bresenham from p0 to p1 inclusive (LineIterator): the JAX
    package's loop in closed form.  Its error term starts at D // 2 (D the
    major delta, d the minor) and stays in [0, D), so after j steps the minor
    coordinate has moved ceil((j * d - D // 2) / D) times."""
    x0, y0 = int(round(p0[0])), int(round(p0[1]))
    x1, y1 = int(round(p1[0])), int(round(p1[1]))
    dx = abs(x1 - x0)
    dy = abs(y1 - y0)
    sx = 1 if x1 >= x0 else -1
    sy = 1 if y1 >= y0 else -1
    D, d = (dx, dy) if dx >= dy else (dy, dx)
    j = np.arange(D + 1, dtype=np.int64)
    k = -((D // 2 - j * d) // D) if D else np.zeros_like(j)
    if dx >= dy:
        return y0 + sy * k, x0 + sx * j
    return y0 + sy * j, x0 + sx * k


def _line_aa(cv, pt1, pt2, color, thickness=1):
    """Antialiased line: Wu-style fractional coverage along the minor
    axis (the role of LineAA in drawing.cpp — the reference uses an
    8-bit filtered profile; endpoints and coverage agree closely)."""
    x0, y0 = float(pt1[0]), float(pt1[1])
    x1, y1 = float(pt2[0]), float(pt2[1])
    dx = x1 - x0
    dy = y1 - y0
    steep = abs(dy) > abs(dx)
    if steep:
        x0, y0, x1, y1 = y0, x0, y1, x1
        dx, dy = dy, dx
    if x1 < x0:
        x0, x1 = x1, x0
        y0, y1 = y1, y0
    grad = dy / dx if dx != 0 else 0.0
    n = int(np.floor(x1) - np.ceil(x0)) + 1
    if n <= 0:
        return
    xs = np.ceil(x0) + np.arange(max(n, 0))
    yc = y0 + (xs - x0) * grad
    # triangular coverage over PERPENDICULAR distance (the reference's
    # LineAA profile integrates to ~1.35 for 1-px lines)
    cos_t = 1.0 / np.hypot(1.0, grad)
    half = max(thickness / 2.0, 0.5) + 0.7
    span = int(np.ceil(half / cos_t)) + 1
    offs = np.arange(-span, span + 1)
    yy = (np.floor(yc)[:, None] + offs[None, :]).astype(int)
    dist = np.abs(yy + 0.0 - yc[:, None]) * cos_t
    alpha = np.clip((half - dist) / 0.7, 0.0, 1.0)
    xx = np.broadcast_to(xs.astype(int)[:, None], yy.shape)
    if steep:
        cv.blend(xx.ravel(), yy.ravel(), alpha.ravel(), color)
    else:
        cv.blend(yy.ravel(), xx.ravel(), alpha.ravel(), color)


def _line(cv, pt1, pt2, color, thickness=1, lineType=K.LINE_8):
    if lineType == K.LINE_AA:
        _line_aa(cv, pt1, pt2, color, thickness)
    elif thickness <= 1:
        ys, xs = _line_points(pt1, pt2)
        cv.put(ys, xs, color)
    else:
        # thick line: stamp a disk of radius thickness/2 along the line
        r = thickness / 2.0
        ys, xs = _line_points(pt1, pt2)
        rr = int(math.ceil(r))
        dy, dx = np.mgrid[-rr:rr + 1, -rr:rr + 1]
        disk = (dy * dy + dx * dx) <= r * r
        ddy, ddx = dy[disk], dx[disk]
        yy = (ys[:, None] + ddy[None, :]).ravel()
        xx = (xs[:, None] + ddx[None, :]).ravel()
        cv.put(yy, xx, color)


def line(img, pt1, pt2, color, thickness: int = 1, lineType: int = K.LINE_8,
         shift: int = 0):
    cv = _Canvas(img)
    _line(cv, pt1, pt2, color, thickness, lineType)
    return cv.done()


def _rectangle(cv, pt1, pt2, color, thickness=1):
    x0, y0 = int(pt1[0]), int(pt1[1])
    x1, y1 = int(pt2[0]), int(pt2[1])
    x0, x1 = min(x0, x1), max(x0, x1)
    y0, y1 = min(y0, y1), max(y0, y1)
    H, W = cv.H, cv.W
    if thickness < 0 or thickness == K.FILLED:
        ya, yb = max(y0, 0), min(y1 + 1, H)
        xa, xb = max(x0, 0), min(x1 + 1, W)
        if ya < yb and xa < xb:
            cv.fill(ya, yb, xa, xb, color)
        return
    for _ in range(thickness):
        # concentric rectangles approximate cv2's thick border
        _line(cv, (x0, y0), (x1, y0), color, 1)
        _line(cv, (x1, y0), (x1, y1), color, 1)
        _line(cv, (x1, y1), (x0, y1), color, 1)
        _line(cv, (x0, y1), (x0, y0), color, 1)
        x0, y0, x1, y1 = x0 - 1, y0 - 1, x1 + 1, y1 + 1


def rectangle(img, pt1, pt2, color, thickness: int = 1,
              lineType: int = K.LINE_8, shift: int = 0):
    cv = _Canvas(img)
    _rectangle(cv, pt1, pt2, color, thickness)
    return cv.done()


def _circle(cv, center, radius, color, thickness=1):
    cx, cy = int(center[0]), int(center[1])
    H, W = cv.H, cv.W
    if thickness < 0 or thickness == K.FILLED:
        ys, xs = np.mgrid[max(cy - radius, 0):min(cy + radius + 1, H),
                          max(cx - radius, 0):min(cx + radius + 1, W)]
        m = (ys - cy) ** 2 + (xs - cx) ** 2 <= radius * radius
        cv.put(ys[m], xs[m], color)
        return
    # midpoint circle (8 octants)
    pts = set()
    x, y, err = radius, 0, 0
    while x >= y:
        for (a, b) in [(x, y), (y, x), (-y, x), (-x, y), (-x, -y), (-y, -x),
                       (y, -x), (x, -y)]:
            pts.add((cy + b, cx + a))
        y += 1
        err += 1 + 2 * y
        if 2 * (err - x) + 1 > 0:
            x -= 1
            err += 1 - 2 * x
    arr = np.asarray(list(pts))
    for _ in range(max(thickness, 1)):
        cv.put(arr[:, 0], arr[:, 1], color)
        if thickness > 1:
            arr = np.concatenate([arr + [0, 1], arr + [1, 0]])


def circle(img, center, radius: int, color, thickness: int = 1,
           lineType: int = K.LINE_8, shift: int = 0):
    cv = _Canvas(img)
    _circle(cv, center, radius, color, thickness)
    return cv.done()


def ellipse(img, center, axes, angle: float, startAngle: float,
            endAngle: float, color, thickness: int = 1,
            lineType: int = K.LINE_8, shift: int = 0):
    cv = _Canvas(img)
    cx, cy = float(center[0]), float(center[1])
    a, b = float(axes[0]), float(axes[1])
    rot = math.radians(angle)
    ca, sa = math.cos(rot), math.sin(rot)
    ts = np.radians(np.arange(int(startAngle), int(endAngle) + 1))
    ex = a * np.cos(ts)
    ey = b * np.sin(ts)
    xs = np.rint(cx + ex * ca - ey * sa).astype(int)
    ys = np.rint(cy + ex * sa + ey * ca).astype(int)
    if thickness < 0:
        _fill_poly(cv, [np.stack([xs, ys], axis=1)], color)
    else:
        for i in range(len(xs) - 1):
            _line(cv, (xs[i], ys[i]), (xs[i + 1], ys[i + 1]), color, max(thickness, 1))
    return cv.done()


def _polylines(cv, pts, isClosed, color, thickness=1):
    for poly in pts:
        p = _host(poly).reshape(-1, 2)
        for i in range(len(p) - 1):
            _line(cv, p[i], p[i + 1], color, thickness)
        if isClosed and len(p) > 2:
            _line(cv, p[-1], p[0], color, thickness)


def polylines(img, pts, isClosed: bool, color, thickness: int = 1,
              lineType: int = K.LINE_8, shift: int = 0):
    cv = _Canvas(img)
    _polylines(cv, pts, isClosed, color, thickness)
    return cv.done()


def _fill_poly(cv, pts, color, offset=(0, 0)):
    """Even-odd scanline fill (drawing.cpp FillEdgeCollection)."""
    H, W = cv.H, cv.W
    for poly in pts:
        p = np.asarray(_host(poly), np.float64).reshape(-1, 2) + np.asarray(offset)
        n = len(p)
        ymin = max(int(np.ceil(p[:, 1].min())), 0)
        ymax = min(int(np.floor(p[:, 1].max())), H - 1)
        for y in range(ymin, ymax + 1):
            xs = []
            for i in range(n):
                x0, y0 = p[i]
                x1, y1 = p[(i + 1) % n]
                if y0 == y1:
                    continue
                if (y >= min(y0, y1)) and (y <= max(y0, y1)):
                    t = (y - y0) / (y1 - y0)
                    if 0 <= t <= 1:
                        xs.append(x0 + t * (x1 - x0))
            xs.sort()
            for i in range(0, len(xs) - 1, 2):
                xa = max(int(np.rint(xs[i])), 0)
                xb = min(int(np.rint(xs[i + 1])), W - 1)
                if xa <= xb:
                    cv.fill(y, y + 1, xa, xb + 1, color)
        # the reference also rasterizes the boundary (Bresenham) when filling
        _polylines(cv, [p.astype(np.int64)], True, color, 1)


def fillPoly(img, pts, color, lineType: int = K.LINE_8, shift: int = 0,
             offset=(0, 0)):
    cv = _Canvas(img)
    _fill_poly(cv, pts, color, offset)
    return cv.done()


def fillConvexPoly(img, points, color, lineType: int = K.LINE_8,
                   shift: int = 0):
    return fillPoly(img, [points], color, lineType, shift)


def _host(a) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def drawContours(img, contours, contourIdx: int, color, thickness: int = 1,
                 lineType: int = K.LINE_8, hierarchy=None, maxLevel=None,
                 offset=(0, 0)):
    cv = _Canvas(img)
    sel = contours if contourIdx < 0 else [contours[contourIdx]]
    if thickness < 0:
        _fill_poly(cv, [_host(c).reshape(-1, 2) for c in sel], color, offset)
    else:
        for c in sel:
            p = _host(c).reshape(-1, 2) + np.asarray(offset)
            _polylines(cv, [p], True, color, thickness)
    return cv.done()


def drawMarker(img, position, color, markerType: int = 0, markerSize: int = 20,
               thickness: int = 1, line_type: int = K.LINE_8):
    cv = _Canvas(img)
    x, y = int(position[0]), int(position[1])
    s = markerSize // 2
    _line(cv, (x - s, y), (x + s, y), color, thickness)
    _line(cv, (x, y - s), (x, y + s), color, thickness)
    return cv.done()


def arrowedLine(img, pt1, pt2, color, thickness: int = 1,
                line_type: int = K.LINE_8, shift: int = 0,
                tipLength: float = 0.1):
    cv = _Canvas(img)
    _line(cv, pt1, pt2, color, thickness)
    dx, dy = pt2[0] - pt1[0], pt2[1] - pt1[1]
    L = math.hypot(dx, dy)
    if L != 0:
        t = tipLength * L
        ang = math.atan2(dy, dx)
        for da in (math.pi * 3 / 4, -math.pi * 3 / 4):
            ex = pt2[0] + t * math.cos(ang + da)
            ey = pt2[1] + t * math.sin(ang + da)
            _line(cv, pt2, (ex, ey), color, thickness)
    return cv.done()


def _bgr_copy(image):
    """A new 3-channel copy of `image` (a gray image's plane thrice), a
    tensor on its device or a numpy array."""
    if isinstance(image, torch.Tensor):
        return torch.stack([image] * 3, dim=-1) if image.ndim == 2 else image.clone()
    img = _as_np(image).copy()
    return np.stack([img] * 3, axis=-1) if img.ndim == 2 else img


def drawKeypoints(image, keypoints, outImage, color=None, flags: int = 0):
    cv = _Canvas(_bgr_copy(image))
    rng = np.random.default_rng(0)
    for k in keypoints:
        c = (color if color is not None and not np.isscalar(color)
             else rng.integers(0, 256, 3).tolist())
        _circle(cv, (int(k.pt[0]), int(k.pt[1])), 3, c, 1)
    return cv.done()


def drawMatches(img1, keypoints1, img2, keypoints2, matches1to2, outImg,
                matchColor=None, singlePointColor=None, matchesMask=None,
                flags: int = 0):
    a = _bgr_copy(img1)
    b = _bgr_copy(img2)
    H = max(a.shape[0], b.shape[0])
    if isinstance(a, torch.Tensor):
        out = torch.zeros((H, a.shape[1] + b.shape[1], 3), dtype=torch.uint8, device=a.device)
    else:
        out = np.zeros((H, a.shape[1] + b.shape[1], 3), np.uint8)
    out[:a.shape[0], :a.shape[1]] = a
    out[:b.shape[0], a.shape[1]:] = b
    cv = _Canvas(out)
    rng = np.random.default_rng(0)
    for i, m in enumerate(matches1to2):
        if matchesMask is not None and not matchesMask[i]:
            continue
        c = (matchColor if matchColor is not None
             else rng.integers(0, 256, 3).tolist())
        p1 = keypoints1[m.queryIdx].pt
        p2 = keypoints2[m.trainIdx].pt
        _line(cv, (int(p1[0]), int(p1[1])),
              (int(p2[0]) + a.shape[1], int(p2[1])), c, 1)
    return cv.done()


def drawMatchesKnn(img1, keypoints1, img2, keypoints2, matches1to2,
                   outImg=None, matchColor=None, singlePointColor=None,
                   matchesMask=None, flags: int = 0):
    """cv::drawMatches knn overload (draw.cpp): draws every match in each
    k-NN bucket, honoring the per-bucket mask rows."""
    flat, flat_mask = [], []
    for i, bucket in enumerate(matches1to2):
        for j, m in enumerate(bucket):
            flat.append(m)
            if matchesMask is not None:
                row = matchesMask[i]
                flat_mask.append(bool(row[j]) if j < len(row) else False)
    return drawMatches(img1, keypoints1, img2, keypoints2, flat, outImg,
                       matchColor, singlePointColor,
                       flat_mask if matchesMask is not None else None,
                       flags)


# ------------------------------------------------------------------ text
# Hershey vector fonts (imgproc/src/drawing.cpp:2287 putText,
# :2355 getTextSize).  The glyph strokes and per-font ascii index tables
# are the public-domain Hershey font data, a byte copy of the JAX
# package's hershey_data.json; each glyph string encodes vertices as
# char-'R' offsets with " R" polyline breaks.

_HERSHEY = None


def _hershey():
    global _HERSHEY
    if _HERSHEY is None:
        import json
        import os
        path = os.path.join(os.path.dirname(__file__), "hershey_data.json")
        with open(path) as f:
            _HERSHEY = json.load(f)
    return _HERSHEY


_FONT_TABLE_NAMES = {
    K.FONT_HERSHEY_SIMPLEX: ("HersheySimplex", "HersheySimplex"),
    K.FONT_HERSHEY_PLAIN: ("HersheyPlain", "HersheyPlainItalic"),
    K.FONT_HERSHEY_DUPLEX: ("HersheyDuplex", "HersheyDuplex"),
    K.FONT_HERSHEY_COMPLEX: ("HersheyComplex", "HersheyComplexItalic"),
    K.FONT_HERSHEY_TRIPLEX: ("HersheyTriplex", "HersheyTriplexItalic"),
    K.FONT_HERSHEY_COMPLEX_SMALL: ("HersheyComplexSmall",
                                   "HersheyComplexSmallItalic"),
    K.FONT_HERSHEY_SCRIPT_SIMPLEX: ("HersheyScriptSimplex",
                                    "HersheyScriptSimplex"),
    K.FONT_HERSHEY_SCRIPT_COMPLEX: ("HersheyScriptComplex",
                                    "HersheyScriptComplex"),
}


def _font_ascii(fontFace):
    italic = bool(fontFace & K.FONT_ITALIC)
    names = _FONT_TABLE_NAMES.get(fontFace & 15)
    if names is None:
        raise ValueError(f"Unknown font type {fontFace}")
    return _hershey()["fonts"][names[1 if italic else 0]]


def _glyph(ascii_table, c):
    if c < ord(' ') or c >= 127:
        c = ord('?')
    return _hershey()["glyphs"][ascii_table[(c - ord(' ')) + 1]]


def _put_text(cv, text, org, fontFace, fontScale, color, thickness=1,
              bottomLeftOrigin=False):
    """Render text with the Hershey vector fonts
    (imgproc/src/drawing.cpp:2287).  Glyph strokes are scaled in float
    and rasterized with the polyline primitive."""
    if not text:
        return
    ascii_table = _font_ascii(fontFace)
    base_line = -(ascii_table[0] & 15)
    hscale = float(fontScale)
    vscale = -hscale if bottomLeftOrigin else hscale

    view_x = float(org[0])
    view_y = float(org[1]) + base_line * vscale

    for ch in text:
        ptr = _glyph(ascii_table, ord(ch))
        px = ord(ptr[0]) - ord('R')
        py = ord(ptr[1]) - ord('R')
        dx = py * hscale
        view_x -= px * hscale
        pts = []
        i = 2
        while True:
            if i >= len(ptr) or ptr[i] == ' ':
                if len(pts) > 1:
                    _polylines(cv, [np.array(pts, np.int32)], False, color, thickness)
                if i >= len(ptr):
                    break
                i += 1
                pts = []
            else:
                gx = ord(ptr[i]) - ord('R')
                gy = ord(ptr[i + 1]) - ord('R')
                i += 2
                pts.append((int(round(gx * hscale + view_x)),
                            int(round(gy * vscale + view_y))))
        view_x += dx


def putText(img, text, org, fontFace, fontScale, color, thickness: int = 1,
            lineType: int = K.LINE_8, bottomLeftOrigin: bool = False):
    cv = _Canvas(img)
    _put_text(cv, text, org, fontFace, fontScale, color, thickness, bottomLeftOrigin)
    return cv.done()


def getTextSize(text, fontFace, fontScale, thickness):
    """Bounding size + baseline (imgproc/src/drawing.cpp:2355)."""
    ascii_table = _font_ascii(fontFace)
    base_line = ascii_table[0] & 15
    cap_line = (ascii_table[0] >> 4) & 15
    height = int(round((cap_line + base_line) * fontScale
                       + (thickness + 1) // 2))
    view_x = 0.0
    for ch in text:
        ptr = _glyph(ascii_table, ord(ch))
        px = ord(ptr[0]) - ord('R')
        py = ord(ptr[1]) - ord('R')
        view_x += (py - px) * fontScale
    width = int(round(view_x + thickness))
    baseline = int(round(base_line * fontScale + thickness * 0.5))
    return (width, height), baseline


def getFontScaleFromHeight(fontFace, pixelHeight, thickness=1):
    ascii_table = _font_ascii(fontFace)
    base_line = ascii_table[0] & 15
    cap_line = (ascii_table[0] >> 4) & 15
    return (pixelHeight - (thickness + 1) / 2.0) / (cap_line + base_line)


# ------------------------------------------------------------ ellipse2Poly

_SIN_TABLE = np.sin(np.deg2rad(np.arange(491))).astype(np.float32)


def ellipse2Poly(center, axes, angle: int, arcStart: int, arcEnd: int,
                 delta: int):
    """`cv::ellipse2Poly` (imgproc/src/drawing.cpp): per-degree float32
    sin-table sampling, cvRound to int points, consecutive duplicates
    removed; degenerate arcs return the center twice."""
    assert 0 < delta <= 180
    angle = int(angle)
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    arc_start, arc_end = int(arcStart), int(arcEnd)
    if arc_start > arc_end:
        arc_start, arc_end = arc_end, arc_start
    while arc_start < 0:
        arc_start += 360
        arc_end += 360
    while arc_end > 360:
        arc_end -= 360
        arc_start -= 360
    if arc_end - arc_start > 360:
        arc_start, arc_end = 0, 360
    alpha = _SIN_TABLE[450 - angle]
    beta = _SIN_TABLE[angle]
    cx, cy = float(center[0]), float(center[1])
    aw, ah = float(axes[0]), float(axes[1])
    pts = []
    prev = None
    i = arc_start
    while i < arc_end + delta:
        a = min(i, arc_end)
        if a < 0:
            a += 360
        x = aw * float(_SIN_TABLE[450 - a])
        y = ah * float(_SIN_TABLE[a])
        px = _cv_round(cx + x * float(alpha) - y * float(beta))
        py = _cv_round(cy + x * float(beta) + y * float(alpha))
        if (px, py) != prev:
            pts.append((px, py))
            prev = (px, py)
        i += delta
    if len(pts) == 1:
        pts = [(int(round(cx)), int(round(cy)))] * 2
    return np.asarray(pts, np.int32)


def _cv_round(v: float) -> int:
    """cvRound: round half to even."""
    f = math.floor(v)
    d = v - f
    if d < 0.5:
        return int(f)
    if d > 0.5:
        return int(f) + 1
    return int(f) + (int(f) & 1)
