"""IntelligentScissorsMB (imgproc/src/intelligent_scissors.cpp); twin of
``opencv_tpu/ops/scissors.py``: live-wire 2-D DP graph search
(Mortensen-Barrett).

``applyImage`` computes the features on the image's device: gray, the two
f32 3×3 Sobels, the Laplacian zero crossings (or Canny), the unit gradient
direction and the inverted normalised magnitude.  ``np.hypot`` of two f32
Sobel values of a u8 image is the correctly rounded root (all 4.2 M pairs
of the 3×3 Sobel's range; the tests check them), which the card's f64
``sqrt`` rounded to f32 gives but torch's CPU ``sqrt`` does not always (it
is not correctly rounded, and not the same from one call to the next), so
the magnitudes are numpy's own, gathered from a table of the pairs; the
Sobels of any other depth are not integers, and their hypot is taken by
numpy on the host.  Each f32 quotient and product is taken in f64 and
rounded once, which is the f32 operation's result on any device.  The
feature maps come to the host in one read; ``buildMap`` (a Dijkstra with f32
costs whose ties the reference orders) and ``getContour`` are the JAX
package's host Python, copied."""

from __future__ import annotations

import functools
import heapq

import numpy as np
import torch

from .. import constants as K
from ..core.arrays import as_tensor, to_device
from .linalg import _host

__all__ = ["IntelligentScissorsMB"]

_NEIGHBORS = [(-1, -1), (0, -1), (1, -1), (-1, 0), (1, 0),
              (-1, 1), (0, 1), (1, 1)]
_ENCODE = [8, 7, 6, 5, 4, 3, 2, 1]
_ACOS_N = 64
_ACOS_TABLE = np.array(
    [np.arccos(np.clip(i / _ACOS_N, -1, 1)) / np.pi
     for i in range(-_ACOS_N, _ACOS_N + 1)], np.float32)
_SQRT2_INV = 0.7071067811865475
# the largest |value| of a 3×3 Sobel of a u8 image: 4 * 255
_SOBEL3_MAX = 1020


@functools.lru_cache(maxsize=4)
def _hypot_table(device) -> torch.Tensor:
    """numpy's f32 ``hypot(a, b)`` for 0 <= a, b <= 1020, flat at a * 1021 +
    b, on `device` (4.2 MB, built once per device)."""
    v = np.arange(_SOBEL3_MAX + 1, dtype=np.float32)
    return to_device(np.hypot(v[:, None], v[None, :]).reshape(-1), device)


def _hypot(Ix: torch.Tensor, Iy: torch.Tensor, integral: bool) -> torch.Tensor:
    """``np.hypot`` of two f32 maps on their device: gathered from the table
    where the values are a u8 image's Sobels (`integral`), else numpy's on
    the host."""
    if not integral:
        return to_device(np.hypot(Ix.cpu().numpy(), Iy.cpu().numpy()), Ix.device)
    a, b = Ix.abs().to(torch.int64), Iy.abs().to(torch.int64)
    return _hypot_table(Ix.device)[a * (_SOBEL3_MAX + 1) + b]


class IntelligentScissorsMB:
    def __init__(self):
        self._w_non_edge = 0.43
        self._w_dir = 0.43
        self._w_mag = 0.14
        self._edge_mode = "zero_crossing"
        self._zc_min_mag = 0.0
        self._canny = (10.0, 100.0, 3, False)
        self._mag_max = 0.0
        self._non_edge = None
        self._grad_dir = None
        self._grad_mag = None
        self._w_non_edge_compute = 0.0
        self._paths = None
        self._size = None

    # -- parameters ---------------------------------------------------
    def setWeights(self, weight_non_edge, weight_gradient_direction,
                   weight_gradient_magnitude):
        self._w_non_edge = float(weight_non_edge)
        self._w_dir = float(weight_gradient_direction)
        self._w_mag = float(weight_gradient_magnitude)
        return self

    def setGradientMagnitudeMaxLimit(self, v):
        self._mag_max = float(v)
        return self

    def setEdgeFeatureZeroCrossingParameters(self, v=0.0):
        self._edge_mode = "zero_crossing"
        self._zc_min_mag = float(v)
        return self

    def setEdgeFeatureCannyParameters(self, threshold1, threshold2,
                                      apertureSize: int = 3,
                                      L2gradient: bool = False):
        self._edge_mode = "canny"
        self._canny = (float(threshold1), float(threshold2),
                       int(apertureSize), bool(L2gradient))
        return self

    # -- features -----------------------------------------------------
    def _gray(self, image) -> torch.Tensor:
        """The (H, W) u8 gray image on the image's device."""
        from .color import cvtColor
        a = as_tensor(image)
        if a.ndim == 3:
            code = K.COLOR_BGR2GRAY if a.shape[2] == 3 else K.COLOR_BGRA2GRAY
            a = cvtColor(a, code)
        return a

    def _derives(self, image):
        """Ix, Iy and np.hypot(Ix, Iy), (H, W) f32 on the image's device."""
        from .deriv import Sobel
        g = self._gray(image)
        Ix = Sobel(g, K.CV_32F, 1, 0, ksize=3)
        Iy = Sobel(g, K.CV_32F, 0, 1, ksize=3)
        return Ix, Iy, _hypot(Ix, Iy, g.dtype == torch.uint8)

    def _zero_crossings(self, image, H: int, W: int) -> torch.Tensor:
        """The Laplacian zero-crossing feature, (H, W) u8 (0 on a
        crossing): of each pair of 4-forward neighbours of opposite sign,
        the one of the smaller |value| (intelligent_scissors.cpp:355)."""
        from .deriv import Laplacian
        lap = Laplacian(self._gray(image), K.CV_16S, ksize=3).to(torch.int32)
        zero = torch.zeros((H, W), dtype=torch.bool, device=lap.device)
        for dy, dx in ((0, 1), (1, -1), (1, 0), (1, 1)):
            off = 1 if dx == -1 else 0
            v = lap[:H - 1, off:W - 1 + off]
            nb = lap[dy:H - 1 + dy, off + dx:W - 1 + off + dx]
            opp = (v < 0) & (nb > 0) | (v > 0) & (nb < 0)
            closer_nb = nb.abs() < v.abs()
            zero[:H - 1, off:W - 1 + off] |= opp & ~closer_nb
            zero[dy:H - 1 + dy, off + dx:W - 1 + off + dx] |= opp & closer_nb
        return (~zero).to(torch.uint8)

    def applyImage(self, image):
        Ix, Iy, mag = self._derives(image)
        H, W = mag.shape
        self._size = (H, W)
        f64, f32 = torch.float64, torch.float32
        # non-edge feature
        if self._edge_mode == "canny":
            from .canny import Canny
            t1, t2, ap, l2 = self._canny
            edges = Canny(self._gray(image), t1, t2, apertureSize=ap, L2gradient=l2)
            non_edge = 255 - edges
            self._w_non_edge_compute = self._w_non_edge / 255.0
        else:
            non_edge = self._zero_crossings(image, H, W)
            if self._zc_min_mag > 0:
                non_edge = torch.where(mag < np.float32(self._zc_min_mag), 1, non_edge)
            self._w_non_edge_compute = self._w_non_edge
        # gradient direction (unit vectors), each f32 op rounded once
        m64 = mag.to(f64)
        inv = torch.where(mag > np.finfo(np.float32).eps,
                          (torch.ones_like(m64) / m64).to(f32), 0.0).to(f64)
        grad_dir = torch.stack([(Ix.to(f64) * inv).to(f32), (Iy.to(f64) * inv).to(f32)], -1)
        # inverted normalized magnitude
        if self._mag_max > 0:
            mm = torch.full((), np.float32(self._mag_max), dtype=f32, device=mag.device)
            m = torch.minimum(mag, mm)
        else:
            m = mag
            mm = mag.max()
        q = (m.to(f64) / mm.to(f64)).to(f32)
        grad_mag = torch.where(mm <= np.finfo(np.float32).eps, 0.0,
                               (1.0 - q.to(f64)).to(f32))
        # the three maps to the host in one read
        host = torch.cat([non_edge.to(f32)[..., None], grad_dir, grad_mag[..., None]],
                         -1).cpu().numpy()
        self._non_edge = host[..., 0].astype(np.uint8)
        self._grad_dir = np.ascontiguousarray(host[..., 1:3])
        self._grad_mag = np.ascontiguousarray(host[..., 3])
        self._paths = None

    def applyImageFeatures(self, non_edge, gradient_direction,
                           gradient_magnitude, image=None):
        ref = (non_edge if non_edge is not None else
               gradient_magnitude)
        H, W = _host(ref).shape[:2]
        self._size = (H, W)
        self._non_edge = (_host(non_edge).astype(np.uint8)
                          if non_edge is not None
                          else np.zeros((H, W), np.uint8))
        self._w_non_edge_compute = self._w_non_edge
        self._grad_dir = (_host(gradient_direction).astype(np.float32)
                          if gradient_direction is not None
                          else np.zeros((H, W, 2), np.float32))
        self._grad_mag = (_host(gradient_magnitude).astype(np.float32)
                          if gradient_magnitude is not None
                          else np.zeros((H, W), np.float32))
        self._paths = None

    # -- graph search -------------------------------------------------
    def buildMap(self, sourcePt):
        if self._grad_mag is None:
            raise RuntimeError("applyImage() must be called first")
        H, W = self._size
        sx, sy = (int(v) for v in _host(sourcePt).reshape(-1)[:2])
        paths = np.zeros((H, W), np.uint8)
        # float32 like the reference, and the heap carries the same
        # float32 values — mixed precision here can invert tie
        # comparisons on zero-cost edge chains and corrupt the path map
        cost_map = np.full((H, W), np.inf, np.float32)
        processed = np.zeros((H, W), bool)
        cost_map[sy, sx] = 0.0
        heap = [(0.0, sx, sy)]
        ne = self._non_edge
        gd = self._grad_dir
        gm = self._grad_mag
        wne = self._w_non_edge_compute
        wd = self._w_dir
        wm = self._w_mag
        at = _ACOS_TABLE
        while heap:
            cq, qx, qy = heapq.heappop(heap)
            if processed[qy, qx]:
                continue
            processed[qy, qx] = True
            for n, (dx, dy) in enumerate(_NEIGHBORS):
                rx, ry = qx + dx, qy + dy
                if not (0 <= rx < W and 0 <= ry < H):
                    continue
                cr = cost_map[ry, rx]
                if cr < cq:
                    continue
                cost = cq + wne * ne[ry, rx]
                if cost < cr:
                    diag = dx != 0 and dy != 0
                    fG = gm[ry, rx]
                    if not diag:
                        fG *= _SQRT2_INV
                    cost += wm * fG
                    if cost < cr:
                        ipx, ipy = gd[qy, qx]
                        iqx, iqy = gd[ry, rx]
                        dp = ipy * dx - ipx * dy
                        dq = iqy * dx - iqx * dy
                        if dp < 0:
                            dp, dq = -dp, -dq
                        if diag:
                            dp *= _SQRT2_INV
                            dq *= _SQRT2_INV
                        dpi = min(_ACOS_N, max(0, int(np.floor(
                            dp * _ACOS_N))))
                        dqi = min(_ACOS_N, max(-_ACOS_N, int(np.floor(
                            dq * _ACOS_N))))
                        fD = at[dpi + _ACOS_N] + at[dqi + _ACOS_N]
                        cost += wd * fD
                cost = np.float32(cost)
                if cost < cr:
                    cost_map[ry, rx] = cost
                    heapq.heappush(heap, (float(cost), rx, ry))
                    paths[ry, rx] = _ENCODE[n]
        self._paths = paths

    def getContour(self, targetPt, backward: bool = False):
        if self._paths is None:
            raise RuntimeError("buildMap() must be called first")
        H, W = self._size
        x, y = (int(v) for v in _host(targetPt).reshape(-1)[:2])
        out = []
        for _ in range(H * W):
            out.append((x, y))
            d = int(self._paths[y, x])
            if d == 0:
                break
            dx, dy = _NEIGHBORS[d - 1]
            x, y = x + dx, y + dy
        pts = np.asarray(out, np.int32)
        if not backward:
            pts = pts[::-1]
        return pts.reshape(-1, 2)
