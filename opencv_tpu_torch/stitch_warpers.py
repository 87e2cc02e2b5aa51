"""Rotation warpers (modules/stitching/src/warpers.cpp,
include/opencv2/stitching/detail/warpers_inl.hpp), twin of
``opencv_tpu/stitch_warpers.py``.

cv::PyRotationWarper: plane, spherical, cylindrical, fisheye,
stereographic, mercator and transverseMercator projectors.  The
reference's per-pixel mapBackward loops become whole-grid maps computed in
float64 tensors on the device (the H100 has real f64), cast to float32 and
handed to the port's ``remap``.  ``warp`` builds its maps on the source
image's device, ``buildMaps`` on the warper's (``"cuda"`` unless asked);
``warpPoint`` and the corner scans of a small ROI run on the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import constants as K
from .core.arrays import as_tensor
from .ops.warp import remap as _remap

__all__ = ["PyRotationWarper"]

_F64 = torch.float64


class _Projector:
    """Camera-parameter bookkeeping (warpers.cpp:63
    ProjectorBase::setCameraParams); the matrices stay host f64."""

    def __init__(self, scale):
        self.scale = float(scale)

    def set_camera(self, Km, R, T=None):
        Km = np.asarray(Km, np.float32).reshape(3, 3).astype(np.float64)
        R = np.asarray(R, np.float32).reshape(3, 3).astype(np.float64)
        self.k = Km
        self.rinv = R.T
        self.r_kinv = R @ np.linalg.inv(Km)
        self.k_rinv = Km @ R.T
        self.t = (np.zeros(3) if T is None
                  else np.asarray(T, np.float64).reshape(3))

    def _ray(self, x, y):
        M = self.r_kinv
        x_ = M[0, 0] * x + M[0, 1] * y + M[0, 2]
        y_ = M[1, 0] * x + M[1, 1] * y + M[1, 2]
        z_ = M[2, 0] * x + M[2, 1] * y + M[2, 2]
        return x_, y_, z_

    def _unray(self, x_, y_, z_):
        M = self.k_rinv
        x = M[0, 0] * x_ + M[0, 1] * y_ + M[0, 2] * z_
        y = M[1, 0] * x_ + M[1, 1] * y_ + M[1, 2] * z_
        z = M[2, 0] * x_ + M[2, 1] * y_ + M[2, 2] * z_
        good = z > 0
        neg = torch.full_like(x, -1.0)
        return torch.where(good, x / z, neg), torch.where(good, y / z, neg)

    # ROI detection strategy: "full" grid scan, "border", or "corners"
    roi_mode = "full"


def _polar(x_, y_, z_):
    """(atan2(x, z), the elevation's π - acos) of a ray, clipped as the
    reference clips it."""
    w = y_ / torch.sqrt(x_ * x_ + y_ * y_ + z_ * z_)
    return torch.atan2(x_, z_), math.pi - torch.acos(torch.clamp(w, -1, 1))


class _Plane(_Projector):
    roi_mode = "corners"

    def forward(self, x, y):
        x_, y_, z_ = self._ray(x, y)
        t = self.t
        u = self.scale * (t[0] + x_ / z_ * (1 - t[2]))
        v = self.scale * (t[1] + y_ / z_ * (1 - t[2]))
        return u, v

    def backward(self, u, v):
        t = self.t
        u = u / self.scale - t[0]
        v = v / self.scale - t[1]
        return self._unray(u, v, torch.full_like(u, 1 - t[2]))


class _Spherical(_Projector):
    roi_mode = "border"

    def forward(self, x, y):
        x_, y_, z_ = self._ray(x, y)
        u = self.scale * torch.atan2(x_, z_)
        w = y_ / torch.sqrt(x_ * x_ + y_ * y_ + z_ * z_)
        v = self.scale * (math.pi - torch.acos(torch.nan_to_num(torch.clamp(w, -1, 1))))
        return u, v

    def backward(self, u, v):
        u = u / self.scale
        v = v / self.scale
        sinv = torch.sin(math.pi - v)
        return self._unray(sinv * torch.sin(u), torch.cos(math.pi - v), sinv * torch.cos(u))


class _Cylindrical(_Projector):
    roi_mode = "border"

    def forward(self, x, y):
        x_, y_, z_ = self._ray(x, y)
        u = self.scale * torch.atan2(x_, z_)
        v = self.scale * y_ / torch.sqrt(x_ * x_ + z_ * z_)
        return u, v

    def backward(self, u, v):
        u = u / self.scale
        v = v / self.scale
        return self._unray(torch.sin(u), v, torch.cos(u))


class _Fisheye(_Projector):
    def forward(self, x, y):
        u_, v_ = _polar(*self._ray(x, y))
        return self.scale * v_ * torch.cos(u_), self.scale * v_ * torch.sin(u_)

    def backward(self, u, v):
        u = u / self.scale
        v = v / self.scale
        u_ = torch.atan2(v, u)
        v_ = torch.sqrt(u * u + v * v)
        sinv = torch.sin(math.pi - v_)
        return self._unray(sinv * torch.sin(u_), torch.cos(math.pi - v_), sinv * torch.cos(u_))


class _Stereographic(_Projector):
    def forward(self, x, y):
        u_, v_ = _polar(*self._ray(x, y))
        r = torch.sin(v_) / (1 - torch.cos(v_))
        return self.scale * r * torch.cos(u_), self.scale * r * torch.sin(u_)

    def backward(self, u, v):
        u = u / self.scale
        v = v / self.scale
        u_ = torch.atan2(v, u)
        r = torch.sqrt(u * u + v * v)
        v_ = 2 * torch.atan(1.0 / r)
        sinv = torch.sin(math.pi - v_)
        return self._unray(sinv * torch.sin(u_), torch.cos(math.pi - v_), sinv * torch.cos(u_))


class _Mercator(_Projector):
    def forward(self, x, y):
        x_, y_, z_ = self._ray(x, y)
        u_ = torch.atan2(x_, z_)
        v_ = torch.asin(torch.clamp(y_ / torch.sqrt(x_ * x_ + y_ * y_ + z_ * z_), -1, 1))
        return self.scale * u_, self.scale * torch.log(torch.tan(math.pi / 4 + v_ / 2))

    def backward(self, u, v):
        u = u / self.scale
        v = v / self.scale
        v_ = torch.atan(torch.sinh(v))
        cosv = torch.cos(v_)
        return self._unray(cosv * torch.sin(u), torch.sin(v_), cosv * torch.cos(u))


class _TransverseMercator(_Projector):
    def forward(self, x, y):
        x_, y_, z_ = self._ray(x, y)
        u_ = torch.atan2(x_, z_)
        v_ = torch.asin(torch.clamp(y_ / torch.sqrt(x_ * x_ + y_ * y_ + z_ * z_), -1, 1))
        b = torch.cos(v_) * torch.sin(u_)
        u = self.scale * 0.5 * torch.log((1 + b) / (1 - b))
        v = self.scale * torch.atan2(torch.tan(v_), torch.cos(u_))
        return u, v

    def backward(self, u, v):
        u = u / self.scale
        v = v / self.scale
        v_ = torch.asin(torch.clamp(torch.sin(v) / torch.cosh(u), -1, 1))
        u_ = torch.atan2(torch.sinh(u), torch.cos(v))
        cosv = torch.cos(v_)
        return self._unray(cosv * torch.sin(u_), torch.sin(v_), cosv * torch.cos(u_))


_WARPERS = {
    "plane": _Plane,
    "spherical": _Spherical,
    "cylindrical": _Cylindrical,
    "fisheye": _Fisheye,
    "stereographic": _Stereographic,
    "mercator": _Mercator,
    "transverseMercator": _TransverseMercator,
    "affine": _Plane,
}


def _grid(xs, ys, device):
    """The (rows, cols) f64 meshgrid of two host ranges, on `device`."""
    gy, gx = torch.meshgrid(torch.as_tensor(ys, dtype=_F64, device=device),
                            torch.as_tensor(xs, dtype=_F64, device=device), indexing="ij")
    return gx, gy


class PyRotationWarper:
    """cv::PyRotationWarper (stitching/include/opencv2/stitching/
    warpers.hpp).  `device` is where ``buildMaps`` builds its maps
    ("cuda" unless asked)."""

    def __init__(self, warp_type="spherical", scale=1.0, device=None):
        if warp_type not in _WARPERS:
            raise ValueError(f"unknown warper type {warp_type!r}")
        self.proj = _WARPERS[warp_type](scale)
        self.device = torch.device("cuda" if device is None else device)

    def warpPoint(self, pt, Km, R):
        self.proj.set_camera(Km, R)
        u, v = self.proj.forward(*(torch.tensor([float(c)], dtype=_F64) for c in pt[:2]))
        return (float(u[0]), float(v[0]))

    def warpPointBackward(self, pt, Km, R):
        self.proj.set_camera(Km, R)
        x, y = self.proj.backward(*(torch.tensor([float(c)], dtype=_F64) for c in pt[:2]))
        return (float(x[0]), float(y[0]))

    def _detect_roi(self, src_h, src_w, device):
        """The projected ROI's (tl, br) corners, from the image's corners,
        its border or every pixel as the projector asks; the extremes are
        read back once."""
        p = self.proj
        w, h = src_w, src_h
        if p.roi_mode == "corners":
            xs = torch.tensor([0.0, w - 1, 0.0, w - 1], dtype=_F64)
            ys = torch.tensor([0.0, 0.0, h - 1, h - 1], dtype=_F64)
        elif p.roi_mode == "border":
            aw = torch.arange(w, dtype=_F64, device=device)
            ah = torch.arange(h, dtype=_F64, device=device)
            xs = torch.cat([aw, aw, torch.zeros_like(ah), torch.full_like(ah, w - 1.0)])
            ys = torch.cat([torch.zeros_like(aw), torch.full_like(aw, h - 1.0), ah, ah])
        else:
            gx, gy = _grid(np.arange(w), np.arange(h), device)
            xs, ys = gx.reshape(-1), gy.reshape(-1)
        u, v = p.forward(xs, ys)
        ext = torch.stack([u.min(), v.min(), u.max(), v.max()]).tolist()
        tl_u, tl_v, br_u, br_v = ext
        if isinstance(p, _Spherical):
            # pole visibility widens the v range to [0, pi*scale]
            # (warpers.cpp:375 SphericalWarper::detectResultRoi)
            for sgn in (1.0, -1.0):
                x, y, z = p.rinv[0, 1], sgn * p.rinv[1, 1], p.rinv[2, 1]
                if y > 0:
                    x_ = (p.k[0, 0] * x + p.k[0, 1] * y) / z + p.k[0, 2]
                    y_ = p.k[1, 1] * y / z + p.k[1, 2]
                    if 0 < x_ < w and 0 < y_ < h:
                        vv = np.pi * p.scale if sgn > 0 else 0.0
                        tl_u = min(tl_u, 0.0)
                        tl_v = min(tl_v, vv)
                        br_u = max(br_u, 0.0)
                        br_v = max(br_v, vv)
        return (int(tl_u), int(tl_v)), (int(br_u), int(br_v))

    def _maps(self, src_size, Km, R, device):
        self.proj.set_camera(Km, R)
        w, h = src_size
        (tlx, tly), (brx, bry) = self._detect_roi(h, w, device)
        us, vs = _grid(np.arange(tlx, brx + 1), np.arange(tly, bry + 1), device)
        x, y = self.proj.backward(us, vs)
        # cv2's buildMaps ROI is Rect(tl, br): width excludes br
        return ((tlx, tly, brx - tlx, bry - tly), x.to(torch.float32), y.to(torch.float32))

    def buildMaps(self, src_size, Km, R):
        """Returns (roi, xmap, ymap); roi = (x, y, w, h), the maps float32
        tensors on the warper's device."""
        return self._maps(src_size, Km, R, self.device)

    def warp(self, src, Km, R, interp_mode=K.INTER_LINEAR, border_mode=K.BORDER_CONSTANT):
        src = as_tensor(src)
        h, w = src.shape[:2]
        roi, xmap, ymap = self._maps((w, h), Km, R, src.device)
        return (roi[0], roi[1]), _remap(src, xmap, ymap, interp_mode, borderMode=border_mode)

    def warpBackward(self, src, Km, R, interp_mode, border_mode, dst_size):
        """Inverse warp: from projected image back to camera plane
        (warpers_inl.hpp:113)."""
        src = as_tensor(src)
        self.proj.set_camera(Km, R)
        w, h = dst_size
        (tlx, tly), _ = self._detect_roi(h, w, src.device)
        gx, gy = _grid(np.arange(w), np.arange(h), src.device)
        u, v = self.proj.forward(gx, gy)
        return _remap(src, (u - tlx).to(torch.float32), (v - tly).to(torch.float32),
                      interp_mode, borderMode=border_mode)

    def warpRoi(self, src_size, Km, R):
        self.proj.set_camera(Km, R)
        w, h = src_size
        (tlx, tly), (brx, bry) = self._detect_roi(h, w, self.device)
        return (tlx, tly, brx - tlx + 1, bry - tly + 1)

    def getScale(self):
        return self.proj.scale

    def setScale(self, s):
        self.proj.scale = float(s)
