"""TSDF volume + RGB-D odometry (5.x 3d module Volume/Odometry); twin of
``opencv_tpu/threed/tsdf.py``.

Volume: dense voxel TSDF — integrate projects every voxel into the depth
frame and folds a truncated signed distance with running-weight averaging;
raycast marches rays to the zero crossing.  The JAX package runs both as
numpy passes; the port keeps the volume on its device (``"cuda"`` unless
the caller asks for another) and runs them as torch there:

- ``integrate`` walks the volume in x-slabs of about ``SLAB_VOXELS`` voxels
  (the JAX package's whole-volume index grids would take tens of GB at
  512³), with the same per-voxel float64 arithmetic, each op alone, so the
  card equals the CPU voxel for voxel.  Like the JAX package it reads a
  16-bit depth map at a factor of 1000, whatever ``getDepthFactor()`` says.
- ``raycast`` computes the rays' directions on the host as the JAX package
  does, then marches them with masked updates that read nothing back, and
  checks every ``RAYCAST_CHECK_EVERY`` steps whether every ray has met the
  surface (a check that only stops the march early and changes no output).

Odometry: point-to-plane ICP between depth frames over an image pyramid
(the reference's ICP branch of Odometry::compute).  The gathers and
residuals run on the depth's device, and each iteration's 6-unknown least
squares is ``torch.linalg.lstsq`` in float64 there; the 3x3 projection of
the update onto a rotation (an SVD) is host numpy, as in the JAX package.

The rigid transforms of points are written out as each row's products
summed left to right plus the translation (numpy's ``@`` is a BLAS product
whose order the port does not copy): with the identity rotations of a
volume pose, as KinectFusion's, that is numpy's result bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.arrays import as_tensor, to_device, to_host
from .depth import (cross, depth_tensor, depthTo3d, gradient, norm3, rescaleDepth, rigid,
                    scalar)

__all__ = ["VolumeSettings", "Volume", "Odometry", "OdometryFrame",
           "OdometrySettings"]

SLAB_VOXELS = 1 << 23        # voxels per x-slab of an integration (32 planes of 512²)
RAYCAST_CHECK_EVERY = 32     # raycast's steps between its reads of "all rays found"


def _f64(d: torch.Tensor) -> torch.Tensor:
    if d.dtype in (torch.uint16, torch.uint8, torch.int16):
        d = d.to(torch.int32)
    return d.to(torch.float64)


def _round_index(v: torch.Tensor, hi: int) -> torch.Tensor:
    """A rounded float coordinate as int64, clamped to [-1, hi] first (an
    out-of-range value stays out of range, and no float overflows the cast)."""
    return torch.round(v).clamp(-1, hi).to(torch.int64)


class VolumeSettings:
    def __init__(self, volumeType: int = 0):
        self._voxelSize = 0.005859375
        self._res = (128, 128, 128)
        self._pose = np.eye(4)
        self._trunc = 2.5 * self._voxelSize
        self._maxWeight = 64
        self._depthFactor = 1000.0
        self._maxDepth = 4.0
        self._raycastStep = 0.75
        self._K = np.array([[525, 0, 319.5], [0, 525, 239.5],
                            [0, 0, 1]], np.float64)
        self._isize = (640, 480)

    def getVoxelSize(self):
        return self._voxelSize

    def setVoxelSize(self, v):
        self._voxelSize = float(v)

    def getVolumeResolution(self):
        return self._res

    def setVolumeResolution(self, r):
        self._res = tuple(int(x) for x in np.ravel(r))

    def getVolumePose(self):
        return self._pose.copy()

    def setVolumePose(self, p):
        self._pose = np.asarray(p, np.float64).reshape(4, 4)

    def getTsdfTruncateDistance(self):
        return self._trunc

    def setTsdfTruncateDistance(self, v):
        self._trunc = float(v)

    def getMaxWeight(self):
        return self._maxWeight

    def setMaxWeight(self, v):
        self._maxWeight = int(v)

    def getDepthFactor(self):
        return self._depthFactor

    def setDepthFactor(self, v):
        self._depthFactor = float(v)

    def getMaxDepth(self):
        return self._maxDepth

    def setMaxDepth(self, v):
        self._maxDepth = float(v)

    def getRaycastStepFactor(self):
        return self._raycastStep

    def setRaycastStepFactor(self, v):
        self._raycastStep = float(v)

    def getCameraIntegrateIntrinsics(self):
        return self._K.copy()

    def setCameraIntegrateIntrinsics(self, K):
        self._K = np.asarray(K, np.float64).reshape(3, 3)

    getCameraRaycastIntrinsics = getCameraIntegrateIntrinsics
    setCameraRaycastIntrinsics = setCameraIntegrateIntrinsics

    def getIntegrateWidth(self):
        return self._isize[0]

    def setIntegrateWidth(self, v):
        self._isize = (int(v), self._isize[1])

    def getIntegrateHeight(self):
        return self._isize[1]

    def setIntegrateHeight(self, v):
        self._isize = (self._isize[0], int(v))

    getRaycastWidth = getIntegrateWidth
    getRaycastHeight = getIntegrateHeight
    setRaycastWidth = setIntegrateWidth
    setRaycastHeight = setIntegrateHeight

    def getVolumeStrides(self):
        nx, ny, nz = self._res
        return (ny * nz, nz, 1)

    def setVolumeStrides(self, s):
        pass


class Volume:
    def __init__(self, volumeType: int = 0, settings=None, device=None):
        self._s = settings or VolumeSettings()
        self._device = torch.device("cuda" if device is None else device)
        self.reset()

    def reset(self):
        nx, ny, nz = self._s.getVolumeResolution()
        self._tsdf = torch.ones((nx, ny, nz), dtype=torch.float32, device=self._device)
        self._w = torch.zeros((nx, ny, nz), dtype=torch.float32, device=self._device)
        self._growth = True

    # -- integration --------------------------------------------------
    def _depth(self, depth, device) -> torch.Tensor:
        d = depth_tensor(depth).to(device)
        return _f64(rescaleDepth(d, 5) if d.dtype in (torch.uint16, torch.int16) else d)

    def integrate(self, depth, cameraPose):
        """Fold one depth frame taken at camera-to-world pose."""
        df = self._depth(depth, self._device)
        w2c = np.linalg.inv(np.asarray(cameraPose, np.float64).reshape(4, 4))
        nx, ny, nz = self._s.getVolumeResolution()
        step = max(1, SLAB_VOXELS // (ny * nz))
        for x0 in range(0, nx, step):
            x1 = min(nx, x0 + step)
            self.integrate_slab(self._tsdf[x0:x1], self._w[x0:x1], x0, df, w2c)

    def integrate_slab(self, t: torch.Tensor, w: torch.Tensor, x0: int, df: torch.Tensor,
                       w2c: np.ndarray) -> None:
        """Fold the float64 depth map `df` (metres) into the planes x0.. of
        the volume held by `t` and `w` (its TSDF and weights there, updated
        in place) for the world-to-camera pose `w2c`.  Each voxel is
        independent of the others."""
        dev = t.device
        n, ny, nz = t.shape
        K = self._s.getCameraIntegrateIntrinsics()
        vs = self._s.getVoxelSize()
        trunc = self._s.getTsdfTruncateDistance()
        i = torch.arange(x0, x0 + n, dtype=torch.float64, device=dev)[:, None, None] * vs
        j = torch.arange(ny, dtype=torch.float64, device=dev)[None, :, None] * vs
        k = torch.arange(nz, dtype=torch.float64, device=dev)[None, None, :] * vs
        pts = rigid(self._s.getVolumePose(), i, j, k)
        pcx, pcy, z = rigid(w2c, *pts)
        del pts
        H, W = df.shape
        ok = z > 0
        zs = torch.where(ok, z, 1.0)
        u = _round_index(pcx / zs * float(K[0, 0]) + float(K[0, 2]), W)
        v = _round_index(pcy / zs * float(K[1, 1]) + float(K[1, 2]), H)
        del pcx, pcy, zs
        inb = ok & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        dm = torch.where(inb, df.reshape(-1)[torch.where(inb, v * W + u, 0)], 0.0)
        del u, v
        valid = inb & torch.isfinite(dm) & (dm > 0) & (dm < self._s.getMaxDepth())
        sdf = dm - z
        upd = valid & (sdf > -trunc)
        tsdf_new = torch.clamp(sdf / scalar(trunc, sdf), -1.0, 1.0)
        wn = torch.minimum(w + 1, torch.tensor(float(self._s.getMaxWeight()), device=dev))
        t_new = (t * w + tsdf_new) / (w + 1)
        t.copy_(torch.where(upd, t_new.to(torch.float32), t))
        w.copy_(torch.where(upd, wn, w))

    def integrateFrame(self, frame, cameraPose):
        self.integrate(frame.getDepth(), cameraPose)

    def integrateColor(self, depth, image, cameraPose):
        self.integrate(depth, cameraPose)

    # -- queries ------------------------------------------------------
    def ray_directions(self, cameraPose, height: int, width: int) -> np.ndarray:
        """The unit rays of the raycast's pixels in world axes, (H, W, 3)
        float64, computed on the host as the JAX package computes them."""
        K = self._s.getCameraRaycastIntrinsics()
        pose = np.asarray(cameraPose, np.float64).reshape(4, 4)
        xs, ys = np.meshgrid(np.arange(width), np.arange(height))
        dirs = np.stack([(xs - K[0, 2]) / K[0, 0],
                         (ys - K[1, 2]) / K[1, 1],
                         np.ones_like(xs, np.float64)], -1)
        dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
        return dirs @ pose[:3, :3].T

    def march(self, dirs_w: torch.Tensor, orig, tsdf: torch.Tensor,
              weights: torch.Tensor) -> torch.Tensor:
        """March rays (`dirs_w`, (..., 3) float64 on the volume's device)
        from `orig` through the volume held by `tsdf` and `weights`; returns
        each ray's zero crossing, (..., 3) float64, NaN where none.  Each
        ray is independent of the others.  The three axes go as one (3, R)
        tensor through each op, so a step is ~35 launches."""
        dev = dirs_w.device
        vs = self._s.getVoxelSize()
        res = self._s.getVolumeResolution()
        nx, ny, nz = res
        step = self._s.getRaycastStepFactor() * vs
        vol_inv = np.linalg.inv(self._s.getVolumePose())
        n_steps = int(self._s.getMaxDepth() / step)
        shape = dirs_w.shape[:-1]
        D = dirs_w.reshape(-1, 3).T                       # (3, R)
        R = D.shape[1]
        O = torch.tensor(np.asarray(orig, np.float64).reshape(3, 1), device=dev)
        # the volume's inverse pose: a translation alone (as KinectFusion's)
        # is added as it is; x + 0*y + 0*z + t is x + t up to the sign of a
        # zero, which rounding to a voxel index does not see
        shift_only = np.array_equal(vol_inv[:3, :3], np.eye(3))
        Tq = torch.tensor(vol_inv[:3, 3:], device=dev)
        hi = torch.tensor([[nx - 1], [ny - 1], [nz - 1]], device=dev)
        flat_t, flat_w = tsdf.reshape(-1), weights.reshape(-1)
        vs_t = scalar(vs, dirs_w)
        pts_out = torch.full((3, R), torch.nan, dtype=torch.float64, device=dev)
        prev_tsdf = torch.full((R,), 1.0, dtype=torch.float64, device=dev)
        prev_t = 0.0
        found = torch.zeros(R, dtype=torch.bool, device=dev)
        for si in range(1, n_steps):
            t = si * step
            P = D * t + O
            Q = P + Tq if shift_only else torch.stack(rigid(vol_inv, *P))
            idx = torch.round(Q / vs_t).to(torch.int64)
            okm = ((idx >= 0) & (idx <= hi)).all(dim=0)
            ic = torch.minimum(idx.clamp(min=0), hi)
            flat = (ic[0] * ny + ic[1]) * nz + ic[2]
            val = torch.where(okm, flat_t[flat], 1.0)
            wgt = torch.where(okm, flat_w[flat], 0.0)
            cross_ = (~found) & (prev_tsdf > 0) & (val <= 0) & (wgt > 0)
            # linear interpolation of the zero crossing
            denom = prev_tsdf - val
            tz = torch.where(denom.abs() > 1e-12,
                             prev_t + (t - prev_t) * prev_tsdf / torch.clamp(denom, min=1e-12), t)
            pts_out = torch.where(cross_, D * tz + O, pts_out)
            found |= cross_
            prev_tsdf = torch.where(wgt > 0, val, prev_tsdf)
            prev_t = t
            if si % RAYCAST_CHECK_EVERY == 0 and bool(found.all()):
                break
        return pts_out.T.reshape(shape + (3,))

    def raycast(self, cameraPose, height: int = -1, width: int = -1):
        """March rays from the camera through the TSDF to the zero
        crossing; returns (points (H,W,4), normals (H,W,4)) on the volume's
        device."""
        if width <= 0:
            width = self._s.getRaycastWidth()
        if height <= 0:
            height = self._s.getRaycastHeight()
        pose = np.asarray(cameraPose, np.float64).reshape(4, 4)
        dirs_w = to_device(self.ray_directions(pose, height, width), self._device)
        pts_out = self.march(dirs_w, pose[:3, 3], self._tsdf, self._w)
        n = cross(gradient(pts_out, 1), gradient(pts_out, 0))
        normals = n / norm3(n)
        pad = lambda a: torch.cat([a, torch.zeros_like(a[..., :1])], -1).to(torch.float32)
        return pad(pts_out), pad(normals)

    def raycastColor(self, cameraPose, *a, **k):
        p, n = self.raycast(cameraPose)
        return p, n, torch.zeros_like(p)

    raycastEx = raycast
    raycastExColor = raycastColor

    def fetchPointsNormals(self):
        vs = self._s.getVoxelSize()
        surf = (self._tsdf.abs() < 0.5) & (self._w > 0)
        idx = torch.argwhere(surf).to(torch.float64) * vs
        pts = torch.stack(rigid(self._s.getVolumePose(), *idx.unbind(-1)), -1)
        return (pts.to(torch.float32).reshape(-1, 1, 3),
                torch.zeros_like(pts, dtype=torch.float32).reshape(-1, 1, 3))

    def fetchNormals(self, points):
        return torch.zeros_like(as_tensor(points).to(torch.float32))

    def fetchPointsNormalsColors(self):
        p, n = self.fetchPointsNormals()
        return p, n, torch.zeros_like(p)

    def getBoundingBox(self, *a, **k):
        nx, ny, nz = self._s.getVolumeResolution()
        vs = self._s.getVoxelSize()
        return np.array([0, 0, 0, nx * vs, ny * vs, nz * vs],
                        np.float32)

    def getTotalVolumeUnits(self):
        return int(np.prod(self._s.getVolumeResolution()))

    def getVisibleBlocks(self):
        return int((self._w > 0).sum())

    def getEnableGrowth(self):
        return self._growth

    def setEnableGrowth(self, v):
        self._growth = bool(v)


class OdometrySettings:
    def __init__(self):
        self._K = np.array([[525, 0, 319.5], [0, 525, 239.5],
                            [0, 0, 1]], np.float32)
        self._iters = [7, 7, 7, 10]
        self._maxDepth = 4.0
        self._minDepth = 0.0
        self._maxDepthDiff = 0.07
        self._maxRot = 15.0
        self._maxTrans = 0.15

    def getCameraMatrix(self):
        return self._K.copy()

    def setCameraMatrix(self, K):
        if K is not None and np.asarray(K).size:
            self._K = np.asarray(K, np.float32).reshape(3, 3)

    def getIterCounts(self):
        return np.asarray(self._iters, np.int32)

    def setIterCounts(self, v):
        self._iters = list(np.ravel(v).astype(int))

    def getMaxDepth(self):
        return self._maxDepth

    def setMaxDepth(self, v):
        self._maxDepth = float(v)

    def getMinDepth(self):
        return self._minDepth

    def setMinDepth(self, v):
        self._minDepth = float(v)

    def getMaxDepthDiff(self):
        return self._maxDepthDiff

    def setMaxDepthDiff(self, v):
        self._maxDepthDiff = float(v)

    def getMaxRotation(self):
        return self._maxRot

    def setMaxRotation(self, v):
        self._maxRot = float(v)

    def getMaxTranslation(self):
        return self._maxTrans

    def setMaxTranslation(self, v):
        self._maxTrans = float(v)

    def getAngleThreshold(self):
        return 0.523599

    def getMaxPointsPart(self):
        return 0.07

    def getMinGradientMagnitude(self):
        return 10.0

    def getMinGradientMagnitudes(self):
        return np.full(4, 10.0, np.float32)

    def getNormalDiffThreshold(self):
        return 50.0

    def getNormalMethod(self):
        return 3

    def getNormalWinSize(self):
        return 5

    def getSobelScale(self):
        return 1.0 / 8

    def getSobelSize(self):
        return 3


class OdometryFrame:
    def __init__(self, depth=None, image=None, mask=None, normals=None):
        self._depth = None if depth is None else np.asarray(depth)
        self._image = None if image is None else np.asarray(image)
        self._mask = None if mask is None else np.asarray(mask)
        self._normals = normals
        self._pyr = None

    def getDepth(self):
        return self._depth

    getProcessedDepth = getDepth

    def getImage(self):
        return self._image

    def getGrayImage(self):
        img = self._image
        if img is not None and img.ndim == 3:
            return img.mean(axis=2).astype(img.dtype)
        return img

    def getMask(self):
        return self._mask

    def getNormals(self):
        return self._normals

    def getPyramidLevels(self):
        return 0 if self._pyr is None else len(self._pyr)

    def getPyramidAt(self, idx, level):
        return None


class OdometryFrame:
    def __init__(self, depth=None, image=None, mask=None, normals=None):
        self._depth = None if depth is None else depth_tensor(depth)
        self._image = None if image is None else as_tensor(image)
        self._mask = None if mask is None else as_tensor(mask)
        self._normals = normals
        self._pyr = None

    def getDepth(self):
        return self._depth

    getProcessedDepth = getDepth

    def getImage(self):
        return self._image

    def getGrayImage(self):
        img = self._image
        if img is not None and img.ndim == 3:
            c = torch.tensor(float(img.shape[2]), dtype=torch.float64, device=img.device)
            return (img.to(torch.float64).sum(dim=2) / c).to(img.dtype)
        return img

    def getMask(self):
        return self._mask

    def getNormals(self):
        return self._normals

    def getPyramidLevels(self):
        return 0 if self._pyr is None else len(self._pyr)

    def getPyramidAt(self, idx, level):
        return None


class Odometry:
    """Depth-frame odometry: multi-scale point-to-plane ICP
    (3d module Odometry, ICP algorithm branch)."""

    def __init__(self, settings=None, algo=None):
        self._s = settings if isinstance(settings, OdometrySettings) \
            else OdometrySettings()

    def prepareFrame(self, frame):
        return frame

    def prepareFrames(self, srcFrame, dstFrame):
        return srcFrame, dstFrame

    def getNormalsComputer(self):
        return None

    @staticmethod
    def _pyr_down_depth(d):
        H, W = d.shape
        H2, W2 = H // 2, W // 2
        blocks = d[:H2 * 2, :W2 * 2].reshape(H2, 2, W2, 2)
        return torch.nanmean(torch.nanmean(blocks, dim=3), dim=1)

    def compute(self, srcFrame, dstFrame, Rt=None):
        """Estimate the rigid motion bringing src onto dst.  Returns
        (ok, Rt 4x4), the pose as host numpy; the work runs on the source
        depth's device."""
        get = lambda f: (f.getDepth() if isinstance(f, OdometryFrame)
                         else depth_tensor(f))
        src = _f64(get(srcFrame))
        dst = _f64(get(dstFrame)).to(src.device)
        K0 = self._s.getCameraMatrix().astype(np.float64)
        # build depth pyramids
        levels = max(1, min(3, len(self._s.getIterCounts())))
        pyr_s, pyr_d, Ks = [src], [dst], [K0]
        for _ in range(levels - 1):
            pyr_s.append(self._pyr_down_depth(pyr_s[-1]))
            pyr_d.append(self._pyr_down_depth(pyr_d[-1]))
            Kd = Ks[-1].copy()
            Kd[:2] *= 0.5
            Ks.append(Kd)
        T = (np.eye(4) if Rt is None
             else np.asarray(to_host(Rt), np.float64).reshape(4, 4).copy())
        iters = list(self._s.getIterCounts())
        for lvl in range(levels - 1, -1, -1):
            s, d, K = pyr_s[lvl], pyr_d[lvl], Ks[lvl]
            it = iters[min(lvl, len(iters) - 1)]
            T = self._icp_level(s, d, K, T, int(it))
        return True, T

    def _icp_level(self, src, dst, K, T, iters):
        H, W = dst.shape
        dst_pts = depthTo3d(dst.to(torch.float32), K)[..., :3].to(torch.float64)
        # dst normals from the organized point map
        nrm = cross(gradient(dst_pts, 1), gradient(dst_pts, 0))
        nrm = (nrm / norm3(nrm)).reshape(-1, 3)
        dst_pts = dst_pts.reshape(-1, 3)
        src_pts = depthTo3d(src.to(torch.float32), K)[..., :3].to(torch.float64).reshape(-1, 3)
        ok_src = (torch.isfinite(src_pts).all(1) & (src_pts[:, 2] > 0)
                  & (src_pts[:, 2] < self._s.getMaxDepth()))
        P = src_pts[ok_src]
        Px, Py, Pz = P.unbind(-1)
        nan = torch.tensor(torch.nan, dtype=torch.float64, device=P.device)
        for _ in range(iters):
            X, Y, Z = rigid(T, Px, Py, Pz)
            okz = Z > 0
            zs = torch.where(okz, Z, 1.0)
            u = _round_index(X / zs * float(K[0, 0]) + float(K[0, 2]), W)
            v = _round_index(Y / zs * float(K[1, 1]) + float(K[1, 2]), H)
            inb = okz & (u >= 0) & (u < W) & (v >= 0) & (v < H)
            at = torch.where(inb, v * W + u, 0)[:, None]
            q = torch.where(inb[:, None], dst_pts[at[:, 0]], nan)
            n = torch.where(inb[:, None], nrm[at[:, 0]], nan)
            good = (torch.isfinite(q).all(1) & torch.isfinite(n).all(1)
                    & ((q[:, 2] - Z).abs() < self._s.getMaxDepthDiff()))
            sel = torch.nonzero(good, as_tuple=True)[0]
            if len(sel) < 6:
                break
            p_ = torch.stack([X[sel], Y[sel], Z[sel]], -1)
            q_, n_ = q[sel], n[sel]
            d_ = p_ - q_
            r = d_[:, 0] * n_[:, 0] + d_[:, 1] * n_[:, 1] + d_[:, 2] * n_[:, 2]
            A = torch.cat([cross(p_, n_), n_], dim=1)
            x = to_host(torch.linalg.lstsq(A, -r[:, None]).solution[:, 0])
            a, b, c = x[:3]
            Rdelta = np.array([[1, -c, b], [c, 1, -a], [-b, a, 1]])
            U, _s2, Vt = np.linalg.svd(Rdelta)
            Rd = U @ Vt
            Td = np.eye(4)
            Td[:3, :3] = Rd
            Td[:3, 3] = x[3:]
            T = Td @ T
            if np.abs(x).max() < 1e-10:
                break
        return T
