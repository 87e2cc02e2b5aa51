"""Depth-map utilities from the 5.x 3d module (depthTo3d, rescaleDepth,
registerDepth, warpFrame); twin of ``opencv_tpu/threed/depth.py``.

The JAX package runs these dense per-pixel maps as numpy on the host; the
port runs them as torch on the input's device (a numpy input is a CPU
tensor), with the wheel's output conventions.  Every float op runs alone in
float64 as numpy's does, and a division by a number divides by a 0-dim
tensor on the device (CUDA turns a division by a host scalar into a product
with its reciprocal), so the card, the CPU and numpy agree bit for bit.
The z-buffers are ``scatter_reduce`` minima; where two points tie for a
pixel, the later one wins, as numpy's fancy assignment has it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.arrays import as_tensor

__all__ = ["depthTo3d", "depthTo3dSparse", "rescaleDepth",
           "registerDepth", "warpFrame"]

_INT_DEPTHS = (torch.uint16, torch.int16, torch.uint8)


def scalar(v, like: torch.Tensor) -> torch.Tensor:
    """`v` as a 0-dim float64 tensor on `like`'s device, to divide by."""
    return torch.tensor(float(v), dtype=torch.float64, device=like.device)


def depth_tensor(a) -> torch.Tensor:
    """A depth map as a tensor (numpy's uint16 is read as torch.uint16)."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype == np.uint16:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.uint16)
    return as_tensor(a)


def _pixel_grid(H: int, W: int, device):
    xs = torch.arange(W, dtype=torch.float64, device=device).expand(H, W)
    ys = torch.arange(H, dtype=torch.float64, device=device)[:, None].expand(H, W)
    return xs, ys


def rescaleDepth(in_, type: int = 5, depth_factor: float = 1000.0):
    """u16/u8 integer depth (millimetres) → float metres; invalid (0 or
    the integer sentinel) becomes NaN like the reference."""
    a = depth_tensor(in_)
    if a.dtype in _INT_DEPTHS:
        out = a.to(torch.int32).to(torch.float64) / scalar(depth_factor, a)
        out = torch.where(a == 0, torch.nan, out)
    else:
        out = a.to(torch.float64)
    return out.to(torch.float32 if type in (5, -1) else torch.float64)


def _metres(d: torch.Tensor) -> torch.Tensor:
    return rescaleDepth(d, 5) if d.dtype in _INT_DEPTHS else d


def backproject(xs, ys, z, Km) -> tuple:
    """(X, Y) of pixels (xs, ys) at depth z under the host 3x3 `Km`, float64,
    each op alone: (x - cx) / fx * z."""
    X = (xs - float(Km[0, 2])) / scalar(Km[0, 0], z) * z
    Y = (ys - float(Km[1, 2])) / scalar(Km[1, 1], z) * z
    return X, Y


def depthTo3d(depth, K, points3d=None, mask=None):
    """Backproject a depth map: (H, W, 4) float32 of (X, Y, Z, 0)
    camera-space points (the wheel returns a 4-channel map)."""
    d = _metres(depth_tensor(depth)).to(torch.float64)
    Km = np.asarray(K, np.float64).reshape(3, 3)
    H, W = d.shape[:2]
    xs, ys = _pixel_grid(H, W, d.device)
    X, Y = backproject(xs, ys, d, Km)
    out = torch.stack([X, Y, d, torch.zeros_like(d)], dim=-1)
    if mask is not None:
        out = torch.where(as_tensor(mask).to(d.device)[..., None] == 0, torch.nan, out)
    return out.to(torch.float32)


def depthTo3dSparse(depth, K, points):
    """Backproject only the given pixel coordinates → (N, 1, 3)."""
    d = _metres(depth_tensor(depth))
    Km = np.asarray(K, np.float64).reshape(3, 3)
    pts = np.asarray(points).reshape(-1, 2)
    ix = torch.from_numpy(pts[:, 0].astype(np.int64)).to(d.device)
    iy = torch.from_numpy(pts[:, 1].astype(np.int64)).to(d.device)
    z = d[iy, ix].to(torch.float64)
    p = torch.from_numpy(pts.astype(np.float64)).to(d.device)
    X, Y = backproject(p[:, 0], p[:, 1], z, Km)
    return torch.stack([X, Y, z], -1).to(torch.float32).reshape(-1, 1, 3)


def rigid(T, X, Y, Z) -> tuple:
    """T (host 3x4) applied to points (X, Y, Z): each row's products summed
    left to right, then its translation added."""
    return tuple(float(T[r, 0]) * X + float(T[r, 1]) * Y + float(T[r, 2]) * Z + float(T[r, 3])
                 for r in range(3))


def project(Xc, Yc, Zc, Km) -> tuple:
    """round(X / Z * fx + cx), round(Y / Z * fy + cy) as int64."""
    u = torch.round(Xc / Zc * float(Km[0, 0]) + float(Km[0, 2]))
    v = torch.round(Yc / Zc * float(Km[1, 1]) + float(Km[1, 2]))
    return u.to(torch.int64), v.to(torch.int64)


def _forward_points(df, Km, T, valid):
    """Valid pixels of `df` moved by T and projected with Km: their target
    (u, v), new depth and source (y, x), for points in front."""
    H, W = df.shape
    sy, sx = torch.nonzero(valid, as_tuple=True)
    z = df[sy, sx]
    X, Y = backproject(sx.to(torch.float64), sy.to(torch.float64), z, Km)
    Xc, Yc, Zc = rigid(T, X, Y, z)
    ok = Zc > 0
    Xc, Yc, Zc, sy, sx = Xc[ok], Yc[ok], Zc[ok], sy[ok], sx[ok]
    u, v = project(Xc, Yc, Zc, Km)
    return u, v, Zc, sy, sx


def _zbuffer(u, v, z, Ho: int, Wo: int):
    """The nearest depth at each pixel (inf where none) and the flat target
    index of each point."""
    idx = v * Wo + u
    zb = torch.full((Ho * Wo,), torch.inf, dtype=torch.float64, device=z.device)
    zb.scatter_reduce_(0, idx, z, reduce="amin")
    return zb, idx


def registerDepth(unregisteredCameraMatrix, registeredCameraMatrix,
                  registeredDistCoeffs, Rt, unregisteredDepth,
                  outputImagePlaneSize, depthDilation: bool = False):
    """Reproject a depth map into another camera's image plane with a
    z-buffer (3d module registerDepth)."""
    Ku = np.asarray(unregisteredCameraMatrix, np.float64).reshape(3, 3)
    Kr = np.asarray(registeredCameraMatrix, np.float64).reshape(3, 3)
    T = np.asarray(Rt, np.float64).reshape(-1, 4)[:3]
    d = depth_tensor(unregisteredDepth)
    scaled = d.dtype in (torch.uint16, torch.int16)
    df = (rescaleDepth(d, 5) if scaled else d).to(torch.float64)
    H, W = df.shape
    Wo, Ho = int(outputImagePlaneSize[0]), int(outputImagePlaneSize[1])
    valid = torch.isfinite(df) & (df > 0)
    sy, sx = torch.nonzero(valid, as_tuple=True)
    z = df[sy, sx]
    X, Y = backproject(sx.to(torch.float64), sy.to(torch.float64), z, Ku)
    Xc, Yc, Zc = rigid(T, X, Y, z)
    ok = Zc > 0
    Xc, Yc, Zc = Xc[ok], Yc[ok], Zc[ok]
    u, v = project(Xc, Yc, Zc, Kr)
    inb = (u >= 0) & (u < Wo) & (v >= 0) & (v < Ho)
    zb, _ = _zbuffer(u[inb], v[inb], Zc[inb], Ho, Wo)
    out = torch.where(torch.isfinite(zb), zb, 0.0).reshape(Ho, Wo)
    if scaled:
        return torch.round(out * 1000).to(torch.int32).to(d.dtype)
    return out.to(torch.float32)


def warpFrame(depth, image, mask, Rt, cameraMatrix, warpedDepth=None,
              warpedImage=None, warpedMask=None):
    """Forward-warp an RGB-D frame by the pose Rt (3d module
    warpFrame): backproject, transform, project, z-buffer scatter."""
    Km = np.asarray(cameraMatrix, np.float64).reshape(3, 3)
    T = np.asarray(Rt, np.float64).reshape(-1, 4)[:3]
    d = depth_tensor(depth)
    df = (rescaleDepth(d, 5) if d.dtype in (torch.uint16, torch.int16) else d).to(torch.float64)
    dev = df.device
    H, W = df.shape
    m = (torch.ones((H, W), dtype=torch.bool, device=dev) if mask is None
         else as_tensor(mask).to(dev) != 0)
    valid = torch.isfinite(df) & (df > 0) & m
    u, v, zn, sy, sx = _forward_points(df, Km, T, valid)
    inb = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    u, v, zn, sy, sx = u[inb], v[inb], zn[inb], sy[inb], sx[inb]
    zb, idx = _zbuffer(u, v, zn, H, W)
    win = zn == zb[idx]
    # among the points that tie at a pixel, the last one's source pixel
    order = torch.arange(len(idx), device=dev)
    last = torch.full((H * W,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, idx[win], order[win], reduce="amax")
    hit = last >= 0
    tgt = torch.nonzero(hit, as_tuple=True)[0]
    src = last[tgt]
    wi = None
    if image is not None:
        img = as_tensor(image).to(dev)
        wi = torch.zeros_like(img).reshape(H * W, -1)
        wi[tgt] = img[sy[src], sx[src]].reshape(len(tgt), -1)
        wi = wi.reshape(img.shape)
    wm = torch.where(hit, 255, 0).to(torch.uint8).reshape(H, W)
    out_d = torch.where(hit, zb, torch.nan).to(torch.float32).reshape(H, W)
    return out_d, wi, wm


def gradient(a: torch.Tensor, dim: int) -> torch.Tensor:
    """numpy.gradient along `dim` at unit spacing: central differences
    inside, one-sided ones at the two ends (a dimension of size 1 gives 0)."""
    n = a.shape[dim]
    if n < 2:
        return torch.zeros_like(a)
    sl = lambda i, j: a.narrow(dim, i, j - i)
    inner = (sl(2, n) - sl(0, n - 2)) / 2.0
    return torch.cat([sl(1, 2) - sl(0, 1), inner, sl(n - 1, n) - sl(n - 2, n - 1)], dim=dim)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """numpy.cross over the last axis of 3-vectors, in its op order."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def norm3(a: torch.Tensor) -> torch.Tensor:
    """numpy.linalg.norm over the last axis of 3-vectors, keeping it."""
    a0, a1, a2 = a.unbind(-1)
    return torch.sqrt(a0 * a0 + a1 * a1 + a2 * a2)[..., None]
