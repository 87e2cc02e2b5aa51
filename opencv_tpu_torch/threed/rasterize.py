"""Software triangle rasterizer (the 5.x 3d module's triangleRasterize,
ptcloud/src/rendering.cpp in the wheel); twin of
``opencv_tpu/threed/rasterize.py``.  Camera looks down −z (GL-style),
pinhole from fovY with f = (H/2)/tan(fovY/2) and principal point
((W−1)/2, (H−1)/2); the depth buffer holds linear camera-space depth unless
INVDEPTH compat is selected.

The JAX package's loop, kept exactly: triangles in order, each one's
bounding-box window tested and written on the buffers' device (a numpy
buffer is a CPU tensor), an f64 depth compared with the f32 buffer and
stored as f32, so that ties fall as they do there.  The vertex transform
and the per-triangle skips (near/far, culling, an empty box) are O(V) host
numpy, as in the JAX package; the windows read nothing back (a triangle
that covers or passes no pixel leaves the buffers as they were).  Each
float op runs alone in f64 and divides by 0-dim device tensors, so the card,
the CPU and numpy agree bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.arrays import as_tensor, to_device

__all__ = ["triangleRasterize", "triangleRasterizeColor",
           "triangleRasterizeDepth", "TriangleRasterizeSettings",
           "RASTERIZE_CULLING_NONE", "RASTERIZE_CULLING_CW",
           "RASTERIZE_CULLING_CCW", "RASTERIZE_SHADING_WHITE",
           "RASTERIZE_SHADING_FLAT", "RASTERIZE_SHADING_SHADED",
           "RASTERIZE_COMPAT_DISABLED", "RASTERIZE_COMPAT_INVDEPTH"]

RASTERIZE_SHADING_WHITE = 0
RASTERIZE_SHADING_FLAT = 1
RASTERIZE_SHADING_SHADED = 2
RASTERIZE_CULLING_NONE = 0
RASTERIZE_CULLING_CW = 1
RASTERIZE_CULLING_CCW = 2
RASTERIZE_COMPAT_DISABLED = 0
RASTERIZE_COMPAT_INVDEPTH = 1


class TriangleRasterizeSettings:
    def __init__(self):
        self.shadingType = RASTERIZE_SHADING_SHADED
        self.cullingMode = RASTERIZE_CULLING_CW
        self.glCompatibleMode = RASTERIZE_COMPAT_DISABLED

    def setShadingType(self, t):
        self.shadingType = t
        return self

    def setCullingMode(self, m):
        self.cullingMode = m
        return self

    def setGlCompatibleMode(self, m):
        self.glCompatibleMode = m
        return self


def _rasterize(vertices, indices, colors, colorBuf, depthBuf, world2cam,
               fovY, zNear, zFar, settings, want_color, want_depth):
    v = np.asarray(vertices, np.float64).reshape(-1, 3)
    tri = np.asarray(indices, np.int32).reshape(-1, 3)
    cols = (np.asarray(colors, np.float64).reshape(-1, 3)
            if colors is not None and np.asarray(colors).size else None)
    T = np.asarray(world2cam, np.float64).reshape(-1, 4)[:3]
    st = settings or TriangleRasterizeSettings()

    db = as_tensor(depthBuf).to(torch.float32, copy=True)
    dev = db.device
    cb = None if colorBuf is None else as_tensor(colorBuf).to(dev, torch.float32, copy=True)
    H, W = db.shape[:2]
    f = (H / 2.0) / np.tan(fovY / 2.0)
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0

    vc = v @ T[:, :3].T + T[:, 3]
    z = -vc[:, 2]                      # camera looks down -z
    with np.errstate(divide="ignore", invalid="ignore"):
        su = vc[:, 0] / z * f + cx
        sv = cy - vc[:, 1] / z * f

    invdepth = st.glCompatibleMode == RASTERIZE_COMPAT_INVDEPTH
    shaded = (cb is not None and want_color and cols is not None
              and st.shadingType not in (RASTERIZE_SHADING_WHITE, RASTERIZE_SHADING_FLAT))

    # the triangles that reach a window
    todo = []
    for t in range(len(tri)):
        i0, i1, i2 = tri[t]
        z0, z1, z2 = z[i0], z[i1], z[i2]
        if z0 < zNear or z1 < zNear or z2 < zNear:
            continue
        if z0 > zFar and z1 > zFar and z2 > zFar:
            continue
        p0 = (float(su[i0]), float(sv[i0]))
        p1 = (float(su[i1]), float(sv[i1]))
        p2 = (float(su[i2]), float(sv[i2]))
        area = ((p1[0] - p0[0]) * (p2[1] - p0[1])
                - (p2[0] - p0[0]) * (p1[1] - p0[1]))
        if st.cullingMode == RASTERIZE_CULLING_CW and area >= 0:
            continue
        if st.cullingMode == RASTERIZE_CULLING_CCW and area <= 0:
            continue
        if area == 0:
            continue
        xmin = max(int(np.ceil(min(p0[0], p1[0], p2[0]))), 0)
        xmax = min(int(np.floor(max(p0[0], p1[0], p2[0]))), W - 1)
        ymin = max(int(np.ceil(min(p0[1], p1[1], p2[1]))), 0)
        ymax = min(int(np.floor(max(p0[1], p1[1], p2[1]))), H - 1)
        if xmin > xmax or ymin > ymax:
            continue
        todo.append((t, p0, p1, p2, area, xmin, xmax, ymin, ymax))
    if not todo:
        return cb, db
    # per triangle, its three edges' terms (the edge from p to the next
    # corner: dx, dy, p.x, p.y), its area and its corners' depths in the
    # order of the edge weights (w0 weighs i2, w1 i0, w2 i1), as one table
    rows = []
    for t, p0, p1, p2, area, *_ in todo:
        cur, nxt = (p0, p1, p2), (p1, p2, p0)
        i0, i1, i2 = tri[t]
        rows.append([b[0] - a[0] for a, b in zip(cur, nxt)]
                    + [b[1] - a[1] for a, b in zip(cur, nxt)]
                    + [a[0] for a in cur] + [a[1] for a in cur] + [area, z[i2], z[i0], z[i1]])
    tab = to_device(np.array(rows, np.float64), dev)
    if shaded:
        cdiv = to_device(np.stack([cols[tri[t]] for t, *_ in todo]), dev)  # (n, 3, 3)
    xs = torch.arange(W, dtype=torch.float64, device=dev)
    ys = torch.arange(H, dtype=torch.float64, device=dev)[:, None]

    for k, (t, _, _, _, _, xmin, xmax, ymin, ymax) in enumerate(todo):
        e = tab[k, :12].view(4, 3, 1, 1)
        area, zs = tab[k, 12], tab[k, 13:16].view(3, 1, 1)
        gx = xs[xmin:xmax + 1]
        gy = ys[ymin:ymax + 1]
        # the three edge functions at once, each op as the JAX package's:
        # w_e = (dx_e * (gy - p_e.y) - (gx - p_e.x) * dy_e) / area
        w = (e[0] * (gy - e[3]) - (gx - e[2]) * e[1]) / area
        inside = (w >= 0).all(dim=0)
        # barycentric wrt (i2, i0, i1) edge functions above: w0 is the
        # weight of i2, w1 of i0, w2 of i1
        l2, l0, l1 = w
        q = w / zs
        zi = 1.0 / (q[1] + q[2] + q[0])
        sub_d = db[ymin:ymax + 1, xmin:xmax + 1]
        passed = inside & (zi < sub_d) & (zi >= zNear) & (zi <= zFar)
        new_d = torch.where(passed, 1.0 / zi if invdepth else zi, sub_d)
        db[ymin:ymax + 1, xmin:xmax + 1] = new_d.to(torch.float32)
        if cb is not None and want_color:
            i0 = tri[t, 0]
            if st.shadingType == RASTERIZE_SHADING_WHITE or cols is None:
                col = torch.ones(passed.shape + (3,), dtype=torch.float64, device=dev)
            elif st.shadingType == RASTERIZE_SHADING_FLAT:
                col = torch.tensor(cols[i0], dtype=torch.float64,
                                   device=dev).expand(passed.shape + (3,))
            else:   # perspective-correct interpolation
                c0, c1, c2 = cdiv[k]
                z2, z0, z1 = zs
                col = (zi[..., None]
                       * (l0[..., None] * c0 / z0
                          + l1[..., None] * c1 / z1
                          + l2[..., None] * c2 / z2))
            sub_c = cb[ymin:ymax + 1, xmin:xmax + 1]
            cb[ymin:ymax + 1, xmin:xmax + 1] = torch.where(
                passed[..., None], col, sub_c).to(torch.float32)
    return cb, db


def triangleRasterize(vertices, indices, colors, colorBuf, depthBuf,
                      world2cam, fovY, zNear, zFar, settings=None):
    return _rasterize(vertices, indices, colors, colorBuf, depthBuf,
                      world2cam, fovY, zNear, zFar, settings, True, True)


def triangleRasterizeColor(vertices, indices, colors, colorBuf,
                           world2cam, fovY, zNear, zFar, settings=None):
    cbuf = as_tensor(colorBuf)
    H, W = cbuf.shape[:2]
    cb, _ = _rasterize(vertices, indices, colors, cbuf,
                       torch.full((H, W), zFar, dtype=torch.float32,
                                  device=cbuf.device), world2cam,
                       fovY, zNear, zFar, settings, True, False)
    return cb


def triangleRasterizeDepth(vertices, indices, depthBuf, world2cam, fovY,
                           zNear, zFar, settings=None):
    _, db = _rasterize(vertices, indices, None, None, depthBuf,
                       world2cam, fovY, zNear, zFar, settings, False,
                       True)
    return db
