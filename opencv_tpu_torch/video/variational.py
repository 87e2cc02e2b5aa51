"""VariationalRefinement (video/src/variational_refinement.cpp); twin of
``opencv_tpu/video/variational.py`` as eager torch on the flow's device.

Brox-style variational refinement of a dense flow field: colour and
gradient constancy data terms, a TV-like smoothness term, fixed-point
iterations over the linearised system solved by red-black SOR.  The
reference packs the grid into separate red and black buffers
(RedBlackBuffer, variational_refinement.cpp:88); here each SOR half-step
updates one checkerboard colour with a masked ``where`` over the whole grid,
which is the same iteration, since in a 4-neighbourhood no pixel of a
colour neighbours its own colour.  About 40 elementwise ops per half-sweep,
so on the card the loop is bound by launches.

The ops are the JAX program's, one at a time in its order; its square roots
are taken in f64 and rounded (correctly rounded f32 on both devices).  It
equals the JAX package's program run eagerly; its jitted program contracts
multiply-adds, against which ROADMAP.md queue C states the bound."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.arrays import as_tensor

__all__ = ["VariationalRefinement", "VariationalRefinement_create"]

_F32 = torch.float32


def _shift_from_left(x):      # the left neighbour's value; 0 outside
    return F.pad(x, (1, 0))[:, :-1]


def _shift_from_right(x):
    return F.pad(x, (0, 1))[:, 1:]


def _shift_from_up(x):
    return F.pad(x, (0, 0, 1, 0))[:-1, :]


def _shift_from_down(x):
    return F.pad(x, (0, 0, 0, 1))[1:, :]


def _dx_rep(x):               # x[i,j+1]-x[i,j], replicate => 0 at last col
    return torch.cat([x[:, 1:] - x[:, :-1], torch.zeros_like(x[:, :1])], dim=1)


def _dy_rep(x):
    return torch.cat([x[1:, :] - x[:-1, :], torch.zeros_like(x[:1, :])], dim=0)


def _pad_edge(x, top, bottom, left, right):
    return F.pad(x[None, None], (left, right, top, bottom), mode="replicate")[0, 0]


def _sobel1(img, axis: int):
    """Sobel with ksize=1 ([-1, 0, 1]), BORDER_REPLICATE: the derivative
    filter of variational_refinement.cpp:140 (gradHorizAndSplitOp)."""
    if axis == 0:   # d/dx
        p = _pad_edge(img, 0, 0, 1, 1)
        return p[:, 2:] - p[:, :-2]
    p = _pad_edge(img, 1, 1, 0, 0)
    return p[2:, :] - p[:-2, :]


def _warp_replicate(img, u, v):
    """remap(I1, grid+flow, INTER_LINEAR, BORDER_REPLICATE)."""
    H, W = img.shape
    dev = img.device
    yy = torch.arange(H, device=dev, dtype=torch.int32)[:, None]
    xx = torch.arange(W, device=dev, dtype=torch.int32)[None, :]
    mx = torch.clamp(xx + u, 0.0, W - 1.0)
    my = torch.clamp(yy + v, 0.0, H - 1.0)
    x0 = torch.clamp(torch.floor(mx), 0, W - 2).to(torch.int64)
    y0 = torch.clamp(torch.floor(my), 0, H - 2).to(torch.int64)
    fx = mx - x0
    fy = my - y0
    flat = img.reshape(-1)
    base = y0 * W + x0
    i00 = flat[base]
    i01 = flat[base + 1]
    i10 = flat[base + W]
    i11 = flat[base + W + 1]
    return ((1 - fy) * ((1 - fx) * i00 + fx * i01)
            + fy * ((1 - fx) * i10 + fx * i11))


def _sqrt32(v):
    return torch.sqrt(v.to(torch.float64)).to(_F32)


def _over(c, x):
    """c / x for an f32 constant c, divided (torch's ``c / x`` multiplies
    by the reciprocal)."""
    return torch.full_like(x, c) / x


def _refine(I0, I1, Wu, Wv, fp_iters: int, sor_iters: int, omega: float, alpha: float,
            delta: float, gamma: float, zeta: float, epsilon: float):
    """The fixed-point and SOR loops of variational_refinement.cpp on
    (H, W) f32 images and flow planes; returns the refined (u, v)."""
    H, W = I0.shape
    dev = I0.device
    zeta2 = np.float32(zeta * zeta)
    eps2 = np.float32(epsilon * epsilon)
    delta2 = np.float32(delta / 2)
    gamma2 = np.float32(gamma / 2)
    alpha2 = np.float32(alpha / 2)
    om = np.float32(omega)

    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    red_mask = (yy + xx) % 2 == 0
    black_mask = ~red_mask
    has_right = (xx < W - 1).to(_F32).expand(H, W)
    has_down = (yy < H - 1).to(_F32).expand(H, W)

    I0 = I0.to(_F32)
    I1 = I1.to(_F32)
    warped = _warp_replicate(I1, Wu, Wv)
    avg = 0.5 * (I0 + warped)
    Iz = warped - I0
    Ix = _sobel1(avg, 0)
    Iy = _sobel1(avg, 1)
    Ixz = _sobel1(Iz, 0)
    Iyz = _sobel1(Iz, 1)
    Ixx = _sobel1(Ix, 0)
    Ixy = _sobel1(Ix, 1)
    Iyy = _sobel1(Iy, 1)

    cu, cv = Wu, Wv
    du, dv = torch.zeros_like(Wu), torch.zeros_like(Wv)
    for _ in range(fp_iters):
        # the data term, from dW of the previous fixed-point iteration
        dN = Ix * Ix + Iy * Iy + zeta2
        Ik1z = Iz + Ix * du + Iy * dv
        w = _over(delta2, _sqrt32(Ik1z * Ik1z / dN + eps2)) / dN
        a11 = w * Ix * Ix + zeta2
        a12 = w * Ix * Iy
        a22 = w * Iy * Iy + zeta2
        b1 = -w * Iz * Ix
        b2 = -w * Iz * Iy
        dNx = Ixx * Ixx + Ixy * Ixy + zeta2
        dNy = Iyy * Iyy + Ixy * Ixy + zeta2
        Ik1zx = Ixz + Ixx * du + Ixy * dv
        Ik1zy = Iyz + Ixy * du + Iyy * dv
        w2 = _over(gamma2, _sqrt32(Ik1zx * Ik1zx / dNx + Ik1zy * Ik1zy / dNy + eps2))
        a11 = a11 + w2 * (Ixx * Ixx / dNx + Ixy * Ixy / dNy)
        a12 = a12 + w2 * (Ixx * Ixy / dNx + Ixy * Iyy / dNy)
        a22 = a22 + w2 * (Ixy * Ixy / dNx + Iyy * Iyy / dNy)
        b1 = b1 - w2 * (Ixx * Ixz / dNx + Ixy * Iyz / dNy)
        b2 = b2 - w2 * (Ixy * Ixz / dNx + Iyy * Iyz / dNy)

        # the smoothness term: edge weights from the current flow
        ux = _dx_rep(cu)
        vx = _dx_rep(cv)
        uy = _dy_rep(cu)
        vy = _dy_rep(cv)
        sw = _over(alpha2, _sqrt32(ux * ux + vx * vx + uy * uy + vy * vy + eps2))
        # b takes the gradients of the input flow W
        ex_u = sw * _dx_rep(Wu)
        ex_v = sw * _dx_rep(Wv)
        ey_u = sw * _dy_rep(Wu)
        ey_v = sw * _dy_rep(Wv)
        diag = (sw * has_right + sw * has_down + _shift_from_left(sw) + _shift_from_up(sw))
        a11 = a11 + diag
        a22 = a22 + diag
        b1 = b1 + ex_u - _shift_from_left(ex_u) + ey_u - _shift_from_up(ey_u)
        b2 = b2 + ex_v - _shift_from_left(ex_v) + ey_v - _shift_from_up(ey_v)

        wL = _shift_from_left(sw)
        wU = _shift_from_up(sw)

        def sor_color(du, dv, mask):
            sU = (wL * _shift_from_left(du) + sw * _shift_from_right(du)
                  + wU * _shift_from_up(du) + sw * _shift_from_down(du))
            du = torch.where(mask, du + om * ((sU + b1 - dv * a12) / a11 - du), du)
            sV = (wL * _shift_from_left(dv) + sw * _shift_from_right(dv)
                  + wU * _shift_from_up(dv) + sw * _shift_from_down(dv))
            dv = torch.where(mask, dv + om * ((sV + b2 - du * a12) / a22 - dv), dv)
            return du, dv

        for _ in range(sor_iters):
            du, dv = sor_color(du, dv, red_mask)
            du, dv = sor_color(du, dv, black_mask)
        cu, cv = Wu + du, Wv + dv
    return cu, cv


class VariationalRefinement:
    """cv2.VariationalRefinement (tracking.hpp:523)."""

    def __init__(self):
        self.fixedPointIterations = 5
        self.sorIterations = 5
        self.omega = 1.6
        self.alpha = 20.0
        self.delta = 5.0
        self.gamma = 10.0
        self.zeta = 0.1
        self.epsilon = 0.001

    @staticmethod
    def create():
        return VariationalRefinement()

    # parameter surface (tracking.hpp:530-571)
    def getFixedPointIterations(self):
        return self.fixedPointIterations

    def setFixedPointIterations(self, v):
        self.fixedPointIterations = int(v)

    def getSorIterations(self):
        return self.sorIterations

    def setSorIterations(self, v):
        self.sorIterations = int(v)

    def getOmega(self):
        return self.omega

    def setOmega(self, v):
        self.omega = float(v)

    def getAlpha(self):
        return self.alpha

    def setAlpha(self, v):
        self.alpha = float(v)

    def getDelta(self):
        return self.delta

    def setDelta(self, v):
        self.delta = float(v)

    def getGamma(self):
        return self.gamma

    def setGamma(self, v):
        self.gamma = float(v)

    def getEpsilon(self):
        return self.epsilon

    def setEpsilon(self, v):
        self.epsilon = float(v)

    def calcUV(self, I0, I1, flow_u, flow_v):
        """Refine (flow_u, flow_v): returns the refined pair as f32 tensors
        on the flow's device, and writes them into the given arrays when
        those are f32 numpy arrays or f32 tensors."""
        u = as_tensor(flow_u).to(_F32)
        v = as_tensor(flow_v).to(_F32)
        if self.fixedPointIterations <= 0:
            return u, v
        dev = u.device
        cu, cv = _refine(as_tensor(I0).to(dev), as_tensor(I1).to(dev), u, v,
                         int(self.fixedPointIterations), int(self.sorIterations),
                         float(self.omega), float(self.alpha), float(self.delta),
                         float(self.gamma), float(self.zeta), float(self.epsilon))
        for dst, src in ((flow_u, cu), (flow_v, cv)):
            if isinstance(dst, np.ndarray) and dst.dtype == np.float32:
                dst[...] = src.cpu().numpy()
            elif isinstance(dst, torch.Tensor) and dst.dtype == _F32:
                dst.copy_(src)
        return cu, cv

    def calc(self, I0, I1, flow):
        """Refine an (H, W, 2) flow; returns it as a tensor (and writes it
        into `flow` when that is an f32 numpy array or tensor)."""
        f = as_tensor(flow).to(_F32)
        u, v = self.calcUV(I0, I1, f[..., 0].clone(), f[..., 1].clone())
        out = torch.stack([u, v], dim=-1)
        if isinstance(flow, np.ndarray) and flow.dtype == np.float32:
            flow[...] = out.cpu().numpy()
        elif isinstance(flow, torch.Tensor) and flow.dtype == _F32:
            flow.copy_(out)
        return out

    def collectGarbage(self):
        pass


def VariationalRefinement_create():
    return VariationalRefinement()
