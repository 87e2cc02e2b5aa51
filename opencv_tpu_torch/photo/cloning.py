"""Poisson image editing (photo/src/seamless_cloning.cpp, *_impl.cpp), twin
of ``opencv_tpu/photo/cloning.py``.

The reference solves the interior Poisson equation with a discrete sine
transform built from row-wise DFTs (Cloning::dst, seamless_cloning_impl
.cpp:98).  Here the three channels' solves run together as torch on the
image's device: the sine transforms are ``torch.fft`` over odd-extended rows
in complex64 (float32, as cv2 and the JAX package compute them), the
eigenvalue division one elementwise divide, and the gradient and Laplacian
fields difference stencils.  Host code only finds the mask's bounding box.

The solve ends in the reference's truncating cast to u8
(seamless_cloning_impl.cpp:166).  The FFTs of torch on the CPU, of cuFFT and
of XLA round apart, so a pixel whose solution lies within an ulp or so of an
integer can truncate one level apart: the results agree within ±1, on the
share the tests state.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.arrays import as_tensor, to_device, to_host
from ..ops.color import cvtColor
from .. import constants as K

__all__ = ["seamlessClone", "colorChange", "illuminationChange",
           "textureFlattening", "NORMAL_CLONE", "MIXED_CLONE",
           "MONOCHROME_TRANSFER"]

NORMAL_CLONE = 1
MIXED_CLONE = 2
MONOCHROME_TRANSFER = 3


def _grad_x(img):
    """filter2D with [0,-1,1] row kernel, REFLECT_101 border, on (H, W, C):
    gx[j] = img[j+1] - img[j], last column uses the reflected sample."""
    f = img.to(torch.float32)
    return torch.cat([f[:, 1:] - f[:, :-1], f[:, -2:-1] - f[:, -1:]], dim=1)


def _grad_y(img):
    f = img.to(torch.float32)
    return torch.cat([f[1:] - f[:-1], f[-2:-1] - f[-1:]], dim=0)


def _lap_x(img):
    """[-1,1,0] kernel: l[j] = img[j] - img[j-1]; first col reflect101."""
    return torch.cat([img[:, :1] - img[:, 1:2], img[:, 1:] - img[:, :-1]], dim=1)


def _lap_y(img):
    return torch.cat([img[:1] - img[1:2], img[1:] - img[:-1]], dim=0)


def _laplacian3(p):
    """3x3 [[0,1,0],[1,-4,1],[0,1,0]] of (H, W, C) with REFLECT_101 border."""
    p = torch.cat([p[1:2], p, p[-2:-1]], dim=0)
    p = torch.cat([p[:, 1:2], p, p[:, -2:-1]], dim=1)
    four = torch.full((), 4.0, dtype=torch.float32, device=p.device)
    return (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
            - four * p[1:-1, 1:-1])


def _dst_rows(m, invert):
    """The sine transform of each row of (..., h, w), from the odd
    extension's DFT (seamless_cloning_impl.cpp:98)."""
    z = torch.zeros((*m.shape[:-1], 1), dtype=torch.float32, device=m.device)
    ext = torch.cat([z, m, z, -m.flip(-1)], dim=-1)
    f = torch.fft.ifft(ext, dim=-1) if invert else torch.fft.fft(ext, dim=-1)
    return f.imag[..., 1:m.shape[-1] + 1]


def _dst2(x, invert=False):
    """2-D sine transform of (C, h, w): rows, then the rows of the
    transpose."""
    a = _dst_rows(x, invert)
    return _dst_rows(a.transpose(-1, -2).contiguous(), invert).transpose(-1, -2)


def _poisson_solve(img_u8, lap):
    """solve() (seamless_cloning_impl.cpp:145) of each channel of (H, W, C)
    u8 and its float32 Laplacian: DST, eigenvalue divide, inverse DST,
    truncating cast, boundary copied from img."""
    h, w = img_u8.shape[:2]
    bound = img_u8.to(torch.float32)
    if h > 2 and w > 2:
        bound = bound.clone()
        bound[1:h - 1, 1:w - 1] = 0.0
    mod_diff = (lap - _laplacian3(bound))[1:h - 1, 1:w - 1].to(torch.float32)

    fx = 2.0 * np.cos(np.pi * (np.arange(w - 2) + 1) / (w - 1))
    fy = 2.0 * np.cos(np.pi * (np.arange(h - 2) + 1) / (h - 1))
    den = to_device((fx[None, :] + fy[:, None] - 4.0).astype(np.float32), img_u8.device)
    res = _dst2(mod_diff.permute(2, 0, 1)) / den
    interior = _dst2(res, invert=True).permute(1, 2, 0)

    out = img_u8.clone()
    # C-style truncation of the clipped solution
    out[1:h - 1, 1:w - 1] = torch.clamp(interior, 0.0, 255.0).to(torch.uint8)
    return out


def _erode3(mask):
    """Three 3×3 erosions of a (H, W) u8 mask with the edge replicated
    (the reference's morphology border treats outside as +inf, so edges do
    not erode inward)."""
    h, w = mask.shape
    for _ in range(3):
        p = torch.cat([mask[:1], mask, mask[-1:]], dim=0)
        p = torch.cat([p[:, :1], p, p[:, -1:]], dim=1)
        m = p[0:h, 0:w]
        for i in range(3):
            for j in range(3):
                if i or j:
                    m = torch.minimum(m, p[i:i + h, j:j + w])
        mask = m
    return mask


def _mask_weight(mask):
    m255 = torch.full((), 255.0, dtype=torch.float32, device=mask.device)
    return (_erode3(mask).to(torch.float32) / m255)[..., None]


def _solve_all(dest, lapx, lapy):
    return _poisson_solve(dest, _lap_x(lapx) + _lap_y(lapy))


def _clone_core(dest, patch, binary_mask, flags):
    """normalClone (seamless_cloning_impl.cpp:323)."""
    mF = _mask_weight(binary_mask)
    dgx, dgy = _grad_x(dest), _grad_y(dest)
    if flags == MONOCHROME_TRANSFER:
        g = cvtColor(patch, K.COLOR_BGR2GRAY)[..., None]
        pgx = _grad_x(g).expand(-1, -1, 3)
        pgy = _grad_y(g).expand(-1, -1, 3)
    else:
        pgx, pgy = _grad_x(patch), _grad_y(patch)

    if flags == MIXED_CLONE:
        use_patch = (pgx - pgy).abs() > (dgx - dgy).abs()
        pgx = torch.where(use_patch, pgx * mF, dgx * mF)
        pgy = torch.where(use_patch, pgy * mF, dgy * mF)
    else:
        pgx = pgx * mF
        pgy = pgy * mF

    one = torch.full((), 1.0, dtype=torch.float32, device=dest.device)
    dgx = dgx * (one - mF)
    dgy = dgy * (one - mF)
    return _solve_all(dest, pgx + dgx, pgy + dgy)


def _check_mask(mask, like):
    """The mask as a (H, W) u8 0/255 tensor on `like`'s device (all of the
    image when it is None or empty)."""
    if mask is None or not as_tensor(mask).numel():
        return torch.full(like.shape[:2], 255, dtype=torch.uint8, device=like.device)
    m = as_tensor(mask).to(like.device)
    if m.ndim == 3:
        m = m[..., 0]
    return torch.where(m != 0, 255, 0).to(torch.uint8)


def _masked(src, m):
    return torch.where(m[..., None] > 0, src, torch.zeros((), dtype=src.dtype, device=src.device))


def seamlessClone(src, dst, mask, p, flags: int = NORMAL_CLONE):
    """cv2.seamlessClone (photo/src/seamless_cloning.cpp:150)."""
    src = as_tensor(src)
    dest = as_tensor(dst).to(src.device)
    mask = _check_mask(mask, src)
    blend = dest.clone()

    # zero the outer ring, bbox (on the host)
    m = torch.zeros_like(mask)
    m[1:-1, 1:-1] = mask[1:-1, 1:-1]
    ys, xs = np.nonzero(to_host(m))
    if len(ys) == 0:
        return blend
    x0, x1 = xs.min(), xs.max() + 1
    y0, y1 = ys.min(), ys.max() + 1
    rw, rh = x1 - x0, y1 - y0

    l = p[0] - rw // 2
    t = p[1] - rh // 2
    dROI = dest[t:t + rh, l:l + rw]
    maskROI = m[y0:y1, x0:x1]
    srcROI = _masked(src[y0:y1, x0:x1], maskROI)

    blend[t:t + rh, l:l + rw] = _clone_core(dROI, srcROI, maskROI, flags)
    return blend


def colorChange(src, mask, red_mul=1.0, green_mul=1.0, blue_mul=1.0):
    """cv2.colorChange: NORMAL clone of src onto itself with per-channel
    gradient scaling (Cloning::localColorChange)."""
    src = as_tensor(src)
    m = _check_mask(mask, src)
    mul = to_device(np.array([blue_mul, green_mul, red_mul], np.float32), src.device)
    # gradients of the scaled patch drive the solve
    return _clone_core(src, _masked(src, m).to(torch.float32) * mul, m, NORMAL_CLONE)


def illuminationChange(src, mask, alpha=0.2, beta=0.4):
    """cv2.illuminationChange (Cloning::illuminationChange): patch
    gradients attenuated by alpha^beta * |grad|^-beta inside the mask."""
    src = as_tensor(src)
    m = _check_mask(mask, src)
    patch = _masked(src, m).to(torch.float32)
    pgx, pgy = _grad_x(patch), _grad_y(patch)
    # the JAX package's numpy arithmetic: the float32 magnitude and its
    # float32 power (each correctly rounded here), times the float64
    # alpha^beta, which makes the attenuation and the gradients float64
    mag = torch.sqrt((pgx * pgx + pgy * pgy).to(torch.float64)).to(torch.float32)
    att = np.power(float(alpha), float(beta)) * torch.pow(
        mag.to(torch.float64), -float(beta)).to(torch.float32).to(torch.float64)
    att = torch.where(torch.isfinite(att), att, torch.zeros((), dtype=att.dtype,
                                                            device=att.device))
    # feed the attenuated patch through the normal-clone pipeline by
    # reconstructing from modified gradients
    return _clone_with_gradients(src, pgx * att, pgy * att, m)


def _clone_with_gradients(dest, pgx, pgy, mask):
    mF = _mask_weight(mask)
    one = torch.full((), 1.0, dtype=torch.float32, device=dest.device)
    dgx = _grad_x(dest) * (one - mF)
    dgy = _grad_y(dest) * (one - mF)
    return _solve_all(dest, pgx * mF + dgx, pgy * mF + dgy)


def textureFlattening(src, mask, low_threshold=30, high_threshold=45,
                      kernel_size=3):
    """cv2.textureFlattening (Cloning::textureFlatten): keep patch
    gradients only where Canny fires (the port's Canny: its two Sobels are
    ``sep_filter`` k3 launches on the card, C = 3)."""
    from ..ops.canny import Canny
    src = as_tensor(src)
    m = _check_mask(mask, src)
    masked = _masked(src, m)
    edges = Canny(masked, low_threshold, high_threshold, apertureSize=kernel_size)
    e = (edges != 0)[..., None]
    patch = masked.to(torch.float32)
    return _clone_with_gradients(src, _grad_x(patch) * e, _grad_y(patch) * e, m)
