"""Plain PyTorch versions of the cv2 operations the benchmark's pipelines
run, written from OpenCV's definitions and independent of the program
under test (no import of it, nothing it made).

Every function takes and returns NHWC tensors on any device.  The u8
arithmetic is OpenCV's:

- ``COLOR_BGR2GRAY``: Q15 coefficients 9798, 19235, 3735 (they sum to
  2^15), ``(acc + 2^14) >> 15``;
- ``GaussianBlur((5, 5), 0)`` on u8: the bit-exact Q8 taps 16, 64, 96, 64,
  16 in both directions, ``(acc + 2^15) >> 16``, BORDER_REFLECT_101;
- ``resize`` to exactly half size: INTER_LINEAR at an exact 2x falls to
  INTER_AREA's integer path, ``(a + b + c + d + 2) >> 2``; INTER_CUBIC
  takes the Q11 taps of A = -0.75 at the fraction 0.5 (-192, 1216, 1216,
  -192), the source index clamped, ``(acc + 2^21) >> 22``;
- ``warpAffine`` / ``warpPerspective`` with INTER_LINEAR and
  BORDER_CONSTANT 0: the source coordinate in float64, its floor and its
  fraction in float32, float32 weights and blend, round half to even,
  taps outside the image read 0.

``low`` names a control, the reference one precision down:
``"coords"`` computes the warps' coordinates in float32 (for float64),
``"all"`` also the weights and blend in bfloat16 (for float32).  The
integer stages are exact in every one.
"""

from __future__ import annotations

import math

import numpy as np
import torch

GRAY_Q15 = (3735, 19235, 9798)            # B, G, R
GAUSS5_Q8 = (16, 64, 96, 64, 16)
CUBIC_HALF_Q11 = (-192, 1216, 1216, -192)
# (coordinates, weights and blend) as the configuration states them, and
# in each control
PRECISION = {"": (torch.float64, torch.float32),
             "coords": (torch.float32, torch.float32),
             "all": (torch.float32, torch.bfloat16)}


def gray(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) BGR u8 -> (N, H, W, 1) u8."""
    xi = x.to(torch.int32)
    b, g, r = GRAY_Q15
    acc = xi[..., 0] * b + xi[..., 1] * g + xi[..., 2] * r
    return ((acc + (1 << 14)) >> 15).to(torch.uint8)[..., None]


def _taps_along(v: torch.Tensor, dim: int, taps, pad: int, mode: str) -> torch.Tensor:
    """Correlate int32 `v` with integer `taps` along `dim` (1 = rows, 2 =
    columns of an (N, H, W, C) tensor); `mode` 'reflect' (REFLECT_101) or
    'clamp' (the index held at the edge)."""
    n = v.shape[dim]
    idx = torch.arange(-pad, n + pad, device=v.device)
    if mode == "reflect":
        idx = idx.abs()
        idx = torch.where(idx >= n, 2 * (n - 1) - idx, idx)
    else:
        idx = idx.clamp(0, n - 1)
    padded = v.index_select(dim, idx)
    out = None
    for k, t in enumerate(taps):
        term = padded.narrow(dim, k, n) * t
        out = term if out is None else out + term
    return out


def gauss5(g: torch.Tensor) -> torch.Tensor:
    """GaussianBlur((5, 5), 0) of an (N, H, W, C) u8 tensor."""
    v = _taps_along(g.to(torch.int32), 2, GAUSS5_Q8, 2, "reflect")
    v = _taps_along(v, 1, GAUSS5_Q8, 2, "reflect")
    return ((v + (1 << 15)) >> 16).clamp(0, 255).to(torch.uint8)


def half_area(x: torch.Tensor) -> torch.Tensor:
    """INTER_AREA (and INTER_LINEAR) to exactly half size, u8."""
    xi = x.to(torch.int32)
    s = xi[:, 0::2, 0::2] + xi[:, 0::2, 1::2] + xi[:, 1::2, 0::2] + xi[:, 1::2, 1::2]
    return ((s + 2) >> 2).to(torch.uint8)


def half_cubic(x: torch.Tensor) -> torch.Tensor:
    """INTER_CUBIC to exactly half size, u8: output column j reads source
    columns 2j-1 .. 2j+2 (held at the edges), and rows likewise."""
    xi = x.to(torch.int32)
    N, H, W, C = x.shape
    out = None
    cols = torch.arange(W // 2, device=x.device) * 2
    for k, t in enumerate(CUBIC_HALF_Q11):
        term = xi.index_select(2, (cols + k - 1).clamp(0, W - 1)) * t
        out = term if out is None else out + term
    rows = torch.arange(H // 2, device=x.device) * 2
    v = None
    for k, t in enumerate(CUBIC_HALF_Q11):
        term = out.index_select(1, (rows + k - 1).clamp(0, H - 1)) * t
        v = term if v is None else v + term
    return ((v + (1 << 21)) >> 22).clamp(0, 255).to(torch.uint8)


def rotation_matrix(center, angle_deg: float, scale: float) -> np.ndarray:
    """The forward 2x3 map of ``getRotationMatrix2D``."""
    a = scale * math.cos(math.radians(angle_deg))
    b = scale * math.sin(math.radians(angle_deg))
    cx, cy = center
    return np.array([[a, b, (1 - a) * cx - b * cy], [-b, a, b * cx + (1 - a) * cy]])


def invert_affine(M: np.ndarray) -> np.ndarray:
    """The inverse of a 2x3 affine map (the destination-to-source map)."""
    A = np.vstack([M, [0.0, 0.0, 1.0]])
    return np.linalg.inv(A)[:2]


def _coords(rows, cols, row_part, col_part, dtype):
    """The (dh, dw) plane ``row_part(y) + col_part(x)`` in `dtype`."""
    return row_part(rows)[:, None].to(dtype) + col_part(cols)[None, :].to(dtype)


def _bilinear(x: torch.Tensor, mx: torch.Tensor, my: torch.Tensor, wdt) -> torch.Tensor:
    """Sample (N, H, W, C) u8 `x` at the (dh, dw) source coordinates with
    weights and blend in `wdt`, BORDER_CONSTANT 0, one frame at a time."""
    N, H, W, C = x.shape
    x0f, y0f = torch.floor(mx), torch.floor(my)
    fx, fy = (mx - x0f).to(wdt), (my - y0f).to(wdt)
    x0 = x0f.clamp(-2, W + 1).to(torch.int64)
    y0 = y0f.clamp(-2, H + 1).to(torch.int64)
    one = torch.ones((), dtype=wdt, device=x.device)
    weights = [((one - fx) * (one - fy)), (fx * (one - fy)), ((one - fx) * fy), (fx * fy)]
    taps = []
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        xi, yi = x0 + dx, y0 + dy
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        taps.append(((yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(-1), inside))
    out = torch.empty((N, *mx.shape, C), dtype=torch.uint8, device=x.device)
    for n in range(N):
        flat = x[n].reshape(H * W, C)
        acc = None
        for (idx, inside), w in zip(taps, weights):
            t = flat.index_select(0, idx).reshape(*mx.shape, C).to(wdt)
            t = torch.where(inside[..., None], t, torch.zeros((), dtype=wdt, device=x.device))
            term = t * w[..., None]
            acc = term if acc is None else acc + term
        out[n] = torch.round(acc.float()).clamp(0, 255).to(torch.uint8)
    return out


def warp_affine(x: torch.Tensor, M: np.ndarray, dsize, low: str = "") -> torch.Tensor:
    """``warpAffine(x, M, dsize)``, INTER_LINEAR, BORDER_CONSTANT 0; `M`
    the forward map, `dsize` (width, height)."""
    m = invert_affine(np.asarray(M, np.float64)).ravel()
    dw, dh = dsize
    cdt, wdt = PRECISION[low]
    dev = x.device
    rows = torch.arange(dh, dtype=torch.float64, device=dev)
    cols = torch.arange(dw, dtype=torch.float64, device=dev)
    mx = _coords(rows, cols, lambda y: m[1] * y + m[2], lambda c: m[0] * c, cdt)
    my = _coords(rows, cols, lambda y: m[4] * y + m[5], lambda c: m[3] * c, cdt)
    return _bilinear(x, mx, my, wdt)


def warp_perspective(x: torch.Tensor, P: np.ndarray, dsize, low: str = "") -> torch.Tensor:
    """``warpPerspective(x, P, dsize)``, INTER_LINEAR, BORDER_CONSTANT 0;
    `P` the forward 3x3 map.  A zero denominator maps to the coordinate 0."""
    m = np.linalg.inv(np.asarray(P, np.float64)).ravel()
    dw, dh = dsize
    cdt, wdt = PRECISION[low]
    dev = x.device
    rows = torch.arange(dh, dtype=torch.float64, device=dev)
    cols = torch.arange(dw, dtype=torch.float64, device=dev)
    xn = _coords(rows, cols, lambda y: m[1] * y + m[2], lambda c: m[0] * c, cdt)
    yn = _coords(rows, cols, lambda y: m[4] * y + m[5], lambda c: m[3] * c, cdt)
    wd = _coords(rows, cols, lambda y: m[7] * y + m[8], lambda c: m[6] * c, cdt)
    zero = wd == 0
    wsafe = torch.where(zero, torch.ones_like(wd), wd)
    mx = torch.where(zero, torch.zeros_like(xn), xn / wsafe)
    my = torch.where(zero, torch.zeros_like(yn), yn / wsafe)
    return _bilinear(x, mx, my, wdt)


def wrap_int32(v: int) -> int:
    """A sum as the int32 that holds it modulo 2^32."""
    return (int(v) + 2 ** 31) % 2 ** 32 - 2 ** 31
