"""Image inpainting (photo/src/inpaint.cpp Telea / Navier-Stokes), twin of
``opencv_tpu/photo/inpaint.py``.

The JAX package's iterative neighbourhood diffusion restricted to the mask,
as torch on the image's device: each iteration averages the filled 3×3
neighbours (the same neighbour order, the same ``max(wacc, 1e-9)`` divide)
into the hole, until the hole is filled and the radius' iterations have
run.  The result equals the JAX package's exactly.

Host syncs: the mask's size once (the iteration cap), and ``filled.all()``
once per iteration from iteration ``4 * inpaintRadius + 1`` on, the only
iterations where the stop rule can fire (the JAX package reads it at the
top of every iteration too, and ignores it there).
"""

from __future__ import annotations

import torch

from .. import constants as K
from ..core.arrays import as_tensor
from ..core.borders import pad_nhwc
from ..core.fixedpoint import saturate_cast

INPAINT_NS = 0
INPAINT_TELEA = 1

__all__ = ["inpaint", "INPAINT_NS", "INPAINT_TELEA"]


def _edge_pad(x: torch.Tensor) -> torch.Tensor:
    """(H, W, C) → (H + 2, W + 2, C), the edge replicated (np.pad "edge")."""
    return pad_nhwc(x[None], 1, 1, 1, 1, K.BORDER_REPLICATE)[0]


def inpaint(src, inpaintMask, inpaintRadius: float = 3.0,
            flags: int = INPAINT_TELEA):
    src = as_tensor(src)
    img = src.to(torch.float32)
    mask = as_tensor(inpaintMask).to(src.device) != 0
    out = img[..., None] if img.ndim == 2 else img.clone()
    H, W = out.shape[:2]
    filled = ~mask
    n_iter = 4 * int(max(int(mask.sum()) ** 0.5, 8))
    tiny = torch.full((), 1e-9, dtype=torch.float32, device=src.device)
    for it in range(n_iter):
        p = _edge_pad(out)
        kf = _edge_pad(filled.to(torch.float32)[..., None])
        acc = torch.zeros_like(out)
        wacc = torch.zeros((H, W, 1), dtype=torch.float32, device=src.device)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                k = kf[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
                acc = acc + p[1 + dy:1 + dy + H, 1 + dx:1 + dx + W] * k
                wacc = wacc + k
        upd = mask & (wacc[..., 0] > 0)
        vals = acc / torch.maximum(wacc, tiny)
        out = torch.where(upd[..., None], vals, out)
        filled = filled | upd
        if it > int(inpaintRadius) * 4 and bool(filled.all()):
            break
    out = out[..., 0] if src.ndim == 2 else out
    if src.dtype == torch.uint8:
        out = saturate_cast(out, torch.uint8)
    return out
