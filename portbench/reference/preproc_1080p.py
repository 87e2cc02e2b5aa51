"""Plain reference of ``preproc_1080p``: BGR -> gray, GaussianBlur 5x5,
half-size INTER_LINEAR resize, warpAffine (the configuration's angle and
scale about the centre) at the resized size."""

from __future__ import annotations

import torch

from portbench.reference import common


def forward(x: torch.Tensor, cfg: dict, low: str = "") -> dict:
    """(N, H, W, 3) u8 -> {"warped": (N, H/2, W/2, 1) u8}."""
    r = common.half_area(common.gauss5(common.gray(x)))
    h, w = r.shape[1], r.shape[2]
    M = common.rotation_matrix((w / 2, h / 2), cfg["warp"]["angle_deg"], cfg["warp"]["scale"])
    return {"warped": common.warp_affine(r, M, (w, h), low=low)}
