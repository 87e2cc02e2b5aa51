"""Plain reference of ``resize_warp_4k``: resize to half size with
INTER_LINEAR, INTER_AREA and INTER_CUBIC, warpAffine (the configuration's
angle and scale about the centre) and warpPerspective (its homography) at
full size, and the three int32 totals (the resizes together, then each
warp)."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import common


def forward(x: torch.Tensor, cfg: dict, low: str = "") -> dict:
    """(N, H, W, C) u8 -> {linear, area, cubic, affine, perspective, totals}."""
    H, W = x.shape[1], x.shape[2]
    linear = common.half_area(x)
    area = linear.clone()
    cubic = common.half_cubic(x)
    M = common.rotation_matrix((W / 2, H / 2), cfg["warp"]["angle_deg"], cfg["warp"]["scale"])
    affine = common.warp_affine(x, M, (W, H), low=low)
    persp = common.warp_perspective(x, np.array(cfg["perspective"], np.float64), (W, H), low=low)
    sums = [int(t.sum(dtype=torch.int64)) for t in (linear, area, cubic, affine, persp)]
    totals = torch.tensor([common.wrap_int32(sums[0] + sums[1] + sums[2]),
                           common.wrap_int32(sums[3]), common.wrap_int32(sums[4])],
                          dtype=torch.int32)
    return {"linear": linear, "area": area, "cubic": cubic, "affine": affine,
            "perspective": persp, "totals": totals}
