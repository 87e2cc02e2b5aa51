"""The call into the program for ``resize_warp_4k``:
``opencv_tpu_torch.entry.forward_resize_warp_4k`` (resize to half size
with INTER_LINEAR, INTER_AREA and INTER_CUBIC, warpAffine and
warpPerspective at full size, three int32 totals), and its warpAffine
stage as the public cv2-named call.

The inputs are uniform random u8 frames.  Every op does the same work
whatever the pixels are (no data-dependent control flow), so noise frames
are a fair load."""

from __future__ import annotations

import opencv_tpu_torch as tcv
from opencv_tpu_torch import entry

OUTPUTS = ("linear", "area", "cubic", "affine", "perspective", "totals")


def call(x):
    return entry.forward_resize_warp_4k(x)


def outputs(out) -> dict:
    return dict(zip(OUTPUTS, out))


def stages(cfg: dict, x) -> dict:
    """``warp``: warpAffine of this batch `x` at its own size."""
    h, w = x.shape[1], x.shape[2]
    M = tcv.getRotationMatrix2D((w / 2, h / 2), cfg["warp"]["angle_deg"], cfg["warp"]["scale"])
    return {"warp": lambda: tcv.warpAffine(x, M, (w, h))}
