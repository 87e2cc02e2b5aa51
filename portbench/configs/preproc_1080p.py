"""The call into the program for ``preproc_1080p``: the flagship,
``opencv_tpu_torch.entry.forward`` (BGR -> gray, GaussianBlur 5x5 through
``sep_filter``'s CUDA k5, INTER_LINEAR resize to half size, warpAffine),
and its stages as the public cv2-named calls it composes.

The inputs are uniform random u8 frames.  Every op of the pipeline does
the same work whatever the pixels are (no data-dependent control flow), so
noise frames are a fair load."""

from __future__ import annotations

import opencv_tpu_torch as tcv
from opencv_tpu_torch import entry


def call(x):
    return entry.forward(x)


def outputs(out) -> dict:
    return {"warped": out}


def stages(cfg: dict, x) -> dict:
    """The stages that per-layer metrics time alone, on this batch `x`:
    ``blur`` on its gray plane and ``warp`` on its resized plane."""
    h, w = x.shape[1] // 2, x.shape[2] // 2
    gray = tcv.cvtColor(x, tcv.COLOR_BGR2GRAY)
    small = tcv.resize(tcv.GaussianBlur(gray, (5, 5), 0), (w, h))
    M = tcv.getRotationMatrix2D((w / 2, h / 2), cfg["warp"]["angle_deg"], cfg["warp"]["scale"])
    return {"blur": lambda: tcv.GaussianBlur(gray, (5, 5), 0),
            "warp": lambda: tcv.warpAffine(small, M, (w, h))}
