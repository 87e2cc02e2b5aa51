"""Optical-flow utilities: LK pyramid construction and Middlebury .flo
file IO (video/src/lkpyramid.cpp:747 buildOpticalFlowPyramid,
optical_flow_io.cpp read/writeOpticalFlow); twin of
``opencv_tpu/video/flow_utils.py``.

The levels are the port's u8 ``pyrDown`` (the ``pyr_down`` kernel on a CUDA
tensor) and the derivative pair the port's Scharr into CV_16S, both on the
input's device; the pyramid is a list of tensors there.  The winSize padding
the reference keeps around each level is an implementation detail of its LK
window reads and is not returned."""

from __future__ import annotations

import struct

import numpy as np
import torch

from .. import constants as K
from ..core.arrays import as_tensor, to_host
from ..ops.deriv import Scharr
from ..ops.pyramids import pyrDown

__all__ = ["buildOpticalFlowPyramid", "readOpticalFlow", "writeOpticalFlow"]

_FLO_MAGIC = 202021.25  # "PIEH" interpreted as a little-endian float


def buildOpticalFlowPyramid(img, winSize, maxLevel: int,
                            pyramid=None, withDerivatives: bool = True,
                            pyrBorder: int = K.BORDER_REFLECT_101,
                            derivBorder: int = K.BORDER_CONSTANT,
                            tryReuseInputImage: bool = True):
    """cv::buildOpticalFlowPyramid (lkpyramid.cpp:747).

    Returns (retval, pyramid): retval is the deepest level actually built;
    pyramid alternates level images and (h, w, 2·C) int16 Scharr derivative
    maps (dx, dy interleaved per channel) when withDerivatives is set.
    Levels stop early once the next level would not exceed winSize in both
    dimensions."""
    a = as_tensor(img)
    if a.dtype != torch.uint8:
        raise ValueError("buildOpticalFlowPyramid expects 8-bit input")
    wx, wy = int(winSize[0]), int(winSize[1])
    out = []
    level_img = a
    sz = (a.shape[1], a.shape[0])
    ret = maxLevel
    for level in range(maxLevel + 1):
        if level != 0:
            level_img = pyrDown(level_img, borderType=pyrBorder)
        out.append(level_img)
        if withDerivatives:
            # lkpyramid.cpp:59 calcScharrDeriv: unnormalized Scharr
            # (3,10,3)x(-1,0,1), REFLECT_101 borders, dx/dy interleaved
            dx = Scharr(level_img, K.CV_16S, 1, 0, borderType=K.BORDER_REFLECT_101)
            dy = Scharr(level_img, K.CV_16S, 0, 1, borderType=K.BORDER_REFLECT_101)
            if dx.ndim == 2:
                deriv = torch.stack([dx, dy], dim=-1)
            else:
                deriv = torch.stack([dx, dy], dim=-1).reshape(*dx.shape[:2], -1)
            out.append(deriv.to(torch.int16))
        sz = ((sz[0] + 1) // 2, (sz[1] + 1) // 2)
        if sz[0] <= wx or sz[1] <= wy:
            ret = level
            break
    return ret, out


def readOpticalFlow(path: str):
    """cv::readOpticalFlow — Middlebury .flo reader.  Returns an (H, W, 2)
    float32 numpy array, or None on malformed input."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
        magic, w, h = struct.unpack("<fii", raw[:12])
        if abs(magic - _FLO_MAGIC) > 1e-3 or w <= 0 or h <= 0:
            return None
        body = np.frombuffer(raw, np.float32, count=h * w * 2, offset=12)
        return body.reshape(h, w, 2).copy()
    except (OSError, struct.error, ValueError):
        return None


def writeOpticalFlow(path: str, flow) -> bool:
    """cv::writeOpticalFlow — Middlebury .flo writer (CV_32FC2); the flow
    may be a tensor on any device."""
    a = to_host(flow).astype(np.float32)
    if a.ndim != 3 or a.shape[2] != 2:
        return False
    h, w = a.shape[:2]
    try:
        with open(path, "wb") as f:
            f.write(struct.pack("<fii", _FLO_MAGIC, w, h))
            f.write(np.ascontiguousarray(a).tobytes())
        return True
    except OSError:
        return False
