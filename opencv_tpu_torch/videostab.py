"""videostab (modules/videostab) — video stabilization; twin of
``opencv_tpu/videostab.py``.

The reference's pipeline: per-frame global motion estimation
(keypoints + RANSAC), trajectory smoothing (GaussianMotionFilter),
and stabilizing warps.  Here: GFTT + pyramidal LK + similarity RANSAC
feed a Gaussian-smoothed trajectory; the warp chain runs through the
port's warpAffine.  The frames stay on their device: only GFTT's corners,
LK's points and status are read back, and the 3x3 motions live on the
host.  (The reference exposes this module in C++ only.)
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .core.arrays import as_tensor
from .ops.corners import goodFeaturesToTrack
from .video.lk import calcOpticalFlowPyrLK
from .calib3d.geometry import estimateAffinePartial2D
from .ops.warp import warpAffine
from . import constants as K

__all__ = ["estimateGlobalMotionRansac", "GaussianMotionFilter",
           "OnePassStabilizer", "MOTION_TRANSLATION", "MOTION_SIMILARITY",
           "STABILIZE_STAGES"]

MOTION_TRANSLATION = 0
MOTION_SIMILARITY = 2

# the stages whose host-clock ms ``OnePassStabilizer.stabilize`` gathers
# into its `times` (each stage synchronised on a CUDA device)
STABILIZE_STAGES = ("corners", "klt", "ransac", "filter", "warp")


class _Clock:
    """Host-clock ms by stage into `times` (None: no timing, no sync)."""

    def __init__(self, times, device):
        self.times = times
        self.sync = times is not None and device.type == "cuda"
        self.t0 = time.perf_counter()
        if times is not None:
            for name in STABILIZE_STAGES:
                times.setdefault(name, 0.0)

    def lap(self, name):
        if self.times is None:
            return
        if self.sync:
            torch.cuda.synchronize()
        t = time.perf_counter()
        self.times[name] += (t - self.t0) * 1e3
        self.t0 = t


def estimateGlobalMotionRansac(prev, curr, model=MOTION_SIMILARITY, _clock=None):
    """Global inter-frame motion as a 3x3 matrix (videostab
    global_motion.cpp role): ``(M, ok)``, M a host f64 array."""
    clock = _clock or _Clock(None, torch.device("cpu"))
    p0 = goodFeaturesToTrack(prev, 300, 0.01, 8)
    clock.lap("corners")
    if p0 is None or len(p0) < 8:
        return np.eye(3), False
    p1, st, _ = calcOpticalFlowPyrLK(prev, curr, p0, None)
    clock.lap("klt")
    good = st.ravel() > 0
    a = p0.reshape(-1, 2)[good]
    b = p1.reshape(-1, 2)[good]
    if len(a) < 8:
        return np.eye(3), False
    if model == MOTION_TRANSLATION:
        t = np.median(b - a, axis=0)
        M = np.array([[1, 0, t[0]], [0, 1, t[1]], [0, 0, 1.0]])
        clock.lap("ransac")
        return M, True
    A, _ = estimateAffinePartial2D(a, b)
    clock.lap("ransac")
    if A is None:
        return np.eye(3), False
    return np.vstack([A, [0, 0, 1]]), True


class GaussianMotionFilter:
    def __init__(self, radius=15, stdev=-1.0):
        self.radius = radius
        self.stdev = stdev if stdev > 0 else np.sqrt(radius)

    def stabilize(self, idx, motions, frame_range):
        """Smoothed correction at frame idx given inter-frame motions
        (list of 3x3, motions[i]: frame i -> i+1)."""
        lo, hi = frame_range
        # cumulative positions relative to idx
        weights = []
        mats = []
        for j in range(max(lo, idx - self.radius),
                       min(hi, idx + self.radius + 1)):
            w = np.exp(-0.5 * ((j - idx) / self.stdev) ** 2)
            M = np.eye(3)
            if j > idx:
                for k in range(idx, j):
                    M = motions[k] @ M
            elif j < idx:
                for k in range(j, idx):
                    M = np.linalg.inv(motions[k]) @ M
            weights.append(w)
            mats.append(M)
        weights = np.asarray(weights)
        weights /= weights.sum()
        avg = sum(w * M for w, M in zip(weights, mats))
        return avg


class OnePassStabilizer:
    def __init__(self, radius=15, model=MOTION_SIMILARITY):
        self.filter = GaussianMotionFilter(radius)
        self.model = model
        self.motions = []

    def stabilize(self, frames, times=None):
        """Stabilize a sequence of frames (tensors on one device, or host
        arrays); returns the warped frames as tensors on their device.  The
        inter-frame motions (host 3x3) are kept in ``self.motions``;
        `times` (if given) gathers the host-clock ms of
        :data:`STABILIZE_STAGES`."""
        frames = [as_tensor(f) for f in frames]
        clock = _Clock(times, frames[0].device)
        n = len(frames)
        motions = []
        for i in range(n - 1):
            M, ok = estimateGlobalMotionRansac(frames[i], frames[i + 1],
                                               self.model, _clock=clock)
            motions.append(M if ok else np.eye(3))
        self.motions = motions
        clock.lap("ransac")
        corrections = [self.filter.stabilize(i, motions, (0, n)) for i in range(n)]
        clock.lap("filter")
        H, W = frames[0].shape[:2]
        out = [warpAffine(f, S[:2].astype(np.float32), (W, H),
                          borderMode=K.BORDER_REPLICATE)
               for f, S in zip(frames, corrections)]
        clock.lap("warp")
        return out
