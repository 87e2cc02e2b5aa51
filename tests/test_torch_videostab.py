"""opencv_tpu_torch.videostab against opencv_tpu.videostab and the
stabilisation criterion of tests/test_video.py, on the CPU.

The module is the JAX package's, copied, over the port's GFTT, LK,
estimateAffinePartial2D and warpAffine.  On test_video.py's 14-frame
160 x 200 scene (tests/test_torch_slice_videostab.py holds the path on a
cut of ``entry.make_motion_video``):

- each inter-frame motion (the JAX package's estimateGlobalMotionRansac on
  the same frames) within MOTION_TOL px at the frame's corners: LK's
  points agree within the video tests' LK_TOL (1e-3 px) once XLA's fused
  multiply-adds are counted (ROADMAP C), and a similarity fitted over the
  frame's corners moves a few times its points' error;
- GaussianMotionFilter equal (host numpy in both);
- each stabilised frame within the warp bound of the JAX package's
  warpAffine of the same frame by the same correction (±1 on at most 0.1%
  of pixels: the port's coordinates are f64, the JAX package's
  double-float);
- the jitter gate: the stabilised frame-to-frame jitter's std under the
  input's / 2.5."""

import numpy as np
import pytest
import torch

from common import cv2

from opencv_tpu import videostab as jvs
import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu_torch import videostab as tvs
from torch_threads import _one_torch_thread  # noqa: F401

MOTION_TOL = 1e-2
WARP_ATOL, WARP_MAX_FRACTION = 1, 1e-3


def _scene():
    """test_video.py::test_videostab_one_pass's frames."""
    rng = np.random.default_rng(0)
    base = cv2.GaussianBlur(rng.integers(0, 256, (160, 200), np.uint8), (0, 0), 2)
    frames = []
    for i in range(14):
        dx = 1.5 * i + rng.normal(0, 2.5)
        dy = rng.normal(0, 2.5)
        M = np.float32([[1, 0, dx], [0, 1, dy]])
        frames.append(cv2.warpAffine(base, M, (200, 160), borderMode=cv2.BORDER_REPLICATE))
    return frames


def _jitter_std(seq):
    js = []
    for a, b in zip(seq[:-1], seq[1:]):
        s, _ = cv2.phaseCorrelate(np.asarray(a)[20:-20, 20:-20].astype(np.float32),
                                  np.asarray(b)[20:-20, 20:-20].astype(np.float32))
        js.append(np.hypot(s[0], s[1]))
    return np.std(js)


def _corner_err(A, B, shape):
    H, W = shape[:2]
    c = np.array([[0, 0, 1], [W - 1, 0, 1], [0, H - 1, 1], [W - 1, H - 1, 1]], np.float64).T
    return float(np.abs((np.asarray(A) - np.asarray(B)) @ c)[:2].max())


def _warp_close(got, want):
    d = np.abs(np.asarray(got).astype(np.int32) - np.asarray(want).astype(np.int32))
    assert d.max() <= WARP_ATOL and np.count_nonzero(d) <= WARP_MAX_FRACTION * d.size, \
        (int(d.max()), int(np.count_nonzero(d)))


def test_one_pass_on_the_test_video_scene():
    frames = _scene()
    stab = tvs.OnePassStabilizer(radius=5)
    times = {}
    out = stab.stabilize(frames, times)
    assert set(times) == set(tvs.STABILIZE_STAGES)
    assert len(out) == 14 and all(isinstance(o, torch.Tensor) and o.dtype == torch.uint8
                                  and o.shape == (160, 200) for o in out)
    assert _jitter_std(out) < _jitter_std(frames) / 2.5
    # the motion against the JAX package's on the same pair (the JAX
    # package's LK compiles for each count of corners)
    want, ok = jvs.estimateGlobalMotionRansac(frames[0], frames[1])
    assert ok
    assert _corner_err(stab.motions[0], want, frames[0].shape) <= MOTION_TOL
    # the filter on the same motions, and the warps by the same corrections
    jf = jvs.GaussianMotionFilter(5)
    for i in (0, 7, 13):
        S = stab.filter.stabilize(i, stab.motions, (0, 14))
        np.testing.assert_array_equal(S, jf.stabilize(i, stab.motions, (0, 14)))
        want = jcv.warpAffine(frames[i], S[:2].astype(np.float32), (200, 160),
                              borderMode=jcv.BORDER_REPLICATE)
        _warp_close(out[i], want)


def test_global_motion_models_and_tensors():
    frames = _scene()
    a, b = frames[0], frames[1]
    for model in (tvs.MOTION_TRANSLATION, tvs.MOTION_SIMILARITY):
        got, ok = tvs.estimateGlobalMotionRansac(torch.from_numpy(a), torch.from_numpy(b), model)
        want, okj = jvs.estimateGlobalMotionRansac(a, b, model)
        assert ok and okj and got.shape == (3, 3)
        assert _corner_err(got, want, a.shape) <= MOTION_TOL
    # too few corners: the identity, as the JAX package returns
    flat = np.full((40, 50), 90, np.uint8)
    M, ok = tvs.estimateGlobalMotionRansac(flat, flat)
    Mj, okj = jvs.estimateGlobalMotionRansac(flat, flat)
    assert (ok, okj) == (False, False)
    np.testing.assert_array_equal(M, Mj)
