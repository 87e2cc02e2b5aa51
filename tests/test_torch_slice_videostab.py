"""The stabilisation path, ``entry.forward_videostab``, on a cut of
``entry.make_motion_video`` (7 frames at 160 x 200, radius 3) on the CPU:
the gray frames equal cvtColor's, each inter-frame motion's displacement at
the frame's centre within 0.25 px of the video's shift difference, the
stabilised jitter under the input's / 2.5 (under the port's phaseCorrelate,
which the report uses, and cv2's, which tests/test_video.py uses), and one
pair's motion and one frame's warp against the JAX package's under
tests/test_torch_videostab.py's tolerances."""

import numpy as np
import pytest
import torch

import opencv_tpu as jcv
from opencv_tpu import videostab as jvs
import opencv_tpu_torch as tcv
from opencv_tpu_torch import entry as E
from test_torch_videostab import MOTION_TOL, _corner_err, _jitter_std, _warp_close
from torch_threads import _one_torch_thread  # noqa: F401

SHIFT_TOL = 0.25
SHAPE = (7, 160, 200, 3)


def test_forward_videostab_on_a_motion_video_cut():
    shape = SHAPE
    frames, shifts, _ = E.make_motion_video(shape)
    fwd, (x,) = E.entry_videostab("cpu", shape)
    assert fwd is E.forward_videostab and torch.equal(x, torch.from_numpy(frames))
    times = {}
    out = E.forward_videostab(torch.from_numpy(frames), radius=3, times=times)
    assert set(times) == set(E.VIDEOSTAB_STAGES)
    assert out["stabilized"].shape == shape[:3] and out["motions"].shape == (6, 3, 3)
    gray = tcv.cvtColor(torch.from_numpy(frames), tcv.COLOR_BGR2GRAY)[..., 0]
    assert torch.equal(out["gray"], gray)
    rep = E.videostab_truth_report(out, shifts, shape)
    assert rep["translation_err"] <= SHIFT_TOL, rep
    assert rep["jitter_gain"] > E.VIDEOSTAB_JITTER_GAIN, rep
    g = out["gray"].numpy()
    # the JAX package's motion of one pair, and its warp of the middle frame
    want, ok = jvs.estimateGlobalMotionRansac(g[2], g[3])
    assert ok and _corner_err(out["motions"][2], want, g[0].shape) <= MOTION_TOL
    S = out["corrections"][3]
    _warp_close(out["stabilized"][3], jcv.warpAffine(g[3], S[:2].astype(np.float32), (200, 160),
                                                     borderMode=jcv.BORDER_REPLICATE))
    # the gate holds under test_video.py's measure (cv2.phaseCorrelate) too,
    # and the report's measure is the port's phaseCorrelate pair by pair
    st = out["stabilized"].numpy()
    assert _jitter_std(list(st)) < _jitter_std(list(g)) / E.VIDEOSTAB_JITTER_GAIN
    js = [np.hypot(*tcv.phaseCorrelate(a[20:-20, 20:-20].astype(np.float32),
                                       b[20:-20, 20:-20].astype(np.float32))[0])
          for a, b in zip(st[:-1], st[1:])]
    assert rep["jitter_out"] == pytest.approx(np.std(js), rel=1e-9)
