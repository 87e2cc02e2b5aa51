"""The port's background subtractors (``opencv_tpu_torch.video.bgsub``:
MOG2 and KNN) on the CPU, against ``opencv_tpu.video`` and cv2.

Over a few small frames of a shaking video with movers: against the JAX
package run under ``jax.disable_jit()`` the masks, the background images
and every state tensor are equal; against its jitted steps (XLA contracts
their multiply-adds) the masks and the background images are equal and the
states within STATE_RTOL of each value (measured 1.8e-6, a variance of
58.585; ROADMAP.md queue C).  The
KNN masks are exact either way: its random update cadences come from
numpy's ``default_rng(12345)`` in the JAX package's order.  cv2: the
reference tests' scenes and bounds (tests/test_video.py)."""

import jax
import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu_torch import entry as E
from torch_threads import _one_torch_thread  # noqa: F401

STATE_RTOL = 1e-5
N_FRAMES = 8


@pytest.fixture(scope="module")
def video():
    frames, _, _ = E.make_motion_video((N_FRAMES, 48, 64, 3))
    return frames


def _run(make_j, make_t, frames, eager, gray=False):
    js, ts = make_j(), make_t()
    out = []
    for f in frames:
        f = cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) if gray else f
        if eager:
            with jax.disable_jit():
                jm = np.asarray(js.apply(f))
        else:
            jm = np.asarray(js.apply(f))
        out.append((jm, ts.apply(torch.from_numpy(f)).numpy()))
    return js, ts, out


@pytest.mark.parametrize("eager", [True, False], ids=["eager", "jitted"])
@pytest.mark.parametrize("shadows", [True, False])
@pytest.mark.parametrize("gray", [False, True], ids=["bgr", "gray"])
def test_mog2_equals_opencv_tpu(video, eager, shadows, gray):
    js, ts, out = _run(lambda: jcv.createBackgroundSubtractorMOG2(detectShadows=shadows),
                       lambda: tcv.createBackgroundSubtractorMOG2(detectShadows=shadows),
                       video, eager, gray)
    for jm, tm in out:
        assert jm.dtype == tm.dtype == np.uint8 and np.array_equal(jm, tm)
    assert out[-1][1].max() == 255
    assert np.array_equal(np.asarray(js.getBackgroundImage()), ts.getBackgroundImage().numpy())
    for a, b in zip(js._state, ts._state):
        a, b = np.asarray(a), b.numpy()
        if eager:
            assert np.array_equal(a, b)
        else:
            np.testing.assert_allclose(b, a, rtol=STATE_RTOL, atol=1e-7)


def test_mog2_learning_rate_and_accessors(video):
    js = jcv.createBackgroundSubtractorMOG2(200, 25.0, True)
    ts = tcv.createBackgroundSubtractorMOG2(200, 25.0, True)
    for f in video[:4]:
        assert np.array_equal(np.asarray(js.apply(f, 0.2)), ts.apply(f, 0.2).numpy())
    batch = torch.from_numpy(np.stack(video[:2]))
    got = tcv.createBackgroundSubtractorMOG2().apply(batch)
    assert tuple(got.shape) == (2, 48, 64, 1)
    assert ts.getHistory() == 200 and ts.getVarThreshold() == 25.0 and ts.getDetectShadows()
    ts.setHistory(10), ts.setVarThreshold(9.0), ts.setDetectShadows(False)
    assert (ts.getHistory(), ts.getVarThreshold(), ts.getDetectShadows()) == (10, 9.0, False)
    assert tcv.createBackgroundSubtractorMOG2().getBackgroundImage() is None


@pytest.mark.parametrize("eager", [True, False], ids=["eager", "jitted"])
@pytest.mark.parametrize("shadows", [True, False])
def test_knn_equals_opencv_tpu(video, eager, shadows):
    js, ts, out = _run(lambda: jcv.createBackgroundSubtractorKNN(detectShadows=shadows),
                       lambda: tcv.createBackgroundSubtractorKNN(detectShadows=shadows),
                       video, eager)
    for jm, tm in out:
        assert jm.dtype == tm.dtype == np.uint8 and np.array_equal(jm, tm)
    assert np.array_equal(np.asarray(js.getBackgroundImage()), ts.getBackgroundImage().numpy())
    st_j, st_t = js._state, ts._state
    for key in ("flags", "idxS", "idxM", "idxL", "nextS", "nextM", "nextL"):
        assert np.array_equal(np.asarray(st_j[key]), st_t[key].numpy()), key
    a, b = np.asarray(st_j["samples"]), st_t["samples"].numpy()
    assert np.array_equal(a, b)


def test_knn_gray_learning_rate_and_accessors(video):
    js, ts = jcv.createBackgroundSubtractorKNN(100, 300.0), tcv.createBackgroundSubtractorKNN(
        100, 300.0)
    for f in video:
        g = cv2.cvtColor(f, cv2.COLOR_BGR2GRAY)
        assert np.array_equal(np.asarray(js.apply(g, 0.3)), ts.apply(torch.from_numpy(g), 0.3
                                                                      ).numpy())
    assert np.array_equal(np.asarray(js.getBackgroundImage()), ts.getBackgroundImage().numpy())
    for get, set_, v in (("getHistory", "setHistory", 7), ("getDist2Threshold",
                                                           "setDist2Threshold", 100.0),
                         ("getkNNSamples", "setkNNSamples", 3), ("getDetectShadows",
                                                                 "setDetectShadows", False),
                         ("getShadowValue", "setShadowValue", 100),
                         ("getShadowThreshold", "setShadowThreshold", 0.7),
                         ("getNSamples", "setNSamples", 5)):
        getattr(ts, set_)(v)
        assert getattr(ts, get)() == v
    assert tcv.createBackgroundSubtractorKNN().getBackgroundImage() is None


def _moving_square_frames(n=20, h=64, w=80):
    rng = np.random.default_rng(0)
    bg = rng.integers(80, 120, (h, w), np.uint8)
    frames = []
    for i in range(n):
        f = bg.copy()
        x = 10 + i
        f[20:30, x:x + 8] = 230
        frames.append(f)
    return frames


def test_mog2_matches_cv2():
    """tests/test_video.py::test_mog2_foreground's scene and bound."""
    ref = cv2.createBackgroundSubtractorMOG2(detectShadows=False)
    ours = tcv.createBackgroundSubtractorMOG2(detectShadows=False)
    for f in _moving_square_frames():
        rm = ref.apply(f)
        om = ours.apply(torch.from_numpy(f)).numpy()
    assert ((rm > 0) == (om > 0)).mean() > 0.95


def test_knn_matches_cv2():
    """tests/test_video.py::test_knn_foreground's scene and bounds."""
    rng = np.random.default_rng(3)
    H, W = 48, 64
    bg = rng.integers(80, 120, (H, W, 3), np.uint8)
    ours = tcv.createBackgroundSubtractorKNN()
    ref = cv2.createBackgroundSubtractorKNN()
    for _ in range(30):
        noise = rng.integers(-3, 4, (H, W, 3))
        frame = np.clip(bg.astype(int) + noise, 0, 255).astype(np.uint8)
        ours.apply(frame)
        ref.apply(frame)
    frame = np.clip(bg.astype(int) + rng.integers(-3, 4, (H, W, 3)), 0, 255).astype(np.uint8)
    frame[10:25, 20:35] = (250, 250, 250)
    fg_ours = ours.apply(torch.from_numpy(frame)).numpy() == 255
    fg_ref = ref.apply(frame) == 255
    assert fg_ours[12:23, 22:33].mean() > 0.95
    assert fg_ours.mean() < 0.2
    assert (fg_ours == fg_ref).mean() > 0.97
    bgimg = ours.getBackgroundImage().numpy()
    assert bgimg.shape == (H, W, 3)
    assert abs(int(bgimg[40:, 40:].mean()) - int(bg[40:, 40:].mean())) < 12
