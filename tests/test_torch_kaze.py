"""The port's KAZE (``opencv_tpu_torch.features2d.kaze``) on the CPU against
``opencv_tpu``'s.

Exact where the JAX package computes eagerly: with ``jax.disable_jit()``
(its conductivity and FED steps then run op by op) its whole scale space,
keypoints and descriptors equal the port's; and its MSURF descriptor on the
port's own levels.  Against its jitted program (XLA contracts the FED
steps' multiply-adds) the port is held to the bound of ROADMAP.md queue C
(measured on the tracking path's frames 0-1 at 120×160: levels within
9.8e-6 of each level's largest value, every keypoint at the same level
within 3.9e-5 px, angles within 6.0e-6°, sizes within a relative 7.0e-7,
MSURF values within 1.2e-6):

- every level (Lt, Lx, Ly, Ldet) within LEVEL_RTOL of its largest |value|;
- at least KP_SHARE of each side's keypoints found on the other at the same
  class_id within KP_TOL px, angles within ANGLE_TOL degrees, sizes (from
  the refined scale) within a relative KP_TOL;
- the matched descriptors within MSURF_ATOL."""

import jax
import numpy as np
import pytest
import torch

import opencv_tpu as jcv
from opencv_tpu.features2d import kaze as jk
import opencv_tpu_torch as tcv
from opencv_tpu_torch.features2d import akaze as ta
from opencv_tpu_torch.features2d import kaze as tk

from opencv_tpu_torch import entry as E

from test_torch_akaze import (  # noqa: F401
    LEVEL_RTOL, _one_torch_thread, assert_within_bound, exact, gray)

TRACK_SHAPE = (3, 240, 320, 3)

MSURF_ATOL = 1e-5


def close_msurf(gd, wd, pairs):
    return all(float(np.abs(gd[i] - wd[j]).max()) <= MSURF_ATOL for i, j in pairs)


@pytest.fixture(scope="module")
def video():
    """tests/test_torch_slice_track.py's pan video."""
    return E.make_pan_video(TRACK_SHAPE)


@pytest.fixture(scope="module")
def frames(video):
    """The tracking path's frames 0-1 at half size (120×160)."""
    return tcv.fusedPreprocessGrayBlurDown2(torch.from_numpy(video[0][:2]), 0.0).numpy()


@pytest.fixture(scope="module")
def img(frames):
    return frames[0]


@pytest.fixture(scope="module")
def jitted(frames):
    """The JAX package's jitted KAZE on the tracking path's frames: frame 0's
    levels, its default and extended upright features, frame 1's default
    features."""
    levels = jk.KAZE_create()._scale_space(frames[0].astype(np.float32) / np.float32(255))
    out = [levels]
    for kz in (jk.KAZE_create(), jk.KAZE_create(extended=True, upright=True)):
        # detectAndCompute's steps on the one scale space
        out.append(kz._describe(levels, kz._refine(levels, kz._detect(levels))))
    out.append(jk.KAZE_create().detectAndCompute(frames[1]))
    return out


def test_track_stage_within_bound(video, jitted):
    """The tracking path's KAZE stage on frames 0-1 against the JAX
    package's KAZE on the same frames, and the L2 kNN of its match stage on
    the JAX package's descriptors against the JAX BFMatcher's."""
    out = E.forward_track(torch.from_numpy(video[0]))
    for b, want in enumerate((jitted[1], jitted[3])):
        got = (out["kaze_keypoints"][b], out["kaze_descriptors"][b])
        assert len(got[0]) > 50
        assert_within_bound(got, want, close_msurf)
    # the same pairs; the distances within 1e-4 (the JAX package takes
    # |q|² + |t|² - 2 q·t in float32, which cancels on near rows; the port's
    # cross term is a float64 product)
    q, t = jitted[1][1], jitted[3][1]
    got = tcv.BFMatcher(tcv.NORM_L2).knnMatch(q, t, 2)
    want = jcv.BFMatcher(jcv.NORM_L2).knnMatch(q, t, 2)
    assert [[(m.queryIdx, m.trainIdx) for m in r] for r in got] == \
        [[(m.queryIdx, m.trainIdx) for m in r] for r in want]
    np.testing.assert_allclose([[m.distance for m in r] for r in got],
                               [[m.distance for m in r] for r in want], rtol=0, atol=1e-4)


def test_levels_within_bound(img, jitted):
    got = tk.KAZE_create().scale_space(ta.to_float_image(torch.from_numpy(img)[None]))
    assert len(got) == len(jitted[0]) == 16
    for g, w in zip(got, jitted[0]):
        for key in ("Lt", "Lx", "Ly", "Ldet"):
            ref = w[key]
            assert g[key].dtype == torch.float32 and g[key].shape == (1, 120, 160)
            np.testing.assert_allclose(g[key][0].numpy(), ref, rtol=0,
                                       atol=LEVEL_RTOL * float(np.abs(ref).max()))
    # the first level has no FED step: exact
    for key in ("Lt", "Lx", "Ly", "Ldet"):
        np.testing.assert_array_equal(got[0][key][0].numpy(), jitted[0][0][key])


def test_detect_and_compute_within_bound(img, jitted):
    got = tcv.KAZE_create().detectAndCompute(img)
    assert len(got[0]) > 50 and got[1].shape == (len(got[0]), 64) and got[1].dtype == np.float32
    assert_within_bound(got, jitted[1], close_msurf)
    kz = tcv.KAZE_create()
    kps = kz.detect(img)
    exact(kz.compute(img, kps), got)


def test_extended_upright_within_bound(img, jitted):
    got = tcv.KAZE_create(extended=True, upright=True).detectAndCompute(img)
    assert got[1].shape == (len(got[0]), 128) and all(k.angle == 0.0 for k in got[0])
    assert_within_bound(got, jitted[2], close_msurf)


def test_msurf_equals_opencv_tpu_on_the_same_levels(img):
    """The copied host tails: the JAX package's MSURF (plain and extended)
    on the port's own levels and keypoints gives the port's descriptors."""
    kz = tk.KAZE_create()
    levels = ta.image_levels(kz.levels_on_host(torch.from_numpy(img)[None]), 0)
    kps = kz.host_detect(levels)
    _, got = kz.host_describe(levels, kps)
    lv = {i: (e["Lx"], e["Ly"]) for i, e in enumerate(levels)}
    np.testing.assert_array_equal(got, jk._msurf_descriptors(lv, kps, False, False))
    np.testing.assert_array_equal(tk._msurf_descriptors(lv, kps, True, True),
                                  jk._msurf_descriptors(lv, kps, True, True))


def test_pipeline_equals_opencv_tpu_eager():
    """With jit disabled the JAX package's arithmetic is the port's: two
    octaves of two sublevels of its scale space, its keypoints and
    descriptors equal the port's exactly."""
    im = gray((80, 120), 5)
    ref = jk.KAZE_create(threshold=0.0005, nOctaves=2, nOctaveLayers=2)
    with jax.disable_jit():
        want_levels = ref._scale_space(im.astype(np.float32) / np.float32(255))
    want = ref._describe(want_levels, ref._refine(want_levels, ref._detect(want_levels)))
    kz = tcv.KAZE_create(threshold=0.0005, nOctaves=2, nOctaveLayers=2)
    got_levels = kz.scale_space(ta.to_float_image(torch.from_numpy(im)[None]))
    assert len(got_levels) == len(want_levels) == 4
    for g, w in zip(got_levels, want_levels):
        for key in ("Lt", "Lx", "Ly", "Ldet"):
            np.testing.assert_array_equal(g[key][0].numpy(), w[key])
    got = kz.detectAndCompute(im)
    assert len(got[0]) > 10
    exact(got, want)


def test_batch_equals_per_image(img):
    batch = np.stack([img, img[::-1].copy()])
    kz = tcv.KAZE_create(threshold=0.002)
    for im, got in zip(batch, kz.detect_and_compute_batch(torch.from_numpy(batch))):
        exact(got, kz.detectAndCompute(im))


@pytest.mark.parametrize("args", [(), (True, True, 0.003, 3, 2, jk.DIFF_CHARBONNIER)])
def test_getters_equal_opencv_tpu(args):
    t, j = tcv.KAZE_create(*args), jcv.KAZE_create(*args)
    for name in ("getThreshold", "getExtended", "getUpright", "getNOctaves",
                 "getNOctaveLayers", "getDiffusivity", "descriptorSize", "descriptorType",
                 "defaultNorm"):
        assert getattr(t, name)() == getattr(j, name)(), name
    t.setThreshold(0.01)
    assert t.getThreshold() == 0.01
    assert t._plan() == j._plan()
