"""The port's StereoBM, StereoSGBM and filterSpeckles
(``opencv_tpu_torch/calib3d/stereo.py``, ``misc3d.py``, the native
``filter_speckles_i32``) against ``opencv_tpu`` and cv2.

All exact: every stage is integer.  The grids are tests/test_calib3d.py's
(:151-245) with each prefilter, SGBM mode, a negative and a positive
minDisparity and the speckle pass, plus the first-minimum rule of the
winner on a tie, and a CUDA-free check that a tensor stays a tensor."""

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu.calib3d import misc3d as jmisc
from opencv_tpu_torch import native
from opencv_tpu_torch.calib3d import misc3d as tmisc
from opencv_tpu_torch.calib3d import stereo as tstereo
from opencv_tpu.calib3d import stereo as jstereo

from torch_threads import _one_torch_thread  # noqa: F401


def _bm_pair():
    rng = np.random.default_rng(2)
    base = (cv2.GaussianBlur(rng.random((64, 160)).astype(np.float32), (0, 0), 1.5)
            * 255).astype(np.uint8)
    return np.roll(base, 8, axis=1), base


BM_CASES = [dict(nd=32, bs=9), dict(nd=32, bs=25), dict(nd=32, bs=9, mindisp=4),
            dict(nd=32, bs=9, mindisp=-2), dict(nd=32, bs=9, pftype=0, pfsize=21),
            dict(nd=32, bs=9, speckle=(50, 16)), dict(nd=48, bs=7, pftype=0, pfsize=9,
                                                      mindisp=-5, speckle=(30, 8))]


def _configure(obj, c):
    if "mindisp" in c:
        obj.setMinDisparity(c["mindisp"])
    if "speckle" in c:
        obj.setSpeckleWindowSize(c["speckle"][0])
        obj.setSpeckleRange(c["speckle"][1])
    if "pftype" in c:
        obj.setPreFilterType(c["pftype"])
    if "pfsize" in c:
        obj.setPreFilterSize(c["pfsize"])
    return obj


@pytest.mark.parametrize("case", range(len(BM_CASES)))
def test_stereo_bm_equals_opencv_tpu_and_cv2(case):
    c = BM_CASES[case]
    left, right = _bm_pair()
    ours = _configure(tcv.StereoBM_create(c["nd"], c["bs"]), c).compute(
        torch.from_numpy(left), torch.from_numpy(right))
    assert isinstance(ours, torch.Tensor) and ours.dtype == torch.int16
    ref = _configure(jcv.StereoBM_create(c["nd"], c["bs"]), c).compute(left, right)
    assert np.array_equal(ours.numpy(), ref)
    want = _configure(cv2.StereoBM_create(c["nd"], c["bs"]), c).compute(left, right)
    assert np.array_equal(ours.numpy(), want)


def test_stereo_bm_matches_the_shift_and_cv2():
    """tests/test_calib3d.py::test_stereo_bm's scene: a known disparity 8."""
    rng = np.random.default_rng(6)
    scene = cv2.GaussianBlur(rng.integers(0, 256, (96, 160), np.uint8), (3, 3), 1)
    right = np.roll(scene, -8, axis=1)
    ours = tcv.StereoBM_create(32, 15).compute(scene, right).numpy()
    assert np.array_equal(ours, cv2.StereoBM_create(32, 15).compute(scene, right))
    valid = ours > 0
    assert valid.mean() > 0.3 and abs(np.median(ours[valid]) / 16 - 8) <= 1


SGBM_CASES = [dict(minDisparity=0, numDisparities=16, blockSize=5, P1=200, P2=800,
                   uniquenessRatio=10, seed=0, shift=6),
              dict(minDisparity=2, numDisparities=16, blockSize=7, P1=100, P2=1000,
                   uniquenessRatio=15, disp12MaxDiff=2),
              dict(minDisparity=-4, numDisparities=32, blockSize=5, P1=200, P2=800,
                   uniquenessRatio=10),
              dict(minDisparity=0, numDisparities=16, blockSize=5, P1=200, P2=800,
                   uniquenessRatio=10, speckleWindowSize=50, speckleRange=2),
              dict(minDisparity=0, numDisparities=32, blockSize=3, P1=72, P2=288,
                   disp12MaxDiff=1, preFilterCap=63, uniquenessRatio=10,
                   speckleWindowSize=100, speckleRange=32)]


def _sgbm_pair(seed, shift, shape=(90, 150)):
    rng = np.random.default_rng(seed)
    base = (cv2.GaussianBlur(rng.random(shape).astype(np.float32), (0, 0), 1.5)
            * 255).astype(np.uint8)
    return np.roll(base, shift, axis=1), base


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("case", range(len(SGBM_CASES)))
def test_stereo_sgbm_equals_opencv_tpu_and_cv2(case, mode):
    cfg = dict(SGBM_CASES[case])
    seed, shift = cfg.pop("seed", 1), cfg.pop("shift", 5)
    shape = (100, 160) if seed == 0 else (90, 150)
    left, right = _sgbm_pair(seed, shift, shape)
    m = tcv.StereoSGBM_create(**cfg, mode=mode)
    ours = m.compute(torch.from_numpy(left), torch.from_numpy(right))
    assert isinstance(ours, torch.Tensor) and ours.dtype == torch.int16
    ref = np.asarray(jcv.StereoSGBM_create(**cfg, mode=mode).compute(left, right))
    assert np.array_equal(ours.numpy(), ref)
    cvmode = cv2.STEREO_SGBM_MODE_HH if mode else cv2.STEREO_SGBM_MODE_SGBM
    want = cv2.StereoSGBM_create(**cfg, mode=cvmode).compute(left, right)
    assert np.array_equal(ours.numpy(), want)


@pytest.mark.parametrize("which", ["bm", "sgbm"])
def test_winner_takes_the_first_minimum_on_a_tie(which):
    """A flat pair: every candidate costs the same, so the first one wins,
    as jnp.argmin's and the reference's loops take it."""
    flat = np.full((40, 96), 77, np.uint8)
    flat[:, ::7] = 90           # texture to pass BM's threshold, the same at every shift
    left = right = flat
    if which == "bm":
        t, j = tcv.StereoBM_create(16, 5), jcv.StereoBM_create(16, 5)
        for obj in (t, j):
            obj.setTextureThreshold(0)
            obj.setUniquenessRatio(0)
        ours, ref = t.compute(left, right).numpy(), j.compute(left, right)
    else:
        cfg = dict(minDisparity=0, numDisparities=16, blockSize=3, P1=8, P2=32)
        ours = tcv.StereoSGBM_create(**cfg).compute(left, right).numpy()
        ref = np.asarray(jcv.StereoSGBM_create(**cfg).compute(left, right))
    assert np.array_equal(ours, ref)
    sad = torch.tensor([[[5, 3, 3, 4]]], dtype=torch.int32)
    assert int(torch.argmin(sad, -1)) == 1


@pytest.mark.parametrize("prefilter", ["xsobel", "norm"])
def test_prefilters_equal_opencv_tpu(prefilter):
    rng = np.random.default_rng(3)
    for shape in ((31, 47), (64, 96), (2, 3), (1, 5)):
        img = rng.integers(0, 256, shape, np.uint8)
        if prefilter == "xsobel":
            ours = tstereo._xsobel_prefilter(torch.from_numpy(img), 31)
            ref = jstereo._xsobel_prefilter(img, 31)
        else:
            ours = tstereo._norm_prefilter(torch.from_numpy(img), 9, 31)
            ref = jstereo._norm_prefilter(img, 9, 31)
        assert ours.dtype == torch.int32 and np.array_equal(ours.numpy(), ref)


def _speckle_images(seed):
    rng = np.random.default_rng(seed)
    a = (rng.integers(-3, 4, (48, 61)) * rng.integers(1, 20)).astype(np.int16)
    a[rng.random(a.shape) < 0.2] = -16
    return a


@pytest.mark.parametrize("seed", range(6))
def test_filter_speckles_native_equals_python_twin_and_opencv_tpu(seed):
    a = _speckle_images(seed)
    for size, diff in ((5, 3), (20, 16), (0, 0), (100, 1), (3000, 40)):
        got = tcv.filterSpeckles(a, -16, size, diff)
        assert got.dtype == np.int16
        assert np.array_equal(got, tmisc._filter_speckles_py(a, -16, size, diff))
        assert np.array_equal(got, jmisc.filterSpeckles(a, -16, size, diff))
        t = tcv.filterSpeckles(torch.from_numpy(a), -16, size, diff)
        assert isinstance(t, torch.Tensor) and np.array_equal(t.numpy(), got)


def test_filter_speckles_matches_cv2_and_takes_u8():
    a = _speckle_images(9)
    want, _ = cv2.filterSpeckles(a.copy(), -16, 20, 16)
    assert np.array_equal(tcv.filterSpeckles(a, -16, 20, 16), want)
    u = np.random.default_rng(4).integers(0, 6, (40, 50)).astype(np.uint8) * 40
    got = tcv.filterSpeckles(u, 0, 8, 40)
    assert np.array_equal(got, tmisc._filter_speckles_py(u, 0, 8, 40))
    want, _ = cv2.filterSpeckles(u.copy(), 0, 8, 40)
    assert np.array_equal(got, want)


def test_filter_speckles_refuses_what_the_native_flood_does_not_take():
    with pytest.raises(ValueError):
        native.filter_speckles(np.zeros((4, 4), np.float32), 0, 1, 1)
    with pytest.raises(OverflowError):
        native.filter_speckles(np.zeros((4, 4), np.uint8), -16, 1, 1)


def test_filter_speckles_build_failure_raises(monkeypatch, tmp_path):
    """A failed g++ build raises: nothing falls back to the Python loop."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS", [*native.CXX_FLAGS, "-DHOSTTAILS_TEST_BROKEN",
                                              "-include", "/nonexistent/broken.h"])
    with pytest.raises(RuntimeError, match="failed"):
        tcv.filterSpeckles(_speckle_images(0), -16, 5, 3)
