"""The port's segmentation module (floodFill, watershed,
pyrMeanShiftFiltering) and its native host tails, on the CPU, against
opencv_tpu and cv2, and the native code against its Python twins.  The
native library is built with g++ at the first call."""

import os
import shutil

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu_torch import native
from opencv_tpu_torch.ops import segmentation as S


def _blocks(seed=0, shape=(30, 30)):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 3, shape) * 10 + 100).astype(np.uint8)


def test_flood_fill_matches_cv2_and_opencv_tpu():
    img = np.zeros((40, 40), np.uint8)
    cv2.rectangle(img, (5, 5), (20, 20), 100, -1)
    rn, rimg, rmask, rrect = cv2.floodFill(img.copy(), None, (10, 10), 200)
    jn, jimg, jmask, jrect = jcv.floodFill(img, None, (10, 10), 200)
    for src in (img, torch.from_numpy(img)):
        on, oimg, omask, orect = tcv.floodFill(src, None, (10, 10), 200)
        assert (on, orect) == (rn, rrect) == (jn, jrect)
        assert type(oimg) is type(src) and type(omask) is type(src)
        np.testing.assert_array_equal(np.asarray(oimg), rimg)
        np.testing.assert_array_equal(np.asarray(omask), jmask)
    assert img[10, 10] == 100           # the caller's image is not filled


def test_flood_fill_tolerance_matches_cv2():
    img = _blocks()
    rn, rimg, _, _ = cv2.floodFill(img.copy(), None, (15, 15), 255, loDiff=25, upDiff=25)
    jn, jimg, jmask, _ = jcv.floodFill(img, None, (15, 15), 255, loDiff=25, upDiff=25)
    on, oimg, omask, _ = tcv.floodFill(img, None, (15, 15), 255, loDiff=25, upDiff=25)
    assert on == rn == jn
    np.testing.assert_array_equal(oimg, rimg)
    np.testing.assert_array_equal(omask, jmask)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("mode", ["floating", "fixed", "fixed mask only"])
def test_native_flood_equals_its_python_twin(channels, conn, mode):
    """The native fill (a depth-first stack) and the JAX package's
    breadth-first fill give the same closed set, count and rect, with lo !=
    up, either connectivity, a floating or fixed range, and a mask that
    already blocks some pixels; and each equals opencv_tpu's floodFill."""
    rng = np.random.default_rng(channels * 10 + conn)
    img = np.clip(rng.normal(120, 12, (41, 53, channels)).cumsum(1) / 8 + 60, 0, 255)
    img = img.astype(np.uint8)[..., 0] if channels == 1 else img.astype(np.uint8)
    flags = conn | (77 << 8)
    if mode != "floating":
        flags |= S.FLOODFILL_FIXED_RANGE
    if mode.endswith("mask only"):
        flags |= S.FLOODFILL_MASK_ONLY
    block = np.zeros((43, 55), np.uint8)
    block[10:30, 20] = 1
    lo, up = (3, 5, 2)[:channels], (6, 1, 4)[:channels]
    seed, nv = (25, 20), (250, 10, 99)[:channels]
    got = tcv.floodFill(img, block, seed, nv, lo, up, flags)
    want = jcv.floodFill(img, block.copy(), seed, nv, lo, up, flags)
    twin_img, twin_mask = img.copy(), block.copy()
    twin = S._flood_py(twin_img, twin_mask, *seed, np.asarray(nv, np.uint8)
                       if channels == 3 else nv[0], np.asarray(lo, np.float64),
                       np.asarray(up, np.float64), conn, mode != "floating",
                       mode.endswith("mask only"), 77)
    assert got[0] == want[0] == twin[0] and got[3] == want[3] == twin[1]
    assert got[0] > 20
    for g, w, t in ((got[1], want[1], twin_img), (got[2], want[2], twin_mask)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, t)


def test_flood_fill_float_image_takes_the_twin():
    rng = np.random.default_rng(3)
    img = rng.random((24, 31)).astype(np.float32).cumsum(0)
    got = tcv.floodFill(torch.from_numpy(img), None, (5, 5), 9.5, 0.6, 0.4, 8)
    want = jcv.floodFill(img, None, (5, 5), 9.5, 0.6, 0.4, 8)
    assert got[0] == want[0] and got[3] == want[3]
    assert isinstance(got[1], torch.Tensor) and got[1].dtype == torch.float32
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])


def _two_discs():
    img = np.zeros((60, 60, 3), np.uint8)
    cv2.circle(img, (20, 30), 12, (200, 200, 200), -1)
    cv2.circle(img, (42, 30), 12, (120, 120, 120), -1)
    markers = np.zeros((60, 60), np.int32)
    markers[30, 20], markers[30, 42], markers[5, 5] = 1, 2, 3
    return img, markers


def _noise_scene(seed=0, shape=(81, 97)):
    rng = np.random.default_rng(seed)
    img = cv2.GaussianBlur(rng.integers(0, 256, shape + (3,), np.uint8), (0, 0), 2)
    mk = np.zeros(shape, np.int32)
    for lbl in range(1, 6):
        mk[rng.integers(2, shape[0] - 2), rng.integers(2, shape[1] - 2)] = lbl
    return img, mk


@pytest.mark.parametrize("scene", ["two discs", "noise"])
def test_watershed_bit_exact(scene):
    """cv2, opencv_tpu and the port agree bit for bit; the markers are
    written in place, a tensor's with copy_, and so does the Python twin."""
    img, mk = _two_discs() if scene == "two discs" else _noise_scene()
    rm = mk.copy()
    cv2.watershed(img, rm)
    jm = mk.copy()
    jcv.watershed(img, jm)
    om = mk.copy()
    assert tcv.watershed(img, om) is om
    tm = torch.from_numpy(mk.copy())
    assert tcv.watershed(torch.from_numpy(img), tm) is tm
    pm = mk.copy()
    S._watershed_py(img, pm)
    for got in (om, tm.numpy(), pm, jm):
        np.testing.assert_array_equal(got, rm)
    assert (rm == -1).sum() > 0


def test_watershed_frames_pooled_equal_one_after_another():
    scenes = [_noise_scene(seed, (64, 72)) for seed in range(4)]
    imgs = np.stack([s[0] for s in scenes])
    mks = np.stack([s[1] for s in scenes])
    pooled = S.watershed_frames(torch.from_numpy(imgs), torch.from_numpy(mks), threads=4)
    alone = S.watershed_frames(imgs, mks, threads=1)
    np.testing.assert_array_equal(pooled, alone)
    for i in range(4):
        one = mks[i].copy()
        jcv.watershed(imgs[i], one)
        np.testing.assert_array_equal(pooled[i], one)
    with pytest.raises(ValueError):
        S.watershed_frames(imgs[..., :1], mks)


@pytest.mark.parametrize("shape", [(32, 32), (33, 47)])
def test_pyr_mean_shift_bit_exact(shape):
    """Bit-exact against cv2 over the spatial window, colour radius and
    pyramid depth (tests/test_hough_seg.py's cases and the path's 10, 10, 1),
    and against opencv_tpu on two of them."""
    rng = np.random.default_rng(1)
    img = cv2.GaussianBlur(rng.integers(0, 256, shape + (3,), np.uint8), (5, 5), 2)
    for sp, sr, ml in [(5, 20, 1), (2, 10, 0), (5, 20, 3), (10, 10, 1), (2.5, 7, 1)]:
        ours = tcv.pyrMeanShiftFiltering(torch.from_numpy(img), sp, sr, maxLevel=ml)
        assert isinstance(ours, torch.Tensor) and ours.dtype == torch.uint8
        np.testing.assert_array_equal(ours.numpy(), cv2.pyrMeanShiftFiltering(img, sp, sr,
                                                                              maxLevel=ml))
        if (sp, sr, ml) in ((2, 10, 0), (10, 10, 1)):
            np.testing.assert_array_equal(ours.numpy(),
                                          jcv.pyrMeanShiftFiltering(img, sp, sr, maxLevel=ml))


def test_pyr_mean_shift_chunks_and_termcrit(monkeypatch):
    """Offsets taken in many small chunks give the same result, with each
    term criterion; only moving pixels are recomputed (their count falls)."""
    rng = np.random.default_rng(2)
    img = cv2.GaussianBlur(rng.integers(0, 256, (40, 52, 3), np.uint8), (5, 5), 2)
    full = {}
    want = tcv.pyrMeanShiftFiltering(img, 6, 15, 1, stats=full)
    monkeypatch.setattr(S, "MS_CHUNK_BYTES", 96 * 200)
    small = {}
    np.testing.assert_array_equal(tcv.pyrMeanShiftFiltering(img, 6, 15, 1, stats=small).numpy(),
                                  want.numpy())
    assert small["chunks"] > 10 * full["chunks"] and small["live"] == full["live"]
    assert full["live"][1] < full["live"][0]
    for crit in ((1, 2, 0.0), (2, 0, 3.0), (3, 7, 0.5)):
        np.testing.assert_array_equal(
            tcv.pyrMeanShiftFiltering(img, 6, 15, 1, crit).numpy(),
            cv2.pyrMeanShiftFiltering(img, 6, 15, maxLevel=1, termcrit=crit))
    with pytest.raises(ValueError):
        tcv.pyrMeanShiftFiltering(img[..., 0], 5, 5)


def test_native_build_raises_without_a_compiler(monkeypatch):
    """No compiler, or a failed build, raises: nothing falls back."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.library()


def test_native_build_raises_on_a_failed_build(monkeypatch, tmp_path):
    bad = tmp_path / "hosttails.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="failed"):
        native.library()
    assert not list((tmp_path / "_build").glob("*.so"))


def test_native_library_is_cached_by_source_hash():
    lib = native.library()
    so = native._library_path(native._compiler())
    assert so.exists() and so.parent == native.BUILD_DIR
    assert os.path.basename(so).startswith("libhosttails_")
    assert native.library() is lib
