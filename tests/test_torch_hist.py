"""opencv_tpu_torch histograms (calcHist, equalizeHist, compareHist,
calcBackProject, CLAHE) vs opencv_tpu and the cv2 oracle, on the CPU.

Bit-exact (``array_equal``) where the reference is: u8 calcHist,
equalizeHist, calcBackProject and CLAHE on the ten shapes of
``tests/test_analysis.py::test_clahe``.  Divergences the port holds to cv2:
float input is binned in f64 from cv2's float ranges (opencv_tpu bins in
f32), and compareHist accumulates in f64 with cv2's 1e-10 floor in
KL_DIV (opencv_tpu: f32 and 2.2e-16)."""

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu_torch.ops.hist import hist_fixed, hist_per_image
from torch_threads import _one_torch_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n,rng_", [(32, (0, 256)), (256, (0, 256)), (30, (10, 200)),
                                    (7, (0, 255))])
def test_calc_hist_1d_equals_opencv_tpu_and_cv2(n, rng_):
    rng = np.random.default_rng(n)
    img = rng.integers(0, 256, (40, 44), np.uint8)
    mask = (rng.random((40, 44)) > 0.5).astype(np.uint8) * 255
    for m in (None, mask):
        got = tcv.calcHist([_t(img)], [0], None if m is None else _t(m), [n], list(rng_))
        assert got.dtype == torch.float32 and got.shape == (n,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jcv.calcHist([img], [0], m, [n],
                                                                           list(rng_))))
        np.testing.assert_array_equal(got.numpy(),
                                      cv2.calcHist([img], [0], m, [n], list(rng_)).reshape(-1))


def test_calc_hist_batch_counts_every_image():
    """A batch counts into one histogram, as opencv_tpu's does."""
    x = np.random.default_rng(1).integers(0, 256, (3, 20, 24, 1), np.uint8)
    got = tcv.calcHist([_t(x)], [0], None, [64], [0, 256]).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcv.calcHist([x], [0], None, [64], [0, 256])))
    assert got.sum() == x.size


def test_calc_hist_2d_and_3d_equal_opencv_tpu_and_cv2():
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (40, 40, 3), np.uint8)
    ycc = cv2.cvtColor(img, cv2.COLOR_BGR2YCrCb)
    for chans, sizes, ranges in (([0, 1], [30, 32], [0, 256, 0, 256]),
                                 ([0, 1, 2], [4, 5, 6], [0, 256, 0, 256, 0, 256]),
                                 ([2, 0], [8, 9], [20, 230, 0, 256])):
        got = tcv.calcHist([_t(ycc)], chans, None, sizes, ranges).numpy()
        np.testing.assert_array_equal(got, np.asarray(jcv.calcHist([ycc], chans, None, sizes,
                                                                   ranges)))
        np.testing.assert_array_equal(got, cv2.calcHist([ycc], chans, None, sizes, ranges))


def test_calc_hist_two_images_index_channels_across_the_list():
    rng = np.random.default_rng(12)
    a = rng.integers(0, 256, (30, 30, 2), np.uint8)
    b = rng.integers(0, 256, (30, 30), np.uint8)
    got = tcv.calcHist([_t(a), _t(b)], [1, 2], None, [16, 16], [0, 256, 0, 256]).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jcv.calcHist([a, b], [1, 2], None, [16, 16], [0, 256, 0, 256])))
    np.testing.assert_array_equal(got, cv2.calcHist([a, b], [1, 2], None, [16, 16],
                                                    [0, 256, 0, 256]))


def test_calc_hist_u16_and_f32_equal_cv2():
    rng = np.random.default_rng(13)
    u16 = rng.integers(0, 65536, (40, 40), np.uint16)
    got = tcv.calcHist([_t(u16)], [0], None, [100], [0, 65536]).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcv.calcHist([u16], [0], None, [100],
                                                               [0, 65536])))
    np.testing.assert_array_equal(got, cv2.calcHist([u16], [0], None, [100],
                                                    [0, 65536]).reshape(-1))
    f = (rng.random((40, 40), np.float32) * 3 - 0.5).astype(np.float32)
    got = tcv.calcHist([_t(f)], [0], None, [17], [0, 2.0]).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcv.calcHist([f], [0], None, [17], [0, 2.0])))
    np.testing.assert_array_equal(got, cv2.calcHist([f], [0], None, [17], [0, 2.0]).reshape(-1))


def test_calc_hist_f32_bins_in_f64_as_cv2_divergence():
    """Divergence: the port bins float input as calcHist_ does, floor(v*a +
    b) in f64 from the float32 ranges; opencv_tpu bins in f32 and puts
    values of this image into other bins than cv2."""
    f = np.random.default_rng(0).random((64, 64), np.float32)
    ref = cv2.calcHist([f], [0], None, [7], [0.1, 0.9]).reshape(-1)
    got = tcv.calcHist([_t(f)], [0], None, [7], [0.1, 0.9]).numpy()
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(np.asarray(jcv.calcHist([f], [0], None, [7], [0.1, 0.9])), ref)


def test_hist_fixed_drops_the_overflow_bin():
    idx = torch.tensor([0, 3, 3, 5, 5, 5, 2], dtype=torch.int32)
    np.testing.assert_array_equal(hist_fixed(idx, 5).numpy(), [1, 0, 1, 2, 0])
    assert hist_fixed(idx, 5).dtype == torch.int64


def test_hist_per_image_is_calc_hist_of_each_image():
    x = np.random.default_rng(14).integers(0, 256, (3, 17, 19, 1), np.uint8)
    got = hist_per_image(_t(x))
    assert got.shape == (3, 256) and got.dtype == torch.float32
    for i in range(3):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(
            jcv.calcHist([x[i]], [0], None, [256], [0, 256])))


def test_equalize_hist_equals_opencv_tpu_and_cv2():
    rng = np.random.default_rng(12)
    g = np.clip(rng.normal(120, 30, (3, 48, 56)), 0, 255).astype(np.uint8)
    g[2] = g[2] // 4 + 100                     # a narrow third image
    got = tcv.equalizeHist(_t(g[..., None])).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcv.equalizeHist(g[..., None])))
    for i in range(3):
        np.testing.assert_array_equal(got[i, ..., 0], cv2.equalizeHist(g[i]))
    const = np.full((10, 12), 7, np.uint8)
    np.testing.assert_array_equal(tcv.equalizeHist(_t(const)).numpy(), cv2.equalizeHist(const))


METHODS = [tcv.HISTCMP_CORREL, tcv.HISTCMP_CHISQR, tcv.HISTCMP_INTERSECT,
           tcv.HISTCMP_BHATTACHARYYA, tcv.HISTCMP_CHISQR_ALT, tcv.HISTCMP_KL_DIV]


@pytest.mark.parametrize("method", METHODS)
def test_compare_hist_in_f64_equals_cv2(method):
    """Held to cv2 within 1e-12 relative (f64 sums in another order);
    opencv_tpu within its own test's 1e-4."""
    rng = np.random.default_rng(13)
    a = rng.integers(0, 256, (32, 32), np.uint8)
    b = rng.integers(0, 256, (32, 32), np.uint8)
    h1 = cv2.calcHist([a], [0], None, [64], [0, 256])
    h2 = cv2.calcHist([b], [0], None, [64], [0, 256])
    ref = cv2.compareHist(h1, h2, method)
    got = tcv.compareHist(_t(h1), _t(h2), method)
    assert isinstance(got, float)
    assert abs(got - ref) <= 1e-12 * max(1.0, abs(ref)), (got, ref)
    j = jcv.compareHist(h1, h2, method)
    assert abs(got - j) <= max(1e-4, abs(j) * 1e-4), (got, j)


def test_compare_hist_kl_floor_as_cv2_divergence():
    """Divergence: where h2 is empty KL_DIV takes q = 1e-10, as cv2 does;
    opencv_tpu takes 2.2e-16 (229.57 against 307.74 here)."""
    rng = np.random.default_rng(13)
    h1 = cv2.calcHist([rng.integers(0, 256, (32, 32), np.uint8)], [0], None, [64], [0, 256])
    h2 = cv2.calcHist([rng.integers(0, 256, (32, 32), np.uint8)], [0], None, [64], [0, 256])
    h2[3] = 0
    ref = cv2.compareHist(h1, h2, cv2.HISTCMP_KL_DIV)
    got = tcv.compareHist(_t(h1), _t(h2), tcv.HISTCMP_KL_DIV)
    assert abs(got - ref) <= 1e-12 * abs(ref)
    assert abs(jcv.compareHist(h1, h2, jcv.HISTCMP_KL_DIV) - ref) > 50


def test_calc_back_project_equals_opencv_tpu_and_cv2():
    rng = np.random.default_rng(14)
    img = rng.integers(0, 256, (32, 36), np.uint8)
    h = cv2.calcHist([img], [0], None, [32], [0, 256])
    got = tcv.calcBackProject([_t(img)], [0], _t(h), [0, 256], 1.0).numpy()
    np.testing.assert_array_equal(got, cv2.calcBackProject([img], [0], h, [0, 256], 1.0))
    np.testing.assert_array_equal(got, np.asarray(jcv.calcBackProject([img], [0], h,
                                                                      [0, 256], 1.0)))
    im3 = rng.integers(0, 256, (30, 34, 3), np.uint8)
    h2 = cv2.calcHist([im3], [0, 1], None, [30, 32], [0, 256, 0, 256])
    got = tcv.calcBackProject([_t(im3)], [0, 1], _t(h2), [0, 256, 0, 256], 0.5).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcv.calcBackProject(
        [im3], [0, 1], h2, [0, 256, 0, 256], 0.5)))
    np.testing.assert_array_equal(got, cv2.calcBackProject([im3], [0, 1], h2,
                                                           [0, 256, 0, 256], 0.5))


CLAHE_CASES = [(64, 64, (8, 8), 2.0), (128, 160, (16, 16), 3.5), (96, 128, (8, 8), 40.0),
               (80, 100, (4, 4), 0.0), (97, 131, (8, 8), 40.0), (120, 160, (16, 16), 3.5),
               (64, 64, (2, 5), 40.0), (65, 63, (7, 4), 2.0), (30, 31, (3, 3), 0.0),
               (100, 99, (7, 4), 40.0)]


# the cases also run through opencv_tpu (one compile each): the pad quirk's
# shapes and one divisible shape without a clip
CLAHE_JAX = {(64, 64, (2, 5), 40.0), (65, 63, (7, 4), 2.0), (97, 131, (8, 8), 40.0),
             (80, 100, (4, 4), 0.0)}


@pytest.mark.parametrize("h,w,grid,clip", CLAHE_CASES)
def test_clahe_equals_opencv_tpu_and_cv2(h, w, grid, clip):
    """The ten shapes of test_analysis.py::test_clahe, the pad quirk's among
    them: bit-exact against cv2 (which opencv_tpu equals on all ten), and
    against opencv_tpu on four."""
    img = np.clip(np.random.default_rng(h * w).normal(120, 40, (h, w)), 0, 255).astype(np.uint8)
    got = tcv.createCLAHE(clip, grid).apply(_t(img)).numpy()
    np.testing.assert_array_equal(got, cv2.createCLAHE(clip, grid).apply(img))
    if (h, w, grid, clip) in CLAHE_JAX:
        np.testing.assert_array_equal(got, np.squeeze(np.asarray(
            jcv.createCLAHE(clip, grid).apply(img))))


def test_clahe_batch_is_per_image():
    x = np.clip(np.random.default_rng(3).normal(100, 50, (3, 72, 96, 1)), 0, 255).astype(np.uint8)
    clahe = tcv.createCLAHE(2.0, (8, 8))
    assert isinstance(clahe, tcv.CLAHE) and clahe.getClipLimit() == 2.0
    got = clahe.apply(_t(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcv.createCLAHE(2.0, (8, 8)).apply(x)))
    for i in range(3):
        np.testing.assert_array_equal(got[i, ..., 0],
                                      cv2.createCLAHE(2.0, (8, 8)).apply(x[i, ..., 0]))
