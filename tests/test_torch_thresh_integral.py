"""opencv_tpu_torch threshold, adaptiveThreshold, thresholdWithMask,
integral/2/3, copyMakeBorder and borderInterpolate vs opencv_tpu (and the cv2
oracle), on the CPU, with the divergences the port holds to cv2: Otsu in
f64, one automatic threshold per batch against cv2's per image, integral
depths in real f64."""

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv

TYPES = [tcv.THRESH_BINARY, tcv.THRESH_BINARY_INV, tcv.THRESH_TRUNC, tcv.THRESH_TOZERO,
         tcv.THRESH_TOZERO_INV]
BORDERS = [tcv.BORDER_CONSTANT, tcv.BORDER_REPLICATE, tcv.BORDER_REFLECT, tcv.BORDER_WRAP,
           tcv.BORDER_REFLECT_101]


def _rand(shape, dtype=np.uint8, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return rng.random(shape, dtype=np.float32)
    return rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype)


@pytest.mark.parametrize("ttype", TYPES)
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_threshold_equals_opencv_tpu(ttype, dtype):
    x = _rand((2, 33, 47, 3), dtype, seed=ttype)
    scale = 1.0 if dtype == np.float32 else float(np.iinfo(dtype).max)
    for thresh, maxval in ((0.4 * scale + 0.5, 0.8 * scale), (-3, 200), (2 * scale, 17)):
        rw, want = jcv.threshold(x, thresh, maxval, ttype)
        rg, got = tcv.threshold(torch.from_numpy(x), thresh, maxval, ttype)
        assert got.numpy().dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert float(rg) == float(rw)
    ref_rv, ref = cv2.threshold(x[0], 0.4 * scale + 0.5, 0.8 * scale, ttype)
    rv, got = tcv.threshold(torch.from_numpy(x[0]), 0.4 * scale + 0.5, 0.8 * scale, ttype)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert float(rv) == ref_rv


@pytest.mark.parametrize("auto", [tcv.THRESH_OTSU, tcv.THRESH_TRIANGLE])
@pytest.mark.parametrize("ttype", TYPES)
def test_auto_threshold_equals_opencv_tpu_and_cv2(auto, ttype):
    x = _rand((2, 41, 53), seed=auto + ttype)
    x[1] = (x[1] // 3 + 20)            # a second image of another spread
    rw, want = jcv.threshold(x[..., None], 0, 255, ttype | auto)
    rg, got = tcv.threshold(torch.from_numpy(x[..., None]), 0, 255, ttype | auto)
    assert isinstance(rg, torch.Tensor) and rg.dtype == torch.float64 and rg.ndim == 0
    assert float(rg) == float(rw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ref_rv, ref = cv2.threshold(x[0], 0, 255, ttype | auto)
    rv, got0 = tcv.threshold(torch.from_numpy(x[0]), 0, 255, ttype | auto)
    assert float(rv) == ref_rv
    np.testing.assert_array_equal(got0.numpy(), ref)


# a histogram (from bin 59 on) of 234,000 pixels in two clusters, where
# opencv_tpu's f32 Otsu picks 67 and thresh.cpp's f64 picks 80
OTSU_F32_CASE = [5, 136, 1322, 5259, 8710, 5431, 1377, 140, 7] + [0] * 12 + [
    1, 10, 9, 46, 104, 245, 488, 918, 1632, 2901, 4519, 7015, 9627, 12880, 15948, 18289, 20496,
    21061, 20665, 18588, 15947, 12724, 9795, 6783, 4564, 2847, 1661, 955, 455, 230, 117, 52, 27,
    11, 2, 1]


def test_otsu_in_f64_as_cv2_divergence():
    """Divergence: the port takes Otsu's between-class variance in f64 (from
    exact int64 prefix sums) where opencv_tpu takes it in f32.  On this
    histogram the two pick 80 and 67; cv2 picks 80."""
    img = np.repeat(np.arange(59, 59 + len(OTSU_F32_CASE), dtype=np.uint8), OTSU_F32_CASE)
    img = img.reshape(234, 1000)
    ref_rv, ref = cv2.threshold(img, 0, 255, cv2.THRESH_BINARY | cv2.THRESH_OTSU)
    rv, got = tcv.threshold(torch.from_numpy(img), 0, 255, tcv.THRESH_BINARY | tcv.THRESH_OTSU)
    assert float(rv) == ref_rv == 80.0
    np.testing.assert_array_equal(got.numpy(), ref)
    assert float(jcv.threshold(img, 0, 255, jcv.THRESH_BINARY | jcv.THRESH_OTSU)[0]) == 67.0


def test_triangle_with_a_large_peak_equals_cv2():
    """Triangle's a·i + b·h[i] reaches 2^31 here: int64 in the port, f64 in
    cv2, both exact."""
    rng = np.random.default_rng(9)
    v = np.concatenate([np.clip(rng.normal(200, 3, 3_000_000), 0, 255),
                        rng.uniform(0, 200, 200_000)]).round().astype(np.uint8)
    img = v.reshape(-1, 1000)
    ref_rv, ref = cv2.threshold(img, 0, 255, cv2.THRESH_BINARY | cv2.THRESH_TRIANGLE)
    rv, got = tcv.threshold(torch.from_numpy(img), 0, 255,
                            tcv.THRESH_BINARY | tcv.THRESH_TRIANGLE)
    assert float(rv) == ref_rv
    np.testing.assert_array_equal(got.numpy(), ref)


def test_otsu_one_threshold_per_batch_divergence():
    """Divergence kept from opencv_tpu: one automatic threshold over the
    whole batch (one histogram across N), where cv2 takes one per image.
    Each image alone gets cv2's threshold."""
    x = _rand((2, 40, 60), seed=11)
    x[1] = x[1] // 4
    rg, got = tcv.threshold(torch.from_numpy(x[..., None]), 0, 255,
                            tcv.THRESH_BINARY | tcv.THRESH_OTSU)
    rw, _ = jcv.threshold(x[..., None], 0, 255, jcv.THRESH_BINARY | jcv.THRESH_OTSU)
    assert float(rg) == float(rw)
    per_image = [cv2.threshold(x[i], 0, 255, cv2.THRESH_BINARY | cv2.THRESH_OTSU)[0]
                 for i in range(2)]
    assert per_image[0] != per_image[1] and float(rg) not in per_image
    for i in range(2):
        r1, _ = tcv.threshold(torch.from_numpy(x[i]), 0, 255, tcv.THRESH_BINARY | tcv.THRESH_OTSU)
        assert float(r1) == per_image[i]


def test_auto_threshold_refuses_non_u8():
    with pytest.raises(ValueError, match="8-bit"):
        tcv.threshold(torch.zeros((4, 4), dtype=torch.float32), 0, 1, tcv.THRESH_OTSU)


@pytest.mark.parametrize("method", [tcv.ADAPTIVE_THRESH_MEAN_C, tcv.ADAPTIVE_THRESH_GAUSSIAN_C])
@pytest.mark.parametrize("ttype", [tcv.THRESH_BINARY, tcv.THRESH_BINARY_INV])
def test_adaptive_threshold_equals_opencv_tpu_and_cv2(method, ttype):
    x = _rand((2, 40, 52, 1), seed=method * 2 + ttype)
    for block, c in ((11, 5.0), (5, -2.5)):
        want = np.asarray(jcv.adaptiveThreshold(x, 200, method, ttype, block, c))
        got = tcv.adaptiveThreshold(torch.from_numpy(x), 200, method, ttype, block, c)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            got[0, ..., 0].numpy(), cv2.adaptiveThreshold(x[0, ..., 0], 200, method, ttype, block, c))


@pytest.mark.parametrize("ttype", [tcv.THRESH_BINARY, tcv.THRESH_TOZERO,
                                   tcv.THRESH_BINARY | tcv.THRESH_OTSU,
                                   tcv.THRESH_TRUNC | tcv.THRESH_TRIANGLE])
def test_threshold_with_mask_equals_opencv_tpu_and_cv2(ttype):
    a = _rand((48, 64), seed=3)
    m = (_rand((48, 64), seed=4) > 128).astype(np.uint8) * 255
    for dst in (None, _rand((48, 64), seed=5)):
        rw, want = jcv.thresholdWithMask(a, dst, m, 100, 255, ttype)
        rg, got = tcv.thresholdWithMask(torch.from_numpy(a), None if dst is None else
                                        torch.from_numpy(dst), torch.from_numpy(m), 100, 255, ttype)
        assert float(rg) == float(rw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ref_rv, ref = cv2.thresholdWithMask(a, a.copy(), m, 100, 255, ttype)
    rv, got = tcv.thresholdWithMask(a, a.copy(), m, 100, 255, ttype)
    assert float(rv) == ref_rv
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("sdepth", [-1, tcv.CV_32S, tcv.CV_32F])
def test_integral_u8_equals_opencv_tpu(sdepth):
    x = _rand((2, 30, 41, 3), seed=20)
    want = np.asarray(jcv.integral(x, sdepth))
    got = tcv.integral(torch.from_numpy(x), sdepth)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[0].numpy(), cv2.integral(x[0], sdepth=sdepth))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_integral_f64_as_cv2_divergence(dtype):
    """Divergence: CV_64F is real float64, and the default depth of every
    input but u8 is cv2's float64; opencv_tpu maps CV_64F to float32 and
    sums 16-bit input in int32 and float input in float32."""
    x = _rand((2, 30, 41), dtype, seed=21)
    for sdepth in (-1, tcv.CV_64F):
        got = tcv.integral(torch.from_numpy(x[..., None]), sdepth).numpy()[..., 0]
        want_dtype = np.int32 if (dtype == np.uint8 and sdepth == -1) else np.float64
        assert got.dtype == want_dtype
        for i in range(2):
            np.testing.assert_array_equal(got[i], cv2.integral(x[i], sdepth=sdepth))
    assert np.asarray(jcv.integral(x[..., None], jcv.CV_64F)).dtype == np.float32


def test_integral2_sqsum_f64_divergence():
    """Divergence: the squared sum is float64 by default, as cv2's; exact
    against cv2 at 256x256, where opencv_tpu's float32 sqsum (sums past
    2^24) is not.  The sum equals opencv_tpu's."""
    x = _rand((2, 256, 256), seed=22)
    s, sq = tcv.integral2(torch.from_numpy(x[..., None]))
    js, jsq = jcv.integral2(x[..., None])
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert sq.dtype == torch.float64
    for i in range(2):
        rs, rsq = cv2.integral2(x[i])
        np.testing.assert_array_equal(sq[i, ..., 0].numpy(), rsq)
        assert not np.array_equal(np.asarray(jsq)[i, ..., 0].astype(np.float64), rsq)
    _, sq32 = tcv.integral2(torch.from_numpy(x[0]), sqdepth=tcv.CV_32F)
    assert sq32.dtype == torch.float32


@pytest.mark.parametrize("shape", [(2, 16, 20, 1), (1, 9, 31, 3), (2, 23, 7, 1)])
def test_integral3_equals_opencv_tpu_and_cv2(shape):
    x = _rand(shape, seed=sum(shape))
    s, sq, t = tcv.integral3(torch.from_numpy(x))
    js, _, jt = jcv.integral3(x)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    for i in range(shape[0]):
        rs, rsq, rt = cv2.integral3(x[i] if shape[3] > 1 else x[i, ..., 0])
        rsq = rsq if shape[3] > 1 else rsq[..., None]
        rt = rt if shape[3] > 1 else rt[..., None]
        np.testing.assert_array_equal(sq[i].numpy(), rsq)
        np.testing.assert_array_equal(t[i].numpy(), rt)


@pytest.mark.parametrize("border", BORDERS)
def test_copy_make_border_equals_opencv_tpu_and_cv2(border):
    x = _rand((2, 13, 17, 3), seed=border)
    want = np.asarray(jcv.copyMakeBorder(x, 2, 5, 3, 4, border, value=(7, 8, 9)))
    got = tcv.copyMakeBorder(torch.from_numpy(x), 2, 5, 3, 4, border, value=(7, 8, 9))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[1].numpy(), cv2.copyMakeBorder(x[1], 2, 5, 3, 4, border,
                                                                     value=(7, 8, 9)))
    one = tcv.copyMakeBorder(x[0, ..., 0], 1, 1, 2, 2, border, value=5)
    np.testing.assert_array_equal(one.numpy(), cv2.copyMakeBorder(x[0, ..., 0], 1, 1, 2, 2, border,
                                                                   value=5))


@pytest.mark.parametrize("border", BORDERS)
def test_border_interpolate_equals_opencv_tpu_and_cv2(border):
    for p in (-7, -1, 0, 5, 9, 10, 23):
        want = jcv.borderInterpolate(p, 10, border)
        assert tcv.borderInterpolate(p, 10, border) == want == cv2.borderInterpolate(p, 10, border)
