"""opencv_tpu_torch medianBlur, bilateralFilter and stackBlur vs opencv_tpu
and the cv2 oracle, on the CPU.

medianBlur is bit-exact against both (k = 3, 5, 7; u8, and u16 and f32 at
k = 3 and 5, where cv2 takes them).  bilateralFilter is held to ±1, the
reference test's bound against cv2, and to opencv_tpu within ±1 (u8) and
1e-5 (f32): both sum the same taps in the same order, but XLA may fuse a
multiply-add that eager torch does not.  stackBlur is held to opencv_tpu
bit for bit, not to cv2 (``tests/test_analysis.py::test_stack_blur`` is a
reference red): row kernels of 3 to 101, the SIMD/scalar lane splits of
one to four channels, u16 and f32."""

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu_torch.ops.smooth import median_network


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("k", [3, 5, 7, 9, 11])
def test_median_network_selects_the_median(k):
    """The pruned network leaves the median of k² values on the middle
    wire, for random integers (numpy, many columns at once)."""
    n = k * k
    net = median_network(n)
    x = np.random.default_rng(k).integers(0, 256, (n, 4000))
    w = list(x)
    for i, j, need_min, need_max in net:
        a, b = w[i], w[j]
        w[i], w[j] = np.minimum(a, b), np.maximum(a, b)
    np.testing.assert_array_equal(w[n // 2], np.sort(x, axis=0)[n // 2])
    assert len(net) == {3: 24, 5: 113, 7: 319, 9: 702, 11: 1137}[k]


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("cn", [1, 3])
def test_median_blur_u8_equals_opencv_tpu_and_cv2(k, cn):
    x = np.random.default_rng(16 + k).integers(0, 256, (2, 40, 44, cn), np.uint8)
    got = tcv.medianBlur(_t(x), k).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcv.medianBlur(x, k)))
    for i in range(2):
        np.testing.assert_array_equal(got[i], cv2.medianBlur(x[i], k).reshape(40, 44, cn))


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
@pytest.mark.parametrize("k", [3, 5])
def test_median_blur_u16_f32_equals_opencv_tpu_and_cv2(dtype, k):
    rng = np.random.default_rng(k)
    x = (rng.integers(0, 65536, (23, 29)).astype(dtype) if dtype == np.uint16
         else rng.random((23, 29), np.float32))
    got = tcv.medianBlur(_t(x), k).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcv.medianBlur(x, k)))
    np.testing.assert_array_equal(got, cv2.medianBlur(x, k))


def _smooth_img(rng, h, w):
    return cv2.GaussianBlur(rng.integers(0, 256, (h, w), np.uint8), (5, 5), 1.5)


@pytest.mark.parametrize("d,sc,ss", [(5, 50, 50), (9, 75, 75), (0, 40, 3)])
def test_bilateral_u8_within_one(d, sc, ss):
    img = _smooth_img(np.random.default_rng(17), 40, 40)
    got = tcv.bilateralFilter(_t(img), d, sc, ss).numpy().astype(np.int32)
    assert np.abs(got - cv2.bilateralFilter(img, d, sc, ss)).max() <= 1
    assert np.abs(got - np.asarray(jcv.bilateralFilter(img, d, sc, ss))).max() <= 1


@pytest.mark.parametrize("border", [tcv.BORDER_REFLECT_101, tcv.BORDER_REPLICATE,
                                    tcv.BORDER_CONSTANT])
def test_bilateral_colour_within_one(border):
    img = cv2.GaussianBlur(np.random.default_rng(18).integers(0, 256, (2, 32, 36, 3), np.uint8)[0],
                           (3, 3), 1)
    got = tcv.bilateralFilter(_t(img), 5, 50, 50, border).numpy().astype(np.int32)
    assert np.abs(got - cv2.bilateralFilter(img, 5, 50, 50, borderType=border)).max() <= 1
    assert np.abs(got - np.asarray(jcv.bilateralFilter(img, 5, 50, 50, border))).max() <= 1


def test_bilateral_f32_equals_opencv_tpu():
    x = np.random.default_rng(19).random((2, 30, 33, 1), np.float32)
    got = tcv.bilateralFilter(_t(x), 5, 0.3, 3).numpy()
    np.testing.assert_allclose(got, np.asarray(jcv.bilateralFilter(x, 5, 0.3, 3)), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got[0, ..., 0], cv2.bilateralFilter(x[0, ..., 0], 5, 0.3, 3),
                               rtol=0, atol=1e-5)


KSIZES = [(3, 3), (5, 5), (9, 9), (11, 11), (13, 3), (21, 21), (25, 5), (31, 7), (51, 1),
          (101, 101), (101, 3), (1, 9), (3, 15)]


@pytest.mark.parametrize("shape", [(1, 40, 40, 1), (2, 37, 53, 3), (1, 50, 130, 1),
                                   (2, 33, 20, 4), (1, 17, 61, 2)])
def test_stack_blur_u8_equals_opencv_tpu(shape):
    """Row kernels of 3 to 101 (the big-kernel recurrence from 11 on, and
    where the row is no wider than the kernel) and the SIMD/scalar splits
    of the row and column passes at widths of 20 to 260 lanes."""
    x = np.random.default_rng(sum(shape)).integers(0, 256, shape, np.uint8)
    for ks in KSIZES:
        got = tcv.stackBlur(_t(x), ks).numpy()
        np.testing.assert_array_equal(got, np.asarray(jcv.stackBlur(x, ks)), err_msg=str(ks))


def test_stack_blur_matches_cv2_where_opencv_tpu_does():
    """On the kernels where opencv_tpu equals cv2 on this image, so does
    the port (the reference test's image and seed)."""
    img = np.random.default_rng(19).integers(0, 256, (40, 40), np.uint8)
    for ks in [(5, 5), (13, 3), (1, 9), (21, 21), (101, 101)]:
        ref = cv2.stackBlur(img, ks)
        jax = np.asarray(jcv.stackBlur(img, ks))
        got = tcv.stackBlur(_t(img), ks).numpy()
        np.testing.assert_array_equal(got, jax)
        if np.array_equal(jax, ref):
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
def test_stack_blur_u16_f32_equals_opencv_tpu(dtype):
    rng = np.random.default_rng(20)
    x = (rng.integers(0, 65536, (30, 41)).astype(dtype) if dtype == np.uint16
         else (rng.random((30, 41), np.float32) * 200))
    for ks in [(5, 5), (21, 21), (7, 31)]:
        np.testing.assert_array_equal(tcv.stackBlur(_t(x), ks).numpy(),
                                      np.asarray(jcv.stackBlur(x, ks)), err_msg=str(ks))
