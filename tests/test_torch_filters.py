"""opencv_tpu_torch's filter, derivative and pyramid families (sepFilter2D,
boxFilter, blur, sqrBoxFilter, filter2D, Sobel, Scharr, Laplacian,
spatialGradient, getDerivKernels, pyrDown, pyrUp, buildPyramid) against
opencv_tpu and the cv2 oracle, on the CPU (plain tier).

Tolerances: array_equal wherever the reference is bit-exact; filter2D and
the float paths carry the reference's float contract (±1 on integer
outputs).  Where the port computes ``CV_64F`` in real float64 (the JAX
package gives float32), it is held to cv2 and the divergence is asserted."""

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
from opencv_tpu.ops.deriv import _sobel_1d as j_sobel_1d
from opencv_tpu.ops.pyramids import _PD_K as J_PD_K

import opencv_tpu_torch as tcv
from opencv_tpu_torch.core.dispatch import reset_tier_stats, tier_stats
from opencv_tpu_torch.kernels.sepfilter import _PD_K
from opencv_tpu_torch.ops.deriv import _sobel_1d

BORDERS = [tcv.BORDER_CONSTANT, tcv.BORDER_REPLICATE, tcv.BORDER_REFLECT,
           tcv.BORDER_WRAP, tcv.BORDER_REFLECT_101]
# cv2's separable filters refuse BORDER_WRAP (filter.dispatch.cpp:130)
CV2_SEP_BORDERS = [b for b in BORDERS if b != tcv.BORDER_WRAP]


def _port(fn, x, *args, **kwargs):
    return np.asarray(fn(torch.from_numpy(x), *args, **kwargs))


def _img(x, i):
    """Image i of an NHWC batch in cv2's layout."""
    return x[i] if x.shape[-1] > 1 else x[i, ..., 0]


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


# ------------------------------------------------------------ sepFilter2D

SEP_KERNELS = {
    "sobel int": (np.array([-1.0, 0, 1]), np.array([1.0, 2, 1])),
    "gauss Q8": (cv2.getGaussianKernel(5, 1.0), cv2.getGaussianKernel(3, 0.8)),
    "binomial Q8": (np.array([0.25, 0.5, 0.25]), np.array([0.125, 0.75, 0.125])),
}


@pytest.mark.parametrize("border", BORDERS)
@pytest.mark.parametrize("ddepth", [-1, tcv.CV_16S])
@pytest.mark.parametrize("kind", list(SEP_KERNELS))
def test_sep_filter2d_u8_exact(kind, ddepth, border):
    kx, ky = SEP_KERNELS[kind]
    x = _rand(border, (2, 30, 32, 3))
    want = np.asarray(jcv.sepFilter2D(x, ddepth, kx, ky, borderType=border))
    got = _port(tcv.sepFilter2D, x, ddepth, kx, ky, borderType=border)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if border in CV2_SEP_BORDERS:
        # cv2 rounds some Q8 kernels differently: the reference holds
        # sepFilter2D to it at ±1 (tests/test_smooth.py); integer taps exact
        tol = 0 if kind == "sobel int" else 1
        for i in range(2):
            ref = cv2.sepFilter2D(_img(x, i), ddepth, kx, ky, borderType=border)
            assert np.abs(_img(got, i).astype(int) - ref.astype(int)).max() <= tol


def test_sep_filter2d_delta_float_path_and_anchor():
    x = _rand(3, (2, 21, 26, 1))
    kx, ky = np.array([0.1, 0.7, 0.2]), np.array([0.3, 0.4, 0.3])  # not Q8: float path
    for ddepth, delta in ((-1, 3.0), (tcv.CV_16S, -7.0), (tcv.CV_32F, 0.5)):
        want = np.asarray(jcv.sepFilter2D(x, ddepth, kx, ky, delta=delta))
        got = _port(tcv.sepFilter2D, x, ddepth, kx, ky, delta=delta)
        # the float path: ±1 on integer outputs (perf_filter2d.cpp:39)
        np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64),
                                   rtol=0, atol=1 if ddepth != tcv.CV_32F else 1e-4)
        ref = cv2.sepFilter2D(x[0, ..., 0], ddepth, kx, ky, delta=delta)
        np.testing.assert_allclose(got[0, ..., 0].astype(np.float64), ref.astype(np.float64),
                                   rtol=0, atol=1 if ddepth != tcv.CV_32F else 1e-4)
    with pytest.raises(NotImplementedError):
        tcv.sepFilter2D(torch.from_numpy(x), -1, kx, ky, anchor=(0, 0))


def test_sep_filter2d_cv64f_is_real_f64():
    x = _rand(4, (1, 20, 24, 1))
    kx, ky = np.array([0.1, 0.7, 0.2]), np.array([0.3, 0.4, 0.3])
    got = _port(tcv.sepFilter2D, x, tcv.CV_64F, kx, ky)
    # divergence from opencv_tpu (f32 on the TPU), held to cv2's double path
    assert np.asarray(jcv.sepFilter2D(x, jcv.CV_64F, kx, ky)).dtype == np.float32
    assert got.dtype == np.float64
    np.testing.assert_allclose(got[0, ..., 0], cv2.sepFilter2D(x[0, ..., 0], cv2.CV_64F, kx, ky),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("border", CV2_SEP_BORDERS)
@pytest.mark.parametrize("ksize, sigma", [((5, 5), 1.5), ((7, 3), 0.0), ((0, 0), 2.0)])
def test_gaussian_blur_f64_is_real_f64(ksize, sigma, border):
    x = np.random.default_rng(border).random((2, 21, 26, 3)) * 255
    got = _port(tcv.GaussianBlur, x, ksize, sigma, borderType=border)
    assert got.dtype == np.float64
    for i in range(2):
        np.testing.assert_allclose(got[i], cv2.GaussianBlur(x[i], ksize, sigma, borderType=border),
                                   rtol=0, atol=1e-12)
    # divergence from opencv_tpu, which filters f64 input in f32 and returns f32
    want = np.asarray(jcv.GaussianBlur(x, ksize, sigma, borderType=border))
    assert want.dtype == np.float32
    assert np.abs(want - got).max() > 1e-8
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


# ------------------------------------------------------------ box filters

@pytest.mark.parametrize("border", BORDERS)
@pytest.mark.parametrize("ksize", [(3, 3), (5, 7), (21, 19)])
def test_box_filter_u8_exact(ksize, border):
    x = _rand(ksize[0] + border, (2, 41, 43, 3))
    for normalize in (True, False):
        for ddepth in (-1, tcv.CV_16S):
            want = np.asarray(jcv.boxFilter(x, ddepth, ksize, normalize=normalize,
                                            borderType=border))
            got = _port(tcv.boxFilter, x, ddepth, ksize, normalize=normalize, borderType=border)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
            if border in CV2_SEP_BORDERS:
                ref = cv2.boxFilter(x[1], ddepth, ksize, normalize=normalize, borderType=border)
                np.testing.assert_array_equal(got[1], ref)
    got = _port(tcv.blur, x, ksize, borderType=border)
    np.testing.assert_array_equal(got, np.asarray(jcv.blur(x, ksize, borderType=border)))
    if border in CV2_SEP_BORDERS:
        np.testing.assert_array_equal(got[0], cv2.blur(x[0], ksize, borderType=border))


def test_box_filter_anchor_float_and_cv64f():
    x = _rand(6, (1, 21, 23, 1))
    for anchor in ((0, 0), (3, 1)):
        want = np.asarray(jcv.boxFilter(x, -1, (5, 4), anchor=anchor))
        got = _port(tcv.boxFilter, x, -1, (5, 4), anchor=anchor)
        np.testing.assert_array_equal(got, want)
        # ±1 vs cv2 for an even kernel off centre, as tests/test_smooth.py holds blur
        ref = cv2.boxFilter(x[0, ..., 0], -1, (5, 4), anchor=anchor)
        assert np.abs(got[0, ..., 0].astype(int) - ref.astype(int)).max() <= 1
    # unnormalized u8 -> f32 is exact (tests/test_smooth.py)
    got = _port(tcv.boxFilter, x, tcv.CV_32F, (5, 5), normalize=False)
    np.testing.assert_array_equal(got, np.asarray(jcv.boxFilter(x, jcv.CV_32F, (5, 5),
                                                                normalize=False)))
    np.testing.assert_array_equal(got[0, ..., 0], cv2.boxFilter(x[0, ..., 0], cv2.CV_32F, (5, 5),
                                                                normalize=False))
    # CV_64F: real f64 here, f32 in opencv_tpu; held to cv2's double path
    got = _port(tcv.boxFilter, x, tcv.CV_64F, (3, 5))
    assert got.dtype == np.float64
    assert np.asarray(jcv.boxFilter(x, jcv.CV_64F, (3, 5))).dtype == np.float32
    np.testing.assert_allclose(got[0, ..., 0], cv2.boxFilter(x[0, ..., 0], cv2.CV_64F, (3, 5)),
                               rtol=0, atol=1e-12)
    # float input
    xf = np.random.default_rng(7).random((2, 17, 19, 3), dtype=np.float32)
    want = np.asarray(jcv.boxFilter(xf, -1, (3, 5)))
    got = _port(tcv.boxFilter, xf, -1, (3, 5))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[0], cv2.boxFilter(xf[0], -1, (3, 5)), rtol=0, atol=1e-5)
    with pytest.raises(NotImplementedError):
        tcv.boxFilter(torch.from_numpy(xf), -1, (3, 5), anchor=(0, 0))


def test_sqr_box_filter():
    x = _rand(8, (2, 19, 22, 1))
    for normalize in (True, False):
        want = np.asarray(jcv.sqrBoxFilter(x, -1, (3, 3), normalize=normalize))
        got = _port(tcv.sqrBoxFilter, x, -1, (3, 3), normalize=normalize)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        ref = cv2.sqrBoxFilter(x[0, ..., 0], -1, (3, 3), normalize=normalize)
        np.testing.assert_allclose(got[0, ..., 0], ref, rtol=1e-6, atol=0)


# ------------------------------------------------------------ filter2D

@pytest.mark.parametrize("border", BORDERS)
def test_filter2d_u8_mac_and_dft(border):
    rng = np.random.default_rng(border)
    x = rng.integers(0, 256, (2, 40, 46, 3), np.uint8)
    sharpen = np.array([[0, -1, 0], [-1, 5, -1], [0, -1, 0]], np.float32)
    big = rng.random((13, 11)).astype(np.float32)  # 143 taps >= 130: the DFT path
    big /= big.sum()
    for kern in (sharpen, big):
        for ddepth in (-1, tcv.CV_16S):
            want = np.asarray(jcv.filter2D(x, ddepth, kern, borderType=border))
            got = _port(tcv.filter2D, x, ddepth, kern, borderType=border)
            assert got.dtype == want.dtype
            # ±1, the reference's float-accumulation contract
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
            if border != tcv.BORDER_WRAP:  # cv2 refuses it
                ref = cv2.filter2D(x[1], ddepth, kern, borderType=border)
                assert np.abs(got[1].astype(int) - ref.astype(int)).max() <= 1


def test_filter2d_float_anchor_delta_and_cv64f():
    rng = np.random.default_rng(8)
    xf = rng.random((1, 32, 34, 3), dtype=np.float32)
    for kern in (rng.random((3, 5), dtype=np.float32) - 0.25,
                 rng.standard_normal((9, 9)).astype(np.float32)):  # 81 >= 50: DFT
        for anchor, delta in (((-1, -1), 0.0), ((1, 0), 0.25)):
            want = np.asarray(jcv.filter2D(xf, -1, kern, anchor=anchor, delta=delta))
            got = _port(tcv.filter2D, xf, -1, kern, anchor=anchor, delta=delta)
            ref = cv2.filter2D(xf[0], -1, kern, anchor=anchor, delta=delta)
            # f32 sums in another order (and through an FFT): tests/test_filters2.py's bound
            scale = np.abs(ref).max()
            assert np.abs(got - want).max() <= 1e-5 * scale
            assert np.abs(got[0] - ref).max() <= 1e-5 * scale
    x = rng.integers(0, 256, (1, 30, 31, 1), np.uint8)
    kern = rng.random((3, 3))
    got = _port(tcv.filter2D, x, tcv.CV_64F, kern)
    assert got.dtype == np.float64
    assert np.asarray(jcv.filter2D(x, jcv.CV_64F, kern)).dtype == np.float32
    np.testing.assert_allclose(got[0, ..., 0], cv2.filter2D(x[0, ..., 0], cv2.CV_64F, kern),
                               rtol=0, atol=1e-12)


# ------------------------------------------------------------ derivatives

SOBEL_CASES = [(1, 0, 3), (0, 1, 3), (1, 1, 3), (2, 0, 3), (1, 0, 5), (2, 2, 5),
               (1, 0, 7), (0, 2, 7), (1, 0, 1), (0, 1, 1), (1, 0, -1), (0, 1, -1)]


@pytest.mark.parametrize("border", BORDERS)
@pytest.mark.parametrize("case", SOBEL_CASES, ids=[str(c) for c in SOBEL_CASES])
def test_sobel_scharr_u8_to_16s(case, border):
    dx, dy, ksize = case
    x = _rand(ksize + 10 * border + 1, (2, 32, 40, 1))
    want = np.asarray(jcv.Sobel(x, jcv.CV_16S, dx, dy, ksize=ksize, borderType=border))
    got = _port(tcv.Sobel, x, tcv.CV_16S, dx, dy, ksize=ksize, borderType=border)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    if border not in CV2_SEP_BORDERS:
        return
    ref = cv2.Sobel(x[0, ..., 0], cv2.CV_16S, dx, dy, ksize=ksize, borderType=border)
    np.testing.assert_array_equal(got[0, ..., 0], ref)
    if ksize == -1:
        got = _port(tcv.Scharr, x, tcv.CV_16S, dx, dy, borderType=border)
        np.testing.assert_array_equal(got[0, ..., 0], cv2.Scharr(x[0, ..., 0], cv2.CV_16S, dx, dy,
                                                                 borderType=border))


def test_sobel_u8_out_scale_delta_and_float():
    x = _rand(9, (1, 30, 33, 3))
    for kw in (dict(), dict(scale=0.5), dict(delta=20.0), dict(scale=0.25, delta=3.0)):
        want = np.asarray(jcv.Sobel(x, -1, 1, 0, **kw))
        got = _port(tcv.Sobel, x, -1, 1, 0, **kw)
        np.testing.assert_array_equal(got, want)
        # u8 out with scale goes through Q8 taps: ±1 vs cv2
        assert np.abs(got[0].astype(int) - cv2.Sobel(x[0], -1, 1, 0, **kw).astype(int)).max() <= 1
    xf = np.random.default_rng(1).random((1, 30, 30, 1), dtype=np.float32)
    want = np.asarray(jcv.Sobel(xf, -1, 1, 0, ksize=3, scale=0.25, delta=1.0))
    got = _port(tcv.Sobel, xf, -1, 1, 0, ksize=3, scale=0.25, delta=1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0, ..., 0], cv2.Sobel(xf[0, ..., 0], -1, 1, 0, ksize=3,
                                                         scale=0.25, delta=1.0),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("ksize", [1, 3, 5, 7])
def test_laplacian(ksize):
    x = _rand(3 + ksize, (2, 24, 26, 1))
    for ddepth in (tcv.CV_16S, -1):
        want = np.asarray(jcv.Laplacian(x, ddepth, ksize=ksize))
        got = _port(tcv.Laplacian, x, ddepth, ksize=ksize)
        assert got.dtype == want.dtype
        # ksize 1 is filter2D's float path; ksize > 1 the exact int32 path
        if ksize == 1:
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        else:
            np.testing.assert_array_equal(got, want)
        # ±1 vs cv2, as tests/test_filters2.py holds the reference (ksize <= 5:
        # at 7 the reference's int32 Q8·Q8 sum wraps, and the port with it)
        if ksize <= 5:
            ref = cv2.Laplacian(x[0, ..., 0], ddepth, ksize=ksize)
            assert np.abs(got[0, ..., 0].astype(int) - ref.astype(int)).max() <= 1
    xf = x.astype(np.float32) / 255
    got = _port(tcv.Laplacian, xf, -1, ksize=ksize, scale=2.0, delta=0.5)
    np.testing.assert_allclose(got, np.asarray(jcv.Laplacian(xf, -1, ksize=ksize, scale=2.0,
                                                             delta=0.5)), rtol=0, atol=1e-5)


def test_spatial_gradient():
    x = _rand(4, (30, 30))
    odx, ody = tcv.spatialGradient(torch.from_numpy(x))
    jdx, jdy = jcv.spatialGradient(x)
    rdx, rdy = cv2.spatialGradient(x)
    for got, want, ref in ((odx, jdx, rdx), (ody, jdy, rdy)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), ref)


def test_deriv_host_tables_equal_reference():
    for ksize in (-1, 1, 3, 5, 7):
        for dx in range(3):
            for dy in range(3):
                if ksize == -1 and dx + dy != 1:
                    continue
                for normalize in (False, True):
                    for ktype in (np.float32, np.float64):
                        ours = tcv.getDerivKernels(dx, dy, ksize, normalize, ktype)
                        want = jcv.getDerivKernels(dx, dy, ksize, normalize, ktype)
                        for o, w in zip(ours, want):
                            assert o.dtype == w.dtype
                            np.testing.assert_array_equal(o, w)
    for ksize in (1, 3, 5, 7, 9):
        for order in range(min(ksize, 3)):
            np.testing.assert_array_equal(_sobel_1d(order, ksize), j_sobel_1d(order, ksize))
    for dx, dy, ks, norm in [(1, 0, 3, False), (2, 1, 5, False), (1, 0, 7, True),
                             (0, 1, -1, False), (1, 0, -1, True)]:
        for o, r in zip(tcv.getDerivKernels(dx, dy, ks, normalize=norm),
                        cv2.getDerivKernels(dx, dy, ks, normalize=norm)):
            np.testing.assert_allclose(o, r, rtol=0, atol=1e-12)
    with pytest.raises(ValueError):
        tcv.getDerivKernels(1, 1, -1)


# ------------------------------------------------------------ pyramids

def test_pyr_down_taps_equal_reference():
    assert _PD_K == J_PD_K


@pytest.mark.parametrize("border", [tcv.BORDER_REFLECT_101, tcv.BORDER_REPLICATE,
                                    tcv.BORDER_REFLECT, tcv.BORDER_WRAP])
@pytest.mark.parametrize("shape", [(48, 64, 3), (47, 63, 1), (33, 41, 4), (16, 17, 3)])
def test_pyr_down_u8(shape, border, monkeypatch):
    x = _rand(shape[0] + border, (2, *shape))
    reset_tier_stats()
    got = _port(tcv.pyrDown, x, borderType=border)
    assert tier_stats() == {"tier.pyr_down_u8.plain": 1}
    # opencv_tpu through its Pallas kernel (interpret mode) and its XLA tier
    monkeypatch.setenv("OPENCV_TPU_PALLAS", "force")
    np.testing.assert_array_equal(got, np.asarray(jcv.pyrDown(x, borderType=border)))
    monkeypatch.setenv("OPENCV_TPU_PALLAS", "0")
    np.testing.assert_array_equal(got, np.asarray(jcv.pyrDown(x, borderType=border)))
    for i in range(2):
        np.testing.assert_array_equal(_img(got, i), cv2.pyrDown(_img(x, i), borderType=border))


def test_pyr_down_other_dtypes_and_constant_border():
    xf = np.random.default_rng(12).random((1, 40, 40, 1), dtype=np.float32)
    got = _port(tcv.pyrDown, xf)
    np.testing.assert_allclose(got, np.asarray(jcv.pyrDown(xf)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0, ..., 0], cv2.pyrDown(xf[0, ..., 0]), rtol=0, atol=1e-5)
    x16 = np.random.default_rng(13).integers(0, 65536, (1, 21, 30, 2), np.uint16)
    np.testing.assert_array_equal(_port(tcv.pyrDown, x16)[0], cv2.pyrDown(x16[0]))
    img = _rand(14, (20, 22))
    assert tcv.pyrDown(torch.from_numpy(img), (11, 10)).shape == (10, 11)
    with pytest.raises(NotImplementedError):
        tcv.pyrDown(torch.from_numpy(img), (12, 10))
    # cv::pyrDown refuses BORDER_CONSTANT; so does the port (opencv_tpu pads zeros)
    with pytest.raises(cv2.error):
        cv2.pyrDown(img, borderType=cv2.BORDER_CONSTANT)
    with pytest.raises(ValueError, match="BORDER_CONSTANT"):
        tcv.pyrDown(torch.from_numpy(img), borderType=tcv.BORDER_CONSTANT)


@pytest.mark.parametrize("shape", [(24, 32, 3), (17, 21, 3), (9, 12, 1)])
def test_pyr_up(shape):
    x = _rand(shape[0], (2, *shape))
    want = np.asarray(jcv.pyrUp(x))
    got = _port(tcv.pyrUp, x)
    np.testing.assert_array_equal(got, want)
    for i in range(2):
        np.testing.assert_array_equal(_img(got, i), cv2.pyrUp(_img(x, i)))
    H, W = shape[:2]
    img = _img(x, 0)
    for dsize in ((2 * W - 1, 2 * H), (2 * W, 2 * H - 1), (2 * W - 1, 2 * H - 1)):
        got = tcv.pyrUp(torch.from_numpy(img), dsize).numpy()
        np.testing.assert_array_equal(got, np.asarray(jcv.pyrUp(img, dsize)))
        np.testing.assert_array_equal(got, cv2.pyrUp(img, dstsize=dsize))
    xf = x.astype(np.float32) / 255
    np.testing.assert_allclose(_port(tcv.pyrUp, xf), np.asarray(jcv.pyrUp(xf)), rtol=0, atol=1e-6)


def test_build_pyramid():
    img = _rand(14, (64, 64))
    levels = tcv.buildPyramid(torch.from_numpy(img), 3)
    want = jcv.buildPyramid(img, 3)
    assert len(levels) == len(want) == 4
    ref = img
    for lv in range(1, 4):
        ref = cv2.pyrDown(ref)
        np.testing.assert_array_equal(levels[lv].numpy(), np.asarray(want[lv]))
        np.testing.assert_array_equal(levels[lv].numpy(), ref)
