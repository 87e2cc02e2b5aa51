"""opencv_tpu_torch ops vs opencv_tpu (and the cv2 oracle): cvtColor gray
family, GaussianBlur, resize, warpAffine, on the CPU (plain tier)."""

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv

BORDERS = [tcv.BORDER_CONSTANT, tcv.BORDER_REPLICATE, tcv.BORDER_REFLECT,
           tcv.BORDER_WRAP, tcv.BORDER_REFLECT_101]
GRAY_CODES = [tcv.COLOR_BGR2GRAY, tcv.COLOR_RGB2GRAY, tcv.COLOR_BGRA2GRAY, tcv.COLOR_RGBA2GRAY]


def _port(fn, x, *args, **kwargs):
    return np.asarray(fn(torch.from_numpy(x), *args, **kwargs))


def _assert_warp_close(ours, ref, msg=""):
    """The warp bound of tests/test_warp.py: max |d| <= 1 on at most 0.1% of
    pixels (f64 vs double-float coordinates, FMA contraction, rint ties)."""
    assert ours.shape == ref.shape, msg
    d = np.abs(ours.astype(int) - ref.astype(int))
    assert d.max() <= 1, f"{msg} max |d| = {d.max()}"
    assert np.count_nonzero(d) <= d.size // 1000, f"{msg} {np.count_nonzero(d)} differ"


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
@pytest.mark.parametrize("code", GRAY_CODES)
def test_cvtcolor_gray(code, dtype):
    rng = np.random.default_rng(code)
    cn = 4 if code in (tcv.COLOR_BGRA2GRAY, tcv.COLOR_RGBA2GRAY) else 3
    if dtype == np.float32:
        x = rng.random((2, 9, 13, cn), dtype=np.float32)
    else:
        x = rng.integers(0, np.iinfo(dtype).max + 1, (2, 9, 13, cn)).astype(dtype)
    want = np.asarray(jcv.cvtColor(x, code))
    got = _port(tcv.cvtColor, x, code)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if dtype != np.float32:
        np.testing.assert_array_equal(got[1, ..., 0], cv2.cvtColor(x[1], code))


@pytest.mark.parametrize("dtype", [np.float64, np.int16])
def test_cvtcolor_gray_refuses_depths_cv2_refuses(dtype):
    x = (np.random.default_rng(5).random((2, 9, 13, 3)) * 255).astype(dtype)
    with pytest.raises(cv2.error):
        cv2.cvtColor(x[0], cv2.COLOR_BGR2GRAY)
    with pytest.raises(ValueError, match="uint8, uint16 or float32"):
        tcv.cvtColor(torch.from_numpy(x), tcv.COLOR_BGR2GRAY)
    # divergence from opencv_tpu, which converts these depths
    assert np.asarray(jcv.cvtColor(x, jcv.COLOR_BGR2GRAY)).shape == (2, 9, 13, 1)


def test_cvtcolor_unported_code_raises():
    # every code of opencv_tpu's registry is ported; a code it does not
    # serve either (VNG demosaicing) raises
    x = torch.zeros((4, 4), dtype=torch.uint8)
    with pytest.raises(NotImplementedError, match="opencv_tpu does not serve it"):
        tcv.cvtColor(x, tcv.COLOR_BayerBG2BGR_VNG)
    with pytest.raises(NotImplementedError):
        jcv.cvtColor(x.numpy(), jcv.COLOR_BayerBG2BGR_VNG)


@pytest.mark.parametrize("border", BORDERS)
@pytest.mark.parametrize("sigma", [0.0, 1.5])
@pytest.mark.parametrize("k", [3, 5, 9, 31])
def test_gaussian_blur_u8(k, sigma, border):
    rng = np.random.default_rng(k * 10 + border)
    for cn in (1, 3):
        x = rng.integers(0, 256, (2, 23, 37, cn), np.uint8)
        want = np.asarray(jcv.GaussianBlur(x, (k, k), sigma, borderType=border))
        got = _port(tcv.GaussianBlur, x, (k, k), sigma, borderType=border)
        np.testing.assert_array_equal(got, want, err_msg=f"C={cn}")
        ref = cv2.GaussianBlur(x[0] if cn > 1 else x[0, ..., 0], (k, k), sigma,
                               borderType=border)
        np.testing.assert_array_equal(got[0] if cn > 1 else got[0, ..., 0], ref)


def test_gaussian_blur_per_image_auto_ksize_and_float():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (31, 40), np.uint8)
    for ks, sx, sy in (((0, 0), 1.2, 0.0), ((7, 3), 2.0, 0.7), ((0, 5), 1.1, 0.0)):
        want = np.asarray(jcv.GaussianBlur(img, ks, sx, sy))
        got = _port(tcv.GaussianBlur, img, ks, sx, sy)
        assert got.shape == img.shape
        np.testing.assert_array_equal(got, want)
    xf = rng.random((2, 17, 19, 3), dtype=np.float32)
    want = np.asarray(jcv.GaussianBlur(xf, (5, 5), 1.5))
    got = _port(tcv.GaussianBlur, xf, (5, 5), 1.5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_get_gaussian_kernel():
    for n, s in ((3, 0), (5, 1.1), (9, 0), (31, 4.0), (11, 0)):
        np.testing.assert_array_equal(tcv.getGaussianKernel(n, s), jcv.getGaussianKernel(n, s))
        # cv2's double path rounds the last bit differently for sigma > 0
        np.testing.assert_allclose(tcv.getGaussianKernel(n, s), cv2.getGaussianKernel(n, s),
                                   rtol=0, atol=1e-15)


RESIZE_CASES = [
    # (H, W, C, dsize, interpolation)
    (48, 64, 1, (32, 24), tcv.INTER_LINEAR),       # the 2x reroute to fast AREA
    (48, 64, 3, (32, 24), tcv.INTER_LINEAR),
    (48, 66, 3, (33, 24), tcv.INTER_AREA),         # AREA x2
    (45, 63, 1, (21, 15), tcv.INTER_AREA),         # AREA x3
    (48, 64, 3, (16, 12), tcv.INTER_AREA),         # AREA x4
    (37, 53, 3, (20, 31), tcv.INTER_LINEAR),       # non-integer ratios
    (37, 53, 1, (71, 90), tcv.INTER_LINEAR),       # upscale
    (30, 40, 3, (47, 55), tcv.INTER_AREA),         # AREA upscale = linear on area coords
]


@pytest.mark.parametrize("case", RESIZE_CASES, ids=[str(c) for c in RESIZE_CASES])
def test_resize_u8(case):
    H, W, C, dsize, interp = case
    x = np.random.default_rng(H * W).integers(0, 256, (2, H, W, C), np.uint8)
    want = np.asarray(jcv.resize(x, dsize, interpolation=interp))
    got = _port(tcv.resize, x, dsize, interpolation=interp)
    np.testing.assert_array_equal(got, want)
    ref = cv2.resize(x[1] if C > 1 else x[1, ..., 0], dsize, interpolation=interp)
    np.testing.assert_array_equal(got[1] if C > 1 else got[1, ..., 0], ref)


def test_resize_area_float_and_fx():
    xf = np.random.default_rng(8).random((1, 24, 36, 3), dtype=np.float32)
    want = np.asarray(jcv.resize(xf, (12, 8), interpolation=jcv.INTER_AREA))
    np.testing.assert_array_equal(_port(tcv.resize, xf, (12, 8), interpolation=tcv.INTER_AREA),
                                  want)
    x = np.random.default_rng(9).integers(0, 256, (24, 36), np.uint8)
    got = _port(tcv.resize, x, None, fx=0.5, fy=0.5)
    np.testing.assert_array_equal(got, np.asarray(jcv.resize(x, None, fx=0.5, fy=0.5)))
    assert _port(tcv.resize, x, (36, 24)).shape == (24, 36)


@pytest.mark.parametrize("interp", [tcv.INTER_NEAREST, tcv.INTER_CUBIC, tcv.INTER_LANCZOS4])
def test_resize_unported_mode_raises(interp):
    """These modes raised NotImplementedError until config 2's slice ported
    them; each now equals opencv_tpu on u8 (tests/test_torch_resize.py has
    the full matrix)."""
    x = np.random.default_rng(interp).integers(0, 256, (8, 8), np.uint8)
    for dsize in ((5, 3), (13, 11)):
        got = _port(tcv.resize, x, dsize, interpolation=interp)
        np.testing.assert_array_equal(got, np.asarray(jcv.resize(x, dsize, interpolation=interp)))


def test_rotation_and_inverse_matrix():
    for center, angle, scale in (((480.0, 270.0), 15.0, 0.9), ((31.5, 23.4), -30.0, 1.3)):
        M = tcv.getRotationMatrix2D(center, angle, scale)
        np.testing.assert_array_equal(M, jcv.getRotationMatrix2D(center, angle, scale))
        # cv2 takes the centre as a Point2f, hence the f32-sized tolerance
        np.testing.assert_allclose(M, cv2.getRotationMatrix2D(center, angle, scale),
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(tcv.invertAffineTransform(M),
                                      jcv.invertAffineTransform(M))


@pytest.mark.parametrize("cn", [1, 3])
@pytest.mark.parametrize("border", BORDERS)
def test_warp_affine_linear(border, cn):
    rng = np.random.default_rng(border)
    x = rng.integers(0, 256, (2, 48, 64, cn), np.uint8)
    M = cv2.getRotationMatrix2D((31.5, 23.4), 30.0, 0.8)
    bval = (11, 22, 33, 44) if cn == 3 else 200
    want = np.asarray(jcv.warpAffine(x, M, (70, 50), borderMode=border, borderValue=bval))
    got = _port(tcv.warpAffine, x, M, (70, 50), borderMode=border, borderValue=bval)
    _assert_warp_close(got, want, "vs opencv_tpu")
    for i in range(2):
        ref = cv2.warpAffine(x[i] if cn > 1 else x[i, ..., 0], M, (70, 50),
                             borderMode=border, borderValue=bval)
        _assert_warp_close(got[i] if cn > 1 else got[i, ..., 0], ref, f"vs cv2 img {i}")


def test_warp_affine_inverse_map_and_unported():
    x = np.random.default_rng(1).integers(0, 256, (40, 40), np.uint8)
    M = cv2.getRotationMatrix2D((20.0, 20.0), 10.0, 1.1)
    flags = tcv.INTER_LINEAR | tcv.WARP_INVERSE_MAP
    got = _port(tcv.warpAffine, x, M, (40, 40), flags=flags)
    _assert_warp_close(got, np.asarray(jcv.warpAffine(x, M, (40, 40), flags=flags)))
    _assert_warp_close(got, cv2.warpAffine(x, M, (40, 40), flags=flags))
    # INTER_NEAREST raised NotImplementedError until config 2's slice; its
    # integer AB_BITS grid now equals opencv_tpu and cv2 exactly
    nn = _port(tcv.warpAffine, x, M, (40, 40), flags=tcv.INTER_NEAREST)
    np.testing.assert_array_equal(nn, np.asarray(jcv.warpAffine(x, M, (40, 40),
                                                                flags=tcv.INTER_NEAREST)))
    np.testing.assert_array_equal(nn, cv2.warpAffine(x, M, (40, 40), flags=cv2.INTER_NEAREST))


# (dtype, input range, max |d| allowed against cv2, share of pixels that may
# differ).  cv2 5.0 warps 8U, 16U and 32F with the exact fraction of the map,
# as the port does, in another arithmetic order: u8 within the warp bound
# above, u16 +-1 (full-range noise) and f32 (noise in 0..255) within 2e-3.
# (u8 differs on up to 0.24% of pixels with this map.)  16S and 64F go through cv2's fixed-point map (a Q5 fraction), which the
# port reproduces: equal.
WARP_DEPTHS = {
    "uint8": (np.uint8, 256, 1, 5e-3),
    "uint16": (np.uint16, 65536, 1, 4e-2),
    "int16": (np.int16, 30000, 0, 0),
    "float32": (np.float32, 255, 2e-3, 1.0),
    "float64": (np.float64, 255, 0, 0),
}


@pytest.mark.parametrize("border", BORDERS)
@pytest.mark.parametrize("depth", list(WARP_DEPTHS))
def test_warp_affine_linear_depths_against_cv2(depth, border):
    dtype, hi, max_d, share = WARP_DEPTHS[depth]
    rng = np.random.default_rng(border)
    if np.dtype(dtype).kind == "f":
        x = (rng.random((2, 48, 64, 3)) * hi).astype(dtype)
    else:
        x = rng.integers(-hi if dtype == np.int16 else 0, hi, (2, 48, 64, 3)).astype(dtype)
    M = np.array([[0.9, 0.2, 3.3], [-0.25, 1.1, -4.2]])
    kw = dict(borderMode=border, borderValue=(7.25, 8, 9))
    got = _port(tcv.warpAffine, x, M, (70, 50), **kw)
    assert got.dtype == dtype
    for i in range(2):
        ref = cv2.warpAffine(x[i], M, (70, 50), **kw)
        d = np.abs(got[i].astype(np.float64) - ref)
        assert d.max() <= max_d, f"image {i}: max |d| {d.max()}"
        assert np.count_nonzero(d) <= share * d.size, f"image {i}: {np.count_nonzero(d)} differ"
    want = np.asarray(jcv.warpAffine(x, M, (70, 50), **kw)).astype(np.float64)
    if depth in ("int16", "float64"):
        # divergence from opencv_tpu, which takes the exact fraction here
        # (opencv_tpu/ops/warp.py, _floor_frac_dd) and is far from cv2
        ref = cv2.warpAffine(x[0], M, (70, 50), **kw)
        assert np.abs(want[0] - ref).max() > 1
    else:
        assert np.abs(got - want).max() <= max_d
