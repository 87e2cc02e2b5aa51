"""opencv_tpu_torch's warps against opencv_tpu and the cv2 oracle, on the CPU:
warpAffine and warpPerspective with every interpolation, remap with float
and fixed-point maps, the polar warps and the transform builders.

The bound is tests/test_warp.py's: max |d| <= 1 on at most 0.1% of pixels
(the port takes coordinates in f64, the reference in double-float, so a
floor or a Q5 fraction may differ at a cell boundary; XLA fuses
multiply-adds that eager torch does not).  Where tests/test_warp.py checks
cv2, these tests check it too, under the same bound: NEAREST exact, LINEAR
and CUBIC ±1, LANCZOS4 |d| > 1 on at most 0.1% and |d| <= 8.
"""

import numpy as np
import pytest
import torch

from common import cv2, rand_img

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from torch_threads import _one_torch_thread  # noqa: F401

BORDERS = [tcv.BORDER_CONSTANT, tcv.BORDER_REPLICATE, tcv.BORDER_REFLECT,
           tcv.BORDER_REFLECT_101, tcv.BORDER_WRAP]
INTERPS = {"NEAREST": tcv.INTER_NEAREST, "LINEAR": tcv.INTER_LINEAR,
           "CUBIC": tcv.INTER_CUBIC, "LANCZOS4": tcv.INTER_LANCZOS4}
BVAL = (11, 22, 33, 44)


def _M_rot():
    return cv2.getRotationMatrix2D((31.5, 23.4), 30.0, 0.8)


def _P():
    src = np.float32([[0, 0], [63, 0], [63, 47], [0, 47]])
    dst = np.float32([[3, 2], [60, 5], [58, 44], [1, 40]])
    return cv2.getPerspectiveTransform(src, dst)


def _batch(seed, cn=3):
    """Two smooth u8 images (CUBIC and LANCZOS4 are held to cv2 on smooth
    input, as tests/test_warp.py does)."""
    rng = np.random.default_rng(seed)
    imgs = [cv2.GaussianBlur(rand_img(rng, 48, 64, 3), (5, 5), 1.5) for _ in range(2)]
    x = np.stack(imgs)
    return x if cn == 3 else x[..., :cn].copy()


def assert_warp_close(got, want, msg=""):
    """max |d| <= 1 on at most 0.1% of pixels."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, msg
    d = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert d.max() <= 1, f"{msg} max |d| = {d.max()}"
    assert np.count_nonzero(d) <= d.size // 1000, f"{msg} {np.count_nonzero(d)} differ"


def assert_cv2_bound(got, ref, mode, msg=""):
    """tests/test_warp.py's bound against cv2, per interpolation."""
    d = np.abs(got.astype(int) - ref.astype(int))
    if mode == "NEAREST":
        assert d.max() == 0, f"{msg} {np.count_nonzero(d)} differ"
    elif mode == "LANCZOS4":
        assert (d > 1).mean() <= 1e-3 and d.max() <= 8, f"{msg} max |d| = {d.max()}"
    else:
        assert d.max() <= 1, f"{msg} max |d| = {d.max()}"
        if mode == "LINEAR":
            assert np.count_nonzero(d) <= d.size // 1000, f"{msg} {np.count_nonzero(d)} differ"


def _port(fn, x, *args, **kwargs):
    return fn(torch.from_numpy(x), *args, **kwargs).numpy()


@pytest.mark.parametrize("border", BORDERS)
@pytest.mark.parametrize("mode", list(INTERPS))
def test_warp_affine_u8(mode, border):
    x = _batch(border)
    kw = dict(flags=INTERPS[mode], borderMode=border, borderValue=BVAL)
    got = _port(tcv.warpAffine, x, _M_rot(), (70, 50), **kw)
    assert_warp_close(got, jcv.warpAffine(x, _M_rot(), (70, 50), **kw), "vs opencv_tpu")
    for i in range(2):
        assert_cv2_bound(got[i], cv2.warpAffine(x[i], _M_rot(), (70, 50), **kw), mode,
                         f"vs cv2 image {i}")


@pytest.mark.parametrize("border", BORDERS)
@pytest.mark.parametrize("mode", list(INTERPS))
def test_warp_perspective_u8(mode, border):
    x = _batch(10 + border)
    kw = dict(flags=INTERPS[mode], borderMode=border, borderValue=BVAL)
    got = _port(tcv.warpPerspective, x, _P(), (64, 48), **kw)
    assert_warp_close(got, jcv.warpPerspective(x, _P(), (64, 48), **kw), "vs opencv_tpu")
    for i in range(2):
        assert_cv2_bound(got[i], cv2.warpPerspective(x[i], _P(), (64, 48), **kw),
                         "LINEAR" if mode == "NEAREST" else mode, f"vs cv2 image {i}")


@pytest.mark.parametrize("cn", [1, 4])
def test_warps_inverse_map_and_channels(cn):
    x = _batch(20, cn)
    for mode, interp in INTERPS.items():
        flags = interp | tcv.WARP_INVERSE_MAP
        got = _port(tcv.warpAffine, x, _M_rot(), (40, 40), flags=flags)
        assert_warp_close(got, jcv.warpAffine(x, _M_rot(), (40, 40), flags=flags), mode)
        got = _port(tcv.warpPerspective, x, _P(), (40, 40), flags=flags)
        assert_warp_close(got, jcv.warpPerspective(x, _P(), (40, 40), flags=flags), mode)
        img = x[0] if cn > 1 else x[0, ..., 0]
        assert_cv2_bound(got[0] if cn > 1 else got[0, ..., 0],
                         cv2.warpPerspective(img, _P(), (40, 40), flags=flags),
                         "LINEAR" if mode == "NEAREST" else mode, f"{mode} vs cv2")


@pytest.mark.parametrize("mode", ["LINEAR", "CUBIC", "LANCZOS4"])
def test_warps_float32(mode):
    """f32 on [0, 1): within 1e-4 of opencv_tpu and cv2 (tests/test_warp.py's
    f32 bound; LANCZOS4 within 1e-3 of cv2, whose f32 tables it shares up
    to the Q5 rounding of the coordinate)."""
    x = np.random.default_rng(2).random((2, 40, 52, 3), dtype=np.float32)
    interp = INTERPS[mode]
    for fn, jfn, cfn, M in ((tcv.warpAffine, jcv.warpAffine, cv2.warpAffine, _M_rot()),
                            (tcv.warpPerspective, jcv.warpPerspective, cv2.warpPerspective,
                             _P())):
        got = _port(fn, x, M, (60, 44), flags=interp)
        np.testing.assert_allclose(got, np.asarray(jfn(x, M, (60, 44), flags=interp)),
                                   rtol=0, atol=1e-4)
        if mode != "LANCZOS4" or fn is tcv.warpPerspective:
            np.testing.assert_allclose(got[0], cfn(x[0], M, (60, 44), flags=interp), rtol=0,
                                       atol=1e-4 if mode != "LANCZOS4" else 1e-3)


# (dtype, input range, max |d| allowed against cv2, share of pixels that may
# differ), as tests/test_torch_ops.py's WARP_DEPTHS for warpAffine: cv2 5.0
# warps 8U, 16U and 32F by the exact fraction, as the port does; 16S and 64F
# go through its fixed-point map X = saturate_cast<int>(X0 * 32 / W), which
# the port reproduces: equal.  f32 noise in 0..255: cv2 divides in float,
# so its fraction is off by up to |X| 2^-23 (X < 70) on each axis, times a
# step of up to 255 per pixel: 5e-3.
PERSPECTIVE_DEPTHS = {
    "uint8": (np.uint8, 256, 1, 1e-3),
    "uint16": (np.uint16, 65536, 1, 5e-2),
    "int16": (np.int16, 30000, 0, 0),
    "float32": (np.float32, 255, 5e-3, 1.0),
    "float64": (np.float64, 255, 0, 0),
}


@pytest.mark.parametrize("border", BORDERS)
@pytest.mark.parametrize("depth", list(PERSPECTIVE_DEPTHS))
def test_warp_perspective_linear_depths_against_cv2(depth, border):
    dtype, hi, max_d, share = PERSPECTIVE_DEPTHS[depth]
    rng = np.random.default_rng(border)
    if np.dtype(dtype).kind == "f":
        x = (rng.random((2, 48, 64, 3)) * hi).astype(dtype)
    else:
        x = rng.integers(-hi if dtype == np.int16 else 0, hi, (2, 48, 64, 3)).astype(dtype)
    P = np.array([[0.95, 0.05, 8.0], [-0.04, 1.02, 4.0], [1e-4, -2e-4, 1.0]])
    kw = dict(borderMode=border, borderValue=(7.25, 8, 9))
    got = _port(tcv.warpPerspective, x, P, (70, 50), **kw)
    assert got.dtype == dtype
    for i in range(2):
        ref = cv2.warpPerspective(x[i], P, (70, 50), **kw)
        d = np.abs(got[i].astype(np.float64) - ref)
        assert d.max() <= max_d, f"image {i}: max |d| {d.max()}"
        assert np.count_nonzero(d) <= share * d.size, f"image {i}: {np.count_nonzero(d)} differ"
    want = np.asarray(jcv.warpPerspective(x, P, (70, 50), **kw)).astype(np.float64)
    if depth in ("int16", "float64"):
        # a divergence from opencv_tpu, which takes the exact fraction here
        # and is far from cv2 (ROADMAP queue C)
        assert np.abs(want[0] - cv2.warpPerspective(x[0], P, (70, 50), **kw)).max() > 1
    else:
        assert np.abs(got - want).max() <= max_d


def test_warp_perspective_zero_denominator():
    """Where the map's denominator is exactly 0 the coordinate is 0 (the JAX
    package's rule): column 10 of this inverse map samples pixel (0, 0).
    The map's entries are binary fractions, so its rounding ties (y / W =
    n + 0.5) are exact in f64 and in double-float alike."""
    x = _batch(30)
    M = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.125, 0.0, -1.25]])
    for mode, interp in INTERPS.items():
        flags = interp | tcv.WARP_INVERSE_MAP
        got = _port(tcv.warpPerspective, x, M, (24, 16), flags=flags,
                    borderMode=tcv.BORDER_REPLICATE)
        assert_warp_close(got, jcv.warpPerspective(x, M, (24, 16), flags=flags,
                                                   borderMode=tcv.BORDER_REPLICATE), mode)
    got = _port(tcv.warpPerspective, x, M, (24, 16),
                flags=tcv.INTER_NEAREST | tcv.WARP_INVERSE_MAP)
    np.testing.assert_array_equal(got[:, :, 10], np.broadcast_to(x[:, :1, 0], (2, 16, 3)))


def _maps(dh=44, dw=55):
    ys, xs = np.mgrid[0:dh, 0:dw].astype(np.float32)
    mapx = (xs * 0.9 - 0.7 + 3 * np.sin(ys * 0.2)).astype(np.float32)
    mapy = (ys * 0.85 - 0.9 + 2 * np.cos(xs * 0.3)).astype(np.float32)
    return mapx, mapy


@pytest.mark.parametrize("border", BORDERS)
@pytest.mark.parametrize("mode", ["NEAREST", "LINEAR"])
def test_remap_float_maps(mode, border):
    x = np.stack([rand_img(np.random.default_rng(s), 40, 50, 3) for s in (4, 5)])
    mapx, mapy = _maps()
    kw = dict(borderMode=border, borderValue=(5, 6, 7))
    interp = INTERPS[mode]
    got = _port(tcv.remap, x, mapx, mapy, interp, **kw)
    assert_warp_close(got, jcv.remap(x, mapx, mapy, interp, **kw), "vs opencv_tpu")
    # one two-channel map, and maps given as tensors, are the same maps
    np.testing.assert_array_equal(
        _port(tcv.remap, x, np.stack([mapx, mapy], -1), None, interp, **kw), got)
    np.testing.assert_array_equal(
        _port(tcv.remap, x, torch.from_numpy(mapx), torch.from_numpy(mapy), interp, **kw), got)
    for i in range(2):
        assert_cv2_bound(got[i], cv2.remap(x[i], mapx, mapy, interp, **kw), mode,
                         f"vs cv2 image {i}")


@pytest.mark.parametrize("border", BORDERS)
@pytest.mark.parametrize("depth", ["uint8", "uint16", "float32"])
def test_remap_fixed_maps(depth, border):
    """CV_16SC2 + CV_16UC1 maps from cv2.convertMaps: LINEAR takes the Q5
    table weights (u8: Q15 integers, equal to cv2), NEAREST the integer
    part; both equal opencv_tpu.  (cv2 5.0's NEAREST on fixed maps is not
    the integer part; the reference's tests do not hold it to cv2.)"""
    dtype = np.dtype(depth).type
    x = rand_img(np.random.default_rng(border), 40, 50, 3, dtype)
    m1, m2 = cv2.convertMaps(*_maps(), cv2.CV_16SC2)
    kw = dict(borderMode=border, borderValue=(5, 6, 7))
    for interp in (tcv.INTER_NEAREST, tcv.INTER_LINEAR):
        got = _port(tcv.remap, x, m1, m2, interp, **kw)
        want = np.asarray(jcv.remap(x, m1, m2, interp, **kw))
        if dtype == np.float32:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)
        if interp == tcv.INTER_LINEAR:
            ref = cv2.remap(x, m1, m2, interp, **kw)
            d = np.abs(got.astype(np.float64) - ref)
            assert d.max() <= (0 if dtype == np.uint8 else 1e-4 if dtype == np.float32 else 1)
    # no map2: every fraction 0
    got = _port(tcv.remap, x, m1, None, tcv.INTER_LINEAR, **kw)
    np.testing.assert_array_equal(got, _port(tcv.remap, x, m1, None, tcv.INTER_NEAREST, **kw))


@pytest.mark.parametrize("mode", ["CUBIC", "LANCZOS4"])
def test_remap_cubic_lanczos_blend_bilinearly(mode):
    """Inherited divergence (ROADMAP queue C): remap on float maps blends
    CUBIC and LANCZOS4 bilinearly, as opencv_tpu does; cv2 takes the 4×4 or
    8×8 window."""
    x = rand_img(np.random.default_rng(9), 40, 50, 3)
    mapx, mapy = _maps()
    interp = INTERPS[mode]
    got = _port(tcv.remap, x, mapx, mapy, interp)
    np.testing.assert_array_equal(got, _port(tcv.remap, x, mapx, mapy, tcv.INTER_LINEAR))
    assert_warp_close(got, jcv.remap(x, mapx, mapy, interp))
    assert np.abs(got.astype(int) - cv2.remap(x, mapx, mapy, interp).astype(int)).max() > 1


def test_transform_builders():
    src = np.float32([[0, 0], [10, 0], [0, 10]])
    dst = np.float32([[1, 2], [11, 3], [2, 13]])
    A = tcv.getAffineTransform(src, dst)
    np.testing.assert_array_equal(A, jcv.getAffineTransform(src, dst))
    np.testing.assert_allclose(A, cv2.getAffineTransform(src, dst), rtol=0, atol=1e-10)
    s4 = np.float32([[0, 0], [10, 0], [10, 10], [0, 10]])
    d4 = np.float32([[1, 1], [9, 2], [11, 9], [0, 8]])
    P = tcv.getPerspectiveTransform(s4, d4)
    np.testing.assert_array_equal(P, jcv.getPerspectiveTransform(s4, d4))
    np.testing.assert_allclose(P, cv2.getPerspectiveTransform(s4, d4), rtol=0, atol=1e-8)
    assert P.shape == (3, 3) and P[2, 2] == 1.0


def _polar_image():
    rng = np.random.default_rng(0)
    return cv2.GaussianBlur(rng.integers(0, 256, (120, 160), np.uint8), (5, 5), 2)


@pytest.mark.parametrize("log", [False, True], ids=["linear", "semilog"])
@pytest.mark.parametrize("mode", ["NEAREST", "LINEAR"])
def test_warp_polar(mode, log):
    """Forward and inverse against opencv_tpu (the warp bound), and the
    forward against cv2 where its source lies inside the image (cv2 leaves
    the rest as stale memory, BORDER_TRANSPARENT; tests/test_warp.py's
    bound: mean |d| < 0.6, |d| > 2 on under 1%)."""
    img = _polar_image()
    fl = (tcv.WARP_POLAR_LOG if log else tcv.WARP_POLAR_LINEAR) + INTERPS[mode]
    got = _port(tcv.warpPolar, img, (80, 180), (80, 60), 70, fl)
    assert_warp_close(got, jcv.warpPolar(img, (80, 180), (80, 60), 70, fl), "forward")
    back = _port(tcv.warpPolar, got, (160, 120), (80, 60), 70, fl + tcv.WARP_INVERSE_MAP)
    assert_warp_close(back, jcv.warpPolar(got, (160, 120), (80, 60), 70,
                                          fl + tcv.WARP_INVERSE_MAP), "inverse")
    ref = cv2.warpPolar(img, (80, 180), (80, 60), 70, fl)
    rr = np.arange(80) * ((np.log(70.0) / 80) if log else (70.0 / 80))
    mag = (np.exp(rr) - 1.0) if log else rr
    ang = np.arange(180) * (2 * np.pi / 180)
    sx = mag[None, :] * np.cos(ang)[:, None] + 80
    sy = mag[None, :] * np.sin(ang)[:, None] + 60
    valid = (sx >= 0) & (sx < 159) & (sy >= 0) & (sy < 119)
    d = np.abs(ref.astype(int) - got.astype(int))[valid]
    assert d.mean() < 0.6 and (d > 2).mean() < 0.01


def test_linear_and_log_polar():
    img = np.stack([_polar_image()] * 3, -1)
    for flags in (tcv.INTER_LINEAR, tcv.INTER_LINEAR + tcv.WARP_INVERSE_MAP):
        assert_warp_close(_port(tcv.linearPolar, img, (80, 60), 70, flags),
                          jcv.linearPolar(img, (80, 60), 70, flags), f"linearPolar {flags}")
        assert_warp_close(_port(tcv.logPolar, img, (80, 60), 40, flags),
                          jcv.logPolar(img, (80, 60), 40, flags), f"logPolar {flags}")
    # dsize (0, 0) and (w, 0): sizes from maxRadius, as the reference takes them
    assert tuple(tcv.warpPolar(torch.from_numpy(img), (0, 0), (80, 60), 30,
                               tcv.INTER_LINEAR).shape) == (94, 30, 3)
    assert tuple(tcv.warpPolar(torch.from_numpy(img), (20, 0), (80, 60), 30,
                               tcv.INTER_LINEAR).shape) == (63, 20, 3)


def test_warp_lanczos4_table_quirk():
    """initInterTab2D's sum-corrected Q15 tables, flat-memory quirk included,
    equal the JAX package's; every row sums to 2^15."""
    from opencv_tpu.ops import warp as jwarp
    from opencv_tpu_torch.ops import warp as twarp
    for k in (2, 4, 8):
        f, i = twarp._inter_tab(k)
        jf, ji = jwarp._inter_tab(k)
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(i, ji)
        if k > 2:
            assert (i.sum(1) == 1 << 15).all()
