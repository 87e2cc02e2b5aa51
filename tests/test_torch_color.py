"""opencv_tpu_torch cvtColor and cvtColorTwoPlane vs opencv_tpu (and the cv2
oracle), on the CPU: every code of the JAX package's registry, the Bayer
codes, and the divergences the port holds to cv2 instead."""

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu.ops import color as jcolor
from opencv_tpu_torch.ops import color as tcolor

# one name per code of the JAX registry
_NAMES = {}
for _n in sorted(dir(jcv)):
    if _n.startswith("COLOR_"):
        _NAMES.setdefault(getattr(jcv, _n), _n)
CODES = sorted(jcolor._REGISTRY)

YUV420_IN = {c for c in CODES if _NAMES[c].startswith("COLOR_YUV2")
             and any(k in _NAMES[c] for k in ("NV12", "NV21", "IYUV", "I420", "YV12", "_420"))}
YUV422_IN = {c for c in CODES if _NAMES[c].startswith("COLOR_YUV2")
             and any(k in _NAMES[c] for k in ("YUY2", "UYVY", "YVYU", "YUNV", "UYNV"))}
YUV_ENC = {c for c in CODES if "2YUV_" in _NAMES[c]}
PACKED = {c for c in CODES if "565" in _NAMES[c] or "555" in _NAMES[c]}
U8_ONLY = YUV420_IN | YUV422_IN | YUV_ENC | PACKED
LAB_LUV = {c for c in CODES if "LAB" in _NAMES[c] or "LUV" in _NAMES[c]}
HSV_HLS = {c for c in CODES if "HSV" in _NAMES[c] or "HLS" in _NAMES[c]}


def _channels(code) -> int:
    src = _NAMES[code][len("COLOR_"):].split("2")[0]
    return {"GRAY": 1, "BGRA": 4, "RGBA": 4, "BGR565": 2, "BGR555": 2}.get(src, 3)


def _input(code, dtype, seed):
    rng = np.random.default_rng(seed)
    if code in YUV420_IN:
        return rng.integers(0, 256, (2, 36, 64, 1), np.uint8)
    if code in YUV422_IN:
        return rng.integers(0, 256, (2, 24, 32, 2), np.uint8)
    shape = (2, 24, 32, _channels(code))
    if dtype == np.float32:
        x = rng.random(shape, dtype=np.float32)
        name = _NAMES[code]
        if name.startswith(("COLOR_HSV2", "COLOR_HLS2")):
            x[..., 0] *= 360
        elif name.startswith("COLOR_LAB2"):
            x = x * np.float32([100, 254, 254]) - np.float32([0, 127, 127])
        elif name.startswith("COLOR_LUV2"):
            x = x * np.float32([100, 354, 262]) - np.float32([0, 134, 140])
        return x
    return rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype)


def _both(code, x):
    return np.asarray(jcv.cvtColor(x, code)), tcv.cvtColor(torch.from_numpy(x), code).numpy()


def test_registry_serves_every_code_of_the_reference():
    assert set(tcolor._REGISTRY) == set(jcolor._REGISTRY)
    assert len(CODES) == 127


@pytest.mark.parametrize("code", CODES, ids=[_NAMES[c] for c in CODES])
def test_cvtcolor_u8_equals_opencv_tpu(code):
    want, got = _both(code, _input(code, np.uint8, code))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


U16_CODES = [c for c in CODES if c not in U8_ONLY | LAB_LUV]


@pytest.mark.parametrize("code", U16_CODES, ids=[_NAMES[c] for c in U16_CODES])
def test_cvtcolor_u16_equals_opencv_tpu(code):
    want, got = _both(code, _input(code, np.uint16, code + 1000))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


F32_CODES = [c for c in CODES if c not in U8_ONLY]


@pytest.mark.parametrize("code", F32_CODES, ids=[_NAMES[c] for c in F32_CODES])
def test_cvtcolor_f32_within_opencv_tpu_tolerance(code):
    """tests/test_color.py's tolerances: 1e-5 on the linear families, 2e-3
    on HSV/HLS and Lab/Luv (float division, cbrt and pow; XLA contracts
    multiply-adds where eager torch rounds each op)."""
    want, got = _both(code, _input(code, np.float32, code + 2000))
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    tol = 2e-3 if code in LAB_LUV | HSV_HLS else 1e-5
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _lab_sample():
    """2^18 random pixels, then all 256 grays and the cube's corners."""
    rng = np.random.default_rng(30)
    rand = rng.integers(0, 256, (1 << 18, 3), np.uint8)
    grays = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    corners = np.array([[b, g, r] for b in (0, 255) for g in (0, 255) for r in (0, 255)],
                       np.uint8)
    px = np.concatenate([rand, grays, corners])
    px = np.concatenate([px, px[: -len(px) % 512]])
    return px.reshape(-1, 512, 3)


LAB_U8 = sorted(LAB_LUV)


@pytest.mark.parametrize("code", LAB_U8, ids=[_NAMES[c] for c in LAB_U8])
def test_lab_luv_u8_sample_equals_opencv_tpu(code):
    want, got = _both(code, _lab_sample())
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("code", ["COLOR_BGR2Lab", "COLOR_BGR2Luv", "COLOR_Lab2BGR",
                                  "COLOR_Luv2BGR"])
def test_lab_luv_u8_exhaustive_against_cv2(code):
    """All 2^24 u8 inputs on the port alone against cv2 (a few seconds
    each): the fixed-point pipelines over the copied tables, with
    Luv2RGBinteger's 64-bit intermediates in int64."""
    vals = np.arange(256, dtype=np.uint8)
    img = np.stack(np.meshgrid(vals, vals, vals, indexing="ij"), axis=-1).reshape(4096, 4096, 3)
    got = tcv.cvtColor(torch.from_numpy(img), getattr(tcv, code)).numpy()
    ref = cv2.cvtColor(img, getattr(cv2, code))
    assert np.count_nonzero(got != ref) == 0


def test_lab_luts_are_the_reference_tables():
    """The port's copy of lab_luts.npz holds the JAX package's arrays."""
    import os
    ref = np.load(os.path.join(os.path.dirname(jcolor.__file__), "lab_luts.npz"))
    ours = np.load(tcolor._LAB_LUTS_PATH)
    assert sorted(ref.files) == sorted(ours.files)
    for k in ref.files:
        assert ref[k].dtype == ours[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


@pytest.mark.parametrize("code", ["COLOR_BGR2Lab", "COLOR_Lab2BGR", "COLOR_BGR2Luv",
                                  "COLOR_LBGR2Luv"])
def test_lab_luv_u16_raises_as_cv2_does(code):
    """Divergence: cv2 takes Lab/Luv from 8U and 32F only.  opencv_tpu
    converts 16-bit input (through its 8-bit tables and clamped gathers, or
    for LBGR2Luv its float path); the port raises, as cv2 does."""
    x = np.random.default_rng(3).integers(0, 65536, (8, 8, 3), np.uint16)
    with pytest.raises(cv2.error):
        cv2.cvtColor(x, getattr(cv2, code))
    assert np.asarray(jcv.cvtColor(x, getattr(jcv, code))).shape == (8, 8, 3)
    with pytest.raises(ValueError, match="uint8 or float32"):
        tcv.cvtColor(torch.from_numpy(x), getattr(tcv, code))


@pytest.mark.parametrize("code", ["COLOR_BGR2HSV", "COLOR_BGR2HSV_FULL", "COLOR_BGR2HLS",
                                  "COLOR_HSV2BGR", "COLOR_HLS2BGR_FULL", "COLOR_BGR2YCrCb",
                                  "COLOR_YCrCb2BGR", "COLOR_BGR2XYZ", "COLOR_XYZ2BGR",
                                  "COLOR_BGR2YUV", "COLOR_BGR2Lab", "COLOR_Lab2BGR",
                                  "COLOR_BGR2Luv", "COLOR_Luv2BGR"])
def test_cvtcolor_u8_against_cv2(code):
    """The port's u8 path against cv2, per image, with the bound
    tests/test_color.py holds the reference to: exact, but HLS (±1 on rare
    float ties) and the HSV/HLS inverses (±1)."""
    x = np.random.default_rng(40).integers(0, 256, (2, 48, 64, 3), np.uint8)
    got = tcv.cvtColor(torch.from_numpy(x), getattr(tcv, code)).numpy()
    atol = 1 if ("HLS" in code or code.startswith(("COLOR_HSV2", "COLOR_HLS2"))) else 0
    for i in range(2):
        ref = cv2.cvtColor(x[i], getattr(cv2, code))
        assert np.abs(got[i].astype(int) - ref.astype(int)).max() <= atol


def test_hsv_u8_division_tables():
    """The arithmetic form of cv2's sdiv/hdiv tables (rint(a / d) ==
    (2a + d) // 2d) gives the tables' entries for every denominator."""
    d = np.arange(1, 256 * 6 + 1, dtype=np.int64)
    for num, den in (((255 << 12), d[:255]), ((180 << 12), 6 * d[:255]),
                     ((256 << 12), 6 * d[:255])):
        want = np.rint(num / den.astype(np.float64)).astype(np.int64)
        q = num / den
        assert not np.any(q - np.floor(q) == 0.5)   # no quotient on a half
        np.testing.assert_array_equal((2 * num + den) // (2 * den), want)


BAYER = ["COLOR_BayerBG2BGR", "COLOR_BayerGB2BGR", "COLOR_BayerRG2BGR", "COLOR_BayerGR2BGR",
         "COLOR_BayerBG2RGB", "COLOR_BayerGB2RGB", "COLOR_BayerRG2RGB", "COLOR_BayerGR2RGB",
         "COLOR_BayerRGGB2BGR", "COLOR_BayerGRBG2RGB"]


@pytest.mark.parametrize("code", BAYER)
def test_bayer_equals_opencv_tpu_and_cv2(code):
    raw = np.random.default_rng(5).integers(0, 256, (2, 30, 44), np.uint8)
    want = np.asarray(jcv.cvtColor(raw[..., None], getattr(jcv, code)))
    got = tcv.cvtColor(torch.from_numpy(raw[..., None]), getattr(tcv, code)).numpy()
    np.testing.assert_array_equal(got, want)
    for i in range(2):
        np.testing.assert_array_equal(got[i], cv2.cvtColor(raw[i], getattr(cv2, code)))
    np.testing.assert_array_equal(tcv.demosaicing(torch.from_numpy(raw[0]), getattr(tcv, code)),
                                  got[0])


def test_unserved_codes_raise():
    x = torch.zeros((4, 4), dtype=torch.uint8)
    for code in (tcv.COLOR_BayerBG2BGR_VNG, tcv.COLOR_BayerBG2GRAY, tcv.COLOR_BayerBG2BGR_EA):
        with pytest.raises(NotImplementedError, match="opencv_tpu does not serve it"):
            tcv.cvtColor(x, code)


NV = ["COLOR_YUV2BGR_NV12", "COLOR_YUV2RGB_NV12", "COLOR_YUV2BGRA_NV12", "COLOR_YUV2RGBA_NV12",
      "COLOR_YUV2BGR_NV21", "COLOR_YUV2RGB_NV21", "COLOR_YUV2BGRA_NV21", "COLOR_YUV2RGBA_NV21"]


@pytest.mark.parametrize("code", NV)
def test_cvtcolor_two_plane_single_and_batched(code):
    """The single-image form equals opencv_tpu's and cv2's; the batched
    form (N, H, W) + (N, H/2, W/2, 2), beyond both, equals them image by
    image."""
    rng = np.random.default_rng(6)
    y = rng.integers(0, 256, (3, 36, 64), np.uint8)
    uv = rng.integers(0, 256, (3, 18, 32, 2), np.uint8)
    c = getattr(tcv, code)
    got = tcv.cvtColorTwoPlane(torch.from_numpy(y), torch.from_numpy(uv), c)
    assert isinstance(got, torch.Tensor) and got.shape == (3, 36, 64, 4 if "A_" in code else 3)
    for i in range(3):
        want = np.asarray(jcv.cvtColorTwoPlane(y[i], uv[i], c))
        np.testing.assert_array_equal(got[i].numpy(), want)
        np.testing.assert_array_equal(got[i].numpy(), cv2.cvtColorTwoPlane(y[i], uv[i], c))
        one = tcv.cvtColorTwoPlane(torch.from_numpy(y[i]), torch.from_numpy(uv[i]), c)
        np.testing.assert_array_equal(one.numpy(), want)
    # the interleaved plane as cv2's (H/2, W) single-channel view
    flat = tcv.cvtColorTwoPlane(y[0], uv[0].reshape(18, 64), c)
    np.testing.assert_array_equal(flat.numpy(), got[0].numpy())


def test_cvtcolor_two_plane_refuses_what_cv2_refuses():
    y = np.zeros((8, 8), np.uint8)
    uv = np.zeros((4, 4, 2), np.uint8)
    with pytest.raises(cv2.error):
        cv2.cvtColorTwoPlane(y, uv, cv2.COLOR_YUV2BGR_I420)
    with pytest.raises(ValueError, match="NV12/NV21"):
        tcv.cvtColorTwoPlane(y, uv, tcv.COLOR_YUV2BGR_I420)
    with pytest.raises(ValueError, match="does not fit"):
        tcv.cvtColorTwoPlane(y, uv[:2], tcv.COLOR_YUV2BGR_NV12)
