"""opencv_tpu_torch.resize against opencv_tpu and the cv2 oracle, on the CPU,
for every interpolation.

u8 NEAREST, NEAREST_EXACT, CUBIC, LANCZOS4, LINEAR_EXACT and integer-ratio
AREA are integer arithmetic on both sides: ``array_equal`` to opencv_tpu.
Against cv2 the port is held to the contract tests/test_resize.py holds the
reference to: NEAREST, NEAREST_EXACT and LINEAR_EXACT u8 exact, CUBIC and
LANCZOS4 u8 ±1 (the reference's Q22 vertical pass rounds where cv2's float
one ties), f32 LINEAR 1e-4 on [0, 1) input, u16 LINEAR ±1, AREA ±1.
Float paths run in another order than XLA's fused multiply-adds, so they
are held to opencv_tpu within the same bounds.
"""

import numpy as np
import pytest
import torch

from common import cv2, rand_img

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from torch_threads import _one_torch_thread  # noqa: F401

# the sizes of tests/test_resize.py: (src, dst) as (width, height)
SIZES = [((640, 480), (320, 240)), ((320, 240), (640, 480)),
         ((97, 61), (53, 41)), ((53, 41), (97, 61)),
         ((64, 64), (32, 32)), ((33, 27), (99, 81))]
EXACT_U8 = {"NEAREST": tcv.INTER_NEAREST, "NEAREST_EXACT": tcv.INTER_NEAREST_EXACT,
            "CUBIC": tcv.INTER_CUBIC, "LANCZOS4": tcv.INTER_LANCZOS4,
            "LINEAR_EXACT": tcv.INTER_LINEAR_EXACT}
# max |d| allowed against cv2 (tests/test_resize.py)
CV2_ATOL_U8 = {"NEAREST": 0, "NEAREST_EXACT": 0, "CUBIC": 1, "LANCZOS4": 1, "LINEAR_EXACT": 0}


def _port(x, dsize, interp):
    return tcv.resize(torch.from_numpy(x), dsize, interpolation=interp).numpy()


def _ref(x, dsize, interp):
    return np.asarray(jcv.resize(x, dsize, interpolation=interp))


def _assert_within(got, want, atol, msg=""):
    assert got.shape == want.shape and got.dtype == want.dtype, msg
    d = np.abs(got.astype(np.float64) - want.astype(np.float64)).max()
    assert d <= atol, f"{msg} max |d| {d} > {atol}"


@pytest.mark.parametrize("src,dst", SIZES, ids=[f"{s}->{d}" for s, d in SIZES])
@pytest.mark.parametrize("mode", list(EXACT_U8))
def test_resize_u8_equals_opencv_tpu(mode, src, dst):
    interp = EXACT_U8[mode]
    rng = np.random.default_rng(src[0] + dst[0])
    for cn in (1, 3, 4):
        x = rng.integers(0, 256, (2, src[1], src[0], cn), np.uint8)
        got = _port(x, dst, interp)
        np.testing.assert_array_equal(got, _ref(x, dst, interp), err_msg=f"C={cn}")
        img = x[1] if cn > 1 else x[1, ..., 0]
        _assert_within(got[1] if cn > 1 else got[1, ..., 0],
                       cv2.resize(img, dst, interpolation=interp), CV2_ATOL_U8[mode],
                       f"vs cv2 C={cn}")


def test_resize_cubic_u8_equals_cv2_without_ipp():
    """cv2's own CUBIC, with IPP off, is the reference's Q22 result up to
    its rare float ties (ROADMAP queue C: exact only without IPP)."""
    x = rand_img(np.random.default_rng(6), 61, 97, 3)
    prev = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        ref = cv2.resize(x, (53, 41), interpolation=cv2.INTER_CUBIC)
    finally:
        cv2.ipp.setUseIPP(prev)
    got = _port(x, (53, 41), tcv.INTER_CUBIC)
    d = np.abs(got.astype(int) - ref.astype(int))
    assert d.max() <= 1 and np.count_nonzero(d) <= d.size // 1000


def test_resize_nearest_fx_fy():
    x = rand_img(np.random.default_rng(11), 48, 64, 3)
    got = tcv.resize(torch.from_numpy(x), None, fx=0.5, fy=0.25,
                     interpolation=tcv.INTER_NEAREST).numpy()
    np.testing.assert_array_equal(got, cv2.resize(x, None, fx=0.5, fy=0.25,
                                                  interpolation=cv2.INTER_NEAREST))


# (dtype, modes, max |d| against cv2 and opencv_tpu)
FLOAT_DEPTHS = {
    "float32": (np.float32, 1e-4),
    "uint16": (np.uint16, 1),
    "int16": (np.int16, 1),
}


@pytest.mark.parametrize("src,dst", SIZES, ids=[f"{s}->{d}" for s, d in SIZES])
@pytest.mark.parametrize("mode", ["LINEAR", "LINEAR_EXACT", "CUBIC", "LANCZOS4"])
@pytest.mark.parametrize("depth", list(FLOAT_DEPTHS))
def test_resize_other_depths(depth, mode, src, dst):
    """f32, u16 and i16 take the f32 path (LINEAR_EXACT the f32 LINEAR
    path, as opencv_tpu reroutes it); held to opencv_tpu and, for LINEAR,
    to cv2 within tests/test_resize.py's bounds (1e-4 for f32 on [0, 1),
    ±1 for integers)."""
    dtype, atol = FLOAT_DEPTHS[depth]
    interp = getattr(tcv, f"INTER_{mode}")
    x = rand_img(np.random.default_rng(4), src[1], src[0], 3, dtype)
    got = _port(x, dst, interp)
    assert got.dtype == dtype
    _assert_within(got, _ref(x, dst, interp), atol, "vs opencv_tpu")
    if mode == "LINEAR":
        _assert_within(got, cv2.resize(x, dst, interpolation=interp), atol, "vs cv2")


AREA_CASES = [((640, 480), (320, 240)), ((96, 48), (32, 16)), ((100, 80), (40, 32)),
              ((97, 61), (53, 41)), ((50, 40), (100, 75)), ((61, 97), (40, 200))]


@pytest.mark.parametrize("src,dst", AREA_CASES, ids=[f"{s}->{d}" for s, d in AREA_CASES])
@pytest.mark.parametrize("depth", ["uint8", "float32", "uint16"])
def test_resize_area(depth, src, dst):
    """AREA: integer ratios (exact mean), fractional ratios (the span
    tables as two f32 products, run in IEEE f32: TF32 is off for them on
    the card), upscales (bilinear on area coordinates) and a mixed one.
    u8 at integer ratios and u8 upscales equal opencv_tpu exactly; every
    case is within tests/test_resize.py's AREA bound of cv2 (±1 for
    integers, 1e-4 for f32 on [0, 1)) and of opencv_tpu."""
    dtype = np.dtype(depth).type
    atol = 1e-4 if dtype == np.float32 else 1
    x = rand_img(np.random.default_rng(8), src[1], src[0], 3, dtype)
    got = _port(x, dst, tcv.INTER_AREA)
    want = _ref(x, dst, tcv.INTER_AREA)
    fractional = src[0] % dst[0] != 0 or src[1] % dst[1] != 0
    if dtype == np.uint8 and not (fractional and src[0] > dst[0]):
        np.testing.assert_array_equal(got, want)
    _assert_within(got, want, atol, "vs opencv_tpu")
    _assert_within(got, cv2.resize(x, dst, interpolation=cv2.INTER_AREA), atol, "vs cv2")


def test_resize_raises_no_not_implemented():
    """Every interpolation of cv::resize runs on every depth the reference
    takes; an unknown one is a ValueError, as in opencv_tpu."""
    x = torch.from_numpy(rand_img(np.random.default_rng(1), 9, 7, 3))
    for interp in range(7):
        for dtype in (torch.uint8, torch.uint16, torch.int16, torch.float32, torch.float64):
            for dsize in ((3, 4), (12, 15), (7, 3)):
                assert tcv.resize(x.to(dtype), dsize, interpolation=interp).shape == \
                    (dsize[1], dsize[0], 3)
    with pytest.raises(ValueError):
        tcv.resize(x, (3, 4), interpolation=7)
    with pytest.raises(ValueError):
        jcv.resize(x.numpy(), (3, 4), interpolation=7)


def test_resize_tables_are_cached_on_the_device():
    """CUBIC and LANCZOS4 build their taps once per (source, destination,
    device): a repeated resize copies nothing from the host."""
    from opencv_tpu_torch.ops import resize as R
    R._ksize_tables.cache_clear()
    x = torch.from_numpy(rand_img(np.random.default_rng(2), 40, 60, 3))
    for _ in range(3):
        tcv.resize(x, (33, 21), interpolation=tcv.INTER_CUBIC)
    info = R._ksize_tables.cache_info()
    assert (info.misses, info.hits) == (2, 4)
