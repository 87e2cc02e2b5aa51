"""opencv_tpu_torch's morphology (getStructuringElement, erode, dilate,
morphologyEx) against opencv_tpu and the cv2 oracle, on the CPU.

Every case is array_equal to opencv_tpu, on u8, u16, i16 and f32, one and
three channels, four elements, iterations 1 and 3, and four borders.  It is
array_equal to cv2 too, except where the reference itself departs from cv2
(tests/test_filters2.py holds it to cv2 on u8 only):

- a custom constant border on a multi-channel image: cv2 reads a scalar
  as (v, 0, 0, 0), the reference fills every channel with v;
- GRADIENT, TOPHAT and BLACKHAT: the reference wraps the difference in the
  input dtype, cv2 saturates it, so they are equal wherever cv2's value
  lies inside the dtype's limits;
- HITMISS: cv2 takes u8 C1 only and the bitwise and of the two erosions,
  the reference their min, one iteration; the two agree on binary images,
  where the port is held to cv2."""

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv

DEPTHS = {"uint8": np.uint8, "uint16": np.uint16, "int16": np.int16, "float32": np.float32}
ASYM = np.array([[1, 0, 0], [1, 1, 0], [0, 0, 0]], np.uint8)
ELEMENTS = {
    "rect": cv2.getStructuringElement(cv2.MORPH_RECT, (5, 3)),
    "cross": cv2.getStructuringElement(cv2.MORPH_CROSS, (5, 5)),
    "ellipse": cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (7, 5)),
    "asym": ASYM,
}
BORDERS = {
    "default": {},
    "custom": dict(borderValue=5),
    "replicate": dict(borderType=tcv.BORDER_REPLICATE),
    "reflect101": dict(borderType=tcv.BORDER_REFLECT_101),
}
OPS = [tcv.MORPH_ERODE, tcv.MORPH_DILATE, tcv.MORPH_OPEN, tcv.MORPH_CLOSE,
       tcv.MORPH_GRADIENT, tcv.MORPH_TOPHAT, tcv.MORPH_BLACKHAT]
DIFFERENCE_OPS = (tcv.MORPH_GRADIENT, tcv.MORPH_TOPHAT, tcv.MORPH_BLACKHAT)


def _batch(depth, cn, seed, shape=(2, 13, 17)):
    rng = np.random.default_rng(seed)
    dtype = DEPTHS[depth]
    if dtype == np.float32:
        return (rng.random((*shape, cn), dtype=np.float32) - 0.25) * 100
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max + 1, (*shape, cn)).astype(dtype)


def _port(x, op, kernel, **kw):
    t = torch.from_numpy(x)
    if op == tcv.MORPH_ERODE:
        return tcv.erode(t, kernel, **kw).numpy()
    if op == tcv.MORPH_DILATE:
        return tcv.dilate(t, kernel, **kw).numpy()
    return tcv.morphologyEx(t, op, kernel, **kw).numpy()


def _cv2_batch(x, op, kernel, **kw):
    cn = x.shape[-1]
    out = np.stack([cv2.morphologyEx(x[i] if cn > 1 else x[i, ..., 0], op, kernel, **kw)
                    for i in range(x.shape[0])])
    return out if cn > 1 else out[..., None]


@pytest.mark.parametrize("shape", [tcv.MORPH_RECT, tcv.MORPH_CROSS, tcv.MORPH_ELLIPSE])
@pytest.mark.parametrize("ksize", [(3, 3), (5, 5), (7, 3), (1, 5)])
def test_structuring_element(shape, ksize):
    got = tcv.getStructuringElement(shape, ksize)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, jcv.getStructuringElement(shape, ksize))
    np.testing.assert_array_equal(got, cv2.getStructuringElement(shape, ksize))


@pytest.mark.parametrize("element", list(ELEMENTS))
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("cn", [1, 3])
@pytest.mark.parametrize("depth", list(DEPTHS))
def test_morphology(depth, cn, op, element):
    x = _batch(depth, cn, seed=op * 10 + cn)
    kernel = ELEMENTS[element]
    for iterations in (1, 3):
        for border, bkw in BORDERS.items():
            kw = dict(iterations=iterations, **bkw)
            msg = f"iterations={iterations} border={border}"
            got = _port(x, op, kernel, **kw)
            want = np.asarray(jcv.morphologyEx(x, op, kernel, **kw))
            assert got.shape == x.shape and got.dtype == x.dtype, msg
            np.testing.assert_array_equal(got, want, err_msg=f"vs opencv_tpu {msg}")
            if border == "custom" and cn > 1:
                continue  # cv2 fills channel 0 only
            ref = _cv2_batch(x, op, kernel, **kw)
            if op in DIFFERENCE_OPS and depth != "float32":
                info = np.iinfo(x.dtype)
                inside = (ref != info.min) & (ref != info.max)
                np.testing.assert_array_equal(got[inside], ref[inside], err_msg=f"vs cv2 {msg}")
            else:
                np.testing.assert_array_equal(got, ref, err_msg=f"vs cv2 {msg}")


HITMISS_ELEMENTS = {
    "cross": np.array([[0, 1, 0], [1, -1, 1], [0, 1, 0]]),
    "corner": np.array([[-1, -1, 0], [-1, 1, 1], [0, 1, 0]]),
    "ellipse ring": ELEMENTS["ellipse"].astype(np.int64) - (ELEMENTS["ellipse"] == 0),
}


@pytest.mark.parametrize("element", list(HITMISS_ELEMENTS))
@pytest.mark.parametrize("cn", [1, 3])
@pytest.mark.parametrize("depth", list(DEPTHS))
def test_hitmiss_equals_opencv_tpu(depth, cn, element):
    x = _batch(depth, cn, seed=cn)
    kernel = HITMISS_ELEMENTS[element]
    for border, bkw in BORDERS.items():
        got = _port(x, tcv.MORPH_HITMISS, kernel, **bkw)
        want = np.asarray(jcv.morphologyEx(x, jcv.MORPH_HITMISS, kernel, **bkw))
        assert got.dtype == x.dtype
        np.testing.assert_array_equal(got, want, err_msg=border)


@pytest.mark.parametrize("element", [*HITMISS_ELEMENTS, "ones", "minus ones"])
def test_hitmiss_binary_u8_equals_cv2(element):
    x = (np.random.default_rng(3).random((2, 24, 28, 1)) > 0.4).astype(np.uint8) * 255
    kernel = {"ones": np.ones((3, 3), np.int64),
              "minus ones": -np.ones((3, 3), np.int64)}.get(element)
    if kernel is None:
        kernel = HITMISS_ELEMENTS[element]
    for border, bkw in BORDERS.items():
        got = _port(x, tcv.MORPH_HITMISS, kernel, **bkw)
        ref = _cv2_batch(x, cv2.MORPH_HITMISS, kernel.astype(np.int32), **bkw)
        np.testing.assert_array_equal(got, ref, err_msg=border)
    # an element of one sign only: the reference fails, the port drops the
    # empty part as cv2 does
    if element in ("ones", "minus ones"):
        with pytest.raises(TypeError):
            jcv.morphologyEx(x, jcv.MORPH_HITMISS, kernel)


def test_morph_per_image_shapes_and_defaults():
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (20, 24), np.uint8)
    rgb = rng.integers(0, 256, (20, 24, 3), np.uint8)
    for src in (img, rgb):
        for fn, jfn, cfn in ((tcv.erode, jcv.erode, cv2.erode), (tcv.dilate, jcv.dilate, cv2.dilate)):
            got = fn(torch.from_numpy(src), None, iterations=2).numpy()  # no element: 3x3
            assert got.shape == src.shape
            np.testing.assert_array_equal(got, np.asarray(jfn(src, None, iterations=2)))
            np.testing.assert_array_equal(got, cfn(src, None, iterations=2))
            got = fn(torch.from_numpy(src), ASYM, anchor=(0, 1),
                     borderValue=tcv.morphologyDefaultBorderValue()).numpy()
            np.testing.assert_array_equal(got, cfn(src, ASYM, anchor=(0, 1)))
    assert tcv.morphologyDefaultBorderValue() == jcv.morphologyDefaultBorderValue()
    with pytest.raises(ValueError, match="unknown morphology op"):
        tcv.morphologyEx(torch.from_numpy(img), 99, ASYM)
    with pytest.raises(ValueError, match="structuring element shape"):
        tcv.getStructuringElement(7, (3, 3))
