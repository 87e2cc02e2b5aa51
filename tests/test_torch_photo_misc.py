"""The port's inpaint and decolor on the CPU, against opencv_tpu (exactly:
inpaint's diffusion runs the same float32 ops in the same order, and
decolor is the same numpy solver over the port's resize and cvtColor, which
are exact here) and cv2 (tests/test_photo.py's bounds)."""

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from torch_threads import _one_torch_thread  # noqa: F401


def _image(seed, shape):
    rng = np.random.default_rng(seed)
    return cv2.GaussianBlur(rng.integers(0, 256, shape, np.uint8), (7, 7), 2)


def _mask(shape, kind):
    m = np.zeros(shape, np.uint8)
    if kind == "square":
        m[20:28, 20:28] = 255
    elif kind == "wire":
        cv2.line(m, (2, 5), (shape[1] - 3, shape[0] - 9), 255, 2)
    else:
        m[::7, ::5] = 1
    return m


@pytest.mark.parametrize("kind", ["square", "wire", "dots"])
@pytest.mark.parametrize("channels", [1, 3])
def test_inpaint_equals_opencv_tpu(kind, channels):
    shape = (48, 64) if channels == 1 else (48, 64, 3)
    img = _image(channels, shape)
    mask = _mask((48, 64), kind)
    for radius in (3, 7):
        got = tcv.inpaint(torch.from_numpy(img), torch.from_numpy(mask), radius,
                          tcv.INPAINT_TELEA)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), jcv.inpaint(img, mask, radius,
                                                               jcv.INPAINT_TELEA))
    f = img.astype(np.float32) / 3
    np.testing.assert_array_equal(tcv.inpaint(f, mask, 3, tcv.INPAINT_NS).numpy(),
                                  jcv.inpaint(f, mask, 3, jcv.INPAINT_NS))


def test_inpaint_fills_like_cv2():
    """tests/test_photo.py's bound: the filled hole is within 0.35 of the
    hole's own error."""
    rng = np.random.default_rng(3)
    img = cv2.GaussianBlur(rng.integers(0, 256, (48, 48), np.uint8), (7, 7), 2)
    mask = np.zeros((48, 48), np.uint8)
    mask[20:28, 20:28] = 255
    damaged = img.copy()
    damaged[mask > 0] = 0
    ours = tcv.inpaint(damaged, mask, 3, tcv.INPAINT_TELEA).numpy()
    err_ours = np.abs(ours[mask > 0].astype(int) - img[mask > 0]).mean()
    err_hole = np.abs(0 - img[mask > 0].astype(int)).mean()
    assert err_ours < err_hole * 0.35


def _decolor_input(shape=(90, 120, 3)):
    """tests/test_photo.py's decolor image."""
    rng = np.random.default_rng(0)
    img = np.zeros(shape, np.uint8)
    cv2.circle(img, (30, 40), 20, (40, 160, 220), -1)
    cv2.rectangle(img, (60, 20), (110, 70), (200, 80, 40), -1)
    return cv2.GaussianBlur(img + rng.integers(0, 40, img.shape, dtype=np.uint8), (5, 5), 1.5)


def test_decolor_equals_opencv_tpu():
    img = _decolor_input()
    gray, boost = tcv.decolor(torch.from_numpy(img))
    jgray, jboost = jcv.decolor(img)
    np.testing.assert_array_equal(gray.numpy(), jgray)
    np.testing.assert_array_equal(boost.numpy(), np.asarray(jboost))


def test_decolor_of_a_large_image_resizes_like_opencv_tpu():
    """h + w > 800: the solver runs on the resize to 800 / (h + w)."""
    img = cv2.resize(_decolor_input(), (560, 300), interpolation=cv2.INTER_LINEAR)
    gray, boost = tcv.decolor(img)
    jgray, jboost = jcv.decolor(img)
    np.testing.assert_array_equal(gray.numpy(), jgray)
    np.testing.assert_array_equal(boost.numpy(), np.asarray(jboost))


def test_decolor_matches_cv2():
    """tests/test_photo.py's bounds."""
    img = _decolor_input()
    g_ref, b_ref = cv2.decolor(img)
    g_our, b_our = tcv.decolor(img)
    assert np.abs(g_ref.astype(int) - g_our.numpy().astype(int)).max() <= 4
    assert np.abs(b_ref.astype(int) - b_our.numpy().astype(int)).mean() < 3
