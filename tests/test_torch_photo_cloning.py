"""The port's Poisson cloning (seamlessClone with its three flags,
colorChange, illuminationChange, textureFlattening) on the CPU, against
opencv_tpu and cv2.

The solve's sine transforms are torch.fft on the CPU where the JAX package
takes XLA's FFT; they round apart, and the solve's truncating cast to u8
turns a solution within an ulp of an integer into a difference of 1.  So
the port is held within ±1 of the JAX package on all pixels and equal on
EQUAL_SHARE of them (measured: all but 0 to 2 pixels of 9,216 at 48×64, and
of 33,600 at 120×140).  cv2's bounds are tests/test_photo.py's."""

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from torch_threads import _one_torch_thread  # noqa: F401

EQUAL_SHARE = 0.999


def _scene(seed, shape):
    rng = np.random.default_rng(seed)
    return cv2.GaussianBlur(rng.integers(0, 256, shape, np.uint8), (5, 5), 2)


@pytest.fixture(scope="module")
def images():
    """tests/test_photo.py's seamless-clone inputs: a (120, 140, 3)
    destination, an (80, 90, 3) source and a disc mask."""
    rng = np.random.default_rng(0)
    dst = cv2.GaussianBlur(rng.integers(40, 220, (120, 140, 3), np.uint8), (7, 7), 3)
    src = cv2.GaussianBlur(rng.integers(0, 256, (80, 90, 3), np.uint8), (5, 5), 2)
    mask = np.zeros((80, 90), np.uint8)
    cv2.circle(mask, (45, 40), 25, 255, -1)
    return src, dst, mask


def _close(got, want):
    got, want = np.asarray(got).astype(int), np.asarray(want).astype(int)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.max() <= 1 and (d == 0).mean() >= EQUAL_SHARE, (d.max(), (d != 0).sum())


@pytest.mark.parametrize("flags", [tcv.NORMAL_CLONE, tcv.MIXED_CLONE, tcv.MONOCHROME_TRANSFER])
def test_seamless_clone_equals_opencv_tpu(images, flags):
    src, dst, mask = images
    got = tcv.seamlessClone(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(mask),
                            (70, 60), flags)
    assert got.dtype == torch.uint8
    _close(got.numpy(), jcv.seamlessClone(src, dst, mask, (70, 60), flags))


def test_seamless_clone_matches_cv2(images):
    """tests/test_photo.py's bounds: statistically the same membrane, and
    cloning an image onto itself a no-op within 1."""
    src, dst, mask = images
    for fl in (cv2.NORMAL_CLONE, cv2.MIXED_CLONE, cv2.MONOCHROME_TRANSFER):
        ref = cv2.seamlessClone(src, dst, mask, (70, 60), fl)
        d = np.abs(ref.astype(int) - tcv.seamlessClone(src, dst, mask, (70, 60), fl).numpy())
        assert d.mean() < 2.0 and np.median(d) <= 1, (fl, d.mean())
    img = dst[:80, :90]
    ours = tcv.seamlessClone(img, img.copy(), mask, (45, 40), 1).numpy()
    assert np.abs(ours.astype(int) - img.astype(int)).max() <= 1


@pytest.fixture(scope="module")
def local():
    img = _scene(1, (48, 64, 3))
    mask = np.zeros((48, 64), np.uint8)
    mask[10:38, 14:50] = 255
    return img, mask


def test_color_change_equals_opencv_tpu(local):
    img, mask = local
    for muls in ((1.5, 0.5, 0.5), (0.8, 1.2, 2.0)):
        _close(tcv.colorChange(torch.from_numpy(img), torch.from_numpy(mask), *muls).numpy(),
               jcv.colorChange(img, mask, *muls))


def test_illumination_change_equals_opencv_tpu(local):
    img, mask = local
    for a, b in ((0.2, 0.4), (0.5, 0.1)):
        _close(tcv.illuminationChange(torch.from_numpy(img), torch.from_numpy(mask), a,
                                      b).numpy(),
               jcv.illuminationChange(img, mask, a, b))


def test_texture_flattening_equals_opencv_tpu(local):
    img, mask = local
    for lo, hi in ((30, 45), (10, 80)):
        got = tcv.textureFlattening(torch.from_numpy(img), torch.from_numpy(mask), lo, hi, 3)
        _close(got.numpy(), jcv.textureFlattening(img, mask, lo, hi, 3))

