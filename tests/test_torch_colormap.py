"""opencv_tpu_torch applyColorMap vs opencv_tpu and the cv2 oracle, on the
CPU: every one of the 22 ids on gray and BGR input and user tables, bit
for bit; and the port's copy of ``colormap_luts.npz`` equals the JAX
package's file, array by array."""

import os

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_colormap_tables_are_a_copy():
    with np.load(os.path.join(ROOT, "opencv_tpu", "ops", "colormap_luts.npz")) as want, \
            np.load(os.path.join(ROOT, "opencv_tpu_torch", "ops", "colormap_luts.npz")) as got:
        assert sorted(got.files) == sorted(want.files)
        assert len(got.files) == 22
        for k in want.files:
            assert got[k].dtype == want[k].dtype and got[k].shape == (256, 3)
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# the ids tests/test_tail_apis.py holds opencv_tpu to cv2 on
CV2_IDS = {0, 2, 9, 11, 12, 16, 20, 21}


@pytest.mark.parametrize("cmap", range(22))
def test_apply_colormap_equals_opencv_tpu(cmap):
    rng = np.random.default_rng(3)
    g = rng.integers(0, 256, (40, 50), np.uint8)
    c = rng.integers(0, 256, (20, 30, 3), np.uint8)
    for x in (g, c):
        got = tcv.applyColorMap(torch.from_numpy(x), cmap).numpy()
        np.testing.assert_array_equal(got, np.asarray(jcv.applyColorMap(x, cmap)))
        if cmap in CV2_IDS:
            np.testing.assert_array_equal(got, cv2.applyColorMap(x, cmap))


def test_apply_colormap_batch_and_user_tables():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, (2, 15, 17, 1), np.uint8)
    got = tcv.applyColorMap(torch.from_numpy(x), tcv.COLORMAP_JET).numpy()
    assert got.shape == (2, 15, 17, 3)
    np.testing.assert_array_equal(got, np.asarray(jcv.applyColorMap(x, jcv.COLORMAP_JET)))
    g = x[0, ..., 0]
    lut = rng.integers(0, 256, (256, 1, 3), np.uint8)
    got = tcv.applyColorMap(torch.from_numpy(g), lut).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcv.applyColorMap(g, lut)))
    np.testing.assert_array_equal(got, cv2.applyColorMap(g, lut))
    # a one-channel table: opencv_tpu (and the port) repeat it into three
    # equal channels, where cv2 returns the one channel
    lut1 = rng.integers(0, 256, (256, 1), np.uint8)
    got = tcv.applyColorMap(torch.from_numpy(g), lut1).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcv.applyColorMap(g, lut1)))
    for ch in range(3):
        np.testing.assert_array_equal(got[..., ch], cv2.applyColorMap(g, lut1))
    with pytest.raises(ValueError):
        tcv.applyColorMap(torch.from_numpy(g), 99)
