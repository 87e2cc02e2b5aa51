"""The blenders of the port (``opencv_tpu_torch/blenders.py``) against the
JAX package's ``opencv_tpu/blenders.py``, on the CPU: blend_multiband
exact (the same f32 pyrDown/pyrUp arithmetic, one rounding at the end) on
u8 colour and gray images, sizes that need the edge padding and sizes that
do not, soft and hard masks and band counts 1 to 5; MultiBandBlender and
FeatherBlender exact, image and mask, with offsets on the canvas; and the
reference test's properties (pure regions keep their colour, a monotone
seam)."""

import numpy as np
import pytest
import torch

from torch_threads import _one_torch_thread  # noqa: F401

import opencv_tpu as jcv
from opencv_tpu import blenders as jbl
import opencv_tpu_torch as tcv
from opencv_tpu_torch import blenders as tbl


def _images(shape, seed, soft):
    rng = np.random.default_rng(seed)
    a, b = (rng.integers(0, 256, shape, np.uint8) for _ in range(2))
    H, W = shape[:2]
    wa = rng.random((H, W)).astype(np.float32) if soft \
        else (np.arange(W)[None, :] < W // 2 + rng.integers(-3, 4, (H, 1))).astype(np.float32)
    return a, b, wa, (1 - wa).astype(np.float32)


@pytest.mark.parametrize("shape,bands,soft", [
    ((100, 140, 3), 4, False), ((64, 64), 5, True), ((37, 91, 3), 4, True),
    ((128, 96, 3), 1, False), ((33, 17), 3, False)])
def test_blend_multiband_equals_opencv_tpu(shape, bands, soft):
    a, b, wa, wb = _images(shape, shape[0], soft)
    got = tbl.blend_multiband([a, b], [wa, wb], bands)
    assert got.dtype == torch.uint8 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), jbl.blend_multiband([a, b], [wa, wb], bands))
    # tensors in, the images' device out
    t = tbl.blend_multiband([torch.from_numpy(a), torch.from_numpy(b)],
                            [torch.from_numpy(wa), torch.from_numpy(wb)], bands)
    assert torch.equal(t, got)


@pytest.mark.parametrize("cls", ["MultiBandBlender", "FeatherBlender"])
def test_blender_classes_equal_opencv_tpu(cls):
    rng = np.random.default_rng(1)
    H, W = 90, 120
    a, b = (rng.integers(0, 256, (H, W, 3), np.uint8) for _ in range(2))
    ma = np.full((H, W), 255, np.uint8)
    mb = (rng.random((H, W)) > 0.2).astype(np.uint8) * 255
    outs = []
    for mod, kw in ((jcv, {}), (tcv, {})):
        bl = getattr(mod, cls)(**kw)
        bl.prepare((0, 0, W + 30, H + 12))
        bl.feed(a, ma, (0, 0))
        bl.feed(b, mb, (30, 12))
        outs.append(bl.blend())
    (jo, jm), (to, tm) = outs
    np.testing.assert_array_equal(to.numpy(), jo)
    np.testing.assert_array_equal(tm.numpy(), jm)
    assert getattr(tcv, f"detail_{cls}") is getattr(tcv, cls)


def test_reference_properties():
    """tests/test_misc_modules.py::test_multiband_blender's checks."""
    H, W = 100, 140
    a = np.zeros((H, W, 3), np.uint8)
    b = np.zeros((H, W, 3), np.uint8)
    a[:] = (180, 60, 40)
    b[:] = (40, 80, 200)
    wa = np.zeros((H, W), np.float32)
    wb = np.zeros((H, W), np.float32)
    wa[:, :80] = 1.0
    wb[:, 60:] = 1.0
    out = tbl.blend_multiband([a, b], [wa, wb], num_bands=4).numpy()
    assert np.abs(out[50, 10].astype(int) - a[50, 10].astype(int)).max() <= 2
    assert np.abs(out[50, 130].astype(int) - b[50, 130].astype(int)).max() <= 2
    assert (np.diff(out[50, 60:80, 2].astype(int)) >= -12).all()
    assert tcv.detail_Blender is tcv.FeatherBlender
