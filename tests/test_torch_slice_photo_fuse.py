"""The photo-finishing path's fusion on the CPU against opencv_tpu's
MergeMertens on the port's own aligned frames, on
tests/test_torch_slice_photo.py's (3, 180, 320, 3) bracket.

The fusion equals the JAX package's once the JAX package's Laplacian is the
port's (the float32 sums of its XLA convolution round apart; with its own,
up to FUSE_ATOL levels on FUSE_SHARE of the pixels: measured 4 levels on
933 of 169,812 values)."""

import numpy as np
import pytest
import torch

import opencv_tpu as jcv
import opencv_tpu.ops.deriv as JD
import opencv_tpu_torch as tcv
from opencv_tpu_torch import entry as E
from torch_threads import _one_torch_thread  # noqa: F401

SHAPE = (3, 180, 320, 3)
FUSE_ATOL = 5
FUSE_SHARE = 0.99


@pytest.fixture(scope="module")
def port():
    x, _, _, face, wire = E.make_bracket(SHAPE)
    st = E.photo_state(*(torch.from_numpy(a) for a in (x, face, wire)))
    for _, stage, _ in E.PHOTO_STAGES[:2]:
        stage(st)
    return st


def test_fuse_equals_opencv_tpu_over_the_same_laplacian(port, monkeypatch):
    aligned = list(port["aligned"].numpy())

    def u8(m):
        return np.clip(np.rint(m * np.float32(255)), 0, 255).astype(np.uint8)

    want = u8(jcv.createMergeMertens().process(aligned))
    d = np.abs(want.astype(int) - port["fused"].numpy())
    assert d.max() <= FUSE_ATOL and (d == 0).mean() >= FUSE_SHARE, (d.max(), (d != 0).sum())
    monkeypatch.setattr(JD, "Laplacian",
                        lambda g, dd: tcv.Laplacian(torch.from_numpy(g), dd).numpy())
    np.testing.assert_array_equal(port["fused"].numpy(),
                                  u8(jcv.createMergeMertens().process(aligned)))
