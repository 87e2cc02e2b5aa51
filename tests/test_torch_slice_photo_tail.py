"""The photo-finishing path's later stages on the CPU (denoise, detail,
flatten, inpaint), each against the same opencv_tpu call on the port's own
input to it, on tests/test_torch_slice_photo.py's (3, 180, 320, 3) bracket.

NL-means: within DENOISE_ATOL on DENOISE_SHARE of the values (measured 2
levels on 10 of 169,812: the JAX package's float32 prefix sums are inexact
at this size, the port's exact); detailEnhance against the jitted program
and textureFlattening (the FFTs round apart before the truncating cast)
within 1 on U8_SHARE (measured 1 and 123 values); inpaint exactly."""

import numpy as np
import pytest
import torch

import opencv_tpu as jcv
from opencv_tpu_torch import entry as E
from torch_threads import _one_torch_thread  # noqa: F401

SHAPE = (3, 180, 320, 3)
DENOISE_ATOL = 3
DENOISE_SHARE = 0.999
U8_SHARE = 0.998


@pytest.fixture(scope="module")
def port():
    x, _, _, face, wire = E.make_bracket(SHAPE)
    return E.forward_photo(*(torch.from_numpy(a) for a in (x, face, wire)))


def _close(got, want, atol, share):
    d = np.abs(got.numpy().astype(int) - np.asarray(want).astype(int))
    assert d.max() <= atol and (d == 0).mean() >= share, (d.max(), (d != 0).sum())


def test_denoise_equals_opencv_tpu(port):
    want = jcv.fastNlMeansDenoisingColored(port["fused"].numpy(), *E.PHOTO_NLM)
    _close(port["denoised"], want, DENOISE_ATOL, DENOISE_SHARE)


def test_detail_equals_opencv_tpu(port):
    want = jcv.detailEnhance(port["denoised"].numpy(), **E.PHOTO_DETAIL)
    _close(port["detailed"], want, 1, U8_SHARE)


def test_flatten_equals_opencv_tpu(port):
    want = jcv.textureFlattening(port["detailed"].numpy(), port["face"].numpy(),
                                 *E.PHOTO_FLATTEN)
    _close(port["flattened"], want, 1, U8_SHARE)


def test_inpaint_equals_opencv_tpu(port):
    want = jcv.inpaint(port["flattened"].numpy(), port["wire"].numpy(), E.PHOTO_INPAINT_RADIUS,
                       jcv.INPAINT_TELEA)
    np.testing.assert_array_equal(port["inpainted"].numpy(), want)
