"""The port's photo-finishing path (``entry.forward_photo``) on the CPU, on a
(3, 180, 320, 3) bracket from ``entry.make_bracket``: the alignment and the
fusion against the same opencv_tpu calls on the port's own inputs, and the
truth.  (The fusion against opencv_tpu is in
tests/test_torch_slice_photo_fuse.py and the later stages in
tests/test_torch_slice_photo_tail.py, so ``--dist loadfile`` spreads them.)

180×320 is the smallest size at which AlignMTB's six levels (its default
max_bits) find the planted shifts: at 64×80 its coarsest bitmaps are 2×3 px,
where a shift that uncovers fewer pixels always scores lower.

AlignMTB's frames and shifts are exact.

The truth (``entry.photo_truth_report``) at this size: the shifts undo the
planted ones exactly; NL-means gains DENOISE_GAIN dB of PSNR against the
noise-free twin's fusion (measured 0.224 dB: the noisy fusion's weights,
not only its noise, part it from the twin's); the face keeps FLAT_RATIO of
its mean |Sobel| (measured 0.607), and OUTSIDE_SHARE of the pixels 5 px
clear of it move by at most 1 (measured 0.762: the Poisson solve spans the
frame, as cv2's does); the wire reads INPAINT_RATIO of its ring (measured
0.956)."""

import numpy as np
import pytest
import torch

import opencv_tpu as jcv
from opencv_tpu_torch import entry as E
from torch_threads import _one_torch_thread  # noqa: F401

SHAPE = (3, 180, 320, 3)
DENOISE_GAIN = 0.2
FLAT_RATIO = 0.62
OUTSIDE_SHARE = 0.75
INPAINT_RATIO = 0.8


@pytest.fixture(scope="module")
def bracket():
    return E.make_bracket(SHAPE)


@pytest.fixture(scope="module")
def port(bracket):
    x, _, _, face, wire = bracket
    return E.forward_photo(*(torch.from_numpy(a) for a in (x, face, wire)))


def test_bracket(bracket):
    x, twin, planted, face, wire = bracket
    assert x.shape == twin.shape == SHAPE and x.dtype == twin.dtype == np.uint8
    assert planted.tolist() == [[1, -1], [0, 0], [-1, 1]]
    assert face.shape == wire.shape == SHAPE[1:3]
    assert 0.02 < (face > 0).mean() < 0.1 and 0 < (wire > 0).mean() < 0.02
    assert not ((face > 0) & (wire > 0)).any()
    # the noise: sigma 3 about the twin, where neither clips
    d = x.astype(float) - twin
    keep = (twin > 10) & (twin < 245)
    assert 2.7 < d[keep].std() < 3.3
    # no exposure is over half white (AlignMTB's median stays below 255)
    for f in x:
        assert np.median(f.mean(-1)) < 250


def test_path_outputs(port):
    h, w = SHAPE[1] - 2, SHAPE[2] - 2
    assert tuple(port["aligned"].shape) == (3, h, w, 3)
    for k in ("fused", "denoised", "detailed", "flattened", "inpainted"):
        assert tuple(port[k].shape) == (h, w, 3) and port[k].dtype == torch.uint8, k
    assert tuple(port["face"].shape) == tuple(port["wire"].shape) == (h, w)


def test_align_equals_opencv_tpu(bracket, port):
    want = jcv.createAlignMTB().process(list(bracket[0]))
    for got, w in zip(port["aligned"], want):
        np.testing.assert_array_equal(got.numpy(), w)
    np.testing.assert_array_equal(port["shifts"], -bracket[2])


def test_truth(bracket, port):
    rep = E.photo_truth_report(port, bracket)
    got, want, same = rep["align"]
    assert same, (got, want)
    p_den, p_fus, gain = rep["denoise"]
    assert gain >= DENOISE_GAIN, rep["denoise"]
    ratio, outside = rep["flatten"]
    assert ratio <= FLAT_RATIO and outside >= OUTSIDE_SHARE, rep["flatten"]
    after, before = rep["inpaint"]
    assert after >= INPAINT_RATIO and before < 0.6, rep["inpaint"]
