"""The port's MergeMertens and AlignMTB on the CPU, against opencv_tpu and
cv2, on one (48, 64, 3) bracket for the JAX calls (Debevec, Robertson and
the tonemappers are in tests/test_torch_photo_tonemap.py).

Mertens runs over the port's float32 Laplacian, whose sums round apart from
the JAX package's XLA convolution by an ulp of the image on most pixels; a
pixel whose contrast and saturation are near 0 takes its weight from those
ulps, so the fused images differ by up to MERTENS_ATOL (measured 0.046 on
this bracket, whose exposures saturate).  With the JAX package's Laplacian
given the port's, the fusions are equal, which holds every other step to it
exactly.  AlignMTB is the JAX package's numpy code over the port's
cvtColor: equal."""

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu.ops.deriv as JD
import opencv_tpu_torch as tcv
from opencv_tpu_torch import entry as E
from torch_threads import _one_torch_thread  # noqa: F401

MERTENS_ATOL = 0.05
TIMES = (0.25, 1.0, 4.0)


@pytest.fixture(scope="module")
def bracket():
    rng = np.random.default_rng(0)
    base = cv2.GaussianBlur(rng.integers(0, 256, (48, 64, 3), np.uint8), (5, 5), 1.5)
    return [np.clip(base.astype(float) * t * 0.6 + 4, 0, 255).astype(np.uint8) for t in TIMES]


def test_merge_mertens_within_bound_of_opencv_tpu(bracket):
    got = tcv.createMergeMertens().process([torch.from_numpy(b) for b in bracket])
    assert got.dtype == torch.float32 and tuple(got.shape) == bracket[0].shape
    want = jcv.createMergeMertens().process(bracket)
    assert np.abs(got.numpy() - want).max() <= MERTENS_ATOL


def test_merge_mertens_equals_opencv_tpu_over_the_same_laplacian(bracket, monkeypatch):
    monkeypatch.setattr(JD, "Laplacian",
                        lambda g, d: tcv.Laplacian(torch.from_numpy(g), d).numpy())
    t = [torch.from_numpy(b) for b in bracket]
    got = tcv.createMergeMertens().process(t)
    np.testing.assert_array_equal(got.numpy(), jcv.createMergeMertens().process(bracket))
    # other weight exponents: numpy's float32 power and exp, an ulp off the
    # rounded float64 ones the port takes on some pixels
    got = tcv.createMergeMertens(0.5, 2.0, 1.0).process(t)
    want = jcv.createMergeMertens(0.5, 2.0, 1.0).process(bracket)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_merge_mertens_matches_cv2():
    """tests/test_photo.py's bound: correlation with cv2 above 0.98."""
    rng = np.random.default_rng(1)
    base = rng.integers(30, 220, (64, 64, 3), np.uint8)
    exposures = [np.clip(base.astype(int) * s, 0, 255).astype(np.uint8) for s in (0.4, 1.0, 2.0)]
    ref = cv2.createMergeMertens().process(exposures)
    ours = tcv.createMergeMertens().process(exposures).numpy()
    assert np.corrcoef(ref.ravel(), ours.ravel())[0, 1] > 0.98


@pytest.fixture(scope="module")
def aligned_bracket():
    """make_bracket at (3, 180, 320, 3), the smallest size at which
    AlignMTB's six levels find its shifts."""
    return E.make_bracket((3, 180, 320, 3), seed=1)


def test_align_mtb_equals_opencv_tpu_and_cv2(aligned_bracket):
    frames, _, planted = aligned_bracket[:3]
    mtb, jmtb, cmtb = tcv.createAlignMTB(), jcv.createAlignMTB(), cv2.createAlignMTB()
    got = mtb.process([torch.from_numpy(f) for f in frames])
    want = jmtb.process(list(frames))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    gray = [cv2.cvtColor(f, cv2.COLOR_RGB2GRAY) for f in frames]
    for i in (0, 2):
        sh = mtb.calculateShift(gray[1], torch.from_numpy(gray[i]))
        assert sh == jmtb.calculateShift(gray[1], gray[i]) == tuple(-planted[i])
        assert sh == tuple(cmtb.calculateShift(gray[1], gray[i]))
    for g in gray:
        tb, eb = mtb.computeBitmaps(torch.from_numpy(g))
        jtb, jeb = jmtb.computeBitmaps(g)
        np.testing.assert_array_equal(tb.numpy(), jtb)
        np.testing.assert_array_equal(eb.numpy(), jeb)
    shifted = mtb.shiftMat(torch.from_numpy(frames[0]), (3, -2))
    np.testing.assert_array_equal(shifted.numpy(), jmtb.shiftMat(frames[0], (3, -2)))
    assert (mtb.getMaxBits(), mtb.getExcludeRange(), mtb.getCut()) == (6, 4, True)
    mtb.setMaxBits(5), mtb.setExcludeRange(2), mtb.setCut(False)
    assert (mtb.getMaxBits(), mtb.getExcludeRange(), mtb.getCut()) == (5, 2, False)


def test_align_mtb_survives_a_saturated_frame():
    """A frame more than half white has median 256: no pixel lies above it,
    and the exclusion bitmap keeps those more than 4 below it (the JAX
    package's u8 > 256 comparison crashes numpy 2.0 there)."""
    img = np.full((40, 60), 255, np.uint8)
    img[:10] = 100
    tb, eb = tcv.createAlignMTB().computeBitmaps(img)
    assert not tb.any()
    np.testing.assert_array_equal(eb.numpy() > 0, img < 252)
