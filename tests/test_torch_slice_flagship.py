"""The port's the flagship entry forward (cvtColor to gray, GaussianBlur 5×5, a
half-size resize, warpAffine) and its fused twin, and the public surface of
the first slices end to end on the CPU, against the same chain through
opencv_tpu at a small batch (moved from tests/test_torch_slice.py, one file
per path)."""

import numpy as np
import pytest
import torch

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu_torch import entry as E
from opencv_tpu_torch.core.dispatch import reset_tier_stats, tier_stats

SHAPE = (2, 96, 128, 3)


def _jax_chain(imgs):
    """__graft_entry__.entry()'s forward at a half-size resize and centre."""
    H, W = imgs.shape[1], imgs.shape[2]
    g = jcv.cvtColor(imgs, jcv.COLOR_BGR2GRAY)
    b = jcv.GaussianBlur(g, (5, 5), 0)
    r = jcv.resize(b, (W // 2, H // 2))
    M = jcv.getRotationMatrix2D((W / 4, H / 4), 15.0, 0.9)
    return np.asarray(r), np.asarray(jcv.warpAffine(r, M, (W // 2, H // 2)))


@pytest.fixture(scope="module")
def batch():
    return E.make_batch(SHAPE)


def test_entry_batch_and_shapes():
    forward, (imgs,) = E.entry("cpu", SHAPE)
    assert forward is E.forward
    assert imgs.dtype == torch.uint8 and tuple(imgs.shape) == SHAPE
    np.testing.assert_array_equal(
        imgs.numpy(), np.random.default_rng(0).integers(0, 256, size=SHAPE, dtype=np.uint8))
    assert E.SHAPE == (8, 1080, 1920, 3)


def test_slice_matches_opencv_tpu(batch):
    want_pre, want = _jax_chain(batch)
    imgs = torch.from_numpy(batch)
    reset_tier_stats()
    pre = E.preprocess(imgs)
    assert tier_stats() == {"tier.sep_filter_u8.plain": 1}
    np.testing.assert_array_equal(pre.numpy(), want_pre)
    out = E.forward(imgs).numpy()
    assert out.shape == (2, 48, 64, 1)
    d = np.abs(out.astype(int) - want.astype(int))
    assert d.max() <= 1 and np.count_nonzero(d) <= d.size // 1000


def test_fused_forward_equals_composed(batch):
    imgs = torch.from_numpy(batch)
    assert torch.equal(E.preprocess_fused(imgs), E.preprocess(imgs))
    assert torch.equal(E.forward_fused(imgs), E.forward(imgs))


def test_public_surface():
    for name in ("cvtColor", "GaussianBlur", "getGaussianKernel", "resize", "warpAffine",
                 "getRotationMatrix2D", "invertAffineTransform",
                 "fusedPreprocessGrayBlurDown2", "COLOR_BGR2GRAY", "BORDER_DEFAULT",
                 "pyrDown", "pyrUp", "buildPyramid", "sepFilter2D", "filter2D", "boxFilter",
                 "blur", "sqrBoxFilter", "Sobel", "Scharr", "Laplacian", "spatialGradient",
                 "getDerivKernels", "cornerHarris", "cornerMinEigenVal",
                 "cornerEigenValsAndVecs", "preCornerDetect", "Canny", "erode", "dilate",
                 "morphologyEx", "getStructuringElement", "morphologyDefaultBorderValue",
                 "matchTemplate", "goodFeaturesToTrack", "goodFeaturesToTrackWithQuality",
                 "KeyPoint", "KeyPoint_convert", "KeyPoint_overlap", "GFTTDetector",
                 "GFTTDetector_create", "TM_CCOEFF_NORMED", "MORPH_ELLIPSE", "ORB", "ORB_create",
                 "BFMatcher", "DMatch", "FastFeatureDetector", "FastFeatureDetector_create",
                 "FastFeatureDetector_detect", "ORB_HARRIS_SCORE", "NORM_HAMMING",
                 "INTER_LINEAR_EXACT"):
        assert hasattr(tcv, name), name
        assert getattr(tcv, name).__class__ is getattr(jcv, name).__class__, name
