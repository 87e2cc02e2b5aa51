"""opencv_tpu_torch's corner responses and Canny against opencv_tpu and the
cv2 oracle, on the CPU (plain tier).

Tolerances: the corner family is float32 arithmetic in another order than
XLA's, so it is held to opencv_tpu at rtol 1e-5 plus atol 1e-6·max|ref|,
and to cv2 at tests/test_analysis.py's bounds.  Canny is integer throughout
and equals opencv_tpu exactly; against cv2 it carries the reference's bound
(at most 0.2% of pixels differ), where the reference's tests check cv2:
single-channel images, apertures 3 and 5."""

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
from opencv_tpu.ops.canny import _TG22 as J_TG22

import opencv_tpu_torch as tcv
from opencv_tpu_torch.ops import canny as tcanny


def _smooth(seed, shape, ksize=(5, 5), sigma=1.5):
    """Noise smoothed by cv2.GaussianBlur, tests/test_analysis.py's input."""
    img = np.random.default_rng(seed).integers(0, 256, shape, np.uint8)
    return cv2.GaussianBlur(img, ksize, sigma)


def _assert_close_to_ref(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * np.abs(want).max())


# ------------------------------------------------------------ corners

@pytest.mark.parametrize("ksize", [3, 5, -1])
@pytest.mark.parametrize("block", [2, 3])
def test_corner_harris_and_min_eigen(block, ksize):
    img = _smooth(block, (48, 52))
    t = torch.from_numpy(img)
    harris = tcv.cornerHarris(t, block, ksize, 0.04).numpy()
    _assert_close_to_ref(harris, jcv.cornerHarris(img, block, ksize, 0.04))
    min_eig = tcv.cornerMinEigenVal(t, block, ksize).numpy()
    _assert_close_to_ref(min_eig, jcv.cornerMinEigenVal(img, block, ksize))
    # cv2 holds the reference only at ksize 3 (tests/test_analysis.py); with
    # Scharr (-1) and cornerMinEigenVal at 5 the reference's scale differs
    # from cv2's, and the port inherits it (ROADMAP C)
    if ksize == 3:
        np.testing.assert_allclose(harris, cv2.cornerHarris(img, block, ksize, 0.04),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(min_eig, cv2.cornerMinEigenVal(img, block, ksize),
                                   rtol=0, atol=1e-6)


def test_corner_harris_float_batch_config3_input():
    """cornerHarris(x/255, 2, 3, 0.04) over an NHWC batch, as BASELINE
    config 3 calls it."""
    x = np.random.default_rng(0).integers(0, 256, (2, 40, 56, 1), np.uint8)
    xf = x.astype(np.float32) / np.float32(255)
    got = tcv.cornerHarris(torch.from_numpy(x).to(torch.float32) / 255.0, 2, 3, 0.04).numpy()
    _assert_close_to_ref(got, jcv.cornerHarris(xf, 2, 3, 0.04))
    for i in range(2):
        ref = cv2.cornerHarris(xf[i, ..., 0], 2, 3, 0.04)
        np.testing.assert_allclose(got[i, ..., 0], ref, rtol=0, atol=1e-6)


def test_corner_eigen_vals_and_vecs():
    img = _smooth(2, (32, 32))
    got = tcv.cornerEigenValsAndVecs(torch.from_numpy(img), 3, 3).numpy()
    want = np.asarray(jcv.cornerEigenValsAndVecs(img, 3, 3))
    assert got.shape == want.shape == (32, 32, 6)
    _assert_close_to_ref(got[..., :2], want[..., :2])
    # eigenvectors are unit vectors up to sign, close to the reference's
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], rtol=0, atol=1e-3)
    # eigenvalues must match cv2; eigenvector signs may flip
    np.testing.assert_allclose(got[..., :2], cv2.cornerEigenValsAndVecs(img, 3, 3)[..., :2],
                               rtol=0, atol=1e-5)


def test_pre_corner_detect():
    img = np.random.default_rng(1).integers(0, 255, (40, 50), np.uint8)
    for ks in (3, 5):
        got = tcv.preCornerDetect(torch.from_numpy(img), ks).numpy()
        _assert_close_to_ref(got, jcv.preCornerDetect(img, ks))
        np.testing.assert_allclose(got, cv2.preCornerDetect(img, ks), rtol=0, atol=1e-3)
    f = img.astype(np.float32) / 255.0
    got = tcv.preCornerDetect(torch.from_numpy(f), 3).numpy()
    _assert_close_to_ref(got, jcv.preCornerDetect(f, 3))
    np.testing.assert_allclose(got, cv2.preCornerDetect(f, 3), rtol=0, atol=1e-5)


# ------------------------------------------------------------ Canny

def test_canny_tables_equal_reference():
    assert tcanny._TG22 == J_TG22


@pytest.mark.parametrize("aperture", [3, 5, 7])
@pytest.mark.parametrize("l2", [False, True])
def test_canny_exact(l2, aperture):
    thresh = {3: (50, 150), 5: (200, 600), 7: (2000, 6000)}[aperture]
    imgs = np.stack([_smooth(aperture, (64, 80)), _smooth(aperture + 1, (64, 80), (3, 3), 0.8)])
    x = imgs[..., None]
    stats = {}
    got = tcv.Canny(torch.from_numpy(x), *thresh, apertureSize=aperture, L2gradient=l2,
                    stats=stats).numpy()
    want = np.asarray(jcv.Canny(x, *thresh, apertureSize=aperture, L2gradient=l2))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert stats["iterations"] == stats["host_syncs"] * tcanny.HYST_CHECK_EVERY
    if aperture == 7:
        return  # the reference is held to cv2 at apertures 3 and 5 only
    for i in range(2):
        ref = cv2.Canny(imgs[i], *thresh, apertureSize=aperture, L2gradient=l2)
        assert np.count_nonzero(ref != got[i, ..., 0]) <= ref.size * 0.002


def test_canny_noise_aperture7_wraps_like_int32():
    """Binary noise saturates Sobel 7 at -32768, where |dx| << 16 wraps in
    int32; the port wraps as the reference does."""
    x = (np.random.default_rng(3).integers(0, 2, (1, 40, 48, 1)) * 255).astype(np.uint8)
    dx = tcv.Sobel(torch.from_numpy(x), tcv.CV_16S, 1, 0, ksize=7,
                   borderType=tcv.BORDER_REPLICATE)
    assert int(dx.min()) == -32768
    for l2 in (False, True):
        got = tcv.Canny(torch.from_numpy(x), 3000, 9000, apertureSize=7, L2gradient=l2).numpy()
        np.testing.assert_array_equal(got, np.asarray(jcv.Canny(x, 3000, 9000, apertureSize=7,
                                                               L2gradient=l2)))


def test_canny_multichannel_and_per_image():
    rng = np.random.default_rng(4)
    x = np.stack([cv2.GaussianBlur(rng.integers(0, 256, (40, 44, 3), np.uint8), (5, 5), 1.2)
                  for _ in range(2)])
    got = tcv.Canny(torch.from_numpy(x), 40, 120).numpy()
    want = np.asarray(jcv.Canny(x, 40, 120))
    assert got.shape == want.shape == (2, 40, 44, 1)
    np.testing.assert_array_equal(got, want)
    img = x[0, ..., 0]
    got = tcv.Canny(torch.from_numpy(img), 150, 50).numpy()  # thresholds in either order
    assert got.shape == img.shape
    np.testing.assert_array_equal(got, np.asarray(jcv.Canny(img, 150, 50)))


def test_canny_hysteresis_counts_converged_groups():
    """The changed-flag is read once per HYST_CHECK_EVERY iterations, and
    the loop stops at the first group that changes nothing."""
    cand = torch.zeros((1, 5, 40, 1), dtype=torch.bool)
    cand[0, 2, :, 0] = True          # a 40-pixel line
    seeds = torch.zeros_like(cand)
    seeds[0, 2, 0, 0] = True         # grown one pixel per iteration
    stats = {}
    out = tcanny._hysteresis(seeds, cand, stats)
    assert torch.equal(out, cand)
    k = tcanny.HYST_CHECK_EVERY
    # 39 growing iterations take ceil(39/k) groups; one more finds no change
    assert stats == {"iterations": stats["host_syncs"] * k, "host_syncs": -(-39 // k) + 1}
