"""opencv_tpu_torch's corner responses, goodFeaturesToTrack, GFTTDetector,
the KeyPoint API and Canny against opencv_tpu and the cv2 oracle, on the
CPU (plain tier).

Tolerances: the corner family is float32 arithmetic in another order than
XLA's, so it is held to opencv_tpu at rtol 1e-5 plus atol 1e-6·max|ref|,
and to cv2 at tests/test_analysis.py's bounds.  The corner sets of GFTT
are held as tests/test_analysis.py holds the reference's: an overlap of at
least 85% of the larger set (80% with Harris), against both.  Canny is
integer throughout and equals opencv_tpu exactly; against cv2 it carries
the reference's bound (at most 0.2% of pixels differ), where the
reference's tests check cv2: single-channel images, apertures 3 and 5."""

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
from opencv_tpu.features2d import keypoint as jkp
from opencv_tpu.ops.canny import _TG22 as J_TG22

import opencv_tpu_torch as tcv
from opencv_tpu_torch.features2d import keypoint as tkp
from opencv_tpu_torch.ops import canny as tcanny
from opencv_tpu_torch.ops import corners as tcorners


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


# ------------------------------------------------------------ goodFeaturesToTrack

def _assert_overlap(got, want, share):
    """tests/test_analysis.py's rule: the integer corner sets share at least
    `share` of the larger one (the order of equal responses is free)."""
    a = {tuple(p) for p in np.asarray(got).reshape(-1, 2).astype(int).tolist()}
    b = {tuple(p) for p in np.asarray(want).reshape(-1, 2).astype(int).tolist()}
    assert len(a & b) >= share * max(len(a), len(b)), f"{len(a & b)} of {len(a)} / {len(b)}"


# (seed, shape, maxCorners, qualityLevel, minDistance, blockSize); the first
# two are tests/test_analysis.py's cases
GFTT_CASES = [(3, (96, 128), 40, 0.05, 10, 3), (4, (64, 96), 20, 0.05, 8, 3),
              (5, (80, 100), 0, 0.01, 5, 5), (6, (72, 90), 30, 0.02, 0, 3)]


@pytest.mark.parametrize("harris", [False, True], ids=["min eigen", "harris"])
@pytest.mark.parametrize("case", GFTT_CASES, ids=[str(c[:5]) for c in GFTT_CASES])
def test_good_features_to_track(case, harris):
    seed, shape, n, q, dist, block = case
    img = _smooth(seed, shape)
    kw = dict(blockSize=block, useHarrisDetector=harris, k=0.04)
    got = tcv.goodFeaturesToTrack(torch.from_numpy(img), n, q, dist, **kw)
    assert got.dtype == np.float32 and got.shape[1:] == (1, 2)
    share = 0.8 if harris else 0.85
    _assert_overlap(got, jcv.goodFeaturesToTrack(img, n, q, dist, **kw), share)
    _assert_overlap(got, cv2.goodFeaturesToTrack(img, n, q, dist, **kw), share)
    if n > 0:
        assert len(got) <= n


def test_good_features_response_and_quality():
    img = _smooth(7, (64, 80))
    x = torch.from_numpy(img[None, :, :, None])
    eig, sel = tcorners.good_features_response(x, 50, 0.02)
    jeig, jsel = jcv.ops.corners.good_features_response(img[None, :, :, None], 50, 0.02)
    _assert_close_to_ref(eig.numpy(), np.asarray(jeig))
    assert sel.dtype == torch.bool and not sel[0, 0].any() and not sel[0, :, -1].any()
    # the local maxima agree but for ties that float order may break
    assert (sel.numpy() != np.asarray(jsel)).sum() <= 2
    pts, qual = tcv.goodFeaturesToTrackWithQuality(x, 30, 0.02, 6)
    jpts, jqual = jcv.goodFeaturesToTrackWithQuality(img, 30, 0.02, 6)
    assert pts.shape == (len(qual), 1, 2) and qual.shape == (len(qual), 1)
    _assert_overlap(pts, jpts, 0.85)
    assert np.all(np.diff(qual[:, 0]) <= 0)
    common = {tuple(p): v for p, v in zip(jpts.reshape(-1, 2).tolist(), jqual[:, 0])}
    for p, v in zip(pts.reshape(-1, 2).tolist(), qual[:, 0]):
        if tuple(p) in common:
            assert abs(v - common[tuple(p)]) <= 1e-5 * abs(v) + 1e-6 * qual.max()


def test_good_features_to_track_mask_and_empty():
    img = _smooth(8, (64, 80))
    mask = np.zeros_like(img)
    mask[10:40, 20:60] = 1
    got = tcv.goodFeaturesToTrack(torch.from_numpy(img), 25, 0.01, 5, mask=torch.from_numpy(mask))
    assert np.all((got[:, 0, 0] >= 20) & (got[:, 0, 0] < 60) & (got[:, 0, 1] >= 10)
                  & (got[:, 0, 1] < 40))
    _assert_overlap(got, jcv.goodFeaturesToTrack(img, 25, 0.01, 5, mask=mask), 0.85)
    _assert_overlap(got, cv2.goodFeaturesToTrack(img, 25, 0.01, 5, mask=mask), 0.85)
    flat = torch.full((32, 32), 7, dtype=torch.uint8)
    assert tcv.goodFeaturesToTrack(flat, 10, 0.01, 3) is None
    assert tcv.goodFeaturesToTrackWithQuality(flat, 10, 0.01, 3) == (None, None)


def test_gftt_detector_and_keypoints():
    img = _smooth(9, (96, 128))
    det = tcv.GFTTDetector_create(maxCorners=60, qualityLevel=0.02, minDistance=4, blockSize=3)
    kps = det.detect(torch.from_numpy(img))
    jkps = jcv.GFTTDetector_create(maxCorners=60, qualityLevel=0.02, minDistance=4,
                                   blockSize=3).detect(img)
    assert all(isinstance(k, tcv.KeyPoint) and k.size == 6.0 for k in kps)
    _assert_overlap([k.pt for k in kps], [k.pt for k in jkps], 0.85)
    _assert_overlap([k.pt for k in kps], [k.pt for k in cv2.GFTTDetector_create(
        60, 0.02, 4, 3).detect(img)], 0.85)
    det.setMaxFeatures(5)
    assert det.getMaxFeatures() == 5 and len(det.detect(torch.from_numpy(img))) == 5
    assert tcv.GFTTDetector.create().detect(torch.zeros((16, 16), dtype=torch.uint8)) == []

    # the KeyPoint helpers are copies of the reference's: the same results
    rng = np.random.default_rng(10)
    pts = rng.random((12, 2)) * 50
    resp = np.round(rng.random(12), 1)
    ours = [tcv.KeyPoint(x, y, 5 + i % 3, response=r) for i, ((x, y), r) in enumerate(zip(pts, resp))]
    theirs = [jcv.KeyPoint(x, y, 5 + i % 3, response=r)
              for i, ((x, y), r) in enumerate(zip(pts, resp))]
    for n in (0, 4, 7, 20):
        assert ([k.pt for k in tkp.retain_best(ours, n)]
                == [k.pt for k in jkp.retain_best(theirs, n)])
    assert ([k.pt for k in tkp.run_by_image_border(ours, (48, 40), 6)]
            == [k.pt for k in jkp.run_by_image_border(theirs, (48, 40), 6)])
    np.testing.assert_array_equal(tcv.KeyPoint_convert(ours), jcv.KeyPoint_convert(theirs))
    np.testing.assert_array_equal(tcv.KeyPoint_convert(ours, [3, 1]),
                                  jcv.KeyPoint_convert(theirs, [3, 1]))
    assert [k.pt for k in tcv.KeyPoint_convert(pts)] == [k.pt for k in jcv.KeyPoint_convert(pts)]
    for a, b in ((0, 1), (2, 2), (3, 9)):
        assert tcv.KeyPoint_overlap(ours[a], ours[b]) == jcv.KeyPoint_overlap(theirs[a], theirs[b])
        assert tcv.KeyPoint_overlap(ours[a], ours[b]) == pytest.approx(
            cv2.KeyPoint_overlap(cv2.KeyPoint(*ours[a].pt, ours[a].size),
                                 cv2.KeyPoint(*ours[b].pt, ours[b].size)), abs=1e-6)


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
