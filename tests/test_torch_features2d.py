"""FAST, ORB, BFMatcher and the INTER_LINEAR_EXACT resize of the port
against ``opencv_tpu`` (run on the CPU; FAST and ORB have no Pallas kernel)
and cv2, at small sizes.

ORB results are compared as sets keyed by (octave, x, y): ``torch.topk``
orders equal values freely, so keypoints of equal response may come back
in another order, while the retained set is fixed by the tie counts
(``opencv_tpu_torch/features2d/orb.py``)."""

import math

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu.features2d import fast as jfast
from opencv_tpu.features2d import orb as jorb
from opencv_tpu_torch.core.dispatch import reset_tier_stats, tier_stats
from opencv_tpu_torch.features2d import fast as tfast
from opencv_tpu_torch.features2d import orb as torb
from opencv_tpu_torch.ops import resize as tresize
from torch_threads import _one_torch_thread  # noqa: F401

# ORB against opencv_tpu: the JAX package takes float32 products in XLA's
# order, which fuses multiply-adds, and the port takes them one op at a
# time; responses and angles then differ in the last bits of float32
RESP_RTOL = 1e-6
ANGLE_TOL = 1e-4  # degrees


def _blurred(seed, shape):
    """Noise smoothed by cv2.GaussianBlur 3x3 sigma 1, per image, as
    tests/test_features2d.py makes its images."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, shape, np.uint8)
    if imgs.ndim == 2:
        return cv2.GaussianBlur(imgs, (3, 3), 1.0)
    return np.stack([cv2.GaussianBlur(i, (3, 3), 1.0) for i in imgs])


def orb_by_key(kps, desc):
    """{(octave, x, y): (keypoint, descriptor row)} of one image's result."""
    out = {(k.octave, k.pt[0], k.pt[1]): (k, None if desc is None else desc[i])
           for i, k in enumerate(kps)}
    assert len(out) == len(kps), "two keypoints share (octave, x, y)"
    return out


def assert_orb_equal(got, want):
    """Per image: the same keypoint set, responses within RESP_RTOL,
    angles within ANGLE_TOL, sizes equal and descriptors equal per key."""
    assert len(got) == len(want)
    for i, ((gk, gd), (wk, wd)) in enumerate(zip(got, want)):
        g, w = orb_by_key(gk, gd), orb_by_key(wk, wd)
        assert set(g) == set(w), (i, len(set(g) - set(w)), len(set(w) - set(g)))
        for key, (kw, dw) in w.items():
            kg, dg = g[key]
            assert abs(kg.response - kw.response) <= RESP_RTOL * abs(kw.response), key
            da = abs(kg.angle - kw.angle)
            assert min(da, 360 - da) <= ANGLE_TOL, (key, kg.angle, kw.angle)
            assert kg.size == kw.size
            if dw is not None:
                np.testing.assert_array_equal(dg, dw, err_msg=str(key))
        if wd is not None:
            assert gd.dtype == np.uint8 and gd.shape == wd.shape


# ---------------------------------------------------------------------------
# FAST
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fast_imgs():
    return _blurred(0, (2, 120, 160))[..., None]


@pytest.mark.parametrize("threshold", [10, 25])
@pytest.mark.parametrize("nonmax", [True, False])
@pytest.mark.parametrize("pattern", [16, 12, 8])
def test_fast_matches_opencv_tpu(fast_imgs, pattern, nonmax, threshold):
    import jax.numpy as jnp
    want = jfast.fast_keypoint_mask(jnp.asarray(fast_imgs), threshold, nonmax, pattern)
    got = tfast.fast_keypoint_mask(torch.from_numpy(fast_imgs), threshold, nonmax, pattern)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    rs, rc = tfast.fast_response(torch.from_numpy(fast_imgs), threshold, pattern)
    js, jc = jfast.fast_response(jnp.asarray(fast_imgs), threshold, pattern)
    np.testing.assert_array_equal(rs.numpy(), np.asarray(js))
    np.testing.assert_array_equal(rc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("shape", [(1, 6, 6, 1), (1, 7, 9, 1), (2, 33, 17, 1)])
def test_fast_small_images(shape):
    import jax.numpy as jnp
    x = np.random.default_rng(3).integers(0, 256, shape, np.uint8)
    for pattern in (16, 12, 8):
        want = jfast.fast_keypoint_mask(jnp.asarray(x), 0, True, pattern)
        got = tfast.fast_keypoint_mask(torch.from_numpy(x), 0, True, pattern)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("nonmax", [True, False])
@pytest.mark.parametrize("ftype", [tcv.FAST_FEATURE_DETECTOR_TYPE_9_16,
                                   tcv.FAST_FEATURE_DETECTOR_TYPE_7_12,
                                   tcv.FAST_FEATURE_DETECTOR_TYPE_5_8])
def test_fast_keypoints_match_cv2(ftype, nonmax):
    """Positions and responses equal to cv2's, as tests/test_features2d.py
    holds the reference."""
    img = _blurred(13, (120, 160))
    rk = cv2.FastFeatureDetector_create(20, nonmax, type=ftype).detect(img)
    ok = tcv.FastFeatureDetector_create(20, nonmax, type=ftype).detect(img)

    def key(k):
        return (round(k.pt[0]), round(k.pt[1])) + ((round(k.response),) if nonmax else ())

    assert {key(k) for k in rk} == {key(k) for k in ok}
    assert len(ok) == len(tcv.FastFeatureDetector_detect(img, 20, nonmax, ftype))


def test_fast_detector_mask_and_threshold():
    img = _blurred(1, (80, 100))
    det = tcv.FastFeatureDetector_create(25)
    det.setThreshold(20)
    assert det.getThreshold() == 20
    mask = np.zeros((80, 100), np.uint8)
    mask[:, :50] = 1
    kps = det.detect(img, mask)
    assert kps and all(k.pt[0] < 50 for k in kps)
    ref = {(k.pt, k.response) for k in jcv.FastFeatureDetector_create(20).detect(img, mask)}
    assert {(k.pt, k.response) for k in kps} == ref


# ---------------------------------------------------------------------------
# ORB
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def orb_batch():
    return _blurred(5, (2, 240, 320))


# (nfeatures, WTA_K, scoreType): every WTA_K, both score types and both
# budgets; each JAX ORB compiles its own program (~10 s on the CPU)
ORB_CASES = [(500, 2, tcv.ORB_HARRIS_SCORE), (200, 2, tcv.ORB_FAST_SCORE),
             (200, 3, tcv.ORB_HARRIS_SCORE), (500, 4, tcv.ORB_FAST_SCORE)]


@pytest.mark.parametrize("nfeatures,wta_k,score_type", ORB_CASES)
def test_orb_batch_matches_opencv_tpu(orb_batch, nfeatures, wta_k, score_type):
    want = jcv.ORB_create(nfeatures, WTA_K=wta_k, scoreType=score_type) \
        .detect_and_compute_batch(orb_batch)
    reset_tier_stats()
    got = tcv.ORB_create(nfeatures, WTA_K=wta_k, scoreType=score_type) \
        .detect_and_compute_batch(torch.from_numpy(orb_batch))
    # the descriptor blur takes sep_filter's plain version once per level
    assert tier_stats() == {"tier.sep_filter_u8.plain": 8}
    assert_orb_equal(got, want)
    assert all(len(k) > 0.8 * nfeatures for k, _ in got)


def test_orb_single_image_detect_and_compute(orb_batch):
    img = orb_batch[0]
    j = jcv.ORB_create(nfeatures=150)
    t = tcv.ORB_create(nfeatures=150)
    assert_orb_equal([t.detectAndCompute(img, None)], [j.detectAndCompute(img, None)])
    assert_orb_equal([(t.detect(img), None)], [(j.detect(img), None)])
    # compute with given keypoints, and a BGR image; three levels, since
    # opencv_tpu's compute compiles a resize and a blur per level
    t3, j3 = tcv.ORB_create(nfeatures=150, nlevels=3), jcv.ORB_create(nfeatures=150, nlevels=3)
    kps = t3.detect(img)
    assert {k.octave for k in kps} == {0, 1, 2}
    want = j3.compute(img, kps)[1]
    np.testing.assert_array_equal(t3.compute(img, kps)[1], want)
    bgr = np.repeat(img[..., None], 3, axis=2)
    np.testing.assert_array_equal(t3.compute(bgr, kps)[1], want)
    assert t3.compute(img, [])[1].shape == (0, 32)


@pytest.mark.parametrize("wta_k", [2, 3, 4])
def test_orb_compute_equals_detect_and_compute(orb_batch, wta_k):
    """compute on detected keypoints gives detectAndCompute's descriptors:
    both take the one rotated-BRIEF sampler, WTA_K included (opencv_tpu's
    compute samples pairs whatever WTA_K is), and compute blurs each level
    through sep_filter."""
    orb = tcv.ORB_create(nfeatures=150, WTA_K=wta_k)
    kps, desc = orb.detectAndCompute(orb_batch[1], None)
    reset_tier_stats()
    got = orb.compute(torch.from_numpy(orb_batch[1]), kps[::-1])[1]
    assert tier_stats() == {"tier.sep_filter_u8.plain": 8}
    np.testing.assert_array_equal(got, desc[::-1])


def _brief_np(blurred, x0, y0, angle, border):
    """One WTA_K=2 descriptor at level pixel (x0, y0), the pattern points
    outside the image clipped (opencv_tpu's compute) or folded by
    REFLECT_101 (the port, and the reference's pyramid margins)."""
    pat = torb._PATTERN.reshape(512, 2).astype(np.float32)
    ang = np.float32(angle) * np.float32(math.pi / 180.0)
    a, b = np.float32(math.cos(float(ang))), np.float32(math.sin(float(ang)))
    rx = np.rint(pat[:, 0] * a - pat[:, 1] * b).astype(np.int64)
    ry = np.rint(pat[:, 0] * b + pat[:, 1] * a).astype(np.int64)
    if border == "clip":
        vals = blurred[np.clip(y0 + ry, 0, blurred.shape[0] - 1),
                       np.clip(x0 + rx, 0, blurred.shape[1] - 1)]
    else:
        vals = np.pad(blurred, 32, mode="reflect")[y0 + ry + 32, x0 + rx + 32]
    return np.packbits(vals[0::2] < vals[1::2], bitorder="little")


def test_orb_compute_border_reflects_where_opencv_tpu_clips(orb_batch):
    """A deliberate divergence: at the image border the port's compute
    folds the pattern by REFLECT_101, as its detectAndCompute and the
    reference's pyramid margins do; opencv_tpu's compute clips.  Inside,
    the two are equal."""
    img = orb_batch[0]
    H, W = img.shape
    kps = [tcv.KeyPoint(x, y, 31, ang, 0, 0)
           for x, y, ang in ((160, 120, 45.0), (1, 1, 30.0), (W - 2, 50, 200.0),
                             (100, H - 1, 95.0), (3, H - 4, 300.0))]
    got = tcv.ORB_create(nlevels=1).compute(img, kps)[1]
    want = jcv.ORB_create(nlevels=1).compute(img, kps)[1]
    blurred = tcv.GaussianBlur(img, (7, 7), 2.0, 2.0, tcv.BORDER_REFLECT_101).numpy()
    for i, k in enumerate(kps):
        x0, y0 = int(k.pt[0]), int(k.pt[1])
        np.testing.assert_array_equal(got[i], _brief_np(blurred, x0, y0, k.angle, "reflect"))
        np.testing.assert_array_equal(want[i], _brief_np(blurred, x0, y0, k.angle, "clip"))
    np.testing.assert_array_equal(got[0], want[0])
    assert all((got[i] != want[i]).any() for i in range(1, len(kps)))


def test_orb_second_batch_builds_no_tables(orb_batch, monkeypatch):
    orb = tcv.ORB_create(nfeatures=100)
    first = orb.detect_and_compute_batch(torch.from_numpy(orb_batch))

    def fail(*args):
        raise AssertionError("a table was rebuilt for the same shape")

    monkeypatch.setattr(torb, "border_index", fail)
    monkeypatch.setattr(torb, "_ic_weight_mats", fail)
    monkeypatch.setattr(torb, "_orb_pattern_for_wta", fail)
    monkeypatch.setattr(tresize, "_linear_exact_coeffs", fail)
    assert_orb_equal(orb.detect_and_compute_batch(torch.from_numpy(orb_batch)), first)


@pytest.mark.parametrize("wta_k", [2, 3, 4])
def test_orb_host_tables_match_opencv_tpu(wta_k):
    np.testing.assert_array_equal(torb._orb_pattern_for_wta(wta_k),
                                  jorb._orb_pattern_for_wta(wta_k))
    np.testing.assert_array_equal(torb._PATTERN, jorb._PATTERN)
    for hp in (15, 7, 3):
        np.testing.assert_array_equal(torb._umax_table(hp), jorb._umax_table(hp))
        for a, b in zip(torb._ic_weight_mats(hp), jorb._ic_weight_mats(hp)):
            np.testing.assert_array_equal(a, b)
    y = np.random.default_rng(wta_k).normal(0, 100, 10000).astype(np.float32)
    x = np.random.default_rng(wta_k + 10).normal(0, 100, 10000).astype(np.float32)
    x[:4], y[:4] = (0, 0, -1, 1), (0, -1, 0, 0)
    got = torb._fast_atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    # numpy's float32 polynomial fuses nothing either; XLA's (ORB's) does
    np.testing.assert_array_equal(got, jorb._fast_atan2(y, x))
    np.testing.assert_allclose(got, np.asarray(jorb._fast_atan2_jnp(y, x)), rtol=0,
                               atol=ANGLE_TOL)


def test_orb_budget_and_arguments():
    for nf in (200, 500, 1000):
        assert tcv.ORB_create(nf)._budget() == jcv.ORB_create(nf)._budget()
    with pytest.raises(AssertionError):
        tcv.ORB_create(firstLevel=1)
    with pytest.raises(ValueError):
        tcv.ORB_create().detect_and_compute_batch(torch.zeros((1, 64, 64), dtype=torch.int16))


# the reference's own bounds against cv2 (tests/test_features2d.py)

def _key(k):
    return (round(k.pt[0]), round(k.pt[1]), k.octave)


def test_orb_matches_cv2():
    img = _blurred(2, (240, 320))
    rk, rd = cv2.ORB_create(nfeatures=200).detectAndCompute(img, None)
    ok, od = tcv.ORB_create(nfeatures=200).detectAndCompute(img, None)
    rmap = {_key(k): i for i, k in enumerate(rk)}
    omap = {_key(k): i for i, k in enumerate(ok)}
    common = set(rmap) & set(omap)
    assert len(common) >= 0.97 * max(len(rmap), len(omap))
    d = np.asarray([int(np.unpackbits(rd[rmap[c]] ^ od[omap[c]]).sum()) for c in common])
    assert d.mean() < 4.0 and np.median(d) <= 1.0


def test_orb_angles_match_cv2():
    img = _blurred(3, (160, 200))
    rmap = {_key(k): k.angle for k in cv2.ORB_create(nfeatures=100).detect(img, None)}
    checked = 0
    for k in tcv.ORB_create(nfeatures=100).detect(img, None):
        if _key(k) in rmap:
            d = abs(k.angle - rmap[_key(k)])
            assert min(d, 360 - d) < 0.01
            checked += 1
    assert checked > 50


@pytest.mark.parametrize("wta_k", [3, 4])
def test_orb_wta_k_matches_cv2(wta_k):
    img = _blurred(14, (240, 320))
    rk, rd = cv2.ORB_create(nfeatures=150, WTA_K=wta_k).detectAndCompute(img, None)
    ok, od = tcv.ORB_create(nfeatures=150, WTA_K=wta_k).detectAndCompute(img, None)
    rmap = {_key(k): i for i, k in enumerate(rk)}
    omap = {_key(k): i for i, k in enumerate(ok)}
    common = set(rmap) & set(omap)
    assert len(common) >= 0.95 * max(len(rk), len(ok))
    d = [int(np.unpackbits(rd[rmap[c]] ^ od[omap[c]]).sum()) for c in common]
    assert np.median(d) <= 1.0 and np.mean(d) < 4.0


def test_orb_small_edge_threshold_matches_cv2():
    img = _blurred(7, (240, 320))
    rk = cv2.ORB_create(nfeatures=150, edgeThreshold=10).detect(img, None)
    omap = {_key(k): k for k in tcv.ORB_create(nfeatures=150, edgeThreshold=10).detect(img)}
    near = [k for k in rk if min(k.pt[0], k.pt[1], 320 - k.pt[0], 240 - k.pt[1]) < 16]
    checked = 0
    for k in near:
        if _key(k) in omap:
            d = abs(omap[_key(k)].angle - k.angle)
            assert min(d, 360 - d) < 0.01
            checked += 1
    assert checked >= 0.9 * len(near)


# ---------------------------------------------------------------------------
# BFMatcher
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def orb_descs():
    """cv2 ORB descriptors of tests/test_features2d.py's image 4 and of the
    same image rotated by 5 degrees, WTA_K 2 and 3."""
    img1 = _blurred(4, (240, 320))
    img2 = cv2.warpAffine(img1, cv2.getRotationMatrix2D((160, 120), 5, 1.0), (320, 240))
    out = {}
    for wta in (2, 3):
        orb = cv2.ORB_create(nfeatures=150, WTA_K=wta)
        out[wta] = (orb.detectAndCompute(img1, None)[1], orb.detectAndCompute(img2, None)[1])
    return out


def _matches(ms):
    return [(m.queryIdx, m.trainIdx, m.imgIdx, m.distance) for m in ms]


@pytest.mark.parametrize("cross_check", [False, True])
@pytest.mark.parametrize("norm,wta", [(tcv.NORM_HAMMING, 2), (tcv.NORM_HAMMING2, 3),
                                      (tcv.NORM_L2, 2), (tcv.NORM_L2SQR, 2), (tcv.NORM_L1, 2)])
def test_bf_matcher_on_orb_descriptors(orb_descs, norm, wta, cross_check):
    """Hamming distances are exact; so are L2 and L1 on u8 descriptors
    (every sum is an integer below 2^24)."""
    d1, d2 = orb_descs[wta]
    ours, ref = tcv.BFMatcher(norm, cross_check), jcv.BFMatcher(norm, cross_check)
    assert _matches(ours.match(d1, d2)) == _matches(ref.match(d1, d2))
    if cross_check:
        return
    assert [_matches(r) for r in ours.knnMatch(d1, d2, k=2)] == \
        [_matches(r) for r in ref.knnMatch(d1, d2, k=2)]
    radius = {tcv.NORM_HAMMING: 40, tcv.NORM_HAMMING2: 30, tcv.NORM_L2: 400.0,
              tcv.NORM_L2SQR: 1.6e5, tcv.NORM_L1: 2000.0}[norm]
    got, want = ours.radiusMatch(d1, d2, radius), ref.radiusMatch(d1, d2, radius)
    assert [_matches(r) for r in got] == [_matches(r) for r in want]
    assert sum(len(r) for r in got) > 0


def test_bf_matcher_hamming_matrices_and_cv2(orb_descs):
    for wta, fn, jfn, norm in ((2, tcv.features2d.matchers.hamming_distance_matrix,
                                jcv.features2d.matchers.hamming_distance_matrix,
                                cv2.NORM_HAMMING),
                               (3, tcv.features2d.matchers.hamming2_distance_matrix,
                                jcv.features2d.matchers.hamming2_distance_matrix,
                                cv2.NORM_HAMMING2)):
        d1, d2 = orb_descs[wta]
        got = fn(d1, d2)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jfn(d1, d2)))
        ref = cv2.BFMatcher(norm).match(d1, d2)
        assert _matches(tcv.BFMatcher(norm).match(d1, d2)) == \
            [(m.queryIdx, m.trainIdx, 0, m.distance) for m in ref]


@pytest.mark.parametrize("norm", [tcv.NORM_L2, tcv.NORM_L2SQR, tcv.NORM_L1])
def test_bf_matcher_float_descriptors(norm):
    """Float descriptors: distances within 1e-4 of opencv_tpu's (another
    summation order), and L2 nearest neighbours and distances as cv2's
    (tests/test_features2d.py's bound)."""
    rng = np.random.default_rng(5)
    d1 = rng.random((40, 64)).astype(np.float32)
    d2 = rng.random((60, 64)).astype(np.float32)
    ours = tcv.BFMatcher.create(norm).knnMatch(d1, d2, k=2)
    ref = jcv.BFMatcher.create(norm).knnMatch(d1, d2, k=2)
    scale = 1.0 if norm != tcv.NORM_L1 else 10.0
    for r, o in zip(ref, ours):
        assert [m.trainIdx for m in r] == [m.trainIdx for m in o]
        assert all(abs(a.distance - b.distance) < 1e-4 * scale for a, b in zip(r, o))
    if norm == tcv.NORM_L2:
        for r, o in zip(cv2.BFMatcher(cv2.NORM_L2).knnMatch(d1, d2, k=2), ours):
            assert r[0].trainIdx == o[0].trainIdx
            assert abs(r[0].distance - o[0].distance) < 1e-4
    with pytest.raises(ValueError):
        tcv.BFMatcher(tcv.NORM_INF).match(d1, d2)


# ---------------------------------------------------------------------------
# resize INTER_LINEAR_EXACT
# ---------------------------------------------------------------------------

def test_resize_linear_exact_orb_pyramid():
    """The 7 level steps of ORB's pyramid at 240x320, each from the level
    before, equal to opencv_tpu and to cv2."""
    x = np.random.default_rng(20).integers(0, 256, (2, 240, 320), np.uint8)
    sizes = torb._Tables(tcv.ORB_create(), 240, 320, "cpu").sizes
    cur = x
    for size in sizes[1:]:
        got = tcv.resize(torch.from_numpy(cur[..., None]), size,
                         interpolation=tcv.INTER_LINEAR_EXACT)[..., 0].numpy()
        want = np.asarray(jcv.resize(cur[..., None], size,
                                     interpolation=jcv.INTER_LINEAR_EXACT))[..., 0]
        np.testing.assert_array_equal(got, want, err_msg=str(size))
        for i in range(2):
            np.testing.assert_array_equal(
                got[i], cv2.resize(cur[i], size, interpolation=cv2.INTER_LINEAR_EXACT))
        cur = got


@pytest.mark.parametrize("cn", [1, 3, 4])
@pytest.mark.parametrize("src,dst", [((97, 61), (53, 41)), ((33, 27), (99, 81)),
                                     ((64, 64), (32, 32)), ((7, 5), (3, 11)),
                                     ((1, 9), (4, 4))])
def test_resize_linear_exact_u8(src, dst, cn):
    x = np.random.default_rng(cn).integers(0, 256, (src[1], src[0], cn), np.uint8)
    if cn == 1:
        x = x[..., 0]
    got = tcv.resize(torch.from_numpy(x), dst, interpolation=tcv.INTER_LINEAR_EXACT).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jcv.resize(x, dst, interpolation=jcv.INTER_LINEAR_EXACT)))
    np.testing.assert_array_equal(got, cv2.resize(x, dst, interpolation=cv2.INTER_LINEAR_EXACT))


def test_resize_linear_exact_other_dtypes_raise():
    """Other depths raised NotImplementedError until config 2's slice; they
    now take the f32 INTER_LINEAR path, as opencv_tpu reroutes them (1e-6:
    XLA may fuse the multiply-adds)."""
    rng = np.random.default_rng(5)
    for x in (rng.random((2, 8, 8, 1), dtype=np.float32),
              rng.integers(0, 65536, (2, 8, 8, 3)).astype(np.uint16)):
        got = tcv.resize(torch.from_numpy(x), (5, 3), interpolation=tcv.INTER_LINEAR_EXACT)
        want = np.asarray(jcv.resize(x, (5, 3), interpolation=jcv.INTER_LINEAR_EXACT))
        assert got.dtype == torch.from_numpy(want).dtype
        np.testing.assert_allclose(got.numpy().astype(np.float64), want.astype(np.float64),
                                   rtol=0, atol=1e-6)
