"""The port's bag of visual words, AffineFeature and detector evaluation
(``opencv_tpu_torch.features2d``: ``bow``, ``affine_feature``,
``evaluation``) on the CPU, against ``opencv_tpu.features2d`` and cv2.

- evaluation (a copy of the JAX package's numpy): exact.
- BOW: the vocabulary is the port's kmeans, held as tests/test_torch_grabcut.py
  holds kmeans (the port's cluster sums are exact f64, the JAX package's
  f32): at least LABEL_SHARE of the labels equal and the centres within
  CENTER_RTOL; the image descriptor exactly.
- AffineFeature at 96×128 (the reference's own test takes minutes, each
  view's shape a JAX compile): the view grids exact; the views of maxTilt
  1 at a roll step base of 150° (tilt 1; tilt √2 at 0° and 106°) and one
  view of tilt 2 (the image, its mask and its pose) exact, and with the
  same backend in both wrappers (the port's ORB) on those views the
  keypoints and descriptors exact, view by view; against cv2, the reference test's
  bounds with a SIFT backend at maxTilt 1 (tests/test_features2d.py)."""

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from torch_threads import _one_torch_thread  # noqa: F401

LABEL_SHARE = 0.999
CENTER_RTOL = 1e-5


def _img(seed=0, h=120, w=160):
    rng = np.random.default_rng(seed)
    return cv2.GaussianBlur(rng.integers(0, 256, (h, w), np.uint8), (3, 3), 1.0)


def _kps(pts, size=16.0):
    return [tcv.KeyPoint(float(x), float(y), size) for x, y in pts]


@pytest.mark.parametrize("H", [np.eye(3), np.array([[1, 0, 5.0], [0, 1, -3.0], [0, 0, 1]]),
                               np.array([[0.98, 0.05, 4.0], [-0.04, 1.02, 2.0],
                                         [1e-4, -2e-4, 1.0]])],
                         ids=["identity", "shift", "homography"])
def test_evaluate_feature_detector_equals_opencv_tpu(H):
    rng = np.random.default_rng(0)
    img = _img()
    pts = rng.uniform(20, 100, (30, 2))
    k1 = _kps(pts, 12.0)
    p2 = (H @ np.c_[pts, np.ones(len(pts))].T).T
    p2 = p2[:, :2] / p2[:, 2:] + rng.normal(0, 0.7, p2[:, :2].shape)
    k2 = _kps(p2, 13.0)
    got = tcv.evaluateFeatureDetector(torch.from_numpy(img), img, torch.from_numpy(H), k1, k2)
    want = jcv.evaluateFeatureDetector(img, img, H, k1, k2)
    assert got == want and got[1] > 0
    assert tcv.evaluateFeatureDetector(img, img, H, k1, _kps(pts + 60.0)) == \
        jcv.evaluateFeatureDetector(img, img, H, k1, _kps(pts + 60.0))


def test_evaluate_feature_detector_with_a_detector():
    img = _img(3, 60, 80)
    shifted = np.roll(img, (4, 7), axis=(0, 1))
    H = np.array([[1, 0, 7.0], [0, 1, 4.0], [0, 0, 1]])
    det = tcv.FastFeatureDetector_create(threshold=40)
    got = tcv.evaluateFeatureDetector(img, shifted, H, [], [], det)
    want = jcv.evaluateFeatureDetector(img, shifted, H, [], [], det)
    assert got == want and got[0] > 0.5


def test_recall_precision_curve_equals_opencv_tpu():
    class M:
        def __init__(self, d):
            self.distance = d

    rng = np.random.default_rng(1)
    matches = [[M(float(d)) for d in rng.random(rng.integers(1, 4))] for _ in range(25)]
    mask = [rng.integers(0, 2, len(r)).tolist() for r in matches]
    got = tcv.computeRecallPrecisionCurve(matches, mask)
    want = jcv.computeRecallPrecisionCurve(matches, mask)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    for p in (-0.5, 0.0, 0.25, 0.5, 0.9, 1.0, 1.5):
        assert tcv.getNearestPoint(got, p) == jcv.getNearestPoint(want, p)
        assert tcv.getRecall(got, p) == jcv.getRecall(want, p)
    small = [[M(0.1), M(0.5)], [M(0.2)], [M(0.3)]]
    curve = tcv.computeRecallPrecisionCurve(small, [[1, 0], [1], [0]])
    assert np.allclose(curve, [[0.0, 0.5], [0.0, 1.0], [1 / 3, 1.0], [0.5, 1.0]])


@pytest.fixture(scope="module")
def descs():
    rng = np.random.default_rng(0)
    centers_gt = rng.normal(0, 10, (4, 32)).astype(np.float32)
    d = np.vstack([c + rng.normal(0, 0.3, (50, 32)) for c in centers_gt]).astype(np.float32)
    return centers_gt, d


def test_bow_trainer_equals_opencv_tpu(descs):
    centers_gt, d = descs
    tt, jt = tcv.BOWKMeansTrainer(4), jcv.BOWKMeansTrainer(4)
    for tr in (tt, jt):
        tr.add(d[:120])
        tr.add(d[120:])
    tt.add(torch.from_numpy(d[:0]))
    assert tt.descriptorsCount() == jt.descriptorsCount() == 200
    assert all(np.array_equal(a, b) for a, b in zip(tt.getDescriptors(), jt.getDescriptors()))
    got, want = tt.cluster(), jt.cluster()
    assert got.dtype == want.dtype == np.float32 and got.shape == (4, 32)
    np.testing.assert_allclose(got, want, rtol=CENTER_RTOL, atol=1e-5)
    ext_t, ext_j = tcv.BOWImgDescriptorExtractor(), jcv.BOWImgDescriptorExtractor()
    ext_t.setVocabulary(torch.from_numpy(want))
    ext_j.setVocabulary(want)
    lab_t = ((d[:, None] - got[None]) ** 2).sum(-1).argmin(1)
    lab_j = ((d[:, None] - want[None]) ** 2).sum(-1).argmin(1)
    assert (lab_t == lab_j).mean() >= LABEL_SHARE
    # the reference test's semantics: every true centre found, balanced words
    assert (np.sqrt(((got[:, None] - centers_gt[None]) ** 2).sum(-1).min(0)) < 1.0).all()
    h = ext_t.compute2(torch.from_numpy(d))
    assert np.array_equal(h, ext_j.compute2(d)) and abs(h.sum() - 1.0) < 1e-6
    assert (np.abs(h - 0.25) < 0.05).all()
    assert np.array_equal(ext_t.compute2(d[:0]), ext_j.compute2(d[:0]))
    assert ext_t.descriptorSize() == 4 and np.array_equal(ext_t.getVocabulary(), want)
    tt.clear()
    assert tt.descriptorsCount() == 0
    got2 = tcv.BOWKMeansTrainer(3, attempts=1).cluster(torch.from_numpy(d[:90]))
    want2 = jcv.BOWKMeansTrainer(3, attempts=1).cluster(d[:90])
    np.testing.assert_allclose(got2, want2, rtol=CENTER_RTOL, atol=1e-5)


def test_bow_extractor_compute_through_a_backend():
    img = _img(5)
    orb = tcv.ORB_create(nfeatures=60)
    kps = orb.detect(img)
    vocab = np.random.default_rng(2).integers(0, 256, (5, 32)).astype(np.float32)
    ext = tcv.BOWImgDescriptorExtractor(orb, tcv.BFMatcher(tcv.NORM_L2))
    ext.setVocabulary(vocab)
    h, kps2 = ext.compute(torch.from_numpy(img), kps)
    _, d = orb.compute(img, kps)
    assert np.array_equal(h, jcv.BOWImgDescriptorExtractor().__class__.compute2(
        _with_vocab(vocab), d))
    assert len(kps2) == len(d)


def _with_vocab(vocab):
    e = jcv.BOWImgDescriptorExtractor()
    e.setVocabulary(vocab)
    return e


@pytest.mark.parametrize("args", [(2, 0), (1, 0), (2, 1), (5, 0)])
def test_affine_feature_views_equal_opencv_tpu(args):
    t = tcv.AffineFeature_create(None, *args)
    j = jcv.AffineFeature_create(None, *args)
    assert t.getViewParams() == j.getViewParams()


def test_affine_feature_view_images_equal_opencv_tpu():
    img = _img(7, 96, 128)
    t = tcv.AffineFeature_create(None, maxTilt=1, rotateStepBase=150.0)
    j = jcv.AffineFeature_create(None, maxTilt=1, rotateStepBase=150.0)
    x = torch.from_numpy(img)
    tilts, rolls = t.getViewParams()
    assert len(tilts) == 3
    for tilt, phi in zip(tilts + [2.0000000000000004], rolls + [126.0]):
        gv, gm, gp = t._affine_skew(x, tilt, phi)
        wv, wm, wp = j._affine_skew(img, tilt, phi)
        assert np.array_equal(gv.numpy(), np.asarray(wv)), (tilt, phi)
        assert np.array_equal(gm, np.asarray(wm)) and np.array_equal(gp, wp), (tilt, phi)


def test_affine_feature_with_a_shared_backend_equals_opencv_tpu():
    img = _img(9, 96, 128)
    orb = tcv.ORB_create(nfeatures=80)
    gk, gd = tcv.AffineFeature_create(orb, 1, rotateStepBase=150.0).detectAndCompute(
        torch.from_numpy(img))
    wk, wd = jcv.AffineFeature_create(orb, 1, rotateStepBase=150.0).detectAndCompute(img)
    key = [(k.pt, k.size, k.angle, k.response, k.octave, k.class_id) for k in gk]
    assert key == [(k.pt, k.size, k.angle, k.response, k.octave, k.class_id) for k in wk]
    assert len({k.class_id for k in gk}) > 1
    assert gd.dtype == wd.dtype and np.array_equal(gd, wd)
    only = tcv.AffineFeature_create(orb, maxTilt=2).detect(img)
    assert len(only) and all(np.isfinite(k.pt).all() for k in only)
    _, d = tcv.AffineFeature_create(orb).compute(img, only[:5])
    assert d.shape[0] <= 5


def test_affine_feature_matches_cv2():
    """tests/test_features2d.py::test_affine_feature_asift's bounds."""
    img = cv2.GaussianBlur(_img(11, 140, 180), (0, 0), 1.0)
    rk, rd = cv2.AffineFeature_create(cv2.SIFT_create(nfeatures=150), maxTilt=1
                                      ).detectAndCompute(img, None)
    ok, od = tcv.AffineFeature_create(tcv.SIFT_create(nfeatures=150), maxTilt=1
                                      ).detectAndCompute(torch.from_numpy(img))
    assert len(ok) >= 0.8 * len(rk)
    rset = {(round(k.pt[0]), round(k.pt[1])) for k in rk}
    oset = {(round(k.pt[0]), round(k.pt[1])) for k in ok}
    assert len(rset & oset) >= 0.6 * min(len(rset), len(oset))
    assert od is not None and od.shape[1] == rd.shape[1]
