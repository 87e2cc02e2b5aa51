"""Stitching of the port (``opencv_tpu_torch/stitch_warpers.py``,
``stitch_detail.py``, ``stitching.py``) against the JAX package's, on the
CPU.

- PyRotationWarper, every projector: the ROI equal, the f64-built maps
  within tests/test_stitching.py's 1e-3 of the JAX package's and of cv2's,
  the warped images equal to the JAX package's and within that test's
  bound of cv2's; warpPoint, warpPointBackward, warpRoi and warpBackward.
- stitch_detail on one pair of ORB features (the port's ORB, given to
  both packages): BestOf2NearestMatcher's matches, homography, inliers and
  confidence equal; the focal estimates, HomographyBasedEstimator and
  waveCorrect equal; the bundle adjusters within 1e-6 relative (a
  Levenberg-Marquardt over numeric Jacobians, Rodrigues from each
  package's calib3d); the gain, channel and block compensators' gains
  within 1e-12 and their images equal; the Voronoi, graph-cut (colour and
  colour-gradient) and DP seam masks equal.
- Stitcher on tests/test_misc_modules.py's scene: that test's checks.
"""

import math

import numpy as np
import pytest
import torch

from common import cv2
from torch_threads import _one_torch_thread  # noqa: F401

import opencv_tpu as jcv
from opencv_tpu import stitch_detail as jd
import opencv_tpu_torch as tcv
from opencv_tpu_torch import stitch_detail as td

KM = np.array([[120., 2, 64], [0, 115, 50], [0, 0, 1]], np.float32)
_ax, _ay = 0.1, -0.2
_RX = np.array([[1, 0, 0], [0, math.cos(_ax), -math.sin(_ax)], [0, math.sin(_ax), math.cos(_ax)]])
_RY = np.array([[math.cos(_ay), 0, math.sin(_ay)], [0, 1, 0], [-math.sin(_ay), 0, math.cos(_ay)]])
RM = (_RY @ _RX).astype(np.float32)
WARPERS = ("plane", "spherical", "cylindrical", "fisheye", "stereographic", "mercator",
           "transverseMercator")


@pytest.mark.parametrize("kind", WARPERS)
def test_rotation_warper_equals_opencv_tpu_and_cv2(kind):
    img = np.random.RandomState(0).randint(0, 256, (100, 128, 3), np.uint8)
    j = jcv.PyRotationWarper(kind, 110.0)
    t = tcv.PyRotationWarper(kind, 110.0, device="cpu")
    c = cv2.PyRotationWarper(kind, 110.0)
    (jc, jdst), (tc, tdst) = j.warp(img, KM, RM), t.warp(img, KM, RM)
    assert tc == jc == c.warp(img, KM, RM, cv2.INTER_LINEAR, cv2.BORDER_CONSTANT)[0]
    np.testing.assert_array_equal(tdst.numpy(), np.asarray(jdst))
    cdst = c.warp(img, KM, RM, cv2.INTER_LINEAR, cv2.BORDER_CONSTANT)[1]
    assert (np.abs(cdst.astype(int) - tdst.numpy().astype(int)) > 2).mean() < 0.005
    jr, tr, cr = (w.buildMaps((128, 100), KM, RM) for w in (j, t, c))
    assert tuple(tr[0]) == tuple(jr[0]) == tuple(cr[0])
    for k in (1, 2):
        assert tr[k].dtype == torch.float32 and tr[k].device == torch.device("cpu")
        assert np.abs(tr[k].numpy() - jr[k]).max() < 1e-3
        assert np.abs(tr[k].numpy() - cr[k]).max() < 1e-3
    for name in ("warpPoint", "warpPointBackward"):
        tp, jp = getattr(t, name)((64, 50), KM, RM), getattr(j, name)((64, 50), KM, RM)
        assert np.hypot(tp[0] - jp[0], tp[1] - jp[1]) < 1e-9, name
    cp = c.warpPoint((64, 50), KM, RM)
    assert np.hypot(tp[0] - jp[0], tp[1] - jp[1]) < 1e-3 and len(cp) == 2
    assert t.warpRoi((128, 100), KM, RM) == j.warpRoi((128, 100), KM, RM)
    np.testing.assert_array_equal(
        t.warpBackward(tdst, KM, RM, 1, 0, (128, 100)).numpy(),
        np.asarray(j.warpBackward(np.asarray(jdst), KM, RM, 1, 0, (128, 100))))
    t.setScale(90.0)
    assert t.getScale() == 90.0


def test_warper_defaults():
    assert tcv.PyRotationWarper().device == torch.device("cuda")
    assert tcv.WarperCreator is tcv.PyRotationWarper
    with pytest.raises(ValueError):
        tcv.PyRotationWarper("no such warper")


def test_opencv_tpu_matcher_lacks_ransac():
    """The divergence of ROADMAP C: the JAX package's BestOf2NearestMatcher
    reads RANSAC from its constants module, which has none, so it raises
    once a pair has enough matches; the port takes calib3d's RANSAC (8),
    and the comparisons below give the JAX package that value."""
    assert not hasattr(jcv.constants, "RANSAC") and tcv.calib3d.RANSAC == 8


@pytest.fixture(scope="module")
def pair():
    """Two overlapping views of one smoothed random scene, the port's ORB
    features of each, and both packages' pairwise matches over them."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jcv.constants, "RANSAC", tcv.calib3d.RANSAC, raising=False)
    yield _pair()
    mp.undo()


def _pair():
    rng = np.random.default_rng(4)
    scene = cv2.GaussianBlur(rng.integers(0, 256, (200, 300, 3), np.uint8), (3, 3), 1)
    imgs = [scene[:, :200].copy(), scene[:, 80:].copy()]
    feats = td.computeImageFeatures(tcv.ORB_create(500), imgs)
    jfeats = [jd.ImageFeatures(f.img_idx, f.img_size, f.keypoints, f.descriptors) for f in feats]
    pm = td.BestOf2NearestMatcher().apply2(feats)
    jpm = jd.BestOf2NearestMatcher().apply2(jfeats)
    return imgs, feats, jfeats, pm, jpm


def test_pairwise_matches_equal_opencv_tpu(pair):
    _, feats, _, pm, jpm = pair
    assert [f.img_size for f in feats] == [(200, 200), (220, 200)]
    assert len(pm) == len(jpm) == 4
    for a, b in zip(pm, jpm):
        assert (a.src_img_idx, a.dst_img_idx) == (b.src_img_idx, b.dst_img_idx)
        assert [(m.queryIdx, m.trainIdx, m.distance) for m in a.matches] == \
            [(m.queryIdx, m.trainIdx, m.distance) for m in b.matches]
        assert a.inliers_mask == b.inliers_mask and a.num_inliers == b.num_inliers
        assert a.confidence == b.confidence
        assert (a.H is None) == (b.H is None)
        if a.H is not None:
            np.testing.assert_array_equal(a.H, b.H)
    assert pm[1].num_inliers > 50


def test_estimators_equal_opencv_tpu(pair):
    _, feats, jfeats, pm, jpm = pair
    assert td.focalsFromHomography(pm[1].H) == jd.focalsFromHomography(jpm[1].H)
    assert td.estimateFocal(feats, pm) == jd.estimateFocal(jfeats, jpm)
    ok, cams = td.HomographyBasedEstimator().apply(feats, pm)
    jok, jcams = jd.HomographyBasedEstimator().apply(jfeats, jpm)
    assert ok and jok
    for c, jc in zip(cams, jcams):
        assert c.focal == jc.focal
        np.testing.assert_array_equal(c.R, jc.R)
        np.testing.assert_array_equal(c.K(), jc.K())
    rm = td.waveCorrect([c.R for c in cams], td.WAVE_CORRECT_HORIZ)
    for a, b in zip(rm, jd.waveCorrect([c.R for c in jcams], jd.WAVE_CORRECT_HORIZ)):
        np.testing.assert_array_equal(a, b)
    for name in ("BundleAdjusterRay", "BundleAdjusterReproj"):
        out = []
        for mod, f, p in ((td, feats, pm), (jd, jfeats, jpm)):
            ba = getattr(mod, name)()
            ba.setConfThresh(0.5)
            _, cs = mod.HomographyBasedEstimator().apply(f, p)
            ok, cs = ba.apply(f, p, cs)
            assert ok
            out.append(cs)
        for c, jc in zip(*out):
            assert c.focal == pytest.approx(jc.focal, rel=1e-6)
            np.testing.assert_allclose(c.R, jc.R, rtol=0, atol=1e-6)


def _overlap_inputs(seed):
    rng = np.random.default_rng(seed)
    base = cv2.GaussianBlur(rng.integers(0, 256, (70, 130, 3), np.uint8), (5, 5), 2)
    a = base[:, :90].copy()
    b = np.clip(base[:, 40:].astype(int) * 1.3 + 5, 0, 255).astype(np.uint8)
    corners = [(0, 0), (40, 0)]
    masks = [np.full(a.shape[:2], 255, np.uint8), np.full(b.shape[:2], 255, np.uint8)]
    masks[1][:8] = 0
    return [a, b], corners, masks


@pytest.mark.parametrize("name,args", [("GainCompensator", ()), ("ChannelsCompensator", ()),
                                       ("BlocksGainCompensator", (16, 16))])
def test_compensators_equal_opencv_tpu(name, args):
    imgs, corners, masks = _overlap_inputs(2)
    tc, jc = getattr(td, name)(*args), getattr(jd, name)(*args)
    tc.feed(corners, [torch.from_numpy(i) for i in imgs], masks)
    jc.feed(corners, imgs, masks)
    if name != "BlocksGainCompensator":
        np.testing.assert_allclose(np.asarray(tc.gains(), np.float64),
                                   np.asarray(jc.gains(), np.float64), rtol=1e-12)
    for i, img in enumerate(imgs):
        got = tc.apply(i, corners[i], torch.from_numpy(img), masks[i])
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), jc.apply(i, corners[i], img, masks[i]))
    assert getattr(tcv, f"detail_{name}") is getattr(td, name)


@pytest.mark.parametrize("finder", ["Voronoi", "GraphCut COLOR", "GraphCut COLOR_GRAD", "Dp"])
def test_seam_finders_equal_opencv_tpu(finder):
    imgs, corners, masks = _overlap_inputs(3)
    kind, _, cost = finder.partition(" ")
    out = []
    for mod in (td, jd):
        if kind == "Voronoi":
            f = mod.VoronoiSeamFinder()
            out.append(f.find([(i.shape[1], i.shape[0]) for i in imgs], corners, masks))
        elif kind == "GraphCut":
            out.append(mod.GraphCutSeamFinder("COST_" + cost).find(imgs, corners, masks))
        else:
            out.append(mod.DpSeamFinder("COLOR").find(imgs, corners, masks))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    # the overlap (columns 40-89 of the canvas) goes to one image a pixel,
    # and no pixel is lost
    a, b = (m > 0 for m in out[0])
    assert not (a[:, 40:] & b[:, :50]).any()
    assert (a[:, 40:] | b[:, :50]).sum() == ((masks[0][:, 40:] > 0) | (masks[1][:, :50] > 0)).sum()


def test_stitcher_reference_scene():
    """tests/test_misc_modules.py::test_stitcher's checks on the port."""
    rng = np.random.default_rng(4)
    scene = cv2.GaussianBlur(rng.integers(0, 256, (200, 300, 3), np.uint8), (3, 3), 1)
    st = tcv.Stitcher.create()
    status, pano = st.stitch([scene[:, :200], scene[:, 80:]])
    assert status == tcv.Stitcher.OK and pano.dtype == torch.uint8
    pano = pano.numpy()
    assert pano.shape[1] >= 290
    d = np.abs(pano[50:150, 50:150].astype(int) - scene[50:150, 50:150].astype(int))
    assert np.median(d) <= 2
    assert len(st.homographies) == 1
    np.testing.assert_allclose(st.homographies[0][:2, 2], (80, 0), atol=2)
    assert tcv.Stitcher_create().stitch([scene])[0] == tcv.Stitcher.ERR_NEED_MORE_IMGS
