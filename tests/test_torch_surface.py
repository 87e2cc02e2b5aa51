"""The port's EMD, Subdiv2D, IntelligentScissorsMB and colour correction
model on the CPU, against opencv_tpu (exactly) and cv2 (under the
reference tests' bounds: tests/test_misc_ops.py, test_surface_classes.py,
test_hough_seg.py); and the top-level names that ``opencv_tpu/__init__.py``
defines itself (CV_MAKETYPE and the CV_*C makers, RotatedRect, TickMeter,
Algorithm, MSTEdge, Feature2D, FontFace, GeneralizedHough,
DescriptorMatcher, BFMatcher_create) against opencv_tpu's, exactly."""

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu_torch.ops import ccm as C


@pytest.mark.parametrize("seed", range(5))
def test_emd_equals_opencv_tpu_and_matches_cv2(seed):
    rng = np.random.default_rng(seed)
    s1 = np.hstack([rng.random((4 + seed, 1)) + 0.2,
                    rng.random((4 + seed, 3)) * 10]).astype(np.float32)
    s2 = np.hstack([rng.random((6, 1)) + 0.2, rng.random((6, 3)) * 10]).astype(np.float32)
    for dt in (cv2.DIST_L1, cv2.DIST_L2, cv2.DIST_C):
        o, lb, fo = tcv.EMD(torch.from_numpy(s1), s2, dt)
        j, jlb, fj = jcv.EMD(s1, s2, dt)
        assert o == j and lb == jlb
        np.testing.assert_array_equal(fo, fj)
        r, _, fl = cv2.EMD(s1, s2, dt)
        assert abs(r - o) < 1e-5, (seed, dt, r, o)
        np.testing.assert_allclose(fo.sum(1), fl.sum(1), atol=1e-4)
        np.testing.assert_allclose(fo.sum(0), fl.sum(0), atol=1e-4)
    cost = rng.random((len(s1), len(s2))).astype(np.float32)
    got = tcv.EMD(s1, s2, cv2.DIST_USER, torch.from_numpy(cost))
    assert got[0] == jcv.EMD(s1, s2, cv2.DIST_USER, cost)[0]


def _subdivs(pts, rect=(0, 0, 100, 100)):
    ours, ref = tcv.Subdiv2D(rect), jcv.Subdiv2D(rect)
    ours.insert(torch.from_numpy(pts))
    ref.insert(pts)
    return ours, ref


def test_subdiv2d_equals_opencv_tpu():
    """Every query of the triangulation, with the points given as a tensor
    to the port, equals opencv_tpu's exactly."""
    rng = np.random.default_rng(1)
    pts = rng.uniform(10, 90, (15, 2)).astype(np.float32)
    ours, ref = _subdivs(pts)
    for name in ("getTriangleList", "getEdgeList", "getLeadingEdgeList"):
        got, want = getattr(ours, name)(), getattr(ref, name)()
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    for q in ((50, 50), (pts[3][0], pts[3][1]), (5, 95), (150, 3), torch.tensor([33.0, 61.0])):
        assert ours.locate(q) == ref.locate(np.asarray(q)), q
        assert ours.findNearest(q) == ref.findNearest(np.asarray(q)), q
    for v in (3, 4, 10, 18, 19, 40):
        assert ours.getVertex(v) == ref.getVertex(v)
    for idx in ([], [4, 7, 11]):
        (gf, gc), (wf, wc) = ours.getVoronoiFacetList(idx), ref.getVoronoiFacetList(idx)
        assert len(gf) == len(wf) and all(np.array_equal(a, b) for a, b in zip(gf, wf))
        np.testing.assert_array_equal(gc, wc)
    assert ours.insert((20.5, 30.25)) == ref.insert((20.5, 30.25))
    with pytest.raises(ValueError):
        ours.insert((120.0, 3.0))
    assert tcv.Subdiv2D.PTLOC_VERTEX == jcv.Subdiv2D.PTLOC_VERTEX == 1


def test_subdiv2d_delaunay_matches_cv2():
    rng = np.random.default_rng(0)
    pts = rng.uniform(10, 90, (12, 2)).astype(np.float32)
    ours = tcv.Subdiv2D((0, 0, 100, 100))
    ref = cv2.Subdiv2D((0, 0, 100, 100))
    for p in pts:
        ours.insert((float(p[0]), float(p[1])))
        ref.insert((float(p[0]), float(p[1])))

    def norm(tl):
        keep = []
        for t in np.asarray(tl).reshape(-1, 6):
            xs, ys = t[0::2], t[1::2]
            if (xs >= 0).all() and (xs <= 100).all() and (ys >= 0).all() and (ys <= 100).all():
                keep.append(tuple(sorted(zip(np.round(xs, 3), np.round(ys, 3)))))
        return sorted(keep)

    assert norm(ours.getTriangleList()) == norm(ref.getTriangleList())
    assert ours.findNearest((50, 50))[0] == ref.findNearest((50, 50))[0]
    f, c = ours.getVoronoiFacetList([])
    assert len(f) == 12 and c.shape == (12, 2)


def test_hypot_of_f32_sobel_pairs():
    """numpy's f32 hypot of every signed pair of 3×3 Sobel values (|v| <=
    1020: 4.2 M pairs) is the correctly rounded root (what the card's f64
    sqrt rounded to f32 gives), and the port's table gives it for each."""
    from opencv_tpu_torch.ops.scissors import _hypot
    v = np.arange(-1020, 1021, dtype=np.float32)
    a, b = np.meshgrid(v, v, indexing="ij")
    want = np.hypot(a, b)
    root = np.sqrt(a.astype(np.float64) ** 2 + b.astype(np.float64) ** 2).astype(np.float32)
    assert want.dtype == np.float32 and a.size == 2041 ** 2
    np.testing.assert_array_equal(root, want)
    got = _hypot(torch.from_numpy(a), torch.from_numpy(b), True)
    np.testing.assert_array_equal(got.numpy(), want)
    f = np.random.default_rng(0).normal(0, 50, (2, 30, 40)).astype(np.float32)
    np.testing.assert_array_equal(_hypot(*torch.from_numpy(f), False).numpy(), np.hypot(*f))


def _wave():
    rng = np.random.default_rng(0)
    img = np.zeros((60, 80), np.uint8)
    for y in range(60):
        img[y, int(35 + 10 * np.sin(y / 8)):] = 180
    return (img.astype(int) + rng.integers(0, 12, img.shape)).astype(np.uint8)


def _configure(s, mode):
    if mode == "canny":
        s.setEdgeFeatureCannyParameters(50, 100)
    elif mode == "zero crossing, min magnitude":
        s.setEdgeFeatureZeroCrossingParameters(20.0)
    elif mode == "magnitude limit, weights":
        s.setGradientMagnitudeMaxLimit(150.3).setWeights(0.3, 0.5, 0.2)
    return s


@pytest.mark.parametrize("mode", ["zero crossing", "canny", "zero crossing, min magnitude",
                                  "magnitude limit, weights"])
@pytest.mark.parametrize("colour", [False, True], ids=["gray", "bgr"])
def test_intelligent_scissors_equals_opencv_tpu(mode, colour):
    """The features, the paths map and the contours equal opencv_tpu's."""
    img = _wave()
    if colour:
        img = np.stack([img, img // 2, 255 - img], -1)
    res = []
    for m, src in ((jcv, img), (tcv, torch.from_numpy(img))):
        s = _configure(m.segmentation.IntelligentScissorsMB(), mode)
        s.applyImage(src)
        s.buildMap((38, 5))
        res.append([s._non_edge, s._grad_dir, s._grad_mag, s._paths, s.getContour((40, 55)),
                    s.getContour((70, 30), backward=True)])
    for name, g, w in zip(("non_edge", "grad_dir", "grad_mag", "paths", "contour", "backward"),
                          *res):
        assert g.dtype == w.dtype and np.array_equal(g, w), name


def test_intelligent_scissors_matches_cv2():
    img = _wave()
    for mode in ("zero crossing", "canny"):
        ours = _configure(tcv.segmentation_IntelligentScissorsMB(), mode)
        ref = _configure(cv2.segmentation.IntelligentScissorsMB(), mode)
        for s in (ours, ref):
            s.applyImage(img)
            s.buildMap((38, 5))
        np.testing.assert_array_equal(ours.getContour((40, 55)).reshape(-1, 2),
                                      np.asarray(ref.getContour((40, 55))).reshape(-1, 2))
    img2 = np.zeros((40, 50), np.uint8)
    img2[:, 25:] = 200
    ours = tcv.segmentation.IntelligentScissorsMB()
    ref = cv2.segmentation.IntelligentScissorsMB()
    for s in (ours, ref):
        s.setEdgeFeatureCannyParameters(50, 100)
        s.applyImage(img2)
        s.buildMap((25, 5))
    np.testing.assert_array_equal(ours.getContour((25, 35)).reshape(-1, 2),
                                  np.asarray(ref.getContour((25, 35))).reshape(-1, 2))


def test_intelligent_scissors_apply_image_features():
    rng = np.random.default_rng(2)
    ne = (rng.random((30, 40)) < 0.8).astype(np.uint8)
    gd = rng.normal(size=(30, 40, 2)).astype(np.float32)
    gm = rng.random((30, 40)).astype(np.float32)
    res = []
    for m, conv in ((jcv, np.asarray), (tcv, torch.from_numpy)):
        s = m.segmentation.IntelligentScissorsMB()
        s.applyImageFeatures(conv(ne), conv(gd), conv(gm))
        s.buildMap(torch.tensor([3, 4]) if m is tcv else (3, 4))
        res.append((s._paths, s.getContour((35, 25))))
    for g, w in zip(*res):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(RuntimeError):
        tcv.segmentation.IntelligentScissorsMB().buildMap((0, 0))


def _cast_patches():
    ref_lin = np.clip(C._lab_d50_to_linear_rgb(C._MACBETH_LAB), 0, 1)
    M = np.array([[0.9, 0.1, 0.0], [0.05, 0.85, 0.05], [0.0, 0.1, 0.95]])
    return (np.clip(ref_lin @ np.linalg.inv(M), 0, 1) ** (1 / 2.2)).reshape(-1, 1, 3)


@pytest.mark.parametrize("ccm_type", [tcv.ccm.CCM_LINEAR, tcv.ccm.CCM_AFFINE])
def test_color_correction_model_equals_opencv_tpu(ccm_type):
    """The fit and every getter equal opencv_tpu's bit for bit; correctImage
    on u8 is exact, on floats within 1e-15 (torch's pow against numpy's)."""
    src = _cast_patches()
    ours = tcv.ccm_ColorCorrectionModel(torch.from_numpy(src), 0).setCcmType(ccm_type)
    ref = jcv.ccm_ColorCorrectionModel(src, 0).setCcmType(ccm_type)
    ours.setWeightsList(np.linspace(1, 2, 24))
    ref.setWeightsList(np.linspace(1, 2, 24))
    ours.compute()
    ref.compute()
    for name in ("getCCM", "getLoss", "getMask", "getWeights", "getSrcLinearRGB",
                 "getRefLinearRGB"):
        np.testing.assert_array_equal(getattr(ours, name)(), getattr(ref, name)(), err_msg=name)
    rng = np.random.default_rng(4)
    u8 = rng.integers(0, 256, (3, 64, 80, 3), np.uint8)
    got = ours.correctImage(torch.from_numpy(u8))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref.correctImage(u8))
    f = rng.random((40, 50, 3)) * 1.2 - 0.1
    np.testing.assert_allclose(ours.correctImage(f).numpy(), ref.correctImage(f), rtol=0,
                               atol=1e-15)


def test_color_correction_model_matches_cv2():
    src = _cast_patches()
    ours = tcv.ccm_ColorCorrectionModel(src, 0)
    ours.compute()
    ref = cv2.ccm.ColorCorrectionModel(src.astype(np.float64), cv2.ccm.COLORCHECKER_MACBETH)
    ref.compute()
    assert np.allclose(ours.getColorCorrectionMatrix(), np.asarray(ref.getColorCorrectionMatrix()),
                       atol=5e-3)
    assert abs(ours.getLoss() - ref.getLoss()) < 0.1
    sat = tcv.ccm_ColorCorrectionModel(src, 0).setSaturatedThreshold(0.02, 0.98)
    want = jcv.ccm_ColorCorrectionModel(src, 0).setSaturatedThreshold(0.02, 0.98)
    np.testing.assert_array_equal(sat.getMask(), want.getMask())
    assert sat.getLoss() == want.getLoss()


# ---------------------------------------------------------------------------
# the top-level names of opencv_tpu/__init__.py

C1_NAMES = ("DescriptorMatcher", "Algorithm", "TickMeter", "RotatedRect", "MSTEdge",
            "GeneralizedHough", "Feature2D", "FontFace", "CV_MAKETYPE", "CV_MAKE_TYPE",
            "CV_8UC", "CV_8SC", "CV_16UC", "CV_16SC", "CV_32SC", "CV_32FC", "CV_64FC",
            "CV_16FC", "CV_16BFC", "CV_BoolC", "CV_64UC", "CV_64SC", "CV_32UC",
            "BFMatcher_create", "getTickCount", "getTickFrequency")


@pytest.mark.parametrize("name", C1_NAMES)
def test_top_level_name_is_exported(name):
    assert hasattr(tcv, name), name
    assert type(getattr(tcv, name)) is type(getattr(jcv, name)), name


# the names of features2d's slice 17: the classes and factories, and the
# enum aliases, whose values equal the JAX package's
SLICE17_NAMES = ("AGAST", "AgastFeatureDetector", "AgastFeatureDetector_create", "BRISK",
                 "BRISK_create", "AKAZE", "AKAZE_create", "KAZE", "KAZE_create", "MSER",
                 "MSER_create", "SimpleBlobDetector", "SimpleBlobDetector_create",
                 "SimpleBlobDetector_Params")
SLICE17_VALUES = ("AKAZE_DESCRIPTOR_KAZE_UPRIGHT", "AKAZE_DESCRIPTOR_KAZE",
                  "AKAZE_DESCRIPTOR_MLDB_UPRIGHT", "AKAZE_DESCRIPTOR_MLDB", "KAZE_DIFF_PM_G1",
                  "KAZE_DIFF_PM_G2", "KAZE_DIFF_WEICKERT", "KAZE_DIFF_CHARBONNIER")


@pytest.mark.parametrize("name", SLICE17_NAMES)
def test_slice17_name_is_exported(name):
    assert type(getattr(tcv, name)) is type(getattr(jcv, name)), name
    assert getattr(tcv.features2d, name) is getattr(tcv, name)
    assert getattr(tcv, name).__name__ == getattr(jcv, name).__name__


@pytest.mark.parametrize("name", SLICE17_VALUES)
def test_slice17_value_equals_opencv_tpu(name):
    assert getattr(tcv, name) == getattr(jcv, name)
    assert getattr(tcv.features2d, name) == getattr(jcv, name)


MAKERS = ("CV_8UC", "CV_8SC", "CV_16UC", "CV_16SC", "CV_32SC", "CV_32FC", "CV_64FC",
          "CV_16FC", "CV_16BFC", "CV_BoolC", "CV_64UC", "CV_64SC", "CV_32UC")


@pytest.mark.parametrize("maker", MAKERS)
def test_cv_type_makers_equal_opencv_tpu(maker):
    for cn in (1, 2, 3, 4, 8, 128):
        assert getattr(tcv, maker)(cn) == getattr(jcv, maker)(cn)
    assert tcv.CV_8UC(3) == tcv.CV_8UC3 == cv2.CV_8UC3
    assert tcv.CV_32FC(2) == cv2.CV_32FC2


def test_cv_maketype_equals_opencv_tpu_and_cv2():
    for depth in range(13):
        for cn in (1, 2, 3, 4, 16):
            want = jcv.CV_MAKETYPE(depth, cn)
            assert tcv.CV_MAKETYPE(depth, cn) == tcv.CV_MAKE_TYPE(depth, cn) == want
    assert tcv.CV_MAKETYPE(tcv.CV_16S, 2) == jcv.CV_MAKETYPE(jcv.CV_16S, 2) == cv2.CV_16SC2
    assert tcv.CV_MAKE_TYPE is tcv.CV_MAKETYPE


def test_rotated_rect_equals_opencv_tpu():
    for args in (((50.5, 40.0), (30.0, 12.0), 30.0), ((0.0, 0.0), (4.0, 4.0), -45.0),
                 ((10.0, 20.0), (7.5, 3.25), 90.0), ((100, 80), (0, 5), 12.5)):
        ours, ref = tcv.RotatedRect(*args), jcv.RotatedRect(*args)
        assert (ours.center, ours.size, ours.angle) == (ref.center, ref.size, ref.angle)
        np.testing.assert_array_equal(ours.points(), ref.points())
        assert ours.points().dtype == np.float32
        assert ours.boundingRect() == ref.boundingRect()
    r = tcv.RotatedRect((50, 40), (30, 12), 30)
    np.testing.assert_allclose(r.points(), cv2.boxPoints(((50, 40), (30, 12), 30)), atol=1e-4)
    rect = tcv.minAreaRect(np.array([[1, 1], [9, 3], [7, 11], [0, 8]], np.int32))
    np.testing.assert_array_equal(tcv.RotatedRect(*rect).points(), tcv.boxPoints(rect))
    assert tcv.RotatedRect().points().shape == (4, 2)


def test_tick_meter_equals_opencv_tpu():
    ours, ref = tcv.TickMeter(), jcv.TickMeter()
    assert tcv.getTickFrequency() == jcv.getTickFrequency() == 1e9
    for m in (ours, ref):
        assert (m.getCounter(), m.getTimeTicks(), m.getFPS(), m.getAvgTimeSec()) == (0, 0, 0.0,
                                                                                      0.0)
        for _ in range(3):
            m.start()
            sum(range(1000))
            m.stop()
        m.stop()                       # a stop without a start counts nothing
    assert ours.getCounter() == ref.getCounter() == 3
    t = ours.getTimeTicks()
    assert t > 0 and ours.getTimeSec() == t / 1e9
    assert ours.getTimeMilli() == ours.getTimeSec() * 1e3
    assert ours.getTimeMicro() == ours.getTimeSec() * 1e6
    assert ours.getAvgTimeSec() == ours.getTimeSec() / 3
    assert ours.getAvgTimeMilli() == ours.getAvgTimeSec() * 1e3
    assert ours.getFPS() == 3 / ours.getTimeSec()
    ours.reset()
    assert (ours.getCounter(), ours.getTimeTicks()) == (0, 0)
    a = tcv.getTickCount()
    assert isinstance(a, int) and tcv.getTickCount() >= a


def test_algorithm_mstedge_feature2d_equal_opencv_tpu():
    for cls in (tcv.Algorithm, jcv.Algorithm):
        a = cls()
        assert (a.clear(), a.empty(), a.save("x"), a.getDefaultName()) == (None, False, None,
                                                                          "Algorithm")
    e, r = tcv.MSTEdge(2, 5, 1.5), jcv.MSTEdge(2, 5, 1.5)
    assert (e.source, e.target, e.weight) == (r.source, r.target, r.weight) == (2, 5, 1.5)
    assert vars(tcv.MSTEdge()) == vars(jcv.MSTEdge())
    f, g = tcv.Feature2D(), jcv.Feature2D()
    assert tcv.Feature2D.__name__ == "Feature2D"
    for name in ("detect", "compute", "detectAndCompute"):
        assert getattr(f, name)(np.zeros((4, 4), np.uint8)) == getattr(g, name)(
            np.zeros((4, 4), np.uint8))
    assert f.empty() is g.empty() is True


def test_font_face_equals_opencv_tpu():
    """FontFace is the reference's named handle: putText draws with the
    Hershey engine whatever the face, so the raster of a FontFace's text is
    putText's, equal between the packages."""
    ours, ref = tcv.FontFace("sans"), jcv.FontFace("sans")
    assert ours.getName() == ref.getName() == "sans"
    assert tcv.FontFace().getName() == jcv.FontFace().getName()
    assert ours.setInstance({}) is ref.setInstance({}) is False
    assert ours.getInstance() is ref.getInstance() is None
    img = np.zeros((60, 240, 3), np.uint8)
    got = tcv.putText(torch.from_numpy(img.copy()), "FontFace 16", (5, 40),
                      tcv.FONT_HERSHEY_SIMPLEX, 1.0, (0, 255, 0), 2)
    want = jcv.putText(img.copy(), "FontFace 16", (5, 40), jcv.FONT_HERSHEY_SIMPLEX, 1.0,
                       (0, 255, 0), 2)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.asarray(got).any()


def test_generalized_hough_equals_opencv_tpu():
    """GeneralizedHough is the Ballard transform under its base name."""
    assert issubclass(tcv.GeneralizedHough, tcv.GeneralizedHoughBallard)
    tmpl = np.zeros((40, 40), np.uint8)
    cv2.rectangle(tmpl, (8, 10), (30, 28), 255, 2)
    img = np.zeros((120, 160), np.uint8)
    img[50:90, 70:110] = tmpl
    ours, ref = tcv.GeneralizedHough(), jcv.GeneralizedHough()
    for g in (ours, ref):
        g.setMinDist(10)
        g.setLevels(180)
        g.setVotesThreshold(20)
        g.setTemplate(tmpl)
    got, want = ours.detect(torch.from_numpy(img)), ref.detect(img)
    assert want[0] is not None and got[0] is not None
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))


def test_descriptor_matcher_and_bfmatcher_create_equal_opencv_tpu():
    assert tcv.DescriptorMatcher is tcv.BFMatcher
    rng = np.random.default_rng(9)
    q = rng.integers(0, 256, (20, 32), np.uint8)
    t = rng.integers(0, 256, (30, 32), np.uint8)
    for args in ((), (tcv.NORM_HAMMING, True), (tcv.NORM_L1, False)):
        ours, ref = tcv.BFMatcher_create(*args), jcv.BFMatcher_create(*args)
        assert type(ours) is tcv.BFMatcher
        assert (ours.norm_type, ours.cross_check) == (ref.norm_type, ref.cross_check)
        got = [(m.queryIdx, m.trainIdx, m.distance) for m in ours.match(q, t)]
        want = [(m.queryIdx, m.trainIdx, m.distance) for m in ref.match(q, t)]
        assert got == want
    d = tcv.DescriptorMatcher(tcv.NORM_HAMMING)
    assert [m.trainIdx for m in d.match(torch.from_numpy(q), t)] == \
        [m.trainIdx for m in jcv.DescriptorMatcher(jcv.NORM_HAMMING).match(q, t)]


# the names of the video module (but the DNN trackers) and of features2d's
# bow, affine_feature and evaluation, with the binding's base-class
# aliases, whose types and names equal the JAX package's; the MOTION_*
# values equal its values
VIDEO_F2D_NAMES = ("BackgroundSubtractorMOG2", "createBackgroundSubtractorMOG2",
                 "BackgroundSubtractorKNN", "createBackgroundSubtractorKNN",
                 "calcOpticalFlowPyrLK", "SparsePyrLKOpticalFlow",
                 "SparsePyrLKOpticalFlow_create", "buildOpticalFlowPyramid", "readOpticalFlow",
                 "writeOpticalFlow", "calcOpticalFlowFarneback", "FarnebackOpticalFlow_create",
                 "KalmanFilter", "meanShift", "CamShift", "findTransformECC", "computeECC",
                 "findTransformECCWithMask", "findTransformECCMultiScale", "DISOpticalFlow",
                 "DISOpticalFlow_create", "TrackerMIL", "TrackerMIL_create",
                 "VariationalRefinement", "VariationalRefinement_create",
                 "BOWKMeansTrainer", "BOWImgDescriptorExtractor", "AffineFeature",
                 "AffineFeature_create", "evaluateFeatureDetector", "computeRecallPrecisionCurve",
                 "getRecall", "getNearestPoint")
VIDEO_ALIASES = {"BackgroundSubtractor": "BackgroundSubtractorMOG2",
                   "SparseOpticalFlow": "SparsePyrLKOpticalFlow",
                   "DenseOpticalFlow": "DISOpticalFlow"}
MOTION_VALUES = ("MOTION_TRANSLATION", "MOTION_EUCLIDEAN", "MOTION_AFFINE", "MOTION_HOMOGRAPHY")
F2D_NAMES = VIDEO_F2D_NAMES[-8:]


@pytest.mark.parametrize("name", VIDEO_F2D_NAMES)
def test_video_and_features2d_name_is_exported(name):
    assert type(getattr(tcv, name)) is type(getattr(jcv, name)), name
    assert getattr(tcv, name).__name__ == getattr(jcv, name).__name__
    sub = tcv.features2d if name in F2D_NAMES else tcv.video
    assert getattr(sub, name) is getattr(tcv, name)


@pytest.mark.parametrize("alias", sorted(VIDEO_ALIASES))
def test_video_alias_equals_opencv_tpu(alias):
    assert getattr(tcv, alias) is getattr(tcv, VIDEO_ALIASES[alias])
    assert getattr(tcv, alias).__name__ == getattr(jcv, alias).__name__


@pytest.mark.parametrize("name", MOTION_VALUES)
def test_motion_value_equals_opencv_tpu(name):
    assert getattr(tcv, name) == getattr(jcv, name) == getattr(tcv.video, name)
    assert getattr(tcv, name) == getattr(cv2, name)


def test_video_leaves_nothing_out():
    import opencv_tpu.video as jvideo
    left = sorted(n for n in dir(jvideo) if not n.startswith("_") and not hasattr(tcv.video, n)
                  and not n.islower())
    assert left == []


# the photo module's top-level names (classes, factories, functions), with
# the binding's HDR base-class aliases, and its flags, whose values equal
# the JAX package's and cv2's; utils.system's top-level names
PHOTO_VALUES = ("INPAINT_NS", "INPAINT_TELEA", "RECURS_FILTER", "NORMCONV_FILTER",
                "NORMAL_CLONE", "MIXED_CLONE", "MONOCHROME_TRANSFER")
PHOTO_NAMES = ("fastNlMeansDenoising", "fastNlMeansDenoisingColored",
               "fastNlMeansDenoisingMulti", "fastNlMeansDenoisingColoredMulti", "denoise_TVL1",
               "inpaint", "createMergeMertens", "MergeMertens", "createMergeDebevec",
               "MergeDebevec", "createCalibrateDebevec", "CalibrateDebevec", "createTonemap",
               "Tonemap", "createTonemapDrago", "TonemapDrago", "createTonemapReinhard",
               "TonemapReinhard", "createAlignMTB", "AlignMTB", "createMergeRobertson",
               "MergeRobertson", "createCalibrateRobertson", "CalibrateRobertson",
               "createTonemapMantiuk", "TonemapMantiuk", "edgePreservingFilter", "detailEnhance",
               "stylization", "pencilSketch", "seamlessClone", "colorChange",
               "illuminationChange", "textureFlattening", "decolor")
PHOTO_ALIASES = {"AlignExposures": "AlignMTB", "MergeExposures": "MergeMertens",
                 "CalibrateCRF": "CalibrateDebevec"}
SYSTEM_NAMES = ("getCPUTickCount", "getNumThreads", "setNumThreads", "getThreadNum",
                "getNumberOfCPUs", "useOptimized", "setUseOptimized", "checkHardwareSupport",
                "getHardwareFeatureName", "getCPUFeaturesLine", "getVersionMajor",
                "getVersionMinor", "getVersionRevision", "getVersionString",
                "getBuildInformation", "redirectError", "getDefaultAlgorithmHint", "bootstrap",
                "VideoCapture_waitAny")


@pytest.mark.parametrize("name", PHOTO_NAMES)
def test_photo_name_is_exported(name):
    assert type(getattr(tcv, name)) is type(getattr(jcv, name)), name
    assert getattr(tcv, name).__name__ == getattr(jcv, name).__name__
    assert getattr(tcv.photo, name) is getattr(tcv, name)


@pytest.mark.parametrize("name", PHOTO_VALUES)
def test_photo_value_equals_opencv_tpu(name):
    assert getattr(tcv, name) == getattr(jcv, name) == getattr(tcv.photo, name)
    assert getattr(tcv, name) == getattr(cv2, name)


@pytest.mark.parametrize("alias", sorted(PHOTO_ALIASES))
def test_photo_alias_equals_opencv_tpu(alias):
    assert getattr(tcv, alias) is getattr(tcv, PHOTO_ALIASES[alias])
    assert getattr(tcv, alias).__name__ == getattr(jcv, alias).__name__


@pytest.mark.parametrize("name", SYSTEM_NAMES)
def test_system_name_is_exported(name):
    import opencv_tpu_torch.utils.system as tsystem
    assert type(getattr(tcv, name)) is type(getattr(jcv, name)), name
    assert getattr(tcv, name) is getattr(tsystem, name)


def test_photo_and_utils_leave_nothing_out():
    import opencv_tpu.photo as jphoto
    import opencv_tpu.utils as jutils
    import opencv_tpu.utils.system as jsystem
    import opencv_tpu_torch.utils.system as tsystem
    for jmod, tmod in ((jphoto, tcv.photo), (jutils, tcv.utils), (jsystem, tsystem)):
        left = sorted(n for n in dir(jmod) if not n.startswith("_") and not hasattr(tmod, n)
                      and n not in ("jnp", "jax", "annotations"))
        assert left == [], (jmod.__name__, left)
    assert len(PHOTO_NAMES) + len(PHOTO_VALUES) == 42 and len(SYSTEM_NAMES) == 19


# calib3d's top-level names: those opencv_tpu/__init__.py imports from its
# calib3d (the functions, classes and flags, the fisheye module), with the
# binding's StereoMatcher alias and CirclesGridFinderParameters
CALIB3D_MODULES = ("calibrate", "chessboard", "circlesgrid", "extended", "fisheye", "geometry",
                   "handeye", "misc3d", "multiview", "pnp", "stereo", "usac")


def _calib3d_top_level_names():
    import importlib
    names = set()
    for m in CALIB3D_MODULES:
        mod = importlib.import_module(f"opencv_tpu.calib3d.{m}")
        names |= {n for n in dir(mod) if not n.startswith("_") and hasattr(jcv, n)
                  and getattr(jcv, n) is getattr(mod, n)}
    return sorted(names | {"fisheye", "StereoMatcher", "CirclesGridFinderParameters"})


CALIB3D_NAMES = _calib3d_top_level_names()


@pytest.mark.parametrize("name", CALIB3D_NAMES)
def test_calib3d_name_is_exported(name):
    got, want = getattr(tcv, name), getattr(jcv, name)
    assert type(got) is type(want), name
    if isinstance(want, (int, float)):
        assert got == want
        if hasattr(cv2, name):
            assert got == getattr(cv2, name)
    elif name == "fisheye":
        assert got is tcv.calib3d.fisheye
    else:
        assert got.__name__ == want.__name__
        assert getattr(tcv.calib3d, name, got) is got


def test_calib3d_leaves_nothing_out():
    import importlib
    for m in CALIB3D_MODULES:
        jmod = importlib.import_module(f"opencv_tpu.calib3d.{m}")
        tmod = importlib.import_module(f"opencv_tpu_torch.calib3d.{m}")
        left = sorted(n for n in dir(jmod) if not n.startswith("_") and not hasattr(tmod, n)
                      and n not in ("jax", "jnp", "np", "annotations", "functools", "to_batched"))
        assert left == [], (m, left)
    assert tcv.StereoMatcher is tcv.StereoBM
    assert len(CALIB3D_NAMES) == 143


# ---------------------------------------------------------------------------
# the second set of top-level names of opencv_tpu/__init__.py (video, core,
# FLANN), each held to the JAX package's

C2_NAMES = ("ECCParameters", "Tracker", "FarnebackOpticalFlow", "TrackerMIL_Params", "AsyncArray",
            "ANNIndex", "ANNIndex_create")


@pytest.mark.parametrize("name", C2_NAMES)
def test_c2_name_is_exported(name):
    got, want = getattr(tcv, name), getattr(jcv, name)
    assert type(got) is type(want), name
    assert got.__name__ == want.__name__
    assert getattr(got, "__doc__", None) == getattr(want, "__doc__", None)


def test_ecc_and_tracker_mil_params_equal_opencv_tpu():
    for args in ((), (0, 2, 20, 1e-4, 3)):
        assert vars(tcv.ECCParameters(*args)) == vars(jcv.ECCParameters(*args))
    assert vars(tcv.TrackerMIL_Params()) == vars(jcv.TrackerMIL_Params())


def test_tracker_and_async_array_equal_opencv_tpu():
    ours, ref = tcv.Tracker(), jcv.Tracker()
    assert ours.init(np.zeros((4, 4), np.uint8), (0, 0, 2, 2)) == ref.init(None, None)
    assert ours.update(np.zeros((4, 4), np.uint8)) == ref.update(None) == (False, (0, 0, 0, 0))
    value = np.arange(6.0)
    for cls in (tcv.AsyncArray, jcv.AsyncArray):
        a = cls(value)
        assert a.get() is value and a.get(10) is value and a.wait_for(0) and a.valid()
        a.release()
        assert a.get() is None and not a.valid()
        assert not cls().valid()


def test_farneback_optical_flow_calc_equals_opencv_tpu():
    """calc is calcOpticalFlowFarneback with the reference's fixed
    parameters (the same constants), on the port's function."""
    consts = tcv.FarnebackOpticalFlow.calc.__code__.co_consts
    assert consts == jcv.FarnebackOpticalFlow.calc.__code__.co_consts
    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, (52, 68), np.uint8)
    prev, nxt = base[2:50, 2:66], base[1:49, 3:67]
    got = tcv.FarnebackOpticalFlow.calc(prev, nxt)
    want = tcv.calcOpticalFlowFarneback(prev, nxt, None, 0.5, 3, 15, 3, 5, 1.2, 0)
    assert got.shape == (48, 64, 2) and torch.equal(got, want)


@pytest.mark.parametrize("dist", range(5))
def test_ann_index_equals_opencv_tpu(dist, tmp_path):
    """knnSearch of every distance on a seeded set: the same indices and
    distances as the JAX package's; items, trees, save and load."""
    rng = np.random.default_rng(dist)
    data = rng.integers(0, 4, (300, 12)).astype(np.float32) if dist == 3 else \
        rng.standard_normal((300, 12)).astype(np.float32)
    query = data[::37] + (0 if dist == 3 else rng.standard_normal((9, 12)).astype(np.float32) * 0.1)
    idx = {}
    for mod in (tcv, jcv):
        ann = mod.ANNIndex_create(12, dist)
        ann.addItems(data[:200])
        ann.addIndex(data[200:])
        assert ann.getItemNumber() == 300
        ann.build()
        assert ann.getTreeNumber() == 4
        idx[mod] = ann.knnSearch(query, 5)
        path = tmp_path / f"{mod.__name__}_{dist}"
        assert ann.save(str(path))
        loaded = mod.ANNIndex.create(12, 0)
        assert loaded.load(str(path)) and loaded.getItemNumber() == 300
        for a, b in zip(loaded.knnSearch(query, 5), idx[mod]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(idx[tcv], idx[jcv]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert idx[tcv][0].shape == (9, 5)


# The top-level names of the JAX package that the port still lacks: only
# those of the modules still to port (ROADMAP A8-A10), by module.  A name
# of a ported area that is missing shows up here.  A top-level submodule
# counts whether or not a test has imported it (an import makes it an
# attribute of its package).
STILL_TO_PORT = {
    "cuda": ("cuda",),
    "threed": ("threed", "RASTERIZE_COMPAT_DISABLED", "RASTERIZE_COMPAT_INVDEPTH",
               "RASTERIZE_CULLING_CCW", "RASTERIZE_CULLING_CW", "RASTERIZE_CULLING_NONE",
               "RASTERIZE_SHADING_FLAT", "RASTERIZE_SHADING_SHADED", "RASTERIZE_SHADING_WHITE",
               "depthTo3d", "depthTo3dSparse", "registerDepth", "rescaleDepth", "warpFrame",
               "Octree", "Octree_createWithDepth", "Octree_createWithResolution", "RgbdNormals",
               "RgbdNormals_create", "loadMesh", "loadPointCloud", "saveMesh", "savePointCloud",
               "TriangleRasterizeSettings", "triangleRasterize", "triangleRasterizeColor",
               "triangleRasterizeDepth", "Odometry", "OdometryFrame", "OdometrySettings",
               "Volume", "VolumeSettings"),
    "objdetect": ("objdetect", "aruco", "aruco_ArucoDetector", "aruco_Board",
                  "aruco_DetectorParameters", "aruco_Dictionary", "aruco_GridBoard",
                  "aruco_RefineParameters", "aruco_CharucoBoard", "aruco_CharucoDetector",
                  "aruco_CharucoParameters", "barcode", "barcode_BarcodeDetector",
                  "CascadeClassifier", "FaceDetectorYN", "FaceDetectorYN_create",
                  "FaceRecognizerSF", "FaceRecognizerSF_create", "HOGDescriptor",
                  "groupRectangles", "mcc", "mcc_CChecker", "mcc_CCheckerDetector",
                  "mcc_DetectorParametersMCC", "QRCodeEncoder", "QRCodeEncoder_Params",
                  "QRCodeEncoder_create", "GraphicalCodeDetector", "QRCodeDetector",
                  "QRCodeDetectorAruco", "QRCodeDetectorAruco_Params"),
    "videostab": ("videostab",),
    "imgcodecs": ("imgcodecs", "IMREAD_ANYCOLOR", "IMREAD_ANYDEPTH", "IMREAD_COLOR",
                  "IMREAD_GRAYSCALE", "IMREAD_UNCHANGED", "Animation", "haveImageReader",
                  "haveImageWriter", "imcount", "imdecode", "imdecodeWithMetadata",
                  "imdecodeanimation", "imdecodemulti", "imencode", "imencodeWithMetadata",
                  "imencodeanimation", "imencodemulti", "imread", "imreadWithMetadata",
                  "imreadanimation", "imreadmulti", "imwrite", "imwriteWithMetadata",
                  "imwriteanimation", "imwritemulti"),
    "videoio": ("videoio", "videoio_registry", "videoio_ffmpeg", "CAP_PROP_FPS",
                "CAP_PROP_FRAME_COUNT", "CAP_PROP_FRAME_HEIGHT", "CAP_PROP_FRAME_WIDTH",
                "CAP_PROP_POS_FRAMES", "IStreamReader", "VideoCapture", "VideoWriter",
                "VideoWriter_fourcc"),
    "persistence": ("persistence", "FILE_STORAGE_READ", "FILE_STORAGE_WRITE", "FileNode",
                    "FileStorage"),
    "highgui": ("highgui", "WINDOW_AUTOSIZE", "WINDOW_NORMAL", "addText", "createButton",
                "createTrackbar", "currentUIFramework", "destroyAllWindows", "destroyWindow",
                "displayOverlay", "displayStatusBar", "getTrackbarPos", "getWindowImageRect",
                "getWindowProperty", "imshow", "moveWindow", "namedWindow", "pollKey",
                "resizeWindow", "selectROI", "selectROIs", "setMouseCallback", "setTrackbarMax",
                "setTrackbarMin", "setTrackbarPos", "setWindowProperty", "setWindowTitle",
                "startWindowThread", "waitKey", "waitKeyEx"),
    "compat_classes": ("compat_classes", "MatShape", "cuda_BufferPool", "cuda_DeviceInfo",
                       "cuda_Event", "cuda_GpuData", "cuda_GpuMat", "cuda_GpuMatND",
                       "cuda_GpuMat_Allocator", "cuda_HostMem", "cuda_Stream",
                       "cuda_TargetArchs", "error", "ocl_Device", "ocl_OpenCLExecutionContext",
                       "utils_ClassWithKeywordProperties", "utils_nested_ExportClassName",
                       "utils_nested_ExportClassName_Params"),
    "mat_wrapper": ("mat_wrapper", "Mat", "UMat", "UMat_context", "UMat_queue"),
    "one-name modules": ("Error", "instr", "ipp", "misc", "ocl", "ogl", "qt", "samples",
                         "typing", "version", "data"),
}


def test_only_the_modules_still_to_port_are_missing():
    import pkgutil
    listed = [n for names in STILL_TO_PORT.values() for n in names]
    assert len(listed) == len(set(listed)) == 172
    theirs = set(dir(jcv)) | {m.name for m in pkgutil.iter_modules(jcv.__path__)}
    ours = set(dir(tcv)) | {m.name for m in pkgutil.iter_modules(tcv.__path__)}
    missing = {n for n in theirs - ours if not n.startswith("_")}
    assert sorted(missing - set(listed)) == []
