"""opencv_tpu_torch's fitLine, line segment detector (LineSegmentDetector,
createLineSegmentDetector, drawSegments) and geometry_extra
(rectangleIntersectionArea, getClosestEllipsePoints,
phaseCorrelateIterative, filter2Dp, findContoursLinkRuns) vs opencv_tpu and
the cv2 oracle, on the CPU.

Tolerances: ``array_equal`` with opencv_tpu everywhere but two places.
LSD fed the JAX package's own scaled image is exact; end to end, its f32
prefilter is the port's GaussianBlur and resize, so the test asks for the
same count of segments with end points within 1e-4 px.  filter2Dp on a
float image carries filter2D's float contract (tests/test_torch_filters.py:
1e-5 of the largest magnitude; the integer outputs equal).  Where the
reference tests hold opencv_tpu to cv2 (test_tail_apis.py,
test_hough_seg.py, test_tail_apis7.py), the port is held to cv2 under the
same bounds."""

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
from opencv_tpu.ops.filter import GaussianBlur as j_gaussian_blur
from opencv_tpu.ops.resize import resize as j_resize
import opencv_tpu_torch as tcv


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


# ------------------------------------------------------------------ fitLine

def _points(dims, seed, outliers=6, n=80):
    rng = np.random.default_rng(seed)
    t = rng.random(n)
    base = np.stack([30 * t, 2 + 7 * t, 1 - 3 * t][:dims], axis=1)
    pts = base + rng.normal(0, 0.05, base.shape)
    pts[:outliers] += rng.normal(0, 8, (outliers, dims))
    return pts.astype(np.float32)


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("dist", ["DIST_L2", "DIST_L1", "DIST_L12", "DIST_FAIR",
                                  "DIST_WELSCH", "DIST_HUBER"])
def test_fit_line_equals_opencv_tpu(dist, dims):
    """2-D and 3-D, every distance: bit for bit, the 20 restarts of cv::RNG
    and 30 IRLS rounds included; a tensor is read back once."""
    for seed in (0, 1):
        pts = _points(dims, seed)
        want = jcv.fitLine(pts, getattr(jcv, dist), 0, 0.01, 0.01)
        np.testing.assert_array_equal(tcv.fitLine(pts, getattr(tcv, dist), 0, 0.01, 0.01), want)
        got = tcv.fitLine(_t(pts).reshape(-1, 1, dims), getattr(tcv, dist), 0, 0.01, 0.01)
        assert got.dtype == np.float32 and got.shape == (2 * dims, 1)
        np.testing.assert_array_equal(got, want)


def test_fit_line_params():
    pts = _points(2, 3)
    for args in ((1.5, 0.0, 0.0), (0, 0.1, 0.05), (2.0, 0.01, 0.01)):
        for dist in (tcv.DIST_HUBER, tcv.DIST_FAIR, tcv.DIST_WELSCH):
            np.testing.assert_array_equal(tcv.fitLine(pts, dist, *args),
                                          jcv.fitLine(pts, dist, *args))


def test_fit_line_vs_cv2():
    """tests/test_tail_apis.py::test_fitline_l2_2d, _robust_2d and _l2_3d."""
    rng = np.random.default_rng(0)
    t = rng.random(60)
    pts = np.stack([10 + 30 * t + rng.normal(0, 0.3, 60), 5 + 12 * t + rng.normal(0, 0.3, 60)],
                   axis=1).astype(np.float32)
    ref = cv2.fitLine(pts, cv2.DIST_L2, 0, 0.01, 0.01).ravel()
    got = tcv.fitLine(_t(pts), tcv.DIST_L2, 0, 0.01, 0.01).ravel()
    if np.dot(ref[:2], got[:2]) < 0:
        got = np.concatenate([-got[:2], got[2:]])
    assert np.allclose(got, ref, atol=1e-4)
    rng = np.random.default_rng(1)
    t = rng.random(80)
    pts = np.stack([30 * t, 2 + 7 * t], axis=1) + rng.normal(0, 0.05, (80, 2))
    pts[:6] += rng.normal(0, 8, (6, 2))
    pts = pts.astype(np.float32)
    for dist in ("DIST_L1", "DIST_L12", "DIST_HUBER", "DIST_FAIR", "DIST_WELSCH"):
        ref = cv2.fitLine(pts, getattr(cv2, dist), 0, 0.01, 0.01).ravel()
        got = tcv.fitLine(_t(pts), getattr(tcv, dist), 0, 0.01, 0.01).ravel()
        assert abs(np.dot(got[:2], ref[:2])) > 0.9995, dist
    rng = np.random.default_rng(2)
    t = rng.random(50)
    pts = (np.stack([1 + 3 * t, 2 - 5 * t, 0.5 + 2 * t], axis=1)
           + rng.normal(0, 0.01, (50, 3))).astype(np.float32)
    ref = cv2.fitLine(pts, cv2.DIST_L2, 0, 0.01, 0.01).ravel()
    got = tcv.fitLine(_t(pts), tcv.DIST_L2, 0, 0.01, 0.01).ravel()
    if np.dot(ref[:3], got[:3]) < 0:
        got = np.concatenate([-got[:3], got[3:]])
    assert abs(np.dot(got[:3], ref[:3])) > 0.99999
    assert np.allclose(got[3:], ref[3:], atol=1e-3)


# ---------------------------------------------------------------------- LSD

def _lsd_image(seed=0, shape=(100, 140)):
    rng = np.random.default_rng(seed)
    img = np.zeros(shape, np.uint8)
    for _ in range(4):
        p = rng.integers(5, shape[1] - 5, 2), rng.integers(5, shape[0] - 5, 2)
        cv2.line(img, (int(p[0][0]), int(p[1][0])), (int(p[0][1]), int(p[1][1])),
                 int(rng.integers(120, 256)), 2)
    return cv2.GaussianBlur(img, (3, 3), 1)


def _jax_scaled(img, scale=0.8, sigma_scale=0.6):
    H0, W0 = img.shape
    sigma = sigma_scale / scale
    ksz = int(np.ceil(sigma * 6)) | 1
    f = np.asarray(j_gaussian_blur(img.astype(np.float32), (ksz, ksz), sigma))
    return np.asarray(j_resize(f, (int(round(W0 * scale)), int(round(H0 * scale))),
                               interpolation=jcv.INTER_LINEAR))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_lsd_tail_on_the_jax_scaled_image_is_exact(seed):
    """The host tail, fed the JAX package's own scaled image, gives its
    segments exactly (the unusable seeds dropped first change nothing)."""
    img = _lsd_image(seed)
    want = jcv.createLineSegmentDetector().detect(img)
    got = tcv.createLineSegmentDetector().segments(_jax_scaled(img))
    assert want[0] is not None and _same(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_lsd_end_to_end(seed):
    """The port's own prefilter: the same count of segments, end points and
    widths within 1e-4 px (the scaled images here come out equal, so the
    segments do too)."""
    img = _lsd_image(seed)
    want = jcv.createLineSegmentDetector().detect(img)
    got = tcv.createLineSegmentDetector().detect(_t(img))
    assert got[0].shape == want[0].shape
    np.testing.assert_allclose(got[0], want[0], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=1e-4, rtol=0)
    assert _same(got[2:], want[2:])


def test_lsd_options_and_colour():
    img = _lsd_image(5)
    bgr = np.stack([img, img // 2, img], -1)
    for kw in (dict(scale=1.0), dict(scale=0.5, sigma_scale=0.8), dict(ang_th=30.0, quant=3.0),
               dict(density_th=0.5)):
        want = jcv.createLineSegmentDetector(**kw).detect(bgr)
        got = tcv.createLineSegmentDetector(**kw).detect(_t(bgr))
        assert (got[0] is None) == (want[0] is None)
        if want[0] is not None:
            assert got[0].shape == want[0].shape
            np.testing.assert_allclose(got[0], want[0], atol=1e-4, rtol=0)
    assert tcv.createLineSegmentDetector().detect(_t(np.full((64, 64), 100, np.uint8))) == \
        (None, None, None, None)


def test_draw_segments():
    img = _lsd_image(6)
    lines = jcv.createLineSegmentDetector().detect(img)[0]
    det = tcv.createLineSegmentDetector()
    want = jcv.createLineSegmentDetector().drawSegments(img, lines)
    np.testing.assert_array_equal(det.drawSegments(img, lines), want)
    np.testing.assert_array_equal(det.drawSegments(_t(img), lines).numpy(), want)
    bgr = np.stack([img] * 3, -1)
    t = _t(bgr.copy())
    assert det.drawSegments(t, lines) is t
    np.testing.assert_array_equal(t.numpy(), want)
    np.testing.assert_array_equal(det.drawSegments(img, None), np.stack([img] * 3, -1))


def test_lsd_vs_cv2_structure():
    """tests/test_hough_seg.py::test_lsd_matches_cv2_structure."""
    img = np.zeros((100, 140), np.uint8)
    cv2.line(img, (10, 20), (120, 30), 255, 2)
    cv2.line(img, (30, 80), (40, 10), 180, 2)
    img = cv2.GaussianBlur(img, (3, 3), 1)
    ref_lines, _, _, _ = cv2.createLineSegmentDetector().detect(img)
    our_lines, w, p, nfa = tcv.createLineSegmentDetector().detect(_t(img))
    assert our_lines is not None and w.shape[0] == our_lines.shape[0]

    def seg_dist(a, b):
        d1 = np.hypot(a[0] - b[0], a[1] - b[1]) + np.hypot(a[2] - b[2], a[3] - b[3])
        d2 = np.hypot(a[0] - b[2], a[1] - b[3]) + np.hypot(a[2] - b[0], a[3] - b[1])
        return min(d1, d2) / 2

    matched = total = 0
    for r in ref_lines.reshape(-1, 4):
        rlen = np.hypot(r[2] - r[0], r[3] - r[1])
        if rlen <= 15:
            continue
        total += 1
        matched += min(seg_dist(r, o) for o in our_lines.reshape(-1, 4)) < max(5, 0.2 * rlen)
    assert total and matched == total


# ------------------------------------------------------------ geometry_extra

def test_rectangle_intersection_area():
    cases = [((0, 0, 10, 10), (5, 5, 10, 10)), ((0.0, 0.0, 10.0, 10.0), (20.0, 20.0, 3.0, 3.0)),
             ((1, 2, 7, 3), (4, 1, 2, 9))]
    for a, b in cases:
        got = tcv.rectangleIntersectionArea(a, b)
        assert got == jcv.rectangleIntersectionArea(a, b) == cv2.rectangleIntersectionArea(a, b)


def test_closest_ellipse_points():
    ep = ((5.0, 5.0), (8.0, 4.0), 30.0)
    q = np.random.default_rng(0).uniform(-5, 15, (12, 2)).astype(np.float32)
    got = tcv.getClosestEllipsePoints(ep, _t(q))
    np.testing.assert_array_equal(got, jcv.getClosestEllipsePoints(ep, q))
    ref = np.asarray(cv2.getClosestEllipsePoints(ep, q)).reshape(-1, 2)
    assert np.allclose(got.reshape(-1, 2), ref, atol=1e-2)


@pytest.mark.parametrize("shift", [(3, 2), (-5, 7), (0, 0)])
def test_phase_correlate_iterative(shift):
    """Within 1e-9 px of opencv_tpu (torch.fft and pocketfft round
    differently, tests/test_torch_misc.py's bound)."""
    a = np.random.default_rng(1).random((32, 40)).astype(np.float32)
    b = np.roll(a, shift[::-1], (0, 1))
    got = tcv.phaseCorrelateIterative(_t(a), b)
    want = jcv.phaseCorrelateIterative(a, b)
    assert all(isinstance(v, float) for v in got)
    np.testing.assert_allclose(got, want, atol=1e-9, rtol=0)
    np.testing.assert_allclose(got, shift, atol=0.05)


@pytest.mark.parametrize("ddepth", [-1, 5, 6])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_filter2dp(dtype, ddepth):
    """u8 outputs equal; float outputs within filter2D's float contract
    (1e-5 of the largest magnitude)."""
    rng = np.random.default_rng(2)
    img = (rng.random((24, 30)) * 255).astype(dtype)
    k = rng.random((3, 3)).astype(np.float32)
    for kw in (dict(scale=0.5, shift=1.25), dict(), dict(anchorX=0, anchorY=2, borderType=1)):
        got = tcv.filter2Dp(_t(img), k, ddepth=ddepth, **kw).numpy()
        want = np.asarray(jcv.filter2Dp(img, k, ddepth=ddepth, **kw))
        assert got.dtype == want.dtype and got.shape == want.shape
        if got.dtype == np.uint8:
            np.testing.assert_array_equal(got, want)
        else:
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_filter2dp_vs_cv2():
    """tests/test_tail_apis7.py::test_filter2dp."""
    rng = np.random.default_rng(1)
    img = rng.random((12, 14)).astype(np.float32)
    k = rng.random((3, 3)).astype(np.float32)
    ref = cv2.filter2Dp(img, k, scale=0.5, shift=1.25)
    assert np.allclose(tcv.filter2Dp(_t(img), k, scale=0.5, shift=1.25).numpy(), ref, atol=1e-5)


def _masks():
    m = np.zeros((12, 14), np.uint8)
    m[1:6, 1:6] = 255
    m[2:5, 2:5] = 0
    m[7:11, 8:13] = 255
    rng = np.random.default_rng(3)
    ring = np.zeros((30, 40), np.uint8)
    cv2.circle(ring, (20, 15), 10, 255, 3)
    two = np.zeros((20, 30), np.uint8)
    two[2:18, 2:28] = 255
    two[5:8, 5:10] = two[5:8, 15:20] = two[12:15, 4:25] = 0
    two[6, 12] = 0
    return [m, ring, two, ((rng.random((40, 50)) < 0.4) * 255).astype(np.uint8),
            ((rng.random((33, 47)) < 0.6) * 255).astype(np.uint8)]


@pytest.mark.parametrize("k", range(5))
def test_find_contours_link_runs_equals_opencv_tpu(k):
    """Components, holes (several runs on their top row too) and noise: the
    contours and the hierarchy exactly."""
    m = _masks()[k]
    got_c, got_h = tcv.findContoursLinkRuns(_t(m))
    want_c, want_h = jcv.findContoursLinkRuns(m)
    assert len(got_c) == len(want_c) > 0
    for g, w in zip(got_c, want_c):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    np.testing.assert_array_equal(got_h, want_h)


def test_find_contours_link_runs_vs_cv2():
    """tests/test_tail_apis7.py::test_find_contours_link_runs."""
    m = _masks()[0]
    ref_c, ref_h = cv2.findContoursLinkRuns(m)
    got_c, got_h = tcv.findContoursLinkRuns(_t(m))
    assert len(got_c) == len(ref_c)
    assert sorted(sorted(map(tuple, c.reshape(-1, 2).tolist())) for c in ref_c) == \
        sorted(sorted(map(tuple, c.reshape(-1, 2).tolist())) for c in got_c)
    assert np.asarray(got_h).shape == np.asarray(ref_h).shape
