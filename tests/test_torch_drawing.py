"""opencv_tpu_torch's drawing module (line, rectangle, circle, ellipse,
ellipse2Poly, polylines, fillPoly, fillConvexPoly, drawContours, drawMarker,
arrowedLine, drawKeypoints, drawMatches, drawMatchesKnn, putText,
getTextSize, getFontScaleFromHeight) vs opencv_tpu and the cv2 oracle, on
the CPU.

Every primitive draws a numpy image in place and returns it, and draws a
tensor in place; both equal opencv_tpu's drawing with ``array_equal``,
LINE_AA's blend included.  Bresenham in closed form equals the JAX
package's loop on 3,000 random segments.  Where the reference tests hold
opencv_tpu to cv2 (test_contours.py, test_tail_apis.py, test_tail_apis3.py),
the port is held to cv2 under the same bounds."""

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
from opencv_tpu.features2d.keypoint import KeyPoint as JKeyPoint
from opencv_tpu.ops.drawing import _line_points as j_line_points
import opencv_tpu_torch as tcv
from opencv_tpu_torch.features2d import DMatch, KeyPoint
from opencv_tpu_torch.ops import drawing as D

SHAPES = [(60, 80), (60, 80, 3), (60, 80, 4)]
POLY = [np.array([[5, 5], [50, 10], [30, 40], [10, 30]])]
CONTOURS = [np.array([[[5, 5]], [[40, 8]], [[30, 35]]]), np.array([[[50, 40]], [[70, 45]],
                                                                   [[60, 55]]])]
CALLS = {
    "line": ("line", (3, 5), (70, 50), (255, 0, 0, 9), 1),
    "line thick": ("line", (3, 5), (70, 50), (255, 0, 0, 9), 3),
    "line float ends": ("line", (3.5, 5.5), (70.2, -50), (255, 0, 0, 9), 2),
    "line AA": ("line", (3, 5.5), (70.2, 50), (255, 0, 40, 9), 1, 16),
    "line AA steep thick": ("line", (30, 5), (35, 58), 200, 3, 16),
    "line AA off the image": ("line", (-10, -5), (95, 70), (10, 250, 30, 9), 2, 16),
    "rectangle": ("rectangle", (5, 5), (50, 40), (0, 255, 0, 9), 2),
    "rectangle filled": ("rectangle", (50, 40), (5, 5), (0, 255, 0, 9), -1),
    "circle": ("circle", (30, 30), 20, (1, 2, 3, 9), 2),
    "circle thick": ("circle", (30, 30), 12, (1, 2, 3, 9), 3),
    "circle filled": ("circle", (70, 55), 12, (1, 2, 3, 9), -1),
    "ellipse arc": ("ellipse", (40, 30), (20, 10), 30, 0, 270, (9, 8, 7, 6), 2),
    "ellipse filled": ("ellipse", (40, 30), (20, 10), 30, 0, 360, (9, 8, 7, 6), -1),
    "polylines": ("polylines", POLY, True, (5, 6, 7, 8), 2),
    "polylines open": ("polylines", POLY, False, (5, 6, 7, 8), 1),
    "fillPoly": ("fillPoly", POLY, (5, 6, 7, 8)),
    "fillConvexPoly": ("fillConvexPoly", POLY[0], 77),
    "drawContours": ("drawContours", CONTOURS, -1, (0, 0, 255, 1), 2),
    "drawContours filled": ("drawContours", CONTOURS, 1, (0, 0, 255, 1), -1),
    "drawMarker": ("drawMarker", (30, 30), (200, 100, 50, 1), 0, 15, 2),
    "arrowedLine": ("arrowedLine", (5, 5), (60, 40), (200, 100, 50, 1), 2),
    "putText": ("putText", "Ab 12!", (3, 40), 0, 0.8, (255, 255, 255, 255), 2),
    "putText italic bottom-left AA": ("putText", "xy?", (3, 20), 3 | 16, 0.6, 128, 1, 16,
                                      True),
}


def _channels(args, cn):
    """The call's colour cut to the image's channels (a 4-tuple for BGRA)."""
    return tuple(a[:max(cn, 1)] if isinstance(a, tuple) and len(a) == 4 else a for a in args)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", sorted(CALLS))
def test_primitive_equals_opencv_tpu(name, shape):
    """numpy in place and returned, a tensor in place: both equal
    opencv_tpu's numpy drawing."""
    fn, *args = CALLS[name]
    cn = shape[2] if len(shape) == 3 else 1
    args = _channels(args, cn)
    base = np.random.default_rng(len(name)).integers(0, 256, shape, np.uint8)
    want = base.copy()
    getattr(jcv, fn)(want, *args)
    a = base.copy()
    assert getattr(tcv, fn)(a, *args) is a
    np.testing.assert_array_equal(a, want)
    t = torch.from_numpy(base.copy())
    assert getattr(tcv, fn)(t, *args) is t
    np.testing.assert_array_equal(t.numpy(), want)


def test_drawing_on_a_view_and_a_read_only_array():
    """As in the JAX package: a numpy view or a read-only array is copied
    and the copy drawn and returned; a tensor view is drawn in place."""
    base = np.zeros((30, 40), np.uint8)
    out = tcv.line(base[5:25], (0, 0), (30, 15), 255, 1)
    assert out.any() and not base.any()
    ro = np.zeros((30, 40), np.uint8)
    ro.flags.writeable = False
    assert tcv.circle(ro, (20, 15), 5, 255, -1).any() and not ro.any()
    t = torch.zeros((30, 40), dtype=torch.uint8)
    tcv.line(t[5:25], (0, 0), (30, 15), 255, 1)
    want = np.zeros((30, 40), np.uint8)
    want[5:25] = jcv.line(np.zeros((20, 40), np.uint8), (0, 0), (30, 15), 255, 1)
    np.testing.assert_array_equal(t.numpy(), want)


def test_bresenham_closed_form_equals_the_loop():
    rng = np.random.default_rng(0)
    for _ in range(3000):
        p0 = rng.integers(-50, 50, 2) + (rng.random(2) if rng.random() < 0.3 else 0)
        p1 = rng.integers(-50, 50, 2)
        for got, want in zip(D._line_points(p0, p1), j_line_points(p0, p1)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_tensor_writes_are_batched_and_last_write_wins():
    """Plain writes wait on the host and go as one index_put_, the last of
    each pixel kept; a blend first makes the pending writes; a blend that
    names a pixel twice is refused."""
    t = torch.zeros((3, 20, 30, 3), dtype=torch.uint8)
    cv = D._Canvas(t, batch=True)
    for i in range(3):
        cv.frame = i
        D._line(cv, (0, 5), (29, 5), (255, 0, 0), 3)
        D._circle(cv, (15, 10), 5, (0, 255, 0), 2)
    assert cv.writes == 0
    cv.frame = 1
    D._line(cv, (0, 0), (29, 19), (0, 0, 255), 2, tcv.LINE_AA)
    assert cv.writes == 2
    cv.done()
    assert cv.writes == 2
    want = [np.zeros((20, 30, 3), np.uint8) for _ in range(3)]
    for w in want:
        jcv.line(w, (0, 5), (29, 5), (255, 0, 0), 3)
        jcv.circle(w, (15, 10), 5, (0, 255, 0), 2)
    jcv.line(want[1], (0, 0), (29, 19), (0, 0, 255), 2, jcv.LINE_AA)
    np.testing.assert_array_equal(t.numpy(), np.stack(want))
    with pytest.raises(ValueError):
        cv.blend(np.array([1, 1]), np.array([2, 2]), np.array([0.5, 0.5]), (1, 2, 3))


@pytest.mark.parametrize("gray", [True, False])
def test_keypoints_and_matches_equal_opencv_tpu(gray):
    rng = np.random.default_rng(1)
    img1 = rng.integers(0, 256, (50, 60) if gray else (50, 60, 3), np.uint8)
    img2 = rng.integers(0, 256, (40, 70, 3), np.uint8)
    pts = [(10, 12), (30.7, 40.2), (55, 3)]
    kps, jkps = [KeyPoint(x, y, 5) for x, y in pts], [JKeyPoint(x, y, 5) for x, y in pts]
    want = jcv.drawKeypoints(img1, jkps, None)
    np.testing.assert_array_equal(tcv.drawKeypoints(img1, kps, None), want)
    np.testing.assert_array_equal(tcv.drawKeypoints(torch.from_numpy(img1), kps, None).numpy(),
                                  want)
    ms = [DMatch(0, 1, 3.0), DMatch(2, 0, 1.0), DMatch(1, 2, 0.5)]
    for mask in (None, [1, 0, 1]):
        want = jcv.drawMatches(img1, jkps, img2, jkps, ms, None, matchesMask=mask)
        np.testing.assert_array_equal(tcv.drawMatches(img1, kps, img2, kps, ms, None,
                                                      matchesMask=mask), want)
        got = tcv.drawMatches(torch.from_numpy(img1), kps, torch.from_numpy(img2), kps, ms,
                              None, matchesMask=mask)
        np.testing.assert_array_equal(got.numpy(), want)
    knn = [ms[:2], ms[2:]]
    want = jcv.drawMatchesKnn(img1, jkps, img2, jkps, knn, None, matchColor=(0, 255, 0),
                              matchesMask=[[1, 0], [1]])
    got = tcv.drawMatchesKnn(torch.from_numpy(img1), kps, torch.from_numpy(img2), kps, knn,
                             None, matchColor=(0, 255, 0), matchesMask=[[1, 0], [1]])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("font", [0, 1, 2, 3, 4, 5, 6, 7, 3 | 16])
def test_text_metrics_equal_opencv_tpu(font):
    for scale, th in ((1.0, 1), (0.55, 2)):
        assert tcv.getTextSize("Quick fox 123!", font, scale, th) == \
            jcv.getTextSize("Quick fox 123!", font, scale, th)
        assert tcv.getFontScaleFromHeight(font, 22, th) == jcv.getFontScaleFromHeight(font, 22, th)
    want = np.zeros((80, 420), np.uint8)
    jcv.putText(want, "Quick fox 123!", (8, 55), font, 1.0, 255, 1)
    got = torch.zeros((80, 420), dtype=torch.uint8)
    tcv.putText(got, "Quick fox 123!", (8, 55), font, 1.0, 255, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_unknown_font_raises():
    with pytest.raises(ValueError):
        tcv.getTextSize("a", 9, 1.0, 1)


# ------------------------------------------------------ against cv2

def test_line_and_rectangle_vs_cv2():
    """tests/test_contours.py::test_drawing_line_rect."""
    ref, ours = np.zeros((40, 50), np.uint8), torch.zeros((40, 50), dtype=torch.uint8)
    cv2.line(ref, (3, 5), (45, 30), 255, 1)
    tcv.line(ours, (3, 5), (45, 30), 255, 1)
    assert np.count_nonzero(ref != ours.numpy()) <= 3
    ref2, ours2 = np.zeros((40, 50), np.uint8), torch.zeros((40, 50), dtype=torch.uint8)
    cv2.rectangle(ref2, (5, 5), (30, 20), 255, -1)
    tcv.rectangle(ours2, (5, 5), (30, 20), 255, -1)
    np.testing.assert_array_equal(ours2.numpy(), ref2)


def test_circle_and_fill_poly_vs_cv2():
    """tests/test_contours.py::test_drawing_circle_fill and test_fill_poly."""
    ref, ours = np.zeros((50, 50), np.uint8), torch.zeros((50, 50), dtype=torch.uint8)
    cv2.circle(ref, (25, 25), 10, 255, -1)
    tcv.circle(ours, (25, 25), 10, 255, -1)
    assert np.count_nonzero(ref != ours.numpy()) <= 40
    ref, ours = np.zeros((40, 50), np.uint8), torch.zeros((40, 50), dtype=torch.uint8)
    poly = np.array([[5, 5], [45, 10], [30, 35], [10, 30]], np.int32)
    cv2.fillPoly(ref, [poly], 255)
    tcv.fillPoly(ours, [poly], 255)
    o = ours.numpy()
    assert np.count_nonzero((ref > 0) & (o > 0)) / np.count_nonzero((ref > 0) | (o > 0)) > 0.93


def test_put_text_fonts_and_metrics():
    """tests/test_contours.py::test_puttext_renders_all_fonts,
    test_gettextsize_formula and test_puttext_bottom_left_origin."""
    for f in (0, 1, 2, 3, 4, 5, 6, 7, 3 | 16):
        img = torch.zeros((80, 420), dtype=torch.uint8)
        tcv.putText(img, "Quick fox 123!", (8, 55), f, 1.0, 255, 1)
        (w, h), b = tcv.getTextSize("Quick fox 123!", f, 1.0, 1)
        ys, xs = np.nonzero(img.numpy())
        assert xs.max() - 8 <= w + 4 and 55 - ys.min() <= h + 2 and ys.max() - 55 <= b + 2
    (w, h), b = tcv.getTextSize("A", tcv.FONT_HERSHEY_SIMPLEX, 1.0, 1)
    assert h == 22 and b == 10
    assert abs(tcv.getFontScaleFromHeight(tcv.FONT_HERSHEY_SIMPLEX, 22, 1) - 1.0) < 0.05
    up, dn = np.zeros((60, 120), np.uint8), np.zeros((60, 120), np.uint8)
    tcv.putText(up, "Ab", (5, 30), tcv.FONT_HERSHEY_SIMPLEX, 1.0, 255, 1)
    tcv.putText(dn, "Ab", (5, 30), tcv.FONT_HERSHEY_SIMPLEX, 1.0, 255, 1, bottomLeftOrigin=True)
    assert np.nonzero(up)[0].mean() < 30 < np.nonzero(dn)[0].mean()


def test_line_aa_vs_cv2():
    """tests/test_contours.py::test_line_aa_coverage, on tensors."""
    for p0, p1 in [((5, 10), (90, 40)), ((10, 5), (30, 85)), ((5, 5), (95, 95)),
                   ((5, 50), (95, 50))]:
        a = np.zeros((100, 100), np.uint8)
        b = torch.zeros((100, 100), dtype=torch.uint8)
        cv2.line(a, p0, p1, 255, 1, cv2.LINE_AA)
        tcv.line(b, p0, p1, 255, 1, tcv.LINE_AA)
        b = b.numpy()
        assert ((a > 30) & (b > 30)).sum() / ((a > 30) | (b > 30)).sum() > 0.95
        assert ((b > 40) & (b < 220)).sum() > 20
    c = torch.full((50, 50, 3), 30, dtype=torch.uint8)
    tcv.line(c, (5, 10), (45, 40), (0, 255, 0), 2, tcv.LINE_AA)
    c = c.numpy()
    assert c[..., 1].max() > 200 and ((c[..., 1] > 60) & (c[..., 1] < 200)).any()


def test_ellipse2poly_vs_cv2():
    """tests/test_tail_apis.py::test_ellipse2poly."""
    for c, ax, ang, a0, a1, d in [((50, 40), (30, 20), 0, 0, 360, 5),
                                  ((10, 10), (15, 25), 30, 45, 270, 10),
                                  ((0, 0), (7, 3), 125, -90, 90, 1)]:
        got = tcv.ellipse2Poly(c, ax, ang, a0, a1, d)
        np.testing.assert_array_equal(got, cv2.ellipse2Poly(c, ax, ang, a0, a1, d))
        np.testing.assert_array_equal(got, jcv.ellipse2Poly(c, ax, ang, a0, a1, d))


def test_draw_matches_knn_vs_cv2_keypoints():
    """tests/test_tail_apis3.py::test_draw_matches_knn, cv2's own keypoints
    and matches."""
    rng = np.random.default_rng(10)
    img1 = rng.integers(0, 256, (40, 40, 3), np.uint8)
    img2 = rng.integers(0, 256, (40, 40, 3), np.uint8)
    kp1 = [cv2.KeyPoint(10.0, 10.0, 3), cv2.KeyPoint(20.0, 15.0, 3)]
    kp2 = [cv2.KeyPoint(12.0, 11.0, 3), cv2.KeyPoint(25.0, 18.0, 3)]
    knn = [[cv2.DMatch(0, 0, 0.5), cv2.DMatch(0, 1, 0.9)], [cv2.DMatch(1, 1, 0.4)]]
    out = tcv.drawMatchesKnn(torch.from_numpy(img1), kp1, torch.from_numpy(img2), kp2, knn,
                             None, matchColor=(0, 255, 0))
    assert out.shape == (40, 80, 3) and (out[:, :, 1] == 255).any()
