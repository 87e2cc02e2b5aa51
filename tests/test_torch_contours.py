"""opencv_tpu_torch's contours module vs opencv_tpu and the cv2 oracle, on
the CPU.  The module is opencv_tpu's host numpy code, copied (with a raster
scan that visits only the pixels where a border can start): every function
equals opencv_tpu exactly (``array_equal``, ``==``) on the reference
tests' own inputs and more, for numpy and tensor arguments; findContours is
also held to cv2's point sets per contour where the reference test holds
opencv_tpu to them.  findContours runs the port's native scan
(``native/hosttails.cpp``), held equal to its Python twin
``_find_contours_simple`` and to opencv_tpu; without a compiler it raises."""

import shutil

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu_torch import native
from opencv_tpu_torch.ops import contours as C


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _shapes_img():
    img = np.zeros((60, 80), np.uint8)
    cv2.circle(img, (18, 20), 10, 255, -1)
    cv2.rectangle(img, (40, 10), (70, 40), 255, -1)
    cv2.rectangle(img, (48, 18), (62, 32), 0, -1)
    cv2.circle(img, (55, 25), 3, 255, -1)
    return img


def _images():
    rng = np.random.default_rng(0)
    nested = np.zeros((50, 50), np.uint8)
    for r, v in ((22, 255), (16, 0), (10, 255), (5, 0), (2, 255)):
        cv2.circle(nested, (25, 25), r, v, -1)
    edge = np.zeros((20, 30), np.uint8)
    edge[0:5, :] = 255
    edge[10:, 25:] = 1
    edge[15, 3] = 255
    lines = np.zeros((40, 50), np.uint8)
    cv2.line(lines, (2, 3), (45, 30), 255, 1)
    cv2.line(lines, (5, 35), (40, 5), 255, 1)
    lines[20, :] = 255
    lines[:, 10] = 255
    lines[30:38, 44] = 255
    lines[12, 30] = 255
    framed = np.zeros((30, 40), np.uint8)
    framed[:, :3] = 255
    framed[-4:, :] = 255
    framed[5:12, 30:] = 255
    framed[14:20, 15:25] = 255
    framed[16:18, 18:22] = 0
    return {"shapes": _shapes_img(), "noise": (rng.random((50, 70)) > 0.6).astype(np.uint8) * 255,
            "dense": (rng.random((31, 33)) > 0.3).astype(np.uint8), "nested": nested,
            "edge": edge, "lines": lines, "framed": framed}


IMAGES = _images()
# the images on which opencv_tpu's contours are cv2's point sets (its own
# test's image and nested rings); on the noise images and at the frame
# opencv_tpu's border following parts from cv2's, and the port keeps
# opencv_tpu's
CV2_IMAGES = ("shapes", "nested")


def _same(got, want):
    gc, gh = got
    wc, wh = want
    assert len(gc) == len(wc)
    for a, b in zip(gc, wc):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert (gh is None) == (wh is None)
    if gh is not None:
        np.testing.assert_array_equal(gh, wh)


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
@pytest.mark.parametrize("method", [1, 2])
@pytest.mark.parametrize("name", list(IMAGES))
def test_find_contours_equals_opencv_tpu(name, mode, method):
    img = IMAGES[name]
    got = tcv.findContours(_t(img), mode, method)
    _same(got, jcv.findContours(img, mode, method))
    if name not in CV2_IMAGES:
        return
    rc, _ = cv2.findContours(img, mode, method)
    key = lambda s: sorted(s)[0]  # noqa: E731
    rsets = sorted([frozenset(map(tuple, c.reshape(-1, 2).tolist())) for c in rc], key=key)
    osets = sorted([frozenset(map(tuple, c.reshape(-1, 2).tolist())) for c in got[0]], key=key)
    assert rsets == osets


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
@pytest.mark.parametrize("method", [1, 2])
@pytest.mark.parametrize("name", list(IMAGES))
def test_native_scan_equals_python_trace(name, mode, method):
    """findContours (the native scan) equals its plain Python twin, in the
    points, their order and the hierarchy."""
    img = IMAGES[name]
    _same(tcv.findContours(img, mode, method),
          C._find_contours_simple((img != 0).astype(np.int32), mode, method))


def test_native_scan_raw_output_and_growth(monkeypatch):
    """The raw scan: one (k, 2) int32 array per border, the parents and
    types the trace finds; a scan that overruns its buffers runs again
    with larger ones and gives the same borders."""
    img = IMAGES["noise"]
    pts, parents, is_outer = native.suzuki_contours(img)
    want, _ = C._find_contours_simple((img != 0).astype(np.int32), 1, 1)
    assert len(pts) == len(want) == len(parents) == len(is_outer)
    for a, b in zip(pts, want):
        assert a.dtype == np.int32 and a.shape == (len(b), 2)
        np.testing.assert_array_equal(a, b.reshape(-1, 2))
    assert is_outer[0] and parents[0] == -1
    lib = native.library()
    calls = []

    class Small:
        """The library with the first call's buffers cut to 4 contours."""
        def suzuki_contours(self, *args):
            calls.append(args[-1])
            args = list(args)
            if len(calls) == 1:
                args[-1] = 4
            return lib.suzuki_contours(*args)

    monkeypatch.setattr(native, "library", lambda: Small())
    again = native.suzuki_contours(img)
    assert len(calls) == 2 and calls[1] == 2 * calls[0]
    assert all(np.array_equal(a, b) for a, b in zip(again[0], pts))
    np.testing.assert_array_equal(again[1], parents)


def test_native_scan_raises_without_a_compiler(monkeypatch):
    """findContours raises where the JAX package falls back to Python."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        tcv.findContours(IMAGES["shapes"], 0, 1)


def test_find_contours_empty_and_3d():
    empty = np.zeros((8, 9), np.uint8)
    assert tcv.findContours(empty, 0, 1) == ([], None)
    img = IMAGES["shapes"][..., None]
    _same(tcv.findContours(img, 3, 2), jcv.findContours(img, 3, 2))


def _result(fn, *args):
    """fn's value, or the type of the error it raises."""
    try:
        return fn(*args)
    except ValueError as e:
        return type(e)


def _contours():
    return cv2.findContours(_shapes_img(), cv2.RETR_LIST, cv2.CHAIN_APPROX_NONE)[0]


def test_contour_geometry():
    for c in _contours():
        for fn, args in (("contourArea", ()), ("contourArea", (True,)), ("arcLength", (True,)),
                         ("arcLength", (False,)), ("boundingRect", ()),
                         ("isContourConvex", ()), ("minAreaRect", ()),
                         ("minEnclosingCircle", ())):
            assert getattr(tcv, fn)(_t(c), *args) == getattr(jcv, fn)(c, *args), fn
        assert abs(tcv.contourArea(c) - cv2.contourArea(c)) < 1e-9
        assert tcv.boundingRect(c) == cv2.boundingRect(c)
        for cw in (False, True):
            for rp in (True, False):
                np.testing.assert_array_equal(tcv.convexHull(_t(c), cw, rp),
                                              jcv.convexHull(c, cw, rp))
        hull = tcv.convexHull(c, returnPoints=False)
        got = tcv.convexityDefects(c, hull)
        want = jcv.convexityDefects(c, hull)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
        for eps, closed in ((2.0, True), (1.0, False)):
            np.testing.assert_array_equal(tcv.approxPolyDP(_t(c), eps, closed),
                                          jcv.approxPolyDP(c, eps, closed))
        if len(c) >= 5:
            for fn in ("fitEllipse", "fitEllipseAMS", "fitEllipseDirect"):
                assert _result(getattr(tcv, fn), _t(c)) == _result(getattr(jcv, fn), c), fn


def test_points_and_polygons():
    rng = np.random.default_rng(0)
    pts = rng.integers(10, 90, (20, 1, 2)).astype(np.int32)
    rect = tcv.minAreaRect(_t(pts))
    assert rect == jcv.minAreaRect(pts)
    np.testing.assert_array_equal(tcv.boxPoints(rect), jcv.boxPoints(rect))
    sq = np.array([[10, 10], [50, 10], [50, 50], [10, 50]], np.int32).reshape(-1, 1, 2)
    for pt in [(30, 30), (5, 5), (10, 30), (49, 49)]:
        for md in (False, True):
            assert tcv.pointPolygonTest(_t(sq), pt, md) == jcv.pointPolygonTest(sq, pt, md)
        assert tcv.pointPolygonTest(sq, pt, False) == cv2.pointPolygonTest(sq, pt, False)
    cpts = rng.integers(0, 100, (30, 1, 2)).astype(np.int32)
    assert tcv.minEnclosingCircle(cpts) == jcv.minEnclosingCircle(cpts)
    fp = rng.random((20, 2)).astype(np.float32) * 100
    got, want = tcv.minEnclosingTriangle(_t(fp)), jcv.minEnclosingTriangle(fp)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    hull = cv2.convexHull(fp.reshape(-1, 1, 2))
    for n, eps in ((4, -1.0), (5, 0.1)):
        np.testing.assert_array_equal(tcv.approxPolyN(_t(hull), n, eps),
                                      jcv.approxPolyN(hull, n, eps))


def test_hu_moments_and_intersections():
    img = _shapes_img()
    np.testing.assert_array_equal(tcv.HuMoments(jcv.moments(img)), jcv.HuMoments(jcv.moments(img)))
    np.testing.assert_allclose(tcv.HuMoments(tcv.moments(img)), cv2.HuMoments(cv2.moments(img)),
                               atol=1e-8)
    r1, r2 = ((50, 50), (40, 20), 30.0), ((60, 55), (30, 30), -10.0)
    for a, b in ((r1, r2), (((0, 0), (4, 4), 0.0), ((100, 100), (4, 4), 0.0)),
                 (((50, 50), (40, 40), 0.0), ((50, 50), (10, 10), 15.0))):
        gs, gp = tcv.rotatedRectangleIntersection(a, b)
        js, jp = jcv.rotatedRectangleIntersection(a, b)
        assert gs == js
        assert (gp is None and jp is None) or np.array_equal(gp, jp)
    assert tcv.rotatedRectangleIntersection(r1, r2)[0] == cv2.rotatedRectangleIntersection(r1,
                                                                                          r2)[0]
    p1 = np.array([[10, 10], [60, 15], [55, 50], [15, 45]], np.float32)
    p2 = np.array([[30, 5], [80, 30], [40, 60]], np.float32)
    ga, gpts = tcv.intersectConvexConvex(_t(p1), p2)
    ja, jpts = jcv.intersectConvexConvex(p1, p2)
    assert ga == ja
    np.testing.assert_array_equal(gpts, jpts)
    assert abs(ga - cv2.intersectConvexConvex(p1, p2)[0]) < 1e-2


def test_public_surface_contours():
    for name in ("findContours", "contourArea", "arcLength", "boundingRect", "minAreaRect",
                 "boxPoints", "convexHull", "convexityDefects", "approxPolyDP", "isContourConvex",
                 "pointPolygonTest", "minEnclosingCircle", "fitEllipse", "fitEllipseAMS",
                 "fitEllipseDirect", "approxPolyN", "HuMoments", "rotatedRectangleIntersection",
                 "intersectConvexConvex", "minEnclosingTriangle", "INTERSECT_NONE",
                 "INTERSECT_PARTIAL", "INTERSECT_FULL"):
        assert hasattr(tcv, name), name
        assert getattr(tcv, name).__class__ is getattr(jcv, name).__class__, name
    assert (tcv.INTERSECT_NONE, tcv.INTERSECT_PARTIAL, tcv.INTERSECT_FULL) == (0, 1, 2)
