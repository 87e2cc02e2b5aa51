"""The port's the lines path (gray → GaussianBlur → Canny → the Hough
accumulator and HoughLinesP → HoughCircles → fitLine → LSD → the drawing)
end to end on the CPU, against the same chain through opencv_tpu at a small
batch (moved from tests/test_torch_slice.py, one file per path)."""

import numpy as np
import pytest
import torch

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu_torch import entry as E
from opencv_tpu_torch.core.dispatch import reset_tier_stats, tier_stats

SHAPE_LINES = (2, 180, 320, 3)  # a sixth of 1080p, two frames


def _jax_lines(x, ins=None):
    """forward_lines' stages through opencv_tpu, per frame where its calls
    take one image, each frame drawn on its own numpy copy.  Each stage takes
    the port's own input to it from ``ins`` (forward_lines' dict) where
    given, else the previous JAX stage's output."""
    N, H, W, _ = x.shape
    hp, cp = E.LINES_HOUGH, E.LINES_CIRCLES
    out = {}

    def inp(key):
        if ins is None:
            return out[key]
        v = ins[key]
        return v.numpy() if isinstance(v, torch.Tensor) else v

    out["gray"] = np.asarray(jcv.cvtColor(x, jcv.COLOR_BGR2GRAY))
    out["blur"] = np.asarray(jcv.GaussianBlur(inp("gray"), (5, 5), 0))
    out["edges"] = np.asarray(jcv.Canny(inp("blur"), 50, 150))
    e = inp("edges")
    out["lines"] = [jcv.HoughLines(e[i, ..., 0], hp["rho"], hp["theta"], hp["threshold"])
                    for i in range(N)]
    out["segments"] = [jcv.HoughLinesP(e[i, ..., 0], hp["rho"], hp["theta"], hp["threshold"],
                                       hp["minLineLength"], hp["maxLineGap"]) for i in range(N)]
    b = inp("blur")
    out["circles"] = [jcv.HoughCircles(b[i, ..., 0], jcv.HOUGH_GRADIENT, cp["dp"], cp["minDist"],
                                       cp["param1"], cp["param2"], cp["minRadius"],
                                       cp["maxRadius"]) for i in range(N)]
    out["lanes"] = []
    for segs in inp("segments"):
        s = np.zeros((0, 4), np.int32) if segs is None else segs.reshape(-1, 4)
        mid = (s[:, 0] + s[:, 2]) / 2
        out["lanes"].append([jcv.fitLine(half.reshape(-1, 2).astype(np.float32),
                                         jcv.DIST_HUBER, 0, 0.01, 0.01) if len(half) else None
                             for half in (s[mid < W / 2], s[mid >= W / 2])])
    out["lsd"] = jcv.createLineSegmentDetector().detect(inp("gray")[0, ..., 0])
    drawn = []
    segments, lanes, circles, lsd = (inp(k) for k in ("segments", "lanes", "circles", "lsd"))
    for i in range(N):
        img = x[i].copy()
        segs = np.zeros((0, 4), np.int32) if segments[i] is None else segments[i].reshape(-1, 4)
        for x1, y1, x2, y2 in segs:
            jcv.line(img, (x1, y1), (x2, y2), E.SEGMENT_BGR, 3)
        for fit in lanes[i]:
            ends = None if fit is None else E.lane_ends(fit, H)
            if ends is not None:
                jcv.line(img, *ends, E.LANE_BGR, 2, jcv.LINE_AA)
        circ = np.zeros((0, 3)) if circles[i] is None else circles[i].reshape(-1, 3)
        for cx, cy, r in circ:
            jcv.circle(img, (int(cx), int(cy)), int(round(float(r))), E.CIRCLE_BGR, 2)
        if i == 0 and lsd[0] is not None:
            for l in lsd[0].reshape(-1, 4):
                jcv.line(img, (int(round(l[0])), int(round(l[1]))),
                         (int(round(l[2])), int(round(l[3]))), E.LSD_BGR, 1)
        text, org, s = E.caption(len(segs), len(circ), H)
        jcv.putText(img, text, org, jcv.FONT_HERSHEY_SIMPLEX, s, E.TEXT_BGR, 2)
        drawn.append(img)
    out["drawn"] = np.stack(drawn)
    return out


def _same_results(a, b):
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_results(x, y) for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def _check_lines(got, want, what):
    """The port's lines outputs against opencv_tpu's: all exactly, but LSD's
    segments, whose f32 prefilter is the port's own: the same count, end
    points and widths within 1e-4 px."""
    for key in ("gray", "blur", "edges", "drawn"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=f"{what} {key}")
    for key in ("lines", "segments", "circles", "lanes"):
        assert _same_results(got[key], want[key]), (what, key)
    (gl, gw, gp, gn), (wl, ww, wp, wn) = got["lsd"], want["lsd"]
    assert gl.shape == wl.shape, what
    np.testing.assert_allclose(gl, wl, atol=1e-4, rtol=0)
    np.testing.assert_allclose(gw, ww, atol=1e-4, rtol=0)
    assert _same_results((gp, gn), (wp, wn))


def test_entry_road_video():
    forward, (x,) = E.entry_lines("cpu", SHAPE_LINES)
    assert forward is E.forward_lines
    video, truth = E.make_road_video(SHAPE_LINES)
    np.testing.assert_array_equal(x.numpy(), video)
    assert video.dtype == np.uint8 and video.shape == SHAPE_LINES
    assert truth["edges"].shape == (2, 4, 2, 2, 2) and 0 <= truth["dashed"] < 4
    assert truth["circles"].shape[0] == 2 and 3 <= truth["circles"].shape[1] <= 5
    assert E.SHAPE_LINES == (8, 1080, 1920, 3)
    with pytest.raises(ValueError):
        E.make_road_video((1, 60, 200, 3))


def test_lines_matches_opencv_tpu():
    """The path at (2, 180, 320, 3) against opencv_tpu's chain: every stage
    on the port's own input to it, then the whole chain.  GaussianBlur
    resolves sep_filter's u8 registration once, the Sobels of the two Canny
    calls and of HoughCircles its integer one six times, each to the plain
    tier on the CPU."""
    x, _ = E.make_road_video(SHAPE_LINES)
    reset_tier_stats()
    got = E.forward_lines(torch.from_numpy(x))
    assert tier_stats() == {"tier.sep_filter_u8.plain": 1, "tier.sep_filter_int.plain": 6}
    N, H, W, _ = SHAPE_LINES
    assert got["edges"].shape == (N, H, W, 1) and got["drawn"].shape == (N, H, W, 3)
    assert got["drawn"].dtype == torch.uint8 and len(got["segments"]) == N
    _check_lines(got, _jax_lines(x, got), "stage")
    _check_lines(got, _jax_lines(x), "chain")
    cols = [got[k].reshape(N, -1).to(torch.int64).sum(1) for k in E.LINES_SUMS]
    np.testing.assert_array_equal(got["sums"].numpy(), torch.stack(cols, 1).numpy())
    assert got["hough_stats"]["edge_pixels"] == int((got["edges"] > 0).sum())
    assert got["circle_stats"]["candidates"] >= 3 * N
    assert 0 < got["draw_writes"] <= 3 * N + 1


def test_lines_finds_the_lanes_and_circles():
    """Every marking edge long enough to gather the Hough threshold's votes
    has a segment within 3 px and 2 degrees, and every circle a detection
    within 2 px and 3 px of radius (tests/test_hough_seg.py's bound); the
    checker reports what it is given to miss."""
    x, truth = E.make_road_video(SHAPE_LINES)
    got = E.forward_lines(torch.from_numpy(x))
    assert E.road_truth_misses(got["segments"], got["circles"], truth) == []
    long = [np.hypot(*(m[1] - m[0])) >= 1.25 * E.LINES_HOUGH["threshold"]
            for m in truth["edges"][0].reshape(-1, 2, 2)]
    assert sum(long) >= 4
    misses = E.road_truth_misses([None] * 2, [None] * 2, truth)
    assert len(misses) == 2 * (sum(long) + truth["circles"].shape[1])


def test_lines_batch_equals_frames():
    """Two frames through the path at once give each frame's own outputs
    (the batched Hough helpers and the one canvas keep frames apart; LSD's
    segments are drawn on the first frame of a call only)."""
    x, _ = E.make_road_video(SHAPE_LINES)
    both = E.forward_lines(torch.from_numpy(x))
    for i in range(2):
        one = E.forward_lines(torch.from_numpy(x[i:i + 1]))
        for key in ("edges", "drawn") if i == 0 else ("edges",):
            assert torch.equal(one[key][0], both[key][i]), key
        for key in ("segments", "circles", "lanes"):
            assert _same_results(one[key][0], both[key][i]), key


def test_public_surface_lines():
    """The names the lines slice adds, each the class of its opencv_tpu
    twin."""
    for name in ("line", "rectangle", "circle", "ellipse", "ellipse2Poly", "polylines",
                 "fillPoly", "fillConvexPoly", "drawContours", "drawMarker", "arrowedLine",
                 "drawKeypoints", "drawMatches", "drawMatchesKnn", "putText", "getTextSize",
                 "getFontScaleFromHeight", "HoughLines", "HoughLinesP", "HoughCircles",
                 "HoughLinesPointSet", "HoughLinesWithAccumulator",
                 "HoughCirclesWithAccumulator", "GeneralizedHoughBallard",
                 "createGeneralizedHoughBallard", "GeneralizedHoughGuil",
                 "createGeneralizedHoughGuil", "fitLine", "createLineSegmentDetector",
                 "LineSegmentDetector", "LSD_REFINE_NONE", "LSD_REFINE_STD", "LSD_REFINE_ADV",
                 "rectangleIntersectionArea", "getClosestEllipsePoints",
                 "phaseCorrelateIterative", "filter2Dp", "findContoursLinkRuns"):
        assert hasattr(tcv, name), name
        assert getattr(tcv, name).__class__ is getattr(jcv, name).__class__, name
    assert (tcv.LSD_REFINE_NONE, tcv.LSD_REFINE_STD, tcv.LSD_REFINE_ADV) == (0, 1, 2)


# ---------------------------------------------------- cell-segmentation path
