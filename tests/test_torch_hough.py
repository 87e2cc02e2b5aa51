"""opencv_tpu_torch's Hough transforms (HoughLines, HoughLinesWithAccumulator,
HoughLinesP, HoughCircles, HoughCirclesWithAccumulator, HoughLinesPointSet,
GeneralizedHoughBallard and Guil) vs opencv_tpu and the cv2 oracle, on the
CPU.

Every output equals opencv_tpu's with ``array_equal``.  The line accumulator
equals ``opencv_tpu.ops.hough._hough_accum`` exactly at 1080p: XLA on the CPU
contracts its ``x*t0 + y*t1`` into a fused multiply-add, which the port
reproduces (without it 204 of 7.5 M votes move).  numpy's hypot is not the
correctly rounded root of ``dx² + dy²`` over the 3×3 Sobel's range, so
HoughCircles gathers numpy's own values from a table, checked here over the
whole signed range; its radius distances are numpy's hypot on the host.
Where the reference tests hold opencv_tpu to cv2 (test_hough_seg.py,
test_tail_apis4.py, test_tail_apis7.py), the port is held to cv2 under the
same bounds."""

import math

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
from opencv_tpu.ops.hough import _hough_accum
import opencv_tpu_torch as tcv
from opencv_tpu_torch.ops import hough as H
from torch_threads import _one_torch_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def _line_image(seed, shape=(120, 160), noise=0.02):
    rng = np.random.default_rng(seed)
    img = np.zeros(shape, np.uint8)
    for _ in range(3):
        p = rng.integers(0, shape[1], 2), rng.integers(0, shape[0], 2)
        cv2.line(img, (int(p[0][0]), int(p[1][0])), (int(p[0][1]), int(p[1][1])), 255, 1)
    img[rng.random(shape) < noise] = 255
    return img


# ------------------------------------------------------------ accumulator

@pytest.mark.parametrize("density", [0.02, 0.05])
def test_accumulator_equals_opencv_tpu_at_1080p(density):
    """The (180, 6001) vote table of a 1080p edge map, bit for bit."""
    e = np.random.default_rng(int(density * 100)).random((1080, 1920)) < density
    want, na, nr = _hough_accum(e, 1, np.pi / 180, 0, np.pi)
    got, na2, nr2 = H.hough_accum_batch(_t(e)[None], 1, np.pi / 180, 0, np.pi)
    assert (na, nr) == (na2, nr2) == (180, 6001)
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("rho,theta,lo,hi", [(1, np.pi / 180, 0, np.pi),
                                             (2.0, np.pi / 90, 0.1, 3.0),
                                             (0.5, np.pi / 360, 0.2, 2.9),
                                             (3.0, 0.05, 0.0, np.pi)])
def test_accumulator_grids_and_batch(rho, theta, lo, hi):
    """Other (rho, theta) grids and angle ranges; a batch of three maps
    equals each map alone."""
    rng = np.random.default_rng(7)
    e = rng.random((3, 97, 131)) < 0.05
    got, _, _ = H.hough_accum_batch(_t(e), rho, theta, lo, hi)
    for i in range(3):
        np.testing.assert_array_equal(got[i].numpy(), _hough_accum(e[i], rho, theta, lo, hi)[0])


def test_accumulator_stats_and_chunks(monkeypatch):
    """The votes come out the same when the angles are cut into chunks of
    one; the stats name the edge pixels and the chunk."""
    e = np.random.default_rng(3).random((1, 60, 80)) < 0.05
    whole, _, _ = H.hough_accum_batch(_t(e), 1, np.pi / 180, 0, np.pi)
    monkeypatch.setattr(H, "VOTE_CHUNK_BYTES", 1)
    stats = {}
    chunked, _, _ = H.hough_accum_batch(_t(e), 1, np.pi / 180, 0, np.pi, stats)
    assert torch.equal(whole, chunked)
    assert stats["edge_pixels"] == int(e.sum()) and stats["angles_per_chunk"] == 1


# ------------------------------------------------------------------ lines

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("threshold", [15, 30, 60])
def test_hough_lines_equal_opencv_tpu(seed, threshold):
    img = _line_image(seed)
    assert _same(tcv.HoughLines(_t(img), 1, np.pi / 180, threshold),
                 jcv.HoughLines(img, 1, np.pi / 180, threshold))
    assert _same(tcv.HoughLinesWithAccumulator(_t(img), 1, np.pi / 180, threshold),
                 jcv.HoughLinesWithAccumulator(img, 1, np.pi / 180, threshold))


def test_hough_lines_none_and_ranges():
    assert tcv.HoughLines(np.zeros((20, 30), np.uint8), 1, np.pi / 180, 5) is None
    img = _line_image(4)
    for args in ((2.0, np.pi / 90, 10, 0, 0, 0.3, 2.5), (1, np.pi / 180, 25, 0, 0, 1.0, 1.2)):
        assert _same(tcv.HoughLines(_t(img), *args), jcv.HoughLines(img, *args))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("min_len,max_gap", [(0, 0), (10, 3), (30, 5), (25.5, 2.5),
                                             (0, -1), (60, 20)])
def test_hough_lines_p_equals_opencv_tpu(seed, min_len, max_gap):
    img = _line_image(seed, noise=0.05)
    assert _same(tcv.HoughLinesP(_t(img), 1, np.pi / 180, 20, min_len, max_gap),
                 jcv.HoughLinesP(img, 1, np.pi / 180, 20, min_len, max_gap))


def test_hough_lines_p_batch_equals_per_image():
    """The batched helpers over three maps give each map's own result."""
    imgs = np.stack([_line_image(s, noise=0.04) for s in range(3)])
    e = _t(imgs) != 0
    lines = H.hough_lines_batch(e, 1, np.pi / 180, 20)
    segs = H.hough_lines_p_batch(e, lines, 15, 4)
    for i in range(3):
        assert _same(lines[i], jcv.HoughLines(imgs[i], 1, np.pi / 180, 20))
        assert _same(segs[i], jcv.HoughLinesP(imgs[i], 1, np.pi / 180, 20, 15, 4))


def test_hough_lines_vs_cv2():
    """tests/test_hough_seg.py::test_hough_lines and test_hough_lines_p."""
    img = np.zeros((100, 100), np.uint8)
    cv2.line(img, (10, 20), (90, 20), 255, 1)
    cv2.line(img, (50, 5), (50, 95), 255, 1)
    ref = cv2.HoughLines(img, 1, np.pi / 180, 60)
    ours = tcv.HoughLines(_t(img), 1, np.pi / 180, 60)
    rset = {(round(float(r), 1), round(float(t), 2)) for r, t in ref.reshape(-1, 2)}
    oset = {(round(float(r), 1), round(float(t), 2)) for r, t in ours.reshape(-1, 2)}
    assert rset == oset
    img = np.zeros((80, 80), np.uint8)
    cv2.line(img, (10, 40), (70, 40), 255, 1)
    segs = tcv.HoughLinesP(_t(img), 1, np.pi / 180, 40, minLineLength=30, maxLineGap=5)
    x1, y1, x2, y2 = segs.reshape(-1, 4)[0]
    assert y1 == 40 and y2 == 40 and abs(x2 - x1) >= 50


def test_hough_lines_with_accumulator_vs_cv2():
    """tests/test_tail_apis4.py::test_hough_lines_with_accumulator."""
    img = np.zeros((60, 60), np.uint8)
    cv2.line(img, (5, 30), (55, 30), 255, 1)
    cv2.line(img, (30, 5), (30, 55), 255, 1)
    ref = cv2.HoughLinesWithAccumulator(img, 1, np.pi / 180, 40)
    got = tcv.HoughLinesWithAccumulator(_t(img), 1, np.pi / 180, 40)
    assert got.shape == ref.shape
    assert np.allclose(np.sort(got.reshape(-1, 3), axis=0),
                       np.sort(np.asarray(ref).reshape(-1, 3), axis=0), atol=1e-4)


# ---------------------------------------------------------------- circles

def test_hypot_table_is_numpys_hypot():
    """The magnitude table equals np.hypot at every signed pair of a 3x3
    Sobel of 8-bit data (|dx|, |dy| <= 1020, 4.2 M pairs); the rounded root
    that the card's sqrt gives differs from np.hypot on 25,668 of them, by
    an ulp."""
    d = np.arange(-H.SOBEL3_MAX, H.SOBEL3_MAX + 1, dtype=np.float64)
    dx, dy = np.meshgrid(d, d)
    want = np.hypot(dx, dy)
    tab = H._hypot_table(torch.device("cpu")).numpy()
    a, b = np.abs(dx).astype(np.int64), np.abs(dy).astype(np.int64)
    np.testing.assert_array_equal(tab[a * (H.SOBEL3_MAX + 1) + b], want)
    root = np.sqrt(dx * dx + dy * dy)
    assert np.count_nonzero(root != want) == 25668
    assert np.abs(root - want).max() <= np.spacing(want.max())


def _circle_image(seed, shape=(90, 130)):
    rng = np.random.default_rng(seed)
    c = (rng.random(shape) * 40 + 60).astype(np.uint8)
    for _ in range(3):
        cv2.circle(c, (int(rng.integers(20, shape[1] - 20)), int(rng.integers(20, shape[0] - 20))),
                   int(rng.integers(8, 25)), 230, int(rng.choice([2, -1])))
    return cv2.GaussianBlur(c, (5, 5), 1)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("dp", [1, 1.5, 2])
def test_hough_circles_equal_opencv_tpu(seed, dp):
    img = _circle_image(seed)
    for kw in (dict(param2=20, minRadius=8, maxRadius=40), dict(param2=8)):
        assert _same(tcv.HoughCircles(_t(img), 3, dp, 15, param1=80, **kw),
                     jcv.HoughCircles(img, 3, dp, 15, param1=80, **kw))
        assert _same(tcv.HoughCirclesWithAccumulator(_t(img), 3, dp, 15, param1=80, **kw),
                     jcv.HoughCirclesWithAccumulator(img, 3, dp, 15, param1=80, **kw))


def test_hough_circles_batch_and_chunks(monkeypatch):
    """The batched helper over three images gives each image's own result,
    with the radii cut into chunks of one too."""
    imgs = np.stack([_circle_image(s) for s in range(3)])
    want = [jcv.HoughCircles(im, 3, 1, 15, param1=80, param2=15, minRadius=8, maxRadius=40)
            for im in imgs]
    got = H.hough_circles_batch(_t(imgs[..., None]), 1, 15, 80, 15, 8, 40)
    monkeypatch.setattr(H, "VOTE_CHUNK_BYTES", 1)
    stats = {}
    chunked = H.hough_circles_batch(_t(imgs[..., None]), 1, 15, 80, 15, 8, 40, stats=stats)
    assert stats["radii_per_chunk"] == 1
    for g, c, w in zip(got, chunked, want):
        assert _same(g, w) and _same(c, w)


def test_hough_circles_refuses_what_it_cannot_take():
    with pytest.raises(ValueError):
        tcv.HoughCircles(_t(np.zeros((20, 20, 3), np.uint8)), 3, 1, 10)
    with pytest.raises(ValueError):
        tcv.HoughCircles(_t(np.zeros((20, 20), np.float32)), 3, 1, 10)


def test_hough_circles_vs_cv2():
    """tests/test_hough_seg.py::test_hough_circles and
    tests/test_tail_apis7.py::test_hough_circles_with_accumulator."""
    img = np.zeros((100, 100), np.uint8)
    cv2.circle(img, (50, 50), 20, 255, 2)
    img = cv2.GaussianBlur(img, (5, 5), 1)
    x, y, r = tcv.HoughCircles(_t(img), 3, 1, 30, param1=100, param2=20, minRadius=10,
                               maxRadius=40).reshape(-1, 3)[0]
    assert abs(x - 50) <= 2 and abs(y - 50) <= 2 and abs(r - 20) <= 3
    img = np.zeros((64, 64), np.uint8)
    cv2.circle(img, (32, 32), 14, 255, 2)
    got = tcv.HoughCirclesWithAccumulator(_t(img), 3, 1, 20, param1=100, param2=20,
                                          minRadius=8, maxRadius=20)
    assert got is not None and got.shape[2] == 4
    x, y, r, v = got[0, 0]
    assert abs(x - 32) <= 2 and abs(y - 32) <= 2 and abs(r - 14) <= 2 and v > 0


# ------------------------------------------------------------- point sets

@pytest.mark.parametrize("args", [(10, 5, 0, 200, 1, 0, np.pi, np.pi / 180),
                                  (20, 3, -50, 150, 2.5, 0.1, 3.0, 0.02),
                                  (5, 1, 0.0, 150.0, 1.0, 0.0, np.pi, np.pi / 180),
                                  (50, 100, 0, 100, 1, 0, np.pi, np.pi / 180)])
def test_hough_lines_point_set_equals_opencv_tpu(args):
    rng = np.random.default_rng(0)
    pts = np.concatenate([np.stack([np.arange(50), 2 * np.arange(50) + 3], 1),
                          rng.uniform(0, 100, (40, 2))]).astype(np.float32)
    assert _same(tcv.HoughLinesPointSet(_t(pts), *args), jcv.HoughLinesPointSet(pts, *args))


def test_hough_lines_point_set_vs_cv2():
    """tests/test_hough_seg.py::test_hough_lines_point_set."""
    rng = np.random.default_rng(0)
    t = np.linspace(0, 1, 40)
    pts = np.stack([10 + 80 * t, 20 + 40 * t], -1) + rng.normal(0, 0.3, (40, 2))
    pts32 = pts.astype(np.float32).reshape(-1, 1, 2)
    args = (5, 1, 0.0, 150.0, 1.0, 0.0, np.pi, np.pi / 180)
    ref = cv2.HoughLinesPointSet(pts32, *args).reshape(-1, 3)
    ours = tcv.HoughLinesPointSet(_t(pts32), *args).reshape(-1, 3)
    np.testing.assert_allclose(ours[0], ref[0], atol=1e-5)


# ------------------------------------------------------------ generalized

def _templ_scene():
    templ = np.zeros((40, 40), np.uint8)
    cv2.rectangle(templ, (10, 10), (30, 30), 255, 2)
    cv2.circle(templ, (20, 20), 5, 128, -1)
    scene = np.zeros((90, 100), np.uint8)
    cv2.rectangle(scene, (40, 45), (60, 65), 255, 2)
    cv2.circle(scene, (50, 55), 5, 128, -1)
    cv2.rectangle(scene, (5, 5), (25, 25), 255, 2)
    return templ, scene


@pytest.mark.parametrize("votes,dp,center", [(10, 1.0, None), (30, 1.0, None),
                                             (10, 2.0, None), (10, 1.0, (18, 22))])
def test_ballard_equals_opencv_tpu(votes, dp, center):
    templ, scene = _templ_scene()
    out = []
    for mod, img in ((jcv, lambda a: a), (tcv, _t)):
        g = mod.createGeneralizedHoughBallard()
        g.setVotesThreshold(votes)
        g.setMinDist(5)
        g.setDp(dp)
        g.setTemplate(img(templ), center)
        out.append(g.detect(img(scene)))
    assert out[0][0] is not None and _same(out[1], out[0])


def test_ballard_finds_nothing_as_opencv_tpu():
    templ, scene = _templ_scene()
    g = tcv.createGeneralizedHoughBallard()
    g.setVotesThreshold(10 ** 6)
    g.setTemplate(_t(templ))
    assert g.detect(_t(scene)) == (None, None)


@pytest.mark.parametrize("angles,scales", [((0, 30, 10), (0.8, 1.2, 0.1)),
                                           ((0, 0, 10), (1.0, 1.0, 0.5)),
                                           ((350, 360, 5), (0.9, 1.0, 0.05))])
def test_guil_equals_opencv_tpu(angles, scales):
    templ, scene = _templ_scene()
    out = []
    for mod, img in ((jcv, lambda a: a), (tcv, _t)):
        g = mod.createGeneralizedHoughGuil()
        g.setMinAngle(angles[0])
        g.setMaxAngle(angles[1])
        g.setAngleStep(angles[2])
        g.setMinScale(scales[0])
        g.setMaxScale(scales[1])
        g.setScaleStep(scales[2])
        g.setPosThresh(15)
        g.setMinDist(10)
        g.setTemplate(img(templ))
        out.append(g.detect(img(scene)))
    assert _same(out[1], out[0])


def test_generalized_hough_vs_cv2():
    """tests/test_hough_seg.py::test_generalized_hough_ballard and
    tests/test_tail_apis7.py::test_generalized_hough_guil_surface."""
    tpl = np.zeros((40, 40), np.uint8)
    cv2.rectangle(tpl, (10, 10), (30, 30), 255, 2)
    scene = np.zeros((120, 160), np.uint8)
    cv2.rectangle(scene, (60, 50), (80, 70), 255, 2)
    gh_r = cv2.createGeneralizedHoughBallard()
    gh_r.setTemplate(tpl)
    pos_r, v_r = gh_r.detect(scene)
    gh_o = tcv.createGeneralizedHoughBallard()
    gh_o.setTemplate(_t(tpl))
    gh_o.setVotesThreshold(60)
    gh_o.setMinDist(10)
    pos_o, v_o = gh_o.detect(_t(scene))
    np.testing.assert_allclose(pos_o.reshape(-1, 4)[0], pos_r.reshape(-1, 4)[0], atol=1e-6)
    assert v_o.reshape(-1, 3)[0][0] == v_r.reshape(-1, 3)[0][0]
    g = tcv.createGeneralizedHoughGuil()
    for name, v in (("MinAngle", 0), ("MaxAngle", 0), ("AngleStep", 10), ("MinScale", 1.0),
                    ("MaxScale", 1.0), ("ScaleStep", 0.5), ("PosThresh", 20), ("MinDist", 10)):
        getattr(g, "set" + name)(v)
    g.setTemplate(_t(tpl))
    scene = np.zeros((90, 90), np.uint8)
    cv2.rectangle(scene, (40, 45), (60, 65), 255, 2)
    pos, votes = g.detect(_t(scene))
    assert abs(pos[0, 0, 0] - 50) <= 3 and abs(pos[0, 0, 1] - 55) <= 3
    assert (g.getMinAngle(), g.getMaxAngle(), g.getAngleStep()) == (0, 0, 10)
    assert (g.getMinScale(), g.getMaxScale(), g.getScaleStep()) == (1.0, 1.0, 0.5)


def test_pairs_match_bins():
    """Every (scene pixel, displacement) pair _pairs lists has matching
    bins, and it lists all of them."""
    rng = np.random.default_rng(5)
    scene, templ = rng.integers(0, 12, 50), rng.integers(0, 12, 30)
    for shift in (0, 5):
        i, j = H._pairs(scene, templ, 12, shift)
        assert np.all((templ[j] + shift) % 12 == scene[i])
        want = sorted((a, b) for a in range(50) for b in range(30)
                      if (templ[b] + shift) % 12 == scene[a])
        assert sorted(zip(i.tolist(), j.tolist())) == want
    assert math.isclose(H._dev_scalar(2.5, "cpu").item(), 2.5)
