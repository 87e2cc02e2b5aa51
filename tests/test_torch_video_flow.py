"""The port's flow pyramid, .flo IO, pyramidal Lucas-Kanade and Farnebäck
(``opencv_tpu_torch.video``) on the CPU, against ``opencv_tpu.video`` and
cv2.

- buildOpticalFlowPyramid and the .flo files: exact (a file written by
  either package reads back identically in the other).
- LK: the derivative and the bilinear windows exact against the JAX
  package's eager functions; with the window sums taken in XLA's order (one
  after another) the whole of calcOpticalFlowPyrLK (one level, four
  iterations: each eager op compiles once per shape) equals the JAX package
  run under ``jax.disable_jit()``.  The port sums each window in a fixed
  binary tree (the same on the card), and the JAX package jits the level
  (contracting multiply-adds), so against its jitted program: at least
  LK_SHARE of the points within LK_TOL px and the status equal on at least
  LK_SHARE of them (ROADMAP.md queue C).
- Farnebäck: the expansion, the pyramid's blur and resize, the matrix
  update and the solve exact against the JAX package's eager functions; the
  box blur's prefix sums are f64 in the port (f32 in the JAX package)
  within BOX_RTOL of the level's largest value (measured 2.9e-6 at
  120×160: the JAX package's f32 prefixes cancel); the flow of one level
  against the JAX package's jitted program within FLOW_TOL px on at least
  FLOW_SHARE of the pixels (ROADMAP.md queue C; three levels in
  tests/test_torch_slice_video.py).
- cv2: the reference tests' bounds (tests/test_video.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
from opencv_tpu.video import farneback as jfb
from opencv_tpu.video import lk as jlk
import opencv_tpu_torch as tcv
from opencv_tpu_torch import entry as E
from opencv_tpu_torch.video import farneback as tfb
from opencv_tpu_torch.video import lk as tlk
from torch_threads import _one_torch_thread  # noqa: F401

LK_TOL = 1e-3
LK_SHARE = 0.99
FLOW_TOL = 1e-3
FLOW_SHARE = 0.999
BOX_RTOL = 1e-5


@pytest.fixture(scope="module")
def frames():
    """Gray frames 0-2 of a (3, 120, 160) shaking video with movers."""
    video, shifts, _ = E.make_motion_video((3, 120, 160, 3))
    return [cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) for f in video], shifts


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("deriv", [True, False])
def test_build_optical_flow_pyramid_equals_opencv_tpu(frames, channels, deriv):
    g = frames[0][0][:41, :53]
    img = g if channels == 1 else np.stack([g, g[::-1], 255 - g], -1)
    levels = 1 if channels == 1 else 0
    rt, got = tcv.buildOpticalFlowPyramid(torch.from_numpy(img), (5, 5), levels,
                                          withDerivatives=deriv)
    rj, want = jcv.buildOpticalFlowPyramid(img, (5, 5), levels, withDerivatives=deriv)
    stop = tcv.buildOpticalFlowPyramid(torch.from_numpy(img), (21, 21), 3, withDerivatives=False)
    assert stop[0] == jcv.buildOpticalFlowPyramid(img, (21, 21), 3, withDerivatives=False)[0]
    assert rt == rj and len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b)


def test_flo_files_round_trip_between_the_packages(tmp_path):
    flow = np.random.default_rng(0).standard_normal((17, 23, 2)).astype(np.float32)
    a, b = str(tmp_path / "port.flo"), str(tmp_path / "jax.flo")
    assert tcv.writeOpticalFlow(a, torch.from_numpy(flow))
    assert jcv.writeOpticalFlow(b, flow)
    assert open(a, "rb").read() == open(b, "rb").read()
    for path in (a, b):
        got, want = tcv.readOpticalFlow(path), jcv.readOpticalFlow(path)
        assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
        assert np.array_equal(got, flow)
    bad = tmp_path / "bad.flo"
    bad.write_bytes(b"nope")
    assert tcv.readOpticalFlow(str(bad)) is None and jcv.readOpticalFlow(str(bad)) is None
    assert not tcv.writeOpticalFlow(a, flow[..., 0])


def test_lk_parts_equal_the_eager_jax_functions(frames):
    img = frames[0][0].astype(np.float32)
    jdx, jdy = jlk._scharr_deriv(jnp.asarray(img))
    tdx, tdy = tlk._scharr_deriv(torch.from_numpy(img))
    assert np.array_equal(np.asarray(jdx), tdx.numpy())
    assert np.array_equal(np.asarray(jdy), tdy.numpy())
    rng = np.random.default_rng(0)
    cx = rng.uniform(-5, 165, 40).astype(np.float32)
    cy = rng.uniform(-5, 125, 40).astype(np.float32)
    want = jlk._bilinear_window(jnp.asarray(img), jnp.asarray(cx), jnp.asarray(cy), 10)
    got = tlk._bilinear_window(torch.from_numpy(img), torch.from_numpy(cx),
                               torch.from_numpy(cy), 10)
    assert np.array_equal(np.asarray(want), got.numpy())


def _lk_points(g0):
    return cv2.goodFeaturesToTrack(g0, 40, 0.01, 7, blockSize=7).astype(np.float32)


def test_lk_in_xla_order_equals_the_eager_jax_program(frames, monkeypatch):
    (g0, g1, _), _ = frames
    pts = _lk_points(g0)

    def sum_in_order(a):
        v = a.reshape(a.shape[0], -1)
        s = v[:, 0]
        for i in range(1, v.shape[1]):
            s = s + v[:, i]
        return s

    crit = (3, 4, 0.01)
    with jax.disable_jit():
        want = jcv.calcOpticalFlowPyrLK(g0, g1, pts, None, (21, 21), 0, crit)
    monkeypatch.setattr(tlk, "_wsum", sum_in_order)
    got = tcv.calcOpticalFlowPyrLK(torch.from_numpy(g0), torch.from_numpy(g1), pts, None,
                                   (21, 21), 0, crit)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_lk_tree_sum_is_the_sum(frames):
    a = torch.from_numpy(np.random.default_rng(2).standard_normal((30, 21, 21)).astype(np.float32))
    np.testing.assert_allclose(tlk._wsum(a).numpy(), a.double().sum(dim=(1, 2)).numpy(),
                               rtol=1e-5, atol=1e-4)
    # 2x2: the flat (a00, a01, a10, a11) halved pairwise
    assert torch.equal(tlk._wsum(a[:, :2, :2]),
                       (a[:, 0, 0] + a[:, 1, 0]) + (a[:, 0, 1] + a[:, 1, 1]))


def test_lk_against_the_jitted_jax_program(frames):
    """Frames 0 and 2, whose camera moved (12, -9) px, at cv2's defaults
    (three levels; at 120 rows the window's rule keeps two below level 0)."""
    (g0, _, g2), shifts = frames
    pts = _lk_points(g0)
    want_p, want_s, want_e = jcv.calcOpticalFlowPyrLK(g0, g2, pts)
    got_p, got_s, got_e = tcv.calcOpticalFlowPyrLK(g0, torch.from_numpy(g2), pts)
    d = np.abs(got_p - want_p).max(axis=(1, 2))
    assert (d <= LK_TOL).mean() >= LK_SHARE, d.max()
    assert (got_s == want_s).mean() >= LK_SHARE
    assert np.array_equal(got_e, want_e)
    ok = got_s[:, 0] == 1
    med = np.median(got_p[ok, 0] - pts[ok, 0], axis=0)
    assert np.abs(med - shifts[2]).max() < 0.05


def test_lk_matches_cv2_and_the_class_api():
    """tests/test_video.py::test_lk_translation's scene and bound."""
    rng = np.random.default_rng(1)
    base = cv2.GaussianBlur(rng.integers(0, 256, (120, 160), np.uint8), (5, 5), 1.5)
    M = np.float32([[1, 0, 3.0], [0, 1, 2.0]])
    nxt = cv2.warpAffine(base, M, (160, 120))
    pts = cv2.goodFeaturesToTrack(base, 30, 0.05, 10).astype(np.float32)
    ref_p, ref_s, _ = cv2.calcOpticalFlowPyrLK(base, nxt, pts, None)
    of = tcv.SparsePyrLKOpticalFlow_create()
    assert of.getWinSize() == (21, 21) and of.getMaxLevel() == 3
    our_p, our_s, _ = of.calc(torch.from_numpy(base), torch.from_numpy(nxt), pts)
    ok = (ref_s.ravel() > 0) & (our_s.ravel() > 0)
    assert ok.sum() >= 0.8 * len(pts)
    d = np.abs(ref_p.reshape(-1, 2)[ok] - our_p.reshape(-1, 2)[ok])
    assert np.median(d) < 0.5
    empty = tcv.calcOpticalFlowPyrLK(base, nxt, np.zeros((0, 1, 2), np.float32))
    assert [a.shape for a in empty] == [(0, 1, 2), (0, 1), (0, 1)]


def test_farneback_parts_equal_the_eager_jax_functions(frames):
    (g0, g1, _), _ = frames
    i0, i1 = g0.astype(np.float32), g1.astype(np.float32)
    t0, t1 = torch.from_numpy(i0), torch.from_numpy(i1)
    # none of these is jitted: each jnp call runs on its own (the taps'
    # einsum is XLA's chain of fused multiply-adds, which the port takes)
    if True:
        j0 = jfb._poly_exp(jnp.asarray(i0), 5, 1.2)
        j1 = jfb._poly_exp(jnp.asarray(i1), 5, 1.2)
        r0, r1 = tfb._poly_exp(t0, 5, 1.2), tfb._poly_exp(t1, 5, 1.2)
        assert np.array_equal(np.asarray(j0), r0.numpy())
        flow = np.random.default_rng(0).uniform(-3, 3, (120, 160, 2)).astype(np.float32)
        jm = jfb._update_matrices(j0, j1, jnp.asarray(flow))
        H, W = flow.shape[:2]
        scale = torch.from_numpy(tfb._border_scale(H)[:, None] * tfb._border_scale(W)[None, :])
        tm = tfb._update_matrices(r0, r1, torch.from_numpy(flow), scale)
        assert np.array_equal(np.asarray(jm), tm.numpy())
        jb = np.asarray(jfb._box_blur_m(jm, 7))
        tb = tfb._box_blur_m(tm, 7, torch.tensor(225.0)).numpy()
        assert np.abs(jb - tb).max() <= BOX_RTOL * np.abs(jb).max()
        js = jfb._solve_flow(jnp.asarray(tb))
        assert np.array_equal(np.asarray(js),
                              tfb._solve_flow(torch.from_numpy(tb), torch.tensor(1e-3)).numpy())
        for ks, sigma in ((3, 0.5), (9, 1.5), (19, 3.5)):
            assert np.array_equal(np.asarray(jfb._gaussian_blur_f32(jnp.asarray(i0), ks, sigma)),
                                  tfb._gaussian_blur_f32(t0, ks, sigma).numpy())
        small = flow[:48, :64]
        for w, h in ((57, 33),):
            assert np.array_equal(np.asarray(jfb._resize_linear(jnp.asarray(small), w, h)),
                                  tfb._resize_linear(torch.from_numpy(small), w, h).numpy())


def test_farneback_against_the_jitted_jax_program(frames):
    (g0, g1, _), _ = frames
    # one level (one compile of the JAX package's level); the pyramid's
    # blur and resize are held exactly above, and three levels in
    # tests/test_torch_slice_video.py
    args = (0.5, 0, 15, 3, 5, 1.2, 0)
    want = jcv.calcOpticalFlowFarneback(g0, g1, None, *args)
    got = tcv.calcOpticalFlowFarneback(torch.from_numpy(g0), torch.from_numpy(g1), None, *args)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    d = np.abs(got.numpy() - want).max(axis=-1)
    assert (d <= FLOW_TOL).mean() >= FLOW_SHARE, (d > FLOW_TOL).mean()
    # the initial-flow flag: the same resize and scale of the given flow
    init = np.full(want.shape, 0.5, np.float32)
    want = jcv.calcOpticalFlowFarneback(g0, g1, init, *args[:-1], 4)
    got = tcv.calcOpticalFlowFarneback(g0, g1, torch.from_numpy(init), *args[:-1], 4)
    d = np.abs(got.numpy() - want).max(axis=-1)
    assert (d <= FLOW_TOL).mean() >= FLOW_SHARE, (d > FLOW_TOL).mean()


def test_farneback_matches_cv2_and_the_class_api():
    """tests/test_video.py::test_farneback_matches_cv2's scene and bounds."""
    rng = np.random.default_rng(0)
    base = rng.random((140, 180)).astype(np.float32)
    base = cv2.GaussianBlur(base, (0, 0), 3) * 255
    H, W = 96, 128
    dx, dy = 3.2, -1.7
    prev = base[20:20 + H, 25:25 + W].astype(np.uint8)
    M2 = np.float32([[1, 0, -dx], [0, 1, -dy]])
    warped = cv2.warpAffine(base, M2, (base.shape[1], base.shape[0]))
    nxt = warped[20:20 + H, 25:25 + W].astype(np.uint8)
    args = (0.5, 3, 15, 3, 5, 1.2, 0)
    ref = cv2.calcOpticalFlowFarneback(prev, nxt, None, *args)
    ours = tcv.calcOpticalFlowFarneback(prev, nxt, None, *args).numpy()
    assert ours.shape == ref.shape and ours.dtype == np.float32
    inner = (slice(10, -10), slice(10, -10))
    d = np.linalg.norm(ref[inner] - ours[inner], axis=-1)
    assert np.median(d) < 0.35 and np.percentile(d, 95) < 0.8
    assert np.sign(np.median(ours[inner][..., 0])) == np.sign(np.median(ref[inner][..., 0]))
    of = tcv.FarnebackOpticalFlow_create(numLevels=2, winSize=13, numIters=2)
    f = of.calc(prev, prev)
    assert tuple(f.shape) == (96, 128, 2) and float(f.abs().max()) < 0.5
