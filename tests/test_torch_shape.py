"""opencv_tpu_torch's shape module (moments, connectedComponents and its
stats, distanceTransform, distanceTransformWithLabels) vs opencv_tpu and the
cv2 oracle, on the CPU.

Tolerances: moments within rel 1e-12 of cv2 (f64 sums on the device) and
within the reference test's f32 error of opencv_tpu (rel 1e-5, abs 1e-6;
on a float image, opencv_tpu's own distance from cv2);
labels, counts and stats ``array_equal`` with both for 4- and
8-connectivity, centroids within 1e-9 relative of opencv_tpu's numpy means;
the chamfer distances within 1e-5 of opencv_tpu (the same f32 fixpoint) and
the reference test's 1e-3 of cv2; DIST_MASK_PRECISE within 1e-4 of both;
distanceTransformWithLabels ``array_equal`` with opencv_tpu.  Deliberate
divergences: moments in f64, held to cv2 on an image where opencv_tpu's f32
row sums are off; DIST_MASK_PRECISE in row chunks at a shape where
opencv_tpu would hold an (N, H, W, W) array of more than 1 GB."""

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu_torch.ops import shape as S


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(got, want):
    return abs(got - want) / max(1.0, abs(want))


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("shape,dtype", [((32, 40), np.uint8), ((17, 23), np.uint16),
                                         ((20, 30), np.float32)])
def test_moments(shape, dtype, binary):
    rng = np.random.default_rng(20)
    img = (rng.random(shape) * (255 if dtype != np.float32 else 1)).astype(dtype)
    img[rng.random(shape) > 0.7] = 0
    got = tcv.moments(_t(img), binary)
    want = jcv.moments(img, binary)
    ref = cv2.moments(img, binary)
    assert set(got) == set(ref)
    for k in ref:
        assert _rel(got[k], ref[k]) <= 1e-12, (k, got[k], ref[k])
        # the reference test's bound; on a float image opencv_tpu's f32
        # products x^p·I are off cv2 by more, and the port is held to that
        bound = max(1e-6, abs(want[k]) * 1e-5)
        if dtype == np.float32:
            bound = max(bound, 1.01 * abs(want[k] - ref[k]) + 1e-12 * abs(ref[k]))
        assert abs(got[k] - want[k]) <= bound, (k, got[k], want[k])


def test_moments_f64_where_opencv_tpu_f32_is_off():
    """A 1920-wide image: x³·I reaches 1.8e12, past f32's 2^24, so the JAX
    package's f32 row sums lose bits that the port's f64 sums keep."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (16, 1920), np.uint8)
    got, want, ref = tcv.moments(img), jcv.moments(img), cv2.moments(img)
    for k in ("m30", "m21", "m20", "mu30"):
        assert _rel(got[k], ref[k]) <= 1e-12, k
    assert _rel(want["m30"], ref["m30"]) > 1e-9


@pytest.mark.parametrize("pts", [
    np.array([[10, 10], [50, 12], [55, 40], [12, 45]], np.int32).reshape(-1, 1, 2),
    np.array([[0, 0], [30, 0], [30, 20], [10, 30]], np.int32),
    np.array([[1.5, 2.0], [40.25, 3.0], [20.0, 33.5]], np.float32).reshape(-1, 1, 2)])
def test_moments_of_contours(pts):
    got, want, ref = tcv.moments(_t(pts)), jcv.moments(pts), cv2.moments(pts)
    assert got == want
    for k in ref:
        assert _rel(got[k], ref[k]) <= 1e-9, k


def test_raw_moments_batch_equals_per_plane():
    rng = np.random.default_rng(6)
    batch = (rng.random((3, 24, 31)) > 0.6).astype(np.uint8) * 255
    raw = S.raw_moments(_t(batch), binaryImage=True)
    assert raw.shape == (3, 10) and raw.dtype == torch.float64
    for i in range(3):
        assert S.moments_dict(raw[i].numpy()) == tcv.moments(batch[i], True)


def _shapes():
    """Masks whose components meet in a 2×2 block or touch diagonally:
    U shapes, a snake, diagonal runs, odd sizes."""
    u = np.zeros((40, 50), np.uint8)
    u[5:35, 5:10] = u[5:35, 40:45] = u[30:35, 5:45] = 255
    u[12:20, 20:30] = 255
    snake = np.zeros((41, 41), np.uint8)
    snake[::4] = 255
    for i in range(0, 40, 8):
        snake[i:i + 4, 40] = 255
        snake[i + 4:i + 8, 0] = 255
    diag = np.zeros((23, 31), np.uint8)
    for k in range(0, 20, 3):
        diag[np.arange(k, 20), np.arange(0, 20 - k) + k // 2] = 255
    checker = np.zeros((9, 11), np.uint8)
    checker[::2, ::2] = checker[1::2, 1::2] = 255
    blocks = np.zeros((15, 17), np.uint8)
    blocks[1:3, 1:3] = blocks[3:5, 3:5] = blocks[2, 6] = blocks[6:9, 0] = 255
    return {"u": u, "snake": snake, "diag": diag, "checker": checker, "blocks": blocks}


SHAPES = _shapes()


@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("name", list(SHAPES) + ["rand48x64", "rand47x63", "rand33x41",
                                                 "rand1x37", "rand29x1"])
def test_connected_components(name, conn):
    if name in SHAPES:
        img = SHAPES[name]
    else:
        h, w = map(int, name[4:].split("x"))
        img = (np.random.default_rng(h * w).random((h, w)) > 0.55).astype(np.uint8) * 255
    n, labels = tcv.connectedComponents(_t(img), conn)
    jn, jl = jcv.connectedComponents(img, conn)
    rn, rl = cv2.connectedComponents(img, connectivity=conn)
    assert n == jn == rn
    assert labels.dtype == torch.int32
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(labels.numpy(), rl)


@pytest.mark.parametrize("conn", [4, 8])
def test_components_batch_and_steps(conn):
    rng = np.random.default_rng(9)
    batch = np.stack([(rng.random((30, 37)) > p).astype(np.uint8) for p in (0.3, 0.5, 0.7)])
    batch[1] = 0
    steps = {}
    labels, counts = S.components_batch(_t(batch), conn, steps)
    for i in range(3):
        jn, jl = jcv.connectedComponents(batch[i] * 255, conn)
        assert int(counts[i]) + 1 == jn
        np.testing.assert_array_equal(labels[i].numpy(), np.asarray(jl))
    # pointer jumping and hooking: a few steps where the flood needs ~the
    # components' diameter, and one convergence read per CC_CHECK_EVERY
    assert steps["steps"] == steps["checks"] * S.CC_CHECK_EVERY
    assert steps["checks"] <= 4
    snake = {}
    S.components_batch(_t(SHAPES["snake"])[None], conn, snake)
    assert snake["steps"] < 41 * 5 // 2


def test_connected_components_with_stats():
    rng = np.random.default_rng(22)
    for shape, p in (((32, 40), 0.75), ((21, 27), 0.4), ((12, 12), 0.0)):
        img = (rng.random(shape) > p).astype(np.uint8) * 255
        n, labels, stats, cents = tcv.connectedComponentsWithStats(_t(img))
        jn, jl, js, jc = jcv.connectedComponentsWithStats(img)
        rn, rl, rs, rc = cv2.connectedComponentsWithStats(img)
        assert n == jn == rn
        assert stats.dtype == torch.int32 and cents.dtype == torch.float64
        np.testing.assert_array_equal(stats.numpy(), js)
        np.testing.assert_allclose(cents.numpy(), jc, rtol=1e-9, atol=0)
        if (img == 0).any():  # cv2 fills an empty background row with sentinels
            np.testing.assert_array_equal(stats.numpy(), rs)
            np.testing.assert_allclose(cents.numpy(), rc, rtol=1e-9)
    n4 = tcv.connectedComponentsWithStats(SHAPES["checker"], 4)
    j4 = jcv.connectedComponentsWithStats(SHAPES["checker"], 4)
    np.testing.assert_array_equal(n4[2].numpy(), j4[2])


def test_component_stats_batch_pads_with_zeros():
    batch = np.zeros((2, 10, 12), np.uint8)
    batch[0, 2:4, 3:7] = batch[0, 7:9, 1:2] = 255
    batch[1, 5, 5] = 255
    labels, counts = S.components_batch(_t(batch))
    stats, cents = S.component_stats(labels, int(counts.max()) + 1)
    assert stats.shape == (2, 3, 5)
    np.testing.assert_array_equal(stats[0].numpy(), cv2.connectedComponentsWithStats(batch[0])[2])
    np.testing.assert_array_equal(stats[1, :2].numpy(),
                                  cv2.connectedComponentsWithStats(batch[1])[2])
    assert not stats[1, 2].any() and not cents[1, 2].any()


def test_cc_with_algorithm():
    rng = np.random.default_rng(2)
    a = (rng.random((20, 25)) > 0.5).astype(np.uint8) * 255
    n, lab = tcv.connectedComponentsWithAlgorithm(a, 8, 4, 0)
    jn, jl = jcv.connectedComponentsWithAlgorithm(a, 8, 4, 0)
    assert n == jn
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jl))
    got = tcv.connectedComponentsWithStatsWithAlgorithm(a, 4, 4, 0)
    want = jcv.connectedComponentsWithStatsWithAlgorithm(a, 4, 4, 0)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[2].numpy(), want[2])


@pytest.mark.parametrize("dt,ms", [("DIST_L1", 3), ("DIST_C", 3), ("DIST_L2", 3),
                                   ("DIST_L2", 5), ("DIST_L1", 5), ("DIST_C", 5)])
def test_distance_transform(dt, ms):
    rng = np.random.default_rng(23)
    img = (rng.random((40, 50)) > 0.05).astype(np.uint8) * 255
    steps = {}
    got = tcv.distanceTransform(_t(img), getattr(tcv, dt), ms, stats=steps)
    assert got.dtype == torch.float32
    want = np.asarray(jcv.distanceTransform(img, getattr(jcv, dt), ms))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    ref = cv2.distanceTransform(img, getattr(cv2, dt), ms)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3, rtol=0)
    assert steps["steps"] == steps["checks"] * S.DT_CHECK_EVERY


def test_distance_transform_batch_and_blob():
    rng = np.random.default_rng(24)
    batch = np.full((3, 36, 44, 1), 255, np.uint8)
    batch[0, 10:12, 5:9] = 0
    batch[1] = (rng.random((36, 44, 1)) > 0.1) * 255
    batch[2, 0, 0] = 0
    got = tcv.distanceTransform(_t(batch), tcv.DIST_L2, 3)
    want = np.asarray(jcv.distanceTransform(batch, jcv.DIST_L2, 3))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape,p", [((64, 80), 0.02), ((31, 57), 0.3), ((20, 20), 0.999)])
def test_distance_transform_precise(shape, p):
    img = (np.random.default_rng(0).random(shape) > p).astype(np.uint8) * 255
    got = tcv.distanceTransform(_t(img), tcv.DIST_L2, tcv.DIST_MASK_PRECISE).numpy()
    want = np.asarray(jcv.distanceTransform(img, jcv.DIST_L2, jcv.DIST_MASK_PRECISE))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    if (img == 0).any():
        ref = cv2.distanceTransform(img, cv2.DIST_L2, cv2.DIST_MASK_PRECISE)
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_distance_transform_precise_in_row_chunks():
    """A divergence in memory only: at (1, 300, 1024) the JAX package would
    hold an (N, H, W, W) f32 array of 1.26 GB; the port takes the rows in
    chunks of a (rows, W, W) array within 256 MiB on the CPU, and equals cv2's
    exact transform."""
    H, W = 300, 1024
    assert H * W * W * 4 > 1 << 30
    rows = S._precise_chunk_rows(W, torch.device("cpu"))
    assert rows * W * W * 4 <= 256 << 20 and rows < H
    rng = np.random.default_rng(1)
    img = np.full((H, W), 255, np.uint8)
    img[rng.integers(0, H, 40), rng.integers(0, W, 40)] = 0
    got = tcv.distanceTransform(img, tcv.DIST_L2, tcv.DIST_MASK_PRECISE).numpy()
    ref = cv2.distanceTransform(img, cv2.DIST_L2, cv2.DIST_MASK_PRECISE)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dt", ["DIST_L2", "DIST_L1", "DIST_C"])
@pytest.mark.parametrize("lt", ["DIST_LABEL_PIXEL", "DIST_LABEL_CCOMP"])
def test_distance_transform_with_labels(dt, lt):
    rng = np.random.default_rng(0)
    a = (rng.random((40, 50)) > 0.05).astype(np.uint8) * 255
    got_d, got_l = tcv.distanceTransformWithLabels(_t(a), getattr(tcv, dt), 5, getattr(tcv, lt))
    want_d, want_l = jcv.distanceTransformWithLabels(a, getattr(jcv, dt), 5, getattr(jcv, lt))
    assert got_d.dtype == torch.float32 and got_l.dtype == torch.int32
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    np.testing.assert_array_equal(got_l.numpy(), want_l)
    if lt == "DIST_LABEL_PIXEL":
        ref_d, ref_l = cv2.distanceTransformWithLabels(a, getattr(cv2, dt), 5,
                                                       labelType=cv2.DIST_LABEL_PIXEL)
        np.testing.assert_array_equal(got_d.numpy(), ref_d)
        np.testing.assert_array_equal(got_l.numpy(), ref_l)


def test_public_surface_shape():
    for name in ("moments", "connectedComponents", "connectedComponentsWithStats",
                 "connectedComponentsWithAlgorithm", "connectedComponentsWithStatsWithAlgorithm",
                 "distanceTransform", "distanceTransformWithLabels"):
        assert hasattr(tcv, name), name
        assert getattr(tcv, name).__class__ is getattr(jcv, name).__class__, name


@pytest.mark.parametrize("shape, p_bg", [((3, 40, 50), 0.05), ((2, 64, 31), 0.002),
                                         ((1, 17, 5), 0.0), ((2, 1, 9), 0.3),
                                         ((1, 48, 160), 0.002)])
def test_distance_l1_closed_form_is_the_chamfer_fixpoint(shape, p_bg):
    """Under DIST_L1 distanceTransform takes the exact city-block distance
    from running minima; it equals the chamfer relaxation's fixpoint (masks
    3 and 5) bit for bit, 1e9 where no background pixel exists, and the JAX
    package's result."""
    fg = torch.from_numpy(np.random.default_rng(shape[1]).random(shape) >= p_bg)
    want = S._chamfer(fg, S._DIST_WEIGHTS[(tcv.DIST_L1, 3)])
    assert torch.equal(S._chamfer(fg, S._DIST_WEIGHTS[(tcv.DIST_L1, 5)]), want)
    steps = {}
    for ms in (3, 5):
        got = tcv.distanceTransform(_t(fg.numpy()[..., None].astype(np.uint8) * 255),
                                    tcv.DIST_L1, ms, stats=steps)
        assert torch.equal(got[..., 0], want)
        assert steps == {"steps": 0, "checks": 0}
    img = fg[0].numpy().astype(np.uint8) * 255
    np.testing.assert_array_equal(tcv.distanceTransform(_t(img), tcv.DIST_L1, 3).numpy(),
                                  np.asarray(jcv.distanceTransform(img, jcv.DIST_L1, 3)))
