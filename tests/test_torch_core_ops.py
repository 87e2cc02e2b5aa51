"""opencv_tpu_torch core array ops vs opencv_tpu and the cv2 oracle, on the
CPU: arithmetic with saturation and masks, bitwise ops, compare and
inRange, LUT, convertScaleAbs, normalize, split/merge/flip/rotate/
transpose, the reductions, the polar and math functions, mixChannels and
the utility surface (hconcat … buildMST).

Tolerances: ``array_equal`` for the integer and layout ops (the bitwise
ops, compare, LUT, flip, rotate, the concatenations, sorts, reductions of
integers); the reference test's ±1 against cv2 for multiply, divide,
addWeighted, convertScaleAbs and normalize.  Divergences the port holds to
cv2: ``mean``, ``meanStdDev``, ``norm``, ``sumElems`` and ``normalize``'s
min, max, norm, scale and shift in f64 (opencv_tpu: f32), and the float
functions keep f64 input in f64.  Batch semantics stay opencv_tpu's:
``normalize`` takes one min and max over the batch and ``minMaxLoc`` reads
image 0, where cv2 takes each image alone."""

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _n(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _imgs(seed=0, dtype=np.uint8, shape=(24, 32, 3)):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return rng.random(shape, np.float32) * 10 - 3, rng.random(shape, np.float32) * 10 - 3
    return (rng.integers(0, 256, shape).astype(dtype), rng.integers(0, 256, shape).astype(dtype))


@pytest.mark.parametrize("name", ["add", "subtract", "absdiff"])
def test_add_subtract_absdiff_exact(name):
    a, b = _imgs(1)
    got = _n(getattr(tcv, name)(_t(a), _t(b)))
    np.testing.assert_array_equal(got, np.asarray(getattr(jcv, name)(a, b)))
    np.testing.assert_array_equal(got, getattr(cv2, name)(a, b))


def test_add_subtract_mask_scalar_and_dtype():
    a, b = _imgs(2)
    mask = (np.random.default_rng(3).random(a.shape[:2]) > 0.5).astype(np.uint8)
    for name in ("add", "subtract"):
        got = _n(getattr(tcv, name)(_t(a), _t(b), _t(mask)))
        np.testing.assert_array_equal(got, np.asarray(getattr(jcv, name)(a, b, mask)))
        np.testing.assert_array_equal(got, getattr(cv2, name)(a, b, mask=mask))
    g = a[..., 0]
    np.testing.assert_array_equal(_n(tcv.add(_t(g), 100)), np.asarray(jcv.add(g, 100)))
    np.testing.assert_array_equal(_n(tcv.subtract(_t(a), _t(b), dtype=tcv.CV_16S)),
                                  cv2.subtract(a, b, dtype=cv2.CV_16S))


def test_multiply_divide_scale_add_within_one():
    a, b = _imgs(4)
    for name, kw, ref in (("multiply", dict(scale=1 / 255.0), cv2.multiply(a, b, scale=1 / 255.0)),
                          ("divide", dict(scale=8.0), cv2.divide(a, b, scale=8.0))):
        got = _n(getattr(tcv, name)(_t(a), _t(b), **kw))
        np.testing.assert_array_equal(got, np.asarray(getattr(jcv, name)(a, b, **kw)))
        assert np.abs(got.astype(np.int32) - ref).max() <= 1
    fa, fb = _imgs(5, np.float32)
    np.testing.assert_array_equal(_n(tcv.scaleAdd(_t(fa), 0.75, _t(fb))),
                                  np.asarray(jcv.scaleAdd(fa, 0.75, fb)))
    np.testing.assert_allclose(_n(tcv.scaleAdd(_t(fa), 0.75, _t(fb))), cv2.scaleAdd(fa, 0.75, fb),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("alpha,beta,gamma", [(0.3, 0.6, 10.0), (1.5, -0.5, 0.0)])
def test_add_weighted_within_one(alpha, beta, gamma):
    a, b = _imgs(6)
    got = _n(tcv.addWeighted(_t(a), alpha, _t(b), beta, gamma)).astype(np.int32)
    assert np.abs(got - np.asarray(jcv.addWeighted(a, alpha, b, beta, gamma))).max() <= 1
    assert np.abs(got - cv2.addWeighted(a, alpha, b, beta, gamma)).max() <= 1


def test_add_weighted_unsharp_mask_exact():
    """forward_enhance's unsharp mask: 1.5·c − 0.5·blur is exact in f32, so
    the port equals opencv_tpu and cv2 there."""
    a, b = _imgs(7, shape=(40, 52))
    got = _n(tcv.addWeighted(_t(a), 1.5, _t(b), -0.5, 0))
    np.testing.assert_array_equal(got, np.asarray(jcv.addWeighted(a, 1.5, b, -0.5, 0)))
    np.testing.assert_array_equal(got, cv2.addWeighted(a, 1.5, b, -0.5, 0))


@pytest.mark.parametrize("name", ["bitwise_and", "bitwise_or", "bitwise_xor", "min", "max"])
def test_bitwise_and_min_max_exact(name):
    a, b = _imgs(8)
    got = _n(getattr(tcv, name)(_t(a), _t(b)))
    np.testing.assert_array_equal(got, np.asarray(getattr(jcv, name)(a, b)))
    np.testing.assert_array_equal(got, getattr(cv2, name)(a, b))


def test_bitwise_not_and_masks():
    a, b = _imgs(9)
    mask = (np.random.default_rng(9).random(a.shape[:2]) > 0.3).astype(np.uint8)
    np.testing.assert_array_equal(_n(tcv.bitwise_not(_t(a))), cv2.bitwise_not(a))
    np.testing.assert_array_equal(_n(tcv.bitwise_not(_t(a), _t(mask))),
                                  np.asarray(jcv.bitwise_not(a, mask)))
    np.testing.assert_array_equal(_n(tcv.bitwise_and(_t(a), _t(b), _t(mask))),
                                  cv2.bitwise_and(a, b, mask=mask))


@pytest.mark.parametrize("op", range(6))
def test_compare_exact(op):
    a, b = _imgs(10)
    g1, g2 = a[..., 0], b[..., 0]
    got = _n(tcv.compare(_t(g1), _t(g2), op))
    np.testing.assert_array_equal(got, np.asarray(jcv.compare(g1, g2, op)))
    np.testing.assert_array_equal(got, cv2.compare(g1, g2, op))


def test_in_range_exact():
    a, _ = _imgs(11)
    got = _n(tcv.inRange(_t(a), (10, 20, 30), (200, 210, 220)))
    np.testing.assert_array_equal(got, np.asarray(jcv.inRange(a, (10, 20, 30), (200, 210, 220))))
    np.testing.assert_array_equal(got, cv2.inRange(a, (10, 20, 30), (200, 210, 220)))


def test_lut_exact():
    a, _ = _imgs(12)
    rng = np.random.default_rng(7)
    lut = rng.integers(0, 256, 256, dtype=np.uint8)
    got = _n(tcv.LUT(_t(a), lut))
    np.testing.assert_array_equal(got, np.asarray(jcv.LUT(a, lut)))
    np.testing.assert_array_equal(got, cv2.LUT(a, lut))
    lut3 = rng.integers(0, 256, (256, 1, 3), dtype=np.uint8)
    got3 = _n(tcv.LUT(_t(a), _t(lut3)))
    np.testing.assert_array_equal(got3, np.asarray(jcv.LUT(a, lut3)))
    np.testing.assert_array_equal(got3, cv2.LUT(a, lut3))
    lutf = rng.random(256).astype(np.float32)
    np.testing.assert_array_equal(_n(tcv.LUT(_t(a[..., 0]), lutf)), cv2.LUT(a[..., 0], lutf))


def test_convert_scale_abs_within_one():
    a, _ = _imgs(13)
    got = _n(tcv.convertScaleAbs(_t(a), alpha=1.5, beta=-20))
    np.testing.assert_array_equal(got, np.asarray(jcv.convertScaleAbs(a, alpha=1.5, beta=-20)))
    assert np.abs(got.astype(np.int32) - cv2.convertScaleAbs(a, alpha=1.5, beta=-20)).max() <= 1


@pytest.mark.parametrize("norm_type,alpha,beta", [(tcv.NORM_MINMAX, 0, 255),
                                                  (tcv.NORM_MINMAX, 200, 10),
                                                  (tcv.NORM_L2, 1000, 0), (tcv.NORM_L1, 5e4, 0),
                                                  (tcv.NORM_INF, 100, 0)])
def test_normalize_within_the_reference_tolerance(norm_type, alpha, beta):
    """±1 against opencv_tpu and cv2 (the reference test's bound); scale
    and shift in f64 as cv2 takes them, then f32 as convertTo."""
    g = cv2.cvtColor(_imgs(14)[0], cv2.COLOR_BGR2GRAY) // 2 + 40
    got = _n(tcv.normalize(_t(g), None, alpha, beta, norm_type)).astype(np.int32)
    assert np.abs(got - np.asarray(jcv.normalize(g, None, alpha, beta, norm_type))).max() <= 1
    assert np.abs(got - cv2.normalize(g, None, alpha, beta, norm_type)).max() <= 1
    gf = g.astype(np.float32)
    gotf = _n(tcv.normalize(_t(gf), None, alpha, beta, norm_type, tcv.CV_32F))
    np.testing.assert_allclose(gotf, cv2.normalize(gf, None, alpha, beta, norm_type,
                                                   cv2.CV_32F), rtol=1e-6, atol=1e-4)


def test_normalize_takes_one_min_max_over_the_batch():
    """Batch semantics (opencv_tpu's): one min and max over the whole batch.
    Image 0 alone normalizes as cv2 does; in the batch it does not, because
    image 1 widens the range."""
    g = _imgs(15, shape=(2, 20, 24, 1))[0] // 2 + 40
    g[1, 0, 0, 0] = 255
    batch = _n(tcv.normalize(_t(g), None, 0, 255, tcv.NORM_MINMAX))
    assert np.abs(batch.astype(np.int32) - np.asarray(jcv.normalize(g, None, 0, 255,
                                                                     jcv.NORM_MINMAX))).max() <= 1
    one = _n(tcv.normalize(_t(g[0, ..., 0]), None, 0, 255, tcv.NORM_MINMAX))
    ref0 = cv2.normalize(g[0, ..., 0], None, 0, 255, cv2.NORM_MINMAX)
    assert np.abs(one.astype(np.int32) - ref0).max() <= 1
    assert np.abs(batch[0, ..., 0].astype(np.int32) - ref0).max() > 1


def test_split_merge_flip_rotate_transpose_exact():
    a, _ = _imgs(16)
    chans = tcv.split(_t(a))
    assert len(chans) == 3
    np.testing.assert_array_equal(_n(chans[1]), cv2.split(a)[1])
    np.testing.assert_array_equal(_n(chans[1]), np.asarray(jcv.split(a)[1]))
    np.testing.assert_array_equal(_n(tcv.merge(chans)), a)
    np.testing.assert_array_equal(_n(tcv.merge(chans)), np.asarray(jcv.merge(jcv.split(a))))
    for code in (0, 1, -1):
        got = _n(tcv.flip(_t(a), code))
        np.testing.assert_array_equal(got, cv2.flip(a, code))
        np.testing.assert_array_equal(got, np.asarray(jcv.flip(a, code)))
    for code in (tcv.ROTATE_90_CLOCKWISE, tcv.ROTATE_180, tcv.ROTATE_90_COUNTERCLOCKWISE):
        got = _n(tcv.rotate(_t(a), code))
        np.testing.assert_array_equal(got, cv2.rotate(a, code))
        np.testing.assert_array_equal(got, np.asarray(jcv.rotate(a, code)))
    g = a[..., 0]
    np.testing.assert_array_equal(_n(tcv.transpose(_t(g))), cv2.transpose(g))
    np.testing.assert_array_equal(_n(tcv.transpose(_t(g))), np.asarray(jcv.transpose(g)))


def test_min_max_loc_exact():
    rng = np.random.default_rng(17)
    g = rng.integers(0, 256, (31, 37), np.uint8)
    assert tcv.minMaxLoc(_t(g)) == cv2.minMaxLoc(g) == jcv.minMaxLoc(g)
    mask = (rng.random((31, 37)) > 0.5).astype(np.uint8)
    assert tcv.minMaxLoc(_t(g), _t(mask)) == cv2.minMaxLoc(g, mask) == jcv.minMaxLoc(g, mask)


def test_min_max_loc_reads_image_zero():
    """Batch semantics (opencv_tpu's): image 0 only."""
    x = np.random.default_rng(18).integers(10, 200, (2, 15, 17, 1), np.uint8)
    x[1, 3, 4, 0] = 255
    got = tcv.minMaxLoc(_t(x))
    assert got == jcv.minMaxLoc(x) == cv2.minMaxLoc(x[0, ..., 0])
    assert got[1] < 255


def test_stats_in_f64_equal_cv2():
    """Divergence: mean, meanStdDev, norm and sumElems in f64 as cv2 (to
    1e-12 relative); opencv_tpu's f32 within its own test's bounds."""
    rng = np.random.default_rng(19)
    g = rng.integers(0, 256, (31, 37), np.uint8)
    a = rng.integers(0, 256, (24, 32, 3), np.uint8)
    mask = (rng.random((31, 37)) > 0.5).astype(np.uint8)
    np.testing.assert_allclose(tcv.mean(_t(g)), cv2.mean(g), rtol=1e-12)
    np.testing.assert_allclose(tcv.mean(_t(g), _t(mask)), cv2.mean(g, mask=mask), rtol=1e-12)
    np.testing.assert_allclose(tcv.mean(_t(a)), np.asarray(jcv.mean(a)), atol=1e-3)
    for nt in (tcv.NORM_L1, tcv.NORM_L2, tcv.NORM_INF, tcv.NORM_L2SQR):
        assert abs(tcv.norm(_t(g), nt) - cv2.norm(g, nt)) <= 1e-12 * cv2.norm(g, nt)
        assert abs(tcv.norm(_t(g), nt) - jcv.norm(g, nt)) < max(1.0, cv2.norm(g, nt) * 1e-5)
    mu, sd = tcv.meanStdDev(_t(a))
    rmu, rsd = cv2.meanStdDev(a)
    np.testing.assert_allclose(mu, rmu, rtol=1e-12)
    np.testing.assert_allclose(sd, rsd, rtol=1e-9)
    jmu, jsd = jcv.meanStdDev(a)
    np.testing.assert_allclose(mu, jmu, atol=1e-2)
    np.testing.assert_allclose(sd, jsd, atol=1e-2)
    np.testing.assert_allclose(tcv.sumElems(_t(a)), cv2.sumElems(a), rtol=1e-12)
    np.testing.assert_allclose(tcv.sumElems(_t(a)), jcv.sumElems(a), rtol=1e-12)
    assert tcv.countNonZero(_t(g)) == cv2.countNonZero(g) == jcv.countNonZero(g)


def test_cart_to_polar_and_back():
    rng = np.random.default_rng(20)
    x = rng.normal(0, 10, (16, 16)).astype(np.float32)
    y = rng.normal(0, 10, (16, 16)).astype(np.float32)
    om, oa = tcv.cartToPolar(_t(x), _t(y))
    jm, ja = jcv.cartToPolar(x, y)
    rm, ra = cv2.cartToPolar(x, y)
    np.testing.assert_allclose(_n(om), np.asarray(jm), rtol=1e-6)
    np.testing.assert_allclose(_n(om), rm, atol=1e-3)
    np.testing.assert_allclose(_n(oa), np.asarray(ja), atol=1e-6)
    da = np.abs(_n(oa) - ra)
    assert np.minimum(da, 2 * np.pi - da).max() < 1e-2
    deg = _n(tcv.phase(_t(x), _t(y), True))
    np.testing.assert_allclose(deg, np.asarray(jcv.phase(x, y, True)), atol=1e-4)
    px, py = tcv.polarToCart(om, oa)
    jx, jy = jcv.polarToCart(np.asarray(jm), np.asarray(ja))
    # cos and sin: the port's are f64 rounded to f32, XLA's f32 kernels
    # are within a few ulp of them
    np.testing.assert_allclose(_n(px), np.asarray(jx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_n(py), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_n(px), x, atol=1e-4)


@pytest.mark.parametrize("name", ["exp", "log", "sqrt"])
def test_math_functions_f32_and_f64(name):
    x = np.random.default_rng(21).random((12, 14), np.float32) * 4 + 0.1
    got = _n(getattr(tcv, name)(_t(x)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(getattr(jcv, name)(x)), rtol=2e-7)
    np.testing.assert_allclose(got, getattr(cv2, name)(x), rtol=1e-6)
    x64 = x.astype(np.float64)
    got64 = _n(getattr(tcv, name)(_t(x64)))
    assert got64.dtype == np.float64       # divergence: opencv_tpu returns f32
    np.testing.assert_allclose(got64, getattr(cv2, name)(x64), rtol=1e-14)


def test_pow():
    x = np.random.default_rng(22).random((12, 14), np.float32) * 4
    got = _n(tcv.pow(_t(x), 2.5))
    np.testing.assert_allclose(got, np.asarray(jcv.pow(x, 2.5)), rtol=2e-7)
    np.testing.assert_allclose(got, cv2.pow(x, 2.5), rtol=1e-6)


def test_mix_channels_set_identity_complete_symm():
    rng = np.random.default_rng(23)
    a = rng.integers(0, 256, (5, 6, 3), np.uint8)
    b = rng.integers(0, 256, (5, 6), np.uint8)
    d1, d2 = np.zeros((5, 6, 2), np.uint8), np.zeros((5, 6), np.uint8)
    pairs = [0, 1, 3, 0, 2, 2, -1, 1]
    got = tcv.mixChannels([_t(a), _t(b)], [_t(d1), _t(d2)], pairs)
    want = jcv.mixChannels([a, b], [d1, d2], pairs)
    ref = cv2.mixChannels([a, b], [d1.copy(), d2.copy()], pairs)
    for g, w, r in zip(got, want, ref):
        np.testing.assert_array_equal(_n(g), w)
        np.testing.assert_array_equal(_n(g), r)
    m = rng.random((4, 5)).astype(np.float32)
    np.testing.assert_array_equal(_n(tcv.setIdentity(_t(m), 3.0)), jcv.setIdentity(m, 3.0))
    np.testing.assert_array_equal(_n(tcv.setIdentity(_t(m), 3.0)), cv2.setIdentity(m.copy(), 3.0))
    s = rng.random((5, 5))
    for low in (False, True):
        np.testing.assert_array_equal(_n(tcv.completeSymm(_t(s), low)), jcv.completeSymm(s, low))
        np.testing.assert_array_equal(_n(tcv.completeSymm(_t(s), low)),
                                      cv2.completeSymm(s.copy(), low))


def test_host_solvers_are_the_reference_code():
    """solveCubic, solvePoly, PSNR, fastAtan2, cubeRoot, clipLine, solveLP and
    buildMST run opencv_tpu's host numpy code, copied."""
    for c in ([1, -6, 11, -6], [2, 0, 3], [0, 1, -3, 2], [1, 0, 0, 1]):
        n, r = tcv.solveCubic(np.array(c, np.float64))
        jn, jr = jcv.solveCubic(np.array(c, np.float64))
        assert n == jn
        np.testing.assert_array_equal(r, jr)
    md, roots = tcv.solvePoly(np.array([6.0, -5.0, 1.0]))
    jmd, jroots = jcv.solvePoly(np.array([6.0, -5.0, 1.0]))
    assert md == jmd
    np.testing.assert_array_equal(roots, jroots)
    a, b = _imgs(24)
    assert tcv.PSNR(_t(a), _t(b)) == jcv.PSNR(a, b)
    assert abs(tcv.PSNR(_t(a), _t(b)) - cv2.PSNR(a, b)) < 1e-9
    assert tcv.fastAtan2(3.0, 4.0) == jcv.fastAtan2(3.0, 4.0)
    assert tcv.cubeRoot(-27.5) == jcv.cubeRoot(-27.5)
    for p1, p2 in (((-5, 3), (15, 7)), ((2, -4), (8, 20)), ((-3, -3), (-1, -9))):
        assert tcv.clipLine((0, 0, 10, 10), p1, p2) == jcv.clipLine((0, 0, 10, 10), p1, p2)
    F = np.array([3.0, 2.0])
    C = np.array([[1.0, 1.0, 4.0], [1.0, 3.0, 6.0]])
    s, z = tcv.solveLP(F, C)
    js, jz = jcv.solveLP(F, C)
    assert s == js
    np.testing.assert_array_equal(z, jz)
    edges = np.array([[0, 1, 4.0], [1, 2, 1.0], [0, 2, 2.0], [2, 3, 5.0], [1, 1, 0.5]])
    ok, out = tcv.buildMST(4, edges)
    jok, jout = jcv.buildMST(4, edges)
    assert ok == jok
    np.testing.assert_array_equal(out, jout)


@pytest.mark.parametrize("norm_type", [tcv.NORM_L2, tcv.NORM_L2SQR, tcv.NORM_L1,
                                       tcv.NORM_HAMMING])
def test_batch_distance(norm_type):
    rng = np.random.default_rng(25)
    if norm_type == tcv.NORM_HAMMING:
        a = rng.integers(0, 256, (7, 32), np.uint8)
        b = rng.integers(0, 256, (9, 32), np.uint8)
    else:
        a = rng.random((7, 16), np.float32)
        b = rng.random((9, 16), np.float32)
    got = _n(tcv.batchDistance(_t(a), _t(b), normType=norm_type))
    want = np.asarray(jcv.batchDistance(a, b, normType=norm_type))
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    d, idx = tcv.batchDistance(_t(a), _t(b), normType=norm_type, K=3)
    jd, jidx = jcv.batchDistance(a, b, normType=norm_type, K=3)
    np.testing.assert_array_equal(_n(idx), jidx)
    np.testing.assert_allclose(_n(d), jd, rtol=1e-5, atol=1e-5)


def test_concat_repeat_reduce_sort():
    rng = np.random.default_rng(26)
    a = rng.integers(0, 100, (4, 5), np.int32)
    b = rng.integers(0, 100, (4, 3), np.int32)
    np.testing.assert_array_equal(_n(tcv.hconcat([_t(a), _t(b)])), cv2.hconcat([a, b]))
    np.testing.assert_array_equal(_n(tcv.hconcat([_t(a), _t(b)])), jcv.hconcat([a, b]))
    np.testing.assert_array_equal(_n(tcv.vconcat([_t(a), _t(a)])), jcv.vconcat([a, a]))
    np.testing.assert_array_equal(_n(tcv.repeat(_t(a), 2, 3)), cv2.repeat(a, 2, 3))
    np.testing.assert_array_equal(_n(tcv.repeat(_t(a), 2, 3)), jcv.repeat(a, 2, 3))
    f = rng.random((6, 7)).astype(np.float32)
    for rt in (tcv.REDUCE_SUM, tcv.REDUCE_AVG, tcv.REDUCE_MAX, tcv.REDUCE_MIN, tcv.REDUCE_SUM2):
        for dim in (0, 1):
            got = _n(tcv.reduce(_t(f), dim, rt))
            np.testing.assert_array_equal(got, jcv.reduce(f, dim, rt))
            np.testing.assert_allclose(got, cv2.reduce(f, dim, rt), rtol=1e-6)
    ties = rng.integers(0, 4, (5, 6)).astype(np.float32)
    for axis in (0, 1):
        for last in (False, True):
            np.testing.assert_array_equal(_n(tcv.reduceArgMax(_t(ties), axis, last)),
                                          jcv.reduceArgMax(ties, axis, last))
            np.testing.assert_array_equal(_n(tcv.reduceArgMin(_t(ties), axis, last)),
                                          cv2.reduceArgMin(ties, axis, lastIndex=last))
            np.testing.assert_array_equal(_n(tcv.reduceArgMin(_t(ties), axis, last)),
                                          jcv.reduceArgMin(ties, axis, last))
    for fl in (tcv.SORT_EVERY_ROW, tcv.SORT_EVERY_COLUMN,
               tcv.SORT_EVERY_ROW | tcv.SORT_DESCENDING):
        np.testing.assert_array_equal(_n(tcv.sort(_t(ties), fl)), cv2.sort(ties, fl))
        np.testing.assert_array_equal(_n(tcv.sort(_t(ties), fl)), jcv.sort(ties, fl))
        np.testing.assert_array_equal(_n(tcv.sortIdx(_t(ties), fl)), jcv.sortIdx(ties, fl))


def test_nonzero_range_nan_channels_copy():
    rng = np.random.default_rng(27)
    a = (rng.random((6, 7)) > 0.7).astype(np.uint8) * rng.integers(1, 9, (6, 7), dtype=np.uint8)
    np.testing.assert_array_equal(_n(tcv.findNonZero(_t(a))), jcv.findNonZero(a))
    np.testing.assert_array_equal(_n(tcv.findNonZero(_t(a))), cv2.findNonZero(a).reshape(-1, 2))
    assert tcv.findNonZero(_t(np.zeros((3, 3), np.uint8))) is None
    assert tcv.hasNonZero(_t(a)) == jcv.hasNonZero(a) == cv2.hasNonZero(a)
    assert not tcv.hasNonZero(_t(np.zeros((3, 3), np.uint8)))
    f = rng.random((5, 5)).astype(np.float32)
    f[1, 2] = np.nan
    assert tcv.checkRange(_t(f)) == jcv.checkRange(f) == cv2.checkRange(f)[0]
    with pytest.raises(ValueError):
        tcv.checkRange(_t(f), quiet=False)
    np.testing.assert_array_equal(_n(tcv.patchNaNs(_t(f), 7.0)), jcv.patchNaNs(f, 7.0))
    c3 = rng.integers(0, 256, (4, 5, 3), np.uint8)
    np.testing.assert_array_equal(_n(tcv.extractChannel(_t(c3), 1)), cv2.extractChannel(c3, 1))
    np.testing.assert_array_equal(_n(tcv.extractChannel(_t(c3), 1)), jcv.extractChannel(c3, 1))
    np.testing.assert_array_equal(_n(tcv.insertChannel(_t(c3[..., 0]), _t(c3), 2)),
                                  jcv.insertChannel(c3[..., 0], c3, 2))
    m = (rng.random((4, 5)) > 0.5).astype(np.uint8)
    np.testing.assert_array_equal(_n(tcv.copyTo(_t(c3), _t(m))), jcv.copyTo(c3, m))
    np.testing.assert_array_equal(_n(tcv.flipND(_t(c3), 2)), jcv.flipND(c3, 2))
    np.testing.assert_array_equal(_n(tcv.transposeND(_t(c3), [2, 0, 1])),
                                  jcv.transposeND(c3, [2, 0, 1]))
    row = rng.random((1, 3)).astype(np.float32)
    np.testing.assert_array_equal(_n(tcv.broadcast(_t(row), np.array([4, 3]))),
                                  cv2.broadcast(row, np.array([4, 3])))
    np.testing.assert_array_equal(_n(tcv.broadcast(_t(row), np.array([4, 3]))),
                                  jcv.broadcast(row, np.array([4, 3])))
    np.testing.assert_array_equal(_n(tcv.finiteMask(_t(f))), cv2.finiteMask(f))
    np.testing.assert_array_equal(_n(tcv.finiteMask(_t(f))), jcv.finiteMask(f))


def test_gemm_covar_div_spectrums():
    rng = np.random.default_rng(28)
    A = rng.random((3, 4)).astype(np.float32)
    B = rng.random((4, 5)).astype(np.float32)
    C = rng.random((3, 5)).astype(np.float32)
    got = _n(tcv.gemm(_t(A), _t(B), 1.5, _t(C), 0.5))
    np.testing.assert_array_equal(got, jcv.gemm(A, B, 1.5, C, 0.5))
    np.testing.assert_allclose(got, cv2.gemm(A, B, 1.5, C, 0.5), rtol=1e-6)
    got_t = _n(tcv.gemm(_t(A.T.copy()), _t(B), 1.0, None, 0.0, tcv.GEMM_1_T))
    np.testing.assert_array_equal(got_t, jcv.gemm(A.T.copy(), B, 1.0, None, 0.0, jcv.GEMM_1_T))
    S = rng.random((10, 3))
    flags = tcv.COVAR_NORMAL | tcv.COVAR_ROWS | tcv.COVAR_SCALE
    cov, mu = tcv.calcCovarMatrix(_t(S), None, flags)
    jcov, jmu = jcv.calcCovarMatrix(S, None, flags)
    np.testing.assert_allclose(_n(cov), jcov, rtol=1e-12)
    np.testing.assert_allclose(_n(mu), jmu, rtol=1e-12)
    sa = rng.random((6, 5, 2)).astype(np.float32)
    sb = rng.random((6, 5, 2)).astype(np.float32) + 0.1
    for conj in (False, True):
        np.testing.assert_allclose(_n(tcv.divSpectrums(_t(sa), _t(sb), 0, conj)),
                                   jcv.divSpectrums(sa, sb, 0, conj), rtol=1e-5)
