"""opencv_tpu_torch's linalg module vs opencv_tpu and the cv2 oracle, on the
CPU. The host solvers (solve, SVDecomp, SVBackSubst, eigen,
eigenNonSymmetric, PCA*, Mahalanobis, mulTransposed, invert, determinant,
trace) are the JAX package's numpy code: ``array_equal`` with opencv_tpu,
and cv2 at the reference test's tolerances. ``transform`` runs in f64 on the
tensor's device: ``array_equal`` with opencv_tpu for integer and f32
outputs; an f64 output within 1e-12 relative (numpy's matmul takes another
order and fused multiply-adds); against cv2, u8 exact on the reference
test's matrix and ±1 elsewhere (cv2 takes the matrix in f32 there), f32
within 1e-4. The RNG fills tensors in place with opencv_tpu's numbers for
the same seed (``array_equal``)."""

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("flags", ["DECOMP_LU", "DECOMP_SVD", "DECOMP_CHOLESKY", "DECOMP_QR",
                                   "DECOMP_EIG"])
def test_solve_square(flags):
    rng = np.random.default_rng(0)
    A = rng.random((5, 5)) + np.eye(5) * 3
    A = A @ A.T
    b = rng.random((5, 1))
    f = getattr(tcv, flags)
    r_t, x_t = tcv.solve(_t(A), _t(b), f)
    r_j, x_j = jcv.solve(A, b, f)
    assert r_t == r_j
    np.testing.assert_array_equal(x_t, x_j)
    r_ref, x_ref = cv2.solve(A, b, flags=getattr(cv2, flags))
    assert r_t == r_ref
    np.testing.assert_allclose(x_t, x_ref, atol=1e-10)


def test_solve_normal_overdetermined_and_singular():
    rng = np.random.default_rng(1)
    A = rng.random((8, 3))
    b = rng.random((8, 1))
    f = tcv.DECOMP_NORMAL + tcv.DECOMP_LU
    np.testing.assert_array_equal(tcv.solve(A, b, f)[1], jcv.solve(A, b, f)[1])
    np.testing.assert_allclose(tcv.solve(A, b, f)[1],
                               cv2.solve(A, b, flags=cv2.DECOMP_NORMAL + cv2.DECOMP_LU)[1],
                               atol=1e-8)
    np.testing.assert_array_equal(tcv.solve(A, b.ravel(), tcv.DECOMP_SVD)[1],
                                  jcv.solve(A, b.ravel(), jcv.DECOMP_SVD)[1])
    S = np.ones((3, 3))
    assert tcv.solve(S, np.ones(3))[0] == jcv.solve(S, np.ones(3))[0]


@pytest.mark.parametrize("flags", [0, 4])
def test_svdecomp_and_backsubst(flags):
    rng = np.random.default_rng(1)
    a = rng.random((6, 4))
    got = tcv.SVDecomp(_t(a), flags)
    want = jcv.SVDecomp(a, flags)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    w_r, u_r, vt_r = cv2.SVDecomp(a, flags=flags)
    assert got[1].shape == u_r.shape and got[2].shape == vt_r.shape
    np.testing.assert_allclose(got[0], w_r, atol=1e-10)
    rhs = rng.random((6, 2))
    np.testing.assert_array_equal(tcv.SVBackSubst(*got, rhs), jcv.SVBackSubst(*want, rhs))
    np.testing.assert_allclose(tcv.SVBackSubst(*got, rhs),
                               cv2.SVBackSubst(w_r, u_r, vt_r, rhs), atol=1e-10)


def test_eigen_and_pca():
    rng = np.random.default_rng(2)
    X = rng.random((40, 5)).astype(np.float32)
    S = np.cov(X.T)
    for g, w in zip(tcv.eigen(_t(S)), jcv.eigen(S)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(tcv.eigen(S)[1], cv2.eigen(S)[1], atol=1e-10)
    N = rng.random((4, 4))
    for g, w in zip(tcv.eigenNonSymmetric(N), jcv.eigenNonSymmetric(N)):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(tcv.PCACompute(_t(X), None, maxComponents=3),
                    jcv.PCACompute(X, None, maxComponents=3)):
        np.testing.assert_array_equal(g, w)
    m_ref, v_ref = cv2.PCACompute(X, mean=None, maxComponents=3)
    m_t, v_t = tcv.PCACompute(X, None, maxComponents=3)
    np.testing.assert_allclose(m_t, m_ref, atol=1e-5)
    for i in range(3):
        assert min(np.abs(v_t[i] - v_ref[i]).max(), np.abs(v_t[i] + v_ref[i]).max()) < 1e-4
    for g, w in zip(tcv.PCACompute2(X, None), jcv.PCACompute2(X, None)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(tcv.PCACompute2(X, None)[2].ravel(),
                               cv2.PCACompute2(X, mean=None)[2].ravel(), rtol=1e-4)
    p = tcv.PCAProject(_t(X), m_t, v_t)
    np.testing.assert_array_equal(p, jcv.PCAProject(X, m_t, v_t))
    np.testing.assert_array_equal(tcv.PCABackProject(p, m_t, v_t),
                                  jcv.PCABackProject(p, m_t, v_t))


def test_small_matrix_functions():
    rng = np.random.default_rng(3)
    A = rng.random((4, 4)) + 2 * np.eye(4)
    for g, w in zip(tcv.invert(_t(A)), jcv.invert(A)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(tcv.invert(A)[1], cv2.invert(A)[1], atol=1e-10)
    np.testing.assert_array_equal(tcv.invert(A[:3], tcv.DECOMP_SVD)[1],
                                  jcv.invert(A[:3], jcv.DECOMP_SVD)[1])
    assert tcv.determinant(_t(A)) == jcv.determinant(A)
    assert abs(tcv.determinant(A) - cv2.determinant(A)) < 1e-8
    assert tcv.trace(_t(A)) == jcv.trace(A)
    d, e = rng.random(3), rng.random(3)
    ic = np.linalg.inv(np.cov(rng.random((10, 3)).T))
    assert tcv.Mahalanobis(_t(d), e, ic) == jcv.Mahalanobis(d, e, ic)
    assert abs(tcv.Mahalanobis(d, e, ic) - cv2.Mahalanobis(d, e, ic)) < 1e-10
    a = rng.random((5, 3))
    for aTa in (True, False):
        np.testing.assert_array_equal(tcv.mulTransposed(_t(a), aTa), jcv.mulTransposed(a, aTa))
        np.testing.assert_allclose(tcv.mulTransposed(a, aTa), cv2.mulTransposed(a, aTa),
                                   atol=1e-12)
    delta = rng.random((1, 3))
    np.testing.assert_array_equal(tcv.mulTransposed(a, True, delta, 2.0),
                                  jcv.mulTransposed(a, True, delta, 2.0))


TRANSFORM_MATRICES = {
    "affine 2x4": np.float32([[0, 0, 1, 10], [1, 0, 0, 0]]),
    "3x3": np.random.default_rng(30).random((3, 3)),
    "2x4 signed": np.random.default_rng(31).random((2, 4)) * 3 - 1,
    "1x3": np.random.default_rng(32).random((1, 3)),
}


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32, np.float64])
@pytest.mark.parametrize("mname", list(TRANSFORM_MATRICES))
def test_transform_equals_opencv_tpu(dtype, mname):
    M = TRANSFORM_MATRICES[mname]
    img = (np.random.default_rng(3).random((24, 28, 3)) * 200).astype(dtype)
    got = tcv.transform(_t(img), M).numpy()
    want = jcv.transform(img, M)
    assert got.shape == want.shape and got.dtype == want.dtype
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    else:
        np.testing.assert_array_equal(got, want)
    ref = cv2.transform(img, M).reshape(got.shape)  # cv2 drops a last axis of 1
    if dtype == np.uint8:
        # cv2 takes the matrix in f32 for 8-bit images: exact on the
        # reference test's integer matrix, else within 1
        d = np.abs(got.astype(np.int32) - ref)
        assert d.max() <= (0 if mname == "affine 2x4" else 1)
    elif dtype == np.float32:
        np.testing.assert_allclose(got, ref, atol=1e-4)


def test_transform_points_and_planes():
    rng = np.random.default_rng(4)
    M = rng.random((2, 3))
    pts = (rng.random((10, 1, 2)) * 50).astype(np.float32)
    np.testing.assert_array_equal(tcv.transform(_t(pts), M).numpy(), jcv.transform(pts, M))
    np.testing.assert_allclose(tcv.transform(pts, M).numpy(), cv2.transform(pts, M), atol=1e-4)
    g = (rng.random((20, 30)) * 255).astype(np.uint8)
    for m in (rng.random((1, 2)), rng.random((3, 2))):
        np.testing.assert_array_equal(tcv.transform(g, m).numpy(), jcv.transform(g, m))


def test_rng_fills_tensors_with_opencv_tpus_numbers():
    for seed in (7, 12345):
        jcv.setRNGSeed(seed)
        tcv.setRNGSeed(seed)
        a = np.zeros((4, 5), np.float32)
        b = torch.zeros(4, 5)
        jcv.randu(a, 0, 1)
        assert tcv.randu(b, 0, 1) is b
        np.testing.assert_array_equal(b.numpy(), a)
        a = np.zeros(40, np.uint8)
        b = torch.zeros(40, dtype=torch.uint8)
        jcv.randu(a, 0, 256)
        tcv.randu(b, 0, 256)
        np.testing.assert_array_equal(b.numpy(), a)
        a = np.zeros((3, 30), np.float64)
        b = torch.zeros(3, 30, dtype=torch.float64)
        jcv.randn(a, 1.0, 2.0)
        tcv.randn(b, 1.0, 2.0)
        np.testing.assert_array_equal(b.numpy(), a)
        c = np.zeros(6, np.int32)
        d = torch.zeros(6, dtype=torch.int32)
        jcv.randu(c, -5, 5)
        tcv.randu(d, -5, 5)
        np.testing.assert_array_equal(d.numpy(), c)
        assert tcv.theRNG().uniform(0, 10) == jcv.theRNG().uniform(0, 10)
        assert tcv.theRNG().uniform(0.0, 1.0) == jcv.theRNG().uniform(0.0, 1.0)
        assert tcv.theRNG().gaussian(2.0) == jcv.theRNG().gaussian(2.0)


@pytest.mark.parametrize("shape", [(7,), (6, 4), (5, 2, 3)])
def test_rand_shuffle_in_place(shape):
    jcv.setRNGSeed(5)
    tcv.setRNGSeed(5)
    a = np.arange(np.prod(shape)).reshape(shape).astype(np.float32)
    b = torch.from_numpy(a.copy())
    jcv.randShuffle(a)
    assert tcv.randShuffle(b) is b
    np.testing.assert_array_equal(b.numpy(), a)
    arr = np.arange(9)
    tcv.randShuffle(arr)
    assert sorted(arr.tolist()) == list(range(9))


def test_rng_numpy_dst_and_object():
    r1, r2 = tcv.RNG(3), jcv.RNG(3)
    a, b = np.zeros((3, 3), np.float32), np.zeros((3, 3), np.float32)
    r1.fill(a, 0, -1.0, 1.0)
    r2.fill(b, 0, -1.0, 1.0)
    np.testing.assert_array_equal(a, b)
    assert r1.uniform(5, 5) == 5


def test_public_surface_linalg():
    for name in ("solve", "SVDecomp", "SVBackSubst", "eigen", "eigenNonSymmetric",
                 "PCACompute", "PCACompute2", "PCAProject", "PCABackProject", "Mahalanobis",
                 "mulTransposed", "transform", "invert", "determinant", "trace", "setRNGSeed",
                 "theRNG", "randu", "randn", "randShuffle", "RNG", "SVD_MODIFY_A", "SVD_NO_UV",
                 "SVD_FULL_UV"):
        assert hasattr(tcv, name), name
        assert getattr(tcv, name).__class__ is getattr(jcv, name).__class__, name
    assert (tcv.SVD_MODIFY_A, tcv.SVD_NO_UV, tcv.SVD_FULL_UV) == (jcv.SVD_MODIFY_A,
                                                                  jcv.SVD_NO_UV, jcv.SVD_FULL_UV)
