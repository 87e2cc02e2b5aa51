"""The port's calib3d geometry (``opencv_tpu_torch/calib3d/geometry.py``,
``usac.py``, ``pnp.py``) against ``opencv_tpu`` on seeded inputs.

The estimators are the JAX package's numpy with the same ``default_rng``
seeds, so every result is equal exactly.  The dense maps are torch float64
in ``_distort``'s order of operations: the float32 maps equal the JAX
package's and cv2's; the float64 maps ``undistort`` uses take ``r2 ** 3``
as a product where the JAX package takes numpy's power, and the images
come out equal here all the same."""

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu_torch.calib3d import geometry as tgeo
from opencv_tpu.calib3d import geometry as jgeo


def _cam():
    return (np.array([[500, 0, 320], [0, 500, 240], [0, 0, 1]], np.float64),
            np.array([0.1, -0.05, 0.001, 0.002, 0.01], np.float64))


def _same(a, b, path="out"):
    """Equal nested results: arrays (and tensors) exactly, with their dtype."""
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif a is None or isinstance(a, (bool, int, float, np.generic)) and np.ndim(a) == 0:
        assert (a is None and b is None) or a == b or (np.isnan(a) and np.isnan(b)), \
            (path, a, b)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (path, a.shape, b.shape, a.dtype,
                                                          b.dtype)
        assert np.array_equal(a, b, equal_nan=True), (path, np.abs(a - b).max())


@pytest.mark.parametrize("seed", range(4))
def test_rodrigues_and_project_points_equal_opencv_tpu(seed):
    rng = np.random.default_rng(seed)
    K, dist = _cam()
    rvec = rng.normal(0, 1, 3)
    _same(tcv.Rodrigues(rvec), jcv.Rodrigues(rvec))
    R, _ = jcv.Rodrigues(rvec)
    _same(tcv.Rodrigues(R), jcv.Rodrigues(R))
    obj = rng.normal(0, 1, (25, 3)) + [0, 0, 5]
    tvec = rng.normal(0, 0.3, 3)
    _same(tcv.projectPoints(obj, rvec, tvec, K, dist), jcv.projectPoints(obj, rvec, tvec, K, dist))
    pts = rng.uniform([50, 50], [590, 430], (30, 2)).astype(np.float32)
    _same(tcv.undistortPoints(pts, K, dist), jcv.undistortPoints(pts, K, dist))
    Rr, _ = jcv.Rodrigues(rng.normal(0, 0.05, 3))
    P = np.array([[480.0, 0, 300, 0], [0, 480, 250, 0], [0, 0, 1, 0]])
    _same(tcv.undistortPoints(pts, K, dist, Rr, P, (3, 20, 0.0)),
          jcv.undistortPoints(pts, K, dist, Rr, P, (3, 20, 0.0)))
    _same(tcv.perspectiveTransform(pts.reshape(-1, 1, 2), P[:, :3]),
          jcv.perspectiveTransform(pts.reshape(-1, 1, 2), P[:, :3]))


@pytest.mark.parametrize("with_r", [False, True])
def test_undistort_maps_equal_opencv_tpu_and_cv2(with_r):
    K, dist = _cam()
    R = jcv.Rodrigues(np.array([0.01, -0.02, 0.005]))[0] if with_r else None
    newK = np.array([[480.0, 0, 318], [0, 478, 242], [0, 0, 1]])
    tx, ty = tcv.initUndistortRectifyMap(K, dist, R, newK, (640, 480))
    jx, jy = jcv.initUndistortRectifyMap(K, dist, R, newK, (640, 480))
    assert tx.dtype == torch.float32 and tx.shape == (480, 640)
    assert np.array_equal(tx.numpy(), jx) and np.array_equal(ty.numpy(), jy)
    rx, ry = cv2.initUndistortRectifyMap(K, dist, R, newK, (640, 480), cv2.CV_32FC1)
    assert np.array_equal(tx.numpy(), rx) and np.array_equal(ty.numpy(), ry)


def test_undistort_maps_take_a_projection_matrix():
    """cv2 takes stereoRectify's (3, 4) P as the new camera matrix, by its
    first three columns; the JAX package takes (3, 3) only."""
    K, dist = _cam()
    P = np.array([[480.0, 0, 318, -57.6], [0, 478, 242, 0], [0, 0, 1, 0]])
    tx, ty = tcv.initUndistortRectifyMap(K, dist, None, P, (640, 480))
    jx, jy = jcv.initUndistortRectifyMap(K, dist, None, P[:, :3], (640, 480))
    assert np.array_equal(tx.numpy(), jx) and np.array_equal(ty.numpy(), jy)
    rx, ry = cv2.initUndistortRectifyMap(K, dist, None, P, (640, 480), cv2.CV_32FC1)
    assert np.array_equal(tx.numpy(), rx) and np.array_equal(ty.numpy(), ry)


def test_float64_maps_near_opencv_tpu():
    """The float64 maps: r2 ** 3 as a product, not numpy's power.  At 1080p
    they differ on 66 and 46 of the 2.07 M pixels, by at most 32 ulps
    (7e-12 px); the float32 maps are equal."""
    K = np.array([[1400.0, 0, 959.5], [0, 1400, 539.5], [0, 0, 1]])
    dist = np.array([-0.12, 0.06, 0.0008, -0.0005, -0.01])
    tx, ty = tgeo._undistort_maps_f64(K, dist, None, None, (1920, 1080))
    jx, jy = jgeo._undistort_maps_f64(K, dist, None, None, (1920, 1080))
    for t, j in ((tx.numpy(), jx), (ty.numpy(), jy)):
        d = np.abs(t - j)
        assert d.max() <= 1e-10 and np.count_nonzero(d) <= 100
    fx, fy = tcv.initUndistortRectifyMap(K, dist, None, None, (1920, 1080))
    gx, gy = jcv.initUndistortRectifyMap(K, dist, None, None, (1920, 1080))
    assert np.array_equal(fx.numpy(), gx) and np.array_equal(fy.numpy(), gy)


@pytest.mark.parametrize("channels", [1, 3])
def test_undistort_image_equals_opencv_tpu(channels):
    K, dist = _cam()
    rng = np.random.default_rng(2)
    shape = (480, 640) if channels == 1 else (480, 640, 3)
    img = cv2.GaussianBlur(rng.integers(0, 256, shape, np.uint8), (3, 3), 0)
    out = tcv.undistort(torch.from_numpy(img), K, dist)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.uint8
    assert np.array_equal(out.numpy(), np.asarray(jcv.undistort(img, K, dist)))
    # cv2.undistort's lower-precision internal path: the reference test's bound
    d = np.abs(cv2.undistort(img, K, dist).astype(int) - out.numpy().astype(int))
    assert np.median(d) <= 1 and (d <= 2).mean() > 0.9


def _h_scene(seed, n_in=200, n_out=60, noise=0.4):
    rng = np.random.default_rng(seed)
    H_gt = np.array([[1.02, 0.05, 10], [-0.03, 0.98, -6], [1e-4, -5e-5, 1.0]])
    src = rng.uniform(0, 500, (n_in, 2))
    dst = cv2.perspectiveTransform(src.reshape(-1, 1, 2), H_gt).reshape(-1, 2)
    dst += rng.normal(0, noise, dst.shape)
    src_all = np.vstack([src, rng.uniform(0, 500, (n_out, 2))]).astype(np.float32)
    dst_all = np.vstack([dst, rng.uniform(0, 500, (n_out, 2))]).astype(np.float32)
    return src_all, dst_all


HOMOGRAPHY_METHODS = ("0", "RANSAC", "LMEDS", "USAC_DEFAULT", "USAC_MAGSAC", "USAC_PROSAC",
                      "USAC_ACCURATE", "USAC_FAST", "USAC_PARALLEL")


@pytest.mark.parametrize("method", HOMOGRAPHY_METHODS)
def test_find_homography_equals_opencv_tpu(method):
    src, dst = _h_scene(0)
    m = 0 if method == "0" else getattr(jcv, method)
    _same(tcv.findHomography(src, dst, m, 3.0), jcv.findHomography(src, dst, m, 3.0))


def _two_views(seed, n=80, n_out=20):
    rng = np.random.default_rng(seed)
    K = np.array([[600.0, 0, 320], [0, 600, 240], [0, 0, 1]])
    R, _ = cv2.Rodrigues(np.array([0.05, -0.15, 0.03]))
    t = np.array([0.3, -0.1, 0.05])
    X = rng.uniform(-1, 1, (n, 3)) + [0, 0, 4]
    p1 = X @ K.T
    p1 = p1[:, :2] / p1[:, 2:]
    p2 = (X @ R.T + t) @ K.T
    p2 = p2[:, :2] / p2[:, 2:]
    p1 += rng.normal(0, 0.3, p1.shape)
    p2 += rng.normal(0, 0.3, p2.shape)
    p1 = np.vstack([p1, rng.uniform(0, 640, (n_out, 2))])
    p2 = np.vstack([p2, rng.uniform(0, 640, (n_out, 2))])
    return K, X, p1, p2


@pytest.mark.parametrize("method", ["FM_8POINT", "FM_RANSAC", "LMEDS", "USAC_DEFAULT",
                                    "USAC_MAGSAC", "USAC_FM_8PTS"])
def test_find_fundamental_mat_equals_opencv_tpu(method):
    _, _, p1, p2 = _two_views(1)
    m = getattr(jcv, method)
    _same(tcv.findFundamentalMat(p1, p2, m, 1.5), jcv.findFundamentalMat(p1, p2, m, 1.5))
    F, _ = jcv.findFundamentalMat(p1, p2, m, 1.5)
    _same(tcv.computeCorrespondEpilines(p1, 1, F), jcv.computeCorrespondEpilines(p1, 1, F))


@pytest.mark.parametrize("method", ["RANSAC", "LMEDS"])
def test_essential_and_recover_pose_equal_opencv_tpu(method):
    K, _, p1, p2 = _two_views(2)
    m = getattr(jcv, method)
    E_t = tcv.findEssentialMat(p1, p2, K, m, 0.999, 1.0)
    E_j = jcv.findEssentialMat(p1, p2, K, m, 0.999, 1.0)
    _same(E_t, E_j)
    _same(tcv.recoverPose(E_j[0], p1, p2, K), jcv.recoverPose(E_j[0], p1, p2, K))
    H = np.array([[1.01, 0.02, 5], [-0.01, 0.99, -3], [1e-5, 2e-5, 1]])
    _same(tcv.decomposeHomographyMat(H, K), jcv.decomposeHomographyMat(H, K))


PNP_CASES = [("SOLVEPNP_ITERATIVE", 12, False), ("SOLVEPNP_EPNP", 10, False),
             ("SOLVEPNP_P3P", 4, False), ("SOLVEPNP_AP3P", 4, False),
             ("SOLVEPNP_IPPE", 8, True), ("SOLVEPNP_IPPE_SQUARE", 4, "square"),
             ("SOLVEPNP_SQPNP", 10, False)]


@pytest.mark.parametrize("flag,n,planar", PNP_CASES)
def test_solve_pnp_equals_opencv_tpu(flag, n, planar):
    rng = np.random.RandomState(1)
    K = np.array([[800.0, 0, 320], [0, 780, 240], [0, 0, 1]])
    d = np.array([0.05, -0.1, 0.001, 0.002, 0.0])
    if planar == "square":
        obj = np.array([[-1, 1, 0], [1, 1, 0], [1, -1, 0], [-1, -1, 0]], np.float64)
    else:
        obj = rng.rand(n, 3) * 2 - 1
        if planar:
            obj[:, 2] = 0
    img, _ = cv2.projectPoints(obj, np.array([0.2, -0.3, 0.1]), np.array([0.1, -0.2, 3.0]), K, d)
    img = img.reshape(-1, 2) + rng.normal(0, 0.2, (len(obj), 2))
    f = getattr(jcv, flag)
    got = tcv.solvePnP(obj, img, K, d, flags=f)
    _same(got, jcv.solvePnP(obj, img, K, d, flags=f))
    assert got[0]


def test_solve_pnp_ransac_and_p3p_equal_opencv_tpu():
    K, X, p1, _ = _two_views(3, n=60, n_out=0)
    img = p1.copy()
    img[::6] += 40
    _same(tcv.solvePnPRansac(X, img, K, np.zeros(5)), jcv.solvePnPRansac(X, img, K, np.zeros(5)))
    _same(tcv.solveP3P(X[:3], p1[:3], K, None), jcv.solveP3P(X[:3], p1[:3], K, None))


def test_triangulate_and_rectify_equal_opencv_tpu_and_cv2():
    P1 = np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = np.hstack([np.eye(3), np.array([[-1.0], [0.02], [0.01]])])
    rng = np.random.default_rng(4)
    X = rng.uniform(-1, 1, (3, 20)) + np.array([[0], [0], [6]])
    x1 = X[:2] / X[2]
    Xs = X + P2[:, 3:]
    x2 = Xs[:2] / Xs[2]
    _same(tcv.triangulatePoints(P1, P2, x1, x2), jcv.triangulatePoints(P1, P2, x1, x2))
    K = np.array([[700.0, 0, 320], [0, 700, 240], [0, 0, 1]])
    d = np.array([0.05, -0.1, 0.001, 0.001, 0.02])
    R, _ = cv2.Rodrigues(np.array([0.01, 0.02, -0.005]))
    T = np.array([[-0.12], [0.002], [0.003]])
    for alpha in (-1, 0, 0.5, 1):
        ours = tcv.stereoRectify(K, d, K, d, (640, 480), R, T, alpha=alpha)
        _same(ours, jcv.stereoRectify(K, d, K, d, (640, 480), R, T, alpha=alpha))
        ref = cv2.stereoRectify(K, d, K, d, (640, 480), R, T, alpha=alpha)
        for a, b in zip(ref[:5], ours[:5]):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-4)
        assert tuple(ours[5]) == tuple(ref[5]) and tuple(ours[6]) == tuple(ref[6])
    for alpha in (0.0, 0.5, 1.0):
        _same(tcv.getOptimalNewCameraMatrix(K, d, (640, 480), alpha),
              jcv.getOptimalNewCameraMatrix(K, d, (640, 480), alpha))


@pytest.mark.parametrize("which", ["affine2d", "partial2d", "affine3d", "translation"])
def test_affine_estimators_equal_opencv_tpu(which):
    rng = np.random.default_rng(5)
    if which in ("affine2d", "partial2d"):
        a = rng.uniform(0, 400, (80, 2))
        M = np.array([[0.98, -0.17, 12.0], [0.17, 0.98, -7.0]])
        b = a @ M[:, :2].T + M[:, 2] + rng.normal(0, 0.3, (80, 2))
        b[::9] += 30
        fn = "estimateAffine2D" if which == "affine2d" else "estimateAffinePartial2D"
        _same(getattr(tcv, fn)(a, b), getattr(jcv, fn)(a, b))
        _same(tcv.estimateTranslation2D(a, a + [3.0, -2.0]),
              jcv.estimateTranslation2D(a, a + [3.0, -2.0]))
    elif which == "affine3d":
        a = rng.random((30, 3)) * 10
        M = np.hstack([cv2.Rodrigues(np.array([0.1, 0.2, -0.1]))[0] * 1.2, [[1], [2], [-0.5]]])
        b = a @ M[:, :3].T + M[:, 3]
        b[::7] += 20
        _same(tcv.estimateAffine3D(a, b), jcv.estimateAffine3D(a, b))
        _same(tcv.estimateTranslation3D(a, a + [1, -2, 3]),
              jcv.estimateTranslation3D(a, a + [1, -2, 3]))
    else:
        p = rng.random((10, 2)).astype(np.float32)
        _same(tcv.convertPointsToHomogeneous(p), jcv.convertPointsToHomogeneous(p))
        h = rng.random((10, 3)).astype(np.float32) + 0.5
        _same(tcv.convertPointsFromHomogeneous(h), jcv.convertPointsFromHomogeneous(h))
        F = rng.random((3, 3))
        x1, x2 = np.array([10.0, 20, 1]), np.array([30.0, 40, 1])
        assert tcv.sampsonDistance(x1, x2, F) == jcv.sampsonDistance(x1, x2, F)
        K, dist = _cam()
        pts = rng.uniform(0, 600, (20, 2)).astype(np.float32)
        _same(tcv.undistortImagePoints(pts, K, dist), jcv.undistortImagePoints(pts, K, dist))


def test_usac_params_and_solve_equal_opencv_tpu():
    from opencv_tpu.calib3d import usac as ju
    from opencv_tpu_torch.calib3d import usac as tu
    src, dst = _h_scene(1)
    out = []
    for U, G in ((ju, jgeo), (tu, tgeo)):
        p = U.UsacParams()
        p.threshold = 3.0
        p.score = U.SCORE_METHOD_MAGSAC
        p.loMethod = U.LOCAL_OPTIM_SIGMA
        est = G._HomographyEstimator(src.astype(np.float64), dst.astype(np.float64))
        out.append(U.ransac_solve(est, len(src), params=p))
    _same(out[0], out[1])
