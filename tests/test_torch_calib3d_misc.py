"""The rest of the port's calib3d (``misc3d``, ``fisheye``, ``circlesgrid``,
``extended``, ``handeye``, ``multiview``) against ``opencv_tpu``, and cv2
where tests/test_calib3d.py and the tail-API tests check it.

The host functions are the JAX package's numpy: equal exactly.  Measured
bounds: the functions over calibrateCamera and stereoCalibrate follow the
port's LM (within 1e-6 relative, tests/test_torch_calib3d_calibrate.py),
and calibrateCameraExtended's standard deviations, a numeric Jacobian of
1e-6 steps, within 1e-4 relative; reprojectImageTo3D on the device sums
its four terms one op at a time where the JAX package takes a matrix
product: within 1e-6 relative (measured: equal on these disparities)."""

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv

from torch_threads import _one_torch_thread  # noqa: F401


def _same(a, b, path="out"):
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif a is None or np.ndim(a) == 0 and not isinstance(a, np.ndarray):
        assert a == b or (a is None and b is None), (path, a, b)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (path, a.shape, b.shape, a.dtype,
                                                          b.dtype)
        assert np.array_equal(a, b, equal_nan=True), path


def _near(a, b, rel, path="out"):
    if isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            _near(x, y, rel, f"{path}[{i}]")
        return
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    scale = np.maximum(np.abs(b), np.abs(b).max(initial=0) * 1e-6 + 1e-300)
    assert a.shape == b.shape and np.all(np.abs(a - b) <= rel * scale), path


K0 = np.array([[600.0, 0, 320], [0, 590, 240], [0, 0, 1]])
D0 = np.array([0.05, -0.1, 0.001, 0.002, 0.01])


def _host_cases():
    rng = np.random.default_rng(11)
    r1, r2 = rng.normal(0, 0.3, 3), rng.normal(0, 0.3, 3)
    t1, t2 = rng.normal(0, 1, 3), rng.normal(0, 1, 3)
    R, _ = cv2.Rodrigues(np.array([0.05, -0.1, 0.02]))
    t = np.array([0.3, 0.02, 0.01])
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = tx @ R
    F = np.linalg.inv(K0).T @ E @ np.linalg.inv(K0)
    P = K0 @ np.hstack([R, t[:, None]])
    X = rng.uniform(-1, 1, (12, 3)) + [0, 0, 5]
    p1 = (X @ K0.T)[:, :2] / (X @ K0.T)[:, 2:]
    X2 = X @ R.T + t
    p2 = (X2 @ K0.T)[:, :2] / (X2 @ K0.T)[:, 2:]
    A, B = rng.normal(0, 1, (3, 4)), rng.normal(0, 1, (4, 2))
    return {
        "composeRT": lambda m: m.composeRT(r1, t1, r2, t2),
        "decomposeEssentialMat": lambda m: m.decomposeEssentialMat(E),
        "decomposeProjectionMatrix": lambda m: m.decomposeProjectionMatrix(P),
        "calibrationMatrixValues": lambda m: m.calibrationMatrixValues(K0, (640, 480), 6.4, 4.8),
        "correctMatches": lambda m: m.correctMatches(F, p1 + rng.normal(0, 0.5, p1.shape), p2),
        "getDefaultNewCameraMatrix": lambda m: m.getDefaultNewCameraMatrix(K0, (640, 480), True),
        "getValidDisparityROI": lambda m: m.getValidDisparityROI((0, 0, 640, 480),
                                                                 (5, 2, 630, 470), -2, 64, 9),
        "stereoRectifyUncalibrated": lambda m: m.stereoRectifyUncalibrated(p1, p2, F, (640, 480)),
        "matMulDeriv": lambda m: m.matMulDeriv(A, B),
        "RQDecomp3x3": lambda m: m.RQDecomp3x3(P[:, :3]),
    }


HOST = list(_host_cases())


@pytest.mark.parametrize("name", HOST)
def test_misc3d_host_function_equals_opencv_tpu(name):
    from opencv_tpu.calib3d import misc3d as jm
    from opencv_tpu_torch.calib3d import misc3d as tm
    ours = _host_cases()[name](tm)
    ref = _host_cases()[name](jm)
    _same(ours, ref)


def test_misc3d_matches_cv2_where_the_tail_tests_do():
    r1, t1 = np.array([0.1, -0.2, 0.05]), np.array([0.3, 0.1, -0.2])
    r2, t2 = np.array([-0.05, 0.15, 0.2]), np.array([0.0, -0.4, 0.1])
    ref = cv2.composeRT(r1, t1, r2, t2)
    got = tcv.composeRT(r1, t1, r2, t2)
    np.testing.assert_allclose(got[0].ravel(), ref[0].ravel(), atol=1e-10)
    np.testing.assert_allclose(got[1].ravel(), ref[1].ravel(), atol=1e-10)
    np.testing.assert_allclose(tcv.getDefaultNewCameraMatrix(K0, (640, 480), True),
                               cv2.getDefaultNewCameraMatrix(K0, (640, 480), True))
    assert tuple(tcv.getValidDisparityROI((0, 0, 40, 30), (0, 0, 40, 30), 0, 16, 5)) == \
        tuple(cv2.getValidDisparityROI((0, 0, 40, 30), (0, 0, 40, 30), 0, 16, 5))


def test_draw_frame_axes_equals_opencv_tpu():
    img = np.full((240, 320, 3), 40, np.uint8)
    K = np.array([[300.0, 0, 160], [0, 300, 120], [0, 0, 1]])
    args = (K, None, np.array([0.2, -0.3, 0.1]), np.array([0.0, 0.0, 4.0]), 1.0, 2)
    ours = tcv.drawFrameAxes(torch.from_numpy(img.copy()), *args)
    ref = jcv.drawFrameAxes(img.copy(), *args)
    assert isinstance(ours, torch.Tensor) and np.array_equal(ours.numpy(), np.asarray(ref))


def test_validate_disparity_and_reprojection_on_the_device_against_opencv_tpu_and_cv2():
    rng = np.random.default_rng(9)
    disp = (rng.integers(-3, 70, (30, 40)) * 16).astype(np.int16)
    got = tcv.validateDisparity(torch.from_numpy(disp), None, 0, 64)
    assert isinstance(got, torch.Tensor)
    assert np.array_equal(got.numpy(), jcv.validateDisparity(disp, None, 0, 64))
    assert np.array_equal(tcv.validateDisparity(disp, None, 0, 64),
                          jcv.validateDisparity(disp, None, 0, 64))
    Q = np.array([[1, 0, 0, -20], [0, 1, 0, -15], [0, 0, 0, 400], [0, 0, 1.0 / 30, 0]])
    for d, missing in ((disp, False), (disp.astype(np.float32) / 16, True)):
        ours = tcv.reprojectImageTo3D(torch.from_numpy(d), Q, missing)
        assert isinstance(ours, torch.Tensor) and ours.dtype == torch.float32
        ref = jcv.reprojectImageTo3D(d, Q, missing)
        _near(ours.numpy(), ref, 1e-6)
        if not missing:   # the tail-API test's check against cv2
            want = cv2.reprojectImageTo3D(d, Q)
            m = np.isfinite(want) & (np.abs(want) < 1e5)
            assert np.allclose(ours.numpy()[m], want[m], rtol=1e-4, atol=1e-3)


FISHEYE_K = np.array([[400.0, 0, 320], [0, 390, 240], [0, 0, 1]])
FISHEYE_D = np.array([0.1, -0.05, 0.01, -0.002])


def test_fisheye_equals_opencv_tpu_and_matches_cv2():
    rng = np.random.default_rng(0)
    obj = rng.normal(0, 0.4, (30, 3)) + [0, 0, 2.5]
    rvec, tvec = np.array([0.05, -0.1, 0.02]), np.array([0.1, -0.05, 0.3])
    K, D = FISHEYE_K, FISHEYE_D
    ours, _ = tcv.fisheye.projectPoints(obj, rvec, tvec, K, D)
    _same(ours, jcv.fisheye.projectPoints(obj, rvec, tvec, K, D)[0])
    ref, _ = cv2.fisheye.projectPoints(obj.reshape(-1, 1, 3), rvec, tvec, K, D)
    np.testing.assert_allclose(np.asarray(ours).reshape(-1, 2), ref.reshape(-1, 2), atol=1e-9)
    pts = np.asarray(ref, np.float64).reshape(-1, 1, 2)
    _same(tcv.fisheye.undistortPoints(pts, K, D), jcv.fisheye.undistortPoints(pts, K, D))
    _same(tcv.fisheye.distortPoints(pts * 0.001, K, D),
          jcv.fisheye.distortPoints(pts * 0.001, K, D))
    m1o, m2o = tcv.fisheye.initUndistortRectifyMap(K, D, np.eye(3), K, (640, 480))
    _same((m1o, m2o), jcv.fisheye.initUndistortRectifyMap(K, D, np.eye(3), K, (640, 480)))
    m1r, m2r = cv2.fisheye.initUndistortRectifyMap(K, D, np.eye(3), K, (640, 480), cv2.CV_32FC1)
    assert np.array_equal(m1o, m1r) and np.array_equal(m2o, m2r)
    _same(tcv.fisheye.estimateNewCameraMatrixForUndistortRectify(K, D, (640, 480), np.eye(3),
                                                                  balance=0.3),
          jcv.fisheye.estimateNewCameraMatrixForUndistortRectify(K, D, (640, 480), np.eye(3),
                                                                  balance=0.3))
    img = cv2.GaussianBlur(rng.integers(0, 256, (480, 640, 3), np.uint8), (3, 3), 0)
    und = tcv.fisheye.undistortImage(torch.from_numpy(img), K, D)
    assert isinstance(und, torch.Tensor)
    assert np.array_equal(und.numpy(), np.asarray(jcv.fisheye.undistortImage(img, K, D)))


@pytest.mark.parametrize("asym", [False, True])
def test_find_circles_grid_equals_opencv_tpu(asym):
    """tests/test_tail_apis7.py's symmetric grid (and cv2 where it finds it,
    else the truth), and an asymmetric one."""
    w, h = (4, 5) if asym else (4, 3)
    img = np.full((240, 300) if asym else (200, 260), 255, np.uint8)
    truth = []
    for r in range(h):
        for c in range(w):
            x = 40 + c * 55 + (27 if asym and r % 2 else 0)
            y = 35 + r * (30 if asym else 60)
            cv2.circle(img, (x, y), 10 if asym else 12, 0, -1)
            truth.append((x, y))
    flags = tcv.CALIB_CB_ASYMMETRIC_GRID if asym else tcv.CALIB_CB_SYMMETRIC_GRID
    ours = tcv.findCirclesGrid(torch.from_numpy(img), (w, h), flags=flags)
    _same(ours, jcv.findCirclesGrid(img, (w, h), flags=flags))
    if not asym:
        ok, want = cv2.findCirclesGrid(img, (w, h), flags=cv2.CALIB_CB_SYMMETRIC_GRID)
        want = np.asarray(want).reshape(-1, 2) if ok else np.asarray(truth, np.float64)
        g = ours[1].reshape(-1, 2)
        assert ours[0] and (np.allclose(g, want, atol=1.5) or np.allclose(g[::-1], want, atol=1.5))


def test_chessboard_sharpness_and_extras_equal_opencv_tpu():
    from test_torch_calib3d_chessboard import _make_board
    img = _make_board(7, 5)
    ok, corners = jcv.findChessboardCorners(img, (7, 5))
    _same(tcv.estimateChessboardSharpness(torch.from_numpy(img), (7, 5), corners),
          jcv.estimateChessboardSharpness(img, (7, 5), corners))
    assert tcv.checkChessboard(torch.from_numpy(img), (7, 5)) == \
        jcv.checkChessboard(img, (7, 5)) is True
    _same(tcv.find4QuadCornerSubpix(torch.from_numpy(img), corners + 0.7, (5, 5)),
          jcv.find4QuadCornerSubpix(img, corners + 0.7, (5, 5)))
    K = np.array([[300.0, 0, 80], [0, 290, 60], [0, 0, 1]])
    dist = np.array([0.05, -0.02, 0.001, 0.001, 0.0])
    newK = np.array([[280.0, 0, 78], [0, 275, 59], [0, 0, 1]])
    _same(tcv.initInverseRectificationMap(K, dist, None, newK, (160, 120)),
          jcv.initInverseRectificationMap(K, dist, None, newK, (160, 120)))


def _pnp_scene(seed):
    rng = np.random.default_rng(seed)
    K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]])
    obj = rng.uniform(-1, 1, (20, 3))
    rvec, tvec = rng.normal(0, 0.2, 3), np.array([0.1, -0.1, 6.0])
    img, _ = cv2.projectPoints(obj, rvec, tvec, K, None)
    return K, obj, img.reshape(-1, 2), rvec, tvec


@pytest.mark.parametrize("fn", ["solvePnPRefineLM", "solvePnPRefineVVS", "solvePnPGeneric",
                                "projectPointsSepJ", "filterHomographyDecompByVisibleRefpoints"])
def test_pnp_extras_equal_opencv_tpu(fn):
    K, obj, img, rvec, tvec = _pnp_scene(3)
    if fn.startswith("solvePnPRefine"):
        args = (obj, img, K, None, rvec + 0.05, tvec + np.array([0.05, -0.03, 0.1]))
    elif fn == "solvePnPGeneric":
        args = (obj, img, K, None)
    elif fn == "projectPointsSepJ":
        args = (obj, rvec, tvec, K, D0)
    else:
        H = np.array([[1.01, 0.02, 5], [-0.01, 0.99, -3], [1e-5, 2e-5, 1]])
        _, Rs, _, Ns = jcv.decomposeHomographyMat(H, K)
        pts = img[:8].copy()
        args = (Rs, Ns, pts, cv2.perspectiveTransform(pts.reshape(-1, 1, 2), H).reshape(-1, 2))
    _same(getattr(tcv, fn)(*args), getattr(jcv, fn)(*args))


def test_calibration_extras_near_opencv_tpu():
    from test_torch_calib3d_calibrate import _views
    objpts, imgpts = _views(0, 6, 0.25, 0.1, np.array([0.1, -0.2, 0.001, 0.002, 0.05]))
    _same(tcv.initCameraMatrix2D(objpts, imgpts, (640, 480)),
          jcv.initCameraMatrix2D(objpts, imgpts, (640, 480)))
    ours = tcv.calibrateCameraExtended(objpts, imgpts, (640, 480))
    ref = jcv.calibrateCameraExtended(objpts, imgpts, (640, 480))
    _near(ours[:5], ref[:5], 1e-6)
    _near(ours[5:], ref[5:], 1e-4)


@pytest.mark.parametrize("method", range(5))
def test_calibrate_hand_eye_equals_opencv_tpu(method):
    rng = np.random.default_rng(method)
    Rg, tg, Rc, tc = [], [], [], []
    for _ in range(6):
        Rg.append(cv2.Rodrigues(rng.normal(0, 0.5, 3))[0])
        tg.append(rng.normal(0, 1, 3))
        Rc.append(cv2.Rodrigues(rng.normal(0, 0.5, 3))[0])
        tc.append(rng.normal(0, 1, 3))
    _same(tcv.calibrateHandEye(Rg, tg, Rc, tc, method=method),
          jcv.calibrateHandEye(Rg, tg, Rc, tc, method=method))
    if method < 2:
        _same(tcv.calibrateRobotWorldHandEye(Rg, tg, Rc, tc, method=method),
              jcv.calibrateRobotWorldHandEye(Rg, tg, Rc, tc, method=method))


def test_multiview_equals_opencv_tpu():
    rng = np.random.default_rng(5)
    K = np.array([[400.0, 0, 160], [0, 400, 120], [0, 0, 1]])
    R_rel = cv2.Rodrigues(np.array([0.0, 0.3, 0.0]))[0]
    t_rel = np.array([[-0.5], [0.0], [0.0]])
    objs, img1, img2 = [], [], []
    for _ in range(4):
        o = np.zeros((30, 3), np.float32)
        o[:, :2] = np.mgrid[0:6, 0:5].T.reshape(-1, 2) * 0.1
        rv, tv = rng.normal(0, 0.2, 3), np.array([-0.2, -0.2, 1.5]) + rng.normal(0, 0.05, 3)
        p1, _ = cv2.projectPoints(o, rv, tv, K, None)
        R2 = R_rel @ cv2.Rodrigues(rv)[0]
        t2 = (R_rel @ tv.reshape(3, 1) + t_rel).ravel()
        p2, _ = cv2.projectPoints(o, cv2.Rodrigues(R2)[0], t2, K, None)
        objs.append(o)
        img1.append(p1.reshape(-1, 2).astype(np.float32))
        img2.append(p2.reshape(-1, 2).astype(np.float32))
    args = (objs, objs, img1, img2, K, None, 0, K, None, 0)
    ours = tcv.registerCameras(*args)
    _same(ours, jcv.registerCameras(*args))
    assert np.allclose(ours[1], R_rel, atol=1e-4) and np.allclose(ours[2], t_rel, atol=1e-4)
    pts = rng.uniform(0, 100, (40, 2)).astype(np.float32)
    _same(tcv.minEnclosingConvexPolygon(pts, 5), jcv.minEnclosingConvexPolygon(pts, 5))
    yy, xx = np.mgrid[0:60, 0:80].astype(np.float64)
    cloud = np.stack([xx, yy, 0.02 * xx + 3.0], -1)
    cloud[30:, 40:, 2] = 0.5 * yy[30:, 40:]
    _same(tcv.findPlanes(cloud, threshold=0.05, block_size=20, min_size=100),
          jcv.findPlanes(cloud, threshold=0.05, block_size=20, min_size=100))
    img = cv2.GaussianBlur(rng.integers(0, 256, (60, 80, 3), np.uint8), (3, 3), 0)
    co = np.zeros((4, 10), np.float32)
    co[:, 0] = (0.5, -0.3, -0.4, 0.2)
    co[:, 1] = (0.002, 0.0, 0.0, -0.001)
    ours = tcv.correctChromaticAberration(torch.from_numpy(img), co, (80, 60), 3)
    assert isinstance(ours, torch.Tensor)
    assert np.array_equal(ours.numpy(), jcv.correctChromaticAberration(img, co, (80, 60), 3))
