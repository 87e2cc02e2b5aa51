"""The port's calibration (``opencv_tpu_torch/calib3d/calibrate.py``) against
``opencv_tpu`` and cv2 on tests/test_calib3d.py's seeded scenes.

The port's residual is torch float64 under ``torch.func.jacfwd``; the JAX
package jits its own under ``jax.enable_x64``, and XLA orders and fuses
the float64 arithmetic its own way.  Measured here: every output within
3e-12 relative of the JAX package's (the distortion's smallest terms;
K within 3e-15); the tests hold them to 1e-6.  Against cv2 they hold the
reference tests' bounds."""

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv

from torch_threads import _one_torch_thread  # noqa: F401

REL = 1e-6


def _rel(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    scale = np.maximum(np.abs(b), np.abs(b).max() * 1e-6 + 1e-300)
    return float(np.max(np.abs(a - b) / scale))


def _views(seed, n_views, rvec_sd, noise, dist_gt, cols=7, rows=6):
    rng = np.random.default_rng(seed)
    K_gt = np.array([[800.0, 0, 320], [0, 780, 240], [0, 0, 1]])
    obj = np.array([[x, y, 0.0] for y in range(rows) for x in range(cols)], np.float32) * 0.03
    objpts, imgpts = [], []
    for i in range(n_views):
        rvec = rng.normal(0, rvec_sd, 3)
        tvec = np.array([rng.normal(0, 0.05), rng.normal(0, 0.05), 0.5 + 0.1 * i])
        proj, _ = cv2.projectPoints(obj, rvec, tvec, K_gt, dist_gt)
        objpts.append(obj)
        imgpts.append((proj.reshape(-1, 2) + rng.normal(0, noise, (len(obj), 2)))
                      .astype(np.float32))
    return objpts, imgpts


@pytest.mark.parametrize("seed", [0, 3])
def test_calibrate_camera_equals_opencv_tpu_and_matches_cv2(seed):
    objpts, imgpts = _views(seed, 8, 0.25, 0.1, np.array([0.1, -0.2, 0.001, 0.002, 0.05]))
    ours = tcv.calibrateCamera(objpts, imgpts, (640, 480))
    ref = jcv.calibrateCamera(objpts, imgpts, (640, 480))
    assert abs(ours[0] - ref[0]) <= REL * ref[0]
    for a, b in zip(ours[1:3], ref[1:3]):
        assert _rel(a, b) <= REL
    for a, b in zip(ours[3] + ours[4], ref[3] + ref[4]):
        assert np.asarray(a).shape == (3, 1) and _rel(a, b) <= REL
    ret_r, K_r, d_r, rv_r, _ = cv2.calibrateCamera(objpts, imgpts, (640, 480), None, None)
    assert abs(ours[0] - ret_r) < 1e-3
    np.testing.assert_allclose(ours[1], K_r, atol=0.05)
    np.testing.assert_allclose(ours[2].ravel(), d_r.ravel(), atol=1e-3)
    for a, b in zip(ours[3], rv_r):
        np.testing.assert_allclose(np.asarray(a).ravel(), np.asarray(b).ravel(), atol=1e-3)


def test_calibrate_camera_ro_equals_opencv_tpu_and_matches_cv2():
    objpts, imgpts = _views(2, 10, 0.3, 0.05, np.array([0.1, -0.15, 0.0, 0.0, 0.02]))
    ours = tcv.calibrateCameraRO(objpts, imgpts, (640, 480), 6)
    ref = jcv.calibrateCameraRO(objpts, imgpts, (640, 480), 6)
    assert abs(ours[0] - ref[0]) <= REL * ref[0]
    for a, b in zip((ours[1], ours[2], ours[5]), (ref[1], ref[2], ref[5])):
        assert _rel(a, b) <= REL
    assert ours[5].dtype == np.float32 and ours[5].shape == (42, 3)
    ret_r, K_r, d_r, _, _, no_r = cv2.calibrateCameraRO(objpts, imgpts, (640, 480), 6, None,
                                                        None)
    assert abs(ours[0] - ret_r) < 2e-3
    np.testing.assert_allclose(ours[1], K_r, atol=0.5)
    np.testing.assert_allclose(ours[2].ravel(), d_r.ravel(), atol=5e-3)
    np.testing.assert_allclose(ours[5], np.asarray(no_r).reshape(-1, 3), atol=5e-4)
    np.testing.assert_allclose(ours[5][0], objpts[0][0], atol=1e-12)
    np.testing.assert_allclose(ours[5][6], objpts[0][6], atol=1e-12)
    # with the fixed point out of range it is calibrateCamera
    plain = tcv.calibrateCameraRO(objpts, imgpts, (640, 480), 0)
    assert plain[0] == tcv.calibrateCamera(objpts, imgpts, (640, 480))[0]


def _stereo_views(seed=0, n=8):
    rng = np.random.default_rng(seed)
    K1 = np.array([[700.0, 0, 320], [0, 690, 240], [0, 0, 1]])
    K2 = np.array([[710.0, 0, 315], [0, 705, 245], [0, 0, 1]])
    d1 = np.array([0.05, -0.1, 0.001, 0.001, 0.0])
    d2 = np.array([-0.02, 0.05, -0.001, 0.002, 0.0])
    R_gt, _ = cv2.Rodrigues(np.array([0.02, 0.25, -0.01]))
    T_gt = np.array([-0.2, 0.01, 0.02])
    obj = np.array([[x, y, 0.0] for y in range(6) for x in range(8)], np.float32) * 0.04
    objpts, i1, i2 = [], [], []
    for k in range(n):
        rv = rng.normal(0, 0.3, 3)
        tv = np.array([rng.normal(0, 0.1), rng.normal(0, 0.1), 0.7 + 0.1 * k])
        p1, _ = cv2.projectPoints(obj, rv, tv, K1, d1)
        Rv, _ = cv2.Rodrigues(rv)
        rv2, _ = cv2.Rodrigues(R_gt @ Rv)
        p2, _ = cv2.projectPoints(obj, rv2, R_gt @ tv + T_gt, K2, d2)
        objpts.append(obj)
        i1.append((p1.reshape(-1, 2) + rng.normal(0, 0.15, (len(obj), 2))).astype(np.float32))
        i2.append((p2.reshape(-1, 2) + rng.normal(0, 0.15, (len(obj), 2))).astype(np.float32))
    return objpts, i1, i2, K1, d1, K2, d2


@pytest.fixture(scope="module")
def stereo_ref():
    """The scene and the JAX package's stereoCalibrate of it (one compile)."""
    views = _stereo_views()
    return views, jcv.stereoCalibrate(*views, (640, 480))


@pytest.mark.parametrize("as_tensors", [False, True])
def test_stereo_calibrate_equals_opencv_tpu_and_matches_cv2(as_tensors, stereo_ref):
    (objpts, i1, i2, K1, d1, K2, d2), ref = stereo_ref
    args = (objpts, i1, i2)
    if as_tensors:   # the residual follows the points' device (here the CPU)
        args = tuple([torch.from_numpy(p) for p in a] for a in args)
    ours = tcv.stereoCalibrate(*args, K1, d1, K2, d2, (640, 480))
    assert abs(ours[0] - ref[0]) <= REL * ref[0]
    for a, b in zip(ours[1:], ref[1:]):
        assert np.asarray(a).shape == np.asarray(b).shape and _rel(a, b) <= REL
    rms_r, _, _, _, _, R_r, T_r, _, _ = cv2.stereoCalibrate(objpts, i1, i2, K1, d1, K2, d2,
                                                           (640, 480),
                                                           flags=cv2.CALIB_FIX_INTRINSIC)
    assert abs(ours[0] - rms_r) < 1e-3
    np.testing.assert_allclose(ours[5], R_r, atol=1e-4)
    np.testing.assert_allclose(np.asarray(ours[6]).ravel(), np.asarray(T_r).ravel(), atol=1e-4)


def test_rodrigues_of_the_residual_equals_the_host_one():
    """The residual's batched rotation (with the JAX package's + 1e-12 in
    theta) against the host Rodrigues."""
    from opencv_tpu_torch.calib3d.calibrate import _rodrigues_t
    rng = np.random.default_rng(7)
    r = rng.normal(0, 1, (5, 3))
    R = _rodrigues_t(torch.from_numpy(r)).numpy()
    for i in range(5):
        np.testing.assert_allclose(R[i], tcv.Rodrigues(r[i])[0], atol=1e-11)
