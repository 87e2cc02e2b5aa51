"""The port's ECC, DIS, variational refinement, TrackerMIL, meanShift,
CamShift and Kalman filter (``opencv_tpu_torch.video``) on the CPU, against
``opencv_tpu.video`` and cv2.

- Kalman, meanShift, CamShift, TrackerMIL and ECC (host numpy over the
  port's cvtColor, f32 GaussianBlur and pyrDown): exact.
- Variational refinement: exact against the JAX package's program run under
  ``jax.disable_jit()``; against its jitted program (XLA contracts the
  multiply-adds) within VR_TOL px (ROADMAP.md queue C).
- DIS: exact without the refinement (the ULTRAFAST preset) and, with it
  (the FAST preset), exact against the JAX package under
  ``jax.disable_jit()``, and within VR_TOL px of its jitted program.
- cv2: the reference tests' scenes and bounds (tests/test_video.py)."""

import jax
import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu_torch import entry as E
from torch_threads import _one_torch_thread  # noqa: F401

VR_TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    """Gray frames 0 and 1 of a (2, 48, 64) shaking video with movers, and
    the camera's shift."""
    video, shifts, _ = E.make_motion_video((2, 48, 64, 3))
    g = [cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) for f in video]
    return g[0], g[1], shifts[1]


def test_kalman_equals_opencv_tpu_and_matches_cv2():
    kf = [tcv.KalmanFilter(4, 2), jcv.KalmanFilter(4, 2), cv2.KalmanFilter(4, 2)]
    A = np.array([[1, 0, 1, 0], [0, 1, 0, 1], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    Hm = np.array([[1, 0, 0, 0], [0, 1, 0, 0]], np.float32)
    for k in kf:
        k.transitionMatrix = A.copy()
        k.measurementMatrix = Hm.copy()
        k.processNoiseCov = np.eye(4, dtype=np.float32) * 1e-3
        k.measurementNoiseCov = np.eye(2, dtype=np.float32) * 1e-1
        k.errorCovPost = np.eye(4, dtype=np.float32)
    for t in range(12):
        z = np.array([[t * 1.5 + 0.1 * np.sin(t)], [t * 0.7]], np.float32)
        ps = [k.predict() for k in kf]
        cs = [kf[0].correct(torch.from_numpy(z)), kf[1].correct(z), kf[2].correct(z)]
        assert np.array_equal(ps[0], ps[1]) and np.array_equal(cs[0], cs[1])
        np.testing.assert_allclose(ps[0], ps[2], atol=1e-3)
        np.testing.assert_allclose(cs[0], cs[2], atol=1e-3)
    assert np.array_equal(kf[0].gain, kf[1].gain)
    kc = [tcv.KalmanFilter(2, 1, 1), jcv.KalmanFilter(2, 1, 1)]
    for k in kc:
        k.controlMatrix = np.array([[0.5], [1.0]], np.float32)
    u = np.array([[2.0]], np.float32)
    assert np.array_equal(kc[0].predict(torch.from_numpy(u)), kc[1].predict(u))


def _blob(draw):
    prob = np.zeros((120, 160), np.uint8)
    draw(prob)
    return prob


@pytest.mark.parametrize("crit", [(3, 10, 1), (1, 5, 0), (2, 1, 0.5)])
def test_mean_shift_and_cam_shift_equal_opencv_tpu(crit):
    prob = _blob(lambda p: cv2.circle(p, (60, 55), 10, 255, -1))
    for win in ((30, 30, 24, 24), (150, 110, 20, 20), (0, 0, 10, 10)):
        assert tcv.meanShift(torch.from_numpy(prob), win, crit) == jcv.meanShift(prob, win, crit)
    ell = _blob(lambda p: cv2.ellipse(p, (60, 50), (15, 8), 30, 0, 360, 255, -1))
    for win in ((40, 35, 40, 30), (100, 90, 20, 20)):
        assert tcv.CamShift(torch.from_numpy(ell), win, crit) == jcv.CamShift(ell, win, crit)


def test_mean_shift_and_cam_shift_match_cv2():
    """tests/test_video.py's meanShift and CamShift scenes and bounds."""
    prob = _blob(lambda p: cv2.circle(p, (60, 55), 10, 255, -1))
    _, rwin = cv2.meanShift(prob, (30, 30, 24, 24), (3, 10, 1))
    _, owin = tcv.meanShift(prob, (30, 30, 24, 24), (3, 10, 1))
    assert abs(rwin[0] - owin[0]) <= 2 and abs(rwin[1] - owin[1]) <= 2
    ell = _blob(lambda p: cv2.ellipse(p, (60, 50), (15, 8), 30, 0, 360, 255, -1))
    rrect, _ = cv2.CamShift(ell, (40, 35, 40, 30), (3, 10, 1))
    orect, _ = tcv.CamShift(ell, (40, 35, 40, 30), (3, 10, 1))
    assert abs(rrect[0][0] - orect[0][0]) < 3 and abs(rrect[0][1] - orect[0][1]) < 3


@pytest.fixture(scope="module")
def ecc_scene():
    img = np.zeros((120, 160), np.uint8)
    cv2.circle(img, (50, 40), 20, 200, -1)
    cv2.rectangle(img, (90, 60), (140, 100), 120, -1)
    cv2.line(img, (10, 100), (150, 20), 80, 3)
    img = cv2.GaussianBlur(img, (0, 0), 2)
    A_gt = np.float32([[1.01, 0.02, 1.5], [-0.02, 0.99, -1.0]])
    warped = cv2.warpAffine(img, A_gt, (160, 120), flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP)
    return img, warped


@pytest.mark.parametrize("motion", [0, 1, 2, 3])
def test_ecc_equals_opencv_tpu_and_matches_cv2(ecc_scene, motion):
    img, warped = ecc_scene
    crit = (3, 200, 1e-6)
    rho_t, M_t = tcv.findTransformECC(torch.from_numpy(img), warped, None, motion, crit, None, 5)
    rho_j, M_j = jcv.findTransformECC(img, warped, None, motion, crit, None, 5)
    assert rho_t == rho_j and np.array_equal(M_t, M_j)
    rows = 3 if motion == 3 else 2
    rho_r, M_r = cv2.findTransformECC(img, warped, np.eye(rows, 3, dtype=np.float32), motion,
                                      (cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, 200, 1e-6),
                                      None, 5)
    assert abs(rho_r - rho_t) < 1e-4
    np.testing.assert_allclose(M_t, M_r, atol=1e-3)


def test_ecc_masks_multiscale_and_compute_ecc(ecc_scene):
    img, warped = ecc_scene
    assert tcv.computeECC(torch.from_numpy(img), warped) == jcv.computeECC(img, warped)
    assert abs(tcv.computeECC(img, warped) - cv2.computeECC(img, warped)) < 1e-3
    mask = np.zeros_like(img)
    mask[10:110, 10:150] = 255
    assert tcv.computeECC(img, warped, mask) == jcv.computeECC(img, warped, mask)
    crit = (3, 30, 1e-5)
    got = tcv.findTransformECC(img, warped, None, tcv.MOTION_AFFINE, crit, torch.from_numpy(mask))
    assert got[0] == jcv.findTransformECC(img, warped, None, 2, crit, mask)[0]
    tmask = np.zeros_like(img)
    tmask[5:115, 20:140] = 1
    got = tcv.findTransformECCWithMask(img, warped, tmask, mask, None, 2, crit)
    want = jcv.findTransformECCWithMask(img, warped, tmask, mask, None, 2, crit)
    assert got[0] == want[0] and np.array_equal(got[1], want[1])
    big = cv2.resize(img, (320, 240))
    bigw = cv2.resize(warped, (320, 240))
    got = tcv.findTransformECCMultiScale(torch.from_numpy(big), bigw, None, (0, 3))
    want = jcv.findTransformECCMultiScale(big, bigw, None, (0, 3))
    assert got[0] == want[0] and np.array_equal(got[1], want[1])


def test_variational_refinement_equals_the_eager_jax_program(pair):
    g0, g1, shift = pair
    rng = np.random.default_rng(0)
    u = (rng.standard_normal(g0.shape) * 0.5 + shift[0]).astype(np.float32)
    v = (rng.standard_normal(g0.shape) * 0.5 + shift[1]).astype(np.float32)
    jv = jcv.VariationalRefinement_create()
    jv.setFixedPointIterations(3)
    jv.setSorIterations(3)
    tv = tcv.VariationalRefinement_create()
    tv.setFixedPointIterations(3)
    tv.setSorIterations(3)
    with jax.disable_jit():
        eu, ev = jv.calcUV(g0, g1, u.copy(), v.copy())
    tu, tvv = tv.calcUV(torch.from_numpy(g0), torch.from_numpy(g1), u.copy(), v.copy())
    assert np.array_equal(eu, tu.numpy()) and np.array_equal(ev, tvv.numpy())
    ju, jvv = jv.calcUV(g0, g1, u.copy(), v.copy())
    assert np.abs(ju - tu.numpy()).max() <= VR_TOL and np.abs(jvv - tvv.numpy()).max() <= VR_TOL


def test_variational_refinement_api_writes_back(pair):
    g0, g1, _ = pair
    tv, jv = tcv.VariationalRefinement_create(), jcv.VariationalRefinement_create()
    for name, val in (("FixedPointIterations", 2), ("SorIterations", 4), ("Omega", 1.5),
                      ("Alpha", 10.0), ("Delta", 4.0), ("Gamma", 8.0), ("Epsilon", 0.01)):
        getattr(tv, "set" + name)(val)
        getattr(jv, "set" + name)(val)
        assert getattr(tv, "get" + name)() == val
    flow = np.zeros(g0.shape + (2,), np.float32)
    t_flow, j_flow = flow.copy(), flow.copy()
    out = tv.calc(g0, g1, t_flow)
    jv.calc(g0, g1, j_flow)
    assert np.array_equal(out.numpy(), t_flow)
    assert np.abs(t_flow - j_flow).max() <= VR_TOL
    u = torch.zeros(g0.shape)
    tv.calcUV(g0, g1, u, torch.zeros(g0.shape))
    assert np.array_equal(u.numpy(), t_flow[..., 0])
    tv.setFixedPointIterations(0)
    assert np.array_equal(tv.calcUV(g0, g1, flow[..., 0], flow[..., 1])[0].numpy(), flow[..., 0])


def test_variational_refinement_matches_cv2():
    """tests/test_video.py::test_variational_refinement_matches_cv2's bounds."""
    rng = np.random.default_rng(3)
    base = (cv2.GaussianBlur(rng.random((80, 96)).astype(np.float32), (0, 0), 3)
            * 255).astype(np.uint8)
    nxt = cv2.warpAffine(base, np.float32([[1, 0, 1.5], [0, 1, -1.0]]), (96, 80))
    u0 = np.full((80, 96), 1.2, np.float32) + rng.normal(0, 0.2, (80, 96)).astype(np.float32)
    v0 = np.full((80, 96), -0.8, np.float32) + rng.normal(0, 0.2, (80, 96)).astype(np.float32)
    ru, rv = u0.copy(), v0.copy()
    cv2.VariationalRefinement_create().calcUV(base, nxt, ru, rv)
    ou, ov = tcv.VariationalRefinement_create().calcUV(base, nxt, u0.copy(), v0.copy())
    d = np.hypot(ru - ou.numpy(), rv - ov.numpy())
    assert np.median(d) < 0.03 and d.mean() < 0.08


def _dis_scene():
    rng = np.random.default_rng(0)
    base = (cv2.GaussianBlur(rng.random((160, 200)).astype(np.float32), (0, 0), 4)
            * 255).astype(np.uint8)
    nxt = cv2.warpAffine(base, np.float32([[1, 0, 5.0], [0, 1, -3.0]]), (200, 160))
    return base, nxt


def test_dis_without_refinement_equals_opencv_tpu_and_matches_cv2(pair):
    g0, g1, _ = pair
    big0, big1 = cv2.resize(g0, (128, 96)), cv2.resize(g1, (128, 96))
    got = tcv.DISOpticalFlow_create(tcv.DISOpticalFlow.PRESET_ULTRAFAST).calc(
        torch.from_numpy(big0), big1, None)
    want = jcv.DISOpticalFlow_create(jcv.DISOpticalFlow.PRESET_ULTRAFAST).calc(big0, big1, None)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    base, nxt = _dis_scene()
    ours = tcv.DISOpticalFlow_create(tcv.DISOpticalFlow.PRESET_ULTRAFAST).calc(base, nxt, None)
    ref_dis = cv2.DISOpticalFlow_create(cv2.DISOpticalFlow_PRESET_ULTRAFAST)
    ref_dis.setVariationalRefinementIterations(0)
    ref = ref_dis.calc(base, nxt, None)
    inner = (slice(24, -24), slice(24, -24))
    assert np.median(np.linalg.norm(ref[inner] - ours[inner], axis=-1)) < 0.25
    assert np.linalg.norm(ours[inner] - np.array([5.0, -3.0]), axis=-1).mean() < 0.5


def test_dis_with_refinement_equals_opencv_tpu(pair):
    g0, g1, _ = pair
    t, j = tcv.DISOpticalFlow_create(), jcv.DISOpticalFlow_create()
    for d in (t, j):
        d.setVariationalRefinementIterations(1)
        d.setFinestScale(1)
        d.setGradientDescentIterations(4)
    with jax.disable_jit():
        want = j.calc(g0, g1, None)
    got = t.calc(g0, g1, None)
    assert np.array_equal(got, want)
    assert np.abs(j.calc(g0, g1, None) - got).max() <= VR_TOL
    assert t.getFinestScale() == 1 and t.getVariationalRefinementIterations() == 1


def _mil_frames():
    rng = np.random.default_rng(0)
    H, W = 120, 160
    bg = cv2.GaussianBlur(rng.integers(0, 256, (H, W), np.uint8), (0, 0), 4)
    frames, boxes = [], []
    for t in range(10):
        f = bg.copy()
        x, y = 20 + 4 * t, 30 + 2 * t
        f[y:y + 24, x:x + 30] = 230
        f[y + 6:y + 18, x + 8:x + 22] = 60
        frames.append(np.stack([f] * 3, -1))
        boxes.append((x, y, 30, 24))
    return frames, boxes


def test_tracker_mil_equals_opencv_tpu_and_tracks():
    """tests/test_video.py::test_tracker_mil's sequence and bound; every box
    equal to the JAX package's."""
    frames, boxes = _mil_frames()

    def iou(a, b):
        x0, y0 = max(a[0], b[0]), max(a[1], b[1])
        x1, y1 = min(a[0] + a[2], b[0] + b[2]), min(a[1] + a[3], b[1] + b[3])
        inter = max(0, x1 - x0) * max(0, y1 - y0)
        return inter / (a[2] * a[3] + b[2] * b[3] - inter)

    tr, jr = tcv.TrackerMIL_create(), jcv.TrackerMIL_create()
    assert tr.init(torch.from_numpy(frames[0]), boxes[0]) and jr.init(frames[0], boxes[0])
    ious = []
    for f, gt in zip(frames[1:], boxes[1:]):
        got, want = tr.update(torch.from_numpy(f)), jr.update(f)
        assert got == want
        ious.append(iou(got[1], gt))
    assert np.mean(ious) > 0.6
    g = tcv.TrackerMIL.create()
    assert g.init(frames[0][..., 0], boxes[0]) and g.update(frames[1][..., 0])[0]
