"""The port's stereo-depth path, its calibration (``entry.calibrate_rig``)
on the CPU, on ``make_stereo_rig``'s data at (4, 540, 960, 3), against the
same chain of ``opencv_tpu`` calls and the rig's truth.

The JAX package's chain: cvtColor, findChessboardCorners and cornerSubPix
(11×11) of every view, the regularity check, calibrateCamera per camera,
stereoCalibrate, stereoRectify (alpha 0) and initUndistortRectifyMap.  The
corners and the pairs kept are equal exactly; the calibration within 1e-6
of each output's largest entry (the LM's float64 residual rounds apart and
stops a step apart: measured 5.1e-8 on camera 1's distortion, 3.5e-9 on its
K, 5.3e-12 on F);
given the port's calibration, the rectification and the float32 maps equal
exactly.  The truth at this size (measured: intrinsics within 0.33%, |T|
within 0.42%, RMS 0.031, 0.029 and 0.041 px, rectified rows 0.020 px) is
held to the path's gates (chip_smoke.py's phase 4p)."""

import numpy as np
import pytest
import torch

import opencv_tpu as jcv
from opencv_tpu.calib3d.chessboard import _sb_grid_regular as j_regular
from opencv_tpu_torch import entry as E

from torch_threads import _one_torch_thread  # noqa: F401

SHAPE = (4, 540, 960, 3)
REL = 1e-6


@pytest.fixture(scope="module")
def data():
    return E.make_stereo_rig(SHAPE)


@pytest.fixture(scope="module")
def rig(data):
    return E.calibrate_rig(torch.from_numpy(data["views"]), data["object_points"])


def _rel(a, b):
    """The largest difference over the largest entry of `b`."""
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def test_data_shapes_and_truth(data):
    N, H, W, _ = SHAPE
    assert data["views"].shape == (N, 2, H, W, 3) and data["views"].dtype == np.uint8
    assert data["scene"].shape == (2, H, W, 3) and data["object_points"].shape == (54, 3)
    assert data["disparity"].shape == (H, W) and data["disparity_half"].shape == (H // 2, W // 2)
    d = data["disparity"]
    f, b = data["rig"]["P1"][0, 0], np.linalg.norm(data["rig"]["T"])
    assert abs(b - E.STEREO_BASELINE_MM) < 1e-9
    assert np.allclose(np.unique(d), np.sort([f * b / p[0] for p in E.STEREO_PLANES]), rtol=1e-3)
    assert 0.5 < data["both"].mean() < 1.0
    # one seed, one result
    again = E.make_stereo_rig(SHAPE)
    assert np.array_equal(again["views"], data["views"])
    assert np.array_equal(again["scene"], data["scene"])


def test_corners_equal_opencv_tpu(data, rig):
    corners, pairs = [], []
    for i in range(SHAPE[0]):
        found = []
        for c in range(2):
            gray = np.asarray(jcv.cvtColor(data["views"][i, c], jcv.COLOR_BGR2GRAY))
            ok, pts = jcv.findChessboardCorners(gray, E.STEREO_BOARD, flags=3)
            if not ok:
                break
            pts = jcv.cornerSubPix(gray, pts, (11, 11), (-1, -1), (3, 30, 0.01))
            if not j_regular(pts.reshape(E.STEREO_BOARD[1], E.STEREO_BOARD[0], 2)):
                break
            found.append(pts)
        if len(found) == 2:
            corners.append(found)
            pairs.append(i)
    assert rig["pairs"] == pairs
    assert np.array_equal(rig["corners"], np.asarray(corners, np.float32).reshape(
        rig["corners"].shape))


def test_calibration_near_opencv_tpu(data, rig):
    n = len(rig["pairs"])
    objs = [data["object_points"]] * n
    c = rig["corners"]
    size = (SHAPE[2], SHAPE[1])
    for cam in (0, 1):
        rms, K, d, _, _ = jcv.calibrateCamera(objs, list(c[:, cam]), size)
        assert abs(rig[f"rms{cam + 1}"] - rms) <= REL * rms
        assert _rel(rig[f"K{cam + 1}"], K) <= REL and _rel(rig[f"d{cam + 1}"], d) <= REL
    out = jcv.stereoCalibrate(objs, list(c[:, 0]), list(c[:, 1]), rig["K1"], rig["d1"],
                              rig["K2"], rig["d2"], size)
    assert abs(rig["rms"] - out[0]) <= REL * out[0]
    for k, v in zip(("R", "T", "E", "F"), out[5:]):
        assert _rel(rig[k], v) <= REL, k


def test_rectification_and_maps_equal_opencv_tpu(rig):
    size = (SHAPE[2], SHAPE[1])
    ref = jcv.stereoRectify(rig["K1"], rig["d1"], rig["K2"], rig["d2"], size, rig["R"], rig["T"],
                            alpha=0)
    for k, v in zip(("R1", "R2", "P1", "P2", "Q"), ref[:5]):
        assert np.array_equal(rig[k], v), k
    assert tuple(rig["roi1"]) == tuple(ref[5]) and tuple(rig["roi2"]) == tuple(ref[6])
    for i, cam in enumerate((1, 2)):
        mx, my = jcv.initUndistortRectifyMap(rig[f"K{cam}"], rig[f"d{cam}"], rig[f"R{cam}"],
                                             rig[f"P{cam}"][:, :3], size)
        assert np.array_equal(rig["maps"][2 * i].numpy(), mx)
        assert np.array_equal(rig["maps"][2 * i + 1].numpy(), my)


def test_calibration_truth(data, rig):
    rep = E.stereo_calibration_report(rig, data)
    assert max(rep["intrinsics"]) <= E.STEREO_GATES["intrinsics"]
    assert rep["baseline"][1] <= E.STEREO_GATES["baseline"]
    assert max(rep["rms"][:2]) <= E.STEREO_GATES["rms"]
    assert rep["rows"] <= E.STEREO_GATES["rows"]
