"""ArUco and ChArUco of the port (``opencv_tpu_torch/objdetect/aruco.py``,
``charuco.py``) against the JAX package's and cv2, on the CPU.

The dictionaries (the port's own copy of aruco_dicts.npz) and the rendered
markers and boards equal both exactly.  Detection equals the JAX package's
exactly: the same thresholded planes (MEAN_C at windows 3, 13 and 23: the
port's boxFilter, which takes the sep_filter kernel on the card), so the same
contours, corners, ids and rejects; and it finds cv2's markers with corners
within 1 px, as tests/test_objdetect.py holds the JAX package."""

import numpy as np
import pytest
import torch

from common import cv2
from torch_threads import _one_torch_thread  # noqa: F401
import test_objdetect as R

import opencv_tpu as jcv
from opencv_tpu.objdetect import aruco as jaruco
import opencv_tpu_torch as tcv
from opencv_tpu_torch.objdetect import aruco as taruco


@pytest.mark.parametrize("ours_id,name", R.DICT_PAIRS)
def test_dictionary_equals_opencv_tpu_and_cv2(ours_id, name):
    t, j = taruco.getPredefinedDictionary(ours_id), jaruco.getPredefinedDictionary(ours_id)
    ref = cv2.aruco.getPredefinedDictionary(getattr(cv2.aruco, name))
    np.testing.assert_array_equal(t.bytesList, j.bytesList)
    np.testing.assert_array_equal(t.bytesList, ref.bytesList)
    np.testing.assert_array_equal(t._bits, j._bits)
    assert t.markerSize == j.markerSize == ref.markerSize
    assert t.maxCorrectionBits == j.maxCorrectionBits
    np.testing.assert_array_equal(t.getBitsFromByteList(t._raw[3, 0]),
                                  j.getBitsFromByteList(j._raw[3, 0]))


def test_generate_marker_equals_opencv_tpu_and_cv2():
    t = taruco.getPredefinedDictionary(taruco.DICT_6X6_250)
    j = jaruco.getPredefinedDictionary(jaruco.DICT_6X6_250)
    ref = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_6X6_250)
    for mid in (0, 17, 99, 249):
        for side in (8, 64, 101):
            got = taruco.generateImageMarker(t, mid, side)
            np.testing.assert_array_equal(got, jaruco.generateImageMarker(j, mid, side))
            np.testing.assert_array_equal(got, cv2.aruco.generateImageMarker(ref, mid, side))
    bits = t._bits[42, 1].reshape(6, 6)
    assert t.identify(bits) == j.identify(bits) == (True, 42, 1)


def _scenes():
    d_ref = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_5X5_100)
    scene = np.full((260, 340), 255, np.uint8)
    for mid, (x, y, side) in [(3, (20, 20, 60)), (55, (150, 30, 80)), (90, (60, 140, 72))]:
        scene[y:y + side, x:x + side] = cv2.aruco.generateImageMarker(d_ref, mid, side)
    out = []
    for angle in (0, 15):
        M = cv2.getRotationMatrix2D((170, 130), angle, 1.0)
        img = cv2.warpAffine(scene, M, (340, 260), borderValue=255)
        img = np.clip(img.astype(int) + np.random.default_rng(0).integers(-6, 6, img.shape),
                      0, 255).astype(np.uint8)
        out.append(img)
    return out


def _same_detection(got, want):
    (cg, ig, rg), (cw, iw, rw) = got, want
    assert (ig is None) == (iw is None)
    if iw is not None:
        np.testing.assert_array_equal(ig, iw)
    assert len(cg) == len(cw) and len(rg) == len(rw)
    for a, b in zip(cg + rg, cw + rw):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("view", [0, 1])
def test_detect_markers_equals_opencv_tpu_and_finds_cv2s(view):
    img = _scenes()[view]
    t = taruco.ArucoDetector(taruco.getPredefinedDictionary(taruco.DICT_5X5_100))
    j = jaruco.ArucoDetector(jaruco.getPredefinedDictionary(jaruco.DICT_5X5_100))
    want = j.detectMarkers(img)
    for x in (img, torch.from_numpy(img), torch.from_numpy(np.repeat(img[..., None], 3, -1))):
        _same_detection(t.detectMarkers(x), want)
    gray = torch.from_numpy(img)
    for win, plane in zip((3, 13, 23), t.thresholded(gray)):
        np.testing.assert_array_equal(
            plane.numpy(), np.asarray(jcv.adaptiveThreshold(
                img, 255, jcv.ADAPTIVE_THRESH_MEAN_C, jcv.THRESH_BINARY_INV, win, 7)))
    c_r, i_r, _ = cv2.aruco.ArucoDetector(
        cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_5X5_100)).detectMarkers(img)
    c_o, i_o, _ = want
    assert sorted(i_o.ravel().tolist()) == sorted(i_r.ravel().tolist())
    ref = {int(i): np.asarray(c) for i, c in zip(i_r.ravel(), c_r)}
    for i, c in zip(i_o.ravel(), c_o):
        assert np.abs(ref[int(i)] - np.asarray(c)).max() <= 1.0


def test_boards_and_drawing_equal_opencv_tpu():
    t = taruco.getPredefinedDictionary(taruco.DICT_4X4_50)
    j = jaruco.getPredefinedDictionary(jaruco.DICT_4X4_50)
    gt, gj = taruco.GridBoard((3, 2), 0.04, 0.01, t), jaruco.GridBoard((3, 2), 0.04, 0.01, j)
    np.testing.assert_array_equal(gt.generateImage((300, 200), 10),
                                  gj.generateImage((300, 200), 10))
    assert gt.getGridSize() == gj.getGridSize() and gt.getRightBottomCorner() == \
        gj.getRightBottomCorner()
    img = gt.generateImage((300, 200), 10)
    det = taruco.ArucoDetector(t).detectMarkers(img)
    assert det[1] is not None and len(det[1]) == 6
    for a, b in zip(gt.matchImagePoints(det[0], det[1]), gj.matchImagePoints(det[0], det[1])):
        np.testing.assert_array_equal(a, b)
    color = np.repeat(img[..., None], 3, -1)
    drawn_t = taruco.drawDetectedMarkers(color.copy(), det[0], det[1])
    drawn_j = jaruco.drawDetectedMarkers(color.copy(), det[0], det[1])
    np.testing.assert_array_equal(np.asarray(drawn_t), drawn_j)
    p = taruco.RefineParameters()
    assert vars(p) == vars(jaruco.RefineParameters())
    assert vars(taruco.DetectorParameters()) == vars(jaruco.DetectorParameters())
    assert vars(taruco.CharucoParameters()) == vars(jaruco.CharucoParameters())


def _same_board(got, want):
    for a, b in zip(got, want):
        if isinstance(b, tuple):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        elif b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)


def test_charuco_equals_opencv_tpu_and_cv2():
    d_r = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_4X4_50)
    board_r = cv2.aruco.CharucoBoard((5, 4), 40.0, 30.0, d_r)
    img = board_r.generateImage((420, 340), marginSize=10)
    bt = taruco.CharucoBoard((5, 4), 40.0, 30.0, taruco.getPredefinedDictionary(taruco.DICT_4X4_50))
    bj = jaruco.CharucoBoard((5, 4), 40.0, 30.0, jaruco.getPredefinedDictionary(jaruco.DICT_4X4_50))
    np.testing.assert_array_equal(bt.generateImage((420, 340), marginSize=10), img)
    assert bt.nearestMarkerIdx == bj.nearestMarkerIdx
    assert bt.nearestMarkerCorners == bj.nearestMarkerCorners
    got = taruco.CharucoDetector(bt).detectBoard(img)
    _same_board(got, jaruco.CharucoDetector(bj).detectBoard(img))
    _same_board(tcv.aruco_CharucoDetector(bt).detectBoard(torch.from_numpy(img)), got)
    cc_r, ci_r, _, _ = cv2.aruco.CharucoDetector(board_r).detectBoard(img)
    ri = {int(i): c for i, c in zip(ci_r.ravel(), cc_r.reshape(-1, 2))}
    oi = {int(i): c for i, c in zip(got[1].ravel(), got[0].reshape(-1, 2))}
    assert set(ri) == set(oi)
    assert max(np.linalg.norm(ri[i] - oi[i]) for i in ri) < 0.15


def test_charuco_perspective_view_equals_opencv_tpu():
    d_r = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_5X5_100)
    img = cv2.aruco.CharucoBoard((6, 5), 30.0, 22.0, d_r).generateImage((480, 400), marginSize=16)
    Hm = cv2.getPerspectiveTransform(np.float32([[0, 0], [479, 0], [479, 399], [0, 399]]),
                                     np.float32([[14, 22], [462, 8], [470, 380], [6, 390]]))
    warped = cv2.warpPerspective(img, Hm, (480, 400), borderValue=255)
    bt, bj = (m.CharucoBoard((6, 5), 30.0, 22.0, m.getPredefinedDictionary(m.DICT_5X5_100))
              for m in (taruco, jaruco))
    got = taruco.CharucoDetector(bt).detectBoard(warped)
    _same_board(got, jaruco.CharucoDetector(bj).detectBoard(warped))
    assert got[1] is not None and len(got[1]) >= 15
