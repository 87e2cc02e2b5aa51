"""The object-detection path (``entry.forward_objdetect``) at half size on
the CPU: ``make_marker_scene``'s (2, 540, 960, 3) frames and its chart,
against the JAX package's detectors stage by stage, and against the scene's
truth.

Frame 0: the markers, the ChArUco corners, the QR code (on the codes' band,
entry.QR_ROI) and the chart equal the JAX package's exactly (the barcode is
held to it in tests/test_torch_objdetect_codes.py, and here to the truth:
its JAX twin compiles for seconds at this size); HOG is held on the
frame's top-left 136 x 240 crop (the JAX package's numpy HOG takes minutes
at 540 x 960) within the bounds of
tests/test_torch_objdetect_hog.py.  Frame 1 holds a contour whose 4-point
approximation has three corners on a line: the JAX package's detectMarkers
raises LinAlgError on it, the port rejects the candidate and finds every
free marker (ROADMAP queue C).  The truth at this size: every free marker
with its id within MARKER_CORNER_TOL, the QR and EAN texts, the chart's
patches within MCC_TOL (the board's markers are 15 px here, too small for
the ChArUco gate, which chip_smoke.py's 1080p run holds)."""

import numpy as np
import pytest
import torch

from torch_threads import _one_torch_thread  # noqa: F401

import opencv_tpu as jcv
from opencv_tpu.objdetect import aruco as jaruco
from opencv_tpu.objdetect.hog import HOGDescriptor as JHOG
from opencv_tpu_torch import entry as E

SHAPE = (2, 540, 960, 3)
HOG_SCORE_ATOL = 5e-5


@pytest.fixture(scope="module")
def run():
    frames, chart, truth = E.make_marker_scene(SHAPE)
    det = E.make_objdetectors("cpu")
    times = {}
    out = E.forward_objdetect(torch.from_numpy(frames), torch.from_numpy(chart), det, times)
    return frames, chart, truth, det, out, times


def test_objdetect_truth(run):
    _, _, truth, _, out, times = run
    rep = E.objdetect_truth_report(out, truth)
    assert rep["markers_missed"] == 0 and rep["marker_corner_err"] <= E.MARKER_CORNER_TOL
    assert rep["qr_decoded"] == rep["ean_decoded"] == SHAPE[0]
    assert rep["mcc_err"] <= E.MCC_TOL
    assert set(times) == set(E.OBJDETECT_STAGES)


def _same(a, b):
    if isinstance(b, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif b is None or isinstance(b, str):
        assert a == b
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_objdetect_frame0_equals_opencv_tpu(run):
    frames, chart, _, _, out, _ = run
    f = frames[0]
    d = jaruco.getPredefinedDictionary(E.MARKER_DICT)
    board = jaruco.CharucoBoard(E.CHARUCO_SQUARES, E.CHARUCO_SQUARE_M, E.CHARUCO_MARKER_M, d)
    _same(out["aruco"][0], jaruco.ArucoDetector(d).detectMarkers(f))
    _same(out["charuco"][0], jaruco.CharucoDetector(board).detectBoard(f))
    x0, y0, x1, y1 = E.qr_roi(SHAPE[1])
    roi = np.ascontiguousarray(f[y0:y1, x0:x1])
    text, pts, straight = jcv.QRCodeDetector().detectAndDecode(roi)
    _same(out["qr"][0], (text, pts + np.float32([x0, y0]), straight))
    j = jcv.mcc_CCheckerDetector.create()
    assert j.process(chart, 0)
    _same(out["mcc"], j.getBestColorChecker().getChartsRGB().reshape(-1, 3))
    rects, weights = out["hog"][0]
    assert rects.dtype == np.int32 and rects.shape[1] == 4


def test_objdetect_hog_crop_equals_opencv_tpu(run):
    frames, _, _, det, _, _ = run
    crop = np.ascontiguousarray(frames[0, :136, :240])
    j = JHOG()
    j.setSVMDetector(JHOG.getDefaultPeopleDetector())
    for thr in (-2.0, -1.0):
        kw = dict(E.HOG_DETECT, hitThreshold=thr, groupThreshold=0)
        rt, wt = det["hog"].detectMultiScale(torch.from_numpy(crop), **kw)
        rj, wj = j.detectMultiScale(crop, **kw)
        np.testing.assert_array_equal(rt, rj)
        assert np.abs(wt - wj).max(initial=0) <= HOG_SCORE_ATOL
        assert len(rt) > 0 or thr > -2


def test_objdetect_degenerate_quad_rejected(run):
    frames, _, truth, _, out, _ = run
    d = jaruco.getPredefinedDictionary(E.MARKER_DICT)
    with pytest.raises(np.linalg.LinAlgError):
        jaruco.ArucoDetector(d).detectMarkers(frames[1])
    _, ids, rejected = out["aruco"][1]
    assert {m for m, _ in truth["markers"][1]} <= set(np.ravel(ids).tolist())
    assert len(rejected) > 0
