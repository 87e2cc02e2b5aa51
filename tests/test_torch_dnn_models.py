"""The port's dnn Model classes against opencv_tpu.dnn's (and cv2 where
tests/test_dnn.py and test_dnn_models.py check cv2), on the CPU: the same
model files, the same frames; the results equal (class ids, boxes, strings,
polygons exactly; scores and points within MODEL_TOL, as the nets' f32
convolutions sum in their own orders)."""

import os
import sys
import tempfile

import numpy as np
import pytest
import torch

from common import cv2
from torch_threads import _one_torch_thread  # noqa: F401
from test_dnn import _tiny_yolo_cfg_weights
from test_dnn_models import (VOC, _ctc_net, _db_net, _east_net, _heatmap_net,
                             _pred_image)
from test_dnn_trackers import _model, _node, _save, _tensor

import opencv_tpu.dnn as jdnn
import opencv_tpu_torch.dnn as tdnn

sys.path.insert(0, os.path.dirname(__file__))
from tflite_builder import build_tflite_convnet  # noqa: E402

MODEL_TOL = dict(rtol=1e-5, atol=1e-5)


def _both(cls, path, **kw):
    return getattr(jdnn, cls)(path), getattr(tdnn, cls)(path, device="cpu")


def test_classification_model():
    data, _, _ = build_tflite_convnet(seed=11)
    path = os.path.join(tempfile.mkdtemp(), "m.tflite")
    open(path, "wb").write(data)
    frame = np.random.default_rng(3).integers(0, 256, (8, 8, 3), np.uint8)
    j, t = _both("ClassificationModel", path)
    for m in (j, t):
        m.setInputParams(scale=1 / 255.0, size=(8, 8))
    (jid, jconf), (tid, tconf) = j.classify(frame), t.classify(frame)
    assert tid == jid and abs(tconf - jconf) < 1e-5
    ref = cv2.dnn.ClassificationModel(path)
    ref.setInputParams(scale=1 / 255.0, size=(8, 8))
    rid, rconf = ref.classify(frame)
    assert tid == rid and abs(tconf - rconf) < 1e-5
    # a frame given as a tensor classifies the same
    assert t.classify(torch.from_numpy(frame))[0] == tid


@pytest.mark.parametrize("across", [False, True])
def test_detection_model_yolo(across):
    tmp = tempfile.mkdtemp()
    cfgp, wp = _tiny_yolo_cfg_weights(tmp)
    frame = np.random.default_rng(4).integers(0, 256, (45, 61, 3), np.uint8)
    res = []
    for dnn, kw in ((jdnn, {}), (tdnn, {"device": "cpu"})):
        m = dnn.DetectionModel(dnn.readNetFromDarknet(cfgp, wp, **kw))
        m.setInputParams(scale=1 / 255.0, size=(32, 32), swapRB=True)
        m.setNmsAcrossClasses(across)
        assert m.getNmsAcrossClasses() == across
        res.append([m.detect(frame, c, n) for c, n in ((0.3, 0.4), (0.2, 0.0), (0.5, 0.5))])
    for (jc, js, jb), (tc, ts, tb) in zip(*res):
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_allclose(ts, js, **MODEL_TOL)
        assert tc.dtype == np.int32 and tb.dtype == np.int32 and ts.dtype == np.float32
    assert len(res[1][1][0]) > 0


def test_detection_model_detection_output():
    """A net whose output is DetectionOutput's [1, 1, N, 7] rows, pixel
    and normalised boxes."""
    rows = np.asarray([[0, 1, 0.9, 3, 4, 20, 30], [0, 2, 0.4, 1, 1, 5, 5],
                       [0, 3, 0.8, 0.1, 0.2, 0.6, 0.9], [0, 1, 0.7, -5, -5, 100, 80]],
                      np.float32).reshape(1, 1, 4, 7)
    m = _model([("input", (1, 3, 0, 0))], [("out", (1, 1, 4, 7))],
               [_node("ReduceMean", ["input"], ["gm"], keepdims=0),
                _node("Mul", ["gm", "zero"], ["z"]),
                _node("Add", ["rows", "z"], ["out"])],
               [_tensor("rows", rows), _tensor("zero", np.zeros((), np.float32))])
    path = _save(m, os.path.join(tempfile.mkdtemp(), "det.onnx"))
    frame = np.zeros((48, 64, 3), np.uint8)
    j, t = _both("DetectionModel", path)
    for a, b in zip(j.detect(frame, 0.5), t.detect(frame, 0.5)):
        np.testing.assert_array_equal(b, a)


def test_segmentation_model():
    w = np.random.default_rng(0).normal(0, 1, (5, 3, 1, 1)).astype(np.float32)
    m = _model([("input", (1, 3, 0, 0))], [("out", (1, 5, 0, 0))],
               [_node("Conv", ["input", "w"], ["out"], kernel_shape=[1, 1])], [_tensor("w", w)])
    path = _save(m, os.path.join(tempfile.mkdtemp(), "seg.onnx"))
    frame = np.random.default_rng(1).integers(0, 256, (24, 32, 3), np.uint8)
    j, t = _both("SegmentationModel", path)
    for m_ in (j, t):
        m_.setInputScale(1 / 255.0).setInputMean((10, 20, 30)).setInputSwapRB(True)
    np.testing.assert_array_equal(t.segment(frame), j.segment(frame))


def test_keypoints_model():
    tmp = tempfile.mkdtemp()
    mp = _heatmap_net(tmp)
    frame = np.random.default_rng(1).integers(0, 40, (64, 80, 3), np.uint8)
    frame[20, 30] = (255, 0, 0)
    j, t = _both("KeypointsModel", mp)
    for m in (j, t):
        m.setInputSize((80, 64))
        m.setInputScale(1 / 255.0)
    np.testing.assert_allclose(t.estimate(frame, 0.3), j.estimate(frame, 0.3), **MODEL_TOL)
    ref = cv2.dnn.KeypointsModel(mp)
    ref.setInputSize((80, 64))
    ref.setInputScale(1 / 255.0)
    np.testing.assert_allclose(t.estimate(frame, 0.3),
                               np.asarray(ref.estimate(frame, 0.3), np.float32).reshape(-1, 2),
                               atol=1.0)


@pytest.mark.parametrize("decode", ["CTC-greedy", "CTC-prefix-beam-search"])
def test_text_recognition(decode):
    tmp = tempfile.mkdtemp()
    mp = _ctc_net(tmp)
    img = _pred_image(np.random.default_rng(0))
    out = []
    for m in _both("TextRecognitionModel", mp):
        m.setDecodeType(decode).setVocabulary(VOC)
        m.setDecodeOptsCTCPrefixBeamSearch(10)
        assert m.getDecodeType() == decode and m.getVocabulary() == VOC
        out.append((m.recognize(img), m.recognize(img, [(0, 0, 11, 12)])))
    assert out[0] == out[1]
    if decode == "CTC-greedy":
        ref = cv2.dnn.TextRecognitionModel(mp)
        ref.setDecodeType(decode)
        ref.setVocabulary(VOC)
        assert out[1][0] == ref.recognize(img)


def test_text_detection_east():
    tmp = tempfile.mkdtemp()
    mp = _east_net(tmp)
    frame = np.zeros((96, 128), np.uint8)
    frame[40:56, 32:96] = 255
    res = []
    for m in _both("TextDetectionModel_EAST", mp):
        m.setInputSize((128, 96))
        m.setInputScale(1 / 255.0)
        m.setConfidenceThreshold(0.8)
        m.setNMSThreshold(0.4)
        assert (m.getConfidenceThreshold(), m.getNMSThreshold()) == (0.8, 0.4)
        res.append(m.detectTextRectangles(frame))
    (jb, js), (tb, ts) = res
    assert len(tb) == len(jb) >= 1
    np.testing.assert_allclose(np.asarray([(*c, *s, a) for c, s, a in tb]),
                               np.asarray([(*c, *s, a) for c, s, a in jb]), **MODEL_TOL)
    np.testing.assert_allclose(ts, js, **MODEL_TOL)


def test_text_detection_db():
    tmp = tempfile.mkdtemp()
    mp = _db_net(tmp)
    frame = np.zeros((96, 128), np.uint8)
    frame[30:50, 20:90] = 255
    frame[70:80, 10:40] = 200
    res = []
    for m in _both("TextDetectionModel_DB", mp):
        m.setInputSize((128, 96))
        m.setInputScale(1 / 255.0)
        m.setBinaryThreshold(0.3).setPolygonThreshold(0.5).setUnclipRatio(2.0)
        m.setMaxCandidates(0)
        res.append((m.detect(frame), m.detectTextRectangles(frame)))
    ((jp, jc), (jr, _)), ((tp, tc), (tr, _)) = res
    assert len(tp) == len(jp) >= 1
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a, b, **MODEL_TOL)
    np.testing.assert_allclose(tc, jc, **MODEL_TOL)
    np.testing.assert_allclose(np.asarray([(*c, *s, a) for c, s, a in tr]),
                               np.asarray([(*c, *s, a) for c, s, a in jr]), **MODEL_TOL)
