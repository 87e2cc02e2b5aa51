"""The detection path (``entry.forward_detect``) on the CPU at a small cut —
YOLOv3-tiny with every hidden width divided by 8 at a 64×64 input, on two
(108, 192) frames — against the JAX package's composition of the same
stages (``opencv_tpu.dnn``'s blobFromImages, readNetFromDarknet of the same
files, DetectionModel.detect's decode and NMSBoxesBatched): the blob within
1e-6, the heads within DETECT_TOL, the decoded rows and the kept boxes
equal.  And the full-width cfg: its layers, parameters and operations as
Darknet's yolov3-tiny.cfg gives them."""

import os

import numpy as np
import pytest
import torch

from torch_threads import _one_torch_thread  # noqa: F401

import opencv_tpu.dnn as jdnn
from opencv_tpu_torch import entry as E
from opencv_tpu_torch.dnn import readNetFromDarknet

DETECT_TOL = dict(rtol=1e-5, atol=1e-5)
SHAPE = (2, 108, 192, 3)
CUT = dict(width_div=8, size=64)


@pytest.fixture(scope="module")
def run():
    frames = E.make_detect_frames(SHAPE, 0)
    net = E.make_detect_net(0, "cpu", **CUT)
    st = E.forward_detect(torch.from_numpy(frames), net, size=(64, 64))
    stem = os.path.join(os.path.dirname(E.__file__), "_build", "yolov3-tiny_w8_s64_seed0")
    return frames, st, stem


def test_blob_and_heads_against_opencv_tpu(run):
    frames, st, stem = run
    want = jdnn.blobFromImages(list(frames), 1 / 255.0, (64, 64), swapRB=True)
    np.testing.assert_allclose(st["blob"].numpy(), want, rtol=1e-6, atol=1e-6)
    jnet = jdnn.readNetFromDarknet(stem + ".cfg", stem + ".weights")
    jnet.setInput(st["blob"].numpy())
    heads = jnet.forward(jnet.getUnconnectedOutLayersNames())
    assert [tuple(h.shape) for h in st["net_out"]] == [(2, 12, 85), (2, 48, 85)]
    for got, w in zip(st["net_out"], heads):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **DETECT_TOL)


def test_detections_against_opencv_tpu(run):
    frames, st, stem = run
    model = jdnn.DetectionModel(jdnn.readNetFromDarknet(stem + ".cfg", stem + ".weights"))
    model.setInputParams(scale=1 / 255.0, size=(64, 64), swapRB=True)
    for i, frame in enumerate(frames):
        jc, js, jb = model.detect(frame, E.DETECT_CONF, E.DETECT_NMS)
        tc, ts, tb = st["nms"][i]
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_allclose(ts, js, **DETECT_TOL)
        assert len(st["decode"][i][0]) >= len(tc) >= 1   # a box reaches NMS on every frame
    # the rows the decode keeps: every row of the first anchor of the
    # 13x13 head (here 2x2), whose prior passes confThreshold
    assert [len(d[0]) for d in st["decode"]] == [4, 4]


def test_stages_run_from_a_state(run):
    frames, st, _ = run
    tail = E.forward_detect(torch.from_numpy(frames), st["net"], size=(64, 64),
                            stages=("decode", "nms"), state={"net_out": st["net_out"]})
    for a, b in zip(tail["nms"], st["nms"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_full_width_cfg():
    """Darknet's yolov3-tiny.cfg: 13 convolutions of 16 to 1024 filters
    (batch norm and leaky ReLU but the heads), six max-pools, the route,
    the upsample and the concat with layer 8, two YOLO heads at 13×13 and
    26×26; 8,858,734 parameters, 5.565 GFLOP an image."""
    cfg = E.yolov3_tiny_cfg()
    assert cfg == E.YOLOV3_TINY_CFG
    convs = E.darknet_convs(cfg)
    assert [c["filters"] for c in convs] == [16, 32, 64, 128, 256, 512, 1024, 256, 512, 255,
                                              128, 256, 255]
    assert [c["bn"] for c in convs] == [True] * 9 + [False, True, True, False]
    assert convs[9]["hw"] == (13, 13) and convs[12]["hw"] == (26, 26)
    assert convs[11]["c_in"] == 128 + 256          # the upsample concatenated with layer 8
    assert sum(c["params"] for c in convs) == 8_858_734
    assert E.detect_flops(cfg) == 5_564_961_792
    path = os.path.join(os.path.dirname(E.__file__), "_build", "yolov3-tiny_full.cfg")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(cfg)
    net = readNetFromDarknet(path, device="cpu")    # no weights: the graph alone
    ops = [n.op_type for n in net._graph.node]
    assert ops.count("Conv") == 13 and ops.count("MaxPool") == 6
    assert ops.count("Resize") == 1 and ops.count("Concat") == 1 and ops.count("Region") == 2
    assert net.getUnconnectedOutLayersNames() == ["l16", "l23"]
    pools = [n for n in net._graph.node if n.op_type == "MaxPool"]
    assert [list(p.attribute[1].ints) for p in pools] == [[2, 2]] * 5 + [[1, 1]]


def test_weights_file_holds_every_parameter(tmp_path):
    cfg = E.yolov3_tiny_cfg(width_div=8, size=64)
    n = E.write_darknet_weights(cfg, tmp_path / "w.weights", 3)
    assert n == sum(c["params"] for c in E.darknet_convs(cfg))
    assert os.path.getsize(tmp_path / "w.weights") == 20 + 4 * n
