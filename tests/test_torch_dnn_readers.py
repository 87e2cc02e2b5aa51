"""The port's dnn readers, blobs and NMS against opencv_tpu.dnn (and cv2
where the reference tests check cv2), on the CPU.

Each reader gets the same file in both packages: ONNX (test_dnn.py's small
CNN, the trained tests/assets/tiny_cnn.onnx), Caffe (prototxt + caffemodel,
every layer type the importer converts), TensorFlow (a frozen GraphDef of
every op the importer converts), TFLite (tests/tflite_builder.py's convnet)
and Darknet (test_dnn.py's miniature YOLOv3); the outputs agree within
NET_TOL (the packages' f32 convolutions and GEMMs sum in their own orders),
cv2's within the reference tests' 1e-5.  NMS is exact."""

import os
import sys
import tempfile

import numpy as np
import pytest
import torch

from common import cv2
from torch_threads import _one_torch_thread  # noqa: F401
from test_dnn import _build_small_cnn, _tiny_yolo_cfg_weights
from test_torch_dnn_proto import _tf_graph

import opencv_tpu.dnn as jdnn
import opencv_tpu_torch.dnn as tdnn
from opencv_tpu.dnn import graph_pb2 as G
from opencv_tpu.dnn import opencv_caffe_pb2 as C

sys.path.insert(0, os.path.dirname(__file__))
from tflite_builder import build_tflite_convnet  # noqa: E402

NET_TOL = dict(rtol=1e-5, atol=1e-5)
ASSET = os.path.join(os.path.dirname(__file__), "assets", "tiny_cnn.onnx")


def forward_both(jnet, tnet, feeds, outs=None):
    res = []
    for net in (jnet, tnet):
        for k, v in feeds.items():
            net.setInput(v, k)
        o = net.forward(outs) if outs is not None else net.forward()
        res.append([np.asarray(x) for x in o] if isinstance(o, list) else [np.asarray(o)])
    for w, g in zip(*res):
        assert w.shape == g.shape
        np.testing.assert_allclose(g, w, **NET_TOL)
    return res[1]


def test_onnx_small_cnn_against_opencv_tpu_and_cv2():
    path = os.path.join(tempfile.mkdtemp(), "m.onnx")
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    ref = _build_small_cnn(path, x)
    ours = forward_both(jdnn.readNetFromONNX(path), tdnn.readNetFromONNX(path, device="cpu"),
                        {"": x.numpy()})[0]
    assert np.abs(ours - ref).max() < 1e-5
    cnet = cv2.dnn.readNetFromONNX(path)
    cnet.setInput(x.numpy())
    assert np.abs(ours - cnet.forward()).max() < 1e-5
    # a buffer, a uint8 array and a tensor blob read and run the same
    data = open(path, "rb").read()
    for src in (data, np.frombuffer(data, np.uint8)):
        net = tdnn.readNetFromONNX(src, device="cpu")
        net.setInput(x)
        out = net.forward()
        assert isinstance(out, torch.Tensor)
        np.testing.assert_array_equal(out.numpy(), ours)


def test_trained_tiny_cnn_asset_against_opencv_tpu_and_cv2():
    rng = np.random.default_rng(0)
    jnet, tnet = jdnn.readNetFromONNX(ASSET), tdnn.readNetFromONNX(ASSET, device="cpu")
    cnet = cv2.dnn.readNetFromONNX(ASSET)
    for _ in range(4):
        x = rng.normal(0, 1, (1, 1, 16, 16)).astype(np.float32)
        got = forward_both(jnet, tnet, {"": x})[0]
        cnet.setInput(x)
        assert np.allclose(got, cnet.forward(), atol=1e-5)
    assert tnet.getLayerNames() == jnet.getLayerNames()
    assert tnet.getUnconnectedOutLayersNames() == jnet.getUnconnectedOutLayersNames()


@pytest.mark.parametrize("size,mean,swap,crop", [((32, 32), (104, 117, 123), True, False),
                                                  ((40, 24), None, False, True),
                                                  ((64, 48), 7.0, True, True),
                                                  (None, (1, 2, 3), False, False)])
def test_blob_from_images(size, mean, swap, crop):
    """f32 conversion, then the resize, swapRB, mean and scale — the JAX
    package's order — batched, from numpy or from tensors."""
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (48, 64, 3), np.uint8) for _ in range(3)]
    want = jdnn.blobFromImages(imgs, 1 / 255.0, size, mean, swap, crop)
    got = tdnn.blobFromImages(imgs, 1 / 255.0, size, mean, swap, crop)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    got_t = tdnn.blobFromImages(torch.from_numpy(np.stack(imgs)), 1 / 255.0, size, mean, swap,
                                crop)
    np.testing.assert_array_equal(got_t.numpy(), got)
    one = tdnn.blobFromImage(imgs[1], 1 / 255.0, size, mean, swap, crop)
    np.testing.assert_allclose(one, want[1:2], rtol=1e-6, atol=1e-6)
    if size:    # images of different sizes, each resized on its own
        mixed = [imgs[0], imgs[1][:40, :50], imgs[2][5:, 3:]]
        np.testing.assert_allclose(
            tdnn.blobFromImages(mixed, 1 / 255.0, size, mean, swap, crop),
            jdnn.blobFromImages(mixed, 1 / 255.0, size, mean, swap, crop), rtol=1e-6, atol=1e-6)
    if size and not crop and mean is not None and not np.isscalar(mean):
        ref = cv2.dnn.blobFromImage(imgs[0], 1 / 255.0, size, mean, swapRB=swap, crop=False)
        assert np.abs(got[:1] - ref).max() < 1e-2   # test_dnn.py's bound


@pytest.mark.parametrize("gray", [False, True])
def test_blob_from_image_with_params(gray):
    """The u8 resize first, then (x - mean) * scale per channel."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (30, 50) if gray else (30, 50, 3), np.uint8)
    for p in (dict(scalefactor=1 / 127.5, size=(20, 16), mean=(127, 120, 110), swapRB=True),
              dict(scalefactor=(0.5, 2.0, 1.0), size=None, mean=3.0),
              dict(scalefactor=1.0, size=(50, 30))):
        want = jdnn.blobFromImageWithParams(img, jdnn.Image2BlobParams(**p))
        got = tdnn.blobFromImageWithParams(img, tdnn.Image2BlobParams(**p))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert tdnn.blobFromImageWithParams(img).shape == jdnn.blobFromImageWithParams(img).shape


CAFFE_NET = """
name: "every"
input: "data"
input_shape { dim: 1 dim: 3 dim: 12 dim: 12 }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 4 kernel_size: 3 pad: 1 stride: 1 } }
layer { name: "bn1" type: "BatchNorm" bottom: "conv1" top: "conv1"
  batch_norm_param { eps: 1e-3 } }
layer { name: "sc1" type: "Scale" bottom: "conv1" top: "conv1" scale_param { bias_term: true } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" relu_param { negative_slope: 0.1 } }
layer { name: "lrn1" type: "LRN" bottom: "conv1" top: "lrn1"
  lrn_param { local_size: 3 alpha: 0.001 beta: 0.75 } }
layer { name: "conv2" type: "Convolution" bottom: "lrn1" top: "conv2"
  convolution_param { num_output: 4 kernel_size: 3 pad: 1 group: 2 bias_term: false } }
layer { name: "sig" type: "Sigmoid" bottom: "conv2" top: "sig" }
layer { name: "tanh" type: "TanH" bottom: "conv2" top: "tanh" }
layer { name: "sum" type: "Eltwise" bottom: "sig" bottom: "tanh" bottom: "lrn1" top: "sum"
  eltwise_param { operation: SUM } }
layer { name: "prod" type: "Eltwise" bottom: "sig" bottom: "tanh" top: "prod"
  eltwise_param { operation: PROD } }
layer { name: "max" type: "Eltwise" bottom: "sig" bottom: "tanh" bottom: "sum" top: "max"
  eltwise_param { operation: MAX } }
layer { name: "cat" type: "Concat" bottom: "prod" bottom: "max" top: "cat" }
layer { name: "pw" type: "Power" bottom: "cat" top: "pw" power_param { power: 2 scale: 0.5 shift: 1 } }
layer { name: "pool1" type: "Pooling" bottom: "pw" top: "pool1"
  pooling_param { pool: AVE kernel_size: 3 stride: 2 } }
layer { name: "pool2" type: "Pooling" bottom: "pool1" top: "pool2"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 pad: 1 } }
layer { name: "drop" type: "Dropout" bottom: "pool2" top: "pool2" }
layer { name: "gap" type: "Pooling" bottom: "pool2" top: "gap" pooling_param { pool: AVE global_pooling: true } }
layer { name: "flat" type: "Flatten" bottom: "pool2" top: "flat" }
layer { name: "fc" type: "InnerProduct" bottom: "flat" top: "fc" inner_product_param { num_output: 5 } }
layer { name: "rs" type: "Reshape" bottom: "fc" top: "rs" reshape_param { shape { dim: 1 dim: 5 } } }
layer { name: "prob" type: "Softmax" bottom: "rs" top: "prob" }
"""


def _caffe_weights(rng):
    w = C.NetParameter()

    def layer(name, *arrs):
        lyr = w.layer.add()
        lyr.name = name
        for a in arrs:
            blob = lyr.blobs.add()
            blob.shape.dim.extend(a.shape)
            blob.data.extend(a.astype(np.float32).ravel().tolist())

    layer("conv1", rng.normal(0, 0.3, (4, 3, 3, 3)), rng.normal(0, 0.1, 4))
    layer("bn1", rng.normal(0, 0.2, 4), rng.uniform(0.5, 2, 4), np.asarray([2.0]))
    layer("sc1", rng.uniform(0.5, 1.5, 4), rng.normal(0, 0.1, 4))
    layer("conv2", rng.normal(0, 0.3, (4, 2, 3, 3)))
    layer("fc", rng.normal(0, 0.2, (5, 8 * 4 * 4)), rng.normal(0, 0.1, 5))
    return w.SerializeToString()


def test_caffe_every_layer_against_opencv_tpu():
    rng = np.random.default_rng(0)
    weights = _caffe_weights(rng)
    x = rng.normal(0, 1, (1, 3, 12, 12)).astype(np.float32)
    jnet = jdnn.readNetFromCaffe(CAFFE_NET, weights)
    tnet = tdnn.readNetFromCaffe(CAFFE_NET, weights, device="cpu")
    outs = jnet.getUnconnectedOutLayersNames()
    assert outs == tnet.getUnconnectedOutLayersNames()
    forward_both(jnet, tnet, {"data": x}, outs)
    # the prototxt from a file, the weights from a file; readNet dispatches
    tmp = tempfile.mkdtemp()
    pt, cm = os.path.join(tmp, "n.prototxt"), os.path.join(tmp, "n.caffemodel")
    open(pt, "w").write(CAFFE_NET)
    open(cm, "wb").write(weights)
    forward_both(jdnn.readNet(cm, pt), tdnn.readNet(cm, pt, device="cpu"), {"data": x}, outs)


def _tf_every_op(rng):
    gd = G.GraphDef()

    def const(name, arr):
        n = gd.node.add()
        n.op, n.name = "Const", name
        t = n.attr["value"].tensor
        t.dtype = {np.float32: 1, np.int32: 3}[arr.dtype.type]
        for d in arr.shape:
            t.tensor_shape.dim.add().size = d
        t.tensor_content = arr.tobytes()

    def add(op, name, inputs, **attrs):
        n = gd.node.add()
        n.op, n.name = op, name
        n.input.extend(inputs)
        for k, v in attrs.items():
            if isinstance(v, bytes):
                n.attr[k].s = v
            elif isinstance(v, bool):
                n.attr[k].b = v
            elif isinstance(v, list):
                n.attr[k].list.i.extend(v)
        return n

    add("Placeholder", "input", [])
    const("dw", rng.normal(0, 0.3, (3, 3, 3, 2)).astype(np.float32))
    add("DepthwiseConv2dNative", "dconv", ["input", "dw"], strides=[1, 1, 1, 1],
        padding=b"SAME")
    add("Relu6", "r6", ["dconv"])
    const("half", np.asarray([0.5], np.float32))
    add("Mul", "mul", ["r6", "half"])
    add("Sub", "sub", ["mul", "half"])
    add("Sigmoid", "sig", ["sub"])
    add("Tanh", "tanh", ["sub"])
    add("Maximum", "maxi", ["sig", "tanh"])
    add("RealDiv", "div", ["maxi", "half"])
    add("AvgPool", "avg", ["div"], ksize=[1, 3, 3, 1], strides=[1, 2, 2, 1], padding=b"SAME")
    const("pads", np.asarray([[0, 0], [1, 0], [0, 1], [0, 0]], np.int32))
    add("Pad", "pad", ["avg", "pads"])
    add("Identity", "idn", ["pad"])
    const("ax", np.asarray([3], np.int32))
    add("ConcatV2", "cat", ["idn", "idn", "ax"])
    const("red", np.asarray([1, 2], np.int32))
    add("Mean", "mean", ["cat", "red"], keep_dims=False)
    const("w", rng.normal(0, 0.3, (12, 3)).astype(np.float32))
    add("MatMul", "mm", ["mean", "w"])
    add("Softmax", "prob", ["mm"])
    add("Relu", "relu", ["mm"])
    return gd


@pytest.mark.parametrize("graph", ["test_dnn", "every_op"])
def test_tensorflow_against_opencv_tpu_and_cv2(graph, tmp_path):
    rng = np.random.default_rng(0)
    gd = _tf_graph() if graph == "test_dnn" else _tf_every_op(rng)
    if graph == "test_dnn":     # a Mean over the bias, which neither converts
        del gd.node[-1]
    path = str(tmp_path / "g.pb")
    open(path, "wb").write(gd.SerializeToString())
    x = rng.normal(0, 1, (1, 3, 10, 10)).astype(np.float32)
    jnet, tnet = jdnn.readNetFromTensorflow(path), tdnn.readNetFromTensorflow(path, device="cpu")
    outs = jnet.getUnconnectedOutLayersNames()
    got = forward_both(jnet, tnet, {"input": x}, outs)
    if graph == "test_dnn":
        ref = cv2.dnn.readNetFromTensorflow(path)
        ref.setInput(x)
        want = ref.forward()
        assert np.abs(want - got[0].reshape(want.shape)).max() < 1e-5


def test_tflite_against_opencv_tpu_and_cv2():
    data, _, _ = build_tflite_convnet(seed=7)
    path = os.path.join(tempfile.mkdtemp(), "m.tflite")
    open(path, "wb").write(data)
    inp = np.random.default_rng(2).normal(0, 1, (1, 3, 8, 8)).astype(np.float32)
    got = forward_both(jdnn.readNetFromTFLite(path), tdnn.readNetFromTFLite(path, device="cpu"),
                       {"": inp})[0]
    ref = cv2.dnn.readNetFromTFLite(path)
    ref.setInput(inp)
    assert np.abs(got - ref.forward()).max() < 1e-5
    np.testing.assert_array_equal(
        tdnn.readNetFromTFLite(data, device="cpu").getLayerNames(),
        tdnn.readNet(path, device="cpu").getLayerNames())


def test_darknet_tiny_yolo_against_opencv_tpu():
    tmp = tempfile.mkdtemp()
    cfgp, wp = _tiny_yolo_cfg_weights(tmp)
    blob = np.random.default_rng(1).random((1, 3, 32, 32)).astype(np.float32)
    jnet, tnet = jdnn.readNetFromDarknet(cfgp, wp), tdnn.readNetFromDarknet(cfgp, wp, "cpu")
    outs = tnet.getUnconnectedOutLayersNames()
    assert outs == jnet.getUnconnectedOutLayersNames() and len(outs) == 2
    forward_both(jnet, tnet, {"": blob}, outs)
    forward_both(jdnn.readNet(wp, cfgp), tdnn.readNet(wp, cfgp, device="cpu"), {"": blob}, outs)
    # no weights: zero kernels, no batch norm
    forward_both(jdnn.readNetFromDarknet(cfgp), tdnn.readNetFromDarknet(cfgp, device="cpu"),
                 {"": blob}, outs)


def test_nms_against_opencv_tpu_and_cv2():
    rng = np.random.default_rng(0)
    n = 150
    boxes = np.stack([rng.uniform(0, 300, n), rng.uniform(0, 300, n),
                      rng.uniform(5, 80, n), rng.uniform(5, 80, n)], 1).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    cids = rng.integers(0, 5, n).astype(np.int32)
    for args in ((0.3, 0.4), (0.3, 0.6, 0.9), (0.1, 0.5, 1.0, 20)):
        got = tdnn.NMSBoxes(boxes, scores, *args)
        np.testing.assert_array_equal(got, jdnn.NMSBoxes(boxes, scores, *args))
        np.testing.assert_array_equal(got, np.asarray(cv2.dnn.NMSBoxes(boxes, scores, *args))
                                      .ravel())
        got = tdnn.NMSBoxesBatched(boxes, scores, cids, *args)
        np.testing.assert_array_equal(got, jdnn.NMSBoxesBatched(boxes, scores, cids, *args))
        np.testing.assert_array_equal(got, np.asarray(
            cv2.dnn.NMSBoxesBatched(boxes, scores, cids, *args)).ravel())
    for method in (0, 1):
        a = tdnn.softNMSBoxes(boxes, scores, 0.2, 0.4, 30, 0.5, method)
        b = jdnn.softNMSBoxes(boxes, scores, 0.2, 0.4, 30, 0.5, method)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    rot = [((float(x + w / 2), float(y + h / 2)), (float(w), float(h)), float(a))
           for (x, y, w, h), a in zip(boxes[:40], rng.uniform(-45, 45, 40))]
    np.testing.assert_array_equal(tdnn.NMSBoxesRotated(rot, scores[:40], 0.2, 0.3),
                                  jdnn.NMSBoxesRotated(rot, scores[:40], 0.2, 0.3))


def test_the_layer_surface_matches_opencv_tpu():
    for v in (3, 2.5, "s"):
        a, b = tdnn.DictValue(v), jdnn.DictValue(v)
        assert (a.isInt(), a.isReal(), a.isString()) == (b.isInt(), b.isReal(), b.isString())
    lay = tdnn.Layer()
    assert (lay.finalize([]), lay.outputNameToIndex("x"), lay.empty(),
            lay.getDefaultName()) == ([], -1, False, "Layer")
    tdnn.dnn_registerLayer("Mine", tdnn.Layer)
    assert tdnn._CUSTOM_LAYERS["Mine"] is tdnn.Layer
    tdnn.dnn_unregisterLayer("Mine")
    assert "Mine" not in tdnn._CUSTOM_LAYERS
    for vocab in (None, {"a": 1, "b": 2}):
        t, j = tdnn.Tokenizer(vocab), jdnn.Tokenizer(vocab)
        np.testing.assert_array_equal(t.encode("a b é"), j.encode("a b é"))
        assert t.decode(t.encode("a b")) == j.decode(j.encode("a b"))
