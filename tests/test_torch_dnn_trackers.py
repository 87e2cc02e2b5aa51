"""The DNN trackers of the port (``opencv_tpu_torch/video/dnn_trackers.py``)
against the JAX package's, on the CPU, with the synthetic models
tests/test_dnn_trackers.py builds: Nano, DaSiamRPN and Vit on its moving
rectangle, GOTURN on its constant-box stub (the GOTURN path at CaffeNet's
depth is tests/test_torch_slice_track_dnn.py's).  Boxes equal the JAX
trackers' exactly, scores within 1e-4 (convolutions summed in oneDNN's
order and XLA's); the full-width net's layers as GOTURN's prototxt gives
them.
And the codec: the port builds the same ONNX bytes as google.protobuf does,
and a 4 M-float Caffe blob round-trips as google.protobuf decodes it, in a
few seconds."""

import os
import tempfile
import time

import numpy as np
import pytest
import torch

from torch_threads import _one_torch_thread  # noqa: F401
import test_dl_features
import test_dnn_trackers as R

import opencv_tpu as jcv
from opencv_tpu.dnn import opencv_caffe_pb2 as C
import opencv_tpu_torch as tcv
from opencv_tpu_torch import entry as E
from opencv_tpu_torch.dnn import _proto

INIT = (100, 80, 50, 40)


@pytest.fixture(scope="module")
def models():
    tmp = tempfile.mkdtemp()
    paths = dict(zip(("nano_backbone", "nano_neckhead"), R._nano_models(tmp)))
    paths.update(zip(("dasiam", "dasiam_cls1", "dasiam_r1"), R._dasiam_models(tmp)))
    paths["vit"] = R._vit_model(tmp)
    paths["disk"] = test_dl_features._disk_model()
    paths["aliked"] = test_dl_features._aliked_model()
    return paths


def test_the_port_builds_the_tests_models(models):
    """entry.small_dnn_models, written with the port's codec, gives the
    bytes google.protobuf gives for the tests' graphs."""
    built = E.small_dnn_models()
    assert sorted(built) == sorted(models)
    for k, path in models.items():
        with open(path, "rb") as fh:
            assert fh.read() == built[k], k


def _run(tracker, frames):
    tracker.init(frames[0], INIT)
    return [(*tracker.update(f), tracker.getTrackingScore()) for f in frames[1:]]


def _same_track(ours, theirs):
    for (ok, box, score), (jok, jbox, jscore) in zip(ours, theirs):
        assert ok == jok
        assert tuple(int(v) for v in box) == tuple(int(v) for v in jbox)
        assert score == pytest.approx(jscore, rel=1e-4, abs=1e-5)


@pytest.mark.parametrize("kind", ["Nano", "DaSiamRPN", "Vit"])
def test_siamese_trackers_equal_opencv_tpu(models, kind):
    frames = R._frames()
    fields = {"Nano": {"backbone": "nano_backbone", "neckhead": "nano_neckhead"},
              "DaSiamRPN": {"model": "dasiam", "kernel_cls1": "dasiam_cls1",
                            "kernel_r1": "dasiam_r1"},
              "Vit": {"net": "vit"}}[kind]
    out = {}
    for mod, kw in ((jcv, {}), (tcv, {"device": "cpu"})):
        p = getattr(mod, f"Tracker{kind}").Params()
        for f, key in fields.items():
            setattr(p, f, models[key])
        with np.errstate(all="ignore"):
            out[mod] = _run(getattr(mod, f"Tracker{kind}_create")(p, **kw), frames)
    _same_track(out[tcv], out[jcv])


def test_sweep_of_the_small_models_equals_opencv_tpu(models):
    """entry.dnn_sweep (the chip check's sweep) on the CPU against the JAX
    trackers and features on the same bytes."""
    frames = R._frames()
    got = E.dnn_sweep(E.small_dnn_models(), frames, INIT, tempfile.mkdtemp(), "cpu")
    p = jcv.TrackerNano.Params()
    p.backbone, p.neckhead = models["nano_backbone"], models["nano_neckhead"]
    _same_track(got["nano"], _run(jcv.TrackerNano_create(p), frames))
    d = jcv.DISK_create(models["disk"], 5, 0.75, (320, 240))
    kps, desc = d.detectAndCompute(frames[0], None)
    np.testing.assert_array_equal(got["disk"][0], np.array([k.pt for k in kps]))
    np.testing.assert_array_equal(got["disk"][2], desc)
    kps, desc = jcv.ALIKED_create(models["aliked"]).detectAndCompute(frames[0], None)
    np.testing.assert_allclose(got["aliked"][0], np.array([k.pt for k in kps]), rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(got["aliked"][2], desc)
    assert got["lightglue"] == "NotImplementedError"


def test_goturn_static_box_equals_opencv_tpu():
    ptxt, pbin = R._goturn_model(tempfile.mkdtemp())
    boxes = {}
    for mod, kw in ((jcv, {}), (tcv, {"device": "cpu"})):
        p = mod.TrackerGOTURN.Params()
        p.modelTxt, p.modelBin = ptxt, pbin
        tr = mod.TrackerGOTURN_create(p, **kw)
        frames = R._frames()
        tr.init(frames[0], INIT)
        boxes[mod] = [tuple(int(v) for v in tr.update(f)[1]) for f in frames[1:]]
    assert boxes[tcv] == boxes[jcv]
    assert R._boxes_close(boxes[tcv][0], INIT, tol=1)


@pytest.fixture(scope="module")
def goturn8():
    return E.goturn_files(0, 8)


def test_goturn_published_widths():
    """The full-width net: CaffeNet's towers, 113,748,740 parameters and
    2.881 GFLOP a forward, as the prototxt gives them."""
    layers = E.goturn_layers()
    assert sum(int(np.prod(s)) + s[0] for _, s in layers) == 113_748_740
    assert E.goturn_flops() == 2_881_276_032
    assert dict(layers)["fc6"] == (4096, 18432) and dict(layers)["conv21"] == (256, 48, 5, 5)
    net = _proto.parse_text(E.goturn_prototxt(), _proto.schema("opencv_caffe").NetParameter())
    widths = [(l.name, l.convolution_param.num_output or l.inner_product_param.num_output)
              for l in net.layer if l.type in ("Convolution", "InnerProduct")]
    assert widths == [(n, s[0]) for n, s in layers]
    assert net.layer[-1].type == "Power" and list(net.layer[-1].top) == ["scale"]


def test_goturn_trackers_share_one_net_on_the_default_device(goturn8):
    net = tcv.dnn.readNetFromCaffe(*goturn8, device="cpu")
    a, b = (tcv.TrackerGOTURN_create(net=net) for _ in range(2))
    assert a.net is b.net is net and a.device == torch.device("cpu")
    p = tcv.TrackerGOTURN.Params()
    p.modelTxt, p.modelBin = goturn8
    assert tcv.TrackerGOTURN_create(p).device == torch.device("cuda")


def test_caffe_blob_of_4m_floats_round_trips():
    """A 4 M-float packed blob: the codec's encoding read by google, and
    google's encoding read by the codec, equal, each way in a few seconds
    (the values stay one numpy array; no Python float per value)."""
    a = np.random.default_rng(0).standard_normal(4_000_000, np.float32)
    S = _proto.schema("opencv_caffe")
    t0 = time.perf_counter()
    m = S.BlobProto()
    m.shape.dim.extend([4000, 1000])
    m.data.extend(a)
    data = m.SerializeToString()
    back = S.BlobProto()
    back.ParseFromString(data)
    got = np.asarray(back.data)
    codec_s = time.perf_counter() - t0
    g = C.BlobProto()
    g.ParseFromString(data)
    assert list(g.shape.dim) == [4000, 1000]
    np.testing.assert_array_equal(np.asarray(g.data, np.float32), a)
    assert g.SerializeToString() == data
    assert got.dtype == np.float32 and np.array_equal(got, a)
    assert codec_s < 3.0, codec_s
    assert back.data[:2] == a[:2].tolist() and len(back.data) == a.size


def test_lightglue_raises_as_opencv_tpu():
    asset = os.path.join(os.path.dirname(__file__), "assets", "tiny_cnn.onnx")
    buf = open(asset, "rb").read()
    desc = np.zeros((3, 128), np.float32)
    for m in (tcv.LightGlueMatcher_create(asset, device="cpu"),
              tcv.LightGlueMatcher_createFromMemory(buf, device="cpu"),
              jcv.LightGlueMatcher_create(asset)):
        with pytest.raises(NotImplementedError):
            m.match(None, desc, None, desc, (1, 1), (1, 1))
    for mod in (tcv, jcv):
        with pytest.raises(ValueError):
            mod.LightGlueMatcher()
        with pytest.raises(NotImplementedError):
            mod.detail_LightGlueFeaturesMatcher()
