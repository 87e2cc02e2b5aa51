"""The port's protobuf codec (``opencv_tpu_torch/dnn/_proto.py``) against
google.protobuf, on the CPU.

Every proto that tests/test_dnn.py, test_dnn_models.py, test_dnn_trackers.py
and test_dl_features.py build (test_onnx_ops.py's through
tests/test_torch_dnn_ops*.py, whose every model goes through
:func:`same_fields`) is built with the JAX package's generated classes,
serialized, and decoded by the codec: every field equal, field for field
(presence, repeated lengths, values; floats as the same f32).  The Caffe
prototxt and a TF pbtxt parse as ``text_format.Parse`` parses them; what the
codec writes, google.protobuf reads back equal.  The port imports no
google.protobuf."""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
from google.protobuf import text_format

from torch_threads import _one_torch_thread  # noqa: F401
import test_dnn
import test_dnn_models
import test_dnn_trackers
import test_dl_features

from opencv_tpu.dnn import graph_pb2 as G
from opencv_tpu.dnn import onnx_schema_pb2 as P
from opencv_tpu.dnn import opencv_caffe_pb2 as C
from opencv_tpu_torch.dnn import _proto

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def same_fields(g, o, path="msg"):
    """Assert that the codec's message `o` holds what google's `g` holds,
    field for field."""
    for fd in g.DESCRIPTOR.fields:
        name = fd.name
        gv, ov = getattr(g, name), getattr(o, name)
        where = f"{path}.{name}"
        if fd.message_type is not None and fd.message_type.GetOptions().map_entry:
            assert sorted(gv.keys()) == sorted(ov.keys()), where
            for k in gv:
                if fd.message_type.fields_by_name["value"].message_type is None:
                    assert gv[k] == ov[k], (where, k)
                else:
                    same_fields(gv[k], ov[k], f"{where}[{k!r}]")
        elif fd.is_repeated:
            assert len(gv) == len(ov), (where, len(gv), len(ov))
            if fd.message_type is not None:
                for i, (a, b) in enumerate(zip(gv, ov)):
                    same_fields(a, b, f"{where}[{i}]")
            else:
                assert list(gv) == list(ov), where
        elif fd.message_type is not None:
            assert g.HasField(name) == o.HasField(name), where
            if g.HasField(name):
                same_fields(gv, ov, where)
        else:
            assert type(gv) is type(ov) and (gv == ov or (gv != gv and ov != ov)), \
                (where, gv, ov)
            if fd.has_presence:
                assert g.HasField(name) == o.HasField(name), where


def decoded(g, key):
    """google's message `g` serialized and decoded by the codec, checked
    field for field, and the codec's encoding read back by google."""
    data = g.SerializeToString()
    o = getattr(_proto.schema(key), g.DESCRIPTOR.name)()
    o.ParseFromString(data)
    same_fields(g, o)
    back = type(g)()
    back.ParseFromString(o.SerializeToString())
    assert back == g
    return o


def _onnx_file(path):
    m = P.ModelProto()
    with open(path, "rb") as f:
        m.ParseFromString(f.read())
    return m


def _small_cnn(tmp):
    import torch
    path = os.path.join(tmp, "s.onnx")
    test_dnn._build_small_cnn(path, torch.randn(2, 3, 32, 32))
    return path


def _builders():
    tmp = tempfile.mkdtemp()
    yield "small_cnn", lambda: _small_cnn(tmp)
    yield "ctc", lambda: test_dnn_models._ctc_net(tmp)
    yield "heatmap", lambda: test_dnn_models._heatmap_net(tmp)
    yield "db", lambda: test_dnn_models._db_net(tmp)
    yield "east", lambda: test_dnn_models._east_net(tmp)
    yield "nano", lambda: test_dnn_trackers._nano_models(tmp)
    yield "dasiamrpn", lambda: test_dnn_trackers._dasiam_models(tmp)
    yield "vit", lambda: test_dnn_trackers._vit_model(tmp)
    yield "disk", test_dl_features._disk_model
    yield "aliked", test_dl_features._aliked_model
    yield "tiny_cnn asset", lambda: os.path.join(ROOT, "tests", "assets", "tiny_cnn.onnx")


BUILDERS = dict(_builders())


@pytest.mark.parametrize("name", list(BUILDERS))
def test_onnx_models_decode_as_google_protobuf(name):
    paths = BUILDERS[name]()
    for p in (paths if isinstance(paths, tuple) else (paths,)):
        decoded(_onnx_file(p), "onnx_schema")


CAFFE_TINY = """
name: "tiny"
input: "data"
input_dim: 1
input_dim: 3
input_dim: 8
input_dim: 8
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 4 kernel_size: 3 pad: 1 stride: 1 } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "fc1" type: "InnerProduct" bottom: "pool1" top: "fc1"
  inner_product_param { num_output: 5 } }
layer { name: "prob" type: "Softmax" bottom: "fc1" top: "prob" }
"""

CAFFE_MORE = r"""
# a comment
name: 'more'  # strings in single quotes
layer {
  name: "bn" type: "BatchNorm" bottom: "x" top: "x"
  batch_norm_param < eps: 1e-3 use_global_stats: true >
  param: { lr_mult: 0 } param { lr_mult: 0.0f }
}
layer { name: "pw" type: "Power" power_param { power: -inf scale: 2.5e+1 shift: -.5 } }
layer { name: "el" type: "Eltwise" eltwise_param { operation: SUM coeff: [1.0, -1, 2e0] } }
layer { name: "sc" type: "Scale" scale_param { bias_term: t }; }
layer { name: "e\x41\101\n\"q" type: "Input" input_param { shape { dim: [1, 3, 0x10, 16] } } }
"""


def _goturn_prototxt(tmp):
    with open(test_dnn_trackers._goturn_model(tmp)[0]) as f:
        return f.read()


@pytest.mark.parametrize("text", [CAFFE_TINY, CAFFE_MORE, _goturn_prototxt],
                         ids=["tiny", "more", "goturn"])
def test_caffe_prototxt_parses_as_text_format(text):
    if callable(text):
        text = text(tempfile.mkdtemp())
    g = C.NetParameter()
    text_format.Parse(text, g)
    o = _proto.parse_text(text, _proto.schema("opencv_caffe").NetParameter())
    same_fields(g, o)
    # the schema's proto2 defaults where nothing was set
    for lg, lo in zip(g.layer, o.layer):
        for f in ("bias_term", "group", "axis"):
            assert getattr(lg.convolution_param, f) == getattr(lo.convolution_param, f)
        assert lg.lrn_param.beta == lo.lrn_param.beta and lg.pooling_param.pool == \
            lo.pooling_param.pool


def test_caffe_weights_decode_as_google_protobuf():
    """test_dnn.py's caffemodel (blobs of unpacked floats) and GOTURN's
    1.2 M packed floats."""
    rng = np.random.RandomState(0)
    wnet = C.NetParameter()
    for name, shapes in (("conv1", [(4, 3, 3, 3), (4,)]), ("fc1", [(5, 64), (5,)])):
        lyr = wnet.layer.add()
        lyr.name = name
        for shp in shapes:
            blob = lyr.blobs.add()
            blob.shape.dim.extend(shp)
            blob.data.extend((rng.randn(*shp).astype(np.float32) * 0.2).ravel().tolist())
    o = decoded(wnet, "opencv_caffe")
    assert o.layer[1].blobs[0].shape.dim == [5, 64]
    _, pbin = test_dnn_trackers._goturn_model(tempfile.mkdtemp())
    g = C.NetParameter()
    g.ParseFromString(open(pbin, "rb").read())
    decoded(g, "opencv_caffe")


def _tf_graph():
    """test_dnn.py::test_read_net_from_tensorflow's GraphDef."""
    rng = np.random.RandomState(0)
    gd = G.GraphDef()

    def add(op, name, inputs=(), **attrs):
        n = gd.node.add()
        n.op = op
        n.name = name
        n.input.extend(inputs)
        for k, v in attrs.items():
            a = n.attr[k]
            if isinstance(v, bytes):
                a.s = v
            elif isinstance(v, float):
                a.f = v
            elif isinstance(v, list):
                a.list.i.extend(v)
            elif isinstance(v, np.ndarray):
                a.tensor.dtype = 1
                for d in v.shape:
                    a.tensor.tensor_shape.dim.add().size = d
                a.tensor.tensor_content = v.tobytes()
        return n

    n = add("Placeholder", "input")
    n.attr["dtype"].type = 1
    add("Const", "W", value=rng.randn(3, 3, 3, 4).astype(np.float32))
    add("Conv2D", "conv", ["input", "W"], strides=[1, 2, 2, 1], padding=b"SAME")
    add("Const", "b", value=rng.randn(4).astype(np.float32))
    add("BiasAdd", "bias", ["conv", "b"])
    n = add("FusedBatchNorm", "bn", ["bias", "b", "b", "b", "b"])
    n.attr["epsilon"].f = 1e-3
    n.attr["is_training"].b = False
    add("MaxPool", "pool", ["bn"], ksize=[1, 2, 2, 1], strides=[1, 2, 2, 1], padding=b"SAME")
    n = add("Mean", "mean", ["pool", "b"])
    n.attr["keep_dims"].b = True
    n.attr["T"].type = 1
    gd.versions.producer = 27
    gd.versions.bad_consumers.extend([-3, 7])
    return gd


def test_tf_graph_decodes_and_pbtxt_parses_as_google_protobuf():
    gd = _tf_graph()
    o = decoded(gd, "graph")
    assert dict(o.node[2].attr)["padding"].s == b"SAME"
    assert o.node[0].attr["dtype"].WhichOneof("value") == "type"
    assert o.node[1].attr["value"].HasField("tensor")
    txt = text_format.MessageToString(gd)
    same_fields(gd, _proto.parse_text(txt, _proto.schema("graph").GraphDef()))


def test_wire_format_corners():
    """Negative int32/int64 (ten-byte varints), packed and unpacked repeated
    scalars, doubles, unknown fields of every wire type (skipped, as the
    generated classes skip them when read), a singular message given
    twice (merged), the last of a repeated scalar given twice."""
    t = P.TensorProto()
    t.dims.extend([-1, 3, 2 ** 40])
    t.int64_data.extend([-(2 ** 63), -5, 0, 2 ** 63 - 1])
    t.int32_data.extend([-(2 ** 31), -1, 7])
    t.double_data.extend([1e-300, -2.5, float("inf")])
    t.float_data.extend([0.1, -1e30, 3.4e38])
    t.data_type = 11
    t.name = "ünïcode"
    t.raw_data = bytes(range(256))
    a = P.AttributeProto()
    a.i = -7
    a.f = 0.1
    a.ints.extend([-1, 1 << 33])
    a.type = P.AttributeProto.INTS
    a.t.CopyFrom(t)
    body = a.SerializeToString()
    unknown = (b"\xb8\x3e\x05"            # field 999, varint
               + b"\xba\x3e\x03abc"       # field 999, length-delimited
               + b"\xbd\x3e\x01\x02\x03\x04"                    # fixed32
               + b"\xb9\x3e" + bytes(8)                          # fixed64
               + b"\xbb\x3e\x08\x01\xbc\x3e")                    # a group
    again = P.AttributeProto()
    again.t.name = "merged"
    again.t.dims.append(9)
    again.i = -8
    data = body + unknown + again.SerializeToString()
    g = P.AttributeProto()
    g.ParseFromString(data)
    o = _proto.schema("onnx_schema").AttributeProto()
    o.ParseFromString(data)
    same_fields(g, o)
    assert o.t.name == "merged" and o.t.dims == [-1, 3, 2 ** 40, 9] and o.i == -8
    # floats are stored as f32, as the generated classes store them
    o.f = 0.1
    assert o.f == g.f and o.f != 0.1


def test_messages_built_with_the_codec():
    """The builder surface the port's readers use: lazy sub-messages that
    appear when written, add()/append/extend, maps, oneofs, enums."""
    S = _proto.schema("onnx_schema")
    m = S.ModelProto()
    assert not m.HasField("graph")
    g = m.graph
    assert not m.HasField("graph")
    vi = g.input.add()
    assert m.HasField("graph")
    vi.type.tensor_type.shape.dim.add().dim_value = 3
    assert vi.HasField("type") and vi.type.tensor_type.HasField("shape")
    n = g.node.add()
    n.attribute.add(name="k", type=S.AttributeProto.FLOAT, f=0.5)
    assert S.AttributeProto.FLOAT == P.AttributeProto.FLOAT
    assert S.TensorProto.DataType.Name(1) == "FLOAT"
    gm = P.ModelProto()
    gm.ParseFromString(m.SerializeToString())
    same_fields(gm, m)
    T = _proto.schema("attr_value")
    v = T.AttrValue()
    v.s = b"x"
    v.i = 3
    assert v.WhichOneof("value") == "i" and not v.HasField("s")
    gd = _proto.schema("graph").GraphDef()
    gd.node.add().attr["strides"].list.i.extend([1, 2])
    assert gd.node[0].attr["strides"].list.i == [1, 2]
    with pytest.raises(AttributeError):
        m.no_such_field = 1
    with pytest.raises(TypeError):
        n.name = 5


def test_the_port_imports_no_protobuf_runtime():
    code = ("import sys; import opencv_tpu_torch.dnn, opencv_tpu_torch.ml; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'opencv_tpu') "
            "or m.startswith('google.protobuf')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=120,
                   env=dict(os.environ, PYTHONPATH=ROOT))
