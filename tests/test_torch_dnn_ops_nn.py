"""The port's ONNX executor against opencv_tpu.dnn's, op by op, on the CPU:
the network ops (Conv, the pools, Gemm, BatchNormalization, ConvTranspose,
the int8 set, NonMaxSuppression, LSTM/GRU/RNN; GridSample, RoiAlign,
Attention and Region are in tests/test_torch_dnn_ops_samplers.py).  As
tests/test_torch_dnn_ops.py: the same ONNX bytes through both packages;
floats within its FLOAT_TOL, integers exactly."""

import numpy as np
import pytest

from torch_threads import _one_torch_thread  # noqa: F401
from test_dnn_trackers import _node, _tensor
from test_onnx_ops import _tensor_i8
from test_torch_dnn_ops import M, RNG, X, _i64, assert_agree, run_both

from opencv_tpu.dnn import onnx_schema_pb2 as P


CONV = [dict(kernel_shape=[3, 3], pads=[1, 1, 1, 1]),
        dict(kernel_shape=[3, 3], strides=[2, 2], pads=[0, 1, 2, 1]),
        dict(kernel_shape=[3, 3], dilations=[2, 2], pads=[2, 2, 2, 2]),
        dict(kernel_shape=[3, 3], group=3, pads=[1, 1, 1, 1]),
        dict(kernel_shape=[3, 3], strides=[2, 2], auto_pad="SAME_UPPER"),
        dict(kernel_shape=[1, 1])]


@pytest.mark.parametrize("attrs", CONV, ids=[str(i) for i in range(len(CONV))])
def test_conv(attrs):
    g = attrs.get("group", 1)
    w = RNG.normal(0, 0.5, (6, 3 // g, *attrs["kernel_shape"])).astype(np.float32)
    b = RNG.normal(0, 0.5, 6).astype(np.float32)
    assert_agree(*run_both([_node("Conv", ["x", "w", "b"], ["y"], **attrs)],
                           [_tensor("w", w), _tensor("b", b)], {"x": X}))


POOL = [("MaxPool", dict(kernel_shape=[2, 2], strides=[2, 2])),
        ("MaxPool", dict(kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 0, 0], ceil_mode=1)),
        ("MaxPool", dict(kernel_shape=[3, 3], strides=[2, 2], auto_pad="SAME_UPPER")),
        ("MaxPool", dict(kernel_shape=[2, 2], strides=[1, 1], pads=[0, 0, 1, 1])),
        ("AveragePool", dict(kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1])),
        ("AveragePool", dict(kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1],
                             count_include_pad=1, ceil_mode=1)),
        ("AveragePool", dict(kernel_shape=[3, 3], strides=[3, 3], auto_pad="SAME_UPPER")),
        ("AveragePool", dict(kernel_shape=[2, 2]))]


@pytest.mark.parametrize("op,attrs", POOL, ids=[str(i) for i in range(len(POOL))])
def test_pool(op, attrs):
    assert_agree(*run_both([_node(op, ["x"], ["y"], **attrs)], [], {"x": X[:, :, :7]}))


def test_clip_gemm_batchnorm_concat():
    b2 = RNG.normal(0, 1, (6, 5)).astype(np.float32)
    c2 = RNG.normal(0, 1, (5,)).astype(np.float32)
    g, be, mu = (RNG.normal(0, 1, 3).astype(np.float32) for _ in range(3))
    var = (RNG.random(3) + 0.5).astype(np.float32)
    nodes = [_node("Clip", ["x"], ["c1"], min=-1.0, max=2.5),
             _node("Clip", ["x", "lo", "hi"], ["cl2"]),
             _node("Clip", ["x", "", "hi"], ["cl3"]),
             _node("Gemm", ["m", "b2", "c2"], ["g1"], alpha=0.5, beta=2.0),
             _node("Gemm", ["m", "m"], ["g2"], transA=1),
             _node("Gemm", ["m", "m"], ["g3"], transB=1),
             _node("BatchNormalization", ["x", "g", "be", "mu", "var"], ["bn"], epsilon=1e-3),
             _node("Concat", ["x", "c1", "bn"], ["y"], axis=1)]
    inits = [_tensor("lo", np.float32(-0.5).reshape(())),
             _tensor("hi", np.float32(1.5).reshape(())),
             _tensor("b2", b2), _tensor("c2", c2), _tensor("g", g), _tensor("be", be),
             _tensor("mu", mu), _tensor("var", var)]
    assert_agree(*run_both(nodes, inits, {"x": X, "m": M},
                           outs=("y", "cl2", "cl3", "g1", "g2", "g3")))


def test_split_expand_trilu_einsum():
    a = RNG.normal(0, 1, (3, 4)).astype(np.float32)
    nodes = [_node("Split", ["x"], ["y", "s2"], axis=1, split=[1, 2]),
             _node("Split", ["x", "sp"], ["s3", "s4"], axis=3),
             _node("Split", ["x"], ["s5", "s6", "s7"], axis=2, num_outputs=3),
             _node("Trilu", ["m"], ["tu"]),
             _node("Trilu", ["m", "k"], ["tl"], upper=0),
             _node("Einsum", ["a", "m"], ["es"], equation="ij,jk->ik"),
             _node("Einsum", ["x"], ["et"], equation="nchw->nwc")]
    inits = [_i64("sp", [5, 3]), _i64("k", 1), _tensor("a", a)]
    assert_agree(*run_both(nodes, inits, {"x": X, "m": M},
                           outs=("y", "s2", "s3", "s4", "s5", "s6", "s7", "tu", "tl", "es",
                                 "et")))


def test_gathers_and_scatter_and_onehot():
    data = RNG.normal(0, 1, (4, 5)).astype(np.float32)
    idx = np.asarray([[0, 1], [3, 4], [-1, 2]], np.int64)
    ge = RNG.integers(-5, 5, (4, 5)).astype(np.int64)
    nodes = [_node("GatherND", ["d", "i"], ["y"]),
             _node("ScatterND", ["d", "i", "u"], ["sc"]),
             _node("GatherElements", ["d", "ge"], ["gel"], axis=1),
             _node("OneHot", ["oi", "dep", "vals"], ["oh"], axis=-1),
             _node("OneHot", ["oi", "dep", "vals"], ["oh0"], axis=0)]
    inits = [_tensor("i", idx), _tensor("u", np.asarray([100.0, 200.0, 300.0], np.float32)),
             _tensor("ge", ge), _i64("oi", [[0, 2, -1], [5, -6, 1]]), _i64("dep", [4]),
             _tensor("vals", np.asarray([-1.0, 3.0], np.float32))]
    assert_agree(*run_both(nodes, inits, {"d": data}, outs=("y", "sc", "gel", "oh", "oh0")))


def test_norms():
    g4, b4 = RNG.random(4).astype(np.float32), RNG.random(4).astype(np.float32)
    x4 = RNG.normal(0, 1, (2, 4, 6, 6)).astype(np.float32)
    w8, b8 = RNG.random(6).astype(np.float32), RNG.random(6).astype(np.float32)
    nodes = [_node("InstanceNormalization", ["x", "g", "b"], ["y"], epsilon=1e-5),
             _node("GroupNormalization", ["x", "g", "b"], ["gn"], num_groups=2),
             _node("LayerNormalization", ["x", "w", "bb"], ["ln"], axis=-1),
             _node("LayerNormalization", ["x", "w"], ["ln2"], axis=3)]
    inits = [_tensor("g", g4), _tensor("b", b4), _tensor("w", w8), _tensor("bb", b8)]
    assert_agree(*run_both(nodes, inits, {"x": x4}, outs=("y", "gn", "ln", "ln2")))


@pytest.mark.parametrize("groups,stride,pad,outpad", [
    (1, 1, 0, 0), (1, 2, 1, 1), (2, 2, 0, 0), (4, 3, 2, 1),
])
def test_conv_transpose(groups, stride, pad, outpad):
    x = RNG.normal(0, 1, (2, 4, 7, 7)).astype(np.float32)
    w = RNG.normal(0, 0.5, (4, 8 // groups, 3, 3)).astype(np.float32)
    b = RNG.normal(0, 0.5, 8).astype(np.float32)
    assert_agree(*run_both([_node("ConvTranspose", ["x", "w", "b"], ["y"],
                                  kernel_shape=[3, 3], strides=[stride, stride],
                                  pads=[pad, pad, pad, pad], output_padding=[outpad, outpad],
                                  group=groups)],
                           [_tensor("w", w), _tensor("b", b)], {"x": x}))


def test_quantize_dequantize():
    s = np.asarray([0.05], np.float32)
    z = np.asarray([10], np.int8)
    sc = np.asarray([0.05, 0.1, 0.02], np.float32)
    zc = np.asarray([1, -3, 7], np.int8)
    nodes = [_node("QuantizeLinear", ["x", "s", "z"], ["y"]),
             _node("DequantizeLinear", ["y", "s", "z"], ["dq"]),
             _node("QuantizeLinear", ["x", "sc", "zc"], ["qc"], axis=1),
             _node("DequantizeLinear", ["qc", "sc", "zc"], ["dqc"], axis=1),
             _node("QuantizeLinear", ["x", "s"], ["qu"])]
    inits = [_tensor_i8("s", s, False), _tensor_i8("z", z, True),
             _tensor_i8("sc", sc, False), _tensor_i8("zc", zc, True)]
    assert_agree(*run_both(nodes, inits, {"x": X}, outs=("y", "dq", "qc", "dqc", "qu")))


def _int_tensor(name, arr, dtype_code):
    t = P.TensorProto()
    t.name = name
    t.data_type = dtype_code
    t.dims.extend(arr.shape)
    t.raw_data = np.ascontiguousarray(arr).tobytes()
    return t


@pytest.mark.parametrize("per_channel", [False, True])
def test_integer_convs_and_matmuls(per_channel):
    """QLinearConv, QLinearMatMul, MatMulInteger and ConvInteger: int32
    accumulation, exact."""
    rng = np.random.default_rng(3)
    xq = rng.integers(-100, 100, (1, 3, 8, 8)).astype(np.int8)
    wq = rng.integers(-80, 80, (5, 3, 3, 3)).astype(np.int8)
    bias = rng.integers(-500, 500, 5).astype(np.int32)
    aq = rng.integers(0, 255, (4, 6)).astype(np.uint8)
    bq = rng.integers(0, 255, (6, 3)).astype(np.uint8)
    ws = np.float32([0.01, 0.02, 0.005, 0.01, 0.03]) if per_channel else np.float32([0.01])
    wz = np.int8([-2, 0, 1, 3, -1]) if per_channel else np.int8([-2])
    inits = [_tensor_i8("xs", np.float32([0.02]), False), _tensor_i8("xz", np.int8([3]), True),
             _tensor_i8("w", wq, True), _tensor_i8("ws", ws, False), _tensor_i8("wz", wz, True),
             _tensor_i8("ys", np.float32([0.1]), False), _tensor_i8("yz", np.int8([5]), True),
             _int_tensor("b", bias, 6), _int_tensor("aq", aq, 2), _int_tensor("bq", bq, 2),
             _int_tensor("az", np.uint8([12]), 2), _int_tensor("bz", np.uint8([130]), 2),
             _tensor_i8("as", np.float32([0.05]), False), _tensor_i8("bs", np.float32([0.02]),
                                                                     False),
             _tensor_i8("os", np.float32([0.5]), False), _int_tensor("oz", np.uint8([20]), 2)]
    nodes = [_node("QLinearConv", ["x", "xs", "xz", "w", "ws", "wz", "ys", "yz", "b"], ["y"],
                   kernel_shape=[3, 3], pads=[1, 1, 1, 1], strides=[1, 1]),
             _node("QLinearConv", ["x", "xs", "xz", "w", "ws", "wz", "ys", "yz"], ["y2"],
                   kernel_shape=[3, 3], strides=[2, 2]),
             _node("ConvInteger", ["x", "w", "xz"], ["ci"], kernel_shape=[3, 3],
                   pads=[0, 1, 1, 0]),
             _node("MatMulInteger", ["aq", "bq", "az", "bz"], ["mi"]),
             _node("MatMulInteger", ["aq", "bq"], ["mi0"]),
             _node("QLinearMatMul", ["aq", "as", "az", "bq", "bs", "bz", "os", "oz"], ["qm"])]
    assert_agree(*run_both(nodes, inits, {"x": xq}, outs=("y", "y2", "ci", "mi", "mi0", "qm")))


@pytest.mark.parametrize("center", [0, 1])
def test_onnx_nms(center):
    rng = np.random.default_rng(5)
    xy = rng.uniform(0, 50, (2, 30, 2))
    wh = rng.uniform(5, 20, (2, 30, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.random((2, 3, 30)).astype(np.float32)
    assert_agree(*run_both([_node("NonMaxSuppression", ["b", "s", "mo", "it", "st"], ["y"],
                                  center_point_box=center)],
                           [_i64("mo", [5]), _tensor("it", np.float32([0.4])),
                            _tensor("st", np.float32([0.2]))], {"b": boxes, "s": scores}))


def _rnn(ngate, D, seq=5, b=3, inp=4, hs=6):
    w = RNG.normal(0, 0.3, (D, ngate * hs, inp)).astype(np.float32)
    r = RNG.normal(0, 0.3, (D, ngate * hs, hs)).astype(np.float32)
    bb = RNG.normal(0, 0.3, (D, 2 * ngate * hs)).astype(np.float32)
    x = RNG.normal(0, 1, (seq, b, inp)).astype(np.float32)
    h0 = RNG.normal(0, 1, (D, b, hs)).astype(np.float32)
    return x, [_tensor("w", w), _tensor("r", r), _tensor("b", bb), _tensor("h0", h0)], hs


@pytest.mark.parametrize("direction", ["forward", "reverse", "bidirectional"])
@pytest.mark.parametrize("kind", ["LSTM", "GRU", "RNN"])
def test_recurrent(kind, direction):
    D = 2 if direction == "bidirectional" else 1
    x, inits, hs = _rnn({"LSTM": 4, "GRU": 3, "RNN": 1}[kind], D)
    outs = ("y", "yh", "yc") if kind == "LSTM" else ("y", "yh")
    attrs = dict(hidden_size=hs, direction=direction)
    ins = ["x", "w", "r", "b", "", "h0"]
    if kind == "GRU":
        attrs["linear_before_reset"] = int(direction != "reverse")
    if kind == "LSTM" and direction == "forward":
        inits.append(_tensor("p", RNG.normal(0, 0.3, (1, 3 * hs)).astype(np.float32)))
        ins += ["", "p"]
    assert_agree(*run_both([_node(kind, ins, list(outs), **attrs)], inits, {"x": x}, outs=outs))
