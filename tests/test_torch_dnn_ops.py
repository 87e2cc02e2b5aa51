"""The port's ONNX executor against opencv_tpu.dnn's, op by op, on the CPU:
the elementwise ops, reductions and shape plumbing (the network ops are in
tests/test_torch_dnn_ops_nn.py).

Every operator of ``onnx_ops.OPS`` and every op ``Net.forward`` lowers
itself is built as a genuine ONNX model (the ``onnx_schema_pb2`` builders of
tests/test_onnx_ops.py, serialized once), which the port's codec decodes
field for field as google.protobuf does; both packages read the same bytes
and run the same inputs.  Floats agree within FLOAT_TOL (the two run f32
transcendental functions and reductions of their own); integers, booleans,
indices and shape plumbing exactly.  The JAX package runs its Pallas-free
executor eagerly here."""

import numpy as np
import pytest

from torch_threads import _one_torch_thread  # noqa: F401
from test_dnn_trackers import _model, _node, _tensor
from test_torch_dnn_proto import same_fields

import opencv_tpu.dnn as jdnn
import opencv_tpu_torch.dnn as tdnn
from opencv_tpu.dnn import onnx_schema_pb2 as P
from opencv_tpu.dnn.onnx_ops import OPS as J_OPS
from opencv_tpu_torch.dnn import _proto
from opencv_tpu_torch.dnn.onnx_ops import OPS as T_OPS

FLOAT_TOL = dict(rtol=1e-5, atol=1e-5)

RNG = np.random.default_rng(0)
X = RNG.normal(0, 2, (2, 3, 8, 8)).astype(np.float32)
POS = (np.abs(X) + 0.1).astype(np.float32)          # Log, Sqrt, Pow's base
UNIT = (np.tanh(X) * 0.9).astype(np.float32)        # Asin, Acos, Atanh
GE1 = (np.abs(X) + 1.0).astype(np.float32)          # Acosh
M = RNG.normal(0, 1, (4, 6)).astype(np.float32)


def _i64(name, arr):
    return _tensor(name, np.asarray(arr, np.int64))


def _const_node(out, arr):
    """A Constant node with a TENSOR value attribute."""
    n = P.NodeProto()
    n.op_type = "Constant"
    n.output.extend([out])
    a = n.attribute.add()
    a.name = "value"
    a.type = P.AttributeProto.TENSOR
    a.t.CopyFrom(_tensor("v", np.asarray(arr)))
    return n


def run_both(nodes, inits, feeds, outs=("y",)):
    """(opencv_tpu's outputs, the port's outputs) of one model."""
    m = _model([(k, v.shape) for k, v in feeds.items()], list(outs), nodes, inits)
    data = m.SerializeToString()
    same_fields(m, _proto.schema("onnx_schema").ModelProto.FromString(data))
    res = []
    for net in (jdnn.readNetFromONNX(data), tdnn.readNetFromONNX(data, device="cpu")):
        for k, v in feeds.items():
            net.setInput(v, k)
        res.append([np.asarray(o) for o in net.forward(list(outs))])
    return res


def assert_agree(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert g.shape == w.shape, (g.shape, w.shape)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, **FLOAT_TOL)
        else:
            np.testing.assert_array_equal(g, w)


def test_the_operator_sets_are_the_same():
    assert sorted(T_OPS) == sorted(J_OPS)


UNARY = [("Neg", X), ("Abs", X), ("Floor", X), ("Ceil", X), ("Round", X * 1.5),
         ("Reciprocal", X), ("Log", POS), ("Sign", X), ("Sin", X), ("Cos", X), ("Tan", UNIT),
         ("Asin", UNIT), ("Acos", UNIT), ("Atan", X), ("Sinh", UNIT), ("Cosh", UNIT),
         ("Atanh", UNIT), ("Asinh", X), ("Acosh", GE1), ("Relu", X), ("Sigmoid", X),
         ("Tanh", X), ("Erf", X), ("Sqrt", POS), ("Exp", UNIT), ("Softplus", X),
         ("Mish", X), ("Swish", X), ("Selu", X), ("HardSwish", X), ("Softsign", X),
         ("Identity", X), ("Dropout", X), ("GlobalAveragePool", X), ("GlobalMaxPool", X),
         ("Not", X > 0)]


@pytest.mark.parametrize("op,x", UNARY, ids=[u[0] for u in UNARY])
def test_unary(op, x):
    assert_agree(*run_both([_node(op, ["x"], ["y"])], [], {"x": x}))


ATTR_UNARY = [
    ("LeakyRelu", {"alpha": 0.13}), ("Elu", {"alpha": 1.3}), ("Celu", {"alpha": 1.1}),
    ("HardSigmoid", {"alpha": 0.2, "beta": 0.5}), ("ThresholdedRelu", {"alpha": 0.7}),
    ("Gelu", {}), ("Gelu", {"approximate": "tanh"}), ("LogSoftmax", {"axis": 1}),
    ("Softmax", {"axis": 1}), ("Softmax", {}), ("Flatten", {"axis": 2}),
    ("Transpose", {"perm": [0, 2, 3, 1]}), ("Transpose", {}),
    ("Unsqueeze", {"axes": [0, 3]}), ("Cast", {"to": 6}), ("Cast", {"to": 7}),
    ("ReduceMean", {"axes": [2, 3], "keepdims": 0}), ("ReduceMean", {}),
    ("ArgMax", {"axis": 1, "keepdims": 0}), ("ArgMin", {"axis": 2}),
    ("LRN", {"size": 3, "alpha": 1e-3, "beta": 0.75, "bias": 2.0}),
    ("LRN", {"size": 4}), ("Reorg", {"stride": 2}),
    ("DepthToSpace", {"blocksize": 2}), ("DepthToSpace", {"blocksize": 2, "mode": "CRD"}),
    ("SpaceToDepth", {"blocksize": 2}), ("LpNormalization", {"axis": 1, "p": 1}),
    ("LpNormalization", {"axis": -1, "p": 2}), ("MeanVarianceNormalization", {}),
    ("MeanVarianceNormalization", {"axes": [2, 3]}),
]


@pytest.mark.parametrize("op,attrs", ATTR_UNARY, ids=[f"{o}-{i}" for i, (o, _) in
                                                      enumerate(ATTR_UNARY)])
def test_unary_with_attributes(op, attrs):
    x = X[:, :3] if op != "DepthToSpace" else np.concatenate([X, X[:, :1]], axis=1)
    assert_agree(*run_both([_node(op, ["x"], ["y"], **attrs)], [], {"x": x}))


BINARY = ["Add", "Sum", "Sub", "Mul", "Div", "Max", "Min", "Pow", "Mod", "Equal", "Greater",
          "GreaterOrEqual", "Less", "LessOrEqual", "And", "Or", "Xor", "PRelu", "MatMul"]


@pytest.mark.parametrize("op", BINARY)
def test_binary(op):
    a, b = X, RNG.normal(0, 2, (1, 3, 1, 8)).astype(np.float32)
    attrs = {}
    if op == "Pow":
        a, b = POS, b
    elif op == "Mod":
        attrs = {"fmod": 1}
    elif op in ("Equal",):
        b = np.round(b)
        a = np.round(a)
    elif op == "PRelu":
        b = RNG.random(3).astype(np.float32)
    elif op == "MatMul":
        b = RNG.normal(0, 1, (8, 5)).astype(np.float32)
    feeds = {"a": a} if op == "PRelu" else {"a": a, "b": b}
    inits = [_tensor("b", b)] if op == "PRelu" else []
    assert_agree(*run_both([_node(op, ["a", "b"], ["y"], **attrs)], inits, feeds))


def test_mod_floor_and_where():
    a, b = X, np.full((1,), -1.5, np.float32)
    assert_agree(*run_both([_node("Mod", ["a", "b"], ["y"])], [_tensor("b", b)], {"a": a}))
    assert_agree(*run_both([_node("Greater", ["a", "h"], ["m"]),
                            _node("Where", ["m", "a", "h"], ["y"])],
                           [_tensor("h", np.zeros((1,), np.float32))], {"a": a}))


REDUCE = ["ReduceSum", "ReduceMax", "ReduceMin", "ReduceProd", "ReduceL1", "ReduceL2",
          "ReduceSumSquare", "ReduceLogSum", "ReduceLogSumExp"]


@pytest.mark.parametrize("keep", [0, 1])
@pytest.mark.parametrize("op", REDUCE)
def test_reductions(op, keep):
    x = (UNIT * 0.5 + 1.0).astype(np.float32)
    assert_agree(*run_both([_node(op, ["x"], ["y"], axes=[1, 3], keepdims=keep)], [],
                           {"x": x}))
    # axes as an input (opset 18)
    assert_agree(*run_both([_node(op, ["x", "ax"], ["y"], keepdims=keep)],
                           [_i64("ax", [-1])], {"x": x}))


def test_reduce_without_axes():
    assert_agree(*run_both([_node("ReduceSum", ["x"], ["y"])], [], {"x": X}))
    assert_agree(*run_both([_node("ReduceSum", ["x", ""], ["y"], noop_with_empty_axes=1)], [],
                           {"x": X}))


@pytest.mark.parametrize("attrs", [{}, {"reverse": 1}, {"exclusive": 1},
                                   {"reverse": 1, "exclusive": 1}])
def test_cumsum(attrs):
    assert_agree(*run_both([_node("CumSum", ["x", "ax"], ["y"], **attrs)],
                           [_tensor("ax", np.asarray(3, np.int64))], {"x": X}))


@pytest.mark.parametrize("largest", [1, 0])
def test_topk_ties_to_the_lower_index(largest):
    x = np.round(X * 0.7).astype(np.float32)     # many ties
    assert_agree(*run_both([_node("TopK", ["x", "k"], ["y", "yi"], axis=-1, largest=largest)],
                           [_i64("k", [4])], {"x": x}, outs=("y", "yi")))


def test_shape_plumbing():
    """Shape → Gather → Concat → Reshape on the host; Squeeze, Unsqueeze by
    input, ConstantOfShape, Range, Expand, Tile, Size, NonZero."""
    nodes = [_node("Shape", ["x"], ["s"]),
             _node("Gather", ["s", "i0"], ["n"], axis=0),
             _node("Concat", ["n", "m1"], ["shp"], axis=0),
             _node("Reshape", ["x", "shp"], ["r"]),
             _node("Unsqueeze", ["r", "ax"], ["u"]),
             _node("Squeeze", ["u", "ax"], ["y"]),
             _node("ConstantOfShape", ["s"], ["c"]),
             _node("Range", ["st", "en", "de"], ["rg"]),
             _node("Expand", ["rg", "ex"], ["e"]),
             _node("Tile", ["r", "rep"], ["t"]),
             _node("Size", ["x"], ["sz"]),
             _node("Relu", ["x"], ["rx"]),
             _node("NonZero", ["rx"], ["nz"])]
    inits = [_i64("i0", [0]), _i64("m1", [-1]), _i64("ax", [1]), _i64("st", 1),
             _i64("en", 7), _i64("de", 2), _i64("ex", [2, 3]), _i64("rep", [2, 1])]
    assert_agree(*run_both(nodes, inits, {"x": X},
                           outs=("y", "c", "rg", "e", "t", "sz", "nz", "s", "shp")))


def test_constant_and_gather():
    nodes = [_const_node("k", np.arange(6, dtype=np.float32).reshape(2, 3)),
             _node("Gather", ["x", "gi"], ["g"], axis=1),
             _node("Gather", ["x", "gs"], ["g0"], axis=3),
             _node("Gather", ["k", "gs"], ["y"], axis=1)]
    assert_agree(*run_both(nodes, [_i64("gi", [[2, 0], [-1, 1]]), _i64("gs", 1)], {"x": X},
                           outs=("y", "g", "g0", "k")))


@pytest.mark.parametrize("case", range(4))
def test_slice(case):
    starts, ends, axes, steps = [
        ([1, 2], [3, 7], [2, 3], [1, 2]),
        ([0], [2 ** 62], [1], [1]),
        ([-1, 6], [-9, 1], [3, 2], [-1, -2]),   # negative steps
        ([-4], [-1], [-1], None),
    ][case]
    ins = ["x", "st", "en", "ax"] + (["sp"] if steps else [])
    inits = [_i64("st", starts), _i64("en", ends), _i64("ax", axes)]
    if steps:
        inits.append(_i64("sp", steps))
    assert_agree(*run_both([_node("Slice", ins, ["y"])], inits, {"x": X}))


@pytest.mark.parametrize("mode", ["constant", "reflect", "edge"])
def test_pad(mode):
    assert_agree(*run_both([_node("Pad", ["x"], ["y"], pads=[0, 0, 1, 2, 0, 1, 2, 1],
                                  mode=mode)], [], {"x": X}))
    assert_agree(*run_both([_node("Pad", ["x", "p"], ["y"], mode=mode)],
                           [_i64("p", [0, 0, 2, 0, 0, 0, 1, 3])], {"x": X}))


@pytest.mark.parametrize("case", range(6))
def test_resize_as_jax_image(case):
    """Resize/Upsample with jax.image.resize's semantics: nearest at f32
    (i + 0.5) * in / out, linear with its antialiased triangle kernel."""
    mode, scales, sizes = [
        ("nearest", [1, 1, 2, 2], None), ("nearest", [1, 1, 1.5, 0.75], None),
        ("linear", [1, 1, 2, 3], None), ("linear", [1, 1, 0.5, 0.625], None),
        ("nearest", None, [2, 3, 5, 11]), ("linear", None, [2, 3, 3, 13]),
    ][case]
    if sizes is None:
        inits = [_tensor("sc", np.asarray(scales, np.float32))]
        nodes = [_node("Resize", ["x", "", "sc"], ["y"], mode=mode)]
        if case == 0:
            nodes = [_node("Upsample", ["x", "sc"], ["y"], mode=mode)]
    else:
        inits = [_i64("sz", sizes)]
        nodes = [_node("Resize", ["x", "", "", "sz"], ["y"], mode=mode)]
    assert_agree(*run_both(nodes, inits, {"x": X}))


def test_numpy_in_numpy_out_and_tensors_in_tensors_out():
    import torch
    m = _model([("x", X.shape)], ["y"], [_node("Relu", ["x"], ["y"])], [])
    net = tdnn.readNetFromONNX(m.SerializeToString(), device="cpu")
    net.setInput(X)
    assert isinstance(net.forward(), np.ndarray)
    net.setInput(torch.from_numpy(X))
    out = net.forward()
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert net.device == torch.device("cpu")
    assert tdnn.Net(m).device == torch.device("cuda")   # the card unless asked
