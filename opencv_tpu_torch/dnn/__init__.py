"""dnn (modules/dnn) — ONNX inference on the card: the port of
``opencv_tpu.dnn``.

The readers parse ONNX, Caffe and TensorFlow protobufs with the port's own
codec (``_proto``: descriptor-driven, over the schemas the JAX package's
generated modules embed), Darknet's ``.cfg``/``.weights`` and TFLite's
flatbuffers directly; every framework becomes the same ONNX graph, which
``Net.forward`` walks op by op in eager torch on the net's device.  A net
holds its weights on ``"cuda"`` unless it was read with ``device="cpu"``.
Convolutions and GEMMs are cuDNN and cuBLAS calls in full f32 (no TF32, as
the JAX package's ``Precision.HIGHEST``); shape plumbing (Shape, Gather of
shapes, Constant) stays numpy on the host, as in the JAX package.

A forward given a numpy blob returns numpy, one given a tensor returns
tensors on the net's device.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from . import _proto
from .onnx_ops import OPS as _EXTRA_OPS
from .onnx_ops import _a, _np, computing_on

__all__ = ["readNetFromONNX", "readNetFromCaffe", "readNetFromTensorflow",
           "readNet", "blobFromImage", "blobFromImages",
           "blobFromImageWithParams", "Image2BlobParams", "Net",
           "DNN_BACKEND_DEFAULT", "DNN_TARGET_CPU", "exact_f32"]

DNN_BACKEND_DEFAULT = 0
DNN_TARGET_CPU = 0

_onnx = _proto.schema("onnx_schema")

_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16,
           5: np.int16, 6: np.int32, 7: np.int64, 9: np.bool_,
           10: np.float16, 11: np.float64}

# ONNX element types as torch computes them: f64 as f32 and u16 as i32, as
# the JAX package computes them with x64 off
_TORCH_DTYPES = {1: torch.float32, 2: torch.uint8, 3: torch.int8, 4: torch.int32,
                 5: torch.int16, 6: torch.int32, 7: torch.int64, 9: torch.bool,
                 10: torch.float16, 11: torch.float32}


@contextlib.contextmanager
def exact_f32():
    """Full-f32 convolutions and matrix products for the block (cuDNN and
    cuBLAS without TF32), restoring the settings after it."""
    prev_mm = torch.get_float32_matmul_precision()
    prev_cudnn = torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev_cudnn
        torch.set_float32_matmul_precision(prev_mm)


def default_device(device=None) -> torch.device:
    """The device a net or model is made on: "cuda" unless asked."""
    return torch.device("cuda" if device is None else device)


def _tensor_to_np(t):
    dt = _DTYPES[t.data_type]
    shape = tuple(t.dims)
    if t.raw_data:
        arr = np.frombuffer(t.raw_data, dt)
    elif t.float_data:
        arr = np.asarray(t.float_data, dt)
    elif t.int64_data:
        arr = np.asarray(t.int64_data, dt)
    elif t.int32_data:
        arr = np.asarray(t.int32_data, dt)
    elif t.double_data:
        arr = np.asarray(t.double_data, dt)
    else:
        arr = np.zeros(shape, dt)
    return arr.reshape(shape) if shape else arr.reshape(())


def _attrs(node):
    out = {}
    for a in node.attribute:
        if a.type == _onnx.AttributeProto.INT:
            out[a.name] = int(a.i)
        elif a.type == _onnx.AttributeProto.FLOAT:
            out[a.name] = float(a.f)
        elif a.type == _onnx.AttributeProto.INTS:
            out[a.name] = [int(v) for v in a.ints]
        elif a.type == _onnx.AttributeProto.FLOATS:
            out[a.name] = [float(v) for v in a.floats]
        elif a.type == _onnx.AttributeProto.STRING:
            out[a.name] = a.s.decode()
        elif a.type == _onnx.AttributeProto.TENSOR:
            out[a.name] = _tensor_to_np(a.t)
    return out


def _pool_pads(x, attrs, default=0):
    pads = attrs.get("pads", [0, 0, 0, 0])
    if len(pads) == 2:
        pads = [pads[0], pads[1], pads[0], pads[1]]
    return pads


def _same_pads(size, k, s, d=1):
    """XLA's "SAME" padding of one axis: (lo, hi)."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, b, attrs):
    strides = attrs.get("strides", [1, 1])
    pads = _pool_pads(x, attrs)
    dil = attrs.get("dilations", [1, 1])
    groups = attrs.get("group", 1)
    if attrs.get("auto_pad", "").startswith("SAME"):
        (t, bo), (le, r) = (_same_pads(x.shape[2], w.shape[2], strides[0], dil[0]),
                            _same_pads(x.shape[3], w.shape[3], strides[1], dil[1]))
    else:
        t, le, bo, r = pads
    if (t, le) == (bo, r):
        out = F.conv2d(x, w, None, tuple(strides), (t, le), tuple(dil), groups)
    else:
        out = F.conv2d(F.pad(x, (le, r, t, bo)), w, None, tuple(strides), 0, tuple(dil), groups)
    if b is not None:
        out = out + b.reshape(1, -1, 1, 1)
    return out


def _window_sum(x, ks, strides, pad4):
    """Sums over the windows of an NCHW float tensor, zero-padded by pad4
    ((top, bottom), (left, right))."""
    xp = F.pad(x, (pad4[1][0], pad4[1][1], pad4[0][0], pad4[0][1]))
    return F.avg_pool2d(xp, tuple(ks), tuple(strides), divisor_override=1)


def _window_max(x, ks, strides, pad4):
    xp = F.pad(x, (pad4[1][0], pad4[1][1], pad4[0][0], pad4[0][1]), value=-float("inf"))
    return F.max_pool2d(xp, tuple(ks), tuple(strides))


def _pool(x, attrs, kind):
    """ONNX MaxPool/AveragePool as ``lax.reduce_window``: -inf pads for max,
    ceil mode by extending the trailing pad, the average over the window's
    in-range cells unless count_include_pad."""
    ks = attrs["kernel_shape"]
    strides = attrs.get("strides", ks)
    pads = _pool_pads(x, attrs)
    ceil = attrs.get("ceil_mode", 0)
    if attrs.get("auto_pad", "").startswith("SAME"):
        pad4 = [_same_pads(x.shape[2], ks[0], strides[0]),
                _same_pads(x.shape[3], ks[1], strides[1])]
        if kind == "max":
            return _window_max(x, ks, strides, pad4)
        s = _window_sum(x, ks, strides, pad4)
        c = _window_sum(torch.ones_like(x[:1, :1]), ks, strides, pad4)
        return s / c
    pad4 = [(pads[0], pads[2]), (pads[1], pads[3])]
    if ceil:
        # extend the trailing pad so the last partial window is kept
        H, W = x.shape[2], x.shape[3]
        for ax, (k, s, lo, hi) in enumerate(
                [(ks[0], strides[0], pads[0], pads[2]),
                 (ks[1], strides[1], pads[1], pads[3])]):
            size = (H if ax == 0 else W) + lo + hi
            rem = (size - k) % s
            if rem:
                pad4[ax] = (lo, hi + (s - rem))
    if kind == "max":
        return _window_max(x, ks, strides, pad4)
    # average (count_include_pad=0 default)
    s = _window_sum(x, ks, strides, pad4)
    c = _window_sum(torch.ones_like(x[:1, :1]), ks, strides, pad4)
    if attrs.get("count_include_pad", 0):
        c = torch.full_like(c, float(ks[0] * ks[1]))
    return s / c


def _resize_nearest(x, oh, ow):
    """``jax.image.resize(method="nearest")``: output i reads
    floor((i + 0.5) * in / out), in f32."""
    H, W = x.shape[2], x.shape[3]
    if oh != H:
        iy = torch.floor((torch.arange(oh, dtype=torch.float32) + 0.5) * H / oh).to(torch.int64)
        x = x.index_select(2, iy.to(x.device))
    if ow != W:
        ix = torch.floor((torch.arange(ow, dtype=torch.float32) + 0.5) * W / ow).to(torch.int64)
        x = x.index_select(3, ix.to(x.device))
    return x


def _linear_weights(n_in, n_out, device):
    """``jax.image``'s ``compute_weight_mat`` for the triangle kernel with
    antialiasing (the kernel widened by the downscale factor), f32,
    (n_in, n_out)."""
    scale = n_out / n_in
    inv = 1.0 / scale
    kscale = max(inv, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.5
    xx = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / kscale
    w = torch.clamp(1 - xx.abs(), min=0)
    tot = w.sum(0, keepdim=True)
    w = torch.where(tot.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(tot != 0, tot, torch.ones_like(tot)), torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def _resize_linear(x, oh, ow):
    x = x.to(torch.float32) if not x.is_floating_point() else x
    H, W = x.shape[2], x.shape[3]
    if oh != H:
        x = torch.einsum("nchw,hH->ncHw", x, _linear_weights(H, oh, x.device).to(x.dtype))
    if ow != W:
        x = torch.einsum("nchw,wW->nchW", x, _linear_weights(W, ow, x.device).to(x.dtype))
    return x


def _region_decode(x, biases, norm_shape, at):
    """Region/YOLO decode (region_layer.cpp:forward) on x's device.
    x: NHWC (N, H, W, A*cell); biases: (2A,) anchor sizes; norm_shape:
    shape of the net input for YOLOv3+ normalization (None => grid units)."""
    classes = at.get("classes", 20)
    A = at.get("anchors", 5)
    coords = 4
    cell = coords + 1 + classes
    thresh = at.get("thresh", 0.2)
    sxy = at.get("scale_x_y", 1.0)
    new_coords = at.get("new_coords", 0)
    classfix = at.get("classfix", 0)
    use_logistic = at.get("logistic", 0)
    use_softmax = at.get("softmax", 0)

    N, H, W = x.shape[0], x.shape[1], x.shape[2]
    t = x.reshape(N, H, W, A, cell).to(torch.float32)
    if norm_shape is not None:
        hN, wN = norm_shape[2], norm_shape[3]
    else:
        hN, wN = H, W
    dev = t.device

    def sig(v):
        return 1.0 / (1.0 + torch.exp(-v))

    gx = torch.arange(W, dtype=torch.float32, device=dev).reshape(1, 1, W, 1)
    gy = torch.arange(H, dtype=torch.float32, device=dev).reshape(1, H, 1, 1)
    b = torch.as_tensor(np.array(biases, np.float32), device=dev)
    bw = b[0::2].reshape(1, 1, 1, A)
    bh = b[1::2].reshape(1, 1, 1, A)
    out = t.clone()
    if new_coords == 0:
        out[..., 4] = sig(t[..., 4])
        if use_softmax:
            e = torch.exp(t[..., 5:] - t[..., 5:].amax(-1, keepdim=True))
            out[..., 5:] = e / e.sum(-1, keepdim=True)
        elif use_logistic:
            out[..., 5:] = sig(t[..., 5:])
        out[..., 0] = (gx + (sig(t[..., 0]) - 0.5) * sxy + 0.5) / W
        out[..., 1] = (gy + (sig(t[..., 1]) - 0.5) * sxy + 0.5) / H
        out[..., 2] = torch.exp(t[..., 2]) * bw / wN
        out[..., 3] = torch.exp(t[..., 3]) * bh / hN
        scale = out[..., 4].clone()
        if classfix == -1:
            scale = torch.where(scale < 0.5, torch.zeros_like(scale), scale)
        prob = scale[..., None] * out[..., 5:]
    else:
        out[..., 0] = (gx + (t[..., 0] - 0.5) * sxy + 0.5) / W
        out[..., 1] = (gy + (t[..., 1] - 0.5) * sxy + 0.5) / H
        out[..., 2] = t[..., 2] ** 2 * 4 * bw / wN
        out[..., 3] = t[..., 3] ** 2 * 4 * bh / hN
        scale = t[..., 4].clone()
        if classfix == -1:
            scale = torch.where(scale < thresh, torch.zeros_like(scale), scale)
        prob = scale[..., None] * t[..., 5:]
    out[..., 5:] = torch.where(prob > thresh, prob, torch.zeros_like(prob))
    out = out.reshape(N, H * W * A, cell)
    if N == 1:
        out = out[0]
    return out


def _slice_axis(x, axis, start, end, step):
    """x[start:end:step] along `axis` with numpy's semantics (a negative
    step too)."""
    n = x.shape[axis]
    s0, e0, st = slice(start, end, step).indices(n)
    if st > 0:
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(s0, e0, st)
        return x[tuple(sl)]
    idx = torch.arange(s0, e0, st, device=x.device)
    return x.index_select(axis, idx)


def _pad_index(n, lo, hi, mode):
    return np.pad(np.arange(n), (lo, hi), mode={"reflect": "reflect", "edge": "edge"}[mode])


def _pad(x, pw, mode):
    if mode == "constant":
        flat = []
        for lo, hi in reversed(pw):
            flat += [lo, hi]
        return F.pad(x, flat)
    for ax, (lo, hi) in enumerate(pw):
        if lo or hi:
            idx = torch.as_tensor(_pad_index(x.shape[ax], lo, hi, mode), device=x.device)
            x = x.index_select(ax, idx)
    return x


def _host_ints(*vals):
    """Whether every value is a host integer array (shape plumbing)."""
    return all(isinstance(v, np.ndarray) and v.dtype.kind in "iu" for v in vals)


class Net:
    def __init__(self, model, device=None):
        self._graph = model.graph
        self._init = {t.name: _tensor_to_np(t)
                      for t in model.graph.initializer}
        self._inputs = [i.name for i in model.graph.input
                        if i.name not in self._init]
        self._outputs = [o.name for o in model.graph.output]
        self._input_blobs = {}
        self.device = default_device(device)
        self._cache = {}     # id(initializer array) -> (array, tensor on the device)
        self._plan = [(node.op_type, _attrs(node), list(node.input),
                       [o for o in node.output if o]) for node in self._graph.node]

    def setInput(self, blob, name=""):
        key = name or (self._inputs[0] if self._inputs else "input")
        if isinstance(blob, torch.Tensor):
            if blob.is_floating_point():
                blob = blob.to(torch.float32)
        else:
            blob = np.asarray(blob)
            if not np.issubdtype(blob.dtype, np.integer):
                blob = blob.astype(np.float32)
        self._input_blobs[key] = blob

    def getLayerNames(self):
        return [n.name or n.op_type for n in self._graph.node]

    def _resolve_layer(self, name):
        """Resolve a layer name to a node index.  Accepts the node's own
        name, any of its output names, and the reference ONNX importer's
        generated names for anonymous nodes ("onnx_node_output_0!<out>",
        "onnx_node!<out>" — onnx_importer.cpp)."""
        if "!" in name:
            name = name.rsplit("!", 1)[1]
        for i, n in enumerate(self._graph.node):
            if n.name == name or name in list(n.output):
                return i
        raise KeyError(f"no layer named {name!r}")

    def getLayerId(self, name):
        return self._resolve_layer(name)

    def setParam(self, layerId, paramIdx, blob):
        """Replace the paramIdx-th learned parameter (constant input) of
        the given layer — cv2.dnn.Net.setParam."""
        node = self._graph.node[int(layerId)]
        params = [i for i in node.input if i in self._init]
        if isinstance(blob, torch.Tensor):
            blob = blob.detach().cpu().numpy()
        self._init[params[int(paramIdx)]] = np.asarray(blob, np.float32)

    def getUnconnectedOutLayersNames(self):
        return list(self._outputs)

    def forward(self, outBlobNames=None):
        as_numpy = not any(isinstance(v, torch.Tensor) for v in self._input_blobs.values())
        keep = {id(a) for a in self._init.values()}
        with computing_on(self.device, self._cache, keep), exact_f32(), torch.no_grad():
            vals = self._run()

        def get(name):
            if name not in vals and "!" in name:
                name = name.rsplit("!", 1)[1]
            v = vals[name]
            if as_numpy:
                return _np(v)
            return _a(v) if not isinstance(v, torch.Tensor) else v

        if outBlobNames is None:
            return get(self._outputs[0])
        if isinstance(outBlobNames, str):
            return get(outBlobNames)
        return [get(n) for n in outBlobNames]

    def _run(self):
        vals = dict(self._init)
        for k, v in self._input_blobs.items():
            vals[k] = _a(v)

        for op, at, inputs, outs in self._plan:
            ins = [vals.get(i) if i else None for i in inputs]
            x = ins[0] if ins else None
            if op == "Conv":
                y = _conv(_a(x), _a(ins[1]), None if len(ins) < 3 else _a(ins[2]), at)
            elif op == "Relu":
                y = torch.clamp(_a(x), min=0)
            elif op == "LeakyRelu":
                a = at.get("alpha", 0.01)
                xx = _a(x)
                y = torch.where(xx >= 0, xx, a * xx)
            elif op == "Sigmoid":
                y = torch.sigmoid(_a(x))
            elif op == "Tanh":
                y = torch.tanh(_a(x))
            elif op == "Clip":
                lo = ins[1] if len(ins) > 1 and ins[1] is not None \
                    else at.get("min", -np.inf)
                hi = ins[2] if len(ins) > 2 and ins[2] is not None \
                    else at.get("max", np.inf)
                y = torch.clamp(_a(x), float(np.float32(_np(lo))), float(np.float32(_np(hi))))
            elif op == "Softmax":
                y = torch.softmax(_a(x), dim=at.get("axis", -1))
            elif op == "MaxPool":
                y = _pool(_a(x), at, "max")
            elif op == "AveragePool":
                y = _pool(_a(x), at, "avg")
            elif op == "GlobalAveragePool":
                y = torch.mean(_a(x), dim=(2, 3), keepdim=True)
            elif op == "GlobalMaxPool":
                y = torch.amax(_a(x), dim=(2, 3), keepdim=True)
            elif op == "Max":
                y = torch.maximum(_a(ins[0]), _a(ins[1]))
            elif op == "Min":
                y = torch.minimum(_a(ins[0]), _a(ins[1]))
            elif op == "LRN":
                # cross-channel local response normalization
                # (dnn/src/layers/lrn_layer.cpp semantics)
                xx = _a(x)
                size = at["size"]
                alpha = at.get("alpha", 1e-4)
                beta = at.get("beta", 0.75)
                bias = at.get("bias", 1.0)
                half = size // 2
                sp = F.pad(xx * xx, (0, 0, 0, 0, half, size - 1 - half))
                den = sum(sp[:, k:k + xx.shape[1]] for k in range(size))
                y = xx / (bias + (alpha / size) * den) ** beta
            elif op == "Gemm":
                A = _a(x)
                B = _a(ins[1])
                if at.get("transA", 0):
                    A = A.T
                if at.get("transB", 0):
                    B = B.T
                y = at.get("alpha", 1.0) * (A @ B)
                if len(ins) > 2 and ins[2] is not None:
                    y = y + at.get("beta", 1.0) * _a(ins[2])
            elif op == "MatMul":
                y = _a(x) @ _a(ins[1])
            elif op == "BatchNormalization":
                g, be, mean, var = (_a(v) for v in ins[1:5])
                eps = at.get("epsilon", 1e-5)
                xx = _a(x)
                shp = (1, -1) + (1,) * (xx.ndim - 2)
                y = (xx - mean.reshape(shp)) / torch.sqrt(var.reshape(shp) + eps) \
                    * g.reshape(shp) + be.reshape(shp)
            elif op in ("Add", "Sum"):
                y = ins[0] + ins[1] if _host_ints(ins[0], ins[1]) else _a(ins[0]) + _a(ins[1])
            elif op == "Sub":
                y = ins[0] - ins[1] if _host_ints(ins[0], ins[1]) else _a(ins[0]) - _a(ins[1])
            elif op == "Mul":
                y = ins[0] * ins[1] if _host_ints(ins[0], ins[1]) else _a(ins[0]) * _a(ins[1])
            elif op == "Div":
                y = _a(ins[0]) / _a(ins[1])
            elif op == "Concat":
                ax = at.get("axis", 0)
                if _host_ints(*ins):
                    y = np.concatenate(ins, axis=ax)
                else:
                    y = torch.cat([_a(v) for v in ins], dim=ax)
            elif op == "Flatten":
                ax = at.get("axis", 1)
                xx = _a(x)
                lead = int(np.prod(xx.shape[:ax])) if ax else 1
                y = xx.reshape(lead, -1)
            elif op == "Reshape":
                shp = _np(ins[1]).astype(int).tolist()
                y = _a(x).reshape(shp)
            elif op == "Transpose":
                xx = _a(x)
                perm = at.get("perm")
                y = xx.permute(*(perm if perm is not None else reversed(range(xx.ndim))))
            elif op == "Unsqueeze":
                axes = at.get("axes") or _np(ins[1]).tolist()
                y = x
                for a in sorted(int(v) for v in axes):
                    y = np.expand_dims(y, a) if isinstance(y, np.ndarray) \
                        else _a(y).unsqueeze(a)
            elif op == "Squeeze":
                axes = at.get("axes") or (_np(ins[1]).tolist() if len(ins) > 1 else None)
                xx = _a(x)
                y = xx.squeeze(tuple(int(a) for a in axes)) if axes else xx.squeeze()
            elif op == "Shape":
                y = np.asarray(tuple(x.shape), np.int64)
            elif op == "Gather":
                idx = _np(ins[1]).astype(np.int64)
                ax = at.get("axis", 0)
                if isinstance(x, np.ndarray) and x.dtype == np.int64:
                    n = x.shape[ax]
                    y = np.take(x, np.where(idx < 0, idx + n, idx), axis=ax)
                else:
                    xx = _a(x)
                    n = xx.shape[ax]
                    ii = torch.as_tensor(np.where(idx < 0, idx + n, idx), device=xx.device)
                    y = xx.index_select(ax, ii.reshape(-1)).reshape(
                        xx.shape[:ax % xx.ndim] + tuple(idx.shape) + xx.shape[ax % xx.ndim + 1:])
            elif op == "Constant":
                y = at.get("value")
            elif op == "ConstantOfShape":
                val = at.get("value", np.zeros(1, np.float32))
                y = np.full(_np(x).astype(int), np.asarray(val).ravel()[0])
            elif op == "Slice":
                starts = _np(ins[1]).astype(int)
                ends = _np(ins[2]).astype(int)
                axes = _np(ins[3]).astype(int) if len(ins) > 3 \
                    and ins[3] is not None else np.arange(len(starts))
                steps = _np(ins[4]).astype(int) if len(ins) > 4 \
                    and ins[4] is not None else np.ones(len(starts), int)
                if isinstance(x, np.ndarray):
                    sl = [slice(None)] * x.ndim
                    for s0, e0, a0, st in zip(starts, ends, axes, steps):
                        sl[int(a0)] = slice(int(s0), int(e0), int(st))
                    y = x[tuple(sl)]
                else:
                    y = _a(x)
                    for s0, e0, a0, st in zip(starts, ends, axes, steps):
                        y = _slice_axis(y, int(a0) % y.ndim, int(s0), int(e0), int(st))
            elif op == "Pad":
                pads = at.get("pads") or _np(ins[1]).astype(int).tolist()
                xx = _a(x)
                nd = xx.ndim
                pw = [(pads[i], pads[i + nd]) for i in range(nd)]
                y = _pad(xx, pw, at.get("mode", "constant"))
            elif op in ("Resize", "Upsample"):
                xx = _a(x)
                if len(ins) >= 4 and ins[3] is not None \
                        and _np(ins[3]).size:
                    new = _np(ins[3]).astype(int)
                    oh, ow = int(new[2]), int(new[3])
                else:
                    scales = _np(ins[2] if len(ins) > 2 else ins[1]).astype(float)
                    oh = int(xx.shape[2] * scales[2])
                    ow = int(xx.shape[3] * scales[3])
                if "nearest" in at.get("mode", "nearest"):
                    y = _resize_nearest(xx, oh, ow)
                else:
                    y = _resize_linear(xx, oh, ow)
            elif op == "Identity":
                y = x
            elif op == "Dropout":
                y = x
            elif op == "Cast":
                y = _a(x).to(_TORCH_DTYPES[at.get("to", 1)])
            elif op == "ReduceMean":
                axes = at.get("axes")
                xx = _a(x)
                keep = bool(at.get("keepdims", 1))
                y = torch.mean(xx, dim=tuple(axes), keepdim=keep) if axes else (
                    torch.mean(xx).reshape((1,) * xx.ndim if keep else ()))
            elif op == "Erf":
                y = torch.erf(_a(x))
            elif op == "Sqrt":
                y = torch.sqrt(_a(x))
            elif op == "Pow":
                y = _a(ins[0]) ** _a(ins[1])
            elif op == "Exp":
                y = torch.exp(_a(x))
            elif op == "Tile":
                reps = [int(v) for v in _np(ins[1]).ravel()]
                y = torch.tile(_a(x), reps)
            elif op == "Softplus":
                xx = _a(x)
                y = torch.logaddexp(xx, torch.zeros_like(xx))
            elif op == "Mish":
                xx = _a(x)
                y = xx * torch.tanh(torch.logaddexp(xx, torch.zeros_like(xx)))
            elif op == "Swish":
                xx = _a(x)
                y = xx * torch.sigmoid(xx)
            elif op == "Reorg":
                # darknet reorg (reorg_layer.cpp finalize): reshape +
                # permute(0,2,4,1,3)
                xx = _a(x)
                s = at.get("stride", 2)
                N, C, H, W = xx.shape
                t = xx.reshape(N, C * H // (s * s), s, W, s)
                t = t.permute(0, 2, 4, 1, 3)
                y = t.reshape(N, C * s * s, H // s, W // s)
            elif op == "Region":
                y = _region_decode(_a(ins[0]), _np(ins[1]),
                                   None if len(ins) < 3 or ins[2] is None
                                   else tuple(ins[2].shape), at)
            elif op in _EXTRA_OPS:
                y = _EXTRA_OPS[op](ins, at)
            else:
                raise NotImplementedError(f"ONNX op {op} not supported "
                                          "in this round")
            if isinstance(y, tuple):
                for o, v in zip(outs, y):
                    vals[o] = v
            else:
                vals[outs[0]] = y  # extra outputs (e.g. Dropout mask)
        return vals


def _read_bytes(path):
    if isinstance(path, (bytes, bytearray, memoryview)):
        return bytes(path)
    if isinstance(path, np.ndarray):
        return path.tobytes()
    with open(path, "rb") as f:
        return f.read()


def readNetFromONNX(path, device=None):
    """Accepts a filename OR an in-memory model buffer (the reference's
    readNetFromONNX has both overloads, modules/dnn/src/onnx/)."""
    model = _onnx.ModelProto()
    model.ParseFromString(_read_bytes(path))
    return Net(model, device)


def readNet(model, config="", framework="", device=None):
    """cv2.dnn.readNet: dispatch on file extension (dnn.cpp readNet)."""
    m = str(model)
    c = str(config)
    ext = m.rsplit(".", 1)[-1].lower() if "." in m else ""
    fw = framework or {"onnx": "onnx", "caffemodel": "caffe",
                       "prototxt": "caffe", "pb": "tensorflow",
                       "tflite": "tflite", "weights": "darknet",
                       "cfg": "darknet"}.get(ext, "")
    if fw == "onnx":
        return readNetFromONNX(m, device)
    if fw == "caffe":
        if ext == "prototxt":
            return readNetFromCaffe(m, c or None, device)
        return readNetFromCaffe(c, m, device)
    if fw == "tensorflow":
        return readNetFromTensorflow(m, c or None, device)
    if fw == "tflite":
        return readNetFromTFLite(m, device)
    if fw == "darknet":
        if ext == "cfg":
            return readNetFromDarknet(m, c or None, device)
        return readNetFromDarknet(c, m, device)
    raise ValueError(f"cannot guess framework for {model!r}")


class Image2BlobParams:
    """cv2.dnn.Image2BlobParams (dnn_utils.cpp:15)."""

    def __init__(self, scalefactor=1.0, size=None, mean=0.0, swapRB=False,
                 ddepth=None, datalayout=0, paddingmode=0):
        self.scalefactor = scalefactor
        self.size = size
        self.mean = mean
        self.swapRB = swapRB
        self.ddepth = ddepth
        self.datalayout = datalayout
        self.paddingmode = paddingmode


def _scalar4(v):
    a = np.zeros(4, np.float32)
    if v is None:
        return a
    v = np.atleast_1d(np.asarray(v, np.float32)).ravel()
    a[:len(v)] = v[:4]
    return a


def _images(images):
    """A batch of HWC images as one NHWC tensor (on the images' device),
    and whether they came as numpy."""
    if isinstance(images, torch.Tensor):
        x = images
        return (x[..., None] if x.ndim == 3 else x), False
    imgs = list(images)
    if imgs and all(isinstance(i, torch.Tensor) for i in imgs):
        x = torch.stack(imgs)
        return (x[..., None] if x.ndim == 3 else x), False
    a = np.stack([np.asarray(i) for i in imgs])
    return torch.from_numpy(a[..., None] if a.ndim == 3 else a), True


def _swap_rb(x):
    C = x.shape[-1]
    if C < 3:
        return x
    return x[..., [2, 1, 0] + list(range(3, C))]


def blobFromImageWithParams(image, params=None):
    """cv2.dnn.blobFromImageWithParams: per-channel (x - mean) * scale
    after optional resize + swapRB (dnn_utils.cpp:188-201).  The resize
    runs in the source depth (u8 rounds) before the float conversion."""
    if params is None:
        params = Image2BlobParams()
    from ..ops.resize import resize as cv_resize
    from .. import constants as K
    a, as_np = _images([image])
    if params.size is not None and tuple(params.size):
        w, h = params.size
        if (a.shape[2], a.shape[1]) != (w, h):
            a = cv_resize(a, (w, h), interpolation=K.INTER_LINEAR)
            if a.ndim == 3:
                a = a[..., None]
    a = a.to(torch.float32)
    if params.swapRB:
        a = _swap_rb(a)
    nc = a.shape[-1]
    mean = torch.as_tensor(_scalar4(params.mean)[:nc], device=a.device)
    scale = np.atleast_1d(np.asarray(params.scalefactor, np.float32)).ravel()
    if scale.size == 1:
        scale = np.full(nc, scale[0], np.float32)
    else:
        scale = _scalar4(params.scalefactor)[:nc]
    a = (a - mean) * torch.as_tensor(scale, device=a.device)
    out = a.permute(0, 3, 1, 2).contiguous()
    return out.numpy() if as_np else out


def blobFromImage(image, scalefactor=1.0, size=None, mean=None,
                  swapRB=False, crop=False, ddepth=None):
    return blobFromImages([image], scalefactor, size, mean, swapRB, crop,
                          ddepth)


def blobFromImages(images, scalefactor=1.0, size=None, mean=None,
                   swapRB=False, crop=False, ddepth=None):
    """cv2.dnn.blobFromImages: (N, C, H, W) float32 blob.  The images (a
    list, or one (N, H, W[, C]) tensor) go as one batch on their device:
    converted to f32, then resized (INTER_LINEAR), channels swapped, mean
    taken and scaled.  Numpy images give a numpy blob."""
    from ..ops.resize import resize as cv_resize
    from .. import constants as K
    if not isinstance(images, torch.Tensor):
        images = list(images)
        if len({tuple(np.shape(i)) for i in images}) > 1:   # each its own size
            parts = [blobFromImages([i], scalefactor, size, mean, swapRB, crop, ddepth)
                     for i in images]
            return (torch.cat(parts) if isinstance(parts[0], torch.Tensor)
                    else np.concatenate(parts))
    a, as_np = _images(images)
    a = a.to(torch.float32)
    if size is not None and tuple(size):
        w, h = size
        if crop:
            ih, iw = a.shape[1:3]
            s = max(w / iw, h / ih)
            a = cv_resize(a, (int(round(iw * s)), int(round(ih * s))),
                          interpolation=K.INTER_LINEAR)
            if a.ndim == 3:
                a = a[..., None]
            y0 = (a.shape[1] - h) // 2
            x0 = (a.shape[2] - w) // 2
            a = a[:, y0:y0 + h, x0:x0 + w]
        else:
            a = cv_resize(a, (w, h), interpolation=K.INTER_LINEAR)
        if a.ndim == 3:
            a = a[..., None]
    if swapRB:
        a = _swap_rb(a)
    if mean is not None:
        m = torch.as_tensor(np.asarray(mean, np.float32).reshape(-1), device=a.device)
        a = a - m[:a.shape[-1]]
    a = a * scalefactor
    out = a.permute(0, 3, 1, 2).contiguous()
    return out.numpy() if as_np else out


from .importers import readNetFromCaffe, readNetFromTensorflow  # noqa: E402,F401
from .darknet import readNetFromDarknet  # noqa: E402,F401
from .nms import (  # noqa: E402,F401
    NMSBoxes, NMSBoxesBatched, NMSBoxesRotated, softNMSBoxes,
)
from .tflite import readNetFromTFLite  # noqa: E402,F401
from .models import (  # noqa: E402,F401
    Model, ClassificationModel, DetectionModel, SegmentationModel,
    KeypointsModel, TextRecognitionModel,
    TextDetectionModel_EAST, TextDetectionModel_DB,
)


_CUSTOM_LAYERS = {}


def dnn_registerLayer(layerTypeName: str, layerClass) -> None:
    """cv::dnn::registerLayer — custom layer factory registry (consulted
    by the ONNX importer for unknown node types)."""
    _CUSTOM_LAYERS[layerTypeName] = layerClass


def dnn_unregisterLayer(layerTypeName: str) -> None:
    _CUSTOM_LAYERS.pop(layerTypeName, None)


class DictValue:
    """cv::dnn::DictValue — tagged scalar for layer params."""

    def __init__(self, v):
        self._v = v

    def isInt(self):
        return isinstance(self._v, int)

    def isReal(self):
        return isinstance(self._v, float)

    def isString(self):
        return isinstance(self._v, str)

    def getIntValue(self, idx: int = -1):
        return int(self._v)

    def getRealValue(self, idx: int = -1):
        return float(self._v)

    def getStringValue(self, idx: int = -1):
        return str(self._v)


class Layer:
    """cv::dnn::Layer base — custom layers registered via
    dnn_registerLayer subclass this surface."""

    def __init__(self, params=None):
        self.blobs = []
        self.name = ""
        self.type = ""
        self.preferableTarget = 0

    def finalize(self, inputs):
        return []

    def run(self, inputs, internals):
        raise NotImplementedError

    def outputNameToIndex(self, outputName):
        return -1

    def empty(self):
        return False

    def clear(self):
        pass

    def getDefaultName(self):
        return "Layer"


class Tokenizer:
    """cv::dnn::Tokenizer — byte-pair / word-piece tokenizer surface.
    Loads the reference's JSON vocab format when available; falls back
    to whitespace+byte tokens so encode/decode round-trips."""

    def __init__(self, vocab=None):
        self._vocab = vocab or {}
        self._inv = {v: k for k, v in self._vocab.items()}

    @staticmethod
    def load(path):
        import json
        try:
            with open(path) as f:
                data = json.load(f)
            vocab = data.get("model", {}).get("vocab", data) \
                if isinstance(data, dict) else {}
            return Tokenizer({str(k): int(v) for k, v in vocab.items()
                              if isinstance(v, int)})
        except (OSError, ValueError):
            return Tokenizer()

    def encode(self, text):
        if self._vocab:
            toks = [self._vocab.get(w, 0) for w in text.split()]
        else:
            toks = list(text.encode("utf-8"))
        return np.asarray(toks, np.int32)

    def decode(self, tokens):
        toks = np.asarray(tokens).ravel().tolist()
        if self._inv:
            return " ".join(self._inv.get(t, "") for t in toks)
        return bytes(int(t) & 0xFF for t in toks).decode(
            "utf-8", "replace")
