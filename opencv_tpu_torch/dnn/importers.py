"""Caffe / TensorFlow importers (modules/dnn/src/caffe/caffe_importer.cpp,
tensorflow/tf_importer.cpp).

Both readers parse with the port's codec (``_proto``) over the schemas of
the reference's bundled proto files (opencv-caffe.proto, tensorflow/*.proto
— public Caffe/TF schemas) and convert the graph into the internal ONNX
representation executed by [[dnn]] Net, so every framework shares one
executor.  TF graphs are NHWC; like the reference importer, tensors
run internally as NCHW with weights/axes/paddings permuted at
conversion time.
"""

from __future__ import annotations

import os

import numpy as np

from . import _proto

_onnx = _proto.schema("onnx_schema")
_caffe = _proto.schema("opencv_caffe")
_tfg = _proto.schema("graph")

__all__ = ["readNetFromCaffe", "readNetFromTensorflow"]


# ------------------------------------------------------- ONNX builders

def _np_to_tensor(arr, name):
    arr = np.asarray(arr)
    t = _onnx.TensorProto()
    t.name = name
    t.dims.extend(arr.shape)
    kind = {np.dtype(np.float32): 1, np.dtype(np.int64): 7,
            np.dtype(np.int32): 6, np.dtype(np.float64): 11}
    t.data_type = kind.get(arr.dtype, 1)
    if t.data_type == 1:
        arr = arr.astype(np.float32)
    t.raw_data = arr.tobytes()
    return t


class _GraphBuilder:
    def __init__(self, name):
        self.model = _onnx.ModelProto()
        self.model.ir_version = 7
        op = self.model.opset_import.add()
        op.domain = ""
        op.version = 13
        g = self.model.graph
        g.name = name
        self.g = g
        self._n = 0

    def init(self, name, arr):
        self.g.initializer.append(_np_to_tensor(arr, name))

    def input(self, name):
        vi = self.g.input.add()
        vi.name = name
        vi.type.tensor_type.elem_type = 1

    def output(self, name):
        vi = self.g.output.add()
        vi.name = name
        vi.type.tensor_type.elem_type = 1

    def node(self, op, inputs, outputs, **attrs):
        n = self.g.node.add()
        n.op_type = op
        n.name = f"{op}_{self._n}"
        self._n += 1
        n.input.extend(inputs)
        n.output.extend(outputs)
        for k, v in attrs.items():
            a = n.attribute.add()
            a.name = k
            if isinstance(v, bool):
                a.type = _onnx.AttributeProto.INT
                a.i = int(v)
            elif isinstance(v, int):
                a.type = _onnx.AttributeProto.INT
                a.i = v
            elif isinstance(v, float):
                a.type = _onnx.AttributeProto.FLOAT
                a.f = v
            elif isinstance(v, str):
                a.type = _onnx.AttributeProto.STRING
                a.s = v.encode()
            elif isinstance(v, (list, tuple)) and v and \
                    isinstance(v[0], float):
                a.type = _onnx.AttributeProto.FLOATS
                a.floats.extend(v)
            elif isinstance(v, (list, tuple)):
                a.type = _onnx.AttributeProto.INTS
                a.ints.extend(int(x) for x in v)
            else:
                raise TypeError(f"attr {k}={v!r}")
        return n


# ------------------------------------------------------------- Caffe

def _blob_to_np(blob):
    if blob.shape.dim:
        shape = tuple(blob.shape.dim)
    else:
        shape = tuple(d for d in (blob.num, blob.channels, blob.height,
                                  blob.width) if d)
    if blob.double_data:
        data = np.asarray(blob.double_data, np.float32)
    else:
        data = np.asarray(blob.data, np.float32)
    return data.reshape(shape) if shape else data


def _caffe_hw(param, field, default):
    """kernel/stride/pad: repeated value or _h/_w pair."""
    rep = getattr(param, field)
    vh = getattr(param, field + "_h", 0)
    vw = getattr(param, field + "_w", 0)
    if vh or vw:
        return int(vh or default), int(vw or default)
    if hasattr(rep, "__len__"):
        if len(rep) == 0:
            return default, default
        if len(rep) == 1:
            return int(rep[0]), int(rep[0])
        return int(rep[0]), int(rep[1])
    v = int(rep) if rep else default
    return v, v


def readNetFromCaffe(prototxt, caffeModel=None, device=None):
    """caffe_importer.cpp role: prototxt (text) + caffemodel (binary)
    merged by layer name, converted layer-by-layer; the net on `device`
    ("cuda" unless asked)."""
    from . import Net

    net = _caffe.NetParameter()
    if os.path.exists(str(prototxt)):
        with open(prototxt) as f:
            _proto.parse_text(f.read(), net)
    else:
        _proto.parse_text(prototxt, net)

    weights = {}
    if caffeModel is not None:
        wnet = _caffe.NetParameter()
        if isinstance(caffeModel, (bytes, bytearray)):
            wnet.ParseFromString(bytes(caffeModel))
        else:
            with open(caffeModel, "rb") as f:
                wnet.ParseFromString(f.read())
        for layer in wnet.layer:
            if layer.blobs:
                weights[layer.name] = [_blob_to_np(b) for b in layer.blobs]

    b = _GraphBuilder(net.name or "caffe")
    # legacy top-level inputs
    for i, iname in enumerate(net.input):
        b.input(iname)

    # alias map for in-place layers: resolve each bottom to the latest
    # tensor name that holds it
    alias = {}

    def src(name):
        return alias.get(name, name)

    produced = []
    for li, layer in enumerate(net.layer):
        typ = layer.type
        name = layer.name or f"layer{li}"
        bots = [src(x) for x in layer.bottom]
        tops = list(layer.top)
        blobs = weights.get(name, [_blob_to_np(x) for x in layer.blobs])

        def out_for(i=0):
            """Unique output name; records alias for in-place tops."""
            t = tops[i]
            uniq = t if t not in alias and t not in [x for x in produced] \
                else f"{t}__{li}"
            alias[t] = uniq
            produced.append(uniq)
            return uniq

        if typ == "Input":
            for i, t in enumerate(tops):
                b.input(t)
                alias[t] = t
            continue
        if typ == "Convolution":
            p = layer.convolution_param
            kh, kw = _caffe_hw(p, "kernel_size", 0)
            sh, sw = _caffe_hw(p, "stride", 1)
            ph, pw = _caffe_hw(p, "pad", 0)
            dil = list(p.dilation) or [1]
            W = blobs[0]
            b.init(f"{name}_W", W)
            ins = [bots[0], f"{name}_W"]
            if p.bias_term and len(blobs) > 1:
                b.init(f"{name}_b", blobs[1])
                ins.append(f"{name}_b")
            b.node("Conv", ins, [out_for()],
                   kernel_shape=[kh or W.shape[2], kw or W.shape[3]],
                   strides=[sh, sw], pads=[ph, pw, ph, pw],
                   dilations=[dil[0], dil[-1]], group=int(p.group) or 1)
        elif typ == "Pooling":
            p = layer.pooling_param
            kind = "MaxPool" if p.pool == 0 else "AveragePool"
            if p.global_pooling:
                if p.pool == 0:
                    b.node("GlobalMaxPool", [bots[0]], [out_for()])
                else:
                    b.node("GlobalAveragePool", [bots[0]], [out_for()])
            else:
                kh, kw = _caffe_hw(p, "kernel_size", 0)
                sh, sw = _caffe_hw(p, "stride", 1)
                ph, pw = _caffe_hw(p, "pad", 0)
                b.node(kind, [bots[0]], [out_for()],
                       kernel_shape=[kh, kw], strides=[sh, sw],
                       pads=[ph, pw, ph, pw], ceil_mode=1,
                       count_include_pad=1)
        elif typ == "InnerProduct":
            p = layer.inner_product_param
            W = blobs[0].reshape(int(p.num_output), -1)
            flat = f"{name}_flat"
            b.node("Flatten", [bots[0]], [flat], axis=int(p.axis) or 1)
            b.init(f"{name}_W", W)
            ins = [flat, f"{name}_W"]
            if p.bias_term and len(blobs) > 1:
                b.init(f"{name}_b", blobs[1].reshape(-1))
                ins.append(f"{name}_b")
            b.node("Gemm", ins, [out_for()], transB=1)
        elif typ == "ReLU":
            slope = float(layer.relu_param.negative_slope)
            if slope:
                b.node("LeakyRelu", [bots[0]], [out_for()], alpha=slope)
            else:
                b.node("Relu", [bots[0]], [out_for()])
        elif typ == "Sigmoid":
            b.node("Sigmoid", [bots[0]], [out_for()])
        elif typ == "TanH":
            b.node("Tanh", [bots[0]], [out_for()])
        elif typ == "Softmax":
            b.node("Softmax", [bots[0]], [out_for()],
                   axis=int(layer.softmax_param.axis) or 1)
        elif typ == "Concat":
            b.node("Concat", bots, [out_for()],
                   axis=int(layer.concat_param.axis)
                   if layer.HasField("concat_param") else 1)
        elif typ == "Eltwise":
            op = {0: "Mul", 1: "Add", 2: "Max"}[
                int(layer.eltwise_param.operation)]
            if op == "Max":
                cur = bots[0]
                for k, extra in enumerate(bots[1:]):
                    nxt = out_for() if k == len(bots) - 2 \
                        else f"{name}_max{k}"
                    b.node("Max", [cur, extra], [nxt])
                    cur = nxt
            else:
                cur = bots[0]
                for k, extra in enumerate(bots[1:]):
                    nxt = out_for() if k == len(bots) - 2 \
                        else f"{name}_acc{k}"
                    b.node(op, [cur, extra], [nxt])
                    cur = nxt
        elif typ == "BatchNorm":
            sf = float(blobs[2].ravel()[0]) if len(blobs) > 2 and \
                blobs[2].size else 1.0
            sf = 1.0 / sf if sf else 1.0
            mean = blobs[0].reshape(-1) * sf
            var = blobs[1].reshape(-1) * sf
            C = mean.size
            b.init(f"{name}_g", np.ones(C, np.float32))
            b.init(f"{name}_be", np.zeros(C, np.float32))
            b.init(f"{name}_m", mean.astype(np.float32))
            b.init(f"{name}_v", var.astype(np.float32))
            b.node("BatchNormalization",
                   [bots[0], f"{name}_g", f"{name}_be", f"{name}_m",
                    f"{name}_v"], [out_for()],
                   epsilon=float(layer.batch_norm_param.eps) or 1e-5)
        elif typ == "Scale":
            gamma = blobs[0].reshape(1, -1, 1, 1)
            b.init(f"{name}_s", gamma)
            mul_out = f"{name}_mul" if layer.scale_param.bias_term \
                else out_for()
            b.node("Mul", [bots[0], f"{name}_s"], [mul_out])
            if layer.scale_param.bias_term:
                b.init(f"{name}_bb", blobs[1].reshape(1, -1, 1, 1))
                b.node("Add", [mul_out, f"{name}_bb"], [out_for()])
        elif typ == "LRN":
            p = layer.lrn_param
            b.node("LRN", [bots[0]], [out_for()],
                   alpha=float(p.alpha) or 1.0,
                   beta=float(p.beta) or 0.75,
                   size=int(p.local_size) or 5, bias=float(p.k) or 1.0)
        elif typ in ("Dropout", "Split"):
            for i in range(len(tops)):
                b.node("Identity", [bots[0]], [out_for(i)])
        elif typ == "Flatten":
            b.node("Flatten", [bots[0]], [out_for()],
                   axis=int(layer.flatten_param.axis) or 1)
        elif typ == "Reshape":
            shp = list(layer.reshape_param.shape.dim)
            b.init(f"{name}_shape", np.asarray(shp, np.int64))
            b.node("Reshape", [bots[0], f"{name}_shape"], [out_for()])
        elif typ == "Power":
            p = layer.power_param
            cur = bots[0]
            if p.scale != 1.0 and p.scale != 0.0 or p.scale == 0.0:
                b.init(f"{name}_sc", np.float32(p.scale or 1.0))
                nxt = f"{name}_scaled"
                b.node("Mul", [cur, f"{name}_sc"], [nxt])
                cur = nxt
            if p.shift:
                b.init(f"{name}_sh", np.float32(p.shift))
                nxt = f"{name}_shifted"
                b.node("Add", [cur, f"{name}_sh"], [nxt])
                cur = nxt
            b.init(f"{name}_pw", np.float32(p.power or 1.0))
            b.node("Pow", [cur, f"{name}_pw"], [out_for()])
        else:
            raise NotImplementedError(f"Caffe layer type {typ!r}")

    # graph outputs: tensors never consumed
    consumed = set()
    for n in b.g.node:
        consumed.update(n.input)
    for n in b.g.node:
        for o in n.output:
            if o not in consumed:
                b.output(o)
    return Net(b.model, device)


# -------------------------------------------------------- TensorFlow

_TF_DT = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8,
          5: np.int16, 6: np.int8, 9: np.int64, 10: np.bool_}


def _tf_tensor_to_np(t):
    dt = _TF_DT.get(t.dtype, np.float32)
    shape = tuple(d.size for d in t.tensor_shape.dim)
    if t.tensor_content:
        arr = np.frombuffer(t.tensor_content, dt)
    elif t.float_val:
        arr = np.asarray(t.float_val, dt)
    elif t.int_val:
        arr = np.asarray(t.int_val, dt)
    elif t.double_val:
        arr = np.asarray(t.double_val, dt)
    elif t.int64_val:
        arr = np.asarray(t.int64_val, dt)
    else:
        arr = np.zeros(shape, dt)
    if shape and arr.size == 1 and int(np.prod(shape)) > 1:
        arr = np.full(shape, arr.ravel()[0], dt)
    return arr.reshape(shape) if shape else arr.reshape(())


def _nhwc_axis_to_nchw(ax, rank=4):
    if rank != 4:
        return ax
    return {0: 0, 1: 2, 2: 3, 3: 1}.get(int(ax), int(ax))


def readNetFromTensorflow(model, config=None, device=None):
    """tf_importer.cpp role: frozen GraphDef -> internal NCHW graph on
    `device` ("cuda" unless asked).  Weights (HWIO), pool/conv strides,
    paddings, concat axes, and reduction indices are permuted from NHWC at
    conversion time."""
    from . import Net

    gd = _tfg.GraphDef()
    if isinstance(model, (bytes, bytearray)):
        gd.ParseFromString(bytes(model))
    else:
        with open(model, "rb") as f:
            gd.ParseFromString(f.read())

    b = _GraphBuilder("tf")
    consts = {}

    def tname(ref):
        # strip :0 port suffixes and ^control inputs
        ref = ref.lstrip("^")
        return ref.split(":")[0]

    for nd in gd.node:
        op = nd.op
        name = nd.name
        ins = [tname(i) for i in nd.input if not i.startswith("^")]
        at = dict(nd.attr)

        if op in ("Const",):
            consts[name] = _tf_tensor_to_np(at["value"].tensor)
            continue
        if op in ("Placeholder",):
            b.input(name)
            continue
        if op in ("Identity", "NoOp", "CheckNumerics", "StopGradient"):
            if ins and ins[0] in consts:
                consts[name] = consts[ins[0]]
            else:
                b.node("Identity", [ins[0]], [name])
            continue
        if op == "Conv2D":
            W = consts[ins[1]]                       # HWIO
            b.init(f"{name}_W", np.transpose(W, (3, 2, 0, 1)).copy())
            st = at["strides"].list.i
            pad = at["padding"].s.decode()
            attrs = dict(kernel_shape=[W.shape[0], W.shape[1]],
                         strides=[int(st[1]), int(st[2])])
            if pad == "SAME":
                attrs["auto_pad"] = "SAME_UPPER"
            b.node("Conv", [ins[0], f"{name}_W"], [name], **attrs)
        elif op == "DepthwiseConv2dNative":
            W = consts[ins[1]]                       # HWIM
            kh, kw, ic, m = W.shape
            Wo = np.transpose(W, (2, 3, 0, 1)).reshape(ic * m, 1, kh, kw)
            b.init(f"{name}_W", Wo.copy())
            st = at["strides"].list.i
            pad = at["padding"].s.decode()
            attrs = dict(kernel_shape=[kh, kw],
                         strides=[int(st[1]), int(st[2])], group=ic)
            if pad == "SAME":
                attrs["auto_pad"] = "SAME_UPPER"
            b.node("Conv", [ins[0], f"{name}_W"], [name], **attrs)
        elif op in ("BiasAdd", "Add", "AddV2", "Sub", "Mul", "RealDiv"):
            onnx_op = {"BiasAdd": "Add", "Add": "Add", "AddV2": "Add",
                       "Sub": "Sub", "Mul": "Mul",
                       "RealDiv": "Div"}[op]
            names = []
            for i, src_n in enumerate(ins):
                if src_n in consts:
                    c = consts[src_n]
                    if c.ndim == 1:
                        c = c.reshape(1, -1, 1, 1)
                    b.init(f"{name}_c{i}", c.astype(np.float32))
                    names.append(f"{name}_c{i}")
                else:
                    names.append(src_n)
            b.node(onnx_op, names, [name])
        elif op in ("MaxPool", "AvgPool"):
            ks = at["ksize"].list.i
            st = at["strides"].list.i
            pad = at["padding"].s.decode()
            attrs = dict(kernel_shape=[int(ks[1]), int(ks[2])],
                         strides=[int(st[1]), int(st[2])])
            if pad == "SAME":
                attrs["auto_pad"] = "SAME_UPPER"
            if op == "AvgPool":
                attrs["count_include_pad"] = 0
            b.node("MaxPool" if op == "MaxPool" else "AveragePool",
                   [ins[0]], [name], **attrs)
        elif op == "MatMul":
            W = consts[ins[1]]
            tb = at["transpose_b"].b if "transpose_b" in at else False
            b.init(f"{name}_W", W if not tb else W)
            b.node("Gemm", [ins[0], f"{name}_W"], [name],
                   transB=1 if tb else 0)
        elif op == "Relu":
            b.node("Relu", [ins[0]], [name])
        elif op == "Relu6":
            b.node("Clip", [ins[0]], [name], min=0.0, max=6.0)
        elif op == "Softmax":
            b.node("Softmax", [ins[0]], [name], axis=1)
        elif op == "Reshape":
            shp = consts[ins[1]].astype(np.int64)
            b.init(f"{name}_shape", shp)
            b.node("Reshape", [ins[0], f"{name}_shape"], [name])
        elif op == "Squeeze":
            dims = [int(d) for d in at["squeeze_dims"].list.i]
            axes = [_nhwc_axis_to_nchw(d) for d in dims]
            b.node("Squeeze", [ins[0]], [name], axes=sorted(axes))
        elif op == "Mean":
            idx = consts[ins[1]].ravel().tolist()
            axes = sorted(_nhwc_axis_to_nchw(a) for a in idx)
            keep = at["keep_dims"].b if "keep_dims" in at else False
            b.node("ReduceMean", [ins[0]], [name], axes=axes,
                   keepdims=1 if keep else 0)
        elif op in ("ConcatV2", "Concat"):
            if op == "ConcatV2":
                ax = int(consts[ins[-1]].ravel()[0])
                data = ins[:-1]
            else:
                ax = int(consts[ins[0]].ravel()[0])
                data = ins[1:]
            names = []
            for i, src_n in enumerate(data):
                if src_n in consts:
                    b.init(f"{name}_c{i}", consts[src_n])
                    names.append(f"{name}_c{i}")
                else:
                    names.append(src_n)
            b.node("Concat", names, [name],
                   axis=_nhwc_axis_to_nchw(ax))
        elif op in ("FusedBatchNorm", "FusedBatchNormV3"):
            g, be, m, v = (consts[ins[k]].reshape(-1).astype(np.float32)
                           for k in (1, 2, 3, 4))
            eps = at["epsilon"].f if "epsilon" in at else 1e-5
            for suffix, arr in (("g", g), ("be", be), ("m", m),
                                ("v", v)):
                b.init(f"{name}_{suffix}", arr)
            b.node("BatchNormalization",
                   [ins[0], f"{name}_g", f"{name}_be", f"{name}_m",
                    f"{name}_v"], [name], epsilon=float(eps))
        elif op == "Pad":
            pads = consts[ins[1]].astype(int)     # (rank, 2) NHWC
            if pads.shape[0] == 4:
                order = [0, 3, 1, 2]
                pads = pads[order]
            flat = pads[:, 0].tolist() + pads[:, 1].tolist()
            b.node("Pad", [ins[0]], [name], pads=flat, mode="constant")
        elif op == "Sigmoid":
            b.node("Sigmoid", [ins[0]], [name])
        elif op == "Tanh":
            b.node("Tanh", [ins[0]], [name])
        elif op == "Maximum":
            b.node("Max", ins, [name])
        elif op == "Shape":
            b.node("Shape", [ins[0]], [name])
        else:
            raise NotImplementedError(f"TF op {op!r}")

    consumed = set()
    for n in b.g.node:
        consumed.update(n.input)
    for n in b.g.node:
        for o in n.output:
            if o not in consumed:
                b.output(o)
    return Net(b.model, device)
