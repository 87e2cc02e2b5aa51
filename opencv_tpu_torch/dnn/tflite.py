"""TFLite importer (`cv2.dnn.readNetFromTFLite`,
modules/dnn/src/tflite/tflite_importer.cpp).

TFLite models are FlatBuffers, not protobuf; rather than depending on a
flatbuffers runtime the reader below walks the binary format directly
(root uoffset → table vtables → fields), which needs ~100 lines for the
subset of the schema a converter emits (Model/SubGraph/Tensor/Operator/
Buffer + per-op option tables, field ids from the public tflite
schema.fbs v3).  The parsed graph is converted NHWC→NCHW into the
internal ONNX representation executed by the shared Net executor —
the same single-executor design as the Caffe/TF importers.  The JAX
package's pure-``struct`` reader, copied.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["readNetFromTFLite"]


# ------------------------------------------------------------ flatbuffers

class _FB:
    """Minimal FlatBuffers table reader."""

    def __init__(self, buf: bytes, pos: int):
        self.buf = buf
        self.pos = pos  # table position

    @classmethod
    def root(cls, buf: bytes):
        (off,) = struct.unpack_from("<I", buf, 0)
        return cls(buf, off)

    def _field(self, fid: int):
        """Byte offset of field `fid` within the table, or 0 if absent."""
        (soff,) = struct.unpack_from("<i", self.buf, self.pos)
        vt = self.pos - soff
        (vt_size,) = struct.unpack_from("<H", self.buf, vt)
        slot = 4 + 2 * fid
        if slot >= vt_size:
            return 0
        (foff,) = struct.unpack_from("<H", self.buf, vt + slot)
        return foff

    def scalar(self, fid: int, fmt: str, default=0):
        f = self._field(fid)
        if not f:
            return default
        return struct.unpack_from("<" + fmt, self.buf, self.pos + f)[0]

    def _indirect(self, fid: int):
        f = self._field(fid)
        if not f:
            return None
        p = self.pos + f
        (off,) = struct.unpack_from("<I", self.buf, p)
        return p + off

    def table(self, fid: int):
        p = self._indirect(fid)
        return None if p is None else _FB(self.buf, p)

    def string(self, fid: int, default=""):
        p = self._indirect(fid)
        if p is None:
            return default
        (n,) = struct.unpack_from("<I", self.buf, p)
        return self.buf[p + 4:p + 4 + n].decode("utf-8", "replace")

    def vector_len(self, fid: int):
        p = self._indirect(fid)
        if p is None:
            return 0
        return struct.unpack_from("<I", self.buf, p)[0]

    def vector_np(self, fid: int, dtype):
        p = self._indirect(fid)
        if p is None:
            return np.zeros(0, dtype)
        (n,) = struct.unpack_from("<I", self.buf, p)
        dt = np.dtype(dtype)
        return np.frombuffer(self.buf, dt, n, p + 4)

    def vector_tables(self, fid: int):
        p = self._indirect(fid)
        if p is None:
            return []
        (n,) = struct.unpack_from("<I", self.buf, p)
        out = []
        for i in range(n):
            ep = p + 4 + 4 * i
            (off,) = struct.unpack_from("<I", self.buf, ep)
            out.append(_FB(self.buf, ep + off))
        return out


# TensorType enum (schema.fbs)
_TT_NP = {0: np.float32, 1: np.float16, 2: np.int32, 3: np.uint8,
          4: np.int64, 6: np.bool_, 7: np.int16, 9: np.int8}

# BuiltinOperator codes used below (schema.fbs enum values)
_OP = {0: "ADD", 1: "AVERAGE_POOL_2D", 2: "CONCATENATION", 3: "CONV_2D",
       4: "DEPTHWISE_CONV_2D", 6: "DEQUANTIZE", 9: "FULLY_CONNECTED",
       14: "LOGISTIC", 17: "MAX_POOL_2D", 18: "MUL", 19: "RELU",
       21: "RELU6", 22: "RESHAPE", 23: "RESIZE_BILINEAR", 25: "SOFTMAX",
       28: "TANH", 34: "PAD", 39: "TRANSPOSE", 40: "MEAN", 41: "SUB",
       42: "DIV", 43: "SQUEEZE", 47: "EXP", 55: "MAXIMUM", 57: "MINIMUM",
       63: "SLICE", 77: "SHAPE", 78: "POW", 80: "FAKE_QUANT",
       97: "RESIZE_NEAREST", 117: "HARD_SWISH"}


def _act_suffix(code):
    return {0: None, 1: "Relu", 3: "Relu6", 4: "Tanh"}.get(code, None)


def readNetFromTFLite(model, device=None):
    """Parse a .tflite file (path or bytes) into a Net on `device`
    ("cuda" unless asked)."""
    from .importers import _GraphBuilder
    from . import Net

    if isinstance(model, (bytes, bytearray)):
        buf = bytes(model)
    else:
        with open(model, "rb") as f:
            buf = f.read()

    root = _FB.root(buf)
    opcodes = root.vector_tables(1)
    subgraphs = root.vector_tables(2)
    buffers = root.vector_tables(4)
    if not subgraphs:
        raise ValueError("TFLite model has no subgraphs")
    sg = subgraphs[0]

    tensors = sg.vector_tables(0)
    sg_inputs = sg.vector_np(1, np.int32)
    sg_outputs = sg.vector_np(2, np.int32)
    operators = sg.vector_tables(3)

    def tensor_np(ti):
        t = tensors[ti]
        shape = t.vector_np(0, np.int32)
        ttype = t.scalar(1, "b", 0)
        bi = t.scalar(2, "I", 0)
        data = buffers[bi].vector_np(0, np.uint8) if bi < len(buffers) \
            else np.zeros(0, np.uint8)
        if data.size == 0:
            return None
        arr = np.frombuffer(data.tobytes(), _TT_NP[ttype])
        return arr.reshape(shape)

    def tname(ti):
        nm = tensors[ti].string(3)
        return nm or f"t{ti}"

    gb = _GraphBuilder("tflite")
    const = {}   # tensor idx -> np array (weights)
    # NHWC activations run internally as NCHW (tflite_importer.cpp design)
    for ti in sg_inputs:
        gb.input(tname(ti))

    def src(ti):
        """Name of tensor ti as a node input; registers constants."""
        nm = tname(ti)
        if ti in const:
            return nm
        arr = tensor_np(ti)
        if arr is not None:
            const[ti] = arr
            gb.init(nm, arr.astype(np.float32)
                    if arr.dtype in (np.float16,) else arr)
        return nm

    def opname(oc):
        dep = oc.scalar(0, "b", 0)
        code = oc.scalar(3, "i", dep)
        if code == 0 and dep != 0:
            code = dep
        name = _OP.get(code)
        if name is None:
            cust = oc.string(1)
            raise NotImplementedError(
                f"TFLite builtin op {code} ({cust or 'builtin'})")
        return name

    def fused(out, act, final_name):
        """Append a fused-activation node if requested."""
        if act is None:
            return out
        if act == "Relu6":
            gb.node("Clip", [out], [final_name], min=0.0, max=6.0)
        else:
            gb.node(act, [out], [final_name])
        return final_name

    for oi, op in enumerate(operators):
        code = opname(opcodes[op.scalar(0, "I", 0)])
        ins = op.vector_np(1, np.int32).tolist()
        outs = op.vector_np(2, np.int32).tolist()
        opts = op.table(4)
        out_name = tname(outs[0])

        if code in ("CONV_2D", "DEPTHWISE_CONV_2D"):
            w = tensor_np(ins[1])           # OHWI (conv) / 1HWO (dw)
            b = tensor_np(ins[2]) if len(ins) > 2 and ins[2] >= 0 else None
            pad_mode = opts.scalar(0, "b", 0) if opts else 0   # 0=SAME
            sw = opts.scalar(1, "i", 1) if opts else 1
            sh = opts.scalar(2, "i", 1) if opts else 1
            if code == "CONV_2D":
                act = _act_suffix(opts.scalar(3, "b", 0) if opts else 0)
                dw_ = opts.scalar(4, "i", 1) if opts else 1
                dh_ = opts.scalar(5, "i", 1) if opts else 1
                wn = np.transpose(w, (0, 3, 1, 2))   # OHWI -> OIHW
                group = 1
            else:
                act = _act_suffix(opts.scalar(4, "b", 0) if opts else 0)
                dw_ = opts.scalar(5, "i", 1) if opts else 1
                dh_ = opts.scalar(6, "i", 1) if opts else 1
                # 1HWO -> (O)(1)HW depthwise: group = input channels
                o = w.shape[3]
                wn = np.transpose(w, (3, 0, 1, 2))   # O,1,H,W
                group = o // max(opts.scalar(3, "i", 1) if opts else 1, 1)
            wname = f"W{oi}"
            gb.init(wname, wn.astype(np.float32))
            inputs = [src(ins[0]), wname]
            if b is not None:
                bname = f"B{oi}"
                gb.init(bname, b.astype(np.float32))
                inputs.append(bname)
            kh, kw = wn.shape[2], wn.shape[3]
            attrs = dict(strides=[sh, sw], dilations=[dh_, dw_],
                         group=group, kernel_shape=[kh, kw])
            if pad_mode == 0:
                attrs["auto_pad"] = "SAME_UPPER"
            else:
                attrs["pads"] = [0, 0, 0, 0]
            tgt = out_name if act is None else out_name + "_conv"
            gb.node("Conv", inputs, [tgt], **attrs)
            fused(tgt, act, out_name)

        elif code in ("AVERAGE_POOL_2D", "MAX_POOL_2D"):
            pad_mode = opts.scalar(0, "b", 0) if opts else 0
            sw = opts.scalar(1, "i", 1) if opts else 1
            sh = opts.scalar(2, "i", 1) if opts else 1
            fw = opts.scalar(3, "i", 1) if opts else 1
            fh = opts.scalar(4, "i", 1) if opts else 1
            act = _act_suffix(opts.scalar(5, "b", 0) if opts else 0)
            kind = "AveragePool" if code == "AVERAGE_POOL_2D" else "MaxPool"
            attrs = dict(kernel_shape=[fh, fw], strides=[sh, sw])
            if pad_mode == 0:
                attrs["auto_pad"] = "SAME_UPPER"
            tgt = out_name if act is None else out_name + "_pool"
            gb.node(kind, [src(ins[0])], [tgt], **attrs)
            fused(tgt, act, out_name)

        elif code == "FULLY_CONNECTED":
            w = tensor_np(ins[1])            # (out, in)
            b = tensor_np(ins[2]) if len(ins) > 2 and ins[2] >= 0 else None
            act = _act_suffix(opts.scalar(0, "b", 0) if opts else 0)
            wname = f"W{oi}"
            gb.init(wname, w.astype(np.float32))
            flat = out_name + "_flat"
            gb.node("Flatten", [src(ins[0])], [flat], axis=1)
            inputs = [flat, wname]
            if b is not None:
                bname = f"B{oi}"
                gb.init(bname, b.astype(np.float32))
                inputs.append(bname)
            tgt = out_name if act is None else out_name + "_fc"
            gb.node("Gemm", inputs, [tgt], transB=1)
            fused(tgt, act, out_name)

        elif code in ("ADD", "SUB", "MUL", "DIV", "MAXIMUM", "MINIMUM",
                      "POW"):
            onnx_op = {"ADD": "Add", "SUB": "Sub", "MUL": "Mul",
                       "DIV": "Div", "MAXIMUM": "Max", "MINIMUM": "Min",
                       "POW": "Pow"}[code]
            act = _act_suffix(opts.scalar(0, "b", 0)
                              if opts and code in ("ADD", "SUB", "MUL",
                                                   "DIV") else 0)
            a_in, b_in = src(ins[0]), src(ins[1])
            # broadcast constants arrive NHWC; executor runs NCHW
            for t_i, nm in ((ins[0], a_in), (ins[1], b_in)):
                if t_i in const and const[t_i].ndim == 4:
                    arr = np.transpose(const[t_i], (0, 3, 1, 2))
                    gb.init(nm, arr.astype(np.float32))
            tgt = out_name if act is None else out_name + "_bin"
            gb.node(onnx_op, [a_in, b_in], [tgt])
            fused(tgt, act, out_name)

        elif code == "RELU":
            gb.node("Relu", [src(ins[0])], [out_name])
        elif code == "RELU6":
            gb.node("Clip", [src(ins[0])], [out_name], min=0.0, max=6.0)
        elif code == "LOGISTIC":
            gb.node("Sigmoid", [src(ins[0])], [out_name])
        elif code == "TANH":
            gb.node("Tanh", [src(ins[0])], [out_name])
        elif code == "EXP":
            gb.node("Exp", [src(ins[0])], [out_name])
        elif code == "HARD_SWISH":
            # y = x * relu6(x + 3) / 6
            mid = out_name + "_hs"
            gb.init(mid + "_3", np.float32(3.0).reshape(()))
            gb.init(mid + "_6", np.float32(6.0).reshape(()))
            gb.node("Add", [src(ins[0]), mid + "_3"], [mid + "a"])
            gb.node("Clip", [mid + "a"], [mid + "c"], min=0.0, max=6.0)
            gb.node("Mul", [src(ins[0]), mid + "c"], [mid + "m"])
            gb.node("Div", [mid + "m", mid + "_6"], [out_name])
        elif code == "SOFTMAX":
            gb.node("Softmax", [src(ins[0])], [out_name], axis=1)
        elif code == "RESHAPE":
            if len(ins) > 1 and ins[1] >= 0:
                shape = tensor_np(ins[1])
            else:
                shape = opts.vector_np(0, np.int32) if opts else None
            shape = np.asarray(shape, np.int64)
            # activations run NCHW internally but TFLite reshape semantics
            # are NHWC element order: restore NHWC, reshape, re-permute
            # (tflite_importer.cpp parseReshape layout handling)
            in_rank = tensors[ins[0]].vector_len(0)
            src_name = src(ins[0])
            if in_rank == 4 and ins[0] not in const:
                gb.node("Transpose", [src_name], [out_name + "_nhwc"],
                        perm=[0, 2, 3, 1])
                src_name = out_name + "_nhwc"
            sname = f"S{oi}"
            gb.init(sname, shape)
            if shape.size == 4:
                gb.node("Reshape", [src_name, sname], [out_name + "_r"])
                gb.node("Transpose", [out_name + "_r"], [out_name],
                        perm=[0, 3, 1, 2])
            else:
                gb.node("Reshape", [src_name, sname], [out_name])
        elif code == "MEAN":
            axes = tensor_np(ins[1]).tolist()
            keep = opts.scalar(0, "b", 0) if opts else 0
            if sorted(axes) == [1, 2]:   # NHWC spatial mean == NCHW (2, 3)
                if keep:  # GlobalAveragePool keeps (N, C, 1, 1)
                    gb.node("GlobalAveragePool", [src(ins[0])], [out_name])
                else:
                    gb.node("GlobalAveragePool", [src(ins[0])],
                            [out_name + "_gap"])
                    gb.node("Flatten", [out_name + "_gap"], [out_name],
                            axis=1)
            else:
                raise NotImplementedError(f"MEAN over axes {axes}")
        elif code == "PAD":
            pads = tensor_np(ins[1])  # (rank, 2) NHWC
            p = np.asarray(pads, np.int64)
            if p.shape[0] == 4:
                p = p[[0, 3, 1, 2]]
            onnx_pads = np.concatenate([p[:, 0], p[:, 1]])
            pname = f"P{oi}"
            gb.init(pname, onnx_pads)
            gb.node("Pad", [src(ins[0]), pname], [out_name])
        elif code == "CONCATENATION":
            axis = opts.scalar(0, "i", 0) if opts else 0
            if axis in (3, -1):
                axis = 1
            elif axis == 1:
                axis = 2
            elif axis == 2:
                axis = 3
            gb.node("Concat", [src(i) for i in ins], [out_name], axis=axis)
        elif code in ("DEQUANTIZE", "FAKE_QUANT"):
            arr = tensor_np(ins[0])
            if arr is not None and arr.dtype == np.float16:
                const[outs[0]] = arr.astype(np.float32)
                gb.init(out_name, arr.astype(np.float32))
            else:
                gb.node("Identity", [src(ins[0])], [out_name])
        else:
            raise NotImplementedError(f"TFLite op {code} not yet mapped")

    for ti in sg_outputs:
        gb.output(tname(ti))
    return Net(gb.model, device)
