"""Darknet importer (modules/dnn/src/darknet/darknet_io.cpp).

Parses the .cfg ini-style layer list and the raw float32 .weights stream
(header: 3x int32 version + seen counter, then per conv/connected layer
bias, [bn scale/mean/var], weights — darknet_io.cpp:973-1090) and emits
the internal ONNX-graph representation executed by dnn.Net, so darknet
models (YOLOv2/v3/v4, tiny variants) run through the same executor
as every other framework.  The JAX package's reader, copied onto the
port's graph builder.  Region/Reorg decode steps become dedicated
graph ops evaluated by the executor (region_layer.cpp, reorg_layer.cpp).
"""

from __future__ import annotations

import numpy as np

from .importers import _GraphBuilder

__all__ = ["readNetFromDarknet"]


def _parse_cfg(text):
    sections = []
    cur = None
    for raw in text.splitlines():
        line = raw.split("#")[0].split(";")[0].strip()
        if not line:
            continue
        if line.startswith("["):
            cur = (line.strip("[] ").lower(), {})
            sections.append(cur)
        elif "=" in line and cur is not None:
            k, v = line.split("=", 1)
            cur[1][k.strip()] = v.strip()
    return sections


def _ints(s):
    return [int(v) for v in s.replace(",", " ").split()]


def _floats(s):
    return [float(v) for v in s.replace(",", " ").split()]


class _WeightReader:
    def __init__(self, path):
        self.buf = open(path, "rb").read()
        major, minor, _rev = np.frombuffer(self.buf[:12], np.int32)
        self.off = 12 + (8 if major * 10 + minor >= 2 else 4)
        self.transpose = major > 1000 or minor > 1000

    def read(self, n):
        a = np.frombuffer(self.buf, np.float32, n, self.off)
        self.off += 4 * n
        return np.array(a)


def readNetFromDarknet(cfgFile, darknetModel=None, device=None):
    """The net of a Darknet .cfg and its .weights (none: zero weights and no
    batch norm) on `device` ("cuda" unless asked)."""
    from . import Net

    cfg = _parse_cfg(open(cfgFile).read())
    assert cfg and cfg[0][0] in ("net", "network"), "cfg must start [net]"
    net_p = cfg[0][1]
    in_c = int(net_p.get("channels", 3))
    in_h = int(net_p.get("height", 416))
    in_w = int(net_p.get("width", 416))

    w = _WeightReader(darknetModel) if darknetModel else None

    b = _GraphBuilder("darknet")
    b.input("data")
    vi = b.g.input[0]
    for d in (1, in_c, in_h, in_w):
        vi.type.tensor_type.shape.dim.add().dim_value = d

    outs = []          # per-darknet-layer output tensor name
    chans = []         # per-darknet-layer output channels
    cur = "data"
    cur_c = in_c
    n_out = [0]
    final_outputs = []

    def act_of(params, name, idx):
        a = params.get("activation", "linear")
        if a == "linear":
            return name
        out = f"act{idx}"
        if a == "leaky":
            b.node("LeakyRelu", [name], [out], alpha=0.1)
        elif a in ("mish",):
            b.node("Mish", [name], [out])
        elif a in ("swish", "silu"):
            b.node("Swish", [name], [out])
        elif a in ("logistic", "sigmoid"):
            b.node("Sigmoid", [name], [out])
        elif a == "relu":
            b.node("Relu", [name], [out])
        else:
            raise NotImplementedError(f"darknet activation {a}")
        return out

    for li, (kind, p) in enumerate(cfg[1:]):
        name = f"l{li}"
        if kind == "convolutional":
            size = int(p.get("size", 1))
            stride = int(p.get("stride", 1))
            pad = int(p.get("padding", size // 2 if int(p.get("pad", 0))
                            else 0))
            filters = int(p["filters"])
            groups = int(p.get("groups", 1))
            bn = int(p.get("batch_normalize", 0)) == 1
            wname = f"{name}_w"
            conv_in = [cur, wname]
            if w is not None:
                bias = w.read(filters)
                if bn:
                    scale = w.read(filters)
                    mean = w.read(filters)
                    var = w.read(filters)
                kern = w.read(filters * (cur_c // groups) * size * size) \
                    .reshape(filters, cur_c // groups, size, size)
                b.init(wname, kern)
                if not bn:
                    b.init(f"{name}_b", bias)
                    conv_in.append(f"{name}_b")
            else:
                b.init(wname, np.zeros(
                    (filters, cur_c // groups, size, size), np.float32))
                bn = False
            cname = f"{name}_conv"
            b.node("Conv", conv_in, [cname], kernel_shape=[size, size],
                   strides=[stride, stride], pads=[pad, pad, pad, pad],
                   group=groups)
            if bn:
                for nm, arr in (("g", scale), ("bb", bias), ("m", mean),
                                ("v", var)):
                    b.init(f"{name}_{nm}", arr)
                b.node("BatchNormalization",
                       [cname, f"{name}_g", f"{name}_bb", f"{name}_m",
                        f"{name}_v"], [f"{name}_bn"], epsilon=1e-6)
                cname = f"{name}_bn"
            cur = act_of(p, cname, li)
            cur_c = filters
        elif kind == "connected":
            # darknet [connected] needs static whole-net shape tracking
            # to size its weight matrix; not used by the YOLO family.
            raise NotImplementedError("darknet [connected] layer")
        elif kind == "maxpool":
            size = int(p.get("size", 2))
            stride = int(p.get("stride", 2))
            padding = int(p.get("padding", size - 1))
            p0 = padding // 2
            p1 = padding - p0
            b.node("MaxPool", [cur], [name], kernel_shape=[size, size],
                   strides=[stride, stride], pads=[p0, p0, p1, p1])
            cur = name
        elif kind == "avgpool":
            b.node("GlobalAveragePool", [cur], [name])
            cur = name
        elif kind == "route":
            layers = _ints(p["layers"])
            refs = [outs[v if v >= 0 else li + v] for v in layers]
            ref_c = [chans[v if v >= 0 else li + v] for v in layers]
            groups = int(p.get("groups", 1))
            if len(refs) == 1 and groups == 1:
                b.node("Identity", refs, [name])
                cur_c = ref_c[0]
            elif len(refs) == 1:
                gid = int(p.get("group_id", 0))
                gsz = ref_c[0] // groups
                b.init(f"{name}_st", np.asarray([gid * gsz], np.int64))
                b.init(f"{name}_en",
                       np.asarray([(gid + 1) * gsz], np.int64))
                b.init(f"{name}_ax", np.asarray([1], np.int64))
                b.node("Slice",
                       [refs[0], f"{name}_st", f"{name}_en", f"{name}_ax"],
                       [name])
                cur_c = gsz
            else:
                b.node("Concat", refs, [name], axis=1)
                cur_c = sum(ref_c)
            cur = name
        elif kind == "shortcut":
            frm = int(p["from"])
            ref = outs[frm if frm >= 0 else li + frm]
            b.node("Add", [cur, ref], [f"{name}_add"])
            cur = act_of(p, f"{name}_add", li)
        elif kind == "scale_channels":
            frm = int(p["from"])
            ref = outs[frm if frm >= 0 else li + frm]
            b.node("Mul", [cur, ref], [name])
            cur = name
        elif kind == "sam":
            frm = int(p["from"])
            ref = outs[frm if frm >= 0 else li + frm]
            b.node("Mul", [cur, ref], [name])
            cur = name
        elif kind == "upsample":
            s = int(p.get("stride", 2))
            b.init(f"{name}_s", np.asarray([1, 1, s, s], np.float32))
            b.node("Resize", [cur, "", f"{name}_s"], [name],
                   mode="nearest")
            cur = name
        elif kind == "reorg":
            s = int(p.get("stride", 2))
            b.node("Reorg", [cur], [name], stride=s)
            cur = name
            cur_c = cur_c * s * s
        elif kind in ("yolo", "region"):
            is_yolo = kind == "yolo"
            classes = int(p.get("classes", 20 if not is_yolo else 80))
            if is_yolo:
                mask = _ints(p.get("mask", "0"))
                anchors = _floats(p.get("anchors", ""))
                used = []
                for m in mask:
                    used += [anchors[2 * m], anchors[2 * m + 1]]
                n_anch = len(mask)
            else:
                used = _floats(p.get("anchors", ""))
                n_anch = int(p.get("num", 5))
                used = used[:2 * n_anch] or [1.0] * (2 * n_anch)
            b.node("Transpose", [cur], [f"{name}_pm"],
                   perm=[0, 2, 3, 1])
            b.init(f"{name}_anch", np.asarray(used, np.float32))
            rin = [f"{name}_pm", f"{name}_anch"]
            if is_yolo:
                rin.append("data")     # norm by net input (darknet_io.cpp:550)
            b.node("Region", rin, [name],
                   classes=classes, anchors=n_anch,
                   logistic=1 if is_yolo else 0,
                   softmax=int(p.get("softmax", 0)) if not is_yolo else 0,
                   thresh=float(p.get("thresh", 0.2)),
                   scale_x_y=float(p.get("scale_x_y", 1.0)),
                   new_coords=int(p.get("new_coords", 0)),
                   classfix=int(p.get("classfix", 0)))
            cur = name
            final_outputs.append(name)
        elif kind in ("dropout", "cost"):
            b.node("Identity", [cur], [name])
            cur = name
        elif kind == "softmax":
            b.node("Softmax", [cur], [name], axis=1)
            cur = name
        else:
            raise NotImplementedError(f"darknet layer [{kind}]")
        outs.append(cur)
        chans.append(cur_c)

    if not final_outputs:
        final_outputs = [cur]
    for o in final_outputs:
        b.output(o)
    return Net(b.model, device)
