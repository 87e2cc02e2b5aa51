"""Extended ONNX operator set for the dnn executor — the port of
``opencv_tpu/dnn/onnx_ops.py``.

Each operator is an eager torch expression on the net's device, registered
in `OPS` and dispatched from ``Net.forward``.  The integer operators
(QLinearConv, QLinearMatMul, MatMulInteger, ConvInteger) accumulate in f64,
which holds every int32 sum of int8 products exactly (up to 2^53), and wrap
to int32 as ONNX's int32 accumulation does.

Values reach an operator as torch tensors or, for shape plumbing and
initializers, numpy arrays; ``_a`` puts a value on the device (an
initializer once per net, through the net's cache), ``_np`` reads one back.
"""

from __future__ import annotations

import contextlib
import math
import os
import threading

import numpy as np
import torch
import torch.nn.functional as F

OPS = {}

_CTX = threading.local()


@contextlib.contextmanager
def computing_on(device, cache=None, keep=()):
    """Within the block, ``_a`` makes tensors on `device`; `cache` (a
    dict) keeps the device copy of each array whose id is in `keep` (a
    net's initializers), made once."""
    prev = getattr(_CTX, "state", None)
    _CTX.state = (torch.device(device), cache, keep)
    try:
        yield
    finally:
        _CTX.state = prev


def _device():
    st = getattr(_CTX, "state", None)
    return st[0] if st is not None else torch.device("cpu")


def _to_tensor(v, dev):
    a = np.asarray(v)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.uint16:
        a = a.astype(np.int32)
    elif a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a, copy=not a.flags.writeable or None, order="C")).to(dev)


def _a(v):
    """v as a tensor on the computing device."""
    st = getattr(_CTX, "state", None)
    dev, cache, keep = st if st is not None else (torch.device("cpu"), None, ())
    if isinstance(v, torch.Tensor):
        return v if v.device == dev else v.to(dev)
    if cache is not None and isinstance(v, np.ndarray) and id(v) in keep:
        hit = cache.get(id(v))
        if hit is not None and hit[0] is v:
            return hit[1]
        t = _to_tensor(v, dev)
        cache[id(v)] = (v, t)
        return t
    return _to_tensor(v, dev)


def _np(v):
    """v as a numpy array on the host."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def op(*names):
    def deco(fn):
        for n in names:
            OPS[n] = fn
        return fn
    return deco


def _axes_arg(ins, at, idx=1):
    axes = at.get("axes")
    if axes is None and len(ins) > idx and ins[idx] is not None:
        axes = [int(v) for v in _np(ins[idx]).ravel()]
    return tuple(axes) if axes else None


# ------------------------------------------------------------ elementwise

def _unary(name, fn):
    OPS[name] = lambda ins, at: fn(_a(ins[0]))


for _name, _fn in (("Neg", torch.neg), ("Abs", torch.abs), ("Floor", torch.floor),
                   ("Ceil", torch.ceil), ("Round", torch.round),   # half to even, as the spec
                   ("Reciprocal", lambda x: 1.0 / x), ("Log", torch.log),
                   ("Sign", torch.sign), ("Sin", torch.sin), ("Cos", torch.cos),
                   ("Tan", torch.tan), ("Asin", torch.asin), ("Acos", torch.acos),
                   ("Atan", torch.atan), ("Sinh", torch.sinh), ("Cosh", torch.cosh),
                   ("Atanh", torch.atanh), ("Asinh", torch.asinh), ("Acosh", torch.acosh)):
    _unary(_name, _fn)


@op("Mod")
def _mod(ins, at):
    x, y = _a(ins[0]), _a(ins[1])
    if at.get("fmod", 0):
        return torch.fmod(x, y)
    return torch.remainder(x, y)


@op("Not")
def _not(ins, at):
    return ~_a(ins[0]).to(torch.bool)


@op("And")
def _and(ins, at):
    return _a(ins[0]).to(torch.bool) & _a(ins[1]).to(torch.bool)


@op("Or")
def _or(ins, at):
    return _a(ins[0]).to(torch.bool) | _a(ins[1]).to(torch.bool)


@op("Xor")
def _xor(ins, at):
    return _a(ins[0]).to(torch.bool) ^ _a(ins[1]).to(torch.bool)


@op("Equal")
def _eq(ins, at):
    return _a(ins[0]) == _a(ins[1])


@op("Greater")
def _gt(ins, at):
    return _a(ins[0]) > _a(ins[1])


@op("GreaterOrEqual")
def _ge(ins, at):
    return _a(ins[0]) >= _a(ins[1])


@op("Less")
def _lt(ins, at):
    return _a(ins[0]) < _a(ins[1])


@op("LessOrEqual")
def _le(ins, at):
    return _a(ins[0]) <= _a(ins[1])


@op("Where")
def _where(ins, at):
    return torch.where(_a(ins[0]).to(torch.bool), _a(ins[1]), _a(ins[2]))


# ------------------------------------------------------------ activations

@op("PRelu")
def _prelu(ins, at):
    x = _a(ins[0])
    s = _a(ins[1])
    if s.ndim and s.ndim < x.ndim:
        s = s.reshape((1, -1) + (1,) * (x.ndim - 2))
    return torch.where(x >= 0, x, x * s)


@op("Elu")
def _elu(ins, at):
    alpha = at.get("alpha", 1.0)
    x = _a(ins[0])
    return torch.where(x >= 0, x, alpha * (torch.exp(x) - 1))


@op("Selu")
def _selu(ins, at):
    alpha = at.get("alpha", 1.6732632423543772)
    gamma = at.get("gamma", 1.0507009873554805)
    x = _a(ins[0])
    return gamma * torch.where(x >= 0, x, alpha * (torch.exp(x) - 1))


@op("Celu")
def _celu(ins, at):
    alpha = at.get("alpha", 1.0)
    x = _a(ins[0])
    return torch.clamp(x, min=0) + torch.clamp(alpha * (torch.exp(x / alpha) - 1), max=0)


@op("HardSigmoid")
def _hardsigmoid(ins, at):
    alpha = at.get("alpha", 0.2)
    beta = at.get("beta", 0.5)
    return torch.clamp(alpha * _a(ins[0]) + beta, 0, 1)


@op("HardSwish")
def _hardswish(ins, at):
    x = _a(ins[0])
    return x * torch.clamp(x / 6.0 + 0.5, 0, 1)


@op("Softsign")
def _softsign(ins, at):
    x = _a(ins[0])
    return x / (1 + torch.abs(x))


@op("ThresholdedRelu")
def _threlu(ins, at):
    alpha = at.get("alpha", 1.0)
    x = _a(ins[0])
    return torch.where(x > alpha, x, torch.zeros_like(x))


@op("Gelu")
def _gelu(ins, at):
    approx = at.get("approximate", "none")
    return F.gelu(_a(ins[0]), approximate="tanh" if approx == "tanh" else "none")


@op("LogSoftmax")
def _logsoftmax(ins, at):
    return torch.log_softmax(_a(ins[0]), dim=at.get("axis", -1))


# -------------------------------------------------------------- reductions

def _prod(x, dim=None, keepdim=False):
    if dim is None:
        return torch.prod(x.reshape(-1)).reshape((1,) * x.ndim if keepdim else ())
    for d in sorted((d % x.ndim for d in dim), reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _sum(x, dim=None, keepdim=False):
    if dim is None:
        return torch.sum(x).reshape((1,) * x.ndim if keepdim else ())
    return torch.sum(x, dim=dim, keepdim=keepdim)


def _amax(x, dim=None, keepdim=False):
    if dim is None:
        return torch.amax(x).reshape((1,) * x.ndim if keepdim else ())
    return torch.amax(x, dim=dim, keepdim=keepdim)


def _amin(x, dim=None, keepdim=False):
    if dim is None:
        return torch.amin(x).reshape((1,) * x.ndim if keepdim else ())
    return torch.amin(x, dim=dim, keepdim=keepdim)


def _reduce(fn, ins, at):
    axes = _axes_arg(ins, at)
    keep = bool(at.get("keepdims", 1))
    if axes is None and at.get("noop_with_empty_axes", 0) \
            and len(ins) > 1 and ins[1] is None:
        return _a(ins[0])
    return fn(_a(ins[0]), dim=axes, keepdim=keep)


@op("ReduceSum")
def _rsum(ins, at):
    return _reduce(_sum, ins, at)


@op("ReduceMax")
def _rmax(ins, at):
    return _reduce(_amax, ins, at)


@op("ReduceMin")
def _rmin(ins, at):
    return _reduce(_amin, ins, at)


@op("ReduceProd")
def _rprod(ins, at):
    return _reduce(_prod, ins, at)


@op("ReduceL2")
def _rl2(ins, at):
    return torch.sqrt(_reduce(_sum, [_a(ins[0]) ** 2] + list(ins[1:]), at))


@op("ReduceL1")
def _rl1(ins, at):
    return _reduce(_sum, [torch.abs(_a(ins[0]))] + list(ins[1:]), at)


@op("ReduceSumSquare")
def _rss(ins, at):
    return _reduce(_sum, [_a(ins[0]) ** 2] + list(ins[1:]), at)


@op("ReduceLogSum")
def _rls(ins, at):
    return torch.log(_reduce(_sum, ins, at))


@op("ReduceLogSumExp")
def _rlse(ins, at):
    return torch.log(_reduce(_sum, [torch.exp(_a(ins[0]))] + list(ins[1:]), at))


@op("ArgMax")
def _argmax(ins, at):
    ax = at.get("axis", 0)
    keep = bool(at.get("keepdims", 1))
    return torch.argmax(_a(ins[0]), dim=ax, keepdim=keep)


@op("ArgMin")
def _argmin(ins, at):
    ax = at.get("axis", 0)
    keep = bool(at.get("keepdims", 1))
    return torch.argmin(_a(ins[0]), dim=ax, keepdim=keep)


@op("CumSum")
def _cumsum(ins, at):
    ax = int(_np(ins[1]))
    x = _a(ins[0])
    if at.get("reverse", 0):
        x = torch.flip(x, (ax,))
    y = torch.cumsum(x, dim=ax)
    if at.get("exclusive", 0):
        y = torch.roll(y, 1, ax)
        idx = [slice(None)] * y.ndim
        idx[ax] = 0
        y[tuple(idx)] = 0
    if at.get("reverse", 0):
        y = torch.flip(y, (ax,))
    return y


def _total_order(v):
    """An integer key that orders floats as XLA's sort does (-0 below +0,
    NaN above +inf); integers are their own key."""
    if not v.is_floating_point():
        return v
    b = v.to(torch.float32).view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


@op("TopK")
def _topk(ins, at):
    """``lax.top_k``: sorted in XLA's total order, ties to the lower index
    (a stable sort)."""
    k = int(_np(ins[1]).ravel()[0])
    ax = at.get("axis", -1)
    largest = at.get("largest", 1)
    x = _a(ins[0])
    xs = torch.movedim(x, ax, -1)
    key = xs if largest else -xs
    i = torch.sort(_total_order(key), dim=-1, descending=True, stable=True).indices[..., :k]
    v = torch.gather(xs, -1, i)
    return (torch.movedim(v, -1, ax), torch.movedim(i, -1, ax))


# ----------------------------------------------------------- shape/layout

@op("Split")
def _split(ins, at):
    x = _a(ins[0])
    ax = at.get("axis", 0)
    split = at.get("split")
    if split is None and len(ins) > 1 and ins[1] is not None:
        split = [int(v) for v in _np(ins[1]).ravel()]
    if split is None:
        n = at.get("num_outputs", 2)
        sz = (x.shape[ax] + n - 1) // n
        split = [min(sz, x.shape[ax] - i * sz) for i in range(n)]
    return tuple(torch.split(x, list(split), dim=ax))


@op("Expand")
def _expand(ins, at):
    shape = [int(v) for v in _np(ins[1]).ravel()]
    x = _a(ins[0])
    return x * torch.ones(shape, dtype=x.dtype, device=x.device)


@op("Range")
def _range(ins, at):
    s, e, d = (_np(v).ravel()[0].item() for v in ins[:3])
    return torch.arange(s, e, d, device=_device())


@op("DepthToSpace")
def _d2s(ins, at):
    x = _a(ins[0])
    b = at["blocksize"]
    N, C, H, W = x.shape
    if at.get("mode", "DCR") == "DCR":
        t = x.reshape(N, b, b, C // (b * b), H, W)
        t = t.permute(0, 3, 4, 1, 5, 2)
    else:
        t = x.reshape(N, C // (b * b), b, b, H, W)
        t = t.permute(0, 1, 4, 2, 5, 3)
    return t.reshape(N, C // (b * b), H * b, W * b)


@op("SpaceToDepth")
def _s2d(ins, at):
    x = _a(ins[0])
    b = at["blocksize"]
    N, C, H, W = x.shape
    t = x.reshape(N, C, H // b, b, W // b, b)
    t = t.permute(0, 3, 5, 1, 2, 4)
    return t.reshape(N, C * b * b, H // b, W // b)


@op("GatherElements")
def _gather_el(ins, at):
    x = _a(ins[0])
    ax = at.get("axis", 0)
    idx = _a(_np(ins[1]).astype(np.int64))
    idx = torch.where(idx < 0, idx + x.shape[ax], idx)
    return torch.gather(x, ax, idx)


@op("GatherND")
def _gather_nd(ins, at):
    x = _a(ins[0])
    idx = _np(ins[1]).astype(np.int64)
    b = at.get("batch_dims", 0)
    assert b == 0, "GatherND batch_dims>0 unsupported"
    return x[tuple(torch.as_tensor(i, device=x.device) for i in np.moveaxis(idx, -1, 0))]


@op("ScatterND")
def _scatter_nd(ins, at):
    x = _a(ins[0]).clone()
    idx = _np(ins[1]).astype(np.int64)
    x[tuple(torch.as_tensor(i, device=x.device) for i in np.moveaxis(idx, -1, 0))] = _a(ins[2])
    return x


@op("OneHot")
def _onehot(ins, at):
    idx = _np(ins[0]).astype(np.int64)
    depth = int(_np(ins[1]).ravel()[0])
    vals = _np(ins[2]).ravel()
    ax = at.get("axis", -1)
    # ONNX: indices in [-depth, depth-1] (negatives wrap once); anything
    # outside produces an all-off_value row
    valid = (idx >= -depth) & (idx < depth)
    norm = np.where(valid, np.where(idx < 0, idx + depth, idx), depth)
    oh = F.one_hot(torch.as_tensor(norm, device=_device()), depth + 1)[..., :depth]
    oh = torch.movedim(oh.to(torch.float32), -1, ax if ax >= 0 else oh.ndim + ax)
    on, off = _a(vals[1:2])[0], _a(vals[0:1])[0]
    return oh * (on - off) + off


@op("Trilu")
def _trilu(ins, at):
    x = _a(ins[0])
    k = int(_np(ins[1]).ravel()[0]) if len(ins) > 1 and \
        ins[1] is not None else 0
    if at.get("upper", 1):
        return torch.triu(x, k)
    return torch.tril(x, k)


@op("Einsum")
def _einsum(ins, at):
    return torch.einsum(at["equation"], *[_a(v) for v in ins])


@op("Attention")
def _attention(ins, at):
    """Two dialects, both used by the reference stack:
    - com.microsoft fused-QKV (dnn/src/layers/attention_layer.cpp):
      inputs (x[B,S,Hin], W[Hin,q+k+v], bias) with qkv_hidden_sizes;
      the effective score multiplier is 1/attr_scale, attr default
      sqrt(q_head_size);
    - ONNX opset-23 (the 5.0 wheel): inputs (Q, K, V[, mask]) as 4-D
      (B, heads, S, D) or 3-D (B, S, hidden) + q_num_heads/kv_num_heads,
      multiplier = attr scale, default 1/sqrt(head_size)."""
    if len(ins) >= 3 and _a(ins[1]).ndim == 2 and "qkv_hidden_sizes" in at:
        x = _a(ins[0]).to(torch.float32)        # (B, S, Hin)
        W = _a(ins[1]).to(torch.float32)        # (Hin, q+k+v)
        b = _a(ins[2]).to(torch.float32)
        nh = int(at["num_heads"])
        qkv = [int(v) for v in at["qkv_hidden_sizes"]]
        qh = qkv[0] // nh
        vh = (W.shape[1] - qkv[0] - qkv[1]) // nh
        scale = 1.0 / float(at.get("scale", math.sqrt(qh)))
        B, S, _ = x.shape
        g = x @ W + b
        q = g[..., :qkv[0]].reshape(B, S, nh, qh).permute(0, 2, 1, 3)
        k = g[..., qkv[0]:qkv[0] + qkv[1]].reshape(B, S, nh, qh).permute(0, 2, 1, 3)
        v = g[..., qkv[0] + qkv[1]:].reshape(B, S, nh, vh).permute(0, 2, 1, 3)
    else:
        q = _a(ins[0]).to(torch.float32)
        k = _a(ins[1]).to(torch.float32)
        v = _a(ins[2]).to(torch.float32)
        if q.ndim == 3:
            B, S, Hq = q.shape
            nh = int(at.get("q_num_heads", 1))
            knh = int(at.get("kv_num_heads", nh))
            q = q.reshape(B, S, nh, Hq // nh).permute(0, 2, 1, 3)
            k = k.reshape(B, k.shape[1], knh, -1).permute(0, 2, 1, 3)
            v = v.reshape(B, v.shape[1], knh, -1).permute(0, 2, 1, 3)
        nh = q.shape[1]
        qh = q.shape[3]
        B, S = q.shape[0], q.shape[2]
        if k.shape[1] != nh:      # grouped-query: repeat kv heads
            rep = nh // k.shape[1]
            k = torch.repeat_interleave(k, rep, dim=1)
            v = torch.repeat_interleave(v, rep, dim=1)
        scale = float(at.get("scale", 1.0 / math.sqrt(qh)))

    scores = torch.einsum("bhsd,bhtd->bhst", q, k) * np.float32(scale).item()
    if len(ins) > 3 and ins[3] is not None:
        mask = _a(ins[3])
        if mask.dtype == torch.bool:
            scores = torch.where(mask, scores, torch.full_like(scores, -float("inf")))
        else:
            scores = scores + mask.to(torch.float32)
    if int(at.get("is_causal", 0)):
        T = scores.shape[-1]
        causal = torch.tril(torch.ones((scores.shape[-2], T), dtype=torch.bool,
                                       device=scores.device))
        scores = torch.where(causal, scores, torch.full_like(scores, -float("inf")))
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhst,bhtd->bhsd", p, v)
    if "qkv_hidden_sizes" in at:
        o = o.permute(0, 2, 1, 3).reshape(B, S, -1)
        if int(at.get("output_ndims", 3)) == 2:
            o = o.reshape(B * S, -1)
    elif _a(ins[0]).ndim == 3:
        o = o.permute(0, 2, 1, 3).reshape(B, S, -1)
    return o


# ---------------------------------------------------------- normalization

def _var(x, axes):
    return torch.var(x, dim=axes, correction=0, keepdim=True)


@op("InstanceNormalization")
def _instnorm(ins, at):
    x = _a(ins[0])
    g = _a(ins[1]).reshape((1, -1) + (1,) * (x.ndim - 2))
    b = _a(ins[2]).reshape((1, -1) + (1,) * (x.ndim - 2))
    axes = tuple(range(2, x.ndim))
    mu = torch.mean(x, dim=axes, keepdim=True)
    var = _var(x, axes)
    return (x - mu) / torch.sqrt(var + at.get("epsilon", 1e-5)) * g + b


@op("LayerNormalization")
def _layernorm(ins, at):
    x = _a(ins[0])
    ax = at.get("axis", -1)
    axes = tuple(range(ax % x.ndim, x.ndim))
    mu = torch.mean(x, dim=axes, keepdim=True)
    var = _var(x, axes)
    y = (x - mu) / torch.sqrt(var + at.get("epsilon", 1e-5))
    y = y * _a(ins[1])
    if len(ins) > 2 and ins[2] is not None:
        y = y + _a(ins[2])
    return y


@op("GroupNormalization")
def _groupnorm(ins, at):
    x = _a(ins[0])
    G = at["num_groups"]
    N, C = x.shape[:2]
    g = _a(ins[1]).reshape((1, -1) + (1,) * (x.ndim - 2))
    b = _a(ins[2]).reshape((1, -1) + (1,) * (x.ndim - 2))
    t = x.reshape((N, G, C // G) + tuple(x.shape[2:]))
    axes = tuple(range(2, t.ndim))
    mu = torch.mean(t, dim=axes, keepdim=True)
    var = _var(t, axes)
    t = (t - mu) / torch.sqrt(var + at.get("epsilon", 1e-5))
    return t.reshape(x.shape) * g + b


@op("LpNormalization")
def _lpnorm(ins, at):
    x = _a(ins[0])
    ax = at.get("axis", -1)
    p = at.get("p", 2)
    if p == 1:
        n = torch.sum(torch.abs(x), dim=ax, keepdim=True)
    else:
        n = torch.sqrt(torch.sum(x * x, dim=ax, keepdim=True))
    return x / n


@op("MeanVarianceNormalization")
def _mvn(ins, at):
    x = _a(ins[0])
    axes = tuple(at.get("axes", [0, 2, 3]))
    mu = torch.mean(x, dim=axes, keepdim=True)
    sd = torch.sqrt(_var(x, axes))
    return (x - mu) / (sd + 1e-9)


# ------------------------------------------------------------ conv family

def _dilate_pad(x, strides, pad_h, pad_w):
    """x with (stride - 1) zeros between its pixels (``lhs_dilation``),
    then padded (a negative pad crops)."""
    N, C, H, W = x.shape
    sh, sw = strides
    if (sh, sw) != (1, 1):
        xd = x.new_zeros((N, C, (H - 1) * sh + 1, (W - 1) * sw + 1))
        xd[:, :, ::sh, ::sw] = x
        x = xd
    return F.pad(x, (pad_w[0], pad_w[1], pad_h[0], pad_h[1]))


@op("ConvTranspose")
def _convtranspose(ins, at):
    """The gradient-style transposed conv of the JAX package: the kernel
    flipped with in/out channels swapped over the input dilated by the
    strides."""
    x = _a(ins[0])
    w = _a(ins[1])                      # (Cin, Cout/g, kH, kW)
    groups = at.get("group", 1)
    strides = at.get("strides", [1, 1])
    pads = at.get("pads", [0, 0, 0, 0])
    outpad = at.get("output_padding", [0, 0])
    kH, kW = w.shape[2], w.shape[3]
    wt = torch.flip(w, (2, 3))
    wt = wt.reshape(groups, w.shape[0] // groups, w.shape[1], kH, kW).transpose(1, 2) \
        .reshape(w.shape[1] * groups, w.shape[0] // groups, kH, kW)
    pad_h = (kH - 1 - pads[0], kH - 1 - pads[2] + outpad[0])
    pad_w = (kW - 1 - pads[1], kW - 1 - pads[3] + outpad[1])
    y = F.conv2d(_dilate_pad(x, strides, pad_h, pad_w), wt, groups=groups)
    if len(ins) > 2 and ins[2] is not None:
        y = y + _a(ins[2]).reshape(1, -1, 1, 1)
    return y


# --------------------------------------------------------------- int8 set

_TORCH_INT = {np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8,
              np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32}


def _sat(v, dtype):
    info = np.iinfo(dtype)
    return torch.clamp(v, info.min, info.max).to(_TORCH_INT[np.dtype(dtype)])


def _wrap_i32(acc):
    """An f64 tensor of exact integers as int32, wrapped as int32
    accumulation wraps."""
    v = acc.to(torch.int64)
    return (((v + 2 ** 31) % 2 ** 32) - 2 ** 31).to(torch.int32)


def _qparams(scale, zp):
    s = _np(scale).astype(np.float32)
    z = _np(zp) if zp is not None else np.zeros_like(s, np.int8)
    return s, z


@op("QuantizeLinear")
def _quantize(ins, at):
    x = _a(ins[0]).to(torch.float32)
    s, z = _qparams(ins[1], ins[2] if len(ins) > 2 else None)
    ax = at.get("axis", 1)
    if s.ndim and s.size > 1:
        shp = [1] * x.ndim
        shp[ax] = -1
        s = s.reshape(shp)
        zr = z.reshape(shp)
    else:
        zr = z
    y = torch.round(x / _a(s)) + _a(zr.astype(np.int32))
    return _sat(y, z.dtype.type)


@op("DequantizeLinear")
def _dequantize(ins, at):
    x = _a(ins[0]).to(torch.int32)
    s, z = _qparams(ins[1], ins[2] if len(ins) > 2 else None)
    ax = at.get("axis", 1)
    if s.ndim and s.size > 1:
        shp = [1] * x.ndim
        shp[ax] = -1
        s = s.reshape(shp)
        z = z.reshape(shp)
    return (x - _a(z.astype(np.int32))).to(torch.float32) * _a(s)


def _int_conv(xq, wq, strides, pads, dil, groups):
    """The exact integer convolution of two int tensors, as f64."""
    return F.conv2d(F.pad(xq.to(torch.float64), (pads[1], pads[3], pads[0], pads[2])),
                    wq.to(torch.float64), None, tuple(strides), 0, tuple(dil), groups)


@op("QLinearConv")
def _qlinearconv(ins, at):
    """int8 conv: exact int32 accumulation, then requantize
    (onnx QLinearConv; reference int8layers/convolution_layer.cpp)."""
    x, xs, xz, w, ws, wz, ys, yz = ins[:8]
    bias = ins[8] if len(ins) > 8 else None
    xq = _a(x).to(torch.int32) - int(_np(xz).ravel()[0])
    wz_arr = _np(wz).astype(np.int32).ravel()
    wq = _a(w).to(torch.int32)
    if wz_arr.size > 1:
        wq = wq - _a(wz_arr.reshape(-1, 1, 1, 1))
    else:
        wq = wq - int(wz_arr[0])
    acc = _int_conv(xq, wq, at.get("strides", [1, 1]), at.get("pads", [0, 0, 0, 0]),
                    at.get("dilations", [1, 1]), at.get("group", 1))
    acc = _wrap_i32(acc)
    if bias is not None:
        acc = acc + _a(bias).to(torch.int32).reshape(1, -1, 1, 1)
    xs_f = float(_np(xs).ravel()[0])
    ws_arr = _np(ws).astype(np.float32).ravel()
    ys_f = float(_np(ys).ravel()[0])
    scale = (xs_f * ws_arr / ys_f)
    if ws_arr.size > 1:
        scale = _a(scale.reshape(1, -1, 1, 1))
    else:
        scale = float(scale[0])
    yz_a = _np(yz).ravel()
    y = torch.round(acc.to(torch.float32) * scale) + int(yz_a[0])
    return _sat(y, yz_a.dtype.type)


@op("QLinearMatMul")
def _qlinearmatmul(ins, at):
    x, xs, xz, w, ws, wz, ys, yz = ins[:8]
    xq = _a(x).to(torch.int32) - int(_np(xz).ravel()[0])
    wq = _a(w).to(torch.int32) - int(_np(wz).ravel()[0])
    acc = _wrap_i32(xq.to(torch.float64) @ wq.to(torch.float64))
    scale = float(_np(xs).ravel()[0]) \
        * float(_np(ws).ravel()[0]) \
        / float(_np(ys).ravel()[0])
    yz_a = _np(yz).ravel()
    y = torch.round(acc.to(torch.float32) * scale) + int(yz_a[0])
    return _sat(y, yz_a.dtype.type)


@op("MatMulInteger")
def _matmulint(ins, at):
    x = _a(ins[0]).to(torch.int32)
    w = _a(ins[1]).to(torch.int32)
    if len(ins) > 2 and ins[2] is not None:
        x = x - int(_np(ins[2]).ravel()[0])
    if len(ins) > 3 and ins[3] is not None:
        w = w - int(_np(ins[3]).ravel()[0])
    return _wrap_i32(x.to(torch.float64) @ w.to(torch.float64))


@op("ConvInteger")
def _convint(ins, at):
    x = _a(ins[0]).to(torch.int32)
    w = _a(ins[1]).to(torch.int32)
    if len(ins) > 2 and ins[2] is not None:
        x = x - int(_np(ins[2]).ravel()[0])
    if len(ins) > 3 and ins[3] is not None:
        w = w - int(_np(ins[3]).ravel()[0])
    return _wrap_i32(_int_conv(x, w, at.get("strides", [1, 1]), at.get("pads", [0, 0, 0, 0]),
                               at.get("dilations", [1, 1]), at.get("group", 1)))


# ---------------------------------------------------------------- sort-of

@op("NonZero")
def _nonzero(ins, at):
    return np.stack(np.nonzero(_np(ins[0]))).astype(np.int64)


@op("Size")
def _size(ins, at):
    return np.int64(_np(ins[0]).size)


@op("NonMaxSuppression")
def _onnx_nms(ins, at):
    """ONNX NonMaxSuppression on the host: boxes (B, N, 4) y1x1y2x2 (center
    mode via attr), scores (B, C, N) → (K, 3) [batch, class, box]."""
    boxes = _np(ins[0]).astype(np.float32)
    scores = _np(ins[1]).astype(np.float32)
    max_out = int(_np(ins[2]).ravel()[0]) if len(ins) > 2 and \
        ins[2] is not None else 0
    iou_t = float(_np(ins[3]).ravel()[0]) if len(ins) > 3 and \
        ins[3] is not None else 0.0
    score_t = float(_np(ins[4]).ravel()[0]) if len(ins) > 4 and \
        ins[4] is not None else -np.inf
    center = at.get("center_point_box", 0)
    sel = []
    for b in range(boxes.shape[0]):
        bx = boxes[b]
        if center:
            cx, cy, w, h = bx[:, 0], bx[:, 1], bx[:, 2], bx[:, 3]
            y1, x1 = cy - h / 2, cx - w / 2
            y2, x2 = cy + h / 2, cx + w / 2
        else:
            y1, x1, y2, x2 = bx[:, 0], bx[:, 1], bx[:, 2], bx[:, 3]
            y1, y2 = np.minimum(y1, y2), np.maximum(y1, y2)
            x1, x2 = np.minimum(x1, x2), np.maximum(x1, x2)
        area = (y2 - y1) * (x2 - x1)
        for c in range(scores.shape[1]):
            sc = scores[b, c]
            order = np.argsort(-sc, kind="stable")
            order = order[sc[order] > score_t]
            keep = []
            while order.size and (not max_out or len(keep) < max_out):
                i = order[0]
                keep.append(i)
                rest = order[1:]
                yy1 = np.maximum(y1[i], y1[rest])
                xx1 = np.maximum(x1[i], x1[rest])
                yy2 = np.minimum(y2[i], y2[rest])
                xx2 = np.minimum(x2[i], x2[rest])
                inter = np.maximum(0, yy2 - yy1) * np.maximum(0, xx2 - xx1)
                iou = inter / (area[i] + area[rest] - inter + 1e-12)
                order = rest[iou <= iou_t]
            sel += [[b, c, int(i)] for i in keep]
    return np.asarray(sel, np.int64).reshape(-1, 3)


# ------------------------------------------------------------- recurrent
# LSTM/GRU/RNN (the reference's recurrent_layers.cpp) as a loop over the
# sequence axis; weights follow the ONNX layouts (gate order iofc for LSTM,
# zrh for GRU).

def _rnn_dir_params(ins, at, ngate):
    hs = int(at["hidden_size"])
    W = _a(ins[1]).to(torch.float32)      # (D, ngate*hs, input)
    R = _a(ins[2]).to(torch.float32)      # (D, ngate*hs, hs)
    D = W.shape[0]
    if len(ins) > 3 and ins[3] is not None:
        Bx = _a(ins[3]).to(torch.float32)  # (D, 2*ngate*hs)
        Wb = Bx[:, :ngate * hs]
        Rb = Bx[:, ngate * hs:]
    else:
        Wb = torch.zeros((D, ngate * hs), device=W.device)
        Rb = torch.zeros((D, ngate * hs), device=W.device)
    return hs, D, W, R, Wb, Rb


def _rnn_run(X, D, direction, cell, h0s):
    """Run `cell` over (seq, batch, input) X for each direction."""
    ys = []
    lasts = []
    for d in range(D):
        rev = (direction == "reverse") or (d == 1)
        xd = torch.flip(X, (0,)) if rev else X
        carry = h0s[d]
        steps = []
        for t in range(xd.shape[0]):
            carry, y = cell[d](carry, xd[t])
            steps.append(y)
        y = torch.stack(steps)
        if rev:
            y = torch.flip(y, (0,))
        ys.append(y)
        lasts.append(carry)
    return ys, lasts


def _direction(at):
    d = at.get("direction", "forward")
    return d.decode() if isinstance(d, bytes) else d


def _opt_state(ins, i, D, B, hs, dev):
    if len(ins) > i and ins[i] is not None:
        return _a(ins[i]).to(torch.float32)
    return torch.zeros((D, B, hs), device=dev)


@op("LSTM")
def _lstm(ins, at):
    hs, D, W, R, Wb, Rb = _rnn_dir_params(ins, at, 4)
    X = _a(ins[0]).to(torch.float32)      # (seq, batch, input)
    B = X.shape[1]
    direction = _direction(at)
    h0 = _opt_state(ins, 5, D, B, hs, X.device)
    c0 = _opt_state(ins, 6, D, B, hs, X.device)
    P = (_a(ins[7]).to(torch.float32) if len(ins) > 7
         and ins[7] is not None else None)  # (D, 3*hs) peepholes

    def make_cell(d):
        Wd = W[d].T
        Rd = R[d].T
        bd = Wb[d] + Rb[d]
        pi = P[d, :hs] if P is not None else None
        po = P[d, hs:2 * hs] if P is not None else None
        pf = P[d, 2 * hs:] if P is not None else None

        def cell(carry, xt):
            h, c = carry
            g = xt @ Wd + h @ Rd + bd
            gi, go, gf, gc = (g[:, :hs], g[:, hs:2 * hs],
                              g[:, 2 * hs:3 * hs], g[:, 3 * hs:])
            if P is not None:
                gi = gi + pi * c
                gf = gf + pf * c
            i = torch.sigmoid(gi)
            f = torch.sigmoid(gf)
            cn = f * c + i * torch.tanh(gc)
            if P is not None:
                go = go + po * cn
            o = torch.sigmoid(go)
            hn = o * torch.tanh(cn)
            return (hn, cn), hn
        return cell

    cells = [make_cell(d) for d in range(D)]
    ys, lasts = _rnn_run(X, D, direction, cells, [(h0[d], c0[d]) for d in range(D)])
    Y = torch.stack(ys, dim=1)               # (seq, D, batch, hs)
    Yh = torch.stack([last[0] for last in lasts], dim=0)
    Yc = torch.stack([last[1] for last in lasts], dim=0)
    return (Y, Yh, Yc)


@op("GRU")
def _gru(ins, at):
    hs, D, W, R, Wb, Rb = _rnn_dir_params(ins, at, 3)
    X = _a(ins[0]).to(torch.float32)
    B = X.shape[1]
    direction = _direction(at)
    lbr = int(at.get("linear_before_reset", 0))
    h0 = _opt_state(ins, 5, D, B, hs, X.device)

    def make_cell(d):
        Wd = W[d].T
        Rd = R[d].T
        wb = Wb[d]
        rb = Rb[d]

        def cell(h, xt):
            gx = xt @ Wd + wb                   # (batch, 3hs)
            gz = gx[:, :hs]
            gr = gx[:, hs:2 * hs]
            gh = gx[:, 2 * hs:]
            hr = h @ Rd
            z = torch.sigmoid(gz + hr[:, :hs] + rb[:hs])
            r = torch.sigmoid(gr + hr[:, hs:2 * hs] + rb[hs:2 * hs])
            if lbr:
                hh = torch.tanh(gh + r * (hr[:, 2 * hs:] + rb[2 * hs:]))
            else:
                hh = torch.tanh(gh + (r * h) @ Rd[:, 2 * hs:] + rb[2 * hs:])
            hn = (1 - z) * hh + z * h
            return hn, hn
        return cell

    cells = [make_cell(d) for d in range(D)]
    ys, lasts = _rnn_run(X, D, direction, cells, [h0[d] for d in range(D)])
    return (torch.stack(ys, dim=1), torch.stack(lasts, dim=0))


@op("RNN")
def _rnn_op(ins, at):
    hs, D, W, R, Wb, Rb = _rnn_dir_params(ins, at, 1)
    X = _a(ins[0]).to(torch.float32)
    B = X.shape[1]
    direction = _direction(at)
    h0 = _opt_state(ins, 5, D, B, hs, X.device)

    def make_cell(d):
        Wd = W[d].T
        Rd = R[d].T
        bd = Wb[d] + Rb[d]

        def cell(h, xt):
            hn = torch.tanh(xt @ Wd + h @ Rd + bd)
            return hn, hn
        return cell

    cells = [make_cell(d) for d in range(D)]
    ys, lasts = _rnn_run(X, D, direction, cells, [h0[d] for d in range(D)])
    return (torch.stack(ys, dim=1), torch.stack(lasts, dim=0))


# --------------------------------------------------------- spatial samplers

@op("GridSample")
def _grid_sample(ins, at):
    """ONNX GridSample: device index math + one batched gather.
    X: (N, C, H, W); grid: (N, Ho, Wo, 2) in [-1, 1] xy order."""
    x = _a(ins[0]).to(torch.float32)
    grid = _a(ins[1]).to(torch.float32)
    mode = at.get("mode", "linear")
    mode = mode.decode() if isinstance(mode, bytes) else mode
    pad_mode = at.get("padding_mode", "zeros")
    pad_mode = pad_mode.decode() if isinstance(pad_mode, bytes) else pad_mode
    align = bool(at.get("align_corners", 0))
    N, C, H, W = x.shape
    Ho, Wo = grid.shape[1], grid.shape[2]

    def unnorm(g, size):
        if align:
            return (g + 1.0) * 0.5 * (size - 1)
        return ((g + 1.0) * size - 1.0) * 0.5

    gx = unnorm(grid[..., 0], W)
    gy = unnorm(grid[..., 1], H)

    def resolve(c, size):
        if pad_mode == "border":
            return torch.clamp(c, 0.0, size - 1.0)
        if pad_mode == "reflection":
            if align:
                span = 2.0 * (size - 1)
                if size == 1:
                    return torch.zeros_like(c)
                m = torch.remainder(c, span)
                return torch.where(m > size - 1, span - m, m)
            span = 2.0 * size
            m = torch.remainder(c + 0.5, span)
            m = torch.where(m > size, span - m, m) - 0.5
            return torch.clamp(m, 0.0, size - 1.0)
        return c                      # zeros: mask below

    gx = resolve(gx, W)
    gy = resolve(gy, H)

    flat = x.permute(0, 2, 3, 1).reshape(N * H * W, C)
    nb = (torch.arange(N, dtype=torch.int32, device=x.device) * (H * W))[:, None, None]

    def fetch(iy, ix):
        okx = (ix >= 0) & (ix <= W - 1)
        oky = (iy >= 0) & (iy <= H - 1)
        ic = torch.clamp(ix, 0, W - 1).to(torch.int32)
        rc = torch.clamp(iy, 0, H - 1).to(torch.int32)
        g = flat.index_select(0, (rc * W + ic + nb).reshape(-1))
        g = g.reshape(N, Ho, Wo, C)
        if pad_mode == "zeros":
            g = torch.where((okx & oky)[..., None], g, torch.zeros_like(g))
        return g

    if mode in ("bicubic", "cubic"):
        raise NotImplementedError("GridSample mode=bicubic")
    if mode in ("nearest",):
        out = fetch(torch.round(gy), torch.round(gx))
    else:  # linear (bilinear)
        x0 = torch.floor(gx)
        y0 = torch.floor(gy)
        fx = (gx - x0)[..., None]
        fy = (gy - y0)[..., None]
        out = (fetch(y0, x0) * (1 - fx) * (1 - fy)
               + fetch(y0, x0 + 1) * fx * (1 - fy)
               + fetch(y0 + 1, x0) * (1 - fx) * fy
               + fetch(y0 + 1, x0 + 1) * fx * fy)
    return out.permute(0, 3, 1, 2)


@op("RoiAlign")
def _roi_align(ins, at):
    """ONNX RoiAlign (two-stage detector pooling): average of
    sampling_ratio^2 bilinear samples per output bin.  sampling_ratio=0
    (adaptive) samples on a fixed SxS grid with per-ROI masking: S is
    sized from constant ROIs, else OPENCV_TPU_ROIALIGN_MAX_SR (default 8),
    as the JAX package does."""
    x = _a(ins[0]).to(torch.float32)       # (N, C, H, W)
    rois = _a(ins[1]).to(torch.float32)    # (R, 4) x1 y1 x2 y2
    bidx = _a(ins[2]).to(torch.int32)      # (R,)
    oh = int(at.get("output_height", 1))
    ow = int(at.get("output_width", 1))
    scale = float(at.get("spatial_scale", 1.0))
    sr_attr = int(at.get("sampling_ratio", 0))
    if sr_attr > 0:
        sr = sr_attr
    else:
        sr = int(os.environ.get("OPENCV_TPU_ROIALIGN_MAX_SR", "8"))
        if isinstance(ins[1], np.ndarray) and ins[1].size:
            r = np.asarray(ins[1], np.float64)
            need = max(
                np.ceil((r[:, 3] - r[:, 1]).max() * scale / oh),
                np.ceil((r[:, 2] - r[:, 0]).max() * scale / ow), 1.0)
            sr = int(min(64.0, need))
    cmode = at.get("coordinate_transformation_mode", "half_pixel")
    cmode = cmode.decode() if isinstance(cmode, bytes) else cmode
    off = 0.5 if cmode == "half_pixel" else 0.0
    N, C, H, W = x.shape
    R = rois.shape[0]
    dev = x.device

    x1 = rois[:, 0] * scale - off
    y1 = rois[:, 1] * scale - off
    x2 = rois[:, 2] * scale - off
    y2 = rois[:, 3] * scale - off
    floor_ = 1.0 if cmode != "half_pixel" else 0.0
    bw = torch.clamp(x2 - x1, min=floor_)
    bh = torch.clamp(y2 - y1, min=floor_)
    ii = torch.arange(oh, dtype=torch.float32, device=dev)
    jj = torch.arange(ow, dtype=torch.float32, device=dev)
    ar = torch.arange(sr, dtype=torch.float32, device=dev)
    if sr_attr > 0:
        nsy = torch.full((R,), float(sr), device=dev)
        nsx = torch.full((R,), float(sr), device=dev)
    else:
        nsy = torch.clamp(torch.ceil(bh / oh), 1.0, float(sr))
        nsx = torch.clamp(torch.ceil(bw / ow), 1.0, float(sr))
    live_y = ar[None, :] < nsy[:, None]            # (R, sr)
    live_x = ar[None, :] < nsx[:, None]
    aa_y = (ar[None, :] + 0.5) / nsy[:, None]      # (R, sr)
    aa_x = (ar[None, :] + 0.5) / nsx[:, None]
    ys = (y1[:, None, None] + (ii[None, :, None] + aa_y[:, None, :])
          * (bh / oh)[:, None, None])              # (R, oh, sr)
    xs = (x1[:, None, None] + (jj[None, :, None] + aa_x[:, None, :])
          * (bw / ow)[:, None, None])              # (R, ow, sr)

    flat = x.permute(0, 2, 3, 1).reshape(N * H * W, C)
    nb = (bidx * (H * W))[:, None, None, None, None]

    yv = ys[:, :, None, :, None]                   # (R, oh, 1, sr, 1)
    xv = xs[:, None, :, None, :]                   # (R, 1, ow, 1, sr)
    y0 = torch.floor(yv)
    x0 = torch.floor(xv)
    fy = yv - y0
    fx = xv - x0

    # OOB is decided per SAMPLE (bilinear_interpolate returns exactly 0
    # for y < -1 or y > H), not per tap; in-range samples clamp taps
    sample_oob = ((yv < -1) | (yv > H) | (xv < -1) | (xv > W))

    def fetch(iy, ix):
        rc = torch.clamp(iy, 0, H - 1).to(torch.int32)
        ic = torch.clamp(ix, 0, W - 1).to(torch.int32)
        idx = (rc * W + ic + nb)
        shp = torch.broadcast_shapes(idx.shape, sample_oob.shape)
        idx = idx.expand(shp)
        return flat.index_select(0, idx.reshape(-1)).reshape(shp + (C,))

    # clamp fractional parts like bilinear_interpolate (x<0 -> x=0)
    fx = torch.where(xv < 0, torch.zeros_like(fx), fx)
    fy = torch.where(yv < 0, torch.zeros_like(fy), fy)
    val = (fetch(y0, x0) * ((1 - fx) * (1 - fy))[..., None]
           + fetch(y0, x0 + 1) * (fx * (1 - fy))[..., None]
           + fetch(y0 + 1, x0) * ((1 - fx) * fy)[..., None]
           + fetch(y0 + 1, x0 + 1) * (fx * fy)[..., None])
    live = (live_y[:, None, None, :, None] & live_x[:, None, None, None, :]
            & ~sample_oob)
    val = torch.where(live[..., None], val, torch.zeros_like(val))
    nlive = (nsy * nsx)[:, None, None]
    out = val.sum(dim=(3, 4)) / nlive[..., None]  # (R, oh, ow, C)
    return out.permute(0, 3, 1, 2)
