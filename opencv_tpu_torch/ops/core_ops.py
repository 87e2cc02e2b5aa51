"""Core dense-array operations (twin of ``opencv_tpu/ops/core_ops.py``;
modules/core: arithm.cpp, matrix ops, statistics, LUT, norm, convert) — the
cv2 surface users touch constantly.

Per-pixel ops and reductions run on the input tensor's device; numpy input
becomes a CPU tensor.  Saturating integer results go through
``saturate_cast`` after f32 arithmetic, as the JAX package computes them.
Where cv2 works in double (``mean``, ``meanStdDev``, ``norm``, ``sumElems``,
``minMaxLoc``'s values, ``normalize``'s min, max, norm, scale and shift) the
port does too, where the JAX package has f32; ``normalize`` then converts
in f32 as cv2's ``convertTo`` does.  A float op on f64 input stays f64.
Batch semantics are the JAX package's: ``normalize`` takes one min and max
(or norm) over the whole batch, ``minMaxLoc`` reads image 0 only.  The
scalar and graph solvers (``solveCubic``, ``solvePoly``, ``solveLP``,
``buildMST``, ``fastAtan2``, ``cubeRoot``, ``clipLine``, ``PSNR``) keep the
JAX package's host numpy code, copied.
"""

from __future__ import annotations

import builtins
import math

import numpy as np
import torch

from .. import constants as K
from ..core.arrays import as_tensor, from_batched, to_batched, to_device
from ..core.fixedpoint import saturate_cast

__all__ = [
    "add", "subtract", "multiply", "divide", "absdiff", "scaleAdd",
    "addWeighted", "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "min", "max", "compare", "inRange",
    "LUT", "convertScaleAbs", "normalize",
    "split", "merge", "flip", "rotate", "transpose",
    "minMaxLoc", "mean", "meanStdDev", "norm", "countNonZero", "sumElems",
    "magnitude", "phase", "cartToPolar", "polarToCart", "exp", "log",
    "sqrt", "pow",
    "mixChannels", "setIdentity", "completeSymm", "solveCubic",
    "solvePoly", "PSNR", "batchDistance",
    "hconcat", "vconcat", "repeat", "reduce", "reduceArgMax", "reduceArgMin",
    "sort", "sortIdx", "findNonZero", "hasNonZero", "checkRange", "patchNaNs",
    "extractChannel", "insertChannel", "copyTo", "gemm", "calcCovarMatrix",
    "divSpectrums", "fastAtan2", "cubeRoot", "clipLine", "flipND", "transposeND",
    "broadcast", "finiteMask", "solveLP", "buildMST",
    "REDUCE_SUM", "REDUCE_AVG", "REDUCE_MAX", "REDUCE_MIN", "REDUCE_SUM2",
    "SORT_EVERY_ROW", "SORT_EVERY_COLUMN", "SORT_ASCENDING", "SORT_DESCENDING",
    "GEMM_1_T", "GEMM_2_T", "GEMM_3_T",
    "COVAR_SCRAMBLED", "COVAR_NORMAL", "COVAR_USE_AVG", "COVAR_SCALE",
    "COVAR_ROWS", "COVAR_COLS",
]

_F32, _F64 = torch.float32, torch.float64
_DBL_EPSILON = float(np.finfo(np.float64).eps)
_DEPTHS = {K.CV_8U: torch.uint8, K.CV_8S: torch.int8, K.CV_16U: torch.uint16,
           K.CV_16S: torch.int16, K.CV_32S: torch.int32, K.CV_32F: _F32, K.CV_64F: _F64}


def _out_dtype(dtype, default: torch.dtype) -> torch.dtype:
    """A cv2 depth (or a torch dtype) as a torch dtype; None or -1 is
    `default`."""
    if dtype is None or (isinstance(dtype, int) and dtype < 0):
        return default
    return _DEPTHS[dtype] if isinstance(dtype, int) else dtype


def _scalar(v, dtype, device):
    """A number as a 0-dim tensor on `device`, made there (a copy from the
    host would wait for the queue)."""
    return torch.full((), v, dtype=dtype, device=device)


def _pair(a, b):
    """(x, y, meta): `a` batched, `b` batched on x's device, or a number as a
    0-dim tensor there."""
    x, meta = to_batched(a)
    if isinstance(b, (int, float, np.integer, np.floating)):
        return x, _scalar(float(b), _F64, x.device), meta
    bt = as_tensor(b)
    if bt.ndim == 0:
        return x, to_device(bt, x.device), meta
    y, _ = to_batched(bt)
    return x, to_device(y, x.device), meta


def _work(*ts) -> torch.dtype:
    """f64 if an input is f64, else f32: the float type an op computes in."""
    return _F64 if any(t.dtype == _F64 for t in ts) else _F32


def _apply_mask(out, mask):
    if mask is None:
        return out
    m, _ = to_batched(to_device(as_tensor(mask), out.device))
    return torch.where(m != 0, out, torch.zeros_like(out))


def add(src1, src2, mask=None, dtype=None):
    x, y, meta = _pair(src1, src2)
    out = saturate_cast(x.to(_F32) + y.to(_F32), _out_dtype(dtype, x.dtype))
    return from_batched(_apply_mask(out, mask), meta)


def subtract(src1, src2, mask=None, dtype=None):
    x, y, meta = _pair(src1, src2)
    out = saturate_cast(x.to(_F32) - y.to(_F32), _out_dtype(dtype, x.dtype))
    return from_batched(_apply_mask(out, mask), meta)


def multiply(src1, src2, scale: float = 1.0, dtype=None):
    x, y, meta = _pair(src1, src2)
    acc = x.to(_F32) * y.to(_F32) * float(scale)
    return from_batched(saturate_cast(acc, _out_dtype(dtype, x.dtype)), meta)


def divide(src1, src2, scale: float = 1.0, dtype=None):
    """src1 * scale / src2, 0 where src2 == 0; the quotient of two tensors,
    so the card and the CPU round alike."""
    x, y, meta = _pair(src1, src2)
    yf = y.to(_F32)
    acc = torch.where(yf != 0, x.to(_F32) * float(scale) / yf, 0.0)
    return from_batched(saturate_cast(acc, _out_dtype(dtype, x.dtype)), meta)


def absdiff(src1, src2):
    x, y, meta = _pair(src1, src2)
    return from_batched(saturate_cast((x.to(_F32) - y.to(_F32)).abs(), x.dtype), meta)


def scaleAdd(src1, alpha: float, src2):
    x, y, meta = _pair(src1, src2)
    return from_batched(saturate_cast(x.to(_F32) * float(alpha) + y.to(_F32), x.dtype), meta)


def addWeighted(src1, alpha: float, src2, beta: float, gamma: float, dtype=None):
    """saturate(src1 * alpha + src2 * beta + gamma) in f32, one op at a time
    (no fused multiply-add on either device)."""
    x, y, meta = _pair(src1, src2)
    acc = x.to(_F32) * float(alpha) + y.to(_F32) * float(beta) + float(gamma)
    return from_batched(saturate_cast(acc, _out_dtype(dtype, x.dtype)), meta)


def _bitwise(op, src1, src2, mask=None):
    x, y, meta = _pair(src1, src2)
    return from_batched(_apply_mask(op(x, y.to(x.dtype)), mask), meta)


def bitwise_and(src1, src2, mask=None):
    return _bitwise(torch.bitwise_and, src1, src2, mask)


def bitwise_or(src1, src2, mask=None):
    return _bitwise(torch.bitwise_or, src1, src2, mask)


def bitwise_xor(src1, src2, mask=None):
    return _bitwise(torch.bitwise_xor, src1, src2, mask)


def bitwise_not(src, mask=None):
    x, meta = to_batched(src)
    return from_batched(_apply_mask(torch.bitwise_not(x), mask), meta)


def min(src1, src2):  # noqa: A001
    x, y, meta = _pair(src1, src2)
    return from_batched(torch.minimum(x, y.to(x.dtype)), meta)


def max(src1, src2):  # noqa: A001
    x, y, meta = _pair(src1, src2)
    return from_batched(torch.maximum(x, y.to(x.dtype)), meta)


_CMP = {0: torch.eq, 1: torch.gt, 2: torch.ge, 3: torch.lt, 4: torch.le, 5: torch.ne}


def compare(src1, src2, cmpop: int):
    x, y, meta = _pair(src1, src2)
    ok = _CMP[cmpop](x.to(_F32), y.to(_F32))
    return from_batched(ok.to(torch.uint8) * 255, meta)


def inRange(src, lowerb, upperb):
    x, meta = to_batched(src)

    def bound(b):
        return to_device(torch.from_numpy(np.asarray(b, np.float64).reshape(-1)).to(_F32),
                         x.device)

    xf = x.to(_F32)
    ok = ((xf >= bound(lowerb)) & (xf <= bound(upperb))).all(dim=-1, keepdim=True)
    return from_batched(ok.to(torch.uint8) * 255, meta)


def LUT(src, lut):
    """`cv::LUT` on u8 input: the 256-entry table (one, or one per channel)
    read with an index; the result has the table's dtype."""
    x, meta = to_batched(src)
    if x.dtype != torch.uint8:
        raise ValueError("LUT takes 8-bit input")
    table = to_device(as_tensor(lut), x.device).reshape(256, -1)
    idx = x.to(torch.int32)
    if table.shape[1] > 1:  # per-channel tables, read as table[v, c]
        C = x.shape[-1]
        idx = idx * C + torch.arange(C, dtype=torch.int32, device=x.device)
    out = table.reshape(-1).index_select(0, idx.reshape(-1)).reshape(x.shape)
    return from_batched(out, meta)


def convertScaleAbs(src, alpha: float = 1.0, beta: float = 0.0):
    x, meta = to_batched(src)
    acc = (x.to(_F32) * float(alpha) + float(beta)).abs()
    return from_batched(saturate_cast(acc, torch.uint8), meta)


def _norm64(x, norm_type: int) -> torch.Tensor:
    """The NORM_INF / L1 / L2 / L2SQR norm of all of x, an f64 0-dim tensor."""
    xd = x.to(_F64)
    if norm_type == K.NORM_INF:
        return xd.abs().max()
    if norm_type == K.NORM_L1:
        return xd.abs().sum()
    if norm_type in (K.NORM_L2, K.NORM_L2SQR):
        s = (xd * xd).sum()
        return torch.sqrt(s) if norm_type == K.NORM_L2 else s
    raise ValueError(f"unsupported norm {norm_type}")


def normalize(src, dst=None, alpha: float = 1.0, beta: float = 0.0,
              norm_type: int = K.NORM_L2, dtype: int = -1, mask=None):
    """`cv::normalize` over the whole batch (one min and max, or one norm,
    as ``opencv_tpu`` takes it; cv2 takes one per image).  scale and shift
    in f64 as cv2 computes them (NORM_MINMAX: scale = (dmax - dmin) /
    (smax - smin), shift = dmin - smin * scale; else scale = alpha / norm),
    then ``convertTo``: x * scale + shift in f32, in f64 for an f64 result."""
    x, meta = to_batched(src)
    dev = x.device
    one = _scalar(1.0, _F64, dev)
    if norm_type == K.NORM_MINMAX:
        smin, smax = x.min().to(_F64), x.max().to(_F64)
        dmin, dmax = builtins.min(alpha, beta), builtins.max(alpha, beta)
        span = smax - smin
        scale = (dmax - dmin) * torch.where(span > _DBL_EPSILON, one / span, 0.0)
        shift = dmin - smin * scale
    else:
        n = _norm64(x, norm_type)
        scale = torch.where(n > _DBL_EPSILON, _scalar(float(alpha), _F64, dev) / n, 0.0)
        shift = torch.zeros((), dtype=_F64, device=dev)
    out_dtype = _out_dtype(dtype, x.dtype)
    work = _F64 if out_dtype == _F64 else _F32
    out = x.to(work) * scale.to(work) + shift.to(work)
    return from_batched(saturate_cast(out, out_dtype), meta)


def split(src):
    x, meta = to_batched(src)
    return [from_batched(x[..., i:i + 1], meta) for i in range(x.shape[-1])]


def merge(channels):
    xs, meta = [], None
    for c in channels:
        x, meta = to_batched(c)
        xs.append(x)
    return from_batched(torch.cat(xs, dim=-1), meta)


def flip(src, flipCode: int):
    x, meta = to_batched(src)
    dims = [1] if flipCode == 0 else [2] if flipCode > 0 else [1, 2]
    return from_batched(torch.flip(x, dims), meta)


def rotate(src, rotateCode: int):
    x, meta = to_batched(src)
    if rotateCode == K.ROTATE_90_CLOCKWISE:
        y = torch.flip(x.transpose(1, 2), [2])
    elif rotateCode == K.ROTATE_180:
        y = torch.flip(x, [1, 2])
    else:
        y = torch.flip(x.transpose(1, 2), [1])
    return from_batched(y, meta)


def transpose(src):
    x, meta = to_batched(src)
    return from_batched(x.transpose(1, 2).contiguous(), meta)


def minMaxLoc(src, mask=None):
    """(min, max, min (x, y), max (x, y)) of image 0 of the batch (the JAX
    package's batch semantics; cv2 takes one image), values in f64, the
    first location in row order; one read back to the host."""
    x, _ = to_batched(src)
    if x.shape[-1] != 1:
        raise ValueError("minMaxLoc requires single-channel input")
    v = x[0, :, :, 0].to(_F64)
    W = v.shape[1]
    vmin = vmax = v.reshape(-1)
    if mask is not None:
        m, _ = to_batched(to_device(as_tensor(mask), x.device))
        mm = (m[0, :, :, 0] != 0).reshape(-1)
        vmin = torch.where(mm, vmin, math.inf)
        vmax = torch.where(mm, vmax, -math.inf)
    i_min, i_max = torch.argmin(vmin), torch.argmax(vmax)
    mn, mx, i_min, i_max = torch.stack([vmin[i_min], vmax[i_max], i_min.to(_F64),
                                        i_max.to(_F64)]).tolist()
    i_min, i_max = int(i_min), int(i_max)
    return mn, mx, (i_min % W, i_min // W), (i_max % W, i_max // W)


def mean(src, mask=None):
    """Per-channel mean over the batch in f64, as a 4-tuple: the sum times
    1/count, as cv2 scales it."""
    x, _ = to_batched(src)
    xd = x.to(_F64)
    if mask is not None:
        m, _ = to_batched(to_device(as_tensor(mask), x.device))
        mm = (m != 0).to(_F64)
        scale = _scalar(1.0, _F64, x.device) / mm.sum().clamp(min=1.0)
        vals = (xd * mm).sum(dim=(0, 1, 2)) * scale
    else:
        vals = xd.sum(dim=(0, 1, 2)) * (1.0 / xd[..., 0].numel())
    vals = vals.tolist()
    return tuple(vals + [0.0] * (4 - len(vals)))


def meanStdDev(src, mask=None):
    """Per-channel mean and standard deviation in f64 as cv2 computes them
    (var = E[x²] - E[x]²), each a (C, 1) f64 numpy array."""
    x, _ = to_batched(src)
    xd = x.to(_F64)
    scale = 1.0 / xd[..., 0].numel()          # cv2 multiplies by 1/n
    mu = xd.sum(dim=(0, 1, 2)) * scale
    var = (xd * xd).sum(dim=(0, 1, 2)) * scale - mu * mu
    sd = torch.sqrt(var.clamp(min=0.0))
    return (mu.cpu().numpy().reshape(-1, 1), sd.cpu().numpy().reshape(-1, 1))


def norm(src1, normType: int = K.NORM_L2, mask=None) -> float:
    x, _ = to_batched(src1)
    return float(_norm64(x, normType & K.NORM_TYPE_MASK))


def countNonZero(src) -> int:
    x, _ = to_batched(src)
    return int(torch.count_nonzero(x))


def sumElems(src):
    """Per-channel sums in f64, as a 4-tuple."""
    x, _ = to_batched(src)
    vals = x.to(_F64).sum(dim=(0, 1, 2)).tolist()
    return tuple(vals + [0.0] * (4 - len(vals)))


def magnitude(x, y):
    """sqrt(x² + y²): the sum in the op's float type, the root correctly
    rounded (taken in f64), so both devices agree."""
    a, b, meta = _pair(x, y)
    w = _work(a, b)
    af, bf = a.to(w), b.to(w)
    return from_batched(torch.sqrt((af * af + bf * bf).to(_F64)).to(w), meta)


def phase(x, y, angleInDegrees: bool = False):
    """atan2(y, x) in [0, 2π) (or degrees), taken in f64."""
    a, b, meta = _pair(x, y)
    w = _work(a, b)
    ang = torch.atan2(b.to(w).to(_F64), a.to(w).to(_F64))
    ang = torch.where(ang < 0, ang + 2 * math.pi, ang)
    if angleInDegrees:
        ang = ang * (180.0 / math.pi)
    return from_batched(ang.to(w), meta)


def cartToPolar(x, y, angleInDegrees: bool = False):
    return magnitude(x, y), phase(x, y, angleInDegrees)


def polarToCart(mag, angle, angleInDegrees: bool = False):
    m, a, meta = _pair(mag, angle)
    w = _work(m, a)
    ad = a.to(w).to(_F64)
    if angleInDegrees:
        ad = ad * (math.pi / 180.0)
    mw = m.to(w)
    return (from_batched(mw * torch.cos(ad).to(w), meta),
            from_batched(mw * torch.sin(ad).to(w), meta))


def _unary(src, fn):
    x, meta = to_batched(src)
    w = _work(x)
    return from_batched(fn(x.to(w).to(_F64)).to(w), meta)


def exp(src):
    return _unary(src, torch.exp)


def log(src):
    return _unary(src, torch.log)


def sqrt(src):
    return _unary(src, torch.sqrt)


def pow(src, power: float):  # noqa: A001
    return _unary(src, lambda v: torch.pow(v, float(power)))


# --------------------------------------------------------------------------
# tail APIs: mixChannels / setIdentity / completeSymm / solveCubic /
# solvePoly / PSNR / batchDistance (core/src/{channels,matrix_ops,
# mathfuncs,norm,batch_distance}.cpp)
# --------------------------------------------------------------------------

def _host(a) -> np.ndarray:
    """An array or tensor as a host numpy array (for the host solvers)."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _hwc(a) -> torch.Tensor:
    t = as_tensor(a)
    return t[..., None] if t.ndim == 2 else t


def mixChannels(src, dst, fromTo):
    """`cv::mixChannels` (core/src/channels.cpp): copy channel planes from
    the `src` list into the `dst` list per (from, to) index pairs (channel
    numbers run across each list; a -1 source fills 0).  Returns the
    updated dst list, each in the rank it came in, on its device."""
    srcs = [_hwc(s) for s in src]
    outs = [_hwc(d).clone() for d in dst]
    pairs = np.asarray(fromTo, np.int64).reshape(-1, 2)
    sbound = np.cumsum([s.shape[2] for s in srcs])
    dbound = np.cumsum([d.shape[2] for d in outs])
    for f, t in pairs:
        di = int(np.searchsorted(dbound, t, side="right"))
        dc = int(t - (dbound[di - 1] if di else 0))
        if f < 0:
            outs[di][:, :, dc] = 0
        else:
            si = int(np.searchsorted(sbound, f, side="right"))
            sc = int(f - (sbound[si - 1] if si else 0))
            outs[di][:, :, dc] = to_device(srcs[si][:, :, sc], outs[di].device)
    return [o[:, :, 0] if as_tensor(d0).ndim == 2 else o for d0, o in zip(dst, outs)]


def setIdentity(mtx, s=1.0):
    """`cv::setIdentity`: a new array of mtx's shape and dtype, s on the
    diagonal and 0 elsewhere."""
    a = as_tensor(mtx)
    out = torch.zeros_like(a)
    n = builtins.min(out.shape[0], out.shape[1])
    i = torch.arange(n, device=a.device)
    out[i, i, ...] = float(np.asarray(_host(s)).reshape(-1)[0])
    return out


def completeSymm(m, lowerToUpper: bool = False):
    """`cv::completeSymm`: copy one triangle onto the other (default: upper
    onto lower)."""
    a = as_tensor(m).clone()
    r, c = torch.tril_indices(a.shape[0], a.shape[1], -1, device=a.device)
    if lowerToUpper:
        a[c, r] = a[r, c]
    else:
        a[r, c] = a[c, r]
    return a


# copy of opencv_tpu.ops.core_ops.solveCubic
def solveCubic(coeffs):
    """`cv::solveCubic` (core/src/mathfuncs.cpp:1797): real roots of
    c0 x^3 + c1 x^2 + c2 x + c3 (or the quadratic when len==3).
    Returns (nroots, roots(3,1)) with unused entries 0."""
    c = np.asarray(_host(coeffs), np.float64).reshape(-1)
    roots = np.zeros(3, np.float64)
    if len(c) == 3:
        a, b, cc = c[0], c[1], c[2]
        if a == 0:
            if b == 0:
                n = -1 if cc == 0 else 0
            else:
                roots[0] = -cc / b
                n = 1
        else:
            d = b * b - 4 * a * cc
            if d < 0:
                n = 0
            elif d == 0:
                roots[0] = -b / (2 * a)
                n = 1
            else:
                sd = np.sqrt(d)
                roots[0] = (-b + sd) / (2 * a)
                roots[1] = (-b - sd) / (2 * a)
                n = 2
    else:
        a0, a1, a2, a3 = (c if len(c) == 4 else np.r_[1.0, c])
        if a0 == 0:
            return solveCubic(np.r_[a1, a2, a3])
        r = np.roots([a0, a1, a2, a3])
        real = np.sort(r[np.abs(r.imag) < 1e-9 * np.maximum(1, np.abs(r))].real)
        n = len(real)
        roots[:n] = real[:n]
    return builtins.max(n, 0) if n >= 0 else n, roots.reshape(3, 1)


# copy of opencv_tpu.ops.core_ops.solvePoly
def solvePoly(coeffs, maxIters: int = 300):
    """`cv::solvePoly` (core/src/mathfuncs.cpp:1944): all complex roots
    of Σ c[i] x^i (cv2's coefficient order is LOW to HIGH degree).
    Returns (maxDiff, roots(n,1,2))."""
    c = np.asarray(_host(coeffs), np.float64).reshape(-1)
    n = len(c) - 1
    r = np.roots(c[::-1])
    vals = np.polyval(c[::-1], r)
    md = float(np.max(np.abs(vals))) if len(r) else 0.0
    out = np.zeros((n, 1, 2), np.float64)
    out[:len(r), 0, 0] = r.real
    out[:len(r), 0, 1] = r.imag
    return md, out


# copy of opencv_tpu.ops.core_ops.PSNR
def PSNR(src1, src2, R: float = 255.0):
    """`cv::PSNR` (core/src/norm.cpp:1291)."""
    a = np.asarray(_host(src1), np.float64)
    b = np.asarray(_host(src2), np.float64)
    diff = np.sqrt(np.mean((a - b) ** 2))
    return float(20 * np.log10(R / (diff + np.finfo(np.float64).eps)))


_POPCOUNT = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1).astype(np.int32)


def batchDistance(src1, src2, dtype: int = -1, nidx=None, normType: int = K.NORM_L2,
                  K_: int = 0, mask=None, update: int = 0, crosscheck: bool = False, K=None):
    """`cv::batchDistance` (core/src/batch_distance.cpp:265): all-pairs
    distances between row vectors on src1's device; K > 0 also returns the
    K nearest src2 rows per src1 row.  L2 and L2SQR as
    |a|² + |b|² - 2ab with one f32 matmul (no TF32); Hamming by a popcount
    table."""
    if K is not None:
        K_ = K
    from .. import constants as _K
    a = as_tensor(src1)
    b = to_device(as_tensor(src2), a.device)
    if normType in (_K.NORM_L2, _K.NORM_L2SQR):
        af, bf = a.to(_F32), b.to(_F32)
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")  # no TF32 on the card
        try:
            g = af @ bf.T
        finally:
            torch.set_float32_matmul_precision(prev)
        d2 = ((af * af).sum(dim=1)[:, None] + (bf * bf).sum(dim=1)[None, :] - 2 * g).clamp(min=0)
        dist = torch.sqrt(d2) if normType == _K.NORM_L2 else d2
    elif normType == _K.NORM_L1:
        dist = (a.to(_F32)[:, None, :] - b.to(_F32)[None, :, :]).abs().sum(dim=2)
    elif normType in (_K.NORM_HAMMING, _K.NORM_HAMMING2):
        x = torch.bitwise_xor(a[:, None, :], b[None, :, :]).to(torch.int64)
        dist = to_device(_POPCOUNT, a.device)[x].sum(dim=2).to(torch.int32)
    else:
        raise ValueError(f"unsupported normType {normType}")
    if K_ > 0:
        order = torch.sort(dist, dim=1, stable=True).indices[:, :K_]
        return torch.gather(dist, 1, order), order.to(torch.int32)
    return dist


# --------------------------------------------------------------------------
# core utility surface: concat/repeat/reduce/sort/findNonZero/checkRange/
# patchNaNs/channel ops/gemm/covar/divSpectrums/scalar math/clipLine
# (core/src/{matrix_ops,matmul,mathfuncs}.cpp); on the input's device
# --------------------------------------------------------------------------

def _same_device(arrays):
    ts = [as_tensor(s) for s in arrays]
    return [to_device(t, ts[0].device) for t in ts]


def hconcat(src):
    return torch.cat(_same_device(src), dim=1)


def vconcat(src):
    return torch.cat(_same_device(src), dim=0)


def repeat(src, ny: int, nx: int):
    a = as_tensor(src)
    return a.repeat((ny, nx) + (1,) * (a.ndim - 2))


REDUCE_SUM, REDUCE_AVG, REDUCE_MAX, REDUCE_MIN, REDUCE_SUM2 = 0, 1, 2, 3, 4


def reduce(src, dim: int, rtype: int, dtype: int = -1):
    """`cv::reduce`: sums, means and squared sums in f64 (f32 unless dtype
    asks for another depth), min and max in the input's type."""
    a = as_tensor(src)
    if rtype == REDUCE_MAX:
        return a.amax(dim=dim, keepdim=True)
    if rtype == REDUCE_MIN:
        return a.amin(dim=dim, keepdim=True)
    f64 = a.to(_F64)
    if rtype == REDUCE_SUM:
        r = f64.sum(dim=dim, keepdim=True)
    elif rtype == REDUCE_AVG:
        r = f64.mean(dim=dim, keepdim=True)
    elif rtype == REDUCE_SUM2:
        r = (f64 * f64).sum(dim=dim, keepdim=True)
    else:
        raise ValueError(rtype)
    return r.to(_F32) if dtype in (-1, K.CV_32F) else r


def _arg_reduce(src, axis: int, last: bool, fn):
    a = as_tensor(src)
    if last:
        idx = a.shape[axis] - 1 - fn(torch.flip(a, [axis]), dim=axis)
    else:
        idx = fn(a, dim=axis)
    return idx.to(torch.int32).unsqueeze(axis)


def reduceArgMax(src, axis: int, lastIndex: bool = False):
    return _arg_reduce(src, axis, lastIndex, torch.argmax)


def reduceArgMin(src, axis: int, lastIndex: bool = False):
    return _arg_reduce(src, axis, lastIndex, torch.argmin)


SORT_EVERY_ROW, SORT_EVERY_COLUMN = 0, 1
SORT_ASCENDING, SORT_DESCENDING = 0, 16


def _sort_axis(flags: int) -> int:
    return 1 if not (flags & SORT_EVERY_COLUMN) else 0


def sort(src, flags: int):  # noqa: A001
    ax = _sort_axis(flags)
    r = torch.sort(as_tensor(src), dim=ax, stable=True).values
    return torch.flip(r, [ax]) if flags & SORT_DESCENDING else r


def sortIdx(src, flags: int):
    ax = _sort_axis(flags)
    r = torch.sort(as_tensor(src), dim=ax, stable=True).indices
    if flags & SORT_DESCENDING:
        r = torch.flip(r, [ax])
    return r.to(torch.int32)


def findNonZero(src):
    """(x, y) int32 rows of the nonzero elements in row order, or None; the
    count is read back to the host."""
    nz = torch.nonzero(as_tensor(src))
    if nz.shape[0] == 0:
        return None
    return torch.stack([nz[:, 1], nz[:, 0]], dim=1).to(torch.int32)


def hasNonZero(src) -> bool:
    return bool(torch.any(as_tensor(src) != 0))


def checkRange(a, quiet: bool = True, minVal=-np.inf, maxVal=np.inf, pos=None) -> bool:
    arr = as_tensor(a).to(_F64)
    ok = not bool((~((arr >= minVal) & (arr < maxVal))).any())
    if not ok and not quiet:
        raise ValueError("checkRange failed")
    return ok


def patchNaNs(a, val: float = 0.0):
    arr = as_tensor(a).clone()
    if arr.is_floating_point():
        arr[torch.isnan(arr)] = val
    return arr


def extractChannel(src, coi: int):
    return _hwc(src)[:, :, coi].clone()


def insertChannel(src, dst, coi: int):
    d = _hwc(dst).clone()
    d[:, :, coi] = to_device(as_tensor(src), d.device)
    return d


def copyTo(src, mask=None, dst=None):
    a = as_tensor(src)
    if mask is None:
        return a.clone()
    m = to_device(as_tensor(mask), a.device) != 0
    if m.ndim < a.ndim:
        m = m[..., None]
    base = torch.zeros_like(a) if dst is None else to_device(as_tensor(dst), a.device)
    return torch.where(m, a, base)


GEMM_1_T, GEMM_2_T, GEMM_3_T = 1, 2, 4


def gemm(src1, src2, alpha, src3, beta, flags: int = 0):
    """alpha * op(src1) @ op(src2) + beta * op(src3) in f64, returned in
    src1's float type (f64 for integer input)."""
    a = as_tensor(src1)
    dt = a.dtype if a.is_floating_point() else _F64
    a = a.to(_F64)
    b = to_device(as_tensor(src2), a.device).to(_F64)
    if flags & GEMM_1_T:
        a = a.T
    if flags & GEMM_2_T:
        b = b.T
    r = alpha * (a @ b)
    if src3 is not None and as_tensor(src3).numel():
        c = to_device(as_tensor(src3), a.device).to(_F64)
        if flags & GEMM_3_T:
            c = c.T
        r = r + beta * c
    return r.to(dt)


COVAR_SCRAMBLED, COVAR_NORMAL = 0, 1
COVAR_USE_AVG, COVAR_SCALE, COVAR_ROWS, COVAR_COLS = 2, 4, 8, 16


def calcCovarMatrix(samples, mean=None, flags: int = 0, ctype=6):
    """(covariance, mean) in f64, the mean flattened."""
    a = as_tensor(samples).to(_F64)
    if flags & COVAR_COLS:
        a = a.T
    n = a.shape[0]
    if flags & COVAR_USE_AVG and mean is not None:
        mu = to_device(as_tensor(mean), a.device).to(_F64).reshape(1, -1)
    else:
        mu = a.mean(dim=0, keepdim=True)
    d = a - mu
    if flags & COVAR_SCRAMBLED and not (flags & COVAR_NORMAL):
        cov = d @ d.T
    else:
        cov = d.T @ d
    if flags & COVAR_SCALE:
        cov = cov / _scalar(float(n), _F64, cov.device)
    return cov, mu.reshape(-1)


def _to_complex(x):
    if x.ndim >= 3 and x.shape[-1] == 2:
        return torch.complex(x[..., 0], x[..., 1])
    return x.to(torch.complex64)


def divSpectrums(a, b, flags: int = 0, conjB: bool = False):
    """CCS-format spectrum division (core/src/dxt.cpp divSpectrums) as
    complex math on the arrays: a (..., 2) array is complex, anything else
    real, as ``opencv_tpu``'s mulSpectrums conventions take them.  Returns
    (..., 2) in a's dtype."""
    at = as_tensor(a)
    A = _to_complex(at.to(_F32))
    B = _to_complex(to_device(as_tensor(b), at.device).to(_F32))
    if conjB:
        B = torch.conj(B)
    mag = B.real ** 2 + B.imag ** 2
    mag = torch.where(mag == 0, 1.0, mag)
    C = A * torch.conj(B) / mag
    return torch.stack([C.real, C.imag], dim=-1).to(at.dtype)


# copy of opencv_tpu.ops.core_ops.fastAtan2
def fastAtan2(y: float, x: float) -> float:
    """cv::fastAtan2 — the reference's 7th-order polynomial in degrees."""
    P1 = 0.9997878412794807 * (180 / math.pi)
    P3 = -0.3258083974640975 * (180 / math.pi)
    P5 = 0.1555786518463281 * (180 / math.pi)
    P7 = -0.04432655554792128 * (180 / math.pi)
    ax, ay = abs(x), abs(y)
    eps = 2.220446049250313e-16
    c = ay / (ax + eps) if ax >= ay else ax / (ay + eps)
    c2 = c * c
    a = (((P7 * c2 + P5) * c2 + P3) * c2 + P1) * c
    if ax < ay:
        a = 90.0 - a
    if x < 0:
        a = 180.0 - a
    if y < 0:
        a = 360.0 - a
    return float(np.float32(a))


# copy of opencv_tpu.ops.core_ops.cubeRoot
def cubeRoot(val: float) -> float:
    v = float(val)
    return float(np.float32(np.sign(v) * abs(v) ** (1.0 / 3.0)))


# copy of opencv_tpu.ops.core_ops.clipLine
def clipLine(imgRect, pt1, pt2):
    """cv::clipLine (Liang-Barsky on the rect)."""
    if len(imgRect) == 2:   # imgSize form
        x0, y0, w, h = 0, 0, imgRect[0], imgRect[1]
    else:
        x0, y0, w, h = imgRect
    x1, y1 = float(pt1[0]), float(pt1[1])
    x2, y2 = float(pt2[0]), float(pt2[1])
    xmin, ymin, xmax, ymax = x0, y0, x0 + w - 1, y0 + h - 1
    t0, t1 = 0.0, 1.0
    dx, dy = x2 - x1, y2 - y1
    for p, q in ((-dx, x1 - xmin), (dx, xmax - x1),
                 (-dy, y1 - ymin), (dy, ymax - y1)):
        if p == 0:
            if q < 0:
                return False, tuple(map(int, pt1)), tuple(map(int, pt2))
        else:
            r = q / p
            # plain comparisons: this module's min and max are array ops
            if p < 0:
                t0 = r if r > t0 else t0
            else:
                t1 = r if r < t1 else t1
    if t0 > t1:
        return False, tuple(map(int, pt1)), tuple(map(int, pt2))
    nx1 = int(round(x1 + t0 * dx))
    ny1 = int(round(y1 + t0 * dy))
    nx2 = int(round(x1 + t1 * dx))
    ny2 = int(round(y1 + t1 * dy))
    return True, (nx1, ny1), (nx2, ny2)


def flipND(src, axis: int):
    return torch.flip(as_tensor(src), [axis])


def transposeND(src, order):
    return as_tensor(src).permute(*order).contiguous()


def broadcast(src, shape):
    """cv::broadcast — broadcasting to a 2D shape."""
    tgt = tuple(int(v) for v in np.asarray(_host(shape)).ravel())
    return as_tensor(src).broadcast_to(tgt).contiguous()


def finiteMask(src):
    """cv::finiteMask — 255 where finite, 0 at NaN/Inf."""
    m = torch.isfinite(as_tensor(src))
    if m.ndim == 3:
        m = m.all(dim=-1)
    return m.to(torch.uint8) * 255


# copy of opencv_tpu.ops.core_ops.solveLP
def solveLP(Func, Constr, constr_eps=1e-12):
    """cv::solveLP (core/src/lpsolver.cpp): maximize c·x subject to
    A·x <= b, x >= 0 — dense two-phase simplex.  Returns
    (status, x) with status in {0 single, 1 multiple, -1 unbounded,
    -2 infeasible} like SOLVELP_*."""
    c = np.asarray(_host(Func), np.float64).ravel()
    Ab = np.asarray(_host(Constr), np.float64)
    A, b = Ab[:, :-1], Ab[:, -1]
    m, n = A.shape
    T = np.zeros((m + 1, n + m + 1))
    T[:m, :n] = A
    T[:m, n:n + m] = np.eye(m)
    T[:m, -1] = b
    T[m, :n] = -c
    basis = list(range(n, n + m))
    for i in range(m):
        if T[i, -1] < 0:
            return -2, None   # the reference also rejects infeasible starts
    for _ in range(10000):
        j = int(np.argmin(T[m, :-1]))
        if T[m, j] >= -1e-12:
            break
        col = T[:m, j]
        if (col <= 1e-12).all():
            return -1, None
        ratios = np.where(col > 1e-12, T[:m, -1] / np.maximum(col, 1e-12), np.inf)
        i = int(np.argmin(ratios))
        T[i] /= T[i, j]
        for r in range(m + 1):
            if r != i:
                T[r] -= T[r, j] * T[i]
        basis[i] = j
    x = np.zeros(n + m)
    for i, bj in enumerate(basis):
        x[bj] = T[i, -1]
    # multiple solutions: a nonbasic structural var with zero reduced cost
    nonbasic = set(range(n)) - set(basis)
    multi = any(abs(T[m, j]) < 1e-12 for j in nonbasic)
    return (1 if multi else 0), x[:n].reshape(-1, 1)


# copy of opencv_tpu.ops.core_ops.buildMST
def buildMST(numNodes: int, inputEdges, algorithm: int = 0, root: int = 0):
    """cv::buildMST — Kruskal with duplicate-edge min-reduction and
    self-loop skipping.  Edges are (u, v, w) rows; returns (ok, edges)
    with the MST edge list."""
    edges = np.asarray(_host(inputEdges), np.float64).reshape(-1, 3)
    best = {}
    for u, v, w in edges:
        u, v = int(u), int(v)
        if u == v:
            continue
        if not (0 <= u < numNodes and 0 <= v < numNodes):
            return False, None
        key = (builtins.min(u, v), builtins.max(u, v))
        if key not in best or w < best[key]:
            best[key] = w
    parent = list(range(numNodes))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    out = []
    for (u, v), w in sorted(best.items(), key=lambda kv: kv[1]):
        ru, rv = find(u), find(v)
        if ru != rv:
            parent[ru] = rv
            out.append((u, v, w))
    if len(out) != numNodes - 1:
        return False, None
    return True, np.asarray(out, np.float64)
