"""Separable stencils on u8: the CUDA kernels ``csrc/sepfilter.cu`` and
``csrc/pyrdown.cu``, each with its plain PyTorch version.

Twin of ``opencv_tpu/kernels/sepfilter.py``:

- ``sep_filter_int`` / ``sep_filter_u8``, the Pallas kernel behind
  GaussianBlur, sepFilter2D, Sobel and boxFilter on u8.  Both dispatch
  registrations (``sep_filter_u8`` and ``sep_filter_int``) launch the same
  kernel, under the JAX package's predicates.
- ``pyr_down_u8``, the Pallas kernel behind pyrDown on u8, registered as
  ``pyr_down_u8``.

Each wrapper takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; it never falls back from one to the other.  Each
launch is also a custom op (``opencv_tpu_torch::sep_filter``,
``opencv_tpu_torch::pyr_down``) registered for CUDA only, with a fake
implementation that gives its output's shape and dtype: under
``torch.export`` the wrapper calls the op, so the exported program holds
the launch as an op call and launches the same kernel once loaded; eagerly
it calls the launch itself (the dispatcher's round trip through Python
costs about 0.1 ms of host time a call).
"""

from __future__ import annotations

import ctypes

import torch

from .. import constants as K
from ..core.borders import constant_vector, pad_nhwc
from ..core.dispatch import register
from ..core.fixedpoint import saturate_cast
from ._build import Kernel, stream_of

__all__ = ["SEP_FILTER", "PYR_DOWN", "SEP_ROUTES", "sep_correlate_int", "sep_filter_route",
           "sep_filter_int", "sep_filter_int_plain", "sep_filter_u8", "pyr_down_sum",
           "pyr_down_int_plain", "pyr_down_u8", "pyr_down_u8_plain"]

# sep_filter's routes (csrc/sepfilter.cu): the template at K = 3, 5 or 7, the
# box kernel (route 1) and the generic kernel (route 0), by the name each is
# counted under
SEP_ROUTES = {3: "k3", 5: "k5", 7: "k7", 1: "box", 0: "generic"}

_vp, _i, _ip = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
SEP_FILTER = Kernel("opencv_sep_filter",
                    [_vp, _vp, _i, _i, _i, _i, _ip, _i, _ip, _i, _i, _i, _i,
                     ctypes.c_float, _i, _ip, _i, _i, _vp], routes=tuple(SEP_ROUTES.values()))
PYR_DOWN = Kernel("opencv_pyr_down", [_vp, _vp, _i, _i, _i, _i, _i, _vp])

_OUT_DTYPES = {"uint8": torch.uint8, "int16": torch.int16}


def _out_dtype(out_dtype) -> torch.dtype:
    return _OUT_DTYPES.get(out_dtype, out_dtype) if isinstance(out_dtype, str) else out_dtype


def sep_correlate_int(x, kx, ky, border, border_value=0):
    """Bit-exact separable correlate in int32, no intermediate rounding —
    ``opencv_tpu/ops/filter.py::_sep_correlate_int``.  Returns the int32
    (N,H,W,C) accumulator."""
    kw, kh = len(kx), len(ky)
    ax, ay = kw // 2, kh // 2
    xi = pad_nhwc(x, ay, kh - 1 - ay, ax, kw - 1 - ax, border, border_value).to(torch.int32)
    N, H, W, C = x.shape
    h = None
    for i, c in enumerate(kx):
        term = xi[:, :, i:i + W, :] * int(c)
        h = term if h is None else h + term
    v = None
    for j, c in enumerate(ky):
        term = h[:, j:j + H, :, :] * int(c)
        v = term if v is None else v + term
    return v


def sep_filter_int_plain(x, kx, ky, shift: int = 0, delta: int = 0, scale=None,
                         out_dtype=torch.uint8, border: int = K.BORDER_DEFAULT,
                         border_value=0):
    """Plain PyTorch version of the kernel, on any device: the int32
    correlation, then ``(acc + 2^(shift-1)) >> shift``, ``+ delta``,
    ``rint(f32(acc) * f32(scale))`` and the saturate."""
    v = sep_correlate_int(x, kx, ky, border, border_value)
    if shift > 0:
        v = (v + (1 << (shift - 1))) >> shift
    if delta:
        v = v + int(delta)
    if scale is not None:
        v = torch.round(v.to(torch.float32) * torch.tensor(scale, dtype=torch.float32))
    return saturate_cast(v, _out_dtype(out_dtype))


def sep_filter_route(kx, ky) -> int:
    """The CUDA route of a ``sep_filter`` launch (``csrc/sepfilter.cu``):
    K (3, 5 or 7) when kw == kh == K and sum |kx| * 255 < 2^16, so the
    template's 16-bit horizontal sums cannot carry; else 1 (the box kernel)
    when the kx are all one value and the ky all one value; else 0 (the
    generic kernel).  The entry refuses taps that the route it is given
    does not take."""
    kx, ky = [int(v) for v in kx], [int(v) for v in ky]
    k = len(kx)
    if k == len(ky) and k in (3, 5, 7) and sum(abs(v) for v in kx) * 255 < 1 << 16:
        return k
    if len(set(kx)) == 1 and len(set(ky)) == 1:
        return 1
    return 0


def _check(x):
    if x.dtype != torch.uint8 or x.ndim != 4:
        raise ValueError(f"sep_filter: expected (N,H,W,C) uint8, got {tuple(x.shape)} {x.dtype}")


def _sep_filter_launch(x, kx, ky, shift, delta, scale, out_int16, border, bval):
    """One launch of ``csrc/sepfilter.cu`` on (N,H,W,C) u8 `x` (the checks
    are the wrapper's), counted in ``SEP_FILTER``."""
    N, H, W, C = x.shape
    x = x.contiguous()
    out = torch.empty((N, H, W, C), dtype=torch.int16 if out_int16 else torch.uint8,
                      device=x.device)
    k = sep_filter_route(kx, ky)
    SEP_FILTER(
        x.device, x.data_ptr(), out.data_ptr(), N, H, W, C,
        (ctypes.c_int * len(kx))(*kx), len(kx), (ctypes.c_int * len(ky))(*ky), len(ky),
        shift, delta, int(scale is not None), scale if scale is not None else 0.0,
        border, (ctypes.c_int * 4)(*bval), int(out_int16), k, stream_of(x),
        route=SEP_ROUTES[k])
    return out


_sep_filter_op = torch.library.custom_op(
    "opencv_tpu_torch::sep_filter", _sep_filter_launch, mutates_args=(), device_types="cuda",
    schema="(Tensor x, int[] kx, int[] ky, int shift, int delta, float? scale, bool out_int16, "
           "int border, int[] bval) -> Tensor")


@_sep_filter_op.register_fake
def _(x, kx, ky, shift, delta, scale, out_int16, border, bval):
    return torch.empty_like(x, dtype=torch.int16 if out_int16 else torch.uint8,
                            memory_format=torch.contiguous_format)


def sep_filter_int(x, kx, ky, shift: int = 0, delta: int = 0, scale=None,
                   out_dtype=torch.uint8, border: int = K.BORDER_DEFAULT,
                   border_value=0):
    """x: (N,H,W,C) u8.  Separable integer correlation with the full
    finishing chain:  acc = Σ ky ⊗ kx · x  (int32);
    shift>0 → (acc + 2^(shift-1)) >> shift;  +delta;
    scale → rint(acc·scale);  saturate to out_dtype (u8 or i16).

    kx/ky: sequences of ints (anchor = center), each at most 31 long."""
    _check(x)
    out_dtype = _out_dtype(out_dtype)
    if x.device.type == "cpu":
        return sep_filter_int_plain(x, kx, ky, shift, delta, scale, out_dtype, border,
                                    border_value)
    if x.device.type != "cuda":
        raise RuntimeError(f"sep_filter: no kernel for device {x.device}")
    if out_dtype not in (torch.uint8, torch.int16):
        raise ValueError(f"sep_filter: out_dtype {out_dtype} is not uint8 or int16")
    C = x.shape[3]
    bval = [int(v) for v in constant_vector(border_value, C)] + [0] * (4 - C)
    launch = _sep_filter_op if torch.compiler.is_exporting() else _sep_filter_launch
    return launch(x, [int(v) for v in kx], [int(v) for v in ky], int(shift), int(delta),
                  None if scale is None else float(scale), out_dtype == torch.int16,
                  border & ~K.BORDER_ISOLATED, bval)


def sep_filter_u8(x, kx, ky, shift: int, border: int = K.BORDER_DEFAULT, border_value=0):
    """u8 → u8 separable Q·Q correlation
    `clip((Σ ky⊗kx · x + 2^(shift-1)) >> shift, 0, 255)`."""
    return sep_filter_int(x, kx, ky, shift=shift, out_dtype=torch.uint8, border=border,
                          border_value=border_value)


# ---------------------------------------------------------------------------
# pyrDown: {1,4,6,4,1} x {1,4,6,4,1} with 2:1 decimation
# ---------------------------------------------------------------------------

_PD_K = (1, 4, 6, 4, 1)


def pyr_down_sum(x, border: int, dtype: torch.dtype):
    """Σ {1,4,6,4,1}⊗{1,4,6,4,1} · x at the even rows and columns, in
    `dtype`, unrounded: the accumulator of ``cv::pyrDown``
    (``opencv_tpu/ops/pyramids.py::_pyr_down_nhwc``).  (N,H,W,C) →
    (N,(H+1)/2,(W+1)/2,C)."""
    N, H, W, C = x.shape
    dh, dw = (H + 1) // 2, (W + 1) // 2
    # pad enough for window [2d-2, 2d+2] with d up to dh-1 (2d can be H for odd H)
    pad_b = 2 * (dh - 1) + 2 - (H - 1)
    pad_r = 2 * (dw - 1) + 2 - (W - 1)
    xa = pad_nhwc(x, 2, pad_b, 2, pad_r, border).to(dtype)
    h = None
    for i, c in enumerate(_PD_K):
        t = xa[:, :, i:i + 2 * (dw - 1) + 1:2, :] * c
        h = t if h is None else h + t
    v = None
    for j, c in enumerate(_PD_K):
        t = h[:, j:j + 2 * (dh - 1) + 1:2, :, :] * c
        v = t if v is None else v + t
    return v


def _check_pyr(x, border: int) -> int:
    if x.dtype != torch.uint8 or x.ndim != 4 or not 1 <= x.shape[3] <= 4:
        raise ValueError(f"pyr_down: expected (N,H,W,C<=4) uint8, got {tuple(x.shape)} {x.dtype}")
    bt = border & ~K.BORDER_ISOLATED
    if bt not in (K.BORDER_REPLICATE, K.BORDER_REFLECT, K.BORDER_WRAP, K.BORDER_REFLECT_101):
        raise ValueError(f"pyr_down: unsupported border {border} (cv::pyrDown refuses "
                         "BORDER_CONSTANT)")
    return bt


def pyr_down_int_plain(x, border: int):
    """The integer pyrDown of any integer dtype and channel count:
    ``saturate((Σ + 128) >> 8)`` with the int32 sum of ``pyr_down_sum``."""
    return saturate_cast((pyr_down_sum(x, border, torch.int32) + 128) >> 8, x.dtype)


def pyr_down_u8_plain(x, border: int = K.BORDER_DEFAULT):
    """Plain PyTorch version of the kernel, on any device.  It accumulates
    in int32 where the JAX package uses uint16 (torch has almost no uint16
    arithmetic); the maximum, 256·255 + 128, fits both, so the integers are
    the same."""
    return pyr_down_int_plain(x, _check_pyr(x, border))


def _pyr_down_launch(x, border):
    """One launch of ``csrc/pyrdown.cu`` on (N,H,W,C) u8 `x`, counted in
    ``PYR_DOWN``."""
    N, H, W, C = x.shape
    x = x.contiguous()
    out = torch.empty((N, (H + 1) // 2, (W + 1) // 2, C), dtype=torch.uint8, device=x.device)
    PYR_DOWN(x.device, x.data_ptr(), out.data_ptr(), N, H, W, C, border, stream_of(x))
    return out


_pyr_down_op = torch.library.custom_op(
    "opencv_tpu_torch::pyr_down", _pyr_down_launch, mutates_args=(), device_types="cuda",
    schema="(Tensor x, int border) -> Tensor")


@_pyr_down_op.register_fake
def _(x, border):
    N, H, W, C = x.shape
    return x.new_empty((N, (H + 1) // 2, (W + 1) // 2, C))


def pyr_down_u8(x, border: int = K.BORDER_DEFAULT):
    """`cv::pyrDown` 8U: (N,H,W,C) u8 → (N,(H+1)/2,(W+1)/2,C) u8,
    {1,4,6,4,1}⊗{1,4,6,4,1} with 2:1 decimation and ``(v + 128) >> 8``
    (pyramids.cpp:488).  The border defaults to REFLECT_101."""
    bt = _check_pyr(x, border)
    if x.device.type == "cpu":
        return pyr_down_u8_plain(x, bt)
    if x.device.type != "cuda":
        raise RuntimeError(f"pyr_down: no kernel for device {x.device}")
    return (_pyr_down_op if torch.compiler.is_exporting() else _pyr_down_launch)(x, bt)


# ---------------------------------------------------------------------------
# dispatch registrations (predicates of opencv_tpu/kernels/sepfilter.py)
# ---------------------------------------------------------------------------

def _tile_ok(ctx):
    return (ctx.get("dtype") == "uint8" and ctx.get("kw", 99) <= 31
            and ctx.get("kh", 99) <= 31
            and 1 <= ctx.get("channels", 1) <= 4)


def _sep_pred(ctx):
    return _tile_ok(ctx) and ctx.get("shift", 0) >= 1


@register("sep_filter_u8", _sep_pred)
def _sep_filter_u8_kernel(ctx, x, kx, ky):
    return sep_filter_u8(x, kx, ky, ctx["shift"],
                         border=ctx.get("border", K.BORDER_DEFAULT),
                         border_value=ctx.get("border_value", 0))


def _sep_int_pred(ctx):
    if not _tile_ok(ctx):
        return False
    # int32 accumulator headroom
    if ctx.get("max_abs_acc", 1 << 31) >= (1 << 31):
        return False
    return ctx.get("out") in ("uint8", "int16")


@register("sep_filter_int", _sep_int_pred)
def _sep_filter_int_kernel(ctx, x, kx, ky):
    return sep_filter_int(
        x, kx, ky, shift=ctx.get("shift", 0), delta=ctx.get("delta", 0),
        scale=ctx.get("scale"), out_dtype=ctx["out"],
        border=ctx.get("border", K.BORDER_DEFAULT),
        border_value=ctx.get("border_value", 0))


def _pyrdown_pred(ctx):
    # The JAX predicate also asks for h, w >= 16 (its tiles' minimum); the
    # CUDA kernel resolves the border in its own edge blocks and takes any
    # size.
    return ctx.get("dtype") == "uint8" and 1 <= ctx.get("channels", 1) <= 4


@register("pyr_down_u8", _pyrdown_pred)
def _pyr_down_u8_kernel(ctx, x):
    return pyr_down_u8(x, border=ctx.get("border", K.BORDER_DEFAULT))
