"""DFT / DCT / spectrum ops (core/src/dxt.cpp), Gabor kernels and the
accumulate family (imgproc/src/accum.cpp, gabor.cpp); twin of
``opencv_tpu/ops/transform.py``.

The transforms run on the input's device through ``torch.fft`` in the
input's depth: f64 input goes through complex128 and stays f64, as in cv2
(the JAX package computes every DFT in complex64 and returns f32).  Complex
arrays carry a trailing axis of 2.  A real 2-D input packs its spectrum in
the reference's CCS layout (dxt.cpp), and an inverse of a CCS array unpacks
it; the layout is an index table built on the host once per size and
applied on the device with one gather.  With DFT_ROWS each row is packed
as a 1-D CCS row, as cv2 packs it (the JAX package returns the complex
spectrum there).  ``mulSpectrums`` of two CCS arrays multiplies their
spectra and packs the product, as cv2 does.  ``dct``/``idct`` are the
orthonormal DCT-II/III built from one FFT per axis (Makhoul's reordering).
``getOptimalDFTSize`` and ``getGaborKernel`` keep the JAX package's host
code, copied.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core.arrays import as_tensor, from_batched, to_batched, to_device

__all__ = ["dft", "idft", "dct", "idct", "mulSpectrums",
           "getOptimalDFTSize", "getGaborKernel",
           "accumulate", "accumulateSquare", "accumulateProduct",
           "accumulateWeighted",
           "DFT_INVERSE", "DFT_SCALE", "DFT_ROWS", "DFT_COMPLEX_OUTPUT",
           "DFT_REAL_OUTPUT", "DFT_COMPLEX_INPUT",
           "DCT_INVERSE", "DCT_ROWS"]

DFT_INVERSE = 1
DFT_SCALE = 2
DFT_ROWS = 4
DFT_COMPLEX_OUTPUT = 16
DFT_REAL_OUTPUT = 32
DFT_COMPLEX_INPUT = 64
DCT_INVERSE = DFT_INVERSE
DCT_ROWS = DFT_ROWS


def _real_dtype(x: torch.Tensor) -> torch.dtype:
    """The float depth a transform works in: f64 for f64 input, else f32."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _to_complex(x: torch.Tensor) -> torch.Tensor:
    """A trailing axis of 2 as a complex tensor; anything else as a real one
    (complex with zero imaginary part)."""
    rd = _real_dtype(x)
    if x.ndim >= 3 and x.shape[-1] == 2:
        return torch.complex(x[..., 0].to(rd), x[..., 1].to(rd))
    return x.to(rd).to(torch.complex128 if rd == torch.float64 else torch.complex64)


def _from_complex(z: torch.Tensor) -> torch.Tensor:
    return torch.stack([z.real, z.imag], dim=-1)


# ------------------------------------------------------------------ CCS

@functools.lru_cache(maxsize=32)
def _ccs_layout(M: int, N: int):
    """The CCS layout of the (M, N) spectrum of a real input (dxt.cpp), as
    three int64 (M, N) tables:

    - ``pack``: entry (r, c) of the packed array is entry ``pack[r, c]`` of
      ``cat(Re F, Im F)`` flattened (``part * M * N + row * N + col``);
    - ``re``, ``im``: entry (r, c) of F takes ``P_ext[re[r, c]]`` as its real
      part and ``sign(im) * P_ext[|im[r, c]|]`` as its imaginary part, where
      ``P_ext`` is the packed array flattened behind one 0 (an entry packed
      neither itself nor as its conjugate mirror is 0).

    Columns 0 and, for even N, N/2 are packed down the column (the real
    part of row 0, then real and imaginary pairs, then for even M the real
    part of row M/2); columns 1..(N-1)/2 as a real and an imaginary column
    each.  This is the JAX package's ``_ccs_pack``/``_ccs_unpack``."""
    MN = M * N
    pack = np.empty((M, N), np.int64)

    def code(part, rows, col):
        return part * MN + rows * N + col

    def pack_col(dst, col):
        half = (M - 1) // 2
        i = np.arange(1, half + 1)
        pack[0, dst] = code(0, 0, col)
        pack[2 * i - 1, dst] = code(0, i, col)
        pack[2 * i, dst] = code(1, i, col)
        if M % 2 == 0:
            pack[M - 1, dst] = code(0, M // 2, col)

    rows = np.arange(M)
    pack_col(0, 0)
    for k in range(1, (N - 1) // 2 + 1):
        pack[:, 2 * k - 1] = code(0, rows, k)
        pack[:, 2 * k] = code(1, rows, k)
    if N % 2 == 0:
        pack_col(N - 1, N // 2)

    # where each part of F sits in the packed array (+1: P_ext's offset)
    pos = np.zeros(2 * MN, np.int64)
    pos[pack.ravel()] = np.arange(1, MN + 1)
    re_pos, im_pos = pos[:MN].reshape(M, N), pos[MN:].reshape(M, N)
    mr, mc = (-rows) % M, (-np.arange(N)) % N
    re_mirror = re_pos[mr][:, mc]
    im_mirror = im_pos[mr][:, mc]
    re = np.where(re_pos > 0, re_pos, re_mirror)
    im = np.where(im_pos > 0, im_pos, -im_mirror)
    return pack.ravel(), re.ravel(), im.ravel()


def _ccs_tables(M: int, N: int, device):
    return tuple(to_device(t, device) for t in _ccs_layout(M, N))


def _ccs_pack(F: torch.Tensor) -> torch.Tensor:
    """(..., M, N) complex spectrum of a real input → (..., M, N) CCS."""
    M, N = F.shape[-2:]
    pack, _, _ = _ccs_tables(M, N, F.device)
    flat = torch.cat([F.real.reshape(*F.shape[:-2], M * N),
                      F.imag.reshape(*F.shape[:-2], M * N)], dim=-1)
    return flat.index_select(-1, pack).reshape(F.shape)


def _ccs_unpack(P: torch.Tensor) -> torch.Tensor:
    """(..., M, N) real CCS array → (..., M, N) complex spectrum."""
    M, N = P.shape[-2:]
    _, re, im = _ccs_tables(M, N, P.device)
    rd = _real_dtype(P)
    flat = P.to(rd).reshape(*P.shape[:-2], M * N)
    ext = torch.cat([torch.zeros_like(flat[..., :1]), flat], dim=-1)
    f_re = ext.index_select(-1, re)
    f_im = ext.index_select(-1, im.abs()) * torch.sign(im).to(rd)
    return torch.complex(f_re, f_im).reshape(P.shape)


def _rows_as_planes(x: torch.Tensor) -> torch.Tensor:
    """(M, N) → (M, 1, N): each row a 1-row plane, for DFT_ROWS packing."""
    return x.reshape(x.shape[0], 1, x.shape[1])


def dft(src, flags: int = 0, nonzeroRows: int = 0):
    """`cv::dft`. Real 2-D input packs the spectrum in CCS unless
    DFT_COMPLEX_OUTPUT is given (per row with DFT_ROWS); the inverse of a
    real 2-D (CCS) array unpacks it, and returns the real part unless
    DFT_COMPLEX_OUTPUT is given.  ``nonzeroRows`` is ignored."""
    x = as_tensor(src)
    rows = bool(flags & DFT_ROWS)
    dims = (-1,) if rows else (-2, -1)
    real_in = x.ndim == 2 or (x.ndim == 3 and x.shape[-1] == 1)
    ccs = real_in and x.ndim == 2
    if flags & DFT_INVERSE:
        if ccs and not flags & DFT_COMPLEX_INPUT:
            z = (_ccs_unpack(_rows_as_planes(x)).reshape(x.shape) if rows
                 else _ccs_unpack(x))
        else:
            z = _to_complex(x)
        # cv2's idft without DFT_SCALE is unnormalised
        out = torch.fft.ifftn(z, dim=dims, norm="backward" if flags & DFT_SCALE else "forward")
        if flags & DFT_REAL_OUTPUT or (real_in and not flags & (DFT_COMPLEX_OUTPUT
                                                                 | DFT_COMPLEX_INPUT)):
            return out.real
        return _from_complex(out)
    z = _to_complex(x)
    out = torch.fft.fftn(z, dim=dims, norm="forward" if flags & DFT_SCALE else "backward")
    if ccs and not flags & DFT_COMPLEX_OUTPUT:
        return _ccs_pack(_rows_as_planes(out)).reshape(x.shape) if rows else _ccs_pack(out)
    return _from_complex(out)


def idft(src, flags: int = 0, nonzeroRows: int = 0):
    return dft(src, flags | DFT_INVERSE, nonzeroRows)


def _dct_last(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Orthonormal DCT-II (or its inverse, DCT-III) along the last axis from
    one complex FFT of the even/odd reordering (Makhoul 1980)."""
    n = x.shape[-1]
    cd = torch.complex128 if x.dtype == torch.float64 else torch.complex64
    k = torch.arange(n, dtype=torch.float64, device=x.device)
    scale = torch.full((n,), math.sqrt(2.0 / n), dtype=torch.float64, device=x.device)
    scale[0] = math.sqrt(1.0 / n)
    twiddle = torch.polar(torch.ones_like(k), -math.pi * k / (2 * n))
    if not inverse:
        v = torch.cat([x[..., 0::2], x[..., 1::2].flip(-1)], dim=-1)
        V = torch.fft.fft(v.to(cd), dim=-1)
        return (V * twiddle.to(cd)).real * scale.to(x.dtype)
    y = x / scale.to(x.dtype)
    y_mirror = torch.cat([torch.zeros_like(y[..., :1]), y[..., 1:].flip(-1)], dim=-1)
    V = torch.complex(y, -y_mirror).to(cd) * twiddle.conj().to(cd)
    v = torch.fft.ifft(V, dim=-1).real
    h = (n + 1) // 2
    out = torch.empty_like(v)
    out[..., 0::2] = v[..., :h]
    out[..., 1::2] = v[..., h:].flip(-1)
    return out


def dct(src, flags: int = 0):
    """`cv::dct`: the orthonormal DCT-II over both axes (or each row with
    DCT_ROWS), its inverse with DCT_INVERSE; f64 stays f64, anything else
    is taken in f32."""
    x = as_tensor(src)
    x = x.to(_real_dtype(x))
    dims = [-1] if flags & DCT_ROWS else [-2, -1]
    inverse = bool(flags & DCT_INVERSE)
    for d in dims:
        x = _dct_last(x.movedim(d, -1), inverse).movedim(-1, d)
    return x.contiguous()


def idct(src, flags: int = 0):
    return dct(src, flags | DCT_INVERSE)


def mulSpectrums(a, b, flags: int = 0, conjB: bool = False):
    """`cv::mulSpectrums`: the per-element product of two complex spectra
    (trailing axis of 2), or of two real 2-D CCS arrays, packed back into
    CCS (per row with DFT_ROWS), as cv2 multiplies them."""
    x, y = as_tensor(a), as_tensor(b)
    y = to_device(y, x.device)
    if x.ndim == 2:
        rows = bool(flags & DFT_ROWS)
        xs, ys = (_rows_as_planes(x), _rows_as_planes(y)) if rows else (x, y)
        za, zb = _ccs_unpack(xs), _ccs_unpack(ys)
        return _ccs_pack(za * (zb.conj() if conjB else zb)).reshape(x.shape)
    za, zb = _to_complex(x), _to_complex(y)
    return _from_complex(za * (zb.conj() if conjB else zb))


def getOptimalDFTSize(vecsize: int) -> int:
    """Smallest 2^p·3^q·5^r ≥ vecsize (dxt.cpp getOptimalDFTSize)."""
    if vecsize <= 0:
        return 1
    n = vecsize
    while True:
        m = n
        while m % 2 == 0:
            m //= 2
        while m % 3 == 0:
            m //= 3
        while m % 5 == 0:
            m //= 5
        if m == 1:
            return n
        n += 1


def getGaborKernel(ksize, sigma: float, theta: float, lambd: float,
                   gamma: float, psi: float = math.pi * 0.5,
                   ktype=np.float64):
    """Host twin of `cv::getGaborKernel` (imgproc/src/gabor.cpp)."""
    sigma_x = sigma
    sigma_y = sigma / gamma
    c, s = math.cos(theta), math.sin(theta)
    if ksize[0] > 0:
        xmax = ksize[0] // 2
    else:
        xmax = int(np.rint(max(abs(3 * sigma_x * c), abs(3 * sigma_y * s))))
    if ksize[1] > 0:
        ymax = ksize[1] // 2
    else:
        ymax = int(np.rint(max(abs(3 * sigma_x * s), abs(3 * sigma_y * c))))
    xs = np.arange(-xmax, xmax + 1)
    ys = np.arange(-ymax, ymax + 1)
    X, Y = np.meshgrid(xs, ys)
    xr = X * c + Y * s
    yr = -X * s + Y * c
    ex = -0.5 / (sigma_x * sigma_x)
    ey = -0.5 / (sigma_y * sigma_y)
    cscale = 2 * math.pi / lambd
    k = np.exp(ex * xr * xr + ey * yr * yr) * np.cos(cscale * xr + psi)
    # the reference stores kernel(ymax - y, xmax - x) — a 180° flip
    k = k[::-1, ::-1]
    return k.astype(np.dtype(ktype) if not isinstance(ktype, int) else np.float64)


# ------------------------------------------------------------- accumulate
# dst's dtype is the accumulator; the expressions are the JAX package's, in
# its order, one op at a time, so the card, the CPU and opencv_tpu agree bit
# for bit in f32.  The result is returned (dst is not written).

def _masked(out, d, mask):
    if mask is None:
        return out
    m, _ = to_batched(mask)
    return torch.where(to_device(m, d.device) != 0, out, d)


def _operands(dst, *srcs):
    d, meta = to_batched(dst)
    return d, meta, [to_device(to_batched(s)[0], d.device).to(d.dtype) for s in srcs]


def accumulate(src, dst, mask=None):
    d, meta, (x,) = _operands(dst, src)
    return from_batched(_masked(d + x, d, mask), meta)


def accumulateSquare(src, dst, mask=None):
    d, meta, (x,) = _operands(dst, src)
    return from_batched(_masked(d + x * x, d, mask), meta)


def accumulateProduct(src1, src2, dst, mask=None):
    d, meta, (x, y) = _operands(dst, src1, src2)
    return from_batched(_masked(d + x * y, d, mask), meta)


def accumulateWeighted(src, dst, alpha: float, mask=None):
    d, meta, (x,) = _operands(dst, src)
    a = torch.full((), alpha, dtype=d.dtype, device=d.device)
    return from_batched(_masked(d * (1 - a) + x * a, d, mask), meta)
