"""Build and load the port's native host tails (``native/hosttails.cpp``).

At the first call, one ``g++ -O3 -shared -fPIC -std=c++17`` compiles the
source into ``opencv_tpu_torch/_build/`` under a name that carries a hash of
the source and the flags, so an edit rebuilds and an unchanged tree reuses
the file.  It is written to a temporary name and moved into place with
``os.replace``, so processes that build at the same time never load a
half-written file.  The compiler is ``$CXX``, else ``g++``.  A missing
compiler or a failed build raises: nothing falls back to Python.

Every pointer is declared ``c_void_p`` (an undeclared Python int is passed
as a 32-bit C int and cuts the pointer).  ctypes releases the GIL for the
length of a call, so floods of several frames run in parallel threads.

The functions take and return host numpy arrays:

- :func:`suzuki_contours` — findContours' border following;
- :func:`flood_fill` — the u8 flood fill, in place;
- :func:`maxflow_grid` — GrabCut's min cut on the 8-neighbour grid;
- :func:`watershed` — the marker-controlled flood, in place;
- :func:`mser_detect` — MSER's stable regions of one polarity;
- :func:`filter_speckles` — filterSpeckles' small blobs of similar values;

and the codecs' entropy loops (``imgcodecs/``), each raising where the C
code reports a corrupt stream or a full buffer:

- :func:`jpeg_decode_blocks`, :func:`jpeg_encode_blocks` — baseline JPEG's
  Huffman coder;
- :func:`ebcot_t1_decode`, :func:`ebcot_t1_encode` — JPEG 2000's EBCOT
  tier-1 of one code-block;
- :func:`hfyu_decode_syms`, :func:`hfyu_encode_syms` — HuffYUV's symbols;
- :func:`ffv1_decode_slice`, :func:`ffv1_encode_slice` — FFV1's Golomb-Rice
  slice coder, its contexts in the caller's arrays;
- :func:`crc32_msb` — FFV1's CRC.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["CXX_FLAGS", "library", "suzuki_contours", "flood_fill", "maxflow_grid",
           "watershed", "mser_detect", "filter_speckles", "jpeg_decode_blocks",
           "jpeg_encode_blocks", "ebcot_t1_decode", "ebcot_t1_encode", "hfyu_decode_syms",
           "hfyu_encode_syms", "ffv1_decode_slice", "ffv1_encode_slice", "crc32_msb"]

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "hosttails.cpp"
BUILD_DIR = _DIR.parent / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_L = ctypes.c_long
_I64 = ctypes.c_int64
# (restype, argtypes) of each entry point
_SIGNATURES = {
    "suzuki_contours": (_I, [_P, _I, _I, _P, ctypes.c_int64, _P, _P, _P, ctypes.c_int32]),
    "flood_fill_u8": (ctypes.c_int64, [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _I, _I,
                                       ctypes.c_uint8, _P]),
    "maxflow_grid": (ctypes.c_double, [_I, _I, _P, _P, _P, _P, _P, _P, _P]),
    "watershed_u8c3": (ctypes.c_int, [_P, _P, _I, _I]),
    "mser_detect": (_I, [_P, _I, _I, _I, _I, _I, ctypes.c_double, ctypes.c_double, _P, _P, _I]),
    "filter_speckles_i32": (ctypes.c_int64, [_P, _I, _I, ctypes.c_int32, ctypes.c_int64,
                                             ctypes.c_int64]),
    "jpeg_decode_blocks": (_LL, [_P, _LL, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _P, _P, _P, _P, _P, _P]),
    "jpeg_encode_blocks": (_LL, [_P, _P, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _LL]),
    "ebcot_t1_decode": (_I, [_P, _I, _I, _I, _I, _I, _I, _P]),
    "ebcot_t1_encode": (_I, [_P, _I, _I, _I, _P, _I, _P, _P]),
    "hfyu_decode_syms": (_I, [_P, _L, _P, _L, _P]),
    "hfyu_encode_syms": (_L, [_P, _L, _P, _P, _L]),
    "crc32_msb": (ctypes.c_uint32, [_P, _I64, ctypes.c_uint32]),
    "ffv1_decode_slice": (_I64, [_P, _I64, _I, _I, _I, _I, _P, _P, _P, _P, ctypes.c_int32,
                                 _P, _P]),
    "ffv1_encode_slice": (_I64, [_P, _I, _I, _I, _I, _P, _P, _P, _P, ctypes.c_int32, _P, _P,
                                 _I64]),
}

_lock = threading.Lock()
_lib = None


def _compiler() -> str:
    for cand in (os.environ.get("CXX"), "g++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no C++ compiler ($CXX, g++): the native host tails cannot be built")


def _library_path(cxx: str) -> Path:
    h = hashlib.sha256(" ".join([os.path.basename(cxx), *CXX_FLAGS]).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libhosttails_{h.hexdigest()[:16]}.so"


def _build(so: Path, cxx: str) -> None:
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = BUILD_DIR / f"{so.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so"
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}) on {SOURCE}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)


def library() -> ctypes.CDLL:
    """The loaded host-tail library, built first if this tree has no copy."""
    global _lib
    with _lock:
        if _lib is None:
            cxx = _compiler()
            so = _library_path(cxx)
            if not so.exists():
                _build(so, cxx)
            lib = ctypes.CDLL(str(so))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib


def suzuki_contours(binary: np.ndarray):
    """Suzuki-Abe border following of the (H, W) image (nonzero is
    foreground): ``(points, parents, is_outer)``, one (k, 2) int32 array of
    (x, y) per border in the order the raster scan finds them.

    The buffers start at the JAX package's sizes; a scan that overruns them
    returns n < 0 and runs again with both doubled, up to H*W + 1 borders
    and 16 times the first point buffer, past which it raises."""
    f = np.ascontiguousarray(binary != 0, np.uint8)
    H, W = f.shape
    max_pts = max(4 * H * W, 1024)
    max_ctrs = max(H * W // 2, 64)
    # every border starts at a pixel of its own
    ctr_cap = H * W + 1
    pts_cap = 16 * max_pts
    while True:
        pts = np.empty((max_pts, 2), np.int32)
        starts = np.empty(max_ctrs + 1, np.int32)
        parents = np.empty(max_ctrs, np.int32)
        is_outer = np.empty(max_ctrs, np.uint8)
        n = library().suzuki_contours(f.ctypes.data, H, W, pts.ctypes.data, max_pts,
                                      starts.ctypes.data, parents.ctypes.data,
                                      is_outer.ctypes.data, max_ctrs)
        if n >= 0:
            break
        if max_pts >= pts_cap and max_ctrs >= ctr_cap:
            raise RuntimeError(f"suzuki_contours: {H}x{W} overran {max_pts} points and "
                               f"{max_ctrs} contours")
        max_pts = min(2 * max_pts, pts_cap)
        max_ctrs = min(2 * max_ctrs, ctr_cap)
    out = np.split(pts[:starts[n]].copy(), starts[1:n]) if n else []
    return out, parents[:n].copy(), is_outer[:n].astype(bool)


def flood_fill(img: np.ndarray, mask: np.ndarray, seed, new_val, lo, up, conn: int,
               fixed_range: bool, mask_only: bool, mask_val: int):
    """Flood-fill the (H, W) or (H, W, C) u8 `img` and its (H+2, W+2) u8
    `mask` in place from `seed` (x, y); ``(count, rect)``."""
    a = img if img.flags.c_contiguous else np.ascontiguousarray(img)
    if not mask.flags.c_contiguous or mask.dtype != np.uint8:
        raise ValueError("flood_fill: the mask must be a contiguous u8 array")
    C = a.shape[2] if a.ndim == 3 else 1
    nv = np.resize(np.asarray(new_val, np.uint8).reshape(-1)[:C], C)
    lo = np.resize(np.asarray(lo, np.float64).reshape(-1)[:C], C)
    up = np.resize(np.asarray(up, np.float64).reshape(-1)[:C], C)
    rect = np.zeros(4, np.int32)
    count = library().flood_fill_u8(
        a.ctypes.data, mask.ctypes.data, a.shape[0], a.shape[1], C, int(seed[0]), int(seed[1]),
        nv.ctypes.data, lo.ctypes.data, up.ctypes.data, conn, int(fixed_range), int(mask_only),
        mask_val, rect.ctypes.data)
    if a is not img:
        img[...] = a
    return int(count), tuple(int(v) for v in rect)


def maxflow_grid(srcw, snkw, leftw, upleftw, upw, uprightw) -> np.ndarray:
    """The minimum cut of GrabCut's grid graph: the (H, W) bool source side,
    from the f64 terminal capacities and the four symmetric n-link planes."""
    H, W = srcw.shape
    arrs = [np.ascontiguousarray(a, np.float64)
            for a in (srcw, snkw, leftw, upleftw, upw, uprightw)]
    out = np.zeros((H, W), np.uint8)
    library().maxflow_grid(H, W, *(a.ctypes.data for a in arrs), out.ctypes.data)
    return out.astype(bool)


def watershed(img: np.ndarray, markers: np.ndarray) -> None:
    """Flood the contiguous (H, W) int32 `markers` in place over the
    (H, W, 3) u8 `img` (cv::watershed's semantics)."""
    if not markers.flags.c_contiguous or markers.dtype != np.int32:
        raise ValueError("watershed: the markers must be a contiguous int32 array")
    im = np.ascontiguousarray(img, np.uint8)
    H, W = markers.shape
    library().watershed_u8c3(im.ctypes.data, markers.ctypes.data, H, W)


def mser_detect(img: np.ndarray, delta=5, min_area=60, max_area=14400,
                max_variation=0.25, min_diversity=0.2, max_out=4096):
    """MSER's stable regions of one polarity of the (H, W) u8 `img`:
    ``(seeds, levels)``, int32, at most `max_out` of them (the JAX
    package's cap); each region is the pixels 4-connected to its seed at
    or below its level."""
    a = np.ascontiguousarray(img, np.uint8)
    H, W = a.shape
    seeds = np.zeros(max_out, np.int32)
    levels = np.zeros(max_out, np.int32)
    n = library().mser_detect(a.ctypes.data, H, W, int(delta), int(min_area), int(max_area),
                              float(max_variation), float(min_diversity), seeds.ctypes.data,
                              levels.ctypes.data, max_out)
    return seeds[:n], levels[:n]


def filter_speckles(img: np.ndarray, new_val, max_size: int, max_diff) -> np.ndarray:
    """filterSpeckles of the (H, W) integer `img` (u8, i16 or i32): a new
    array of its type, each 4-connected blob of pixels other than `new_val`
    whose neighbours differ by at most `max_diff` set to `new_val` when it
    has at most `max_size` pixels."""
    a = np.asarray(img)
    if a.ndim != 2 or a.dtype not in (np.uint8, np.int16, np.int32):
        raise ValueError(f"filter_speckles: an (H, W) u8, i16 or i32 image, not "
                         f"{a.shape} {a.dtype}")
    buf = np.array(a, np.int32, order="C")
    H, W = buf.shape
    nv = int(new_val)
    info = np.iinfo(a.dtype)
    if not info.min <= nv <= info.max:
        raise OverflowError(f"filter_speckles: new value {nv} out of {a.dtype}'s range")
    library().filter_speckles_i32(buf.ctypes.data, H, W, nv, int(max_size), int(max_diff))
    return buf.astype(a.dtype)


# ------------------------------------------------------------------ codecs

def _pack_huff_tables(tabs, n):
    """Up to `n` (bits, values) Huffman tables (None for a missing one) as
    the C code's (n, 16) and (n, 256) u8 arrays."""
    bits = np.zeros((n, 16), np.uint8)
    vals = np.zeros((n, 256), np.uint8)
    for i, t in enumerate(tabs[:n]):
        if t is None:
            continue
        b, v = t
        bits[i, :len(b)] = b
        vals[i, :len(v)] = v
    return bits, vals


def _i32(seq):
    return np.ascontiguousarray(seq, np.int32)


def jpeg_decode_blocks(data: bytes, comp_h, comp_v, scan_ci, scan_td, scan_ta, mcux, mcuy,
                       dri, dc_tables, ac_tables, comp_dims):
    """Baseline JPEG's entropy decode of one scan.  dc/ac_tables: up to 4
    (bits, values) pairs (None entries allowed); comp_dims: each
    component's (bh, bw) block grid.  Returns one (bh, bw, 64) int32 array
    a component, its coefficients in zigzag order."""
    dcb, dcv = _pack_huff_tables(dc_tables, 4)
    acb, acv = _pack_huff_tables(ac_tables, 4)
    ncomp = len(comp_h)
    sizes = [bh * bw * 64 for bh, bw in comp_dims]
    offs = np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.int64)
    coeff = np.zeros(sum(sizes), np.int32)
    # held in names for the length of the call: a pointer of a temporary
    # array dangles
    ch, cv_, sci, std, sta = (_i32(a) for a in (comp_h, comp_v, scan_ci, scan_td, scan_ta))
    buf = np.frombuffer(data, np.uint8)
    rc = library().jpeg_decode_blocks(
        buf.ctypes.data, len(buf), ncomp, ch.ctypes.data, cv_.ctypes.data, sci.ctypes.data,
        std.ctypes.data, sta.ctypes.data, len(sci), mcux, mcuy, dri, dcb.ctypes.data,
        dcv.ctypes.data, acb.ctypes.data, acv.ctypes.data, coeff.ctypes.data, offs.ctypes.data)
    if rc != 0:
        raise ValueError("jpeg: corrupt entropy-coded scan")
    return [coeff[o:o + n].reshape(bh, bw, 64)
            for o, n, (bh, bw) in zip(offs, sizes, comp_dims)]


def jpeg_encode_blocks(qcoef, comp_h, comp_v, comp_tq, mcux, mcuy, dc_tables,
                       ac_tables) -> bytes:
    """Baseline JPEG's entropy encode with no restart markers.  qcoef: each
    component's (bh, bw, 64) int32 zigzag blocks; dc/ac_tables: the 2
    (bits, values) pairs (luma, chroma).  Returns the stuffed entropy
    bytes."""
    sizes = [q.size for q in qcoef]
    offs = np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.int64)
    coeff = np.concatenate([np.ascontiguousarray(q, np.int32).reshape(-1) for q in qcoef])
    dcb, dcv = _pack_huff_tables(dc_tables, 2)
    acb, acv = _pack_huff_tables(ac_tables, 2)
    # a coefficient takes at most 16 + 11 bits, doubled by byte stuffing
    cap = 8 * sum(sizes) + (1 << 16)
    out = np.empty(cap, np.uint8)
    ch, cv_, ctq = (_i32(a) for a in (comp_h, comp_v, comp_tq))
    n = library().jpeg_encode_blocks(
        coeff.ctypes.data, offs.ctypes.data, len(qcoef), ch.ctypes.data, cv_.ctypes.data,
        ctq.ctypes.data, mcux, mcuy, dcb.ctypes.data, dcv.ctypes.data, acb.ctypes.data,
        acv.ctypes.data, out.ctypes.data, cap)
    if n < 0:
        raise RuntimeError(f"jpeg: the entropy coder overran its {cap}-byte buffer")
    return bytes(out[:n])


def ebcot_t1_decode(data: bytes, w: int, h: int, numbps: int, orient: int,
                    num_passes: int) -> np.ndarray:
    """JPEG 2000's tier-1 decode of one (h, w) code-block: int64 values
    with one fractional bit."""
    out = np.zeros(h * w, np.int64)
    buf = np.frombuffer(data + b"\x00\x00", np.uint8).copy()
    rc = library().ebcot_t1_decode(buf.ctypes.data, len(data), w, h, numbps, orient,
                                   num_passes, out.ctypes.data)
    if rc != 0:
        raise ValueError(f"jpeg2000: a {w}x{h} code-block could not be decoded")
    return out.reshape(h, w)


def ebcot_t1_encode(v: np.ndarray, orient: int):
    """JPEG 2000's tier-1 encode of one (h, w) int64 code-block:
    ``(numbps, data)``."""
    h, w = v.shape
    coeffs = np.ascontiguousarray(v, np.int64)
    cap = h * w * 8 + 1024
    outb = np.zeros(cap, np.uint8)
    nbps, ln = ctypes.c_int(0), ctypes.c_int(0)
    rc = library().ebcot_t1_encode(coeffs.ctypes.data, w, h, orient, outb.ctypes.data, cap,
                                   ctypes.byref(nbps), ctypes.byref(ln))
    if rc != 0:
        raise RuntimeError(f"jpeg2000: the MQ coder overran its {cap}-byte buffer")
    return nbps.value, bytes(outb[1:1 + ln.value])


def hfyu_decode_syms(stream: np.ndarray, lens, n_syms: int) -> np.ndarray:
    """`n_syms` HuffYUV symbols from the word-swapped u8 `stream` under the
    256 code lengths `lens`."""
    s = np.ascontiguousarray(stream, np.uint8)
    lens = np.ascontiguousarray(np.array(lens, np.uint8))
    out = np.empty(n_syms, np.uint8)
    rc = library().hfyu_decode_syms(s.ctypes.data, len(s), lens.ctypes.data, int(n_syms),
                                    out.ctypes.data)
    if rc != 0:
        raise ValueError("huffyuv: truncated/corrupt bitstream")
    return out


def hfyu_encode_syms(syms, lens) -> bytes:
    """The HuffYUV symbols packed MSB first under the code lengths `lens`,
    zero-padded to 4 bytes, before the caller's word swap."""
    s = np.ascontiguousarray(syms, np.uint8)
    lens_c = np.ascontiguousarray(lens, np.uint8)
    cap = len(s) * 2 + 64
    out = np.empty(cap, np.uint8)
    n = library().hfyu_encode_syms(s.ctypes.data, len(s), lens_c.ctypes.data, out.ctypes.data,
                                   cap)
    if n < 0:
        raise RuntimeError(f"huffyuv: the symbols overran their {cap}-byte buffer")
    return out[:n].tobytes()


def crc32_msb(data: bytes, crc: int = 0) -> int:
    """FFV1's CRC-32 (MSB first, polynomial 0x04C11DB7) of `data` from
    `crc`."""
    arr = np.frombuffer(data, np.uint8)
    return int(library().crc32_msb(arr.ctypes.data, len(arr), np.uint32(crc)))


def ffv1_decode_slice(stream: np.ndarray, w: int, h: int, nplanes: int, bits: int,
                      qts: np.ndarray, plane_ctx: np.ndarray, ctx_qt: np.ndarray,
                      state: np.ndarray, max_cc: int, run_io: np.ndarray,
                      samples: np.ndarray) -> int:
    """FFV1's Golomb-Rice residuals of one slice into the (h, nplanes, w)
    int32 `samples`; `state` (the contexts) and `run_io` are updated in
    place.  Returns the bytes read."""
    for a in (qts, plane_ctx, ctx_qt, state, run_io, samples):
        if not a.flags.c_contiguous or a.dtype != np.int32:
            raise ValueError("ffv1_decode_slice: contiguous int32 arrays")
    s = np.ascontiguousarray(stream, np.uint8)
    rc = library().ffv1_decode_slice(
        s.ctypes.data, len(s), w, h, nplanes, bits, qts.ctypes.data, plane_ctx.ctypes.data,
        ctx_qt.ctypes.data, state.ctypes.data, np.int32(max_cc), run_io.ctypes.data,
        samples.ctypes.data)
    if rc < 0:
        raise ValueError("ffv1: corrupt slice (native)")
    return int(rc)


def ffv1_encode_slice(samples: np.ndarray, w: int, h: int, nplanes: int, bits: int,
                      qts: np.ndarray, plane_ctx: np.ndarray, ctx_qt: np.ndarray,
                      vlc: np.ndarray, ccount: int, run_io: np.ndarray) -> bytes:
    """FFV1's Golomb-Rice coding of the (h, nplanes, w) int32 `samples` of
    one slice; `vlc` (the contexts) and `run_io` are updated in place."""
    for a in (samples, qts, plane_ctx, ctx_qt, vlc, run_io):
        if not a.flags.c_contiguous or a.dtype != np.int32:
            raise ValueError("ffv1_encode_slice: contiguous int32 arrays")
    cap = samples.nbytes + 4096
    outb = np.empty(cap, np.uint8)
    n = library().ffv1_encode_slice(
        samples.ctypes.data, w, h, nplanes, bits, qts.ctypes.data, plane_ctx.ctypes.data,
        ctx_qt.ctypes.data, vlc.ctypes.data, np.int32(ccount), run_io.ctypes.data,
        outb.ctypes.data, cap)
    if n < 0:
        raise ValueError("ffv1: encode overflow (native)")
    return outb[:n].tobytes()
