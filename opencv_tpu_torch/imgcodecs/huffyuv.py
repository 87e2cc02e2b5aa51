"""HuffYUV ('HFYU') in-AVI video codec — lossless compressed payloads.

The reference reads/writes HuffYUV through its FFmpeg backend
(modules/videoio/src/cap_ffmpeg.cpp); this is a from-scratch
implementation of the classic HuffYUV format, whose Huffman tables
travel IN the stream (strf extradata), so everything needed to decode
is in-band — no external normative tables.

Format facts (established black-box against the installed wheel with
known-plaintext probes, tests/test_huffyuv.py):

- extradata: byte0 = predictor | (decorrelate << 6), byte1 = bit depth
  (24 = RGB, 16 = packed 4:2:2), byte2 = 0x20, byte3 = 0, then three
  RLE-coded 256-entry code-length tables (byte = len | (count << 5),
  count==0 means the next byte is the count).
- codes: canonical, assigned longest-length first in symbol order,
  `bits >>= 1` when the length decreases (classic huffyuv rule).
- bitstream: MSB-first within 32-bit LITTLE-ENDIAN words (the byte
  stream is bswapped in 4-byte groups).
- RGB mode (bpp=24): rows processed BOTTOM-UP (DIB heritage).  The
  first pixel is raw: disk bytes (0, B, G, R).  Every later pixel
  stores (dG, dB', dR') where the chains are g, cb=B-G, cr=R-G, each
  delta'd against the previous pixel in stream order (continuing
  across row boundaries), all mod 256.  Decorrelate=1, predictor=LEFT.
- 4:2:2 mode (bpp=16): rows TOP-DOWN, units of 2 pixels; first unit
  raw as disk bytes (Y0, U, Y1, V); later units store
  (dY0, dU, dY1, dV) with independent left chains for Y (stepped twice
  per unit), U, V.  Predictor=LEFT, decorrelate=0.

The classic length table below is the in-band table every classic
HuffYUV file carries (it is literally parsed back out of the stream by
the decoder; embedded here so the encoder can emit it).

Twin of ``opencv_tpu/imgcodecs/huffyuv.py``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["encode_frame_bgr", "decode_frame", "build_extradata",
           "parse_extradata"]

# classic HuffYUV code-length table (identical for all 3 components)
_CLASSIC_LENS = (
    [2, 2, 4, 5, 6, 6, 7, 7] + [8] * 4 + [9] * 5 + [10] * 7 + [11] * 9
    + [12] * 13 + [13] * 19 + [14] * 28 + [15] * 72 + [14] * 26
    + [13] * 20 + [12] * 13 + [11] * 9 + [10] * 7 + [9] * 5 + [8] * 3
    + [7] * 3 + [6] * 2 + [5, 4, 3]
)
assert len(_CLASSIC_LENS) == 256


def _gen_codes(lens):
    """Classic huffyuv canonical codes: longest first, symbol order."""
    codes = np.zeros(256, np.uint32)
    bits = 0
    for ln in range(32, 0, -1):
        for sym in range(256):
            if lens[sym] == ln:
                codes[sym] = bits
                bits += 1
        bits >>= 1
    return codes


_CLASSIC_CODES = _gen_codes(_CLASSIC_LENS)
_CLASSIC_LENS_NP = np.array(_CLASSIC_LENS, np.uint8)


def _rle_table(lens):
    out = bytearray()
    i = 0
    while i < 256:
        v = lens[i]
        j = i
        while j < 256 and lens[j] == v and j - i < 255:
            j += 1
        rep = j - i
        if rep > 7:
            out.append(v)
            out.append(rep)
        else:
            out.append(v | (rep << 5))
        i = j
    return bytes(out)


def build_extradata(bpp=24):
    pred, dec = (0, 1) if bpp == 24 else (0, 0)
    head = bytes([pred | (dec << 6), bpp, 0x20, 0])
    return head + _rle_table(_CLASSIC_LENS) * 3


def parse_extradata(ed):
    predictor = ed[0] & 63
    decorrelate = ed[0] >> 6
    bpp = ed[1]
    pos = 4
    tables = []
    for _ in range(3):
        lens = []
        while len(lens) < 256:
            b = ed[pos]
            pos += 1
            val = b & 31
            rep = b >> 5
            if rep == 0:
                rep = ed[pos]
                pos += 1
            lens += [val] * rep
        tables.append(lens)
    return predictor, decorrelate, bpp, tables


def _bswap32(buf):
    a = np.frombuffer(buf, np.uint8)
    n4 = len(a) // 4 * 4
    out = a.copy()
    out[:n4] = a[:n4].reshape(-1, 4)[:, ::-1].reshape(-1)
    return out


# ------------------------------------------------------------------ encode

def _pack_bits(syms, codes, lens):
    """MSB-first packing of variable-length codes (the native
    ``hfyu_encode_syms``; :func:`_pack_bits_py` is its plain twin)."""
    from ..native import hfyu_encode_syms
    return _bswap32(hfyu_encode_syms(syms, lens)).tobytes()


def _pack_bits_py(syms, codes, lens):
    """The vectorized numpy twin of :func:`_pack_bits`."""
    L = lens[syms].astype(np.int64)
    C = codes[syms].astype(np.uint32)
    starts = np.concatenate([[0], np.cumsum(L)[:-1]])
    total = int(starts[-1] + L[-1]) if len(L) else 0
    nbits = (total + 31) // 32 * 32
    bits = np.zeros(nbits, np.uint8)
    maxlen = int(L.max()) if len(L) else 0
    for k in range(maxlen):
        m = L > k
        pos = starts[m] + k
        bits[pos] = (C[m] >> (L[m] - 1 - k).astype(np.uint32)) & 1
    packed = np.packbits(bits)
    return _bswap32(packed.tobytes()).tobytes()


def encode_frame_bgr(img):
    """Encode one BGR (H,W,3) frame as classic HuffYUV RGB24."""
    a = np.asarray(img, np.uint8)
    h, w = a.shape[:2]
    if a.ndim == 2:
        a = np.repeat(a[:, :, None], 3, axis=2)
    s = a[::-1].reshape(-1, 3)  # bottom-up stream order; uint8 wraps
    b, g, r = s[:, 0], s[:, 1], s[:, 2]
    cb = b - g
    cr = r - g
    syms = np.empty((len(s) - 1, 3), np.uint8)
    syms[:, 0] = g[1:] - g[:-1]
    syms[:, 1] = cb[1:] - cb[:-1]
    syms[:, 2] = cr[1:] - cr[:-1]
    syms = syms.reshape(-1)
    first = bytes([0, int(b[0]), int(g[0]), int(r[0])])
    return first + _pack_bits(syms, _CLASSIC_CODES, _CLASSIC_LENS_NP)


# ------------------------------------------------------------------ decode

def _decode_syms_py(bits_arr, lens, n_syms):
    """The plain Python twin of the native Huffman decode."""
    inv = {}
    codes = _gen_codes(lens)
    for sym in range(256):
        if lens[sym]:
            inv[(int(codes[sym]), int(lens[sym]))] = sym
    syms = np.empty(n_syms, np.uint8)
    c = 0
    ln = 0
    i = 0
    for bit in bits_arr:
        c = (c << 1) | int(bit)
        ln += 1
        if (c, ln) in inv:
            syms[i] = inv[(c, ln)]
            i += 1
            if i == n_syms:
                break
            c = 0
            ln = 0
    if i != n_syms:
        raise ValueError("huffyuv: truncated bitstream")
    return syms


def _decode_syms(payload, lens_tables, n_syms, skip_bytes=4):
    """Decode n_syms symbols with the native ``hfyu_decode_syms`` (all three
    tables are equal, as classic files' always are)."""
    from ..native import hfyu_decode_syms
    return hfyu_decode_syms(_bswap32(payload)[skip_bytes:], lens_tables[0], n_syms)


def decode_frame(payload, w, h, extradata):
    """Decode one frame.  Returns BGR (H,W,3) for RGB mode, or
    (y, u, v) planes for 4:2:2 mode.  None on error."""
    try:
        predictor, decorrelate, bpp, tables = parse_extradata(extradata)
    except (IndexError, ValueError):
        return None
    if predictor != 0:
        return None  # only LEFT (the only mode classic encoders emit)
    if tables[0] != tables[1] or tables[1] != tables[2]:
        return None
    if bpp == 24:
        if len(payload) < 4 or not decorrelate:
            return None
        n = w * h
        try:
            syms = _decode_syms(payload, tables, 3 * (n - 1))
        except ValueError:
            return None
        first = payload[:4]  # disk order (0, B, G, R)
        b0, g0, r0 = first[1], first[2], first[3]
        # uint8 cumsum wraps mod 256 — exactly the chain arithmetic
        d = np.empty((n, 3), np.uint8)
        d[0] = (g0, (b0 - g0) & 255, (r0 - g0) & 255)
        d[1:] = syms.reshape(-1, 3)
        ch = np.cumsum(d, axis=0, dtype=np.uint8)
        img = np.empty((n, 3), np.uint8)
        img[:, 0] = ch[:, 0] + ch[:, 1]   # B = g + cb (wraps)
        img[:, 1] = ch[:, 0]              # G
        img[:, 2] = ch[:, 0] + ch[:, 2]   # R = g + cr
        return img.reshape(h, w, 3)[::-1]  # stream was bottom-up
    if bpp == 16:
        if w % 2 or len(payload) < 4:
            return None
        units = w * h // 2
        try:
            syms = _decode_syms(payload, tables, 4 * (units - 1))
        except ValueError:
            return None
        first = payload[:4]  # disk order (Y0, U, Y1, V)
        y0, u0, y1, v0 = first[0], first[1], first[2], first[3]
        d = syms.reshape(-1, 4)
        # y chain steps twice per unit: y += dY0 then += dY1
        dy = np.empty(2 * units, np.uint8)
        dy[0] = y0
        dy[1] = (y1 - y0) & 255
        dy[2:] = d[:, [0, 2]].reshape(-1)
        yseq = np.cumsum(dy, dtype=np.uint8)
        du = np.empty(units, np.uint8)
        du[0] = u0
        du[1:] = d[:, 1]
        dv = np.empty(units, np.uint8)
        dv[0] = v0
        dv[1:] = d[:, 3]
        yp = yseq.reshape(h, w)                          # top-down
        up = np.cumsum(du, dtype=np.uint8).reshape(h, w // 2)
        vp = np.cumsum(dv, dtype=np.uint8).reshape(h, w // 2)
        return (yp, up, vp)
    return None


def yuv422_to_bgr(y, u, v):
    """4:2:2 -> BGR, BT.601 limited range (what swscale produced the
    planes from), chroma replicated horizontally."""
    h, w = y.shape
    uu = np.repeat(u, 2, axis=1)[:, :w].astype(np.float64) - 128.0
    vv = np.repeat(v, 2, axis=1)[:, :w].astype(np.float64) - 128.0
    yy = (y.astype(np.float64) - 16.0) * (255.0 / 219.0)
    c = 255.0 / 224.0
    r = yy + 1.402 * c * vv
    g = yy - 0.344136 * c * uu - 0.714136 * c * vv
    b = yy + 1.772 * c * uu
    out = np.stack([b, g, r], axis=-1)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)
