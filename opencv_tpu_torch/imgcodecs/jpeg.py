"""Baseline JPEG codec (imgcodecs/src/grfmt_jpeg.cpp's role, built from
the JPEG spec rather than libjpeg).

Host/device split: entropy coding (Huffman bitstreams) is host work (the
native C tier in ``native/hosttails.cpp``, its plain Python twin below); the block
numerics are libjpeg's deterministic integer pipelines vectorized over
all blocks at once.  DECODE (islow fixed-point IDCT, fancy upsampling,
16-bit YCbCr tables) is bit-identical to cv2.imdecode; ENCODE (islow
forward DCT, biased box downsampling, dummy-block MCU padding,
Annex-K tables) emits byte-identical files to cv2.imencode for the
same quality/sampling parameters.

Supports baseline sequential (SOF0) and progressive (SOF2) decode,
8-bit, 1 or 3 components, all integer sampling factors; encoder
writes baseline JFIF at 4:4:4/4:2:2/4:2:0/4:4:0/4:1:1.

Twin of ``opencv_tpu/imgcodecs/jpeg.py``.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["jpeg_decode", "jpeg_encode"]

# Annex K quantization tables
_QY = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], np.int32)
_QC = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99], np.int32)

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int32)

# Annex K Huffman tables: (bits per length 1..16, values)
_HT_DC_LUM = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
              list(range(12)))
_HT_DC_CHR = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
              list(range(12)))
_HT_AC_LUM = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41,
    0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91,
    0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24,
    0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A,
    0x25, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53,
    0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66,
    0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93,
    0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7,
    0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2,
    0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
_HT_AC_CHR = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12,
    0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14,
    0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15,
    0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17,
    0x18, 0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37,
    0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A,
    0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65,
    0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
    0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A,
    0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5,
    0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9,
    0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2,
    0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])


# ------------------------------------------------- integer decode pipeline
#
# The reference decodes through libjpeg-turbo (grfmt_jpeg.cpp), whose
# default path is fully deterministic integer math: the 13-bit
# fixed-point Loeffler IDCT ("islow"), triangular "fancy" chroma
# upsampling, and 16-bit fixed-point YCbCr->BGR tables.  Reproducing
# those (vectorized over all blocks) makes our decode bit-identical to
# cv2.imdecode.  Constants are FIX(x) = round(x * 2^13) from the
# published Loeffler-Ligtenberg-Moshovitz factorization.

_CONST_BITS = 13
_PASS1_BITS = 2


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _islow_1d(c):
    """One 8-point Loeffler fixed-point IDCT pass over a list of eight
    equally-shaped int64 arrays; returns the eight outputs pre-descale."""
    # even part
    z2, z3 = c[2], c[6]
    z1 = (z2 + z3) * 4433                       # FIX_0_541196100
    t2 = z1 - z3 * 15137                        # FIX_1_847759065
    t3 = z1 + z2 * 6270                         # FIX_0_765366865
    z2, z3 = c[0], c[4]
    t0 = (z2 + z3) << _CONST_BITS
    t1 = (z2 - z3) << _CONST_BITS
    e0, e3 = t0 + t3, t0 - t3
    e1, e2 = t1 + t2, t1 - t2
    # odd part
    o0, o1, o2, o3 = c[7], c[5], c[3], c[1]
    z1 = o0 + o3
    z2 = o1 + o2
    z3 = o0 + o2
    z4 = o1 + o3
    z5 = (z3 + z4) * 9633                       # FIX_1_175875602
    o0 = o0 * 2446                              # FIX_0_298631336
    o1 = o1 * 16819                             # FIX_2_053119869
    o2 = o2 * 25172                             # FIX_3_072711026
    o3 = o3 * 12299                             # FIX_1_501321110
    z1 = z1 * -7373                             # FIX_0_899976223
    z2 = z2 * -20995                            # FIX_2_562915447
    z3 = z3 * -16069 + z5                       # FIX_1_961570560
    z4 = z4 * -3196 + z5                        # FIX_0_390180644
    o0 = o0 + z1 + z3
    o1 = o1 + z2 + z4
    o2 = o2 + z2 + z3
    o3 = o3 + z1 + z4
    return [e0 + o3, e1 + o2, e2 + o1, e3 + o0,
            e3 - o0, e2 - o1, e1 - o2, e0 - o3]


def _idct_islow(blocks):
    """jpeg_idct_islow over (N, 8, 8) dequantized natural-order
    coefficients -> (N, 8, 8) uint8 samples (level-shifted, wrapped
    range-limit exactly as libjpeg's post-IDCT table)."""
    x = blocks.astype(np.int64)
    ws = _islow_1d([x[:, k, :] for k in range(8)])      # column pass
    ws = [_descale(w, _CONST_BITS - _PASS1_BITS) for w in ws]
    ws = np.stack(ws, axis=1)                            # (N, 8, 8)
    out = _islow_1d([ws[:, :, k] for k in range(8)])     # row pass
    out = [_descale(o, _CONST_BITS + _PASS1_BITS + 3) for o in out]
    v = np.stack(out, axis=2) & 1023
    v = np.where(v >= 512, v - 1024, v)
    return np.clip(v + 128, 0, 255).astype(np.uint8)


def _h2v1_fancy(p):
    """libjpeg h2v1_fancy_upsample: 3/4-1/4 triangular filter, edge
    replicated (the endpoint formulas collapse to the pad)."""
    t = np.pad(p.astype(np.int32), ((0, 0), (1, 1)), mode="edge")
    out = np.empty((p.shape[0], p.shape[1] * 2), np.int32)
    out[:, 0::2] = (3 * t[:, 1:-1] + t[:, :-2] + 1) >> 2
    out[:, 1::2] = (3 * t[:, 1:-1] + t[:, 2:] + 2) >> 2
    return out


def _h2v2_fancy(p):
    """libjpeg h2v2_fancy_upsample: vertical 3:1 column sums then the
    horizontal triangular pass with 8/7 bias."""
    rows, cw = p.shape
    pv = np.pad(p.astype(np.int32), ((1, 1), (0, 0)), mode="edge")
    cs = np.empty((rows * 2, cw), np.int32)
    cs[0::2] = 3 * pv[1:-1] + pv[:-2]
    cs[1::2] = 3 * pv[1:-1] + pv[2:]
    t = np.pad(cs, ((0, 0), (1, 1)), mode="edge")
    out = np.empty((rows * 2, cw * 2), np.int32)
    out[:, 0::2] = (3 * t[:, 1:-1] + t[:, :-2] + 8) >> 4
    out[:, 1::2] = (3 * t[:, 1:-1] + t[:, 2:] + 7) >> 4
    return out


# 16-bit fixed-point YCbCr->BGR tables (jdcolor.c build_ycc_rgb_table)
_I256 = np.arange(256, dtype=np.int64) - 128
_CR_R = ((91881 * _I256 + 32768) >> 16).astype(np.int32)    # FIX(1.40200)
_CB_B = ((116130 * _I256 + 32768) >> 16).astype(np.int32)   # FIX(1.77200)
_CR_G = (-46802 * _I256).astype(np.int32)                   # FIX(0.71414)
_CB_G = (-22554 * _I256 + 32768).astype(np.int32)           # FIX(0.34414)


# ------------------------------------------------- integer encode pipeline
#
# The same treatment for the encoder makes imencode('.jpg') emit the
# exact bytes the wheel emits: fixed-point RGB->YCbCr (jccolor.c),
# biased box downsampling (jcsample.c), the islow forward DCT
# (jfdctint.c, outputs scaled x8), and round-half-away-from-zero
# quantization (jcdctmgr.c).  Entropy coding of the resulting
# coefficients with the Annex-K tables is unique, so byte-identity
# follows.


def _fdct_1d(c, pass2):
    """One 8-point islow forward-DCT pass (jfdctint.c) over eight
    equally-shaped int64 arrays."""
    t0, t7 = c[0] + c[7], c[0] - c[7]
    t1, t6 = c[1] + c[6], c[1] - c[6]
    t2, t5 = c[2] + c[5], c[2] - c[5]
    t3, t4 = c[3] + c[4], c[3] - c[4]
    t10, t13 = t0 + t3, t0 - t3
    t11, t12 = t1 + t2, t1 - t2
    if pass2:
        o0 = _descale(t10 + t11, _PASS1_BITS)
        o4 = _descale(t10 - t11, _PASS1_BITS)
        sh = _CONST_BITS + _PASS1_BITS
    else:
        o0 = (t10 + t11) << _PASS1_BITS
        o4 = (t10 - t11) << _PASS1_BITS
        sh = _CONST_BITS - _PASS1_BITS
    z1 = (t12 + t13) * 4433                     # FIX_0_541196100
    o2 = _descale(z1 + t13 * 6270, sh)          # FIX_0_765366865
    o6 = _descale(z1 - t12 * 15137, sh)         # FIX_1_847759065
    z1 = t4 + t7
    z2 = t5 + t6
    z3 = t4 + t6
    z4 = t5 + t7
    z5 = (z3 + z4) * 9633                       # FIX_1_175875602
    t4 = t4 * 2446                              # FIX_0_298631336
    t5 = t5 * 16819                             # FIX_2_053119869
    t6 = t6 * 25172                             # FIX_3_072711026
    t7 = t7 * 12299                             # FIX_1_501321110
    z1 = z1 * -7373                             # FIX_0_899976223
    z2 = z2 * -20995                            # FIX_2_562915447
    z3 = z3 * -16069 + z5                       # FIX_1_961570560
    z4 = z4 * -3196 + z5                        # FIX_0_390180644
    o7 = _descale(t4 + z1 + z3, sh)
    o5 = _descale(t5 + z2 + z4, sh)
    o3 = _descale(t6 + z2 + z3, sh)
    o1 = _descale(t7 + z1 + z4, sh)
    return [o0, o1, o2, o3, o4, o5, o6, o7]


def _fdct_islow(blocks):
    """jpeg_fdct_islow over (N, 8, 8) level-shifted samples ->
    (N, 8, 8) coefficients scaled x8."""
    x = blocks.astype(np.int64)
    ws = _fdct_1d([x[:, :, k] for k in range(8)], False)    # row pass
    ws = np.stack(ws, axis=2)
    out = _fdct_1d([ws[:, k, :] for k in range(8)], True)   # column pass
    return np.stack(out, axis=1)


def _quantize_blocks(coef, q):
    """jcdctmgr.c quantize: divisor is quantval<<3 (fdct is scaled x8),
    rounding half away from zero.  coef (N, 64) natural order."""
    qv = q.astype(np.int64) << 3
    mag = (np.abs(coef) + (qv >> 1)) // qv
    return np.where(coef < 0, -mag, mag)


def _down_h2v2(p):
    """jcsample.c h2v2_downsample: 2x2 box with the 1/2 alternating
    bias per output column."""
    s = (p[0::2, 0::2].astype(np.int32) + p[0::2, 1::2]
         + p[1::2, 0::2] + p[1::2, 1::2])
    bias = 1 + (np.arange(s.shape[1], dtype=np.int32) & 1)
    return (s + bias[None, :]) >> 2


def _down_h2v1(p):
    """jcsample.c h2v1_downsample: horizontal pairs, 0/1 alternating
    bias."""
    s = p[:, 0::2].astype(np.int32) + p[:, 1::2]
    bias = np.arange(s.shape[1], dtype=np.int32) & 1
    return (s + bias[None, :]) >> 1


def _down_int(p, hexp, vexp):
    """jcsample.c int_downsample: plain box average, round half up."""
    n = hexp * vexp
    s = p.reshape(p.shape[0] // vexp, vexp,
                  p.shape[1] // hexp, hexp).astype(np.int32).sum((1, 3))
    return (s + (n >> 1)) // n


class _DecTable(dict):
    """(length, code) -> symbol map; carries the raw (bits, values) spec
    so the native entropy decoder can rebuild its canonical tables."""
    bits = None
    vals = None


def _build_decoder_table(bits, values):
    table = _DecTable()
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            table[(length, code)] = values[k]
            code += 1
            k += 1
        code <<= 1
    table.bits = list(bits)
    table.vals = list(values)
    return table


class _BitReader:
    def __init__(self, data):
        self.data = data
        self.pos = 0
        self.bitbuf = 0
        self.nbits = 0

    def _fill(self):
        while self.nbits <= 24 and self.pos < len(self.data):
            b = self.data[self.pos]
            self.pos += 1
            if b == 0xFF:
                nxt = self.data[self.pos] if self.pos < len(self.data) else 0
                if nxt == 0x00:
                    self.pos += 1
                else:
                    # marker: stop feeding (RSTn handled by caller)
                    self.pos -= 1
                    return
            self.bitbuf = (self.bitbuf << 8) | b
            self.nbits += 8

    def read(self, n):
        if n == 0:
            return 0
        self._fill()
        if self.nbits < n:
            self.bitbuf <<= (n - self.nbits)
            self.nbits = n
        v = (self.bitbuf >> (self.nbits - n)) & ((1 << n) - 1)
        self.nbits -= n
        self.bitbuf &= (1 << self.nbits) - 1
        return v

    def decode_huffman(self, table):
        code = 0
        for length in range(1, 17):
            code = (code << 1) | self.read(1)
            sym = table.get((length, code))
            if sym is not None:
                return sym
        raise ValueError("bad Huffman code")


def _extend(v, t):
    """JPEG EXTEND: map t-bit magnitude to signed value."""
    return v - (1 << t) + 1 if t > 0 and v < (1 << (t - 1)) else v


def jpeg_decode(buf, grayscale=False):
    data = np.frombuffer(np.asarray(bytearray(buf), np.uint8), np.uint8)
    data = bytes(data.tobytes())
    assert data[0:2] == b"\xff\xd8", "not a JPEG"
    pos = 2
    qt = {}
    huff_dc = {}
    huff_ac = {}
    frame = None
    restart_interval = 0
    prog_coeff = None
    while pos < len(data):
        assert data[pos] == 0xFF
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD9:
            break
        if marker in (0x01,) or 0xD0 <= marker <= 0xD7:
            continue
        seglen = struct.unpack(">H", data[pos:pos + 2])[0]
        seg = data[pos + 2:pos + seglen]
        if marker == 0xDB:  # DQT
            i = 0
            while i < len(seg):
                pq_tq = seg[i]
                tq = pq_tq & 15
                if pq_tq >> 4:
                    tab = np.frombuffer(seg[i + 1:i + 129], ">u2")
                    i += 129
                else:
                    tab = np.frombuffer(seg[i + 1:i + 65], np.uint8)
                    i += 65
                qt[tq] = tab.astype(np.int32)
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(seg):
                tc_th = seg[i]
                bits = list(seg[i + 1:i + 17])
                nval = sum(bits)
                vals = list(seg[i + 17:i + 17 + nval])
                tbl = _build_decoder_table(bits, vals)
                if tc_th >> 4:
                    huff_ac[tc_th & 15] = tbl
                else:
                    huff_dc[tc_th & 15] = tbl
                i += 17 + nval
        elif marker == 0xC0 or marker == 0xC1:  # SOF0/1 baseline
            prec, H, W, nc = struct.unpack(">BHHB", seg[:6])
            comps = []
            for c in range(nc):
                cid, hv, tq = seg[6 + 3 * c:9 + 3 * c]
                comps.append(dict(id=cid, h=hv >> 4, v=hv & 15, tq=tq))
            frame = dict(H=H, W=W, comps=comps)
        elif marker == 0xC2:  # SOF2 progressive
            prec, H, W, nc = struct.unpack(">BHHB", seg[:6])
            comps = []
            for c in range(nc):
                cid, hv, tq = seg[6 + 3 * c:9 + 3 * c]
                comps.append(dict(id=cid, h=hv >> 4, v=hv & 15, tq=tq))
            frame = dict(H=H, W=W, comps=comps, progressive=True)
        elif marker == 0xDD:  # DRI
            restart_interval = struct.unpack(">H", seg[:2])[0]
        elif marker == 0xDA:  # SOS
            ns = seg[0]
            scomp = []
            for c in range(ns):
                cs, td_ta = seg[1 + 2 * c:3 + 2 * c]
                scomp.append((cs, td_ta >> 4, td_ta & 15))
            pos += seglen
            if not frame.get("progressive"):
                return _decode_scan(data, pos, frame, scomp, qt,
                                    huff_dc, huff_ac, restart_interval,
                                    grayscale)
            # progressive: this scan covers the spectral band ss..se
            # with successive approximation ah -> al (ITU T.81 G.2)
            ss, se, ah_al = seg[1 + 2 * ns:4 + 2 * ns]
            ah, al = ah_al >> 4, ah_al & 15
            if prog_coeff is None:
                prog_coeff = _alloc_coeff(frame)
            end = _scan_end(data, pos)
            _decode_prog_scan(data[pos:end], frame, prog_coeff, scomp,
                              ss, se, ah, al, huff_dc, huff_ac,
                              restart_interval)
            pos = end
            continue
        pos += seglen
    if frame is not None and frame.get("progressive") and \
            prog_coeff is not None:
        return _finish_decode(frame, prog_coeff, qt, grayscale)
    raise ValueError("no scan found")


def _decode_scan(data, pos, frame, scomp, qt, huff_dc, huff_ac,
                 dri, grayscale=False):
    H, W = frame["H"], frame["W"]
    comps = frame["comps"]
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mcux = (W + 8 * hmax - 1) // (8 * hmax)
    mcuy = (H + 8 * vmax - 1) // (8 * vmax)

    by_id = {c[0]: k for k, (c) in enumerate(
        [(cc["id"],) for cc in comps])}
    order = [by_id[cs] for cs, _, _ in scomp]

    # the native entropy decoder (native/hosttails.cpp
    # jpeg_decode_blocks); _decode_scan_py is its plain twin
    from ..native import jpeg_decode_blocks as _native_decode
    dc_raw = [(huff_dc[i].bits, huff_dc[i].vals)
              if i in huff_dc and getattr(huff_dc[i], "bits", None)
              is not None else None for i in range(4)]
    ac_raw = [(huff_ac[i].bits, huff_ac[i].vals)
              if i in huff_ac and getattr(huff_ac[i], "bits", None)
              is not None else None for i in range(4)]
    comp_dims = [(mcuy * c["v"], mcux * c["h"]) for c in comps]
    res = _native_decode(
        data[pos:], [c["h"] for c in comps], [c["v"] for c in comps],
        order, [td for _, td, _ in scomp], [ta for _, _, ta in scomp],
        mcux, mcuy, dri, dc_raw, ac_raw, comp_dims)
    return _finish_decode(frame, res, qt, grayscale)


def _decode_scan_py(data, pos, frame, scomp, huff_dc, huff_ac, dri):
    """The plain twin of the native entropy decode of one baseline scan:
    each component's (bh, bw, 64) int32 zigzag coefficients."""
    H, W = frame["H"], frame["W"]
    comps = frame["comps"]
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mcux = (W + 8 * hmax - 1) // (8 * hmax)
    mcuy = (H + 8 * vmax - 1) // (8 * vmax)
    by_id = {cc["id"]: k for k, cc in enumerate(comps)}
    order = [by_id[cs] for cs, _, _ in scomp]
    rd = _BitReader(data[pos:])
    coeff = []
    for c in comps:
        bw = mcux * c["h"]
        bh = mcuy * c["v"]
        coeff.append(np.zeros((bh, bw, 64), np.int32))
    pred = [0] * len(comps)

    nmcu = 0
    for my in range(mcuy):
        for mx in range(mcux):
            if dri and nmcu and nmcu % dri == 0:
                # resync: skip to next RST marker
                rd.nbits = 0
                rd.bitbuf = 0
                while rd.pos < len(rd.data) - 1:
                    if rd.data[rd.pos] == 0xFF and \
                            0xD0 <= rd.data[rd.pos + 1] <= 0xD7:
                        rd.pos += 2
                        break
                    rd.pos += 1
                pred = [0] * len(comps)
            for si, (cs, td, ta) in enumerate(scomp):
                ci = order[si]
                c = comps[ci]
                for v in range(c["v"]):
                    for h in range(c["h"]):
                        blk = np.zeros(64, np.int32)
                        t = rd.decode_huffman(huff_dc[td])
                        diff = _extend(rd.read(t), t)
                        pred[ci] += diff
                        blk[0] = pred[ci]
                        k = 1
                        while k < 64:
                            rs = rd.decode_huffman(huff_ac[ta])
                            r, s = rs >> 4, rs & 15
                            if s == 0:
                                if r == 15:
                                    k += 16
                                    continue
                                break
                            k += r
                            blk[k] = _extend(rd.read(s), s)
                            k += 1
                        coeff[ci][my * c["v"] + v, mx * c["h"] + h] = blk
            nmcu += 1
    return coeff


def _finish_decode(frame, coeff, qt, grayscale=False):
    """Dequantize + islow IDCT + fancy upsample + fixed-point YCbCr
    conversion — shared by the baseline and progressive paths.
    Bit-identical to libjpeg-turbo's default decode
    (grfmt_jpeg.cpp's backend); `grayscale` mirrors JCS_GRAYSCALE
    output (the Y plane, chroma never touched)."""
    H, W = frame["H"], frame["W"]
    comps = frame["comps"]
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    planes = []
    for ci, c in enumerate(comps):
        if grayscale and ci > 0:
            break
        q = qt[c["tq"]]
        zz = np.zeros((coeff[ci].shape[0], coeff[ci].shape[1], 64),
                      np.int64)
        zz[..., _ZIGZAG] = coeff[ci].astype(np.int64) * q[None, None, :]
        bh, bw = coeff[ci].shape[:2]
        pix = _idct_islow(zz.reshape(-1, 8, 8))
        plane = pix.reshape(bh, bw, 8, 8).transpose(
            0, 2, 1, 3).reshape(bh * 8, bw * 8)
        # libjpeg upsamples the component at its true (downsampled)
        # size with edge replication at the image border, not at the
        # block-padded border — crop first
        cw = -(-W * c["h"] // hmax)
        ch = -(-H * c["v"] // vmax)
        plane = plane[:ch, :cw]
        sy = vmax // c["v"]
        sx = hmax // c["h"]
        if sx == 2 and sy == 1:
            plane = _h2v1_fancy(plane)
        elif sx == 2 and sy == 2:
            plane = _h2v2_fancy(plane)
        elif sx != 1 or sy != 1:
            # all other ratios use int_upsample (pixel replication)
            plane = np.repeat(np.repeat(plane, sy, axis=0), sx, axis=1)
        planes.append(plane[:H, :W].astype(np.int32))

    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    Y, Cb, Cr = planes
    r = np.clip(Y + _CR_R[Cr], 0, 255)
    g = np.clip(Y + ((_CB_G[Cb] + _CR_G[Cr]) >> 16), 0, 255)
    b = np.clip(Y + _CB_B[Cb], 0, 255)
    return np.stack([b, g, r], -1).astype(np.uint8)


# ------------------------------------------------------------------ encode

class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def write(self, code, length):
        self.acc = (self.acc << length) | (code & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            b = (self.acc >> (self.n - 8)) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0x00)
            self.n -= 8
            self.acc &= (1 << self.n) - 1

    def flush(self):
        if self.n:
            pad = 8 - self.n
            self.acc = (self.acc << pad) | ((1 << pad) - 1)
            b = self.acc & 0xFF
            self.out.append(b)
            if b == 0xFF:          # 1-padding can form FF: stuff it
                self.out.append(0x00)
            self.n = 0
            self.acc = 0


def _encode_table(bits, values):
    codes = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[values[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def _magnitude(v):
    a = abs(int(v))
    t = a.bit_length()
    if v < 0:
        v = v + (1 << t) - 1
    return t, v & ((1 << t) - 1)


def _quality_scale(q, base):
    q = min(max(int(q), 1), 100)
    scale = 5000 // q if q < 50 else 200 - q * 2
    t = (base * scale + 50) // 100
    return np.clip(t, 1, 255).astype(np.int32)


def _gen_optimal_table(freq):
    """libjpeg jpeg_gen_optimal_table (jchuff.c): merge-based optimal
    code lengths over 257 symbols (256 reserved), the <= tie rule that
    picks the LARGEST index among minimum frequencies, the >16-bit
    length adjustment, and value-ordered symbol listing."""
    freq = list(freq) + [1]                       # reserved slot 256
    codesize = [0] * 257
    others = [-1] * 257
    while True:
        c1, v = -1, 10 ** 9
        for i in range(257):
            if freq[i] and freq[i] <= v:
                v = freq[i]
                c1 = i
        c2, v = -1, 10 ** 9
        for i in range(257):
            if freq[i] and freq[i] <= v and i != c1:
                v = freq[i]
                c2 = i
        if c2 < 0:
            break
        freq[c1] += freq[c2]
        freq[c2] = 0
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1
    bits = [0] * 33
    for i in range(257):
        if codesize[i]:
            bits[codesize[i]] += 1
    for i in range(32, 16, -1):                   # limit to 16 bits
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1                                  # drop the reserved slot
    vals = []
    for length in range(1, 33):
        for sym in range(256):
            if codesize[sym] == length:
                vals.append(sym)
    return bits[1:17], vals


def _entropy_pass(qcoef, samp, qts, mcux, mcuy, rst, dc_tabs=None,
                  ac_tabs=None, bw_=None, dc_freq=None, ac_freq=None):
    """One pass over the MCU stream: emits bits (when bw_ given) or
    tallies symbol frequencies (when freq arrays given), with restart
    markers/DC resets every `rst` MCUs."""
    pred = [0] * len(samp)
    nmcu = 0
    rstn = 0
    for my in range(mcuy):
        for mx in range(mcux):
            if rst and nmcu and nmcu % rst == 0:
                if bw_ is not None:
                    bw_.flush()
                    bw_.out += bytes([0xFF, 0xD0 + (rstn & 7)])
                rstn += 1
                pred = [0] * len(samp)
            nmcu += 1
            for pi in range(len(samp)):
                h, v = samp[pi]
                ti = 0 if qts[pi] == 0 else 1
                for dv in range(v):
                    for dh in range(h):
                        blk = qcoef[pi][my * v + dv, mx * h + dh]
                        diff = int(blk[0]) - pred[pi]
                        pred[pi] = int(blk[0])
                        t, bitsv = _magnitude(diff)
                        if bw_ is not None:
                            code, ln = dc_tabs[ti][t]
                            bw_.write(code, ln)
                            if t:
                                bw_.write(bitsv, t)
                        else:
                            dc_freq[ti][t] += 1
                        run = 0
                        last_nz = np.nonzero(blk[1:])[0]
                        last = last_nz[-1] + 1 if len(last_nz) else 0
                        for k in range(1, last + 1):
                            val = int(blk[k])
                            if val == 0:
                                run += 1
                                continue
                            while run >= 16:
                                if bw_ is not None:
                                    code, ln = ac_tabs[ti][0xF0]
                                    bw_.write(code, ln)
                                else:
                                    ac_freq[ti][0xF0] += 1
                                run -= 16
                            t, bitsv = _magnitude(val)
                            if bw_ is not None:
                                code, ln = ac_tabs[ti][(run << 4) | t]
                                bw_.write(code, ln)
                                bw_.write(bitsv, t)
                            else:
                                ac_freq[ti][(run << 4) | t] += 1
                            run = 0
                        if last < 63:
                            if bw_ is not None:
                                code, ln = ac_tabs[ti][0x00]
                                bw_.write(code, ln)
                            else:
                                ac_freq[ti][0x00] += 1


def jpeg_encode(img, quality=95, sampling=0x221111, optimize=0,
                rst_interval=0, luma_quality=-1, chroma_quality=-1):
    """Byte-identical to the wheel's imencode('.jpg') for the same
    parameters (grfmt_jpeg.cpp over libjpeg): quality, sampling factor
    (IMWRITE_JPEG_SAMPLING_FACTOR_* encodings), Huffman optimization,
    restart intervals, and separate luma/chroma quality (which forces
    4:4:4 when they differ, as the reference does)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    gray = C == 1

    # grfmt_jpeg.cpp:726-745: LUMA_QUALITY also sets the overall
    # quality; CHROMA alone is ignored; differing luma/chroma forces
    # 4:4:4 (jpeg_default_qtables path)
    force_111 = False
    if luma_quality >= 0:
        luma_quality = min(max(luma_quality, 0), 100)
        quality = luma_quality
        if chroma_quality < 0:
            chroma_quality = luma_quality
    if luma_quality >= 0 and chroma_quality >= 0:
        chroma_quality = min(max(chroma_quality, 0), 100)
        qy = _quality_scale(luma_quality, _QY)
        qc = _quality_scale(chroma_quality, _QC)
        force_111 = luma_quality != chroma_quality
    else:
        qy = _quality_scale(quality, _QY)
        qc = _quality_scale(quality, _QC)

    if gray:
        samp = [(1, 1)]
        qts = [0]
    else:
        lh = (sampling >> 20) & 15 or 2
        lv = (sampling >> 16) & 15 or 2
        if force_111:
            lh = lv = 1
        samp = [(lh, lv), (1, 1), (1, 1)]
        qts = [0, 1, 1]

    hmax = max(s[0] for s in samp)
    vmax = max(s[1] for s in samp)
    mcux = (W + 8 * hmax - 1) // (8 * hmax)
    mcuy = (H + 8 * vmax - 1) // (8 * vmax)

    # full-res color conversion first (pointwise, so it commutes with
    # the per-component edge expansion below)
    if gray:
        fullres = [np.ascontiguousarray(img[..., 0]).astype(np.int32)]
    else:
        px = img.astype(np.int64)
        b, g, r = px[..., 0], px[..., 1], px[..., 2]
        # jccolor.c rgb_ycc_start: FIX(x) = round(x * 2^16); Cb/Cr get
        # ONE_HALF-1 so exact halves round down
        Y = ((19595 * r + 38470 * g + 7471 * b + 32768) >> 16)
        Cb = ((-11059 * r - 21709 * g + 32768 * b
               + (128 << 16) + 32767) >> 16)
        Cr = ((32768 * r - 27439 * g - 5329 * b
               + (128 << 16) + 32767) >> 16)
        fullres = [Y.astype(np.int32), Cb.astype(np.int32),
                   Cr.astype(np.int32)]

    qcoef = []
    for pi, p in enumerate(fullres):
        h, v = samp[pi]
        hexp, vexp = hmax // h, vmax // v
        # libjpeg edge-expands samples only to the component's
        # width_in_blocks*8 x height_in_blocks*8 (jcsample.c
        # expand_right_edge / jcprepct.c expand_bottom_edge) ...
        dsw = -(-W * h // hmax)
        dsh = -(-H * v // vmax)
        wib = -(-dsw // 8)
        hib = -(-dsh // 8)
        p = np.pad(p, ((0, hib * 8 * vexp - H), (0, wib * 8 * hexp - W)),
                   mode="edge")
        if hexp == 2 and vexp == 2:
            p = _down_h2v2(p)
        elif hexp == 2 and vexp == 1:
            p = _down_h2v1(p)
        elif hexp != 1 or vexp != 1:
            p = _down_int(p, hexp, vexp)
        blocks = p.reshape(hib, 8, wib, 8).transpose(0, 2, 1, 3)
        F = _fdct_islow(blocks.reshape(-1, 8, 8).astype(np.int64) - 128)
        q = qy if qts[pi] == 0 else qc       # natural (row-major) order
        qz = _quantize_blocks(F.reshape(-1, 64), q).astype(np.int32)
        qz = qz.reshape(hib, wib, 64)[..., _ZIGZAG]
        # ... MCU-padding blocks beyond that are DUMMY blocks: zero AC,
        # DC copied from the previous block in MCU encode order
        # (jccoefct.c compress_data)
        bh, bw = mcuy * v, mcux * h
        full = np.zeros((bh, bw, 64), np.int32)
        full[:hib, :wib] = qz
        for c in range(wib, bw):             # right-edge dummy columns
            full[:hib, c, 0] = full[:hib, c - 1, 0]
        for rrow in range(hib, bh):          # bottom dummy block rows
            for mx in range(mcux):
                full[rrow, mx * h:(mx + 1) * h, 0] = \
                    full[rrow - 1, (mx + 1) * h - 1, 0]
        qcoef.append(full)

    # Huffman tables: Annex-K standard, or per-image optimal
    if optimize:
        ntab = 1 if gray else 2
        dc_freq = [[0] * 256 for _ in range(ntab)]
        ac_freq = [[0] * 256 for _ in range(ntab)]
        _entropy_pass(qcoef, samp, qts, mcux, mcuy, rst_interval,
                      dc_freq=dc_freq, ac_freq=ac_freq)
        dc_spec = [_gen_optimal_table(f) for f in dc_freq]
        ac_spec = [_gen_optimal_table(f) for f in ac_freq]
    else:
        dc_spec = [_HT_DC_LUM, _HT_DC_CHR]
        ac_spec = [_HT_AC_LUM, _HT_AC_CHR]

    # the native entropy encoder (native/hosttails.cpp jpeg_encode_blocks)
    # has no restart markers: with a restart interval the Python pass,
    # its plain twin, writes the scan
    ent = None
    if not rst_interval:
        from ..native import jpeg_encode_blocks as _native_encode
        ent = _native_encode(qcoef, [s[0] for s in samp],
                             [s[1] for s in samp], qts, mcux, mcuy,
                             [dc_spec[0], dc_spec[-1]],
                             [ac_spec[0], ac_spec[-1]])

    bw_ = _BitWriter()
    if ent is not None:
        bw_.out = bytearray(ent)
    else:
        dc_tabs = [_encode_table(*s) for s in dc_spec]
        ac_tabs = [_encode_table(*s) for s in ac_spec]
        _entropy_pass(qcoef, samp, qts, mcux, mcuy, rst_interval,
                      dc_tabs=dc_tabs, ac_tabs=ac_tabs, bw_=bw_)
    bw_.flush()

    # assemble the file
    out = bytearray(b"\xff\xd8")
    out += b"\xff\xe0" + struct.pack(">H", 16) + b"JFIF\x00\x01\x01\x00" \
        + struct.pack(">HH", 1, 1) + b"\x00\x00"
    for tq, q in ([(0, qy)] if gray else [(0, qy), (1, qc)]):
        out += b"\xff\xdb" + struct.pack(">H", 67) + bytes([tq]) \
            + bytes(np.asarray(q, np.uint8).reshape(8, 8).ravel()
                    [_ZIGZAG].tolist())
    nc = 1 if gray else 3
    out += b"\xff\xc0" + struct.pack(">HBHHB", 8 + 3 * nc, 8, H, W, nc)
    for ci in range(nc):
        h, v = samp[ci]
        out += bytes([ci + 1, (h << 4) | v, qts[ci]])
    tabs = [dc_spec[0], ac_spec[0]] if gray else \
        [dc_spec[0], ac_spec[0], dc_spec[-1], ac_spec[-1]]
    classes = [0x00, 0x10] if gray else [0x00, 0x10, 0x01, 0x11]
    for (bits, vals), cls in zip(tabs, classes):
        out += b"\xff\xc4" + struct.pack(">H", 19 + len(vals)) \
            + bytes([cls]) + bytes(bits) + bytes(vals)
    if rst_interval:
        out += b"\xff\xdd" + struct.pack(">HH", 4, rst_interval)
    out += b"\xff\xda" + struct.pack(">HB", 6 + 2 * nc, nc)
    for ci in range(nc):
        td_ta = 0x00 if qts[ci] == 0 else 0x11
        out += bytes([ci + 1, td_ta])
    out += b"\x00\x3f\x00"
    out += bytes(bw_.out)
    out += b"\xff\xd9"
    return np.frombuffer(bytes(out), np.uint8)




# ------------------------------------------------------- progressive decode

def _alloc_coeff(frame):
    comps = frame["comps"]
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mcux = (frame["W"] + 8 * hmax - 1) // (8 * hmax)
    mcuy = (frame["H"] + 8 * vmax - 1) // (8 * vmax)
    return [np.zeros((mcuy * c["v"], mcux * c["h"], 64), np.int32)
            for c in comps]


def _scan_end(data, pos):
    """Find the end of entropy-coded data: the next marker that is not
    byte stuffing (FF00) or a restart marker."""
    p = pos
    n = len(data)
    while p < n - 1:
        if data[p] == 0xFF:
            m = data[p + 1]
            if m != 0x00 and not (0xD0 <= m <= 0xD7):
                return p
        p += 1
    return n


def _decode_prog_scan(scan, frame, coeff, scomp, ss, se, ah, al,
                      huff_dc, huff_ac, dri):
    """One progressive scan (ITU T.81 G.2): DC first/refine over MCUs,
    AC first/refine (with EOB runs) over a single component's blocks."""
    comps = frame["comps"]
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mcux = (frame["W"] + 8 * hmax - 1) // (8 * hmax)
    mcuy = (frame["H"] + 8 * vmax - 1) // (8 * vmax)
    by_id = {c["id"]: k for k, c in enumerate(comps)}
    rd = _BitReader(scan)

    def resync():
        rd.nbits = 0
        rd.bitbuf = 0
        while rd.pos < len(rd.data) - 1:
            if rd.data[rd.pos] == 0xFF and \
                    0xD0 <= rd.data[rd.pos + 1] <= 0xD7:
                rd.pos += 2
                return
            rd.pos += 1

    if ss == 0:
        pred = [0] * len(comps)

        def dc_one(blk, td, ci):
            if ah == 0:
                t = rd.decode_huffman(huff_dc[td])
                if not 0 <= t <= 15:  # corrupt/crafted DHT
                    raise ValueError("bad DC category in progressive scan")
                diff = _extend(rd.read(t), t)
                pred[ci] += diff
                blk[0] = pred[ci] << al
            else:
                if rd.read(1):
                    blk[0] |= (1 << al)

        if len(scomp) == 1:
            # ---- non-interleaved DC scan: iterate the COMPONENT's own
            # block grid (T.81 A.2.2), not the MCU grid — for subsampled
            # luma the two differ by h*v
            (cs, td, _ta) = scomp[0]
            ci = by_id[cs]
            c = comps[ci]
            cw = (frame["W"] * c["h"] + 8 * hmax - 1) // (8 * hmax)
            ch = (frame["H"] * c["v"] + 8 * vmax - 1) // (8 * vmax)
            nblk = 0
            for byi in range(ch):
                for bxi in range(cw):
                    if dri and nblk and nblk % dri == 0:
                        resync()
                        pred = [0] * len(comps)
                    dc_one(coeff[ci][byi, bxi], td, ci)
                    nblk += 1
            return

        # ---- interleaved DC scan over MCUs
        nmcu = 0
        for my in range(mcuy):
            for mx in range(mcux):
                if dri and nmcu and nmcu % dri == 0:
                    resync()
                    pred = [0] * len(comps)
                for (cs, td, _ta) in scomp:
                    ci = by_id[cs]
                    c = comps[ci]
                    for v in range(c["v"]):
                        for h in range(c["h"]):
                            dc_one(coeff[ci][my * c["v"] + v,
                                             mx * c["h"] + h], td, ci)
                nmcu += 1
        return

    # ---- AC scan: always a single component, non-interleaved blocks
    (cs, _td, ta) = scomp[0]
    ci = by_id[cs]
    c = comps[ci]
    cw = (frame["W"] * c["h"] + 8 * hmax - 1) // (8 * hmax)
    ch = (frame["H"] * c["v"] + 8 * vmax - 1) // (8 * vmax)
    eobrun = 0
    nblk = 0
    for byi in range(ch):
        for bxi in range(cw):
            if dri and nblk and nblk % dri == 0:
                resync()
                eobrun = 0
            nblk += 1
            blk = coeff[ci][byi, bxi]
            if ah == 0:
                # first pass for this band
                if eobrun > 0:
                    eobrun -= 1
                    continue
                k = ss
                while k <= se:
                    rs = rd.decode_huffman(huff_ac[ta])
                    r, sz = rs >> 4, rs & 15
                    if sz == 0:
                        if r == 15:
                            k += 16
                            continue
                        eobrun = (1 << r) - 1
                        if r:
                            eobrun += rd.read(r)
                        break
                    k += r
                    blk[k] = _extend(rd.read(sz), sz) << al
                    k += 1
            else:
                # refinement pass (T.81 G.2.2.3 correction bits)
                p1 = 1 << al
                m1 = -1 << al
                k = ss
                if eobrun == 0:
                    while k <= se:
                        rs = rd.decode_huffman(huff_ac[ta])
                        r, sz = rs >> 4, rs & 15
                        if sz == 0:
                            if r != 15:
                                eobrun = (1 << r)
                                if r:
                                    eobrun += rd.read(r)
                                break
                            val = 0
                        else:
                            val = p1 if rd.read(1) else m1
                        while k <= se:
                            if blk[k] != 0:
                                if rd.read(1) and (blk[k] & p1) == 0:
                                    blk[k] += p1 if blk[k] >= 0 else m1
                            else:
                                if r == 0:
                                    if val:
                                        blk[k] = val
                                    k += 1
                                    break
                                r -= 1
                            k += 1
                        else:
                            break
                if eobrun > 0:
                    # EOB run: only correction bits for nonzero coeffs
                    while k <= se:
                        if blk[k] != 0:
                            if rd.read(1) and (blk[k] & p1) == 0:
                                blk[k] += p1 if blk[k] >= 0 else m1
                        k += 1
                    eobrun -= 1
