"""FFV1 version-3 ('FFV1') in-AVI video codec — lossless, wheel-interoperable.

The reference reads/writes FFV1 through its FFmpeg backend
(modules/videoio/src/cap_ffmpeg.cpp:1); this is a from-scratch
implementation of the FFV1 bitstream (the format is specified in
RFC 9043): range coder for the ConfigurationRecord and slice headers,
Golomb-Rice coder for the sample residuals (coder_type 0 — what the
wheel's encoder emits by default), median predictor with 3/5-gradient
quantized contexts, and the JPEG2000 reversible color transform for RGB.

Everything needed to decode travels in the stream: the quant tables and
all coder parameters live in the range-coded ConfigurationRecord
(extradata), whose trailing CRC-32 (poly 0x04C11DB7, MSB-first) gives a
hard oracle that the parse is exact.  The header range-coder states are
built analytically (the 0.05-factor construction below), so no normative
state-transition table is required for coder_type 0 streams.

Interop facts established black-box against the installed wheel
(tests/test_ffv1.py):
- the wheel writes version 3, micro 4, coder_type 0 (Golomb-Rice),
  colorspace 1 (RGB) with transparency (BGRA), 2x2 slices, ec=1
  (per-slice CRC with an error-status byte), context model 0
  (the 11x11x11 3-gradient table);
- our encoder emits the same shape with transparency 0 and a single
  quant-table set; the wheel decodes it bit-exactly.

Twin of ``opencv_tpu/imgcodecs/ffv1.py``.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["decode_frame", "encode_frame_bgr", "build_extradata",
           "parse_extradata", "FFV1Decoder", "FFV1Encoder"]


# ---------------------------------------------------------------------------
# CRC-32 (poly 0x04C11DB7, MSB-first, init 0 — FFV1's slice/record CRC)
# ---------------------------------------------------------------------------

def _crc_table():
    tbl = np.zeros(256, np.uint32)
    for b in range(256):
        crc = b << 24
        for _ in range(8):
            crc = ((crc << 1) ^ 0x04C11DB7) if crc & 0x80000000 else (crc << 1)
            crc &= 0xFFFFFFFF
        tbl[b] = crc
    return tbl


_CRC_TBL = _crc_table()


def crc32_ffv1(data: bytes, crc: int = 0) -> int:
    """FFV1's CRC through the native ``crc32_msb``."""
    from ..native import crc32_msb
    return crc32_msb(data, crc)


def _crc32_ffv1_py(data: bytes, crc: int = 0) -> int:
    """The plain twin of :func:`crc32_ffv1`."""
    arr = np.frombuffer(data, np.uint8)
    tbl = _CRC_TBL
    for b in arr:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ int(tbl[((crc >> 24) ^ b) & 0xFF])
    return crc


# ---------------------------------------------------------------------------
# Range coder (the "0.05-factor" analytic state construction is used for
# the ConfigurationRecord and slice headers; coder_type 0 streams never
# need the normative default state-transition table)
# ---------------------------------------------------------------------------

def _build_rac_states(factor: int = int(0.05 * (1 << 32)), max_p: int = 248):
    one = 1 << 32
    one_state = [0] * 256
    last_p8 = 0
    p = one // 2
    for _ in range(128):
        p8 = (256 * p + one // 2) >> 32
        if p8 <= last_p8:
            p8 = last_p8 + 1
        if last_p8 and last_p8 < 256 and p8 <= max_p:
            one_state[last_p8] = p8
        p += ((one - p) * factor + one // 2) >> 32
        last_p8 = p8
    for i in range(256 - max_p, max_p + 1):
        if one_state[i]:
            continue
        p = (i * one + 128) >> 8
        p += ((one - p) * factor + one // 2) >> 32
        p8 = (256 * p + one // 2) >> 32
        if p8 <= i:
            p8 = i + 1
        if p8 > max_p:
            p8 = max_p
        one_state[i] = p8
    zero_state = [0] * 256
    for i in range(1, 255):
        zero_state[i] = 256 - one_state[256 - i]
    return one_state, zero_state


_ONE_STATE, _ZERO_STATE = _build_rac_states()


class RangeDecoder:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 2
        self.low = (buf[0] << 8) | buf[1] if len(buf) >= 2 else 0
        self.range = 0xFF00

    def _refill(self):
        if self.range < 0x100:
            self.range <<= 8
            self.low <<= 8
            if self.pos < len(self.buf):
                self.low += self.buf[self.pos]
            self.pos += 1

    def get_rac(self, state, i=0):
        r1 = (self.range * state[i]) >> 8
        self.range -= r1
        if self.low < self.range:
            state[i] = _ZERO_STATE[state[i]]
            self._refill()
            return 0
        self.low -= self.range
        self.range = r1
        state[i] = _ONE_STATE[state[i]]
        self._refill()
        return 1

    def get_symbol(self, state, signed: bool) -> int:
        if self.get_rac(state, 0):
            return 0
        e = 0
        while self.get_rac(state, 1 + min(e, 9)):
            e += 1
            if e > 31:
                raise ValueError("ffv1: corrupt symbol")
        a = 1
        for i in range(e - 1, -1, -1):
            a += a + self.get_rac(state, 22 + min(i, 9))
        if signed and self.get_rac(state, 11 + min(e, 10)):
            return -a
        return a


class RangeEncoder:
    def __init__(self):
        self.out = bytearray()
        self.low = 0
        self.range = 0xFF00
        self.outstanding_count = 0
        self.outstanding_byte = -1

    def _renorm(self):
        while self.range < 0x100:
            if self.outstanding_byte < 0:
                self.outstanding_byte = self.low >> 8
            elif self.low <= 0xFF00:
                self.out.append(self.outstanding_byte)
                self.out.extend(b"\xFF" * self.outstanding_count)
                self.outstanding_count = 0
                self.outstanding_byte = self.low >> 8
            elif self.low >= 0x10000:
                self.out.append(self.outstanding_byte + 1)
                self.out.extend(b"\x00" * self.outstanding_count)
                self.outstanding_count = 0
                self.outstanding_byte = (self.low >> 8) & 0xFF
            else:
                self.outstanding_count += 1
            self.low = (self.low & 0xFF) << 8
            self.range <<= 8

    def put_rac(self, state, i, bit):
        r1 = (self.range * state[i]) >> 8
        if bit:
            self.low += self.range - r1
            self.range = r1
            state[i] = _ONE_STATE[state[i]]
        else:
            self.range -= r1
            state[i] = _ZERO_STATE[state[i]]
        self._renorm()

    def put_symbol(self, state, v: int, signed: bool):
        if v:
            a = abs(v)
            e = a.bit_length() - 1
            self.put_rac(state, 0, 0)
            if e <= 9:
                for i in range(e):
                    self.put_rac(state, 1 + i, 1)
                self.put_rac(state, 1 + e, 0)
                for i in range(e - 1, -1, -1):
                    self.put_rac(state, 22 + i, (a >> i) & 1)
                if signed:
                    self.put_rac(state, 11 + e, int(v < 0))
            else:
                for i in range(e):
                    self.put_rac(state, 1 + min(i, 9), 1)
                self.put_rac(state, 1 + 9, 0)
                for i in range(e - 1, -1, -1):
                    self.put_rac(state, 22 + min(i, 9), (a >> i) & 1)
                if signed:
                    self.put_rac(state, 11 + 10, int(v < 0))
        else:
            self.put_rac(state, 0, 1)

    def terminate(self, version3: bool) -> bytes:
        """Flush; with version3 an extra 129-state zero bit first (the
        decoder reads it back before switching to the Golomb section)."""
        if version3:
            self.put_rac([129], 0, 0)
        self.range = 0xFF
        self.low += 0xFF
        self._renorm()
        self.range = 0xFF
        self._renorm()
        return bytes(self.out)


# ---------------------------------------------------------------------------
# MSB-first bit IO (the Golomb-Rice residual sections)
# ---------------------------------------------------------------------------

class BitReader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.bitpos = 0

    def get_bits(self, n: int) -> int:
        v = 0
        bp = self.bitpos
        buf = self.buf
        for _ in range(n):
            byte = buf[bp >> 3] if (bp >> 3) < len(buf) else 0
            v = (v << 1) | ((byte >> (7 - (bp & 7))) & 1)
            bp += 1
        self.bitpos = bp
        return v

    def get_bits1(self) -> int:
        bp = self.bitpos
        byte = self.buf[bp >> 3] if (bp >> 3) < len(self.buf) else 0
        self.bitpos = bp + 1
        return (byte >> (7 - (bp & 7))) & 1


class BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nacc = 0

    def put_bits(self, v: int, n: int):
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.nacc += n
        while self.nacc >= 8:
            self.nacc -= 8
            self.out.append((self.acc >> self.nacc) & 0xFF)
        self.acc &= (1 << self.nacc) - 1

    def flush(self) -> bytes:
        if self.nacc:
            self.out.append((self.acc << (8 - self.nacc)) & 0xFF)
            self.acc = 0
            self.nacc = 0
        return bytes(self.out)


# ---------------------------------------------------------------------------
# Golomb-Rice residual coder (coder_type 0)
# ---------------------------------------------------------------------------

# run-length order table (golomb run mode)
LOG2_RUN = [0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 5, 5,
            6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
            20, 21, 22, 23, 24]


def _get_ur_golomb(gb: BitReader, k: int, limit: int, esc_len: int) -> int:
    """Unsigned Rice: q zeros + '1' + k suffix bits when q < limit;
    otherwise `limit` zeros (the escape) + an esc_len-bit raw value,
    decoding to value + limit - 1."""
    q = 0
    while q < limit:
        if gb.get_bits1():
            return (q << k) | (gb.get_bits(k) if k else 0)
        q += 1
    return gb.get_bits(esc_len) + limit - 1


def _put_ur_golomb(pb: BitWriter, v: int, k: int, limit: int, esc_len: int):
    q = v >> k
    if q < limit:
        pb.put_bits(1, q + 1)          # q zeros then a 1
        if k:
            pb.put_bits(v & ((1 << k) - 1), k)
    else:
        pb.put_bits(0, limit)          # limit zeros = escape
        pb.put_bits(v - limit + 1, esc_len)


def _get_sr_golomb(gb, k, limit, esc_len):
    v = _get_ur_golomb(gb, k, limit, esc_len)
    return (v >> 1) ^ -(v & 1)


def _sr_map(v: int) -> int:
    return (v << 1) if v >= 0 else (((-v) << 1) - 1)


def _fold(diff: int, bits: int) -> int:
    diff &= (1 << bits) - 1
    if diff & (1 << (bits - 1)):
        diff -= 1 << bits
    return diff


def _mid_pred(a, b, c):
    """median of three (the FFV1 predictor median(L, T, L+T-LT))."""
    if a > b:
        a, b = b, a
    return min(b, max(a, c))


# VlcState is an int32[4] row {drift, error_sum, bias, count} inside a
# numpy array owned by the slice state — the same layout the native C
# fast path (hosttails.cpp ffv1_decode_slice/ffv1_encode_slice) mutates,
# so contexts persist across frames regardless of which tier ran.
_VLC_INIT = (0, 4, 0, 1)


def new_vlc_states(n: int) -> np.ndarray:
    return np.tile(np.array(_VLC_INIT, np.int32), (n, 1))


def _vlc_update(s, v: int):
    drift = int(s[0]) + v
    s[1] += abs(v)
    count = int(s[3])
    if count == 128:
        count >>= 1
        drift >>= 1
        s[1] >>= 1
    count += 1
    if drift <= -count:
        s[2] = max(int(s[2]) - 1, -128)
        drift = max(drift + count, -count + 1)
    elif drift > 0:
        s[2] = min(int(s[2]) + 1, 127)
        drift = min(drift - count, 0)
    s[0] = drift
    s[3] = count


def _vlc_k(s) -> int:
    i = int(s[3])
    es = int(s[1])
    k = 0
    while i < es:
        k += 1
        i += i
    return k


def _get_vlc_symbol(gb: BitReader, s, bits: int) -> int:
    k = _vlc_k(s)
    v = _get_sr_golomb(gb, k, 12, bits)
    if (2 * int(s[0]) + int(s[3])) < 0:
        v = -1 - v          # v ^= -1 when the bias correction is active
    ret = _fold(v + int(s[2]), bits)
    _vlc_update(s, v)
    return ret


def _put_vlc_symbol(pb: BitWriter, s, v: int, bits: int):
    k = _vlc_k(s)
    res = _fold(v - int(s[2]), bits)       # true residual
    code = res
    if (2 * int(s[0]) + int(s[3])) < 0:
        code = -1 - code                   # wire-only sign-bias flip
    _put_ur_golomb(pb, _sr_map(code), k, 12, bits)
    _vlc_update(s, res)                    # both sides track the residual


# ---------------------------------------------------------------------------
# context model
# ---------------------------------------------------------------------------

# the standard quant tables the wheel's encoder selects (recovered from
# its own ConfigurationRecord): an 11-level gradient quantizer and a
# 5-level one for the two extra gradients of the large context set
_Q11_RUNS = [(0, 1), (1, 1), (2, 3), (3, 7), (4, 23), (5, 93)]
_Q5_RUNS = [(0, 1), (1, 3), (2, 124)]


def _expand_quant(runs, scale):
    tbl = np.zeros(256, np.int32)
    i = 0
    nvals = 0
    for v, ln in runs:
        tbl[i:i + ln] = v * scale
        i += ln
        nvals = v + 1
    for j in range(1, 128):
        tbl[256 - j] = -tbl[j]
    tbl[128] = -tbl[127]
    return tbl, 2 * nvals - 1


def default_quant_tables():
    """The wheel's context model 0: 3 gradients, 11 levels each."""
    tabs = []
    scale = 1
    for runs in (_Q11_RUNS, _Q11_RUNS, _Q11_RUNS):
        tbl, levels = _expand_quant(runs, scale)
        tabs.append(tbl)
        scale *= levels
    tabs.append(np.zeros(256, np.int32))
    tabs.append(np.zeros(256, np.int32))
    return tabs, (scale + 1) // 2


# ---------------------------------------------------------------------------
# ConfigurationRecord
# ---------------------------------------------------------------------------

class FFV1Params:
    version = 3
    micro = 4
    ac = 0                      # Golomb-Rice
    colorspace = 1              # RGB (JPEG2000-RCT)
    bits = 8
    chroma_planes = 1
    ch_shift = 0
    cv_shift = 0
    transparency = 0
    num_h_slices = 1
    num_v_slices = 1
    ec = 1
    intra = 0

    def __init__(self):
        self.quant_tables = []      # list of (tabs[5], context_count)

    @property
    def plane_count(self):
        return 1 + 1 + (1 if self.transparency else 0)


def parse_extradata(extra: bytes) -> FFV1Params:
    if len(extra) < 8:
        raise ValueError("ffv1: extradata too short")
    if crc32_ffv1(extra) != 0:
        raise ValueError("ffv1: ConfigurationRecord CRC mismatch")
    c = RangeDecoder(extra[:-4])
    st = [128] * 32
    p = FFV1Params()
    p.version = c.get_symbol(st, False)
    if p.version < 3:
        raise ValueError("ffv1: extradata for version < 3")
    p.micro = c.get_symbol(st, False)
    p.ac = c.get_symbol(st, False)
    if p.ac == 2:               # custom state-transition table
        p.state_transition = [0] + [c.get_symbol(st, True) + _ONE_STATE[i]
                                    for i in range(1, 256)]
    elif p.ac == 1:
        raise ValueError("ffv1: coder_type 1 (default-table range coder) "
                         "not supported; the wheel emits coder_type 0")
    p.colorspace = c.get_symbol(st, False)
    p.bits = c.get_symbol(st, False) or 8
    p.chroma_planes = c.get_rac(st)
    p.ch_shift = c.get_symbol(st, False)
    p.cv_shift = c.get_symbol(st, False)
    p.transparency = c.get_rac(st)
    p.num_h_slices = c.get_symbol(st, False) + 1
    p.num_v_slices = c.get_symbol(st, False) + 1
    qtc = c.get_symbol(st, False)
    if not 0 < qtc <= 8:
        raise ValueError("ffv1: bad quant_table_count")
    for _ in range(qtc):
        tabs = []
        scale = 1
        for _g in range(5):
            st2 = [128] * 32
            tbl = np.zeros(256, np.int32)
            i = 0
            v = 0
            while i < 128:
                ln = c.get_symbol(st2, False) + 1
                if ln > 128 - i:
                    raise ValueError("ffv1: bad quant table")
                tbl[i:i + ln] = v * scale
                i += ln
                v += 1
            for j in range(1, 128):
                tbl[256 - j] = -tbl[j]
            tbl[128] = -tbl[127]
            tabs.append(tbl)
            scale *= 2 * v - 1
        p.quant_tables.append((tabs, (scale + 1) // 2))
    for _ in range(qtc):
        if c.get_rac(st):
            raise ValueError("ffv1: explicit initial states not supported")
    p.ec = c.get_symbol(st, False)
    p.intra = c.get_symbol(st, False)
    return p


def _write_quant_table(c: RangeEncoder, runs):
    st = [128] * 32
    for _v, ln in runs:
        c.put_symbol(st, ln - 1, False)


def build_extradata(num_h_slices=1, num_v_slices=1) -> bytes:
    """ConfigurationRecord for our encoder: v3.4, Golomb-Rice, RGB 8-bit,
    no alpha, one 11x11x11 quant-table set, per-slice CRCs."""
    c = RangeEncoder()
    st = [128] * 32
    c.put_symbol(st, 3, False)          # version
    c.put_symbol(st, 4, False)          # micro_version
    c.put_symbol(st, 0, False)          # coder_type: Golomb-Rice
    c.put_symbol(st, 1, False)          # colorspace: RGB
    c.put_symbol(st, 8, False)          # bits_per_raw_sample
    c.put_rac(st, 0, 1)                 # chroma_planes
    c.put_symbol(st, 0, False)          # h shift
    c.put_symbol(st, 0, False)          # v shift
    c.put_rac(st, 0, 0)                 # transparency
    c.put_symbol(st, num_h_slices - 1, False)
    c.put_symbol(st, num_v_slices - 1, False)
    c.put_symbol(st, 1, False)          # quant_table_count
    for _ in range(3):
        _write_quant_table(c, _Q11_RUNS)
    for _ in range(2):
        _write_quant_table(c, [(0, 128)])
    c.put_rac(st, 0, 0)                 # no explicit initial states
    c.put_symbol(st, 1, False)          # ec: slice CRCs
    c.put_symbol(st, 0, False)          # intra
    body = c.terminate(False)
    crc = crc32_ffv1(body)
    return body + struct.pack(">I", crc)


# ---------------------------------------------------------------------------
# slice residual coding
# ---------------------------------------------------------------------------

def _decode_line(gb, w, cur, prev, prev2, qt, vlc_states, run_state, bits,
                 five):
    """One line of one plane.  cur/prev/prev2 are int32 arrays of length
    w+4 with 2 guard cells on the left (index base 2)."""
    run_index = run_state[0]
    run_mode = 0
    run_count = 0
    q0, q1, q2, q3, q4 = qt
    x = 0
    while x < w:
        b = x + 2
        l = cur[b - 1]
        t = prev[b]
        lt = prev[b - 1]
        rt = prev[b + 1]
        context = (q0[(l - lt) & 0xFF] + q1[(lt - t) & 0xFF]
                   + q2[(t - rt) & 0xFF])
        if five:
            context += (q3[(cur[b - 2] - l) & 0xFF]
                        + q4[(prev2[b] - t) & 0xFF])
        if context < 0:
            context = -context
            sign = 1
        else:
            sign = 0
        if context == 0 and run_mode == 0:
            run_mode = 1
        if run_mode:
            if run_count == 0 and run_mode == 1:
                if gb.get_bits1():
                    run_count = 1 << LOG2_RUN[run_index]
                    if x + run_count <= w:
                        run_index += 1
                else:
                    if LOG2_RUN[run_index]:
                        run_count = gb.get_bits(LOG2_RUN[run_index])
                    else:
                        run_count = 0
                    if run_index:
                        run_index -= 1
                    run_mode = 2
            run_count -= 1
            if run_count < 0:
                run_mode = 0
                run_count = 0
                diff = _get_vlc_symbol(gb, vlc_states[context], bits)
                if diff >= 0:
                    diff += 1
            else:
                diff = 0
        else:
            diff = _get_vlc_symbol(gb, vlc_states[context], bits)
        if sign:
            diff = -diff
        pred = _mid_pred(l, t, l + t - lt)
        cur[b] = (pred + diff) & ((1 << bits) - 1)
        x += 1
    run_state[0] = run_index


def _encode_line(pb, w, cur, prev, prev2, qt, vlc_states, run_state, bits,
                 five):
    run_index = run_state[0]
    run_mode = 0
    run_count = 0
    q0, q1, q2, q3, q4 = qt
    x = 0
    while x < w:
        b = x + 2
        l = cur[b - 1]
        t = prev[b]
        lt = prev[b - 1]
        rt = prev[b + 1]
        context = (q0[(l - lt) & 0xFF] + q1[(lt - t) & 0xFF]
                   + q2[(t - rt) & 0xFF])
        if five:
            context += (q3[(cur[b - 2] - l) & 0xFF]
                        + q4[(prev2[b] - t) & 0xFF])
        if context < 0:
            context = -context
            sign = 1
        else:
            sign = 0
        diff = cur[b] - _mid_pred(l, t, l + t - lt)
        if sign:
            diff = -diff
        diff = _fold(diff, bits)
        if context == 0 and run_mode == 0:
            run_mode = 1
        if run_mode:
            if diff:
                # flush full-run chunks, then the terminator (0 + count)
                while run_count >= (1 << LOG2_RUN[run_index]):
                    run_count -= 1 << LOG2_RUN[run_index]
                    run_index += 1
                    pb.put_bits(1, 1)
                pb.put_bits(run_count, 1 + LOG2_RUN[run_index])
                if run_index:
                    run_index -= 1
                run_count = 0
                run_mode = 0
                if diff > 0:
                    diff -= 1
            else:
                run_count += 1
        if run_mode == 0:
            _put_vlc_symbol(pb, vlc_states[context], diff, bits)
        x += 1
    if run_mode:
        while run_count >= (1 << LOG2_RUN[run_index]):
            run_count -= 1 << LOG2_RUN[run_index]
            run_index += 1
            pb.put_bits(1, 1)
        if run_count:
            pb.put_bits(1, 1)   # partial leftover claimed as a full run
    run_state[0] = run_index


# ---------------------------------------------------------------------------
# slice geometry + state
# ---------------------------------------------------------------------------

def _slice_coord(dim, idx, num):
    return dim * idx // num


def _qts_array(params: FFV1Params) -> np.ndarray:
    return np.ascontiguousarray(
        np.stack([np.stack(tabs) for tabs, _ in params.quant_tables]),
        dtype=np.int32)


class _SliceState:
    """Per-slice contexts; persists across frames for inter frames.

    ``arr`` has shape (plane_count, max_cc, 4) int32 — shared between the
    Python tier and the native C tier."""

    def __init__(self, params: FFV1Params, qt_indices):
        self.qt_indices = list(qt_indices)
        self.params = params
        self.max_cc = max(params.quant_tables[i][1] for i in qt_indices)
        self.arr = np.empty((params.plane_count, self.max_cc, 4), np.int32)
        self.reset()

    def reset(self):
        self.arr[:] = _VLC_INIT

    @property
    def vlc(self):
        return self.arr


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

class FFV1Decoder:
    def __init__(self, extradata: bytes, width: int, height: int):
        self.p = parse_extradata(extradata)
        if self.p.colorspace != 1 or self.p.bits != 8:
            raise ValueError("ffv1: only 8-bit RGB streams supported")
        self.w = width
        self.h = height
        self.slice_states = {}

    def decode(self, packet: bytes) -> np.ndarray:
        p = self.p
        n_slices = p.num_h_slices * p.num_v_slices
        trailer = 3 + (5 if p.ec else 0)
        # locate slices from the tail
        spans = []
        end = len(packet)
        for _i in range(n_slices):
            if end - trailer < 0:
                raise ValueError("ffv1: truncated packet")
            v = ((packet[end - trailer] << 16)
                 | (packet[end - trailer + 1] << 8)
                 | packet[end - trailer + 2]) + trailer
            start = end - v
            if start < 0:
                raise ValueError("ffv1: bad slice size")
            if p.ec and crc32_ffv1(packet[start:end]) != 0:
                raise ValueError("ffv1: slice CRC mismatch")
            spans.append((start, end - trailer))
            end = start
        if end != 0:
            raise ValueError("ffv1: slice sizes do not cover the packet")
        spans.reverse()

        nplanes = 3 + (1 if p.transparency else 0)
        out = np.zeros((self.h, self.w, 4), np.uint8)
        keyframe = None
        for si, (start, stop) in enumerate(spans):
            c = RangeDecoder(packet[start:stop])
            if si == 0:
                keyframe = c.get_rac([128])
            self._decode_slice(c, packet[start:stop], si, out, nplanes,
                               keyframe)
        return out[:, :, :3]        # BGR

    def _decode_slice(self, c, chunk, si, out, nplanes, keyframe):
        p = self.p
        st = [128] * 32
        sx = c.get_symbol(st, False)
        sy = c.get_symbol(st, False)
        sw = c.get_symbol(st, False) + 1
        sh = c.get_symbol(st, False) + 1
        qt_idx = [c.get_symbol(st, False) for _ in range(p.plane_count)]
        c.get_symbol(st, False)                     # picture structure
        c.get_symbol(st, False)                     # sar num
        c.get_symbol(st, False)                     # sar den
        x0 = _slice_coord(self.w, sx, p.num_h_slices)
        x1 = _slice_coord(self.w, sx + sw, p.num_h_slices)
        y0 = _slice_coord(self.h, sy, p.num_v_slices)
        y1 = _slice_coord(self.h, sy + sh, p.num_v_slices)
        w = x1 - x0
        h = y1 - y0

        key = (sx, sy)
        state = self.slice_states.get(key)
        if state is None or state.qt_indices != qt_idx:
            state = _SliceState(p, qt_idx)
            self.slice_states[key] = state
        if keyframe:
            state.reset()

        # switch to the Golomb bit reader: the rac coder has read one
        # byte ahead, plus the micro>1 129-state termination bit
        if p.micro > 1:
            c.get_rac([129])
        ac_bytes = c.pos - 1
        bits = 9                                     # 8-bit RGB: bits+1

        from ..native import ffv1_decode_slice
        if not hasattr(self, "_qts"):
            self._qts = _qts_array(p)
        plane_ctx = np.array([(pl + 1) // 2 for pl in range(nplanes)],
                             np.int32)
        ctx_qt = np.array(qt_idx, np.int32)
        samples = np.empty((h, nplanes, w), np.int32)
        run_io = np.zeros(1, np.int32)
        ffv1_decode_slice(np.frombuffer(chunk, np.uint8)[ac_bytes:], w, h,
                          nplanes, bits, self._qts, plane_ctx, ctx_qt,
                          state.arr, state.max_cc, run_io, samples)
        g = samples[:, 0]
        b = samples[:, 1] - 256
        r = samples[:, 2] - 256
        gg = g - ((b + r) >> 2)
        out[y0:y1, x0:x1, 0] = (b + gg) & 0xFF
        out[y0:y1, x0:x1, 1] = gg & 0xFF
        out[y0:y1, x0:x1, 2] = (r + gg) & 0xFF
        if nplanes == 4:
            out[y0:y1, x0:x1, 3] = samples[:, 3] & 0xFF


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

class FFV1Encoder:
    def __init__(self, width: int, height: int):
        self.w = width
        self.h = height
        self.extradata = build_extradata(1, 1)
        self.p = parse_extradata(self.extradata)

    def encode(self, bgr: np.ndarray) -> bytes:
        """One keyframe packet (single slice)."""
        p = self.p
        h, w = self.h, self.w
        assert bgr.shape[:2] == (h, w)
        b = bgr[:, :, 0].astype(np.int32)
        g = bgr[:, :, 1].astype(np.int32)
        r = bgr[:, :, 2].astype(np.int32)
        bb = b - g
        rr = r - g
        gg = g + ((bb + rr) >> 2)
        planes = [gg & 0x1FF, (bb + 256) & 0x1FF, (rr + 256) & 0x1FF]

        c = RangeEncoder()
        c.put_rac([128], 0, 1)                     # keyframe
        st = [128] * 32
        c.put_symbol(st, 0, False)                 # sx
        c.put_symbol(st, 0, False)                 # sy
        c.put_symbol(st, 0, False)                 # sw-1
        c.put_symbol(st, 0, False)                 # sh-1
        for _ in range(p.plane_count):
            c.put_symbol(st, 0, False)             # quant table index
        c.put_symbol(st, 0, False)                 # picture structure
        c.put_symbol(st, 0, False)                 # sar num
        c.put_symbol(st, 0, False)                 # sar den
        rac = c.terminate(True)

        tabs, ccount = p.quant_tables[0]
        vlc = new_vlc_states(2 * ccount).reshape(2, ccount, 4)
        from ..native import ffv1_encode_slice
        if not hasattr(self, "_qts"):
            self._qts = _qts_array(p)
        samples = np.ascontiguousarray(
            np.stack(planes, axis=1), dtype=np.int32)  # (h, 3, w)
        plane_ctx = np.array([0, 1, 1], np.int32)
        ctx_qt = np.zeros(2, np.int32)
        run_io = np.zeros(1, np.int32)
        payload = rac + ffv1_encode_slice(samples, w, h, 3, 9, self._qts,
                                          plane_ctx, ctx_qt, vlc, ccount,
                                          run_io)
        sz = struct.pack(">I", len(payload))[1:]    # uint24
        body = payload + sz + b"\x00"               # error status 0
        crc = crc32_ffv1(body)
        return body + struct.pack(">I", crc)


# ---------------------------------------------------------------------------
# the plain twins of the native slice coder
# ---------------------------------------------------------------------------

def _decode_samples_py(stream: bytes, w: int, h: int, nplanes: int,
                       bits: int, p: FFV1Params, qt_idx, vlc) -> np.ndarray:
    """The plain twin of the native ``ffv1_decode_slice``: the (h, nplanes,
    w) int32 samples of one slice's Golomb-Rice residuals; `vlc` (the
    contexts, (planes, contexts, 4) int32) is updated in place."""
    gb = BitReader(stream)
    # 2 previous lines + current, per plane, with 2 left guards +
    # 2 right guards (int32)
    lines = [np.zeros((3, w + 5), np.int32) for _ in range(nplanes)]
    run_state = [0]
    samples = np.empty((h, nplanes, w), np.int32)
    for y in range(h):
        for pl in range(nplanes):
            plane_index = (pl + 1) // 2
            tabs, _cc = p.quant_tables[qt_idx[plane_index]]
            five = bool(tabs[3][127] or tabs[4][127])
            buf = lines[pl]
            prev2, prev, cur = buf[0], buf[1], buf[2]
            # rotate: cur becomes prev, prev becomes prev2
            buf[:] = np.stack([prev, cur, prev2])
            prev2, prev, cur = buf[0], buf[1], buf[2]
            cur[1] = prev[2]                    # left guard = T
            cur[0] = prev[2]
            prev[w + 2] = prev[w + 1]           # right guard
            prev[w + 3] = prev[w + 1]
            _decode_line(gb, w, cur, prev, prev2, tabs,
                         vlc[plane_index], run_state, bits, five)
            samples[y, pl] = cur[2:w + 2]
    return samples


def _encode_samples_py(planes, w: int, h: int, tabs, vlc) -> bytes:
    """The plain twin of the native ``ffv1_encode_slice`` over the three
    (h, w) planes at 9 bits; `vlc` ((2, contexts, 4) int32) is updated in
    place."""
    pb = BitWriter()
    lines = [np.zeros((3, w + 5), np.int32) for _ in range(3)]
    run_state = [0]
    for y in range(h):
        for pl in range(3):
            plane_index = (pl + 1) // 2
            buf = lines[pl]
            prev2, prev, cur = buf[0], buf[1], buf[2]
            buf[:] = np.stack([prev, cur, prev2])
            prev2, prev, cur = buf[0], buf[1], buf[2]
            cur[2:w + 2] = planes[pl][y]
            cur[1] = prev[2]
            cur[0] = prev[2]
            prev[w + 2] = prev[w + 1]
            prev[w + 3] = prev[w + 1]
            _encode_line(pb, w, cur, prev, prev2, tabs,
                         vlc[plane_index], run_state, 9, False)
    return pb.flush()


# ---------------------------------------------------------------------------
# module-level helpers (videoio wiring)
# ---------------------------------------------------------------------------

def decode_frame(packet: bytes, extradata: bytes, size) -> np.ndarray:
    """size = (width, height); returns BGR uint8."""
    w, h = size
    dec = FFV1Decoder(extradata, w, h)
    return dec.decode(packet)


def encode_frame_bgr(frame: np.ndarray) -> bytes:
    h, w = frame.shape[:2]
    return FFV1Encoder(w, h).encode(frame)
