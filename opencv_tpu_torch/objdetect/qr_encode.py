"""QRCodeEncoder (objdetect/src/qrcode_encoder.cpp): full QR symbol
generation — mode auto-selection, version/EC capacity search, RS ECC,
block interleave, function patterns, data zigzag, the reference's mask
penalty scoring, format/version info — validated bit-exact against the
reference wheel's encoder.  Twin of ``opencv_tpu/objdetect/qr_encode.py``,
copied with its tables (the port's own ``qr_tables.json``).

Host tier by design (tiny data, sequential bit twiddling), mirroring the
reference and the JAX package.
"""

from __future__ import annotations

import json
import os

import numpy as np

__all__ = ["QRCodeEncoder"]

_ALNUM = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ $%*+-./:"

# mode indicator values (ISO 18004 table 2)
MODE_NUMERIC = 1
MODE_ALPHANUMERIC = 2
MODE_BYTE = 4
MODE_ECI = 7
MODE_KANJI = 8
MODE_STRUCTURED_APPEND = 3
MODE_AUTO = -1

CORRECT_LEVEL_L = 0
CORRECT_LEVEL_M = 1
CORRECT_LEVEL_Q = 2
CORRECT_LEVEL_H = 3

_MAX_VERSION = 40

# character capacity per (version, ec level) and mode, ISO table 7
# (numeric, alphanumeric, byte, kanji) — derived from data codewords
_GF_EXP = np.zeros(512, np.int64)
_GF_LOG = np.zeros(256, np.int64)
_x = 1
for _i in range(255):
    _GF_EXP[_i] = _x
    _GF_LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= 0x11D
for _i in range(255, 512):
    _GF_EXP[_i] = _GF_EXP[_i - 255]


def _gf_mul(a, b):
    if a == 0 or b == 0:
        return 0
    return int(_GF_EXP[_GF_LOG[a] + _GF_LOG[b]])


def _tables():
    path = os.path.join(os.path.dirname(__file__), "qr_tables.json")
    return json.load(open(path))


_T = None


def _vinfo(version):
    global _T
    if _T is None:
        _T = _tables()
    return _T[version]


def _ecc_params(version, ecc):
    e = _vinfo(version)["ecc"][ecc]
    # [ecc_codewords, blocks_G1, data_G1, blocks_G2, data_G2]
    return dict(ecc_codewords=e[0], nb1=e[1], d1=e[2], nb2=e[3], d2=e[4])


def _data_codewords(version, ecc):
    p = _ecc_params(version, ecc)
    return p["nb1"] * p["d1"] + p["nb2"] * p["d2"]


def _count_bits(mode, version):
    if mode == MODE_NUMERIC:
        return 14 if version >= 27 else (12 if version >= 10 else 10)
    if mode == MODE_ALPHANUMERIC:
        return 13 if version >= 27 else (11 if version >= 10 else 9)
    if mode == MODE_BYTE:
        return 16 if version >= 10 else 8
    if mode == MODE_KANJI:
        return 12 if version >= 27 else (10 if version >= 10 else 8)
    raise ValueError(mode)


def _capacity(version, ecc, mode):
    """Character capacity (getCapacity, qrcode_encoder.cpp:283) —
    computed from data codeword budget like ISO table 7."""
    bits = _data_codewords(version, ecc) * 8 - 4 - _count_bits(mode, version)
    if bits < 0:
        return 0
    if mode == MODE_NUMERIC:
        full = (bits // 10) * 3
        rem = bits % 10
        return full + (2 if rem >= 7 else (1 if rem >= 4 else 0))
    if mode == MODE_ALPHANUMERIC:
        full = (bits // 11) * 2
        return full + (1 if bits % 11 >= 6 else 0)
    if mode == MODE_BYTE:
        return bits // 8
    if mode == MODE_KANJI:
        return bits // 13
    raise ValueError(mode)


def _write(num, bits, out):
    for i in range(bits - 1, -1, -1):
        out.append((num >> i) & 1)


def _is_numeric(s):
    return len(s) > 0 and all("0" <= c <= "9" for c in s)


def _is_alnum(s):
    return len(s) > 0 and all(c in _ALNUM for c in s)


def _auto_mode(s):
    if _is_numeric(s):
        return MODE_NUMERIC
    if _is_alnum(s):
        return MODE_ALPHANUMERIC
    return MODE_BYTE


def _encode_payload(s, mode, version):
    out = []
    n = len(s)
    if mode == MODE_NUMERIC:
        _write(MODE_NUMERIC, 4, out)
        _write(n, _count_bits(MODE_NUMERIC, version), out)
        i = 0
        while i + 3 <= n:
            _write(int(s[i:i + 3]), 10, out)
            i += 3
        if i + 2 == n:
            _write(int(s[i:i + 2]), 7, out)
        elif i + 1 == n:
            _write(int(s[i]), 4, out)
    elif mode == MODE_ALPHANUMERIC:
        _write(MODE_ALPHANUMERIC, 4, out)
        _write(n, _count_bits(MODE_ALPHANUMERIC, version), out)
        i = 0
        while i + 2 <= n:
            v = _ALNUM.index(s[i]) * 45 + _ALNUM.index(s[i + 1])
            _write(v, 11, out)
            i += 2
        if i < n:
            _write(_ALNUM.index(s[i]), 6, out)
    elif mode == MODE_BYTE:
        data = s.encode("latin-1") if isinstance(s, str) else bytes(s)
        _write(MODE_BYTE, 4, out)
        _write(len(data), _count_bits(MODE_BYTE, version), out)
        for b in data:
            _write(b, 8, out)
    else:
        raise NotImplementedError(f"mode {mode}")
    return out


def _find_version(s, mode, ecc, requested):
    if requested:
        return requested
    # estimateVersion (qrcode_encoder.cpp:299): smallest fitting by
    # char capacity, then findVersionCapacity by payload bits over
    # [smallest, smallest+1]
    n = len(s)
    if n > _capacity(_MAX_VERSION, ecc, mode):
        raise ValueError("input too long for any version")
    version = _MAX_VERSION
    while version > 0:
        if n > _capacity(version, ecc, mode):
            break
        version -= 1
    if version < _MAX_VERSION:
        version += 1
    possible = [version]
    if version < _MAX_VERSION:
        possible.append(version + 1)
    # payload is sized with the PRE-SELECTION version's count field
    # (versionAuto encodes before the version is known; version_level
    # starts at the requested value, 0 here -> smallest count widths)
    nbits = len(_encode_payload(s, mode, 0))
    for v in possible:
        if _data_codewords(v, ecc) * 8 >= nbits:
            return v
    return -1


def _pad(payload, version, ecc):
    total = _data_codewords(version, ecc) * 8
    pad = total - len(payload)
    if pad <= 0:
        return payload
    if pad <= 4:
        # replicate qrcode_encoder.cpp padBitStream verbatim (it appends
        # len(payload) zeros in this branch)
        payload = payload + [0] * len(payload)
        return payload[:total]
    payload = payload + [0] * 4
    if len(payload) % 8:
        payload = payload + [0] * (8 - len(payload) % 8)
    rem = (total - len(payload)) // 8
    pats = (236, 17)
    for j in range(rem):
        _write(pats[j % 2], 8, payload)
    return payload


def _poly_gen(necc):
    g = [1]
    for i in range(necc):
        g2 = [0] * (len(g) + 1)
        for j, c in enumerate(g):
            g2[j] ^= _gf_mul(c, int(_GF_EXP[i]))
            g2[j + 1] ^= c
        g = g2
    return g[::-1]  # highest degree first


def _rs_ecc(block, necc):
    gen = _poly_gen(necc)
    msg = list(block) + [0] * necc
    for i in range(len(block)):
        c = msg[i]
        if c:
            for j in range(1, len(gen)):
                msg[i + j] ^= _gf_mul(gen[j], c)
    return msg[len(block):]


def _alignment_positions(version):
    return _vinfo(version)["align"]


_FORMAT_GEN = 0b10100110111
_FORMAT_MASK = 0b101010000010010
_VERSION_GEN = 0b1111100100101


def _bch(value, nbits, gen, glen):
    v = value << (glen - 1)
    for i in range(nbits - 1, -1, -1):
        if v & (1 << (i + glen - 1)):
            v ^= gen << i
    return v


def _format_bits(ecc, mask):
    ecc_code = {CORRECT_LEVEL_L: 0b01, CORRECT_LEVEL_M: 0b00,
                CORRECT_LEVEL_Q: 0b11, CORRECT_LEVEL_H: 0b10}[ecc]
    data = (ecc_code << 3) | mask
    rem = _bch(data, 5, _FORMAT_GEN, 11)
    return ((data << 10) | rem) ^ _FORMAT_MASK


def _version_bits(version):
    rem = _bch(version, 6, _VERSION_GEN, 13)
    return (version << 12) | rem


def _build_function_mask(n, version):
    """True where modules are function patterns (not data)."""
    fm = np.zeros((n, n), bool)
    for (r, c) in ((0, 0), (0, n - 7), (n - 7, 0)):
        fm[max(r - 1, 0):r + 8, max(c - 1, 0):c + 8] = True
    fm[6, :] = True
    fm[:, 6] = True
    ap = _alignment_positions(version)
    for ay in ap:
        for ax in ap:
            if (ay < 8 and ax < 8) or (ay < 8 and ax > n - 9) or \
                    (ay > n - 9 and ax < 8):
                continue
            fm[ay - 2:ay + 3, ax - 2:ax + 3] = True
    # format info areas
    fm[8, :9] = True
    fm[:9, 8] = True
    fm[8, n - 8:] = True
    fm[n - 8:, 8] = True
    if version >= 7:
        fm[:6, n - 11:n - 8] = True
        fm[n - 11:n - 8, :6] = True
    return fm


def _draw_function_patterns(m, version):
    """m: (n,n) uint8, 0=dark 255=light; draws finder/timing/alignment
    and the dark module."""
    n = m.shape[0]
    m[:, :] = 255

    def finder(r, c):
        m[r:r + 7, c:c + 7] = 0
        m[r + 1:r + 6, c + 1:c + 6] = 255
        m[r + 2:r + 5, c + 2:c + 5] = 0

    finder(0, 0)
    finder(0, n - 7)
    finder(n - 7, 0)
    # separators
    m[7, :8] = 255
    m[:8, 7] = 255
    m[7, n - 8:] = 255
    m[:8, n - 8] = 255
    m[n - 8, :8] = 255
    m[n - 8:, 7] = 255
    # timing patterns only BETWEEN the finders
    for i in range(8, n - 8):
        v = 0 if i % 2 == 0 else 255
        m[6, i] = v
        m[i, 6] = v
    ap = _alignment_positions(version)
    for ay in ap:
        for ax in ap:
            if (ay < 8 and ax < 8) or (ay < 8 and ax > n - 9) or \
                    (ay > n - 9 and ax < 8):
                continue
            m[ay - 2:ay + 3, ax - 2:ax + 3] = 0
            m[ay - 1:ay + 2, ax - 1:ax + 2] = 255
            m[ay, ax] = 0
    m[n - 8, 8] = 0  # dark module
    return m


def _zigzag_coords(n, fmask):
    coords = []
    col = n - 1
    upward = True
    while col > 0:
        if col == 6:
            col -= 1
        rows = range(n - 1, -1, -1) if upward else range(n)
        for r in rows:
            for c in (col, col - 1):
                if not fmask[r, c]:
                    coords.append((r, c))
        upward = not upward
        col -= 2
    return coords


def _mask_bit(mask, i, j):
    if mask == 0:
        return (i + j) % 2 == 0
    if mask == 1:
        return i % 2 == 0
    if mask == 2:
        return j % 3 == 0
    if mask == 3:
        return (i + j) % 3 == 0
    if mask == 4:
        return (i // 2 + j // 3) % 2 == 0
    if mask == 5:
        return (i * j) % 2 + (i * j) % 3 == 0
    if mask == 6:
        return ((i * j) % 2 + (i * j) % 3) % 2 == 0
    return ((i + j) % 2 + (i * j) % 3) % 2 == 0


def _mask_flip(n, mask):
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    if mask == 0:
        return (ii + jj) % 2 == 0
    if mask == 1:
        return ii % 2 == 0
    if mask == 2:
        return jj % 3 == 0
    if mask == 3:
        return (ii + jj) % 3 == 0
    if mask == 4:
        return (ii // 2 + jj // 3) % 2 == 0
    if mask == 5:
        return ((ii * jj) % 2 + (ii * jj) % 3) == 0
    if mask == 6:
        return (((ii * jj) % 2 + (ii * jj) % 3) % 2) == 0
    return (((ii + jj) % 2 + (ii * jj) % 3) % 2) == 0


def _apply_mask(display, original, fmask, mask):
    """The reference's maskData (qrcode_encoder.cpp): flipped cells are
    assigned `original ^ 255` (original holds 255 at unwritten remainder
    modules), non-flipped cells keep the DISPLAY value (which carries
    the writeReservedArea pre-darkening quirk)."""
    flip = _mask_flip(display.shape[0], mask) & ~fmask
    out = display.copy()
    out[flip] = original[flip] ^ 255
    return out


def _place_format(m, fbits, n):
    bits = [(fbits >> (14 - k)) & 1 for k in range(15)]

    def put(r, c, bit):
        m[r, c] = 0 if bit else 255

    # around the top-left finder
    cpos = [(8, 0), (8, 1), (8, 2), (8, 3), (8, 4), (8, 5), (8, 7),
            (8, 8), (7, 8), (5, 8), (4, 8), (3, 8), (2, 8), (1, 8),
            (0, 8)]
    for k, (r, c) in enumerate(cpos):
        put(r, c, bits[k])
    # split copy: bottom-left column + top-right row
    for k in range(7):
        put(n - 1 - k, 8, bits[k])
    for k in range(8):
        put(8, n - 8 + k, bits[7 + k])


def _place_version(m, version, n):
    if version < 7:
        return
    vbits = _version_bits(version)
    for k in range(18):
        bit = (vbits >> k) & 1
        r = k // 3
        c = n - 11 + k % 3
        m[r, c] = 0 if bit else 255
        m[c, r] = 0 if bit else 255


def _penalties(m):
    """The reference's findAutoMaskType scoring (qrcode_encoder.cpp:835)."""
    n = m.shape[0]
    dark = m == 0
    p1 = 0
    for arr in (m, m.T):
        for i in range(n):
            row = arr[i]
            run = 1
            for j in range(1, n):
                if row[j] == row[j - 1]:
                    run += 1
                    if j == n - 1 and run >= 5:
                        p1 += 3 + run - 5
                else:
                    if run >= 5:
                        p1 += 3 + run - 5
                    run = 1
    p2 = 0
    same = ((m[:-1, :-1] == m[:-1, 1:]) & (m[:-1, :-1] == m[1:, 1:])
            & (m[:-1, :-1] == m[1:, :-1]))
    p2 = 3 * int(same.sum())
    pat0 = np.array([255, 255, 255, 255, 0, 255, 0, 0, 0, 255, 0],
                    np.uint8)
    pat1 = np.array([0, 255, 0, 0, 0, 255, 0, 255, 255, 255, 255],
                    np.uint8)
    p3 = 0
    for arr in (m, m.T):
        if n >= 11:
            win = np.lib.stride_tricks.sliding_window_view(arr, 11,
                                                           axis=1)
            p3 += 40 * int((win == pat0).all(axis=2).sum())
            p3 += 40 * int((win == pat1).all(axis=2).sum())
    pct = int(dark.sum()) * 100 // (n * n)
    diff = min(abs(pct - 45), abs(pct - 55))
    p4 = (diff // 5) * 10
    return p1 + p2 + p3 + p4


class QRCodeEncoder:
    """cv2.QRCodeEncoder-compatible (create/encode)."""

    MODE_AUTO = MODE_AUTO
    MODE_NUMERIC = MODE_NUMERIC
    MODE_ALPHANUMERIC = MODE_ALPHANUMERIC
    MODE_BYTE = MODE_BYTE
    CORRECT_LEVEL_L = CORRECT_LEVEL_L
    CORRECT_LEVEL_M = CORRECT_LEVEL_M
    CORRECT_LEVEL_Q = CORRECT_LEVEL_Q
    CORRECT_LEVEL_H = CORRECT_LEVEL_H

    def __init__(self, version=0, correction_level=CORRECT_LEVEL_L,
                 mode=MODE_AUTO):
        self.version = version
        self.correction_level = correction_level
        self.mode = mode

    @staticmethod
    def create(params=None):
        if params is None:
            return QRCodeEncoder()
        return QRCodeEncoder(
            version=getattr(params, "version", 0),
            correction_level=getattr(params, "correction_level",
                                     CORRECT_LEVEL_L),
            mode=getattr(params, "mode", MODE_AUTO))

    def encode(self, text):
        ecc = self.correction_level
        mode = self.mode if self.mode != MODE_AUTO else _auto_mode(text)
        version = _find_version(text, mode, ecc, self.version)
        if version <= 0:
            raise ValueError("cannot encode input")
        payload = _encode_payload(text, mode, version)
        payload = _pad(payload, version, ecc)

        p = _ecc_params(version, ecc)
        necc = p["ecc_codewords"]
        blocks = []
        eccs = []
        k = 0
        for b in range(p["nb1"] + p["nb2"]):
            blen = p["d1"] if b < p["nb1"] else p["d2"]
            data = []
            for _ in range(blen):
                v = 0
                for _i in range(8):
                    v = (v << 1) | payload[k]
                    k += 1
                data.append(v)
            blocks.append(data)
            eccs.append(_rs_ecc(data, necc))

        # interleave (rearrangeBlocks)
        final = []
        maxd = max(len(b) for b in blocks)
        for i in range(maxd):
            for b in blocks:
                if i < len(b):
                    final.append(b[i])
        for i in range(necc):
            for e in eccs:
                final.append(e[i])

        n = 21 + 4 * (version - 1)
        m = np.full((n, n), 255, np.uint8)
        _draw_function_patterns(m, version)
        # reference quirk (writeReservedArea, qrcode_encoder.cpp): the
        # bottom-left finder's outer ring loop darkens row n-9 cells
        # (cols 3+j, |j| != 4) in masked_data WITHOUT marking them
        # reserved — remainder modules there inherit the dark state
        for j in range(-5, 6):
            if abs(j) == 4:
                continue
            c = 3 + j
            if 0 <= c < n:
                m[n - 9, c] = 0
        fmask = _build_function_mask(n, version)
        coords = _zigzag_coords(n, fmask)
        bits = []
        for v in final:
            for i in range(7, -1, -1):
                bits.append((v >> i) & 1)
        # `original` mirrors the reference's data matrix: 255 everywhere
        # except placed data; unwritten remainder modules stay 255 there
        # but keep the display matrix's pre-darkening
        original = np.full((n, n), 255, np.uint8)
        for (r, c), bit in zip(coords, bits):
            v = 0 if bit else 255
            m[r, c] = v
            original[r, c] = v

        best_mask, best_pen = 0, None
        for mask in range(8):
            cand = _apply_mask(m, original, fmask, mask)
            _place_format(cand, _format_bits(ecc, mask), n)
            _place_version(cand, version, n)
            pen = _penalties(cand)
            if best_pen is None or pen < best_pen:
                best_pen, best_mask = pen, mask

        out = _apply_mask(m, original, fmask, best_mask)
        _place_format(out, _format_bits(ecc, best_mask), n)
        _place_version(out, version, n)
        border = 2
        return np.pad(out, border, constant_values=255)
