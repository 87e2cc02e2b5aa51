"""WebP lossless (VP8L) decode/encode
(`modules/imgcodecs/src/grfmt_webp.cpp` via the bundled libwebp;
bitstream per the public WebP lossless spec).

Decoder: full VP8L — canonical-Huffman entropy images (simple + code-
length-coded), meta-Huffman groups, color cache, LZ77 backward
references with the 2-D distance map, and all four transforms
(predictor 0-13, cross-color, subtract-green, color-indexing incl.
pixel bundling).  Covers cv2-written lossless .webp files.

Encoder: a minimal-but-valid VP8L writer (no transforms, flat 8-bit
literal codes) — readable by any compliant decoder including the
reference wheel.  Lossy VP8 is out of scope (raises).

Format constants (kCodeToPlane, code-length order) are normative
bitstream data shared with the spec.

Twin of ``opencv_tpu/imgcodecs/webp.py``.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["webp_decode", "webp_encode"]

_CODE_LENGTH_ORDER = [17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11,
                      12, 13, 14, 15]

_CODE_TO_PLANE = [
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a,
    0x26, 0x2a, 0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a,
    0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b,
    0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03,
    0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d, 0x44, 0x4c,
    0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b,
    0x32, 0x3e, 0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f,
    0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41,
    0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d, 0x51, 0x5f,
    0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70]


class _Bits:
    """LSB-first bit reader."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.bits = 0
        self.nbits = 0

    def read(self, n):
        while self.nbits < n:
            b = self.data[self.pos] if self.pos < len(self.data) else 0
            self.bits |= b << self.nbits
            self.nbits += 8
            self.pos += 1
        v = self.bits & ((1 << n) - 1)
        self.bits >>= n
        self.nbits -= n
        return v


class _Huff:
    """Canonical Huffman decoder (MSB-first code bits over the LSB-first
    stream, per the VP8L convention)."""

    def __init__(self, lengths):
        self.single = None
        lengths = np.asarray(lengths, np.int32)
        nz = np.nonzero(lengths)[0]
        if len(nz) == 1:
            self.single = int(nz[0])
            return
        self.table = {}
        code = 0
        maxlen = int(lengths.max()) if len(nz) else 0
        for ln in range(1, maxlen + 1):
            for sym in np.nonzero(lengths == ln)[0]:
                self.table[(ln, code)] = int(sym)
                code += 1
            code <<= 1

    def read(self, br: _Bits):
        if self.single is not None:
            return self.single
        code = 0
        ln = 0
        while True:
            code = (code << 1) | br.read(1)
            ln += 1
            hit = self.table.get((ln, code))
            if hit is not None:
                return hit
            if ln > 15:
                raise ValueError("bad huffman stream")


def _read_code_lengths(br, num_symbols):
    """ReadHuffmanCode (vp8l_dec.c): simple or code-length-coded."""
    lengths = np.zeros(num_symbols, np.int32)
    if br.read(1):  # simple
        n = br.read(1) + 1
        if br.read(1):
            s0 = br.read(8)
        else:
            s0 = br.read(1)
        lengths[s0] = 1
        if n == 2:
            s1 = br.read(8)
            lengths[s1] = 1
        return lengths
    nclc = br.read(4) + 4
    clc = np.zeros(19, np.int32)
    for i in range(nclc):
        clc[_CODE_LENGTH_ORDER[i]] = br.read(3)
    clh = _Huff(clc)
    if br.read(1):  # use length
        nbits = 2 + 2 * br.read(3)
        max_symbol = 2 + br.read(nbits)
    else:
        max_symbol = num_symbols
    sym = 0
    prev = 8
    while sym < num_symbols:
        if max_symbol == 0:
            break
        max_symbol -= 1
        s = clh.read(br)
        if s < 16:
            lengths[sym] = s
            sym += 1
            if s:
                prev = s
        elif s == 16:
            rep = 3 + br.read(2)
            lengths[sym:sym + rep] = prev
            sym += rep
        elif s == 17:
            sym += 3 + br.read(3)
        else:
            sym += 11 + br.read(7)
    return lengths


def _prefix_value(br, code):
    """LZ77 length/distance prefix decoding."""
    if code < 4:
        return code + 1
    extra = (code - 2) >> 1
    offset = (2 + (code & 1)) << extra
    return offset + br.read(extra) + 1


def _subsample(size, bits):
    return (size + (1 << bits) - 1) >> bits


def _decode_image(br, w, h, allow_meta):
    """DecodeImageStream core: huffman groups + LZ77 + color cache →
    (h, w) uint32 ARGB."""
    # order per DecodeImageStream: color-cache bits FIRST, then the
    # meta-Huffman bit inside ReadHuffmanCodes (vp8l_dec.c:275,382)
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
    cache_size = (1 << cache_bits) if cache_bits else 0

    meta = None
    meta_bits = 0
    ngroups = 1
    if allow_meta and br.read(1):
        meta_bits = br.read(3) + 2
        mw, mh = _subsample(w, meta_bits), _subsample(h, meta_bits)
        meta_img = _decode_image(br, mw, mh, False)
        meta = ((meta_img >> 8) & 0xFFFF).astype(np.int32)
        ngroups = int(meta.max()) + 1

    groups = []
    for _ in range(ngroups):
        hg = [_Huff(_read_code_lengths(br, 256 + 24 + cache_size)),
              _Huff(_read_code_lengths(br, 256)),
              _Huff(_read_code_lengths(br, 256)),
              _Huff(_read_code_lengths(br, 256)),
              _Huff(_read_code_lengths(br, 40))]
        groups.append(hg)

    out = np.zeros(w * h, np.uint32)
    cache = np.zeros(max(cache_size, 1), np.uint32)
    pos = 0
    total = w * h

    def cache_insert(argb):
        if cache_size:
            cache[(0x1e35a7bd * int(argb) & 0xFFFFFFFF) >>
                  (32 - cache_bits)] = argb

    while pos < total:
        if meta is not None:
            x, y = pos % w, pos // w
            g = groups[meta[y >> meta_bits, x >> meta_bits]]
        else:
            g = groups[0]
        s = g[0].read(br)
        if s < 256:
            r = g[1].read(br)
            b = g[2].read(br)
            a = g[3].read(br)
            argb = (a << 24) | (r << 16) | (s << 8) | b
            out[pos] = argb
            cache_insert(argb)
            pos += 1
        elif s < 280:
            length = _prefix_value(br, s - 256)
            dcode = g[4].read(br)
            dist = _prefix_value(br, dcode)
            if dist <= 120:
                plane = _CODE_TO_PLANE[dist - 1]
                dist = (plane >> 4) * w + (8 - (plane & 0xF))
                if dist < 1:
                    dist = 1
            else:
                dist -= 120
            for _ in range(length):
                out[pos] = out[pos - dist]
                cache_insert(out[pos])
                pos += 1
                if pos >= total:
                    break
        else:
            out[pos] = cache[s - 280]
            pos += 1
    return out.reshape(h, w)


def _avg2(a, b):
    return (((a ^ b) & 0xfefefefe) >> np.uint32(1)) + (a & b)


def _unpack(p):
    return ((p >> 24) & 0xFF, (p >> 16) & 0xFF, (p >> 8) & 0xFF, p & 0xFF)


def _pack(a, r, g, b):
    return ((int(a) & 0xFF) << 24) | ((int(r) & 0xFF) << 16) | \
        ((int(g) & 0xFF) << 8) | (int(b) & 0xFF)


def _predict(mode, L, T, TL, TR):
    """Predictors 0..13 (lossless.c VP8LPredictor*_C), python ints."""
    if mode == 0:
        return 0xFF000000
    if mode == 1:
        return L
    if mode == 2:
        return T
    if mode == 3:
        return TR
    if mode == 4:
        return TL
    a2 = lambda x, y: int(_avg2(np.uint32(x), np.uint32(y)))  # noqa: E731
    if mode == 5:
        return a2(a2(L, TR), T)
    if mode == 6:
        return a2(L, TL)
    if mode == 7:
        return a2(L, T)
    if mode == 8:
        return a2(TL, T)
    if mode == 9:
        return a2(T, TR)
    if mode == 10:
        return a2(a2(L, TL), a2(T, TR))
    if mode == 11:  # Select (lossless.c:98)
        ta = _unpack(np.uint32(T))
        la = _unpack(np.uint32(L))
        tla = _unpack(np.uint32(TL))
        pa_minus_pb = 0
        for i in range(4):
            pb = abs(int(la[i]) - int(tla[i]))   # |L - TL| predicts T
            pa_ = abs(int(ta[i]) - int(tla[i]))  # |T - TL| predicts L
            pa_minus_pb += pa_ - pb
        return T if pa_minus_pb <= 0 else L
    if mode == 12:  # ClampedAddSubtractFull
        la = _unpack(np.uint32(L))
        ta = _unpack(np.uint32(T))
        tla = _unpack(np.uint32(TL))
        comps = [min(255, max(0, int(la[i]) + int(ta[i]) - int(tla[i])))
                 for i in range(4)]
        return _pack(*comps)
    if mode == 13:  # ClampedAddSubtractHalf (C division truncates to 0)
        ave = _unpack(_avg2(np.uint32(L), np.uint32(T)))
        tla = _unpack(np.uint32(TL))
        comps = []
        for i in range(4):
            d = int(ave[i]) - int(tla[i])
            half = d // 2 if d >= 0 else -((-d) // 2)
            comps.append(min(255, max(0, int(ave[i]) + half)))
        return _pack(*comps)
    raise ValueError(f"bad predictor {mode}")


def _add_pixels(a, b):
    """Per-byte modular add of two ARGB values."""
    return (((int(a) & 0xFF00FF00) + (int(b) & 0xFF00FF00)) & 0xFF00FF00) \
        | (((int(a) & 0x00FF00FF) + (int(b) & 0x00FF00FF)) & 0x00FF00FF)


def webp_decode(data: bytes):
    if data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("not a WebP file")
    pos = 12
    while pos + 8 <= len(data):
        tag = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        body = data[pos + 8:pos + 8 + size]
        if tag == b"VP8L":
            return _vp8l_decode(body)
        if tag == b"VP8 ":
            from .vp8 import vp8_decode
            return vp8_decode(body)
        pos += 8 + size + (size & 1)
    raise ValueError("no image chunk in WebP")


def _vp8l_decode(body: bytes):
    if body[0] != 0x2F:
        raise ValueError("bad VP8L signature")
    br = _Bits(body[1:])
    w = br.read(14) + 1
    h = br.read(14) + 1
    br.read(1)   # alpha hint
    if br.read(3) != 0:
        raise ValueError("bad VP8L version")

    # transforms (applied inverse in reverse order after decode)
    transforms = []
    xsize = w
    while br.read(1):
        t = br.read(2)
        if t == 0:      # predictor
            bits = br.read(3) + 2
            tw, th = _subsample(xsize, bits), _subsample(h, bits)
            timg = _decode_image(br, tw, th, False)
            transforms.append(("pred", bits, timg))
        elif t == 1:    # cross-color
            bits = br.read(3) + 2
            tw, th = _subsample(xsize, bits), _subsample(h, bits)
            timg = _decode_image(br, tw, th, False)
            transforms.append(("color", bits, timg))
        elif t == 2:    # subtract green
            transforms.append(("subg", 0, None))
        else:           # color indexing
            n = br.read(8) + 1
            pal = _decode_image(br, n, 1, False)[0]
            # palette entries are delta-coded componentwise
            pb = pal.view(np.uint8).reshape(n, 4).astype(np.int64)
            pb = np.cumsum(pb, axis=0) & 0xFF
            pal = pb.astype(np.uint8).reshape(n, 4).copy().view(np.uint32) \
                .reshape(n)
            if n <= 2:
                wbits = 3
            elif n <= 4:
                wbits = 2
            elif n <= 16:
                wbits = 1
            else:
                wbits = 0
            transforms.append(("index", wbits, pal))
            if wbits:
                xsize = _subsample(xsize, wbits)

    argb = _decode_image(br, xsize, h, True)

    for kind, bits, timg in reversed(transforms):
        if kind == "index":
            pal = timg
            if bits:
                packed = (argb >> 8) & 0xFF
                per = 1 << bits      # pixels packed per green byte
                idx_bits = 8 >> bits  # bits per palette index
                cols = []
                for k in range(per):
                    cols.append((packed >> (idx_bits * k))
                                & ((1 << idx_bits) - 1))
                full = np.zeros((h, argb.shape[1] * per), np.uint32)
                for k in range(per):
                    full[:, k::per] = cols[k]
                full = full[:, :w]
                argb = pal[np.clip(full, 0, len(pal) - 1)]
            else:
                idx = (argb >> 8) & 0xFF
                argb = pal[np.clip(idx, 0, len(pal) - 1)]
        elif kind == "subg":
            g = (argb >> 8) & 0xFF
            r = (((argb >> 16) & 0xFF) + g) & 0xFF
            b = ((argb & 0xFF) + g) & 0xFF
            argb = (argb & 0xFF00FF00) | (r << 16) | b
        elif kind == "color":
            tile = 1 << bits
            out = argb.astype(np.int64)
            g2r = ((timg >> 0) & 0xFF).astype(np.int8)
            g2b = ((timg >> 8) & 0xFF).astype(np.int8)
            r2b = ((timg >> 16) & 0xFF).astype(np.int8)
            ty = (np.arange(h) >> bits)
            tx = (np.arange(w) >> bits)
            G2R = g2r[ty][:, tx].astype(np.int64)
            G2B = g2b[ty][:, tx].astype(np.int64)
            R2B = r2b[ty][:, tx].astype(np.int64)
            green = ((out >> 8) & 0xFF).astype(np.int8).astype(np.int64)
            red = (out >> 16) & 0xFF
            blue = out & 0xFF
            new_red = (red + ((G2R * green) >> 5)) & 0xFF
            nr8 = new_red.astype(np.int8).astype(np.int64)
            new_blue = (blue + ((G2B * green) >> 5) + ((R2B * nr8) >> 5)) \
                & 0xFF
            argb = ((out & 0xFF00FF00) | (new_red << 16) | new_blue) \
                .astype(np.uint32)
        elif kind == "pred":
            tile_bits = bits
            res = argb.astype(np.uint32)
            out = np.zeros_like(res)
            modes = (timg >> 8) & 0xF
            for y in range(h):
                for x in range(w):
                    if x == 0 and y == 0:
                        pred = 0xFF000000
                    elif y == 0:
                        pred = int(out[0, x - 1])
                    elif x == 0:
                        pred = int(out[y - 1, 0])
                    else:
                        mode = int(modes[y >> tile_bits, x >> tile_bits])
                        L = int(out[y, x - 1])
                        T = int(out[y - 1, x])
                        TL = int(out[y - 1, x - 1])
                        TR = int(out[y - 1, x + 1]) if x + 1 < w \
                            else int(out[y - 1, 0])
                        pred = _predict(mode, L, T, TL, TR)
                    out[y, x] = np.uint32(_add_pixels(res[y, x], pred))
            argb = out

    a = (argb >> 24) & 0xFF
    r = (argb >> 16) & 0xFF
    g = (argb >> 8) & 0xFF
    b = argb & 0xFF
    if (a == 255).all():
        return np.stack([b, g, r], -1).astype(np.uint8)
    return np.stack([b, g, r, a], -1).astype(np.uint8)


# ------------------------------------------------------------------ encode

class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.bits = 0
        self.nbits = 0

    def write(self, v, n):
        self.bits |= (v & ((1 << n) - 1)) << self.nbits
        self.nbits += n
        while self.nbits >= 8:
            self.out.append(self.bits & 0xFF)
            self.bits >>= 8
            self.nbits -= 8

    def finish(self):
        if self.nbits:
            self.out.append(self.bits & 0xFF)
            self.bits = 0
            self.nbits = 0
        return bytes(self.out)


def _write_flat_code(bw, num_symbols, active):
    """Write a code-length-coded Huffman code where the `active` first
    symbols get 8-bit flat codes and the rest length 0."""
    # code-length alphabet uses symbols {0, 8}: give each length 1 bit
    # clc lengths (3 bits each) in _CODE_LENGTH_ORDER; need entries up to
    # symbol 8 → order positions: 17,18,0,...  find max index needed
    lens = {0: 1, 8: 1}
    # order: 17 18 0 1 2 3 4 5 16 6 7 8 ... symbol 8 is at index 11
    bw.write(0, 1)           # not simple
    # 12 code-length-code entries (order index 11 covers symbol 8)
    bw.write(12 - 4, 4)
    order = _CODE_LENGTH_ORDER[:12]
    for s in order:
        bw.write(lens.get(s, 0), 3)
    # canonical clc: symbols 0 and 8, both length 1 → 0 -> code 0, 8 -> 1
    bw.write(0, 1)  # no max_symbol trick
    emitted = 0
    while emitted < active:
        bw.write(1, 1)       # clc symbol 8 (code 1)
        emitted += 1
    # remaining symbols get 0 (clc symbol 0 = code 0)
    for _ in range(num_symbols - active):
        bw.write(0, 1)


def _write_single_code(bw, symbol):
    """Simple code with exactly one symbol."""
    bw.write(1, 1)   # simple
    bw.write(0, 1)   # one symbol
    if symbol < 2:
        bw.write(0, 1)
        bw.write(symbol, 1)
    else:
        bw.write(1, 1)
        bw.write(symbol, 8)


def webp_encode(img) -> bytes:
    """Minimal valid VP8L: literals only, flat 8-bit codes."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    H, W = img.shape[:2]
    has_a = img.shape[2] == 4
    b = img[:, :, 0].astype(np.uint32)
    g = img[:, :, 1].astype(np.uint32)
    r = img[:, :, 2].astype(np.uint32)
    a = img[:, :, 3].astype(np.uint32) if has_a else None

    bw = _BitWriter()
    bw.write(0x2F, 8)
    bw.write(W - 1, 14)
    bw.write(H - 1, 14)
    bw.write(1 if has_a else 0, 1)
    bw.write(0, 3)
    bw.write(0, 1)   # no transforms
    bw.write(0, 1)   # no color cache (read before the meta bit)
    bw.write(0, 1)   # no meta-huffman image
    # 5 codes: green(280) flat over 256 literals, r, b flat, alpha single
    # or flat, distance single-symbol
    _write_flat_code(bw, 280, 256)
    _write_flat_code(bw, 256, 256)
    _write_flat_code(bw, 256, 256)
    if has_a:
        _write_flat_code(bw, 256, 256)
    else:
        _write_single_code(bw, 255)
    _write_single_code(bw, 0)

    # flat canonical code over symbols 0..255 with length 8: code == symbol
    def put_sym(v):
        # write 8 bits MSB-first (canonical code bits order)
        for k in range(7, -1, -1):
            bw.write((v >> k) & 1, 1)

    gs = g.ravel()
    rs = r.ravel()
    bs = b.ravel()
    as_ = a.ravel() if has_a else None
    for i in range(W * H):
        put_sym(int(gs[i]))
        put_sym(int(rs[i]))
        put_sym(int(bs[i]))
        if has_a:
            put_sym(int(as_[i]))
    payload = bw.finish()

    chunk = b"VP8L" + struct.pack("<I", len(payload)) + payload
    if len(payload) & 1:
        chunk += b"\x00"
    riff = b"WEBP" + chunk
    return b"RIFF" + struct.pack("<I", len(riff)) + riff
