"""Baseline TIFF codec (modules/imgcodecs/src/grfmt_tiff.cpp role).

Pure-python strip-based TIFF: decode handles uncompressed, PackBits,
LZW (with early-change code growth and horizontal predictor), and
Deflate strips for 8/16-bit gray/RGB/RGBA images in either byte
order; encode writes Deflate (COMPRESSION_ADOBE_DEFLATE) strips with
the horizontal-difference predictor, which libtiff/cv2 read back
bit-exactly.  Tiled TIFFs and exotic photometrics are gated with a
clear error.

Twin of ``opencv_tpu/imgcodecs/tiff.py``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["tiff_decode", "tiff_encode", "is_tiff"]


def is_tiff(data: bytes) -> bool:
    return data[:4] in (b"II*\x00", b"MM\x00*")


def _read_ifd(data, endian, off):
    n = struct.unpack(endian + "H", data[off:off + 2])[0]
    tags = {}
    type_size = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
                 10: 8, 11: 4, 12: 8}
    type_fmt = {1: "B", 3: "H", 4: "I", 8: "h", 9: "i", 11: "f", 12: "d"}
    for i in range(n):
        e = off + 2 + 12 * i
        tag, typ, cnt = struct.unpack(endian + "HHI", data[e:e + 8])
        sz = type_size.get(typ, 1) * cnt
        if sz <= 4:
            raw = data[e + 8:e + 8 + sz]
        else:
            ptr = struct.unpack(endian + "I", data[e + 8:e + 12])[0]
            raw = data[ptr:ptr + sz]
        if typ in type_fmt:
            vals = struct.unpack(endian + type_fmt[typ] * cnt, raw)
        elif typ == 5:   # rational
            u = struct.unpack(endian + "II" * cnt, raw)
            vals = tuple(u[2 * k] / max(u[2 * k + 1], 1)
                         for k in range(cnt))
        else:
            vals = (raw,)
        tags[tag] = vals
    nxt = struct.unpack(
        endian + "I", data[off + 2 + 12 * n:off + 6 + 12 * n])[0]
    return tags, nxt


def _unpackbits(src: bytes, expect: int) -> bytes:
    out = bytearray()
    i = 0
    n = len(src)
    while i < n and len(out) < expect:
        h = src[i]
        i += 1
        if h < 128:
            out += src[i:i + h + 1]
            i += h + 1
        elif h > 128:
            out += src[i:i + 1] * (257 - h)
            i += 1
    return bytes(out)


def _lzw_decode(src: bytes, expect: int) -> bytes:
    """TIFF LZW: MSB-first bit packing, ClearCode 256, EOI 257,
    early-change code-width growth."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    table = []
    width = 9
    nextcode = 258
    prev = None
    acc = 0
    nbits = 0
    pos = 0
    n = len(src)
    while len(out) < expect:
        while nbits < width:
            if pos >= n:
                return bytes(out)
            acc = (acc << 8) | src[pos]
            pos += 1
            nbits += 8
        code = (acc >> (nbits - width)) & ((1 << width) - 1)
        nbits -= width
        if code == EOI:
            break
        if code == CLEAR:
            table = []
            width = 9
            nextcode = 258
            prev = None
            continue
        if code < 256:
            entry = bytes([code])
        elif code - 258 < len(table):
            entry = table[code - 258]
        elif prev is not None:
            entry = prev + prev[:1]
        else:
            break
        out += entry
        if prev is not None:
            table.append(prev + entry[:1])
            nextcode += 1
        prev = entry
        # early change: widen one code before the table is full
        if nextcode + 1 >= (1 << width) and width < 12:
            width += 1
    return bytes(out)


def tiff_decode(data: bytes):
    """First page (reference: first IFD wins for imread)."""
    endian = "<" if data[:2] == b"II" else ">"
    first = struct.unpack(endian + "I", data[4:8])[0]
    tags, _ = _read_ifd(data, endian, first)
    return _decode_page(data, endian, tags)


def tiff_decode_all(data: bytes):
    """All pages (imreadmulti, loadsave.cpp imreadmulti_)."""
    endian = "<" if data[:2] == b"II" else ">"
    off = struct.unpack(endian + "I", data[4:8])[0]
    pages = []
    seen = set()
    while off and off not in seen:
        seen.add(off)
        tags, off = _read_ifd(data, endian, off)
        pages.append(_decode_page(data, endian, tags))
    return pages


def _decode_page(data: bytes, endian: str, tags):
    if 322 in tags or 323 in tags:
        raise ValueError("tiled TIFF not supported")
    W = tags[256][0]
    H = tags[257][0]
    spp = tags.get(277, (1,))[0]
    bits = tags.get(258, (8,) * spp)
    if any(b not in (8, 16) for b in bits):
        raise ValueError(f"unsupported TIFF bit depth {bits}")
    bps = bits[0]
    comp = tags.get(259, (1,))[0]
    predictor = tags.get(317, (1,))[0]
    photometric = tags.get(262, (1,))[0]
    rows_per_strip = tags.get(278, (H,))[0]
    offsets = tags[273]
    counts = tags.get(279, (len(data) - offsets[0],))
    fmt = tags.get(339, (1,))[0]
    if fmt not in (1, 4):
        raise ValueError("non-uint TIFF sample format not supported")
    row_bytes = W * spp * (bps // 8)
    raw = bytearray()
    for si, (o, c) in enumerate(zip(offsets, counts)):
        nrows = min(rows_per_strip, H - si * rows_per_strip)
        expect = nrows * row_bytes
        chunk = data[o:o + c]
        if comp == 1:
            raw += chunk[:expect]
        elif comp == 5:
            raw += _lzw_decode(chunk, expect)
        elif comp in (8, 32946):
            raw += zlib.decompress(chunk)
        elif comp == 32773:
            raw += _unpackbits(chunk, expect)
        else:
            raise ValueError(f"unsupported TIFF compression {comp}")
    dt = np.dtype(("<" if endian == "<" else ">")
                  + ("u2" if bps == 16 else "u1"))
    img = np.frombuffer(bytes(raw[:H * row_bytes]), dt)
    img = img.reshape(H, W, spp).astype(
        np.uint16 if bps == 16 else np.uint8)
    if predictor == 2:
        img = np.cumsum(img.astype(np.int64), axis=1)
        img = (img & ((1 << bps) - 1)).astype(
            np.uint16 if bps == 16 else np.uint8)
    if photometric == 0:   # white-is-zero
        img = ((1 << bps) - 1) - img
    if spp == 1:
        return img[:, :, 0]
    if spp >= 3:           # TIFF stores RGB; convert to BGR(A)
        out = img.copy()
        out[:, :, 0] = img[:, :, 2]
        out[:, :, 2] = img[:, :, 0]
        return out
    return img


def tiff_encode(img: np.ndarray) -> bytes:
    return b"II*\x00" + struct.pack("<I", 8) + _encode_page(img, 8, 0)


def tiff_encode_multi(imgs) -> bytes:
    """Multi-page TIFF: IFDs chained via the next-IFD pointer
    (imwritemulti)."""
    blocks = []
    base = 8
    # first pass: lengths (independent of the next pointer)
    lens = []
    for im in imgs:
        b = _encode_page(im, base, 0)
        lens.append(len(b))
        base += len(b)
    out = b"II*\x00" + struct.pack("<I", 8)
    base = 8
    for i, im in enumerate(imgs):
        nxt = base + lens[i] if i + 1 < len(imgs) else 0
        out += _encode_page(im, base, nxt)
        base += lens[i]
    return out


def _encode_page(img: np.ndarray, base: int, next_ifd: int) -> bytes:
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError("TIFF encoder supports uint8/uint16")
    if img.ndim == 2:
        img = img[:, :, None]
    H, W, C = img.shape
    if C >= 3:             # BGR(A) -> RGB(A)
        rgb = img.copy()
        rgb[:, :, 0] = img[:, :, 2]
        rgb[:, :, 2] = img[:, :, 0]
        img = rgb
    bps = 16 if img.dtype == np.uint16 else 8
    # horizontal predictor then deflate
    diff = img.astype(np.int32)
    diff[:, 1:] -= img[:, :-1].astype(np.int32)
    diff = (diff & ((1 << bps) - 1)).astype("<u2" if bps == 16 else "u1")
    payload = zlib.compress(diff.tobytes(), 6)

    def tag(tid, typ, cnt, val):
        return struct.pack("<HHI4s", tid, typ, cnt, val)

    def short(v):
        return struct.pack("<HH", v, 0)

    def long_(v):
        return struct.pack("<I", v)

    entries = []
    extra = b""
    photometric = 2 if C >= 3 else 1
    ntags = 12
    ifd_off = base
    data_off = ifd_off + 2 + ntags * 12 + 4
    # bits-per-sample / sample-format arrays (> 4 bytes when C > 2)
    if C > 2:
        bits_off = data_off + len(extra)
        extra += struct.pack("<" + "H" * C, *([bps] * C))
        bits_val = long_(bits_off)
        bits_typ_cnt = (3, C)
        fmt_off = data_off + len(extra)
        extra += struct.pack("<" + "H" * C, *([1] * C))
        fmt_val = long_(fmt_off)
        fmt_cnt = C
    else:
        bits_val = short(bps)
        bits_typ_cnt = (3, 1)
        fmt_val = short(1)
        fmt_cnt = 1
    strip_off = data_off + len(extra)
    entries.append(tag(256, 3, 1, short(W)))
    entries.append(tag(257, 3, 1, short(H)))
    entries.append(tag(258, bits_typ_cnt[0], bits_typ_cnt[1], bits_val))
    entries.append(tag(259, 3, 1, short(8)))          # deflate
    entries.append(tag(262, 3, 1, short(photometric)))
    entries.append(tag(273, 4, 1, long_(strip_off)))  # strip offset
    entries.append(tag(277, 3, 1, short(C)))
    entries.append(tag(278, 3, 1, short(H)))          # rows per strip
    entries.append(tag(279, 4, 1, long_(len(payload))))
    entries.append(tag(284, 3, 1, short(1)))          # chunky
    entries.append(tag(317, 3, 1, short(2)))          # predictor
    entries.append(tag(339, 3, fmt_cnt, fmt_val))     # uint per sample
    entries.sort(key=lambda e: struct.unpack("<H", e[:2])[0])
    ifd = (struct.pack("<H", len(entries)) + b"".join(entries)
           + long_(next_ifd))
    return ifd + extra + payload
