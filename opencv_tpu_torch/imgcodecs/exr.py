"""OpenEXR scanline decode/encode (`modules/imgcodecs/src/grfmt_exr.cpp`
behavior via the reference's bundled OpenEXR; format per the public
OpenEXR 2.0 spec).

Supports single-part scanline files, HALF/FLOAT/UINT channels,
NO_COMPRESSION / ZIPS (1 line) / ZIP (16 lines).  ZIP blocks use EXR's
byte-deinterleave + delta predictor around zlib.  Half-float conversion
is vectorized numpy (np.float16 is IEEE half — same bits).

Twin of ``opencv_tpu/imgcodecs/exr.py``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["exr_decode", "exr_encode"]

_MAGIC = b"\x76\x2f\x31\x01"

_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_PT_NP = {_PT_UINT: np.uint32, _PT_HALF: np.float16, _PT_FLOAT: np.float32}
_PT_SIZE = {_PT_UINT: 4, _PT_HALF: 2, _PT_FLOAT: 4}

_NO_COMP, _RLE, _ZIPS, _ZIP, _PIZ = 0, 1, 2, 3, 4


def _read_cstr(data, pos):
    end = data.index(b"\x00", pos)
    return data[pos:end].decode("latin-1"), end + 1


def _exr_unpredict(b):
    """EXR ZIP post-inflate reconstruction (ImfZip.cpp uncompress):
    delta decode t[i] = t[i-1] + raw[i] - 128, then de-interleave the
    two halves back to even/odd byte positions."""
    raw = np.frombuffer(b, np.uint8).astype(np.int64)
    out = np.empty(len(raw), np.int64)
    out[0] = raw[0]
    out[1:] = raw[0] + np.cumsum(raw[1:] - 128)
    d = (out & 0xFF).astype(np.uint8)
    n = len(d)
    half = (n + 1) // 2
    res = np.empty(n, np.uint8)
    res[0::2] = d[:half]
    res[1::2] = d[half:]
    return res.tobytes()


def _exr_predict(b):
    """Inverse of _exr_unpredict (ImfZip.cpp compress)."""
    d = np.frombuffer(b, np.uint8)
    n = len(d)
    half = (n + 1) // 2
    inter = np.empty(n, np.uint8)
    inter[:half] = d[0::2]
    inter[half:] = d[1::2]
    ii = inter.astype(np.int64)
    out = np.empty(n, np.int64)
    out[0] = ii[0]
    out[1:] = np.diff(ii) + 128
    return (out & 0xFF).astype(np.uint8).tobytes()


def exr_decode(data: bytes):
    if data[:4] != _MAGIC:
        raise ValueError("not an EXR file")
    version = struct.unpack_from("<I", data, 4)[0]
    if version & 0x200:
        raise NotImplementedError("multi-part EXR")
    pos = 8

    channels = []   # (name, pixel_type)
    compression = _ZIP
    x_min = y_min = x_max = y_max = 0
    while True:
        name, pos = _read_cstr(data, pos)
        if name == "":
            break
        atype, pos = _read_cstr(data, pos)
        size = struct.unpack_from("<I", data, pos)[0]
        pos += 4
        body = data[pos:pos + size]
        pos += size
        if name == "channels":
            cp = 0
            while body[cp] != 0:
                cname_end = body.index(b"\x00", cp)
                cname = body[cp:cname_end].decode("latin-1")
                ptype = struct.unpack_from("<i", body, cname_end + 1)[0]
                channels.append((cname, ptype))
                cp = cname_end + 1 + 16
        elif name == "compression":
            compression = body[0]
        elif name == "dataWindow":
            x_min, y_min, x_max, y_max = struct.unpack("<4i", body)

    W = x_max - x_min + 1
    H = y_max - y_min + 1
    nch = len(channels)
    # channels are stored alphabetically within each scanline
    ch_sorted = sorted(range(nch), key=lambda i: channels[i][0])

    if compression == _ZIPS:
        lines_per_block = 1
    elif compression == _ZIP:
        lines_per_block = 16
    elif compression == _PIZ:
        lines_per_block = 32
    elif compression == _NO_COMP:
        lines_per_block = 1
    else:
        raise NotImplementedError(f"EXR compression {compression}")

    nblocks = -(-H // lines_per_block)
    offsets = struct.unpack_from(f"<{nblocks}Q", data, pos)

    planes = {c[0]: np.zeros((H, W), _PT_NP[c[1]]) for c in channels}
    for off in offsets:
        y, size = struct.unpack_from("<iI", data, off)
        raw = data[off + 8:off + 8 + size]
        rows = min(lines_per_block, y_max - y + 1)
        expect = rows * sum(_PT_SIZE[channels[i][1]] for i in range(nch)) * W
        if compression in (_ZIPS, _ZIP) and size < expect:
            raw = _exr_unpredict(zlib.decompress(raw))
        elif compression == _PIZ and size < expect:
            from .exr_piz import piz_uncompress
            sizes = [_PT_SIZE[channels[i][1]] // 2 for i in ch_sorted]
            raw = piz_uncompress(raw, rows, W, sizes)
        bp = 0
        for r in range(rows):
            for ci in ch_sorted:
                cname, pt = channels[ci]
                nbytes = W * _PT_SIZE[pt]
                planes[cname][y - y_min + r] = np.frombuffer(
                    raw, _PT_NP[pt], W, bp)
                bp += nbytes

    names = [c[0] for c in channels]
    if set("BGR").issubset(names):
        order = ["B", "G", "R"] + (["A"] if "A" in names else [])
        img = np.stack([planes[c].astype(np.float32) for c in order], -1)
    elif set("RGB").issubset(names):
        order = ["B", "G", "R"] + (["A"] if "A" in names else [])
        img = np.stack([planes[c].astype(np.float32) for c in order], -1)
    elif "Y" in names:
        img = planes["Y"].astype(np.float32)
    else:
        img = np.stack([planes[n].astype(np.float32) for n in names], -1)
    return img


def exr_encode(img, params=None) -> bytes:
    """Write float32 input as FLOAT channels (half via
    IMWRITE_EXR_TYPE=1 param), ZIP compression."""
    img = np.asarray(img)
    if img.dtype != np.float32:
        img = img.astype(np.float32)
    half = False
    comp = _ZIP
    if params:
        p = list(params)
        for i in range(0, len(p) - 1, 2):
            if p[i] == 48:   # IMWRITE_EXR_TYPE
                half = int(p[i + 1]) == 1
            if p[i] == 49:   # IMWRITE_EXR_COMPRESSION
                comp = int(p[i + 1])
    if comp not in (_NO_COMP, _ZIPS, _ZIP, _PIZ):
        comp = _ZIP
    pt = _PT_HALF if half else _PT_FLOAT
    npdt = _PT_NP[pt]

    if img.ndim == 2:
        chans = [("Y", img)]
    else:
        names = ["B", "G", "R", "A"][:img.shape[2]]
        chans = [(n, img[:, :, i]) for i, n in enumerate(names)]
    chans.sort(key=lambda c: c[0])
    H, W = img.shape[:2]

    out = bytearray()
    out += _MAGIC
    out += struct.pack("<I", 2)

    def attr(name, atype, body):
        out.extend(name.encode() + b"\x00" + atype.encode() + b"\x00")
        out.extend(struct.pack("<I", len(body)))
        out.extend(body)

    chbody = bytearray()
    for n, _ in chans:
        chbody += n.encode() + b"\x00"
        chbody += struct.pack("<i", pt) + struct.pack("<i", 0) \
            + struct.pack("<ii", 1, 1)
    chbody += b"\x00"
    attr("channels", "chlist", bytes(chbody))
    attr("compression", "compression", bytes([comp]))
    attr("dataWindow", "box2i", struct.pack("<4i", 0, 0, W - 1, H - 1))
    attr("displayWindow", "box2i", struct.pack("<4i", 0, 0, W - 1, H - 1))
    attr("lineOrder", "lineOrder", b"\x00")
    attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    out += b"\x00"

    lpb = 16 if comp == _ZIP else (32 if comp == _PIZ else 1)
    nblocks = -(-H // lpb)
    offset_table_pos = len(out)
    out += b"\x00" * (8 * nblocks)

    offsets = []
    for b in range(nblocks):
        y0 = b * lpb
        rows = min(lpb, H - y0)
        payload = bytearray()
        for r in range(rows):
            for n, plane in chans:
                payload += plane[y0 + r].astype(npdt).tobytes()
        if comp in (_ZIPS, _ZIP):
            cz = zlib.compress(_exr_predict(bytes(payload)), 6)
            blk = cz if len(cz) < len(payload) else bytes(payload)
        elif comp == _PIZ:
            from .exr_piz import piz_compress
            sizes = [_PT_SIZE[pt] // 2] * len(chans)
            cz = piz_compress(bytes(payload), rows, W, sizes)
            blk = cz if len(cz) < len(payload) else bytes(payload)
        else:
            blk = bytes(payload)
        offsets.append(len(out))
        out += struct.pack("<iI", y0, len(blk))
        out += blk

    for i, off in enumerate(offsets):
        struct.pack_into("<Q", out, offset_table_pos + 8 * i, off)
    return bytes(out)
