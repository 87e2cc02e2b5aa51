"""GIF decode/encode (`modules/imgcodecs/src/grfmt_gif.cpp`).

Pure-python LZW with numpy pixel handling — codecs are host-side IO
tails in this framework (decode on the host, dense work on the device).
Decode returns the first frame composited as BGR/BGRA like the
reference reader; encode quantizes to a ≤256-color palette (exact
palette when the image already has ≤256 distinct colors, else a
6x7x6 color cube) and writes GIF89a.

Twin of ``opencv_tpu/imgcodecs/gif.py``.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["gif_decode", "gif_encode"]


# ------------------------------------------------------------------ LZW

def _lzw_decode(data: bytes, min_code_size: int, npixels: int):
    """GIF LZW decompression (grfmt_gif.cpp lzwExtractData role)."""
    clear = 1 << min_code_size
    end = clear + 1
    out = np.empty(npixels, np.uint8)
    n_out = 0

    # bit reader over the whole sub-block-joined stream
    bits = 0
    nbits = 0
    pos = 0
    code_size = min_code_size + 1
    dict_entries = {}   # code -> bytes
    next_code = end + 1
    prev = None

    def reset_dict():
        nonlocal dict_entries, next_code, code_size, prev
        dict_entries = {i: bytes([i]) for i in range(clear)}
        next_code = end + 1
        code_size = min_code_size + 1
        prev = None

    reset_dict()
    data_len = len(data)
    while n_out < npixels:
        while nbits < code_size:
            if pos >= data_len:
                return out[:n_out]
            bits |= data[pos] << nbits
            nbits += 8
            pos += 1
        code = bits & ((1 << code_size) - 1)
        bits >>= code_size
        nbits -= code_size

        if code == clear:
            reset_dict()
            continue
        if code == end:
            break
        if prev is None:
            entry = dict_entries[code]
        elif code in dict_entries:
            entry = dict_entries[code]
            if next_code < 4096:
                dict_entries[next_code] = dict_entries[prev] + entry[:1]
                next_code += 1
        else:
            seq = dict_entries[prev]
            entry = seq + seq[:1]
            if next_code < 4096:
                dict_entries[next_code] = entry
                next_code += 1
        take = min(len(entry), npixels - n_out)
        out[n_out:n_out + take] = np.frombuffer(entry[:take], np.uint8)
        n_out += take
        if (next_code == (1 << code_size) and code_size < 12):
            code_size += 1
        prev = code
    return out[:n_out]


def _lzw_encode(indices: np.ndarray, min_code_size: int) -> bytes:
    """GIF LZW compression."""
    clear = 1 << min_code_size
    end = clear + 1
    out = bytearray()
    bits = 0
    nbits = 0

    def emit(code, size):
        nonlocal bits, nbits
        bits |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(bits & 0xFF)
            bits >>= 8
            nbits -= 8

    table = {bytes([i]): i for i in range(clear)}
    next_code = end + 1
    code_size = min_code_size + 1
    emit(clear, code_size)
    seq = b""
    for px in indices.tobytes():
        cand = seq + bytes([px])
        if cand in table:
            seq = cand
        else:
            emit(table[seq], code_size)
            if next_code < 4096:
                table[cand] = next_code
                if next_code == (1 << code_size) and code_size < 12:
                    code_size += 1
                next_code += 1
            else:
                emit(clear, code_size)
                table = {bytes([i]): i for i in range(clear)}
                next_code = end + 1
                code_size = min_code_size + 1
            seq = bytes([px])
    if seq:
        emit(table[seq], code_size)
    emit(end, code_size)
    if nbits:
        out.append(bits & 0xFF)
    return bytes(out)


# ---------------------------------------------------------------- decode

def gif_decode(data: bytes):
    """First frame as BGR (or BGRA when transparency is flagged)."""
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF")
    W, H, flags, bg, _ = struct.unpack_from("<HHBBB", data, 6)
    pos = 13
    gct = None
    if flags & 0x80:
        n = 2 << (flags & 7)
        gct = np.frombuffer(data, np.uint8, n * 3, pos).reshape(n, 3)
        pos += n * 3

    transparent = None
    while pos < len(data):
        b0 = data[pos]
        if b0 == 0x21:  # extension
            label = data[pos + 1]
            pos += 2
            if label == 0xF9:  # graphic control
                sz = data[pos]
                gflags = data[pos + 1]
                if gflags & 1:
                    transparent = data[pos + 4]
                pos += sz + 1
            while data[pos] != 0:
                pos += data[pos] + 1
            pos += 1
        elif b0 == 0x2C:  # image descriptor
            x0, y0, iw, ih, iflags = struct.unpack_from("<HHHHB", data,
                                                        pos + 1)
            pos += 10
            table = gct
            if iflags & 0x80:
                n = 2 << (iflags & 7)
                table = np.frombuffer(data, np.uint8, n * 3,
                                      pos).reshape(n, 3)
                pos += n * 3
            min_code = data[pos]
            pos += 1
            chunks = []
            while data[pos] != 0:
                ln = data[pos]
                chunks.append(data[pos + 1:pos + 1 + ln])
                pos += ln + 1
            pos += 1
            idx = _lzw_decode(b"".join(chunks), min_code, iw * ih)
            if len(idx) < iw * ih:
                idx = np.pad(idx, (0, iw * ih - len(idx)))
            idx = idx.reshape(ih, iw)
            if iflags & 0x40:  # interlaced
                de = np.empty_like(idx)
                rows = list(range(0, ih, 8)) + list(range(4, ih, 8)) \
                    + list(range(2, ih, 4)) + list(range(1, ih, 2))
                de[np.asarray(rows)] = idx
                idx = de
            if table is None:
                table = np.stack([np.arange(256)] * 3, 1).astype(np.uint8)
            rgb = table[np.clip(idx, 0, len(table) - 1)]
            bgr = rgb[:, :, ::-1]
            frame = np.zeros((H, W, 3), np.uint8)
            frame[y0:y0 + ih, x0:x0 + iw] = bgr
            if transparent is not None:
                a = np.full((H, W, 1), 255, np.uint8)
                a[y0:y0 + ih, x0:x0 + iw, 0] = \
                    np.where(idx == transparent, 0, 255).astype(np.uint8)
                return np.concatenate([frame, a], axis=2)
            return frame
        elif b0 == 0x3B:  # trailer
            break
        else:
            pos += 1
    raise ValueError("GIF has no image frame")


# ---------------------------------------------------------------- encode

def _quantize(img_bgr):
    """(palette_rgb (n,3) u8, indices (H,W) u8)."""
    H, W = img_bgr.shape[:2]
    flat = img_bgr.reshape(-1, 3)
    colors, inv = np.unique(flat, axis=0, return_inverse=True)
    if len(colors) <= 256:
        return colors[:, ::-1].copy(), inv.astype(np.uint8).reshape(H, W)
    # 6x7x6 BGR cube
    b = (flat[:, 0].astype(np.int32) * 6) >> 8
    g = (flat[:, 1].astype(np.int32) * 7) >> 8
    r = (flat[:, 2].astype(np.int32) * 6) >> 8
    idx = (b * 42 + g * 6 + r).astype(np.uint8)
    pal = np.zeros((252, 3), np.uint8)
    bi, gi, ri = np.meshgrid(np.arange(6), np.arange(7), np.arange(6),
                             indexing="ij")
    pal[:, 2] = (bi.ravel() * 255 // 5).astype(np.uint8)   # B as RGB pal
    pal[:, 1] = (gi.ravel() * 255 // 6).astype(np.uint8)
    pal[:, 0] = (ri.ravel() * 255 // 5).astype(np.uint8)
    return pal, idx.reshape(H, W)


def gif_encode(img) -> bytes:
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    if img.shape[2] == 4:
        img = img[:, :, :3]
    H, W = img.shape[:2]
    pal, idx = _quantize(img)
    n = max(2, int(np.ceil(np.log2(max(len(pal), 2)))))
    size = 1 << n
    table = np.zeros((size, 3), np.uint8)
    table[:len(pal)] = pal

    out = bytearray()
    out += b"GIF89a"
    out += struct.pack("<HHBBB", W, H, 0x80 | ((n - 1) & 7), 0, 0)
    out += table.tobytes()
    out += struct.pack("<BHHHHB", 0x2C, 0, 0, W, H, 0)
    min_code = max(n, 2)
    out.append(min_code)
    payload = _lzw_encode(idx.reshape(-1), min_code)
    for i in range(0, len(payload), 255):
        blk = payload[i:i + 255]
        out.append(len(blk))
        out += blk
    out.append(0)
    out.append(0x3B)
    return bytes(out)


def gif_decode_all(data: bytes):
    """All frames (BGR, full-canvas composited) + per-frame durations in
    ms + loop count.  Disposal: 2 restores background (zeros), 3 falls
    back to previous (treated as 1), else leave-in-place."""
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF")
    W, H, flags, bg, _ = struct.unpack_from("<HHBBB", data, 6)
    pos = 13
    gct = None
    if flags & 0x80:
        n = 2 << (flags & 7)
        gct = np.frombuffer(data, np.uint8, n * 3, pos).reshape(n, 3)
        pos += n * 3

    frames, durations = [], []
    loop_count = 0
    canvas = np.zeros((H, W, 3), np.uint8)
    transparent = None
    duration = 100
    disposal = 0
    while pos < len(data):
        b0 = data[pos]
        if b0 == 0x21:
            label = data[pos + 1]
            pos += 2
            if label == 0xF9:
                sz = data[pos]
                gflags = data[pos + 1]
                delay = struct.unpack_from("<H", data, pos + 2)[0]
                duration = delay * 10
                disposal = (gflags >> 2) & 7
                transparent = data[pos + 4] if gflags & 1 else None
                pos += sz + 1
            elif label == 0xFF:   # application ext (NETSCAPE loop)
                sz = data[pos]
                app = data[pos + 1:pos + 1 + sz]
                p2 = pos + 1 + sz
                if app[:8] == b"NETSCAPE" and data[p2] >= 3:
                    stored = struct.unpack_from("<H", data, p2 + 2)[0]
                    # GIF stores additional repetitions; cv::Animation
                    # counts total loops (0 = infinite)
                    loop_count = stored + 1 if stored > 0 else 0
                pos = p2
            while data[pos] != 0:
                pos += data[pos] + 1
            pos += 1
        elif b0 == 0x2C:
            x0, y0, iw, ih, iflags = struct.unpack_from("<HHHHB", data,
                                                        pos + 1)
            pos += 10
            table = gct
            if iflags & 0x80:
                n = 2 << (iflags & 7)
                table = np.frombuffer(data, np.uint8, n * 3,
                                      pos).reshape(n, 3)
                pos += n * 3
            min_code = data[pos]
            pos += 1
            chunks = []
            while data[pos] != 0:
                ln = data[pos]
                chunks.append(data[pos + 1:pos + 1 + ln])
                pos += ln + 1
            pos += 1
            idx = _lzw_decode(b"".join(chunks), min_code, iw * ih)
            if len(idx) < iw * ih:
                idx = np.pad(idx, (0, iw * ih - len(idx)))
            idx = idx.reshape(ih, iw)
            if iflags & 0x40:
                de = np.empty_like(idx)
                rows = list(range(0, ih, 8)) + list(range(4, ih, 8)) \
                    + list(range(2, ih, 4)) + list(range(1, ih, 2))
                de[np.asarray(rows)] = idx
                idx = de
            if table is None:
                table = np.stack([np.arange(256)] * 3, 1)\
                    .astype(np.uint8)
            rgb = table[np.clip(idx, 0, len(table) - 1)]
            bgr = rgb[:, :, ::-1]
            region = canvas[y0:y0 + ih, x0:x0 + iw]
            if transparent is not None:
                m = (idx != transparent)[..., None]
                region[:] = np.where(m, bgr, region)
            else:
                region[:] = bgr
            frames.append(canvas.copy())
            durations.append(duration)
            if disposal == 2:
                canvas[y0:y0 + ih, x0:x0 + iw] = 0
        elif b0 == 0x3B:
            break
        else:
            pos += 1
    return frames, durations, loop_count


def gif_encode_multi(frames, durations=None, loop_count: int = 0) -> bytes:
    """Multi-frame GIF89a with per-frame delays and a NETSCAPE loop
    extension (imgcodecs GifEncoder behavior)."""
    frames = [np.asarray(f) for f in frames]
    fixed = []
    for f in frames:
        if f.ndim == 2:
            f = np.stack([f] * 3, -1)
        if f.shape[2] == 4:
            f = f[:, :, :3]
        fixed.append(f)
    H, W = fixed[0].shape[:2]
    if durations is None:
        durations = [100] * len(fixed)

    out = bytearray()
    out += b"GIF89a"
    out += struct.pack("<HHBBB", W, H, 0, 0, 0)  # no global table
    stored = loop_count - 1 if loop_count > 0 else 0
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" \
        + struct.pack("<H", stored) + b"\x00"
    for f, dur in zip(fixed, durations):
        pal, idx = _quantize(f)
        n = max(2, int(np.ceil(np.log2(max(len(pal), 2)))))
        size = 1 << n
        table = np.zeros((size, 3), np.uint8)
        table[:len(pal)] = pal
        out += struct.pack("<BBBBHBB", 0x21, 0xF9, 4, 0,
                           max(0, int(dur)) // 10, 0, 0)
        out += struct.pack("<BHHHHB", 0x2C, 0, 0, W, H,
                           0x80 | ((n - 1) & 7))
        out += table.tobytes()
        min_code = max(n, 2)
        out.append(min_code)
        payload = _lzw_encode(idx.reshape(-1), min_code)
        for i in range(0, len(payload), 255):
            blk = payload[i:i + 255]
            out.append(len(blk))
            out += blk
        out.append(0)
    out.append(0x3B)
    return bytes(out)
