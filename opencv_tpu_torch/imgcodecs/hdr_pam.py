"""Radiance HDR (.hdr, grfmt_hdr.cpp) and PAM (.pam, grfmt_pam.cpp).

HDR: RGBE shared-exponent pixels with the new-style per-channel RLE
scanlines; decodes to float32 BGR like the reference (rgbe.cpp
RGBE_ReadPixels_RLE semantics).  PAM: the P7 netpbm superset header +
raw tuples.

Twin of ``opencv_tpu/imgcodecs/hdr_pam.py``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["hdr_decode", "hdr_encode", "pam_decode", "pam_encode"]


# --------------------------------------------------------------------- HDR

def _rgbe_to_float(rgbe):
    """(..., 4) u8 RGBE -> (..., 3) f32 RGB (rgbe.cpp rgbe2float)."""
    r = rgbe[..., 0].astype(np.float32)
    g = rgbe[..., 1].astype(np.float32)
    b = rgbe[..., 2].astype(np.float32)
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0).astype(
        np.float32)
    return np.stack([r * scale, g * scale, b * scale], axis=-1)


def _float_to_rgbe(rgb):
    """(..., 3) f32 RGB -> (..., 4) u8 RGBE (rgbe.cpp float2rgbe)."""
    v = rgb.max(axis=-1)
    m, e = np.frexp(v)
    scale = np.where(v >= 1e-32, m * 256.0 / np.maximum(v, 1e-32), 0.0)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    out[..., 0] = np.clip(rgb[..., 0] * scale, 0, 255).astype(np.uint8)
    out[..., 1] = np.clip(rgb[..., 1] * scale, 0, 255).astype(np.uint8)
    out[..., 2] = np.clip(rgb[..., 2] * scale, 0, 255).astype(np.uint8)
    out[..., 3] = np.where(v >= 1e-32, e + 128, 0).astype(np.uint8)
    return out


def hdr_decode(data):
    """Returns float32 BGR (H, W, 3)."""
    if not (data[:2] == b"#?"):
        raise ValueError("not a Radiance HDR file")
    pos = data.index(b"\n") + 1
    # header lines until blank, then resolution line
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl]
        pos = nl + 1
        if line == b"":
            break
    nl = data.index(b"\n", pos)
    res = data[pos:nl].split()
    pos = nl + 1
    assert res[0] == b"-Y" and res[2] == b"+X", "unsupported orientation"
    H, W = int(res[1]), int(res[3])

    buf = np.frombuffer(data, np.uint8, offset=pos)
    out = np.zeros((H, W, 4), np.uint8)
    p = 0
    for y in range(H):
        if W < 8 or W > 0x7FFF or not (buf[p] == 2 and buf[p + 1] == 2
                                       and buf[p + 2] & 0x80 == 0):
            # flat (old-style) scanline: W RGBE pixels
            row = buf[p:p + 4 * W].reshape(W, 4)
            out[y] = row
            p += 4 * W
            continue
        assert (int(buf[p + 2]) << 8 | int(buf[p + 3])) == W
        p += 4
        for ch in range(4):
            x = 0
            while x < W:
                cnt = int(buf[p])
                p += 1
                if cnt > 128:       # run
                    out[y, x:x + cnt - 128, ch] = buf[p]
                    p += 1
                    x += cnt - 128
                else:               # literal
                    out[y, x:x + cnt, ch] = buf[p:p + cnt]
                    p += cnt
                    x += cnt
    rgb = _rgbe_to_float(out)
    return rgb[..., ::-1].copy()    # BGR like the reference


def hdr_encode(img, params=None):
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    rgb = img[..., ::-1].astype(np.float32)     # BGR -> RGB
    H, W = rgb.shape[:2]
    rgbe = _float_to_rgbe(rgb)
    out = bytearray()
    out += b"#?RGBE\nFORMAT=32-bit_rle_rgbe\n\n"
    out += f"-Y {H} +X {W}\n".encode()
    if W < 8 or W > 0x7FFF:
        out += rgbe.tobytes()
        return bytes(out)
    for y in range(H):
        out += bytes([2, 2, W >> 8, W & 0xFF])
        for ch in range(4):
            row = rgbe[y, :, ch]
            x = 0
            while x < W:
                # find run length at x
                run = 1
                while x + run < W and run < 127 and \
                        row[x + run] == row[x]:
                    run += 1
                if run >= 4:
                    out += bytes([128 + run, int(row[x])])
                    x += run
                else:
                    # literal until next run of >=4 or 128 cap
                    lit = x
                    while lit < W and lit - x < 128:
                        r2 = 1
                        while lit + r2 < W and r2 < 4 and \
                                row[lit + r2] == row[lit]:
                            r2 += 1
                        if r2 >= 4:
                            break
                        lit += 1
                    n = lit - x
                    out += bytes([n]) + row[x:x + n].tobytes()
                    x = lit
    return bytes(out)


# --------------------------------------------------------------------- PAM

def pam_decode(data):
    assert data[:3] == b"P7\n" or data[:3] == b"P7\r", "not a PAM file"
    pos = 3
    hdr = {}
    tupltype = ""
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl].decode("ascii", "replace").strip()
        pos = nl + 1
        if not line or line.startswith("#"):
            continue
        if line == "ENDHDR":
            break
        k, _, v = line.partition(" ")
        if k == "TUPLTYPE":
            tupltype = v.strip()
        else:
            hdr[k] = int(v)
    W, H = hdr["WIDTH"], hdr["HEIGHT"]
    depth = hdr.get("DEPTH", 1)
    maxval = hdr.get("MAXVAL", 255)
    dt = np.dtype(">u2") if maxval > 255 else np.uint8
    arr = np.frombuffer(data, dt, W * H * depth, pos)
    img = arr.reshape(H, W, depth).astype(
        np.uint16 if maxval > 255 else np.uint8)
    if depth >= 3 and tupltype.startswith("RGB"):
        order = [2, 1, 0] + list(range(3, depth))  # RGB(A) -> BGR(A)
        img = img[..., order]
    elif depth == 1:
        img = img[..., 0]
    return img


def pam_encode(img, params=None):
    img = np.asarray(img)
    # like the reference writer (grfmt_pam.cpp): raw channel order
    # (BGR as stored), no TUPLTYPE line
    if img.ndim == 2:
        depth = 1
        payload = img
    else:
        depth = img.shape[2]
        payload = img
    maxval = 65535 if img.dtype == np.uint16 else 255
    H, W = img.shape[:2]
    head = (f"P7\nWIDTH {W}\nHEIGHT {H}\nDEPTH {depth}\n"
            f"MAXVAL {maxval}\nENDHDR\n").encode()
    if maxval > 255:
        body = payload.astype(">u2").tobytes()
    else:
        body = payload.astype(np.uint8).tobytes()
    return head + body
