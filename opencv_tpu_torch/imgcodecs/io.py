"""Image IO (modules/imgcodecs), twin of ``opencv_tpu/imgcodecs/io.py``:
imread/imwrite for PNG (zlib, pure python encoder/decoder), BMP, PNM/PBM/
PFM and Sun raster here, and the dispatch to the other codecs of this
package (JPEG, TIFF, GIF, EXR, WebP, HDR, PAM, JPEG 2000, AVIF).

Decoded images are returned as numpy BGR(A) arrays exactly like cv2;
device pipelines copy them to the card (the host/device split the
reference also has: decode on CPU, dense work on the accelerator).  An
encoder takes a numpy array or a tensor on any device, which is read back
once (``core.arrays.to_host``).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from ..core.arrays import to_host

IMREAD_UNCHANGED = -1
IMREAD_GRAYSCALE = 0
IMREAD_COLOR = 1
IMREAD_ANYDEPTH = 2
IMREAD_ANYCOLOR = 4

__all__ = ["imread", "imwrite", "imdecode", "imencode",
           "imreadmulti", "imwritemulti", "imcount",
           "IMREAD_COLOR", "IMREAD_GRAYSCALE", "IMREAD_UNCHANGED",
           "IMREAD_ANYDEPTH", "IMREAD_ANYCOLOR"]


def _apply_read_flags(img, flags):
    if img is None:
        return None
    if flags == IMREAD_GRAYSCALE and img.ndim == 3:
        from ..ops.color import cvtColor
        from .. import constants as K
        img = to_host(cvtColor(img[..., :3], K.COLOR_BGR2GRAY))
    elif flags == IMREAD_COLOR:
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        elif img.shape[2] == 4:
            img = img[..., :3]
    return img


# ------------------------------------------------------------------- PNG

def _png_decode(data: bytes):
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    idat = b""
    w = h = bitdepth = colortype = None
    palette = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            w, h, bitdepth, colortype, _, _, interlace = \
                struct.unpack(">IIBBBBB", chunk)
            if interlace:
                raise ValueError("interlaced PNG not supported")
        elif ctype == b"PLTE":
            palette = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat += chunk
        elif ctype == b"IEND":
            break
    if bitdepth not in (8, 16):
        raise ValueError(f"bitdepth {bitdepth} not supported")
    nch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colortype]
    bpp = nch * (bitdepth // 8)
    raw = zlib.decompress(idat)
    stride = w * bpp
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for y in range(h):
        ft = raw[pos]
        row = np.frombuffer(raw[pos + 1:pos + 1 + stride], np.uint8).astype(np.int32)
        pos += 1 + stride
        if ft == 0:
            cur = row
        elif ft == 1:  # Sub
            cur = row.copy()
            for i in range(bpp, stride):
                cur[i] = (cur[i] + cur[i - bpp]) & 255
        elif ft == 2:  # Up
            cur = (row + prev) & 255
        elif ft == 3:  # Average
            cur = row.copy()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 255
        elif ft == 4:  # Paeth
            cur = row.copy()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 255
        else:
            raise ValueError(f"bad filter {ft}")
        out[y] = cur.astype(np.uint8)
        prev = cur
    if bitdepth == 16:
        arr = out.reshape(h, w, nch, 2)
        img = (arr[..., 0].astype(np.uint16) << 8) | arr[..., 1]
    else:
        img = out.reshape(h, w, nch)
    if colortype == 3:
        img = palette[img[..., 0]]
        nch = 3
    # PNG is RGB(A); cv2 returns BGR(A)
    if nch >= 3:
        img = img[..., [2, 1, 0] + ([3] if nch == 4 else [])]
    elif nch == 1:
        img = img[..., 0]
    return img


def _png_encode(img: np.ndarray) -> bytes:
    a = to_host(img)
    if a.ndim == 2:
        colortype, nch = 0, 1
        rgb = a[..., None]
    elif a.shape[2] == 3:
        colortype, nch = 2, 3
        rgb = a[..., [2, 1, 0]]  # BGR → RGB
    else:
        colortype, nch = 6, 4
        rgb = a[..., [2, 1, 0, 3]]
    h, w = a.shape[:2]
    if a.dtype == np.uint16:
        depth = 16
        payload = rgb.astype(">u2").tobytes()
        stride = w * nch * 2
    else:
        depth = 8
        payload = rgb.astype(np.uint8).tobytes()
        stride = w * nch
    rows = b"".join(b"\x00" + payload[y * stride:(y + 1) * stride]
                    for y in range(h))
    comp = zlib.compress(rows, 6)

    def chunk(ctype, body):
        c = struct.pack(">I", len(body)) + ctype + body
        crc = zlib.crc32(ctype + body) & 0xFFFFFFFF
        return c + struct.pack(">I", crc)

    ihdr = struct.pack(">IIBBBBB", w, h, depth, colortype, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", comp) + chunk(b"IEND", b""))


# ------------------------------------------------------------------- BMP

def _bmp_decode(data: bytes):
    assert data[:2] == b"BM"
    off = struct.unpack("<I", data[10:14])[0]
    hsize = struct.unpack("<I", data[14:18])[0]
    w, h = struct.unpack("<ii", data[18:26])
    bpp = struct.unpack("<H", data[28:30])[0]
    comp = struct.unpack("<I", data[30:34])[0]
    if comp != 0 or bpp not in (8, 24, 32):
        raise ValueError("unsupported BMP variant")
    flip = h > 0
    h = abs(h)
    stride = ((w * bpp // 8) + 3) & ~3
    raw = np.frombuffer(data[off:off + stride * h], np.uint8).reshape(h, stride)
    if bpp == 24:
        img = raw[:, :w * 3].reshape(h, w, 3)
    elif bpp == 32:
        img = raw[:, :w * 4].reshape(h, w, 4)[..., :3]
    else:
        img = raw[:, :w]
    if flip:
        img = img[::-1]
    return np.ascontiguousarray(img)


def _bmp_encode(img: np.ndarray) -> bytes:
    a = to_host(img)
    if a.ndim == 2:
        a = np.stack([a] * 3, axis=-1)
    h, w = a.shape[:2]
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = a[..., :3].reshape(h, -1)
    body = rows[::-1].tobytes()
    header = b"BM" + struct.pack("<IHHI", 54 + len(body), 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(body),
                       2835, 2835, 0, 0)
    return header + info + body


# ----------------------------------------------------------------- PPM/PGM

def _pnm_header(data: bytes, n_fields: int):
    """Parse a PNM header skipping '#' comments; returns (fields,
    payload offset)."""
    fields = []
    pos = 0
    token = b""
    while len(fields) < n_fields and pos < len(data):
        ch = data[pos:pos + 1]
        pos += 1
        if ch == b"#":
            nl = data.find(b"\n", pos)
            pos = len(data) if nl < 0 else nl + 1
            continue
        if ch.isspace():
            if token:
                fields.append(token)
                token = b""
            continue
        token += ch
    if token and len(fields) < n_fields:
        fields.append(token)
    return fields, pos


def _pnm_decode(data: bytes):
    """PNM family (reference: modules/imgcodecs/src/grfmt_pxm.cpp):
    P1/P4 bitmaps (1 = black = 0), P2/P5 graymaps, P3/P6 pixmaps."""
    magic = data[:2]
    if magic in (b"P1", b"P4"):  # PBM — no maxval field
        (_, ws, hs), pos = _pnm_header(data, 3)
        w, h = int(ws), int(hs)
        if magic == b"P4":
            stride = (w + 7) // 8
            raw = np.frombuffer(data, np.uint8, stride * h, pos)
            bits = np.unpackbits(raw.reshape(h, stride),
                                 axis=1)[:, :w]
        else:
            # P1 digits may be packed without whitespace; '#' comments
            digits = []
            body = data[pos:]
            i = 0
            while i < len(body) and len(digits) < w * h:
                c = body[i:i + 1]
                if c == b"#":
                    nl = body.find(b"\n", i)
                    i = len(body) if nl < 0 else nl + 1
                    continue
                if c in (b"0", b"1"):
                    digits.append(0 if c == b"0" else 1)
                i += 1
            bits = np.array(digits, np.uint8).reshape(h, w)
        return ((1 - bits) * 255).astype(np.uint8)  # 1 = black
    (_, ws, hs, mv), pos = _pnm_header(data, 4)
    w, h, maxv = int(ws), int(hs), int(mv)
    if magic in (b"P2", b"P3"):  # ASCII
        ch = 1 if magic == b"P2" else 3
        toks = data[pos:].split()
        vals = np.array([int(t) for t in toks[:w * h * ch]],
                        np.int64)
        dt = np.uint8 if maxv < 256 else np.uint16
        img = vals.astype(dt).reshape((h, w) if ch == 1 else (h, w, 3))
        if ch == 3:
            img = img[..., ::-1]
        return np.ascontiguousarray(img)
    raw = data[pos:]
    dt = np.uint8 if maxv < 256 else ">u2"
    if magic == b"P5":
        img = np.frombuffer(raw, dt, w * h).reshape(h, w)
    elif magic == b"P6":
        img = np.frombuffer(raw, dt, w * h * 3).reshape(h, w, 3)[..., ::-1]
    else:
        raise ValueError(f"unsupported PNM magic {magic}")
    return np.ascontiguousarray(img.astype(np.uint16 if maxv >= 256 else np.uint8))


def _pbm_encode(img: np.ndarray) -> bytes:
    a = to_host(img)
    if a.ndim == 3:
        from ..ops.color import cvtColor
        from .. import constants as K
        a = to_host(cvtColor(a, K.COLOR_BGR2GRAY))
    bits = (a < 128).astype(np.uint8)      # 1 = black
    packed = np.packbits(bits, axis=1)
    head = b"P4\n%d %d\n" % (a.shape[1], a.shape[0])
    return head + packed.tobytes()


def _pfm_decode(data: bytes):
    """PFM (grfmt_pfm.cpp): 'PF' = 3-ch, 'Pf' = 1-ch float32; scale
    sign = endianness; rows stored BOTTOM-UP; file is RGB."""
    (magic, ws, hs, sc), pos = _pnm_header(data, 4)
    w, h = int(ws), int(hs)
    scale = float(sc)
    ch = 3 if magic == b"PF" else 1
    dt = "<f4" if scale < 0 else ">f4"
    img = np.frombuffer(data, dt, w * h * ch, pos).astype(np.float32)
    img = img.reshape(h, w, ch)[::-1]      # bottom-up
    if ch == 3:
        img = img[..., ::-1]               # RGB file -> BGR
    else:
        img = img[..., 0]
    s = abs(scale)
    if s not in (0.0, 1.0):
        img = img * np.float32(s)
    return np.ascontiguousarray(img)


def _pfm_encode(img: np.ndarray) -> bytes:
    a = np.asarray(img, np.float32)
    if a.ndim == 3 and a.shape[2] == 3:
        magic = b"PF"
        payload = a[::-1, :, ::-1]         # bottom-up, BGR -> RGB
    else:
        magic = b"Pf"
        payload = a.reshape(a.shape[0], -1)[::-1]
    head = b"%s\n%d %d\n-1\n" % (magic, a.shape[1], a.shape[0])
    return head + np.ascontiguousarray(payload, "<f4").tobytes()


_RAS_MAGIC = 0x59A66A95


def _sunras_decode(data: bytes):
    """Sun raster (grfmt_sunras.cpp): big-endian header, depths
    1/8/24/32, RT_OLD/STANDARD (raw) and RT_BYTE_ENCODED (0x80 RLE),
    optional RGB palette; rows padded to 16 bits; 24-bit is BGR unless
    type RT_FORMAT_RGB."""
    (magic, w, h, depth, length, rtype, maptype, maplen) = \
        __import__("struct").unpack(">8I", data[:32])
    if magic != _RAS_MAGIC:
        raise ValueError("not a Sun raster")
    pos = 32
    palette = None
    if maptype == 1 and maplen:
        pal = np.frombuffer(data, np.uint8, maplen, pos)
        n = maplen // 3
        palette = np.stack([pal[2 * n:3 * n], pal[n:2 * n], pal[:n]],
                           axis=1)  # file RGB planes -> BGR rows
    pos += maplen
    stride = ((w * depth + 15) // 16) * 2  # rows padded to 16 bits
    need = stride * h
    if rtype == 2:  # RT_BYTE_ENCODED
        raw = np.empty(need, np.uint8)
        src = data
        i, o = pos, 0
        while o < need and i < len(src):
            b = src[i]
            i += 1
            if b == 0x80:
                cnt = src[i]
                i += 1
                if cnt == 0:
                    raw[o] = 0x80
                    o += 1
                else:
                    v = src[i]
                    i += 1
                    raw[o:o + cnt + 1] = v
                    o += cnt + 1
            else:
                raw[o] = b
                o += 1
        raw = raw[:need]
    else:
        raw = np.frombuffer(data, np.uint8, min(need, len(data) - pos),
                            pos)
        if len(raw) < need:
            raw = np.concatenate([raw,
                                  np.zeros(need - len(raw), np.uint8)])
    rows = raw.reshape(h, stride)
    if depth == 1:
        bits = np.unpackbits(rows, axis=1)[:, :w]
        img = ((1 - bits) * 255).astype(np.uint8)  # 1 = black
        if palette is not None and len(palette) >= 2:
            img = palette[bits.astype(np.int64)]
    elif depth == 8:
        img = rows[:, :w]
        if palette is not None:
            img = palette[img.astype(np.int64)]
    elif depth == 24:
        img = rows[:, :w * 3].reshape(h, w, 3)
        if rtype == 3:  # RT_FORMAT_RGB
            img = img[..., ::-1]
    elif depth == 32:
        px = rows[:, :w * 4].reshape(h, w, 4)
        # file layout x,B,G,R (xBGR); RT_FORMAT_RGB = x,R,G,B
        img = px[..., 1:4] if rtype != 3 else px[..., :0:-1]
    else:
        raise ValueError(f"unsupported Sun raster depth {depth}")
    return np.ascontiguousarray(img)


def _sunras_encode(img: np.ndarray) -> bytes:
    import struct as _struct
    a = np.asarray(img, np.uint8)
    h, w = a.shape[:2]
    depth = 8 if a.ndim == 2 else 24
    stride = ((w * depth + 15) // 16) * 2
    rows = np.zeros((h, stride), np.uint8)
    if depth == 8:
        rows[:, :w] = a
        maptype, maplen = 1, 768
        pal = np.arange(256, dtype=np.uint8)
        cmap = pal.tobytes() * 3           # identity gray palette
    else:
        rows[:, :w * 3] = a.reshape(h, w * 3)
        maptype, maplen = 0, 0
        cmap = b""
    head = _struct.pack(">8I", _RAS_MAGIC, w, h, depth,
                        stride * h, 1, maptype, maplen)
    return head + cmap + rows.tobytes()


def _pnm_encode(img: np.ndarray, ext: str) -> bytes:
    a = to_host(img)
    if ext == ".pgm":
        if a.ndim == 3:
            from ..ops.color import cvtColor
            from .. import constants as K
            a = to_host(cvtColor(a, K.COLOR_BGR2GRAY))
        head = b"P5\n%d %d\n255\n" % (a.shape[1], a.shape[0])
        return head + a.astype(np.uint8).tobytes()
    if a.ndim == 2:
        a = np.stack([a] * 3, axis=-1)
    head = b"P6\n%d %d\n255\n" % (a.shape[1], a.shape[0])
    return head + a[..., ::-1].astype(np.uint8).tobytes()


# ---------------------------------------------------------------- public

def imdecode(buf, flags: int = IMREAD_COLOR):
    data = bytes(np.asarray(buf, np.uint8))
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        img = _png_decode(data)
    elif data[:2] == b"BM":
        img = _bmp_decode(data)
    elif data[:2] in (b"P1", b"P2", b"P3", b"P4", b"P5", b"P6"):
        img = _pnm_decode(data)
    elif data[:2] in (b"PF", b"Pf"):
        img = _pfm_decode(data)
    elif data[:4] == b"\x59\xa6\x6a\x95":
        img = _sunras_decode(data)
    elif data[:2] == b"\xff\xd8":
        from .jpeg import jpeg_decode
        # the reference asks libjpeg for JCS_GRAYSCALE directly (the Y
        # plane), which differs from BGR->GRAY of the color decode
        img = jpeg_decode(data, grayscale=(flags == IMREAD_GRAYSCALE))
    elif data[:4] in (b"II*\x00", b"MM\x00*"):
        from .tiff import tiff_decode
        img = tiff_decode(data)
    elif data[:6] in (b"GIF87a", b"GIF89a"):
        from .gif import gif_decode
        img = gif_decode(data)
    elif data[:4] == b"\x76\x2f\x31\x01":
        from .exr import exr_decode
        img = exr_decode(data)
    elif data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        from .webp import webp_decode
        img = webp_decode(data)
    elif data[:2] == b"#?":
        from .hdr_pam import hdr_decode
        img = hdr_decode(data)
    elif data[:2] == b"P7":
        from .hdr_pam import pam_decode
        img = pam_decode(data)
    elif data[:12] == b"\x00\x00\x00\x0cjP  \r\n\x87\n" \
            or data[:2] == b"\xff\x4f":
        from .jpeg2000 import jp2_decode
        img = jp2_decode(data)
    elif len(data) > 12 and data[4:8] == b"ftyp" and (
            b"avif" in data[8:32] or b"avis" in data[8:32]):
        from .avif import avif_decode
        img = avif_decode(data)
    else:
        raise ValueError("unsupported image format "
                         "(PNG/BMP/PNM/JPEG/TIFF/GIF/EXR/WebP/JPEG2000 available)")
    if flags == IMREAD_GRAYSCALE and img.ndim == 3:
        from ..ops.color import cvtColor
        from .. import constants as K
        img = to_host(cvtColor(img[..., :3], K.COLOR_BGR2GRAY))
    elif flags == IMREAD_COLOR:
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        elif img.shape[2] == 4:
            img = img[..., :3]
    return img


def imread(filename: str, flags: int = IMREAD_COLOR):
    if not os.path.exists(filename):
        return None
    with open(filename, "rb") as f:
        data = f.read()
    return imdecode(np.frombuffer(data, np.uint8), flags)


def imencode(ext: str, img, params=None):
    ext = ext.lower()
    img = to_host(img)
    if ext in (".png",):
        data = _png_encode(img)
    elif ext in (".bmp", ".dib"):
        data = _bmp_encode(img)
    elif ext in (".ppm", ".pgm", ".pnm"):
        data = _pnm_encode(img, ext)
    elif ext == ".pbm":
        data = _pbm_encode(img)
    elif ext == ".pfm":
        data = _pfm_encode(img)
    elif ext in (".sr", ".ras"):
        data = _sunras_encode(img)
    elif ext in (".jpg", ".jpeg", ".jpe"):
        from .jpeg import jpeg_encode
        from .. import constants as K
        quality = 95
        sampling = 0x221111  # libjpeg default 4:2:0
        optimize = 0
        rst = 0
        luma_q = -1
        chroma_q = -1
        if params:
            p = list(params)
            for i in range(0, len(p) - 1, 2):
                if p[i] == 1:   # IMWRITE_JPEG_QUALITY
                    quality = int(p[i + 1])
                elif p[i] == 3:  # IMWRITE_JPEG_OPTIMIZE
                    optimize = int(p[i + 1])
                elif p[i] == 4:  # IMWRITE_JPEG_RST_INTERVAL
                    rst = min(max(int(p[i + 1]), 0), 65535)
                elif p[i] == 5:  # IMWRITE_JPEG_LUMA_QUALITY
                    luma_q = int(p[i + 1])
                elif p[i] == 6:  # IMWRITE_JPEG_CHROMA_QUALITY
                    chroma_q = int(p[i + 1])
                elif p[i] == 7:  # IMWRITE_JPEG_SAMPLING_FACTOR
                    sampling = int(p[i + 1])
        data = bytes(jpeg_encode(img, quality, sampling, optimize=optimize,
                                 rst_interval=rst, luma_quality=luma_q,
                                 chroma_quality=chroma_q))
    elif ext in (".tif", ".tiff"):
        from .tiff import tiff_encode
        data = tiff_encode(img)
    elif ext == ".gif":
        from .gif import gif_encode
        data = gif_encode(img)
    elif ext in (".jp2", ".j2k", ".jpc"):
        from .jpeg2000 import jp2_encode
        data = jp2_encode(img)
    elif ext == ".exr":
        from .exr import exr_encode
        data = exr_encode(img, params)
    elif ext == ".webp":
        from .webp import webp_encode
        data = webp_encode(img)
    elif ext in (".hdr", ".pic"):
        from .hdr_pam import hdr_encode
        data = hdr_encode(img, params)
    elif ext == ".pam":
        from .hdr_pam import pam_encode
        data = pam_encode(img, params)
    elif ext == ".avif":
        from .avif import avif_encode
        data = avif_encode(img, params)
    else:
        raise ValueError(f"unsupported extension {ext}")
    return True, np.frombuffer(data, np.uint8)


def imwrite(filename: str, img, params=None) -> bool:
    ext = os.path.splitext(filename)[1].lower()
    ok, data = imencode(ext, img, params)
    with open(filename, "wb") as f:
        f.write(bytes(data))
    return True


def imcount(filename: str, flags: int = IMREAD_ANYCOLOR) -> int:
    """`cv::imcount` — number of pages/frames in the file."""
    if not os.path.exists(filename):
        return 0
    with open(filename, "rb") as f:
        data = f.read()
    from .tiff import is_tiff, tiff_decode_all
    if is_tiff(data):
        return len(tiff_decode_all(data))
    return 1


def imreadmulti(filename: str, mats=None, flags: int = IMREAD_ANYCOLOR,
                start: int = 0, count: int = -1):
    """`cv::imreadmulti` (imgcodecs/src/loadsave.cpp): decode all (or
    [start, start+count)) pages of a multi-page file.  Returns
    (ok, [imgs])."""
    if not os.path.exists(filename):
        return False, []
    with open(filename, "rb") as f:
        data = f.read()
    from .tiff import is_tiff, tiff_decode_all
    pages = None
    if is_tiff(data):
        pages = tiff_decode_all(data)
    if pages is None:
        one = imdecode(np.frombuffer(data, np.uint8), flags)
        pages = [one] if one is not None else []
    out = []
    for p in pages:
        out.append(_apply_read_flags(p, flags))
    if start or count >= 0:
        end = len(out) if count < 0 else start + count
        out = out[start:end]
    return (len(out) > 0), out


def imwritemulti(filename: str, imgs, params=None) -> bool:
    """`cv::imwritemulti` — multi-page TIFF write."""
    ext = os.path.splitext(filename)[1].lower()
    imgs = [to_host(i) for i in imgs]
    if not imgs:
        return False
    if ext in (".tif", ".tiff"):
        from .tiff import tiff_encode_multi
        data = tiff_encode_multi(imgs)
        with open(filename, "wb") as f:
            f.write(data)
        return True
    if len(imgs) == 1:
        return imwrite(filename, imgs[0], params)
    raise ValueError(f"multi-page write not supported for {ext}")


def imdecodemulti(buf, flags: int = IMREAD_ANYCOLOR, mats=None,
                  range_=None):
    """`cv::imdecodemulti` — in-memory multi-page decode.  Returns
    (ok, [imgs])."""
    data = bytes(np.asarray(buf, np.uint8))
    from .tiff import is_tiff, tiff_decode_all
    pages = None
    if is_tiff(data):
        pages = tiff_decode_all(data)
    if pages is None:
        try:
            one = imdecode(np.frombuffer(data, np.uint8), flags)
        except ValueError:
            return False, []
        pages = [one] if one is not None else []
    out = [_apply_read_flags(p, flags) for p in pages]
    if range_ is not None:
        out = out[range_[0]:range_[1]]
    return (len(out) > 0), out


def imencodemulti(ext: str, imgs, params=None):
    """`cv::imencodemulti` — in-memory multi-page encode (TIFF)."""
    imgs = [to_host(i) for i in imgs]
    if not imgs:
        return False, b""
    ext = ext.lower()
    if ext in (".tif", ".tiff"):
        from .tiff import tiff_encode_multi
        return True, np.frombuffer(tiff_encode_multi(imgs), np.uint8)
    if len(imgs) == 1:
        ok, buf = imencode(ext, imgs[0], params)
        return ok, buf
    return False, b""


_READER_EXTS = (".png", ".bmp", ".dib", ".ppm", ".pgm", ".pnm", ".pbm",
                ".pfm", ".sr", ".ras", ".jpg",
                ".jpeg", ".jpe", ".tif", ".tiff", ".gif", ".exr",
                ".webp", ".hdr", ".pic", ".pam", ".avif")
_WRITER_EXTS = (".png", ".bmp", ".dib", ".ppm", ".pgm", ".pnm", ".pbm",
                ".pfm", ".sr", ".ras", ".jpg",
                ".jpeg", ".jpe", ".tif", ".tiff", ".gif", ".exr",
                ".webp", ".hdr", ".pam", ".avif")


def haveImageReader(filename: str) -> bool:
    """cv::haveImageReader — true iff the file exists and a decoder
    recognizes its content (the reference probes the file, not the
    extension)."""
    try:
        with open(filename, "rb") as f:
            head = f.read(16)
    except OSError:
        return False
    sigs = (b"\x89PNG\r\n\x1a\n", b"BM", b"P1", b"P2", b"P3", b"P4",
            b"P5", b"P6", b"P7", b"PF", b"Pf", b"\x59\xa6\x6a\x95",
            b"\xff\xd8",
            b"II*\x00", b"MM\x00*", b"GIF87a", b"GIF89a",
            b"\x76\x2f\x31\x01", b"#?", b"\xff\x4f",
            b"\x00\x00\x00\x0cjP")
    if any(head.startswith(s) for s in sigs):
        return True
    if head[4:8] == b"ftyp" and (b"avif" in head[8:16]
                                 or b"avis" in head[8:16]):
        from .avif import have_avif
        return have_avif()
    return head[:4] == b"RIFF" and head[8:12] == b"WEBP"


def haveImageWriter(filename: str) -> bool:
    """cv::haveImageWriter — extension-based encoder availability."""
    return os.path.splitext(filename)[1].lower() in _WRITER_EXTS


class Animation:
    """cv::Animation (imgcodecs/include: loop_count, bgcolor, durations
    in ms, frames, still_image)."""

    def __init__(self, loopCount: int = 0, bgColor=(0, 0, 0, 0)):
        self.loop_count = loopCount
        self.bgcolor = bgColor
        self.durations = []
        self.frames = []
        self.still_image = None


def imreadanimation(filename: str, start: int = 0, count: int = 32767):
    """cv::imreadanimation — multi-frame animation read (GIF)."""
    anim = Animation()
    try:
        with open(filename, "rb") as f:
            data = f.read()
    except OSError:
        return False, anim
    if data[:6] in (b"GIF87a", b"GIF89a"):
        from .gif import gif_decode_all
        frames, durs, loop = gif_decode_all(data)
        anim.frames = frames[start:start + count]
        anim.durations = durs[start:start + count]
        anim.loop_count = loop
        return len(anim.frames) > 0, anim
    img = imread(filename, IMREAD_UNCHANGED)
    if img is None:
        return False, anim
    anim.frames = [img]
    anim.durations = [1000]
    return True, anim


def imwriteanimation(filename: str, animation, params=None) -> bool:
    """cv::imwriteanimation — multi-frame animation write (GIF)."""
    ext = os.path.splitext(filename)[1].lower()
    frames = [to_host(f) for f in animation.frames]
    if not frames:
        return False
    if ext == ".gif":
        from .gif import gif_encode_multi
        data = gif_encode_multi(frames, list(animation.durations),
                                int(animation.loop_count))
        with open(filename, "wb") as f:
            f.write(data)
        return True
    return imwritemulti(filename, frames, params)


def imdecodeanimation(buf, start: int = 0, count: int = 32767):
    """cv::imdecodeanimation — in-memory animation decode (GIF)."""
    data = bytes(np.asarray(buf, np.uint8))
    anim = Animation()
    if data[:6] in (b"GIF87a", b"GIF89a"):
        from .gif import gif_decode_all
        frames, durs, loop = gif_decode_all(data)
        anim.frames = frames[start:start + count]
        anim.durations = durs[start:start + count]
        anim.loop_count = loop
        return len(anim.frames) > 0, anim
    try:
        img = imdecode(np.frombuffer(data, np.uint8), IMREAD_UNCHANGED)
    except ValueError:
        return False, anim
    anim.frames, anim.durations = [img], [1000]
    return True, anim


def imencodeanimation(ext: str, animation, params=None):
    """cv::imencodeanimation — in-memory animation encode (GIF)."""
    if ext.lower() != ".gif" or not animation.frames:
        return False, b""
    from .gif import gif_encode_multi
    data = gif_encode_multi([to_host(f) for f in animation.frames],
                            list(animation.durations),
                            int(animation.loop_count))
    return True, np.frombuffer(data, np.uint8)


def imreadWithMetadata(filename: str, flags: int = IMREAD_ANYCOLOR,
                       metadata=None):
    """cv::imreadWithMetadata — image + (metadataTypes, metadata).
    Our encoders do not embed EXIF/XMP/ICC, so the metadata lists are
    empty (same shape of result as the wheel for metadata-free files)."""
    img = imread(filename, flags)
    return img, [], []


def imwriteWithMetadata(filename: str, img, metadataTypes, metadata,
                        params=None) -> bool:
    """cv::imwriteWithMetadata — metadata payloads are accepted and
    ignored (no EXIF writer yet); the image itself is written."""
    return imwrite(filename, img, params)


def imdecodeWithMetadata(buf, flags: int = IMREAD_ANYCOLOR,
                         metadata=None):
    img = imdecode(buf, flags)
    return img, [], []


def imencodeWithMetadata(ext: str, img, metadataTypes, metadata,
                         params=None):
    return imencode(ext, img, params)
