"""Standalone identity-MC lossless AVIF encoder (libavif 0.11 ctypes).

Run as a SUBPROCESS by imgcodecs/avif.py: the parent process usually
has PIL's statically-linked libavif/libaom loaded, whose exported
symbols collide with the system libavif — encoding must happen in a
process that never imports PIL.  Protocol:

    argv: width height channels speed
    stdin: raw interleaved BGR/BGRA bytes (h*w*channels)
    stdout: the encoded AVIF bytes (empty + exit 1 on failure)

Only ctypes/sys are imported — startup stays a few ms.  Struct offsets
are for libavif 0.11.x, anchored at runtime (version + geometry check).

Twin of ``opencv_tpu/imgcodecs/_avif_worker.py``.
"""

import ctypes
import sys


def main():
    w, h, ch, speed = (int(x) for x in sys.argv[1:5])
    raw = sys.stdin.buffer.read(w * h * ch)
    if len(raw) != w * h * ch:
        return 1
    lib = None
    for name in ("libavif.so.15", "libavif.so"):
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            pass
    if lib is None:
        return 1
    lib.avifVersion.restype = ctypes.c_char_p
    if not lib.avifVersion().startswith(b"0.11"):
        return 1
    lib.avifImageCreate.restype = ctypes.c_void_p
    lib.avifImageCreate.argtypes = [ctypes.c_uint32] * 3 + [ctypes.c_int]
    lib.avifImageAllocatePlanes.restype = ctypes.c_int
    lib.avifImageAllocatePlanes.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.avifEncoderCreate.restype = ctypes.c_void_p

    class RW(ctypes.Structure):
        _fields_ = [("data", ctypes.c_void_p), ("size", ctypes.c_size_t)]

    lib.avifEncoderWrite.restype = ctypes.c_int
    lib.avifEncoderWrite.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.POINTER(RW)]

    img = lib.avifImageCreate(w, h, 8, 1)           # 8-bit YUV444
    if not img:
        return 1
    # anchors: w/h at offsets 0/4 (avifImage, libavif 0.11 ABI)
    if ctypes.c_uint32.from_address(img).value != w:
        return 1
    ctypes.c_uint32.from_address(img + 16).value = 1     # full range
    ctypes.c_uint16.from_address(img + 104).value = 1    # CP BT.709
    ctypes.c_uint16.from_address(img + 106).value = 13   # TC sRGB
    ctypes.c_uint16.from_address(img + 108).value = 0    # MC identity
    if lib.avifImageAllocatePlanes(img, 1 | (2 if ch == 4 else 0)) != 0:
        return 1
    planes = (ctypes.c_void_p * 3).from_address(img + 24)
    rowbytes = (ctypes.c_uint32 * 3).from_address(img + 48)
    if rowbytes[0] < w:
        return 1
    # identity MC plane order is G, B, R; input is B,G,R(,A) interleaved
    for plane_i, chan in ((0, 1), (1, 0), (2, 2)):
        dst = planes[plane_i]
        rb = rowbytes[plane_i]
        for y in range(h):
            row = raw[y * w * ch + chan:(y + 1) * w * ch:ch]
            ctypes.memmove(dst + y * rb, row, w)
    if ch == 4:
        ap = ctypes.c_void_p.from_address(img + 64).value
        arb = ctypes.c_uint32.from_address(img + 72).value
        for y in range(h):
            row = raw[y * w * ch + 3:(y + 1) * w * ch:ch]
            ctypes.memmove(ap + y * arb, row, w)
    enc = lib.avifEncoderCreate()
    if not enc:
        return 1
    ctypes.c_int32.from_address(enc + 8).value = max(0, min(10, speed))
    out = RW()
    if lib.avifEncoderWrite(enc, img, ctypes.byref(out)) != 0:
        return 1
    sys.stdout.buffer.write(ctypes.string_at(out.data, out.size))
    return 0


if __name__ == "__main__":
    sys.exit(main())
