"""FFmpeg adapter backend for videoio (CAP_FFMPEG analogue).

Same architectural position as the reference's FFmpeg backend
(reference: modules/videoio/src/cap_ffmpeg.cpp:1, cap_ffmpeg_impl.hpp):
an adapter over the system libavformat/libavcodec/libswscale public
API, handling every compressed container/payload whose bitstream spec
is not derivable in-image (MP4/H.264, HEVC, VP9, MPEG-4 ASP, MKV, ...).

The from-scratch codecs (MJPEG-AVI, HuffYUV, FFV1, raw AVI, Y4M) stay
first-tier in videoio.py; this module is the fallback tier, and is
gated: when the FFmpeg dev stack is absent the native shim fails to
build and `available()` returns False without breaking anything else.

Twin of ``opencv_tpu/videoio_ffmpeg.py`` over the port's copy of the shim,
``native/ffmpegio.c``.  ``gcc`` builds it into ``opencv_tpu_torch/_build/``
under a name that carries a hash of the source and the flags (written to a
temporary name and moved into place), never beside the source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "native" / "ffmpegio.c"
BUILD_DIR = _PKG / "_build"
CC_FLAGS = ["-O2", "-shared", "-fPIC"]
LIBS = ["-lavformat", "-lavcodec", "-lavutil", "-lswscale"]
_LIB = None
_TRIED = False


def library_path() -> Path:
    """Where the shim is built: ``_build/libffmpegio_<hash>.so``."""
    h = hashlib.sha256(" ".join(["gcc", *CC_FLAGS, *LIBS]).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libffmpegio_{h.hexdigest()[:16]}.so"


def _build():
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp.so"
    try:
        subprocess.run(["gcc", *CC_FLAGS, str(SOURCE), "-o", str(tmp), *LIBS],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except Exception:
        return None
    finally:
        tmp.unlink(missing_ok=True)


def _get_lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.ocvt_ff_reader_open.restype = ctypes.c_void_p
    lib.ocvt_ff_reader_open.argtypes = [ctypes.c_char_p]
    lib.ocvt_ff_reader_info.restype = None
    lib.ocvt_ff_reader_info.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint32)]
    lib.ocvt_ff_reader_read.restype = ctypes.c_int
    lib.ocvt_ff_reader_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.ocvt_ff_reader_seek.restype = ctypes.c_int
    lib.ocvt_ff_reader_seek.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.ocvt_ff_reader_tell.restype = ctypes.c_int64
    lib.ocvt_ff_reader_tell.argtypes = [ctypes.c_void_p]
    lib.ocvt_ff_reader_close.restype = None
    lib.ocvt_ff_reader_close.argtypes = [ctypes.c_void_p]
    lib.ocvt_ff_writer_open.restype = ctypes.c_void_p
    lib.ocvt_ff_writer_open.argtypes = [
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_double,
        ctypes.c_int, ctypes.c_int]
    lib.ocvt_ff_writer_write.restype = ctypes.c_int
    lib.ocvt_ff_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.ocvt_ff_writer_close.restype = ctypes.c_int
    lib.ocvt_ff_writer_close.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def available() -> bool:
    return _get_lib() is not None


class FFmpegReader:
    """Decode any FFmpeg-supported video file to BGR24 frames."""

    def __init__(self, path: str):
        lib = _get_lib()
        self._lib = lib
        self._h = None
        if lib is None:
            return
        h = lib.ocvt_ff_reader_open(str(path).encode())
        if not h:
            return
        self._h = h
        w = ctypes.c_int()
        hh = ctypes.c_int()
        fps = ctypes.c_double()
        nf = ctypes.c_int64()
        fcc = ctypes.c_uint32()
        lib.ocvt_ff_reader_info(h, ctypes.byref(w), ctypes.byref(hh),
                                ctypes.byref(fps), ctypes.byref(nf),
                                ctypes.byref(fcc))
        self.width = w.value
        self.height = hh.value
        self.fps = fps.value
        self.frame_count = nf.value
        self.fourcc = fcc.value

    @property
    def ok(self):
        return self._h is not None

    def read(self):
        if self._h is None:
            return False, None
        buf = np.empty((self.height, self.width, 3), np.uint8)
        r = self._lib.ocvt_ff_reader_read(
            self._h, buf.ctypes.data_as(ctypes.c_void_p))
        if not r:
            return False, None
        return True, buf

    def grab(self) -> bool:
        if self._h is None:
            return False
        return bool(self._lib.ocvt_ff_reader_read(self._h, None))

    def seek(self, frame_idx: int) -> bool:
        if self._h is None:
            return False
        return bool(self._lib.ocvt_ff_reader_seek(self._h, int(frame_idx)))

    def tell(self) -> int:
        if self._h is None:
            return 0
        return int(self._lib.ocvt_ff_reader_tell(self._h))

    def close(self):
        if self._h is not None:
            self._lib.ocvt_ff_reader_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class FFmpegWriter:
    """Encode BGR24 frames into any FFmpeg-supported container/codec."""

    def __init__(self, path: str, fourcc: int, fps: float, width: int,
                 height: int):
        lib = _get_lib()
        self._lib = lib
        self._h = None
        self.width, self.height = int(width), int(height)
        if lib is None:
            return
        h = lib.ocvt_ff_writer_open(str(path).encode(), int(fourcc) & 0xFFFFFFFF,
                                    float(fps), self.width, self.height)
        self._h = h if h else None

    @property
    def ok(self):
        return self._h is not None

    def write(self, bgr: np.ndarray) -> bool:
        if self._h is None:
            return False
        a = np.ascontiguousarray(bgr, dtype=np.uint8)
        if a.ndim == 2:
            a = np.stack([a] * 3, axis=-1)
        if a.shape[0] != self.height or a.shape[1] != self.width:
            return False
        return bool(self._lib.ocvt_ff_writer_write(
            self._h, a.ctypes.data_as(ctypes.c_void_p)))

    def close(self) -> bool:
        if self._h is None:
            return False
        r = self._lib.ocvt_ff_writer_close(self._h)
        self._h = None
        return bool(r)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
