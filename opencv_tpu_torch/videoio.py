"""videoio (modules/videoio) — file-based backends.

Camera/device IO is out of scope on TPU hosts; the file surface is
real, in two tiers:

1. From-scratch codecs (first tier): MJPEG-in-AVI both ways (RIFF
   container around this framework's JPEG codec), HuffYUV and FFV1
   lossless compressed payloads (bit-exact wheel interop both
   directions), raw AVI layouts, Y4M, printf-style image sequences.
2. FFmpeg adapter (fallback tier, `videoio_ffmpeg.py`): MP4/H.264,
   HEVC, VP9, MPEG-4 ASP, MKV/WebM and every other payload whose
   bitstream spec is not derivable in-image — the same architectural
   position as the reference's FFmpeg backend (reference:
   modules/videoio/src/cap_ffmpeg.cpp:1).

Twin of ``opencv_tpu/videoio.py``, over the port's ``imgcodecs`` and its
``cvtColor``.  ``VideoCapture.read`` returns host numpy BGR frames, as cv2
does; copying them to a device is the caller's step.  ``VideoWriter.write``
takes a numpy array or a tensor on any device, which is read back once
(``core.arrays.to_host``).
"""

from __future__ import annotations

import glob
import os
import struct

import numpy as np

from .core.arrays import to_host
from .imgcodecs import imread, imwrite, imdecode, imencode

__all__ = ["VideoCapture", "VideoWriter", "VideoWriter_fourcc",
           "CAP_PROP_FRAME_WIDTH", "CAP_PROP_FRAME_HEIGHT",
           "CAP_PROP_FPS", "CAP_PROP_FRAME_COUNT", "CAP_PROP_POS_FRAMES"]

CAP_PROP_POS_FRAMES = 1
CAP_PROP_FRAME_WIDTH = 3
CAP_PROP_FRAME_HEIGHT = 4
CAP_PROP_FPS = 5
CAP_PROP_FOURCC = 6
CAP_PROP_FRAME_COUNT = 7


def VideoWriter_fourcc(*args):
    c = "".join(args)
    return struct.unpack("<I", c.encode())[0]


def _parse_avi(data):
    """Minimal RIFF/AVI walk: returns (frames, fps, size, fourcc,
    extradata) — extradata = strf bytes beyond BITMAPINFOHEADER (codec
    private data; HuffYUV keeps its Huffman tables there)."""
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI ", "not an AVI"
    fps = 25.0
    size = (0, 0)
    frames = []
    fourcc = [b""]
    extradata = [b""]

    def walk(pos, end):
        nonlocal fps, size
        while pos + 8 <= end:
            ckid = data[pos:pos + 4]
            cksz = struct.unpack("<I", data[pos + 4:pos + 8])[0]
            body = pos + 8
            if ckid == b"LIST":
                walk(body + 4, body + cksz)
            elif ckid == b"avih":
                usec = struct.unpack("<I", data[body:body + 4])[0]
                if usec:
                    fps = 1e6 / usec
                w, h = struct.unpack("<II", data[body + 32:body + 40])
                size = (w, h)
            elif ckid == b"strf" and cksz >= 20 and not fourcc[0]:
                fourcc[0] = data[body + 16:body + 20]
                if cksz > 40:
                    extradata[0] = data[body + 40:body + cksz]
            elif ckid[2:4] in (b"dc", b"db"):
                frames.append(data[body:body + cksz])
            pos = body + cksz + (cksz & 1)

    walk(12, len(data))
    return frames, fps, size, fourcc[0], extradata[0]


def _raw_frame_to_bgr(buf, size, fourcc):
    """Decode an uncompressed AVI payload (videoio raw fourccs).

    Returns None for unknown fourccs AND for truncated payloads — the
    caller turns that into (False, None), matching the reference's
    corrupt-frame behavior (cv2 never raises from read()).
    """
    from .ops.color import cvtColor
    from . import constants as K
    w, h = size
    a = np.frombuffer(buf, np.uint8)
    fc = fourcc.decode("latin-1", "replace").strip("\x00 ").upper()
    if fc in ("I420", "IYUV", "YV12"):
        if len(a) < w * h * 3 // 2:
            return None
        yuv = a[:w * h * 3 // 2].reshape(h * 3 // 2, w)
        code = K.COLOR_YUV2BGR_I420 if fc != "YV12" \
            else K.COLOR_YUV2BGR_YV12
        return to_host(cvtColor(yuv, code))
    if fc in ("Y800", "GREY", "Y8"):
        if len(a) < w * h:
            return None
        g = a[:w * h].reshape(h, w)
        return np.stack([g] * 3, axis=-1)
    if fc == "RGBA":
        if len(a) < w * h * 4:
            return None
        rgba = a[:w * h * 4].reshape(h, w, 4)
        return rgba[:, :, [2, 1, 0]].copy()
    if fc in ("RGB", "\x00\x00\x00\x00", "DIB", ""):
        # Uncompressed DIB frames (BI_RGB, positive biHeight) are
        # bottom-up rows of BGR triplets — flip vertically, keep order.
        if len(a) >= w * h * 3:
            bgr = a[:w * h * 3].reshape(h, w, 3)
            return bgr[::-1].copy()
    return None


# container extensions always routed to the FFmpeg adapter tier
_FF_EXTS = (".mp4", ".m4v", ".mov", ".mkv", ".webm", ".mpg", ".mpeg",
            ".m2v", ".ts", ".wmv", ".flv", ".3gp", ".ogv", ".h264",
            ".264", ".h265", ".265", ".hevc", ".ivf", ".asf", ".vob")

# AVI payloads the from-scratch tier decodes itself
_NATIVE_AVI_FCCS = ("MJPG", "JPEG", "MJPA", "HFYU", "FFV1", "I420",
                    "IYUV", "YV12", "Y800", "GREY", "Y8", "RGBA", "RGB",
                    "DIB", "", "\x00\x00\x00\x00")


class _NativeMp4Reader:
    """MP4 + mp4v through the from-scratch stack: Mp4Demuxer (container)
    + Mpeg4Decoder (ISO 14496-2 SP payload, imgcodecs/mpeg4.py).  BGR
    conversion goes through the same swscale step the FFmpeg tier uses
    (bit-exact vs the wheel at 8-aligned widths), with the in-house
    I420 cvtColor as the last-resort fallback."""

    def __init__(self, path):
        from .imgcodecs.mp4 import Mp4Demuxer
        from .imgcodecs.mpeg4 import Mpeg4Decoder
        with open(path, "rb") as f:
            self._data = f.read()
        d = Mp4Demuxer(self._data)
        if not d.samples or not d.width:
            raise ValueError("no decodable mp4v track")
        self._demux = d
        self._dec = Mpeg4Decoder(d.extradata, d.width, d.height)  # may raise
        self.width, self.height = d.width, d.height
        self.fps = d.fps
        self.frame_count = len(d.samples)
        self.fourcc = struct.unpack("<I", b"mp4v")[0]
        self._pos = 0

    def _to_bgr(self, i420):
        w, h = self.width, self.height
        flat = np.ascontiguousarray(i420).reshape(-1)
        y = np.ascontiguousarray(flat[:h * w].reshape(h, w))
        cn = (h // 2) * (w // 2)
        u = np.ascontiguousarray(flat[h * w:h * w + cn]
                                 .reshape(h // 2, w // 2))
        v = np.ascontiguousarray(flat[h * w + cn:].reshape(h // 2, w // 2))
        try:
            from . import videoio_ffmpeg as _ffio
            lib = _ffio._get_lib()
        except Exception:
            lib = None
        if lib is not None:
            import ctypes
            if not hasattr(lib, "_sws_sig"):
                lib.ocvt_sws_yuv420p_to_bgr.restype = ctypes.c_int
                lib.ocvt_sws_yuv420p_to_bgr.argtypes = \
                    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
                    + [ctypes.c_void_p]
                lib._sws_sig = True
            bgr = np.empty((h, w, 3), np.uint8)
            if lib.ocvt_sws_yuv420p_to_bgr(
                    y.ctypes.data_as(ctypes.c_void_p),
                    u.ctypes.data_as(ctypes.c_void_p),
                    v.ctypes.data_as(ctypes.c_void_p), w, h,
                    bgr.ctypes.data_as(ctypes.c_void_p)):
                return bgr
        from .ops.color import cvtColor
        from . import constants as K
        return to_host(cvtColor(i420, K.COLOR_YUV2BGR_I420))

    def read(self):
        if self._pos >= len(self._demux.samples):
            return False, None
        off, sz = self._demux.samples[self._pos]
        i420 = self._dec.decode(self._data[off:off + sz])
        self._pos += 1
        if i420 is None:
            return False, None
        return True, self._to_bgr(i420)

    def grab(self):
        # decode is still required (P-frames chain off every sample)
        ok, _ = self.read()
        return ok

    def seek(self, frame_idx):
        frame_idx = int(frame_idx)
        if frame_idx < self._pos:
            # restart from the first sample (keyframe) and roll forward
            from .imgcodecs.mpeg4 import Mpeg4Decoder
            self._dec = Mpeg4Decoder(self._demux.extradata,
                                     self.width, self.height)
            self._pos = 0
        while self._pos < frame_idx:
            off, sz = self._demux.samples[self._pos]
            self._dec.decode(self._data[off:off + sz])
            self._pos += 1
        return True

    def tell(self):
        return self._pos

    def close(self):
        pass


class VideoCapture:
    def __init__(self, source=None, apiPreference=0):
        self._frames = None
        self._files = None
        self._ff = None
        self._ff_frame = None
        self._pos = 0
        self._fps = 25.0
        self._size = (0, 0)
        self._opened = False
        if source is not None:
            self.open(source)

    def _open_ffmpeg(self, path):
        from . import videoio_ffmpeg as _ffio
        if not _ffio.available():
            return False
        rd = _ffio.FFmpegReader(path)
        if not rd.ok:
            return False
        self._path_for_ff = path
        self._ff = rd
        self._frames = None
        self._files = None
        self._fps = rd.fps
        self._size = (rd.width, rd.height)
        self._opened = True
        return True

    def open(self, source, apiPreference=0):
        self._pos = 0
        self._ff = None
        self._ff_frame = None
        if isinstance(source, (int, np.integer)):
            return False  # no camera devices in this environment
        s = str(source)
        if s.lower().endswith(".y4m") and os.path.exists(s):
            with open(s, "rb") as f:
                data = f.read()
            self._frames, self._fps, self._size = _parse_y4m(data)
            self._files = None
            self._y4m = True
            self._opened = self._frames is not None
            return self._opened
        if s.lower().endswith(_FF_EXTS) and os.path.exists(s):
            if s.lower().endswith((".mp4", ".m4v", ".mov")) \
                    and os.environ.get("OPENCV_TPU_MP4_NATIVE", "1") != "0":
                try:
                    rd = _NativeMp4Reader(s)
                except Exception:
                    rd = None   # not mp4v / outside SP subset -> adapter
                if rd is not None:
                    self._path_for_ff = s
                    self._ff = rd
                    self._frames = self._files = None
                    self._fps = rd.fps
                    self._size = (rd.width, rd.height)
                    self._opened = True
                    return True
            if self._open_ffmpeg(s):
                return True
            self._opened = False
            return False
        if s.lower().endswith(".avi") and os.path.exists(s):
            with open(s, "rb") as f:
                data = f.read()
            try:
                (self._frames, self._fps, self._size,
                 self._fourcc, self._extradata) = _parse_avi(data)
            except Exception:
                return self._open_ffmpeg(s)
            fcs = self._fourcc.decode("latin-1", "replace") \
                .strip("\x00 ").upper()
            if fcs not in _NATIVE_AVI_FCCS:
                # compressed payload outside the from-scratch tier
                # (XVID, H264-in-AVI, ...) -> adapter
                if self._open_ffmpeg(s):
                    return True
            self._files = None
            self._opened = True
            return True
        if "%" in s:  # printf-style image sequence
            files = []
            i = 0
            # find the first existing index (0 or 1 based)
            for start in (0, 1):
                if os.path.exists(s % start):
                    i = start
                    break
            while os.path.exists(s % i):
                files.append(s % i)
                i += 1
            self._files = files
            self._opened = bool(files)
            return self._opened
        if os.path.exists(s):
            self._files = [s]
            self._opened = True
            return True
        matches = sorted(glob.glob(s))
        self._files = matches
        self._opened = bool(matches)
        return self._opened

    def isOpened(self):
        return self._opened

    def _switch_to_adapter(self):
        """Mid-stream failover: the native mp4v decoder hit a feature
        outside its SP subset — reopen through the FFmpeg adapter and
        roll forward to the same position."""
        pos = self._ff.tell() if self._ff is not None else 0
        path = getattr(self, "_path_for_ff", None)
        if path is None:
            return False
        from . import videoio_ffmpeg as _ffio
        if not _ffio.available():
            return False
        rd = _ffio.FFmpegReader(path)
        if not rd.ok:
            return False
        rd.seek(pos)
        self._ff = rd
        return True

    def grab(self):
        if self._ff is not None:
            try:
                ok, fr = self._ff.read()
            except Exception:
                if isinstance(self._ff, _NativeMp4Reader) \
                        and self._switch_to_adapter():
                    ok, fr = self._ff.read()
                else:
                    ok, fr = False, None
            self._ff_frame = fr if ok else None
            return ok
        n = len(self._frames if self._frames is not None else self._files)
        if self._pos < n:
            self._pos += 1
            return True
        return False

    def retrieve(self):
        if self._ff is not None:
            if self._ff_frame is None:
                return False, None
            return True, self._ff_frame
        pos = self._pos - 1
        if getattr(self, "_y4m", False):
            img = _y4m_to_bgr(self._frames[pos], self._size)
            return True, img
        if self._frames is not None:
            fc = getattr(self, "_fourcc", b"")
            fcs = fc.decode("latin-1", "replace").strip("\x00 ").upper()
            if fcs == "HFYU":
                from .imgcodecs import huffyuv as _hf
                w, h = self._size
                res = _hf.decode_frame(self._frames[pos], w, h,
                                       getattr(self, "_extradata", b""))
                if res is None:
                    return False, None
                if isinstance(res, tuple):
                    return True, _hf.yuv422_to_bgr(*res)
                return True, res
            if fcs == "FFV1":
                from .imgcodecs import ffv1 as _ff
                if getattr(self, "_ffv1_dec", None) is None:
                    w, h = self._size
                    self._ffv1_dec = _ff.FFV1Decoder(
                        getattr(self, "_extradata", b""), w, h)
                try:
                    return True, self._ffv1_dec.decode(self._frames[pos])
                except ValueError:
                    return False, None
            if fcs not in ("MJPG", "JPEG", "MJPA"):
                # raw layouts, incl. empty fourcc = uncompressed DIB
                img = _raw_frame_to_bgr(self._frames[pos], self._size,
                                        fc)
                if img is not None:
                    return True, img
                if fcs:  # known-raw fourcc, truncated/bad payload
                    return False, None
                # empty fourcc and not a plausible DIB: try imdecode
            try:
                img = imdecode(np.frombuffer(self._frames[pos], np.uint8),
                               1)
            except Exception:
                img = None
        else:
            img = imread(self._files[pos])
        return img is not None, img

    def read(self):
        if not self.grab():
            return False, None
        return self.retrieve()

    def get(self, prop):
        if prop == CAP_PROP_FPS:
            return self._fps
        if prop == CAP_PROP_FRAME_COUNT:
            if self._ff is not None:
                return float(self._ff.frame_count)
            return float(len(self._frames if self._frames is not None
                             else self._files or []))
        if prop == CAP_PROP_POS_FRAMES:
            if self._ff is not None:
                return float(self._ff.tell())
            return float(self._pos)
        if prop == CAP_PROP_FRAME_WIDTH:
            return float(self._size[0])
        if prop == CAP_PROP_FRAME_HEIGHT:
            return float(self._size[1])
        if prop == CAP_PROP_FOURCC:
            if self._ff is not None:
                return float(self._ff.fourcc)
            fc = getattr(self, "_fourcc", b"")
            if fc:
                return float(struct.unpack("<I", fc[:4].ljust(4, b"\x00"))[0])
        return 0.0

    def set(self, prop, value):
        if prop == CAP_PROP_POS_FRAMES:
            if self._ff is not None:
                return self._ff.seek(int(value))
            self._pos = int(value)
            return True
        return False

    def release(self):
        self._opened = False
        if self._ff is not None:
            self._ff.close()
            self._ff = None
            self._ff_frame = None


class VideoWriter:
    def __init__(self, filename=None, fourcc=0, fps=25.0, frameSize=(0, 0),
                 isColor=True):
        self._frames = []
        self._path = None
        self._fps = fps
        self._size = frameSize
        self._seq = False
        self._opened = False
        if filename:
            self.open(filename, fourcc, fps, frameSize, isColor)

    def open(self, filename, fourcc, fps, frameSize, isColor=True):
        self._path = str(filename)
        self._fps = float(fps) if fps else 25.0
        self._size = tuple(int(v) for v in frameSize)
        self._seq = "%" in self._path
        self._y4m = self._path.lower().endswith(".y4m")
        self._frames = []
        self._count = 0
        self._ffw = None
        fc = b"MJPG"
        fourcc_int = 0
        if isinstance(fourcc, (int, np.integer)) and fourcc > 0:
            fourcc_int = int(fourcc)
            fc = bytes([fourcc & 0xFF, (fourcc >> 8) & 0xFF,
                        (fourcc >> 16) & 0xFF, (fourcc >> 24) & 0xFF])
        self._fcc = fc.decode("latin-1").upper()
        native = self._fcc in ("MJPG", "I420", "IYUV", "YV12", "Y800",
                               "RGBA", "HFYU", "FFV1")
        ext = os.path.splitext(self._path)[1].lower()
        if not self._seq and not self._y4m \
                and (ext != ".avi" or not native):
            # non-AVI container, or a payload outside the from-scratch
            # tier (mp4v/avc1/XVID/VP90/...) -> FFmpeg adapter
            from . import videoio_ffmpeg as _ffio
            if _ffio.available():
                w, h = self._size
                wr = _ffio.FFmpegWriter(self._path, fourcc_int,
                                        self._fps, w, h)
                if wr.ok:
                    self._ffw = wr
                    self._opened = True
                    return True
            if ext != ".avi":
                self._opened = False
                return False
        if not native:
            self._fcc = "MJPG"
        self._opened = True
        return True

    def isOpened(self):
        return self._opened

    def write(self, frame):
        a = to_host(frame)
        if getattr(self, "_ffw", None) is not None:
            self._ffw.write(a)
            return
        if self._seq:
            imwrite(self._path % self._count, a)
            self._count += 1
            return
        if self._y4m:
            self._frames.append(_bgr_to_y4m_frame(a))
            return
        fcc = getattr(self, "_fcc", "MJPG")
        if fcc in ("I420", "IYUV", "YV12"):
            from .ops.color import cvtColor
            from . import constants as K
            if a.ndim == 2:
                a = np.stack([a] * 3, -1)
            code = K.COLOR_BGR2YUV_I420 if fcc != "YV12" \
                else K.COLOR_BGR2YUV_YV12
            yuv = to_host(cvtColor(a, code))
            self._frames.append(yuv.tobytes())
            return
        if fcc == "Y800":
            if a.ndim == 2:
                g = a
            else:  # BT.601 luma, same weights as the reference writer
                from .ops.color import cvtColor
                from . import constants as K
                g = to_host(cvtColor(a, K.COLOR_BGR2GRAY))
            self._frames.append(g.tobytes())
            return
        if fcc == "RGBA":
            if a.ndim == 2:
                a = np.stack([a] * 3, -1)
            rgba = np.dstack([a[:, :, 2], a[:, :, 1], a[:, :, 0],
                              np.full(a.shape[:2], 255, np.uint8)])
            self._frames.append(rgba.tobytes())
            return
        if fcc == "HFYU":
            from .imgcodecs import huffyuv as _hf
            self._frames.append(_hf.encode_frame_bgr(a))
            return
        if fcc == "FFV1":
            from .imgcodecs import ffv1 as _ff
            if a.ndim == 2:
                a = np.stack([a] * 3, -1)
            if getattr(self, "_ffv1_enc", None) is None:
                w, h = self._size
                self._ffv1_enc = _ff.FFV1Encoder(w, h)
            self._frames.append(self._ffv1_enc.encode(a))
            return
        ok, buf = imencode(".jpg", a, [1, 95])
        self._frames.append(bytes(buf))

    def release(self):
        if not self._opened:
            return
        self._opened = False
        if getattr(self, "_ffw", None) is not None:
            self._ffw.close()
            self._ffw = None
            return
        if self._seq or not self._frames:
            return
        if self._y4m:
            w, h = self._size
            num = int(round(self._fps * 1000))
            hdr = ("YUV4MPEG2 W%d H%d F%d:1000 Ip A1:1 C420mpeg2\n"
                   % (w, h, num)).encode()
            with open(self._path, "wb") as fo:
                fo.write(hdr)
                for fr in self._frames:
                    fo.write(b"FRAME\n")
                    fo.write(fr)
            return
        w, h = self._size
        fps = self._fps

        def chunk(ckid, body):
            pad = b"\x00" if len(body) & 1 else b""
            return ckid + struct.pack("<I", len(body)) + body + pad

        n = len(self._frames)
        maxbuf = max(len(f) for f in self._frames)
        avih = struct.pack("<14I", int(1e6 / fps), 0, 0, 0x10, n, 0, 1,
                           maxbuf, w, h, 0, 0, 0, 0)
        fcc = getattr(self, "_fcc", "MJPG").encode("latin-1")
        bits = {b"I420": 12, b"IYUV": 12, b"YV12": 12, b"Y800": 8,
                b"RGBA": 32}.get(fcc, 24)
        extradata = b""
        if fcc == b"HFYU":
            from .imgcodecs import huffyuv as _hf
            extradata = _hf.build_extradata(24)
        elif fcc == b"FFV1":
            enc = getattr(self, "_ffv1_enc", None)
            if enc is not None:
                extradata = enc.extradata
            else:
                from .imgcodecs import ffv1 as _ff
                extradata = _ff.build_extradata()
        strh = b"vids" + fcc + struct.pack(
            "<IHHIIIIIIIII", 0, 0, 0, 0, 1, int(fps), 0, n, maxbuf,
            0xFFFFFFFF, 0, 0) + struct.pack("<4H", 0, 0, w, h)
        strf = struct.pack("<IiiHH4sIiiII", 40 + len(extradata), w, h,
                           1, bits, fcc, w * h * bits // 8,
                           0, 0, 0, 0) + extradata
        strl = b"LIST" + struct.pack(
            "<I", 4 + len(chunk(b"strh", strh)) + len(chunk(b"strf", strf))
        ) + b"strl" + chunk(b"strh", strh) + chunk(b"strf", strf)
        hdrl_body = b"hdrl" + chunk(b"avih", avih) + strl
        hdrl = b"LIST" + struct.pack("<I", len(hdrl_body)) + hdrl_body

        movi_items = b"".join(chunk(b"00dc", f) for f in self._frames)
        movi = b"LIST" + struct.pack("<I", 4 + len(movi_items)) + b"movi" \
            + movi_items

        # idx1
        idx = b""
        off = 4
        for f in self._frames:
            idx += b"00dc" + struct.pack("<III", 0x10, off, len(f))
            off += 8 + len(f) + (len(f) & 1)
        idx1 = chunk(b"idx1", idx)

        body = b"AVI " + hdrl + movi + idx1
        with open(self._path, "wb") as fo:
            fo.write(b"RIFF" + struct.pack("<I", len(body)) + body)


# ---------------------------------------------------------------------------
# Y4M (YUV4MPEG2) — uncompressed 4:2:0 interchange (cap_images/cap_mjpeg
# analogue; the reference reads these via its FFmpeg backend)
# ---------------------------------------------------------------------------

def _parse_y4m(data):
    """Parse a YUV4MPEG2 stream -> (list of raw I420 frame bytes, fps,
    (w, h)).  Only C420 family colorspaces are supported."""
    nl = data.find(b"\n")
    if nl < 0 or not data.startswith(b"YUV4MPEG2"):
        return None, 25.0, (0, 0)
    w = h = 0
    fps = 25.0
    for tok in data[:nl].split()[1:]:
        t, v = tok[:1], tok[1:]
        if t == b"W":
            w = int(v)
        elif t == b"H":
            h = int(v)
        elif t == b"F":
            num, den = v.split(b":")
            fps = int(num) / int(den)
        elif t == b"C" and not v.startswith(b"420"):
            return None, fps, (w, h)
    fsz = w * h * 3 // 2
    frames = []
    pos = nl + 1
    while pos < len(data):
        fnl = data.find(b"\n", pos)
        if fnl < 0 or not data[pos:pos + 5] == b"FRAME":
            break
        body = fnl + 1
        if body + fsz > len(data):
            break
        frames.append(data[body:body + fsz])
        pos = body + fsz
    return frames, fps, (w, h)


def _y4m_to_bgr(raw, size):
    from .ops.color import cvtColor
    from . import constants as K
    w, h = size
    yuv = np.frombuffer(raw, np.uint8).reshape(h * 3 // 2, w)
    return to_host(cvtColor(yuv, K.COLOR_YUV2BGR_I420))


def _bgr_to_y4m_frame(frame):
    from .ops.color import cvtColor
    from . import constants as K
    if frame.ndim == 2:
        frame = np.repeat(frame[:, :, None], 3, axis=2)
    i420 = to_host(cvtColor(frame, K.COLOR_BGR2YUV_I420))
    return i420.tobytes()
