"""ISO BMFF (MP4) demuxer — the container side of the reference's
FFmpeg backend path (cap_ffmpeg.cpp).

Walks moov/trak/mdia/minf/stbl, resolves per-sample offsets via
stsc/stsz/stco, pulls the codec extradata (e.g. the MPEG-4 VOL header)
from esds DecoderSpecificInfo, and exposes (offset, size) per sample
plus width/height/fps.

The payload decoder lives in imgcodecs/mpeg4.py (from-scratch ISO
14496-2 Simple-Profile I/P decoder, bit-exact vs the wheel); streams
outside that subset (B-VOPs, MPEG quant, interlace, other codecs) fall
back to the FFmpeg adapter tier (videoio_ffmpeg.py).

Twin of ``opencv_tpu/imgcodecs/mp4.py``.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["Mp4Demuxer"]


# ---------------------------------------------------------------- demux

class Mp4Demuxer:
    def __init__(self, data: bytes):
        self.data = data
        self.width = 0
        self.height = 0
        self.fps = 25.0
        self.extradata = b""
        self.samples = []      # list of (offset, size)
        self._parse()

    def _boxes(self, start, end):
        pos = start
        while pos + 8 <= end:
            size, typ = struct.unpack_from(">I4s", self.data, pos)
            if size == 1:
                size = struct.unpack_from(">Q", self.data, pos + 8)[0]
                hdr = 16
            elif size == 0:
                size = end - pos
                hdr = 8
            else:
                hdr = 8
            if size < hdr or pos + size > end:
                break
            yield typ.decode("latin-1"), pos + hdr, pos + size
            pos += size

    def _parse(self):
        d = self.data
        tracks = []
        for typ, b, e in self._boxes(0, len(d)):
            if typ == "moov":
                for t2, b2, e2 in self._boxes(b, e):
                    if t2 == "trak":
                        tracks.append((b2, e2))
        for tb, te in tracks:
            info = self._parse_trak(tb, te)
            if info is not None:
                (self.width, self.height, self.extradata,
                 self.samples, self.fps) = info
                return

    def _find(self, path, b, e):
        cur = [(b, e)]
        for name in path:
            nxt = []
            for (bb, ee) in cur:
                for t, b2, e2 in self._boxes(bb, ee):
                    if t == name:
                        nxt.append((b2, e2))
            cur = nxt
            if not cur:
                return None
        return cur[0]

    def _parse_trak(self, tb, te):
        d = self.data
        stbl = self._find(["mdia", "minf", "stbl"], tb, te)
        if stbl is None:
            return None
        sb, se = stbl
        stsd = stsz = stco = stsc = stts = None
        co64 = None
        for t, b, e in self._boxes(sb, se):
            if t == "stsd":
                stsd = (b, e)
            elif t == "stsz":
                stsz = (b, e)
            elif t == "stco":
                stco = (b, e)
            elif t == "co64":
                co64 = (b, e)
            elif t == "stsc":
                stsc = (b, e)
            elif t == "stts":
                stts = (b, e)
        if stsd is None or stsz is None or (stco is None
                                            and co64 is None):
            return None
        # stsd: count(4) then sample entries
        b, e = stsd
        n = struct.unpack_from(">I", d, b + 4)[0]
        pos = b + 8
        width = height = 0
        extradata = b""
        is_mp4v = False
        for _ in range(n):
            size, fmt = struct.unpack_from(">I4s", d, pos)
            fmt = fmt.decode("latin-1")
            if fmt in ("mp4v",):
                is_mp4v = True
                width, height = struct.unpack_from(">HH", d, pos + 32)
                # esds inside the visual sample entry (offset 86)
                for t2, b2, e2 in self._boxes(pos + 86, pos + size):
                    if t2 == "esds":
                        extradata = self._parse_esds(b2 + 4, e2)
            pos += size
        if not is_mp4v:
            return None
        # stsz
        b, e = stsz
        ssz, cnt = struct.unpack_from(">II", d, b + 4)
        if ssz:
            sizes = [ssz] * cnt
        else:
            sizes = list(struct.unpack_from(">%dI" % cnt, d, b + 12))
        # chunk offsets
        if stco is not None:
            b, e = stco
            cn = struct.unpack_from(">I", d, b + 4)[0]
            offs = list(struct.unpack_from(">%dI" % cn, d, b + 8))
        else:
            b, e = co64
            cn = struct.unpack_from(">I", d, b + 4)[0]
            offs = list(struct.unpack_from(">%dQ" % cn, d, b + 8))
        # stsc: sample-to-chunk runs
        b, e = stsc
        rn = struct.unpack_from(">I", d, b + 4)[0]
        runs = [struct.unpack_from(">III", d, b + 8 + 12 * i)
                for i in range(rn)]
        samples = []
        si = 0
        for ri, (first, per, _desc) in enumerate(runs):
            last = runs[ri + 1][0] - 1 if ri + 1 < len(runs) \
                else len(offs)
            for ci in range(first - 1, last):
                off = offs[ci]
                for _ in range(per):
                    if si >= len(sizes):
                        break
                    samples.append((off, sizes[si]))
                    off += sizes[si]
                    si += 1
        # fps from stts + mdhd timescale
        fps = 25.0
        mdhd = self._find(["mdia", "mdhd"], tb, te)
        if mdhd is not None and stts is not None:
            mb, _me = mdhd
            ver = d[mb]
            timescale = struct.unpack_from(
                ">I", d, mb + (20 if ver else 12))[0]
            sb2, _se2 = stts
            if struct.unpack_from(">I", d, sb2 + 4)[0] >= 1:
                _cnt, delta = struct.unpack_from(">II", d, sb2 + 8)
                if delta:
                    fps = timescale / delta
        return width, height, extradata, samples, fps

    def _parse_esds(self, b, e):
        """Walk the ES descriptor to DecoderSpecificInfo (tag 5)."""
        d = self.data
        pos = b

        def read_len(p):
            ln = 0
            for _ in range(4):
                c = d[p]
                p += 1
                ln = (ln << 7) | (c & 0x7F)
                if not (c & 0x80):
                    break
            return ln, p

        while pos < e:
            tag = d[pos]
            ln, p2 = read_len(pos + 1)
            if tag == 0x03:        # ES_Descriptor: skip 3 bytes of ids
                pos = p2 + 3
            elif tag == 0x04:      # DecoderConfig: skip 13 bytes
                pos = p2 + 13
            elif tag == 0x05:      # DecoderSpecificInfo = VOL header
                return d[p2:p2 + ln]
            else:
                pos = p2 + ln
        return b""


# ------------------------------------------------------------ bitstream

class _Bits:
    def __init__(self, data: bytes):
        self.d = data
        self.pos = 0        # bit position

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.d[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def peek(self, n: int) -> int:
        save = self.pos
        try:
            v = self.read(n)
        except IndexError:
            # pad with zeros at the end
            v = 0
            rem = len(self.d) * 8 - save
            if rem > 0:
                self.pos = save
                v = self.read(rem) << (n - rem)
        self.pos = save
        return v

    def skip(self, n: int):
        self.pos += n

    def bits_left(self) -> int:
        return len(self.d) * 8 - self.pos

    def bytealign(self):
        self.pos = (self.pos + 7) & ~7
