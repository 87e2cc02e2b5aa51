"""JPEG 2000 Part-1 decoder (ISO/IEC 15444-1), matching the behavior of
the reference's bundled OpenJPEG (3rdparty/openjpeg/openjp2: j2k.c,
t2.c, t1.c, mqc.c, tgt.c, dwt.c — studied for the normative state
machines; the MQ Qe table and EBCOT context rules are the standard's
normative tables D.1-D.4 / C.2).

Scope (everything the reference wheel's OpenJPEG encoder emits for
.jp2): JP2 container + raw J2K codestreams, single tile, single-layer
packets, default precincts, MQ-coded EBCOT (cblksty 0), reversible 5/3
and irreversible 9/7 wavelets, quantization styles none/derived/
expounded, optional RCT/ICT.  Lossless output is validated bit-exact
against the wheel.

Twin of ``opencv_tpu/imgcodecs/jpeg2000.py``.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["j2k_decode", "jp2_decode", "is_jp2"]

# normative MQ-coder state table (ISO 15444-1 Table C.2)
_MQ_TABLE = [
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0)]

_CTX_UNI = 18
_CTX_AGG = 17


class _MQDecoder:
    """ISO 15444-1 C.3 decoder with opj_mqc's synthetic FF FF tail."""

    __slots__ = ("d", "bp", "c", "a", "ct", "ctx")

    def __init__(self, data: bytes):
        self.d = data + b"\xff\xff"
        self.bp = 0
        self.ctx = [[0, 0] for _ in range(19)]
        self.ctx[_CTX_UNI][0] = 46
        self.ctx[_CTX_AGG][0] = 3
        self.ctx[0][0] = 4
        self.c = (0xFF if len(data) == 0 else self.d[0]) << 16
        self.ct = 0
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def _bytein(self):
        d, bp = self.d, self.bp
        l_c = d[bp + 1]
        if d[bp] == 0xFF:
            if l_c > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp = bp + 1
                self.c += l_c << 9
                self.ct = 7
        else:
            self.bp = bp + 1
            self.c += l_c << 8
            self.ct = 8

    def decode(self, cx: int) -> int:
        st = self.ctx[cx]
        qe, nmps, nlps, switch = _MQ_TABLE[st[0]]
        self.a -= qe
        if (self.c >> 16) < qe:
            if self.a < qe:
                d = st[1]
                st[0] = nmps
            else:
                d = 1 - st[1]
                if switch:
                    st[1] = 1 - st[1]
                st[0] = nlps
            self.a = qe
            while True:
                if self.ct == 0:
                    self._bytein()
                self.a <<= 1
                self.c = (self.c << 1) & 0xFFFFFFFF
                self.ct -= 1
                if self.a & 0x8000:
                    break
        else:
            self.c -= qe << 16
            if (self.a & 0x8000) == 0:
                if self.a < qe:
                    d = 1 - st[1]
                    if switch:
                        st[1] = 1 - st[1]
                    st[0] = nlps
                else:
                    d = st[1]
                    st[0] = nmps
                while True:
                    if self.ct == 0:
                        self._bytein()
                    self.a <<= 1
                    self.c = (self.c << 1) & 0xFFFFFFFF
                    self.ct -= 1
                    if self.a & 0x8000:
                        break
            else:
                d = st[1]
        return d


class _Bio:
    """Packet-header bit reader with FF stuffing (bio.c)."""

    def __init__(self, data: bytes, pos: int):
        self.d = data
        self.bp = pos
        self.buf = 0
        self.ct = 0

    def _bytein(self):
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        if self.bp < len(self.d):
            self.buf |= self.d[self.bp]
            self.bp += 1

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            if self.ct == 0:
                self._bytein()
            self.ct -= 1
            v = (v << 1) | ((self.buf >> self.ct) & 1)
        return v

    def inalign(self) -> int:
        if (self.buf & 0xFF) == 0xFF:
            self._bytein()
        self.ct = 0
        return self.bp


class _TagTree:
    """opj_tgt semantics: node values start 'unknown high'; decode(bio,
    leaf, threshold) refines bounds and returns value < threshold."""

    def __init__(self, w: int, h: int):
        dims = []
        ww, hh = max(w, 1), max(h, 1)
        while True:
            dims.append((ww, hh))
            if ww == 1 and hh == 1:
                break
            ww = (ww + 1) // 2
            hh = (hh + 1) // 2
        self.dims = dims
        big = 999
        self.value = [np.full((hh, ww), big, np.int32)
                      for (ww, hh) in dims]
        self.low = [np.zeros((hh, ww), np.int32) for (ww, hh) in dims]

    def decode(self, bio: _Bio, x: int, y: int, threshold: int) -> int:
        low = 0
        for lvl in range(len(self.dims) - 1, -1, -1):
            yi, xi = y >> lvl, x >> lvl
            if low > self.low[lvl][yi, xi]:
                self.low[lvl][yi, xi] = low
            else:
                low = int(self.low[lvl][yi, xi])
            while low < threshold and low < self.value[lvl][yi, xi]:
                if bio.read(1):
                    self.value[lvl][yi, xi] = low
                else:
                    low += 1
            self.low[lvl][yi, xi] = low
        return 1 if self.value[0][y, x] < threshold else 0

    def leaf_value(self, x, y):
        return int(self.value[0][y, x])


def _getnumpasses(bio: _Bio) -> int:
    if not bio.read(1):
        return 1
    if not bio.read(1):
        return 2
    n = bio.read(2)
    if n != 3:
        return 3 + n
    n = bio.read(5)
    if n != 31:
        return 6 + n
    return 37 + bio.read(7)


# ---------------------------------------------------------------- Tier-1

def _zc_context(sig, y, x, orient):
    h = sig[y, x - 1] + sig[y, x + 1]
    v = sig[y - 1, x] + sig[y + 1, x]
    d = (sig[y - 1, x - 1] + sig[y - 1, x + 1]
         + sig[y + 1, x - 1] + sig[y + 1, x + 1])
    if orient == 1:
        h, v = v, h
    if orient != 3:
        if h == 2:
            return 8
        if h == 1:
            if v >= 1:
                return 7
            return 6 if d >= 1 else 5
        if v == 2:
            return 4
        if v == 1:
            return 3
        return 2 if d >= 2 else (1 if d == 1 else 0)
    hv = h + v
    if d >= 3:
        return 8
    if d == 2:
        return 7 if hv >= 1 else 6
    if d == 1:
        return 5 if hv >= 2 else (4 if hv == 1 else 3)
    return 2 if hv >= 2 else (1 if hv == 1 else 0)


def _sc_context(sig, sgn, y, x):
    h0 = (-1 if sgn[y, x - 1] else 1) if sig[y, x - 1] else 0
    h1 = (-1 if sgn[y, x + 1] else 1) if sig[y, x + 1] else 0
    v0 = (-1 if sgn[y - 1, x] else 1) if sig[y - 1, x] else 0
    v1 = (-1 if sgn[y + 1, x] else 1) if sig[y + 1, x] else 0
    h = max(-1, min(1, h0 + h1))
    v = max(-1, min(1, v0 + v1))
    if h == 1:
        return (13, 0) if v == 1 else ((12, 0) if v == 0 else (11, 0))
    if h == 0:
        return (10, 0) if v == 1 else ((9, 0) if v == 0 else (10, 1))
    return (11, 1) if v == 1 else ((12, 1) if v == 0 else (13, 1))


def _t1_decode(data: bytes, w: int, h: int, numbps: int, orient: int,
               num_passes: int):
    """EBCOT decode of one code-block → int32 values with one
    fractional bit (t1.c: significance writes ±(one|half), refinement
    adds ±half), through the native ``ebcot_t1_decode``;
    :func:`_t1_decode_py` is its plain twin."""
    from ..native import ebcot_t1_decode
    return ebcot_t1_decode(data, w, h, numbps, orient, num_passes)


def _t1_decode_py(data: bytes, w: int, h: int, numbps: int, orient: int,
                  num_passes: int):
    """The plain twin of the native EBCOT decode of one code-block."""
    mq = _MQDecoder(data)
    val = np.zeros((h, w), np.int64)
    sig = np.zeros((h + 2, w + 2), np.uint8)
    sgn = np.zeros((h + 2, w + 2), np.uint8)
    refined = np.zeros((h, w), bool)
    visited = np.zeros((h, w), bool)
    dec = mq.decode

    bpno = numbps
    passtype = 2
    for _p in range(num_passes):
        if bpno < 1:
            break
        one = 1 << bpno
        half = one >> 1
        oneplushalf = one | half
        if passtype == 0:
            for k in range(0, h, 4):
                kend = min(k + 4, h)
                for i in range(w):
                    x = i + 1
                    for j in range(k, kend):
                        y = j + 1
                        if sig[y, x]:
                            continue
                        if not (sig[y - 1, x - 1] or sig[y - 1, x]
                                or sig[y - 1, x + 1] or sig[y, x - 1]
                                or sig[y, x + 1] or sig[y + 1, x - 1]
                                or sig[y + 1, x] or sig[y + 1, x + 1]):
                            continue
                        visited[j, i] = True
                        ctx = _zc_context(sig, y, x, orient)
                        if dec(ctx):
                            sc, xorbit = _sc_context(sig, sgn, y, x)
                            s = dec(sc) ^ xorbit
                            sig[y, x] = 1
                            sgn[y, x] = s
                            val[j, i] = -oneplushalf if s \
                                else oneplushalf
        elif passtype == 1:
            for k in range(0, h, 4):
                kend = min(k + 4, h)
                for i in range(w):
                    x = i + 1
                    for j in range(k, kend):
                        y = j + 1
                        if not sig[y, x] or visited[j, i]:
                            continue
                        if not refined[j, i]:
                            nb = (sig[y - 1, x - 1] + sig[y - 1, x]
                                  + sig[y - 1, x + 1] + sig[y, x - 1]
                                  + sig[y, x + 1] + sig[y + 1, x - 1]
                                  + sig[y + 1, x] + sig[y + 1, x + 1])
                            ctx = 15 if nb > 0 else 14
                        else:
                            ctx = 16
                        v = dec(ctx)
                        neg = val[j, i] < 0
                        val[j, i] += half if (v ^ neg) else -half
                        refined[j, i] = True
        else:
            for k in range(0, h, 4):
                kend = min(k + 4, h)
                for i in range(w):
                    x = i + 1
                    j = k
                    agg = kend - k == 4
                    if agg:
                        for jj in range(k, kend):
                            y = jj + 1
                            if sig[y, x] or visited[jj, i] or \
                                sig[y - 1, x - 1] or sig[y - 1, x] or \
                                sig[y - 1, x + 1] or sig[y, x - 1] or \
                                sig[y, x + 1] or sig[y + 1, x - 1] or \
                                    sig[y + 1, x] or sig[y + 1, x + 1]:
                                agg = False
                                break
                    runlen = 0
                    first_from_agg = False
                    if agg:
                        if not dec(_CTX_AGG):
                            continue
                        runlen = (dec(_CTX_UNI) << 1) | dec(_CTX_UNI)
                        j = k + runlen
                        first_from_agg = True
                    for jj in range(j, kend):
                        y = jj + 1
                        if sig[y, x] or visited[jj, i]:
                            continue
                        if first_from_agg and jj == k + runlen:
                            first_from_agg = False
                            sc, xorbit = _sc_context(sig, sgn, y, x)
                            s = dec(sc) ^ xorbit
                            sig[y, x] = 1
                            sgn[y, x] = s
                            val[jj, i] = -oneplushalf if s \
                                else oneplushalf
                            continue
                        ctx = _zc_context(sig, y, x, orient)
                        if dec(ctx):
                            sc, xorbit = _sc_context(sig, sgn, y, x)
                            s = dec(sc) ^ xorbit
                            sig[y, x] = 1
                            sgn[y, x] = s
                            val[jj, i] = -oneplushalf if s \
                                else oneplushalf
            visited[:] = False
        passtype += 1
        if passtype == 3:
            passtype = 0
            bpno -= 1
    return val


# ------------------------------------------------------------- wavelets

def _lift53(s, d):
    """In-place reversible inverse lifting on last axis halves
    (dwt.c opj_idwt53, cas 0, clamped symmetric extension)."""
    sn = s.shape[-1]
    dn = d.shape[-1]
    if sn == 0 or (sn == 1 and dn == 0):
        return s, d
    dm1 = np.concatenate([d[..., :1], d[..., :max(sn - 1, 0)]], -1)
    di = d[..., :sn] if dn >= sn else \
        np.concatenate([d, d[..., -1:]], -1)[..., :sn]
    s = s - ((dm1[..., :sn] + di + 2) >> 2)
    sp1 = np.concatenate([s[..., 1:], s[..., -1:]], -1)
    d = d + ((s[..., :dn] + sp1[..., :dn]) >> 1)
    return s, d


def _interleave(s, d, n):
    out_shape = list(s.shape)
    out_shape[-1] = n
    out = np.zeros(out_shape, s.dtype)
    out[..., 0::2] = s
    out[..., 1::2] = d
    return out


def _idwt53_level(arr, sn_w, sn_h):
    """arr laid out as [low|high] along both axes; returns spatial."""
    a = arr.astype(np.int64)
    H, W = a.shape
    # horizontal
    s, d = _lift53(a[:, :sn_w].copy(), a[:, sn_w:].copy())
    a = _interleave(s, d, W)
    # vertical
    at = a.T
    s, d = _lift53(at[:, :sn_h].copy(), at[:, sn_h:].copy())
    a = _interleave(s, d, H).T
    return a


_ALPHA = np.float32(-1.586134342)
_BETA = np.float32(-0.052980118)
_GAMMA = np.float32(0.882911075)
_DELTA = np.float32(0.443506852)
_KK = np.float32(1.230174105)
_TWO_INVK = np.float32(1.625732422)


def _lift97(s, d):
    """Inverse 9/7 lifting (dwt.c opj_v8dwt_decode, cas 0, float32,
    two_invK convention compensated in the stepsize)."""
    s = s.astype(np.float32) * _KK
    d = d.astype(np.float32) * _TWO_INVK
    sn = s.shape[-1]
    dn = d.shape[-1]

    def upd_s(s, d, c):
        if sn == 0:
            return s
        m = min(sn, dn)
        dm1 = np.concatenate([d[..., :1], d], -1)
        di = np.concatenate([d, d[..., -1:]], -1)
        out = s.copy()
        out[..., :m] = s[..., :m] + c * (dm1[..., :m] + di[..., :m])
        if m < sn:   # right tail: s[m] += 2c*d[dn-1]
            out[..., m:] = s[..., m:] + 2 * c * d[..., -1:]
        return out

    def upd_d(d, s, c):
        if dn == 0:
            return d
        m = min(dn, sn - 0)
        si = s
        sp1 = np.concatenate([s[..., 1:], s[..., -1:]], -1)
        out = d.copy()
        mm = min(dn, sn)
        out[..., :mm] = d[..., :mm] + c * (si[..., :mm]
                                           + sp1[..., :mm])
        if mm < dn:
            out[..., mm:] = d[..., mm:] + 2 * c * s[..., -1:]
        return out

    s = upd_s(s, d, -_DELTA)
    d = upd_d(d, s, -_GAMMA)
    s = upd_s(s, d, -_BETA)
    d = upd_d(d, s, -_ALPHA)
    return s, d


def _idwt97_level(arr, sn_w, sn_h):
    a = arr.astype(np.float32)
    H, W = a.shape
    s, d = _lift97(a[:, :sn_w], a[:, sn_w:])
    a = _interleave(s, d, W)
    at = a.T
    s, d = _lift97(at[:, :sn_h], at[:, sn_h:])
    a = _interleave(s, d, H).T
    return a


# ------------------------------------------------------------ codestream

def _ceildiv(a, b):
    return (a + b - 1) // b


def _floorlog2(n):
    r = 0
    while n > 1:
        n >>= 1
        r += 1
    return r


def j2k_decode(data: bytes):
    if data[:2] != b"\xff\x4f":
        raise ValueError("not a J2K codestream")
    pos = 2
    siz = cod = qcd = None
    tile_chunks = []
    while pos + 2 <= len(data):
        marker = struct.unpack_from(">H", data, pos)[0]
        if marker == 0xFFD9:
            break
        ln = struct.unpack_from(">H", data, pos + 2)[0]
        body = data[pos + 4:pos + 2 + ln]
        if marker == 0xFF51:
            siz = body
        elif marker == 0xFF52:
            cod = body
        elif marker == 0xFF5C:
            qcd = body
        elif marker == 0xFF90:
            psot = struct.unpack_from(">I", body, 2)[0]
            sod_pos = pos + 2 + ln
            if struct.unpack_from(">H", data, sod_pos)[0] != 0xFF93:
                raise ValueError("missing SOD")
            end = pos + psot if psot else len(data) - 2
            tile_chunks.append(data[sod_pos + 2:end])
            pos = end
            continue
        elif marker in (0xFF53, 0xFF5D, 0xFF5E, 0xFF5F, 0xFF58):
            raise ValueError(f"unsupported marker {marker:#x} "
                             "(per-component overrides)")
        pos += 2 + ln
    if siz is None or cod is None or qcd is None:
        raise ValueError("missing SIZ/COD/QCD")

    (rsiz, xsiz, ysiz, xo, yo, xt, yt, xto, yto,
     ncomp) = struct.unpack_from(">HIIIIIIIIH", siz, 0)
    comps = []
    for c in range(ncomp):
        ssiz, xr, yr = struct.unpack_from(">BBB", siz, 36 + 3 * c)
        comps.append(((ssiz & 0x7F) + 1, bool(ssiz & 0x80), xr, yr))

    scod = cod[0]
    prog = cod[1]
    nlayers = struct.unpack_from(">H", cod, 2)[0]
    mct = cod[4]
    ndecomp = cod[5]
    cbw = 1 << (cod[6] + 2)
    cbh = 1 << (cod[7] + 2)
    cblksty = cod[8]
    transform = cod[9]     # 1 = 5/3 reversible
    if cblksty != 0:
        raise ValueError(f"unsupported code-block style {cblksty:#x}")
    if nlayers != 1:
        raise ValueError("only single-layer codestreams supported")
    if scod & 0x01:
        raise ValueError("explicit precincts not supported")

    sqcd = qcd[0]
    qstyle = sqcd & 0x1F
    guard = sqcd >> 5
    qbody = qcd[1:]

    tile = b"".join(tile_chunks)
    W, H = xsiz - xo, ysiz - yo

    # --- per-component structures
    struct_comps = []
    for cidx in range(ncomp):
        prec, sgnd, xr, yr = comps[cidx]
        cw, ch = _ceildiv(W, xr), _ceildiv(H, yr)
        dims = [(cw, ch)]
        for _ in range(ndecomp):
            dims.append((_ceildiv(dims[-1][0], 2),
                         _ceildiv(dims[-1][1], 2)))
        # bands[r] = list of (orient, bw, bh)
        resos = []
        for r in range(ndecomp + 1):
            fw, fh = dims[ndecomp - r]
            if r == 0:
                resos.append([(0, fw, fh)])
            else:
                lw, lh = dims[ndecomp - r + 1]
                resos.append([(1, fw - lw, lh), (2, lw, fh - lh),
                              (3, fw - lw, fh - lh)])
        struct_comps.append((prec, sgnd, cw, ch, resos))

    # quantization per band (band index: 0 = LL, then HL,LH,HH per res)
    def band_q(cidx, r, orient):
        prec = comps[cidx][0]
        bindex = 0 if r == 0 else 1 + 3 * (r - 1) + (orient - 1)
        if qstyle == 0:
            expn = qbody[bindex] >> 3
            mant = 0
        elif qstyle == 1:
            v = struct.unpack_from(">H", qbody, 0)[0]
            expn = (v >> 11) - (ndecomp - r if r else ndecomp)
            if r > 0:
                expn = (v >> 11) - (ndecomp - r)
            mant = v & 0x7FF
        else:
            v = struct.unpack_from(">H", qbody, 2 * bindex)[0]
            expn = v >> 11
            mant = v & 0x7FF
        numbps = expn + guard - 1
        # decode-side stepsize (tcd.c with BUG_WEIRD_TWO_INVK: gain 0)
        Rb = prec
        step = (1.0 + mant / 2048.0) * (2.0 ** (Rb - expn))
        return numbps, step

    # --- code-block grids + tag trees per (comp, res, band)
    cblks = {}
    trees = {}
    for cidx in range(ncomp):
        _prec, _sgnd, _cw, _ch, resos = struct_comps[cidx]
        for r, bands in enumerate(resos):
            # code-block size within this resolution: for r>0 the
            # effective block is halved against the precinct grid
            ebw = min(cbw, 1 << 14)
            ebh = min(cbh, 1 << 14)
            for orient, bw, bh in bands:
                ngx = max(1, _ceildiv(bw, ebw)) if bw else 0
                ngy = max(1, _ceildiv(bh, ebh)) if bh else 0
                key = (cidx, r, orient)
                blocks = []
                for gy in range(ngy):
                    for gx in range(ngx):
                        x0, y0 = gx * ebw, gy * ebh
                        ww = min(ebw, bw - x0)
                        hh = min(ebh, bh - y0)
                        blocks.append(dict(x=x0, y=y0, w=ww, h=hh,
                                           inc=False, numbps=0,
                                           lblock=3, passes=0,
                                           data=b""))
                cblks[key] = (ngx, ngy, blocks)
                if ngx and ngy:
                    trees[key] = (_TagTree(ngx, ngy),
                                  _TagTree(ngx, ngy))

    # --- packet walk
    if prog == 0:      # LRCP
        order = [(r, c) for r in range(ndecomp + 1)
                 for c in range(ncomp)]
    elif prog == 1:    # RLCP
        order = [(r, c) for r in range(ndecomp + 1)
                 for c in range(ncomp)]
    elif prog == 2:    # RPCL
        order = [(r, c) for r in range(ndecomp + 1)
                 for c in range(ncomp)]
    else:
        raise ValueError(f"unsupported progression {prog}")

    pos = 0
    for (r, cidx) in order:
        bio = _Bio(tile, pos)
        present = bio.read(1)
        bands = struct_comps[cidx][4][r]
        plan = []
        if present:
            for orient, bw, bh in bands:
                key = (cidx, r, orient)
                ngx, ngy, blocks = cblks[key]
                if ngx == 0 or ngy == 0:
                    continue
                incl_t, imsb_t = trees[key]
                nb, _ = band_q(cidx, r, orient)
                for idx, cb in enumerate(blocks):
                    gy, gx = divmod(idx, ngx)
                    if not cb["inc"]:
                        included = incl_t.decode(bio, gx, gy, 1)
                    else:
                        included = bio.read(1)
                    if not included:
                        continue
                    if not cb["inc"]:
                        i = 0
                        while not imsb_t.decode(bio, gx, gy, i):
                            i += 1
                        zbp = imsb_t.leaf_value(gx, gy)
                        cb["numbps"] = nb + 1 - (zbp + 1)
                        cb["inc"] = True
                    numnew = _getnumpasses(bio)
                    while bio.read(1):
                        cb["lblock"] += 1
                    bits = cb["lblock"] + _floorlog2(numnew)
                    ln = bio.read(bits)
                    cb["passes"] += numnew
                    plan.append((cb, ln))
        pos = bio.inalign()
        for cb, ln in plan:
            cb["data"] += tile[pos:pos + ln]
            pos += ln

    # --- Tier-1 + assembly per component
    planes = []
    for cidx in range(ncomp):
        prec, sgnd, cw, ch, resos = struct_comps[cidx]
        reversible = transform == 1
        # decode LL of deepest level
        def band_plane(r, orient, bw, bh):
            nbps, step = band_q(cidx, r, orient)
            out = (np.zeros((bh, bw), np.int64) if reversible
                   else np.zeros((bh, bw), np.float32))
            ngx, ngy, blocks = cblks[(cidx, r, orient)]
            for cb in blocks:
                if not cb["inc"] or cb["passes"] == 0:
                    continue
                v = _t1_decode(cb["data"], cb["w"], cb["h"],
                               cb["numbps"], orient, cb["passes"])
                if reversible:
                    out[cb["y"]:cb["y"] + cb["h"],
                        cb["x"]:cb["x"] + cb["w"]] = \
                        (np.abs(v) // 2) * np.sign(v)
                else:
                    out[cb["y"]:cb["y"] + cb["h"],
                        cb["x"]:cb["x"] + cb["w"]] = \
                        v.astype(np.float32) * np.float32(0.5 * step)
            return out

        cur = band_plane(0, 0, *[d for d in resos[0][0][1:]])
        for r in range(1, ndecomp + 1):
            hl = band_plane(r, 1, resos[r][0][1], resos[r][0][2])
            lh = band_plane(r, 2, resos[r][1][1], resos[r][1][2])
            hh = band_plane(r, 3, resos[r][2][1], resos[r][2][2])
            lw, lhh = cur.shape[1], cur.shape[0]
            top = np.concatenate([cur, hl], axis=1)
            bot = np.concatenate([lh, hh], axis=1)
            arr = np.concatenate([top, bot], axis=0)
            cur = (_idwt53_level(arr, lw, lhh) if reversible
                   else _idwt97_level(arr, lw, lhh))
        planes.append(cur)

    meta = dict(width=W, height=H, ncomp=ncomp,
                prec=[c[0] for c in comps],
                sgnd=[c[1] for c in comps], mct=mct,
                reversible=transform == 1)
    return planes, meta


def is_jp2(data: bytes) -> bool:
    return data[:12] == b"\x00\x00\x00\x0cjP  \r\n\x87\n" \
        or data[:2] == b"\xff\x4f"


def jp2_decode(data: bytes):
    """JP2 container or raw codestream → BGR / gray image."""
    if data[:2] == b"\xff\x4f":
        cs = data
    else:
        cs = None
        pos = 0
        while pos + 8 <= len(data):
            size, typ = struct.unpack_from(">I4s", data, pos)
            if size == 0:
                size = len(data) - pos
            if typ == b"jp2c":
                cs = data[pos + 8:pos + size]
                break
            pos += size
        if cs is None:
            raise ValueError("no jp2c box")
    planes, meta = j2k_decode(cs)
    return _planes_to_image(planes, meta)


def _planes_to_image(planes, meta):
    prec = meta["prec"]
    if meta["mct"] and len(planes) >= 3:
        if meta["reversible"]:
            y, u, v = [p.astype(np.int64) for p in planes[:3]]
            g = y - ((u + v) >> 2)
            r = v + g
            b = u + g
            planes = [r, g, b] + list(planes[3:])
        else:
            y, cb, cr = [p.astype(np.float64) for p in planes[:3]]
            r = y + 1.402 * cr
            g = y - 0.344136 * cb - 0.714136 * cr
            b = y + 1.772 * cb
            planes = [r, g, b] + list(planes[3:])
    out = []
    for c, p in enumerate(planes):
        pr = prec[min(c, len(prec) - 1)]
        v = np.asarray(p)
        if v.dtype.kind == "f":
            v = np.floor(v + 0.5)
        if not meta["sgnd"][min(c, len(prec) - 1)]:
            v = v + (1 << (pr - 1))
        v = np.clip(v, 0, (1 << pr) - 1)
        out.append(v.astype(np.uint16 if pr > 8 else np.uint8))
    if len(out) == 1:
        return out[0]
    if len(out) >= 3:
        return np.stack([out[2], out[1], out[0]], axis=-1)
    return np.stack(out, axis=-1)


# ============================================================== encoder

class _MQEncoder:
    """ISO 15444-1 C.3.3 encoder (opj_mqc encode/byteout/flush)."""

    def __init__(self):
        self.ctx = [[0, 0] for _ in range(19)]
        self.ctx[_CTX_UNI][0] = 46
        self.ctx[_CTX_AGG][0] = 3
        self.ctx[0][0] = 4
        self.a = 0x8000
        self.c = 0
        self.ct = 12
        self.out = bytearray([0])     # fake byte before start

    def _byteout(self):
        o = self.out
        if o[-1] == 0xFF:
            o.append((self.c >> 20) & 0xFF)
            self.c &= 0xFFFFF
            self.ct = 7
        else:
            if (self.c & 0x8000000) == 0:
                o.append((self.c >> 19) & 0xFF)
                self.c &= 0x7FFFF
                self.ct = 8
            else:
                o[-1] += 1
                if o[-1] == 0xFF:
                    self.c &= 0x7FFFFFF
                    o.append((self.c >> 20) & 0xFF)
                    self.c &= 0xFFFFF
                    self.ct = 7
                else:
                    o.append((self.c >> 19) & 0xFF)
                    self.c &= 0x7FFFF
                    self.ct = 8

    def _renorm(self):
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a & 0x8000:
                break

    def encode(self, d: int, cx: int):
        st = self.ctx[cx]
        qe, nmps, nlps, switch = _MQ_TABLE[st[0]]
        if st[1] == d:
            self.a -= qe
            if (self.a & 0x8000) == 0:
                if self.a < qe:
                    self.a = qe
                else:
                    self.c += qe
                st[0] = nmps
                self._renorm()
            else:
                self.c += qe
        else:
            self.a -= qe
            if self.a < qe:
                self.c += qe
            else:
                self.a = qe
            if switch:
                st[1] = 1 - st[1]
            st[0] = nlps
            self._renorm()

    def flush(self) -> bytes:
        # SETBITS
        tempc = self.c + self.a
        self.c |= 0xFFFF
        if self.c >= tempc:
            self.c -= 0x8000
        self.c <<= self.ct
        self._byteout()
        self.c <<= self.ct
        self._byteout()
        out = self.out
        if out[-1] == 0xFF:
            out = out[:-1]
        return bytes(out[1:])     # drop the fake first byte


class _BioW:
    """Packet-header bit writer with FF stuffing (bio.c encode side)."""

    def __init__(self):
        self.out = bytearray()
        self.buf = 0
        self.ct = 8

    def putbit(self, b: int):
        if self.ct == 0:
            self.out.append(self.buf & 0xFF)
            self.ct = 7 if (self.buf & 0xFF) == 0xFF else 8
            self.buf = 0
        self.ct -= 1
        self.buf |= b << self.ct
    def write(self, v: int, n: int):
        for i in range(n - 1, -1, -1):
            self.putbit((v >> i) & 1)

    def flush(self) -> bytes:
        self.out.append(self.buf & 0xFF)
        if self.ct == 0 and (self.buf & 0xFF) == 0xFF:
            self.out.append(0)
        elif (self.buf & 0xFF) == 0xFF:
            self.out.append(0)
        return bytes(self.out)


class _TagTreeEnc:
    def __init__(self, w, h, leaf_values):
        self.dims = []
        ww, hh = max(w, 1), max(h, 1)
        while True:
            self.dims.append((ww, hh))
            if ww == 1 and hh == 1:
                break
            ww, hh = (ww + 1) // 2, (hh + 1) // 2
        self.value = []
        v = np.asarray(leaf_values, np.int32).reshape(h, w)
        for (ww, hh) in self.dims:
            if not self.value:
                self.value.append(v.copy())
                continue
            prev = self.value[-1]
            cur = np.full((hh, ww), 2 ** 30, np.int32)
            for yy in range(prev.shape[0]):
                for xx in range(prev.shape[1]):
                    cur[yy // 2, xx // 2] = min(cur[yy // 2, xx // 2],
                                                prev[yy, xx])
            self.value.append(cur)
        self.low = [np.zeros(a.shape, np.int32) for a in self.value]
        self.known = [np.zeros(a.shape, bool) for a in self.value]

    def encode(self, bio: _BioW, x, y, threshold):
        low = 0
        for lvl in range(len(self.dims) - 1, -1, -1):
            yi, xi = y >> lvl, x >> lvl
            if low > self.low[lvl][yi, xi]:
                self.low[lvl][yi, xi] = low
            else:
                low = int(self.low[lvl][yi, xi])
            while low < threshold:
                if low >= self.value[lvl][yi, xi]:
                    if not self.known[lvl][yi, xi]:
                        bio.putbit(1)
                        self.known[lvl][yi, xi] = True
                    break
                bio.putbit(0)
                low += 1
            self.low[lvl][yi, xi] = low


def _put_numpasses(bio: _BioW, n: int):
    if n == 1:
        bio.putbit(0)
    elif n == 2:
        bio.write(2, 2)
    elif n <= 5:
        bio.write(0xC | (n - 3), 4)
    elif n <= 36:
        bio.write(0x1E0 | (n - 6), 9)
    else:
        bio.write(0xFF80 | (n - 37), 16)


def _t1_encode(v, orient):
    """Encode one code-block (int64 coefficients) → (numbps, data), through
    the native ``ebcot_t1_encode``; :func:`_t1_encode_py` is its plain
    twin."""
    if not np.abs(v).any():
        return 0, b""
    from ..native import ebcot_t1_encode
    return ebcot_t1_encode(v, orient)


def _t1_encode_py(v, orient):
    """The plain twin of the native EBCOT encode of one code-block."""
    h, w = v.shape
    mag = np.abs(v)
    if not mag.any():
        return 0, b""
    numbps = int(mag.max()).bit_length()
    mq = _MQEncoder()
    enc = mq.encode
    sig = np.zeros((h + 2, w + 2), np.uint8)
    sgn = np.zeros((h + 2, w + 2), np.uint8)
    neg = (v < 0).astype(np.uint8)
    refined = np.zeros((h, w), bool)
    visited = np.zeros((h, w), bool)

    def put_sign(y, x, j, i):
        sc, xorbit = _sc_context(sig, sgn, y, x)
        enc(int(neg[j, i]) ^ xorbit, sc)
        sig[y, x] = 1
        sgn[y, x] = neg[j, i]

    passtype = 2
    bpno = numbps - 1
    npasses = 1 + 3 * (numbps - 1)
    for _p in range(npasses):
        if passtype == 0:
            for k in range(0, h, 4):
                kend = min(k + 4, h)
                for i in range(w):
                    x = i + 1
                    for j in range(k, kend):
                        y = j + 1
                        if sig[y, x]:
                            continue
                        if not (sig[y - 1, x - 1] or sig[y - 1, x]
                                or sig[y - 1, x + 1] or sig[y, x - 1]
                                or sig[y, x + 1] or sig[y + 1, x - 1]
                                or sig[y + 1, x] or sig[y + 1, x + 1]):
                            continue
                        visited[j, i] = True
                        bit = int(mag[j, i] >> bpno) & 1
                        enc(bit, _zc_context(sig, y, x, orient))
                        if bit:
                            put_sign(y, x, j, i)
        elif passtype == 1:
            for k in range(0, h, 4):
                kend = min(k + 4, h)
                for i in range(w):
                    x = i + 1
                    for j in range(k, kend):
                        y = j + 1
                        if not sig[y, x] or visited[j, i]:
                            continue
                        if not refined[j, i]:
                            nb = (sig[y - 1, x - 1] + sig[y - 1, x]
                                  + sig[y - 1, x + 1] + sig[y, x - 1]
                                  + sig[y, x + 1] + sig[y + 1, x - 1]
                                  + sig[y + 1, x] + sig[y + 1, x + 1])
                            ctx = 15 if nb > 0 else 14
                        else:
                            ctx = 16
                        enc(int(mag[j, i] >> bpno) & 1, ctx)
                        refined[j, i] = True
        else:
            for k in range(0, h, 4):
                kend = min(k + 4, h)
                for i in range(w):
                    x = i + 1
                    j = k
                    agg = kend - k == 4
                    if agg:
                        for jj in range(k, kend):
                            y = jj + 1
                            if sig[y, x] or visited[jj, i] or \
                                sig[y - 1, x - 1] or sig[y - 1, x] or \
                                sig[y - 1, x + 1] or sig[y, x - 1] or \
                                sig[y, x + 1] or sig[y + 1, x - 1] or \
                                    sig[y + 1, x] or sig[y + 1, x + 1]:
                                agg = False
                                break
                    start = k
                    if agg:
                        runlen = -1
                        for jj in range(k, kend):
                            if (mag[jj, i] >> bpno) & 1:
                                runlen = jj - k
                                break
                        if runlen < 0:
                            enc(0, _CTX_AGG)
                            continue
                        enc(1, _CTX_AGG)
                        enc((runlen >> 1) & 1, _CTX_UNI)
                        enc(runlen & 1, _CTX_UNI)
                        jj = k + runlen
                        put_sign(jj + 1, x, jj, i)
                        start = jj + 1
                    for jj in range(start, kend):
                        y = jj + 1
                        if sig[y, x] or visited[jj, i]:
                            continue
                        bit = int(mag[jj, i] >> bpno) & 1
                        enc(bit, _zc_context(sig, y, x, orient))
                        if bit:
                            put_sign(y, x, jj, i)
            visited[:] = False
        passtype += 1
        if passtype == 3:
            passtype = 0
            bpno -= 1
    return numbps, mq.flush()


def _fwd53(x):
    """Forward reversible 5/3 on last axis → (s, d)."""
    n = x.shape[-1]
    sn = (n + 1) // 2
    s0 = x[..., 0::2].astype(np.int64)
    d0 = x[..., 1::2].astype(np.int64)
    dn = d0.shape[-1]
    s_ext = np.concatenate([s0, s0[..., -1:]], -1)
    d = d0 - ((s_ext[..., :dn] + s_ext[..., 1:dn + 1]) >> 1)
    dm1 = np.concatenate([d[..., :1], d], -1)
    di = np.concatenate([d, d[..., -1:] if dn else
                         np.zeros_like(s0[..., :1])], -1)
    s = s0 + ((dm1[..., :sn] + di[..., :sn] + 2) >> 2)
    return s, d


def jp2_encode(img, lossless: bool = True) -> bytes:
    """Encode BGR/gray uint8 (or uint16) → .jp2 (reversible 5/3,
    single tile/layer, no MCT — decodable by the reference wheel)."""
    a = np.asarray(img)
    if a.ndim == 2:
        planes = [a.astype(np.int64)]
    else:
        planes = [a[..., 2].astype(np.int64), a[..., 1].astype(np.int64),
                  a[..., 0].astype(np.int64)]   # RGB order
    prec = 16 if a.dtype == np.uint16 else 8
    H, W = a.shape[:2]
    ncomp = len(planes)
    ndecomp = max(0, min(5, min(W, H).bit_length() - 3))
    guard = 2

    # forward DWT per component → band dict
    comp_bands = []
    for p in planes:
        x = p - (1 << (prec - 1))
        cur = x
        bands = {}
        dims = []
        for r in range(ndecomp):
            hgt, wdt = cur.shape
            # vertical first (inverse does horizontal last)
            s, d = _fwd53(cur.T)
            cur2 = np.concatenate([s, d], axis=-1).T
            lo_h = (hgt + 1) // 2
            s, d = _fwd53(cur2)
            cur2 = np.concatenate([s, d], axis=-1)
            lo_w = (wdt + 1) // 2
            ll = cur2[:lo_h, :lo_w]
            hl = cur2[:lo_h, lo_w:]
            lh = cur2[lo_h:, :lo_w]
            hh = cur2[lo_h:, lo_w:]
            lvl = ndecomp - r     # resolution index of these bands
            bands[(lvl, 1)] = hl
            bands[(lvl, 2)] = lh
            bands[(lvl, 3)] = hh
            cur = ll
        bands[(0, 0)] = cur
        comp_bands.append(bands)

    gain = {0: 0, 1: 1, 2: 1, 3: 2}
    cbw = cbh = 64

    # encode all code-blocks
    enc_blocks = {}
    for cidx in range(ncomp):
        for (r, orient), band in comp_bands[cidx].items():
            bh, bw = band.shape
            band_numbps = (prec + gain[orient]) + guard - 1
            ngx = max(1, _ceildiv(bw, cbw)) if bw else 0
            ngy = max(1, _ceildiv(bh, cbh)) if bh else 0
            blocks = []
            for gy in range(ngy):
                for gx in range(ngx):
                    sub = band[gy * cbh:(gy + 1) * cbh,
                               gx * cbw:(gx + 1) * cbw]
                    nb, data = _t1_encode(sub, orient)
                    if nb == 0:
                        blocks.append(None)
                    else:
                        zbp = band_numbps - nb
                        np_total = 1 + 3 * (nb - 1)
                        blocks.append((zbp, np_total, data))
            enc_blocks[(cidx, r, orient)] = (ngx, ngy, blocks)

    # Tier-2 packets (LRCP, 1 layer)
    body = bytearray()
    for r in range(ndecomp + 1):
        bands_r = [(0,)] if r == 0 else [(1,), (2,), (3,)]
        for cidx in range(ncomp):
            bio = _BioW()
            datas = []
            any_data = any(
                b is not None
                for (o,) in bands_r
                for b in enc_blocks[(cidx, r, o)][2])
            bio.putbit(1 if any_data else 0)
            if any_data:
                for (orient,) in bands_r:
                    ngx, ngy, blocks = enc_blocks[(cidx, r, orient)]
                    if ngx == 0 or ngy == 0:
                        continue
                    incl = [0 if b is not None else 1
                            for b in blocks]   # layer of inclusion
                    zbps = [b[0] if b is not None else 0
                            for b in blocks]
                    incl_t = _TagTreeEnc(ngx, ngy, incl)
                    imsb_t = _TagTreeEnc(ngx, ngy, zbps)
                    for idx, b in enumerate(blocks):
                        gy, gx = divmod(idx, ngx)
                        incl_t.encode(bio, gx, gy, 1)
                        if b is None:
                            continue
                        zbp, npas, data = b
                        i = zbp + 1
                        # encode zbp tagtree with growing thresholds
                        for t in range(1, zbp + 2):
                            imsb_t.encode(bio, gx, gy, t)
                        _put_numpasses(bio, npas)
                        lblock = 3
                        bits_needed = max(
                            0, len(data).bit_length()
                            - _floorlog2(npas))
                        while lblock + _floorlog2(npas) < \
                                len(data).bit_length():
                            bio.putbit(1)
                            lblock += 1
                        bio.putbit(0)
                        bio.write(len(data),
                                  lblock + _floorlog2(npas))
                        datas.append(data)
            body += bio.flush()
            for d in datas:
                body += d

    # markers
    def marker(code, payload):
        return struct.pack(">HH", code, len(payload) + 2) + payload

    siz = struct.pack(">HIIIIIIIIH", 0, W, H, 0, 0, W, H, 0, 0, ncomp)
    for _ in range(ncomp):
        siz += struct.pack(">BBB", prec - 1, 1, 1)
    cod = struct.pack(">BBHBBBBBB", 0, 0, 1, 0, ndecomp, 4, 4, 0, 1)
    qcd = bytes([0 | (guard << 5)]) + bytes(
        [((prec + gain[o]) << 3)
         for o in ([0] + [1, 2, 3] * ndecomp)][:1 + 3 * ndecomp])
    cs = b"\xff\x4f" + marker(0xFF51, siz) + marker(0xFF52, cod) \
        + marker(0xFF5C, qcd)
    sot_payload = struct.pack(">HIBB", 0, 0, 0, 1)
    psot = 2 + 2 + len(sot_payload) + 2 + len(body)
    sot_payload = struct.pack(">HIBB", 0, psot, 0, 1)
    cs += marker(0xFF90, sot_payload) + b"\xff\x93" + bytes(body)
    cs += b"\xff\xd9"

    # jp2 wrapper
    def box(typ, payload):
        return struct.pack(">I4s", len(payload) + 8, typ) + payload

    jp = box(b"jP  ", b"\r\n\x87\n")
    ftyp = box(b"ftyp", b"jp2 " + struct.pack(">I", 0) + b"jp2 ")
    ihdr = box(b"ihdr", struct.pack(">IIHBBBB", H, W, ncomp, prec - 1,
                                    7, 0, 0))
    colr = box(b"colr", struct.pack(">BBBI", 1, 0, 0,
                                    16 if ncomp == 3 else 17))
    jp2h = box(b"jp2h", ihdr + colr)
    return jp + ftyp + jp2h + box(b"jp2c", cs)
