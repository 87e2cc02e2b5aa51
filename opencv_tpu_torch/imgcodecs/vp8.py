"""Lossy VP8 (WebP "VP8 " chunk) key-frame decoder — RFC 6386 semantics,
bit-exact with the reference's libwebp path (imgcodecs/src/grfmt_webp.cpp):
same boolean coder, token trees, dequant, intra predictors, loop filter,
fancy chroma upsampler and fixed-point YUV→BGR conversion.

Host/device split: the arithmetic entropy decode is inherently
sequential host work (like the JPEG Huffman tail); reconstruction per
macroblock is numpy; the final upsample+color-convert is vectorized over
the whole image.  Normative probability/quantizer tables live in
`vp8_tables.npz` (snapshotted constants, the Annex-K precedent).

Twin of ``opencv_tpu/imgcodecs/vp8.py``.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["vp8_decode"]

_T = None


def _tables():
    global _T
    if _T is None:
        _T = np.load(os.path.join(os.path.dirname(__file__),
                                  "vp8_tables.npz"))
    return _T


# ------------------------------------------------------------- bool coder

class _BoolDec:
    """RFC 6386 §7.3 boolean decoder (16-bit value window)."""

    __slots__ = ("data", "pos", "range", "value", "bit_count")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 2
        self.range = 255
        b0 = data[0] if len(data) > 0 else 0
        b1 = data[1] if len(data) > 1 else 0
        self.value = (b0 << 8) | b1
        self.bit_count = 0

    def bool_(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        SPLIT = split << 8
        if self.value >= SPLIT:
            bit = 1
            self.range -= split
            self.value -= SPLIT
        else:
            bit = 0
            self.range = split
        while self.range < 128:
            self.value <<= 1
            self.range <<= 1
            self.bit_count += 1
            if self.bit_count == 8:
                self.bit_count = 0
                nb = self.data[self.pos] if self.pos < len(self.data) else 0
                self.value |= nb
                self.pos += 1
        return bit

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bool_(128)
        return v

    def signed(self, n: int) -> int:
        v = self.literal(n)
        return -v if self.bool_(128) else v


# ----------------------------------------------------------- misc tables

_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CAT3456 = ((173, 148, 140), (176, 155, 140, 135),
            (180, 157, 141, 134, 130),
            (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))

_DC, _TM, _VE, _HE = 0, 1, 2, 3
_B_PRED = 10
(_B_DC, _B_TM, _B_VE, _B_HE, _B_RD, _B_VR, _B_LD, _B_VL, _B_HD,
 _B_HU) = range(10)


def _clip(a):
    return np.clip(a, 0, 255)


# -------------------------------------------------------------- transforms

_C1, _C2 = 20091, 35468


def _mul1(a):
    return ((a * _C1) >> 16) + a


def _mul2(a):
    return (a * _C2) >> 16


def _idct_add(coef, dst):
    """libwebp TransformOne: columns then rows, >>3 with +4 rounder,
    ADDS into dst (int arrays)."""
    i = coef.astype(np.int64).reshape(4, 4)
    # vertical pass (over columns of the coefficient matrix layout)
    a = i[0] + i[2]
    b = i[0] - i[2]
    c = _mul2(i[1]) - _mul1(i[3])
    d = _mul1(i[1]) + _mul2(i[3])
    t = np.stack([a + d, b + c, b - c, a - d])   # (4 rows, 4 cols)
    # horizontal pass
    dc = t[:, 0] + 4
    a = dc + t[:, 2]
    b = dc - t[:, 2]
    c = _mul2(t[:, 1]) - _mul1(t[:, 3])
    d = _mul1(t[:, 1]) + _mul2(t[:, 3])
    out = np.stack([a + d, b + c, b - c, a - d], axis=1) >> 3
    dst[:, :] = _clip(dst + out)


def _iwht(coef):
    """libwebp TransformWHT → 16 DC values in raster order (4,4)."""
    i = coef.astype(np.int64).reshape(4, 4)
    a0 = i[0] + i[3]
    a1 = i[1] + i[2]
    a2 = i[1] - i[2]
    a3 = i[0] - i[3]
    t = np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2])
    dc = t[:, 0] + 3
    a0 = dc + t[:, 3]
    a1 = t[:, 1] + t[:, 2]
    a2 = t[:, 1] - t[:, 2]
    a3 = dc - t[:, 3]
    out = np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], axis=1) >> 3
    return out


# -------------------------------------------------------------- predictors

def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _pred4(dst, top, topright, left, topleft, mode):
    """4x4 predictors (dsp/dec.c); top/left are int arrays, returns (4,4)."""
    t = np.concatenate([top, topright]).astype(np.int64)  # 8 entries
    l = left.astype(np.int64)
    x = int(topleft)
    o = np.zeros((4, 4), np.int64)
    if mode == _B_DC:
        o[:, :] = (int(t[:4].sum() + l.sum()) + 4) >> 3
    elif mode == _B_TM:
        o[:, :] = _clip(l[:, None] + t[None, :4] - x)
    elif mode == _B_VE:
        vals = [_avg3(x, t[0], t[1]), _avg3(t[0], t[1], t[2]),
                _avg3(t[1], t[2], t[3]), _avg3(t[2], t[3], t[4])]
        o[:, :] = np.asarray(vals)[None, :]
    elif mode == _B_HE:
        A, B, C, D, E = x, l[0], l[1], l[2], l[3]
        o[0, :] = _avg3(A, B, C)
        o[1, :] = _avg3(B, C, D)
        o[2, :] = _avg3(C, D, E)
        o[3, :] = _avg3(D, E, E)
    elif mode == _B_RD:
        I, J, K, L = l
        A, B, C, D = t[0], t[1], t[2], t[3]
        X = x
        o[3, 0] = _avg3(J, K, L)
        o[3, 1] = o[2, 0] = _avg3(I, J, K)
        o[3, 2] = o[2, 1] = o[1, 0] = _avg3(X, I, J)
        o[3, 3] = o[2, 2] = o[1, 1] = o[0, 0] = _avg3(A, X, I)
        o[2, 3] = o[1, 2] = o[0, 1] = _avg3(B, A, X)
        o[1, 3] = o[0, 2] = _avg3(C, B, A)
        o[0, 3] = _avg3(D, C, B)
    elif mode == _B_LD:
        A, B, C, D, E, F, G, H = t
        o[0, 0] = _avg3(A, B, C)
        o[0, 1] = o[1, 0] = _avg3(B, C, D)
        o[0, 2] = o[1, 1] = o[2, 0] = _avg3(C, D, E)
        o[0, 3] = o[1, 2] = o[2, 1] = o[3, 0] = _avg3(D, E, F)
        o[1, 3] = o[2, 2] = o[3, 1] = _avg3(E, F, G)
        o[2, 3] = o[3, 2] = _avg3(F, G, H)
        o[3, 3] = _avg3(G, H, H)
    elif mode == _B_VR:
        I, J, K = l[0], l[1], l[2]
        X = x
        A, B, C, D = t[0], t[1], t[2], t[3]
        o[0, 0] = o[2, 1] = _avg2(X, A)
        o[0, 1] = o[2, 2] = _avg2(A, B)
        o[0, 2] = o[2, 3] = _avg2(B, C)
        o[0, 3] = _avg2(C, D)
        o[3, 0] = _avg3(K, J, I)
        o[2, 0] = _avg3(J, I, X)
        o[1, 0] = o[3, 1] = _avg3(I, X, A)
        o[1, 1] = o[3, 2] = _avg3(X, A, B)
        o[1, 2] = o[3, 3] = _avg3(A, B, C)
        o[1, 3] = _avg3(B, C, D)
    elif mode == _B_VL:
        A, B, C, D, E, F, G, H = t
        o[0, 0] = _avg2(A, B)
        o[0, 1] = o[2, 0] = _avg2(B, C)
        o[0, 2] = o[2, 1] = _avg2(C, D)
        o[0, 3] = o[2, 2] = _avg2(D, E)
        o[1, 0] = _avg3(A, B, C)
        o[1, 1] = o[3, 0] = _avg3(B, C, D)
        o[1, 2] = o[3, 1] = _avg3(C, D, E)
        o[1, 3] = o[3, 2] = _avg3(D, E, F)
        o[2, 3] = _avg3(E, F, G)
        o[3, 3] = _avg3(F, G, H)
    elif mode == _B_HD:
        I, J, K, L = l
        X = x
        A, B, C = t[0], t[1], t[2]
        o[0, 0] = o[1, 2] = _avg2(I, X)
        o[1, 0] = o[2, 2] = _avg2(J, I)
        o[2, 0] = o[3, 2] = _avg2(K, J)
        o[3, 0] = _avg2(L, K)
        o[0, 3] = _avg3(A, B, C)
        o[0, 2] = _avg3(X, A, B)
        o[0, 1] = o[1, 3] = _avg3(I, X, A)
        o[1, 1] = o[2, 3] = _avg3(J, I, X)
        o[2, 1] = o[3, 3] = _avg3(K, J, I)
        o[3, 1] = _avg3(L, K, J)
    elif mode == _B_HU:
        I, J, K, L = l
        o[0, 0] = _avg2(I, J)
        o[1, 0] = o[0, 2] = _avg2(J, K)
        o[1, 2] = o[2, 0] = _avg2(K, L)
        o[0, 1] = _avg3(I, J, K)
        o[1, 1] = o[0, 3] = _avg3(J, K, L)
        o[2, 1] = o[1, 3] = _avg3(K, L, L)
        o[2, 2] = o[2, 3] = o[3, 0] = o[3, 1] = o[3, 2] = o[3, 3] = L
    else:
        raise ValueError(mode)
    return o


def _pred_big(plane, y0, x0, size, mode, have_top, have_left):
    """16x16 / 8x8 whole-block predictors with border-availability
    variants (CheckMode)."""
    n = size
    top = plane[y0 - 1, x0:x0 + n].astype(np.int64) if y0 > 0 \
        else np.full(n, 127, np.int64)
    left = plane[y0:y0 + n, x0 - 1].astype(np.int64) if x0 > 0 \
        else np.full(n, 129, np.int64)
    tl = int(plane[y0 - 1, x0 - 1]) if (y0 > 0 and x0 > 0) else \
        (129 if y0 > 0 else 127)
    if mode == _DC:
        if have_top and have_left:
            dc = (int(top.sum() + left.sum()) + n) >> (
                5 if n == 16 else 4)
        elif have_left:
            dc = (int(left.sum()) + (n >> 1)) >> (4 if n == 16 else 3)
        elif have_top:
            dc = (int(top.sum()) + (n >> 1)) >> (4 if n == 16 else 3)
        else:
            dc = 0x80
        return np.full((n, n), dc, np.int64)
    if mode == _VE:
        return np.broadcast_to(top, (n, n)).copy()
    if mode == _HE:
        return np.broadcast_to(left[:, None], (n, n)).copy()
    if mode == _TM:
        return _clip(left[:, None] + top[None, :] - tl)
    raise ValueError(mode)


# ------------------------------------------------------------- loop filter

def _sclip1(v):
    return np.clip(v, -128, 127)


def _sclip2(v):
    return np.clip(v, -16, 15)


def _do_filter2(p1, p0, q0, q1):
    a = 3 * (q0 - p0) + _sclip1(p1 - q1)
    a1 = _sclip2((a + 4) >> 3)
    a2 = _sclip2((a + 3) >> 3)
    return _clip(p0 + a2), _clip(q0 - a1)


def _do_filter4(p1, p0, q0, q1):
    a = 3 * (q0 - p0)
    a1 = _sclip2((a + 4) >> 3)
    a2 = _sclip2((a + 3) >> 3)
    a3 = (a1 + 1) >> 1
    return (_clip(p1 + a3), _clip(p0 + a2),
            _clip(q0 - a1), _clip(q1 - a3))


def _do_filter6(p2, p1, p0, q0, q1, q2):
    a = _sclip1(3 * (q0 - p0) + _sclip1(p1 - q1))
    a1 = (27 * a + 63) >> 7
    a2 = (18 * a + 63) >> 7
    a3 = (9 * a + 63) >> 7
    return (_clip(p2 + a3), _clip(p1 + a2), _clip(p0 + a1),
            _clip(q0 - a1), _clip(q1 - a2), _clip(q2 - a3))


def _needs_filter(p1, p0, q0, q1, t):
    return (4 * np.abs(p0 - q0) + np.abs(p1 - q1)) <= t


def _needs_filter2(px, t, it):
    p3, p2, p1, p0, q0, q1, q2, q3 = px
    ok = (4 * np.abs(p0 - q0) + np.abs(p1 - q1)) <= t
    for a, b in ((p3, p2), (p2, p1), (p1, p0), (q3, q2), (q2, q1),
                 (q1, q0)):
        ok &= np.abs(a - b) <= it
    return ok


def _hev(p1, p0, q0, q1, thresh):
    return (np.abs(p1 - p0) > thresh) | (np.abs(q1 - q0) > thresh)


def _filter_edge_simple(plane, y0, x0, n, horiz, limit):
    """Simple filter on one edge: 'horiz' means a VERTICAL edge (pixels
    vary horizontally across x0)."""
    t = 2 * limit + 1
    idx = np.arange(n)
    if horiz:
        p1 = plane[y0 + idx, x0 - 2].astype(np.int64)
        p0 = plane[y0 + idx, x0 - 1].astype(np.int64)
        q0 = plane[y0 + idx, x0 + 0].astype(np.int64)
        q1 = plane[y0 + idx, x0 + 1].astype(np.int64)
        m = _needs_filter(p1, p0, q0, q1, t)
        np0, nq0 = _do_filter2(p1, p0, q0, q1)
        plane[y0 + idx, x0 - 1] = np.where(m, np0, p0)
        plane[y0 + idx, x0 + 0] = np.where(m, nq0, q0)
    else:
        p1 = plane[y0 - 2, x0 + idx].astype(np.int64)
        p0 = plane[y0 - 1, x0 + idx].astype(np.int64)
        q0 = plane[y0 + 0, x0 + idx].astype(np.int64)
        q1 = plane[y0 + 1, x0 + idx].astype(np.int64)
        m = _needs_filter(p1, p0, q0, q1, t)
        np0, nq0 = _do_filter2(p1, p0, q0, q1)
        plane[y0 - 1, x0 + idx] = np.where(m, np0, p0)
        plane[y0 + 0, x0 + idx] = np.where(m, nq0, q0)


def _filter_edge_complex(plane, y0, x0, n, horiz, limit, ilevel,
                         hev_t, edge):
    """Complex filter: FilterLoop26 (edge=True) / FilterLoop24."""
    t = 2 * limit + 1
    idx = np.arange(n)
    if horiz:
        px = [plane[y0 + idx, x0 + o].astype(np.int64)
              for o in (-4, -3, -2, -1, 0, 1, 2, 3)]
    else:
        px = [plane[y0 + o, x0 + idx].astype(np.int64)
              for o in (-4, -3, -2, -1, 0, 1, 2, 3)]
    p3, p2, p1, p0, q0, q1, q2, q3 = px
    m = _needs_filter2(px, t, ilevel)
    hv = _hev(p1, p0, q0, q1, hev_t)
    f2 = _do_filter2(p1, p0, q0, q1)
    if edge:
        f6 = _do_filter6(p2, p1, p0, q0, q1, q2)
        outs = {-3: np.where(m & ~hv, f6[0], p2),
                -2: np.where(m & ~hv, f6[1], p1),
                -1: np.where(m, np.where(hv, f2[0], f6[2]), p0),
                0: np.where(m, np.where(hv, f2[1], f6[3]), q0),
                1: np.where(m & ~hv, f6[4], q1),
                2: np.where(m & ~hv, f6[5], q2)}
    else:
        f4 = _do_filter4(p1, p0, q0, q1)
        outs = {-2: np.where(m & ~hv, f4[0], p1),
                -1: np.where(m, np.where(hv, f2[0], f4[1]), p0),
                0: np.where(m, np.where(hv, f2[1], f4[2]), q0),
                1: np.where(m & ~hv, f4[3], q1)}
    for o, v in outs.items():
        if horiz:
            plane[y0 + idx, x0 + o] = v
        else:
            plane[y0 + o, x0 + idx] = v


# ------------------------------------------------------------- YUV -> BGR

def _yuv_to_bgr(Y, U, V):
    """libwebp fixed-point conversion (dsp/yuv.h) with the fancy
    upsampler (dsp/upsampling.c) — vectorized."""
    H, W = Y.shape

    def mult_hi(v, c):
        return (v * c) >> 8

    def clip8(v):
        return np.where((v & ~((256 << 6) - 1)) == 0, v >> 6,
                        np.where(v < 0, 0, 255)).astype(np.uint8)

    # --- fancy chroma upsample to full res ------------------------------
    def upsample(C):
        ch, cw = C.shape
        Cp = np.pad(C.astype(np.int64), 1, mode="edge")
        # nearest chroma row/col is simply y//2 (sample r covers output
        # rows 2r, 2r+1); the second tap is on the other side
        yy = np.arange(H)
        xx = np.arange(W)
        cyn = yy // 2 + 1                       # padded index
        cyf = cyn + np.where(yy % 2 == 1, 1, -1)
        cxn = xx // 2 + 1
        cxf = cxn + np.where(xx % 2 == 1, 1, -1)
        cyn = np.clip(cyn, 0, ch + 1)[:, None]
        cyf = np.clip(cyf, 0, ch + 1)[:, None]
        cxn_r = np.clip(cxn, 0, cw + 1)[None, :]
        cxf_r = np.clip(cxf, 0, cw + 1)[None, :]
        tl = Cp[cyn, cxn_r]      # weight 9 (nearest in both axes)
        tr = Cp[cyn, cxf_r]      # weight 3
        bl = Cp[cyf, cxn_r]      # weight 3
        br = Cp[cyf, cxf_r]      # weight 1
        # UPSAMPLE_FUNC's exact two-step rounding
        avg = tl + tr + bl + br + 8
        diag = (avg + 2 * (tr + bl)) >> 3
        out = (diag + tl) >> 1
        # column edges use the 2-tap (3*near + far + 2) >> 2 form
        ncol = Cp[cyn[:, 0], 1]
        fcol = Cp[cyf[:, 0], 1]
        out[:, 0] = (3 * ncol + fcol + 2) >> 2
        if W % 2 == 0:
            ncol = Cp[cyn[:, 0], cw]
            fcol = Cp[cyf[:, 0], cw]
            out[:, W - 1] = (3 * ncol + fcol + 2) >> 2
        return out

    Uf = upsample(U)
    Vf = upsample(V)
    y = Y.astype(np.int64)
    r = clip8(mult_hi(y, 19077) + mult_hi(Vf, 26149) - 14234)
    g = clip8(mult_hi(y, 19077) - mult_hi(Uf, 6419)
              - mult_hi(Vf, 13320) + 8708)
    b = clip8(mult_hi(y, 19077) + mult_hi(Uf, 33050) - 17685)
    return np.stack([b, g, r], axis=-1)


# --------------------------------------------------------------- decoder

def _get_coeffs(bd, probs, bands_first_ctx, first, ctx, qdc, qac, out):
    """libwebp GetCoeffsFast: returns last-nonzero position + 1."""
    p = probs[_BANDS[first], ctx]
    n = first
    while n < 16:
        if not bd.bool_(p[0]):
            return n
        while not bd.bool_(p[1]):       # zero runs
            n += 1
            if n == 16:
                return 16
            p = probs[_BANDS[n], 0]
        if not bd.bool_(p[2]):
            v = 1
            nctx = 1
        else:
            # large value (GetLargeValue)
            if not bd.bool_(p[3]):
                if not bd.bool_(p[4]):
                    v = 2
                else:
                    v = 3 + bd.bool_(p[5])
            else:
                if not bd.bool_(p[6]):
                    if not bd.bool_(p[7]):
                        v = 5 + bd.bool_(159)
                    else:
                        v = 7 + 2 * bd.bool_(165) + bd.bool_(145)
                else:
                    bit1 = bd.bool_(p[8])
                    bit0 = bd.bool_(p[9 + bit1])
                    cat = 2 * bit1 + bit0
                    v = 0
                    for cp in _CAT3456[cat]:
                        v += v + bd.bool_(cp)
                    v += 3 + (8 << cat)
            nctx = 2
        if bd.bool_(128):
            v = -v
        out[_ZIGZAG[n]] = v * (qdc if n == 0 else qac)
        n += 1
        if n == 16:
            return 16
        p = probs[_BANDS[n], nctx]
    return 16


def vp8_decode(body: bytes):
    T = _tables()
    dc_q = T["dc_q"]
    ac_q = T["ac_q"]
    kb = T["bmode_probs"].astype(np.int32)

    tag = body[0] | (body[1] << 8) | (body[2] << 16)
    if tag & 1:
        raise ValueError("VP8 inter frame in a still image")
    part0_size = tag >> 5
    assert body[3:6] == b"\x9d\x01\x2a", "bad VP8 start code"
    W = (body[6] | (body[7] << 8)) & 0x3FFF
    H = (body[8] | (body[9] << 8)) & 0x3FFF
    bd = _BoolDec(body[10:10 + part0_size])

    bd.literal(1)  # color space
    bd.literal(1)  # clamping

    # segment header
    seg_enabled = bd.bool_(128)
    update_map = False
    seg_abs = False
    seg_qi = [0, 0, 0, 0]
    seg_lf = [0, 0, 0, 0]
    seg_probs = [255, 255, 255]
    if seg_enabled:
        update_map = bool(bd.bool_(128))
        if bd.bool_(128):   # update data
            seg_abs = bool(bd.bool_(128))
            for i in range(4):
                seg_qi[i] = bd.signed(7) if bd.bool_(128) else 0
            for i in range(4):
                seg_lf[i] = bd.signed(6) if bd.bool_(128) else 0
        if update_map:
            seg_probs = [bd.literal(8) if bd.bool_(128) else 255
                         for _ in range(3)]

    # filter header
    lf_simple = bd.bool_(128)
    lf_level = bd.literal(6)
    sharpness = bd.literal(3)
    lf_delta = bd.bool_(128)
    ref_lf_delta = [0, 0, 0, 0]
    mode_lf_delta = [0, 0, 0, 0]
    if lf_delta:
        if bd.bool_(128):
            for i in range(4):
                if bd.bool_(128):
                    ref_lf_delta[i] = bd.signed(6)
            for i in range(4):
                if bd.bool_(128):
                    mode_lf_delta[i] = bd.signed(6)
    filter_type = 0 if lf_level == 0 else (1 if lf_simple else 2)

    # partitions
    nparts = 1 << bd.literal(2)
    rest = body[10 + part0_size:]
    off = 3 * (nparts - 1)
    parts = []
    for i in range(nparts - 1):
        sz = rest[3 * i] | (rest[3 * i + 1] << 8) | (rest[3 * i + 2] << 16)
        parts.append(_BoolDec(rest[off:off + sz]))
        off += sz
    parts.append(_BoolDec(rest[off:]))

    # quantizers
    yac_qi = bd.literal(7)
    dqy1_dc = bd.signed(4) if bd.bool_(128) else 0
    dqy2_dc = bd.signed(4) if bd.bool_(128) else 0
    dqy2_ac = bd.signed(4) if bd.bool_(128) else 0
    dquv_dc = bd.signed(4) if bd.bool_(128) else 0
    dquv_ac = bd.signed(4) if bd.bool_(128) else 0

    def quant_for(seg):
        if seg_enabled:
            q = seg_qi[seg] if seg_abs else yac_qi + seg_qi[seg]
        else:
            q = yac_qi
        q = int(np.clip(q, 0, 127))
        y1dc = int(dc_q[int(np.clip(q + dqy1_dc, 0, 127))])
        y1ac = int(ac_q[q])
        y2dc = int(dc_q[int(np.clip(q + dqy2_dc, 0, 127))]) * 2
        y2ac = (int(ac_q[int(np.clip(q + dqy2_ac, 0, 127))]) * 101581) >> 16
        y2ac = max(y2ac, 8)
        uvdc = int(dc_q[int(np.clip(q + dquv_dc, 0, 117))])
        uvac = int(ac_q[int(np.clip(q + dquv_ac, 0, 127))])
        return y1dc, y1ac, y2dc, y2ac, uvdc, uvac

    bd.bool_(128)  # refresh entropy probs (ignored for stills)

    coef_probs = T["coef_probs"].astype(np.int32)
    upd = T["coef_update"]
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    if bd.bool_(int(upd[t, b, c, p])):
                        coef_probs[t, b, c, p] = bd.literal(8)

    use_skip = bd.bool_(128)
    skip_p = bd.literal(8) if use_skip else 0

    mb_w = (W + 15) // 16
    mb_h = (H + 15) // 16

    # ---- pass 1: intra modes for every MB (partition 0, row by row)
    mb_seg = np.zeros((mb_h, mb_w), np.int32)
    mb_skip = np.zeros((mb_h, mb_w), np.int32)
    mb_i4 = np.zeros((mb_h, mb_w), bool)
    mb_uv = np.zeros((mb_h, mb_w), np.int32)
    mb_y16 = np.zeros((mb_h, mb_w), np.int32)
    mb_bmodes = np.zeros((mb_h, mb_w, 4, 4), np.int32)

    top_modes = np.full((mb_w, 4), _B_DC, np.int32)
    for my in range(mb_h):
        left_modes = np.full(4, _B_DC, np.int32)
        for mx in range(mb_w):
            if seg_enabled and update_map:
                if not bd.bool_(seg_probs[0]):
                    seg = bd.bool_(seg_probs[1])
                else:
                    seg = bd.bool_(seg_probs[2]) + 2
            else:
                seg = 0
            mb_seg[my, mx] = seg
            if use_skip:
                mb_skip[my, mx] = bd.bool_(skip_p)
            is_i4 = not bd.bool_(145)
            mb_i4[my, mx] = is_i4
            if not is_i4:
                ymode = (_TM if bd.bool_(128) else _HE) if bd.bool_(156) \
                    else (_VE if bd.bool_(163) else _DC)
                mb_y16[my, mx] = ymode
                top_modes[mx, :] = ymode
                left_modes[:] = ymode
            else:
                for sy in range(4):
                    ym = left_modes[sy]
                    for sx in range(4):
                        pr = kb[top_modes[mx, sx], ym]
                        if not bd.bool_(int(pr[0])):
                            m = _B_DC
                        elif not bd.bool_(int(pr[1])):
                            m = _B_TM
                        elif not bd.bool_(int(pr[2])):
                            m = _B_VE
                        elif not bd.bool_(int(pr[3])):
                            if not bd.bool_(int(pr[4])):
                                m = _B_HE
                            elif not bd.bool_(int(pr[5])):
                                m = _B_RD
                            else:
                                m = _B_VR
                        elif not bd.bool_(int(pr[6])):
                            m = _B_LD
                        elif not bd.bool_(int(pr[7])):
                            m = _B_VL
                        elif not bd.bool_(int(pr[8])):
                            m = _B_HD
                        else:
                            m = _B_HU
                        ym = m
                        top_modes[mx, sx] = m
                        mb_bmodes[my, mx, sy, sx] = m
                    left_modes[sy] = ym
            if not bd.bool_(142):
                uvm = _DC
            elif not bd.bool_(114):
                uvm = _VE
            else:
                uvm = _TM if bd.bool_(183) else _HE
            mb_uv[my, mx] = uvm

    # ---- pass 2: residuals (token partitions) + reconstruction
    coeffs_all = np.zeros((mb_h, mb_w, 25, 16), np.int32)
    mb_has_coeff = np.zeros((mb_h, mb_w), bool)
    nzY_all = np.zeros((mb_h, mb_w, 4, 4), bool)   # per 4x4: any coeff
    nzUV_all = np.zeros((mb_h, mb_w, 8), bool)

    top_nz = np.zeros((mb_w, 9), np.int32)   # 4 y, 2 u, 2 v, 1 y2dc
    for my in range(mb_h):
        tp = parts[my % nparts]
        left_nz = np.zeros(9, np.int32)
        for mx in range(mb_w):
            seg = mb_seg[my, mx]
            y1dc, y1ac, y2dc, y2ac, uvdc, uvac = quant_for(seg)
            is_i4 = mb_i4[my, mx]
            skip = mb_skip[my, mx]
            if skip:
                left_nz[:] = 0
                top_nz[mx, :8] = 0
                if not is_i4:
                    top_nz[mx, 8] = left_nz[8] = 0
                continue
            cf = coeffs_all[my, mx]
            probs_y2 = coef_probs[1]
            probs_y = coef_probs[0] if not is_i4 else coef_probs[3]
            probs_uv = coef_probs[2]
            any_nz = False
            if not is_i4:
                ctx = int(top_nz[mx, 8] + left_nz[8])
                dcbuf = np.zeros(16, np.int32)
                nz = _get_coeffs(tp, probs_y2, None, 0, ctx, y2dc, y2ac,
                                 dcbuf)
                top_nz[mx, 8] = left_nz[8] = 1 if nz > 0 else 0
                if nz > 1:
                    dcs = _iwht(dcbuf)
                    for i in range(16):
                        cf[i, 0] = dcs[i // 4, i % 4]
                else:
                    dc0 = (int(dcbuf[0]) + 3) >> 3
                    for i in range(16):
                        cf[i, 0] = dc0
                first = 1
                if nz > 0:
                    any_nz = True
            else:
                first = 0
            for sy in range(4):
                l = int(left_nz[sy])
                for sx in range(4):
                    ctx = l + int(top_nz[mx, sx])
                    nz = _get_coeffs(tp, probs_y, None, first, ctx,
                                     y1dc, y1ac, cf[sy * 4 + sx])
                    l = 1 if nz > first else 0
                    top_nz[mx, sx] = l
                    nzY_all[my, mx, sy, sx] = (nz > first) or \
                        (cf[sy * 4 + sx, 0] != 0)
                    any_nz = any_nz or nz > first
                left_nz[sy] = l
            for base, (o_t, o_l) in ((16, (4, 4)), (20, (6, 6))):
                for sy in range(2):
                    l = int(left_nz[o_l + sy])
                    for sx in range(2):
                        ctx = l + int(top_nz[mx, o_t + sx])
                        nz = _get_coeffs(tp, probs_uv, None, 0, ctx,
                                         uvdc, uvac,
                                         cf[base + sy * 2 + sx])
                        l = 1 if nz > 0 else 0
                        top_nz[mx, o_t + sx] = l
                        nzUV_all[my, mx, base - 16 + sy * 2 + sx] = \
                            nz > 0
                        any_nz = any_nz or nz > 0
                    left_nz[o_l + sy] = l
            mb_has_coeff[my, mx] = any_nz
            if not any_nz and not is_i4:
                pass

    # skipped MBs with i16 mode still carry the Y2 DC convention: a
    # skipped MB has no residual at all (handled above)

    # ---- pass 3: reconstruction (unfiltered; prediction reads the
    # unfiltered plane exactly like libwebp's top/left caches)
    PW, PH = mb_w * 16, mb_h * 16
    Y = np.zeros((PH, PW), np.int64)
    U = np.zeros((PH // 2, PW // 2), np.int64)
    V = np.zeros((PH // 2, PW // 2), np.int64)

    def top_arr(plane, y0, x0, n, avail_w):
        if y0 == 0:
            return np.full(n, 127, np.int64)
        end = min(x0 + n, avail_w)
        t = plane[y0 - 1, x0:end].astype(np.int64)
        if end < x0 + n:
            t = np.concatenate([t, np.full(x0 + n - end, t[-1]
                                           if len(t) else 127)])
        return t

    def left_arr(plane, y0, x0, n):
        if x0 == 0:
            return np.full(n, 129, np.int64)
        return plane[y0:y0 + n, x0 - 1].astype(np.int64)

    for my in range(mb_h):
        for mx in range(mb_w):
            yo, xo = my * 16, mx * 16
            cf = coeffs_all[my, mx]
            is_i4 = mb_i4[my, mx]
            if is_i4:
                # MB-level top-right (4 px right of the MB's top edge)
                if my == 0:
                    mb_tr = np.full(4, 127, np.int64)
                elif mx >= mb_w - 1:
                    mb_tr = np.full(4, int(Y[yo - 1, PW - 1]), np.int64)
                else:
                    mb_tr = Y[yo - 1, xo + 16:xo + 20].astype(np.int64)
                for sy in range(4):
                    for sx in range(4):
                        by, bx = yo + sy * 4, xo + sx * 4
                        if sy == 0:
                            top = top_arr(Y, by, bx, 4, PW)
                        else:
                            top = Y[by - 1, bx:bx + 4].astype(np.int64)
                        if sx == 3:
                            tr = mb_tr if sy == 0 else mb_tr
                            tr = mb_tr
                        elif sy == 0:
                            tr = top_arr(Y, by, bx + 4, 4, PW)
                        else:
                            tr = Y[by - 1, bx + 4:bx + 8].astype(np.int64)
                        left = left_arr(Y, by, bx, 4)
                        if by == 0:
                            tl = 127
                        elif bx == 0:
                            tl = 129
                        else:
                            tl = int(Y[by - 1, bx - 1])
                        blk = _pred4(None, top, tr, left, tl,
                                     mb_bmodes[my, mx, sy, sx])
                        dst = blk
                        c = cf[sy * 4 + sx]
                        if c.any():
                            _idct_add(c, dst)
                        else:
                            dst = _clip(dst)
                        Y[by:by + 4, bx:bx + 4] = dst
            else:
                mode = mb_y16[my, mx]
                pred = _pred_big(Y, yo, xo, 16, mode, my > 0, mx > 0)
                for sy in range(4):
                    for sx in range(4):
                        c = cf[sy * 4 + sx]
                        sub = pred[sy * 4:sy * 4 + 4, sx * 4:sx * 4 + 4]
                        if c.any():
                            _idct_add(c, sub)
                        else:
                            sub[:, :] = _clip(sub)
                Y[yo:yo + 16, xo:xo + 16] = pred
            # chroma
            co, cxo = my * 8, mx * 8
            uvm = mb_uv[my, mx]
            for pl, base in ((U, 16), (V, 20)):
                pred = _pred_big(pl, co, cxo, 8, uvm, my > 0, mx > 0)
                for sy in range(2):
                    for sx in range(2):
                        c = cf[base + sy * 2 + sx]
                        sub = pred[sy * 4:sy * 4 + 4, sx * 4:sx * 4 + 4]
                        if c.any():
                            _idct_add(c, sub)
                        else:
                            sub[:, :] = _clip(sub)
                pl[co:co + 8, cxo:cxo + 8] = pred

    # ---- pass 4: loop filter
    if os.environ.get('OPENCV_TPU_VP8_NOFILTER'):
        filter_type = 0
    if os.environ.get('OPENCV_TPU_VP8_DEBUG'):
        print('lf', filter_type, lf_level, sharpness, 'i4:', mb_i4.astype(int).tolist(), 'y16:', mb_y16.tolist(), 'skip:', mb_skip.tolist(), 'uv:', mb_uv.tolist())
    if filter_type > 0:
        # precompute per-(segment, i4) strengths (frame_dec.c:265)
        strengths = {}
        for s_ in range(4):
            if seg_enabled:
                base = seg_lf[s_] if seg_abs else lf_level + seg_lf[s_]
            else:
                base = lf_level
            for i4 in (0, 1):
                level = base
                if lf_delta:
                    level += ref_lf_delta[0]
                    if i4:
                        level += mode_lf_delta[0]
                level = int(np.clip(level, 0, 63))
                if level > 0:
                    il = level
                    if sharpness > 0:
                        il >>= 2 if sharpness > 4 else 1
                        il = min(il, 9 - sharpness)
                    il = max(il, 1)
                    strengths[(s_, i4)] = (2 * level + il, il,
                                           2 if level >= 40 else
                                           1 if level >= 15 else 0)
                else:
                    strengths[(s_, i4)] = None
        for my in range(mb_h):
            for mx in range(mb_w):
                i4 = bool(mb_i4[my, mx])
                st = strengths[(int(mb_seg[my, mx]), int(i4))]
                if st is None:
                    continue
                limit, il, hev_t = st
                inner = i4 or mb_has_coeff[my, mx]
                yo, xo = my * 16, mx * 16
                co, cxo = my * 8, mx * 8
                if filter_type == 1:     # simple: luma only
                    lim = (limit + 4, limit)
                    if mx > 0:
                        _filter_edge_simple(Y, yo, xo, 16, True, lim[0] - 4 + 4)
                    if inner:
                        for k in (4, 8, 12):
                            _filter_edge_simple(Y, yo, xo + k, 16, True,
                                                limit)
                    if my > 0:
                        _filter_edge_simple(Y, yo, xo, 16, False,
                                            limit + 4)
                    if inner:
                        for k in (4, 8, 12):
                            _filter_edge_simple(Y, yo + k, xo, 16, False,
                                                limit)
                else:                    # complex: luma + chroma
                    if mx > 0:
                        _filter_edge_complex(Y, yo, xo, 16, True,
                                             limit + 4, il, hev_t, True)
                        _filter_edge_complex(U, co, cxo, 8, True,
                                             limit + 4, il, hev_t, True)
                        _filter_edge_complex(V, co, cxo, 8, True,
                                             limit + 4, il, hev_t, True)
                    if inner:
                        for k in (4, 8, 12):
                            _filter_edge_complex(Y, yo, xo + k, 16, True,
                                                 limit, il, hev_t, False)
                        _filter_edge_complex(U, co, cxo + 4, 8, True,
                                             limit, il, hev_t, False)
                        _filter_edge_complex(V, co, cxo + 4, 8, True,
                                             limit, il, hev_t, False)
                    if my > 0:
                        _filter_edge_complex(Y, yo, xo, 16, False,
                                             limit + 4, il, hev_t, True)
                        _filter_edge_complex(U, co, cxo, 8, False,
                                             limit + 4, il, hev_t, True)
                        _filter_edge_complex(V, co, cxo, 8, False,
                                             limit + 4, il, hev_t, True)
                    if inner:
                        for k in (4, 8, 12):
                            _filter_edge_complex(Y, yo + k, xo, 16, False,
                                                 limit, il, hev_t, False)
                        _filter_edge_complex(U, co + 4, cxo, 8, False,
                                             limit, il, hev_t, False)
                        _filter_edge_complex(V, co + 4, cxo, 8, False,
                                             limit, il, hev_t, False)

    y = Y[:H, :W]
    cu = U[:(H + 1) // 2, :(W + 1) // 2]
    cv_ = V[:(H + 1) // 2, :(W + 1) // 2]
    return _yuv_to_bgr(y, cu, cv_)
