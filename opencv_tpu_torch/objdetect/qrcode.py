"""QR code detection + decoding (objdetect/src/qrcode.cpp); twin of
``opencv_tpu/objdetect/qrcode.py``.

Detection finds finder patterns as concentric square contours
(7:5:3 area nesting), orients the code by the right-angle corner, and
unprojects the module grid; decoding implements the QR standard:
format-info BCH matching, mask removal, zigzag codeword read,
block de-interleaving per the version table (qr_tables.json, extracted
from the reference's encoder tables), Reed-Solomon correction over
GF(2^8)/0x11D, and numeric/alphanumeric/byte segment parsing.

On a tensor image the gray conversion and the binarisations (Otsu, then
the 51x51 adaptive mean, whose box takes the plain route at k = 51 in
both packages) run on its device; each binary plane and the gray plane are
read back once, and the contours, the sampling and the decoding are host
numpy, as in the JAX package.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .. import constants as K
from ..core.arrays import as_tensor, to_host
from ..ops.color import cvtColor
from ..ops.thresh import threshold, adaptiveThreshold
from ..ops.contours import findContours, contourArea, minAreaRect, boxPoints
from ..ops.warp import getPerspectiveTransform

__all__ = ["QRCodeDetector"]

_TABLES = None


def _tables():
    global _TABLES
    if _TABLES is None:
        path = os.path.join(os.path.dirname(__file__), "qr_tables.json")
        _TABLES = json.load(open(path))
    return _TABLES


# ------------------------------------------------------------ GF(256) RS

_GF_EXP = np.zeros(512, np.int32)
_GF_LOG = np.zeros(256, np.int32)
_x = 1
for _i in range(255):
    _GF_EXP[_i] = _x
    _GF_LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= 0x11D
for _i in range(255, 512):
    _GF_EXP[_i] = _GF_EXP[_i - 255]


def _gf_mul(a, b):
    if a == 0 or b == 0:
        return 0
    return int(_GF_EXP[_GF_LOG[a] + _GF_LOG[b]])


def _rs_correct(codeword, necc):
    """Reed-Solomon error correction; returns corrected data or None."""
    n = len(codeword)
    msg = list(codeword)
    # syndromes
    synd = []
    for i in range(necc):
        s = 0
        for c in msg:
            s = _gf_mul(s, _GF_EXP[i]) ^ c
        synd.append(s)
    if max(synd) == 0:
        return msg[:n - necc]
    # Berlekamp-Massey
    err_loc = [1]
    old_loc = [1]
    for i in range(necc):
        old_loc.append(0)
        delta = synd[i]
        for j in range(1, len(err_loc)):
            delta ^= _gf_mul(err_loc[len(err_loc) - 1 - j], synd[i - j])
        if delta != 0:
            if len(old_loc) > len(err_loc):
                new_loc = [_gf_mul(c, delta) for c in old_loc]
                inv = _GF_EXP[255 - _GF_LOG[delta]]
                old_loc = [_gf_mul(c, inv) for c in err_loc]
                err_loc = new_loc
            add = [_gf_mul(c, delta) for c in old_loc]
            err_loc = [0] * (len(add) - len(err_loc)) + err_loc
            err_loc = [a ^ b for a, b in zip(err_loc, add)]
    errs = len(err_loc) - 1
    if errs * 2 > necc:
        return None
    # Chien search
    err_pos = []
    for i in range(n):
        x_inv = _GF_EXP[255 - _GF_LOG[_GF_EXP[i]]] if i else 1
        val = 0
        for j, c in enumerate(reversed(err_loc)):
            val ^= _gf_mul(c, _GF_EXP[(j * i) % 255])
        if val == 0:
            err_pos.append(n - 1 - i)
    if len(err_pos) != errs:
        return None
    # Forney
    synd_poly = list(reversed(synd))
    err_eval = [0] * (len(synd) + len(err_loc))
    # omega = synd * err_loc mod x^necc
    full = [0] * (len(synd) + len(err_loc) - 1)
    rsynd = synd[:]  # synd[i] corresponds to x^i
    for i, s in enumerate(rsynd):
        for j, c in enumerate(reversed(err_loc)):
            full[i + j] ^= _gf_mul(s, c)
    omega = full[:necc]
    for pos in err_pos:
        xi = _GF_EXP[(n - 1 - pos) % 255]
        xi_inv = _GF_EXP[255 - _GF_LOG[xi]]
        # error evaluator at xi_inv
        num = 0
        for j, c in enumerate(omega):
            num ^= _gf_mul(c, _GF_EXP[(_GF_LOG[xi_inv] * j) % 255]
                           if xi_inv != 1 else 1) if c else 0
        # formal derivative of err_loc at xi_inv
        loc = list(reversed(err_loc))
        den = 0
        for j in range(1, len(loc), 2):
            den ^= _gf_mul(loc[j], _GF_EXP[(_GF_LOG[xi_inv] * (j - 1))
                                           % 255] if xi_inv != 1 else 1) \
                if loc[j] else 0
        if den == 0:
            return None
        mag = _gf_mul(num, _GF_EXP[255 - _GF_LOG[den]]) if num else 0
        mag = _gf_mul(mag, xi)
        msg[pos] ^= mag
    # verify
    for i in range(necc):
        s = 0
        for c in msg:
            s = _gf_mul(s, _GF_EXP[i]) ^ c
        if s != 0:
            return None
    return msg[:n - necc]


# --------------------------------------------------------------- masks

_MASKS = [
    lambda i, j: (i + j) % 2 == 0,
    lambda i, j: i % 2 == 0,
    lambda i, j: j % 3 == 0,
    lambda i, j: (i + j) % 3 == 0,
    lambda i, j: (i // 2 + j // 3) % 2 == 0,
    lambda i, j: (i * j) % 2 + (i * j) % 3 == 0,
    lambda i, j: ((i * j) % 2 + (i * j) % 3) % 2 == 0,
    lambda i, j: ((i + j) % 2 + (i * j) % 3) % 2 == 0,
]

_ALNUM = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ $%*+-./:"


def _format_candidates():
    """All 32 valid 15-bit format codes -> (ec_index, mask)."""
    out = {}
    # generator 0x537 (BCH 15,5)
    for ec2 in range(4):
        for mask in range(8):
            data = (ec2 << 3) | mask
            v = data << 10
            g = 0x537
            for i in range(14, 9, -1):
                if v & (1 << i):
                    v ^= g << (i - 10)
            code = ((data << 10) | v) ^ 0x5412
            # ec indicator -> table index (L,M,Q,H)
            ecmap = {1: 0, 0: 1, 3: 2, 2: 3}
            out[code] = (ecmap[ec2], mask)
    return out


_FORMATS = _format_candidates()


def _function_mask(n, version):
    """True where modules are function patterns (not data)."""
    m = np.zeros((n, n), bool)
    for (r, c) in [(0, 0), (0, n - 7), (n - 7, 0)]:
        m[max(r - 1, 0):r + 8, max(c - 1, 0):c + 8] = True
    m[6, :] = True
    m[:, 6] = True
    # format info
    m[8, :9] = True
    m[:9, 8] = True
    m[8, n - 8:] = True
    m[n - 8:, 8] = True
    # alignment patterns
    align = _tables()[version]["align"]
    for r in align:
        for c in align:
            if (r < 8 and c < 8) or (r < 8 and c > n - 9) \
                    or (r > n - 9 and c < 8):
                continue
            m[r - 2:r + 3, c - 2:c + 3] = True
    if version >= 7:
        m[:6, n - 11:n - 8] = True
        m[n - 11:n - 8, :6] = True
    return m


def _decode_grid(mods):
    """mods: (n, n) bool (True = dark). Returns decoded text or None."""
    n = mods.shape[0]
    if (n - 17) % 4 != 0:
        return None
    version = (n - 17) // 4
    if not (1 <= version <= 40):
        return None

    # format info (copy A: around TL finder)
    bits = []
    for c in [0, 1, 2, 3, 4, 5, 7, 8]:
        bits.append(mods[8, c])
    for r in [7, 5, 4, 3, 2, 1, 0]:
        bits.append(mods[r, 8])
    code = 0
    for b in bits:
        code = (code << 1) | int(b)
    best = None
    for cand, val in _FORMATS.items():
        d = bin(cand ^ code).count("1")
        if best is None or d < best[0]:
            best = (d, val)
    if best[0] > 3:
        # try copy B
        bits = []
        for r in range(n - 1, n - 8, -1):
            bits.append(mods[r, 8])
        for c in range(n - 8, n):
            bits.append(mods[8, c])
        code = 0
        for b in bits:
            code = (code << 1) | int(b)
        best = None
        for cand, val in _FORMATS.items():
            d = bin(cand ^ code).count("1")
            if best is None or d < best[0]:
                best = (d, val)
        if best[0] > 3:
            return None
    ec_idx, mask_id = best[1]

    fmask = _function_mask(n, version)
    maskf = _MASKS[mask_id]
    ii, jj = np.mgrid[0:n, 0:n]
    mvals = np.vectorize(maskf)(ii, jj)
    data_mods = np.where(fmask, mods, mods ^ mvals)

    # zigzag read
    bits = []
    col = n - 1
    upward = True
    while col > 0:
        if col == 6:
            col -= 1
        rows = range(n - 1, -1, -1) if upward else range(n)
        for r in rows:
            for c in (col, col - 1):
                if not fmask[r, c]:
                    bits.append(int(data_mods[r, c]))
        upward = not upward
        col -= 2

    nbytes = len(bits) // 8
    codewords = []
    for i in range(nbytes):
        v = 0
        for b in bits[8 * i:8 * i + 8]:
            v = (v << 1) | b
        codewords.append(v)

    info = _tables()[version]
    ecc = info["ecc"][ec_idx]
    necc, nb1, dc1, nb2, dc2 = ecc
    nblocks = nb1 + nb2
    total_data = nb1 * dc1 + nb2 * dc2
    if len(codewords) < info["total"]:
        return None
    codewords = codewords[:info["total"]]

    # de-interleave
    blocks = [[] for _ in range(nblocks)]
    sizes = [dc1] * nb1 + [dc2] * nb2
    k = 0
    for i in range(max(sizes)):
        for bidx in range(nblocks):
            if i < sizes[bidx]:
                blocks[bidx].append(codewords[k])
                k += 1
    eccs = [[] for _ in range(nblocks)]
    for i in range(necc):
        for bidx in range(nblocks):
            eccs[bidx].append(codewords[k])
            k += 1

    data = []
    for bidx in range(nblocks):
        corrected = _rs_correct(blocks[bidx] + eccs[bidx], necc)
        if corrected is None:
            return None
        data.extend(corrected)
    assert len(data) == total_data

    # parse segments
    bs = []
    for v in data:
        for i in range(7, -1, -1):
            bs.append((v >> i) & 1)

    def take(k, pos):
        v = 0
        for i in range(k):
            v = (v << 1) | bs[pos + i]
        return v, pos + k

    pos = 0
    out = []
    while pos + 4 <= len(bs):
        mode, pos = take(4, pos)
        if mode == 0:
            break
        if mode == 1:       # numeric
            nlen = 10 if version <= 9 else (12 if version <= 26 else 14)
            cnt, pos = take(nlen, pos)
            while cnt >= 3:
                v, pos = take(10, pos)
                out.append(f"{v:03d}")
                cnt -= 3
            if cnt == 2:
                v, pos = take(7, pos)
                out.append(f"{v:02d}")
            elif cnt == 1:
                v, pos = take(4, pos)
                out.append(str(v))
        elif mode == 2:     # alphanumeric
            nlen = 9 if version <= 9 else (11 if version <= 26 else 13)
            cnt, pos = take(nlen, pos)
            while cnt >= 2:
                v, pos = take(11, pos)
                out.append(_ALNUM[v // 45] + _ALNUM[v % 45])
                cnt -= 2
            if cnt == 1:
                v, pos = take(6, pos)
                out.append(_ALNUM[v])
        elif mode == 4:     # byte
            nlen = 8 if version <= 9 else 16
            cnt, pos = take(nlen, pos)
            raw = bytearray()
            for _ in range(cnt):
                v, pos = take(8, pos)
                raw.append(v)
            out.append(raw.decode("utf-8", errors="replace"))
        elif mode == 7:     # ECI: skip designator
            v, pos = take(8, pos)
        else:
            break
    return "".join(out)


class QRCodeDetector:
    def __init__(self):
        pass

    def _find_finders(self, gray):
        """Finder patterns as >=2 concentric square contours."""
        cands = []
        for attempt in range(2):
            if attempt == 0:
                _, binary = threshold(gray, 0, 255,
                                      K.THRESH_BINARY_INV + K.THRESH_OTSU)
                binary = to_host(binary)
            else:
                binary = to_host(adaptiveThreshold(
                    gray, 255, K.ADAPTIVE_THRESH_MEAN_C,
                    K.THRESH_BINARY_INV, 51, 5))
            contours, _ = findContours(binary, K.RETR_LIST,
                                       K.CHAIN_APPROX_SIMPLE)
            squares = []
            for c in contours:
                pts = np.asarray(c).reshape(-1, 2).astype(np.float32)
                if len(pts) < 4:
                    continue
                area = abs(contourArea(pts))
                if area < 9:
                    continue
                rect = minAreaRect(pts)
                w, h = rect[1]
                if w <= 0 or h <= 0 or max(w, h) > 1.6 * min(w, h):
                    continue
                if not (0.6 * w * h <= area <= 1.15 * w * h):
                    continue
                squares.append((np.array(rect[0]), max(w, h), rect, pts))
            # cluster concentric squares
            used = [False] * len(squares)
            finders = []
            for i in range(len(squares)):
                if used[i]:
                    continue
                group = [i]
                for j in range(i + 1, len(squares)):
                    if used[j]:
                        continue
                    if np.linalg.norm(squares[i][0] - squares[j][0]) \
                            < 0.35 * max(squares[i][1], squares[j][1]):
                        group.append(j)
                if len(group) >= 2:
                    for g in group:
                        used[g] = True
                    big = max(group, key=lambda g: squares[g][1])
                    finders.append(squares[big])
            if len(finders) >= 3:
                return finders
        return finders if len(cands) == 0 else cands

    @staticmethod
    def _gray(img):
        x = as_tensor(img)
        return cvtColor(x, K.COLOR_BGR2GRAY) if x.ndim == 3 else x

    def detect(self, img):
        """Finds the code's quad in `img` (a numpy image or a tensor, whose
        device runs the binarisations)."""
        finders = self._find_finders(self._gray(img))
        if len(finders) < 3:
            return False, None
        # choose the 3 largest
        finders = sorted(finders, key=lambda f: -f[1])[:3]
        centers = [f[0] for f in finders]
        # top-left = corner with ~90 deg between vectors to the others
        best = None
        for i in range(3):
            a = centers[(i + 1) % 3] - centers[i]
            b = centers[(i + 2) % 3] - centers[i]
            cosang = abs(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b))
            if best is None or cosang < best[0]:
                best = (cosang, i)
        tl_i = best[1]
        tl = centers[tl_i]
        o1 = centers[(tl_i + 1) % 3]
        o2 = centers[(tl_i + 2) % 3]
        # right-handed order: TR then BL (cross product sign, y down)
        v1 = o1 - tl
        v2 = o2 - tl
        if v1[0] * v2[1] - v1[1] * v2[0] < 0:
            o1, o2 = o2, o1
        tr, bl = o1, o2
        module = np.mean([f[1] for f in finders]) / 7.0
        d = (np.linalg.norm(tr - tl) + np.linalg.norm(bl - tl)) / 2
        version = max(1, min(40, int(round((d / module - 10) / 4))))
        n = 17 + 4 * version
        # outer quad corners: extend from centers by 3.5 modules
        ex = (tr - tl) / np.linalg.norm(tr - tl)
        ey = (bl - tl) / np.linalg.norm(bl - tl)
        m35 = 3.5 * module
        c_tl = tl - ex * m35 - ey * m35
        c_tr = tr + ex * m35 - ey * m35
        c_bl = bl - ex * m35 + ey * m35
        c_br = tr + bl - tl + ex * m35 + ey * m35
        pts = np.array([c_tl, c_tr, c_br, c_bl], np.float32)
        self._n = n
        return True, pts.reshape(1, 4, 2)

    def _sample(self, gray, quad, n):
        dst = np.array([[0, 0], [n, 0], [n, n], [0, n]], np.float64)
        M = np.asarray(getPerspectiveTransform(
            dst.astype(np.float32), quad.reshape(4, 2).astype(np.float32)))
        js, iis = np.meshgrid(np.arange(n) + 0.5, np.arange(n) + 0.5)
        den = M[2, 0] * js + M[2, 1] * iis + M[2, 2]
        u = (M[0, 0] * js + M[0, 1] * iis + M[0, 2]) / den
        v = (M[1, 0] * js + M[1, 1] * iis + M[1, 2]) / den
        H, W = gray.shape
        ui = np.clip(np.rint(u).astype(int), 0, W - 1)
        vi = np.clip(np.rint(v).astype(int), 0, H - 1)
        vals = gray[vi, ui]
        thr = (int(vals.min()) + int(vals.max())) / 2
        return vals < thr

    def decode(self, img, points):
        gray = to_host(self._gray(img))
        quad = np.asarray(points, np.float64).reshape(4, 2)
        base_n = getattr(self, "_n", 21)
        for n in (base_n, base_n - 4, base_n + 4):
            if n < 21 or (n - 17) % 4:
                continue
            mods = self._sample(gray, quad, n)
            txt = _decode_grid(mods)
            if txt:
                straight = (~mods).astype(np.uint8) * 255
                return txt, straight
        return "", None

    def detectAndDecode(self, img, points=None):
        gray = self._gray(img)
        ok, pts = self.detect(gray)
        if not ok:
            return "", None, None
        txt, straight = self.decode(gray, pts)
        return txt, pts, straight
