"""ArUco fiducial markers (objdetect/src/aruco/); twin of
``opencv_tpu/objdetect/aruco.py``.

The predefined dictionaries are the public marker bit tables extracted
from the reference (aruco_dicts.npz, the port's own copy: [N][4
rotations][nbytes], MSB-first row-major bits — predefined_dictionaries.hpp).
Detection keeps the reference pipeline (adaptive threshold -> quad
candidates -> canonical unwarp -> cell voting -> dictionary identification
with error correction) over the port's primitives.

On a tensor image the dense part runs on its device: the gray conversion
and each window's adaptive threshold (MEAN_C: ``boxFilter`` -> the
``sep_filter_int`` kernel on the card, the k3 template at window 3 and the
box kernel at 13 and 23).  The gray plane and each thresholded plane
are read back once; the contours, quads, unwarping and bit reading are
host numpy, as in the JAX package.  One difference: a candidate quad with
three corners on a line (no homography to unwarp it by) is rejected, where
the JAX package's detectMarkers raises LinAlgError.
"""

from __future__ import annotations

import os

import numpy as np

from .. import constants as K
from ..core.arrays import as_tensor, to_host
from ..ops.color import cvtColor
from ..ops.thresh import adaptiveThreshold
from ..ops.contours import findContours, approxPolyDP, contourArea
from ..ops.warp import getPerspectiveTransform as _gpt

__all__ = ["Dictionary", "DetectorParameters", "ArucoDetector",
           "getPredefinedDictionary", "generateImageMarker",
           "drawDetectedMarkers"]

DICT_4X4_50 = 0
DICT_4X4_100 = 1
DICT_4X4_250 = 2
DICT_4X4_1000 = 3
DICT_5X5_50 = 4
DICT_5X5_100 = 5
DICT_5X5_250 = 6
DICT_5X5_1000 = 7
DICT_6X6_50 = 8
DICT_6X6_100 = 9
DICT_6X6_250 = 10
DICT_6X6_1000 = 11
DICT_7X7_50 = 12
DICT_7X7_100 = 13
DICT_7X7_250 = 14
DICT_7X7_1000 = 15
DICT_ARUCO_ORIGINAL = 16
DICT_APRILTAG_16h5 = 17
DICT_APRILTAG_25h9 = 18
DICT_APRILTAG_36h10 = 19
DICT_APRILTAG_36h11 = 20
DICT_ARUCO_MIP_36h12 = 21

_DICTS = None

# (table name, marker size, count, maxCorrectionBits) per enum — counts
# and corrections from aruco_dictionary.cpp:234-261
_SPECS = {
    DICT_4X4_50: ("DICT_4X4_1000_BYTES", 4, 50, 1),
    DICT_4X4_100: ("DICT_4X4_1000_BYTES", 4, 100, 1),
    DICT_4X4_250: ("DICT_4X4_1000_BYTES", 4, 250, 1),
    DICT_4X4_1000: ("DICT_4X4_1000_BYTES", 4, 1000, 0),
    DICT_5X5_50: ("DICT_5X5_1000_BYTES", 5, 50, 3),
    DICT_5X5_100: ("DICT_5X5_1000_BYTES", 5, 100, 3),
    DICT_5X5_250: ("DICT_5X5_1000_BYTES", 5, 250, 2),
    DICT_5X5_1000: ("DICT_5X5_1000_BYTES", 5, 1000, 2),
    DICT_6X6_50: ("DICT_6X6_1000_BYTES", 6, 50, 6),
    DICT_6X6_100: ("DICT_6X6_1000_BYTES", 6, 100, 5),
    DICT_6X6_250: ("DICT_6X6_1000_BYTES", 6, 250, 5),
    DICT_6X6_1000: ("DICT_6X6_1000_BYTES", 6, 1000, 4),
    DICT_7X7_50: ("DICT_7X7_1000_BYTES", 7, 50, 9),
    DICT_7X7_100: ("DICT_7X7_1000_BYTES", 7, 100, 8),
    DICT_7X7_250: ("DICT_7X7_1000_BYTES", 7, 250, 8),
    DICT_7X7_1000: ("DICT_7X7_1000_BYTES", 7, 1000, 6),
    DICT_ARUCO_ORIGINAL: ("DICT_ARUCO_BYTES", 5, 1024, 0),
    DICT_APRILTAG_16h5: ("DICT_APRILTAG_16h5_BYTES", 4, 30, 0),
    DICT_APRILTAG_25h9: ("DICT_APRILTAG_25h9_BYTES", 5, 35, 0),
    DICT_APRILTAG_36h10: ("DICT_APRILTAG_36h10_BYTES", 6, 2320, 0),
    DICT_APRILTAG_36h11: ("DICT_APRILTAG_36h11_BYTES", 6, 587, 0),
    DICT_ARUCO_MIP_36h12: ("DICT_ARUCO_MIP_36h12_BYTES", 6, 250, 12),
}


def _load_dicts():
    global _DICTS
    if _DICTS is None:
        path = os.path.join(os.path.dirname(__file__), "aruco_dicts.npz")
        _DICTS = dict(np.load(path))
    return _DICTS


def _bytes_to_bits(row_bytes, nbits):
    """Unpack one rotation's byte row to nbits bits: full bytes are
    MSB-first; the tail byte holds its bits LSB-aligned
    (Dictionary::getBitsFromByteList packing)."""
    rem = nbits % 8
    if rem == 0:
        return np.unpackbits(row_bytes)[:nbits]
    head = np.unpackbits(row_bytes[:-1])
    tail = np.unpackbits(row_bytes[-1:])[-rem:]
    return np.concatenate([head, tail])


class Dictionary:
    def __init__(self, bytesList, markerSize, maxCorrectionBits=0):
        # native layout is [N][4 rotations][nbytes]; the cv2-visible
        # bytesList is that same flat buffer viewed as (N, nbytes, 4)
        b = np.asarray(bytesList, np.uint8)
        if b.ndim == 3 and b.shape[2] == 4 and b.shape[1] != 4:
            # cv2-shaped input: reinterpret back to rotation-major
            b = b.reshape(len(b), 4, -1)
        self._raw = b                          # (N, 4, nbytes)
        self.bytesList = b.reshape(len(b), -1, 4) if b.size else b
        self.markerSize = int(markerSize)
        self.maxCorrectionBits = int(maxCorrectionBits)
        n = self.markerSize * self.markerSize
        self._bits = np.stack([
            np.stack([_bytes_to_bits(b[i, r], n) for r in range(4)])
            for i in range(len(b))])          # (N, 4, nbits)

    def getBitsFromByteList(self, byteList=None, markerSize=None):
        b = self.bytesList if byteList is None else np.asarray(byteList)
        ms = self.markerSize if markerSize is None else markerSize
        bits = _bytes_to_bits(b.reshape(-1, b.shape[-1])[0] if b.ndim > 1
                              else b, ms * ms)
        return bits.reshape(ms, ms)

    def identify(self, onlyBits, maxCorrectionRate=0.6):
        """Returns (found, id, rotation)."""
        flat = np.asarray(onlyBits).ravel().astype(np.uint8)
        maxcorr = int(self.maxCorrectionBits * maxCorrectionRate)
        d = np.sum(self._bits != flat[None, None, :], axis=-1)  # (N, 4)
        idx = np.unravel_index(np.argmin(d), d.shape)
        if d[idx] <= maxcorr:
            return True, int(idx[0]), int(idx[1])
        return False, -1, -1


def getPredefinedDictionary(name):
    table, msize, count, corr = _SPECS[name]
    data = _load_dicts()[table][:count]       # (N, 4, nbytes)
    return Dictionary(data, msize, corr)


def generateImageMarker(dictionary, id, sidePixels, borderBits=1):
    ms = dictionary.markerSize
    bits = dictionary._bits[id, 0].reshape(ms, ms)
    total = ms + 2 * borderBits
    canon = np.zeros((total, total), np.uint8)
    canon[borderBits:borderBits + ms, borderBits:borderBits + ms] = \
        bits * 255
    # nearest-neighbor upscale (aruco_dictionary.cpp generateImageMarker)
    idx = (np.arange(sidePixels) * total) // sidePixels
    return canon[np.ix_(idx, idx)]


class DetectorParameters:
    def __init__(self):
        self.adaptiveThreshWinSizeMin = 3
        self.adaptiveThreshWinSizeMax = 23
        self.adaptiveThreshWinSizeStep = 10
        self.adaptiveThreshConstant = 7
        self.minMarkerPerimeterRate = 0.03
        self.maxMarkerPerimeterRate = 4.0
        self.polygonalApproxAccuracyRate = 0.03
        self.minCornerDistanceRate = 0.05
        self.minDistanceToBorder = 3
        self.markerBorderBits = 1
        self.perspectiveRemovePixelPerCell = 4
        self.perspectiveRemoveIgnoredMarginPerCell = 0.13
        self.maxErroneousBitsInBorderRate = 0.35
        self.errorCorrectionRate = 0.6
        self.cornerRefinementMethod = 0


def _order_quad_cw(q):
    """Order 4 points clockwise (image coords) starting top-left-most."""
    c = q.mean(axis=0)
    ang = np.arctan2(q[:, 1] - c[1], q[:, 0] - c[0])
    order = np.argsort(ang)                  # CCW in math = CW on screen?
    q = q[order]
    # start at the corner closest to top-left
    start = np.argmin(q.sum(axis=1))
    return np.roll(q, -start, axis=0)


def _warp_canonical(gray, quad, side):
    """Inverse-perspective sample the quad to a side x side patch."""
    dst = np.array([[0, 0], [side - 1, 0], [side - 1, side - 1],
                    [0, side - 1]], np.float64)
    M = _gpt(dst, quad.astype(np.float64))   # canonical -> image
    ys, xs = np.mgrid[0:side, 0:side].astype(np.float64)
    den = M[2, 0] * xs + M[2, 1] * ys + M[2, 2]
    u = (M[0, 0] * xs + M[0, 1] * ys + M[0, 2]) / den
    v = (M[1, 0] * xs + M[1, 1] * ys + M[1, 2]) / den
    H, W = gray.shape
    ui = np.clip(np.rint(u).astype(int), 0, W - 1)
    vi = np.clip(np.rint(v).astype(int), 0, H - 1)
    return gray[vi, ui]


class ArucoDetector:
    def __init__(self, dictionary=None, detectorParams=None):
        self.dictionary = dictionary or getPredefinedDictionary(DICT_4X4_50)
        self.params = detectorParams or DetectorParameters()

    def thresholded(self, gray):
        """The adaptive threshold of each window size, on gray's device."""
        p = self.params
        return [adaptiveThreshold(gray, 255, K.ADAPTIVE_THRESH_MEAN_C, K.THRESH_BINARY_INV,
                                  win | 1, p.adaptiveThreshConstant)
                for win in range(p.adaptiveThreshWinSizeMin,
                                 p.adaptiveThreshWinSizeMax + 1,
                                 p.adaptiveThreshWinSizeStep)]

    def detectMarkers(self, image):
        img = as_tensor(image)
        gray_t = cvtColor(img, K.COLOR_BGR2GRAY) if img.ndim == 3 else img
        planes = self.thresholded(gray_t)
        gray = to_host(gray_t)
        H, W = gray.shape
        p = self.params
        ms = self.dictionary.markerSize
        border = p.markerBorderBits
        total = ms + 2 * border
        cellpx = p.perspectiveRemovePixelPerCell
        side = total * cellpx

        corners_out, ids_out, rejected = [], [], []
        seen = []
        perim_img = 2 * (H + W)
        for plane in planes:
            contours, _ = findContours(to_host(plane), K.RETR_LIST,
                                       K.CHAIN_APPROX_SIMPLE)
            for c in contours:
                pts = np.asarray(c).reshape(-1, 2)
                per = np.sum(np.linalg.norm(
                    np.diff(np.vstack([pts, pts[:1]]), axis=0), axis=1))
                if not (p.minMarkerPerimeterRate * perim_img / 4 < per
                        < p.maxMarkerPerimeterRate * perim_img):
                    continue
                ap = np.asarray(approxPolyDP(
                    pts.reshape(-1, 1, 2).astype(np.float32),
                    p.polygonalApproxAccuracyRate * per, True)
                ).reshape(-1, 2)
                if len(ap) != 4:
                    continue
                if abs(contourArea(ap)) < 16:
                    continue
                quad = _order_quad_cw(ap.astype(np.float64))
                if np.min(quad[:, 0]) < p.minDistanceToBorder or \
                        np.min(quad[:, 1]) < p.minDistanceToBorder or \
                        np.max(quad[:, 0]) >= W - p.minDistanceToBorder or \
                        np.max(quad[:, 1]) >= H - p.minDistanceToBorder:
                    continue
                # dedup across threshold scales: same marker if centers
                # are within half a side length (minMarkerDistanceRate)
                ctr = quad.mean(axis=0)
                side_len = per / 4.0
                if any(np.linalg.norm(ctr - q.mean(axis=0))
                       < 0.5 * side_len for q in seen):
                    continue

                try:
                    patch = _warp_canonical(gray, quad, side)
                except np.linalg.LinAlgError:
                    # a quad with three corners on a line has no homography:
                    # the JAX package raises here, the port rejects the
                    # candidate (ROADMAP queue C)
                    rejected.append(quad.astype(np.float32).reshape(1, 4, 2))
                    continue
                lo, hi = patch.min(), patch.max()
                if hi - lo < 30:
                    continue
                binp = patch > (int(lo) + int(hi)) / 2
                margin = int(p.perspectiveRemoveIgnoredMarginPerCell
                             * cellpx)
                cells = np.zeros((total, total), np.uint8)
                for i in range(total):
                    for j in range(total):
                        cell = binp[i * cellpx + margin:(i + 1) * cellpx
                                    - margin,
                                    j * cellpx + margin:(j + 1) * cellpx
                                    - margin]
                        cells[i, j] = cell.mean() > 0.5
                # border must be (mostly) black
                bmask = np.ones((total, total), bool)
                bmask[border:-border, border:-border] = False
                if cells[bmask].sum() > p.maxErroneousBitsInBorderRate \
                        * bmask.sum():
                    rejected.append(quad.astype(np.float32
                                                ).reshape(1, 4, 2))
                    continue
                inner = cells[border:-border, border:-border]
                ok, mid, rot = self.dictionary.identify(
                    inner, p.errorCorrectionRate)
                if not ok:
                    rejected.append(quad.astype(np.float32
                                                ).reshape(1, 4, 2))
                    continue
                # stored rotations are anticlockwise; rotate corner list
                # so corner 0 is the marker's canonical top-left
                quad_r = np.roll(quad, rot, axis=0)
                seen.append(quad)
                corners_out.append(quad_r.astype(np.float32
                                                 ).reshape(1, 4, 2))
                ids_out.append(mid)

        ids = np.array(ids_out, np.int32).reshape(-1, 1) if ids_out \
            else None
        return tuple(corners_out), ids, tuple(rejected)


def drawDetectedMarkers(image, corners, ids=None,
                        borderColor=(0, 255, 0)):
    from ..ops.drawing import polylines, putText
    img = image
    for k, c in enumerate(corners):
        q = np.asarray(c).reshape(4, 2).astype(np.int32)
        img = polylines(img, [q], True, borderColor, 1)
        if ids is not None:
            img = putText(img, str(int(np.asarray(ids).ravel()[k])),
                          (int(q[0, 0]), int(q[0, 1]) - 4),
                          K.FONT_HERSHEY_SIMPLEX, 0.4, borderColor, 1)
    return img


from .charuco import (  # noqa: E402,F401
    CharucoBoard, CharucoParameters, CharucoDetector,
)


class RefineParameters:
    """cv::aruco::RefineParameters (refineDetectedMarkers knobs)."""

    def __init__(self, minRepDistance: float = 10.0,
                 errorCorrectionRate: float = 3.0,
                 checkAllOrders: bool = True):
        self.minRepDistance = minRepDistance
        self.errorCorrectionRate = errorCorrectionRate
        self.checkAllOrders = checkAllOrders


class Board:
    """cv::aruco::Board — marker layout with object points for pose
    estimation (aruco/board.cpp)."""

    def __init__(self, objPoints, dictionary, ids):
        self._obj = [np.asarray(o, np.float32).reshape(-1, 3)
                     for o in objPoints]
        self._dict = dictionary
        self._ids = np.asarray(ids, np.int32).ravel()

    def getDictionary(self):
        return self._dict

    def getObjPoints(self):
        return self._obj

    def getIds(self):
        return self._ids

    def getRightBottomCorner(self):
        allp = np.vstack(self._obj)
        return tuple(allp.max(axis=0))

    def matchImagePoints(self, detectedCorners, detectedIds):
        det = np.asarray(detectedIds, np.int32).ravel()
        obj_out, img_out = [], []
        for k, mid in enumerate(det):
            where = np.nonzero(self._ids == mid)[0]
            if not len(where):
                continue
            obj_out.append(self._obj[where[0]])
            img_out.append(np.asarray(detectedCorners[k],
                                      np.float32).reshape(-1, 2))
        if not obj_out:
            return (np.zeros((0, 1, 3), np.float32),
                    np.zeros((0, 1, 2), np.float32))
        return (np.vstack(obj_out).reshape(-1, 1, 3),
                np.vstack(img_out).reshape(-1, 1, 2))


class GridBoard(Board):
    """cv::aruco::GridBoard — planar X×Y marker grid."""

    def __init__(self, size, markerLength, markerSeparation, dictionary,
                 ids=None):
        nx, ny = int(size[0]), int(size[1])
        n = nx * ny
        if ids is None:
            ids = np.arange(n, dtype=np.int32)
        objs = []
        for i in range(ny):
            for j in range(nx):
                x0 = j * (markerLength + markerSeparation)
                y0 = i * (markerLength + markerSeparation)
                objs.append(np.array(
                    [[x0, y0, 0], [x0 + markerLength, y0, 0],
                     [x0 + markerLength, y0 + markerLength, 0],
                     [x0, y0 + markerLength, 0]], np.float32))
        super().__init__(objs, dictionary, ids)
        self._size = (nx, ny)
        self._mlen = float(markerLength)
        self._msep = float(markerSeparation)

    def getGridSize(self):
        return self._size

    def getMarkerLength(self):
        return self._mlen

    def getMarkerSeparation(self):
        return self._msep

    def generateImage(self, outSize, marginSize: int = 0,
                      borderBits: int = 1):
        W, H = int(outSize[0]), int(outSize[1])
        img = np.full((H, W), 255, np.uint8)
        nx, ny = self._size
        span_x = nx * self._mlen + (nx - 1) * self._msep
        span_y = ny * self._mlen + (ny - 1) * self._msep
        avail_w = W - 2 * marginSize
        avail_h = H - 2 * marginSize
        scale = min(avail_w / span_x, avail_h / span_y)
        off_x = marginSize + (avail_w - span_x * scale) / 2
        off_y = marginSize + (avail_h - span_y * scale) / 2
        mpx = max(1, int(round(self._mlen * scale)))
        for idx, obj in enumerate(self._obj):
            mid = int(self._ids[idx])
            bits = generateImageMarker(self._dict, mid, mpx,
                                       borderBits)
            x = int(round(off_x + obj[0, 0] * scale))
            y = int(round(off_y + obj[0, 1] * scale))
            img[y:y + mpx, x:x + mpx] = np.asarray(bits)[:mpx, :mpx]
        return img
