"""Macbeth ColorChecker detection (the reference's cv::mcc module); twin
of ``opencv_tpu/objdetect/mcc.py``.

Detection pipeline: adaptive threshold → square-patch contours →
cluster into a 6×4 grid (same outcome as the reference's
checker-recognition graph on clean charts) → per-patch median RGB.

On a tensor image the channel mean and the adaptive threshold run on its
device (the box of a window over 31 takes the plain route, as the JAX
package's predicate sends it there too); the binary plane and the image are
read back once, and the contours, the grid and the patch medians are host
numpy.  The reference colours come from the port's ``ops/ccm.py``."""

from __future__ import annotations

import numpy as np

from .. import constants as K

__all__ = ["CChecker", "CCheckerDetector", "DetectorParametersMCC",
           "MCC24", "SG140", "VINYL18", "mcc"]

MCC24 = 0
SG140 = 1
VINYL18 = 2


class DetectorParametersMCC:
    def __init__(self):
        self.adaptiveThreshWinSizeMin = 23
        self.adaptiveThreshWinSizeMax = 153
        self.adaptiveThreshWinSizeStep = 16
        self.adaptiveThreshConstant = 7
        self.minContoursAreaRate = 0.003
        self.minContoursArea = 100
        self.confidenceThreshold = 0.5
        self.minContourSolidity = 0.9
        self.findCandidatesApproxPolyDPEpsMultiplier = 0.05
        self.borderWidth = 0
        self.B0factor = 1.25
        self.maxError = 0.1
        self.minContourPointsAllowed = 4
        self.minContourLengthAllowed = 100
        self.minInterContourDistance = 100
        self.minInterCheckerDistance = 10000
        self.minImageSize = 1000
        self.minGroupSize = 4


class CChecker:
    def __init__(self):
        self._box = np.zeros((4, 2), np.float32)
        self._center = (0.0, 0.0)
        self._charts_rgb = np.zeros((0, 1, 3), np.float64)
        self._patch_boxes = []
        self._cost = 0.0
        self._target = MCC24

    @staticmethod
    def create():
        return CChecker()

    def getBox(self):
        return self._box.copy()

    def setBox(self, box):
        self._box = np.asarray(box, np.float32).reshape(4, 2)

    def getCenter(self):
        return self._center

    def setCenter(self, c):
        self._center = tuple(c)

    def getChartsRGB(self, *a):
        return self._charts_rgb.copy()

    def setChartsRGB(self, v):
        self._charts_rgb = np.asarray(v, np.float64)

    def getChartsYCbCr(self, *a):
        rgb = self._charts_rgb.reshape(-1, 3)
        y = 0.299 * rgb[:, 0] + 0.587 * rgb[:, 1] + 0.114 * rgb[:, 2]
        cb = 128 - 0.168736 * rgb[:, 0] - 0.331264 * rgb[:, 1] \
            + 0.5 * rgb[:, 2]
        cr = 128 + 0.5 * rgb[:, 0] - 0.418688 * rgb[:, 1] \
            - 0.081312 * rgb[:, 2]
        return np.stack([y, cb, cr], -1).reshape(-1, 1, 3)

    def setChartsYCbCr(self, v):
        pass

    def getColorCharts(self):
        return self._patch_boxes

    def getCost(self):
        return self._cost

    def setCost(self, c):
        self._cost = float(c)

    def getTarget(self):
        return self._target

    def setTarget(self, t):
        self._target = t

    def empty(self):
        return len(self._charts_rgb) == 0


class CCheckerDetector:
    def __init__(self):
        self._params = DetectorParametersMCC()
        self._chart_type = MCC24
        self._checkers = []

    @staticmethod
    def create():
        return CCheckerDetector()

    def setDetectionParams(self, p):
        self._params = p
        return self

    def getDetectionParams(self):
        return self._params

    def setColorChartType(self, t):
        self._chart_type = t

    def getColorChartType(self):
        return self._chart_type

    def setUseDnnModel(self, flag):
        pass

    def getUseDnnModel(self):
        return False

    def getRefColors(self):
        from ..ops.ccm import _MACBETH_LAB, _lab_d50_to_linear_rgb
        lin = np.clip(_lab_d50_to_linear_rgb(_MACBETH_LAB), 0, 1)
        return (lin ** (1 / 2.2) * 255).astype(np.float32)

    def process(self, image, chartType=MCC24, nc: int = 1,
                useNet: bool = False, params=None):
        """Detect ColorChecker charts; returns True when at least one
        checker was found (retrievable via getBestColorChecker)."""
        import torch
        from ..core.arrays import as_tensor, to_host
        src = as_tensor(image)
        if src.ndim == 3:
            # numpy's float64 mean over the channels, a sum divided by C
            # (torch's mean multiplies by 1/C, which truncates apart)
            c = torch.tensor(float(src.shape[2]), dtype=torch.float64, device=src.device)
            gray = (src.to(torch.float64).sum(dim=2) / c).to(torch.uint8)
        else:
            gray = src
        from ..ops.thresh import adaptiveThreshold
        from ..ops.contours import (findContours, contourArea,
                                    approxPolyDP, arcLength,
                                    boundingRect)
        H, W = gray.shape
        win = max(23, (min(H, W) // 10) | 1)
        bin_ = to_host(adaptiveThreshold(
            gray, 255, K.ADAPTIVE_THRESH_MEAN_C, K.THRESH_BINARY_INV,
            win, 7))
        contours, _h = findContours(bin_, K.RETR_LIST,
                                    K.CHAIN_APPROX_SIMPLE)
        quads = []
        for c in contours:
            area = contourArea(c.astype(np.float32))
            if area < 50:
                continue
            peri = arcLength(c.astype(np.float32), True)
            ap = approxPolyDP(c.astype(np.float32), 0.05 * peri, True)
            if len(ap) != 4:
                continue
            x, y, w, h = boundingRect(np.asarray(ap, np.int32))
            if w < 4 or h < 4:
                continue
            ar = w / h
            if not (0.6 < ar < 1.7):
                continue
            quads.append((x + w / 2.0, y + h / 2.0, w, h))
        if len(quads) < 24:
            self._checkers = []
            return False
        q = np.asarray(quads)
        med_w = np.median(q[:, 2])
        keep = (np.abs(q[:, 2] - med_w) < 0.5 * med_w)
        q = q[keep]
        if len(q) < 24:
            self._checkers = []
            return False
        # order into a 6x4 grid: sort rows by y clusters, x within
        order = np.argsort(q[:, 1], kind="stable")
        q = q[order]
        rows = []
        cur = [q[0]]
        for r in q[1:]:
            if abs(r[1] - cur[-1][1]) < med_w * 0.6:
                cur.append(r)
            else:
                rows.append(cur)
                cur = [r]
        rows.append(cur)
        rows = [sorted(r, key=lambda t: t[0]) for r in rows
                if len(r) >= 4]
        cells = [c for row in rows for c in row][:24]
        if len(cells) < 24:
            self._checkers = []
            return False
        img = to_host(src)
        chk = CChecker()
        vals = []
        boxes = []
        for (cx, cy, w, h) in cells:
            x0 = int(cx - w * 0.25)
            x1 = int(cx + w * 0.25) + 1
            y0 = int(cy - h * 0.25)
            y1 = int(cy + h * 0.25) + 1
            patch = img[max(y0, 0):y1, max(x0, 0):x1]
            med = np.median(patch.reshape(-1, img.shape[2]
                                          if img.ndim == 3 else 1), 0)
            if img.ndim == 3:
                vals.append(med[::-1])   # BGR -> RGB rows
            else:
                vals.append([med[0]] * 3)
            boxes.append(np.array([[cx - w / 2, cy - h / 2],
                                   [cx + w / 2, cy - h / 2],
                                   [cx + w / 2, cy + h / 2],
                                   [cx - w / 2, cy + h / 2]],
                                  np.float32))
        allb = np.vstack(boxes)
        chk.setBox(np.array([[allb[:, 0].min(), allb[:, 1].min()],
                             [allb[:, 0].max(), allb[:, 1].min()],
                             [allb[:, 0].max(), allb[:, 1].max()],
                             [allb[:, 0].min(), allb[:, 1].max()]]))
        chk.setCenter((float(allb[:, 0].mean()),
                       float(allb[:, 1].mean())))
        chk._charts_rgb = np.asarray(vals, np.float64).reshape(-1, 1, 3)
        chk._patch_boxes = boxes
        self._checkers = [chk]
        return True

    def processWithROI(self, image, chartType, regionsOfInterest,
                       nc: int = 1, useNet: bool = False, params=None):
        return self.process(image, chartType, nc, useNet, params)

    def getBestColorChecker(self):
        return self._checkers[0] if self._checkers else None

    def getListColorChecker(self):
        return list(self._checkers)

    def draw(self, img):
        from ..ops.drawing import polylines
        for chk in self._checkers:
            for b in chk.getColorCharts():
                img = polylines(img, [b.astype(np.int32)], True, (0, 0, 255))
        return img


class _MccNS:
    CChecker = CChecker
    CCheckerDetector = CCheckerDetector
    DetectorParametersMCC = DetectorParametersMCC
    MCC24 = MCC24
    SG140 = SG140
    VINYL18 = VINYL18


mcc = _MccNS()
