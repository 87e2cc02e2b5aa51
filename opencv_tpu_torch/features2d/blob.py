"""SimpleBlobDetector (features2d/src/blobdetector.cpp), twin of
``opencv_tpu/features2d/blob.py``.

The threshold ladder is a host loop over binarizations: each rung is the
port's ``threshold`` on the image's device, read back once, then the
port's contours (the native border following), moments and convex hull on
the host.  Filters, center grouping (median-radius dedup within
minDistBetweenBlobs) and confidence-weighted averaging mirror
detect()/findBlobs().
"""

from __future__ import annotations

import numpy as np

from .. import constants as K
from ..ops.thresh import threshold
from ..ops.contours import (findContours, contourArea, arcLength,
                            convexHull)
from ..ops.shape import moments
from ..ops.color import cvtColor
from .keypoint import KeyPoint

__all__ = ["SimpleBlobDetector", "SimpleBlobDetector_create",
           "SimpleBlobDetector_Params"]

class SimpleBlobDetector_Params:
    def __init__(self):
        self.thresholdStep = 10.0
        self.minThreshold = 50.0
        self.maxThreshold = 220.0
        self.minRepeatability = 2
        self.minDistBetweenBlobs = 10.0
        self.filterByColor = True
        self.blobColor = 0
        self.filterByArea = True
        self.minArea = 25.0
        self.maxArea = 5000.0
        self.filterByCircularity = False
        self.minCircularity = 0.8
        self.maxCircularity = 3.4e38
        self.filterByInertia = True
        self.minInertiaRatio = 0.1
        self.maxInertiaRatio = 3.4e38
        self.filterByConvexity = True
        self.minConvexity = 0.95
        self.maxConvexity = 3.4e38
        self.collectContours = False


class _Center:
    __slots__ = ("location", "radius", "confidence")

    def __init__(self, location, radius, confidence):
        self.location = location
        self.radius = radius
        self.confidence = confidence


class SimpleBlobDetector:
    def __init__(self, params=None):
        self.params = params or SimpleBlobDetector_Params()

    @staticmethod
    def create(params=None):
        return SimpleBlobDetector(params)

    def _find_blobs(self, binary):
        p = self.params
        centers = []
        contours, _ = findContours(binary, K.RETR_LIST,
                                   K.CHAIN_APPROX_NONE)
        for cnt in contours:
            pts = np.asarray(cnt).reshape(-1, 2)
            m = moments(pts.astype(np.float32).reshape(-1, 1, 2))
            area = m["m00"]
            confidence = 1.0
            if p.filterByArea and not (p.minArea <= area < p.maxArea):
                continue
            if p.filterByCircularity:
                per = arcLength(pts.reshape(-1, 1, 2), True)
                ratio = 4 * np.pi * area / max(per * per, 1e-12)
                if not (p.minCircularity <= ratio < p.maxCircularity):
                    continue
            if p.filterByInertia:
                den = np.hypot(2 * m["mu11"], m["mu20"] - m["mu02"])
                if den > 1e-2:
                    cosmin = (m["mu20"] - m["mu02"]) / den
                    sinmin = 2 * m["mu11"] / den
                    imin = 0.5 * (m["mu20"] + m["mu02"]) \
                        - 0.5 * (m["mu20"] - m["mu02"]) * cosmin \
                        - m["mu11"] * sinmin
                    imax = 0.5 * (m["mu20"] + m["mu02"]) \
                        + 0.5 * (m["mu20"] - m["mu02"]) * cosmin \
                        + m["mu11"] * sinmin
                    ratio = imin / imax if imax != 0 else 1.0
                else:
                    ratio = 1.0
                if not (p.minInertiaRatio <= ratio < p.maxInertiaRatio):
                    continue
                confidence = ratio * ratio
            if p.filterByConvexity:
                hull = convexHull(pts.reshape(-1, 1, 2))
                hull_area = contourArea(np.asarray(hull))
                if abs(hull_area) < 1e-12:
                    continue
                ratio = area / hull_area
                if not (p.minConvexity <= ratio < p.maxConvexity):
                    continue
            if area == 0:
                continue
            loc = np.array([m["m10"] / m["m00"], m["m01"] / m["m00"]])
            if p.filterByColor:
                iy = int(round(loc[1]))
                ix = int(round(loc[0]))
                if binary[iy, ix] != p.blobColor:
                    continue
            dists = np.sort(np.linalg.norm(pts - loc, axis=1))
            n = len(dists)
            radius = (dists[(n - 1) // 2] + dists[n // 2]) / 2.0
            centers.append(_Center(loc, radius, confidence))
        return centers

    def detect(self, image, mask=None):
        p = self.params
        img = image
        if img.ndim == 3:
            img = cvtColor(img, K.COLOR_BGR2GRAY)
        groups = []
        th = p.minThreshold
        while th < p.maxThreshold:
            _, binary = threshold(img, th, 255, K.THRESH_BINARY)
            binary = binary.cpu().numpy()
            cur = self._find_blobs(binary)
            new_groups = []
            for c in cur:
                is_new = True
                for g in groups:
                    mid = g[len(g) // 2]
                    dist = np.linalg.norm(mid.location - c.location)
                    is_new = (dist >= p.minDistBetweenBlobs
                              and dist >= mid.radius and dist >= c.radius)
                    if not is_new:
                        g.append(c)
                        k = len(g) - 1
                        while k > 0 and c.radius < g[k - 1].radius:
                            g[k] = g[k - 1]
                            k -= 1
                        g[k] = c
                        break
                if is_new:
                    new_groups.append([c])
            groups.extend(new_groups)
            th += p.thresholdStep

        kps = []
        for g in groups:
            if len(g) < p.minRepeatability:
                continue
            ssum = np.zeros(2)
            norm = 0.0
            for c in g:
                ssum += c.confidence * c.location
                norm += c.confidence
            ssum /= norm
            kp = KeyPoint(float(ssum[0]), float(ssum[1]),
                          float(g[len(g) // 2].radius * 2.0))
            kps.append(kp)
        if mask is not None:
            mk = np.asarray(mask)
            kps = [k for k in kps if mk[int(k.pt[1]), int(k.pt[0])]]
        return kps


def SimpleBlobDetector_create(params=None):
    return SimpleBlobDetector(params)
