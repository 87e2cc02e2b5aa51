"""GFTTDetector (features2d/src/gftt.cpp), the Feature2D wrapper around
goodFeaturesToTrack; a copy of ``opencv_tpu/features2d/gftt.py``."""

from __future__ import annotations

import numpy as np

from ..ops.corners import goodFeaturesToTrack
from .keypoint import KeyPoint

__all__ = ["GFTTDetector", "GFTTDetector_create"]


class GFTTDetector:
    def __init__(self, maxCorners=1000, qualityLevel=0.01, minDistance=1.0,
                 blockSize=3, useHarrisDetector=False, k=0.04):
        self.maxCorners = maxCorners
        self.qualityLevel = qualityLevel
        self.minDistance = minDistance
        self.blockSize = blockSize
        self.useHarris = useHarrisDetector
        self.k = k

    @staticmethod
    def create(maxCorners=1000, qualityLevel=0.01, minDistance=1.0,
               blockSize=3, useHarrisDetector=False, k=0.04):
        return GFTTDetector(maxCorners, qualityLevel, minDistance,
                            blockSize, useHarrisDetector, k)

    def detect(self, image, mask=None):
        pts = goodFeaturesToTrack(image, self.maxCorners,
                                  self.qualityLevel, self.minDistance,
                                  mask=mask, blockSize=self.blockSize,
                                  useHarrisDetector=self.useHarris,
                                  k=self.k)
        if pts is None:
            return []
        return [KeyPoint(float(p[0]), float(p[1]),
                         float(self.blockSize * 2))
                for p in np.asarray(pts).reshape(-1, 2)]

    def setMaxFeatures(self, m):
        self.maxCorners = m

    def getMaxFeatures(self):
        return self.maxCorners

    def setQualityLevel(self, q):
        self.qualityLevel = q

    def setMinDistance(self, d):
        self.minDistance = d


def GFTTDetector_create(maxCorners=1000, qualityLevel=0.01,
                        minDistance=1.0, blockSize=3,
                        useHarrisDetector=False, k=0.04):
    return GFTTDetector(maxCorners, qualityLevel, minDistance, blockSize,
                        useHarrisDetector, k)
