"""Bag-of-visual-words (`cv::BOWKMeansTrainer` /
`cv::BOWImgDescriptorExtractor`, features2d/src/bagofwords.cpp); twin of
``opencv_tpu/features2d/bow.py``.

The vocabulary is the port's ``kmeans`` (its Lloyd iterations on the
descriptors' device); the image descriptor is the L1-normalised histogram of
each descriptor's nearest vocabulary word, in host numpy as the JAX package
computes it.  Descriptors may be tensors (read back once)."""

from __future__ import annotations

import numpy as np

from .. import constants as K
from ..core.arrays import to_host
from ..ops.cluster import KMEANS_PP_CENTERS, kmeans

__all__ = ["BOWKMeansTrainer", "BOWImgDescriptorExtractor"]


class BOWKMeansTrainer:
    def __init__(self, clusterCount, termcrit=None, attempts=3,
                 flags=None):
        self.cluster_count = int(clusterCount)
        self.termcrit = termcrit or (K.TERM_CRITERIA_MAX_ITER
                                     + K.TERM_CRITERIA_EPS, 20, 1e-3)
        self.attempts = int(attempts)
        self.flags = KMEANS_PP_CENTERS if flags is None else flags
        self._descs = []

    def add(self, descriptors):
        self._descs.append(to_host(descriptors).astype(np.float32))

    def getDescriptors(self):
        return list(self._descs)

    def descriptorsCount(self):
        return int(sum(len(d) for d in self._descs))

    def clear(self):
        self._descs = []

    def cluster(self, descriptors=None):
        data = (to_host(descriptors).astype(np.float32) if descriptors
                is not None else np.vstack(self._descs))
        _, _, centers = kmeans(data, self.cluster_count, None,
                               self.termcrit, self.attempts, self.flags)
        return to_host(centers).astype(np.float32)


class BOWImgDescriptorExtractor:
    def __init__(self, dextractor=None, dmatcher=None):
        self._extractor = dextractor
        self._matcher = dmatcher
        self._vocab = None

    def setVocabulary(self, vocabulary):
        self._vocab = to_host(vocabulary).astype(np.float32)

    def getVocabulary(self):
        return self._vocab

    def descriptorSize(self):
        return 0 if self._vocab is None else len(self._vocab)

    def compute(self, image, keypoints, imgDescriptor=None):
        """(bow_hist (1, K) f32, keypoints, pointIdxsOfClusters)."""
        assert self._vocab is not None, "vocabulary not set"
        if self._extractor is not None:
            keypoints, descriptors = self._extractor.compute(image,
                                                             keypoints)
        else:
            descriptors = to_host(image).astype(np.float32)
        return self.compute2(descriptors), keypoints

    def compute2(self, descriptors):
        d = to_host(descriptors).astype(np.float32)
        if d.size == 0:
            return np.zeros((1, len(self._vocab)), np.float32)
        # nearest vocabulary word per descriptor (bagofwords.cpp:147)
        d2 = ((d[:, None, :] - self._vocab[None, :, :]) ** 2).sum(-1)
        assign = d2.argmin(1)
        hist = np.bincount(assign, minlength=len(self._vocab)) \
            .astype(np.float32)
        hist /= max(len(d), 1)
        return hist.reshape(1, -1)
