"""DL feature detectors (ALIKED / DISK), twin of
``opencv_tpu/features2d/dl_features.py``: Feature2D-shaped classes that run
the user-supplied ONNX export through the port's dnn reader.  No weights
are bundled (same as the reference wheel).  The net lives on ``device``
("cuda" unless asked); the image is resized and made a blob there, and the
net's keypoints, scores and descriptors come back to the host, where the
filtering and the KeyPoint lists are the JAX package's numpy.

The I/O contracts mirror the 5.x wheel (modules/features/src/disk.cpp,
aliked.cpp — not present in the 4.x reference tree; behavior verified
black-box against the installed wheel with synthetic ONNX graphs, see
tests/test_dl_features.py):

DISK model:   image (1,3,H,W) float →
              keypoints  int64 (1,N,2) absolute pixel coords in
                         net-input space,
              scores     float (1,N),
              descriptors float (1,N,128)   (raw, no re-normalization)
              The image is resized to `imageSize` (default 1024×1024);
              returned pts are scaled by (origW/netW, origH/netH).

ALIKED model: image (1,3,H,W) float →
              keypoints  float (N,2) in [-1,1] normalized coords,
              scores     float (N,),
              descriptors float (N,128)
              Denormalization: pt = (kp + 1)/2 * (W, H).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as K
from ..core.arrays import as_tensor
from ..ops.resize import resize
from .keypoint import KeyPoint

__all__ = ["ALIKED", "ALIKED_Params", "DISK"]


class ALIKED_Params:
    def __init__(self):
        self.inputSize = 640
        self.normalizeDescriptors = True
        self.backend = 0
        self.target = 0
        self.engine = 0


def _to_3ch(image, device):
    a = as_tensor(image).to(device)
    if a.ndim == 2:
        a = a[:, :, None].expand(-1, -1, 3)
    return a


class _DnnFeature2D:
    _desc_size = 128

    def __init__(self, model=None, params=None, from_memory=False, device=None):
        from ..dnn import default_device, readNetFromONNX
        self._params = params
        self._net = None
        self.device = default_device(device)
        if model is not None and (from_memory or model):
            self._net = readNetFromONNX(model, self.device)

    @classmethod
    def create(cls, modelPath="", params=None, device=None):
        return cls(modelPath or None, params, device=device)

    def detect(self, image, mask=None):
        kps, _ = self.detectAndCompute(image, mask)
        return kps

    def compute(self, image, keypoints):
        _, desc = self.detectAndCompute(image, None)
        return keypoints, desc

    def descriptorSize(self):
        return self._desc_size

    def descriptorType(self):
        return 5   # CV_32F

    def defaultNorm(self):
        return 4   # NORM_L2

    def empty(self):
        return self._net is None

    def clear(self):
        self._net = None

    def _require_net(self):
        if self._net is None:
            raise RuntimeError(
                f"{type(self).__name__} requires the ONNX model "
                "export (pass modelPath to create())")

    @staticmethod
    def _blob(img_resized):
        a = img_resized.to(torch.float32) / 255.0
        return a.permute(2, 0, 1)[None].contiguous()

    def _run(self, image, size):
        """The net on `image` resized to `size` (w, h): (its (h, w), the
        keypoints, scores and descriptors as host numpy)."""
        self._require_net()
        a = _to_3ch(image, self.device)
        net_in = resize(a, size, interpolation=K.INTER_LINEAR)
        self._net.setInput(self._blob(net_in), "image")
        outs = self._net.forward(["keypoints", "scores", "descriptors"])
        return a.shape[:2], [o.cpu().numpy() for o in outs]


class ALIKED(_DnnFeature2D):
    Params = ALIKED_Params
    _desc_size = 128

    def detectAndCompute(self, image, mask=None):
        size = getattr(self._params, "inputSize", 640) if self._params \
            else 640
        (h, w), (kpn, scores, desc) = self._run(image, (size, size))
        kpn = np.asarray(kpn, np.float64).reshape(-1, 2)
        scores = np.asarray(scores, np.float32).reshape(-1)
        desc = np.asarray(desc, np.float32).reshape(-1, self._desc_size)
        if self._params is None or getattr(
                self._params, "normalizeDescriptors", True):
            n = np.linalg.norm(desc, axis=1, keepdims=True)
            desc = desc / np.maximum(n, 1e-12)
        pts = (kpn + 1.0) / 2.0 * np.array([w, h], np.float64)
        kps = [KeyPoint(x, y, 0.0, -1.0, float(s))
               for (x, y), s in zip(pts, scores)]
        return kps, desc


class DISK(_DnnFeature2D):
    _desc_size = 128

    def __init__(self, model=None, maxKeypoints=1024,
                 scoreThreshold=0.0, imageSize=(1024, 1024),
                 backendId=0, targetId=0, from_memory=False, device=None):
        super().__init__(model, None, from_memory=from_memory, device=device)
        self._max_kp = int(maxKeypoints)
        self._thr = float(scoreThreshold)
        self._net_size = (int(imageSize[0]), int(imageSize[1]))  # (w, h)

    @classmethod
    def create(cls, modelPath="", maxKeypoints=1024, scoreThreshold=0.0,
               imageSize=(1024, 1024), backendId=0, targetId=0, device=None):
        return cls(modelPath or None, maxKeypoints, scoreThreshold,
                   imageSize, backendId, targetId, device=device)

    @classmethod
    def createFromMemory(cls, bufferModel, maxKeypoints=1024,
                         scoreThreshold=0.0, imageSize=(1024, 1024),
                         backendId=0, targetId=0, device=None):
        return cls(bufferModel, maxKeypoints, scoreThreshold,
                   imageSize, backendId, targetId, from_memory=True, device=device)

    def detectAndCompute(self, image, mask=None):
        nw, nh = self._net_size
        (h, w), (kp, scores, desc) = self._run(image, (nw, nh))
        kp = np.asarray(kp).reshape(-1, 2).astype(np.float64)
        scores = np.asarray(scores, np.float32).reshape(-1)
        desc = np.asarray(desc, np.float32).reshape(-1, self._desc_size)
        keep = scores >= self._thr
        kp, scores, desc = kp[keep], scores[keep], desc[keep]
        if self._max_kp and len(scores) > self._max_kp:
            order = np.argsort(-scores, kind="stable")[:self._max_kp]
            order = np.sort(order)       # keep model order
            kp, scores, desc = kp[order], scores[order], desc[order]
        pts = kp * np.array([w / nw, h / nh], np.float64)
        kps = [KeyPoint(x, y, 1.0, -1.0, float(s))
               for (x, y), s in zip(pts, scores)]
        return kps, desc
