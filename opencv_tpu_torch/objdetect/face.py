"""YuNet face detection + SFace recognition
(`cv2.FaceDetectorYN` / `cv2.FaceRecognizerSF`,
modules/objdetect/src/face_detect.cpp, face_recognize.cpp); twin of
``opencv_tpu/objdetect/face.py``.

Model-driven: the user supplies the YuNet / SFace ONNX weights; inference
runs through the port's dnn Net executor on the model's device (``device``,
``"cuda"`` unless the caller asks for another, as the port's nets and
trackers take it): the image goes there, is padded and blobbed there, and
the heads come back once.  The anchor-free decode + NMS post-processing
below reproduces the reference exactly (face_detect.cpp:160-258) as
vectorized host numpy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.arrays import as_tensor, to_host

__all__ = ["FaceDetectorYN", "FaceRecognizerSF"]


class FaceDetectorYN:
    """cv2.FaceDetectorYN (face_detect.cpp:31): anchor-free YuNet decode
    over strides {8, 16, 32} with sqrt(cls*obj) scoring and NMS."""

    STRIDES = (8, 16, 32)
    DIVISOR = 32

    def __init__(self, model, config="", input_size=(320, 320),
                 score_threshold=0.9, nms_threshold=0.3, top_k=5000,
                 backend_id=0, target_id=0, device=None):
        from ..dnn import default_device, readNetFromONNX

        self.device = default_device(device)
        self._net = readNetFromONNX(model, self.device)
        self.input_size = (int(input_size[0]), int(input_size[1]))
        self.score_threshold = float(score_threshold)
        self.nms_threshold = float(nms_threshold)
        self.top_k = int(top_k)

    @staticmethod
    def create(model, config="", input_size=(320, 320),
               score_threshold=0.9, nms_threshold=0.3, top_k=5000,
               backend_id=0, target_id=0, device=None):
        return FaceDetectorYN(model, config, input_size, score_threshold,
                              nms_threshold, top_k, backend_id, target_id,
                              device)

    # cv2 accessors
    def setInputSize(self, input_size):
        self.input_size = (int(input_size[0]), int(input_size[1]))

    def getInputSize(self):
        return self.input_size

    def setScoreThreshold(self, v):
        self.score_threshold = float(v)

    def getScoreThreshold(self):
        return self.score_threshold

    def setNMSThreshold(self, v):
        self.nms_threshold = float(v)

    def getNMSThreshold(self):
        return self.nms_threshold

    def setTopK(self, k):
        self.top_k = int(k)

    def getTopK(self):
        return self.top_k

    def _pad_size(self):
        w, h = self.input_size
        padW = ((w - 1) // self.DIVISOR + 1) * self.DIVISOR
        padH = ((h - 1) // self.DIVISOR + 1) * self.DIVISOR
        return padW, padH

    def detect(self, image):
        from ..dnn import blobFromImage
        from ..dnn.nms import NMSBoxes

        img = as_tensor(image).to(self.device)
        h, w = img.shape[:2]
        if (w, h) != self.input_size:
            raise ValueError(
                "Size does not match. Call setInputSize(size) if input "
                "size does not match the preset size")
        padW, padH = self._pad_size()
        pad = torch.zeros((padH, padW) + tuple(img.shape[2:]), dtype=img.dtype,
                          device=img.device)
        pad[:h, :w] = img
        blob = blobFromImage(pad)
        self._net.setInput(blob)
        names = [f"{k}_{s}" for k in ("cls", "obj", "bbox", "kps")
                 for s in self.STRIDES]
        outs = [to_host(o) for o in self._net.forward(names)]

        faces = []
        ns = len(self.STRIDES)
        for i, s in enumerate(self.STRIDES):
            cols = padW // s
            rows = padH // s
            cls = np.clip(outs[i].reshape(-1), 0.0, 1.0)
            obj = np.clip(outs[i + ns].reshape(-1), 0.0, 1.0)
            bbox = outs[i + 2 * ns].reshape(-1, 4)
            kps = outs[i + 3 * ns].reshape(-1, 10)
            score = np.sqrt(cls * obj).astype(np.float32)
            idx = np.arange(rows * cols)
            keep = score >= self.score_threshold
            if not keep.any():
                continue
            ii = idx[keep]
            c = (ii % cols).astype(np.float32)
            r = (ii // cols).astype(np.float32)
            cx = (c + bbox[ii, 0]) * s
            cy = (r + bbox[ii, 1]) * s
            bw = np.exp(bbox[ii, 2]) * s
            bh = np.exp(bbox[ii, 3]) * s
            f = np.empty((len(ii), 15), np.float32)
            f[:, 0] = cx - bw / 2.0
            f[:, 1] = cy - bh / 2.0
            f[:, 2] = bw
            f[:, 3] = bh
            for n in range(5):
                f[:, 4 + 2 * n] = (kps[ii, 2 * n] + c) * s
                f[:, 4 + 2 * n + 1] = (kps[ii, 2 * n + 1] + r) * s
            f[:, 14] = score[keep]
            faces.append(f)

        if not faces:
            return 1, None
        faces = np.concatenate(faces, axis=0)
        if faces.shape[0] > 1:
            # Rect2i truncation (face_detect.cpp:239)
            boxes = np.trunc(faces[:, :4]).astype(np.int64)
            keep = NMSBoxes(boxes, faces[:, 14], self.score_threshold,
                            self.nms_threshold, eta=1.0, top_k=self.top_k)
            faces = faces[keep]
        return 1, faces


class FaceRecognizerSF:
    """cv2.FaceRecognizerSF (face_recognize.cpp): SFace embeddings with
    similarity-transform alignment from the 5 YuNet landmarks."""

    FR_COSINE = 0
    FR_NORM_L2 = 1

    # reference alignment template (face_recognize.cpp getSimilarityTransformMatrix
    # uses the standard 112x112 ArcFace 5-point template)
    _TEMPLATE = np.array([
        [38.2946, 51.6963], [73.5318, 51.5014], [56.0252, 71.7366],
        [41.5493, 92.3655], [70.7299, 92.2041]], np.float32)

    def __init__(self, model, config="", backend_id=0, target_id=0, device=None):
        from ..dnn import default_device, readNetFromONNX

        self.device = default_device(device)
        self._net = readNetFromONNX(model, self.device)

    @staticmethod
    def create(model, config="", backend_id=0, target_id=0, device=None):
        return FaceRecognizerSF(model, config, backend_id, target_id, device)

    def alignCrop(self, src_img, face_box):
        """Similarity-transform crop to 112x112 from the 5 landmarks
        (face_recognize.cpp alignCrop)."""
        from ..ops.warp import warpAffine

        face = np.asarray(to_host(face_box), np.float32).reshape(-1)
        pts = face[4:14].reshape(5, 2)
        M = self._similarity_transform(pts, self._TEMPLATE)
        return warpAffine(as_tensor(src_img).to(self.device), M, (112, 112))

    @staticmethod
    def _similarity_transform(src, dst):
        """Umeyama least-squares similarity transform (2x3)."""
        src = np.asarray(src, np.float64)
        dst = np.asarray(dst, np.float64)
        mu_s = src.mean(0)
        mu_d = dst.mean(0)
        sc = src - mu_s
        dc = dst - mu_d
        cov = dc.T @ sc / len(src)
        U, S, Vt = np.linalg.svd(cov)
        d = np.sign(np.linalg.det(U) * np.linalg.det(Vt))
        D = np.diag([1.0, d])
        R = U @ D @ Vt
        var_s = (sc ** 2).sum() / len(src)
        scale = np.trace(np.diag(S) @ D) / var_s
        t = mu_d - scale * R @ mu_s
        M = np.zeros((2, 3))
        M[:, :2] = scale * R
        M[:, 2] = t
        return M

    def feature(self, aligned_img):
        from ..dnn import blobFromImage

        # blobFromImage(img, 1, 112x112, 0, swapRB=true, crop=false)
        # (face_recognize.cpp:58)
        blob = blobFromImage(as_tensor(aligned_img).to(self.device), scalefactor=1.0,
                             size=(112, 112), swapRB=True)
        self._net.setInput(blob)
        out = self._net.forward()
        return to_host(out).reshape(1, -1).astype(np.float32)

    def match(self, face_feature1, face_feature2, dis_type=0):
        f1 = np.asarray(to_host(face_feature1), np.float32).reshape(-1)
        f2 = np.asarray(to_host(face_feature2), np.float32).reshape(-1)
        if dis_type == self.FR_COSINE:
            n1 = f1 / max(np.linalg.norm(f1), 1e-12)
            n2 = f2 / max(np.linalg.norm(f2), 1e-12)
            return float(np.dot(n1, n2))
        if dis_type == self.FR_NORM_L2:
            n1 = f1 / max(np.linalg.norm(f1), 1e-12)
            n2 = f2 / max(np.linalg.norm(f2), 1e-12)
            return float(np.linalg.norm(n1 - n2))
        raise ValueError(f"unknown distance type {dis_type}")
