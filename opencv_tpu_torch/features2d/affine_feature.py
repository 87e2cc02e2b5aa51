"""ASIFT-style affine-invariant wrapper (`cv::AffineFeature`,
features2d/src/affine_feature.cpp); twin of
``opencv_tpu/features2d/affine_feature.py``.

Simulates camera tilts and rolls: for every (tilt, roll) view the image is
rotated (BORDER_REPLICATE), blurred against aliasing along x with
sigma = 0.8·sqrt(tilt² − 1), shrunk along x by 1/tilt (INTER_NEAREST), the
backend detects and describes on the view, and the keypoints map back
through the inverse pose.  The views are the port's ``warpAffine``,
``GaussianBlur`` and ``resize`` on the image's device; each view's mask is
read back to filter its keypoints on the host."""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import constants as K
from ..core.arrays import as_tensor, to_host
from ..ops.filter import GaussianBlur
from ..ops.resize import resize
from ..ops.warp import invertAffineTransform, warpAffine

__all__ = ["AffineFeature", "AffineFeature_create"]


class AffineFeature:
    def __init__(self, backend, maxTilt=5, minTilt=0, tiltStep=1.4142135623730951,
                 rotateStepBase=72.0):
        self.backend = backend
        self.tilts = []
        self.rolls = []
        i = minTilt
        if i == 0:
            self.tilts.append(1.0)
            self.rolls.append(0.0)
            i += 1
        tilt = 1.0
        while i <= maxTilt:
            tilt *= tiltStep
            rotate_step = rotateStepBase / tilt
            roll_n = int(math.floor(180.0 / rotate_step))
            if roll_n * rotate_step == 180.0:
                roll_n -= 1
            for j in range(roll_n + 1):
                self.tilts.append(tilt)
                self.rolls.append(rotate_step * j)
            i += 1

    @staticmethod
    def create(backend, maxTilt=5, minTilt=0, tiltStep=1.4142135623730951,
               rotateStepBase=72.0):
        return AffineFeature(backend, maxTilt, minTilt, tiltStep,
                             rotateStepBase)

    def getViewParams(self):
        return list(self.tilts), list(self.rolls)

    def _affine_skew(self, image, tilt, phi):
        """(the view, its u8 mask as host numpy, the 2x3 f32 pose); the view
        is a tensor on the image's device."""
        h, w = image.shape[:2]
        pose = np.array([[1, 0, 0], [0, 1, 0]], np.float32)
        rot = image
        if phi != 0.0:
            p = np.float32(phi * math.pi / 180)
            s, c = np.float32(math.sin(p)), np.float32(math.cos(p))
            corners = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float32)
            A = np.array([[c, -s], [s, c]], np.float32)
            tc = (corners @ A.T).astype(np.int32)
            x0, y0 = tc[:, 0].min(), tc[:, 1].min()
            x1, y1 = tc[:, 0].max(), tc[:, 1].max()
            nw, nh = int(x1 - x0 + 1), int(y1 - y0 + 1)
            pose = np.array([[c, -s, -float(x0)], [s, c, -float(y0)]], np.float32)
            rot = warpAffine(image, pose.astype(np.float64), (nw, nh), K.INTER_LINEAR,
                             K.BORDER_REPLICATE)
        if tilt != 1.0:
            sg = 0.8 * math.sqrt(tilt * tilt - 1.0)
            rot = GaussianBlur(rot, (0, 0), sg, 0.01)
            nw = int(np.rint(rot.shape[1] / tilt))
            rot = resize(rot, (nw, rot.shape[0]), interpolation=K.INTER_NEAREST)
            pose[0] /= np.float32(tilt)
        mask = np.full(rot.shape[:2], 255, np.uint8)
        if phi != 0.0 or tilt != 1.0:
            full = torch.full((h, w), 255, dtype=torch.uint8, device=image.device)
            mask = to_host(warpAffine(full, pose.astype(np.float64),
                                      (rot.shape[1], rot.shape[0]), K.INTER_NEAREST))
        return rot, mask, pose

    def detectAndCompute(self, image, mask=None, compute_desc=True):
        img = as_tensor(image)
        all_kps = []
        descs = []
        for a, (tilt, phi) in enumerate(zip(self.tilts, self.rolls)):
            warped, wmask, pose = self._affine_skew(img, tilt, phi)
            kps, d = self.backend.detectAndCompute(warped, None)
            inv = invertAffineTransform(pose.astype(np.float64))
            kept = []
            rows = []
            for i, kp in enumerate(kps):
                x, y = kp.pt
                xi, yi = int(np.clip(round(x), 0, wmask.shape[1] - 1)), \
                    int(np.clip(round(y), 0, wmask.shape[0] - 1))
                if wmask[yi, xi] == 0:
                    continue
                nx = inv[0, 0] * x + inv[0, 1] * y + inv[0, 2]
                ny = inv[1, 0] * x + inv[1, 1] * y + inv[1, 2]
                kp.pt = (float(nx), float(ny))
                kp.class_id = a
                kept.append(kp)
                rows.append(i)
            all_kps.extend(kept)
            if d is not None and len(rows):
                descs.append(to_host(d)[rows])
        desc = (np.vstack(descs) if descs else None) if compute_desc else None
        return all_kps, desc

    def detect(self, image, mask=None):
        return self.detectAndCompute(image, mask, compute_desc=False)[0]

    def compute(self, image, keypoints):
        return self.backend.compute(image, keypoints)


def AffineFeature_create(backend, maxTilt=5, minTilt=0,
                         tiltStep=1.4142135623730951, rotateStepBase=72.0):
    return AffineFeature(backend, maxTilt, minTilt, tiltStep, rotateStepBase)
