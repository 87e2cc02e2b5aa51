"""Panorama stitching (modules/stitching), twin of
``opencv_tpu/stitching.py``: the pipeline composed from the port's own
stages, ORB features → Hamming matches → RANSAC homography →
warpPerspective → L1 distance-transform seam weights → multi-band blending
(stitcher.cpp's detail pipeline, simplified to the planar chain of image
pairs; exposure compensation and graph-cut seams are left out, as in the
JAX package).

Each pair runs on the images' device: ORB there (its descriptors come back
to the host, as ORB's do), the Hamming matrix on the card, RANSAC on the
host, and the canvas, masks, weights and blend on the card; the one other
read-back is whether the two images overlap.  ``homographies`` keeps each
pair's matrix (the new image into the panorama so far) after ``stitch``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import constants as K
from .blenders import blend_multiband
from .calib3d.geometry import RANSAC, findHomography
from .core.arrays import as_tensor
from .features2d.matchers import BFMatcher
from .features2d.orb import ORB
from .ops.shape import distanceTransform
from .ops.warp import warpPerspective

__all__ = ["Stitcher", "Stitcher_create"]

STITCHER_OK = 0
STITCHER_ERR_NEED_MORE_IMGS = 1


class Stitcher:
    OK = STITCHER_OK
    ERR_NEED_MORE_IMGS = STITCHER_ERR_NEED_MORE_IMGS

    def __init__(self, mode=0):
        self.orb = ORB(nfeatures=1000)
        self.matcher = BFMatcher(K.NORM_HAMMING, crossCheck=True)
        self.homographies = []

    @staticmethod
    def create(mode=0):
        return Stitcher(mode)

    def stitch(self, images, pano=None):
        """(status, panorama): the images (a list, or an (N, H, W, C)
        tensor) chained pairwise onto the first, on its device."""
        if len(images) < 2:
            return STITCHER_ERR_NEED_MORE_IMGS, None
        self.homographies = []
        base = as_tensor(images[0])
        for nxt in images[1:]:
            base = self._stitch_pair(base, as_tensor(nxt).to(base.device))
            if base is None:
                return STITCHER_ERR_NEED_MORE_IMGS, None
        return STITCHER_OK, base

    def match_points(self, a, b):
        """ORB on both images, the cross-checked Hamming matches of b's
        descriptors against a's, the best 200 by distance: the (src in b,
        dst in a) f32 point arrays, or None where there are too few."""
        k1, d1 = self.orb.detectAndCompute(a, None)
        k2, d2 = self.orb.detectAndCompute(b, None)
        if d1 is None or d2 is None or len(d1) < 8 or len(d2) < 8:
            return None
        dev = a.device
        matches = self.matcher.match(torch.from_numpy(d2).to(dev),
                                     torch.from_numpy(d1).to(dev))  # b → a
        matches = sorted(matches, key=lambda m: m.distance)[:200]
        if len(matches) < 8:
            return None
        src = np.float32([k2[m.queryIdx].pt for m in matches])
        dst = np.float32([k1[m.trainIdx].pt for m in matches])
        return src, dst

    def _stitch_pair(self, a, b):
        pts = self.match_points(a, b)
        if pts is None:
            return None
        H, _ = findHomography(*pts, RANSAC, 3.0)
        if H is None:
            return None
        self.homographies.append(H)
        return self.compose(a, b, H)

    @staticmethod
    def canvas(a, b, H):
        """b warped by H onto the canvas that holds a and it, and a placed
        there: (canvas with a, warped b, the mask of a, the mask of b)."""
        ha, wa = a.shape[:2]
        hb, wb = b.shape[:2]
        corners = np.array([[0, 0], [wb, 0], [wb, hb], [0, hb]], np.float64)
        ch = np.column_stack([corners, np.ones(4)]) @ H.T
        ch = ch[:, :2] / ch[:, 2:3]
        minx = min(0.0, ch[:, 0].min())
        miny = min(0.0, ch[:, 1].min())
        maxx = max(float(wa), ch[:, 0].max())
        maxy = max(float(ha), ch[:, 1].max())
        T = np.array([[1, 0, -minx], [0, 1, -miny], [0, 0, 1]])
        W = int(np.ceil(maxx - minx))
        Hh = int(np.ceil(maxy - miny))
        warped_b = warpPerspective(b, T @ H, (W, Hh))
        canvas = torch.zeros_like(warped_b)
        ox, oy = int(round(-minx)), int(round(-miny))
        canvas[oy:oy + ha, ox:ox + wa] = a
        mask_a = torch.zeros((Hh, W), dtype=torch.bool, device=a.device)
        mask_a[oy:oy + ha, ox:ox + wa] = True
        mask_b = warped_b.sum(-1) > 0 if warped_b.ndim == 3 else warped_b > 0
        return canvas, warped_b, mask_a, mask_b

    @staticmethod
    def seam_weights(mask_a, mask_b):
        """Each pixel of the overlap to the image whose mask's L1 distance
        to its edge is larger (a on ties): the f32 weights of a and b."""
        both = mask_a & mask_b
        da = distanceTransform(mask_a.to(torch.uint8) * 255, K.DIST_L1, 3)
        db = distanceTransform(mask_b.to(torch.uint8) * 255, K.DIST_L1, 3)
        one, zero = torch.ones_like(da), torch.zeros_like(da)
        wa = torch.where(mask_a, torch.where(both, (da >= db).to(torch.float32), one), zero)
        wb = torch.where(mask_b, 1.0 - wa, zero)
        return wa, wb

    def compose(self, a, b, H):
        """The panorama of a and b given H (b → a): the canvas, the seam
        weights and the 4-band blend, on a's device."""
        canvas, warped_b, mask_a, mask_b = self.canvas(a, b, H)
        if not bool((mask_a & mask_b).any()):
            out = canvas.clone()
            out[mask_b] = warped_b[mask_b]
            return out
        wa, wb = self.seam_weights(mask_a, mask_b)
        out = blend_multiband([canvas, warped_b], [wa, wb], num_bands=4)
        out[~(mask_a | mask_b)] = 0
        return out


def Stitcher_create(mode=0):
    return Stitcher(mode)
