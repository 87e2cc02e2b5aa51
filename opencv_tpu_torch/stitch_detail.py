"""Stitching detail pipeline (modules/stitching/src/matchers.cpp,
motion_estimators.cpp, autocalib.cpp, exposure_compensate.cpp,
seam_finders.cpp), twin of ``opencv_tpu/stitch_detail.py``.

cv2.detail parity: feature matching with the best-of-2-nearest ratio
test, homography-based rotation estimation over the max-spanning tree,
ray-space bundle adjustment (LM with numeric Jacobian — the problems
are a handful of cameras), wave correction, gain/blocks-gain exposure
compensation, and Voronoi / graph-cut seam finding (the min-cut runs
on the port's native Dinic grid solver, ``native.maxflow_grid``).

As in the JAX package this is host code: the features come from the
port's ORB on the images' device, the matches from BFMatcher on the
descriptors' device, and the estimators, compensators' systems and seam
finders run in numpy on the host (images given as tensors are read back
once; the seam finders return numpy masks).  A compensator's ``apply``
scales the image on its own device and returns a tensor.  A missing C++
compiler for the native cut raises, where the JAX package falls back to
the Voronoi seam.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import constants as K
from .calib3d.geometry import RANSAC, Rodrigues, findHomography
from .core.arrays import as_tensor, to_host
from .features2d.matchers import BFMatcher, DMatch
from .native import maxflow_grid
from .ops.deriv import Sobel
from .ops.resize import resize

__all__ = ["CameraParams", "ImageFeatures", "MatchesInfo",
           "computeImageFeatures", "BestOf2NearestMatcher",
           "HomographyBasedEstimator", "BundleAdjusterRay",
           "BundleAdjusterReproj", "waveCorrect",
           "WAVE_CORRECT_HORIZ", "WAVE_CORRECT_VERT",
           "GainCompensator", "ChannelsCompensator",
           "BlocksGainCompensator", "VoronoiSeamFinder",
           "GraphCutSeamFinder", "DpSeamFinder", "focalsFromHomography",
           "estimateFocal"]

WAVE_CORRECT_HORIZ = 0
WAVE_CORRECT_VERT = 1


class CameraParams:
    def __init__(self):
        self.focal = 1.0
        self.aspect = 1.0
        self.ppx = 0.0
        self.ppy = 0.0
        self.R = np.eye(3)
        self.t = np.zeros((3, 1))

    def K(self):
        return np.array([[self.focal, 0, self.ppx],
                         [0, self.focal * self.aspect, self.ppy],
                         [0, 0, 1.0]])


class ImageFeatures:
    def __init__(self, img_idx=0, img_size=(0, 0), keypoints=None,
                 descriptors=None):
        self.img_idx = img_idx
        self.img_size = img_size          # (w, h)
        self.keypoints = keypoints or []
        self.descriptors = descriptors


class MatchesInfo:
    def __init__(self):
        self.src_img_idx = -1
        self.dst_img_idx = -1
        self.matches = []
        self.inliers_mask = []
        self.num_inliers = 0
        self.H = None
        self.confidence = 0.0


def computeImageFeatures(featuresFinder, images):
    out = []
    for i, img in enumerate(images):
        kps, desc = featuresFinder.detectAndCompute(img, None)
        h, w = img.shape[:2]
        out.append(ImageFeatures(i, (w, h), kps, desc))
    return out


class BestOf2NearestMatcher:
    """matchers.cpp BestOf2NearestMatcher: 2-NN ratio test both ways,
    RANSAC homography, confidence = inliers / (8 + 0.3 matches)."""

    def __init__(self, try_use_gpu=False, match_conf=0.3,
                 num_matches_thresh1=6, num_matches_thresh2=6):
        self.match_conf = match_conf
        self.thresh1 = num_matches_thresh1
        self.thresh2 = num_matches_thresh2

    @staticmethod
    def create(try_use_gpu=False, match_conf=0.3,
               num_matches_thresh1=6, num_matches_thresh2=6):
        return BestOf2NearestMatcher(try_use_gpu, match_conf,
                                     num_matches_thresh1,
                                     num_matches_thresh2)

    def _pair(self, f1, f2):
        info = MatchesInfo()
        if f1.descriptors is None or f2.descriptors is None \
                or len(f1.descriptors) < 2 or len(f2.descriptors) < 2:
            return info
        bf = BFMatcher(6)   # NORM_HAMMING for binary descriptors
        if str(f1.descriptors.dtype).removeprefix("torch.") != "uint8":
            bf = BFMatcher(4)
        ratio = 1.0 - self.match_conf
        pair_ids = set()
        matches = []
        for m0, m1 in bf.knnMatch(f1.descriptors, f2.descriptors, 2):
            if m0.distance < ratio * m1.distance:
                matches.append(m0)
                pair_ids.add((m0.queryIdx, m0.trainIdx))
        for m0, m1 in bf.knnMatch(f2.descriptors, f1.descriptors, 2):
            if m0.distance < ratio * m1.distance and \
                    (m0.trainIdx, m0.queryIdx) not in pair_ids:
                m = DMatch(m0.trainIdx, m0.queryIdx, m0.distance)
                matches.append(m)
        info.matches = matches
        if len(matches) < self.thresh1:
            return info
        src = np.asarray([f1.keypoints[m.queryIdx].pt for m in matches])
        dst = np.asarray([f2.keypoints[m.trainIdx].pt for m in matches])
        # center coordinates like the reference (matchers.cpp:448)
        src = src - np.asarray(f1.img_size) * 0.5
        dst = dst - np.asarray(f2.img_size) * 0.5
        H, mask = findHomography(src, dst, RANSAC, 3.0)
        if H is None:
            return info
        info.H = H
        info.inliers_mask = mask.ravel().astype(bool).tolist()
        info.num_inliers = int(mask.sum())
        info.confidence = info.num_inliers / (8 + 0.3 * len(matches))
        # reference zeroes confidence for image-pair duplicates > 3
        info.confidence = 0.0 if info.confidence > 3.0 else info.confidence
        return info

    def apply(self, features1, features2):
        return self._pair(features1, features2)

    def apply2(self, features):
        n = len(features)
        out = []
        for i in range(n):
            for j in range(n):
                if i == j:
                    info = MatchesInfo()
                elif i < j:
                    info = self._pair(features[i], features[j])
                else:
                    prev = out[j * n + i]
                    info = MatchesInfo()
                    info.matches = prev.matches
                    info.inliers_mask = prev.inliers_mask
                    info.num_inliers = prev.num_inliers
                    info.confidence = prev.confidence
                    if prev.H is not None:
                        info.H = np.linalg.inv(prev.H)
                info.src_img_idx = i
                info.dst_img_idx = j
                out.append(info)
        return out


def focalsFromHomography(H):
    """autocalib.cpp:46: focal estimates for both images from one
    homography (returns (f0, f1, f0_ok, f1_ok))."""
    h = np.asarray(H, np.float64).ravel()
    f0 = f1 = 0.0
    f1_ok = True
    d1 = h[6] * h[7]
    d2 = (h[7] - h[6]) * (h[7] + h[6])
    v1 = -(h[0] * h[1] + h[3] * h[4]) / d1 if d1 != 0 else -np.inf
    v2 = (h[0] ** 2 + h[3] ** 2 - h[1] ** 2 - h[4] ** 2) / d2 \
        if d2 != 0 else -np.inf
    if v1 < v2:
        v1, v2 = v2, v1
        d1, d2 = d2, d1
    if v1 > 0 and v2 > 0:
        f1 = math.sqrt(v1 if abs(d1) > abs(d2) else v2)
    elif v1 > 0:
        f1 = math.sqrt(v1)
    else:
        f1_ok = False
    f0_ok = True
    d1 = h[0] * h[3] + h[1] * h[4]
    d2 = h[0] ** 2 + h[1] ** 2 - h[3] ** 2 - h[4] ** 2
    v1 = -h[2] * h[5] / d1 if d1 != 0 else -np.inf
    v2 = (h[5] ** 2 - h[2] ** 2) / d2 if d2 != 0 else -np.inf
    if v1 < v2:
        v1, v2 = v2, v1
        d1, d2 = d2, d1
    if v1 > 0 and v2 > 0:
        f0 = math.sqrt(v1 if abs(d1) > abs(d2) else v2)
    elif v1 > 0:
        f0 = math.sqrt(v1)
    else:
        f0_ok = False
    return f0, f1, f0_ok, f1_ok


def estimateFocal(features, pairwise_matches):
    """autocalib.cpp estimateFocal: median of pairwise estimates with
    the geometric-mean fallback."""
    n = len(features)
    all_focals = []
    for m in pairwise_matches:
        if m.H is None:
            continue
        f0, f1, ok0, ok1 = focalsFromHomography(m.H)
        if ok0 and ok1:
            all_focals.append(math.sqrt(f0 * f1))
    if len(all_focals) >= n - 1:
        return float(np.median(all_focals))
    s = 0.0
    for f in features:
        s += f.img_size[0] + f.img_size[1]
    return s / n


def _max_spanning_tree(n, pairwise_matches):
    """Edges of the maximum spanning tree by num_inliers, plus a
    BFS order from the best-connected node."""
    edges = []
    for m in pairwise_matches:
        if m.src_img_idx < m.dst_img_idx and m.H is not None:
            edges.append((m.num_inliers, m.src_img_idx, m.dst_img_idx))
    edges.sort(reverse=True)
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    tree = {i: [] for i in range(n)}
    for w, a, b in edges:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
            tree[a].append(b)
            tree[b].append(a)
    # BFS from the node with the most tree edges
    root = max(range(n), key=lambda i: len(tree[i]))
    order = []
    seen = {root}
    q = [root]
    while q:
        u = q.pop(0)
        for v in tree[u]:
            if v not in seen:
                seen.add(v)
                order.append((u, v))
                q.append(v)
    return order


class HomographyBasedEstimator:
    """motion_estimators.cpp HomographyBasedEstimator: focals from
    homographies, rotations chained over the spanning tree."""

    def apply(self, features, pairwise_matches, cameras=None):
        n = len(features)
        focal = estimateFocal(features, pairwise_matches)
        cams = [CameraParams() for _ in range(n)]
        by_pair = {}
        for m in pairwise_matches:
            by_pair[(m.src_img_idx, m.dst_img_idx)] = m
        for i, f in enumerate(features):
            cams[i].focal = focal
            cams[i].ppx = 0.0
            cams[i].ppy = 0.0
        for (u, v) in _max_spanning_tree(n, pairwise_matches):
            m = by_pair.get((u, v))
            H = m.H
            K_from = cams[u].K()
            K_to = cams[v].K()
            R = np.linalg.inv(K_from) @ np.linalg.inv(H) @ K_to
            cams[v].R = cams[u].R @ R
        return True, cams


class _BundleBase:
    def __init__(self):
        self.conf_thresh = 1.0

    def setConfThresh(self, t):
        self.conf_thresh = t

    def apply(self, features, pairwise_matches, cameras):
        n = len(cameras)
        edges = []
        for m in pairwise_matches:
            if (m.src_img_idx < m.dst_img_idx
                    and m.confidence > self.conf_thresh
                    and m.H is not None):
                edges.append(m)
        if not edges:
            return True, cameras
        x = []
        for c in cameras:
            U, _, Vt = np.linalg.svd(c.R)
            R = U @ Vt
            if np.linalg.det(R) < 0:
                R = -R
            rv, _ = Rodrigues(R)
            x.extend([c.focal, *rv.ravel()])
        x = np.asarray(x, np.float64)

        def residuals(xv):
            return self._errors(xv, features, edges)

        # Levenberg–Marquardt with numeric Jacobian
        lam = 1e-3
        r = residuals(x)
        cost = float(r @ r)
        for _ in range(30):
            Jac = np.zeros((len(r), len(x)))
            for k in range(len(x)):
                h = 1e-6 * max(abs(x[k]), 1.0)
                xp = x.copy()
                xp[k] += h
                Jac[:, k] = (residuals(xp) - r) / h
            A = Jac.T @ Jac
            g = Jac.T @ r
            for _ in range(10):
                try:
                    step = np.linalg.solve(
                        A + lam * np.diag(np.maximum(np.diag(A), 1e-12)),
                        -g)
                except np.linalg.LinAlgError:
                    lam *= 10
                    continue
                xn = x + step
                rn = residuals(xn)
                cn = float(rn @ rn)
                if cn < cost:
                    x, r, cost = xn, rn, cn
                    lam = max(lam * 0.3, 1e-12)
                    break
                lam *= 10
            else:
                break
            if np.linalg.norm(step) < 1e-10:
                break
        for i, c in enumerate(cameras):
            c.focal = x[4 * i]
            rv = x[4 * i + 1:4 * i + 4]
            R, _ = Rodrigues(rv)
            c.R = R
        return True, cameras


class BundleAdjusterRay(_BundleBase):
    """motion_estimators.cpp:557 — residual is the difference of the
    unit rays through matched keypoints, scaled by sqrt(f1 f2)."""

    def _errors(self, xv, features, edges):
        out = []
        for m in edges:
            i = m.src_img_idx
            j = m.dst_img_idx
            f1 = xv[4 * i]
            f2 = xv[4 * j]
            R1, _ = Rodrigues(xv[4 * i + 1:4 * i + 4])
            R2, _ = Rodrigues(xv[4 * j + 1:4 * j + 4])
            w1, h1 = features[i].img_size
            w2, h2 = features[j].img_size
            K1 = np.array([[f1, 0, w1 * 0.5], [0, f1, h1 * 0.5],
                           [0, 0, 1]])
            K2 = np.array([[f2, 0, w2 * 0.5], [0, f2, h2 * 0.5],
                           [0, 0, 1]])
            H1 = R1 @ np.linalg.inv(K1)
            H2 = R2 @ np.linalg.inv(K2)
            mult = math.sqrt(abs(f1 * f2))
            for k, dm in enumerate(m.matches):
                if not m.inliers_mask[k]:
                    continue
                p1 = features[i].keypoints[dm.queryIdx].pt
                p2 = features[j].keypoints[dm.trainIdx].pt
                r1 = H1 @ np.array([p1[0], p1[1], 1.0])
                r2 = H2 @ np.array([p2[0], p2[1], 1.0])
                r1 = r1 / max(np.linalg.norm(r1), 1e-12)
                r2 = r2 / max(np.linalg.norm(r2), 1e-12)
                out.extend(mult * (r1 - r2))
        return np.asarray(out)


class BundleAdjusterReproj(_BundleBase):
    """motion_estimators.cpp:382 — reprojection of matched points
    through H = K2 R2 R1^-1 K1^-1."""

    def _errors(self, xv, features, edges):
        out = []
        for m in edges:
            i = m.src_img_idx
            j = m.dst_img_idx
            f1 = xv[4 * i]
            f2 = xv[4 * j]
            R1, _ = Rodrigues(xv[4 * i + 1:4 * i + 4])
            R2, _ = Rodrigues(xv[4 * j + 1:4 * j + 4])
            w1, h1 = features[i].img_size
            w2, h2 = features[j].img_size
            K1 = np.array([[f1, 0, w1 * 0.5], [0, f1, h1 * 0.5],
                           [0, 0, 1]])
            K2 = np.array([[f2, 0, w2 * 0.5], [0, f2, h2 * 0.5],
                           [0, 0, 1]])
            H = K2 @ R2 @ R1.T @ np.linalg.inv(K1)
            for k, dm in enumerate(m.matches):
                if not m.inliers_mask[k]:
                    continue
                p1 = features[i].keypoints[dm.queryIdx].pt
                p2 = features[j].keypoints[dm.trainIdx].pt
                q = H @ np.array([p1[0], p1[1], 1.0])
                out.append(q[0] / q[2] - p2[0])
                out.append(q[1] / q[2] - p2[1])
        return np.asarray(out)


def waveCorrect(rmats, kind=WAVE_CORRECT_HORIZ):
    """motion_estimators.cpp waveCorrect."""
    if len(rmats) <= 1:
        return rmats
    moment = np.zeros((3, 3))
    for R in rmats:
        c = np.asarray(R)[:, 0:1]
        moment += c @ c.T
    w, V = np.linalg.eigh(moment)     # ascending
    rg1 = V[:, 0] if kind == WAVE_CORRECT_HORIZ else V[:, 2]
    img_k = np.zeros(3)
    for R in rmats:
        img_k += np.asarray(R)[:, 2]
    rg0 = np.cross(rg1, img_k)
    nrm = np.linalg.norm(rg0)
    if nrm < 1e-300:
        return rmats
    rg0 /= nrm
    rg2 = np.cross(rg0, rg1)
    conf = 0.0
    if kind == WAVE_CORRECT_HORIZ:
        for R in rmats:
            conf += rg0 @ np.asarray(R)[:, 0]
    else:
        for R in rmats:
            conf -= rg1 @ np.asarray(R)[:, 0]
    if conf < 0:
        rg0 = -rg0
        rg1 = -rg1
    Rw = np.vstack([rg0, rg1, rg2])
    return [Rw @ np.asarray(R) for R in rmats]


# ------------------------------------------------- exposure compensation

def _scaled(image, gain):
    """`image` times `gain` (a scalar, or an array that broadcasts over it)
    in float64 on the image's device; a u8 image rounds back as the
    reference does (+0.5, clipped, truncated)."""
    img = as_tensor(image)
    g = torch.as_tensor(np.asarray(gain, np.float64), device=img.device)
    out = img.to(torch.float64) * g
    if img.dtype == torch.uint8:
        return torch.clamp(out + 0.5, 0, 255).to(torch.uint8)
    return out


def _overlap_roi(c1, c2, s1, s2):
    x0 = max(c1[0], c2[0])
    y0 = max(c1[1], c2[1])
    x1 = min(c1[0] + s1[1], c2[0] + s2[1])
    y1 = min(c1[1] + s1[0], c2[1] + s2[0])
    if x1 <= x0 or y1 <= y0:
        return None
    return (x0, y0, x1 - x0, y1 - y0)


class GainCompensator:
    """exposure_compensate.cpp GainCompensator: per-image scalar gain
    from the overlap-intensity linear system (alpha=0.01, beta=100)."""

    def __init__(self, nr_feeds=1):
        self.gains_ = None

    def feed(self, corners, images, masks):
        n = len(images)
        images = [to_host(im) for im in images]
        masks = [to_host(mk) for mk in masks]
        N = np.zeros((n, n))
        I = np.zeros((n, n))
        skip = np.ones(n, bool)
        for i in range(n):
            for j in range(i, n):
                roi = _overlap_roi(corners[i], corners[j],
                                   images[i].shape, images[j].shape)
                if roi is None:
                    continue
                x0, y0, w, h = roi
                si = images[i][y0 - corners[i][1]:y0 - corners[i][1] + h,
                               x0 - corners[i][0]:x0 - corners[i][0] + w]
                sj = images[j][y0 - corners[j][1]:y0 - corners[j][1] + h,
                               x0 - corners[j][0]:x0 - corners[j][0] + w]
                mi = masks[i][y0 - corners[i][1]:y0 - corners[i][1] + h,
                              x0 - corners[i][0]:x0 - corners[i][0] + w]
                mj = masks[j][y0 - corners[j][1]:y0 - corners[j][1] + h,
                              x0 - corners[j][0]:x0 - corners[j][0] + w]
                inter = (mi > 0) & (mj > 0)
                cnt = int(inter.sum())
                N[i, j] = N[j, i] = max(1, cnt)
                if cnt == 0:
                    continue
                if i != j:
                    skip[i] = skip[j] = False
                if si.ndim == 3:
                    Isum1 = np.sqrt((si.astype(np.float64) ** 2)
                                    .sum(-1))[inter].sum()
                    Isum2 = np.sqrt((sj.astype(np.float64) ** 2)
                                    .sum(-1))[inter].sum()
                else:
                    Isum1 = si.astype(np.float64)[inter].sum()
                    Isum2 = sj.astype(np.float64)[inter].sum()
                I[i, j] = Isum1 / N[i, j]
                I[j, i] = Isum2 / N[i, j]
        alpha, beta = 0.01, 100.0
        keep = np.nonzero(~skip)[0]
        self.gains_ = np.ones(n)
        if len(keep) == 0:
            return
        m = len(keep)
        A = np.zeros((m, m))
        b = np.zeros(m)
        for ki, i in enumerate(keep):
            for kj, j in enumerate(keep):
                b[ki] += beta * N[i, j]
                A[ki, ki] += beta * N[i, j]
                if i != j:
                    A[ki, ki] += 2 * alpha * I[i, j] ** 2 * N[i, j]
                    A[ki, kj] -= 2 * alpha * I[i, j] * I[j, i] * N[i, j]
        g = np.linalg.solve(A, b)
        for ki, i in enumerate(keep):
            self.gains_[i] = g[ki]

    def apply(self, index, corner, image, mask):
        return _scaled(image, self.gains_[index])

    def gains(self):
        return list(self.gains_)


class ChannelsCompensator:
    """Per-channel GainCompensator (exposure_compensate.cpp
    ChannelsCompensator)."""

    def __init__(self, nr_feeds=1):
        self._per_channel = [GainCompensator() for _ in range(3)]

    def feed(self, corners, images, masks):
        for c in range(3):
            chans = [to_host(im)[..., c] for im in images]
            self._per_channel[c].feed(corners, chans, masks)

    def apply(self, index, corner, image, mask):
        C = image.shape[-1]
        g = np.ones(C)
        g[:3] = [self._per_channel[c].gains_[index] for c in range(3)]
        return _scaled(image, g)

    def gains(self):
        return [g.gains_ for g in self._per_channel]


class BlocksGainCompensator:
    """exposure_compensate.cpp BlocksGainCompensator: per-block gains
    smoothed by bilinear upsampling."""

    def __init__(self, bl_width=32, bl_height=32, nr_feeds=1):
        self.bw = bl_width
        self.bh = bl_height
        self.gain_maps_ = None

    def feed(self, corners, images, masks):
        block_corners = []
        block_images = []
        block_masks = []
        layout = []
        for idx, (c, im, mk) in enumerate(zip(corners, images, masks)):
            im = to_host(im)
            mk = to_host(mk)
            h, w = im.shape[:2]
            ny = max(1, -(-h // self.bh))
            nx = max(1, -(-w // self.bw))
            blocks = []
            for by in range(ny):
                for bx in range(nx):
                    y0 = by * self.bh
                    x0 = bx * self.bw
                    y1 = min(y0 + self.bh, h)
                    x1 = min(x0 + self.bw, w)
                    block_corners.append((c[0] + x0, c[1] + y0))
                    block_images.append(im[y0:y1, x0:x1])
                    block_masks.append(mk[y0:y1, x0:x1])
                    blocks.append(len(block_corners) - 1)
            layout.append((ny, nx, blocks))
        gc = GainCompensator()
        gc.feed(block_corners, block_images, block_masks)
        self.gain_maps_ = []
        for idx, (c, im) in enumerate(zip(corners, images)):
            ny, nx, blocks = layout[idx]
            gm = np.asarray([gc.gains_[b] for b in blocks],
                            np.float32).reshape(ny, nx)
            h, w = im.shape[:2]
            up = resize(gm, (w, h), interpolation=K.INTER_LINEAR).numpy()
            self.gain_maps_.append(up)

    def apply(self, index, corner, image, mask):
        g = self.gain_maps_[index]
        return _scaled(image, g[..., None] if image.ndim == 3 else g)


# ------------------------------------------------------- seam finders

class VoronoiSeamFinder:
    """seam_finders.cpp VoronoiSeamFinder: nearest-source partition of
    each pairwise overlap by distance transform."""

    def find(self, sizes_or_images, corners, masks):
        first = sizes_or_images[0]
        shape = getattr(first, "shape", None)
        if shape is not None and len(shape) >= 2 and int(np.prod(shape)) > 4:
            sizes = [tuple(s.shape[:2]) for s in sizes_or_images]
        else:
            sizes = [(s[1], s[0]) for s in sizes_or_images]
        masks = [to_host(m).copy() for m in masks]
        n = len(sizes)
        for i in range(n - 1):
            for j in range(i + 1, n):
                roi = _overlap_roi(corners[i], corners[j], sizes[i],
                                   sizes[j])
                if roi is None:
                    continue
                self._pair(i, j, roi, corners, sizes, masks)
        return masks

    @staticmethod
    def _pair(i, j, roi, corners, sizes, masks):
        from scipy import ndimage
        x0, y0, w, h = roi
        sl_i = (slice(y0 - corners[i][1], y0 - corners[i][1] + h),
                slice(x0 - corners[i][0], x0 - corners[i][0] + w))
        sl_j = (slice(y0 - corners[j][1], y0 - corners[j][1] + h),
                slice(x0 - corners[j][0], x0 - corners[j][0] + w))
        mi = masks[i][sl_i] > 0
        mj = masks[j][sl_j] > 0
        both = mi & mj
        if not both.any():
            return
        # distance to the exclusive region of each image
        only_i = mi & ~mj
        only_j = mj & ~mi
        di = ndimage.distance_transform_edt(~only_i) if only_i.any() \
            else np.full(mi.shape, np.inf)
        dj = ndimage.distance_transform_edt(~only_j) if only_j.any() \
            else np.full(mj.shape, np.inf)
        keep_i = di <= dj
        masks[i][sl_i] = np.where(both & ~keep_i, 0, masks[i][sl_i])
        masks[j][sl_j] = np.where(both & keep_i, 0, masks[j][sl_j])


class GraphCutSeamFinder:
    """seam_finders.cpp GraphCutSeamFinder: pairwise min-cut with
    terminal cost 10000, bad-region penalty 1000; color or
    color-grad costs.  The cut runs on the native Dinic grid solver."""

    COST_COLOR = 0
    COST_COLOR_GRAD = 1

    def __init__(self, cost_type="COST_COLOR", terminal_cost=10000.0,
                 bad_region_penalty=1000.0):
        if isinstance(cost_type, str):
            cost_type = {"COST_COLOR": 0, "COST_COLOR_GRAD": 1}[cost_type]
        self.cost_type = cost_type
        self.terminal_cost = terminal_cost
        self.bad_region_penalty = bad_region_penalty

    def find(self, images, corners, masks):
        images = [to_host(im).astype(np.float32) for im in images]
        masks = [to_host(m).copy() for m in masks]
        n = len(images)
        grads = []
        if self.cost_type == self.COST_COLOR_GRAD:
            for im in images:
                dx = Sobel(im, K.CV_32F, 1, 0).numpy()
                dy = Sobel(im, K.CV_32F, 0, 1).numpy()
                gx = (dx ** 2).sum(-1) if dx.ndim == 3 else dx ** 2
                gy = (dy ** 2).sum(-1) if dy.ndim == 3 else dy ** 2
                grads.append((gx, gy))
        for i in range(n - 1):
            for j in range(i + 1, n):
                roi = _overlap_roi(corners[i], corners[j],
                                   images[i].shape[:2],
                                   images[j].shape[:2])
                if roi is None:
                    continue
                self._pair(i, j, roi, corners, images, masks, grads)
        return masks

    def _pair(self, i, j, roi, corners, images, masks, grads):
        gap = 10
        x0, y0, w, h = roi
        H = h + 2 * gap
        W = w + 2 * gap

        def crop(img, corner, fill=0.0, chan=None):
            shape = (H, W) + ((img.shape[2],) if img.ndim == 3 else ())
            out = np.full(shape, fill, img.dtype)
            ys = y0 - corner[1] - gap
            xs = x0 - corner[0] - gap
            sy0 = max(ys, 0)
            sx0 = max(xs, 0)
            sy1 = min(ys + H, img.shape[0])
            sx1 = min(xs + W, img.shape[1])
            if sy1 > sy0 and sx1 > sx0:
                out[sy0 - ys:sy1 - ys, sx0 - xs:sx1 - xs] = \
                    img[sy0:sy1, sx0:sx1]
            return out

        im1 = crop(images[i], corners[i]).astype(np.float64)
        im2 = crop(images[j], corners[j]).astype(np.float64)
        mk1 = crop(masks[i], corners[i]) > 0
        mk2 = crop(masks[j], corners[j]) > 0
        # reference cost is the squared L2 color difference
        d = ((im1 - im2) ** 2).sum(-1) if im1.ndim == 3 \
            else (im1 - im2) ** 2
        eps = 1.0
        wx = d[:, :-1] + d[:, 1:] + eps
        wy = d[:-1, :] + d[1:, :] + eps
        badx = (~mk1[:, :-1] | ~mk1[:, 1:] | ~mk2[:, :-1] | ~mk2[:, 1:])
        bady = (~mk1[:-1, :] | ~mk1[1:, :] | ~mk2[:-1, :] | ~mk2[1:, :])
        if self.cost_type == self.COST_COLOR_GRAD:
            gx1, gy1 = grads[i]
            gx2, gy2 = grads[j]
            gxs = crop(gx1, corners[i]) + crop(gx2, corners[j])
            gys = crop(gy1, corners[i]) + crop(gy2, corners[j])
            wx = (d[:, :-1] + d[:, 1:]) / np.sqrt(
                gxs[:, :-1] + gxs[:, 1:] + 1.0) + eps
            wy = (d[:-1, :] + d[1:, :]) / np.sqrt(
                gys[:-1, :] + gys[1:, :] + 1.0) + eps
        wx = wx + badx * self.bad_region_penalty
        wy = wy + bady * self.bad_region_penalty
        src = np.where(mk1, self.terminal_cost, 0.0)
        snk = np.where(mk2, self.terminal_cost, 0.0)
        left = np.zeros((H, W))
        left[:, 1:] = wx
        up = np.zeros((H, W))
        up[1:, :] = wy
        zero = np.zeros((H, W))
        in_src = maxflow_grid(src, snk, left, zero, up, zero)
        sub = in_src[gap:gap + h, gap:gap + w]
        sl_i = (slice(y0 - corners[i][1], y0 - corners[i][1] + h),
                slice(x0 - corners[i][0], x0 - corners[i][0] + w))
        sl_j = (slice(y0 - corners[j][1], y0 - corners[j][1] + h),
                slice(x0 - corners[j][0], x0 - corners[j][0] + w))
        m1 = masks[i][sl_i]
        m2 = masks[j][sl_j]
        keep1 = sub & (m1 > 0)
        masks[j][sl_j] = np.where(keep1, 0, m2)
        masks[i][sl_i] = np.where(~sub & (m2 > 0), 0, m1)


class DpSeamFinder:
    """seam_finders.cpp DpSeamFinder role: here backed by the graph-cut
    solver (same seam-quality objective, global optimum)."""

    def __init__(self, costFunc="COLOR"):
        cost = "COST_COLOR" if costFunc == "COLOR" else "COST_COLOR_GRAD"
        self._gc = GraphCutSeamFinder(cost)

    def find(self, images, corners, masks):
        return self._gc.find(images, corners, masks)
