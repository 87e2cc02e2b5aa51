"""SIFT detector + descriptor (features2d/src/sift.dispatch.cpp,
sift.simd.hpp), twin of ``opencv_tpu/features2d/sift.py``.

On the input's device, in torch: the 2x LINEAR upsample and the f32
Gaussian and DoG pyramids through the port's ``resize`` and
``GaussianBlur``, in the reference's order, and the 26-neighbour extremum
masks, batched over the images.  Then one read-back of every level and
mask (through pinned memory on the card, one host sync per batch).  On the
host, the JAX package's numpy, copied: the per-candidate subpixel
refinement, the orientation histograms and the descriptor sampling, in its
f32/f64 arithmetic.  The float pyramid is plain torch on both devices, as
it is plain XLA in the JAX package (no Pallas kernel: the blurs are f32,
so they do not reach ``sep_filter``).

Constants follow the reference exactly: INIT_SIGMA=0.5, IMG_BORDER=5,
MAX_INTERP_STEPS=5, 36 orientation bins, σ factor 1.5 (radius 4.5),
peak ratio 0.8, descriptor 4×4×8 with scale factor 3, magnitude clip
0.2, output scale 512 (sift.simd.hpp:84-117).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import constants as K
from ..core.arrays import as_tensor
from ..ops.color import cvtColor
from ..ops.filter import GaussianBlur
from ..ops.resize import resize
from .keypoint import KeyPoint

__all__ = ["SIFT", "SIFT_create", "extrema_mask"]

_INIT_SIGMA = 0.5
_IMG_BORDER = 5
_MAX_STEPS = 5
_ORI_BINS = 36
_ORI_SIG = 1.5
_ORI_RADIUS = 4.5
_PEAK_RATIO = 0.8
_DESCR_W = 4
_DESCR_BINS = 8
_DESCR_SCL = 3.0
_DESCR_MAG_THR = 0.2
_INT_FCTR = 512.0


def extrema_mask(prev, cur, nxt, thr):
    """26-neighbour extremum mask on (B, H, W) f32 DoG triples: the
    reference's ``_extrema_mask`` (edge-replicated neighbours), batched."""
    H, W = cur.shape[1:]

    def shifted(img):
        p = F.pad(img[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
        return [p[:, dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)]

    nb = shifted(prev) + shifted(nxt) + [s for i, s in enumerate(shifted(cur)) if i != 4]
    allmax, allmin = nb[0], nb[0]
    for s in nb[1:]:
        allmax = torch.maximum(allmax, s)
        allmin = torch.minimum(allmin, s)
    t = torch.tensor(thr, dtype=torch.float32, device=cur.device)
    strong = cur.abs() > t
    return (((cur > 0) & (cur >= allmax)) | ((cur < 0) & (cur <= allmin))) & strong


def _host_views(levels, device):
    """Every tensor of the nested lists `levels` as a host numpy array: on
    the card, each is copied into one pinned buffer per dtype, then one
    sync; on the CPU they are the tensors' own memory."""
    flat = [t for row in levels for t in row]
    if device.type != "cuda":
        return [[t.numpy() for t in row] for row in levels]
    bufs, offs = {}, []
    for t in flat:
        n = bufs.get(t.dtype, 0)
        offs.append(n)
        bufs[t.dtype] = n + t.numel()
    host = {dt: torch.empty(n, dtype=dt, pin_memory=True) for dt, n in bufs.items()}
    for t, o in zip(flat, offs):
        host[t.dtype][o:o + t.numel()].copy_(t.reshape(-1), non_blocking=True)
    torch.cuda.current_stream(device).synchronize()
    views = iter([host[t.dtype][o:o + t.numel()].view(t.shape).numpy()
                  for t, o in zip(flat, offs)])
    return [[next(views) for _ in row] for row in levels]


class SIFT:
    def __init__(self, nfeatures=0, nOctaveLayers=3, contrastThreshold=0.04,
                 edgeThreshold=10.0, sigma=1.6):
        self.nfeatures = nfeatures
        self.n_layers = nOctaveLayers
        self.contrast = contrastThreshold
        self.edge = edgeThreshold
        self.sigma = sigma

    @staticmethod
    def create(nfeatures=0, nOctaveLayers=3, contrastThreshold=0.04,
               edgeThreshold=10.0, sigma=1.6):
        return SIFT(nfeatures, nOctaveLayers, contrastThreshold,
                    edgeThreshold, sigma)

    # ------------------------------------------------------------ pyramids
    def n_octaves(self, H0: int, W0: int) -> int:
        return max(int(np.rint(math.log2(min(H0 * 2, W0 * 2)) - 2)), 1)

    def _sigmas(self):
        sig_diff = math.sqrt(max(self.sigma ** 2 - 4 * _INIT_SIGMA ** 2, 0.01))
        k = 2.0 ** (1.0 / self.n_layers)
        sig = [self.sigma]
        for i in range(1, self.n_layers + 3):
            sp = self.sigma * (k ** (i - 1))
            st = k * sp
            sig.append(math.sqrt(st * st - sp * sp))
        return sig_diff, sig

    def threshold(self) -> np.float32:
        return np.float32(0.5 * self.contrast / self.n_layers * 255)

    def build_pyramids(self, gray):
        """(B, H, W) u8 (or float) tensor → the Gaussian pyramid (per octave,
        n_layers + 3 levels) and the DoG pyramid (n_layers + 2), each level a
        (B, h, w) f32 tensor on the input's device (``_build_pyramids_batch``
        of the JAX package, in its order of operations)."""
        g4 = as_tensor(gray).to(torch.float32)[..., None]
        n_oct = self.n_octaves(g4.shape[1], g4.shape[2])
        sig_diff, sig = self._sigmas()
        base = resize(g4, None, 2.0, 2.0, K.INTER_LINEAR)
        base = GaussianBlur(base, (0, 0), sig_diff, sig_diff)
        gpyr = []
        for o in range(n_oct):
            if o == 0:
                octv = [base]
            else:
                prev_top = gpyr[o - 1][self.n_layers]
                h, w = prev_top.shape[1], prev_top.shape[2]
                octv = [resize(prev_top, (w // 2, h // 2), interpolation=K.INTER_NEAREST)]
            for i in range(1, self.n_layers + 3):
                octv.append(GaussianBlur(octv[-1], (0, 0), sig[i], sig[i]))
            gpyr.append(octv)
        dog = [[octv[i + 1] - octv[i] for i in range(self.n_layers + 2)] for octv in gpyr]
        return ([[a[..., 0] for a in octv] for octv in gpyr],
                [[a[..., 0] for a in octv] for octv in dog])

    def extrema_masks(self, dog):
        """Per octave, the extremum masks of layers 1..n_layers, (B, h, w)
        bool on the DoG's device."""
        thr = self.threshold()
        return [[extrema_mask(d[li - 1], d[li], d[li + 1], thr)
                 for li in range(1, self.n_layers + 1)] for d in dog]

    def read_back(self, gpyr, dog, masks):
        """The pyramids and masks as host numpy (one sync on the card)."""
        dev = gpyr[0][0].device
        n1, n2 = len(gpyr), len(gpyr) + len(dog)
        views = _host_views(gpyr + dog + masks, dev)
        return views[:n1], views[n1:n2], views[n2:]

    def host_tails(self, gpyr_np, dog_np, masks_np, b: int):
        """Image b's keypoints and descriptors from the host pyramids: the
        JAX package's per-image loop of ``detect_and_compute_batch``."""
        gpyr = [[a[b] for a in octv] for octv in gpyr_np]
        dog = [[a[b] for a in octv] for octv in dog_np]
        kps = []
        for o in range(len(dog)):
            H, W = dog[o][0].shape
            if H < 2 * _IMG_BORDER or W < 2 * _IMG_BORDER:
                continue
            for li in range(1, self.n_layers + 1):
                m = masks_np[o][li - 1][b].copy()
                m[:_IMG_BORDER] = m[-_IMG_BORDER:] = False
                m[:, :_IMG_BORDER] = m[:, -_IMG_BORDER:] = False
                ys, xs = np.nonzero(m)
                for y0, x0 in zip(ys.tolist(), xs.tolist()):
                    kp = self._refine(dog[o], o, li, y0, x0)
                    if kp is None:
                        continue
                    kps.extend(self._orientations(gpyr[o], kp))
        if self.nfeatures > 0 and len(kps) > self.nfeatures:
            kps.sort(key=lambda q: -q.response)
            kps = kps[:self.nfeatures]
        desc = self._describe(gpyr, kps)
        return kps, desc

    # -------------------------------------------------- batched pipeline
    def detect_and_compute_batch(self, images):
        """(B, H, W) u8 batch (a tensor on any device, or numpy) → list of
        (keypoints, descriptors).  The pyramids and masks of the whole batch
        on the device, one read-back, then the host tails per image."""
        imgs = as_tensor(images)
        if imgs.ndim == 2:
            imgs = imgs[None]
        gpyr, dog = self.build_pyramids(imgs)
        masks = self.extrema_masks(dog)
        gpyr_np, dog_np, masks_np = self.read_back(gpyr, dog, masks)
        del gpyr, dog, masks
        return [self.host_tails(gpyr_np, dog_np, masks_np, b) for b in range(imgs.shape[0])]

    # ------------------------------------------------------------- detect
    def detectAndCompute(self, image, mask=None):
        img = as_tensor(image)
        if img.ndim == 3:
            img = cvtColor(img, K.COLOR_BGR2GRAY)
        return self.detect_and_compute_batch(img[None])[0]

    def detect(self, image, mask=None):
        return self.detectAndCompute(image, mask)[0]

    def _refine(self, dogo, octv, layer, r, c):
        """Subpixel 3D quadratic refinement (adjustLocalExtrema)."""
        img_scale = 1.0 / 255.0
        deriv_scale = img_scale * 0.5
        second_scale = img_scale
        cross_scale = img_scale * 0.25
        li, y, x = layer, r, c
        H, W = dogo[0].shape
        for step in range(_MAX_STEPS):
            prev_, cur, nxt = dogo[li - 1], dogo[li], dogo[li + 1]
            dD = np.array([
                (cur[y, x + 1] - cur[y, x - 1]) * deriv_scale,
                (cur[y + 1, x] - cur[y - 1, x]) * deriv_scale,
                (nxt[y, x] - prev_[y, x]) * deriv_scale])
            v2 = cur[y, x] * 2
            dxx = (cur[y, x + 1] + cur[y, x - 1] - v2) * second_scale
            dyy = (cur[y + 1, x] + cur[y - 1, x] - v2) * second_scale
            dss = (nxt[y, x] + prev_[y, x] - v2) * second_scale
            dxy = (cur[y + 1, x + 1] - cur[y + 1, x - 1]
                   - cur[y - 1, x + 1] + cur[y - 1, x - 1]) * cross_scale
            dxs = (nxt[y, x + 1] - nxt[y, x - 1]
                   - prev_[y, x + 1] + prev_[y, x - 1]) * cross_scale
            dys = (nxt[y + 1, x] - nxt[y - 1, x]
                   - prev_[y + 1, x] + prev_[y - 1, x]) * cross_scale
            Hm = np.array([[dxx, dxy, dxs], [dxy, dyy, dys], [dxs, dys, dss]])
            try:
                X = np.linalg.solve(Hm, dD)
            except np.linalg.LinAlgError:
                return None
            xi, xr, xc = -X[2], -X[1], -X[0]
            if abs(xi) < 0.5 and abs(xr) < 0.5 and abs(xc) < 0.5:
                break
            if max(abs(xi), abs(xr), abs(xc)) > 1e9 / 255:
                return None
            x += int(np.rint(xc))
            y += int(np.rint(xr))
            li += int(np.rint(xi))
            if (li < 1 or li > self.n_layers
                    or x < _IMG_BORDER or x >= W - _IMG_BORDER
                    or y < _IMG_BORDER or y >= H - _IMG_BORDER):
                return None
        else:
            return None

        # contrast
        t = np.dot(dD, np.array([xc, xr, xi]))
        contr = dogo[li][y, x] * img_scale + t * 0.5
        if abs(contr) * self.n_layers < self.contrast:
            return None
        # edge response
        tr = dxx + dyy
        det = dxx * dyy - dxy * dxy
        e = self.edge
        if det <= 0 or tr * tr * e >= (e + 1) * (e + 1) * det:
            return None

        kp = KeyPoint(
            (x + xc) * (1 << octv) / 2.0,  # firstOctave=-1 → scale /2
            (y + xr) * (1 << octv) / 2.0,
            self.sigma * (2 ** ((li + xi) / self.n_layers)) * (1 << octv),
            -1, abs(contr))
        kp.octave = octv + (li << 8)
        kp.class_id = li
        kp._oct_pos = (octv, li, (x + xc), (y + xr))
        kp._scl_octv = self.sigma * (2 ** ((li + xi) / self.n_layers))
        return kp

    def _orientations(self, gocts, kp):
        octv, li, xf, yf = kp._oct_pos
        scl = kp._scl_octv
        img = gocts[li]
        H, W = img.shape
        radius = int(np.rint(_ORI_RADIUS * scl))
        sigma = _ORI_SIG * scl
        x0 = int(np.rint(xf))
        y0 = int(np.rint(yf))
        hist = np.zeros(_ORI_BINS)
        ys = np.arange(max(y0 - radius, 1), min(y0 + radius + 1, H - 1))
        xs = np.arange(max(x0 - radius, 1), min(x0 + radius + 1, W - 1))
        if len(ys) < 1 or len(xs) < 1:
            return []
        Y, X = np.meshgrid(ys, xs, indexing="ij")
        dx = img[Y, np.clip(X + 1, 0, W - 1)] - img[Y, np.clip(X - 1, 0, W - 1)]
        dy = img[np.clip(Y - 1, 0, H - 1), X] - img[np.clip(Y + 1, 0, H - 1), X]
        mag = np.hypot(dx, dy)
        ang = np.degrees(np.arctan2(dy, dx)) % 360.0
        w = np.exp(-(((Y - y0) ** 2 + (X - x0) ** 2)
                     / (2 * sigma * sigma)))
        binf = np.rint(ang * (_ORI_BINS / 360.0)).astype(int) % _ORI_BINS
        np.add.at(hist, binf, mag * w)
        # circular smooth with the reference's (1,4,6,4,1)/16 kernel
        hist = (np.roll(hist, 1) * 4 + hist * 6 + np.roll(hist, -1) * 4
                + np.roll(hist, 2) + np.roll(hist, -2)) / 16.0
        mx = hist.max()
        out = []
        for b in range(_ORI_BINS):
            l_ = hist[(b - 1) % _ORI_BINS]
            r_ = hist[(b + 1) % _ORI_BINS]
            if hist[b] > l_ and hist[b] > r_ and hist[b] >= _PEAK_RATIO * mx:
                bin_ = b + 0.5 * (l_ - r_) / (l_ - 2 * hist[b] + r_)
                bin_ = bin_ % _ORI_BINS
                angle = 360.0 - bin_ * (360.0 / _ORI_BINS)
                if abs(angle - 360.0) < 1e-7:
                    angle = 0.0
                k2 = KeyPoint(kp.pt[0], kp.pt[1], kp.size, angle,
                              kp.response, kp.octave, kp.class_id)
                k2._oct_pos = kp._oct_pos
                k2._scl_octv = kp._scl_octv
                out.append(k2)
        return out

    def _describe(self, gpyr, kps):
        d, n = _DESCR_W, _DESCR_BINS
        out = np.zeros((len(kps), d * d * n), np.float32)
        for idx, kp in enumerate(kps):
            octv, li, xf, yf = kp._oct_pos
            img = gpyr[octv][li]
            H, W = img.shape
            scl = kp._scl_octv
            angle = 360.0 - kp.angle
            if abs(angle - 360.0) < 1e-7:
                angle = 0.0
            cos_t = math.cos(math.radians(angle))
            sin_t = math.sin(math.radians(angle))
            hist_width = _DESCR_SCL * scl
            radius = int(np.rint(hist_width * math.sqrt(2)
                                 * (d + 1) * 0.5))
            radius = min(radius, int(math.sqrt(H * H + W * W)))
            cos_t /= hist_width
            sin_t /= hist_width
            x0 = int(np.rint(xf))
            y0 = int(np.rint(yf))
            hist = np.zeros((d + 2, d + 2, n + 2))
            ys = np.arange(-radius, radius + 1)
            xs = np.arange(-radius, radius + 1)
            Y, X = np.meshgrid(ys, xs, indexing="ij")
            # reference rotation: c_rot = j·cosθ − i·sinθ,
            # r_rot = j·sinθ + i·cosθ (calcSIFTDescriptor)
            c_rot = X * cos_t - Y * sin_t
            r_rot = X * sin_t + Y * cos_t
            rbin = r_rot + d / 2 - 0.5
            cbin = c_rot + d / 2 - 0.5
            yy = Y + y0
            xx = X + x0
            ok = ((rbin > -1) & (rbin < d) & (cbin > -1) & (cbin < d)
                  & (yy > 0) & (yy < H - 1) & (xx > 0) & (xx < W - 1))
            yv, xv = yy[ok], xx[ok]
            dx = img[yv, xv + 1] - img[yv, xv - 1]
            dy = img[yv - 1, xv] - img[yv + 1, xv]
            mag = np.hypot(dx, dy)
            ang = (np.degrees(np.arctan2(dy, dx)) - angle) % 360.0
            obin = ang * (n / 360.0)
            w = np.exp((c_rot[ok] ** 2 + r_rot[ok] ** 2)
                       * (-1.0 / (d * d * 0.5)))
            m = mag * w
            rb = rbin[ok]
            cb = cbin[ok]
            r0 = np.floor(rb).astype(int)
            c0 = np.floor(cb).astype(int)
            o0 = np.floor(obin).astype(int)
            fr = rb - r0
            fc = cb - c0
            fo = obin - o0
            for dr in (0, 1):
                for dcol in (0, 1):
                    for do in (0, 1):
                        wgt = (m * (fr if dr else 1 - fr)
                               * (fc if dcol else 1 - fc)
                               * (fo if do else 1 - fo))
                        np.add.at(hist, (r0 + 1 + dr, c0 + 1 + dcol,
                                         (o0 + do) % n), wgt)
            v = hist[1:-1, 1:-1, :n].ravel()
            nrm = math.sqrt((v * v).sum())
            v = np.minimum(v, _DESCR_MAG_THR * nrm)
            nrm = _INT_FCTR / max(math.sqrt((v * v).sum()),
                                  np.finfo(np.float32).eps)
            out[idx] = np.clip(np.rint(v * nrm), 0, 255)
        return out

    def compute(self, image, keypoints):
        kps, desc = self.detectAndCompute(image)
        return kps, desc


def SIFT_create(nfeatures=0, nOctaveLayers=3, contrastThreshold=0.04,
                edgeThreshold=10.0, sigma=1.6):
    return SIFT(nfeatures, nOctaveLayers, contrastThreshold, edgeThreshold,
                sigma)
