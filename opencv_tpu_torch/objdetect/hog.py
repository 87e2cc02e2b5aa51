"""HOG descriptor + people detection (objdetect/src/hog.cpp); twin of
``opencv_tpu/objdetect/hog.py``.

compute() follows the reference's exact window layout — blocks
column-major within the window, cells column-major within the block
(HOGCache histOfs = (x*nblocks.height + y)), trilinear cell
interpolation and Gaussian block weighting (winSigma=4), L2-Hys — so
the bundled INRIA people SVM (hog_detectors.npz, extracted from
getDefaultPeopleDetector) scores windows exactly as the reference
pipeline expects.

The JAX package builds the per-pixel vote volume and every window's
descriptor in numpy; at 1080p that is two (134, 239, 256, 9) f32 volumes
and a 27,960 x 3,780 descriptor matrix.  The port works on the image's device
(a numpy image is a CPU tensor) and materialises neither:

- the votes are a 9-channel image (each pixel's magnitude split between its
  two bins), and the block histograms are one strided, grouped
  ``F.conv2d`` of it with the fixed (16, 16) trilinear-and-Gaussian stencil
  of each cell;
- the window scores are one ``F.conv2d`` of the normalised 36-channel block
  map with the SVM's weights laid out as the descriptor orders them.

Both convolutions run in full float32 (cuDNN without TF32).  Their sums
run in another order than numpy's einsum and matrix product, and than each
other on the card and the CPU, so the scores agree within a float32 bound,
not bit for bit.  The square root, the gradient's magnitude and its angle
are taken in float64 and rounded to float32 once (torch's float32 ``sqrt``,
``hypot`` and ``atan2`` round differently on the card and the CPU).
``detectMultiScale`` keeps the JAX package's loop of scales, and like it
ignores ``padding``.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..core.arrays import as_tensor, to_device, to_host
from ..dnn import exact_f32

__all__ = ["HOGDescriptor", "groupRectangles"]

_DETECTORS = None


def _detectors():
    global _DETECTORS
    if _DETECTORS is None:
        path = os.path.join(os.path.dirname(__file__), "hog_detectors.npz")
        _DETECTORS = dict(np.load(path))
    return _DETECTORS


# numpy's float32 square root of every u8 value (the reference's gamma LUT)
_SQRT_U8 = np.sqrt(np.arange(256, dtype=np.float32))


def groupRectangles(rectList, groupThreshold, eps=0.2):
    """cv2.groupRectangles: cluster similar rects, average, drop small
    clusters (objdetect/src/cascadedetect.cpp groupRectangles)."""
    rects = [list(map(float, r)) for r in rectList]
    n = len(rects)
    labels = [-1] * n
    nclass = 0

    def similar(a, b):
        delta = eps * (min(a[2], b[2]) + min(a[3], b[3])) * 0.5
        return (abs(a[0] - b[0]) <= delta and abs(a[1] - b[1]) <= delta
                and abs(a[0] + a[2] - b[0] - b[2]) <= delta
                and abs(a[1] + a[3] - b[1] - b[3]) <= delta)

    for i in range(n):
        if labels[i] >= 0:
            continue
        labels[i] = nclass
        for j in range(n):
            if labels[j] < 0 and similar(rects[i], rects[j]):
                labels[j] = nclass
        nclass += 1
    out = []
    weights = []
    for c in range(nclass):
        grp = [rects[i] for i in range(n) if labels[i] == c]
        if len(grp) <= groupThreshold:
            continue
        m = np.mean(grp, axis=0)
        out.append([int(round(v)) for v in m])
        weights.append(len(grp))
    return np.array(out, np.int32).reshape(-1, 4), \
        np.array(weights, np.int32)


class HOGDescriptor:
    def __init__(self, winSize=(64, 128), blockSize=(16, 16),
                 blockStride=(8, 8), cellSize=(8, 8), nbins=9):
        self.win_size = winSize
        self.block_size = blockSize
        self.block_stride = blockStride
        self.cell_size = cellSize
        self.nbins = nbins
        self.svm = None
        self._tables = {}

    @staticmethod
    def getDefaultPeopleDetector():
        return _detectors()["default"].copy()

    @staticmethod
    def getDaimlerPeopleDetector():
        return _detectors()["daimler"].copy()

    def setSVMDetector(self, detector):
        self.svm = np.asarray(to_host(detector), np.float32).ravel()
        self._tables = {k: v for k, v in self._tables.items() if k[0] != "svm"}

    def getDescriptorSize(self):
        bw = (self.win_size[0] - self.block_size[0]) \
            // self.block_stride[0] + 1
        bh = (self.win_size[1] - self.block_size[1]) \
            // self.block_stride[1] + 1
        cells = (self.block_size[0] // self.cell_size[0]) \
            * (self.block_size[1] // self.cell_size[1])
        return bw * bh * cells * self.nbins

    def _window_blocks(self):
        wbx = (self.win_size[0] - self.block_size[0]) // self.block_stride[0] + 1
        wby = (self.win_size[1] - self.block_size[1]) // self.block_stride[1] + 1
        return wbx, wby

    # ------------------------------------------------- device tables

    def _stencil(self) -> np.ndarray:
        """The (bwc, bhc, bh, bw) weight of each block pixel in each cell's
        histogram: trilinear cell interpolation times the block's Gaussian
        (the JAX package's S, laid out as the pixel's row and column)."""
        bw, bh = self.block_size
        cw, ch = self.cell_size
        bwc, bhc = bw // cw, bh // ch
        sigma = (bw + bh) / 8.0
        jj, ii = np.meshgrid(np.arange(bw), np.arange(bh))
        dj = jj - bw * 0.5
        di = ii - bh * 0.5
        gauss = np.exp(-(di * di + dj * dj) / (2 * sigma * sigma)
                       ).astype(np.float32)
        cxf = (jj - (cw - 1) * 0.5) / cw
        cyf = (ii - (ch - 1) * 0.5) / ch
        icx0 = np.floor(cxf).astype(int)
        icy0 = np.floor(cyf).astype(int)
        fx = (cxf - icx0).astype(np.float32)
        fy = (cyf - icy0).astype(np.float32)
        S = np.zeros((bwc, bhc, bh, bw), np.float32)
        for dyc in (0, 1):
            for dxc in (0, 1):
                tcx = icx0 + dxc
                tcy = icy0 + dyc
                wxy = (fx if dxc else (1 - fx)) * (fy if dyc else (1 - fy))
                valid = (tcx >= 0) & (tcx < bwc) & (tcy >= 0) & (tcy < bhc)
                wmap = (wxy * gauss * valid)
                ys, xs = np.nonzero(valid)
                for i, j in zip(ys, xs):
                    S[tcx[i, j], tcy[i, j], i, j] += wmap[i, j]
        return S

    def _table(self, name: str, device) -> torch.Tensor:
        key = (name, str(device))
        if key not in self._tables:
            nb = self.nbins
            if name == "sqrt":
                t = _SQRT_U8
            elif name == "votes":
                S = self._stencil()
                cells = S.shape[0] * S.shape[1]
                # groups = bins: filter b * cells + c is cell c's stencil
                t = np.tile(S.reshape(cells, 1, *S.shape[2:]), (nb, 1, 1, 1))
            else:   # "svm": the weights as a (1, 36, wby, wbx) filter
                wbx, wby = self._window_blocks()
                w = self.svm[:-1].reshape(wbx, wby, -1)
                t = np.ascontiguousarray(w.transpose(2, 1, 0)[None])
            self._tables[key] = to_device(t, device)
        return self._tables[key]

    # ------------------------------------------------- block histograms

    def _gradients(self, img: torch.Tensor):
        """Magnitude and unsigned angle (float32) of an (H, W) or (H, W, C)
        image, the strongest channel's where there are several."""
        if img.dtype == torch.uint8:
            f = self._table("sqrt", img.device)[img.to(torch.int64)]
        else:
            f = torch.sqrt(img.to(torch.float64)).to(torch.float32)
        H, W = f.shape[:2]
        dev = f.device
        xi = torch.arange(-1, W + 1, device=dev).clamp(0, W - 1)
        yi = torch.arange(-1, H + 1, device=dev).clamp(0, H - 1)
        p = f[yi][:, xi]
        gx = p[1:-1, 2:] - p[1:-1, :-2]
        gy = p[2:, 1:-1] - p[:-2, 1:-1]
        if f.ndim == 3:
            # per-channel gradient, keep the strongest (hog.cpp
            # computeGradient)
            mag2 = gx * gx + gy * gy
            pick = torch.argmax(mag2, dim=-1, keepdim=True)
            gx = torch.gather(gx, -1, pick)[..., 0]
            gy = torch.gather(gy, -1, pick)[..., 0]
        gx64, gy64 = gx.to(torch.float64), gy.to(torch.float64)
        mag = torch.sqrt(gx64 * gx64 + gy64 * gy64).to(torch.float32)
        ang = torch.atan2(gy64, gx64).to(torch.float32)
        ang = torch.where(ang < 0, ang + np.pi, ang)
        return mag, ang

    def _block_hists(self, img: torch.Tensor) -> torch.Tensor:
        """All normalised block histograms over the image: (nby, nbx, 36)
        float32, cells column-major within the block."""
        bw, bh = self.block_size
        sx, sy = self.block_stride
        nb = self.nbins
        mag, ang = self._gradients(img)
        binf = ang * (nb / np.pi) - 0.5
        b0 = torch.floor(binf)
        wb1 = binf - b0
        bin0 = b0.to(torch.int64) % nb
        bin1 = (bin0 + 1) % nb
        m0 = mag * (1 - wb1)
        m1 = mag * wb1
        bins = torch.arange(nb, device=mag.device)[:, None, None]
        votes = (m0 * (bin0 == bins) + m1 * (bin1 == bins))[None]     # (1, nb, H, W)
        with exact_f32():
            hist = F.conv2d(votes, self._table("votes", mag.device), stride=(sy, sx),
                            groups=nb)[0]                              # (nb * cells, nby, nbx)
        cells = hist.shape[0] // nb
        flat = hist.reshape(nb, cells, *hist.shape[1:]).permute(2, 3, 1, 0)
        flat = flat.reshape(*hist.shape[1:], cells * nb)
        # L2-Hys per block (normalizeBlockHistogram: 1/(sqrt(sum)+sz*0.1),
        # clip 0.2, then 1/(sqrt(sum)+1e-3))
        sz = flat.shape[-1]
        norm = torch.sqrt((flat * flat).sum(-1, keepdim=True).to(torch.float64)).to(torch.float32)
        flat = torch.clamp(flat / (norm + sz * 0.1), max=0.2)
        norm = torch.sqrt((flat * flat).sum(-1, keepdim=True).to(torch.float64)).to(torch.float32)
        return flat / (norm + 1e-3)

    @staticmethod
    def _image(img) -> torch.Tensor:
        x = as_tensor(img)
        if x.ndim == 4:
            x = x[0]
        if x.ndim == 3 and x.shape[-1] == 1:
            x = x[..., 0]
        return x

    def _grid(self, H: int, W: int, ws) -> tuple:
        ys = list(range(0, H - self.win_size[1] + 1, ws[1]))
        xs = list(range(0, W - self.win_size[0] + 1, ws[0]))
        return ys, xs

    def compute(self, img, winStride=None, padding=None, locations=None):
        """The descriptors of the windows, (n * 3780, 1) float32 in the JAX
        package's layout, on the image's device."""
        arr = self._image(img)
        hists = self._block_hists(arr)
        sx, sy = self.block_stride
        ws = winStride or self.win_size
        H, W = arr.shape[:2]
        if locations:
            grid = [(py // sy, px // sx) for (px, py) in locations]
        else:
            ys, xs = self._grid(H, W, ws)
            grid = [(y // sy, xx // sx) for y in ys for xx in xs]
        if not grid:
            return torch.zeros((0, 1), dtype=torch.float32, device=arr.device)
        wbx, wby = self._window_blocks()
        g = torch.tensor(grid, dtype=torch.int64, device=arr.device)
        rows = g[:, 0, None, None] + torch.arange(wby, device=arr.device)[None, None, :]
        cols = g[:, 1, None, None] + torch.arange(wbx, device=arr.device)[None, :, None]
        d = hists[rows, cols]                       # (n, wbx, wby, 36)
        return d.reshape(-1, 1)

    def window_scores(self, img, winStride=(8, 8)) -> tuple:
        """Each window's SVM score, (rows, cols) float32 on the image's
        device, and the windows' top-left y and x positions (host lists)."""
        assert self.svm is not None, "call setSVMDetector first"
        arr = self._image(img)
        H, W = arr.shape[:2]
        ys, xs = self._grid(H, W, winStride)
        hists = self._block_hists(arr).permute(2, 0, 1)[None]     # (1, 36, nby, nbx)
        with exact_f32():
            s = F.conv2d(hists, self._table("svm", arr.device))[0, 0]
        sx, sy = self.block_stride
        r = torch.tensor([y // sy for y in ys], dtype=torch.int64, device=arr.device)
        c = torch.tensor([x // sx for x in xs], dtype=torch.int64, device=arr.device)
        return s[r][:, c] + float(self.svm[-1]), ys, xs

    def detect(self, img, hitThreshold=0.0, winStride=(8, 8),
               padding=(0, 0)):
        assert self.svm is not None, "call setSVMDetector first"
        arr = self._image(img)
        H, W = arr.shape[:2]
        if H < self.win_size[1] or W < self.win_size[0]:
            return [], []
        scores, ys, xs = self.window_scores(arr, winStride)
        scores = to_host(scores)
        iy, ix = np.nonzero(scores >= hitThreshold)
        found = [(xs[j], ys[i]) for i, j in zip(iy, ix)]
        weights = [float(scores[i, j]) for i, j in zip(iy, ix)]
        return found, weights

    def scales(self, H: int, W: int, scale=1.05) -> list:
        """detectMultiScale's scale factors for an H x W image."""
        out, s = [], 1.0
        while W / s >= self.win_size[0] and H / s >= self.win_size[1]:
            out.append(s)
            s *= scale
        return out

    def scaled_image(self, arr: torch.Tensor, s: float) -> torch.Tensor:
        from ..ops.resize import resize
        from .. import constants as K
        if s == 1.0:
            return arr
        H, W = arr.shape[:2]
        return resize(arr, (int(W / s), int(H / s)), interpolation=K.INTER_LINEAR)

    def detectMultiScale(self, img, hitThreshold=0.0, winStride=(8, 8),
                         padding=(0, 0), scale=1.05, groupThreshold=2.0,
                         useMeanshiftGrouping=False):
        arr = self._image(img)
        H, W = arr.shape[:2]
        rects = []
        weights = []
        for s in self.scales(H, W, scale):
            locs, ws = self.detect(self.scaled_image(arr, s), hitThreshold, winStride)
            for (xx, y), wgt in zip(locs, ws):
                rects.append((int(xx * s), int(y * s),
                              int(self.win_size[0] * s),
                              int(self.win_size[1] * s)))
                weights.append(wgt)
        if groupThreshold > 0 and rects:
            grouped, counts = groupRectangles(
                rects, int(groupThreshold) - 1, 0.2)
            return grouped, counts.astype(np.float64)
        return np.array(rects, np.int32).reshape(-1, 4), \
            np.array(weights)
