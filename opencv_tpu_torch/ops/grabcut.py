"""GrabCut segmentation (imgproc/src/grabcut.cpp); twin of
``opencv_tpu/ops/grabcut.py``.

On the image's device, in f64: the n-link weights and their β, each GMM's
per-pixel component likelihoods, the component assignment, the mixture
likelihoods and the two ``-log`` terminal maps, and the sums a GMM learns
from (counts, colour sums and second moments per component, as one-hot
products: exact for u8 colours, in any order, so equal to numpy's).  On the
host, in numpy as the JAX package has them: each component's 3×3 ``det`` and
``inv``, and the models' pack and unpack.  The min cut is the port's native
``maxflow_grid``: the two terminal planes are read to the host once per
iteration (the four n-link planes once per call) and the cut goes back to
the device.  kmeans (``ops/cluster.py``) seeds the GMMs, on the device.

The likelihoods' ``exp`` and ``log`` and the quadratic form (numpy's
``einsum``) are not numpy's to the last bit, nor the card's the CPU's; a
last-bit change of a capacity almost never moves a min cut, and the tests
hold the mask to the JAX package's within 0.01% of its pixels.
``_py_maxflow`` is the plain version of the native cut, for the tests.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import native
from ..core.arrays import as_tensor, to_device
from .cluster import KMEANS_PP_CENTERS, kmeans

__all__ = ["grabCut", "GC_BGD", "GC_FGD", "GC_PR_BGD", "GC_PR_FGD",
           "GC_INIT_WITH_RECT", "GC_INIT_WITH_MASK", "GC_EVAL"]

GC_BGD = 0
GC_FGD = 1
GC_PR_BGD = 2
GC_PR_FGD = 3
GC_INIT_WITH_RECT = 0
GC_INIT_WITH_MASK = 1
GC_EVAL = 2
GC_EVAL_FREEZE_MODEL = 3

_NCOMP = 5
_F64 = torch.float64


class _GMM:
    """5-component full-covariance GMM (grabcut.cpp:60): the parameters on
    the host, the per-pixel work on the device."""

    def __init__(self, model=None):
        self.coefs = np.zeros(_NCOMP)
        self.means = np.zeros((_NCOMP, 3))
        self.covs = np.zeros((_NCOMP, 3, 3))
        self.icovs = np.zeros((_NCOMP, 3, 3))
        self.dets = np.ones(_NCOMP)
        if model is not None and np.asarray(model).size == 13 * _NCOMP:
            m = np.asarray(model, np.float64).ravel()
            self.coefs = m[:_NCOMP].copy()
            self.means = m[_NCOMP:4 * _NCOMP].reshape(_NCOMP, 3).copy()
            self.covs = m[4 * _NCOMP:].reshape(_NCOMP, 3, 3).copy()
            for ci in range(_NCOMP):
                if self.coefs[ci] > 0:
                    self._inv(ci, 0.0)

    def _inv(self, ci, fix):
        c = self.covs[ci]
        det = np.linalg.det(c)
        if det <= 1e-6 and fix > 0:
            c = c + np.eye(3) * fix
            self.covs[ci] = c
            det = np.linalg.det(c)
        self.dets[ci] = det
        self.icovs[ci] = np.linalg.inv(c)

    def _table(self, device) -> torch.Tensor:
        """(5, 14) f64 on `device`: per component its mean, inverse
        covariance and sqrt(det) (1 for a component of weight 0)."""
        sqrt_det = np.sqrt(np.where(self.coefs > 0, self.dets, 1.0))
        tab = np.concatenate([self.means, self.icovs.reshape(_NCOMP, 9), sqrt_det[:, None]],
                             axis=1)
        return to_device(tab, device)

    def pdf_comp(self, colors: torch.Tensor) -> torch.Tensor:
        """(n, 3) f64 -> (n, 5) f64 per-component likelihoods (0 for a
        component of weight 0)."""
        tab = self._table(colors.device)
        d = colors[:, None, :] - tab[:, :3]                       # (n, 5, 3)
        mult = torch.zeros(d.shape[:2], dtype=_F64, device=colors.device)
        for i in range(3):
            for j in range(3):
                mult = mult + d[..., i] * tab[:, 3 + 3 * i + j] * d[..., j]
        out = torch.exp(-0.5 * mult) / tab[:, 12]
        return torch.where(to_device(self.coefs > 0, colors.device), out, 0.0)

    def pdf(self, colors: torch.Tensor) -> torch.Tensor:
        pc = self.pdf_comp(colors)
        w = to_device(self.coefs, colors.device)
        out = pc[:, 0] * w[0]
        for ci in range(1, _NCOMP):
            out = out + pc[:, ci] * w[ci]
        return out

    def which(self, colors: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self.pdf_comp(colors), dim=1)

    def learn(self, stats: np.ndarray, total: int):
        """Learn from the host (5, 13) f64 ``[count, colour sums, second
        moments]`` per component of a sample set of `total` colours."""
        for ci in range(_NCOMP):
            n = stats[ci, 0]
            if n == 0:
                self.coefs[ci] = 0
                continue
            self.coefs[ci] = n / total
            mu = stats[ci, 1:4] / n
            self.means[ci] = mu
            self.covs[ci] = stats[ci, 4:].reshape(3, 3) / n - np.outer(mu, mu)
            self._inv(ci, 0.01)

    def pack(self):
        return np.concatenate([self.coefs, self.means.ravel(),
                               self.covs.reshape(_NCOMP, 9).ravel()]).reshape(1, -1)


def _sample_stats(colors: torch.Tensor, outer: torch.Tensor, comp: torch.Tensor,
                  weight: torch.Tensor | None = None) -> torch.Tensor:
    """(5, 13) f64 per component: the count, the colour sums and the second
    moments of the colours assigned to it (and selected by `weight`), as one
    one-hot product: exact sums of integers, so order-free."""
    ks = torch.arange(_NCOMP, device=colors.device)
    onehot = comp.reshape(-1, 1) == ks
    if weight is not None:
        onehot &= weight[:, None]
    onehot = onehot.to(_F64)
    return onehot.T @ torch.cat([torch.ones_like(colors[:, :1]), colors, outer], dim=1)


def _nweights(img: torch.Tensor, beta: float, gamma: float):
    """The four n-link planes (left, up-left, up, up-right) of an (H, W, 3)
    image, f64 on its device."""
    c = img.to(_F64)
    g2 = gamma / np.sqrt(2.0)
    H, W = img.shape[:2]
    nb = torch.tensor(-beta, dtype=_F64, device=img.device)

    def w(a, b, g):
        return g * torch.exp(nb * ((a - b) ** 2).sum(-1))

    left, upleft, up, upright = (torch.zeros((H, W), dtype=_F64, device=img.device)
                                 for _ in range(4))
    left[:, 1:] = w(c[:, 1:], c[:, :-1], gamma)
    upleft[1:, 1:] = w(c[1:, 1:], c[:-1, :-1], g2)
    up[1:] = w(c[1:], c[:-1], gamma)
    upright[1:, :-1] = w(c[1:, :-1], c[:-1, 1:], g2)
    return left, upleft, up, upright


def _calc_beta(img: torch.Tensor) -> float:
    """β from the four neighbour directions' squared colour differences:
    the sum is an exact integer (one host read), then the JAX package's
    f64 formula."""
    c = img.to(torch.int64)
    H, W = img.shape[:2]
    s = sum(((a - b) ** 2).sum() for a, b in ((c[:, 1:], c[:, :-1]), (c[1:, 1:], c[:-1, :-1]),
                                              (c[1:], c[:-1]), (c[1:, :-1], c[:-1, 1:])))
    s = float(int(s))
    if s <= np.finfo(np.float64).eps:
        return 0.0
    return 1.0 / (2 * s / (4 * W * H - 3 * W - 3 * H + 2))


def _py_maxflow(srcw, snkw, left, upleft, up, upright):
    """The JAX package's pure-Python Dinic: the plain version of the native
    cut (host numpy in, the (H, W) bool source side out; small images)."""
    H, W = srcw.shape
    N = H * W
    import collections
    graph = [[] for _ in range(N + 2)]

    def add(a, b, cab, cba):
        graph[a].append([b, cab, len(graph[b])])
        graph[b].append([a, cba, len(graph[a]) - 1])

    S, T = N, N + 1
    for i in range(N):
        if srcw.flat[i] > 0:
            add(S, i, srcw.flat[i], 0)
        if snkw.flat[i] > 0:
            add(i, T, snkw.flat[i], 0)
    for y in range(H):
        for x in range(W):
            i = y * W + x
            if x > 0 and left[y, x] > 0:
                add(i, i - 1, left[y, x], left[y, x])
            if x > 0 and y > 0 and upleft[y, x] > 0:
                add(i, i - W - 1, upleft[y, x], upleft[y, x])
            if y > 0 and up[y, x] > 0:
                add(i, i - W, up[y, x], up[y, x])
            if x < W - 1 and y > 0 and upright[y, x] > 0:
                add(i, i - W + 1, upright[y, x], upright[y, x])

    def bfs():
        level = [-1] * (N + 2)
        level[S] = 0
        q = collections.deque([S])
        while q:
            v = q.popleft()
            for e in graph[v]:
                if e[1] > 1e-12 and level[e[0]] < 0:
                    level[e[0]] = level[v] + 1
                    q.append(e[0])
        return level if level[T] >= 0 else None

    def dfs(level, it, v, f):
        if v == T:
            return f
        while it[v] < len(graph[v]):
            e = graph[v][it[v]]
            if e[1] > 1e-12 and level[v] < level[e[0]]:
                d = dfs(level, it, e[0], min(f, e[1]))
                if d > 0:
                    e[1] -= d
                    graph[e[0]][e[2]][1] += d
                    return d
            it[v] += 1
        return 0

    import sys
    sys.setrecursionlimit(10000 + N)
    while True:
        level = bfs()
        if level is None:
            break
        it = [0] * (N + 2)
        while dfs(level, it, S, float("inf")) > 0:
            pass
    vis = np.zeros(N + 2, bool)
    q = collections.deque([S])
    vis[S] = True
    while q:
        v = q.popleft()
        for e in graph[v]:
            if e[1] > 1e-12 and not vis[e[0]]:
                vis[e[0]] = True
                q.append(e[0])
    return vis[:N].reshape(H, W)


def grabCut(img, mask, rect, bgdModel=None, fgdModel=None, iterCount=1, mode=GC_EVAL,
            stats=None):
    """cv2.grabCut (imgproc/src/grabcut.cpp:548): ``(mask, bgdModel,
    fgdModel)``, the (H, W) u8 mask as the image came (a tensor on its
    device, or numpy), the two (1, 65) f64 models as numpy.  `stats` (this
    port's addition), if a dict, receives the host ms of each min cut
    (``maxflow_ms``)."""
    x = as_tensor(img)
    if x.ndim != 3 or x.shape[2] != 3 or x.dtype != torch.uint8:
        raise ValueError(f"grabCut needs an 8UC3 image, got {tuple(x.shape)} {x.dtype}")
    dev = x.device
    H, W = x.shape[:2]
    m = as_tensor(mask) if mask is not None and as_tensor(mask).numel() else None
    mask_d = to_device(m, dev).to(torch.uint8).clone() if m is not None \
        else torch.zeros((H, W), dtype=torch.uint8, device=dev)

    colors = x.reshape(-1, 3).to(_F64)
    outer = (colors[:, :, None] * colors[:, None, :]).reshape(-1, 9)
    bgd = _GMM(bgdModel if bgdModel is not None and np.asarray(bgdModel).size else None)
    fgd = _GMM(fgdModel if fgdModel is not None and np.asarray(fgdModel).size else None)

    if mode == GC_INIT_WITH_RECT:
        mask_d.fill_(GC_BGD)
        rx, ry, rw, rh = rect
        x0, y0 = max(0, rx), max(0, ry)
        mask_d[y0:min(H, ry + rh), x0:min(W, rx + rw)] = GC_PR_FGD
    if mode in (GC_INIT_WITH_RECT, GC_INIT_WITH_MASK):
        bgd_idx = ((mask_d == GC_BGD) | (mask_d == GC_PR_BGD)).reshape(-1)
        for gmm, sel in ((bgd, bgd_idx), (fgd, ~bgd_idx)):
            samples = colors[sel]
            kk = min(_NCOMP, len(samples))
            _, labels, _ = kmeans(samples.to(torch.float32), kk, None, (1, 10, 0.0), 3,
                                  KMEANS_PP_CENTERS)
            gmm.learn(_sample_stats(samples, outer[sel], labels).cpu().numpy(), len(samples))

    def out(mk):
        return (mk if isinstance(img, torch.Tensor) else mk.cpu().numpy()), bgd.pack(), fgd.pack()

    if iterCount <= 0:
        return out(mask_d)

    gamma = 50.0
    lam = 9 * gamma
    beta = _calc_beta(x)
    links = [p.cpu().numpy() for p in _nweights(x, beta, gamma)]
    lam_t = torch.tensor(lam, dtype=_F64, device=dev)
    zero = torch.zeros((), dtype=_F64, device=dev)

    for _ in range(max(iterCount, 1)):
        bgd_idx = ((mask_d == GC_BGD) | (mask_d == GC_PR_BGD)).reshape(-1)
        if mode != GC_EVAL_FREEZE_MODEL:
            comp = torch.where(bgd_idx, bgd.which(colors), fgd.which(colors))
            both = torch.stack([_sample_stats(colors, outer, comp, bgd_idx),
                                _sample_stats(colors, outer, comp, ~bgd_idx)]).cpu().numpy()
            n_bgd = int(both[0, :, 0].sum())
            bgd.learn(both[0], n_bgd)
            fgd.learn(both[1], H * W - n_bgd)

        pb = torch.clamp(bgd.pdf(colors), min=1e-300).reshape(H, W)
        pf = torch.clamp(fgd.pdf(colors), min=1e-300).reshape(H, W)
        soft = (mask_d == GC_PR_BGD) | (mask_d == GC_PR_FGD)
        hard_bgd = mask_d == GC_BGD
        src = torch.where(soft, -torch.log(pb), torch.where(hard_bgd, zero, lam_t))
        snk = torch.where(soft, -torch.log(pf), torch.where(hard_bgd, lam_t, zero))
        terminals = torch.stack([src, snk]).cpu().numpy()
        t0 = time.perf_counter()
        fg = native.maxflow_grid(terminals[0], terminals[1], *links)
        if stats is not None:
            stats.setdefault("maxflow_ms", []).append((time.perf_counter() - t0) * 1e3)
        fg_d = to_device(fg, dev)
        mask_d = torch.where(soft, torch.where(fg_d, GC_PR_FGD, GC_PR_BGD).to(torch.uint8),
                             mask_d)

    return out(mask_d)
