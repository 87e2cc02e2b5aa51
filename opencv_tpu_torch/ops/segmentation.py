"""Segmentation: floodFill, watershed and pyrMeanShiftFiltering
(imgproc/src/floodfill.cpp, segmentation.cpp); twin of
``opencv_tpu/ops/segmentation.py``.

floodFill and watershed are host algorithms with data-dependent frontiers:
a u8 flood fill and every watershed run the port's native host tails
(``native/hosttails.cpp``), other depths the JAX package's breadth-first
fill in Python.  The image is read to the host once and the result written
back to its device.  A missing compiler raises; nothing falls back.
:func:`watershed_frames` floods the frames of a batch in parallel host
threads (ctypes releases the GIL), one frame per thread.  ``_flood_py`` and
``_watershed_py`` are the plain versions of the native code, for the tests.

pyrMeanShiftFiltering runs on the image's device: the pyramid through
``pyrDown`` (the ``pyr_down`` kernel on a card, C = 3) and ``pyrUp``, and the
mean shift of each level over the pixels still moving only.  Each iteration
compacts them with one ``nonzero`` (its one host read) and gathers their
window offsets in chunks of at most :data:`MS_CHUNK_BYTES`, one batched
gather per chunk; the sums are exact integers and the means ``rint(sum *
(1/cnt))`` in f64, correctly rounded operations, so the result is the JAX
package's bit for bit on any device.
"""

from __future__ import annotations

import math
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import native
from ..core.arrays import as_tensor
from .linalg import _host

__all__ = ["floodFill", "watershed", "pyrMeanShiftFiltering", "watershed_frames",
           "FLOODFILL_FIXED_RANGE", "FLOODFILL_MASK_ONLY", "MS_CHUNK_BYTES"]

FLOODFILL_FIXED_RANGE = 1 << 16
FLOODFILL_MASK_ONLY = 1 << 17

# the device memory one chunk of mean-shift window offsets may take
MS_CHUNK_BYTES = 1 << 30
# bytes per (pixel, offset) of a chunk: the coordinates, the flat index, the
# gathered colours, their differences and the masked products
_MS_BYTES_PER = 96


def _like(a: np.ndarray, ref):
    """`a` as `ref` came: a tensor on ref's device, or numpy."""
    return torch.from_numpy(a).to(ref.device) if isinstance(ref, torch.Tensor) else a


def _flood_py(img, mask, sx, sy, nv, lo, up, conn, fixed, mask_only, fill_mask_val):
    """The JAX package's breadth-first flood fill: fills `img` and `mask` in
    place; ``(count, rect)``."""
    multi = img.ndim == 3
    H, W = img.shape[:2]
    seed_val = img[sy, sx].astype(np.float64)
    offs = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    if conn == 8:
        offs += [(-1, -1), (-1, 1), (1, -1), (1, 1)]
    filled = np.zeros((H, W), bool)
    q = deque([(sy, sx)])
    filled[sy, sx] = True
    count = 0
    minx, miny, maxx, maxy = sx, sy, sx, sy
    imgf = img.astype(np.float64)
    while q:
        y, x = q.popleft()
        count += 1
        minx, maxx = min(minx, x), max(maxx, x)
        miny, maxy = min(miny, y), max(maxy, y)
        base = seed_val if fixed else imgf[y, x]
        for dy, dx in offs:
            ny, nx = y + dy, x + dx
            if not (0 <= ny < H and 0 <= nx < W) or filled[ny, nx]:
                continue
            if mask[ny + 1, nx + 1]:
                continue
            v = imgf[ny, nx]
            d = v - base if multi else np.array([v - base])
            dd = np.atleast_1d(d)
            if np.all(dd >= -lo[:len(dd)]) and np.all(dd <= up[:len(dd)]):
                filled[ny, nx] = True
                q.append((ny, nx))
    mask[1:-1, 1:-1][filled] = fill_mask_val
    if not mask_only:
        img[filled] = nv
    return count, (minx, miny, maxx - minx + 1, maxy - miny + 1)


def floodFill(image, mask, seedPoint, newVal, loDiff=None, upDiff=None, flags: int = 4):
    """`cv::floodFill` on a copy — ``(retval, image, mask, rect)``, the image
    and mask as the image came (a tensor on its device, or numpy)."""
    img = _host(image).copy()
    multi = img.ndim == 3
    H, W = img.shape[:2]
    mask_h = np.zeros((H + 2, W + 2), np.uint8) if mask is None \
        else np.ascontiguousarray(_host(mask), np.uint8).copy()
    conn = flags & 255 or 4
    fixed = bool(flags & FLOODFILL_FIXED_RANGE)
    mask_only = bool(flags & FLOODFILL_MASK_ONLY)
    fill_mask_val = (flags >> 8) & 255 or 1
    lo = np.zeros(img.shape[2] if multi else 1, np.float64) if loDiff is None \
        else np.asarray(loDiff, np.float64).reshape(-1)
    up = np.zeros_like(lo) if upDiff is None else np.asarray(upDiff, np.float64).reshape(-1)
    sx, sy = int(seedPoint[0]), int(seedPoint[1])
    nv = np.asarray(newVal, img.dtype).reshape(-1)[:img.shape[2]] if multi \
        else np.asarray(newVal).reshape(-1)[0]
    if img.dtype == np.uint8:
        count, rect = native.flood_fill(img, mask_h, (sx, sy), np.atleast_1d(nv), lo, up, conn,
                                        fixed, mask_only, fill_mask_val)
    else:
        count, rect = _flood_py(img, mask_h, sx, sy, nv, lo, up, conn, fixed, mask_only,
                                fill_mask_val)
    return count, _like(img, image), _like(mask_h, image if mask is None else mask), rect


def _watershed_py(img, m):
    """The JAX package's Python watershed: the plain version of the native
    flood, on the (H, W, 3) u8 `img` and the (H, W) int32 `m` in place."""
    IN_QUEUE, WSHED = -2, -1
    H, W = m.shape
    m[0, :] = m[-1, :] = WSHED
    m[:, 0] = m[:, -1] = WSHED
    im = img.astype(np.int32)

    def cdiff(y1, x1, y2, x2):
        return int(np.abs(im[y1, x1] - im[y2, x2]).max())

    q = [deque() for _ in range(256)]
    inner = m[1:H - 1, 1:W - 1]
    inner[inner < 0] = 0
    for i in range(1, H - 1):
        for j in range(1, W - 1):
            if m[i, j] != 0:
                continue
            idx = 256
            if m[i, j - 1] > 0:
                idx = cdiff(i, j, i, j - 1)
            if m[i, j + 1] > 0:
                idx = min(idx, cdiff(i, j, i, j + 1))
            if m[i - 1, j] > 0:
                idx = min(idx, cdiff(i, j, i - 1, j))
            if m[i + 1, j] > 0:
                idx = min(idx, cdiff(i, j, i + 1, j))
            if idx <= 255:
                q[idx].append((i, j))
                m[i, j] = IN_QUEUE
    active = next((k for k in range(256) if q[k]), 256)
    if active == 256:
        return
    while True:
        if not q[active]:
            active = next((k for k in range(active + 1, 256) if q[k]), 256)
            if active == 256:
                break
        i, j = q[active].popleft()
        lab = 0
        for t in (m[i, j - 1], m[i, j + 1], m[i - 1, j], m[i + 1, j]):
            if t > 0:
                if lab == 0:
                    lab = t
                elif t != lab:
                    lab = WSHED
        m[i, j] = lab
        if lab == WSHED:
            continue
        for ni, nj in ((i, j - 1), (i, j + 1), (i - 1, j), (i + 1, j)):
            if m[ni, nj] == 0:
                t = cdiff(i, j, ni, nj)
                q[t].append((ni, nj))
                active = min(active, t)
                m[ni, nj] = IN_QUEUE


def watershed_frames(images, markers, threads: int | None = None) -> np.ndarray:
    """The native watershed of each frame: `images` (N, H, W, 3) u8 and
    `markers` (N, H, W) int32, host arrays or tensors (read to the host
    once); the flooded (N, H, W) int32 markers as a new host array.  The
    frames run in a pool of `threads` host threads (default: one per frame,
    at most the CPUs), each flood on its own frame, so the result equals the
    floods run one after another."""
    img = np.ascontiguousarray(_host(images), np.uint8)
    out = np.ascontiguousarray(_host(markers), np.int32).copy()
    if img.ndim != 4 or img.shape[3] != 3 or out.shape != img.shape[:3]:
        raise ValueError(f"watershed needs (N, H, W, 3) u8 frames and (N, H, W) markers, got "
                         f"{img.shape} and {out.shape}")
    n = len(img)
    workers = threads or max(1, min(n, os.cpu_count() or 1))
    if workers == 1 or n == 1:
        for i in range(n):
            native.watershed(img[i], out[i])
    else:
        native.library()   # build once, before the threads
        with ThreadPoolExecutor(workers) as pool:
            list(pool.map(lambda i: native.watershed(img[i], out[i]), range(n)))
    return out


def watershed(image, markers):
    """Marker-controlled watershed, bit-exact with cv::watershed
    (segmentation.cpp:88-325), through the native flood.  `markers` (H, W)
    int32 is written in place, as cv2 does (a tensor with ``copy_``), and
    returned."""
    img = _host(image)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("watershed needs 8UC3 input")
    out = watershed_frames(img[None], _host(markers)[None])[0]
    if isinstance(markers, torch.Tensor):
        markers.copy_(torch.from_numpy(out))
    else:
        markers[...] = out
    return markers


def _ms_level(src: torch.Tensor, sp: float, isr2: int, max_count: int, eps: float,
              proc: torch.Tensor, stats=None) -> torch.Tensor:
    """One pyramid level of the mean shift (segmentation.cpp:441-543: the
    window bounds ``cvRound(x0 ± sp)`` clipped to the image, the colour test
    against the current colour, cvRound half-even means and the stop test
    on the old colour) over the pixels of `proc`, on src's device.  `src`
    (H, W, 3) u8; returns src with the `proc` pixels replaced."""
    H, W = src.shape[:2]
    dev = src.device
    flat = src.reshape(-1, 3)
    pix = torch.nonzero(proc.reshape(-1)).squeeze(1)
    x0 = (pix % W).to(torch.int32)
    y0 = (pix // W).to(torch.int32)
    c = flat[pix].to(torch.int32)
    active = torch.ones(len(pix), dtype=torch.bool, device=dev)
    # |cvRound(x0 ± sp) - x0| <= ceil(sp): the window's offsets
    R = int(math.ceil(sp))
    d = torch.arange(-R, R + 1, dtype=torch.int32, device=dev)
    dys, dxs = d.repeat_interleave(2 * R + 1), d.repeat(2 * R + 1)
    # a sum over the window: at most (2R + 1)^2 terms of a colour or coordinate
    acc = torch.int32 if (2 * R + 1) ** 2 * max(H, W, 256) < 2 ** 31 else torch.int64
    f64 = torch.float64
    for _ in range(max_count):
        ids = torch.nonzero(active).squeeze(1)
        m = len(ids)
        if stats is not None:
            stats.setdefault("live", []).append(m)
        if m == 0:
            break
        X0, Y0, Cc = x0[ids], y0[ids], c[ids]
        minx = torch.round(X0.to(f64) - sp).clamp(min=0).to(torch.int32)
        maxx = torch.round(X0.to(f64) + sp).clamp(max=W - 1).to(torch.int32)
        miny = torch.round(Y0.to(f64) - sp).clamp(min=0).to(torch.int32)
        maxy = torch.round(Y0.to(f64) + sp).clamp(max=H - 1).to(torch.int32)
        s0 = torch.zeros((m, 3), dtype=acc, device=dev)
        sx = torch.zeros(m, dtype=acc, device=dev)
        sy = torch.zeros(m, dtype=acc, device=dev)
        cnt = torch.zeros(m, dtype=acc, device=dev)
        kc = max(1, min(len(dys), MS_CHUNK_BYTES // (_MS_BYTES_PER * m)))
        if stats is not None:
            stats["chunk_offsets"] = min(stats.get("chunk_offsets", kc), kc)
            stats["chunks"] = stats.get("chunks", 0) + -(-len(dys) // kc)
        for k0 in range(0, len(dys), kc):
            yy = Y0[:, None] + dys[k0:k0 + kc]
            xx = X0[:, None] + dxs[k0:k0 + kc]
            sel = ((yy >= miny[:, None]) & (yy <= maxy[:, None])
                   & (xx >= minx[:, None]) & (xx <= maxx[:, None]))
            t = flat[yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)].to(torch.int32)
            sel &= ((t - Cc[:, None, :]) ** 2).sum(-1) <= isr2
            w = sel.to(acc)
            s0 += (t * w[..., None]).sum(1, dtype=acc)
            sx += (xx * w).sum(1, dtype=acc)
            sy += (yy * w).sum(1, dtype=acc)
            cnt += w.sum(1, dtype=acc)
            del yy, xx, sel, t, w
        live = cnt > 0
        cf = cnt.clamp(min=1).to(f64)
        icnt = torch.ones_like(cf) / cf
        x1 = torch.round(sx.to(f64) * icnt).to(torch.int32)
        y1 = torch.round(sy.to(f64) * icnt).to(torch.int32)
        sm = torch.round(s0.to(f64) * icnt[:, None]).to(torch.int32)
        moved = (x1 - X0).abs() + (y1 - Y0).abs()
        cdist = ((sm - Cc) ** 2).sum(-1)
        stop = ((x1 == X0) & (y1 == Y0)) | ((moved + cdist).to(f64) <= eps)
        x0[ids] = torch.where(live, x1, X0)
        y0[ids] = torch.where(live, y1, Y0)
        c[ids] = torch.where(live[:, None], sm, Cc)
        active[ids] = live & ~stop
    out = flat.clone()
    out[pix] = c.to(torch.uint8)
    return out.view(H, W, 3)


def _recompute_mask(dst: torch.Tensor, H: int, W: int, isr22: int) -> torch.Tensor:
    """The finer level's pixels to run again: coarse pixels with a colour
    edge in the 8-neighbour sense mark ``(1 + 2(i + 1), 2(j + 1) - 1)``, then
    a 3×3 dilation; (H, W) bool on dst's device."""
    h1, w1 = dst.shape[:2]
    m = torch.zeros((H + 2, W + 2), dtype=torch.bool, device=dst.device)
    if h1 > 2 and w1 > 2:
        d = dst.to(torch.int32)
        ctr = d[1:-1, 1:-1]
        edge = torch.zeros((h1 - 2, w1 - 2), dtype=torch.bool, device=dst.device)
        for oy in (-1, 0, 1):
            for ox in (-1, 0, 1):
                if oy or ox:
                    nb = d[1 + oy:h1 - 1 + oy, 1 + ox:w1 - 1 + ox]
                    edge |= ((nb - ctr) ** 2).sum(-1) >= isr22
        # m (padded by one) at rows 1 + 2(i + 1), columns 2(j + 1) - 1
        m[4:4 + 2 * (h1 - 2):2, 2:2 + 2 * (w1 - 2):2] = edge
    md = torch.zeros((H, W), dtype=torch.bool, device=dst.device)
    for oy in range(3):
        for ox in range(3):
            md |= m[oy:oy + H, ox:ox + W]
    return md


def pyrMeanShiftFiltering(src, sp: float, sr: float, maxLevel: int = 1, termcrit=(3, 5, 1.0),
                          stats=None):
    """cv::pyrMeanShiftFiltering (segmentation.cpp:333-546), bit-exact: a
    Gaussian pyramid, processed top down, where each finer level starts from
    pyrUp of the coarser result and recomputes only the pixels whose coarse
    8-neighbourhood shows a colour edge (>= max(sr², 16)), dilated 3×3.  An
    (H, W, 3) u8 image (a tensor on its device, or numpy); the result as a
    tensor on that device.  `stats` (this port's addition), if a dict,
    receives each iteration's moving pixels (``live``), the chunks and the
    smallest chunk's offsets."""
    from .pyramids import pyrDown, pyrUp
    x = as_tensor(src)
    if x.ndim != 3 or x.shape[2] != 3 or x.dtype != torch.uint8:
        raise ValueError("pyrMeanShiftFiltering needs 8UC3")
    ttype, max_count, eps = int(termcrit[0]), int(termcrit[1]), float(termcrit[2])
    if not ttype & 1:                               # TermCriteria::COUNT
        max_count = 5
    max_count = min(max(max_count, 1), 100)
    if not ttype & 2:                               # TermCriteria::EPS
        eps = 1.0
    eps = max(eps, 0.0)
    isr2 = int(np.rint(sr * sr))
    isr22 = max(isr2, 16)

    src_pyr = [x]
    for _ in range(maxLevel):
        src_pyr.append(pyrDown(src_pyr[-1]))

    dst = None
    for level in range(maxLevel, -1, -1):
        cur = src_pyr[level]
        H, W = cur.shape[:2]
        sp_l = max(sp / (1 << level), 1.0)
        if level < maxLevel:
            up = pyrUp(dst, dstsize=(W, H))
            proc = _recompute_mask(dst, H, W, isr22)
            res = _ms_level(cur, sp_l, isr2, max_count, eps, proc, stats)
            dst = torch.where(proc[..., None], res, up)
        else:
            proc = torch.ones((H, W), dtype=torch.bool, device=cur.device)
            dst = _ms_level(cur, sp_l, isr2, max_count, eps, proc, stats)
    return dst
