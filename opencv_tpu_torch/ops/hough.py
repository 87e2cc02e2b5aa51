"""Hough transforms (imgproc/src/hough.cpp, generalized_hough.cpp); twin
of ``opencv_tpu/ops/hough.py``.

The JAX package builds the line accumulator on the device (one ``bincount``
per angle) and does the rest in host numpy with Python loops over radii,
lines, pixels and hypotheses.  Here every vote is one ``index_add_`` on the
image's device, in chunks, and the host keeps what decides the order of the
results, with the JAX package's own calls:

- **lines**: the edge pixels of a whole batch come from one ``nonzero`` (a
  host read); the angle table is the JAX package's (f64 ``cos / rho``, then
  f32), and ρ is ``round`` of what XLA on the CPU computes for the JAX
  expression ``x·t0 + y·t1`` in f32: it contracts it to ``fma(x, t0,
  y·t1)`` (found by comparing the accumulators at 1080p: 204 of 7.5 M
  votes moved without it).  x·t0 is exact in f64, so the port adds the f32
  product y·t1 to it in f64 and rounds to f32 once;
  the local-maximum test keeps hough.cpp's >/>= rules on the device, and
  only the peaks come back, to be ordered by the same ``np.lexsort``;
- **HoughLinesP**: the samples of every line of a batch are taken on the
  device in f64 (cos and sin from ``math`` on the host, then only + − × ÷,
  which round alike everywhere), and the runs with their gap and length
  rules are found per line in host numpy;
- **HoughCircles**: every (sign, radius, edge pixel) votes in f64 in the
  JAX package's order of operations, the magnitude is ``np.hypot``'s own,
  gathered from a table over the 3×3 Sobel's range (it is not the rounded
  root that the card's sqrt gives), the candidates come back and are
  ordered on the host by the same unstable ``np.argsort``, and each
  centre's radius histogram is numpy's, on the host;
- **HoughLinesPointSet**, **GeneralizedHoughBallard** and **Guil**: the
  transcendentals stay on the host (numpy's), the votes of many hypotheses
  go in one scatter each, ``argsort(kind="stable")`` is ``torch.sort(stable=
  True)`` and ``argmax`` is ``torch.argmax`` (the first maximum).

A vote that falls outside its accumulator goes to a spread of spare slots,
so that no one address takes them all.  Chunks keep the index tensors of a
scatter under :data:`VOTE_CHUNK_BYTES`.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import constants as K
from ..core.arrays import as_tensor, to_batched, to_device
from .canny import Canny
from .color import cvtColor
from .deriv import Sobel

__all__ = ["HoughLines", "HoughLinesWithAccumulator", "HoughLinesP", "HoughCircles",
           "HoughCirclesWithAccumulator", "HoughLinesPointSet", "GeneralizedHoughBallard",
           "createGeneralizedHoughBallard", "GeneralizedHoughGuil",
           "createGeneralizedHoughGuil", "SOBEL3_MAX", "VOTE_CHUNK_BYTES", "hough_accum_batch",
           "hough_circles_batch", "hough_lines_batch", "hough_lines_p_batch", "line_vote_chunks"]

# the device memory one scatter's votes may take (their indices and the
# values they are computed from)
VOTE_CHUNK_BYTES = 1 << 30
# spare slots past an accumulator for the votes that fall outside it
_DUMP = 4096
# HoughLinesP walks the strongest this many lines of each image
P_MAX_LINES = 100


def _chunk(n_per_row: int, bytes_per_vote: int, rows: int) -> int:
    """Rows of `n_per_row` votes each per chunk, within VOTE_CHUNK_BYTES."""
    return max(1, min(rows, VOTE_CHUNK_BYTES // max(1, n_per_row * bytes_per_vote)))


def _vote(acc: torch.Tensor, size: int, flat: torch.Tensor, ok: torch.Tensor):
    """Add one vote at each `flat` index where `ok`; the others go to the
    spare slots past `size`."""
    flat = flat.reshape(-1)
    spare = size + torch.arange(flat.numel(), device=flat.device) % _DUMP
    flat = torch.where(ok.reshape(-1), flat, spare)
    acc.index_add_(0, flat, torch.ones((), dtype=acc.dtype, device=acc.device).expand(
        flat.numel()))


def _dev_scalar(v, device) -> torch.Tensor:
    """An f64 0-dim tensor on `device`: dividing by it is a true division on
    the card, where a host scalar becomes a product with its reciprocal."""
    return torch.tensor(float(v), dtype=torch.float64, device=device)


# ------------------------------------------------------------------ lines

def _line_grid(H: int, W: int, rho: float, theta: float, min_theta: float, max_theta: float):
    """(numangle, numrho, tabs): the (theta, rho) grid of an H x W image and
    the JAX package's (cos, sin) / rho table, f64 rounded to f32."""
    numangle = max(int(np.rint((max_theta - min_theta) / theta)), 1)
    numrho = int(np.rint(((W + H) * 2 + 1) / rho))
    angs = min_theta + np.arange(numangle) * theta
    tabs = np.stack([np.cos(angs) / rho, np.sin(angs) / rho], 1).astype(np.float32)
    return numangle, numrho, tabs


def line_vote_chunks(edges: torch.Tensor, rho: float, theta: float, min_theta: float,
                     max_theta: float, stats=None):
    """The votes of every edge pixel of an (N, H, W) bool batch, one chunk
    of angles at a time: yields ``(flat, ok)``, each vote's index into the
    (N, numangle, numrho) accumulator and whether it falls inside.  `stats`
    (a dict) receives the edge pixel count, the angles per chunk and the
    chunk's bytes."""
    N, H, W = edges.shape
    dev = edges.device
    numangle, numrho, tabs = _line_grid(H, W, rho, theta, min_theta, max_theta)
    tab = to_device(tabs, dev)
    n, ys, xs = torch.nonzero(edges, as_tuple=True)
    E = n.numel()
    xd, yf = xs.to(torch.float64), ys.to(torch.float32)
    base = n * numangle
    # per vote: the f64 product, sum and rho, the f32 product and sum, the
    # int64 index and spare slot
    per_vote = 3 * 8 + 2 * 4 + 2 * 8 + 1
    A = _chunk(E, per_vote, numangle)
    if stats is not None:
        stats.update(edge_pixels=E, angles_per_chunk=A, chunk_bytes=A * E * per_vote)
    for a0 in range(0, numangle, A):
        t = tab[a0:a0 + A]
        # fma(x, t0, f32(y * t1)), rounded once to f32: x * t0 is exact in f64
        v = (xd * t[:, :1].to(torch.float64) + (yf * t[:, 1:]).to(torch.float64))
        r = torch.round(v.to(torch.float32)).to(torch.int64) + (numrho - 1) // 2
        r = r.clamp_min(0)  # jnp.bincount clips below, drops past the end
        a = torch.arange(a0, a0 + len(t), device=dev)[:, None]
        yield (base + a) * numrho + r, r < numrho


def hough_accum_batch(edges: torch.Tensor, rho: float, theta: float, min_theta: float,
                      max_theta: float, stats=None):
    """The vote accumulator of each image of an (N, H, W) bool batch of edge
    maps: ``(acc, numangle, numrho)`` with acc an (N, numangle, numrho)
    int32 tensor on the batch's device, each image's equal to
    ``opencv_tpu.ops.hough._hough_accum``'s.  `stats` as
    :func:`line_vote_chunks`."""
    N, H, W = edges.shape
    numangle, numrho, _ = _line_grid(H, W, rho, theta, min_theta, max_theta)
    size = N * numangle * numrho
    acc = torch.zeros(size + _DUMP, dtype=torch.int32, device=edges.device)
    for flat, ok in line_vote_chunks(edges, rho, theta, min_theta, max_theta, stats):
        _vote(acc, size, flat, ok)
    return acc[:size].reshape(N, numangle, numrho), numangle, numrho


def _line_peaks(acc: torch.Tensor, threshold):
    """hough.cpp findLocalMaximums on the device: the (n, angle, rho)
    indices and votes of every peak, read back once."""
    A = F.pad(acc, (1, 1, 1, 1))
    c = A[:, 1:-1, 1:-1]
    keep = ((c > threshold)
            & (c > A[:, 1:-1, :-2]) & (c >= A[:, 1:-1, 2:])
            & (c > A[:, :-2, 1:-1]) & (c >= A[:, 2:, 1:-1]))
    idx = torch.nonzero(keep)
    votes = c[idx[:, 0], idx[:, 1], idx[:, 2]]
    host = torch.cat([idx, votes[:, None].to(torch.int64)], dim=1).cpu().numpy()
    return host[:, 0], host[:, 1], host[:, 2], host[:, 3].astype(np.int32)


def hough_lines_batch(edges: torch.Tensor, rho: float, theta: float, threshold,
                      min_theta: float = 0.0, max_theta: float = math.pi,
                      with_votes: bool = False, stats=None):
    """HoughLines of each image of an (N, H, W) bool batch of edge maps: a
    list of N results, each as ``HoughLines`` (or with votes, as
    ``HoughLinesWithAccumulator``) returns it."""
    acc, numangle, numrho = hough_accum_batch(edges, rho, theta, min_theta, max_theta, stats)
    n, ai, ri, votes = _line_peaks(acc, threshold)
    out = []
    for i in range(edges.shape[0]):
        f = n == i
        a_i, r_i, v_i = ai[f], ri[f], votes[f]
        order = np.lexsort((a_i * numrho + r_i, -v_i))
        r = (r_i[order] - (numrho - 1) / 2) * rho
        a = min_theta + a_i[order] * theta
        if not len(order):
            out.append(None)
        elif with_votes:   # the 5.x binding returns (N, 3) for this variant
            out.append(np.stack([r, a, v_i[order]], 1).astype(np.float32).reshape(-1, 3))
        else:
            out.append(np.stack([r, a], 1).astype(np.float32).reshape(-1, 1, 2))
    return out


def _edge_batch(image):
    """Channel 0 of `image` as a (1, H, W) bool edge map, as the JAX
    package reads it."""
    x, _ = to_batched(image)
    return x[:1, :, :, 0] != 0


def HoughLines(image, rho: float, theta: float, threshold: int,
               srn: float = 0, stn: float = 0,
               min_theta: float = 0.0, max_theta: float = math.pi):
    """Standard Hough line transform → (N, 1, 2) of (rho, theta)."""
    return hough_lines_batch(_edge_batch(image), rho, theta, threshold, min_theta, max_theta)[0]


def HoughLinesWithAccumulator(image, rho: float, theta: float,
                              threshold: int, srn: float = 0,
                              stn: float = 0, min_theta: float = 0.0,
                              max_theta: float = math.pi,
                              use_edgeval: bool = False):
    """cv::HoughLinesWithAccumulator — (rho, theta, votes) triples
    (hough.cpp HoughLinesStandard with returnVotes)."""
    return hough_lines_batch(_edge_batch(image), rho, theta, threshold, min_theta, max_theta,
                             with_votes=True)[0]


def _runs(pts: np.ndarray, on: np.ndarray, minLineLength, maxLineGap, segs: list):
    """The JAX package's walk along one line's samples: a segment runs over
    on-samples whose gaps (off-samples between two on-samples) stay within
    maxLineGap, and is kept if its ends lie minLineLength apart."""
    p = np.flatnonzero(on)
    if not p.size:
        return
    gaps = np.diff(p) - 1
    cut = np.flatnonzero((gaps >= 1) & (gaps > maxLineGap))
    for s, e in zip(np.r_[p[0], p[cut + 1]], np.r_[p[cut], p[-1]]):
        if math.dist(pts[s], pts[e]) >= minLineLength:
            segs.append((*pts[s], *pts[e]))


def hough_lines_p_batch(edges: torch.Tensor, lines: list, minLineLength: float = 0,
                        maxLineGap: float = 0):
    """HoughLinesP's segments of each image of an (N, H, W) bool batch from
    its HoughLines result (`lines`, one per image): the first
    :data:`P_MAX_LINES` lines of each are sampled on the device in one pass
    and read back once.  A list of N results, each as ``HoughLinesP``
    returns it."""
    N, H, W = edges.shape
    dev = edges.device
    rows = [(i, float(r), math.cos(a), math.sin(a))
            for i, ls in enumerate(lines) if ls is not None
            for r, a in ls.reshape(-1, 2)[:P_MAX_LINES]]
    if not rows:
        return [None] * N
    tab = np.array(rows, np.float64)
    horiz_h = np.abs(tab[:, 3]) > np.abs(tab[:, 2])
    t_dev = to_device(tab, dev)
    img_i, r, c, s = (t_dev[:, k:k + 1] for k in range(4))
    horiz = to_device(horiz_h, dev)[:, None]
    S = max(H, W)
    t = torch.arange(S, dtype=torch.float64, device=dev)[None, :]
    # horizontal-ish lines walk x and solve y, the others walk y and solve x
    other = torch.round((r - t * torch.where(horiz, c, s)) / torch.where(horiz, s, c))
    major_n = torch.where(horiz, W, H)
    minor_n = torch.where(horiz, H, W)
    valid = (t < major_n) & (other >= 0) & (other < minor_n)
    o = torch.where(valid, other, 0).to(torch.int64)
    tt = t.to(torch.int64).expand_as(o)
    ys = torch.where(horiz, o, tt)
    xs = torch.where(horiz, tt, o)
    on = edges[img_i.to(torch.int64).expand_as(o), ys.clamp_max(H - 1), xs.clamp_max(W - 1)]
    host = torch.stack([valid.to(torch.int32), (on & valid).to(torch.int32),
                        o.to(torch.int32)]).cpu().numpy()
    segs = [[] for _ in range(N)]
    idx = np.arange(S)
    for k, (i, _, _, _) in enumerate(rows):
        m = host[0, k].astype(bool)
        major, minor = idx[m], host[2, k][m].astype(np.int64)
        pts = np.stack([major, minor] if horiz_h[k] else [minor, major], 1)
        _runs(pts, host[1, k][m].astype(bool), minLineLength, maxLineGap, segs[i])
    return [np.asarray(sg, np.int32).reshape(-1, 1, 4) if sg else None for sg in segs]


def HoughLinesP(image, rho: float, theta: float, threshold: int,
                minLineLength: float = 0, maxLineGap: float = 0):
    """Probabilistic Hough — returns line segments (x1,y1,x2,y2).

    Deterministic variant: strongest standard-Hough peaks, then segment
    extraction along each line with the gap/length rules of
    HoughLinesProbabilistic."""
    edges = _edge_batch(image)
    lines = hough_lines_batch(edges, rho, theta, threshold)
    return hough_lines_p_batch(edges, lines, minLineLength, maxLineGap)[0]


# ---------------------------------------------------------------- circles

# the largest |dx| or |dy| of a 3x3 Sobel of an 8-bit image: 4 * 255
SOBEL3_MAX = 1020


@functools.lru_cache(maxsize=4)
def _hypot_table(device) -> torch.Tensor:
    """``np.hypot(a, b)`` for 0 <= a, b <= SOBEL3_MAX, flat at a * 1021 + b,
    as an f64 table on `device`.  numpy's hypot is not the correctly rounded
    root: it differs from ``sqrt(a² + b²)`` by an ulp on 25,668 of the 4.2 M
    signed pairs, and the card's sqrt is the rounded root, so the magnitudes
    are numpy's own, gathered (hypot of signed pairs equals that of their
    absolute values; the tests check both)."""
    v = np.arange(SOBEL3_MAX + 1, dtype=np.float64)
    return to_device(np.hypot(v[:, None], v[None, :]).reshape(-1), device)


def hough_circles_batch(x: torch.Tensor, dp: float, minDist: float, param1: float = 100,
                        param2: float = 100, minRadius: int = 0, maxRadius: int = 0,
                        with_votes: bool = False, stats=None):
    """HOUGH_GRADIENT on each image of an (N, H, W, 1) u8 batch: Canny and
    the two CV_16S Sobels run once over the batch, the votes of every image
    go into one scatter per chunk of radii, and the edge pixels and the
    candidate centres come back once each.  A list of N results, each as
    ``HoughCircles`` returns it.  `stats` (a dict) receives the edge pixel
    count, the radii per chunk and the candidates."""
    N, H, W, _ = x.shape
    dev = x.device
    if maxRadius <= 0:
        maxRadius = max(H, W)
    if x.dtype != torch.uint8:
        raise ValueError(f"HoughCircles takes an 8-bit image, got {x.dtype}")
    edges = Canny(x, param1 / 2, param1)[..., 0] != 0
    dx = Sobel(x, K.CV_16S, 1, 0)[..., 0]
    dy = Sobel(x, K.CV_16S, 0, 1)[..., 0]
    n, ys, xs = torch.nonzero(edges & ((dx != 0) | (dy != 0)), as_tuple=True)
    dx_e, dy_e = dx[n, ys, xs].to(torch.int64), dy[n, ys, xs].to(torch.int64)
    m_e = _hypot_table(dev)[dx_e.abs() * (SOBEL3_MAX + 1) + dy_e.abs()]
    nx = dx_e.to(torch.float64) / m_e
    ny = dy_e.to(torch.float64) / m_e
    ah = int(np.ceil(H / dp))
    aw = int(np.ceil(W / dp))
    size = N * ah * aw
    acc = torch.zeros(size + _DUMP, dtype=torch.int32, device=dev)
    radii = np.array([sgn * r for sgn in (1, -1)
                      for r in range(max(minRadius, 1), maxRadius, max(int(dp), 1))], np.float64)
    E = n.numel()
    dp_t = _dev_scalar(dp, dev)
    xf, yf = xs.to(torch.float64), ys.to(torch.float64)
    base = n * ah
    # per vote: 3 f64 planes per axis, the index and the spare slot
    per_vote = 2 * 3 * 8 + 2 * 8 + 1
    R = _chunk(E, per_vote, len(radii))
    rad_t = to_device(radii, dev)
    for r0 in range(0, len(radii), R):
        sr = rad_t[r0:r0 + R, None]
        cx = torch.round((xf + sr * nx) / dp_t).to(torch.int64)
        cy = torch.round((yf + sr * ny) / dp_t).to(torch.int64)
        ok = (cx >= 0) & (cx < aw) & (cy >= 0) & (cy < ah)
        _vote(acc, size, (base + cy) * aw + cx, ok)
    A = F.pad(acc[:size].reshape(N, ah, aw), (1, 1, 1, 1))
    c = A[:, 1:-1, 1:-1]
    keep = ((c > param2) & (c >= A[:, 1:-1, :-2]) & (c >= A[:, 1:-1, 2:])
            & (c >= A[:, :-2, 1:-1]) & (c >= A[:, 2:, 1:-1]))
    cand = torch.nonzero(keep)
    cvotes = c[cand[:, 0], cand[:, 1], cand[:, 2]]
    host = torch.cat([torch.stack([n, ys, xs], 1).reshape(-1),
                      torch.cat([cand, cvotes[:, None].to(torch.int64)], 1).reshape(-1)]
                     ).cpu().numpy()
    pix = host[:3 * E].reshape(-1, 3)
    cands = host[3 * E:].reshape(-1, 4)
    if stats is not None:
        stats.update(edge_pixels=E, radii_per_chunk=R, chunk_bytes=R * E * per_vote,
                     candidates=len(cands))
    out = []
    for i in range(N):
        p = pix[pix[:, 0] == i]
        q = cands[cands[:, 0] == i]
        out.append(_circle_centres(p[:, 2], p[:, 1], q[:, 2], q[:, 1], q[:, 3].astype(np.int32),
                                   dp, minDist, minRadius, maxRadius, with_votes))
    return out


def _circle_centres(xs, ys, cx, cy, votes, dp, minDist, minRadius, maxRadius, with_votes):
    """The JAX package's host tail of HoughCircles for one image: the
    candidates by votes (its unstable ``np.argsort``), minDist, and the
    radius as the mode of the edge distances."""
    order = np.argsort(-votes)
    centers = []
    for k in order:
        px, py = cx[k] * dp, cy[k] * dp
        if all((px - c_[0]) ** 2 + (py - c_[1]) ** 2 >= minDist ** 2
               for c_ in centers):
            # radius: mode of edge distances
            d = np.hypot(xs - px, ys - py)
            sel = (d >= max(minRadius, 1)) & (d <= maxRadius)
            if not sel.any():
                continue
            hist, be = np.histogram(d[sel], bins=min(64, maxRadius))
            rad = (be[hist.argmax()] + be[hist.argmax() + 1]) / 2
            if with_votes:
                centers.append((px, py, rad, float(votes[k])))
            else:
                centers.append((px, py, rad))
    if not centers:
        return None
    w = 4 if with_votes else 3
    return np.asarray(centers, np.float32).reshape(1, -1, w)


def _gray_plane(image) -> torch.Tensor:
    """A one-channel image as a (1, H, W, 1) batch."""
    x, _ = to_batched(image)
    if x.shape[0] != 1 or x.shape[-1] != 1:
        raise ValueError(f"HoughCircles takes one 8-bit one-channel image, got "
                         f"{tuple(as_tensor(image).shape)}")
    return x


def HoughCircles(image, method: int, dp: float, minDist: float,
                 param1: float = 100, param2: float = 100,
                 minRadius: int = 0, maxRadius: int = 0):
    """HOUGH_GRADIENT: Canny edges + gradient-direction center voting
    (hough.cpp HoughCirclesGradient), then radius estimation."""
    return hough_circles_batch(_gray_plane(image), dp, minDist, param1, param2, minRadius,
                               maxRadius)[0]


def HoughCirclesWithAccumulator(image, method: int, dp: float,
                                minDist: float, param1: float = 100,
                                param2: float = 100, minRadius: int = 0,
                                maxRadius: int = 0):
    """cv::HoughCirclesWithAccumulator — (x, y, radius, votes)."""
    return hough_circles_batch(_gray_plane(image), dp, minDist, param1, param2, minRadius,
                               maxRadius, with_votes=True)[0]


# ------------------------------------------------------------ point sets

def HoughLinesPointSet(point, lines_max, threshold, min_rho, max_rho,
                       rho_step, min_theta, max_theta, theta_step):
    """cv2.HoughLinesPointSet (hough.cpp): vote a (rho, theta) grid from
    a 2-D point set; returns (N, 1, 3) [votes, rho, theta] sorted by
    votes descending."""
    pts = as_tensor(point).to(torch.float64).reshape(-1, 2)
    dev = pts.device
    thetas = np.arange(min_theta, max_theta, theta_step)
    T = len(thetas)
    nrho = int(round((max_rho - min_rho) / rho_step)) + 1
    cos_t = to_device(np.cos(thetas), dev)[None, :]
    sin_t = to_device(np.sin(thetas), dev)[None, :]
    rho = pts[:, 0:1] * cos_t + pts[:, 1:2] * sin_t
    ri = torch.round((rho - min_rho) / _dev_scalar(rho_step, dev)).to(torch.int64)
    size = nrho * T
    acc = torch.zeros(size + _DUMP, dtype=torch.int64, device=dev)
    ti = torch.arange(T, device=dev)[None, :]
    _vote(acc, size, ri * T + ti, (ri >= 0) & (ri < nrho))
    neg, order = torch.sort(-acc[:size], stable=True)
    top = max(lines_max, 0)
    host = torch.stack([order[:top], -neg[:top]], 1).cpu().numpy()
    out = []
    for k, v in host:
        if v < threshold:
            break
        r_i, t_i = divmod(int(k), T)
        out.append([float(v), min_rho + r_i * rho_step,
                    min_theta + t_i * theta_step])
    return np.asarray(out, np.float32).reshape(-1, 1, 3)


# --------------------------------------------------------- generalized

def _pairs(scene_bins: np.ndarray, templ_bins: np.ndarray, levels: int, shift: int = 0):
    """Every (scene pixel, template displacement) pair whose bins match,
    template bin b against scene bin (b + shift) % levels: two index arrays,
    the template's in its order within each bin."""
    order = np.argsort(templ_bins, kind="stable")
    cnt = np.bincount(templ_bins, minlength=levels)
    start = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    tb = (scene_bins - shift) % levels
    k = cnt[tb]
    i = np.repeat(np.arange(len(scene_bins)), k)
    within = np.arange(k.sum()) - np.repeat(np.cumsum(k) - k, k)
    return i, order[start[tb][i] + within]


class GeneralizedHoughBallard:
    """imgproc/src/generalized_hough.cpp (Ballard R-table voting).
    Template edge displacements grouped by gradient orientation; the scene's
    votes go into one scatter on the image's device."""

    def __init__(self):
        self.canny_low = 50
        self.canny_high = 100
        self.levels = 360
        self.votes_threshold = 100
        self.min_dist = 1.0
        self.dp = 1.0
        self._rtable = None

    def setCannyLowThresh(self, v):
        self.canny_low = int(v)

    def setCannyHighThresh(self, v):
        self.canny_high = int(v)

    def setLevels(self, v):
        self.levels = int(v)

    def setVotesThreshold(self, v):
        self.votes_threshold = int(v)

    def setMinDist(self, v):
        self.min_dist = float(v)

    def setDp(self, v):
        self.dp = float(v)

    def _edge_points(self, img):
        """(xs, ys, bins, (H, W), device) of the edge pixels of `img` in
        row-major order: Canny and the f32 Sobels on the image's device, the
        gradient angle (numpy's arctan2) and its bin on the host, from one
        read of the edge pixels' gradients."""
        g = as_tensor(img)
        if g.ndim == 3:
            g = cvtColor(g, K.COLOR_BGR2GRAY)
        edges = Canny(g, self.canny_low, self.canny_high)
        gx = Sobel(g, K.CV_32F, 1, 0, ksize=3)
        gy = Sobel(g, K.CV_32F, 0, 1, ksize=3)
        ys, xs = torch.nonzero(edges, as_tuple=True)
        host = torch.stack([ys.to(torch.float32), xs.to(torch.float32), gx[ys, xs],
                            gy[ys, xs]]).cpu().numpy()
        ang = np.arctan2(host[3], host[2]) % (2 * np.pi)
        bins = (ang * self.levels / (2 * np.pi)).astype(int) % self.levels
        return (host[1].astype(np.int64), host[0].astype(np.int64), bins,
                tuple(edges.shape), g.device)

    def setTemplate(self, templ, templCenter=None):
        xs, ys, bins, (h, w), _ = self._edge_points(templ)
        if templCenter is None:
            cx, cy = w // 2, h // 2
        else:
            cx, cy = templCenter
        self._rtable = {}
        for b, x, y in zip(bins, xs, ys):
            self._rtable.setdefault(b, []).append((cx - x, cy - y))
        self._rtable = {b: np.asarray(v) for b, v in self._rtable.items()}

    def _table(self):
        """The R-table as (bins, dx, dy) arrays, one entry per
        displacement."""
        b = np.concatenate([np.full(len(v), k) for k, v in self._rtable.items()]).astype(int)
        d = np.concatenate(list(self._rtable.values())).reshape(-1, 2)
        return b, d[:, 0], d[:, 1]

    def detect(self, image):
        xs, ys, bins, (H, W), dev = self._edge_points(image)
        aw = int(np.ceil(W / self.dp))
        ah = int(np.ceil(H / self.dp))
        tb, tdx, tdy = self._table()
        i, j = _pairs(bins, tb, self.levels)
        dp_t = _dev_scalar(self.dp, dev)
        acc = torch.zeros(ah * aw + _DUMP, dtype=torch.int32, device=dev)
        # per vote: two int64 sums, two f64 quotients, the index and spare slot
        step = _chunk(1, 6 * 8 + 1, max(len(i), 1))
        for k0 in range(0, len(i), step):
            sl = slice(k0, k0 + step)
            vx = to_device(xs[i[sl]] + tdx[j[sl]], dev).to(torch.float64) / dp_t
            vy = to_device(ys[i[sl]] + tdy[j[sl]], dev).to(torch.float64) / dp_t
            vxi = torch.round(vx).to(torch.int64)
            vyi = torch.round(vy).to(torch.int64)
            _vote(acc, ah * aw, vyi * aw + vxi, (vxi >= 0) & (vxi < aw) & (vyi >= 0) & (vyi < ah))
        flat = acc[:ah * aw]
        idx = torch.nonzero(flat >= self.votes_threshold)[:, 0]
        neg, order = torch.sort(-flat[idx], stable=True)
        host = torch.stack([idx[order], -neg], 1).cpu().numpy()
        out = []
        votes = []
        for k, v in host:
            y, x = divmod(int(k), aw)
            px, py = x * self.dp, y * self.dp
            if any(np.hypot(px - o[0], py - o[1]) < self.min_dist
                   for o in out):
                continue
            out.append((px, py))
            votes.append(int(v))
        if not out:
            return None, None
        pos = np.asarray([[x, y, 1.0, 0.0] for (x, y) in out],
                         np.float32).reshape(1, -1, 4)
        vt = np.asarray([[v, 0, 0] for v in votes],
                        np.int32).reshape(1, -1, 3)
        return pos, vt


def createGeneralizedHoughBallard():
    return GeneralizedHoughBallard()


class GeneralizedHoughGuil(GeneralizedHoughBallard):
    """Guil rotation/scale-invariant GHT (generalized_hough.cpp
    GeneralizedHoughGuilImpl): discretized search over (angle, scale),
    re-voting the R-table displacements rotated and scaled per
    hypothesis.  Peaks return (x, y, scale, angle_deg).  The scales of one
    angle vote together, each into its own accumulator, in one scatter."""

    def __init__(self):
        super().__init__()
        self.min_angle, self.max_angle = 0.0, 360.0
        self.angle_step = 5.0
        self.angle_thresh = 1000
        self.min_scale, self.max_scale = 0.5, 2.0
        self.scale_step = 0.05
        self.scale_thresh = 1000
        self.xi = 90.0
        self.angle_epsilon = 1.0
        self.max_buffer_size = 1000
        self.pos_thresh = 100

    # extra Guil knobs (setters return None like the wheel's)
    def setMinAngle(self, v):
        self.min_angle = float(v)

    def setMaxAngle(self, v):
        self.max_angle = float(v)

    def setAngleStep(self, v):
        self.angle_step = float(v)

    def setAngleThresh(self, v):
        self.angle_thresh = int(v)

    def setMinScale(self, v):
        self.min_scale = float(v)

    def setMaxScale(self, v):
        self.max_scale = float(v)

    def setScaleStep(self, v):
        self.scale_step = float(v)

    def setScaleThresh(self, v):
        self.scale_thresh = int(v)

    def setXi(self, v):
        self.xi = float(v)

    def setAngleEpsilon(self, v):
        self.angle_epsilon = float(v)

    def setMaxBufferSize(self, v):
        self.max_buffer_size = int(v)

    def setPosThresh(self, v):
        self.pos_thresh = int(v)

    def getMinAngle(self):
        return self.min_angle

    def getMaxAngle(self):
        return self.max_angle

    def getAngleStep(self):
        return self.angle_step

    def getMinScale(self):
        return self.min_scale

    def getMaxScale(self):
        return self.max_scale

    def getScaleStep(self):
        return self.scale_step

    def detect(self, image):
        xs, ys, bins, (H, W), dev = self._edge_points(image)
        aw = int(np.ceil(W / self.dp))
        ah = int(np.ceil(H / self.dp))
        tb, tdx, tdy = self._table()
        angles = np.arange(self.min_angle, self.max_angle + 1e-9,
                           self.angle_step)
        scales = np.arange(self.min_scale, self.max_scale + 1e-9,
                           self.scale_step)
        dp_t = _dev_scalar(self.dp, dev)
        size = ah * aw
        peaks = []
        for adeg in angles:
            arad = np.deg2rad(adeg)
            ca, sa = np.cos(arad), np.sin(arad)
            shift = int(round(adeg / 360.0 * self.levels)) % self.levels
            i, j = _pairs(bins, tb, self.levels, shift)
            xi = to_device(xs[i], dev).to(torch.float64)
            yi = to_device(ys[i], dev).to(torch.float64)
            rx = ca * tdx[j] - sa * tdy[j]
            ry = sa * tdx[j] + ca * tdy[j]
            # per scale: its votes (two f64 planes, two int64, the index and
            # spare slot) and its accumulator
            S = max(1, min(len(scales), VOTE_CHUNK_BYTES // (len(i) * 6 * 8 + size * 4)))
            for s0 in range(0, len(scales), S):
                sc = scales[s0:s0 + S, None]
                dx = to_device(sc * rx[None, :], dev)
                dy = to_device(sc * ry[None, :], dev)
                vxi = torch.round((xi + dx) / dp_t).to(torch.int64)
                vyi = torch.round((yi + dy) / dp_t).to(torch.int64)
                ok = (vxi >= 0) & (vxi < aw) & (vyi >= 0) & (vyi < ah)
                hyp = torch.arange(len(sc), device=dev)[:, None] * size
                acc = torch.zeros(len(sc) * size + _DUMP, dtype=torch.int32, device=dev)
                _vote(acc, len(sc) * size, hyp + vyi * aw + vxi, ok)
                acc = acc[:len(sc) * size].reshape(len(sc), size)
                k = torch.argmax(acc, dim=1)
                peaks.append(torch.stack([k, acc.gather(1, k[:, None])[:, 0].to(torch.int64)], 1))
        host = torch.cat(peaks).cpu().numpy().reshape(len(angles), len(scales), 2)
        best = []
        for a_i, adeg in enumerate(angles):
            for s_i, sc in enumerate(scales):
                k, v = (int(t) for t in host[a_i, s_i])
                if v >= self.pos_thresh:
                    y, x = divmod(k, aw)
                    best.append((v, x * self.dp, y * self.dp, sc, adeg))
        if not best:
            return None, None
        best.sort(key=lambda t: -t[0])
        out, votes = [], []
        for v, px, py, sc, adeg in best:
            if any(np.hypot(px - o[0], py - o[1]) < self.min_dist
                   for o in out):
                continue
            out.append((px, py, sc, adeg))
            votes.append((v, v, v))
        pos = np.asarray(out, np.float32).reshape(1, -1, 4)
        vt = np.asarray(votes, np.int32).reshape(1, -1, 3)
        return pos, vt


def createGeneralizedHoughGuil():
    return GeneralizedHoughGuil()
