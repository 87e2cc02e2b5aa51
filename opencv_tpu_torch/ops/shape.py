"""moments / connectedComponents / distanceTransform
(imgproc/src/moments.cpp, connectedcomponents.cpp, distransform.cpp); twin
of ``opencv_tpu/ops/shape.py``.

Everything dense runs on the input's device; the batched helpers
(:func:`raw_moments`, :func:`components_batch`) take a whole (N, H, W)
batch at once.  Where the JAX package carries a TPU workaround the port
uses what the card has:

- moments: the power sums are taken in f64 on the device, as cv2 takes
  them (the JAX package sums x³·I per row in f32, which is not exact past
  2^24); a point contour keeps the host polygon formula, copied.
- connectedComponents: the JAX package floods the minimum label one pixel
  per step under a ``while_loop``.  Here each step takes the neighbours'
  minimum, hooks it onto the representative the pixel points at
  (``scatter_reduce`` amin, the union-find idea), and then jumps pointers
  (``lab = lab[lab - 1]``) :data:`CC_JUMPS` times; convergence is read
  once every :data:`CC_CHECK_EVERY` steps.  The fixpoint labels each
  component with 1 + the flat index of its first pixel.  The compaction to
  cv2's label order is the JAX package's, on the device: the first pixel of
  each component in scan order (2×2 blocks in block-raster order for
  8-connectivity, pixel-raster for 4) by ``scatter_reduce`` amin, the
  components ranked by a cumulative sum in scan order, applied as a LUT.
  The component counts are the one value read back.  The stats are
  scatters (``scatter_reduce`` amin/amax, ``index_add_``) over the runs of
  equal labels along each row, the centroids exact integer sums, all on
  the device.  Every scatter keeps the atomics on one address few: a pixel
  with nothing to contribute writes a no-op into its own slot.
- distanceTransform: the 3×3 and 5×5 chamfer masks relax to the JAX
  package's fixpoint, one step being the minimum over the neighbours that
  share a weight, plus that weight (equal to the JAX package's step, since
  adding a weight is monotone in f32); the fixpoint is checked every
  :data:`DT_CHECK_EVERY` steps.  Under DIST_L1 that fixpoint is the exact
  city-block distance (each mask weight is its step's |dx| + |dy|), which
  two running minima a direction give without relaxing: the vertical
  distance within each column, then the minimum over each row of that
  distance plus |dx|.  DIST_MASK_PRECISE takes the vertical
  distance from running maxima of the nearest background row, then the
  parabola minimum over each row in chunks of rows sized from free memory,
  never the whole (N, H, W, W) array.
- distanceTransformWithLabels keeps the JAX package's row recurrence in
  int64 16.16 fixed point, each row on the device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import constants as K
from ..core.arrays import as_tensor, from_batched, to_batched, to_device

__all__ = ["moments", "raw_moments", "moments_dict", "connectedComponents",
           "connectedComponentsWithStats", "connectedComponentsWithAlgorithm",
           "connectedComponentsWithStatsWithAlgorithm", "components_batch",
           "component_stats", "distanceTransform", "distanceTransformWithLabels",
           "CC_CHECK_EVERY", "CC_JUMPS", "DT_CHECK_EVERY"]

# label propagation: pointer jumps per step, and steps between two reads of
# the convergence flag (each read is a host sync on the card)
CC_JUMPS = 2
CC_CHECK_EVERY = 4
# chamfer relaxation: steps between two reads of the fixpoint flag
DT_CHECK_EVERY = 8

_F64 = torch.float64


# ------------------------------------------------------------------ moments

def _contour_moments(pts):
    """Polygon moments via the boundary Green's-theorem accumulation
    (imgproc/src/moments.cpp contourMoments) — host f64, exact."""
    p = np.asarray(pts, np.float64).reshape(-1, 2)
    x, y = p[:, 0], p[:, 1]
    xp = np.roll(x, 1)
    yp = np.roll(y, 1)
    t = xp * y - x * yp
    a00 = np.sum(t)
    a10 = np.sum(t * (xp + x))
    a01 = np.sum(t * (yp + y))
    a20 = np.sum(t * (xp * xp + xp * x + x * x))
    a11 = np.sum(t * (xp * (2 * yp + y) + x * (yp + 2 * y)))
    a02 = np.sum(t * (yp * yp + yp * y + y * y))
    a30 = np.sum(t * (xp + x) * (xp * xp + x * x))
    a03 = np.sum(t * (yp + y) * (yp * yp + y * y))
    a21 = np.sum(t * (xp * xp * (3 * yp + y) + 2 * x * xp * (yp + y)
                      + x * x * (yp + 3 * y)))
    a12 = np.sum(t * (yp * yp * (3 * xp + x) + 2 * y * yp * (xp + x)
                      + y * y * (xp + 3 * x)))
    sgn = -1.0 if a00 < 0 else 1.0
    m = {
        "m00": a00 * sgn / 2, "m10": a10 * sgn / 6, "m01": a01 * sgn / 6,
        "m20": a20 * sgn / 12, "m11": a11 * sgn / 24, "m02": a02 * sgn / 12,
        "m30": a30 * sgn / 20, "m21": a21 * sgn / 60, "m12": a12 * sgn / 60,
        "m03": a03 * sgn / 20,
    }
    if m["m00"] != 0:
        cx = m["m10"] / m["m00"]
        cy = m["m01"] / m["m00"]
    else:
        cx = cy = 0.0
    mu20 = m["m20"] - m["m10"] * cx
    mu11 = m["m11"] - m["m10"] * cy
    mu02 = m["m02"] - m["m01"] * cy
    mu30 = m["m30"] - cx * (3 * mu20 + cx * m["m10"])
    mu21 = m["m21"] - cx * (2 * mu11 + cx * m["m01"]) - cy * mu20
    mu12 = m["m12"] - cy * (2 * mu11 + cy * m["m10"]) - cx * mu02
    mu03 = m["m03"] - cy * (3 * mu02 + cy * m["m01"])
    m.update(mu20=mu20, mu11=mu11, mu02=mu02, mu30=mu30, mu21=mu21,
             mu12=mu12, mu03=mu03)
    s2 = m["m00"] ** 2 if m["m00"] else 1.0
    s3 = m["m00"] ** 2.5 if m["m00"] else 1.0
    m.update(nu20=mu20 / s2, nu11=mu11 / s2, nu02=mu02 / s2,
             nu30=mu30 / s3, nu21=mu21 / s3, nu12=mu12 / s3,
             nu03=mu03 / s3)
    return m


# the raw moments in the order of raw_moments' last axis, as (p, q)
RAW_MOMENTS = ((0, 0), (1, 0), (0, 1), (2, 0), (1, 1), (0, 2), (3, 0), (2, 1), (1, 2), (0, 3))


def raw_moments(img, binaryImage: bool = False) -> torch.Tensor:
    """The raw moments m_pq (p + q <= 3, :data:`RAW_MOMENTS` order) of each
    plane of an (N, H, W) batch, an (N, 10) f64 tensor on its device.  The
    per-row power sums Σ_x x^p I and then Σ_y y^q S_p are taken in f64 (exact
    for u8 planes up to 2^53 per row sum)."""
    x = as_tensor(img)
    f = (x != 0).to(_F64) if binaryImage else x.to(_F64)
    N, H, W = f.shape
    xs = torch.arange(W, dtype=_F64, device=f.device)
    ys = torch.arange(H, dtype=_F64, device=f.device)
    S = [f.sum(dim=2)]
    for _ in range(3):
        f = f * xs
        S.append(f.sum(dim=2))                      # (N, H) each
    yq = [torch.ones_like(ys), ys, ys * ys, ys * ys * ys]
    return torch.stack([(S[p] * yq[q]).sum(dim=1) for p, q in RAW_MOMENTS], dim=1)


def moments_dict(raw) -> dict:
    """cv2's moments dict (spatial, central, normalised) from the 10 raw
    moments of one plane (host f64), as moments.cpp completes them."""
    m = {f"m{p}{q}": float(v) for (p, q), v in zip(RAW_MOMENTS, raw)}
    m00 = m["m00"]
    if m00 != 0:
        cx = m["m10"] / m00
        cy = m["m01"] / m00
    else:
        cx = cy = 0.0
    mu = {}
    mu["mu20"] = m["m20"] - m["m10"] * cx
    mu["mu11"] = m["m11"] - m["m10"] * cy
    mu["mu02"] = m["m02"] - m["m01"] * cy
    mu["mu30"] = m["m30"] - cx * (3 * mu["mu20"] + cx * m["m10"])
    mu["mu21"] = m["m21"] - cx * (2 * mu["mu11"] + cx * m["m01"]) - cy * mu["mu20"]
    mu["mu12"] = m["m12"] - cy * (2 * mu["mu11"] + cy * m["m10"]) - cx * mu["mu02"]
    mu["mu03"] = m["m03"] - cy * (3 * mu["mu02"] + cy * m["m01"])
    m.update(mu)
    # nu_pq = mu_pq / m00^((p+q)/2 + 1)
    for name in ["mu20", "mu11", "mu02"]:
        m["nu" + name[2:]] = m[name] / (m00 * m00) if m00 != 0 else 0.0
    for name in ["mu30", "mu21", "mu12", "mu03"]:
        m["nu" + name[2:]] = (m[name] / (m00 * m00 * (m00 ** 0.5))
                              if m00 > 0 else 0.0)
    return m


def _is_point_set(arr) -> bool:
    if not isinstance(arr, (torch.Tensor, np.ndarray)):
        arr = np.asarray(arr)
    shape = tuple(arr.shape)
    if len(shape) == 3 and shape[1:] == (1, 2):
        return True
    # (N,2) int32/int64 is a point set (cv2 images there are u8/u16/f32 HxW)
    dt = str(arr.dtype).removeprefix("torch.")
    return len(shape) == 2 and shape[1] == 2 and dt in ("int32", "int64")


def moments(array, binaryImage: bool = False):
    """`cv::moments`: a dense single-channel image on its device (one read
    of the 10 raw moments); point contours (N,1,2)/(N,2) via the polygon
    path on the host."""
    if _is_point_set(array):
        from .contours import _np
        return _contour_moments(_np(array))
    x, _ = to_batched(array)
    if x.shape[0] != 1 or x.shape[-1] != 1:
        raise ValueError(f"moments: one single-channel image, got {tuple(x.shape)}")
    return moments_dict(raw_moments(x[..., 0], binaryImage)[0].cpu().numpy())


# ------------------------------------------------------ connected components

def _neighbour_min(t: torch.Tensor, conn: int, fill):
    """The minimum of `t` (N, H, W) over each pixel's 8 (or 4) neighbours,
    `fill` outside the plane.  The 8-neighbourhood is taken separably: the
    3-wide row minimum above and below, the 2-wide one beside."""
    H, W = t.shape[1:]
    p = torch.nn.functional.pad(t, (1, 1, 1, 1), value=fill)
    side = torch.minimum(p[:, 1:H + 1, :W], p[:, 1:H + 1, 2:])
    if conn == 4:
        return torch.minimum(side, torch.minimum(p[:, :H, 1:W + 1], p[:, 2:, 1:W + 1]))
    row3 = torch.minimum(torch.minimum(p[:, :, :W], p[:, :, 1:W + 1]), p[:, :, 2:])
    return torch.minimum(side, torch.minimum(row3[:, :H], row3[:, 2:]))


def _propagate(fg: torch.Tensor, conn: int, stats=None) -> torch.Tensor:
    """(N, H, W) bool → the (N, H, W) int64 representative of each pixel's
    component: the flat index (over the batch) of its first pixel in raster
    order; N*H*W for background."""
    N, H, W = fg.shape
    total = N * H * W
    big = total + 1
    fgf = fg.reshape(-1)
    own = torch.arange(total, dtype=torch.int64, device=fg.device)
    # buf[i] is 1 + the index pixel i points at; buf[total] is the sentinel
    # that background points at
    buf = torch.full((total + 1,), big, dtype=torch.int64, device=fg.device)
    buf[:total] = torch.where(fgf, own + 1, big)
    steps = checks = 0
    while True:
        before = buf.clone()
        for _ in range(CC_CHECK_EVERY):
            lab = buf[:total]
            nb = torch.where(fgf, _neighbour_min(lab.view(N, H, W), conn, big).reshape(-1), big)
            # hook: the representative a pixel points at takes a smaller
            # neighbour label.  A pixel with none to give writes `big` into
            # its own slot instead (a no-op), so the atomics meet on one
            # address only along the fronts where two labels touch
            active = nb < lab
            buf.scatter_reduce_(0, torch.where(active, lab - 1, own),
                                torch.where(active, nb, big), "amin")
            buf[:total] = torch.minimum(buf[:total], nb)
            for _ in range(CC_JUMPS):
                buf[:total] = buf[buf[:total] - 1]
            steps += 1
        checks += 1
        if torch.equal(before, buf):
            break
    if stats is not None:
        stats.update(steps=steps, checks=checks)
    return (buf[:total] - 1).view(N, H, W)


@functools.lru_cache(maxsize=16)
def _scan_order(H: int, W: int, conn: int):
    """(key, perm) over the pixels of an (H, W) plane: each pixel's place in
    the reference's scan order (2×2 blocks in block-raster order, raster
    within a block, for 8-connectivity; raster for 4) and the pixels sorted
    by it.  This is the JAX package's ``scan_key`` with the raster index
    breaking its ties, as its stable sort does."""
    ys, xs = np.mgrid[0:H, 0:W]
    if conn == 8:
        key = ((ys // 2) * ((W + 1) // 2) + xs // 2) * 4 + (ys % 2) * 2 + xs % 2
    else:
        key = ys * W + xs
    key = key.ravel().astype(np.int64)
    return key, np.argsort(key, kind="stable")


def _compact(rep: torch.Tensor, fg: torch.Tensor, conn: int):
    """cv2's labels from the representatives: components numbered 1, 2, ...
    in the scan order of their first pixels, per plane.  Returns the (N, H,
    W) int32 labels and the (N,) int64 component counts (background not
    counted), both on the device."""
    N, H, W = fg.shape
    HW, total = H * W, N * H * W
    dev = fg.device
    fgf = fg.reshape(N, HW)
    root = rep.reshape(N, HW)
    own = torch.arange(total, dtype=torch.int64, device=dev).view(N, HW)
    if conn == 8:
        key_np, perm_np = _scan_order(H, W, conn)
        key = to_device(key_np, dev)
        # the first pixel in 2×2-block order lies in the block row of the
        # component's first raster row (the representative's row): only
        # those pixels take part in the minimum, the others write the
        # sentinel key into their own slot
        rows = torch.arange(H, device=dev).repeat_interleave(W)
        cand = fgf & (rows // 2 == (root % HW) // W // 2)
        no_key = 1 << 62
        first_key = torch.full((total + 1,), no_key, dtype=torch.int64, device=dev)
        first_key.scatter_reduce_(0, torch.where(cand, root, own).reshape(-1),
                                  torch.where(cand, key, no_key).reshape(-1), "amin")
        is_first = cand & (key == first_key[root])
        perm = to_device(perm_np, dev)
        rank_scan = torch.cumsum(is_first[:, perm], dim=1, dtype=torch.int32)
        rank = torch.empty_like(rank_scan)
        rank[:, perm] = rank_scan
    else:
        # raster order: the representative is the first pixel
        is_first = fgf & (root == own)
        rank_scan = rank = torch.cumsum(is_first, dim=1, dtype=torch.int32)
    counts = rank_scan[:, -1].to(torch.int64)
    # the first pixel writes its rank into its representative's slot, every
    # other pixel a 0 into its own
    lut = torch.zeros(total + 1, dtype=torch.int32, device=dev)
    lut.scatter_reduce_(0, torch.where(is_first, root, own).reshape(-1),
                        torch.where(is_first, rank, 0).reshape(-1), "amax")
    return lut[root].view(N, H, W), counts


def components_batch(mask, connectivity: int = 8, stats=None):
    """Connected components of each plane of an (N, H, W) batch (nonzero is
    foreground): ``(labels, counts)``, the (N, H, W) int32 labels in cv2's
    order and the (N,) int64 number of components per plane (background
    not counted), left on the device.  `stats`, if a dict, receives the
    propagation's ``steps`` and ``checks`` (host syncs)."""
    fg = as_tensor(mask) != 0
    rep = _propagate(fg, 8 if connectivity == 8 else 4, stats)
    return _compact(rep, fg, 8 if connectivity == 8 else 4)


def component_stats(labels: torch.Tensor, n_labels: int):
    """cv2's stats (left, top, width, height, area; int32) and centroids
    (f64) of labels 0..n_labels-1 in each plane of an (N, H, W) int32 label
    batch: ``(N, n_labels, 5)`` and ``(N, n_labels, 2)`` tensors on its
    device.  A label with no pixel has zeros, as the JAX package leaves
    them.  The reductions run over the runs of equal labels along each row
    (one scatter per run, not per pixel, so the atomics on one label are as
    many as its rows); finding the runs is one read back (``nonzero``)."""
    N, H, W = labels.shape
    dev = labels.device
    L = n_labels
    xs = torch.arange(W, device=dev)
    start = torch.ones_like(labels, dtype=torch.bool)
    start[..., 1:] = labels[..., 1:] != labels[..., :-1]
    end = torch.ones_like(labels, dtype=torch.bool)
    end[..., :-1] = labels[..., :-1] != labels[..., 1:]
    run_x0 = torch.where(start, xs, -1).cummax(dim=2).values
    n, y, x = torch.nonzero(end, as_tuple=True)
    x0 = run_x0[n, y, x]
    length = x - x0 + 1
    idx = n * L + labels[n, y, x].to(torch.int64)

    def reduce(vals, how):
        return torch.zeros(N * L, dtype=torch.int64, device=dev).scatter_reduce_(
            0, idx, vals, how, include_self=False)

    def total(vals):
        return torch.zeros(N * L, dtype=torch.int64, device=dev).index_add_(0, idx, vals)

    left, top = reduce(x0, "amin"), reduce(y, "amin")
    right, bottom = reduce(x, "amax"), reduce(y, "amax")
    area = total(length)
    some = area > 0
    stats = torch.stack([left, top, torch.where(some, right - left + 1, 0),
                         torch.where(some, bottom - top + 1, 0), area], dim=1)
    # exact integer sums of x and y over each label, then one division, as
    # numpy's mean of the coordinates takes it
    sums = torch.stack([total((x0 + x) * length // 2), total(y * length)], dim=1).to(_F64)
    cent = torch.where(some[:, None], sums / torch.where(some, area, 1)[:, None].to(_F64), 0.0)
    return stats.to(torch.int32).view(N, L, 5), cent.view(N, L, 2)


def _one_plane(image):
    x, _ = to_batched(image)
    return x[0, :, :, 0]


def connectedComponents(image, connectivity: int = 8, ltype: int = 4):
    """`cv::connectedComponents` — labels 0 (bg) and 1..N, assigned in the
    reference's scan order of each component's first pixel.  Returns
    ``(n + 1, labels)`` with the (H, W) int32 labels on the image's device."""
    labels, counts = components_batch(_one_plane(image)[None], connectivity)
    return int(counts[0]) + 1, labels[0]


def connectedComponentsWithStats(image, connectivity: int = 8, ltype: int = 4):
    """``(n + 1, labels, stats, centroids)``, the tensors on the image's
    device."""
    labels, counts = components_batch(_one_plane(image)[None], connectivity)
    n = int(counts[0]) + 1
    stats, cent = component_stats(labels, n)
    return n, labels[0], stats[0], cent[0]


def connectedComponentsWithAlgorithm(image, connectivity: int, ltype: int, ccltype: int):
    """cv::connectedComponentsWithAlgorithm — the algorithm selector only
    changes the reference's scan strategy; the labels are the same."""
    return connectedComponents(image, connectivity, ltype)


def connectedComponentsWithStatsWithAlgorithm(image, connectivity: int, ltype: int,
                                              ccltype: int):
    return connectedComponentsWithStats(image, connectivity, ltype)


# --------------------------------------------------------- distance transform

# chamfer mask weights (distransform.cpp initTopBottom/getDistanceTransformMask)
_DIST_WEIGHTS = {
    (K.DIST_L1, 3): (1.0, 2.0),
    (K.DIST_C, 3): (1.0, 1.0),
    (K.DIST_L2, 3): (0.955, 1.3693),
    (K.DIST_L1, 5): (1.0, 2.0, 3.0),
    (K.DIST_C, 5): (1.0, 1.0, 2.0),
    (K.DIST_L2, 5): (1.0, 1.4, 2.1969),
}
# the mask's neighbours by weight: (dy, dx) of weights 0, 1 (and 2 for 5×5)
_MASK_OFFS = (
    ((-1, 0), (1, 0), (0, -1), (0, 1)),
    ((-1, -1), (-1, 1), (1, -1), (1, 1)),
    ((-2, -1), (-2, 1), (2, -1), (2, 1), (-1, -2), (-1, 2), (1, -2), (1, 2)),
)
_INF = 1e9


def _chamfer(fg: torch.Tensor, weights, stats=None) -> torch.Tensor:
    """The chamfer relaxation of (N, H, W) bool to its fixpoint in f32."""
    N, H, W = fg.shape
    r = 2 if len(weights) == 3 else 1
    d = torch.where(fg, _INF, 0.0).to(torch.float32)
    steps = checks = 0
    while True:
        for _ in range(DT_CHECK_EVERY):
            p = torch.nn.functional.pad(d, (r, r, r, r), value=_INF)
            prev = d
            if r == 1:
                # the 3×3 mask separably: the row minimum beside each pixel,
                # then its rows above and below for the diagonals
                side = torch.minimum(p[:, :, :W], p[:, :, 2:])
                m_a = torch.minimum(side[:, 1:H + 1],
                                    torch.minimum(p[:, :H, 1:W + 1], p[:, 2:, 1:W + 1]))
                m_b = torch.minimum(side[:, :H], side[:, 2:])
                d = torch.minimum(d, torch.minimum(m_a + weights[0], m_b + weights[1]))
            else:
                for w, offs in zip(weights, _MASK_OFFS):
                    m = None
                    for dy, dx in offs:
                        nb = p[:, r + dy:r + dy + H, r + dx:r + dx + W]
                        m = nb if m is None else torch.minimum(m, nb)
                    d = torch.minimum(d, m + w)
            steps += 1
        checks += 1
        if torch.equal(prev, d):
            break
    if stats is not None:
        stats.update(steps=steps, checks=checks)
    return d


def _city_block(fg: torch.Tensor) -> torch.Tensor:
    """The exact L1 distance of (N, H, W) bool to the nearest background
    pixel, in f32, _INF where there is none: the fixpoint of the DIST_L1
    chamfer masks, from running minima in int64."""
    N, H, W = fg.shape
    dev = fg.device
    far = 1 << 40
    rows = torch.arange(H, device=dev)[None, :, None]
    bg = ~fg
    above = torch.where(bg, rows, -far).cummax(dim=1).values
    below = torch.where(bg, rows, far).flip(1).cummin(dim=1).values.flip(1)
    g = torch.minimum(rows - above, below - rows)
    # min over x' of g(x') + |x - x'|: the columns at or left of x, then right
    xs = torch.arange(W, device=dev)[None, None, :]
    left = (g - xs).cummin(dim=2).values + xs
    right = (g + xs).flip(2).cummin(dim=2).values.flip(2) - xs
    d = torch.minimum(left, right)
    return torch.where(d < far // 2, d.to(torch.float32), _INF)


def _precise_chunk_rows(W: int, device) -> int:
    """Rows of the parabola minimum taken at once: a (rows, W, W) f32
    intermediate in a quarter of the free device memory, at most 1 GiB (256
    MiB on the CPU)."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        budget = min(free // 4, 1 << 30)
    else:
        budget = 256 << 20
    return max(1, budget // (4 * W * W))


def _precise(fg: torch.Tensor) -> torch.Tensor:
    """The exact Euclidean distance (DIST_MASK_PRECISE) of (N, H, W) bool,
    as the JAX package computes it: the vertical distance to the nearest
    background pixel of the column (1e9 where there is none), then the
    minimum over the row of g² + dx² in f32, then the square root."""
    N, H, W = fg.shape
    dev = fg.device
    rows = torch.arange(H, device=dev)[None, :, None]
    bg = ~fg
    above = torch.where(bg, rows, -(1 << 40)).cummax(dim=1).values
    below = torch.where(bg, rows, 1 << 40).flip(1).cummin(dim=1).values.flip(1)
    g = torch.minimum(rows - above, below - rows)
    g = torch.where(g < (1 << 30), g.to(torch.float32), _INF).reshape(N * H, W)
    xs = torch.arange(W, device=dev, dtype=torch.float32)
    dx2 = (xs[:, None] - xs[None, :]) ** 2                       # (W, W)
    g2 = g * g
    d2 = torch.empty_like(g)
    step = _precise_chunk_rows(W, dev)
    for r0 in range(0, N * H, step):
        d2[r0:r0 + step] = (g2[r0:r0 + step, None, :] + dx2[None]).amin(dim=2)
    # the f32 root correctly rounded (taken in f64)
    return torch.sqrt(d2.to(_F64)).to(torch.float32).reshape(N, H, W)


def distanceTransform(src, distanceType: int, maskSize: int, dstType: int = K.CV_32F,
                      stats=None):
    """`cv::distanceTransform` of each image of the batch: chamfer masks 3/5
    relaxed to the JAX package's fixpoint (under DIST_L1 its closed form,
    the exact city-block distance), DIST_MASK_PRECISE with DIST_L2 exact;
    an f32 result on the input's device.  `stats` (this port's addition),
    if a dict, receives the chamfer relaxation's ``steps`` and ``checks``
    (host syncs; 0 under DIST_L1)."""
    x, meta = to_batched(src)
    fg = x[..., 0] != 0
    if maskSize == K.DIST_MASK_PRECISE and distanceType == K.DIST_L2:
        return from_batched(_precise(fg)[..., None], meta)
    if maskSize == K.DIST_MASK_PRECISE or distanceType not in (K.DIST_L1, K.DIST_L2,
                                                                K.DIST_C):
        maskSize = 5
        distanceType = K.DIST_L2
    if distanceType == K.DIST_L1:
        if stats is not None:
            stats.update(steps=0, checks=0)
        return from_batched(_city_block(fg)[..., None], meta)
    d = _chamfer(fg, _DIST_WEIGHTS[(distanceType, maskSize)], stats)
    return from_batched(d[..., None], meta)


def _row_chain(cand, cl, step_w, js):
    """tmp[j] = min(cand[j], tmp[j-1] + step_w), the candidate winning
    ties: a running minimum preferring the nearest earlier index."""
    v = cand - js * step_w
    mrun = torch.cummin(v, dim=0).values
    marked = torch.where(v == mrun, js, -1)
    ksel = torch.cummax(marked, dim=0).values
    return mrun + js * step_w, cl[ksel]


def distanceTransformWithLabels(src, distanceType: int, maskSize: int,
                                labelType: int = K.DIST_LABEL_CCOMP):
    """cv::distanceTransform labeled overload (distransform.cpp:744 +
    distanceTransformEx_5x5): 5×5 chamfer in 16.16 fixed point with
    Voronoi label propagation.  The JAX package's row recurrence, each row
    vectorised on the device in int64: upper-window candidates argmin in
    the reference's check order, then the within-row chain as a running
    minimum.  Returns the (H, W) f32 distances and int32 labels."""
    img = as_tensor(src)
    if img.ndim == 3:
        img = img[:, :, 0]
    H, W = img.shape
    dev = img.device
    SHIFT = 16
    m = {K.DIST_C: (1.0, 1.0, 2.0), K.DIST_L1: (1.0, 2.0, 3.0),
         K.DIST_L2: (1.0, 1.4, 2.1969)}[distanceType]
    HV = int(round(m[0] * (1 << SHIFT)))
    DG = int(round(m[1] * (1 << SHIFT)))
    LG = int(round(m[2] * (1 << SHIFT)))
    DIST_MAX = (1 << 32) - 1 - LG
    i64 = dict(dtype=torch.int64, device=dev)

    zero = img == 0
    if labelType == K.DIST_LABEL_CCOMP:
        _n, lab0 = connectedComponents(zero.to(torch.uint8) * 255, 8)
        labels = torch.where(zero, lab0, 0).to(torch.int64)
    else:
        labels = torch.zeros(H * W, **i64)
        labels[zero.reshape(-1)] = torch.arange(1, int(zero.sum()) + 1, **i64)
        labels = labels.view(H, W)

    B = 2
    dist = torch.full((H + 2 * B, W + 2 * B), DIST_MAX, **i64)
    lab = torch.zeros((H + 2 * B, W + 2 * B), **i64)
    js = torch.arange(W, **i64)
    cmax = torch.full((W,), DIST_MAX, **i64)
    czero = torch.zeros(W, **i64)

    def window(rd, rl, near, far, sgn):
        """The seven upper (sgn = 1) or lower (sgn = -1) candidates of a row,
        in the reference's check order."""
        o = [(far, -sgn, LG), (far, sgn, LG), (near, -2 * sgn, LG), (near, -sgn, DG),
             (near, 0, HV), (near, sgn, DG), (near, 2 * sgn, LG)]
        return ([rd[r][B + dx:B + dx + W] + w for r, dx, w in o],
                [rl[r][B + dx:B + dx + W] for r, dx, w in o])

    # forward pass (top→bottom, candidates from the two rows above)
    for i in range(H):
        r = i + B
        ds, ls = window(dist, lab, r - 1, r - 2, 1)
        cands, clabs = torch.stack([cmax] + ds), torch.stack([czero] + ls)
        pick = torch.argmin(cands, dim=0)   # first minimum == check order
        cand, cl = cands[pick, js], clabs[pick, js]
        z = zero[i]
        cand = torch.where(z, 0, torch.minimum(cand, cmax))
        cl = torch.where(z, labels[i], cl)
        rowd, rowl = _row_chain(cand, cl, HV, js)
        dist[r, B:B + W] = torch.where(z, 0, rowd)
        lab[r, B:B + W] = torch.where(z, labels[i], rowl)

    # backward pass (bottom→top, candidates from the two rows below)
    for i in range(H - 1, -1, -1):
        r = i + B
        ds, ls = window(dist, lab, r + 1, r + 2, -1)
        cands = torch.stack([dist[r, B:B + W]] + ds)
        clabs = torch.stack([lab[r, B:B + W]] + ls)
        pick = torch.argmin(cands, dim=0)   # current value checked first
        cand, cl = cands[pick, js], clabs[pick, js]
        rowd, rowl = _row_chain(cand.flip(0), cl.flip(0), HV, js)
        dist[r, B:B + W] = rowd.flip(0)
        lab[r, B:B + W] = rowl.flip(0)

    out = (dist[B:B + H, B:B + W].to(_F64) / float(1 << SHIFT)).to(torch.float32)
    return out, lab[B:B + H, B:B + W].to(torch.int32)
