"""k-means clustering (core/src/kmeans.cpp); twin of
``opencv_tpu/ops/cluster.py``.

The seeding is the JAX package's, in host numpy: kmeans++ (D² sampling) or
random centres from the same ``np.random.default_rng(0x5EED)`` stream, so the
same calls pick the same points (torch's generator would pick others).  The
samples are read to the host once per call for it.

Lloyd's iterations run on the samples' device as a plain loop with no host
read inside.  The JAX package computes them in f32 under XLA, which on the
CPU takes the distance ``x2 - 2 X·Cᵀ + c2`` as ``(x2 - 2P) + c2`` with ``x2``
and each dot product ``P`` a chain of fused multiply-adds over the features
(found by comparing the orders on 200 k points).  The port takes each step of
the chain exactly in f64 (a product of two f32 values is exact there) and
rounds to f32, so its distances are XLA's, and the card's are the CPU's.
The cluster sums are ``onehotᵀ @ X`` in f64, rounded to f32: exact, so equal
to XLA's f32 sums while those are exact (integer data below 2^24 per sum),
and deterministic on the card (no float atomics).  Empty clusters take the
farthest point overall, as in the JAX package.  One host read per attempt:
the compactness.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.arrays import as_tensor, to_device

__all__ = ["kmeans", "KMEANS_RANDOM_CENTERS", "KMEANS_PP_CENTERS",
           "KMEANS_USE_INITIAL_LABELS"]

KMEANS_RANDOM_CENTERS = 0
KMEANS_PP_CENTERS = 2
KMEANS_USE_INITIAL_LABELS = 1

_F32, _F64 = torch.float32, torch.float64


def _pp_init(X, k, rng):
    n = X.shape[0]
    centers = [X[rng.integers(n)]]
    d2 = ((X - centers[0]) ** 2).sum(-1)
    for _ in range(1, k):
        p = d2 / max(d2.sum(), 1e-12)
        idx = rng.choice(n, p=p)
        centers.append(X[idx])
        d2 = np.minimum(d2, ((X - centers[-1]) ** 2).sum(-1))
    return np.stack(centers)


def _f32(v: torch.Tensor) -> torch.Tensor:
    """An f64 value rounded to f32 and widened again."""
    return v.to(_F32).to(_F64)


def _fma_chain(terms) -> torch.Tensor:
    """XLA's f32 chain ``fma(a_d, b_d, ... fma(a_1, b_1, a_0 * b_0))`` from
    its exact f64 products, as f64 holding f32 values."""
    acc = _f32(terms[0])
    for t in terms[1:]:
        acc = _f32(t + acc)
    return acc


def _dist2(X64, x2, C):
    """XLA's f32 ``(x2 - 2 X·Cᵀ) + c2`` of the (n, d) samples (in f64) and
    the (k, d) f32 centres, as an (n, k) f32 tensor."""
    c = C.to(_F64)
    d = c.shape[1]
    c2 = _fma_chain([c[:, j] * c[:, j] for j in range(d)])
    dot = _fma_chain([X64[:, j:j + 1] * c[:, j] for j in range(d)])
    return (_f32(x2[:, None] - 2.0 * dot) + c2).to(_F32)


def _lloyd(X, C0, iters: int):
    """`iters` Lloyd steps from the (k, d) f32 centres `C0` on the (n, d) f32
    samples `X`; ``(labels (n,) int32, centres, compactness (0-dim f32))``,
    on X's device, with no host read."""
    X64 = X.to(_F64)
    x2 = _fma_chain([X64[:, j] * X64[:, j] for j in range(X.shape[1])])
    ks = torch.arange(C0.shape[0], device=X.device)
    C = C0
    for _ in range(iters):
        D = _dist2(X64, x2, C)
        onehot = (torch.argmin(D, dim=1)[:, None] == ks).to(_F64)
        counts = onehot.sum(0)
        sums = _f32(onehot.T @ X64)
        Cn = (sums / torch.clamp(counts, min=1.0)[:, None]).to(_F32)
        # an empty cluster takes the farthest point overall
        far = X.index_select(0, torch.argmax(D.min(dim=1).values).view(1))
        C = torch.where((counts > 0)[:, None], Cn, far)
    D = _dist2(X64, x2, C)
    return torch.argmin(D, dim=1).to(torch.int32), C, D.min(dim=1).values.sum()


def kmeans(data, Kclusters, bestLabels, criteria, attempts, flags, centers=None):
    """cv2.kmeans: ``(compactness, labels (N, 1) int32, centres (K, d) f32)``,
    the labels and centres on the samples' device (numpy in, numpy out)."""
    is_tensor = isinstance(data, torch.Tensor)
    Xt = data.to(_F32) if is_tensor else torch.from_numpy(
        np.ascontiguousarray(np.asarray(data, np.float32)))
    if Xt.ndim > 2:
        Xt = Xt.reshape(len(Xt), -1)
    if Xt.ndim == 1:
        Xt = Xt[:, None]
    Xt = Xt.contiguous()
    X = Xt.cpu().numpy()
    n = X.shape[0]
    k = int(Kclusters)
    maxiter = int(criteria[1]) if len(criteria) > 1 else 20
    maxiter = max(maxiter, 1)
    rng = np.random.default_rng(0x5EED)

    best = None
    use_initial = bool(flags & KMEANS_USE_INITIAL_LABELS) \
        and bestLabels is not None and as_tensor(bestLabels).numel() == n
    for a in range(max(int(attempts), 1)):
        if use_initial and a == 0:
            lbl0 = as_tensor(bestLabels).cpu().numpy().astype(np.int64).ravel()
            C0 = np.stack([
                X[lbl0 == j].mean(0) if np.any(lbl0 == j)
                else X[rng.integers(n)] for j in range(k)])
        elif flags & KMEANS_PP_CENTERS:
            C0 = _pp_init(X, k, rng)
        else:
            C0 = X[rng.choice(n, k, replace=False)]
        lbl, C, comp = _lloyd(Xt, to_device(np.asarray(C0, np.float32), Xt.device), maxiter)
        comp = float(comp)
        if best is None or comp < best[0]:
            best = (comp, lbl, C)

    comp, lbl, C = best
    lbl = lbl[:, None]
    if not is_tensor:
        return comp, lbl.numpy(), C.numpy()
    return comp, lbl, C
