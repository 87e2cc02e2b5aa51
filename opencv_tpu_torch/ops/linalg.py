"""Linear-algebra public surface (core/src/lapack.cpp, matmul.cpp, pca.cpp,
rand.cpp); twin of ``opencv_tpu/ops/linalg.py``.

The small dense solvers (``solve``, ``SVDecomp``, ``eigen``, PCA,
``invert``, ...) are the JAX package's host numpy code in f64, copied: they
return what ``opencv_tpu`` returns, bit for bit, for numpy or tensor input.
``transform`` (cv2.transform) is per pixel and runs on the input's device in
f64.  The RNG keeps the JAX package's state machine (numpy's generator) on
the host and fills a tensor ``dst`` in place on its own device, so one seed
gives the same numbers as ``opencv_tpu``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as K
from ..core.arrays import as_tensor

__all__ = ["solve", "SVDecomp", "SVBackSubst", "eigen", "eigenNonSymmetric",
           "PCACompute", "PCACompute2", "PCAProject", "PCABackProject",
           "Mahalanobis", "mulTransposed", "transform", "invert",
           "determinant", "trace", "setRNGSeed", "theRNG", "randu", "randn",
           "randShuffle", "RNG", "SVD_MODIFY_A", "SVD_NO_UV", "SVD_FULL_UV"]


def _host(a) -> np.ndarray:
    """A tensor as a host numpy array, anything else through numpy."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _f64(a) -> np.ndarray:
    return _host(a).astype(np.float64)


def solve(A, b, flags: int = K.DECOMP_LU):
    """cv2.solve (core/src/lapack.cpp:1065): returns (retval, x)."""
    A = _f64(A)
    b = _f64(b)
    if b.ndim == 1:
        b = b[:, None]
    normal = bool(flags & K.DECOMP_NORMAL)
    method = flags & 15
    if normal:
        b = A.T @ b
        A = A.T @ A
    try:
        if method in (K.DECOMP_LU, K.DECOMP_CHOLESKY):
            if A.shape[0] == A.shape[1]:
                x = np.linalg.solve(A, b)
            else:
                x = np.linalg.lstsq(A, b, rcond=None)[0]
        elif method == K.DECOMP_SVD or method == K.DECOMP_QR:
            x = np.linalg.lstsq(A, b, rcond=None)[0]
        elif method == K.DECOMP_EIG:
            x = np.linalg.solve(A, b)
        else:
            raise ValueError(f"solve: unknown method {method}")
    except np.linalg.LinAlgError:
        return False, np.zeros((A.shape[1], b.shape[1]), np.float64)
    return True, x.astype(np.float64)


SVD_MODIFY_A = 1
SVD_NO_UV = 2
SVD_FULL_UV = 4


def SVDecomp(src, flags: int = 0):
    """cv2.SVDecomp: (w (n,1), u (m,n) economy / (m,m) full, vt (n,n))."""
    a = _f64(src)
    full = bool(flags & SVD_FULL_UV)
    u, s, vt = np.linalg.svd(a, full_matrices=full)
    return s[:, None], u, vt


def SVBackSubst(w, u, vt, rhs):
    w = _f64(w).ravel()
    u = _f64(u)
    vt = _f64(vt)
    rhs = _f64(rhs)
    if rhs.ndim == 1:
        rhs = rhs[:, None]
    winv = np.where(w > np.finfo(np.float64).eps * w.max() * max(u.shape),
                    1.0 / np.where(w == 0, 1, w), 0.0)
    k = len(w)
    return vt[:k].T @ (winv[:, None] * (u[:, :k].T @ rhs))


def eigen(src):
    """Symmetric eigen (cv2.eigen): (retval, evals desc, evecs as rows)."""
    a = _f64(src)
    vals, vecs = np.linalg.eigh(a)
    order = np.argsort(vals)[::-1]
    return True, vals[order][:, None], vecs[:, order].T


def eigenNonSymmetric(src):
    a = _f64(src)
    vals, vecs = np.linalg.eig(a)
    return vals.real[:, None], vecs.real.T


def _mean_row(X, mean):
    if mean is None or (hasattr(mean, "size") and _host(mean).size == 0):
        return X.mean(axis=0, keepdims=True)
    return _f64(mean).reshape(1, -1)


def PCACompute(data, mean=None, eigenvectors=None, maxComponents: int = 0):
    """cv2.PCACompute (core/src/pca.cpp): rows are observations.
    Returns (mean, eigenvectors)."""
    X = _f64(data)
    mu = _mean_row(X, mean)
    # SVD of the centered data: rows of vt are the principal axes
    _, s, vt = np.linalg.svd(X - mu, full_matrices=False)
    n = vt.shape[0] if maxComponents <= 0 else min(maxComponents, vt.shape[0])
    return mu.astype(X.dtype), vt[:n].astype(X.dtype)


def PCACompute2(data, mean=None, maxComponents: int = 0):
    """Returns (mean, eigenvectors, eigenvalues)."""
    X = _f64(data)
    mu = _mean_row(X, mean)
    _, s, vt = np.linalg.svd(X - mu, full_matrices=False)
    evals = (s * s) / X.shape[0]  # reference scales by 1/N (CV_COVAR_SCALE)
    n = vt.shape[0] if maxComponents <= 0 else min(maxComponents, vt.shape[0])
    return mu.astype(X.dtype), vt[:n].astype(X.dtype), evals[:n, None].astype(X.dtype)


def PCAProject(data, mean, eigenvectors):
    X = _f64(data)
    mu = _f64(mean).reshape(1, -1)
    V = _f64(eigenvectors)
    return ((X - mu) @ V.T).astype(_host(data).dtype)


def PCABackProject(data, mean, eigenvectors):
    Y = _f64(data)
    mu = _f64(mean).reshape(1, -1)
    V = _f64(eigenvectors)
    return (Y @ V + mu).astype(_host(data).dtype)


def Mahalanobis(v1, v2, icovar):
    d = _f64(v1).ravel() - _f64(v2).ravel()
    ic = _f64(icovar)
    return float(np.sqrt(d @ ic @ d))


def mulTransposed(src, aTa: bool, delta=None, scale: float = 1.0):
    a = _f64(src)
    if delta is not None and _host(delta).size:
        a = a - _f64(delta)
    return (a.T @ a if aTa else a @ a.T) * scale


def transform(src, m):
    """cv2.transform: per-element channel-space affine map
    (core/src/matmul.cpp:1731), on the input's device in f64.  The output
    keeps the source depth (rounded half to even and saturated for integer
    types), with dn output channels.  Each output channel is the sum of the
    products in channel order, then the offset, one op at a time, so the
    card and the CPU agree bit for bit."""
    x = as_tensor(src)
    M = _f64(m)
    cn = x.shape[-1] if x.ndim == 3 else 1
    pts = x.to(torch.float64).reshape(-1, cn)
    dn = M.shape[0]
    chans = []
    for r in range(dn):
        acc = pts[:, 0] * float(M[r, 0])
        for c in range(1, cn):
            acc = acc + pts[:, c] * float(M[r, c])
        if M.shape[1] == cn + 1:
            acc = acc + float(M[r, cn])
        chans.append(acc)
    out = torch.stack(chans, dim=-1).reshape(x.shape[0], -1, dn)
    if not (x.is_floating_point() or x.is_complex()):
        info = torch.iinfo(x.dtype)
        out = torch.round(out).clamp(info.min, info.max)
    out = out.to(x.dtype)
    return out[..., 0] if dn == 1 and x.ndim == 2 else out


def invert(src, flags: int = K.DECOMP_LU):
    a = _f64(src)
    if flags & 15 == K.DECOMP_SVD or a.shape[0] != a.shape[1]:
        return True, np.linalg.pinv(a)
    try:
        return True, np.linalg.inv(a)
    except np.linalg.LinAlgError:
        return False, np.zeros_like(a.T)


def determinant(src):
    return float(np.linalg.det(_f64(src)))


def trace(src):
    return float(np.trace(_f64(src)))


# ------------------------------------------------------------------- RNG
# cv2's RNG is a 64-bit multiply-with-carry generator (core/src/rand.cpp);
# the public surface (randu/randn/randShuffle/theRNG) is reproduced over
# numpy's generator, as in the JAX package — the reference's exact
# bit-stream is not part of the documented contract.  The draws are made on
# the host; a tensor is filled in place on its own device.

def _store(mat, values: np.ndarray):
    """Write host `values` into `mat` in place (a numpy array, or a tensor
    on any device); return `mat`."""
    if isinstance(mat, torch.Tensor):
        mat.copy_(torch.from_numpy(np.ascontiguousarray(values)))
    else:
        mat[...] = values
    return mat


def _is_int(mat) -> bool:
    if isinstance(mat, torch.Tensor):
        return not (mat.is_floating_point() or mat.is_complex())
    return np.issubdtype(mat.dtype, np.integer)


class RNG:
    def __init__(self, state: int = 0xFFFFFFFF):
        self._g = np.random.default_rng(state & 0xFFFFFFFFFFFFFFFF)

    def uniform(self, a, b):
        if isinstance(a, int) and isinstance(b, int):
            return int(self._g.integers(a, b)) if b > a else a
        return float(self._g.uniform(a, b))

    def gaussian(self, sigma):
        return float(self._g.normal(0.0, sigma))

    def fill(self, mat, distType, a, b):
        shape = tuple(mat.shape)
        if distType == 0:  # UNIFORM
            if _is_int(mat):
                return _store(mat, self._g.integers(int(a), int(b), shape))
            return _store(mat, self._g.uniform(a, b, shape))
        return _store(mat, self._g.normal(a, b, shape))  # NORMAL


_THE_RNG = RNG(12345)


def theRNG():
    return _THE_RNG


def setRNGSeed(seed: int):
    global _THE_RNG
    _THE_RNG = RNG(int(seed))


def _target(dst):
    return dst if isinstance(dst, torch.Tensor) else np.asarray(dst)


def randu(dst, low, high):
    return _THE_RNG.fill(_target(dst), 0, low, high)


def randn(dst, mean, stddev):
    return _THE_RNG.fill(_target(dst), 1, mean, stddev)


def randShuffle(dst, iterFactor: float = 1.0):
    """Shuffle the rows of `dst` (its elements, if 1-D) in place, in the
    order numpy's generator shuffles them."""
    a = _target(dst)
    if not isinstance(a, torch.Tensor):
        flat = a.reshape(-1, a.shape[-1]) if a.ndim > 1 else a
        _THE_RNG._g.shuffle(flat, axis=0)
        return a
    flat = a.reshape(-1, a.shape[-1]) if a.ndim > 1 else a
    perm = np.arange(flat.shape[0])
    _THE_RNG._g.shuffle(perm)
    flat.copy_(flat[torch.from_numpy(perm).to(a.device)])
    return a
