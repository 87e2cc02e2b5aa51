"""USAC framework (calib3d/src/usac/): modular robust estimation.

Mirrors the reference's component architecture — samplers (sampler.cpp),
quality/score functions (quality.cpp), local optimization
(local_optimization.cpp), degeneracy tests (degeneracy.cpp), SPRT
verification (utils.cpp) and adaptive termination (termination.cpp) —
composed per USAC_* flag exactly as ransac_solvers.cpp:1084-1131 does.
Twin of ``opencv_tpu/calib3d/usac.py``: the same numpy, with the same
``default_rng`` seed, so the port draws the same samples.

Numerical difference by design: MAGSAC's σ-marginalized loss uses the
incomplete gamma integrals computed directly (scipy) instead of the
reference's 50-anchor interpolation tables (gamma_values.cpp) — same
function, no table quantization.  Residual evaluation for all candidate
models is vectorized over the full point set.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["UsacParams", "ransac_solve",
           "SAMPLING_UNIFORM", "SAMPLING_PROSAC",
           "SAMPLING_NAPSAC", "SAMPLING_PROGRESSIVE_NAPSAC",
           "SCORE_METHOD_RANSAC", "SCORE_METHOD_MSAC",
           "SCORE_METHOD_MAGSAC", "SCORE_METHOD_LMEDS",
           "LOCAL_OPTIM_NULL", "LOCAL_OPTIM_INNER_LO",
           "LOCAL_OPTIM_INNER_AND_ITER_LO", "LOCAL_OPTIM_GC",
           "LOCAL_OPTIM_SIGMA",
           "NEIGH_FLANN_KNN", "NEIGH_GRID", "NEIGH_FLANN_RADIUS"]

# enums (usac.hpp)
SAMPLING_UNIFORM = 0
SAMPLING_PROGRESSIVE_NAPSAC = 1
SAMPLING_NAPSAC = 2
SAMPLING_PROSAC = 3
SCORE_METHOD_RANSAC = 0
SCORE_METHOD_MSAC = 1
SCORE_METHOD_MAGSAC = 2
SCORE_METHOD_LMEDS = 3
LOCAL_OPTIM_NULL = 0
LOCAL_OPTIM_INNER_LO = 1
LOCAL_OPTIM_INNER_AND_ITER_LO = 2
LOCAL_OPTIM_GC = 3
LOCAL_OPTIM_SIGMA = 4
NEIGH_FLANN_KNN = 0
NEIGH_GRID = 1
NEIGH_FLANN_RADIUS = 2


class UsacParams:
    """cv2.UsacParams (usac.hpp UsacParams)."""

    def __init__(self):
        self.confidence = 0.99
        self.isParallel = False
        self.loIterations = 5
        self.loMethod = LOCAL_OPTIM_INNER_LO
        self.loSampleSize = 14
        self.maxIterations = 5000
        self.neighborsSearch = NEIGH_GRID
        self.randomGeneratorState = 0
        self.sampler = SAMPLING_UNIFORM
        self.score = SCORE_METHOD_MSAC
        self.threshold = 1.5
        self.final_polisher = 1          # COV_POLISHER
        self.final_polisher_iterations = 3


# ------------------------------------------------------------- samplers

class UniformSampler:
    """sampler.cpp UniformSamplerImpl."""

    def __init__(self, rng, sample_size, points_size):
        self.rng = rng
        self.k = sample_size
        self.n = points_size

    def sample(self, _iter):
        return self.rng.choice(self.n, self.k, replace=False)


class ProsacSampler:
    """PROSAC growth schedule (sampler.cpp ProsacSamplerImpl):
    points must be sorted by decreasing quality; the hypothesis pool
    grows from the top-ranked correspondences."""

    def __init__(self, rng, sample_size, points_size,
                 growth_max_samples=200000):
        self.rng = rng
        self.k = sample_size
        self.n = points_size
        # growth function T_n (PROSAC paper eq. 3)
        Tn = growth_max_samples
        for i in range(sample_size):
            Tn *= (sample_size - i) / (points_size - i)
        self.growth = np.zeros(points_size, np.int64)
        Tn_prime = 1.0
        for nn in range(sample_size, points_size):
            Tn1 = Tn * (nn + 1) / (nn + 1 - sample_size)
            self.growth[nn] = int(Tn_prime + np.ceil(Tn1 - Tn))
            Tn_prime = self.growth[nn]
            Tn = Tn1
        self.subset = sample_size
        self.t = 0

    def sample(self, _iter):
        self.t += 1
        while self.subset < self.n - 1 and \
                self.t > self.growth[self.subset]:
            self.subset += 1
        # draw k-1 from the top (subset) points + the subset-th point
        if self.subset <= self.k:
            return np.arange(self.k)
        idx = self.rng.choice(self.subset, self.k - 1, replace=False)
        return np.concatenate([idx, [self.subset]])


class NapsacSampler:
    """N Adjacent Points SAC (sampler.cpp NapsacSamplerImpl): one seed
    point + its spatial neighbours."""

    def __init__(self, rng, sample_size, pts):
        self.rng = rng
        self.k = sample_size
        self.n = len(pts)
        d = np.linalg.norm(pts[:, None, :2] - pts[None, :, :2], axis=-1)
        self.order = np.argsort(d, axis=1)

    def sample(self, _iter):
        seed = self.rng.integers(self.n)
        neigh = self.order[seed][1:max(self.k * 3, self.k + 1)]
        pick = self.rng.choice(len(neigh), self.k - 1, replace=False)
        return np.concatenate([[seed], neigh[pick]])


# -------------------------------------------------------------- quality

class RansacQuality:
    def __init__(self, t2):
        self.t2 = t2

    def score(self, sq_err):
        inl = sq_err < self.t2
        return -float(inl.sum()), inl


class MsacQuality:
    """Truncated quadratic loss (quality.cpp MsacQualityImpl)."""

    def __init__(self, t2):
        self.t2 = t2

    def score(self, sq_err):
        inl = sq_err < self.t2
        loss = np.minimum(sq_err, self.t2).sum() / self.t2
        return float(loss), inl


class LMedsQuality:
    def __init__(self, t2):
        self.t2 = t2

    def score(self, sq_err):
        return float(np.median(sq_err)), sq_err < self.t2


class MagsacQuality:
    """σ-marginalized loss (quality.cpp:167, MAGSAC paper eq. 12) with
    the gamma integrals evaluated directly: a = (DoF-1)/2,
    t = r² / (2 σ_max²)."""

    def __init__(self, t2, dof=2, sigma_quantile=3.04,
                 upper_inc_of_quantile=0.00419, max_thr=None):
        from scipy.special import gammainc, gammaincc, gamma
        self._ginc = gammainc
        self._gincc = gammaincc
        self._g = gamma
        self.t2 = t2                       # tentative inlier threshold²
        maximum_thr = max(math.sqrt(t2), 7.5) if max_thr is None \
            else max_thr
        self.max_t2 = maximum_thr * maximum_thr
        self.a = (dof - 1) / 2.0
        max_sigma = math.sqrt(self.max_t2) / sigma_quantile
        self.sig2 = max_sigma * max_sigma
        self.gamma_k = upper_inc_of_quantile
        self.two_ad = 2.0 ** ((dof + 1) * 0.5) / max_sigma
        # normalize so the per-point loss peaks at 1 (quality.cpp:204)
        grid = np.linspace(0, self.max_t2, 31)[1:]
        self.norm = self.two_ad / max(self._loss(grid).max(), 1e-10)

    def _loss(self, sq):
        t = sq / (2 * self.sig2)
        low = self._ginc(self.a, t) * self._g(self.a)
        upper = self._gincc(self.a, t) * self._g(self.a)
        return self.two_ad * (self.sig2 / 2 * low
                              + sq * 0.25 * (upper - self.gamma_k))

    def score(self, sq_err):
        inl = sq_err < self.t2
        mask = sq_err < self.max_t2
        loss = -(1.0 - self._loss(sq_err[mask]) / self.two_ad
                 * self.norm).sum()
        return float(loss), inl

    def weights(self, sq_err):
        """σ-consensus weights: -dL/dr² (local_optimization.cpp
        SigmaConsensus)."""
        t = np.minimum(sq_err, self.max_t2) / (2 * self.sig2)
        upper = self._gincc(self.a, t) * self._g(self.a)
        w = np.maximum(upper - self.gamma_k, 0.0)
        w[sq_err >= self.max_t2] = 0.0
        return w


# -------------------------------------------------------- SPRT verifier

class SPRT:
    """Sequential probability ratio test (utils.cpp AdaptiveSPRTImpl):
    early-reject bad models after inspecting a prefix of points."""

    def __init__(self, rng, t2, eps0=0.05, delta0=0.01):
        self.rng = rng
        self.t2 = t2
        self.eps = eps0        # inlier ratio of a good model (estimate)
        self.delta = delta0    # inlier ratio of a bad model
        self._update_A()

    def _update_A(self):
        # decision threshold via the standard SPRT recurrence
        eps, delta = max(self.eps, 1e-3), min(max(self.delta, 1e-4),
                                              self.eps * 0.9)
        C = (1 - delta) * math.log((1 - delta) / (1 - eps)) \
            + delta * math.log(delta / eps)
        K = 200.0 / C + 1
        A = K
        for _ in range(10):
            A = K + math.log(A)
        self.A = A
        self.lam_in = delta / eps
        self.lam_out = (1 - delta) / (1 - eps)

    def verify(self, sq_err):
        """Returns (accepted, inlier_mask_prefix_len)."""
        order = self.rng.permutation(len(sq_err))
        lam = 1.0
        for cnt, i in enumerate(order):
            lam *= self.lam_in if sq_err[i] < self.t2 else self.lam_out
            if lam > self.A:
                return False, cnt + 1
        return True, len(sq_err)

    def update(self, inlier_ratio, good):
        if good:
            self.eps = max(self.eps, inlier_ratio)
        else:
            self.delta = 0.9 * self.delta + 0.1 * inlier_ratio
        self._update_A()


# ------------------------------------------------------------ termination

def _adaptive_iters(inlier_ratio, sample_size, confidence, max_iters):
    """termination.cpp StandardTerminationCriteria."""
    if inlier_ratio <= 0:
        return max_iters
    denom = math.log(max(1 - inlier_ratio ** sample_size, 1e-300))
    if denom >= 0:
        return max_iters
    return min(max_iters, int(math.log(max(1 - confidence, 1e-300))
                              / denom) + 1)


# ------------------------------------------------------ the RANSAC loop

def ransac_solve(estimator, n_points, flag=None, threshold=1.5,
                 confidence=0.995, max_iters=2000, params=None,
                 prosac_order=None, seed=0, points_for_napsac=None):
    """Generic USAC solve.  `estimator` provides:
      - sample_size
      - fit(idx) -> list of candidate models (may be empty)
      - errors(model) -> squared residuals over all points
      - non_minimal_fit(inlier_idx, weights=None) -> model or None
      - is_sample_good(idx) -> bool  (degeneracy pre-check)
    Returns (model, inlier_mask (bool), n_iters)."""
    from . import geometry as G

    t2 = threshold * threshold
    rng = np.random.default_rng(seed)

    # ---- flag -> components (ransac_solvers.cpp:1084 setParameters)
    sampling = SAMPLING_UNIFORM
    scoring = SCORE_METHOD_MSAC
    lo = LOCAL_OPTIM_INNER_AND_ITER_LO
    lo_iters = 10
    use_sprt = False
    if params is not None:
        sampling = params.sampler
        scoring = params.score
        lo = params.loMethod
        lo_iters = params.loIterations
        confidence = params.confidence
        max_iters = params.maxIterations
        t2 = params.threshold * params.threshold
    elif flag is not None:
        if flag == G.USAC_MAGSAC:
            scoring = SCORE_METHOD_MAGSAC
            lo = LOCAL_OPTIM_SIGMA
            lo_iters = 15
        elif flag == G.USAC_PARALLEL:
            lo = LOCAL_OPTIM_INNER_LO
        elif flag == G.USAC_ACCURATE:
            lo = LOCAL_OPTIM_GC
            lo_iters = 25
        elif flag == G.USAC_FAST:
            lo_iters = 5
            use_sprt = True
        elif flag == G.USAC_PROSAC:
            sampling = SAMPLING_PROSAC
            lo = LOCAL_OPTIM_INNER_LO
        # USAC_DEFAULT / USAC_FM_8PTS keep the defaults above

    k = estimator.sample_size
    if sampling == SAMPLING_PROSAC:
        # the reference's PROSAC assumes the input is already sorted by
        # match quality (usac/sampler.cpp ProsacSampler) — default to
        # identity order so the USAC_PROSAC flag actually changes the
        # sampling schedule even when no explicit order is passed
        if prosac_order is None:
            prosac_order = np.arange(n_points)
        sampler = ProsacSampler(rng, k, n_points)
    elif sampling in (SAMPLING_NAPSAC, SAMPLING_PROGRESSIVE_NAPSAC) \
            and points_for_napsac is not None:
        sampler = NapsacSampler(rng, k, points_for_napsac)
    else:
        sampler = UniformSampler(rng, k, n_points)
        prosac_order = None

    if scoring == SCORE_METHOD_RANSAC:
        quality = RansacQuality(t2)
    elif scoring == SCORE_METHOD_MAGSAC:
        quality = MagsacQuality(t2, dof=getattr(estimator, "dof", 2),
                                sigma_quantile=getattr(
                                    estimator, "sigma_quantile", 3.04),
                                upper_inc_of_quantile=getattr(
                                    estimator, "upper_inc", 0.00419))
    elif scoring == SCORE_METHOD_LMEDS:
        quality = LMedsQuality(t2)
    else:
        quality = MsacQuality(t2)

    sprt = SPRT(rng, t2) if use_sprt else None

    best_loss = np.inf
    best_model = None
    best_inl = None
    iters = max_iters
    it = 0
    while it < iters:
        idx = sampler.sample(it)
        if prosac_order is not None:
            idx = prosac_order[idx]
        it += 1
        if not estimator.is_sample_good(idx):
            continue
        for model in estimator.fit(idx):
            sq = estimator.errors(model)
            if sprt is not None:
                ok, _ = sprt.verify(sq)
                ratio = float((sq < t2).mean())
                sprt.update(ratio, ok)
                if not ok:
                    continue
            loss, inl = quality.score(sq)
            if loss < best_loss:
                best_loss = loss
                best_model = model
                best_inl = inl
                # ---- local optimization on the so-far-best model
                m2, l2, i2 = _local_opt(estimator, quality, model, inl,
                                        lo, lo_iters, rng, t2)
                if l2 < best_loss:
                    best_loss, best_model, best_inl = l2, m2, i2
                iters = min(iters, _adaptive_iters(
                    float(best_inl.mean()), k, confidence, max_iters))

    if best_model is None:
        return None, None, it
    # final polish: LSQ on inliers (ransac_solvers.cpp final_polisher)
    for _ in range(3):
        idx = np.nonzero(best_inl)[0]
        if len(idx) < k:
            break
        m = estimator.non_minimal_fit(idx)
        if m is None:
            break
        loss, inl = quality.score(estimator.errors(m))
        if loss < best_loss:
            best_loss, best_model, best_inl = loss, m, inl
        else:
            break
    return best_model, best_inl, it


def _local_opt(estimator, quality, model, inliers, lo, lo_iters, rng, t2):
    """local_optimization.cpp: inner (sampled non-minimal refits),
    iterative (threshold-annealed refits) and σ-consensus variants."""
    best_model = model
    best_loss, best_inl = quality.score(estimator.errors(model))
    if lo == LOCAL_OPTIM_NULL:
        return best_model, best_loss, best_inl

    if lo == LOCAL_OPTIM_SIGMA and hasattr(quality, "weights"):
        for _ in range(lo_iters):
            sq = estimator.errors(best_model)
            w = quality.weights(sq)
            if (w > 0).sum() < estimator.sample_size:
                break
            m = estimator.non_minimal_fit(np.nonzero(w > 0)[0],
                                          weights=w[w > 0])
            if m is None:
                break
            loss, inl = quality.score(estimator.errors(m))
            if loss + 1e-12 >= best_loss:
                break
            best_model, best_loss, best_inl = m, loss, inl
        return best_model, best_loss, best_inl

    # inner LO: non-minimal fits on random subsets of the inliers
    lo_sample = max(estimator.sample_size * 3, 14)
    for _ in range(lo_iters):
        idx = np.nonzero(best_inl)[0]
        if len(idx) < estimator.sample_size:
            break
        sub = idx if len(idx) <= lo_sample else \
            rng.choice(idx, lo_sample, replace=False)
        m = estimator.non_minimal_fit(sub)
        if m is None:
            break
        loss, inl = quality.score(estimator.errors(m))
        if loss < best_loss:
            best_model, best_loss, best_inl = m, loss, inl
        elif lo == LOCAL_OPTIM_INNER_LO:
            break

    if lo in (LOCAL_OPTIM_INNER_AND_ITER_LO, LOCAL_OPTIM_GC):
        # iterative LO: annealed threshold refits (4x -> 1x)
        for mult in (4.0, 2.0, 1.5, 1.0):
            sq = estimator.errors(best_model)
            idx = np.nonzero(sq < t2 * mult)[0]
            if len(idx) < estimator.sample_size:
                continue
            m = estimator.non_minimal_fit(idx)
            if m is None:
                continue
            loss, inl = quality.score(estimator.errors(m))
            if loss < best_loss:
                best_model, best_loss, best_inl = m, loss, inl
    return best_model, best_loss, best_inl
