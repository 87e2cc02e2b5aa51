"""Decision trees, random forests, boosting (ml/src/tree.cpp,
rtrees.cpp, boost.cpp).

CART construction is host recursion (data-dependent structure), but
split scoring is vectorized: every (feature, threshold) candidate's
Gini/variance gain is evaluated with cumulative sums over the sorted
responses in one shot per node.  The JAX package's numpy module, copied.
"""

from __future__ import annotations

import numpy as np

__all__ = ["DTrees", "DTrees_create", "RTrees", "RTrees_create",
           "Boost", "Boost_create"]


def _best_split(X, y, weights, classes, min_samples):
    """Vectorized exhaustive split search. Returns
    (feature, threshold, gain) or None."""
    n, d = X.shape
    if n < 2 * min_samples:
        return None
    total_w = weights.sum()
    onehot = (y[:, None] == classes[None, :]).astype(np.float64) \
        * weights[:, None]
    parent_counts = onehot.sum(0)
    parent_gini = 1.0 - ((parent_counts / total_w) ** 2).sum()

    best = None
    for f in range(d):
        order = np.argsort(X[:, f], kind="stable")
        xs = X[order, f]
        oh = onehot[order]
        cum = np.cumsum(oh, axis=0)               # left counts
        wl = cum.sum(1)
        wr = total_w - wl
        valid = (xs[1:] > xs[:-1]) & (wl[:-1] > 0) & (wr[:-1] > 0)
        idx = np.nonzero(valid)[0]
        if len(idx) == 0:
            continue
        cl = cum[idx]
        cr = parent_counts[None, :] - cl
        gl = 1.0 - ((cl / wl[idx, None]) ** 2).sum(1)
        gr = 1.0 - ((cr / wr[idx, None]) ** 2).sum(1)
        gain = parent_gini - (wl[idx] * gl + wr[idx] * gr) / total_w
        k = np.argmax(gain)
        if best is None or gain[k] > best[2]:
            thr = (xs[idx[k]] + xs[idx[k] + 1]) / 2.0
            best = (f, thr, float(gain[k]))
    if best is None or best[2] <= 1e-12:
        return None
    return best


class _Node:
    __slots__ = ("feature", "thr", "left", "right", "value")

    def __init__(self):
        self.feature = -1
        self.thr = 0.0
        self.left = None
        self.right = None
        self.value = 0.0


def _build(X, y, weights, classes, depth, max_depth, min_samples, rng,
           nactive=None):
    node = _Node()
    onehot = (y[:, None] == classes[None, :]).astype(np.float64) \
        * weights[:, None]
    node.value = classes[np.argmax(onehot.sum(0))]
    if depth >= max_depth or len(np.unique(y)) == 1:
        return node
    if nactive is not None and nactive < X.shape[1]:
        feats = rng.choice(X.shape[1], nactive, replace=False)
        sub = _best_split(X[:, feats], y, weights, classes, min_samples)
        split = None if sub is None else (feats[sub[0]], sub[1], sub[2])
    else:
        split = _best_split(X, y, weights, classes, min_samples)
    if split is None:
        return node
    f, thr, _ = split
    m = X[:, f] <= thr
    if m.sum() < min_samples or (~m).sum() < min_samples:
        return node
    node.feature = f
    node.thr = thr
    node.left = _build(X[m], y[m], weights[m], classes, depth + 1,
                       max_depth, min_samples, rng, nactive)
    node.right = _build(X[~m], y[~m], weights[~m], classes, depth + 1,
                        max_depth, min_samples, rng, nactive)
    return node


def _predict_tree(node, X):
    out = np.empty(len(X))
    idx = np.arange(len(X))
    stack = [(node, idx)]
    while stack:
        nd, ii = stack.pop()
        if nd.feature < 0 or nd.left is None:
            out[ii] = nd.value
            continue
        m = X[ii, nd.feature] <= nd.thr
        stack.append((nd.left, ii[m]))
        stack.append((nd.right, ii[~m]))
    return out


class DTrees:
    def __init__(self):
        self.max_depth = 10
        self.min_samples = 2
        self._root = None

    @staticmethod
    def create():
        return DTrees()

    def setMaxDepth(self, d):
        self.max_depth = int(d)

    def setMinSampleCount(self, c):
        self.min_samples = int(c)

    def setCVFolds(self, f):
        pass

    def train(self, samples, layout=0, responses=None):
        X = np.asarray(samples, np.float64)
        y = np.asarray(responses).ravel()
        self._classes = np.unique(y)
        w = np.ones(len(y))
        self._root = _build(X, y, w, self._classes, 0, self.max_depth,
                            self.min_samples, np.random.default_rng(0))
        return True

    def predict(self, samples, results=None, flags=0):
        X = np.asarray(samples, np.float64)
        out = _predict_tree(self._root, X)
        return 0.0, out.astype(np.float32).reshape(-1, 1)


class RTrees(DTrees):
    def __init__(self):
        super().__init__()
        self.ntrees = 50
        self.max_depth = 12
        self._forest = None

    @staticmethod
    def create():
        return RTrees()

    def setTermCriteria(self, crit):
        if len(crit) > 1:
            self.ntrees = int(crit[1])

    def setActiveVarCount(self, n):
        self._nactive = int(n)

    def train(self, samples, layout=0, responses=None):
        X = np.asarray(samples, np.float64)
        y = np.asarray(responses).ravel()
        self._classes = np.unique(y)
        n = len(y)
        nactive = getattr(self, "_nactive", 0) or \
            max(1, int(np.sqrt(X.shape[1])))
        rng = np.random.default_rng(5489)
        self._forest = []
        w = np.ones(n)
        for _ in range(self.ntrees):
            boot = rng.integers(0, n, n)
            self._forest.append(_build(
                X[boot], y[boot], w, self._classes, 0, self.max_depth,
                self.min_samples, rng, nactive))
        return True

    def predict(self, samples, results=None, flags=0):
        X = np.asarray(samples, np.float64)
        preds = np.stack([_predict_tree(t, X) for t in self._forest])
        out = []
        for col in preds.T:
            vals, cnt = np.unique(col, return_counts=True)
            out.append(vals[np.argmax(cnt)])
        return 0.0, np.asarray(out, np.float32).reshape(-1, 1)


class Boost(DTrees):
    """Discrete AdaBoost over depth-limited CARTs (boost.cpp)."""

    DISCRETE = 0
    REAL = 1

    def __init__(self):
        super().__init__()
        self.weak_count = 100
        self.max_depth = 1

    @staticmethod
    def create():
        return Boost()

    def setBoostType(self, t):
        pass

    def setWeakCount(self, c):
        self.weak_count = int(c)

    def train(self, samples, layout=0, responses=None):
        X = np.asarray(samples, np.float64)
        y0 = np.asarray(responses).ravel()
        self._classes = np.unique(y0)
        assert len(self._classes) == 2, "Boost: binary only (like CvBoost)"
        y = np.where(y0 == self._classes[1], 1.0, -1.0)
        n = len(y)
        w = np.ones(n) / n
        self._weaks = []
        rng = np.random.default_rng(0)
        for _ in range(self.weak_count):
            tree = _build(X, y, w, np.array([-1.0, 1.0]), 0,
                          self.max_depth, self.min_samples, rng)
            pred = _predict_tree(tree, X)
            err = np.sum(w * (pred != y))
            err = min(max(err, 1e-10), 1 - 1e-10)
            a = 0.5 * np.log((1 - err) / err)
            self._weaks.append((tree, a))
            w = w * np.exp(-a * y * pred)
            w /= w.sum()
            if err < 1e-9:
                break
        return True

    def predict(self, samples, results=None, flags=0):
        X = np.asarray(samples, np.float64)
        s = np.zeros(len(X))
        for tree, a in self._weaks:
            s += a * _predict_tree(tree, X)
        out = np.where(s > 0, self._classes[1], self._classes[0])
        return 0.0, out.astype(np.float32).reshape(-1, 1)


def DTrees_create():
    return DTrees()


def RTrees_create():
    return RTrees()


def Boost_create():
    return Boost()
