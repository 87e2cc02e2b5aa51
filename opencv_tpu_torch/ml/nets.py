"""ANN_MLP and EM (ml/src/ann_mlp.cpp, em.cpp).

The port of ``opencv_tpu/ml/nets.py``: the MLP trains by ``torch.autograd``
over its forward pass on the model's device ("cuda" unless made with
``device="cpu"``), full-batch gradient descent on the mean squared error
from the same initial weights as the JAX package (the reference hand-rolls
RPROP/backprop); EM's E and M steps are the JAX package's numpy f64
log-domain matrix ops, on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dnn import default_device, exact_f32
from .classic import as_device, output

__all__ = ["ANN_MLP", "ANN_MLP_create", "EM", "EM_create"]


class ANN_MLP:
    BACKPROP = 0
    RPROP = 1
    SIGMOID_SYM = 1

    def __init__(self, device=None):
        self.device = default_device(device)
        self.layers = None
        self.lr = 0.1
        self.max_iter = 1000
        self._params = None

    @staticmethod
    def create(device=None):
        return ANN_MLP(device)

    def setLayerSizes(self, sizes):
        self.layers = [int(s) for s in np.asarray(sizes).ravel()]

    def setActivationFunction(self, f, a=1.0, b=1.0):
        pass  # symmetric sigmoid (tanh-like), the reference default

    def setTrainMethod(self, m, param1=0.1, param2=0.0):
        self.lr = param1 or 0.1

    def setTermCriteria(self, crit):
        if len(crit) > 1:
            self.max_iter = int(crit[1])

    def _init(self, rng):
        params = []
        for a, b in zip(self.layers[:-1], self.layers[1:]):
            w = rng.normal(0, np.sqrt(2.0 / a), (a, b)).astype(np.float32)
            params.append((torch.as_tensor(w, device=self.device),
                           torch.zeros(b, device=self.device)))
        return params

    @staticmethod
    def _forward(params, x):
        h = x
        for i, (w, b) in enumerate(params):
            h = h @ w + b
            if i < len(params) - 1:
                h = torch.tanh(h)
        return h

    def train(self, samples, layout=0, responses=None):
        X, _ = as_device(samples, torch.float32, self.device)
        Y, _ = as_device(responses, torch.float32, self.device)
        if Y.ndim == 1:
            Y = Y[:, None]
        params = [(w.requires_grad_(), b.requires_grad_())
                  for w, b in self._init(np.random.default_rng(0))]
        lr = self.lr
        with exact_f32():
            for _ in range(self.max_iter):
                flat = [t for wb in params for t in wb]
                loss = torch.mean((self._forward(params, X) - Y) ** 2)
                g = torch.autograd.grad(loss, flat)
                with torch.no_grad():
                    params = [((w - lr * g[2 * i]).requires_grad_(),
                               (b - lr * g[2 * i + 1]).requires_grad_())
                              for i, (w, b) in enumerate(params)]
        self._params = [(w.detach(), b.detach()) for w, b in params]
        return True

    def predict(self, samples, results=None, flags=0):
        X, as_np = as_device(samples, torch.float32, self.device)
        with exact_f32(), torch.no_grad():
            out = self._forward(self._params, X)
        return 0.0, output(out, as_np)


class EM:
    COV_MAT_SPHERICAL = 0
    COV_MAT_DIAGONAL = 1
    COV_MAT_GENERIC = 2

    def __init__(self):
        self.nclusters = 5
        self.cov_type = EM.COV_MAT_DIAGONAL
        self.max_iter = 100
        self.eps = 1e-6
        self._means = None

    @staticmethod
    def create():
        return EM()

    def setClustersNumber(self, n):
        self.nclusters = int(n)

    def setCovarianceMatrixType(self, t):
        self.cov_type = t

    def setTermCriteria(self, crit):
        if len(crit) > 1:
            self.max_iter = int(crit[1])
        if len(crit) > 2:
            self.eps = float(crit[2])

    def getMeans(self):
        return np.asarray(self._means)

    def getWeights(self):
        return np.asarray(self._weights).reshape(1, -1)

    def trainEM(self, samples, logLikelihoods=None, labels=None,
                probs=None):
        X = np.asarray(samples, np.float64)
        n, d = X.shape
        k = self.nclusters
        rng = np.random.default_rng(0)
        # kmeans++ init
        from ..ops.cluster import _pp_init
        mu = _pp_init(X, k, rng)
        var = np.tile(X.var(0) + 1e-6, (k, 1))
        w = np.full(k, 1.0 / k)

        ll_old = -np.inf
        for _ in range(self.max_iter):
            # E step (log domain, diagonal covs)
            logp = -0.5 * (((X[:, None, :] - mu[None]) ** 2
                            / var[None]).sum(-1)
                           + np.log(2 * np.pi * var).sum(-1)[None]) \
                + np.log(w)[None]
            m = logp.max(1, keepdims=True)
            lse = m[:, 0] + np.log(np.exp(logp - m).sum(1))
            resp = np.exp(logp - lse[:, None])
            ll = lse.sum()
            # M step
            nk = resp.sum(0) + 1e-12
            w = nk / n
            mu = (resp.T @ X) / nk[:, None]
            var = (resp.T @ (X ** 2)) / nk[:, None] - mu ** 2 + 1e-6
            if abs(ll - ll_old) < self.eps * abs(ll):
                break
            ll_old = ll

        self._means = mu
        self._vars = var
        self._weights = w
        lbl = np.argmax(resp, axis=1).astype(np.int32)
        return True, lse.reshape(-1, 1), lbl.reshape(-1, 1), resp

    def predict2(self, sample, probs=None):
        X = np.asarray(sample, np.float64).reshape(1, -1)
        logp = -0.5 * (((X[:, None, :] - self._means[None]) ** 2
                        / self._vars[None]).sum(-1)
                       + np.log(2 * np.pi * self._vars).sum(-1)[None]) \
            + np.log(self._weights)[None]
        m = logp.max()
        lse = m + np.log(np.exp(logp - m).sum())
        return (float(lse), float(np.argmax(logp))), \
            np.exp(logp - lse).astype(np.float64)


def ANN_MLP_create(device=None):
    return ANN_MLP(device)


def EM_create():
    return EM()
