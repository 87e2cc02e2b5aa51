"""Classic ML (modules/ml): KNearest / NormalBayes / LogisticRegression —
the port of ``opencv_tpu/ml/classic.py``.

A model holds its data on its device ("cuda" unless made with
``device="cpu"``): KNearest's distance matrix (the JAX package's formula,
|q|² + |t|² − 2 q·t clamped at 0, in that order of terms), its stable sort
and the vote; NormalBayes' f64 statistics and quadratic forms; the logistic
regression's gradient steps, all classes as the columns of one matrix.
Numpy samples give numpy results, tensors give tensors on the model's
device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dnn import default_device, exact_f32

ROW_SAMPLE = 0
COL_SAMPLE = 1

__all__ = ["KNearest", "KNearest_create", "NormalBayesClassifier",
           "NormalBayesClassifier_create", "LogisticRegression",
           "LogisticRegression_create", "ROW_SAMPLE", "COL_SAMPLE"]

# query rows per block of KNearest's distance matrix
KNN_BLOCK = 2048


def as_device(v, dtype, device):
    """(v as a tensor of dtype on device, whether v was not a tensor)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype), False
    return torch.as_tensor(np.asarray(v)).to(device=device, dtype=dtype), True


def output(t, as_numpy):
    return t.cpu().numpy() if as_numpy else t


def l2sq(q, t):
    """The squared distances of the rows of q to those of t, as the JAX
    package's ``_l2sq``: max(|q|² + |t|² − 2 q·t, 0) in f32."""
    q2 = torch.sum(q * q, dim=1, keepdim=True)
    t2 = torch.sum(t * t, dim=1, keepdim=True)
    with exact_f32():
        g = q @ t.T
    return torch.clamp(q2 + t2.T - 2 * g, min=0.0)


class KNearest:
    def __init__(self, device=None):
        self.device = default_device(device)
        self._X = None
        self._y = None
        self.default_k = 10

    @staticmethod
    def create(device=None):
        return KNearest(device)

    def setDefaultK(self, k):
        self.default_k = k

    def train(self, samples, layout=ROW_SAMPLE, responses=None):
        X, _ = as_device(samples, torch.float32, self.device)
        if layout == COL_SAMPLE:
            X = X.T.contiguous()
        self._X = X
        y = responses.detach().cpu().numpy() if isinstance(responses, torch.Tensor) \
            else np.asarray(responses)
        self._y = y.reshape(-1)
        self._classes = np.unique(self._y)
        # each training row's class index, for the vote
        self._yi = torch.as_tensor(np.searchsorted(self._classes, self._y), device=self.device)
        self._yv = torch.as_tensor(self._y.astype(np.float32), device=self.device)
        return True

    def findNearest(self, samples, k):
        """(first result, results (n, 1), neighbour labels (n, k), distances
        (n, k)): the k nearest training rows by a stable sort of each
        query's distances, and the most frequent label among them (the
        smallest label of a tie, as ``np.unique``'s first maximum)."""
        q, as_np = as_device(samples, torch.float32, self.device)
        idx, dists = [], []
        for s in range(0, q.shape[0], KNN_BLOCK):
            d = l2sq(q[s:s + KNN_BLOCK], self._X)
            order = torch.sort(d, dim=1, stable=True).indices[:, :k]
            idx.append(order)
            dists.append(torch.gather(d, 1, order))
        idx = torch.cat(idx)
        dists = torch.cat(dists)
        votes = torch.zeros((q.shape[0], len(self._classes)), dtype=torch.int64,
                            device=self.device)
        votes.scatter_add_(1, self._yi[idx], torch.ones_like(idx))
        best = torch.argmax(votes, dim=1)
        results = torch.as_tensor(self._classes.astype(np.float32),
                                  device=self.device)[best].reshape(-1, 1)
        nlabels = self._yv[idx]
        return (float(results[0, 0]), output(results, as_np), output(nlabels, as_np),
                output(dists, as_np))

    def predict(self, samples):
        r, results, _, _ = self.findNearest(samples, self.default_k)
        return r, results


def KNearest_create(device=None):
    return KNearest(device)


class NormalBayesClassifier:
    def __init__(self, device=None):
        self.device = default_device(device)
        self._means = None
        self._invcov = None
        self._logdet = None
        self._classes = None

    @staticmethod
    def create(device=None):
        return NormalBayesClassifier(device)

    def train(self, samples, layout=ROW_SAMPLE, responses=None):
        X, _ = as_device(samples, torch.float64, self.device)
        if layout == COL_SAMPLE:
            X = X.T
        y = responses.detach().cpu().numpy() if isinstance(responses, torch.Tensor) \
            else np.asarray(responses)
        y = y.reshape(-1)
        self._classes = np.unique(y)
        yt = torch.as_tensor(y, device=self.device)
        eye = torch.eye(X.shape[1], dtype=torch.float64, device=self.device)
        means, invcovs, logdets = [], [], []
        for c in self._classes:
            Xi = X[yt == torch.as_tensor(c, device=self.device)]
            mu = Xi.mean(dim=0)
            d = Xi - mu
            cov = d.T @ d / (Xi.shape[0] - 1) + eye * 1e-6
            means.append(mu)
            invcovs.append(torch.linalg.inv(cov))
            logdets.append(torch.linalg.slogdet(cov)[1])
        self._means = torch.stack(means)
        self._invcov = torch.stack(invcovs)
        self._logdet = torch.stack(logdets)
        return True

    def predictProb(self, inputs):
        X, as_np = as_device(inputs, torch.float64, self.device)
        ll = []
        for i in range(len(self._classes)):
            d = X - self._means[i]
            ll.append(-0.5 * (((d @ self._invcov[i]) * d).sum(dim=1) + self._logdet[i]))
        ll = torch.stack(ll, dim=1)
        best = torch.as_tensor(self._classes, device=self.device)[ll.argmax(dim=1)]
        p = torch.exp(ll - ll.amax(dim=1, keepdim=True))
        p = p / p.sum(dim=1, keepdim=True)
        best = best.to(torch.float32).reshape(-1, 1)
        return float(best[0, 0]), output(best, as_np), output(p.to(torch.float32), as_np)

    def predict(self, inputs):
        r, out, _ = self.predictProb(inputs)
        return r, out


def NormalBayesClassifier_create(device=None):
    return NormalBayesClassifier(device)


class LogisticRegression:
    REG_L2 = 1
    BATCH = 0
    MINI_BATCH = 1

    def __init__(self, learning_rate=0.001, iterations=1000, reg=1, device=None):
        self.device = default_device(device)
        self.lr = learning_rate
        self.iters = iterations
        self._theta = None
        self._classes = None

    @staticmethod
    def create(device=None):
        return LogisticRegression(device=device)

    def setLearningRate(self, lr):
        self.lr = lr

    def setIterations(self, n):
        self.iters = n

    def setRegularization(self, r):
        pass

    def setTrainMethod(self, m):
        pass

    def train(self, samples, layout=ROW_SAMPLE, responses=None):
        """One-vs-rest batch gradient descent, the JAX package's step
        theta -= lr * Xb^T (sigmoid(Xb theta) - t) / n, for every class at
        once (theta the columns of one matrix)."""
        X, _ = as_device(samples, torch.float32, self.device)
        if layout == COL_SAMPLE:
            X = X.T
        y = responses.detach().cpu().numpy() if isinstance(responses, torch.Tensor) \
            else np.asarray(responses)
        y = y.reshape(-1)
        self._classes = np.unique(y)
        Xb = torch.cat([torch.ones((X.shape[0], 1), device=self.device), X], dim=1)
        yt = torch.as_tensor(y, device=self.device)
        T = torch.stack([(yt == torch.as_tensor(c, device=self.device)).to(torch.float32)
                         for c in self._classes], dim=1)
        theta = torch.zeros((Xb.shape[1], len(self._classes)), device=self.device)
        n = len(y)
        with exact_f32():
            for _ in range(self.iters):
                p = torch.sigmoid(Xb @ theta)
                g = Xb.T @ (p - T) / n
                theta = theta - self.lr * g
        self._theta = theta.T.contiguous()
        return True

    def predict(self, samples):
        X, as_np = as_device(samples, torch.float32, self.device)
        Xb = torch.cat([torch.ones((X.shape[0], 1), device=self.device), X], dim=1)
        with exact_f32():
            scores = Xb @ self._theta.T
        out = torch.as_tensor(self._classes, device=self.device)[scores.argmax(dim=1)]
        out = out.to(torch.float32).reshape(-1, 1)
        return float(out[0, 0]), output(out, as_np)

    def get_learnt_thetas(self):
        return self._theta.cpu().numpy()


def LogisticRegression_create(device=None):
    return LogisticRegression(device=device)
