"""Support vector machine (ml/src/svm.cpp).

C_SVC / NU-free SMO with LINEAR / RBF / POLY / SIGMOID kernels — the port
of ``opencv_tpu/ml/svm.py``.  The kernel Gram matrix and every prediction's
decision values are torch matrix products on the model's device ("cuda"
unless made with ``device="cpu"``); the SMO working-set loop is host f64
control flow over the Gram matrix read back once, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dnn import default_device, exact_f32

__all__ = ["SVM", "SVM_create"]


class SVM:
    C_SVC = 100
    NU_SVC = 101
    ONE_CLASS = 102
    EPS_SVR = 103
    NU_SVR = 104

    LINEAR = 0
    POLY = 1
    RBF = 2
    SIGMOID = 3

    def __init__(self, device=None):
        self.device = default_device(device)
        self.svm_type = SVM.C_SVC
        self.kernel_type = SVM.RBF
        self.C = 1.0
        self.gamma = 1.0
        self.coef0 = 0.0
        self.degree = 3.0
        self.tol = 1e-3
        self.max_iter = 2000
        self._models = None

    @staticmethod
    def create(device=None):
        return SVM(device)

    # --- parameter surface (cv2.ml.SVM_*)
    def setType(self, t):
        self.svm_type = t

    def setKernel(self, k):
        self.kernel_type = k

    def setC(self, c):
        self.C = float(c)

    def setGamma(self, g):
        self.gamma = float(g)

    def setCoef0(self, c):
        self.coef0 = float(c)

    def setDegree(self, d):
        self.degree = float(d)

    def setTermCriteria(self, crit):
        if len(crit) > 1:
            self.max_iter = int(crit[1])
        if len(crit) > 2:
            self.tol = float(crit[2])

    def getSupportVectors(self):
        if not self._models:
            return np.zeros((0, 0), np.float32)
        return np.concatenate([m["sv"] for m in self._models]
                              ).astype(np.float32)

    def _kernel(self, A, B):
        """The f32 kernel matrix of the rows of A and B, on the device."""
        A = torch.as_tensor(np.asarray(A, np.float32), device=self.device)
        B = torch.as_tensor(np.asarray(B, np.float32), device=self.device)
        with exact_f32():
            G = A @ B.T
        if self.kernel_type == SVM.LINEAR:
            return G
        if self.kernel_type == SVM.POLY:
            return (self.gamma * G + self.coef0) ** self.degree
        if self.kernel_type == SVM.SIGMOID:
            return torch.tanh(self.gamma * G + self.coef0)
        # RBF
        d2 = (torch.sum(A * A, 1)[:, None] - 2 * G
              + torch.sum(B * B, 1)[None, :])
        return torch.exp(-self.gamma * d2)

    def _smo(self, X, y):
        """Binary SMO (simplified Platt; ml/src/svm.cpp Solver)."""
        n = len(y)
        K = self._kernel(X, X).cpu().numpy().astype(np.float64)
        Q = K * np.outer(y, y)
        alpha = np.zeros(n)
        g = np.ones(n)           # gradient of dual: 1 - Q alpha
        C = self.C
        for _ in range(self.max_iter):
            # working set selection (maximal violating pair)
            up = ((alpha < C - 1e-12) & (y > 0)) | ((alpha > 1e-12) & (y < 0))
            lo = ((alpha < C - 1e-12) & (y < 0)) | ((alpha > 1e-12) & (y > 0))
            if not up.any() or not lo.any():
                break
            yg = y * g
            i = np.argmax(np.where(up, yg, -np.inf))
            j = np.argmin(np.where(lo, yg, np.inf))
            if yg[i] - yg[j] < self.tol:
                break
            # solve the 2-variable subproblem
            quad = max(Q[i, i] + Q[j, j] - 2 * y[i] * y[j] * Q[i, j], 1e-12)
            delta = (yg[i] - yg[j]) / quad
            # clip to box
            ai_old, aj_old = alpha[i], alpha[j]
            ai = ai_old + y[i] * delta
            aj = aj_old - y[j] * delta
            # box clipping
            ai = min(max(ai, 0.0), C)
            dai = (ai - ai_old) * y[i]
            aj = aj_old - y[j] * dai * 1.0
            aj = min(max(aj, 0.0), C)
            dai = -(aj - aj_old) * y[j]
            ai = ai_old + y[i] * dai
            ai = min(max(ai, 0.0), C)
            da_i = ai - ai_old
            da_j = aj - aj_old
            if abs(da_i) < 1e-14 and abs(da_j) < 1e-14:
                break
            alpha[i], alpha[j] = ai, aj
            g -= Q[:, i] * da_i + Q[:, j] * da_j
        # rho (bias): average over free vectors
        free = (alpha > 1e-8) & (alpha < C - 1e-8)
        dec = (K * (alpha * y)[None, :]).sum(1)
        if free.any():
            b = np.mean(y[free] - dec[free])
        else:
            b = np.mean(y - dec) if n else 0.0
        sv = alpha > 1e-8
        return dict(sv=np.asarray(X)[sv], coef=(alpha * y)[sv], b=b)

    def train(self, samples, layout=0, responses=None):
        X = np.asarray(samples, np.float32)
        y = np.asarray(responses).ravel().astype(np.int64)
        self._classes = np.unique(y)
        self._models = []
        self._pairs = []
        # one-vs-one like the reference
        for a in range(len(self._classes)):
            for bcl in range(a + 1, len(self._classes)):
                ca, cb = self._classes[a], self._classes[bcl]
                sel = (y == ca) | (y == cb)
                yy = np.where(y[sel] == ca, 1.0, -1.0)
                m = self._smo(X[sel], yy)
                self._models.append(m)
                self._pairs.append((ca, cb))
        return True

    def _decision(self, m, Q):
        k = self._kernel(Q, m["sv"]).cpu().numpy().astype(np.float64)
        return k @ m["coef"] + m["b"]

    def predict(self, samples, results=None, flags=0):
        Q = samples.detach().cpu().numpy() if isinstance(samples, torch.Tensor) \
            else np.asarray(samples, np.float32)
        votes = np.zeros((len(Q), len(self._classes)), np.int32)
        cls_idx = {c: i for i, c in enumerate(self._classes)}
        for m, (ca, cb) in zip(self._models, self._pairs):
            d = self._decision(m, Q)
            votes[:, cls_idx[ca]] += d > 0
            votes[:, cls_idx[cb]] += d <= 0
        out = self._classes[np.argmax(votes, axis=1)]
        return 0.0, out.astype(np.float32).reshape(-1, 1)


def SVM_create(device=None):
    return SVM(device)
