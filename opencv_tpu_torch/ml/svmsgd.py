"""cv::ml::SVMSGD (ml/src/svmsgd.cpp): stochastic-gradient linear SVM
with SGD and averaged-SGD variants and soft/hard margins.

Faithful port of the reference algorithm including its cv::RNG(0) sample
schedule, normalization (mean-center + global-norm scale), step decay
`initialStepSize * (1 + reg*step0*iter)^-power`, and margin-based shift.
Host tier (the reference is a scalar sequential loop over single
samples); the trained model predicts as one matvec.  The JAX package's
numpy module, copied.
"""

from __future__ import annotations

import numpy as np

__all__ = ["SVMSGD"]


class _CvRNG:
    A = 4164903690

    def __init__(self, state):
        # cv::RNG(0) maps seed 0 to 0xffffffff (core/operations.hpp:395)
        self.state = (state & 0xFFFFFFFFFFFFFFFF) or 0xFFFFFFFF

    def next(self):
        self.state = ((self.state & 0xFFFFFFFF) * self.A
                      + (self.state >> 32)) & 0xFFFFFFFFFFFFFFFF
        return self.state & 0xFFFFFFFF

    def uniform(self, a, b):
        return a + self.next() % (b - a)


class SVMSGD:
    SGD = 0
    ASGD = 1
    SOFT_MARGIN = 0
    HARD_MARGIN = 1

    def __init__(self):
        self.weights_ = None
        self.shift_ = 0.0
        self.setOptimalParameters()

    @staticmethod
    def create():
        return SVMSGD()

    # ---- params (svmsgd.cpp setOptimalParameters) ----------------------
    def setOptimalParameters(self, svmsgdType=None, marginType=None):
        if svmsgdType is None:
            svmsgdType = SVMSGD.ASGD
        if marginType is None:
            marginType = SVMSGD.SOFT_MARGIN
        self.svmsgd_type = svmsgdType
        self.margin_type = marginType
        if svmsgdType == SVMSGD.SGD:
            self.margin_regularization = 0.0001
            self.initial_step_size = 0.05
            self.step_decreasing_power = 1.0
        else:
            self.margin_regularization = 0.00001
            self.initial_step_size = 0.05
            self.step_decreasing_power = 0.75
        self.max_count = 100000
        self.epsilon = 0.00001

    def setSvmsgdType(self, v):
        self.svmsgd_type = v

    def getSvmsgdType(self):
        return self.svmsgd_type

    def setMarginType(self, v):
        self.margin_type = v

    def getMarginType(self):
        return self.margin_type

    def setMarginRegularization(self, v):
        self.margin_regularization = float(v)

    def setInitialStepSize(self, v):
        self.initial_step_size = float(v)

    def setStepDecreasingPower(self, v):
        self.step_decreasing_power = float(v)

    def setTermCriteria(self, crit):
        # (type, maxCount, epsilon)
        t, n, e = crit
        self.max_count = int(n) if (t & 1) else np.iinfo(np.int32).max
        self.epsilon = float(e) if (t & 2) else 0.0

    # ---- train / predict ----------------------------------------------
    def train(self, samples, layout=0, responses=None):
        X = np.asarray(samples, np.float32)
        y = np.asarray(responses, np.float32).reshape(-1)
        ns, nf = X.shape
        pos = int((y >= 0).sum())
        neg = ns - pos
        if pos <= 0 or neg <= 0:
            self.weights_ = np.zeros(nf, np.float32)
            self.shift_ = 1.0 if pos > 0 else -1.0
            return True

        # normalizeSamples (svmsgd.cpp:149)
        avg = X.mean(axis=0, dtype=np.float64).astype(np.float32)
        Xn = X - avg
        mult = np.float32(np.sqrt(Xn.size) / np.linalg.norm(Xn))
        Xn = Xn * mult
        ext = np.concatenate([Xn, np.ones((ns, 1), np.float32)], axis=1)

        w = np.zeros(nf + 1, np.float32)
        prev = np.zeros(nf + 1, np.float32)
        avg_w = np.zeros(nf + 1, np.float32) \
            if self.svmsgd_type == SVMSGD.ASGD else None
        rng = _CvRNG(0)
        err = np.inf
        reg = np.float32(self.margin_regularization)
        step0 = np.float32(self.initial_step_size)
        power = np.float32(self.step_decreasing_power)
        for it in range(self.max_count):
            if err <= self.epsilon:
                break
            k = rng.uniform(0, ns)
            s = ext[k]
            step = step0 * np.float32(
                (1 + reg * step0 * np.float32(it)) ** (-power))
            resp = 1.0 if y[k] >= 0 else -1.0
            if float(s @ w) * resp > 1:
                w = w * (1 - step * reg)
            else:
                w = w - (step * reg) * w + (step * np.float32(resp)) * s
            if avg_w is not None:
                avg_w = (np.float32(it) / (1 + np.float32(it))) * avg_w \
                    + w / (1 + np.float32(it))
                err = float(np.linalg.norm(avg_w - prev))
                prev = avg_w.copy()
            else:
                err = float(np.linalg.norm(w - prev))
                prev = w.copy()
        if avg_w is not None:
            w = avg_w

        self.weights_ = (w[:nf] * mult).astype(np.float32)
        if self.margin_type == SVMSGD.SOFT_MARGIN:
            self.shift_ = float(w[nf] - self.weights_ @ avg)
        else:
            d = X @ self.weights_
            m_pos = d[y >= 0].min()
            m_neg = (-d[y < 0]).min()
            self.shift_ = float(-(m_pos - m_neg) / 2.0)
        return True

    def predict(self, samples, results=None, flags=0):
        X = np.asarray(samples, np.float32)
        if X.ndim == 1:
            X = X[None]
        d = X @ self.weights_ + np.float32(self.shift_)
        out = np.where(d > 0, 1.0, -1.0).astype(np.float32)
        if len(out) == 1:
            return float(out[0]), out.reshape(-1, 1)
        return 0.0, out.reshape(-1, 1)

    def getWeights(self):
        return self.weights_.reshape(1, -1)

    def getShift(self):
        return float(self.shift_)

    def isTrained(self):
        return self.weights_ is not None
