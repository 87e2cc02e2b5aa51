"""The port's ml module against opencv_tpu.ml, on the CPU, on the data of
tests/test_misc_modules.py (test_knearest, test_normal_bayes,
test_logistic_regression, test_ml_classifiers_xor, test_svmsgd).

Each model is trained in both packages on the same data and queried on the
same samples.  The numpy host code (SVMSGD, the trees, EM) gives equal
results.  KNearest's neighbours, labels and distances are equal (the
distance matrix within DIST_TOL: the f32 product sums in its own order).
Where training is an f32 iteration that the two sum in their own orders
(the logistic regression's and the MLP's gradient steps, the SVM's solver
on its f32 Gram matrix), the trained arrays agree within TRAIN_TOL and
the predictions hold the reference test's accuracy; then the JAX model's
arrays carried into the port (``ml.carry.from_reference``) predict what the
JAX model predicts: classes equal, values within PREDICT_TOL."""

import numpy as np
import pytest
import torch

from torch_threads import _one_torch_thread  # noqa: F401

from opencv_tpu import ml as jml
from opencv_tpu_torch import ml as tml
from opencv_tpu_torch.ml.carry import arrays_of, from_reference

DIST_TOL = dict(rtol=1e-5, atol=1e-5)
TRAIN_TOL = dict(rtol=1e-3, atol=1e-4)
PREDICT_TOL = dict(rtol=1e-5, atol=1e-5)


def _xor(rng, n):
    X = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    return X, ((X[:, 0] > 0) ^ (X[:, 1] > 0)).astype(np.int32)


@pytest.fixture(scope="module")
def xor():
    rng = np.random.default_rng(0)
    return _xor(rng, 400) + _xor(rng, 200)


def test_knearest():
    rng = np.random.default_rng(0)
    X = np.vstack([rng.normal(0, 1, (40, 2)), rng.normal(5, 1, (40, 2))]).astype(np.float32)
    y = np.array([0] * 40 + [1] * 40, np.float32).reshape(-1, 1)
    # ties: duplicated rows at equal distances, and a vote that ties
    X = np.vstack([X, X[:3], [[2.5, 2.5], [2.5, 2.5]]]).astype(np.float32)
    y = np.vstack([y, [[1], [1], [0]], [[0], [1]]]).astype(np.float32)
    Q = np.vstack([[[0.2, 0.1], [5.1, 4.8], [2.5, 2.5]], X[:5] + 0.01,
                   rng.normal(2.5, 2, (30, 2))]).astype(np.float32)
    j, t = jml.KNearest_create(), tml.KNearest_create(device="cpu")
    j.train(X, jml.ROW_SAMPLE, y)
    t.train(X, tml.ROW_SAMPLE, y)
    for k in (1, 2, 5, 10):
        jr, jres, jn, jd = j.findNearest(Q, k)
        tr, tres, tn, td = t.findNearest(Q, k)
        assert tr == jr
        np.testing.assert_array_equal(tres, jres)
        np.testing.assert_array_equal(tn, jn)
        np.testing.assert_allclose(td, jd, **DIST_TOL)
    j.setDefaultK(3)
    t.setDefaultK(3)
    np.testing.assert_array_equal(t.predict(Q)[1], j.predict(Q)[1])
    # tensors in, tensors out; COL_SAMPLE
    out = t.findNearest(torch.from_numpy(Q), 5)
    assert isinstance(out[1], torch.Tensor)
    t2 = tml.KNearest_create(device="cpu")
    t2.train(X.T.copy(), tml.COL_SAMPLE, y)
    np.testing.assert_array_equal(t2.findNearest(Q, 5)[2], t.findNearest(Q, 5)[2])
    c = from_reference(arrays_of(j), device="cpu")
    np.testing.assert_array_equal(c.predict(Q)[1], j.predict(Q)[1])


def test_normal_bayes():
    rng = np.random.default_rng(1)
    X = np.vstack([rng.normal(0, 1, (60, 3)), rng.normal(4, 1, (60, 3)),
                   rng.normal((0, 4, 0), 1, (60, 3))]).astype(np.float32)
    y = np.array([1] * 60 + [2] * 60 + [5] * 60, np.int32).reshape(-1, 1)
    Q = np.vstack([[[0, 0, 0], [4, 4, 4]], rng.normal(2, 2, (40, 3))]).astype(np.float32)
    j, t = jml.NormalBayesClassifier_create(), tml.NormalBayesClassifier_create(device="cpu")
    j.train(X, jml.ROW_SAMPLE, y)
    t.train(X, tml.ROW_SAMPLE, y)
    jr, jo, jp = j.predictProb(Q)
    tr, to, tp = t.predictProb(Q)
    assert tr == jr and to[0, 0] == 1 and to[1, 0] == 2
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_allclose(tp, jp, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t._means.numpy(), j._means, rtol=1e-12)
    np.testing.assert_allclose(t._invcov.numpy(), j._invcov, rtol=1e-9, atol=1e-12)
    c = from_reference(arrays_of(j), device="cpu")
    np.testing.assert_array_equal(c.predict(Q)[1], j.predict(Q)[1])


def test_logistic_regression():
    rng = np.random.default_rng(2)
    X = np.vstack([rng.normal(-1, 0.5, (50, 2)), rng.normal(1, 0.5, (50, 2)),
                   rng.normal((1, -1), 0.5, (50, 2))]).astype(np.float32)
    y = np.array([0] * 50 + [1] * 50 + [2] * 50, np.float32)
    Q = np.vstack([[[-1.2, -0.8], [1.1, 0.9]], rng.normal(0, 1.5, (40, 2))]).astype(np.float32)
    j, t = jml.LogisticRegression_create(), tml.LogisticRegression_create(device="cpu")
    for m in (j, t):
        m.setLearningRate(0.5)
        m.setIterations(300)
        m.train(X, 0, y)
    np.testing.assert_allclose(t.get_learnt_thetas(), j.get_learnt_thetas(), **TRAIN_TOL)
    _, out = t.predict(Q)
    assert out[0, 0] == 0 and out[1, 0] == 1
    assert (out == j.predict(Q)[1]).mean() > 0.95
    c = from_reference(arrays_of(j), device="cpu")
    np.testing.assert_array_equal(c.predict(Q)[1], j.predict(Q)[1])


@pytest.mark.parametrize("kernel", ["LINEAR", "POLY", "RBF", "SIGMOID"])
def test_svm(kernel, xor):
    Xtr, ytr, Xte, yte = xor
    ytr3 = np.where(Xtr[:, 0] > 0.6, 2, ytr)        # three classes: one-vs-one
    res = []
    for mod, kw in ((jml, {}), (tml, {"device": "cpu"})):
        s = mod.SVM_create(**kw)
        s.setKernel(getattr(mod.SVM, kernel))
        s.setC(5.0)
        s.setGamma(2.0 if kernel != "SIGMOID" else 0.5)
        s.setCoef0(0.5)
        s.setDegree(2.0)
        s.setTermCriteria((3, 500, 1e-3))
        s.train(Xtr, 0, ytr3)
        res.append(s)
    j, t = res
    np.testing.assert_allclose(t.getSupportVectors().shape, j.getSupportVectors().shape,
                               atol=3)
    agree = (t.predict(Xte)[1] == j.predict(Xte)[1]).mean()
    assert agree > 0.97, agree
    if kernel == "RBF":
        assert (t.predict(Xte)[1].ravel() == np.where(Xte[:, 0] > 0.6, 2, yte)).mean() > 0.9
    c = from_reference(arrays_of(j), device="cpu")
    np.testing.assert_array_equal(c.predict(Xte)[1], j.predict(Xte)[1])
    for mc, mj in zip(c._models, j._models):
        np.testing.assert_allclose(c._decision(mc, Xte), j._decision(mj, Xte), **TRAIN_TOL)


def test_trees_and_boost(xor):
    Xtr, ytr, Xte, yte = xor
    for name, setup in (("DTrees", lambda m: m.setMaxDepth(8)),
                        ("RTrees", lambda m: m.setTermCriteria((3, 30, 0))),
                        ("Boost", lambda m: (m.setWeakCount(80), m.setMaxDepth(2)))):
        out = []
        for mod in (jml, tml):
            m = getattr(mod, f"{name}_create")()
            setup(m)
            m.train(Xtr, 0, ytr)
            out.append(m.predict(Xte)[1])
        np.testing.assert_array_equal(out[1], out[0])
        assert (out[1].ravel() == yte).mean() > 0.95


def test_ann_mlp(xor):
    Xtr, ytr, Xte, yte = xor
    res = []
    for mod, kw in ((jml, {}), (tml, {"device": "cpu"})):
        m = mod.ANN_MLP_create(**kw)
        m.setLayerSizes([2, 16, 1])
        m.setTrainMethod(0, 0.2)
        m.setTermCriteria((3, 400, 0))
        m.train(Xtr, 0, ytr.astype(np.float32) * 2 - 1)
        res.append(m)
    j, t = res
    for (tw, tb), (jw, jb) in zip(t._params, j._params):
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TRAIN_TOL)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), **TRAIN_TOL)
    assert ((t.predict(Xte)[1].ravel() > 0) == yte).mean() > 0.85
    c = from_reference(arrays_of(j), device="cpu")
    np.testing.assert_allclose(c.predict(Xte)[1], j.predict(Xte)[1], **PREDICT_TOL)
    out = c.predict(torch.from_numpy(Xte))[1]
    assert isinstance(out, torch.Tensor)


def test_em():
    rng = np.random.default_rng(0)
    blobs = np.concatenate([rng.normal((0, 0), 0.3, (100, 2)),
                            rng.normal((3, 3), 0.5, (100, 2))])
    res = []
    for mod in (jml, tml):
        em = mod.EM_create()
        em.setClustersNumber(2)
        res.append((em, em.trainEM(blobs)))
    (j, jr), (t, tr) = res
    assert tr[0] and jr[0]
    for a, b in zip(tr[1:], jr[1:]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.getMeans(), j.getMeans())
    np.testing.assert_array_equal(t.getWeights(), j.getWeights())
    assert max((tr[2].ravel()[:100] == 0).mean(), (tr[2].ravel()[:100] == 1).mean()) > 0.98
    c = from_reference(arrays_of(j))
    for q in blobs[::37]:
        (a, b), pa = c.predict2(q)
        (x, y), px = j.predict2(q)
        assert (a, b) == (x, y)
        np.testing.assert_array_equal(pa, px)


def test_svmsgd():
    rng = np.random.default_rng(0)
    n = 120
    X = rng.normal(0, 1, (n, 2)).astype(np.float32)
    w_true = np.array([1.5, -2.0], np.float32)
    y = np.where(X @ w_true + 0.3 > 0, 1.0, -1.0).astype(np.float32)
    keep = np.abs(X @ w_true + 0.3) > 0.4
    X, y = X[keep], y[keep]
    for t_ in (tml.SVMSGD.SGD, tml.SVMSGD.ASGD):
        for m_ in (tml.SVMSGD.SOFT_MARGIN, tml.SVMSGD.HARD_MARGIN):
            out = []
            for mod in (jml, tml):
                s = mod.SVMSGD_create()
                s.setOptimalParameters(t_, m_)
                assert s.train(X, 0, y)
                out.append((s.predict(X)[1], s.getWeights(), s.getShift()))
            np.testing.assert_array_equal(out[1][0], out[0][0])
            np.testing.assert_array_equal(out[1][1], out[0][1])
            assert out[1][2] == out[0][2]
            assert (out[1][0].ravel() == y).mean() >= 0.97
