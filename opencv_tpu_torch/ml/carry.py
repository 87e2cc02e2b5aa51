"""Trained ml models carried across from the JAX package.

:func:`from_reference` makes a port model from the numpy arrays of a
trained ``opencv_tpu.ml`` model, and :func:`arrays_of` reads those arrays
from such a model (by attribute; nothing of the JAX package is imported).
The port model then predicts what the JAX one does, on the port's device.
The arrays, by ``type``:

- ``"ANN_MLP"``: ``params``, the (w, b) of each layer;
- ``"SVM"``: ``models`` (each a dict of ``sv``, ``coef``, ``b``), ``pairs``,
  ``classes`` and the kernel's ``kernel_type``, ``gamma``, ``coef0``,
  ``degree``;
- ``"LogisticRegression"``: ``theta`` (classes × 1 + features), ``classes``;
- ``"EM"``: ``means``, ``vars`` (the diagonal covariances), ``weights``;
- ``"NormalBayesClassifier"``: ``means``, ``invcov``, ``logdet``,
  ``classes``;
- ``"KNearest"``: ``X``, ``y``, ``default_k``.
"""

from __future__ import annotations

import numpy as np
import torch

from .classic import KNearest, LogisticRegression, NormalBayesClassifier
from .nets import ANN_MLP, EM
from .svm import SVM

__all__ = ["arrays_of", "from_reference"]


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.array(v)


def arrays_of(model) -> dict:
    """The arrays :func:`from_reference` takes, read from a trained model
    of the JAX package (or of the port)."""
    kind = type(model).__name__
    if kind == "ANN_MLP":
        return {"type": kind, "params": [(_host(w), _host(b)) for w, b in model._params]}
    if kind == "SVM":
        return {"type": kind, "models": [{k: _host(v) for k, v in m.items()}
                                         for m in model._models],
                "pairs": list(model._pairs), "classes": _host(model._classes),
                "kernel_type": model.kernel_type, "gamma": model.gamma,
                "coef0": model.coef0, "degree": model.degree}
    if kind == "LogisticRegression":
        return {"type": kind, "theta": _host(model._theta), "classes": _host(model._classes)}
    if kind == "EM":
        return {"type": kind, "means": _host(model._means), "vars": _host(model._vars),
                "weights": _host(model._weights)}
    if kind == "NormalBayesClassifier":
        return {"type": kind, "means": _host(model._means), "invcov": _host(model._invcov),
                "logdet": _host(model._logdet), "classes": _host(model._classes)}
    if kind == "KNearest":
        return {"type": kind, "X": _host(model._X), "y": _host(model._y),
                "default_k": model.default_k}
    raise TypeError(f"no carried arrays for {kind}")


def _on(a, dtype, device):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def from_reference(model_arrays: dict, device=None):
    """A port model, on `device` ("cuda" unless asked), that predicts as
    the trained model whose arrays these are (see the module's note)."""
    kind = model_arrays["type"]
    a = model_arrays
    if kind == "ANN_MLP":
        m = ANN_MLP(device)
        m.layers = [np.asarray(a["params"][0][0]).shape[0]] + [
            np.asarray(w).shape[1] for w, _ in a["params"]]
        m._params = [(_on(w, torch.float32, m.device), _on(b, torch.float32, m.device))
                     for w, b in a["params"]]
        return m
    if kind == "SVM":
        m = SVM(device)
        m.kernel_type, m.gamma, m.coef0, m.degree = (a["kernel_type"], a["gamma"], a["coef0"],
                                                     a["degree"])
        m._models = [dict(sv=np.asarray(x["sv"], np.float32),
                          coef=np.asarray(x["coef"], np.float64), b=float(x["b"]))
                     for x in a["models"]]
        m._pairs = [tuple(p) for p in a["pairs"]]
        m._classes = np.asarray(a["classes"])
        return m
    if kind == "LogisticRegression":
        m = LogisticRegression(device=device)
        m._theta = _on(a["theta"], torch.float32, m.device)
        m._classes = np.asarray(a["classes"])
        return m
    if kind == "EM":
        m = EM()
        m.nclusters = len(np.asarray(a["weights"]))
        m._means = np.asarray(a["means"], np.float64)
        m._vars = np.asarray(a["vars"], np.float64)
        m._weights = np.asarray(a["weights"], np.float64)
        return m
    if kind == "NormalBayesClassifier":
        m = NormalBayesClassifier(device)
        m._means = _on(a["means"], torch.float64, m.device)
        m._invcov = _on(a["invcov"], torch.float64, m.device)
        m._logdet = _on(a["logdet"], torch.float64, m.device)
        m._classes = np.asarray(a["classes"])
        return m
    if kind == "KNearest":
        m = KNearest(device)
        m.default_k = a["default_k"]
        m.train(a["X"], 0, a["y"])
        return m
    raise TypeError(f"no port model for {kind}")
