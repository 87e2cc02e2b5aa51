"""Earth Mover's Distance (imgproc/src/emd_new.cpp / emd.cpp); twin of
``opencv_tpu/ops/emd.py``, copied: host numpy and scipy's HiGHS, so the
result is the JAX package's bit for bit.  Tensor signatures are read to the
host.

The reference solves the transportation problem with its own simplex;
here the identical LP is handed to scipy's HiGHS solver (host-side —
EMD signatures are tiny).  Distance matrices follow cv2's DIST_* types
or a user matrix.
"""

from __future__ import annotations

import numpy as np

from .. import constants as K
from .linalg import _host

__all__ = ["EMD"]


def EMD(signature1, signature2, distType, cost=None, lowerBound=None):
    """cv2.EMD: signatures are (N, 1+dims) [weight, coords...].
    Returns (emd, lowerBound, flow)."""
    s1 = _host(signature1).astype(np.float64)
    s2 = _host(signature2).astype(np.float64)
    w1 = s1[:, 0]
    w2 = s2[:, 0]
    p1 = s1[:, 1:]
    p2 = s2[:, 1:]
    n1, n2 = len(w1), len(w2)

    if cost is not None and _host(cost).size:
        C = _host(cost).astype(np.float64)
    else:
        d = p1[:, None, :] - p2[None, :, :]
        if distType == K.DIST_L1:
            C = np.abs(d).sum(-1)
        elif distType == K.DIST_C:
            C = np.abs(d).max(-1)
        else:  # DIST_L2
            C = np.sqrt((d * d).sum(-1))

    tw1 = w1.sum()
    tw2 = w2.sum()

    from scipy.optimize import linprog
    # raw-weight transportation: the smaller total is fully shipped,
    # surplus on the larger side stays unshipped (cv2 semantics), and
    # emd = total cost / total shipped flow.
    A1 = np.zeros((n1, n1 * n2))
    for i in range(n1):
        A1[i, i * n2:(i + 1) * n2] = 1
    A2 = np.zeros((n2, n1 * n2))
    for j in range(n2):
        A2[j, j::n2] = 1
    if abs(tw1 - tw2) < 1e-12 * max(tw1, tw2):
        res = linprog(C.ravel(), A_eq=np.vstack([A1, A2])[:-1],
                      b_eq=np.concatenate([w1, w2])[:-1],
                      bounds=(0, None), method="highs")
    elif tw1 < tw2:
        res = linprog(C.ravel(), A_eq=A1, b_eq=w1,
                      A_ub=A2, b_ub=w2, bounds=(0, None), method="highs")
    else:
        res = linprog(C.ravel(), A_eq=A2, b_eq=w2,
                      A_ub=A1, b_ub=w1, bounds=(0, None), method="highs")
    f = res.x.reshape(n1, n2)
    # the reference ships the surplus to a zero-cost dummy node, so the
    # normalizing total flow is the LARGER total mass
    emd = float(np.sum(f * C) / max(tw1, tw2))
    return emd, 0.0, f.astype(np.float32)
