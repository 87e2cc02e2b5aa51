"""NMS utilities (`cv2.dnn.NMSBoxes*`, modules/dnn/src/nms.cpp +
nms.inl.hpp NMSFast_) — the JAX package's numpy module, copied.

NMS is a tiny sequential reduction over at most top_k candidate boxes —
a host tail.  The IoU matrix for the candidate set is vectorized numpy
(one pass), only the greedy keep loop is sequential, mirroring
`NMSFast_`'s adaptive-threshold semantics exactly.
"""

from __future__ import annotations

import numpy as np

__all__ = ["NMSBoxes", "NMSBoxesBatched", "NMSBoxesRotated", "softNMSBoxes"]


def _max_score_index(scores, threshold, top_k):
    """GetMaxScoreIndex (nms.inl.hpp:33): filter > threshold, stable sort
    descending, truncate to top_k."""
    scores = np.asarray(scores, np.float32).reshape(-1)
    keep = np.nonzero(scores > threshold)[0]
    order = keep[np.argsort(-scores[keep], kind="stable")]
    if top_k and top_k > 0:
        order = order[:top_k]
    return order


def _rect_iou_matrix(boxes):
    """Pairwise IoU of [x, y, w, h] boxes (rectOverlap semantics)."""
    b = np.asarray(boxes, np.float64)
    x1, y1 = b[:, 0], b[:, 1]
    x2, y2 = b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]
    areas = b[:, 2] * b[:, 3]
    ix1 = np.maximum(x1[:, None], x1[None, :])
    iy1 = np.maximum(y1[:, None], y1[None, :])
    ix2 = np.minimum(x2[:, None], x2[None, :])
    iy2 = np.minimum(y2[:, None], y2[None, :])
    iw = np.maximum(ix2 - ix1, 0)
    ih = np.maximum(iy2 - iy1, 0)
    inter = iw * ih
    union = areas[:, None] + areas[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _nms_fast(order, iou, nms_threshold, eta, limit=None):
    """NMSFast_ greedy loop (nms.inl.hpp:68) on a precomputed IoU matrix
    over the ordered candidate subset."""
    adaptive = float(nms_threshold)
    kept = []
    for i in range(len(order)):
        keep = True
        for k in kept:
            if iou[i, k] > adaptive:
                keep = False
                break
        if keep:
            kept.append(i)
            if limit is not None and len(kept) >= limit:
                break
        if keep and eta < 1 and adaptive > 0.5:
            adaptive *= eta
    return order[kept]


def NMSBoxes(bboxes, scores, score_threshold, nms_threshold,
             eta: float = 1.0, top_k: int = 0):
    """cv2.dnn.NMSBoxes: boxes are [x, y, w, h]; returns kept indices."""
    order = _max_score_index(scores, score_threshold, top_k)
    if len(order) == 0:
        return np.empty((0,), np.int32)
    b = np.asarray(bboxes, np.float64).reshape(-1, 4)[order]
    iou = _rect_iou_matrix(b)
    return _nms_fast(order, iou, nms_threshold, eta).astype(np.int32)


def NMSBoxesBatched(bboxes, scores, class_ids, score_threshold,
                    nms_threshold, eta: float = 1.0, top_k: int = 0):
    """cv2.dnn.NMSBoxesBatched (nms.cpp:62): per-class NMS via the
    class-offset trick — boxes of different classes never overlap."""
    b = np.asarray(bboxes, np.float64).reshape(-1, 4)
    cid = np.asarray(class_ids, np.float64).reshape(-1)
    if len(b):
        max_coord = max(0.0, float(np.max(np.concatenate(
            [b[:, 0], b[:, 1], b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]]))))
        off = cid * (max_coord + 1)
        b = b + np.stack([off, off, np.zeros_like(off),
                          np.zeros_like(off)], axis=1)
    return NMSBoxes(b, scores, score_threshold, nms_threshold, eta, top_k)


def NMSBoxesRotated(bboxes, scores, score_threshold, nms_threshold,
                    eta: float = 1.0, top_k: int = 0):
    """cv2.dnn.NMSBoxesRotated: boxes are ((cx, cy), (w, h), angle_deg);
    IoU via rotatedRectangleIntersection + contourArea (nms.cpp:40)."""
    from ..ops.contours import rotatedRectangleIntersection, contourArea

    order = _max_score_index(scores, score_threshold, top_k)
    if len(order) == 0:
        return np.empty((0,), np.int32)
    boxes = [bboxes[i] for i in order]

    def iou(a, b):
        res, inter = rotatedRectangleIntersection(a, b)
        if inter is None or len(inter) == 0:
            return 0.0
        if res == 2:  # INTERSECT_FULL
            return 1.0
        ia = float(contourArea(np.asarray(inter, np.float32)))
        area_a = float(a[1][0]) * float(a[1][1])
        area_b = float(b[1][0]) * float(b[1][1])
        return ia / max(area_a + area_b - ia, 1e-12)

    n = len(boxes)
    m = np.zeros((n, n))
    for i in range(n):
        for j in range(i):
            m[i, j] = m[j, i] = iou(boxes[i], boxes[j])
    return _nms_fast(order, m, nms_threshold, eta).astype(np.int32)


def softNMSBoxes(bboxes, scores, score_threshold, nms_threshold,
                 top_k: int = 0, sigma: float = 0.5, method: int = 1):
    """cv2.dnn.softNMSBoxes (soft_nms.cpp): Gaussian (method=1) or linear
    (method=0) score decay.  Returns (updated_scores, indices)."""
    b = np.asarray(bboxes, np.float64).reshape(-1, 4)
    s = np.asarray(scores, np.float64).copy().reshape(-1)
    idx = list(range(len(s)))
    kept, kept_scores = [], []
    limit = top_k if top_k and top_k > 0 else len(s)
    iou_full = _rect_iou_matrix(b)
    while idx and len(kept) < limit:
        i_loc = int(np.argmax(s[idx]))
        i = idx.pop(i_loc)
        if s[i] < score_threshold:
            break
        kept.append(i)
        kept_scores.append(float(s[i]))
        if idx:
            ious = iou_full[i, idx]
            if method == 1:  # gaussian
                s[idx] = s[idx] * np.exp(-(ious * ious) / sigma)
            else:            # linear
                dec = np.where(ious > nms_threshold, 1.0 - ious, 1.0)
                s[idx] = s[idx] * dec
    return (np.asarray(kept_scores, np.float32),
            np.asarray(kept, np.int32))
