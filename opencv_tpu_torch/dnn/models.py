"""High-level model API (`cv2.dnn.Model` family, modules/dnn/src/model.cpp).

Model wraps a Net with preprocessing params (size/mean/scale/swapRB/crop);
subclasses add task-specific postprocessing:
- ClassificationModel.classify (model.cpp:251)
- DetectionModel.detect — DetectionOutput (1x1xNx7) and YOLO Region
  (Nx(classes+5)) decoders with reference box clipping (model.cpp:495)
- SegmentationModel.segment — per-pixel argmax (model.cpp:406)

The port of ``opencv_tpu/dnn/models.py``: a model runs its net on the net's
device ("cuda" unless it was made with ``device="cpu"``), the frame is
moved there and made a blob there; the YOLO rows are decoded and thresholded
there (:func:`decode_yolo`), and what is left (NMS, CTC, contours) runs on
the host, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .onnx_ops import _np

__all__ = ["Model", "ClassificationModel", "DetectionModel",
           "SegmentationModel", "KeypointsModel", "TextRecognitionModel",
           "TextDetectionModel_EAST", "TextDetectionModel_DB"]


def _read_any(path, config=None, device=None):
    from . import readNetFromONNX
    from .importers import readNetFromCaffe, readNetFromTensorflow

    p = str(path)
    if p.endswith(".onnx"):
        return readNetFromONNX(p, device)
    if p.endswith(".caffemodel") or p.endswith(".prototxt"):
        return readNetFromCaffe(config or p, p, device)
    if p.endswith(".pb"):
        return readNetFromTensorflow(p, config, device)
    if p.endswith(".tflite"):
        from .tflite import readNetFromTFLite
        return readNetFromTFLite(p, device)
    raise ValueError(f"cannot infer model format for {p}")


def _frame_np(frame):
    return frame.detach().cpu().numpy() if isinstance(frame, torch.Tensor) else np.asarray(frame)


def decode_yolo(outs, fh, fw, confThreshold):
    """DetectionModel.detect's YOLO decode (model.cpp:495) of one frame's
    Region rows [cx, cy, w, h, obj, class scores...] (a list of (rows, C)
    arrays or tensors): each row's best class and its score, the rows whose
    score is not under confThreshold, and their boxes in frame pixels,
    clipped to the frame — as the JAX package's row loop gives them, in its
    order.  Returns (class_ids int32, confs float32, boxes int32 (n, 4)) as
    numpy; the scores and the threshold are taken on the rows' device."""
    return decode_yolo_batch([torch.as_tensor(o)[None] for o in outs], fh, fw,
                             confThreshold)[0]


def decode_yolo_batch(heads, fh, fw, confThreshold):
    """:func:`decode_yolo` of each frame of a batch at once: `heads` are
    (N, rows, C) per head, one read-back for the batch.  Returns a list of
    N (class_ids, confs, boxes)."""
    rows = torch.cat([torch.as_tensor(h) for h in heads], dim=1)
    scores = rows[..., 5:]
    cid = torch.argmax(scores, dim=-1)
    conf = scores.gather(-1, cid[..., None])[..., 0]
    keep = ~(conf.to(torch.float64) < confThreshold)
    # int(row * fw): the f32 product, truncated toward zero
    xywh = torch.stack([rows[..., 0] * fw, rows[..., 1] * fh, rows[..., 2] * fw,
                        rows[..., 3] * fh], dim=-1).to(torch.int64)
    packed = torch.cat([keep[..., None], cid[..., None], conf[..., None], xywh],
                       dim=-1).to(torch.float64).cpu().numpy()
    out = []
    for p in packed:
        p = p[p[:, 0] > 0]
        cx, cy, w, h = p[:, 3:].astype(np.int64).T
        left = np.maximum(0, np.minimum(cx - w // 2, fw - 1))
        top = np.maximum(0, np.minimum(cy - h // 2, fh - 1))
        w = np.maximum(1, np.minimum(w, fw - left))
        h = np.maximum(1, np.minimum(h, fh - top))
        boxes = np.stack([left, top, w, h], axis=1).astype(np.int32).reshape(-1, 4)
        out.append((p[:, 1].astype(np.int32), p[:, 2].astype(np.float32), boxes))
    return out


class Model:
    def __init__(self, model, config=None, device=None):
        self._net = model if hasattr(model, "forward") else \
            _read_any(model, config, device)
        self._size = None
        self._mean = (0.0, 0.0, 0.0, 0.0)
        self._scale = 1.0
        self._swapRB = False
        self._crop = False

    # -- preprocessing params (model.cpp setInput*) ------------------------
    def setInputSize(self, size, height=None):
        self._size = (int(size), int(height)) if height is not None \
            else (int(size[0]), int(size[1]))
        return self

    def setInputMean(self, mean):
        self._mean = mean
        return self

    def setInputScale(self, scale):
        self._scale = scale
        return self

    def setInputSwapRB(self, swapRB):
        self._swapRB = bool(swapRB)
        return self

    def setInputCrop(self, crop):
        self._crop = bool(crop)
        return self

    def setInputParams(self, scale=1.0, size=(), mean=(), swapRB=False,
                       crop=False):
        if size:
            self.setInputSize(size)
        self._mean = mean if mean != () else self._mean
        self._scale = scale
        self._swapRB = swapRB
        self._crop = crop
        return self

    def _preprocess(self, frame):
        from . import blobFromImage

        frame = (frame if isinstance(frame, torch.Tensor)
                 else torch.from_numpy(np.ascontiguousarray(frame))).to(self._net.device)
        size = self._size or (frame.shape[1], frame.shape[0])
        return blobFromImage(frame, scalefactor=self._scale, size=size,
                             mean=self._mean, swapRB=self._swapRB,
                             crop=self._crop)

    def predict(self, frame):
        self._net.setInput(self._preprocess(frame))
        return self._net.forward(self._net.getUnconnectedOutLayersNames())


class ClassificationModel(Model):
    def classify(self, frame):
        outs = self.predict(frame)
        out = _np(outs[0] if isinstance(outs, (list, tuple)) else outs)
        out = out.reshape(-1)
        cls = int(np.argmax(out))
        return cls, float(out[cls])


class SegmentationModel(Model):
    def segment(self, frame):
        outs = self.predict(frame)
        out = outs[0] if isinstance(outs, (list, tuple)) else outs
        # (1, C, H, W) → per-pixel argmax class id (model.cpp:406)
        return _np(torch.argmax(out[0], dim=0)).astype(np.uint8)


class DetectionModel(Model):
    def __init__(self, model, config=None, device=None):
        super().__init__(model, config, device)
        self._nms_across_classes = False

    def setNmsAcrossClasses(self, value):
        self._nms_across_classes = bool(value)
        return self

    def getNmsAcrossClasses(self):
        return self._nms_across_classes

    def detect(self, frame, confThreshold=0.5, nmsThreshold=0.0):
        fh, fw = frame.shape[:2]
        outs = self.predict(frame)
        if not isinstance(outs, (list, tuple)):
            outs = [outs]
        return self.postprocess(outs, fh, fw, confThreshold, nmsThreshold)

    def postprocess(self, outs, fh, fw, confThreshold=0.5, nmsThreshold=0.0):
        """detect's decode and NMS of one frame's net outputs."""
        from .nms import NMSBoxes, NMSBoxesBatched

        class_ids, confs, boxes = [], [], []
        is_det_output = outs[0].ndim == 4 and outs[0].shape[-1] == 7

        if is_det_output:
            outs = [_np(o) for o in outs]
            # [batchId, classId, conf, l, t, r, b] rows (model.cpp:520)
            for out in outs:
                for row in out.reshape(-1, 7):
                    conf = float(row[2])
                    if conf < confThreshold:
                        continue
                    l, t, r, b = (int(row[3]), int(row[4]),
                                  int(row[5]), int(row[6]))
                    w, h = r - l + 1, b - t + 1
                    if w <= 2 or h <= 2:  # normalized coords
                        l = int(row[3] * fw)
                        t = int(row[4] * fh)
                        r = int(row[5] * fw)
                        b = int(row[6] * fh)
                        w, h = r - l + 1, b - t + 1
                    l = max(0, min(l, fw - 1))
                    t = max(0, min(t, fh - 1))
                    w = max(1, min(w, fw - l))
                    h = max(1, min(h, fh - t))
                    boxes.append((l, t, w, h))
                    class_ids.append(int(row[1]))
                    confs.append(conf)
        else:
            # YOLO Region rows: [cx, cy, w, h, obj, class scores...]
            class_ids, confs, boxes = decode_yolo(outs, fh, fw, confThreshold)
            if nmsThreshold:
                if self._nms_across_classes:
                    keep = NMSBoxes(boxes, confs, confThreshold,
                                    nmsThreshold)
                else:
                    keep = NMSBoxesBatched(boxes, confs, class_ids,
                                           confThreshold, nmsThreshold)
                boxes = boxes[keep]
                confs = confs[keep]
                class_ids = class_ids[keep]

        return (np.asarray(class_ids, np.int32),
                np.asarray(confs, np.float32),
                np.asarray(boxes, np.int32).reshape(-1, 4))


class KeypointsModel(Model):
    """cv2.dnn.KeypointsModel (model.cpp:334): heatmap argmax per
    keypoint channel, rescaled to frame coordinates."""

    def estimate(self, frame, thresh=0.5):
        fh, fw = frame.shape[:2]
        outs = self.predict(frame)
        out = _np(outs[0] if isinstance(outs, (list, tuple)) else outs)
        points = []
        if out.ndim == 4:
            n, h, w = out.shape[1], out.shape[2], out.shape[3]
            for k in range(n - 1):       # last channel = background
                pm = out[0, k]
                iy, ix = np.unravel_index(np.argmax(pm), pm.shape)
                if pm[iy, ix] > thresh:
                    points.append((ix * fw / w, iy * fh / h))
                else:
                    points.append((-1.0, -1.0))
        else:
            points = [tuple(p) for p in out.reshape(-1, 2)]
        return np.asarray(points, np.float32)


class TextRecognitionModel(Model):
    """cv2.dnn.TextRecognitionModel (model.cpp:656): CTC decoding with
    a user vocabulary."""

    def __init__(self, model, config=None, device=None):
        super().__init__(model, config, device)
        self._decode_type = ""
        self._vocabulary = []
        self._beam_size = 10

    def setDecodeType(self, t):
        self._decode_type = t
        return self

    def getDecodeType(self):
        return self._decode_type

    def setVocabulary(self, voc):
        self._vocabulary = list(voc)
        return self

    def getVocabulary(self):
        return list(self._vocabulary)

    def setDecodeOptsCTCPrefixBeamSearch(self, beamSize, vocPruneSize=0):
        self._beam_size = int(beamSize)
        return self

    def _ctc_greedy(self, pred):
        """model.cpp:717 ctcGreedyDecode (class 0 = CTC blank)."""
        seq = []
        last = 0
        flag = True
        for t in range(pred.shape[0]):
            j = int(np.argmax(pred[t, :len(self._vocabulary) + 1]))
            if j > 0:
                if j != last or flag:
                    last = j
                    seq.append(self._vocabulary[j - 1])
                    flag = False
            else:
                flag = True
        return "".join(seq)

    def _ctc_beam(self, pred):
        """CTC prefix beam search over log-probs (model.cpp:837)."""
        T = pred.shape[0]
        V = len(self._vocabulary) + 1
        # the reference consumes the net outputs directly as
        # log-probabilities (model.cpp:870 prefixScore.pB + prob)
        logp = pred[:, :V]
        NEG = -1e30
        beams = {(): (0.0, NEG)}    # prefix -> (log p_blank, log p_nonblank)

        def logadd(a, b):
            if a <= NEG:
                return b
            if b <= NEG:
                return a
            m = max(a, b)
            return m + np.log(np.exp(a - m) + np.exp(b - m))

        for t in range(T):
            new = {}
            for prefix, (pb, pnb) in beams.items():
                total = logadd(pb, pnb)
                # blank
                e = new.get(prefix, (NEG, NEG))
                new[prefix] = (logadd(e[0], total + logp[t, 0]), e[1])
                # repeat last char (non-blank path only)
                if prefix:
                    lastc = prefix[-1]
                    e = new.get(prefix, (NEG, NEG))
                    new[prefix] = (e[0],
                                   logadd(e[1], pnb + logp[t, lastc]))
                for c in range(1, V):
                    np_prefix = prefix + (c,)
                    if prefix and prefix[-1] == c:
                        src = pb
                    else:
                        src = total
                    e = new.get(np_prefix, (NEG, NEG))
                    new[np_prefix] = (e[0],
                                      logadd(e[1], src + logp[t, c]))
            beams = dict(sorted(
                new.items(),
                key=lambda kv: -logadd(kv[1][0], kv[1][1])
            )[:self._beam_size])
        best = max(beams.items(),
                   key=lambda kv: logadd(kv[1][0], kv[1][1]))[0]
        return "".join(self._vocabulary[c - 1] for c in best)

    def recognize(self, frame, roiRects=None):
        if roiRects is not None:
            return [self.recognize(_frame_np(frame)[
                int(r[1]):int(r[1] + r[3]), int(r[0]):int(r[0] + r[2])])
                for r in roiRects]
        outs = self.predict(frame)
        out = _np(outs[0] if isinstance(outs, (list, tuple)) else outs)
        pred = out.reshape(out.shape[0], -1) if out.ndim == 2 else \
            out.reshape(out.shape[0], out.shape[-1])
        if out.ndim == 3:           # (T, 1, V)
            pred = out[:, 0, :]
        if self._decode_type == "CTC-greedy":
            return self._ctc_greedy(pred)
        if self._decode_type == "CTC-prefix-beam-search":
            return self._ctc_beam(pred)
        raise ValueError("TextRecognitionModel: decodeType is not set")


class TextDetectionModel_EAST(Model):
    """cv2.dnn.TextDetectionModel_EAST (model.cpp:1129)."""

    def __init__(self, model, config=None, device=None):
        super().__init__(model, config, device)
        self._conf = 0.5
        self._nms = 0.0

    def setConfidenceThreshold(self, v):
        self._conf = float(v)
        return self

    def getConfidenceThreshold(self):
        return self._conf

    def setNMSThreshold(self, v):
        self._nms = float(v)
        return self

    def getNMSThreshold(self):
        return self._nms

    def detectTextRectangles(self, frame):
        """Returns (rotated_rects [( (cx,cy),(w,h), angle_deg )],
        confidences) — model.cpp:1161."""
        from .nms import NMSBoxesRotated

        fh, fw = frame.shape[:2]
        outs = self.predict(frame)
        geometry, score_map = _np(outs[0]), _np(outs[1])
        if geometry.shape[1] == 1 and score_map.shape[1] == 5:
            geometry, score_map = score_map, geometry
        H, W = score_map.shape[2], score_map.shape[3]
        boxes, scores = [], []
        for y in range(H):
            for x in range(W):
                sc = float(score_map[0, 0, y, x])
                if sc < self._conf:
                    continue
                x0 = geometry[0, 0, y, x]
                x1 = geometry[0, 1, y, x]
                x2 = geometry[0, 2, y, x]
                x3 = geometry[0, 3, y, x]
                ang = geometry[0, 4, y, x]
                ca, sa = np.cos(ang), np.sin(ang)
                h = x0 + x2
                w = x1 + x3
                offx = 4.0 * x + ca * x1 + sa * x2
                offy = 4.0 * y - sa * x1 + ca * x2
                p1 = (-sa * h + offx, -ca * h + offy)
                p3 = (-ca * w + offx, sa * w + offy)
                boxes.append(((0.5 * (p1[0] + p3[0]),
                               0.5 * (p1[1] + p3[1])),
                              (float(w), float(h)),
                              float(-ang * 180.0 / np.pi)))
                scores.append(sc)
        keep = NMSBoxesRotated(boxes, scores, self._conf, self._nms) \
            if self._nms > 0 else list(range(len(boxes)))
        size = self._size or (fw, fh)
        rx, ry = fw / size[0], fh / size[1]
        out_boxes, out_scores = [], []
        for i in keep:
            (cx, cy), (w, h), a = boxes[i]
            out_boxes.append(((cx * rx, cy * ry), (w * rx, h * ry), a))
            out_scores.append(scores[i])
        return out_boxes, np.asarray(out_scores, np.float32)


class TextDetectionModel_DB(Model):
    """cv2.dnn.TextDetectionModel_DB (model.cpp:1324): differentiable
    binarization postprocess — threshold, contours, score, unclip."""

    def __init__(self, model, config=None, device=None):
        super().__init__(model, config, device)
        self.binaryThreshold = 0.3
        self.polygonThreshold = 0.5
        self.unclipRatio = 2.0
        self.maxCandidates = 0

    def setBinaryThreshold(self, v):
        self.binaryThreshold = float(v)
        return self

    def setPolygonThreshold(self, v):
        self.polygonThreshold = float(v)
        return self

    def setUnclipRatio(self, v):
        self.unclipRatio = float(v)
        return self

    def setMaxCandidates(self, v):
        self.maxCandidates = int(v)
        return self

    def detect(self, frame):
        """Returns (list of 4-point polygons (np (4,2) f32),
        confidences)."""
        from ..ops.contours import findContours, minAreaRect, boxPoints
        from ..ops.drawing import fillPoly
        from .. import constants as Kc

        fh, fw = frame.shape[:2]
        outs = self.predict(frame)
        binary = _np(outs[0] if isinstance(outs, (list, tuple)) else outs)
        binary = binary.reshape(binary.shape[-2], binary.shape[-1])
        bitmap = (binary > self.binaryThreshold).astype(np.uint8) * 255
        sy = fh / binary.shape[0]
        sx = fw / binary.shape[1]
        cont, _ = findContours(bitmap, Kc.RETR_LIST,
                               Kc.CHAIN_APPROX_SIMPLE)
        ncand = len(cont) if self.maxCandidates <= 0 else \
            min(len(cont), self.maxCandidates)
        polys, confs = [], []
        for c in cont[:ncand]:
            pts = np.asarray(c).reshape(-1, 2)
            # contour score = mean of binary inside the contour mask
            x0, y0 = pts.min(axis=0)
            x1, y1 = pts.max(axis=0)
            mask = np.zeros((y1 - y0 + 1, x1 - x0 + 1), np.uint8)
            mask = fillPoly(mask, [pts - [x0, y0]], 1)
            roi = binary[y0:y1 + 1, x0:x1 + 1]
            score = float(roi[mask > 0].mean()) if (mask > 0).any() \
                else 0.0
            if score < self.polygonThreshold:
                continue
            scaled = (pts * [sx, sy]).astype(np.int64)
            rect = minAreaRect(scaled.astype(np.float32))
            (w, h) = rect[1]
            if min(h / sx, w / sy) < 3:
                continue
            (cx, cy), (w, h), ang = rect
            swap = w < h or abs(ang) >= 60
            if swap:
                w, h = h, w
                ang = ang + 90 if ang < 0 else ang - 90
            vert = np.asarray(boxPoints(((cx, cy), (w, h), ang)),
                              np.float64)
            poly = _db_unclip(vert, self.unclipRatio)
            if poly is None or len(poly) == 0:
                continue
            polys.append(np.asarray(poly, np.float32))
            confs.append(score)
        return polys, np.asarray(confs, np.float32)

    def detectTextRectangles(self, frame):
        from ..ops.contours import minAreaRect
        polys, confs = self.detect(frame)
        rects = []
        for p in polys:
            box = minAreaRect(np.asarray(p, np.float32))
            (cx, cy), (w, h), a = box
            if w < h or abs(a) >= 60:
                w, h = h, w
                a = a + 90 if a < 0 else a - 90
            rects.append(((cx, cy), (w, h), a))
        return rects, confs


def _db_unclip(poly, ratio):
    """Expand a polygon outward by area*ratio/perimeter (model.cpp:1500)."""
    from ..ops.contours import contourArea, arcLength
    area = abs(contourArea(np.asarray(poly, np.float32)))
    length = arcLength(np.asarray(poly, np.float32), True)
    if length == 0:
        return None
    distance = area * ratio / length
    n = len(poly)
    lines = []
    for i in range(n):
        p1 = poly[i]
        p2 = poly[(i - 1) % n]
        vec = p1 - p2
        nv = np.linalg.norm(vec)
        if nv == 0:
            continue
        d = distance / nv
        rot = np.array([vec[1] * d, -vec[0] * d])
        lines.append((p1 + rot, p2 + rot))
    out = []
    m = len(lines)
    for i in range(m):
        a, b = lines[i]
        c, d = lines[(i + 1) % m]
        v1 = b - a
        v2 = d - c
        den = np.linalg.norm(v1) * np.linalg.norm(v2)
        cosang = np.dot(v1, v2) / den if den else 1.0
        if abs(cosang) > 0.7:
            out.append(0.5 * (b + c))
        else:
            denom = (a[0] * (d[1] - c[1]) + b[0] * (c[1] - d[1])
                     + d[0] * (b[1] - a[1]) + c[0] * (a[1] - b[1]))
            num = (a[0] * (d[1] - c[1]) + c[0] * (a[1] - d[1])
                   + d[0] * (c[1] - a[1]))
            s = num / denom if denom else 0.5
            out.append(a + s * (b - a))
    return np.asarray(out)


TextDetectionModel = Model   # abstract base in the binding
