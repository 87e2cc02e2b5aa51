"""DNN-based trackers (video/src/tracking/tracker_{nano,dasiamrpn,
goturn,vit}.cpp), twin of ``opencv_tpu/video/dnn_trackers.py``.

Model-driven single-object trackers running their networks through the
port's ``dnn``: NanoTrack, DaSiamRPN, GOTURN and VitTrack.  Each tracker
takes ``device`` (``"cuda"`` unless asked) and reads its nets onto it; a
frame goes to that device once, and the context crops, the constant- or
edge-padded windows, the resizes, the blobs, the nets and the score maps
(softmax, penalties, Hanning windows, the argmax) stay there.  Only the
values at the best position (and GOTURN's four outputs) come back to the
host, in the dtypes the JAX package computes them in, and the host finishes
the box with the JAX package's arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as K
from .. import dnn
from ..core.arrays import as_tensor, to_device
from ..ops.misc import createHanningWindow
from ..ops.resize import resize

__all__ = [
    "TrackerNano", "TrackerNano_create",
    "TrackerDaSiamRPN", "TrackerDaSiamRPN_create",
    "TrackerGOTURN", "TrackerGOTURN_create",
    "TrackerVit", "TrackerVit_create",
]


def _frame(image, device):
    """A frame as an (H, W, C) tensor on `device`."""
    img = as_tensor(image).to(device)
    return img[..., None] if img.ndim == 2 else img


def _mean_chans(img):
    """The per-channel mean of an (H, W, C) integer frame, f64 on its device
    (an exact int64 sum divided once, as numpy's mean of u8 rounds)."""
    C = img.shape[-1]
    return img.reshape(-1, C).sum(0, dtype=torch.int64).to(torch.float64) / (img.numel() // C)


def _crop_pad(img, x0, y0, w, h, fill):
    """Crop [y0:y0+h, x0:x0+w] padding out-of-range pixels with `fill` (a
    per-channel value cast to the frame's dtype as numpy casts it, or a
    number): the avgChans constant-border crop both SiamRPN trackers use."""
    H, W, nc = img.shape
    fill = torch.as_tensor(fill, device=img.device).reshape(-1)[:nc].to(img.dtype)
    out = fill.reshape(1, 1, -1).expand(h, w, nc).clone()
    sx0 = max(0, x0)
    sy0 = max(0, y0)
    sx1 = min(W, x0 + w)
    sy1 = min(H, y0 + h)
    if sx1 > sx0 and sy1 > sy0:
        out[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] = img[sy0:sy1, sx0:sx1]
    return out


def _resize(img, w, h):
    out = resize(img, (w, h), interpolation=K.INTER_LINEAR)
    return out[..., None] if out.ndim == 2 else out


def _hann2d(sz, device):
    """cv::createHanningWindow (phasecorr.cpp:601 — note the final
    element-wise sqrt), f32 on `device`."""
    return to_device(createHanningWindow((sz, sz)), device)


def _size_cal(w, h):
    pad = (w + h) * 0.5
    return (w + pad) * (h + pad)


def _recip_max(a):
    return torch.maximum(a, 1.0 / a)


def _at(scores, *maps):
    """The flat index of the largest of `scores` (the first, as numpy's
    argmax) and the value of each map there, read back at once: (index,
    [each value as a numpy scalar of its map's dtype])."""
    best = scores.reshape(-1).argmax().reshape(1)
    vals = torch.cat([best.to(torch.float64)]
                     + [m.reshape(-1).index_select(0, best).to(torch.float64)
                        for m in maps]).cpu().numpy()
    return int(vals[0]), [np.float32(v) if m.dtype == torch.float32 else np.float64(v)
                          for v, m in zip(vals[1:], maps)]


def _softmax2(a, b):
    m = torch.maximum(a, b)
    e0 = torch.exp(a - m)
    e1 = torch.exp(b - m)
    return e1 / (e0 + e1)


# ------------------------------------------------------------------ Nano

class TrackerNano:
    """cv2.TrackerNano (tracker_nano.cpp:85)."""

    class Params:
        def __init__(self):
            self.backbone = "nanotrack_backbone_sim.onnx"
            self.neckhead = "nanotrack_head_sim.onnx"
            self.backend = 0
            self.target = 0

    def __init__(self, parameters=None, device=None):
        self.params = parameters or TrackerNano.Params()
        self.device = dnn.default_device(device)
        self.backbone = dnn.readNet(self.params.backbone, device=self.device)
        self.neckhead = dnn.readNet(self.params.neckhead, device=self.device)
        self.exemplarSize = 127
        self.instanceSize = 255
        self.totalStride = 16
        self.contextAmount = 0.5
        self.windowInfluence = 0.455
        self.lr = 0.37
        self.penaltyK = 0.055
        self.swapRB = True
        self.tracking_score = 0.0

    @staticmethod
    def create(parameters=None, device=None):
        return TrackerNano(parameters, device)

    def _get_subwindow(self, img, original_sz, resize_sz):
        avg = _mean_chans(img)
        c = (original_sz + 1) // 2
        x0 = int(self.targetPos[0]) - c
        y0 = int(self.targetPos[1]) - c
        crop = _crop_pad(img, x0, y0, original_sz, original_sz, avg)
        return _resize(crop, resize_sz, resize_sz)

    def _blob(self, crop):
        return dnn.blobFromImage(crop, 1.0, None, None, self.swapRB)

    def init(self, image, boundingBox):
        img = _frame(image, self.device)
        x, y, w, h = boundingBox
        self.scoreSize = (self.instanceSize - self.exemplarSize) // self.totalStride + 8
        self.targetPos = [x + w * 0.5, y + h * 0.5]
        self.targetSz = [float(w), float(h)]
        self.imgSize = (img.shape[1], img.shape[0])

        ssum = self.targetSz[0] + self.targetSz[1]
        wext = self.targetSz[0] + self.contextAmount * ssum
        hext = self.targetSz[1] + self.contextAmount * ssum
        sz = int(np.sqrt(wext * hext))
        crop = self._get_subwindow(img, sz, self.exemplarSize)
        self.backbone.setInput(self._blob(crop))
        feat = self.backbone.forward()
        self.neckhead.setInput(feat, "input1")

        self.hanning = _hann2d(self.scoreSize, self.device)
        s2 = self.scoreSize // 2
        g = (np.arange(self.scoreSize, dtype=np.float32) - s2) \
            * self.totalStride + self.instanceSize / 2
        self.gridX = to_device(np.tile(g, (self.scoreSize, 1)), self.device)
        self.gridY = self.gridX.T.contiguous()

    def update(self, image):
        img = _frame(image, self.device)
        ssum = self.targetSz[0] + self.targetSz[1]
        wc = self.targetSz[0] + self.contextAmount * int(ssum)
        hc = self.targetSz[1] + self.contextAmount * int(ssum)
        sz = np.sqrt(wc * hc)
        scale_z = self.exemplarSize / sz
        sx = sz * (self.instanceSize / self.exemplarSize)
        self.targetSz[0] *= scale_z
        self.targetSz[1] *= scale_z

        crop = self._get_subwindow(img, int(sx), self.instanceSize)
        self.backbone.setInput(self._blob(crop))
        xf = self.backbone.forward()
        self.neckhead.setInput(xf, "input2")
        cls, box = self.neckhead.forward(["output1", "output2"])
        S = self.scoreSize
        cls = cls.reshape(2, S, S)
        box = box.reshape(4, S, S)
        score = _softmax2(cls[0], cls[1])

        x1 = self.gridX - box[0]
        y1 = self.gridY - box[1]
        x2 = self.gridX + box[2]
        y2 = self.gridY + box[3]

        # scale/ratio penalties (tracker_nano.cpp:272-289; the scale
        # denominator uses targetPos — reproduced for parity), in f64 where
        # the JAX package's numpy promotes
        den = float(np.sqrt(_size_cal(self.targetPos[0], self.targetPos[1])))
        sc = _recip_max(torch.sqrt(_size_cal(x2 - x1, y2 - y1)).to(torch.float64) / den)
        ratio = self.targetSz[0] / self.targetSz[1]
        rc = _recip_max(float(ratio) / ((x2 - x1) / (y2 - y1)).to(torch.float64))
        penalty = torch.exp(-(rc * sc - 1) * self.penaltyK)
        pscore = penalty * score * (1 - self.windowInfluence) \
            + (self.hanning * self.windowInfluence).to(torch.float64)

        _, (ps, bx1, by1, bx2, by2, pen, sc_) = _at(pscore, pscore, x1, y1, x2, y2, penalty,
                                                    score)
        self.tracking_score = float(ps)
        px = (bx1 + bx2) / 2
        py = (by1 + by2) / 2
        pw = (bx2 - bx1) / scale_z
        ph = (by2 - by1) / scale_z
        dx = (px - self.instanceSize / 2) / scale_z
        dy = (py - self.instanceSize / 2) / scale_z
        self.targetSz[0] /= scale_z
        self.targetSz[1] /= scale_z
        lr = float(pen * sc_ * self.lr)

        rx = min(max(0.0, self.targetPos[0] + dx), self.imgSize[0])
        ry = min(max(0.0, self.targetPos[1] + dy), self.imgSize[1])
        rw = min(max(10.0, pw * lr + (1 - lr) * self.targetSz[0]), self.imgSize[0])
        rh = min(max(10.0, ph * lr + (1 - lr) * self.targetSz[1]), self.imgSize[1])
        self.targetPos = [rx, ry]
        self.targetSz = [rw, rh]
        return True, (int(rx - rw / 2), int(ry - rh / 2), int(rw), int(rh))

    def getTrackingScore(self):
        return self.tracking_score


def TrackerNano_create(parameters=None, device=None):
    return TrackerNano(parameters, device)


# -------------------------------------------------------------- DaSiamRPN

class TrackerDaSiamRPN:
    """cv2.TrackerDaSiamRPN (tracker_dasiamrpn.cpp:57)."""

    class Params:
        def __init__(self):
            self.model = "dasiamrpn_model.onnx"
            self.kernel_cls1 = "dasiamrpn_kernel_cls1.onnx"
            self.kernel_r1 = "dasiamrpn_kernel_r1.onnx"
            self.backend = 0
            self.target = 0

    def __init__(self, parameters=None, device=None):
        self.params = parameters or TrackerDaSiamRPN.Params()
        self.device = dnn.default_device(device)
        self.siamRPN = dnn.readNet(self.params.model, device=self.device)
        self.kernelCL1 = dnn.readNet(self.params.kernel_cls1, device=self.device)
        self.kernelR1 = dnn.readNet(self.params.kernel_r1, device=self.device)
        self.windowInfluence = 0.43
        self.lr = 0.4
        self.scale = 8
        self.swapRB = False
        self.totalStride = 8
        self.penaltyK = 0.055
        self.exemplarSize = 127
        self.instanceSize = 271
        self.contextAmount = 0.5
        self.ratios = [0.33, 0.5, 1.0, 2.0, 3.0]
        self.anchorNum = len(self.ratios)
        self.scoreSize = (self.instanceSize - self.exemplarSize) // self.totalStride + 1
        self.tracking_score = 0.0

    @staticmethod
    def create(parameters=None, device=None):
        return TrackerDaSiamRPN(parameters, device)

    def _gen_anchors(self):
        S = self.scoreSize
        A = self.anchorNum
        size = self.totalStride * self.totalStride
        ori = -(S // 2) * self.totalStride
        anchors = np.zeros((4, A, S, S), np.float32)
        for k, r in enumerate(self.ratios):
            ws = int(np.sqrt(size / r))
            hs = int(ws * r)
            anchors[2, k] = ws * self.scale
            anchors[3, k] = hs * self.scale
        grid = ori + self.totalStride * np.arange(S, dtype=np.float32)
        anchors[0] = grid.reshape(1, 1, S)       # x offsets by column
        anchors[1] = grid.reshape(1, S, 1)       # y offsets by row
        return to_device(anchors, self.device)

    def _get_subwindow(self, img, cx, cy, original_size):
        c = (original_size + 1) / 2
        x0 = int(round(cx - c))
        y0 = int(round(cy - c))
        return _crop_pad(img, x0, y0, int(original_size), int(original_size), self.avgChans)

    def _blob(self, crop, size):
        return dnn.blobFromImage(crop.to(torch.float32), 1.0, (size, size), None, self.swapRB)

    def init(self, image, boundingBox):
        img = _frame(image, self.device)
        x, y, w, h = boundingBox
        self.targetBox = [x + w * 0.5, y + h * 0.5, float(w), float(h)]
        self.anchors = self._gen_anchors()
        self.windows = _hann2d(self.scoreSize, self.device).expand(self.anchorNum, -1, -1)
        self.imgSize = (img.shape[1], img.shape[0])
        self.avgChans = _mean_chans(img)

        cx, cy, w, h = self.targetBox
        wc = w + self.contextAmount * (w + h)
        hc = h + self.contextAmount * (w + h)
        sz = float(round(np.sqrt(wc * hc)))
        zcrop = self._get_subwindow(img, cx, cy, sz)
        self.siamRPN.setInput(self._blob(zcrop, self.exemplarSize))
        out1 = self.siamRPN.forward("onnx_node_output_0!63")
        self.kernelCL1.setInput(out1)
        self.kernelR1.setInput(out1)
        cls1 = self.kernelCL1.forward()
        r1 = self.kernelR1.forward()
        self.siamRPN.setParam(self.siamRPN.getLayerId("onnx_node_output_0!65"), 0,
                              r1.reshape(20, 256, 4, 4))
        self.siamRPN.setParam(self.siamRPN.getLayerId("onnx_node_output_0!68"), 0,
                              cls1.reshape(10, 256, 4, 4))

    def update(self, image):
        img = _frame(image, self.device)
        cx, cy, w, h = self.targetBox
        # (width/height swap preserved from tracker_dasiamrpn.cpp:195-196)
        wc = h + self.contextAmount * (w + h)
        hc = w + self.contextAmount * (w + h)
        sz = np.sqrt(wc * hc)
        scale_z = self.exemplarSize / sz
        pad = (self.instanceSize - self.exemplarSize) / 2 / scale_z
        sx = round(sz + 2 * pad)

        xcrop = self._get_subwindow(img, cx, cy, sx)
        self.siamRPN.setInput(self._blob(xcrop, self.instanceSize))
        outs = self.siamRPN.forward(self.siamRPN.getUnconnectedOutLayersNames())
        delta, score = outs[0], outs[1]
        A = self.anchorNum
        S = self.scoreSize
        score = score.reshape(2, A, S, S)
        delta = delta.reshape(4, A, S, S)
        score = _softmax2(score[0], score[1])     # (A, S, S)

        tw = w * scale_z
        th = h * scale_z

        an = self.anchors
        d0 = delta[0] * an[2] + an[0]
        d1 = delta[1] * an[3] + an[1]
        d2 = torch.exp(delta[2]) * an[2]
        d3 = torch.exp(delta[3]) * an[3]

        sc = _recip_max(torch.sqrt(_size_cal(d2, d3)).to(torch.float64)
                        / float(np.sqrt(_size_cal(tw, th))))
        rc = _recip_max(float(tw / th) / (d2 / d3).to(torch.float64))
        penalty = torch.exp(-(rc * sc - 1.0) * self.penaltyK)
        pscore = penalty * score * (1 - self.windowInfluence) \
            + (self.windows * self.windowInfluence).to(torch.float64)

        _, (b0, b1, b2, b3, pf, sf) = _at(pscore, d0, d1, d2, d3, penalty, score)
        rx = b0 / scale_z + cx
        ry = b1 / scale_z + cy
        rw0 = b2 / scale_z
        rh0 = b3 / scale_z
        lr = pf * sf * self.lr
        rw = (w * (1 - lr) + rw0 * lr)
        rh = (h * (1 - lr) + rh0 * lr)
        rx = float(max(0.0, min(self.imgSize[0], rx)))
        ry = float(max(0.0, min(self.imgSize[1], ry)))
        rw = float(max(10.0, min(self.imgSize[0], rw)))
        rh = float(max(10.0, min(self.imgSize[1], rh)))
        self.targetBox = [rx, ry, rw, rh]
        self.tracking_score = float(sf)
        return True, (int(rx - int(rw / 2)), int(ry - int(rh / 2)), int(rw), int(rh))

    def getTrackingScore(self):
        return self.tracking_score


def TrackerDaSiamRPN_create(parameters=None, device=None):
    return TrackerDaSiamRPN(parameters, device)


# ---------------------------------------------------------------- GOTURN

class TrackerGOTURN:
    """cv2.TrackerGOTURN (tracker_goturn.cpp:30).  `net`, if given, is an
    already read GOTURN net to use instead of reading the params' files
    (trackers of several objects share one).  After an update, ``last``
    holds its search region (x, y, w, h), the two blobs on the net's device
    and the net's four outputs."""

    INPUT_SIZE = 227

    class Params:
        def __init__(self):
            self.modelTxt = "goturn.prototxt"
            self.modelBin = "goturn.caffemodel"

    def __init__(self, parameters=None, device=None, net=None):
        self.params = parameters or TrackerGOTURN.Params()
        if net is None:
            self.device = dnn.default_device(device)
            net = dnn.readNetFromCaffe(self.params.modelTxt, self.params.modelBin,
                                       device=self.device)
        else:
            self.device = net.device
        self.net = net
        self.last = None

    @staticmethod
    def create(parameters=None, device=None, net=None):
        return TrackerGOTURN(parameters, device, net)

    def init(self, image, boundingBox):
        self.image = _frame(image, self.device)
        self._set_bb(boundingBox)

    def _set_bb(self, bb):
        H, W = self.image.shape[:2]
        x, y, w, h = [int(v) for v in bb]
        x1 = max(0, x)
        y1 = max(0, y)
        x2 = min(W, x + w)
        y2 = min(H, y + h)
        self.bb = (x1, y1, max(0, x2 - x1), max(0, y2 - y1))

    def search_region(self):
        """The region around the box that both crops cover, (rx, ry, rw,
        rh) in the padded frame's coordinates (twice the box, clamped)."""
        H, W = self.image.shape[:2]
        px, py, pw, ph = self.bb
        cx = px + pw / 2.0
        cy = py + ph / 2.0
        pad = 2.0
        rw = pw * pad
        rh = ph * pad
        rx = cx - pw * pad / 2.0 + rw
        ry = cy - ph * pad / 2.0 + rh
        rw = min(rw, float(W))
        rh = min(rh, float(H))
        rx = max(-W * 0.5, min(rx, W * 1.5))
        ry = max(-H * 0.5, min(ry, H * 1.5))
        return rx, ry, rw, rh

    def blobs(self, cur, region):
        """The previous frame's and `cur`'s crops of `region`, edge-padded
        (numpy's pad by the crop's size, then its slice), resized to
        227×227 and made blobs with the mean 128: (target, search)."""
        rx, ry, rw, rh = region
        ix, iy, iw, ih = (int(round(rx)), int(round(ry)), int(round(rw)), int(round(rh)))
        H, W = cur.shape[:2]
        dev = cur.device
        # numpy's slice [iy:iy+ih] of the frame padded by ih (edge rows)
        rows = torch.as_tensor(range(H + 2 * ih)[iy:iy + ih], device=dev) - ih
        cols = torch.as_tensor(range(W + 2 * iw)[ix:ix + iw], device=dev) - iw
        rows, cols = rows.clamp_(0, H - 1), cols.clamp_(0, W - 1)
        out = []
        for img in (self.image, cur):
            crop = _resize(img.index_select(0, rows).index_select(1, cols),
                           self.INPUT_SIZE, self.INPUT_SIZE)
            out.append(dnn.blobFromImage(crop.to(torch.float32), 1.0, None, (128, 128, 128),
                                         False))
        return out

    def forward(self, target, search):
        """The net's ``scale`` output for the two blobs, read back as a
        numpy f32 (4,) array."""
        self.net.setInput(target, "data1")
        self.net.setInput(search, "data2")
        return self.net.forward("scale").reshape(-1).cpu().numpy()

    def box(self, res, region):
        """The new box from the net's output `res` over `region` (the JAX
        package's f32 arithmetic on `res`)."""
        rx, ry, rw, rh = region
        nx = int(round(rx + res[0] * rw / self.INPUT_SIZE - rw))
        ny = int(round(ry + res[1] * rh / self.INPUT_SIZE - rh))
        nw = int(round((res[2] - res[0]) * rw / self.INPUT_SIZE))
        nh = int(round((res[3] - res[1]) * rh / self.INPUT_SIZE))
        return nx, ny, nw, nh

    def update(self, image):
        cur = _frame(image, self.device)
        region = self.search_region()
        target, search = self.blobs(cur, region)
        res = self.forward(target, search)
        self.last = (region, target, search, res)
        self.image = cur
        self._set_bb(self.box(res, region))
        return True, self.bb


def TrackerGOTURN_create(parameters=None, device=None, net=None):
    return TrackerGOTURN(parameters, device, net)


# ------------------------------------------------------------------- ViT

def _hann1d_centered(n):
    i = np.arange(n, dtype=np.float32)
    return 0.5 * (1.0 - np.cos(2 * np.pi / (n + 1) * (i + 1)))


class TrackerVit:
    """cv2.TrackerVit (tracker_vit.cpp:42)."""

    class Params:
        def __init__(self):
            self.net = "vitTracker.onnx"
            self.backend = 0
            self.target = 0
            self.meanvalue = (0.485, 0.456, 0.406)
            self.stdvalue = (0.229, 0.224, 0.225)
            self.tracking_score_threshold = 0.20

    def __init__(self, parameters=None, device=None):
        self.params = parameters or TrackerVit.Params()
        self.device = dnn.default_device(device)
        self.net = dnn.readNet(self.params.net, device=self.device)
        mean = np.asarray(self.params.meanvalue, np.float32) * 255.0
        scale = 1.0 / (np.asarray(self.params.stdvalue, np.float32) * 255.0)
        self.i2bp = dnn.Image2BlobParams(scalefactor=scale, mean=mean)
        self.searchSize = 256
        self.templateSize = 128
        self.tracking_score = 0.0

    @staticmethod
    def create(parameters=None, device=None):
        return TrackerVit(parameters, device)

    def _crop(self, img, box, factor):
        x, y, w, h = box
        crop_sz = int(np.ceil(np.sqrt(w * h) * factor))
        # C-style trunc-toward-zero division (tracker_vit.cpp:crop_image)
        x1 = int(x + int((w - crop_sz) / 2))
        y1 = int(y + int((h - crop_sz) / 2))
        # reference pads when x2 >= W (the "+1" in crop_image's
        # x2_pad = max(x2 - W + 1, 0)) — zero-fill from that column on
        H, W = img.shape[:2]
        x2_pad = max(x1 + crop_sz - W + 1, 0)
        y2_pad = max(y1 + crop_sz - H + 1, 0)
        crop = _crop_pad(img, x1, y1, crop_sz, crop_sz, 0)
        if x2_pad and x2_pad <= crop_sz:
            crop[:, crop_sz - x2_pad:] = 0
        if y2_pad and y2_pad <= crop_sz:
            crop[crop_sz - y2_pad:, :] = 0
        return crop, crop_sz

    def _blob(self, crop, size):
        p = dnn.Image2BlobParams(scalefactor=self.i2bp.scalefactor,
                                 size=(size, size), mean=self.i2bp.mean)
        return dnn.blobFromImageWithParams(crop, p)

    def init(self, image, boundingBox):
        img = _frame(image, self.device)
        self.rect_last = [int(v) for v in boundingBox]
        crop, _ = self._crop(img, self.rect_last, 2)
        self.net.setInput(self._blob(crop, self.templateSize), "template")
        h = _hann1d_centered(16)
        self.hanning = to_device(np.outer(h, h).astype(np.float32), self.device)

    def update(self, image):
        img = _frame(image, self.device)
        crop, crop_sz = self._crop(img, self.rect_last, 4)
        self.net.setInput(self._blob(crop, self.searchSize), "search")
        conf, size_map, off_map = self.net.forward(["output1", "output2", "output3"])
        conf = conf.reshape(16, 16) * self.hanning
        size_map = size_map.reshape(2, 16, 16)
        off_map = off_map.reshape(2, 16, 16)
        best, (score, o0, o1, w, h) = _at(conf, conf, off_map[0], off_map[1], size_map[0],
                                          size_map[1])
        self.tracking_score = float(score)
        if self.tracking_score < self.params.tracking_score_threshold:
            return False, tuple(self.rect_last)
        my, mx = divmod(best, 16)
        cx = (mx + o0) / 16.0
        cy = (my + o1) / 16.0
        x0 = self.rect_last[0] + int((self.rect_last[2] - crop_sz) / 2)
        y0 = self.rect_last[1] + int((self.rect_last[3] - crop_sz) / 2)
        self.rect_last = [int(np.floor((cx - w / 2) * crop_sz + x0)),
                          int(np.floor((cy - h / 2) * crop_sz + y0)),
                          int(np.floor(w * crop_sz)),
                          int(np.floor(h * crop_sz))]
        return True, tuple(self.rect_last)

    def getTrackingScore(self):
        return self.tracking_score


def TrackerVit_create(parameters=None, device=None):
    return TrackerVit(parameters, device)
