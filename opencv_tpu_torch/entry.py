"""The flagship forward on the port — twin of ``__graft_entry__.py::entry``.

``forward`` is ``cvtColor(BGR2GRAY) → GaussianBlur((5,5), 0) → resize to
half size → warpAffine(getRotationMatrix2D(centre, 15°, 0.9))`` over a
batched NHWC u8 tensor; at the (8, 1080, 1920, 3) batch that is exactly
``entry()``'s chain (resize to 960×540, centre (480, 270)).
``forward_fused`` gives the same output through
``fusedPreprocessGrayBlurDown2`` → ``warpAffine``.

``forward_pyr_corner_edge`` is BASELINE config 3 (``bench.py``'s
``3_pyr_corner_edge_1080p``): pyrDown, cornerHarris on x/255, Sobel u8→16S
and Canny over an (N, 1080, 1920, 1) u8 batch; ``entry_pyr_corner_edge``
gives it ``bench.py``'s batch at ``BATCH_1080`` = 8.

``forward_match_morph`` is BASELINE config 4 (``4_match_morph_1080p``):
matchTemplate TM_CCOEFF_NORMED with a 32×32 u8 template, erode 3×3,
dilate 5×5 and erode 9×9 over the same (N, 1080, 1920, 1) u8 batch;
``entry_match_morph`` draws the batch and then the template from one
``default_rng(0)``, as ``bench.py`` does.

``forward_orb`` is BASELINE config 5 (``5_orb_1080p``): ORB with
nfeatures=500 over an (N, 1080, 1920) u8 batch, through
``ORB.detect_and_compute_batch`` (an INTER_LINEAR_EXACT pyramid of 8
levels, FAST, a sparse Harris rescore, the 7×7 σ 2 blur through
``sep_filter`` once per level, rotated BRIEF, and a host tail);
``entry_orb`` gives it ``bench.py``'s ``default_rng(0)`` batch.

``forward_resize_warp_4k`` is BASELINE config 2 (``2_resize_warp_4k``):
resize to half size with INTER_LINEAR (an exact 2× that reroutes to fast
AREA), INTER_AREA and INTER_CUBIC, warpAffine (15°, 0.9 about the centre)
and warpPerspective by ``bench.py``'s ``P``, both at the input's size, over
an (N, H, W, 3) u8 batch; at (4, 2160, 3840, 3) that is ``bench.py``'s
chain.  ``entry_resize_warp_4k`` gives it ``bench.py``'s batch at
``BATCH_4K`` = 4.

``forward_decode_color`` is the path from a decoded video frame to a binary
map and its integral image: NV12 as a hardware decoder hands it over (a Y
plane and an interleaved UV plane) → ``cvtColorTwoPlane`` to BGR →
cvtColor to HSV, Lab (u8) and YCrCb → ``fusedPreprocessGrayBlurDown2`` →
``threshold`` BINARY | OTSU → ``integral``.  ``entry_decode_color`` gives it
Y (8, 1080, 1920) and UV (8, 540, 960, 2) u8 drawn from one
``default_rng(0)`` in that order: the batch of 8 at 1080p of configs 3–5.

``forward_enhance`` is the contrast-enhancement and visualisation front
end: cvtColor to gray → medianBlur 5 → CLAHE (clip 2, 8×8 tiles) → an
unsharp mask (addWeighted of the image and its ``GaussianBlur((5, 5), 0)``,
1.5 and −0.5; the one ``sep_filter`` launch) → bilateralFilter(5, 50, 50)
→ a γ = 0.8 ``LUT`` → ``applyColorMap`` JET, with the per-image histogram
of the CLAHE output.  ``entry_enhance`` gives it ``make_batch()``'s
(8, 1080, 1920, 3) u8 batch, the flagship's.

``forward_motion`` stabilises a shaking or panning camera and finds what
moves in the frame, as surveillance, traffic and drone video run it: gray →
GaussianBlur 5×5 (the one ``sep_filter`` launch) → the phase correlation of
each frame against frame 0 under a Hanning window → warpAffine of each frame
by minus its shift (LINEAR, BORDER_REPLICATE) → a running background
(``accumulateWeighted``, α = 0.05, frame by frame) → absdiff against it,
threshold 25 and a 3×3 opening → connectedComponentsWithStats,
distanceTransform (L2, 3×3) and binary moments of every frame →
findContours (external, simple) of the last frame, with each contour's
area and bounding rect (:data:`MOTION_STAGES`).  ``entry_motion`` gives it
``make_motion_video()``'s (8, 1080, 1920, 3) u8 frames.

``forward_lines`` finds lane markings and round signs in road video and
burns them into the frames, as dashcam, ADAS and road-survey pipelines do:
gray → GaussianBlur 5×5 (``sep_filter`` k5) → Canny 50/150 → the Hough
accumulator of every frame and HoughLinesP → HoughCircles (HOUGH_GRADIENT)
of the blurred frames → fitLine (DIST_HUBER) of each half's segments →
the line segment detector on frame 0 → drawing the segments, lane fits,
circles, frame 0's LSD segments and a caption on a copy of the frames
(:data:`LINES_STAGES`).  ``entry_lines`` gives it ``make_road_video()``'s
(8, 1080, 1920, 3) u8 frames.

``forward_segment`` splits touching cells, coins or parts and cuts one
cluster out, as microscopy, inspection and counting pipelines do: the
colour correction of a calibrated camera (a ColorCorrectionModel fitted
once, on the host) → gray → GaussianBlur 5×5 (``sep_filter`` k5) → Otsu →
a 3×3 opening → the sure background (dilate) and foreground (the distance
transform above half its frame's largest) → the markers → the native
watershed of each frame in host threads → each cell's centroid and their
Delaunay triangles → frame 0's background flood, its pyrDown (``pyr_down``,
C = 3), pyrMeanShiftFiltering (10, 10, 1; ``pyr_down`` again) and grabCut
of its largest cluster → EMD between the frames' grey histograms of the
cells → the boundaries painted red (:data:`SEGMENT_STAGES`).
``entry_segment`` gives it ``make_cells_video()``'s (8, 1080, 1920, 3) u8
frames and the camera's fitted model.

``forward_register`` registers consecutive frames as cv::Stitcher does
before it stitches: gray → ``resize`` to the 0.6 Mpx registration size
(INTER_LINEAR_EXACT) → SIFT (its pyramids and extremum masks on the
device, one read-back, the host tails) → FlannBasedMatcher's kNN of each
frame in the next → the ratio test d0 < 0.7·d1
(:data:`REGISTER_STAGES`).  ``entry_register`` gives it
``make_pan_video()``'s (8, 1080, 1920, 3) u8 frames of a panning camera,
whose true frame-to-frame matrices ``register_truth_report`` checks the
matches against.

``forward_track`` tracks features between consecutive frames at half size,
as visual-odometry, SLAM and drone-mapping front ends do:
``fusedPreprocessGrayBlurDown2`` (the one ``gauss5_down2`` launch) → AKAZE,
BRISK and (on the first two frames) KAZE, their dense work on the device
and their sparse tails on the host → kNN of each frame in the next with the
ratio test d0 < 0.8·d1 (:data:`TRACK_STAGES`).  ``entry_track`` gives it
the registration path's pan video; ``track_truth_report`` checks each
detector's good pairs against the pan's truth.

``dryrun_multichip(n)`` is the twin of ``__graft_entry__.dryrun_multichip``
on ``torch.distributed``: n spawned ranks (gloo on the CPU, NCCL with n
CUDA devices) run the batch-DP step and the spatial filters of
``opencv_tpu_torch.parallel``; ``run_mesh_scenarios`` runs every mesh
function on a given mesh and gathers the outputs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import constants as K
from .core.arrays import to_device
from .features2d.orb import ORB_create
from .kernels import fused_gray_gauss5_down2
from .ops.canny import Canny
from .ops.color import cvtColor, cvtColorTwoPlane
from .ops.colormap import applyColorMap
from .ops.core_ops import LUT, absdiff, addWeighted, convertScaleAbs
from .ops.hist import createCLAHE, hist_per_image
from .ops.smooth import bilateralFilter, medianBlur
from .ops.corners import cornerHarris
from .ops.deriv import Sobel
from .ops.filter import GaussianBlur
from .ops.morph import dilate, erode, getStructuringElement, morphologyEx
from .ops.pyramids import pyrDown
from .ops.integral import integral
from .ops.resize import resize
from .ops.templmatch import matchTemplate
from .ops.thresh import threshold
from .ops.warp import getRotationMatrix2D, warpAffine, warpPerspective
from .ops.contours import boundingRect, contourArea, findContours
from .ops.misc import createHanningWindow, phase_correlate_batch
from .ops.shape import component_stats, components_batch, distanceTransform, moments_dict, \
    raw_moments
from .ops.transform import accumulateWeighted
from .ops.drawing import _Canvas, _circle, _line, _put_text
from .ops.hough import hough_circles_batch, hough_lines_batch, hough_lines_p_batch
from .ops.linefit import fitLine
from .ops.lsd import _segment_ends, createLineSegmentDetector
from .ops.ccm import COLORCHECKER_MACBETH, ColorCorrectionModel
from .ops.core_ops import subtract
from .ops.emd import EMD
from .ops.grabcut import GC_FGD, GC_INIT_WITH_RECT, GC_PR_FGD, grabCut
from .ops.hist import hist_fixed
from .ops.segmentation import (FLOODFILL_FIXED_RANGE, FLOODFILL_MASK_ONLY, floodFill,
                               pyrMeanShiftFiltering, watershed_frames)
from .ops.subdiv2d import Subdiv2D
from .features2d.akaze import AKAZE_create, image_levels, read_levels, to_float_image
from .features2d.brisk import BRISK_create
from .features2d.kaze import KAZE_create
from .features2d.matchers import BFMatcher, FlannBasedMatcher
from .features2d.sift import SIFT_create

__all__ = ["SHAPE", "SHAPE_CFG2", "SHAPE_CFG3", "SHAPE_CFG4", "SHAPE_CFG5", "SHAPE_NV12",
           "SHAPE_MOTION", "SHAPE_LINES", "SHAPE_SEGMENT", "PERSPECTIVE_CFG2",
           "DECODE_COLOR_OUTPUTS",
           "ENHANCE_STAGES", "ENHANCE_OUTPUTS", "GAMMA_LUT", "MOTION_STAGES", "MOTION_SUMS",
           "LINES_STAGES", "LINES_SUMS", "LINES_HOUGH", "LINES_CIRCLES", "SEGMENT_STAGES",
           "SEGMENT_SUMS", "entry",
           "entry_resize_warp_4k", "entry_pyr_corner_edge", "entry_match_morph", "entry_orb",
           "entry_decode_color", "entry_enhance", "entry_motion", "entry_lines", "entry_segment",
           "make_batch", "make_cells_video", "cells_patches", "fit_cells_model", "cutout_rect",
           "make_nv12", "make_motion_video", "make_road_video", "road_truth_misses",
           "segment_truth_report",
           "lane_ends", "caption", "preprocess", "preprocess_fused", "warp", "forward",
           "forward_fused", "forward_resize_warp_4k", "forward_pyr_corner_edge",
           "forward_match_morph", "forward_orb", "forward_decode_color", "forward_enhance",
           "forward_motion", "forward_lines", "forward_segment",
           "SHAPE_REGISTER", "REGISTER_STAGES", "REGISTER_RATIO", "register_size",
           "make_pan_video", "forward_register", "entry_register", "register_truth_report",
           "SHAPE_TRACK", "TRACK_STAGES", "TRACK_RATIO", "TRACK_TOL_PX", "TRACK_LSH",
           "TRACK_KAZE_FRAMES", "TRACK_DETECTORS", "track_state", "forward_track", "entry_track",
           "track_truth_report",
           "MESH_BORDERS", "MESH_TIMEOUT_S", "dryrun_multichip", "make_mesh_batch",
           "run_mesh_scenarios"]

SHAPE = (8, 1080, 1920, 3)
SHAPE_CFG2 = (4, 2160, 3840, 3)
# config 2's homography (bench.py:498-499)
PERSPECTIVE_CFG2 = np.array([[0.95, 0.05, 8.0], [-0.04, 1.02, 4.0], [1e-6, -2e-6, 1.0]],
                            np.float64)
SHAPE_CFG3 = (8, 1080, 1920, 1)
SHAPE_CFG4 = (8, 1080, 1920, 1)
TEMPLATE_CFG4 = (32, 32)
SHAPE_CFG5 = (8, 1080, 1920)
# the Y plane of the NV12 batch; its UV plane is (N, H/2, W/2, 2)
SHAPE_NV12 = (8, 1080, 1920)
# forward_decode_color's image outputs, in order
DECODE_COLOR_OUTPUTS = ("bgr", "hsv", "lab", "ycrcb", "small", "binary", "integral")
# forward_enhance's gamma table: 255 * (v / 255) ** 0.8, rounded, as a u8 LUT
GAMMA_LUT = np.rint(255.0 * (np.arange(256) / 255.0) ** 0.8).astype(np.uint8)


def make_batch(shape=SHAPE, seed: int = 0) -> np.ndarray:
    """The u8 batch of ``entry()``: numpy ``default_rng(seed)`` integers."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=shape, dtype=np.uint8)


def preprocess(imgs):
    """Gray → blur → half-size resize: (N,H,W,3) → (N,H/2,W/2,1)."""
    H, W = imgs.shape[1], imgs.shape[2]
    g = cvtColor(imgs, K.COLOR_BGR2GRAY)
    b = GaussianBlur(g, (5, 5), 0)
    return resize(b, (W // 2, H // 2))


def preprocess_fused(imgs):
    """The same as :func:`preprocess`, through the fused kernel."""
    return fused_gray_gauss5_down2(imgs, 0.0)[..., None]


def warp(r):
    """Rotate 15° and scale 0.9 about the centre, at the input's size."""
    h, w = r.shape[1], r.shape[2]
    M = getRotationMatrix2D((w / 2, h / 2), 15.0, 0.9)
    return warpAffine(r, M, (w, h))


def forward(imgs):
    return warp(preprocess(imgs))


def forward_fused(imgs):
    return warp(preprocess_fused(imgs))


def entry(device="cuda", shape=SHAPE):
    """``(forward, (imgs,))`` with the batch on `device`."""
    return forward, (torch.from_numpy(make_batch(shape)).to(device),)


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """An int64 sum as the int32 sum XLA computes: modulo 2^32, signed."""
    return ((v + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def forward_resize_warp_4k(x):
    """BASELINE config 2 over an (N, H, W, C) u8 batch (``bench.py:501-520``).

    Returns ``(linear, area, cubic, affine, perspective, totals)``: the three
    resizes to (W/2, H/2), the two warps at (W, H), and the three int32
    reductions ``bench.py`` takes (the three resizes together, then each
    warp), as an int32 tensor of 3."""
    H, W = x.shape[1], x.shape[2]
    half = (W // 2, H // 2)
    r1 = resize(x, half, interpolation=K.INTER_LINEAR)
    r2 = resize(x, half, interpolation=K.INTER_AREA)
    r3 = resize(x, half, interpolation=K.INTER_CUBIC)
    wa = warpAffine(x, getRotationMatrix2D((W / 2, H / 2), 15.0, 0.9), (W, H))
    wp = warpPerspective(x, PERSPECTIVE_CFG2, (W, H))
    totals = torch.stack([
        _wrap_int32(r1.sum(dtype=torch.int64) + r2.sum(dtype=torch.int64)
                    + r3.sum(dtype=torch.int64)),
        _wrap_int32(wa.sum(dtype=torch.int64)), _wrap_int32(wp.sum(dtype=torch.int64))])
    return r1, r2, r3, wa, wp, totals


def entry_resize_warp_4k(device="cuda", shape=SHAPE_CFG2):
    """``(forward_resize_warp_4k, (x,))`` with ``bench.py``'s config-2 batch
    (``default_rng(0)`` integers) on `device`."""
    return forward_resize_warp_4k, (torch.from_numpy(make_batch(shape)).to(device),)


def forward_pyr_corner_edge(x):
    """BASELINE config 3 over an (N, H, W, 1) u8 batch (``bench.py:447-454``).

    Returns ``(pyrDown, cornerHarris, Sobel, Canny, total)``: the four
    outputs and the int32 reduction ``bench.py`` takes of them."""
    p = pyrDown(x)
    h = cornerHarris(x.to(torch.float32) / 255.0, 2, 3, 0.04)
    sx = Sobel(x, K.CV_16S, 1, 0)
    c = Canny(x, 50, 150)
    total = _wrap_int32(p.sum(dtype=torch.int64) + h.sum().to(torch.int32).to(torch.int64)
                        + sx.sum(dtype=torch.int64) + c.sum(dtype=torch.int64))
    return p, h, sx, c, total


def entry_pyr_corner_edge(device="cuda", shape=SHAPE_CFG3):
    """``(forward_pyr_corner_edge, (x,))`` with ``bench.py``'s config-3 batch
    (``default_rng(0)`` integers) on `device`."""
    return forward_pyr_corner_edge, (torch.from_numpy(make_batch(shape)).to(device),)


def forward_match_morph(x, t):
    """BASELINE config 4 over an (N, H, W, 1) u8 batch and a u8 template
    (``bench.py:466-471``).

    Returns ``(m, e3, d5, e9, total)``: matchTemplate TM_CCOEFF_NORMED,
    erode 3×3, dilate 5×5, erode 9×9, and the float32 reduction ``bench.py``
    takes of them (the f32 sum of ``m`` plus each morph output's int32 sum,
    added in f32)."""
    m = matchTemplate(x, t, K.TM_CCOEFF_NORMED)
    e3 = erode(x, np.ones((3, 3), np.uint8))
    d5 = dilate(x, np.ones((5, 5), np.uint8))
    e9 = erode(x, np.ones((9, 9), np.uint8))
    total = m.sum()
    for v in (e3, d5, e9):
        total = total + _wrap_int32(v.sum(dtype=torch.int64)).to(torch.float32)
    return m, e3, d5, e9, total


def entry_match_morph(device="cuda", shape=SHAPE_CFG4):
    """``(forward_match_morph, (x, t))`` with ``bench.py``'s config-4 batch
    and then its 32×32 template, both from one ``default_rng(0)``, on
    `device`."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, size=shape, dtype=np.uint8)
    t = rng.integers(0, 256, size=TEMPLATE_CFG4, dtype=np.uint8)
    return forward_match_morph, (torch.from_numpy(x).to(device), torch.from_numpy(t).to(device))


def forward_orb(x, orb):
    """BASELINE config 5 over an (N, H, W) u8 batch (``bench.py:478-491``):
    ``orb.detect_and_compute_batch(x)``, a list of (keypoints, descriptors)
    per image."""
    return orb.detect_and_compute_batch(x)


def entry_orb(device="cuda", shape=SHAPE_CFG5):
    """``(forward_orb, (x, orb))`` with ``bench.py``'s config-5 batch
    (``default_rng(0)`` integers) on `device` and ``ORB_create(nfeatures=500)``."""
    return forward_orb, (torch.from_numpy(make_batch(shape)).to(device), ORB_create(nfeatures=500))


def forward_decode_color(y, uv):
    """From NV12 to a binary map and its integral image: Y (N, H, W) and
    UV (N, H/2, W/2, 2) u8.

    Returns ``(bgr, hsv, lab, ycrcb, small, binary, integral, otsu, sums)``:
    the decoded (N, H, W, 3) BGR frame, its HSV, Lab and YCrCb u8
    conversions, the (N, H/2, W/2, 1) gray + 5×5 Gaussian + 2× AREA map,
    its Otsu binary map (one threshold over the batch, as ``opencv_tpu``
    takes it), the binary map's (N, H/2+1, W/2+1, 1) int32 integral, the
    Otsu threshold (an f64 0-dim tensor) and the int64 sum of each of the
    seven outputs per image, an (N, 7) tensor."""
    bgr = cvtColorTwoPlane(y, uv, K.COLOR_YUV2BGR_NV12)
    hsv = cvtColor(bgr, K.COLOR_BGR2HSV)
    lab = cvtColor(bgr, K.COLOR_BGR2Lab)
    ycrcb = cvtColor(bgr, K.COLOR_BGR2YCrCb)
    small = fused_gray_gauss5_down2(bgr, 0.0)[..., None]
    otsu, binary = threshold(small, 0, 255, K.THRESH_BINARY | K.THRESH_OTSU)
    integ = integral(binary)
    outs = (bgr, hsv, lab, ycrcb, small, binary, integ)
    sums = torch.stack([o.reshape(o.shape[0], -1).sum(dim=1, dtype=torch.int64) for o in outs],
                       dim=1)
    return (*outs, otsu, sums)


def make_nv12(shape=SHAPE_NV12, seed: int = 0):
    """Y (N, H, W) and UV (N, H/2, W/2, 2) u8 from one ``default_rng(seed)``,
    in that order."""
    N, H, W = shape
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, size=(N, H, W), dtype=np.uint8)
    uv = rng.integers(0, 256, size=(N, H // 2, W // 2, 2), dtype=np.uint8)
    return y, uv


def entry_decode_color(device="cuda", shape=SHAPE_NV12):
    """``(forward_decode_color, (y, uv))`` with the NV12 batch of
    :func:`make_nv12` on `device`."""
    y, uv = make_nv12(shape)
    return forward_decode_color, (torch.from_numpy(y).to(device), torch.from_numpy(uv).to(device))


# forward_enhance's stages in order, (name, fn of the previous stage's output);
# the names are its image outputs
ENHANCE_STAGES = (
    ("gray", lambda a: cvtColor(a, K.COLOR_BGR2GRAY)),
    ("median", lambda a: medianBlur(a, 5)),
    ("clahe", lambda a: createCLAHE(2.0, (8, 8)).apply(a)),
    ("unsharp", lambda a: addWeighted(a, 1.5, GaussianBlur(a, (5, 5), 0), -0.5, 0)),
    ("bilateral", lambda a: bilateralFilter(a, 5, 50, 50)),
    ("gamma", lambda a: LUT(a, GAMMA_LUT)),
    ("colour", lambda a: applyColorMap(a, K.COLORMAP_JET)),
)
ENHANCE_OUTPUTS = tuple(name for name, _ in ENHANCE_STAGES)


def forward_enhance(x):
    """Contrast enhancement and false colour over an (N, H, W, 3) u8 BGR
    batch, the front end that inspection, thermal, medical and low-light
    video run before a display or a detector: gray, impulse noise removed
    (medianBlur 5), local contrast (CLAHE clip 2 on 8×8 tiles), sharpened
    (unsharp mask: 1.5 × image − 0.5 × its 5×5 Gaussian), edge-preserving
    smoothing (bilateralFilter d = 5, σ 50, 50), brightened (γ = 0.8 LUT)
    and mapped to JET (:data:`ENHANCE_STAGES`).

    Returns ``(gray, median, clahe, unsharp, bilateral, gamma, colour, hist,
    sums)``: the six (N, H, W, 1) u8 stages and the (N, H, W, 3) colour
    image, the CLAHE output's 256-bin f32 histogram per image (N, 256), and
    the int64 sum of each of the seven images and of the histogram per
    image, an (N, 8) tensor."""
    outs, cur = [], x
    for _, stage in ENHANCE_STAGES:
        cur = stage(cur)
        outs.append(cur)
    outs.append(hist_per_image(outs[2]))
    sums = torch.stack([o.reshape(o.shape[0], -1).sum(dim=1, dtype=torch.int64) for o in outs],
                       dim=1)
    return (*outs, sums)


def entry_enhance(device="cuda", shape=SHAPE):
    """``(forward_enhance, (x,))`` with ``make_batch()``'s batch on `device`."""
    return forward_enhance, (torch.from_numpy(make_batch(shape)).to(device),)


# ------------------------------------------------------------ motion path

SHAPE_MOTION = (8, 1080, 1920, 3)
MOTION_MAX_SHIFT = 16       # the camera's shake, px per axis against frame 0
MOTION_OBJECTS = 6
MOTION_ALPHA = 0.05         # accumulateWeighted's rate for the background
MOTION_THRESH = 25          # the absdiff threshold, grey levels


def _box_mean(a: np.ndarray, k: int) -> np.ndarray:
    """The k×k box mean of `a` over the windows that fit (valid mode)."""
    c = np.pad(a.cumsum(0).cumsum(1), ((1, 0), (1, 0)))
    return (c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]) / (k * k)


def make_motion_video(shape=SHAPE_MOTION, seed: int = 0):
    """A shaking camera over a textured scene with moving objects, all from
    one ``default_rng(seed)``: ``(frames, shifts, boxes)``.

    - the scene: uniform noise smoothed by a 9×9 box mean and stretched to
      0–255, on a canvas 2 × :data:`MOTION_MAX_SHIFT` × 2 px larger than a
      frame;
    - frame i is the crop of the canvas at an integer shift (dx_i, dy_i)
      drawn in [-16, 16] (frame 0 at (0, 0)), so that frame i is frame 0
      moved by (dx_i, dy_i): ``shifts`` is that (N, 2) int64 (x, y), what
      the phase correlation of frame i against frame 0 should find;
    - :data:`MOTION_OBJECTS` filled rectangles and discs, 40–160 px across
      at 1080p (scaled with the frame), 70–110 grey levels off the scene's
      median, each moving on its own at 30–60 px per frame (bouncing off
      the edges); ``boxes`` is their (N, 6, 4) int64 (x, y, w, h) in the
      scene's coordinates, which are frame 0's and the aligned frames';
    - sensor noise, uniform in ±2 per channel.

    Returns the (N, H, W, 3) u8 BGR frames."""
    N, H, W, C = shape
    rng = np.random.default_rng(seed)
    m = MOTION_MAX_SHIFT * 2
    scene = _box_mean(rng.random((H + 2 * m + 8, W + 2 * m + 8)), 9)
    scene = np.rint((scene - scene.min()) / (scene.max() - scene.min()) * 255.0)
    median = float(np.median(scene))
    shifts = rng.integers(-MOTION_MAX_SHIFT, MOTION_MAX_SHIFT + 1, (N, 2))
    shifts[0] = 0
    frames = np.empty((N, H, W), np.uint8)
    for i, (dx, dy) in enumerate(shifts):
        frames[i] = scene[m - dy:m - dy + H, m - dx:m - dx + W]
    scale = min(H / 1080, W / 1920)
    boxes = np.empty((N, MOTION_OBJECTS, 4), np.int64)
    ys, xs = np.mgrid[0:H, 0:W]
    for k in range(MOTION_OBJECTS):
        disc = k % 2 == 1
        w = h = max(6, int(rng.integers(40, 161) * scale))
        if not disc:
            h = max(6, int(rng.integers(40, 161) * scale))
        level = np.clip(median + rng.choice((-1, 1)) * rng.uniform(70, 110), 0, 255)
        lo = np.array([m, m])
        hi = np.array([W - m - w, H - m - h])
        p = lo + rng.random(2) * (hi - lo)
        ang = rng.uniform(0, 2 * np.pi)
        v = rng.uniform(30, 60) * scale * np.array([np.cos(ang), np.sin(ang)])
        for i in range(N):
            # the position bounces between lo and hi
            q = p + i * v - lo
            span = hi - lo
            q = np.abs((q + span) % (2 * span) - span) + lo
            x0, y0 = (int(t) for t in np.rint(q))
            boxes[i, k] = (x0, y0, w, h)
            fx, fy = x0 + shifts[i, 0], y0 + shifts[i, 1]
            if disc:
                r = w / 2.0
                inside = (xs - (fx + r - 0.5)) ** 2 + (ys - (fy + r - 0.5)) ** 2 <= r * r
                frames[i][inside] = level
            else:
                frames[i, fy:fy + h, fx:fx + w] = level
    noise = rng.integers(-2, 3, (N, H, W, C), dtype=np.int8)
    video = np.clip(frames[..., None].astype(np.int16) + noise, 0, 255).astype(np.uint8)
    return video, shifts, boxes


@functools.lru_cache(maxsize=4)
def _hanning(h: int, w: int, device) -> torch.Tensor:
    """createHanningWindow((w, h), CV_64F) on `device`, built once."""
    return to_device(createHanningWindow((w, h), K.CV_64F), device)


def _gray(st):
    st["gray"] = cvtColor(st["x"], K.COLOR_BGR2GRAY)


def _smooth(st):
    st["smooth"] = GaussianBlur(st["gray"], (5, 5), 0)


def _shifts(st):
    """The (N-1, 2) f64 shifts of frames 1.. against frame 0 and their
    responses, read back once."""
    s = st["smooth"][..., 0]
    shifts, resp = phase_correlate_batch(s[:1], s[1:], _hanning(s.shape[1], s.shape[2],
                                                                 s.device))
    host = torch.cat([shifts, resp[:, None]], dim=1).cpu().numpy()
    st["shifts"], st["responses"] = host[:, :2], host[:, 2]


def _align(st):
    s = st["smooth"]
    H, W = s.shape[1], s.shape[2]
    frames = [s[:1]]
    for i, (sx, sy) in enumerate(st["shifts"], 1):
        M = np.array([[1.0, 0.0, -sx], [0.0, 1.0, -sy]])
        frames.append(warpAffine(s[i:i + 1], M, (W, H), K.INTER_LINEAR, K.BORDER_REPLICATE))
    st["aligned"] = torch.cat(frames)


def _background(st):
    a = st["aligned"]
    bg = a[:1].to(torch.float32)
    for i in range(1, len(a)):
        bg = accumulateWeighted(a[i:i + 1], bg, MOTION_ALPHA)
    st["background"] = bg


def _mask(st):
    d = absdiff(st["aligned"], convertScaleAbs(st["background"]))
    _, m = threshold(d, MOTION_THRESH, 255, K.THRESH_BINARY)
    st["mask"] = morphologyEx(m, K.MORPH_OPEN, getStructuringElement(K.MORPH_RECT, (3, 3)))


def _components(st):
    """Labels, stats and centroids of every frame; the per-frame label
    counts are the one read."""
    steps = {}
    labels, counts = components_batch(st["mask"][..., 0], 8, steps)
    n = counts.cpu().numpy() + 1
    stats, cent = component_stats(labels, int(n.max()))
    st.update(labels=labels, n_labels=n, stats=stats, centroids=cent, cc_steps=steps)


def _distance(st):
    steps = {}
    st["distance"] = distanceTransform(st["mask"], K.DIST_L2, 3, stats=steps)
    st["dt_steps"] = steps


def _moments(st):
    raw = raw_moments(st["mask"][..., 0], binaryImage=True).cpu().numpy()
    st["moments"] = [moments_dict(r) for r in raw]


def _contours(st):
    cs, _ = findContours(st["mask"][-1, ..., 0], K.RETR_EXTERNAL, K.CHAIN_APPROX_SIMPLE)
    st.update(contours=cs, areas=[contourArea(c) for c in cs],
              rects=[boundingRect(c) for c in cs])


# the per-frame sums of forward_motion's "sums" table, in its column order
MOTION_SUMS = ("smooth", "aligned", "mask", "labels", "distance", "stats")


def _sums(st):
    cols = []
    for name in MOTION_SUMS:
        v = st[name]
        if name == "distance":
            v = torch.round(v)
        cols.append(v.reshape(v.shape[0], -1).sum(dim=1, dtype=torch.int64))
    st["sums"] = torch.stack(cols, dim=1)


# forward_motion's stages in order: (name, fn of the state dict, the keys it
# writes); each reads only keys written before it
MOTION_STAGES = (
    ("gray", _gray, ("gray",)),
    ("smooth", _smooth, ("smooth",)),
    ("shifts", _shifts, ("shifts", "responses")),
    ("aligned", _align, ("aligned",)),
    ("background", _background, ("background",)),
    ("mask", _mask, ("mask",)),
    ("components", _components, ("labels", "n_labels", "stats", "centroids", "cc_steps")),
    ("distance", _distance, ("distance", "dt_steps")),
    ("moments", _moments, ("moments",)),
    ("contours", _contours, ("contours", "areas", "rects")),
    ("sums", _sums, ("sums",)),
)


def forward_motion(x):
    """Stabilisation and motion detection over an (N, H, W, 3) u8 BGR video
    (:data:`MOTION_STAGES`), frame 0 the reference.

    Returns a dict: ``gray`` and ``smooth`` (N, H, W, 1) u8; ``shifts``
    ((N-1, 2) f64 numpy, cv2's (x, y) shift of frames 1.. against frame 0)
    and their ``responses``; ``aligned`` (N, H, W, 1) u8; ``background``
    (1, H, W, 1) f32; ``mask`` (N, H, W, 1) u8 (0 or 255); ``labels`` (N, H,
    W) int32, ``n_labels`` (N,) numpy (cv2's n, background included),
    ``stats`` (N, L, 5) int32 and ``centroids`` (N, L, 2) f64 with L the
    largest n (rows past a frame's n are 0); ``distance`` (N, H, W, 1) f32;
    ``moments``, one cv2 moments dict per frame; ``contours``, ``areas`` and
    ``rects`` of the last frame; ``sums``, the (N, 6) int64 per-frame sums
    of :data:`MOTION_SUMS` (the distances rounded); and ``cc_steps`` /
    ``dt_steps``, the propagation steps and fixpoint checks of the
    components and the distance transform."""
    st = {"x": x}
    for _, stage, _ in MOTION_STAGES:
        stage(st)
    del st["x"]
    return st


def entry_motion(device="cuda", shape=SHAPE_MOTION):
    """``(forward_motion, (x,))`` with :func:`make_motion_video`'s frames on
    `device`."""
    video, _, _ = make_motion_video(shape)
    return forward_motion, (torch.from_numpy(video).to(device),)


# ------------------------------------------------------------- lines path

SHAPE_LINES = (8, 1080, 1920, 3)
# HoughLinesP's and HoughCircles' parameters on the path
LINES_HOUGH = dict(rho=1, theta=np.pi / 180, threshold=120, minLineLength=80, maxLineGap=10)
LINES_CIRCLES = dict(dp=1, minDist=100, param1=100, param2=40, minRadius=20, maxRadius=90)
ROAD_MAX_SHIFT = 6          # the camera's shake, px per axis against frame 0
# the colours the path draws with (BGR)
SEGMENT_BGR, LANE_BGR, CIRCLE_BGR, LSD_BGR, TEXT_BGR = ((0, 0, 255), (0, 255, 0), (255, 0, 0),
                                                        (0, 255, 255), (255, 255, 255))


def make_road_video(shape=SHAPE_LINES, seed: int = 0):
    """Road video from one ``default_rng(seed)``: ``(frames, truth)``.

    - the road: uniform noise smoothed by a 31×31 box mean, stretched to
      70–110 grey, on a canvas 2 × :data:`ROAD_MAX_SHIFT` px larger than a
      frame;
    - 4 lane markings, 12–20 px wide at 1080p (scaled with the frame, at
      least 3 px), bright white or yellow, converging to a vanishing point
      on the horizon (35% of the height, its x within 5% of the centre) at
      48–56° and 14–22° either side of the vertical (a whole degree ±0.15°)
      and ending 12% of the height below it; one of them is dashed (dashes
      of max(96, H/7) rows, gaps of max(16, H/12));
    - 3–5 bright rings (3–4 px thick) and discs (radius 40 and up) above
      the horizon, one per column of the frame (as many columns of 105 px
      as fit, at most the 3–5 drawn), of radius 25 to min(80, (horizon −
      8) / 2) px, their centres ≥ 100 px apart (HoughCircles' minDist);
    - the markings and circles are drawn with their pixels' coverage
      (anti-aliased), as a camera sees them;
    - frame i is the canvas moved by an integer (dx, dy) in [-6, 6] (frame
      0 by (0, 0)), plus sensor noise uniform in ±2 per channel.

    ``truth`` is a dict of, per frame, ``"edges"``: (N, 4, 2, 2, 2) f64, the
    two edges of each marking as (x, y) end points (the far end first), and
    ``"circles"``: (N, k, 3) f64 (x, y, radius: a disc's, or the middle of a
    ring); and ``"dashed"``, the dashed marking's index."""
    N, H, W, C = shape
    rng = np.random.default_rng(seed)
    m = ROAD_MAX_SHIFT
    scale = min(H / 1080, W / 1920)
    road = _box_mean(rng.random((H + 2 * m + 30, W + 2 * m + 30)), 31)
    road = 70.0 + 40.0 * (road - road.min()) / (road.max() - road.min())
    canvas = np.repeat(road[..., None], 3, axis=2)

    def paint(cover, colour):
        cover = cover[..., None]
        canvas[:] = canvas * (1 - cover) + np.asarray(colour, np.float64) * cover

    horizon = int(0.35 * H)
    far = horizon + int(0.12 * H)
    vx = W / 2 + rng.uniform(-0.05, 0.05) * W
    # each marking's angle from the vertical: a whole degree in its range,
    # within 0.15 of it, so that each edge's votes gather in one or two
    # (theta, rho) bins
    lo = np.array([-56, -22, 14, 48])
    phi = lo + rng.integers(0, 9, 4) + rng.uniform(-0.15, 0.15, 4)
    bottoms = vx + np.tan(np.radians(phi)) * (H - 1 - horizon)
    widths = np.maximum(3, np.rint(rng.integers(12, 21, 4) * scale))
    dashed = int(rng.integers(0, 4))
    on, off = max(96, H // 7), max(16, H // 12)
    ys, xs = np.mgrid[0:H + 2 * m, 0:W + 2 * m] - m     # frame 0's coordinates
    edges = np.empty((4, 2, 2, 2))
    for k, (xb, w) in enumerate(zip(bottoms, widths)):
        c = vx + (xb - vx) * (ys - horizon) / (H - 1 - horizon)
        cover = np.clip(w / 2 + 0.5 - np.abs(xs - c), 0, 1) * (ys >= far)
        if k == dashed:
            cover *= (ys - far) % (on + off) < on
        paint(cover, (240, 240, 240) if rng.random() < 0.5 else (60, 220, 240))
        for e, sgn in enumerate((-1, 1)):
            for j, y in enumerate((far, H - 1)):
                edges[k, e, j] = (vx + (xb - vx) * (y - horizon) / (H - 1 - horizon)
                                  + sgn * w / 2, y)
    # one circle per column of the frame, 3-5 columns as the width allows
    r_hi = min(80, (horizon - 8) // 2)
    k = min(int(rng.integers(3, 6)), W // 105)
    if k < 3 or r_hi < 25:
        raise ValueError(f"a {H}x{W} frame has no room for 3 circles")
    cw = W / k
    circles = []
    for j in range(k):
        r = int(rng.integers(25, r_hi + 1))
        jit = max(0.0, (cw - max(100, 2 * r_hi + 20)) / 2)
        cx = int(round((j + 0.5) * cw + rng.uniform(-jit, jit)))
        cy = int(rng.integers(r + 4, horizon - r - 3))
        d = np.hypot(xs - cx, ys - cy)
        cover = np.clip(r + 0.5 - d, 0, 1)
        t = 0 if r >= 40 and rng.random() < 0.5 else int(rng.integers(3, 5))
        if t:
            cover *= np.clip(d - (r - t) + 0.5, 0, 1)
        paint(cover, ((240, 240, 240), (60, 220, 240), (250, 200, 150))[rng.integers(0, 3)])
        circles.append((cx, cy, r - t / 2))
    canvas = np.rint(canvas)
    shifts = rng.integers(-m, m + 1, (N, 2))
    shifts[0] = 0
    frames = np.empty((N, H, W, C), np.uint8)
    for i, (dx, dy) in enumerate(shifts):
        frames[i] = canvas[m - dy:m - dy + H, m - dx:m - dx + W]
    noise = rng.integers(-2, 3, (N, H, W, C), dtype=np.int8)
    frames = np.clip(frames.astype(np.int16) + noise, 0, 255).astype(np.uint8)
    sh = shifts[:, None, None, None, :].astype(np.float64)
    cs = np.asarray(circles, np.float64)
    truth = {"edges": edges[None] + sh,
             "circles": np.stack([cs + [dx, dy, 0] for dx, dy in shifts]),
             "dashed": dashed}
    return frames, truth


def road_truth_misses(segments, circles, truth, pos_tol: float = 3.0, ang_tol: float = 2.0,
                      centre_tol: float = 2.0, radius_tol: float = 3.0) -> list:
    """What of the road video's truth the path did not find, per frame: a
    marking edge with no segment within `ang_tol` degrees of it whose two
    ends lie within `pos_tol` px of its line, or a circle with no detection
    whose centre lies within `centre_tol` px on each axis and radius within
    `radius_tol` px.  An edge shorter than 1.25 times the Hough threshold
    is left out: it cannot gather the threshold's votes (one per pixel of
    its length), which happens in frames of a few hundred rows, never at
    1080p (a marking spans 53% of the height).  An empty list when all were
    found."""
    misses = []
    min_len = 1.25 * LINES_HOUGH["threshold"]
    for i, segs in enumerate(segments):
        s = np.zeros((0, 4)) if segs is None else segs.reshape(-1, 4).astype(np.float64)
        for k, marking in enumerate(truth["edges"][i]):
            for e, ((x0, y0), (x1, y1)) in enumerate(marking):
                if np.hypot(x1 - x0, y1 - y0) < min_len:
                    continue
                d = np.array([x1 - x0, y1 - y0]) / np.hypot(x1 - x0, y1 - y0)
                dist = [np.abs((s[:, 2 * j] - x0) * d[1] - (s[:, 2 * j + 1] - y0) * d[0])
                        for j in (0, 1)]
                ang = np.degrees(np.arctan2(s[:, 3] - s[:, 1], s[:, 2] - s[:, 0]))
                da = np.abs((ang - np.degrees(np.arctan2(d[1], d[0])) + 90) % 180 - 90)
                if not ((dist[0] <= pos_tol) & (dist[1] <= pos_tol) & (da <= ang_tol)).any():
                    misses.append(("edge", i, k, e))
        c = np.zeros((0, 3)) if circles[i] is None else circles[i].reshape(-1, 3)
        for x, y, r in truth["circles"][i]:
            if not ((np.abs(c[:, 0] - x) <= centre_tol) & (np.abs(c[:, 1] - y) <= centre_tol)
                    & (np.abs(c[:, 2] - r) <= radius_tol)).any():
                misses.append(("circle", i, x, y, r))
    return misses


def _l_gray(st):
    st["gray"] = cvtColor(st["x"], K.COLOR_BGR2GRAY)


def _l_blur(st):
    st["blur"] = GaussianBlur(st["gray"], (5, 5), 0)


def _l_edges(st):
    st["edges"] = Canny(st["blur"], 50, 150)


def _l_segments(st):
    """The Hough lines of every frame's edges from one accumulator, then
    HoughLinesP's segments from them."""
    hp = LINES_HOUGH
    e = st["edges"][..., 0] != 0
    stats = {}
    lines = hough_lines_batch(e, hp["rho"], hp["theta"], hp["threshold"], stats=stats)
    st.update(lines=lines, hough_stats=stats, segments=hough_lines_p_batch(
        e, lines, hp["minLineLength"], hp["maxLineGap"]))


def _l_circles(st):
    stats = {}
    st["circles"] = hough_circles_batch(st["blur"], stats=stats, **LINES_CIRCLES)
    st["circle_stats"] = stats


def _l_lanes(st):
    """fitLine (DIST_HUBER) of the end points of each half's segments, left
    then right, per frame (None where a half has none)."""
    W = st["x"].shape[2]
    lanes = []
    for segs in st["segments"]:
        s = np.zeros((0, 4), np.int32) if segs is None else segs.reshape(-1, 4)
        mid = (s[:, 0] + s[:, 2]) / 2
        lanes.append([fitLine(half.reshape(-1, 2).astype(np.float32), K.DIST_HUBER, 0, 0.01,
                              0.01) if len(half) else None
                      for half in (s[mid < W / 2], s[mid >= W / 2])])
    st["lanes"] = lanes


def _l_lsd(st):
    st["lsd"] = createLineSegmentDetector().detect(st["gray"][0, ..., 0])


def lane_ends(fit, H: int):
    """The end points of a lane fit's line at the frame's bottom row and at
    45% of its height, or None for a line within 1e-3 of level."""
    vx, vy, x0, y0 = (float(v) for v in fit.reshape(-1))
    if abs(vy) < 1e-3:
        return None
    return [(x0 + (y - y0) * vx / vy, float(y)) for y in (H - 1, int(0.45 * H))]


def caption(n_segments: int, n_circles: int, H: int):
    """putText's text, origin and scale for one frame's counts."""
    s = max(0.4, 1.2 * H / 1080)
    return f"lines {n_segments} circles {n_circles}", (10, int(40 * s)), s


def _l_draw(st):
    """Everything found, burnt into a copy of the frames on their device:
    each segment red (3 px), each lane fit green (2 px, LINE_AA), each circle
    blue (2 px), frame 0's LSD segments yellow (1 px) and a caption."""
    x = st["x"]
    H = x.shape[1]
    cv = _Canvas(x.clone(), batch=True)
    for i in range(x.shape[0]):
        cv.frame = i
        segs = st["segments"][i]
        segs = np.zeros((0, 4), np.int32) if segs is None else segs.reshape(-1, 4)
        for x1, y1, x2, y2 in segs:
            _line(cv, (x1, y1), (x2, y2), SEGMENT_BGR, 3)
        for fit in st["lanes"][i]:
            ends = None if fit is None else lane_ends(fit, H)
            if ends is not None:
                _line(cv, *ends, LANE_BGR, 2, K.LINE_AA)
        circ = st["circles"][i]
        circ = np.zeros((0, 3)) if circ is None else circ.reshape(-1, 3)
        for cx, cy, r in circ:
            _circle(cv, (int(cx), int(cy)), int(round(float(r))), CIRCLE_BGR, 2)
        if i == 0:
            for ends in _segment_ends(st["lsd"][0]):
                _line(cv, *ends, LSD_BGR, 1)
        text, org, s = caption(len(segs), len(circ), H)
        _put_text(cv, text, org, K.FONT_HERSHEY_SIMPLEX, s, TEXT_BGR, 2)
    st["drawn"] = cv.done()
    st["draw_writes"] = cv.writes


# the per-frame sums of forward_lines' "sums" table, in its column order
LINES_SUMS = ("gray", "blur", "edges", "drawn")


def _l_sums(st):
    st["sums"] = torch.stack([st[k].reshape(st[k].shape[0], -1).sum(dim=1, dtype=torch.int64)
                              for k in LINES_SUMS], dim=1)


# forward_lines' stages in order: (name, fn of the state dict, the keys it
# writes); each reads only keys written before it
LINES_STAGES = (
    ("gray", _l_gray, ("gray",)),
    ("blur", _l_blur, ("blur",)),
    ("edges", _l_edges, ("edges",)),
    ("segments", _l_segments, ("lines", "hough_stats", "segments")),
    ("circles", _l_circles, ("circles", "circle_stats")),
    ("lanes", _l_lanes, ("lanes",)),
    ("lsd", _l_lsd, ("lsd",)),
    ("draw", _l_draw, ("drawn", "draw_writes")),
    ("sums", _l_sums, ("sums",)),
)


def forward_lines(x):
    """Lanes and round signs in an (N, H, W, 3) u8 BGR road video
    (:data:`LINES_STAGES`).

    Returns a dict: ``gray`` and ``blur`` (N, H, W, 1) u8; ``edges`` (N, H,
    W, 1) u8 (0 or 255); per frame, ``lines`` (HoughLines' (k, 1, 2) f32
    or None), ``segments`` (HoughLinesP's (k, 1, 4) int32 or None),
    ``circles`` (HoughCircles' (1, k, 3) f32 or None) and ``lanes`` (the
    left and the right half's fitLine (4, 1) f32, or None); ``lsd``, the
    line segment detector's (lines, widths, precs, nfa) of frame 0;
    ``drawn``, the (N, H, W, 3) u8 frames with all of it drawn in;
    ``draw_writes``, the device writes the drawing made; ``sums``, the
    (N, 4) int64 per-frame sums of :data:`LINES_SUMS`; and ``hough_stats`` /
    ``circle_stats``, the edge pixels and vote chunks of the two
    accumulators."""
    st = {"x": x}
    for _, stage, _ in LINES_STAGES:
        stage(st)
    del st["x"]
    return st


def entry_lines(device="cuda", shape=SHAPE_LINES):
    """``(forward_lines, (x,))`` with :func:`make_road_video`'s frames on
    `device`."""
    video, _ = make_road_video(shape)
    return forward_lines, (torch.from_numpy(video).to(device),)


# ----------------------------------------------------- cell-segmentation path

SHAPE_SEGMENT = (8, 1080, 1920, 3)
SEGMENT_DRIFT = 3.0         # the slide's drift, px per frame per axis at most
# the camera's colour cast: linear RGB is mixed by the inverse of CELLS_CAST
# (row vectors) and encoded with CELLS_GAMMA, so the colour correction model
# fitted on the ColorChecker's patches finds CELLS_CAST
CELLS_CAST = np.array([[0.9, 0.1, 0.0], [0.05, 0.85, 0.05], [0.0, 0.1, 0.95]])
CELLS_GAMMA = 2.2
# floodFill of frame 0's background and grabCut's rect padding, px
SEGMENT_FLOOD_DIFF = 20
SEGMENT_RECT_PAD = 10
SEGMENT_HIST_BINS = 16
# the boundaries' colour in the painted frames (BGR)
BOUNDARY_BGR = (0, 0, 255)


def _cast(rgb: np.ndarray) -> np.ndarray:
    """The camera's view, in [0, 1], of true RGB values in [0, 1]."""
    lin = np.clip(rgb, 0, 1) ** CELLS_GAMMA
    return np.clip(lin @ np.linalg.inv(CELLS_CAST), 0, 1) ** (1 / CELLS_GAMMA)


def cells_patches() -> np.ndarray:
    """The camera's view of the 24 ColorChecker patches (the model's
    reference), (24, 1, 3) f64 RGB in [0, 1]: what a user measures once on
    a chart to calibrate the camera."""
    from .ops.ccm import _MACBETH_LAB, _lab_d50_to_linear_rgb
    ref = np.clip(_lab_d50_to_linear_rgb(_MACBETH_LAB), 0, 1) ** (1 / CELLS_GAMMA)
    return _cast(ref).reshape(-1, 1, 3)


def _place_cells(rng, H: int, W: int, margin: float, scale: float):
    """Discs of radius 35–55 px at 1080p (scaled), most in touching clusters
    of 2–3: ``(centres (K, 2) f64, radii (K,) f64, cluster (K,) int64)``.  A
    touching pair meets on a chord of half-length h of 20–32% of the smaller
    radius, so each centre lies outside the other disc and the distance
    transform keeps one peak per disc (the neck's distance, at most h, stays
    below half the largest radius); clusters keep a gap apart."""
    target = int(rng.integers(40, 61))
    gap = max(3.0, 12.0 * scale)
    cs, rs, cl = [], [], []

    def free(c, r, partner=None):
        for j, (cj, rj) in enumerate(zip(cs, rs)):
            if j != partner and np.hypot(*(c - cj)) < r + rj + gap:
                return False
        lo = margin + r
        return lo <= c[0] <= W - lo and lo <= c[1] <= H - lo

    cluster = 0
    for _ in range(20000):
        if len(cs) >= target:
            break
        size = int(rng.choice((1, 2, 3), p=(0.2, 0.45, 0.35)))
        r = rng.uniform(35, 55) * scale
        c = rng.uniform((0, 0), (W, H))
        if not free(c, r):
            continue
        members = [len(cs)]
        cs.append(c)
        rs.append(r)
        cl.append(cluster)
        for _ in range(size - 1):
            for _ in range(50):
                k = members[int(rng.integers(len(members)))]
                r2 = rng.uniform(35, 55) * scale
                h = rng.uniform(0.20, 0.32) * min(rs[k], r2)
                d = np.sqrt(rs[k] ** 2 - h * h) + np.sqrt(r2 ** 2 - h * h)
                ang = rng.uniform(0, 2 * np.pi)
                c2 = cs[k] + d * np.array([np.cos(ang), np.sin(ang)])
                if free(c2, r2, partner=k):
                    members.append(len(cs))
                    cs.append(c2)
                    rs.append(r2)
                    cl.append(cluster)
                    break
        cluster += 1
    return np.array(cs), np.array(rs), np.array(cl, np.int64)


def make_cells_video(shape=SHAPE_SEGMENT, seed: int = 0):
    """A drifting microscope slide of touching cells through a colour-cast
    camera, from one ``default_rng(seed)``: ``(frames, truth)``.

    - the background: uniform noise smoothed by a 31×31 box mean, 30–50
      grey, on a canvas larger than a frame by the drift;
    - 40–60 bright, lightly textured discs ("cells") of radius 35–55 px at
      1080p (scaled with the frame; :func:`_place_cells`), most touching in
      clusters of 2–3, each disc's centre outside every other disc, drawn
      with their pixels' coverage;
    - frame i is the canvas moved by i times a drift of at most
      :data:`SEGMENT_DRIFT` px per axis, rounded;
    - the camera's colour cast (:data:`CELLS_CAST`, :data:`CELLS_GAMMA`) on
      the whole scene, then sensor noise uniform in ±2 per channel.

    ``truth`` is a dict of ``"centres"`` (N, K, 2) f64 (x, y) per frame,
    ``"radii"`` (K,), ``"cluster"`` (K,) (the cluster of each disc) and
    ``"patches"``, :func:`cells_patches`."""
    N, H, W, C = shape
    rng = np.random.default_rng(seed)
    scale = min(H / 1080, W / 1920)
    v = rng.uniform(-SEGMENT_DRIFT, SEGMENT_DRIFT, 2)
    shifts = np.rint(np.arange(N)[:, None] * v).astype(np.int64)
    m = int(np.abs(shifts).max()) + 1
    bg = _box_mean(rng.random((H + 2 * m + 30, W + 2 * m + 30)), 31)
    bg = 30.0 + 20.0 * (bg - bg.min()) / (bg.max() - bg.min())
    canvas = np.repeat(bg[..., None], 3, axis=2)
    centres, radii, cluster = _place_cells(rng, H, W, m + max(6.0, 12.0 * scale), scale)
    texture = _box_mean(rng.random((H + 2 * m + 8, W + 2 * m + 8)), 9)
    texture = (texture - texture.mean()) / texture.std()
    ys, xs = np.mgrid[0:H + 2 * m, 0:W + 2 * m] - m     # frame 0's coordinates
    for (cx, cy), r in zip(centres, radii):
        y0, y1 = int(max(cy - r - 2 + m, 0)), int(min(cy + r + 3 + m, H + 2 * m))
        x0, x1 = int(max(cx - r - 2 + m, 0)), int(min(cx + r + 3 + m, W + 2 * m))
        d = np.hypot(xs[y0:y1, x0:x1] - cx, ys[y0:y1, x0:x1] - cy)
        cover = np.clip(r + 0.5 - d, 0, 1)[..., None]
        base = np.array([rng.uniform(190, 215), rng.uniform(150, 175), rng.uniform(200, 225)])
        cell = base * (1 + 0.04 * texture[y0:y1, x0:x1, None])
        canvas[y0:y1, x0:x1] = canvas[y0:y1, x0:x1] * (1 - cover) + cell * cover
    seen = np.rint(255.0 * _cast(canvas[..., ::-1] / 255.0)[..., ::-1])
    frames = np.empty((N, H, W, C), np.uint8)
    for i, (dx, dy) in enumerate(shifts):
        frames[i] = seen[m - dy:m - dy + H, m - dx:m - dx + W]
    noise = rng.integers(-2, 3, (N, H, W, C), dtype=np.int8)
    frames = np.clip(frames.astype(np.int16) + noise, 0, 255).astype(np.uint8)
    truth = {"centres": centres[None] + shifts[:, None, :], "radii": radii, "cluster": cluster,
             "patches": cells_patches()}
    return frames, truth


def _s_correct(st):
    """The colour correction of the batch on its device; the model's axis
    is RGB, the frames' BGR."""
    st["corrected"] = st["model"].correctImage(st["x"].flip(-1)).flip(-1)


def _s_gray(st):
    st["gray"] = cvtColor(st["corrected"], K.COLOR_BGR2GRAY)


def _s_blur(st):
    st["blur"] = GaussianBlur(st["gray"], (5, 5), 0)


def _s_binary(st):
    st["otsu"], st["binary"] = threshold(st["blur"], 0, 255, K.THRESH_BINARY | K.THRESH_OTSU)


def _s_opening(st):
    st["opening"] = morphologyEx(st["binary"], K.MORPH_OPEN, np.ones((3, 3), np.uint8),
                                 iterations=2)


def _s_sure_bg(st):
    st["sure_bg"] = dilate(st["opening"], np.ones((3, 3), np.uint8), iterations=3)


def _s_sure_fg(st):
    """The distance transform, and the sure foreground: distances above half
    of their own frame's largest."""
    d = distanceTransform(st["opening"], K.DIST_L2, 5)
    st["distance"] = d
    top = d.amax(dim=(1, 2, 3), keepdim=True)
    st["sure_fg"] = torch.where(d > 0.5 * top, 255, 0).to(torch.uint8)


def _s_unknown(st):
    st["unknown"] = subtract(st["sure_bg"], st["sure_fg"])


def _s_markers(st):
    """The sure foreground's components, + 1, and 0 where unknown; the
    per-frame component counts are the one read."""
    labels, counts = components_batch(st["sure_fg"][..., 0], 8)
    st["n_labels"] = counts.cpu().numpy() + 1
    st["markers"] = torch.where(st["unknown"][..., 0] == 255, 0, labels + 1)


def _s_watershed(st):
    """The native flood of each frame, in a pool of host threads."""
    ws = watershed_frames(st["corrected"], st["markers"])
    st["regions"] = torch.from_numpy(ws).to(st["x"].device)


def _label_sums(labels: torch.Tensor, L: int, values: torch.Tensor) -> torch.Tensor:
    """(N, L, V) f64 sums of the (N, H, W, V) `values` over each label 2..L-1
    of each frame of the (N, H, W) int32 `labels` (rows 0 and 1 zero), from
    one ``index_add_``: exact integer sums, so order-free.  A pixel of
    another label adds into one of 256 spare rows by its position, so that
    the pixels of the background do not all meet on one address."""
    N, H, W = labels.shape
    dev = labels.device
    n = torch.arange(N, device=dev).view(N, 1, 1)
    pos = torch.arange(H * W, device=dev).view(1, H, W) % 256
    lab = labels.to(torch.int64)
    idx = torch.where((lab >= 2) & (lab < L), n * L + lab, N * L + pos).reshape(-1)
    V = values.shape[-1]
    sums = torch.zeros((N * L + 256, V), dtype=torch.float64, device=dev)
    sums.index_add_(0, idx, values.reshape(-1, V).to(torch.float64))
    return sums[:N * L].view(N, L, V)


def _s_cells(st):
    """Per frame: the cells (the watershed's regions of label >= 2), their
    centroids from one scatter of (x, y, 1) per label (read once), and the
    Delaunay triangles of the centroids (host)."""
    ws = st["regions"]
    N, H, W = ws.shape
    L = int(st["n_labels"].max()) + 1
    yy, xx = torch.meshgrid(torch.arange(H, device=ws.device), torch.arange(W, device=ws.device),
                            indexing="ij")
    vals = torch.stack([xx, yy, torch.ones_like(xx)], -1).expand(N, H, W, 3)
    sums = _label_sums(ws, L, vals).cpu().numpy()
    cells, triangles = [], []
    for i in range(N):
        have = np.nonzero(sums[i, :, 2] > 0)[0]
        cent = sums[i, have, :2] / sums[i, have, 2:3]
        cells.append(cent)
        sub = Subdiv2D((0, 0, W, H))
        sub.insert(cent)
        triangles.append(sub.getTriangleList())
    st["centroids"], st["n_cells"], st["triangles"] = cells, [len(c) for c in cells], triangles


def _s_flood(st):
    """Frame 0's background, flooded from (0, 0) into a mask only."""
    d = (SEGMENT_FLOOD_DIFF,) * 3
    _, _, mask, _ = floodFill(st["corrected"][0], None, (0, 0), (0, 0, 0), d, d,
                              8 | FLOODFILL_FIXED_RANGE | FLOODFILL_MASK_ONLY | (255 << 8))
    st["flood"] = mask[1:-1, 1:-1]


def cutout_rect(stats: np.ndarray, shape) -> tuple:
    """grabCut's rect at half size: the box of the largest foreground blob
    of connectedComponentsWithStats' `stats` (background row 0), halved,
    padded by :data:`SEGMENT_RECT_PAD` and clipped to the half-size frame
    (H, W)."""
    H, W = shape
    x, y, w, h, _ = stats[1 + int(np.argmax(stats[1:, 4]))]
    x0, y0 = max(x // 2 - SEGMENT_RECT_PAD, 0), max(y // 2 - SEGMENT_RECT_PAD, 0)
    x1 = min((x + w + 1) // 2 + SEGMENT_RECT_PAD, W)
    y1 = min((y + h + 1) // 2 + SEGMENT_RECT_PAD, H)
    return int(x0), int(y0), int(x1 - x0), int(y1 - y0)


def _s_cutout(st):
    """Frame 0 at half size, mean-shift smoothed, and grabCut's cut of the
    largest cluster of touching cells (the largest blob of the opening)."""
    half = pyrDown(st["corrected"][0])
    ms_stats, gc_stats = {}, {}
    smoothed = pyrMeanShiftFiltering(half, 10, 10, 1, stats=ms_stats)
    labels, counts = components_batch(st["opening"][:1, ..., 0], 8)
    stats, _ = component_stats(labels, int(counts[0]) + 1)
    rect = cutout_rect(stats[0].cpu().numpy(), half.shape[:2])
    mask, bgd, fgd = grabCut(smoothed, None, rect, None, None, 3, GC_INIT_WITH_RECT,
                             stats=gc_stats)
    st.update(half=half, smoothed=smoothed, cut_rect=rect, cut_mask=mask, bgd_model=bgd,
              fgd_model=fgd, ms_stats=ms_stats, gc_stats=gc_stats)


def _s_emd(st):
    """The grey histogram of the cells of each frame (16 bins, under the
    regions of label >= 2, from one scatter), normalised, and EMD (DIST_L1)
    of frame 0's against each other frame's."""
    g = st["gray"][..., 0].to(torch.int64)
    N = g.shape[0]
    n = torch.arange(N, device=g.device).view(N, 1, 1)
    b = SEGMENT_HIST_BINS
    idx = torch.where(st["regions"] >= 2, n * b + g * b // 256, N * b)
    hist = hist_fixed(idx, N * b).view(N, b).cpu().numpy().astype(np.float32)
    st["cell_hist"] = hist
    sig = [np.stack([h / max(h.sum(), 1.0), np.arange(b, dtype=np.float32)], 1) for h in hist]
    st["emd"] = np.array([EMD(sig[0], s, K.DIST_L1)[0] for s in sig[1:]])


def _s_painted(st):
    red = torch.tensor(BOUNDARY_BGR, dtype=torch.uint8, device=st["corrected"].device)
    st["painted"] = torch.where((st["regions"] == -1)[..., None], red, st["corrected"])


# the per-frame sums of forward_segment's "sums" table, in its column order
SEGMENT_SUMS = ("corrected", "gray", "blur", "binary", "opening", "sure_bg", "sure_fg",
                "unknown", "markers", "regions", "painted")


def _s_sums(st):
    st["sums"] = torch.stack([st[k].reshape(st[k].shape[0], -1).sum(dim=1, dtype=torch.int64)
                              for k in SEGMENT_SUMS], dim=1)


# forward_segment's stages in order: (name, fn of the state dict, the keys it
# writes); each reads only keys written before it
SEGMENT_STAGES = (
    ("correct", _s_correct, ("corrected",)),
    ("gray", _s_gray, ("gray",)),
    ("blur", _s_blur, ("blur",)),
    ("threshold", _s_binary, ("otsu", "binary")),
    ("opening", _s_opening, ("opening",)),
    ("sure_bg", _s_sure_bg, ("sure_bg",)),
    ("sure_fg", _s_sure_fg, ("distance", "sure_fg")),
    ("unknown", _s_unknown, ("unknown",)),
    ("markers", _s_markers, ("n_labels", "markers")),
    ("watershed", _s_watershed, ("regions",)),
    ("cells", _s_cells, ("centroids", "n_cells", "triangles")),
    ("flood", _s_flood, ("flood",)),
    ("cutout", _s_cutout, ("half", "smoothed", "cut_rect", "cut_mask", "bgd_model",
                           "fgd_model", "ms_stats", "gc_stats")),
    ("emd", _s_emd, ("cell_hist", "emd")),
    ("painted", _s_painted, ("painted",)),
    ("sums", _s_sums, ("sums",)),
)


def forward_segment(x, model):
    """Cell segmentation of an (N, H, W, 3) u8 BGR video through a
    colour-cast camera, with `model` the camera's fitted
    ColorCorrectionModel (:data:`SEGMENT_STAGES`).

    Returns a dict: ``corrected`` (N, H, W, 3) u8; ``gray``, ``blur``,
    ``binary``, ``opening``, ``sure_bg``, ``sure_fg`` and ``unknown`` (N, H,
    W, 1) u8, with ``otsu`` the batch's threshold (0-dim f64) and
    ``distance`` (N, H, W, 1) f32; ``n_labels`` (N,) numpy and ``markers``
    (N, H, W) int32; ``regions``, the watershed's (N, H, W) int32; per frame
    ``centroids`` (f64 numpy), ``n_cells`` and ``triangles`` (Subdiv2D's
    (k, 6) f32); ``flood``, frame 0's (H, W) u8 background mask; for frame
    0 at half size ``half``, ``smoothed`` (pyrMeanShiftFiltering),
    ``cut_rect``, ``cut_mask`` (grabCut's (H/2, W/2) u8 mask) and the two
    models, with ``ms_stats`` / ``gc_stats`` (the mean shift's moving pixels
    and chunks, the min cuts' host ms); ``cell_hist`` (N, 16) f32 and
    ``emd`` (N-1,) f64; ``painted``, the corrected frames with the
    boundaries in :data:`BOUNDARY_BGR`; and ``sums``, the (N, 11) int64
    per-frame sums of :data:`SEGMENT_SUMS`."""
    st = {"x": x, "model": model}
    for _, stage, _ in SEGMENT_STAGES:
        stage(st)
    del st["x"], st["model"]
    return st


def fit_cells_model(patches=None):
    """The ColorCorrectionModel of the cells camera, fitted on the host on
    :func:`cells_patches` (set-up: a camera is calibrated once)."""
    model = ColorCorrectionModel(cells_patches() if patches is None else patches,
                                 COLORCHECKER_MACBETH)
    return model.compute()


def entry_segment(device="cuda", shape=SHAPE_SEGMENT):
    """``(forward_segment, (x, model))`` with :func:`make_cells_video`'s
    frames on `device` and the camera's fitted model."""
    video, truth = make_cells_video(shape)
    return forward_segment, (torch.from_numpy(video).to(device), fit_cells_model(truth["patches"]))


def segment_truth_report(out, truth) -> dict:
    """How forward_segment's outputs `out` meet the cells video's `truth`:

    - ``missed``: (frame, cell) of each truth centre not inside a region of
      label >= 2; ``shared``: (frame, label) of each region holding two or
      more centres;
    - ``counts``: per frame (regions, cells);
    - ``flood_bg``: the share of frame 0's background (pixels 2 px or more
      outside every disc) that the flood mask covers, and
      ``flood_cells``: the pixels of the discs' interiors (2 px or more
      inside) that it covers;
    - ``cut_iou``: the IoU of grabCut's foreground with the discs at half
      size, inside its rect."""
    regions = out["regions"].cpu().numpy()
    N, H, W = regions.shape
    centres, radii = truth["centres"], truth["radii"]
    missed, shared, counts = [], [], []
    for i in range(N):
        pts = np.rint(centres[i]).astype(np.int64)
        lab = regions[i, pts[:, 1], pts[:, 0]]
        missed += [(i, k) for k in np.nonzero(lab < 2)[0]]
        vals, n = np.unique(lab[lab >= 2], return_counts=True)
        shared += [(i, int(v)) for v in vals[n > 1]]
        counts.append((int(out["n_cells"][i]), len(radii)))
    ys, xs = np.mgrid[0:H, 0:W]
    gap = np.full((H, W), np.inf)
    for (cx, cy), r in zip(centres[0], radii):
        gap = np.minimum(gap, np.hypot(xs - cx, ys - cy) - r)
    flood = out["flood"].cpu().numpy() != 0
    bg, inner = gap >= 2, gap <= -2
    x0, y0, w, h = out["cut_rect"]
    hy, hx = np.mgrid[y0:y0 + h, x0:x0 + w]
    disc = np.zeros((h, w), bool)
    for (cx, cy), r in zip(centres[0] / 2, radii / 2):
        disc |= np.hypot(hx - cx + 0.25, hy - cy + 0.25) <= r
    cut = out["cut_mask"].cpu().numpy()[y0:y0 + h, x0:x0 + w]
    fg = (cut == GC_FGD) | (cut == GC_PR_FGD)
    return {"missed": missed, "shared": shared, "counts": counts,
            "flood_bg": float(flood[bg].mean()), "flood_cells": int(flood[inner].sum()),
            "cut_iou": float((fg & disc).sum() / max((fg | disc).sum(), 1))}


# ------------------------------------------------------ registration path

SHAPE_REGISTER = (8, 1080, 1920, 3)
# cv::Stitcher's registration resolution, in megapixels
REGISTER_MPX = 0.6
# BestOf2NearestMatcher keeps a pair when d0 < (1 - match_conf) * d1; the
# JAX package's stitcher takes match_conf = 0.3
REGISTER_RATIO = 0.7
PAN_STEP = 160.0            # the camera's pan between frames, px at 1080p
PAN_JITTER = 8.0            # px per axis around the pan
PAN_ANGLE = 0.75            # each frame's roll, degrees either way
PAN_SCALE = 0.01            # each frame's zoom, either way


def register_size(H: int, W: int, mpx: float = REGISTER_MPX) -> tuple:
    """(width, height) of cv::Stitcher's registration resolution of `mpx`
    megapixels for an H × W frame: both scaled by sqrt(mpx · 1e6 / (H · W))
    (never up), rounded as ``resize`` rounds fx and fy."""
    s = min(1.0, float(np.sqrt(mpx * 1e6 / (H * W))))
    return int(np.rint(W * s)), int(np.rint(H * s))


def _smooth_noise(rng, h: int, w: int, sigma: float) -> np.ndarray:
    """Zero-mean, unit-deviation Gaussian noise smoothed by a Gaussian of
    `sigma` px (one FFT, the canvas wrapping)."""
    f = np.fft.rfft2(rng.standard_normal((h, w)))
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    a = np.fft.irfft2(f * np.exp(-2.0 * np.pi ** 2 * sigma ** 2 * (fx ** 2 + fy ** 2)), s=(h, w))
    return (a - a.mean()) / a.std()


def _pan_pose(rng, i: int, scale: float) -> np.ndarray:
    """Frame i's camera: the 2×3 map from its pixels to the canvas about
    the frame's centre, (angle, zoom, shift)."""
    ang = np.deg2rad(rng.uniform(-PAN_ANGLE, PAN_ANGLE))
    z = 1.0 + rng.uniform(-PAN_SCALE, PAN_SCALE)
    t = np.array([i * PAN_STEP, 0.0]) * scale + rng.uniform(-PAN_JITTER, PAN_JITTER, 2) * scale
    return np.array([[z * np.cos(ang), -z * np.sin(ang), t[0]],
                     [z * np.sin(ang), z * np.cos(ang), t[1]]])


def make_pan_video(shape=SHAPE_REGISTER, seed: int = 0):
    """A camera panning over one textured scene, all from one
    ``default_rng(seed)``: ``(frames, truth)``.

    - the scene: Gaussian-smoothed noise at two scales (σ 24 px with a
      deviation of 45 grey levels, σ 3 px with 10, at 1080p) with 90 filled
      discs, rectangles and triangles per frame's area in random greys,
      tinted per channel, on a canvas wide enough for the whole pan (SIFT
      finds about 1.7 k keypoints in a frame at the registration size);
    - frame i samples the canvas (bilinear) through its camera: a pan of
      :data:`PAN_STEP` px a frame with ±:data:`PAN_JITTER` px per axis, a
      roll of ±:data:`PAN_ANGLE`° and a zoom of ±:data:`PAN_SCALE`, each
      drawn per frame, so that consecutive frames differ by a shift of about
      160 px, a rotation of at most 1.5° and a scale in 0.98–1.02;
    - sensor noise, uniform in ±2 per channel.

    ``truth`` is the (N-1, 2, 3) f64 matrix that maps a pixel of frame i to
    the same scene point in frame i+1.  Returns the (N, H, W, 3) u8 BGR
    frames."""
    N, H, W, C = shape
    rng = np.random.default_rng(seed)
    s = min(H / 1080, W / 1920)
    mg = int(np.ceil(48 * s)) + 8
    Hc, Wc = H + 2 * mg, W + int(np.ceil((N - 1) * PAN_STEP * s)) + 2 * mg
    tex = 128.0 + 45.0 * _smooth_noise(rng, Hc, Wc, 24.0 * s) \
        + 10.0 * _smooth_noise(rng, Hc, Wc, 3.0 * s)
    ys, xs = np.mgrid[0:Hc, 0:Wc]
    for _ in range(int(90 * Hc * Wc / (H * W))):
        kind = rng.integers(0, 3)
        cx, cy = rng.uniform(0, Wc), rng.uniform(0, Hc)
        r = rng.uniform(12, 60) * s
        x0, x1 = int(max(cx - 2 * r, 0)), int(min(cx + 2 * r + 1, Wc))
        y0, y1 = int(max(cy - 2 * r, 0)), int(min(cy + 2 * r + 1, Hc))
        X, Y = xs[y0:y1, x0:x1] - cx, ys[y0:y1, x0:x1] - cy
        if kind == 0:
            inside = X ** 2 + Y ** 2 <= r * r
        elif kind == 1:
            inside = (np.abs(X) <= r) & (np.abs(Y) <= rng.uniform(0.4, 1.0) * r)
        else:
            a = rng.uniform(0, 2 * np.pi) + np.arange(3) * 2 * np.pi / 3
            vx, vy = r * np.cos(a), r * np.sin(a)
            inside = np.ones(X.shape, bool)
            for k in range(3):
                ex, ey = vx[(k + 1) % 3] - vx[k], vy[(k + 1) % 3] - vy[k]
                inside &= ex * (Y - vy[k]) - ey * (X - vx[k]) >= 0
        tex[y0:y1, x0:x1][inside] = rng.uniform(0, 255)
    tint = rng.uniform(0.85, 1.15, C)
    canvas = np.clip(tex[..., None] * tint, 0, 255)
    poses = [_pan_pose(rng, i, s) for i in range(N)]
    c = np.array([(W - 1) / 2.0, (H - 1) / 2.0])
    py, px = np.mgrid[0:H, 0:W].astype(np.float64)
    frames = np.empty((N, H, W, C), np.float64)
    for i, P in enumerate(poses):
        u = P[0, 0] * (px - c[0]) + P[0, 1] * (py - c[1]) + c[0] + mg + P[0, 2]
        v = P[1, 0] * (px - c[0]) + P[1, 1] * (py - c[1]) + c[1] + mg + P[1, 2]
        u0, v0 = np.floor(u).astype(np.int64), np.floor(v).astype(np.int64)
        fu, fv = (u - u0)[..., None], (v - v0)[..., None]
        frames[i] = ((canvas[v0, u0] * (1 - fu) + canvas[v0, u0 + 1] * fu) * (1 - fv)
                     + (canvas[v0 + 1, u0] * (1 - fu) + canvas[v0 + 1, u0 + 1] * fu) * fv)
    noise = rng.integers(-2, 3, (N, H, W, C))
    video = np.clip(np.rint(frames) + noise, 0, 255).astype(np.uint8)
    # frame pixel p -> canvas A_i (p - c) + c + t_i; frame i -> frame i+1
    truth = np.empty((N - 1, 2, 3))
    for i in range(N - 1):
        A0, A1 = poses[i][:, :2], poses[i + 1][:, :2]
        inv = np.linalg.inv(A1)
        L = inv @ A0
        truth[i, :, :2] = L
        truth[i, :, 2] = inv @ (poses[i][:, 2] - poses[i + 1][:, 2]) + c - L @ c
    return video, truth


def _r_gray(st):
    st["gray"] = cvtColor(st["x"], K.COLOR_BGR2GRAY)


def _r_small(st):
    g = st["gray"]
    st["small"] = resize(g, register_size(g.shape[1], g.shape[2], st["mpx"]),
                         interpolation=K.INTER_LINEAR_EXACT)


def _r_pyramid(st):
    st["gpyr"], st["dog"] = st["sift"].build_pyramids(st["small"][..., 0])


def _r_masks(st):
    st["masks"] = st["sift"].extrema_masks(st["dog"])


def _r_readback(st):
    st["gpyr_np"], st["dog_np"], st["masks_np"] = st["sift"].read_back(
        st["gpyr"], st["dog"], st["masks"])


def _r_features(st):
    feats = [st["sift"].host_tails(st["gpyr_np"], st["dog_np"], st["masks_np"], b)
             for b in range(st["small"].shape[0])]
    st["keypoints"] = [k for k, _ in feats]
    st["descriptors"] = [d for _, d in feats]


def _r_index(st):
    """One FLANN kd-tree forest per frame pair, over frame i+1's
    descriptors (FlannBasedMatcher's defaults: 4 trees)."""
    matchers = []
    for d in st["descriptors"][1:]:
        m = FlannBasedMatcher()
        m.add(d)
        m.train()
        matchers.append(m)
    st["matchers"] = matchers


def _r_search(st):
    st["knn"] = [m.knnMatch(d, None, 2) for m, d in zip(st["matchers"], st["descriptors"])]


def _r_ratio(st):
    """The ratio test of each pair, the good pairs' points, and per pair
    (good, queried)."""
    good, points, counts = [], [], []
    for i, knn in enumerate(st["knn"]):
        pairs = np.array([(p[0].queryIdx, p[0].trainIdx) for p in knn
                          if len(p) == 2 and p[0].distance < REGISTER_RATIO * p[1].distance],
                         np.int64).reshape(-1, 2)
        k0, k1 = st["keypoints"][i], st["keypoints"][i + 1]
        p0 = np.array([k0[q].pt for q in pairs[:, 0]], np.float64).reshape(-1, 2)
        p1 = np.array([k1[t].pt for t in pairs[:, 1]], np.float64).reshape(-1, 2)
        good.append(pairs)
        points.append((p0, p1))
        counts.append((len(pairs), len(knn)))
    st.update(good=good, points=points, counts=counts)


# forward_register's stages in order: (name, fn of the state dict, the keys
# it writes); each reads only keys written before it
REGISTER_STAGES = (
    ("gray", _r_gray, ("gray",)),
    ("resize", _r_small, ("small",)),
    ("pyramid", _r_pyramid, ("gpyr", "dog")),
    ("masks", _r_masks, ("masks",)),
    ("readback", _r_readback, ("gpyr_np", "dog_np", "masks_np")),
    ("features", _r_features, ("keypoints", "descriptors")),
    ("flann_build", _r_index, ("matchers",)),
    ("flann_search", _r_search, ("knn",)),
    ("ratio", _r_ratio, ("good", "points", "counts")),
)


def forward_register(x, mpx: float = REGISTER_MPX):
    """Feature registration of consecutive frames of an (N, H, W, 3) u8 BGR
    video, as cv::Stitcher registers its images (:data:`REGISTER_STAGES`):
    gray → ``resize`` to the `mpx` (0.6) Mpx registration size with
    INTER_LINEAR_EXACT → SIFT's ``detect_and_compute_batch`` (the pyramids
    and extremum masks on the device, one read-back, the host tails) → for
    each pair (i, i+1), FlannBasedMatcher's kNN (k = 2) of frame i's
    descriptors in frame i+1's → the ratio test d0 < 0.7 d1.

    Returns a dict: ``gray`` (N, H, W, 1) and ``small`` (N, h, w, 1) u8;
    ``gpyr``, ``dog`` and ``masks``, SIFT's levels per octave on the device
    ((N, h_o, w_o) f32 and bool); ``keypoints`` and ``descriptors`` per frame
    (cv2 KeyPoints at the registration size, (k, 128) f32); ``knn``, the
    DMatch lists of each pair; ``good``, each pair's (g, 2) int64 (query,
    train) indices; ``points``, each pair's (p_i, p_{i+1}) (g, 2) f64 points;
    ``counts``, each pair's (good pairs, descriptors queried)."""
    st = {"x": x, "mpx": mpx, "sift": SIFT_create()}
    for _, stage, _ in REGISTER_STAGES:
        stage(st)
    for k in ("x", "mpx", "sift", "matchers", "gpyr_np", "dog_np", "masks_np"):
        del st[k]
    return st


def entry_register(device="cuda", shape=SHAPE_REGISTER):
    """``(forward_register, (x,))`` with :func:`make_pan_video`'s frames on
    `device`."""
    video, _ = make_pan_video(shape)
    return forward_register, (torch.from_numpy(video).to(device),)


def register_truth_report(out, truth, shape, size, tol: float = 1.5) -> dict:
    """How a path's good pairs meet the pan's `truth` matrices (full-size
    pixels of frame i to frame i+1): each point of frame i, found on frames
    of `size` (w, h), is taken to full size (the pixel centres of a resize
    or of a 2×2 mean: p' = (p + 0.5)·s − 0.5), moved by the truth, taken
    back and compared with its match in frame i+1.  `out["points"]` holds
    each pair's (p_i, p_{i+1}).  ``share``: the share of all good pairs
    within `tol` px; ``per_pair``: each pair's (good pairs, share within
    `tol`, median error px)."""
    H, W = shape[1], shape[2]
    w, h = size
    sx, sy = W / w, H / h
    inside, total, per = 0, 0, []
    for (p0, p1), M in zip(out["points"], truth):
        full = np.stack([(p0[:, 0] + 0.5) * sx - 0.5, (p0[:, 1] + 0.5) * sy - 0.5], 1)
        moved = full @ M[:, :2].T + M[:, 2]
        pred = np.stack([(moved[:, 0] + 0.5) / sx - 0.5, (moved[:, 1] + 0.5) / sy - 0.5], 1)
        err = np.hypot(*(pred - p1).T)
        ok = int((err <= tol).sum())
        inside, total = inside + ok, total + len(err)
        per.append((len(err), ok / max(len(err), 1),
                    float(np.median(err)) if len(err) else float("nan")))
    return {"share": inside / max(total, 1), "per_pair": per}


# ------------------------------------------------------ feature tracking

SHAPE_TRACK = (8, 1080, 1920, 3)
# the ratio test and the inlier distance of OpenCV's AKAZE tutorial
# (samples/cpp/tutorial_code/features2D/AKAZE_match.cpp)
TRACK_RATIO = 0.8
TRACK_TOL_PX = 2.5
# BRISK's LSH index: the parameters of OpenCV's feature-matching tutorial
TRACK_LSH = {"algorithm": 6, "table_number": 6, "key_size": 12, "multi_probe_level": 1}
# KAZE keeps every level at full size and its host tails grow with the
# keypoints: it runs on the first frames only
TRACK_KAZE_FRAMES = 2
TRACK_DETECTORS = ("akaze", "brisk", "kaze")


def _t_small(st):
    st["small"] = fused_gray_gauss5_down2(st["x"], 0.0)


def _t_akaze_space(st):
    st["akaze_levels"] = st["akaze"].scale_space(to_float_image(st["small"]))


def _t_akaze_detect(st):
    ak = st["akaze"]
    st["akaze_masks"] = ak.maxima_masks(st["akaze_levels"])
    st["akaze_host"] = read_levels(st["akaze_levels"], st["akaze_masks"])
    st["akaze_keypoints"] = [ak.host_detect(image_levels(st["akaze_host"], b))
                             for b in range(st["small"].shape[0])]


def _t_akaze_describe(st):
    feats = [st["akaze"].host_describe(image_levels(st["akaze_host"], b), k)
             for b, k in enumerate(st["akaze_keypoints"])]
    st["akaze_descriptors"] = [d for _, d in feats]


def _t_brisk(st):
    br, small = st["brisk"], st["small"]
    layers = br.pyramid(small)
    st["brisk_layers"] = [a for a, _ in layers]
    st["brisk_scores"] = br.score_layers(layers)
    rows = br.read_candidates(st["brisk_scores"], [s for _, s in layers])
    feats = br.compute_batch(small, [br.nms(r) for r in rows])
    st["brisk_keypoints"] = [k for k, _ in feats]
    st["brisk_descriptors"] = [d for _, d in feats]


def _t_kaze(st):
    kz = st["kaze"]
    st["kaze_levels"] = kz.scale_space(to_float_image(st["small"][:TRACK_KAZE_FRAMES]))
    lv = read_levels(st["kaze_levels"], keys=("Lx", "Ly", "Ldet"))
    feats = []
    for b in range(st["kaze_levels"][0]["Ldet"].shape[0]):
        levels = image_levels(lv, b)
        feats.append(kz.host_describe(levels, kz.host_detect(levels)))
    st["kaze_keypoints"] = [k for k, _ in feats]
    st["kaze_descriptors"] = [d for _, d in feats]


def _t_match(st):
    """Per detector and frame pair: kNN (k = 2) of frame i's descriptors in
    frame i+1's, the ratio test d0 < 0.8 d1, the good pairs' points and
    (good pairs, descriptors queried).  AKAZE through BFMatcher
    (NORM_HAMMING) on the frames' device (integer distances, equal on every
    device), BRISK through FlannBasedMatcher's LSH index over frame i+1 and
    KAZE through BFMatcher (NORM_L2) on the host."""
    knn, good, points, counts = {}, {}, {}, {}
    dev = st["small"].device
    for det in TRACK_DETECTORS:
        kps, desc = st[f"{det}_keypoints"], st[f"{det}_descriptors"]
        rows = []
        for i in range(len(desc) - 1):
            if det == "brisk":
                m = FlannBasedMatcher(TRACK_LSH, {"checks": 32})
                m.add(desc[i + 1])
                m.train()
                rows.append(m.knnMatch(desc[i], None, 2))
            elif det == "akaze":
                rows.append(BFMatcher(K.NORM_HAMMING).knnMatch(
                    to_device(desc[i], dev), to_device(desc[i + 1], dev), 2))
            else:
                rows.append(BFMatcher(K.NORM_L2).knnMatch(desc[i], desc[i + 1], 2))
        knn[det], good[det], points[det], counts[det] = rows, [], [], []
        for i, r in enumerate(rows):
            pairs = np.array([(p[0].queryIdx, p[0].trainIdx) for p in r
                              if len(p) == 2 and p[0].distance < TRACK_RATIO * p[1].distance],
                             np.int64).reshape(-1, 2)
            p0 = np.array([kps[i][q].pt for q in pairs[:, 0]], np.float64).reshape(-1, 2)
            p1 = np.array([kps[i + 1][t].pt for t in pairs[:, 1]], np.float64).reshape(-1, 2)
            good[det].append(pairs)
            points[det].append((p0, p1))
            counts[det].append((len(pairs), len(r)))
    st.update(knn=knn, good=good, points=points, counts=counts)


# forward_track's stages in order: (name, fn of the state dict, the keys it
# writes); each reads only keys written before it
TRACK_STAGES = (
    ("small", _t_small, ("small",)),
    ("akaze_space", _t_akaze_space, ("akaze_levels",)),
    ("akaze_detect", _t_akaze_detect, ("akaze_masks", "akaze_host", "akaze_keypoints")),
    ("akaze_describe", _t_akaze_describe, ("akaze_descriptors",)),
    ("brisk", _t_brisk, ("brisk_layers", "brisk_scores", "brisk_keypoints",
                         "brisk_descriptors")),
    ("kaze", _t_kaze, ("kaze_levels", "kaze_keypoints", "kaze_descriptors")),
    ("match", _t_match, ("knn", "good", "points", "counts")),
)


def track_state(x) -> dict:
    """forward_track's state before its first stage."""
    return {"x": x, "akaze": AKAZE_create(), "brisk": BRISK_create(), "kaze": KAZE_create()}


def forward_track(x):
    """Feature tracking between consecutive frames of an (N, H, W, 3) u8 BGR
    video at half size, as visual-odometry and SLAM front ends track
    (:data:`TRACK_STAGES`): ``fusedPreprocessGrayBlurDown2`` (the one
    ``gauss5_down2`` launch) → AKAZE (MLDB, threshold 0.001, 4 octaves × 4
    sublevels, PM_G2: the scale space and maxima masks of every frame on
    the device, one read-back, the host suppression, refinement,
    orientation and descriptors) → BRISK (thresh 30, 3 octaves: the pyramid
    and AGAST on the device, the NMS on the host, the descriptors' reads
    and bits on the device) → KAZE on the first :data:`TRACK_KAZE_FRAMES`
    frames → per detector and pair (i, i+1), kNN (k = 2) and the ratio test
    d0 < 0.8 d1.

    Returns a dict: ``small`` (N, H/2, W/2) u8; ``akaze_levels`` and
    ``kaze_levels``, the level dicts with ``Lt``, ``Lx``, ``Ly`` and
    ``Ldet`` ((B, h, w) f32 on the device); ``akaze_masks``;
    ``brisk_layers`` and ``brisk_scores`` (AGAST's (score, keep) per
    layer); ``<det>_keypoints`` and ``<det>_descriptors`` per frame; and
    per detector (``akaze``, ``brisk``, ``kaze``) in ``knn``, ``good``,
    ``points`` and ``counts`` each pair's DMatch rows, (g, 2) int64 (query,
    train) indices, (p_i, p_{i+1}) points at half size, and (good pairs,
    descriptors queried)."""
    st = track_state(x)
    for _, stage, _ in TRACK_STAGES:
        stage(st)
    for k in ("x", "akaze", "brisk", "kaze", "akaze_host"):
        del st[k]
    return st


def entry_track(device="cuda", shape=SHAPE_TRACK):
    """``(forward_track, (x,))`` with :func:`make_pan_video`'s frames on
    `device`."""
    video, _ = make_pan_video(shape)
    return forward_track, (torch.from_numpy(video).to(device),)


def track_truth_report(out, truth, shape, det: str, tol: float = TRACK_TOL_PX) -> dict:
    """:func:`register_truth_report` of detector `det`'s good pairs, found
    on the half-size frames."""
    h, w = out["small"].shape[1:3]
    return register_truth_report({"points": out["points"][det]}, truth, shape, (w, h), tol)


# ------------------------------------------------------------ the mesh

# how long spawned ranks may run before they are killed (a hung collective
# fails its caller instead of hanging it)
MESH_TIMEOUT_S = 300.0


def _spawn(fn, nprocs: int, args: tuple) -> None:
    """Run fn(rank, *args) in `nprocs` spawned processes and wait at most
    MESH_TIMEOUT_S for all of them; a rank that fails raises here, and
    ranks still running at the timeout are killed and raise."""
    import time

    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + MESH_TIMEOUT_S
    while not ctx.join(timeout=max(0.0, min(5.0, deadline - time.monotonic()))):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"{nprocs} ranks did not finish in {MESH_TIMEOUT_S} s")


def _init_rank(rank: int, world: int, store_path: str, backend: str) -> None:
    import torch.distributed as dist

    if backend == "nccl":
        torch.cuda.set_device(rank)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world)


def _gather_blocks(local: torch.Tensor, mesh, sp: bool = True) -> torch.Tensor:
    """The global tensor from every rank's block (blocks of N over "data",
    of H over "sp" when `sp`), on every rank, on the CPU."""
    import torch.distributed as dist

    parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, local.contiguous())
    grid = mesh.mesh.tolist()
    rows = [torch.cat([parts[r] for r in row], dim=1) if sp else parts[row[0]] for row in grid]
    return torch.cat(rows, dim=0).cpu()


def _dp_step(n_sp: int):
    def step(x):
        g = cvtColor(x, K.COLOR_BGR2GRAY)
        b = GaussianBlur(g, (3, 3), 0)
        return resize(b, (32, 16 * n_sp))
    return step


def _dryrun_rank(rank: int, world: int, store_path: str, backend: str) -> None:
    """One rank of :func:`dryrun_multichip`."""
    import torch.distributed as dist

    from .parallel import (make_mesh, shard_batch, sharded_otsu, sharded_pipeline,
                           spatial_gaussian_blur, spatial_sep_filter)

    _init_rank(rank, world, store_path, backend)
    try:
        n_sp = 2 if world % 2 == 0 and world >= 4 else 1
        n_data = world // n_sp
        mesh = make_mesh(n_data, n_sp)
        rng = np.random.default_rng(0)
        imgs = rng.integers(0, 256, size=(2 * n_data, 32 * n_sp, 64, 3), dtype=np.uint8)
        # batch-DP step over the mesh: each rank its block of images
        out = _gather_blocks(sharded_pipeline(_dp_step(n_sp), mesh)(imgs), mesh, sp=False)
        assert out.shape == (2 * n_data, 16 * n_sp, 32, 1), out.shape
        # spatial sharding with the halo exchange over the sp axis
        if n_sp > 1:
            gray = rng.integers(0, 256, size=(2 * n_data, 32 * n_sp, 64, 1), dtype=np.uint8)
            g = shard_batch(gray, mesh)
            out2 = spatial_gaussian_blur(g, (5, 5), 1.1, mesh)
            assert out2.shape == g.shape
            # the generalised halo filter under the REFLECT_101 default border
            out3 = spatial_sep_filter(g, (5, 5), 1.1, mesh, border=K.BORDER_REFLECT_101)
            assert out3.shape == g.shape
            # the all-reduced histogram's Otsu threshold
            thr = sharded_otsu(g, mesh)
            assert thr.shape == () and 0 <= float(thr) <= 255
    finally:
        dist.destroy_process_group()


def _backend(n: int) -> str:
    return "nccl" if torch.cuda.is_available() and torch.cuda.device_count() >= n else "gloo"


def dryrun_multichip(n_devices: int) -> None:
    """Twin of ``__graft_entry__.py::dryrun_multichip``: `n_devices` ranks,
    spawned, on NCCL where there are that many CUDA devices and else on gloo
    over the CPU, each in a group on a ``FileStore`` in a temporary
    directory.  A ("data", "sp") mesh with sp = 2 when n is even and at
    least 4: the batch-DP step (gray → GaussianBlur 3×3 → resize) and, with
    sp > 1, the zero-border spatial blur, the REFLECT_101 spatial filter and
    the sharded Otsu; each rank asserts the reference's shapes."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        _spawn(_dryrun_rank, n_devices, (n_devices, f"{d}/store", _backend(n_devices)))


# the borders the mesh scenarios run spatial_sep_filter under
MESH_BORDERS = (K.BORDER_REFLECT_101, K.BORDER_REPLICATE, K.BORDER_REFLECT, K.BORDER_WRAP,
                K.BORDER_CONSTANT)


def make_mesh_batch(n_data: int, n_sp: int, seed: int = 0):
    """The global inputs of :func:`run_mesh_scenarios`: an (4·n_data,
    24·n_sp, 40, 3) u8 BGR batch and an (4·n_data, 24·n_sp, 40, 1) u8 gray
    batch with a smooth ramp under the noise (so Otsu has classes to
    split)."""
    rng = np.random.default_rng(seed)
    N, H, W = 4 * n_data, 24 * n_sp, 40
    bgr = rng.integers(0, 256, (N, H, W, 3), dtype=np.uint8)
    ramp = np.linspace(0, 160, W)[None, None, :, None]
    gray = np.clip(rng.integers(0, 96, (N, H, W, 1)) + ramp, 0, 255).astype(np.uint8)
    return bgr, gray


def _mesh_rank(rank: int, world: int, store_path: str, backend: str, n_data: int, n_sp: int,
               out_path: str) -> None:
    """One rank of :func:`run_mesh_scenarios`: every scenario on this
    rank's blocks, the outputs gathered; rank 0 writes them to `out_path`."""
    import torch.distributed as dist

    from .parallel import (make_mesh, shard_batch, sharded_hist, sharded_min_max,
                           sharded_otsu, sharded_pipeline, spatial_gaussian_blur,
                           spatial_sep_filter)

    _init_rank(rank, world, store_path, backend)
    try:
        mesh = make_mesh(n_data, n_sp)
        bgr, gray = make_mesh_batch(n_data, n_sp)
        g = shard_batch(gray, mesh)
        res = {"dp_step": _gather_blocks(sharded_pipeline(_dp_step(n_sp), mesh)(bgr), mesh,
                                         sp=False)}
        for k in (3, 5):
            res[f"blur{k}"] = _gather_blocks(spatial_gaussian_blur(g, (k, k), 1.1, mesh), mesh)
            for b in MESH_BORDERS:
                res[f"sep{k}_{b}"] = _gather_blocks(
                    spatial_sep_filter(g, (k, k), 1.1, mesh, border=b), mesh)
        mn, mx = sharded_min_max(g, mesh)
        res["min_max"] = torch.stack([mn, mx]).cpu()
        res["hist"] = sharded_hist(g, mesh).cpu()
        res["otsu"] = sharded_otsu(g, mesh).reshape(1).cpu()
        if rank == 0:
            np.savez(out_path, **{k: v.numpy() for k, v in res.items()})
    finally:
        dist.destroy_process_group()


def run_mesh_scenarios(n_data: int, n_sp: int, out_path: str) -> dict:
    """Every mesh scenario on an n_data × n_sp mesh of spawned ranks (gloo
    on the CPU, or NCCL with that many CUDA devices) over
    :func:`make_mesh_batch`'s inputs: the batch-DP step, the zero-border
    spatial blur and the spatial filter under each of :data:`MESH_BORDERS`
    at 3×3 and 5×5, and the sharded min/max, histogram and Otsu.  Returns
    the gathered outputs, by name, as numpy."""
    import tempfile

    world = n_data * n_sp
    with tempfile.TemporaryDirectory() as d:
        _spawn(_mesh_rank, world, (world, f"{d}/store", _backend(world), n_data, n_sp, out_path))
    with np.load(out_path) as z:
        return {k: z[k] for k in z.files}
