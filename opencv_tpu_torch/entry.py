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

``forward_video`` is video analytics on a shaking camera, the steps of
OpenCV's own video tutorials as CCTV, traffic and drone pipelines run them:
gray → goodFeaturesToTrack on frame 0 (500 corners, quality 0.01, distance
7, block 7) → pyramidal Lucas-Kanade of frame 0 to each later frame at
cv2's defaults (21×21, 3 levels, 30 iterations; each level's pair one
``pyr_down`` launch) → the camera's shake as each frame's median track
displacement, and the frames aligned by it rounded (warpAffine, NEAREST,
BORDER_REPLICATE) → MOG2 at its defaults over the aligned frames → one
``pyrDown`` of the gray batch (one ``pyr_down`` launch) and Farnebäck
(0.5, 3, 15, 3, 5, 1.2) of half-size frame 0 to each later one
(:data:`VIDEO_STAGES`).  ``entry_video`` gives it ``make_motion_video()``'s
frames; ``video_truth_report`` checks the tracks, the shake, the dense flow
and the masks against the video's shifts and object boxes.

``forward_stereo`` computes depth from a calibrated stereo rig, as OpenCV's
samples/cpp/stereo_calib.cpp and stereo_match.cpp do it: once,
``calibrate_rig`` finds the 9×6 chessboard in each of N pairs
(findChessboardCorners, cornerSubPix 11×11), calibrates each camera and
then the pair (intrinsics fixed), rectifies (stereoRectify, alpha 0) and
builds the four maps on the device; then, per frame pair: remap LINEAR of
both frames → ``fusedPreprocessGrayBlurDown2`` of the rectified pair (the
one ``gauss5_down2`` launch, N = 2) → StereoSGBM at half size (128
disparities, window 3, P1 72, P2 288) → cvtColor and StereoBM at full size
(240 disparities, window 9) → filterSpeckles (the native host tail) →
reprojectImageTo3D of the BM disparity (:data:`STEREO_STAGES`).
``make_stereo_rig`` renders the rig's calibration pairs and one scene pair
of textured planes at 1.5-6 m, with their truth; ``entry_stereo`` gives
the path its calibrated rig and the scene pair, and
``stereo_truth_report`` checks the calibration, the rectification and both
disparities against the truth.

``forward_detect`` finds objects in camera frames in front of a detector,
as OpenCV's samples/dnn/object_detection.py runs YOLO: blobFromImages
(1/255, 416×416, swapRB) → the net's forward (both YOLO heads) → each
frame's DetectionModel.detect decode at confThreshold 0.5 → NMSBoxesBatched
at 0.4 (:data:`DETECT_STAGES`).  ``make_detect_net`` writes Darknet's
yolov3-tiny.cfg and random weights made from a seed as a ``.weights`` file
and reads them with ``readNetFromDarknet``; ``make_detect_frames`` draws
shapes on gradient backgrounds; ``entry_detect`` gives the path both.

``forward_stitch`` stitches a panning camera's frames into one panorama
through ``Stitcher.create().stitch`` (ORB, BFMatcher, RANSAC findHomography,
warpPerspective, the distance-transform seam, multi-band blending);
``pan_extent`` gives the extent ``make_pan_video``'s truth implies.
``gapi_flagship`` is the flagship chain as a G-API ``GComputation`` with
pyrDown of the gray frame as a second output, and ``forward_gapi`` runs it
over host batches through ``gapi.Stream``.  ``forward_track_dnn`` updates
GOTURN trackers (``make_goturn_net``: GOTURN's published CaffeNet towers
with random weights made from a seed, written as a ``.caffemodel`` by the
port's codec) on ``make_motion_video``'s frames; ``small_dnn_models``
builds the small ONNX graphs of the other DNN trackers and features.

``forward_objdetect`` runs the object detectors over camera frames as a
warehouse or AR pipeline does: each frame's ArucoDetector.detectMarkers
(DICT_6X6_250; its adaptive thresholds through ``sep_filter``, route k3 at
window 3 and the box kernel at 13 and 23), CharucoDetector.detectBoard,
QRCodeDetector on the band that holds the codes, BarcodeDetector and
HOGDescriptor.detectMultiScale with the INRIA people SVM at
samples/python/peopledetect.py's settings, then CCheckerDetector on a
colour chart (:data:`OBJDETECT_STAGES`). ``make_marker_scene`` draws the
frames with numpy from a seed (markers under mild homographies, the 5 x 7
ChArUco board, a QR code, an EAN-13 code) with their truth, which
``objdetect_truth_report`` checks. ``haar_cascade_xml`` and
``face_models`` write a Haar cascade and YuNet / SFace graphs from a seed
(their published files are not in the repository).

``forward_fusion`` is KinectFusion's loop at ``cv::kinfu::Params::
defaultParams()``: a room (``make_room_mesh``) rendered by
triangleRasterizeDepth along a 30-frame trajectory and sent as u16
millimetres, Odometry.compute frame to frame, Volume.integrate of each
frame in a 512³ TSDF of 3 m at its chained pose, then the raycast and
fetchPointsNormals (:data:`FUSION_STAGES`); ``fusion_truth_report`` checks
the chained pose and the raycast depth against the trajectory.

``forward_videostab`` stabilises ``make_motion_video``'s shaking camera
with ``videostab.OnePassStabilizer`` (radius 15, over 2 * 15 + 1 frames):
GFTT and LK of each consecutive pair (LK's pyramids through ``pyr_down``),
the similarity RANSAC and the Gaussian motion filter on the host, the
warps on the card; ``videostab_truth_report`` holds each motion to the
video's shifts and the jitter to tests/test_video.py's gain.
``forward_codec`` takes JPEGs in (``make_codec_frames``: the motion
frames through ``imencode('.jpg')``), decodes them on the host, runs the
flagship :func:`forward` on the card and writes PNGs.  ``forward_videoio``
is the loop most OpenCV programs run, VideoCapture → the card →
VideoWriter: it reads a HuffYUV AVI (``make_videoio_files``: the motion
frames and a ``FileStorage`` YAML of the run's parameters), runs the
flagship chain with the YAML's parameters and writes an FFV1 AVI.

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
from .core.arrays import as_tensor, to_device
from .utils.trace import region, trace_region
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
from .ops.warp import getRotationMatrix2D, remap, warpAffine, warpPerspective
from .ops.contours import boundingRect, contourArea, findContours
from .ops.misc import createHanningWindow, phase_correlate_batch
from .videostab import STABILIZE_STAGES, OnePassStabilizer
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
from .ops.corners import goodFeaturesToTrack
from .video.bgsub import createBackgroundSubtractorMOG2
from .video.farneback import calcOpticalFlowFarneback
from .video.lk import calcOpticalFlowPyrLK
from .core.fixedpoint import saturate_cast
from .calib3d import (StereoBM, StereoBM_create, StereoSGBM, StereoSGBM_create, calibrateCamera,
                      cornerSubPix, findChessboardCorners, initUndistortRectifyMap, stereoCalibrate,
                      stereoRectify)
from .calib3d.geometry import Rodrigues, projectPoints, undistortPoints
from .calib3d.chessboard import CALIB_CB_ADAPTIVE_THRESH, CALIB_CB_NORMALIZE_IMAGE, _sb_grid_regular
from .calib3d.misc3d import filterSpeckles, reprojectImageTo3D
from .photo import (AlignMTB, INPAINT_TELEA, createAlignMTB, createMergeMertens, detailEnhance,
                    fastNlMeansDenoisingColored, inpaint, textureFlattening)

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
           "SHAPE_VIDEO", "VIDEO_STAGES", "VIDEO_GFTT", "VIDEO_FARNEBACK", "VIDEO_LK_REACH",
           "VIDEO_BORDER", "forward_video", "entry_video", "video_truth_report",
           "SHAPE_PHOTO", "PHOTO_STAGES", "PHOTO_TIMES", "PHOTO_SHIFTS", "PHOTO_NOISE",
           "PHOTO_NLM", "PHOTO_DETAIL", "PHOTO_FLATTEN", "PHOTO_INPAINT_RADIUS", "make_bracket",
           "fuse", "photo_state", "forward_photo", "entry_photo", "photo_truth_report",
           "MESH_BORDERS", "MESH_TIMEOUT_S", "dryrun_multichip", "make_mesh_batch",
           "run_mesh_scenarios",
           "SHAPE_DETECT", "DETECT_SIZE", "DETECT_CONF", "DETECT_NMS", "DETECT_OBJ_BIAS",
           "DETECT_PRIOR_BIAS", "DETECT_OBJECTS",
           "DETECT_STAGES", "YOLOV3_TINY_CFG", "yolov3_tiny_cfg", "darknet_convs",
           "detect_flops", "write_darknet_weights", "make_detect_net", "make_detect_frames",
           "forward_detect", "entry_detect",
           "SHAPE_STITCH", "forward_stitch", "pan_extent", "gapi_flagship", "forward_gapi",
           "SHAPE_TRACK_DNN", "GOTURN_INPUT", "GOTURN_PRIOR", "GOTURN_FC8_GAIN",
           "goturn_prototxt", "goturn_layers", "goturn_flops", "write_goturn_caffemodel",
           "goturn_files", "make_goturn_net", "make_goturn_trackers", "forward_track_dnn",
           "small_dnn_models", "dnn_sweep",
           "VIDEOSTAB_RADIUS", "SHAPE_VIDEOSTAB", "VIDEOSTAB_STAGES", "VIDEOSTAB_CROP",
           "VIDEOSTAB_JITTER_GAIN", "forward_videostab", "entry_videostab", "motion_translation",
           "jitter_std", "videostab_truth_report",
           "SHAPE_CODEC", "CODEC_STAGES", "CODEC_PSNR_DB", "CODEC_PSNR_MARGIN_DB",
           "make_codec_frames", "forward_codec", "psnr",
           "SHAPE_VIDEOIO", "VIDEOIO_STAGES", "VIDEOIO_FPS", "make_videoio_files",
           "forward_videoio"]

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


@region("entry.forward")
def forward(imgs):
    return warp(preprocess(imgs))


@region("entry.forward_fused")
def forward_fused(imgs):
    return warp(preprocess_fused(imgs))


def entry(device="cuda", shape=SHAPE):
    """``(forward, (imgs,))`` with the batch on `device`."""
    return forward, (torch.from_numpy(make_batch(shape)).to(device),)


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """An int64 sum as the int32 sum XLA computes: modulo 2^32, signed."""
    return ((v + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


@region("entry.forward_resize_warp_4k")
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
    with trace_region("totals"):
        totals = torch.stack([
            _wrap_int32(r1.sum(dtype=torch.int64) + r2.sum(dtype=torch.int64)
                        + r3.sum(dtype=torch.int64)),
            _wrap_int32(wa.sum(dtype=torch.int64)), _wrap_int32(wp.sum(dtype=torch.int64))])
    return r1, r2, r3, wa, wp, totals


def entry_resize_warp_4k(device="cuda", shape=SHAPE_CFG2):
    """``(forward_resize_warp_4k, (x,))`` with ``bench.py``'s config-2 batch
    (``default_rng(0)`` integers) on `device`."""
    return forward_resize_warp_4k, (torch.from_numpy(make_batch(shape)).to(device),)


@region("entry.forward_pyr_corner_edge")
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


@region("entry.forward_match_morph")
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


@region("entry.forward_orb")
def forward_orb(x, orb):
    """BASELINE config 5 over an (N, H, W) u8 batch (``bench.py:478-491``):
    ``orb.detect_and_compute_batch(x)``, a list of (keypoints, descriptors)
    per image."""
    return orb.detect_and_compute_batch(x)


def entry_orb(device="cuda", shape=SHAPE_CFG5):
    """``(forward_orb, (x, orb))`` with ``bench.py``'s config-5 batch
    (``default_rng(0)`` integers) on `device` and ``ORB_create(nfeatures=500)``."""
    return forward_orb, (torch.from_numpy(make_batch(shape)).to(device), ORB_create(nfeatures=500))


@region("entry.forward_decode_color")
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


@region("entry.forward_enhance")
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


@region("entry.forward_motion")
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


@region("entry.forward_lines")
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


@region("entry.forward_segment")
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


@region("entry.forward_register")
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


@region("entry.forward_track")
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


# ------------------------------------------------------- video analytics

SHAPE_VIDEO = (8, 1080, 1920, 3)
# goodFeaturesToTrack's and Farnebäck's parameters: OpenCV's optical-flow
# tutorials (samples/python/tutorial_code/video/optical_flow/optical_flow.py
# with blockSize 7, and optical_flow_dense.py)
VIDEO_GFTT = dict(maxCorners=500, qualityLevel=0.01, minDistance=7, blockSize=7)
VIDEO_FARNEBACK = (None, 0.5, 3, 15, 3, 5, 1.2, 0)
# the reach of LK's coarsest window at cv2's defaults: half of 21 px at
# level 3, in level-0 px
VIDEO_LK_REACH = (21 // 2) * 2 ** 3
# the truth's margin at the frame's edge: the camera's largest shake, whose
# strip the alignment fills by replication
VIDEO_BORDER = MOTION_MAX_SHIFT


def _v_gray(st):
    st["gray"] = cvtColor(st["x"], K.COLOR_BGR2GRAY)


def _v_corners(st):
    """Frame 0's corners, (n, 1, 2) f32 host numpy (GFTT's tail reads its
    response map back)."""
    st["corners"] = goodFeaturesToTrack(st["gray"][0], **VIDEO_GFTT)


def _v_klt(st):
    """Each later frame's tracks of frame 0's corners: (N-1, n, 2) f32 and
    (N-1, n) u8 status, host numpy (each call reads its points back)."""
    g, p0 = st["gray"][..., 0], st["corners"]
    tracks, status = [], []
    for i in range(1, g.shape[0]):
        p1, s1, _ = calcOpticalFlowPyrLK(g[0], g[i], p0)
        tracks.append(p1[:, 0])
        status.append(s1[:, 0])
    st["tracks"] = np.stack(tracks)
    st["status"] = np.stack(status)


def _v_shake(st):
    """The median displacement of each frame's tracked points (status 1),
    (N-1, 2) f64 (x, y), and the frames moved back by it rounded to whole
    pixels."""
    p0 = st["corners"][:, 0].astype(np.float64)
    shifts = np.stack([np.median(t[s == 1] - p0[s == 1], axis=0)
                       for t, s in zip(st["tracks"].astype(np.float64), st["status"])])
    x = st["x"]
    H, W = x.shape[1], x.shape[2]
    frames = [x[:1]]
    for i, (sx, sy) in enumerate(np.rint(shifts), 1):
        M = np.array([[1.0, 0.0, -sx], [0.0, 1.0, -sy]])
        frames.append(warpAffine(x[i:i + 1], M, (W, H), K.INTER_NEAREST, K.BORDER_REPLICATE))
    st["shifts"], st["aligned"] = shifts, torch.cat(frames)


def _v_bg(st):
    mog = createBackgroundSubtractorMOG2()
    st["masks"] = torch.stack([mog.apply(f) for f in st["aligned"]])
    st["background"] = mog.getBackgroundImage()


def _v_dense(st):
    """Half-size frames (one pyrDown of the batch) and Farnebäck's flow of
    frame 0 to each later frame, (N-1, h, w, 2) f32."""
    half = pyrDown(st["gray"])[..., 0]
    st["half"] = half
    st["flow"] = torch.stack([calcOpticalFlowFarneback(half[0], half[i], *VIDEO_FARNEBACK)
                              for i in range(1, half.shape[0])])


# forward_video's stages in order: (name, fn of the state dict, the keys it
# writes); each reads only keys written before it
VIDEO_STAGES = (
    ("gray", _v_gray, ("gray",)),
    ("corners", _v_corners, ("corners",)),
    ("klt", _v_klt, ("tracks", "status")),
    ("shake", _v_shake, ("shifts", "aligned")),
    ("bg", _v_bg, ("masks", "background")),
    ("dense", _v_dense, ("half", "flow")),
)


@region("entry.forward_video")
def forward_video(x):
    """Video analytics over an (N, H, W, 3) u8 BGR video from a shaking
    camera, frame 0 the reference (:data:`VIDEO_STAGES`).

    Returns a dict: ``gray`` (N, H, W, 1) u8; ``corners`` (n, 1, 2) f32,
    ``tracks`` (N-1, n, 2) f32 and ``status`` (N-1, n) u8 (host numpy);
    ``shifts`` (N-1, 2) f64 (x, y) host numpy, the median track displacement
    of frames 1..; ``aligned`` (N, H, W, 3) u8; ``masks`` (N, H, W) u8 (0,
    127 shadow, 255) and ``background`` (H, W, 3) u8, MOG2's; ``half`` (N,
    H/2, W/2) u8 and ``flow`` (N-1, H/2, W/2, 2) f32, Farnebäck's flow of
    half-size frame 0 to each later one."""
    st = {"x": x}
    for _, stage, _ in VIDEO_STAGES:
        stage(st)
    del st["x"]
    return st


def entry_video(device="cuda", shape=SHAPE_VIDEO):
    """``(forward_video, (x,))`` with :func:`make_motion_video`'s frames on
    `device`."""
    video, _, _ = make_motion_video(shape)
    return forward_video, (torch.from_numpy(video).to(device),)


def _outside(px, py, boxes, margin: float = 0.0):
    """Whether points (px, py) lie outside every (x, y, w, h) box grown by
    `margin` on each side."""
    ok = np.ones(np.shape(px), bool)
    for bx, by, bw, bh in boxes:
        ok &= ~((px >= bx - margin) & (px < bx + bw + margin)
                & (py >= by - margin) & (py < by + bh + margin))
    return ok


def video_truth_report(out, shifts, boxes, shape, reach: int = VIDEO_LK_REACH) -> dict:
    """forward_video's outputs against the video's truth (``shifts`` (N, 2)
    and ``boxes`` (N, objects, 4) of :func:`make_motion_video`):

    - ``klt``: per frame i ≥ 1, (static tracked points, their share within
      0.5 px of shifts[i]): points of status 1 whose coarsest LK window
      clears every box of frames 0 and i (outside each box grown by `reach`
      px: a mover inside that window drags the coarse estimate); ``klt_all``
      the same with no growth;
    - ``shake``: per frame, the largest |median shift − shifts[i]| per axis;
    - ``dense``: per frame, the largest |median flow − shifts[i]/2| per axis
      over the half-size pixels outside every box of frames 0 and i and
      :data:`VIDEO_BORDER` px (at full size) from the edge, past the
      aligned frames' replicated strips;
    - ``bg``: per frame 4.., (the least and the mean share of foreground,
      127 or 255, in a box of that frame; the share of the foreground
      VIDEO_BORDER px from the edge that lies in a box of that frame; the
      share of foreground among the pixels outside every box of frames
      0..i and VIDEO_BORDER px from the edge)."""
    N, H, W = shape[:3]
    border = VIDEO_BORDER
    p0 = out["corners"][:, 0].astype(np.float64)
    klt, klt_all, shake, dense, bg = [], [], [], [], []
    for i in range(1, N):
        st = out["status"][i - 1] == 1
        err = np.hypot(*(out["tracks"][i - 1].astype(np.float64) - p0 - shifts[i]).T)
        for rows, grow in ((klt, reach), (klt_all, 0)):
            keep = st & _outside(p0[:, 0], p0[:, 1], np.concatenate([boxes[0], boxes[i]]), grow)
            rows.append((int(keep.sum()), float((err[keep] <= 0.5).mean()) if keep.any() else 0.0))
        shake.append(float(np.abs(out["shifts"][i - 1] - shifts[i]).max()))
    flow = out["flow"].cpu().numpy()
    h, w = flow.shape[1:3]
    ys, xs = np.mgrid[0:h, 0:w]
    # a half-size pixel covers full-size pixels 2y..2y+1
    edge = ((xs >= border // 2) & (xs < w - border // 2)
            & (ys >= border // 2) & (ys < h - border // 2))
    for i in range(1, N):
        keep = edge & _outside(2 * xs + 0.5, 2 * ys + 0.5,
                               np.concatenate([boxes[0], boxes[i]]), 1.0)
        med = np.median(flow[i - 1][keep], axis=0)
        dense.append(float(np.abs(med - shifts[i] / 2.0).max()))
    masks = out["masks"].cpu().numpy() > 0
    ys, xs = np.mgrid[0:H, 0:W]
    edge = (xs >= border) & (xs < W - border) & (ys >= border) & (ys < H - border)
    for i in range(4, N):
        inside = [masks[i, by:by + bh, bx:bx + bw].mean() for bx, by, bw, bh in boxes[i]]
        fg = masks[i] & edge
        in_box = fg & ~_outside(xs, ys, boxes[i])
        static = edge & _outside(xs, ys, boxes[:i + 1].reshape(-1, 4))
        bg.append((float(min(inside)), float(np.mean(inside)),
                   float(in_box.sum() / max(fg.sum(), 1)), float(masks[i][static].mean())))
    return {"klt": klt, "klt_all": klt_all, "shake": shake, "dense": dense, "bg": bg}


# ------------------------------------------------------- photo finishing

SHAPE_PHOTO = (3, 1080, 1920, 3)
PHOTO_TIMES = (0.25, 1.0, 4.0)   # the bracket's exposure times
# the planted shifts (x, y) of frames 0 and 2 at 1080p, scaled with the
# frame (at least 1 px); frame 1, AlignMTB's pivot, is not moved
PHOTO_SHIFTS = ((5, -3), (-4, 6))
PHOTO_NOISE = 3.0                # the sensor noise's sigma, grey levels
PHOTO_NLM = (3, 3, 7, 21)        # fastNlMeansDenoisingColored's h, hColor, template, search
PHOTO_DETAIL = dict(sigma_s=10, sigma_r=0.15)
PHOTO_FLATTEN = (30, 45, 3)      # textureFlattening's thresholds and aperture
PHOTO_INPAINT_RADIUS = 3


def _photo_shift(v: int, W: int) -> int:
    return int(np.sign(v)) * max(1, int(round(abs(v) * W / 1920)))


def _radiance(rng, H: int, W: int, m: int):
    """The scene's linear radiance, (H + 2m, W + 2m, 3) f64 BGR, about
    1:1000 from the shadowed block to the disc, with the face ellipse and
    the wire, in the canvas's coordinates: ``(radiance, face, wire)``."""
    Hc, Wc = H + 2 * m, W + 2 * m
    s = min(H / 1080, W / 1920)
    ys, xs = np.mgrid[0:Hc, 0:Wc].astype(np.float64)
    # the ground: smoothed noise stretched over 6..70, a texture at every
    # exposure's median for the bitmaps
    k = max(3, int(round(9 * s)) | 1)
    tex = _box_mean(rng.random((Hc + k - 1, Wc + k - 1)), k)
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    base = 6.0 + 64.0 * tex
    rad = np.stack([base * 0.8, base, base * 0.9], axis=-1)
    # the sky: a gradient over the top third, blue-white, 90..200
    sky = ys < 0.3 * Hc
    t = np.clip(ys / (0.3 * Hc), 0, 1)
    rad[sky] = np.stack([200 - 60 * t, 170 - 50 * t, 120 - 30 * t], axis=-1)[sky]
    # the bright disc in the sky
    cx, cy, r = 0.8 * Wc, 0.12 * Hc, 0.06 * Hc
    rad[(xs - cx) ** 2 + (ys - cy) ** 2 <= r * r] = (900.0, 950.0, 1000.0)
    # the dark shadowed block, textured at 0.3..3
    sh = (xs > 0.05 * Wc) & (xs < 0.3 * Wc) & (ys > 0.55 * Hc) & (ys < 0.9 * Hc)
    rad[sh] = (0.3 + 2.7 * tex[sh])[:, None] * np.array([0.9, 1.0, 1.1])
    # textured rectangles: checkers of 2..10 % of the height, 15..90
    for _ in range(6):
        x0, y0 = rng.uniform(0.35, 0.95) * Wc, rng.uniform(0.35, 0.9) * Hc
        w, h = rng.uniform(0.05, 0.12) * Wc, rng.uniform(0.05, 0.12) * Hc
        cell = max(2.0, rng.uniform(0.02, 0.1) * Hc)
        inside = (xs >= x0) & (xs < x0 + w) & (ys >= y0) & (ys < y0 + h)
        chk = ((np.floor((xs - x0) / cell) + np.floor((ys - y0) / cell)) % 2)[inside]
        rad[inside] = (15.0 + 75.0 * chk)[:, None] * rng.uniform(0.7, 1.0, 3)
    # the face: an ellipse of skin with fine texture (1-2 px grain, ±25 %)
    fx, fy, ra, rb = 0.22 * Wc, 0.5 * Hc, 0.09 * Wc, 0.16 * Hc
    face = ((xs - fx) / ra) ** 2 + ((ys - fy) / rb) ** 2 <= 1.0
    grain = _box_mean(rng.random((Hc + 1, Wc + 1)), 2)
    skin = 1.0 + 0.5 * (grain - 0.5) / 0.5
    rad[face] = skin[face][:, None] * np.array([40.0, 55.0, 80.0])
    # the wire: 2-3 px wide, dark, crossing the frame on a slight slope,
    # clear of the face
    y_wire = 0.22 * Hc + 0.08 * Hc * (xs - 0.35 * Wc) / Wc
    half = max(1.0, 1.25 * s)
    wire = (np.abs(ys - y_wire) <= half) & (xs >= 0.35 * Wc)
    rad[wire] = 0.5
    return rad, face, wire


def make_bracket(shape=SHAPE_PHOTO, seed: int = 0):
    """An exposure bracket of one scene, all from one ``default_rng(seed)``:
    ``(bracket, twin, shifts, face, wire)``.

    - the scene's radiance spans about 1:1000: a sky gradient (90–200), a
      bright disc (about 1,000), a dark shadowed block (0.3–3), a textured
      ground (6–70) and checkered rectangles (15–90), an ellipse of
      skin-like fine texture and a dark wire 2–3 px wide across the frame;
    - frame i is the radiance times :data:`PHOTO_TIMES`[i], plus Gaussian
      sensor noise of sigma :data:`PHOTO_NOISE`, rounded and clipped to u8;
      ``twin`` is the same without the noise;
    - frames 0 and 2 are the scene moved by the planted ``shifts`` (3, 2)
      int64 (x, y), :data:`PHOTO_SHIFTS` scaled with the frame (frame 1,
      the pivot, at (0, 0)): frame i(x, y) = frame 1(x - dx, y - dy);
    - ``face`` and ``wire`` (H, W) u8 0/255 are in frame 1's coordinates:
      the ellipse, and the wire grown by 1 px.

    Returns (N, H, W, 3) u8 BGR frames (N = 3)."""
    N, H, W, _ = shape
    rng = np.random.default_rng(seed)
    shifts = np.zeros((N, 2), np.int64)
    shifts[0] = [_photo_shift(v, W) for v in PHOTO_SHIFTS[0]]
    shifts[N - 1] = [_photo_shift(v, W) for v in PHOTO_SHIFTS[1]]
    m = int(np.abs(shifts).max())
    rad, face, wire = _radiance(rng, H, W, m)
    bracket = np.empty(shape, np.uint8)
    twin = np.empty(shape, np.uint8)
    for i, ((dx, dy), t) in enumerate(zip(shifts, PHOTO_TIMES)):
        crop = rad[m - dy:m - dy + H, m - dx:m - dx + W] * t
        twin[i] = np.clip(np.rint(crop), 0, 255)
        noisy = crop + rng.normal(0.0, PHOTO_NOISE, crop.shape)
        bracket[i] = np.clip(np.rint(noisy), 0, 255)
    face = face[m:m + H, m:m + W]
    wire = wire[m:m + H, m:m + W]
    grown = np.zeros_like(wire)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            grown |= np.roll(np.roll(wire, dy, 0), dx, 1)
    return (bracket, twin, shifts, face.astype(np.uint8) * 255,
            grown.astype(np.uint8) * 255)


def _p_align(st):
    """AlignMTB of the bracket (cut on): the aligned frames, the shifts
    (x, y) it found per frame, and the masks cut by the same window."""
    mtb = createAlignMTB()
    x = st["x"]
    frames, shifts = mtb._align([x[i] for i in range(x.shape[0])])
    x0, y0, x1, y1 = mtb._window(shifts, x.shape[1], x.shape[2])
    st["aligned"] = torch.stack(frames)
    st["shifts"] = np.array(shifts, np.int64)
    st["face"] = st["face_in"][y0:y1, x0:x1]
    st["wire"] = st["wire_in"][y0:y1, x0:x1]


def fuse(aligned):
    """MergeMertens of the aligned frames, as u8 (saturate_cast(x · 255))."""
    res = createMergeMertens().process([f for f in aligned])
    return saturate_cast(res * 255.0, torch.uint8)


def _p_fuse(st):
    st["fused"] = fuse(st["aligned"])


def _p_denoise(st):
    st["denoised"] = fastNlMeansDenoisingColored(st["fused"], *PHOTO_NLM)


def _p_detail(st):
    st["detailed"] = detailEnhance(st["denoised"], **PHOTO_DETAIL)


def _p_flatten(st):
    """textureFlattening of the face: the port's Canny (two ``sep_filter``
    k3 launches, C = 3) and a Poisson solve over the whole frame."""
    st["flattened"] = textureFlattening(st["detailed"], st["face"], *PHOTO_FLATTEN)


def _p_inpaint(st):
    st["inpainted"] = inpaint(st["flattened"], st["wire"], PHOTO_INPAINT_RADIUS,
                              INPAINT_TELEA)


# forward_photo's stages in order: (name, fn of the state dict, the keys it
# writes); each reads only keys written before it
PHOTO_STAGES = (
    ("align", _p_align, ("aligned", "shifts", "face", "wire")),
    ("fuse", _p_fuse, ("fused",)),
    ("denoise", _p_denoise, ("denoised",)),
    ("detail", _p_detail, ("detailed",)),
    ("flatten", _p_flatten, ("flattened",)),
    ("inpaint", _p_inpaint, ("inpainted",)),
)


def photo_state(x, face, wire) -> dict:
    """The state dict the photo stages start from."""
    return {"x": x, "face_in": face, "wire_in": wire}


@region("entry.forward_photo")
def forward_photo(x, face, wire):
    """HDR finishing of one exposure bracket (:data:`PHOTO_STAGES`): x (3,
    H, W, 3) u8 BGR, the masks (H, W) u8 in frame 1's coordinates.

    Returns a dict: ``shifts`` (3, 2) int64 (x, y) host numpy, AlignMTB's;
    ``aligned`` (3, h, w, 3) u8, the frames cut to the window they share;
    ``face`` and ``wire`` (h, w) u8, the masks cut alike; ``fused``,
    ``denoised``, ``detailed``, ``flattened`` and ``inpainted`` (h, w, 3)
    u8, each stage's image."""
    st = photo_state(x, face, wire)
    for _, stage, _ in PHOTO_STAGES:
        stage(st)
    for k in ("x", "face_in", "wire_in"):
        del st[k]
    return st


def entry_photo(device="cuda", shape=SHAPE_PHOTO):
    """``(forward_photo, (x, face, wire))`` with :func:`make_bracket`'s
    bracket and masks on `device`."""
    bracket, _, _, face, wire = make_bracket(shape)
    return forward_photo, tuple(torch.from_numpy(a).to(device) for a in (bracket, face, wire))


def _psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = float(((a.to(torch.float64) - b.to(torch.float64)) ** 2).mean())
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def _grow(mask: np.ndarray, r: int) -> np.ndarray:
    """A bool mask grown by r px (a (2r+1)² square)."""
    p = np.pad(mask, r)
    h, w = mask.shape
    out = np.zeros_like(mask)
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            out |= p[dy:dy + h, dx:dx + w]
    return out


def _sobel_mag(img: torch.Tensor) -> np.ndarray:
    """|Sobel dx| + |Sobel dy| of the gray image, f64 host numpy."""
    g = cvtColor(img, K.COLOR_BGR2GRAY).to(torch.float32)
    gx = Sobel(g, K.CV_32F, 1, 0)
    gy = Sobel(g, K.CV_32F, 0, 1)
    return (gx.abs() + gy.abs()).cpu().numpy().astype(np.float64)


def photo_truth_report(out, bracket_info) -> dict:
    """forward_photo's outputs against :func:`make_bracket`'s truth
    (``bracket_info`` is its tuple):

    - ``align``: AlignMTB's shifts (3, 2) and the ones that undo the
      planted shifts (minus them), and whether they are equal;
    - ``denoise``: the PSNR of ``denoised`` and of ``fused`` against the
      noise-free twin's fusion (the twin shifted and cut as the bracket,
      then ``fuse``), and the gain, in dB;
    - ``flatten``: the mean |Sobel| of the gray image inside the face mask
      eroded by 5 px after ``flatten`` over the same before it, and the
      share of pixels outside the mask grown by 5 px that ``flatten`` moved
      by at most 1;
    - ``inpaint``: the mean gray level under the wire after ``inpaint``
      over that of the 3-px ring around it (and the same before it)."""
    _, twin, planted, _, _ = bracket_info
    want = -planted
    rep = {"align": (out["shifts"], want, bool(np.array_equal(out["shifts"], want)))}
    dev = out["fused"].device
    h, w = out["fused"].shape[:2]
    x0, y0, _, _ = AlignMTB._window([tuple(s) for s in out["shifts"]], twin.shape[1],
                                    twin.shape[2])
    tw = [AlignMTB.shiftMat(torch.from_numpy(twin[i]).to(dev), out["shifts"][i])
          [y0:y0 + h, x0:x0 + w] for i in range(twin.shape[0])]
    clean = fuse(torch.stack(tw))
    p_den, p_fus = _psnr(out["denoised"], clean), _psnr(out["fused"], clean)
    rep["denoise"] = (p_den, p_fus, p_den - p_fus)
    face = out["face"].cpu().numpy() > 0
    inner = ~_grow(~face, 5)
    outer = ~_grow(face, 5)
    before, after = _sobel_mag(out["detailed"]), _sobel_mag(out["flattened"])
    moved = np.abs(out["flattened"].cpu().numpy().astype(np.int32)
                   - out["detailed"].cpu().numpy().astype(np.int32)).max(axis=-1)
    rep["flatten"] = (float(after[inner].mean() / before[inner].mean()),
                      float((moved[outer] <= 1).mean()))
    wire = out["wire"].cpu().numpy() > 0
    ring = _grow(wire, 3) & ~wire
    ratios = []
    for key in ("inpainted", "flattened"):
        g = cvtColor(out[key], K.COLOR_BGR2GRAY).cpu().numpy().astype(np.float64)
        ratios.append(float(g[wire].mean() / g[ring].mean()))
    rep["inpaint"] = tuple(ratios)
    return rep


# ------------------------------------------------------------ stereo depth

SHAPE_STEREO = (12, 1080, 1920, 3)   # calibration pairs, and each frame's size
STEREO_BOARD = (9, 6)                # inner corners per row and column
STEREO_SQUARE_MM = 25.0
STEREO_BASELINE_MM = 120.0
# StereoSGBM at half size and StereoBM at full size, as OpenCV's
# samples/cpp/stereo_match.cpp sets them (cn = 1, SGBM's window 3)
STEREO_SGBM = dict(minDisparity=0, numDisparities=128, blockSize=3, P1=8 * 3 * 3,
                   P2=32 * 3 * 3, disp12MaxDiff=1, preFilterCap=63, uniquenessRatio=10,
                   speckleWindowSize=100, speckleRange=32, mode=0)
STEREO_BM = dict(numDisparities=240, blockSize=9, preFilterCap=31, textureThreshold=10,
                 uniquenessRatio=15, speckleWindowSize=100, speckleRange=32,
                 disp12MaxDiff=1)
# the scene's fronto-parallel planes in the true rectified camera-1 frame
# (mm): depth Z and the rectangle X0, X1, Y0, Y1, nearest first
STEREO_PLANES = ((1500.0, -900.0, -200.0, -150.0, 500.0),
                 (2200.0, 0.0, 700.0, -700.0, -100.0),
                 (3000.0, 300.0, 1600.0, 100.0, 900.0),
                 (4200.0, -2400.0, -900.0, -1500.0, -300.0),
                 (6000.0, -1e5, 1e5, -1e5, 1e5))
STEREO_NOISE = 1.0                   # each camera's sensor noise, grey levels
# the fewest pairs calibrate_rig calibrates from (Zhang's method needs 3
# views of the plane)
STEREO_MIN_PAIRS = 3
# the undistortion's fixed-point steps when rendering (at 1080p its residual
# is under 1e-11 px)
STEREO_UNDISTORT_ITERS = 12


def _rig_truth(W: int, H: int) -> dict:
    """The rig scaled to a (W, H) frame: K, distortion (k1, k2, p1, p2, k3)
    per camera and camera 2's pose R, T (X2 = R X1 + T, mm): fx about 1,400
    px at 1080p, a 120 mm baseline, 0.4° of roll, 0.6° of yaw and 0.1° of
    pitch."""
    s = W / 1920.0
    K1 = np.array([[1400.0 * s, 0, 0.5 * (W - 1) + 6.0 * s],
                   [0, 1398.0 * s, 0.5 * (H - 1) - 4.0 * s], [0, 0, 1.0]])
    K2 = np.array([[1405.0 * s, 0, 0.5 * (W - 1) - 5.0 * s],
                   [0, 1403.5 * s, 0.5 * (H - 1) + 3.0 * s], [0, 0, 1.0]])
    d1 = np.array([-0.12, 0.06, 0.0008, -0.0005, -0.01])
    d2 = np.array([-0.10, 0.05, -0.0006, 0.0004, -0.008])
    R, _ = Rodrigues(np.deg2rad([0.1, 0.6, 0.4]))
    T = np.array([-STEREO_BASELINE_MM, 0.6, 1.2])
    T *= STEREO_BASELINE_MM / np.linalg.norm(T)
    return dict(K1=K1, d1=d1, K2=K2, d2=d2, R=R, T=T)


def _pixel_rays(K, dist, W: int, H: int) -> np.ndarray:
    """The undistorted normalized (x, y) of every pixel of a (W, H) frame
    under the distortion `dist`, (H, W, 2) f64: the fixed point of
    cv::undistortPoints' iteration, run to convergence."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    k1, k2, p1, p2, k3 = dist
    u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    x0, y0 = (u - cx) / fx, (v - cy) / fy
    x, y = x0.copy(), y0.copy()
    for _ in range(STEREO_UNDISTORT_ITERS):
        r2 = x * x + y * y
        radial = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x, y = (x0 - dx) / radial, (y0 - dy) / radial
    return np.stack([x, y], axis=-1)


def _bilinear(grid: np.ndarray, gx: np.ndarray, gy: np.ndarray) -> np.ndarray:
    """`grid` sampled at the continuous (gx, gy), clamped at its border."""
    gh, gw = grid.shape
    gx = np.clip(gx, 0, gw - 1.000001)
    gy = np.clip(gy, 0, gh - 1.000001)
    x0, y0 = np.floor(gx).astype(np.int64), np.floor(gy).astype(np.int64)
    fx, fy = gx - x0, gy - y0
    return ((grid[y0, x0] * (1 - fx) + grid[y0, x0 + 1] * fx) * (1 - fy)
            + (grid[y0 + 1, x0] * (1 - fx) + grid[y0 + 1, x0 + 1] * fx) * fy)


def _board_view(rays, origin, rot, Rb, tb, bg) -> np.ndarray:
    """One camera's gray view of the board: rays (H, W, 3) and the centre
    `origin` in camera 1's frame (rot turns a camera ray into that frame),
    the board's pose (Rb, tb: board to camera 1) and the background (H, W);
    the squares anti-aliased by their footprint, (H, W) f64."""
    d = rays @ (rot.T @ Rb)                        # the rays in board axes
    o = (origin - tb) @ Rb
    t = -o[2] / d[..., 2]
    sq = STEREO_SQUARE_MM
    cols, rows = STEREO_BOARD
    bx = o[0] + t * d[..., 0]
    by = o[1] + t * d[..., 1]
    paper = ((bx > -2 * sq) & (bx < (cols + 1) * sq) & (by > -2 * sq)
             & (by < (rows + 1) * sq) & (t > 0))
    val = np.array(bg, np.float64)
    ys, xs = np.nonzero(paper.any(axis=1))[0], np.nonzero(paper.any(axis=0))[0]
    if not len(ys):
        return val
    win = (slice(ys[0], ys[-1] + 1), slice(xs[0], xs[-1] + 1))
    # each axis' square wave over the paper's box, softened over a pixel's
    # footprint
    s = []
    for b in (bx[win], by[win]):
        q = (b + sq) / sq
        gy, gx = np.gradient(b)
        foot = np.maximum(np.abs(gx) + np.abs(gy), 1e-6)
        frac = q - np.floor(q)
        edge = sq * np.minimum(frac, 1 - frac)
        sign = np.where(np.floor(q) % 2 == 0, 1.0, -1.0)
        s.append(sign * np.minimum(1.0, 2 * edge / foot))
    inside = ((bx[win] >= -sq) & (bx[win] < cols * sq)
              & (by[win] >= -sq) & (by[win] < rows * sq))
    square = np.where(inside, 225.0 - 195.0 * 0.5 * (1 + s[0] * s[1]), 225.0)
    val[win] = np.where(paper[win], square, val[win])
    return val


def _board_poses(rng, rig, W: int, H: int, n: int):
    """n board poses (Rb, tb) whose paper lies inside both frames with a
    margin, at 0.5-0.85 m, tilted up to 15° about each axis and turned up
    to 10° in its plane, spread over the frame (the detector fits each
    square's minimum-area rectangle, which steeper tilts skew)."""
    sq = STEREO_SQUARE_MM
    cols, rows = STEREO_BOARD
    paper = np.array([[x, y, 0.0] for x in (-2 * sq, (cols + 1) * sq)
                      for y in (-2 * sq, (rows + 1) * sq)])
    centre = np.array([(cols - 1) * sq / 2, (rows - 1) * sq / 2, 0.0])
    rv2, _ = Rodrigues(rig["R"])
    poses = []
    margin = 40 * W / 1920
    while len(poses) < n:
        z = rng.uniform(500.0, 850.0)
        ang = np.deg2rad([rng.uniform(-15, 15), rng.uniform(-15, 15), rng.uniform(-10, 10)])
        Rb, _ = Rodrigues(ang)
        # the board's centre somewhere in the frame's middle 70 %
        u = rng.uniform(0.15, 0.85) * W
        v = rng.uniform(0.15, 0.85) * H
        K1 = rig["K1"]
        c = np.array([(u - K1[0, 2]) / K1[0, 0] * z, (v - K1[1, 2]) / K1[1, 1] * z, z])
        tb = c - Rb @ centre
        ok = True
        for (K, d, rv, tv) in ((rig["K1"], rig["d1"], np.zeros(3), np.zeros(3)),
                               (rig["K2"], rig["d2"], rv2.ravel(), rig["T"])):
            Rc, _ = Rodrigues(rv)
            pts = (paper @ Rb.T + tb) @ Rc.T + tv
            if (pts[:, 2] <= 0).any():
                ok = False
                break
            proj, _ = projectPoints(paper @ Rb.T + tb, rv, tv, K, d)
            p = proj.reshape(-1, 2)
            if (p[:, 0] < margin).any() or (p[:, 0] > W - 1 - margin).any() \
                    or (p[:, 1] < margin).any() or (p[:, 1] > H - 1 - margin).any():
                ok = False
                break
        if ok:
            poses.append((Rb, tb))
    return poses


def _scene_view(grids, rays, origin, rot, texture: bool = True) -> tuple:
    """One camera's view of the plane scene: its rays (H, W, 3) turned by
    `rot` into the true rectified camera-1 frame, from `origin` there (on
    its z = 0 plane, as both centres are); the nearest plane each ray
    meets, the planes being fronto-parallel and in depth order: ``(gray
    (H, W) f64 or None, depth Z (H, W))``."""
    d = rays @ rot.T
    zhit = np.zeros(d.shape[:2])
    val = np.zeros(d.shape[:2]) if texture else None
    for (Z, X0, X1, Y0, Y1), (fine, coarse, cell, lo, hi) in zip(STEREO_PLANES, grids):
        t = (Z - origin[2]) / d[..., 2]
        X = origin[0] + t * d[..., 0]
        Y = origin[1] + t * d[..., 1]
        hit = (zhit == 0) & (t > 0) & (X >= X0) & (X < X1) & (Y >= Y0) & (Y < Y1)
        zhit[hit] = Z
        if texture:
            gx = (X[hit] - max(X0, -1e4)) / cell
            gy = (Y[hit] - max(Y0, -1e4)) / cell
            tex = 0.65 * _bilinear(fine, gx, gy) + 0.35 * _bilinear(coarse, gx / 3, gy / 3)
            val[hit] = lo + (hi - lo) * tex
    return val, zhit


def make_stereo_rig(shape=SHAPE_STEREO, seed: int = 0) -> dict:
    """A calibrated stereo rig's data, rendered on the host from one
    ``default_rng(seed)``: a dict of

    - ``views``: (N, 2, H, W, 3) u8 BGR, N pairs of a 9×6 inner-corner
      chessboard with 25 mm squares (OpenCV's samples/cpp/stereo_calib.cpp's
      board) at varied poses, each seen by camera 1 then camera 2 through
      its lens distortion;
    - ``scene``: (2, H, W, 3) u8 BGR, one pair of a scene of textured
      fronto-parallel planes at 1.5-6 m (:data:`STEREO_PLANES`);
    - ``object_points``: (54, 3) f32, the board's inner corners in mm, row
      by row;
    - ``rig``: the truth, :func:`_rig_truth`'s K1, d1, K2, d2, R, T, and
      its ``stereoRectify`` (alpha 0): R1, R2, P1, P2, Q;
    - ``disparity``: (H, W) f64, the scene's disparity at each pixel of
      camera 1's image rectified by the true rig; ``both``: (H, W) bool,
      where camera 2 sees the same point; ``disparity_half`` and
      ``both_half``, the same at half size (the 2×2 block's mean over 2).

    Each camera adds Gaussian noise of sigma :data:`STEREO_NOISE`."""
    N, H, W, _ = shape
    rng = np.random.default_rng(seed)
    rig = _rig_truth(W, H)
    R1, R2, P1, P2, Q, _, _ = stereoRectify(rig["K1"], rig["d1"], rig["K2"], rig["d2"], (W, H),
                                            rig["R"], rig["T"].reshape(3, 1), alpha=0)
    rig.update(R1=R1, R2=R2, P1=P1, P2=P2, Q=Q)
    rays = []
    for K, d in ((rig["K1"], rig["d1"]), (rig["K2"], rig["d2"])):
        xy = _pixel_rays(K, d, W, H)
        rays.append(np.concatenate([xy, np.ones(xy.shape[:2] + (1,))], axis=-1))
    c2 = -rig["R"].T @ rig["T"]                    # camera 2's centre, camera-1 frame
    # the calibration views: a smooth grey background, the board on it
    bg = 100.0 + 60.0 * _bilinear(rng.random((8, 12)),
                                  *np.meshgrid(np.linspace(0, 11, W), np.linspace(0, 7, H)))
    views = np.empty((N, 2, H, W, 3), np.uint8)
    for i, (Rb, tb) in enumerate(_board_poses(rng, rig, W, H, N)):
        for c, (origin, rot) in enumerate(((np.zeros(3), np.eye(3)), (c2, rig["R"].T))):
            g = _board_view(rays[c], origin, rot, Rb, tb, bg)
            g = g + rng.normal(0.0, STEREO_NOISE, g.shape)
            views[i, c] = np.clip(np.rint(g), 0, 255).astype(np.uint8)[..., None]
    # the scene: each plane's texture two octaves of value noise, its finer
    # cell about 3 px at its depth
    f = P1[0, 0]
    grids = []
    for Z, X0, X1, Y0, Y1 in STEREO_PLANES:
        cell = 3.0 * Z / f
        ext_x = min(X1, 1e4) - max(X0, -1e4)
        ext_y = min(Y1, 1e4) - max(Y0, -1e4)
        fine = rng.random((int(ext_y / cell) + 2, int(ext_x / cell) + 2))
        coarse = rng.random((int(ext_y / cell / 3) + 2, int(ext_x / cell / 3) + 2))
        lo = rng.uniform(20, 70)
        grids.append((fine, coarse, cell, lo, lo + rng.uniform(140, 180)))
    tint = (0.9, 1.0, 1.08)
    scene = np.empty((2, H, W, 3), np.uint8)
    for c, (origin, rot) in enumerate(((np.zeros(3), R1), (R1 @ c2, R1 @ rig["R"].T))):
        g, _ = _scene_view(grids, rays[c], origin, rot)
        for ch in range(3):
            gc = g * tint[ch] + rng.normal(0.0, STEREO_NOISE, g.shape)
            scene[c, ..., ch] = np.clip(np.rint(gc), 0, 255)
    # the truth at camera 1's rectified pixels: the first plane each
    # rectified ray meets, and whether camera 2 sees that point first
    fx, cx, cy = P1[0, 0], P1[0, 2], P1[1, 2]
    u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    rect_rays = np.stack([(u - cx) / fx, (v - cy) / P1[1, 1], np.ones_like(u)], axis=-1)
    _, z1 = _scene_view(grids, rect_rays, np.zeros(3), np.eye(3), texture=False)
    baseline = -P2[0, 3] / P2[0, 0]
    disp = fx * baseline / z1
    pts = rect_rays * z1[..., None]
    o2 = R1 @ c2
    to2 = pts - o2
    _, z2 = _scene_view(grids, to2 / to2[..., 2:3], o2, np.eye(3), texture=False)
    both = np.abs(z2 - z1) < 1e-6
    Hh, Wh = H // 2, W // 2
    dh = disp[:2 * Hh, :2 * Wh].reshape(Hh, 2, Wh, 2).mean(axis=(1, 3)) / 2
    bh = both[:2 * Hh, :2 * Wh].reshape(Hh, 2, Wh, 2).all(axis=(1, 3))
    sq = STEREO_SQUARE_MM
    cols, rows = STEREO_BOARD
    obj = np.array([[x * sq, y * sq, 0.0] for y in range(rows) for x in range(cols)], np.float32)
    return dict(views=views, scene=scene, object_points=obj, rig=rig, disparity=disp,
                both=both, disparity_half=dh, both_half=bh)


def calibrate_rig(views, object_points) -> dict:
    """Calibrate the rig from N chessboard pairs, as OpenCV's
    samples/cpp/stereo_calib.cpp does: findChessboardCorners (adaptive
    threshold, normalized) and cornerSubPix (11×11, 30 iterations, 0.01)
    on every view, calibrateCamera per camera, stereoCalibrate with the
    intrinsics fixed, stereoRectify (alpha 0) and initUndistortRectifyMap
    of each camera.  `views` (N, 2, H, W, 3) u8 on any device; the corners
    come back to the host, so the solvers run there, and the maps are built
    on the views' device.

    A pair counts only where the board is found in both views, as in the
    sample, and where both grids pass the detector's regularity check
    (``chessboard._sb_grid_regular``: no row or column bends by more than
    0.35 of the median spacing); fewer than :data:`STEREO_MIN_PAIRS` such
    pairs raise.

    Returns a dict: ``pairs``, the indices of the pairs used; ``corners``
    (n, 2, 54, 1, 2) f32 host, theirs; ``rms1``,
    ``rms2`` (each camera's reprojection RMS, px), ``rms`` (the stereo
    one); K1, d1, K2, d2, R, T, E, F; R1, R2, P1, P2, Q, roi1, roi2; and
    ``maps``, the four (H, W) f32 maps (camera 1's x and y, camera 2's)
    on the device."""
    v = torch.as_tensor(views)
    N, _, H, W, _ = v.shape
    n_pts = STEREO_BOARD[0] * STEREO_BOARD[1]
    corners, used = [], []
    for i in range(N):
        found = []
        for c in range(2):
            gray = cvtColor(v[i, c], K.COLOR_BGR2GRAY)
            ok, pts = findChessboardCorners(gray, STEREO_BOARD, flags=CALIB_CB_ADAPTIVE_THRESH
                                            | CALIB_CB_NORMALIZE_IMAGE)
            if not ok:
                break
            pts = cornerSubPix(gray, pts, (11, 11), (-1, -1), (3, 30, 0.01))
            # the detector can return a grid with a stray point in it: keep
            # only a grid whose rows and columns run evenly
            if not _sb_grid_regular(pts.reshape(STEREO_BOARD[1], STEREO_BOARD[0], 2)):
                break
            found.append(pts)
        # the sample keeps a pair only if both views show the whole board
        if len(found) == 2:
            corners.append(found)
            used.append(i)
    if len(used) < STEREO_MIN_PAIRS:
        raise RuntimeError(f"calibrate_rig: the {STEREO_BOARD} board was found in both views of "
                           f"{len(used)} of {N} pairs, fewer than {STEREO_MIN_PAIRS}")
    corners = np.asarray(corners, np.float32).reshape(len(used), 2, n_pts, 1, 2)
    objs = [np.asarray(object_points, np.float32)] * len(used)
    size = (W, H)
    rms1, K1, d1, _, _ = calibrateCamera(objs, list(corners[:, 0]), size)
    rms2, K2, d2, _, _ = calibrateCamera(objs, list(corners[:, 1]), size)
    rms, _, _, _, _, R, T, E, F = stereoCalibrate(objs, list(corners[:, 0]), list(corners[:, 1]),
                                                  K1, d1, K2, d2, size)
    R1, R2, P1, P2, Q, roi1, roi2 = stereoRectify(K1, d1, K2, d2, size, R, T, alpha=0)
    maps = (*initUndistortRectifyMap(K1, d1, R1, P1, size, K.CV_32FC1, device=v.device),
            *initUndistortRectifyMap(K2, d2, R2, P2, size, K.CV_32FC1, device=v.device))
    return dict(corners=corners, pairs=used, rms1=rms1, rms2=rms2, rms=rms, K1=K1, d1=d1, K2=K2, d2=d2,
                R=R, T=T, E=E, F=F, R1=R1, R2=R2, P1=P1, P2=P2, Q=Q, roi1=roi1, roi2=roi2,
                maps=maps)


def stereo_sgbm() -> StereoSGBM:
    return StereoSGBM_create(**STEREO_SGBM)


def stereo_bm() -> StereoBM:
    """StereoBM with :data:`STEREO_BM`'s settings but its speckle pass,
    which the path runs as a stage of its own."""
    bm = StereoBM_create(STEREO_BM["numDisparities"], STEREO_BM["blockSize"])
    bm.setPreFilterCap(STEREO_BM["preFilterCap"])
    bm.setTextureThreshold(STEREO_BM["textureThreshold"])
    bm.setUniquenessRatio(STEREO_BM["uniquenessRatio"])
    bm.setDisp12MaxDiff(STEREO_BM["disp12MaxDiff"])
    return bm


def _s_rectify(st):
    m1x, m1y, m2x, m2y = st["rig"]["maps"]
    x = st["x"]
    st["rectified"] = torch.stack([remap(x[0], m1x, m1y, K.INTER_LINEAR),
                                   remap(x[1], m2x, m2y, K.INTER_LINEAR)])


def _s_half(st):
    """The rectified pair through ``fusedPreprocessGrayBlurDown2``: the one
    ``gauss5_down2`` launch, (2, H, W, 3) → (2, H/2, W/2)."""
    st["half"] = fused_gray_gauss5_down2(st["rectified"])


def _s_sgbm(st):
    h = st["half"]
    st["sgbm"] = stereo_sgbm().compute(h[0], h[1])


def _s_bm(st):
    g = cvtColor(st["rectified"], K.COLOR_BGR2GRAY)[..., 0]
    st["gray"] = g
    st["bm"] = stereo_bm().compute(g[0], g[1])


def _s_speckles(st):
    st["bm_filtered"] = filterSpeckles(st["bm"], -16, STEREO_BM["speckleWindowSize"],
                                       STEREO_BM["speckleRange"])


def _s_depth(st):
    st["xyz"] = reprojectImageTo3D(st["bm_filtered"].to(torch.float32) / 16.0, st["rig"]["Q"],
                                   handleMissingValues=True)


# forward_stereo's stages in order: (name, fn of the state dict, the keys
# it writes); each reads only keys written before it
STEREO_STAGES = (
    ("rectify", _s_rectify, ("rectified",)),
    ("half", _s_half, ("half",)),
    ("sgbm", _s_sgbm, ("sgbm",)),
    ("bm", _s_bm, ("gray", "bm")),
    ("speckles", _s_speckles, ("bm_filtered",)),
    ("depth", _s_depth, ("xyz",)),
)


def stereo_state(pair, rig) -> dict:
    """The state dict the stereo stages start from."""
    return {"x": pair, "rig": rig}


@region("entry.forward_stereo")
def forward_stereo(pair, rig) -> dict:
    """Depth from one stereo pair (:data:`STEREO_STAGES`): ``pair`` (2, H, W,
    3) u8 BGR, camera 1 then camera 2; ``rig`` :func:`calibrate_rig`'s.

    Returns a dict: ``rectified`` (2, H, W, 3) u8; ``half`` (2, H/2, W/2) u8;
    ``sgbm`` (H/2, W/2) int16, StereoSGBM's disparity × 16 at half size
    (median and speckle passes included); ``gray`` (2, H, W) u8; ``bm`` and
    ``bm_filtered`` (H, W) int16, StereoBM's at full size before and after
    filterSpeckles; ``xyz`` (H, W, 3) f32, reprojectImageTo3D of the
    filtered BM disparity over 16 (mm; 10,000 where it is invalid)."""
    st = stereo_state(pair, rig)
    for _, stage, _ in STEREO_STAGES:
        stage(st)
    del st["x"], st["rig"]
    return st


def entry_stereo(device="cuda", shape=SHAPE_STEREO):
    """``(forward_stereo, (pair, rig))``: :func:`make_stereo_rig`'s views
    calibrated by :func:`calibrate_rig` on `device`, and its scene pair
    there."""
    data = make_stereo_rig(shape)
    rig = calibrate_rig(torch.from_numpy(data["views"]).to(device), data["object_points"])
    return forward_stereo, (torch.from_numpy(data["scene"]).to(device), rig)


def _window_all(mask: np.ndarray, r: int) -> np.ndarray:
    """Where `mask` holds over the whole (2r+1)² window (False near the
    border)."""
    from numpy.lib.stride_tricks import sliding_window_view as win
    out = np.zeros_like(mask)
    k = 2 * r + 1
    rows = win(mask, k, axis=1).all(axis=-1)
    out[r:-r, r:-r] = win(rows, k, axis=0).all(axis=-1)
    return out


def stereo_interior(disp: np.ndarray, both: np.ndarray, r: int, first_col: int) -> np.ndarray:
    """The pixels between the planes' edges: where the truth's disparity is
    one value and camera 2 sees the same point over the (2r+1)² window,
    at or right of column `first_col` (the matcher's first)."""
    same = np.ones_like(both)
    same[:, 1:] = disp[:, 1:] == disp[:, :-1]
    same[1:] &= disp[1:] == disp[:-1]
    inner = _window_all(same & both, r)
    inner[:, :first_col] = False
    return inner


# the path's truth gates (stereo_truth_report's numbers): each camera's
# fx, fy, cx and cy within 1% of the rig's, |T| within 1% of 120 mm, each
# camera's reprojection RMS at most 0.2 px, the rectified corners' rows
# within 0.5 px (median); of the valid pixels between the planes' edges,
# SGBM at least 85% within 1 px (half size) with at least 60% of those
# pixels valid, BM at least 75% within 1 px (full size).  Measured on the
# CPU at full size (perf/stereo_truth.py): 0.061% and 0.050%, 2.2e-5, 0.026
# and 0.023 px, 0.015 px; SGBM 1.0 with 1.0 valid, BM 1.0
STEREO_GATES = dict(intrinsics=0.01, baseline=0.01, rms=0.2, rows=0.5, sgbm_within=0.85,
                    sgbm_valid=0.60, bm_within=0.75)

# the windows of the interior masks: SGBM's 3×3 block and median at half
# size, BM's 9×9 block at full size, each with its neighbours
STEREO_INTERIOR_R = {"sgbm": 4, "bm": 8}


def stereo_calibration_report(rig, data) -> dict:
    """calibrate_rig's ``rig`` against :func:`make_stereo_rig`'s ``data``:

    - ``intrinsics``: per camera the largest relative error of fx, fy, cx
      and cy against the truth;
    - ``baseline``: |T| (mm) and its relative error against 120 mm;
    - ``rms``: each camera's reprojection RMS and the stereo one (px);
    - ``rows``: the median |y1 - y2| of the pairs' corners rectified by
      (R1, P1) and (R2, P2) (px)."""
    truth = data["rig"]
    rep = {"intrinsics": tuple(
        max(abs(rig[k][i, j] / truth[k][i, j] - 1) for i, j in ((0, 0), (1, 1), (0, 2), (1, 2)))
        for k in ("K1", "K2"))}
    b = float(np.linalg.norm(rig["T"]))
    rep["baseline"] = (b, abs(b / STEREO_BASELINE_MM - 1))
    rep["rms"] = (rig["rms1"], rig["rms2"], rig["rms"])
    c = rig["corners"]
    crit = (3, 50, 1e-9)
    y1 = np.concatenate([undistortPoints(c[i, 0], rig["K1"], rig["d1"], rig["R1"], rig["P1"],
                                         crit)[:, 0, 1] for i in range(len(c))])
    y2 = np.concatenate([undistortPoints(c[i, 1], rig["K2"], rig["d2"], rig["R2"], rig["P2"],
                                         crit)[:, 0, 1] for i in range(len(c))])
    rep["rows"] = float(np.median(np.abs(y1 - y2)))
    return rep


def stereo_truth_report(rig, out, data) -> dict:
    """:func:`stereo_calibration_report`'s keys, and for forward_stereo's
    ``out``: ``sgbm`` and ``bm``, of the valid pixels between the planes'
    edges (:func:`stereo_interior`), the share within 1 px of the truth at
    the matcher's scale, the share of those pixels that are valid, and the
    share within 1 px of all valid pixels."""
    rep = stereo_calibration_report(rig, data)
    for name, key, dkey, bkey, first in (
            ("sgbm", "sgbm", "disparity_half", "both_half", STEREO_SGBM["numDisparities"]),
            ("bm", "bm_filtered", "disparity", "both",
             STEREO_BM["numDisparities"] + STEREO_BM["blockSize"] // 2)):
        d = out[key].cpu().numpy()
        valid = d >= 0
        err = np.abs(d / 16.0 - data[dkey])
        inner = stereo_interior(data[dkey], data[bkey], STEREO_INTERIOR_R[name], first)
        vi = valid & inner
        rep[name] = (float((err[vi] <= 1).mean()) if vi.any() else 0.0,
                     float(vi.sum() / max(inner.sum(), 1)),
                     float((err[valid] <= 1).mean()) if valid.any() else 0.0)
    return rep


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


# ------------------------------------------------------------ detection

SHAPE_DETECT = (8, 1080, 1920, 3)
DETECT_SIZE = (416, 416)
# confThreshold and nmsThreshold as OpenCV's samples/dnn/object_detection.py
# sets them
DETECT_CONF = 0.5
DETECT_NMS = 0.4
# the head biases of the random weights: every anchor's objectness logit at
# DETECT_OBJ_BIAS (a detector's prior that most anchors hold nothing), but
# the first anchor of the 13x13 head, whose objectness and class-0 logits
# are at DETECT_PRIOR_BIAS; untrained, the heads then give about one row
# per cell of that anchor over confThreshold, whatever the features' scale
DETECT_OBJ_BIAS = -4.0
DETECT_PRIOR_BIAS = 2.0
DETECT_OBJECTS = 10         # shapes drawn on each of make_detect_frames' frames

# Darknet's published cfg/yolov3-tiny.cfg (github.com/pjreddie/darknet),
# its training keys left out: 416x416x3, 13 convolutions with batch norm
# and leaky ReLU, six max-pools (the last at stride 1), the 1x1 route, the
# 2x upsample and the concat with layer 8, two [yolo] heads of 80 classes
YOLOV3_TINY_CFG = """[net]
batch=1
subdivisions=1
width=416
height=416
channels=3

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=64
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=128
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=256
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=512
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=1

[convolutional]
batch_normalize=1
filters=1024
size=3
stride=1
pad=1
activation=leaky

###########

[convolutional]
batch_normalize=1
filters=256
size=1
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=512
size=3
stride=1
pad=1
activation=leaky

[convolutional]
size=1
stride=1
pad=1
filters=255
activation=linear



[yolo]
mask = 3,4,5
anchors = 10,14,  23,27,  37,58,  81,82,  135,169,  344,319
classes=80
num=6
jitter=.3
ignore_thresh = .7
truth_thresh = 1
random=1

[route]
layers = -4

[convolutional]
batch_normalize=1
filters=128
size=1
stride=1
pad=1
activation=leaky

[upsample]
stride=2

[route]
layers = -1, 8

[convolutional]
batch_normalize=1
filters=256
size=3
stride=1
pad=1
activation=leaky

[convolutional]
size=1
stride=1
pad=1
filters=255
activation=linear

[yolo]
mask = 0,1,2
anchors = 10,14,  23,27,  37,58,  81,82,  135,169,  344,319
classes=80
num=6
jitter=.3
ignore_thresh = .7
truth_thresh = 1
random=1
"""

# forward_detect's stages, in order
DETECT_STAGES = ("blob", "net", "decode", "nms")


def yolov3_tiny_cfg(width_div: int = 1, size: int = 416) -> str:
    """YOLOV3_TINY_CFG with every hidden layer's filters divided by
    `width_div` and the input `size` square (the heads keep their 255 =
    3 x (5 + 80) channels): the tests' cut of the model."""
    out = []
    for line in YOLOV3_TINY_CFG.splitlines():
        if line.startswith("filters=") and line != "filters=255":
            line = f"filters={int(line.split('=')[1]) // width_div}"
        elif line.startswith(("width=", "height=")):
            line = f"{line.split('=')[0]}={size}"
        out.append(line)
    return "\n".join(out) + "\n"


def darknet_convs(cfg: str) -> list:
    """Each [convolutional] layer of a cfg, in order, as a dict of
    filters, size, stride, groups, the input channels ``c_in``, whether it
    has batch norm, its output size ``hw`` (H, W) and its parameter count
    as the .weights file stores it (bias, the batch norm's scale, mean and
    variance, the kernel)."""
    from .dnn.darknet import _ints, _parse_cfg

    secs = _parse_cfg(cfg)
    net = secs[0][1]
    c, h, w = int(net.get("channels", 3)), int(net.get("height", 416)), int(net.get("width", 416))
    chans, sizes, convs = [], [], []
    for li, (kind, p) in enumerate(secs[1:]):
        if kind == "convolutional":
            k, s = int(p.get("size", 1)), int(p.get("stride", 1))
            f, g = int(p["filters"]), int(p.get("groups", 1))
            pad = k // 2 if int(p.get("pad", 0)) else 0
            h, w = (h + 2 * pad - k) // s + 1, (w + 2 * pad - k) // s + 1
            bn = int(p.get("batch_normalize", 0)) == 1
            convs.append(dict(filters=f, size=k, stride=s, groups=g, c_in=c, bn=bn, hw=(h, w),
                              params=f * (4 if bn else 1) + f * (c // g) * k * k))
            c = f
        elif kind == "maxpool":
            k, s = int(p.get("size", 2)), int(p.get("stride", 2))
            pd = int(p.get("padding", k - 1))
            h, w = (h + pd - k) // s + 1, (w + pd - k) // s + 1
        elif kind == "route":
            refs = [v if v >= 0 else li + v for v in _ints(p["layers"])]
            c = sum(chans[r] for r in refs)
            h, w = sizes[refs[0]]
        elif kind == "upsample":
            s = int(p.get("stride", 2))
            h, w = h * s, w * s
        chans.append(c)
        sizes.append((h, w))
    return convs


def detect_flops(cfg: str) -> int:
    """The convolutions' operations of one image, a multiply-add counting
    two (Darknet's count)."""
    return sum(2 * v["filters"] * (v["c_in"] // v["groups"]) * v["size"] ** 2
               * v["hw"][0] * v["hw"][1] for v in darknet_convs(cfg))


def write_darknet_weights(cfg: str, path, seed: int = 0) -> int:
    """Write random weights for `cfg` as a Darknet .weights file (header
    major 0, minor 2, revision 0, a 64-bit seen count; then per
    convolution its bias, [batch norm scale, mean, variance], kernel) made
    from numpy's default_rng(seed): He-scaled kernels, batch norm near the
    identity, the heads' biases as DETECT_OBJ_BIAS and DETECT_PRIOR_BIAS
    say.  Returns the count of floats written."""
    rng = np.random.default_rng(seed)
    parts = [np.asarray([0, 2, 0], np.int32).tobytes(), np.asarray([0], np.int64).tobytes()]
    n = 0
    heads = 0
    for v in darknet_convs(cfg):
        f, fan_in = v["filters"], (v["c_in"] // v["groups"]) * v["size"] ** 2
        kern = rng.normal(0, np.sqrt((2.0 if v["bn"] else 1.0) / fan_in),
                          (f, v["c_in"] // v["groups"], v["size"], v["size"]))
        if v["bn"]:
            bias = rng.normal(0, 0.05, f)
            bn = [rng.uniform(0.9, 1.1, f), rng.normal(0, 0.05, f), rng.uniform(0.9, 1.1, f)]
        else:
            bias = np.zeros(f)
            bias[4::85] = DETECT_OBJ_BIAS   # each anchor's objectness (5 + 80 per anchor)
            if heads == 0:
                bias[4] = bias[5] = DETECT_PRIOR_BIAS
            heads += 1
            bn = []
        for a in [bias, *bn, kern]:
            a = np.asarray(a, np.float32).ravel()
            parts.append(a.tobytes())
            n += a.size
    with open(path, "wb") as fh:
        fh.write(b"".join(parts))
    return n


def make_detect_net(seed: int = 0, device="cuda", width_div: int = 1, size: int = 416):
    """YOLOv3-tiny (:func:`yolov3_tiny_cfg`) with random weights from
    `seed` (:func:`write_darknet_weights`), written as a Darknet cfg and
    .weights under ``opencv_tpu_torch/_build/`` and read back by
    ``readNetFromDarknet`` onto `device`."""
    import os
    from .dnn import readNetFromDarknet

    cfg = yolov3_tiny_cfg(width_div, size)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
    os.makedirs(build, exist_ok=True)
    stem = os.path.join(build, f"yolov3-tiny_w{width_div}_s{size}_seed{seed}")
    with open(stem + ".cfg", "w") as fh:
        fh.write(cfg)
    write_darknet_weights(cfg, stem + ".weights", seed)
    return readNetFromDarknet(stem + ".cfg", stem + ".weights", device=device)


def make_detect_frames(shape=SHAPE_DETECT, seed: int = 0) -> np.ndarray:
    """(N, H, W, 3) u8 BGR frames from numpy's default_rng(seed): a
    gradient background with noise, and DETECT_OBJECTS filled rectangles
    and ellipses of random colours and sizes on each."""
    rng = np.random.default_rng(seed)
    N, H, W, _ = shape
    yy = np.linspace(0, 1, H, dtype=np.float32)[:, None, None]
    xx = np.linspace(0, 1, W, dtype=np.float32)[None, :, None]
    out = np.empty(shape, np.uint8)
    for i in range(N):
        c0, c1, c2 = rng.uniform(30, 220, (3, 3)).astype(np.float32)
        f = c0 + (c1 - c0) * yy + (c2 - c0) * xx * 0.5
        f = f + rng.normal(0, 6, (H, W, 1)).astype(np.float32)
        for _ in range(DETECT_OBJECTS):
            h = int(rng.integers(max(H // 27, 2), max(H // 2, 3)))
            w = int(rng.integers(max(W // 48, 2), max(W // 3, 3)))
            y0, x0 = int(rng.integers(0, H - h)), int(rng.integers(0, W - w))
            col = rng.uniform(0, 255, 3).astype(np.float32)
            if rng.random() < 0.5:
                f[y0:y0 + h, x0:x0 + w] = col
            else:
                ry = (np.arange(h, dtype=np.float32)[:, None] - h / 2) / (h / 2)
                rx = (np.arange(w, dtype=np.float32)[None, :] - w / 2) / (w / 2)
                f[y0:y0 + h, x0:x0 + w][(ry * ry + rx * rx) <= 1] = col
        out[i] = np.clip(f, 0, 255).astype(np.uint8)
    return out


def _d_blob(st):
    from .dnn import blobFromImages
    size = st["size"]
    return blobFromImages(st["frames"], 1 / 255.0, size, swapRB=True)


def _d_net(st):
    net = st["net"]
    net.setInput(st["blob"])
    return net.forward(net.getUnconnectedOutLayersNames())


def _d_decode(st):
    from .dnn.models import decode_yolo_batch
    N, fh, fw = st["frames"].shape[:3]
    heads = [h if N > 1 else h[None] for h in st["net_out"]]
    return decode_yolo_batch(heads, fh, fw, DETECT_CONF)


def _d_nms(st):
    from .dnn.nms import NMSBoxesBatched
    out = []
    for cids, confs, boxes in st["decode"]:
        keep = NMSBoxesBatched(boxes, confs, cids, DETECT_CONF, DETECT_NMS)
        out.append((cids[keep], confs[keep], boxes[keep]))
    return out


_DETECT_FNS = {"blob": _d_blob, "net": _d_net, "decode": _d_decode, "nms": _d_nms}


@region("entry.forward_detect")
def forward_detect(frames, net, size=DETECT_SIZE, stages=DETECT_STAGES, state=None) -> dict:
    """Objects in a batch of BGR u8 frames, as a detector in front of a
    camera runs it: ``blobFromImages(frames, 1/255, size, swapRB=True)`` →
    the net's forward (both YOLO heads) → each frame's
    ``DetectionModel.detect`` decode (the rows whose best class score is
    at least DETECT_CONF, their boxes in frame pixels) →
    ``NMSBoxesBatched`` at DETECT_NMS.  Returns the state: "blob", "net_out"
    (the heads), "decode" and "nms" (per frame: class ids, scores, boxes
    [x, y, w, h]).  `stages` and `state` run a part of the chain from a
    given state."""
    st = dict(state or {}, frames=frames, net=net, size=size)
    for name in stages:
        st["net_out" if name == "net" else name] = _DETECT_FNS[name](st)
    return st


def entry_detect(device="cuda", shape=SHAPE_DETECT, seed: int = 0):
    """``(forward_detect, (frames, net))``: make_detect_frames()' frames and
    :func:`make_detect_net`'s full-width YOLOv3-tiny on `device`."""
    frames = torch.from_numpy(make_detect_frames(shape, seed)).to(device)
    return forward_detect, (frames, make_detect_net(seed, device))


# ---------------------------------------------------------------------------
# stitching: cv::Stitcher over a panning camera
# ---------------------------------------------------------------------------

SHAPE_STITCH = (8, 1080, 1920, 3)


@region("entry.forward_stitch")
def forward_stitch(frames) -> dict:
    """The frames of a panning camera stitched into one panorama, as
    OpenCV's samples/python/stitching.py runs ``Stitcher.create().stitch``:
    each next frame onto the panorama so far (ORB 1000 on both, the
    cross-checked Hamming matches, the best 200, RANSAC findHomography at
    3 px, warpPerspective onto the canvas, the L1 distance-transform seam
    and the 4-band blend).  Returns {"status", "pano", "homographies" (each
    frame into the panorama before it), "stitcher"}."""
    from .stitching import Stitcher
    st = Stitcher.create()
    status, pano = st.stitch(frames)
    return {"status": status, "pano": pano, "homographies": list(st.homographies),
            "stitcher": st}


def pan_extent(truth, shape) -> tuple:
    """The panorama's extent that the pan's truth implies: every frame's
    corners taken into frame 0 through the inverse of the chained
    frame-to-next maps; ``(min x, max x, min y, max y)``."""
    N, H, W = shape[:3]
    corners = np.array([[0, 0, 1], [W, 0, 1], [W, H, 1], [0, H, 1]], np.float64).T
    to0 = np.eye(3)          # frame k -> frame 0
    pts = [corners[:2]]
    for i in range(N - 1):
        A = np.vstack([truth[i], [0, 0, 1]])   # frame i -> frame i+1
        to0 = to0 @ np.linalg.inv(A)
        pts.append((to0 @ corners)[:2])
    p = np.hstack(pts)
    return float(p[0].min()), float(p[0].max()), float(p[1].min()), float(p[1].max())


# ---------------------------------------------------------------------------
# G-API: the flagship chain as a GComputation
# ---------------------------------------------------------------------------

def gapi_flagship(shape=SHAPE):
    """The flagship chain (:func:`forward`) as a ``gapi.GComputation`` of
    (N, H, W, 3) u8 BGR input: cvtColor BGR2GRAY → gaussianBlur 5×5 →
    resize to half size → warpAffine (15°, 0.9 about the centre), with
    pyrDown of the gray frame as a second output."""
    from . import gapi
    H, W = shape[1], shape[2]
    w, h = W // 2, H // 2
    M = np.asarray(getRotationMatrix2D((w / 2, h / 2), 15.0, 0.9), np.float64)
    gin = gapi.GMat()
    g = gapi.g_op("cvtColor", gin, code=K.COLOR_BGR2GRAY)
    b = gapi.g_op("gaussianBlur", g, ksize=(5, 5), sigmaX=0.0)
    r = gapi.g_op("resize", b, dsize=(w, h))
    out = gapi.g_op("warpAffine", r, M=M.tolist(), dsize=(w, h))
    return gapi.GComputation(gin, [out, gapi.g_op("pyrDown", g)])


@region("entry.forward_gapi")
def forward_gapi(batches, comp=None, device="cuda") -> list:
    """:func:`gapi_flagship`'s graph over host batches through
    ``gapi.Stream`` on `device`: the list of each batch's (warped, half)."""
    from . import gapi
    comp = comp or gapi_flagship(np.shape(batches[0]))
    return list(gapi.Stream(comp.apply, device=device).run(batches))


# ---------------------------------------------------------------------------
# the DNN trackers: GOTURN at CaffeNet's published widths
# ---------------------------------------------------------------------------

SHAPE_TRACK_DNN = (8, 1080, 1920, 3)   # make_motion_video's frames
GOTURN_INPUT = 227
# the box GOTURN's net gives for a target that did not move, in its 227-px
# search region (the region is twice the box, centred on it), over the
# Power layer's scale of 10: fc8's bias, an untrained tracker's prior
GOTURN_PRIOR = (56.75 / 10, 56.75 / 10, 170.25 / 10, 170.25 / 10)
# fc8's kernel is He-scaled times this, so that the random features move
# the prior box by a few pixels of the search region at most
GOTURN_FC8_GAIN = 3e-3


def _goturn_tower(t: str, bottom: str, d: int) -> str:
    """CaffeNet's five convolutions of one tower (suffix `t`), widths / d."""
    def conv(name, bot, n, k, s=1, p=0, g=1):
        return (f'layer {{ name: "{name}" type: "Convolution" bottom: "{bot}" top: "{name}" '
                f'convolution_param {{ num_output: {n // d} kernel_size: {k} stride: {s} pad: {p} '
                f'group: {g} }} }}\n'
                f'layer {{ name: "relu{name[4:]}" type: "ReLU" bottom: "{name}" top: "{name}" }}\n')

    def pool(name, bot):
        return (f'layer {{ name: "{name}" type: "Pooling" bottom: "{bot}" top: "{name}" '
                f'pooling_param {{ pool: MAX kernel_size: 3 stride: 2 }} }}\n')

    def norm(name, bot):
        return (f'layer {{ name: "{name}" type: "LRN" bottom: "{bot}" top: "{name}" '
                f'lrn_param {{ local_size: 5 alpha: 0.0001 beta: 0.75 }} }}\n')

    return (conv(f"conv1{t}", bottom, 96, 11, s=4) + pool(f"pool1{t}", f"conv1{t}")
            + norm(f"norm1{t}", f"pool1{t}")
            + conv(f"conv2{t}", f"norm1{t}", 256, 5, p=2, g=2) + pool(f"pool2{t}", f"conv2{t}")
            + norm(f"norm2{t}", f"pool2{t}")
            + conv(f"conv3{t}", f"norm2{t}", 384, 3, p=1)
            + conv(f"conv4{t}", f"conv3{t}", 384, 3, p=1, g=2)
            + conv(f"conv5{t}", f"conv4{t}", 256, 3, p=1, g=2) + pool(f"pool5{t}", f"conv5{t}"))


def goturn_prototxt(width_div: int = 1) -> str:
    """GOTURN's network as its published deploy prototxt defines it
    (github.com/davheld/GOTURN nets/tracker.prototxt, as opencv_extra's
    testdata/dnn/gsoc2016-goturn/goturn.prototxt deploys it for
    cv::TrackerGOTURN): two CaffeNet towers of 1×3×227×227 ("data1", the
    previous frame's crop; "data2", the current one), each conv1 96 k11 s4,
    ReLU, pool 3/2, LRN (5, 1e-4, 0.75), conv2 256 k5 p2 g2, ReLU, pool,
    LRN, conv3 384 k3 p1, conv4 384 k3 p1 g2, conv5 256 k3 p1 g2 (each
    with ReLU), pool5 3/2 (6×6×256); their concat (18,432 values); fc6,
    fc7 and fc7b of 4096 with ReLU and Dropout; fc8 of 4; a Power layer of
    scale 10, whose top is named ``scale`` (the name OpenCV's tracker
    reads) so that the executor's top names reach it.  Every hidden width
    is divided by `width_div` (the tests' cut)."""
    d = width_div
    head = ('name: "GOTURN"\n'
            'input: "data1"\ninput_shape { dim: 1 dim: 3 dim: 227 dim: 227 }\n'
            'input: "data2"\ninput_shape { dim: 1 dim: 3 dim: 227 dim: 227 }\n')
    fc = ""
    bot = "concat"
    for name in ("fc6", "fc7", "fc7b"):
        fc += (f'layer {{ name: "{name}" type: "InnerProduct" bottom: "{bot}" top: "{name}" '
               f'inner_product_param {{ num_output: {4096 // d} }} }}\n'
               f'layer {{ name: "relu{name[2:]}" type: "ReLU" bottom: "{name}" top: "{name}" }}\n'
               f'layer {{ name: "drop{name[2:]}" type: "Dropout" bottom: "{name}" top: "{name}" '
               f'dropout_param {{ dropout_ratio: 0.5 }} }}\n')
        bot = name
    return (head + _goturn_tower("1", "data1", d) + _goturn_tower("2", "data2", d)
            + 'layer { name: "concat" type: "Concat" bottom: "pool51" bottom: "pool52" '
              'top: "concat" concat_param { axis: 1 } }\n'
            + fc
            + 'layer { name: "fc8" type: "InnerProduct" bottom: "fc7b" top: "fc8" '
              'inner_product_param { num_output: 4 } }\n'
            + 'layer { name: "scale" type: "Power" bottom: "fc8" top: "scale" '
              'power_param { scale: 10 } }\n')


def goturn_layers(width_div: int = 1) -> list:
    """(name, kernel shape) of each learned layer of :func:`goturn_prototxt`,
    in order, with a bias of the kernel's first dimension each."""
    d = width_div
    out = []
    for t in ("1", "2"):
        c = 3
        for name, n, k, g in (("conv1", 96, 11, 1), ("conv2", 256, 5, 2), ("conv3", 384, 3, 1),
                              ("conv4", 384, 3, 2), ("conv5", 256, 3, 2)):
            out.append((name + t, (n // d, c // g, k, k)))
            c = n // d
    fan = 2 * (256 // d) * 6 * 6
    for name in ("fc6", "fc7", "fc7b"):
        out.append((name, (4096 // d, fan)))
        fan = 4096 // d
    out.append(("fc8", (4, fan)))
    return out


def goturn_flops(width_div: int = 1) -> int:
    """The operations of one forward (both towers, a multiply-add counting
    two): the convolutions at 55, 27, 13, 13 and 13 px, and the products."""
    hw = {"conv1": 55, "conv2": 27, "conv3": 13, "conv4": 13, "conv5": 13}
    total = 0
    for name, shape in goturn_layers(width_div):
        per_out = int(np.prod(shape[1:]))
        n_out = shape[0] * (hw[name[:5]] ** 2 if name.startswith("conv") else 1)
        total += 2 * per_out * n_out
    return total


def write_goturn_caffemodel(path, seed: int = 0, width_div: int = 1) -> int:
    """Random weights for :func:`goturn_prototxt` as a ``.caffemodel``,
    written by the port's protobuf codec: each kernel a He-scaled normal
    (fc8's times GOTURN_FC8_GAIN) from numpy's default_rng(seed), the
    hidden biases 0 and fc8's GOTURN_PRIOR.  Returns the count of
    parameters."""
    from .dnn import _proto
    caffe = _proto.schema("opencv_caffe")
    rng = np.random.default_rng(seed)
    net = caffe.NetParameter()
    net.name = "GOTURN"
    n = 0
    for name, shape in goturn_layers(width_div):
        fan_in = int(np.prod(shape[1:]))
        std = np.sqrt(2.0 / fan_in) * (GOTURN_FC8_GAIN if name == "fc8" else 1.0)
        kern = rng.standard_normal(shape, np.float32) * np.float32(std)
        bias = (np.asarray(GOTURN_PRIOR, np.float32) if name == "fc8"
                else np.zeros(shape[0], np.float32))
        layer = net.layer.add()
        layer.name = name
        layer.type = "InnerProduct" if name.startswith("fc") else "Convolution"
        for a in (kern, bias):
            blob = layer.blobs.add()
            blob.shape.dim.extend(a.shape)
            blob.data.extend(a)
            n += a.size
    with open(path, "wb") as fh:
        fh.write(net.SerializeToString())
    return n


def goturn_files(seed: int = 0, width_div: int = 1) -> tuple:
    """:func:`goturn_prototxt` and :func:`write_goturn_caffemodel`'s weights
    written under ``opencv_tpu_torch/_build/``: (prototxt path, caffemodel
    path).  Each is written to a name of this process and moved into place,
    so processes that write them at once never read a half-written file."""
    import os
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
    os.makedirs(build, exist_ok=True)
    stem = os.path.join(build, f"goturn_w{width_div}_seed{seed}")
    tmp = f"{stem}.{os.getpid()}.tmp"
    with open(tmp, "w") as fh:
        fh.write(goturn_prototxt(width_div))
    os.replace(tmp, stem + ".prototxt")
    write_goturn_caffemodel(tmp, seed, width_div)
    os.replace(tmp, stem + ".caffemodel")
    return stem + ".prototxt", stem + ".caffemodel"


def make_goturn_net(seed: int = 0, device="cuda", width_div: int = 1):
    """GOTURN (:func:`goturn_files`) read by ``readNetFromCaffe`` onto
    `device`."""
    from .dnn import readNetFromCaffe
    return readNetFromCaffe(*goturn_files(seed, width_div), device=device)


def make_goturn_trackers(net, frame, boxes) -> list:
    """One ``TrackerGOTURN`` per box (x, y, w, h), all reading the one
    `net`, each initialised on `frame`."""
    from .video.dnn_trackers import TrackerGOTURN
    out = []
    for box in boxes:
        t = TrackerGOTURN(device=net.device, net=net)
        t.init(frame, tuple(int(v) for v in box))
        out.append(t)
    return out


@region("entry.forward_track_dnn")
def forward_track_dnn(frames, trackers) -> dict:
    """Each tracker updated on frames 1.. in turn, as a multi-object
    tracker runs its single-object trackers: {"boxes": (N-1, T, 4) int64
    host array, "updates": per update (frame, tracker, region, target blob,
    search blob, the net's output)}."""
    boxes = np.zeros((len(frames) - 1, len(trackers), 4), np.int64)
    updates = []
    for i in range(1, len(frames)):
        for k, t in enumerate(trackers):
            _, boxes[i - 1, k] = t.update(frames[i])
            updates.append((i, k, *t.last))
    return {"boxes": boxes, "updates": updates}


# The synthetic models of the other DNN trackers and features, built with the
# port's codec: the graphs tests/test_dnn_trackers.py and test_dl_features.py
# build with google.protobuf, from the same seeds

def _onnx_tensor(S, name, arr):
    t = S.TensorProto()
    t.name = name
    arr = np.asarray(arr)
    t.data_type = 7 if arr.dtype == np.int64 else 1
    t.dims.extend(arr.shape)
    t.raw_data = np.ascontiguousarray(arr).tobytes()
    return t


def _onnx_node(S, op, inputs, outputs, **attrs):
    n = S.NodeProto()
    n.op_type = op
    n.name = ""
    n.input.extend(inputs)
    n.output.extend(outputs)
    for k, v in attrs.items():
        a = n.attribute.add()
        a.name = k
        if isinstance(v, int):
            a.type = S.AttributeProto.INT
            a.i = v
        else:
            a.type = S.AttributeProto.INTS
            a.ints.extend(v)
    return n


def _onnx_model(S, inputs, outputs, nodes, inits):
    m = S.ModelProto()
    m.ir_version = 7
    m.opset_import.add().version = 13
    g = m.graph
    g.name = "t"
    for io, specs in ((g.input, inputs), (g.output, outputs)):
        for name, shape in specs:
            vi = io.add()
            vi.name = name
            vi.type.tensor_type.elem_type = 1
            for d in shape:
                dim = vi.type.tensor_type.shape.dim.add()
                if d:
                    dim.dim_value = d
                else:
                    dim.dim_param = "d"
    g.node.extend(nodes)
    g.initializer.extend(inits)
    return m


def small_dnn_models() -> dict:
    """The small ONNX graphs of the Nano, DaSiamRPN and Vit trackers and of
    DISK and ALIKED, as {name: bytes}: "nano_backbone", "nano_neckhead",
    "dasiam", "dasiam_cls1", "dasiam_r1", "vit", "disk", "aliked"."""
    from .dnn import _proto
    S = _proto.schema("onnx_schema")
    T = functools.partial(_onnx_tensor, S)
    N = functools.partial(_onnx_node, S)
    M = functools.partial(_onnx_model, S)
    out = {}
    rng = np.random.default_rng(5)
    wb = rng.normal(0, 0.1, (4, 3, 3, 3)).astype(np.float32)
    bb = rng.normal(0, 0.1, 4).astype(np.float32)
    out["nano_backbone"] = M(
        [("input", (1, 3, 0, 0))], [("feat", (1, 4, 0, 0))],
        [N("Conv", ["input", "wb", "bb"], ["feat"], kernel_shape=[3, 3], strides=[16, 16],
           pads=[1, 1, 1, 1])], [T("wb", wb), T("bb", bb)])
    wc = rng.normal(0, 0.4, (2, 4, 1, 1)).astype(np.float32)
    bc = rng.normal(0, 0.2, 2).astype(np.float32)
    wr = rng.normal(0, 0.4, (4, 4, 1, 1)).astype(np.float32)
    br = rng.normal(0, 0.2, 4).astype(np.float32)
    out["nano_neckhead"] = M(
        [("input1", (1, 4, 8, 8)), ("input2", (1, 4, 16, 16))],
        [("output1", (1, 2, 16, 16)), ("output2", (1, 4, 16, 16))],
        [N("GlobalAveragePool", ["input1"], ["ga"]), N("Add", ["input2", "ga"], ["t"]),
         N("Conv", ["t", "wc", "bc"], ["output1"], kernel_shape=[1, 1]),
         N("Conv", ["t", "wr", "br"], ["bx"], kernel_shape=[1, 1]),
         N("Sigmoid", ["bx"], ["bxs"]), N("Mul", ["bxs", "sc30"], ["output2"])],
        [T("wc", wc), T("bc", bc), T("wr", wr), T("br", br),
         T("sc30", np.float32(30.0).reshape(()))])
    rng = np.random.default_rng(7)
    ws = {k: rng.normal(0, s, shape).astype(np.float32) for k, s, shape in (
        ("w1", 0.2, (8, 3, 7, 7)), ("b1", 0.1, 8), ("w2", 0.05, (256, 8, 13, 13)),
        ("b2", 0.05, 256), ("w65", 0.02, (20, 256, 4, 4)), ("b65", 0.02, 20),
        ("w68", 0.02, (10, 256, 4, 4)), ("b68", 0.02, 10))}
    out["dasiam"] = M(
        [("input", (1, 3, 0, 0))], [("65", (1, 20, 0, 0)), ("68", (1, 10, 0, 0))],
        [N("Conv", ["input", "w1", "b1"], ["c1"], kernel_shape=[7, 7], strides=[8, 8]),
         N("Relu", ["c1"], ["62"]),
         N("Conv", ["62", "w2", "b2"], ["63"], kernel_shape=[13, 13]),
         N("Conv", ["63", "w65", "b65"], ["65"], kernel_shape=[4, 4]),
         N("Conv", ["63", "w68", "b68"], ["68"], kernel_shape=[4, 4])],
        [T(k, a) for k, a in ws.items()])
    for key, reps in (("dasiam_r1", 20), ("dasiam_cls1", 10)):
        out[key] = M([("input", (1, 256, 4, 4))], [("out", (reps, 256, 4, 4))],
                     [N("Tile", ["input", f"r{reps}"], ["out"])],
                     [T(f"r{reps}", np.asarray([reps, 1, 1, 1], np.int64))])
    rng = np.random.default_rng(9)
    vw = {}
    for k, s, shape in (("ws", 0.05, (4, 3, 16, 16)), ("bs", 0.05, 4), ("wt", 0.05, (4, 3, 16, 16)),
                        ("bt", 0.05, 4), ("wconf", 0.5, (1, 4, 1, 1))):
        vw[k] = rng.normal(0, s, shape).astype(np.float32)
    vw["bconf"] = np.asarray([0.3], np.float32)
    vw["wsz"] = rng.normal(0, 0.3, (2, 4, 1, 1)).astype(np.float32)
    vw["bsz"] = np.asarray([-1.0, -1.0], np.float32)
    vw["woff"] = rng.normal(0, 0.3, (2, 4, 1, 1)).astype(np.float32)
    vw["boff"] = np.asarray([0.0, 0.0], np.float32)
    out["vit"] = M(
        [("template", (1, 3, 128, 128)), ("search", (1, 3, 256, 256))],
        [("output1", (1, 1, 16, 16)), ("output2", (1, 2, 16, 16)), ("output3", (1, 2, 16, 16))],
        [N("Conv", ["search", "ws", "bs"], ["fs"], kernel_shape=[16, 16], strides=[16, 16]),
         N("Conv", ["template", "wt", "bt"], ["ft"], kernel_shape=[16, 16], strides=[16, 16]),
         N("GlobalAveragePool", ["ft"], ["ga"]), N("Add", ["fs", "ga"], ["t"]),
         N("Conv", ["t", "wconf", "bconf"], ["cf"], kernel_shape=[1, 1]),
         N("Sigmoid", ["cf"], ["output1"]),
         N("Conv", ["t", "wsz", "bsz"], ["sz"], kernel_shape=[1, 1]),
         N("Sigmoid", ["sz"], ["output2"]),
         N("Conv", ["t", "woff", "boff"], ["of"], kernel_shape=[1, 1]),
         N("Sigmoid", ["of"], ["output3"])],
        [T(k, a) for k, a in vw.items()])
    kp = np.array([[0, 0], [100, 40], [200, 80], [631, 479], [300, 300], [50, 400]], np.float32)
    scores = np.array([1.0, 0.9, 0.8, 0.7, 0.6, 0.5], np.float32)
    desc = np.random.default_rng(4).normal(0, 1, (6, 128)).astype(np.float32)
    for key, kp0, sc0, de0, outs in (
            ("disk", kp[None], scores[None], desc[None],
             [("keypoints", (1, 6, 2)), ("scores", (1, 6)), ("descriptors", (1, 6, 128))]),
            ("aliked", kp / np.array([640, 480], np.float32) * 2 - 1, scores, desc,
             [("keypoints", (6, 2)), ("scores", (6,)), ("descriptors", (6, 128))])):
        nodes = [N("ReduceMean", ["image"], ["gm"], keepdims=0), N("Mul", ["gm", "zero"], ["z"])]
        if key == "disk":
            nodes += [N("Add", ["kp0", "z"], ["kpf"]), N("Cast", ["kpf"], ["keypoints"], to=7)]
        else:
            nodes += [N("Add", ["kp0", "z"], ["keypoints"])]
        nodes += [N("Add", ["sc0", "z"], ["scores"]), N("Add", ["de0", "z"], ["descriptors"])]
        m = M([("image", (1, 3, 0, 0))], outs, nodes,
              [T("kp0", kp0), T("sc0", sc0), T("de0", de0), T("zero", np.zeros((), np.float32))])
        if key == "disk":
            m.graph.output[0].type.tensor_type.elem_type = 7   # int64 keypoints
        out[key] = m
    return {k: m.SerializeToString() for k, m in out.items()}


def dnn_sweep(models: dict, frames, box, workdir: str, device="cuda") -> dict:
    """The other DNN trackers and features on `device` over
    :func:`small_dnn_models`' graphs (written to `workdir`): Nano,
    DaSiamRPN and Vit initialised on frames[0] at `box` and updated on the
    rest, DISK (at most 5 keypoints of score >= 0.75, 320×240) and ALIKED
    on frames[0], and LightGlue's match.  Returns {"nano", "dasiam", "vit":
    per update (ok, box, score); "disk", "aliked": (points, scores,
    descriptors); "lightglue": the name of the exception its match
    raised}."""
    import os
    from . import video
    from .features2d import DISK, ALIKED
    from .features2d.matchers import LightGlueMatcher
    paths = {}
    for k, b in models.items():
        paths[k] = os.path.join(workdir, k + ".onnx")
        with open(paths[k], "wb") as fh:
            fh.write(b)
    out = {}
    nano = video.TrackerNano.Params()
    nano.backbone, nano.neckhead = paths["nano_backbone"], paths["nano_neckhead"]
    dasiam = video.TrackerDaSiamRPN.Params()
    dasiam.model, dasiam.kernel_cls1, dasiam.kernel_r1 = (paths["dasiam"], paths["dasiam_cls1"],
                                                          paths["dasiam_r1"])
    vit = video.TrackerVit.Params()
    vit.net = paths["vit"]
    for key, make, params in (("nano", video.TrackerNano, nano),
                              ("dasiam", video.TrackerDaSiamRPN, dasiam),
                              ("vit", video.TrackerVit, vit)):
        t = make(params, device)
        t.init(frames[0], tuple(int(v) for v in box))
        res = []
        for f in frames[1:]:
            ok, b = t.update(f)
            res.append((ok, tuple(int(v) for v in b), t.getTrackingScore()))
        out[key] = res
    for key, det in (("disk", DISK(paths["disk"], 5, 0.75, (320, 240), device=device)),
                     ("aliked", ALIKED(paths["aliked"], device=device))):
        kps, desc = det.detectAndCompute(frames[0], None)
        out[key] = (np.array([k.pt for k in kps]), np.array([k.response for k in kps]), desc)
    lg = LightGlueMatcher(paths["aliked"], device=device)
    try:
        lg.match(None, out["aliked"][2], None, out["aliked"][2], (1, 1), (1, 1))
    except NotImplementedError as e:
        out["lightglue"] = type(e).__name__
    return out


# ---------------------------------------------------------------------------
# object detection in 1080p frames: ArUco markers, a ChArUco board, a QR
# code, an EAN-13 code, HOG people detection and an MCC colour chart
# ---------------------------------------------------------------------------

SHAPE_OBJDETECT = (8, 1080, 1920, 3)
MARKER_DICT = 10               # aruco.DICT_6X6_250
MARKER_SLOTS = (4, 3)          # the free markers' grid of slots, columns x rows
MARKER_FIRST_ID = 17           # the ChArUco board's own markers are ids 0-16
MARKER_SIDE = (90, 220)        # px a side at 1080p
MARKER_TILT = 15.0             # each marker's rotation, degrees either way
MARKER_WARP = 0.06             # each corner's random move, share of the side
MARKER_QUIET = 12              # white px around a marker, at 1080p
INK, PAPER = 25, 230           # the grey of a code's black and white print
BACKGROUND = (185.0, 12.0)     # the textured background's mean grey and deviation
CHARUCO_SQUARES = (5, 7)       # OpenCV's ChArUco tutorial's board
CHARUCO_SQUARE_M, CHARUCO_MARKER_M = 0.04, 0.02
CHARUCO_SQUARE_PX = 60         # at 1080p
QR_MODULE_PX = 6
QR_TEXT_LEN = 40
# QRCodeDetector (both packages) takes the three largest groups of
# concentric squares for the code's finders, and an ArUco marker in its
# quiet zone or a ChArUco square around its marker is such a group: the
# path runs it on the band of the frame that holds the codes, (x0, y0, x1,
# y1) at 1080p, clear of the markers and the board (ROADMAP queue C)
QR_ROI = (0, 600, 470, 1080)
EAN_MODULE_PX = 3
EAN_QUIET = 12                 # modules of quiet zone on each side
HOG_DETECT = dict(hitThreshold=0.0, winStride=(8, 8), padding=(32, 32), scale=1.05)
MCC_PATCH_PX = (170, 160)      # a chart patch's width and height at 1080p
MCC_GAP_PX = 40
OBJDETECT_STAGES = ("aruco", "charuco", "qr", "barcode", "hog", "mcc")
# the truth gates (objdetect_truth_report): a free marker's corners and a
# ChArUco corner within these px of where they were drawn, this share of
# the board's corners found, each chart patch within this many grey levels
MARKER_CORNER_TOL = 1.5
CHARUCO_CORNER_TOL = 1.0
CHARUCO_MIN_SHARE = 0.9
MCC_TOL = 2.0


def _apply_h(Hm: np.ndarray, pts: np.ndarray) -> np.ndarray:
    p = np.asarray(pts, np.float64) @ Hm[:, :2].T + Hm[:, 2]
    return p[:, :2] / p[:, 2:]


def _homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The 3x3 map of four point pairs (an 8x8 solve, H[2, 2] = 1)."""
    A, b = np.zeros((8, 8)), np.zeros(8)
    for i, ((x, y), (u, v)) in enumerate(zip(src, dst)):
        A[2 * i] = [x, y, 1, 0, 0, 0, -u * x, -u * y]
        A[2 * i + 1] = [0, 0, 0, x, y, 1, -v * x, -v * y]
        b[2 * i], b[2 * i + 1] = u, v
    return np.append(np.linalg.solve(A, b), 1.0).reshape(3, 3)


def _outline(h: int, w: int) -> np.ndarray:
    """A patch's outer corners in pixel-centre coordinates."""
    return np.array([[-0.5, -0.5], [w - 0.5, -0.5], [w - 0.5, h - 0.5], [-0.5, h - 0.5]])


def _paste(frame: np.ndarray, patch: np.ndarray, Hm: np.ndarray) -> None:
    """Draw the grey `patch` into the BGR `frame` through Hm (patch pixel
    centres to frame pixel centres), sampled bilinearly, inside the
    patch's outline only."""
    h, w = patch.shape
    FH, FW = frame.shape[:2]
    box = _apply_h(Hm, _outline(h, w))
    x0, x1 = max(int(np.floor(box[:, 0].min())), 0), min(int(np.ceil(box[:, 0].max())), FW - 1)
    y0, y1 = max(int(np.floor(box[:, 1].min())), 0), min(int(np.ceil(box[:, 1].max())), FH - 1)
    ys, xs = np.mgrid[y0:y1 + 1, x0:x1 + 1]
    src = _apply_h(np.linalg.inv(Hm), np.stack([xs.ravel(), ys.ravel()], 1))
    sx, sy = src[:, 0], src[:, 1]
    inside = (sx >= -0.5) & (sx <= w - 0.5) & (sy >= -0.5) & (sy <= h - 0.5)
    fx, fy = np.clip(sx, 0, w - 1), np.clip(sy, 0, h - 1)
    ix, iy = np.minimum(fx.astype(int), max(w - 2, 0)), np.minimum(fy.astype(int), max(h - 2, 0))
    ax, ay = fx - ix, fy - iy
    p = patch.astype(np.float64)
    ix1, iy1 = np.minimum(ix + 1, w - 1), np.minimum(iy + 1, h - 1)
    val = ((p[iy, ix] * (1 - ax) + p[iy, ix1] * ax) * (1 - ay)
           + (p[iy1, ix] * (1 - ax) + p[iy1, ix1] * ax) * ay)
    sub = frame[y0:y1 + 1, x0:x1 + 1].reshape(-1, 3)
    sub[inside] = np.rint(val[inside])[:, None].astype(np.uint8)
    frame[y0:y1 + 1, x0:x1 + 1] = sub.reshape(y1 - y0 + 1, x1 - x0 + 1, 3)


def _print(a: np.ndarray) -> np.ndarray:
    """A 0/255 code image as printed: INK and PAPER greys."""
    return np.where(a > 127, PAPER, INK).astype(np.uint8)


def _placement(rng, h: int, w: int, centre, scale: float, tilt: float, warp: float) -> np.ndarray:
    """A mild homography: the patch scaled about its centre, rotated by up
    to `tilt` degrees, each corner moved by up to `warp` of the side."""
    src = _outline(h, w)
    ang = np.deg2rad(rng.uniform(-tilt, tilt))
    R = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
    c = np.array([(w - 1) / 2.0, (h - 1) / 2.0])
    dst = (src - c) @ R.T * scale + np.asarray(centre, np.float64)
    dst += rng.uniform(-warp, warp, (4, 2)) * max(h, w) * scale
    return _homography(src, dst)


def ean13_image(digits12: str, module: int = EAN_MODULE_PX, height: int = 90,
                quiet: int = EAN_QUIET) -> tuple:
    """The EAN-13 code of 12 digits and its check digit, as a 0/255 image
    with its quiet zone (GS1's L, G and R patterns)."""
    L = {0: "0001101", 1: "0011001", 2: "0010011", 3: "0111101", 4: "0100011",
         5: "0110001", 6: "0101111", 7: "0111011", 8: "0110111", 9: "0001011"}
    first_parity = {0: "LLLLLL", 1: "LLGLGG", 2: "LLGGLG", 3: "LLGGGL", 4: "LGLLGG",
                    5: "LGGLLG", 6: "LGGGLL", 7: "LGLGLG", 8: "LGLGGL", 9: "LGGLGL"}
    d = [int(c) for c in digits12]
    s = sum(x * (3 if i % 2 else 1) for i, x in enumerate(d))
    d.append((10 - s % 10) % 10)
    inv = lambda bits: "".join("1" if c == "0" else "0" for c in bits)
    bits = "101"
    for dig, par in zip(d[1:7], first_parity[d[0]]):
        bits += L[dig] if par == "L" else inv(L[dig])[::-1]
    bits += "01010" + "".join(inv(L[dig]) for dig in d[7:]) + "101"
    row = np.full((2 * quiet + len(bits)) * module, 255, np.uint8)
    for i, b in enumerate(bits):
        if b == "1":
            row[(quiet + i) * module:(quiet + i + 1) * module] = 0
    pad = np.full((quiet * module // 2, row.size), 255, np.uint8)
    return "".join(map(str, d)), np.vstack([pad, np.tile(row, (height, 1)), pad])


def make_objdetectors(device="cuda") -> dict:
    """The path's detectors at their published settings: ArUco
    (DICT_6X6_250, default DetectorParameters), the 5 x 7 ChArUco board's
    detector, QRCodeDetector, BarcodeDetector, HOGDescriptor with the INRIA
    people SVM (getDefaultPeopleDetector) and CCheckerDetector."""
    from .objdetect import aruco
    from .objdetect.barcode import BarcodeDetector
    from .objdetect.hog import HOGDescriptor
    from .objdetect.mcc import CCheckerDetector
    from .objdetect.qrcode import QRCodeDetector
    d = aruco.getPredefinedDictionary(MARKER_DICT)
    board = aruco.CharucoBoard(CHARUCO_SQUARES, CHARUCO_SQUARE_M, CHARUCO_MARKER_M, d)
    hog = HOGDescriptor()
    hog.setSVMDetector(HOGDescriptor.getDefaultPeopleDetector())
    return {"aruco": aruco.ArucoDetector(d),
            "charuco": aruco.CharucoDetector(board), "qr": QRCodeDetector(),
            "barcode": BarcodeDetector(), "hog": hog, "mcc": CCheckerDetector()}


def make_marker_scene(shape=SHAPE_OBJDETECT, seed: int = 0):
    """(frames (N, H, W, 3) u8, chart (H, W, 3) u8, truth): each frame a
    textured background with MARKER_SLOTS free DICT_6X6_250 markers (ids >=
    MARKER_FIRST_ID, MARKER_SIDE px a side at 1080p, each under a mild
    random homography), the 5 x 7 ChArUco board rendered by the port's
    CharucoBoard.generateImage, one QR code of a seeded QR_TEXT_LEN-character
    text from the port's QRCodeEncoder and one EAN-13 code, placed apart;
    the chart a 6 x 4 colour chart of seeded patches.  Made with numpy from
    the seed (no cv2).  The truth holds each frame's marker ids and
    corners, the ChArUco corners and ids, the texts and the chart's BGR
    patches, in the frame's pixel-centre coordinates."""
    from .objdetect import aruco
    from .objdetect.qr_encode import QRCodeEncoder
    N, H, W, _ = shape
    s = H / 1080.0
    rng = np.random.default_rng(seed)
    d = aruco.getPredefinedDictionary(MARKER_DICT)
    board = aruco.CharucoBoard(CHARUCO_SQUARES, CHARUCO_SQUARE_M, CHARUCO_MARKER_M, d)
    alphabet = "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 $%*+-./:"
    text = "".join(rng.choice(list(alphabet), QR_TEXT_LEN))
    # the encoder's symbol has a 2-module margin: pad it to ISO 18004's 4
    qr = np.pad(QRCodeEncoder.create().encode(text), 2, constant_values=255)
    qr = np.kron(qr, np.ones((max(1, round(QR_MODULE_PX * s)),) * 2, np.uint8))
    ean, ean_img = ean13_image("".join(map(str, rng.integers(0, 10, 12))),
                               module=max(1, round(EAN_MODULE_PX * s)))
    sq = max(4, round(CHARUCO_SQUARE_PX * s))
    bw, bh = CHARUCO_SQUARES
    margin = sq // 2
    board_img = board.generateImage((bw * sq + 2 * margin, bh * sq + 2 * margin), margin)
    inner = np.array([[margin + (x + 1) * sq - 0.5, margin + (y + 1) * sq - 0.5]
                      for y in range(bh - 1) for x in range(bw - 1)])
    frames = np.empty(shape, np.uint8)
    truth = {"qr": text, "ean": ean, "markers": [], "charuco": []}
    x_lo, x_hi = 470 * s, W - 20 * s
    cols, rows = MARKER_SLOTS
    sw, shh = (x_hi - x_lo) / cols, (H - 40 * s) / rows
    for i in range(N):
        tint = rng.uniform(-8, 8, 3)
        bg = BACKGROUND[0] + BACKGROUND[1] * _smooth_noise(rng, H, W, 40.0 * s)
        f = np.clip(bg[..., None] + tint + rng.normal(0, 1.5, (H, W, 3)), 0, 255)
        f = np.rint(f).astype(np.uint8)
        # the ChArUco board, top left, nearly square to the camera
        bc = (40 * s + board_img.shape[1] / 2, 30 * s + board_img.shape[0] / 2)
        Hb = _placement(rng, *board_img.shape, bc, 1.0, 4.0, 0.02)
        _paste(f, _print(board_img), Hb)
        truth["charuco"].append(_apply_h(Hb, inner))
        # the QR code and the EAN-13 code below it
        jit = rng.uniform(-10, 10, 2) * s
        Hq = _homography(_outline(*qr.shape), _outline(*qr.shape) + [60 * s, 640 * s] + jit)
        _paste(f, _print(qr), Hq)
        He = _homography(_outline(*ean_img.shape),
                         _outline(*ean_img.shape) + [40 * s, 900 * s] + jit)
        _paste(f, _print(ean_img), He)
        # the free markers, one per slot
        ids = rng.choice(np.arange(MARKER_FIRST_ID, len(d.bytesList)), cols * rows, replace=False)
        marks = []
        for k, mid in enumerate(ids):
            side = int(rng.integers(MARKER_SIDE[0], MARKER_SIDE[1] + 1) * s)
            q = max(2, round(MARKER_QUIET * s))
            patch = np.pad(aruco.generateImageMarker(d, int(mid), side), q, constant_values=255)
            ext = side * (np.cos(np.deg2rad(MARKER_TILT)) + np.sin(np.deg2rad(MARKER_TILT))
                          + 2 * MARKER_WARP) + 2 * q
            cx = x_lo + (k % cols + 0.5) * sw + rng.uniform(-1, 1) * max(0.0, sw - ext) / 2
            cy = 20 * s + (k // cols + 0.5) * shh + rng.uniform(-1, 1) * max(0.0, shh - ext) / 2
            Hm = _placement(rng, *patch.shape, (cx, cy), 1.0, MARKER_TILT, MARKER_WARP)
            _paste(f, _print(patch), Hm)
            corners = np.array([[q - 0.5, q - 0.5], [q + side - 0.5, q - 0.5],
                                [q + side - 0.5, q + side - 0.5], [q - 0.5, q + side - 0.5]])
            marks.append((int(mid), _apply_h(Hm, corners)))
        truth["markers"].append(marks)
        frames[i] = f
    # the colour chart: 6 x 4 patches on a dark ground
    chart = np.clip(30 + rng.integers(-2, 3, (H, W, 3)), 0, 255).astype(np.uint8)
    colours = rng.integers(40, 231, (24, 3))
    pw, ph = round(MCC_PATCH_PX[0] * s), round(MCC_PATCH_PX[1] * s)
    gap = round(MCC_GAP_PX * s)
    ox, oy = (W - 6 * pw - 5 * gap) // 2, (H - 4 * ph - 3 * gap) // 2
    for k, c in enumerate(colours):
        r, cc = divmod(k, 6)
        y0, x0 = oy + r * (ph + gap), ox + cc * (pw + gap)
        chart[y0:y0 + ph, x0:x0 + pw] = np.clip(c + rng.integers(-2, 3, (ph, pw, 3)), 0, 255)
    truth["chart_bgr"] = colours
    return frames, chart, truth


def qr_roi(H: int) -> tuple:
    """QR_ROI at an H-row frame."""
    s = H / 1080.0
    return tuple(int(round(v * s)) for v in QR_ROI)


def _qr_in(qr, roi, origin) -> tuple:
    """QRCodeDetector.detectAndDecode on a view of the frame; the points in
    the frame's coordinates."""
    text, pts, straight = qr.detectAndDecode(roi)
    if pts is not None:
        pts = pts + np.asarray(origin, np.float32)
    return text, pts, straight


@region("entry.forward_objdetect")
def forward_objdetect(frames, chart, det: dict, times: dict | None = None) -> dict:
    """Each frame through ArucoDetector.detectMarkers, CharucoDetector
    .detectBoard (its own marker pass), QRCodeDetector.detectAndDecode (on
    the frame's QR_ROI band), BarcodeDetector.detectAndDecode and HOGDescriptor.detectMultiScale at
    HOG_DETECT (samples/python/peopledetect.py's settings), then
    CCheckerDetector.process on the chart.  Returns per stage the frames'
    results; `times` (if given) gathers each stage's host-clock ms."""
    import time as _t
    out = {k: [] for k in OBJDETECT_STAGES}
    clock = {k: 0.0 for k in OBJDETECT_STAGES}
    x0, y0, x1, y1 = qr_roi(frames.shape[1])
    calls = (("aruco", lambda f: det["aruco"].detectMarkers(f)),
             ("charuco", lambda f: det["charuco"].detectBoard(f)),
             ("qr", lambda f: _qr_in(det["qr"], f[y0:y1, x0:x1], (x0, y0))),
             ("barcode", lambda f: det["barcode"].detectAndDecode(f)),
             ("hog", lambda f: det["hog"].detectMultiScale(f, **HOG_DETECT)))
    for f in frames:
        for name, fn in calls:
            t0 = _t.perf_counter()
            out[name].append(fn(f))
            clock[name] += (_t.perf_counter() - t0) * 1e3
    t0 = _t.perf_counter()
    ok = det["mcc"].process(chart, 0)
    best = det["mcc"].getBestColorChecker() if ok else None
    out["mcc"] = None if best is None else best.getChartsRGB().reshape(-1, 3)
    clock["mcc"] = (_t.perf_counter() - t0) * 1e3
    if times is not None:
        times.update(clock)
    return out


def objdetect_truth_report(out: dict, truth: dict) -> dict:
    """The path's results against the scene's truth: free markers missed
    (or with another id), their corners' largest error, the ChArUco corners'
    share found and largest error, the decoded texts, the chart's largest
    patch error."""
    missed, corner_err = 0, 0.0
    for (corners, ids, _), marks in zip(out["aruco"], truth["markers"]):
        found = {} if ids is None else {int(i): np.asarray(c).reshape(4, 2)
                                        for i, c in zip(np.ravel(ids), corners)}
        for mid, want in marks:
            if mid not in found:
                missed += 1
                continue
            corner_err = max(corner_err, float(np.abs(found[mid] - want).max()))
    share, ch_err = [], 0.0
    for (cc, ci, _, _), want in zip(out["charuco"], truth["charuco"]):
        if ci is None:
            share.append(0.0)
            continue
        got = np.asarray(cc).reshape(-1, 2)
        err = np.abs(got - want[np.ravel(ci)]).max(axis=1)
        share.append(float((err <= CHARUCO_CORNER_TOL).sum() / len(want)))
        ch_err = max(ch_err, float(err.max()))
    qr_ok = sum(t == truth["qr"] for t, _, _ in out["qr"])
    ean_ok = sum(truth["ean"] in infos for _, infos, _, _ in out["barcode"])
    mcc = out["mcc"]
    mcc_err = (float("inf") if mcc is None
               else float(np.abs(mcc - truth["chart_bgr"][:, ::-1]).max()))
    n = len(truth["markers"])
    return {"markers": sum(len(m) for m in truth["markers"]), "markers_missed": missed,
            "marker_corner_err": corner_err, "charuco_min_share": min(share),
            "charuco_corner_err": ch_err, "qr_decoded": qr_ok, "ean_decoded": ean_ok,
            "frames": n, "mcc_err": mcc_err,
            "ok": (missed == 0 and corner_err <= MARKER_CORNER_TOL
                   and min(share) >= CHARUCO_MIN_SHARE and qr_ok == n and ean_ok == n
                   and mcc_err <= MCC_TOL)}


# ---------------------------------------------------------------------------
# RGB-D fusion: KinectFusion's volume, ICP odometry and the rasterizer
# ---------------------------------------------------------------------------

SHAPE_FUSION = (30, 480, 640)       # frames, rows, columns
# cv::kinfu::Params::defaultParams() (opencv_contrib modules/rgbd/src/kinfu.cpp)
FUSION_F, FUSION_CX, FUSION_CY = 525.0, 319.5, 239.5
FUSION_RES = 512                    # voxels a side
FUSION_SIZE_M = 3.0                 # the volume's side
FUSION_POSE_T = (-1.5, -1.5, 0.5)   # the volume's corner in the first camera's frame
FUSION_TRUNC_VOXELS = 7
FUSION_MAX_WEIGHT = 64
FUSION_STEP_FACTOR = 0.25
FUSION_ICP_ITERS = (10, 5, 4)
# the cut: u16 millimetres (Kinect's and RealSense's z16 streams), not
# kinfu's 5000 for TUM PNGs; the JAX package's integrate reads 1000 only
FUSION_DEPTH_FACTOR = 1000.0
FUSION_STEP_M, FUSION_STEP_DEG = 0.01, 0.5   # the camera's motion a frame
FUSION_Z = (0.1, 10.0)              # the rasterizer's near and far planes
FUSION_STAGES = ("render", "odometry", "integrate", "raycast", "fetch")
# the truth gates (fusion_truth_report): the last chained pose within these
# of the trajectory's, and the raycast's depth within FUSION_DEPTH_TOL of the
# rendered depth on FUSION_DEPTH_SHARE of the pixels valid in both
FUSION_POSE_TOL_M, FUSION_POSE_TOL_DEG = 0.02, 1.0
FUSION_DEPTH_TOL, FUSION_DEPTH_SHARE = 0.01, 0.95
GL_FLIP = np.diag([1.0, -1.0, -1.0, 1.0])   # the rasterizer's camera looks down -z, y up


def fusion_intrinsics(W: int = 640, H: int = 480) -> np.ndarray:
    """kinfu's intrinsics scaled to a W x H frame."""
    s = W / 640.0
    return np.array([[FUSION_F * s, 0, (W - 1) / 2.0], [0, FUSION_F * s, (H - 1) / 2.0], [0, 0, 1]])


def fusion_settings(res: int = FUSION_RES, W: int = 640, H: int = 480) -> tuple:
    """(VolumeSettings, OdometrySettings) at kinfu's defaults: a res³ volume
    of FUSION_SIZE_M posed at FUSION_POSE_T, truncation at 7 voxels, weight
    64, raycast step 0.25 voxels, ICP iterations {10, 5, 4}."""
    from .threed.tsdf import OdometrySettings, VolumeSettings
    K = fusion_intrinsics(W, H)
    vs = VolumeSettings()
    vs.setVoxelSize(FUSION_SIZE_M / res)
    vs.setVolumeResolution((res, res, res))
    pose = np.eye(4)
    pose[:3, 3] = FUSION_POSE_T
    vs.setVolumePose(pose)
    vs.setTsdfTruncateDistance(FUSION_TRUNC_VOXELS * FUSION_SIZE_M / res)
    vs.setMaxWeight(FUSION_MAX_WEIGHT)
    vs.setRaycastStepFactor(FUSION_STEP_FACTOR)
    vs.setDepthFactor(FUSION_DEPTH_FACTOR)
    vs.setCameraIntegrateIntrinsics(K)
    vs.setIntegrateWidth(W)
    vs.setIntegrateHeight(H)
    os_ = OdometrySettings()
    os_.setCameraMatrix(K)
    os_.setIterCounts(list(FUSION_ICP_ITERS))
    return vs, os_


def _quad(a, b, c, d) -> tuple:
    return [a, b, c, d], [(0, 1, 2), (0, 2, 3)]


def make_room_mesh(seed: int = 0) -> tuple:
    """A room in the first camera's frame (x right, y down, z forward): back
    wall, floor, ceiling and side walls, three boxes on the floor and a
    sphere, all inside the volume; (vertices (V, 3) float64, triangles (T,
    3) int32), under 1,000 triangles."""
    rng = np.random.default_rng(seed)
    V, T = [], []

    def add(verts, tris):
        base = len(V)
        V.extend(verts)
        T.extend([(base + i, base + j, base + k) for i, j, k in tris])

    x0, x1, y0, y1, z0, z1 = -1.35, 1.35, -1.25, 1.2, 0.6, 3.2
    add(*_quad((x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1)))   # back wall
    add(*_quad((x0, y1, z0), (x1, y1, z0), (x1, y1, z1), (x0, y1, z1)))   # floor
    add(*_quad((x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1)))   # ceiling
    add(*_quad((x0, y0, z0), (x0, y1, z0), (x0, y1, z1), (x0, y0, z1)))   # left wall
    add(*_quad((x1, y0, z0), (x1, y1, z0), (x1, y1, z1), (x1, y0, z1)))   # right wall
    faces = [(0, 1, 2), (0, 2, 3), (4, 6, 5), (4, 7, 6), (0, 4, 5), (0, 5, 1),
             (1, 5, 6), (1, 6, 2), (2, 6, 7), (2, 7, 3), (3, 7, 4), (3, 4, 0)]
    for bx, bz in ((-0.8, 2.4), (0.7, 2.6), (0.2, 1.9)):
        w, h, d = rng.uniform(0.25, 0.55, 3)
        a = rng.uniform(0, np.pi / 2)
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        c = np.array([[sx * w / 2, sy, sz * d / 2] for sy in (y1 - h, y1)
                      for sx, sz in ((-1, -1), (1, -1), (1, 1), (-1, 1))])
        c[:, 1] = np.repeat([y1 - h, y1], 4)
        add([tuple(p) for p in c @ R.T + [bx, 0, bz]], faces)
    r, (sx, sz) = 0.3, (-0.2, 2.7)
    st, sl = 12, 24
    verts = [(sx + r * np.sin(np.pi * i / st) * np.cos(2 * np.pi * j / sl),
              y1 - r - 0.2 + r * np.cos(np.pi * i / st),
              sz + r * np.sin(np.pi * i / st) * np.sin(2 * np.pi * j / sl))
             for i in range(st + 1) for j in range(sl)]
    tris = [t for i in range(st) for j in range(sl)
            for t in (((i * sl + j), (i + 1) * sl + j, (i + 1) * sl + (j + 1) % sl),
                      ((i * sl + j), (i + 1) * sl + (j + 1) % sl, i * sl + (j + 1) % sl))]
    add(verts, tris)
    return np.asarray(V, np.float64), np.asarray(T, np.int32)


def _rot(axis, deg: float) -> np.ndarray:
    k = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    a = np.deg2rad(deg)
    return np.eye(3) + np.sin(a) * Kx + (1 - np.cos(a)) * Kx @ Kx


def make_rgbd_scene(shape=SHAPE_FUSION, seed: int = 0) -> dict:
    """The room of make_room_mesh and a camera trajectory of shape[0]
    camera-to-world poses (the first the identity; each step moves
    FUSION_STEP_M and turns FUSION_STEP_DEG about a slowly turning axis),
    with the rasterizer's projection set to kinfu's intrinsics: fovY =
    2·atan((H/2)/f) gives f, and the principal point is ((W-1)/2, (H-1)/2)."""
    n, H, W = shape
    rng = np.random.default_rng(seed)
    verts, tris = make_room_mesh(seed)
    K = fusion_intrinsics(W, H)
    poses = [np.eye(4)]
    axis, move = rng.normal(size=3), rng.normal(size=3)
    for _ in range(n - 1):
        axis = axis + 0.3 * rng.normal(size=3)
        move = move + 0.3 * rng.normal(size=3)
        step = np.eye(4)
        step[:3, :3] = _rot(axis, FUSION_STEP_DEG)
        step[:3, 3] = FUSION_STEP_M * move / np.linalg.norm(move)
        poses.append(poses[-1] @ step)
    return {"verts": verts, "tris": tris, "poses": np.stack(poses), "K": K,
            "fovY": 2.0 * np.arctan((H / 2.0) / K[1, 1]), "size": (W, H)}


def render_depth(scene: dict, pose: np.ndarray, device="cuda") -> torch.Tensor:
    """triangleRasterizeDepth of the room seen from camera-to-world `pose`,
    (H, W) float32 metres on `device`, FUSION_Z[1] where nothing is hit."""
    from .threed.rasterize import (RASTERIZE_CULLING_NONE, TriangleRasterizeSettings,
                                   triangleRasterizeDepth)
    W, H = scene["size"]
    buf = torch.full((H, W), FUSION_Z[1], dtype=torch.float32, device=device)
    st = TriangleRasterizeSettings().setCullingMode(RASTERIZE_CULLING_NONE)
    return triangleRasterizeDepth(scene["verts"], scene["tris"], buf,
                                  GL_FLIP @ np.linalg.inv(pose), scene["fovY"], FUSION_Z[0],
                                  FUSION_Z[1], st)


def depth_to_u16(depth: torch.Tensor) -> torch.Tensor:
    """Rendered metres as a z16 stream: millimetres rounded, 0 where no
    surface was hit."""
    mm = torch.round(depth.to(torch.float64) * FUSION_DEPTH_FACTOR).to(torch.int32)
    return torch.where(depth < FUSION_Z[1], mm, 0).to(torch.uint16)


@region("entry.forward_fusion")
def forward_fusion(scene: dict, volume, odometry, device="cuda", times: dict | None = None) -> dict:
    """KinectFusion's loop over the trajectory: each frame rendered on
    `device` and sent as u16 millimetres, Odometry.compute of each frame
    against the one before (the poses chained), Volume.integrate of each
    frame at its chained pose, then raycast at the last pose and
    fetchPointsNormals.  Returns the depths, the chained poses, the raycast
    points and normals and the point cloud; `times` (if given) gathers each
    stage's host-clock ms (each stage synchronised)."""
    import time as _t
    from .threed.depth import rescaleDepth
    clock = {k: 0.0 for k in FUSION_STAGES}
    dev = torch.device(device)

    def timed(name, fn):
        t0 = _t.perf_counter()
        r = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        clock[name] += (_t.perf_counter() - t0) * 1e3
        return r

    depths = timed("render", lambda: torch.stack([depth_to_u16(render_depth(scene, p, dev))
                                                   for p in scene["poses"]]))
    poses = [np.eye(4)]
    metres = [rescaleDepth(d) for d in depths]
    for k in range(len(depths)):
        if k:
            # src = frame k, dst = frame k-1: T takes frame k's points to k-1's
            _, T = timed("odometry", lambda: odometry.compute(metres[k], metres[k - 1]))
            poses.append(poses[-1] @ T)
        timed("integrate", lambda: volume.integrate(depths[k], poses[k]))
    points, normals = timed("raycast", lambda: volume.raycast(poses[-1]))
    cloud, _ = timed("fetch", lambda: volume.fetchPointsNormals())
    if times is not None:
        times.update(clock)
    return {"depths": depths, "poses": np.stack(poses), "points": points, "normals": normals,
            "cloud": cloud}


def fusion_truth_report(out: dict, scene: dict) -> dict:
    """The chained pose against the trajectory's last pose (translation m,
    rotation degrees), and the raycast's depth (its points seen from the
    chained pose) against the last rendered depth on the pixels valid in
    both."""
    from .core.arrays import to_host
    est, true = out["poses"][-1], scene["poses"][-1]
    dt = float(np.linalg.norm(est[:3, 3] - true[:3, 3]))
    dR = est[:3, :3].T @ true[:3, :3]
    deg = float(np.rad2deg(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))))
    p = to_host(out["points"])[..., :3].astype(np.float64)
    w2c = np.linalg.inv(est)
    z = p @ w2c[2, :3] + w2c[2, 3]
    d = to_host(out["depths"][-1]).astype(np.float64) / FUSION_DEPTH_FACTOR
    valid = np.isfinite(z) & (d > 0)
    err = np.abs(z - d)[valid]
    share = float((err <= FUSION_DEPTH_TOL).mean()) if err.size else 0.0
    return {"pose_err_m": dt, "pose_err_deg": deg, "depth_share": share,
            "valid": int(valid.sum()), "raycast_hits": int(np.isfinite(z).sum()),
            "depth_median_err": float(np.median(err)) if err.size else float("inf"),
            "ok": (dt <= FUSION_POSE_TOL_M and deg <= FUSION_POSE_TOL_DEG
                   and share >= FUSION_DEPTH_SHARE)}


# ---------------------------------------------------------------------------
# the object-detection models whose published files the repository lacks:
# a Haar cascade and YuNet / SFace graphs made from a seed
# ---------------------------------------------------------------------------

CASCADE_WINDOW = 24
CASCADE_STAGES = 12


def haar_cascade_xml(seed: int = 0, stages: int = CASCADE_STAGES) -> str:
    """A Haar cascade in OpenCV's (new) XML format with random stumps over
    edge, line and tilted features of a 24 x 24 window: each stump splits
    near 0 with leaves -a and +a, and each stage passes the windows whose
    votes sum above 0 (on the objdetect path's frames a few of a million
    windows pass all 12 stages)."""
    rng = np.random.default_rng(seed)
    n = CASCADE_WINDOW
    feats, xml_stages = [], []
    for st in range(stages):
        k = 2 if st == 0 else int(rng.integers(3, 7))
        weak = []
        for _ in range(k):
            kind = ("edge", "line", "tilted")[int(rng.integers(0, 3))]
            if kind == "tilted":
                w, h = (int(v) for v in rng.integers(2, 7, 2))
                x = int(rng.integers(h, n - w + 1))
                y = int(rng.integers(0, n - w - h + 1))
                rects = [(x, y, w, h, -1.0), (x, y, w, max(1, h // 2), 2.0)]
            else:
                w, h = (int(v) for v in rng.integers(4, 12, 2)) if kind == "edge" else \
                    (3 * int(rng.integers(2, 5)), int(rng.integers(3, 10)))
                x, y = int(rng.integers(0, n - w + 1)), int(rng.integers(0, n - h + 1))
                rects = ([(x, y, w, h, -1.0), (x, y, w // 2, h, 2.0)] if kind == "edge" else
                         [(x, y, w, h, -1.0), (x + w // 3, y, w // 3, h, 3.0)])
            feats.append((rects, kind == "tilted"))
            a = float(rng.uniform(0.5, 1.0))
            weak.append(f"<_><internalNodes>0 -1 {len(feats) - 1} "
                        f"{rng.uniform(-0.002, 0.002):.6e}</internalNodes>"
                        f"<leafValues>{-a:.6e} {a:.6e}</leafValues></_>")
        xml_stages.append(f"<_><maxWeakCount>{k}</maxWeakCount><stageThreshold>0.0"
                          f"</stageThreshold><weakClassifiers>{''.join(weak)}</weakClassifiers>"
                          f"</_>")
    xml_feats = "".join(
        "<_><rects>" + "".join(f"<_>{x} {y} {w} {h} {wt:.1f}</_>" for x, y, w, h, wt in rects)
        + f"</rects><tilted>{int(tilted)}</tilted></_>" for rects, tilted in feats)
    return ('<?xml version="1.0"?>\n<opencv_storage>\n<cascade type_id="opencv-cascade-'
            'classifier"><stageType>BOOST</stageType><featureType>HAAR</featureType>'
            f"<height>{n}</height><width>{n}</width><stageParams><maxWeakCount>6"
            "</maxWeakCount></stageParams><featureParams><maxCatCount>0</maxCatCount>"
            f"<featSize>1</featSize><mode>ALL</mode></featureParams><stageNum>{stages}"
            f"</stageNum><stages>{''.join(xml_stages)}</stages><features>{xml_feats}"
            "</features></cascade>\n</opencv_storage>\n")


def face_models(seed: int = 0, size=(96, 96)) -> dict:
    """{"yunet": bytes, "sface": bytes}: ONNX graphs of YuNet's and SFace's
    interfaces with random weights (the port's codec; no google.protobuf).
    YuNet's: for strides 8, 16 and 32 an average pool of the input and 1x1
    convolutions into its 12 heads cls_/obj_/bbox_/kps_{8,16,32}, shaped
    (1, rows * cols, C); SFace's: one 112 x 112 convolution into a
    16-float embedding."""
    from .dnn import _proto
    S = _proto.schema("onnx_schema")
    T = functools.partial(_onnx_tensor, S)
    N = functools.partial(_onnx_node, S)
    M = functools.partial(_onnx_model, S)
    W, H = size
    rng = np.random.default_rng(seed)
    nodes, inits, outs = [], [], []
    for s in (8, 16, 32):
        nodes.append(N("AveragePool", ["input"], [f"p{s}"], kernel_shape=[s, s], strides=[s, s]))
        for name, ch, sig, std in (("cls", 1, True, 0.4), ("obj", 1, True, 0.4),
                                   ("bbox", 4, False, 0.003), ("kps", 10, False, 0.01)):
            inits += [T(f"w_{name}_{s}", rng.normal(0, std, (ch, 3, 1, 1)).astype(np.float32)),
                      T(f"b_{name}_{s}", rng.normal(0, std, (ch,)).astype(np.float32)),
                      T(f"shape_{name}_{s}", np.asarray([1, -1, ch], np.int64))]
            act = f"{name}_{s}_conv"
            nodes.append(N("Conv", [f"p{s}", f"w_{name}_{s}", f"b_{name}_{s}"], [act],
                           kernel_shape=[1, 1], strides=[1, 1], pads=[0, 0, 0, 0]))
            if sig:
                nodes.append(N("Sigmoid", [act], [f"{name}_{s}_sig"]))
                act = f"{name}_{s}_sig"
            nodes += [N("Transpose", [act], [f"{name}_{s}_tr"], perm=[0, 2, 3, 1]),
                      N("Reshape", [f"{name}_{s}_tr", f"shape_{name}_{s}"], [f"{name}_{s}"])]
            outs.append((f"{name}_{s}", (1, (H // s) * (W // s), ch)))
    yunet = M([("input", (1, 3, H, W))], outs, nodes, inits)
    sface = M([("input", (1, 3, 112, 112))], [("emb", (1, 16))],
              [N("Conv", ["input", "w"], ["emb4"], kernel_shape=[112, 112], strides=[1, 1],
                 pads=[0, 0, 0, 0]),
               N("Reshape", ["emb4", "shape"], ["emb"])],
              [T("w", rng.normal(0, 0.1, (16, 3, 112, 112)).astype(np.float32)),
               T("shape", np.asarray([1, 16], np.int64))])
    return {"yunet": yunet.SerializeToString(), "sface": sface.SerializeToString()}


# ---------------------------------------------------------------------------
# the stabilisation path: videostab's OnePassStabilizer over a shaking camera
# ---------------------------------------------------------------------------

VIDEOSTAB_RADIUS = 15                  # OnePassStabilizer's default
# 2 * radius + 1 frames of make_motion_video: the middle frame's correction
# sees the whole Gaussian window
SHAPE_VIDEOSTAB = (2 * VIDEOSTAB_RADIUS + 1, 1080, 1920, 3)
VIDEOSTAB_STAGES = ("gray",) + STABILIZE_STAGES
# the frames' margin left out of the jitter measure, px (test_video.py's 20)
VIDEOSTAB_CROP = 20
# the stabilised jitter's std must be under the input's over this
VIDEOSTAB_JITTER_GAIN = 2.5


@region("entry.forward_videostab")
def forward_videostab(frames, radius: int = VIDEOSTAB_RADIUS, times: dict | None = None) -> dict:
    """The (N, H, W, 3) u8 BGR `frames` turned to gray on their device, then
    ``videostab.OnePassStabilizer(radius)``: GFTT (300 corners) and LK of
    each consecutive pair (three pyrDown levels of the pair each, through
    ``pyr_down``), the similarity RANSAC and the Gaussian motion filter on
    the host, and warpAffine of each frame by its correction
    (BORDER_REPLICATE) on the frames' device.  Returns the gray frames, the
    inter-frame motions (host 3x3), the corrections and the (N, H, W)
    stabilised frames; `times` (if given) gathers the host-clock ms of
    :data:`VIDEOSTAB_STAGES`."""
    import time as _t
    t0 = _t.perf_counter()
    gray = cvtColor(frames, K.COLOR_BGR2GRAY)[..., 0]
    if times is not None:
        if gray.device.type == "cuda":
            torch.cuda.synchronize(gray.device)
        times["gray"] = (_t.perf_counter() - t0) * 1e3
    stab = OnePassStabilizer(radius)
    out = stab.stabilize(gray.unbind(0), times)
    n = len(out)
    return {"gray": gray, "motions": np.stack(stab.motions),
            "corrections": np.stack([stab.filter.stabilize(i, stab.motions, (0, n))
                                     for i in range(n)]),
            "stabilized": torch.stack(out)}


def entry_videostab(device="cuda", shape=SHAPE_VIDEOSTAB):
    """``(forward_videostab, (frames,))`` with ``make_motion_video(shape)``'s
    frames on `device`."""
    return forward_videostab, (torch.from_numpy(make_motion_video(shape)[0]).to(device),)


def motion_translation(M, shape) -> np.ndarray:
    """The displacement of a 3x3 motion at the centre of an (H, W) frame, px
    (x, y): a similarity's translation as the frame's middle sees it."""
    H, W = shape[:2]
    c = np.array([(W - 1) / 2.0, (H - 1) / 2.0, 1.0])
    return (np.asarray(M, np.float64) @ c)[:2] - c[:2]


def jitter_std(seq, crop: int = VIDEOSTAB_CROP) -> float:
    """The std of the frame-to-frame shift magnitudes of an (N, H, W)
    sequence (``phaseCorrelate`` of each consecutive pair, its margin of
    `crop` px left out), as tests/test_video.py measures jitter."""
    s = as_tensor(seq)[:, crop:-crop, crop:-crop].to(torch.float32)
    shifts, _ = phase_correlate_batch(s[:-1], s[1:])
    return float(torch.hypot(shifts[:, 0], shifts[:, 1]).cpu().numpy().std())


def videostab_truth_report(out: dict, shifts, shape) -> dict:
    """forward_videostab's outputs against make_motion_video's ``shifts``:
    ``translation_err``, the largest |displacement at the frame's centre of
    each inter-frame motion − (shifts[i+1] − shifts[i])| per axis, px; the
    input's and the stabilised jitter (:func:`jitter_std`) and their
    ratio."""
    sh = np.asarray(shifts, np.float64)
    err = max(float(np.abs(motion_translation(M, shape[1:3]) - (sh[i + 1] - sh[i])).max())
              for i, M in enumerate(out["motions"]))
    j_in, j_out = jitter_std(out["gray"]), jitter_std(out["stabilized"])
    return {"translation_err": err, "jitter_in": j_in, "jitter_out": j_out,
            "jitter_gain": j_in / j_out if j_out > 0 else float("inf")}


# ---------------------------------------------------------------------------
# the JPEG-in, PNG-out path: decode on the host, the flagship on the card,
# encode on the host
# ---------------------------------------------------------------------------

SHAPE_CODEC = (8, 1080, 1920, 3)
CODEC_STAGES = ("decode", "upload", "forward", "readback", "encode")
# each decoded frame's PSNR against its source, dB: the CPU measures 41.908 -
# 41.913 on make_motion_video's 1080p frames 0 and 7 at imencode('.jpg')'s
# defaults (tests/test_torch_slice_codec.py); the gate takes the margin off
CODEC_PSNR_DB = 41.90
CODEC_PSNR_MARGIN_DB = 0.1


def make_codec_frames(shape=SHAPE_CODEC, seed: int = 0):
    """``make_motion_video(shape)``'s frames and each one's JPEG as
    ``imencode('.jpg')`` writes it at its defaults (quality 95, 4:2:0):
    ``(frames, jpegs)``, the JPEGs as bytes."""
    from .imgcodecs import imencode
    frames = make_motion_video(shape, seed)[0]
    return frames, [imencode(".jpg", f)[1].tobytes() for f in frames]


@region("entry.forward_codec")
def forward_codec(jpegs, device="cuda", times: dict | None = None) -> dict:
    """JPEG in, PNG out: ``imdecode`` of each of the `jpegs` on the host, one
    copy of the (N, H, W, 3) batch to `device` (through pinned memory to a
    card), :func:`forward` (the flagship: gray, GaussianBlur 5x5 through
    ``sep_filter``, the half-size resize, warpAffine), one read-back, and
    ``imencode('.png')`` of each (H/2, W/2) output.  Returns the decoded
    frames, the forward's output on `device`, its host copy and the PNGs;
    `times` (if given) gathers the host-clock ms of :data:`CODEC_STAGES`."""
    import time as _t
    from .imgcodecs import IMREAD_COLOR, imdecode, imencode
    dev = torch.device(device)
    clock = {}

    def lap(name, t0):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t = _t.perf_counter()
        clock[name] = (t - t0) * 1e3
        return t

    t = _t.perf_counter()
    decoded = np.stack([imdecode(np.frombuffer(b, np.uint8), IMREAD_COLOR) for b in jpegs])
    t = lap("decode", t)
    x = to_device(decoded, dev)
    t = lap("upload", t)
    y = forward(x)
    t = lap("forward", t)
    host = y[..., 0].cpu().numpy()
    t = lap("readback", t)
    pngs = [imencode(".png", o)[1].tobytes() for o in host]
    lap("encode", t)
    if times is not None:
        times.update(clock)
    return {"decoded": decoded, "out": y, "host": host, "pngs": pngs}


def psnr(a, b) -> float:
    """PSNR of two u8 arrays of one shape, dB (inf where equal)."""
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


# ---------------------------------------------------------------------------
# the video-file path: a HuffYUV AVI in through VideoCapture, the flagship on
# the card with its parameters from a FileStorage YAML, an FFV1 AVI out
# through VideoWriter
# ---------------------------------------------------------------------------

SHAPE_VIDEOIO = (8, 1080, 1920, 3)
VIDEOIO_STAGES = ("read", "upload", "forward", "readback", "write")
VIDEOIO_FPS = 25.0


def make_videoio_files(dirpath, shape=SHAPE_VIDEOIO, seed: int = 0):
    """Write the video-file path's two inputs into `dirpath` and return their
    paths ``(in_path, params_path)``:

    - ``in.avi``: ``make_motion_video(shape, seed)``'s frames through
      ``VideoWriter`` with fourcc HFYU (HuffYUV, lossless) at
      :data:`VIDEOIO_FPS`;
    - ``params.yml``: a ``FileStorage`` YAML of the flagship's parameters:
      ``ksize`` [5, 5] and ``dsize`` [W/2, H/2] (1 x 2 CV_32S matrices),
      ``M`` = ``getRotationMatrix2D((W/4, H/4), 15, 0.9)`` (2 x 3 CV_64F),
      ``fourcc_out`` FFV1 and ``fps``."""
    import os
    from .persistence import FILE_STORAGE_WRITE, FileStorage
    from .videoio import VideoWriter, VideoWriter_fourcc
    N, H, W, _ = shape
    in_path = os.path.join(str(dirpath), "in.avi")
    params_path = os.path.join(str(dirpath), "params.yml")
    wr = VideoWriter(in_path, VideoWriter_fourcc(*"HFYU"), VIDEOIO_FPS, (W, H))
    for f in make_motion_video(shape, seed)[0]:
        wr.write(f)
    wr.release()
    fs = FileStorage(params_path, FILE_STORAGE_WRITE)
    fs.write("ksize", np.array([[5, 5]], np.int32))
    fs.write("dsize", np.array([[W // 2, H // 2]], np.int32))
    fs.write("M", getRotationMatrix2D((W / 4, H / 4), 15.0, 0.9))
    fs.write("fourcc_out", "FFV1")
    fs.write("fps", VIDEOIO_FPS)
    fs.release()
    return in_path, params_path


@region("entry.forward_videoio")
def forward_videoio(in_path, params_path, out_path, device="cuda",
                    times: dict | None = None) -> dict:
    """A video file in, a video file out, the flagship between them:

    1. ``FileStorage(params_path, READ)`` reads the run's parameters;
    2. ``VideoCapture(in_path)``'s frame count, width, height and FPS are
       checked against them (the frame twice ``dsize``, the YAML's ``fps``);
    3. ``read()`` runs until it returns False, and the frames are stacked;
    4. one copy of the (N, H, W, 3) batch to `device` (pinned, to a card);
    5. cvtColor BGR2GRAY → GaussianBlur(ksize) (``sep_filter`` k5 once on a
       card) → resize(dsize) → warpAffine(M, dsize): :func:`forward`'s
       chain with the YAML's values;
    6. one read-back;
    7. ``VideoWriter(out_path, fourcc_out, fps, dsize, isColor=False)``
       writes each output frame, then ``release()``;
    8. ``imshow("videoio", last)`` of the last output and ``waitKey(1)``.

    Returns the decoded frames, the output on `device` (N, H/2, W/2, 1), its
    host copy (N, H/2, W/2) and the parameters; `times` (if given) gathers
    the host-clock ms of :data:`VIDEOIO_STAGES`."""
    import time as _t
    from .highgui import imshow, waitKey
    from .persistence import FILE_STORAGE_READ, FileStorage
    from .videoio import (CAP_PROP_FPS, CAP_PROP_FRAME_COUNT, CAP_PROP_FRAME_HEIGHT,
                          CAP_PROP_FRAME_WIDTH, VideoCapture, VideoWriter, VideoWriter_fourcc)
    dev = torch.device(device)
    clock = {}

    def lap(name, t0):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t = _t.perf_counter()
        clock[name] = (t - t0) * 1e3
        return t

    t = _t.perf_counter()
    fs = FileStorage(params_path, FILE_STORAGE_READ)
    params = {"ksize": tuple(int(v) for v in fs.getNode("ksize").mat().ravel()),
              "dsize": tuple(int(v) for v in fs.getNode("dsize").mat().ravel()),
              "M": fs.getNode("M").mat(),
              "fourcc_out": fs.getNode("fourcc_out").string(),
              "fps": fs.getNode("fps").real()}
    fs.release()
    dw, dh = params["dsize"]
    cap = VideoCapture(in_path)
    want = {CAP_PROP_FRAME_WIDTH: 2 * dw, CAP_PROP_FRAME_HEIGHT: 2 * dh,
            CAP_PROP_FPS: params["fps"]}
    got = {p: cap.get(p) for p in want}
    n = int(cap.get(CAP_PROP_FRAME_COUNT))
    if not cap.isOpened() or got != want or n < 1:
        raise ValueError(f"{in_path}: {n} frames, properties {got}; the parameters want {want}")
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    if len(frames) != n:
        raise ValueError(f"{in_path}: {len(frames)} frames read of {n}")
    decoded = np.stack(frames)
    t = lap("read", t)
    x = to_device(decoded, dev)
    t = lap("upload", t)
    g = cvtColor(x, K.COLOR_BGR2GRAY)
    b = GaussianBlur(g, params["ksize"], 0)
    y = warpAffine(resize(b, params["dsize"]), params["M"], params["dsize"])
    t = lap("forward", t)
    host = y[..., 0].cpu().numpy()
    t = lap("readback", t)
    wr = VideoWriter(out_path, VideoWriter_fourcc(*params["fourcc_out"]), params["fps"],
                     params["dsize"], isColor=False)
    for o in host:
        wr.write(o)
    wr.release()
    imshow("videoio", host[-1])
    waitKey(1)
    lap("write", t)
    if times is not None:
        times.update(clock)
    return {"decoded": decoded, "out": y, "host": host, "params": params}
