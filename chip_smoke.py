#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``opencv_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, and no result line):

1. device: a CUDA device is present; prints nvidia-smi's name and power limit;
2. build: compiles the CUDA kernels from ``opencv_tpu_torch/csrc`` (nvcc),
   prints what ``ptxas -v`` said of sep_filter's kernels (registers, spills)
   and fails if an instantiation of its template spills;
3. kernels: each kernel (sep_filter, gauss5_down2, pyr_down) equals its
   plain PyTorch version bit for bit (``torch.equal``) on the whole batch at
   the main paths' shapes, with the taps and borders those paths give it
   (sep_filter's template at K = 7 at each of ORB's 8 level shapes too, and
   pyr_down with C = 3 at the segmentation path's two shapes, and at the
   video path's: N = 2 at 1080p and its three LK levels, N = 8 at 1080p;
   gauss5_down2 at the stereo path's rectified pair, (2, 1080, 1920, 3);
   sep_filter's route k3 with C = 3 at the photo path's (1, 1071, 1911, 3),
   u8 -> i16, dx and dy under BORDER_REPLICATE), and on edge cases
   (borders, channel counts, odd and tiny sizes, rows of every width and
   offset views for the K = 7 template, k = 9 and 31 for
   the generic kernel; gauss5_down2's strip classes: 3W % 16 != 0, a base
   one byte off, W of a strip and a strip -/+ 2, a ragged last strip, H = 2
   and 4, N = 1 and 3, sigma 0, 0.1 (the identity taps), 1.5 and 20, plans
   of 1 and 3 blocks, and asymmetric taps refused);
4. main paths, each read with the launch counts set to 0 just before it:
   a. the flagship: ``entry("cuda")``'s forward and the fused forward on the
      (8, 1080, 1920, 3) batch; sep_filter and gauss5_down2 must have
      launched, the fused path must equal the composed one, and images 0 and
      1 must equal the CPU plain forward (exact before the warp; after it
      max |d| <= 1 on at most 0.1% of pixels, the warp tolerance of the
      tests);
   b. BASELINE config 3: ``entry_pyr_corner_edge("cuda")``'s forward
      (pyrDown, cornerHarris, Sobel, Canny) on the (8, 1080, 1920, 1) batch;
      pyr_down must have launched once and sep_filter at least 3 times, and
      on images 0 and 1 pyrDown, Sobel and Canny must equal the CPU plain
      forward exactly and cornerHarris be within HARRIS_RTOL/HARRIS_ATOL;
      then Canny on the batch smoothed by GaussianBlur 7x7 sigma 2.5 (one
      sep_filter launch, on route k7), exact against the CPU, with its
      hysteresis iterations and host syncs;
   c. BASELINE config 4: ``entry_match_morph("cuda")``'s forward
      (matchTemplate TM_CCOEFF_NORMED with a 32x32 template, erode 3x3,
      dilate 5x5, erode 9x9) on the (8, 1080, 1920, 1) batch, which launches
      none of the kernels (its ops are plain torch); its shapes, the morph
      outputs exactly and matchTemplate within MATCH_TOL against the CPU
      plain forward on images 0 and 1; a template cut from image 0 at
      (500, 900) found there with a score within MATCH_TOL of 1; and
      goodFeaturesToTrack on the smoothed image 0, on the card and on the
      CPU, whose corner sets must overlap by GFTT_OVERLAP;
   d. BASELINE config 5: ``entry_orb("cuda")``'s forward (ORB, nfeatures=500)
      on the (8, 1080, 1920) batch; sep_filter must have launched 8 times,
      all on route k7 (the 7x7 blur of each pyramid level), and no other
      kernel; on images 0
      and 1 the keypoints and descriptors are held to the CPU plain forward
      exactly (the same keypoints, responses, angles and descriptors);
      image 0's 8 levels (the LINEAR_EXACT resize, FAST's score and mask,
      the blur) equal the CPU's exactly; ``ORB.compute`` on the card at
      image 0's keypoints gives the forward's descriptors through 8
      sep_filter launches; and
      BFMatcher(NORM_HAMMING, crossCheck) on image 0's descriptors against
      image 1's gives the CPU's pairs and distances;
   e. BASELINE config 2: ``entry_resize_warp_4k("cuda")``'s forward (resize
      to 1920x1080 with LINEAR, AREA and CUBIC, warpAffine and
      warpPerspective at 3840x2160) on the (4, 2160, 3840, 3) batch, which
      launches none of the kernels (plain torch); its shapes, and on images
      0 and 1 the three resizes exactly and the two warps within the warp
      bound against the CPU plain forward;
   f. the decode-and-colour path: ``entry_decode_color("cuda")``'s forward
      (NV12 Y (8, 1080, 1920) and UV (8, 540, 960, 2) → cvtColorTwoPlane to
      BGR → HSV, Lab and YCrCb → the fused gray + blur + 2x AREA map →
      threshold BINARY | OTSU → integral), which must launch gauss5_down2
      once, through the dispatch registry (``tier.gauss5_down2_u8.cuda``),
      and no other kernel; on images 0 and 1 the card equals the CPU plain
      forward exactly in every u8 and int32 output, the Otsu threshold and
      the per-image sums, and the batch's own threshold equals the one the
      CPU takes from the batch's map, its binary map and integral of images
      0 and 1 equal to the CPU's at that threshold;
   g. the enhancement path: ``entry_enhance("cuda")``'s forward (gray →
      medianBlur 5 → CLAHE 2.0, 8x8 → the unsharp mask of GaussianBlur 5x5 →
      bilateralFilter 5, 50, 50 → the gamma LUT → applyColorMap JET, with the
      CLAHE output's histogram per image) on the (8, 1080, 1920, 3) batch,
      which must launch sep_filter once, on route k5, through the registry
      (``tier.sep_filter_u8.cuda``), and no other kernel; on images 0 and 1
      each stage, fed the card's own input to it, equals the CPU's on that
      input (a float stage, CLAHE, the unsharp mask or bilateralFilter, that
      is not exact prints how many pixels differ and by how much, and is held
      to the warp bound: max |d| <= 1 on at most 0.1% of pixels), and so do
      the histograms and the whole chain;
   h. the motion path: ``entry_motion("cuda")``'s forward (gray → GaussianBlur
      5x5 → the phase correlation of frames 1-7 against frame 0 under a
      Hanning window → warpAffine by minus each shift → an accumulateWeighted
      background → absdiff, threshold 25 and a 3x3 opening →
      connectedComponentsWithStats, distanceTransform L2 3x3 and binary
      moments of every frame → the last frame's contours) on
      ``make_motion_video()``'s (8, 1080, 1920, 3) frames, which must launch
      sep_filter once, on route k5, through the registry, and no other
      kernel; every recovered shift within MOTION_SHIFT_TOL px of the
      video's, and every object box of frames 1-7 overlapping a component of
      its frame; then the path on frames 0-2 on the card and on the CPU, each
      stage fed the card's own input to it and then the whole chain, within
      the bounds of ``motion_compare`` (shifts within 1e-6 px, u8 images,
      labels and stats exact, the background exact in f32, distances within
      1e-5, moments within rel 1e-12), printing the count and size of any
      difference; the contour stage runs the native scan
      (``native/hosttails.cpp``), which must equal its Python twin on the
      last frame's mask, and prints its host ms;
   i. the lane-and-sign path: ``entry_lines("cuda")``'s forward (gray →
      GaussianBlur 5x5 → Canny 50/150 → the Hough accumulator of every
      frame and HoughLinesP → HoughCircles of the blurred frames → fitLine
      of each half's segments → the line segment detector on frame 0 →
      drawing all of it on a copy of the frames) on ``make_road_video()``'s
      (8, 1080, 1920, 3) frames, which must launch sep_filter through the
      registry once on route k5 and 6 times on route k3 (the Sobels of the
      two Canny calls and of HoughCircles' gradient), and no other kernel;
      every marking edge of the video must have a segment within 3 px and
      2 degrees, and every circle a detection within 2 px (centre) and 3 px
      (radius); then frames 0-2 on the card and on the CPU, each stage fed
      the card's own input to it and then the whole chain, exact (LSD's
      prefilter, a float stage, prints how many pixels differ and is held to
      the warp bound; its segments then exact, or the same count within
      LSD_ATOL px); and a sweep of the slice's other public functions on
      small inputs, card against CPU (HoughLinesPointSet, the generalized
      Hough of Ballard and Guil, findContoursLinkRuns, filter2Dp,
      phaseCorrelateIterative, fitLine, and drawing on a card tensor);
   j. the cell-segmentation path: ``entry_segment("cuda")``'s forward (the
      colour correction of the cast camera → gray → GaussianBlur 5x5 → Otsu
      → a 3x3 opening x2 → the sure background (dilate x3) → the distance
      transform and the sure foreground → the markers → the native watershed
      of each frame in host threads → the cells' centroids and their
      Delaunay triangles → frame 0's background flood → frame 0's pyrDown,
      pyrMeanShiftFiltering (10, 10, 1) and grabCut of its largest cluster →
      EMD of the cells' grey histograms → the painted boundaries) on
      ``make_cells_video()``'s (8, 1080, 1920, 3) frames, which must launch
      sep_filter through the registry once on route k5 and pyr_down twice
      (C = 3), and no other kernel; every cell centre must lie in a
      watershed region that holds no other, the region count within 10% of
      the cells', frame 0's flood over 95% of the background and no cell's
      interior, and grabCut's IoU with the cells in its rect at least 0.85;
      then frames 0-1 on the card and on the CPU, each stage fed the card's
      own input to it and then the whole chain, within ``segment_compare``
      (exact but the corrected frames, held to the warp bound, the distances
      within 1e-5, and grabCut's mask on at most 0.01% of its pixels); and a
      sweep of the slice's other public functions, card against CPU
      (IntelligentScissorsMB's features on frame 0 in both edge modes and
      its paths on a crop, kmeans with each flag, floodFill on a float
      image, Subdiv2D's facets and locate, the model's getters), after the
      launch counts are read;
   k. the registration path: ``forward_register`` (gray → resize to the
      0.6 Mpx registration size, 1033x581, with INTER_LINEAR_EXACT → SIFT:
      the f32 Gaussian and DoG pyramids and the extremum masks on the card,
      one read-back through pinned memory, the host tails → FLANN kd-tree
      kNN (k = 2) of each consecutive pair → the ratio test d0 < 0.7 d1) on
      ``make_pan_video()``'s (8, 1080, 1920, 3) frames, which must launch no
      kernel; at least REGISTER_MIN_SHARE of the good pairs within
      REGISTER_TOL_PX of where the pan's true matrix sends them, and at
      least REGISTER_MIN_GOOD good pairs in every frame pair; then frames
      0-1 on the CPU: gray, the resize, every pyramid level and mask, the
      keypoints (pt, size, angle, response, octave), the descriptors and
      pair 0's kNN rows and good pairs equal the card's exactly;
   l. the mesh at world size 1: one NCCL rank on a ``FileStore`` in a
      temporary directory and a 1x1 ("data", "sp") mesh;
      ``spatial_gaussian_blur`` (zero border) and ``spatial_sep_filter``
      (REFLECT_101) on the flagship's gray (8, 1080, 1920, 1) batch must each
      launch sep_filter once, on route k5, and equal GaussianBlur 5x5 under
      the same border exactly; ``sharded_otsu`` must equal threshold's Otsu
      value and ``sharded_min_max`` / ``sharded_hist`` the single-card
      results; each function's wall (CUDA events) beside the single-card
      GaussianBlur; then the group is destroyed;
   m. the feature-tracking path: ``entry_track("cuda")``'s forward
      (``fusedPreprocessGrayBlurDown2`` to (8, 540, 960) → AKAZE's scale
      space, maxima masks, one read-back and host tails → BRISK's pyramid
      and AGAST on the card, NMS on the host, its reads and bits on the card
      → KAZE on frames 0-1 → per detector and frame pair kNN (k = 2) and the
      ratio test d0 < 0.8 d1) on the registration path's pan video, which
      must launch gauss5_down2 once (BGR route, through the registry) and
      no other kernel; for AKAZE and BRISK at least TRACK_MIN_SHARE of all
      good pairs within TRACK_TOL_PX of the pan's truth and at least
      TRACK_MIN_GOOD good pairs in every frame pair; then frames 0-1 on the
      CPU: the small frames, every AKAZE and KAZE level (Lt, Lx, Ly, Ldet)
      and AKAZE's masks, every BRISK layer with its score and keep maps,
      each detector's keypoints (pt, size, angle, response, octave,
      class_id) and descriptors, and pair 0's kNN rows and good pairs of
      each detector equal the card's exactly; the phase prints its wall;
   n. the video-analytics path: ``entry_video("cuda")``'s forward (gray →
      goodFeaturesToTrack on frame 0 → pyramidal LK of frame 0 to each
      later frame → the median shake and the frames aligned by it → MOG2 →
      one pyrDown of the gray batch and Farnebäck of half-size frame 0 to
      each later frame) on ``make_motion_video()``'s frames, which must
      launch pyr_down 22 times (LK's three levels of each pair, N = 2, and
      the batch's half) through the registry and no other kernel; the truth
      gates (VIDEO_*: the tracks, the shake, the dense flow, the masks);
      then frames 0-1 on the CPU, stage by stage on the card's own inputs:
      the corners overlap by GFTT_OVERLAP, pair (0, 1)'s tracks within
      VIDEO_LK_TOL px and its status equal on VIDEO_LK_SHARE of the
      points, the MOG2 masks of frames 0-1 exactly, Farnebäck's (0, 1) flow
      within VIDEO_FLOW_TOL px on VIDEO_FLOW_SHARE of the pixels, and the
      CPU's chain of frames 0-1 the same way; the phase prints its wall;
   o. the photo-finishing path: ``entry.forward_photo`` on
      ``make_bracket()``'s (3, 1080, 1920, 3) exposure bracket (AlignMTB →
      MergeMertens → fastNlMeansDenoisingColored 21x21 → detailEnhance →
      textureFlattening of the face → inpaint of the wire), which must
      launch sep_filter twice, both on route k3 (Canny's Sobels of the
      masked three-channel frame), through the registry, and no other
      kernel; the truth gates (PHOTO_*: AlignMTB's shifts undo the planted
      ones exactly, NL-means' PSNR gain, the face's flattening and the
      pixels outside it, the wire's fill); then a (3, 270, 480, 3) bracket
      on the card and on the CPU: the shifts and the aligned frames
      exactly, and each later stage on the card's own input on the CPU
      (inpaint exactly, the others within PHOTO_ATOL on PHOTO_SHARE of the
      values); the phase prints its wall;
   p. the stereo-depth path: ``entry.calibrate_rig`` on
      ``make_stereo_rig()``'s 12 chessboard pairs (findChessboardCorners
      and cornerSubPix on the 24 views, calibrateCamera per camera,
      stereoCalibrate, stereoRectify, the four maps on the card), then
      ``entry.forward_stereo`` on its (2, 1080, 1920, 3) scene pair (remap
      → the fused gray + blur + 2x map → StereoSGBM at half size → cvtColor
      and StereoBM at full size → filterSpeckles → reprojectImageTo3D),
      which must launch gauss5_down2 once (BGR, N = 2, through the
      registry) and no other kernel; the truth gates
      (``entry.STEREO_GATES``: the intrinsics, the baseline, the
      reprojection RMS, the rectified rows, both disparities against the
      scene's); then the card against the CPU: the first pair's corners,
      the rectified and half pairs, StereoSGBM on a band of the half pair
      and StereoBM, filterSpeckles and the depth on a band of the full
      pair, each exactly; the phase prints its wall against its budget;
   q. the detection path: ``entry.forward_detect`` on
      ``make_detect_frames()``' (8, 1080, 1920, 3) frames with
      ``make_detect_net(0)``'s full-width YOLOv3-tiny (Darknet's cfg, random
      weights from the seed, written as .cfg/.weights and read by
      ``readNetFromDarknet``): blobFromImages (1/255, 416x416, swapRB) →
      the net → each frame's DetectionModel.detect decode → NMSBoxesBatched
      (0.5, 0.4), which launches no kernel of csrc/ (its convolutions are
      cuDNN's, without TF32); it asserts that ``opencv_tpu_torch.dnn``
      imported without google.protobuf, that a box reaches NMS on every
      frame, and holds the card to the CPU's net on the card's blob: the
      heads within DETECT_HEAD_RTOL/ATOL, the kept boxes matched (corners
      within a pixel), a box kept on one device only allowed where its
      score or an IoU lies within DETECT_BAND of a threshold (counted and
      printed); it prints the stages' times (blob and net by CUDA events,
      decode and NMS on the host clock), the forward's busy share, host
      syncs and peak memory beside its FLOP and bytes bounds, and its wall
      against DETECT_WALL_BUDGET_S;
   r. ml on the card against the CPU: KNearest, NormalBayes,
      LogisticRegression and ANN_MLP at MNIST's shape (``ml_data()``:
      60,000 x 784 f32 samples from the seed, 10 classes, 10,000 queries;
      the card timed on all of it, and held to the CPU on the first
      ML_CPU_TRAIN samples and ML_CPU_QUERIES queries, trained arrays
      within ML_TRAIN_TOL, and a CPU model carried to the card by
      ``ml.carry.from_reference``); SVM, SVMSGD, EM and the trees, whose
      algorithms are host loops, at ML_HOST_N samples; and
      tests/assets/tiny_cnn.onnx read through the port's codec, card
      against CPU within 1e-5; no kernel of csrc/ launches; the phase's
      wall against ML_WALL_BUDGET_S;
   s. the stitching path: ``entry.forward_stitch`` (``Stitcher.create()
      .stitch``) over ``make_pan_video()``'s (8, 1080, 1920, 3) pan, 7 pairs
      chained into one panorama about 3,070 px wide; sep_filter must launch
      2 x 7 x 8 times on route k7 (ORB's blur of each level) and nothing
      else; the panorama's width within STITCH_WIDTH_TOL of the extent the
      pan's truth implies (``entry.pan_extent``); on the card's own
      panorama so far, each pair's homography from the CPU's ORB, matches
      and RANSAC equal to the card's exactly, and the first and last pair's
      panoramas within the warp bound; sep_filter k7 equal to its plain
      version at every level shape of the wider panoramas; the stages'
      times (ORB, match, homography, warp, distance, blend), busy share,
      host syncs and peak memory beside the path's bytes bound; the wall
      against PATH_WALL_BUDGET_S;
   t. G-API: ``entry.gapi_flagship()`` (the flagship chain with pyrDown of
      the gray frame as a second output) through ``gapi.Stream`` over
      GAPI_BATCHES batches of ``make_batch()``, then through
      ``deserialize_compiled(serialize_compiled(...))`` (``torch.export``;
      the kernels are custom ops); both outputs equal ``entry.forward`` and
      the eager pyrDown, live and loaded, and each run launches sep_filter
      k5 and pyr_down once a batch and nothing else; the Stream's wall
      against its copies and compute back to back; the wall against
      PATH_WALL_BUDGET_S;
   u. the DNN trackers: GOTURN at its published widths
      (``entry.goturn_files``: 113,748,740 parameters written as a
      .caffemodel by the port's codec), six trackers on
      ``make_motion_video()``'s frame 0 at its boxes, updated over frames
      1-7 (``entry.forward_track_dnn``, 42 updates); no kernel of csrc/
      launches; each update's output against the CPU's net on the card's
      blobs within GOTURN_RTOL of its largest value and each box within 1
      px of the CPU's; Nano, DaSiamRPN, Vit, DISK and ALIKED on
      ``entry.small_dnn_models()``, card against CPU, and LightGlue's raise
      (``entry.dnn_sweep``); the net's time by CUDA events beside its bytes
      and FLOP bounds, the path's busy share, host syncs and peak memory;
      the wall against PATH_WALL_BUDGET_S;
5. timing: CUDA events, median of 20 after warm-up, with L2 flushed between
   runs: each kernel at each main-path shape beside its plain version, its
   bound (``bound_ms``: bytes in + out over 3.35 TB/s, or operations over
   the f32 rate if larger) and, where one PyTorch call computes the same
   multiply-accumulate, that call (``library_ms``: ``F.conv2d`` on a
   pre-padded f32 copy, timed only here), and for sep_filter the route each
   shape takes (the generic kernel timed at k = 9 on ORB's level-2 shape,
   as no main path launches it); each op of config 3; the whole
   forwards; config 4's forward and ops; the pad inside one erode, whole and
   its device work alone; goodFeaturesToTrack's device part and host
   tail apart; config 5's forward on the host clock, its host syncs, and its
   stages (level-0 FAST, one LINEAR_EXACT step, torch.topk on the pooled
   and the unpooled level-0 map, level 0's sparse Harris/IC/descriptor
   stage, the device rows and the host tail) and BFMatcher at 500 x 500;
   config 2's forward and each of its five ops beside their bytes bounds,
   the forward's device busy share (``torch.profiler``) and its peak
   device memory; the same for the decode-and-colour forward and its seven
   stages, for the enhancement forward and its eight, and for the motion
   forward and its eleven (with the sub-steps of the phase correlation),
   each with its host syncs; the motion path's propagation steps and
   fixpoint checks (connectedComponents, distanceTransform), and
   distanceTransform DIST_MASK_PRECISE on its mask batch with its peak
   memory; the lane-and-sign forward and its nine stages beside their bytes
   bounds, with busy share, host syncs, peak memory, the two Hough
   accumulations' own peaks, the line accumulation against the same number
   of votes on distinct addresses (its atomic contention), LSD's host tail
   and the drawing's device writes; the segmentation forward and its
   sixteen stages beside their bytes bounds (median of 5), with busy share,
   host syncs, peak memory, the mean shift's own peak, the min cuts' host
   ms and the watershed floods pooled and one after another; the
   registration forward's nine stages beside their bytes bounds (the
   device stages by CUDA events, median of 5; the host tails, FLANN's build
   and search and the ratio test once on the host clock), the bound's
   terms, and one profiled forward's wall, busy share and peak memory, with
   the 4k run's wall and host syncs; the tracking forward's seven stages
   the same way, with its busy share, host syncs and peak memory over the
   input, and 4m's wall with this timing; the video forward's six stages
   on the host clock beside their bytes bounds (the terms listed), one
   profiled forward's wall, busy share and peak memory, its host syncs, and
   4n's wall with this timing; the photo forward's six stages the same way,
   with 4o's wall, and sep_filter k3 at the photo path's C = 3 shape beside
   its bound and F.conv2d; the stereo forward's six stages the same way,
   with SGBM's kernel launches in one stage (``torch.profiler``), 4p's
   wall, and gauss5_down2 at the stereo shape (2, 1080, 1920, 3); phases
   4s, 4t and 4u time their own stages beside their bounds inside their
   budgets.  A kernel's share of its bound is
   bound_ms / ms.

The last two lines are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# (warp) max |d| allowed between GPU and CPU plain output, and the share of
# pixels that may differ: the bound tests/test_warp.py uses against cv2
WARP_ATOL = 1
WARP_MAX_FRACTION = 1e-3
# (cornerHarris) float32 on the card vs the CPU: |d| <= HARRIS_RTOL * |ref|
# + HARRIS_ATOL * max |ref|, the bound tests/test_torch_analysis.py holds the
# port to against opencv_tpu
HARRIS_RTOL = 1e-5
HARRIS_ATOL = 1e-6
# (matchTemplate) max |d| <= MATCH_TOL * max(1, max |ref|), the bound
# tests/test_analysis.py holds the reference to against cv2
MATCH_TOL = 1e-4
# (goodFeaturesToTrack) the corner sets share this much of the larger one,
# as tests/test_analysis.py compares them (the order of equal responses is
# free)
GFTT_OVERLAP = 0.85
# (ORB) card vs CPU plain forward, per image: the same keypoint set keyed by
# (octave, x, y), and per key the same response, angle and descriptor.  No
# tolerance: cos and sin are taken in float64 and rounded to float32, and
# every other float op runs alone on both devices (no fused multiply-add).


# (enhancement path) the stages computed in float (CLAHE's blend, the unsharp
# mask's addWeighted, bilateralFilter), held to the warp bound where they are
# not exact; in the whole chain, the stages after them too, and the sums
ENHANCE_FLOAT_STAGES = ("clahe", "unsharp", "bilateral", "gamma", "colour", "sums")


# (motion path) the recovered shifts against the video's, px
MOTION_SHIFT_TOL = 0.25
# (motion path) card vs CPU: the shifts and responses, and the distances
MOTION_SHIFT_ATOL = 1e-6
MOTION_DIST_ATOL = 1e-5
MOTION_MOMENTS_RTOL = 1e-12
# (lines path) card vs CPU: LSD's segment end points where its prefilter
# differs (exact where it does not)
LSD_ATOL = 1e-4
# (segmentation path) card vs CPU: grabCut's mask may differ on this share
# of its pixels (its likelihoods' exp and log are the device's), and then
# its models by this relative amount (a pixel's component moves a GMM's
# moments by about 1/count); the distances within MOTION_DIST_ATOL
CUT_MAX_FRACTION = 1e-4
CUT_MODEL_RTOL = 1e-4
# (segmentation path) the truth: regions within this share of the cells,
# the flood over this share of the background, grabCut's IoU at least this
SEGMENT_COUNT_TOL = 0.1
FLOOD_MIN_BG = 0.95
CUT_MIN_IOU = 0.85
# (registration path) the truth: this share of all good pairs within
# REGISTER_TOL_PX of where the pan's matrix sends them, and at least
# REGISTER_MIN_GOOD good pairs in every frame pair
REGISTER_TOL_PX = 1.5
REGISTER_MIN_SHARE = 0.90
REGISTER_MIN_GOOD = 100
# (tracking path) the truth, for AKAZE and BRISK: TRACK_MIN_SHARE[det] of
# all good pairs within TRACK_TOL_PX (half-size px, OpenCV's AKAZE
# tutorial's inlier distance) of where the pan's matrix sends them, and at
# least TRACK_MIN_GOOD[det] good pairs in every frame pair
# (measured on the H100, PR 17 c2: AKAZE 0.9842 of all good pairs, 0.9772
# to 0.9892 a pair, 832 to 965 good pairs a pair; BRISK 0.7362, 0.7054 to
# 0.7969, 243 to 270: BRISK has no subpixel refinement in the JAX package,
# so its octave 1 and 2 keypoints sit on 2 and 4 px grids)
TRACK_TOL_PX = 2.5
TRACK_MIN_SHARE = {"akaze": 0.95, "brisk": 0.65}
TRACK_MIN_GOOD = {"akaze": 700, "brisk": 200}
# (video path) the truth, from entry.video_truth_report: per frame pair, at
# least VIDEO_KLT_SHARE of the tracked points clear of the movers (by LK's
# reach) within 0.5 px of the camera's shift, and VIDEO_KLT_MIN of them;
# the median shake and the static pixels' median Farnebäck flow within
# VIDEO_SHIFT_TOL px per axis of the shift (half of it at half size); in
# frames VIDEO_BG_FIRST.. each box's foreground share at least
# VIDEO_BG_BOX_MIN and on average VIDEO_BG_BOX_MEAN, at least
# VIDEO_BG_IN_BOX of the foreground inside a box, and in frames 4.. at most
# VIDEO_BG_STATIC of the static pixels foreground.  Measured at full size
# (perf/video_truth.py on the H100 and on the CPU alike, and this script;
# NVIDIA H100 80GB HBM3, 700.00 W): 0.9909-1.0 of 328-372 points; shake
# <= 0.0011 px, dense <= 0.0014 px; frames 5-7 least box share
# 0.0262-0.0941, mean 0.6117-0.6212, all the foreground in boxes; static
# 0.0.  The JAX package's MOG2 counts a fresh mode as background
# while the older modes' weights sum below backgroundRatio (0.9), which its
# learning rate 1/(2 frames) keeps true up to frame 4: no foreground before
# frame 5, and a box over its mover's last place keeps its old mode
VIDEO_KLT_SHARE = 0.95
VIDEO_KLT_MIN = 300
VIDEO_SHIFT_TOL = 0.25
VIDEO_BG_FIRST = 5
VIDEO_BG_BOX_MIN = 0.025
VIDEO_BG_BOX_MEAN = 0.6
VIDEO_BG_IN_BOX = 0.99
VIDEO_BG_STATIC = 0.05
# (video path) card vs CPU: LK's points within VIDEO_LK_TOL px and its
# status equal on VIDEO_LK_SHARE of the points, Farnebäck's flow within
# VIDEO_FLOW_TOL px on VIDEO_FLOW_SHARE of the pixels (the bounds the tests
# hold the port to against the JAX package's jitted programs)
VIDEO_LK_TOL = 1e-3
VIDEO_LK_SHARE = 0.99
VIDEO_FLOW_TOL = 1e-3
VIDEO_FLOW_SHARE = 0.999

# (photo path) the truth, from entry.photo_truth_report at (3, 1080, 1920, 3):
# AlignMTB's shifts undo the planted ones exactly; NL-means gains at least
# PHOTO_DENOISE_GAIN dB of PSNR against the noise-free twin's fusion; the
# face keeps at most PHOTO_FLAT_RATIO of its mean |Sobel| and at least
# PHOTO_OUTSIDE_SHARE of the pixels 5 px clear of it move by at most 1; the
# wire reads at least PHOTO_INPAINT_RATIO of its 3-px ring.  Measured by the
# port's plain forward on the CPU at full size (the gates sit just under):
# gain 0.129 dB (the noisy fusion's weights, not only its noise, part it
# from the twin's), ratio 0.599, outside 0.242 (the Poisson solve spans the
# frame, as cv2's does: cv2.textureFlattening on the same input is within
# 0.52 levels of the port on average), wire 0.958
PHOTO_DENOISE_GAIN = 0.1
PHOTO_FLAT_RATIO = 0.62
PHOTO_OUTSIDE_SHARE = 0.2
PHOTO_INPAINT_RATIO = 0.8
# (photo path) card vs CPU on a (3, 270, 480, 3) bracket, each stage on the
# card's own input: the shifts, the aligned frames and inpaint exactly; fuse,
# denoise, detail and flatten within PHOTO_ATOL on all values and equal on
# PHOTO_SHARE of them (the float32 exp, pow and FFT of the card and the CPU
# round apart before a rounding or a truncating cast to u8)
PHOTO_CHECK_SHAPE = (3, 270, 480, 3)
PHOTO_ATOL = 1
PHOTO_SHARE = 0.999


# (stereo path) card vs CPU on the band of rows STEREO_BAND of the full-size
# rectified pair (StereoBM, filterSpeckles, the depth) and the band
# STEREO_HALF_BAND of the half-size pair (StereoSGBM): all exact (integer
# stages; the depth float64 one op at a time, rounded to float32 once)
STEREO_BAND = (405, 675)
STEREO_HALF_BAND = (135, 405)
# phase 4p's wall budget, s (the rendering, calibrate_rig, the forward, the
# truth and the CPU's bands)
STEREO_WALL_BUDGET_S = 60.0
# gauss5_down2's shape on the stereo path: the rectified pair, N = 2
GAUSS_STEREO_SHAPE = (2, 1080, 1920, 3)
# the strip kernel's classes (BGR; the gray route on channel 1): rows of
# 3W % 16 != 0 (the unaligned path), W of one strip (16), a strip -/+ 2, a
# ragged last strip (512 + 6), H = 2 and 4, N = 1 and 3, the main width
GAUSS_CLASS_SHAPES = ((3, 34, 1918, 3), (1, 2, 16, 3), (1, 4, 14, 3), (1, 6, 18, 3),
                      (2, 10, 518, 3), (1, 8, 512, 3), (3, 12, 1920, 3), (1, 1080, 1920, 3))
# shapes run under plans of 1 and 3 blocks: each warp's run ends at every
# step of the unrolled loop and crosses column groups and images
GAUSS_RUN_SHAPES = ((1, 2, 512, 3), (1, 6, 512, 3), (1, 10, 512, 3), (1, 14, 512, 3),
                    (1, 26, 512, 3), (3, 50, 1030, 3))


# phase 4q (the detection path): the heads' agreement, card against CPU, and
# the band around confThreshold and nmsThreshold inside which a box may be
# kept on one device and not the other (f32 convolutions summed in cuDNN's
# and the CPU's orders: the 13 layers' rounding reaches ~1e-5 of the heads'
# values); a kept box's corner may sit one pixel apart where x * width lies
# that close to an integer
DETECT_HEAD_RTOL = 1e-3
DETECT_HEAD_ATOL = 1e-3
DETECT_BAND = 1e-3
DETECT_WALL_BUDGET_S = 60.0
# phase 4r (ml): MNIST's shape for the batched algorithms; the CPU repeats
# the card's work on a subset (the first ML_CPU_TRAIN samples, the first
# ML_CPU_QUERIES queries) to hold the card to it in the phase's budget
ML_SHAPE = (60000, 784)
ML_CLASSES = 10
ML_QUERIES = 10000
ML_CPU_TRAIN = 6000
ML_CPU_QUERIES = 500
ML_LR_ITERS = 100
ML_MLP_LAYERS = (784, 64, 10)
ML_MLP_ITERS = 20
# the host-loop algorithms (SVM's SMO, SVMSGD, EM, the trees) at a size
# their Python loops finish in seconds: 2,000 samples (SVM 784 features,
# one-vs-one over the 10 classes; SVMSGD two classes; EM 16 features and 10
# clusters; the trees 32 features)
ML_HOST_N = 2000
ML_WALL_BUDGET_S = 60.0
ML_DIST_TOL = 1e-3      # KNearest's distances (|q|^2 + |t|^2 - 2 q.t, f32)
ML_TRAIN_TOL = 1e-3     # trained f32 arrays, card against CPU, relative


# phases 4s, 4t and 4u (stitching, G-API, the DNN trackers): each path's
# wall budget, s (the inputs, the counted run, the CPU's check and the
# timing)
PATH_WALL_BUDGET_S = 60.0
# (stitching path) the panorama's width against the extent the pan's truth
# implies, relative: 1%, the width of about 30 px at 3,000 px (each pair's
# canvas rounds its corners up to a pixel; the homographies are estimates)
STITCH_WIDTH_TOL = 0.01
# (G-API) the batches of make_batch() the Stream runs
GAPI_BATCHES = 4
# (DNN trackers) six GOTURN trackers over frames 1-7; the card's output
# against the CPU's net on the card's blobs, relative to the largest value
# (f32 convolutions and products summed in cuDNN's, cuBLAS's and oneDNN's
# orders over 113.75 M weights: the net's rounding reaches ~1e-6 of its
# outputs, which sit near the prior box, 57-170)
GOTURN_UPDATES = 42
GOTURN_RTOL = 1e-4
# the other trackers' frames in the card-against-CPU sweep
SWEEP_FRAMES = 4


# config 2's ops, in the order of entry.forward_resize_warp_4k's outputs
CFG2_OPS = ("resize LINEAR", "resize AREA", "resize CUBIC", "warpAffine", "warpPerspective")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


class Timer:
    """CUDA-event timing: warm-up, then the median of `iters` runs, each
    after a write of 256 MiB that evicts the 50 MB L2 (outside the timed
    window).

    device_only: the card spins for about 0.5 ms (``torch.cuda._sleep``)
    before the start event, so the host has enqueued the whole of `fn` by the
    time the window opens and the window holds device time only.  Without
    it, host work in `fn` that outlasts the flush (a Python wrapper's
    allocation and argument marshalling) is counted, as a caller sees it."""

    SPIN_CYCLES = 1_000_000

    def __init__(self, device):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)

    def __call__(self, fn, iters: int = 20, warmup: int = 3, device_only: bool = False) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            if device_only:
                torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def check_equal(name, got, want) -> int:
    """Raise unless `got` equals `want` exactly; return max |got - want|."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} != "
                             f"{tuple(want.shape)} {want.dtype}")
    wide = torch.float64 if got.is_floating_point() else torch.int64
    d = (got.to(wide) - want.to(wide)).abs()
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel != plain ({int(d.count_nonzero())} differ, "
                             f"max |d| = {d.max().item()})")
    return d.max().item() if got.is_floating_point() else int(d.max())


def check_close(name, got, want, rtol, atol) -> float:
    """Raise unless |got - want| <= rtol * |want| + atol * max |want|
    elementwise; print and return max |got - want|."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} != "
                             f"{tuple(want.shape)} {want.dtype}")
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{name}: non-finite values")
    d = (got.to(torch.float64) - want.to(torch.float64)).abs()
    ref_max = float(want.abs().max())
    bound = rtol * want.to(torch.float64).abs() + atol * ref_max
    log(f"{name}: max |d| {float(d.max()):.6g}, max |ref| {ref_max:.6g} "
        f"(rtol {rtol}, atol {atol} * max |ref|)")
    if bool((d > bound).any()):
        raise AssertionError(f"{name}: {int((d > bound).sum())} values out of tolerance")
    return float(d.max())


def check_rel(name, got, want, tol) -> float:
    """Raise unless max |got - want| <= tol * max(1, max |want|); print and
    return max |got - want|."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} != "
                             f"{tuple(want.shape)} {want.dtype}")
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{name}: non-finite values")
    d = float((got.to(torch.float64) - want.to(torch.float64)).abs().max())
    scale = max(1.0, float(want.abs().max()))
    log(f"{name}: max |d| {d:.6g}, bound {tol} * {scale:.6g}")
    if d > tol * scale:
        raise AssertionError(f"{name}: max |d| {d} over {tol * scale}")
    return d


def corner_overlap(got, want) -> tuple[int, int, int]:
    """(shared, len got, len want) of two goodFeaturesToTrack results as
    integer point sets."""
    a = {tuple(p) for p in np.asarray(got).reshape(-1, 2).astype(int).tolist()}
    b = {tuple(p) for p in np.asarray(want).reshape(-1, 2).astype(int).tolist()}
    return len(a & b), len(a), len(b)


def orb_compare(name, got, want) -> str:
    """Raise unless one image's ORB result on the card equals the CPU's
    (the same keypoints, responses, angles and descriptors); return a
    summary line."""
    g = {(k.octave, k.pt[0], k.pt[1]): (k, d) for k, d in zip(*got)}
    w = {(k.octave, k.pt[0], k.pt[1]): (k, d) for k, d in zip(*want)}
    if g.keys() != w.keys():
        raise AssertionError(f"{name}: {len(g.keys() & w.keys())} keypoints shared of {len(g)} "
                             f"(card) and {len(w)} (CPU)")
    for key, (kw, dw) in w.items():
        kg, dg = g[key]
        if (kg.response, kg.angle) != (kw.response, kw.angle) or not np.array_equal(dg, dw):
            raise AssertionError(f"{name} at {key}: response {kg.response} / {kw.response}, "
                                 f"angle {kg.angle} / {kw.angle}, "
                                 f"{int(np.unpackbits(dg ^ dw).sum())} descriptor bits differ")
    return (f"{name}: the same {len(w)} keypoints, responses, angles and descriptors on the "
            f"card and the CPU")


def count_syncs(fn) -> int:
    """Run fn once with torch's sync debug mode on; return the number of
    operations that made the host wait for the card."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(c.message) for c in caught)


def host_median(fn, iters: int = 20, warmup: int = 2) -> float:
    """Median wall time of fn in ms on the host clock (fn ends in a host
    sync of its own)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def busy_share(fn, iters: int = 3, warmup: bool = True,
               host_ops: bool = True) -> tuple[float, float, float]:
    """(kernel time / wall time, kernel ms, wall ms) per call of fn, from
    torch.profiler over `iters` calls after one warm-up (none for a path that
    has just run); the wall time ends in a synchronize.  host_ops=False
    records the device's activity alone (a forward of tens of thousands of
    small ops otherwise takes a minute to summarise)."""
    from torch.profiler import ProfilerActivity, profile
    if warmup:
        fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops else [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    cuda = torch.autograd.DeviceType.CUDA
    k_us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
               for e in prof.key_averages() if e.device_type == cuda)
    k_ms = k_us / iters / 1e3
    return k_ms / wall_ms, k_ms, wall_ms


def motion_compare(what, got, want) -> list[str]:
    """Hold the motion path's outputs `got` (the card's, on the host) to
    `want` (the CPU's), key by key, for the keys they share: the shifts and
    responses within MOTION_SHIFT_ATOL, the distances within
    MOTION_DIST_ATOL, the moments within MOTION_MOMENTS_RTOL relative, the
    centroids within 1e-12 relative, everything else (u8 images, labels,
    counts, stats, the f32 background, contours, areas, rects, step counts)
    exactly.  Raise with the count and size of the differences; return one
    summary per key."""
    report = []
    for key in want:
        g, w = got[key], want[key]
        if key in ("moments",):
            worst = max(abs(a[k] - b[k]) / max(1.0, abs(b[k])) for a, b in zip(g, w) for k in b)
            if worst > MOTION_MOMENTS_RTOL:
                raise AssertionError(f"motion {what} {key}: max rel |d| {worst}")
            report.append(f"{key} max rel |d| {worst:.3g}")
            continue
        if key in ("contours", "areas", "rects", "cc_steps", "dt_steps"):
            same = (len(g) == len(w) and all(np.array_equal(a, b) for a, b in zip(g, w))
                    if key == "contours" else g == w)
            if not same:
                raise AssertionError(f"motion {what} {key}: {g} != {w}")
            report.append(f"{key} equal")
            continue
        g = torch.as_tensor(np.asarray(g) if not isinstance(g, torch.Tensor) else g)
        w = torch.as_tensor(np.asarray(w) if not isinstance(w, torch.Tensor) else w)
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"motion {what} {key}: {tuple(g.shape)} {g.dtype} != "
                                 f"{tuple(w.shape)} {w.dtype}")
        d = (g.to(torch.float64) - w.to(torch.float64)).abs()
        n_diff, d_max = int(d.count_nonzero()), float(d.max()) if d.numel() else 0.0
        tol = {"shifts": MOTION_SHIFT_ATOL, "responses": MOTION_SHIFT_ATOL,
               "distance": MOTION_DIST_ATOL}.get(key, 0.0)
        if key == "centroids":
            tol = 1e-12 * max(1.0, float(w.abs().max()))
        if d_max > tol:
            raise AssertionError(f"motion {what} {key}: {n_diff} of {d.numel()} differ, "
                                 f"max |d| {d_max}")
        report.append(f"{key} {'exact' if not n_diff else f'{n_diff} differ, max |d| {d_max:.3g}'}")
    return report


def same_results(a, b) -> bool:
    """Two per-frame result lists (arrays, None, nested lists or tuples of
    them) equal exactly."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(same_results(x, y) for x, y in zip(a, b)))
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def lines_compare(what, got, want) -> list[str]:
    """Hold the lines path's outputs `got` (the card's, on the host) to `want`
    (the CPU's), key by key, for the keys they share: everything exactly (the
    images, sums, lines, segments, circles, lane fits, draw counts and vote
    statistics), but LSD's segments, which may differ by LSD_ATOL px in
    their end points (the same count) where its float prefilter differs.
    Raise with the size of a difference; return one summary per key."""
    report = []
    for key in want:
        g, w = got[key], want[key]
        if isinstance(w, torch.Tensor):
            ok = g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)
        elif isinstance(w, dict) or isinstance(w, int):
            ok = g == w
        else:
            ok = same_results(g, w)
        if ok:
            report.append(f"{key} exact")
            continue
        if key == "lsd" and g[0] is not None and w[0] is not None and len(g[0]) == len(w[0]):
            d = float(np.abs(g[0] - w[0]).max())
            if d <= LSD_ATOL:
                report.append(f"lsd {len(w[0])} segments, ends within {d:.3g} px")
                continue
        raise AssertionError(f"lines {what} {key}: card and CPU differ")
    return report


def segment_compare(what, got, want) -> list[str]:
    """Hold the segmentation path's outputs `got` (the card's, on the host)
    to `want` (the CPU's), key by key, for the keys they share: the
    corrected frames to the warp bound (``^(1/γ)`` is the device's), the
    distances within MOTION_DIST_ATOL, grabCut's mask to CUT_MAX_FRACTION
    and its models to CUT_MODEL_RTOL where the mask differs (else exactly),
    the min cuts' host times not at all, everything else (images, labels,
    markers, masks, counts, centroids, triangles, histograms, EMD, the
    mean shift's counts) exactly.  Raise with the size of a difference;
    return one summary per key."""
    report = []
    cut_diff = 0
    for key in want:
        g, w = got[key], want[key]
        if key == "gc_stats":
            continue
        if isinstance(w, torch.Tensor):
            same = g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)
        elif isinstance(w, (dict, tuple, int, float)):
            same = g == w
        else:
            same = same_results(g, w)
        if same:
            report.append(f"{key} exact")
            continue
        if key in ("corrected", "distance", "cut_mask") and g.shape == w.shape:
            d = (g.to(torch.float64) - w.to(torch.float64)).abs()
            n_diff, d_max = int(d.count_nonzero()), float(d.max())
            ok = {"corrected": d_max <= WARP_ATOL and n_diff <= WARP_MAX_FRACTION * d.numel(),
                  "distance": d_max <= MOTION_DIST_ATOL,
                  "cut_mask": n_diff <= CUT_MAX_FRACTION * d.numel()}[key]
            if ok:
                cut_diff += n_diff if key == "cut_mask" else 0
                report.append(f"{key} {n_diff} of {d.numel()} differ (max |d| {d_max:.3g})")
                continue
        if key in ("bgd_model", "fgd_model") and cut_diff:
            rel = float(np.abs(g - w).max() / np.abs(w).max())
            if rel <= CUT_MODEL_RTOL:
                report.append(f"{key} max rel |d| {rel:.3g}")
                continue
        raise AssertionError(f"segment {what} {key}: card and CPU differ")
    return report


def host_state(st) -> dict:
    """The motion path's state dict with its tensors on the host."""
    return {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in st.items()}


def pyr_cases(K):
    """(name, shape, border) for phase 3's pyr_down cases."""
    borders = {"REPLICATE": K.BORDER_REPLICATE, "REFLECT": K.BORDER_REFLECT,
               "WRAP": K.BORDER_WRAP, "REFLECT_101": K.BORDER_REFLECT_101}
    cases = [(f"main {b}", (8, 1080, 1920, 1), border) for b, border in borders.items()]
    for bname, border in borders.items():
        for C in (1, 3, 4):
            for hw in ((40, 52), (41, 53), (40, 53), (16, 16), (17, 16), (67, 261),
                       (1, 1), (2, 3), (5, 7), (9, 15)):
                cases.append((f"{hw} C{C} {bname}", (2, *hw, C), border))
    # the kernel's block classes: a warp strip is 16 output rows (32 input)
    # by 512 output bytes, a row is staged in 16-byte chunks; odd H and W
    # around those widths, rows that are not a multiple of 16 bytes, and a
    # mostly interior size
    for bname, border in borders.items():
        for shape in ((2, 33, 1025, 1), (2, 31, 1023, 1), (2, 65, 17, 1), (2, 63, 15, 1),
                      (2, 97, 2047, 1), (1, 256, 4096, 1), (2, 33, 343, 3), (2, 35, 257, 4),
                      (2, 34, 130, 2), (2, 66, 34, 4)):
            cases.append((f"class {shape} {bname}", shape, border))
    return cases


def sep_cases(K, gauss_taps, orb_sizes):
    """(name, shape, kwargs of sep_filter_int) for phase 3; `orb_sizes` are
    the (width, height) of ORB's pyramid levels at 1080p."""
    borders = {"CONSTANT": K.BORDER_CONSTANT, "REPLICATE": K.BORDER_REPLICATE,
               "REFLECT": K.BORDER_REFLECT, "WRAP": K.BORDER_WRAP,
               "REFLECT_101": K.BORDER_REFLECT_101}
    main = (8, 1080, 1920, 1)
    cases = [("main gauss k5 s0 REFLECT_101", main,
              dict(kx=gauss_taps(5, 0.0), ky=gauss_taps(5, 0.0), shift=16,
                   border=K.BORDER_REFLECT_101)),
             # config 5: ORB's GaussianBlur 7x7 sigma 2 of every level, the
             # template at K = 7
             *((f"main orb k7 level {lv} {(h, w)}", (8, h, w, 1),
                dict(kx=gauss_taps(7, 2.0), ky=gauss_taps(7, 2.0), shift=16,
                     border=K.BORDER_REFLECT_101))
               for lv, (w, h) in enumerate(orb_sizes)),
             # config 3: Sobel(x, CV_16S, 1, 0), and Canny's dx and dy
             ("main sobel dx i16 REFLECT_101", main,
              dict(kx=(-1, 0, 1), ky=(1, 2, 1), out_dtype="int16",
                   border=K.BORDER_REFLECT_101)),
             ("main canny dx i16 REPLICATE", main,
              dict(kx=(-1, 0, 1), ky=(1, 2, 1), out_dtype="int16", border=K.BORDER_REPLICATE)),
             ("main canny dy i16 REPLICATE", main,
              dict(kx=(1, 2, 1), ky=(-1, 0, 1), out_dtype="int16", border=K.BORDER_REPLICATE)),
             # the lines path: HoughCircles' Sobel(blur, CV_16S, 0, 1)
             ("main sobel dy i16 REFLECT_101", main,
              dict(kx=(1, 2, 1), ky=(-1, 0, 1), out_dtype="int16",
                   border=K.BORDER_REFLECT_101))]
    for bname, border in borders.items():
        for C in (1, 3, 4):
            for k, sigma in ((3, 0.8), (9, 2.0), (31, 5.0)):
                cases.append((f"gauss k{k} C{C} {bname}", (2, 45, 141, C),
                              dict(kx=gauss_taps(k, sigma), ky=gauss_taps(k, sigma), shift=16,
                                   border=border, border_value=7)))
        cases.append((f"gauss k31 tiny C3 {bname}", (1, 5, 7, 3),
                      dict(kx=gauss_taps(31, 5.0), ky=gauss_taps(31, 5.0), shift=16,
                           border=border)))
    cases += [
        ("constant per-channel C3", (2, 33, 70, 3),
         dict(kx=gauss_taps(5, 1.5), ky=gauss_taps(9, 2.0), shift=16,
              border=K.BORDER_CONSTANT, border_value=(11, 22, 33))),
        ("constant per-channel C4", (2, 33, 70, 4),
         dict(kx=gauss_taps(7, 1.2), ky=gauss_taps(3, 0.0), shift=16,
              border=K.BORDER_CONSTANT, border_value=(1, 2, 250, 255))),
        ("sobel dx i16", (2, 70, 90, 1),
         dict(kx=(-1, 0, 1), ky=(1, 2, 1), shift=0, out_dtype="int16")),
        ("sobel k5 dyy i16 C3 +delta", (2, 70, 90, 3),
         dict(kx=(1, 4, 6, 4, 1), ky=(1, 0, -2, 0, 1), shift=0, delta=-5, out_dtype="int16",
              border=K.BORDER_REPLICATE)),
        ("box k3 scale", (2, 70, 90, 1),
         dict(kx=(1,) * 3, ky=(1,) * 3, scale=1.0 / 9, border=K.BORDER_REFLECT_101)),
        ("box k9 scale C4", (2, 70, 90, 4),
         dict(kx=(1,) * 9, ky=(1,) * 9, scale=1.0 / 81, border=K.BORDER_REPLICATE)),
        ("odd size 1x1", (1, 1, 1, 1),
         dict(kx=gauss_taps(5, 0.0), ky=gauss_taps(5, 0.0), shift=16)),
        ("odd size 17x129 C2", (3, 17, 129, 2),
         dict(kx=gauss_taps(5, 1.1), ky=gauss_taps(5, 1.1), shift=16,
              border=K.BORDER_WRAP)),
    ]
    # the kernels' block classes: a block of the template is 4 warp strips
    # of 8 output rows by 512 bytes, a row staged from its 16-byte granules
    # at any offset; k = 3, 5 and 7 are the template, 9 and 31 the generic
    # kernel (strips of 32 rows, staged byte by byte where W*C % 16 != 0)
    taps = {3: dict(kx=gauss_taps(3, 0.0), ky=gauss_taps(3, 0.0), shift=16),
            5: dict(kx=gauss_taps(5, 1.3), ky=gauss_taps(5, 1.3), shift=16),
            7: dict(kx=gauss_taps(7, 0.0), ky=gauss_taps(7, 0.0), shift=16),
            9: dict(kx=gauss_taps(9, 2.0), ky=gauss_taps(9, 2.0), shift=16),
            31: dict(kx=gauss_taps(31, 6.0), ky=gauss_taps(31, 6.0), shift=16)}
    shapes = {"interior-heavy": (1, 256, 4096, 1), "W 15": (2, 40, 15, 1), "W 17": (2, 40, 17, 1),
              "W 511": (2, 33, 511, 1), "W 513": (2, 33, 513, 1), "WC%16 C1": (2, 40, 101, 1),
              "WC%16 C3": (2, 40, 101, 3), "WC%16 C4": (2, 40, 101, 4),
              "H 33 (strip+1)": (2, 33, 64, 1), "H 127": (1, 127, 160, 2),
              "H 161 C4": (1, 161, 128, 4)}
    for bname, border in borders.items():
        for k, kw in taps.items():
            for sname, shape in shapes.items():
                if k == 31 and shape[2] * shape[3] > 600:
                    continue  # the generic k = 31 path is checked on the narrow shapes
                cases.append((f"class k{k} {sname} {shape} {bname}", shape,
                              dict(kw, border=border, border_value=(9, 99, 199, 250)[:shape[3]])))
        cases.append((f"class sobel i16 W 17 {bname}", (2, 40, 17, 1),
                      dict(kx=(-1, 0, 1), ky=(1, 2, 1), out_dtype="int16", border=border)))
        cases.append((f"class sobel i16 WC%16 C3 {bname}", (2, 40, 101, 3),
                      dict(kx=(-1, 0, 1), ky=(1, 2, 1), out_dtype="int16", border=border)))
    # the template at K = 7 at every row width: W*C % 16 in {1, 5, 15} (odd
    # C; even C the nearest their channel count allows), aligned rows, and
    # rows over one warp's 512 bytes; H of 1, 7 and 33 rows (one output row,
    # one strip, over one block of 32); and Sobel ksize 7 u8 -> i16 with
    # delta and scale, dx and dy
    g7 = gauss_taps(7, 2.0)
    for bname, border in borders.items():
        for C, widths in K7_WIDTHS.items():
            bv = (9, 99, 199, 250)[:C]
            for W in widths:
                for H in (1, 7, 33):
                    cases.append((f"k7 C{C} W {W} (W*C % 16 = {W * C % 16}) H {H} {bname}",
                                  (2, H, W, C),
                                  dict(kx=g7, ky=g7, shift=16, border=border, border_value=bv)))
            for W in (widths[0], widths[-1]):
                for kx, ky in SOBEL7:
                    cases.append((f"k7 sobel i16 C{C} W {W} {kx} {bname}", (2, 33, W, C),
                                  dict(kx=kx, ky=ky, delta=-5, scale=0.5, out_dtype="int16",
                                       border=border, border_value=bv)))
    return cases


# (C, widths) of phase 3's K = 7 rows: W*C % 16 = 1, 5, 15 (C = 1, 3), the
# nearest even values (C = 2, 4), 0, and one row over 512 bytes
K7_WIDTHS = {1: (33, 37, 47, 48, 1029), 2: (33, 35, 39, 48, 517), 3: (43, 39, 37, 48, 345),
             4: (33, 35, 34, 48, 259)}
# Sobel ksize 7, (kx, ky) of dx = 1 and of dy = 1 (getDerivKernels)
SOBEL7 = (((-1, -4, -5, 0, 5, 4, 1), (1, 6, 15, 20, 15, 6, 1)),
          ((1, 6, 15, 20, 15, 6, 1), (-1, -4, -5, 0, 5, 4, 1)))


def offset_view(rng, shape, dev):
    """x[1:] of a batch: contiguous, with a storage offset of one image."""
    base = torch.from_numpy(rng.integers(0, 256, (shape[0] + 1, *shape[1:]), np.uint8)).to(dev)
    return base[1:].contiguous()


# (name, input shape) of the storage-offset cases: an image of H*W*C bytes
# that is a multiple of 16 keeps the base aligned, one that is not (an odd
# offset) puts every row of sep_filter's template at another offset in its
# granule, and sends pyr_down and sep_filter's generic kernel to their
# byte-wise staging
OFFSET_SHAPES = (("offset aligned", (2, 40, 64, 1)), ("offset unaligned", (2, 41, 63, 1)),
                 ("offset unaligned C3", (2, 41, 67, 3)), ("offset main", (7, 1080, 1920, 1)))


# pyr_down's inputs on the segmentation path (4j): frame 0, then its half
PYR_SEGMENT_SHAPES = ((1, 1080, 1920, 3), (1, 540, 960, 3))
# pyr_down's inputs on the video path (4n): LK's pair at 1080p and its next
# two levels, then the gray batch
PYR_VIDEO_SHAPES = ((2, 1080, 1920, 1), (2, 540, 960, 1), (2, 270, 480, 1), (8, 1080, 1920, 1))


# sep_filter's inputs on the photo path (4o): textureFlattening's Canny of the
# masked three-channel frame, cut to the window AlignMTB's shifts leave at
# 1080p ((5, -3) and (-4, 6) planted: 1920 - 9 by 1080 - 9), u8 -> i16, dx and
# dy, BORDER_REPLICATE
SEP_PHOTO_SHAPE = (1, 1071, 1911, 3)
SEP_PHOTO_TAPS = (((-1, 0, 1), (1, 2, 1)), ((1, 2, 1), (-1, 0, 1)))


# bound_ms: the card's memory rate and its float32 rate outside the tensor
# cores (NVIDIA's data sheet, H100 SXM)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound(bytes_moved: int, ops: int) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the f32 rate (a MAC counts two)."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def conv_yardstick(x, kx, ky, stride, dev):
    """One F.conv2d that computes the kernel's multiply-accumulate on the
    same image: f32 NCHW, padded for the taps outside the timed window
    (REFLECT_101 = torch's "reflect"), w = ky (x) kx, groups = C.  Returns
    the closure to time."""
    import torch.nn.functional as F
    N, H, W, C = x.shape
    kw, kh = len(kx), len(ky)
    xf = x.permute(0, 3, 1, 2).to(torch.float32)
    xp = F.pad(xf, (kw // 2, kw - 1 - kw // 2, kh // 2, kh - 1 - kh // 2), mode="reflect")
    w = torch.outer(torch.tensor(ky, dtype=torch.float32), torch.tensor(kx, dtype=torch.float32))
    w = w.to(dev).expand(C, 1, kh, kw).contiguous()
    return lambda: F.conv2d(xp, w, stride=stride, groups=C)



def _iou_row(box, boxes):
    """IoU of one [x, y, w, h] box with each of `boxes`."""
    b = np.asarray(boxes, np.float64).reshape(-1, 4)
    x1, y1 = np.maximum(box[0], b[:, 0]), np.maximum(box[1], b[:, 1])
    x2 = np.minimum(box[0] + box[2], b[:, 0] + b[:, 2])
    y2 = np.minimum(box[1] + box[3], b[:, 1] + b[:, 3])
    inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    union = box[2] * box[3] + b[:, 2] * b[:, 3] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def detect_compare(card, cpu, conf_t, nms_t, band):
    """Hold the card's decoded and kept boxes of each frame to the CPU's.
    A kept box matches one of the same class with its corners within a
    pixel and its score within `band`; a box kept on one device only must
    lie in the band: its score within `band` of conf_t, or its IoU with a
    candidate of its class within `band` of nms_t.  Returns (matched, of
    them off by a pixel, kept on one device only in the band, candidate
    rows in the band of conf_t); raises on any other difference."""
    matched = off = near = 0
    cand_band = 0
    for f, ((cdc, cds, cdb), (cc, cs, cb)), ((pdc, pds, pdb), (pc, ps, pb)) in zip(
            range(len(card["nms"])), zip(card["decode"], card["nms"]),
            zip(cpu["decode"], cpu["nms"])):
        in_band_c = int((np.abs(cds - conf_t) <= band).sum())
        in_band_p = int((np.abs(pds - conf_t) <= band).sum())
        cand_band += max(in_band_c, in_band_p)
        if abs(len(cds) - len(pds)) > max(in_band_c, in_band_p):
            raise AssertionError(f"detect frame {f}: {len(cds)} candidate rows on the card, "
                                 f"{len(pds)} on the CPU, {in_band_c}/{in_band_p} in the band")
        used = np.zeros(len(pc), bool)
        lonely = []
        for cls, sc, bx in zip(cc, cs, cb):
            hit = [k for k in range(len(pc)) if not used[k] and pc[k] == cls
                   and np.abs(pb[k].astype(int) - bx.astype(int)).max() <= 1
                   and abs(float(ps[k]) - float(sc)) <= band]
            if hit:
                used[hit[0]] = True
                matched += 1
                off += int(np.abs(pb[hit[0]].astype(int) - bx.astype(int)).max() == 1)
            else:
                lonely.append((cls, sc, bx, cdc, cdb))
        lonely += [(pc[k], ps[k], pb[k], pdc, pdb) for k in range(len(pc)) if not used[k]]
        for cls, sc, bx, dc, db in lonely:
            same = db[dc == cls]
            ious = _iou_row(bx.astype(np.float64), same)
            if abs(float(sc) - conf_t) > band and not (np.abs(ious - nms_t) <= band).any():
                raise AssertionError(f"detect frame {f}: box {bx.tolist()} class {cls} score "
                                     f"{float(sc)} kept on one device only, outside the band")
            near += 1
    return matched, off, near, cand_band


def phase_detect(E, run_counted, count_syncs, dev, card, kernel_syms):
    """4q: the detection path at full width (see the module's note)."""
    t_start = time.perf_counter()
    import opencv_tpu_torch.dnn as tdnn
    if "google.protobuf" in sys.modules:
        raise AssertionError("opencv_tpu_torch.dnn imported google.protobuf")
    log("dnn: opencv_tpu_torch.dnn imported; \"google.protobuf\" not in sys.modules: True "
        "(the readers parse with the port's own codec, dnn/_proto.py)")
    frames_np = E.make_detect_frames(E.SHAPE_DETECT, 0)
    t0 = time.perf_counter()
    net = E.make_detect_net(0, dev)
    make_s = time.perf_counter() - t0
    cfg = E.yolov3_tiny_cfg()
    n_params = sum(c["params"] for c in E.darknet_convs(cfg))
    frames = torch.from_numpy(frames_np).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    held = []
    t0 = time.perf_counter()
    n_sync, cnt = run_counted(
        lambda: count_syncs(lambda: held.append(E.forward_detect(frames, net))))
    wall = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    st = held[0]
    log(f"detect path launches: {cnt}")
    if any(cnt[k] for k in kernel_syms):
        raise AssertionError(f"detect path: no kernel of csrc/ may launch (its convolutions are "
                             f"cuDNN's, as the JAX package's are XLA's); got {cnt}")
    N = E.SHAPE_DETECT[0]
    blob, heads = st["blob"], st["net_out"]
    if tuple(blob.shape) != (N, 3, *E.DETECT_SIZE[::-1]) or blob.dtype != torch.float32 \
            or blob.device != dev:
        raise AssertionError(f"detect blob: {tuple(blob.shape)} {blob.dtype} {blob.device}")
    for h, rows in zip(heads, (13 * 13 * 3, 26 * 26 * 3)):
        if tuple(h.shape) != (N, rows, 85) or h.device != dev or not bool(torch.isfinite(h).all()):
            raise AssertionError(f"detect head: {tuple(h.shape)} {h.device}, or not finite")
    cands = [len(d[0]) for d in st["decode"]]
    kept = [len(d[0]) for d in st["nms"]]
    log(f"detect path: YOLOv3-tiny ({n_params:,} parameters, {n_params * 4 / 1e6:.2f} MB f32, "
        f"{E.detect_flops(cfg) / 1e9:.4f} GFLOP an image) made and read in {make_s:.2f} s; "
        f"candidate rows per frame {cands}, kept per frame {kept}")
    if min(kept) < 1:
        raise AssertionError(f"detect: a frame with no box reaching NMS: {kept}")
    # the CPU from the card's blob: the heads, the decode and NMS
    t0 = time.perf_counter()
    stem = os.path.join(os.path.dirname(E.__file__), "_build", "yolov3-tiny_w1_s416_seed0")
    net_c = tdnn.readNetFromDarknet(stem + ".cfg", stem + ".weights", device="cpu")
    st_c = E.forward_detect(frames.cpu(), net_c, stages=("net", "decode", "nms"),
                            state={"blob": blob.cpu()})
    err = 0.0
    for g, c in zip(heads, st_c["net_out"]):
        g = g.cpu()
        err = max(err, float((g - c).abs().max()))
        if not torch.allclose(g, c, rtol=DETECT_HEAD_RTOL, atol=DETECT_HEAD_ATOL):
            raise AssertionError(f"detect heads: card against CPU max |d| "
                                 f"{float((g - c).abs().max())}")
    matched, off, near, band_rows = detect_compare(st, st_c, E.DETECT_CONF, E.DETECT_NMS,
                                                   DETECT_BAND)
    cpu_s = time.perf_counter() - t0
    log(f"detect against the CPU (its net on the card's blob, {cpu_s:.1f} s): heads max |d| "
        f"{err:.3e} (within rtol {DETECT_HEAD_RTOL}, atol {DETECT_HEAD_ATOL}); kept boxes "
        f"matched {matched} (of them {off} a pixel apart), kept on one device only within "
        f"{DETECT_BAND} of a threshold: {near}; candidate rows within {DETECT_BAND} of "
        f"confThreshold: {band_rows}")
    # timing: the device stages by CUDA events, the host stages on the host clock
    timer = Timer(dev)
    blob_ms = timer(lambda: E.forward_detect(frames, net, stages=("blob",)), iters=10)
    net_ms = timer(lambda: E.forward_detect(frames, net, stages=("net",), state={"blob": blob}),
                   iters=10)
    del timer
    dec_ms = host_median(lambda: E.forward_detect(frames, net, stages=("decode",),
                                                  state={"net_out": heads}), iters=5)
    nms_ms = host_median(lambda: E.forward_detect(frames, net, stages=("nms",),
                                                  state={"decode": st["decode"]}), iters=5)
    busy, k_ms, f_ms = busy_share(lambda: E.forward_detect(frames, net), iters=3)
    flops = E.detect_flops(cfg) * N
    bytes_moved = frames.numel() + n_params * 4 + sum(h.numel() * 4 for h in heads)
    b_flop, b_bytes = flops / F32_OPS_PER_S * 1e3, bytes_moved / HBM_BYTES_PER_S * 1e3
    log(f"time detect stages on {tuple(frames.shape)}: blob {blob_ms:.4f} ms, net "
        f"{net_ms:.4f} ms (CUDA events, median of 10), decode {dec_ms:.4f} ms, NMS "
        f"{nms_ms:.4f} ms (host clock, median of 5)  [{card}]")
    log(f"detect forward: {f_ms:.4f} ms a batch on the host clock (profiled), device busy share "
        f"{busy:.4f} (kernels {k_ms:.4f} ms), {n_sync} host syncs; the 4q run {wall:.1f} ms; "
        f"peak device memory over the frames {peak:.3f} GiB; FLOP bound {b_flop:.4f} ms "
        f"({flops / 1e9:.2f} GFLOP at {F32_OPS_PER_S / 1e12:.0f} TFLOP/s f32), bytes bound "
        f"{b_bytes:.4f} ms ({bytes_moved / 1e6:.1f} MB); net share of its FLOP bound "
        f"{b_flop / net_ms:.4f}  [{card}]")
    wall_s = time.perf_counter() - t_start
    log(f"phase 4q wall: {wall_s:.1f} s (budget {DETECT_WALL_BUDGET_S:.0f} s)")
    if wall_s > DETECT_WALL_BUDGET_S:
        raise AssertionError(f"phase 4q took {wall_s:.1f} s, over its budget")
    return cnt


def _host_ms(fn, iters: int = 3) -> float:
    """Median host-clock ms of fn followed by a synchronize."""
    def run():
        fn()
        torch.cuda.synchronize()
    return host_median(run, iters=iters, warmup=1)


def phase_stitch(E, run_counted, count_syncs, dev, card, kernel_syms, k7):
    """4s: the stitching path at full size (see the module's note); `k7`
    are ORB's 7x7 blur taps.  Returns the launch counts of its counted
    run."""
    t_start = time.perf_counter()
    import opencv_tpu_torch as cv
    from opencv_tpu_torch.features2d.orb import level_sizes
    from opencv_tpu_torch.kernels.sepfilter import sep_filter_int, sep_filter_int_plain
    from opencv_tpu_torch.stitching import Stitcher
    from opencv_tpu_torch.blenders import blend_multiband
    from opencv_tpu_torch.calib3d.geometry import RANSAC, findHomography
    frames_np, truth = E.make_pan_video(E.SHAPE_STITCH)
    make_s = time.perf_counter() - t_start
    frames = torch.from_numpy(frames_np).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    held = []
    t0 = time.perf_counter()
    n_sync, cnt = run_counted(lambda: count_syncs(lambda: held.append(E.forward_stitch(frames))))
    wall = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 30
    st = held[0]
    log(f"stitch path launches: {cnt}")
    N = E.SHAPE_STITCH[0]
    orb_calls = 2 * (N - 1)
    want = orb_calls * st["stitcher"].orb.nlevels
    if (cnt["opencv_sep_filter"] != want or cnt["sep_filter routes"]["k7"] != want
            or any(cnt[k] for k in kernel_syms if k != "opencv_sep_filter")):
        raise AssertionError(f"stitch path: sep_filter must launch {want} times on route k7 (the "
                             f"7x7 blur of each level of {orb_calls} ORB calls) and nothing else; "
                             f"got {cnt}")
    pano = st["pano"]
    if st["status"] != Stitcher.OK or pano.dtype != torch.uint8 or pano.device != dev \
            or pano.ndim != 3 or len(st["homographies"]) != N - 1:
        raise AssertionError(f"stitch: status {st['status']}, panorama "
                             f"{None if pano is None else (tuple(pano.shape), pano.dtype)}")
    x0, x1, y0, y1 = E.pan_extent(truth, E.SHAPE_STITCH)
    width_err = abs(pano.shape[1] - (x1 - x0)) / (x1 - x0)
    log(f"stitch: panorama {tuple(pano.shape)} from {N} frames {E.SHAPE_STITCH[1:3]} (made in "
        f"{make_s:.1f} s); the pan's truth implies {x1 - x0:.1f} x {y1 - y0:.1f} px; width off "
        f"by {width_err:.5f} (gate {STITCH_WIDTH_TOL})")
    if width_err > STITCH_WIDTH_TOL:
        raise AssertionError("stitch: the panorama's width is off the pan's truth")
    # card against CPU, pair by pair on the card's own panorama so far: the
    # card's bases rebuilt from the run's homographies, the CPU's features,
    # matches and homography of each pair on those bases, and the CPU's
    # composition of the first and the last pair (the CPU's chamfer
    # distance transform takes seconds a panorama)
    t0 = time.perf_counter()
    sg, sc = Stitcher.create(), Stitcher.create()
    bases = [frames[0]]
    h_exact, worst = 0, (0, 0.0)
    for i, H in enumerate(st["homographies"]):
        base = bases[-1]
        nxt = sg.compose(base, frames[i + 1], H)
        src, dst = sc.match_points(base.cpu(), frames[i + 1].cpu())
        Hc, _ = findHomography(src, dst, RANSAC, 3.0)
        if not np.array_equal(Hc, H):
            raise AssertionError(f"stitch pair {i}: the CPU's homography differs: "
                                 f"max |d| {np.abs(Hc - H).max()}")
        h_exact += 1
        bases.append(nxt)
        if i not in (0, N - 2):
            continue
        d = (nxt.cpu().to(torch.int32) - sc.compose(base.cpu(), frames[i + 1].cpu(), H)
             .to(torch.int32)).abs()
        share = int(d.count_nonzero()) / d.numel()
        worst = max(worst, (int(d.max()), share))
        if int(d.max()) > WARP_ATOL or share > WARP_MAX_FRACTION:
            raise AssertionError(f"stitch pair {i}: composition max |d| {int(d.max())}, share "
                                 f"{share}")
    if not torch.equal(bases[-1], pano):
        raise AssertionError("stitch: the pairs rebuilt from the homographies differ from the run")
    # sep_filter at the shapes the path gave it past 1080p: the levels of
    # every panorama so far, against the plain version on the card
    rng = np.random.default_rng(19)
    shapes = sorted({(1, h, w, 1) for p_ in bases[1:-1]
                     for w, h in level_sizes(p_.shape[0], p_.shape[1])})
    for shape in shapes:
        x = torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(dev)
        kw = dict(kx=k7, ky=k7, shift=16, border=cv.BORDER_REFLECT_101)
        check_equal(f"sep_filter k7 {shape}", sep_filter_int(x, **kw), sep_filter_int_plain(x, **kw))
    cpu_s = time.perf_counter() - t0
    log(f"stitch: sep_filter k7 equal to the plain version at the {len(shapes)} level shapes of "
        f"the panoramas so far ({shapes[0][1:3]} to {shapes[-1][1:3]})")
    log(f"stitch against the CPU (with the k7 checks, {cpu_s:.1f} s): {h_exact} of {N - 1} "
        f"homographies equal "
        f"exactly (ORB and the Hamming matches exact on both devices, RANSAC on the host); the "
        f"first and the last pair's panoramas within the warp bound (max |d| {worst[0]}, share "
        f"{worst[1]:.2e}; bound {WARP_ATOL}, {WARP_MAX_FRACTION})")
    # stage times on the last pair (the widest panorama), host clock with a
    # synchronize, median of 3
    last, b, H = bases[-2], frames[-1], st["homographies"][-1]
    orb = sg.orb
    _, d1 = orb.detectAndCompute(last, None)
    _, d2 = orb.detectAndCompute(b, None)
    t_d1, t_d2 = torch.from_numpy(d1).to(dev), torch.from_numpy(d2).to(dev)
    src, dst = sg.match_points(last, b)
    canvas, warped, ma, mb = sg.canvas(last, b, H)
    wa, wb = sg.seam_weights(ma, mb)
    stages = {
        "orb": _host_ms(lambda: (orb.detectAndCompute(last, None), orb.detectAndCompute(b, None))),
        "match": _host_ms(lambda: sg.matcher.match(t_d2, t_d1)),
        "homography": _host_ms(lambda: findHomography(src, dst, RANSAC, 3.0)),
        "warp": _host_ms(lambda: sg.canvas(last, b, H)),
        "distance": _host_ms(lambda: sg.seam_weights(ma, mb)),
        "blend": _host_ms(lambda: blend_multiband([canvas, warped], [wa, wb], num_bands=4)),
    }
    # the busy share of the last pair alone: the profiler's summary of the
    # whole forward's ~80,000 kernels takes longer than the phase's budget
    busy, k_ms, f_ms = busy_share(lambda: sg._stitch_pair(last, b), iters=1, warmup=False,
                                  host_ops=False)
    nbytes = frames.numel() + pano.numel()
    b_ms = bound(nbytes, 0)[0]
    log(f"time stitch stages of the last pair (panorama so far {tuple(last.shape)} + a frame): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items())
        + f" (host clock with a synchronize, median of 3)  [{card}]")
    log(f"stitch forward: {wall:.1f} ms (the 4s run) on the host clock, {n_sync} host syncs, "
        f"peak device memory over the frames {peak:.3f} GiB; bytes bound {b_ms:.4f} ms "
        f"({nbytes / 1e6:.1f} MB: the frames read once, the panorama written once), share of "
        f"bound {b_ms / wall:.8f}; the last pair {f_ms:.1f} ms profiled, device busy share "
        f"{busy:.4f} (kernels {k_ms:.2f} ms)  [{card}]")
    wall_s = time.perf_counter() - t_start
    log(f"phase 4s wall: {wall_s:.1f} s (budget {PATH_WALL_BUDGET_S:.0f} s)")
    if wall_s > PATH_WALL_BUDGET_S:
        raise AssertionError(f"phase 4s took {wall_s:.1f} s, over its budget")
    return cnt


def phase_gapi(E, run_counted, dev, card):
    """4t: the flagship chain as a G-API graph through Stream and through
    its exported form (see the module's note).  Returns the launch counts of
    the live run and of the loaded program's."""
    import io
    from opencv_tpu_torch import gapi
    import opencv_tpu_torch as cv
    t_start = time.perf_counter()
    batches = [E.make_batch(E.SHAPE, seed) for seed in range(GAPI_BATCHES)]
    comp = E.gapi_flagship(E.SHAPE)
    outs, live = run_counted(lambda: E.forward_gapi(batches, comp, dev))
    log(f"gapi (Stream over {GAPI_BATCHES} batches) launches: {live}")
    xs = [torch.from_numpy(b).to(dev) for b in batches]
    refs = [(E.forward(x), cv.pyrDown(cv.cvtColor(x, cv.COLOR_BGR2GRAY))) for x in xs]
    for i, ((w, half), (rw, rhalf)) in enumerate(zip(outs, refs)):
        if w.device != dev or not torch.equal(w, rw) or not torch.equal(half, rhalf):
            raise AssertionError(f"gapi batch {i}: the graph's outputs differ from entry.forward "
                                 f"and the eager pyrDown")
    t0 = time.perf_counter()
    blob = gapi.serialize_compiled(comp.apply, xs[0])
    export_s = time.perf_counter() - t0
    called = sorted({str(n.target) for n in torch.export.load(io.BytesIO(blob)).graph.nodes
                     if n.op == "call_function" and "opencv_tpu_torch" in str(n.target)})
    fn = gapi.deserialize_compiled(blob)
    couts, compiled = run_counted(lambda: [fn(x) for x in xs])
    log(f"gapi (the loaded program over {GAPI_BATCHES} batches) launches: {compiled}; the "
        f"exported graph calls {called}; export {export_s:.1f} s, {len(blob) / 1e6:.2f} MB")
    for i, ((w, half), (rw, rhalf)) in enumerate(zip(couts, refs)):
        if not torch.equal(w, rw) or not torch.equal(half, rhalf):
            raise AssertionError(f"gapi batch {i}: the loaded program's outputs differ")
    for name, c in (("live", live), ("loaded", compiled)):
        if c["opencv_sep_filter"] != GAPI_BATCHES or c["sep_filter routes"]["k5"] != GAPI_BATCHES \
                or c["opencv_pyr_down"] != GAPI_BATCHES or c["opencv_gauss5_down2"]:
            raise AssertionError(f"gapi {name}: sep_filter k5 and pyr_down must launch once a "
                                 f"batch and nothing else; got {c}")
    if called != ["opencv_tpu_torch.pyr_down.default", "opencv_tpu_torch.sep_filter.default"]:
        raise AssertionError(f"gapi: the exported graph's kernel calls are {called}")
    log(f"gapi: {GAPI_BATCHES} batches of {E.SHAPE}, both outputs equal to entry.forward and the "
        f"eager pyrDown, live and through the loaded program")
    # the Stream's wall against its copies and its compute back to back
    pinned = [torch.from_numpy(b).pin_memory() for b in batches]

    def copies():
        for p in pinned:
            p.to(dev, non_blocking=True)

    stream_ms = _host_ms(lambda: E.forward_gapi(batches, comp, dev))
    copy_ms = _host_ms(copies)
    compute_ms = _host_ms(lambda: [comp.apply(x) for x in xs])
    loaded_ms = _host_ms(lambda: [fn(x) for x in xs])
    nbytes = sum(b.nbytes for b in batches) + sum(w.numel() + h.numel() for w, h in outs)
    log(f"time gapi over {GAPI_BATCHES} batches: Stream {stream_ms:.3f} ms (pinned copies, a "
        f"side stream, the graph), the pinned copies alone {copy_ms:.3f} ms + the graph on "
        f"resident batches {compute_ms:.3f} ms = {copy_ms + compute_ms:.3f} ms back to back; the "
        f"loaded program on resident batches {loaded_ms:.3f} ms; bytes bound of the graph "
        f"{bound(nbytes, 0)[0]:.4f} ms (host clock with a synchronize, median of 3)  [{card}]")
    wall_s = time.perf_counter() - t_start
    log(f"phase 4t wall: {wall_s:.1f} s (budget {PATH_WALL_BUDGET_S:.0f} s)")
    if wall_s > PATH_WALL_BUDGET_S:
        raise AssertionError(f"phase 4t took {wall_s:.1f} s, over its budget")
    return live, compiled


def phase_track_dnn(E, run_counted, count_syncs, dev, card, kernel_syms):
    """4u: GOTURN at its published widths and the other DNN trackers and
    features (see the module's note).  Returns the launch counts of the
    counted run."""
    import tempfile
    import opencv_tpu_torch.dnn as tdnn
    t_start = time.perf_counter()
    frames_np, _, boxes = E.make_motion_video(E.SHAPE_TRACK_DNN)
    frames = torch.from_numpy(frames_np).to(dev)
    t0 = time.perf_counter()
    files = E.goturn_files(0)
    net = tdnn.readNetFromCaffe(*files, device=dev)
    make_s = time.perf_counter() - t0
    n_params = sum(int(np.prod(s)) + s[0] for _, s in E.goturn_layers())
    trackers = E.make_goturn_trackers(net, frames[0], boxes[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    held = []
    t0 = time.perf_counter()
    n_sync, cnt = run_counted(
        lambda: count_syncs(lambda: held.append(E.forward_track_dnn(frames, trackers))))
    wall = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 30
    out = held[0]
    log(f"track_dnn path launches: {cnt}")
    if any(cnt[k] for k in kernel_syms):
        raise AssertionError(f"track_dnn path: no kernel of csrc/ may launch (its convolutions "
                             f"are cuDNN's, as the JAX package's are XLA's); got {cnt}")
    ups = out["updates"]
    if len(ups) != GOTURN_UPDATES:
        raise AssertionError(f"track_dnn: {len(ups)} updates, not {GOTURN_UPDATES}")
    log(f"track_dnn: GOTURN ({n_params:,} parameters, {n_params * 4 / 1e6:.2f} MB f32, "
        f"{E.goturn_flops() / 1e9:.3f} GFLOP a forward) written and read in {make_s:.1f} s; "
        f"{len(trackers)} trackers over {len(frames) - 1} frames: {len(ups)} updates; last boxes "
        f"{out['boxes'][-1].tolist()}")
    # the CPU's net on the card's blobs, all updates as one batch
    t0 = time.perf_counter()
    net_c = tdnn.readNetFromCaffe(*files, device="cpu")
    net_c.setInput(torch.cat([u[3] for u in ups]).cpu(), "data1")
    net_c.setInput(torch.cat([u[4] for u in ups]).cpu(), "data2")
    res_c = net_c.forward("scale").numpy()
    err, moved = 0.0, 0
    for (i, k, region, _, _, res), rc in zip(ups, res_c):
        e = float(np.abs(res - rc).max() / np.abs(rc).max())
        err = max(err, e)
        if e > GOTURN_RTOL:
            raise AssertionError(f"track_dnn frame {i} tracker {k}: the card's output {res} "
                                 f"against the CPU's {rc}")
        got, want = trackers[k].box(res, region), trackers[k].box(rc, region)
        if max(abs(g - w) for g, w in zip(got, want)) > 1:
            raise AssertionError(f"track_dnn frame {i} tracker {k}: box {got} against the "
                                 f"CPU's {want}")
        moved += got != want
    cpu_s = time.perf_counter() - t0
    log(f"track_dnn against the CPU's net on the card's blobs ({cpu_s:.1f} s): outputs within "
        f"{err:.2e} of the largest (gate {GOTURN_RTOL}), every box within 1 px ({moved} of "
        f"{len(ups)} a pixel apart)")
    # the other models, card against CPU
    t0 = time.perf_counter()
    models = E.small_dnn_models()
    with tempfile.TemporaryDirectory() as tmp:
        sweep_g = E.dnn_sweep(models, frames[:SWEEP_FRAMES], boxes[0][0], tmp, dev)
        sweep_c = E.dnn_sweep(models, frames[:SWEEP_FRAMES].cpu(), boxes[0][0], tmp, "cpu")
    for key in ("nano", "dasiam", "vit"):
        for (ok, b, sco), (okc, bc, scc) in zip(sweep_g[key], sweep_c[key]):
            if ok != okc or max(abs(x - y) for x, y in zip(b, bc)) > 1 or abs(sco - scc) > 1e-4:
                raise AssertionError(f"{key}: card ({ok}, {b}, {sco}) against CPU ({okc}, {bc}, "
                                     f"{scc})")
    for key in ("disk", "aliked"):
        for g, c in zip(sweep_g[key], sweep_c[key]):
            if g.shape != c.shape or not np.allclose(g, c, rtol=1e-6, atol=1e-6):
                raise AssertionError(f"{key}: the card differs from the CPU")
    if sweep_g["lightglue"] != "NotImplementedError":
        raise AssertionError("LightGlue's match did not raise NotImplementedError")
    log(f"track_dnn sweep ({time.perf_counter() - t0:.1f} s, frames {SWEEP_FRAMES} of "
        f"{E.SHAPE_TRACK_DNN[1:3]}): Nano {[b for _, b, _ in sweep_g['nano']]}, DaSiamRPN "
        f"{[b for _, b, _ in sweep_g['dasiam']]}, Vit {[b for _, b, _ in sweep_g['vit']]}; DISK "
        f"{len(sweep_g['disk'][0])} and ALIKED {len(sweep_g['aliked'][0])} keypoints; each equal "
        f"to the CPU's (boxes within 1 px, scores 1e-4); LightGlue raises NotImplementedError")
    # the net's time by CUDA events against its bounds
    _, _, _, target, search, _ = ups[0]
    timer = Timer(dev)

    def forward():
        net.setInput(target, "data1")
        net.setInput(search, "data2")
        return net.forward("scale")

    net_ms = timer(forward, iters=20)
    net_dev_ms = timer(forward, iters=20, device_only=True)
    del timer
    upd_ms = _host_ms(lambda: E.forward_track_dnn(frames[:2], trackers), iters=3) / len(trackers)
    nbytes = n_params * 4 + 2 * target.numel() * 4 + 16
    b_bytes, b_flop = nbytes / HBM_BYTES_PER_S * 1e3, E.goturn_flops() / F32_OPS_PER_S * 1e3
    busy, k_ms, f_ms = busy_share(lambda: E.forward_track_dnn(frames, trackers), iters=1,
                                  warmup=False, host_ops=False)
    log(f"time GOTURN forward (1 x 2 x 3 x 227 x 227): {net_ms:.4f} ms as the caller sees it, "
        f"{net_dev_ms:.4f} ms device (CUDA events, median of 20, L2 flushed); bytes bound "
        f"{b_bytes:.4f} ms ({nbytes / 1e6:.1f} MB: the weights read once), FLOP bound "
        f"{b_flop:.4f} ms ({E.goturn_flops() / 1e9:.3f} GFLOP at {F32_OPS_PER_S / 1e12:.0f} "
        f"TFLOP/s f32); share of the bytes bound {b_bytes / net_dev_ms:.4f}; for "
        f"{GOTURN_UPDATES} updates the bytes bound is {b_bytes * GOTURN_UPDATES:.3f} ms  [{card}]")
    log(f"track_dnn forward: {f_ms:.1f} ms for {GOTURN_UPDATES} updates (profiled; the 4u run "
        f"{wall:.1f} ms; one update {upd_ms:.3f} ms on the host clock), device busy share "
        f"{busy:.4f} (kernels {k_ms:.2f} ms), {n_sync} host syncs, peak device memory "
        f"{peak:.3f} GiB over the frames and the net  [{card}]")
    wall_s = time.perf_counter() - t_start
    log(f"phase 4u wall: {wall_s:.1f} s (budget {PATH_WALL_BUDGET_S:.0f} s)")
    if wall_s > PATH_WALL_BUDGET_S:
        raise AssertionError(f"phase 4u took {wall_s:.1f} s, over its budget")
    return cnt


def ml_data(seed=0, shape=ML_SHAPE, classes=ML_CLASSES, queries=ML_QUERIES):
    """MNIST's shape from the seed: (samples, labels, queries, their labels),
    f32 pixels in [0, 1] around a mean image per class."""
    rng = np.random.default_rng(seed)
    n, d = shape
    means = rng.uniform(0.1, 0.9, (classes, d))
    y = rng.integers(0, classes, n)
    yq = rng.integers(0, classes, queries)
    X = np.clip(means[y] + rng.normal(0, 0.3, (n, d)), 0, 1).astype(np.float32)
    Q = np.clip(means[yq] + rng.normal(0, 0.3, (queries, d)), 0, 1).astype(np.float32)
    return X, y.astype(np.int32), Q, yq.astype(np.int32)


def _sync_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def phase_ml(dev, card, data=None):
    """4r: ml on the card against the CPU (see the module's note).  Returns
    the log lines' numbers by name."""
    from opencv_tpu_torch import ml
    from opencv_tpu_torch.ml.carry import arrays_of, from_reference
    t_start = time.perf_counter()
    X, y, Q, yq = data if data is not None else ml_data()
    n = ML_CPU_TRAIN
    nq = ML_CPU_QUERIES
    Xt, Qt = torch.from_numpy(X).to(dev), torch.from_numpy(Q).to(dev)
    out = {}
    # KNearest: the card on every query, the CPU on the first nq
    knn = ml.KNearest_create(dev)
    knn.train(Xt, ml.ROW_SAMPLE, y)
    (_, res, nb, dist), ms = _sync_ms(lambda: knn.findNearest(Qt, 3))
    knn_c = ml.KNearest_create("cpu")
    knn_c.train(X, ml.ROW_SAMPLE, y)
    _, res_c, nb_c, dist_c = knn_c.findNearest(Q[:nq], 3)
    agree = float((res[:nq].cpu().numpy() == res_c).mean())
    nb_same = float((nb[:nq].cpu().numpy() == nb_c).all(1).mean())
    derr = _rel(dist[:nq].cpu().numpy(), dist_c)
    acc = float((res.cpu().numpy().ravel() == yq).mean())
    log(f"ml KNearest k=3 on {X.shape} x {Q.shape}: {ms:.1f} ms on the card (host clock, one "
        f"call); against the CPU on {nq} queries: results agree {agree:.4f}, neighbour labels "
        f"{nb_same:.4f}, distances rel {derr:.2e}; accuracy {acc:.4f}  [{card}]")
    if agree < 0.995 or derr > ML_DIST_TOL:
        raise AssertionError("ml KNearest: the card differs from the CPU")
    out["knn_ms"] = ms
    # NormalBayes, LogisticRegression, ANN_MLP: the card on the whole set
    # (timed), then card and CPU on the first n samples, held together
    for name, make, fit in (
            ("NormalBayes", lambda d: ml.NormalBayesClassifier_create(d),
             lambda m, A, b: m.train(A, ml.ROW_SAMPLE, b)),
            ("LogisticRegression", lambda d: _lr(ml, d),
             lambda m, A, b: m.train(A, ml.ROW_SAMPLE, b.astype(np.float32))),
            ("ANN_MLP", lambda d: _mlp(ml, d),
             lambda m, A, b: m.train(A, 0, _onehot(b)))):
        m = make(dev)
        _, t_ms = _sync_ms(lambda: fit(m, Xt, y))
        (_, pred), p_ms = _sync_ms(lambda: m.predict(Qt))
        pred = pred.cpu().numpy()
        acc = float(((pred.argmax(1) if name == "ANN_MLP" else pred.ravel()) == yq).mean())
        mg, mc = make(dev), make("cpu")
        fit(mg, torch.from_numpy(X[:n]).to(dev), y[:n])
        fit(mc, X[:n], y[:n])
        pg = mg.predict(Qt[:nq])[1].cpu().numpy()
        pc = mc.predict(Q[:nq])[1]
        ag = arrays_of(mg)
        ac = arrays_of(mc)
        if name == "ANN_MLP":
            terr = max(_rel(a, b) for (w, bb), (w2, bb2) in zip(ag["params"], ac["params"])
                       for a, b in ((w, w2), (bb, bb2)))
            same = float((pg.argmax(1) == pc.argmax(1)).mean())
        elif name == "LogisticRegression":
            terr = _rel(ag["theta"], ac["theta"])
            same = float((pg == pc).mean())
        else:
            terr = max(_rel(ag["means"], ac["means"]), _rel(ag["invcov"], ac["invcov"]))
            same = float((pg == pc).mean())
        carried = from_reference(ac, dev)
        pcar = carried.predict(Qt[:nq])[1].cpu().numpy()
        car = float((pcar.argmax(1) == pc.argmax(1)).mean() if name == "ANN_MLP"
                    else (pcar == pc).mean())
        log(f"ml {name}: train {t_ms:.1f} ms, predict {p_ms:.1f} ms on the card at "
            f"{X.shape} / {Q.shape[0]} queries (host clock), accuracy {acc:.4f}; card against "
            f"CPU on {n} samples: trained arrays rel {terr:.2e}, predictions agree {same:.4f}; "
            f"the CPU model carried to the card agrees {car:.4f}  [{card}]")
        if terr > ML_TRAIN_TOL or same < 0.99 or car < 0.999:
            raise AssertionError(f"ml {name}: the card differs from the CPU")
        out[name] = (t_ms, p_ms)
    # the host-loop algorithms at ML_HOST_N samples
    h = ML_HOST_N
    svm_g, svm_c = (ml.SVM_create(d) for d in (dev, "cpu"))
    for s in (svm_g, svm_c):
        s.setKernel(ml.SVM.RBF)
        s.setC(1.0)
        s.setGamma(1.0 / X.shape[1])
        s.setTermCriteria((3, 300, 1e-3))
    _, svm_ms = _sync_ms(lambda: svm_g.train(X[:h], 0, y[:h]))
    svm_c.train(X[:h], 0, y[:h])
    pg = svm_g.predict(Q[:nq])[1]
    pc = svm_c.predict(Q[:nq])[1]
    svm_agree = float((pg == pc).mean())
    svm_acc = float((pg.ravel() == yq[:nq]).mean())
    sd = ml.SVMSGD_create()
    yb = np.where(y[:h] % 2 == 0, 1.0, -1.0).astype(np.float32)
    t0 = time.perf_counter()
    sd.train(X[:h], 0, yb)
    sgd_ms = (time.perf_counter() - t0) * 1e3
    sgd_acc = float((sd.predict(X[:h])[1].ravel() == yb).mean())
    em = ml.EM_create()
    em.setClustersNumber(ML_CLASSES)
    t0 = time.perf_counter()
    ok, _, lbl, _ = em.trainEM(X[:h, :16].astype(np.float64))
    em_ms = (time.perf_counter() - t0) * 1e3
    purity = sum(np.bincount(y[:h][lbl.ravel() == c]).max() for c in np.unique(lbl)) / h
    trees = {}
    for name, mk in (("DTrees", ml.DTrees_create), ("RTrees", ml.RTrees_create),
                     ("Boost", ml.Boost_create)):
        m = mk()
        if name == "RTrees":
            m.setTermCriteria((3, 10, 0))
        yy = (y[:h] % 2) if name == "Boost" else y[:h]
        t0 = time.perf_counter()
        m.train(X[:h, :32].astype(np.float64), 0, yy)
        ms_ = (time.perf_counter() - t0) * 1e3
        yt = (yq[:nq] % 2) if name == "Boost" else yq[:nq]
        trees[name] = (ms_, float((m.predict(Q[:nq, :32])[1].ravel() == yt).mean()))
    log(f"ml host loops at {h} samples: SVM (RBF, 10 classes one-vs-one, the Gram matrix on the "
        f"card) train {svm_ms:.0f} ms, accuracy {svm_acc:.4f}, agrees with the CPU's "
        f"{svm_agree:.4f}; SVMSGD train {sgd_ms:.0f} ms, training accuracy {sgd_acc:.4f}; EM "
        f"(16 features, 10 clusters) {em_ms:.0f} ms, purity {purity:.4f}; "
        + ", ".join(f"{k} {v[0]:.0f} ms accuracy {v[1]:.4f}" for k, v in trees.items())
        + f" (32 features)  [{card}]")
    if svm_agree < 0.99 or not ok:
        raise AssertionError("ml: SVM differs from the CPU's, or EM failed")
    # tests/assets/tiny_cnn.onnx through the port's codec, card against CPU
    import opencv_tpu_torch.dnn as tdnn
    asset = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "assets",
                         "tiny_cnn.onnx")
    net_g, net_c = (tdnn.readNetFromONNX(asset, device=d) for d in (dev, "cpu"))
    rng = np.random.default_rng(0)
    err = 0.0
    for _ in range(4):
        x = rng.normal(0, 1, (1, 1, 16, 16)).astype(np.float32)
        net_g.setInput(torch.from_numpy(x).to(dev))
        net_c.setInput(x)
        err = max(err, float(np.abs(net_g.forward().cpu().numpy() - net_c.forward()).max()))
    img = (rng.random((16, 16)) * 255).astype(np.uint8)
    cls = []
    for d in (dev, "cpu"):
        m = tdnn.ClassificationModel(asset, device=d)
        m.setInputParams(scale=1.0 / 255, size=(16, 16))
        cls.append(m.classify(img))
    log(f"tiny_cnn.onnx (the port's codec) on the card against the CPU: max |d| {err:.2e}; "
        f"ClassificationModel {cls[0]} / {cls[1]}")
    if err > 1e-5 or cls[0][0] != cls[1][0] or abs(cls[0][1] - cls[1][1]) > 1e-5:
        raise AssertionError("tiny_cnn.onnx: the card differs from the CPU")
    wall = time.perf_counter() - t_start
    log(f"phase 4r wall: {wall:.1f} s (budget {ML_WALL_BUDGET_S:.0f} s)")
    if wall > ML_WALL_BUDGET_S:
        raise AssertionError(f"phase 4r took {wall:.1f} s, over its budget")
    return out


def _lr(ml, device):
    m = ml.LogisticRegression_create(device)
    m.setLearningRate(0.1)
    m.setIterations(ML_LR_ITERS)
    return m


def _mlp(ml, device):
    m = ml.ANN_MLP_create(device)
    m.setLayerSizes(list(ML_MLP_LAYERS))
    m.setTrainMethod(0, 0.1)
    m.setTermCriteria((3, ML_MLP_ITERS, 0))
    return m


def _onehot(y):
    return (np.eye(ML_CLASSES, dtype=np.float32)[y] * 2 - 1).astype(np.float32)


def main() -> int:
    # -- 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import opencv_tpu_torch as cv
    from opencv_tpu_torch import entry as E
    from opencv_tpu_torch.kernels import KERNELS, _build
    from opencv_tpu_torch.kernels.fused_preproc import (
        GAUSS5_DOWN2, fused_gray_gauss5_down2, fused_gray_gauss5_down2_plain, gauss5_down2_u8,
        gauss5_down2_u8_plain)
    from opencv_tpu_torch.kernels.fused_preproc import _launch as gauss5_launch
    from opencv_tpu_torch.kernels.fused_preproc import _plan as gauss5_plan
    from opencv_tpu_torch.kernels.sepfilter import (
        SEP_FILTER, SEP_ROUTES, pyr_down_u8, pyr_down_u8_plain, sep_filter_int,
        sep_filter_int_plain, sep_filter_route)
    from opencv_tpu_torch.core.borders import border_index, pad_nhwc
    from opencv_tpu_torch.ops.canny import HYST_CHECK_EVERY
    from opencv_tpu_torch.ops.corners import _gftt_host_tail, good_features_response
    from opencv_tpu_torch.ops.filter import gaussian_kernel_bitexact, gaussian_kernel_fixedpoint_ed
    from opencv_tpu_torch.ops.hist import hist_per_image
    from opencv_tpu_torch.features2d import orb as orb_mod
    from opencv_tpu_torch.features2d.fast import fast_keypoint_mask
    from opencv_tpu_torch.features2d.matchers import hamming_distance_matrix

    # -- 2. build
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.3f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    spills = []
    for name, r in sorted(_build.ptxas_report().items()):
        m = re.search(r"sep_filter_kernelILi(\d+)ELi(\d+)E([hs])E", name)
        if m is None and "sep_generic_kernel" not in name:
            continue
        what = (f"sep_filter_kernel<K={m.group(1)}, C={m.group(2)}, "
                f"{'u8' if m.group(3) == 'h' else 'i16'}>" if m else name)
        log(f"ptxas {what}: {r.get('registers')} registers, {r.get('stack')} bytes stack, "
            f"{r.get('spill_stores')} / {r.get('spill_loads')} bytes spill stores / loads")
        if m and (r.get("spill_stores") or r.get("spill_loads")):
            spills.append(what)
    if spills:
        raise AssertionError(f"sep_filter's template spills registers in {spills}")

    # -- 3. each kernel against its plain version, on the card
    def gauss_taps(k, sigma):
        return tuple(int(v) for v in
                     gaussian_kernel_fixedpoint_ed(gaussian_kernel_bitexact(k, sigma), 8))

    rng = np.random.default_rng(1)
    max_err = {}
    sizes5 = orb_mod.level_sizes(1080, 1920)
    cases = sep_cases(cv, gauss_taps, sizes5)
    for name, shape, kw in cases:
        x = torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(dev)
        err = check_equal(f"sep_filter {name}", sep_filter_int(x, **kw),
                          sep_filter_int_plain(x, **kw))
        if name.startswith("main"):
            max_err["sep_filter"] = max(max_err.get("sep_filter", 0), err)
    kx5, k7 = gauss_taps(5, 0.0), gauss_taps(7, 2.0)
    offset_taps = (dict(kx=kx5, ky=kx5, shift=16),
                   dict(kx=(-1, 0, 1), ky=(1, 2, 1), out_dtype="int16"),
                   dict(kx=k7, ky=k7, shift=16),
                   *(dict(kx=kx, ky=ky, delta=3, scale=0.25, out_dtype="int16")
                     for kx, ky in SOBEL7))
    for name, shape in OFFSET_SHAPES:
        x = offset_view(rng, shape, dev)
        for kw in offset_taps:
            check_equal(f"sep_filter {name} {shape} k{len(kw['kx'])}", sep_filter_int(x, **kw),
                        sep_filter_int_plain(x, **kw))
    for kx, ky in SEP_PHOTO_TAPS:
        x = torch.from_numpy(rng.integers(0, 256, SEP_PHOTO_SHAPE, np.uint8)).to(dev)
        kw = dict(kx=kx, ky=ky, out_dtype="int16", border=cv.BORDER_REPLICATE)
        err = check_equal(f"sep_filter photo k3 C3 {SEP_PHOTO_SHAPE} {kx}", sep_filter_int(x, **kw),
                          sep_filter_int_plain(x, **kw))
        max_err["sep_filter"] = max(max_err["sep_filter"], err)
    log(f"sep_filter: {len(cases) + len(offset_taps) * len(OFFSET_SHAPES)} cases + "
        f"{len(SEP_PHOTO_TAPS)} at the photo path's shape equal to the plain version")

    imgs = torch.from_numpy(E.make_batch()).to(dev)
    n = 0
    for sigma in (0.0, 1.5):
        err = check_equal(f"gauss5_down2 bgr sigma {sigma}",
                          fused_gray_gauss5_down2(imgs, sigma),
                          fused_gray_gauss5_down2_plain(imgs, sigma))
        max_err["gauss5_down2"] = max(max_err.get("gauss5_down2", 0), err)
        n += 1
    gray = cv.cvtColor(imgs, cv.COLOR_BGR2GRAY)[..., 0].contiguous()
    check_equal("gauss5_down2 gray", gauss5_down2_u8(gray, 0.0),
                gauss5_down2_u8_plain(gray, 0.0))
    n += 1
    # the stereo path's rectified pair, N = 2
    x = torch.from_numpy(rng.integers(0, 256, GAUSS_STEREO_SHAPE, np.uint8)).to(dev)
    err = check_equal(f"gauss5_down2 stereo {GAUSS_STEREO_SHAPE}", fused_gray_gauss5_down2(x, 0.0),
                      fused_gray_gauss5_down2_plain(x, 0.0))
    max_err["gauss5_down2"] = max(max_err["gauss5_down2"], err)
    n += 1
    for shape, sigma in (((2, 98, 262, 3), 0.8), ((1, 4, 6, 3), 0.0), ((3, 34, 130, 3), 2.0)):
        x = torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(dev)
        check_equal(f"gauss5_down2 {shape}", fused_gray_gauss5_down2(x, sigma),
                    fused_gray_gauss5_down2_plain(x, sigma))
        check_equal(f"gauss5_down2 gray {shape}", gauss5_down2_u8(x[..., 1].contiguous(), sigma),
                    gauss5_down2_u8_plain(x[..., 1].contiguous(), sigma))
        n += 2
    for shape in GAUSS_CLASS_SHAPES:
        x = torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(dev)
        g = x[..., 1].contiguous()
        for sigma in (0.0, 0.1, 1.5, 20.0):
            check_equal(f"gauss5_down2 {shape} sigma {sigma}", fused_gray_gauss5_down2(x, sigma),
                        fused_gray_gauss5_down2_plain(x, sigma))
            check_equal(f"gauss5_down2 gray {shape} sigma {sigma}", gauss5_down2_u8(g, sigma),
                        gauss5_down2_u8_plain(g, sigma))
            n += 2
    # a contiguous input one byte into its storage: the unaligned path
    for shape in ((2, 40, 64, 3), (1, 20, 1920, 3), (2, 40, 64)):
        size = int(np.prod(shape))
        x = torch.from_numpy(rng.integers(0, 256, size + 1, np.uint8)).to(dev)[1:].view(shape)
        run, plain = ((fused_gray_gauss5_down2, fused_gray_gauss5_down2_plain) if len(shape) == 4
                      else (gauss5_down2_u8, gauss5_down2_u8_plain))
        check_equal(f"gauss5_down2 {shape} at storage offset 1", run(x, 1.5), plain(x, 1.5))
        n += 1
    for shape in GAUSS_RUN_SHAPES:
        x = torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(dev)
        for t, has_bgr, plain in ((x, True, fused_gray_gauss5_down2_plain),
                                  (x[..., 1].contiguous(), False, gauss5_down2_u8_plain)):
            for blocks in (1, 3):
                plan = gauss5_plan(*shape[:3], has_bgr, t.data_ptr())._replace(blocks=blocks)
                check_equal(f"gauss5_down2 {tuple(t.shape)} {plan}",
                            gauss5_launch(t, 1.5, has_bgr, plan), plain(t, 1.5))
                n += 1
    # the entry refuses asymmetric taps, and the wrapper raises
    x = torch.from_numpy(rng.integers(0, 256, (1, 8, 64, 3), np.uint8)).to(dev)
    out = torch.empty((1, 4, 32), dtype=torch.uint8, device=dev)
    plan = gauss5_plan(1, 8, 64, True, x.data_ptr())
    try:
        GAUSS5_DOWN2(dev, x.data_ptr(), out.data_ptr(), 1, 8, 64, 1,
                     (ctypes.c_int * 9)(16, 64, 96, 60, 20, plan.px, plan.blocks, plan.gx,
                                        int(plan.vec)), _build.stream_of(x))
    except RuntimeError:
        pass
    else:
        raise AssertionError("gauss5_down2: the entry took asymmetric taps")
    log(f"gauss5_down2: {n} cases equal to the plain version; asymmetric taps refused")

    cases = pyr_cases(cv)
    for name, shape, border in cases:
        x = torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(dev)
        err = check_equal(f"pyr_down {name}", pyr_down_u8(x, border), pyr_down_u8_plain(x, border))
        if name.startswith("main"):
            max_err["pyr_down"] = max(max_err.get("pyr_down", 0), err)
    for name, shape in OFFSET_SHAPES:
        x = offset_view(rng, shape, dev)
        check_equal(f"pyr_down {name} {shape}", pyr_down_u8(x), pyr_down_u8_plain(x))
    # the segmentation path's two launches, C = 3: frame 0 at 1080p, then its
    # half inside pyrMeanShiftFiltering
    for shape in PYR_SEGMENT_SHAPES:
        x = torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(dev)
        err = check_equal(f"pyr_down segment {shape}", pyr_down_u8(x), pyr_down_u8_plain(x))
        max_err["pyr_down"] = max(max_err["pyr_down"], err)
    for shape in PYR_VIDEO_SHAPES:
        x = torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(dev)
        err = check_equal(f"pyr_down video {shape}", pyr_down_u8(x), pyr_down_u8_plain(x))
        max_err["pyr_down"] = max(max_err["pyr_down"], err)
    log(f"pyr_down: {len(cases) + len(OFFSET_SHAPES) + len(PYR_SEGMENT_SHAPES)} cases "
        f"+ {len(PYR_VIDEO_SHAPES)} at the video path's shapes equal to the plain version")

    # -- 4a. the flagship path
    def run_counted(fn):
        """Run fn with every launch count (and sep_filter's route counts)
        set to 0 first; return its result and the counts it left, the
        routes under "sep_filter routes"."""
        torch.cuda.synchronize()
        for k in KERNELS:
            k.reset()
        result = fn()
        torch.cuda.synchronize()
        return result, {**{k.symbol: k.launches for k in KERNELS},
                        "sep_filter routes": dict(SEP_FILTER.routes)}

    forward, (imgs,) = E.entry("cuda")
    (out, out_fused), flagship = run_counted(lambda: (forward(imgs), E.forward_fused(imgs)))
    log(f"flagship path launches: {flagship}")
    missing = [s for s in ("opencv_sep_filter", "opencv_gauss5_down2") if flagship[s] < 1]
    if missing:
        raise AssertionError(f"kernels not launched by the flagship path: {missing}")

    N, H, W, _ = E.SHAPE
    if out.shape != (N, H // 2, W // 2, 1) or out.dtype != torch.uint8:
        raise AssertionError(f"forward output {tuple(out.shape)} {out.dtype}")
    pre = E.preprocess(imgs)
    check_equal("fused preprocess vs composed", E.preprocess_fused(imgs), pre)
    check_equal("forward_fused vs forward", out_fused, out)

    cpu = imgs[:2].cpu()
    pre_cpu = E.preprocess(cpu)
    if not torch.equal(pre[:2].cpu(), pre_cpu):
        raise AssertionError("preprocess on the card != CPU plain preprocess")
    d = (out[:2].cpu().to(torch.int32) - E.warp(pre_cpu).to(torch.int32)).abs()
    n_diff = int(d.count_nonzero())
    if int(d.max()) > WARP_ATOL or n_diff > WARP_MAX_FRACTION * d.numel():
        raise AssertionError(f"forward vs CPU plain: max |d| {int(d.max())}, {n_diff} differ")
    log(f"flagship path: output {tuple(out.shape)} equals the CPU plain forward on images 0-1 "
        f"(preprocess exact; warp max |d| {int(d.max())}, {n_diff} of {d.numel()} differ)")

    # -- 4b. BASELINE config 3
    forward3, (x3,) = E.entry_pyr_corner_edge("cuda")
    outs3, cfg3 = run_counted(lambda: forward3(x3))
    log(f"config 3 path launches: {cfg3}")
    if cfg3["opencv_pyr_down"] != 1 or cfg3["opencv_sep_filter"] < 3:
        raise AssertionError(f"config 3 path: pyr_down must launch once and sep_filter at "
                             f"least 3 times, got {cfg3}")
    N3, H3, W3, _ = E.SHAPE_CFG3
    shapes = [(N3, (H3 + 1) // 2, (W3 + 1) // 2, 1), (N3, H3, W3, 1), (N3, H3, W3, 1),
              (N3, H3, W3, 1)]
    want_cpu = forward3(x3[:2].cpu())
    for name, got, shape, want in zip(("pyrDown", "cornerHarris", "Sobel", "Canny"),
                                      outs3, shapes, want_cpu):
        if tuple(got.shape) != shape:
            raise AssertionError(f"config 3 {name}: shape {tuple(got.shape)} != {shape}")
        if name == "cornerHarris":
            check_close("config 3 cornerHarris vs CPU, images 0-1", got[:2].cpu(), want,
                        HARRIS_RTOL, HARRIS_ATOL)
        else:
            check_equal(f"config 3 {name} vs CPU, images 0-1", got[:2].cpu(), want)
    canny_edges = int((outs3[3] > 0).sum())
    log(f"config 3: pyrDown, Sobel and Canny equal the CPU plain forward on images 0-1; "
        f"{canny_edges} Canny edge pixels in the batch; total {int(outs3[4])}")

    smooth, blur7 = run_counted(lambda: cv.GaussianBlur(x3, (7, 7), 2.5))
    if blur7["opencv_sep_filter"] != 1 or blur7["sep_filter routes"]["k7"] != 1:
        raise AssertionError(f"GaussianBlur 7x7: one sep_filter launch on route k7 expected, "
                             f"got {blur7}")
    smooth_cpu = cv.GaussianBlur(x3[:2].cpu(), (7, 7), 2.5)
    check_equal("GaussianBlur 7x7 s2.5 vs CPU, images 0-1", smooth[:2].cpu(), smooth_cpu)
    st_gpu, st_cpu = {}, {}
    edges_s = cv.Canny(smooth, 50, 150, stats=st_gpu)
    check_equal("Canny on the smoothed batch vs CPU, images 0-1", edges_s[:2].cpu(),
                cv.Canny(smooth_cpu, 50, 150, stats=st_cpu))
    st_noise = {}
    cv.Canny(x3, 50, 150, stats=st_noise)
    log(f"Canny hysteresis (check every {HYST_CHECK_EVERY}): noise batch {st_noise}; "
        f"smoothed batch {st_gpu} on the card, images 0-1 {st_cpu} on the CPU")

    # -- 4c. BASELINE config 4, and goodFeaturesToTrack
    forward4, (x4, t4) = E.entry_match_morph("cuda")
    outs4, cfg4 = run_counted(lambda: forward4(x4, t4))
    log(f"config 4 path launches: {cfg4} (matchTemplate and the morphology are plain torch)")
    N4, H4, W4, _ = E.SHAPE_CFG4
    th, tw = t4.shape
    for name, got, shape, dtype in zip(
            ("matchTemplate", "erode 3x3", "dilate 5x5", "erode 9x9"), outs4,
            [(N4, H4 - th + 1, W4 - tw + 1, 1)] + [E.SHAPE_CFG4] * 3,
            [torch.float32] + [torch.uint8] * 3):
        if tuple(got.shape) != shape or got.dtype != dtype:
            raise AssertionError(f"config 4 {name}: {tuple(got.shape)} {got.dtype}, "
                                 f"expected {shape} {dtype}")
    want4 = forward4(x4[:2].cpu(), t4.cpu())
    check_rel("config 4 matchTemplate vs CPU, images 0-1", outs4[0][:2].cpu(), want4[0],
              MATCH_TOL)
    for name, got, want in zip(("erode 3x3", "dilate 5x5", "erode 9x9"), outs4[1:4], want4[1:4]):
        check_equal(f"config 4 {name} vs CPU, images 0-1", got[:2].cpu(), want)
    if not torch.isfinite(outs4[4]):
        raise AssertionError(f"config 4 total {outs4[4]}")
    t_plant = x4[0, 500:532, 900:932, 0].clone()
    m_plant = cv.matchTemplate(x4[:1], t_plant, cv.TM_CCOEFF_NORMED)[0, ..., 0]
    best = divmod(int(m_plant.argmax()), m_plant.shape[1])
    score = float(m_plant[best])
    if best != (500, 900) or abs(score - 1.0) > MATCH_TOL:
        raise AssertionError(f"planted template found at {best} with {score}, not (500, 900)")
    log(f"config 4: shapes, morph outputs exact and matchTemplate within {MATCH_TOL} of the CPU "
        f"plain forward on images 0-1; total {float(outs4[4])}; planted template at {best}, "
        f"score {score:.7f}")
    pts_gpu = cv.goodFeaturesToTrack(smooth[:1], 500, 0.01, 10)
    pts_cpu = cv.goodFeaturesToTrack(smooth_cpu[:1], 500, 0.01, 10)
    shared, n_gpu, n_cpu = corner_overlap(pts_gpu, pts_cpu)
    if shared < GFTT_OVERLAP * max(n_gpu, n_cpu):
        raise AssertionError(f"goodFeaturesToTrack: {shared} shared of {n_gpu} (card) and "
                             f"{n_cpu} (CPU)")
    log(f"goodFeaturesToTrack(smoothed image 0, 500, 0.01, 10): {n_gpu} corners on the card, "
        f"{n_cpu} on the CPU, {shared} shared")

    # -- 4d. BASELINE config 5: ORB, then BFMatcher on its descriptors
    forward5, (x5, orb5) = E.entry_orb("cuda")
    res5, cfg5 = run_counted(lambda: forward5(x5, orb5))
    log(f"config 5 path launches: {cfg5}")
    if (cfg5["opencv_sep_filter"] != 8 or cfg5["sep_filter routes"]["k7"] != 8
            or cfg5["opencv_pyr_down"] or cfg5["opencv_gauss5_down2"]):
        raise AssertionError(f"config 5 path: sep_filter must launch 8 times, all on route k7, "
                             f"and no other kernel, got {cfg5}")
    if len(res5) != E.SHAPE_CFG5[0]:
        raise AssertionError(f"config 5: {len(res5)} results for {E.SHAPE_CFG5[0]} images")
    for i, (kps, desc) in enumerate(res5):
        if not (0 < len(kps) <= 2 * orb5.nfeatures and desc.shape == (len(kps), 32)
                and desc.dtype == np.uint8 and {k.octave for k in kps} == set(range(8))
                and all(np.isfinite([k.pt[0], k.pt[1], k.angle, k.response]).all()
                        for k in kps)):
            raise AssertionError(f"config 5 image {i}: {len(kps)} keypoints, descriptors "
                                 f"{desc.shape} {desc.dtype}")
    res5_cpu = forward5(x5[:2].cpu(), cv.ORB_create(nfeatures=500))
    for i in range(2):
        log(orb_compare(f"config 5 image {i} vs CPU", res5[i], res5_cpu[i]))
    cur_g, cur_c = x5[:1, ..., None], x5[:1, ..., None].cpu()
    for lv, size in enumerate(sizes5):
        if lv:
            cur_g = cv.resize(cur_g, size, interpolation=cv.INTER_LINEAR_EXACT)
            cur_c = cv.resize(cur_c, size, interpolation=cv.INTER_LINEAR_EXACT)
            check_equal(f"config 5 image 0 level {lv} resize vs CPU", cur_g.cpu(), cur_c)
        for what, g, c in zip(("FAST score", "FAST mask", "blur 7x7"),
                              orb_mod._level_maps(cur_g, orb5.fast_threshold),
                              orb_mod._level_maps(cur_c, orb5.fast_threshold)):
            check_equal(f"config 5 image 0 level {lv} {what} vs CPU", g.cpu(), c)
    log(f"config 5: image 0's 8 levels (resize, FAST score and mask, blur) equal the CPU's; "
        f"{[len(k) for k, _ in res5]} keypoints per image")
    desc_c, launched = run_counted(lambda: orb5.compute(x5[0], res5[0][0])[1])
    if not np.array_equal(desc_c, res5[0][1]) or launched != cfg5:
        raise AssertionError(f"ORB.compute on the card: {launched} launches, "
                             f"{int((desc_c != res5[0][1]).any(1).sum())} descriptors differ")
    log(f"ORB.compute on the card, image 0's {len(desc_c)} keypoints: the forward's "
        f"descriptors, 8 sep_filter launches on route k7")
    d0, d1 = res5[0][1], res5[1][1]
    bf = cv.BFMatcher(cv.NORM_HAMMING, crossCheck=True)
    d0c, d1c = torch.from_numpy(d0).to(dev), torch.from_numpy(d1).to(dev)
    m_gpu = [(m.queryIdx, m.trainIdx, m.distance) for m in bf.match(d0c, d1c)]
    m_cpu = [(m.queryIdx, m.trainIdx, m.distance) for m in bf.match(d0, d1)]
    if m_gpu != m_cpu:
        raise AssertionError(f"BFMatcher on the card: {len(m_gpu)} matches, CPU {len(m_cpu)}, "
                             f"{len(set(m_gpu) ^ set(m_cpu))} differ")
    log(f"BFMatcher(NORM_HAMMING, crossCheck) image 0 ({len(d0)}) vs image 1 ({len(d1)}) on "
        f"the card: {len(m_gpu)} matches, equal to the CPU's")

    # -- 4e. BASELINE config 2: 4K resize x3, warpAffine, warpPerspective
    forward2, (x2,) = E.entry_resize_warp_4k("cuda")
    outs2, cfg2 = run_counted(lambda: forward2(x2))
    log(f"config 2 path launches: {cfg2} (resize and the warps are plain torch)")
    if any(cfg2[k.symbol] for k in KERNELS):
        raise AssertionError(f"config 2 path: no kernel may launch, got {cfg2}")
    N2, H2, W2, C2 = E.SHAPE_CFG2
    for name, got, shape in zip(CFG2_OPS, outs2, [(N2, H2 // 2, W2 // 2, C2)] * 3
                                + [E.SHAPE_CFG2] * 2):
        if tuple(got.shape) != shape or got.dtype != torch.uint8:
            raise AssertionError(f"config 2 {name}: {tuple(got.shape)} {got.dtype}, "
                                 f"expected {shape} uint8")
    want2 = forward2(x2[:2].cpu())
    for name, got, want in zip(CFG2_OPS[:3], outs2[:3], want2[:3]):
        check_equal(f"config 2 {name} vs CPU, images 0-1", got[:2].cpu(), want)
    warp_diff = []
    for name, got, want in zip(CFG2_OPS[3:], outs2[3:5], want2[3:5]):
        d = (got[:2].cpu().to(torch.int32) - want.to(torch.int32)).abs()
        n_diff = int(d.count_nonzero())
        if int(d.max()) > WARP_ATOL or n_diff > WARP_MAX_FRACTION * d.numel():
            raise AssertionError(f"config 2 {name} vs CPU: max |d| {int(d.max())}, "
                                 f"{n_diff} differ")
        warp_diff.append(f"{name} max |d| {int(d.max())}, {n_diff} of {d.numel()} differ")
    log(f"config 2: shapes; resize LINEAR, AREA and CUBIC equal the CPU plain forward on "
        f"images 0-1; {'; '.join(warp_diff)}; totals {outs2[5].tolist()}")

    # -- 4f. the decode-and-colour path: NV12 -> BGR -> HSV, Lab, YCrCb ->
    # gauss5_down2 -> Otsu -> integral
    from opencv_tpu_torch.core.dispatch import reset_tier_stats, tier_stats
    forward6, (y6, uv6) = E.entry_decode_color("cuda")
    reset_tier_stats()
    outs6, cfg6 = run_counted(lambda: forward6(y6, uv6))
    tiers6 = tier_stats()
    log(f"decode-colour path launches: {cfg6}; dispatch {tiers6}")
    if (cfg6["opencv_gauss5_down2"] != 1 or cfg6["opencv_sep_filter"] or cfg6["opencv_pyr_down"]
            or tiers6 != {"tier.gauss5_down2_u8.cuda": 1}):
        raise AssertionError(f"decode-colour path: gauss5_down2 must launch once, through the "
                             f"registry, and no other kernel; got {cfg6}, {tiers6}")
    N6, H6, W6 = E.SHAPE_NV12
    full, half6 = (N6, H6, W6, 3), (N6, H6 // 2, W6 // 2, 1)
    shapes6 = [full] * 4 + [half6] * 2 + [(N6, H6 // 2 + 1, W6 // 2 + 1, 1)]
    dtypes6 = [torch.uint8] * 6 + [torch.int32]
    for name, got, shape, dtype in zip(E.DECODE_COLOR_OUTPUTS, outs6, shapes6, dtypes6):
        if tuple(got.shape) != shape or got.dtype != dtype:
            raise AssertionError(f"decode-colour {name}: {tuple(got.shape)} {got.dtype}, "
                                 f"expected {shape} {dtype}")
    otsu6 = float(outs6[7])
    # images 0-1 on the card against the CPU plain forward on the same two
    # images: every output, their own Otsu threshold and the sums
    got01 = forward6(y6[:2], uv6[:2])
    want01 = forward6(y6[:2].cpu(), uv6[:2].cpu())
    for name, got, want in zip((*E.DECODE_COLOR_OUTPUTS, "otsu", "sums"), got01, want01):
        check_equal(f"decode-colour images 0-1 {name} vs CPU", got.cpu(), want)
    # the batch's images 0-1: the outputs before the threshold are the
    # same; the batch threshold is the CPU's over the batch's map, and at it
    # the binary map and integral of images 0-1 are the CPU's
    for i, name in enumerate(E.DECODE_COLOR_OUTPUTS[:5]):
        check_equal(f"decode-colour batch {name}, images 0-1 vs CPU", outs6[i][:2].cpu(),
                    want01[i])
    t_cpu, _ = cv.threshold(outs6[4].cpu(), 0, 255, cv.THRESH_BINARY | cv.THRESH_OTSU)
    if float(t_cpu) != otsu6:
        raise AssertionError(f"decode-colour: batch Otsu {otsu6} on the card, {float(t_cpu)} on "
                             f"the CPU")
    _, bin01 = cv.threshold(want01[4], otsu6, 255, cv.THRESH_BINARY)
    check_equal("decode-colour batch binary, images 0-1 vs CPU", outs6[5][:2].cpu(), bin01)
    check_equal("decode-colour batch integral, images 0-1 vs CPU", outs6[6][:2].cpu(),
                cv.integral(bin01))
    check_equal("decode-colour batch sums, images 0-1 vs CPU", outs6[8][:2, :5].cpu(),
                want01[8][:, :5])
    log(f"decode-colour path: outputs {[tuple(o.shape) for o in outs6[:7]]}; images 0-1 equal "
        f"the CPU plain forward (u8 and int32 outputs, Otsu {float(want01[7])}, sums); batch "
        f"Otsu threshold {otsu6}, the CPU's over the batch map; "
        f"{int(outs6[5].count_nonzero())} of {outs6[5].numel()} binary pixels set")

    # -- 4g. the enhancement path: gray -> medianBlur -> CLAHE -> unsharp
    # mask (sep_filter k5) -> bilateralFilter -> gamma LUT -> JET
    forward7, (x7,) = E.entry_enhance("cuda")
    reset_tier_stats()
    outs7, cfg7 = run_counted(lambda: forward7(x7))
    tiers7 = tier_stats()
    log(f"enhancement path launches: {cfg7}; dispatch {tiers7}")
    if (cfg7["opencv_sep_filter"] != 1 or cfg7["sep_filter routes"]["k5"] != 1
            or cfg7["opencv_pyr_down"] or cfg7["opencv_gauss5_down2"]
            or tiers7 != {"tier.sep_filter_u8.cuda": 1}):
        raise AssertionError(f"enhancement path: sep_filter must launch once, on route k5, "
                             f"through the registry, and no other kernel; got {cfg7}, {tiers7}")
    N7, H7, W7, _ = E.SHAPE
    names7 = (*E.ENHANCE_OUTPUTS, "hist", "sums")
    shapes7 = [(N7, H7, W7, 1)] * 6 + [(N7, H7, W7, 3), (N7, 256), (N7, 8)]
    dtypes7 = [torch.uint8] * 7 + [torch.float32, torch.int64]
    for name, got, shape, dtype in zip(names7, outs7, shapes7, dtypes7):
        if tuple(got.shape) != shape or got.dtype != dtype:
            raise AssertionError(f"enhancement {name}: {tuple(got.shape)} {got.dtype}, "
                                 f"expected {shape} {dtype}")

    def near(what, name, got, want) -> str:
        """Exact, or (a float stage, or one after it in the chain) max |d| <=
        WARP_ATOL on at most WARP_MAX_FRACTION of the values; raise
        otherwise; return a summary."""
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"enhancement {what} {name}: {tuple(got.shape)} {got.dtype} "
                                 f"!= {tuple(want.shape)} {want.dtype}")
        d = (got.to(torch.int64) - want.to(torch.int64)).abs()
        n_diff = int(d.count_nonzero())
        if not n_diff:
            return f"{name} exact"
        d_max = int(d.max())
        if (name not in ENHANCE_FLOAT_STAGES or d_max > WARP_ATOL
                or n_diff > WARP_MAX_FRACTION * d.numel()):
            raise AssertionError(f"enhancement {what} {name} vs CPU: {n_diff} of {d.numel()} "
                                 f"differ, max |d| {d_max}")
        return f"{name} {n_diff} of {d.numel()} differ, max |d| {d_max}"

    # each stage of images 0-1 on the card's own input to it, then the
    # histograms and the whole chain against the CPU plain forward
    ins7 = [x7[:2]] + [o[:2] for o in outs7[:len(E.ENHANCE_STAGES) - 1]]
    stage_report = [near("stage", name, got[:2].cpu(), stage(a.cpu()))
                    for (name, stage), a, got in zip(E.ENHANCE_STAGES, ins7, outs7)]
    check_equal("enhancement hist, images 0-1 vs CPU", outs7[7][:2].cpu(),
                hist_per_image(outs7[2][:2].cpu()))
    want7 = forward7(x7[:2].cpu())
    chain_report = [near("chain", name, got[:2].cpu(), want)
                    for name, got, want in zip(names7, outs7, want7)]
    log(f"enhancement path, images 0-1: each stage on the card's own input vs the CPU: "
        f"{'; '.join(stage_report)}; the whole chain vs the CPU plain forward: "
        f"{'; '.join(chain_report)}")

    # -- 4h. the motion path: gray -> GaussianBlur (sep_filter k5) -> phase
    # correlation -> warpAffine -> background -> mask -> components, distance,
    # moments -> contours
    video8, true_shifts8, boxes8 = E.make_motion_video()
    x8 = torch.from_numpy(video8).to(dev)
    reset_tier_stats()
    outs8, cfg8 = run_counted(lambda: E.forward_motion(x8))
    tiers8 = tier_stats()
    log(f"motion path launches: {cfg8}; dispatch {tiers8}")
    if (cfg8["opencv_sep_filter"] != 1 or cfg8["sep_filter routes"]["k5"] != 1
            or cfg8["opencv_pyr_down"] or cfg8["opencv_gauss5_down2"]
            or tiers8 != {"tier.sep_filter_u8.cuda": 1}):
        raise AssertionError(f"motion path: sep_filter must launch once, on route k5, through "
                             f"the registry, and no other kernel; got {cfg8}, {tiers8}")
    N8, H8, W8, _ = E.SHAPE_MOTION
    for key, shape, dtype in (("smooth", (N8, H8, W8, 1), torch.uint8),
                              ("aligned", (N8, H8, W8, 1), torch.uint8),
                              ("background", (1, H8, W8, 1), torch.float32),
                              ("mask", (N8, H8, W8, 1), torch.uint8),
                              ("labels", (N8, H8, W8), torch.int32),
                              ("distance", (N8, H8, W8, 1), torch.float32),
                              ("sums", (N8, len(E.MOTION_SUMS)), torch.int64)):
        got = outs8[key]
        if tuple(got.shape) != shape or got.dtype != dtype or not torch.isfinite(
                got.to(torch.float64)).all():
            raise AssertionError(f"motion {key}: {tuple(got.shape)} {got.dtype}, expected "
                                 f"{shape} {dtype}, finite")
    shift_err = np.abs(outs8["shifts"] - true_shifts8[1:])
    if not shift_err.max() < MOTION_SHIFT_TOL:
        raise AssertionError(f"motion shifts {outs8['shifts'].tolist()} against the video's "
                             f"{true_shifts8[1:].tolist()}: max error {shift_err.max()}")
    labels8 = outs8["labels"].cpu().numpy()
    missed = [(i, k) for i in range(1, N8) for k, (bx, by, bw, bh) in enumerate(boxes8[i])
              if not labels8[i, by:by + bh, bx:bx + bw].any()]
    if missed:
        raise AssertionError(f"motion: object boxes (frame, object) {missed} overlap no "
                             f"component")
    log(f"motion path: shifts {np.round(outs8['shifts'], 4).tolist()} (the video's "
        f"{true_shifts8[1:].tolist()}, max error {shift_err.max():.4f} px, responses "
        f"{np.round(outs8['responses'], 4).tolist()}); all {(N8 - 1) * E.MOTION_OBJECTS} object "
        f"boxes of frames 1-{N8 - 1} overlap a component; labels per frame "
        f"{outs8['n_labels'].tolist()}; {len(outs8['contours'])} contours in frame {N8 - 1}; "
        f"connectedComponents {outs8['cc_steps']}, distanceTransform {outs8['dt_steps']}")
    # frames 0-2 as a three-frame video on the card and the CPU: each stage on
    # the card's own input to it, then the whole chain
    got3 = host_state(E.forward_motion(x8[:3]))
    got3["x"] = x8[:3].cpu()
    stage_report8 = []
    for name, stage, keys in E.MOTION_STAGES:
        st = dict(got3)
        stage(st)
        stage_report8 += motion_compare(f"stage {name}", got3, {k: st[k] for k in keys})
    chain_report8 = motion_compare("chain", got3, E.forward_motion(got3["x"]))
    log(f"motion path, frames 0-2: each stage on the card's own input vs the CPU: "
        f"{'; '.join(stage_report8)}; the whole chain vs the CPU: {'; '.join(chain_report8)}")
    # the contour stage takes the native scan (native/hosttails.cpp); it
    # equals its Python twin on the last frame's mask
    from opencv_tpu_torch.ops import contours as contours_mod
    contours8 = dict((n, f) for n, f, _ in E.MOTION_STAGES)["contours"]
    last8 = outs8["mask"][-1, ..., 0].cpu().numpy()
    twin8 = contours_mod._find_contours_simple((last8 != 0).astype(np.int32),
                                               cv.RETR_EXTERNAL, cv.CHAIN_APPROX_SIMPLE)[0]
    if not same_results(outs8["contours"], twin8):
        raise AssertionError("motion contours: the native scan differs from its Python twin")
    t_ctr8 = host_median(lambda: contours8({"mask": outs8["mask"]}), iters=5, warmup=1)
    t_twin8 = host_median(lambda: contours_mod._find_contours_simple(
        (last8 != 0).astype(np.int32), cv.RETR_EXTERNAL, cv.CHAIN_APPROX_SIMPLE), iters=3,
        warmup=0)
    log(f"motion contour stage (native scan, {len(twin8)} contours, equal to the Python "
        f"trace): {t_ctr8:.4f} ms on the host clock with the frame's read-back (median of 5); "
        f"the Python trace alone {t_twin8:.4f} ms (median of 3)  [{card}]")

    # -- 4i. the lane-and-sign path: gray -> GaussianBlur (sep_filter k5) ->
    # Canny (k3) -> Hough lines -> HoughLinesP -> HoughCircles (k3) -> fitLine
    # -> LSD on frame 0 -> drawing
    from opencv_tpu_torch.ops import hough as hough_mod
    forward9, (x9,) = E.entry_lines("cuda")
    _, truth9 = E.make_road_video()
    reset_tier_stats()
    outs9, cfg9 = run_counted(lambda: forward9(x9))
    tiers9 = tier_stats()
    log(f"lines path launches: {cfg9}; dispatch {tiers9}")
    if (cfg9["opencv_sep_filter"] != 7 or cfg9["sep_filter routes"] != {
            "k3": 6, "k5": 1, "k7": 0, "generic": 0}
            or cfg9["opencv_pyr_down"] or cfg9["opencv_gauss5_down2"]
            or tiers9 != {"tier.sep_filter_u8.cuda": 1, "tier.sep_filter_int.cuda": 6}):
        raise AssertionError(f"lines path: sep_filter must launch through the registry once on "
                             f"route k5 and 6 times on route k3, and no other kernel; got "
                             f"{cfg9}, {tiers9}")
    N9, H9, W9, _ = E.SHAPE_LINES
    for key, shape, dtype in (("gray", (N9, H9, W9, 1), torch.uint8),
                              ("blur", (N9, H9, W9, 1), torch.uint8),
                              ("edges", (N9, H9, W9, 1), torch.uint8),
                              ("drawn", (N9, H9, W9, 3), torch.uint8),
                              ("sums", (N9, len(E.LINES_SUMS)), torch.int64)):
        got = outs9[key]
        if tuple(got.shape) != shape or got.dtype != dtype or got.device.type != "cuda":
            raise AssertionError(f"lines {key}: {tuple(got.shape)} {got.dtype} {got.device}, "
                                 f"expected {shape} {dtype} on the card")
    misses9 = E.road_truth_misses(outs9["segments"], outs9["circles"], truth9)
    if misses9:
        raise AssertionError(f"lines path: not found in the road video: {misses9}")
    n_seg9 = [0 if s_ is None else len(s_) for s_ in outs9["segments"]]
    n_circ9 = [0 if c_ is None else c_.shape[1] for c_ in outs9["circles"]]
    log(f"lines path: all {4 * 2 * N9} marking edges and {truth9['circles'][:, :, 0].size} "
        f"circles of the video found; segments per frame {n_seg9}, circles {n_circ9}, "
        f"{0 if outs9['lsd'][0] is None else len(outs9['lsd'][0])} LSD segments in frame 0, "
        f"{outs9['draw_writes']} device writes of the drawing; Hough lines "
        f"{outs9['hough_stats']}, circles {outs9['circle_stats']}")
    # frames 0-2 on the card and the CPU: each stage on the card's own input
    # to it, then the whole chain
    got9 = host_state(E.forward_lines(x9[:3]))
    got9["x"] = x9[:3].cpu()
    stage_report9 = []
    for name, stage, keys in E.LINES_STAGES:
        st = dict(got9)
        stage(st)
        stage_report9 += lines_compare(f"stage {name}", got9, {k: st[k] for k in keys})
    chain_report9 = lines_compare("chain", got9, E.forward_lines(got9["x"]))
    lsd9 = cv.createLineSegmentDetector()
    pre_g = lsd9.scaled(outs9["gray"][0, ..., 0])
    pre_c = lsd9.scaled(outs9["gray"][0, ..., 0].cpu())
    d_pre = np.abs(pre_g.astype(np.float64) - pre_c)
    n_pre = int(np.count_nonzero(d_pre))
    if d_pre.max() > WARP_ATOL or n_pre > WARP_MAX_FRACTION * d_pre.size:
        raise AssertionError(f"LSD prefilter on the card vs CPU: {n_pre} of {d_pre.size} "
                             f"differ, max |d| {d_pre.max()}")
    log(f"lines path, frames 0-2: each stage on the card's own input vs the CPU: "
        f"{'; '.join(stage_report9)}; the whole chain vs the CPU: {'; '.join(chain_report9)}; "
        f"LSD's prefilter {n_pre} of {d_pre.size} pixels differ (max |d| {d_pre.max():.3g})")

    # the slice's other public functions, card against CPU, on small inputs
    rng9 = np.random.default_rng(9)
    sweep = []

    def same(name, g, c):
        if not same_results(g, c):
            raise AssertionError(f"{name} on the card != CPU")
        sweep.append(name)

    pts9 = np.concatenate([np.stack([np.arange(60), 2 * np.arange(60) + 3], 1),
                           rng9.uniform(0, 120, (40, 2))]).astype(np.float32)
    args9 = (20, 5, -50, 250, 1.0, 0.0, np.pi, np.pi / 180)
    same("HoughLinesPointSet", cv.HoughLinesPointSet(torch.from_numpy(pts9).to(dev), *args9),
         cv.HoughLinesPointSet(pts9, *args9))
    templ9 = np.zeros((40, 40), np.uint8)
    templ9[10:31, 10:12] = templ9[10:31, 29:31] = templ9[10:12, 10:31] = 255
    templ9[29:31, 10:31] = 255
    scene9 = np.zeros((120, 140), np.uint8)
    scene9[45:47, 40:61] = scene9[64:66, 40:61] = scene9[45:66, 40:42] = 255
    scene9[45:66, 59:61] = 255
    for name, make in (("GeneralizedHoughBallard", cv.createGeneralizedHoughBallard),
                       ("GeneralizedHoughGuil", cv.createGeneralizedHoughGuil)):
        res = []
        for d in (dev, "cpu"):
            g = make()
            g.setMinDist(10)
            g.setVotesThreshold(20)
            if name.endswith("Guil"):
                g.setMinAngle(0)
                g.setMaxAngle(30)
                g.setAngleStep(10)
                g.setMinScale(0.8)
                g.setMaxScale(1.2)
                g.setScaleStep(0.1)
                g.setPosThresh(20)
            g.setTemplate(torch.from_numpy(templ9).to(d))
            res.append(g.detect(torch.from_numpy(scene9).to(d)))
        if res[0][0] is None:
            raise AssertionError(f"{name}: nothing found on the card")
        same(name, res[0], res[1])
    mask9 = ((rng9.random((64, 80)) < 0.45) * 255).astype(np.uint8)
    same("findContoursLinkRuns", cv.findContoursLinkRuns(torch.from_numpy(mask9).to(dev)),
         cv.findContoursLinkRuns(mask9))
    f9 = rng9.random((48, 64)).astype(np.float32)
    k9 = rng9.random((3, 3)).astype(np.float32)
    u9 = rng9.integers(0, 256, (48, 64), np.uint8)
    for name, src in (("filter2Dp f32", f9), ("filter2Dp u8", u9)):
        same(name, cv.filter2Dp(torch.from_numpy(src).to(dev), k9, scale=0.5, shift=1.25)
             .cpu().numpy(), cv.filter2Dp(src, k9, scale=0.5, shift=1.25).numpy())
    p9 = rng9.random((64, 80)).astype(np.float32)
    q9 = np.roll(p9, (3, -5), (0, 1))
    pc_g = cv.phaseCorrelateIterative(torch.from_numpy(p9).to(dev), torch.from_numpy(q9).to(dev))
    pc_c = cv.phaseCorrelateIterative(p9, q9)
    if max(abs(a - b) for a, b in zip(pc_g, pc_c)) > MOTION_SHIFT_ATOL:
        raise AssertionError(f"phaseCorrelateIterative: card {pc_g}, CPU {pc_c}")
    sweep.append("phaseCorrelateIterative")
    lp9 = (np.arange(50)[:, None] * [1.0, 0.5] + rng9.normal(0, 1, (50, 2))).astype(np.float32)
    same("fitLine", cv.fitLine(torch.from_numpy(lp9).to(dev), cv.DIST_HUBER, 0, 0.01, 0.01),
         cv.fitLine(lp9, cv.DIST_HUBER, 0, 0.01, 0.01))
    base9 = rng9.integers(0, 256, (60, 80, 3), np.uint8)
    for name, fn in (
            ("line LINE_AA", lambda im: cv.line(im, (3, 5.5), (70.2, 50), (255, 0, 40), 2,
                                                cv.LINE_AA)),
            ("circle filled", lambda im: cv.circle(im, (40, 30), 17, (9, 8, 7), -1)),
            ("ellipse", lambda im: cv.ellipse(im, (40, 30), (20, 10), 30, 0, 270, (1, 2, 3), 2)),
            ("putText", lambda im: cv.putText(im, "Ab 12!", (3, 40), cv.FONT_HERSHEY_SIMPLEX,
                                              0.8, (255, 255, 255), 2)),
            ("drawContours", lambda im: cv.drawContours(
                im, [np.array([[[5, 5]], [[40, 8]], [[30, 35]]])], -1, (0, 0, 255), -1))):
        g = fn(torch.from_numpy(base9.copy()).to(dev))
        same(name, g.cpu().numpy(), fn(base9.copy()))
    log(f"lines slice sweep, card equal to the CPU: {', '.join(sweep)}")

    # -- 4j. the cell-segmentation path: colour correction -> gray ->
    # GaussianBlur (sep_filter k5) -> Otsu -> opening -> sure background and
    # foreground -> markers -> watershed (native, pooled) -> cells and
    # triangles -> frame 0's flood -> pyrDown (pyr_down C = 3) -> mean shift
    # (pyr_down C = 3) -> grabCut -> EMD -> painted boundaries
    from opencv_tpu_torch.ops import segmentation as seg_mod
    forward10, (x10, model10) = E.entry_segment("cuda")
    _, truth10 = E.make_cells_video()
    reset_tier_stats()
    outs10, cfg10 = run_counted(lambda: forward10(x10, model10))
    tiers10 = tier_stats()
    log(f"segmentation path launches: {cfg10}; dispatch {tiers10}")
    if (cfg10["opencv_sep_filter"] != 1 or cfg10["sep_filter routes"] != {
            "k3": 0, "k5": 1, "k7": 0, "generic": 0}
            or cfg10["opencv_pyr_down"] != 2 or cfg10["opencv_gauss5_down2"]
            or tiers10 != {"tier.sep_filter_u8.cuda": 1, "tier.pyr_down_u8.cuda": 2}):
        raise AssertionError(f"segmentation path: sep_filter must launch through the registry "
                             f"once on route k5 and pyr_down twice, and no other kernel; got "
                             f"{cfg10}, {tiers10}")
    N10, H10, W10, _ = E.SHAPE_SEGMENT
    for key, shape, dtype in (("corrected", (N10, H10, W10, 3), torch.uint8),
                              ("opening", (N10, H10, W10, 1), torch.uint8),
                              ("distance", (N10, H10, W10, 1), torch.float32),
                              ("markers", (N10, H10, W10), torch.int32),
                              ("regions", (N10, H10, W10), torch.int32),
                              ("flood", (H10, W10), torch.uint8),
                              ("cut_mask", (H10 // 2, W10 // 2), torch.uint8),
                              ("painted", (N10, H10, W10, 3), torch.uint8),
                              ("sums", (N10, len(E.SEGMENT_SUMS)), torch.int64)):
        got = outs10[key]
        if tuple(got.shape) != shape or got.dtype != dtype or got.device.type != "cuda":
            raise AssertionError(f"segment {key}: {tuple(got.shape)} {got.dtype} {got.device}, "
                                 f"expected {shape} {dtype} on the card")
    rep10 = E.segment_truth_report(outs10, truth10)
    bad = [n for n, k in rep10["counts"] if abs(n - k) > SEGMENT_COUNT_TOL * k]
    if (rep10["missed"] or rep10["shared"] or bad or rep10["flood_bg"] < FLOOD_MIN_BG
            or rep10["flood_cells"] or rep10["cut_iou"] < CUT_MIN_IOU):
        raise AssertionError(f"segmentation path against the video's truth: {rep10}")
    log(f"segmentation path: every cell centre of the {N10} frames in a region of its own; "
        f"regions / cells per frame {rep10['counts']}; frame 0's flood covers "
        f"{rep10['flood_bg']:.4f} of the background and {rep10['flood_cells']} cell-interior "
        f"pixels; grabCut's IoU with the cells in its rect {outs10['cut_rect']} "
        f"{rep10['cut_iou']:.4f}; Otsu {float(outs10['otsu'])}; triangles per frame "
        f"{[len(t) for t in outs10['triangles']]}; EMD to frame 0 "
        f"{np.round(outs10['emd'], 5).tolist()}; mean shift {outs10['ms_stats']}; min cuts "
        f"{[round(v, 1) for v in outs10['gc_stats']['maxflow_ms']]} ms on the host")
    # frames 0-1 on the card and the CPU: each stage on the card's own input
    # to it, then the whole chain
    got10 = host_state(E.forward_segment(x10[:2], model10))
    got10.update(x=x10[:2].cpu(), model=model10)
    stage_report10 = []
    for name, stage, keys in E.SEGMENT_STAGES:
        st = dict(got10)
        stage(st)
        stage_report10 += segment_compare(f"stage {name}", got10, {k: st[k] for k in keys})
    t0 = time.perf_counter()
    chain10 = E.forward_segment(got10["x"], model10)
    t_chain = time.perf_counter() - t0
    if torch.equal(chain10["corrected"], got10["corrected"]):
        chain_report10 = segment_compare("chain", got10, chain10)
    else:
        # the warp bound let a corrected pixel move: what follows differs
        # by its input, and is held stage by stage above
        chain_report10 = segment_compare("chain", got10, {"corrected": chain10["corrected"]})
    log(f"segmentation path, frames 0-1: each stage on the card's own input vs the CPU: "
        f"{'; '.join(stage_report10)}; the whole chain vs the CPU ({t_chain:.1f} s on the "
        f"host): {'; '.join(chain_report10)}")
    del got10, chain10

    # the slice's other public functions, card against CPU, on small inputs
    sweep = []
    frame0 = outs10["corrected"][0]
    for mode in ("zero crossing", "canny"):
        feats = []
        for src in (frame0, frame0.cpu()):
            sc = cv.segmentation.IntelligentScissorsMB()
            if mode == "canny":
                sc.setEdgeFeatureCannyParameters(50, 100)
            sc.applyImage(src)
            feats.append((sc._non_edge, sc._grad_dir, sc._grad_mag))
        same(f"IntelligentScissorsMB.applyImage {mode} {tuple(frame0.shape)}", *feats)
    crop = frame0[200:320, 300:460]
    paths = []
    for src in (crop, crop.cpu()):
        sc = cv.segmentation.IntelligentScissorsMB()
        sc.applyImage(src)
        sc.buildMap((80, 60))
        paths.append((sc._paths, sc.getContour((10, 110)), sc.getContour((150, 5))))
    same("IntelligentScissorsMB.buildMap/getContour (120, 160)", *paths)
    rng10 = np.random.default_rng(10)
    # integer-valued points, as grabCut's colours: their f64 sums are exact
    # in any order
    pts10 = np.rint(rng10.normal(0, 8, (3000, 3)) + np.repeat(
        rng10.uniform(-50, 50, (5, 3)), 600, axis=0)).astype(np.float32)
    init10 = rng10.integers(0, 5, (3000, 1)).astype(np.int32)
    for name, flags in (("RANDOM", cv.KMEANS_RANDOM_CENTERS), ("PP", cv.KMEANS_PP_CENTERS),
                        ("USE_INITIAL_LABELS", cv.KMEANS_USE_INITIAL_LABELS)):
        k_g = cv.kmeans(torch.from_numpy(pts10).to(dev), 5, init10, (3, 20, 0.0), 2, flags)
        k_c = cv.kmeans(torch.from_numpy(pts10), 5, init10, (3, 20, 0.0), 2, flags)
        same(f"kmeans {name} labels and centres", (k_g[1].cpu(), k_g[2].cpu()), k_c[1:])
        if abs(k_g[0] - k_c[0]) > 1e-5 * abs(k_c[0]):
            raise AssertionError(f"kmeans {name} compactness: card {k_g[0]}, CPU {k_c[0]}")
    fimg = np.cumsum(rng10.random((60, 80)).astype(np.float32), 0)
    ff_g = cv.floodFill(torch.from_numpy(fimg).to(dev), None, (20, 30), 99.0, 0.7, 0.5, 8)
    ff_c = cv.floodFill(torch.from_numpy(fimg), None, (20, 30), 99.0, 0.7, 0.5, 8)
    same("floodFill f32", (ff_g[0], ff_g[1].cpu(), ff_g[2].cpu(), ff_g[3]), ff_c)
    sub_g, sub_c = cv.Subdiv2D((0, 0, W10, H10)), cv.Subdiv2D((0, 0, W10, H10))
    cent = outs10["centroids"][0]
    sub_g.insert(torch.from_numpy(cent).to(dev))
    sub_c.insert(cent)
    same("Subdiv2D.getVoronoiFacetList", sub_g.getVoronoiFacetList([]),
         sub_c.getVoronoiFacetList([]))
    same("Subdiv2D.locate", [sub_g.locate(torch.tensor(q, device=dev)) for q in
                             ((500.0, 400.0), (17.0, 3.0))],
         [sub_c.locate(q) for q in ((500.0, 400.0), (17.0, 3.0))])
    same("ccm getters", [getattr(model10, g)() for g in
                         ("getCCM", "getLoss", "getMask", "getWeights", "getSrcLinearRGB",
                          "getRefLinearRGB")],
         [getattr(E.fit_cells_model(), g)() for g in
          ("getCCM", "getLoss", "getMask", "getWeights", "getSrcLinearRGB", "getRefLinearRGB")])
    log(f"segmentation slice sweep, card equal to the CPU: {', '.join(sweep)}")

    # -- 4k. the registration path: gray -> resize to 0.6 Mpx (LINEAR_EXACT)
    # -> SIFT (pyramids and masks on the card, one read-back, host tails) ->
    # FLANN kNN of each consecutive pair -> the ratio test
    video11, truth11 = E.make_pan_video()
    x11 = torch.from_numpy(video11).to(dev)
    reset_tier_stats()
    held11 = []
    t11 = time.perf_counter()
    n_sync11, cfg11 = run_counted(
        lambda: count_syncs(lambda: held11.append(E.forward_register(x11))))
    wall11 = (time.perf_counter() - t11) * 1e3
    outs11 = held11[0]
    tiers11 = tier_stats()
    log(f"registration path launches: {cfg11}; dispatch {tiers11}")
    if (cfg11["opencv_sep_filter"] or cfg11["opencv_pyr_down"] or cfg11["opencv_gauss5_down2"]
            or any(k.endswith(".cuda") for k in tiers11)):
        raise AssertionError(f"registration path: no kernel may launch (its float ops have "
                             f"none); got {cfg11}, {tiers11}")
    N11, H11, W11, _ = E.SHAPE_REGISTER
    w11, h11 = E.register_size(H11, W11)
    for key, shape, dtype in (("gray", (N11, H11, W11, 1), torch.uint8),
                              ("small", (N11, h11, w11, 1), torch.uint8)):
        got = outs11[key]
        if tuple(got.shape) != shape or got.dtype != dtype:
            raise AssertionError(f"register {key}: {tuple(got.shape)} {got.dtype}")
    for o, levels in enumerate(outs11["gpyr"] + outs11["dog"]):
        for a in levels:
            if a.dtype != torch.float32 or not bool(torch.isfinite(a).all()):
                raise AssertionError(f"register pyramid octave {o}: {a.dtype}, finite")
    rep11 = E.register_truth_report(outs11, truth11, E.SHAPE_REGISTER, (w11, h11),
                                    REGISTER_TOL_PX)
    n_kp11 = [len(k) for k in outs11["keypoints"]]
    if rep11["share"] < REGISTER_MIN_SHARE or min(n for n, _, _ in rep11["per_pair"]) < \
            REGISTER_MIN_GOOD:
        raise AssertionError(f"registration truth: {rep11}")
    log(f"registration path: {w11}x{h11} registration frames, {len(outs11['gpyr'])} octaves, "
        f"keypoints per frame {n_kp11}; good pairs per frame pair "
        f"{[c[0] for c in outs11['counts']]} of {[c[1] for c in outs11['counts']]} queried; "
        f"{rep11['share']:.4f} of good pairs within {REGISTER_TOL_PX} px of the pan's truth "
        f"(per pair: share {[round(r[1], 4) for r in rep11['per_pair']]}, median error "
        f"{[round(r[2], 4) for r in rep11['per_pair']]} px); {n_sync11} host syncs; the "
        f"forward {wall11:.1f} ms on the host clock  [{card}]")
    # frames 0-1 on the CPU: every level and mask, the keypoints, the
    # descriptors and pair 0's matches equal the card's exactly
    cpu11 = E.forward_register(x11[:2].cpu())
    n_lv = 0
    for key in ("gray", "small"):
        check_equal(f"register {key} frames 0-1", outs11[key][:2].cpu(), cpu11[key])
    for key in ("gpyr", "dog", "masks"):
        for o, (g_oct, c_oct) in enumerate(zip(outs11[key], cpu11[key])):
            if len(g_oct) != len(c_oct):
                raise AssertionError(f"register {key} octave {o}: {len(g_oct)} levels on the "
                                     f"card, {len(c_oct)} on the CPU")
            for i, (g_lv, c_lv) in enumerate(zip(g_oct, c_oct)):
                check_equal(f"register {key} octave {o} level {i}", g_lv[:2].cpu(), c_lv)
                n_lv += 1
    for b in range(2):
        kg = [(k.pt, k.size, k.angle, k.response, k.octave) for k in outs11["keypoints"][b]]
        kc = [(k.pt, k.size, k.angle, k.response, k.octave) for k in cpu11["keypoints"][b]]
        if kg != kc or not np.array_equal(outs11["descriptors"][b], cpu11["descriptors"][b]):
            raise AssertionError(f"register frame {b}: {len(kg)} keypoints on the card, "
                                 f"{len(kc)} on the CPU, or their descriptors differ")
    knn_g = [[(m.queryIdx, m.trainIdx, m.distance) for m in r] for r in outs11["knn"][0]]
    knn_c = [[(m.queryIdx, m.trainIdx, m.distance) for m in r] for r in cpu11["knn"][0]]
    if knn_g != knn_c or not np.array_equal(outs11["good"][0], cpu11["good"][0]):
        raise AssertionError("register pair 0: the card's matches differ from the CPU's")
    log(f"registration path, frames 0-1: gray, the resize, all {n_lv} pyramid levels and "
        f"masks, the {n_kp11[:2]} keypoints (pt, size, angle, response, octave), their "
        f"descriptors and pair 0's {len(knn_g)} kNN rows and {len(outs11['good'][0])} good "
        f"pairs equal the CPU plain forward exactly")
    del cpu11

    # -- 4l. the mesh at world size 1: one NCCL rank on a FileStore, the
    # spatial filters through sep_filter (k5) and the all-reduced statistics
    import tempfile

    import torch.distributed as dist

    from opencv_tpu_torch import parallel as par
    from opencv_tpu_torch.ops.hist import hist_fixed
    gray12 = cv.cvtColor(imgs, cv.COLOR_BGR2GRAY)
    timer12 = Timer(dev)
    walls12 = {}
    with tempfile.TemporaryDirectory() as d12:
        dist.init_process_group("nccl", store=dist.FileStore(f"{d12}/store", 1), rank=0,
                                world_size=1)
        try:
            mesh12 = par.make_mesh(1, 1)
            local12 = par.shard_batch(gray12, mesh12)
            blur12, cfg12a = run_counted(
                lambda: par.spatial_gaussian_blur(local12, (5, 5), 1.1, mesh12))
            sep12, cfg12b = run_counted(
                lambda: par.spatial_sep_filter(local12, (5, 5), 1.1, mesh12,
                                               border=cv.BORDER_REFLECT_101))
            for what, c in (("spatial_gaussian_blur", cfg12a), ("spatial_sep_filter", cfg12b)):
                if (c["opencv_sep_filter"] != 1 or c["sep_filter routes"]["k5"] != 1
                        or c["opencv_pyr_down"] or c["opencv_gauss5_down2"]):
                    raise AssertionError(f"mesh {what}: sep_filter must launch once, on route "
                                         f"k5, and no other kernel; got {c}")
            check_equal("mesh spatial_gaussian_blur vs GaussianBlur 5x5 BORDER_CONSTANT",
                        blur12, cv.GaussianBlur(gray12, (5, 5), 1.1,
                                                borderType=cv.BORDER_CONSTANT))
            check_equal("mesh spatial_sep_filter REFLECT_101 vs GaussianBlur 5x5", sep12,
                        cv.GaussianBlur(gray12, (5, 5), 1.1))
            otsu12 = par.sharded_otsu(local12, mesh12)
            want_otsu12 = cv.threshold(gray12, 0, 255, cv.THRESH_BINARY | cv.THRESH_OTSU)[0]
            mn12, mx12 = par.sharded_min_max(local12, mesh12)
            want_mm12 = cv.minMaxLoc(gray12.reshape(-1, gray12.shape[2]))[:2]
            hist12 = par.sharded_hist(local12, mesh12)
            want_hist12 = hist_fixed(gray12.to(torch.int32), 256)
            if (float(otsu12) != float(want_otsu12) or (int(mn12), int(mx12)) != want_mm12
                    or not torch.equal(hist12.to(torch.int64), want_hist12)):
                raise AssertionError(f"mesh reductions: Otsu {float(otsu12)} / "
                                     f"{float(want_otsu12)}, min/max {(int(mn12), int(mx12))} / "
                                     f"{want_mm12}, histograms equal "
                                     f"{torch.equal(hist12.to(torch.int64), want_hist12)}")
            # walls, as the caller sees them (CUDA events, median of 20)
            for what, fn in (
                    ("spatial_gaussian_blur", lambda: par.spatial_gaussian_blur(
                        local12, (5, 5), 1.1, mesh12)),
                    ("spatial_sep_filter REFLECT_101", lambda: par.spatial_sep_filter(
                        local12, (5, 5), 1.1, mesh12, border=cv.BORDER_REFLECT_101)),
                    ("GaussianBlur 5x5 (single card)", lambda: cv.GaussianBlur(gray12, (5, 5),
                                                                               1.1)),
                    ("sharded_hist", lambda: par.sharded_hist(local12, mesh12)),
                    ("sharded_otsu", lambda: par.sharded_otsu(local12, mesh12)),
                    ("sharded_min_max", lambda: par.sharded_min_max(local12, mesh12))):
                walls12[what] = timer12(fn)
        finally:
            dist.destroy_process_group()
    cfg12 = {k: cfg12a[k] + cfg12b[k] for k in cfg12a if k != "sep_filter routes"}
    cfg12["sep_filter routes"] = {r: cfg12a["sep_filter routes"][r] + cfg12b["sep_filter routes"][r]
                                  for r in cfg12a["sep_filter routes"]}
    log(f"mesh at world size 1 (NCCL, 1x1 mesh) on {tuple(gray12.shape)}: "
        f"spatial_gaussian_blur and spatial_sep_filter (REFLECT_101) equal GaussianBlur 5x5 "
        f"under the same border exactly, each through one sep_filter launch on route k5 "
        f"(launches {cfg12}); sharded_otsu {float(otsu12)} equals threshold's Otsu, "
        f"sharded_min_max {(int(mn12), int(mx12))} and sharded_hist equal the single-card "
        f"results; the group is destroyed")
    for what, t in walls12.items():
        log(f"time mesh {what} {tuple(gray12.shape)}: {t:.4f} ms  [{card}]")
    del blur12, sep12, local12, gray12

    # -- 4m. the feature-tracking path: fusedPreprocessGrayBlurDown2
    # (gauss5_down2) -> AKAZE, BRISK and (frames 0-1) KAZE -> kNN of each
    # consecutive pair -> the ratio test
    t13_start = time.perf_counter()
    if E.SHAPE_TRACK != E.SHAPE_REGISTER:
        raise AssertionError("the tracking path runs on the registration path's pan video")
    x13, truth13 = x11, truth11
    reset_tier_stats()
    held13 = []
    t13 = time.perf_counter()
    n_sync13, cfg13 = run_counted(
        lambda: count_syncs(lambda: held13.append(E.forward_track(x13))))
    wall13 = (time.perf_counter() - t13) * 1e3
    outs13 = held13[0]
    tiers13 = tier_stats()
    log(f"tracking path launches: {cfg13}; dispatch {tiers13}")
    if (cfg13["opencv_gauss5_down2"] != 1 or cfg13["opencv_sep_filter"]
            or cfg13["opencv_pyr_down"]
            or {k: v for k, v in tiers13.items() if k.endswith(".cuda")}
            != {"tier.gauss5_down2_u8.cuda": 1}):
        raise AssertionError(f"tracking path: gauss5_down2 must launch once (BGR route, through "
                             f"the registry) and no other kernel; got {cfg13}, {tiers13}")
    N13, H13, W13, _ = E.SHAPE_TRACK
    small13 = outs13["small"]
    if tuple(small13.shape) != (N13, H13 // 2, W13 // 2) or small13.dtype != torch.uint8:
        raise AssertionError(f"track small: {tuple(small13.shape)} {small13.dtype}")
    for det in ("akaze", "kaze"):
        for i, lv in enumerate(outs13[f"{det}_levels"]):
            for key in ("Lt", "Lx", "Ly", "Ldet"):
                a = lv[key]
                if a.dtype != torch.float32 or not bool(torch.isfinite(a).all()):
                    raise AssertionError(f"track {det} level {i} {key}: {a.dtype}, finite")
    reps13 = {det: E.track_truth_report(outs13, truth13, E.SHAPE_TRACK, det, TRACK_TOL_PX)
              for det in E.TRACK_DETECTORS}
    n_kp13 = {det: [len(k) for k in outs13[f"{det}_keypoints"]] for det in E.TRACK_DETECTORS}
    for det in E.TRACK_DETECTORS:
        rep = reps13[det]
        log(f"tracking path, {det}: keypoints per frame {n_kp13[det]}; good pairs per frame pair "
            f"{[c[0] for c in outs13['counts'][det]]} of {[c[1] for c in outs13['counts'][det]]} "
            f"queried; {rep['share']:.4f} of good pairs within {TRACK_TOL_PX} px of the pan's "
            f"truth (per pair: share {[round(r[1], 4) for r in rep['per_pair']]}, median error "
            f"{[round(r[2], 4) for r in rep['per_pair']]} px)")
    for det, need in TRACK_MIN_GOOD.items():
        rep = reps13[det]
        if rep["share"] < TRACK_MIN_SHARE[det] or min(n for n, _, _ in rep["per_pair"]) < need:
            raise AssertionError(f"tracking truth, {det}: {rep}")
    log(f"tracking path: {len(outs13['akaze_levels'])} AKAZE levels, "
        f"{len(outs13['brisk_layers'])} BRISK layers, {len(outs13['kaze_levels'])} KAZE levels "
        f"on {E.TRACK_KAZE_FRAMES} frames; {n_sync13} host syncs; the forward {wall13:.1f} ms on "
        f"the host clock  [{card}]")
    # frames 0-1 on the CPU: every stage equal to the card's exactly
    t13_cpu = time.perf_counter()
    cpu13 = E.forward_track(x13[:2].cpu())
    cpu_ms13 = (time.perf_counter() - t13_cpu) * 1e3
    check_equal("track small frames 0-1", small13[:2].cpu(), cpu13["small"])
    n_lv13 = 0
    for det in ("akaze", "kaze"):
        g_lv, c_lv = outs13[f"{det}_levels"], cpu13[f"{det}_levels"]
        if len(g_lv) != len(c_lv):
            raise AssertionError(f"track {det}: {len(g_lv)} levels on the card, {len(c_lv)} on "
                                 f"the CPU")
        for i, (g, c) in enumerate(zip(g_lv, c_lv)):
            for key in ("Lt", "Lx", "Ly", "Ldet"):
                check_equal(f"track {det} level {i} {key}", g[key][:2].cpu(), c[key])
            n_lv13 += 1
    for i, (g, c) in enumerate(zip(outs13["akaze_masks"], cpu13["akaze_masks"])):
        check_equal(f"track akaze mask {i}", g[:2].cpu(), c)
    if len(outs13["brisk_layers"]) != len(cpu13["brisk_layers"]):
        raise AssertionError("track brisk: the card's and the CPU's layer counts differ")
    for i, (g, c, (gs, gk), (cs, ck)) in enumerate(zip(
            outs13["brisk_layers"], cpu13["brisk_layers"], outs13["brisk_scores"],
            cpu13["brisk_scores"])):
        check_equal(f"track brisk layer {i}", g[:2].cpu(), c)
        check_equal(f"track brisk layer {i} score", gs[:2].cpu(), cs)
        check_equal(f"track brisk layer {i} keep", gk[:2].cpu(), ck)
    n_pairs13 = {}
    for det in E.TRACK_DETECTORS:
        for b in range(2):
            kg = [(k.pt, k.size, k.angle, k.response, k.octave, k.class_id)
                  for k in outs13[f"{det}_keypoints"][b]]
            kc = [(k.pt, k.size, k.angle, k.response, k.octave, k.class_id)
                  for k in cpu13[f"{det}_keypoints"][b]]
            if kg != kc or not np.array_equal(outs13[f"{det}_descriptors"][b],
                                              cpu13[f"{det}_descriptors"][b]):
                raise AssertionError(f"track {det} frame {b}: {len(kg)} keypoints on the card, "
                                     f"{len(kc)} on the CPU, or their descriptors differ")
        knn_g = [[(m.queryIdx, m.trainIdx, m.distance) for m in r] for r in outs13["knn"][det][0]]
        knn_c = [[(m.queryIdx, m.trainIdx, m.distance) for m in r] for r in cpu13["knn"][det][0]]
        if knn_g != knn_c or not np.array_equal(outs13["good"][det][0], cpu13["good"][det][0]):
            raise AssertionError(f"track {det} pair 0: the card's matches differ from the CPU's")
        n_pairs13[det] = (len(knn_g), len(outs13["good"][det][0]))
    log(f"tracking path, frames 0-1: the small frames, all {n_lv13} AKAZE and KAZE levels (Lt, "
        f"Lx, Ly, Ldet) and AKAZE's masks, the {len(outs13['brisk_layers'])} BRISK layers with "
        f"their score and keep maps, each detector's keypoints (pt, size, angle, response, "
        f"octave, class_id) {[n_kp13[d][:2] for d in E.TRACK_DETECTORS]} and descriptors, and "
        f"pair 0's (kNN rows, good pairs) {n_pairs13} equal the CPU plain forward exactly; the "
        f"CPU's frames 0-1 took {cpu_ms13:.1f} ms")
    del cpu13
    wall4m = time.perf_counter() - t13_start
    log(f"phase 4m wall: {wall4m:.1f} s (the card's forward, the truth, the CPU's frames 0-1 and "
        f"the comparison)")

    # -- 4n. the video-analytics path: gray -> goodFeaturesToTrack -> LK
    # (pyr_down of each pair's levels) -> shake -> aligned -> MOG2 -> pyrDown
    # of the batch (pyr_down) -> Farneback
    t14_start = time.perf_counter()
    video14, shifts14, boxes14 = E.make_motion_video(E.SHAPE_VIDEO)
    x14 = torch.from_numpy(video14).to(dev)
    reset_tier_stats()
    held14 = []
    t14 = time.perf_counter()
    n_sync14, cfg14 = run_counted(
        lambda: count_syncs(lambda: held14.append(E.forward_video(x14))))
    wall14 = (time.perf_counter() - t14) * 1e3
    outs14 = held14[0]
    tiers14 = tier_stats()
    log(f"video path launches: {cfg14}; dispatch {tiers14}")
    N14, H14, W14, _ = E.SHAPE_VIDEO
    n_pyr14 = 3 * (N14 - 1) + 1
    if (cfg14["opencv_pyr_down"] != n_pyr14 or cfg14["opencv_sep_filter"]
            or cfg14["opencv_gauss5_down2"]
            or {k: v for k, v in tiers14.items() if k.endswith(".cuda")}
            != {"tier.pyr_down_u8.cuda": n_pyr14}):
        raise AssertionError(f"video path: pyr_down must launch {n_pyr14} times through the "
                             f"registry and no other kernel; got {cfg14}, {tiers14}")
    flow14, masks14 = outs14["flow"], outs14["masks"]
    if (tuple(flow14.shape) != (N14 - 1, H14 // 2, W14 // 2, 2) or flow14.dtype != torch.float32
            or not bool(torch.isfinite(flow14).all())):
        raise AssertionError(f"video flow: {tuple(flow14.shape)} {flow14.dtype}")
    if tuple(masks14.shape) != (N14, H14, W14) or masks14.dtype != torch.uint8:
        raise AssertionError(f"video masks: {tuple(masks14.shape)} {masks14.dtype}")
    rep14 = E.video_truth_report(outs14, shifts14, boxes14, E.SHAPE_VIDEO)
    log(f"video path truth: KLT (points clear of the movers by {E.VIDEO_LK_REACH} px, share "
        f"within 0.5 px) {[(n, round(v, 4)) for n, v in rep14['klt']]}; with no margin "
        f"{[(n, round(v, 4)) for n, v in rep14['klt_all']]}; shake |d| "
        f"{[round(v, 5) for v in rep14['shake']]} px; dense |d| "
        f"{[round(v, 5) for v in rep14['dense']]} px; MOG2 frames 4.. (least, mean box share, "
        f"foreground in boxes, static) {[tuple(round(v, 4) for v in r) for r in rep14['bg']]}; "
        f"gates: KLT >= {VIDEO_KLT_SHARE} of >= {VIDEO_KLT_MIN} points, shake and dense <= "
        f"{VIDEO_SHIFT_TOL} px, MOG2 frames {VIDEO_BG_FIRST}.. least >= {VIDEO_BG_BOX_MIN}, mean "
        f">= {VIDEO_BG_BOX_MEAN}, in boxes >= {VIDEO_BG_IN_BOX}, static <= {VIDEO_BG_STATIC}")
    bad14 = []
    if any(v < VIDEO_KLT_SHARE or n < VIDEO_KLT_MIN for n, v in rep14["klt"]):
        bad14.append("klt")
    if max(rep14["shake"]) > VIDEO_SHIFT_TOL:
        bad14.append("shake")
    if max(rep14["dense"]) > VIDEO_SHIFT_TOL:
        bad14.append("dense")
    late14 = rep14["bg"][VIDEO_BG_FIRST - 4:]
    if (any(r[0] < VIDEO_BG_BOX_MIN or r[1] < VIDEO_BG_BOX_MEAN or r[2] < VIDEO_BG_IN_BOX
            for r in late14) or any(r[3] > VIDEO_BG_STATIC for r in rep14["bg"])):
        bad14.append("bg")
    if bad14:
        raise AssertionError(f"video truth fails {bad14}: {rep14}")
    log(f"video path: {len(outs14['corners'])} corners, {n_sync14} host syncs; the forward "
        f"{wall14:.1f} ms on the host clock  [{card}]")
    # frames 0-1 on the CPU: each stage on the card's own inputs, then the
    # CPU's own chain of frames 0-1
    t14_cpu = time.perf_counter()
    gray14 = outs14["gray"][:2, ..., 0].cpu()
    corners_c14 = cv.goodFeaturesToTrack(gray14[0], **E.VIDEO_GFTT)
    shared14, n_g14, n_c14 = corner_overlap(outs14["corners"], corners_c14)
    if shared14 < GFTT_OVERLAP * max(n_g14, n_c14):
        raise AssertionError(f"video corners: {shared14} shared of {n_g14} (card), {n_c14} (CPU)")

    def lk_compare(what, p_got, s_got, p_want, s_want):
        d = np.abs(p_got.astype(np.float64) - p_want).max(axis=-1)
        near, same = float((d <= VIDEO_LK_TOL).mean()), float((s_got == s_want).mean())
        if near < VIDEO_LK_SHARE or same < VIDEO_LK_SHARE:
            raise AssertionError(f"{what}: {near} of the points within {VIDEO_LK_TOL} px, "
                                 f"status equal on {same}")
        return f"{what}: max |d| {d.max():.3g} px, status equal on {same:.4f}"

    def flow_compare(what, got, want):
        d = (got - want).abs().amax(dim=-1)
        share = float((d <= VIDEO_FLOW_TOL).float().mean())
        if share < VIDEO_FLOW_SHARE:
            raise AssertionError(f"{what}: {share} of the pixels within {VIDEO_FLOW_TOL} px")
        return f"{what}: max |d| {float(d.max()):.3g} px, {int((d != 0).sum())} pixels differ"

    p_c14, s_c14, _ = cv.calcOpticalFlowPyrLK(gray14[0], gray14[1], outs14["corners"])
    notes14 = [lk_compare("LK (0, 1)", outs14["tracks"][0], outs14["status"][0], p_c14[:, 0],
                          s_c14[:, 0])]
    mog14 = cv.createBackgroundSubtractorMOG2()
    for i in range(2):
        check_equal(f"video MOG2 mask {i}", masks14[i].cpu(),
                    mog14.apply(outs14["aligned"][i].cpu()))
    half14 = outs14["half"][:2].cpu()
    check_equal("video half frames 0-1", half14, cv.pyrDown(gray14[..., None])[..., 0])
    notes14.append(flow_compare("Farneback (0, 1)", flow14[0].cpu(), cv.calcOpticalFlowFarneback(
        half14[0], half14[1], *E.VIDEO_FARNEBACK)))
    cpu14 = E.forward_video(x14[:2].cpu())
    shared_c14 = corner_overlap(outs14["corners"], cpu14["corners"])[0]
    if shared_c14 < GFTT_OVERLAP * max(n_g14, len(cpu14["corners"])):
        raise AssertionError("video chain: the CPU's corners differ from the card's")
    if np.array_equal(outs14["corners"], cpu14["corners"]):
        notes14.append(lk_compare("chain LK (0, 1)", outs14["tracks"][0], outs14["status"][0],
                                  cpu14["tracks"][0], cpu14["status"][0]))
    if not np.allclose(outs14["shifts"][0], cpu14["shifts"][0], atol=VIDEO_LK_TOL, rtol=0):
        raise AssertionError(f"video chain shake: {outs14['shifts'][0]} on the card, "
                             f"{cpu14['shifts'][0]} on the CPU")
    check_equal("video chain masks 0-1", masks14[:2].cpu(), cpu14["masks"])
    notes14.append(flow_compare("chain Farneback (0, 1)", flow14[0].cpu(), cpu14["flow"][0]))
    cpu_ms14 = (time.perf_counter() - t14_cpu) * 1e3
    log(f"video path, frames 0-1 against the CPU: corners {shared14} shared of {n_g14} / "
        f"{n_c14}; {'; '.join(notes14)}; MOG2 masks 0-1 and the half frames equal; the CPU's "
        f"chain: corners {shared_c14} shared, shake {cpu14['shifts'][0].tolist()}, masks equal; "
        f"the CPU took {cpu_ms14:.1f} ms")
    del cpu14, half14, gray14
    wall4n = time.perf_counter() - t14_start
    log(f"phase 4n wall: {wall4n:.1f} s (the card's forward, the truth, the CPU's frames 0-1 and "
        f"the comparison)")

    # -- 4o. the photo-finishing path: AlignMTB -> MergeMertens -> NL-means
    # -> detailEnhance -> textureFlattening (Canny: sep_filter k3 twice,
    # C = 3) -> inpaint
    t15_start = time.perf_counter()
    info15 = E.make_bracket(E.SHAPE_PHOTO)
    x15, face15, wire15 = (torch.from_numpy(a).to(dev) for a in (info15[0], info15[3], info15[4]))
    reset_tier_stats()
    held15 = []
    t15 = time.perf_counter()
    n_sync15, cfg15 = run_counted(
        lambda: count_syncs(lambda: held15.append(E.forward_photo(x15, face15, wire15))))
    wall15 = (time.perf_counter() - t15) * 1e3
    outs15 = held15[0]
    tiers15 = tier_stats()
    log(f"photo path launches: {cfg15}; dispatch {tiers15}")
    if (cfg15["opencv_sep_filter"] != 2 or cfg15["sep_filter routes"]["k3"] != 2
            or cfg15["opencv_pyr_down"] or cfg15["opencv_gauss5_down2"]
            or {k: v for k, v in tiers15.items() if k.endswith(".cuda")}
            != {"tier.sep_filter_int.cuda": 2}):
        raise AssertionError(f"photo path: sep_filter must launch twice on route k3 through the "
                             f"registry and no other kernel; got {cfg15}, {tiers15}")
    h15, w15 = outs15["fused"].shape[:2]
    for key in ("fused", "denoised", "detailed", "flattened", "inpainted"):
        o = outs15[key]
        if tuple(o.shape) != (h15, w15, 3) or o.dtype != torch.uint8 or o.device != dev:
            raise AssertionError(f"photo {key}: {tuple(o.shape)} {o.dtype} {o.device}")
    rep15 = E.photo_truth_report(outs15, info15)
    got15, want15, same15 = rep15["align"]
    log(f"photo path truth: shifts {got15.tolist()} (planted undone {want15.tolist()}); PSNR "
        f"against the twin's fusion: denoised {rep15['denoise'][0]:.4f} dB, fused "
        f"{rep15['denoise'][1]:.4f} dB, gain {rep15['denoise'][2]:.4f} dB; face |Sobel| ratio "
        f"{rep15['flatten'][0]:.4f}, outside within 1: {rep15['flatten'][1]:.4f}; wire over "
        f"ring {rep15['inpaint'][0]:.4f} (before {rep15['inpaint'][1]:.4f}); gates: gain >= "
        f"{PHOTO_DENOISE_GAIN}, ratio <= {PHOTO_FLAT_RATIO}, outside >= {PHOTO_OUTSIDE_SHARE}, "
        f"wire >= {PHOTO_INPAINT_RATIO}")
    bad15 = [name for name, ok in (
        ("align", same15), ("denoise", rep15["denoise"][2] >= PHOTO_DENOISE_GAIN),
        ("flatten", rep15["flatten"][0] <= PHOTO_FLAT_RATIO
         and rep15["flatten"][1] >= PHOTO_OUTSIDE_SHARE),
        ("inpaint", rep15["inpaint"][0] >= PHOTO_INPAINT_RATIO)) if not ok]
    if bad15:
        raise AssertionError(f"photo truth fails {bad15}: {rep15}")
    log(f"photo path: output {(h15, w15, 3)}, {n_sync15} host syncs; the forward {wall15:.1f} ms "
        f"on the host clock  [{card}]")
    # card against CPU on a smaller bracket (the CPU's 21x21 NL-means at
    # 1080p is minutes of host time): the chain on both, then each stage
    # on the CPU from the card's own inputs
    t15_cpu = time.perf_counter()
    small15 = E.make_bracket(PHOTO_CHECK_SHAPE)
    args15 = [torch.from_numpy(a) for a in (small15[0], small15[3], small15[4])]
    g15 = E.forward_photo(*(a.to(dev) for a in args15))
    c15 = E.forward_photo(*args15)
    if not np.array_equal(g15["shifts"], c15["shifts"]):
        raise AssertionError(f"photo shifts: card {g15['shifts']}, CPU {c15['shifts']}")
    check_equal("photo aligned frames", g15["aligned"].cpu(), c15["aligned"])
    st15 = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in g15.items()}
    notes15 = []
    for name, stage, keys in E.PHOTO_STAGES[1:]:
        cpu = dict(st15)
        stage(cpu)
        for key in keys:
            d = (cpu[key].to(torch.int32) - st15[key].to(torch.int32)).abs()
            n_diff = int(d.count_nonzero())
            if name == "inpaint" and n_diff:
                raise AssertionError(f"photo inpaint: {n_diff} values differ on the CPU")
            if int(d.max()) > PHOTO_ATOL or n_diff > (1 - PHOTO_SHARE) * d.numel():
                raise AssertionError(f"photo {name}: max |d| {int(d.max())}, {n_diff} of "
                                     f"{d.numel()} differ")
            notes15.append(f"{name} max |d| {int(d.max())} on {n_diff} of {d.numel()}")
    dc15 = max(int((g15[k].cpu().to(torch.int32) - c15[k].to(torch.int32)).abs().max())
               for k in ("fused", "denoised", "detailed", "flattened", "inpainted"))
    cpu_ms15 = (time.perf_counter() - t15_cpu) * 1e3
    log(f"photo path {PHOTO_CHECK_SHAPE} against the CPU: shifts {g15['shifts'].tolist()} and "
        f"the aligned frames equal; stage by stage on the card's inputs: {'; '.join(notes15)}; "
        f"the two chains' outputs within {dc15}; {cpu_ms15:.1f} ms")
    del g15, c15, st15
    wall4o = time.perf_counter() - t15_start
    log(f"phase 4o wall: {wall4o:.1f} s (the card's forward, the truth, the {PHOTO_CHECK_SHAPE} "
        f"bracket on the card and the CPU, and the comparison)")

    # -- 4p. the stereo-depth path: calibrate_rig once (findChessboardCorners
    # and cornerSubPix on 24 views, calibrateCamera per camera,
    # stereoCalibrate, stereoRectify, the maps), then forward_stereo: remap
    # -> gauss5_down2 (N = 2) -> StereoSGBM at half size -> cvtColor and
    # StereoBM at full size -> filterSpeckles -> reprojectImageTo3D
    t16_start = time.perf_counter()
    data16 = E.make_stereo_rig(E.SHAPE_STEREO)
    render16 = time.perf_counter() - t16_start
    views16 = torch.from_numpy(data16["views"]).to(dev)
    t0 = time.perf_counter()
    rig16 = E.calibrate_rig(views16, data16["object_points"])
    torch.cuda.synchronize()
    calib16 = time.perf_counter() - t0
    pair16 = torch.from_numpy(data16["scene"]).to(dev)
    reset_tier_stats()
    held16 = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base16 = torch.cuda.memory_allocated()
    t16 = time.perf_counter()
    n_sync16, cfg16 = run_counted(
        lambda: count_syncs(lambda: held16.append(E.forward_stereo(pair16, rig16))))
    wall16 = (time.perf_counter() - t16) * 1e3
    peak16 = (torch.cuda.max_memory_allocated() - base16) / 2 ** 30
    outs16 = held16[0]
    tiers16 = tier_stats()
    log(f"stereo path launches: {cfg16}; dispatch {tiers16}")
    if (cfg16["opencv_gauss5_down2"] != 1 or cfg16["opencv_sep_filter"]
            or cfg16["opencv_pyr_down"] or tiers16 != {"tier.gauss5_down2_u8.cuda": 1}):
        raise AssertionError(f"stereo path: gauss5_down2 must launch once (BGR route, through the "
                             f"registry) and no other kernel; got {cfg16}, {tiers16}")
    N16, H16, W16, _ = E.SHAPE_STEREO
    for key, shape, dtype in (("rectified", (2, H16, W16, 3), torch.uint8),
                              ("half", (2, H16 // 2, W16 // 2), torch.uint8),
                              ("sgbm", (H16 // 2, W16 // 2), torch.int16),
                              ("gray", (2, H16, W16), torch.uint8),
                              ("bm", (H16, W16), torch.int16),
                              ("bm_filtered", (H16, W16), torch.int16),
                              ("xyz", (H16, W16, 3), torch.float32)):
        o = outs16[key]
        if tuple(o.shape) != shape or o.dtype != dtype or o.device != dev:
            raise AssertionError(f"stereo {key}: {tuple(o.shape)} {o.dtype} {o.device}")
    rep16 = E.stereo_truth_report(rig16, outs16, data16)
    g16 = E.STEREO_GATES
    log(f"stereo path truth: pairs used {rig16['pairs']} of {N16}; intrinsics within "
        f"{rep16['intrinsics'][0]:.6f}, {rep16['intrinsics'][1]:.6f} (gate {g16['intrinsics']}); "
        f"|T| {rep16['baseline'][0]:.4f} mm, off by {rep16['baseline'][1]:.6f} (gate "
        f"{g16['baseline']}); RMS {rep16['rms'][0]:.4f}, {rep16['rms'][1]:.4f} px, stereo "
        f"{rep16['rms'][2]:.4f} (gate {g16['rms']}); rectified rows {rep16['rows']:.4f} px (gate "
        f"{g16['rows']}); SGBM within 1 px {rep16['sgbm'][0]:.4f} (gate {g16['sgbm_within']}), "
        f"valid {rep16['sgbm'][1]:.4f} (gate {g16['sgbm_valid']}), of all valid "
        f"{rep16['sgbm'][2]:.4f}; BM within 1 px {rep16['bm'][0]:.4f} (gate {g16['bm_within']}), "
        f"valid {rep16['bm'][1]:.4f}, of all valid {rep16['bm'][2]:.4f}")
    bad16 = [name for name, ok in (
        ("intrinsics", max(rep16["intrinsics"]) <= g16["intrinsics"]),
        ("baseline", rep16["baseline"][1] <= g16["baseline"]),
        ("rms", max(rep16["rms"][:2]) <= g16["rms"]), ("rows", rep16["rows"] <= g16["rows"]),
        ("sgbm", rep16["sgbm"][0] >= g16["sgbm_within"]
         and rep16["sgbm"][1] >= g16["sgbm_valid"]),
        ("bm", rep16["bm"][0] >= g16["bm_within"])) if not ok]
    if bad16:
        raise AssertionError(f"stereo truth fails {bad16}: {rep16}")
    if not bool(torch.isfinite(outs16["xyz"]).all()):
        raise AssertionError("stereo depth: non-finite values")
    log(f"stereo path: render {render16:.1f} s (host numpy), calibrate_rig {calib16:.1f} s; the "
        f"forward {wall16:.1f} ms on the host clock, {n_sync16} host syncs, peak device memory "
        f"over the input {peak16:.3f} GiB  [{card}]")
    # card against CPU: the first pair's corners, the rectification and the
    # half pair whole, then StereoSGBM on a band of the half pair and
    # StereoBM, filterSpeckles and the depth on a band of the full pair, each
    # from the card's own input
    t16_cpu = time.perf_counter()
    i16 = rig16["pairs"][0]
    for c in range(2):
        gray_c = cv.cvtColor(data16["views"][i16, c], cv.COLOR_BGR2GRAY)
        ok, pts = cv.findChessboardCorners(gray_c, E.STEREO_BOARD, flags=3)
        pts = cv.cornerSubPix(gray_c, pts, (11, 11), (-1, -1), (3, 30, 0.01)) if ok else None
        if pts is None or not np.array_equal(pts, rig16["corners"][0, c]):
            raise AssertionError(f"stereo corners of pair {i16} camera {c + 1}: the CPU's differ")
    maps_c = [m.cpu() for m in rig16["maps"]]
    rect_c = torch.stack([cv.remap(data16["scene"][c], maps_c[2 * c], maps_c[2 * c + 1],
                                   cv.INTER_LINEAR) for c in range(2)])
    check_equal("stereo rectified pair", outs16["rectified"].cpu(), rect_c)
    check_equal("stereo half pair", outs16["half"].cpu(),
                fused_gray_gauss5_down2_plain(outs16["rectified"].cpu(), 0.0))
    y0, y1 = STEREO_HALF_BAND
    hb = outs16["half"][:, y0:y1].contiguous()
    sg_g = E.stereo_sgbm().compute(hb[0], hb[1])
    sg_c = E.stereo_sgbm().compute(hb[0].cpu(), hb[1].cpu())
    check_equal(f"stereo SGBM on half rows {STEREO_HALF_BAND}", sg_g.cpu(), sg_c)
    y0, y1 = STEREO_BAND
    gb = outs16["gray"][:, y0:y1].contiguous()
    bm_g = E.stereo_bm().compute(gb[0], gb[1])
    bm_c = E.stereo_bm().compute(gb[0].cpu(), gb[1].cpu())
    check_equal(f"stereo BM on rows {STEREO_BAND}", bm_g.cpu(), bm_c)
    sp = dict(newVal=-16, maxSpeckleSize=E.STEREO_BM["speckleWindowSize"],
              maxDiff=E.STEREO_BM["speckleRange"])
    fs_g = cv.filterSpeckles(bm_g, **sp)
    fs_c = cv.filterSpeckles(bm_c, **sp)
    check_equal(f"stereo filterSpeckles on rows {STEREO_BAND}", fs_g.cpu(), fs_c)
    xyz_g = cv.reprojectImageTo3D(fs_g.to(torch.float32) / 16.0, rig16["Q"], True)
    xyz_c = cv.reprojectImageTo3D(fs_c.to(torch.float32) / 16.0, rig16["Q"], True)
    check_equal(f"stereo depth on rows {STEREO_BAND}", xyz_g.cpu(), xyz_c)
    cpu_s16 = time.perf_counter() - t16_cpu
    log(f"stereo path against the CPU: pair {i16}'s corners, the rectified and half pairs, SGBM "
        f"on half rows {STEREO_HALF_BAND}, BM, filterSpeckles and the depth on rows "
        f"{STEREO_BAND} equal; {cpu_s16:.1f} s")
    del sg_g, sg_c, bm_g, bm_c, xyz_g, xyz_c, rect_c, maps_c
    wall4p = time.perf_counter() - t16_start
    log(f"phase 4p wall: {wall4p:.1f} s (render {render16:.1f} s, calibrate_rig {calib16:.1f} s, "
        f"the card's forward, the truth, the CPU's corners and bands {cpu_s16:.1f} s; budget "
        f"{STEREO_WALL_BUDGET_S:.0f} s)")

    # -- 4q. the detection path: blobFromImages (1/255, 416x416, swapRB) ->
    # YOLOv3-tiny read by readNetFromDarknet (cuDNN convolutions, no TF32)
    # -> DetectionModel.detect's decode -> NMSBoxesBatched; no kernel of csrc/
    kernel_syms = [k.symbol for k in KERNELS]
    cfg17 = phase_detect(E, run_counted, count_syncs, dev, card, kernel_syms)

    # -- 4r. ml on the card against the CPU (KNearest, NormalBayes,
    # LogisticRegression and ANN_MLP at MNIST's shape; SVM, SVMSGD, EM and
    # the trees at ML_HOST_N), and tests/assets/tiny_cnn.onnx
    _, cfg18 = run_counted(lambda: phase_ml(dev, card))
    log(f"ml launches: {cfg18}")
    if any(cfg18[k] for k in kernel_syms):
        raise AssertionError(f"ml: no kernel of csrc/ may launch; got {cfg18}")

    # -- 4s. the stitching path: Stitcher.create().stitch over the pan (ORB,
    # BFMatcher, RANSAC findHomography, warpPerspective, the seam, the blend)
    cfg19 = phase_stitch(E, run_counted, count_syncs, dev, card, kernel_syms, k7)

    # -- 4t. the flagship chain as a G-API graph through Stream, live and
    # through its torch.export bytes
    cfg20, cfg21 = phase_gapi(E, run_counted, dev, card)

    # -- 4u. GOTURN at its published widths, six trackers over the motion
    # video, and the other DNN trackers and features
    cfg22 = phase_track_dnn(E, run_counted, count_syncs, dev, card, kernel_syms)

    # -- 5. timing
    timer = Timer(dev)
    g1 = gray[..., None].contiguous()
    n1 = g1.numel()  # 8 * 1080 * 1920 pixels
    n_half = N3 * ((H3 + 1) // 2) * ((W3 + 1) // 2)
    k5 = (1, 4, 6, 4, 1)
    sobel = ((-1, 0, 1), (1, 2, 1))
    # (name, kernel, plain, what, bytes in + out, operations, library call or
    # None, sep_filter's taps or None)
    xs16 = torch.from_numpy(rng.integers(0, 256, GAUSS_STEREO_SHAPE, np.uint8)).to(dev)
    rows = [
        ("sep_filter", lambda: sep_filter_int(g1, kx5, kx5, shift=16),
         lambda: sep_filter_int_plain(g1, kx5, kx5, shift=16), "(8,1080,1920,1) k5 u8",
         2 * n1, 2 * 10 * n1, conv_yardstick(g1, kx5, kx5, 1, dev), (kx5, kx5)),
        ("sep_filter sobel", lambda: sep_filter_int(x3, *sobel, out_dtype="int16"),
         lambda: sep_filter_int_plain(x3, *sobel, out_dtype="int16"),
         "(8,1080,1920,1) Sobel dx u8->16S", 3 * n1, 2 * 6 * n1,
         conv_yardstick(x3, *sobel, 1, dev), sobel),
        ("gauss5_down2", lambda: fused_gray_gauss5_down2(imgs, 0.0),
         lambda: fused_gray_gauss5_down2_plain(imgs, 0.0), "(8,1080,1920,3) bgr",
         imgs.numel() + n_half, 2 * 13 * n1, None, None),
        ("gauss5_down2 stereo", lambda: fused_gray_gauss5_down2(xs16, 0.0),
         lambda: fused_gray_gauss5_down2_plain(xs16, 0.0), f"{GAUSS_STEREO_SHAPE} bgr",
         xs16.numel() + xs16.numel() // 12, 2 * 13 * (xs16.numel() // 3), None, None),
        ("gauss5_down2 gray", lambda: gauss5_down2_u8(gray, 0.0),
         lambda: gauss5_down2_u8_plain(gray, 0.0), "(8,1080,1920) gray", n1 + n_half,
         2 * 10 * n1, None, None),
        ("pyr_down", lambda: pyr_down_u8(x3), lambda: pyr_down_u8_plain(x3),
         "(8,1080,1920,1) REFLECT_101", n1 + n_half, 2 * (5 * n1 // 2 + 5 * n_half),
         conv_yardstick(x3, k5, k5, 2, dev), None),
    ]
    # pyr_down with C = 3 on the segmentation path's two inputs
    for shape in PYR_SEGMENT_SHAPES:
        a = torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(dev)
        n_in, n_out = a.numel(), a.numel() // 4
        rows.append((f"pyr_down c3 {shape[1]}x{shape[2]}", lambda a=a: pyr_down_u8(a),
                     lambda a=a: pyr_down_u8_plain(a), f"{shape} REFLECT_101", n_in + n_out,
                     2 * (5 * n_in // 2 + 5 * n_out), conv_yardstick(a, k5, k5, 2, dev), None))
    # pyr_down on the video path's LK pairs (N = 2) at its three levels
    for shape in PYR_VIDEO_SHAPES[:3]:
        a = torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(dev)
        n_in, n_out = a.numel(), a.numel() // 4
        rows.append((f"pyr_down video {shape[0]}x{shape[1]}x{shape[2]}",
                     lambda a=a: pyr_down_u8(a), lambda a=a: pyr_down_u8_plain(a),
                     f"{shape} REFLECT_101", n_in + n_out, 2 * (5 * n_in // 2 + 5 * n_out),
                     conv_yardstick(a, k5, k5, 2, dev), None))
    # sep_filter at each of ORB's levels (the pyramid of the config-5 batch),
    # as the blur launches it; then the generic kernel, which no main path
    # launches, at k = 9 on the level-2 shape
    levels = [x5[..., None]]
    for size in sizes5[1:]:
        levels.append(cv.resize(levels[-1], size, interpolation=cv.INTER_LINEAR_EXACT))
    k9 = gauss_taps(9, 2.0)
    for name, a, kx in ((*((f"sep_filter k7 level {lv}", a, k7) for lv, a in enumerate(levels)),
                         ("sep_filter generic k9 level 2", levels[2], k9))):
        rows.append((name, lambda a=a, kx=kx: sep_filter_int(a, kx, kx, shift=16,
                                                             border=cv.BORDER_REFLECT_101),
                     lambda a=a, kx=kx: sep_filter_int_plain(a, kx, kx, shift=16,
                                                             border=cv.BORDER_REFLECT_101),
                     f"{tuple(a.shape)} k{len(kx)} s2 REFLECT_101", 2 * a.numel(),
                     2 * 2 * len(kx) * a.numel(), conv_yardstick(a, kx, kx, 1, dev), (kx, kx)))
    # sep_filter on route k3 at the photo path's shape: Canny's dx of the
    # masked three-channel frame, u8 -> i16 (its dy is the same work)
    a = torch.from_numpy(rng.integers(0, 256, SEP_PHOTO_SHAPE, np.uint8)).to(dev)
    kx3, ky3 = SEP_PHOTO_TAPS[0]
    kw3 = dict(out_dtype="int16", border=cv.BORDER_REPLICATE)
    rows.append(("sep_filter k3 photo", lambda: sep_filter_int(a, kx3, ky3, **kw3),
                 lambda: sep_filter_int_plain(a, kx3, ky3, **kw3),
                 f"{SEP_PHOTO_SHAPE} Sobel dx u8->16S REPLICATE", 3 * a.numel(), 2 * 6 * a.numel(),
                 conv_yardstick(a, kx3, ky3, 1, dev), (kx3, ky3)))
    log(f"library_ms: one F.conv2d (cuDNN) on a pre-padded f32 NCHW copy, "
        f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")
    times = {}
    for name, kern, plain, what, nbytes, ops, lib, taps in rows:
        t_plain = timer(plain)
        t_kern = timer(kern)
        t_lib = timer(lib) if lib is not None else None
        b_ms, b_by = bound(nbytes, ops)
        times[name] = dict(what=what, ms=t_kern, plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by,
                           library_ms=t_lib)
        if taps is not None:
            times[name]["route"] = SEP_ROUTES[sep_filter_route(*taps)]
        log(f"time {name} {what}{' route ' + times[name]['route'] if taps else ''}: kernel "
            f"{t_kern:.4f} ms, plain {t_plain:.4f} ms, "
            f"library {'none' if t_lib is None else f'{t_lib:.4f} ms'}, bound {b_ms:.4f} ms "
            f"({b_by}), share of bound {b_ms / t_kern:.3f}  [{card}]")
    t_fwd = timer(lambda: forward(imgs))
    t_fused = timer(lambda: E.forward_fused(imgs))
    log(f"time forward (8,1080,1920,3): {t_fwd:.4f} ms  [{card}]")
    log(f"time forward_fused (8,1080,1920,3): {t_fused:.4f} ms  [{card}]")
    x3f = x3.to(torch.float32) / 255.0
    for name, fn in (("pyrDown", lambda: cv.pyrDown(x3)),
                     ("cornerHarris(x/255, 2, 3, 0.04)", lambda: cv.cornerHarris(x3f, 2, 3, 0.04)),
                     ("Sobel 16S dx", lambda: cv.Sobel(x3, cv.CV_16S, 1, 0)),
                     ("Canny 50/150 noise", lambda: cv.Canny(x3, 50, 150)),
                     ("Canny 50/150 smoothed", lambda: cv.Canny(smooth, 50, 150))):
        log(f"time op {name} (8,1080,1920,1): {timer(fn):.4f} ms  [{card}]")
    log(f"time forward_pyr_corner_edge (8,1080,1920,1): {timer(lambda: forward3(x3)):.4f} ms  "
        f"[{card}]")
    # config 4, as the caller sees it (host work included; the device part
    # of each op is perf/profile_torch_forward.py --path cfg4's).  Bytes: each
    # input read once, each output written once.
    m_bytes = x4.numel() + outs4[0].numel() * 4
    for name, fn, nbytes in (
            ("forward_match_morph", lambda: forward4(x4, t4), None),
            ("matchTemplate TM_CCOEFF_NORMED 32x32",
             lambda: cv.matchTemplate(x4, t4, cv.TM_CCOEFF_NORMED), m_bytes),
            ("erode 3x3", lambda: cv.erode(x4, np.ones((3, 3), np.uint8)), 2 * n1),
            ("dilate 5x5", lambda: cv.dilate(x4, np.ones((5, 5), np.uint8)), 2 * n1),
            ("erode 9x9", lambda: cv.erode(x4, np.ones((9, 9), np.uint8)), 2 * n1)):
        extra = "" if nbytes is None else f", bytes bound {bound(nbytes, 0)[0]:.4f} ms"
        log(f"time config 4 {name} (8,1080,1920,1): {timer(fn):.4f} ms{extra}  [{card}]")
    # the pad inside erode 3x3, whole, and its device work alone: the same
    # two gathers and fill with the index vectors already on the card
    ridx, cidx = border_index(H4, 1, 1, cv.BORDER_CONSTANT), border_index(W4, 1, 1,
                                                                          cv.BORDER_CONSTANT)
    rows = torch.from_numpy(np.maximum(ridx, 0).astype(np.int64)).to(dev)
    cols = torch.from_numpy(np.maximum(cidx, 0).astype(np.int64)).to(dev)
    fill = torch.from_numpy((ridx < 0)[:, None] | (cidx < 0)[None, :]).to(dev)[None, :, :, None]
    val = torch.full((1, 1, 1, 1), 255, dtype=torch.uint8, device=dev)
    t_pad = timer(lambda: pad_nhwc(x4, 1, 1, 1, 1, cv.BORDER_CONSTANT, 255))
    t_pad_dev = timer(lambda: torch.where(fill, val, x4.index_select(1, rows).index_select(2, cols)),
                      device_only=True)
    log(f"time config 4 pad inside erode 3x3 (pad_nhwc 1 px, constant) (8,1080,1920,1): "
        f"{t_pad:.4f} ms, its device work alone {t_pad_dev:.4f} ms, host share "
        f"{max(0.0, 1 - t_pad_dev / t_pad):.3f}, bytes bound "
        f"{bound(n1 + N4 * (H4 + 2) * (W4 + 2), 0)[0]:.4f} ms  [{card}]")
    eig, sel = good_features_response(smooth[:1], 500, 0.01)
    t_resp = timer(lambda: good_features_response(smooth[:1], 500, 0.01))
    t_tail = host_median(lambda: _gftt_host_tail(eig, sel, 500, 10))
    log(f"time goodFeaturesToTrack (1,1080,1920,1) device part {t_resp:.4f} ms, host tail "
        f"({int(sel.sum())} candidates) {t_tail:.4f} ms  [{card}]")

    # config 5: the forward as the caller sees it (it reads the tie counts
    # and the rows back, so it ends in a host sync of its own), its syncs,
    # and its stages
    t5 = host_median(lambda: forward5(x5, orb5), iters=10)
    n_sync = count_syncs(lambda: forward5(x5, orb5))
    log(f"time forward_orb (8,1080,1920) nfeatures=500: {t5:.4f} ms on the host clock; "
        f"{n_sync} host syncs per batch  [{card}]")
    n5 = x5.numel()
    x5_4 = x5[..., None]
    t_fast = timer(lambda: fast_keypoint_mask(x5_4, orb5.fast_threshold, True))
    log(f"time config 5 level-0 FAST + NMS (8,1080,1920,1): {t_fast:.4f} ms, bytes bound "
        f"{bound(n5 + 5 * n5, 0)[0]:.4f} ms (u8 in, int32 score and bool mask out)  [{card}]")
    w1, h1 = sizes5[1]
    t_rs = timer(lambda: cv.resize(x5_4, (w1, h1), interpolation=cv.INTER_LINEAR_EXACT))
    log(f"time config 5 LINEAR_EXACT step (8,1080,1920,1) -> (8,{h1},{w1},1): {t_rs:.4f} ms, "
        f"bytes bound {bound(n5 + 8 * h1 * w1, 0)[0]:.4f} ms  [{card}]")
    tabs5 = orb5._tables_for(1080, 1920, dev)
    nper5, n2s5, caps5, dcaps5 = orb5._pools()
    t_prep = timer(lambda: orb_mod._level_prepare(x5_4, orb5.fast_threshold,
                                                  orb5.edge_threshold, tabs5.pad[0]))
    lvl0 = orb_mod._level_prepare(x5_4, orb5.fast_threshold, orb5.edge_threshold, tabs5.pad[0])
    score0, keep0 = fast_keypoint_mask(x5_4, orb5.fast_threshold, True)
    unpooled = torch.where(keep0[..., 0], score0[..., 0].to(torch.float32),
                           -float("inf")).reshape(x5.shape[0], -1)
    t_topk = timer(lambda: torch.topk(lvl0["pooled"], caps5[0], dim=1))
    t_topk_full = timer(lambda: torch.topk(unpooled, caps5[0], dim=1))
    n_cand0 = int(torch.isfinite(lvl0["pooled"]).sum())
    log(f"time config 5 level-0 maps (FAST, blur, 1x2 pre-pool, pad): {t_prep:.4f} ms; "
        f"torch.topk k={caps5[0]} on the pooled map {tuple(lvl0['pooled'].shape)}: "
        f"{t_topk:.4f} ms, on the unpooled map {tuple(unpooled.shape)}: {t_topk_full:.4f} ms "
        f"({n_cand0} candidates in the batch)  [{card}]")
    t_sparse = timer(lambda: orb_mod._level_cand_desc(
        lvl0, tabs5, orb5.patch_size // 2, n2s5[0], caps5[0], orb5.wta_k, dcap=dcaps5[0],
        nper=nper5[0], is_harris=True))
    log(f"time config 5 level-0 candidate stage (top-k, sparse Harris, IC moments, "
        f"descriptors; cap {caps5[0]}, rows {dcaps5[0]}): {t_sparse:.4f} ms  [{card}]")
    t_rows = host_median(lambda: orb5._device_rows(x5), iters=10)
    cand5, desc5 = orb5._device_rows(x5)
    t_tail5 = host_median(lambda: orb5._host_tail(cand5, desc5), iters=10)
    log(f"time config 5 device rows (all levels, read back) {t_rows:.4f} ms, host tail "
        f"({cand5.shape[0]} levels x {cand5.shape[1]} images x {cand5.shape[2]} rows) "
        f"{t_tail5:.4f} ms, on the host clock  [{card}]")
    q5 = torch.from_numpy(d0[:500]).to(dev)
    r5 = torch.from_numpy(d1[:500]).to(dev)
    t_bf = host_median(lambda: bf.match(q5, r5))
    t_ham = timer(lambda: hamming_distance_matrix(q5, r5))
    log(f"time BFMatcher(NORM_HAMMING, crossCheck).match {len(q5)} x {len(r5)}: {t_bf:.4f} ms "
        f"on the host clock; its Hamming matrix on the card {t_ham:.4f} ms  [{card}]")

    # config 2, as the caller sees it (the warps copy their host vectors to
    # the card on each call); bytes: each input read once, each output
    # written once
    half2 = (W2 // 2, H2 // 2)
    n_in2, n_half2 = x2.numel(), outs2[0].numel()
    ops2 = (
        ("forward_resize_warp_4k", lambda: forward2(x2), 5 * n_in2 + 3 * n_half2 + 2 * n_in2),
        *((name, lambda i=i: cv.resize(x2, half2, interpolation=i), n_in2 + n_half2)
          for name, i in zip(CFG2_OPS, (cv.INTER_LINEAR, cv.INTER_AREA, cv.INTER_CUBIC))),
        (CFG2_OPS[3], lambda: cv.warpAffine(x2, cv.getRotationMatrix2D(
            (W2 / 2, H2 / 2), 15.0, 0.9), (W2, H2)), 2 * n_in2),
        (CFG2_OPS[4], lambda: cv.warpPerspective(x2, E.PERSPECTIVE_CFG2, (W2, H2)), 2 * n_in2))
    for name, fn, nbytes in ops2:
        t = timer(fn)
        b_ms = bound(nbytes, 0)[0]
        log(f"time config 2 {name} {tuple(x2.shape)}: {t:.4f} ms, bytes bound {b_ms:.4f} ms "
            f"({nbytes / 1e6:.1f} MB), share of bound {b_ms / t:.4f}  [{card}]")
    busy, k_ms, f_ms = busy_share(lambda: forward2(x2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    forward2(x2)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"config 2 forward: device busy share {busy:.4f} (kernels {k_ms:.4f} ms of "
        f"{f_ms:.4f} ms, torch.profiler); peak device memory {peak / 2 ** 30:.3f} GiB "
        f"({(peak - base) / 2 ** 30:.3f} GiB over the {base / 2 ** 30:.3f} GiB held before)  "
        f"[{card}]")

    # the decode-and-colour path, as the caller sees it; bytes: each
    # stage's inputs read once and outputs written once
    bgr6, small6, bin6, int6 = outs6[0], outs6[4], outs6[5], outs6[6]
    n_nv12, n_bgr, n_small = y6.numel() + uv6.numel(), bgr6.numel(), small6.numel()
    otsu_type = cv.THRESH_BINARY | cv.THRESH_OTSU
    stages6 = (
        ("cvtColorTwoPlane NV12 -> BGR",
         lambda: cv.cvtColorTwoPlane(y6, uv6, cv.COLOR_YUV2BGR_NV12), n_nv12 + n_bgr),
        ("cvtColor BGR2HSV", lambda: cv.cvtColor(bgr6, cv.COLOR_BGR2HSV), 2 * n_bgr),
        ("cvtColor BGR2Lab", lambda: cv.cvtColor(bgr6, cv.COLOR_BGR2Lab), 2 * n_bgr),
        ("cvtColor BGR2YCrCb", lambda: cv.cvtColor(bgr6, cv.COLOR_BGR2YCrCb), 2 * n_bgr),
        ("fusedPreprocessGrayBlurDown2 (gauss5_down2)",
         lambda: cv.fusedPreprocessGrayBlurDown2(bgr6), n_bgr + n_small),
        ("threshold BINARY | OTSU", lambda: cv.threshold(small6, 0, 255, otsu_type), 2 * n_small),
        ("integral", lambda: cv.integral(bin6), n_small + 4 * int6.numel()))
    stage_bytes = sum(b for _, _, b in stages6)
    # the forward also reads each of its seven outputs once for the sums
    fwd_bytes6 = stage_bytes + 4 * n_bgr + 2 * n_small + 4 * int6.numel()
    t6 = timer(lambda: forward6(y6, uv6))
    log(f"time forward_decode_color Y {tuple(y6.shape)} UV {tuple(uv6.shape)}: {t6:.4f} ms, bytes "
        f"bound {bound(fwd_bytes6, 0)[0]:.4f} ms ({fwd_bytes6 / 1e6:.1f} MB with the sums' reads; "
        f"the stages alone {bound(stage_bytes, 0)[0]:.4f} ms, {stage_bytes / 1e6:.1f} MB), share "
        f"of bound {bound(fwd_bytes6, 0)[0] / t6:.4f}  [{card}]")
    for name, fn, nbytes in stages6:
        t = timer(fn)
        b_ms = bound(nbytes, 0)[0]
        log(f"time decode-colour {name}: {t:.4f} ms, bytes bound {b_ms:.4f} ms "
            f"({nbytes / 1e6:.1f} MB), share of bound {b_ms / t:.4f}  [{card}]")
    n_sync6 = count_syncs(lambda: forward6(y6, uv6))
    busy6, k_ms6, f_ms6 = busy_share(lambda: forward6(y6, uv6))
    torch.cuda.synchronize()
    del outs6, got01, bgr6, small6, bin6, int6
    torch.cuda.reset_peak_memory_stats()
    base6 = torch.cuda.memory_allocated()
    forward6(y6, uv6)
    torch.cuda.synchronize()
    peak6 = torch.cuda.max_memory_allocated()
    log(f"decode-colour forward: device busy share {busy6:.4f} (kernels {k_ms6:.4f} ms of "
        f"{f_ms6:.4f} ms, torch.profiler); {n_sync6} host syncs per batch (threshold's "
        f"histogram is one scatter); peak device memory "
        f"{peak6 / 2 ** 30:.3f} GiB ({(peak6 - base6) / 2 ** 30:.3f} GiB over the "
        f"{base6 / 2 ** 30:.3f} GiB held before)  [{card}]")

    # the enhancement path, as the caller sees it; bytes: each stage's inputs
    # read once and outputs written once (the unsharp mask as GaussianBlur,
    # then addWeighted of the image and the blur)
    g7, m7, c7, u7, b7, v7 = outs7[:6]
    n7 = g7.numel()
    stages7 = (
        ("cvtColor BGR2GRAY", lambda: cv.cvtColor(x7, cv.COLOR_BGR2GRAY), 4 * n7),
        ("medianBlur 5", lambda: cv.medianBlur(g7, 5), 2 * n7),
        ("CLAHE 2.0 8x8", lambda: cv.createCLAHE(2.0, (8, 8)).apply(m7), 2 * n7),
        ("unsharp mask (GaussianBlur 5x5 + addWeighted)",
         lambda: cv.addWeighted(c7, 1.5, cv.GaussianBlur(c7, (5, 5), 0), -0.5, 0), 5 * n7),
        ("bilateralFilter 5 50 50", lambda: cv.bilateralFilter(u7, 5, 50, 50), 2 * n7),
        ("LUT gamma 0.8", lambda: cv.LUT(b7, E.GAMMA_LUT), 2 * n7),
        ("applyColorMap JET", lambda: cv.applyColorMap(v7, cv.COLORMAP_JET), 4 * n7),
        ("calcHist per image", lambda: hist_per_image(c7), n7 + 4 * N7 * 256))
    stage_bytes7 = sum(b for _, _, b in stages7)
    # the forward also reads its seven images and the histograms for the sums
    fwd_bytes7 = stage_bytes7 + 9 * n7 + 4 * N7 * 256
    t7 = timer(lambda: forward7(x7))
    log(f"time forward_enhance {tuple(x7.shape)}: {t7:.4f} ms, bytes bound "
        f"{bound(fwd_bytes7, 0)[0]:.4f} ms ({fwd_bytes7 / 1e6:.1f} MB with the sums' reads; the "
        f"stages alone {bound(stage_bytes7, 0)[0]:.4f} ms, {stage_bytes7 / 1e6:.1f} MB), share "
        f"of bound {bound(fwd_bytes7, 0)[0] / t7:.4f}  [{card}]")
    for name, fn, nbytes in stages7:
        t = timer(fn)
        b_ms = bound(nbytes, 0)[0]
        log(f"time enhancement {name}: {t:.4f} ms, bytes bound {b_ms:.4f} ms "
            f"({nbytes / 1e6:.1f} MB), share of bound {b_ms / t:.4f}  [{card}]")
    n_sync7 = count_syncs(lambda: forward7(x7))
    busy7, k_ms7, f_ms7 = busy_share(lambda: forward7(x7))
    torch.cuda.synchronize()
    del outs7, want7, g7, m7, c7, u7, b7, v7
    torch.cuda.reset_peak_memory_stats()
    base7 = torch.cuda.memory_allocated()
    forward7(x7)
    torch.cuda.synchronize()
    peak7 = torch.cuda.max_memory_allocated()
    g7 = cv.cvtColor(x7, cv.COLOR_BGR2GRAY)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_med = torch.cuda.memory_allocated()
    cv.medianBlur(g7, 5)
    torch.cuda.synchronize()
    peak_med = torch.cuda.max_memory_allocated() - base_med
    del g7
    log(f"enhancement forward: device busy share {busy7:.4f} (kernels {k_ms7:.4f} ms of "
        f"{f_ms7:.4f} ms, torch.profiler); {n_sync7} host syncs per batch; peak device memory "
        f"{peak7 / 2 ** 30:.3f} GiB ({(peak7 - base7) / 2 ** 30:.3f} GiB over the "
        f"{base7 / 2 ** 30:.3f} GiB held before); medianBlur 5 on (8,1080,1920,1) alone "
        f"{peak_med / 2 ** 30:.3f} GiB over its input  [{card}]")

    # the motion path, as the caller sees it; bytes: each stage's inputs read
    # once and outputs written once, the phase correlation counted by its
    # sub-steps (window, rfft2, normalised cross-power, irfft2, peak) with
    # their f64 planes and complex128 half spectra
    n8, P8, F8 = N8 * H8 * W8, H8 * W8, H8 * (W8 // 2 + 1)
    pc_steps = (("window multiply (u8 -> f64)", 9 * n8 + 8 * P8),
                ("rfft2 (f64 -> complex128)", 8 * n8 + 16 * N8 * F8),
                ("normalised cross-power spectrum", 16 * N8 * F8 + 16 * (N8 - 1) * F8),
                ("irfft2", 16 * (N8 - 1) * F8 + 8 * (N8 - 1) * P8),
                ("peak and centroid", 8 * (N8 - 1) * P8))
    stage_bytes8 = {"gray": 4 * n8, "smooth": 2 * n8, "shifts": sum(b for _, b in pc_steps),
                    "aligned": 2 * n8, "background": n8 + 4 * P8, "mask": 2 * n8 + 4 * P8,
                    "components": 5 * n8, "distance": 5 * n8, "moments": n8, "contours": P8,
                    "sums": 11 * n8}
    fwd_bytes8 = sum(stage_bytes8.values())
    state8 = {"x": x8}
    for _, stage, _ in E.MOTION_STAGES:
        stage(state8)
    t8 = timer(lambda: E.forward_motion(x8), iters=10)
    log(f"time forward_motion {tuple(x8.shape)}: {t8:.4f} ms, bytes bound "
        f"{bound(fwd_bytes8, 0)[0]:.4f} ms ({fwd_bytes8 / 1e6:.1f} MB), share of bound "
        f"{bound(fwd_bytes8, 0)[0] / t8:.4f}  [{card}]")
    for name, stage, keys in E.MOTION_STAGES:
        t = timer(lambda: stage(dict(state8)), iters=10)
        b_ms = bound(stage_bytes8[name], 0)[0]
        log(f"time motion {name}: {t:.4f} ms, bytes bound {b_ms:.4f} ms "
            f"({stage_bytes8[name] / 1e6:.1f} MB), share of bound {b_ms / t:.4f}  [{card}]")
    for name, nbytes in pc_steps:
        log(f"motion shifts sub-step {name}: bytes bound {bound(nbytes, 0)[0]:.4f} ms "
            f"({nbytes / 1e6:.1f} MB)")
    n_sync8 = count_syncs(lambda: E.forward_motion(x8))
    busy8, k_ms8, f_ms8 = busy_share(lambda: E.forward_motion(x8))
    mask8 = state8["mask"]
    del outs8, state8, labels8
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base8 = torch.cuda.memory_allocated()
    E.forward_motion(x8)
    torch.cuda.synchronize()
    peak8 = torch.cuda.max_memory_allocated()
    log(f"motion forward: device busy share {busy8:.4f} (kernels {k_ms8:.4f} ms of "
        f"{f_ms8:.4f} ms, torch.profiler); {n_sync8} host syncs per batch; peak device memory "
        f"{peak8 / 2 ** 30:.3f} GiB ({(peak8 - base8) / 2 ** 30:.3f} GiB over the "
        f"{base8 / 2 ** 30:.3f} GiB held before)  [{card}]")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_p = torch.cuda.memory_allocated()
    t_p0 = time.perf_counter()
    precise = cv.distanceTransform(mask8, cv.DIST_L2, cv.DIST_MASK_PRECISE)
    torch.cuda.synchronize()
    t_p = (time.perf_counter() - t_p0) * 1e3
    peak_p = torch.cuda.max_memory_allocated() - base_p
    if not (precise.shape == mask8.shape and torch.isfinite(precise).all()):
        raise AssertionError(f"DIST_MASK_PRECISE: {tuple(precise.shape)}")
    full_nhww = N8 * H8 * W8 * W8 * 4
    log(f"distanceTransform DIST_MASK_PRECISE on the motion mask {tuple(mask8.shape)}: "
        f"{t_p:.4f} ms on the host clock (first call), peak "
        f"{peak_p / 2 ** 30:.3f} GiB over its input (an (N, H, W, W) f32 array would be "
        f"{full_nhww / 1e9:.1f} GB); max distance {float(precise.max()):.3f}  [{card}]")
    del precise, mask8

    # the lane-and-sign path, as the caller sees it (host reads and host
    # tails included); bytes: each stage's inputs read once and outputs
    # written once (n = N*H*W; the accumulators are the stages' own work)
    n9 = N9 * H9 * W9
    stage_bytes9 = {"gray": 4 * n9, "blur": 2 * n9, "edges": 2 * n9, "segments": n9,
                    "circles": n9, "lanes": 0, "lsd": H9 * W9, "draw": 6 * n9, "sums": 6 * n9}
    fwd_bytes9 = sum(stage_bytes9.values())
    state9 = {"x": x9}
    for _, stage, _ in E.LINES_STAGES:
        stage(state9)
    t9 = timer(lambda: E.forward_lines(x9), iters=5, warmup=1)
    log(f"time forward_lines {tuple(x9.shape)}: {t9:.4f} ms, bytes bound "
        f"{bound(fwd_bytes9, 0)[0]:.4f} ms ({fwd_bytes9 / 1e6:.1f} MB), share of bound "
        f"{bound(fwd_bytes9, 0)[0] / t9:.4f}  [{card}]")
    for name, stage, keys in E.LINES_STAGES:
        t = timer(lambda: stage(dict(state9)), iters=5, warmup=1)
        b_ms = bound(stage_bytes9[name], 0)[0]
        log(f"time lines {name}: {t:.4f} ms, bytes bound {b_ms:.4f} ms "
            f"({stage_bytes9[name] / 1e6:.1f} MB), share of bound "
            f"{b_ms / t if b_ms else 0.0:.4f}  [{card}]")
    # the line accumulation as the path runs it (its nonzero read included),
    # then its scatter alone against the same number of votes on distinct
    # addresses: the atomic contention of the votes that meet on a bin
    e9 = state9["edges"][..., 0] != 0
    acc_stats = {}
    votes9 = list(hough_mod.line_vote_chunks(e9, 1, np.pi / 180, 0, np.pi, acc_stats))
    t_acc = timer(lambda: hough_mod.hough_accum_batch(e9, 1, np.pi / 180, 0, np.pi))
    n_votes = acc_stats["edge_pixels"] * 180
    acc_size = N9 * 180 * ((W9 + H9) * 2 + 1)
    acc9 = torch.zeros(acc_size + 4096, dtype=torch.int32, device=dev)
    spread = torch.arange(n_votes, device=dev) * 7919 % acc_size
    inside = torch.ones(n_votes, dtype=torch.bool, device=dev)
    t_scatter = timer(lambda: [hough_mod._vote(acc9, acc_size, f, o) for f, o in votes9],
                      device_only=True)
    t_spread = timer(lambda: hough_mod._vote(acc9, acc_size, spread, inside), device_only=True)
    log(f"lines Hough accumulation ({N9} frames, {acc_stats['edge_pixels']} edge pixels, "
        f"{n_votes} votes in {len(votes9)} chunk(s)): {t_acc:.4f} ms with its nonzero read; "
        f"its scatter alone {t_scatter:.4f} ms, the same number of votes on distinct "
        f"addresses {t_spread:.4f} ms  [{card}]")
    del spread, inside, acc9, votes9
    n_sync9 = count_syncs(lambda: E.forward_lines(x9))
    busy9, k_ms9, f_ms9 = busy_share(lambda: E.forward_lines(x9), iters=2)
    img_s9 = lsd9.scaled(state9["gray"][0, ..., 0])
    t_lsd = host_median(lambda: lsd9.segments(img_s9), iters=3, warmup=1)
    draw_writes9 = state9["draw_writes"]
    del outs9, state9, got9
    peaks9 = {}
    for name, fn in (("forward", lambda: E.forward_lines(x9)),
                     ("line accumulation", lambda: hough_mod.hough_lines_batch(
                         e9, 1, np.pi / 180, 120)),
                     ("circle accumulation", lambda: hough_mod.hough_circles_batch(
                         cv.GaussianBlur(cv.cvtColor(x9, cv.COLOR_BGR2GRAY), (5, 5), 0),
                         **E.LINES_CIRCLES))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base9 = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        peaks9[name] = (torch.cuda.max_memory_allocated() - base9) / 2 ** 30
    log(f"lines forward: device busy share {busy9:.4f} (kernels {k_ms9:.4f} ms of "
        f"{f_ms9:.4f} ms, torch.profiler); {n_sync9} host syncs per batch; peak device memory "
        f"over the inputs: forward {peaks9['forward']:.3f} GiB, line accumulation "
        f"{peaks9['line accumulation']:.3f} GiB, circle accumulation (with its gray and "
        f"blur) {peaks9['circle accumulation']:.3f} GiB; LSD's host tail on frame 0 "
        f"{t_lsd:.4f} ms on the host clock; the drawing's device writes {draw_writes9}  "
        f"[{card}]")
    del e9

    # the segmentation path, as the caller sees it (host reads and host
    # tails included); bytes: each stage's inputs read once and outputs
    # written once (n = N*H*W pixels, a = H*W of frame 0)
    n10, a10 = N10 * H10 * W10, H10 * W10
    stage_bytes10 = {"correct": 6 * n10, "gray": 4 * n10, "blur": 2 * n10, "threshold": 2 * n10,
                     "opening": 2 * n10, "sure_bg": 2 * n10, "sure_fg": 6 * n10,
                     "unknown": 3 * n10, "markers": 6 * n10, "watershed": 11 * n10,
                     "cells": 4 * n10, "flood": 4 * a10, "cutout": 4 * a10, "emd": 5 * n10,
                     "painted": 10 * n10, "sums": 21 * n10}
    fwd_bytes10 = sum(stage_bytes10.values())
    state10 = {"x": x10, "model": model10}
    for _, stage, _ in E.SEGMENT_STAGES:
        stage(state10)
    t10 = timer(lambda: forward10(x10, model10), iters=5, warmup=1)
    log(f"time forward_segment {tuple(x10.shape)}: {t10:.4f} ms, bytes bound "
        f"{bound(fwd_bytes10, 0)[0]:.4f} ms ({fwd_bytes10 / 1e6:.1f} MB), share of bound "
        f"{bound(fwd_bytes10, 0)[0] / t10:.6f}  [{card}]")
    for name, stage, keys in E.SEGMENT_STAGES:
        t = timer(lambda: stage(dict(state10)), iters=5, warmup=1)
        b_ms = bound(stage_bytes10[name], 0)[0]
        log(f"time segment {name}: {t:.4f} ms, bytes bound {b_ms:.4f} ms "
            f"({stage_bytes10[name] / 1e6:.1f} MB), share of bound {b_ms / t:.6f}  [{card}]")
    n_sync10 = count_syncs(lambda: forward10(x10, model10))
    busy10, k_ms10, f_ms10 = busy_share(lambda: forward10(x10, model10), iters=1)
    maxflow10 = state10["gc_stats"]["maxflow_ms"]
    frames10, markers10 = state10["corrected"].cpu().numpy(), state10["markers"].cpu().numpy()
    t_pool = host_median(lambda: seg_mod.watershed_frames(frames10, markers10), iters=3,
                         warmup=1)
    t_alone = host_median(lambda: seg_mod.watershed_frames(frames10, markers10, threads=1),
                          iters=3, warmup=1)
    half10 = state10["half"]
    del outs10, state10
    peaks10 = {}
    for name, fn in (("forward", lambda: forward10(x10, model10)),
                     ("mean shift", lambda: cv.pyrMeanShiftFiltering(half10, 10, 10, 1))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base10 = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        peaks10[name] = (torch.cuda.max_memory_allocated() - base10) / 2 ** 30
    log(f"segment forward: device busy share {busy10:.4f} (kernels {k_ms10:.4f} ms of "
        f"{f_ms10:.4f} ms, torch.profiler); {n_sync10} host syncs per batch; peak device memory "
        f"over the inputs: forward {peaks10['forward']:.3f} GiB, the mean shift at "
        f"{tuple(half10.shape)} {peaks10['mean shift']:.3f} GiB (chunks of at most "
        f"{seg_mod.MS_CHUNK_BYTES / 2 ** 30:.2f} GiB); grabCut's min cuts "
        f"{[round(v, 1) for v in maxflow10]} ms on the host; the {N10} watershed floods "
        f"{t_pool:.1f} ms pooled, {t_alone:.1f} ms one after another (host clock, median of 3, "
        f"{os.cpu_count()} CPUs)  [{card}]")
    del frames10, markers10, half10

    # the registration path, as the caller sees it (host tails included):
    # its stages one after another on one state, the device stages by CUDA
    # events (median of 5), the host stages once on the host clock; then one
    # forward under torch.profiler (busy share, wall) with the peak memory.
    # Bytes: each stage's inputs read once and outputs written once (the
    # pyramid's input is the small frames, its outputs every Gaussian and DoG
    # level; the masks read the DoG levels; the read-back moves every level
    # and mask once); the host stages move no device bytes
    n11, m11 = N11 * H11 * W11, N11 * h11 * w11
    st11 = {"x": x11, "mpx": E.REGISTER_MPX, "sift": cv.SIFT_create()}
    stage_ms11, stage_bytes11 = {}, {}
    for name, stage, keys in E.REGISTER_STAGES:
        if name in ("gray", "resize", "pyramid", "masks"):
            stage_ms11[name] = timer(lambda: stage(dict(st11)), iters=5, warmup=1)
            stage(st11)
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stage(st11)
            torch.cuda.synchronize()
            stage_ms11[name] = (time.perf_counter() - t0) * 1e3
    lv_bytes = sum(a.numel() * a.element_size() for o in st11["gpyr"] + st11["dog"] for a in o)
    dog_bytes = sum(a.numel() * a.element_size() for o in st11["dog"] for a in o)
    mask_bytes = sum(a.numel() for o in st11["masks"] for a in o)
    stage_bytes11 = {"gray": 4 * n11, "resize": n11 + m11, "pyramid": m11 + lv_bytes,
                     "masks": dog_bytes + mask_bytes, "readback": lv_bytes + mask_bytes,
                     "features": 0, "flann_build": 0, "flann_search": 0, "ratio": 0}
    fwd_bytes11 = sum(stage_bytes11.values())
    for name, t in stage_ms11.items():
        b_ms = bound(stage_bytes11[name], 0)[0]
        log(f"time register {name}: {t:.4f} ms, bytes bound {b_ms:.4f} ms "
            f"({stage_bytes11[name] / 1e6:.1f} MB), share of bound {b_ms / t:.6f}  [{card}]")
    log(f"register bytes bound terms (MB): gray {4 * n11 / 1e6:.1f} (BGR in, gray out), resize "
        f"{(n11 + m11) / 1e6:.1f}, pyramid {m11 / 1e6:.1f} in + {lv_bytes / 1e6:.1f} out "
        f"({sum(len(o) for o in st11['gpyr'])} Gaussian and {sum(len(o) for o in st11['dog'])} "
        f"DoG f32 levels; one octave-0 level {st11['gpyr'][0][0].numel() * 4 / 1e6:.1f}), masks "
        f"{dog_bytes / 1e6:.1f} in + {mask_bytes / 1e6:.1f} out, read-back "
        f"{(lv_bytes + mask_bytes) / 1e6:.1f}; total {fwd_bytes11 / 1e6:.1f} MB = "
        f"{bound(fwd_bytes11, 0)[0]:.4f} ms")
    del st11
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base11 = torch.cuda.memory_allocated()
    busy11, k_ms11, f_ms11 = busy_share(lambda: E.forward_register(x11), iters=1, warmup=False)
    peak11 = torch.cuda.max_memory_allocated() - base11
    log(f"time forward_register {tuple(x11.shape)}: {f_ms11:.4f} ms (profiled run; the 4k run "
        f"{wall11:.4f} ms; stages summed {sum(stage_ms11.values()):.4f} ms) on the host clock, "
        f"bytes bound {bound(fwd_bytes11, 0)[0]:.4f} ms ({fwd_bytes11 / 1e6:.1f} MB), share of "
        f"bound {bound(fwd_bytes11, 0)[0] / f_ms11:.6f}  [{card}]")
    log(f"register forward: device busy share {busy11:.4f} (kernels {k_ms11:.4f} ms of "
        f"{f_ms11:.4f} ms, torch.profiler, one forward after the path's earlier runs); "
        f"{n_sync11} host syncs per batch; peak device memory over the input "
        f"{peak11 / 2 ** 30:.3f} GiB  [{card}]")
    del outs11

    # the tracking path, as the caller sees it: its stages one after another
    # on one state, the device stages (the fused map, AKAZE's scale space)
    # by CUDA events (median of 5), the stages that read back and run host
    # tails once on the host clock; then one forward under torch.profiler
    # (busy share, wall) with the peak memory.  Bytes: each stage's inputs
    # read once and outputs written once (the scale spaces write Lt, Lx, Ly
    # and Ldet of every level; AKAZE's detection reads Ldet, writes the masks
    # and reads back all four and the masks; BRISK reads the small frames and
    # writes its layers, their score and keep maps and the five blurs;
    # KAZE's frames read and its levels written and read back once)
    t13_time = time.perf_counter()
    n13, m13 = N13 * H13 * W13, N13 * (H13 // 2) * (W13 // 2)
    st13 = E.track_state(x13)
    stage_ms13 = {}
    for name, stage, keys in E.TRACK_STAGES:
        if name in ("small", "akaze_space"):
            stage_ms13[name] = timer(lambda: stage(dict(st13)), iters=5, warmup=1)
            stage(st13)
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stage(st13)
            torch.cuda.synchronize()
            stage_ms13[name] = (time.perf_counter() - t0) * 1e3

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    ak_lv = nbytes(lv[k] for lv in st13["akaze_levels"] for k in ("Lt", "Lx", "Ly", "Ldet"))
    ak_det = nbytes(lv["Ldet"] for lv in st13["akaze_levels"])
    ak_mask = nbytes(st13["akaze_masks"])
    br_lv = nbytes(st13["brisk_layers"][1:])
    br_sc = nbytes(t for sk in st13["brisk_scores"] for t in sk)
    br_blur = 5 * m13 * 4
    kz_lv = nbytes(lv[k] for lv in st13["kaze_levels"] for k in ("Lt", "Lx", "Ly", "Ldet"))
    kz_in = E.TRACK_KAZE_FRAMES * (H13 // 2) * (W13 // 2)
    stage_bytes13 = {"small": 3 * n13 + m13, "akaze_space": m13 + ak_lv,
                     "akaze_detect": ak_det + ak_mask + ak_lv + ak_mask, "akaze_describe": 0,
                     "brisk": m13 + br_lv + br_sc + br_blur, "kaze": kz_in + 2 * kz_lv,
                     "match": 0}
    fwd_bytes13 = sum(stage_bytes13.values())
    for name, t in stage_ms13.items():
        b_ms = bound(stage_bytes13[name], 0)[0]
        log(f"time track {name}: {t:.4f} ms, bytes bound {b_ms:.4f} ms "
            f"({stage_bytes13[name] / 1e6:.1f} MB), share of bound {b_ms / t:.6f}  [{card}]")
    log(f"track bytes bound terms (MB): small {3 * n13 / 1e6:.1f} in + {m13 / 1e6:.1f} out; AKAZE "
        f"{len(st13['akaze_levels'])} levels x 4 f32 maps {ak_lv / 1e6:.1f} (Ldet "
        f"{ak_det / 1e6:.1f}, masks {ak_mask / 1e6:.1f}); BRISK layers {br_lv / 1e6:.1f}, score "
        f"and keep maps {br_sc / 1e6:.1f}, blurs {br_blur / 1e6:.1f}; KAZE "
        f"{len(st13['kaze_levels'])} levels x 4 f32 maps on {E.TRACK_KAZE_FRAMES} frames "
        f"{kz_lv / 1e6:.1f}; total {fwd_bytes13 / 1e6:.1f} MB = "
        f"{bound(fwd_bytes13, 0)[0]:.4f} ms")
    del st13
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base13 = torch.cuda.memory_allocated()
    busy13, k_ms13, f_ms13 = busy_share(lambda: E.forward_track(x13), iters=1, warmup=False)
    peak13 = torch.cuda.max_memory_allocated() - base13
    log(f"time forward_track {tuple(x13.shape)}: {f_ms13:.4f} ms (profiled run; the 4m run "
        f"{wall13:.4f} ms; stages summed {sum(stage_ms13.values()):.4f} ms) on the host clock, "
        f"bytes bound {bound(fwd_bytes13, 0)[0]:.4f} ms ({fwd_bytes13 / 1e6:.1f} MB), share of "
        f"bound {bound(fwd_bytes13, 0)[0] / f_ms13:.6f}  [{card}]")
    log(f"track forward: device busy share {busy13:.4f} (kernels {k_ms13:.4f} ms of "
        f"{f_ms13:.4f} ms, torch.profiler); {n_sync13} host syncs per batch; peak device memory "
        f"over the input {peak13 / 2 ** 30:.3f} GiB  [{card}]")
    log(f"tracking path's wall in chip_smoke.py: phase 4m {wall4m:.1f} s + its timing "
        f"{time.perf_counter() - t13_time:.1f} s")
    del outs13, x11, x13

    # the video path, as the caller sees it: its stages one after another on
    # one state on the host clock (each ends in a synchronize), then one
    # forward under torch.profiler (busy share, wall) with the peak memory.
    # Bytes: each stage's inputs read once and outputs written once (n =
    # N*H*W): gray 3n in, n out; corners frame 0; klt each pair's two frames
    # per call; shake frames 1.. in, the aligned batch out; MOG2 the aligned
    # frames in, the masks out, and its state (weights, means, variances:
    # 100 B a pixel) read and written at each frame; dense the gray batch in,
    # the half batch out, each pair's two half frames in and its flow out
    t14_time = time.perf_counter()
    st14 = {"x": x14}
    stage_ms14 = {}
    for name, stage, keys in E.VIDEO_STAGES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stage(st14)
        torch.cuda.synchronize()
        stage_ms14[name] = (time.perf_counter() - t0) * 1e3
    hw14 = H14 * W14
    n14 = N14 * hw14
    n_pts14 = len(st14["corners"])
    stage_bytes14 = {"gray": 3 * n14 + n14, "corners": hw14 + 8 * n_pts14,
                     "klt": (N14 - 1) * (2 * hw14 + 9 * n_pts14) + 8 * n_pts14,
                     "shake": (N14 - 1) * 3 * hw14 + N14 * 3 * hw14,
                     "bg": 3 * n14 + n14 + N14 * 2 * 100 * hw14 + 3 * hw14,
                     "dense": n14 + n14 // 4 + (N14 - 1) * (2 * hw14 // 4 + 8 * hw14 // 4)}
    fwd_bytes14 = sum(stage_bytes14.values())
    for name, t in stage_ms14.items():
        b_ms = bound(stage_bytes14[name], 0)[0]
        log(f"time video {name}: {t:.4f} ms, bytes bound {b_ms:.4f} ms "
            f"({stage_bytes14[name] / 1e6:.1f} MB), share of bound {b_ms / t:.6f}  [{card}]")
    log(f"video bytes bound terms (MB): gray {4 * n14 / 1e6:.1f}; corners "
        f"{stage_bytes14['corners'] / 1e6:.2f}; klt {stage_bytes14['klt'] / 1e6:.1f} "
        f"({N14 - 1} pairs); "
        f"shake {stage_bytes14['shake'] / 1e6:.1f}; MOG2 frames {4 * n14 / 1e6:.1f} + state "
        f"{N14 * 200 * hw14 / 1e6:.1f}; dense {stage_bytes14['dense'] / 1e6:.1f}; total "
        f"{fwd_bytes14 / 1e6:.1f} MB = {bound(fwd_bytes14, 0)[0]:.4f} ms")
    del st14
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base14 = torch.cuda.memory_allocated()
    busy14, k_ms14, f_ms14 = busy_share(lambda: E.forward_video(x14), iters=1, warmup=False,
                                        host_ops=False)
    peak14 = torch.cuda.max_memory_allocated() - base14
    log(f"time forward_video {tuple(x14.shape)}: {f_ms14:.4f} ms (profiled run; the 4n run "
        f"{wall14:.4f} ms; stages summed {sum(stage_ms14.values()):.4f} ms) on the host clock, "
        f"bytes bound {bound(fwd_bytes14, 0)[0]:.4f} ms ({fwd_bytes14 / 1e6:.1f} MB), share of "
        f"bound {bound(fwd_bytes14, 0)[0] / f_ms14:.6f}  [{card}]")
    log(f"video forward: device busy share {busy14:.4f} (kernels {k_ms14:.4f} ms of "
        f"{f_ms14:.4f} ms, torch.profiler); {n_sync14} host syncs per batch; peak device memory "
        f"over the input {peak14 / 2 ** 30:.3f} GiB  [{card}]")
    log(f"video path's wall in chip_smoke.py: phase 4n {wall4n:.1f} s + its timing "
        f"{time.perf_counter() - t14_time:.1f} s")
    del outs14, x14

    # the photo path, as the caller sees it: its stages one after another on
    # one state on the host clock (each ends in a synchronize), then one
    # forward under torch.profiler (the device's activity: busy share, wall)
    # with the peak memory over the input.  Bytes: each stage's inputs read
    # once and outputs written once (n = h*w of the cut frame, HW the
    # bracket's): align the bracket (9 HW) and the masks (2 HW) in, the
    # aligned frames (9 n) and cut masks (2 n) out; fuse 9 n in, 3 n out;
    # denoise, detail 3 n in, 3 n out; flatten and inpaint 3 n and a mask in,
    # 3 n out
    t15_time = time.perf_counter()
    st15 = E.photo_state(x15, face15, wire15)
    stage_ms15 = {}
    for name, stage, keys in E.PHOTO_STAGES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stage(st15)
        torch.cuda.synchronize()
        stage_ms15[name] = (time.perf_counter() - t0) * 1e3
    HW15 = E.SHAPE_PHOTO[1] * E.SHAPE_PHOTO[2]
    n15 = h15 * w15
    stage_bytes15 = {"align": 11 * HW15 + 11 * n15, "fuse": 12 * n15, "denoise": 6 * n15,
                     "detail": 6 * n15, "flatten": 7 * n15, "inpaint": 7 * n15}
    fwd_bytes15 = sum(stage_bytes15.values())
    for name, t in stage_ms15.items():
        b_ms = bound(stage_bytes15[name], 0)[0]
        log(f"time photo {name}: {t:.4f} ms, bytes bound {b_ms:.4f} ms "
            f"({stage_bytes15[name] / 1e6:.1f} MB), share of bound {b_ms / t:.8f}  [{card}]")
    terms15 = "; ".join(f"{k} {v / 1e6:.2f}" for k, v in stage_bytes15.items())
    log(f"photo bytes bound terms (MB): {terms15}; total {fwd_bytes15 / 1e6:.1f} MB = "
        f"{bound(fwd_bytes15, 0)[0]:.4f} ms")
    del st15
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base15 = torch.cuda.memory_allocated()
    busy15, k_ms15, f_ms15 = busy_share(lambda: E.forward_photo(x15, face15, wire15), iters=1,
                                        warmup=False, host_ops=False)
    peak15 = torch.cuda.max_memory_allocated() - base15
    log(f"time forward_photo {tuple(x15.shape)}: {f_ms15:.4f} ms (profiled run; the 4o run "
        f"{wall15:.4f} ms; stages summed {sum(stage_ms15.values()):.4f} ms) on the host clock, "
        f"bytes bound {bound(fwd_bytes15, 0)[0]:.4f} ms ({fwd_bytes15 / 1e6:.1f} MB), share of "
        f"bound {bound(fwd_bytes15, 0)[0] / f_ms15:.8f}  [{card}]")
    log(f"photo forward: device busy share {busy15:.4f} (kernels {k_ms15:.4f} ms of "
        f"{f_ms15:.4f} ms, torch.profiler); {n_sync15} host syncs per bracket; peak device "
        f"memory over the input {peak15 / 2 ** 30:.3f} GiB  [{card}]")
    log(f"photo path's wall in chip_smoke.py: phase 4o {wall4o:.1f} s + its timing "
        f"{time.perf_counter() - t15_time:.1f} s")
    del outs15, x15

    # the stereo forward stage by stage on the host clock, beside their
    # bytes bounds (n = H*W of a frame; each stage's inputs read once and
    # outputs written once): rectify the pair (6 n) and four f32 maps (16 n)
    # in, the rectified pair (6 n) out; half 6 n in, n / 2 out; sgbm the
    # half pair (n / 2) in, n / 4 int16 (n / 2) out; bm the rectified pair in
    # (6 n), the gray pair (2 n) and the int16 disparity (2 n) out; speckles
    # 2 n in and out; depth 2 n in, 12 n out
    t16_time = time.perf_counter()
    st16 = E.stereo_state(pair16, rig16)
    stage_ms16 = {}
    for name, stage, keys in E.STEREO_STAGES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stage(st16)
        torch.cuda.synchronize()
        stage_ms16[name] = (time.perf_counter() - t0) * 1e3
    n16 = H16 * W16
    stage_bytes16 = {"rectify": 28 * n16, "half": 6 * n16 + n16 // 2, "sgbm": n16,
                     "bm": 10 * n16, "speckles": 4 * n16, "depth": 14 * n16}
    fwd_bytes16 = sum(stage_bytes16.values())
    for name, t in stage_ms16.items():
        b_ms = bound(stage_bytes16[name], 0)[0]
        log(f"time stereo {name}: {t:.4f} ms, bytes bound {b_ms:.4f} ms "
            f"({stage_bytes16[name] / 1e6:.1f} MB), share of bound {b_ms / t:.8f}  [{card}]")
    terms16 = "; ".join(f"{k} {v / 1e6:.2f}" for k, v in stage_bytes16.items())
    log(f"stereo bytes bound terms (MB): {terms16}; total {fwd_bytes16 / 1e6:.1f} MB = "
        f"{bound(fwd_bytes16, 0)[0]:.4f} ms")
    # the launches of SGBM's path loops: the kernels torch.profiler sees in
    # one SGBM stage
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof16:
        E.STEREO_STAGES[2][1](st16)
        torch.cuda.synchronize()
    cuda_t = torch.autograd.DeviceType.CUDA
    sgbm_kernels16 = sum(e.count for e in prof16.key_averages() if e.device_type == cuda_t)
    log(f"stereo SGBM at {(H16 // 2, W16 // 2)}, {E.STEREO_SGBM['numDisparities']} disparities: "
        f"{sgbm_kernels16} kernel launches in one stage (torch.profiler)")
    del st16
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base16 = torch.cuda.memory_allocated()
    busy16, k_ms16, f_ms16 = busy_share(lambda: E.forward_stereo(pair16, rig16), iters=1,
                                        warmup=False, host_ops=False)
    peak16b = (torch.cuda.max_memory_allocated() - base16) / 2 ** 30
    log(f"time forward_stereo {tuple(pair16.shape)}: {f_ms16:.4f} ms (profiled run; the 4p run "
        f"{wall16:.4f} ms; stages summed {sum(stage_ms16.values()):.4f} ms) on the host clock, "
        f"bytes bound {bound(fwd_bytes16, 0)[0]:.4f} ms ({fwd_bytes16 / 1e6:.1f} MB), share of "
        f"bound {bound(fwd_bytes16, 0)[0] / f_ms16:.8f}  [{card}]")
    log(f"stereo forward: device busy share {busy16:.4f} (kernels {k_ms16:.4f} ms of "
        f"{f_ms16:.4f} ms, torch.profiler); {n_sync16} host syncs per pair; peak device memory "
        f"over the input {peak16b:.3f} GiB (the 4p run {peak16:.3f})  [{card}]")
    log(f"stereo path's wall in chip_smoke.py: phase 4p {wall4p:.1f} s + its timing "
        f"{time.perf_counter() - t16_time:.1f} s")
    del outs16, pair16, views16, rig16

    meta = {
        "sep_filter": ("opencv_tpu_torch/csrc/sepfilter.cu",
                       "opencv_tpu/kernels/sepfilter.py:220", "opencv_sep_filter"),
        "gauss5_down2": ("opencv_tpu_torch/csrc/fused_preproc.cu",
                         "opencv_tpu/kernels/fused_preproc.py:210", "opencv_gauss5_down2"),
        "pyr_down": ("opencv_tpu_torch/csrc/pyrdown.cu",
                     "opencv_tpu/kernels/sepfilter.py:297", "opencv_pyr_down"),
    }
    # launches: the kernel's count over the main paths (4a to 4u); the
    # top-level numbers are the first shape of `cases`, which lists each
    # shape the main paths give the kernel
    shapes = {"sep_filter": ("sep_filter", "sep_filter sobel",
                             *(f"sep_filter k7 level {lv}" for lv in range(len(sizes5))),
                             "sep_filter k3 photo", "sep_filter generic k9 level 2"),
              "gauss5_down2": ("gauss5_down2", "gauss5_down2 stereo", "gauss5_down2 gray"),
              "pyr_down": ("pyr_down", *(f"pyr_down c3 {h}x{w}" for _, h, w, _ in
                                         PYR_SEGMENT_SHAPES),
                           *(f"pyr_down video {n}x{h}x{w}" for n, h, w, _ in
                             PYR_VIDEO_SHAPES[:3]))}
    main_paths = (flagship, cfg3, cfg4, cfg5, cfg2, cfg6, cfg7, cfg8, cfg9, cfg10, cfg11, cfg12,
                  cfg13, cfg14, cfg15, cfg16, cfg17, cfg18, cfg19, cfg20, cfg21, cfg22)
    kernels = []
    for name, (src, rep, sym) in meta.items():
        row = times[shapes[name][0]]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "launches": sum(c[sym] for c in main_paths),
                        "max_abs_err": max_err[name],
                        **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                               "library_ms")},
                        "cases": [times[s] for s in shapes[name]]})
    # each kernel's launches by path: 4a-4r, and this slice's three
    by_path = {"4a-4r": main_paths[:18], "4s stitch": (cfg19,), "4t gapi live": (cfg20,),
               "4t gapi loaded": (cfg21,), "4u track_dnn": (cfg22,)}
    for k, (_, _, sym) in zip(kernels, meta.values()):
        k["launches_by_path"] = {p: sum(c[sym] for c in cs) for p, cs in by_path.items()}
    # sep_filter's launches on the main paths by route
    kernels[0]["launches_by_route"] = {
        r: sum(c["sep_filter routes"][r] for c in main_paths)
        for r in SEP_FILTER.routes}
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
