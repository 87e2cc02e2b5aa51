#!/usr/bin/env python3
"""Where the port's forwards spend their device time, on one GPU.

    python3 perf/profile_torch_forward.py [--path PATH] [--iters 5] [--repeats 20] [--table FILE]
        [--sort COLUMN]

PATH is one of flagship, cfg2, cfg3, cfg4, cfg5, decode, enhance, motion,
lines, segment, photo, stereo, stitch, gapi and trackdnn.

``--path flagship`` (the default) runs ``opencv_tpu_torch.entry``'s forward
and fused forward on the (8, 1080, 1920, 3) batch; ``--path cfg2`` runs
BASELINE config 2 (resize LINEAR, AREA, CUBIC, warpAffine, warpPerspective)
on the (4, 2160, 3840, 3) batch; ``--path cfg3`` runs BASELINE config 3
(pyrDown, cornerHarris, Sobel, Canny) and ``--path cfg4`` BASELINE config 4
(matchTemplate, erode, dilate, erode) on the (8, 1080, 1920, 1) batch;
``--path cfg5`` BASELINE config 5 (ORB, nfeatures=500) on the (8, 1080,
1920) batch in its four stages: the level maps (pyramid, FAST, blur,
pre-pool, pad), the candidate stage with its tie-count read, the readback of
the rows and the host tail; ``--path decode`` the decode-colour path
(``entry.forward_decode_color``) on NV12 (8, 1080, 1920) in its stages:
cvtColorTwoPlane, HSV, Lab, YCrCb, gauss5_down2, threshold OTSU, integral
and the per-image sums; ``--path enhance`` the enhancement path
(``entry.forward_enhance``) on the (8, 1080, 1920, 3) batch in its stages:
gray, medianBlur, CLAHE, the unsharp mask, bilateralFilter, the gamma LUT,
applyColorMap, the per-image histogram and the sums; ``--path motion`` the
motion path (``entry.forward_motion``) on ``make_motion_video()``'s (8,
1080, 1920, 3) frames in its stages (``entry.MOTION_STAGES``): gray,
GaussianBlur, the phase correlation, warpAffine, the background, the mask,
the components, the distance transform, the moments, the contours and the
sums; ``--path lines`` the lane-and-sign path (``entry.forward_lines``) on
``make_road_video()``'s (8, 1080, 1920, 3) frames in its stages
(``entry.LINES_STAGES``): gray, GaussianBlur, Canny, the Hough lines and
HoughLinesP, HoughCircles, fitLine, LSD on frame 0, the drawing and the
sums; ``--path segment`` the cell-segmentation path
(``entry.forward_segment``) on ``make_cells_video()``'s (8, 1080, 1920, 3)
frames in its stages (``entry.SEGMENT_STAGES``): the colour correction,
gray, GaussianBlur, Otsu, the opening, the sure background, the distance
transform and sure foreground, the unknown band, the markers, the
watershed, the cells and their triangles, frame 0's flood, its cut-out
(pyrDown, mean shift, grabCut), EMD, the painted boundaries and the sums (a
forward of seconds: run it with ``--repeats 3 --iters 1``); ``--path photo``
the photo-finishing path (``entry.forward_photo``) on ``make_bracket()``'s
(3, 1080, 1920, 3) bracket in its stages (``entry.PHOTO_STAGES``): align,
fuse, denoise, detail, flatten, inpaint; ``--path stereo`` the stereo-depth
path (``entry.forward_stereo``) on ``make_stereo_rig()``'s scene pair with
the rig ``entry.calibrate_rig`` calibrates first (not profiled), in its
stages (``entry.STEREO_STAGES``): rectify, half, sgbm, bm, speckles, depth
(run it with ``--repeats 3 --iters 1``); ``--path stitch`` the stitching
path's stages on its last pair (``entry.forward_stitch`` on
``make_pan_video()``'s pan, run once first to give the panorama so far and
the homography): orb (both images), match (the Hamming matches on the
card), homography (RANSAC on the host), warp (the canvas), distance (the
seam weights) and blend; ``--path gapi`` ``entry.gapi_flagship()``'s graph
through ``gapi.Stream`` over four host batches of ``make_batch()``, on one
resident batch, and its ``torch.export`` program loaded back; ``--path
trackdnn`` GOTURN at its published widths (``entry.make_goturn_net``) on
``make_motion_video()``'s frames: one tracker's crops and blobs, the net's
forward, and an update of all six trackers. Each runs under
``torch.profiler`` with one ``record_function`` span per stage. Prints, per
stage, the time between CUDA events around it (median of ``--repeats``,
unprofiled) beside the device time of its torch-op kernels
(profiled); the device busy share (all kernel time over the stage spans,
where a low share means the device waits on the host); and the top kernels.
``--table`` writes the profiler's full table to a file, in ``--sort``'s
order. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import opencv_tpu_torch as cv  # noqa: E402
from opencv_tpu_torch import entry as E  # noqa: E402
from opencv_tpu_torch.ops.hist import hist_per_image  # noqa: E402

def flagship_stages():
    """Both flagship forwards as (name, fn of the previous stage's output)."""
    _, (imgs,) = E.entry("cuda")
    H, W = imgs.shape[1], imgs.shape[2]
    return [("cvtColor", lambda _: cv.cvtColor(imgs, cv.COLOR_BGR2GRAY)),
            ("GaussianBlur", lambda g: cv.GaussianBlur(g, (5, 5), 0)),
            ("resize", lambda b: cv.resize(b, (W // 2, H // 2))),
            ("warpAffine", E.warp),
            ("fusedPreprocess", lambda _: E.preprocess_fused(imgs)),
            ("warpFused", E.warp)]


def cfg2_stages():
    """BASELINE config 2's five ops (``entry.forward_resize_warp_4k``
    without its final reductions), each on the input batch."""
    _, (x,) = E.entry_resize_warp_4k("cuda")
    H, W = x.shape[1], x.shape[2]
    M = cv.getRotationMatrix2D((W / 2, H / 2), 15.0, 0.9)
    return [("resizeLinear", lambda _: cv.resize(x, (W // 2, H // 2))),
            ("resizeArea", lambda _: cv.resize(x, (W // 2, H // 2), interpolation=cv.INTER_AREA)),
            ("resizeCubic", lambda _: cv.resize(x, (W // 2, H // 2),
                                                interpolation=cv.INTER_CUBIC)),
            ("warpAffine", lambda _: cv.warpAffine(x, M, (W, H))),
            ("warpPerspective", lambda _: cv.warpPerspective(x, E.PERSPECTIVE_CFG2, (W, H)))]


def cfg3_stages():
    """BASELINE config 3's four ops (``entry.forward_pyr_corner_edge``
    without its final reduction), each on the input batch."""
    _, (x,) = E.entry_pyr_corner_edge("cuda")
    return [("pyrDown", lambda _: cv.pyrDown(x)),
            ("cornerHarris", lambda _: cv.cornerHarris(x.to(torch.float32) / 255.0, 2, 3, 0.04)),
            ("Sobel", lambda _: cv.Sobel(x, cv.CV_16S, 1, 0)),
            ("Canny", lambda _: cv.Canny(x, 50, 150))]


def cfg4_stages():
    """BASELINE config 4's four ops (``entry.forward_match_morph`` without
    its final reduction), each on the input batch."""
    _, (x, t) = E.entry_match_morph("cuda")
    return [("matchTemplate", lambda _: cv.matchTemplate(x, t, cv.TM_CCOEFF_NORMED)),
            ("erode3", lambda _: cv.erode(x, np.ones((3, 3), np.uint8))),
            ("dilate5", lambda _: cv.dilate(x, np.ones((5, 5), np.uint8))),
            ("erode9", lambda _: cv.erode(x, np.ones((9, 9), np.uint8)))]


def cfg5_stages():
    """BASELINE config 5 (``entry.forward_orb``) in the stages of
    ``ORB.detect_and_compute_batch``."""
    _, (x, orb) = E.entry_orb("cuda")
    tabs = orb._tables_for(x.shape[1], x.shape[2], x.device)
    return [("levels", lambda _: orb._levels(x, tabs)),
            ("candidates", lambda levels: orb._candidates(levels, tabs)),
            ("readback", orb._read_rows),
            ("hostTail", lambda rows: orb._host_tail(*rows))]


def decode_stages():
    """``entry.forward_decode_color`` stage by stage; the three conversions
    and the fused map each read the decoded frame, kept from the first."""
    _, (y, uv) = E.entry_decode_color("cuda")
    frame = {}

    def decode(_):
        frame["bgr"] = cv.cvtColorTwoPlane(y, uv, cv.COLOR_YUV2BGR_NV12)
        return frame["bgr"]

    def sums(binary_integral):
        return [o.reshape(o.shape[0], -1).sum(dim=1, dtype=torch.int64)
                for o in (frame["bgr"], *binary_integral)]

    return [("cvtColorTwoPlane", decode),
            ("HSV", lambda bgr: (cv.cvtColor(bgr, cv.COLOR_BGR2HSV), bgr)[1]),
            ("Lab", lambda bgr: (cv.cvtColor(bgr, cv.COLOR_BGR2Lab), bgr)[1]),
            ("YCrCb", lambda bgr: (cv.cvtColor(bgr, cv.COLOR_BGR2YCrCb), bgr)[1]),
            ("gauss5_down2", lambda bgr: cv.fusedPreprocessGrayBlurDown2(bgr)[..., None]),
            ("thresholdOtsu", lambda small: cv.threshold(small, 0, 255,
                                                          cv.THRESH_BINARY | cv.THRESH_OTSU)[1]),
            ("integral", lambda binary: (binary, cv.integral(binary))),
            ("sums", sums)]


def enhance_stages():
    """``entry.forward_enhance`` stage by stage (``entry.ENHANCE_STAGES``),
    then the CLAHE output's histogram per image and the per-image sums."""
    _, (x,) = E.entry_enhance("cuda")
    outs = []

    def kept(fn):
        def run(a):
            outs.append(fn(x if a is None else a))
            return outs[-1]
        return run

    def hist(_):
        outs.append(hist_per_image(outs[2]))
        return outs

    def sums(o):
        s = [v.reshape(v.shape[0], -1).sum(dim=1, dtype=torch.int64) for v in o]
        outs.clear()
        return s

    return [(name, kept(fn)) for name, fn in E.ENHANCE_STAGES] + [("calcHist", hist),
                                                                   ("sums", sums)]


def motion_stages():
    """``entry.forward_motion`` stage by stage (``entry.MOTION_STAGES``), each
    adding its outputs to the state dict the previous stage passed on."""
    _, (x,) = E.entry_motion("cuda")

    def step(fn):
        def run(st):
            st = {"x": x} if st is None else st
            fn(st)
            return st
        return run

    return [(name, step(fn)) for name, fn, _ in E.MOTION_STAGES]


def lines_stages():
    """``entry.forward_lines`` stage by stage (``entry.LINES_STAGES``), each
    adding its outputs to the state dict the previous stage passed on."""
    _, (x,) = E.entry_lines("cuda")

    def step(fn):
        def run(st):
            st = {"x": x} if st is None else st
            fn(st)
            return st
        return run

    return [(name, step(fn)) for name, fn, _ in E.LINES_STAGES]


def segment_stages():
    """``entry.forward_segment`` stage by stage (``entry.SEGMENT_STAGES``),
    each adding its outputs to the state dict the previous stage passed
    on."""
    _, (x, model) = E.entry_segment("cuda")

    def step(fn):
        def run(st):
            st = {"x": x, "model": model} if st is None else st
            fn(st)
            return st
        return run

    return [(name, step(fn)) for name, fn, _ in E.SEGMENT_STAGES]


def photo_stages():
    """``entry.forward_photo`` stage by stage (``entry.PHOTO_STAGES``), each
    adding its outputs to the state dict the previous stage passed on."""
    _, (x, face, wire) = E.entry_photo("cuda")

    def step(fn):
        def run(st):
            st = E.photo_state(x, face, wire) if st is None else st
            fn(st)
            return st
        return run

    return [(name, step(fn)) for name, fn, _ in E.PHOTO_STAGES]


def stereo_stages():
    """``entry.forward_stereo`` stage by stage (``entry.STEREO_STAGES``) on
    the scene pair, with the rig calibrated once from the views."""
    _, (pair, rig) = E.entry_stereo("cuda")

    def step(fn):
        def run(st):
            st = E.stereo_state(pair, rig) if st is None else st
            fn(st)
            return st
        return run

    return [(name, step(fn)) for name, fn, _ in E.STEREO_STAGES]


def stitch_stages():
    """The stitching path's six stages on its last pair."""
    from opencv_tpu_torch.blenders import blend_multiband
    from opencv_tpu_torch.calib3d.geometry import RANSAC, findHomography
    frames_np, _ = E.make_pan_video(E.SHAPE_STITCH)
    frames = torch.from_numpy(frames_np).cuda()
    st = E.forward_stitch(frames)
    s, Hs = st["stitcher"], st["homographies"]
    base = frames[0]
    for i, H in enumerate(Hs[:-1]):
        base = s.compose(base, frames[i + 1], H)
    b, H = frames[-1], Hs[-1]
    (_, d1), (_, d2) = s.orb.detectAndCompute(base, None), s.orb.detectAndCompute(b, None)
    d1, d2 = torch.from_numpy(d1).cuda(), torch.from_numpy(d2).cuda()
    src, dst = s.match_points(base, b)
    canvas, warped, ma, mb = s.canvas(base, b, H)
    wa, wb = s.seam_weights(ma, mb)
    return [("orb", lambda _: (s.orb.detectAndCompute(base, None),
                               s.orb.detectAndCompute(b, None))),
            ("match", lambda _: s.matcher.match(d2, d1)),
            ("homography", lambda _: findHomography(src, dst, RANSAC, 3.0)),
            ("warp", lambda _: s.canvas(base, b, H)),
            ("distance", lambda _: s.seam_weights(ma, mb)),
            ("blend", lambda _: blend_multiband([canvas, warped], [wa, wb], num_bands=4))]


def gapi_stages():
    """The flagship graph through Stream, on a resident batch, and loaded
    back from its exported bytes."""
    from opencv_tpu_torch import gapi
    batches = [E.make_batch(E.SHAPE, seed) for seed in range(4)]
    comp = E.gapi_flagship(E.SHAPE)
    x = torch.from_numpy(batches[0]).cuda()
    fn = gapi.deserialize_compiled(gapi.serialize_compiled(comp.apply, x))
    return [("stream4", lambda _: E.forward_gapi(batches, comp, "cuda")),
            ("graph", lambda _: comp.apply(x)),
            ("loaded", lambda _: fn(x))]


def trackdnn_stages():
    """GOTURN at its published widths: one tracker's crops, the net, and an
    update of the six trackers on frame 1."""
    frames_np, _, boxes = E.make_motion_video(E.SHAPE_TRACK_DNN)
    frames = torch.from_numpy(frames_np).cuda()
    trackers = E.make_goturn_trackers(E.make_goturn_net(0, "cuda"), frames[0], boxes[0])
    t = trackers[0]
    region = t.search_region()
    target, search = t.blobs(frames[1], region)
    return [("crops", lambda _: t.blobs(frames[1], region)),
            ("net", lambda _: t.forward(target, search)),
            ("update6", lambda _: [k.update(frames[1]) for k in trackers])]


PATHS = {"flagship": flagship_stages, "cfg2": cfg2_stages, "cfg3": cfg3_stages,
         "cfg4": cfg4_stages, "cfg5": cfg5_stages, "decode": decode_stages,
         "enhance": enhance_stages, "motion": motion_stages, "lines": lines_stages,
         "segment": segment_stages, "photo": photo_stages, "stereo": stereo_stages,
         "stitch": stitch_stages, "gapi": gapi_stages, "trackdnn": trackdnn_stages}


def staged(stages, marks=None):
    """Run the stages in order; `marks` collects a CUDA event after each
    stage."""
    v = None
    for name, fn in stages:
        with record_function(name):
            v = fn(v)
        if marks is not None:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--path", choices=sorted(PATHS), default="flagship")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--repeats", type=int, default=20,
                    help="unprofiled runs whose median time each stage")
    ap.add_argument("--table", help="write the profiler's key_averages table here")
    ap.add_argument("--sort", default="cuda_time_total",
                    help="the table's order (a key_averages column, e.g. self_cpu_time_total)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_forward: no CUDA device", file=sys.stderr)
        return 1
    stages = PATHS[args.path]()
    names = [name for name, _ in stages]
    for _ in range(2):
        staged(stages)
    torch.cuda.synchronize()
    per_stage = {s: [] for s in names}
    for _ in range(args.repeats):
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        marks = [start]
        staged(stages, marks)
        marks[-1].synchronize()
        for s, a, b in zip(names, marks, marks[1:]):
            per_stage[s].append(a.elapsed_time(b))
    print(f"device: {torch.cuda.get_device_name(0)}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            staged(stages)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    if args.table:
        os.makedirs(os.path.dirname(os.path.abspath(args.table)), exist_ok=True)
        with open(args.table, "w") as f:
            f.write(events.table(sort_by=args.sort, row_limit=40))

    def device_us(e):
        return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)

    def self_device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # a host-side stage span carries the device time of the torch ops under
    # it; kernels launched through ctypes (csrc/) are not attributed to it by
    # the profiler and show only in the kernel list
    cpu = torch.autograd.DeviceType.CPU
    spans = {e.key: e for e in events if e.key in names and e.device_type == cpu}
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in names]
    print(f"profiled: {args.iters} iterations, wall {wall_ms / args.iters:.4f} ms each")
    span_sum = 0.0
    for s in names:
        e_ms = statistics.median(per_stage[s])
        span_sum += e_ms
        print(f"stage {s}: {e_ms:.4f} ms between its events; torch-op kernels "
              f"{device_us(spans[s]) / args.iters / 1e3:.4f} ms")
    k_iter = sum(self_device_us(e) for e in kernels) / args.iters / 1e3
    print(f"device busy share, unprofiled estimate: {k_iter / span_sum:.4f} "
          f"(kernel time {k_iter:.4f} ms per iteration over {span_sum:.4f} ms of stage spans)")
    for e in sorted(kernels, key=self_device_us, reverse=True)[:12]:
        print(f"kernel {self_device_us(e) / args.iters / 1e3:.4f} ms/iter "
              f"x{e.count // args.iters} {e.key[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
