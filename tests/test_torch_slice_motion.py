"""The port's the motion path (gray → GaussianBlur → phase correlation against
frame 0 → warpAffine by minus the shift → accumulateWeighted background →
absdiff, threshold and opening → connected components with stats, distance
transform, moments → the last frame's contours) end to end on the CPU,
against the same chain through opencv_tpu at a small batch (moved from
tests/test_torch_slice.py, one file per path)."""

import numpy as np
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu_torch import entry as E
from opencv_tpu_torch.core.dispatch import reset_tier_stats, tier_stats

SHAPE_MOTION = (4, 216, 384, 3)  # a fifth of 1080p, four frames


def _jax_motion(x, ins=None):
    """forward_motion's stages through opencv_tpu.  Each stage takes the
    port's own input to it from ``ins`` (forward_motion's dict) where given,
    else the previous JAX stage's output."""
    N, H, W, _ = x.shape
    out = {}

    def inp(key):
        return out[key] if ins is None else np.asarray(ins[key])

    out["gray"] = np.asarray(jcv.cvtColor(x, jcv.COLOR_BGR2GRAY))
    out["smooth"] = np.asarray(jcv.GaussianBlur(inp("gray"), (5, 5), 0))
    s = inp("smooth")[..., 0]
    win = jcv.createHanningWindow((W, H), jcv.CV_64F)
    pc = [jcv.phaseCorrelate(s[0], s[i], win) for i in range(1, N)]
    out["shifts"] = np.array([[sx, sy] for (sx, sy), _ in pc])
    out["responses"] = np.array([r for _, r in pc])
    shifts = inp("shifts")
    out["aligned"] = np.stack([s[0]] + [np.asarray(jcv.warpAffine(
        s[i], np.array([[1.0, 0, -shifts[i - 1, 0]], [0, 1.0, -shifts[i - 1, 1]]]), (W, H),
        jcv.INTER_LINEAR, jcv.BORDER_REPLICATE)) for i in range(1, N)])[..., None]
    a = inp("aligned")
    bg = a[0, ..., 0].astype(np.float32)
    for i in range(1, N):
        bg = np.asarray(jcv.accumulateWeighted(a[i, ..., 0], bg, 0.05))
    out["background"] = bg[None, ..., None]
    d = np.asarray(jcv.absdiff(a, np.asarray(jcv.convertScaleAbs(inp("background")))))
    _, m = jcv.threshold(d, 25, 255, jcv.THRESH_BINARY)
    out["mask"] = np.asarray(jcv.morphologyEx(np.asarray(m), jcv.MORPH_OPEN,
                                              jcv.getStructuringElement(jcv.MORPH_RECT, (3, 3))))
    m = inp("mask")
    cc = [jcv.connectedComponentsWithStats(m[i, ..., 0], 8) for i in range(N)]
    out["n_labels"] = np.array([c[0] for c in cc])
    out["labels"] = np.stack([np.asarray(c[1]) for c in cc])
    out["stats"] = [c[2] for c in cc]
    out["centroids"] = [c[3] for c in cc]
    out["distance"] = np.asarray(jcv.distanceTransform(m, jcv.DIST_L2, 3))
    out["moments"] = [jcv.moments(m[i, ..., 0], True) for i in range(N)]
    out["contours"] = jcv.findContours(m[-1, ..., 0], jcv.RETR_EXTERNAL,
                                       jcv.CHAIN_APPROX_SIMPLE)[0]
    return out


def _check_motion(got, want, what):
    """The port's motion outputs against opencv_tpu's: u8 images, labels,
    counts, stats and contours exactly, the shifts and responses within
    1e-9, the aligned frames within the warp bound (max |d| <= 1 on at most
    0.1% of pixels), the background bit for bit in f32, the distances
    within 1e-5, the centroids within 1e-9 relative, and the moments within
    rel 1e-12 of cv2 and within opencv_tpu's f32 error of it (its central
    moments cancel: its own distance from cv2)."""
    for key in ("gray", "smooth", "mask", "labels", "n_labels", "background"):
        np.testing.assert_array_equal(np.asarray(got[key]), want[key], err_msg=f"{what} {key}")
    for key in ("shifts", "responses"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-9, rtol=0, err_msg=key)
    d = np.abs(got["aligned"].numpy().astype(np.int32) - want["aligned"])
    assert d.max() <= 1 and np.count_nonzero(d) <= d.size // 1000, what
    for i, n in enumerate(want["n_labels"]):
        np.testing.assert_array_equal(got["stats"][i, :n].numpy(), want["stats"][i])
        assert not got["stats"][i, n:].any()
        np.testing.assert_allclose(got["centroids"][i, :n].numpy(), want["centroids"][i],
                                   rtol=1e-9, atol=0)
        ref = cv2.moments(got["mask"][i, ..., 0].numpy(), True)
        for k, v in want["moments"][i].items():
            g = got["moments"][i][k]
            assert abs(g - ref[k]) <= 1e-12 * max(1.0, abs(ref[k])), (what, i, k)
            bound = max(1e-6, abs(v) * 1e-5, 1.01 * abs(v - ref[k]) + 1e-12 * abs(ref[k]))
            assert abs(g - v) <= bound, (what, i, k)
    np.testing.assert_allclose(got["distance"].numpy(), want["distance"], atol=1e-5, rtol=0)
    assert len(got["contours"]) == len(want["contours"])
    for c, w in zip(got["contours"], want["contours"]):
        np.testing.assert_array_equal(c, w)


def test_entry_motion_video():
    forward, (x,) = E.entry_motion("cpu", SHAPE_MOTION)
    assert forward is E.forward_motion
    video, shifts, boxes = E.make_motion_video(SHAPE_MOTION)
    np.testing.assert_array_equal(x.numpy(), video)
    assert video.dtype == np.uint8 and video.shape == SHAPE_MOTION
    assert shifts.shape == (4, 2) and not shifts[0].any() and np.abs(shifts).max() <= 16
    assert boxes.shape == (4, E.MOTION_OBJECTS, 4)
    assert E.SHAPE_MOTION == (8, 1080, 1920, 3)


def test_motion_matches_opencv_tpu():
    """The path at (4, 216, 384, 3) against opencv_tpu's chain: every stage
    on the port's own input to it, then the whole chain (the seed's aligned
    frames come out equal, so the stages after them must too).  GaussianBlur
    resolves sep_filter's registration once, to the plain tier on the CPU."""
    x, _, _ = E.make_motion_video(SHAPE_MOTION)
    reset_tier_stats()
    got = E.forward_motion(torch.from_numpy(x))
    assert tier_stats() == {"tier.sep_filter_u8.plain": 1}
    N, H, W, _ = SHAPE_MOTION
    assert got["shifts"].shape == (N - 1, 2) and got["aligned"].shape == (N, H, W, 1)
    assert got["labels"].dtype == torch.int32 and got["distance"].dtype == torch.float32
    assert got["stats"].shape == (N, int(got["n_labels"].max()), 5)
    _check_motion(got, _jax_motion(x, got), "stage")
    _check_motion(got, _jax_motion(x), "chain")
    cols = [got[k] for k in E.MOTION_SUMS]
    cols[4] = torch.round(cols[4])
    np.testing.assert_array_equal(got["sums"].numpy(), np.stack(
        [c.reshape(N, -1).to(torch.int64).sum(1).numpy() for c in cols], 1))
    assert got["areas"] == [jcv.contourArea(c) for c in got["contours"]]
    assert got["rects"] == [jcv.boundingRect(c) for c in got["contours"]]


def test_motion_recovers_the_shifts_and_objects():
    """The shifts within 0.25 px of the video's, and every object box of
    frames 1.. overlaps a component of the mask in its frame (frame 0's
    objects weigh 0.95^(N-1) in the background)."""
    x, shifts, boxes = E.make_motion_video(SHAPE_MOTION)
    got = E.forward_motion(torch.from_numpy(x))
    assert np.abs(got["shifts"] - shifts[1:]).max() < 0.25
    labels = got["labels"].numpy()
    for i in range(1, SHAPE_MOTION[0]):
        for bx, by, bw, bh in boxes[i]:
            assert labels[i, by:by + bh, bx:bx + bw].any(), (i, bx, by)
    assert got["cc_steps"]["checks"] >= 1 and got["dt_steps"]["checks"] >= 1


def test_public_surface_motion():
    """The names the motion slice adds, each the class of its opencv_tpu
    twin."""
    for name in ("phaseCorrelate", "createHanningWindow", "accumulateWeighted",
                 "connectedComponentsWithStats", "distanceTransform", "moments", "findContours",
                 "contourArea", "boundingRect", "dft", "dct", "solve", "transform", "RNG",
                 "getRectSubPix", "convertMaps", "blendLinear", "matchShapes", "HuMoments"):
        assert hasattr(tcv, name), name
        assert getattr(tcv, name).__class__ is getattr(jcv, name).__class__, name


# ------------------------------------------------------------- lines path
