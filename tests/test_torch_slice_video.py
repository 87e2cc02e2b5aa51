"""The port's video-analytics path (``entry.forward_video``) on the CPU, on
a 6-frame (180, 240) shaking video with movers, against the same chain of
``opencv_tpu`` calls and the video's truth.

Stage by stage on the port's own inputs: gray, the corners, the aligned
frames, the half-size frames and MOG2's background image exactly; LK's
tracks within LK_TOL px and their status equal on LK_SHARE of the points,
and Farnebäck's flow within FLOW_TOL px on FLOW_SHARE of the pixels (the
bounds of tests/test_torch_video_flow.py: the JAX package jits both and
XLA contracts their multiply-adds); the MOG2 masks equal on MASK_SHARE of
the pixels (measured: all).  As a chain (the JAX package's own corners,
tracks, shifts, aligned frames, masks and flow): the same bounds, the shifts
within LK_TOL px.  The truth (``entry.video_truth_report`` with LK's reach
at this size, 10 px at level 2 = 40 px): at least 0.80 of the static tracks
within 0.5 px (measured 0.8046 to 0.9481 of 56 to 87) and 50 of them; the
shake within 0.25 px (measured ≤ 0.003); the dense flow within 0.25 px on
every pair but the (15, −2) px one (measured 1.10 px: two Farnebäck levels
of a 90×120 frame do not reach 7.5 px; at 1080p all seven pairs are within
0.0015 px, chip_smoke.py 4n); MOG2's frame 5 with foreground in its boxes
and none on the static pixels."""

import numpy as np
import pytest
import torch

import opencv_tpu as jcv
from opencv_tpu_torch import entry as E
from torch_threads import _one_torch_thread  # noqa: F401

SHAPE = (6, 180, 240, 3)
LK_TOL = 1e-3
LK_SHARE = 0.99
FLOW_TOL = 1e-3
FLOW_SHARE = 0.999
MASK_SHARE = 0.999
REACH = 40


@pytest.fixture(scope="module")
def video():
    return E.make_motion_video(SHAPE)


@pytest.fixture(scope="module")
def port(video):
    return E.forward_video(torch.from_numpy(video[0]))


def _jax_align(frames, shifts):
    """The frames moved back by the rounded shifts, through the JAX
    package's warpAffine."""
    H, W = frames.shape[1:3]
    out = [frames[0]]
    for i, (sx, sy) in enumerate(np.rint(shifts), 1):
        M = np.array([[1.0, 0.0, -sx], [0.0, 1.0, -sy]])
        out.append(np.asarray(jcv.warpAffine(frames[i], M, (W, H), jcv.INTER_NEAREST,
                                             jcv.BORDER_REPLICATE)))
    return np.stack(out)


def _jax_tracks(gray, corners):
    """The JAX package's tracks, status and median shifts of frame 0's
    corners in each later frame."""
    p0 = corners[:, 0].astype(np.float64)
    tracks, status = [], []
    for i in range(1, len(gray)):
        p1, s1, _ = jcv.calcOpticalFlowPyrLK(gray[0], gray[i], corners)
        tracks.append(p1[:, 0])
        status.append(s1[:, 0])
    tracks, status = np.stack(tracks), np.stack(status)
    shifts = np.stack([np.median(t[s == 1] - p0[s == 1], axis=0)
                       for t, s in zip(tracks.astype(np.float64), status)])
    return tracks, status, shifts


def _jax_mog2(aligned):
    mog = jcv.createBackgroundSubtractorMOG2()
    masks = np.stack([np.asarray(mog.apply(f)) for f in aligned])
    return masks, np.asarray(mog.getBackgroundImage())


def _jax_flow(half):
    return np.stack([jcv.calcOpticalFlowFarneback(half[0], half[i], *E.VIDEO_FARNEBACK)
                     for i in range(1, len(half))])


@pytest.fixture(scope="module")
def ref(video, port):
    """The JAX package's stages on the port's inputs, and its own chain: a
    chain stage whose inputs equal the port's (checked here) is the stage
    already run on the port's inputs, and runs again only where they
    differ."""
    frames = video[0]
    p_gray = port["gray"][..., 0].numpy()
    gray = np.asarray(jcv.cvtColor(frames, jcv.COLOR_BGR2GRAY))[..., 0]
    corners = jcv.goodFeaturesToTrack(gray[0], **E.VIDEO_GFTT)
    half = np.asarray(jcv.pyrDown(p_gray[..., None]))[..., 0]
    stages = {"tracks": _jax_tracks(p_gray, port["corners"]),
              "aligned": _jax_align(frames, port["shifts"]),
              "mog2": _jax_mog2(port["aligned"].numpy()),
              "flow": _jax_flow(port["half"].numpy())}
    same_in = np.array_equal(gray, p_gray) and np.array_equal(corners, port["corners"])
    tracks = stages["tracks"] if same_in else _jax_tracks(gray, corners)
    aligned = _jax_align(frames, tracks[2])
    same_al = np.array_equal(aligned, port["aligned"].numpy())
    chain = {"corners": corners, "tracks": tracks,
             "mog2": stages["mog2"] if same_al else _jax_mog2(aligned),
             "flow": stages["flow"] if same_in and np.array_equal(half, port["half"].numpy())
             else _jax_flow(np.asarray(jcv.pyrDown(gray[..., None]))[..., 0])}
    return {"gray": gray, "half": half, "stages": stages, "chain": chain}


def _lk_close(p_got, s_got, p_want, s_want):
    d = np.abs(p_got.astype(np.float64) - p_want).max(axis=-1)
    assert (d <= LK_TOL).mean() >= LK_SHARE, d.max()
    assert (s_got == s_want).mean() >= LK_SHARE


def _flow_close(got, want):
    d = np.abs(got - want).max(axis=-1)
    assert (d <= FLOW_TOL).mean() >= FLOW_SHARE, d.max()


def test_stages_on_the_ports_inputs(port, ref):
    assert np.array_equal(port["gray"][..., 0].numpy(), ref["gray"])
    assert np.array_equal(port["corners"], ref["chain"]["corners"])
    st = ref["stages"]
    tracks, status, shifts = st["tracks"]
    _lk_close(port["tracks"], port["status"], tracks, status)
    assert np.abs(port["shifts"] - shifts).max() <= LK_TOL
    assert np.array_equal(port["aligned"].numpy(), st["aligned"])
    masks, background = st["mog2"]
    assert (port["masks"].numpy() == masks).mean() >= MASK_SHARE
    assert np.array_equal(port["background"].numpy(), background)
    assert np.array_equal(port["half"].numpy(), ref["half"])
    _flow_close(port["flow"].numpy(), st["flow"])


def test_chain_equals_the_jax_composition(port, ref):
    c = ref["chain"]
    tracks, status, shifts = c["tracks"]
    _lk_close(port["tracks"], port["status"], tracks, status)
    assert np.abs(port["shifts"] - shifts).max() <= LK_TOL
    assert (port["masks"].numpy() == c["mog2"][0]).mean() >= MASK_SHARE
    _flow_close(port["flow"].numpy(), c["flow"])


def test_truth(video, port):
    _, shifts, boxes = video
    rep = E.video_truth_report(port, shifts, boxes, SHAPE, reach=REACH)
    assert all(share >= 0.80 and n >= 50 for n, share in rep["klt"]), rep["klt"]
    assert max(rep["shake"]) <= 0.25
    dense = sorted(rep["dense"])
    assert dense[-2] <= 0.25 and dense[-1] <= 1.5, rep["dense"]
    least, mean, in_box, static = rep["bg"][1]
    assert mean >= 0.3 and in_box >= 0.99 and static <= 0.05
    assert all(r[3] <= 0.05 for r in rep["bg"])


def test_stage_table_and_outputs(port):
    names = [n for n, _, _ in E.VIDEO_STAGES]
    assert names == ["gray", "corners", "klt", "shake", "bg", "dense"]
    keys = {k for _, _, ks in E.VIDEO_STAGES for k in ks}
    assert keys == set(port)
    N, H, W, _ = SHAPE
    assert port["tracks"].shape == (N - 1, len(port["corners"]), 2)
    assert tuple(port["flow"].shape) == (N - 1, H // 2, W // 2, 2)
    assert tuple(port["masks"].shape) == (N, H, W) and port["masks"].dtype == torch.uint8
    fn, (x,) = E.entry_video("cpu", SHAPE)
    assert fn is E.forward_video and tuple(x.shape) == SHAPE and x.device.type == "cpu"
