"""The port's registration path (``entry.forward_register``) on the CPU, on a
2-frame (216, 384) pan registered at 0.05 Mpx (298×168, the same
downscale, 0.776, runs the INTER_LINEAR_EXACT resize as the 0.6 Mpx size
does at 1080p), against the JAX package's composition of the same ops and
the pan's truth.

Stage by stage on the port's own inputs: gray and the resize exactly; SIFT
under tests/test_torch_sift.py's bound (the JAX program's f32 pyramid is
contracted into fused multiply-adds by XLA); the FLANN build, search and
ratio test on the JAX package's own keypoints and descriptors exactly.  As
a chain: at least 95% of the JAX package's good pairs are the port's too,
with the same points within 1e-3 px.  The truth: at least 95% of good pairs
within 1.5 px of where the pan's matrix sends them (measured 0.9967), and
at least 200 good pairs (measured 304)."""

import numpy as np
import pytest
import torch

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu_torch import entry as E

from test_torch_sift import KP_SHARE, _pairs, close_descriptors

SHAPE = (2, 216, 384, 3)
MPX = 0.05


@pytest.fixture(scope="module")
def video():
    return E.make_pan_video(SHAPE)


@pytest.fixture(scope="module")
def port(video):
    return E.forward_register(torch.from_numpy(video[0]), MPX)


def _ratio_pairs(knn):
    return {(p[0].queryIdx, p[0].trainIdx) for p in knn
            if len(p) == 2 and p[0].distance < E.REGISTER_RATIO * p[1].distance}


@pytest.fixture(scope="module")
def ref(video):
    """The JAX package's composition: gray, resize, SIFT, FLANN, ratio."""
    frames = video[0]
    gray = np.asarray(jcv.cvtColor(frames, jcv.COLOR_BGR2GRAY))
    w, h = E.register_size(SHAPE[1], SHAPE[2], MPX)
    small = np.asarray(jcv.resize(gray, (w, h), interpolation=jcv.INTER_LINEAR_EXACT))
    feats = jcv.SIFT_create().detect_and_compute_batch(small[..., 0])
    m = jcv.FlannBasedMatcher()
    m.add(feats[1][1])
    m.train()
    knn = m.knnMatch(feats[0][1], None, 2)
    return {"gray": gray, "small": small, "feats": feats, "knn": knn}


def test_register_size():
    assert E.register_size(1080, 1920) == (1033, 581)
    assert E.register_size(*SHAPE[1:3], MPX) == (298, 168)
    assert E.register_size(216, 384) == (384, 216)       # never up


def test_stages_against_the_jax_composition(port, ref):
    assert port["gray"].shape == (2, 216, 384, 1)
    np.testing.assert_array_equal(port["gray"].numpy(), ref["gray"])
    assert port["small"].shape == (2, 168, 298, 1)
    np.testing.assert_array_equal(port["small"].numpy(), ref["small"])
    # SIFT on the same small frames, under the SIFT bound
    for (ok, od), (rk, rd) in zip(zip(port["keypoints"], port["descriptors"]), ref["feats"]):
        fwd, back = _pairs(ok, rk), _pairs(rk, ok)
        assert sum(j >= 0 for j in fwd) >= KP_SHARE * len(ok)
        assert sum(j >= 0 for j in back) >= KP_SHARE * len(rk)
        assert all(close_descriptors(od[i], rd[j]) for i, j in enumerate(fwd) if j >= 0)
    # FLANN and the ratio test on the JAX package's own features: exact
    st = {"keypoints": [f[0] for f in ref["feats"]], "descriptors": [f[1] for f in ref["feats"]]}
    for name in ("flann_build", "flann_search", "ratio"):
        dict((n, fn) for n, fn, _ in E.REGISTER_STAGES)[name](st)
    got = [[(m.queryIdx, m.trainIdx, m.distance) for m in row] for row in st["knn"][0]]
    want = [[(m.queryIdx, m.trainIdx, m.distance) for m in row] for row in ref["knn"]]
    assert got == want
    assert set(map(tuple, st["good"][0].tolist())) == _ratio_pairs(ref["knn"])
    assert st["counts"][0] == (len(_ratio_pairs(ref["knn"])), len(ref["knn"]))


def test_chain_against_the_jax_composition(port, ref):
    rk0, rk1 = ref["feats"][0][0], ref["feats"][1][0]
    want = {(rk0[q].pt, rk1[t].pt) for q, t in _ratio_pairs(ref["knn"])}
    p0, p1 = port["points"][0]
    got = np.concatenate([p0, p1], axis=1)
    hits = 0
    for (a, b) in want:
        d = np.abs(got - np.array([*a, *b])).max(axis=1)
        hits += bool((d <= 1e-3).any())
    assert hits >= 0.95 * len(want)
    assert len(port["knn"]) == 1 and len(port["good"]) == 1


def test_truth_report(video, port):
    rep = E.register_truth_report(port, video[1], SHAPE, mpx=MPX)
    assert rep["share"] >= 0.95
    assert all(n >= 200 and share >= 0.95 for n, share, _ in rep["per_pair"])
    assert port["counts"][0][0] == len(port["good"][0]) >= 200


def test_pan_video_truth_is_the_camera_motion(video):
    """The truth maps a frame's pixel to the same scene point in the next
    frame: a smooth patch of frame 0 warped by it matches frame 1 (noise
    and bilinear sampling apart)."""
    frames, truth = video
    assert frames.shape == SHAPE and frames.dtype == np.uint8 and truth.shape == (1, 2, 3)
    M = truth[0]
    # about 32 px (160 at 1080p) of pan, under 1.5 degrees, zoom within 2%
    assert 25 < -M[0, 2] < 40 and abs(M[1, 2]) < 10
    z = np.sqrt(abs(np.linalg.det(M[:, :2])))
    assert 0.98 <= z <= 1.02
    assert abs(np.degrees(np.arctan2(M[1, 0], M[0, 0]))) <= 1.5
    inv = tcv.invertAffineTransform(M)
    back = tcv.warpAffine(frames[1], inv, (SHAPE[2], SHAPE[1]))
    d = np.abs(np.asarray(back).astype(int) - frames[0].astype(int))[40:-40, 60:-120]
    assert np.median(d) <= 3
