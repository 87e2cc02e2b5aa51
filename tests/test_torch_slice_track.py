"""The port's feature-tracking path (``entry.forward_track``) on the CPU, on a
3-frame (240, 320) pan tracked at 120×160, against the same chain of
``opencv_tpu`` calls and the pan's truth.

Stage by stage on the port's own inputs: the fused map exactly (the JAX
kernel in interpret mode); AKAZE under tests/test_torch_akaze.py's bound
(XLA contracts the JAX program's multiply-adds); BRISK exactly (the JAX
package's dense AGAST run eagerly: integer ops, its jitted values, without
two compiles); KAZE equal to the port's KAZE module, which
tests/test_torch_kaze.py holds to the JAX package on these frames; the
matching on the JAX package's own keypoints and descriptors exactly.  As a
chain: BRISK's good pairs exactly, and at least 95% of the JAX package's
AKAZE good pairs are the port's, at points within 1e-3 px.  The truth: for
AKAZE at least 0.95 of good pairs within 2.5 px (measured 0.9852) and 50
good pairs a pair (measured 65, 70); for BRISK 0.80 (measured 0.8658) and
100 (measured 140, 158)."""

import numpy as np
import pytest
import torch

import opencv_tpu as jcv
from opencv_tpu.features2d import agast as jagast
from opencv_tpu.features2d import brisk as jbrisk
import opencv_tpu_torch as tcv
from opencv_tpu_torch import entry as E

from test_torch_akaze import _one_torch_thread, assert_within_bound, same_mldb  # noqa: F401

SHAPE = (3, 240, 320, 3)


@pytest.fixture(scope="module")
def video():
    return E.make_pan_video(SHAPE)


@pytest.fixture(scope="module")
def port(video):
    return E.forward_track(torch.from_numpy(video[0]))


@pytest.fixture(scope="module")
def ref(video):
    """The JAX package's chain: the fused map, AKAZE and BRISK on every
    frame, and its matchers on its own features."""
    from opencv_tpu.kernels.fused_preproc import fused_gray_gauss5_down2 as j_fused
    small = np.asarray(j_fused(video[0], 0.0, interpret=True))
    akaze = jcv.AKAZE_create().detect_and_compute_batch(small)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbrisk, "_agast_dense", jagast._agast_dense.__wrapped__)
        brisk = jcv.BRISK_create().detect_and_compute_batch(small)
    knn = {"akaze": [], "brisk": []}
    for i in range(len(small) - 1):
        knn["akaze"].append(jcv.BFMatcher(jcv.NORM_HAMMING).knnMatch(akaze[i][1], akaze[i + 1][1],
                                                                     2))
        m = jcv.FlannBasedMatcher(E.TRACK_LSH, {"checks": 32})
        m.add(brisk[i + 1][1])
        m.train()
        knn["brisk"].append(m.knnMatch(brisk[i][1], None, 2))
    return {"small": small, "akaze": akaze, "brisk": brisk, "knn": knn}


def _rows(knn):
    return [[(m.queryIdx, m.trainIdx, m.distance) for m in r] for r in knn]


def _ratio_pairs(knn):
    return {(p[0].queryIdx, p[0].trainIdx) for p in knn
            if len(p) == 2 and p[0].distance < E.TRACK_RATIO * p[1].distance}


def test_entry_track(video):
    forward, (x,) = E.entry_track("cpu", SHAPE)
    assert forward is E.forward_track and x.device.type == "cpu"
    np.testing.assert_array_equal(x.numpy(), video[0])
    assert E.SHAPE_TRACK == (8, 1080, 1920, 3) and E.TRACK_KAZE_FRAMES == 2
    assert E.TRACK_LSH == {"algorithm": 6, "table_number": 6, "key_size": 12,
                           "multi_probe_level": 1}
    written = [k for _, _, keys in E.TRACK_STAGES for k in keys]
    assert [n for n, _, _ in E.TRACK_STAGES] == ["small", "akaze_space", "akaze_detect",
                                                 "akaze_describe", "brisk", "kaze", "match"]
    assert len(written) == len(set(written))


def test_small_is_the_fused_map(port, ref):
    assert port["small"].dtype == torch.uint8 and port["small"].shape == (3, 120, 160)
    np.testing.assert_array_equal(port["small"].numpy(), ref["small"])


def test_akaze_stage_within_bound(port, ref):
    assert len(port["akaze_levels"]) == 8
    for b, want in enumerate(ref["akaze"]):
        got = (port["akaze_keypoints"][b], port["akaze_descriptors"][b])
        assert len(got[0]) > 50
        assert_within_bound(got, want, same_mldb)
    for lv, mask in zip(port["akaze_levels"], port["akaze_masks"]):
        assert mask.shape == lv["Ldet"].shape and mask.dtype == torch.bool


def test_brisk_stage_equals_opencv_tpu(port, ref):
    assert [tuple(a.shape) for a in port["brisk_layers"]] == [(3, 120, 160), (3, 60, 80)]
    for b, (wk, wd) in enumerate(ref["brisk"]):
        gk = port["brisk_keypoints"][b]
        assert len(gk) > 100
        assert [(k.pt, k.size, k.angle, k.response, k.octave) for k in gk] == \
            [(k.pt, k.size, k.angle, k.response, k.octave) for k in wk]
        np.testing.assert_array_equal(port["brisk_descriptors"][b], wd)
    # the score and keep maps are AGAST's of each layer
    for layer, (s, k) in zip(port["brisk_layers"], port["brisk_scores"]):
        ws, wk = jagast._agast_dense.__wrapped__(layer[:1].numpy()[..., None], 30, 3, True)
        np.testing.assert_array_equal(s[:1].numpy(), np.asarray(ws)[..., 0])
        np.testing.assert_array_equal(k[:1].numpy(), np.asarray(wk)[..., 0])


def test_kaze_stage_equals_the_kaze_module(port):
    """Frames 0-1 only; the module is held to the JAX package on them in
    tests/test_torch_kaze.py."""
    assert len(port["kaze_keypoints"]) == E.TRACK_KAZE_FRAMES == 2
    assert port["kaze_levels"][0]["Lt"].shape == (2, 120, 160)
    want = tcv.KAZE_create().detect_and_compute_batch(port["small"][:2])
    for b, (wk, wd) in enumerate(want):
        assert [(k.pt, k.size, k.angle, k.response, k.class_id) for k in
                port["kaze_keypoints"][b]] == \
            [(k.pt, k.size, k.angle, k.response, k.class_id) for k in wk]
        np.testing.assert_array_equal(port["kaze_descriptors"][b], wd)


def test_match_stage_on_opencv_tpu_features(ref):
    """The port's matching and ratio test on the JAX package's own
    keypoints and descriptors give the JAX matchers' rows exactly."""
    st = {"small": torch.from_numpy(ref["small"].copy())}
    for det in ("akaze", "brisk"):
        st[f"{det}_keypoints"] = [k for k, _ in ref[det]]
        st[f"{det}_descriptors"] = [d for _, d in ref[det]]
    # KAZE's L2 matching, on float rows (AKAZE's bytes as floats)
    st["kaze_keypoints"] = st["akaze_keypoints"][:2]
    st["kaze_descriptors"] = [d.astype(np.float32) for d in st["akaze_descriptors"][:2]]
    dict((n, fn) for n, fn, _ in E.TRACK_STAGES)["match"](st)
    for det in ("akaze", "brisk"):
        assert _rows(st["knn"][det][0]) == _rows(ref["knn"][det][0])
        assert _rows(st["knn"][det][1]) == _rows(ref["knn"][det][1])
        for i in range(2):
            assert set(map(tuple, st["good"][det][i].tolist())) == \
                _ratio_pairs(ref["knn"][det][i])
            assert st["counts"][det][i] == (len(_ratio_pairs(ref["knn"][det][i])),
                                            len(ref["knn"][det][i]))
    want = jcv.BFMatcher(jcv.NORM_L2).knnMatch(st["kaze_descriptors"][0],
                                               st["kaze_descriptors"][1], 2)
    assert _rows(st["knn"]["kaze"][0]) == _rows(want)


def test_chain_against_the_jax_composition(port, ref):
    for i in range(2):
        # BRISK: the same good pairs
        got = set(map(tuple, port["good"]["brisk"][i].tolist()))
        assert got == _ratio_pairs(ref["knn"]["brisk"][i]) and len(got) > 50
        # AKAZE: the JAX package's good pairs, found among the port's
        rk0, rk1 = ref["akaze"][i][0], ref["akaze"][i + 1][0]
        want = [(rk0[q].pt, rk1[t].pt) for q, t in _ratio_pairs(ref["knn"]["akaze"][i])]
        p0, p1 = port["points"]["akaze"][i]
        both = np.concatenate([p0, p1], axis=1)
        hits = sum(bool((np.abs(both - np.array([*a, *b])).max(axis=1) <= 1e-3).any())
                   for a, b in want)
        assert hits >= 0.95 * len(want) and len(want) > 40


def test_truth_report(video, port):
    for det, share, good in (("akaze", 0.95, 50), ("brisk", 0.80, 100)):
        rep = E.track_truth_report(port, video[1], SHAPE, det)
        assert rep["share"] >= share, (det, rep)
        assert all(n >= good for n, _, _ in rep["per_pair"]), (det, rep)
        assert [c[0] for c in port["counts"][det]] == [n for n, _, _ in rep["per_pair"]]
    rep = E.track_truth_report(port, video[1], SHAPE, "kaze")
    assert len(rep["per_pair"]) == 1 and rep["share"] >= 0.95
