"""The port's SIFT on the CPU against opencv_tpu's and the cv2 oracle.

The JAX package builds SIFT's f32 pyramid under ``jax.jit``, where XLA on
the CPU contracts the separable blur's and the LINEAR upsample's
multiply-adds into fused multiply-adds; the port's torch ops round each
product (its eager ``GaussianBlur`` equals the JAX package's own eager
``GaussianBlur`` exactly).  So the levels differ in the last float32 bits
(at most 6.1e-5 of a 0..255 scale measured here; the bound held is
``PYR_ATOL``), and keypoints and descriptors are held to opencv_tpu under a
bound: at least 99% of each side's keypoints found on the other with the
same octave, position within 1e-3 px, angle within 1e-2°, size and
response within a relative 1e-3 and 1e-4, and each such pair's descriptors
within one rounding step per element and an L2 of 2 (on the 512 scale; the
largest measured on the tests' images is sqrt(2), two elements off by 1).
The extremum masks, comparisons of those levels, are equal.  The card
against the CPU (chip_smoke.py phase 4k) is exact: both run the port's own
torch ops.  The JAX program compiles once per module, at one shape."""

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu_torch.features2d import sift as S
from torch_threads import _one_torch_thread  # noqa: F401

SHAPE = (2, 120, 160)
PYR_ATOL = 2e-4
KP_SHARE, POS_TOL, ANG_TOL, SIZE_RTOL, RESP_RTOL, DESC_L2 = 0.99, 1e-3, 1e-2, 1e-3, 1e-4, 2.0


def close_descriptors(a, b) -> bool:
    """Two descriptors within the bound: each element within 1, L2 <= 2."""
    d = np.abs(a.astype(np.float64) - b)
    return bool(d.max() <= 1.0 and np.sqrt((d * d).sum()) <= DESC_L2)


def _scene(h, w, seed):
    """Smoothed noise at two scales: SIFT finds blobs at several octaves."""
    r = np.random.default_rng(seed)
    coarse = cv2.resize(r.random((h // 8, w // 8)).astype(np.float32), (w, h),
                        interpolation=cv2.INTER_CUBIC)
    fine = cv2.GaussianBlur(r.random((h, w)).astype(np.float32), (0, 0), 2)
    return np.clip((coarse * 0.6 + fine * 0.8) * 255 - 60, 0, 255).astype(np.uint8)


IMGS = np.stack([_scene(SHAPE[1], SHAPE[2], s) for s in range(SHAPE[0])])


@pytest.fixture(scope="module")
def jax_sift():
    """opencv_tpu's pyramids, masks and per-image results, computed once."""
    js = jcv.SIFT_create()
    (gp, dg, mk), n_oct = js._build_pyramids_batch(IMGS.astype(np.float32)[..., None])
    pyr = ([[np.asarray(a)[..., 0] for a in o] for o in gp],
           [[np.asarray(a)[..., 0] for a in o] for o in dg],
           [[np.asarray(m) for m in o] for o in mk])
    return pyr, n_oct, js.detect_and_compute_batch(IMGS)


@pytest.fixture(scope="module")
def port_sift():
    return tcv.SIFT_create().detect_and_compute_batch(torch.from_numpy(IMGS))


def _pairs(a_kps, b_kps):
    """For each keypoint of a, the index of b's keypoint within the bounds,
    or -1; each of b's is used once."""
    used, out = set(), []
    by_oct = {}
    for j, k in enumerate(b_kps):
        by_oct.setdefault(k.octave, []).append(j)
    for k in a_kps:
        hit = -1
        for j in by_oct.get(k.octave, ()):
            m = b_kps[j]
            da = abs((k.angle - m.angle + 180.0) % 360.0 - 180.0)
            if (j not in used and abs(k.pt[0] - m.pt[0]) <= POS_TOL
                    and abs(k.pt[1] - m.pt[1]) <= POS_TOL and da <= ANG_TOL
                    and abs(k.size - m.size) <= SIZE_RTOL * k.size
                    and abs(k.response - m.response) <= RESP_RTOL * k.response):
                hit = j
                break
        if hit >= 0:
            used.add(hit)
        out.append(hit)
    return out


def test_pyramid_and_masks_against_opencv_tpu(jax_sift):
    (gp, dg, mk), n_oct, _ = jax_sift
    sift = tcv.SIFT_create()
    assert sift.n_octaves(*SHAPE[1:]) == n_oct
    gpyr, dog = sift.build_pyramids(torch.from_numpy(IMGS))
    masks = sift.extrema_masks(dog)
    assert len(gpyr) == len(dog) == len(masks) == n_oct
    for o in range(n_oct):
        assert len(gpyr[o]) == len(gp[o]) == 6 and len(dog[o]) == 5 and len(masks[o]) == 3
        for got, want in zip(gpyr[o] + dog[o], gp[o] + dg[o]):
            assert got.dtype == torch.float32 and got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PYR_ATOL)
        for got, want in zip(masks[o], mk[o]):
            assert got.dtype == torch.bool
            np.testing.assert_array_equal(got.numpy(), want)


def test_keypoints_and_descriptors_against_opencv_tpu(jax_sift, port_sift):
    _, _, ref = jax_sift
    for (ok, od), (rk, rd) in zip(port_sift, ref):
        assert od.dtype == rd.dtype == np.float32 and od.shape == (len(ok), 128)
        assert len(rk) > 50
        fwd, back = _pairs(ok, rk), _pairs(rk, ok)
        assert sum(j >= 0 for j in fwd) >= KP_SHARE * len(ok)
        assert sum(j >= 0 for j in back) >= KP_SHARE * len(rk)
        for i, j in enumerate(fwd):
            if j >= 0:
                assert ok[i].class_id == rk[j].class_id
                assert close_descriptors(od[i], rd[j])


def test_single_image_and_numpy_paths_equal_the_batch(port_sift):
    sift = tcv.SIFT_create()
    for b in range(SHAPE[0]):
        for img in (IMGS[b], torch.from_numpy(IMGS[b])):
            kps, desc = sift.detectAndCompute(img)
            bk, bd = port_sift[b]
            assert [(k.pt, k.size, k.angle, k.response, k.octave) for k in kps] == \
                [(k.pt, k.size, k.angle, k.response, k.octave) for k in bk]
            np.testing.assert_array_equal(desc, bd)
    assert len(sift.detect(IMGS[0])) == len(port_sift[0][0])
    bgr = np.repeat(IMGS[0][..., None], 3, axis=2)
    np.testing.assert_array_equal(sift.compute(bgr, None)[1], port_sift[0][1])


def test_extrema_mask_is_the_reference_rule():
    """The batched mask against a direct numpy statement of the rule, with
    plateaus (ties count as extrema) and edge replication."""
    rng = np.random.default_rng(0)
    d = np.round(rng.normal(0, 2, (3, 2, 9, 11))).astype(np.float32)
    thr = np.float32(0.5)
    got = S.extrema_mask(*(torch.from_numpy(a) for a in d), thr).numpy()
    p = np.pad(d, ((0, 0), (0, 0), (1, 1), (1, 1)), mode="edge")
    want = np.zeros(d.shape[1:], bool)
    for b in range(2):
        for y in range(9):
            for x in range(11):
                v = d[1, b, y, x]
                win = p[:, b, y:y + 3, x:x + 3].reshape(-1)
                nb = np.delete(win, 13)
                want[b, y, x] = abs(v) > thr and ((v > 0 and v >= nb.max())
                                                  or (v < 0 and v <= nb.min()))
    np.testing.assert_array_equal(got, want)


def test_nfeatures_cap_and_create():
    img = cv2.GaussianBlur(np.random.default_rng(7).integers(0, 256, (120, 160), np.uint8),
                           (3, 3), 1.0)
    assert len(tcv.SIFT_create(nfeatures=50).detect(img)) <= 60
    s = tcv.SIFT.create(100, 4, 0.05, 8.0, 1.5)
    assert (s.nfeatures, s.n_layers, s.contrast, s.edge, s.sigma) == (100, 4, 0.05, 8.0, 1.5)


def test_sift_against_cv2():
    """tests/test_features2d.py::test_sift_detect_and_compute's bounds."""
    img = cv2.GaussianBlur(np.random.default_rng(6).integers(0, 256, (160, 200), np.uint8),
                           (3, 3), 1.0)
    rk, rd = cv2.SIFT_create().detectAndCompute(img, None)
    ok, od = tcv.SIFT_create().detectAndCompute(torch.from_numpy(img), None)
    assert abs(len(ok) - len(rk)) <= 0.05 * len(rk)
    rpts = np.array([k.pt for k in rk])
    desc_d, ang_d = [], []
    for i, k in enumerate(ok):
        d = np.hypot(rpts[:, 0] - k.pt[0], rpts[:, 1] - k.pt[1])
        j = d.argmin()
        if d[j] < 1.0:
            desc_d.append(np.linalg.norm(rd[j].astype(float) - od[i]))
            da = abs(rk[j].angle - k.angle) % 360
            ang_d.append(min(da, 360 - da))
    assert len(desc_d) >= 0.9 * len(ok)
    assert np.median(desc_d) <= 5.0
    assert np.median(ang_d) <= 0.1


def test_ratio_test_overlap_with_cv2():
    """The port's SIFT on a rotated pair, matched by the port's
    FlannBasedMatcher and by cv2's, with the 0.7 ratio test
    (tests/test_flann.py::test_flann_matcher_sift_scene's bounds)."""
    rng = np.random.default_rng(5)
    img = cv2.GaussianBlur(rng.integers(0, 256, (240, 320), np.uint8), (0, 0), 2.0)
    img2 = cv2.warpAffine(img, cv2.getRotationMatrix2D((160, 120), 12, 0.95), (320, 240))
    sift = tcv.SIFT_create(nfeatures=300)
    (_, d1), (_, d2) = sift.detectAndCompute(img), sift.detectAndCompute(img2)
    assert len(d1) >= 20 and len(d2) >= 20

    def good(matcher):
        return {(p[0].queryIdx, p[0].trainIdx) for p in matcher.knnMatch(d1, d2, 2)
                if len(p) == 2 and p[0].distance < 0.7 * p[1].distance}

    ours, refs = good(tcv.FlannBasedMatcher()), good(cv2.FlannBasedMatcher())
    assert len(ours) >= 0.9 * len(refs)
    assert len(ours & refs) >= 0.8 * min(len(ours), len(refs))
