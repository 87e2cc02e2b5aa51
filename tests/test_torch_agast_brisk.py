"""The port's AGAST and BRISK (``opencv_tpu_torch.features2d.agast`` and
``.brisk``) on the CPU against ``opencv_tpu``'s, exactly: integer maps,
keypoints (pt, size, angle, response, octave) and descriptors.

AGAST's ring types and NMS switches are held to the JAX package's own
dense test run eagerly (``_agast_dense.__wrapped__``: integer ops, the
same values as its jitted program, without a compile per case), and so is
BRISK at 64×96, the pyramid's edge (a short side that halves to exactly 32
still makes a second layer); the public ``AGAST`` to the jitted JAX
package at 64×96.  BRISK at 120×160 is held to the JAX package in
tests/test_torch_slice_track.py."""

import numpy as np
import pytest
import torch

import opencv_tpu as jcv
from opencv_tpu.features2d import agast as jagast
from opencv_tpu.features2d import brisk as jbrisk
import opencv_tpu_torch as tcv
from opencv_tpu_torch.features2d import agast as tagast
from opencv_tpu_torch.features2d import brisk as tbrisk
from opencv_tpu_torch import entry as E

from torch_threads import _one_torch_thread  # noqa: F401


def _gray(shape, seed=0):
    video, _ = E.make_pan_video((1, *shape, 3), seed)
    return tcv.cvtColor(torch.from_numpy(video), tcv.COLOR_BGR2GRAY)[0, ..., 0].numpy()


def _kp(kps):
    return [(k.pt, k.size, k.angle, k.response, k.octave) for k in kps]


@pytest.fixture(scope="module")
def img():
    return _gray((64, 96), 2)


@pytest.fixture(scope="module")
def small_batch():
    """Two 40×52 images: a textured one and a posterised one (flat
    plateaus and steps, the segment test's ties)."""
    a = _gray((40, 52), 1)
    return np.stack([a, (a // 64) * 64])


def test_tables_equal_opencv_tpu():
    assert tagast._RINGS == jagast._RINGS
    for name in ("_PTS", "_SIG"):
        np.testing.assert_array_equal(getattr(tbrisk, name), getattr(jbrisk, name))
    assert tbrisk._SHORT == jbrisk._SHORT and len(tbrisk._SHORT) == 512
    assert tbrisk._LONG == jbrisk._LONG and len(tbrisk._LONG) == 393
    for name in ("AGAST_5_8", "AGAST_7_12d", "AGAST_7_12s", "OAST_9_16"):
        assert getattr(tcv.AgastFeatureDetector, name) == getattr(jcv.AgastFeatureDetector, name)


@pytest.mark.parametrize("nonmax", [True, False])
@pytest.mark.parametrize("agast_type", [0, 1, 2, 3])
def test_agast_dense_equals_opencv_tpu(small_batch, agast_type, nonmax):
    """Score and keep maps of both images, at a threshold per case."""
    thr = (0, 10, 25, 40)[agast_type] + (0 if nonmax else 5)
    s, k = jagast._agast_dense.__wrapped__(small_batch[..., None], thr, agast_type, nonmax)
    gs, gk = tagast.agast_dense(torch.from_numpy(small_batch), thr, agast_type, nonmax)
    assert gs.dtype == torch.int32 and gk.dtype == torch.bool
    np.testing.assert_array_equal(gs.numpy(), np.asarray(s)[..., 0])
    np.testing.assert_array_equal(gk.numpy(), np.asarray(k)[..., 0])
    assert int(gk[0].sum()) > 0 and int(gk[1].sum()) > 0


@pytest.mark.parametrize("agast_type", [0, 1, 2, 3])
def test_agast_closed_form_equals_bisection(small_batch, agast_type):
    """The closed-form score equals the plain twin's 9-step bisection."""
    x = torch.from_numpy(small_batch)
    for thr in (0, 7, 25, 254):
        for nonmax in (True, False):
            a = tagast.agast_dense(x, thr, agast_type, nonmax)
            b = tagast.agast_dense_bisect(x, thr, agast_type, nonmax)
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_agast_equals_opencv_tpu(img):
    got = tcv.AGAST(img, 10, True, tcv.AgastFeatureDetector.OAST_9_16)
    want = jcv.AGAST(img, 10, True, jcv.AgastFeatureDetector.OAST_9_16)
    assert len(got) > 20 and _kp(got) == _kp(want)


def test_agast_detector_class(img):
    t = tcv.AgastFeatureDetector_create(10, True)
    j = jcv.AgastFeatureDetector_create(10, True)
    assert (t.getThreshold(), t.getType()) == (j.getThreshold(), j.getType()) == (10, 3)
    mask = np.zeros(img.shape, np.uint8)
    mask[10:50, 20:80] = 1
    assert _kp(t.detect(img, mask)) == _kp(j.detect(img, mask))
    t.setThreshold(25)
    t.setNonmaxSuppression(False)
    t.setType(tcv.AgastFeatureDetector.AGAST_5_8)
    assert (t.getThreshold(), t.getType(), t.nonmaxSuppression) == (25, 0, False)
    want = [(k.pt, k.response) for k in _kp_from_dense(img, 25, 0, False)]
    assert [(k.pt, k.response) for k in t.detect(img)] == want


def _kp_from_dense(img, thr, agast_type, nonmax):
    """The JAX package's AGAST keypoints, from its eager dense test."""
    s, k = jagast._agast_dense.__wrapped__(img[None, ..., None], thr, agast_type, nonmax)
    s, k = np.asarray(s)[0, ..., 0], np.asarray(k)[0, ..., 0]
    ys, xs = np.nonzero(k)
    return [jcv.KeyPoint(float(x), float(y), 7.0, -1.0, float(s[y, x])) for y, x in zip(ys, xs)]


@pytest.fixture(scope="module")
def brisk_ref(img):
    """The JAX package's detectAndCompute (its detect, then its compute,
    which sets each keypoint's angle), its dense AGAST run eagerly."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbrisk, "_agast_dense", jagast._agast_dense.__wrapped__)
        return jcv.BRISK_create().detectAndCompute(img)


def _unoriented(kps):
    return [(k.pt, k.size, k.response, k.octave) for k in kps]


def test_brisk_detect_equals_opencv_tpu(img, brisk_ref):
    br = tcv.BRISK_create()
    assert [(tuple(a.shape), s) for a, s in br.pyramid(torch.from_numpy(img)[None])] == \
        [((1, 64, 96), 1.0), ((1, 32, 48), 2.0)]
    got = br.detect(img)
    assert len(got) > 20 and _unoriented(got) == _unoriented(brisk_ref[0])
    assert {k.octave for k in got} == {0, 1} and {k.angle for k in got} == {-1.0}


def test_brisk_compute_equals_opencv_tpu(img, brisk_ref):
    kps = [tcv.KeyPoint(k.pt[0], k.pt[1], k.size, -1.0, k.response, k.octave)
           for k in brisk_ref[0]]
    got_k, got_d = tcv.BRISK_create().compute(img, kps)
    want_k, want_d = brisk_ref
    assert got_d.dtype == np.uint8 and got_d.shape == (len(want_k), 64)
    assert _kp(got_k) == _kp(want_k)
    np.testing.assert_array_equal(got_d, want_d)


def test_brisk_detect_and_compute_equals_opencv_tpu(img, brisk_ref):
    got_k, got_d = tcv.BRISK_create().detectAndCompute(img)
    want_k, want_d = brisk_ref
    assert _kp(got_k) == _kp(want_k)
    np.testing.assert_array_equal(got_d, want_d)
    # a BGR image takes the gray conversion first
    bgr = np.repeat(img[..., None], 3, axis=2)
    k3, d3 = tcv.BRISK_create().detectAndCompute(bgr)
    assert _kp(k3) == _kp(want_k) and np.array_equal(d3, want_d)


def test_brisk_batch_equals_per_image(img):
    imgs = np.stack([img, img[::-1, ::-1].copy(), np.zeros_like(img)])
    br = tcv.BRISK_create()
    batch = br.detect_and_compute_batch(torch.from_numpy(imgs))
    for im, (k, d) in zip(imgs, batch):
        k1, d1 = br.detectAndCompute(im)
        assert _kp(k) == _kp(k1) and np.array_equal(d, d1)
    assert len(batch[2][0]) == 0 and batch[2][1].shape == (0, 64)
    assert br.descriptorSize() == 64 and br.descriptorType() == 0 and br.defaultNorm() == 6
