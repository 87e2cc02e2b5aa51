"""HOG, groupRectangles and the Haar cascade of the port
(``opencv_tpu_torch/objdetect/hog.py``, ``cascade.py``) against the JAX
package's, on the CPU.

HOG: the gradient magnitudes equal the JAX package's; the angles are within
HOG_ANGLE_ATOL, an ulp of float32 at pi (numpy's float32 arctan2 against the
port's float64 one rounded once, before pi is added to the negative ones);
the normalised block histograms (one grouped F.conv2d against numpy's
einsum) within HOG_BLOCK_ATOL, the descriptors likewise,
and the window scores (one F.conv2d against numpy's matrix product) within
HOG_SCORE_ATOL; the windows found and the rectangles are equal wherever no
score lies within HOG_SCORE_ATOL of hitThreshold.  Both packages score with
the bundled INRIA SVM (the port's own copy of hog_detectors.npz).

The cascade: a Haar cascade in OpenCV's XML format written from the seed
(``entry.haar_cascade_xml``, 24 x 24, tilted features among its stumps),
its raw windows and grouped rectangles equal to the JAX package's exactly.
The JAX cascade is given the port's ``resize`` and ``integral3`` (both held
to the JAX package's in tests/test_torch_resize.py and
tests/test_torch_thresh_integral.py), which spares a jit compile per scale;
its stage loop, the code under test, is its own."""

import numpy as np
import pytest
import torch

from torch_threads import _one_torch_thread  # noqa: F401

import opencv_tpu as jcv
import opencv_tpu.ops.integral as jintegral
import opencv_tpu.ops.resize as jresize
from opencv_tpu.objdetect.cascade import CascadeClassifier as JCascade
from opencv_tpu.objdetect.hog import HOGDescriptor as JHOG
import opencv_tpu_torch as tcv
from opencv_tpu_torch import entry as E
from opencv_tpu_torch.ops.integral import integral3
from opencv_tpu_torch.ops.resize import resize
from opencv_tpu_torch.objdetect.cascade import CascadeClassifier as TCascade
from opencv_tpu_torch.objdetect.hog import HOGDescriptor as THOG

HOG_ANGLE_ATOL = float(np.spacing(np.float32(np.pi)))   # an ulp at pi
HOG_BLOCK_ATOL = 1e-6
HOG_SCORE_ATOL = 5e-5


def _texture(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, shape, np.uint8)
    return (np.cumsum(np.cumsum(a.astype(np.int64), 0), 1) % 256).astype(np.uint8)


IMAGES = {"bgr": _texture((160, 112, 3), 0), "gray": _texture((136, 96), 1)}


@pytest.mark.parametrize("kind", sorted(IMAGES))
def test_hog_gradients_blocks_and_descriptors_equal_opencv_tpu(kind):
    img = IMAGES[kind]
    t, j = THOG(), JHOG()
    mt, at = t._gradients(torch.from_numpy(img))
    mj, aj = j._gradients(img)
    np.testing.assert_array_equal(mt.numpy(), mj)
    assert np.abs(at.numpy() - aj).max() <= HOG_ANGLE_ATOL
    bj = j._block_hists(img)
    bt = t._block_hists(torch.from_numpy(img)).numpy()
    assert bt.shape == bj.shape[:2] + (36,)
    assert np.abs(bt - bj.reshape(bt.shape)).max() <= HOG_BLOCK_ATOL
    for ws, locs in (((8, 8), None), ((16, 24), None), (None, [(0, 0), (16, 8), (32, 0)])):
        dt = t.compute(torch.from_numpy(img), ws, None, locs).numpy()
        dj = j.compute(img, ws, None, locs)
        assert dt.shape == dj.shape and dt.dtype == dj.dtype
        assert np.abs(dt - dj).max() <= HOG_BLOCK_ATOL
    assert t.getDescriptorSize() == j.getDescriptorSize() == 3780


def _same_windows(got, want, thr):
    (ft, wt), (fj, wj) = got, want
    both = [(w, wj[fj.index(f)]) for f, w in zip(ft, wt) if f in fj]
    assert all(abs(a - b) <= HOG_SCORE_ATOL for a, b in both)
    for f, w in zip(fj, wj):
        if abs(w - thr) > HOG_SCORE_ATOL:
            assert f in ft
    for f, w in zip(ft, wt):
        if abs(w - thr) > HOG_SCORE_ATOL:
            assert f in fj


@pytest.mark.parametrize("detector", ["default", "daimler"])
def test_hog_detect_equals_opencv_tpu(detector):
    img = IMAGES["bgr"]
    t, j = THOG(), JHOG()
    if detector == "daimler":
        args = ((48, 96), (16, 16), (8, 8), (8, 8), 9)
        t, j = THOG(*args), JHOG(*args)
    svm = getattr(JHOG, f"get{detector.capitalize()}PeopleDetector")()
    np.testing.assert_array_equal(getattr(THOG, f"get{detector.capitalize()}PeopleDetector")(), svm)
    t.setSVMDetector(svm)
    j.setSVMDetector(svm)
    for thr in (-1.0, 0.0):
        _same_windows(t.detect(torch.from_numpy(img), thr), j.detect(img, thr), thr)
    scores, ys, xs = t.window_scores(torch.from_numpy(img))
    assert scores.shape == (len(ys), len(xs))


def test_hog_detect_multiscale_equals_opencv_tpu():
    img = np.ascontiguousarray(IMAGES["bgr"][:144, :96])
    t, j = tcv.HOGDescriptor(), jcv.HOGDescriptor()
    for h in (t, j):
        h.setSVMDetector(JHOG.getDefaultPeopleDetector())
    assert t.scales(144, 96) == [1.0, 1.05, 1.05 ** 2] == t.scales(*img.shape[:2])[:3]
    for thr, group in ((-1.5, 0.0), (-1.5, 2.0), (0.0, 2.0)):
        rt, wt = t.detectMultiScale(torch.from_numpy(img), thr, groupThreshold=group)
        rj, wj = j.detectMultiScale(img, thr, groupThreshold=group)
        np.testing.assert_array_equal(rt, rj)
        assert np.abs(np.asarray(wt) - np.asarray(wj)).max(initial=0) <= HOG_SCORE_ATOL
    # padding is ignored, as in the JAX package
    np.testing.assert_array_equal(t.detectMultiScale(img, -1.5, padding=(32, 32))[0],
                                  t.detectMultiScale(img, -1.5)[0])


def test_group_rectangles_equals_opencv_tpu():
    rng = np.random.default_rng(4)
    rects = [(10, 10, 50, 100), (12, 11, 50, 100), (9, 10, 52, 98), (200, 50, 40, 80)]
    rects += [tuple(int(v) for v in r) for r in rng.integers(0, 60, (40, 4)) + [0, 0, 20, 40]]
    for thr in (0, 1, 2, 3):
        for eps in (0.2, 0.5):
            got, want = tcv.groupRectangles(rects, thr, eps), jcv.groupRectangles(rects, thr, eps)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    out, w = tcv.groupRectangles(rects[:4], 1, 0.2)
    assert len(out) == 1 and w[0] == 3


@pytest.fixture
def cascade_xml(tmp_path, monkeypatch):
    monkeypatch.setattr(jintegral, "integral3", lambda x: tuple(
        a.numpy() for a in integral3(torch.from_numpy(np.asarray(x)))))
    monkeypatch.setattr(jresize, "resize", lambda x, *a, **k: resize(
        torch.from_numpy(np.ascontiguousarray(x)), *a, **k).numpy())
    path = tmp_path / "cascade.xml"
    path.write_text(E.haar_cascade_xml(0, stages=4))
    return str(path)


@pytest.mark.parametrize("sigma", [0.0, 3.0, 6.0])
def test_cascade_equals_opencv_tpu(cascade_xml, sigma):
    rng = np.random.default_rng(int(sigma))
    img = (rng.integers(0, 256, (96, 128), np.uint8) if sigma == 0 else
           np.clip(128 + 40 * E._smooth_noise(rng, 96, 128, sigma), 0, 255).astype(np.uint8))
    t, j = TCascade(cascade_xml), JCascade(cascade_xml)
    assert not t.empty() and t._has_tilted == j._has_tilted is True
    assert any(t._tilted[s.feat] for _, stumps in t._stages for s in stumps)
    for kw in (dict(minNeighbors=0), dict(), dict(scaleFactor=1.2, minNeighbors=1),
               dict(minNeighbors=0, minSize=(30, 30), maxSize=(60, 60))):
        got = t.detectMultiScale(torch.from_numpy(img), **kw)
        np.testing.assert_array_equal(got, j.detectMultiScale(img, **kw))
    color = np.repeat(img[..., None], 3, -1)
    np.testing.assert_array_equal(tcv.CascadeClassifier(cascade_xml).detectMultiScale(color),
                                  j.detectMultiScale(color))
    if sigma == 6.0:
        assert len(t.detectMultiScale(img, minNeighbors=0)) > 10
