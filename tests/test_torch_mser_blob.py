"""The port's MSER (the native ``mser_detect`` of
``opencv_tpu_torch/native/hosttails.cpp`` and its Python twin) and
SimpleBlobDetector on the CPU, against ``opencv_tpu``'s, exactly: seeds
and levels, regions, boxes, keypoints and parameters."""

import numpy as np
import pytest
import torch

import opencv_tpu as jcv
from opencv_tpu.features2d import mser as jmser
import opencv_tpu_torch as tcv
from opencv_tpu_torch import native
from opencv_tpu_torch.features2d import mser as tmser

from test_torch_akaze import _one_torch_thread  # noqa: F401


def blobs(seed, H=120, W=160, n=14, bg=200):
    """Filled discs and ellipses of random greys on a flat background, with
    ±3 noise: MSER's and the blob detector's regions."""
    rng = np.random.default_rng(seed)
    img = np.full((H, W), bg, np.float64)
    yy, xx = np.mgrid[:H, :W]
    for _ in range(n):
        cx, cy = rng.uniform(8, W - 8), rng.uniform(8, H - 8)
        ax, ay = rng.uniform(3, 13), rng.uniform(3, 13)
        img[((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2 <= 1] = rng.integers(0, 130)
    return np.clip(img + rng.integers(-3, 4, img.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_mser_equals_python_twin(seed):
    img = blobs(seed)
    for im in (img, 255 - img):
        for args in ((5, 60, 14400, 0.25, 0.2), (2, 10, 2000, 0.5, 0.1)):
            got = native.mser_detect(im, *args)
            want = tmser._mser_py(im, *args)
            assert got[0].dtype == np.int32 and got[1].dtype == np.int32
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    assert len(native.mser_detect(img)[0]) > 3


def test_native_mser_equals_opencv_tpu_native():
    img = blobs(3)
    from opencv_tpu.native import mser_detect as j_native
    want = j_native(img)
    if want is None:  # the JAX package's library did not build: its Python path
        want = jmser._mser_py(img, 5, 60, 14400, 0.25, 0.2)
    got = native.mser_detect(img)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("seed", [0, 4])
def test_mser_equals_opencv_tpu(seed):
    img = blobs(seed)
    t, j = tcv.MSER_create(), jcv.MSER_create()
    got_r, got_b = t.detectRegions(img)
    want_r, want_b = j.detectRegions(img)
    assert len(got_r) == len(want_r) > 3
    for a, b in zip(got_r, want_r):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got_b, want_b)
    gk, wk = t.detect(img), j.detect(img)
    assert [(k.pt, k.size) for k in gk] == [(k.pt, k.size) for k in wk]
    # a tensor and a BGR image give the same
    bgr = np.repeat(img[..., None], 3, axis=2)
    r3, b3 = t.detectRegions(torch.from_numpy(bgr))
    np.testing.assert_array_equal(b3, want_b)
    mask = np.zeros(img.shape, np.uint8)
    mask[:, :80] = 1
    assert [(k.pt, k.size) for k in t.detect(img, mask)] == \
        [(k.pt, k.size) for k in j.detect(img, mask)]


def test_mser_parameters_equal_opencv_tpu():
    img = blobs(5)
    t, j = tcv.MSER_create(3, 20, 3000, 0.4, 0.3), jcv.MSER_create(3, 20, 3000, 0.4, 0.3)
    for obj in (t, j):
        obj.setDelta(4)
        obj.setMinArea(30)
        obj.setMaxArea(5000)
        obj.setPass2Only(True)
    assert (t.getDelta(), t.getMinArea(), t.getMaxArea(), t.getPass2Only()) == \
        (j.getDelta(), j.getMinArea(), j.getMaxArea(), j.getPass2Only()) == (4, 30, 5000, True)
    got_r, got_b = t.detectRegions(img)
    want_r, want_b = j.detectRegions(img)
    np.testing.assert_array_equal(got_b, want_b)
    assert all(np.array_equal(a, b) for a, b in zip(got_r, want_r))


def test_blob_params_equal_opencv_tpu():
    t, j = tcv.SimpleBlobDetector_Params(), jcv.SimpleBlobDetector_Params()
    assert vars(t) == vars(j)


def _blob_params(mod, **kw):
    p = mod.SimpleBlobDetector_Params()
    for k, v in kw.items():
        setattr(p, k, v)
    return p


@pytest.mark.parametrize("kw", [
    {},
    {"filterByCircularity": True, "minCircularity": 0.6, "filterByConvexity": False},
    {"filterByColor": False, "filterByInertia": False, "minArea": 10.0, "minRepeatability": 3},
    {"blobColor": 255, "minThreshold": 120.0, "maxThreshold": 250.0, "thresholdStep": 15.0},
], ids=["defaults", "circularity", "no-colour", "bright"])
def test_blob_detector_equals_opencv_tpu(kw):
    img = blobs(6)
    if kw.get("blobColor") == 255:
        img = 255 - img
    got = tcv.SimpleBlobDetector_create(_blob_params(tcv, **kw)).detect(img)
    want = jcv.SimpleBlobDetector_create(_blob_params(jcv, **kw)).detect(img)
    assert len(got) == len(want) > 0
    assert [(k.pt, k.size) for k in got] == [(k.pt, k.size) for k in want]


def test_blob_detector_on_a_tensor_and_bgr():
    img = blobs(7)
    want = [(k.pt, k.size) for k in jcv.SimpleBlobDetector_create().detect(img)]
    det = tcv.SimpleBlobDetector_create()
    assert [(k.pt, k.size) for k in det.detect(torch.from_numpy(img))] == want
    bgr = np.repeat(img[..., None], 3, axis=2)
    assert [(k.pt, k.size) for k in det.detect(bgr)] == want
    mask = np.zeros(img.shape, np.uint8)
    mask[60:] = 1
    assert [(k.pt, k.size) for k in det.detect(img, mask)] == [p for p in want if p[0][1] >= 60]
