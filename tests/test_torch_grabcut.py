"""The port's kmeans and grabCut on the CPU, against opencv_tpu and cv2,
the models carried between the two packages, and the native max-flow
against its Python twin.

Tolerances, from the JAX package's f32 arithmetic under XLA (the port
reproduces its distances, ``ops/cluster.py``, but not the order of its f32
sums once they round): kmeans' labels equal on well-separated data and on
integer colours (at least 99.9% elsewhere), its centres and compactness
within rel 1e-5; grabCut's mask equal, or at most 0.01% of its pixels
apart (its likelihoods' exp and log are not numpy's to the last bit), each
count printed; the models are equal where the masks are (a GMM learns
exact integer sums)."""

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu_torch import native
from opencv_tpu_torch.ops import grabcut as G
from torch_threads import _one_torch_thread  # noqa: F401

REL = 1e-5


def _blobs(seed=5):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal((0, 0), 0.3, (40, 2)), rng.normal((5, 5), 0.3, (40, 2)),
                           rng.normal((0, 5), 0.3, (40, 2))]).astype(np.float32)


def _check_kmeans(got, want, min_share=1.0):
    (gc, gl, gC), (wc, wl, wC) = got, want
    gl, gC = np.asarray(gl), np.asarray(gC)
    assert gl.shape == wl.shape and gl.dtype == wl.dtype == np.int32
    assert gC.shape == wC.shape and gC.dtype == np.float32
    same = float((gl == wl).mean())
    print(f"kmeans: {int((gl != wl).sum())} of {gl.size} labels differ")
    assert same >= min_share
    assert abs(gc - wc) <= REL * abs(wc)
    np.testing.assert_allclose(gC, wC, rtol=REL, atol=REL * np.abs(wC).max())


@pytest.mark.parametrize("flags", [tcv.KMEANS_RANDOM_CENTERS, tcv.KMEANS_PP_CENTERS,
                                   tcv.KMEANS_USE_INITIAL_LABELS])
def test_kmeans_blobs_match_opencv_tpu_and_cv2(flags):
    blobs = _blobs()
    crit = (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 1e-4)
    init = np.repeat(np.arange(3, dtype=np.int32), 40)[:, None]
    labels = init if flags == tcv.KMEANS_USE_INITIAL_LABELS else None
    got = tcv.kmeans(blobs, 3, labels, crit, 5, flags)
    _check_kmeans(got, jcv.kmeans(blobs, 3, labels, crit, 5, flags))
    comp_ref, _, C_ref = cv2.kmeans(blobs, 3, None, crit, 5, cv2.KMEANS_PP_CENTERS)
    assert got[0] <= comp_ref * 1.05
    assert (np.abs(got[2][:, None] - C_ref[None]).sum(-1).min(axis=1) < 0.2).all()


@pytest.mark.parametrize("kind", ["u8 colours", "normal 4-d"])
def test_kmeans_many_points(kind):
    """grabCut's call (u8 colours, kmeans++, 10 iterations, 3 attempts) and
    float data in 4-d; tensors in, tensors out."""
    rng = np.random.default_rng(7)
    X = (rng.integers(0, 256, (20000, 3)) if kind == "u8 colours"
         else rng.normal(0, 3, (20000, 4))).astype(np.float32)
    want = jcv.kmeans(X, 5, None, (1, 10, 0.0), 3, jcv.KMEANS_PP_CENTERS)
    got = tcv.kmeans(torch.from_numpy(X), 5, None, (1, 10, 0.0), 3, tcv.KMEANS_PP_CENTERS)
    assert isinstance(got[1], torch.Tensor) and isinstance(got[2], torch.Tensor)
    _check_kmeans((got[0], got[1].numpy(), got[2].numpy()), want,
                  1.0 if kind == "u8 colours" else 0.999)
    if kind == "u8 colours":
        np.testing.assert_array_equal(got[2].numpy(), want[2])


def test_kmeans_empty_cluster_takes_the_farthest_point():
    X = np.array([[0, 0], [0, 0], [0, 0], [10, 10]], np.float32)
    init = np.array([0, 0, 0, 2], np.int32)
    got = tcv.kmeans(X, 3, init, (1, 3, 0.0), 1, tcv.KMEANS_USE_INITIAL_LABELS)
    want = jcv.kmeans(X, 3, init, (1, 3, 0.0), 1, jcv.KMEANS_USE_INITIAL_LABELS)
    _check_kmeans(got, want)


def _ellipse_image():
    """tests/test_hough_seg.py::test_grabcut_matches_cv2's image and rect."""
    rng = np.random.default_rng(0)
    H, W = 80, 100
    img = np.zeros((H, W, 3), np.uint8)
    img[..., 0], img[..., 1], img[..., 2] = 40, 120, 60
    cv2.ellipse(img, (50, 40), (22, 16), 0, 0, 360, (200, 80, 160), -1)
    img = np.clip(img.astype(int) + rng.integers(-12, 12, img.shape), 0, 255).astype(np.uint8)
    return img, (20, 15, 60, 50)


def _disc_image():
    rng = np.random.default_rng(3)
    img = cv2.GaussianBlur(rng.integers(0, 256, (120, 160, 3), np.uint8), (0, 0), 3)
    cv2.circle(img, (80, 60), 30, (30, 200, 90), -1)
    img = np.clip(img.astype(int) + rng.integers(-8, 8, img.shape), 0, 255).astype(np.uint8)
    return img, (30, 15, 100, 90)


def _mask_close(got, want, what):
    got = np.asarray(got)
    n = int((got != want).sum())
    print(f"grabCut {what}: {n} of {want.size} mask pixels differ")
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert n <= 1e-4 * want.size, what


@pytest.mark.parametrize("scene", ["ellipse", "disc"])
def test_grabcut_matches_opencv_tpu_and_cv2(scene):
    img, rect = _ellipse_image() if scene == "ellipse" else _disc_image()
    want = jcv.grabCut(img, None, rect, None, None, 3, jcv.GC_INIT_WITH_RECT)
    stats = {}
    got = G.grabCut(torch.from_numpy(img), None, rect, None, None, 3, G.GC_INIT_WITH_RECT,
                    stats=stats)
    assert isinstance(got[0], torch.Tensor) and len(stats["maxflow_ms"]) == 3
    _mask_close(got[0].numpy(), want[0], scene)
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == (1, 65) and g.dtype == np.float64
        np.testing.assert_array_equal(g, w)
    if scene == "ellipse":
        H, W = img.shape[:2]
        m_ref = np.zeros((H, W), np.uint8)
        cv2.grabCut(img, m_ref, rect, np.zeros((1, 65)), np.zeros((1, 65)), 3,
                    cv2.GC_INIT_WITH_RECT)
        fg_ref = (m_ref == 1) | (m_ref == 3)
        fg = np.isin(got[0].numpy(), (1, 3))
        assert (fg_ref & fg).sum() / max((fg_ref | fg).sum(), 1) > 0.95
        yy, xx = np.mgrid[0:H, 0:W]
        gt = ((xx - 50) / 22) ** 2 + ((yy - 40) / 16) ** 2 <= 1
        assert (fg & gt).sum() / (fg | gt).sum() > 0.9


def test_grabcut_models_carry_between_the_packages():
    """The (1, 65) models of either package seed the other's GC_EVAL and
    GC_INIT_WITH_MASK runs, and the masks agree."""
    img, rect = _disc_image()
    jm, jb, jf = jcv.grabCut(img, None, rect, None, None, 1, jcv.GC_INIT_WITH_RECT)
    tm, tb, tf = tcv.grabCut(img, None, rect, None, None, 1, tcv.GC_INIT_WITH_RECT)
    _mask_close(tm, jm, "rect, 1 iteration")
    for mode in (jcv.GC_EVAL, jcv.GC_INIT_WITH_MASK):
        # the port's models in opencv_tpu and opencv_tpu's in the port
        a = jcv.grabCut(img, jm.copy(), None, tb.copy(), tf.copy(), 2, mode)
        b = tcv.grabCut(img, jm.copy(), None, jb.copy(), jf.copy(), 2, mode)
        c = tcv.grabCut(img, jm.copy(), None, tb.copy(), tf.copy(), 2, mode)
        _mask_close(b[0], a[0], f"mode {mode}, models crossed")
        _mask_close(c[0], a[0], f"mode {mode}, own models")
    frozen = tcv.grabCut(img, jm.copy(), None, jb, jf, 1, G.GC_EVAL_FREEZE_MODEL)
    np.testing.assert_array_equal(frozen[1], jb)
    zero = tcv.grabCut(img, None, rect, None, None, 0, tcv.GC_INIT_WITH_RECT)
    want0 = jcv.grabCut(img, None, rect, None, None, 0, jcv.GC_INIT_WITH_RECT)
    np.testing.assert_array_equal(zero[0], want0[0])
    np.testing.assert_array_equal(zero[1], want0[1])


@pytest.mark.parametrize("seed", range(4))
def test_native_maxflow_equals_its_python_twin(seed):
    rng = np.random.default_rng(seed)
    H, W = 9 + seed, 13
    src = np.where(rng.random((H, W)) < 0.3, 0.0, rng.random((H, W)) * 5)
    snk = np.where(rng.random((H, W)) < 0.3, 0.0, rng.random((H, W)) * 5)
    links = [rng.random((H, W)) * 2 for _ in range(4)]
    links[0][:, 0] = links[1][0] = links[1][:, 0] = links[2][0] = 0
    links[3][0] = links[3][:, -1] = 0
    cut = native.maxflow_grid(src, snk, *links)
    np.testing.assert_array_equal(cut, G._py_maxflow(src, snk, *links))
    assert 0 < cut.sum() < H * W
