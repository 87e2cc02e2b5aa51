"""The port's AKAZE (``opencv_tpu_torch.features2d.akaze``) on the CPU
against ``opencv_tpu``'s.

Exact where the JAX package computes eagerly: the FED step sizes, the
derivative kernels, the Gaussian, the Scharr pair, the separable filter,
the contrast factor, the MLDB grids; and, with ``jax.disable_jit()`` (its
FED scan then runs step by step), its whole scale space, keypoints and
descriptors.  The JAX package jits the conductivity, the FED steps and the
Hessian, and XLA contracts their multiply-adds into fused ones, so against
its jitted program the port is held to the bound ROADMAP.md queue C
states (measured at 120×160 on two pan images and the tracking path's
three frames: levels within 1.2e-6 of each level's largest value, every
keypoint at the same level within 1.6e-5 px, angles within 5.8e-6°, every
MLDB descriptor identical):

- every level (Lt, Lx, Ly, Ldet) within LEVEL_RTOL of its largest |value|;
- at least KP_SHARE of each side's keypoints found on the other at the same
  class_id within KP_TOL px, angles within ANGLE_TOL degrees, sizes within
  a relative KP_TOL;
- at least KP_SHARE of the matched descriptors identical."""

import math

import jax
import numpy as np
import pytest
import torch

import opencv_tpu as jcv
from opencv_tpu.features2d import akaze as ja
import opencv_tpu_torch as tcv
from opencv_tpu_torch.features2d import akaze as ta
from opencv_tpu_torch import entry as E

LEVEL_RTOL = 2e-5
KP_SHARE = 0.99
KP_TOL = 1e-3
ANGLE_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for a module's many small torch ops (the files
    of the tracking slice import this fixture): the suite runs several
    test processes at once, and each op's thread pool would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gray(shape, seed=0):
    video, _ = E.make_pan_video((1, *shape, 3), seed)
    return tcv.cvtColor(torch.from_numpy(video), tcv.COLOR_BGR2GRAY)[0, ..., 0].numpy()


def matched(a, b, tol=KP_TOL):
    """For each keypoint of a, the index of b's at the same class_id within
    tol px, or -1."""
    by = {}
    for j, k in enumerate(b):
        by.setdefault(k.class_id, []).append(j)
    out = []
    for k in a:
        hit = [j for j in by.get(k.class_id, [])
               if max(abs(b[j].pt[0] - k.pt[0]), abs(b[j].pt[1] - k.pt[1])) <= tol]
        out.append(hit[0] if hit else -1)
    return out


def assert_within_bound(got, want, compare_desc):
    """The keypoint and descriptor part of the stated bound."""
    (gk, gd), (wk, wd) = got, want
    fwd, back = matched(gk, wk), matched(wk, gk)
    assert sum(j >= 0 for j in fwd) >= KP_SHARE * len(gk)
    assert sum(j >= 0 for j in back) >= KP_SHARE * len(wk)
    pairs = [(i, j) for i, j in enumerate(fwd) if j >= 0]
    assert all(abs(gk[i].angle - wk[j].angle) <= ANGLE_TOL for i, j in pairs)
    assert all(abs(gk[i].size - wk[j].size) <= KP_TOL * wk[j].size
               and gk[i].octave == wk[j].octave for i, j in pairs)
    assert compare_desc(gd, wd, pairs)


def same_mldb(gd, wd, pairs):
    return sum(np.array_equal(gd[i], wd[j]) for i, j in pairs) >= KP_SHARE * len(pairs)


def exact(got, want):
    (gk, gd), (wk, wd) = got, want
    assert [(k.pt, k.size, k.angle, k.response, k.octave, k.class_id) for k in gk] == \
        [(k.pt, k.size, k.angle, k.response, k.octave, k.class_id) for k in wk]
    assert gd.dtype == wd.dtype
    np.testing.assert_array_equal(gd, wd)


@pytest.fixture(scope="module")
def img():
    return gray((120, 160))


@pytest.fixture(scope="module")
def imgs():
    return np.stack([gray((48, 64), 1), gray((48, 64), 2)])


def test_fed_tau_and_tables_equal_opencv_tpu():
    for T in (0.3, 1.0, 2.56, 7.3, 67.2, 231.0):
        for reorder in (True, False):
            assert ta._fed_tau(T, reordering=reorder) == ja._fed_tau(T, reordering=reorder)
    assert [ta._is_prime(m) for m in range(200)] == [ja._is_prime(m) for m in range(200)]
    for order in (0, 1):
        for scale in (1, 2, 3, 4, 7):
            for a, b in zip(ta._deriv_kernels(order, scale), ja._deriv_kernels(order, scale)):
                np.testing.assert_array_equal(a, b)
    for lvl_t, lvl_j in zip(ta._MLDB_GRIDS, ja._MLDB_GRIDS):
        assert len(lvl_t) == len(lvl_j)
        for (ks, ls), (kj, lj) in zip(lvl_t, lvl_j):
            np.testing.assert_array_equal(ks, kj)
            np.testing.assert_array_equal(ls, lj)
    for name in ("_OX", "_OY", "_OW"):
        np.testing.assert_array_equal(getattr(ta, name), getattr(ja, name))
    assert [ta._gauss_ksize(s) for s in (1.0, 1.6, 2.5)] == [ja._gauss_ksize(s) for s in
                                                            (1.0, 1.6, 2.5)]


def test_dense_kernels_equal_opencv_tpu_eager(imgs):
    """The Gaussian, the Scharr pair and the scale-adapted derivatives of
    each image equal the JAX package's eager functions exactly."""
    x = torch.from_numpy(imgs.astype(np.float32) / np.float32(255))
    for b in range(2):
        xb = imgs[b].astype(np.float32) / np.float32(255)
        for sigma, k in ((1.6, None), (1.0, 5)):
            np.testing.assert_array_equal(ta._gaussian(x, sigma, k)[b].numpy(),
                                          np.asarray(ja._gaussian(xb, sigma, k)))
        for got, want in zip(ta._scharr(x), ja._scharr(xb[None])):
            np.testing.assert_array_equal(got[b].numpy(), np.asarray(want)[0])
        for order in (0, 1):
            for scale in (1, 3, 4):
                kx, ky = ta._deriv_kernels(order, scale)
                np.testing.assert_array_equal(ta._sep_filter(x, kx, ky)[b].numpy(),
                                              np.asarray(ja._sep_filter(xb[None], kx, ky))[0])


def test_jitted_parts_equal_opencv_tpu_eager(imgs):
    """The conductivity (PM_G2), the FED cycle and the Hessian equal the JAX
    package's functions run eagerly; the other conductivities within 1e-6
    (exp and sqrt are each library's)."""
    x = torch.from_numpy(imgs.astype(np.float32) / np.float32(255))
    Lx, Ly = ta._scharr(ta._gaussian(x, 1.0, 5))
    ks = [0.021, 0.043]
    taus = ta._fed_tau(2.3)
    for b in range(2):
        lx, ly = jax.numpy.asarray(Lx[b].numpy()), jax.numpy.asarray(Ly[b].numpy())
        for kind in range(4):
            got = ta._diffusivity(Lx, Ly, ks, kind)[b].numpy()
            want = np.asarray(ja._diffusivity.__wrapped__(lx, ly, np.float32(ks[b]), kind))
            if kind == ta.DIFF_PM_G2:
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        c = ta._diffusivity(Lx, Ly, ks, ta.DIFF_PM_G2)
        with jax.disable_jit():
            want = ja._nld_steps(jax.numpy.asarray(x[b].numpy()), jax.numpy.asarray(c[b].numpy()),
                                 jax.numpy.asarray(taus, jax.numpy.float32))
        np.testing.assert_array_equal(ta._nld_steps(x, c, taus)[b].numpy(), np.asarray(want))
        for s in (2, 3):
            got = ta._hessian_response(x, s)
            want = ja._hessian_response.__wrapped__(jax.numpy.asarray(x[b].numpy())[None], s)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g[b].numpy(), np.asarray(w)[0])


def test_kcontrast_equals_opencv_tpu(imgs):
    """Each image's contrast factor, from the device histogram over the
    host's bin thresholds, equals the JAX package's numpy exactly; and so
    does a flat image's fallback."""
    x = np.concatenate([imgs, np.full((1, 48, 64), 77, np.uint8)])
    xf = x.astype(np.float32) / np.float32(255)
    got = ta.compute_kcontrast(torch.from_numpy(xf))
    assert got == [ja._compute_kcontrast(im) for im in xf]
    assert got[2] == 0.03


def test_bin_thresholds_match_the_bins():
    """A value's bin is the count of thresholds at or below it, for every
    value around each threshold."""
    hmax, nbins = 0.8731, 300
    t = ta._bin_thresholds(hmax, nbins, np.float32(hmax * hmax))
    assert np.all(np.diff(t) >= 0)
    v = np.concatenate([t, np.nextafter(t, np.float32(0)), np.nextafter(t, np.float32(1))])
    v = v[(v > 0) & np.isfinite(v)].astype(np.float32)
    want = np.minimum((nbins * (np.sqrt(v) / hmax)).astype(np.int64), nbins - 1)
    np.testing.assert_array_equal(np.searchsorted(t, v, side="right"), want)


def test_area_resize_equals_resize():
    """The fixed-order INTER_AREA of the octave steps: an integer ratio is
    ``resize``'s exact mean; a fractional one (135 → 67 rows) agrees with
    the JAX package's matrix product to float32 rounding."""
    rng = np.random.default_rng(0)
    x = rng.random((2, 135, 240), np.float32)
    got = ta.area_resize(torch.from_numpy(x), 120, 67).numpy()
    for b in range(2):
        want = np.asarray(jcv.resize(x[b], (120, 67), interpolation=jcv.INTER_AREA))
        np.testing.assert_allclose(got[b], want, rtol=0, atol=1e-6)
    got = ta.area_resize(torch.from_numpy(x[:, :134]), 120, 67).numpy()
    np.testing.assert_array_equal(
        got[1], np.asarray(jcv.resize(x[1, :134], (120, 67), interpolation=jcv.INTER_AREA)))


def test_pipeline_equals_opencv_tpu_eager(img):
    """With jit disabled the JAX package's arithmetic is the port's: its
    scale space (one octave), keypoints and descriptors equal exactly."""
    im = img
    ref = ja.AKAZE_create(threshold=0.0005, nOctaves=1)
    with jax.disable_jit():
        want_levels = ref._scale_space(im.astype(np.float32) / np.float32(255))
    # the rest of the JAX package's detectAndCompute on those levels
    want = ref._describe(want_levels, ref._refine(want_levels, ref._detect_levels(want_levels)))
    got_levels = ta.AKAZE_create(threshold=0.0005, nOctaves=1).scale_space(
        ta.to_float_image(torch.from_numpy(im)[None]))
    assert len(got_levels) == len(want_levels) == 4
    for g, w in zip(got_levels, want_levels):
        for key in ("Lt", "Lx", "Ly", "Ldet"):
            np.testing.assert_array_equal(g[key][0].numpy(), w[key])
    got = tcv.AKAZE_create(threshold=0.0005, nOctaves=1).detectAndCompute(im)
    assert len(got[0]) > 10
    exact(got, want)


@pytest.fixture(scope="module")
def jitted(img):
    """The JAX package's jitted AKAZE at 120×160: levels, MLDB and upright."""
    levels = ja.AKAZE_create()._scale_space(img.astype(np.float32) / np.float32(255))
    out = [levels]
    for ak in (ja.AKAZE_create(), ja.AKAZE_create(descriptor_type=ja.DESCRIPTOR_MLDB_UPRIGHT)):
        # detectAndCompute's steps on the one scale space
        out.append(ak._describe(levels, ak._refine(levels, ak._detect_levels(levels))))
    return out


def test_levels_within_bound(img, jitted):
    got = ta.AKAZE_create().scale_space(ta.to_float_image(torch.from_numpy(img)[None]))
    assert len(got) == len(jitted[0]) == 8
    for g, w in zip(got, jitted[0]):
        for key in ("Lt", "Lx", "Ly", "Ldet"):
            ref = w[key]
            assert g[key].dtype == torch.float32 and g[key].shape[1:] == ref.shape
            np.testing.assert_allclose(g[key][0].numpy(), ref, rtol=0,
                                       atol=LEVEL_RTOL * float(np.abs(ref).max()))


def test_detect_and_compute_within_bound(img, jitted):
    got = tcv.AKAZE_create().detectAndCompute(img)
    assert len(got[0]) > 50 and got[1].shape == (len(got[0]), 61) and got[1].dtype == np.uint8
    assert_within_bound(got, jitted[1], same_mldb)
    # detect, then compute, give detectAndCompute's result
    ak = tcv.AKAZE_create()
    kps = ak.detect(img)
    assert all(k.angle == 0.0 for k in kps)
    exact(ak.compute(img, kps), got)
    # a mask keeps the keypoints inside it
    mask = np.zeros(img.shape, np.uint8)
    mask[:60] = 1
    masked = ak.detect(img, mask)
    assert 0 < len(masked) < len(kps) and all(k.pt[1] < 60 for k in masked)


def test_upright_within_bound(img, jitted):
    got = tcv.AKAZE_create(descriptor_type=tcv.AKAZE_DESCRIPTOR_MLDB_UPRIGHT).detectAndCompute(img)
    assert all(k.angle == 0.0 for k in got[0])
    assert_within_bound(got, jitted[2], same_mldb)


def test_batch_equals_per_image(img):
    """The batch runs the dense part of all images together; each image's
    result equals its own detectAndCompute exactly."""
    batch = np.stack([img, img[:, ::-1].copy(), np.full_like(img, 128)])
    ak = tcv.AKAZE_create(descriptor_channels=2)
    out = ak.detect_and_compute_batch(torch.from_numpy(batch))
    for im, got in zip(batch, out):
        exact(got, ak.detectAndCompute(im))
    assert len(out[2][0]) == 0 and out[2][1].shape == (0, ak.descriptorSize())
    assert out[0][1].shape[1] == ak.descriptorSize() == 41


@pytest.mark.parametrize("args", [(), (ja.DESCRIPTOR_KAZE, 0, 3, 0.002, 3, 2, ja.DIFF_PM_G1),
                                  (ja.DESCRIPTOR_MLDB_UPRIGHT, 0, 1)])
def test_getters_equal_opencv_tpu(args):
    t, j = tcv.AKAZE_create(*args), jcv.AKAZE_create(*args)
    for name in ("getThreshold", "getNOctaves", "getNOctaveLayers", "getDiffusivity",
                 "getDescriptorType", "getDescriptorSize", "getDescriptorChannels",
                 "descriptorSize", "descriptorType", "defaultNorm"):
        assert getattr(t, name)() == getattr(j, name)(), name
    t.setThreshold(0.01)
    assert t.getThreshold() == 0.01
    assert t._evolution_plan(540, 960) == j._evolution_plan(540, 960)
    assert math.isclose(t.soffset, 1.6) and t.derivative_factor == 1.5


def test_constants_equal_opencv_tpu():
    for name in ("AKAZE_DESCRIPTOR_KAZE_UPRIGHT", "AKAZE_DESCRIPTOR_KAZE",
                 "AKAZE_DESCRIPTOR_MLDB_UPRIGHT", "AKAZE_DESCRIPTOR_MLDB", "KAZE_DIFF_PM_G1",
                 "KAZE_DIFF_PM_G2", "KAZE_DIFF_WEICKERT", "KAZE_DIFF_CHARBONNIER"):
        assert getattr(tcv, name) == getattr(jcv, name), name
    for name in ("DESCRIPTOR_MLDB", "DIFF_PM_G2", "DIFF_WEICKERT"):
        assert getattr(ta, name) == getattr(ja, name)
