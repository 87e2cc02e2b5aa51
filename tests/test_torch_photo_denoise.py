"""The port's NL-means and TV-L1 denoising on the CPU, against opencv_tpu
and cv2.

The port takes NL-means' patch distances as exact box sums (separable
int32 window sums of u8 input); the JAX package takes float32 prefix sums
over the whole padded plane.  Where those float32 sums are exact (every prefix under
2^24, which the tests assert of their data), the two are equal on
EQUAL_SHARE of the pixels (measured: all; the weights' exp, XLA's float32
one against the port's float64 one rounded, may differ by an ulp).  On
full-range data the port's distances equal an int64 numpy reference and
the JAX package's float32 ones differ from it: the divergence ROADMAP
queue C records.  TV-L1 is the JAX package's float64 solver, exactly."""

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
from opencv_tpu.photo.denoise import _box_sum_f32
import opencv_tpu_torch as tcv
from opencv_tpu_torch.photo.denoise import patch_distances
from torch_threads import _one_torch_thread  # noqa: F401

SHAPE = (48, 64)
EQUAL_SHARE = 1.0


def _low_range(seed, shape=SHAPE, hi=31):
    """Values in 0..hi-1: every float32 prefix of the squared differences
    stays an exact integer."""
    return np.random.default_rng(seed).integers(0, hi, shape).astype(np.uint8)


def _max_prefix(planes, tw, sw):
    """The largest prefix sum the JAX package's float32 box sums take over
    `planes` (2-D u8, the first the one denoised): the whole padded plane's
    squared differences at the worst offset."""
    pad = tw // 2 + sw // 2
    sr = sw // 2
    H, W = planes[0].shape
    c = np.pad(planes[0].astype(np.int64), pad, mode="symmetric")
    c = c[sr:sr + H + 2 * (tw // 2), sr:sr + W + 2 * (tw // 2)]
    best = 0
    for f in planes:
        p = np.pad(f.astype(np.int64), pad, mode="symmetric")
        for dy in range(-sr, sr + 1):
            for dx in range(-sr, sr + 1):
                nb = p[sr + dy:sr + dy + c.shape[0], sr + dx:sr + dx + c.shape[1]]
                best = max(best, int(((c - nb) ** 2).sum()))
    return best


def _assert_equal_share(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert (got == want).mean() >= EQUAL_SHARE, (got != want).sum()


@pytest.mark.parametrize("h,sw", [(3, 11), (10, 11), (4, 21)])
def test_nl_means_equals_opencv_tpu_where_its_sums_are_exact(h, sw):
    x = _low_range(0)
    assert _max_prefix([x], 7, sw) < 2 ** 24
    got = tcv.fastNlMeansDenoising(torch.from_numpy(x), h, 7, sw)
    _assert_equal_share(got.numpy(), jcv.fastNlMeansDenoising(x, h, 7, sw))


def test_nl_means_multi_equals_opencv_tpu():
    frames = [_low_range(s) for s in (1, 2, 3)]
    assert _max_prefix([frames[1], *frames], 7, 7) < 2 ** 24
    got = tcv.fastNlMeansDenoisingMulti([torch.from_numpy(f) for f in frames], 1, 3, 6, 7, 7)
    _assert_equal_share(got.numpy(), jcv.fastNlMeansDenoisingMulti(frames, 1, 3, 6, 7, 7))


def _low_range_bgr(seed):
    """A dark BGR image whose u8 Lab planes keep the float32 sums exact."""
    return _low_range(seed, (*SHAPE, 3), 24)


def _lab_planes(img):
    lab = cv2.cvtColor(img, cv2.COLOR_BGR2Lab)
    return [lab[..., c] for c in range(3)]


def test_nl_means_colored_equals_opencv_tpu():
    img = _low_range_bgr(4)
    assert max(_max_prefix([p], 7, 7) for p in _lab_planes(img)) < 2 ** 24
    got = tcv.fastNlMeansDenoisingColored(torch.from_numpy(img), 5, 4, 7, 7)
    _assert_equal_share(got.numpy(), jcv.fastNlMeansDenoisingColored(img, 5, 4, 7, 7))


def test_nl_means_colored_multi_equals_opencv_tpu():
    imgs = [_low_range_bgr(s) for s in (5, 6, 7)]
    for c in range(3):
        planes = [_lab_planes(i)[c] for i in imgs]
        assert _max_prefix([planes[1], *planes], 5, 7) < 2 ** 24
    got = tcv.fastNlMeansDenoisingColoredMulti([torch.from_numpy(i) for i in imgs], 1, 3, 4, 4,
                                               5, 7)
    _assert_equal_share(got.numpy(),
                        jcv.fastNlMeansDenoisingColoredMulti(imgs, 1, 3, 4, 4, 5, 7))


@pytest.mark.parametrize("offset", [(0, 1), (3, -2), (-10, 10)])
def test_patch_distances_are_exact_where_float32_sums_are_not(offset):
    """Full-range planes: the port's d2 equals the int64 box sums of numpy,
    and the JAX package's float32 box sums of its float32 prefix sums do
    not (the prefix sums reach 7.0e8 here)."""
    rng = np.random.default_rng(8)
    H, W, tw = 200, 320, 7
    a = rng.integers(0, 256, (1, H, W, 1), np.uint8)
    dy, dx = offset
    b = np.roll(a, (dy, dx), axis=(1, 2))
    got = patch_distances(torch.from_numpy(a), torch.from_numpy(b), tw).numpy()
    sq = (a.astype(np.int64) - b.astype(np.int64)) ** 2
    c = np.pad(sq[0, ..., 0].cumsum(0).cumsum(1), ((1, 0), (1, 0)))
    ref = c[tw:, tw:] - c[tw:, :-tw] - c[:-tw, tw:] + c[:-tw, :-tw]
    assert ref.max() < 2 ** 24 and c.max() > 5e8
    np.testing.assert_array_equal(got[0, ..., 0], ref.astype(np.float32))
    jax_d2 = np.asarray(_box_sum_f32(sq.astype(np.float32), tw))[0, ..., 0]
    assert (jax_d2 != ref).mean() > 0.5 and np.abs(jax_d2 - ref).max() > 100


def test_patch_distances_of_float_planes_take_float64_sums():
    rng = np.random.default_rng(9)
    a = rng.random((1, 40, 50, 3)).astype(np.float32) * 255
    b = rng.random((1, 40, 50, 3)).astype(np.float32) * 255
    got = patch_distances(torch.from_numpy(a), torch.from_numpy(b), 5).numpy()[0, ..., 0]
    sq = ((a.astype(np.float64) - b) ** 2).sum(-1)[0]
    ref = np.lib.stride_tricks.sliding_window_view(sq, (5, 5)).sum((-1, -2))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def _psnr(a, b):
    mse = np.mean((a.astype(float) - b.astype(float)) ** 2)
    return 10 * np.log10(255 ** 2 / max(mse, 1e-9))


def test_nl_means_denoises_like_cv2():
    """tests/test_photo.py's bound: better than the noisy image by 1 dB and
    within 3 dB of cv2's PSNR."""
    rng = np.random.default_rng(0)
    clean = cv2.GaussianBlur(rng.integers(0, 256, (64, 64), np.uint8), (7, 7), 3)
    noisy = np.clip(clean.astype(int) + rng.normal(0, 15, clean.shape), 0,
                    255).astype(np.uint8)
    ref = cv2.fastNlMeansDenoising(noisy, None, 10)
    ours = tcv.fastNlMeansDenoising(torch.from_numpy(noisy), 10).numpy()
    assert _psnr(ours, clean) > _psnr(noisy, clean) + 1.0
    assert _psnr(ours, clean) > _psnr(ref, clean) - 3.0


@pytest.mark.parametrize("n_obs,lam,iters", [(1, 1.0, 30), (3, 0.7, 12)])
def test_denoise_tvl1_equals_opencv_tpu(n_obs, lam, iters):
    rng = np.random.default_rng(10 + n_obs)
    base = cv2.GaussianBlur(rng.integers(0, 256, SHAPE, np.uint8), (5, 5), 2)
    obs = [np.clip(base + rng.normal(0, 20, SHAPE), 0, 255).astype(np.uint8)
           for _ in range(n_obs)]
    got = tcv.denoise_TVL1([torch.from_numpy(o) for o in obs], None, lam, iters)
    want = jcv.denoise_TVL1(obs, None, lam, iters)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
