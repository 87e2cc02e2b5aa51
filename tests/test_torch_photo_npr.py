"""The port's domain-transform filters (edgePreservingFilter RECURS and
NORMCONV, detailEnhance, stylization, pencilSketch) on the CPU, against
opencv_tpu and cv2, on one (64, 80, 3) image.

The RF filter runs the JAX package's associative-scan tree op by op, so its
float32 output equals the JAX package's run under ``jax.disable_jit()``
exactly, once both take the power ``a^d`` correctly rounded (the JAX
package's float32 power is glibc's ``powf``, an ulp off on about 0.1% of
its inputs, and XLA's exp of the filter's constant is an ulp off at some
sigma: the test gives the JAX module a ``jnp`` whose ``power`` and ``exp``
round the float64 results, as the port does); against the jitted program,
whose multiply-adds XLA contracts, within RF_ATOL.  The NC filter takes its
domain-transform and running sums in float64 where the JAX package takes
XLA's float32 cumulative sums: its float32 output is within NC_ATOL of the
JAX package's (measured 3.0e-5), and its u8 results equal on U8_SHARE of
the pixels within 1 (measured: all equal but stylization's 2 pixels of
15,360, by 1), as detailEnhance's against the jitted program.  cv2's
bounds are tests/test_photo.py's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu.photo.npr as JN
import opencv_tpu_torch as tcv
import opencv_tpu_torch.photo.npr as TN
from torch_threads import _one_torch_thread  # noqa: F401

RF_ATOL = 2e-6
NC_ATOL = 1e-4
U8_SHARE = 0.999


@pytest.fixture(scope="module")
def img():
    rng = np.random.default_rng(0)
    return cv2.GaussianBlur(rng.integers(0, 256, (64, 80, 3), np.uint8), (5, 5), 2)


class _RoundedPower:
    """``jnp`` whose float32 power and exp round the float64 results, as the
    port takes them."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def power(a, b):
        a64, b64 = np.float64(np.asarray(a)), np.asarray(b, np.float64)
        return jnp.asarray(np.power(a64, b64).astype(np.float32))

    @staticmethod
    def exp(a):
        return jnp.asarray(np.exp(np.asarray(a, np.float64)).astype(np.float32))


@pytest.fixture
def rounded_power(monkeypatch):
    monkeypatch.setattr(JN, "jnp", _RoundedPower())


def _u8_close(got, want):
    got, want = np.asarray(got).astype(int), np.asarray(want).astype(int)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.max() <= 1 and (d == 0).mean() >= U8_SHARE, (d.max(), (d != 0).sum())


@pytest.mark.parametrize("sigma_s,sigma_r", [(60.0, 0.4), (20.0, 0.3)])
def test_rf_filter_equals_opencv_tpu_op_by_op(img, sigma_s, sigma_r, rounded_power):
    x, horiz, vert, _, _ = TN._prep(torch.from_numpy(img), sigma_s, sigma_r, False)
    got = TN._edge_preserving_rf(x, horiz, vert, sigma_s).numpy()
    with jax.disable_jit():
        jx, jh, jv, _, _ = JN._prep(img, sigma_s, sigma_r, False)
        np.testing.assert_array_equal(horiz.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(vert.numpy(), np.asarray(jv))
        want = np.asarray(JN._edge_preserving_rf(jx, jh, jv, sigma_s))
    np.testing.assert_array_equal(got, want)


def test_rf_filter_within_bound_of_the_jitted_program(img):
    x, horiz, vert, _, _ = TN._prep(torch.from_numpy(img), 60.0, 0.4, False)
    got = TN._edge_preserving_rf(x, horiz, vert, 60.0).numpy()
    jx, jh, jv, _, _ = JN._prep(img, 60.0, 0.4, False)
    want = np.asarray(JN._edge_preserving_rf(jx, jh, jv, 60.0))
    assert np.abs(got - want).max() <= RF_ATOL


def test_associative_scan_is_the_recurrence():
    """The scan's tree against the sequential recurrence, in float64, on
    every length from 1 to 37."""
    rng = np.random.default_rng(1)
    for n in range(1, 38):
        x = torch.from_numpy(rng.random((3, n, 2)))
        V = torch.from_numpy(rng.random((3, n)))
        y = TN._iir_scan(x, V)
        ref = x.clone()
        for j in range(1, n):
            ref[:, j] = V[:, j, None] * ref[:, j - 1] + (1 - V[:, j, None]) * x[:, j]
        np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=1e-12, atol=1e-12)


def test_nc_filter_within_bound_of_opencv_tpu(img):
    x, _, _, ct_H, ct_V = TN._prep(torch.from_numpy(img), 60.0, 0.4, True)
    got = TN._edge_preserving_nc(x, ct_H, ct_V, 60.0).numpy()
    jx, _, _, jH, jV = JN._prep(img, 60.0, 0.4, True)
    want = np.asarray(JN._edge_preserving_nc(jx, jH, jV, 60.0))
    assert np.abs(got - want).max() <= NC_ATOL
    np.testing.assert_allclose(ct_H.numpy(), np.asarray(jH), rtol=1e-6)


def test_recursive_filter_equals_opencv_tpu_op_by_op(img, rounded_power):
    got = tcv.edgePreservingFilter(torch.from_numpy(img), flags=tcv.RECURS_FILTER)
    assert got.dtype == torch.uint8
    with jax.disable_jit():
        want = jcv.edgePreservingFilter(img, flags=tcv.RECURS_FILTER)
    np.testing.assert_array_equal(got.numpy(), want)


def test_normconv_filter_and_detail_enhance_equal_opencv_tpu(img):
    got = tcv.edgePreservingFilter(torch.from_numpy(img), flags=tcv.NORMCONV_FILTER)
    _u8_close(got.numpy(), jcv.edgePreservingFilter(img, flags=tcv.NORMCONV_FILTER))
    got = tcv.detailEnhance(torch.from_numpy(img), sigma_s=10, sigma_r=0.15)
    _u8_close(got.numpy(), jcv.detailEnhance(img, sigma_s=10, sigma_r=0.15))


def test_stylization_and_pencil_sketch_equal_opencv_tpu(img):
    _u8_close(tcv.stylization(torch.from_numpy(img)).numpy(), jcv.stylization(img))
    s, c = tcv.pencilSketch(torch.from_numpy(img))
    js, jc = jcv.pencilSketch(img)
    _u8_close(s.numpy(), js)
    _u8_close(c.numpy(), jc)


def test_npr_filters_match_cv2(img):
    """tests/test_photo.py's bounds against cv2."""
    t = torch.from_numpy(img)

    def d(a, b):
        return np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int)).max()

    for flags in (1, 2):
        ref = cv2.edgePreservingFilter(img, flags=flags, sigma_s=60, sigma_r=0.4)
        assert d(ref, tcv.edgePreservingFilter(t, flags=flags, sigma_s=60, sigma_r=0.4)) <= 1
    ref = cv2.stylization(img, sigma_s=60, sigma_r=0.45)
    assert d(ref, tcv.stylization(t, sigma_s=60, sigma_r=0.45)) <= 1
    ref = cv2.detailEnhance(img, sigma_s=10, sigma_r=0.15)
    assert d(ref, tcv.detailEnhance(t, sigma_s=10, sigma_r=0.15)) <= 3
    r1, r2 = cv2.pencilSketch(img, sigma_s=60, sigma_r=0.07, shade_factor=0.02)
    o1, o2 = tcv.pencilSketch(t, sigma_s=60, sigma_r=0.07, shade_factor=0.02)
    assert d(r1, o1) <= 1 and d(r2, o2) <= 1
