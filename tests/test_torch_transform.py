"""opencv_tpu_torch's transform module (dft/idft, dct/idct, mulSpectrums,
getOptimalDFTSize, getGaborKernel, the accumulate family) vs opencv_tpu and
the cv2 oracle, on the CPU.

Tolerances: f32 spectra within 1e-5 of the plane's largest magnitude of
opencv_tpu's (torch.fft and XLA's FFT round differently) and within the
reference test's 1e-3 of cv2; the DCT within rtol 1e-5 of the plane's
largest value of ``jax.scipy.fft.dct`` (through opencv_tpu) and 1e-4 of cv2;
getOptimalDFTSize, getGaborKernel and the accumulate family ``array_equal``
(the accumulators in f32, the JAX package's expression order); the complex
mulSpectrums within 1e-6 of the largest magnitude (XLA may fuse the
multiply-adds).  Deliberate divergences, held to cv2: f64 input stays f64
through the DFT, the DCT and an f64 accumulator (opencv_tpu: f32);
DFT_ROWS packs each row of a real input in CCS, and its inverse unpacks
each row (opencv_tpu: the complex spectrum); mulSpectrums of two CCS arrays
packs their product (opencv_tpu: a complex array)."""

import numpy as np
import pytest
import torch

from common import cv2

import jax.scipy.fft as jfft

import opencv_tpu as jcv
import opencv_tpu_torch as tcv


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close_to_max(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(1.0, np.abs(want).max())


CCS_SHAPES = [(4, 6), (5, 6), (4, 7), (5, 7), (8, 8), (1, 8), (1, 7), (8, 1), (7, 1), (9, 9),
              (6, 9)]


@pytest.mark.parametrize("shape", CCS_SHAPES)
def test_dft_ccs_packing(shape):
    a = np.random.default_rng(7).random(shape).astype(np.float32)
    got = tcv.dft(_t(a))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    _close_to_max(got, jcv.dft(a), 1e-5)
    ref = cv2.dft(a)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3)
    flags = tcv.DFT_SCALE | tcv.DFT_REAL_OUTPUT
    back = tcv.idft(got, flags)
    _close_to_max(back, jcv.idft(np.asarray(jcv.dft(a)), flags), 1e-5)
    np.testing.assert_allclose(back.numpy(), cv2.idft(ref, flags=flags), atol=1e-4)
    np.testing.assert_allclose(back.numpy(), a, atol=1e-4)
    # unnormalised inverse without DFT_SCALE, as cv2's
    np.testing.assert_allclose(tcv.idft(got).numpy(), cv2.idft(ref), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("shape", [(16, 24), (5, 7)])
def test_dft_complex_output_and_input(shape):
    rng = np.random.default_rng(14)
    x = rng.random(shape).astype(np.float32)
    got = tcv.dft(x, tcv.DFT_COMPLEX_OUTPUT)
    _close_to_max(got, jcv.dft(x, jcv.DFT_COMPLEX_OUTPUT), 1e-5)
    np.testing.assert_allclose(got.numpy(), cv2.dft(x, flags=cv2.DFT_COMPLEX_OUTPUT), atol=1e-3)
    back = tcv.idft(got, tcv.DFT_SCALE | tcv.DFT_REAL_OUTPUT)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-5)
    c = rng.random((*shape, 2)).astype(np.float32)
    for flags in (0, tcv.DFT_SCALE, tcv.DFT_ROWS):
        _close_to_max(tcv.dft(c, flags), jcv.dft(c, flags), 1e-5)
        np.testing.assert_allclose(tcv.dft(c, flags).numpy(), cv2.dft(c, flags=flags),
                                   rtol=1e-5, atol=1e-4)
        _close_to_max(tcv.idft(c, flags), jcv.idft(c, flags), 1e-5)
        np.testing.assert_allclose(tcv.idft(c, flags).numpy(), cv2.idft(c, flags=flags),
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", [(5, 7), (4, 6), (3, 8)])
def test_dft_rows_packs_each_row_as_cv2(shape):
    """A divergence from opencv_tpu, which returns the (M, N, 2) complex
    spectrum of each row here."""
    a = np.random.default_rng(8).random(shape).astype(np.float32)
    got = tcv.dft(a, tcv.DFT_ROWS)
    ref = cv2.dft(a, flags=cv2.DFT_ROWS)
    assert tuple(got.shape) == ref.shape == shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    assert np.asarray(jcv.dft(a, jcv.DFT_ROWS)).shape == (*shape, 2)
    flags = tcv.DFT_ROWS | tcv.DFT_SCALE
    np.testing.assert_allclose(tcv.idft(got, flags).numpy(), cv2.idft(ref, flags=flags),
                               atol=1e-5)
    np.testing.assert_allclose(tcv.idft(got, flags).numpy(), a, atol=1e-5)


def test_dft_f64_stays_f64():
    """A divergence from opencv_tpu (complex64 and an f32 result): f64 goes
    through complex128, as cv2 computes it."""
    a = np.random.default_rng(9).random((12, 10))
    got = tcv.dft(_t(a))
    assert got.dtype == torch.float64
    assert np.asarray(jcv.dft(a)).dtype == np.float32
    ref = cv2.dft(a)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    back = tcv.idft(got, tcv.DFT_SCALE | tcv.DFT_REAL_OUTPUT)
    assert back.dtype == torch.float64
    np.testing.assert_allclose(back.numpy(), a, atol=1e-13)
    # where the f32 result of opencv_tpu is off cv2 by far more than f64's
    assert np.abs(np.asarray(jcv.dft(a), np.float64) - ref).max() > 1e-9
    c = tcv.dft(a, tcv.DFT_COMPLEX_OUTPUT)
    np.testing.assert_allclose(c.numpy(), cv2.dft(a, flags=cv2.DFT_COMPLEX_OUTPUT), atol=1e-12)


@pytest.mark.parametrize("shape,flags", [((16, 16), 0), ((10, 14), 0), ((9, 7), 0),
                                         ((8, 12), 4), ((7, 5), 4), ((1, 6), 0)])
def test_dct_equals_jax_scipy(shape, flags):
    x = np.random.default_rng(15).random(shape).astype(np.float32)
    got = tcv.dct(_t(x), flags)
    assert got.dtype == torch.float32
    want = np.asarray(jcv.dct(x, flags))
    _close_to_max(got, want, 1e-5)
    axes = [-1] if flags & tcv.DCT_ROWS else [-2, -1]
    direct = x
    for ax in axes:
        direct = np.asarray(jfft.dct(direct, type=2, axis=ax, norm="ortho"))
    _close_to_max(got, direct, 1e-5)
    back = tcv.idct(got, flags)
    _close_to_max(back, jcv.idct(want, flags), 1e-5)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-5)
    if shape[0] % 2 == 0 and shape[1] % 2 == 0 or shape[0] == 1:
        np.testing.assert_allclose(got.numpy(), cv2.dct(x, flags=flags), atol=1e-4)


def test_dct_f64_stays_f64():
    """A divergence from opencv_tpu (an f32 result): f64 DCT in f64, as cv2."""
    x = np.random.default_rng(16).random((10, 14))
    got = tcv.dct(x)
    assert got.dtype == torch.float64 and np.asarray(jcv.dct(x)).dtype == np.float32
    np.testing.assert_allclose(got.numpy(), cv2.dct(x), atol=1e-13)
    np.testing.assert_allclose(tcv.idct(got).numpy(), x, atol=1e-13)
    np.testing.assert_allclose(tcv.dct(x, tcv.DCT_ROWS).numpy(), cv2.dct(x, flags=cv2.DCT_ROWS),
                               atol=1e-13)


@pytest.mark.parametrize("conj", [False, True])
def test_mul_spectrums_complex(conj):
    rng = np.random.default_rng(16)
    a = rng.random((8, 8, 2)).astype(np.float32)
    b = rng.random((8, 8, 2)).astype(np.float32)
    got = tcv.mulSpectrums(_t(a), _t(b), 0, conjB=conj)
    _close_to_max(got, jcv.mulSpectrums(a, b, 0, conjB=conj), 1e-6)
    np.testing.assert_allclose(got.numpy(), cv2.mulSpectrums(a, b, 0, conjB=conj), atol=1e-5)


@pytest.mark.parametrize("shape,flags", [((6, 8), 0), ((5, 7), 0), ((4, 7), 0), ((5, 6), 4)])
@pytest.mark.parametrize("conj", [False, True])
def test_mul_spectrums_ccs(shape, flags, conj):
    """A divergence from opencv_tpu, which multiplies a CCS array as a real
    one and returns a complex array: the port multiplies the spectra and
    packs the product, as cv2."""
    rng = np.random.default_rng(17)
    fa = cv2.dft(rng.random(shape).astype(np.float32), flags=flags)
    fb = cv2.dft(rng.random(shape).astype(np.float32), flags=flags)
    got = tcv.mulSpectrums(fa, fb, flags, conjB=conj)
    ref = cv2.mulSpectrums(fa, fb, flags, conjB=conj)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4 * np.abs(ref).max())
    assert np.asarray(jcv.mulSpectrums(fa, fb, flags, conjB=conj)).shape == (*shape, 2)


def test_optimal_dft_size_and_gabor():
    for n in [0, 1, 7, 13, 100, 255, 256, 1000, 1081, 1919]:
        assert tcv.getOptimalDFTSize(n) == jcv.getOptimalDFTSize(n)
        if n > 0:
            assert tcv.getOptimalDFTSize(n) == cv2.getOptimalDFTSize(n)
    for args in [((21, 21), 4.0, 0.5, 10.0, 0.5, 1.0), ((0, 0), 3.0, 1.2, 8.0, 0.7)]:
        got = tcv.getGaborKernel(*args)
        np.testing.assert_array_equal(got, jcv.getGaborKernel(*args))
        np.testing.assert_allclose(got, cv2.getGaborKernel(*args), atol=1e-10)


def _acc_inputs(seed, shape=(16, 16)):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, shape, np.uint8)
    src2 = rng.integers(0, 256, shape, np.uint8)
    dst = rng.random(shape).astype(np.float32) * 10
    mask = (rng.random(shape[:2]) > 0.5).astype(np.uint8)
    return src, src2, dst, mask


@pytest.mark.parametrize("shape", [(16, 16), (12, 20, 3)])
@pytest.mark.parametrize("masked", [False, True])
def test_accumulate_family_bit_equal(shape, masked):
    src, src2, dst, mask = _acc_inputs(17, shape)
    m = mask if masked else None
    cases = (("accumulate", (src, dst), {}, (src, None)),
             ("accumulateSquare", (src, dst), {}, (src, None)),
             ("accumulateProduct", (src, src2, dst), {}, (src, src2)),
             ("accumulateWeighted", (src, dst, 0.3), {}, (src, None)))
    for name, args, kw, _ in cases:
        got = getattr(tcv, name)(*[_t(a) if isinstance(a, np.ndarray) else a for a in args],
                                 mask=None if m is None else _t(m))
        want = np.asarray(getattr(jcv, name)(*args, mask=m))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        ref = dst.copy()
        getattr(cv2, name)(*args[:-1] if name != "accumulateWeighted" else (src,), ref,
                           *((0.3,) if name == "accumulateWeighted" else ()), mask=m)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, err_msg=name)


def test_accumulate_weighted_f64_accumulator():
    """A divergence from opencv_tpu, which computes in f32 (JAX without
    64-bit mode): an f64 accumulator stays f64, as cv2's."""
    src, _, dst, _ = _acc_inputs(18)
    d64 = dst.astype(np.float64)
    got = tcv.accumulateWeighted(src, _t(d64), 0.05)
    assert got.dtype == torch.float64
    assert np.asarray(jcv.accumulateWeighted(src, d64, 0.05)).dtype == np.float32
    ref = d64.copy()
    cv2.accumulateWeighted(src, ref, 0.05)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-12)


def test_public_surface_transform():
    for name in ("dft", "idft", "dct", "idct", "mulSpectrums", "getOptimalDFTSize",
                 "getGaborKernel", "accumulate", "accumulateSquare", "accumulateProduct",
                 "accumulateWeighted", "DFT_INVERSE", "DFT_SCALE", "DFT_ROWS",
                 "DFT_COMPLEX_OUTPUT", "DFT_REAL_OUTPUT", "DFT_COMPLEX_INPUT", "DCT_INVERSE",
                 "DCT_ROWS"):
        assert hasattr(tcv, name), name
        assert getattr(tcv, name).__class__ is getattr(jcv, name).__class__, name
    for name in ("DFT_INVERSE", "DFT_SCALE", "DFT_ROWS", "DFT_COMPLEX_OUTPUT",
                 "DFT_REAL_OUTPUT", "DFT_COMPLEX_INPUT", "DCT_INVERSE", "DCT_ROWS"):
        assert getattr(tcv, name) == getattr(jcv, name) == getattr(cv2, name), name
