"""opencv_tpu_torch's matchTemplate against opencv_tpu and the cv2 oracle,
on the CPU.

Tolerance, as tests/test_analysis.py holds the reference to cv2:
max |d| / max(1, max |ref|) < 1e-4 against both, and the same argmax (or
argmin for the SQDIFF modes) where the template was cut from the image.
With three channels the reference takes one template mean over all
channels in the CCOEFF modes where cv2 takes one per channel, and the port
follows the reference: there cv2 holds it at 8e-3 in CCOEFF_NORMED with
templates of 16 rows or more (the reference's own case), and not at all in
CCOEFF or with an 8×8 template.

The port takes the window sums of x and x² exactly (int64 or f64) where the
reference takes them in f32; at 480×640 that puts the reference off cv2 by
more than 1e-4 and the port within 1e-5 (recorded below)."""

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu_torch.ops import templmatch as ttm

MODES = [tcv.TM_SQDIFF, tcv.TM_SQDIFF_NORMED, tcv.TM_CCORR, tcv.TM_CCORR_NORMED,
         tcv.TM_CCOEFF, tcv.TM_CCOEFF_NORMED]


def _rel(got, ref):
    return np.abs(got.astype(np.float64) - ref).max() / max(1.0, float(np.abs(ref).max()))


def _best(res, method):
    flat = res.argmin() if method in (tcv.TM_SQDIFF, tcv.TM_SQDIFF_NORMED) else res.argmax()
    return np.unravel_index(flat, res.shape)


def _img(x, i):
    return x[i] if x.shape[-1] > 1 else x[i, ..., 0]


def _cv2_tol(method, cn, th):
    """The bound cv2 holds the reference to, or None where it holds none."""
    if cn == 1 or method not in (tcv.TM_CCOEFF, tcv.TM_CCOEFF_NORMED):
        return 1e-4
    if method == tcv.TM_CCOEFF_NORMED and th >= 16:
        return 8e-3
    return None


@pytest.mark.parametrize("tsize", [(8, 8), (16, 20), (32, 32)], ids=["8x8 taps", "16x20 fft",
                                                                     "32x32 fft"])
@pytest.mark.parametrize("cn", [1, 3])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("method", MODES)
def test_match_template(method, dtype, cn, tsize):
    rng = np.random.default_rng(method * 7 + cn)
    if dtype == np.uint8:
        x = rng.integers(0, 256, (2, 64, 80, cn), np.uint8)
    else:
        x = rng.random((2, 64, 80, cn), dtype=np.float32)
    th, tw = tsize
    t = x[0, 20:20 + th, 30:30 + tw].copy()
    if cn == 1:
        t = t[..., 0]
    got = tcv.matchTemplate(torch.from_numpy(x), torch.from_numpy(t), method).numpy()
    want = np.asarray(jcv.matchTemplate(x, t, method))
    assert got.shape == want.shape == (2, 64 - th + 1, 80 - tw + 1, 1)
    assert got.dtype == np.float32
    assert _rel(got, want) < 1e-4
    assert _best(got[0, ..., 0], method) == _best(want[0, ..., 0], method)
    tol = _cv2_tol(method, cn, th)
    for i in range(2):
        ref = cv2.matchTemplate(_img(x, i), t, method)
        if tol is not None:
            assert _rel(got[i, ..., 0], ref) < tol, f"image {i}"
        if i == 0:
            assert _best(got[0, ..., 0], method) == _best(ref, method)
            if method != tcv.TM_CCORR:  # the plain correlation peaks on bright patches
                assert _best(ref, method) == (20, 30)


@pytest.mark.parametrize("mask_kind", ["u8 binary", "f32 weights"])
@pytest.mark.parametrize("cn", [1, 3])
@pytest.mark.parametrize("method", MODES)
def test_match_template_masked(method, cn, mask_kind):
    rng = np.random.default_rng(11 + method + cn)
    img = rng.integers(0, 256, (60, 80, cn) if cn > 1 else (60, 80), np.uint8)
    t = rng.integers(0, 256, (16, 12, cn) if cn > 1 else (16, 12), np.uint8)
    if mask_kind == "u8 binary":
        mask = (rng.random((16, 12)) > 0.3).astype(np.uint8) * 255
    else:
        mask = rng.random((16, 12)).astype(np.float32)
    got = tcv.matchTemplate(torch.from_numpy(img), torch.from_numpy(t), method, mask=mask).numpy()
    want = np.asarray(jcv.matchTemplate(img, t, method, mask=mask))
    ref = cv2.matchTemplate(img, t, method, mask=mask)
    assert got.shape == ref.shape == (45, 69) and got.dtype == np.float32
    for other in (want.reshape(ref.shape), ref):
        assert _rel(got, other) < 1e-4
        # tests/test_analysis.py checks the argmax for all but the SQDIFF modes
        assert got.argmax() == other.argmax() or method in (tcv.TM_SQDIFF, tcv.TM_SQDIFF_NORMED)


def test_match_template_window_sums_are_exact_at_vga():
    """The divergence from opencv_tpu: its f32 cumsums of x² lose the
    normalisation at 480×640; the port's int64 sums do not."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (480, 640), np.uint8)
    t = rng.integers(0, 256, (32, 32), np.uint8)
    ref = cv2.matchTemplate(x, t, cv2.TM_CCOEFF_NORMED)
    got = tcv.matchTemplate(torch.from_numpy(x), torch.from_numpy(t), tcv.TM_CCOEFF_NORMED).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < 1e-5
    want = np.asarray(jcv.matchTemplate(x, t, jcv.TM_CCOEFF_NORMED))
    assert np.abs(want - ref).max() > 1e-4
    wsum, wsum2 = ttm._window_sums(torch.from_numpy(x)[None, :, :, None], 32, 32)
    assert wsum.dtype == wsum2.dtype == torch.float64
    xi = x.astype(np.int64)
    assert wsum2[0, 100, 200, 0] == (xi[100:132, 200:232] ** 2).sum()


def test_match_template_per_image_and_errors():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (30, 40), np.uint8)
    t = img[5:13, 7:15].copy()
    got = tcv.matchTemplate(img, t, tcv.TM_CCORR_NORMED)  # numpy in, CPU tensor out
    assert tuple(got.shape) == (23, 33)
    np.testing.assert_allclose(got.numpy(), cv2.matchTemplate(img, t, cv2.TM_CCORR_NORMED),
                               rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="unknown matchTemplate method"):
        tcv.matchTemplate(img, t, 6)
    with pytest.raises(ValueError, match="unknown matchTemplate method"):
        tcv.matchTemplate(img, t, 6, mask=np.ones((8, 8), np.uint8))
