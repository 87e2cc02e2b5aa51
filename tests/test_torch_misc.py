"""opencv_tpu_torch's misc module (getRectSubPix, matchShapes,
phaseCorrelate, createHanningWindow, convertMaps, blendLinear) vs
opencv_tpu and the cv2 oracle, on the CPU.

Tolerances: getRectSubPix ``array_equal`` with opencv_tpu on u8 (the same
f32 weights of the same f64 map) and ±1 of cv2, the reference test's bound;
matchShapes and createHanningWindow ``==`` opencv_tpu (its host code) and
the reference test's bounds of cv2; phaseCorrelate within 1e-9 px and 1e-9
of the response of opencv_tpu's numpy f64 (torch.fft and pocketfft round
differently) and the reference test's 0.2 px of cv2 without a window;
convertMaps and
blendLinear ``array_equal`` with both."""

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu_torch.ops.misc import phase_correlate_batch


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("size,center", [((15, 11), (20.3, 17.7)), ((8, 8), (0.25, 0.5)),
                                         ((9, 5), (49.9, 39.2)), ((6, 7), (-3.4, 12.0))])
@pytest.mark.parametrize("cn", [1, 3])
def test_get_rect_sub_pix(size, center, cn):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (40, 50, cn), np.uint8)
    if cn == 1:
        img = img[..., 0]
    got = tcv.getRectSubPix(_t(img), size, center).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcv.getRectSubPix(img, size, center)))
    ref = cv2.getRectSubPix(img, size, center)
    assert got.shape == ref.shape
    assert np.abs(got.astype(np.int32) - ref).max() <= 1


def _ellipse_contours():
    img = np.zeros((64, 64), np.uint8)
    cv2.circle(img, (32, 32), 20, 255, -1)
    img2 = np.zeros((64, 64), np.uint8)
    cv2.ellipse(img2, (32, 32), (25, 15), 0, 0, 360, 255, -1)
    return img, img2, cv2.findContours(img, 0, 2)[0][0], cv2.findContours(img2, 0, 2)[0][0]


@pytest.mark.parametrize("method", [1, 2, 3])
def test_match_shapes(method):
    img, img2, c1, c2 = _ellipse_contours()
    got = tcv.matchShapes(_t(c1), c2, method, 0)
    assert got == jcv.matchShapes(c1, c2, method, 0)
    r = cv2.matchShapes(c1, c2, method, 0)
    assert abs(r - got) < max(0.05, 0.1 * r)
    assert tcv.matchShapes(_t(img), img2, method, 0) == jcv.matchShapes(img, img2, method, 0)
    assert tcv.matchShapes(c1, c1.reshape(-1, 2), method, 0) == 0.0


@pytest.mark.parametrize("kind", ["CV_32F", "CV_64F"])
def test_hanning_window(kind):
    for size in ((16, 12), (1920, 1080), (5, 3)):
        got = tcv.createHanningWindow(size, getattr(tcv, kind))
        np.testing.assert_array_equal(got, jcv.createHanningWindow(size, getattr(jcv, kind)))
        np.testing.assert_allclose(got, cv2.createHanningWindow(size, getattr(cv2, kind)),
                                   atol=1e-6)


def _textured(seed, shape=(64, 64)):
    rng = np.random.default_rng(seed)
    return cv2.GaussianBlur(rng.random(shape).astype(np.float32), (5, 5), 2)


@pytest.mark.parametrize("shift", [(5, -3), (-7.5, 2.25), (0, 0), (13, 9)])
@pytest.mark.parametrize("windowed", [False, True])
def test_phase_correlate(shift, windowed):
    a = _textured(1, (64, 80))
    b = cv2.warpAffine(a, np.float32([[1, 0, shift[0]], [0, 1, shift[1]]]), (80, 64))
    win = cv2.createHanningWindow((80, 64), cv2.CV_64F) if windowed else None
    (gx, gy), gr = tcv.phaseCorrelate(_t(a), _t(b), win)
    (jx, jy), jr = jcv.phaseCorrelate(a, b, win)
    assert abs(gx - jx) < 1e-9 and abs(gy - jy) < 1e-9 and abs(gr - jr) < 1e-9
    if win is None:
        # the reference test's bound; under a window the reference's 5×5
        # centroid and cv2's sub-pixel fit part by up to ~0.22 px
        (rx, ry), _ = cv2.phaseCorrelate(a, b)
        assert abs(rx - gx) < 0.2 and abs(ry - gy) < 0.2
    assert abs(gx - shift[0]) < 0.5 and abs(gy - shift[1]) < 0.5


def test_phase_correlate_u8_and_batch():
    rng = np.random.default_rng(2)
    base = (cv2.GaussianBlur(rng.random((70, 90)), (7, 7), 2) * 255).astype(np.uint8)
    frames = np.stack([np.roll(base, (dy, dx), (0, 1)) for dx, dy in
                       ((0, 0), (3, -2), (-6, 5), (11, 1))])
    win = tcv.createHanningWindow((90, 70), tcv.CV_64F)
    shifts, resp = phase_correlate_batch(_t(frames[:1]), _t(frames[1:]), win)
    assert shifts.shape == (3, 2) and resp.shape == (3,) and shifts.dtype == torch.float64
    for i in range(1, 4):
        (jx, jy), jr = jcv.phaseCorrelate(frames[0], frames[i], win)
        (gx, gy), gr = tcv.phaseCorrelate(frames[0], frames[i], win)
        assert (gx, gy, gr) == tuple(torch.cat([shifts[i - 1], resp[i - 1:i]]).tolist())
        assert abs(gx - jx) < 1e-9 and abs(gy - jy) < 1e-9 and abs(gr - jr) < 1e-9


def test_phase_correlate_tie():
    """A surface with two equal peaks: an image of period W/2 along x,
    shifted by 3 px, correlates at 3 and at 3 + W/2.  Each backend takes the
    first maximum it finds; which of the two that is depends on the last
    bits of the FFT, so this records the pick, and the two sub-pixel
    answers must be one of the two peaks."""
    rng = np.random.default_rng(3)
    tile = cv2.GaussianBlur(rng.random((32, 24)), (5, 5), 1.5)
    a = np.tile(tile, (1, 2))
    b = np.roll(a, 3, axis=1)
    (gx, gy), gr = tcv.phaseCorrelate(a, b)
    (jx, jy), jr = jcv.phaseCorrelate(a, b)
    peaks = (3.0, 3.0 - 24.0)
    for x in (gx, jx):
        assert min(abs(x - p) for p in peaks) < 0.5, (gx, jx)
    assert abs(gy) < 0.5 and abs(jy) < 0.5 and abs(gr - jr) < 1e-9
    print(f"tie: port picks x = {gx:.6f}, opencv_tpu x = {jx:.6f}")


@pytest.mark.parametrize("nn", [False, True])
def test_convert_maps(nn):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (30, 30), np.uint8)
    mapx = (rng.random((30, 30)) * 28).astype(np.float32)
    mapy = (rng.random((30, 30)) * 28).astype(np.float32)
    m1, m2 = tcv.convertMaps(_t(mapx), _t(mapy), None, nn)
    j1, j2 = jcv.convertMaps(mapx, mapy, None, nn)
    np.testing.assert_array_equal(m1.numpy(), j1)
    assert m1.dtype == torch.int16
    if nn:
        assert m2 is None and j2 is None
        np.testing.assert_array_equal(m1.numpy(), np.stack([np.rint(mapx), np.rint(mapy)], -1))
        return
    assert m2.dtype == torch.uint16
    np.testing.assert_array_equal(m2.numpy(), j2)
    r1, r2 = cv2.convertMaps(mapx, mapy, cv2.CV_16SC2)
    np.testing.assert_array_equal(m1.numpy(), r1)
    np.testing.assert_array_equal(m2.numpy(), r2)
    np.testing.assert_array_equal(tcv.remap(img, m1, m2, tcv.INTER_LINEAR).numpy(),
                                  cv2.remap(img, r1, r2, cv2.INTER_LINEAR))


@pytest.mark.parametrize("dtype,cn", [(np.uint8, 3), (np.uint8, 1), (np.float32, 3)])
def test_blend_linear(dtype, cn):
    rng = np.random.default_rng(4)
    shape = (16, 16, cn) if cn > 1 else (16, 16)
    if dtype == np.uint8:
        a, b = rng.integers(0, 256, shape, np.uint8), rng.integers(0, 256, shape, np.uint8)
    else:
        a, b = rng.random(shape).astype(dtype), rng.random(shape).astype(dtype)
    w1 = rng.random((16, 16)).astype(np.float32)
    w2 = rng.random((16, 16)).astype(np.float32)
    got = tcv.blendLinear(_t(a), _t(b), _t(w1), w2).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcv.blendLinear(a, b, w1, w2)))
    np.testing.assert_array_equal(got, cv2.blendLinear(a, b, w1, w2))


def test_public_surface_misc():
    for name in ("getRectSubPix", "matchShapes", "phaseCorrelate", "createHanningWindow",
                 "convertMaps", "demosaicing", "blendLinear", "CONTOURS_MATCH_I1",
                 "CONTOURS_MATCH_I2", "CONTOURS_MATCH_I3"):
        assert hasattr(tcv, name), name
        assert getattr(tcv, name).__class__ is getattr(jcv, name).__class__, name
    assert (tcv.CONTOURS_MATCH_I1, tcv.CONTOURS_MATCH_I2, tcv.CONTOURS_MATCH_I3) == (1, 2, 3)
