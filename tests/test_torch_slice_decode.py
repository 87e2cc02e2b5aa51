"""The port's the decode-and-colour path (NV12 → BGR → HSV, Lab, YCrCb, the
fused gray + blur + 2× AREA map, its Otsu binary map and integral) end to
end on the CPU, against the same chain through opencv_tpu at a small batch
(moved from tests/test_torch_slice.py, one file per path)."""

import numpy as np
import torch

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu_torch import entry as E
from opencv_tpu_torch.core.dispatch import reset_tier_stats, tier_stats

SHAPE_NV12 = (2, 108, 192)  # a tenth of 1080p


def _jax_decode_color(y, uv):
    """forward_decode_color's chain through opencv_tpu: cvtColorTwoPlane
    image by image (the JAX call takes one), the fused kernel in interpret
    mode, one Otsu threshold over the batch."""
    from opencv_tpu.kernels.fused_preproc import fused_gray_gauss5_down2 as j_fused
    bgr = np.stack([np.asarray(jcv.cvtColorTwoPlane(y[i], uv[i], jcv.COLOR_YUV2BGR_NV12))
                    for i in range(len(y))])
    convs = [np.asarray(jcv.cvtColor(bgr, c))
             for c in (jcv.COLOR_BGR2HSV, jcv.COLOR_BGR2Lab, jcv.COLOR_BGR2YCrCb)]
    small = np.asarray(j_fused(bgr, 0.0, interpret=True))[..., None]
    otsu, binary = jcv.threshold(small, 0, 255, jcv.THRESH_BINARY | jcv.THRESH_OTSU)
    integ = np.asarray(jcv.integral(binary))
    return [bgr, *convs, small, np.asarray(binary), integ], float(otsu)


def test_entry_decode_color_batch():
    forward, (y, uv) = E.entry_decode_color("cpu", SHAPE_NV12)
    assert forward is E.forward_decode_color
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(y.numpy(), rng.integers(0, 256, SHAPE_NV12, np.uint8))
    np.testing.assert_array_equal(uv.numpy(), rng.integers(0, 256, (2, 54, 96, 2), np.uint8))
    assert E.SHAPE_NV12 == (8, 1080, 1920)


def test_decode_color_matches_opencv_tpu():
    """The path at (2, 108, 192): every image output equals opencv_tpu's
    exactly, the Otsu threshold too, and the per-image sums are the
    outputs' sums.  The fused kernel resolves through the dispatch
    registry, which counts the plain tier on the CPU."""
    y, uv = E.make_nv12(SHAPE_NV12)
    want, otsu = _jax_decode_color(y, uv)
    reset_tier_stats()
    got = E.forward_decode_color(torch.from_numpy(y), torch.from_numpy(uv))
    assert tier_stats() == {"tier.gauss5_down2_u8.plain": 1}
    *outs, got_otsu, sums = got
    assert len(outs) == len(E.DECODE_COLOR_OUTPUTS)
    for name, g, w in zip(E.DECODE_COLOR_OUTPUTS, outs, want):
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert outs[0].shape == (2, 108, 192, 3) and outs[6].shape == (2, 55, 97, 1)
    assert got_otsu.dtype == torch.float64 and float(got_otsu) == otsu
    assert sums.dtype == torch.int64 and sums.shape == (2, 7)
    np.testing.assert_array_equal(
        sums.numpy(), np.stack([w.reshape(2, -1).astype(np.int64).sum(1) for w in want], 1))


def test_gauss5_down2_resolves_through_the_registry():
    """Both entries of the fused kernel resolve ``gauss5_down2_u8`` with
    lookup; a CPU tensor counts the plain tier."""
    x = torch.from_numpy(E.make_batch((1, 8, 12, 3)))
    reset_tier_stats()
    tcv.fusedPreprocessGrayBlurDown2(x)
    tcv.kernels.gauss5_down2_u8(x[..., 0].contiguous())
    assert tier_stats() == {"tier.gauss5_down2_u8.plain": 2}


def test_public_surface_decode_color():
    """The names the decode-and-colour slice adds."""
    for name in ("cvtColorTwoPlane", "threshold", "adaptiveThreshold", "thresholdWithMask",
                 "integral", "integral2", "integral3", "copyMakeBorder", "borderInterpolate",
                 "demosaicing", "COLOR_YUV2BGR_NV12", "THRESH_OTSU", "THRESH_TRIANGLE",
                 "ADAPTIVE_THRESH_GAUSSIAN_C", "COLOR_BayerBG2BGR"):
        assert hasattr(tcv, name), name
        assert getattr(tcv, name).__class__ is getattr(jcv, name).__class__, name
