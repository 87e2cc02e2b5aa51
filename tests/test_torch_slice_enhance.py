"""The port's the enhancement path (gray → medianBlur → CLAHE → unsharp mask →
bilateralFilter → γ LUT → applyColorMap, with the CLAHE output's histogram
per image) end to end on the CPU, against the same chain through opencv_tpu
at a small batch (moved from tests/test_torch_slice.py, one file per path)."""

import numpy as np
import torch

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu_torch import entry as E
from opencv_tpu_torch.core.dispatch import reset_tier_stats, tier_stats

SHAPE_ENHANCE = (2, 216, 384, 3)  # a fifth of 1080p: the 8x8 CLAHE tiles still divide it


def _jax_enhance_stages(x, ins=None):
    """forward_enhance's stages through opencv_tpu.  Each stage takes
    ``ins[i]`` (the port's own input to that stage) where given, else the
    previous JAX stage's output; returns the seven images and the
    per-image histograms of the CLAHE output."""
    steps = [lambda a: jcv.cvtColor(a, jcv.COLOR_BGR2GRAY),
             lambda a: jcv.medianBlur(a, 5),
             lambda a: jcv.createCLAHE(2.0, (8, 8)).apply(a),
             lambda a: jcv.addWeighted(a, 1.5, jcv.GaussianBlur(a, (5, 5), 0), -0.5, 0),
             lambda a: jcv.bilateralFilter(a, 5, 50, 50),
             lambda a: jcv.LUT(a, E.GAMMA_LUT),
             lambda a: jcv.applyColorMap(a, jcv.COLORMAP_JET)]
    outs, cur = [], x
    for i, step in enumerate(steps):
        cur = np.asarray(step(cur if ins is None else ins[i]))
        outs.append(cur)
    c = outs[2] if ins is None else ins[3]
    hist = np.stack([np.asarray(jcv.calcHist([c[i]], [0], None, [256], [0, 256]))
                     for i in range(len(c))])
    return outs, hist


def test_entry_enhance_batch():
    forward, (x,) = E.entry_enhance("cpu", SHAPE_ENHANCE)
    assert forward is E.forward_enhance
    np.testing.assert_array_equal(x.numpy(), E.make_batch(SHAPE_ENHANCE))
    np.testing.assert_array_equal(
        E.GAMMA_LUT, np.rint(255 * (np.arange(256) / 255.0) ** 0.8).astype(np.uint8))


def test_enhance_matches_opencv_tpu():
    """The path at (2, 216, 384, 3) against opencv_tpu's chain: every stage
    on the port's own input to it exactly (bilateralFilter within ±1, its
    reference bound), and the whole chain exactly up to the bilateral
    stage.  The per-image sums are the outputs' sums; GaussianBlur resolves
    sep_filter's registration once, to the plain tier on the CPU."""
    x = E.make_batch(SHAPE_ENHANCE)
    reset_tier_stats()
    *outs, hist, sums = E.forward_enhance(torch.from_numpy(x))
    assert tier_stats() == {"tier.sep_filter_u8.plain": 1}
    outs = [o.numpy() for o in outs]
    assert [o.shape for o in outs] == [(2, 216, 384, 1)] * 6 + [(2, 216, 384, 3)]
    assert all(o.dtype == np.uint8 for o in outs)
    ins = [x] + outs[:-1]
    want, want_hist = _jax_enhance_stages(x, ins)
    for name, g, w in zip(E.ENHANCE_OUTPUTS, outs, want):
        assert g.shape == w.shape, name
        if name == "bilateral":
            assert np.abs(g.astype(np.int32) - w).max() <= 1, name
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert hist.dtype == torch.float32 and hist.shape == (2, 256)
    np.testing.assert_array_equal(hist.numpy(), want_hist)
    chain, _ = _jax_enhance_stages(x)
    for name, g, w in list(zip(E.ENHANCE_OUTPUTS, outs, chain))[:4]:
        np.testing.assert_array_equal(g, w, err_msg=f"chain {name}")
    assert sums.dtype == torch.int64 and sums.shape == (2, 8)
    np.testing.assert_array_equal(
        sums.numpy(), np.stack([a.reshape(2, -1).astype(np.int64).sum(1)
                                for a in (*outs, hist.numpy())], 1))


def test_public_surface_enhance():
    """The names the enhancement slice adds, each the class of its
    opencv_tpu twin."""
    for name in ("calcHist", "equalizeHist", "compareHist", "calcBackProject", "createCLAHE",
                 "CLAHE", "medianBlur", "bilateralFilter", "stackBlur", "applyColorMap", "add",
                 "subtract", "multiply", "divide", "absdiff", "scaleAdd", "addWeighted",
                 "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not", "compare", "inRange",
                 "LUT", "convertScaleAbs", "normalize", "split", "merge", "flip", "rotate",
                 "transpose", "minMaxLoc", "mean", "meanStdDev", "norm", "countNonZero",
                 "sumElems", "magnitude", "phase", "cartToPolar", "polarToCart", "min", "max",
                 "exp", "log", "sqrt", "pow", "mixChannels", "setIdentity", "completeSymm",
                 "solveCubic", "solvePoly", "PSNR", "batchDistance", "hconcat", "vconcat",
                 "repeat", "reduce", "reduceArgMax", "reduceArgMin", "sort", "sortIdx",
                 "findNonZero", "hasNonZero", "checkRange", "patchNaNs", "extractChannel",
                 "insertChannel", "copyTo", "gemm", "calcCovarMatrix", "divSpectrums",
                 "fastAtan2", "cubeRoot", "clipLine", "flipND", "transposeND", "broadcast",
                 "finiteMask", "solveLP", "buildMST", "REDUCE_SUM", "REDUCE_AVG", "REDUCE_MAX",
                 "REDUCE_MIN", "REDUCE_SUM2", "SORT_EVERY_ROW", "SORT_EVERY_COLUMN",
                 "SORT_ASCENDING", "SORT_DESCENDING", "GEMM_1_T", "GEMM_2_T", "GEMM_3_T",
                 "COVAR_SCRAMBLED", "COVAR_NORMAL", "COVAR_USE_AVG", "COVAR_SCALE",
                 "COVAR_ROWS", "COVAR_COLS", "COLORMAP_JET", "HISTCMP_KL_DIV"):
        assert hasattr(tcv, name), name
        assert getattr(tcv, name).__class__ is getattr(jcv, name).__class__, name
    for name in ("REDUCE_SUM2", "SORT_DESCENDING", "GEMM_3_T", "COVAR_COLS"):
        assert getattr(tcv, name) == getattr(jcv, name), name
