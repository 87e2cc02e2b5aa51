"""The port's slices end to end on the CPU, each against the same chain
through opencv_tpu at a small batch: the flagship entry forward,
BASELINE config 2 (resize LINEAR, AREA and CUBIC, warpAffine,
warpPerspective), config 3 (pyrDown, cornerHarris, Sobel, Canny),
config 4 (matchTemplate, erode, dilate), config 5 (ORB), and the
decode-and-colour path (NV12 → BGR → HSV, Lab, YCrCb, the fused gray +
blur + 2× AREA map, its Otsu binary map and integral), and the enhancement
path (gray → medianBlur → CLAHE → unsharp mask → bilateralFilter → γ LUT
→ applyColorMap, with the CLAHE output's histogram per image), and the motion
path (gray → GaussianBlur → phase correlation against frame 0 → warpAffine
by minus the shift → accumulateWeighted background → absdiff, threshold and
opening → connected components with stats, distance transform, moments →
the last frame's contours), the lines path, and the cell-segmentation path
(colour correction → gray → GaussianBlur → Otsu → opening → sure
background, distance transform and sure foreground → markers → watershed →
cells, centroids and Delaunay triangles; frame 0's background flood, mean
shift and grabCut cut-out; EMD of the cells' histograms; the painted
boundaries)."""

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu_torch import entry as E
from opencv_tpu_torch.core.dispatch import reset_tier_stats, tier_stats

SHAPE = (2, 96, 128, 3)
SHAPE_CFG2 = (2, 216, 384, 3)  # a tenth of 4K: LINEAR still halves exactly
SHAPE_CFG3 = (2, 96, 128, 1)
SHAPE_CFG4 = (2, 96, 128, 1)
SHAPE_CFG5 = (2, 240, 320)
SHAPE_NV12 = (2, 108, 192)  # a tenth of 1080p
SHAPE_ENHANCE = (2, 216, 384, 3)  # a fifth of 1080p: the 8x8 CLAHE tiles still divide it
SHAPE_MOTION = (4, 216, 384, 3)  # a fifth of 1080p, four frames
SHAPE_LINES = (2, 180, 320, 3)  # a sixth of 1080p, two frames
SHAPE_SEGMENT = (2, 216, 384, 3)  # a fifth of 1080p, two frames


def _jax_chain(imgs):
    """__graft_entry__.entry()'s forward at a half-size resize and centre."""
    H, W = imgs.shape[1], imgs.shape[2]
    g = jcv.cvtColor(imgs, jcv.COLOR_BGR2GRAY)
    b = jcv.GaussianBlur(g, (5, 5), 0)
    r = jcv.resize(b, (W // 2, H // 2))
    M = jcv.getRotationMatrix2D((W / 4, H / 4), 15.0, 0.9)
    return np.asarray(r), np.asarray(jcv.warpAffine(r, M, (W // 2, H // 2)))


@pytest.fixture(scope="module")
def batch():
    return E.make_batch(SHAPE)


def test_entry_batch_and_shapes():
    forward, (imgs,) = E.entry("cpu", SHAPE)
    assert forward is E.forward
    assert imgs.dtype == torch.uint8 and tuple(imgs.shape) == SHAPE
    np.testing.assert_array_equal(
        imgs.numpy(), np.random.default_rng(0).integers(0, 256, size=SHAPE, dtype=np.uint8))
    assert E.SHAPE == (8, 1080, 1920, 3)


def test_slice_matches_opencv_tpu(batch):
    want_pre, want = _jax_chain(batch)
    imgs = torch.from_numpy(batch)
    reset_tier_stats()
    pre = E.preprocess(imgs)
    assert tier_stats() == {"tier.sep_filter_u8.plain": 1}
    np.testing.assert_array_equal(pre.numpy(), want_pre)
    out = E.forward(imgs).numpy()
    assert out.shape == (2, 48, 64, 1)
    d = np.abs(out.astype(int) - want.astype(int))
    assert d.max() <= 1 and np.count_nonzero(d) <= d.size // 1000


def test_fused_forward_equals_composed(batch):
    imgs = torch.from_numpy(batch)
    assert torch.equal(E.preprocess_fused(imgs), E.preprocess(imgs))
    assert torch.equal(E.forward_fused(imgs), E.forward(imgs))


def _jax_cfg2(x):
    """bench.py's cfg2 (bench.py:501-520) at x's size: outputs and the three
    int32 reductions."""
    import jax.numpy as jnp
    H, W = x.shape[1], x.shape[2]
    rs = [jcv.resize(x, (W // 2, H // 2), interpolation=i)
          for i in (jcv.INTER_LINEAR, jcv.INTER_AREA, jcv.INTER_CUBIC)]
    wa = jcv.warpAffine(x, jcv.getRotationMatrix2D((W / 2, H / 2), 15.0, 0.9), (W, H))
    wp = jcv.warpPerspective(x, E.PERSPECTIVE_CFG2, (W, H))
    totals = [sum(jnp.asarray(r).astype(jnp.int32).sum() for r in rs),
              jnp.asarray(wa).astype(jnp.int32).sum(), jnp.asarray(wp).astype(jnp.int32).sum()]
    return [np.asarray(v) for v in (*rs, wa, wp)] + [np.array([int(t) for t in totals])]


def test_entry_resize_warp_4k_batch():
    forward, (x,) = E.entry_resize_warp_4k("cpu", SHAPE_CFG2)
    assert forward is E.forward_resize_warp_4k
    np.testing.assert_array_equal(
        x.numpy(), np.random.default_rng(0).integers(0, 256, size=SHAPE_CFG2, dtype=np.uint8))
    assert E.SHAPE_CFG2 == (4, 2160, 3840, 3)
    np.testing.assert_array_equal(E.PERSPECTIVE_CFG2, [[0.95, 0.05, 8.0], [-0.04, 1.02, 4.0],
                                                       [1e-6, -2e-6, 1.0]])


def test_resize_warp_4k_matches_opencv_tpu():
    """Config 2 on bench.py's noise batch at (2, 216, 384, 3): the three
    resizes equal opencv_tpu exactly; each warp is within the warp bound
    (max |d| <= 1 on at most 0.1% of pixels: f64 against double-float
    coordinates), so its int32 total is within the number of pixels that
    differ; the resizes' total is exact."""
    x = E.make_batch(SHAPE_CFG2)
    want = _jax_cfg2(x)
    reset_tier_stats()
    got = [v.numpy() for v in E.forward_resize_warp_4k(torch.from_numpy(x))]
    assert tier_stats() == {}  # no kernel on this path: the JAX package has none there
    for name, g, w in zip(("LINEAR", "AREA", "CUBIC", "warpAffine", "warpPerspective"),
                          got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == np.uint8, name
        if name.startswith("warp"):
            d = np.abs(g.astype(int) - w.astype(int))
            assert d.max() <= 1 and np.count_nonzero(d) <= d.size // 1000, name
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[0].shape == (2, 108, 192, 3) and got[3].shape == SHAPE_CFG2
    # LINEAR at exactly half size is fast AREA (resize.cpp:4010)
    np.testing.assert_array_equal(got[0], got[1])
    n_diff = [np.count_nonzero(got[i] != want[i]) for i in (3, 4)]
    assert got[5][0] == want[5][0]
    assert all(abs(int(got[5][i + 1]) - int(want[5][i + 1])) <= n_diff[i] for i in range(2))


def _jax_cfg3(x):
    """bench.py's cfg3 (bench.py:447-454), outputs and reduction."""
    import jax.numpy as jnp
    p = jcv.pyrDown(x)
    h = jcv.cornerHarris(x.astype(np.float32) / np.float32(255), 2, 3, 0.04)
    sx = jcv.Sobel(x, jcv.CV_16S, 1, 0)
    c = jcv.Canny(x, 50, 150)
    total = (jnp.asarray(p).astype(jnp.int32).sum() + jnp.asarray(h).sum().astype(jnp.int32)
             + jnp.asarray(sx).astype(jnp.int32).sum() + jnp.asarray(c).astype(jnp.int32).sum())
    return [np.asarray(v) for v in (p, h, sx, c, total)]


def test_entry_pyr_corner_edge_batch():
    forward, (x,) = E.entry_pyr_corner_edge("cpu", SHAPE_CFG3)
    assert forward is E.forward_pyr_corner_edge
    np.testing.assert_array_equal(
        x.numpy(), np.random.default_rng(0).integers(0, 256, size=SHAPE_CFG3, dtype=np.uint8))
    assert E.SHAPE_CFG3 == (8, 1080, 1920, 1)


@pytest.mark.parametrize("smooth", [False, True], ids=["noise", "smoothed"])
def test_pyr_corner_edge_matches_opencv_tpu(smooth):
    x = E.make_batch(SHAPE_CFG3)
    if smooth:
        x = np.array(jcv.GaussianBlur(x, (7, 7), 2.5))
    want = _jax_cfg3(x)
    reset_tier_stats()
    got = [v.numpy() for v in E.forward_pyr_corner_edge(torch.from_numpy(x))]
    # one pyrDown and three integer Sobels (config 3's Sobel, Canny's dx, dy)
    assert tier_stats() == {"tier.pyr_down_u8.plain": 1, "tier.sep_filter_int.plain": 3}
    for name, g, w in zip(("pyrDown", "cornerHarris", "Sobel", "Canny", "total"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name == "cornerHarris":
            # float32 in another order than XLA's: tests/test_torch_analysis.py's bound
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6 * np.abs(w).max())
        elif name != "total":
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[0].shape == (2, 48, 64, 1)
    # the reduction takes int32 of the float32 Harris sum, which another
    # summation order may move by one
    assert abs(int(got[4]) - int(want[4])) <= 1


def _jax_cfg4(x, t):
    """bench.py's cfg4 (bench.py:466-471), outputs and reduction."""
    import jax.numpy as jnp
    m = jcv.matchTemplate(x, t, jcv.TM_CCOEFF_NORMED)
    e3 = jcv.erode(x, np.ones((3, 3), np.uint8))
    d5 = jcv.dilate(x, np.ones((5, 5), np.uint8))
    e9 = jcv.erode(x, np.ones((9, 9), np.uint8))
    total = (jnp.asarray(m).sum().astype(jnp.float32) + jnp.asarray(e3).astype(jnp.int32).sum()
             + jnp.asarray(d5).astype(jnp.int32).sum() + jnp.asarray(e9).astype(jnp.int32).sum())
    return [np.asarray(v) for v in (m, e3, d5, e9, total)]


def test_entry_match_morph_batch():
    forward, (x, t) = E.entry_match_morph("cpu", SHAPE_CFG4)
    assert forward is E.forward_match_morph
    rng = np.random.default_rng(0)  # the batch, then the template, as bench.py draws them
    np.testing.assert_array_equal(x.numpy(), rng.integers(0, 256, size=SHAPE_CFG4, dtype=np.uint8))
    np.testing.assert_array_equal(t.numpy(), rng.integers(0, 256, size=(32, 32), dtype=np.uint8))
    assert E.SHAPE_CFG4 == (8, 1080, 1920, 1)


@pytest.mark.parametrize("planted", [False, True], ids=["random template", "planted template"])
def test_match_morph_matches_opencv_tpu(planted):
    _, (x, t) = E.entry_match_morph("cpu", SHAPE_CFG4)
    if planted:
        t = x[1, 40:72, 50:82, 0].clone()
    want = _jax_cfg4(x.numpy(), t.numpy())
    reset_tier_stats()
    got = [v.numpy() for v in E.forward_match_morph(x, t)]
    assert tier_stats() == {}  # no kernel on this path (see the module docstring)
    for name, g, w in zip(("matchTemplate", "erode 3", "dilate 5", "erode 9", "total"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name == "matchTemplate":
            assert np.abs(g - w).max() <= 1e-4 * max(1.0, float(np.abs(w).max()))
        elif name == "total":
            assert abs(float(g) - float(w)) <= 1e-5 * abs(float(w))
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[0].shape == (2, 65, 97, 1)
    if planted:
        assert np.unravel_index(got[0][1, ..., 0].argmax(), (65, 97)) == (40, 50)
        assert abs(got[0][1, 40, 50, 0] - 1) < 1e-4


def test_entry_orb_batch():
    forward, (x, orb) = E.entry_orb("cpu", SHAPE_CFG5)
    assert forward is E.forward_orb
    np.testing.assert_array_equal(
        x.numpy(), np.random.default_rng(0).integers(0, 256, size=SHAPE_CFG5, dtype=np.uint8))
    assert (orb.nfeatures, orb.nlevels, orb.scale_factor, orb.wta_k) == (500, 8, 1.2, 2)
    assert E.SHAPE_CFG5 == (8, 1080, 1920)


def test_orb_slice_matches_opencv_tpu():
    """Config 5 on bench.py's noise batch, against opencv_tpu's ORB under
    the set rule of tests/test_torch_features2d.py."""
    from test_torch_features2d import assert_orb_equal

    forward, (x, orb) = E.entry_orb("cpu", SHAPE_CFG5)
    want = jcv.ORB_create(nfeatures=500).detect_and_compute_batch(x.numpy())
    reset_tier_stats()
    got = forward(x, orb)
    # the descriptor blur through sep_filter, once per level
    assert tier_stats() == {"tier.sep_filter_u8.plain": 8}
    assert_orb_equal(got, want)
    assert all(len(k) > 400 and d.shape == (len(k), 32) for k, d in got)
    assert all({kp.octave for kp in k} == set(range(8)) for k, _ in got)


def test_public_surface_config2():
    """The names config 2's slice adds: the rest of resize and the warps."""
    for name in ("warpPerspective", "remap", "getAffineTransform", "getPerspectiveTransform",
                 "warpPolar", "linearPolar", "logPolar", "WARP_POLAR_LINEAR", "WARP_POLAR_LOG",
                 "INTER_CUBIC", "INTER_LANCZOS4", "INTER_NEAREST_EXACT", "WARP_INVERSE_MAP"):
        assert hasattr(tcv, name), name
        assert getattr(tcv, name).__class__ is getattr(jcv, name).__class__, name
    assert (tcv.WARP_POLAR_LINEAR, tcv.WARP_POLAR_LOG) == (jcv.WARP_POLAR_LINEAR,
                                                           jcv.WARP_POLAR_LOG)


def test_public_surface():
    for name in ("cvtColor", "GaussianBlur", "getGaussianKernel", "resize", "warpAffine",
                 "getRotationMatrix2D", "invertAffineTransform",
                 "fusedPreprocessGrayBlurDown2", "COLOR_BGR2GRAY", "BORDER_DEFAULT",
                 "pyrDown", "pyrUp", "buildPyramid", "sepFilter2D", "filter2D", "boxFilter",
                 "blur", "sqrBoxFilter", "Sobel", "Scharr", "Laplacian", "spatialGradient",
                 "getDerivKernels", "cornerHarris", "cornerMinEigenVal",
                 "cornerEigenValsAndVecs", "preCornerDetect", "Canny", "erode", "dilate",
                 "morphologyEx", "getStructuringElement", "morphologyDefaultBorderValue",
                 "matchTemplate", "goodFeaturesToTrack", "goodFeaturesToTrackWithQuality",
                 "KeyPoint", "KeyPoint_convert", "KeyPoint_overlap", "GFTTDetector",
                 "GFTTDetector_create", "TM_CCOEFF_NORMED", "MORPH_ELLIPSE", "ORB", "ORB_create",
                 "BFMatcher", "DMatch", "FastFeatureDetector", "FastFeatureDetector_create",
                 "FastFeatureDetector_detect", "ORB_HARRIS_SCORE", "NORM_HAMMING",
                 "INTER_LINEAR_EXACT"):
        assert hasattr(tcv, name), name
        assert getattr(tcv, name).__class__ is getattr(jcv, name).__class__, name


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


def _jax_motion(x, ins=None):
    """forward_motion's stages through opencv_tpu.  Each stage takes the
    port's own input to it from ``ins`` (forward_motion's dict) where given,
    else the previous JAX stage's output."""
    N, H, W, _ = x.shape
    out = {}

    def inp(key):
        return out[key] if ins is None else np.asarray(ins[key])

    out["gray"] = np.asarray(jcv.cvtColor(x, jcv.COLOR_BGR2GRAY))
    out["smooth"] = np.asarray(jcv.GaussianBlur(inp("gray"), (5, 5), 0))
    s = inp("smooth")[..., 0]
    win = jcv.createHanningWindow((W, H), jcv.CV_64F)
    pc = [jcv.phaseCorrelate(s[0], s[i], win) for i in range(1, N)]
    out["shifts"] = np.array([[sx, sy] for (sx, sy), _ in pc])
    out["responses"] = np.array([r for _, r in pc])
    shifts = inp("shifts")
    out["aligned"] = np.stack([s[0]] + [np.asarray(jcv.warpAffine(
        s[i], np.array([[1.0, 0, -shifts[i - 1, 0]], [0, 1.0, -shifts[i - 1, 1]]]), (W, H),
        jcv.INTER_LINEAR, jcv.BORDER_REPLICATE)) for i in range(1, N)])[..., None]
    a = inp("aligned")
    bg = a[0, ..., 0].astype(np.float32)
    for i in range(1, N):
        bg = np.asarray(jcv.accumulateWeighted(a[i, ..., 0], bg, 0.05))
    out["background"] = bg[None, ..., None]
    d = np.asarray(jcv.absdiff(a, np.asarray(jcv.convertScaleAbs(inp("background")))))
    _, m = jcv.threshold(d, 25, 255, jcv.THRESH_BINARY)
    out["mask"] = np.asarray(jcv.morphologyEx(np.asarray(m), jcv.MORPH_OPEN,
                                              jcv.getStructuringElement(jcv.MORPH_RECT, (3, 3))))
    m = inp("mask")
    cc = [jcv.connectedComponentsWithStats(m[i, ..., 0], 8) for i in range(N)]
    out["n_labels"] = np.array([c[0] for c in cc])
    out["labels"] = np.stack([np.asarray(c[1]) for c in cc])
    out["stats"] = [c[2] for c in cc]
    out["centroids"] = [c[3] for c in cc]
    out["distance"] = np.asarray(jcv.distanceTransform(m, jcv.DIST_L2, 3))
    out["moments"] = [jcv.moments(m[i, ..., 0], True) for i in range(N)]
    out["contours"] = jcv.findContours(m[-1, ..., 0], jcv.RETR_EXTERNAL,
                                       jcv.CHAIN_APPROX_SIMPLE)[0]
    return out


def _check_motion(got, want, what):
    """The port's motion outputs against opencv_tpu's: u8 images, labels,
    counts, stats and contours exactly, the shifts and responses within
    1e-9, the aligned frames within the warp bound (max |d| <= 1 on at most
    0.1% of pixels), the background bit for bit in f32, the distances
    within 1e-5, the centroids within 1e-9 relative, and the moments within
    rel 1e-12 of cv2 and within opencv_tpu's f32 error of it (its central
    moments cancel: its own distance from cv2)."""
    for key in ("gray", "smooth", "mask", "labels", "n_labels", "background"):
        np.testing.assert_array_equal(np.asarray(got[key]), want[key], err_msg=f"{what} {key}")
    for key in ("shifts", "responses"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-9, rtol=0, err_msg=key)
    d = np.abs(got["aligned"].numpy().astype(np.int32) - want["aligned"])
    assert d.max() <= 1 and np.count_nonzero(d) <= d.size // 1000, what
    for i, n in enumerate(want["n_labels"]):
        np.testing.assert_array_equal(got["stats"][i, :n].numpy(), want["stats"][i])
        assert not got["stats"][i, n:].any()
        np.testing.assert_allclose(got["centroids"][i, :n].numpy(), want["centroids"][i],
                                   rtol=1e-9, atol=0)
        ref = cv2.moments(got["mask"][i, ..., 0].numpy(), True)
        for k, v in want["moments"][i].items():
            g = got["moments"][i][k]
            assert abs(g - ref[k]) <= 1e-12 * max(1.0, abs(ref[k])), (what, i, k)
            bound = max(1e-6, abs(v) * 1e-5, 1.01 * abs(v - ref[k]) + 1e-12 * abs(ref[k]))
            assert abs(g - v) <= bound, (what, i, k)
    np.testing.assert_allclose(got["distance"].numpy(), want["distance"], atol=1e-5, rtol=0)
    assert len(got["contours"]) == len(want["contours"])
    for c, w in zip(got["contours"], want["contours"]):
        np.testing.assert_array_equal(c, w)


def test_entry_motion_video():
    forward, (x,) = E.entry_motion("cpu", SHAPE_MOTION)
    assert forward is E.forward_motion
    video, shifts, boxes = E.make_motion_video(SHAPE_MOTION)
    np.testing.assert_array_equal(x.numpy(), video)
    assert video.dtype == np.uint8 and video.shape == SHAPE_MOTION
    assert shifts.shape == (4, 2) and not shifts[0].any() and np.abs(shifts).max() <= 16
    assert boxes.shape == (4, E.MOTION_OBJECTS, 4)
    assert E.SHAPE_MOTION == (8, 1080, 1920, 3)


def test_motion_matches_opencv_tpu():
    """The path at (4, 216, 384, 3) against opencv_tpu's chain: every stage
    on the port's own input to it, then the whole chain (the seed's aligned
    frames come out equal, so the stages after them must too).  GaussianBlur
    resolves sep_filter's registration once, to the plain tier on the CPU."""
    x, _, _ = E.make_motion_video(SHAPE_MOTION)
    reset_tier_stats()
    got = E.forward_motion(torch.from_numpy(x))
    assert tier_stats() == {"tier.sep_filter_u8.plain": 1}
    N, H, W, _ = SHAPE_MOTION
    assert got["shifts"].shape == (N - 1, 2) and got["aligned"].shape == (N, H, W, 1)
    assert got["labels"].dtype == torch.int32 and got["distance"].dtype == torch.float32
    assert got["stats"].shape == (N, int(got["n_labels"].max()), 5)
    _check_motion(got, _jax_motion(x, got), "stage")
    _check_motion(got, _jax_motion(x), "chain")
    cols = [got[k] for k in E.MOTION_SUMS]
    cols[4] = torch.round(cols[4])
    np.testing.assert_array_equal(got["sums"].numpy(), np.stack(
        [c.reshape(N, -1).to(torch.int64).sum(1).numpy() for c in cols], 1))
    assert got["areas"] == [jcv.contourArea(c) for c in got["contours"]]
    assert got["rects"] == [jcv.boundingRect(c) for c in got["contours"]]


def test_motion_recovers_the_shifts_and_objects():
    """The shifts within 0.25 px of the video's, and every object box of
    frames 1.. overlaps a component of the mask in its frame (frame 0's
    objects weigh 0.95^(N-1) in the background)."""
    x, shifts, boxes = E.make_motion_video(SHAPE_MOTION)
    got = E.forward_motion(torch.from_numpy(x))
    assert np.abs(got["shifts"] - shifts[1:]).max() < 0.25
    labels = got["labels"].numpy()
    for i in range(1, SHAPE_MOTION[0]):
        for bx, by, bw, bh in boxes[i]:
            assert labels[i, by:by + bh, bx:bx + bw].any(), (i, bx, by)
    assert got["cc_steps"]["checks"] >= 1 and got["dt_steps"]["checks"] >= 1


def test_public_surface_motion():
    """The names the motion slice adds, each the class of its opencv_tpu
    twin."""
    for name in ("phaseCorrelate", "createHanningWindow", "accumulateWeighted",
                 "connectedComponentsWithStats", "distanceTransform", "moments", "findContours",
                 "contourArea", "boundingRect", "dft", "dct", "solve", "transform", "RNG",
                 "getRectSubPix", "convertMaps", "blendLinear", "matchShapes", "HuMoments"):
        assert hasattr(tcv, name), name
        assert getattr(tcv, name).__class__ is getattr(jcv, name).__class__, name


# ------------------------------------------------------------- lines path

def _jax_lines(x, ins=None):
    """forward_lines' stages through opencv_tpu, per frame where its calls
    take one image, each frame drawn on its own numpy copy.  Each stage takes
    the port's own input to it from ``ins`` (forward_lines' dict) where
    given, else the previous JAX stage's output."""
    N, H, W, _ = x.shape
    hp, cp = E.LINES_HOUGH, E.LINES_CIRCLES
    out = {}

    def inp(key):
        if ins is None:
            return out[key]
        v = ins[key]
        return v.numpy() if isinstance(v, torch.Tensor) else v

    out["gray"] = np.asarray(jcv.cvtColor(x, jcv.COLOR_BGR2GRAY))
    out["blur"] = np.asarray(jcv.GaussianBlur(inp("gray"), (5, 5), 0))
    out["edges"] = np.asarray(jcv.Canny(inp("blur"), 50, 150))
    e = inp("edges")
    out["lines"] = [jcv.HoughLines(e[i, ..., 0], hp["rho"], hp["theta"], hp["threshold"])
                    for i in range(N)]
    out["segments"] = [jcv.HoughLinesP(e[i, ..., 0], hp["rho"], hp["theta"], hp["threshold"],
                                       hp["minLineLength"], hp["maxLineGap"]) for i in range(N)]
    b = inp("blur")
    out["circles"] = [jcv.HoughCircles(b[i, ..., 0], jcv.HOUGH_GRADIENT, cp["dp"], cp["minDist"],
                                       cp["param1"], cp["param2"], cp["minRadius"],
                                       cp["maxRadius"]) for i in range(N)]
    out["lanes"] = []
    for segs in inp("segments"):
        s = np.zeros((0, 4), np.int32) if segs is None else segs.reshape(-1, 4)
        mid = (s[:, 0] + s[:, 2]) / 2
        out["lanes"].append([jcv.fitLine(half.reshape(-1, 2).astype(np.float32),
                                         jcv.DIST_HUBER, 0, 0.01, 0.01) if len(half) else None
                             for half in (s[mid < W / 2], s[mid >= W / 2])])
    out["lsd"] = jcv.createLineSegmentDetector().detect(inp("gray")[0, ..., 0])
    drawn = []
    segments, lanes, circles, lsd = (inp(k) for k in ("segments", "lanes", "circles", "lsd"))
    for i in range(N):
        img = x[i].copy()
        segs = np.zeros((0, 4), np.int32) if segments[i] is None else segments[i].reshape(-1, 4)
        for x1, y1, x2, y2 in segs:
            jcv.line(img, (x1, y1), (x2, y2), E.SEGMENT_BGR, 3)
        for fit in lanes[i]:
            ends = None if fit is None else E.lane_ends(fit, H)
            if ends is not None:
                jcv.line(img, *ends, E.LANE_BGR, 2, jcv.LINE_AA)
        circ = np.zeros((0, 3)) if circles[i] is None else circles[i].reshape(-1, 3)
        for cx, cy, r in circ:
            jcv.circle(img, (int(cx), int(cy)), int(round(float(r))), E.CIRCLE_BGR, 2)
        if i == 0 and lsd[0] is not None:
            for l in lsd[0].reshape(-1, 4):
                jcv.line(img, (int(round(l[0])), int(round(l[1]))),
                         (int(round(l[2])), int(round(l[3]))), E.LSD_BGR, 1)
        text, org, s = E.caption(len(segs), len(circ), H)
        jcv.putText(img, text, org, jcv.FONT_HERSHEY_SIMPLEX, s, E.TEXT_BGR, 2)
        drawn.append(img)
    out["drawn"] = np.stack(drawn)
    return out


def _same_results(a, b):
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_results(x, y) for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def _check_lines(got, want, what):
    """The port's lines outputs against opencv_tpu's: all exactly, but LSD's
    segments, whose f32 prefilter is the port's own: the same count, end
    points and widths within 1e-4 px."""
    for key in ("gray", "blur", "edges", "drawn"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=f"{what} {key}")
    for key in ("lines", "segments", "circles", "lanes"):
        assert _same_results(got[key], want[key]), (what, key)
    (gl, gw, gp, gn), (wl, ww, wp, wn) = got["lsd"], want["lsd"]
    assert gl.shape == wl.shape, what
    np.testing.assert_allclose(gl, wl, atol=1e-4, rtol=0)
    np.testing.assert_allclose(gw, ww, atol=1e-4, rtol=0)
    assert _same_results((gp, gn), (wp, wn))


def test_entry_road_video():
    forward, (x,) = E.entry_lines("cpu", SHAPE_LINES)
    assert forward is E.forward_lines
    video, truth = E.make_road_video(SHAPE_LINES)
    np.testing.assert_array_equal(x.numpy(), video)
    assert video.dtype == np.uint8 and video.shape == SHAPE_LINES
    assert truth["edges"].shape == (2, 4, 2, 2, 2) and 0 <= truth["dashed"] < 4
    assert truth["circles"].shape[0] == 2 and 3 <= truth["circles"].shape[1] <= 5
    assert E.SHAPE_LINES == (8, 1080, 1920, 3)
    with pytest.raises(ValueError):
        E.make_road_video((1, 60, 200, 3))


def test_lines_matches_opencv_tpu():
    """The path at (2, 180, 320, 3) against opencv_tpu's chain: every stage
    on the port's own input to it, then the whole chain.  GaussianBlur
    resolves sep_filter's u8 registration once, the Sobels of the two Canny
    calls and of HoughCircles its integer one six times, each to the plain
    tier on the CPU."""
    x, _ = E.make_road_video(SHAPE_LINES)
    reset_tier_stats()
    got = E.forward_lines(torch.from_numpy(x))
    assert tier_stats() == {"tier.sep_filter_u8.plain": 1, "tier.sep_filter_int.plain": 6}
    N, H, W, _ = SHAPE_LINES
    assert got["edges"].shape == (N, H, W, 1) and got["drawn"].shape == (N, H, W, 3)
    assert got["drawn"].dtype == torch.uint8 and len(got["segments"]) == N
    _check_lines(got, _jax_lines(x, got), "stage")
    _check_lines(got, _jax_lines(x), "chain")
    cols = [got[k].reshape(N, -1).to(torch.int64).sum(1) for k in E.LINES_SUMS]
    np.testing.assert_array_equal(got["sums"].numpy(), torch.stack(cols, 1).numpy())
    assert got["hough_stats"]["edge_pixels"] == int((got["edges"] > 0).sum())
    assert got["circle_stats"]["candidates"] >= 3 * N
    assert 0 < got["draw_writes"] <= 3 * N + 1


def test_lines_finds_the_lanes_and_circles():
    """Every marking edge long enough to gather the Hough threshold's votes
    has a segment within 3 px and 2 degrees, and every circle a detection
    within 2 px and 3 px of radius (tests/test_hough_seg.py's bound); the
    checker reports what it is given to miss."""
    x, truth = E.make_road_video(SHAPE_LINES)
    got = E.forward_lines(torch.from_numpy(x))
    assert E.road_truth_misses(got["segments"], got["circles"], truth) == []
    long = [np.hypot(*(m[1] - m[0])) >= 1.25 * E.LINES_HOUGH["threshold"]
            for m in truth["edges"][0].reshape(-1, 2, 2)]
    assert sum(long) >= 4
    misses = E.road_truth_misses([None] * 2, [None] * 2, truth)
    assert len(misses) == 2 * (sum(long) + truth["circles"].shape[1])


def test_lines_batch_equals_frames():
    """Two frames through the path at once give each frame's own outputs
    (the batched Hough helpers and the one canvas keep frames apart; LSD's
    segments are drawn on the first frame of a call only)."""
    x, _ = E.make_road_video(SHAPE_LINES)
    both = E.forward_lines(torch.from_numpy(x))
    for i in range(2):
        one = E.forward_lines(torch.from_numpy(x[i:i + 1]))
        for key in ("edges", "drawn") if i == 0 else ("edges",):
            assert torch.equal(one[key][0], both[key][i]), key
        for key in ("segments", "circles", "lanes"):
            assert _same_results(one[key][0], both[key][i]), key


def test_public_surface_lines():
    """The names the lines slice adds, each the class of its opencv_tpu
    twin."""
    for name in ("line", "rectangle", "circle", "ellipse", "ellipse2Poly", "polylines",
                 "fillPoly", "fillConvexPoly", "drawContours", "drawMarker", "arrowedLine",
                 "drawKeypoints", "drawMatches", "drawMatchesKnn", "putText", "getTextSize",
                 "getFontScaleFromHeight", "HoughLines", "HoughLinesP", "HoughCircles",
                 "HoughLinesPointSet", "HoughLinesWithAccumulator",
                 "HoughCirclesWithAccumulator", "GeneralizedHoughBallard",
                 "createGeneralizedHoughBallard", "GeneralizedHoughGuil",
                 "createGeneralizedHoughGuil", "fitLine", "createLineSegmentDetector",
                 "LineSegmentDetector", "LSD_REFINE_NONE", "LSD_REFINE_STD", "LSD_REFINE_ADV",
                 "rectangleIntersectionArea", "getClosestEllipsePoints",
                 "phaseCorrelateIterative", "filter2Dp", "findContoursLinkRuns"):
        assert hasattr(tcv, name), name
        assert getattr(tcv, name).__class__ is getattr(jcv, name).__class__, name
    assert (tcv.LSD_REFINE_NONE, tcv.LSD_REFINE_STD, tcv.LSD_REFINE_ADV) == (0, 1, 2)


# ---------------------------------------------------- cell-segmentation path

def _jax_segment(x, model, ins=None):
    """forward_segment's stages through opencv_tpu, per frame where its
    calls take one image.  Each stage takes the port's own input to it from
    ``ins`` (forward_segment's dict) where given, else the previous JAX
    stage's output."""
    N, H, W, _ = x.shape
    out = {}

    def inp(key):
        if ins is None:
            return out[key]
        v = ins[key]
        return v.numpy() if isinstance(v, torch.Tensor) else v

    ones = np.ones((3, 3), np.uint8)
    out["corrected"] = np.ascontiguousarray(model.correctImage(x[..., ::-1])[..., ::-1])
    out["gray"] = np.asarray(jcv.cvtColor(inp("corrected"), jcv.COLOR_BGR2GRAY))
    out["blur"] = np.asarray(jcv.GaussianBlur(inp("gray"), (5, 5), 0))
    otsu, binary = jcv.threshold(inp("blur"), 0, 255, jcv.THRESH_BINARY | jcv.THRESH_OTSU)
    out["otsu"], out["binary"] = float(otsu), np.asarray(binary)
    out["opening"] = np.asarray(jcv.morphologyEx(inp("binary"), jcv.MORPH_OPEN, ones,
                                                 iterations=2))
    out["sure_bg"] = np.asarray(jcv.dilate(inp("opening"), ones, iterations=3))
    d = np.asarray(jcv.distanceTransform(inp("opening"), jcv.DIST_L2, 5))
    out["distance"] = d
    out["sure_fg"] = np.where(d > 0.5 * d.max(axis=(1, 2, 3), keepdims=True), 255,
                              0).astype(np.uint8)
    out["unknown"] = np.asarray(jcv.subtract(inp("sure_bg"), inp("sure_fg")))
    cc = [jcv.connectedComponents(inp("sure_fg")[i, ..., 0], 8) for i in range(N)]
    out["n_labels"] = np.array([c[0] for c in cc])
    out["markers"] = np.where(inp("unknown")[..., 0] == 255, 0,
                              np.stack([np.asarray(c[1]) for c in cc]) + 1).astype(np.int32)
    regions = []
    for i in range(N):
        m = np.ascontiguousarray(inp("markers")[i], np.int32).copy()
        jcv.watershed(inp("corrected")[i], m)
        regions.append(m)
    out["regions"] = np.stack(regions)
    out["centroids"], out["n_cells"], out["triangles"] = [], [], []
    for i in range(N):
        r = inp("regions")[i]
        cent = []
        for lab in range(2, r.max() + 1):
            ys, xs = np.nonzero(r == lab)
            if len(xs):
                cent.append((xs.mean(), ys.mean()))
        cent = np.array(cent).reshape(-1, 2)
        sub = jcv.Subdiv2D((0, 0, W, H))
        sub.insert(cent)
        out["centroids"].append(cent)
        out["n_cells"].append(len(cent))
        out["triangles"].append(sub.getTriangleList())
    dd = (E.SEGMENT_FLOOD_DIFF,) * 3
    out["flood"] = jcv.floodFill(inp("corrected")[0], None, (0, 0), (0, 0, 0), dd, dd,
                                 8 | jcv.FLOODFILL_FIXED_RANGE | jcv.FLOODFILL_MASK_ONLY
                                 | (255 << 8))[2][1:-1, 1:-1]
    out["half"] = np.asarray(jcv.pyrDown(inp("corrected")[0]))
    out["smoothed"] = np.asarray(jcv.pyrMeanShiftFiltering(inp("half"), 10, 10, 1))
    stats = jcv.connectedComponentsWithStats(inp("opening")[0, ..., 0], 8)[2]
    out["cut_rect"] = E.cutout_rect(np.asarray(stats), inp("half").shape[:2])
    out["cut_mask"], out["bgd_model"], out["fgd_model"] = jcv.grabCut(
        inp("smoothed"), None, inp("cut_rect"), None, None, 3, jcv.GC_INIT_WITH_RECT)
    hist = np.stack([np.asarray(jcv.calcHist([inp("gray")[i]], [0],
                                             (inp("regions")[i] >= 2).astype(np.uint8),
                                             [16], [0, 256])).reshape(-1) for i in range(N)])
    out["cell_hist"] = hist
    sig = [np.stack([h / max(h.sum(), 1.0), np.arange(16, dtype=np.float32)], 1) for h in hist]
    out["emd"] = np.array([jcv.EMD(sig[0], g, jcv.DIST_L1)[0] for g in sig[1:]])
    out["painted"] = np.where((inp("regions") == -1)[..., None],
                              np.array(E.BOUNDARY_BGR, np.uint8), inp("corrected"))
    return out


def _check_segment(got, want, what):
    """The port's segmentation outputs against opencv_tpu's, all exactly."""
    for key, w in want.items():
        g = got[key]
        if isinstance(g, torch.Tensor):
            g = g.numpy()
        if key == "otsu":
            assert float(g) == w, (what, key)
        elif key in ("centroids", "triangles"):
            assert _same_results(g, w), (what, key)
        elif key in ("cut_rect", "n_cells"):
            assert tuple(g) == tuple(w), (what, key)
        else:
            g, w = np.asarray(g), np.asarray(w)
            assert g.shape == w.shape and g.dtype == w.dtype, (what, key, g.shape, w.shape,
                                                               g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {key}")


@pytest.fixture(scope="module")
def segment_run():
    x, truth = E.make_cells_video(SHAPE_SEGMENT)
    model = E.fit_cells_model(truth["patches"])
    reset_tier_stats()
    got = E.forward_segment(torch.from_numpy(x), model)
    return x, truth, model, got, tier_stats()


def test_entry_cells_video():
    forward, (x, model) = E.entry_segment("cpu", SHAPE_SEGMENT)
    assert forward is E.forward_segment
    video, truth = E.make_cells_video(SHAPE_SEGMENT)
    np.testing.assert_array_equal(x.numpy(), video)
    assert video.dtype == np.uint8 and video.shape == SHAPE_SEGMENT
    K = len(truth["radii"])
    assert 40 <= K <= 60 and truth["centres"].shape == (2, K, 2)
    assert truth["patches"].shape == (24, 1, 3)
    # most cells touch another, and no centre lies in another disc
    c, r = truth["centres"][0], truth["radii"]
    d = np.hypot(*(c[:, None] - c[None]).transpose(2, 0, 1)) + np.diag(np.full(K, np.inf))
    assert ((d < r[:, None] + r[None]).any(1)).mean() > 0.6
    assert (d > np.maximum(r[:, None], r[None])).all()
    np.testing.assert_array_equal(model.getCCM(), E.fit_cells_model().getCCM())
    assert E.SHAPE_SEGMENT == (8, 1080, 1920, 3)


def test_segment_matches_opencv_tpu(segment_run):
    """The path at (2, 216, 384, 3) against opencv_tpu's chain: every stage
    on the port's own input to it, then the whole chain.  GaussianBlur
    resolves sep_filter's u8 registration once and pyrDown pyr_down's twice
    (frame 0, then inside pyrMeanShiftFiltering), each to the plain tier on
    the CPU."""
    x, truth, _, got, tiers = segment_run
    assert tiers == {"tier.sep_filter_u8.plain": 1, "tier.pyr_down_u8.plain": 2}
    jmodel = jcv.ccm_ColorCorrectionModel(truth["patches"], 0)
    jmodel.compute()
    _check_segment(got, _jax_segment(x, jmodel, got), "stage")
    _check_segment(got, _jax_segment(x, jmodel), "chain")
    N = SHAPE_SEGMENT[0]
    cols = [got[k].reshape(N, -1).to(torch.int64).sum(1) for k in E.SEGMENT_SUMS]
    np.testing.assert_array_equal(got["sums"].numpy(), torch.stack(cols, 1).numpy())
    assert got["ms_stats"]["live"][0] > 0 and len(got["gc_stats"]["maxflow_ms"]) == 3


def test_segment_finds_the_cells(segment_run):
    """Every cell centre of both frames lies in a watershed region of its
    own, the region count is the truth's within 10%, and frame 0's flood
    covers at least 95% of the background and no cell's interior.  grabCut's
    IoU with the cells (0.85 at 1080p, chip_smoke.py phase 4j) is not held
    at this fifth of the size, where the mean shift's fixed 10 px window
    spans a cell; the report still gives it."""
    _, truth, _, got, _ = segment_run
    rep = E.segment_truth_report(got, truth)
    assert rep["missed"] == [] and rep["shared"] == []
    assert all(abs(n - k) <= 0.1 * k for n, k in rep["counts"])
    assert rep["flood_bg"] >= 0.95 and rep["flood_cells"] == 0
    assert 0 < rep["cut_iou"] <= 1
    lost = dict(got, regions=torch.zeros_like(got["regions"]), flood=torch.zeros_like(
        got["flood"]))
    rep = E.segment_truth_report(lost, truth)
    assert len(rep["missed"]) == truth["centres"].size // 2 and rep["flood_bg"] == 0


def test_segment_batch_equals_frames(segment_run):
    """Frame 1 through the path alone gives its own outputs: the pooled
    floods and the batched scatters keep frames apart (its Otsu threshold,
    one per batch, is the batch's here)."""
    x, _, model, both, _ = segment_run
    one = E.forward_segment(torch.from_numpy(x[1:]), model)
    assert float(one["otsu"]) == float(both["otsu"])
    for key in ("corrected", "sure_fg", "markers", "regions", "painted"):
        assert torch.equal(one[key][0], both[key][1]), key
    assert _same_results(one["centroids"][0], both["centroids"][1])
    assert _same_results(one["triangles"][0], both["triangles"][1])
    np.testing.assert_array_equal(one["cell_hist"][0], both["cell_hist"][1])


def test_public_surface_segment():
    """The names the segmentation slice adds, each the class of its
    opencv_tpu twin."""
    for name in ("floodFill", "watershed", "pyrMeanShiftFiltering", "FLOODFILL_FIXED_RANGE",
                 "FLOODFILL_MASK_ONLY", "EMD", "grabCut", "GC_BGD", "GC_FGD", "GC_PR_BGD",
                 "GC_PR_FGD", "GC_INIT_WITH_RECT", "GC_INIT_WITH_MASK", "GC_EVAL", "Subdiv2D",
                 "kmeans", "KMEANS_RANDOM_CENTERS", "KMEANS_PP_CENTERS",
                 "KMEANS_USE_INITIAL_LABELS", "IntelligentScissorsMB",
                 "segmentation_IntelligentScissorsMB", "ccm_ColorCorrectionModel"):
        assert hasattr(tcv, name), name
        assert getattr(tcv, name).__class__ is getattr(jcv, name).__class__, name
        if isinstance(getattr(jcv, name), int):
            assert getattr(tcv, name) == getattr(jcv, name), name
    assert tcv.segmentation.IntelligentScissorsMB is tcv.IntelligentScissorsMB
    for name in ("CCM_LINEAR", "CCM_AFFINE", "COLORCHECKER_MACBETH", "COLORCHECKER_VINYL",
                 "COLORCHECKER_DIGITAL_SG"):
        assert getattr(tcv.ccm, name) == getattr(jcv.ccm, name), name
    assert tcv.ccm.ColorCorrectionModel is tcv.ccm_ColorCorrectionModel
