"""The port's the cell-segmentation path (colour correction → gray →
GaussianBlur → Otsu → opening → sure background, distance transform and sure
foreground → markers → watershed → cells, centroids and Delaunay triangles;
frame 0's background flood, mean shift and grabCut cut-out; EMD of the
cells' histograms; the painted boundaries) end to end on the CPU, against
the same chain through opencv_tpu at a small batch (moved from
tests/test_torch_slice.py, one file per path)."""

import numpy as np
import pytest
import torch

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu_torch import entry as E
from opencv_tpu_torch.core.dispatch import reset_tier_stats, tier_stats
from torch_threads import _one_torch_thread  # noqa: F401

SHAPE_SEGMENT = (2, 216, 384, 3)  # a fifth of 1080p, two frames


def _same_results(a, b):
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_results(x, y) for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


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
