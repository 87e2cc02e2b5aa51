"""The port's BASELINE config 3 (pyrDown, cornerHarris, Sobel, Canny) end to
end on the CPU, against the same chain through opencv_tpu at a small batch
(moved from tests/test_torch_slice.py, one file per path)."""

import numpy as np
import pytest
import torch

import opencv_tpu as jcv
from opencv_tpu_torch import entry as E
from opencv_tpu_torch.core.dispatch import reset_tier_stats, tier_stats

SHAPE_CFG3 = (2, 96, 128, 1)


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
