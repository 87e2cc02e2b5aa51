"""The port's BASELINE config 2 (resize LINEAR, AREA and CUBIC, warpAffine,
warpPerspective) end to end on the CPU, against the same chain through
opencv_tpu at a small batch (moved from tests/test_torch_slice.py, one file
per path)."""

import numpy as np
import torch

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu_torch import entry as E
from opencv_tpu_torch.core.dispatch import reset_tier_stats, tier_stats

SHAPE_CFG2 = (2, 216, 384, 3)  # a tenth of 4K: LINEAR still halves exactly


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


def test_public_surface_config2():
    """The names config 2's slice adds: the rest of resize and the warps."""
    for name in ("warpPerspective", "remap", "getAffineTransform", "getPerspectiveTransform",
                 "warpPolar", "linearPolar", "logPolar", "WARP_POLAR_LINEAR", "WARP_POLAR_LOG",
                 "INTER_CUBIC", "INTER_LANCZOS4", "INTER_NEAREST_EXACT", "WARP_INVERSE_MAP"):
        assert hasattr(tcv, name), name
        assert getattr(tcv, name).__class__ is getattr(jcv, name).__class__, name
    assert (tcv.WARP_POLAR_LINEAR, tcv.WARP_POLAR_LOG) == (jcv.WARP_POLAR_LINEAR,
                                                           jcv.WARP_POLAR_LOG)
