"""The port's BASELINE config 4 (matchTemplate, erode, dilate) end to end on
the CPU, against the same chain through opencv_tpu at a small batch (moved
from tests/test_torch_slice.py, one file per path)."""

import numpy as np
import pytest

import opencv_tpu as jcv
from opencv_tpu_torch import entry as E
from opencv_tpu_torch.core.dispatch import reset_tier_stats, tier_stats

SHAPE_CFG4 = (2, 96, 128, 1)


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
