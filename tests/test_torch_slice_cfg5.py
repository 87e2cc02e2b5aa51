"""The port's BASELINE config 5 (ORB) end to end on the CPU, against the same
chain through opencv_tpu at a small batch (moved from
tests/test_torch_slice.py, one file per path)."""

import numpy as np

import opencv_tpu as jcv
from opencv_tpu_torch import entry as E
from opencv_tpu_torch.core.dispatch import reset_tier_stats, tier_stats

SHAPE_CFG5 = (2, 240, 320)


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
