"""The JPEG-in, PNG-out path, ``entry.forward_codec``, on the CPU: the
motion video's frames through the port's ``imencode('.jpg')``, decoded on
the host, the flagship forward (``sep_filter`` k5 through its plain
version on a CPU tensor), and ``imencode('.png')``, held to the same chain
through opencv_tpu (JPEG bytes, decoded frames and PNG bytes equal; the
forward within the flagship slice's warp bound), and the decoded frames'
PSNR at 1080p against ``entry.CODEC_PSNR_DB``, the value the card's run is
gated by."""

import numpy as np
import torch

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu_torch import entry as E
from opencv_tpu_torch.core.dispatch import reset_tier_stats, tier_stats
from test_torch_slice_flagship import _jax_chain
from torch_threads import _one_torch_thread  # noqa: F401

SHAPE = (2, 108, 192, 3)


def test_forward_codec_against_opencv_tpu():
    frames, jpegs = E.make_codec_frames(SHAPE)
    np.testing.assert_array_equal(frames, E.make_motion_video(SHAPE)[0])
    for f, b in zip(frames, jpegs):
        assert b == bytes(jcv.imencode(".jpg", f)[1])
    times = {}
    reset_tier_stats()
    out = E.forward_codec(jpegs, "cpu", times)
    assert tier_stats() == {"tier.sep_filter_u8.plain": 1}
    assert set(times) == set(E.CODEC_STAGES)
    want_dec = np.stack([jcv.imdecode(np.frombuffer(b, np.uint8), jcv.IMREAD_COLOR)
                         for b in jpegs])
    np.testing.assert_array_equal(out["decoded"], want_dec)
    y = out["out"]
    assert y.device.type == "cpu" and y.shape == (2, 54, 96, 1) and y.dtype == torch.uint8
    assert torch.equal(y, E.forward(torch.from_numpy(want_dec)))
    np.testing.assert_array_equal(out["host"], y[..., 0].numpy())
    _, want = _jax_chain(want_dec)
    d = np.abs(out["host"].astype(int) - want[..., 0].astype(int))
    assert d.max() <= 1 and np.count_nonzero(d) <= d.size // 1000
    for png, o in zip(out["pngs"], out["host"]):
        assert png == bytes(jcv.imencode(".png", o)[1])
        np.testing.assert_array_equal(tcv.imdecode(np.frombuffer(png, np.uint8), -1), o)
    for d_, f in zip(out["decoded"], frames):
        assert E.psnr(d_, f) > 35.0


def test_codec_psnr_at_1080p_holds_the_card_gate():
    """The CPU's PSNR of frames 0 and 7 at the card's size is at least
    CODEC_PSNR_DB, so the card's gate (less the margin) is the CPU's value."""
    frames = E.make_motion_video(E.SHAPE_CODEC)[0][[0, -1]]
    for f in frames:
        ok, buf = tcv.imencode(".jpg", f)
        assert ok
        p = E.psnr(tcv.imdecode(buf, tcv.IMREAD_COLOR), f)
        assert E.CODEC_PSNR_DB <= p < E.CODEC_PSNR_DB + 0.05, p
    assert E.psnr(frames[0], frames[0]) == float("inf")
