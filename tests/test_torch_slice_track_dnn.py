"""The DNN-tracker path (``entry.forward_track_dnn``) on the CPU at a small
cut — GOTURN at CaffeNet's depth with every width divided by 8
(``entry.goturn_files(0, 8)``), six trackers on a (4, 216, 384)
``make_motion_video`` — against the JAX package: the two readers' nets on
the same blobs within NET_TOL (convolutions and products summed in
oneDNN's order and XLA's), each update's blobs equal to the JAX
composition of the crop (numpy's edge pad and slice, the JAX resize and
blobFromImage), each update's output equal to the JAX net's on the port's
blobs within NET_TOL, and every box equal to the JAX tracker's."""

import numpy as np
import pytest
import torch

from torch_threads import _one_torch_thread  # noqa: F401

import opencv_tpu as jcv
from opencv_tpu_torch import entry as E

NET_TOL = dict(rtol=1e-4, atol=1e-4)
SHAPE = (4, 216, 384, 3)


@pytest.fixture(scope="module")
def run():
    ptxt, pbin = E.goturn_files(0, 8)
    net = E.make_goturn_net(0, "cpu", width_div=8)
    frames, _, boxes = E.make_motion_video(SHAPE)
    trackers = E.make_goturn_trackers(net, torch.from_numpy(frames[0]), boxes[0])
    out = E.forward_track_dnn(torch.from_numpy(frames), trackers)
    jnet = jcv.dnn.readNetFromCaffe(ptxt, pbin)
    return (ptxt, pbin), net, jnet, frames, boxes, out


def test_nets_agree_on_random_blobs(run):
    _, net, jnet, *_ = run
    rng = np.random.default_rng(0)
    a, b = (rng.uniform(-128, 127, (2, 3, 227, 227)).astype(np.float32) for _ in range(2))
    for n in (net, jnet):
        n.setInput(a, "data1")
        n.setInput(b, "data2")
    got, want = net.forward("scale"), np.asarray(jnet.forward("scale"))
    assert got.shape == (2, 4)
    np.testing.assert_allclose(got, want, **NET_TOL)


def _jax_blob(img, region):
    """The JAX tracker's crop of `region` (tracker_goturn's padded ROI)."""
    rx, ry, rw, rh = region
    ix, iy, iw, ih = (int(round(rx)), int(round(ry)), int(round(rw)), int(round(rh)))
    p = np.pad(img, ((ih, ih), (iw, iw), (0, 0)), mode="edge")[iy:iy + ih, ix:ix + iw]
    r = np.asarray(jcv.resize(p, (227, 227), interpolation=jcv.INTER_LINEAR))
    return np.asarray(jcv.dnn.blobFromImage(r.astype(np.float32), 1.0, None, (128, 128, 128),
                                            False))


def test_each_update_against_the_jax_composition(run):
    _, _, jnet, frames, _, out = run
    assert len(out["updates"]) == 6 * (SHAPE[0] - 1)
    for i, k, region, target, search, res in out["updates"][::5]:
        np.testing.assert_array_equal(target.numpy(), _jax_blob(frames[i - 1], region))
        np.testing.assert_array_equal(search.numpy(), _jax_blob(frames[i], region))
        jnet.setInput(target.numpy(), "data1")
        jnet.setInput(search.numpy(), "data2")
        np.testing.assert_allclose(res, np.asarray(jnet.forward("scale")).ravel(), **NET_TOL)


def test_boxes_equal_the_jax_trackers(run):
    (ptxt, pbin), _, _, frames, boxes, out = run
    for k, box in enumerate(boxes[0]):
        p = jcv.TrackerGOTURN.Params()
        p.modelTxt, p.modelBin = ptxt, pbin
        jt = jcv.TrackerGOTURN_create(p)
        jt.init(frames[0], tuple(int(v) for v in box))
        for i in range(1, len(frames)):
            assert tuple(jt.update(frames[i])[1]) == tuple(out["boxes"][i - 1, k]), (i, k)
    # the untrained prior keeps each box near where it was given
    assert np.abs(out["boxes"][-1] - boxes[0]).max() <= 12
