"""The port's stereo-depth path, its forward (``entry.forward_stereo``) on
the CPU, on ``make_stereo_rig``'s scene pair at (540, 960) with the rig
``calibrate_rig`` calibrates from 4 pairs, stage by stage on the port's own
inputs against the same ``opencv_tpu`` calls, and the truth.

Every stage equals the JAX package exactly but the depth: remap LINEAR of
each frame; the fused gray + blur + 2× map (the JAX kernel in interpret
mode); StereoSGBM at half size; cvtColor and StereoBM at full size;
filterSpeckles (the JAX package's Python loop against the port's native
flood).  The depth, reprojectImageTo3D's four terms summed one op at a
time against the JAX package's matrix product, within 1e-6 relative
(measured: equal).
Equal stages make equal chains.  The truth at this size (measured: SGBM
1.0 of the valid pixels between the planes' edges within 1 px, all of
them valid; BM 1.0, 0.994 valid) is held to the path's gates."""

import numpy as np
import pytest
import torch

import opencv_tpu as jcv
from opencv_tpu.calib3d import misc3d as jmisc
from opencv_tpu.kernels.fused_preproc import fused_gray_gauss5_down2 as j_fused
from opencv_tpu_torch import entry as E

from torch_threads import _one_torch_thread  # noqa: F401

SHAPE = (4, 540, 960, 3)


@pytest.fixture(scope="module")
def data():
    return E.make_stereo_rig(SHAPE)


@pytest.fixture(scope="module")
def out(data):
    rig = E.calibrate_rig(torch.from_numpy(data["views"]), data["object_points"])
    st = E.forward_stereo(torch.from_numpy(data["scene"]), rig)
    return rig, st


def test_outputs(out):
    _, st = out
    H, W = SHAPE[1:3]
    for key, shape, dtype in (("rectified", (2, H, W, 3), torch.uint8),
                              ("half", (2, H // 2, W // 2), torch.uint8),
                              ("sgbm", (H // 2, W // 2), torch.int16),
                              ("gray", (2, H, W), torch.uint8),
                              ("bm", (H, W), torch.int16), ("bm_filtered", (H, W), torch.int16),
                              ("xyz", (H, W, 3), torch.float32)):
        assert tuple(st[key].shape) == shape and st[key].dtype == dtype, key


def test_rectify_and_half_equal_opencv_tpu(data, out):
    rig, st = out
    m = [v.numpy() for v in rig["maps"]]
    for c in range(2):
        ref = jcv.remap(data["scene"][c], m[2 * c], m[2 * c + 1], jcv.INTER_LINEAR)
        assert np.array_equal(st["rectified"][c].numpy(), np.asarray(ref))
    ref = j_fused(st["rectified"].numpy(), 0.0, interpret=True)
    assert np.array_equal(st["half"].numpy(), np.asarray(ref))


def test_sgbm_equals_opencv_tpu(out):
    _, st = out
    h = st["half"].numpy()
    ref = jcv.StereoSGBM_create(**E.STEREO_SGBM).compute(h[0], h[1])
    assert np.array_equal(st["sgbm"].numpy(), np.asarray(ref))


def test_bm_speckles_and_depth_near_opencv_tpu(out):
    rig, st = out
    gray = np.asarray(jcv.cvtColor(st["rectified"].numpy(), jcv.COLOR_BGR2GRAY))[..., 0]
    assert np.array_equal(st["gray"].numpy(), gray)
    bm = jcv.StereoBM_create(E.STEREO_BM["numDisparities"], E.STEREO_BM["blockSize"])
    bm.setPreFilterCap(E.STEREO_BM["preFilterCap"])
    bm.setTextureThreshold(E.STEREO_BM["textureThreshold"])
    bm.setUniquenessRatio(E.STEREO_BM["uniquenessRatio"])
    assert np.array_equal(st["bm"].numpy(), bm.compute(gray[0], gray[1]))
    ref = jmisc.filterSpeckles(st["bm"].numpy(), -16, E.STEREO_BM["speckleWindowSize"],
                               E.STEREO_BM["speckleRange"])
    assert np.array_equal(st["bm_filtered"].numpy(), ref)
    xyz = jcv.reprojectImageTo3D(st["bm_filtered"].numpy().astype(np.float32) / 16.0, rig["Q"],
                                 True)
    a, b = st["xyz"].numpy().astype(np.float64), xyz.astype(np.float64)
    assert np.all(np.abs(a - b) <= 1e-6 * np.maximum(np.abs(b), 1.0))


def test_disparity_truth(data, out):
    rig, st = out
    rep = E.stereo_truth_report(rig, st, data)
    g = E.STEREO_GATES
    assert rep["sgbm"][0] >= g["sgbm_within"] and rep["sgbm"][1] >= g["sgbm_valid"], rep["sgbm"]
    assert rep["bm"][0] >= g["bm_within"], rep["bm"]
