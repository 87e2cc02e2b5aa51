"""The RGB-D fusion path (``entry.forward_fusion``) at a small size on the
CPU: ``make_rgbd_scene``'s room seen over 5 frames at 160 x 120 (kinfu's
intrinsics scaled), fused into a 96³ volume of the same 3 m, against the JAX
package stage by stage on the port's own inputs, and against the truth.

The rendered depths equal the JAX package's rasterizer's bit for bit; each
frame-to-frame ICP pose (on the port's depth frames) agrees within
ODO_ATOL; the volume integrated at the port's chained poses, the raycast at
its last pose and the fetched points equal the JAX package's exactly.  The
truth: the last chained pose within FUSION_POSE_TOL_M and
FUSION_POSE_TOL_DEG, and the raycast's depth within DEPTH_VOXELS voxels (47
mm here: the raycast reads the nearest voxel, and a 31 mm voxel at grazing
angles puts 5.4% of the pixels over one; chip_smoke.py holds
FUSION_DEPTH_TOL, 10 mm, at 512³) of the rendered depth on
FUSION_DEPTH_SHARE of the pixels."""

import numpy as np
import pytest
import torch

from torch_threads import _one_torch_thread  # noqa: F401

import opencv_tpu as jcv
from opencv_tpu_torch import entry as E
from opencv_tpu_torch.threed.tsdf import Odometry, Volume

SHAPE = (5, 120, 160)
RES = 96
ODO_ATOL = 1e-9
DEPTH_VOXELS = 1.5


@pytest.fixture(scope="module")
def run():
    scene = E.make_rgbd_scene(SHAPE)
    vs, os_ = E.fusion_settings(RES, SHAPE[2], SHAPE[1])
    vol = Volume(0, vs, device="cpu")
    times = {}
    out = E.forward_fusion(scene, vol, Odometry(os_), "cpu", times)
    return scene, vol, out, times


def _jax_settings():
    vs, os_ = E.fusion_settings(RES, SHAPE[2], SHAPE[1])
    jvs, jos = jcv.VolumeSettings(), jcv.OdometrySettings()
    for name in ("VoxelSize", "VolumeResolution", "VolumePose", "TsdfTruncateDistance",
                 "MaxWeight", "RaycastStepFactor", "DepthFactor", "CameraIntegrateIntrinsics",
                 "IntegrateWidth", "IntegrateHeight"):
        getattr(jvs, "set" + name)(getattr(vs, "get" + name)())
    jos.setCameraMatrix(os_.getCameraMatrix())
    jos.setIterCounts(os_.getIterCounts())
    return jvs, jos


def test_fusion_truth(run):
    scene, _, out, times = run
    rep = E.fusion_truth_report(out, scene)
    assert rep["pose_err_m"] <= E.FUSION_POSE_TOL_M and rep["pose_err_deg"] <= E.FUSION_POSE_TOL_DEG
    voxel = DEPTH_VOXELS * E.FUSION_SIZE_M / RES
    p = out["points"][..., :3].double().numpy()
    w2c = np.linalg.inv(out["poses"][-1])
    z = p @ w2c[2, :3] + w2c[2, 3]
    d = out["depths"][-1].numpy() / E.FUSION_DEPTH_FACTOR
    ok = np.isfinite(z) & (d > 0)
    assert ok.mean() > 0.95 and (np.abs(z - d)[ok] <= voxel).mean() >= E.FUSION_DEPTH_SHARE
    assert set(times) == set(E.FUSION_STAGES)
    assert len(scene["tris"]) < 1000 and out["depths"].dtype == torch.uint16


def test_fusion_stages_equal_opencv_tpu(run):
    scene, vol, out, _ = run
    W, H = scene["size"]
    st = jcv.TriangleRasterizeSettings().setCullingMode(jcv.RASTERIZE_CULLING_NONE)
    for k, pose in enumerate(scene["poses"]):
        dj = jcv.triangleRasterizeDepth(scene["verts"], scene["tris"],
                                        np.full((H, W), E.FUSION_Z[1], np.float32),
                                        E.GL_FLIP @ np.linalg.inv(pose), scene["fovY"],
                                        E.FUSION_Z[0], E.FUSION_Z[1], st)
        mm = np.round(dj.astype(np.float64) * E.FUSION_DEPTH_FACTOR).astype(np.int32)
        want = np.where(dj < E.FUSION_Z[1], mm, 0).astype(np.uint16)
        np.testing.assert_array_equal(out["depths"][k].numpy(), want)
    jvs, jos = _jax_settings()
    metres = [jcv.rescaleDepth(d.numpy()) for d in out["depths"]]
    od = jcv.Odometry(jos)
    for k in range(1, len(metres)):
        _, T = od.compute(metres[k], metres[k - 1])
        want = out["poses"][k - 1] @ T
        assert np.abs(out["poses"][k] - want).max() <= ODO_ATOL
    jv = jcv.Volume(0, jvs)
    for d, pose in zip(out["depths"], out["poses"]):
        jv.integrate(d.numpy(), pose)
    np.testing.assert_array_equal(vol._tsdf.numpy(), jv._tsdf)
    np.testing.assert_array_equal(vol._w.numpy(), jv._w)
    for a, b in zip((out["points"], out["normals"]), jv.raycast(out["poses"][-1])):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(out["cloud"].numpy(), jv.fetchPointsNormals()[0])
