"""The TSDF Volume and ICP Odometry of the port
(``opencv_tpu_torch/threed/tsdf.py``) against the JAX package's, on the CPU,
on tests/test_surface_classes.py's bumpy scene.

Integration walks the volume in x-slabs with the JAX package's per-voxel
float64 arithmetic: the TSDF and weights equal its numpy's bit for bit,
whatever the slab size, for float metres and u16 millimetres (read at a
factor of 1000 whatever getDepthFactor says, as the JAX package reads them:
ROADMAP queue C).  The raycast marches with masked updates and equals the
JAX package's points and normals exactly; so do the fetched points.
Odometry's poses agree within ODO_ATOL: its 6-unknown least squares is
torch.linalg.lstsq (QR) against numpy's (SVD), apart by ~1e-15 a solve."""

import numpy as np
import pytest
import torch

from torch_threads import _one_torch_thread  # noqa: F401
import test_surface_classes as S

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
import opencv_tpu_torch.threed.tsdf as ttsdf

ODO_ATOL = 1e-9


def _settings(mod, K, H, W, rot=None):
    vs = mod.VolumeSettings()
    vs.setVoxelSize(0.02)
    vs.setVolumeResolution((48, 40, 56))
    vs.setTsdfTruncateDistance(0.06)
    vs.setCameraIntegrateIntrinsics(K)
    vs.setRaycastWidth(W)
    vs.setRaycastHeight(H)
    pose = np.eye(4)
    pose[:3, 3] = [-0.48, -0.4, 1.5]
    if rot is not None:
        pose[:3, :3] = S._rodr(np.asarray(rot, np.float64))
    vs.setVolumePose(pose)
    return vs


def _rt():
    Rt = np.eye(4)
    Rt[:3, :3] = S._rodr(np.array([0.01, -0.015, 0.008]))
    Rt[:3, 3] = [0.01, -0.005, 0.02]
    return Rt


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("slab", [1 << 23, 40 * 56 * 5])
def test_volume_equals_opencv_tpu(slab, monkeypatch):
    monkeypatch.setattr(ttsdf, "SLAB_VOXELS", slab)
    K, H, W, Z, _ = S._bumpy_scene()
    Rt = _rt()
    vt = tcv.Volume(0, _settings(tcv, K, H, W), device="cpu")
    vj = jcv.Volume(0, _settings(jcv, K, H, W))
    for depth, pose in ((Z.astype(np.float32), np.eye(4)), ((Z * 1000).astype(np.uint16), Rt),
                        (torch.from_numpy(Z), np.linalg.inv(Rt))):
        vt.integrate(depth, pose)
        vj.integrate(np.asarray(depth), pose)
        _eq(vt._tsdf.numpy(), vj._tsdf)
        _eq(vt._w.numpy(), vj._w)
    for pose in (np.eye(4), Rt):
        for a, b in zip(vt.raycast(pose, H, W), vj.raycast(pose, H, W)):
            _eq(a.numpy(), b)
    _eq(vt.raycast(Rt)[0].numpy(), vj.raycast(Rt)[0])
    for a, b in zip(vt.fetchPointsNormals(), vj.fetchPointsNormals()):
        _eq(a.numpy(), b)
    assert vt.getVisibleBlocks() == vj.getVisibleBlocks() > 1000
    assert vt.getTotalVolumeUnits() == vj.getTotalVolumeUnits()
    _eq(vt.getBoundingBox(), vj.getBoundingBox())
    p, n, c = vt.raycastColor(np.eye(4))
    assert p.shape == n.shape == c.shape == (H, W, 4)
    vt.reset()
    assert vt.getVisibleBlocks() == 0


def test_volume_rotated_pose_equals_opencv_tpu():
    """A volume pose with a rotation: the raycast takes the general path of
    its inverse pose (rows of products), still the JAX package's values."""
    K, H, W, Z, _ = S._bumpy_scene()
    vt = tcv.Volume(0, _settings(tcv, K, H, W, (0.02, 0.01, -0.03)), device="cpu")
    vj = jcv.Volume(0, _settings(jcv, K, H, W, (0.02, 0.01, -0.03)))
    vt.integrate(Z.astype(np.float32), np.eye(4))
    vj.integrate(Z.astype(np.float32), np.eye(4))
    _eq(vt._tsdf.numpy(), vj._tsdf)
    for a, b in zip(vt.raycast(_rt(), H, W), vj.raycast(_rt(), H, W)):
        _eq(a.numpy(), b)
    _eq(vt.fetchPointsNormals()[0].numpy(), vj.fetchPointsNormals()[0])


def test_volume_settings_equal_opencv_tpu():
    a, b = tcv.VolumeSettings(), jcv.VolumeSettings()
    for name in dir(b):
        if name.startswith("get") and name != "getVolumePose":
            want = getattr(b, name)()
            got = getattr(a, name)()
            assert np.array_equal(np.asarray(got), np.asarray(want)), name
    oa, ob = tcv.OdometrySettings(), jcv.OdometrySettings()
    for name in dir(ob):
        if name.startswith("get"):
            assert np.array_equal(np.asarray(getattr(oa, name)()), np.asarray(getattr(ob, name)()))


def test_odometry_equals_opencv_tpu():
    K, H, W, Z, pts = S._bumpy_scene()
    Rt = _rt()
    p2 = pts @ Rt[:3, :3].T + Rt[:3, 3]
    u = np.round(p2[:, 0] / p2[:, 2] * K[0, 0] + K[0, 2]).astype(int)
    v = np.round(p2[:, 1] / p2[:, 2] * K[1, 1] + K[1, 2]).astype(int)
    dst = np.full((H, W), np.nan)
    inb = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    order = np.argsort(-p2[inb, 2])
    dst[v[inb][order], u[inb][order]] = p2[inb, 2][order]
    src, dst = Z.astype(np.float32), dst.astype(np.float32)
    poses = {}
    for mod in (tcv, jcv):
        s = mod.OdometrySettings()
        s.setCameraMatrix(K)
        od = mod.Odometry(s)
        poses[mod] = [od.compute(src, dst)[1], od.compute(src, dst, np.eye(4))[1]]
        s.setIterCounts([10, 5, 4])
        frames = mod.OdometryFrame(src), mod.OdometryFrame(dst)
        poses[mod].append(mod.Odometry(s).compute(*frames)[1])
    for a, b in zip(poses[tcv], poses[jcv]):
        assert np.abs(a - b).max() <= ODO_ATOL
    assert np.abs(poses[tcv][0][:3, :3] - Rt[:3, :3]).max() < 5e-3
    assert np.abs(poses[tcv][0][:3, 3] - Rt[:3, 3]).max() < 5e-3
    img = np.random.default_rng(0).integers(0, 256, (H, W, 3), np.uint8)
    ft, fj = tcv.OdometryFrame(src, img), jcv.OdometryFrame(src, img)
    _eq(ft.getGrayImage().numpy(), fj.getGrayImage())
    _eq(ft.getDepth().numpy(), fj.getDepth())
    assert ft.getPyramidLevels() == fj.getPyramidLevels() == 0
