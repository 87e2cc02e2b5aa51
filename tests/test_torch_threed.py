"""The 3d module's depth maps, point clouds, octree and rasterizer in the
port (``opencv_tpu_torch/threed/``) against the JAX package's and cv2, on
the CPU.

Depth maps, normals and the rasterizer run as torch on the input's device,
each float op alone in float64 and divided by 0-dim tensors: they equal
the JAX package's numpy bit for bit (the rasterizer over every shading,
culling and depth mode).  The files either package writes are the other's
byte for byte, and cv2 reads them.  Against cv2, the bounds of
tests/test_threed.py."""

import numpy as np
import pytest
import torch

from common import cv2
from torch_threads import _one_torch_thread  # noqa: F401

import opencv_tpu as jcv
import opencv_tpu_torch as tcv

K = np.array([[100, 0, 16], [0, 100, 12], [0, 0, 1]], np.float64)


def _rodr(r):
    th = np.linalg.norm(r)
    k = r / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def _rt():
    Rt = np.eye(4)
    Rt[:3, :3] = _rodr(np.array([0.01, -0.015, 0.008]))
    Rt[:3, 3] = [0.01, -0.005, 0.02]
    return Rt


def _depths():
    d = np.random.default_rng(1).uniform(0.5, 3.0, (24, 32)).astype(np.float32)
    d16 = (d * 1000).astype(np.uint16)
    d16[3, 4] = 0
    return d, d16


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_depth_maps_equal_opencv_tpu_and_cv2():
    d, d16 = _depths()
    for x in (d, d16):
        got = tcv.depthTo3d(x, K)
        _eq(got.numpy(), jcv.depthTo3d(x, K))
        assert np.allclose(got.numpy(), cv2.depthTo3d(x, K), atol=1e-4, equal_nan=True)
        _eq(tcv.depthTo3d(torch.from_numpy(x.astype(np.int32)).to(torch.uint16)
                          if x.dtype == np.uint16 else torch.from_numpy(x), K).numpy(),
            got.numpy())
    mask = (np.arange(24 * 32).reshape(24, 32) % 3 != 0).astype(np.uint8)
    _eq(tcv.depthTo3d(d, K, None, mask).numpy(), jcv.depthTo3d(d, K, None, mask))
    pts = np.array([[3, 4], [10, 20], [31, 23]], np.float32)
    _eq(tcv.depthTo3dSparse(d16, K, pts).numpy(), jcv.depthTo3dSparse(d16, K, pts))
    for t in (5, 6):
        _eq(tcv.rescaleDepth(d16, t).numpy(), jcv.rescaleDepth(d16, t))
    small = np.array([[0, 1500], [2000, 65535]], np.uint16)
    ref = cv2.rescaleDepth(small, cv2.CV_32F)
    got = tcv.rescaleDepth(small, tcv.CV_32F).numpy()
    assert np.array_equal(np.isfinite(got), np.isfinite(ref))
    assert np.allclose(got[np.isfinite(ref)], ref[np.isfinite(ref)])


@pytest.mark.parametrize("pose", ["eye", "rt"])
def test_register_and_warp_equal_opencv_tpu(pose):
    d, d16 = _depths()
    Rt = np.eye(4) if pose == "eye" else _rt()
    for x in (d, d16):
        got = tcv.registerDepth(K, K, None, Rt, x, (32, 24)).numpy()
        want = jcv.registerDepth(K, K, None, Rt, x, (32, 24))
        assert got.dtype == want.dtype
        _eq(got, want)
    img = np.random.default_rng(0).integers(0, 256, (24, 32, 3), np.uint8)
    mask = np.ones((24, 32), np.uint8)
    mask[:4] = 0
    for m in (None, mask):
        got = tcv.warpFrame(d, img, m, Rt, K)
        want = jcv.warpFrame(d, img, m, Rt, K)
        for a, b in zip(got, want):
            _eq(a.numpy(), b)
    depth = np.full((24, 32), 2.0, np.float32)
    ref = cv2.registerDepth(K, K, None, np.eye(4), depth, (32, 24))
    got = tcv.registerDepth(K, K, None, np.eye(4), depth, (32, 24)).numpy()
    m = (ref > 0) & (got > 0)
    assert m.mean() > 0.9 and np.allclose(got[m], ref[m], atol=1e-5)


def test_normals_and_octree_equal_opencv_tpu():
    d, _ = _depths()
    Z = 2.0 + 0.2 * np.sin(np.arange(32) / 5.0)[None, :] + np.zeros((24, 1))
    for src in (Z.astype(np.float32), d, jcv.depthTo3d(d, K)):
        got = tcv.RgbdNormals_create(24, 32, None, K).apply(src).numpy()
        _eq(got, jcv.RgbdNormals_create(24, 32, None, K).apply(src))
    rn = tcv.RgbdNormals.create(24, 32, None, K, 7)
    assert (rn.getRows(), rn.getCols(), rn.getWindowSize(), rn.getMethod()) == (24, 32, 7, 3)
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 1, (40, 3))
    for mod in (tcv, jcv):
        o = mod.Octree_createWithDepth(4, 1.0)
        assert all(o.insertPoint(p) for p in pts) and not o.insertPoint((2.0, 0, 0))
        assert o.deletePoint(pts[0]) and not o.deletePoint((5.0, 5, 5))
        mod._res = (o.KNNSearch((0.5, 0.5, 0.5), 5), o.radiusNNSearch((0.5, 0.5, 0.5), 0.3),
                    o.getPointCloudByOctree()[0])
    for a, b in zip(tcv._res[:1] + tcv._res[1][1:] + tcv._res[2:],
                    jcv._res[:1] + jcv._res[1][1:] + jcv._res[2:]):
        _eq(a, b)
    assert tcv._res[1][0] == jcv._res[1][0]
    o = tcv.Octree_createWithResolution(0.1, 1.0)
    assert o.empty() and o.isPointInBound((0.5, 0.5, 0.5))
    del tcv._res, jcv._res


def test_point_cloud_files_equal_opencv_tpu_and_cv2(tmp_path):
    rng = np.random.default_rng(0)
    v = rng.uniform(-1, 1, (10, 3)).astype(np.float32)
    rgb = (rng.integers(0, 256, (10, 3)) / 255.0).astype(np.float32)
    n = rng.normal(size=(10, 3)).astype(np.float32)
    for ext in ("ply", "obj"):
        pt, pj = str(tmp_path / f"t.{ext}"), str(tmp_path / f"j.{ext}")
        tcv.savePointCloud(pt, torch.from_numpy(v.reshape(-1, 1, 3)), n, rgb)
        jcv.savePointCloud(pj, v.reshape(-1, 1, 3), n, rgb)
        assert open(pt, "rb").read() == open(pj, "rb").read()
        for a, b in zip(tcv.loadPointCloud(pj), jcv.loadPointCloud(pj)):
            assert (a is None) == (b is None)
            if b is not None:
                _eq(a, b)
    rv, _, rc = cv2.loadPointCloud(str(tmp_path / "t.ply"))
    assert np.allclose(np.asarray(rv).reshape(-1, 3), v, atol=1e-5)
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32).reshape(-1, 1, 3)
    idx = [np.array([0, 1, 2], np.int32), np.array([1, 3, 2], np.int32)]
    for ext in ("ply", "obj"):
        pt, pj = str(tmp_path / f"m.{ext}"), str(tmp_path / f"mj.{ext}")
        tcv.saveMesh(pt, verts, idx)
        jcv.saveMesh(pj, verts, idx)
        assert open(pt, "rb").read() == open(pj, "rb").read()
        rv, ri = cv2.loadMesh(pt)[:2]
        assert [list(np.asarray(x).ravel()) for x in ri] == [[0, 1, 2], [1, 3, 2]]
        gv, gi = tcv.loadMesh(pt)[:2]
        assert np.allclose(gv.reshape(-1, 3), verts.reshape(-1, 3))


def _mesh(trial):
    rng = np.random.default_rng(trial)
    verts = rng.uniform(-1.5, 1.5, (9, 3)).astype(np.float32)
    verts[:, 2] = -rng.uniform(2, 8, 9)
    return verts, rng.integers(0, 9, (6, 3)).astype(np.int32), rng.uniform(0, 1, (9, 3)).astype(
        np.float32)


@pytest.mark.parametrize("trial", [0, 1, 2])
def test_rasterize_equals_opencv_tpu_and_cv2(trial):
    verts, idxs, cols = _mesh(trial)
    H, W = 40, 48
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, 3] = [0.1, -0.2, 0.3]
    for shading in range(3):
        for culling in range(3):
            for gl in range(2):
                st = [m.TriangleRasterizeSettings().setShadingType(shading).setCullingMode(culling)
                      .setGlCompatibleMode(gl) for m in (tcv, jcv)]
                args = (verts, idxs, cols, np.zeros((H, W, 3), np.float32),
                        np.full((H, W), 50.0, np.float32), w2c, np.deg2rad(55.0), 0.1, 50.0)
                got = tcv.triangleRasterize(*args, st[0])
                want = jcv.triangleRasterize(*args, st[1])
                _eq(got[0].numpy(), want[0])
                _eq(got[1].numpy(), want[1])
    _eq(tcv.triangleRasterizeDepth(verts, idxs, torch.full((H, W), 50.0), w2c, 1.0, 0.1, 50.0)
        .numpy(), jcv.triangleRasterizeDepth(verts, idxs, np.full((H, W), 50.0, np.float32), w2c,
                                             1.0, 0.1, 50.0))
    _eq(tcv.triangleRasterizeColor(verts, idxs, cols, np.zeros((H, W, 3), np.float32), w2c, 1.0,
                                   0.1, 50.0).numpy(),
        jcv.triangleRasterizeColor(verts, idxs, cols, np.zeros((H, W, 3), np.float32), w2c, 1.0,
                                   0.1, 50.0))
    args = (verts, idxs, cols, np.zeros((H, W, 3), np.float32), np.full((H, W), 50.0, np.float32),
            np.eye(4, dtype=np.float32), np.deg2rad(55.0), 0.1, 50.0)
    ref_cb, ref_db = cv2.triangleRasterize(*args)
    got_cb, got_db = (a.numpy() for a in tcv.triangleRasterize(*args))
    m = ref_db < 49
    assert np.array_equal(m, got_db < 49)
    if m.any():
        assert np.abs(ref_db[m] - got_db[m]).max() < 1e-3
        assert np.abs(ref_cb[m] - got_cb[m]).max() < 1e-5
    for n in ("RASTERIZE_SHADING_SHADED", "RASTERIZE_CULLING_CCW", "RASTERIZE_COMPAT_INVDEPTH"):
        assert getattr(tcv, n) == getattr(jcv, n) == getattr(cv2, n)
