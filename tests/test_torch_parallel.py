"""The port's ``parallel`` (torch.distributed) on gloo over the CPU.

One spawn per world size runs every scenario of
``entry.run_mesh_scenarios`` in its ranks (2 ranks on a 1×2 mesh, 4 on a
2×2 mesh of ("data", "sp")); the ranks run the port's own function, so
they import neither this module nor jax.  The gathered outputs must equal,
exactly, the port's single-process GaussianBlur / threshold / calcHist /
minMaxLoc and the DP step on the whole batch, and the JAX package's
``opencv_tpu.parallel`` functions run here on a 1×1 CPU mesh over the same
global arrays.  ``dryrun_multichip(4)`` passes on gloo."""

import numpy as np
import pytest
import torch

import opencv_tpu_torch as tcv
from opencv_tpu_torch import entry as E

MESHES = {"1x2": (1, 2), "2x2": (2, 2)}


@pytest.fixture(scope="module", params=list(MESHES))
def mesh_run(request, tmp_path_factory):
    n_data, n_sp = MESHES[request.param]
    out = tmp_path_factory.mktemp("mesh") / f"{request.param}.npz"
    return n_data, n_sp, E.run_mesh_scenarios(n_data, n_sp, str(out))


def _port_reference(n_data, n_sp):
    bgr, gray = E.make_mesh_batch(n_data, n_sp)
    t = torch.from_numpy(gray)
    want = {"dp_step": E._dp_step(n_sp)(torch.from_numpy(bgr)).numpy()}
    for k in (3, 5):
        want[f"blur{k}"] = tcv.GaussianBlur(t, (k, k), 1.1, borderType=tcv.BORDER_CONSTANT)
        for b in E.MESH_BORDERS:
            if b != tcv.BORDER_WRAP:   # GaussianBlur refuses WRAP, as cv2 does
                want[f"sep{k}_{b}"] = tcv.GaussianBlur(t, (k, k), 1.1, borderType=b)
    flat = t.reshape(-1, t.shape[2])
    mn, mx, _, _ = tcv.minMaxLoc(flat)
    want["min_max"] = np.array([mn, mx])
    want["hist"] = np.asarray(tcv.calcHist([flat], [0], None, [256], [0, 256])).reshape(-1)
    want["otsu"] = np.array([float(tcv.threshold(t, 0, 255,
                                                 tcv.THRESH_BINARY | tcv.THRESH_OTSU)[0])])
    return {k: np.asarray(v) for k, v in want.items()}


def _jax_reference(n_data, n_sp):
    import jax.numpy as jnp

    import opencv_tpu as jcv
    from opencv_tpu import parallel as P

    bgr, gray = E.make_mesh_batch(n_data, n_sp)
    mesh = P.make_mesh(1, 1)

    def step(x):
        g = jcv.cvtColor(x, jcv.COLOR_BGR2GRAY)
        return jcv.resize(jcv.GaussianBlur(g, (3, 3), 0), (32, 16 * n_sp))

    want = {"dp_step": P.sharded_pipeline(step, mesh)(jnp.asarray(bgr))}
    for k in (3, 5):
        want[f"blur{k}"] = P.spatial_gaussian_blur(jnp.asarray(gray), (k, k), 1.1, mesh)
        for b in E.MESH_BORDERS:
            want[f"sep{k}_{b}"] = P.spatial_sep_filter(jnp.asarray(gray), (k, k), 1.1, mesh,
                                                       border=b)
    want["min_max"] = np.array([int(v) for v in P.sharded_min_max(jnp.asarray(gray), mesh)])
    want["hist"] = P.sharded_hist(jnp.asarray(gray), mesh)
    want["otsu"] = np.array([float(P.sharded_otsu(jnp.asarray(gray), mesh))])
    return {k: np.asarray(v) for k, v in want.items()}


def test_mesh_equals_the_single_process_port(mesh_run):
    n_data, n_sp, got = mesh_run
    want = _port_reference(n_data, n_sp)
    assert set(want) <= set(got)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g.astype(np.float64), w.astype(np.float64), err_msg=name)
    # the kernel size and the border reach the outputs
    assert not np.array_equal(got["sep5_4"], got["sep3_4"])
    assert not np.array_equal(got["sep5_4"], got["sep5_0"])


def test_mesh_equals_opencv_tpu_parallel(mesh_run):
    n_data, n_sp, got = mesh_run
    want = _jax_reference(n_data, n_sp)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g.astype(np.float64), w.astype(np.float64), err_msg=name)


def test_world_size_one_in_process(tmp_path):
    """One gloo rank in this process, the case the card runs: no neighbour,
    so the border rule gives the halos and nothing is sent; WRAP is held to
    the plain filter, the rest to GaussianBlur."""
    import torch.distributed as dist

    from opencv_tpu_torch import parallel as P
    from opencv_tpu_torch.kernels.sepfilter import sep_filter_int_plain
    from opencv_tpu_torch.ops.filter import gaussian_kernel_bitexact, \
        gaussian_kernel_fixedpoint_ed

    _, gray = E.make_mesh_batch(1, 1)
    t = torch.from_numpy(gray)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        mesh = P.make_mesh()
        assert mesh.mesh_dim_names == ("data", "sp") and tuple(mesh.mesh.shape) == (1, 1)
        local = P.shard_batch(gray, mesh)
        assert torch.equal(local, t)
        for k in (3, 5, 7):
            taps = gaussian_kernel_fixedpoint_ed(gaussian_kernel_bitexact(k, 1.1), 8)
            assert torch.equal(P.spatial_gaussian_blur(local, (k, k), 1.1, mesh),
                               tcv.GaussianBlur(t, (k, k), 1.1, borderType=tcv.BORDER_CONSTANT))
            for b in E.MESH_BORDERS:
                want = (sep_filter_int_plain(t, taps, taps, shift=16, border=b)
                        if b == tcv.BORDER_WRAP else tcv.GaussianBlur(t, (k, k), 1.1,
                                                                      borderType=b))
                assert torch.equal(P.spatial_sep_filter(local, (k, k), 1.1, mesh, border=b),
                                   want), (k, b)
        assert float(P.sharded_otsu(local, mesh)) == float(
            tcv.threshold(t, 0, 255, tcv.THRESH_BINARY | tcv.THRESH_OTSU)[0])
        mn, mx = P.sharded_min_max(local, mesh)
        assert (mn.dtype, int(mn), int(mx)) == (torch.uint8, int(t.min()), int(t.max()))
        with pytest.raises(ValueError):
            P.make_mesh(2, 1)
        with pytest.raises(ValueError):
            P.sharded_hist(local.to(torch.int16), mesh)
    finally:
        dist.destroy_process_group()


def test_dryrun_multichip_on_gloo():
    E.dryrun_multichip(4)


def test_parallel_surface():
    from opencv_tpu_torch import parallel

    for name in ("make_mesh", "shard_batch", "pipeline", "sharded_pipeline",
                 "spatial_gaussian_blur", "spatial_sep_filter", "sharded_min_max",
                 "sharded_hist", "sharded_otsu", "setParallelForBackend"):
        assert callable(getattr(parallel, name)), name
    assert tcv.parallel is parallel
    assert parallel.setParallelForBackend("tbb") is False
    f = lambda x: x  # noqa: E731
    assert parallel.pipeline(f) is f
