"""Multi-device scaling: batch data parallelism and spatial sharding over
``torch.distributed`` (twin of ``opencv_tpu/parallel/mesh.py``).

The JAX package lays a ``("data", "sp")`` ``jax.sharding.Mesh`` over its
chips and runs ``shard_map`` programs with ``ppermute`` halo exchanges.
Here each process is one rank of an initialised process group (gloo on the
CPU, NCCL on CUDA devices), the mesh is a 2-D ``DeviceMesh`` with the same
axis names, and every function takes this rank's **local block** of the
global batch and returns its local block:

- **Batch DP**: N is split over "data"; every op of the package is
  per-image, so :func:`sharded_pipeline` runs with no communication.
- **Spatial sharding (SP)**: H is split over "sp"; a stencil exchanges
  halo rows with its ring neighbours on the sp group in one
  ``batch_isend_irecv``, takes the global border rule at the outer shards
  (``core/borders.py::border_interpolate``), and runs the single-device
  filter on the halo-extended rows: on a CUDA shard the ``sep_filter``
  kernel through its dispatch registration, on a CPU shard its plain
  version.  With one shard on the sp axis there is no neighbour: the
  border rule gives the halo and nothing is sent.
- **Reductions**: ``all_reduce`` over the sp group, then the data group.

There is no jit to wrap: :func:`pipeline` returns the function as it is.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import constants as K
from ..core.arrays import as_tensor, to_device
from ..core.borders import border_interpolate
from ..core.dispatch import lookup
from ..kernels.sepfilter import sep_filter_int_plain
from ..ops.filter import gaussian_kernel_bitexact, gaussian_kernel_fixedpoint_ed
from ..ops.hist import hist_fixed
from ..ops.thresh import _otsu_from_hist

__all__ = ["make_mesh", "shard_batch", "pipeline", "sharded_pipeline",
           "spatial_gaussian_blur", "spatial_sep_filter",
           "sharded_min_max", "sharded_hist", "sharded_otsu"]


def make_mesh(n_data: int = None, n_sp: int = 1, devices=None) -> DeviceMesh:
    """A ("data", "sp") mesh over the ranks of the initialised process
    group, rank r at (r // n_sp, r % n_sp).  `devices` is the device type
    ("cuda" or "cpu"); by default "cuda" under NCCL, else "cpu"."""
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_sp
    if n_data * n_sp != world:
        raise ValueError(f"a {n_data}x{n_sp} mesh needs {n_data * n_sp} ranks, not {world}")
    if devices is None:
        devices = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(devices, (n_data, n_sp), mesh_dim_names=("data", "sp"))


def _device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _block(n: int, parts: int, i: int) -> slice:
    if n % parts:
        raise ValueError(f"{n} does not split into {parts} equal blocks")
    return slice(i * n // parts, (i + 1) * n // parts)


def shard_batch(x, mesh: DeviceMesh, sp: bool = True):
    """This rank's block of the global (N, H, W, C) batch `x` on its
    device: N split over "data" and, with `sp`, H over "sp"."""
    x = as_tensor(x)
    blk = x[_block(x.shape[0], mesh.size(0), mesh.get_local_rank("data"))]
    if sp:
        blk = blk[:, _block(x.shape[1], mesh.size(1), mesh.get_local_rank("sp"))]
    return to_device(blk.contiguous(), _device(mesh))


def pipeline(fn):
    """A whole image pipeline as one callable (the JAX package jit-compiles
    it; the port runs it eagerly)."""
    return fn


def sharded_pipeline(fn, mesh: DeviceMesh):
    """`fn` over the mesh's data axis: each 4-D argument (the global batch)
    becomes this rank's block of images, whole in H; the result is this
    rank's block of the output.  The ops are per-image, so no collective
    runs."""

    @functools.wraps(fn)
    def wrapped(*args):
        args = tuple(shard_batch(a, mesh, sp=False) if getattr(a, "ndim", 0) == 4 else a
                     for a in args)
        return fn(*args)

    return wrapped


def _ring(x, halo: int, group):
    """The rows the ring neighbours send: (from the previous shard's last
    `halo` rows, from the next shard's first), with the ring wrapping at
    the ends.  Sends and receives go in one ``batch_isend_irecv``."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    prev = dist.get_global_rank(group, (idx - 1) % n)
    nxt = dist.get_global_rank(group, (idx + 1) % n)
    top, bot = x[:, :halo].contiguous(), x[:, -halo:].contiguous()
    recv_top, recv_bot = torch.empty_like(bot), torch.empty_like(top)
    ops = [dist.P2POp(dist.isend, bot, nxt, group, tag=0),
           dist.P2POp(dist.irecv, recv_top, prev, group, tag=0),
           dist.P2POp(dist.isend, top, prev, group, tag=1),
           dist.P2POp(dist.irecv, recv_bot, nxt, group, tag=1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv_top, recv_bot


def _halo_exchange_rows(x, halo: int, group):
    """x: (N, H_local, W, C) shard.  Returns x extended with its
    neighbours' `halo` boundary rows, (N, H_local + 2*halo, W, C); the
    outermost shards take zeros (the global border of
    :func:`spatial_gaussian_blur`)."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    zeros = torch.zeros_like(x[:, :halo])
    if n == 1:
        return torch.cat([zeros, x, zeros], dim=1)
    recv_top, recv_bot = _ring(x, halo, group)
    return torch.cat([zeros if idx == 0 else recv_top, x,
                      zeros if idx == n - 1 else recv_bot], dim=1)


def _halo_exchange_bordered(x, halo: int, group, border_type: int, H_global: int,
                            border_value=0):
    """Halo exchange honouring the global image border.

    Interior seams take the neighbours' rows; the outermost shards take
    their outer halo from the border rule (`cv::borderInterpolate`,
    core/src/copy.cpp:748) applied to the GLOBAL image: those source rows
    always lie in the edge shard itself for halo <= H_local.  BORDER_WRAP
    is the ring's own wraparound.  With one shard the rule gives both
    halos and nothing is sent."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    H_local = x.shape[1]
    bt = border_type & ~K.BORDER_ISOLATED
    if n > 1:
        recv_top, recv_bot = _ring(x, halo, group)
    if bt == K.BORDER_CONSTANT:
        fill = torch.full_like(x[:, :halo], border_value)
        top = fill if idx == 0 else recv_top
        bot = fill if idx == n - 1 else recv_bot
    elif bt == K.BORDER_WRAP and n > 1:
        top, bot = recv_top, recv_bot
    else:
        ti = [border_interpolate(j, H_global, bt) for j in range(-halo, 0)]
        bi = [border_interpolate(H_global + j, H_global, bt) - (H_global - H_local)
              for j in range(halo)]
        if max(ti) >= H_local or min(bi) < 0:
            raise ValueError(f"halo {halo} is larger than the shard height {H_local}")
        top = x[:, ti] if idx == 0 else recv_top
        bot = x[:, bi] if idx == n - 1 else recv_bot
    return torch.cat([top, x, bot], dim=1)


def _shard_filter(xh, kx, ky, halo: int, border: int):
    """The Q8·Q8 separable MAC of the halo-extended shard, ``(v + 2^15) >>
    16`` saturated to u8, with the halo rows cut off; columns take
    `border` (W is not sharded).  A CUDA shard launches ``sep_filter``
    through its registration, as GaussianBlur does."""
    kern = lookup("sep_filter_u8", xh.device, dtype="uint8", kw=len(kx), kh=len(ky),
                  channels=xh.shape[3], border=border, shift=16)
    y = (kern(xh, kx, ky) if kern is not None
         else sep_filter_int_plain(xh, kx, ky, shift=16, border=border))
    return y[:, halo:y.shape[1] - halo]


def _q8_taps(k: int, sigma: float):
    return gaussian_kernel_fixedpoint_ed(gaussian_kernel_bitexact(k, sigma), 8)


def _check_u8(x):
    x = as_tensor(x)
    if x.dtype != torch.uint8 or x.ndim != 4:
        raise ValueError(f"expected an (N,H,W,C) uint8 shard, got {tuple(x.shape)} {x.dtype}")
    return x


def spatial_sep_filter(imgs, ksize, sigma, mesh: DeviceMesh, border=None):
    """Bit-exact Gaussian filtering of this rank's (N, H_local, W, C) u8
    block, H sharded over "sp", honouring all 5 border modes at the global
    image edges: the halo exchange, then the Q8 fixed-point separable
    kernel of the single-device path (`GaussianBlurFixedPoint`,
    smooth.dispatch.cpp:720)."""
    x = _check_u8(imgs)
    if border is None:
        border = K.BORDER_DEFAULT
    kw, kh = ksize
    kq_x = _q8_taps(kw, sigma)
    kq_y = kq_x if kh == kw else _q8_taps(kh, sigma)
    r = kh // 2
    H_global = x.shape[1] * mesh.size(1)
    xh = _halo_exchange_bordered(x, r, mesh.get_group("sp"), border, H_global)
    return _shard_filter(xh, kq_x, kq_y, r, border)


def spatial_gaussian_blur(imgs, ksize, sigma, mesh: DeviceMesh):
    """GaussianBlur of this rank's u8 block with H sharded over "sp" and a
    zero border (BORDER_CONSTANT, 0) on every side of the global image:
    zero halos at the outer shards, zero columns at W's ends.  Bit-exact
    with the single-device GaussianBlur under that border."""
    x = _check_u8(imgs)
    kq = _q8_taps(ksize[0], sigma)
    r = len(kq) // 2
    xh = _halo_exchange_rows(x, r, mesh.get_group("sp"))
    return _shard_filter(xh, kq, kq, r, K.BORDER_CONSTANT)


def _all_reduce(v, op, mesh: DeviceMesh):
    """`v` reduced by `op` over every mesh axis (sp, then data)."""
    for axis in ("sp", "data"):
        dist.all_reduce(v, op=op, group=mesh.get_group(axis))
    return v


def sharded_min_max(imgs, mesh: DeviceMesh):
    """The global min and max of the sharded batch (0-dim tensors of its
    dtype), by MIN / MAX all-reduces — the sharded `cv::minMaxLoc`
    values."""
    x = as_tensor(imgs)
    wide = torch.float64 if x.is_floating_point() else torch.int64
    mn = _all_reduce(x.min().to(wide).reshape(1), dist.ReduceOp.MIN, mesh)
    mx = _all_reduce(x.max().to(wide).reshape(1), dist.ReduceOp.MAX, mesh)
    return mn[0].to(x.dtype), mx[0].to(x.dtype)


def sharded_hist(imgs, mesh: DeviceMesh):
    """The 256-bin int32 histogram of the sharded u8 batch: each shard's
    ``hist_fixed`` (one scatter), then a SUM all-reduce."""
    x = _check_u8(imgs)
    h = hist_fixed(x.to(torch.int32), 256).to(torch.int32)
    return _all_reduce(h, dist.ReduceOp.SUM, mesh)


def sharded_otsu(imgs, mesh: DeviceMesh):
    """Otsu's threshold of the sharded u8 batch: the summed histogram, then
    the port's exact scan of `threshold` (thresh.cpp getThreshVal_Otsu_8u,
    in f64 where the JAX package takes f32); an f64 0-dim tensor."""
    return _otsu_from_hist(sharded_hist(imgs, mesh))
