"""sep_filter's tile kernels (``csrc/sepfilter.cu``): the box route (kx all
one value, ky all one value) and the generic route, on the CPU.

- The plain version, which both routes are held to on the card, against the
  JAX package's Pallas ``sep_filter_int`` in interpret mode on equal taps:
  windows 9, 13, 23 and 31, kw != kh, every border with and without
  BORDER_ISOLATED, C = 1..4, u8 with a scale, i16 with a delta, negative
  taps.
- The port's boxFilter and adaptiveThreshold MEAN_C at windows 13 and 23
  against the JAX package's, and the box taps' plain version against the
  port's boxFilter (the card's path against the CPU's).
- The kernel source itself, compiled for the host with g++ against an
  emulation of the CUDA features it uses (``tests/cuda_host_emu.py``: a
  block's threads are host threads that meet at each barrier; a cp.async is
  a memcpy done at its wait), at the tile kernels' block classes, held to
  the plain version.
"""

import ctypes
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import opencv_tpu as jcv
import opencv_tpu.constants as JK
from opencv_tpu.kernels.sepfilter import sep_filter_int as j_sep_filter_int

import opencv_tpu_torch as tcv
from opencv_tpu_torch.kernels import sepfilter as S
from opencv_tpu_torch.ops.filter import gaussian_kernel_bitexact, gaussian_kernel_fixedpoint_ed
import cuda_host_emu
from torch_threads import _one_torch_thread  # noqa: F401

CSRC = Path(S.__file__).resolve().parent.parent / "csrc"
BORDERS = [JK.BORDER_CONSTANT, JK.BORDER_REPLICATE, JK.BORDER_REFLECT, JK.BORDER_WRAP,
           JK.BORDER_REFLECT_101]


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _q8(k, sigma):
    return tuple(int(v) for v in gaussian_kernel_fixedpoint_ed(gaussian_kernel_bitexact(k, sigma), 8))


def _box(kw, kh, a=1, b=1):
    return (a,) * kw, (b,) * kh


def _both(x, kx, ky, **kw):
    """(Pallas in interpret mode, plain) of the same call."""
    jkw = dict(kw, out_dtype=jnp.int16) if kw.get("out_dtype") == torch.int16 else kw
    want = np.asarray(j_sep_filter_int(x, kx, ky, interpret=True, **jkw))
    return want, S.sep_filter_int_plain(torch.from_numpy(x), kx, ky, **kw).numpy()


# ---------------------------------------------------------------------------
# the plain version against the Pallas kernel, on box taps

@pytest.mark.parametrize("border", BORDERS)
def test_box_plain_equals_pallas_at_every_border(border):
    """Each border, without and with BORDER_ISOLATED: a 13 x 13 normalised
    box on C = 3 and a 9 x 15 box on C = 1 into u8."""
    bv = (9, 99, 199)
    x = _rand((2, 20, 37, 3), border)
    want, got = _both(x, *_box(13, 13), scale=1.0 / 169, border=border, border_value=bv)
    np.testing.assert_array_equal(got, want)
    x = _rand((1, 26, 41, 1), border + 10)
    want, got = _both(x, *_box(9, 15), scale=1.0 / 135, border=border | JK.BORDER_ISOLATED,
                      border_value=bv[:1])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,C", [(9, 4), (13, 2), (23, 1), (31, 3)])
def test_box_plain_equals_pallas_at_each_window(k, C):
    """u8 with the box's scale, and i16 unnormalised with a delta and
    negative taps (a = -2, b = 3), at windows 9, 13, 23 and 31."""
    x = _rand((1, 2 * k + 3, 2 * k + 5, C), k)
    want, got = _both(x, *_box(k, k), scale=1.0 / (k * k), border=JK.BORDER_REFLECT_101)
    np.testing.assert_array_equal(got, want)
    want, got = _both(x, *_box(k, k, -2, 3), delta=-7, out_dtype=torch.int16,
                      border=JK.BORDER_REPLICATE | JK.BORDER_ISOLATED)
    np.testing.assert_array_equal(got, want)


def test_box_plain_equals_pallas_when_kw_differs_from_kh():
    x = _rand((2, 30, 50, 2), 5)
    want, got = _both(x, *_box(23, 5, 1, -1), delta=100, out_dtype=torch.int16,
                      border=JK.BORDER_WRAP)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the functions of the objdetect path that reach the box route

@pytest.mark.parametrize("k", [13, 23])
def test_box_filter_and_adaptive_threshold_mean_equal_opencv_tpu(k):
    """ArUco's adaptive threshold (MEAN_C; boxFilter under BORDER_REPLICATE |
    BORDER_ISOLATED) and boxFilter at the box route's windows, against the
    JAX package; the box taps' plain version, which the card's route is
    held to, equals the port's CPU boxFilter."""
    x = _rand((2, 47, 61, 1), k)
    border = JK.BORDER_REPLICATE | JK.BORDER_ISOLATED
    got = tcv.boxFilter(torch.from_numpy(x), -1, (k, k), borderType=border)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcv.boxFilter(x, -1, (k, k),
                                                                        borderType=border)))
    plain = S.sep_filter_int_plain(torch.from_numpy(x), *_box(k, k), scale=1.0 / (k * k),
                                   border=border)
    np.testing.assert_array_equal(plain.numpy(), got.numpy())
    for method_c in (7.0, -3.0):
        want = np.asarray(jcv.adaptiveThreshold(x, 255, JK.ADAPTIVE_THRESH_MEAN_C,
                                                JK.THRESH_BINARY_INV, k, method_c))
        got = tcv.adaptiveThreshold(torch.from_numpy(x), 255, tcv.ADAPTIVE_THRESH_MEAN_C,
                                    tcv.THRESH_BINARY_INV, k, method_c)
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the kernel source on the host

@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """sepfilter.cu built for the host (tests/cuda_host_emu.py)."""
    fn = cuda_host_emu.build(CSRC / "sepfilter.cu", tmp_path_factory.mktemp("sepfilter_host"),
                             "opencv_sep_filter", 3)
    fn.argtypes = S.SEP_FILTER.argtypes
    return fn


def _host_run(fn, x, kx, ky, route, offset=0, shift=0, delta=0, scale=None,
              out_dtype=torch.uint8, border=JK.BORDER_REFLECT_101, border_value=0):
    """The kernel on host memory at `offset` bytes past a 16-byte boundary;
    returns (error, output)."""
    N, H, W, C = x.shape
    buf = np.zeros(x.size + 64, np.uint8)
    start = (-buf.ctypes.data) % 16 + 16 + offset
    buf[start:start + x.size] = x.reshape(-1)
    out = np.zeros(x.shape, np.int16 if out_dtype == torch.int16 else np.uint8)
    bval = list(np.broadcast_to(np.asarray(border_value, np.int64), (C,))) + [0] * (4 - C)
    err = fn(buf.ctypes.data + start, out.ctypes.data, N, H, W, C,
             (ctypes.c_int * len(kx))(*kx), len(kx), (ctypes.c_int * len(ky))(*ky), len(ky),
             shift, delta, int(scale is not None), scale or 0.0, border,
             (ctypes.c_int * 4)(*map(int, bval)), int(out_dtype == torch.int16), route, None)
    return err, out


def _check_host(fn, x, kx, ky, route, offset=0, **kw):
    err, got = _host_run(fn, x, kx, ky, route, offset, **kw)
    assert err == 0
    want = S.sep_filter_int_plain(torch.from_numpy(x), kx, ky, **kw).numpy()
    np.testing.assert_array_equal(got, want, err_msg=str((x.shape, len(kx), len(ky), offset, kw)))


# The tile kernels' block classes: a block is 256 output bytes of 32 rows, its
# window 64 bytes wider each side; rows of one window, rows across two and
# three blocks and one byte over and under them, W*C % 16 != 0 (and a base
# one byte off: the word-load staging), H of one block and one row more, a
# ragged last block of rows, a row narrower than the halo, a 1 x 1 image.
TILE_SHAPES = [(1, 40, 15, 1), (2, 33, 17, 1), (1, 9, 255, 1), (1, 34, 257, 1),
               (1, 12, 513, 1), (2, 40, 101, 3), (1, 39, 101, 4), (1, 33, 64, 2),
               (3, 5, 7, 3), (1, 1, 1, 1)]


@pytest.mark.parametrize("border", BORDERS)
def test_box_kernel_source_on_the_host_equals_plain(host_kernel, border):
    """Route 1 at every block class under each border, windows 9, 13, 23,
    31 and 9 x 15 in turn; by turns u8 with the box's scale on an aligned
    base, and i16 with negative taps and a delta on a base one byte off."""
    bv = (9, 99, 199, 250)
    for i, shape in enumerate(TILE_SHAPES):
        x = _rand(shape, border * 100 + i)
        kw_, kh_ = ((9, 9), (13, 13), (23, 23), (31, 31), (9, 15))[i % 5]
        kw = dict(border=border, border_value=bv[:shape[3]])
        if (i + border) % 2:
            _check_host(host_kernel, x, *_box(kh_, kw_, -3, 2), 1, offset=1, delta=-5,
                        out_dtype=torch.int16, **kw)
        else:
            _check_host(host_kernel, x, *_box(kw_, kh_), 1, scale=1.0 / (kw_ * kh_), **kw)


@pytest.mark.parametrize("border", [JK.BORDER_CONSTANT, JK.BORDER_WRAP, JK.BORDER_REFLECT_101])
def test_generic_kernel_source_on_the_host_equals_plain(host_kernel, border):
    """Route 0 at the block classes: Gaussian k13 into u8, and k9 x 23 or
    negative taps into i16, on an aligned base and one byte off by turns."""
    for i, shape in enumerate(TILE_SHAPES[::2]):
        x = _rand(shape, border * 10 + i)
        kw = dict(border=border, border_value=(7, 70, 170, 255)[:shape[3]])
        _check_host(host_kernel, x, _q8(13, 2.2), _q8(13, 2.2), 0, offset=i % 2, shift=16, **kw)
        if i % 2:
            _check_host(host_kernel, x, _q8(9, 1.5), _q8(23, 4.0), 0, shift=16, **kw)
        else:
            _check_host(host_kernel, x, (-1, -2, 0, 2, 1), (1, 4, 6, 4, 1, 0, 0, 0, 0), 0,
                        offset=1, delta=3, out_dtype=torch.int16, **kw)


def test_kernel_entry_on_the_host_refuses_taps_its_route_does_not_take(host_kernel):
    x = _rand((1, 8, 16, 1), 0)
    assert _host_run(host_kernel, x, (1, 1, 2), (1, 1, 1), 1)[0] != 0  # kx not equal
    assert _host_run(host_kernel, x, (1,) * 9, (1, 2) * 4 + (1,), 1)[0] != 0  # ky not equal
    assert _host_run(host_kernel, x, (1,) * 9, (1,) * 9, 5)[0] != 0  # k9 on the template
    assert _host_run(host_kernel, x, (1,) * 9, (1,) * 9, 1)[0] == 0
    assert _host_run(host_kernel, x, (1,) * 9, (1,) * 9, 0)[0] == 0
