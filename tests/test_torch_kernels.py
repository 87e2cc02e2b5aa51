"""The port's kernel modules on the CPU: each plain version against the JAX
package's Pallas kernel in interpret mode (as tests/test_kernels.py runs
it), and the wrappers' CPU routing.  The CUDA kernels themselves are held
against these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from common import cv2

import jax.numpy as jnp

import opencv_tpu.constants as JK
from opencv_tpu.kernels.fused_preproc import fused_gray_gauss5_down2 as j_fused
from opencv_tpu.kernels.fused_preproc import gauss5_down2_u8 as j_gauss5_down2
from opencv_tpu.kernels.sepfilter import pyr_down_u8 as j_pyr_down_u8
from opencv_tpu.kernels.sepfilter import sep_filter_int as j_sep_filter_int
from opencv_tpu.ops.filter import gaussian_kernel_bitexact, gaussian_kernel_fixedpoint_ed

import opencv_tpu_torch as tcv
from opencv_tpu_torch.kernels import KERNELS
from opencv_tpu_torch.kernels.fused_preproc import (
    fused_gray_gauss5_down2, fused_gray_gauss5_down2_plain, gauss5_down2_u8,
    gauss5_down2_u8_plain)
from opencv_tpu_torch.kernels.sepfilter import (
    SEP_FILTER, pyr_down_u8, pyr_down_u8_plain, sep_filter_int, sep_filter_int_plain,
    sep_filter_route)
from torch_threads import _one_torch_thread  # noqa: F401

# test_kernels.py's Gaussian cases: (H, W, C, ksize, sigma, border)
GAUSS_CASES = [
    (100, 150, 1, 5, 0.0, JK.BORDER_REFLECT_101),
    (64, 200, 3, 5, 1.5, JK.BORDER_REPLICATE),
    (130, 257, 1, 9, 2.0, JK.BORDER_CONSTANT),
    (33, 65, 3, 3, 0.8, JK.BORDER_WRAP),
    (128, 130, 1, 31, 5.0, JK.BORDER_REFLECT),
]


def _q8(k, sigma):
    return tuple(int(v) for v in gaussian_kernel_fixedpoint_ed(gaussian_kernel_bitexact(k, sigma), 8))


@pytest.mark.parametrize("case", GAUSS_CASES, ids=[str(c) for c in GAUSS_CASES])
def test_sep_filter_gaussian_vs_pallas(case):
    H, W, C, k, sigma, border = case
    x = np.random.default_rng(H + W).integers(0, 256, (2, H, W, C), np.uint8)
    kq = _q8(k, sigma)
    want = np.asarray(j_sep_filter_int(x, kq, kq, shift=16, border=border, interpret=True))
    got = sep_filter_int_plain(torch.from_numpy(x), kq, kq, shift=16, border=border)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sep_filter_sobel_i16_vs_pallas():
    x = np.random.default_rng(4).integers(0, 256, (2, 70, 90, 1), np.uint8)
    want = np.asarray(j_sep_filter_int(x, (-1, 0, 1), (1, 2, 1), shift=0,
                                       out_dtype=jnp.int16, interpret=True))
    got = sep_filter_int_plain(torch.from_numpy(x), (-1, 0, 1), (1, 2, 1), shift=0,
                               out_dtype=torch.int16)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,border", [(3, JK.BORDER_REFLECT_101), (9, JK.BORDER_REPLICATE)])
def test_sep_filter_box_scale_vs_pallas(k, border):
    x = np.random.default_rng(4).integers(0, 256, (2, 70, 90, 1), np.uint8)
    ones = (1,) * k
    want = np.asarray(j_sep_filter_int(x, ones, ones, shift=0, scale=1.0 / (k * k),
                                       out_dtype=jnp.uint8, border=border, interpret=True))
    got = sep_filter_int_plain(torch.from_numpy(x), ones, ones, scale=1.0 / (k * k),
                               border=border)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sep_filter_constant_per_channel_and_delta_vs_pallas():
    x = np.random.default_rng(6).integers(0, 256, (1, 21, 34, 3), np.uint8)
    kq = _q8(7, 1.2)
    want = np.asarray(j_sep_filter_int(x, kq, _q8(3, 0.0), shift=16, delta=3,
                                       border=JK.BORDER_CONSTANT, border_value=(5, 99, 250),
                                       interpret=True))
    got = sep_filter_int_plain(torch.from_numpy(x), kq, _q8(3, 0.0), shift=16, delta=3,
                               border=JK.BORDER_CONSTANT, border_value=(5, 99, 250))
    np.testing.assert_array_equal(got.numpy(), want)


# The CUDA kernels' block classes (csrc/sepfilter.cu, csrc/pyrdown.cu): a
# row is W*C bytes, a warp covers 512 output bytes in 16-byte words, strips
# of rows; k = 3, 5 and 7 take sep_filter's template, which stages a row
# whose W*C is not a multiple of 16 from its granules at an offset, other k
# the tile kernels (tests/test_torch_sepfilter_box.py), which stage such a
# row by word loads at its own alignment.  The plain
# versions, which the kernels are held to on the card, are held here to the
# Pallas kernels at the same shapes: (name, (N, H, W, C)).
SEP_CLASS_SHAPES = [
    ("W 15", (2, 40, 15, 1)), ("W 17", (2, 40, 17, 1)), ("W 511", (2, 33, 511, 1)),
    ("WC%16 C3", (2, 40, 101, 3)), ("WC%16 C4", (2, 40, 101, 4)),
    ("H 127 C2", (1, 127, 160, 2)),
]
ALL_BORDERS = [JK.BORDER_CONSTANT, JK.BORDER_REPLICATE, JK.BORDER_REFLECT, JK.BORDER_WRAP,
               JK.BORDER_REFLECT_101]


@pytest.mark.parametrize("border", ALL_BORDERS)
@pytest.mark.parametrize("k", [3, 5, 7, 31])
def test_sep_filter_block_classes_vs_pallas(k, border):
    kq = _q8(k, 0.0 if k < 7 else 1.0 + k / 8)
    for name, shape in SEP_CLASS_SHAPES:
        if k == 31 and shape[2] * shape[3] > 600:
            continue  # the generic k = 31 path on the narrow shapes
        x = np.random.default_rng(k * 100 + border * 10 + shape[2]).integers(0, 256, shape, np.uint8)
        bv = (9, 99, 199, 250)[:shape[3]]
        want = np.asarray(j_sep_filter_int(x, kq, kq, shift=16, border=border, border_value=bv,
                                           interpret=True))
        got = sep_filter_int_plain(torch.from_numpy(x), kq, kq, shift=16, border=border,
                                   border_value=bv)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


@pytest.mark.parametrize("border", ALL_BORDERS)
def test_sep_filter_sobel_i16_block_classes_vs_pallas(border):
    for shape in ((2, 40, 17, 1), (2, 40, 101, 3)):
        x = np.random.default_rng(border + shape[3]).integers(0, 256, shape, np.uint8)
        want = np.asarray(j_sep_filter_int(x, (-1, 0, 1), (1, 2, 1), shift=0, out_dtype=jnp.int16,
                                           border=border, interpret=True))
        got = sep_filter_int_plain(torch.from_numpy(x), (-1, 0, 1), (1, 2, 1),
                                   out_dtype=torch.int16, border=border)
        np.testing.assert_array_equal(got.numpy(), want)


# Sobel ksize 7, (kx, ky) of dx = 1 and of dy = 1 (getDerivKernels): the
# template at K = 7 with negative taps, into i16
SOBEL7 = (((-1, -4, -5, 0, 5, 4, 1), (1, 6, 15, 20, 15, 6, 1)),
          ((1, 6, 15, 20, 15, 6, 1), (-1, -4, -5, 0, 5, 4, 1)))


@pytest.mark.parametrize("border", ALL_BORDERS)
def test_sep_filter_sobel7_i16_vs_pallas(border):
    for shape in ((2, 40, 101, 3), (2, 40, 17, 1)):
        x = np.random.default_rng(border + shape[2]).integers(0, 256, shape, np.uint8)
        bv = (9, 99, 199)[:shape[3]]
        for kx, ky in SOBEL7:
            want = np.asarray(j_sep_filter_int(x, kx, ky, shift=0, out_dtype=jnp.int16,
                                               border=border, border_value=bv, interpret=True))
            got = sep_filter_int_plain(torch.from_numpy(x), kx, ky, out_dtype=torch.int16,
                                       border=border, border_value=bv)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=str((shape, kx)))


@pytest.mark.parametrize("kx,ky,route", [
    (_q8(7, 2.0), _q8(7, 2.0), 7),                        # ORB's blur: sum 256
    (*SOBEL7[0], 7), (*SOBEL7[1], 7),                     # Sobel ksize 7
    (tuple(2 * v for v in _q8(7, 2.0)),) * 2 + (0,),      # sum 512: the sums would carry
    (_q8(7, 2.0), _q8(5, 1.0), 0),                        # kw != kh
    (_q8(5, 1.0), _q8(7, 2.0), 0),
    (_q8(9, 2.0), _q8(9, 2.0), 0),                        # k = 9
    (_q8(3, 0.0), _q8(3, 0.0), 3), ((-1, 0, 1), (1, 2, 1), 3),
    (_q8(5, 1.3), _q8(5, 1.3), 5),
    *(((1,) * k, (1,) * k, 1) for k in (9, 13, 23, 31)),  # boxes over 7: the box route
    ((1,) * 9, (1,) * 15, 1), ((2,) * 15, (2,) * 9, 1),   # kw != kh
    ((-3,) * 13, (5,) * 13, 1), ((0,) * 9, (-1,) * 9, 1),  # equal negative or zero taps
    *(((1,) * k, (1,) * k, k) for k in (3, 5, 7)),        # small boxes stay on the template
    (_q8(13, 2.0), _q8(13, 2.0), 0),                      # Gaussian k13: the generic kernel
    ((1,) * 9 + (2,), (1,) * 10, 0),                      # one tap off
])
def test_sep_filter_route(kx, ky, route):
    assert sep_filter_route(kx, ky) == route


def test_sep_filter_and_pyr_down_storage_offset_vs_pallas():
    # x[1:] of a batch is contiguous with a storage offset of one image,
    # which the kernels' 16-byte alignment test sees
    base = np.random.default_rng(8).integers(0, 256, (3, 41, 63, 1), np.uint8)
    view = torch.from_numpy(base)[1:].contiguous()
    assert view.storage_offset() == 41 * 63
    kq = _q8(5, 0.0)
    want = np.asarray(j_sep_filter_int(base[1:], kq, kq, shift=16, interpret=True))
    np.testing.assert_array_equal(sep_filter_int_plain(view, kq, kq, shift=16).numpy(), want)
    np.testing.assert_array_equal(pyr_down_u8_plain(view).numpy(),
                                  np.asarray(j_pyr_down_u8(base[1:], interpret=True)))


# pyr_down's block classes: a warp strip is 4 output rows (11 input rows) by
# 512 output pixels (C = 1), rows staged in 16-byte words; odd H and W
# around those widths and rows that are not a multiple of 16 bytes
PYR_CLASS_SHAPES = [(2, 33, 1025, 1), (2, 31, 1023, 1), (2, 65, 17, 1), (2, 33, 343, 3),
                    (2, 35, 257, 4), (2, 34, 130, 2)]


@pytest.mark.parametrize("border", [JK.BORDER_REPLICATE, JK.BORDER_REFLECT, JK.BORDER_WRAP,
                                    JK.BORDER_REFLECT_101])
@pytest.mark.parametrize("shape", PYR_CLASS_SHAPES, ids=[str(s) for s in PYR_CLASS_SHAPES])
def test_pyr_down_block_classes_vs_pallas(shape, border):
    x = np.random.default_rng(shape[1] * shape[2] + border).integers(0, 256, shape, np.uint8)
    want = np.asarray(j_pyr_down_u8(x, border=border, interpret=True))
    np.testing.assert_array_equal(pyr_down_u8_plain(torch.from_numpy(x), border).numpy(), want)


@pytest.mark.parametrize("sigma", [0.0, 1.5])
def test_fused_gray_gauss5_down2_vs_pallas(sigma):
    imgs = np.random.default_rng(0).integers(0, 256, (2, 192, 256, 3), np.uint8)
    want = np.asarray(j_fused(imgs, sigma, interpret=True))
    got = fused_gray_gauss5_down2_plain(torch.from_numpy(imgs), sigma)
    np.testing.assert_array_equal(got.numpy(), want)
    # the public entry on a CPU tensor is the plain version
    np.testing.assert_array_equal(tcv.fusedPreprocessGrayBlurDown2(imgs, sigma).numpy(), want)


def test_gauss5_down2_gray_vs_pallas():
    gray = np.random.default_rng(1).integers(0, 256, (2, 66, 130), np.uint8)
    want = np.asarray(j_gauss5_down2(gray, 1.1, interpret=True))
    got = gauss5_down2_u8_plain(torch.from_numpy(gray), 1.1)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(gauss5_down2_u8(gray, 1.1).numpy(), want)


def test_cpu_tensors_take_the_plain_version():
    before = [k.launches for k in KERNELS]
    routes = dict(SEP_FILTER.routes)
    x = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (1, 8, 10, 3), np.uint8))
    kq = _q8(5, 0.0)
    assert torch.equal(sep_filter_int(x, kq, kq, shift=16),
                       sep_filter_int_plain(x, kq, kq, shift=16))
    assert torch.equal(fused_gray_gauss5_down2(x), fused_gray_gauss5_down2_plain(x))
    assert torch.equal(pyr_down_u8(x), pyr_down_u8_plain(x))
    assert [k.launches for k in KERNELS] == before
    assert SEP_FILTER.routes == routes


def test_fused_rejects_odd_sizes_and_wrong_inputs():
    with pytest.raises(ValueError, match="even"):
        fused_gray_gauss5_down2(torch.zeros((1, 5, 8, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="even"):
        gauss5_down2_u8(torch.zeros((1, 6, 7), dtype=torch.uint8))
    with pytest.raises(ValueError):
        fused_gray_gauss5_down2(torch.zeros((1, 6, 8, 4), dtype=torch.uint8))
    with pytest.raises(ValueError):
        sep_filter_int(torch.zeros((1, 6, 8, 1), dtype=torch.int16), (1,), (1,))


# test_kernels.py's pyrDown cases (REFLECT_101), plus C=4, the other three
# borders cv::pyrDown takes, and the JAX predicate's 16x16 minimum:
# (C, H, W, border)
PYR_CASES = [
    (1, 40, 52, JK.BORDER_REFLECT_101), (1, 41, 53, JK.BORDER_REFLECT_101),
    (3, 37, 45, JK.BORDER_REFLECT_101), (4, 33, 47, JK.BORDER_REFLECT_101),
    (1, 41, 53, JK.BORDER_REPLICATE), (4, 40, 52, JK.BORDER_REPLICATE),
    (3, 37, 45, JK.BORDER_WRAP), (1, 40, 53, JK.BORDER_WRAP),
    (3, 16, 16, JK.BORDER_REFLECT), (4, 17, 31, JK.BORDER_REFLECT),
]


@pytest.mark.parametrize("case", PYR_CASES, ids=[str(c) for c in PYR_CASES])
def test_pyr_down_vs_pallas_and_cv2(case):
    C, H, W, border = case
    x = np.random.default_rng(H * W + C).integers(0, 256, (2, H, W, C), np.uint8)
    want = np.asarray(j_pyr_down_u8(x, border=border, interpret=True))
    got = pyr_down_u8_plain(torch.from_numpy(x), border).numpy()
    np.testing.assert_array_equal(got, want)
    # the wrapper on a CPU tensor is the plain version
    np.testing.assert_array_equal(pyr_down_u8(torch.from_numpy(x), border).numpy(), want)
    for i in range(2):
        ref = cv2.pyrDown(x[i] if C > 1 else x[i, ..., 0], borderType=border)
        np.testing.assert_array_equal(got[i] if C > 1 else got[i, ..., 0], ref)


# below the JAX kernel's 16x16 minimum, where the CUDA kernel (whose
# predicate has no minimum) is held to this plain version: (C, H, W)
PYR_TINY = [(1, 1, 1), (2, 2, 3), (3, 5, 7), (4, 9, 15), (1, 15, 2)]


@pytest.mark.parametrize("border", [JK.BORDER_REFLECT_101, JK.BORDER_REPLICATE,
                                    JK.BORDER_REFLECT, JK.BORDER_WRAP])
@pytest.mark.parametrize("case", PYR_TINY, ids=[str(c) for c in PYR_TINY])
def test_pyr_down_plain_tiny_sizes_vs_cv2(case, border):
    C, H, W = case
    x = np.random.default_rng(H * W + C + border).integers(0, 256, (2, H, W, C), np.uint8)
    got = pyr_down_u8_plain(torch.from_numpy(x), border).numpy()
    assert got.shape == (2, (H + 1) // 2, (W + 1) // 2, C)
    for i in range(2):
        ref = cv2.pyrDown(x[i] if C > 1 else x[i, ..., 0], borderType=border)
        np.testing.assert_array_equal(got[i] if C > 1 else got[i, ..., 0], ref)


def test_pyr_down_predicate_takes_any_size():
    from opencv_tpu_torch.core.dispatch import lookup
    cuda = torch.device("cuda")
    for C in (1, 2, 3, 4):
        assert lookup("pyr_down_u8", cuda, dtype="uint8", channels=C,
                      border=JK.BORDER_REFLECT_101) is not None
    assert lookup("pyr_down_u8", cuda, dtype="uint8", channels=5, border=0) is None
    assert lookup("pyr_down_u8", cuda, dtype="int16", channels=1, border=0) is None


def test_pyr_down_rejects_constant_border_and_wrong_inputs():
    x = torch.zeros((1, 20, 20, 1), dtype=torch.uint8)
    for fn in (pyr_down_u8, pyr_down_u8_plain):
        with pytest.raises(ValueError, match="BORDER_CONSTANT"):
            fn(x, tcv.BORDER_CONSTANT)
        with pytest.raises(ValueError):
            fn(torch.zeros((1, 20, 20, 5), dtype=torch.uint8))
        with pytest.raises(ValueError):
            fn(torch.zeros((1, 20, 20, 1), dtype=torch.int16))
    assert pyr_down_u8(x, tcv.BORDER_REFLECT_101 | tcv.BORDER_ISOLATED).shape == (1, 10, 10, 1)


def _sweep_module():
    path = Path(__file__).resolve().parent.parent / "perf" / "sweep_stencil_tiles.py"
    spec = importlib.util.spec_from_file_location("sweep_stencil_tiles", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sweep_stencil_tiles_edits_match_the_sources():
    """perf/sweep_stencil_tiles.py's variants and schedule probes are text
    edits of csrc/sepfilter.cu and csrc/pyrdown.cu, each of which must match
    the shipped source exactly once (patched() raises otherwise)."""
    sweep = _sweep_module()
    for kernel, consts in sweep.VARIANTS:
        src = sweep.patched(kernel, consts)
        for name, value in consts.items():
            if name != "edits":
                assert f"constexpr int {name} = {value};" in src
        for _, new in consts.get("edits", ()):
            assert new in src
    for kernel in ("sep", "pyr"):
        src = sweep.probed(kernel)
        assert src.count("probe_record(g0, 1);") == 1 and src.count("probe_record(g0, 0);") == 1
        assert "struct ProbeRec" in src


def test_parse_ptxas_reads_each_kernel_and_skips_device_functions():
    """chip_smoke.py fails on a spill in sep_filter's template from this
    reading of nvcc's -Xptxas -v log."""
    from opencv_tpu_torch.kernels._build import parse_ptxas
    k7 = "_ZN12_GLOBAL__N_117sep_filter_kernelILi7ELi4EsEEvPKhPT1_NS_4TapsENS_6ParamsE"
    gen = "_ZN12_GLOBAL__N_118sep_generic_kernelIhEEvPKhPT_NS_4TapsENS_6ParamsE"
    log = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{k7}' for 'sm_90a'
ptxas info    : Function properties for {k7}
    80 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 156 registers, used 1 barriers, 904 bytes cmem[0]
ptxas info    : Function properties for _ZN4ocvt11stage_bytesEPhPKhiiiPKNS_8EdgeMapsE
    40 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Compiling entry function '{gen}' for 'sm_90a'
ptxas info    : Function properties for {gen}
    80 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 84 registers, 904 bytes cmem[0]
"""
    assert parse_ptxas(log) == {
        k7: dict(stack=80, spill_stores=0, spill_loads=0, registers=156),
        gen: dict(stack=80, spill_stores=4, spill_loads=4, registers=84)}
