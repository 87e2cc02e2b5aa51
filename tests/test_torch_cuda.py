"""The port's CUDA kernels on the card, each against its plain version.

Needs a CUDA device and nvcc; skips otherwise.  Imports no JAX, so it runs
on a GPU machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q
"""

import ctypes

import numpy as np
import pytest
import torch

import opencv_tpu_torch as tcv
from opencv_tpu_torch import entry as E
from opencv_tpu_torch.core.dispatch import reset_tier_stats, tier_stats
from opencv_tpu_torch.kernels import GAUSS5_DOWN2, PYR_DOWN, SEP_FILTER
from opencv_tpu_torch.kernels.fused_preproc import (
    fused_gray_gauss5_down2, fused_gray_gauss5_down2_plain, gauss5_down2_u8,
    gauss5_down2_u8_plain)
from opencv_tpu_torch.kernels.sepfilter import (
    pyr_down_u8, pyr_down_u8_plain, sep_filter_int, sep_filter_int_plain, sep_filter_route)
from opencv_tpu_torch.features2d.fast import fast_keypoint_mask
from opencv_tpu_torch.features2d.orb import level_sizes
from opencv_tpu_torch.ops import shape as S
from opencv_tpu_torch.ops.filter import gaussian_kernel_bitexact, gaussian_kernel_fixedpoint_ed

pytestmark = pytest.mark.gpu

BORDERS = [tcv.BORDER_CONSTANT, tcv.BORDER_REPLICATE, tcv.BORDER_REFLECT,
           tcv.BORDER_WRAP, tcv.BORDER_REFLECT_101]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _q8(k, sigma):
    return tuple(int(v) for v in gaussian_kernel_fixedpoint_ed(gaussian_kernel_bitexact(k, sigma), 8))


def _rand(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, shape, np.uint8))


@pytest.mark.parametrize("border", BORDERS)
@pytest.mark.parametrize("cn", [1, 3, 4])
def test_sep_filter_kernel_equals_plain(cuda, border, cn):
    x = _rand((2, 45, 141, cn), border * 10 + cn).to(cuda)
    for k, sigma in ((3, 0.8), (9, 2.0), (31, 5.0)):
        kw = dict(kx=_q8(k, sigma), ky=_q8(k, sigma), shift=16, border=border,
                  border_value=(3, 200, 17, 90)[:cn])
        before = SEP_FILTER.launches
        got = sep_filter_int(x, **kw)
        torch.cuda.synchronize()
        assert SEP_FILTER.launches == before + 1
        assert torch.equal(got, sep_filter_int_plain(x, **kw)), (k, sigma)


# The kernels' block classes (see the notes in csrc/sepfilter.cu and
# csrc/pyrdown.cu): interior blocks, rows one byte over and under the
# 16-byte word and the 512-byte warp, W*C % 16 != 0 (rows at an offset in
# their granules; the tile kernels' word loads at the row's alignment), H
# not a multiple of the row strip; k = 3, 5 and 7 (the template) and 9, 31
# (the generic kernel)
SEP_CLASS_SHAPES = [(1, 256, 4096, 1), (2, 40, 15, 1), (2, 40, 17, 1), (2, 33, 511, 1),
                    (2, 33, 513, 1), (2, 40, 101, 1), (2, 40, 101, 3), (2, 40, 101, 4),
                    (2, 33, 64, 1), (1, 127, 160, 2), (1, 161, 128, 4)]


@pytest.mark.parametrize("border", BORDERS)
@pytest.mark.parametrize("k", [3, 5, 7, 9, 31])
def test_sep_filter_kernel_block_classes(cuda, k, border):
    kq = _q8(k, 0.0 if k < 7 else 1.0 + k / 8)
    route = "generic" if k > 7 else f"k{k}"
    for shape in SEP_CLASS_SHAPES:
        if k == 31 and shape[2] * shape[3] > 600:
            continue
        x = _rand(shape, k * 100 + border * 10 + shape[2]).to(cuda)
        kw = dict(kx=kq, ky=kq, shift=16, border=border, border_value=(9, 99, 199, 250)[:shape[3]])
        before = SEP_FILTER.routes[route]
        got = sep_filter_int(x, **kw)
        torch.cuda.synchronize()
        assert SEP_FILTER.routes[route] == before + 1
        assert torch.equal(got, sep_filter_int_plain(x, **kw)), shape


@pytest.mark.parametrize("border", BORDERS)
@pytest.mark.parametrize("window", [(9, 9), (13, 13), (23, 23), (31, 31), (9, 15)])
def test_sep_filter_box_route_block_classes(cuda, window, border):
    """The box kernel at every block class, k31 on the wide shapes too: u8
    with the box's scale and i16 with negative taps and a delta, on a batch
    and on a view one image into its storage (an odd offset where H*W*C is
    odd), each launch counted on route box."""
    kw_, kh_ = window
    taps = (dict(kx=(1,) * kw_, ky=(1,) * kh_, scale=1.0 / (kw_ * kh_)),
            dict(kx=(-3,) * kh_, ky=(2,) * kw_, delta=-5, out_dtype=torch.int16))
    for shape in SEP_CLASS_SHAPES:
        base = _rand((shape[0] + 1, *shape[1:]), kw_ * 100 + border * 10 + shape[2]).to(cuda)
        for x in (base[:-1], base[1:].contiguous()):
            for kw in taps:
                kw = dict(kw, border=border, border_value=(9, 99, 199, 250)[:shape[3]])
                before = SEP_FILTER.routes["box"]
                got = sep_filter_int(x, **kw)
                torch.cuda.synchronize()
                assert SEP_FILTER.routes["box"] == before + 1
                assert torch.equal(got, sep_filter_int_plain(x, **kw)), (shape, x.storage_offset())


def test_sep_filter_tile_kernels_at_the_timed_shapes(cuda):
    """ArUco's normalised boxes 13 and 23 on the box kernel, and the
    Gaussians k13 and k23 on the generic kernel, at the 1080p frame; k9 at
    ORB's level 2 on the generic kernel."""
    aruco = _rand((1, 1080, 1920, 1), 1).to(cuda)
    for k in (13, 23):
        kw = dict(kx=(1,) * k, ky=(1,) * k, scale=1.0 / (k * k),
                  border=tcv.BORDER_REPLICATE | tcv.BORDER_ISOLATED)
        assert sep_filter_route(kw["kx"], kw["ky"]) == 1
        assert torch.equal(sep_filter_int(aruco, **kw), sep_filter_int_plain(aruco, **kw))
    for x, k, sigma in ((aruco, 13, 0.0), (aruco, 23, 0.0), (_rand((8, 750, 1333, 1), 2).to(cuda),
                                                             9, 2.0)):
        kw = dict(kx=_q8(k, sigma), ky=_q8(k, sigma), shift=16)
        assert sep_filter_route(kw["kx"], kw["ky"]) == 0
        assert torch.equal(sep_filter_int(x, **kw), sep_filter_int_plain(x, **kw))


# sep_filter's template at K = 7, at every row width: (C, widths) with
# W*C % 16 = 1, 5, 15 (C = 1, 3; for C = 2, 4 the nearest their channel
# count allows), 0, and one row over 512 bytes
K7_WIDTHS = {1: (33, 37, 47, 48, 1029), 2: (33, 35, 39, 48, 517), 3: (43, 39, 37, 48, 345),
             4: (33, 35, 34, 48, 259)}
# Sobel ksize 7, (kx, ky) of dx = 1 and of dy = 1 (getDerivKernels)
SOBEL7 = (((-1, -4, -5, 0, 5, 4, 1), (1, 6, 15, 20, 15, 6, 1)),
          ((1, 6, 15, 20, 15, 6, 1), (-1, -4, -5, 0, 5, 4, 1)))


@pytest.mark.parametrize("border", BORDERS)
@pytest.mark.parametrize("cn", [1, 2, 3, 4])
def test_sep_filter_k7_template_equals_plain(cuda, cn, border):
    """The Q8 Gaussian into u8 and Sobel ksize 7 dx and dy into i16 (with
    delta and scale), at H = 1, 7 and 33 and every width of K7_WIDTHS, on
    a batch and on a view with an odd storage offset, all on route k7."""
    bv = (9, 99, 199, 250)[:cn]
    taps = [dict(kx=_q8(7, 2.0), ky=_q8(7, 2.0), shift=16)]
    taps += [dict(kx=kx, ky=ky, delta=-5, scale=0.5, out_dtype=torch.int16) for kx, ky in SOBEL7]
    for W in K7_WIDTHS[cn]:
        for H in (1, 7, 33):
            base = _rand((3, H, W, cn), W * 10 + H + cn).to(cuda)
            for x in (base[:2], base.view(-1)[1:1 + 2 * H * W * cn].view(2, H, W, cn)):
                for kw in taps:
                    kw = dict(kw, border=border, border_value=bv)
                    before = SEP_FILTER.routes["k7"]
                    got = sep_filter_int(x, **kw)
                    torch.cuda.synchronize()
                    assert SEP_FILTER.routes["k7"] == before + 1
                    assert torch.equal(got, sep_filter_int_plain(x, **kw)), \
                        (W, H, x.storage_offset(), kw["kx"])


def test_sep_filter_entry_refuses_a_route_its_taps_do_not_meet(cuda):
    """The route is the host's (sep_filter_route); the entry checks it and
    never sends the taps to another kernel."""
    x = _rand((1, 16, 40, 1), 3).to(cuda)
    out = torch.empty_like(x)
    q7, q5 = _q8(7, 2.0), _q8(5, 1.0)
    for kx, ky, route in ((q5, q5, 7), (q7, q7, 5), (q7, q5, 7), (tuple(2 * v for v in q7),) * 2
                          + (7,), (q7, q7, 4), (_q8(9, 2.0), _q8(9, 2.0), 9),
                          (q7, q7, 1), ((1,) * 9, (1,) * 8 + (2,), 1)):
        launches = SEP_FILTER.launches
        with pytest.raises(RuntimeError, match="CUDA error"):
            SEP_FILTER(x.device, x.data_ptr(), out.data_ptr(), 1, 16, 40, 1,
                       (ctypes.c_int * len(kx))(*kx), len(kx), (ctypes.c_int * len(ky))(*ky),
                       len(ky), 16, 0, 0, 0.0, tcv.BORDER_REFLECT_101, (ctypes.c_int * 4)(),
                       0, route, torch.cuda.current_stream().cuda_stream, route="k7")
        assert SEP_FILTER.launches == launches
    assert sep_filter_route(q7, q7) == 7


@pytest.mark.parametrize("border", BORDERS)
def test_sep_filter_kernel_sobel_i16_block_classes(cuda, border):
    for shape in ((2, 40, 17, 1), (2, 40, 101, 3), (2, 33, 513, 1), (1, 256, 4096, 1)):
        x = _rand(shape, border + shape[2]).to(cuda)
        for kx, ky in (((-1, 0, 1), (1, 2, 1)), ((1, 2, 1), (-1, 0, 1))):
            kw = dict(kx=kx, ky=ky, out_dtype=torch.int16, border=border)
            assert torch.equal(sep_filter_int(x, **kw), sep_filter_int_plain(x, **kw)), shape


@pytest.mark.parametrize("shape", [(2, 40, 64, 1), (2, 41, 63, 1), (3, 120, 1920, 1)])
def test_kernels_on_a_view_with_a_storage_offset(cuda, shape):
    # x[1:] of a batch: contiguous, offset by one image (aligned to 16 bytes
    # or not, which picks the kernels' word or byte-wise path)
    x = _rand((shape[0] + 1, *shape[1:]), shape[2]).to(cuda)[1:].contiguous()
    assert x.storage_offset() > 0
    for kw in (dict(kx=_q8(5, 0.0), ky=_q8(5, 0.0), shift=16),
               dict(kx=(-1, 0, 1), ky=(1, 2, 1), out_dtype=torch.int16)):
        assert torch.equal(sep_filter_int(x, **kw), sep_filter_int_plain(x, **kw))
    assert torch.equal(pyr_down_u8(x), pyr_down_u8_plain(x))


def test_sep_filter_kernel_sobel_and_box(cuda):
    x = _rand((2, 70, 90, 1), 4).to(cuda)
    for kw in (dict(kx=(-1, 0, 1), ky=(1, 2, 1), out_dtype=torch.int16),
               dict(kx=(1,) * 9, ky=(1,) * 9, scale=1.0 / 81, border=tcv.BORDER_REPLICATE)):
        got = sep_filter_int(x, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, sep_filter_int_plain(x, **kw))


# the strip kernel's classes: rows of 3W % 16 != 0 (the unaligned path),
# W of one strip (16), a strip -/+ 2 and a ragged last strip (512 + 6),
# H = 2 and 4, N = 1 and 3, and the main paths' width
GAUSS5_SHAPES = [(2, 98, 262, 3), (1, 4, 6, 3), (2, 192, 256, 3), (3, 34, 1918, 3),
                 (1, 2, 16, 3), (1, 4, 14, 3), (1, 6, 18, 3), (2, 10, 518, 3), (1, 8, 512, 3),
                 (3, 12, 1920, 3), (1, 1080, 1920, 3)]


@pytest.mark.parametrize("shape", GAUSS5_SHAPES)
def test_gauss5_down2_kernel_equals_plain(cuda, shape):
    x = _rand(shape, shape[1]).to(cuda)
    for sigma in (0.0, 0.1, 1.5, 20.0):
        before = GAUSS5_DOWN2.launches
        got = fused_gray_gauss5_down2(x, sigma)
        torch.cuda.synchronize()
        assert GAUSS5_DOWN2.launches == before + 1
        assert torch.equal(got, fused_gray_gauss5_down2_plain(x, sigma))
        g = x[..., 0].contiguous()
        assert torch.equal(gauss5_down2_u8(g, sigma), gauss5_down2_u8_plain(g, sigma))


def test_gauss5_down2_kernel_at_a_storage_offset(cuda):
    """A contiguous input one byte into its storage (aligned rows, unaligned
    base) takes the unaligned path and stays exact."""
    for shape in ((2, 40, 64, 3), (1, 20, 1920, 3), (2, 40, 64)):
        n = int(np.prod(shape))
        buf = _rand((n + 1,), n).to(cuda)
        x = buf[1:].view(shape)
        assert x.is_contiguous() and x.data_ptr() % 16 == 1
        for sigma in (0.0, 0.1, 1.5, 20.0):
            run, plain = ((fused_gray_gauss5_down2, fused_gray_gauss5_down2_plain)
                          if len(shape) == 4 else (gauss5_down2_u8, gauss5_down2_u8_plain))
            got, want = run(x, sigma), plain(x, sigma)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (shape, sigma)


def test_gauss5_down2_kernel_on_forced_plans(cuda):
    """Plans of few blocks: each warp's run of rows ends at every step of the
    unrolled loop, crosses column groups and images."""
    from opencv_tpu_torch.kernels.fused_preproc import _launch, _plan
    for shape in ((1, 2, 512, 3), (1, 4, 512, 3), (1, 6, 512, 3), (1, 10, 512, 3),
                  (1, 14, 512, 3), (1, 22, 512, 3), (1, 26, 512, 3), (3, 50, 1030, 3),
                  (2, 66, 512, 3)):
        x = _rand(shape, shape[1]).to(cuda)
        g = x[..., 2].contiguous()
        for blocks in (1, 3):
            for t, has_bgr, plain in ((x, True, fused_gray_gauss5_down2_plain),
                                      (g, False, gauss5_down2_u8_plain)):
                plan = _plan(*shape[:3], has_bgr, t.data_ptr())._replace(blocks=blocks)
                got = _launch(t, 1.5, has_bgr, plan)
                torch.cuda.synchronize()
                assert torch.equal(got, plain(t, 1.5)), (shape, plan)


def test_gauss5_down2_entry_refuses_taps_and_plans(cuda):
    """The C entry refuses taps that are not symmetric, non-negative and of
    sum 256, a plan that does not cover the image or has another strip width
    (12; 16 with BGR), and an aligned path on an unaligned base; the wrapper
    raises."""
    from opencv_tpu_torch.kernels.fused_preproc import _plan, stream_of
    x = _rand((1, 8, 64, 3), 5).to(cuda)
    out = torch.empty((1, 4, 32), dtype=torch.uint8, device=cuda)
    plan = _plan(1, 8, 64, True, x.data_ptr())
    good = (16, 64, 96, 64, 16, plan.px, plan.blocks, plan.gx, int(plan.vec))
    bad = [(16, 64, 96, 60, 20), (16, 64, 90, 64, 16), (-4, 68, 128, 68, -4)]
    args = [t + good[5:] for t in bad] + [good[:7] + (plan.gx + 1,) + good[8:],
                                           good[:5] + (12,) + good[6:],
                                           good[:5] + (16, plan.blocks, 1) + good[8:]]
    before = GAUSS5_DOWN2.launches
    for a in args:
        with pytest.raises(RuntimeError, match="CUDA error"):
            GAUSS5_DOWN2(cuda, x.data_ptr(), out.data_ptr(), 1, 8, 64, 1,
                         (ctypes.c_int * 9)(*a), stream_of(x))
    with pytest.raises(RuntimeError, match="CUDA error"):
        GAUSS5_DOWN2(cuda, x.data_ptr() + 1, out.data_ptr(), 1, 8, 62, 1,
                     (ctypes.c_int * 9)(*good[:7], 1, 1), stream_of(x))
    assert GAUSS5_DOWN2.launches == before
    GAUSS5_DOWN2(cuda, x.data_ptr(), out.data_ptr(), 1, 8, 64, 1, (ctypes.c_int * 9)(*good),
                 stream_of(x))
    torch.cuda.synchronize()
    assert torch.equal(out, fused_gray_gauss5_down2_plain(x))


def test_gaussian_blur_dispatches_to_the_kernel(cuda):
    x = _rand((1, 40, 60, 3), 7)
    reset_tier_stats()
    got = tcv.GaussianBlur(x.to(cuda), (5, 5), 1.1)
    assert tier_stats() == {"tier.sep_filter_u8.cuda": 1}
    assert torch.equal(got.cpu(), tcv.GaussianBlur(x, (5, 5), 1.1))


def test_slice_on_the_card_equals_cpu(cuda):
    imgs = torch.from_numpy(E.make_batch((2, 96, 128, 3)))
    pre = E.preprocess(imgs.to(cuda))
    assert torch.equal(pre.cpu(), E.preprocess(imgs))
    assert torch.equal(E.preprocess_fused(imgs.to(cuda)).cpu(), E.preprocess(imgs))
    d = (E.forward(imgs.to(cuda)).cpu().int() - E.forward(imgs).int()).abs()
    assert int(d.max()) <= 1 and int(d.count_nonzero()) <= d.numel() // 1000


PYR_BORDERS = [tcv.BORDER_REPLICATE, tcv.BORDER_REFLECT, tcv.BORDER_WRAP,
               tcv.BORDER_REFLECT_101]


@pytest.mark.parametrize("border", PYR_BORDERS)
@pytest.mark.parametrize("cn", [1, 3, 4])
def test_pyr_down_kernel_equals_plain(cuda, border, cn):
    for shape in ((2, 40, 52, cn), (2, 41, 53, cn), (1, 16, 16, cn), (2, 67, 261, cn),
                  (1, 1, 1, cn), (2, 5, 7, cn), (1, 9, 15, cn)):
        x = _rand(shape, border * 10 + cn + shape[1]).to(cuda)
        before = PYR_DOWN.launches
        got = pyr_down_u8(x, border)
        torch.cuda.synchronize()
        assert PYR_DOWN.launches == before + 1
        assert got.shape == (shape[0], (shape[1] + 1) // 2, (shape[2] + 1) // 2, cn)
        assert torch.equal(got, pyr_down_u8_plain(x, border)), shape


PYR_CLASS_SHAPES = [(2, 33, 1025, 1), (2, 31, 1023, 1), (2, 65, 17, 1), (2, 63, 15, 1),
                    (2, 97, 2047, 1), (1, 256, 4096, 1), (2, 33, 343, 3), (2, 35, 257, 4),
                    (2, 34, 130, 2), (2, 66, 34, 4)]


@pytest.mark.parametrize("border", PYR_BORDERS)
@pytest.mark.parametrize("shape", PYR_CLASS_SHAPES, ids=[str(s) for s in PYR_CLASS_SHAPES])
def test_pyr_down_kernel_block_classes(cuda, shape, border):
    x = _rand(shape, shape[1] * shape[2] + border).to(cuda)
    got = pyr_down_u8(x, border)
    torch.cuda.synchronize()
    assert torch.equal(got, pyr_down_u8_plain(x, border))


def test_build_pyramid_launches_the_kernel_at_every_level(cuda):
    # the kernel has no minimum size, so the small upper levels take it too
    x = _rand((1, 40, 52, 3), 11)
    reset_tier_stats()
    got = tcv.buildPyramid(x.to(cuda), 5)
    assert tier_stats() == {"tier.pyr_down_u8.cuda": 5}
    assert got[-1].shape == (1, 2, 2, 3)
    for g, w in zip(got, tcv.buildPyramid(x, 5)):
        assert torch.equal(g.cpu(), w)


def test_pyr_corner_edge_on_the_card_equals_cpu(cuda):
    x = torch.from_numpy(E.make_batch((2, 96, 128, 1)))
    reset_tier_stats()
    got = E.forward_pyr_corner_edge(x.to(cuda))
    assert tier_stats() == {"tier.pyr_down_u8.cuda": 1, "tier.sep_filter_int.cuda": 3}
    want = E.forward_pyr_corner_edge(x)
    for name, g, w in zip(("pyrDown", "cornerHarris", "Sobel", "Canny"), got, want):
        if name == "cornerHarris":
            torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-6 * float(w.abs().max()))
        else:
            assert torch.equal(g.cpu(), w), name


# ---------------------------------------------------------------- config 4 and GFTT
# (plain torch on both devices: the card's result equals the CPU's, exactly
# where the arithmetic is integer, min/max or f64, within the float bound of
# tests/test_torch_templmatch.py for matchTemplate)

@pytest.mark.parametrize("op", [tcv.MORPH_ERODE, tcv.MORPH_DILATE, tcv.MORPH_OPEN,
                                tcv.MORPH_GRADIENT, tcv.MORPH_BLACKHAT])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16, torch.int16, torch.float32])
def test_morphology_on_the_card_equals_cpu(cuda, dtype, op):
    rng = np.random.default_rng(op)
    x = torch.from_numpy(rng.integers(0, 65536, (2, 45, 67, 3))).to(dtype)
    ellipse = tcv.getStructuringElement(tcv.MORPH_ELLIPSE, (7, 5))
    for kernel, kw in ((np.ones((5, 3), np.uint8), dict(iterations=3)),
                       (ellipse, dict(borderType=tcv.BORDER_REFLECT_101)),
                       (ellipse, dict(borderValue=9))):
        got = tcv.morphologyEx(x.to(cuda), op, kernel, **kw)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), tcv.morphologyEx(x, op, kernel, **kw)), kw


@pytest.mark.parametrize("tsize", [(8, 8), (32, 32)])
@pytest.mark.parametrize("method", [tcv.TM_SQDIFF, tcv.TM_SQDIFF_NORMED, tcv.TM_CCORR,
                                    tcv.TM_CCORR_NORMED, tcv.TM_CCOEFF, tcv.TM_CCOEFF_NORMED])
def test_match_template_on_the_card_equals_cpu(cuda, method, tsize):
    x = _rand((2, 120, 160, 1), method)
    t = x[0, 30:30 + tsize[0], 40:40 + tsize[1], 0].clone()
    got = tcv.matchTemplate(x.to(cuda), t.to(cuda), method).cpu()
    want = tcv.matchTemplate(x, t, method)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-4 * max(1.0, float(want.abs().max()))
    if method != tcv.TM_CCORR:
        best = got[0, ..., 0].argmin() if method < tcv.TM_CCORR else got[0, ..., 0].argmax()
        assert divmod(int(best), got.shape[2]) == (30, 40)


def test_match_template_masked_on_the_card_equals_cpu(cuda):
    x = _rand((1, 60, 80, 3), 3)
    t = _rand((16, 12, 3), 4)
    mask = (np.random.default_rng(5).random((16, 12)) > 0.3).astype(np.uint8)
    for method in range(6):
        got = tcv.matchTemplate(x.to(cuda), t.to(cuda), method, mask=mask).cpu()
        want = tcv.matchTemplate(x, t, method, mask=mask)
        assert float((got - want).abs().max()) <= 1e-6 * max(1.0, float(want.abs().max()))


def test_match_morph_on_the_card_equals_cpu(cuda):
    _, (x, t) = E.entry_match_morph("cpu", (2, 96, 128, 1))
    reset_tier_stats()
    got = E.forward_match_morph(x.to(cuda), t.to(cuda))
    assert tier_stats() == {}
    want = E.forward_match_morph(x, t)
    m, mw = got[0].cpu(), want[0]
    assert float((m - mw).abs().max()) <= 1e-4 * max(1.0, float(mw.abs().max()))
    for g, w in zip(got[1:4], want[1:4]):
        assert torch.equal(g.cpu(), w)
    assert abs(float(got[4]) - float(want[4])) <= 1e-5 * abs(float(want[4]))


@pytest.mark.parametrize("harris", [False, True])
def test_good_features_to_track_on_the_card(cuda, harris):
    x = tcv.GaussianBlur(_rand((1, 120, 160, 1), 6), (7, 7), 2.5)
    kw = dict(useHarrisDetector=harris)
    got = tcv.goodFeaturesToTrack(x.to(cuda), 100, 0.01, 5, **kw)
    want = tcv.goodFeaturesToTrack(x, 100, 0.01, 5, **kw)
    a = {tuple(p) for p in got.reshape(-1, 2).astype(int).tolist()}
    b = {tuple(p) for p in want.reshape(-1, 2).astype(int).tolist()}
    assert len(a & b) >= (0.8 if harris else 0.85) * max(len(a), len(b))


@pytest.mark.parametrize("dtype", [torch.int16, torch.float64])
def test_warp_q5_map_on_the_card_equals_cpu(cuda, dtype):
    x = torch.from_numpy(np.random.default_rng(7).integers(-3000, 3000, (2, 48, 64, 3))).to(dtype)
    M = np.array([[0.9, 0.2, 3.3], [-0.25, 1.1, -4.2]])
    for border in BORDERS:
        got = tcv.warpAffine(x.to(cuda), M, (70, 50), borderMode=border, borderValue=(7, 8, 9))
        assert torch.equal(got.cpu(), tcv.warpAffine(x, M, (70, 50), borderMode=border,
                                                     borderValue=(7, 8, 9))), border


# -- BASELINE config 5: ORB, with FAST, the LINEAR_EXACT pyramid and BFMatcher

@pytest.mark.parametrize("level", range(8))
def test_sep_filter_k7_at_orb_level_shapes(cuda, level):
    """ORB's blur (GaussianBlur 7x7 sigma 2, REFLECT_101) takes the
    template at K = 7 at each of its 1080p level shapes."""
    w, h = level_sizes(1080, 1920)[level]
    x = _rand((2, h, w, 1), level).to(cuda)
    kw = dict(kx=_q8(7, 2.0), ky=_q8(7, 2.0), shift=16, border=tcv.BORDER_REFLECT_101)
    before = SEP_FILTER.launches
    routes = dict(SEP_FILTER.routes)
    got = sep_filter_int(x, **kw)
    torch.cuda.synchronize()
    assert SEP_FILTER.launches == before + 1
    assert SEP_FILTER.routes == {**routes, "k7": routes["k7"] + 1}
    assert torch.equal(got, sep_filter_int_plain(x, **kw))


@pytest.mark.parametrize("pattern", [16, 12, 8])
def test_fast_on_the_card_equals_cpu(cuda, pattern):
    x = tcv.GaussianBlur(_rand((2, 240, 320, 1), pattern), (3, 3), 1.0)
    for nonmax in (True, False):
        got = fast_keypoint_mask(x.to(cuda), 20, nonmax, pattern)
        for g, w in zip(got, fast_keypoint_mask(x, 20, nonmax, pattern)):
            assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("cn", [1, 3, 4])
def test_resize_linear_exact_on_the_card_equals_cpu(cuda, cn):
    x = _rand((2, 300, 536, cn), cn)
    for size in ((447, 250), (97, 61), (600, 333), (1, 1)):
        got = tcv.resize(x.to(cuda), size, interpolation=tcv.INTER_LINEAR_EXACT)
        assert torch.equal(got.cpu(), tcv.resize(x, size, interpolation=tcv.INTER_LINEAR_EXACT))


def _orb_equal(got, want):
    """Card against CPU, as chip_smoke.py holds them: per image the same
    keypoint set keyed by (octave, x, y), and per key the same response,
    angle and descriptor (cos and sin are taken in float64 and every other
    float op runs alone on both devices, so nothing is left to differ)."""
    for (gk, gd), (wk, wd) in zip(got, want):
        g = {(k.octave, k.pt[0], k.pt[1]): (k, d) for k, d in zip(gk, gd)}
        w = {(k.octave, k.pt[0], k.pt[1]): (k, d) for k, d in zip(wk, wd)}
        assert g.keys() == w.keys()
        for key, (kw, dw) in w.items():
            kg, dg = g[key]
            assert (kg.response, kg.angle) == (kw.response, kw.angle), key
            np.testing.assert_array_equal(dg, dw, err_msg=str(key))


@pytest.mark.parametrize("wta_k,score_type", [(2, tcv.ORB_HARRIS_SCORE), (3, tcv.ORB_HARRIS_SCORE),
                                              (4, tcv.ORB_FAST_SCORE), (2, tcv.ORB_FAST_SCORE)])
def test_orb_on_the_card_equals_cpu(cuda, wta_k, score_type):
    x = torch.from_numpy(E.make_batch((2, 480, 640)))
    before = (SEP_FILTER.launches, PYR_DOWN.launches, GAUSS5_DOWN2.launches)
    got = tcv.ORB_create(500, WTA_K=wta_k, scoreType=score_type).detect_and_compute_batch(
        x.to(cuda))
    # the 7x7 blur of each of the 8 levels, and no other kernel
    assert (SEP_FILTER.launches, PYR_DOWN.launches, GAUSS5_DOWN2.launches) == \
        (before[0] + 8, before[1], before[2])
    want = tcv.ORB_create(500, WTA_K=wta_k, scoreType=score_type).detect_and_compute_batch(x)
    _orb_equal(got, want)


def test_orb_entry_on_the_card(cuda):
    forward, (x, orb) = E.entry_orb("cuda", (2, 240, 320))
    assert x.device.type == "cuda"
    got = forward(x, orb)
    _orb_equal(got, forward(x.cpu(), tcv.ORB_create(500)))
    assert all(len(k) > 400 for k, _ in got)


@pytest.mark.parametrize("wta_k", [2, 4])
def test_orb_compute_on_the_card_equals_cpu(cuda, wta_k):
    """compute keeps the pyramid, the blur (8 sep_filter launches) and the
    sampling on the card, and gives detectAndCompute's descriptors."""
    img = torch.from_numpy(E.make_batch((1, 480, 640))[0])
    orb = tcv.ORB_create(500, WTA_K=wta_k)
    kps, desc = orb.detectAndCompute(img, None)
    before = (SEP_FILTER.launches, PYR_DOWN.launches, GAUSS5_DOWN2.launches)
    got = orb.compute(img.to(cuda), kps)[1]
    assert (SEP_FILTER.launches, PYR_DOWN.launches, GAUSS5_DOWN2.launches) == \
        (before[0] + 8, before[1], before[2])
    np.testing.assert_array_equal(got, desc)
    np.testing.assert_array_equal(got, orb.compute(img, kps)[1])


@pytest.mark.parametrize("norm", [tcv.NORM_HAMMING, tcv.NORM_HAMMING2, tcv.NORM_L2,
                                  tcv.NORM_L2SQR, tcv.NORM_L1])
def test_bf_matcher_on_the_card_equals_cpu(cuda, norm):
    """u8 descriptors: every distance is an integer sum, so the card's
    matches and distances equal the CPU's."""
    rng = np.random.default_rng(norm)
    d1 = rng.integers(0, 256, (300, 32), np.uint8)
    d2 = np.concatenate([d1[:150] ^ rng.integers(0, 2, (150, 32), np.uint8),
                         rng.integers(0, 256, (200, 32), np.uint8)])
    for cross in (False, True):
        bf = tcv.BFMatcher(norm, cross)
        got = bf.match(torch.from_numpy(d1).to(cuda), torch.from_numpy(d2).to(cuda))
        want = bf.match(d1, d2)
        assert [(m.queryIdx, m.trainIdx, m.distance) for m in got] == \
            [(m.queryIdx, m.trainIdx, m.distance) for m in want]
    knn = tcv.BFMatcher(norm).knnMatch(torch.from_numpy(d1).to(cuda),
                                       torch.from_numpy(d2).to(cuda), 2)
    assert [[(m.trainIdx, m.distance) for m in r] for r in knn] == \
        [[(m.trainIdx, m.distance) for m in r] for r in tcv.BFMatcher(norm).knnMatch(d1, d2, 2)]


# -- BASELINE config 2: the rest of resize and the warps (plain torch)

def _assert_warp_bound(got, want, msg=""):
    """max |d| <= 1 on at most 0.1% of pixels (chip_smoke.py's warp bound)."""
    d = (got.cpu().to(torch.float64) - want.to(torch.float64)).abs()
    assert float(d.max()) <= 1, f"{msg} max |d| {float(d.max())}"
    assert int(d.count_nonzero()) <= d.numel() // 1000, msg


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.float32])
@pytest.mark.parametrize("interp", [tcv.INTER_NEAREST, tcv.INTER_NEAREST_EXACT, tcv.INTER_LINEAR,
                                    tcv.INTER_LINEAR_EXACT, tcv.INTER_CUBIC, tcv.INTER_AREA,
                                    tcv.INTER_LANCZOS4])
def test_resize_on_the_card_equals_cpu(cuda, interp, dtype):
    """Integer paths bit for bit; f32 paths within 1e-5 (the card may round
    a product in another order than the CPU); fractional AREA in IEEE f32,
    whose i16 result may move by 1 where a sum lands on a rounding tie."""
    x = _rand((2, 61, 97, 3), interp).to(dtype)
    if dtype == torch.int16:
        x = x * 100 - 12000
    for size in ((53, 41), (194, 122), (45, 61), (33, 20)):
        got = tcv.resize(x.to(cuda), size, interpolation=interp).cpu()
        want = tcv.resize(x, size, interpolation=interp)
        if dtype == torch.float32:
            assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()), size
        else:
            assert float((got.to(torch.float64) - want.to(torch.float64)).abs().max()) <= \
                (0 if dtype == torch.uint8 or interp != tcv.INTER_AREA else 1), size


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.float64])
@pytest.mark.parametrize("interp", [tcv.INTER_NEAREST, tcv.INTER_LINEAR, tcv.INTER_CUBIC,
                                    tcv.INTER_LANCZOS4])
def test_warps_on_the_card_equal_cpu(cuda, interp, dtype):
    x = torch.from_numpy(np.random.default_rng(interp).integers(0, 256, (2, 48, 64, 3))).to(dtype)
    M = tcv.getRotationMatrix2D((31.5, 23.4), 30.0, 0.8)
    P = np.array([[0.95, 0.05, 8.0], [-0.04, 1.02, 4.0], [1e-4, -2e-4, 1.0]])
    for border in BORDERS:
        kw = dict(flags=interp, borderMode=border, borderValue=(7, 8, 9))
        _assert_warp_bound(tcv.warpAffine(x.to(cuda), M, (70, 50), **kw),
                           tcv.warpAffine(x, M, (70, 50), **kw), f"affine {border}")
        _assert_warp_bound(tcv.warpPerspective(x.to(cuda), P, (70, 50), **kw),
                           tcv.warpPerspective(x, P, (70, 50), **kw), f"perspective {border}")


def test_remap_and_polar_on_the_card_equal_cpu(cuda):
    x = _rand((40, 50, 3), 3)
    ys, xs = np.mgrid[0:44, 0:55].astype(np.float32)
    mapx = (xs * 0.9 - 0.7 + 3 * np.sin(ys * 0.2)).astype(np.float32)
    mapy = (ys * 0.85 - 0.9 + 2 * np.cos(xs * 0.3)).astype(np.float32)
    for interp in (tcv.INTER_NEAREST, tcv.INTER_LINEAR):
        for border in BORDERS:
            got = tcv.remap(x.to(cuda), torch.from_numpy(mapx).to(cuda),
                            torch.from_numpy(mapy).to(cuda), interp, borderMode=border)
            _assert_warp_bound(got, tcv.remap(x, mapx, mapy, interp, borderMode=border))
    img = _rand((120, 160), 4)
    for flags in (tcv.INTER_LINEAR, tcv.INTER_NEAREST + tcv.WARP_POLAR_LOG):
        fwd = tcv.warpPolar(img.to(cuda), (80, 180), (80, 60), 70, flags)
        _assert_warp_bound(fwd, tcv.warpPolar(img, (80, 180), (80, 60), 70, flags))
        inv = flags + tcv.WARP_INVERSE_MAP
        _assert_warp_bound(tcv.warpPolar(fwd, (160, 120), (80, 60), 70, inv),
                           tcv.warpPolar(fwd.cpu(), (160, 120), (80, 60), 70, inv))


def test_resize_warp_4k_on_the_card_equals_cpu(cuda):
    """Config 2 at a tenth of 4K: no kernel launches; the resizes equal the
    CPU's, the warps are within the warp bound, the resizes' total equal."""
    _, (x,) = E.entry_resize_warp_4k("cpu", (2, 216, 384, 3))
    before = (SEP_FILTER.launches, PYR_DOWN.launches, GAUSS5_DOWN2.launches)
    reset_tier_stats()
    got = E.forward_resize_warp_4k(x.to(cuda))
    torch.cuda.synchronize()
    assert tier_stats() == {}
    assert (SEP_FILTER.launches, PYR_DOWN.launches, GAUSS5_DOWN2.launches) == before
    want = E.forward_resize_warp_4k(x)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g.cpu(), w)
    for g, w in zip(got[3:5], want[3:5]):
        _assert_warp_bound(g, w)
    assert int(got[5][0]) == int(want[5][0])


def test_gauss5_down2_resolves_through_the_registry(cuda):
    """Both entries of the fused kernel resolve ``gauss5_down2_u8`` with
    lookup on a CUDA tensor, which counts the cuda tier and launches the
    kernel; odd H raises before any launch, as before the registry."""
    x = _rand((2, 40, 64, 3), 31).to(cuda)
    before = GAUSS5_DOWN2.launches
    reset_tier_stats()
    got = fused_gray_gauss5_down2(x)
    g = gauss5_down2_u8(x[..., 1].contiguous())
    torch.cuda.synchronize()
    assert tier_stats() == {"tier.gauss5_down2_u8.cuda": 2}
    assert GAUSS5_DOWN2.launches == before + 2
    assert torch.equal(got, fused_gray_gauss5_down2_plain(x))
    assert torch.equal(g, gauss5_down2_u8_plain(x[..., 1].contiguous()))
    for bad in (_rand((1, 41, 64, 3), 32).to(cuda), _rand((1, 40, 63, 3), 33).to(cuda)):
        with pytest.raises(ValueError, match="even"):
            fused_gray_gauss5_down2(bad)
        with pytest.raises(ValueError, match="even"):
            gauss5_down2_u8(bad[..., 0].contiguous())
    assert GAUSS5_DOWN2.launches == before + 2


def test_cvtcolor_on_the_card_equals_cpu(cuda):
    """Every registry code on u8 (and each float-capable code on f32) on the
    card against the CPU: u8 exact (but linear-RGB Luv, ±1), f32 within the
    tests' 2e-3."""
    from opencv_tpu_torch.ops.color import _REGISTRY

    x3 = _rand((2, 24, 32, 4), 41)
    yuv420, yuv422 = _rand((2, 36, 64, 1), 42), _rand((2, 24, 32, 2), 43)
    for code, fn in sorted(_REGISTRY.items()):
        for x in (x3[..., :1], x3[..., :2], x3[..., :3], x3, yuv420, yuv422):
            try:
                want = fn(x)
            except (RuntimeError, ValueError, IndexError):
                continue  # a layout the conversion does not take
            got = fn(x.to(cuda)).cpu()
            if code in (tcv.COLOR_LBGR2Luv, tcv.COLOR_LRGB2Luv):
                # u8 through the float path, whose pow (cbrt) may differ
                # by an ulp between the devices before the rounding
                assert (got.to(torch.int32) - want.to(torch.int32)).abs().max() <= 1, code
            else:
                assert torch.equal(got, want), code
            if x.shape[-1] in (1, 3, 4) and x.shape[1] == 24:
                xf = x.to(torch.float32) / 255.0
                try:
                    wf = fn(xf)
                except (RuntimeError, ValueError, TypeError):
                    continue
                gf = fn(xf.to(cuda)).cpu()
                assert gf.dtype == wf.dtype and gf.shape == wf.shape, code
                assert torch.allclose(gf, wf, rtol=0, atol=2e-3, equal_nan=True), code


def test_decode_color_on_the_card_equals_cpu(cuda):
    """The decode-and-colour path at (2, 108, 192): every output, the Otsu
    threshold and the sums equal the CPU's; one gauss5_down2 launch,
    resolved through the registry."""
    y, uv = E.make_nv12((2, 108, 192))
    y, uv = torch.from_numpy(y), torch.from_numpy(uv)
    before = GAUSS5_DOWN2.launches
    reset_tier_stats()
    got = E.forward_decode_color(y.to(cuda), uv.to(cuda))
    torch.cuda.synchronize()
    assert tier_stats() == {"tier.gauss5_down2_u8.cuda": 1}
    assert GAUSS5_DOWN2.launches == before + 1
    want = E.forward_decode_color(y, uv)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_enhance_on_the_card_equals_cpu(cuda):
    """The enhancement path at (2, 72, 128, 3): each stage on the card, fed
    the card's own input to it, equals the CPU's on that input, and so does
    the whole chain; GaussianBlur launches sep_filter once, on route k5."""
    x = torch.from_numpy(E.make_batch((2, 72, 128, 3)))
    before, k5 = SEP_FILTER.launches, SEP_FILTER.routes["k5"]
    reset_tier_stats()
    got = E.forward_enhance(x.to(cuda))
    torch.cuda.synchronize()
    assert tier_stats() == {"tier.sep_filter_u8.cuda": 1}
    assert SEP_FILTER.launches == before + 1 and SEP_FILTER.routes["k5"] == k5 + 1
    ins = [x.to(cuda)] + list(got[:len(E.ENHANCE_STAGES) - 1])
    for (name, stage), a in zip(E.ENHANCE_STAGES, ins):
        assert torch.equal(stage(a).cpu(), stage(a.cpu())), name
    for g, w in zip(got, E.forward_enhance(x)):
        assert torch.equal(g.cpu(), w)


def test_histograms_read_nothing_back(cuda):
    """threshold (OTSU, TRIANGLE), thresholdWithMask and calcHist take their
    histograms by one scatter on the card: under sync debug mode "error"
    none of them makes the host wait, and each equals the CPU's."""
    x = _rand((2, 64, 96, 1), 11)
    m = _rand((2, 64, 96, 1), 12) > 100
    calls = (lambda a, k: tcv.threshold(a, 0, 255, tcv.THRESH_BINARY | tcv.THRESH_OTSU),
             lambda a, k: tcv.threshold(a, 0, 255, tcv.THRESH_TOZERO | tcv.THRESH_TRIANGLE),
             lambda a, k: tcv.thresholdWithMask(a, None, k, 0, 255,
                                                tcv.THRESH_BINARY | tcv.THRESH_OTSU),
             lambda a, k: (tcv.calcHist([a], [0], None, [256], [0, 256]),),
             lambda a, k: (tcv.calcHist([a], [0], k, [32], [0, 256]),))
    xc, mc = x.to(cuda), m.to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [fn(xc, mc) for fn in calls]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for g, fn in zip(got, calls):
        for a, b in zip(g, fn(x, m)):
            assert torch.equal(a.cpu(), b)


def _motion_same(key, g, w):
    """The motion path's card output `g` against the CPU's `w`: the shifts
    and responses within 1e-6, distances within 1e-5, moments within rel
    1e-12, centroids within 1e-12 relative, everything else exactly."""
    if key == "moments":
        for a, b in zip(g, w):
            assert all(abs(a[k] - b[k]) <= 1e-12 * max(1.0, abs(b[k])) for k in b), key
    elif key == "contours":
        assert len(g) == len(w) and all(np.array_equal(a, b) for a, b in zip(g, w))
    elif key in ("areas", "rects", "cc_steps", "dt_steps"):
        assert g == w, key
    else:
        g = g.cpu() if isinstance(g, torch.Tensor) else torch.from_numpy(np.asarray(g))
        w = w if isinstance(w, torch.Tensor) else torch.from_numpy(np.asarray(w))
        assert g.shape == w.shape and g.dtype == w.dtype, key
        tol = {"shifts": 1e-6, "responses": 1e-6, "distance": 1e-5,
               "centroids": 1e-12 * max(1.0, float(w.abs().max()) if w.numel() else 1.0)}
        d = (g.to(torch.float64) - w.to(torch.float64)).abs()
        assert not d.numel() or float(d.max()) <= tol.get(key, 0.0), key


def test_motion_on_the_card_equals_cpu(cuda):
    """The motion path at (3, 144, 256, 3): GaussianBlur launches sep_filter
    once, on route k5; each stage on the card, fed the card's own input to
    it, equals the CPU's on that input, and so does the whole chain."""
    x = torch.from_numpy(E.make_motion_video((3, 144, 256, 3))[0])
    before, k5 = SEP_FILTER.launches, SEP_FILTER.routes["k5"]
    reset_tier_stats()
    got = E.forward_motion(x.to(cuda))
    torch.cuda.synchronize()
    assert tier_stats() == {"tier.sep_filter_u8.cuda": 1}
    assert SEP_FILTER.launches == before + 1 and SEP_FILTER.routes["k5"] == k5 + 1
    card = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in got.items()}
    card["x"] = x
    for name, stage, keys in E.MOTION_STAGES:
        st = dict(card)
        stage(st)
        for k in keys:
            _motion_same(k, card[k], st[k])
    for k, w in E.forward_motion(x).items():
        _motion_same(k, got[k], w)


@pytest.mark.parametrize("conn", [4, 8])
def test_components_on_the_card_equal_cpu(cuda, conn):
    rng = np.random.default_rng(conn)
    masks = np.stack([(rng.random((47, 63)) > p).astype(np.uint8) * 255 for p in (0.3, 0.55, 0.8)])
    masks[0, 10:40, 5:9] = masks[0, 10:40, 30:34] = masks[0, 36:40, 5:34] = 255
    labels, counts = S.components_batch(torch.from_numpy(masks).to(cuda), conn)
    want_l, want_c = S.components_batch(torch.from_numpy(masks), conn)
    assert torch.equal(labels.cpu(), want_l) and torch.equal(counts.cpu(), want_c)
    n = int(want_c.max()) + 1
    for g, w in zip(S.component_stats(labels, n),
                    S.component_stats(want_l, n)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("dist,mask", [("DIST_L2", 3), ("DIST_L1", 3), ("DIST_C", 5),
                                       ("DIST_L2", 5), ("DIST_L2", 0)])
def test_distance_transform_on_the_card_equals_cpu(cuda, dist, mask):
    x = (_rand((2, 60, 90, 1), 21) > 12).to(torch.uint8) * 255
    got = tcv.distanceTransform(x.to(cuda), getattr(tcv, dist), mask)
    assert torch.equal(got.cpu(), tcv.distanceTransform(x, getattr(tcv, dist), mask))


def test_distance_transform_with_labels_on_the_card_equals_cpu(cuda):
    x = (_rand((40, 50), 22) > 12).to(torch.uint8) * 255
    for lt in (tcv.DIST_LABEL_PIXEL, tcv.DIST_LABEL_CCOMP):
        for g, w in zip(tcv.distanceTransformWithLabels(x.to(cuda), tcv.DIST_L2, 5, lt),
                        tcv.distanceTransformWithLabels(x, tcv.DIST_L2, 5, lt)):
            assert torch.equal(g.cpu(), w)


def test_spectra_and_moments_on_the_card(cuda):
    """dft/idft (CCS, rows, f64), dct, mulSpectrums, phaseCorrelate and
    moments on the card against the CPU: f32 spectra within 1e-5 of the
    largest magnitude, f64 within 1e-12, shifts within 1e-6 px, moments
    within rel 1e-12."""
    rng = np.random.default_rng(5)
    for shape, dtype in (((30, 42), np.float32), ((31, 43), np.float32), ((20, 17), np.float64)):
        a = torch.from_numpy(rng.random(shape).astype(dtype))
        tol = 1e-12 if dtype == np.float64 else 1e-5
        for fn, flags in ((tcv.dft, 0), (tcv.dft, tcv.DFT_ROWS),
                          (tcv.dft, tcv.DFT_COMPLEX_OUTPUT), (tcv.dct, 0), (tcv.dct, tcv.DCT_ROWS)):
            g, w = fn(a.to(cuda), flags).cpu(), fn(a, flags)
            assert g.dtype == w.dtype and float((g - w).abs().max()) <= tol * float(w.abs().max())
        f = tcv.dft(a)
        g = tcv.idft(f.to(cuda), tcv.DFT_SCALE).cpu()
        assert float((g - tcv.idft(f, tcv.DFT_SCALE)).abs().max()) <= tol * float(a.abs().max())
        g = tcv.mulSpectrums(f.to(cuda), f.to(cuda), 0, True).cpu()
        w = tcv.mulSpectrums(f, f, 0, True)
        assert float((g - w).abs().max()) <= tol * float(w.abs().max())
    img = torch.from_numpy((rng.random((64, 96)) * 255).astype(np.uint8))
    moved = torch.roll(img, (3, -5), (0, 1))
    (gx, gy), gr = tcv.phaseCorrelate(img.to(cuda), moved.to(cuda))
    (cx, cy), cr = tcv.phaseCorrelate(img, moved)
    assert abs(gx - cx) < 1e-6 and abs(gy - cy) < 1e-6 and abs(gr - cr) < 1e-6
    g, w = tcv.moments(img.to(cuda)), tcv.moments(img)
    assert all(abs(g[k] - w[k]) <= 1e-12 * max(1.0, abs(w[k])) for k in w)


def test_accumulate_transform_rng_on_the_card_bit_equal(cuda):
    """The accumulate family, cv2.transform, convertMaps, blendLinear and
    getRectSubPix on the card equal the CPU bit for bit; the RNG fills a
    card tensor with the CPU's numbers for one seed."""
    src = _rand((40, 50), 31)
    dst = torch.from_numpy(np.random.default_rng(32).random((40, 50)).astype(np.float32) * 10)
    mask = _rand((40, 50), 33) > 100
    for fn, args in ((tcv.accumulate, (src, dst)), (tcv.accumulateSquare, (src, dst)),
                     (tcv.accumulateProduct, (src, src, dst)),
                     (tcv.accumulateWeighted, (src, dst, 0.05))):
        for m in (None, mask):
            g = fn(*[a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args],
                   mask=None if m is None else m.to(cuda))
            assert torch.equal(g.cpu(), fn(*args, mask=m))
    img = _rand((30, 40, 3), 34)
    M = np.random.default_rng(35).random((3, 4))
    assert torch.equal(tcv.transform(img.to(cuda), M).cpu(), tcv.transform(img, M))
    mx = torch.from_numpy(np.random.default_rng(36).random((30, 30)).astype(np.float32) * 28)
    for g, w in zip(tcv.convertMaps(mx.to(cuda), mx.t().contiguous().to(cuda), None),
                    tcv.convertMaps(mx, mx.t().contiguous(), None)):
        assert torch.equal(g.cpu(), w)
    w1 = torch.rand(30, 40)
    assert torch.equal(tcv.blendLinear(img.to(cuda), img.flip(0).to(cuda), w1.to(cuda),
                                       (1 - w1).to(cuda)).cpu(),
                       tcv.blendLinear(img, img.flip(0), w1, 1 - w1))
    assert torch.equal(tcv.getRectSubPix(img.to(cuda), (9, 7), (12.3, 4.6)).cpu(),
                       tcv.getRectSubPix(img, (9, 7), (12.3, 4.6)))
    tcv.setRNGSeed(3)
    t = torch.zeros(5, 7, device=cuda)
    tcv.randu(t, 0, 1)
    tcv.setRNGSeed(3)
    c = torch.zeros(5, 7)
    tcv.randu(c, 0, 1)
    assert torch.equal(t.cpu(), c)


def _same(a, b):
    """Per-frame results (arrays, tensors, None, nested lists, tuples or
    dicts of them) equal exactly."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def test_lines_on_the_card_equals_cpu(cuda):
    """The lane-and-sign path at (2, 360, 640, 3): sep_filter launches once
    on route k5 and 6 times on route k3, through the registry; each stage on
    the card, fed the card's own input to it, equals the CPU's on that input,
    and so does the whole chain."""
    x = torch.from_numpy(E.make_road_video((2, 360, 640, 3))[0])
    before = dict(SEP_FILTER.routes)
    reset_tier_stats()
    got = E.forward_lines(x.to(cuda))
    torch.cuda.synchronize()
    assert tier_stats() == {"tier.sep_filter_u8.cuda": 1, "tier.sep_filter_int.cuda": 6}
    assert SEP_FILTER.routes["k5"] == before["k5"] + 1
    assert SEP_FILTER.routes["k3"] == before["k3"] + 6
    assert got["drawn"].device.type == "cuda"
    card = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in got.items()}
    card["x"] = x
    for name, stage, keys in E.LINES_STAGES:
        st = dict(card)
        stage(st)
        for k in keys:
            assert _same(card[k], st[k]), (name, k)
    want = E.forward_lines(x)
    for k, w in want.items():
        assert _same(got[k], w), k


def test_hough_on_the_card_equals_cpu(cuda):
    """HoughLines (with votes), HoughLinesP, HoughCircles (dp 1 and 2),
    HoughLinesPointSet and the generalized Hough of Ballard and Guil on the
    card equal the CPU."""
    import cv2
    rng = np.random.default_rng(41)
    img = np.zeros((120, 160), np.uint8)
    cv2.line(img, (10, 20), (150, 90), 255, 1)
    cv2.line(img, (50, 5), (60, 115), 255, 1)
    img[rng.random(img.shape) < 0.02] = 255
    t, g = torch.from_numpy(img), torch.from_numpy(img).to(cuda)
    assert _same(tcv.HoughLinesWithAccumulator(g, 1, np.pi / 180, 20),
                 tcv.HoughLinesWithAccumulator(t, 1, np.pi / 180, 20))
    assert _same(tcv.HoughLinesP(g, 1, np.pi / 180, 20, 10, 3),
                 tcv.HoughLinesP(t, 1, np.pi / 180, 20, 10, 3))
    c = np.full((100, 120), 80, np.uint8)
    cv2.circle(c, (50, 50), 20, 230, 3)
    cv2.circle(c, (95, 30), 14, 200, -1)
    c = torch.from_numpy(cv2.GaussianBlur(c, (5, 5), 1))
    for dp in (1, 2):
        assert _same(tcv.HoughCirclesWithAccumulator(c.to(cuda), 3, dp, 20, 100, 15, 8, 40),
                     tcv.HoughCirclesWithAccumulator(c, 3, dp, 20, 100, 15, 8, 40))
    pts = torch.from_numpy(rng.uniform(0, 100, (60, 2)).astype(np.float32))
    args = (10, 3, -50, 150, 1.0, 0.0, np.pi, np.pi / 180)
    assert _same(tcv.HoughLinesPointSet(pts.to(cuda), *args), tcv.HoughLinesPointSet(pts, *args))
    templ = np.zeros((40, 40), np.uint8)
    cv2.rectangle(templ, (10, 10), (30, 30), 255, 2)
    scene = np.zeros((90, 100), np.uint8)
    cv2.rectangle(scene, (40, 45), (60, 65), 255, 2)
    for make in (tcv.createGeneralizedHoughBallard, tcv.createGeneralizedHoughGuil):
        res = []
        for d in (cuda, "cpu"):
            h = make()
            h.setVotesThreshold(20)
            h.setMinDist(10)
            if hasattr(h, "setPosThresh"):
                h.setMinAngle(0)
                h.setMaxAngle(20)
                h.setAngleStep(10)
                h.setMinScale(0.9)
                h.setMaxScale(1.1)
                h.setScaleStep(0.1)
                h.setPosThresh(20)
            h.setTemplate(torch.from_numpy(templ).to(d))
            res.append(h.detect(torch.from_numpy(scene).to(d)))
        assert res[0][0] is not None and _same(res[0], res[1])


def test_drawing_on_the_card_equals_cpu(cuda):
    """Each primitive draws a card tensor in place, equal to the numpy
    drawing, LINE_AA's f64 blend included."""
    from opencv_tpu_torch.features2d import KeyPoint
    base = np.random.default_rng(42).integers(0, 256, (60, 80, 3), np.uint8)
    kps = [KeyPoint(10, 12, 5), KeyPoint(30.7, 40.2, 5)]
    for fn in (lambda im: tcv.line(im, (3, 5.5), (70.2, 50), (255, 0, 40), 2, tcv.LINE_AA),
               lambda im: tcv.line(im, (3, 5), (70, 50), (255, 0, 40), 3),
               lambda im: tcv.rectangle(im, (5, 5), (50, 40), (0, 255, 0), 2),
               lambda im: tcv.circle(im, (30, 30), 20, (1, 2, 3), 2),
               lambda im: tcv.ellipse(im, (40, 30), (20, 10), 30, 0, 360, (9, 8, 7), -1),
               lambda im: tcv.fillPoly(im, [np.array([[5, 5], [50, 10], [30, 40]])], (5, 6, 7)),
               lambda im: tcv.arrowedLine(im, (5, 5), (60, 40), (200, 100, 50), 2),
               lambda im: tcv.putText(im, "Ab 12!", (3, 40), tcv.FONT_HERSHEY_SIMPLEX, 0.8,
                                      (255, 255, 255), 2),
               lambda im: tcv.drawKeypoints(im, kps, None)):
        g = torch.from_numpy(base.copy()).to(cuda)
        out = fn(g)
        assert out.device.type == "cuda"
        assert np.array_equal(out.cpu().numpy(), fn(base.copy()))


def test_geometry_extra_on_the_card_equals_cpu(cuda):
    rng = np.random.default_rng(43)
    m = ((rng.random((50, 70)) < 0.45) * 255).astype(np.uint8)
    assert _same(tcv.findContoursLinkRuns(torch.from_numpy(m).to(cuda)),
                 tcv.findContoursLinkRuns(m))
    f = torch.from_numpy(rng.random((30, 40)).astype(np.float32))
    k = rng.random((3, 3)).astype(np.float32)
    assert _same(tcv.filter2Dp(f.to(cuda), k, scale=0.5, shift=1.25),
                 tcv.filter2Dp(f, k, scale=0.5, shift=1.25))
    moved = torch.roll(f, (2, -3), (0, 1))
    g = tcv.phaseCorrelateIterative(f.to(cuda), moved.to(cuda))
    c = tcv.phaseCorrelateIterative(f, moved)
    assert max(abs(a - b) for a, b in zip(g, c)) < 1e-6


@pytest.mark.parametrize("shape", [(1, 1080, 1920, 3), (1, 540, 960, 3)])
def test_pyr_down_c3_at_the_segmentation_shapes(cuda, shape):
    """pyr_down with C = 3 on the segmentation path's two inputs (frame 0
    at 1080p, and its half inside pyrMeanShiftFiltering) equals its plain
    version, one launch each."""
    x = _rand(shape, shape[1]).to(cuda)
    before = PYR_DOWN.launches
    got = pyr_down_u8(x)
    torch.cuda.synchronize()
    assert PYR_DOWN.launches == before + 1
    assert tuple(got.shape) == (1, shape[1] // 2, shape[2] // 2, 3)
    assert torch.equal(got, pyr_down_u8_plain(x))


def _segment_same(key, g, w):
    """Card against CPU for forward_segment's `key`: the corrected frames
    within the warp bound (``^(1/γ)`` is the device's), grabCut's mask on at
    most 0.01% of its pixels and then its models within rel 1e-4, the
    distances within 1e-5, the min cuts' host times not at all, the rest
    exactly."""
    if key == "gc_stats":
        return True
    if key in ("corrected", "cut_mask", "distance"):
        d = (g.cpu().double() - w.double()).abs()
        bound = {"corrected": int(d.max()) <= 1 and int(d.count_nonzero()) <= 1e-3 * d.numel(),
                 "cut_mask": int(d.count_nonzero()) <= 1e-4 * d.numel(),
                 "distance": float(d.max()) <= 1e-5}
        return g.shape == w.shape and bound[key]
    if key in ("bgd_model", "fgd_model"):
        return np.abs(g - w).max() <= 1e-4 * np.abs(w).max()
    return _same(g, w)


def test_segment_on_the_card_equals_cpu(cuda):
    """The cell-segmentation path at (2, 270, 480, 3): sep_filter launches
    once on route k5 and pyr_down twice (C = 3), through the registry; each
    stage on the card, fed the card's own input to it, equals the CPU's on
    that input, and so does the whole chain."""
    fwd, (x, model) = E.entry_segment("cpu", (2, 270, 480, 3))
    before, pyr_before = dict(SEP_FILTER.routes), PYR_DOWN.launches
    reset_tier_stats()
    got = fwd(x.to(cuda), model)
    torch.cuda.synchronize()
    assert tier_stats() == {"tier.sep_filter_u8.cuda": 1, "tier.pyr_down_u8.cuda": 2}
    assert SEP_FILTER.routes["k5"] == before["k5"] + 1
    assert PYR_DOWN.launches == pyr_before + 2
    assert got["painted"].device.type == "cuda" and got["cut_mask"].device.type == "cuda"
    card = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in got.items()}
    card.update(x=x, model=model)
    for name, stage, keys in E.SEGMENT_STAGES:
        st = dict(card)
        stage(st)
        for k in keys:
            assert _segment_same(k, card[k], st[k]), (name, k)
    want = E.forward_segment(x, model)
    if torch.equal(got["corrected"].cpu(), want["corrected"]):
        for k, w in want.items():
            assert _segment_same(k, got[k], w), k


def test_segmentation_ops_on_the_card_equal_cpu(cuda):
    """pyrMeanShiftFiltering, kmeans (integer points), watershed and
    floodFill on card tensors, IntelligentScissorsMB's features, and the
    colour correction (within the warp bound) equal the CPU; grabCut's mask
    within 0.01% of its pixels."""
    import cv2
    rng = np.random.default_rng(15)
    img = cv2.GaussianBlur(rng.integers(0, 256, (90, 120, 3), np.uint8), (5, 5), 2)
    t, g = torch.from_numpy(img), torch.from_numpy(img).to(cuda)
    ms = tcv.pyrMeanShiftFiltering(g, 8, 12, 1)
    assert ms.device.type == "cuda"
    assert torch.equal(ms.cpu(), tcv.pyrMeanShiftFiltering(t, 8, 12, 1))
    pts = np.rint(rng.normal(0, 20, (4000, 3))).astype(np.float32)
    for flags in (tcv.KMEANS_RANDOM_CENTERS, tcv.KMEANS_PP_CENTERS):
        kg = tcv.kmeans(torch.from_numpy(pts).to(cuda), 4, None, (3, 15, 0.0), 2, flags)
        kc = tcv.kmeans(torch.from_numpy(pts), 4, None, (3, 15, 0.0), 2, flags)
        assert torch.equal(kg[1].cpu(), kc[1]) and torch.equal(kg[2].cpu(), kc[2])
        assert abs(kg[0] - kc[0]) <= 1e-5 * abs(kc[0])
    mk = np.zeros((90, 120), np.int32)
    mk[20, 30], mk[60, 90], mk[45, 10] = 1, 2, 3
    mg = torch.from_numpy(mk).to(cuda)
    tcv.watershed(g, mg)
    assert _same(mg.cpu(), tcv.watershed(t, torch.from_numpy(mk)))
    ff = tcv.floodFill(g, None, (60, 45), (9, 9, 9), (6, 6, 6), (6, 6, 6), 8)
    assert ff[1].device.type == "cuda"
    assert _same(ff, tcv.floodFill(t, None, (60, 45), (9, 9, 9), (6, 6, 6), (6, 6, 6), 8))
    for canny in (False, True):
        feats = []
        for src in (g, t):
            s = tcv.segmentation.IntelligentScissorsMB()
            if canny:
                s.setEdgeFeatureCannyParameters(40, 90)
            s.applyImage(src)
            feats.append((s._non_edge, s._grad_dir, s._grad_mag))
        assert _same(*feats), canny
    gm = tcv.grabCut(g, None, (20, 15, 70, 60), None, None, 2, tcv.GC_INIT_WITH_RECT)[0]
    cm = tcv.grabCut(t, None, (20, 15, 70, 60), None, None, 2, tcv.GC_INIT_WITH_RECT)[0]
    assert gm.device.type == "cuda" and int((gm.cpu() != cm).sum()) <= 1e-4 * cm.numel()
    model = E.fit_cells_model()
    d = (model.correctImage(g).cpu().int() - model.correctImage(t).int()).abs()
    assert int(d.max()) <= 1 and int(d.count_nonzero()) <= 1e-3 * d.numel()


@pytest.mark.parametrize("shape", [(2, 1080, 1920, 1), (2, 540, 960, 1), (2, 270, 480, 1),
                                   (8, 1080, 1920, 1)])
def test_pyr_down_at_the_video_shapes(cuda, shape):
    """pyr_down on the video path's inputs (LK's pair at 1080p and its next
    two levels, N = 2; the gray batch, N = 8) equals its plain version, one
    launch each."""
    x = _rand(shape, shape[2]).to(cuda)
    before = PYR_DOWN.launches
    got = pyr_down_u8(x)
    torch.cuda.synchronize()
    assert PYR_DOWN.launches == before + 1
    assert tuple(got.shape) == (shape[0], shape[1] // 2, shape[2] // 2, 1)
    assert torch.equal(got, pyr_down_u8_plain(x))


def test_video_path_on_the_card_equals_cpu(cuda):
    """forward_video on a (3, 270, 480) video: 7 pyr_down launches (LK's
    three levels of two pairs, the batch's half) and no other kernel; the
    corners, tracks, shifts, aligned frames, masks and half frames equal the
    CPU's, the flow within 1e-3 px on 99.9% of the pixels."""
    video, _, _ = E.make_motion_video((3, 270, 480, 3))
    x = torch.from_numpy(video)
    kernels = (SEP_FILTER, GAUSS5_DOWN2, PYR_DOWN)
    for k in kernels:
        k.reset()
    got = E.forward_video(x.to(cuda))
    torch.cuda.synchronize()
    assert {k.symbol: k.launches for k in kernels} == {
        "opencv_sep_filter": 0, "opencv_gauss5_down2": 0, "opencv_pyr_down": 7}
    want = E.forward_video(x)
    for key in ("corners", "tracks", "status", "shifts"):
        assert np.array_equal(got[key], want[key]), key
    for key in ("gray", "aligned", "masks", "background", "half"):
        assert torch.equal(got[key].cpu(), want[key]), key
    d = (got["flow"].cpu() - want["flow"]).abs().amax(dim=-1)
    assert float((d <= 1e-3).float().mean()) >= 0.999


@pytest.mark.parametrize("shape", [(1, 1071, 1911, 3), (1, 268, 478, 3)])
def test_sep_filter_k3_c3_at_the_photo_shapes(cuda, shape):
    """Canny's two Sobels (BORDER_REPLICATE, u8 -> i16) on the photo path's
    masked three-channel frame, cut at 1080p and at 270x480 (odd widths):
    route k3, one launch each, equal to the plain version."""
    x = _rand(shape, shape[2]).to(cuda)
    for kx, ky in (((-1, 0, 1), (1, 2, 1)), ((1, 2, 1), (-1, 0, 1))):
        SEP_FILTER.reset()
        kw = dict(kx=kx, ky=ky, out_dtype="int16", border=tcv.BORDER_REPLICATE)
        got = sep_filter_int(x, **kw)
        torch.cuda.synchronize()
        assert SEP_FILTER.launches == SEP_FILTER.routes["k3"] == 1
        assert sep_filter_route(kx, ky) == 3
        assert torch.equal(got, sep_filter_int_plain(x, **kw))


def test_photo_path_on_the_card_equals_cpu(cuda):
    """forward_photo on a (3, 270, 480) bracket: two sep_filter launches on
    route k3 (textureFlattening's Canny, C = 3) and no other kernel; the
    shifts, aligned frames and inpaint's fill (on the same input) equal the
    CPU's; fuse, denoise, detail and flatten, each on the card's own input,
    within 1 on 99.9% of the values."""
    bracket, _, _, face, wire = E.make_bracket((3, 270, 480, 3))
    args = [torch.from_numpy(a) for a in (bracket, face, wire)]
    kernels = (SEP_FILTER, GAUSS5_DOWN2, PYR_DOWN)
    for k in kernels:
        k.reset()
    got = E.forward_photo(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    assert {k.symbol: k.launches for k in kernels} == {
        "opencv_sep_filter": 2, "opencv_gauss5_down2": 0, "opencv_pyr_down": 0}
    assert SEP_FILTER.routes["k3"] == 2
    want = E.forward_photo(*args)
    assert np.array_equal(got["shifts"], want["shifts"])
    assert torch.equal(got["aligned"].cpu(), want["aligned"])
    st = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in got.items()}
    for name, stage, keys in E.PHOTO_STAGES[1:]:
        cpu = dict(st)
        stage(cpu)
        for key in keys:
            d = (cpu[key].int() - st[key].int()).abs()
            assert int(d.max()) <= 1 and int(d.count_nonzero()) <= 1e-3 * d.numel(), key
    cpu = dict(st)
    E.PHOTO_STAGES[-1][1](cpu)
    assert torch.equal(cpu["inpainted"], st["inpainted"])
