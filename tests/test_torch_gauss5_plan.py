"""The host side of the gauss5_down2 strip kernel (``csrc/fused_preproc.cu``):
its taps, the bounds its packed arithmetic relies on, its gray weights and
the launch plan of ``kernels/fused_preproc.py``.

The kernel itself runs on the card (``tests/test_torch_cuda.py``); here its
source is also compiled for the host with g++, against an emulation of the
CUDA features it uses (``tests/cuda_host_emu.py``), and held to the plain
version.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import cuda_host_emu
from opencv_tpu_torch.kernels import fused_preproc as F
from opencv_tpu_torch.ops.color import BY15, GRAY_SHIFT, GY15, RY15

CSRC = Path(F.__file__).resolve().parent.parent / "csrc"
SIGMAS = np.round(np.arange(0.0, 20.0001, 0.05), 2)


def _constants() -> dict:
    """The kernel's ``constexpr unsigned`` constants, evaluated."""
    src = (CSRC / "fused_preproc.cu").read_text()
    return {name: eval(expr.replace("u", ""))  # noqa: S307 - integer literals and shifts
            for name, expr in re.findall(r"constexpr unsigned (\w+) = ([^;]+);", src)}


def test_taps_are_symmetric_non_negative_and_sum_to_256():
    for sigma in SIGMAS:
        k = F._taps(float(sigma))
        assert len(k) == 5 and k == k[::-1], (sigma, k)
        assert min(k) >= 0 and sum(k) == 256, (sigma, k)


def test_the_packed_halves_cannot_carry():
    """Every partial sum of the vertical pass is at most 255 * sum(k) = 65280
    < 2^16 (the taps are non-negative); the horizontal pass's sum with its
    round stays under 2^24, so a blur is at most 255 and the composed ops'
    saturate never acts.  Only the identity taps (0, 0, 256) have a tap
    over the 255 of a __dp2a byte."""
    for sigma in SIGMAS:
        k = F._taps(float(sigma))
        assert 255 * sum(k) <= 0xFFFF
        v = sum(k) * 255 * sum(k) + (1 << 15)
        assert v < 1 << 24 and v >> 16 == 255
        assert max(k) <= 255 or k == [0, 0, 256, 0, 0], (sigma, k)


def test_identity_taps_round_as_the_kernel_takes_them():
    """Taps (0, 0, 256) reach the horizontal pass as (0, 0, 255) from 65280:
    for every gray g, (255 * 256 g + 65280) >> 16 == (65536 g + 2^15) >> 16."""
    g = np.arange(256, dtype=np.int64)
    np.testing.assert_array_equal((255 * 256 * g + 65280) >> 16, (65536 * g + (1 << 15)) >> 16)


def test_gray_weights_of_the_kernel_equal_cvtcolor():
    """The doubled Q15 weights in the kernel's __dp2a pairs, and byte 2 of
    the doubled sum equals (r*9798 + g*19235 + b*3735 + 2^14) >> 15 for all
    2^24 pixels."""
    c = _constants()
    b2, g2, r2 = 2 * BY15, 2 * GY15, 2 * RY15
    assert (c["kBG"], c["kR0"], c["k0B"], c["kGR"]) == (b2 | g2 << 16, r2, b2 << 16, g2 | r2 << 16)
    assert c["kGrayRound"] == 1 << 15 and b2 + g2 + r2 == 1 << 16
    v = np.arange(1 << 24, dtype=np.int64)
    b, g, r = v & 255, (v >> 8) & 255, v >> 16
    s = b * b2 + g * g2 + r * r2 + c["kGrayRound"]
    assert s.max() < 1 << 24
    want = (r * RY15 + g * GY15 + b * BY15 + (1 << (GRAY_SHIFT - 1))) >> GRAY_SHIFT
    np.testing.assert_array_equal((s >> 16) & 255, want)


def _coverage(plan, N, H, W):
    """How often the kernel writes each output under `plan`: warp i takes
    units [i * units / warps, (i + 1) * units / warps) of the (image, column
    group, row) units, and lane l of column group c the outputs [(32 c + l)
    * px / 2, + px / 2) of its row, those under W / 2."""
    Ho, Wo = H // 2, W // 2
    units = N * plan.gx * Ho
    warps = plan.blocks * F.WARPS
    cuts = np.arange(warps + 1, dtype=np.int64) * units // warps
    per_unit = np.zeros(units, np.int64)
    np.add.at(per_unit, np.concatenate([np.arange(a, b) for a, b in zip(cuts[:-1], cuts[1:])]), 1)
    n, cx, oy = np.unravel_index(np.arange(units), (N, plan.gx, Ho))
    count = np.zeros((N, Ho, plan.gx * 16 * plan.px), np.int64)
    for c in range(plan.gx):
        sel = cx == c
        count[n[sel], oy[sel], c * 16 * plan.px:(c + 1) * 16 * plan.px] += per_unit[sel, None]
    return count[:, :, :Wo]


@pytest.mark.parametrize("shape", [(8, 1080, 1920, 3), (2, 1080, 1920, 3), (8, 1080, 1920, 1),
                                   (1, 2, 2, 3), (1, 4, 6, 1), (3, 34, 1918, 3),
                                   (2, 10, 518, 1), (1, 2, 16, 3), (5, 98, 262, 3)])
def test_plan_covers_every_output_once(shape):
    N, H, W, C = shape
    plan = F._plan(N, H, W, C == 3, 0)
    assert plan.px == (8 if C == 3 else 16) and plan.gx == -(-W // (32 * plan.px))
    assert 1 <= plan.blocks <= F.WAVE
    assert (_coverage(plan, N, H, W) == 1).all()
    runs = np.diff(np.arange(plan.blocks * F.WARPS + 1) * (N * plan.gx * (H // 2))
                   // (plan.blocks * F.WARPS))
    assert runs.max() == plan.band and runs.max() - runs.min() <= 1
    for blocks in (1, 3):
        assert (_coverage(plan._replace(blocks=blocks), N, H, W) == 1).all()


def test_plan_fills_the_card_at_the_main_paths_shapes():
    """One wave of 4 blocks of 4 warps on each of the 132 SMs, at N = 2 as at
    N = 8; small images take fewer blocks, runs of at least 2 rows."""
    for N in (2, 8):
        for C in (1, 3):
            plan = F._plan(N, 1080, 1920, C == 3, 0)
            assert plan.blocks == 528 and plan.blocks * F.WARPS >= 4 * 4 * 132
    assert F._plan(2, 1080, 1920, True, 0) == F.Plan(8, 528, 8, True, 5)
    assert F._plan(8, 1080, 1920, True, 0) == F.Plan(8, 528, 8, True, 17)
    assert F._plan(8, 1080, 1920, False, 0) == F.Plan(16, 528, 4, True, 9)
    assert F._plan(1, 4, 6, True, 0) == F.Plan(8, 1, 1, False, 1)
    assert F._plan(1, 64, 1024, False, 0).blocks == 8


def test_plan_takes_the_aligned_path_exactly_when_base_and_pitch_are():
    for W in (1920, 16, 32, 1918, 262, 14, 18, 8, 24):
        for has_bgr in (True, False):
            pitch = W * (3 if has_bgr else 1)
            for ptr in (0, 1, 4, 8, 16, 1 << 20, (1 << 20) + 3):
                want = ptr % 16 == 0 and pitch % 16 == 0
                assert F._plan(2, 8, W, has_bgr, ptr).vec == want, (W, has_bgr, ptr)


# ---------------------------------------------------------------------------
# the kernel's source on the host

@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """fused_preproc.cu built for the host (tests/cuda_host_emu.py)."""
    fn = cuda_host_emu.build(CSRC / "fused_preproc.cu", tmp_path_factory.mktemp("gauss5_host"),
                             "opencv_gauss5_down2", 2)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    return fn


def _host_run(fn, x, sigma, has_bgr, offset=0, blocks=None, taps=None):
    """The kernel on host memory at `offset` bytes past a 16-byte boundary;
    returns (error, output)."""
    N, H, W = x.shape[:3]
    buf = np.zeros(x.size + 32, np.uint8)
    start = (-buf.ctypes.data) % 16 + offset
    buf[start:start + x.size] = x.reshape(-1)
    ptr = buf.ctypes.data + start
    plan = F._plan(N, H, W, has_bgr, ptr)
    if blocks:
        plan = plan._replace(blocks=blocks)
    out = np.zeros((N, H // 2, W // 2), np.uint8)
    args = (*(taps or F._taps(sigma)), plan.px, plan.blocks, plan.gx, int(plan.vec))
    err = fn(ptr, out.ctypes.data, N, H, W, int(has_bgr), (ctypes.c_int * 9)(*args), None)
    return err, out


@pytest.mark.parametrize("has_bgr", [True, False])
def test_kernel_source_on_the_host_equals_plain(host_kernel, has_bgr):
    """Both paths (aligned rows, and a base one byte off or rows of W % 16
    != 0), one strip -/+ 2 and a ragged last strip, H = 2
    and 4, N = 1 and 3, sigma 0, 0.1 (the identity taps), 1.5 and 20; runs
    that end at every step of the unrolled loop and cross column groups and
    images (few blocks)."""
    rng = np.random.default_rng(int(has_bgr))
    plain = F.fused_gray_gauss5_down2_plain if has_bgr else F.gauss5_down2_u8_plain
    # (shape, base offset, blocks): strips of 8 BGR / 16 gray pixels, one
    # strip -/+ 2 (6, 10; 14, 18), ragged last strips (518, 262)
    cases = [((1, 4, 6), 0, None), ((1, 2, 2), 0, None), ((1, 2, 16), 0, None),
             ((1, 4, 14), 0, None), ((1, 6, 18), 1, None), ((3, 12, 32), 0, None),
             ((3, 12, 32), 1, None), ((2, 10, 518), 0, None), ((1, 8, 512), 0, None),
             ((3, 22, 1056), 0, 1), ((2, 26, 544), 0, 3), ((1, 14, 48), 0, 1),
             ((1, 8, 10), 0, None), ((2, 10, 262), 0, 1)]
    for shape, offset, blocks in cases:
        x = rng.integers(0, 256, shape + ((3,) if has_bgr else ()), np.uint8)
        for sigma in (0.0, 0.1, 1.5, 20.0):
            err, got = _host_run(host_kernel, x, sigma, has_bgr, offset, blocks)
            assert err == 0
            want = plain(torch.from_numpy(x), sigma).numpy()
            np.testing.assert_array_equal(got, want, err_msg=str((shape, offset, sigma)))


def test_kernel_entry_on_the_host_refuses_bad_taps(host_kernel):
    x = np.zeros((1, 4, 6, 3), np.uint8)
    for taps in ([16, 64, 96, 60, 20], [16, 64, 90, 64, 16], [-4, 68, 128, 68, -4]):
        assert _host_run(host_kernel, x, 0.0, True, taps=taps)[0] != 0
