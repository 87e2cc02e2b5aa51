"""opencv_tpu_torch core layer vs opencv_tpu: constants, borders, fixed
point, NHWC batching, dispatch, and the no-JAX import rule."""

import ast
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import opencv_tpu.constants as JK
from opencv_tpu.core import borders as jb
from opencv_tpu.core.fixedpoint import saturate_cast as j_saturate_cast

import opencv_tpu_torch.constants as TK
from opencv_tpu_torch.core import borders as tb
from opencv_tpu_torch.core.arrays import from_batched, to_batched
from opencv_tpu_torch.core.dispatch import lookup, register, reset_tier_stats, tier_stats
from opencv_tpu_torch.core.fixedpoint import descale, saturate_cast

ROOT = pathlib.Path(__file__).resolve().parent.parent
BORDERS = [TK.BORDER_CONSTANT, TK.BORDER_REPLICATE, TK.BORDER_REFLECT,
           TK.BORDER_WRAP, TK.BORDER_REFLECT_101]


def _public(mod):
    return {k: getattr(mod, k) for k in dir(mod) if not k.startswith("_")
            and isinstance(getattr(mod, k), (int, float, str))}


def test_constants_equal_reference():
    ours, ref = _public(TK), _public(JK)
    assert ours.keys() == ref.keys()
    assert all(ours[k] == ref[k] for k in ref), [k for k in ref if ours[k] != ref[k]]


@pytest.mark.parametrize("border", BORDERS + [TK.BORDER_REFLECT_101 | TK.BORDER_ISOLATED])
def test_border_index(border):
    for length, before, after in ((1, 3, 2), (2, 5, 5), (7, 3, 4), (5, 12, 9)):
        np.testing.assert_array_equal(tb.border_index(length, before, after, border),
                                      jb.border_index(length, before, after, border))


@pytest.mark.parametrize("value", [0, 77, (11, 22, 33)])
@pytest.mark.parametrize("border", BORDERS)
def test_pad_nhwc(border, value):
    x = np.random.default_rng(border).integers(0, 256, (2, 5, 7, 3), np.uint8)
    pads = (2, 3, 4, 1)
    want = np.asarray(jb.pad_nhwc(jnp.asarray(x), *pads, border, value))
    got = tb.pad_nhwc(torch.from_numpy(x), *pads, border, value).numpy()
    np.testing.assert_array_equal(got, want)


def test_pad_nhwc_large_pad_and_float():
    x = np.random.default_rng(5).random((1, 3, 2, 2), dtype=np.float32)
    for border in BORDERS:
        want = np.asarray(jb.pad_nhwc(jnp.asarray(x), 7, 5, 6, 9, border, 0.5))
        got = tb.pad_nhwc(torch.from_numpy(x), 7, 5, 6, 9, border, 0.5).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.int8])
def test_saturate_cast(dtype):
    vals = np.array([-70000.0, -129.5, -0.5, 0.5, 1.5, 2.5, 127.5, 254.5, 255.5, 256.0,
                     32767.5, 1e6], np.float32)
    ints = np.array([-70000, -129, -1, 0, 128, 255, 256, 40000], np.int32)
    jdt = {torch.uint8: jnp.uint8, torch.int16: jnp.int16, torch.int8: jnp.int8}[dtype]
    for a in (vals, ints):
        want = np.asarray(j_saturate_cast(jnp.asarray(a), jdt))
        got = saturate_cast(torch.from_numpy(a), dtype).numpy()
        np.testing.assert_array_equal(got, want)


def test_descale():
    a = torch.arange(-5, 300, dtype=torch.int32)
    assert torch.equal(descale(a, 3), (a + 4) >> 3)


def test_batched_round_trip():
    img = np.zeros((4, 5), np.uint8)
    x, meta = to_batched(img)
    assert x.shape == (1, 4, 5, 1) and meta == "hw"
    assert from_batched(x, meta).shape == (4, 5)
    x, meta = to_batched(np.zeros((4, 5, 3), np.uint8))
    assert x.shape == (1, 4, 5, 3) and from_batched(x, meta).shape == (4, 5, 3)
    t = torch.zeros((2, 4, 5, 1), dtype=torch.uint8)
    x, meta = to_batched(t)
    assert x is t and from_batched(x, meta) is t
    with pytest.raises(ValueError):
        to_batched(np.zeros(3))


def test_dispatch_tiers():
    op = "test_torch_core.op"
    register(op, lambda ctx: ctx["k"] <= 3)(lambda ctx, v: ("kernel", ctx["k"], v))
    reset_tier_stats()
    assert lookup(op, torch.device("cpu"), k=1) is None
    fn = lookup(op, torch.device("cuda", 0), k=2)
    assert fn(5) == ("kernel", 2, 5)
    assert lookup(op, torch.device("cuda", 0), k=9) is None
    assert tier_stats() == {f"tier.{op}.plain": 2, f"tier.{op}.cuda": 1}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / "opencv_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "perf" / "profile_torch_forward.py"]
    assert len(files) > 10
    bad = [(f.name, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "opencv_tpu")]
    assert not bad, bad
