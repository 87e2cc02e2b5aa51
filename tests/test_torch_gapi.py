"""G-API of the port (``opencv_tpu_torch/gapi.py``) against the JAX
package's ``opencv_tpu/gapi.py``, on the CPU: GComputation graphs run
through the port's ops equal the JAX package's outputs; the JSON bytes
that either package writes load in the other and run to the same output;
``pipeline`` and ``Stream`` give the eager outputs in order;
``serialize_compiled`` round-trips the flagship graph through
``torch.export`` bytes to the same outputs; and the kernels' custom ops
(``opencv_tpu_torch::sep_filter``, ``pyr_down``, ``gauss5_down2``, CUDA
only) are recorded by export as op calls and run again after loading,
rehearsed here with CPU implementations registered for the scope of the
test (the plain versions)."""

import io
import json

import numpy as np
import pytest
import torch

from torch_threads import _one_torch_thread  # noqa: F401

import opencv_tpu as jcv
from opencv_tpu import gapi as jg
import opencv_tpu_torch as tcv
from opencv_tpu_torch import entry as E
from opencv_tpu_torch import gapi as tg
from opencv_tpu_torch.kernels import fused_preproc as FP
from opencv_tpu_torch.kernels import sepfilter as S

SHAPE = (2, 108, 192, 3)


def _graph(g):
    gin = g.GMat()
    gray = g.g_op("cvtColor", gin, code=tcv.COLOR_BGR2GRAY)
    b = g.g_op("gaussianBlur", gray, ksize=(5, 5), sigmaX=0.0)
    r = g.g_op("resize", b, dsize=(32, 24))
    e = g.g_op("erode", gray, kernel=np.ones((3, 3), np.uint8).tolist())
    return g.GComputation(gin, [r, g.g_op("pyrDown", gray), e])


def _multi(g):
    a, bg = g.GMat(), g.GMat()
    return g.GComputation([a, bg], [a + bg, g.g_op("absDiff", a, bg), a - bg, a * bg])


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_op_registry_equals_opencv_tpu():
    assert tg.op_registry() == jg.op_registry()
    with pytest.raises(KeyError):
        tg.g_op("noSuchOp", tg.GMat())


def test_graphs_equal_opencv_tpu():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (48, 64, 3), np.uint8)
    for got, want in zip(_graph(tg).apply(img), _graph(jg).apply(img)):
        np.testing.assert_array_equal(_np(got), _np(want))
    x, y = (rng.integers(0, 256, (8, 8), np.uint8) for _ in range(2))
    for got, want in zip(_multi(tg).apply(x, y), _multi(jg).apply(x, y)):
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("make", [_graph, _multi])
def test_bytes_cross_load_both_ways(make):
    """Bytes written by either package load in the other: the same graph
    (ops, consts, wiring) and the same outputs."""
    rng = np.random.default_rng(1)
    args = ((rng.integers(0, 256, (40, 56, 3), np.uint8),) if make is _graph
            else tuple(rng.integers(0, 256, (8, 8), np.uint8) for _ in range(2)))
    for src, dst in ((tg, jg), (jg, tg)):
        blob = src.serialize(make(src))
        back = dst.deserialize(blob)
        assert json.loads(dst.serialize(back)) == json.loads(blob)
        for got, want in zip(back.apply(*args), make(src).apply(*args)):
            np.testing.assert_array_equal(_np(got), _np(want))
    with pytest.raises(ValueError):
        tg.deserialize(json.dumps({"version": 2}).encode())


def test_pipeline_and_stream_equal_eager():
    @tcv.pipeline
    def pipe(imgs):
        return tcv.GaussianBlur(tcv.cvtColor(imgs, tcv.COLOR_BGR2GRAY), (3, 3), 0)

    assert hasattr(pipe, "lower") and tcv.Stream(pipe).fn is pipe
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, 256, (2, 32, 32, 3), np.uint8) for _ in range(3)]
    outs = list(tcv.Stream(pipe, device="cpu").run(batches))
    jouts = list(jcv.Stream(jcv.pipeline(lambda x: jcv.GaussianBlur(
        jcv.cvtColor(x, jcv.COLOR_BGR2GRAY), (3, 3), 0))).run(batches))
    assert len(outs) == 3
    for o, j, b in zip(outs, jouts, batches):
        assert tuple(o.shape) == (2, 32, 32, 1)
        np.testing.assert_array_equal(o.numpy(), np.asarray(j))
        assert torch.equal(o, pipe(torch.from_numpy(b)))
    assert tcv.Stream(lambda x: x).device == torch.device("cuda")


def test_flagship_graph_through_stream_and_compiled():
    """entry.gapi_flagship over forward_gapi's Stream equals entry.forward
    and pyrDown of the gray frame; serialize_compiled round-trips it."""
    batches = [E.make_batch(SHAPE, s) for s in range(2)]
    comp = E.gapi_flagship(SHAPE)
    outs = E.forward_gapi(batches, comp, device="cpu")
    fn = tg.deserialize_compiled(tg.serialize_compiled(comp.apply, batches[0]))
    for (w, half), b in zip(outs, batches):
        x = torch.from_numpy(b)
        assert torch.equal(w, E.forward(x))
        assert torch.equal(half, tcv.pyrDown(tcv.cvtColor(x, tcv.COLOR_BGR2GRAY)))
        cw, chalf = fn(b)
        assert torch.equal(cw, w) and torch.equal(chalf, half)


def _cpu_impls(lib):
    """The plain versions as CPU implementations of the kernels' ops."""
    lib.impl("sep_filter", lambda x, kx, ky, shift, delta, scale, i16, border, bval:
             S.sep_filter_int_plain(x, kx, ky, shift, delta, scale,
                                    torch.int16 if i16 else torch.uint8, border), "CPU")
    lib.impl("pyr_down", lambda x, border: S.pyr_down_u8_plain(x, border), "CPU")
    lib.impl("gauss5_down2", lambda x, taps, has_bgr, plan: (
        FP.fused_gray_gauss5_down2_plain if has_bgr else FP.gauss5_down2_u8_plain)(x), "CPU")


def test_exported_kernels_are_op_calls():
    """The three custom ops under torch.export: their fake implementations
    give the outputs' shapes and dtypes, the saved program holds the op
    calls, and the loaded program runs them (here on CPU implementations
    of the test's scope) to the plain versions' outputs."""
    x = torch.randint(0, 256, (2, 40, 66, 3), dtype=torch.uint8)
    ops = torch.ops.opencv_tpu_torch
    k5 = [1, 4, 6, 4, 1]

    def f(x):
        return (ops.sep_filter(x, k5, k5, 8, 0, None, False, 4, [0, 0, 0, 0]),
                ops.sep_filter(x, [-1, 0, 1], [1, 2, 1], 0, 3, 0.5, True, 1, [0, 0, 0, 0]),
                ops.pyr_down(x, 4), ops.gauss5_down2(x, FP._taps(0.0), True, []))

    with torch.library._scoped_library("opencv_tpu_torch", "IMPL") as lib:
        _cpu_impls(lib)
        blob = tg.serialize_compiled(f, x)
        prog = torch.export.load(io.BytesIO(blob))
        called = [str(n.target) for n in prog.graph.nodes if n.op == "call_function"]
        assert called == ["opencv_tpu_torch.sep_filter.default"] * 2 + [
            "opencv_tpu_torch.pyr_down.default", "opencv_tpu_torch.gauss5_down2.default"]
        outs = tg.deserialize_compiled(blob)(x)
        want = (S.sep_filter_int_plain(x, k5, k5, 8),
                S.sep_filter_int_plain(x, [-1, 0, 1], [1, 2, 1], 0, 3, 0.5, torch.int16, 1),
                S.pyr_down_u8_plain(x), FP.fused_gray_gauss5_down2_plain(x))
        for got, w in zip(outs, want):
            assert got.dtype == w.dtype and torch.equal(got, w)
    with pytest.raises(NotImplementedError):
        ops.pyr_down(x, 4)      # no CPU implementation outside the test's scope
