"""The port's spans at its layer boundaries (``utils/trace.py``) on the CPU:
free when off (no ``record_function`` entered), the span tree of the two
benchmarked entries under a CPU ``torch.profiler``, outputs equal with
spans on and off, a kernel launch and a host-table upload opening no span,
nothing recorded under ``torch.export``, and the wrapped ops' public
surface."""

import inspect
import io
import json
import os

import pytest
import torch

import opencv_tpu_torch as tcv
from opencv_tpu_torch import entry, gapi
from opencv_tpu_torch.core.arrays import to_device
from opencv_tpu_torch.kernels._build import Kernel
from opencv_tpu_torch.utils import trace

from torch_threads import _one_torch_thread  # noqa: F401

OPS = ("cvtColor", "GaussianBlur", "resize", "warpAffine", "warpPerspective")
ENTRIES = {"forward": (2, 48, 80, 3), "forward_resize_warp_4k": (2, 40, 64, 3)}
SPANS = {"forward": ["cvtColor", "GaussianBlur", "resize", "warpAffine"],
         "forward_resize_warp_4k": ["resize"] * 3 + ["warpAffine", "warpPerspective", "totals"]}


def _batch(shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, shape, dtype=torch.uint8, generator=g)


@pytest.fixture
def no_record_function(monkeypatch):
    """torch.profiler.record_function raises if a span enters it."""
    def refuse(*a, **kw):
        raise AssertionError("a span entered record_function")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)


@pytest.mark.parametrize("host_buffer", [False, True])
@pytest.mark.parametrize("name", ENTRIES)
def test_spans_without_profiler_enter_no_record_function(no_record_function, name,
                                                         host_buffer):
    """Off, a span is a flag check; with the host buffer on and no profiler
    it records its host span and still enters no record_function."""
    trace.reset()
    if host_buffer:
        trace.start()
    try:
        getattr(entry, name)(_batch(ENTRIES[name]))
        recorded = [e["name"] for e in trace.events()]
    finally:
        trace.stop()
        trace.reset()
    assert not torch.autograd._profiler_enabled()
    if host_buffer:
        assert recorded == SPANS[name] + [f"entry.{name}"]
    else:
        assert recorded == []


def _tree(events):
    """The user spans of a Chrome trace as nested (name, children) lists,
    by containment on one thread."""
    spans = sorted(((e["ts"], -e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation"))
    root, stack = ("", []), []
    for ts, neg, name in spans:
        node = (name, [])
        while stack and stack[-1][0] + stack[-1][1] < ts:
            stack.pop()
        (stack[-1][2] if stack else root)[1].append(node)
        stack.append((ts, -neg, node))
    return root[1]


def _profiled(fn, tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return out, _tree(json.load(f)["traceEvents"])


def test_forward_span_tree(tmp_path):
    """entry.forward, then its four ops in order, each a leaf: the warp's
    map-vector uploads open no span of their own."""
    _, tree = _profiled(lambda: entry.forward(_batch(ENTRIES["forward"])), tmp_path)
    assert [n for n, _ in tree] == ["entry.forward"]
    ops = tree[0][1]
    assert ops == [(n, []) for n in SPANS["forward"]]


def test_forward_resize_warp_4k_span_tree(tmp_path):
    """The 4K entry: three resizes, two warps, and the ``totals`` span over
    the three reductions, each a leaf."""
    _, tree = _profiled(
        lambda: entry.forward_resize_warp_4k(_batch(ENTRIES["forward_resize_warp_4k"])), tmp_path)
    assert [n for n, _ in tree] == ["entry.forward_resize_warp_4k"]
    assert tree[0][1] == [(n, []) for n in SPANS["forward_resize_warp_4k"]]


@pytest.mark.parametrize("name", ENTRIES)
def test_outputs_equal_with_spans_on_and_off(name, tmp_path):
    x = _batch(ENTRIES[name], seed=3)
    fn = getattr(entry, name)
    off = fn(x)
    trace.reset()
    trace.start()
    try:
        host = fn(x)
    finally:
        trace.stop()
        trace.reset()
    prof, _ = _profiled(lambda: fn(x), tmp_path)

    def outs(o):
        return o if isinstance(o, tuple) else (o,)

    for got in (host, prof):
        for a, b in zip(outs(off), outs(got), strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_kernel_launch_opens_no_span(tmp_path):
    """A launch of the library is matched to its op by its own launch
    record, so it opens no span, and is counted as before (a stand-in
    entry point, no card: device -1 selects none)."""
    k = Kernel("opencv_test_entry", [], routes=("k5",))
    k._fn = lambda *a: 0
    _, tree = _profiled(lambda: (k(-1, route="k5"), k(-1)), tmp_path)
    assert tree == []
    assert k.launches == 2 and k.routes == {"k5": 1}


def test_upload_opens_no_span(tmp_path):
    """A host-table upload is attributed to the op that makes it, so it
    opens no span of its own, and is the same table."""
    table = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    out, tree = _profiled(lambda: to_device(table.numpy(), "cpu"), tmp_path)
    assert tree == [] and torch.equal(out, table)


def test_export_records_no_span():
    """Under torch.export a span records nothing, with the host buffer on:
    the exported graph holds the work alone, and runs to the same output."""
    x = _batch((1, 24, 32, 3))
    trace.reset()
    trace.start()
    try:
        blob = gapi.serialize_compiled(entry.forward, x)
        recorded = trace.events()
    finally:
        trace.stop()
        trace.reset()
    assert recorded == []
    prog = torch.export.load(io.BytesIO(blob))
    targets = [str(n.target) for n in prog.graph.nodes if n.op == "call_function"]
    assert targets and not any("profiler" in t or "record_function" in t for t in targets)
    assert torch.equal(gapi.deserialize_compiled(blob)(x), entry.forward(x))


@pytest.mark.parametrize("name", OPS + ("entry.forward", "entry.forward_resize_warp_4k"))
def test_wrapped_function_keeps_its_surface(name):
    """A function under ``region`` keeps its name, doc, module, signature
    and ``__wrapped__``."""
    if name.startswith("entry."):
        fn = getattr(entry, name.split(".", 1)[1])
    else:
        fn = getattr(tcv, name)
    inner = fn.__wrapped__
    assert fn.__name__ == inner.__name__ == name.rsplit(".", 1)[-1]
    assert fn.__doc__ == inner.__doc__ and fn.__module__ == inner.__module__
    assert inspect.signature(fn) == inspect.signature(inner)
    assert fn.__module__.startswith("opencv_tpu_torch")
