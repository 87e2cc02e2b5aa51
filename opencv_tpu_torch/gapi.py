"""Graph pipelines and streaming — the G-API analogue (modules/gapi), twin
of ``opencv_tpu/gapi.py``.

The reference builds lazy expression graphs, fuses islands, and runs a
streaming executor (gapi/src/compiler/gcompiler.cpp:220-284,
executor/gstreamingexecutor.cpp).  In the JAX package ``jax.jit`` compiles a
pipeline into one XLA program.  Here a pipeline runs eagerly on both
devices, op by op through the port's kernels (no CUDA graph and no
``torch.compile``, which would need Triton on the card and a compiler on
the CPU).  :class:`Stream` overlaps the copy of the next batch to the card
with the compute on the current one.

``GComputation`` graphs serialize as the JSON bytes of the JAX package, so a
graph written by either package loads in the other.
``serialize_compiled`` exports a pipeline with ``torch.export`` (the
kernels are ``opencv_tpu_torch::`` custom ops, so an exported program
launches the same kernels once it is loaded).
"""

from __future__ import annotations

import collections
import functools
import io
import itertools
import json as _json

import numpy as _np
import torch

from .core.arrays import as_tensor

__all__ = ["pipeline", "Stream", "GMat", "GComputation", "serialize", "deserialize",
           "serialize_compiled", "deserialize_compiled", "op_registry"]


def pipeline(fn=None, *, donate: bool = False):
    """Mark a whole image pipeline as one unit, run eagerly.

    Use as a decorator::

        @tcv.pipeline
        def preprocess(imgs): ...

    The wrapper carries ``lower`` (the function itself), the marker
    :class:`Stream` takes for an already wrapped pipeline; `donate` is kept
    for the reference's signature (a torch op frees its inputs' memory when
    the caller drops them)."""
    def wrap(f):
        @functools.wraps(f)
        def run(*args, **kwargs):
            return f(*args, **kwargs)

        run.lower = f
        return run

    return wrap(fn) if fn is not None else wrap


class Stream:
    """Double-buffered host→device feed: the copy of the next batches
    overlaps the compute on the current one.

    On a CUDA `device` each batch is copied into pinned host memory and
    sent with ``non_blocking`` on a side CUDA stream, with an event the
    compute stream waits on before it uses the batch; up to `prefetch`
    batches are in flight.  On the CPU the batches run in order.

    >>> stream = Stream(pipeline_fn)
    >>> for out in stream.run(batches):
    ...     consume(out)
    """

    def __init__(self, fn, prefetch: int = 2, device=None):
        self.fn = pipeline(fn) if not hasattr(fn, "lower") else fn
        self.prefetch = prefetch
        self.device = torch.device("cuda" if device is None else device)

    def run(self, batches):
        dev = self.device
        if dev.type != "cuda":
            for b in batches:
                yield self.fn(as_tensor(b).to(dev))
            return
        copier = torch.cuda.Stream(dev)
        compute = torch.cuda.current_stream(dev)

        def send(b):
            host = as_tensor(b)
            if host.device.type == "cpu" and not host.is_pinned():
                host = host.pin_memory()
            with torch.cuda.stream(copier):
                x = host.to(dev, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(copier)
            return x, ready, host      # the pinned copy lives until its batch is used

        it = iter(batches)
        queue = collections.deque(send(b) for b in itertools.islice(it, max(1, self.prefetch)))
        while queue:
            x, ready, _ = queue.popleft()
            compute.wait_event(ready)
            x.record_stream(compute)
            out = self.fn(x)
            nxt = next(it, None)
            if nxt is not None:
                queue.append(send(nxt))
            yield out


# --------------------------------------------------------------------------
# Expression graphs + serialization (modules/gapi s11n.hpp, api/s11n.cpp)
# --------------------------------------------------------------------------
#
# A graph is a small DAG of named ops over GMat placeholders, serialized as
# the JAX package's JSON; `GComputation.apply` interprets it through the
# port's ops.


def _g_ops():
    import opencv_tpu_torch as cv

    return {
        "add": lambda a, b: cv.add(a, b),
        "sub": lambda a, b: cv.subtract(a, b),
        "mul": lambda a, b: cv.multiply(a, b),
        "div": lambda a, b: cv.divide(a, b),
        "absDiff": lambda a, b: cv.absdiff(a, b),
        "addWeighted": lambda a, b, alpha=1.0, beta=1.0, gamma=0.0:
            cv.addWeighted(a, alpha, b, beta, gamma),
        "bitwise_and": lambda a, b: cv.bitwise_and(a, b),
        "bitwise_or": lambda a, b: cv.bitwise_or(a, b),
        "bitwise_xor": lambda a, b: cv.bitwise_xor(a, b),
        "bitwise_not": lambda a: cv.bitwise_not(a),
        "cvtColor": lambda a, code=6: cv.cvtColor(a, code),
        "resize": lambda a, dsize=None, fx=0.0, fy=0.0, interpolation=1:
            cv.resize(a, tuple(dsize) if dsize else None, fx=fx, fy=fy,
                      interpolation=interpolation),
        "gaussianBlur": lambda a, ksize=(3, 3), sigmaX=0.0, sigmaY=0.0:
            cv.GaussianBlur(a, tuple(ksize), sigmaX, sigmaY=sigmaY),
        "blur": lambda a, ksize=(3, 3): cv.blur(a, tuple(ksize)),
        "medianBlur": lambda a, ksize=3: cv.medianBlur(a, ksize),
        "erode": lambda a, kernel=None, iterations=1:
            cv.erode(a, _np.asarray(kernel, _np.uint8), iterations=iterations),
        "dilate": lambda a, kernel=None, iterations=1:
            cv.dilate(a, _np.asarray(kernel, _np.uint8), iterations=iterations),
        "threshold": lambda a, thresh=0.0, maxval=255.0, type=0:
            cv.threshold(a, thresh, maxval, type)[1],
        "filter2D": lambda a, kernel=None, ddepth=-1:
            cv.filter2D(a, ddepth, _np.asarray(kernel, _np.float32)),
        "sobel": lambda a, ddepth=-1, dx=1, dy=0, ksize=3:
            cv.Sobel(a, ddepth, dx, dy, ksize=ksize),
        "canny": lambda a, threshold1=50.0, threshold2=150.0:
            cv.Canny(a, threshold1, threshold2),
        "normalize": lambda a, alpha=0.0, beta=1.0, norm_type=4:
            cv.normalize(a, None, alpha, beta, norm_type),
        "warpAffine": lambda a, M=None, dsize=None:
            cv.warpAffine(a, _np.asarray(M, _np.float64), tuple(dsize)),
        "pyrDown": lambda a: cv.pyrDown(a),
        "pyrUp": lambda a: cv.pyrUp(a),
        "equalizeHist": lambda a: cv.equalizeHist(a),
        "flip": lambda a, flipCode=0: cv.flip(a, flipCode),
        "transpose": lambda a: cv.transpose(a),
        "crop": lambda a, rect=None: a[rect[1]:rect[1] + rect[3],
                                       rect[0]:rect[0] + rect[2]],
    }


def op_registry():
    """Names usable as graph ops (the kernel package analogue)."""
    return sorted(_g_ops().keys())


class GMat:
    """Lazy placeholder/expression node (cv::GMat)."""

    _counter = [0]

    def __init__(self, op=None, inputs=(), consts=None):
        self.id = GMat._counter[0]
        GMat._counter[0] += 1
        self.op = op                 # None => graph input
        self.inputs = list(inputs)
        self.consts = dict(consts or {})

    # expression sugar
    def __add__(self, other):
        return GMat("add", [self, other])

    def __sub__(self, other):
        return GMat("sub", [self, other])

    def __mul__(self, other):
        return GMat("mul", [self, other])


def g_op(name, *mats, **consts):
    """Build an op node: g_op("resize", gmat, dsize=(64, 48))."""
    ops = _g_ops()
    if name not in ops:
        raise KeyError(f"unknown gapi op {name!r}; see op_registry()")
    return GMat(name, list(mats), consts)


class GComputation:
    """cv::GComputation: a serializable op DAG, run op by op through the
    port's ops on apply (gcomputation.cpp; s11n.cpp for the byte form)."""

    def __init__(self, ins, outs):
        self.ins = list(ins) if isinstance(ins, (list, tuple)) else [ins]
        self.outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        self._nodes = self._topo()

    def _topo(self):
        order = []
        seen = set()

        def visit(n):
            if n.id in seen:
                return
            seen.add(n.id)
            for i in n.inputs:
                visit(i)
            order.append(n)

        for o in self.outs:
            visit(o)
        for i in self.ins:
            if i.id not in seen:
                order.insert(0, i)
                seen.add(i.id)
        return order

    def apply(self, *arrays):
        """Run the graph on the inputs' devices."""
        ops = _g_ops()
        env = {}
        for g, a in zip(self.ins, arrays):
            env[g.id] = a
        for n in self._nodes:
            if n.op is None:
                if n.id not in env:
                    raise ValueError("unbound graph input")
                continue
            args = [env[i.id] for i in n.inputs]
            env[n.id] = ops[n.op](*args, **n.consts)
        outs = [env[o.id] for o in self.outs]
        return outs[0] if len(outs) == 1 else tuple(outs)

    # ------------------------------------------------------------- s11n
    def to_bytes(self):
        nodes = [{"id": n.id, "op": n.op,
                  "inputs": [i.id for i in n.inputs],
                  "consts": {k: (v.tolist()
                                 if isinstance(v, _np.ndarray) else v)
                             for k, v in n.consts.items()}}
                 for n in self._nodes]
        doc = {"version": 1,
               "nodes": nodes,
               "ins": [g.id for g in self.ins],
               "outs": [g.id for g in self.outs]}
        return _json.dumps(doc).encode()

    @staticmethod
    def from_bytes(blob):
        doc = _json.loads(bytes(blob).decode())
        if doc.get("version") != 1:
            raise ValueError(f"gapi: unknown graph version {doc.get('version')!r}")
        by_id = {}
        for nd in doc["nodes"]:
            g = GMat(nd["op"], [by_id[i] for i in nd["inputs"]], nd["consts"])
            g.id = nd["id"]
            by_id[g.id] = g
        return GComputation([by_id[i] for i in doc["ins"]],
                            [by_id[i] for i in doc["outs"]])


def serialize(comp):
    """cv::gapi::serialize(GComputation) analogue."""
    return comp.to_bytes()


def deserialize(blob):
    """cv::gapi::deserialize<GComputation>() analogue."""
    return GComputation.from_bytes(blob)


class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def serialize_compiled(fn, *example_args):
    """A pipeline exported for `example_args` (arrays or tensors; shapes,
    dtypes and devices fixed) as the bytes of ``torch.export.save``: the
    compiled-artifact form (GCompiled s11n analogue).  Export traces the
    function on fake tensors (non-strict); a kernel on the card is the
    custom op that launches it."""
    args = tuple(as_tensor(a) for a in example_args)
    with torch.no_grad():
        exported = torch.export.export(_Fn(fn), args, strict=False)
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def deserialize_compiled(blob):
    """Rebuild a callable from :func:`serialize_compiled`'s bytes; it takes
    arrays or tensors of the exported shapes, dtypes and devices."""
    mod = torch.export.load(io.BytesIO(bytes(blob))).module()

    def run(*args):
        with torch.no_grad():
            return mod(*(as_tensor(a) for a in args))

    return run
