"""Tracing and profiling — the port's replacement for CV_TRACE_* /
CV_INSTRUMENT_REGION (core/src/trace.cpp, core/src/utils/instrumentation.cpp);
twin of ``opencv_tpu/utils/trace.py``.

Three tiers, as in the JAX package:

1. **Host region tracing** (`trace_region`, the CV_TRACE_REGION
   analogue): nested spans with wall times and optional args, recorded
   into a per-thread buffer when tracing is enabled.  `dump_trace()`
   writes the Chrome trace-event format (load in chrome://tracing or
   Perfetto).  Enable programmatically (`start()`) or through the
   environment: ``OPENCV_TPU_TRACE=1`` traces the whole process and writes
   ``OPENCV_TPU_TRACE_LOCATION`` (default ``opencv_tpu_trace.json``) at
   exit.

2. **Device annotation**: while a ``torch.profiler`` runs, every
   `trace_region` is also a ``torch.profiler.record_function``, so the
   work it encloses is labelled in the trace (`profile_to`), on the CPU
   and on the card.

3. **Dispatch-tier instrumentation**: ``core.dispatch.lookup`` counts which
   tier (CUDA kernel or plain PyTorch) served each op; `tier_stats()` is
   ``core.dispatch.tier_stats()``, so the counters live in one place.

**The off path.** Spans sit on the hot path (the entries and the public
ops they call), so with the host buffer off and no profiler running a
span costs one check of two flags and enters no
``record_function`` (which alone costs some 10 us of host time).  Under
``torch.compile`` or ``torch.export`` a span records nothing, so an
exported program holds only the work.  A span launches nothing on the card
and never waits for it.
"""

from __future__ import annotations

import atexit
import contextlib
import functools
import json
import os
import threading
import time

import torch
# its `_is_profiler_enabled`: whether a torch profiler (or emit_nvtx) runs,
# torch's own Python flag, which torch.compile reads as a constant
from torch.autograd import profiler as _autograd_profiler

from ..core import dispatch

_TLS = threading.local()
_LOCK = threading.Lock()
_ENABLED = False
_EVENTS: list[dict] = []        # completed spans, Chrome "X" events
_T0 = time.perf_counter()


def _now_us() -> float:
    return (time.perf_counter() - _T0) * 1e6


def is_enabled() -> bool:
    return _ENABLED


def start() -> None:
    """Begin recording host spans (a span is a device annotation whenever
    a torch profiler runs, whether or not this is on)."""
    global _ENABLED
    _ENABLED = True


def stop() -> None:
    global _ENABLED
    _ENABLED = False


def reset() -> None:
    with _LOCK:
        _EVENTS.clear()
        dispatch.reset_tier_stats()


def _depth() -> int:
    return getattr(_TLS, "depth", 0)


_OFF = contextlib.nullcontext()


class _Span:
    """One recording span: a ``record_function`` while a profiler runs,
    and a host-buffer event while tracing is enabled."""

    __slots__ = ("name", "args", "_rf", "_t0")

    def __init__(self, name: str, args: dict):
        self.name, self.args = name, args
        self._rf = self._t0 = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        if _ENABLED:
            _TLS.depth = _depth() + 1
            self._t0 = _now_us()
        return self

    def __exit__(self, *exc):
        if self._t0 is not None:
            t1 = _now_us()
            _TLS.depth -= 1
            ev = {"name": self.name, "ph": "X", "ts": self._t0, "dur": t1 - self._t0,
                  "pid": os.getpid(), "tid": threading.get_ident(),
                  "args": {"depth": _depth(), **self.args}}
            with _LOCK:
                _EVENTS.append(ev)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def trace_region(name: str, **args):
    """`CV_TRACE_REGION` equivalent, a context manager: label the region in
    a running torch.profiler trace and, when tracing is enabled, record a
    nested host span with optional args (CV_TRACE_ARG).  Off both, or
    under compile or export, it is a no-op."""
    if not (_ENABLED or _autograd_profiler._is_profiler_enabled) \
            or torch.compiler.is_compiling() \
            or torch.compiler.is_exporting():
        return _OFF
    return _Span(name, args)


def region(name: str):
    """Decorator form of trace_region; the wrapper keeps the function's
    name, doc, signature and ``__wrapped__``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            if not (_ENABLED or _autograd_profiler._is_profiler_enabled):
                return fn(*a, **kw)
            with trace_region(name):
                return fn(*a, **kw)
        return wrapped
    return deco


def count(counter: str, n: int = 1) -> None:
    """Bump an instrumentation counter (dispatch tiers use
    ``tier.<op>.<tier>``), among the dispatch registry's counters."""
    dispatch.count(counter, n)


def tier_stats() -> dict:
    """Counters of which dispatch tier served each op since reset()."""
    return dispatch.tier_stats()


def events() -> list:
    with _LOCK:
        return list(_EVENTS)


def dump_trace(path: str) -> str:
    """Write recorded spans + counters as Chrome trace-event JSON
    (chrome://tracing / Perfetto / `about:tracing`)."""
    with _LOCK:
        evs = list(_EVENTS)
    doc = {"traceEvents": evs,
           "otherData": {"counters": tier_stats(),
                         "origin": "opencv_tpu trace_region"}}
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


@contextlib.contextmanager
def profile_to(logdir: str):
    """Profile the enclosed block with ``torch.profiler`` (the CPU, and the
    card's CUDA activity when there is one) and write its Chrome trace to
    ``<logdir>/trace.json``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# --- OPENCV_TRACE-style environment activation (core/src/trace.cpp:
# getTraceLevel reads OPENCV_TRACE; location via OPENCV_TRACE_LOCATION)
if os.environ.get("OPENCV_TPU_TRACE", "") not in ("", "0"):
    start()

    @atexit.register
    def _dump_at_exit():
        if _EVENTS or tier_stats():
            dump_trace(os.environ.get("OPENCV_TPU_TRACE_LOCATION",
                                      "opencv_tpu_trace.json"))
