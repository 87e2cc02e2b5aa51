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

2. **Device annotation**: every `trace_region` is also a
   ``torch.profiler.record_function``, so the work it encloses is labelled
   in a ``torch.profiler`` trace (`profile_to`), on the CPU and on the card.

3. **Dispatch-tier instrumentation**: ``core.dispatch.lookup`` counts which
   tier (CUDA kernel or plain PyTorch) served each op; `tier_stats()` is
   ``core.dispatch.tier_stats()``, so the counters live in one place.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import threading
import time

import torch

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
    """Begin recording host spans (device annotations are always on)."""
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


@contextlib.contextmanager
def trace_region(name: str, **args):
    """`CV_TRACE_REGION` equivalent: label the region in a torch.profiler
    trace and, when tracing is enabled, record a nested host span with
    optional args (CV_TRACE_ARG)."""
    with torch.profiler.record_function(name):
        if not _ENABLED:
            yield
            return
        _TLS.depth = _depth() + 1
        t0 = _now_us()
        try:
            yield
        finally:
            t1 = _now_us()
            _TLS.depth -= 1
            ev = {"name": name, "ph": "X", "ts": t0, "dur": t1 - t0,
                  "pid": os.getpid(), "tid": threading.get_ident(),
                  "args": {"depth": _depth(), **args}}
            with _LOCK:
                _EVENTS.append(ev)


def region(name: str):
    """Decorator form of trace_region."""
    def deco(fn):
        def wrapped(*a, **kw):
            with trace_region(name):
                return fn(*a, **kw)
        wrapped.__name__ = getattr(fn, "__name__", name)
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
