"""Kernel dispatch registry — the `CALL_HAL` analogue (twin of
``opencv_tpu/core/dispatch.py``).

Two tiers: hand-written CUDA kernels registered here per (op, dtype,
ksize, border, …) predicate, and the plain PyTorch composition each op
carries beside its lookup.

Kernel side::

    @register("sep_filter_u8", lambda ctx: ctx["kw"] <= 31 and ...)
    def _cuda_sep_filter(ctx, x, kx, ky):
        ...

Op side::

    fn = lookup("sep_filter_u8", x.device, kw=kw, kh=kh, ...)
    if fn is not None:
        return fn(x, kx, ky)
    # ... plain torch ...

The device of the input decides: a CUDA tensor whose ctx passes a
predicate gets that kernel, anything else the plain tier.  There is no
switch that sends CUDA tensors to the plain tier.  Every resolution bumps a
``tier.<op>.<cuda|plain>`` counter, read with :func:`tier_stats`.
"""

from __future__ import annotations

import collections
import functools

import torch

__all__ = ["register", "lookup", "count", "tier_stats", "reset_tier_stats"]

_REGISTRY: dict = {}
_COUNTERS: collections.Counter = collections.Counter()


def register(op: str, predicate=None):
    """Register a kernel implementation for `op`; first match wins."""

    def deco(fn):
        _REGISTRY.setdefault(op, []).append((predicate, fn))
        return fn

    return deco


def lookup(op: str, device: torch.device, **ctx):
    """Return the first registered kernel whose predicate accepts `ctx`
    (bound to that ctx) when `device` is a CUDA device, else None (the
    caller runs its plain version)."""
    if device.type == "cuda":
        for pred, fn in _REGISTRY.get(op, ()):
            if pred is None or pred(ctx):
                _COUNTERS[f"tier.{op}.cuda"] += 1
                return functools.partial(fn, ctx)
    _COUNTERS[f"tier.{op}.plain"] += 1
    return None


def count(counter: str, n: int = 1) -> None:
    """Bump `counter` by `n` (``utils.trace.count``)."""
    _COUNTERS[counter] += n


def tier_stats() -> dict:
    """Counters of which tier served each op since the last reset."""
    return dict(_COUNTERS)


def reset_tier_stats() -> None:
    _COUNTERS.clear()
