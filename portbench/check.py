"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference run on the same input batch.

Numbers compared, each against the limit the configuration's file gives:

- ``max_abs_diff``: the largest difference, in u8 levels, of any pixel of
  any image output;
- ``mismatch_ppm``: the pixels of the image outputs that differ at all,
  per million;
- ``totals_off``: for a configuration that names ``exact`` outputs (the
  int32 totals), how many of their values differ.

An output that is missing or has another shape counts as every pixel
wrong.
"""

from __future__ import annotations

import torch


def compare(cell, pairs, device, low: str = ""):
    """``(numbers, failed)`` over `pairs` of (input batch, outputs by name):
    the numbers over all pairs, and how many pairs fail a limit alone.
    `low` names a control of the reference (``reference/common.py``) to
    compare in the outputs' place (pass None for the outputs)."""
    per_pair = [_numbers(cell, x.to(device), outs, device, low) for x, outs in pairs]
    limits = cell.config["limits"]
    failed = sum(bool(failures(_total([n]), limits)) for n in per_pair)
    return _total(per_pair), failed


def _numbers(cell, x, outs, device, low):
    """(largest difference, pixels wrong, pixels, exact values off) of one
    batch."""
    cfg = cell.config
    exact = set(cfg.get("exact", ()))
    want = cell.reference.forward(x, cfg)
    if low:
        outs = cell.reference.forward(x, cfg, low=low)
    worst, wrong, total, off = 0, 0, 0, 0
    for name, w in want.items():
        got = outs.get(name)
        if name in exact:
            w = w.cpu().long()
            g = got.cpu().long() if got is not None else None
            off += w.numel() if g is None or g.shape != w.shape else int((g != w).sum())
            continue
        total += w.numel()
        if got is None or tuple(got.shape) != tuple(w.shape):
            worst, wrong = 255, wrong + w.numel()
            continue
        d = (got.to(device).to(torch.int32) - w.to(torch.int32)).abs()
        worst = max(worst, int(d.max()))
        wrong += int((d > 0).sum())
    return worst, wrong, total, off, bool(exact)


def _total(per_pair) -> dict:
    numbers = {"max_abs_diff": max((n[0] for n in per_pair), default=0),
               "mismatch_ppm": 1e6 * sum(n[1] for n in per_pair)
               / max(sum(n[2] for n in per_pair), 1)}
    if any(n[4] for n in per_pair):
        numbers["totals_off"] = sum(n[3] for n in per_pair)
    return numbers


def failures(numbers: dict, limits: dict) -> list:
    """The names of the numbers over their limits."""
    return [k for k, v in numbers.items() if v > limits[k]]
