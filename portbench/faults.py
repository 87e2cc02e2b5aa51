"""Faults planted under a run's timed path, each wrapping the
configuration's call: the check has to read ``correct`` false for every
one.  ``test_portbench_faults.py`` plants them on the CPU at a small size,
``calibrate.py --faults 1`` on the card at the cell's own."""

import torch


def _map(out, fn):
    return fn(out) if torch.is_tensor(out) else type(out)(fn(t) for t in out)


def stale(entry):
    """The step hands back what it produced for the call before."""
    last = []

    def f(x):
        out = entry(x)
        last.append(out)
        return last.pop(0) if len(last) > 1 else out
    return f


def half_batch(entry):
    """Half of the batch left out: the first half's outputs stand in for it."""
    def f(x):
        n = x.shape[0] // 2
        out = entry(x[:n])
        return _map(out, lambda t: torch.cat([t, t]) if t.dim() >= 4 else t)
    return f


def altered(entry):
    """One pixel of the first output altered where it is produced."""
    def f(x):
        out = entry(x)
        first = out if torch.is_tensor(out) else out[0]
        bad = first.clone()
        bad.view(-1)[bad.numel() // 2] ^= 0x80
        return bad if torch.is_tensor(out) else (bad, *out[1:])
    return f


FAULTS = {"stale": stale, "half_batch": half_batch, "altered": altered}
