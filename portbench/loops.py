"""The closed loops that offer a cell's traffic to the program: one caller
keeps ``depth`` batches in flight and waits only on the oldest.  A traffic
file names its loop under ``"loop"``; its other keys are the loop's
parameters.

- ``resident``: a ring of ``ring`` distinct batches already on the card is
  submitted, batch after batch, to the configuration's entry; outputs stay
  on the card.
- ``hostfed``: the same ring sits in pinned host memory, as
  ``DataLoader(pin_memory=True)`` hands batches out, and goes through the
  program's own feed, ``opencv_tpu_torch.gapi.Stream(entry,
  prefetch=depth)``; outputs stay on the card.

Each batch is timed from the host's call that submits it (for ``hostfed``:
the feed's hand-over of the batch to the Stream) to the host observing its
output complete.  ``stop(i)`` says whether batch ``i`` is still to be
submitted, so one loop serves the timed window, the warm-up and the traced
window alike.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field

import torch
from torch.profiler import record_function


@dataclass
class Window:
    """What a loop did: its start and end on the host clock, and each
    completed batch's (index, ring slot, latency in seconds)."""
    start: float = 0.0
    end: float = 0.0
    done: list = field(default_factory=list)


class _HostEvent:
    """The stand-in for a CUDA event on a CPU run (tests): the work is
    already done when the call returns."""

    def record(self):
        pass

    def synchronize(self):
        pass


def _event(device):
    ev = torch.cuda.Event() if device.type == "cuda" else _HostEvent()
    ev.record()
    return ev


class _InFlight:
    """Batches submitted and not yet seen complete, oldest first."""

    def __init__(self, window: Window, on_output):
        self.q = collections.deque()
        self.window = window
        self.on_output = on_output

    def add(self, i, slot, t_submit, ev, out):
        self.q.append((i, slot, t_submit, ev, out))

    def finish_oldest(self):
        i, slot, t_submit, ev, out = self.q.popleft()
        with record_function("wait"):
            ev.synchronize()
        self.window.done.append((i, slot, time.perf_counter() - t_submit))
        self.on_output(i, slot, out)

    def drain(self):
        while self.q:
            self.finish_oldest()


def resident(entry, ring, traffic, device, stop, on_output) -> Window:
    depth = int(traffic["depth"])
    w = Window(start=time.perf_counter())
    inflight = _InFlight(w, on_output)
    i = 0
    with record_function("window"):
        while not stop(i):
            if len(inflight.q) >= depth:
                inflight.finish_oldest()
            slot = i % len(ring)
            t_submit = time.perf_counter()
            with record_function("submit"):
                out = entry(ring[slot])
            inflight.add(i, slot, t_submit, _event(device), out)
            i += 1
        inflight.drain()
    w.end = time.perf_counter()
    return w


def hostfed(entry, ring, traffic, device, stop, on_output) -> Window:
    from opencv_tpu_torch.gapi import Stream

    depth = int(traffic["depth"])
    handed = []        # when the feed handed batch i to the Stream

    def feed():
        i = 0
        while not stop(i):
            with record_function("feed"):
                handed.append(time.perf_counter())
                batch = ring[i % len(ring)]
            yield batch
            i += 1

    w = Window(start=time.perf_counter())
    inflight = _InFlight(w, on_output)
    stream = Stream(entry, prefetch=depth, device=device).run(feed())
    i = 0
    with record_function("window"):
        while True:
            if len(inflight.q) >= depth:
                inflight.finish_oldest()
            with record_function("submit"):
                out = next(stream, None)
            if out is None:
                break
            inflight.add(i, i % len(ring), handed[i], _event(device), out)
            i += 1
        inflight.drain()
    w.end = time.perf_counter()
    return w


LOOPS = {"resident": resident, "hostfed": hostfed}


def ring_on(traffic, frames, device):
    """The ring as the loop reads it: on the card for ``resident``, in
    pinned host memory for ``hostfed`` (plain host memory on a CPU run)."""
    if traffic["loop"] != "hostfed":
        return frames
    if device.type != "cuda":
        return [f.cpu() for f in frames]
    return [torch.empty(f.shape, dtype=f.dtype, pin_memory=True).copy_(f) for f in frames]
