"""Each metric reader on a synthetic trace with known intervals and
launches."""

import pytest
import torch

from portbench import harness, trace
from portbench.harness import Run, load_module

H100 = "NVIDIA H100 80GB HBM3"


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def _trace():
    """A 1000 us window: kernels over [100, 300) and [250, 400) (so 300 us
    busy from them), an HtoD copy of 4 MB over [350, 550) that kernels cover
    for 50 us, a fill over [900, 950); the host submits over [0, 600) and
    waits over [600, 1000)."""
    ev = [
        _x("user_annotation", "window", 0, 1000),
        _x("user_annotation", "submit", 0, 600),
        _x("user_annotation", "wait", 600, 400),
        _x("kernel", "k_a", 100, 200),
        _x("kernel", "k_b", 250, 150),
        _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 350, 200, bytes=4_000_000),
        _x("gpu_memset", "Memset (Device)", 900, 50),
        {"ph": "M", "name": "process_name"},
    ]
    return trace.Trace(ev)


def _run(cell_name, counters=None, kind=H100):
    cell = harness.load_cell(cell_name)
    return Run(cell=cell, device_kind=kind, trace=_trace(), counters=counters or {})


def _read(metric, run):
    return load_module(harness.reader(metric)).read(run)


@pytest.mark.parametrize("metric", ["idle_pct", "idle_pct.hostfed"])
def test_idle_pct(metric):
    """A metric split by cells (``idle_pct.hostfed``) reads its quantity's
    reader."""
    # busy: [100, 400) kernels, [400, 550) the copy, [900, 950) the fill
    assert _read(metric, _run("preproc_1080p.b32_resident")) == pytest.approx(50.0)


def test_launches_per_batch():
    run = _run("preproc_1080p.b32_resident", {"traced_batches": 2})
    assert _read("launches_per_batch", run) == pytest.approx(1.0)   # 2 kernels in the window


def test_host_syncs_per_batch():
    run = _run("preproc_1080p.b32_resident", {"host_syncs": 6, "sync_batches": 3})
    assert _read("host_syncs_per_batch", run) == 2.0
    assert _read("host_syncs_per_batch", _run("preproc_1080p.b32_resident")) is None


def test_h2d_gbps_and_overlap():
    run = _run("preproc_1080p.b32_resident")
    assert _read("h2d_gbps", run) == pytest.approx(4e6 / 200e-6 / 1e9)
    assert _read("copy_overlap_pct", run) == pytest.approx(25.0)


def test_stage_rooflines():
    """Two blur calls of 100 and 120 us and three warp calls of 2-4 us, as
    ``harness.time_stages`` returns them."""
    stage_s = {"blur": [100e-6, 120e-6], "warp": [4e-6, 2e-6, 3e-6]}
    run = _run("preproc_1080p.b32_resident", {"stage_s": stage_s})
    blur_bytes = 2 * 2_073_600 * 32
    assert _read("blur_roofline_pct", run) == pytest.approx(
        100 * blur_bytes / 3.35e12 / 110e-6)                  # the median of 100 and 120 us
    warp_bytes = 2 * 518_400 * 32
    assert _read("warp_roofline_pct", run) == pytest.approx(100 * warp_bytes / 3.35e12 / 3e-6)
    # an unknown card, or no timed stage: nothing to read
    assert _read("blur_roofline_pct", _run("preproc_1080p.b32_resident", {"stage_s": stage_s},
                                           kind="cpu")) is None
    assert _read("warp_roofline_pct", _run("preproc_1080p.b32_resident")) is None


def test_time_stages_times_every_call():
    """On the CPU each call is timed by the host's clock; every call of
    every stage is timed."""
    calls = []
    times = harness.time_stages({"a": lambda: calls.append("a"), "b": lambda: calls.append("b")},
                                torch.device("cpu"))
    assert calls == ["a"] * harness.STAGE_REPEATS + ["b"] * harness.STAGE_REPEATS
    assert {k: len(v) for k, v in times.items()} == {"a": harness.STAGE_REPEATS,
                                                     "b": harness.STAGE_REPEATS}
    assert all(t >= 0 for v in times.values() for t in v)


def test_breakdown_names_gaps_by_host_span():
    b = harness.breakdown(_trace())
    assert b["device_ops"][0] == ["k_a", pytest.approx(200e-6)]
    gaps = b["idle_gaps"]
    assert gaps[0] == ["wait", pytest.approx(350e-6)]          # [550, 900)
    assert gaps[1] == ["submit", pytest.approx(100e-6)]        # [0, 100)
    assert len(gaps) == 3
