"""The attribution of the card's work to the program's spans
(``attribution.py``) and its readers, on synthetic traces with correlation
ids and launch records: a planted offset between the two clocks changes
nothing, and work with no launch record stays unattributed and is listed.
The enqueue time is read from the port's own host buffer, on the CPU."""

import pytest

from portbench import attribution, harness, trace
from portbench.harness import Run, load_module

H100 = "NVIDIA H100 80GB HBM3"
B32 = "preproc_1080p.b32_resident"


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def _events(offset_us=0.0, runtime_tid=1):
    """Two batches of the flagship in a 1000 us window, host times in us;
    the card's clock is the host's plus `offset_us`.  Each batch: a colour
    kernel (50 us), the k5 kernel (20 us, launched by its library), a resize
    kernel (60 us), the warp's upload (5 us) and kernel (35 us); the
    fastest launch (the warp's) starts 5 us after its call.  A fill
    enqueued in ``wait``, outside the entry, ends the window's work."""
    ev = [_x("user_annotation", "window", 0, 1000), _x("user_annotation", "wait", 600, 400)]

    def dev(cat, name, ts, dur, **args):
        return _x(cat, name, ts + offset_us, dur, tid=7, stream=7, **args)

    def call(name, ts, corr):
        return _x("cuda_runtime", name, ts, 3, tid=runtime_tid, correlation=corr)

    for b, t in enumerate((0, 300)):
        c = 10 * b
        ev += [
            _x("user_annotation", "submit", t, 300),
            _x("user_annotation", "entry.forward", t + 10, 280),
            _x("user_annotation", "cvtColor", t + 20, 40),
            call("cudaLaunchKernel", t + 30, c + 1),
            dev("kernel", "k_color", t + 100, 50, correlation=c + 1),
            _x("user_annotation", "GaussianBlur", t + 70, 50),
            call("cudaLaunchKernel", t + 80, 900 + b),
            dev("kernel", "sep_k5", t + 150, 20, correlation=900 + b),
            _x("user_annotation", "resize", t + 130, 40),
            call("cudaLaunchKernel", t + 140, c + 2),
            dev("kernel", "k_resize", t + 170, 60, correlation=c + 2),
            _x("user_annotation", "warpAffine", t + 180, 100),
            call("cudaMemcpyAsync", t + 195, c + 3),
            dev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", t + 230, 5, correlation=c + 3,
                bytes=4096),
            call("cudaLaunchKernel", t + 260, c + 4),
            dev("kernel", "k_warp", t + 265, 35, correlation=c + 4),
        ]
    ev += [call("cudaMemsetAsync", 700, 99), dev("gpu_memset", "Memset (Device)", 805, 50,
                                                 correlation=99)]
    return ev


@pytest.mark.parametrize("runtime_tid", [1, 2])
@pytest.mark.parametrize("offset_us", [0.0, -125.0, 200.0, -200.0])
def test_attribution_by_launch_is_offset_free(offset_us, runtime_tid):
    att = attribution.attribute(_events(offset_us, runtime_tid))
    assert att.batches == 2
    assert att.offset == pytest.approx((5 + offset_us) * 1e-6)
    got = [(w.name, att.stage_of(w), att.spans[w.path[-1]].name if w.path else None)
           for w in att.work]
    assert got == [("k_color", "cvtColor", "cvtColor"),
                   ("sep_k5", "GaussianBlur", "GaussianBlur"),
                   ("k_resize", "resize", "resize"),
                   ("Memcpy HtoD (Pinned -> Device)", "warpAffine", "warpAffine"),
                   ("k_warp", "warpAffine", "warpAffine")] * 2 + [
                   ("Memset (Device)", None, "wait")]
    assert att.device_ms(attribution.STAGES["color"]) == pytest.approx(0.050)
    assert att.device_ms(("GaussianBlur",)) == pytest.approx(0.020)
    assert att.device_ms(attribution.STAGES["resize"]) == pytest.approx(0.060)
    assert att.device_ms(attribution.STAGES["warp"]) == pytest.approx(0.040)
    assert att.uploads() == {"warpAffine": 2} and att.uploads_per_batch() == 1.0
    # gaps on the aligned clock (device - 5 us): [295, 395) ends with a
    # colour kernel, [230, 260) and [530, 560) with a warp kernel, each
    # enqueued inside the entry after the gap began; [595, 800) ends with
    # the fill enqueued outside it; [0, 95) and [850, 1000) are the
    # window's edges
    assert att.entry_idle_pct() == pytest.approx(100 * (30 + 100 + 30) / 1000)
    s = att.summary()
    assert s["unattributed"] == {"Memset (Device)": 1}
    assert s["busy_ms_per_batch"] == pytest.approx((1000 - 95 - 30 - 100 - 30 - 205 - 150)
                                                   / 2 / 1e3)
    assert s["stage_ms"]["GaussianBlur"] == pytest.approx(0.020)
    assert s["idle_gaps_us"][0] == ["wait (outside the entry)", pytest.approx(205)]
    assert s["idle_gaps_us"][1] == ["window edge", pytest.approx(150)]
    assert s["idle_pct_by_cause"] == {"window edge": pytest.approx(24.5),
                                      "program": pytest.approx(16.0),
                                      "outside the entry": pytest.approx(20.5)}


def test_work_without_launch_record_stays_unattributed():
    """A kernel whose launch the trace did not record (here the k5 of both
    batches) is put under no span and listed by name, and the offset is
    measured over the work matched by id."""
    ev = [e for e in _events(-125.0) if (e["args"].get("correlation") or 0) < 900
          or e["cat"] == "kernel"]
    att = attribution.attribute(ev)
    assert [w.name for w in att.work if att.stage_of(w) is None] == [
        "sep_k5", "sep_k5", "Memset (Device)"]
    assert att.device_ms(("GaussianBlur",)) == 0.0
    assert att.offset == pytest.approx(-120e-6)
    assert att.summary()["unattributed"] == {"sep_k5": 2, "Memset (Device)": 1}


def _run(events, kind=H100, cell=B32, monkeypatch=None, roots=(0.25e-3, 0.30e-3, 0.27e-3)):
    if monkeypatch is not None:
        monkeypatch.setattr(attribution, "_windows", lambda run: (events, list(roots)))
    return Run(cell=harness.load_cell(cell), device_kind=kind, trace=trace.Trace(events))


def _read(metric, run):
    return load_module(harness.reader(metric)).read(run)


@pytest.mark.parametrize("offset_us", [0.0, -125.0, 200.0, -200.0])
def test_readers(monkeypatch, offset_us):
    run = _run(_events(offset_us), monkeypatch=monkeypatch)
    assert _read("enqueue_ms", run) == pytest.approx(0.270)
    assert _read("color_ms", run) == pytest.approx(0.050)
    assert _read("resize_ms", run) == pytest.approx(0.060)
    assert _read("warp_ms", run) == pytest.approx(0.040)
    assert _read("uploads_per_batch", run) == 1.0
    assert _read("entry_idle_pct", run) == pytest.approx(16.0)


def test_readers_of_a_program_without_spans(monkeypatch):
    """A program that opens no root span (as before the spans) or a CPU
    run: every new reader returns None, and no window is traced."""
    plain = [e for e in _events() if e["cat"] != "user_annotation"
             or e["name"] in ("window", "submit", "wait")]

    def refuse(run):
        raise AssertionError("traced a window with nothing to attribute")

    monkeypatch.setattr(attribution, "_windows", refuse)
    for run in (_run(plain), _run(_events(), kind="cpu")):
        for metric in ("enqueue_ms", "color_ms", "resize_ms", "warp_ms", "uploads_per_batch",
                       "entry_idle_pct"):
            assert _read(metric, run) is None, metric


def test_readers_share_one_window(monkeypatch):
    calls = []

    def events(run):
        calls.append(run)
        return _events(), [1e-3]

    monkeypatch.setattr(attribution, "_windows", events)
    run = _run(_events())
    for metric in ("enqueue_ms", "color_ms", "warp_ms", "entry_idle_pct"):
        _read(metric, run)
    assert calls == [run]


def test_root_seconds_reads_the_port_host_buffer():
    """The enqueue time comes from the port's host buffer with no profiler:
    one outermost ``entry.*`` span a call (an entry called inside another
    is not a batch), and the buffer's state is left as it was."""
    import torch

    from opencv_tpu_torch import entry
    from opencv_tpu_torch.utils import trace as port_trace

    x = torch.zeros((1, 24, 32, 3), dtype=torch.uint8)

    def batches():
        for _ in range(3):
            entry.forward(x)
        port_trace.region("entry.outer")(entry.forward)(x)

    assert not port_trace.is_enabled()
    roots = attribution.root_seconds(batches)
    assert not port_trace.is_enabled() and not torch.autograd._profiler_enabled()
    assert len(roots) == 4 and all(r > 0 for r in roots)
    port_trace.reset()
