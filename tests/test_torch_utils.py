"""The port's utils (logger, config, trace, system, buildinfo) on the CPU,
against opencv_tpu's where the answer is device-free: the log levels and
their parsing from the environment, the config readers, the version, tick
frequency, hints and hardware flags, and the trace's nested spans and
Chrome events (bar the times); the trace regions seen in a CPU
torch.profiler trace; the build information naming torch and not jax."""

import json
import os
import re

import pytest
import torch

import opencv_tpu.utils as jutils
import opencv_tpu.utils.config as jconfig
import opencv_tpu.utils.logger as jlogger
import opencv_tpu.utils.system as jsystem
import opencv_tpu.utils.trace as jtrace
import opencv_tpu_torch as tcv
import opencv_tpu_torch.utils as tutils
import opencv_tpu_torch.utils.config as tconfig
import opencv_tpu_torch.utils.logger as tlogger
import opencv_tpu_torch.utils.system as tsystem
import opencv_tpu_torch.utils.trace as ttrace
from opencv_tpu_torch.core import dispatch
from torch_threads import _one_torch_thread  # noqa: F401

LOG_ENVS = ("", "INFO", "debug", "5", "VERBOSE,imgproc:DEBUG,a.b:1", "WARN, x:SILENT",
            "bogus", "2,,photo:4")


def test_utils_names_equal_opencv_tpu():
    want = sorted(n for n in dir(jutils) if not n.startswith("_"))
    got = sorted(n for n in dir(tutils) if not n.startswith("_"))
    assert got == want
    for name in ("LOG_LEVEL_SILENT", "LOG_LEVEL_FATAL", "LOG_LEVEL_ERROR", "LOG_LEVEL_WARNING",
                 "LOG_LEVEL_INFO", "LOG_LEVEL_DEBUG", "LOG_LEVEL_VERBOSE"):
        assert getattr(tutils, name) == getattr(jutils, name)
    assert tcv.utils is tutils


@pytest.mark.parametrize("raw", LOG_ENVS)
def test_log_levels_from_the_environment_equal_opencv_tpu(raw, monkeypatch):
    for var in ("OPENCV_TPU_LOG_LEVEL", "OPENCV_LOG_LEVEL"):
        monkeypatch.delenv(var, raising=False)
    if raw:
        monkeypatch.setenv("OPENCV_TPU_LOG_LEVEL", raw)
    assert tlogger._initial_levels() == jlogger._initial_levels()
    monkeypatch.delenv("OPENCV_TPU_LOG_LEVEL", raising=False)
    monkeypatch.setenv("OPENCV_LOG_LEVEL", raw or "ERROR")
    assert tlogger._initial_levels() == jlogger._initial_levels()
    for v in ("silent", "FATAL", "warn", "6", "x"):
        assert tlogger._parse_level(v) == jlogger._parse_level(v)


def test_log_tags_and_output_equal_opencv_tpu(capsys):
    saved = [(m, m.getLogLevel(), dict(m._tag_levels)) for m in (tlogger, jlogger)]
    try:
        lines = []
        for m in (tlogger, jlogger):
            m.setLogLevel(m.LOG_LEVEL_INFO)
            m.setLogTagLevel("photo", m.LOG_LEVEL_DEBUG)
            m.setLogTagLevel("photo.hdr", m.LOG_LEVEL_ERROR)
            levels = [m.getLogTagLevel(t) for t in ("photo", "photo.npr", "photo.hdr.x",
                                                    "global", "imgproc")]
            for lv in (1, 2, 3, 4, 5, 6):
                m.log(lv, f"message {lv}", tag="photo.npr")
                m.log(lv, f"message {lv}", tag="photo.hdr")
            err = capsys.readouterr().err
            lines.append((levels, re.sub(r"\d\d:\d\d:\d\d", "T", err)))
        assert lines[0] == lines[1]
        assert "[D T photo.npr] message 5" in lines[0][1]
    finally:
        for m, level, tags in saved:
            m.setLogLevel(level)
            m._tag_levels.clear()
            m._tag_levels.update(tags)


@pytest.mark.parametrize("value", [None, "1", "true", " ON ", "yes", "0", "off", "No", "7",
                                   "-3", "maybe", ""])
def test_config_equals_opencv_tpu(value, monkeypatch):
    name = "OPENCV_TPU_TEST_CONFIG_VALUE"
    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)
    for default in (False, True):
        assert tconfig.get_config_bool(name, default) == jconfig.get_config_bool(name, default)
    for default in (0, 42):
        assert tconfig.get_config_int(name, default) == jconfig.get_config_int(name, default)
    assert tconfig.get_config_str(name, "d") == jconfig.get_config_str(name, "d")


SYSTEM_CALLS = ("getTickFrequency", "getNumThreads", "getThreadNum", "getNumberOfCPUs",
                "useOptimized", "getCPUFeaturesLine", "getVersionMajor", "getVersionMinor",
                "getVersionRevision", "getVersionString", "getDefaultAlgorithmHint")


@pytest.mark.parametrize("name", SYSTEM_CALLS)
def test_system_call_equals_opencv_tpu(name):
    assert getattr(tsystem, name)() == getattr(jsystem, name)()
    assert getattr(tcv, name)() == getattr(jsystem, name)()


def test_system_flags_hints_and_ticks_equal_opencv_tpu():
    for name in ("VERSION_MAJOR", "VERSION_MINOR", "VERSION_REVISION", "VERSION_STATUS",
                 "ALGO_HINT_DEFAULT", "ALGO_HINT_ACCURATE", "ALGO_HINT_APPROX"):
        assert getattr(tsystem, name) == getattr(jsystem, name)
    for feature in (0, 1, 100, 256):
        assert tcv.checkHardwareSupport(feature) == jsystem.checkHardwareSupport(feature)
        assert tcv.getHardwareFeatureName(feature) == jsystem.getHardwareFeatureName(feature)
    assert tcv.setUseOptimized(False) is None and tcv.setNumThreads(3) is None
    assert tcv.bootstrap() is None and tcv.redirectError(print) is None
    tcv.redirectError(None)
    t0, c0 = tcv.getTickCount(), tcv.getCPUTickCount()
    assert tcv.getTickCount() >= t0 and tcv.getCPUTickCount() >= c0

    class Stream:
        def __init__(self, ok):
            self.ok = ok

        def isOpened(self):
            return self.ok

    streams = [Stream(True), Stream(False), object(), Stream(True)]
    assert tcv.VideoCapture_waitAny(streams) == jsystem.VideoCapture_waitAny(streams)


def test_build_information_names_torch_and_not_jax():
    for text in (tcv.getBuildInformation(), tutils.getBuildInformation()):
        assert torch.__version__ in text and "torch" in text
        assert "jax" not in text.lower()
    assert tcv.getBuildInformation().startswith("General configuration for opencv_tpu")
    assert tsystem.getVersionString() in tcv.getBuildInformation()
    # the device count: 1 (the CPU) where there is no CUDA device
    want = torch.cuda.device_count() if torch.cuda.is_available() else 1
    assert tutils.getNumThreads() == want
    assert tutils.setNumThreads(8) is None


def _spans(mod):
    """Nested regions with args, traced by `mod`; the events bar the
    times."""
    mod.reset()
    mod.start()
    try:
        with mod.trace_region("outer", frame=3):
            with mod.trace_region("inner"):
                with mod.trace_region("leaf", k="v"):
                    pass
            with mod.trace_region("inner2"):
                pass

        @mod.region("decorated")
        def f(x):
            return x + 1

        assert f(1) == 2 and f.__name__ == "f"
        mod.count("tier.test_op.cuda", 2)
        mod.count("tier.test_op.cuda")
        evs = mod.events()
        stats = {k: v for k, v in mod.tier_stats().items() if "test_op" in k}
    finally:
        mod.stop()
    for ev in evs:
        assert ev["dur"] >= 0 and ev["ts"] >= 0
    return [{k: v for k, v in ev.items() if k not in ("ts", "dur")} for ev in evs], stats


def test_trace_spans_and_counters_equal_opencv_tpu(tmp_path):
    got, got_stats = _spans(ttrace)
    want, want_stats = _spans(jtrace)
    assert got == want and got_stats == want_stats == {"tier.test_op.cuda": 3}
    assert [e["name"] for e in got] == ["leaf", "inner", "inner2", "outer", "decorated"]
    assert [e["args"]["depth"] for e in got] == [2, 1, 1, 0, 0]
    assert dispatch.tier_stats()["tier.test_op.cuda"] == 3
    docs = []
    for mod in (ttrace, jtrace):
        path = mod.dump_trace(str(tmp_path / f"{mod.__name__}.json"))
        doc = json.load(open(path))
        for ev in doc["traceEvents"]:
            ev.pop("ts"), ev.pop("dur")
        doc["otherData"]["counters"] = {k: v for k, v in doc["otherData"]["counters"].items()
                                        if "test_op" in k}
        docs.append(doc)
        mod.reset()
    assert docs[0] == docs[1]
    assert "tier.test_op.cuda" not in dispatch.tier_stats()
    # disabled: regions run, nothing is recorded
    with ttrace.trace_region("quiet"):
        pass
    assert ttrace.events() == [] and not ttrace.is_enabled()


def test_trace_region_is_seen_by_torch_profiler(tmp_path):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with ttrace.trace_region("photo.test_region"):
            torch.ones(64, 64).add_(1).sum()
    assert "photo.test_region" in {e.key for e in prof.key_averages()}
    logdir = tmp_path / "prof"
    with tutils.profile_to(str(logdir)):
        with ttrace.trace_region("photo.profiled"):
            torch.ones(8).mul_(2)
    doc = json.load(open(os.path.join(logdir, "trace.json")))
    assert any(e.get("name") == "photo.profiled" for e in doc["traceEvents"])
