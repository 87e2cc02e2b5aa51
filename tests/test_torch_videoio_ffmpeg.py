"""The port's FFmpeg adapter tier (``opencv_tpu_torch/videoio_ffmpeg.py``
over its copy of ``native/ffmpegio.c``): the cases of
tests/test_videoio_ffmpeg.py with the port, skipped as that file skips
where the system FFmpeg's development files are missing, each decode also
held equal to the JAX package's; and, wherever this runs, where the shim is
built: under ``opencv_tpu_torch/_build/``, never beside its source and never
under ``opencv_tpu/``."""

import subprocess
from pathlib import Path

import numpy as np
import pytest

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu_torch import videoio_ffmpeg

ROOT = Path(tcv.__file__).resolve().parent.parent
# the cases that need the shim skip inside the test (a fixture), where the
# system FFmpeg's development files are missing
needs_ffmpeg = pytest.mark.usefixtures("_ffmpeg")


@pytest.fixture
def _ffmpeg():
    if not videoio_ffmpeg.available():
        pytest.skip("system FFmpeg dev stack not present")


def _frames(n=6):
    out = []
    for i in range(n):
        f = np.zeros((48, 64, 3), np.uint8)
        f[:, :, 0] = i * 20
        f[10 + i:20 + i, 10:30] = 200
        out.append(f)
    return out


def _read_all(cap):
    res = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        res.append(f)
    return res


def test_the_shim_builds_under_the_port_build_dir(monkeypatch, tmp_path):
    """The build's output lies under opencv_tpu_torch/_build/ (a hashed
    name), and its command names no path under opencv_tpu/: run the build
    afresh into a scratch build dir with gcc recorded."""
    want_dir = ROOT / "opencv_tpu_torch" / "_build"
    assert videoio_ffmpeg.BUILD_DIR == want_dir
    assert videoio_ffmpeg.library_path().parent == want_dir
    assert videoio_ffmpeg.library_path().name.startswith("libffmpegio_")
    assert videoio_ffmpeg.SOURCE == ROOT / "opencv_tpu_torch" / "native" / "ffmpegio.c"
    calls = []
    real_run = subprocess.run

    def record(cmd, *a, **k):
        calls.append(cmd)
        return real_run(cmd, *a, **k)

    monkeypatch.setattr(videoio_ffmpeg, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(videoio_ffmpeg.subprocess, "run", record)
    out = videoio_ffmpeg._build()
    assert len(calls) == 1
    cmd = calls[0]
    assert cmd[0] == "gcc" and str(videoio_ffmpeg.SOURCE) in cmd
    target = Path(cmd[cmd.index("-o") + 1])
    assert target.parent == tmp_path / "_build"
    assert not any("opencv_tpu/" in str(c) for c in cmd)
    if out is None:   # no FFmpeg development files: nothing is left behind
        assert list((tmp_path / "_build").iterdir()) == []
    else:
        assert out == tmp_path / "_build" / videoio_ffmpeg.library_path().name
        assert [p.name for p in (tmp_path / "_build").iterdir()] == [out.name]
    # the source is the JAX package's shim, its header comment aside
    ours = videoio_ffmpeg.SOURCE.read_text().split("#include", 1)[1]
    theirs = (ROOT / "opencv_tpu" / "native" / "ffmpegio.c").read_text().split("#include", 1)[1]
    assert ours == theirs


@needs_ffmpeg
def test_the_loaded_shim_is_the_port_build():
    lib = videoio_ffmpeg._get_lib()
    assert Path(lib._name).parent == ROOT / "opencv_tpu_torch" / "_build"


@needs_ffmpeg
@pytest.mark.parametrize("name,fcc", [
    ("a.mp4", "mp4v"), ("b.mp4", "avc1"), ("c.avi", "XVID")])
def test_read_wheel_compressed_bitexact(tmp_path, name, fcc):
    frames = _frames()
    p = str(tmp_path / name)
    w = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*fcc), 10, (64, 48))
    if not w.isOpened():
        # the wheel cannot encode this codec: write it with the port's
        # adapter; both sides then decode the same file
        wr = videoio_ffmpeg.FFmpegWriter(p, cv2.VideoWriter_fourcc(*fcc), 10, 64, 48)
        assert wr.ok
        for f in frames:
            wr.write(f)
        wr.close()
    else:
        for f in frames:
            w.write(f)
        w.release()
    ours = tcv.VideoCapture(p)
    theirs = cv2.VideoCapture(p)
    assert ours.isOpened()
    a, b = _read_all(ours), _read_all(theirs)
    c = _read_all(jcv.VideoCapture(p))
    assert len(a) == len(b) == len(c) == len(frames)
    for x, y, z in zip(a, b, c):
        assert np.array_equal(x, y)  # the same libavcodec: bit-exact
        assert np.array_equal(x, np.asarray(z))
    assert ours.get(tcv.CAP_PROP_FRAME_WIDTH) == 64
    assert ours.get(tcv.CAP_PROP_FRAME_COUNT) == len(frames)
    ours.release()


@needs_ffmpeg
def test_seek_matches_wheel(tmp_path):
    frames = _frames(10)
    p = str(tmp_path / "seek.mp4")
    w = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    for f in frames:
        w.write(f)
    w.release()
    ours = tcv.VideoCapture(p)
    theirs = cv2.VideoCapture(p)
    for idx in (7, 2, 9, 0, 4):
        ours.set(tcv.CAP_PROP_POS_FRAMES, idx)
        theirs.set(cv2.CAP_PROP_POS_FRAMES, idx)
        ok1, f1 = ours.read()
        ok2, f2 = theirs.read()
        assert ok1 and ok2
        assert np.array_equal(f1, f2), idx
    ours.release()


@needs_ffmpeg
def test_adapter_reader_seek_equals_opencv_tpu(tmp_path, monkeypatch):
    """With the native mp4v tier off, the adapter reads and seeks as the JAX
    package's adapter does."""
    monkeypatch.setenv("OPENCV_TPU_MP4_NATIVE", "0")
    p = str(tmp_path / "s.mp4")
    w = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    for f in _frames(8):
        w.write(f)
    w.release()
    ours, theirs = tcv.VideoCapture(p), jcv.VideoCapture(p)
    assert isinstance(ours._ff, videoio_ffmpeg.FFmpegReader)
    assert ours.get(tcv.CAP_PROP_FOURCC) == theirs.get(jcv.CAP_PROP_FOURCC)
    for idx in (5, 1, 7):
        ours.set(tcv.CAP_PROP_POS_FRAMES, idx)
        theirs.set(jcv.CAP_PROP_POS_FRAMES, idx)
        assert ours.get(tcv.CAP_PROP_POS_FRAMES) == theirs.get(jcv.CAP_PROP_POS_FRAMES)
        (ok1, f1), (ok2, f2) = ours.read(), theirs.read()
        assert ok1 and ok2 and np.array_equal(f1, np.asarray(f2)), idx


@needs_ffmpeg
@pytest.mark.parametrize("name,fcc", [
    ("o1.mp4", "mp4v"), ("o2.mp4", "avc1"), ("o3.avi", "XVID"),
    ("o4.webm", "VP90")])
def test_write_wheel_reads(tmp_path, name, fcc):
    frames = _frames()
    p = str(tmp_path / name)
    w = tcv.VideoWriter(p, tcv.VideoWriter_fourcc(*fcc), 10, (64, 48))
    assert w.isOpened()
    for f in frames:
        w.write(f)
    w.release()
    cap = cv2.VideoCapture(p)
    assert cap.isOpened()
    got = _read_all(cap)
    assert len(got) == len(frames)
    # lossy codecs: the wheel's own mp4v round trip of these frames has
    # max |d| 75; the port's stays in that class
    for x, y in zip(got, frames):
        assert np.abs(x.astype(int) - y.astype(int)).max() <= 90


@needs_ffmpeg
def test_native_tier_still_first(tmp_path):
    p = str(tmp_path / "nat.avi")
    w = tcv.VideoWriter(p, tcv.VideoWriter_fourcc(*"MJPG"), 10, (64, 48))
    for f in _frames(3):
        w.write(f)
    w.release()
    cap = tcv.VideoCapture(p)
    assert cap.isOpened() and cap._ff is None  # the native parser, no adapter
    ok, f = cap.read()
    assert ok and f.shape == (48, 64, 3)


@needs_ffmpeg
def test_grayscale_write(tmp_path):
    p = str(tmp_path / "g.mp4")
    w = tcv.VideoWriter(p, tcv.VideoWriter_fourcc(*"mp4v"), 10, (64, 48), isColor=False)
    assert w.isOpened()
    g = np.tile(np.arange(64, dtype=np.uint8) * 4, (48, 1))
    for _ in range(3):
        w.write(g)
    w.release()
    cap = cv2.VideoCapture(p)
    ok, f = cap.read()
    assert ok and f.shape == (48, 64, 3)
