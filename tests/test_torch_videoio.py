"""The port's videoio (``opencv_tpu_torch/videoio.py``) and
``videoio_registry``, held against the cv2 wheel as the reference tests are
(tests/test_videoio_raw.py, test_imgcodecs.py's MJPG AVI cross,
test_misc_modules.py's Y4M round trip) and against the JAX package's: the
files its VideoWriter writes byte-equal to the JAX package's for every
from-scratch fourcc, the frames its VideoCapture reads equal (HuffYUV, FFV1,
raw, MJPG, Y4M, image sequences, mp4v through ``_NativeMp4Reader``), the
properties, a truncated frame's (False, None), and a tensor written as its
numpy array.  The YUV layouts' tolerances against cv2 are the reference
tests' (3 grey levels: the port's cvtColor against FFmpeg's swscale)."""

import os
import struct

import numpy as np
import pytest
import torch

from common import cv2, assert_exact

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu import videoio as jvio
from opencv_tpu import videoio_registry as jreg
from opencv_tpu_torch import videoio as tvio
from opencv_tpu_torch import videoio_registry as treg
from torch_threads import _one_torch_thread  # noqa: F401

NATIVE_FCCS = ("MJPG", "I420", "IYUV", "YV12", "Y800", "RGBA", "HFYU", "FFV1")
PROPS = ("CAP_PROP_POS_FRAMES", "CAP_PROP_FRAME_WIDTH", "CAP_PROP_FRAME_HEIGHT",
         "CAP_PROP_FPS", "CAP_PROP_FOURCC", "CAP_PROP_FRAME_COUNT")


def _frames(n=3, seed=3, shape=(48, 64, 3)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, shape, np.uint8) for _ in range(n)]


def _smooth_frames(n=4, seed=0, shape=(48, 64, 3)):
    rng = np.random.default_rng(seed)
    return [cv2.GaussianBlur(rng.integers(0, 256, shape, np.uint8), (5, 5), 2)
            for _ in range(n)]


def _read_all(cap):
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    return out


def _write(mod, path, fourcc, frames, fps=10, size=None):
    h, w = frames[0].shape[:2]
    wr = mod.VideoWriter(path, fourcc, fps, size or (w, h))
    assert wr.isOpened()
    for f in frames:
        wr.write(f)
    wr.release()
    if "%" in path:
        return None
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------- the packages

@pytest.mark.parametrize("fcc", NATIVE_FCCS)
def test_writer_bytes_and_reader_frames_equal_opencv_tpu(tmp_path, fcc):
    frames = _smooth_frames(seed=1) if fcc == "MJPG" else _frames(seed=2)
    four = tcv.VideoWriter_fourcc(*fcc)
    assert four == jcv.VideoWriter_fourcc(*fcc) == cv2.VideoWriter_fourcc(*fcc)
    a = _write(tcv, str(tmp_path / "t.avi"), four, frames)
    b = _write(jcv, str(tmp_path / "j.avi"), four, frames)
    assert a == b, fcc
    ours, theirs = tcv.VideoCapture(str(tmp_path / "t.avi")), jcv.VideoCapture(str(tmp_path / "j.avi"))
    for name in PROPS:
        assert ours.get(getattr(tvio, name)) == theirs.get(getattr(jvio, name)), (fcc, name)
    got, want = _read_all(ours), _read_all(theirs)
    assert len(got) == len(want) == len(frames)
    for g, r in zip(got, want):
        assert_exact(g, np.asarray(r), fcc)
    if fcc in ("RGBA", "HFYU", "FFV1"):   # lossless
        for g, f in zip(got, frames):
            assert_exact(g, f, fcc)


@pytest.mark.parametrize("fcc", ("HFYU", "FFV1"))
def test_lossless_odd_size_and_gray_equal_opencv_tpu(tmp_path, fcc):
    frames = _frames(2, seed=5, shape=(31, 45, 3))
    four = tcv.VideoWriter_fourcc(*fcc)
    gray = [f[..., 1].copy() for f in frames]
    for name, fr in (("c", frames), ("g", gray)):
        a = _write(tcv, str(tmp_path / f"t{name}.avi"), four, fr)
        b = _write(jcv, str(tmp_path / f"j{name}.avi"), four, fr)
        assert a == b, (fcc, name)
        got = _read_all(tcv.VideoCapture(str(tmp_path / f"t{name}.avi")))
        want = _read_all(jcv.VideoCapture(str(tmp_path / f"j{name}.avi")))
        assert len(got) == len(want) == 2
        for g, r in zip(got, want):
            assert_exact(g, np.asarray(r))


@pytest.mark.parametrize("fcc", ("HFYU", "FFV1"))
def test_lossless_avi_crosses_cv2(tmp_path, fcc):
    """The port's file read by cv2 and cv2's read by the port, exactly
    (tests/test_huffyuv.py, test_ffv1.py)."""
    frames = _frames(3, seed=6)
    p = str(tmp_path / "o.avi")
    _write(tcv, p, tcv.VideoWriter_fourcc(*fcc), frames)
    refs = _read_all(cv2.VideoCapture(p))
    assert len(refs) == 3
    for f, r in zip(frames, refs):
        assert_exact(r, f, fcc)
    p2 = str(tmp_path / "w.avi")
    wr = cv2.VideoWriter(p2, cv2.VideoWriter_fourcc(*fcc), 10, (64, 48))
    assert wr.isOpened()
    for f in frames:
        wr.write(f)
    wr.release()
    got, refs = _read_all(tcv.VideoCapture(p2)), _read_all(cv2.VideoCapture(p2))
    assert len(got) == len(refs) == 3
    for g, r in zip(got, refs):
        assert_exact(g, r, fcc)


@pytest.mark.parametrize("fcc", ("HFYU", "FFV1", "MJPG", "I420", "Y800"))
def test_write_of_a_tensor_equals_its_array(tmp_path, fcc):
    frames = _frames(2, seed=7)
    four = tcv.VideoWriter_fourcc(*fcc)
    a = _write(tcv, str(tmp_path / "n.avi"), four, frames)
    t = _write(tcv, str(tmp_path / "t.avi"), four, [torch.from_numpy(f) for f in frames])
    assert a == t
    # a strided view
    wide = [torch.from_numpy(np.repeat(f, 2, axis=1)) for f in frames]
    v = _write(tcv, str(tmp_path / "v.avi"), four, [w[:, ::2] for w in wide])
    assert v == a


def test_y4m_and_image_sequences_equal_opencv_tpu(tmp_path):
    frames = _frames(3, seed=8)
    a = _write(tcv, str(tmp_path / "t.y4m"), 0, frames, fps=30.0)
    b = _write(jcv, str(tmp_path / "j.y4m"), 0, frames, fps=30.0)
    assert a == b
    for ext in ("png", "bmp"):
        _write(tcv, str(tmp_path / f"t%03d.{ext}"), 0, frames)
        _write(jcv, str(tmp_path / f"j%03d.{ext}"), 0, frames)
        for i in range(3):
            with open(tmp_path / f"t{i:03d}.{ext}", "rb") as f1, \
                    open(tmp_path / f"j{i:03d}.{ext}", "rb") as f2:
                assert f1.read() == f2.read()
        for pat in (f"t%03d.{ext}", f"t*.{ext}"):
            cap = tcv.VideoCapture(str(tmp_path / pat))
            assert cap.isOpened() and cap.get(tcv.CAP_PROP_FRAME_COUNT) == 3
            for g, f in zip(_read_all(cap), frames):
                assert_exact(g, f)
    single = tcv.VideoCapture(str(tmp_path / "t001.png"))
    assert single.get(tcv.CAP_PROP_FRAME_COUNT) == 1
    assert_exact(single.read()[1], frames[1])
    assert not tcv.VideoCapture(str(tmp_path / "none%03d.png")).isOpened()
    assert not tcv.VideoCapture(0).isOpened()


def test_get_set_position_equal_opencv_tpu(tmp_path):
    frames = _frames(4, seed=9)
    four = tcv.VideoWriter_fourcc(*"FFV1")
    _write(tcv, str(tmp_path / "p.avi"), four, frames, fps=12.5)
    ours, theirs = tcv.VideoCapture(str(tmp_path / "p.avi")), jcv.VideoCapture(str(tmp_path / "p.avi"))
    for idx in (2, 0, 3):
        assert ours.set(tcv.CAP_PROP_POS_FRAMES, idx) == theirs.set(jcv.CAP_PROP_POS_FRAMES, idx)
        assert ours.get(tcv.CAP_PROP_POS_FRAMES) == theirs.get(jcv.CAP_PROP_POS_FRAMES) == idx
        (ok1, f1), (ok2, f2) = ours.read(), theirs.read()
        assert ok1 and ok2
        assert_exact(f1, np.asarray(f2))
    assert ours.get(tcv.CAP_PROP_FPS) == theirs.get(jcv.CAP_PROP_FPS) == 12.5
    assert ours.get(99) == theirs.get(99) == 0.0
    assert ours.set(tcv.CAP_PROP_FPS, 5) is theirs.set(jcv.CAP_PROP_FPS, 5) is False
    ours.release()
    assert not ours.isOpened()


def test_registry_equals_opencv_tpu():
    assert treg.getBackends() == jreg.getBackends()
    assert treg.getStreamBackends() == jreg.getStreamBackends()
    assert treg.getWriterBackends() == jreg.getWriterBackends()
    assert treg.getCameraBackends() == jreg.getCameraBackends() == []
    assert treg.getStreamBufferedBackends() == jreg.getStreamBufferedBackends() == []
    for api in (*jreg.getBackends(), 0, 1900, 12345):
        assert treg.getBackendName(api) == jreg.getBackendName(api)
        assert treg.hasBackend(api) == jreg.hasBackend(api)
        assert treg.isBackendBuiltIn(api) == jreg.isBackendBuiltIn(api)
    assert treg.getBackendName(cv2.CAP_IMAGES) == "CAP_IMAGES"
    for name in ("getCameraBackendPluginVersion", "getStreamBackendPluginVersion",
                 "getStreamBufferedBackendPluginVersion", "getWriterBackendPluginVersion"):
        with pytest.raises(RuntimeError):
            getattr(treg, name)(cv2.CAP_IMAGES)


def test_constants_equal_opencv_tpu_and_cv2():
    for name in (*PROPS, "CAP_PROP_FOURCC"):
        assert getattr(tvio, name) == getattr(jvio, name) == getattr(cv2, name), name
    assert tvio.__all__ == jvio.__all__
    assert tvio._NATIVE_AVI_FCCS == jvio._NATIVE_AVI_FCCS and tvio._FF_EXTS == jvio._FF_EXTS


# ------------------------------------------------------ mp4v, the native tier

def _wheel_mp4v(tmp_path, n=6):
    rng = np.random.RandomState(7)
    base = cv2.GaussianBlur(rng.randint(0, 255, (48 + 64, 64 + 64, 3), np.uint8), (7, 7), 2)
    frames = [base[int(1.7 * i):int(1.7 * i) + 48, int(2.5 * i):int(2.5 * i) + 64].copy()
              for i in range(n)]
    p = str(tmp_path / "w.mp4")
    wr = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    assert wr.isOpened()
    for f in frames:
        wr.write(f)
    wr.release()
    return p


def test_mp4v_through_the_native_reader(tmp_path):
    """mp4v in MP4 through Mp4Demuxer and Mpeg4Decoder, P-frame chains
    bit-exact against the wheel (tests/test_mpeg4.py) and the JAX package's
    reader, with the seek that restarts the GOP."""
    p = _wheel_mp4v(tmp_path)
    ours, theirs, ref = tcv.VideoCapture(p), jcv.VideoCapture(p), cv2.VideoCapture(p)
    assert isinstance(ours._ff, tvio._NativeMp4Reader)
    for name in PROPS:
        assert ours.get(getattr(tvio, name)) == theirs.get(getattr(jvio, name)), name
    got, want, wheel = _read_all(ours), _read_all(theirs), _read_all(ref)
    assert len(got) == len(want) == len(wheel) == 6
    for g, w, r in zip(got, want, wheel):
        assert_exact(g, np.asarray(w))
        assert_exact(g, r)
    for idx in (4, 1, 5):
        ours.set(tcv.CAP_PROP_POS_FRAMES, idx)
        ok, f = ours.read()
        assert ok
        assert_exact(f, wheel[idx])


def test_mp4v_bgr_without_the_adapter_equals_opencv_tpu(tmp_path, monkeypatch):
    """The in-house I420 conversion the native reader takes when the FFmpeg
    shim is not there: the port's cvtColor against the JAX package's."""
    from opencv_tpu import videoio_ffmpeg as jff
    from opencv_tpu_torch import videoio_ffmpeg as tff
    p = _wheel_mp4v(tmp_path, 3)
    monkeypatch.setattr(tff, "_get_lib", lambda: None)
    monkeypatch.setattr(jff, "_get_lib", lambda: None)
    got, want = _read_all(tcv.VideoCapture(p)), _read_all(jcv.VideoCapture(p))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_exact(g, np.asarray(w))


# ----------------------------------------------- tests/test_videoio_raw.py

@pytest.mark.parametrize("fcc", ["I420", "YV12", "Y800", "RGBA"])
def test_read_wheel_raw_avi(tmp_path, fcc):
    frames = _frames()
    p = str(tmp_path / f"w_{fcc}.avi")
    w = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*fcc), 10, (64, 48))
    assert w.isOpened()
    for f in frames:
        w.write(f)
    w.release()
    refs = _read_all(cv2.VideoCapture(p))
    got = _read_all(tcv.VideoCapture(p))
    want = _read_all(jcv.VideoCapture(p))
    assert len(got) == len(refs) == len(want) == 3
    for g, r, j in zip(got, refs, want):
        assert_exact(g, np.asarray(j), fcc)
        d = np.abs(g.astype(int) - r.astype(int))
        if fcc in ("Y800", "RGBA"):
            assert d.max() == 0, fcc
        else:   # YUV: cvtColor against FFmpeg's swscale differ by <= 3
            assert d.max() <= 3, (fcc, d.max())


@pytest.mark.parametrize("fcc", ["Y800", "RGBA"])
def test_write_raw_avi_wheel_reads_exact(tmp_path, fcc):
    frames = _frames(seed=4)
    p = str(tmp_path / f"o_{fcc}.avi")
    _write(tcv, p, tcv.VideoWriter_fourcc(*fcc), frames)
    refs = _read_all(cv2.VideoCapture(p))
    assert len(refs) == 3
    for f, r in zip(frames, refs):
        want = f if fcc == "RGBA" else np.repeat(
            cv2.cvtColor(f, cv2.COLOR_BGR2GRAY)[..., None], 3, 2)
        assert_exact(r, want)


def test_write_i420_wheel_reads(tmp_path):
    rng = np.random.default_rng(5)
    img = cv2.GaussianBlur(rng.integers(0, 255, (48, 64, 3), np.uint8), (11, 11), 4)
    p = str(tmp_path / "o_i420.avi")
    _write(tcv, p, tcv.VideoWriter_fourcc(*"I420"), [img, img])
    refs = _read_all(cv2.VideoCapture(p))
    assert len(refs) == 2
    d = np.abs(refs[0].astype(int) - img.astype(int))
    assert d.mean() < 3 and d.max() < 24   # the chroma filters differ


@pytest.mark.parametrize("fcc", ("I420", "FFV1", "HFYU"))
def test_truncated_frame_returns_false(tmp_path, fcc):
    """A truncated payload yields (False, None), not an exception, as cv2
    and the JAX package do."""
    frames = _frames(seed=7)
    p = str(tmp_path / "trunc.avi")
    _write(tcv, p, tcv.VideoWriter_fourcc(*fcc), frames)
    data = open(p, "rb").read()
    if fcc == "I420":
        cut = data[:-100]   # into the last frame chunk (the index is 3 x 16 + 8 bytes)
    else:                   # drop the index and half the last frame's payload
        movi = data.rfind(b"00dc")
        (size,) = struct.unpack("<I", data[movi + 4:movi + 8])
        cut = data[:movi + 8 + size // 2]
    open(p, "wb").write(cut)
    results = {}
    for mod in (tcv, jcv):
        cap = mod.VideoCapture(p)
        res = []
        for _ in range(3):
            if not cap.grab():
                break
            res.append(cap.retrieve())
        results[mod] = res
    ours, theirs = results[tcv], results[jcv]
    assert ours, "no frames parsed at all"
    assert len(ours) == len(theirs)
    for (ok1, f1), (ok2, f2) in zip(ours, theirs):
        assert ok1 == ok2
        assert (f1 is None) == (f2 is None)
    if fcc == "I420":
        assert ours[-1] == (False, None)
        for ok, img in ours[:-1]:
            assert ok and img is not None


def test_read_wheel_fourcc0_avi(tmp_path):
    frames = _frames(seed=8)
    p = str(tmp_path / "raw0.avi")
    w = cv2.VideoWriter(p, 0, 10, (64, 48))
    if not w.isOpened():
        pytest.skip("wheel cannot write fourcc-0 AVI")
    for f in frames:
        w.write(f)
    w.release()
    refs = _read_all(cv2.VideoCapture(p))
    got = _read_all(tcv.VideoCapture(p))
    if not refs:
        pytest.skip("wheel wrote no readable frames")
    assert len(got) == len(refs)
    for g, r in zip(got, refs):
        assert np.abs(g.astype(int) - r.astype(int)).max() <= 3


def test_read_dib_avi_bottom_up(tmp_path):
    """A hand-built BI_RGB AVI: bottom-up rows of BGR triplets, flipped and
    kept in order."""
    rng = np.random.default_rng(9)
    img = rng.integers(0, 255, (48, 64, 3), np.uint8)
    payload = img[::-1].tobytes()

    def chunk(ckid, body):
        pad = b"\x00" if len(body) & 1 else b""
        return ckid + struct.pack("<I", len(body)) + body + pad

    w, h = 64, 48
    avih = struct.pack("<14I", 100000, 0, 0, 0x10, 1, 0, 1, len(payload), w, h, 0, 0, 0, 0)
    strh = b"vids" + b"\x00" * 4 + struct.pack(
        "<IHHIIIIIIIII", 0, 0, 0, 0, 1, 10, 0, 1, len(payload),
        0xFFFFFFFF, 0, 0) + struct.pack("<4H", 0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"\x00\x00\x00\x00", len(payload),
                       0, 0, 0, 0)
    strl = b"LIST" + struct.pack(
        "<I", 4 + len(chunk(b"strh", strh)) + len(chunk(b"strf", strf))
    ) + b"strl" + chunk(b"strh", strh) + chunk(b"strf", strf)
    hdrl_body = b"hdrl" + chunk(b"avih", avih) + strl
    hdrl = b"LIST" + struct.pack("<I", len(hdrl_body)) + hdrl_body
    movi_items = chunk(b"00db", payload)
    movi = b"LIST" + struct.pack("<I", 4 + len(movi_items)) + b"movi" + movi_items
    body = b"AVI " + hdrl + movi
    p = str(tmp_path / "dib.avi")
    with open(p, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    got = _read_all(tcv.VideoCapture(p))
    assert len(got) == 1
    assert_exact(got[0], img)
    assert tcv.VideoCapture(p).get(tcv.CAP_PROP_FPS) == 10.0


def test_self_roundtrip_raw(tmp_path):
    frames = _frames(seed=6)
    for fcc in ("I420", "YV12", "Y800", "RGBA"):
        p = str(tmp_path / f"rt_{fcc}.avi")
        _write(tcv, p, tcv.VideoWriter_fourcc(*fcc), frames)
        got = _read_all(tcv.VideoCapture(p))
        assert len(got) == 3
        if fcc == "RGBA":
            for g, f in zip(got, frames):
                assert_exact(g, f)


# ---------------- tests/test_imgcodecs.py and test_misc_modules.py's cases

def test_videoio_mjpeg_avi_cross(tmp_path):
    frames = _smooth_frames(5)
    path = os.path.join(tmp_path, "ours.avi")
    _write(tcv, path, tcv.VideoWriter_fourcc(*"MJPG"), frames, fps=15)
    cap = cv2.VideoCapture(path)
    assert cap.isOpened()
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 5
    assert abs(cap.get(cv2.CAP_PROP_FPS) - 15) < 0.1
    ok, f0 = cap.read()
    assert ok and cv2.PSNR(frames[0], f0) > 28
    path2 = os.path.join(tmp_path, "ref.avi")
    vw2 = cv2.VideoWriter(path2, cv2.VideoWriter_fourcc(*"MJPG"), 15, (64, 48))
    for f in frames:
        vw2.write(f)
    vw2.release()
    cap2 = tcv.VideoCapture(path2)
    assert cap2.isOpened()
    assert int(cap2.get(tcv.CAP_PROP_FRAME_COUNT)) == 5
    got = _read_all(cap2)
    assert len(got) == 5
    for g, f, j in zip(got, frames, _read_all(jcv.VideoCapture(path2))):
        assert cv2.PSNR(f, g) > 28
        assert_exact(g, np.asarray(j))
    seq = os.path.join(tmp_path, "img%03d.png")
    _write(tcv, seq, 0, frames, fps=0)
    cap3 = tcv.VideoCapture(seq)
    assert int(cap3.get(tcv.CAP_PROP_FRAME_COUNT)) == 5
    tcv.imshow("w", frames[0])
    assert tcv.waitKey(1) == -1


def test_y4m_roundtrip(tmp_path):
    rng = np.random.default_rng(7)
    frames = [rng.integers(0, 256, (48, 64, 3), np.uint8) for _ in range(3)]
    path = os.path.join(tmp_path, "clip.y4m")
    _write(tcv, path, 0, frames, fps=30.0)
    cap = tcv.VideoCapture(path)
    assert cap.isOpened()
    assert cap.get(tcv.CAP_PROP_FPS) == 30.0
    got = _read_all(cap)
    assert len(got) == 3
    want = _read_all(jcv.VideoCapture(path))
    for a, b, j in zip(got, frames, want):
        assert_exact(a, np.asarray(j))
        ya = cv2.cvtColor(a, cv2.COLOR_BGR2GRAY).astype(int)
        yb = cv2.cvtColor(b, cv2.COLOR_BGR2GRAY).astype(int)
        assert np.abs(ya - yb).mean() < 3
