"""opencv_tpu_torch.imgcodecs' video codecs (FFV1, HuffYUV, MPEG-4 Part 2
with the MP4 demuxer) against opencv_tpu's and the cv2 oracle, and the
codecs' native entropy loops against their plain twins, on the CPU.

The JAX package's tests read and write these codecs through VideoCapture
and VideoWriter (the port's videoio is held to them in
test_torch_videoio.py); here the packets come from the
same cv2-written files through the JAX package's AVI parser and from each
codec's own encoder, and go through both packages' codec functions: the
bytes and the decoded frames are equal, and equal to cv2's frames wherever
the reference test holds the JAX package to them.

The native tier (``native/hosttails.cpp``) is what the codecs run; each of
its nine entry points is held to its plain Python twin on the arguments a
real encode or decode gives it (recorded by wrapping the entry point)."""

import numpy as np
import pytest

from common import assert_exact, cv2

from opencv_tpu.imgcodecs import ffv1 as jF, huffyuv as jH, mp4 as jmp4, mpeg4 as jM
from opencv_tpu.videoio import _NativeMp4Reader, _parse_avi
import opencv_tpu_torch as tcv
from opencv_tpu_torch import native
from opencv_tpu_torch.imgcodecs import ffv1 as F, huffyuv as H, jpeg as J, jpeg2000 as J2
from opencv_tpu_torch.imgcodecs import mp4 as tmp4, mpeg4 as M
from torch_threads import _one_torch_thread  # noqa: F401


def _frames(n=3, h=48, w=64, seed=3):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h, w, 3), np.uint8)
    grad = (np.add.outer(np.arange(h), np.arange(w)) * 2 % 256).astype(np.uint8)
    out = [base, np.dstack([grad, grad // 2, 255 - grad])]
    for i in range(2, n):
        f = base.copy()
        f[5 * i:5 * i + 10, 3 * i:3 * i + 12] = (10 * i, 200, 30)
        out.append(f)
    return out


def _read_all(cap):
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    return out


def _wheel_avi(tmp_path, fourcc, frames, name="w.avi"):
    """cv2's AVI of `frames` under `fourcc`: (packets, size, extradata),
    or a skip where the wheel lacks the encoder."""
    h, w = frames[0].shape[:2]
    p = str(tmp_path / name)
    wr = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*fourcc), 10, (w, h))
    if not wr.isOpened():
        pytest.skip(f"wheel lacks the {fourcc} encoder")
    for f in frames:
        wr.write(f)
    wr.release()
    packets, _, size, _, extradata = _parse_avi(open(p, "rb").read())
    return p, packets, size, extradata


# ------------------------------------------------------------------ FFV1

@pytest.mark.parametrize("wh", [(64, 48), (62, 46), (33, 47)])
def test_ffv1_wheel_writes_we_read_exact(tmp_path, wh):
    w, h = wh
    frames = _frames(h=h, w=w)
    p, packets, size, extra = _wheel_avi(tmp_path, "FFV1", frames)
    refs = _read_all(cv2.VideoCapture(p))
    dec, jdec = F.FFV1Decoder(extra, *size), jF.FFV1Decoder(extra, *size)
    assert len(packets) == len(refs) == len(frames)
    for pkt, r, f in zip(packets, refs, frames):
        got = dec.decode(pkt)
        assert_exact(got, jdec.decode(pkt))
        assert_exact(got, r)
        if (w % 2, h % 2) == (0, 0):
            assert_exact(got, f)


@pytest.mark.parametrize("wh", [(64, 48), (45, 31)])
def test_ffv1_encode_equal_and_self_roundtrip(wh):
    w, h = wh
    for f in _frames(h=h, w=w):
        pkt = F.encode_frame_bgr(f)
        assert pkt == jF.encode_frame_bgr(f)
        assert_exact(F.decode_frame(pkt, F.build_extradata(), (w, h)), f)
    ex = F.build_extradata()
    assert ex == jF.build_extradata()
    assert F.crc32_ffv1(ex) == 0
    p = F.parse_extradata(ex)
    assert (p.version, p.ac, p.colorspace, p.quant_tables[0][1]) == (3, 0, 1, 666)
    flat = np.full((32, 40, 3), 77, np.uint8)
    pkt = F.encode_frame_bgr(flat)
    assert len(pkt) < 64 and pkt == jF.encode_frame_bgr(flat)
    assert_exact(F.decode_frame(pkt, ex, (40, 32)), flat)


# --------------------------------------------------------------- HuffYUV

@pytest.mark.parametrize("wh", [(64, 48), (62, 46), (33, 47)])
def test_huffyuv_wheel_writes_we_read_exact(tmp_path, wh):
    w, h = wh
    frames = _frames(h=h, w=w)[:1] + [f for f in _frames(h=h, w=w)[2:]]
    p, packets, size, extra = _wheel_avi(tmp_path, "HFYU", frames)
    refs = _read_all(cv2.VideoCapture(p))
    assert len(packets) == len(refs)
    for pkt, r in zip(packets, refs):
        got = H.decode_frame(pkt, *size, extra)
        want = jH.decode_frame(pkt, *size, extra)
        assert not isinstance(got, tuple)
        assert_exact(got, want)
        assert_exact(got, r)


def test_huffyuv_gray_422_and_encode(tmp_path):
    rng = np.random.default_rng(4)
    g = cv2.GaussianBlur(rng.integers(0, 255, (32, 48), np.uint8), (5, 5), 2)
    frames = [np.dstack([g, g, g])] * 2
    p, packets, size, extra = _wheel_avi(tmp_path, "HFYU", frames, "g.avi")
    ref = _read_all(cv2.VideoCapture(p))
    for pkt, r in zip(packets, ref):
        got, want = H.decode_frame(pkt, *size, extra), jH.decode_frame(pkt, *size, extra)
        if isinstance(want, tuple):
            for a, b in zip(got, want):
                assert_exact(a, b)
            got = H.yuv422_to_bgr(*got)
            assert_exact(got, jH.yuv422_to_bgr(*want))
        assert np.abs(got.astype(int) - r.astype(int)).max() <= 3   # YUV->BGR
    for f in _frames(h=30, w=41) + _frames(h=48, w=64):
        pkt = H.encode_frame_bgr(f)
        assert pkt == jH.encode_frame_bgr(f)
        assert_exact(H.decode_frame(pkt, f.shape[1], f.shape[0], H.build_extradata(24)), f)
    ed = H.build_extradata(24)
    assert ed == jH.build_extradata(24)
    assert H.parse_extradata(ed)[:3] == (0, 1, 24)


# ---------------------------------------------------------------- MPEG-4

def _wheel_mp4v(tmp_path, name, frames, fps=10):
    p = str(tmp_path / name)
    h, w = frames[0].shape[:2]
    wr = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    assert wr.isOpened()
    for f in frames:
        wr.write(f)
    wr.release()
    return p


def _moving_texture(n, h, w, seed=7, step=(2.5, 1.7)):
    rng = np.random.RandomState(seed)
    base = cv2.GaussianBlur(rng.randint(0, 255, (h + 64, w + 64, 3), np.uint8), (7, 7), 2)
    out = []
    for i in range(n):
        dx, dy = int(step[0] * i) % 60, int(step[1] * i) % 60
        f = base[dy:dy + h, dx:dx + w].copy()
        f[10:30, 10:50] = rng.randint(0, 255, (20, 40, 3), np.uint8)
        out.append(f)
    return out


@pytest.mark.parametrize("case", ["intra", "motion", "large_motion"])
def test_mpeg4_decode_equal_and_wheel(tmp_path, case):
    if case == "intra":
        frames = [np.full((48, 64, 3), v, np.uint8) for v in (10, 100, 250)]
    elif case == "motion":
        frames = _moving_texture(8, 64, 96)
    else:
        frames = _moving_texture(6, 96, 128, step=(17.0, 11.0))
    p = _wheel_mp4v(tmp_path, f"{case}.mp4", frames)
    data = open(p, "rb").read()
    d, jd = tmp4.Mp4Demuxer(data), jmp4.Mp4Demuxer(data)
    assert (d.samples, d.extradata, d.width, d.height, d.fps) == \
        (jd.samples, jd.extradata, jd.width, jd.height, jd.fps)
    dec, jdec = M.Mpeg4Decoder(d.extradata, d.width, d.height), \
        jM.Mpeg4Decoder(jd.extradata, jd.width, jd.height)
    # the JAX package's reader converts I420 to BGR (its test holds that to
    # cv2's frames); the port's I420 goes through the same conversion
    to_bgr = _NativeMp4Reader(p)._to_bgr
    refs = _read_all(cv2.VideoCapture(p))
    assert len(refs) == len(d.samples)
    seq = []
    for (off, sz), r in zip(d.samples, refs):
        seq.append(dec.decode(data[off:off + sz]))
        assert_exact(seq[-1], jdec.decode(data[off:off + sz]))
        assert_exact(to_bgr(seq[-1]), r)
    # a seek restarts the GOP from the first sample and rolls forward:
    # the frame equals the sequential decode's
    dec2 = M.Mpeg4Decoder(d.extradata, d.width, d.height)
    for off, sz in d.samples:
        last = dec2.decode(data[off:off + sz])
    assert_exact(last, seq[-1])


def test_mpeg4_vol_profiles_and_idct():
    def vol_bits(quant_type):
        bits = "0" + "00000001" + "0" + "0001" + "0" + "00" + "1"
        bits += format(10, "016b") + "1" + "0" + "1"
        bits += format(64, "013b") + "1" + format(48, "013b") + "1"
        bits += "0" + "1" + "0" + "0"
        bits += "1" if quant_type else "0"
        if quant_type:
            bits += "00"
        bits += "1" + "1" + "0" + "0" + "000"
        by = int(bits + "0" * (-len(bits) % 8), 2).to_bytes((len(bits) + 7) // 8, "big")
        return b"\x00\x00\x01\x20" + by
    M.Mpeg4Decoder(vol_bits(False))
    with pytest.raises(M.Mpeg4Unsupported):
        M.Mpeg4Decoder(vol_bits(True))
    rng = np.random.RandomState(11)
    blocks = []
    for i in range(32):
        b = rng.randint(-512, 512, (8, 8)).astype(np.int16)
        if i % 3 == 0:
            b[rng.rand(8, 8) < 0.7] = 0
        if i % 5 == 0:
            b[1:, :] = 0
        blocks.append(b)
    blocks = np.stack(blocks)
    out = M.idct_batch(blocks)
    assert_exact(out, jM.idct_batch(blocks))
    assert int(out.astype(np.int64).sum()) == -6612
    dc = np.zeros((1, 8, 8), np.int16)
    dc[0, 0, 0] = 1024
    assert (M.idct_batch(dc) == 128).all()


# ------------------------------------------------- the native tier's twins

def _record(monkeypatch, name):
    """Wrap the native entry point `name`: each call's arguments before and
    after it (arrays copied: the C code updates some in place, and the
    caller goes on updating them) and its result."""
    calls = []
    fn = getattr(native, name)

    def copies(args):
        return [a.copy() if isinstance(a, np.ndarray) else a for a in args]

    def wrapper(*args):
        before = copies(args)
        out = fn(*args)
        calls.append((before, copies(args), out))
        return out

    monkeypatch.setattr(native, name, wrapper)
    return calls


def test_native_jpeg_decode_equals_its_twin(monkeypatch):
    seen = []
    real = J._decode_scan

    def spy(data, pos, frame, scomp, qt, huff_dc, huff_ac, dri, grayscale=False):
        seen.append((data, pos, frame, scomp, huff_dc, huff_ac, dri))
        return real(data, pos, frame, scomp, qt, huff_dc, huff_ac, dri, grayscale)

    monkeypatch.setattr(J, "_decode_scan", spy)
    calls = _record(monkeypatch, "jpeg_decode_blocks")
    rng = np.random.default_rng(3)
    img = cv2.GaussianBlur(rng.integers(0, 256, (61, 83, 3), np.uint8), (0, 0), 1.5)
    for flags in ([cv2.IMWRITE_JPEG_QUALITY, 90],
                  [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
                  [cv2.IMWRITE_JPEG_RST_INTERVAL, 3]):
        _, buf = cv2.imencode(".jpg", img, flags)
        tcv.imdecode(buf, tcv.IMREAD_COLOR)
    _, buf = cv2.imencode(".jpg", img[..., 0])
    tcv.imdecode(buf, tcv.IMREAD_GRAYSCALE)
    assert len(seen) == len(calls) == 4
    for (data, pos, frame, scomp, huff_dc, huff_ac, dri), (_, _, out) in zip(seen, calls):
        twin = J._decode_scan_py(data, pos, frame, scomp, huff_dc, huff_ac, dri)
        assert len(twin) == len(out)
        for a, b in zip(twin, out):
            assert_exact(b, a)


def test_native_jpeg_encode_equals_its_twin(monkeypatch):
    calls = _record(monkeypatch, "jpeg_encode_blocks")
    rng = np.random.default_rng(9)
    img = cv2.GaussianBlur(rng.integers(0, 256, (45, 70, 3), np.uint8), (0, 0), 1)
    for params in ([1, 95], [1, 60, 7, 0x111111], [1, 90, 3, 1]):
        tcv.imencode(".jpg", img, params)
    tcv.imencode(".jpg", img[..., 1], [1, 80])
    assert len(calls) == 4
    for (qcoef, comp_h, comp_v, comp_tq, mcux, mcuy, dc_t, ac_t), _, ent in calls:
        bw = J._BitWriter()
        J._entropy_pass(qcoef, list(zip(comp_h, comp_v)), comp_tq, mcux, mcuy, 0,
                        dc_tabs=[J._encode_table(*t) for t in dc_t],
                        ac_tabs=[J._encode_table(*t) for t in ac_t], bw_=bw)
        bw.flush()
        nat = J._BitWriter()
        nat.out = bytearray(ent)
        nat.flush()
        assert bytes(nat.out) == bytes(bw.out)


def test_native_ebcot_equals_its_twin(monkeypatch):
    enc = _record(monkeypatch, "ebcot_t1_encode")
    dec = _record(monkeypatch, "ebcot_t1_decode")
    rng = np.random.default_rng(5)
    for img in (rng.integers(0, 255, (40, 52, 3), np.uint8),
                cv2.GaussianBlur(rng.integers(0, 255, (33, 47), np.uint8), (0, 0), 2)):
        ok, buf = tcv.imencode(".jp2", img)
        assert_exact(tcv.imdecode(buf, -1), img)
    assert len(enc) > 10 and len(dec) > 10
    for (v, orient), _, out in enc:
        assert J2._t1_encode_py(v, orient) == out
    for (data, w, h, numbps, orient, passes), _, out in dec:
        assert_exact(out, J2._t1_decode_py(data, w, h, numbps, orient, passes))


def test_native_huffyuv_equals_its_twin():
    rng = np.random.default_rng(5)
    for shape in ((9, 11, 3), (30, 41, 3)):
        x = rng.integers(0, 256, shape, np.uint8)
        n = 3 * (shape[0] * shape[1] - 1)
        enc = H.encode_frame_bgr(x)
        syms = H._decode_syms_py(np.unpackbits(H._bswap32(enc)[4:]), H._CLASSIC_LENS, n)
        assert_exact(H._decode_syms(enc, [H._CLASSIC_LENS] * 3, n), syms)
        assert H._pack_bits(syms, H._CLASSIC_CODES, H._CLASSIC_LENS_NP) == \
            H._pack_bits_py(syms, H._CLASSIC_CODES, H._CLASSIC_LENS_NP)
    with pytest.raises(ValueError):
        H._decode_syms(enc[:12], [H._CLASSIC_LENS] * 3, n)


def test_native_ffv1_equals_its_twin(tmp_path, monkeypatch):
    enc = _record(monkeypatch, "ffv1_encode_slice")
    dec = _record(monkeypatch, "ffv1_decode_slice")
    frames = _frames(h=31, w=45)
    ex = F.build_extradata()
    p = F.parse_extradata(ex)
    for f in frames:
        assert_exact(F.decode_frame(F.encode_frame_bgr(f), ex, (45, 31)), f)
    # the wheel's 2 x 2 slices, 4 planes
    _, packets, size, extra = _wheel_avi(tmp_path, "FFV1", _frames(h=48, w=64))
    wd = F.FFV1Decoder(extra, *size)
    for pkt in packets:
        wd.decode(pkt)
    assert len(enc) == 3 and len(dec) == 3 + 4 * len(packets)
    for (samples, w, h, nplanes, bits, qts, plane_ctx, ctx_qt, vlc, ccount, run_io), after, out \
            in enc:
        v = vlc.copy()
        twin = F._encode_samples_py([samples[:, pl] for pl in range(3)], w, h,
                                    p.quant_tables[0][0], v)
        assert out == twin
        assert_exact(after[8], v)
    for k, ((stream, w, h, nplanes, bits, qts, plane_ctx, ctx_qt, state, max_cc, run_io,
             samples), after, _) in enumerate(dec):
        params = p if k < 3 else wd.p
        st = state.copy()
        twin = F._decode_samples_py(stream.tobytes(), w, h, nplanes, bits, params,
                                    list(ctx_qt), st)
        assert_exact(after[11], twin)
        assert_exact(after[8], st)
    for data in (ex, b"", bytes(range(256)) * 3, packets[0]):
        assert F.crc32_ffv1(data) == F._crc32_ffv1_py(data) == jF.crc32_ffv1(data)
