"""opencv_tpu_torch.imgcodecs' still-image codecs against opencv_tpu's and
the cv2 oracle, on the CPU.

The port's codecs are the JAX package's host numpy code, copied, with their
entropy loops in the port's native host tails.  Every format of the JAX
package's codec tests (test_imgcodecs.py, test_small_codecs.py,
test_jpeg2000.py, test_avif.py) goes through both packages on the same
seeded numpy images: the encoded bytes are equal and the decoded arrays are
equal (``array_equal``, dtype and shape), and cv2 reads or writes the same
files wherever the reference test holds the JAX package to it.  An encoder
also takes a tensor, read back once."""

import numpy as np
import pytest
import torch

from common import assert_exact, cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu.imgcodecs import exr as jexr, gif as jgif, webp as jwebp
from opencv_tpu_torch.imgcodecs import exr as texr, gif as tgif, webp as twebp
from torch_threads import _one_torch_thread  # noqa: F401


def _buf(b):
    return np.frombuffer(bytes(b), np.uint8)


def both_encode(ext, img, params=None) -> bytes:
    """The bytes of both packages' imencode, held equal."""
    okj, bj = jcv.imencode(ext, img, params) if params is not None else jcv.imencode(ext, img)
    okt, bt = tcv.imencode(ext, img, params) if params is not None else tcv.imencode(ext, img)
    assert okj and okt
    assert bytes(np.asarray(bt)) == bytes(np.asarray(bj)), ext
    return bytes(np.asarray(bt))


def both_decode(data, flags=-1):
    """Both packages' imdecode of the same bytes, held equal; the port's is
    numpy, as cv2's is."""
    want = jcv.imdecode(_buf(data), flags)
    got = tcv.imdecode(_buf(data), flags)
    assert isinstance(got, np.ndarray)
    assert_exact(got, np.asarray(want))
    return got


# --------------------------------------------------------------- PNG, BMP, PNM

def _u8(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


@pytest.mark.parametrize("ext, shape", [
    (".png", (32, 40, 3)), (".png", (17, 23)), (".png", (9, 11, 4)),
    (".bmp", (21, 33, 3)), (".bmp", (13, 14)), (".ppm", (15, 17, 3)), (".pgm", (15, 17, 3)),
    (".pgm", (12, 9)), (".pbm", (19, 21)), (".sr", (14, 18, 3)), (".ras", (14, 19)),
])
def test_u8_formats_equal_and_read_by_cv2(ext, shape, tmp_path):
    img = _u8(len(ext) + shape[0], shape)
    data = both_encode(ext, img)
    got = both_decode(data, -1)
    p = str(tmp_path / f"x{ext}")
    assert tcv.imwrite(p, img)
    assert open(p, "rb").read() == data
    assert_exact(tcv.imread(p, tcv.IMREAD_UNCHANGED), got)
    if ext in (".png", ".bmp", ".ppm") and len(shape) == 3 and shape[2] == 3:
        # cv2 reads ours, we read cv2's (test_png_roundtrip and its kin)
        assert_exact(cv2.imread(p), img)
        p2 = str(tmp_path / f"y{ext}")
        cv2.imwrite(p2, img)
        assert_exact(tcv.imread(p2), img)
        assert_exact(tcv.imread(p2), jcv.imread(p2))


def test_png_gray16_and_read_flags(tmp_path):
    img = np.random.default_rng(1).integers(0, 65536, (16, 20), np.uint16)
    data = both_encode(".png", img)
    assert_exact(both_decode(data, tcv.IMREAD_UNCHANGED), img)
    col = _u8(4, (16, 16, 3))
    p = str(tmp_path / "x.png")
    assert tcv.imwrite(p, col)
    for flags in (tcv.IMREAD_GRAYSCALE, tcv.IMREAD_COLOR, tcv.IMREAD_UNCHANGED,
                  tcv.IMREAD_ANYCOLOR):
        assert_exact(tcv.imread(p, flags), np.asarray(jcv.imread(p, flags)), str(flags))
    assert tcv.imread(p, tcv.IMREAD_GRAYSCALE).ndim == 2
    assert tcv.imread(str(tmp_path / "missing.png")) is None


def test_pbm_pnm_pfm_wheel_interop(tmp_path):
    img = (_u8(5, (19, 27)) > 127).astype(np.uint8) * 255
    p = str(tmp_path / "w.pbm")
    cv2.imwrite(p, img)
    assert_exact(tcv.imread(p, tcv.IMREAD_UNCHANGED), cv2.imread(p, cv2.IMREAD_UNCHANGED))
    assert_exact(tcv.imread(p, tcv.IMREAD_UNCHANGED), jcv.imread(p, jcv.IMREAD_UNCHANGED))
    p1 = str(tmp_path / "a.pbm")
    open(p1, "wb").write(b"P1\n4 3\n0 1 0 1\n1 1 0 0\n0 0 0 1\n")
    assert_exact(tcv.imread(p1, -1), jcv.imread(p1, -1))
    p2, p3 = str(tmp_path / "a.pgm"), str(tmp_path / "a.ppm")
    open(p2, "wb").write(b"P2\n3 2\n255\n0 128 255\n7 8 9\n")
    open(p3, "wb").write(b"P3\n2 2\n255\n255 0 0 0 255 0\n0 0 255 9 9 9\n")
    for q in (p2, p3):
        assert_exact(tcv.imread(q, -1), jcv.imread(q, -1))
    for shape in ((9, 14), (9, 14, 3)):
        f = (np.random.default_rng(6).random(shape) * 100 - 50).astype(np.float32)
        pf = str(tmp_path / "w.pfm")
        assert cv2.imwrite(pf, f)
        assert_exact(tcv.imread(pf, -1), cv2.imread(pf, -1))
        assert_exact(tcv.imread(pf, -1), jcv.imread(pf, -1))
        data = both_encode(".pfm", f)
        assert_exact(cv2.imdecode(_buf(data), -1), f)


@pytest.mark.parametrize("ext", [".sr", ".ras"])
@pytest.mark.parametrize("color", [True, False])
def test_sunras_wheel_interop(tmp_path, ext, color):
    img = _u8(11 + color, (11, 13, 3) if color else (11, 13))
    p = str(tmp_path / ("a" + ext))
    assert cv2.imwrite(p, img)
    ours = tcv.imread(p, tcv.IMREAD_UNCHANGED)
    assert_exact(ours, jcv.imread(p, jcv.IMREAD_UNCHANGED))
    # the wheel's own 8-bit reader drops its writer's row padding at odd
    # widths: held to the wheel only where it round-trips itself
    assert_exact(ours, img)
    ref = cv2.imread(p, cv2.IMREAD_UNCHANGED)
    if np.array_equal(ref, img):
        assert_exact(ours, ref)
    assert_exact(cv2.imdecode(_buf(both_encode(ext, img)), cv2.IMREAD_UNCHANGED), img)


def test_sunras_rle_decode(tmp_path):
    import struct
    w, h = 6, 2
    raw = bytes([7, 7, 7, 7, 9, 9]) * 2
    rle = bytes([0x80, 3, 7, 0x80, 1, 9, 0x80, 3, 7, 0x80, 1, 9])
    head = struct.pack(">8I", 0x59A66A95, w, h, 8, len(rle), 2, 1, 768)
    p = str(tmp_path / "rle.ras")
    open(p, "wb").write(head + bytes(range(256)) * 3 + rle)
    ours = tcv.imread(p, tcv.IMREAD_UNCHANGED)
    assert_exact(ours, jcv.imread(p, jcv.IMREAD_UNCHANGED))
    ref = cv2.imread(p, cv2.IMREAD_UNCHANGED)
    if ref is not None:
        assert_exact(ours, ref)
    want = np.frombuffer(raw, np.uint8).reshape(h, w)
    assert np.array_equal(ours[..., 0] if ours.ndim == 3 else ours, want)


# ------------------------------------------------------------------- JPEG

def test_jpeg_encode_byte_identical():
    rng = np.random.default_rng(9)
    imgs = [rng.integers(0, 256, (37, 53, 3), np.uint8),
            cv2.GaussianBlur(rng.integers(0, 256, (64, 96, 3), np.uint8), (0, 0), 2),
            rng.integers(0, 256, (61, 93), np.uint8)]
    samps = [(0x221111, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420),
             (0x211111, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422),
             (0x111111, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
             (0x411111, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411),
             (0x121111, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440)]
    for img in imgs:
        for q in (1, 75, 95, 100):
            for sv, cvs in samps:
                if img.ndim == 2 and sv != 0x221111:
                    continue
                _, ref = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, q,
                                                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cvs])
                assert both_encode(".jpg", img, [1, q, 7, sv]) == bytes(ref), (q, sv)


def test_jpeg_encode_options_and_tensors():
    """Huffman optimisation, restart intervals (the Python pass: the native
    coder writes no restart markers), luma/chroma qualities, and a tensor
    input, each equal to the JAX package's bytes and to cv2's decode."""
    img = cv2.GaussianBlur(_u8(10, (45, 70, 3)), (0, 0), 1.5)
    for params in ([1, 90, 3, 1], [1, 80, 4, 2], [1, 85, 5, 60, 6, 30], [1, 70, 4, 1, 3, 1]):
        data = both_encode(".jpg", img, params)
        assert_exact(both_decode(data, tcv.IMREAD_COLOR), cv2.imdecode(_buf(data), 1))
    t = torch.from_numpy(img)
    ok, b = tcv.imencode(".jpg", t)
    assert ok and bytes(b) == both_encode(".jpg", img)


def test_jpeg_decode_bit_exact_matrix():
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, (37, 53, 3), np.uint8),
            cv2.GaussianBlur(rng.integers(0, 256, (96, 130, 3), np.uint8), (0, 0), 2)]
    samps = [None, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411]
    for img in imgs:
        for q in (30, 90, 100):
            for samp in samps:
                flags = [cv2.IMWRITE_JPEG_QUALITY, q]
                if samp is not None:
                    flags += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, samp]
                _, buf = cv2.imencode(".jpg", img, flags)
                for rf, cf in ((tcv.IMREAD_COLOR, cv2.IMREAD_COLOR),
                               (tcv.IMREAD_GRAYSCALE, cv2.IMREAD_GRAYSCALE)):
                    assert_exact(both_decode(buf, rf), cv2.imdecode(buf, cf), f"{q} {samp}")
    _, buf = cv2.imencode(".jpg", imgs[1], [cv2.IMWRITE_JPEG_RST_INTERVAL, 3])
    assert_exact(both_decode(buf, tcv.IMREAD_COLOR), cv2.imdecode(buf, cv2.IMREAD_COLOR))


def test_jpeg_cross_codec_and_progressive(tmp_path):
    img = cv2.GaussianBlur(_u8(0, (64, 96, 3)), (5, 5), 2)
    data = both_encode(".jpg", img, [1, 95])
    assert cv2.PSNR(img, cv2.imdecode(_buf(data), 1)) > 30
    g = img[:61, :93, 0]
    p = str(tmp_path / "t.jpg")
    assert tcv.imwrite(p, g, [1, 90])
    assert_exact(tcv.imread(p, tcv.IMREAD_GRAYSCALE), cv2.imread(p, cv2.IMREAD_GRAYSCALE))
    for shape, q in (((40, 56, 3), 90), ((33, 47, 3), 60), ((48, 64), 85)):
        im = cv2.GaussianBlur(_u8(q, shape), (3, 3), 1)
        _, buf = cv2.imencode(".jpg", im, [cv2.IMWRITE_JPEG_QUALITY, q,
                                           cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
        flags = tcv.IMREAD_COLOR if len(shape) == 3 else tcv.IMREAD_GRAYSCALE
        assert_exact(both_decode(buf, flags), cv2.imdecode(buf, flags), f"progressive {shape}")


# ------------------------------------------------------------- TIFF, GIF

def test_tiff_roundtrip_and_compressions():
    rng = np.random.RandomState(0)
    cases = [rng.randint(0, 256, (37, 53, 3), np.uint8), rng.randint(0, 65536, (25, 31), np.uint16),
             rng.randint(0, 256, (20, 22, 4), np.uint8), rng.randint(0, 256, (40, 40), np.uint8),
             rng.randint(0, 65536, (15, 17, 3), np.uint16)]
    for im in cases:
        data = both_encode(".tiff", im)
        assert_exact(cv2.imdecode(_buf(data), -1), im)
        _, buf2 = cv2.imencode(".tiff", im)
        assert_exact(both_decode(buf2, -1), im)
    img = np.random.RandomState(1).randint(0, 256, (33, 47, 3), np.uint8)
    for comp in (1, 32773, 5, 32946):
        _, buf = cv2.imencode(".tiff", img, [cv2.IMWRITE_TIFF_COMPRESSION, comp])
        assert_exact(both_decode(buf, -1), img, f"compression {comp}")


def test_tiff_multipage_and_counts(tmp_path):
    pages = [_u8(20 + i, (12 + i, 15, 3)) for i in range(3)]
    okj, bj = jcv.imencodemulti(".tiff", pages)
    okt, bt = tcv.imencodemulti(".tiff", [torch.from_numpy(p) for p in pages])
    assert okj and okt and bytes(bt) == bytes(bj)
    ok, got = tcv.imdecodemulti(bt, tcv.IMREAD_UNCHANGED)
    assert ok and len(got) == 3
    for a, b in zip(got, pages):
        assert_exact(a, b)
    p = str(tmp_path / "m.tiff")
    assert tcv.imwritemulti(p, pages)
    assert tcv.imcount(p) == jcv.imcount(p) == 3
    ok, back = tcv.imreadmulti(p)
    okr, ref = jcv.imreadmulti(p)
    assert ok and okr and len(back) == len(ref) == 3
    for a, b in zip(back, ref):
        assert_exact(a, np.asarray(b))
    assert tcv.haveImageReader(p) == jcv.haveImageReader(p)
    for name in ("a.png", "a.jpg", "a.webp", "a.xyz", "a.jp2", "a.exr"):
        assert tcv.haveImageWriter(name) == jcv.haveImageWriter(name), name


def test_gif_roundtrip_interop_and_animation(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (8, 3), np.uint8)[rng.integers(0, 8, (60, 80))]
    data = tgif.gif_encode(img)
    assert data == jgif.gif_encode(img)
    assert_exact(tgif.gif_decode(data), jgif.gif_decode(data))
    p = str(tmp_path / "t.gif")
    open(p, "wb").write(data)
    assert_exact(cv2.imread(p), img)
    assert cv2.imwrite(p, img)
    assert_exact(tgif.gif_decode(open(p, "rb").read())[:, :, :3], cv2.imread(p))
    many = rng.integers(0, 256, (300, 3), np.uint8)[rng.integers(0, 300, (30, 40))]
    assert both_encode(".gif", many) is not None
    anim = tcv.Animation()
    anim.frames = [rng.integers(0, 256, (4, 3), np.uint8)[rng.integers(0, 4, (20, 24))]
                   for _ in range(3)]
    anim.durations = [100, 200, 300]
    janim = jcv.Animation()
    janim.frames, janim.durations = anim.frames, anim.durations
    okt, bt = tcv.imencodeanimation(".gif", anim)
    okj, bj = jcv.imencodeanimation(".gif", janim)
    assert okt and okj and bytes(bt) == bytes(bj)
    ok, back = tcv.imdecodeanimation(bt)
    okr, ref = jcv.imdecodeanimation(bj)
    assert ok and okr and back.durations == ref.durations and back.loop_count == ref.loop_count
    for a, b in zip(back.frames, ref.frames):
        assert_exact(a, np.asarray(b))
    pa = str(tmp_path / "a.gif")
    assert tcv.imwriteanimation(pa, anim)
    ok, again = tcv.imreadanimation(pa)
    assert ok and len(again.frames) == 3


# ------------------------------------------------------- EXR, HDR, PAM, WebP

def test_exr_all_compressions_and_piz():
    rng = np.random.default_rng(2)
    img = rng.normal(0, 2, (37, 53, 3)).astype(np.float32)
    smooth = np.cumsum(rng.normal(0, 0.1, (37, 53, 3)), axis=0).astype(np.float32)
    g = rng.normal(0, 1, (33, 31)).astype(np.float32)
    for im, params in ((img, [49, 0]), (img, [49, 2]), (img, [49, 3]), (img, [48, 1]),
                       (g, None), (smooth, [48, 1, 49, 4]), (smooth, [48, 2, 49, 4]),
                       (g, [49, 4])):
        data = texr.exr_encode(im, params) if params else texr.exr_encode(im)
        assert data == (jexr.exr_encode(im, params) if params else jexr.exr_encode(im)), params
        assert_exact(texr.exr_decode(data), jexr.exr_decode(data), str(params))
    assert both_encode(".exr", img) is not None


def test_hdr_and_pam_cross_codec():
    rng = np.random.default_rng(9)
    for img in ((rng.random((40, 64, 3)) * 8).astype(np.float32),
                (rng.random((10, 5, 3)) * 4).astype(np.float32)):
        data = both_encode(".hdr", img)
        ref = cv2.imdecode(_buf(data), cv2.IMREAD_UNCHANGED)
        np.testing.assert_allclose(both_decode(data, tcv.IMREAD_UNCHANGED), ref, rtol=1e-6)
        _, buf2 = cv2.imencode(".hdr", img)
        np.testing.assert_allclose(both_decode(buf2, tcv.IMREAD_UNCHANGED),
                                   cv2.imdecode(buf2, cv2.IMREAD_UNCHANGED), rtol=1e-6)
    for shape in ((30, 40), (30, 40, 3)):
        img = rng.integers(0, 256, shape, np.uint8)
        data = both_encode(".pam", img)
        assert_exact(cv2.imdecode(_buf(data), cv2.IMREAD_UNCHANGED), img)
        _, buf2 = cv2.imencode(".pam", img)
        assert_exact(both_decode(buf2, tcv.IMREAD_UNCHANGED), img)


def test_webp_lossless_both_ways():
    rng = np.random.default_rng(3)
    for (h, w), c, blur in (((2, 2), 3, 0), ((8, 8), 3, 1.0), ((32, 48), 3, 2.0),
                            ((17, 23), 4, 1.0), ((40, 40), 3, 0)):
        img = rng.integers(0, 256, (h, w, c), np.uint8)
        if blur:
            img = cv2.GaussianBlur(img, (0, 0), blur)
        _, buf = cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, 101])
        got = twebp.webp_decode(bytes(buf))
        assert_exact(got, jwebp.webp_decode(bytes(buf)))
        assert_exact(got, cv2.imdecode(buf, cv2.IMREAD_UNCHANGED))
        data = twebp.webp_encode(img)
        assert data == jwebp.webp_encode(img)
        assert_exact(cv2.imdecode(_buf(data), cv2.IMREAD_UNCHANGED), img)
    pal = rng.integers(0, 256, (5, 3), np.uint8)[rng.integers(0, 5, (30, 41))]
    assert_exact(cv2.imdecode(_buf(both_encode(".webp", pal)), 1), pal)


def test_webp_lossy_vp8_decode_bitexact():
    rng = np.random.default_rng(0)
    for (h, w) in [(16, 16), (17, 23), (64, 48), (33, 31)]:
        img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), np.uint8), (3, 3), 1)
        for q in (10, 50, 90):
            _, buf = cv2.imencode(".webp", img, [int(cv2.IMWRITE_WEBP_QUALITY), q])
            got = twebp.webp_decode(bytes(buf))
            assert_exact(got, cv2.imdecode(buf, 1), f"{h}x{w} q={q}")
            assert_exact(got, jwebp.webp_decode(bytes(buf)))
    _, buf = cv2.imencode(".webp", cv2.GaussianBlur(_u8(1, (40, 56, 3)), (5, 5), 2),
                          [int(cv2.IMWRITE_WEBP_QUALITY), 80])
    assert_exact(both_decode(buf, tcv.IMREAD_COLOR), cv2.imdecode(buf, 1))


# -------------------------------------------------------------- JPEG 2000

LOSSLESS = [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 1000]


def test_jp2_lossless_lossy_and_wheel(tmp_path):
    rng = np.random.default_rng(0)
    circ = np.zeros((80, 100, 3), np.uint8)
    cv2.circle(circ, (50, 40), 25, (30, 200, 90), -1)
    for img, flags in ((rng.integers(0, 255, (150, 200, 3), np.uint8), tcv.IMREAD_COLOR),
                       (rng.integers(0, 255, (97, 129), np.uint8), tcv.IMREAD_GRAYSCALE),
                       (np.tile(np.arange(256, dtype=np.uint8), (64, 1)), tcv.IMREAD_GRAYSCALE),
                       (circ, tcv.IMREAD_COLOR)):
        p = str(tmp_path / "w.jp2")
        assert cv2.imwrite(p, img, LOSSLESS)
        assert_exact(both_decode(open(p, "rb").read(), flags), img)
        assert_exact(tcv.imread(p, flags), img)
        assert tcv.haveImageReader(p)
    smooth = cv2.GaussianBlur(rng.integers(0, 255, (120, 180, 3), np.uint8), (7, 7), 3)
    for x1000 in (None, 500, 250):
        params = [] if x1000 is None else [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, x1000]
        p = str(tmp_path / f"l{x1000}.jp2")
        assert cv2.imwrite(p, smooth, params)
        assert_exact(both_decode(open(p, "rb").read(), tcv.IMREAD_COLOR), cv2.imread(p),
                     f"x1000={x1000}")
    for img in (rng.integers(0, 255, (37, 51), np.uint8),
                rng.integers(0, 255, (70, 90, 3), np.uint8),
                rng.integers(0, 255, (5, 7, 3), np.uint8),
                rng.integers(0, 65535, (30, 40), np.uint16)):
        data = both_encode(".jp2", img)
        assert_exact(np.squeeze(cv2.imdecode(_buf(data), cv2.IMREAD_UNCHANGED)), img)
        assert_exact(both_decode(data, -1), img)


# ------------------------------------------------------------------ AVIF

def test_avif_both_packages(tmp_path):
    from opencv_tpu_torch.imgcodecs.avif import have_avif
    from opencv_tpu.imgcodecs.avif import have_avif as j_have
    assert have_avif() == j_have()
    if not have_avif():
        pytest.skip("no AVIF codec (PIL's plugin) in this environment")
    img = cv2.GaussianBlur(_u8(2, (32, 48, 3)), (0, 0), 1.5)
    ok, buf = cv2.imencode(".avif", img, [cv2.IMWRITE_AVIF_QUALITY, 90])
    assert ok
    assert_exact(both_decode(buf, tcv.IMREAD_UNCHANGED), cv2.imdecode(buf, -1))
    g = _u8(3, (24, 32))
    okt, bt = tcv.imencode(".avif", g, [tcv.IMWRITE_AVIF_QUALITY, 100])
    assert okt
    assert_exact(tcv.imdecode(bt, tcv.IMREAD_GRAYSCALE), g)
    assert_exact(tcv.imdecode(bt, tcv.IMREAD_GRAYSCALE), jcv.imdecode(bt, jcv.IMREAD_GRAYSCALE))


def test_metadata_forms(tmp_path):
    img = _u8(8, (10, 12, 3))
    p = str(tmp_path / "m.png")
    assert tcv.imwriteWithMetadata(p, img, [], [])
    got, types, meta = tcv.imreadWithMetadata(p, tcv.IMREAD_UNCHANGED)
    ref = jcv.imreadWithMetadata(p, jcv.IMREAD_UNCHANGED)
    assert_exact(got, ref[0])
    assert (types, meta) == (ref[1], ref[2]) == ([], [])
    okt, bt = tcv.imencodeWithMetadata(".png", img, [], [])
    assert okt and bytes(bt) == both_encode(".png", img)
    got, _, _ = tcv.imdecodeWithMetadata(bt, tcv.IMREAD_COLOR)
    assert_exact(got, img)
