"""QR and barcodes of the port (``opencv_tpu_torch/objdetect/qr_encode.py``,
``qrcode.py``, ``barcode.py``) against the JAX package's and cv2, on the
CPU.

The encoder (host numpy, copied with its tables) equals the JAX package's
and cv2's symbol bit for bit across modes, versions and EC levels.  The
detectors' dense parts (gray, Otsu, the 51x51 adaptive mean; Sobel, the
31x31 box, the closing) run on the image's device; their quads and texts
equal the JAX package's exactly, and the texts cv2's, as
tests/test_objdetect.py holds the JAX package."""

import numpy as np
import pytest
import torch

from common import cv2
from torch_threads import _one_torch_thread  # noqa: F401
import test_objdetect as R

import opencv_tpu as jcv
from opencv_tpu.objdetect.barcode import BarcodeDetector as JBarcode
import opencv_tpu_torch as tcv
from opencv_tpu_torch import entry as E
from opencv_tpu_torch.objdetect.barcode import BarcodeDetector as TBarcode

TEXTS = ["HELLO WORLD 123", "1234567890", "lower case bytes!", "x" * 200, "9" * 60]


@pytest.mark.parametrize("text", TEXTS)
def test_qr_encoder_equals_opencv_tpu_and_cv2(text):
    got = tcv.QRCodeEncoder_create().encode(text)
    np.testing.assert_array_equal(got, jcv.QRCodeEncoder_create().encode(text))
    np.testing.assert_array_equal(got, cv2.QRCodeEncoder_create().encode(text))


def test_qr_encoder_levels_equal_cv2():
    for lvl in range(4):
        wp = cv2.QRCodeEncoder.Params()
        wp.correction_level = lvl
        got = tcv.QRCodeEncoder(correction_level=lvl).encode("EC TEST 77")
        np.testing.assert_array_equal(got, cv2.QRCodeEncoder_create(wp).encode("EC TEST 77"))
        np.testing.assert_array_equal(
            got, jcv.QRCodeEncoder(correction_level=lvl).encode("EC TEST 77"))
    assert vars(tcv.QRCodeEncoder_Params()) == vars(jcv.QRCodeEncoder_Params())
    assert vars(tcv.QRCodeDetectorAruco_Params()) == vars(jcv.QRCodeDetectorAruco_Params())
    assert tcv.GraphicalCodeDetector is tcv.QRCodeDetectorAruco is tcv.QRCodeDetector


def _qr_image(text, fx, pad, noise=0):
    code = cv2.QRCodeEncoder_create().encode(text)
    big = cv2.resize(code, None, fx=fx, fy=fx, interpolation=cv2.INTER_NEAREST)
    big = cv2.copyMakeBorder(big, pad, pad, pad, pad, cv2.BORDER_CONSTANT, value=255)
    if noise:
        big = np.clip(big.astype(int) + np.random.default_rng(0).integers(-noise, noise, big.shape),
                      0, 255).astype(np.uint8)
    return big


@pytest.mark.parametrize("text,fx,pad,noise", [
    ("HELLO TPU 123", 8, 32, 0), ("The quick brown fox jumps over the lazy dog 42!", 8, 32, 0),
    ("NOISE TEST 99", 7, 25, 25)])
def test_qr_detect_and_decode_equals_opencv_tpu(text, fx, pad, noise):
    img = _qr_image(text, fx, pad, noise)
    want = jcv.QRCodeDetector().detectAndDecode(img)
    for x in (img, torch.from_numpy(np.repeat(img[..., None], 3, -1))):
        got = tcv.QRCodeDetector().detectAndDecode(x)
        assert got[0] == want[0] == text
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
    ok, pts = tcv.QRCodeDetector().detect(img)
    assert ok and np.array_equal(pts, want[1])
    ref_txt, ref_pts, _ = cv2.QRCodeDetector().detectAndDecode(img)
    assert ref_txt == text or noise


def test_qr_decodes_the_ports_encoder_roundtrip():
    m = tcv.QRCodeEncoder_create().encode("ROUNDTRIP OK 99")
    big = np.kron(m, np.ones((8, 8), np.uint8))
    assert cv2.QRCodeDetector().detectAndDecode(big)[0] == "ROUNDTRIP OK 99"
    assert tcv.QRCodeDetector().detectAndDecode(big)[0] == "ROUNDTRIP OK 99"


def _same_barcode(got, want):
    assert got[:3] == want[:3]
    if want[3] is None:
        assert got[3] is None
    else:
        np.testing.assert_array_equal(got[3], want[3])


@pytest.mark.parametrize("digits,angle", [("590123412345", 0.0), ("401234567890", 180.0)])
def test_barcode_equals_opencv_tpu_and_cv2(digits, angle):
    code, img = R._render_ean13(digits)
    if angle:
        M = cv2.getRotationMatrix2D((img.shape[1] / 2, img.shape[0] / 2), angle, 1.0)
        img = cv2.warpAffine(img, M, (img.shape[1], img.shape[0]), borderValue=255)
    want = JBarcode().detectAndDecode(img)
    assert want[0] and code in want[1]
    for x in (img, torch.from_numpy(img)):
        _same_barcode(TBarcode().detectAndDecode(x), want)
    ok, pts = TBarcode().detectMulti(img)
    assert ok and np.array_equal(pts, want[3])
    assert TBarcode().decodeMulti(img, pts) == JBarcode().decode(img, pts)
    _same_barcode(tcv.barcode_BarcodeDetector().detectAndDecodeMulti(img), want)
    if not angle:
        r = cv2.barcode_BarcodeDetector().detectAndDecode(img)
        rinfos = r[1] if len(r) == 4 else r[0]
        assert not any(rinfos) or code in rinfos


def test_ean13_image_equals_the_reference_tests_rendering():
    """entry.ean13_image draws the code tests/test_objdetect.py draws."""
    for digits in ("590123412345", "401234567890"):
        code, img = E.ean13_image(digits, module=3, height=90, quiet=24)
        want_code, want = R._render_ean13(digits)
        assert code == want_code
        np.testing.assert_array_equal(img[36:-36], want[40:-40])
    blank = np.full((64, 64), 200, np.uint8)
    for mod in (tcv, jcv):
        assert mod.barcode_BarcodeDetector().detectAndDecode(blank)[0] is False
