"""YuNet, SFace and the MCC chart detector of the port
(``opencv_tpu_torch/objdetect/face.py``, ``mcc.py``) against the JAX
package's and cv2, on the CPU.

The face models' published ONNX files are not in the repository: both
packages (and cv2) read the same small graphs of YuNet's and SFace's
interfaces, written from a seed by the port's codec (``entry.face_models``).
The nets' float32 convolutions sum in oneDNN's and XLA's orders, so the
detections agree within FACE_ATOL (boxes, landmarks and scores) and the
embeddings within EMB_RTOL; the decode, NMS and alignment on top are the JAX
package's code.  alignCrop's warpAffine is held to the warp bound of
tests/test_warp.py.  MCC's patches equal the JAX package's exactly."""

import numpy as np
import pytest
import torch

from common import cv2
from torch_threads import _one_torch_thread  # noqa: F401

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu_torch import entry as E

FACE_ATOL = 1e-4
EMB_RTOL = 1e-5
# (warp) max |d| and the share of pixels that may differ, tests/test_warp.py's
WARP_MAX, WARP_SHARE = 1, 1e-3


@pytest.fixture(scope="module")
def face_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("faces")
    out = {}
    for k, b in E.face_models(0).items():
        out[k] = str(d / f"{k}.onnx")
        with open(out[k], "wb") as fh:
            fh.write(b)
    return out


def _sorted(f):
    return f[np.lexsort((f[:, 0], f[:, 14]))]


@pytest.mark.parametrize("seed,score", [(1, 0.45), (2, 0.5)])
def test_face_detector_yn_equals_opencv_tpu_and_cv2(face_files, seed, score):
    img = np.random.default_rng(seed).integers(0, 256, (96, 96, 3), np.uint8)
    ours = tcv.FaceDetectorYN_create(face_files["yunet"], "", (96, 96), score, 0.3, 50,
                                     device="cpu")
    _, got = ours.detect(img)
    args = (face_files["yunet"], "", (96, 96), score, 0.3, 50)
    _, want = jcv.FaceDetectorYN_create(*args).detect(img)
    _, ref = cv2.FaceDetectorYN_create(*args).detect(img)
    assert got is not None and want is not None and ref is not None
    assert got.shape == want.shape == ref.shape and got.dtype == np.float32
    assert np.abs(_sorted(got) - _sorted(want)).max() <= FACE_ATOL
    assert np.abs(_sorted(got) - _sorted(ref)).max() <= 1e-3
    _, again = ours.detect(torch.from_numpy(img))
    np.testing.assert_array_equal(again, got)
    with pytest.raises(ValueError, match="Size does not match"):
        ours.detect(img[:64])
    ours.setInputSize((64, 96))
    assert ours.getInputSize() == (64, 96) and ours.getTopK() == 50


def test_face_recognizer_sf_equals_opencv_tpu(face_files):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (200, 200, 3), np.uint8)
    face = np.zeros(15, np.float32)
    face[:4] = [40, 40, 100, 100]
    face[4:14] = [70, 80, 120, 80, 95, 105, 75, 130, 115, 130]
    ours = tcv.FaceRecognizerSF_create(face_files["sface"], "", device="cpu")
    ref = jcv.FaceRecognizerSF_create(face_files["sface"], "")
    oa, ra = ours.alignCrop(img, face).numpy(), ref.alignCrop(img, face)
    assert oa.shape == ra.shape == (112, 112, 3)
    d = np.abs(oa.astype(int) - ra.astype(int))
    assert d.max() <= WARP_MAX and (d > 0).mean() <= WARP_SHARE
    f1o, f1r = ours.feature(ra), ref.feature(ra)
    assert f1o.shape == f1r.shape == (1, 16)
    np.testing.assert_allclose(f1o, f1r, rtol=EMB_RTOL, atol=EMB_RTOL * np.abs(f1r).max())
    f2 = ref.feature(ref.alignCrop(img, face + 2))
    for dist in (0, 1):
        assert abs(ours.match(f1o, f2, dist) - ref.match(f1r, f2, dist)) <= 1e-5
    cv_ref = cv2.FaceRecognizerSF_create(face_files["sface"], "")
    assert np.abs(oa.astype(int) - cv_ref.alignCrop(img, face).astype(int)).mean() < 2.0
    with pytest.raises(ValueError):
        ours.match(f1o, f2, 5)


def _chart(seed, shape=(300, 440, 3)):
    rng = np.random.default_rng(seed)
    img = np.full(shape, 30, np.uint8)
    colors = rng.integers(40, 230, (24, 3))
    for k in range(24):
        r, c = divmod(k, 6)
        x0, y0 = 25 + c * 68, 25 + r * 66
        img[y0:y0 + 52, x0:x0 + 56] = colors[k]
    return img, colors


@pytest.mark.parametrize("seed", [0, 1])
def test_mcc_equals_opencv_tpu(seed):
    img, colors = _chart(seed)
    got, want = tcv.mcc_CCheckerDetector.create(), jcv.mcc_CCheckerDetector.create()
    assert got.process(torch.from_numpy(img), 0) and want.process(img, 0)
    g, w = got.getBestColorChecker(), want.getBestColorChecker()
    np.testing.assert_array_equal(g.getChartsRGB(), w.getChartsRGB())
    np.testing.assert_array_equal(g.getChartsYCbCr(), w.getChartsYCbCr())
    np.testing.assert_array_equal(g.getBox(), w.getBox())
    assert g.getCenter() == w.getCenter()
    assert np.abs(g.getChartsRGB().reshape(-1, 3) - colors[:, ::-1]).max() <= 2
    np.testing.assert_array_equal(got.getRefColors(), want.getRefColors())
    np.testing.assert_array_equal(np.asarray(got.draw(img.copy())), want.draw(img.copy()))
    blank = np.full((120, 160, 3), 90, np.uint8)
    assert not got.process(blank) and got.getBestColorChecker() is None
    assert tcv.mcc.MCC24 == jcv.mcc.MCC24 and vars(tcv.mcc_DetectorParametersMCC()) == \
        vars(jcv.mcc_DetectorParametersMCC())
