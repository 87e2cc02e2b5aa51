"""DISK and ALIKED of the port (``opencv_tpu_torch/features2d/dl_features.py``)
against the JAX package's and the cv2 wheel, on the CPU, with
tests/test_dl_features.py's synthetic ONNX graphs (the 5.x wheel's I/O
contracts): keypoints, responses and descriptors equal to the JAX
package's, and to the wheel's under its test's bounds."""

import numpy as np
import pytest
import torch

from common import cv2
from torch_threads import _one_torch_thread  # noqa: F401
from test_dl_features import IMG, N, _aliked_model, _cmp, _disk_model

import opencv_tpu as jcv
import opencv_tpu_torch as tcv


@pytest.fixture(scope="module")
def paths():
    return {"disk": _disk_model(), "aliked": _aliked_model()}


def _same(ours, theirs):
    (okps, odesc), (jkps, jdesc) = ours, theirs
    assert len(okps) == len(jkps)
    np.testing.assert_array_equal(np.array([k.pt for k in okps]), np.array([k.pt for k in jkps]))
    assert [k.response for k in okps] == [k.response for k in jkps]
    assert [k.size for k in okps] == [k.size for k in jkps]
    np.testing.assert_array_equal(odesc, np.asarray(jdesc))


@pytest.mark.parametrize("args", [(), (3,), (100, 0.75), (100, 0.0, (320, 240))])
def test_disk_equals_opencv_tpu_and_the_wheel(paths, args):
    p = paths["disk"]
    ours = tcv.DISK_create(p, *args, device="cpu").detectAndCompute(IMG, None)
    _same(ours, jcv.DISK_create(p, *args).detectAndCompute(IMG, None))
    _cmp(*cv2.DISK_create(p, *args).detectAndCompute(IMG, None), *ours)


def test_disk_gray_tensor_and_memory(paths):
    p = paths["disk"]
    g = cv2.cvtColor(IMG, cv2.COLOR_BGR2GRAY)
    ours = tcv.DISK_create(p, device="cpu").detectAndCompute(torch.from_numpy(g), None)
    _same(ours, jcv.DISK_create(p).detectAndCompute(g, None))
    buf = np.frombuffer(open(p, "rb").read(), np.uint8)
    kps, desc = tcv.DISK_createFromMemory(buf, device="cpu").detectAndCompute(IMG, None)
    assert len(kps) == N and desc.shape == (N, 128)


def test_aliked_equals_opencv_tpu_and_the_wheel(paths):
    p = paths["aliked"]
    ours = tcv.ALIKED_create(p, device="cpu").detectAndCompute(IMG, None)
    theirs = jcv.ALIKED_create(p).detectAndCompute(IMG, None)
    np.testing.assert_allclose(np.array([k.pt for k in ours[0]]),
                               np.array([k.pt for k in theirs[0]]), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(ours[1], theirs[1])
    _cmp(*cv2.ALIKED_create(p).detectAndCompute(IMG, None), *ours, pt_tol=1e-2)
    params = tcv.ALIKED_Params()
    params.normalizeDescriptors = False
    params.inputSize = 320
    raw = tcv.ALIKED_create(p, params, device="cpu").detectAndCompute(IMG, None)[1]
    jp = jcv.ALIKED_Params()
    jp.normalizeDescriptors, jp.inputSize = False, 320
    np.testing.assert_array_equal(raw, jcv.ALIKED_create(p, jp).detectAndCompute(IMG, None)[1])


def test_the_feature2d_surface(paths):
    for name in ("disk", "aliked"):
        cls = tcv.DISK if name == "disk" else tcv.ALIKED
        det = cls.create(paths[name], device="cpu")
        jdet = getattr(jcv, cls.__name__).create(paths[name])
        for m in ("descriptorSize", "descriptorType", "defaultNorm", "empty"):
            assert getattr(det, m)() == getattr(jdet, m)(), m
        kps = det.detect(IMG)
        assert len(kps) == N
        _, desc = det.compute(IMG, kps)
        assert desc.shape == (N, 128)
        det.clear()
        assert det.empty()
        with pytest.raises(RuntimeError):
            det.detectAndCompute(IMG)
    assert tcv.DISK_create().empty() and tcv.DISK_create().device == torch.device("cuda")
