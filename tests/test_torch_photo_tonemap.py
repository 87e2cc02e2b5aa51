"""The port's Debevec and Robertson merging and calibration and the four
tonemappers on the CPU, against opencv_tpu (exactly: they are the JAX
package's numpy code, over the port's resize in Mantiuk's case) and
tests/test_photo.py's Debevec check, on one (48, 64, 3) bracket."""

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from torch_threads import _one_torch_thread  # noqa: F401

TIMES = np.array([0.25, 1.0, 4.0], np.float32)


@pytest.fixture(scope="module")
def bracket():
    rng = np.random.default_rng(0)
    base = cv2.GaussianBlur(rng.integers(0, 256, (48, 64, 3), np.uint8), (5, 5), 1.5)
    return [np.clip(base.astype(float) * t * 0.6 + 4, 0, 255).astype(np.uint8) for t in TIMES]


def test_debevec_equals_opencv_tpu(bracket):
    t = [torch.from_numpy(b) for b in bracket]
    resp = tcv.createCalibrateDebevec().process(t, TIMES)
    np.testing.assert_array_equal(resp.numpy(),
                                  jcv.createCalibrateDebevec().process(bracket, TIMES))
    for r in (None, resp):
        got = tcv.createMergeDebevec().process(t, TIMES, r)
        want = jcv.createMergeDebevec().process(bracket, TIMES, None if r is None else r.numpy())
        np.testing.assert_array_equal(got.numpy(), want)


def test_robertson_equals_opencv_tpu(bracket):
    t = [torch.from_numpy(b) for b in bracket]
    cal, jcal = tcv.createCalibrateRobertson(5, 0.01), jcv.createCalibrateRobertson(5, 0.01)
    resp = cal.process(t, TIMES)
    np.testing.assert_array_equal(resp.numpy(), jcal.process(bracket, TIMES))
    np.testing.assert_array_equal(cal.getRadiance().numpy(), jcal.getRadiance())
    for r in (None, resp):
        got = tcv.createMergeRobertson().process(t, TIMES, r)
        want = jcv.createMergeRobertson().process(bracket, TIMES,
                                                   None if r is None else r.numpy())
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name,args", [("Tonemap", (2.2,)), ("TonemapDrago", (1.0, 1.0, 0.7)),
                                       ("TonemapReinhard", (1.5, 0.5)),
                                       ("TonemapMantiuk", (2.2, 0.7, 1.2))])
def test_tonemap_equals_opencv_tpu(bracket, name, args):
    hdr = jcv.createMergeDebevec().process(bracket, TIMES)
    got = getattr(tcv, "create" + name)(*args).process(torch.from_numpy(hdr))
    np.testing.assert_array_equal(got.numpy(), getattr(jcv, "create" + name)(*args).process(hdr))


def test_debevec_calibrate_and_tonemap_like_the_reference_test():
    """tests/test_photo.py's test_merge_debevec_calibrate on the port."""
    rng = np.random.default_rng(2)
    base = rng.integers(20, 200, (32, 32, 3), np.uint8)
    exposures = [np.clip(base.astype(float) * t, 0, 255).astype(np.uint8) for t in TIMES]
    resp = tcv.createCalibrateDebevec().process(exposures, TIMES)
    hdr = tcv.createMergeDebevec().process(exposures, TIMES, resp)
    assert tuple(hdr.shape) == base.shape and bool(torch.isfinite(hdr).all())
    ldr = tcv.createTonemapReinhard().process(hdr)
    assert 0 <= float(ldr.min()) and float(ldr.max()) <= 1.0
