"""The port's headless highgui, ``mat_wrapper``, the top-level Mat / UMat
names and the one-name modules (Error, instr, ipp, misc, ocl, ogl, qt,
samples, typing, version, data) against the JAX package's: every constant
and return value, addText's pixels, ``samples.findFile``, the
``data.haarcascades`` string, Mat's ``wrap_channels``; and the names and
values cv2's own modules have (tests/test_surface.py,
test_tail_apis4.py)."""

import os
import types

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu_torch import highgui as th
from opencv_tpu import highgui as jh

ONE_NAME = ("Error", "instr", "ipp", "misc", "ocl", "ogl", "qt", "samples", "typing", "version",
            "data", "mat_wrapper", "videoio_registry")


def _values(mod):
    """A module's public names: each constant's value, each class and
    function by name, nested modules left out."""
    out = {}
    for n in dir(mod):
        if n.startswith("_"):
            continue
        v = getattr(mod, n)
        if isinstance(v, types.ModuleType):
            continue
        if isinstance(v, (int, float, str, bool, tuple)) or v is None:
            out[n] = v
        elif isinstance(v, type) or callable(v):
            out[n] = ("callable", getattr(v, "__name__", n))
        else:
            out[n] = repr(v)
    return out


@pytest.mark.parametrize("name", ONE_NAME)
def test_one_name_module_equals_opencv_tpu(name):
    ours, theirs = getattr(tcv, name), getattr(jcv, name)
    assert ours.__name__ == f"opencv_tpu_torch.{name}"
    got, want = _values(ours), _values(theirs)
    if name == "data":
        got.pop("haarcascades"), want.pop("haarcascades")
    assert got == want


@pytest.mark.parametrize("name", ("Error", "instr", "ipp", "misc", "ocl", "ogl", "qt", "samples",
                                  "typing", "version", "data", "mat_wrapper",
                                  "videoio_registry"))
def test_submodule_names_and_values_match_cv2(name):
    """tests/test_surface.py::test_submodule_parity with the port."""
    w, o = getattr(cv2, name), getattr(tcv, name)
    missing, bad = [], []
    for n in dir(w):
        if n.startswith("_"):
            continue
        v = getattr(w, n)
        if isinstance(v, types.ModuleType):
            continue
        if (name, n) in (("data", "haarcascades"), ("version", "opencv_version"),
                         ("version", "ci_build"), ("version", "headless")):
            continue
        if not hasattr(o, n):
            missing.append(n)
        elif isinstance(v, (int, float, bool)) and not isinstance(v, type) and not callable(v):
            if getattr(o, n) != v:
                bad.append((n, v, getattr(o, n)))
    assert not missing and not bad, (missing, bad)


def test_return_values_equal_opencv_tpu():
    for mod in (tcv, jcv):
        assert mod.ipp.getIppVersion() == "disabled" and mod.ipp.useIPP() is False
        assert mod.ipp.setUseIPP(True) is None and mod.ipp.useIPP_NotExact() is False
        assert mod.ipp.setUseIPP_NotExact(True) is None
        assert mod.ocl.haveOpenCL() is mod.ocl.useOpenCL() is mod.ocl.haveAmdBlas() is False
        assert mod.ocl.haveAmdFft() is False and mod.ocl.setUseOpenCL(True) is None
        assert mod.ocl.finish() is None
        assert mod.misc.get_ocv_version() == mod.version.opencv_version == "5.0.0-tpu"
        assert mod.UMat_context() == mod.UMat_queue() == 0
    assert type(tcv.ocl.Device_getDefault()).__name__ == type(jcv.ocl.Device_getDefault()).__name__
    assert tcv.ocl.Device is tcv.ocl_Device
    assert tcv.ocl.OpenCLExecutionContext is tcv.ocl_OpenCLExecutionContext
    assert tcv.typing.TermCriteria_Type.EPS == jcv.typing.TermCriteria_Type.EPS == 2
    assert tcv.typing.Size == jcv.typing.Size and tcv.typing.Rect == jcv.typing.Rect


def test_highgui_equals_opencv_tpu():
    assert th.__all__ == jh.__all__
    for n in ("WINDOW_NORMAL", "WINDOW_AUTOSIZE", "WND_PROP_VISIBLE"):
        assert getattr(th, n) == getattr(jh, n)
    img = np.arange(7 * 9, dtype=np.uint8).reshape(7, 9)
    for h in (th, jh):
        h.destroyAllWindows()
        assert h.getWindowProperty("t", 4) == -1.0
        assert h.getWindowImageRect("t") == (0, 0, -1, -1)
        h.namedWindow("t")
        assert h.getWindowProperty("t", 4) == 1.0
        h.imshow("t", img)
        assert h.getWindowImageRect("t") == (0, 0, 9, 7)
        h.createTrackbar("a", "t", 3, 10, None)
        assert h.getTrackbarPos("a", "t") == 3
        h.setTrackbarPos("a", "t", 7)
        assert h.getTrackbarPos("a", "t") == 7 and h.getTrackbarPos("b", "t") == 0
        assert h.waitKey(0) == h.pollKey() == h.waitKeyEx(1) == -1
        assert h.startWindowThread() == 0 and h.currentUIFramework() == ""
        assert h.selectROI("w", img) == (0, 0, 0, 0) and h.selectROIs("w", img) == []
        for fn, args in (("moveWindow", ("t", 1, 2)), ("resizeWindow", ("t", 3, 4)),
                         ("setMouseCallback", ("t", None)), ("setWindowProperty", ("t", 0, 1)),
                         ("setWindowTitle", ("t", "x")), ("setTrackbarMin", ("a", "t", 0)),
                         ("setTrackbarMax", ("a", "t", 10)), ("displayOverlay", ("t", "hi")),
                         ("displayStatusBar", ("t", "hi")), ("createButton", ("b",))):
            assert getattr(h, fn)(*args) is None
        h.destroyWindow("t")
        assert h.getWindowProperty("t", 4) == -1.0
    assert th._windows == jh._windows == {}


def test_imshow_stores_the_host_copy_of_a_tensor():
    t = torch.arange(6 * 5 * 3, dtype=torch.uint8).reshape(6, 5, 3)
    tcv.imshow("tensor", t[:, ::1])
    stored = th._windows["tensor"]
    assert isinstance(stored, np.ndarray)
    np.testing.assert_array_equal(stored, t.numpy())
    assert tcv.getWindowImageRect("tensor") == (0, 0, 5, 6)
    tcv.destroyAllWindows()


@pytest.mark.parametrize("size,color", [(-1, None), (12, (10, 200, 30)), (48, (255, 0, 0))])
def test_add_text_pixels_equal_opencv_tpu(size, color):
    base = np.full((60, 160, 3), 90, np.uint8)
    got = tcv.addText(base.copy(), "Hi 27", (5, 40), "Sans", size, color)
    want = jcv.addText(base.copy(), "Hi 27", (5, 40), "Sans", size, color)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.count_nonzero(np.asarray(got) != base) > 0
    on_tensor = tcv.addText(torch.from_numpy(base.copy()), "Hi 27", (5, 40), "Sans", size, color)
    np.testing.assert_array_equal(on_tensor.numpy(), np.asarray(want))


def test_samples_find_file_equals_opencv_tpu(tmp_path, monkeypatch):
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "x.txt").write_text("x")
    (tmp_path / "y.txt").write_text("y")
    monkeypatch.setenv("OPENCV_SAMPLES_DATA_PATH", str(tmp_path))
    for s in (tcv.samples, jcv.samples):
        monkeypatch.setattr(s, "_search_paths", [])
        monkeypatch.setattr(s, "_sub_dirs", [""])
    for s in (tcv.samples, jcv.samples):
        s.addSamplesDataSearchSubDirectory("sub")
    got = [tcv.samples.findFile("y.txt"), tcv.samples.findFile("x.txt"),
           tcv.samples.findFile(str(tmp_path / "y.txt")),
           tcv.samples.findFile("none.txt", required=False),
           tcv.samples.findFileOrKeep("none.txt"), tcv.samples.findFileOrKeep("x.txt")]
    want = [jcv.samples.findFile("y.txt"), jcv.samples.findFile("x.txt"),
            jcv.samples.findFile(str(tmp_path / "y.txt")),
            jcv.samples.findFile("none.txt", required=False),
            jcv.samples.findFileOrKeep("none.txt"), jcv.samples.findFileOrKeep("x.txt")]
    assert got == want
    assert got[0] == os.path.join(str(tmp_path), "y.txt")
    assert got[1] == os.path.join(str(tmp_path), "sub", "x.txt")
    with pytest.raises(FileNotFoundError):
        tcv.samples.findFile("none.txt")
    other = tmp_path / "first"
    other.mkdir()
    (other / "y.txt").write_text("z")
    tcv.samples.addSamplesDataSearchPath(other)
    jcv.samples.addSamplesDataSearchPath(other)
    assert tcv.samples.findFile("y.txt") == jcv.samples.findFile("y.txt") == str(other / "y.txt")


def test_data_haarcascades_string():
    """The port's candidates are the JAX package's with its own data dir
    first and without the JAX package's last, a fixed path outside the
    repo; the string is the first that holds a cascade, else the first."""
    ours, theirs = tcv.data, jcv.data
    assert ours._candidates[0] == os.path.join(os.path.dirname(ours.__file__), "haarcascades")
    assert ours._candidates[1:] == theirs._candidates[1:-1]
    want = next((p + os.sep for p in ours._candidates if ours._has_cascades(p)),
                ours._candidates[0] + os.sep)
    assert ours.haarcascades == want and ours.haarcascades.endswith(os.sep)
    if theirs.haarcascades in (p + os.sep for p in theirs._candidates[1:-1]):
        assert ours.haarcascades == theirs.haarcascades
    if theirs.haarcascades == theirs._candidates[0] + os.sep:
        assert ours.haarcascades == ours._candidates[0] + os.sep


def test_mat_wrapper_and_umat_equal_opencv_tpu():
    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    for mod in (tcv, jcv):
        m = mod.mat_wrapper.Mat(a, wrap_channels=True)
        assert isinstance(m, np.ndarray) and type(m).__name__ == "Mat"
        assert m.wrap_channels is True
        np.testing.assert_array_equal(m, a)
        view = m[1:]
        assert type(view) is mod.mat_wrapper.Mat and view.wrap_channels is True
        assert mod.mat_wrapper.Mat(a).wrap_channels is False
        top = mod.Mat(a, wrap_channels=True)
        assert mod.UMat is mod.Mat and top.wrap_channels is True
        np.testing.assert_array_equal(top, a)
        assert mod.Mat().shape == (0,) and mod.UMat([1, 2]).tolist() == [1, 2]
    assert tcv.Mat.__doc__ == jcv.Mat.__doc__
    assert tcv.mat_wrapper.Mat.__doc__ == jcv.mat_wrapper.Mat.__doc__


def test_istream_reader_equals_opencv_tpu():
    assert tcv.IStreamReader.__doc__ == jcv.IStreamReader.__doc__
    for cls in (tcv.IStreamReader, jcv.IStreamReader):
        r = cls()
        with pytest.raises(NotImplementedError):
            r.read(None, 0)
        with pytest.raises(NotImplementedError):
            r.seek(0, 0)


def test_headless_highgui_surface():
    """tests/test_tail_apis4.py::test_headless_highgui_surface with the port."""
    assert tcv.waitKeyEx(1) == -1
    assert tcv.selectROI("w", np.zeros((5, 5), np.uint8)) == (0, 0, 0, 0)
    assert tcv.selectROIs("w", np.zeros((5, 5), np.uint8)) == []
    tcv.namedWindow("t")
    tcv.imshow("t", np.zeros((7, 9), np.uint8))
    assert tcv.getWindowImageRect("t") == (0, 0, 9, 7)
    tcv.setWindowTitle("t", "x")
    tcv.setTrackbarMin("a", "t", 0)
    tcv.setTrackbarMax("a", "t", 10)
    tcv.displayOverlay("t", "hi")
    tcv.displayStatusBar("t", "hi")
    tcv.createButton("b")
    tcv.startWindowThread()
    assert isinstance(tcv.currentUIFramework(), str)
    tcv.destroyAllWindows()
    for n in ("WINDOW_NORMAL", "WINDOW_AUTOSIZE"):
        assert getattr(tcv, n) == getattr(cv2, n)
