"""cv2.cuda and the binding-compat classes of the port
(``opencv_tpu_torch/cuda.py``, ``compat_classes.py``) against the JAX
package's: the same constants, the same answers (0 devices, the same
raises), the same class surface.  The port runs on a CUDA card, but through
torch tensors, not through cv::cuda, so like the JAX package it reports a
build without cv::cuda (ROADMAP queue C)."""

import inspect

import numpy as np
import pytest

import opencv_tpu as jcv
import opencv_tpu.compat_classes as jcc
import opencv_tpu.cuda as jcuda
import opencv_tpu_torch as tcv
import opencv_tpu_torch.compat_classes as tcc
import opencv_tpu_torch.cuda as tcuda


def _public(mod):
    return sorted(n for n in dir(mod) if not n.startswith("_") and n != "annotations"
                  and not inspect.ismodule(getattr(mod, n)))


def test_cuda_module_names_and_constants_equal_opencv_tpu():
    assert _public(tcuda) == _public(jcuda)
    for n in _public(jcuda):
        want = getattr(jcuda, n)
        if isinstance(want, int):
            assert getattr(tcuda, n) == want, n
    assert tcv.cuda is tcuda


RAISING = [n for n in _public(jcuda) if inspect.isfunction(getattr(jcuda, n))
           and n not in ("getCudaEnabledDeviceCount", "Stream_Null") and not n.startswith(
               ("GpuMat_", "TargetArchs_"))]


@pytest.mark.parametrize("name", RAISING)
def test_cuda_function_raises_as_opencv_tpu(name):
    n_args = len(inspect.signature(getattr(jcuda, name)).parameters)
    args = [None] * n_args
    for mod in (jcuda, tcuda):
        fn = getattr(mod, name)
        if any(p.kind is p.VAR_POSITIONAL for p in inspect.signature(fn).parameters.values()):
            args = []
        with pytest.raises(RuntimeError, match="no CUDA support"):
            fn(*args)


def test_cuda_answers_equal_opencv_tpu():
    assert tcuda.getCudaEnabledDeviceCount() == jcuda.getCudaEnabledDeviceCount() == 0
    assert isinstance(tcuda.Stream_Null(), tcuda.Stream)
    for n in ("GpuMat_defaultAllocator", "GpuMat_getStdAllocator"):
        assert getattr(tcuda, n)() is None is getattr(jcuda, n)()
    assert tcuda.GpuMat_setDefaultAllocator(None) is None
    for n in _public(jcuda):
        if n.startswith("TargetArchs_"):
            assert getattr(tcuda, n)(9, 0) is False is getattr(jcuda, n)(9, 0)


def test_compat_classes_equal_opencv_tpu():
    assert _public(tcc) == _public(jcc)
    for n in _public(jcc):
        j, t = getattr(jcc, n), getattr(tcc, n)
        assert type(j) is type(t) and t.__module__ == "opencv_tpu_torch.compat_classes", n
        assert getattr(tcv, n) is t
    g = tcv.cuda_GpuMat()
    assert g.empty()
    for meth in ("upload", "download"):
        with pytest.raises(tcv.error, match="without CUDA support"):
            getattr(g, meth)(np.zeros((2, 2), np.uint8))
    assert not tcv.cuda_DeviceInfo().isCompatible() and not tcv.cuda_TargetArchs.has(9, 0)
    assert isinstance(tcv.cuda_Stream.Null(), tcv.cuda_Stream)
    assert tcv.ocl_Device().name() == "" and not tcv.ocl_Device().available()
    assert tcv.ocl_OpenCLExecutionContext.getCurrent() is None


def test_error_and_binding_utils_equal_opencv_tpu():
    for mod in (tcv, jcv):
        e = mod.error("boom", code=-5, func="f", file="x.cpp", line=7)
        assert (str(e), e.code, e.err, e.func, e.file, e.line, e.msg) == \
            ("boom", -5, "boom", "f", "x.cpp", 7, "boom")
        assert mod.MatShape([1, 2]) == [1, 2]
        k = mod.utils_ClassWithKeywordProperties(lambda_=3)
        assert (k.lambda_, k.except_) == (3, -1)
        x = mod.utils_nested_ExportClassName.create(
            mod.utils_nested_ExportClassName_Params(7, 1.5))
        assert (x.getIntParam(), x.getFloatParam()) == (7, 1.5)
        d = mod.utils_nested_ExportClassName()
        assert (d.getIntParam(), d.getFloatParam()) == (123, 3.5)
