"""Binding-compatibility class surface (twin of
``opencv_tpu/compat_classes.py``): the cv2 wheel exports flattened nested
classes (detail_*, cuda_*, ocl_*, dnn_*) plus a handful of scaffolding
types.  Real machinery lives in the dedicated modules (stitch_detail, dnn,
threed); this file provides the flattened aliases and the platform stubs.

cv::cuda reports absent here as it does in the JAX package, although the
port itself runs on a CUDA card: the port reaches the card through torch
tensors, and has neither a working ``GpuMat`` nor cv::cuda's algorithms,
so a wheel built without cv::cuda is what this surface honestly is.
OpenCL reports absent too."""

from __future__ import annotations

import numpy as np


class error(Exception):
    """cv2.error — carries code/err/func/file/line like the binding."""

    def __init__(self, msg="", code=-1, err="", func="", file="",
                 line=0):
        super().__init__(msg or err)
        self.code = code
        self.err = err or msg
        self.func = func
        self.file = file
        self.line = line
        self.msg = msg or err


class MatShape(list):
    """cv::MatShape — a small int vector."""


# ---------------------------------------------------------------- cuda/ocl

class _NoCuda:
    """cv::cuda stubs: unavailable, exactly like a reference build
    without cv::cuda (the port's own device work goes through torch)."""

    def __init__(self, *a, **k):
        pass

    def empty(self):
        return True


class cuda_GpuMat(_NoCuda):
    def upload(self, *a, **k):
        raise error("the library is compiled without CUDA support")

    def download(self, *a, **k):
        raise error("the library is compiled without CUDA support")


class cuda_GpuMatND(_NoCuda):
    pass


class cuda_GpuData(_NoCuda):
    pass


class cuda_GpuMat_Allocator(_NoCuda):
    pass


class cuda_HostMem(_NoCuda):
    pass


class cuda_Stream(_NoCuda):
    @staticmethod
    def Null():
        return cuda_Stream()


class cuda_Event(_NoCuda):
    pass


class cuda_BufferPool(_NoCuda):
    pass


class cuda_DeviceInfo(_NoCuda):
    def isCompatible(self):
        return False


class cuda_TargetArchs(_NoCuda):
    @staticmethod
    def has(major, minor):
        return False


class ocl_Device:
    def name(self):
        return ""

    def available(self):
        return False


class ocl_OpenCLExecutionContext:
    @staticmethod
    def getCurrent():
        return None


# ------------------------------------------------------- binding test utils

class utils_ClassWithKeywordProperties:
    def __init__(self, lambda_=-1, except_=-1):
        self.lambda_ = lambda_
        self.except_ = except_


class utils_nested_ExportClassName:
    class Params:
        def __init__(self, int_param=123, float_param=3.5):
            self.int_value = int_param
            self.float_value = float_param

    def __init__(self, params=None):
        self._p = params or self.Params()

    @staticmethod
    def create(params=None):
        return utils_nested_ExportClassName(params)

    def getIntParam(self):
        return self._p.int_value

    def getFloatParam(self):
        return self._p.float_value


utils_nested_ExportClassName_Params = utils_nested_ExportClassName.Params
