"""cv2.ocl — OpenCL runtime surface (core/include/opencv2/core/ocl.hpp).

This build has no OpenCL (compute runs on CUDA or the CPU through
PyTorch); the module reports OpenCL as unavailable, exactly like a wheel
built without it.  Twin of ``opencv_tpu/ocl.py`` over the port's
``compat_classes``.
"""

from .compat_classes import ocl_Device as Device
from .compat_classes import ocl_OpenCLExecutionContext as OpenCLExecutionContext  # noqa: E501

DEVICE_EXEC_KERNEL = Device_EXEC_KERNEL = 1
DEVICE_EXEC_NATIVE_KERNEL = Device_EXEC_NATIVE_KERNEL = 2
DEVICE_FP_DENORM = Device_FP_DENORM = 1
DEVICE_FP_INF_NAN = Device_FP_INF_NAN = 2
DEVICE_FP_ROUND_TO_NEAREST = Device_FP_ROUND_TO_NEAREST = 4
DEVICE_FP_ROUND_TO_ZERO = Device_FP_ROUND_TO_ZERO = 8
DEVICE_FP_ROUND_TO_INF = Device_FP_ROUND_TO_INF = 16
DEVICE_FP_FMA = Device_FP_FMA = 32
DEVICE_FP_SOFT_FLOAT = Device_FP_SOFT_FLOAT = 64
DEVICE_FP_CORRECTLY_ROUNDED_DIVIDE_SQRT = 128
Device_FP_CORRECTLY_ROUNDED_DIVIDE_SQRT = 128
DEVICE_NO_CACHE = Device_NO_CACHE = 0
DEVICE_READ_ONLY_CACHE = Device_READ_ONLY_CACHE = 1
DEVICE_READ_WRITE_CACHE = Device_READ_WRITE_CACHE = 2
DEVICE_NO_LOCAL_MEM = Device_NO_LOCAL_MEM = 0
DEVICE_LOCAL_IS_LOCAL = Device_LOCAL_IS_LOCAL = 1
DEVICE_LOCAL_IS_GLOBAL = Device_LOCAL_IS_GLOBAL = 2
DEVICE_TYPE_DEFAULT = Device_TYPE_DEFAULT = 1
DEVICE_TYPE_CPU = Device_TYPE_CPU = 2
DEVICE_TYPE_GPU = Device_TYPE_GPU = 4
DEVICE_TYPE_ACCELERATOR = Device_TYPE_ACCELERATOR = 8
DEVICE_TYPE_DGPU = Device_TYPE_DGPU = 65540
DEVICE_TYPE_IGPU = Device_TYPE_IGPU = 131076
DEVICE_TYPE_ALL = Device_TYPE_ALL = 4294967295
DEVICE_UNKNOWN_VENDOR = Device_UNKNOWN_VENDOR = 0
DEVICE_VENDOR_AMD = Device_VENDOR_AMD = 1
DEVICE_VENDOR_INTEL = Device_VENDOR_INTEL = 2
DEVICE_VENDOR_NVIDIA = Device_VENDOR_NVIDIA = 3
KERNEL_ARG_LOCAL = KernelArg_LOCAL = 1
KERNEL_ARG_READ_ONLY = KernelArg_READ_ONLY = 2
KERNEL_ARG_WRITE_ONLY = KernelArg_WRITE_ONLY = 4
KERNEL_ARG_READ_WRITE = KernelArg_READ_WRITE = 6
KERNEL_ARG_CONSTANT = KernelArg_CONSTANT = 8
KERNEL_ARG_PTR_ONLY = KernelArg_PTR_ONLY = 16
KERNEL_ARG_NO_SIZE = KernelArg_NO_SIZE = 256
OCL_VECTOR_DEFAULT = 0
OCL_VECTOR_OWN = 0
OCL_VECTOR_MAX = 1

_use_opencl = False


def haveOpenCL():
    return False


def haveAmdBlas():
    return False


def haveAmdFft():
    return False


def useOpenCL():
    return False


def setUseOpenCL(flag):
    # accepted and ignored: there is no OpenCL runtime in this build
    return None


def finish():
    return None


def Device_getDefault():
    return Device()
