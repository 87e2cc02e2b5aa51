"""cv2.cuda — the cv::cuda module surface
(modules/core/include/opencv2/core/cuda.hpp); twin of ``opencv_tpu/cuda.py``.

The port runs its work on a CUDA card, but through torch tensors and its
own kernels, not through cv::cuda: it has no ``GpuMat`` that holds data and
none of cv::cuda's algorithms.  So this module keeps the JAX package's
answers and behaves like a wheel built without cv::cuda: device count 0,
``setDevice`` and the rest raise, the class surface is present.  A caller
who wants the card passes tensors on it to the port's functions.
"""

from .compat_classes import (
    cuda_GpuMat as GpuMat,
    cuda_GpuMatND as GpuMatND,
    cuda_GpuData as GpuData,
    cuda_HostMem as HostMem,
    cuda_Stream as Stream,
    cuda_Event as Event,
    cuda_BufferPool as BufferPool,
    cuda_DeviceInfo as DeviceInfo,
    cuda_TargetArchs as TargetArchs,
)

FEATURE_SET_COMPUTE_10 = 10
FEATURE_SET_COMPUTE_11 = 11
FEATURE_SET_COMPUTE_12 = 12
FEATURE_SET_COMPUTE_13 = 13
FEATURE_SET_COMPUTE_20 = 20
FEATURE_SET_COMPUTE_21 = 21
FEATURE_SET_COMPUTE_30 = 30
FEATURE_SET_COMPUTE_32 = 32
FEATURE_SET_COMPUTE_35 = 35
FEATURE_SET_COMPUTE_50 = 50
GLOBAL_ATOMICS = 11
SHARED_ATOMICS = 12
NATIVE_DOUBLE = 13
WARP_SHUFFLE_FUNCTIONS = 30
DYNAMIC_PARALLELISM = 35
EVENT_DEFAULT = Event_DEFAULT = 0
EVENT_BLOCKING_SYNC = Event_BLOCKING_SYNC = 1
EVENT_DISABLE_TIMING = Event_DISABLE_TIMING = 2
EVENT_INTERPROCESS = Event_INTERPROCESS = 4
HOST_MEM_PAGE_LOCKED = HostMem_PAGE_LOCKED = 1
HOST_MEM_SHARED = HostMem_SHARED = 2
HOST_MEM_WRITE_COMBINED = HostMem_WRITE_COMBINED = 4
DEVICE_INFO_COMPUTE_MODE_DEFAULT = DeviceInfo_ComputeModeDefault = 0
DEVICE_INFO_COMPUTE_MODE_EXCLUSIVE = DeviceInfo_ComputeModeExclusive = 1
DEVICE_INFO_COMPUTE_MODE_PROHIBITED = DeviceInfo_ComputeModeProhibited = 2
DEVICE_INFO_COMPUTE_MODE_EXCLUSIVE_PROCESS = 3
DeviceInfo_ComputeModeExclusiveProcess = 3


def getCudaEnabledDeviceCount():
    return 0


def getDevice():
    raise RuntimeError("no CUDA support in this build")


def setDevice(device):
    raise RuntimeError("no CUDA support in this build")


def resetDevice():
    raise RuntimeError("no CUDA support in this build")


def printCudaDeviceInfo(device):
    raise RuntimeError("no CUDA support in this build")


def printShortCudaDeviceInfo(device):
    raise RuntimeError("no CUDA support in this build")


def createContinuous(rows, cols, type, arr=None):
    raise RuntimeError("no CUDA support in this build")


def createGpuMatFromCudaMemory(*a, **k):
    raise RuntimeError("no CUDA support in this build")


def ensureSizeIsEnough(rows, cols, type, arr=None):
    raise RuntimeError("no CUDA support in this build")


def registerPageLocked(m):
    raise RuntimeError("no CUDA support in this build")


def unregisterPageLocked(m):
    raise RuntimeError("no CUDA support in this build")


def setBufferPoolConfig(*a, **k):
    raise RuntimeError("no CUDA support in this build")


def setBufferPoolUsage(on):
    raise RuntimeError("no CUDA support in this build")


def wrapStream(ptr):
    raise RuntimeError("no CUDA support in this build")


def fastNlMeansDenoising(*a, **k):
    raise RuntimeError("no CUDA support in this build")


def fastNlMeansDenoisingColored(*a, **k):
    raise RuntimeError("no CUDA support in this build")


def nonLocalMeans(*a, **k):
    raise RuntimeError("no CUDA support in this build")


def Stream_Null():
    return Stream()


def Event_elapsedTime(start, end):
    raise RuntimeError("no CUDA support in this build")


def GpuMat_defaultAllocator():
    return None


def GpuMat_getStdAllocator():
    return None


def GpuMat_setDefaultAllocator(alloc):
    return None


def TargetArchs_has(major, minor):
    return False


def TargetArchs_hasBin(major, minor):
    return False


def TargetArchs_hasPtx(major, minor):
    return False


def TargetArchs_hasEqualOrGreater(major, minor):
    return False


def TargetArchs_hasEqualOrGreaterBin(major, minor):
    return False


def TargetArchs_hasEqualOrGreaterPtx(major, minor):
    return False


def TargetArchs_hasEqualOrLessPtx(major, minor):
    return False
