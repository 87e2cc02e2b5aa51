"""System/utility surface (core/src/system.cpp): tick counters, version,
thread controls (no-ops, as in the JAX package), build info; twin of
``opencv_tpu/utils/system.py``, whose build information reports torch, its
CUDA and the CUDA devices where the JAX package reports jax."""

from __future__ import annotations

import os
import time

VERSION_MAJOR, VERSION_MINOR, VERSION_REVISION = 5, 0, 0
VERSION_STATUS = "-tpu"

_TICK_FREQ = 1_000_000_000


def getTickCount() -> int:
    return time.perf_counter_ns()


def getTickFrequency() -> float:
    return float(_TICK_FREQ)


def getCPUTickCount() -> int:
    return time.perf_counter_ns()


def getNumThreads() -> int:
    return os.cpu_count() or 1


def setNumThreads(n: int) -> None:
    """No-op, as in the JAX package: ops run as device kernels and torch
    ops, not on a host thread pool of this package (the reference's
    parallel_for_ has no analogue)."""


def getThreadNum() -> int:
    return 0


def getNumberOfCPUs() -> int:
    return os.cpu_count() or 1


def useOptimized() -> bool:
    return True


def setUseOptimized(flag: bool) -> None:
    pass


def checkHardwareSupport(feature: int) -> bool:
    return False   # CPU SIMD feature flags don't apply to the device path


def getHardwareFeatureName(feature: int) -> str:
    return ""


def getCPUFeaturesLine() -> str:
    return ""


def getVersionMajor() -> int:
    return VERSION_MAJOR


def getVersionMinor() -> int:
    return VERSION_MINOR


def getVersionRevision() -> int:
    return VERSION_REVISION


def getVersionString() -> str:
    return f"{VERSION_MAJOR}.{VERSION_MINOR}.{VERSION_REVISION}" \
           f"{VERSION_STATUS}"


def getBuildInformation() -> str:
    import torch
    n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
    lines = [
        "General configuration for opencv_tpu",
        f"  Version control:  {getVersionString()}",
        "  Platform:         PyTorch/CUDA port (opencv_tpu_torch, CUDA C++ kernels)",
        f"  torch:            {torch.__version__}",
        f"  CUDA:             {torch.version.cuda}",
        f"  Backend:          {'cuda' if n_cuda else 'cpu'}",
        f"  Devices:          {n_cuda}",
    ]
    return "\n".join(lines) + "\n"


_error_handler = None


def redirectError(onError=None):
    """cv::redirectError — store (or clear) a custom error callback.
    Errors in this package surface as Python exceptions, so the handler
    is kept for API compatibility and invoked by ``error()``."""
    global _error_handler
    _error_handler = onError


ALGO_HINT_DEFAULT = 0
ALGO_HINT_ACCURATE = 1
ALGO_HINT_APPROX = 2


def getDefaultAlgorithmHint() -> int:
    return ALGO_HINT_ACCURATE


def bootstrap() -> None:
    """cv2.bootstrap — loader hook; nothing to do in-process."""


def VideoCapture_waitAny(streams, timeoutNs: int = 0):
    """cv::VideoCapture::waitAny — our captures are synchronous file
    readers, so every opened stream is immediately ready."""
    ready = [i for i, s in enumerate(streams)
             if getattr(s, "isOpened", lambda: False)()]
    return len(ready) > 0, ready
