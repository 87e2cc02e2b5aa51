"""Build/runtime information (cv::getBuildInformation analogue) and
thread-control compatibility shims (twin of ``opencv_tpu/utils/buildinfo.py``:
parallelism is the CUDA devices and batch sharding, not a thread pool)."""

from __future__ import annotations


def _cuda_devices() -> list:
    import torch

    if not torch.cuda.is_available():
        return []
    return [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]


def getBuildInformation() -> str:
    import torch

    devices = _cuda_devices()
    lines = [
        "General configuration for opencv_tpu",
        f"  torch:   {torch.__version__}",
        f"  cuda:    {torch.version.cuda}",
        f"  devices: {devices}",
        f"  backend: {'cuda' if devices else 'cpu'}",
        "  compute: CUDA C++ kernels + PyTorch ops (NHWC batched)",
        "  parallel: torch.distributed mesh (batch DP + spatial SP)",
    ]
    return "\n".join(lines)


def setNumThreads(n: int) -> None:
    """Compatibility no-op: parallelism is the CUDA devices, not a host
    thread pool (cv::setNumThreads analogue)."""


def getNumThreads() -> int:
    """The number of devices, as the JAX package's counts jax's: the CUDA
    devices, or 1 (the CPU) where there is none."""
    return len(_cuda_devices()) or 1
