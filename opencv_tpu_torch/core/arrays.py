"""Array layout conventions (twin of ``opencv_tpu/core/arrays.py``).

The canonical layout is **batched NHWC**: ``(N, H, W, C)`` tensors.  The
public API also accepts the cv2-style per-image shapes ``(H, W)`` and
``(H, W, C)`` and returns results in the matching convention: single-channel
per-image results come back as ``(H, W)``.

The device of a result is the device of its input tensor; there is no
global default.  numpy input becomes a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["as_tensor", "dtype_name", "to_batched", "from_batched", "to_device", "to_host"]


def as_tensor(src) -> torch.Tensor:
    """A tensor as it is, or a numpy array (or array-like) as a CPU tensor."""
    if isinstance(src, torch.Tensor):
        return src
    return torch.from_numpy(np.ascontiguousarray(src))


def to_host(a) -> np.ndarray:
    """A tensor on any device (read back once), or an array-like, as a host
    numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def to_device(table, device) -> torch.Tensor:
    """A host array (numpy or a CPU tensor) on `device`, without making the
    host wait: a copy to the card goes through pinned memory, queued on the
    current stream (a copy from pageable memory would wait for the queue)."""
    t = torch.from_numpy(np.ascontiguousarray(table)) if isinstance(table, np.ndarray) else table
    device = torch.device(device)
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype ("uint8", "int16", "float32", ...), as
    the dispatch predicates take it."""
    return str(dtype).removeprefix("torch.")


def to_batched(src):
    """Normalize input to (N, H, W, C); returns (x, meta) with meta for
    :func:`from_batched`."""
    x = as_tensor(src)
    if x.ndim == 2:
        return x[None, :, :, None], "hw"
    if x.ndim == 3:
        return x[None], "hwc"
    if x.ndim == 4:
        return x, "nhwc"
    raise ValueError(f"expected 2-4 dims, got shape {tuple(x.shape)}")


def from_batched(y, meta):
    """Undo :func:`to_batched`, using the cv2 convention that per-image
    single-channel results are rank-2."""
    if meta == "nhwc":
        return y
    y = y[0]
    if y.shape[-1] == 1:
        return y[..., 0]
    return y
