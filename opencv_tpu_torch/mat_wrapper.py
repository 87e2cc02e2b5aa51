"""cv2.mat_wrapper — the wheel's numpy-subclass Mat helper
(cv2/mat_wrapper/__init__.py in the wheel)."""

from typing import Any, TYPE_CHECKING  # noqa: F401

import numpy as np


class Mat(np.ndarray):
    """ndarray subclass carrying the wrap_channels attribute used by
    the bindings to disambiguate (H,W,C) vs n-dim arrays."""

    def __new__(cls, arr, wrap_channels=False, **kwargs):
        obj = arr.view(Mat)
        obj.wrap_channels = wrap_channels
        return obj

    def __array_finalize__(self, obj):
        if obj is None:
            return
        self.wrap_channels = getattr(obj, "wrap_channels", False)
