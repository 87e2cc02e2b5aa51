"""Runtime configuration parameters from the environment
(core/include/opencv2/core/utils/configuration.private.hpp pattern); twin of
``opencv_tpu/utils/config.py``."""

from __future__ import annotations

import os

_TRUE = {"1", "true", "on", "yes"}
_FALSE = {"0", "false", "off", "no"}


def get_config_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    v = v.strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    return default


def get_config_int(name: str, default: int = 0) -> int:
    v = os.environ.get(name)
    if v is None:
        return default
    try:
        return int(v)
    except ValueError:
        return default


def get_config_str(name: str, default: str = "") -> str:
    return os.environ.get(name, default)
