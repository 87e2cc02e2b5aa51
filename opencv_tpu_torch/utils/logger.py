"""Leveled tag-based logging (core/include/opencv2/core/utils/logger.hpp,
core/src/logger.cpp); twin of ``opencv_tpu/utils/logger.py``, with the
same environment variables.

Levels and env control mirror the reference: OPENCV_TPU_LOG_LEVEL accepts
the same names (SILENT/FATAL/ERROR/WARNING/INFO/DEBUG/VERBOSE) or numbers.
Per-tag levels (the LogTagManager, core/src/utils/logtagmanager.cpp)
parse from the same variable: ``OPENCV_TPU_LOG_LEVEL=INFO,imgproc:DEBUG``
sets the global level to INFO and the ``imgproc`` tag to DEBUG; tags
match on the full name or a dotted prefix (``a.b`` matches tag
``a.b.c``).
"""

from __future__ import annotations

import os
import sys
import time

LOG_LEVEL_SILENT = 0
LOG_LEVEL_FATAL = 1
LOG_LEVEL_ERROR = 2
LOG_LEVEL_WARNING = 3
LOG_LEVEL_INFO = 4
LOG_LEVEL_DEBUG = 5
LOG_LEVEL_VERBOSE = 6

_NAMES = {"SILENT": 0, "FATAL": 1, "ERROR": 2, "WARNING": 3, "WARN": 3,
          "INFO": 4, "DEBUG": 5, "VERBOSE": 6}
_LEVEL_TAG = {1: "F", 2: "E", 3: "W", 4: "I", 5: "D", 6: "V"}


def _parse_level(v: str, default: int = LOG_LEVEL_WARNING) -> int:
    v = v.strip().upper()
    if v.isdigit():
        return int(v)
    return _NAMES.get(v, default)


def _initial_levels():
    """Global level + per-tag overrides from the env, reference syntax:
    ``LEVEL`` or ``LEVEL,tag1:LEVEL,tag2:LEVEL`` (logtagmanager.cpp)."""
    raw = os.environ.get("OPENCV_TPU_LOG_LEVEL",
                         os.environ.get("OPENCV_LOG_LEVEL", "WARNING"))
    glob = LOG_LEVEL_WARNING
    tags: dict[str, int] = {}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            tag, _, lv = part.rpartition(":")
            tags[tag.strip()] = _parse_level(lv)
        else:
            glob = _parse_level(part)
    return glob, tags


_level, _tag_levels = _initial_levels()


def setLogLevel(level: int) -> int:
    global _level
    prev = _level
    _level = level
    return prev


def getLogLevel() -> int:
    return _level


def setLogTagLevel(tag: str, level: int) -> None:
    _tag_levels[tag] = level


def getLogTagLevel(tag: str) -> int:
    """Effective level for a tag: exact match, then longest dotted-prefix
    match, then the global level."""
    if tag in _tag_levels:
        return _tag_levels[tag]
    parts = tag.split(".")
    for i in range(len(parts) - 1, 0, -1):
        p = ".".join(parts[:i])
        if p in _tag_levels:
            return _tag_levels[p]
    return _level


def log(level: int, msg: str, tag: str = "global"):
    if 0 < level <= getLogTagLevel(tag):
        ts = time.strftime("%H:%M:%S")
        print(f"[{_LEVEL_TAG.get(level, '?')} {ts} {tag}] {msg}",
              file=sys.stderr)
