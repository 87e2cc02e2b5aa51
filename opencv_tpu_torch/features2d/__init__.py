"""features2d of the port: the KeyPoint API and GFTTDetector (twin of
``opencv_tpu/features2d``; ORB and the other detectors are not ported yet,
ROADMAP.md queue A)."""

from .keypoint import (  # noqa: F401
    KeyPoint, KeyPoint_convert, KeyPoint_overlap, retain_best, run_by_image_border,
)
from .gftt import GFTTDetector, GFTTDetector_create  # noqa: F401
