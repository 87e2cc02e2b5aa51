"""features2d of the port: the KeyPoint API, GFTTDetector, FAST, ORB and
BFMatcher (twin of ``opencv_tpu/features2d``; the other detectors and
matchers are not ported yet, ROADMAP.md queue A)."""

from .keypoint import (  # noqa: F401
    KeyPoint, KeyPoint_convert, KeyPoint_overlap, retain_best, run_by_image_border,
)
from .gftt import GFTTDetector, GFTTDetector_create  # noqa: F401
from .fast import FAST, FastFeatureDetector, FastFeatureDetector_create  # noqa: F401
from .orb import ORB, ORB_create  # noqa: F401
from .matchers import BFMatcher, DMatch, hamming_distance_matrix  # noqa: F401
