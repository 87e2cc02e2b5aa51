"""features2d of the port: the KeyPoint API, GFTTDetector, FAST, ORB,
SIFT, BFMatcher and FlannBasedMatcher (twin of ``opencv_tpu/features2d``;
the other detectors are not ported yet, ROADMAP.md queue A)."""

from .keypoint import (  # noqa: F401
    KeyPoint, KeyPoint_convert, KeyPoint_overlap, retain_best, run_by_image_border,
)
from .gftt import GFTTDetector, GFTTDetector_create  # noqa: F401
from .fast import FAST, FastFeatureDetector, FastFeatureDetector_create  # noqa: F401
from .orb import ORB, ORB_create  # noqa: F401
from .matchers import (  # noqa: F401
    BFMatcher, DMatch, DescriptorMatcher_create, FlannBasedMatcher, FlannBasedMatcher_create,
    hamming_distance_matrix,
)
from .sift import SIFT, SIFT_create  # noqa: F401
