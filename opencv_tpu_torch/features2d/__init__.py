"""features2d of the port: the KeyPoint API, GFTTDetector, FAST, AGAST,
ORB, SIFT, BRISK, AKAZE, KAZE, MSER, SimpleBlobDetector, BFMatcher and
FlannBasedMatcher, BOWKMeansTrainer and BOWImgDescriptorExtractor,
AffineFeature, the detector evaluation, and the DNN features (DISK,
ALIKED) and LightGlueMatcher over the port's dnn (twin of
``opencv_tpu/features2d``)."""

from .keypoint import (  # noqa: F401
    KeyPoint, KeyPoint_convert, KeyPoint_overlap, retain_best, run_by_image_border,
)
from .gftt import GFTTDetector, GFTTDetector_create  # noqa: F401
from .fast import FAST, FastFeatureDetector, FastFeatureDetector_create  # noqa: F401
from .orb import ORB, ORB_create  # noqa: F401
from .matchers import (  # noqa: F401
    BFMatcher, DMatch, DescriptorMatcher_create, FlannBasedMatcher, FlannBasedMatcher_create,
    LightGlueMatcher, LightGlueMatcher_create, LightGlueMatcher_createFromMemory,
    hamming_distance_matrix,
)
from .sift import SIFT, SIFT_create  # noqa: F401
from .agast import AGAST, AgastFeatureDetector, AgastFeatureDetector_create  # noqa: F401
from .brisk import BRISK, BRISK_create  # noqa: F401
from .akaze import (  # noqa: F401
    AKAZE, AKAZE_create,
    DESCRIPTOR_KAZE_UPRIGHT, DESCRIPTOR_KAZE,
    DESCRIPTOR_MLDB_UPRIGHT, DESCRIPTOR_MLDB,
    DIFF_PM_G1, DIFF_PM_G2, DIFF_WEICKERT, DIFF_CHARBONNIER,
)
from .kaze import KAZE, KAZE_create  # noqa: F401
from .mser import MSER, MSER_create  # noqa: F401
from .blob import (  # noqa: F401
    SimpleBlobDetector, SimpleBlobDetector_create, SimpleBlobDetector_Params,
)
from .bow import BOWKMeansTrainer, BOWImgDescriptorExtractor  # noqa: F401
from .affine_feature import AffineFeature, AffineFeature_create  # noqa: F401
from .evaluation import (  # noqa: F401
    evaluateFeatureDetector, computeRecallPrecisionCurve, getRecall, getNearestPoint,
)
from .dl_features import ALIKED, ALIKED_Params, DISK  # noqa: F401

# cv2-style flat constant aliases
AKAZE_DESCRIPTOR_KAZE_UPRIGHT = DESCRIPTOR_KAZE_UPRIGHT
AKAZE_DESCRIPTOR_KAZE = DESCRIPTOR_KAZE
AKAZE_DESCRIPTOR_MLDB_UPRIGHT = DESCRIPTOR_MLDB_UPRIGHT
AKAZE_DESCRIPTOR_MLDB = DESCRIPTOR_MLDB
KAZE_DIFF_PM_G1 = DIFF_PM_G1
KAZE_DIFF_PM_G2 = DIFF_PM_G2
KAZE_DIFF_WEICKERT = DIFF_WEICKERT
KAZE_DIFF_CHARBONNIER = DIFF_CHARBONNIER
