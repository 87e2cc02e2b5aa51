"""opencv_tpu_torch — the PyTorch/CUDA port of ``opencv_tpu``.

The same cv2-style API, enum values and batched NHWC layout as the JAX
package, over torch tensors.  A result lives on its input's device: CUDA
tensors run the hand-written Hopper kernels in ``csrc/`` where the JAX
package has a Pallas kernel, and plain PyTorch elsewhere; CPU tensors run
plain PyTorch throughout.  This package imports neither jax nor
``opencv_tpu``.

Ported so far: the flagship preprocess path (cvtColor to gray,
GaussianBlur, resize, warpAffine), the fused gray+blur+downsample entry,
the pyramid/corner/edge path of BASELINE config 3 (pyrDown, cornerHarris,
Sobel, Canny) with the filter, derivative, pyramid and corner families
around it, and BASELINE config 4 (matchTemplate, erode, dilate,
morphologyEx) with goodFeaturesToTrack, GFTTDetector and the KeyPoint API,
BASELINE config 5 (ORB, with FAST, the INTER_LINEAR_EXACT resize of
its pyramid and BFMatcher), and BASELINE config 2 with the whole of
resize and the warps (warpAffine, warpPerspective, remap, the polar warps
and the transform builders), and the decode-and-colour path: all of
cvtColor (the Bayer codes through demosaicing) and cvtColorTwoPlane,
threshold, adaptiveThreshold, thresholdWithMask, integral/2/3,
copyMakeBorder and borderInterpolate, and the enhancement path: histograms
(calcHist, equalizeHist, compareHist, calcBackProject, CLAHE), medianBlur,
bilateralFilter, stackBlur, the core array ops (arithmetic, bitwise, LUT,
normalize, reductions, the polar and math functions and the utility
surface) and applyColorMap, and the motion path: linalg, the DFT/DCT and
accumulate family, the rest of misc (phaseCorrelate, getRectSubPix,
convertMaps, blendLinear, matchShapes), moments, connectedComponents,
distanceTransform and the contour geometry, and the lane-and-sign path:
the Hough transforms (lines, circles, point sets, the generalized Hough),
fitLine, the line segment detector, drawing and putText, and the small
geometry of ``geometry_extra``, and the cell-segmentation path: floodFill,
watershed and pyrMeanShiftFiltering, grabCut with kmeans, EMD,
IntelligentScissorsMB, Subdiv2D and the colour correction model, with the
port's own native host tails (``native/hosttails.cpp``, built with g++ at
the first call; findContours' border following among them), and the
registration path: SIFT, the FLANN indexes (``flann``) and
FlannBasedMatcher, and the feature-tracking path: AGAST, BRISK, AKAZE,
KAZE, MSER (a native host tail) and SimpleBlobDetector; ``parallel``, batch and spatial sharding over
``torch.distributed``; and the top-level names ``opencv_tpu/__init__.py``
defines itself (RotatedRect, TickMeter, CV_MAKETYPE, FontFace, ...).
"""

from .constants import *  # noqa: F401,F403
from .core.borders import border_interpolate as borderInterpolate  # noqa: F401
from .core.borders import copy_make_border as copyMakeBorder  # noqa: F401
from .ops.color import cvtColor, cvtColorTwoPlane  # noqa: F401
from .ops.integral import integral, integral2, integral3  # noqa: F401
from .ops.misc import (  # noqa: F401
    CONTOURS_MATCH_I1, CONTOURS_MATCH_I2, CONTOURS_MATCH_I3, blendLinear, convertMaps,
    createHanningWindow, demosaicing, getRectSubPix, matchShapes, phaseCorrelate,
)
from .ops.thresh import adaptiveThreshold, threshold, thresholdWithMask  # noqa: F401
from .ops.filter import (  # noqa: F401
    GaussianBlur, blur, boxFilter, filter2D, getGaussianKernel, sepFilter2D, sqrBoxFilter,
)
from .ops.deriv import Laplacian, Scharr, Sobel, getDerivKernels, spatialGradient  # noqa: F401
from .ops.pyramids import buildPyramid, pyrDown, pyrUp  # noqa: F401
from .ops.morph import (  # noqa: F401
    dilate, erode, getStructuringElement, morphologyDefaultBorderValue, morphologyEx,
)
from .ops.corners import (  # noqa: F401
    cornerEigenValsAndVecs, cornerHarris, cornerMinEigenVal, goodFeaturesToTrack,
    goodFeaturesToTrackWithQuality, preCornerDetect,
)
from .ops.canny import Canny  # noqa: F401
from .ops.templmatch import matchTemplate  # noqa: F401
from .ops.resize import resize  # noqa: F401
from .ops.warp import (  # noqa: F401
    WARP_POLAR_LINEAR, WARP_POLAR_LOG, getAffineTransform, getPerspectiveTransform,
    getRotationMatrix2D, invertAffineTransform, linearPolar, logPolar, remap, warpAffine,
    warpPerspective, warpPolar,
)
from .ops.hist import (  # noqa: F401
    CLAHE, calcBackProject, calcHist, compareHist, createCLAHE, equalizeHist,
)
from .ops.smooth import bilateralFilter, medianBlur, stackBlur  # noqa: F401
from .ops.core_ops import (  # noqa: F401
    add, subtract, multiply, divide, absdiff, scaleAdd, addWeighted,
    bitwise_and, bitwise_or, bitwise_xor, bitwise_not,
    compare, inRange, LUT, convertScaleAbs, normalize,
    split, merge, flip, rotate, transpose,
    minMaxLoc, mean, meanStdDev, norm, countNonZero, sumElems,
    magnitude, phase, cartToPolar, polarToCart,
    mixChannels, setIdentity, completeSymm, solveCubic, solvePoly,
    PSNR, batchDistance,
    hconcat, vconcat, repeat, reduce, reduceArgMax, reduceArgMin,
    sort, sortIdx, findNonZero, hasNonZero, checkRange, patchNaNs,
    extractChannel, insertChannel, copyTo, gemm, calcCovarMatrix,
    divSpectrums, fastAtan2, cubeRoot, clipLine, flipND, transposeND,
    broadcast, finiteMask, solveLP, buildMST,
    REDUCE_SUM, REDUCE_AVG, REDUCE_MAX, REDUCE_MIN, REDUCE_SUM2,
    SORT_EVERY_ROW, SORT_EVERY_COLUMN, SORT_ASCENDING, SORT_DESCENDING,
    GEMM_1_T, GEMM_2_T, GEMM_3_T,
    COVAR_SCRAMBLED, COVAR_NORMAL, COVAR_USE_AVG, COVAR_SCALE,
    COVAR_ROWS, COVAR_COLS,
)
from .ops import core_ops as _core_ops
min = _core_ops.min  # noqa: A001 — cv2-compatible names
max = _core_ops.max  # noqa: A001
exp = _core_ops.exp
log = _core_ops.log
sqrt = _core_ops.sqrt
pow = _core_ops.pow  # noqa: A001
from .ops.colormap import applyColorMap  # noqa: F401,E402
from .features2d import (  # noqa: F401
    BFMatcher, DMatch, DescriptorMatcher_create, FastFeatureDetector, FastFeatureDetector_create,
    FlannBasedMatcher, FlannBasedMatcher_create, GFTTDetector, GFTTDetector_create, KeyPoint,
    KeyPoint_convert, KeyPoint_overlap, ORB, ORB_create, SIFT, SIFT_create,
    AGAST, AgastFeatureDetector, AgastFeatureDetector_create, BRISK, BRISK_create, AKAZE,
    AKAZE_create, KAZE, KAZE_create, MSER, MSER_create, SimpleBlobDetector,
    SimpleBlobDetector_create, SimpleBlobDetector_Params,
    AKAZE_DESCRIPTOR_KAZE_UPRIGHT, AKAZE_DESCRIPTOR_KAZE, AKAZE_DESCRIPTOR_MLDB_UPRIGHT,
    AKAZE_DESCRIPTOR_MLDB, KAZE_DIFF_PM_G1, KAZE_DIFF_PM_G2, KAZE_DIFF_WEICKERT,
    KAZE_DIFF_CHARBONNIER,
)
from . import flann  # noqa: F401,E402
from . import parallel  # noqa: F401,E402
from .flann import Index as flann_Index  # noqa: F401,E402
from .features2d.fast import FAST as FastFeatureDetector_detect  # noqa: F401

from .ops.contours import (  # noqa: F401,E402
    findContours, contourArea, arcLength, boundingRect, minAreaRect,
    boxPoints, convexHull, convexityDefects, approxPolyDP,
    isContourConvex,
    pointPolygonTest, minEnclosingCircle, fitEllipse, fitEllipseAMS,
    fitEllipseDirect, approxPolyN, HuMoments,
    rotatedRectangleIntersection, intersectConvexConvex,
    minEnclosingTriangle, INTERSECT_NONE, INTERSECT_PARTIAL,
    INTERSECT_FULL,
)
from .ops.transform import (  # noqa: F401,E402
    dft, idft, dct, idct, mulSpectrums, getOptimalDFTSize, getGaborKernel,
    accumulate, accumulateSquare, accumulateProduct, accumulateWeighted,
    DFT_INVERSE, DFT_SCALE, DFT_ROWS, DFT_COMPLEX_OUTPUT, DFT_REAL_OUTPUT,
    DFT_COMPLEX_INPUT, DCT_INVERSE, DCT_ROWS,
)
from .ops.shape import (  # noqa: F401,E402
    moments,
    connectedComponents,
    connectedComponentsWithStats,
    connectedComponentsWithAlgorithm,
    connectedComponentsWithStatsWithAlgorithm,
    distanceTransform,
    distanceTransformWithLabels,
)
from .ops.linalg import (  # noqa: F401,E402
    solve, SVDecomp, SVBackSubst, eigen, eigenNonSymmetric,
    PCACompute, PCACompute2, PCAProject, PCABackProject,
    Mahalanobis, mulTransposed, transform, invert, determinant, trace,
    setRNGSeed, theRNG, randu, randn, randShuffle, RNG,
    SVD_MODIFY_A, SVD_NO_UV, SVD_FULL_UV,
)

from .ops.drawing import (  # noqa: F401,E402
    line, rectangle, circle, ellipse, ellipse2Poly, polylines, fillPoly,
    fillConvexPoly, drawContours, drawMarker, arrowedLine,
    drawKeypoints, drawMatches, drawMatchesKnn,
    putText, getTextSize, getFontScaleFromHeight,
)
from .ops.hough import (  # noqa: F401,E402
    HoughLines, HoughLinesP, HoughCircles, HoughLinesPointSet,
    HoughLinesWithAccumulator, HoughCirclesWithAccumulator,
    GeneralizedHoughBallard, createGeneralizedHoughBallard,
    GeneralizedHoughGuil, createGeneralizedHoughGuil,
)
from .ops.linefit import fitLine  # noqa: F401,E402
from .ops.lsd import (  # noqa: F401,E402
    createLineSegmentDetector, LineSegmentDetector,
    LSD_REFINE_NONE, LSD_REFINE_STD, LSD_REFINE_ADV,
)
from .ops.geometry_extra import (  # noqa: F401,E402
    rectangleIntersectionArea, getClosestEllipsePoints,
    phaseCorrelateIterative, filter2Dp, findContoursLinkRuns,
)
from .ops.segmentation import (  # noqa: F401,E402
    floodFill, watershed, pyrMeanShiftFiltering, FLOODFILL_FIXED_RANGE, FLOODFILL_MASK_ONLY,
)
from .ops.emd import EMD  # noqa: F401,E402
from .ops.grabcut import (  # noqa: F401,E402
    grabCut, GC_BGD, GC_FGD, GC_PR_BGD, GC_PR_FGD,
    GC_INIT_WITH_RECT, GC_INIT_WITH_MASK, GC_EVAL,
)
from .ops.subdiv2d import Subdiv2D  # noqa: F401,E402
from .ops.cluster import (  # noqa: F401,E402
    kmeans, KMEANS_RANDOM_CENTERS, KMEANS_PP_CENTERS, KMEANS_USE_INITIAL_LABELS,
)
from .ops.scissors import IntelligentScissorsMB  # noqa: F401,E402
from .ops.ccm import ColorCorrectionModel as ccm_ColorCorrectionModel, ccm  # noqa: F401,E402

segmentation_IntelligentScissorsMB = IntelligentScissorsMB


class _SegmentationNS:
    IntelligentScissorsMB = IntelligentScissorsMB


segmentation = _SegmentationNS()

# fused fast path (no cv2 equivalent): gray + blur + 2x area in one kernel
from .kernels import fused_gray_gauss5_down2 as fusedPreprocessGrayBlurDown2  # noqa: F401

# ---------------------------------------------------------------------------
# Top-level names that ``opencv_tpu/__init__.py`` defines itself
# ---------------------------------------------------------------------------

import time as _time  # noqa: E402

DescriptorMatcher = BFMatcher

_TICK_FREQ = 1_000_000_000


def getTickCount() -> int:
    return _time.perf_counter_ns()


def getTickFrequency() -> float:
    return float(_TICK_FREQ)


class Algorithm:
    """cv::Algorithm base — state save/load surface."""

    def clear(self):
        pass

    def empty(self):
        return False

    def save(self, filename):
        pass

    def getDefaultName(self):
        return type(self).__name__


class TickMeter:
    """cv::TickMeter (core/utility.hpp)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = None
        self._total = 0
        self._count = 0

    def start(self):
        self._t0 = getTickCount()

    def stop(self):
        if self._t0 is not None:
            self._total += getTickCount() - self._t0
            self._count += 1
            self._t0 = None

    def getTimeTicks(self):
        return self._total

    def getTimeSec(self):
        return self._total / getTickFrequency()

    def getTimeMilli(self):
        return self.getTimeSec() * 1e3

    def getTimeMicro(self):
        return self.getTimeSec() * 1e6

    def getCounter(self):
        return self._count

    def getAvgTimeSec(self):
        return self.getTimeSec() / self._count if self._count else 0.0

    def getAvgTimeMilli(self):
        return self.getAvgTimeSec() * 1e3

    def getFPS(self):
        s = self.getTimeSec()
        return self._count / s if s > 0 else 0.0


class RotatedRect:
    """cv::RotatedRect — (center, size, angle) with points() and
    boundingRect() like the binding."""

    def __init__(self, center=(0.0, 0.0), size=(0.0, 0.0), angle=0.0):
        self.center = tuple(map(float, center))
        self.size = tuple(map(float, size))
        self.angle = float(angle)

    def points(self):
        return boxPoints((self.center, self.size, self.angle))

    def boundingRect(self):
        import numpy as _np
        p = _np.asarray(self.points())
        x0, y0 = _np.floor(p.min(0)).astype(int)
        x1, y1 = _np.ceil(p.max(0)).astype(int)
        return (int(x0), int(y0), int(x1 - x0 + 1), int(y1 - y0 + 1))


class MSTEdge:
    """cv::MSTEdge (source, target, weight)."""

    def __init__(self, source=0, target=0, weight=0.0):
        self.source, self.target, self.weight = source, target, weight


class GeneralizedHough(GeneralizedHoughBallard):
    """Base alias — the reference's abstract GHT interface."""


Feature2D = type("Feature2D", (), {
    "detect": lambda self, *a, **k: [],
    "compute": lambda self, *a, **k: ([], None),
    "detectAndCompute": lambda self, *a, **k: ([], None),
    "empty": lambda self: True,
    "__doc__": "cv::Feature2D abstract base (features2d.hpp)",
})


class FontFace:
    """cv::FontFace — named font handle; text rendering (putText) uses the
    built-in Hershey engine regardless of the requested face."""

    def __init__(self, name: str = "sans"):
        self._name = name

    def getName(self):
        return self._name

    def setInstance(self, params):
        return False

    def getInstance(self):
        return None


# CV_MAKETYPE family (5.x type system: depth in the low 5 bits, channels-1
# shifted by 5 — core/include/opencv2/core/hal/interface.h)
_CV_CN_SHIFT = 5
_CV_DEPTH_MAX = 1 << _CV_CN_SHIFT


def CV_MAKETYPE(depth, cn):
    return (depth & (_CV_DEPTH_MAX - 1)) + ((cn - 1) << _CV_CN_SHIFT)


CV_MAKE_TYPE = CV_MAKETYPE


def _make_typec(depth):
    def typec(cn):
        return CV_MAKETYPE(depth, cn)
    return typec


CV_8UC = _make_typec(0)
CV_8SC = _make_typec(1)
CV_16UC = _make_typec(2)
CV_16SC = _make_typec(3)
CV_32SC = _make_typec(4)
CV_32FC = _make_typec(5)
CV_64FC = _make_typec(6)
CV_16FC = _make_typec(7)
CV_16BFC = _make_typec(8)
CV_BoolC = _make_typec(9)
CV_64UC = _make_typec(10)
CV_64SC = _make_typec(11)
CV_32UC = _make_typec(12)


def BFMatcher_create(normType=4, crossCheck=False):
    return BFMatcher.create(normType, crossCheck)
