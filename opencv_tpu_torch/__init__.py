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
``torch.distributed``; the video module; and the photo-finishing path: the
photo module (NL-means and TV-L1, HDR alignment, merging and tonemapping,
inpaint, the domain-transform filters, Poisson cloning, decolor) and
``utils`` (logging, configuration, tracing, the system surface); and the
stereo-depth path: calib3d (chessboards, calibrateCamera and
stereoCalibrate, stereoRectify and the rectification maps, StereoBM and
StereoSGBM, filterSpeckles (a native host tail), USAC, PnP, fisheye,
hand-eye, multiview); and the top-level names ``opencv_tpu/__init__.py``
defines itself (RotatedRect, TickMeter, CV_MAKETYPE, FontFace,
ECCParameters, FarnebackOpticalFlow, AsyncArray, ANNIndex, ...); and dnn (the
ONNX executor, the Darknet, Caffe, TensorFlow and TFLite readers over the
port's own protobuf codec, NMS, the Model classes) and ml.
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

from .features2d import (  # noqa: F401,E402
    BOWKMeansTrainer, BOWImgDescriptorExtractor, AffineFeature, AffineFeature_create,
    evaluateFeatureDetector, computeRecallPrecisionCurve, getRecall, getNearestPoint,
)
from . import video  # noqa: F401,E402
from .video import (  # noqa: F401,E402
    BackgroundSubtractorMOG2, createBackgroundSubtractorMOG2, BackgroundSubtractorKNN,
    createBackgroundSubtractorKNN, calcOpticalFlowPyrLK, SparsePyrLKOpticalFlow,
    SparsePyrLKOpticalFlow_create, buildOpticalFlowPyramid, readOpticalFlow, writeOpticalFlow,
    calcOpticalFlowFarneback, FarnebackOpticalFlow_create, KalmanFilter, meanShift, CamShift,
    findTransformECC, computeECC, findTransformECCWithMask, findTransformECCMultiScale,
    MOTION_TRANSLATION, MOTION_EUCLIDEAN, MOTION_AFFINE, MOTION_HOMOGRAPHY, DISOpticalFlow,
    DISOpticalFlow_create, TrackerMIL, TrackerMIL_create, VariationalRefinement,
    VariationalRefinement_create,
)

# the binding's base-class aliases of the video module
BackgroundSubtractor = BackgroundSubtractorMOG2
SparseOpticalFlow = SparsePyrLKOpticalFlow
DenseOpticalFlow = DISOpticalFlow

from . import photo  # noqa: F401,E402
from .photo import (  # noqa: F401,E402
    fastNlMeansDenoising, fastNlMeansDenoisingColored, fastNlMeansDenoisingMulti,
    fastNlMeansDenoisingColoredMulti, denoise_TVL1, inpaint, INPAINT_NS, INPAINT_TELEA,
    createMergeMertens, MergeMertens, createMergeDebevec, MergeDebevec,
    createCalibrateDebevec, CalibrateDebevec, createTonemap, Tonemap, createTonemapDrago,
    TonemapDrago, createTonemapReinhard, TonemapReinhard, createAlignMTB, AlignMTB,
    createMergeRobertson, MergeRobertson, createCalibrateRobertson, CalibrateRobertson,
    createTonemapMantiuk, TonemapMantiuk,
    edgePreservingFilter, detailEnhance, stylization, pencilSketch, RECURS_FILTER,
    NORMCONV_FILTER, seamlessClone, colorChange, illuminationChange, textureFlattening,
    NORMAL_CLONE, MIXED_CLONE, MONOCHROME_TRANSFER, decolor,
)

# the binding's base-class aliases of the photo module's HDR classes
AlignExposures = AlignMTB
MergeExposures = MergeMertens
CalibrateCRF = CalibrateDebevec

from . import utils  # noqa: F401,E402
from .utils.system import (  # noqa: F401,E402
    getCPUTickCount, getNumThreads, setNumThreads, getThreadNum, getNumberOfCPUs,
    useOptimized, setUseOptimized, checkHardwareSupport, getHardwareFeatureName,
    getCPUFeaturesLine, getVersionMajor, getVersionMinor, getVersionRevision,
    getVersionString, getBuildInformation, redirectError, getDefaultAlgorithmHint, bootstrap,
    VideoCapture_waitAny,
)

from . import calib3d  # noqa: F401,E402
from .calib3d import (  # noqa: F401,E402
    Rodrigues, projectPoints, undistortPoints, initUndistortRectifyMap, undistort,
    findHomography, findFundamentalMat, solvePnP, triangulatePoints, computeCorrespondEpilines,
    perspectiveTransform, getOptimalNewCameraMatrix, RANSAC, LMEDS, FM_8POINT, FM_RANSAC,
    SOLVEPNP_ITERATIVE, USAC_DEFAULT, USAC_PARALLEL, USAC_FM_8PTS, USAC_FAST, USAC_ACCURATE,
    USAC_PROSAC, USAC_MAGSAC, SOLVEPNP_EPNP, SOLVEPNP_P3P, SOLVEPNP_AP3P, SOLVEPNP_IPPE,
    SOLVEPNP_IPPE_SQUARE, SOLVEPNP_SQPNP, SOLVEPNP_MAX_COUNT,
    StereoBM, StereoBM_create, StereoSGBM, StereoSGBM_create,
    estimateAffine2D, estimateAffinePartial2D, stereoRectify,
    findEssentialMat, recoverPose, decomposeHomographyMat, solvePnPRansac, solveP3P,
    fisheye, UsacParams,
    calibrateCamera, calibrateCameraRO, stereoCalibrate, findChessboardCorners,
    drawChessboardCorners, cornerSubPix, CALIB_CB_ADAPTIVE_THRESH, CALIB_CB_NORMALIZE_IMAGE,
    CALIB_CB_FAST_CHECK, findChessboardCornersSB, CALIB_CB_EXHAUSTIVE, CALIB_CB_ACCURACY,
    CALIB_CB_LARGER, CALIB_CB_MARKER,
    calibrateHandEye, calibrateRobotWorldHandEye,
    CALIB_HAND_EYE_TSAI, CALIB_HAND_EYE_PARK, CALIB_HAND_EYE_HORAUD,
    CALIB_HAND_EYE_ANDREFF, CALIB_HAND_EYE_DANIILIDIS,
    CALIB_ROBOT_WORLD_HAND_EYE_SHAH, CALIB_ROBOT_WORLD_HAND_EYE_LI,
)
from .calib3d.geometry import (  # noqa: F401,E402
    estimateTranslation2D, undistortImagePoints, convertPointsToHomogeneous,
    convertPointsFromHomogeneous, sampsonDistance, estimateAffine3D, estimateTranslation3D,
)
from .calib3d.misc3d import (  # noqa: F401,E402
    composeRT, decomposeEssentialMat, decomposeProjectionMatrix,
    calibrationMatrixValues, drawFrameAxes, correctMatches,
    getDefaultNewCameraMatrix, filterSpeckles, validateDisparity,
    getValidDisparityROI, reprojectImageTo3D,
    stereoRectifyUncalibrated, matMulDeriv, RQDecomp3x3,
)
from .calib3d.extended import (  # noqa: F401,E402
    solvePnPGeneric, solvePnPRefineLM, solvePnPRefineVVS,
    initCameraMatrix2D, calibrateCameraExtended, stereoCalibrateExtended,
    filterHomographyDecompByVisibleRefpoints, checkChessboard,
    find4QuadCornerSubpix, initInverseRectificationMap,
    projectPointsSepJ, findChessboardCornersSBWithMeta,
    calibrateCameraROExtended,
)
from .calib3d.multiview import (  # noqa: F401,E402
    registerCameras, registerCamerasExtended, calibrateMultiview,
    calibrateMultiviewExtended, correctChromaticAberration,
    loadChromaticAberrationParams, findPlanes,
    minEnclosingConvexPolygon,
)
from .calib3d.circlesgrid import (  # noqa: F401,E402
    findCirclesGrid, estimateChessboardSharpness,
    CALIB_CB_SYMMETRIC_GRID, CALIB_CB_ASYMMETRIC_GRID,
    CALIB_CB_CLUSTERING,
)

# the binding's base-class alias of the stereo matchers
StereoMatcher = StereoBM

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


class CirclesGridFinderParameters:
    """findCirclesGrid's parameter struct (calib3d.hpp)."""

    def __init__(self):
        self.densityNeighborhoodSize = (16, 16)
        self.minDensity = 10.0
        self.kmeansAttempts = 100
        self.minDistanceToAddKeypoint = 20
        self.keypointScale = 1
        self.minGraphConfidence = 9.0
        self.vertexGain = 1.0
        self.vertexPenalty = -0.6
        self.existingVertexGain = 10000.0
        self.edgeGain = 1.0
        self.edgePenalty = -0.6
        self.convexHullFactor = 1.1
        self.minRNGEdgeSwitchDist = 5.0


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


class ECCParameters:
    """Parameter struct for findTransformECCMultiScale."""

    def __init__(self, motionType=2, numLevels=3, maxCount=50,
                 epsilon=0.001, gaussFiltSize=5):
        self.motionType = motionType
        self.numLevels = numLevels
        self.maxCount = maxCount
        self.epsilon = epsilon
        self.gaussFiltSize = gaussFiltSize


Tracker = type("Tracker", (), {
    "init": lambda self, *a, **k: None,
    "update": lambda self, *a, **k: (False, (0, 0, 0, 0)),
    "__doc__": "cv::Tracker abstract base (tracking.hpp)",
})
FarnebackOpticalFlow = type("FarnebackOpticalFlow", (), {
    "calc": staticmethod(lambda prev, nxt, flow=None, **k:
                         calcOpticalFlowFarneback(
                             prev, nxt, flow, 0.5, 3, 15, 3, 5, 1.2, 0)),
    "__doc__": "Algorithm wrapper over calcOpticalFlowFarneback",
})


class TrackerMIL_Params:
    def __init__(self):
        self.samplerInitInRadius = 3.0
        self.samplerInitMaxNegNum = 65
        self.samplerSearchWinSize = 25.0
        self.samplerTrackInRadius = 4.0
        self.samplerTrackMaxPosNum = 100000
        self.samplerTrackMaxNegNum = 65
        self.featureSetNumFeatures = 250


class AsyncArray:
    """cv::AsyncArray — results here are always ready (synchronous)."""

    def __init__(self, value=None):
        self._v = value

    def get(self, timeoutNs=None):
        return self._v

    def wait_for(self, timeoutNs):
        return True

    def valid(self):
        return self._v is not None

    def release(self):
        self._v = None


class ANNIndex:
    """Approximate NN index (the wheel's Annoy-backed cv::ANNIndex) —
    backed by brute-force exact search (exact results are a valid ANN
    answer; the distance definitions match Annoy's)."""

    DIST_EUCLIDEAN = 0
    DIST_MANHATTAN = 1
    DIST_ANGULAR = 2
    DIST_HAMMING = 3
    DIST_DOTPRODUCT = 4

    def __init__(self, dim=None, distType=0):
        self._dim = dim
        self._dist = distType
        self._rows = []
        self._data = None
        self._trees = 0
        self._seed = None

    @classmethod
    def create(cls, dim, distType=0):
        return cls(dim, distType)

    def addItems(self, features):
        import numpy as _np
        a = _np.asarray(features, _np.float32)
        a = a.reshape(-1, self._dim) if self._dim else _np.atleast_2d(a)
        self._rows.append(a)
        self._data = None

    # pre-5.x spellings kept for compatibility
    addIndex = addItems

    def build(self, trees: int = -1):
        import numpy as _np
        if self._rows:
            self._data = _np.concatenate(self._rows, axis=0)
        self._trees = trees if trees > 0 else 4

    def getItemNumber(self):
        if self._data is not None:
            return int(self._data.shape[0])
        return int(sum(r.shape[0] for r in self._rows))

    def getTreeNumber(self):
        return int(self._trees)

    def setOnDiskBuild(self, filename):
        self._disk = str(filename)
        return True

    def setSeed(self, seed):
        self._seed = int(seed)

    def save(self, filename, *a):
        import numpy as _np
        self.build(self._trees or -1)
        _np.savez(str(filename), data=self._data,
                  dist=self._dist, dim=self._dim or 0)
        return True

    def load(self, filename, *a):
        import numpy as _np
        z = _np.load(str(filename) if str(filename).endswith(".npz")
                     else str(filename) + ".npz")
        self._data = z["data"]
        self._dist = int(z["dist"])
        self._dim = int(z["dim"]) or None
        self._rows = []
        return True

    def knnSearch(self, query, knn: int):
        import numpy as _np
        if self._data is None:
            self.build(self._trees or -1)
        base = self._data
        q = _np.asarray(query, _np.float32).reshape(-1, base.shape[1])
        t = self._dist
        if t == self.DIST_MANHATTAN:
            d = _np.abs(q[:, None, :] - base[None]).sum(-1)
        elif t == self.DIST_ANGULAR:
            qn = q / _np.maximum(_np.linalg.norm(q, axis=1,
                                                 keepdims=True), 1e-12)
            bn = base / _np.maximum(_np.linalg.norm(base, axis=1,
                                                    keepdims=True), 1e-12)
            # annoy angular distance = sqrt(2 - 2cos)
            d = _np.sqrt(_np.maximum(2.0 - 2.0 * (qn @ bn.T), 0.0))
        elif t == self.DIST_HAMMING:
            d = (q[:, None, :] != base[None]).sum(-1).astype(_np.float32)
        elif t == self.DIST_DOTPRODUCT:
            d = -(q @ base.T)   # larger dot = closer
        else:  # euclidean
            d = _np.sqrt(((q[:, None, :] - base[None]) ** 2).sum(-1))
        idx = _np.argsort(d, axis=1, kind="stable")[:, :knn]
        dist = _np.take_along_axis(d, idx, 1)
        if t == self.DIST_DOTPRODUCT:
            dist = -dist        # report the dot product itself
        return idx.astype(_np.int32), dist.astype(_np.float32)


def ANNIndex_create(dim, distType=0):
    """cv2.ANNIndex_create binding alias (gen2.py static-factory
    convention, modules/python/src2/gen2.py:1331)."""
    return ANNIndex.create(dim, distType)


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


# ---------------------------------------------------------------------------
# dnn and ml, and the binding's flattened dnn names
# ---------------------------------------------------------------------------

from . import dnn  # noqa: F401,E402
from . import ml  # noqa: F401,E402
from .dnn import dnn_registerLayer, dnn_unregisterLayer  # noqa: F401,E402
from .dnn.models import TextDetectionModel as dnn_TextDetectionModel  # noqa: F401,E402

dnn_Net = dnn.Net
dnn_Model = dnn.Model
dnn_ClassificationModel = dnn.ClassificationModel
dnn_DetectionModel = dnn.DetectionModel
dnn_SegmentationModel = dnn.SegmentationModel
dnn_KeypointsModel = dnn.KeypointsModel
dnn_TextDetectionModel_DB = dnn.TextDetectionModel_DB
dnn_TextDetectionModel_EAST = dnn.TextDetectionModel_EAST
dnn_TextRecognitionModel = dnn.TextRecognitionModel
dnn_DictValue = dnn.DictValue
dnn_Layer = dnn.Layer
dnn_Tokenizer = dnn.Tokenizer
dnn_Image2BlobParams = dnn.Image2BlobParams


# ---------------------------------------------------------------------------
# the DNN trackers and features, LightGlue, G-API, the blenders and stitching
# ---------------------------------------------------------------------------

from .video import (  # noqa: F401,E402
    TrackerNano, TrackerNano_create, TrackerDaSiamRPN, TrackerDaSiamRPN_create, TrackerGOTURN,
    TrackerGOTURN_create, TrackerVit, TrackerVit_create,
)
from .features2d import (  # noqa: F401,E402
    ALIKED, ALIKED_Params, DISK, LightGlueMatcher, LightGlueMatcher_create,
    LightGlueMatcher_createFromMemory,
)


class TrackerDaSiamRPN_Params:
    def __init__(self):
        self.model = ""
        self.kernel_cls1 = ""
        self.kernel_r1 = ""
        self.backend = 0
        self.target = 0


class TrackerNano_Params:
    def __init__(self):
        self.backbone = ""
        self.neckhead = ""
        self.backend = 0
        self.target = 0


class TrackerVit_Params:
    def __init__(self):
        self.net = ""
        self.meanvalue = (0.485, 0.456, 0.406)
        self.stdvalue = (0.229, 0.224, 0.225)
        self.backend = 0
        self.target = 0
        self.tracking_score_threshold = 0.0


def ALIKED_create(modelPath="", params=None, device=None):
    return ALIKED.create(modelPath, params, device)


def DISK_create(modelPath="", maxKeypoints=1024, scoreThreshold=0.0,
                imageSize=(1024, 1024), backendId=0, targetId=0, device=None):
    return DISK.create(modelPath, maxKeypoints, scoreThreshold, imageSize, backendId, targetId,
                       device)


def DISK_createFromMemory(bufferModel, maxKeypoints=1024, scoreThreshold=0.0,
                          imageSize=(1024, 1024), backendId=0, targetId=0, device=None):
    return DISK.createFromMemory(bufferModel, maxKeypoints, scoreThreshold, imageSize, backendId,
                                 targetId, device)


from . import gapi  # noqa: F401,E402
from .gapi import pipeline, Stream  # noqa: F401,E402
from . import blenders, stitching, stitch_warpers  # noqa: F401,E402
from .stitching import Stitcher, Stitcher_create  # noqa: F401,E402
from .blenders import MultiBandBlender, FeatherBlender  # noqa: F401,E402
from .stitch_warpers import PyRotationWarper  # noqa: F401,E402
from . import stitch_detail as detail  # noqa: E402

detail_GainCompensator = detail.GainCompensator
detail_ChannelsCompensator = detail.ChannelsCompensator
detail_BlocksGainCompensator = detail.BlocksGainCompensator
detail_VoronoiSeamFinder = detail.VoronoiSeamFinder
detail_GraphCutSeamFinder = detail.GraphCutSeamFinder
detail_DpSeamFinder = detail.DpSeamFinder
detail_BestOf2NearestMatcher = detail.BestOf2NearestMatcher
detail_HomographyBasedEstimator = detail.HomographyBasedEstimator
detail_BundleAdjusterRay = detail.BundleAdjusterRay
detail_BundleAdjusterReproj = detail.BundleAdjusterReproj
detail_CameraParams = detail.CameraParams
detail_ImageFeatures = detail.ImageFeatures
detail_MatchesInfo = detail.MatchesInfo
# the binding's base-class and variant names, as the JAX package maps them
detail_FeaturesMatcher = detail.BestOf2NearestMatcher
detail_AffineBestOf2NearestMatcher = detail.BestOf2NearestMatcher
detail_BestOf2NearestRangeMatcher = detail.BestOf2NearestMatcher
detail_Estimator = detail.HomographyBasedEstimator
detail_AffineBasedEstimator = detail.HomographyBasedEstimator
detail_BundleAdjusterBase = detail._BundleBase
detail_BundleAdjusterAffine = detail.BundleAdjusterRay
detail_BundleAdjusterAffinePartial = detail.BundleAdjusterReproj
detail_ExposureCompensator = detail.GainCompensator
detail_BlocksChannelsCompensator = detail.ChannelsCompensator
detail_BlocksCompensator = detail.BlocksGainCompensator
detail_SeamFinder = detail.VoronoiSeamFinder
detail_PairwiseSeamFinder = detail.VoronoiSeamFinder
detail_NoSeamFinder = detail.DpSeamFinder
detail_Blender = FeatherBlender
detail_FeatherBlender = FeatherBlender
detail_MultiBandBlender = MultiBandBlender
detail_ProjectorBase = stitch_warpers._Projector
detail_SphericalProjector = stitch_warpers._Spherical
WarperCreator = PyRotationWarper


class detail_NoBundleAdjuster:
    """Pass-through bundle adjuster (stitching detail surface)."""

    def apply(self, features, pairwise_matches, cameras):
        return True, cameras


class detail_NoExposureCompensator:
    def feed(self, corners, images, masks):
        pass

    def apply(self, index, corner, image, mask):
        return image


class detail_Timelapser:
    """Pastes each image at its corner on one host canvas (numpy u8)."""

    AS_IS, CROP = 0, 1

    @staticmethod
    def createDefault(type):
        return detail_TimelapserCrop() if type == 1 else detail_Timelapser()

    def initialize(self, corners, sizes):
        import numpy as _np
        xs = [c[0] for c in corners]
        ys = [c[1] for c in corners]
        ws = [s[0] for s in sizes]
        hs = [s[1] for s in sizes]
        self._off = (min(xs), min(ys))
        W = max(x + w for x, w in zip(xs, ws)) - self._off[0]
        H = max(y + h for y, h in zip(ys, hs)) - self._off[1]
        self._dst = _np.zeros((H, W, 3), _np.uint8)

    def process(self, img, mask, tl):
        from .core.arrays import to_host
        a = to_host(img)
        y0 = tl[1] - self._off[1]
        x0 = tl[0] - self._off[0]
        self._dst[y0:y0 + a.shape[0], x0:x0 + a.shape[1]] = a

    def getDst(self):
        return self._dst


class detail_TimelapserCrop(detail_Timelapser):
    pass


class detail_PoseGraph:
    """Pose-graph optimization placeholder (3d module detail)."""

    def __init__(self):
        self._nodes = {}

    def addNode(self, i, pose, fixed=False):
        self._nodes[i] = pose

    def getNodePose(self, i):
        return self._nodes.get(i)


class detail_LightGlueFeaturesMatcher:
    def __init__(self, *a, **k):
        raise NotImplementedError(
            "requires the LightGlue ONNX export; use "
            "LightGlueMatcher_create")
