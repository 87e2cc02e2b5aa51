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
the first call).
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
    BFMatcher, DMatch, FastFeatureDetector, FastFeatureDetector_create, GFTTDetector,
    GFTTDetector_create, KeyPoint, KeyPoint_convert, KeyPoint_overlap, ORB, ORB_create,
)
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
