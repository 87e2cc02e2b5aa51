"""calib3d of the port, twin of ``opencv_tpu/calib3d``: camera geometry,
calibration, chessboards, stereo matching, USAC, PnP, fisheye, hand-eye.

Dense image work (maps, remap, prefilters, cost volumes, aggregation,
reprojection) runs as torch on its input's device; point and matrix
algorithms are host numpy float64 as in the JAX package; filterSpeckles is
a native host tail."""

from .geometry import (  # noqa: F401
    Rodrigues,
    projectPoints,
    undistortPoints,
    initUndistortRectifyMap,
    undistort,
    findHomography,
    findFundamentalMat,
    solvePnP,
    triangulatePoints,
    computeCorrespondEpilines,
    perspectiveTransform,
    getOptimalNewCameraMatrix,
    RANSAC, LMEDS, FM_8POINT, FM_RANSAC, SOLVEPNP_ITERATIVE,
    USAC_DEFAULT, USAC_PARALLEL, USAC_FM_8PTS, USAC_FAST,
    USAC_ACCURATE, USAC_PROSAC, USAC_MAGSAC,
    SOLVEPNP_EPNP, SOLVEPNP_P3P, SOLVEPNP_AP3P, SOLVEPNP_IPPE,
    SOLVEPNP_IPPE_SQUARE, SOLVEPNP_SQPNP, SOLVEPNP_MAX_COUNT,
)
from .geometry import estimateAffine2D, estimateAffinePartial2D, stereoRectify  # noqa: F401
from .geometry import (  # noqa: F401
    findEssentialMat, recoverPose, decomposeHomographyMat, solvePnPRansac,
    solveP3P,
)
from .stereo import StereoBM, StereoBM_create, StereoSGBM, StereoSGBM_create  # noqa: F401
from .calibrate import calibrateCamera, calibrateCameraRO, stereoCalibrate  # noqa: F401
from .chessboard import (  # noqa: F401
    findChessboardCornersSB, CALIB_CB_EXHAUSTIVE, CALIB_CB_ACCURACY,
    CALIB_CB_LARGER, CALIB_CB_MARKER,
    findChessboardCorners, drawChessboardCorners, cornerSubPix,
    CALIB_CB_ADAPTIVE_THRESH, CALIB_CB_NORMALIZE_IMAGE, CALIB_CB_FAST_CHECK,
)
from . import fisheye  # noqa: F401
from .handeye import (  # noqa: F401
    calibrateHandEye, calibrateRobotWorldHandEye,
    CALIB_HAND_EYE_TSAI, CALIB_HAND_EYE_PARK, CALIB_HAND_EYE_HORAUD,
    CALIB_HAND_EYE_ANDREFF, CALIB_HAND_EYE_DANIILIDIS,
    CALIB_ROBOT_WORLD_HAND_EYE_SHAH, CALIB_ROBOT_WORLD_HAND_EYE_LI,
)
from .usac import UsacParams, ransac_solve  # noqa: F401
from . import usac  # noqa: F401
