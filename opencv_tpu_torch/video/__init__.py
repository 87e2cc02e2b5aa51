"""video of the port: background subtraction (MOG2, KNN), pyramidal
Lucas-Kanade, Farnebäck, DIS and variational refinement, the flow
pyramid and .flo IO, Kalman, meanShift / CamShift, ECC, TrackerMIL and
the DNN trackers (Nano, DaSiamRPN, GOTURN, Vit) over the port's dnn (twin
of ``opencv_tpu/video``)."""

from .bgsub import (  # noqa: F401
    BackgroundSubtractorMOG2,
    createBackgroundSubtractorMOG2,
    BackgroundSubtractorKNN,
    createBackgroundSubtractorKNN,
)
from .lk import (  # noqa: F401
    calcOpticalFlowPyrLK, SparsePyrLKOpticalFlow,
    SparsePyrLKOpticalFlow_create,
)
from .flow_utils import (  # noqa: F401
    buildOpticalFlowPyramid, readOpticalFlow, writeOpticalFlow,
)
from .farneback import (  # noqa: F401
    calcOpticalFlowFarneback,
    FarnebackOpticalFlow_create,
)
from .kalman import KalmanFilter  # noqa: F401
from .meanshift import meanShift, CamShift  # noqa: F401
from .ecc import (  # noqa: F401
    findTransformECC, computeECC, findTransformECCWithMask,
    findTransformECCMultiScale,
    MOTION_TRANSLATION, MOTION_EUCLIDEAN, MOTION_AFFINE, MOTION_HOMOGRAPHY,
)
from .dis import DISOpticalFlow, DISOpticalFlow_create  # noqa: F401
from .trackers import TrackerMIL, TrackerMIL_create  # noqa: F401
from .dnn_trackers import (  # noqa: F401
    TrackerNano, TrackerNano_create,
    TrackerDaSiamRPN, TrackerDaSiamRPN_create,
    TrackerGOTURN, TrackerGOTURN_create,
    TrackerVit, TrackerVit_create,
)
from .variational import (  # noqa: F401
    VariationalRefinement, VariationalRefinement_create,
)
