"""photo of the port: NL-means and TV-L1 denoising, HDR (Mertens,
Debevec, Robertson, the tonemappers, AlignMTB), inpainting, the
domain-transform filters, Poisson cloning and decolor (twin of
``opencv_tpu/photo``)."""

from .denoise import (  # noqa: F401
    fastNlMeansDenoising, fastNlMeansDenoisingColored,
    fastNlMeansDenoisingMulti, fastNlMeansDenoisingColoredMulti, denoise_TVL1,
)
from .hdr import (  # noqa: F401
    createMergeMertens, MergeMertens,
    createMergeDebevec, MergeDebevec,
    createCalibrateDebevec, CalibrateDebevec,
    createTonemap, Tonemap,
    createTonemapDrago, TonemapDrago,
    createTonemapReinhard, TonemapReinhard,
    createAlignMTB, AlignMTB,
    createMergeRobertson, MergeRobertson,
    createCalibrateRobertson, CalibrateRobertson,
    createTonemapMantiuk, TonemapMantiuk,
)
from .inpaint import inpaint, INPAINT_NS, INPAINT_TELEA  # noqa: F401
from .npr import (  # noqa: F401
    edgePreservingFilter, detailEnhance, stylization, pencilSketch,
    RECURS_FILTER, NORMCONV_FILTER,
)
from .cloning import (  # noqa: F401
    seamlessClone, colorChange, illuminationChange, textureFlattening,
    NORMAL_CLONE, MIXED_CLONE, MONOCHROME_TRANSFER,
)
from .decolor import decolor  # noqa: F401
