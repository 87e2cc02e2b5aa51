"""Hand-written CUDA kernels for Hopper (sm_90a), each with its plain
PyTorch version beside it.  Sources live in ``opencv_tpu_torch/csrc`` and
are built by :mod:`._build` at the first launch."""

from .fused_preproc import (  # noqa: F401
    GAUSS5_DOWN2, fused_gray_gauss5_down2, gauss5_down2_u8,
)
from .sepfilter import (  # noqa: F401
    PYR_DOWN, SEP_FILTER, pyr_down_u8, sep_filter_int, sep_filter_u8,
)

# every kernel of the package, for launch counts and builds
KERNELS = (SEP_FILTER, GAUSS5_DOWN2, PYR_DOWN)
