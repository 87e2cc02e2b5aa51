"""cv2.instr — instrumentation framework enums
(core/include/opencv2/core/utils/instrumentation.hpp)."""

FLAGS_NONE = 0
FLAGS_MAPPING = 1
FLAGS_EXPAND_SAME_NAMES = 2
IMPL_PLAIN = 0
IMPL_IPP = 1
IMPL_OPENCL = 2
TYPE_GENERAL = 0
TYPE_MARKER = 1
TYPE_WRAPPER = 2
TYPE_FUN = 3
