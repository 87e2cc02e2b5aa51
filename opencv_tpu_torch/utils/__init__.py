"""utils of the port: logging, configuration, tracing, build information
and the system surface (twin of ``opencv_tpu/utils``)."""

from .logger import (  # noqa: F401
    LOG_LEVEL_SILENT, LOG_LEVEL_FATAL, LOG_LEVEL_ERROR, LOG_LEVEL_WARNING,
    LOG_LEVEL_INFO, LOG_LEVEL_DEBUG, LOG_LEVEL_VERBOSE,
    setLogLevel, getLogLevel, log,
)
from .config import get_config_bool, get_config_int, get_config_str  # noqa: F401
from .trace import trace_region, profile_to  # noqa: F401
from .buildinfo import getBuildInformation, setNumThreads, getNumThreads  # noqa: F401
