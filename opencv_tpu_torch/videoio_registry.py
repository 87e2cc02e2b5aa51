"""cv2.videoio_registry — backend registry queries
(modules/videoio/src/videoio_registry.cpp).  This build has two
built-in file backends: CAP_IMAGES (image sequences) and our native
AVI/Y4M container codec (reported under CAP_OPENCV_MJPEG, the
reference's built-in MJPEG AVI backend id).  Twin of
``opencv_tpu/videoio_registry.py``."""

from .constants import CAP_IMAGES, CAP_OPENCV_MJPEG

_BACKENDS = [CAP_IMAGES, CAP_OPENCV_MJPEG]
_NAMES = {CAP_IMAGES: "CAP_IMAGES", CAP_OPENCV_MJPEG: "CAP_OPENCV_MJPEG"}


def getBackends():
    return list(_BACKENDS)

def getBackendName(api):
    return _NAMES.get(api, f"UnknownVideoAPI({int(api)})")

def hasBackend(api):
    return api in _BACKENDS

def isBackendBuiltIn(api):
    return api in _BACKENDS

def getCameraBackends():
    return []

def getStreamBackends():
    return list(_BACKENDS)

def getStreamBufferedBackends():
    return []

def getWriterBackends():
    return list(_BACKENDS)

def getCameraBackendPluginVersion(api):
    raise RuntimeError("Unknown or wrong backend ID")

def getStreamBackendPluginVersion(api):
    raise RuntimeError("Unknown or wrong backend ID")

def getStreamBufferedBackendPluginVersion(api):
    raise RuntimeError("Unknown or wrong backend ID")

def getWriterBackendPluginVersion(api):
    raise RuntimeError("Unknown or wrong backend ID")
