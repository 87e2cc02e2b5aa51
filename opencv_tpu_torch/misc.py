"""cv2.misc — small helper namespace."""

from . import version


def get_ocv_version():
    return version.opencv_version
