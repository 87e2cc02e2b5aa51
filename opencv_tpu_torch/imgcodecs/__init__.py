"""Image codecs (modules/imgcodecs), twin of ``opencv_tpu/imgcodecs``.

The codecs are host numpy and return numpy, as cv2 does; their entropy
loops run in the port's native host tails (``native/hosttails.cpp``).
"""

from .io import (  # noqa: F401
    imread, imwrite, imdecode, imencode,
    imreadmulti, imwritemulti, imcount, imdecodemulti, imencodemulti,
    haveImageReader, haveImageWriter, Animation, imreadanimation,
    imwriteanimation, imdecodeanimation, imencodeanimation,
    imreadWithMetadata, imwriteWithMetadata, imdecodeWithMetadata,
    imencodeWithMetadata, IMREAD_ANYDEPTH, IMREAD_ANYCOLOR,
    IMREAD_COLOR, IMREAD_GRAYSCALE, IMREAD_UNCHANGED,
)
