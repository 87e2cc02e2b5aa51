from .hog import HOGDescriptor, groupRectangles  # noqa: F401
from . import aruco  # noqa: F401
from .qrcode import QRCodeDetector  # noqa: F401
from .qr_encode import QRCodeEncoder  # noqa: F401
from .cascade import CascadeClassifier  # noqa: F401
from .face import FaceDetectorYN, FaceRecognizerSF  # noqa: F401
from .barcode import BarcodeDetector  # noqa: F401
