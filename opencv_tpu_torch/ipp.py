"""cv2.ipp — Intel IPP dispatch controls (core/src/system.cpp).  This
build has no IPP; the toggles are accepted and report disabled."""


def getIppVersion():
    return "disabled"


def useIPP():
    return False


def setUseIPP(flag):
    return None


def useIPP_NotExact():
    return False


def setUseIPP_NotExact(flag):
    return None
