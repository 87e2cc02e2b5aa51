"""highgui (modules/highgui) — headless stubs.

TPU hosts have no display; the API surface exists so pipelines written
against the reference import and run. imshow stores the last image per
window (retrievable for tests/debugging), waitKey returns immediately.

Twin of ``opencv_tpu/highgui.py``.  imshow takes a numpy array or a tensor
on any device and stores its host copy (``core.arrays.to_host``); addText
draws with the port's putText.
"""

from __future__ import annotations

from .core.arrays import to_host

__all__ = ["imshow", "waitKey", "pollKey", "namedWindow", "destroyWindow",
           "destroyAllWindows", "moveWindow", "resizeWindow",
           "setMouseCallback", "createTrackbar", "getTrackbarPos",
           "setTrackbarPos", "getWindowProperty", "setWindowProperty",
           "waitKeyEx", "startWindowThread", "setWindowTitle",
           "getWindowImageRect", "setTrackbarMin", "setTrackbarMax",
           "displayOverlay", "displayStatusBar", "addText", "createButton",
           "selectROI", "selectROIs", "currentUIFramework",
           "WINDOW_NORMAL", "WINDOW_AUTOSIZE", "WND_PROP_VISIBLE"]

WINDOW_NORMAL = 0
WINDOW_AUTOSIZE = 1
WND_PROP_VISIBLE = 4

_windows = {}
_trackbars = {}


def namedWindow(winname, flags=WINDOW_AUTOSIZE):
    _windows.setdefault(winname, None)


def imshow(winname, mat):
    _windows[winname] = to_host(mat)


def waitKey(delay=0):
    return -1


def pollKey():
    return -1


def destroyWindow(winname):
    _windows.pop(winname, None)


def destroyAllWindows():
    _windows.clear()


def moveWindow(winname, x, y):
    pass


def resizeWindow(winname, w, h):
    pass


def setMouseCallback(winname, onMouse, param=None):
    pass


def createTrackbar(name, winname, value, count, onChange):
    _trackbars[(winname, name)] = value


def getTrackbarPos(name, winname):
    return _trackbars.get((winname, name), 0)


def setTrackbarPos(name, winname, pos):
    _trackbars[(winname, name)] = pos


def getWindowProperty(winname, prop):
    return 1.0 if winname in _windows else -1.0


def setWindowProperty(winname, prop, value):
    pass


def waitKeyEx(delay=0):
    return -1


def startWindowThread():
    return 0


def setWindowTitle(winname, title):
    pass


def getWindowImageRect(winname):
    img = _windows.get(winname)
    if img is None:
        return (0, 0, -1, -1)
    return (0, 0, img.shape[1], img.shape[0])


def setTrackbarMin(name, winname, minval):
    pass


def setTrackbarMax(name, winname, maxval):
    pass


def displayOverlay(winname, text, delayms=0):
    pass


def displayStatusBar(winname, text, delayms=0):
    pass


def addText(img, text, org, nameFont, pointSize=-1, color=None,
            weight=0, style=0, spacing=0):
    """Qt addText — headless: draw with the Hershey engine instead."""
    from .ops.drawing import putText
    sc = max(0.5, (pointSize if pointSize > 0 else 12) / 24.0)
    return putText(img, text, org, 0, sc,
                   color if color is not None else (0, 0, 0))


def createButton(buttonName, onChange=None, userData=None,
                 buttonType=0, initialButtonState=False):
    pass


def selectROI(windowName, img=None, showCrosshair=True,
              fromCenter=False, printNotice=True):
    """Headless: no interactive selection possible; returns an empty
    rect like the reference does when selection is cancelled."""
    return (0, 0, 0, 0)


def selectROIs(windowName, img=None, showCrosshair=True,
               fromCenter=False, printNotice=True):
    return []


def currentUIFramework():
    return ""
