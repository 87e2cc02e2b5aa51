"""ChArUco board detection (`cv2.aruco.CharucoBoard` /
`cv2.aruco.CharucoDetector`, modules/objdetect/src/aruco/
charuco_detector.cpp + aruco_board.cpp CharucoBoardImpl); twin of
``opencv_tpu/objdetect/charuco.py``.

The marker detection reuses the port's ArucoDetector (its thresholds on
the image's device); chessboard-corner interpolation uses per-marker local
homographies (charuco_detector.cpp :206 interpolateCornersCharucoLocalHom)
with nearest-marker averaging, distance-capped cornerSubPix refinement on
the gray plane read back once, and the minMarkers filter (host numpy, as
in the JAX package).
"""

from __future__ import annotations

import numpy as np

__all__ = ["CharucoBoard", "CharucoParameters", "CharucoDetector"]


class CharucoBoard:
    """cv2.aruco.CharucoBoard (aruco_board.cpp:332 createCharucoBoard)."""

    def __init__(self, size, squareLength, markerLength, dictionary,
                 ids=None):
        self.size = (int(size[0]), int(size[1]))          # (w, h) squares
        self.squareLength = float(squareLength)
        self.markerLength = float(markerLength)
        self.dictionary = dictionary
        w, h = self.size
        diff = (self.squareLength - self.markerLength) / 2

        self.objPoints = []       # marker corners, (nmarkers, 4, 3)
        self.ids = []
        next_id = 0
        for y in range(h):
            for x in range(w):
                if y % 2 == x % 2:
                    continue      # black square, no marker
                x0 = x * self.squareLength + diff
                y0 = y * self.squareLength + diff
                m = self.markerLength
                self.objPoints.append(np.array(
                    [[x0, y0, 0], [x0 + m, y0, 0],
                     [x0 + m, y0 + m, 0], [x0, y0 + m, 0]], np.float32))
                self.ids.append(next_id)
                next_id += 1
        if ids is not None:
            ids = [int(i) for i in np.asarray(ids).reshape(-1)]
            assert len(ids) == len(self.objPoints)
            self.ids = ids

        self.chessboardCorners = np.array(
            [[(x + 1) * self.squareLength, (y + 1) * self.squareLength, 0]
             for y in range(h - 1) for x in range(w - 1)], np.float32)
        self._calc_nearest()

    def _calc_nearest(self):
        """nearestMarkerIdx / nearestMarkerCorners
        (aruco_board.cpp:379 calcNearestMarkerCorners)."""
        centers = np.stack([p[:, :2].mean(0) for p in self.objPoints])
        self.nearestMarkerIdx = []
        self.nearestMarkerCorners = []
        tol = (0.01 * self.squareLength) ** 2
        for cc in self.chessboardCorners[:, :2]:
            d2 = ((centers - cc) ** 2).sum(1)
            idxs = []
            mind = None
            for j in range(len(d2)):
                if j == 0 or (mind is not None
                              and abs(d2[j] - mind) < tol):
                    idxs.append(j)
                    mind = d2[j]
                elif d2[j] < mind:
                    idxs = [j]
                    mind = d2[j]
            self.nearestMarkerIdx.append(idxs)
            ncs = []
            for j in idxs:
                dc = ((self.objPoints[j][:, :2] - cc) ** 2).sum(1)
                ncs.append(int(dc.argmin()))
            self.nearestMarkerCorners.append(ncs)

    def getChessboardCorners(self):
        return self.chessboardCorners

    def getIds(self):
        return np.asarray(self.ids, np.int32)

    def getObjPoints(self):
        return self.objPoints

    def getSquareLength(self):
        return self.squareLength

    def getMarkerLength(self):
        return self.markerLength

    def getChessboardSize(self):
        return self.size

    def generateImage(self, outSize, marginSize: int = 0,
                      borderBits: int = 1):
        """Render the board (aruco_board.cpp generateImage semantics):
        chessboard with markers centered in the white squares."""
        from .aruco import generateImageMarker

        ow, oh = int(outSize[0]), int(outSize[1])
        w, h = self.size
        img = np.full((oh, ow), 255, np.uint8)
        avail_w = ow - 2 * marginSize
        avail_h = oh - 2 * marginSize
        sq = min(avail_w // w, avail_h // h)
        bw, bh = sq * w, sq * h
        x0 = marginSize + (avail_w - bw) // 2
        y0 = marginSize + (avail_h - bh) // 2
        mpix = int(round(sq * self.markerLength / self.squareLength))
        moff = (sq - mpix) // 2
        mi = 0
        for y in range(h):
            for x in range(w):
                xs, ys = x0 + x * sq, y0 + y * sq
                if y % 2 == x % 2:
                    img[ys:ys + sq, xs:xs + sq] = 0
                else:
                    mk = generateImageMarker(self.dictionary, self.ids[mi],
                                             mpix, borderBits)
                    img[ys + moff:ys + moff + mpix,
                        xs + moff:xs + moff + mpix] = mk
                    mi += 1
        return img


class CharucoParameters:
    def __init__(self):
        self.cameraMatrix = None
        self.distCoeffs = None
        self.minMarkers = 2
        self.tryRefineMarkers = False


class CharucoDetector:
    """cv2.aruco.CharucoDetector (charuco_detector.cpp:384)."""

    def __init__(self, board, charucoParams=None, detectorParams=None,
                 refineParams=None):
        from .aruco import ArucoDetector

        self.board = board
        self.params = charucoParams or CharucoParameters()
        self._aruco = ArucoDetector(board.dictionary, detectorParams)

    def detectBoard(self, image, markerCorners=None, markerIds=None):
        """Returns (charucoCorners, charucoIds, markerCorners, markerIds).
        charucoCorners: (n, 1, 2) float32; charucoIds: (n, 1) int32."""
        from .. import constants as K
        from ..core.arrays import as_tensor, to_host
        from ..ops.color import cvtColor
        from ..ops.warp import getPerspectiveTransform
        from ..calib3d.geometry import perspectiveTransform
        from ..calib3d.chessboard import cornerSubPix

        img = as_tensor(image)
        gray_t = img if img.ndim == 2 else cvtColor(img, K.COLOR_BGR2GRAY)

        if markerCorners is None or markerIds is None:
            markerCorners, markerIds, _ = self._aruco.detectMarkers(gray_t)
        gray = to_host(gray_t)
        if markerIds is None or len(markerIds) == 0:
            return None, None, markerCorners, markerIds
        mids = np.asarray(markerIds).reshape(-1)
        mcs = [np.asarray(c, np.float32).reshape(4, 2)
               for c in markerCorners]

        board = self.board
        board_ids = list(board.getIds())

        # local homography per detected marker (obj plane -> image)
        transforms = {}
        for i, mid in enumerate(mids):
            if mid not in board_ids:
                continue
            bidx = board_ids.index(mid)
            obj2d = board.objPoints[bidx][:, :2].astype(np.float32)
            Hm = getPerspectiveTransform(obj2d, mcs[i])
            if abs(np.linalg.det(Hm)) > 1e-6:
                transforms[int(mid)] = Hm

        ncorners = len(board.chessboardCorners)
        all_pts = np.full((ncorners, 2), -1.0, np.float32)
        for i in range(ncorners):
            obj = board.chessboardCorners[i, :2][None, :]
            interp = []
            for j in board.nearestMarkerIdx[i]:
                mid = board_ids[j]
                if mid in transforms and mid in mids:
                    p = np.asarray(perspectiveTransform(
                        obj.reshape(1, 1, 2), transforms[mid])).reshape(2)
                    interp.append(p)
            if not interp:
                continue
            all_pts[i] = (interp[0] + interp[1]) / 2.0 \
                if len(interp) > 1 else interp[0]

        # subpix window capped by distance to nearest marker corner
        # (charuco_detector.cpp getMaximumSubPixWindowSizes)
        win = np.full(ncorners, -1, np.int64)
        mid_to_idx = {int(m): k for k, m in enumerate(mids)}
        for i in range(ncorners):
            if all_pts[i, 0] == -1:
                continue
            mind = None
            for j, bj in enumerate(board.nearestMarkerIdx[i]):
                mid = board_ids[bj]
                k = mid_to_idx.get(mid)
                if k is None:
                    continue
                mc = mcs[k][board.nearestMarkerCorners[i][j]]
                d = float(np.linalg.norm(mc - all_pts[i]))
                mind = d if mind is None else min(mind, d)
            if mind is not None:
                win[i] = int(np.clip(int(mind - 2), 1, 10))

        # select inside-image corners + refine
        Hh, Ww = gray.shape[:2]
        sel = [i for i in range(ncorners)
               if 2 <= all_pts[i, 0] < Ww - 2 and 2 <= all_pts[i, 1] < Hh - 2]
        corners, ids = [], []
        for i in sel:
            ws = int(win[i]) if win[i] > 0 else 5
            # (no ±0.5 shuffle: our cornerSubPix already uses the same
            # integer-coordinate convention as its cv2 oracle tests)
            ref = np.asarray(cornerSubPix(
                gray, all_pts[i].reshape(1, 1, 2).astype(np.float32),
                (ws, ws), (-1, -1),
                (K.TERM_CRITERIA_MAX_ITER + K.TERM_CRITERIA_EPS,
                 30, 1e-3))).reshape(2)
            corners.append(ref)
            ids.append(i)

        # minMarkers filter (charuco_detector.cpp:274)
        mm = self.params.minMarkers
        f_corners, f_ids = [], []
        for c, i in zip(corners, ids):
            total = sum(1 for bj in self.board.nearestMarkerIdx[i]
                        if board_ids[bj] in mid_to_idx)
            if total >= mm:
                f_corners.append(c)
                f_ids.append(i)
        if not f_ids:
            return None, None, markerCorners, markerIds
        cc = np.asarray(f_corners, np.float32).reshape(-1, 1, 2)
        ci = np.asarray(f_ids, np.int32).reshape(-1, 1)
        return cc, ci, markerCorners, markerIds
