"""Kalman filter (video/src/kalman.cpp); the port's copy of
``opencv_tpu/video/kalman.py``: tiny dense linear algebra in host numpy, as
the reference's Mat math.  Measurements and controls may be tensors."""

from __future__ import annotations

import numpy as np

from ..core.arrays import to_host

__all__ = ["KalmanFilter"]


class KalmanFilter:
    def __init__(self, dynamParams: int, measureParams: int,
                 controlParams: int = 0, type: int = 5):
        dp, mp, cp = dynamParams, measureParams, controlParams
        self.statePre = np.zeros((dp, 1), np.float32)
        self.statePost = np.zeros((dp, 1), np.float32)
        self.transitionMatrix = np.eye(dp, dtype=np.float32)
        self.controlMatrix = (np.zeros((dp, cp), np.float32) if cp else None)
        self.measurementMatrix = np.zeros((mp, dp), np.float32)
        self.processNoiseCov = np.eye(dp, dtype=np.float32)
        self.measurementNoiseCov = np.eye(mp, dtype=np.float32)
        self.errorCovPre = np.zeros((dp, dp), np.float32)
        self.errorCovPost = np.zeros((dp, dp), np.float32)
        self.gain = np.zeros((dp, mp), np.float32)

    def predict(self, control=None):
        A = self.transitionMatrix
        self.statePre = A @ self.statePost
        if control is not None and self.controlMatrix is not None:
            self.statePre = self.statePre + self.controlMatrix @ to_host(control)
        self.errorCovPre = A @ self.errorCovPost @ A.T + self.processNoiseCov
        self.statePost = self.statePre.copy()
        self.errorCovPost = self.errorCovPre.copy()
        return self.statePre

    def correct(self, measurement):
        H = self.measurementMatrix
        S = H @ self.errorCovPre @ H.T + self.measurementNoiseCov
        K = self.errorCovPre @ H.T @ np.linalg.inv(S)
        self.gain = K.astype(np.float32)
        z = to_host(measurement).astype(np.float32).reshape(-1, 1)
        self.statePost = self.statePre + K @ (z - H @ self.statePre)
        self.errorCovPost = (np.eye(len(self.statePre), dtype=np.float32)
                             - K @ H) @ self.errorCovPre
        return self.statePost
