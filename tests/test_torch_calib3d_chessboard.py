"""The port's chessboard detection (``opencv_tpu_torch/calib3d/chessboard.py``)
against ``opencv_tpu`` and cv2.

findChessboardCorners, cornerSubPix and drawChessboardCorners equal the JAX
package exactly (its numpy, over the port's adaptiveThreshold, erode,
native contours and drawing).  findChessboardCornersSB's corner likelihood
takes torch's FFT where the JAX package's jitted program takes XLA's:
measured, the maps differ by at most 6.6e-7 (of a range of 0.5); the
tests hold them to 2e-6.  Given the port's likelihood map, the JAX
package's detector returns the port's corners exactly; on its own jitted
map the corners sit within 0.06 px (measured 0.0526), held to 0.1."""

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv
from opencv_tpu.calib3d import chessboard as jcb
from opencv_tpu_torch.calib3d import chessboard as tcb

from torch_threads import _one_torch_thread  # noqa: F401

LIKELIHOOD_ATOL = 2e-6
SB_CORNER_TOL = 0.1


def _make_board(cols, rows, sq=30, angle=7, noise=8, seed=0):
    W, H = (cols + 3) * sq, (rows + 3) * sq
    img = np.full((H, W), 255, np.uint8)
    for i in range(rows + 1):
        for j in range(cols + 1):
            if (i + j) % 2 == 0:
                img[(i + 1) * sq:(i + 2) * sq, (j + 1) * sq:(j + 2) * sq] = 0
    M = cv2.getRotationMatrix2D((W / 2, H / 2), angle, 1.0)
    img = cv2.warpAffine(img, M, (W, H), borderValue=180)
    rng = np.random.default_rng(seed)
    return np.clip(img.astype(int) + rng.integers(-noise, noise, img.shape), 0,
                   255).astype(np.uint8)


BOARDS = [(7, 5, 7), (9, 6, 0), (6, 4, -12)]


@pytest.mark.parametrize("cols,rows,ang", BOARDS)
def test_find_chessboard_corners_equals_opencv_tpu_and_matches_cv2(cols, rows, ang):
    img = _make_board(cols, rows, angle=ang)
    ok, ours = tcv.findChessboardCorners(torch.from_numpy(img), (cols, rows))
    ok_j, ref = jcv.findChessboardCorners(img, (cols, rows))
    assert ok and ok_j and ours.dtype == np.float32 and np.array_equal(ours, ref)
    bgr = np.repeat(img[..., None], 3, axis=-1)
    assert np.array_equal(tcv.findChessboardCorners(torch.from_numpy(bgr), (cols, rows))[1],
                          jcv.findChessboardCorners(bgr, (cols, rows))[1])
    okr, cref = cv2.findChessboardCorners(img, (cols, rows))
    assert okr
    g = ours.reshape(rows, cols, 2)
    variants = [g.reshape(-1, 2), g[::-1, ::-1].reshape(-1, 2),
                np.transpose(g, (1, 0, 2)).reshape(-1, 2)[::-1],
                np.transpose(g[::-1, ::-1], (1, 0, 2)).reshape(-1, 2)[::-1]]
    assert min(np.linalg.norm(cref.reshape(-1, 2) - v, axis=1).max() for v in variants) < 0.3


def test_find_chessboard_corners_not_found_equals_opencv_tpu():
    img = _make_board(7, 5)
    for flags in (tcv.CALIB_CB_ADAPTIVE_THRESH, 0):
        assert tcv.findChessboardCorners(img, (9, 9), flags=flags) \
            == jcv.findChessboardCorners(img, (9, 9), flags=flags) == (False, None)


@pytest.mark.parametrize("win", [(5, 5), (11, 11), (3, 7)])
def test_corner_subpix_equals_opencv_tpu_and_matches_cv2(win):
    img = _make_board(7, 5, angle=0, noise=4)
    ok, corners = cv2.findChessboardCorners(img, (7, 5), flags=cv2.CALIB_CB_ADAPTIVE_THRESH)
    assert ok
    rough = corners.reshape(-1, 2) + np.random.default_rng(1).uniform(
        -1.5, 1.5, (35, 2)).astype(np.float32)
    crit = (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 0.01)
    ours = tcv.cornerSubPix(torch.from_numpy(img), torch.from_numpy(rough.reshape(-1, 1, 2)),
                            win, (-1, -1), crit)
    ref = jcv.cornerSubPix(img, rough.copy().reshape(-1, 1, 2), win, (-1, -1), crit)
    assert ours.shape == (35, 1, 2) and np.array_equal(ours, ref)
    zz = tcv.cornerSubPix(img, rough.copy(), win, (1, 1), crit)
    assert np.array_equal(zz, jcv.cornerSubPix(img, rough.copy(), win, (1, 1), crit))
    if win == (5, 5):
        want = cv2.cornerSubPix(img, rough.copy().reshape(-1, 1, 2), win, (-1, -1), crit)
        d = np.linalg.norm(want.reshape(-1, 2) - ours.reshape(-1, 2), axis=1)
        assert np.median(d) < 0.1


@pytest.mark.parametrize("found", [True, False])
def test_draw_chessboard_corners_equals_opencv_tpu(found):
    img = _make_board(7, 5)
    ok, corners = jcv.findChessboardCorners(img, (7, 5))
    base = np.repeat(img[..., None], 3, axis=-1)
    ours = tcv.drawChessboardCorners(torch.from_numpy(base.copy()), (7, 5), corners, found)
    ref = jcv.drawChessboardCorners(base.copy(), (7, 5), corners, found)
    assert isinstance(ours, torch.Tensor) and np.array_equal(ours.numpy(), np.asarray(ref))
    host = base.copy()
    tcv.drawChessboardCorners(host, (7, 5), corners, found)       # in place on an array
    assert np.array_equal(host, np.asarray(ref))


def _sb_board(sq=40, cols=7, rows=5, bg=128, M=None):
    board = np.zeros(((rows + 1) * sq, (cols + 1) * sq), np.uint8)
    for i in range(rows + 1):
        for j in range(cols + 1):
            if (i + j) % 2 == 0:
                board[i * sq:(i + 1) * sq, j * sq:(j + 1) * sq] = 255
    img = np.full((480, 640), bg, np.uint8)
    img[60:60 + board.shape[0], 80:80 + board.shape[1]] = board
    if M is not None:
        img = cv2.warpAffine(img, M, (640, 480), borderValue=bg)
    return img


SB_AFFINES = [None, np.array([[0.95, 0.08, 20], [-0.05, 0.9, 30]]),
              np.array([[0.8, 0.0, 60], [0.0, 0.8, 50]])]


@pytest.mark.parametrize("case", range(len(SB_AFFINES)))
def test_corner_likelihood_within_bound_of_opencv_tpu(case):
    img = _sb_board(M=SB_AFFINES[case])
    gray = img.astype(np.float32) / 255.0
    ours = tcb._corner_likelihood(torch.from_numpy(gray))
    assert ours.dtype == torch.float32
    ref = jcb._corner_likelihood(gray)
    assert np.abs(ours.numpy() - ref).max() <= LIKELIHOOD_ATOL


@pytest.mark.parametrize("case", range(len(SB_AFFINES)))
def test_find_chessboard_corners_sb_against_opencv_tpu_and_cv2(case, monkeypatch):
    img = _sb_board(M=SB_AFFINES[case])
    ok, ours = tcv.findChessboardCornersSB(torch.from_numpy(img), (7, 5))
    ok_j, ref = jcv.findChessboardCornersSB(img, (7, 5))
    assert ok and ok_j and ours.shape == (35, 1, 2)
    assert np.abs(ours - ref).max() <= SB_CORNER_TOL
    # given the port's likelihood map, the JAX package's detector agrees exactly
    monkeypatch.setattr(jcb, "_corner_likelihood",
                        lambda g: tcb._corner_likelihood(torch.from_numpy(g)).numpy())
    ok_j, same = jcv.findChessboardCornersSB(img, (7, 5))
    assert ok_j and np.array_equal(ours, same)
    ok_r, want = cv2.findChessboardCornersSB(img, (7, 5))
    a, b = want.reshape(-1, 2), ours.reshape(-1, 2)
    assert ok_r and min(np.linalg.norm(a - b, axis=1).max(),
                        np.linalg.norm(a - b[::-1], axis=1).max()) < 0.7


def test_find_chessboard_corners_sb_noise_and_flags(monkeypatch):
    rng = np.random.default_rng(0)
    img = np.clip(_sb_board().astype(np.int16) + rng.normal(0, 6, (480, 640)), 0,
                  255).astype(np.uint8)
    flags = tcv.CALIB_CB_EXHAUSTIVE | tcv.CALIB_CB_ACCURACY
    ok, ours = tcv.findChessboardCornersSB(img, (7, 5), flags)
    assert ok
    monkeypatch.setattr(jcb, "_corner_likelihood",
                        lambda g: tcb._corner_likelihood(torch.from_numpy(g)).numpy())
    assert np.array_equal(ours, jcv.findChessboardCornersSB(img, (7, 5), flags)[1])
    assert tcv.findChessboardCornersSB(img, (9, 9)) == (False, None)
