"""The stitching path (``entry.forward_stitch``) on the CPU at a small cut —
``make_pan_video``'s pan at (3, 216, 384), two pairs — against the JAX
package's Stitcher stage by stage: pair 0's ORB keypoints and descriptors,
cross-checked matches and RANSAC homography equal to the JAX package's
(its ORB on the same frames; ORB's float responses round apart in the last
bits, so the homography within 1e-6 relative), and the last pair's
composition (warpPerspective onto the canvas, the L1 distance-transform
seam, the 4-band blend) from the port's panorama so far and homography
equal to the JAX package's composition within the warp bound of the
port's tests (one pair: the JAX package compiles each canvas size); and the
truth: the panorama's width within 1% of the extent the pan's matrices
imply."""

import numpy as np
import pytest
import torch

from torch_threads import _one_torch_thread  # noqa: F401

import opencv_tpu as jcv
from opencv_tpu.blenders import blend_multiband as jblend
from opencv_tpu_torch import entry as E
from opencv_tpu_torch.stitching import Stitcher

SHAPE = (3, 216, 384, 3)
# the warps' bound against the JAX package (tests/test_torch_warp.py): f64
# coordinates where the JAX package takes double-float
WARP_ATOL, WARP_SHARE = 1, 1e-3


@pytest.fixture(scope="module")
def run():
    frames, truth = E.make_pan_video(SHAPE)
    st = E.forward_stitch(torch.from_numpy(frames))
    return frames, truth, st


def test_panorama_and_truth(run):
    frames, truth, st = run
    assert st["status"] == Stitcher.OK
    pano = st["pano"]
    assert pano.dtype == torch.uint8 and pano.shape[0] >= SHAPE[1]
    x0, x1, _, _ = E.pan_extent(truth, SHAPE)
    assert abs(pano.shape[1] - (x1 - x0)) <= 0.01 * (x1 - x0)
    assert len(st["homographies"]) == SHAPE[0] - 1


def test_pair0_features_and_homography_equal_opencv_tpu(run):
    frames, _, st = run
    a, b = frames[0], frames[1]
    jorb = jcv.ORB_create(nfeatures=1000)
    k1, d1 = jorb.detectAndCompute(a, None)
    k2, d2 = jorb.detectAndCompute(b, None)
    tk1, td1 = st["stitcher"].orb.detectAndCompute(torch.from_numpy(a), None)
    assert [k.pt for k in tk1] == [k.pt for k in k1]
    np.testing.assert_array_equal(td1, np.asarray(d1))
    matches = jcv.BFMatcher(jcv.NORM_HAMMING, crossCheck=True).match(d2, d1)
    matches = sorted(matches, key=lambda m: m.distance)[:200]
    src = np.float32([k2[m.queryIdx].pt for m in matches])
    dst = np.float32([k1[m.trainIdx].pt for m in matches])
    tsrc, tdst = st["stitcher"].match_points(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(tsrc, src)
    np.testing.assert_array_equal(tdst, dst)
    H, _ = jcv.findHomography(src, dst, jcv.RANSAC, 3.0)
    np.testing.assert_allclose(st["homographies"][0], H, rtol=1e-6, atol=1e-9)


def _jax_compose(a, b, H):
    """The JAX package's Stitcher._stitch_pair after the homography."""
    ha, wa = a.shape[:2]
    hb, wb = b.shape[:2]
    corners = np.array([[0, 0], [wb, 0], [wb, hb], [0, hb]], np.float64)
    ch = np.column_stack([corners, np.ones(4)]) @ H.T
    ch = ch[:, :2] / ch[:, 2:3]
    minx, miny = min(0.0, ch[:, 0].min()), min(0.0, ch[:, 1].min())
    maxx, maxy = max(float(wa), ch[:, 0].max()), max(float(ha), ch[:, 1].max())
    T = np.array([[1, 0, -minx], [0, 1, -miny], [0, 0, 1]])
    W, Hh = int(np.ceil(maxx - minx)), int(np.ceil(maxy - miny))
    warped_b = np.asarray(jcv.warpPerspective(b, T @ H, (W, Hh)))
    canvas = np.zeros_like(warped_b)
    ox, oy = int(round(-minx)), int(round(-miny))
    canvas[oy:oy + ha, ox:ox + wa] = a
    mask_a = np.zeros((Hh, W), bool)
    mask_a[oy:oy + ha, ox:ox + wa] = True
    mask_b = warped_b.sum(axis=-1) > 0
    both = mask_a & mask_b
    da = np.asarray(jcv.distanceTransform(mask_a.astype(np.uint8) * 255, jcv.DIST_L1, 3))
    db = np.asarray(jcv.distanceTransform(mask_b.astype(np.uint8) * 255, jcv.DIST_L1, 3))
    w_a = np.where(mask_a, np.where(both, (da >= db).astype(np.float32), 1.0), 0.0)
    w_b = np.where(mask_b, 1.0 - w_a, 0.0)
    out = jblend([canvas, warped_b], [w_a, w_b], num_bands=4)
    out[~(mask_a | mask_b)] = 0
    return warped_b, out


def test_composition_equals_opencv_tpu(run):
    frames, _, st = run
    stitcher = st["stitcher"]
    bases = [torch.from_numpy(frames[0])]
    for i, H in enumerate(st["homographies"]):
        bases.append(stitcher.compose(bases[-1], torch.from_numpy(frames[i + 1]), H))
    assert torch.equal(bases[-1], st["pano"])
    base, b, H = bases[-2], torch.from_numpy(frames[-1]), st["homographies"][-1]
    _, warped, _, _ = stitcher.canvas(base, b, H)
    jwarped, jout = _jax_compose(base.numpy(), frames[-1], H)
    assert tuple(st["pano"].shape) == jout.shape
    for got, want in ((warped.numpy(), jwarped), (st["pano"].numpy(), jout)):
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= WARP_ATOL and (d > 0).mean() <= WARP_SHARE, d.max()
