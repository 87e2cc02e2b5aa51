"""The flagship forward on the port — twin of ``__graft_entry__.py::entry``.

``forward`` is ``cvtColor(BGR2GRAY) → GaussianBlur((5,5), 0) → resize to
half size → warpAffine(getRotationMatrix2D(centre, 15°, 0.9))`` over a
batched NHWC u8 tensor; at the (8, 1080, 1920, 3) batch that is exactly
``entry()``'s chain (resize to 960×540, centre (480, 270)).
``forward_fused`` gives the same output through
``fusedPreprocessGrayBlurDown2`` → ``warpAffine``.

``forward_pyr_corner_edge`` is BASELINE config 3 (``bench.py``'s
``3_pyr_corner_edge_1080p``): pyrDown, cornerHarris on x/255, Sobel u8→16S
and Canny over an (N, 1080, 1920, 1) u8 batch; ``entry_pyr_corner_edge``
gives it ``bench.py``'s batch at ``BATCH_1080`` = 8.

``forward_match_morph`` is BASELINE config 4 (``4_match_morph_1080p``):
matchTemplate TM_CCOEFF_NORMED with a 32×32 u8 template, erode 3×3,
dilate 5×5 and erode 9×9 over the same (N, 1080, 1920, 1) u8 batch;
``entry_match_morph`` draws the batch and then the template from one
``default_rng(0)``, as ``bench.py`` does.

``forward_orb`` is BASELINE config 5 (``5_orb_1080p``): ORB with
nfeatures=500 over an (N, 1080, 1920) u8 batch, through
``ORB.detect_and_compute_batch`` (an INTER_LINEAR_EXACT pyramid of 8
levels, FAST, a sparse Harris rescore, the 7×7 σ 2 blur through
``sep_filter`` once per level, rotated BRIEF, and a host tail);
``entry_orb`` gives it ``bench.py``'s ``default_rng(0)`` batch.

``forward_resize_warp_4k`` is BASELINE config 2 (``2_resize_warp_4k``):
resize to half size with INTER_LINEAR (an exact 2× that reroutes to fast
AREA), INTER_AREA and INTER_CUBIC, warpAffine (15°, 0.9 about the centre)
and warpPerspective by ``bench.py``'s ``P``, both at the input's size, over
an (N, H, W, 3) u8 batch; at (4, 2160, 3840, 3) that is ``bench.py``'s
chain.  ``entry_resize_warp_4k`` gives it ``bench.py``'s batch at
``BATCH_4K`` = 4.

``forward_decode_color`` is the path from a decoded video frame to a binary
map and its integral image: NV12 as a hardware decoder hands it over (a Y
plane and an interleaved UV plane) → ``cvtColorTwoPlane`` to BGR →
cvtColor to HSV, Lab (u8) and YCrCb → ``fusedPreprocessGrayBlurDown2`` →
``threshold`` BINARY | OTSU → ``integral``.  ``entry_decode_color`` gives it
Y (8, 1080, 1920) and UV (8, 540, 960, 2) u8 drawn from one
``default_rng(0)`` in that order: the batch of 8 at 1080p of configs 3–5.

``forward_enhance`` is the contrast-enhancement and visualisation front
end: cvtColor to gray → medianBlur 5 → CLAHE (clip 2, 8×8 tiles) → an
unsharp mask (addWeighted of the image and its ``GaussianBlur((5, 5), 0)``,
1.5 and −0.5; the one ``sep_filter`` launch) → bilateralFilter(5, 50, 50)
→ a γ = 0.8 ``LUT`` → ``applyColorMap`` JET, with the per-image histogram
of the CLAHE output.  ``entry_enhance`` gives it ``make_batch()``'s
(8, 1080, 1920, 3) u8 batch, the flagship's.
"""

from __future__ import annotations

import numpy as np
import torch

from . import constants as K
from .features2d.orb import ORB_create
from .kernels import fused_gray_gauss5_down2
from .ops.canny import Canny
from .ops.color import cvtColor, cvtColorTwoPlane
from .ops.colormap import applyColorMap
from .ops.core_ops import LUT, addWeighted
from .ops.hist import createCLAHE, hist_per_image
from .ops.smooth import bilateralFilter, medianBlur
from .ops.corners import cornerHarris
from .ops.deriv import Sobel
from .ops.filter import GaussianBlur
from .ops.morph import dilate, erode
from .ops.pyramids import pyrDown
from .ops.integral import integral
from .ops.resize import resize
from .ops.templmatch import matchTemplate
from .ops.thresh import threshold
from .ops.warp import getRotationMatrix2D, warpAffine, warpPerspective

__all__ = ["SHAPE", "SHAPE_CFG2", "SHAPE_CFG3", "SHAPE_CFG4", "SHAPE_CFG5", "SHAPE_NV12",
           "PERSPECTIVE_CFG2", "DECODE_COLOR_OUTPUTS", "ENHANCE_STAGES", "ENHANCE_OUTPUTS",
           "GAMMA_LUT", "entry", "entry_resize_warp_4k", "entry_pyr_corner_edge",
           "entry_match_morph", "entry_orb", "entry_decode_color", "entry_enhance",
           "make_batch", "make_nv12", "preprocess", "preprocess_fused", "warp", "forward",
           "forward_fused", "forward_resize_warp_4k", "forward_pyr_corner_edge",
           "forward_match_morph", "forward_orb", "forward_decode_color", "forward_enhance"]

SHAPE = (8, 1080, 1920, 3)
SHAPE_CFG2 = (4, 2160, 3840, 3)
# config 2's homography (bench.py:498-499)
PERSPECTIVE_CFG2 = np.array([[0.95, 0.05, 8.0], [-0.04, 1.02, 4.0], [1e-6, -2e-6, 1.0]],
                            np.float64)
SHAPE_CFG3 = (8, 1080, 1920, 1)
SHAPE_CFG4 = (8, 1080, 1920, 1)
TEMPLATE_CFG4 = (32, 32)
SHAPE_CFG5 = (8, 1080, 1920)
# the Y plane of the NV12 batch; its UV plane is (N, H/2, W/2, 2)
SHAPE_NV12 = (8, 1080, 1920)
# forward_decode_color's image outputs, in order
DECODE_COLOR_OUTPUTS = ("bgr", "hsv", "lab", "ycrcb", "small", "binary", "integral")
# forward_enhance's gamma table: 255 * (v / 255) ** 0.8, rounded, as a u8 LUT
GAMMA_LUT = np.rint(255.0 * (np.arange(256) / 255.0) ** 0.8).astype(np.uint8)


def make_batch(shape=SHAPE, seed: int = 0) -> np.ndarray:
    """The u8 batch of ``entry()``: numpy ``default_rng(seed)`` integers."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=shape, dtype=np.uint8)


def preprocess(imgs):
    """Gray → blur → half-size resize: (N,H,W,3) → (N,H/2,W/2,1)."""
    H, W = imgs.shape[1], imgs.shape[2]
    g = cvtColor(imgs, K.COLOR_BGR2GRAY)
    b = GaussianBlur(g, (5, 5), 0)
    return resize(b, (W // 2, H // 2))


def preprocess_fused(imgs):
    """The same as :func:`preprocess`, through the fused kernel."""
    return fused_gray_gauss5_down2(imgs, 0.0)[..., None]


def warp(r):
    """Rotate 15° and scale 0.9 about the centre, at the input's size."""
    h, w = r.shape[1], r.shape[2]
    M = getRotationMatrix2D((w / 2, h / 2), 15.0, 0.9)
    return warpAffine(r, M, (w, h))


def forward(imgs):
    return warp(preprocess(imgs))


def forward_fused(imgs):
    return warp(preprocess_fused(imgs))


def entry(device="cuda", shape=SHAPE):
    """``(forward, (imgs,))`` with the batch on `device`."""
    return forward, (torch.from_numpy(make_batch(shape)).to(device),)


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """An int64 sum as the int32 sum XLA computes: modulo 2^32, signed."""
    return ((v + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def forward_resize_warp_4k(x):
    """BASELINE config 2 over an (N, H, W, C) u8 batch (``bench.py:501-520``).

    Returns ``(linear, area, cubic, affine, perspective, totals)``: the three
    resizes to (W/2, H/2), the two warps at (W, H), and the three int32
    reductions ``bench.py`` takes (the three resizes together, then each
    warp), as an int32 tensor of 3."""
    H, W = x.shape[1], x.shape[2]
    half = (W // 2, H // 2)
    r1 = resize(x, half, interpolation=K.INTER_LINEAR)
    r2 = resize(x, half, interpolation=K.INTER_AREA)
    r3 = resize(x, half, interpolation=K.INTER_CUBIC)
    wa = warpAffine(x, getRotationMatrix2D((W / 2, H / 2), 15.0, 0.9), (W, H))
    wp = warpPerspective(x, PERSPECTIVE_CFG2, (W, H))
    totals = torch.stack([
        _wrap_int32(r1.sum(dtype=torch.int64) + r2.sum(dtype=torch.int64)
                    + r3.sum(dtype=torch.int64)),
        _wrap_int32(wa.sum(dtype=torch.int64)), _wrap_int32(wp.sum(dtype=torch.int64))])
    return r1, r2, r3, wa, wp, totals


def entry_resize_warp_4k(device="cuda", shape=SHAPE_CFG2):
    """``(forward_resize_warp_4k, (x,))`` with ``bench.py``'s config-2 batch
    (``default_rng(0)`` integers) on `device`."""
    return forward_resize_warp_4k, (torch.from_numpy(make_batch(shape)).to(device),)


def forward_pyr_corner_edge(x):
    """BASELINE config 3 over an (N, H, W, 1) u8 batch (``bench.py:447-454``).

    Returns ``(pyrDown, cornerHarris, Sobel, Canny, total)``: the four
    outputs and the int32 reduction ``bench.py`` takes of them."""
    p = pyrDown(x)
    h = cornerHarris(x.to(torch.float32) / 255.0, 2, 3, 0.04)
    sx = Sobel(x, K.CV_16S, 1, 0)
    c = Canny(x, 50, 150)
    total = _wrap_int32(p.sum(dtype=torch.int64) + h.sum().to(torch.int32).to(torch.int64)
                        + sx.sum(dtype=torch.int64) + c.sum(dtype=torch.int64))
    return p, h, sx, c, total


def entry_pyr_corner_edge(device="cuda", shape=SHAPE_CFG3):
    """``(forward_pyr_corner_edge, (x,))`` with ``bench.py``'s config-3 batch
    (``default_rng(0)`` integers) on `device`."""
    return forward_pyr_corner_edge, (torch.from_numpy(make_batch(shape)).to(device),)


def forward_match_morph(x, t):
    """BASELINE config 4 over an (N, H, W, 1) u8 batch and a u8 template
    (``bench.py:466-471``).

    Returns ``(m, e3, d5, e9, total)``: matchTemplate TM_CCOEFF_NORMED,
    erode 3×3, dilate 5×5, erode 9×9, and the float32 reduction ``bench.py``
    takes of them (the f32 sum of ``m`` plus each morph output's int32 sum,
    added in f32)."""
    m = matchTemplate(x, t, K.TM_CCOEFF_NORMED)
    e3 = erode(x, np.ones((3, 3), np.uint8))
    d5 = dilate(x, np.ones((5, 5), np.uint8))
    e9 = erode(x, np.ones((9, 9), np.uint8))
    total = m.sum()
    for v in (e3, d5, e9):
        total = total + _wrap_int32(v.sum(dtype=torch.int64)).to(torch.float32)
    return m, e3, d5, e9, total


def entry_match_morph(device="cuda", shape=SHAPE_CFG4):
    """``(forward_match_morph, (x, t))`` with ``bench.py``'s config-4 batch
    and then its 32×32 template, both from one ``default_rng(0)``, on
    `device`."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, size=shape, dtype=np.uint8)
    t = rng.integers(0, 256, size=TEMPLATE_CFG4, dtype=np.uint8)
    return forward_match_morph, (torch.from_numpy(x).to(device), torch.from_numpy(t).to(device))


def forward_orb(x, orb):
    """BASELINE config 5 over an (N, H, W) u8 batch (``bench.py:478-491``):
    ``orb.detect_and_compute_batch(x)``, a list of (keypoints, descriptors)
    per image."""
    return orb.detect_and_compute_batch(x)


def entry_orb(device="cuda", shape=SHAPE_CFG5):
    """``(forward_orb, (x, orb))`` with ``bench.py``'s config-5 batch
    (``default_rng(0)`` integers) on `device` and ``ORB_create(nfeatures=500)``."""
    return forward_orb, (torch.from_numpy(make_batch(shape)).to(device), ORB_create(nfeatures=500))


def forward_decode_color(y, uv):
    """From NV12 to a binary map and its integral image: Y (N, H, W) and
    UV (N, H/2, W/2, 2) u8.

    Returns ``(bgr, hsv, lab, ycrcb, small, binary, integral, otsu, sums)``:
    the decoded (N, H, W, 3) BGR frame, its HSV, Lab and YCrCb u8
    conversions, the (N, H/2, W/2, 1) gray + 5×5 Gaussian + 2× AREA map,
    its Otsu binary map (one threshold over the batch, as ``opencv_tpu``
    takes it), the binary map's (N, H/2+1, W/2+1, 1) int32 integral, the
    Otsu threshold (an f64 0-dim tensor) and the int64 sum of each of the
    seven outputs per image, an (N, 7) tensor."""
    bgr = cvtColorTwoPlane(y, uv, K.COLOR_YUV2BGR_NV12)
    hsv = cvtColor(bgr, K.COLOR_BGR2HSV)
    lab = cvtColor(bgr, K.COLOR_BGR2Lab)
    ycrcb = cvtColor(bgr, K.COLOR_BGR2YCrCb)
    small = fused_gray_gauss5_down2(bgr, 0.0)[..., None]
    otsu, binary = threshold(small, 0, 255, K.THRESH_BINARY | K.THRESH_OTSU)
    integ = integral(binary)
    outs = (bgr, hsv, lab, ycrcb, small, binary, integ)
    sums = torch.stack([o.reshape(o.shape[0], -1).sum(dim=1, dtype=torch.int64) for o in outs],
                       dim=1)
    return (*outs, otsu, sums)


def make_nv12(shape=SHAPE_NV12, seed: int = 0):
    """Y (N, H, W) and UV (N, H/2, W/2, 2) u8 from one ``default_rng(seed)``,
    in that order."""
    N, H, W = shape
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, size=(N, H, W), dtype=np.uint8)
    uv = rng.integers(0, 256, size=(N, H // 2, W // 2, 2), dtype=np.uint8)
    return y, uv


def entry_decode_color(device="cuda", shape=SHAPE_NV12):
    """``(forward_decode_color, (y, uv))`` with the NV12 batch of
    :func:`make_nv12` on `device`."""
    y, uv = make_nv12(shape)
    return forward_decode_color, (torch.from_numpy(y).to(device), torch.from_numpy(uv).to(device))


# forward_enhance's stages in order, (name, fn of the previous stage's output);
# the names are its image outputs
ENHANCE_STAGES = (
    ("gray", lambda a: cvtColor(a, K.COLOR_BGR2GRAY)),
    ("median", lambda a: medianBlur(a, 5)),
    ("clahe", lambda a: createCLAHE(2.0, (8, 8)).apply(a)),
    ("unsharp", lambda a: addWeighted(a, 1.5, GaussianBlur(a, (5, 5), 0), -0.5, 0)),
    ("bilateral", lambda a: bilateralFilter(a, 5, 50, 50)),
    ("gamma", lambda a: LUT(a, GAMMA_LUT)),
    ("colour", lambda a: applyColorMap(a, K.COLORMAP_JET)),
)
ENHANCE_OUTPUTS = tuple(name for name, _ in ENHANCE_STAGES)


def forward_enhance(x):
    """Contrast enhancement and false colour over an (N, H, W, 3) u8 BGR
    batch, the front end that inspection, thermal, medical and low-light
    video run before a display or a detector: gray, impulse noise removed
    (medianBlur 5), local contrast (CLAHE clip 2 on 8×8 tiles), sharpened
    (unsharp mask: 1.5 × image − 0.5 × its 5×5 Gaussian), edge-preserving
    smoothing (bilateralFilter d = 5, σ 50, 50), brightened (γ = 0.8 LUT)
    and mapped to JET (:data:`ENHANCE_STAGES`).

    Returns ``(gray, median, clahe, unsharp, bilateral, gamma, colour, hist,
    sums)``: the six (N, H, W, 1) u8 stages and the (N, H, W, 3) colour
    image, the CLAHE output's 256-bin f32 histogram per image (N, 256), and
    the int64 sum of each of the seven images and of the histogram per
    image, an (N, 8) tensor."""
    outs, cur = [], x
    for _, stage in ENHANCE_STAGES:
        cur = stage(cur)
        outs.append(cur)
    outs.append(hist_per_image(outs[2]))
    sums = torch.stack([o.reshape(o.shape[0], -1).sum(dim=1, dtype=torch.int64) for o in outs],
                       dim=1)
    return (*outs, sums)


def entry_enhance(device="cuda", shape=SHAPE):
    """``(forward_enhance, (x,))`` with ``make_batch()``'s batch on `device`."""
    return forward_enhance, (torch.from_numpy(make_batch(shape)).to(device),)
