"""Build and load the port's native host tails (``native/hosttails.cpp``).

At the first call, one ``g++ -O3 -shared -fPIC -std=c++17`` compiles the
source into ``opencv_tpu_torch/_build/`` under a name that carries a hash of
the source and the flags, so an edit rebuilds and an unchanged tree reuses
the file.  It is written to a temporary name and moved into place with
``os.replace``, so processes that build at the same time never load a
half-written file.  The compiler is ``$CXX``, else ``g++``.  A missing
compiler or a failed build raises: nothing falls back to Python.

Every pointer is declared ``c_void_p`` (an undeclared Python int is passed
as a 32-bit C int and cuts the pointer).  ctypes releases the GIL for the
length of a call, so floods of several frames run in parallel threads.

The functions take and return host numpy arrays:

- :func:`suzuki_contours` — findContours' border following;
- :func:`flood_fill` — the u8 flood fill, in place;
- :func:`maxflow_grid` — GrabCut's min cut on the 8-neighbour grid;
- :func:`watershed` — the marker-controlled flood, in place;
- :func:`mser_detect` — MSER's stable regions of one polarity.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["CXX_FLAGS", "library", "suzuki_contours", "flood_fill", "maxflow_grid",
           "watershed", "mser_detect"]

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "hosttails.cpp"
BUILD_DIR = _DIR.parent / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# (restype, argtypes) of each entry point
_SIGNATURES = {
    "suzuki_contours": (_I, [_P, _I, _I, _P, ctypes.c_int64, _P, _P, _P, ctypes.c_int32]),
    "flood_fill_u8": (ctypes.c_int64, [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _I, _I,
                                       ctypes.c_uint8, _P]),
    "maxflow_grid": (ctypes.c_double, [_I, _I, _P, _P, _P, _P, _P, _P, _P]),
    "watershed_u8c3": (ctypes.c_int, [_P, _P, _I, _I]),
    "mser_detect": (_I, [_P, _I, _I, _I, _I, _I, ctypes.c_double, ctypes.c_double, _P, _P, _I]),
}

_lock = threading.Lock()
_lib = None


def _compiler() -> str:
    for cand in (os.environ.get("CXX"), "g++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no C++ compiler ($CXX, g++): the native host tails cannot be built")


def _library_path(cxx: str) -> Path:
    h = hashlib.sha256(" ".join([os.path.basename(cxx), *CXX_FLAGS]).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libhosttails_{h.hexdigest()[:16]}.so"


def _build(so: Path, cxx: str) -> None:
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = BUILD_DIR / f"{so.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so"
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}) on {SOURCE}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)


def library() -> ctypes.CDLL:
    """The loaded host-tail library, built first if this tree has no copy."""
    global _lib
    with _lock:
        if _lib is None:
            cxx = _compiler()
            so = _library_path(cxx)
            if not so.exists():
                _build(so, cxx)
            lib = ctypes.CDLL(str(so))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib


def suzuki_contours(binary: np.ndarray):
    """Suzuki-Abe border following of the (H, W) image (nonzero is
    foreground): ``(points, parents, is_outer)``, one (k, 2) int32 array of
    (x, y) per border in the order the raster scan finds them.

    The buffers start at the JAX package's sizes; a scan that overruns them
    returns n < 0 and runs again with both doubled, up to H*W + 1 borders
    and 16 times the first point buffer, past which it raises."""
    f = np.ascontiguousarray(binary != 0, np.uint8)
    H, W = f.shape
    max_pts = max(4 * H * W, 1024)
    max_ctrs = max(H * W // 2, 64)
    # every border starts at a pixel of its own
    ctr_cap = H * W + 1
    pts_cap = 16 * max_pts
    while True:
        pts = np.empty((max_pts, 2), np.int32)
        starts = np.empty(max_ctrs + 1, np.int32)
        parents = np.empty(max_ctrs, np.int32)
        is_outer = np.empty(max_ctrs, np.uint8)
        n = library().suzuki_contours(f.ctypes.data, H, W, pts.ctypes.data, max_pts,
                                      starts.ctypes.data, parents.ctypes.data,
                                      is_outer.ctypes.data, max_ctrs)
        if n >= 0:
            break
        if max_pts >= pts_cap and max_ctrs >= ctr_cap:
            raise RuntimeError(f"suzuki_contours: {H}x{W} overran {max_pts} points and "
                               f"{max_ctrs} contours")
        max_pts = min(2 * max_pts, pts_cap)
        max_ctrs = min(2 * max_ctrs, ctr_cap)
    out = np.split(pts[:starts[n]].copy(), starts[1:n]) if n else []
    return out, parents[:n].copy(), is_outer[:n].astype(bool)


def flood_fill(img: np.ndarray, mask: np.ndarray, seed, new_val, lo, up, conn: int,
               fixed_range: bool, mask_only: bool, mask_val: int):
    """Flood-fill the (H, W) or (H, W, C) u8 `img` and its (H+2, W+2) u8
    `mask` in place from `seed` (x, y); ``(count, rect)``."""
    a = img if img.flags.c_contiguous else np.ascontiguousarray(img)
    if not mask.flags.c_contiguous or mask.dtype != np.uint8:
        raise ValueError("flood_fill: the mask must be a contiguous u8 array")
    C = a.shape[2] if a.ndim == 3 else 1
    nv = np.resize(np.asarray(new_val, np.uint8).reshape(-1)[:C], C)
    lo = np.resize(np.asarray(lo, np.float64).reshape(-1)[:C], C)
    up = np.resize(np.asarray(up, np.float64).reshape(-1)[:C], C)
    rect = np.zeros(4, np.int32)
    count = library().flood_fill_u8(
        a.ctypes.data, mask.ctypes.data, a.shape[0], a.shape[1], C, int(seed[0]), int(seed[1]),
        nv.ctypes.data, lo.ctypes.data, up.ctypes.data, conn, int(fixed_range), int(mask_only),
        mask_val, rect.ctypes.data)
    if a is not img:
        img[...] = a
    return int(count), tuple(int(v) for v in rect)


def maxflow_grid(srcw, snkw, leftw, upleftw, upw, uprightw) -> np.ndarray:
    """The minimum cut of GrabCut's grid graph: the (H, W) bool source side,
    from the f64 terminal capacities and the four symmetric n-link planes."""
    H, W = srcw.shape
    arrs = [np.ascontiguousarray(a, np.float64)
            for a in (srcw, snkw, leftw, upleftw, upw, uprightw)]
    out = np.zeros((H, W), np.uint8)
    library().maxflow_grid(H, W, *(a.ctypes.data for a in arrs), out.ctypes.data)
    return out.astype(bool)


def watershed(img: np.ndarray, markers: np.ndarray) -> None:
    """Flood the contiguous (H, W) int32 `markers` in place over the
    (H, W, 3) u8 `img` (cv::watershed's semantics)."""
    if not markers.flags.c_contiguous or markers.dtype != np.int32:
        raise ValueError("watershed: the markers must be a contiguous int32 array")
    im = np.ascontiguousarray(img, np.uint8)
    H, W = markers.shape
    library().watershed_u8c3(im.ctypes.data, markers.ctypes.data, H, W)


def mser_detect(img: np.ndarray, delta=5, min_area=60, max_area=14400,
                max_variation=0.25, min_diversity=0.2, max_out=4096):
    """MSER's stable regions of one polarity of the (H, W) u8 `img`:
    ``(seeds, levels)``, int32, at most `max_out` of them (the JAX
    package's cap); each region is the pixels 4-connected to its seed at
    or below its level."""
    a = np.ascontiguousarray(img, np.uint8)
    H, W = a.shape
    seeds = np.zeros(max_out, np.int32)
    levels = np.zeros(max_out, np.int32)
    n = library().mser_detect(a.ctypes.data, H, W, int(delta), int(min_area), int(max_area),
                              float(max_variation), float(min_diversity), seeds.ctypes.data,
                              levels.ctypes.data, max_out)
    return seeds[:n], levels[:n]
