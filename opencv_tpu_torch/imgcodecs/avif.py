"""AVIF codec adapter (reference: modules/imgcodecs/src/grfmt_avif.cpp).

The reference implements AVIF as a thin adapter over the libavif
library (3rdparty dependency); this module takes the same architectural
position over the libavif build shipped in this image (via pillow's
avif plugin).  Decode output is BIT-IDENTICAL to the reference wheel's
(both run the same libavif/libaom decode — verified in
tests/test_avif.py).

Falls back cleanly (raises ValueError from decode, unsupported from
encode) when the avif plugin is unavailable, mirroring a wheel built
without libavif.

Twin of ``opencv_tpu/imgcodecs/avif.py``.
"""

from __future__ import annotations

import io

import numpy as np

__all__ = ["avif_decode", "avif_decode_all", "avif_encode",
           "have_avif", "is_avif"]


def have_avif() -> bool:
    try:
        from PIL import features
        return bool(features.check("avif"))
    except Exception:
        return False


def is_avif(data: bytes) -> bool:
    # ISO-BMFF: ftyp box with an avif/avis major/compatible brand
    if len(data) < 12 or data[4:8] != b"ftyp":
        return False
    return b"avif" in data[8:32] or b"avis" in data[8:32]


def _pil_to_bgr(im):
    has_alpha = im.mode in ("RGBA", "LA", "PA") or \
        (im.mode == "P" and "transparency" in im.info)
    if has_alpha:
        a = np.asarray(im.convert("RGBA"))
        return a[..., [2, 1, 0, 3]].copy()
    a = np.asarray(im.convert("RGB"))
    return a[..., ::-1].copy()


def avif_decode(data: bytes):
    from PIL import Image
    try:
        im = Image.open(io.BytesIO(data))
        im.load()
    except Exception as e:
        raise ValueError(f"avif decode failed: {e}") from e
    return _pil_to_bgr(im)


def avif_decode_all(data: bytes):
    """All frames of an animated AVIF (avis), BGR list."""
    from PIL import Image, ImageSequence
    im = Image.open(io.BytesIO(data))
    return [_pil_to_bgr(f.copy()) for f in ImageSequence.Iterator(im)]


# ---------------------------------------------------------------------------
# Direct libavif lossless path (q100): the PIL plugin exposes no
# matrix-coefficients control, so color q100 through it keeps a ±2 BT.601
# round-trip.  The reference's grfmt_avif.cpp sets MC=identity at q100;
# we do the same by driving the system libavif directly — identity MC +
# 4:4:4 means the "YUV" planes are literally G,B,R, so no color
# transform happens at all and the encode is exactly lossless.
# ABI note: field offsets below are for libavif 0.11.x and are verified
# at runtime (version string + plane geometry anchors) before use.
# ---------------------------------------------------------------------------

_NATIVE_OK = None


def _native_lib():
    """True when the system libavif is present for the lossless worker.
    The library must NOT be dlopened in this process: PIL's bundled
    libavif/libaom exports collide with it (symbol interposition
    segfaults inside the encoder), which is why the actual encode runs
    in the _avif_worker.py subprocess."""
    global _NATIVE_OK
    if _NATIVE_OK is None:
        import ctypes.util
        import os
        _NATIVE_OK = bool(
            os.path.exists("/usr/lib/x86_64-linux-gnu/libavif.so.15")
            or ctypes.util.find_library("avif"))
    return True if _NATIVE_OK else None


def _native_lossless_encode(a, speed=6):
    """Identity-MC 4:4:4 lossless encode of BGR/BGRA uint8 via the
    subprocess worker.  Returns bytes or None if unavailable."""
    global _NATIVE_OK
    if _native_lib() is None:
        return None
    import os
    import subprocess
    import sys
    h, w = a.shape[:2]
    ch = 1 if a.ndim == 2 else a.shape[2]
    worker = os.path.join(os.path.dirname(__file__), "_avif_worker.py")
    try:
        r = subprocess.run(
            [sys.executable, worker, str(w), str(h), str(ch),
             str(max(0, min(10, int(speed))))],
            input=np.ascontiguousarray(a).tobytes(),
            capture_output=True, timeout=300)
    except Exception:
        _NATIVE_OK = False
        return None
    if r.returncode != 0 or not r.stdout:
        _NATIVE_OK = False
        return None
    return r.stdout


def avif_encode(img, params=None) -> bytes:
    """Encode BGR/BGRA/gray uint8 (or uint16 via 8-bit downshift, as a
    depth-8 encode) honoring IMWRITE_AVIF_QUALITY (default 95) and
    IMWRITE_AVIF_SPEED (ignored by the PIL plugin's default encoder
    settings beyond mapping to `speed`)."""
    from PIL import Image
    from .. import constants as K
    quality = 95
    speed = 6
    if params:
        p = list(params)
        for i in range(0, len(p) - 1, 2):
            if p[i] == getattr(K, "IMWRITE_AVIF_QUALITY", 512):
                quality = int(p[i + 1])
            elif p[i] == getattr(K, "IMWRITE_AVIF_SPEED", 514):
                speed = int(p[i + 1])
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = np.clip(a, 0, 255).astype(np.uint8)
    if a.ndim == 2:
        pil = Image.fromarray(a, "L")
    elif a.shape[2] == 4:
        pil = Image.fromarray(a[..., [2, 1, 0, 3]], "RGBA")
    else:
        pil = Image.fromarray(a[..., ::-1], "RGB")
    buf = io.BytesIO()
    kw = {"quality": max(0, min(100, quality)),
          "speed": max(0, min(10, speed))}
    if quality >= 100:
        # q100 = exactly lossless, like the reference's grfmt_avif.cpp:
        # GRAY via the PIL plugin (YUV400 has no color matrix; aom
        # pinned lossless), COLOR via direct libavif with MC=identity
        # (the PIL plugin exposes no MC control — see
        # _native_lossless_encode above).
        if a.ndim == 3:
            data = _native_lossless_encode(a, speed=kw["speed"])
            if data is not None:
                return data
        kw["subsampling"] = "4:4:4"
        kw["advanced"] = {"lossless": "1"}
    pil.save(buf, format="AVIF", **kw)
    return buf.getvalue()
