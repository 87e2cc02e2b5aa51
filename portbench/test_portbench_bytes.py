"""The bytes arithmetic of the configurations: each stage's input read
once and its output written once (PERF.md's and chip_smoke.py phase 5's
terms)."""

import json
from pathlib import Path

CONFIGS = Path(__file__).resolve().parent / "configs"


def _cfg(name):
    with open(CONFIGS / f"{name}.json") as f:
        return json.load(f)


def _plane(cfg, scale=1, channels=None):
    f = cfg["frame"]
    return (f["height"] // scale) * (f["width"] // scale) * (channels or f["channels"])


def test_preproc_1080p_bytes():
    cfg = _cfg("preproc_1080p")
    b = cfg["bytes_per_frame"]
    assert b["in"] == 6_220_800 == _plane(cfg)
    assert b["out"] == 518_400 == _plane(cfg, 2, 1)
    gray = _plane(cfg, 1, 1)
    assert b["stages"] == {"gray": [6_220_800, gray], "blur": [gray, gray],
                           "resize": [gray, 518_400], "warp": [518_400, 518_400]}
    # the forward's bound at batch 32: in + out, 215.7 MB
    assert round((b["in"] + b["out"]) * 32 / 1e6, 1) == 215.7


def test_resize_warp_4k_bytes():
    cfg = _cfg("resize_warp_4k")
    b = cfg["bytes_per_frame"]
    full, half = _plane(cfg), _plane(cfg, 2)
    assert b["in"] == 24_883_200 == full
    assert b["out"] == 3 * half + 2 * full
    stages = b["stages"]
    assert sum(r + w for r, w in stages.values()) == 5 * full + 3 * half + 2 * full
    # every stage's bytes, at batch 4 and at batch 8: 771 MB and 1,542 MB
    per_frame = sum(r + w for r, w in stages.values())
    assert round(per_frame * 4 / 1e6) == 771
    assert int(per_frame * 8 / 1e6) == 1542
