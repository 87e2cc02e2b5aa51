"""The port's ONNX executor against opencv_tpu.dnn's on the CPU: GridSample,
RoiAlign, Attention and the Region decode.  As
tests/test_torch_dnn_ops.py: the same ONNX bytes through both packages;
floats within its FLOAT_TOL."""

import numpy as np
import pytest

from torch_threads import _one_torch_thread  # noqa: F401
from test_dnn_trackers import _node, _tensor
from test_torch_dnn_ops import RNG, assert_agree, run_both


@pytest.mark.parametrize("mode,pad_mode,align", [
    ("linear", "zeros", 0), ("linear", "border", 0), ("linear", "reflection", 0),
    ("linear", "reflection", 1), ("linear", "zeros", 1), ("nearest", "zeros", 0)])
def test_grid_sample(mode, pad_mode, align):
    x = RNG.normal(0, 1, (2, 3, 7, 9)).astype(np.float32)
    grid = RNG.uniform(-1.3, 1.3, (2, 5, 6, 2)).astype(np.float32)
    assert_agree(*run_both([_node("GridSample", ["x", "g"], ["y"], mode=mode,
                                  padding_mode=pad_mode, align_corners=align)],
                           [], {"x": x, "g": grid}))


@pytest.mark.parametrize("sr,cmode,const", [(2, "half_pixel", False), (0, "half_pixel", True),
                                            (0, "output_half_pixel", False)])
def test_roi_align(sr, cmode, const):
    x = RNG.normal(0, 1, (2, 2, 12, 14)).astype(np.float32)
    rois = np.array([[1.0, 1.0, 9.0, 8.0], [0.0, 0.0, 13.0, 11.0], [-3, 2, 4, 20]], np.float32)
    bi = np.asarray([0, 1, 1], np.float32)
    node = _node("RoiAlign", ["x", "r", "bi"], ["y"], output_height=3, output_width=4,
                 sampling_ratio=sr, spatial_scale=0.5, coordinate_transformation_mode=cmode)
    feeds = {"x": x, "bi": bi}
    inits = [_tensor("r", rois)] if const else []
    if not const:
        feeds["r"] = rois
    assert_agree(*run_both([node], inits, feeds))


@pytest.mark.parametrize("form", range(5))
def test_attention(form):
    B, nh, S, D = 2, 2, 5, 4
    if form == 4:           # com.microsoft fused QKV
        x = RNG.normal(0, 1, (B, S, 8)).astype(np.float32)
        W = RNG.normal(0, 0.3, (8, 24)).astype(np.float32)
        b = RNG.normal(0, 0.3, 24).astype(np.float32)
        assert_agree(*run_both([_node("Attention", ["x", "W", "b"], ["y"], num_heads=2,
                                      qkv_hidden_sizes=[8, 8, 8])],
                               [_tensor("W", W), _tensor("b", b)], {"x": x}))
        return
    attrs, shp = [({}, (B, nh, S, D)), ({"is_causal": 1}, (B, nh, S, D)),
                  ({"q_num_heads": nh, "kv_num_heads": nh}, (B, S, nh * D)),
                  ({"scale": 0.3}, (B, nh, S, D))][form]
    q, k, v = (RNG.normal(0, 1, shp).astype(np.float32) for _ in range(3))
    ins = ["q", "k", "v"]
    inits = []
    if form == 3:
        ins.append("mask")
        inits.append(_tensor("mask", RNG.normal(0, 1, (S, S)).astype(np.float32)))
    assert_agree(*run_both([_node("Attention", ins, ["y"], **attrs)], inits,
                           {"q": q, "k": k, "v": v}))


@pytest.mark.parametrize("yolo", [True, False])
def test_region(yolo):
    """The Region decode of a YOLO head (logistic classes, normalised by
    the net input) and of a v2 region (softmax, grid units, classfix)."""
    A, classes = 3, 4
    head = RNG.normal(0, 1.5, (2, 5, 6, A * (5 + classes))).astype(np.float32)
    anch = np.asarray([10, 14, 23, 27, 37, 58], np.float32)
    attrs = dict(classes=classes, anchors=A, thresh=0.3)
    ins = ["h", "an"]
    feeds = {"h": head}
    if yolo:
        attrs.update(logistic=1, scale_x_y=1.05)
        ins.append("d")
        feeds["d"] = np.zeros((2, 3, 40, 48), np.float32)
    else:
        attrs.update(softmax=1, classfix=-1)
    assert_agree(*run_both([_node("Region", ins, ["y"], **attrs)], [_tensor("an", anch)],
                           feeds))
    attrs["new_coords"] = 1
    assert_agree(*run_both([_node("Region", ins, ["y"], **attrs)], [_tensor("an", anch)],
                           feeds))
