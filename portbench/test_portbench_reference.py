"""Each plain reference against the program on the CPU at small shapes,
and the control (the reference one precision down) against the limits."""

import pytest
import torch

from portbench import check, harness

CELLS = {"preproc_1080p": "preproc_1080p.b32_resident",
         "resize_warp_4k": "resize_warp_4k.b8_resident"}
SHAPES = [(2, 64, 96), (1, 120, 200), (2, 270, 480)]


def _cell(config):
    return harness.load_cell(CELLS[config])


def _frames(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (*shape, 3), dtype=torch.uint8, generator=g)


@pytest.mark.parametrize("config", sorted(CELLS))
@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_program(config, shape):
    cell = _cell(config)
    x = _frames(shape, seed=sum(shape))
    outs = cell.adapter.outputs(cell.adapter.call(x))
    want = cell.reference.forward(x, cell.config)
    assert set(outs) == set(want)
    for name, w in want.items():
        assert torch.equal(outs[name], w), name


@pytest.mark.parametrize("low, shape", [("all", (2, 120, 200)), ("coords", (1, 1080, 1920))])
@pytest.mark.parametrize("config", sorted(CELLS))
def test_control_fails_the_limits(config, low, shape):
    """Each control, at a size where it reads: the warps' coordinates in
    float32 move a pixel only where the coordinates are large enough."""
    cell = _cell(config)
    x = _frames(shape, seed=7)
    numbers, failed = check.compare(cell, [(x, None)], torch.device("cpu"), low=low)
    assert failed == 1
    assert "mismatch_ppm" in check.failures(numbers, cell.config["limits"])


@pytest.mark.parametrize("config", sorted(CELLS))
def test_program_passes_the_limits(config):
    cell = _cell(config)
    x = _frames((2, 120, 200), seed=8)
    outs = cell.adapter.outputs(cell.adapter.call(x))
    numbers, failed = check.compare(cell, [(x, outs)], torch.device("cpu"))
    assert failed == 0 and not check.failures(numbers, cell.config["limits"])
    assert numbers["max_abs_diff"] == 0 and numbers["mismatch_ppm"] == 0
