"""A run driven on the CPU at a small size, past the harness's look for a
card, with the timed path broken underneath: ``correct`` comes out false
for each fault a cell can have, and true without one.  The host-fed loop,
which no cell uses yet, is driven with the flagship's configuration."""

import json
import time

import pytest
import torch

from portbench import harness
from portbench.faults import FAULTS

CELLS = {"preproc_1080p.b32_resident": None, "resize_warp_4k.b8_resident": None,
         "preproc_1080p.hostfed_b32": ("preproc_1080p.b32_resident", "hostfed_b32")}


def _small(name):
    stand_in = CELLS[name]
    cell = harness.load_cell(stand_in[0] if stand_in else name)
    if stand_in:
        cell.traffic = json.loads((harness.HERE / "traffic" / f"{stand_in[1]}.json").read_text())
    cell.config["frame"].update(height=48, width=80)
    cell.traffic.update(batch=4, ring=2)
    return cell


def _run(cell, entry=None):
    return harness.run_cell(cell, 2 ** 31 + 11, 0.3, False, torch.device("cpu"),
                            time.perf_counter(), entry=entry)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = _run(_small(name))
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", FAULTS.values(), ids=FAULTS.keys())
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_caught(name, fault):
    cell = _small(name)
    r = _run(cell, entry=fault(cell.adapter.call))
    assert not r["correct"] and r["failed"] > 0
