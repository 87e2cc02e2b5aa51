"""On the card: one short run of each cell through the command, its result
read from the last line of standard output.  Skips without a CUDA device."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct(card, cell, trace):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          str(2 ** 31 + 101), "--seconds", "2", "--trace", str(trace)],
                         capture_output=True, text=True, timeout=900, cwd=HERE.parent)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    names = {m["name"] for m in BENCH["per_layer" if trace else "end_to_end"]
             if cell in m.get("workloads", [cell])}
    assert set(r["metrics"]) == names
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        # no share of a roofline passes 100%
        for name, m in r["metrics"].items():
            if name.endswith("_roofline_pct"):
                assert 0 < m["value"] <= 100, (name, m["value"])
