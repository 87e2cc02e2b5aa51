"""Every cell of BENCHMARK.json resolves to its configuration, traffic,
reference and metric files, and the file keeps to the benchmark's
contract on names, units, keys and sizes."""

import json
import re

import pytest

from portbench import harness, loops

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = harness.load_cell(cell, BENCH)
    assert c.traffic["loop"] in loops.LOOPS
    for fn in ("call", "outputs", "stages"):
        assert callable(getattr(c.adapter, fn))
    assert callable(c.reference.forward)
    assert set(c.config["limits"]) >= {"max_abs_diff", "mismatch_ppm"}
    for m in c.per_layer:
        assert harness.reader(m["name"]).exists()
    for stage in c.config["stages"]:
        assert stage in c.config["bytes_per_frame"]["stages"]
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer


def test_names_units_and_keys():
    metric_keys = {"name", "unit", "better", "source"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == metric_keys | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == metric_keys | {"layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m["workloads"]) <= set(CELLS)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    seen = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(seen) == len(set(seen))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_per_layer_reported_where_listed():
    """Every cell reports at least one per-layer metric and the end-to-end
    metric each of its per-layer metrics moves; a metric whose reader needs
    a stage names only cells whose configuration has it."""
    for w in BENCH["workloads"]:
        c = harness.load_cell(w["name"], BENCH)
        reported = {m["name"] for m in c.end_to_end}
        stages = set(c.config["stages"])
        for m in c.per_layer:
            assert m["moves"] in reported, (w["name"], m["name"])
            if m["name"].endswith("_roofline_pct"):
                assert m["name"][: -len("_roofline_pct")] in stages


def test_split_metrics_read_their_quantity():
    """An end-to-end metric named <quantity>.<cells> is its quantity."""
    quantities = {"mpx_per_s", "batch_p95_ms", "peak_device_gib", "setup_s"}
    for m in BENCH["end_to_end"]:
        assert m["name"].split(".")[0] in quantities
