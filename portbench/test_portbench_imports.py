"""The import guard: the benchmark's run loads neither JAX nor the JAX
package, whose name the port's begins with, so top-level module names are
compared whole; and nothing of the harness reads the JAX package's
benchmark files."""

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

PROBE = r"""
import importlib.util, json, sys
from pathlib import Path
here = Path(sys.argv[1])
sys.path.insert(0, str(here.parent))
spec = importlib.util.spec_from_file_location("portbench_run", here / "run.py")
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)
from portbench import harness, calibrate
bench = harness.benchmark()
for w in bench["workloads"]:
    cell = harness.load_cell(w["name"], bench)
    for m in cell.per_layer:
        harness.load_module(harness.HERE / "metrics" / f"{m['name']}.py")
import opencv_tpu_torch.gapi
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_no_jax_in_a_fresh_process():
    out = subprocess.run([sys.executable, "-c", PROBE, str(HERE)], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "opencv_tpu_torch" in top and "portbench" in top
    assert not top & {"jax", "jaxlib", "flax", "opencv_tpu", "bench", "perf", "chip_smoke"}


def test_forbidden_names_are_compared_whole():
    from portbench import harness
    saved = dict(sys.modules)
    try:
        sys.modules["opencv_tpu_torch_probe"] = sys
        assert "opencv_tpu" not in harness.forbidden_modules()
        sys.modules["opencv_tpu.x"] = sys
        assert "opencv_tpu" in harness.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_harness_reads_no_jax_benchmark_files():
    for path in HERE.rglob("*.py"):
        if path.name.startswith("test_"):
            continue
        text = path.read_text()
        for name in ("bench.py", "perf/", "BENCH_", "BASELINE", "import jax",
                     "opencv_tpu.", "from opencv_tpu "):
            assert name not in text, f"{path.name} names {name}"
