"""Run one cell of the benchmark of opencv_tpu_torch on the card it is
started on and print its result as the last line of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` measures the cell's end-to-end metrics over a window of
``--seconds``; ``--trace 1`` traces a fixed number of batches
(the traffic's ``trace_batches``) and the cell's stages with
``torch.profiler`` and reports its per-layer metrics.  Both check what the
window produced against the plain reference and print each number compared
beside its limit, as the last lines of standard error and under
``checks`` in the result.  Exits non-zero, printing no result, without
enough CUDA devices, or when a forbidden module (JAX or the JAX package)
is loaded at the end.
"""

import time

T0 = time.perf_counter()   # the process's start, as near as Python sees it

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Where bytecode may not be written (PYTHONDONTWRITEBYTECODE, an install
# without __pycache__), every process compiles torch's sources anew, some
# 8 s of set-up on the card's host.  Keep the bytecode of torch and the
# program in the checkout instead, at a fixed path, so that only a
# checkout's first run compiles it.
sys.dont_write_bytecode = False
sys.pycache_prefix = str(ROOT / ".portbench_cache" / "pycache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # kernel caches a later version of the program may use stay in the
    # checkout, at fixed paths (the CUDA library is built into
    # opencv_tpu_torch/_build/ by the program itself)
    cache = ROOT / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    bench = harness.benchmark()
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload)
    if chips is None:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, bench)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T0)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
