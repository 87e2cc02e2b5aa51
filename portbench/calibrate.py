"""The readings the comparison's limits are set from, on the card at a
cell's own size: for each seed, the cell's ring of batches through the
program's timed entry against the plain reference (the program's
readings), and each control of the reference against it (the controls'
readings, ``reference/common.py``).  With ``--faults 1``, a short run of
the cell for each fault of ``faults.py`` planted under its timed path.
The benchmark's runs do not run this.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 [--controls all,coords]
    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 --faults 1 [--seconds 2]

Prints one JSON line a seed (a seed and fault with ``--faults 1``) and,
last, the largest program reading and the smallest reading of each control
(of each fault) for each number.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _least(readings):
    return {k: min(n[k] for n in readings) for k in readings[0]}


def _readings(cell, seed, controls, dev):
    from portbench import check, harness, loops

    frames = harness.make_frames(cell.config, cell.traffic, seed, dev)
    ring = loops.ring_on(cell.traffic, frames, dev)
    loop = loops.LOOPS[cell.traffic["loop"]]
    kept = harness.Sampler(len(ring), seed, cell.adapter.outputs)
    loop(cell.adapter.call, ring, cell.traffic, dev, lambda i: i >= len(ring), kept)
    line = {"seed": seed,
            "program": check.compare(cell, [(ring[s], o) for _, s, o in kept.kept], dev)[0]}
    del kept
    for low in controls:
        line[low] = check.compare(cell, [(x, None) for x in ring], dev, low=low)[0]
    return line


def _fault_readings(cell, seed, seconds, dev):
    from portbench import harness
    from portbench.faults import FAULTS

    for name, fault in FAULTS.items():
        r = harness.run_cell(cell, seed, seconds, False, dev, time.perf_counter(),
                             entry=fault(cell.adapter.call))
        yield {"seed": seed, "fault": name, "correct": r["correct"], "failed": r["failed"],
               "attempted": r["attempted"], **{k: c["value"] for k, c in r["checks"].items()}}


def main(argv=None) -> int:
    import torch

    from portbench import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--controls", default="all,coords", help="comma-separated, or empty")
    ap.add_argument("--faults", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=2.0, help="each fault's window")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    summary = {"workload": args.workload, "seeds": len(seeds)}
    if args.faults:
        by_fault = {}
        for seed in seeds:
            for line in _fault_readings(cell, seed, args.seconds, dev):
                print(json.dumps(line), flush=True)
                by_fault.setdefault(line["fault"], []).append(line)
        summary["faults"] = {f: {"correct": any(n["correct"] for n in ns),
                                 **_least([{k: n[k] for k in cell.config["limits"]} for n in ns])}
                             for f, ns in by_fault.items()}
    else:
        controls = [c for c in args.controls.split(",") if c]
        lines = []
        for seed in seeds:
            lines.append(_readings(cell, seed, controls, dev))
            print(json.dumps(lines[-1]), flush=True)
        summary["program_max"] = {k: max(n["program"][k] for n in lines)
                                  for k in lines[0]["program"]}
        for low in controls:
            summary[f"{low}_min"] = _least([n[low] for n in lines])
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
