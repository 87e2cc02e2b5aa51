#!/usr/bin/env python3
"""Registers, spills and SASS instruction counts of the gauss5_down2 kernels
of one or more checkouts, for comparing their designs.

    python3 perf/sass_count.py ROOT [ROOT ...] [--out chiprun_out/sass]
    python3 perf/sass_count.py --listing FILE [FILE ...]

Each ROOT holds ``opencv_tpu_torch/csrc/fused_preproc.cu``; it is compiled
to a cubin with the flags of ``kernels/_build.py`` and ``-Xptxas -v``
(printed), and ``cuobjdump -sass`` of it is saved under ``--out``.  Needs
``nvcc`` and ``cuobjdump`` (the GPU machine); ``--listing`` counts a saved
listing instead, anywhere.

For every kernel it prints its innermost loops (a backward branch and its
target; the out-of-line handlers of divergent shuffles, after the first
``BRA.DIV`` target, branch back into the body and are not loops): their
instructions, loads and stores, as written, not as executed (a branch
inside a loop counts whole).
  - The strip kernel (``gauss5_down2_kernel<PX, BGR, VEC>``): its row loop
    (the largest) computes three output rows from six input rows of PX
    pixels a lane: instructions per input pixel = the loop over 6 PX.
  - The first design's kernel (no template): a tile loop's instructions per
    element (the loop over its stores: a gray pixel, a row sum or an output
    each), and per input pixel with 36 x 132 gray pixels, 36 x 128 row sums
    and 16 x 64 outputs for a tile's 32 x 128 input pixels; its phase-1
    copies hold the BGR and the gray paths both.
"""

from __future__ import annotations

import argparse
import collections
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
FUNC = re.compile(r"Function\s*:\s*(\S+)")
TARGET = re.compile(r"BRA(?:\.\S+)?\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def parse(listing: str) -> dict:
    """{function: [(address, opcode, text)], labels} of a cuobjdump -sass listing."""
    funcs, cur = {}, None
    pending = []
    for line in listing.splitlines():
        m = FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), {"insns": [], "labels": {}})
            continue
        if cur is None:
            continue
        m = LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = INSN.search(line)
        if m:
            addr, text = int(m.group(1), 16), m.group(2)
            for lab in pending:
                cur["labels"][lab] = addr
            pending = []
            op = re.sub(r"^@!?U?P\w+\s+", "", text).split()[0]
            cur["insns"].append((addr, op, text))
    return funcs


def loops(func: dict) -> list:
    """(start, end) address spans of the innermost loops."""
    div = [int(m.group(1), 16) for _, op, text in func["insns"] if op.startswith("BRA.DIV")
           for m in [re.search(r"(0x[0-9a-f]+)\s*$", text)] if m]
    body_end = min(div) if div else float("inf")
    spans = []
    for addr, op, text in func["insns"]:
        if not op.startswith("BRA") or addr >= body_end:
            continue
        m = TARGET.search(text)
        if not m:
            continue
        tgt = func["labels"].get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if tgt is not None and tgt < addr:
            spans.append((tgt, addr))
    inner = [s for s in spans if not any(o != s and s[0] <= o[0] and o[1] <= s[1] for o in spans)]
    return sorted(set(inner))


def count(func: dict, span) -> tuple[int, collections.Counter]:
    ops = collections.Counter(op.split(".")[0] for a, op, _ in func["insns"]
                              if span[0] <= a <= span[1])
    return sum(ops.values()), ops


# a tile's elements per input pixel, by phase (the first design)
TILE_ELEMENTS = {"gray tile": 36 * 132 / 4096, "row sums": 36 * 128 / 4096,
                 "outputs": 16 * 64 / 4096}


def report(listing: str, label: str) -> None:
    for name, func in parse(listing).items():
        if "gauss5_down2" not in name:
            continue
        sizes = [count(func, s) for s in loops(func)]
        print(f"[{label}] {name}: {len(func['insns'])} instructions; innermost loops: " + "; ".join(
            f"{n} ({ops['LDG']} LDG, {ops['LDS']} LDS, {ops['STS']} STS, {ops['STG']} STG)"
            for n, ops in sizes))
        m = re.search(r"gauss5_down2_kernelILi(\d+)E", name)
        if m and sizes:
            px = int(m.group(1))
            n, ops = max(sizes, key=lambda s: s[0])
            print(f"  row loop: {n} instructions for 6 rows of {px} px a lane = "
                  f"{n / (6 * px):.2f} per input pixel; {dict(ops.most_common(12))}")
        elif not m:
            per_px = []
            for n, ops in sizes:
                stores = ops["STS"] + ops["STG"]
                what = ("outputs" if ops["STG"] else "row sums" if ops["LDS"] else "gray tile")
                print(f"  {what} loop: {n} instructions, {stores} stores: "
                      f"{n / stores:.2f} per element, {n / stores * TILE_ELEMENTS[what]:.2f} "
                      f"per input pixel")
                per_px.append((what, n / stores * TILE_ELEMENTS[what]))
            gray = [v for w, v in per_px if w == "gray tile"]
            rest = {w: v for w, v in per_px if w != "gray tile"}
            if gray and rest:
                print(f"  per input pixel: gray tile {min(gray):.2f}-{max(gray):.2f} (the copies) "
                      f"+ the largest row-sum and output loops "
                      f"{max(v for w, v in per_px if w == 'row sums'):.2f} + "
                      f"{max(v for w, v in per_px if w == 'outputs'):.2f}")


def compile_root(root: Path, out: Path) -> str:
    from opencv_tpu_torch.kernels import _build
    src = root / "opencv_tpu_torch" / "csrc" / "fused_preproc.cu"
    out.mkdir(parents=True, exist_ok=True)
    tag = root.resolve().name or "root"
    cubin = out / f"{tag}_fused_preproc.cubin"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    res = subprocess.run([_build._nvcc(), *flags, "-Xptxas", "-v", "-I", str(src.parent), "-cubin",
                          "-o", str(cubin), str(src)], capture_output=True, text=True, timeout=600)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr}")
    print(f"[{tag}] ptxas -v:\n" + "\n".join(
        line for line in res.stderr.splitlines() if "gauss5" in line or "registers" in line
        or "spill" in line))
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(cubin)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    (out / f"{tag}_fused_preproc.sass").write_text(sass)
    return sass


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--listing", nargs="*", default=[])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "sass"))
    args = ap.parse_args()
    for f in args.listing:
        report(Path(f).read_text(), Path(f).name)
    for root in args.roots:
        report(compile_root(Path(root), Path(args.out)), Path(root).resolve().name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
