#!/usr/bin/env python3
"""Run chosen path phases of ``chip_smoke.py`` alone on one card.

    python3 perf/smoke_phases.py [s] [w] [x] [y] [z]

``s`` stitching (4s), ``w`` RGB-D fusion (4w), ``x`` stabilisation (4x),
``y`` JPEG in, PNG out (4y), ``z`` a HuffYUV AVI in, an FFV1 AVI out (4z);
all five when none is named.  Each is the
phase function ``chip_smoke.py`` runs, with the same launch counting, gates,
logs and wall budget.  The kernels are built first, and the card is warmed
as the earlier phases of a whole run would warm it (a small stabilisation,
the phase correlation's FFT, the profiler): without that the first phase
pays ~15 s of start-up inside its wall.  Stitching takes
``make_pan_video()``'s frames, as the whole run passes it the registration
phase's.  Ends with ``{"ok": true}``; exits 1 without a CUDA device."""

import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as S  # noqa: E402

PHASES = {"s": "phase_stitch", "w": "phase_fusion", "x": "phase_videostab", "y": "phase_codec",
          "z": "phase_videoio"}


def main(which) -> int:
    if not torch.cuda.is_available():
        print("smoke_phases: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from opencv_tpu_torch import entry as E
    from opencv_tpu_torch.kernels import KERNELS, _build
    from opencv_tpu_torch.kernels.sepfilter import SEP_FILTER
    from opencv_tpu_torch.ops.filter import gaussian_kernel_bitexact, gaussian_kernel_fixedpoint_ed
    card = S.card_line()
    S.log(f"card: {card}")
    t0 = time.perf_counter()
    _build.library()
    S.log(f"build: {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)

    def run_counted(fn):
        torch.cuda.synchronize()
        for k in KERNELS:
            k.reset()
        result = fn()
        torch.cuda.synchronize()
        return result, {**{k.symbol: k.launches for k in KERNELS},
                        "sep_filter routes": dict(SEP_FILTER.routes)}

    t0 = time.perf_counter()
    small = torch.from_numpy(E.make_motion_video((4, 270, 480, 3))[0]).to(dev)
    E.videostab_truth_report(E.forward_videostab(small), np.zeros((4, 2)), small.shape)
    S.busy_share(lambda: small.float().sum(), iters=1, warmup=False, host_ops=False)
    torch.cuda.synchronize()
    S.log(f"warm-up: {time.perf_counter() - t0:.1f} s")
    syms = [k.symbol for k in KERNELS]
    k7 = tuple(int(v) for v in
               gaussian_kernel_fixedpoint_ed(gaussian_kernel_bitexact(7, 2.0), 8))
    for w in which:
        fn = getattr(S, PHASES[w])
        if w == "s":
            cnt = fn(E, run_counted, S.count_syncs, dev, card, syms, k7, pan=E.make_pan_video())
        else:
            cnt = fn(E, run_counted, S.count_syncs, dev, card, syms)
        S.log(f"phase 4{w} launches: {cnt}")
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    args = sys.argv[1:] or list(PHASES)
    unknown = [a for a in args if a not in PHASES]
    if unknown:
        sys.exit(f"smoke_phases: unknown phases {unknown}; choose from {sorted(PHASES)}")
    sys.exit(main(args))
