#!/usr/bin/env python3
"""Whether ``chip_smoke.kernel_profile``'s gate holds as the process ages
and the profiler's host and device clocks part, on one CUDA card:

    python3 tools/profile_replays.py [--reps N] [--until S] [--models B1,B2]

For each model at 224 px (random weights from ``--seed``), fp32 and FIX8,
a ``VisionEngine`` with buckets (1, 8) is warmed.  Then the engines'
batch-8 graph replays and eager forwards go through ``kernel_profile`` in
turn, ``--reps`` rounds and on until the process is ``--until`` seconds
old.  One line per capture that fails the gate; one line per round: the
process's age and each range's first kernel start less its host start
(below 0: the device times read early), smallest and largest; then a
summary.  Exits non-zero if any capture failed.  Needs a CUDA card;
imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = time.perf_counter()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--until", type=float, default=0.0)
    ap.add_argument("--models", default="B1,B2,B3")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_replays: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import numpy as np
    from chip_smoke import kernel_profile, randomize_bn
    from repro_torch.core import efficientvit
    from repro_torch.core.program import execute
    from repro_torch.kernels.build import build
    from repro_torch.serving.vision import VisionEngine, VisionServeConfig

    build()
    x8 = torch.from_numpy(np.random.default_rng(args.seed).standard_normal(
        (8, 224, 224, 3)).astype(np.float32)).cuda()
    scfg = VisionServeConfig(microbatch=8, buckets=(1, 8))
    forwards = []
    for name in args.models.split(","):
        cfg = getattr(efficientvit, name)
        gen = torch.Generator().manual_seed(args.seed)
        params = efficientvit.init_efficientvit(gen, cfg, "cuda")
        randomize_bn(params, gen)
        for prec in ("fp32", "fix8"):
            eng = (VisionEngine(params, cfg, scfg) if prec == "fp32" else
                   VisionEngine.quantized(params, cfg, scfg)).warmup()
            ex = eng.cache.get(8, 224)

            def eager(ex=ex, eng=eng):
                with torch.inference_mode():
                    return execute(ex.program, eng.params, x8, plan=ex.plan)
            forwards.append((f"{name} {prec}",
                             lambda ex=ex, eng=eng: ex(eng.params, x8), eager))
    runs = bad = rnd = 0
    low = high = None
    while rnd < args.reps or time.perf_counter() - T0 < args.until:
        offsets = []
        for tag, fwd, eager in forwards:
            out = io.StringIO()
            runs += 1
            try:
                with contextlib.redirect_stdout(out):
                    offsets += kernel_profile(fwd, eager, tag)
            except AssertionError as e:
                bad += 1
                print(f"[replays] {tag}: {e}")
                print(out.getvalue().splitlines()[-1])
        rnd += 1
        if offsets:
            low = min(offsets + ([low] if low is not None else []))
            high = max(offsets + ([high] if high is not None else []))
            print(f"[replays] round {rnd} at {time.perf_counter() - T0:.1f} "
                  f"s: first kernel start less host start {min(offsets):.1f}"
                  f" .. {max(offsets):.1f} us")
    print(f"[replays] all: {runs} captures over {rnd} rounds to "
          f"{time.perf_counter() - T0:.1f} s, {bad} failed the gate; first "
          f"kernel start less host start {low:.1f} .. {high:.1f} us")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
