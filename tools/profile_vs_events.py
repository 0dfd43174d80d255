#!/usr/bin/env python3
"""Time each FIX8 kernel of the B1@224 batch-8 forward three ways on one
CUDA card, to tell the profiler's per-forward kernel times from the
CUDA-event times of ``chip_smoke.py``'s ``[kernel]`` lines:

    python3 tools/profile_vs_events.py [--seed N]

For every int8 kernel case of ``chip_smoke.int8_kernel_cases`` and
``chain_cases`` at batch 8, one line with:

- ``events_warm``: ``chip_smoke.device_ms``, back-to-back calls on the
  same inputs (warm in the 50 MB L2), as the ``[kernel]`` lines;
- ``profiler_warm``: ``torch.profiler``'s mean kernel time over the same
  back-to-back calls;
- ``events_cold``: CUDA events around one call after a 256 MB write that
  evicts L2, the median of 10.  A spin of about 0.5 ms keeps the card
  busy between the write and the start event, so the host has enqueued
  the call before the window opens and its wrapper's host time stays
  out of the window.

Then, per kernel, each sum over one forward's calls, beside the
profiler's time inside the served forward (``chip_smoke.kernel_profile``
on ``VisionEngine.quantized``).  Needs a CUDA card; imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def profiler_ms(fn, reps: int = 20) -> float:
    """Mean device time per call of ``fn``'s kernels, from the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import device_us
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(device_us(e) for e in prof.key_averages()) / reps / 1e3


def cold_ms(fn, reps: int = 10) -> float:
    """One call after L2 is evicted, CUDA events, median of ``reps``."""
    import torch
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    out = []
    for _ in range(reps):
        flush.fill_(1.0)
        torch.cuda._sleep(1_000_000)      # ~0.5 ms of clock cycles
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_vs_events: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import subprocess

    import numpy as np
    from chip_smoke import (chain_cases, device_ms, int8_kernel_cases,
                            kernel_profile, randomize_bn)
    from repro_torch.core.efficientvit import B1, init_efficientvit
    from repro_torch.core.quantization import quantize_efficientvit
    from repro_torch.kernels.build import build
    from repro_torch.serving.vision import VisionEngine, VisionServeConfig

    build()
    gen = torch.Generator().manual_seed(args.seed)
    params = init_efficientvit(gen, B1, "cuda")
    randomize_bn(params, gen)
    cases = int8_kernel_cases(8, gen) + chain_cases(
        8, gen, params, quantize_efficientvit(params))[1]
    sums: dict = {}
    for name, sites, label, kfn, *_ in cases:
        t = (device_ms(kfn, reps=20, windows=5), profiler_ms(kfn),
             cold_ms(kfn))
        print(f"[timing] {name} {label} sites={len(sites)}: events_warm "
              f"{t[0]:.5f} ms, profiler_warm {t[1]:.5f} ms, events_cold "
              f"{t[2]:.5f} ms")
        acc = sums.setdefault(name, [0.0, 0.0, 0.0])
        for i in range(3):
            acc[i] += len(sites) * t[i]
    for name, (w, p, c) in sums.items():
        print(f"[timing] {name} per batch-8 forward: events_warm {w:.4f} "
              f"ms, profiler_warm {p:.4f} ms, events_cold {c:.4f} ms")
    engine = VisionEngine.quantized(params, B1,
                                    VisionServeConfig(microbatch=8))
    x8 = torch.from_numpy(np.random.default_rng(args.seed).standard_normal(
        (8, 224, 224, 3)).astype(np.float32)).cuda()
    engine.logits(x8)
    ex = engine.cache.get(8, 224)
    from repro_torch.core.program import execute

    def eager():
        with torch.inference_mode():
            return execute(ex.program, engine.params, x8, plan=ex.plan)
    kernel_profile(lambda: ex(engine.params, x8), eager, "fix8 forward")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
