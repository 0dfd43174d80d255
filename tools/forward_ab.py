#!/usr/bin/env python3
"""Time the port's B1@224 batch-8 forward, fp32 and FIX8, for one or more
source trees on one CUDA card, each tree in a process of its own.

    python3 tools/forward_ab.py LABEL=SRC [LABEL=SRC ...] [--seed N]
        [--kernels NAME[,NAME ...]]

``SRC`` is a tree's ``src`` directory (its ``repro_torch`` package and
``csrc`` kernels; each tree builds its own kernels under its own
``build/``).  Run the trees interleaved, e.g. ``parent=P change=src
change=src parent=P``, to compare two commits on one card.  For each
run and precision it prints, with the same measuring code for every
tree (``chip_smoke.device_ms``, CUDA events, the host's enqueue hidden
behind a sleep kernel):

- ``dev1_ms``: device time of one forward (the executor's call: a CUDA
  graph replay where the tree captures one), one forward per event window,
  median of 5 windows (``chip_smoke.py``'s steady state);
- ``dev5_ms``: the same with five forwards per window, median of 3;
- ``host_ms``: the host's time to enqueue one forward, median of 3
  groups of 5 (a synchronize before and after each group);
- ``host_after_profiler_ms`` and ``dev1_after_profiler_ms``: the same
  after ``torch.profiler`` captures of CUDA activity in the process (one
  fp32 and one FIX8 forward's kernels, launches, memsets and zero fills,
  printed as ``chip_smoke.py``'s profiler lines, each beside one eager
  ``execute`` of the same plan).

With ``--kernels NAME[,NAME ...]``, each run also times those kernels
as the ``[kernel]`` cases of the tree's own ``chip_smoke.py``
(``kernel_cases`` and ``int8_kernel_cases``: every B1@224 shape, batch
1 and 8, each tree's builders on its own package) through the wrappers
(``chip_smoke.device_ms``, 20 calls a window, median of 5):
``kernel_ms`` per shape and ``kernel_fwd_ms``, the sum over one batch-8
forward's calls (a case's sites).  A kernel no served forward runs (the
library's ``int8_matmul_emit``, ``dsconv_fused_int8_emit``, ...) is
timed at its ``library_cases`` instead, and its ``kernel_fwd_ms`` is the
sum over those cases, one call each (``chip_smoke.py``'s kernels line).

One JSON line per run, then a summary line per label and metric (the
median over that label's runs), then the card's name and power limit.
Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = ("dev1_ms", "dev5_ms", "host_ms", "host_after_profiler_ms",
           "dev1_after_profiler_ms")


def host_ms(fwd, groups: int = 3, reps: int = 5) -> float:
    import torch
    out = []
    for _ in range(groups):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fwd()
        out.append((time.perf_counter() - t0) / reps * 1e3)
        torch.cuda.synchronize()
    return statistics.median(out)


def tree_smoke(src: str):
    """The ``chip_smoke`` module of the tree whose ``src`` is given,
    loaded under its own name beside this tree's."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(src)),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("tree_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_kernels(src: str, names, seed: int) -> tuple[dict, dict]:
    """-> ({"<kernel> <shape> B=<batch>": ms a call}, {kernel: ms per
    batch-8 forward}) for the ``[kernel]`` cases of ``names``."""
    import torch

    from chip_smoke import device_ms
    smoke = tree_smoke(src)
    per_call, per_fwd = {}, dict.fromkeys(names, 0.0)
    seen = set()
    for batch in (1, 8):
        gen = torch.Generator().manual_seed(seed + batch)
        cases = smoke.kernel_cases(batch, gen) \
            + smoke.int8_kernel_cases(batch, gen)
        for case in cases:
            name, sites, label, fn = case[:4]
            if name not in per_fwd:
                continue
            seen.add(name)
            ms = device_ms(fn)
            per_call[f"{name} {label} B={batch}"] = ms
            if batch == 8:
                per_fwd[name] += len(sites) * ms
        del cases
    if set(names) - seen:
        cases = smoke.library_cases(seed)
        for case, *_ in cases:
            name, _, label, fn = case[:4]
            if name in per_fwd and name not in seen:
                ms = device_ms(fn)
                per_call[f"{name} {label}"] = ms
                per_fwd[name] += ms
        del cases
    return per_call, per_fwd


def one(label: str, src: str, seed: int, kernels=()) -> dict:
    """Build ``src``'s kernels, serve both precisions, time them."""
    sys.path.insert(0, os.path.abspath(src))
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from chip_smoke import device_ms, kernel_profile, randomize_bn
    from repro_torch.core.efficientvit import B1, init_efficientvit
    from repro_torch.kernels.build import build
    from repro_torch.serving.vision import VisionEngine, VisionServeConfig

    build()
    gen = torch.Generator().manual_seed(seed)
    params = init_efficientvit(gen, B1, "cuda")
    randomize_bn(params, gen)
    x8 = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (8, 224, 224, 3)).astype(np.float32)).cuda()
    from repro_torch.core.program import execute

    def eager_of(ex, p):
        def eager():
            with torch.inference_mode():
                return execute(ex.program, p, x8, plan=ex.plan)
        return eager

    fwds, eagers = {}, {}
    for prec in ("fp32", "fix8"):
        cfg = VisionServeConfig(microbatch=8)
        engine = (VisionEngine(params, B1, cfg) if prec == "fp32"
                  else VisionEngine.quantized(params, B1, cfg))
        engine.logits(x8)
        ex = engine.cache.get(8, 224)
        fwds[prec] = lambda ex=ex, p=engine.params: ex(p, x8)
        eagers[prec] = eager_of(ex, engine.params)
    res = {"tree": label, "src": src}
    for prec, fwd in fwds.items():
        res[prec] = {"dev1_ms": device_ms(fwd, reps=1, windows=5),
                     "dev5_ms": device_ms(fwd, reps=5, windows=3),
                     "host_ms": host_ms(fwd)}
    csrc = os.path.join(src, "repro_torch", "csrc")
    kernel_profile(fwds["fp32"], eagers["fp32"], f"{label} fp32", csrc=csrc)
    kernel_profile(fwds["fix8"], eagers["fix8"], f"{label} fix8", csrc=csrc)
    for prec, fwd in fwds.items():
        res[prec]["host_after_profiler_ms"] = host_ms(fwd)
        res[prec]["dev1_after_profiler_ms"] = device_ms(fwd, reps=1,
                                                        windows=5)
    if kernels:
        res["kernel_ms"], res["kernel_fwd_ms"] = time_kernels(
            src, kernels, seed)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="*", metavar="LABEL=SRC")
    ap.add_argument("--one", metavar="LABEL=SRC",
                    help="time one tree in this process (used per run)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", type=lambda v: v.split(","), default=[],
                    metavar="NAME[,NAME]",
                    help="also time these kernels' [kernel] cases of "
                         "chip_smoke.py per shape")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("forward_ab: no CUDA device is available", file=sys.stderr)
        return 1
    if args.one:
        label, src = args.one.split("=", 1)
        print(json.dumps(one(label, src, args.seed, args.kernels)),
              flush=True)
        return 0
    if not args.trees:
        ap.error("give at least one LABEL=SRC")
    runs = []
    for tree in args.trees:
        if not os.path.isdir(os.path.join(tree.split("=", 1)[1],
                                          "repro_torch")):
            print(f"forward_ab: no repro_torch package in {tree}",
                  file=sys.stderr)
            return 1
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", tree,
             "--seed", str(args.seed)]
            + (["--kernels", ",".join(args.kernels)] if args.kernels
               else []),
            capture_output=True, text=True, timeout=900)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode:
            print(proc.stdout[-4000:])
            print(f"forward_ab: {tree} exited {proc.returncode}",
                  file=sys.stderr)
            return 1
        lines = proc.stdout.strip().splitlines()
        print("\n".join(lines[:-1]))
        runs.append(json.loads(lines[-1]))
        print(json.dumps(runs[-1]), flush=True)
    for label in dict.fromkeys(r["tree"] for r in runs):
        mine = [r for r in runs if r["tree"] == label]
        for prec in ("fp32", "fix8"):
            vals = {m: statistics.median(r[prec][m] for r in mine)
                    for m in METRICS}
            print(f"[ab] {label} {prec} over {len(mine)} runs: "
                  + ", ".join(f"{m} {v:.3f}" for m, v in vals.items()))
        for key in ("kernel_fwd_ms", "kernel_ms") if args.kernels else ():
            vals = {k: statistics.median(r[key][k] for r in mine)
                    for k in mine[0][key]}
            print(f"[ab] {label} {key} over {len(mine)} runs: "
                  + ", ".join(f"{k} {v:.5f}" for k, v in vals.items()))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
