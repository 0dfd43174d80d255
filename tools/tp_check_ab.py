#!/usr/bin/env python3
"""``chip_smoke.py``'s 6i memory check (``tp_check``) run several times
in the same two ranks, with and without a scan probe on its first step:

    python3 tools/tp_check_ab.py [--order probe,plain,probe]

Two processes on ``cuda:0`` meet on gloo on a (1, 2) ``("data",
"model")`` mesh, as 6i's.  Each runs ``tp_check`` (Zamba2-1.2B
relu_linear, B 8 x S 1024: the rank's blocks, ``TP_CHECK_STEPS``
sharded train steps, the peak allocated over the steps after the first)
once per entry of ``--order``: ``plain`` as ``chip_smoke.py`` runs it,
``probe`` with ``lm_scan_probe`` open over the first step and the
inputs it kept copied to the host before the next.  Prints one JSON
line a rank and run: the peak and the argument bytes against the meta
prediction (``tp_predict``), each step's seconds.  Needs a CUDA card;
imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def probed(make):
    """``make_train_step`` whose first step runs under ``lm_scan_probe``,
    the kept inputs copied to the host and dropped after it."""
    import torch
    import chip_smoke as cs

    def make_step(*a, **k):
        step, first = make(*a, **k), [True]

        def run(*x):
            if not first[0]:
                return step(*x)
            first[0] = False
            with cs.lm_scan_probe() as calls:
                out = step(*x)
                torch.cuda.synchronize()
            kept = {key: tuple(t.cpu() if torch.is_tensor(t) else t
                               for t in args)
                    for key, (args, _) in calls.items()}
            del calls, kept
            return out
        return run
    return make_step


def rank_main(rank: int, tmp: str, order, predicted: int) -> int:
    import torch
    import torch.distributed as dist
    import chip_smoke as cs
    from repro_torch.kernels.registry import kernel_wrappers
    from repro_torch.launch import steps as st
    from repro_torch.launch.mesh import make_mesh
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=2)
    try:
        wrappers = kernel_wrappers()
        mesh = make_mesh((1, 2), ("data", "model"), device="cuda")
        plain = st.make_train_step
        for i, name in enumerate(order):
            st.make_train_step = probed(plain) if name == "probe" else plain
            o = cs.tp_check({"seed": 0, "batch": cs.TRAIN_BATCH}, wrappers,
                            mesh)
            st.make_train_step = plain
            print(json.dumps({"rank": rank, "run": i, "variant": name,
                              "peak": o["peak"],
                              "peak_over_predicted": o["peak"] / predicted,
                              "args": o["args"], "step_s": o["check_secs"]}),
                  flush=True)
            dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--order", default="probe,plain,probe")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--predicted", type=int, default=0,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    order = args.order.split(",")
    if any(v not in ("plain", "probe") for v in order):
        ap.error("--order takes plain and probe")
    if args.rank is not None:
        return rank_main(args.rank, args.dir, order, args.predicted)

    import torch
    if not torch.cuda.is_available():
        print("tp_check_ab: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels.build import build
    t0 = time.perf_counter()
    build()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    pred = cs.tp_predict(card, cs.TRAIN_BATCH)
    predicted = pred["args"] + pred["temp"]
    tmp = tempfile.mkdtemp(prefix="tp_check_ab_")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--order", args.order,
         "--rank", str(r), "--dir", tmp, "--predicted", str(predicted)])
        for r in range(2)]
    try:
        rcs = [p.wait(timeout=1200) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print(f"predicted peak {predicted} B; ranks exited {rcs} in "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    return max(rcs)


if __name__ == "__main__":
    sys.exit(main())
