#!/usr/bin/env python3
"""What a checkpoint of a whole training state costs, on one CUDA card:

    python3 tools/checkpoint_cost.py [--arch zamba2-1.2b] [--backend relu_linear]

Makes the arch's random params and default AdamW state on the card (for
Zamba2-1.2B: 2.2 GiB of bf16 params, a 4.4 GiB fp32 master, 2.2 GiB each
of bf16 m and v), then times, each to a synchronize: the params and
state's init; the snapshot ``CheckpointManager.save_async`` takes (a
copy to pageable host memory); a synchronous ``save`` of that snapshot
into a temporary directory, and a second one; ``restore`` onto the card;
for comparison, a snapshot into pinned host memory (allocation and
copy), then a copy into pinned buffers already allocated; and
``save_async`` followed by ``wait`` (the background write).  Prints the
directory's size.  Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="zamba2-1.2b")
    ap.add_argument("--backend", default="relu_linear")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("checkpoint_cost: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.checkpoint import checkpoint as ck
    from repro_torch.common.tree import tree_leaves, tree_map
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import default_opt_cfg, init_train_state
    from repro_torch.models.registry import build_model

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()

    def timed(label, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        print(f"{label}: {time.perf_counter() - t0:.3f} s [{card}]",
              flush=True)
        return out

    cfg = get_arch(args.arch).scaled(attn_backend=args.backend)
    params, opt = timed("init params and AdamW state", lambda: (
        init_train_state(build_model(cfg), default_opt_cfg(cfg), 0, "cuda")))
    tree = {"params": params, "opt": opt}
    gib = sum(t.numel() * t.element_size()
              for t in tree_leaves(tree)) / 2**30
    print(f"{cfg.name}: state {gib:.3f} GiB")
    root = tempfile.mkdtemp(prefix="checkpoint_cost_")
    try:
        host = timed("snapshot to pageable host memory (save_async's)",
                     lambda: tree_map(ck._host, tree))
        timed("save of the snapshot", lambda: ck.save(root, 10, host))
        timed("save again", lambda: ck.save(root, 20, host))
        del host
        timed("restore onto the card",
              lambda: ck.restore(root, tree, device="cuda"))

        def pinned():
            return tree_map(lambda x: torch.empty(
                x.shape, dtype=x.dtype, pin_memory=True), tree)

        def copy(dst):
            tree_map(lambda o, x: o.copy_(x, non_blocking=True), dst, tree)
            return dst

        timed("snapshot to pinned host memory (allocation and copy)",
              lambda: copy(pinned()))
        bufs = pinned()
        timed("copy into pinned buffers already allocated",
              lambda: copy(bufs))
        del bufs
        mgr = ck.CheckpointManager(root, keep=2)
        timed("save_async (the snapshot)",
              lambda: mgr.save_async(30, tree))
        timed("wait (the background write)", mgr.wait)
        mgr.close()
        print(subprocess.run(["du", "-sh", root], capture_output=True,
                             text=True).stdout.strip())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
