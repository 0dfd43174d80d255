"""LM serving launcher: ``python -m repro_torch.launch.serve``,
counterpart of ``repro/launch/serve.py`` with its flags and defaults.

Boots a ``ServingEngine`` over an arch (``--smoke``: its
``smoke_variant``) with random weights from ``--seed`` and drives a
synthetic request stream through continuous batching.  Runs on the CUDA
card; ``--device cpu`` runs the plain PyTorch path on the CPU, and
without a card and without it the launcher raises.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.configs import get_arch
from repro_torch.configs.base import smoke_variant
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import Request, ServeConfig, ServingEngine
from repro_torch.serving.sampler import SamplerConfig

__all__ = ["main", "parser"]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def main(argv=None):
    """Serve ``--requests`` random prompts; -> the finished requests."""
    args = parser().parse_args(argv)

    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    if args.smoke:
        arch = smoke_variant(arch)
    params = build_model(arch).init(args.seed, device=device)
    cfg = ServeConfig(max_slots=args.slots, max_len=args.max_len,
                      sampler=SamplerConfig(temperature=args.temperature),
                      seed=args.seed)
    engine = ServingEngine(arch, params, cfg, device=device)

    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, arch.vocab,
                                        size=rng.integers(4, 32)),
                    max_tokens=args.max_tokens)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    done = engine.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.out_tokens) for r in done)
    print(f"served {len(done)} requests, {total_tokens} tokens "
          f"in {dt:.1f}s ({total_tokens / dt:.1f} tok/s) on {device}")
    for r in done[:3]:
        print(f"  req {r.rid}: prompt[:8]={r.prompt[:8].tolist()} -> "
              f"out[:8]={r.out_tokens[:8]}")
    return done


if __name__ == "__main__":
    main()
