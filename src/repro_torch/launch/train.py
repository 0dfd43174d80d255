"""Training launcher: ``python -m repro_torch.launch.train``, counterpart
of ``repro/launch/train.py`` with its flags and defaults.

Runs the fault-tolerant ``Trainer`` on one device: the CUDA card, or the
CPU with ``--device cpu`` (without a card and without it the launcher
raises).  Random weights and the synthetic Markov data both come from
``--seed``.

Examples:
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --smoke --steps 5 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
        --smoke --steps 200
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import smoke_variant
from repro_torch.data.pipeline import DataConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig

__all__ = ["main", "parser"]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    arch = get_arch(args.arch)
    if args.smoke:
        arch = smoke_variant(arch)
    data_cfg = DataConfig(vocab=arch.vocab, seq_len=args.seq,
                          global_batch=args.batch, seed=args.seed)
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir, seed=args.seed,
                         log_every=args.log_every)
    trainer = Trainer(arch, data_cfg, tcfg, device=args.device)
    out = trainer.run()
    dev = trainer.device
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"final loss: {out['final_loss']:.4f} "
          f"(first: {out['losses'][0]:.4f}) over {len(out['losses'])} "
          f"steps on {name}")
    return out


if __name__ == "__main__":
    main()
