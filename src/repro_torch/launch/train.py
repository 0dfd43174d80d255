"""Training launcher: ``python -m repro_torch.launch.train``, counterpart
of ``repro/launch/train.py`` with its flags and defaults.

Runs the fault-tolerant ``Trainer`` on one device: the CUDA card, or the
CPU with ``--device cpu`` (without a card and without it the launcher
raises).  Random weights and the synthetic Markov data both come from
``--seed``.  Under ``torchrun`` (its ``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK`` environment) every rank initializes the process group
(``nccl`` on the cards, one per rank; ``gloo`` only with ``--device
cpu``) and trains on a ``--mesh DATAxMODEL`` mesh (default: world x 1);
rank 0 prints.

Examples:
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --smoke --steps 5 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
        --smoke --steps 200
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --device cpu --mesh 2x2 --smoke --steps 5
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.configs.base import smoke_variant
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import make_mesh
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
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL mesh under torchrun (default: world "
                         "x 1)")
    return ap


def _init_group(device):
    """Under torchrun: the process group and this rank's device."""
    if device == "cpu":
        dist.init_process_group("gloo")
        return device
    local = int(os.environ["LOCAL_RANK"])
    torch.cuda.set_device(local)
    dist.init_process_group("nccl")
    return f"cuda:{local}"


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
    distributed = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    device, mesh = args.device, None
    if distributed:
        device = _init_group(device)
        if args.mesh:
            data, model = (int(n) for n in args.mesh.lower().split("x"))
            mesh = make_mesh((data, model), ("data", "model"), device=device)
    elif args.mesh:
        raise SystemExit("--mesh needs torchrun (RANK / WORLD_SIZE)")
    try:
        trainer = Trainer(arch, data_cfg, tcfg, device=device, mesh=mesh)
        out = trainer.run()
    finally:
        if distributed:
            dist.destroy_process_group()
    dev = trainer.device
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    if not distributed or int(os.environ["RANK"]) == 0:
        where = (f" on a {trainer.mesh.shape} mesh"
                 if trainer.mesh is not None else "")
        print(f"final loss: {out['final_loss']:.4f} "
              f"(first: {out['losses'][0]:.4f}) over "
              f"{len(out['losses'])} steps on {name}{where}")
    return out


if __name__ == "__main__":
    main()
