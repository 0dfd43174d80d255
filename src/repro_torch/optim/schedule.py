"""Learning-rate schedules, counterpart of ``repro/optim/schedule.py``:
step -> a multiplier of the optimizer's lr, computed in fp32 as JAX's."""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["ScheduleConfig", "lr_scale"]


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    kind: str = "cosine"        # cosine | linear | constant
    warmup_steps: int = 100
    total_steps: int = 10000
    min_ratio: float = 0.1      # floor as a fraction of peak lr


def lr_scale(cfg: ScheduleConfig, step) -> torch.Tensor:
    """A 0-dim fp32 CPU tensor in [0, 1]: a linear warmup over
    ``warmup_steps``, then ``kind``'s decay to ``min_ratio`` at
    ``total_steps``.  Computed on the CPU, where dividing by a number is
    a true division (a CUDA tensor would multiply by its reciprocal)."""
    s = torch.as_tensor(step).to("cpu", torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    if cfg.kind == "cosine":
        decay = cfg.min_ratio + (1 - cfg.min_ratio) * 0.5 * (
            1 + torch.cos(math.pi * frac))
    elif cfg.kind == "linear":
        decay = cfg.min_ratio + (1 - cfg.min_ratio) * (1 - frac)
    elif cfg.kind == "constant":
        decay = torch.ones((), dtype=torch.float32)
    else:
        raise ValueError(cfg.kind)
    return warm * decay
