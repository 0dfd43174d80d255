"""Token samplers (greedy / temperature / top-k / top-p), counterpart of
``repro/serving/sampler.py``.  Randomness comes from an explicit
``torch.Generator`` on the logits' device."""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["SamplerConfig", "sample", "NEG_INF"]

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0     # 0 -> greedy
    top_k: int = 0               # 0 -> off
    top_p: float = 1.0           # 1 -> off


def sample(logits, generator, cfg: SamplerConfig):
    """logits: (B, V) -> (B,) int64 tokens.  Greedy is the argmax (no
    draw); otherwise one categorical draw per row from ``generator``
    over the tempered logits, cut to the top-k and then to the smallest
    prefix of mass >= top_p (both keep ties at the threshold)."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    lf = logits.float() / cfg.temperature
    if cfg.top_k:
        kth = torch.topk(lf, cfg.top_k, dim=-1).values[..., -1:]
        lf = torch.where(lf < kth, torch.full_like(lf, NEG_INF), lf)
    if cfg.top_p < 1.0:
        sorted_lf = torch.sort(lf, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_lf, dim=-1), dim=-1)
        # the smallest prefix with cumulative mass >= top_p
        cutoff_idx = torch.argmax((cum >= cfg.top_p).to(torch.int32),
                                  dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_lf, -1, cutoff_idx)
        lf = torch.where(lf < cutoff, torch.full_like(lf, NEG_INF), lf)
    probs = torch.softmax(lf, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
