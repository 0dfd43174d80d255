"""Rotary position embeddings (RoPE), half-rotation convention,
counterpart of ``repro/layers/rope.py``."""
from __future__ import annotations

import torch

__all__ = ["rope_freqs", "apply_rope"]


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None
               ) -> torch.Tensor:
    """Inverse frequencies of the largest even half of ``head_dim`` (an
    odd head dim keeps its last channel unrotated)."""
    rot = head_dim - head_dim % 2
    ex = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** ex)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, heads, head_dim); positions: (S,), shared by every
    row, or (B, S), one per row (decode: each slot at its own position).
    Rotates in fp32, returns x's dtype."""
    head_dim = x.shape[-1]
    rot = head_dim - head_dim % 2
    inv = rope_freqs(head_dim, theta, x.device)
    ang = positions[..., None].to(torch.float32) * inv     # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]                       # over heads
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., : rot // 2].float()
    x2 = x[..., rot // 2: rot].float()
    parts = [x1 * cos - x2 * sin, x1 * sin + x2 * cos]
    if rot != head_dim:
        parts.append(x[..., rot:].float())
    return torch.cat(parts, dim=-1).to(x.dtype)
