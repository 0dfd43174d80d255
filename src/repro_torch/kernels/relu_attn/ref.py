"""Plain PyTorch version of the fused non-causal ReLU linear attention.

The CPU path of ``kernel.relu_attn_noncausal`` and its yardstick on the
card.  Layout (G, N, heads, d): the JAX kernel's (BH, N, D) rows are
the (g, head) pairs, folded by strides instead of a copy.
"""
from __future__ import annotations

import torch

EPS = 1e-6


def relu_attn_noncausal_ref(q, k, v, eps: float = EPS):
    """q, k, v: (G, N, h, d) -> (G, N, h, d) fp32.

    out = ReLU(Q) (ReLU(K)^T V) / max(ReLU(Q) . rowsum(ReLU(K)), eps)
    """
    pq = torch.relu(q.float())
    pk = torch.relu(k.float())
    kv = torch.einsum("gnhd,gnhe->ghde", pk, v.float())
    ksum = pk.sum(dim=1)
    num = torch.einsum("gnhd,ghde->gnhe", pq, kv)
    den = torch.einsum("gnhd,ghd->gnh", pq, ksum)[..., None]
    return num / torch.clamp(den, min=eps)
