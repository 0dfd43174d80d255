"""Plain PyTorch version of the fused MBConv kernel.

Semantics match ``core.efficientvit.mbconv`` with BN folded into each
conv: PWConv(C->M) + bias + Hardswish, depthwise 3x3 over the
zero-padded mid map + bias, stride s sampled at offset s - 1 (the
reference's SAME anchor), Hardswish, PWConv(M->F) + bias.  The CPU path
of ``kernel.mbconv_fused`` and its yardstick on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.efficientvit import hardswish


def mbconv_ref(x, w1, b1, dw_w, dw_b, w2, b2, *, stride: int = 1):
    """x: (B, H, W, C); w1: (C, M); dw_w: (3, 3, M); w2: (M, F)
    -> (B, H // stride, W // stride, F) fp32."""
    B, H, W, C = x.shape
    mid = hardswish(x.float() @ w1.float() + b1)
    mp = F.pad(mid, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros_like(mid)
    for dy in range(3):
        for dx in range(3):
            acc = acc + mp[:, dy:dy + H, dx:dx + W, :] * dw_w[dy, dx]
    acc = acc + dw_b
    if stride > 1:
        acc = acc[:, stride - 1::stride, stride - 1::stride, :]
    return hardswish(acc) @ w2.float() + b2
