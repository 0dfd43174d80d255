"""Plain PyTorch version of the fused DWConv -> PWConv kernel.

Semantics: 3x3 depthwise conv over a (1,1)-padded NHWC map + bias,
stride s sampled at offset s - 1 (the reference's SAME anchor),
Hardswish, then 1x1 pointwise conv + bias.  The CPU path of
``kernel.dsconv_fused`` and its yardstick on the card.

Unlike the JAX oracle ``repro/kernels/dsconv/ref.py``, which subsamples
stride 2 at offset 0, this follows the reference forward
(``core.efficientvit.dsconv``).  No B1 site runs a stride-2 dsconv.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.efficientvit import hardswish


def dsconv_ref(x, dw_w, dw_b, pw_w, pw_b, *, stride: int = 1,
               act: bool = True):
    """x: (B, H, W, C); dw_w: (3, 3, C); pw_w: (C, F) -> (B, Ho, Wo, F)."""
    B, H, W, C = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((B, H, W, C), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            acc = acc + xp[:, dy:dy + H, dx:dx + W, :] * dw_w[dy, dx]
    acc = acc + dw_b
    if stride > 1:
        acc = acc[:, stride - 1::stride, stride - 1::stride, :]
    if act:
        acc = hardswish(acc)
    return acc @ pw_w.float() + pw_b
