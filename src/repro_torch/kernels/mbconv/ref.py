"""Plain PyTorch versions of the fused MBConv kernels (fp32
``mbconv_fused`` and FIX8 ``mbconv_fused_int8`` / ``_emit``).

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


def mbconv_int8_ref(x_q, x_scale, w1_q, s1, b1, dw_q, dw_s, dw_b, w2_q, s2,
                    b2, *, stride: int = 1):
    """Plain version of ``mbconv_fused_int8``, mirroring the JAX oracle
    ``mbconv_int8_ref``: int32 PW1, dequant ``acc * (xs * s1) + b1``,
    Hardswish, per-image requant, int32 DW over the int8 zero-padded map,
    dequant, stride at offset s - 1, Hardswish, per-image requant, int32
    PW2, dequant.  ``x_scale``: () or (B,).  -> (B, Ho, Wo, F) fp32."""
    from repro_torch.core.quantization import int_sums, quantize_act
    from repro_torch.kernels.dsconv.ref import dw3x3_int
    from repro_torch.kernels.quant import xs_per_batch_vec

    B = x_q.shape[0]
    col = (B, 1, 1, 1)
    xs = xs_per_batch_vec(x_scale, B).reshape(col)
    mid = hardswish(int_sums(x_q, w1_q) * (xs * s1) + b1)
    mq = quantize_act(mid)
    dw = dw3x3_int(mq.q, dw_q).float() * (mq.scale.reshape(col) * dw_s) \
        + dw_b
    if stride > 1:
        dw = dw[:, stride - 1::stride, stride - 1::stride, :]
    dq = quantize_act(hardswish(dw))
    return int_sums(dq.q, w2_q) * (dq.scale.reshape(col) * s2) + b2
