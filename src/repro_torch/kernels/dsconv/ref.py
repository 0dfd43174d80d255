"""Plain PyTorch versions of the fused DWConv -> PWConv kernels (fp32
``dsconv_fused``, FIX8 ``dsconv_fused_int8`` and its emitting variant).

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


def dw3x3_int(x_q, dw_q):
    """Exact int32 sums of a 3x3 depthwise conv over the int8 zero-padded
    NHWC map, at every position (stride 1), as float64."""
    B, H, W, C = x_q.shape
    xp = F.pad(x_q.double(), (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((B, H, W, C), dtype=torch.float64, device=x_q.device)
    for dy in range(3):
        for dx in range(3):
            acc = acc + xp[:, dy:dy + H, dx:dx + W, :] * dw_q[dy, dx].double()
    return acc


def dsconv_int8_ref(x_q, x_scale, dw_q, dw_s, dw_b, pw_q, pw_s, pw_b, *,
                    stride: int = 1, act: bool = True):
    """Plain version of ``dsconv_fused_int8``, mirroring the JAX oracle
    ``dsconv_int8_ref``: int32 DW, dequant ``acc * (xs * dw_s) + dw_b``,
    stride at offset s - 1, Hardswish, per-image requant, int32 PW,
    dequant ``acc * (s_dw * pw_s) + pw_b``.  ``x_scale``: () or (B,)."""
    from repro_torch.core.quantization import int_sums, quantize_act
    from repro_torch.kernels.quant import xs_per_batch_vec

    B = x_q.shape[0]
    xs = xs_per_batch_vec(x_scale, B).reshape(B, 1, 1, 1)
    y = dw3x3_int(x_q, dw_q).float() * (xs * dw_s) + dw_b
    if stride > 1:
        y = y[:, stride - 1::stride, stride - 1::stride, :]
    if act:
        y = hardswish(y)
    yq = quantize_act(y)
    acc = int_sums(yq.q, pw_q)
    return acc * (yq.scale.reshape(B, 1, 1, 1) * pw_s) + pw_b


def dsconv_int8_emit_ref(x_q, x_scale, dw_q, dw_s, dw_b, pw_q, pw_s, pw_b, *,
                         stride: int = 1, act: bool = True,
                         keep_fp: bool = False):
    """Plain version of ``dsconv_fused_int8_emit``: ``dsconv_int8_ref``,
    then ``quantize_act`` per image over the full c_out -> (q, scales),
    or (q, scales, fp32 output) when ``keep_fp``."""
    from repro_torch.core.quantization import quantize_act

    out = dsconv_int8_ref(x_q, x_scale, dw_q, dw_s, dw_b, pw_q, pw_s, pw_b,
                          stride=stride, act=act)
    qt = quantize_act(out)
    return (qt.q, qt.scale, out) if keep_fp else (qt.q, qt.scale)
