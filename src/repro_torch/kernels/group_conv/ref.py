"""Plain PyTorch version of the FIX8 MSA aggregation branch
(``csrc/group_agg.cu``), mirroring the JAX oracle
``repro/kernels/group_conv/kernel.py::group_agg_int8_ref``: int32
depthwise SxS, dequant ``acc * (xs * dw_s) + dw_b``, per-image requant,
the grouped 1x1 as a dense block-diagonal int32 product, dequant
``acc * (s_y * pw_s) + pw_b``.  The CPU path of ``kernel.group_agg_int8``
and its yardstick on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["block_diag", "group_agg_int8_ref"]


def block_diag(pw_q):
    """Grouped-1x1 weights (d, C) (or HWIO (1, 1, d, C)) -> the dense
    (C, C) int8 block-diagonal matrix: output channel ``oc`` keeps its
    group's ``d`` input rows, everything off-block is zero (exact for
    int32 sums)."""
    w = pw_q.reshape(pw_q.shape[-2], pw_q.shape[-1])
    d, C = w.shape
    col = torch.arange(C, device=w.device)
    rows = (col // d)[None, :] * d + torch.arange(d, device=w.device)[:, None]
    dense = torch.zeros((C, C), dtype=torch.int8, device=w.device)
    dense[rows, col[None, :].expand(d, C)] = w
    return dense


def group_agg_int8_ref(x_q, x_scale, dw_q, dw_s, dw_b, pw_dense_q, pw_s,
                       pw_b):
    """x_q: (B, H, W, C) int8 QKV with () or (B,) ``x_scale``; dw_q:
    (S, S, C) int8; pw_dense_q: (C, C) int8 block-diagonal -> (B, H, W, C)
    fp32."""
    from repro_torch.core.quantization import int_sums, quantize_act
    from repro_torch.kernels.quant import xs_per_batch_vec

    B, H, W, C = x_q.shape
    s = dw_q.shape[0]
    p = s // 2
    xp = F.pad(x_q.double(), (0, 0, p, p, p, p))
    acc = torch.zeros((B, H, W, C), dtype=torch.float64, device=x_q.device)
    for dy in range(s):
        for dx in range(s):
            acc = acc + xp[:, dy:dy + H, dx:dx + W, :] * dw_q[dy, dx].double()
    xs = xs_per_batch_vec(x_scale, B).reshape(B, 1, 1, 1)
    yq = quantize_act(acc.float() * (xs * dw_s) + dw_b)
    return (int_sums(yq.q, pw_dense_q) * (yq.scale.reshape(B, 1, 1, 1) * pw_s)
            + pw_b)
