"""Plain PyTorch versions of the W8A8 GEMM and its emitting variant
(``csrc/int8_matmul.cu``).

Mirrors the JAX oracle ``repro/kernels/int8_matmul/ref.py``: exact int32
sums, epilogue ``(acc * x_scale) * w_scale`` in that order; the emitting
variant then adds the bias and quantizes each row group as
``quantize_act`` does.  The CPU paths of ``kernel.int8_matmul`` and
``kernel.int8_matmul_emit`` and their yardsticks on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantization import int_sums, quantize_act


def int8_matmul_ref(x_q, w_q, x_scale, w_scale):
    """x_q: (M, K) int8; w_q: (K, N) int8; x_scale: () or per-row (M,);
    w_scale: (N,) -> (M, N) fp32."""
    acc = int_sums(x_q, w_q)
    xs = torch.as_tensor(x_scale, dtype=torch.float32,
                         device=acc.device).reshape(-1, 1)
    return acc * xs * w_scale[None, :]


def int8_matmul_emit_ref(x_q, w_q, x_scale, w_scale, *, rows_per_group: int,
                         bias=None, keep_fp: bool = False):
    """``int8_matmul_ref`` with one activation scale per group of
    ``rows_per_group`` rows (x_scale: () or (M // rows_per_group,)), then
    ``+ bias``, then ``quantize_act`` per row group -> (q (M, N) int8,
    scales (G,) fp32), plus the fp32 output when ``keep_fp``.  The fp32
    steps run in the TPU kernel's order: ``(acc * xs) * ws``, then
    ``+ b``."""
    M, N = x_q.shape[0], w_q.shape[1]
    G = M // rows_per_group
    xs = torch.as_tensor(x_scale, dtype=torch.float32,
                         device=x_q.device).reshape(-1).expand(G)
    out = int8_matmul_ref(x_q, w_q, xs.repeat_interleave(rows_per_group),
                          w_scale)
    if bias is not None:
        out = out + bias[None, :]
    qt = quantize_act(out.reshape(G, rows_per_group, N))
    q = qt.q.reshape(M, N)
    return (q, qt.scale, out) if keep_fp else (q, qt.scale)
