"""Plain PyTorch version of the W8A8 GEMM (``csrc/int8_matmul.cu``).

Mirrors the JAX oracle ``repro/kernels/int8_matmul/ref.py``: exact int32
sums, epilogue ``(acc * x_scale) * w_scale`` in that order.  The CPU path
of ``kernel.int8_matmul`` and its yardstick on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantization import int_sums


def int8_matmul_ref(x_q, w_q, x_scale, w_scale):
    """x_q: (M, K) int8; w_q: (K, N) int8; x_scale: () or per-row (M,);
    w_scale: (N,) -> (M, N) fp32."""
    acc = int_sums(x_q, w_q)
    xs = torch.as_tensor(x_scale, dtype=torch.float32,
                         device=acc.device).reshape(-1, 1)
    return acc * xs * w_scale[None, :]
