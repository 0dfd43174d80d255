"""The activation-scale convention of the int8 kernels, counterpart of
``repro/kernels/quant.py``.

The plain versions requantize per image with
``core.quantization.quantize_act``, which shares one scale/round/clip
arithmetic with the reference ``conv2d_int8`` chain; the CUDA kernels
repeat it in ``csrc/int8.cuh`` (``scale_of``, ``quant_i8``).
"""
from __future__ import annotations

import torch

__all__ = ["xs_per_batch_vec"]


def xs_per_batch_vec(x_scale, batch: int) -> torch.Tensor:
    """A per-tensor scalar or per-image (B,) activation scale -> (B,)
    fp32 (the producer-epilogue convention every consumer takes)."""
    xs = torch.as_tensor(x_scale, dtype=torch.float32).reshape(-1)
    return xs.expand(batch)
