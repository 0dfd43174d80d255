"""W8A8 wrappers around ``int8_matmul`` + the FIX8 MSA registry impl.

``linear_w8a8`` quantizes activations per image (or takes a producer's
``QTensor`` as it is) and runs the int8 GEMM.  ``conv1x1_w8a8`` runs a quantized 1x1 conv (a ``qconv`` from
``core.quantization.quantize_efficientvit``) through it: the route of
the MSA QKV and output projections at FIX8.  Counterpart of
``repro/kernels/int8_matmul/ops.py`` without its calibrated static
``x_scale`` (no caller) and its emitting GEMM (``int8_matmul_emit``, not
ported yet).
"""
from __future__ import annotations

import torch

from repro_torch.core.quantization import QTensor, quantize_act
from repro_torch.kernels.int8_matmul.kernel import (
    INT8_GEMM_SMEM_BYTES, int8_matmul)
from repro_torch.kernels.registry import register
from repro_torch.kernels.relu_attn.ops import MsaKernel

__all__ = ["linear_w8a8", "conv1x1_w8a8", "MsaInt8Kernel"]

EMIT_NOT_PORTED = ("an emitting int8 epilogue needs int8_matmul_emit, "
                   "which is not ported yet")


def linear_w8a8(x, w_q, w_scale):
    """x: (..., K) fp (quantized here per leading index) or a producer's
    ``QTensor``, whose per-image scales become per-row GEMM scales;
    w_q: (K, N) int8; w_scale: (N,) -> (..., N) fp32."""
    qt = x if isinstance(x, QTensor) else quantize_act(x)
    lead, K = qt.q.shape[:-1], qt.q.shape[-1]
    x_q = qt.q.reshape(-1, K)
    rows = x_q.shape[0] // qt.q.shape[0]
    xs = qt.scale_col()[:, None].expand(-1, rows).reshape(-1)  # per row
    out = int8_matmul(x_q.contiguous(), w_q, xs, w_scale)
    return out.reshape(*lead, -1)


def conv1x1_w8a8(qp, x, *, epilogue=None):
    """FIX8 1x1 conv as the int8 GEMM.  qp: {'q' (1,1,C,F) int8, 'scale'
    (F,), 'bias' (F,)}; x: (B, H, W, C) fp (quantized here per image) or
    a producer's ``QTensor``.  The bias is added after the GEMM's
    dequant, as the JAX wrapper does."""
    if epilogue is not None and epilogue.emits_q:
        raise NotImplementedError(EMIT_NOT_PORTED)
    qt = isinstance(x, QTensor)
    out_dtype = (x.fp.dtype if qt and x.fp is not None
                 else torch.float32 if qt else x.dtype)
    B, H, W, C = x.shape
    w_q = qp["q"].reshape(C, -1)
    out = linear_w8a8(x, w_q, qp["scale"])
    out = out.reshape(-1, w_q.shape[1]) + qp["bias"][None, :]
    return out.reshape(B, H, W, -1).to(out_dtype)


@register
class MsaInt8Kernel(MsaKernel):
    """(msa, int8): the fused MSA module with its QKV and output
    projections on the W8A8 GEMM kernel and its aggregation branches on
    the grouped int8 kernel; takes a producer's ``QTensor`` straight into
    the QKV GEMM.  ``emits_q`` is the planner's view (the post-add
    quantize of a residual MSA site runs in ``execute``)."""
    precision, dtype = "int8", "i8"
    int8_proj = True
    takes_q = True
    emits_q = True

    def smem_bytes(self, site, blocks):
        return max(super().smem_bytes(site, blocks), INT8_GEMM_SMEM_BYTES)
