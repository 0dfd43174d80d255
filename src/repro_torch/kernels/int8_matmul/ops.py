"""W8A8 wrappers around ``int8_matmul`` + the FIX8 MSA registry impl.

``linear_w8a8`` quantizes activations per image, takes a producer's
``QTensor`` as it is, or clips to a calibrated static ``x_scale``
(``core.quantization.calibrate_act_scale``), and runs the int8 GEMM.
``conv1x1_w8a8`` runs a quantized 1x1 conv (a ``qconv`` from
``core.quantization.quantize_efficientvit``) through it: the route of
the MSA QKV and output projections at FIX8.  An int8 ``epilogue`` makes
it the producer: the GEMM quantizes its own output per image
(``int8_matmul_emit``) and it returns a ``QTensor``.  Counterpart of
``repro/kernels/int8_matmul/ops.py``.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantization import (
    QTensor, quantize_act, quantize_with_scale)
from repro_torch.kernels.group_conv.kernel import group_agg_path
from repro_torch.kernels.int8_matmul.kernel import (
    int8_gemm_plan, int8_matmul, int8_matmul_emit)
from repro_torch.kernels.registry import register
from repro_torch.kernels.relu_attn.ops import MSA_DEFAULT_BLOCK_N, MsaKernel

__all__ = ["linear_w8a8", "conv1x1_w8a8", "MsaInt8Kernel"]


def linear_w8a8(x, w_q, w_scale, *, x_scale=None):
    """x: (..., K) fp or a producer's ``QTensor``, whose per-image scales
    become per-row GEMM scales; w_q: (K, N) int8; w_scale: (N,) ->
    (..., N) fp32.  ``x_scale=None`` quantizes an fp ``x`` per leading
    index; a calibrated static ``x_scale`` clips to it instead."""
    if isinstance(x, QTensor) or x_scale is None:
        qt = x if isinstance(x, QTensor) else quantize_act(x)
        lead, K = qt.q.shape[:-1], qt.q.shape[-1]
        x_q = qt.q.reshape(-1, K)
        rows = x_q.shape[0] // qt.q.shape[0]
        xs = qt.scale_col()[:, None].expand(-1, rows).reshape(-1)  # per row
    else:
        lead, K = x.shape[:-1], x.shape[-1]
        xs = torch.as_tensor(x_scale, dtype=torch.float32, device=x.device)
        x_q = quantize_with_scale(x.reshape(-1, K), xs)
    out = int8_matmul(x_q.contiguous(), w_q, xs, w_scale)
    return out.reshape(*lead, -1)


def conv1x1_w8a8(qp, x, *, x_scale=None, epilogue=None):
    """FIX8 1x1 conv as the int8 GEMM.  qp: {'q' (1,1,C,F) int8, 'scale'
    (F,), 'bias' (F,)}; x: (B, H, W, C) fp (quantized here per image, or
    clipped to a calibrated static ``x_scale``) or a producer's
    ``QTensor``.  The bias is added after the GEMM's dequant, as the JAX
    wrapper does.  An int8 ``epilogue`` returns a ``QTensor`` with one
    scale per image from the emitting GEMM (bias added before its
    absmax), the fp32 map alongside under "keep-fp"."""
    qt = isinstance(x, QTensor)
    if not qt and x_scale is None:
        x, out_dtype = quantize_act(x), x.dtype
        qt = True
    else:
        out_dtype = (x.fp.dtype if qt and x.fp is not None
                     else torch.float32 if qt else x.dtype)
    B, H, W, C = x.shape
    w_q = qp["q"].reshape(C, -1)
    F = w_q.shape[1]
    if epilogue is not None and epilogue.emits_q:
        if qt:
            x_q, xs = x.q.reshape(-1, C), x.scale_col()
        else:
            xs = torch.as_tensor(x_scale, dtype=torch.float32,
                                 device=x.device)
            x_q = quantize_with_scale(x.reshape(-1, C), xs)
        keep_fp = epilogue.residual == "keep-fp"
        outs = int8_matmul_emit(x_q.contiguous(), w_q, xs, qp["scale"],
                                rows_per_group=H * W, bias=qp["bias"],
                                keep_fp=keep_fp)
        fp = (outs[2].reshape(B, H, W, F).to(out_dtype) if keep_fp
              else None)
        return QTensor(outs[0].reshape(B, H, W, F), outs[1], fp)
    out = linear_w8a8(x if qt else x.reshape(-1, C), w_q, qp["scale"],
                      x_scale=None if qt else x_scale)
    out = out.reshape(-1, F) + qp["bias"][None, :]
    return out.reshape(B, H, W, -1).to(out_dtype)


@register
class MsaInt8Kernel(MsaKernel):
    """(msa, int8): the fused MSA module with its QKV and output
    projections on the W8A8 GEMM kernel and its aggregation branches on
    the grouped int8 kernel; takes a producer's ``QTensor`` straight into
    the QKV GEMM and emits its own output through the projection GEMM's
    act-quant epilogue (a residual MSA site quantizes after its add, in
    ``execute``)."""
    precision, dtype = "int8", "i8"
    int8_proj = True
    takes_q = True
    emits_q = True

    def tune(self, site, *, autotune=True, device=None):
        """The default token tile, never swept: the FIX8 plan's blocks
        (and so its bits) do not depend on ``autotune``."""
        return {"block_n": MSA_DEFAULT_BLOCK_N}

    def candidates(self, site):
        return ()

    def smem_bytes(self, site, blocks):
        """The largest CTA of the site's launches: the attention core,
        the QKV and output projections' GEMM plans (``int8_gemm_plan``)
        and each aggregation branch's path (``group_agg_path``)."""
        B, H, W, C = site.in_shape
        d = site.attrs["head_dim"]
        total = site.attrs["heads"] * d
        rows = B * H * W
        qkv = int8_gemm_plan(rows, 3 * total, C)
        proj = int8_gemm_plan(rows, site.out_shape[-1],
                              site.attrs["n_branches"] * total)
        aggs = [group_agg_path(H, W, 3 * total, d, s)["smem"]
                for s in site.attrs["scales"]]
        return max(super().smem_bytes(site, blocks), qkv["smem"],
                   proj["smem"], *aggs)
