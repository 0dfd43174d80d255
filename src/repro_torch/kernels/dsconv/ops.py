"""Fused DSConv for framework param trees + its registry impl.

``dsconv_apply(params, x)`` consumes the EfficientViT {'dw','pw'}
conv+BN block pair, folds BN into both convs and runs ``dsconv_fused``.
"""
from __future__ import annotations

from repro_torch.core.quantization import fold_bn_into_conv
from repro_torch.kernels.dsconv.kernel import (
    choose_blocks, dsconv_fused, dsconv_smem_bytes)
from repro_torch.kernels.registry import KernelBase, register

__all__ = ["dsconv_apply", "DsconvKernel"]


def dsconv_apply(params, x, *, stride: int = 1,
                 block_rows: int | None = None, block_f: int | None = None):
    """{'dw': conv+bn, 'pw': conv+bn} -> fused kernel: BN folded into
    both convs, Hardswish between them, bare projection after."""
    dw_w4, dw_b = fold_bn_into_conv(params["dw"]["conv"], params["dw"]["bn"])
    pw_w4, pw_b = fold_bn_into_conv(params["pw"]["conv"], params["pw"]["bn"])
    out = dsconv_fused(x.contiguous(), dw_w4[:, :, 0, :].contiguous(), dw_b,
                       pw_w4[0, 0].contiguous(), pw_b, stride=stride,
                       act=True, block_rows=block_rows, block_f=block_f)
    return out.to(x.dtype)


@register
class DsconvKernel(KernelBase):
    """(dsconv, fp): the DW+PW CUDA kernel behind ``dsconv_apply``."""
    kind, precision, dtype = "dsconv", "fp", "f32"
    batch_dependent_tiles = True   # the band height follows the batch

    def smem_bytes(self, site, blocks):
        _, _, W, C = site.in_shape
        return dsconv_smem_bytes(W, C, site.stride, blocks["block_rows"],
                                 blocks["block_f"])

    def tune(self, site):
        return choose_blocks(site.in_shape, site.out_shape[-1], site.stride)

    def apply(self, params, x, site, decision=None):
        blocks = dict(decision.blocks) if decision is not None else {}
        return dsconv_apply(params, x, stride=site.stride, **blocks)

    def ref(self, params, x, site, **kw):
        from repro_torch.core.efficientvit import dsconv
        return dsconv(params, x, stride=site.stride)
