"""Fused MBConv for framework param trees + its registry impl.

``mbconv_apply(params, x)`` consumes the EfficientViT
{'pw1','dw','pw2'} conv+BN triple, folds BN into each conv and runs
``mbconv_fused``.
"""
from __future__ import annotations

from repro_torch.core.quantization import fold_bn_into_conv
from repro_torch.kernels.mbconv.kernel import (
    choose_blocks, mbconv_fused, mbconv_smem_bytes)
from repro_torch.kernels.registry import KernelBase, register

__all__ = ["mbconv_apply", "MbconvKernel"]


def mbconv_apply(params, x, *, stride: int = 1,
                 block_rows: int | None = None, block_m: int | None = None):
    """Matches ``core.efficientvit.mbconv``: BN folded into all three
    convs, Hardswish after pw1 and dw, bare projection after pw2."""
    w1, b1 = fold_bn_into_conv(params["pw1"]["conv"], params["pw1"]["bn"])
    dw, dw_b = fold_bn_into_conv(params["dw"]["conv"], params["dw"]["bn"])
    w2, b2 = fold_bn_into_conv(params["pw2"]["conv"], params["pw2"]["bn"])
    out = mbconv_fused(x.contiguous(), w1[0, 0].contiguous(), b1,
                       dw[:, :, 0, :].contiguous(), dw_b,
                       w2[0, 0].contiguous(), b2, stride=stride,
                       block_rows=block_rows, block_m=block_m)
    return out.to(x.dtype)


@register
class MbconvKernel(KernelBase):
    """(mbconv, fp): the PW+DW+PW CUDA kernel behind ``mbconv_apply``."""
    kind, precision, dtype = "mbconv", "fp", "f32"
    batch_dependent_tiles = True   # the band height follows the batch

    def smem_bytes(self, site, blocks):
        _, _, W, C = site.in_shape
        return mbconv_smem_bytes(W, C, site.out_shape[-1], site.stride,
                                 blocks["block_rows"], blocks["block_m"])

    def tune(self, site):
        return choose_blocks(site.in_shape, site.attrs["mid"],
                             site.out_shape[-1], site.stride)

    def apply(self, params, x, site, decision=None):
        blocks = dict(decision.blocks) if decision is not None else {}
        return mbconv_apply(params, x, stride=site.stride, **blocks)

    def ref(self, params, x, site, **kw):
        from repro_torch.core.efficientvit import mbconv
        return mbconv(params, x, stride=site.stride)
