"""Fused MBConv for framework param trees + its registry impl.

``mbconv_apply(params, x)`` consumes the EfficientViT
{'pw1','dw','pw2'} conv+BN triple, folds BN into each conv and runs
``mbconv_fused``.  ``mbconv_apply_int8`` is the FIX8 twin over the
quantized triple (each a ``qconv``): ``mbconv_fused_int8``, or
``mbconv_fused_int8_emit`` when the site's epilogue emits int8.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantization import (
    QTensor, fold_bn_into_conv, quantize_act)
from repro_torch.kernels.autotune import (
    autotune, backend_tag, bench_randn, fault_point, on_card, shape_key,
    tile_work)
from repro_torch.kernels.mbconv.kernel import (
    mbconv_fused, mbconv_fused_int8, mbconv_fused_int8_emit,
    mbconv_int8_path, mbconv_smem_bytes, ranked_blocks)
from repro_torch.kernels.registry import KernelBase, register

__all__ = ["mbconv_apply", "MbconvKernel", "mbconv_apply_int8",
           "MbconvInt8Kernel", "tune_blocks", "TUNE_TOP_K"]

# Candidates the autotuner times per fp32 MBConv shape: the blocks the
# cost model ranks best, its pick first.  The model's pick was within 5 %
# of the sweep's fastest at B1@224; six reach past its ties and its
# misfit at shapes it was not fitted on.
TUNE_TOP_K = 6


def tune_blocks(x_shape, mid: int, f: int, *, stride: int = 1,
                allow_sweep: bool = True, device=None) -> dict:
    """Blocks for an fp32 MBConv shape: the cached or swept choice among
    ``ranked_blocks``' first ``TUNE_TOP_K``, timed on ``mbconv_fused``
    with random inputs of the shape.  ``allow_sweep=False`` gives the
    cost model's pick without reading the cache; off the card, the cached
    choice or the pick.  The key carries the batch (the band height
    follows it)."""
    B, H, W, C = x_shape
    cands = ranked_blocks(x_shape, mid, f, stride, TUNE_TOP_K)
    key = shape_key(batch=B, spatial=(H, W), c=C, mid=mid, f=f,
                    stride=stride, dtype="f32", backend=backend_tag(device))
    if not allow_sweep:
        fault_point("mbconv", key)
        return dict(cands[0])
    bench = None
    if on_card(device):
        x, w1, b1, dw, db, w2, b2 = bench_randn(
            device, (B, H, W, C), (C, mid), (mid,), (3, 3, mid), (mid,),
            (mid, f), (f,), scales=(1.0, C ** -0.5, 1.0, 1 / 3, 1.0,
                                    mid ** -0.5, 1.0))

        def bench(cand):
            return mbconv_fused(x, w1, b1, dw, db, w2, b2, stride=stride,
                                **cand)
    return autotune("mbconv", key, cands, bench)


def mbconv_apply(params, x, *, stride: int = 1,
                 block_rows: int | None = None, block_m: int | None = None,
                 split: int | None = None):
    """Matches ``core.efficientvit.mbconv``: BN folded into all three
    convs, Hardswish after pw1 and dw, bare projection after pw2."""
    w1, b1 = fold_bn_into_conv(params["pw1"]["conv"], params["pw1"]["bn"])
    dw, dw_b = fold_bn_into_conv(params["dw"]["conv"], params["dw"]["bn"])
    w2, b2 = fold_bn_into_conv(params["pw2"]["conv"], params["pw2"]["bn"])
    out = mbconv_fused(x.contiguous(), w1[0, 0].contiguous(), b1,
                       dw[:, :, 0, :].contiguous(), dw_b,
                       w2[0, 0].contiguous(), b2, stride=stride,
                       block_rows=block_rows, block_m=block_m, split=split)
    return out.to(x.dtype)


@register
class MbconvKernel(KernelBase):
    """(mbconv, fp): the PW+DW+PW CUDA kernel behind ``mbconv_apply``."""
    kind, precision, dtype = "mbconv", "fp", "f32"
    batch_dependent_tiles = True   # the band height follows the batch

    def smem_bytes(self, site, blocks):
        return mbconv_smem_bytes(site.in_shape[2], site.out_shape[-1],
                                 site.stride, blocks["block_rows"],
                                 blocks["block_m"])

    def tune(self, site, *, autotune=True, device=None):
        return tune_blocks(site.in_shape, site.attrs["mid"],
                           site.out_shape[-1], stride=site.stride,
                           allow_sweep=autotune, device=device)

    def candidates(self, site):
        return ranked_blocks(site.in_shape, site.attrs["mid"],
                             site.out_shape[-1], site.stride, TUNE_TOP_K)

    def block_work(self, site, blocks):
        return tile_work(site.out_shape[1], blocks["block_rows"])

    def apply(self, params, x, site, decision=None, *, epilogue=None):
        blocks = dict(decision.blocks) if decision is not None else {}
        return mbconv_apply(params, x, stride=site.stride, **blocks)

    def ref(self, params, x, site, **kw):
        from repro_torch.core.efficientvit import mbconv
        return mbconv(params, x, stride=site.stride)


def mbconv_apply_int8(params, x, *, stride: int = 1, epilogue=None):
    """Quantized {'pw1','dw','pw2'} triple -> the FIX8 kernel.  ``x`` is
    the fp activation (quantized here per image, as the reference
    ``conv2d_int8`` does) or a producer's ``QTensor``.  An int8
    ``epilogue`` makes this site the producer: it returns a ``QTensor``
    quantized by the kernel, with the fp output kept under "keep-fp"."""
    q1, qd, q2 = (params[k]["qconv"] for k in ("pw1", "dw", "pw2"))
    if isinstance(x, QTensor):
        x_q, x_scale = x.q, x.scale
        out_dtype = x.fp.dtype if x.fp is not None else torch.float32
    else:
        qt = quantize_act(x)
        x_q, x_scale, out_dtype = qt.q, qt.scale, x.dtype
    args = (x_q.contiguous(), x_scale, q1["q"][0, 0].contiguous(),
            q1["scale"], q1["bias"], qd["q"][:, :, 0, :].contiguous(),
            qd["scale"], qd["bias"], q2["q"][0, 0].contiguous(), q2["scale"],
            q2["bias"])
    if epilogue is not None and epilogue.emits_q:
        q, scales, out = mbconv_fused_int8_emit(*args, stride=stride)
        fp = out.to(out_dtype) if epilogue.residual == "keep-fp" else None
        return QTensor(q, scales, fp)
    return mbconv_fused_int8(*args, stride=stride).to(out_dtype)


@register
class MbconvInt8Kernel(MbconvKernel):
    """(mbconv, int8): the FIX8 PW+DW+PW CUDA kernel, with ``QTensor``
    boundaries on both sides (the int8 dataflow)."""
    precision, dtype = "int8", "i8"
    batch_dependent_tiles = False
    takes_q = True
    emits_q = True

    def smem_bytes(self, site, blocks):
        """One CTA of the path the site's shape takes: the cluster
        kernel's rank, or the largest of the three passes."""
        b, h, w, c = site.in_shape
        return mbconv_int8_path(h, w, c, site.attrs["mid"],
                                site.out_shape[-1], site.stride, b)["smem"]

    def tune(self, site, *, autotune=True, device=None):
        return {}

    def candidates(self, site):
        return ()

    def block_work(self, site, blocks):
        return 1.0

    def apply(self, params, x, site, decision=None, *, epilogue=None):
        return mbconv_apply_int8(params, x, stride=site.stride,
                                 epilogue=epilogue)
