"""Fused DSConv for framework param trees + its registry impls.

``dsconv_apply(params, x)`` consumes the EfficientViT {'dw','pw'}
conv+BN block pair, folds BN into both convs and runs ``dsconv_fused``.
``dsconv_apply_int8`` is the FIX8 twin over the quantized pair (each a
``qconv``), running ``dsconv_fused_int8`` or, for an int8 epilogue,
``dsconv_fused_int8_emit``.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantization import (
    QTensor, fold_bn_into_conv, quantize_act)
from repro_torch.kernels.autotune import (
    autotune, backend_tag, bench_randn, fault_point, on_card, shape_key,
    tile_work)
from repro_torch.kernels.dsconv.kernel import (
    choose_blocks, dsconv_fused, dsconv_fused_int8, dsconv_fused_int8_emit,
    dsconv_int8_path, dsconv_smem_bytes)
from repro_torch.kernels.registry import SMEM_LIMIT, KernelBase, register

__all__ = ["dsconv_apply", "DsconvKernel", "dsconv_apply_int8",
           "DsconvInt8Kernel", "candidate_rows", "tune_blocks"]


def candidate_rows(shape, f: int, stride: int) -> tuple:
    """The band heights the autotuner times for an fp32 DSConv shape:
    ``choose_blocks``' pick first, then twice, half, one more and one
    fewer row, four times and a quarter of it, where they fit one CTA
    (the pick alone where none fits)."""
    B, H, W, C = shape
    ho = H // stride
    r = choose_blocks(shape, f, stride)["block_rows"]
    out = []
    for v in (r, 2 * r, r // 2, r + 1, r - 1, 4 * r, r // 4):
        if 1 <= v <= ho and v not in out and \
                dsconv_smem_bytes(W, C, f, stride, v) <= SMEM_LIMIT:
            out.append(v)
    # nothing fits: the pick alone, which the planner's fit check declines
    return tuple({"block_rows": v} for v in out or [r])


def tune_blocks(x_shape, f: int, *, stride: int = 1,
                allow_sweep: bool = True, device=None) -> dict:
    """``{"block_rows"}`` for an fp32 DSConv shape: the cached or swept
    choice among ``candidate_rows``, timed on ``dsconv_fused`` with random
    inputs of the shape.  ``allow_sweep=False`` gives ``choose_blocks``'
    pick without reading the cache; off the card, the cached choice or the
    pick."""
    B, H, W, C = x_shape
    key = shape_key(batch=B, spatial=(H, W), c=C, f=f, stride=stride,
                    dtype="f32", backend=backend_tag(device))
    cands = candidate_rows(x_shape, f, stride)
    if not allow_sweep:
        fault_point("dsconv", key)
        return dict(cands[0])
    bench = None
    if on_card(device):
        x, dw, db, pw, pb = bench_randn(
            device, (B, H, W, C), (3, 3, C), (C,), (C, f), (f,),
            scales=(1.0, 1 / 3, 1.0, C ** -0.5, 1.0))

        def bench(cand):
            return dsconv_fused(x, dw, db, pw, pb, stride=stride, act=True,
                                **cand)
    return autotune("dsconv", key, cands, bench)


def dsconv_apply(params, x, *, stride: int = 1,
                 block_rows: int | None = None):
    """{'dw': conv+bn, 'pw': conv+bn} -> fused kernel: BN folded into
    both convs, Hardswish between them, bare projection after."""
    dw_w4, dw_b = fold_bn_into_conv(params["dw"]["conv"], params["dw"]["bn"])
    pw_w4, pw_b = fold_bn_into_conv(params["pw"]["conv"], params["pw"]["bn"])
    out = dsconv_fused(x.contiguous(), dw_w4[:, :, 0, :].contiguous(), dw_b,
                       pw_w4[0, 0].contiguous(), pw_b, stride=stride,
                       act=True, block_rows=block_rows)
    return out.to(x.dtype)


@register
class DsconvKernel(KernelBase):
    """(dsconv, fp): the DW+PW CUDA kernel behind ``dsconv_apply``."""
    kind, precision, dtype = "dsconv", "fp", "f32"
    batch_dependent_tiles = True   # the band height follows the batch

    def smem_bytes(self, site, blocks):
        _, _, W, C = site.in_shape
        return dsconv_smem_bytes(W, C, site.out_shape[-1], site.stride,
                                 blocks["block_rows"])

    def tune(self, site, *, autotune=True, device=None):
        return tune_blocks(site.in_shape, site.out_shape[-1],
                           stride=site.stride, allow_sweep=autotune,
                           device=device)

    def candidates(self, site):
        return candidate_rows(site.in_shape, site.out_shape[-1],
                              site.stride)

    def block_work(self, site, blocks):
        return tile_work(site.out_shape[1], blocks["block_rows"])

    def apply(self, params, x, site, decision=None, *, epilogue=None):
        blocks = dict(decision.blocks) if decision is not None else {}
        return dsconv_apply(params, x, stride=site.stride, **blocks)

    def ref(self, params, x, site, **kw):
        from repro_torch.core.efficientvit import dsconv
        return dsconv(params, x, stride=site.stride)


def dsconv_apply_int8(params, x, *, stride: int = 1, epilogue=None):
    """Quantized {'dw','pw'} pair -> the FIX8 kernel.  ``x`` is the fp
    activation (quantized here per image, as the reference
    ``conv2d_int8`` does) or a producer's ``QTensor``.  An int8
    ``epilogue`` makes this site the producer: it returns a ``QTensor``
    quantized by the kernel, with the fp output kept under "keep-fp"."""
    qd, qp = params["dw"]["qconv"], params["pw"]["qconv"]
    if isinstance(x, QTensor):
        x_q, x_scale = x.q, x.scale
        out_dtype = x.fp.dtype if x.fp is not None else torch.float32
    else:
        qt = quantize_act(x)
        x_q, x_scale, out_dtype = qt.q, qt.scale, x.dtype
    args = (x_q.contiguous(), x_scale, qd["q"][:, :, 0, :].contiguous(),
            qd["scale"], qd["bias"], qp["q"][0, 0].contiguous(), qp["scale"],
            qp["bias"])
    if epilogue is not None and epilogue.emits_q:
        keep_fp = epilogue.residual == "keep-fp"
        outs = dsconv_fused_int8_emit(*args, stride=stride, act=True,
                                      keep_fp=keep_fp)
        fp = outs[2].to(out_dtype) if keep_fp else None
        return QTensor(outs[0], outs[1], fp)
    return dsconv_fused_int8(*args, stride=stride, act=True).to(out_dtype)


@register
class DsconvInt8Kernel(DsconvKernel):
    """(dsconv, int8): the FIX8 DW+PW CUDA kernel; takes a producer's
    ``QTensor`` and emits its own output through the emitting variant
    (a residual site such as ``stem.ds0`` quantizes after its add, in
    ``execute``)."""
    precision, dtype = "int8", "i8"
    batch_dependent_tiles = False
    takes_q = True
    emits_q = True

    def smem_bytes(self, site, blocks):
        _, H, W, C = site.in_shape
        return dsconv_int8_path(H, W, C, site.out_shape[-1],
                                site.stride)["smem"]

    def tune(self, site, *, autotune=True, device=None):
        return {}

    def candidates(self, site):
        return ()

    def block_work(self, site, blocks):
        return 1.0

    def apply(self, params, x, site, decision=None, *, epilogue=None):
        return dsconv_apply_int8(params, x, stride=site.stride,
                                 epilogue=epilogue)
