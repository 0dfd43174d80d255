"""Fused MSA module + its registry impl.

``msa_fused_apply`` runs one EfficientViT MSA module with every
multi-scale branch, image and head in ONE attention launch: the
branches are stacked, and the q/k/v split (``[Q heads | K heads |
V heads]`` channel order) reaches the kernel as strided views.  The QKV
projection, aggregation convs and output projection stay plain torch
ops, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import torch

from repro_torch.core.relu_attention import msa_aggregate
from repro_torch.kernels.registry import KernelBase, register
from repro_torch.kernels.relu_attn.kernel import (
    relu_attn_noncausal, relu_attn_smem_bytes)
from repro_torch.layers.conv import pwconv
from repro_torch.layers.norms import batchnorm

__all__ = ["msa_fused_apply", "MsaKernel", "MSA_DEFAULT_BLOCK_N"]

MSA_DEFAULT_BLOCK_N = 256   # token tile of the K/V phase


def msa_fused_apply(params, x, n_heads: int, head_dim: int, *,
                    block_n: int = MSA_DEFAULT_BLOCK_N):
    """x: (B, H, W, C) -> (B, H, W, C); one attention launch."""
    B, H, W, _ = x.shape
    stack = torch.stack(msa_aggregate(params, x, n_heads))  # (S,B,H,W,3T)
    S = stack.shape[0]
    total = n_heads * head_dim
    t = stack.reshape(S * B, H * W, 3, n_heads, head_dim)
    o = relu_attn_noncausal(t[:, :, 0], t[:, :, 1], t[:, :, 2],
                            block_n=block_n)              # (S*B,N,h,d)
    out = o.reshape(S, B, H, W, total).movedim(0, -2)
    out = out.reshape(B, H, W, S * total).to(x.dtype)
    return batchnorm(params["proj_bn"], pwconv(params["proj"], out))


@register
class MsaKernel(KernelBase):
    """(msa, fp): all branches and heads fold into one attention launch;
    the projections stay on the reference conv path."""
    kind, precision, dtype = "msa", "fp", "f32"

    def site_precision(self, params):
        return ("int8" if "qconv" in params["qkv"]
                and "qconv" in params["proj"] else "fp")

    def resolve_precision(self, site_prec, requested):
        # never a fallback: a mismatch keeps the projections on the
        # reference path while the attention core fuses either way
        if requested in ("auto", site_prec):
            return site_prec, None
        return "fp", None

    def smem_bytes(self, site, blocks):
        return relu_attn_smem_bytes(site.attrs["head_dim"],
                                    blocks["block_n"])

    def tune(self, site):
        return {"block_n": MSA_DEFAULT_BLOCK_N}

    def apply(self, params, x, site, decision=None):
        blocks = decision.blocks if decision is not None else {}
        return msa_fused_apply(params, x, site.attrs["heads"],
                               site.attrs["head_dim"],
                               block_n=blocks.get("block_n",
                                                  MSA_DEFAULT_BLOCK_N))

    def ref(self, params, x, site, **kw):
        from repro_torch.core.relu_attention import MSAConfig, msa
        return msa(params, x, MSAConfig(x.shape[-1], site.attrs["head_dim"],
                                        site.attrs["scales"]))
