"""EfficientViT's Lightweight Multi-Scale Attention (MSA), reference path.

Counterpart of ``repro/core/relu_attention.py``:

  1. 1x1 conv projects the input to Q/K/V (``3 * total_dim`` channels,
     laid out [Q heads | K heads | V heads]).
  2. Per scale, a depthwise s x s conv + grouped 1x1 conv (groups =
     3 * heads) over the stacked QKV.
  3. ReLU global attention per branch:
         out = (ReLU(Q) @ (ReLU(K)^T V)) / (ReLU(Q) @ rowsum(ReLU(K)^T))
  4. Concat branches, 1x1 projection + BN.

The fused module (all branches x batch x heads in one kernel launch)
is ``kernels.relu_attn.ops.msa_fused_apply``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.layers.conv import conv2d, init_conv2d, init_pwconv, pwconv
from repro_torch.layers.norms import batchnorm, init_batchnorm

__all__ = ["MSAConfig", "init_msa", "relu_global_attention", "msa",
           "msa_aggregate", "msa_project"]


@dataclasses.dataclass(frozen=True)
class MSAConfig:
    channels: int
    head_dim: int = 16
    scales: Sequence[int] = (5,)
    dtype: torch.dtype = torch.float32

    @property
    def n_heads(self) -> int:
        return self.channels // self.head_dim

    @property
    def total_dim(self) -> int:
        return self.n_heads * self.head_dim


def init_msa(generator, cfg: MSAConfig, device=None):
    qkv_dim = 3 * cfg.total_dim
    kw = dict(bias=False, dtype=cfg.dtype, device=device)
    p = {
        "qkv": init_pwconv(generator, cfg.channels, qkv_dim, **kw),
        "aggreg": [],
        "proj": init_pwconv(generator, (1 + len(cfg.scales)) *
                            cfg.total_dim, cfg.channels, **kw),
        "proj_bn": init_batchnorm(cfg.channels, cfg.dtype, device),
    }
    for s in cfg.scales:
        p["aggreg"].append({
            "dw": init_conv2d(generator, s, qkv_dim, qkv_dim,
                              groups=qkv_dim, **kw),
            "pw": init_conv2d(generator, 1, qkv_dim, qkv_dim,
                              groups=3 * cfg.n_heads, **kw),
        })
    return p


def relu_global_attention(q, k, v, eps: float = 1e-6):
    """q, k, v: (B, N, h, d), non-causal, KV-first: O(N d^2)."""
    pq = torch.relu(q.float())
    pk = torch.relu(k.float())
    vf = v.float()
    kv = torch.einsum("bnhd,bnhe->bhde", pk, vf)
    ksum = pk.sum(dim=1)
    num = torch.einsum("bnhd,bhde->bnhe", pq, kv)
    den = torch.einsum("bnhd,bhd->bnh", pq, ksum)[..., None]
    return (num / torch.clamp(den, min=eps)).to(q.dtype)


def _conv_any(p, x, *, groups=1):
    """A bare conv, fp32 or FIX8 (a ``qconv`` from quantization)."""
    if "qconv" in p:
        from repro_torch.core.quantization import conv2d_int8
        return conv2d_int8(p["qconv"], x, groups=groups)
    if groups == 1 and p["w"].shape[0] == 1:
        return pwconv(p, x)
    return conv2d(p, x, groups=groups)


def msa_aggregate(params, x, n_heads: int):
    """The QKV projection and every multi-scale aggregation branch:
    ``[qkv, agg_s...]``, each (B, H, W, 3 * total)."""
    qkv = _conv_any(params["qkv"], x)
    multi = [qkv]
    for agg in params["aggreg"]:
        a = _conv_any(agg["dw"], qkv, groups=qkv.shape[-1])
        multi.append(_conv_any(agg["pw"], a, groups=3 * n_heads))
    return multi


def msa_project(params, out):
    """The output projection + BN (folded into the ``qconv`` at FIX8)."""
    if "qconv" in params["proj"]:
        return _conv_any(params["proj"], out)
    return batchnorm(params["proj_bn"], pwconv(params["proj"], out))


def msa(params, x, cfg: MSAConfig, *, attention_fn=relu_global_attention):
    """x: (B, H, W, C) -> (B, H, W, C), one attention call per branch."""
    B, H, W, C = x.shape
    outs = []
    for branch in msa_aggregate(params, x, cfg.n_heads):
        t = branch.reshape(B, H * W, 3, cfg.n_heads, cfg.head_dim)
        q, k, v = t[:, :, 0], t[:, :, 1], t[:, :, 2]
        outs.append(attention_fn(q, k, v).reshape(B, H, W, cfg.total_dim))
    return msa_project(params, torch.cat(outs, dim=-1))
