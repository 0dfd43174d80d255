"""EfficientViT backbone blocks and params, counterpart of
``repro/core/efficientvit.py``.

The network walk lives in one place, ``core.program.lower``; this module
owns the config, param init and the reference block forwards.  Params
are plain dict/list trees with the JAX package's keys, so
``Site.param_path`` resolves in both.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.common.device import resolve_device, scalar, tree_to
from repro_torch.core.relu_attention import MSAConfig, init_msa
from repro_torch.layers.conv import conv2d, init_conv2d
from repro_torch.layers.norms import batchnorm, init_batchnorm

__all__ = ["EfficientViTConfig", "B1", "B1_SMOKE", "B2", "B3", "OpRecord",
           "init_efficientvit", "conv_bn_act", "dsconv", "mbconv",
           "hardswish"]


@dataclasses.dataclass(frozen=True)
class EfficientViTConfig:
    name: str = "efficientvit-b1"
    widths: Sequence[int] = (16, 32, 64, 128, 256)
    depths: Sequence[int] = (1, 2, 3, 3, 4)
    head_dim: int = 16
    msa_scales: Sequence[int] = (5,)
    expand_ratio: int = 4
    head_widths: Sequence[int] = (1536, 1600)
    num_classes: int = 1000
    image_size: int = 224
    dtype: torch.dtype = torch.float32


B1 = EfficientViTConfig()
B1_SMOKE = EfficientViTConfig(
    name="efficientvit-b1-smoke", widths=(8, 16, 24, 32, 48),
    depths=(1, 1, 1, 1, 1), head_widths=(64, 64), num_classes=10,
    image_size=64)
# B2 and B3 as the JAX package defines them (Cai et al., ICCV'23):
# 32-wide heads, 1000 classes at 224 px
B2 = EfficientViTConfig(
    name="efficientvit-b2", widths=(24, 48, 96, 192, 384),
    depths=(1, 3, 4, 4, 6), head_dim=32, head_widths=(2304, 2560))
B3 = EfficientViTConfig(
    name="efficientvit-b3", widths=(32, 64, 128, 256, 512),
    depths=(1, 4, 6, 6, 9), head_dim=32, head_widths=(2304, 2560))


def hardswish(x):
    """``jax.nn.hard_swish`` as JAX runs it op by op: x * (relu6(x + 3)
    / 6), in that order, with a true division on every device (a Python
    scalar divisor becomes a reciprocal multiply on CUDA tensors)."""
    return x * (torch.clamp(x + 3.0, 0.0, 6.0) / scalar(6.0, x.device))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def init_conv_bn(generator, k, c_in, c_out, dtype, device, *, groups=1):
    return {
        "conv": init_conv2d(generator, k, c_in, c_out, groups=groups,
                            bias=False, dtype=dtype, device=device),
        "bn": init_batchnorm(c_out, dtype, device),
    }


def conv_bn_act(p, x, *, stride=1, groups=1, act=True):
    """fp32 conv + BN, or the FIX8 folded conv when the block was
    quantized by ``core.quantization.quantize_efficientvit``."""
    if "qconv" in p:
        from repro_torch.core.quantization import conv2d_int8
        y = conv2d_int8(p["qconv"], x, stride=stride, groups=groups)
    else:
        y = batchnorm(p["bn"], conv2d(p["conv"], x, stride=stride,
                                      groups=groups))
    return hardswish(y) if act else y


def init_dsconv(generator, c_in, c_out, dtype, device):
    return {
        "dw": init_conv_bn(generator, 3, c_in, c_in, dtype, device,
                           groups=c_in),
        "pw": init_conv_bn(generator, 1, c_in, c_out, dtype, device),
    }


def dsconv(p, x, *, stride=1):
    y = conv_bn_act(p["dw"], x, stride=stride, groups=x.shape[-1])
    return conv_bn_act(p["pw"], y, act=False)


def init_mbconv(generator, c_in, c_out, expand, dtype, device):
    mid = c_in * expand
    return {
        "pw1": init_conv_bn(generator, 1, c_in, mid, dtype, device),
        "dw": init_conv_bn(generator, 3, mid, mid, dtype, device,
                           groups=mid),
        "pw2": init_conv_bn(generator, 1, mid, c_out, dtype, device),
    }


def mbconv(p, x, *, stride=1):
    """PWConv -> DWConv -> PWConv, BN+Hardswish on all but the last."""
    y = conv_bn_act(p["pw1"], x)
    y = conv_bn_act(p["dw"], y, stride=stride, groups=y.shape[-1])
    return conv_bn_act(p["pw2"], y, act=False)


def init_evit_module(generator, c, head_dim, scales, expand, dtype, device):
    return {
        "msa": init_msa(generator, MSAConfig(c, head_dim, scales, dtype),
                        device),
        "mbconv": init_mbconv(generator, c, c, expand, dtype, device),
    }


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def init_efficientvit(generator: torch.Generator,
                      cfg: EfficientViTConfig = B1, device="cuda"):
    """Random params from ``generator`` (a CPU ``torch.Generator``),
    placed on ``device``.  ``device="cuda"`` without a card raises."""
    dev = resolve_device(device)
    w, d, dt = cfg.widths, cfg.depths, cfg.dtype
    params = {"stem_conv": init_conv_bn(generator, 3, 3, w[0], dt, None)}
    params["stem_ds"] = [init_dsconv(generator, w[0], w[0], dt, None)
                         for _ in range(d[0])]
    for si in (1, 2):
        blocks = []
        c_in = w[si - 1]
        for _ in range(d[si]):
            blocks.append(init_mbconv(generator, c_in, w[si],
                                      cfg.expand_ratio, dt, None))
            c_in = w[si]
        params[f"stage{si}"] = blocks
    for si in (3, 4):
        down = init_mbconv(generator, w[si - 1], w[si], cfg.expand_ratio,
                           dt, None)
        blocks = [init_evit_module(generator, w[si], cfg.head_dim,
                                   tuple(cfg.msa_scales), cfg.expand_ratio,
                                   dt, None) for _ in range(d[si])]
        params[f"stage{si}"] = {"down": down, "blocks": blocks}
    hw1, hw2 = cfg.head_widths
    params["head"] = {
        "conv": init_conv_bn(generator, 1, w[4], hw1, dt, None),
        "fc1": {"w": (torch.randn((hw1, hw2), generator=generator)
                      * hw1 ** -0.5).to(dt)},
        "fc2": {"w": (torch.randn((hw2, cfg.num_classes),
                                  generator=generator)
                      * hw2 ** -0.5).to(dt)},
    }
    return tree_to(params, dev)


# ---------------------------------------------------------------------------
# layer manifest records (the cycle model's input)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OpRecord:
    stage: str
    name: str
    kind: str          # conv | pw | dw | matmul | group_pw
    h: int             # output spatial height (or M rows for matmul)
    w: int             # output spatial width (or 1 for matmul)
    c_in: int          # reduction length (C_in * k * k for conv)
    c_out: int
    k: int = 1
    fused_with_prev: bool = False

    @property
    def macs(self) -> int:
        if self.kind == "dw":
            return self.h * self.w * self.c_out * self.k * self.k
        return self.h * self.w * self.c_out * self.c_in * (
            self.k * self.k if self.kind == "conv" else 1)

    @property
    def reduction(self) -> int:
        if self.kind == "dw":
            return self.k * self.k
        if self.kind == "conv":
            return self.c_in * self.k * self.k
        return self.c_in
