"""Architecture + shape configuration schema, counterpart of
``repro/configs/base.py``.

One ``ArchConfig`` describes any of the 10 assigned LM-family archs
(dense / MoE / SSM / hybrid / enc-dec / VLM).  ``ShapeSpec`` describes the
four assigned input shapes.  ``supports()`` encodes the skip policy for
``long_500k`` (sub-quadratic only) per DESIGN.md §6.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | mamba2 | zamba2 | gemma3 | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0              # 0 for attention-free archs
    n_kv: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab: int = 32000
    # attention
    attn_backend: str = "softmax"     # softmax | sliding | relu_linear
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: int = 1024                # sliding / gemma3 local window
    global_every: int = 6             # gemma3: 1 global per this many layers
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    shared_attn_every: int = 6        # zamba2
    # enc-dec
    dec_layers: int = 0               # 0 -> decoder-only
    # vlm
    n_patches: int = 0
    # numerics / execution
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    loss_chunk: int = 1024
    flash_vjp: bool = False
    fused_qkv: bool = False
    fused_mlp: bool = False
    score_dtype: str = "float32"
    pad_heads_to: int = 0
    grad_accum: int = 1
    zero_infer: bool = True       # False: replicate params over data for
                                  # inference (no per-token ZeRO gather)
    w8: bool = False              # weight-only int8 (FIX8) at inference
    kv_dtype: str = "bfloat16"    # decode-cache dtype (float8_e4m3fn: 2x)
    q_chunk: int = 1024
    kv_chunk: int = 1024
    ssm_chunk: int = 256
    notes: str = ""

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def scaled(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# archs whose faithful config is sub-quadratic enough for 500k decode:
#   mamba2 (pure SSM, O(1) state), zamba2 (hybrid; its shared global-attn
#   slot runs the paper's relu_linear backend at this shape -> O(1) state),
#   gemma3 (5:1 local layers have bounded window KV; global layers switch
#   to relu_linear at this shape).
_LONG_OK_FAMILIES = {"mamba2", "zamba2", "gemma3"}


def supports(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runnable, reason).  Encodes the DESIGN.md §6 long_500k policy."""
    if shape.name == "long_500k" and cfg.family not in _LONG_OK_FAMILIES:
        if cfg.attn_backend == "relu_linear":
            return True, "relu_linear backend: O(1) decode state"
        return False, ("pure full-attention arch: 524k-token softmax KV is "
                       "outside the model's regime (DESIGN.md §6); see the "
                       "relu_linear beyond-paper cell in EXPERIMENTS §Perf")
    return True, ""


def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    kw: dict = dict(
        n_layers=min(cfg.n_layers, 2 if cfg.family != "zamba2" else 4),
        d_model=64, d_ff=128 if cfg.d_ff else 0, vocab=128,
        loss_chunk=64, q_chunk=32, kv_chunk=32, ssm_chunk=32,
        param_dtype="float32", compute_dtype="float32",
    )
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv=max(1, min(cfg.n_kv, 2)), head_dim=16)
    if cfg.n_experts:
        kw.update(n_experts=4, top_k=min(cfg.top_k, 2))
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16)
    if cfg.window:
        kw.update(window=32)
    if cfg.dec_layers:
        kw.update(dec_layers=2)
    if cfg.n_patches:
        kw.update(n_patches=8)
    if cfg.family == "zamba2":
        kw.update(shared_attn_every=2)
    if cfg.family == "gemma3":
        kw.update(n_layers=6, global_every=3)
    return cfg.scaled(**kw)
