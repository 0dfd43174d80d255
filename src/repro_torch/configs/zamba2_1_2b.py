"""zamba2-1.2b — hybrid: Mamba-2 backbone + shared attention block.
[arXiv:2411.15242]
38L d_model=2048 32H (MHA kv=32) d_ff=8192 vocab=32000, ssm_state=64
Shared transformer block invoked every 6 Mamba layers (weights shared;
Zamba's per-invocation LoRA deltas omitted — DESIGN.md §9).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="zamba2",
    n_layers=38, d_model=2048, n_heads=32, n_kv=32, head_dim=64,
    d_ff=8192, vocab=32000, ssm_state=64, ssm_head_dim=64,
    shared_attn_every=6,
    param_dtype="bfloat16",
)
