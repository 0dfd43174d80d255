"""grok-1-314b — MoE, 8 experts top-2.
[hf:xai-org/grok-1; unverified tier]
64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv=8, head_dim=128,
    d_ff=32768, vocab=131072, n_experts=8, top_k=2,
    capacity_factor=1.25,
    param_dtype="bfloat16",
)
