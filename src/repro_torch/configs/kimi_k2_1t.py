"""kimi-k2-1t-a32b — trillion-parameter MoE, 384 experts top-8.
[arXiv:2501.kimi2; unverified tier]
61L d_model=7168 64H (GQA kv=8) d_ff=2048(per-expert) vocab=163840
Training this arch requires ZeRO-1 sharded bf16 optimizer states; see
EXPERIMENTS.md memory table.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv=8, head_dim=112,
    d_ff=2048, vocab=163840, n_experts=384, top_k=8,
    capacity_factor=1.0,
    param_dtype="bfloat16",
)
