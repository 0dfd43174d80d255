"""gemma3-12b — dense GQA with 5:1 local:global attention, 128k context.
[hf:google/gemma-3 family; unverified tier]
48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144
Local layers: 1024-token sliding window.  Global layers: full attention
(relu_linear at the long_500k shape per DESIGN.md §6).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b", family="gemma3",
    n_layers=48, d_model=3840, n_heads=16, n_kv=8, head_dim=240,
    d_ff=15360, vocab=262144, window=1024, global_every=6,
    rope_theta=1e6,
    param_dtype="bfloat16",
)
