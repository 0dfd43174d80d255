"""internvl2-1b — VLM: InternViT frontend (stub) + InternLM2/Qwen2 backbone.
[arXiv:2404.16821]
24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655
The vision frontend is a stub per assignment spec: input_specs() provides
precomputed patch embeddings (256 patches).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv=2, head_dim=64,
    d_ff=4864, vocab=151655, n_patches=256,
    param_dtype="bfloat16",
)
