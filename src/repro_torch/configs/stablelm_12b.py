"""stablelm-12b — dense GQA transformer.
[hf:stabilityai/stablelm-2-1_6b family; 12B scale per assignment]
40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv=8, head_dim=160,
    d_ff=13824, vocab=100352,
    param_dtype="bfloat16",
)
