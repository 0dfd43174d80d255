"""granite-3-2b — dense GQA transformer.
[hf:ibm-granite/granite-3.0-2b-base]
40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv=8, head_dim=64,
    d_ff=8192, vocab=49155,
    param_dtype="bfloat16",
)
