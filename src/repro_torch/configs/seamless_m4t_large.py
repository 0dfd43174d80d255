"""seamless-m4t-large-v2 — encoder-decoder, multimodal (audio frontend stub).
[arXiv:2308.11596]
24L enc + 24L dec, d_model=1024 16H (kv=16) d_ff=8192 vocab=256206
input_specs() provides precomputed frame embeddings for the encoder.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, dec_layers=24, d_model=1024, n_heads=16, n_kv=16,
    head_dim=64, d_ff=8192, vocab=256206,
    param_dtype="bfloat16",
)
