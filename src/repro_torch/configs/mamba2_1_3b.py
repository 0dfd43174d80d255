"""mamba2-1.3b — pure SSM (attention-free), SSD.
[arXiv:2405.21060]
48L d_model=2048 d_ff=0 (no FFN; Mamba-2 blocks subsume channel mixing)
vocab=50280, ssm_state=128
The paper's attention technique is inapplicable (attention-free); SSD
shares the chunked-state kernel skeleton (DESIGN.md §6).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b", family="mamba2",
    n_layers=48, d_model=2048, d_ff=0, vocab=50280,
    ssm_state=128, ssm_head_dim=64,
    param_dtype="bfloat16",
)
