"""Master partition rules for every model family, counterpart of
``repro/distributed/rules.py`` (copied as data).

Rules are (path-regex, logical-axes) applied right-aligned to each param's
trailing dims (leading layer-stack dims stay unsharded).  Logical axes:
``fsdp`` -> ZeRO/data axis, ``tp`` -> model axis, ``ep`` -> expert axis
(shares the model axis), ``vocab`` -> model axis.
"""
from __future__ import annotations

LM_RULES = [
    (r"embed/table$", ("vocab", "fsdp")),
    (r"embed/qt$", ("vocab", "fsdp")),
    (r"embed/scale$", ("vocab", None)),
    (r"lm_head/(w|qw)$", ("fsdp", "vocab")),
    (r"lm_head/scale$", ("vocab",)),
    (r"(attn|self_attn|cross_attn)/w[qkv]/(w|qw)$", ("fsdp", "tp")),
    (r"(attn|self_attn|cross_attn)/wqkv/(w|qw)$", ("fsdp", "tp")),
    (r"(attn|self_attn|cross_attn)/w\w*/scale$", ("tp",)),
    (r"(attn|self_attn|cross_attn)/wqkv/b$", ("tp",)),
    (r"(attn|self_attn|cross_attn)/w[qkv]/b$", ("tp",)),
    (r"(attn|self_attn|cross_attn)/wo/(w|qw)$", ("tp", "fsdp")),
    (r"mlp/w_(in|gate)/(w|qw)$", ("fsdp", "tp")),
    (r"mlp/w_\w*/scale$", ("tp",)),
    (r"mlp/w_in_gate/w$", ("fsdp", "tp")),
    (r"mlp/w_out/(w|qw)$", ("tp", "fsdp")),
    (r"moe/router/w$", ()),
    (r"moe/w_(in|gate)$", ("ep", "fsdp", "tp")),
    (r"moe/w_(in|gate)/q$", ("ep", "fsdp", "tp")),
    (r"moe/w_\w*/scale$", ("ep", None, "tp")),
    (r"moe/w_out$", ("ep", "tp", "fsdp")),
    (r"moe/w_out/q$", ("ep", "tp", "fsdp")),
    (r"mixer/in_proj/(w|qw)$", ("fsdp", "tp")),
    (r"mixer/out_proj/(w|qw)$", ("tp", "fsdp")),
    (r"mixer/\w*_proj/scale$", ("tp",)),
    (r"mixer/conv_w$", (None, "tp")),
    (r"mixer/norm/scale$", ("tp",)),
    (r"head/fc[12]/w$", ("fsdp", "tp")),
]

# Decode caches: KV tensors are (L..., B, S, n_kv, head_dim); Mamba/linear
# states are (L..., B, ...).  Batch rides the data axes; the KV *sequence*
# dim rides the model axis ("sp_kv") — at 32k context the cache is the
# dominant per-device allocation and kv-head counts (8) don't divide the
# 16-way model axis, so context sharding is what fits (context-parallel
# decode); heads pick up whatever axis is left.
CACHE_RULES = [
    (r"/(k|v|ck|cv)$", ("dp", "sp_kv", "heads", None)),
    (r"/state$", ("dp", "heads", None, None)),
    (r"/zsum$", ("dp", "heads", None)),
    (r"/conv$", ("dp", None, "tp")),
    (r"/ssm$", ("dp", "tp", None, None)),
]
