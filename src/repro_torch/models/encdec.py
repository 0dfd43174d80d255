"""Encoder-decoder transformer (the seamless-m4t backbone), counterpart
of ``repro/models/encdec.py`` for serving.

The encoder takes precomputed frame embeddings (the modality frontend is
a stub, as in JAX) and runs non-causal softmax attention; the decoder is
a causal LM with cross attention into the encoder's memory.  Both
stacks keep JAX's stacked layout ((L, ...) leaves under ``enc_blocks``
and ``dec_blocks``); where JAX scans over the stacked axis, the port
loops over it in Python, as ``models/lm.py`` does.

Serving: ``init_encdec_state`` runs the encoder once and keeps each
decoder layer's cross K/V beside zero self-attention caches;
``encdec_decode_step`` decodes one token against them.  ``decode_train``
is the cache-free forward (the oracle of the tests and of the chip
gate).  Training: ``encdec_loss``, ``chunked_ce_loss`` over
``decode_train`` of ``encode``; each encoder and decoder block runs
under ``_maybe_remat`` (a checkpoint only when ``cfg.remat`` is set and
grad is enabled), as JAX's.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.tp import Block, held_block, spec_block, to_spec
from repro_torch.layers.attention import (
    _heads_of, _qkv_blocks, _wo, attention, attention_decode,
    block_softmax, cross_attention, cross_kv, init_attention, init_kv_cache)
from repro_torch.layers.linear import embed, init_embedding, init_linear
from repro_torch.layers.mlp import init_mlp, mlp
from repro_torch.layers.norms import init_rmsnorm, rmsnorm
from repro_torch.common.tree import tree_map
from repro_torch.models.lm import (
    _at, _maybe_remat, _stack, _stacked_init, _unstack, attn_cfg,
    chunked_ce_terms, lm_logits_head, mlp_cfg, spec_at)

__all__ = ["init_enc_block", "init_dec_block", "init_encdec", "encode",
           "decode_train", "encdec_loss", "encdec_loss_terms",
           "init_encdec_state",
           "encdec_decode_step"]


def init_enc_block(generator: torch.Generator, cfg: ArchConfig,
                   device=None):
    return {"ln1": init_rmsnorm(cfg.d_model, cfg.pdtype, device),
            "attn": init_attention(generator, attn_cfg(cfg, "softmax"),
                                   device),
            "ln2": init_rmsnorm(cfg.d_model, cfg.pdtype, device),
            "mlp": init_mlp(generator, mlp_cfg(cfg), device)}


def init_dec_block(generator: torch.Generator, cfg: ArchConfig,
                   device=None):
    acfg = attn_cfg(cfg, "softmax")
    return {"ln1": init_rmsnorm(cfg.d_model, cfg.pdtype, device),
            "self_attn": init_attention(generator, acfg, device),
            "ln2": init_rmsnorm(cfg.d_model, cfg.pdtype, device),
            "cross_attn": init_attention(generator, acfg, device),
            "ln3": init_rmsnorm(cfg.d_model, cfg.pdtype, device),
            "mlp": init_mlp(generator, mlp_cfg(cfg), device)}


def init_encdec(generator: torch.Generator, cfg: ArchConfig, device=None):
    """Random params drawn from ``generator`` (on its device), placed on
    ``device``."""
    return {
        "embed": init_embedding(generator, cfg.vocab, cfg.d_model,
                                cfg.pdtype, device),
        "enc_blocks": _stacked_init(generator, cfg, "enc", (cfg.n_layers,),
                                    device, init_enc_block),
        "enc_norm": init_rmsnorm(cfg.d_model, cfg.pdtype, device),
        "dec_blocks": _stacked_init(generator, cfg, "dec",
                                    (cfg.dec_layers,), device,
                                    init_dec_block),
        "final_norm": init_rmsnorm(cfg.d_model, cfg.pdtype, device),
        "lm_head": init_linear(generator, cfg.d_model, cfg.vocab,
                               dtype=cfg.pdtype, device=device),
    }


def encode(params, frames, cfg: ArchConfig):
    """frames: (B, S_enc, D) stub embeddings -> encoder memory (B, S_enc,
    D)."""
    x = frames.to(cfg.cdtype)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    acfg = dataclasses.replace(attn_cfg(cfg, "softmax"), causal=False)

    def block(p, h):
        h = h + attention(p["attn"], rmsnorm(p["ln1"], h, cfg.norm_eps),
                          acfg, positions)
        return h + mlp(p["mlp"], rmsnorm(p["ln2"], h, cfg.norm_eps),
                       mlp_cfg(cfg))

    block = _maybe_remat(block, cfg)
    for p in _unstack(params["enc_blocks"]):
        x = block(p, x)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def decode_train(params, dec_tokens, memory, cfg: ArchConfig):
    """The cache-free decoder forward: tokens (B, S) over ``memory`` ->
    final hidden states (B, S, D)."""
    x = embed(params["embed"], dec_tokens, cfg.cdtype, cfg.vocab)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    acfg = attn_cfg(cfg, "softmax")

    def block(p, h, memory):
        h = h + attention(p["self_attn"], rmsnorm(p["ln1"], h, cfg.norm_eps),
                          acfg, positions)
        h = h + cross_attention(p["cross_attn"],
                                rmsnorm(p["ln2"], h, cfg.norm_eps), memory,
                                acfg)
        return h + mlp(p["mlp"], rmsnorm(p["ln3"], h, cfg.norm_eps),
                       mlp_cfg(cfg))

    block = _maybe_remat(block, cfg)
    for p in _unstack(params["dec_blocks"]):
        x = block(p, x, memory)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


def encdec_loss(params, batch, cfg: ArchConfig):
    """batch: {"frames": (B, S_enc, D), "tokens": (B, S_dec), "targets":
    (B, S_dec)[, "mask"]} -> the scalar fp32 cross-entropy."""
    tot, cnt, _ = encdec_loss_terms(params, batch, cfg)
    return tot / torch.clamp(cnt, min=1.0)


def encdec_loss_terms(params, batch, cfg: ArchConfig):
    """``encdec_loss``'s terms: (cross-entropy sum, token weight sum,
    0.0 for the aux loss it does not have)."""
    memory = encode(params, batch["frames"], cfg)
    h = decode_train(params, batch["tokens"], memory, cfg)
    return chunked_ce_terms(params, h, batch["targets"], cfg,
                            batch.get("mask")) + (0.0,)


# ---------------------------------------------------------------------------
# decode (serving): the cross K/V computed once per request batch
# ---------------------------------------------------------------------------

def init_encdec_state(params, frames, cfg: ArchConfig, max_len: int,
                      dtype=torch.bfloat16, specs=None):
    """Run the encoder; each decoder layer's cross K/V (L, B, S_enc, KV,
    Dh) and zero self-attention caches (L, B, ``max_len``, KV, Dh), all in
    ``dtype``.  ``specs``: the state's spec tree under the installed
    ``ShardingCtx`` (the sharded prefill step): each leaf is the rank's
    block."""
    memory = encode(params, frames, cfg)
    acfg = attn_cfg(cfg, "softmax")
    B = memory.shape[0]
    cross = [cross_kv(_at(params["dec_blocks"], i)["cross_attn"], memory,
                      acfg, dtype,
                      None if specs is None else spec_at(specs, ("cross", i)))
             for i in range(cfg.dec_layers)]
    self_caches = tree_map(
        lambda a: a.new_zeros((cfg.dec_layers,) + tuple(a.shape)),
        init_kv_cache(acfg, B, max_len, dtype, memory.device))
    if specs is not None:
        self_caches = tree_map(to_spec, self_caches, specs["self"])
    return {"cross": _stack(cross), "self": self_caches}


def _cross_decode(p, x, ck, cv, acfg, spec=None):
    """One token's cross attention against the cached memory K/V;
    ``spec``: ck's spec when ck, cv are the rank's blocks (the softmax
    combined over sequence blocks; the rank's heads where the heads are
    split, their output reaching ``wo``'s rows, as
    ``attention_decode``'s)."""
    B = x.shape[0]
    g = acfg.n_heads // acfg.n_kv
    Dh = acfg.head_dim
    kvb = spec_block(spec, 2, acfg.n_kv)
    kv = kvb.stop - kvb.start
    seq_axes = held_block(spec, 1, ck.shape[1]).axes
    heads = Block(acfg.n_heads, kvb.start * g, kvb.stop * g, kvb.axes)
    q = _heads_of(_qkv_blocks(p, x, acfg, ("q",))["q"], heads, Dh)
    qf = q.reshape(B, kv, g, Dh).float() * Dh ** -0.5
    s = torch.einsum("bkgd,bckd->bkgc", qf, ck.float())
    o = block_softmax(s, cv, seq_axes)
    return _wo(p, o.reshape(B, 1, kv * g, Dh), heads, acfg, x.dtype)


def encdec_decode_step(params, state, tokens, pos, cfg: ArchConfig,
                       specs=None):
    """tokens: (B, 1); ``pos`` one int or a (B,) tensor -> (logits (B, V),
    new state); the input state is not written.  ``specs``: the state's
    spec tree when it is the rank's blocks under the installed
    ``ShardingCtx``."""
    x = embed(params["embed"], tokens, cfg.cdtype, cfg.vocab)
    acfg = attn_cfg(cfg, "softmax")
    new_self = []
    for i in range(cfg.dec_layers):
        p = _at(params["dec_blocks"], i)
        y, sc = attention_decode(
            p["self_attn"], rmsnorm(p["ln1"], x, cfg.norm_eps),
            _at(state["self"], i), pos, acfg,
            None if specs is None else spec_at(specs, ("self", i)))
        new_self.append(sc)
        x = x + y
        x = x + _cross_decode(
            p["cross_attn"], rmsnorm(p["ln2"], x, cfg.norm_eps),
            state["cross"]["ck"][i], state["cross"]["cv"][i], acfg,
            None if specs is None else spec_at(specs, ("cross", i))["ck"])
        x = x + mlp(p["mlp"], rmsnorm(p["ln3"], x, cfg.norm_eps),
                    mlp_cfg(cfg))
    h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = lm_logits_head(params, h, cfg)
    return logits[:, 0, :], {"cross": state["cross"],
                             "self": _stack(new_self)}
