"""Decoder-only LM, counterpart of ``repro/models/lm.py``:

  dense   — a uniform [attention + MLP] stack (stablelm, granite,
            qwen2.5)
  moe     — a uniform [attention + MoE] stack (grok-1, kimi-k2)
  vlm     — the dense stack over [patch embeddings | text embeddings]
            (internvl2; the vision frontend is a stub, as in JAX)
  gemma3  — groups of (global_every - 1) sliding-window layers and one
            global layer (softmax, or the paper's relu_linear attention
            when the arch's backend is relu_linear: DESIGN §6)
  mamba2  — a uniform [Mamba-2] stack (attention-free)
  zamba2  — a Mamba-2 backbone with ONE shared [attention + MLP] block
            invoked after every ``shared_attn_every`` Mamba layers
            (weights reused)

The param and cache trees keep JAX's stacked layout leaf for leaf: a
uniform stack's leaves are (L, ...); gemma3's ``local`` leaves are
(groups, global_every - 1, ...) and its ``global`` leaves (groups, ...);
zamba2's Mamba layers are (groups, every, ...) under ``mamba_groups``
plus (rem, ...) under ``mamba_tail``, and the shared block's caches are
(groups, ...).  Where JAX scans over the stacked axis, the port loops
over it in Python.

``reference=True`` (prefill only: decode runs no scan) routes both scans
to their plain versions on any device; the served path never takes it.

``forward_hidden`` sums the MoE layers' aux losses, as JAX's scan
does (only training reads it).  Decode runs each row's MoE as a group of
its own (``layers/moe.py``: the capacity of one token, as JAX's engine
``vmap``s a batch-1 step over its slots); prefill routes the batch as
one group, as JAX's.  The encoder-decoder is ``models/encdec.py``.
Training: ``lm_loss`` (the chunked cross-entropy ``chunked_ce_loss``
plus the MoE aux loss, as JAX's) is differentiable end to end: the two
scan kernels through ``kernels/recompute.py``, softmax and sliding
attention through autograd or, with ``flash_vjp=True``,
``layers/flash.py``.  With ``cfg.remat`` and grad enabled every block
runs under ``torch.utils.checkpoint`` (JAX's ``jax.checkpoint``: the
stacks' blocks, gemma3's global block, zamba2's shared block), so its
forward, kernel launches included, runs again in the backward; serving
runs no grad and is unchanged.  A stacked leaf is unbound once per
forward, so its blocks' gradients come back as one stacked tensor.
"""
from __future__ import annotations

import itertools
from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.ctx import current_ctx, use_sharding
from repro_torch.distributed.tp import param_block
from repro_torch.layers.attention import (
    AttnConfig, attention, attention_decode, init_attention, init_kv_cache)
from repro_torch.layers.linear import (
    embed, init_embedding, init_linear, linear)
from repro_torch.layers.mamba2 import (
    Mamba2Config, init_mamba2, init_mamba2_cache, mamba2, mamba2_decode)
from repro_torch.layers.mlp import MlpConfig, init_mlp, mlp
from repro_torch.layers.moe import MoeConfig, init_moe, moe
from repro_torch.layers.norms import init_rmsnorm, rmsnorm

__all__ = ["attn_cfg", "mlp_cfg", "moe_cfg", "mamba_cfg", "check_supported",
           "tree_map", "init_block", "block_apply", "block_decode",
           "init_block_cache", "init_lm", "forward_hidden", "lm_logits_head",
           "block_prefill", "lm_prefill", "init_lm_caches", "lm_decode_step",
           "chunked_ce_loss", "chunked_ce_terms", "lm_loss",
           "lm_loss_terms", "spec_at"]

UNIFORM = {"dense": "attn_mlp", "vlm": "attn_mlp", "moe": "attn_moe",
           "mamba2": "mamba"}
FAMILIES = tuple(UNIFORM) + ("gemma3", "zamba2")


def check_supported(cfg: ArchConfig, families=FAMILIES) -> None:
    """Raise ``ValueError`` for a family outside ``families``."""
    if cfg.family not in families:
        raise ValueError(f"unknown family {cfg.family!r}")


# ---------------------------------------------------------------------------
# sub-config builders
# ---------------------------------------------------------------------------

def attn_cfg(cfg: ArchConfig, backend: Optional[str] = None) -> AttnConfig:
    return AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        head_dim=cfg.head_dim, backend=backend or cfg.attn_backend,
        window=cfg.window, qkv_bias=cfg.qkv_bias, rope_theta=cfg.rope_theta,
        q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
        flash_vjp=cfg.flash_vjp, fused_qkv=cfg.fused_qkv,
        score_dtype=cfg.score_dtype, pad_heads_to=cfg.pad_heads_to,
        dtype=cfg.pdtype)


def mlp_cfg(cfg: ArchConfig) -> MlpConfig:
    return MlpConfig(cfg.d_model, cfg.d_ff, "silu", True, cfg.fused_mlp,
                     cfg.pdtype)


def moe_cfg(cfg: ArchConfig) -> MoeConfig:
    return MoeConfig(cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k,
                     cfg.capacity_factor, dtype=cfg.pdtype)


def mamba_cfg(cfg: ArchConfig) -> Mamba2Config:
    return Mamba2Config(cfg.d_model, cfg.ssm_state, cfg.ssm_conv,
                        cfg.ssm_expand, cfg.ssm_head_dim,
                        chunk=cfg.ssm_chunk, dtype=cfg.pdtype)


def _block_backend(cfg: ArchConfig, kind: str) -> Optional[str]:
    """gemma3's ``local`` layers slide; its ``global`` layers switch to
    the paper's linear attention under an arch backend of relu_linear
    (DESIGN §6), else softmax.  Other kinds take the arch's backend."""
    if kind == "local":
        return "sliding"
    if kind == "global":
        return ("relu_linear" if cfg.attn_backend == "relu_linear"
                else "softmax")
    return None


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _stack(trees):
    """A list of equal trees -> one tree of leaves stacked on a new axis
    0."""
    return tree_map(lambda *leaves: torch.stack(leaves), *trees)


def _at(tree, i: int):
    """Entry ``i`` of every leaf's leading (stacked) axis."""
    return tree_map(lambda a: a[i], tree)


def _unstack(tree) -> list:
    """The entries of every leaf's leading (stacked) axis, as a list of
    trees of views: one ``unbind`` a leaf, whose backward stacks the
    entries' gradients once (indexing each entry apart would give every
    entry a leaf-sized gradient of its own)."""
    parts = tree_map(lambda a: a.unbind(0), tree)
    n = len(tree_leaves(parts)[0])
    return [tree_map(lambda t: t[i], parts) for i in range(n)]


def _maybe_remat(fn, cfg: ArchConfig):
    """``fn`` under ``torch.utils.checkpoint`` (its activations dropped
    and recomputed in the backward) when ``cfg.remat`` is set and grad
    is enabled; as it is otherwise.  The recomputation runs under the
    ``ShardingCtx`` of the forward: autograd runs a CUDA backward on a
    thread of its own, where the thread-local context is not set."""
    if not cfg.remat:
        return fn

    def run(*args, **kw):
        if not torch.is_grad_enabled():
            return fn(*args, **kw)
        ctx = current_ctx()

        def under_ctx(*a, **k):
            with use_sharding(ctx):
                return fn(*a, **k)

        return torch.utils.checkpoint.checkpoint(under_ctx, *args,
                                                 use_reentrant=False, **kw)
    return run


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def init_block(generator: torch.Generator, cfg: ArchConfig, kind: str,
               device=None):
    if kind == "mamba":
        return {"ln1": init_rmsnorm(cfg.d_model, cfg.pdtype, device),
                "mixer": init_mamba2(generator, mamba_cfg(cfg), device)}
    if kind not in ("attn_mlp", "attn_moe", "local", "global"):
        raise ValueError(f"unknown block kind {kind!r}")
    acfg = attn_cfg(cfg, _block_backend(cfg, kind))
    p = {"ln1": init_rmsnorm(cfg.d_model, cfg.pdtype, device),
         "attn": init_attention(generator, acfg, device),
         "ln2": init_rmsnorm(cfg.d_model, cfg.pdtype, device)}
    if kind == "attn_moe":
        p["moe"] = init_moe(generator, moe_cfg(cfg), device)
    else:
        p["mlp"] = init_mlp(generator, mlp_cfg(cfg), device)
    return p


def _ffn(p, h, cfg: ArchConfig, kind: str, groups: int = 1):
    """The block's feed-forward half: -> (y, aux); the MoE's tokens in
    ``groups`` groups (decode: one per row)."""
    if kind == "attn_moe":
        return moe(p["moe"], h, moe_cfg(cfg), groups)
    return mlp(p["mlp"], h, mlp_cfg(cfg)), 0.0


def _block(p, x, cfg: ArchConfig, kind: str, positions, *, cache: bool,
           cache_dtype, reference: bool, spec=None):
    """x: (B, S, D) -> (x', the block's decode cache or None, aux);
    ``spec``: the cache's specs, for the rank's blocks of it."""
    if kind == "mamba":
        out = mamba2(p["mixer"], rmsnorm(p["ln1"], x, cfg.norm_eps),
                     mamba_cfg(cfg), return_cache=cache,
                     reference=reference, cache_spec=spec)
        y, c = out if cache else (out, None)
        return x + y, c, 0.0
    out = attention(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps),
                    attn_cfg(cfg, _block_backend(cfg, kind)), positions,
                    return_cache=cache, cache_dtype=cache_dtype,
                    reference=reference, cache_spec=spec)
    y, c = out if cache else (out, None)
    x = x + y
    y, aux = _ffn(p, rmsnorm(p["ln2"], x, cfg.norm_eps), cfg, kind)
    return x + y, c, aux


def block_apply(p, x, cfg: ArchConfig, kind: str, positions, *,
                reference: bool = False):
    """x: (B, S, D) -> (x', aux): the block without its cache; aux is
    the MoE's load-balancing loss (0.0 for other kinds)."""
    x, _, aux = _block(p, x, cfg, kind, positions, cache=False,
                       cache_dtype=None, reference=reference)
    return x, aux


def block_prefill(p, x, cfg: ArchConfig, kind: str, positions, *,
                  cache_dtype=torch.bfloat16, reference: bool = False,
                  spec=None):
    """x: (B, S, D) -> (x', the block's decode cache, KV in
    ``cache_dtype``; with ``spec``, the cache's specs under the installed
    ``ShardingCtx``, the rank's blocks of it)."""
    return _block(p, x, cfg, kind, positions, cache=True,
                  cache_dtype=cache_dtype, reference=reference,
                  spec=spec)[:2]


def block_decode(p, x, cache, pos, cfg: ArchConfig, kind: str, spec=None):
    """x: (B, 1, D) -> (x', cache); an MoE routes each row as a group of
    its own (see the module docstring).  ``spec``: the cache's specs
    when it is the rank's blocks (``attention_decode``,
    ``mamba2_decode``)."""
    if kind == "mamba":
        y, cache = mamba2_decode(p["mixer"],
                                 rmsnorm(p["ln1"], x, cfg.norm_eps),
                                 cache, mamba_cfg(cfg), spec)
        return x + y, cache
    y, cache = attention_decode(p["attn"],
                                rmsnorm(p["ln1"], x, cfg.norm_eps),
                                cache, pos,
                                attn_cfg(cfg, _block_backend(cfg, kind)),
                                spec)
    x = x + y
    y, _ = _ffn(p, rmsnorm(p["ln2"], x, cfg.norm_eps), cfg, kind,
                groups=x.shape[0])
    return x + y, cache


def init_block_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                     dtype=torch.bfloat16, device=None):
    if kind == "mamba":
        return init_mamba2_cache(mamba_cfg(cfg), batch, device=device)
    return init_kv_cache(attn_cfg(cfg, _block_backend(cfg, kind)), batch,
                         max_len, dtype, device)


# ---------------------------------------------------------------------------
# the layer stacks
# ---------------------------------------------------------------------------

def _stacked_init(generator, cfg: ArchConfig, kind: str, lead: tuple,
                  device, init=None):
    """Blocks of ``kind`` (``init(generator, cfg, device)``, default
    ``init_block`` of ``kind``) stacked on leading axes ``lead``, drawn in
    row-major order, each written into the stacked leaves as it is made
    (one block's params beside the stack, not a list of them); a stack
    of one block is that block's leaves, viewed with the leading axes
    (no copy: one Kimi-K2 layer's experts are 33.8 GB in bf16)."""
    if init is None:
        def init(g, c, d):
            return init_block(g, c, kind, d)
    if all(n == 1 for n in lead):
        return tree_map(lambda a: a.view(lead + tuple(a.shape)),
                        init(generator, cfg, device))
    out = None
    for idx in itertools.product(*map(range, lead)):
        blk = init(generator, cfg, device)
        if out is None:
            out = tree_map(lambda a: a.new_empty(lead + tuple(a.shape)),
                           blk)
        tree_map(lambda o, a: o[idx].copy_(a), out, blk)
        del blk                     # freed before the next block is drawn
    return out


def _zamba_split(cfg: ArchConfig) -> tuple[int, int]:
    """(groups, tail layers) of zamba2's Mamba stack."""
    return divmod(cfg.n_layers, cfg.shared_attn_every)


def _gemma_split(cfg: ArchConfig) -> tuple[int, int]:
    """(groups, local layers per group) of gemma3's stack."""
    if cfg.n_layers % cfg.global_every:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is no "
                         f"multiple of global_every {cfg.global_every}")
    return cfg.n_layers // cfg.global_every, cfg.global_every - 1


def init_lm(generator: torch.Generator, cfg: ArchConfig, device=None):
    """Random params drawn from ``generator`` (on its device), placed on
    ``device``."""
    check_supported(cfg)
    params = {
        "embed": init_embedding(generator, cfg.vocab, cfg.d_model,
                                cfg.pdtype, device),
        "final_norm": init_rmsnorm(cfg.d_model, cfg.pdtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(generator, cfg.d_model, cfg.vocab,
                                        dtype=cfg.pdtype, device=device)
    if cfg.family in UNIFORM:
        params["blocks"] = _stacked_init(generator, cfg, UNIFORM[cfg.family],
                                         (cfg.n_layers,), device)
    elif cfg.family == "gemma3":
        g, nl = _gemma_split(cfg)
        params["local"] = _stacked_init(generator, cfg, "local", (g, nl),
                                        device)
        params["global"] = _stacked_init(generator, cfg, "global", (g,),
                                         device)
    else:
        g, rem = _zamba_split(cfg)
        params["mamba_groups"] = _stacked_init(
            generator, cfg, "mamba", (g, cfg.shared_attn_every), device)
        if rem:
            params["mamba_tail"] = _stacked_init(generator, cfg, "mamba",
                                                 (rem,), device)
        params["shared_attn"] = init_block(generator, cfg, "attn_mlp",
                                           device)
    return params


def _layer_order(params, cfg: ArchConfig):
    """The blocks in the order they run: (kind, params, cache path), the
    path being the keys and indices of the block's cache in the stacked
    cache tree."""
    check_supported(cfg)
    if cfg.family in UNIFORM:
        kind = UNIFORM[cfg.family]
        return [(kind, p, ("blocks", i)) for i, p in
                enumerate(_unstack(params["blocks"]))]
    order = []
    if cfg.family == "gemma3":
        for gi, (grp, gp) in enumerate(zip(_unstack(params["local"]),
                                           _unstack(params["global"]))):
            order += [("local", p, ("local", gi, j))
                      for j, p in enumerate(_unstack(grp))]
            order.append(("global", gp, ("global", gi)))
        return order
    for gi, grp in enumerate(_unstack(params["mamba_groups"])):
        order += [("mamba", p, ("mamba_groups", gi, j))
                  for j, p in enumerate(_unstack(grp))]
        order.append(("attn_mlp", params["shared_attn"],
                      ("shared_attn", gi)))
    if "mamba_tail" in params:
        order += [("mamba", p, ("mamba_tail", j)) for j, p in
                  enumerate(_unstack(params["mamba_tail"]))]
    return order


def _stack_caches(cfg: ArchConfig, flat: dict):
    """{cache path: block cache} -> the stacked cache tree of
    ``init_lm_caches``."""
    if cfg.family in UNIFORM:
        return {"blocks": _stack([flat["blocks", i]
                                  for i in range(cfg.n_layers)])}
    if cfg.family == "gemma3":
        g, nl = _gemma_split(cfg)
        return {"local": _stack([_stack([flat["local", gi, j]
                                         for j in range(nl)])
                                 for gi in range(g)]),
                "global": _stack([flat["global", gi] for gi in range(g)])}
    g, rem = _zamba_split(cfg)
    out = {"mamba_groups": _stack([
        _stack([flat["mamba_groups", gi, j]
                for j in range(cfg.shared_attn_every)]) for gi in range(g)]),
        "shared_attn": _stack([flat["shared_attn", gi] for gi in range(g)])}
    if rem:
        out["mamba_tail"] = _stack([flat["mamba_tail", j]
                                    for j in range(rem)])
    return out


def _cache_at(caches, path):
    node = caches[path[0]]
    for i in path[1:]:
        node = _at(node, i)
    return node


def spec_at(specs, path):
    """The cache specs of the block at ``path`` (``_cache_at`` on a spec
    tree: each stacked index drops a spec's leading entry)."""
    node = specs[path[0]]
    for _ in path[1:]:
        node = tree_map(lambda s: type(s)(*s[1:]), node)
    return node


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------

def forward_hidden(params, x, cfg: ArchConfig, positions, *,
                   reference: bool = False):
    """Embedded input (B, S, D) -> (final hidden states (B, S, D),
    aux); each block under ``_maybe_remat``."""
    aux = 0.0
    block = _maybe_remat(block_apply, cfg)
    for kind, p, _ in _layer_order(params, cfg):
        x, a = block(p, x, cfg, kind, positions, reference=reference)
        aux = aux + a
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def _vocab_block(cfg: ArchConfig):
    """The rank's block of the vocab (``tp.Block``): the logits' under
    (``dp``, ``vocab``), the table's rows and ``lm_head``'s columns (one
    resolution of ``vocab`` on the same size)."""
    return param_block(("vocab",), (cfg.vocab,))


def lm_logits_head(params, h, cfg: ArchConfig):
    """h (..., D) -> the logits (..., V), the rank's ``_vocab_block`` of
    them where ``model`` splits the vocab."""
    if cfg.tie_embeddings:
        e = params["embed"]
        if "qt" in e:
            w = e["qt"].to(h.dtype) * e["scale"].to(h.dtype)
        else:
            w = e["table"].to(h.dtype)                      # (V, D)
        return torch.matmul(h, w.T)
    return linear(params["lm_head"], h)


def chunked_ce_loss(params, hidden, targets, cfg: ArchConfig, mask=None):
    """The mean cross-entropy of ``targets`` (B, S) under the logits of
    ``hidden`` (B, S, D), without the whole (B, S, V) logits at once: the
    vocab projection and logsumexp run over chunks of ``cfg.loss_chunk``
    tokens (one chunk where S is no multiple of it), in fp32.  ``mask``
    (B, S) weights each token; the mean is over its sum (at least 1).
    Under autograd each chunk's fp32 logits are kept for the backward,
    as JAX's scan keeps them."""
    tot, cnt = chunked_ce_terms(params, hidden, targets, cfg, mask)
    return tot / torch.clamp(cnt, min=1.0)


def chunked_ce_terms(params, hidden, targets, cfg: ArchConfig, mask=None):
    """``chunked_ce_loss``'s (weighted cross-entropy sum, weight sum):
    a sharded step divides the sum by the global weight sum."""
    B, S, _ = hidden.shape
    C = min(cfg.loss_chunk, S)
    if S % C != 0:
        C = S
    m = (torch.ones((B, S), dtype=torch.float32, device=hidden.device)
         if mask is None else mask.to(torch.float32))
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    vb = _vocab_block(cfg)
    for c0 in range(0, S, C):
        logits = lm_logits_head(params, hidden[:, c0:c0 + C], cfg).float()
        t = targets[:, c0:c0 + C].long()
        if vb.axes:
            lse, picked = _vocab_parallel_terms(logits, t, vb)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            picked = torch.gather(logits, -1, t[..., None])[..., 0]
        mc = m[:, c0:c0 + C]
        tot = tot + ((lse - picked) * mc).sum()
        cnt = cnt + mc.sum()
    return tot, cnt


def _vocab_parallel_terms(logits, targets, vb):
    """The logsumexp and the target's logit of vocab-split logits (the
    rank's block ``vb``), as GSPMD computes them under JAX's ``shard(
    logits, "dp", None, "vocab")``: the shift is the ``pmax`` of the
    blocks' maxima (held constant: the logsumexp does not depend on
    it), the exponentials' sums are ``psum``'d, and the rank holding a
    target contributes its logit to a ``psum``."""
    m = coll.pmax(logits.detach().amax(dim=-1), vb.axes)
    se = coll.psum(torch.exp(logits - m[..., None]).sum(dim=-1), vb.axes)
    local = targets - vb.start
    hit = (local >= 0) & (local < vb.stop - vb.start)
    pk = torch.gather(logits, -1, torch.where(
        hit, local, torch.zeros_like(local))[..., None])[..., 0]
    picked = coll.psum(torch.where(hit, pk, torch.zeros_like(pk)), vb.axes)
    return m + torch.log(se), picked


def lm_loss(params, batch, cfg: ArchConfig, *, reference: bool = False):
    """batch: {"tokens": (B, S), "targets": (B, S)[, "mask": (B, S)]}
    (vlm: also "patches" (B, P, D), the stub frontend's embeddings, and
    the targets are read off the hidden states from position P - 1) ->
    the scalar fp32 loss: ``chunked_ce_loss`` plus the MoE layers' aux
    loss.  ``reference=True`` runs the scans' plain versions."""
    tot, cnt, aux = lm_loss_terms(params, batch, cfg, reference=reference)
    return tot / torch.clamp(cnt, min=1.0) + aux


def lm_loss_terms(params, batch, cfg: ArchConfig, *,
                  reference: bool = False):
    """``lm_loss``'s terms: (cross-entropy sum, token weight sum, the
    MoE aux loss as fp32 or 0.0)."""
    x = embed(params["embed"], batch["tokens"], cfg.cdtype, cfg.vocab)
    if cfg.family == "vlm":
        x = torch.cat([batch["patches"].to(cfg.cdtype), x], dim=1)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    h, aux = forward_hidden(params, x, cfg, positions, reference=reference)
    if cfg.family == "vlm":
        P = batch["patches"].shape[1]
        h = h[:, P - 1: P - 1 + batch["targets"].shape[1]]
    tot, cnt = chunked_ce_terms(params, h, batch["targets"], cfg,
                                batch.get("mask"))
    return tot, cnt, (aux.float() if torch.is_tensor(aux) else aux)


def lm_prefill(params, tokens, cfg: ArchConfig, *, patches=None,
               cache_dtype=torch.bfloat16, reference: bool = False,
               specs=None):
    """(B, S) tokens -> (last-token logits (B, V), caches), the caches
    stacked as ``init_lm_caches`` lays them out (KV in ``cache_dtype``),
    so decode continues at position S.  vlm: ``patches`` (B, P, D), the
    stub frontend's embeddings, go before the text, and decode continues
    at P + S.  ``specs``: the caches' spec tree under the installed
    ``ShardingCtx`` (the sharded prefill step): each cache leaf is the
    rank's block of it, the logits the rank's vocab block."""
    x = embed(params["embed"], tokens, cfg.cdtype, cfg.vocab)
    if cfg.family == "vlm" and patches is not None:
        x = torch.cat([patches.to(cfg.cdtype), x], dim=1)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    flat = {}
    for kind, p, path in _layer_order(params, cfg):
        x, flat[path] = block_prefill(
            p, x, cfg, kind, positions, cache_dtype=cache_dtype,
            reference=reference,
            spec=None if specs is None else spec_at(specs, path))
    h = rmsnorm(params["final_norm"], x[:, -1:, :], cfg.norm_eps)
    return lm_logits_head(params, h, cfg)[:, 0, :], _stack_caches(cfg, flat)


def init_lm_caches(cfg: ArchConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None):
    """Zero caches for ``batch`` rows of ``max_len`` positions, KV in
    ``dtype`` (``device="meta"`` allocates nothing)."""
    check_supported(cfg)

    def stacked(kind, *lead):
        c = init_block_cache(cfg, kind, batch, max_len, dtype, device)
        return tree_map(lambda a: a.new_zeros(lead + tuple(a.shape)), c)

    if cfg.family in UNIFORM:
        return {"blocks": stacked(UNIFORM[cfg.family], cfg.n_layers)}
    if cfg.family == "gemma3":
        g, nl = _gemma_split(cfg)
        return {"local": stacked("local", g, nl),
                "global": stacked("global", g)}
    g, rem = _zamba_split(cfg)
    out = {"mamba_groups": stacked("mamba", g, cfg.shared_attn_every),
           "shared_attn": stacked("attn_mlp", g)}
    if rem:
        out["mamba_tail"] = stacked("mamba", rem)
    return out


def lm_decode_step(params, caches, tokens, pos, cfg: ArchConfig,
                   specs=None):
    """One decode step.  tokens: (B, 1); ``pos``: the 0-based position of
    each row's token, one int for every row or a (B,) tensor (each slot
    at its own position).  -> (logits (B, V), new caches); the input
    caches are not written.  ``specs``: the caches' spec tree when they
    are the rank's blocks under the installed ``ShardingCtx`` (the
    sharded serve step; the logits are then the rank's vocab block)."""
    x = embed(params["embed"], tokens, cfg.cdtype, cfg.vocab)
    flat = {}
    for kind, p, path in _layer_order(params, cfg):
        x, flat[path] = block_decode(
            p, x, _cache_at(caches, path), pos, cfg, kind,
            None if specs is None else spec_at(specs, path))
    h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits_head(params, h, cfg)[:, 0, :], _stack_caches(cfg, flat)
