"""Mixture-of-Experts FFN with top-k token-choice routing, counterpart of
``repro/layers/moe.py``.

``moe_dense`` is JAX's reference semantics: route (fp32 softmax, top-k,
gates renormalized), rank each assignment within its expert in token
order (slot), drop the assignments past the expert's capacity, scatter
the kept tokens into an (E, C, D) buffer, run every expert's FFN over
its C slots (``torch.bmm``, as JAX leaves the einsums to XLA), and
gather back gate-weighted.

``moe_shard_map`` is JAX's distributed path with explicit collectives
(``distributed/collectives.py``) on the rank's local tokens, in JAX's
three modes over the ``model`` axis (size ep): ``a2a`` (E % ep == 0 and
the sequence splits: each model rank routes its S/ep slice, the slots go
to the experts' ranks by an all-to-all and back), ``repl`` (E % ep == 0
otherwise: every rank routes every token and serves its E/ep experts,
the partial outputs summed over ``model``) and ``tp`` (ep % E == 0:
every expert on every rank, d_ff split over ``model``, summed).  It
takes each expert weight whole or as the rank's block under
``MOE_RULES`` (the sharded train step passes the blocks it holds, so no
rank holds every expert) and moves it to the mode's block: the ``fsdp``
dim all-gathered inside, as JAX's ``_gather_fsdp``, the gradient coming
back through the gather's backward at the block's size; capacity is the
local token count's, so tokens drop where JAX's drop; the aux statistics
are ``pmean``'d over the token axes.  ``moe`` is the dispatcher: under a
``ShardingCtx`` whose ``model`` axis is larger than 1,
``moe_shard_map``; under other meshes of more than one rank (and where
no mode applies) ``_moe_global``, JAX's ``moe_dense`` on the global
batch (what GSPMD computes), with each rank computing only its own
rows' experts; else ``moe_dense``.

``groups``: the port's serving engine decodes every slot in one batched
step, where JAX's ``vmap``s a batch-1 step over the slots.  With
``groups=G`` the B*S tokens form G consecutive groups, each routed,
slotted and dropped against its own capacity ``_capacity(cfg, T / G)``
-- exactly what ``jax.vmap`` of ``moe_dense`` over the groups computes
-- and the experts still run once over every group's slots.  The
decode step passes its batch size, so no row shares capacity with
another row.  ``groups=1`` is JAX's batched call.  Under a context (the
sharded serve step) the rank's groups route the same way: every rank
routes its rows, ``repl`` / ``tp`` serve its experts or its d_ff slice
(each group's slots at its own offset in the buffer), and where no mode
applies the rank runs ``moe_dense(groups=)`` on its rows with every
expert gathered whole (``_moe_rows``).

W8 expert weights (``{"q", "scale"}`` from ``quantize_lm_params``)
dequantize whole on every call (``_deq``), as JAX's do: at Kimi-K2's
width one (384, 7168, 2048) tensor's temporary is 11.3 GB in bf16.
"""
from __future__ import annotations

import dataclasses
import re

import torch

from repro_torch.common.tree import match_first
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.ctx import P, current_ctx, mesh_axes
from repro_torch.distributed.partition import (
    local_block, resolve_param_spec)
from repro_torch.layers.mlp import _act

__all__ = ["MoeConfig", "init_moe", "MOE_RULES", "EXPERT_LEAF", "moe_dense",
           "moe_shard_map", "moe"]


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    d_model: int
    d_ff: int                 # per-expert hidden size
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    activation: str = "silu"
    gated: bool = True
    router_aux_weight: float = 0.01
    dtype: torch.dtype = torch.float32


def _normal(generator, shape, std, dtype, device):
    """N(0, std^2) drawn in fp32 on the generator's device (scaled in
    place: an expert tensor's fp32 draw is 22.5 GB at Kimi-K2's width),
    then cast and placed."""
    w = torch.randn(shape, generator=generator, device=generator.device)
    return w.mul_(std).to(device=device, dtype=dtype)


def init_moe(generator: torch.Generator, cfg: MoeConfig, device=None):
    E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
    std_in, std_out = D ** -0.5, F ** -0.5
    p = {
        "router": {"w": _normal(generator, (D, E), std_in, torch.float32,
                                device)},
        "w_in": _normal(generator, (E, D, F), std_in, cfg.dtype, device),
        "w_out": _normal(generator, (E, F, D), std_out, cfg.dtype, device),
    }
    if cfg.gated:
        p["w_gate"] = _normal(generator, (E, D, F), std_in, cfg.dtype,
                              device)
    return p


MOE_RULES = [
    (r"router/w$", (None, None)),
    (r"w_(in|gate)$", ("ep", "fsdp", "tp")),
    (r"w_out$", ("ep", "tp", "fsdp")),
]


def _capacity(cfg: MoeConfig, n_tokens: int) -> int:
    c = int(-(-cfg.top_k * n_tokens * cfg.capacity_factor // cfg.n_experts))
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


# ---------------------------------------------------------------------------
# routing, slotting, dispatch, combine (each over G groups of T tokens)
# ---------------------------------------------------------------------------

def _route(xf, router_w, cfg: MoeConfig):
    """xf (G, T, D) -> gates (G, T, k), idx (G, T, k), probs (G, T, E),
    fp32.  Top-k by a stable descending sort: on ties the lower expert
    index first, as ``jax.lax.top_k``."""
    logits = torch.matmul(xf.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :cfg.top_k], idx[..., :cfg.top_k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return gates, idx, probs


def _slot_assign(idx, n_experts: int, capacity: int):
    """Slot ranking.  idx (G, T, k) -> slot_c (G, T, k), valid (G, T, k).

    slot = the assignment's rank within its (group, expert) in token-
    major, then k, order (JAX's stable ``argsort``); at or past
    ``capacity`` it is dropped (slot ``capacity``, the overflow)."""
    G, T, k = idx.shape
    key = (idx + n_experts * torch.arange(
        G, device=idx.device)[:, None, None]).reshape(-1)
    order = torch.argsort(key, stable=True)
    counts = torch.zeros(G * n_experts, dtype=key.dtype,
                         device=idx.device).scatter_add_(
        0, key, torch.ones_like(key))        # bincount sizes on the host
    starts = torch.cumsum(counts, 0) - counts
    ranks = torch.arange(key.numel(), device=idx.device) - starts[key[order]]
    slot = torch.empty_like(key).scatter_(0, order, ranks).reshape(G, T, k)
    valid = slot < capacity
    return torch.where(valid, slot, capacity), valid


def _buffer_slot(slot_c, capacity: int):
    """(G, T, k) slots -> columns of the (E, G*C + 1) dispatch buffer:
    group g's slots at g*C.., every overflow at G*C."""
    G = slot_c.shape[0]
    base = capacity * torch.arange(G, device=slot_c.device)[:, None, None]
    return torch.where(slot_c < capacity, slot_c + base, G * capacity)


def _dispatch(xf, idx, col, n_experts: int, capacity: int):
    """Scatter the tokens into an (E, G*C + 1, D) buffer: each kept
    assignment to a column of its own, every dropped one to the overflow
    column G*C, which is never read (no add: no result depends on the
    order of the writes, and the host never waits for a mask)."""
    G, T, D = xf.shape
    k = idx.shape[-1]
    buf = xf.new_zeros((n_experts, G * capacity + 1, D))
    return buf.index_put_((idx, col), xf[:, :, None, :].expand(G, T, k, D))


def _deq(w, cd):
    """Dequantize-on-use for W8 expert weights (``{"q", "scale"}``)."""
    if isinstance(w, dict):
        return w["q"].to(cd) * w["scale"].to(cd)
    return w.to(cd)


def _expert_ffn(h_in, w_in, w_gate, w_out, cfg: MoeConfig, cd):
    """(E, C, D) @ per-expert weights -> (E, C, D)."""
    act = _act(cfg.activation)
    h = torch.bmm(h_in.to(cd), _deq(w_in, cd))
    if w_gate is not None:
        g = torch.bmm(h_in.to(cd), _deq(w_gate, cd))
        h = act(g) * h
    else:
        h = act(h)
    return torch.bmm(h, _deq(w_out, cd))


def _combine(out_buf, idx, col, gates, valid, dtype):
    """Gather the expert outputs back per token, gate-weighted sum over
    k.  -> (G, T, D)."""
    gathered = out_buf[idx, col]                      # (G, T, k, D)
    w = (gates * valid).to(dtype)[..., None]
    return torch.sum(gathered * w, dim=-2)


def _aux_from_stats(me, frac, cfg: MoeConfig):
    return cfg.router_aux_weight * cfg.n_experts * torch.sum(me * frac, -1)


def _assign_frac(idx, n_experts: int):
    """idx (G, T, k) -> each group's share of assignments per expert,
    (G, E) fp32."""
    G, T, k = idx.shape
    counts = torch.zeros((G, n_experts), dtype=torch.float32,
                         device=idx.device)
    counts.scatter_add_(1, idx.reshape(G, -1),
                        torch.ones((G, T * k), device=idx.device))
    return counts / (T * k)


# ---------------------------------------------------------------------------
# the dense (single device) path
# ---------------------------------------------------------------------------

def moe_dense(params, x, cfg: MoeConfig, groups: int = 1):
    """x: (B, S, D) -> (y (B, S, D), aux).  ``groups`` (see the module
    docstring): aux is a 0-dim tensor for one group, else one per group
    (G,), as ``jax.vmap`` returns it."""
    B, S, D = x.shape
    T = B * S
    if T % groups:
        raise ValueError(f"{T} tokens do not split into {groups} groups")
    G, Tg = groups, T // groups
    C = _capacity(cfg, Tg)
    xf = x.reshape(G, Tg, D)
    gates, idx, probs = _route(xf, params["router"]["w"], cfg)
    aux = _aux_from_stats(torch.mean(probs, dim=1),
                          _assign_frac(idx, cfg.n_experts), cfg)
    slot_c, valid = _slot_assign(idx, cfg.n_experts, C)
    col = _buffer_slot(slot_c, C)
    buf = _dispatch(xf, idx, col, cfg.n_experts, C)
    out = _expert_ffn(buf[:, :G * C], params["w_in"], params.get("w_gate"),
                      params["w_out"], cfg, x.dtype)
    out_pad = torch.cat([out, out.new_zeros((cfg.n_experts, 1, D))], dim=1)
    y = _combine(out_pad, idx, col, gates, valid, out.dtype)
    return y.reshape(B, S, D), (aux[0] if G == 1 else aux)


# ---------------------------------------------------------------------------
# the sharded path: explicit collectives on the rank's tokens
# ---------------------------------------------------------------------------

# The expert weights that the sharded paths take as the rank's blocks
# (the sharded train step passes them ungathered); each is the block of
# its per-layer shape under ``MOE_RULES`` resolved on the context, as
# ``LM_RULES`` shards the model's stacked leaves.
EXPERT_LEAF = re.compile(r"moe/w_(in|gate|out)$")
_W8_SCALE_AXES = ("ep", None, "tp")      # LM_RULES' moe/w_*/scale


def _pmean(x, axes, mesh):
    for a in axes:
        x = coll.pmean(x, a, mesh)
    return x


def _relayout(w, have, want, mesh):
    """The rank's block under ``want`` from its block under ``have``: a
    dim that ``have`` splits otherwise than ``want`` is all-gathered
    (its gradient comes back summed over those ranks), then ``want``'s
    own cuts are taken."""
    sizes = mesh_axes(mesh)

    def split(spec, d):
        return tuple(a for a in spec.axes(d) if sizes[a] > 1)

    for d in range(w.dim()):
        if split(have, d) and split(have, d) != split(want, d):
            w = coll.all_gather(w, split(have, d), axis=d, mesh=mesh)
    for d in range(w.dim()):
        t = split(want, d)
        if t and t != split(have, d):
            size = w.shape[d] // coll.axis_size(t, mesh)
            w = w.narrow(d, coll.axis_index(t, mesh) * size, size)
    return w


def _expert_leaf(w, full, logical, want, ctx):
    if tuple(w.shape) == full:    # the whole weight (or a block that
        return local_block(w, want, ctx.mesh)      # splits nothing)
    have = resolve_param_spec(ctx, logical, full)
    return _relayout(w, have, want, ctx.mesh)


def _expert_weight(w, name, want, cfg: MoeConfig, ctx):
    """Expert weight ``name`` as the rank's block under ``want`` (its
    ``fsdp`` dim gathered, as JAX's ``_gather_fsdp``), from the whole
    weight or from the rank's block under ``MOE_RULES``.  A W8 dict's
    scale (E, 1, out) follows its codes' expert and out dims: JAX's
    ``tp`` mode keeps it whole while the codes' out dim splits, and its
    dequantize fails on the shapes."""
    E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
    full = (E, F, D) if name == "w_out" else (E, D, F)
    logical = match_first(MOE_RULES, name, default=())
    if isinstance(w, dict):
        return {"q": _expert_leaf(w["q"], full, logical, want, ctx),
                "scale": _expert_leaf(w["scale"], (E, 1, full[2]),
                                      _W8_SCALE_AXES,
                                      P(want[0], None, want[2]), ctx)}
    return _expert_leaf(w, full, logical, want, ctx)


def _expert_weights(params, want_in, want_out, cfg: MoeConfig, ctx):
    w_in = _expert_weight(params["w_in"], "w_in", want_in, cfg, ctx)
    w_gate = (_expert_weight(params["w_gate"], "w_gate", want_in, cfg, ctx)
              if cfg.gated else None)
    w_out = _expert_weight(params["w_out"], "w_out", want_out, cfg, ctx)
    return w_in, w_gate, w_out


def _moe_global(params, x, cfg: MoeConfig, ctx):
    """JAX's ``moe_dense`` on the global batch (what GSPMD computes on
    the data-parallel ranks' tokens as one array), each rank routing and
    computing only its own rows.  An assignment's slot in the global
    order is its slot among the rank's assignments plus the earlier
    ranks' counts for its expert (one all-gather of an (E,) vector); it
    drops where that reaches the global batch's capacity C; the experts
    run over the rank's kept assignments only, at most min(C, T) an
    expert.  The aux statistics are ``pmean``'d over the data axes
    (equal shards: the global means).  Every expert is on every rank."""
    mesh = ctx.mesh
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh_axes(mesh))
    B, S, D = x.shape
    E = cfg.n_experts
    xt = x.reshape(1, -1, D)
    T = xt.shape[1]
    C = _capacity(cfg, T * coll.axis_size(dp_axes, mesh))
    gates, idx, probs = _route(xt, params["router"]["w"], cfg)
    me = _pmean(torch.mean(probs, dim=1), dp_axes, mesh)
    frac = _pmean(_assign_frac(idx, E), dp_axes, mesh)
    aux = _aux_from_stats(me, frac, cfg)[0]
    flat = idx.reshape(-1)
    counts = torch.zeros(E, dtype=flat.dtype, device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    every = coll.all_gather(counts[None], dp_axes, axis=0, mesh=mesh)
    offset = every[:coll.axis_index(dp_axes, mesh)].sum(0)
    slot, _ = _slot_assign(idx, E, T)     # a token takes an expert once
    valid = offset[idx] + slot < C
    c_loc = min(C, T)
    col = _buffer_slot(torch.where(valid, slot, c_loc), c_loc)
    buf = _dispatch(xt, idx, col, E, c_loc)
    whole = P(None, None, None)
    out = _expert_ffn(buf[:, :c_loc],
                      *_expert_weights(params, whole, whole, cfg, ctx), cfg,
                      x.dtype)
    out_pad = torch.cat([out, out.new_zeros((E, 1, D))], dim=1)
    y = _combine(out_pad, idx, col, gates, valid, out.dtype)
    return y.reshape(B, S, D), aux


def moe_shard_map(params, x, cfg: MoeConfig, ctx, groups: int = 1):
    """Distributed MoE on the rank's tokens: x (B/dp, S, D), replicated
    over ``model`` -> (y (B/dp, S, D), aux).  Each expert weight is the
    whole weight or the rank's block under ``MOE_RULES``.  See the
    module docstring.  ``groups`` > 1 (the decode's rows) route, slot
    and drop each group of the rank's tokens against its own capacity,
    as ``moe_dense(groups=)``: ``repl`` or ``tp``, never ``a2a``; the
    aux is then each group's own, (G,)."""
    mesh = ctx.mesh
    sizes = mesh_axes(mesh)
    ep_axis = "model"
    ep = sizes[ep_axis]
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    B, S, D = x.shape
    E = cfg.n_experts
    cd = x.dtype

    seq_sharded = S % ep == 0 and S > 1 and groups == 1
    if E % ep == 0:
        mode = "a2a" if seq_sharded else "repl"
    elif ep % E == 0:
        mode = "tp"
    elif groups != 1:
        return _moe_rows(params, x, cfg, groups, ctx)
    else:
        return _moe_global(params, x, cfg, ctx)

    t_loc = B * (S // ep if mode == "a2a" else S)
    C = _capacity(cfg, t_loc // groups)
    E_loc = E // ep if E % ep == 0 else E
    if mode == "tp":   # every expert on every rank, d_ff on model
        w_in, w_gate, w_out = _expert_weights(
            params, P(None, None, ep_axis), P(None, ep_axis, None), cfg, ctx)
    else:              # E/ep experts a rank
        w_in, w_gate, w_out = _expert_weights(
            params, P(ep_axis, None, None), P(ep_axis, None, None), cfg, ctx)
    token_axes = dp_axes + ((ep_axis,) if mode == "a2a" else ())

    if mode == "a2a":    # this model rank's slice of the sequence
        s_loc = S // ep
        x = x.narrow(1, coll.axis_index(ep_axis, mesh) * s_loc, s_loc)
    G = groups
    xt = x.reshape(G, -1, D)
    gates, idx, probs = _route(xt, params["router"]["w"], cfg)
    if G == 1:
        me = _pmean(torch.mean(probs, dim=1), token_axes, mesh)
        frac = _pmean(_assign_frac(idx, E), token_axes, mesh)
        aux = _aux_from_stats(me, frac, cfg)[0]
    else:                # each group (a row) its own statistics
        aux = _aux_from_stats(torch.mean(probs, dim=1),
                              _assign_frac(idx, E), cfg)

    if mode == "repl":
        # every rank sees every token; it serves only its expert slice
        lo = coll.axis_index(ep_axis, mesh) * E_loc
        own = (idx >= lo) & (idx < lo + E_loc)
        idx_own = torch.where(own, idx - lo, E_loc)      # E_loc = drop bin
        slot_c, valid = _slot_assign(idx_own, E_loc + 1, C)
        valid = valid & own
        slot_c = torch.where(own, slot_c, C)
        e_idx = torch.where(own, idx_own, 0)
        col = _buffer_slot(slot_c, C)
        buf = _dispatch(xt, e_idx, col, E_loc, C)[:, :G * C]
        out = _expert_ffn(buf, w_in, w_gate, w_out, cfg, cd)
    else:
        e_idx = idx
        slot_c, valid = _slot_assign(idx, E, C)
        col = _buffer_slot(slot_c, C)
        buf = _dispatch(xt, idx, col, E, C)[:, :G * C]         # (E, GC, D)
        if mode == "a2a":
            # send expert block j to rank j -> (E_loc, ep*C, D), and back
            buf = coll.all_to_all(buf, ep_axis, 0, 1, mesh=mesh)
            out = _expert_ffn(buf, w_in, w_gate, w_out, cfg, cd)
            out = coll.all_to_all(out, ep_axis, 1, 0, mesh=mesh)
        else:
            out = _expert_ffn(buf, w_in, w_gate, w_out, cfg, cd)
    out_pad = torch.cat([out, out.new_zeros((out.shape[0], 1, D))], dim=1)
    y = _combine(out_pad, e_idx, col, gates, valid, out.dtype)
    y = y.reshape(x.shape)
    if mode == "a2a":
        y = coll.all_gather(y, ep_axis, axis=1, mesh=mesh)
    else:                                # partial experts / partial d_ff
        y = coll.psum(y, ep_axis, mesh)
    return y, aux


def _moe_rows(params, x, cfg: MoeConfig, groups: int, ctx):
    """``moe_dense(groups=)`` on the rank's tokens with every expert
    whole (gathered from the rank's blocks): each group routes against
    its own capacity, so no group needs another rank's tokens."""
    whole = P(None, None, None)
    w_in, w_gate, w_out = _expert_weights(params, whole, whole, cfg, ctx)
    p = {"router": params["router"], "w_in": w_in, "w_out": w_out}
    if w_gate is not None:
        p["w_gate"] = w_gate
    return moe_dense(p, x, cfg, groups)


def moe(params, x, cfg: MoeConfig, groups: int = 1):
    """Dispatcher (see the module docstring): ``moe_dense`` without a
    ``ShardingCtx``, the sharded paths under one; ``groups`` > 1 under a
    ctx routes as ``moe_dense(groups=)`` does (``moe_shard_map``'s
    ``repl`` / ``tp`` with per-group capacity, else ``_moe_rows``)."""
    ctx = current_ctx()
    if ctx is None:
        return moe_dense(params, x, cfg, groups)
    B, S, _ = x.shape
    if (B * S) % groups:
        raise ValueError(f"{B * S} tokens do not split into {groups} "
                         f"groups")
    sizes = mesh_axes(ctx.mesh)
    if sizes.get("model", 1) > 1:
        return moe_shard_map(params, x, cfg, ctx, groups)
    if groups != 1:
        return _moe_rows(params, x, cfg, groups, ctx)
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    if coll.axis_size(dp_axes, ctx.mesh) > 1:
        return _moe_global(params, x, cfg, ctx)
    return moe_dense(params, x, cfg)
