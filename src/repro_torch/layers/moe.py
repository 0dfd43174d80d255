"""Mixture-of-Experts FFN with top-k token-choice routing, counterpart of
``repro/layers/moe.py`` on a single device.

``moe_dense`` is JAX's reference semantics: route (fp32 softmax, top-k,
gates renormalized), rank each assignment within its expert in token
order (slot), drop the assignments past the expert's capacity, scatter
the kept tokens into an (E, C, D) buffer, run every expert's FFN over
its C slots (``torch.bmm``, as JAX leaves the einsums to XLA), and
gather back gate-weighted.  ``moe`` is the dispatcher; JAX's takes
``moe_shard_map`` (the all-to-all / replicated / tensor-parallel modes
over a multi-device ``model`` mesh) only under such a mesh, which the
port does not have yet: ``moe_shard_map`` and the sharding rules'
use belong with ``distributed/`` (ROADMAP A8g), and ``moe`` always
calls ``moe_dense``.  ``MOE_RULES`` is kept as data.

``groups``: the port's serving engine decodes every slot in one batched
step, where JAX's ``vmap``s a batch-1 step over the slots.  With
``groups=G`` the B*S tokens form G consecutive groups, each routed,
slotted and dropped against its own capacity ``_capacity(cfg, T / G)``
-- exactly what ``jax.vmap`` of ``moe_dense`` over the groups computes
-- and the experts still run once over every group's slots.  The
decode step passes its batch size, so no row shares capacity with
another row.  ``groups=1`` is JAX's batched call.

W8 expert weights (``{"q", "scale"}`` from ``quantize_lm_params``)
dequantize whole on every call (``_deq``), as JAX's do: at Kimi-K2's
width one (384, 7168, 2048) tensor's temporary is 11.3 GB in bf16.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.layers.mlp import _act

__all__ = ["MoeConfig", "init_moe", "MOE_RULES", "moe_dense", "moe"]


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


def moe(params, x, cfg: MoeConfig, groups: int = 1):
    """Dispatcher: ``moe_dense`` (JAX's choice without a multi-device
    ``model`` mesh; the sharded path is ROADMAP A8g)."""
    return moe_dense(params, x, cfg, groups)
