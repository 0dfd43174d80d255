"""LM attention, counterpart of ``repro/layers/attention.py``: the GQA
projections and RoPE every backend shares, and the ``relu_linear``
backend, the paper's ReLU linear attention in causal LM form.

The causal prefill runs ``kernels/relu_attn/ops.py::relu_linear_attention``
in chunks of 256 tokens: on a CUDA tensor that is the hand-written
``relu_attn_causal`` kernel, on a CPU tensor its plain version
(``reference=True`` takes the plain version on any device).  JAX runs a
``lax.scan`` here; the kernel computes the same function.  Decode keeps
the O(1) recurrent state, a (kv_heads, d, d) state and a (kv_heads, d)
normalizer per row, in plain torch.

The ``softmax`` and ``sliding`` backends and ``cross_attention`` are not
ported yet (ROADMAP A8b): they raise ``NotImplementedError``.

Layout: prefill computes in flat-head (B, S, H, Dh) layout with K/V
repeated to full heads; the decode state keeps the compact GQA layout.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.relu_attn.ops import relu_linear_attention
from repro_torch.layers.linear import init_linear, linear
from repro_torch.layers.rope import apply_rope

__all__ = ["AttnConfig", "init_attention", "attention", "attention_decode",
           "init_kv_cache", "relu_linear_state", "cross_attention",
           "softmax_attention", "sliding_attention", "RELU_CHUNK", "EPS"]

RELU_CHUNK = 256     # chunk of the causal scan (JAX's default chunk)
EPS = 1e-6           # floor of the normalizer


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP A8b: softmax "
        f"and sliding attention with flash.py)")


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    backend: str = "softmax"        # softmax | sliding | relu_linear
    qkv_bias: bool = False           # qwen2.5
    rope_theta: float = 10000.0
    causal: bool = True
    fused_qkv: bool = False          # one QKV matmul
    dtype: torch.dtype = torch.float32   # param dtype

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv * self.head_dim


def init_attention(generator: torch.Generator, cfg: AttnConfig,
                   device=None):
    kw = dict(dtype=cfg.dtype, device=device)
    if cfg.fused_qkv:
        return {
            "wqkv": init_linear(generator, cfg.d_model,
                                cfg.q_dim + 2 * cfg.kv_dim,
                                bias=cfg.qkv_bias, **kw),
            "wo": init_linear(generator, cfg.q_dim, cfg.d_model, **kw),
        }
    return {
        "wq": init_linear(generator, cfg.d_model, cfg.q_dim,
                          bias=cfg.qkv_bias, **kw),
        "wk": init_linear(generator, cfg.d_model, cfg.kv_dim,
                          bias=cfg.qkv_bias, **kw),
        "wv": init_linear(generator, cfg.d_model, cfg.kv_dim,
                          bias=cfg.qkv_bias, **kw),
        "wo": init_linear(generator, cfg.q_dim, cfg.d_model, **kw),
    }


def _raw_qkv(params, x, cfg: AttnConfig):
    """x (B, S, D) -> q (B, S, H, Dh), k, v (B, S, KV, Dh), pre-RoPE."""
    B, S, _ = x.shape
    if "wqkv" in params:
        qkv = linear(params["wqkv"], x)
        q = qkv[..., : cfg.q_dim]
        k = qkv[..., cfg.q_dim: cfg.q_dim + cfg.kv_dim]
        v = qkv[..., cfg.q_dim + cfg.kv_dim:]
    else:
        q = linear(params["wq"], x)
        k = linear(params["wk"], x)
        v = linear(params["wv"], x)
    return (q.reshape(B, S, cfg.n_heads, cfg.head_dim),
            k.reshape(B, S, cfg.n_kv, cfg.head_dim),
            v.reshape(B, S, cfg.n_kv, cfg.head_dim))


def _repeat_kv(k, groups: int):
    """(B, S, KV, Dh) -> (B, S, KV*G, Dh) flat-head layout."""
    if groups == 1:
        return k
    return torch.repeat_interleave(k, groups, dim=2)


def _project_qkv(params, x, cfg: AttnConfig, positions):
    """x: (B, S, D) -> q (B, S, H, Dh); k, v (B, S, KV, Dh); q and k
    rotated at ``positions`` ((S,) or (B, S))."""
    q, k, v = _raw_qkv(params, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def relu_linear_state(k, v):
    """The decode state at the end of a prefill, from the UNREPEATED k, v
    (B, S, KV, Dh): state (B, KV, Dh, Dh) = sum_s ReLU(k_s) v_s^T and
    zsum (B, KV, Dh) = sum_s ReLU(k_s), fp32."""
    pk = torch.relu(k.float())
    state = torch.einsum("bskd,bske->bkde", pk, v.float())
    return state, pk.sum(dim=1)


def softmax_attention(*args, **kwargs):
    raise _unported("softmax attention")


def sliding_attention(*args, **kwargs):
    raise _unported("sliding-window attention")


def cross_attention(*args, **kwargs):
    raise _unported("cross attention")


def attention(params, x, cfg: AttnConfig, positions=None, *,
              return_cache: bool = False, reference: bool = False):
    """Prefill forward.  x: (B, S, D) -> (B, S, D), and with
    ``return_cache=True`` the decode cache as of the end of the sequence
    (the relu_linear state).  ``reference=True`` runs the scan's plain
    version."""
    B, S, _ = x.shape
    if cfg.backend in ("softmax", "sliding"):
        raise _unported(f"the {cfg.backend!r} attention backend")
    if cfg.backend != "relu_linear":
        raise ValueError(f"unknown attention backend {cfg.backend!r}")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(params, x, cfg, positions)
    g = cfg.n_heads // cfg.n_kv
    cache = None
    if cfg.causal and return_cache:
        cache = dict(zip(("state", "zsum"), relu_linear_state(k, v)))
    out = relu_linear_attention(q, _repeat_kv(k, g), _repeat_kv(v, g),
                                causal=cfg.causal, block_n=RELU_CHUNK,
                                reference=reference)
    out = out.reshape(B, S, cfg.q_dim).to(x.dtype)
    y = linear(params["wo"], out)
    return (y, cache) if return_cache else y


def init_kv_cache(cfg: AttnConfig, batch: int, device=None):
    """relu_linear: the zero state and normalizer, fp32."""
    if cfg.backend != "relu_linear":
        raise _unported(f"the {cfg.backend!r} decode cache")
    return {
        "state": torch.zeros((batch, cfg.n_kv, cfg.head_dim, cfg.head_dim),
                             dtype=torch.float32, device=device),
        "zsum": torch.zeros((batch, cfg.n_kv, cfg.head_dim),
                            dtype=torch.float32, device=device),
    }


def decode_positions(pos, batch: int, device) -> torch.Tensor:
    """A decode step's position(s) as a (batch, 1) int tensor: ``pos`` is
    one position for every row (an int or a 0-dim tensor) or one per row
    ((batch,))."""
    p = torch.as_tensor(pos, device=device)
    return p.reshape(-1, 1).expand(batch, 1)


def attention_decode(params, x, cache, pos, cfg: AttnConfig):
    """One-token decode.  x: (B, 1, D); ``pos``: each row's position (see
    ``decode_positions``).  relu_linear: the O(1) recurrent update."""
    if cfg.backend != "relu_linear":
        raise _unported(f"{cfg.backend!r} decode")
    B = x.shape[0]
    g = cfg.n_heads // cfg.n_kv
    positions = decode_positions(pos, B, x.device)
    q, k, v = _raw_qkv(params, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    pq = torch.relu(q.float()).reshape(B, cfg.n_kv, g, cfg.head_dim)
    pk = torch.relu(k.float()).reshape(B, cfg.n_kv, cfg.head_dim)
    vf = v.float().reshape(B, cfg.n_kv, cfg.head_dim)
    state = cache["state"] + torch.einsum("bkd,bke->bkde", pk, vf)
    zsum = cache["zsum"] + pk
    num = torch.einsum("bkgd,bkde->bkge", pq, state)
    den = torch.einsum("bkgd,bkd->bkg", pq, zsum)[..., None]
    out = (num / torch.clamp(den, min=EPS)).reshape(B, 1, cfg.q_dim)
    return (linear(params["wo"], out.to(x.dtype)),
            {"state": state, "zsum": zsum})
