"""LM attention, counterpart of ``repro/layers/attention.py``: the GQA
projections and RoPE every backend shares, and three backends.

``softmax``      GQA full attention: the chunked online softmax over kv
                 chunks, looped over q blocks in Python (JAX's
                 ``lax.scan`` / ``lax.map``), so no S x S score matrix is
                 held at once.
``sliding``      causal sliding-window attention (gemma3's local
                 layers): each block of ``window`` queries against its
                 own block and the previous one, or the masked chunked
                 softmax where S is no multiple of the window.
``relu_linear``  the paper's ReLU linear attention in causal LM form.
                 The causal prefill runs
                 ``kernels/relu_attn/ops.py::relu_linear_attention`` in
                 chunks of 256 tokens: on a CUDA tensor that is the
                 hand-written ``relu_attn_causal`` kernel, on a CPU tensor
                 its plain version (``reference=True`` takes the plain
                 version on any device).  JAX runs a ``lax.scan`` here;
                 the kernel computes the same function.

The softmax and sliding backends are plain torch ops, as JAX leaves them
to XLA; with ``flash_vjp=True`` both run ``layers/flash.py``'s
``flash_attention``, whose backward recomputes the probabilities chunk
by chunk (training), as JAX's do.  The relu_linear scan's backward
recomputes through the kernel's plain version
(``kernels/relu_attn/ops.py``).  Decode: softmax and sliding keep a
KV cache (sliding a ring of ``window`` slots), each row writing its own
slot and masking its own keys at its own position; relu_linear keeps
the O(1) recurrent state, a (kv_heads, d, d) state and a (kv_heads, d)
normalizer per row.

Sharded decode (``spec=``: the cache's ``CACHE_RULES`` specs under the
installed ``ShardingCtx``; the batch is the rank's rows): a K/V cache
whose sequence dim is split (``sp_kv``) is the rank's block of
positions, and the softmax is combined over the blocks (``pmax`` of the
row max, ``psum`` of the exponentials' sum and of the weighted values);
only the rank whose block holds a row's slot writes that row's K/V (the
sliding ring's slots likewise).  A cache whose head dim is split holds
the rank's KV heads: the rank attends with their query groups and the
heads are all-gathered for the output projection.  relu_linear states
split over heads the same way.  No whole cache is ever gathered.

Tensor parallelism (``distributed/tp.py``): under a context whose
``model`` axis splits them, ``wq`` / ``wk`` / ``wv`` / ``wqkv`` are the
rank's columns and ``wo`` its rows.  The backends run on the rank's
flat heads under JAX's ``heads`` annotation (``_head_block``: zero
heads padded up to ``pad_heads_to``, every head where ``model``
divides neither count); q, k and v are taken from the rank's columns
where they hold the rank's heads and gathered where not (GQA kv heads
off the split, 1.5 heads a rank, the fused ``wqkv``), and the output
reaches ``wo``'s rows the same way (``_wo``, a row-parallel product).

Layout: prefill computes in flat-head (B, S, H, Dh) layout with K/V
repeated to full heads; the caches keep the compact GQA layout.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.tp import (
    Block, held_block, model_axes, param_block, spec_block, take, to_spec,
    whole)
from repro_torch.kernels.relu_attn.ops import relu_linear_attention
from repro_torch.layers.flash import flash_attention
from repro_torch.layers.linear import init_linear, linear, row_linear
from repro_torch.layers.rope import apply_rope

__all__ = ["AttnConfig", "init_attention", "attention", "attention_decode",
           "init_kv_cache", "relu_linear_state", "cross_attention",
           "cross_kv",
           "softmax_attention", "sliding_attention", "to_cache_dtype",
           "block_softmax", "RELU_CHUNK", "EPS", "NEG_INF"]

RELU_CHUNK = 256     # chunk of the causal scan (JAX's default chunk)
EPS = 1e-6           # floor of the normalizer
NEG_INF = -1e30      # a masked score
F8_LIMIT = 464.0     # float8_e4m3fn: larger magnitudes round past 448


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    backend: str = "softmax"        # softmax | sliding | relu_linear
    window: int = 1024               # sliding backend only
    qkv_bias: bool = False           # qwen2.5
    rope_theta: float = 10000.0
    causal: bool = True
    q_chunk: int = 1024
    kv_chunk: int = 1024
    flash_vjp: bool = False          # softmax / sliding: layers/flash.py
    fused_qkv: bool = False          # one QKV matmul
    score_dtype: str = "float32"     # bfloat16: p and v rounded to bf16
    # JAX pads zero heads up to this count for a TPU model axis; they
    # change no output, and on one card the port computes none
    pad_heads_to: int = 0
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


def _qkv_blocks(params, x, cfg: AttnConfig, names=("q", "k", "v")):
    """x (B, S, D) -> {name: (the product's columns the rank holds,
    (B, S, cols), their ``tp.Block`` of q_dim or kv_dim)}.  A fused
    ``wqkv`` block is a contiguous block of ``[q | k | v]``, not a block
    of each: its product is gathered whole first."""
    D, qd, kd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    if "wqkv" in params:
        n = qd + 2 * kd
        y = take(linear(params["wqkv"], x), -1,
                 param_block(("fsdp", "tp"), (D, n)), whole(n))
        out = {"q": (y[..., :qd], whole(qd)),
               "k": (y[..., qd:qd + kd], whole(kd)),
               "v": (y[..., qd + kd:], whole(kd))}
        return {k: out[k] for k in names}
    return {k: (linear(params["w" + k], x),
                param_block(("fsdp", "tp"), (D, qd if k == "q" else kd)))
            for k in names}


def _heads_of(proj, heads: Block, head_dim: int):
    """The heads ``heads`` (a ``tp.Block`` of heads) of a
    ``_qkv_blocks`` entry -> (B, S, their count, Dh)."""
    t, blk = proj
    n = heads.stop - heads.start
    t = take(t, -1, blk, Block(heads.size * head_dim,
                               heads.start * head_dim,
                               heads.stop * head_dim, heads.axes))
    return t.reshape(t.shape[:2] + (n, head_dim))


def _repeat_kv(k, groups: int):
    """(B, S, KV, Dh) -> (B, S, KV*G, Dh) flat-head layout."""
    if groups == 1:
        return k
    return torch.repeat_interleave(k, groups, dim=2)


def _head_block(cfg: AttnConfig) -> Block:
    """The rank's range of the flat heads, zero-padded to
    ``pad_heads_to`` where ``model`` splits, under JAX's ``heads``
    annotation (divisibility-aware: every head where ``model`` divides
    neither count); every head on one device."""
    H = cfg.n_heads
    Hp = max(H, cfg.pad_heads_to) if model_axes() else H
    return param_block(("heads",), (Hp,))


def _real(hb: Block, cfg: AttnConfig) -> tuple:
    """The real (unpadded) heads [h0, hr) of the rank's range ``hb``."""
    return hb.start, max(hb.start, min(hb.stop, cfg.n_heads))


def _q_heads(hb: Block, cfg: AttnConfig) -> Block:
    """The real q heads of ``hb`` as a Block of the ``n_heads`` (an even
    split where nothing is padded)."""
    if hb.size == cfg.n_heads:
        return hb
    return Block(cfg.n_heads, *_real(hb, cfg))


def _kv_heads(hb: Block, cfg: AttnConfig) -> Block:
    """The kv heads that the real heads of ``hb`` use, as a Block of the
    ``n_kv``: an even split over ``hb``'s axes where the unpadded heads
    split and their split divides ``n_kv``."""
    g = cfg.n_heads // cfg.n_kv
    h0, hr = _real(hb, cfg)
    kv0, kv1 = (h0 // g, (hr - 1) // g + 1) if hr > h0 else (0, 0)
    n = (hb.size // (hb.stop - hb.start)) if hb.axes else 1
    aligned = hb.axes and hb.size == cfg.n_heads and cfg.n_kv % n == 0
    return Block(cfg.n_kv, kv0, kv1, hb.axes if aligned else ())


def _rank_heads(q, k, v, hb: Block, cfg: AttnConfig):
    """The rank's flat heads ``hb`` (padded): q (B, S, the real heads of
    hb, Dh), k, v the kv heads they use (``_kv_heads``) -> q, kh, vh (B,
    S, hb's heads, Dh), each q head beside its kv head (``h // g``, as
    ``_repeat_kv``), the padding heads zeros (JAX's: they change no
    output and are dropped before ``wo``)."""
    g = cfg.n_heads // cfg.n_kv
    h0, hr = _real(hb, cfg)
    if (h0, hr) == (0, cfg.n_heads):
        kh, vh = _repeat_kv(k, g), _repeat_kv(v, g)
    else:
        idx = torch.arange(h0, hr, device=k.device) // g - h0 // g
        kh, vh = k.index_select(2, idx), v.index_select(2, idx)
    npad = (hb.stop - hb.start) - (hr - h0)
    if npad:
        def pad(t):
            return torch.cat([t, t.new_zeros(t.shape[:2] + (
                npad, t.shape[3]))], 2)
        q, kh, vh = pad(q), pad(kh), pad(vh)
    return q, kh, vh


def _wo(params, out, hb: Block, cfg: AttnConfig, dtype):
    """The attention output on the rank's heads ``hb`` (B, S, heads, Dh)
    -> ``wo``: the padding dropped and the rows of ``wo``'s block taken
    (a gather of the heads where they are not that block), then the
    row-parallel product."""
    B, S = out.shape[:2]
    Dh = cfg.head_dim
    rows = param_block(("tp", "fsdp"), (cfg.q_dim, cfg.d_model), dim=0)
    out = out.reshape(B, S, -1).to(dtype)
    out = take(out, -1, Block(hb.size * Dh, hb.start * Dh, hb.stop * Dh,
                              hb.axes), rows)
    return row_linear(params["wo"], out, rows, cfg.d_model)


def relu_linear_state(k, v):
    """The decode state at the end of a prefill, from the UNREPEATED k, v
    (B, S, KV, Dh): state (B, KV, Dh, Dh) = sum_s ReLU(k_s) v_s^T and
    zsum (B, KV, Dh) = sum_s ReLU(k_s), fp32."""
    pk = torch.relu(k.float())
    state = torch.einsum("bskd,bske->bkde", pk, v.float())
    return state, pk.sum(dim=1)


def to_cache_dtype(t, dtype: torch.dtype):
    """``t`` cast to a cache's dtype as JAX's ``astype`` casts it: for
    ``float8_e4m3fn`` a magnitude past the last value that rounds to 448
    (and inf) becomes NaN, where torch's cast saturates."""
    if dtype == torch.float8_e4m3fn:
        t = torch.where(t.abs() > F8_LIMIT, float("nan"), t)
    return t.to(dtype)


def _bits(t):
    """A 1-byte tensor as uint8 (the same bits), others as they are:
    index and select ops that torch lacks for float8 work on the bits."""
    return t.view(torch.uint8) if t.element_size() == 1 else t


# ---------------------------------------------------------------------------
# softmax backend: chunked online softmax
# ---------------------------------------------------------------------------

def _flash_chunk_scan(q, k, v, q_pos, kv_pos, *, causal: bool, window,
                      kv_chunk: int, score_dtype=torch.float32):
    """Online-softmax attention of one q block against every kv chunk, in
    order.  q: (B, Sq, H, Dh); k, v: (B, Skv, H, Dh); q_pos (Sq,), kv_pos
    (Skv,) absolute positions.  -> (B, Sq, H, Dh) fp32."""
    B, Sq, H, Dh = q.shape
    Skv = k.shape[1]
    assert Skv % kv_chunk == 0, (Skv, kv_chunk)
    qf = (q.float() * Dh ** -0.5).permute(0, 2, 1, 3)      # (B, H, Sq, Dh)
    m = q.new_full((B, H, Sq), NEG_INF, dtype=torch.float32)
    l = q.new_zeros((B, H, Sq), dtype=torch.float32)
    acc = q.new_zeros((B, H, Sq, Dh), dtype=torch.float32)
    for c0 in range(0, Skv, kv_chunk):
        k_i = k[:, c0:c0 + kv_chunk].float().permute(0, 2, 3, 1)
        v_i = v[:, c0:c0 + kv_chunk].permute(0, 2, 1, 3)
        p_i = kv_pos[c0:c0 + kv_chunk]
        s = torch.matmul(qf, k_i)                             # (B, H, Sq, C)
        mask = None
        if causal:
            mask = p_i[None, :] <= q_pos[:, None]
        if window is not None:
            w = p_i[None, :] > (q_pos[:, None] - window)
            mask = w if mask is None else mask & w
        if mask is not None:
            s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        del s
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        # JAX: einsum of p, v in score_dtype accumulated in fp32
        pv = torch.matmul(p.to(score_dtype).float(),
                          v_i.to(score_dtype).float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 2, 1, 3)


def softmax_attention(q, k, v, q_pos, kv_pos, *, causal=True, window=None,
                      q_chunk=1024, kv_chunk=1024, score_dtype="float32"):
    """Full (optionally windowed) attention, chunked over q and kv.
    q, k, v: flat-head (B, S, H, Dh) -> (B, Sq, H, Dh) fp32.  As JAX's:
    one kv chunk when ``Skv % kv_chunk != 0``.  Where ``Sq % q_chunk !=
    0`` JAX takes one q block; rows are independent, so this runs that
    block ``q_chunk`` rows at a time (the last one ragged), each row's
    arithmetic unchanged, and holds H x q_chunk x kv_chunk scores, not
    H x Sq x kv_chunk."""
    B, Sq, H, Dh = q.shape
    Skv = k.shape[1]
    if isinstance(score_dtype, str):
        score_dtype = getattr(torch, score_dtype)
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    if Skv % kv_chunk != 0:
        kv_chunk = Skv
    kw = dict(causal=causal, window=window, kv_chunk=kv_chunk,
              score_dtype=score_dtype)
    if q_chunk == Sq:
        return _flash_chunk_scan(q, k, v, q_pos, kv_pos, **kw)
    out = q.new_empty((B, Sq, H, Dh), dtype=torch.float32)
    for q0 in range(0, Sq, q_chunk):
        out[:, q0:q0 + q_chunk] = _flash_chunk_scan(
            q[:, q0:q0 + q_chunk], k, v, q_pos[q0:q0 + q_chunk], kv_pos,
            **kw)
    return out


# ---------------------------------------------------------------------------
# sliding backend: block-local attention
# ---------------------------------------------------------------------------

def sliding_attention(q, k, v, q_pos, kv_pos, *, window: int):
    """Causal sliding-window attention: each query attends the keys in
    [p - window + 1, p].  q, k, v: flat-head (B, S, H, Dh) -> fp32;
    q_pos = kv_pos, consecutive.  Where ``S % window == 0`` and ``S >
    window``, each block of ``window`` queries against its own block and
    the previous one (zeros before block 0, masked); otherwise JAX's
    masked chunked softmax, past ``window`` tokens ``_sliding_rows``."""
    B, S, H, Dh = q.shape
    block = window
    if S <= block:
        return softmax_attention(q, k, v, q_pos, kv_pos, causal=True,
                                 window=window)
    if S % block != 0:
        return _sliding_rows(q, k, v, q_pos, kv_pos, window)
    nb = S // block
    qb = (q.float() * Dh ** -0.5).reshape(B, nb, block, H, Dh)

    def with_prev(t):
        tb = t.float().reshape(B, nb, block, H, Dh)
        prev = torch.cat([torch.zeros_like(tb[:, :1]), tb[:, :-1]], dim=1)
        return torch.cat([prev, tb], dim=2)              # (B, nb, 2W, H, Dh)

    s = torch.einsum("bnqhd,bnchd->bnhqc", qb, with_prev(k))
    qi = torch.arange(block, device=q.device)
    ci = torch.arange(2 * block, device=q.device)
    diff = qi[:, None] - ci[None, :] + block        # query minus key position
    s.masked_fill_(~((diff >= 0) & (diff < window)), NEG_INF)
    s[:, 0, :, :, :block] = NEG_INF     # block 0's "previous block" is zeros
    p = torch.softmax(s, dim=-1)
    del s
    out = torch.einsum("bnhqc,bnchd->bnqhd", p, with_prev(v))
    return out.reshape(B, S, H, Dh)


def _sliding_rows(q, k, v, q_pos, kv_pos, window: int):
    """JAX's sliding fallback (the masked softmax over every key, in one
    kv chunk where S is off the 1024 chunk), ``window`` queries at a time
    against only the keys they can see, [q0 - window + 1, q1).  A key
    outside the window scores ``NEG_INF`` and adds an exact 0, so each
    row's softmax is JAX's; the scores held are H x window x 2 window,
    where JAX's one block holds H x S x S (64 GiB at gemma3's 16 heads
    and 32769 tokens)."""
    B, S, H, Dh = q.shape
    out = q.new_empty((B, S, H, Dh), dtype=torch.float32)
    for q0 in range(0, S, window):
        q1, k0 = min(q0 + window, S), max(0, q0 - window + 1)
        out[:, q0:q1] = _flash_chunk_scan(
            q[:, q0:q1], k[:, k0:q1], v[:, k0:q1], q_pos[q0:q1],
            kv_pos[k0:q1], causal=True, window=window, kv_chunk=q1 - k0)
    return out


# ---------------------------------------------------------------------------
# prefill, cross attention, caches, decode
# ---------------------------------------------------------------------------

def _ring(t, S: int, window: int, dtype):
    """The sliding cache after a prefill of S tokens: the last min(window,
    S) of t (B, S, KV, Dh), token S - w + i at slot (S - w + i) %
    window, of length min(window, S)."""
    if S < window:
        return to_cache_dtype(t, dtype)
    return to_cache_dtype(torch.roll(t[:, S - window:], S % window, dims=1),
                          dtype)


def attention(params, x, cfg: AttnConfig, positions=None, *,
              return_cache: bool = False, cache_dtype=torch.bfloat16,
              reference: bool = False, cache_spec=None):
    """Prefill forward.  x: (B, S, D) -> (B, S, D), and with
    ``return_cache=True`` the decode cache as of the end of the sequence:
    softmax the whole K/V, sliding the ring (``_ring``), both in
    ``cache_dtype``; relu_linear the fp32 state.  ``reference=True`` runs
    the relu_linear scan's plain version.  Under a context whose
    ``model`` axis splits them the backend runs on the rank's heads
    (``_head_block``), and ``cache_spec`` (the cache leaves'
    ``CACHE_RULES`` specs, the rows the rank's) gives the rank's block
    of each cache leaf."""
    B, S, _ = x.shape
    if cfg.backend not in ("softmax", "sliding", "relu_linear"):
        raise ValueError(f"unknown attention backend {cfg.backend!r}")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    Dh = cfg.head_dim
    hb = _head_block(cfg)
    kvb = _kv_heads(hb, cfg)
    proj = _qkv_blocks(params, x, cfg)
    q = apply_rope(_heads_of(proj["q"], _q_heads(hb, cfg), Dh), positions,
                   cfg.rope_theta)
    k = apply_rope(_heads_of(proj["k"], kvb, Dh), positions, cfg.rope_theta)
    v = _heads_of(proj["v"], kvb, Dh)
    cache = None
    if return_cache:
        leaf, dim = ("state", 1) if cfg.backend == "relu_linear" else ("k", 2)
        cb = spec_block(cache_spec and cache_spec[leaf], dim, cfg.n_kv)
        kc, vc = k, v
        if hb.axes or cb.axes:      # every rank takes its cache's heads
            kc = apply_rope(_heads_of(proj["k"], cb, Dh), positions,
                            cfg.rope_theta)
            vc = _heads_of(proj["v"], cb, Dh)
        if cfg.backend == "softmax":
            cache = {"k": to_cache_dtype(kc, cache_dtype),
                     "v": to_cache_dtype(vc, cache_dtype)}
        elif cfg.backend == "sliding":
            cache = {"k": _ring(kc, S, cfg.window, cache_dtype),
                     "v": _ring(vc, S, cfg.window, cache_dtype)}
        elif cfg.causal:
            cache = dict(zip(("state", "zsum"), relu_linear_state(kc, vc)))
        if cache is not None and cache_spec is not None:
            cache = {n: to_spec(t, cache_spec[n], {dim: cb})
                     for n, t in cache.items()}
        del kc, vc
    del proj
    q, kh, vh = _rank_heads(q, k, v, hb, cfg)
    del k, v
    if cfg.backend == "softmax":
        if cfg.flash_vjp:
            out = flash_attention(q, kh, vh, positions, positions,
                                  cfg.causal, None, cfg.q_chunk,
                                  cfg.kv_chunk)
        else:
            out = softmax_attention(q, kh, vh, positions, positions,
                                    causal=cfg.causal, window=None,
                                    q_chunk=cfg.q_chunk,
                                    kv_chunk=cfg.kv_chunk,
                                    score_dtype=cfg.score_dtype)
    elif cfg.backend == "sliding":
        if cfg.flash_vjp:
            out = flash_attention(q, kh, vh, positions, positions, True,
                                  cfg.window, cfg.q_chunk, cfg.kv_chunk)
        else:
            out = sliding_attention(q, kh, vh, positions, positions,
                                    window=cfg.window)
    else:
        out = relu_linear_attention(q, kh, vh, causal=cfg.causal,
                                    block_n=RELU_CHUNK, reference=reference)
    del q, kh, vh           # freed before the output projection
    y = _wo(params, out, hb, cfg, x.dtype)
    return (y, cache) if return_cache else y


def cross_attention(params, x, memory, cfg: AttnConfig):
    """Encoder-decoder cross attention: queries from x (B, S, D), keys
    and values from ``memory`` (B, Sm, D), non-causal softmax, no RoPE;
    on the rank's heads, as ``attention``'s."""
    S = x.shape[1]
    Sm = memory.shape[1]
    Dh = cfg.head_dim
    hb = _head_block(cfg)
    kvb = _kv_heads(hb, cfg)
    q = _heads_of(_qkv_blocks(params, x, cfg, ("q",))["q"],
                  _q_heads(hb, cfg), Dh)
    kv = _qkv_blocks(params, memory, cfg, ("k", "v"))
    q, kh, vh = _rank_heads(q, _heads_of(kv["k"], kvb, Dh),
                            _heads_of(kv["v"], kvb, Dh), hb, cfg)
    del kv
    out = softmax_attention(
        q, kh, vh, torch.arange(S, device=x.device),
        torch.arange(Sm, device=x.device), causal=False,
        q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    return _wo(params, out, hb, cfg, x.dtype)


def cross_kv(params, memory, cfg: AttnConfig, dtype, spec=None):
    """A decoder layer's cross K/V over ``memory`` (B, Sm, D) in
    ``dtype``: {"ck", "cv"} (B, Sm, KV, Dh), or the rank's blocks under
    ``spec`` (their ``CACHE_RULES`` specs)."""
    cb = spec_block(spec and spec["ck"], 2, cfg.n_kv)
    kv = _qkv_blocks(params, memory, cfg, ("k", "v"))
    out = {}
    for n, src in (("ck", "k"), ("cv", "v")):
        t = _heads_of(kv[src], cb, cfg.head_dim).to(dtype)
        out[n] = to_spec(t, spec[n], {2: cb}) if spec is not None else t
    return out


def init_kv_cache(cfg: AttnConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None):
    """Zero decode cache for ``batch`` rows: relu_linear the fp32 state
    and normalizer; softmax K/V of ``max_len`` slots, sliding of
    ``min(max_len, window)``, in ``dtype``."""
    if cfg.backend == "relu_linear":
        return {
            "state": torch.zeros((batch, cfg.n_kv, cfg.head_dim,
                                  cfg.head_dim), dtype=torch.float32,
                                 device=device),
            "zsum": torch.zeros((batch, cfg.n_kv, cfg.head_dim),
                                dtype=torch.float32, device=device),
        }
    length = (min(max_len, cfg.window) if cfg.backend == "sliding"
              else max_len)
    shape = (batch, length, cfg.n_kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_positions(pos, batch: int, device) -> torch.Tensor:
    """A decode step's position(s) as a (batch, 1) int tensor: ``pos`` is
    one position for every row (an int or a 0-dim tensor) or one per row
    ((batch,))."""
    p = torch.as_tensor(pos, device=device)
    return p.reshape(-1, 1).expand(batch, 1)


def _write_rows(cache, slot, new):
    """A copy of ``cache`` (B, L, KV, Dh) with row b's slot ``slot[b]``
    set to ``new[b]`` (B, KV, Dh), cast to the cache's dtype; the input
    is not written."""
    L = cache.shape[1]
    hit = torch.arange(L, device=cache.device)[None, :] == slot[:, None]
    new = _bits(to_cache_dtype(new, cache.dtype))[:, None]
    return torch.where(hit[:, :, None, None], new,
                       _bits(cache)).view(cache.dtype)


def block_softmax(s, cv, seq_axes):
    """Softmax over the keys of ``s`` (..., C) times ``cv`` (B, C, KV,
    Dh), fp32 -> (B, KV, G, Dh).  With ``seq_axes`` the keys are the
    rank's block of the sequence and the result is combined over the
    blocks: the row max by ``pmax``, the sum of the exponentials by
    ``psum``, each block's weights normalized by the global sum (as
    ``torch.softmax`` normalizes before the product) and the weighted
    values by ``psum``."""
    if not seq_axes:
        w = torch.softmax(s, dim=-1)
        return torch.einsum("bkgc,bckd->bkgd", w, cv.float())
    m = coll.pmax(s.amax(dim=-1), seq_axes)
    e = torch.exp(s - m[..., None])
    w = e / coll.psum(e.sum(dim=-1), seq_axes)[..., None]
    return coll.psum(torch.einsum("bkgc,bckd->bkgd", w, cv.float()),
                     seq_axes)


def attention_decode(params, x, cache, pos, cfg: AttnConfig, spec=None):
    """One-token decode.  x: (B, 1, D); ``pos``: each row's position (see
    ``decode_positions``).  softmax / sliding: each row writes its K/V at
    its own slot (``pos``; sliding ``pos % length``, a ring) of a copy of
    the cache and attends the keys valid at its position; relu_linear:
    the O(1) recurrent update.  ``spec``: the cache leaves' specs, the
    cache the rank's blocks (see the module docstring): the rank
    projects q, k and v for the cache's kv heads (every head where the
    cache splits the sequence), and their output reaches ``wo``'s
    rows."""
    B = x.shape[0]
    g = cfg.n_heads // cfg.n_kv
    Dh = cfg.head_dim
    positions = decode_positions(pos, B, x.device)
    relu = cfg.backend == "relu_linear"
    if not relu and cfg.backend not in ("softmax", "sliding"):
        raise ValueError(f"unknown attention backend {cfg.backend!r}")
    leaf, dim = ("state", 1) if relu else ("k", 2)
    kvb = spec_block(spec and spec[leaf], dim, cfg.n_kv)
    kv = kvb.stop - kvb.start
    proj = _qkv_blocks(params, x, cfg)
    heads = Block(cfg.n_heads, kvb.start * g, kvb.stop * g, kvb.axes)
    q = apply_rope(_heads_of(proj["q"], heads, Dh), positions,
                   cfg.rope_theta)
    k = apply_rope(_heads_of(proj["k"], kvb, Dh), positions, cfg.rope_theta)
    v = _heads_of(proj["v"], kvb, Dh)
    del proj
    if relu:
        pq = torch.relu(q.float()).reshape(B, kv, g, Dh)
        pk = torch.relu(k.float()).reshape(B, kv, Dh)
        vf = v.float().reshape(B, kv, Dh)
        state = cache["state"] + torch.einsum("bkd,bke->bkde", pk, vf)
        zsum = cache["zsum"] + pk
        num = torch.einsum("bkgd,bkde->bkge", pq, state)
        den = torch.einsum("bkgd,bkd->bkg", pq, zsum)[..., None]
        out = num / torch.clamp(den, min=EPS)
        return (_wo(params, out.reshape(B, 1, kv * g, Dh), heads, cfg,
                    x.dtype), {"state": state, "zsum": zsum})
    L = cache["k"].shape[1]
    sb = held_block(spec and spec["k"], 1, L)
    seq_axes, off, length = sb.axes, sb.start, sb.size
    qf = q.float().reshape(B, kv, g, Dh)
    k, v = k[:, 0], v[:, 0]
    p = positions[:, 0]
    slot = (p % length if cfg.backend == "sliding" else p) - off
    ck = _write_rows(cache["k"], slot, k)
    cv = _write_rows(cache["v"], slot, v)
    kv_idx = off + torch.arange(L, device=x.device)[None, :]
    pc = p[:, None]
    if cfg.backend == "sliding":
        # slot i of the ring holds the latest position congruent to it
        kv_pos = pc - torch.remainder(pc - kv_idx, length)
        valid = (kv_pos >= 0) & (kv_pos >= pc - cfg.window + 1)
    else:
        valid = kv_idx <= pc
    s = torch.einsum("bkgd,bckd->bkgc", qf * Dh ** -0.5, ck.float())
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    out = block_softmax(s, cv, seq_axes)
    return (_wo(params, out.reshape(B, 1, kv * g, Dh), heads, cfg, x.dtype),
            {"k": ck, "v": cv})
