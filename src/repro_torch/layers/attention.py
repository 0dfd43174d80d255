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

Layout: prefill computes in flat-head (B, S, H, Dh) layout with K/V
repeated to full heads; the caches keep the compact GQA layout.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.kernels.relu_attn.ops import relu_linear_attention
from repro_torch.layers.flash import flash_attention
from repro_torch.layers.linear import init_linear, linear
from repro_torch.layers.rope import apply_rope

__all__ = ["AttnConfig", "init_attention", "attention", "attention_decode",
           "init_kv_cache", "relu_linear_state", "cross_attention",
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
              reference: bool = False):
    """Prefill forward.  x: (B, S, D) -> (B, S, D), and with
    ``return_cache=True`` the decode cache as of the end of the sequence:
    softmax the whole K/V, sliding the ring (``_ring``), both in
    ``cache_dtype``; relu_linear the fp32 state.  ``reference=True`` runs
    the relu_linear scan's plain version."""
    B, S, _ = x.shape
    if cfg.backend not in ("softmax", "sliding", "relu_linear"):
        raise ValueError(f"unknown attention backend {cfg.backend!r}")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(params, x, cfg, positions)
    g = cfg.n_heads // cfg.n_kv
    cache = None
    kh, vh = _repeat_kv(k, g), _repeat_kv(v, g)
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
        if return_cache:
            cache = {"k": to_cache_dtype(k, cache_dtype),
                     "v": to_cache_dtype(v, cache_dtype)}
    elif cfg.backend == "sliding":
        if cfg.flash_vjp:
            out = flash_attention(q, kh, vh, positions, positions, True,
                                  cfg.window, cfg.q_chunk, cfg.kv_chunk)
        else:
            out = sliding_attention(q, kh, vh, positions, positions,
                                    window=cfg.window)
        if return_cache:
            cache = {"k": _ring(k, S, cfg.window, cache_dtype),
                     "v": _ring(v, S, cfg.window, cache_dtype)}
    else:
        if cfg.causal and return_cache:
            cache = dict(zip(("state", "zsum"), relu_linear_state(k, v)))
        out = relu_linear_attention(q, kh, vh, causal=cfg.causal,
                                    block_n=RELU_CHUNK, reference=reference)
    del q, kh, vh           # freed before the output projection
    out = out.reshape(B, S, cfg.q_dim).to(x.dtype)
    y = linear(params["wo"], out)
    return (y, cache) if return_cache else y


def cross_attention(params, x, memory, cfg: AttnConfig):
    """Encoder-decoder cross attention: queries from x (B, S, D), keys
    and values from ``memory`` (B, Sm, D), non-causal softmax, no RoPE."""
    B, S, _ = x.shape
    Sm = memory.shape[1]
    g = cfg.n_heads // cfg.n_kv
    q, _, _ = _raw_qkv(params, x, cfg)
    _, k, v = _raw_qkv(params, memory, cfg)
    kh, vh = _repeat_kv(k, g), _repeat_kv(v, g)
    out = softmax_attention(
        q, kh, vh, torch.arange(S, device=x.device),
        torch.arange(Sm, device=x.device), causal=False,
        q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    out = out.reshape(B, S, cfg.q_dim).to(x.dtype)
    return linear(params["wo"], out)


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


def _block_of(spec, dim: int, n: int) -> tuple:
    """(axes, first index) of the rank's block of ``n`` entries on cache
    dim ``dim`` under ``spec`` (None: unsharded, ((), 0))."""
    axes = spec.axes(dim) if spec is not None else ()
    return axes, (coll.axis_index(axes) * n if axes else 0)


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
    cache the rank's blocks (see the module docstring)."""
    B = x.shape[0]
    g = cfg.n_heads // cfg.n_kv
    positions = decode_positions(pos, B, x.device)
    q, k, v = _raw_qkv(params, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cfg.backend == "relu_linear":
        kv = cache["state"].shape[1]
        head_axes, h0 = _block_of(spec and spec["state"], 1, kv)
        pq = torch.relu(q.float()).reshape(B, cfg.n_kv, g, cfg.head_dim)
        pk = torch.relu(k.float()).reshape(B, cfg.n_kv, cfg.head_dim)
        vf = v.float().reshape(B, cfg.n_kv, cfg.head_dim)
        if spec is not None:
            pq, pk, vf = (t.narrow(1, h0, kv) for t in (pq, pk, vf))
        state = cache["state"] + torch.einsum("bkd,bke->bkde", pk, vf)
        zsum = cache["zsum"] + pk
        num = torch.einsum("bkgd,bkde->bkge", pq, state)
        den = torch.einsum("bkgd,bkd->bkg", pq, zsum)[..., None]
        out = num / torch.clamp(den, min=EPS)
        if spec is not None:
            out = coll.all_gather(out, head_axes, axis=1)
        out = out.reshape(B, 1, cfg.q_dim)
        return (linear(params["wo"], out.to(x.dtype)),
                {"state": state, "zsum": zsum})
    if cfg.backend not in ("softmax", "sliding"):
        raise ValueError(f"unknown attention backend {cfg.backend!r}")
    L, kv = cache["k"].shape[1], cache["k"].shape[2]
    kspec = spec and spec["k"]
    seq_axes, off = _block_of(kspec, 1, L)
    length = L * (coll.axis_size(seq_axes) if seq_axes else 1)
    head_axes, h0 = _block_of(kspec, 2, kv)
    qf = q.float().reshape(B, cfg.n_kv, g, cfg.head_dim)
    k, v = k[:, 0], v[:, 0]
    if spec is not None:
        qf, k, v = qf.narrow(1, h0, kv), k.narrow(1, h0, kv), \
            v.narrow(1, h0, kv)
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
    s = torch.einsum("bkgd,bckd->bkgc", qf * cfg.head_dim ** -0.5,
                     ck.float())
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    out = block_softmax(s, cv, seq_axes)
    if spec is not None:
        out = coll.all_gather(out, head_axes, axis=1)
    out = out.reshape(B, 1, cfg.q_dim).to(x.dtype)
    return linear(params["wo"], out), {"k": ck, "v": cv}
