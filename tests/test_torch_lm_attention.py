"""The port's softmax, sliding-window and cross attention and their KV
caches (``repro_torch/layers/attention.py``) on the CPU, held against
the JAX package's ``repro/layers/attention.py``.

Weights are JAX's own init carried over by ``params_from_jax``; inputs
are numpy-seeded.  GQA throughout: 2 kv heads under 4 heads of 16.

Tolerance: max|port - JAX| <= 1e-5 * max(1, max|JAX|) for every fp32
output and cache leaf (both sides fp32; the port mirrors JAX's q / kv
chunking, and runs JAX's one-q-block fallback a q chunk of rows at a
time and the sliding fallback against the keys each row slice can see:
only the order inside each matmul and each row sum differs).
``score_dtype="bfloat16"`` rounds p and v to bf16 on both sides: a p
element on either side of a bf16 rounding boundary moves the output by
one bf16 step, so those cases are held to 2^-8 * max(1, max|JAX|).  A
bf16 or float8 cache leaf is compared after the cast, within one step
of its dtype (2^-7 for bf16, 2^-3 for float8_e4m3fn) of max|JAX|, and
decode outputs read from such a cache within 1e-4.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.convert import params_from_jax
from repro_torch.layers import attention as ta

ja = importlib.import_module("repro.layers.attention")
TOL = 1e-5
BF16_SCORE_TOL = 2.0 ** -8
CACHE_TOL = {"float32": TOL, "bfloat16": 2.0 ** -7,
             "float8_e4m3fn": 2.0 ** -3}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, ref, tol=TOL):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    nan = np.isnan(ref)
    assert np.array_equal(np.isnan(got), nan)
    err = np.abs(got - ref)[~nan].max() if got.size > nan.sum() else 0.0
    assert err <= tol * max(1.0, np.abs(ref[~nan]).max()), (
        err, np.abs(ref[~nan]).max())


def tree_close(got, ref, tol=TOL):
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        node = got
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape, jax.tree_util.keystr(path)
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), (
            jax.tree_util.keystr(path), node.dtype, leaf.dtype)
        close(node, leaf, tol)


def port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def rand(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def cfgs(**kw):
    base = dict(d_model=32, n_heads=4, n_kv=2, head_dim=16, window=16,
                q_chunk=16, kv_chunk=16)
    base.update(kw)
    return ja.AttnConfig(**base), ta.AttnConfig(**base)


def layer(seed=0, **kw):
    jc, tc = cfgs(**kw)
    p = ja.init_attention(jax.random.PRNGKey(seed), jc)
    return jc, tc, p, port(p)


def flat(S, seed=0):
    """q, k, v (2, S, 4, 16) flat heads, JAX and torch."""
    return [both(rand((2, S, 4, 16), seed + i)) for i in range(3)]


# ---------------------------------------------------------------------------
# the attention cores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("score_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,qc,kc", [(64, 16, 32), (40, 16, 16),
                                     (48, 32, 16), (7, 16, 16)])
def test_softmax_attention_matches_jax(S, qc, kc, causal, score_dtype):
    """S = 64: 4 q blocks x 2 kv chunks; S = 40: one q block and one kv
    chunk (both fallbacks); S = 48: one q block (48 % 32) over 3 kv
    chunks; S = 7: shorter than a chunk."""
    (qj, qt), (kj, kt), (vj, vt) = flat(S, seed=S)
    pos = np.arange(S)
    kw = dict(causal=causal, q_chunk=qc, kv_chunk=kc,
              score_dtype=score_dtype)
    ref = ja.softmax_attention(qj, kj, vj, jnp.asarray(pos),
                               jnp.asarray(pos), **kw)
    got = ta.softmax_attention(qt, kt, vt, torch.as_tensor(pos),
                               torch.as_tensor(pos), **kw)
    assert got.dtype == torch.float32
    close(got, ref, TOL if score_dtype == "float32" else BF16_SCORE_TOL)


def test_softmax_attention_windowed_and_bf16_inputs_match_jax():
    """The ``window`` mask of the chunked path (the sliding fallback's),
    and bf16 q / k / v, against JAX's."""
    (qj, qt), (kj, kt), (vj, vt) = flat(48, seed=5)
    pos = np.arange(48)
    pj, pt = jnp.asarray(pos), torch.as_tensor(pos)
    close(ta.softmax_attention(qt, kt, vt, pt, pt, window=10, q_chunk=16,
                               kv_chunk=16),
          ja.softmax_attention(qj, kj, vj, pj, pj, window=10, q_chunk=16,
                               kv_chunk=16))
    bj = [a.astype(jnp.bfloat16) for a in (qj, kj, vj)]
    bt = [a.to(torch.bfloat16) for a in (qt, kt, vt)]
    close(ta.softmax_attention(*bt, pt, pt, q_chunk=16, kv_chunk=16),
          ja.softmax_attention(*bj, pj, pj, q_chunk=16, kv_chunk=16))


@pytest.mark.parametrize("S,W", [(64, 16), (48, 16), (40, 16), (17, 16),
                                 (16, 16), (10, 16)])
def test_sliding_attention_matches_jax(S, W):
    """S = 64, 48: the block path (self + previous block); S = 40, 17:
    the masked fallback (S % W != 0) a window of rows at a time; S = W
    and S < W: the fallback in one block."""
    (qj, qt), (kj, kt), (vj, vt) = flat(S, seed=S + W)
    pos = np.arange(S)
    ref = ja.sliding_attention(qj, kj, vj, jnp.asarray(pos),
                               jnp.asarray(pos), window=W)
    got = ta.sliding_attention(qt, kt, vt, torch.as_tensor(pos),
                               torch.as_tensor(pos), window=W)
    close(got, ref)


def test_sliding_block_path_equals_the_masked_fallback():
    """Both sliding paths compute keys in [p - W + 1, p]: the block path
    at S = 64 equals the port's chunked softmax with ``window``."""
    (_, qt), (_, kt), (_, vt) = flat(64, seed=9)
    pos = torch.arange(64)
    close(ta.sliding_attention(qt, kt, vt, pos, pos, window=16),
          ta.softmax_attention(qt, kt, vt, pos, pos, window=16))


@pytest.mark.parametrize("S", [65, 79])
def test_sliding_fallback_rows_equal_the_block_path(S):
    """Causal: an off-window prompt's first 64 rows (the row-sliced
    fallback) equal the block path's at S = 64, and no row sees a key
    past its window (a key W back changed moves nothing)."""
    (_, qt), (_, kt), (_, vt) = flat(S, seed=S)
    pos = torch.arange(S)
    got = ta.sliding_attention(qt, kt, vt, pos, pos, window=16)
    close(got[:, :64], ta.sliding_attention(qt[:, :64], kt[:, :64],
                                            vt[:, :64], pos[:64], pos[:64],
                                            window=16))
    kt2, vt2 = kt.clone(), vt.clone()
    kt2[:, S - 17], vt2[:, S - 17] = 5.0, 5.0
    moved = ta.sliding_attention(qt, kt2, vt2, pos, pos, window=16)
    assert torch.equal(moved[:, S - 1], got[:, S - 1])


@pytest.mark.parametrize("S,Sm,fused", [(12, 40, False), (32, 32, True)])
def test_cross_attention_matches_jax(S, Sm, fused):
    """Non-causal softmax over the memory, no RoPE, on the layer's
    params (separate and fused QKV)."""
    jc, tc, p, tp = layer(seed=3, fused_qkv=fused)
    xj, xt = both(rand((2, S, 32), 1))
    mj, mt = both(rand((2, Sm, 32), 2))
    close(ta.cross_attention(tp, xt, mt, tc),
          ja.cross_attention(p, xj, mj, jc))


# ---------------------------------------------------------------------------
# prefill with its cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend,S", [
    ("softmax", 64), ("softmax", 40), ("sliding", 64), ("sliding", 40),
    ("sliding", 16), ("sliding", 10), ("relu_linear", 40)])
def test_attention_and_cache_match_jax(backend, S, cache_dtype):
    """The layer's output and its decode cache after a prefill of S
    tokens: softmax the whole K/V, sliding the ring of the last min(W,
    S) tokens at slots (S - w + i) % W (S = 64, 40: a rolled ring; 16:
    the whole window; 10: shorter than it), relu_linear the state."""
    jc, tc, p, tp = layer(seed=S, backend=backend)
    xj, xt = both(rand((2, S, 32), S + 1))
    yj, cj = ja.attention(p, xj, jc, return_cache=True,
                          cache_dtype=jnp.dtype(cache_dtype))
    yt, ct = ta.attention(tp, xt, tc, return_cache=True,
                          cache_dtype=getattr(torch, cache_dtype))
    close(yt, yj)
    tree_close(ct, cj, CACHE_TOL[cache_dtype])
    if backend == "sliding":
        assert ct["k"].shape[1] == min(16, S)
    close(ta.attention(tp, xt, tc), yj)


def test_pad_heads_to_matches_jax_and_changes_nothing():
    """JAX pads zero heads up to 6 (v = 0) and slices them away: its
    output equals the port's, which pads none, with or without the
    field."""
    for backend in ("softmax", "sliding", "relu_linear"):
        jc, tc, p, tp = layer(seed=4, backend=backend, pad_heads_to=6)
        _, tc0 = cfgs(backend=backend)
        xj, xt = both(rand((2, 32, 32), 6))
        yt = ta.attention(tp, xt, tc)
        close(yt, ja.attention(p, xj, jc))
        close(yt, ta.attention(tp, xt, tc0), 1e-6)


@pytest.mark.parametrize("backend", ["softmax", "sliding", "relu_linear"])
@pytest.mark.parametrize("max_len", [8, 40])
def test_init_kv_cache_matches_jax(backend, max_len):
    """The zero caches: softmax max_len positions, sliding min(max_len,
    W), relu_linear the fp32 state, in the asked dtype."""
    jc, tc = cfgs(backend=backend)
    for dt in ("bfloat16", "float32"):
        tree_close(ta.init_kv_cache(tc, 3, max_len, getattr(torch, dt)),
                   ja.init_kv_cache(jc, 3, max_len, jnp.dtype(dt)))
    meta = ta.init_kv_cache(tc, 3, max_len, device="meta")
    assert all(t.device.type == "meta" for t in meta.values())


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _jax_padded(p, jc, x, L, cache_dtype):
    """JAX's prefill cache of one row, zero-padded to L positions as
    JAX's engine pads it."""
    _, c = ja.attention(p, x, jc, return_cache=True,
                        cache_dtype=jnp.dtype(cache_dtype))
    return {k: jnp.pad(v, ((0, 0), (0, L - v.shape[1]), (0, 0), (0, 0)))
            for k, v in c.items()}


@pytest.mark.parametrize("backend", ["softmax", "sliding"])
def test_decode_per_row_positions_across_a_ring_wrap_match_jax(backend):
    """Three rows prefilled with 5, 16 and 37 tokens (sliding: W = 16, so
    the rows hold a short ring, a full one and a rolled one), each padded
    to the cache length as the engine pads it, then 14 decode steps in
    one batch, each row at its own position: every step's output and
    every cache leaf against JAX's batch-1 decode of each row at its
    scalar position.  The sliding rows wrap their rings."""
    L = 16 if backend == "sliding" else 56
    lens = (5, 16, 37)
    jc, tc, p, tp = layer(seed=11, backend=backend)
    xs = [rand((1, n + 14, 32), n) for n in lens]
    jcs = [_jax_padded(p, jc, jnp.asarray(x[:, :n]), L, "float32")
           for x, n in zip(xs, lens)]
    tcache = {k: torch.cat([torch.from_numpy(np.array(c[k]))
                            for c in jcs]) for k in ("k", "v")}
    for t in range(14):
        pos = torch.tensor([n + t for n in lens])
        xt = torch.from_numpy(np.concatenate([x[:, n + t:n + t + 1]
                                              for x, n in zip(xs, lens)]))
        yt, tcache = ta.attention_decode(tp, xt, tcache, pos, tc)
        for b, (x, n) in enumerate(zip(xs, lens)):
            yj, jcs[b] = ja.attention_decode(
                p, jnp.asarray(x[:, n + t:n + t + 1]), jcs[b],
                jnp.int32(n + t), jc)
            close(yt[b:b + 1], yj)
            tree_close({k: v[b:b + 1] for k, v in tcache.items()}, jcs[b])


@pytest.mark.parametrize("S", [15, 16, 17, 32, 40])
def test_sliding_prefill_then_decode_equals_one_prefill(S):
    """The ring at every boundary (S < W, S = W, S = W + 1, S = k * W,
    ragged): prefill S tokens, pad the ring to W, decode 20 tokens across
    the wrap; every step equals the last row of a prefill of the whole
    prefix (the block path or the fallback, whichever it takes)."""
    jc, tc, p, tp = layer(seed=S, backend="sliding")
    x = torch.from_numpy(rand((2, S + 20, 32), S))
    _, cache = ta.attention(tp, x[:, :S], tc, return_cache=True,
                            cache_dtype=torch.float32)
    cache = {k: torch.cat([v, v.new_zeros((2, 16 - v.shape[1], 2, 16))],
                          dim=1) for k, v in cache.items()}
    full = ta.attention(tp, x, tc)
    for t in range(20):
        y, cache = ta.attention_decode(tp, x[:, S + t:S + t + 1], cache,
                                       S + t, tc)
        close(y, full[:, S + t:S + t + 1], 1e-4)


def test_decode_leaves_the_input_cache_unwritten():
    jc, tc, p, tp = layer(backend="sliding")
    cache = {k: torch.randn((2, 16, 2, 16)) for k in ("k", "v")}
    before = {k: v.clone() for k, v in cache.items()}
    _, new = ta.attention_decode(tp, torch.randn((2, 1, 32)), cache,
                                 torch.tensor([3, 20]), tc)
    assert all(torch.equal(cache[k], before[k]) for k in cache)
    assert not torch.equal(new["k"], cache["k"])


def test_float8_cache_rounds_as_jax_and_decodes_from_it():
    """A float8_e4m3fn cache: the prefill's K/V cast as JAX casts them
    (bits equal), values past 464 NaN as JAX's cast makes them (torch's
    own saturates at 448), and decode steps read from and write into
    the float8 ring as JAX's do."""
    v = np.array([463.9, 464.0, 464.01, -470.0, 1e-3, 447.0, np.inf],
                 np.float32)
    got = ta.to_cache_dtype(torch.from_numpy(v), torch.float8_e4m3fn)
    ref = np.asarray(jnp.asarray(v).astype(jnp.float8_e4m3fn))
    assert got.dtype == torch.float8_e4m3fn
    close(got, ref, 0.0)
    jc, tc, p, tp = layer(seed=2, backend="sliding")
    for scale in (30.0, 1.0):         # 30: some |k| past 464
        xj, xt = both(rand((1, 40, 32), 3, scale))
        _, cj = ja.attention(p, xj[:, :30], jc, return_cache=True,
                             cache_dtype=jnp.float8_e4m3fn)
        _, ct = ta.attention(tp, xt[:, :30], tc, return_cache=True,
                             cache_dtype=torch.float8_e4m3fn)
        for k in ("k", "v"):
            assert ct[k].dtype == torch.float8_e4m3fn
            bits = ct[k].view(torch.uint8).numpy()
            assert np.array_equal(bits, np.asarray(cj[k]).view(np.uint8)), k
    assert np.isnan(_np(ct["k"])).sum() == 0
    for t in range(30, 34):
        yj, cj = ja.attention_decode(p, xj[:, t:t + 1], cj, jnp.int32(t),
                                     jc)
        yt, ct = ta.attention_decode(tp, xt[:, t:t + 1], ct,
                                     torch.tensor([t]), tc)
        close(yt, yj, 1e-4)
        tree_close(ct, cj, CACHE_TOL["float8_e4m3fn"])
