"""The port's LM layers (``repro_torch.layers``: linear, norms, RoPE, MLP,
relu_linear attention, Mamba-2) on the CPU, held against the JAX
package's.

Weights are JAX's own init (``jax.random``) carried over by
``params_from_jax``; inputs are numpy-seeded.  On the CPU the two scans
run their kernels' plain versions (``relu_attn_causal_scan``,
``ssd_scan_ref``), which compute JAX's functions in the kernels' order.

Tolerance: max|port - JAX| <= 1e-5 * max(1, max|JAX|) for every output
and cache leaf (fp32 on both sides; sums in another order).  A ragged
sequence (S not a multiple of the chunk) is taken by JAX as one chunk and
padded to whole chunks by the port: the same math in another order,
held to the same tolerance.  bf16 cases compare bf16 outputs at one
bf16 step (2^-7 relative) of max|JAX|.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.convert import params_from_jax
from repro_torch.layers import attention as ta
from repro_torch.layers import linear as tl
from repro_torch.layers import mamba2 as tm
from repro_torch.layers import mlp as tmlp
from repro_torch.layers import norms as tn
from repro_torch.layers import rope as tr

# ``repro.layers`` re-exports functions named like its modules
ja, jl, jm, jmlp, jn, jr = (importlib.import_module(f"repro.layers.{m}")
                            for m in ("attention", "linear", "mamba2",
                                      "mlp", "norms", "rope"))
TOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, ref, tol=TOL):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max() if got.size else 0.0
    assert err <= tol * max(1.0, np.abs(ref).max()), (err, np.abs(ref).max())


def tree_close(got, ref, tol=TOL):
    """Every leaf of JAX's tree ``ref`` against the port's ``got``, with
    equal shapes and dtypes."""
    leaves = jax.tree_util.tree_flatten_with_path(ref)[0]
    for path, leaf in leaves:
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


# ---------------------------------------------------------------------------
# linear, embedding, norms, RoPE, MLP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bias", [False, True])
def test_linear_matches_jax(bias):
    p = jl.init_linear(jax.random.PRNGKey(1), 24, 40, bias=bias)
    if bias:
        p["b"] = jnp.asarray(rand((40,), 3))
    xj, xt = both(rand((2, 5, 24)))
    close(tl.linear(port(p), xt), jl.linear(p, xj))
    t = tl.init_linear(torch.Generator().manual_seed(0), 24, 40, bias=bias)
    assert {k: tuple(v.shape) for k, v in t.items()} == \
        {k: v.shape for k, v in p.items()}


def test_linear_weight_only_int8_matches_jax():
    rng = np.random.default_rng(4)
    p = {"qw": jnp.asarray(rng.integers(-127, 128, (24, 40), np.int8)),
         "scale": jnp.asarray(rng.uniform(1e-3, 1e-2, (40,)), jnp.float32)}
    xj, xt = both(rand((3, 24)))
    close(tl.linear(port(p), xt), jl.linear(p, xj))


def test_embed_and_unembed_match_jax():
    p = jl.init_embedding(jax.random.PRNGKey(2), 50, 16)
    ids = np.random.default_rng(0).integers(0, 50, (2, 7))
    tp = port(p)
    close(tl.embed(tp, torch.as_tensor(ids)), jl.embed(p, jnp.asarray(ids)))
    xj, xt = both(rand((2, 7, 16)))
    close(tl.unembed(tp, xt), jl.unembed(p, xj))
    q = {"qt": jnp.asarray(np.random.default_rng(1).integers(
        -127, 128, (50, 16), np.int8)),
        "scale": jnp.asarray(rand((50, 1), 5, 0.01))}
    close(tl.embed(port(q), torch.as_tensor(ids)),
          jl.embed(q, jnp.asarray(ids)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_layernorm_match_jax(dtype):
    x = rand((3, 5, 32), 0, 3.0) + 1.0
    xj = jnp.asarray(x, dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    rp = {"scale": jnp.asarray(rand((32,), 1))}
    lp = {"scale": jnp.asarray(rand((32,), 2)),
          "bias": jnp.asarray(rand((32,), 3))}
    tol = TOL if dtype == "float32" else 2.0 ** -7
    for eps in (1e-6, 1e-5):
        got = tn.rmsnorm(port(rp), xt, eps)
        assert got.dtype == xt.dtype
        close(got, jn.rmsnorm(rp, xj, eps), tol)
    close(tn.layernorm(port(lp), xt), jn.layernorm(lp, xj), tol)
    assert set(tn.init_rmsnorm(32)) == set(jn.init_rmsnorm(32))
    assert set(tn.init_layernorm(32)) == set(jn.init_layernorm(32))


@pytest.mark.parametrize("head_dim", [16, 15])
def test_rope_matches_jax_at_shared_and_per_row_positions(head_dim):
    x = rand((3, 6, 4, head_dim))
    xj, xt = both(x)
    close(tr.rope_freqs(head_dim), jr.rope_freqs(head_dim))
    shared = np.arange(6, dtype=np.int32) + 5
    close(tr.apply_rope(xt, torch.as_tensor(shared)),
          jr.apply_rope(xj, jnp.asarray(shared)))
    per_row = np.random.default_rng(1).integers(0, 4000, (3, 6)).astype(
        np.int32)
    got = tr.apply_rope(xt, torch.as_tensor(per_row))
    close(got, jr.apply_rope(xj, jnp.asarray(per_row)))
    # each row at its own positions == that row alone
    for b in range(3):
        close(got[b:b + 1], tr.apply_rope(xt[b:b + 1],
                                          torch.as_tensor(per_row[b])), 0)
    if head_dim % 2:        # the odd channel passes through unrotated
        assert torch.equal(got[..., -1], xt[..., -1])


@pytest.mark.parametrize("kw", [
    dict(), dict(fused=True), dict(gated=False, activation="relu"),
    dict(activation="gelu"), dict(gated=False, activation="hardswish")])
def test_mlp_matches_jax(kw):
    jc = jmlp.MlpConfig(32, 64, **kw)
    tc = tmlp.MlpConfig(32, 64, **kw)
    p = jmlp.init_mlp(jax.random.PRNGKey(3), jc)
    xj, xt = both(rand((2, 5, 32)))
    close(tmlp.mlp(port(p), xt, tc), jmlp.mlp(p, xj, jc))
    t = tmlp.init_mlp(torch.Generator().manual_seed(0), tc)
    assert jax.tree.map(lambda a: a.shape, p) == jax.tree.map(
        lambda a: tuple(a.shape), t)


# ---------------------------------------------------------------------------
# relu_linear attention (GQA: 2 kv heads under 4 heads)
# ---------------------------------------------------------------------------

def _attn_cfgs(**kw):
    base = dict(d_model=32, n_heads=4, n_kv=2, head_dim=16,
                backend="relu_linear")
    base.update(kw)
    return ja.AttnConfig(**base), ta.AttnConfig(**base)


def _attn_case(S, seed=0, fused=False, B=2):
    jc, tc = _attn_cfgs(fused_qkv=fused)
    p = ja.init_attention(jax.random.PRNGKey(seed), jc)
    x = rand((B, S, 32), seed + 1)
    return jc, tc, p, port(p), x


@pytest.mark.parametrize("S,fused", [(512, False), (300, False),
                                     (40, True)])
def test_relu_linear_attention_and_cache_match_jax(S, fused):
    """S = 512: two chunks of 256 on both sides; S = 300: JAX one chunk,
    the port two (padded); S = 40 with the fused QKV projection."""
    jc, tc, p, tp, x = _attn_case(S, fused=fused)
    xj, xt = both(x)
    yj, cj = ja.attention(p, xj, jc, return_cache=True)
    yt, ct = ta.attention(tp, xt, tc, return_cache=True)
    close(yt, yj)
    tree_close(ct, cj)
    close(ta.attention(tp, xt, tc, reference=True), yj)
    t = ta.init_attention(torch.Generator().manual_seed(0), tc)
    assert jax.tree.map(lambda a: a.shape, p) == jax.tree.map(
        lambda a: tuple(a.shape), t)


def test_relu_linear_noncausal_matches_jax():
    jc, tc = _attn_cfgs(causal=False)
    p = ja.init_attention(jax.random.PRNGKey(5), jc)
    xj, xt = both(rand((2, 24, 32), 6))
    close(ta.attention(port(p), xt, tc), ja.attention(p, xj, jc))


def test_relu_linear_decode_matches_jax_and_hands_off_from_prefill():
    """JAX's decode at one position against the port's at a (B,)
    position tensor; then the handoff: prefill S, decode token S ==
    prefill S + 1's last row (and its cache)."""
    S = 37
    jc, tc, p, tp, x = _attn_case(S + 1, seed=7)
    xj, xt = both(x)
    _, cj = ja.attention(p, xj[:, :S], jc, return_cache=True)
    _, ct = ta.attention(tp, xt[:, :S], tc, return_cache=True)
    yj, nj = ja.attention_decode(p, xj[:, S:], cj, jnp.int32(S), jc)
    yt, nt = ta.attention_decode(tp, xt[:, S:], ct, torch.tensor([S, S]),
                                 tc)
    close(yt, yj)
    tree_close(nt, nj)
    y_full, c_full = ta.attention(tp, xt, tc, return_cache=True)
    close(yt, y_full[:, S:])
    for k in c_full:
        close(nt[k], c_full[k])


def test_relu_linear_decode_positions_are_per_row():
    """Rows at different positions == each row decoded alone at its
    own."""
    jc, tc, p, tp, x = _attn_case(1, seed=8, B=3)
    xt = torch.from_numpy(x)
    cache = ta.init_kv_cache(tc, 3, 64)
    cache = {k: torch.rand(v.shape, generator=torch.Generator()
                           .manual_seed(1)) for k, v in cache.items()}
    pos = torch.tensor([3, 17, 40])
    y, new = ta.attention_decode(tp, xt, cache, pos, tc)
    for b in range(3):
        yb, nb = ta.attention_decode(
            tp, xt[b:b + 1], {k: v[b:b + 1] for k, v in cache.items()},
            int(pos[b]), tc)
        close(y[b:b + 1], yb, 1e-6)
        close(new["state"][b:b + 1], nb["state"], 1e-6)
    yj, _ = ja.attention_decode(
        p, jnp.asarray(x[1:2]), {k: jnp.asarray(v[1:2].numpy())
                                 for k, v in cache.items()},
        jnp.int32(17), jc)
    close(y[1:2], yj)


# ---------------------------------------------------------------------------
# Mamba-2
# ---------------------------------------------------------------------------

def _mamba_case(seed=0, chunk=32, **kw):
    base = dict(d_model=32, d_state=16, head_dim=16, chunk=chunk)
    base.update(kw)
    jc, tc = jm.Mamba2Config(**base), tm.Mamba2Config(**base)
    p = jm.init_mamba2(jax.random.PRNGKey(seed), jc)
    return jc, tc, p, port(p)


@pytest.mark.parametrize("S,groups", [(64, 1), (45, 1), (2, 1), (64, 2)])
def test_mamba2_and_cache_match_jax(S, groups):
    """S = 64: two chunks of 32 on both sides; S = 45: JAX one chunk,
    the port two (padded); S = 2: shorter than the conv window (the tail
    is zero-padded); two B/C groups."""
    jc, tc, p, tp = _mamba_case(n_groups=groups)
    xj, xt = both(rand((2, S, 32), 3))
    yj, cj = jm.mamba2(p, xj, jc, return_cache=True)
    yt, ct = tm.mamba2(tp, xt, tc, return_cache=True)
    close(yt, yj)
    tree_close(ct, cj)
    close(tm.mamba2(tp, xt, tc, reference=True), yj)
    t = tm.init_mamba2(torch.Generator().manual_seed(0), tc)
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), p) == \
        jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]),
                     t)


def test_mamba2_decode_matches_jax_and_hands_off_from_prefill():
    S = 40
    jc, tc, p, tp = _mamba_case(seed=1)
    x = rand((2, S + 1, 32), 4)
    xj, xt = both(x)
    _, cj = jm.mamba2(p, xj[:, :S], jc, return_cache=True)
    _, ct = tm.mamba2(tp, xt[:, :S], tc, return_cache=True)
    yj, nj = jm.mamba2_decode(p, xj[:, S:], cj, jc)
    yt, nt = tm.mamba2_decode(tp, xt[:, S:], ct, tc)
    close(yt, yj)
    tree_close(nt, nj)
    y_full, c_full = tm.mamba2(tp, xt, tc, return_cache=True)
    close(yt, y_full[:, S:])
    for k in c_full:
        close(nt[k], c_full[k])


def test_mamba2_decode_from_a_zero_fp32_cache_matches_jax():
    """The served cache: fp32 zeros (``init_mamba2_cache``), the step's
    conv window promoted to fp32 as JAX's concatenation promotes."""
    jc, tc, p, tp = _mamba_case(seed=2)
    xj, xt = both(rand((3, 1, 32), 5))
    cj = jm.init_mamba2_cache(jc, 3)
    ct = tm.init_mamba2_cache(tc, 3)
    tree_close(ct, cj)
    yj, nj = jm.mamba2_decode(p, xj, cj, jc)
    yt, nt = tm.mamba2_decode(tp, xt, ct, tc)
    close(yt, yj)
    tree_close(nt, nj)


# ---------------------------------------------------------------------------
# params_from_jax
# ---------------------------------------------------------------------------

def test_params_from_jax_takes_bf16_leaves_bit_for_bit():
    a = jax.random.normal(jax.random.PRNGKey(0), (5, 7), jnp.bfloat16)
    tree = {"w": a, "stack": [a[None], a.astype(jnp.float32)]}
    got = params_from_jax(jax.tree.map(np.asarray, tree), "cpu")
    assert got["w"].dtype == torch.bfloat16
    bits = np.asarray(a).view(np.uint16).astype(np.int64)
    assert np.array_equal(got["w"].view(torch.int16).numpy().view(np.uint16)
                          .astype(np.int64), bits)
    assert torch.equal(got["stack"][0][0], got["w"])
    assert torch.equal(got["stack"][1], got["w"].float())
