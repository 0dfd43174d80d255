"""The port's encoder-decoder (``repro_torch/models/encdec.py``) and its
registry branch on the CPU, held against JAX's at
``smoke_variant(seamless-m4t-large-v2)`` (2 + 2 layers, d_model 64),
weights from JAX's init carried over by ``params_from_jax``, frames and
tokens from numpy seeds.

Tolerance: the encoder memory, the decoder's hidden states and the serve
state's cross K/V within 1e-5 * max(1, max|leaf|); decode logits within
1e-4 * max(1, max|logit|) over 8 steps with fp32 caches, and within
1e-2 * max(1, max|logit|) through the registry's bf16 state (one fp32
ulp of k can flip a bf16 rounding on one side only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import smoke_variant as jsmoke
from repro.models import encdec as jed
from repro.models.registry import build_model as jbuild
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.convert import params_from_jax
from repro_torch.models import encdec as ted
from repro_torch.models.lm import lm_logits_head
from repro_torch.models.registry import ENC_MEMORY_LEN, build_model
from repro_torch.serving.engine import ServeConfig, ServingEngine

NAME = "seamless-m4t-large-v2"
LEAF_TOL = 1e-5
LOGIT_TOL = 1e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, ref, tol):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), (err, np.abs(ref).max())


def leaves(tree):
    return {tuple(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def dtype_name(x):
    return str(x.dtype).split(".")[-1]


@pytest.fixture(scope="module")
def model():
    jc, tc = jsmoke(JARCHS[NAME]), smoke_variant(get_arch(NAME))
    jp = jbuild(jc).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


def _frames(cfg, B, S, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_encdec_tree_matches_jax_leaf_for_leaf(dtype):
    """``init_encdec``'s tree against JAX's, path for path, shape and
    dtype (``enc_blocks`` (n_layers, ...), ``dec_blocks`` (dec_layers,
    ...)), at the smoke size."""
    jc = jsmoke(JARCHS[NAME]).scaled(param_dtype=dtype)
    tc = smoke_variant(get_arch(NAME)).scaled(param_dtype=dtype)
    ref = leaves(jax.eval_shape(lambda: jbuild(jc).init(
        jax.random.PRNGKey(0))))
    tp = build_model(tc).init(0, device="cpu")
    for path, s in ref.items():
        t = at(tp, path)
        assert tuple(t.shape) == s.shape, path
        assert dtype_name(t) == str(s.dtype), path
    n = sum(1 for _ in jax.tree_util.tree_leaves(
        jax.tree.map(lambda a: 0, tp)))
    assert n == len(ref)


@pytest.mark.parametrize("S", [24, 40])
def test_encode_and_decode_train_match_jax(model, S):
    """The encoder memory of a batch of 2 (S_enc frames) and the
    decoder's hidden states over 10 tokens against JAX's."""
    jc, tc, jp, tp = model
    fr = _frames(jc, 2, S, S)
    mj = jax.jit(lambda p, f: jed.encode(p, f, jc))(jp, jnp.asarray(fr))
    mt = ted.encode(tp, torch.from_numpy(fr), tc)
    close(mt, mj, LEAF_TOL)
    toks = np.random.default_rng(S + 1).integers(0, jc.vocab, (2, 10))
    hj = jax.jit(lambda p, t, m: jed.decode_train(p, t, m, jc))(
        jp, jnp.asarray(toks, jnp.int32), mj)
    ht = ted.decode_train(tp, torch.as_tensor(toks), mt, tc)
    close(ht, hj, LEAF_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_encdec_state_matches_jax(model, dtype):
    """The serve state: the cross K/V of each decoder layer (L, B, S_enc,
    KV, Dh) within 1e-5 (bf16: one bf16 step, 2^-7) of max|leaf|, and
    zero self caches of ``max_len`` positions, in ``dtype``."""
    jc, tc, jp, tp = model
    fr = _frames(jc, 3, 20, 3)
    sj = jax.jit(lambda p, f: jed.init_encdec_state(
        p, f, jc, 12, jnp.dtype(dtype)))(jp, jnp.asarray(fr))
    st = ted.init_encdec_state(tp, torch.from_numpy(fr), tc, 12,
                               getattr(torch, dtype))
    tol = LEAF_TOL if dtype == "float32" else 2.0 ** -7
    for path, leaf in leaves(sj).items():
        t = at(st, path)
        assert dtype_name(t) == str(leaf.dtype), path
        close(t, leaf, tol)
    assert not bool(st["self"]["k"].any()) and \
        st["self"]["k"].shape == (2, 3, 12, tc.n_kv, tc.head_dim)


def test_decode_steps_match_jax(model):
    """8 steps of ``encdec_decode_step`` from fp32 caches (the port at a
    (B,) position tensor every other step): each step's logits against
    JAX's within 1e-4 * max(1, max|logit|), the self caches at the end
    within 1e-4; the cross K/V pass through untouched, and the input
    state is not written."""
    jc, tc, jp, tp = model
    fr = _frames(jc, 2, 24, 5)
    sj = jed.init_encdec_state(jp, jnp.asarray(fr), jc, 10, jnp.float32)
    st = ted.init_encdec_state(tp, torch.from_numpy(fr), tc, 10,
                               torch.float32)
    toks = np.random.default_rng(6).integers(0, jc.vocab, (2, 8))
    dec = jax.jit(lambda p, s, t, pos: jed.encdec_decode_step(
        p, s, t, pos, jc))
    first = jax.tree.map(lambda a: a.clone(), st)
    for t in range(8):
        nt = toks[:, t:t + 1]
        lj, sj = dec(jp, sj, jnp.asarray(nt, jnp.int32), jnp.int32(t))
        pos = torch.full((2,), t) if t % 2 else t
        lt, new = ted.encdec_decode_step(tp, st, torch.as_tensor(nt), pos,
                                         tc)
        if t == 0:
            assert all(torch.equal(a, b) for a, b in zip(
                jax.tree_util.tree_leaves(first),
                jax.tree_util.tree_leaves(st)))
        assert new["cross"] is st["cross"]
        st = new
        close(lt, lj, LOGIT_TOL)
    for path, leaf in leaves(sj["self"]).items():
        close(at(st["self"], path), leaf, LOGIT_TOL)


def test_decode_equals_decode_train(model):
    """Decode against the cache-free forward: each step's logits equal
    ``lm_logits_head`` of ``decode_train``'s last row over the tokens so
    far, within 1e-4 * max(1, max|logit|) (fp32 caches)."""
    _, tc, _, tp = model
    fr = torch.from_numpy(_frames(tc, 2, 16, 7))
    memory = ted.encode(tp, fr, tc)
    st = ted.init_encdec_state(tp, fr, tc, 6, torch.float32)
    toks = torch.as_tensor(np.random.default_rng(8).integers(
        0, tc.vocab, (2, 6)))
    for t in range(6):
        lg, st = ted.encdec_decode_step(tp, st, toks[:, t:t + 1], t, tc)
        h = ted.decode_train(tp, toks[:, :t + 1], memory, tc)
        close(lg, lm_logits_head(tp, h[:, -1:], tc)[:, 0], LOGIT_TOL)


def test_registry_prefill_returns_the_state_and_decodes_like_jax(model):
    """``prefill(params, {"frames", "tokens"})`` returns the serve state
    only (bf16, self caches sized by ``tokens.shape[1]``), equal to JAX's
    within one bf16 step; decode from it returns (logits (B, V), state),
    4 steps within 1e-2 * max(1, max|logit|) of JAX's."""
    jc, tc, jp, tp = model
    jm, tm = jbuild(jc), build_model(tc)
    fr = _frames(jc, 2, 24, 9)
    toks = np.random.default_rng(10).integers(0, jc.vocab, (2, 5))
    sj = jax.jit(jm.prefill)(jp, {"frames": jnp.asarray(fr),
                                  "tokens": jnp.asarray(toks, jnp.int32)})
    st = tm.prefill(tp, {"frames": torch.from_numpy(fr),
                         "tokens": torch.as_tensor(toks)})
    assert set(st) == {"cross", "self"}
    assert st["self"]["k"].shape[2] == 5
    for path, leaf in leaves(sj).items():
        t = at(st, path)
        assert t.dtype == torch.bfloat16, path
        close(t, leaf, 2.0 ** -7)
    dec = jax.jit(jm.decode)
    for t in range(4):
        lj, sj = dec(jp, sj, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                     jnp.int32(t))
        out = tm.decode(tp, st, torch.as_tensor(toks[:, t:t + 1]), t)
        assert isinstance(out, tuple) and len(out) == 2
        lt, st = out
        assert lt.shape == (2, tc.vocab)
        close(lt, lj, 1e-2)


@pytest.mark.parametrize("full", [False, True])
def test_init_caches_match_jax_eval_shape(full):
    """``init_caches(batch, max_len)``: the leaf shapes and dtypes of
    ``jax.eval_shape`` of JAX's (cross K/V ``ENC_MEMORY_LEN`` = 4096
    positions, bf16), at the smoke and (on the meta device) the published
    size."""
    jc, tc = JARCHS[NAME], get_arch(NAME)
    if not full:
        jc, tc = jsmoke(jc), smoke_variant(tc)
    ref = leaves(jax.eval_shape(lambda: jbuild(jc).init_caches(3, 48)))
    got = build_model(tc).init_caches(3, 48, device="meta" if full
                                      else "cpu")
    assert {p: (tuple(at(got, p).shape), dtype_name(at(got, p)))
            for p in ref} == {p: (s.shape, str(s.dtype))
                              for p, s in ref.items()}
    assert ENC_MEMORY_LEN == 4096
    assert at(got, ("cross", "ck")).shape[2] == ENC_MEMORY_LEN


def test_serving_engine_refuses_encdec(model):
    """The ``ServingEngine`` serves decoder-only LMs: an enc-dec arch
    raises ``ValueError`` in the constructor (JAX's engine fails inside
    ``admit``, unpacking a state as (logits, caches))."""
    _, tc, _, tp = model
    with pytest.raises(ValueError, match="enc-dec"):
        ServingEngine(tc, tp, ServeConfig(max_slots=2, max_len=32),
                      device="cpu")
