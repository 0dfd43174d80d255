"""The port's LM stack on the CPU (configs, ``models/lm.py``,
``models/registry.py``, ``serving/sampler.py``, ``serving/engine.py``),
held against the JAX package's, on ``smoke_variant`` of mamba2-1.3b and
of zamba2-1.2b under ``attn_backend="relu_linear"`` (also at 5 layers,
which gives zamba2 a Mamba tail).

Weights are JAX's init carried over by ``params_from_jax``.  Tolerance:
logits within 1e-4 * max(1, max|logit|) of JAX's, cache leaves within
1e-5 * max(1, max|leaf|) after one prefill, 1e-4 after decode steps.
Tokens: the port's greedy tokens equal JAX's wherever JAX's top-2
margin exceeds the logit tolerance (compared up to the first position
where it does not: after it the two contexts differ).  The engine's
per-step logits are compared teacher-forced on JAX's engine's tokens.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import smoke_variant as jsmoke
from repro.configs import supports as jsupports
from repro.models.registry import build_model as jbuild
from repro.serving import engine as jeng
from repro.serving.sampler import SamplerConfig as JSamplerConfig
from repro_torch.configs import ARCHS, SHAPES, get_arch, smoke_variant
from repro_torch.configs import supports
from repro_torch.convert import params_from_jax
from repro_torch.kernels.relu_attn import ops as relu_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.layers.linear import embed
from repro_torch.models import lm as tlm
from repro_torch.models.registry import build_model
from repro_torch.serving import engine as teng
from repro_torch.serving.sampler import SamplerConfig, sample

jlm = importlib.import_module("repro.models.lm")

LOGIT_TOL = 1e-4
ZAMBA = "zamba2-1.2b"
MAMBA = "mamba2-1.3b"
CASES = {"mamba2": (MAMBA, {}),
         "zamba2": (ZAMBA, {"attn_backend": "relu_linear"}),
         "zamba2-tail": (ZAMBA, {"attn_backend": "relu_linear",
                                 "n_layers": 5})}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, ref, tol):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), (err, np.abs(ref).max())


def leaves(tree):
    """JAX tree -> {path string: leaf}; the port's trees index by the
    same keys."""
    return {tuple(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def tree_close(got, ref, tol):
    for path, leaf in leaves(ref).items():
        node = at(got, path)
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
        close(node, leaf, tol)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    name, kw = CASES[request.param]
    jc = jsmoke(JARCHS[name]).scaled(**kw)
    tc = smoke_variant(get_arch(name)).scaled(**kw)
    jp = jbuild(jc).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_configs_equal_jax_field_for_field():
    assert list(ARCHS) == list(JARCHS)
    for name, jc in JARCHS.items():
        tc = ARCHS[name]
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc), name
        assert dataclasses.asdict(smoke_variant(tc)) == \
            dataclasses.asdict(jsmoke(jc)), name
        for shape in JSHAPES:
            assert supports(tc, SHAPES[shape]) == \
                jsupports(jc, JSHAPES[shape]), (name, shape)
        assert tc.pdtype == getattr(torch, str(jc.pdtype))
        assert tc.cdtype == getattr(torch, str(jc.cdtype))
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


# ---------------------------------------------------------------------------
# init, prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_init_lm_tree_matches_jax_leaf_for_leaf(name, dtype):
    arch, kw = CASES[name]
    kw = dict(kw, param_dtype=dtype)
    jc = jsmoke(JARCHS[arch]).scaled(**kw)
    tc = smoke_variant(get_arch(arch)).scaled(**kw)
    jshapes = leaves(jax.eval_shape(lambda: jbuild(jc).init(
        jax.random.PRNGKey(0))))
    tp = build_model(tc).init(0, device="cpu")
    tshapes = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            tshapes[path] = node

    walk(tp, ())
    assert set(tshapes) == set(jshapes)
    for path, s in jshapes.items():
        t = tshapes[path]
        assert tuple(t.shape) == s.shape, path
        assert str(t.dtype).split(".")[-1] == str(s.dtype), path
    # the caches, at the full config too, on the meta device
    for c_j, c_t in ((jc, tc), (JARCHS[arch].scaled(**kw),
                                get_arch(arch).scaled(**kw))):
        jcache = leaves(jax.eval_shape(lambda: jbuild(c_j).init_caches(3,
                                                                       64)))
        tcache = build_model(c_t).init_caches(3, 64, device="meta")
        assert {p: (tuple(at(tcache, p).shape),
                    str(at(tcache, p).dtype).split(".")[-1])
                for p in jcache} == {p: (s.shape, str(s.dtype))
                                     for p, s in jcache.items()}


@pytest.mark.parametrize("S", [40, 64])
def test_prefill_and_decode_match_jax(case, S):
    """A batch of 2 prompts of S tokens (64: two SSD chunks of 32; 40:
    ragged), then 3 decode steps: every step's logits and the caches."""
    jc, tc, jp, tp = case
    jm, tm = jbuild(jc), build_model(tc)
    rng = np.random.default_rng(S)
    toks = rng.integers(0, jc.vocab, (2, S))
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tcache = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    close(tl, jl, LOGIT_TOL)
    tree_close(tcache, jcache, 1e-5)
    rl, _ = build_model(tc, reference=True).prefill(
        tp, {"tokens": torch.as_tensor(toks)})
    assert torch.equal(rl, tl)      # on the CPU both run the plain scans
    for t in range(3):
        nt = rng.integers(0, jc.vocab, (2, 1))
        jl, jcache = jm.decode(jp, jcache, jnp.asarray(nt, jnp.int32),
                               jnp.int32(S + t))
        pos = torch.full((2,), S + t) if t % 2 else S + t
        tl, tcache = tm.decode(tp, tcache, torch.as_tensor(nt), pos)
        close(tl, jl, LOGIT_TOL)
    tree_close(tcache, jcache, 1e-4)


@pytest.mark.parametrize("S", [40, 64])
def test_forward_hidden_matches_jax(case, S):
    """The no-cache forward (``block_apply`` over the stack, then the
    final norm) on an embedded batch of 2 against JAX's
    ``forward_hidden``, and equal to the served prefill's last-token
    logits through ``lm_logits_head``."""
    jc, tc, jp, tp = case
    x = np.random.default_rng(S + 1).standard_normal(
        (2, S, jc.d_model)).astype(np.float32)
    hj, _ = jlm.forward_hidden(jp, jnp.asarray(x), jc, jnp.arange(S))
    ht, aux = tlm.forward_hidden(tp, torch.from_numpy(x), tc,
                                 torch.arange(S))
    close(ht, hj, LOGIT_TOL)
    assert float(aux) == 0.0
    toks = torch.as_tensor(np.random.default_rng(S).integers(
        0, tc.vocab, (2, S)))
    h, _ = tlm.forward_hidden(tp, embed(tp["embed"], toks, tc.cdtype),
                              tc, torch.arange(S))
    logits, _ = build_model(tc).prefill(tp, {"tokens": toks})
    close(tlm.lm_logits_head(tp, h[:, -1:], tc)[:, 0], logits, 1e-6)


def test_decode_leaves_its_input_caches_unwritten(case):
    _, tc, _, tp = case
    tm = build_model(tc)
    _, caches = tm.prefill(tp, {"tokens": torch.arange(9)[None] % tc.vocab})
    before = jax.tree.map(lambda a: a.clone(), caches)
    tm.decode(tp, caches, torch.tensor([[3]]), 9)
    assert jax.tree.all(jax.tree.map(torch.equal, caches, before))


def test_prefill_reaches_both_scans_and_reference_neither(case,
                                                          monkeypatch):
    """The served prefill calls the kernels' wrappers (which on a CUDA
    tensor launch the kernels); the reference forward calls their plain
    versions only."""
    _, tc, _, tp = case
    calls = {"relu_attn_causal": 0, "ssd_chunked": 0}
    for mod, name in ((relu_ops, "relu_attn_causal"),
                      (ssd_ops, "ssd_chunked")):
        real = getattr(mod, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    toks = {"tokens": torch.arange(20)[None] % tc.vocab}
    build_model(tc, reference=True).prefill(tp, toks)
    assert calls == {"relu_attn_causal": 0, "ssd_chunked": 0}
    build_model(tc).prefill(tp, toks)
    n_attn = (tc.n_layers // tc.shared_attn_every
              if tc.family == "zamba2" else 0)
    assert calls == {"relu_attn_causal": n_attn,
                     "ssd_chunked": tc.n_layers}


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------

def _requests(vocab, mod):
    rng = np.random.default_rng(0)
    lens = (5, 33, 12, 64, 20)
    return [mod.Request(rid=i, prompt=rng.integers(0, vocab, size=n),
                        max_tokens=4 + i % 2) for i, n in enumerate(lens)]


def _jax_logits(jc, jp, prompt, tokens):
    """JAX's teacher-forced logits of one request: its prefill, then one
    decode step per token but the last."""
    jm = jbuild(jc)
    logits, caches = jm.prefill(
        jp, {"tokens": jnp.asarray(prompt, jnp.int32)[None]})
    out = [np.asarray(logits[0])]
    for i, tok in enumerate(tokens[:-1]):
        logits, caches = jm.decode(jp, caches, jnp.full((1, 1), tok,
                                                        jnp.int32),
                                   jnp.int32(len(prompt) + i))
        out.append(np.asarray(logits[0]))
    return out


def _margin(logits):
    top2 = np.sort(logits)[-2:]
    return top2[1] - top2[0]


def test_serving_engine_matches_jax(case, monkeypatch):
    """2 slots, 5 ragged requests, greedy: the port's engine against
    JAX's.  Teacher-forced on JAX's tokens (the engine's sampler made to
    return them), every admission's and decode step's logits of every
    slot match JAX's; free-running, the tokens equal JAX's wherever
    JAX's margin exceeds the tolerance."""
    jc, tc, jp, tp = case
    cfg = dict(max_slots=2, max_len=96)
    jdone = jeng.ServingEngine(jc, jp, jeng.ServeConfig(
        **cfg, sampler=JSamplerConfig())).run(_requests(jc.vocab, jeng))
    jtok = {r.rid: r.out_tokens for r in jdone}
    reqs = _requests(tc.vocab, teng)
    ref = {r.rid: _jax_logits(jc, jp, r.prompt, jtok[r.rid]) for r in reqs}

    # free-running
    eng = teng.ServingEngine(tc, tp, teng.ServeConfig(**cfg), device="cpu")
    done = eng.run(reqs)
    assert sorted(r.rid for r in done) == sorted(jtok)
    assert [r.rid for r in done] == [r.rid for r in jdone]
    for r in done:
        assert len(r.out_tokens) == r.max_tokens
        for i, (got, want) in enumerate(zip(r.out_tokens, jtok[r.rid])):
            lg = ref[r.rid][i]
            if _margin(lg) <= LOGIT_TOL * max(1.0, np.abs(lg).max()):
                break
            assert got == want, (r.rid, i)
    assert eng.telemetry.snapshot()["counters"]["admitted"] == 5

    # teacher-forced through the engine's own admit / step
    reqs = _requests(tc.vocab, teng)
    eng = teng.ServingEngine(tc, tp, teng.ServeConfig(**cfg), device="cpu")
    order = iter(reqs)
    seen = {r.rid: [] for r in reqs}

    def forced(logits, generator, scfg):
        if logits.shape[0] == 1 and scfg == teng.GREEDY:   # an admission
            r = next(order)
            seen[r.rid].append(logits[0])
            return torch.tensor([jtok[r.rid][0]])
        out = torch.zeros(logits.shape[0], dtype=torch.long)
        for i, r in enumerate(eng.slot_req):
            if r is not None:
                seen[r.rid].append(logits[i])
                out[i] = jtok[r.rid][len(r.out_tokens)]
        return out

    monkeypatch.setattr(teng, "sample", forced)
    eng.run(reqs)
    for rid, got in seen.items():
        assert len(got) == len(ref[rid])
        for g, w in zip(got, ref[rid]):
            close(g, w, LOGIT_TOL)


def test_engine_batch_axes_by_construction(case):
    _, tc, _, _ = case
    axes = teng._batch_axes(build_model(tc), 64)
    want = {"mamba2": {"blocks": {"conv": 1, "ssm": 1}},
            "zamba2": {"mamba_groups": {"conv": 2, "ssm": 2},
                       "shared_attn": {"state": 1, "zsum": 1}}}[tc.family]
    if tc.n_layers % max(tc.shared_attn_every, 1) and tc.family == "zamba2":
        want["mamba_tail"] = {"conv": 1, "ssm": 1}
    assert axes == want


def test_engine_refuses_a_request_beyond_max_len(case):
    """A prompt plus ``max_tokens`` longer than ``max_len`` is refused
    before any slot is taken; one that just fits is served."""
    _, tc, _, tp = case
    eng = teng.ServingEngine(tc, tp, teng.ServeConfig(max_slots=1,
                                                      max_len=12),
                             device="cpu")
    with pytest.raises(ValueError, match="exceed max_len 12"):
        eng.admit(teng.Request(rid=0, prompt=np.arange(9), max_tokens=4))
    assert eng.active() == 0
    done = eng.run([teng.Request(rid=1, prompt=np.arange(9), max_tokens=3)])
    assert [len(r.out_tokens) for r in done] == [3]


def test_engine_refuses_the_cpu_unasked(case, monkeypatch):
    _, tc, _, tp = case
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teng.ServingEngine(tc, tp, teng.ServeConfig(max_slots=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(tc).init(0)


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------

def _logits():
    return torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 50)).astype(np.float32) * 3)


def test_greedy_is_argmax():
    lg = _logits()
    assert torch.equal(sample(lg, None, SamplerConfig()), lg.argmax(-1))


def test_top_k_and_top_p_keep_only_their_support():
    lg = _logits()
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([sample(lg, gen, SamplerConfig(temperature=1.0,
                                                       top_k=3))
                         for _ in range(200)])
    for row in range(4):
        support = set(torch.topk(lg[row], 3).indices.tolist())
        assert set(draws[:, row].tolist()) <= support
    sp, si = torch.sort(torch.softmax(lg, -1), -1, descending=True)
    cum = sp.cumsum(-1)
    draws = torch.stack([sample(lg, gen, SamplerConfig(temperature=1.0,
                                                       top_p=0.6))
                         for _ in range(200)])
    for row in range(4):
        n = int((cum[row] < 0.6).sum()) + 1      # smallest prefix >= 0.6
        got = set(draws[:, row].tolist())
        assert got <= set(si[row, :n].tolist())
        assert len(got) > 1 or n == 1


def test_one_seed_gives_the_same_tokens_twice():
    lg = _logits()
    cfg = SamplerConfig(temperature=0.8, top_k=10, top_p=0.9)
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(7)
        runs.append(torch.stack([sample(lg, gen, cfg) for _ in range(20)]))
    assert torch.equal(runs[0], runs[1])
    gen = torch.Generator().manual_seed(8)
    other = torch.stack([sample(lg, gen, cfg) for _ in range(20)])
    assert not torch.equal(runs[0], other)
