"""The port's dense, vlm, gemma3 and moe LM families (grok-1 and kimi-k2:
their smoke MoE of 4 experts top-2), zamba2 as published (its shared
block on softmax attention), the KV caches through the registry and the
``ServingEngine``, and ``launch/serve.py``, on the CPU, held against the
JAX package at ``smoke_variant`` sizes.

Weights are JAX's init carried over by ``params_from_jax``; JAX's
prefill and decode run jitted.  The tight cases cache K/V in fp32
(``kv_dtype="float32"``).  Tolerance: logits within 1e-4 * max(1,
max|logit|) of JAX's, cache leaves within 1e-5 * max(1, max|leaf|) after
a prefill and 1e-4 after decode steps.  With JAX's default bf16 KV cache
one fp32 ulp of k can flip a bf16 rounding on one side only, so that
case holds cache leaves to one bf16 step (2^-7) of max|leaf| and logits
to 1e-2 * max(1, max|logit|).  The engine is compared teacher-forced on
JAX's engine's tokens: every admission's and decode step's logits
against JAX's batch-1 prefill of the request and its decode steps from
the cache padded as JAX's engine pads it.  The MoE's aux loss: within
1e-5 of |aux| of JAX's (0 for the other families).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import smoke_variant as jsmoke
from repro.models import lm as jlm
from repro.models.registry import build_model as jbuild
from repro.serving import engine as jeng
from repro.serving.sampler import SamplerConfig as JSamplerConfig
from repro_torch.configs import ARCHS, get_arch, smoke_variant
from repro_torch.convert import params_from_jax
from repro_torch.kernels.relu_attn import ops as relu_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch import serve as tserve
from repro_torch.layers.linear import embed
from repro_torch.models import lm as tlm
from repro_torch.models.registry import build_model
from repro_torch.serving import engine as teng

LOGIT_TOL = 1e-4
FP32_KV = {"kv_dtype": "float32"}
CASES = {
    "granite": ("granite-3-2b", FP32_KV),
    "stablelm": ("stablelm-12b", FP32_KV),
    "qwen2.5": ("qwen2.5-32b", FP32_KV),
    "internvl2": ("internvl2-1b", FP32_KV),
    "gemma3": ("gemma3-12b", FP32_KV),
    "gemma3-relu": ("gemma3-12b", dict(FP32_KV, attn_backend="relu_linear")),
    "zamba2": ("zamba2-1.2b", FP32_KV),
    "grok": ("grok-1-314b", FP32_KV),
    "kimi": ("kimi-k2-1t-a32b", FP32_KV),
}


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


def tree_close(got, ref, tol):
    for path, leaf in leaves(ref).items():
        node = at(got, path)
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
        close(node, leaf, tol)


def configs(name, kw):
    arch, extra = CASES[name] if name in CASES else (name, {})
    kw = dict(extra, **kw)
    return (jsmoke(JARCHS[arch]).scaled(**kw),
            smoke_variant(get_arch(arch)).scaled(**kw))


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    jc, tc = configs(request.param, {})
    jp = jbuild(jc).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return request.param, jc, tc, jp, tp


def _patches(cfg, B, seed):
    """The vlm's stub frontend: random patch embeddings (B, P, D)."""
    if cfg.family != "vlm":
        return None
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.n_patches, cfg.d_model)).astype(np.float32)


def _batch(tokens, patches, lib):
    if lib == "jax":
        b = {"tokens": jnp.asarray(tokens, jnp.int32)}
        if patches is not None:
            b["patches"] = jnp.asarray(patches)
        return b
    b = {"tokens": torch.as_tensor(tokens)}
    if patches is not None:
        b["patches"] = torch.from_numpy(patches)
    return b


def _padded(mod, model, caches, batch, max_len, **kw):
    """A prefill's caches zero-padded to ``max_len`` as each engine pads
    them (``_pad_seq_dims``)."""
    return mod._pad_seq_dims(caches, model.init_caches(batch, max_len, **kw),
                             mod._batch_axes(model, max_len))


# ---------------------------------------------------------------------------
# the trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_init_lm_tree_matches_jax_leaf_for_leaf(name, dtype):
    """The port's init tree and JAX's, path for path, shape and dtype
    (gemma3: ``local`` (groups, global_every - 1, ...), ``global``
    (groups, ...)); the caches too, at the smoke size and, on the meta
    device, at the published one."""
    jc, tc = configs(name, {"param_dtype": dtype})
    jshapes = leaves(jax.eval_shape(lambda: jbuild(jc).init(
        jax.random.PRNGKey(0))))
    tp = build_model(tc).init(0, device="cpu")
    tflat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            tflat[path] = node

    walk(tp, ())
    assert set(tflat) == set(jshapes)
    for path, s in jshapes.items():
        assert tuple(tflat[path].shape) == s.shape, path
        assert str(tflat[path].dtype).split(".")[-1] == str(s.dtype), path
    arch = CASES[name][0]
    full = [(JARCHS[arch].scaled(**CASES[name][1]),
             get_arch(arch).scaled(**CASES[name][1]))]
    for c_j, c_t in [(jc, tc)] + full:
        for max_len in (48, 2048):
            jcache = leaves(jax.eval_shape(
                lambda: jbuild(c_j).init_caches(3, max_len)))
            tcache = build_model(c_t).init_caches(3, max_len, device="meta")
            assert {p: (tuple(at(tcache, p).shape),
                        str(at(tcache, p).dtype).split(".")[-1])
                    for p in jcache} == {p: (s.shape, str(s.dtype))
                                         for p, s in jcache.items()}


def test_build_model_raises_only_for_moe_encdec_and_flash_vjp():
    """Every one of the ten LM configs builds (the moe and enc-dec
    families too), also under ``attn_backend="relu_linear"`` and with
    ``flash_vjp=True`` (training's flash attention, ``layers/flash.py``),
    each with a ``loss``; an unknown family raises."""
    assert {cfg.family for cfg in ARCHS.values()} >= {"moe", "encdec"}
    for name, cfg in ARCHS.items():
        build_model(cfg)
        build_model(cfg.scaled(attn_backend="relu_linear"))
        assert callable(build_model(cfg.scaled(flash_vjp=True)).loss)
    with pytest.raises(ValueError, match="unknown family"):
        build_model(ARCHS["granite-3-2b"].scaled(family="rnn"))


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [40, 64])
def test_forward_hidden_matches_jax(case, S):
    """The no-cache forward on an embedded batch of 2 against JAX's
    ``forward_hidden`` (gemma3 smoke: window 32, so S = 64 takes the
    block path and 40 the fallback) with its aux loss (the MoE layers'
    summed, 0 elsewhere), and the served prefill's last-token logits
    equal to ``lm_logits_head`` of it."""
    _, jc, tc, jp, tp = case
    x = np.random.default_rng(S + 1).standard_normal(
        (2, S, jc.d_model)).astype(np.float32)
    hj, aj = jax.jit(lambda p, x: jlm.forward_hidden(
        p, x, jc, jnp.arange(S)))(jp, jnp.asarray(x))
    ht, aux = tlm.forward_hidden(tp, torch.from_numpy(x), tc,
                                 torch.arange(S))
    close(ht, hj, LOGIT_TOL)
    assert abs(float(aux) - float(aj)) <= 1e-5 * abs(float(aj))
    assert (float(aux) > 0) == (jc.family == "moe")
    toks = torch.as_tensor(np.random.default_rng(S).integers(
        0, tc.vocab, (2, S)))
    h, _ = tlm.forward_hidden(tp, embed(tp["embed"], toks, tc.cdtype), tc,
                              torch.arange(S))
    logits, _ = build_model(tc).prefill(tp, {"tokens": toks})
    close(tlm.lm_logits_head(tp, h[:, -1:], tc)[:, 0], logits, 1e-6)


def _prefill_decode(jc, tc, jp, tp, S, steps, seed, pre_tol, cache_tol,
                    logit_tol):
    """A batch of 2 prompts of S tokens (vlm: after its patches), the
    caches padded to S + steps + 8 positions, then ``steps`` decode
    steps (the port at a (2,) position tensor every other step): every
    step's logits and the caches against JAX's."""
    jm, tm = jbuild(jc), build_model(tc)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jc.vocab, (2, S))
    patches = _patches(jc, 2, seed)
    P = 0 if patches is None else patches.shape[1]
    L = P + S + steps + 8
    jl, jcache = jax.jit(jm.prefill)(jp, _batch(toks, patches, "jax"))
    tl, tcache = tm.prefill(tp, _batch(toks, patches, "torch"))
    close(tl, jl, pre_tol)
    tree_close(tcache, jcache, cache_tol)
    jcache = _padded(jeng, jm, jcache, 2, L)
    tcache = _padded(teng, tm, tcache, 2, L, device="cpu")
    jdec = jax.jit(jm.decode)
    for t in range(steps):
        nt = rng.integers(0, jc.vocab, (2, 1))
        jl, jcache = jdec(jp, jcache, jnp.asarray(nt, jnp.int32),
                          jnp.int32(P + S + t))
        pos = torch.full((2,), P + S + t) if t % 2 else P + S + t
        tl, tcache = tm.decode(tp, tcache, torch.as_tensor(nt), pos)
        close(tl, jl, logit_tol)
    tree_close(tcache, jcache, max(cache_tol, 1e-4))


@pytest.mark.parametrize("S", [40, 64])
def test_prefill_and_decode_match_jax(case, S):
    """Prefill logits and every cache leaf, then 3 decode steps (gemma3
    at S = 40 wraps its 32-slot rings)."""
    _, jc, tc, jp, tp = case
    _prefill_decode(jc, tc, jp, tp, S, 3, S, LOGIT_TOL, 1e-5, LOGIT_TOL)


@pytest.mark.parametrize("name", ["granite", "gemma3"])
def test_bf16_kv_cache_matches_jax_at_a_looser_tolerance(name):
    """JAX's default bf16 KV cache: leaves within one bf16 step, logits
    within 1e-2 * max(1, max|logit|) (see the module docstring)."""
    jc, tc = configs(name, {"kv_dtype": "bfloat16"})
    jp = jbuild(jc).init(jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    _prefill_decode(jc, tc, jp, tp, 40, 3, 7, LOGIT_TOL, 2.0 ** -7, 1e-2)


def test_float8_kv_cache_matches_jax():
    """``kv_dtype="float8_e4m3fn"``: the prefill's cache leaves equal
    JAX's bit for bit, and 3 decode steps read and write the float8
    caches as JAX's do (logits within 1e-2, leaves within one float8
    step, 2^-3)."""
    jc, tc = configs("gemma3", {"kv_dtype": "float8_e4m3fn"})
    jp = jbuild(jc).init(jax.random.PRNGKey(2))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(0).integers(0, jc.vocab, (1, 40))
    _, jcache = jax.jit(jbuild(jc).prefill)(jp, _batch(toks, None, "jax"))
    _, tcache = build_model(tc).prefill(tp, _batch(toks, None, "torch"))
    for path, leaf in leaves(jcache).items():
        node = at(tcache, path)
        if leaf.dtype == jnp.float8_e4m3fn:
            assert node.dtype == torch.float8_e4m3fn, path
            assert np.array_equal(node.view(torch.uint8).numpy(),
                                  np.asarray(leaf).view(np.uint8)), path
    _prefill_decode(jc, tc, jp, tp, 40, 3, 0, LOGIT_TOL, 2.0 ** -3, 1e-2)


def test_decode_leaves_its_input_caches_unwritten(case):
    _, _, tc, _, tp = case
    tm = build_model(tc)
    _, caches = tm.prefill(tp, {"tokens": torch.arange(9)[None] % tc.vocab})
    caches = _padded(teng, tm, caches, 1, 16, device="cpu")
    before = jax.tree.map(lambda a: a.clone(), caches)
    tm.decode(tp, caches, torch.tensor([[3]]), 9)
    assert jax.tree.all(jax.tree.map(torch.equal, caches, before))


def test_prefill_launches_the_scans_where_the_arch_runs_them(case,
                                                             monkeypatch):
    """The served prefill calls ``ssd_chunked`` once per Mamba-2 layer
    and ``relu_attn_causal`` once per relu_linear attention layer
    (gemma3 relu_linear: its global layers); softmax and sliding
    attention call neither; the reference forward calls neither."""
    name, _, tc, _, tp = case
    calls = {"relu_attn_causal": 0, "ssd_chunked": 0}
    for mod, fn in ((relu_ops, "relu_attn_causal"),
                    (ssd_ops, "ssd_chunked")):
        real = getattr(mod, fn)

        def counted(*a, _real=real, _name=fn, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, fn, counted)
    batch = {"tokens": torch.arange(20)[None] % tc.vocab}
    build_model(tc, reference=True).prefill(tp, batch)
    assert calls == {"relu_attn_causal": 0, "ssd_chunked": 0}
    build_model(tc).prefill(tp, batch)
    want = {"gemma3-relu": (tc.n_layers // tc.global_every, 0),
            "zamba2": (0, tc.n_layers)}.get(name, (0, 0))
    assert (calls["relu_attn_causal"], calls["ssd_chunked"]) == want


def test_vlm_prefill_puts_the_patches_before_the_text():
    """vlm: the prefill's logits are ``lm_logits_head`` of the last row
    of ``forward_hidden`` over [patches | text embeddings], and the KV
    caches hold P + S positions; a dense model ignores ``patches``, as
    JAX's does."""
    _, tc = configs("internvl2", {})
    tp = build_model(tc).init(0, device="cpu")
    patches = torch.from_numpy(_patches(tc, 1, 3))
    toks = torch.arange(12)[None] % tc.vocab
    logits, caches = build_model(tc).prefill(tp, {"tokens": toks,
                                                  "patches": patches})
    x = torch.cat([patches, embed(tp["embed"], toks, tc.cdtype)], dim=1)
    h, _ = tlm.forward_hidden(tp, x, tc, torch.arange(x.shape[1]))
    close(logits, tlm.lm_logits_head(tp, h[:, -1:], tc)[:, 0], 1e-6)
    assert caches["blocks"]["k"].shape[2] == tc.n_patches + 12
    dense = tc.scaled(family="dense")
    with_p, _ = build_model(dense).prefill(tp, {"tokens": toks,
                                                "patches": patches})
    close(with_p, build_model(dense).prefill(tp, {"tokens": toks})[0], 0.0)


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------

ENGINE_CASES = ("granite", "gemma3", "zamba2", "grok", "kimi")


def _requests(vocab, mod):
    """5 ragged requests; 33 and 64 tokens exceed gemma3's smoke window
    (32), 30 crosses it while decoding."""
    rng = np.random.default_rng(0)
    lens = (5, 33, 30, 64, 20)
    return [mod.Request(rid=i, prompt=rng.integers(0, vocab, size=n),
                        max_tokens=4 + i % 2) for i, n in enumerate(lens)]


def _jax_logits(jc, jp, prompt, tokens, max_len):
    """JAX's logits of one request as its engine computes them: the
    batch-1 prefill, the cache padded to ``max_len``, one decode step per
    token but the last."""
    jm = jbuild(jc)
    logits, caches = jax.jit(jm.prefill)(
        jp, {"tokens": jnp.asarray(prompt, jnp.int32)[None]})
    caches = _padded(jeng, jm, caches, 1, max_len)
    out = [np.asarray(logits[0])]
    dec = jax.jit(jm.decode)
    for i, tok in enumerate(tokens[:-1]):
        logits, caches = dec(jp, caches, jnp.full((1, 1), tok, jnp.int32),
                             jnp.int32(len(prompt) + i))
        out.append(np.asarray(logits[0]))
    return out


def _margin(logits):
    top2 = np.sort(logits)[-2:]
    return top2[1] - top2[0]


@pytest.mark.parametrize("name", ENGINE_CASES)
def test_serving_engine_matches_jax(name, monkeypatch):
    """2 slots, 5 ragged requests, greedy, ``max_len`` 80 (gemma3: rings
    of 32): free-running, the tokens equal JAX's engine's wherever JAX's
    top-2 margin exceeds the tolerance; teacher-forced on JAX's tokens
    through the port's own admit / step, every admission's and decode
    step's logits match JAX's."""
    jc, tc = configs(name, {})
    jp = jbuild(jc).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    cfg = dict(max_slots=2, max_len=80)
    jdone = jeng.ServingEngine(jc, jp, jeng.ServeConfig(
        **cfg, sampler=JSamplerConfig())).run(_requests(jc.vocab, jeng))
    jtok = {r.rid: r.out_tokens for r in jdone}
    reqs = _requests(tc.vocab, teng)
    ref = {r.rid: _jax_logits(jc, jp, r.prompt, jtok[r.rid], 80)
           for r in reqs}

    eng = teng.ServingEngine(tc, tp, teng.ServeConfig(**cfg), device="cpu")
    done = eng.run(reqs)
    assert [r.rid for r in done] == [r.rid for r in jdone]
    for r in done:
        assert len(r.out_tokens) == r.max_tokens
        for i, (got, want) in enumerate(zip(r.out_tokens, jtok[r.rid])):
            lg = ref[r.rid][i]
            if _margin(lg) <= LOGIT_TOL * max(1.0, np.abs(lg).max()):
                break
            assert got == want, (r.rid, i)

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


@pytest.mark.parametrize("name", ["grok", "kimi"])
def test_engine_sixteen_slots_one_prompt_matches_jax_vmapped_engine(
        name, monkeypatch):
    """16 slots, one prompt in every slot (the smoke MoE: 4 experts
    top-2, 32 decode assignments a step beside a batched capacity of 8):
    JAX's engine ``vmap``s a batch-1 decode over the slots, so every slot
    keeps its tokens; the port's batched step routes each row as its own
    group and must give every slot the tokens of JAX's engine, and,
    teacher-forced on them, every slot's logits equal JAX's batch-1
    logits of the prompt (no row dropped, none depending on another)."""
    jc, tc = configs(name, {})
    jp = jbuild(jc).init(jax.random.PRNGKey(2))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    prompt = np.random.default_rng(3).integers(0, jc.vocab, 20)
    cfg = dict(max_slots=16, max_len=40)

    def reqs(mod):
        return [mod.Request(rid=i, prompt=prompt, max_tokens=6)
                for i in range(16)]

    jdone = jeng.ServingEngine(jc, jp, jeng.ServeConfig(
        **cfg, sampler=JSamplerConfig())).run(reqs(jeng))
    jtok = {r.rid: r.out_tokens for r in jdone}
    assert all(t == jtok[0] for t in jtok.values())
    ref = _jax_logits(jc, jp, prompt, jtok[0], 40)
    eng = teng.ServingEngine(tc, tp, teng.ServeConfig(**cfg), device="cpu")
    done = eng.run(reqs(teng))
    for r in done:
        for i, (got, want) in enumerate(zip(r.out_tokens, jtok[r.rid])):
            if _margin(ref[i]) <= LOGIT_TOL * max(1.0,
                                                  np.abs(ref[i]).max()):
                break
            assert got == want, (r.rid, i)

    eng = teng.ServingEngine(tc, tp, teng.ServeConfig(**cfg), device="cpu")
    seen = {i: [] for i in range(16)}
    order = iter(range(16))                 # admissions in rid order

    def forced(logits, generator, scfg):
        if logits.shape[0] == 1:                       # an admission
            seen[next(order)].append(logits[0])
            return torch.tensor([jtok[0][0]])
        out = torch.zeros(16, dtype=torch.long)
        for i, r in enumerate(eng.slot_req):
            if r is not None:
                seen[r.rid].append(logits[i])
                out[i] = jtok[r.rid][len(r.out_tokens)]
        return out

    monkeypatch.setattr(teng, "sample", forced)
    eng.run(reqs(teng))
    for rid, got in seen.items():
        assert len(got) == len(ref), rid
        for g, w in zip(got, ref):
            close(g, w, LOGIT_TOL)


def test_engine_caches_are_sized_by_max_len_and_axes_found():
    """``max_len`` sizes the KV caches (sliding: a ring of min(max_len,
    window)); the batch axes are found by construction."""
    _, tc = configs("gemma3", {})
    for max_len, ring in ((80, 32), (20, 20)):
        eng = teng.ServingEngine(tc, build_model(tc).init(0, device="cpu"),
                                 teng.ServeConfig(max_slots=3,
                                                  max_len=max_len),
                                 device="cpu")
        assert eng.caches["local"]["k"].shape == (2, 2, 3, ring, 2, 16)
        assert eng.caches["global"]["k"].shape == (2, 3, max_len, 2, 16)
        assert eng.axes == {"local": {"k": 2, "v": 2},
                            "global": {"k": 1, "v": 1}}


def test_engine_zeroes_the_slot_tail_and_refuses_a_long_prefill():
    """A short request admitted into a slot a longer one used leaves no
    key of the old request past its prompt; a prefill cache longer than
    the engine's raises (``_pad_seq_dims``), and ``admit`` refuses a
    request beyond ``max_len`` before any slot is taken."""
    _, tc = configs("granite", {})
    params = build_model(tc).init(0, device="cpu")
    eng = teng.ServingEngine(tc, params, teng.ServeConfig(max_slots=1,
                                                          max_len=40),
                             device="cpu")
    eng.run([teng.Request(rid=0, prompt=np.arange(30) % tc.vocab,
                          max_tokens=3)])
    assert bool(eng.caches["blocks"]["k"][:, 0, 25:32].abs().sum() > 0)
    eng.admit(teng.Request(rid=1, prompt=np.arange(6), max_tokens=2))
    assert bool((eng.caches["blocks"]["k"][:, 0, 6:] == 0).all())
    with pytest.raises(ValueError, match="exceed max_len 40"):
        eng.admit(teng.Request(rid=2, prompt=np.arange(38), max_tokens=4))
    tm = build_model(tc)
    _, big = tm.prefill(params, {"tokens": torch.arange(50)[None]})
    with pytest.raises(ValueError, match="exceeds max_len"):
        teng._pad_seq_dims(big, eng.caches, eng.axes)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launch_serve_smoke_on_the_cpu(capsys):
    """``python -m repro_torch.launch.serve --smoke --device cpu``:
    granite-3-2b's smoke variant at the launcher's defaults serves 12
    requests of 16 tokens."""
    done = tserve.main(["--smoke", "--device", "cpu"])
    assert sorted(r.rid for r in done) == list(range(12))
    assert all(len(r.out_tokens) == 16 for r in done)
    assert "served 12 requests, 192 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["grok-1-314b", "kimi-k2-1t-a32b"])
def test_launch_serve_moe_smoke_on_the_cpu(arch, capsys):
    """``--arch grok-1-314b`` / ``kimi-k2-1t-a32b --smoke --device cpu``:
    the MoE smoke variants serve the launcher's 12 requests of 16
    tokens."""
    done = tserve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    assert sorted(r.rid for r in done) == list(range(12))
    assert all(len(r.out_tokens) == 16 for r in done)
    assert "served 12 requests, 192 tokens" in capsys.readouterr().out


def test_launch_serve_encdec_raises_the_engine_error():
    """``--arch seamless-m4t-large-v2 --smoke --device cpu``: the
    engine's ``ValueError`` (an enc-dec prefill returns its serve state;
    JAX's launcher fails inside ``admit``)."""
    with pytest.raises(ValueError, match="enc-dec"):
        tserve.main(["--arch", "seamless-m4t-large-v2", "--smoke",
                     "--device", "cpu"])


def test_launch_serve_flags_and_defaults(monkeypatch):
    """The flags and defaults of ``repro.launch.serve``, plus
    ``--device`` (default: the card); without a card the default device
    raises."""
    assert vars(tserve.parser().parse_args([])) == {
        "arch": "granite-3-2b", "smoke": False, "requests": 12, "slots": 4,
        "max_tokens": 16, "max_len": 256, "temperature": 0.8, "seed": 0,
        "device": None}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--smoke"])
