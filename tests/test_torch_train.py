"""The port's training math on the CPU (``models/lm.py``'s ``lm_loss`` and
``chunked_ce_loss``, ``models/encdec.py``'s ``encdec_loss``,
``layers/flash.py``, the two scans' autograd, ``launch/steps.py``), held
against the JAX package at ``smoke_variant`` sizes.

Weights are JAX's init carried over by ``params_from_jax``; tokens,
patches, masks and cotangents come from numpy seeds.  Tolerances: the
fp32 loss within 1e-5 relative of JAX's, every gradient leaf within
1e-4 * max(1, max|g|) of JAX's (``jax.value_and_grad`` of the same
loss, jitted); flash outputs and (dq, dk, dv) within 1e-5 * max(1,
max|.|) of JAX's ``flash_attention`` and its vjp; a scan's gradients
through its autograd Function equal to autograd of its plain version
within 1e-6 * max(1, max|g|); ``make_train_step`` over 3 steps: losses
within 1e-5 relative, the AdamW state within 1e-5 * max(1, max|.|), and
params within half the learning rate: AdamW scales each element's step
to about lr whatever the size of its gradient, so an element whose
gradient is at rounding level may step differently on the two sides
(measured: up to 4.9e-5 at lr 3e-4 after 3 steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import smoke_variant as jsmoke
from repro.launch import steps as jsteps
from repro.layers.flash import flash_attention as jflash
from repro.models.registry import build_model as jbuild
from repro.optim.adamw import adamw_init as jadamw_init
from repro_torch.common.tree import flatten_with_paths
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.convert import params_from_jax
from repro_torch.kernels.relu_attn import ops as relu_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch import steps as tsteps
from repro_torch.layers.flash import flash_attention
from repro_torch.models.registry import build_model

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
FLASH_TOL = 1e-5
CASES = {
    "granite": ("granite-3-2b", {}),
    "granite-flash": ("granite-3-2b", {"flash_vjp": True}),
    "grok": ("grok-1-314b", {}),
    "mamba2": ("mamba2-1.3b", {}),
    "zamba2": ("zamba2-1.2b", {}),
    "zamba2-relu": ("zamba2-1.2b", {"attn_backend": "relu_linear"}),
    "gemma3": ("gemma3-12b", {}),
    "gemma3-flash": ("gemma3-12b", {"flash_vjp": True}),
    "internvl2": ("internvl2-1b", {}),
    "seamless": ("seamless-m4t-large-v2", {}),
}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, ref, tol):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max() if got.size else 0.0
    assert err <= tol * max(1.0, np.abs(ref).max()), (err, np.abs(ref).max())


def jax_leaves(tree) -> dict:
    """JAX tree -> {path string: leaf}, the port's path strings."""
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def batch_for(cfg, seed=0, B=2, S=64):
    """A numpy batch: tokens and targets; vlm: patches and a mask
    (targets read past the patches); enc-dec: frames."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "targets": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        b["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
        b["mask"] = (rng.random((B, S)) > 0.3).astype(np.float32)
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal(
            (B, 48, cfg.d_model)).astype(np.float32)
    return b


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def configs(name):
    arch, kw = CASES[name]
    return jsmoke(JARCHS[arch]).scaled(**kw), smoke_variant(
        get_arch(arch)).scaled(**kw)


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_every_gradient_match_jax(name):
    """``Model.loss`` and its gradient at every param leaf against
    ``jax.value_and_grad(build_model(cfg).loss)``: dense (also with
    ``flash_vjp``), moe (its aux loss added), mamba2, zamba2 with its
    shared block on softmax and on relu_linear (both scan kernels' autograd
    Functions), gemma3 (sliding + global, also with ``flash_vjp``), vlm
    with patches and a mask, and the enc-dec's ``encdec_loss``; every
    block under ``torch.utils.checkpoint`` (remat on, as JAX's)."""
    jc, tc = configs(name)
    assert tc.remat
    jm = jbuild(jc)
    jp = jm.init(jax.random.PRNGKey(0))
    b = batch_for(jc)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(jp, to_jax(b))
    tl, tg = tsteps.value_and_grad(build_model(tc).loss)(port(jp),
                                                         to_torch(b))
    assert tl.dtype == torch.float32
    assert abs(tl.item() - float(jl)) <= LOSS_TOL * abs(float(jl))
    ref = jax_leaves(jg)
    got = dict(flatten_with_paths(tg))
    assert set(got) == set(ref)
    for path, g in ref.items():
        assert got[path].dtype == torch.float32, path
        close(got[path], g, GRAD_TOL)


def test_chunked_ce_loss_chunks_and_mask():
    """``chunked_ce_loss`` equals the plain mean cross-entropy over the
    whole (B, S, V) logits, at a chunk that divides S, one that does not
    (one chunk) and under a mask (mean over the mask's sum)."""
    from repro_torch.models.lm import chunked_ce_loss, lm_logits_head
    _, tc = configs("granite")
    params = build_model(tc).init(0, "cpu")
    g = torch.Generator().manual_seed(1)
    h = torch.randn((2, 96, tc.d_model), generator=g)
    t = torch.randint(0, tc.vocab, (2, 96), generator=g)
    m = (torch.rand((2, 96), generator=g) > 0.5).float()
    logits = lm_logits_head(params, h, tc).float()
    nll = torch.nn.functional.cross_entropy(
        logits.reshape(-1, tc.vocab), t.reshape(-1),
        reduction="none").reshape(2, 96)
    for chunk in (32, 40):
        cfg = tc.scaled(loss_chunk=chunk)
        close(chunked_ce_loss(params, h, t, cfg), nll.mean(), 1e-6)
        close(chunked_ce_loss(params, h, t, cfg, m),
              (nll * m).sum() / m.sum(), 1e-6)


@pytest.mark.parametrize("causal,window,S", [
    (True, None, 96), (False, None, 96), (True, 32, 96), (True, None, 80),
    (True, 24, 80)])
def test_flash_forward_and_vjp_match_jax(causal, window, S):
    """``flash_attention``'s output and (dq, dk, dv) for a random
    cotangent against JAX's ``flash_attention`` and its custom vjp:
    causal, non-causal, windowed, and a ragged S (80: one chunk of 80,
    as JAX's), chunks of 32."""
    rng = np.random.default_rng(S + (window or 0) + causal)
    q, k, v, do = (rng.standard_normal((2, S, 3, 16)).astype(np.float32)
                   for _ in range(4))
    pos = np.arange(S, dtype=np.int32)

    def jf(q, k, v):
        return jflash(q, k, v, jnp.asarray(pos), jnp.asarray(pos), causal,
                      window, 32, 32)

    jout, vjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tpos = torch.from_numpy(pos)
    tout = flash_attention(tq, tk, tv, tpos, tpos, causal, window, 32, 32)
    tgrads = torch.autograd.grad(tout, (tq, tk, tv), torch.from_numpy(do))
    close(tout, jout, FLASH_TOL)
    for a, b in zip(tgrads, jgrads):
        close(a, b, FLASH_TOL)


def test_flash_keeps_dtypes_and_matches_the_softmax_backends():
    """bf16 q, k, v get bf16 gradients; an attention layer with
    ``flash_vjp=True`` gives the softmax and sliding backends' output
    and input gradient (the port's own, fp32)."""
    from repro_torch.layers import attention as ta
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((1, 64, 2, 16), generator=g).bfloat16()
               .requires_grad_() for _ in range(3))
    pos = torch.arange(64)
    out = flash_attention(q, k, v, pos, pos, True, None, 32, 32)
    assert out.dtype == torch.float32
    grads = torch.autograd.grad(out.sum(), (q, k, v))
    assert all(t.dtype == torch.bfloat16 for t in grads)
    for backend in ("softmax", "sliding"):
        cfg = ta.AttnConfig(d_model=32, n_heads=4, n_kv=2, head_dim=16,
                            backend=backend, window=16, q_chunk=16,
                            kv_chunk=16)
        params = ta.init_attention(torch.Generator().manual_seed(4), cfg)
        x = torch.randn((2, 48, 32), generator=g)
        outs = []
        for flash in (False, True):
            c = cfg.__class__(**{**cfg.__dict__, "flash_vjp": flash})
            xi = x.clone().requires_grad_()
            y = ta.attention(params, xi, c)
            (gx,) = torch.autograd.grad((y * y).sum(), xi)
            outs.append((y, gx))
        close(outs[1][0], outs[0][0], FLASH_TOL)
        close(outs[1][1], outs[0][1], FLASH_TOL)


def graph_nodes(t) -> set:
    """The names of every autograd node behind ``t``."""
    seen, todo, names = set(), [t.grad_fn], set()
    while todo:
        f = todo.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        names.add(type(f).__name__)
        todo += [n for n, _ in f.next_functions]
    return names


def _scan_inputs(dtype=torch.float32, S=80):
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn((2, S, 4, 16), generator=g).to(dtype)
               for _ in range(3))
    x = torch.randn((2, S, 4, 8), generator=g).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((2, S, 4), generator=g))
    A = -torch.rand((4,), generator=g) - 0.1
    Bm, Cm = (torch.randn((2, S, 2, 8), generator=g).to(dtype)
              for _ in range(2))
    D = torch.rand((4,), generator=g)
    return (q, k, v), (x, dt, A, Bm, Cm, D)


def _grads(fn, inputs, seed=6):
    xs = [t.clone().requires_grad_() for t in inputs]
    out = fn(*xs)
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(
        seed))
    return out, torch.autograd.grad(out, xs, cot)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_functions_backward_matches_plain_autograd(dtype, monkeypatch):
    """``relu_linear_attention(causal=True)`` and ``ssd_op`` through their
    autograd Functions (``kernels/recompute.py``) against autograd of the
    plain versions (``reference=True``): every input's gradient, in its
    input's dtype; chunk 32 on a ragged 80 tokens.  The kernels are
    replaced by their plain versions with the graph cut (as a launch on
    the card returns a tensor with no ``grad_fn``), so the gradients can
    only come from the Functions' backward."""
    dt_ = getattr(torch, dtype)
    (q, k, v), (x, dt, A, Bm, Cm, D) = _scan_inputs(dt_)
    cut = {}
    for mod, name in ((relu_ops, "relu_attn_causal"),
                      (ssd_ops, "ssd_chunked")):
        kernel = getattr(mod, name)

        def launch(*a, _kernel=kernel, _name=name, **kw):
            cut[_name] = cut.get(_name, 0) + 1
            with torch.no_grad():
                return _kernel(*a, **kw)
        monkeypatch.setattr(mod, name, launch)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    for fn, inputs in (
            (lambda q, k, v, ref=False: relu_ops.relu_linear_attention(
                q, k, v, causal=True, block_n=32, reference=ref),
             (q, k, v)),
            (lambda x, dt, A, Bm, Cm, D, ref=False: ssd_ops.ssd_op(
                x, dt, A, Bm, Cm, chunk=32, D_skip=D, reference=ref),
             (x, dt, A, Bm, Cm, D))):
        out, grads = _grads(fn, inputs)
        assert "_RecomputeGradBackward" in graph_nodes(out)
        rout, rgrads = _grads(lambda *a: fn(*a, ref=True), inputs)
        close(out, rout, 1e-6)
        for t, a, b in zip(inputs, grads, rgrads):
            assert a.dtype == t.dtype
            close(a, b, tol)
    assert cut == {"relu_attn_causal": 1, "ssd_chunked": 1}


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_make_train_step_matches_jax_over_three_steps(grad_accum):
    """``make_train_step`` (value_and_grad, then ``adamw_update``) three
    times on granite's and zamba2's (relu_linear) smoke configs against
    JAX's jitted ``make_train_step``: each step's loss, then every param
    and the optimizer state; ``grad_accum=2`` sums two microbatches'
    fp32 gradients."""
    for name in ("granite", "zamba2-relu"):
        jc, tc = configs(name)
        jm, tm = jbuild(jc), build_model(tc)
        ocfg = jsteps.default_opt_cfg(jc)
        tcfg = tsteps.default_opt_cfg(tc)
        assert ocfg.__dict__ == tcfg.__dict__
        jp = jm.init(jax.random.PRNGKey(1))
        jo = jadamw_init(jp, ocfg)
        tp, to = port(jp), port(jo)
        jstep = jax.jit(jsteps.make_train_step(jm, ocfg,
                                               grad_accum=grad_accum))
        tstep = tsteps.make_train_step(tm, tcfg, grad_accum=grad_accum)
        for i in range(3):
            b = batch_for(jc, seed=10 + i, B=4, S=32)
            jp, jo, jl = jstep(jp, jo, to_jax(b))
            tp, to, tl = tstep(tp, to, to_torch(b))
            assert abs(tl.item() - float(jl)) <= LOSS_TOL * abs(float(jl))
        got = dict(flatten_with_paths(tp))
        for path, leaf in jax_leaves(jp).items():
            err = np.abs(_np(got[path]) - _np(leaf)).max()
            assert err <= 0.5 * tcfg.lr, (path, err)
        got = dict(flatten_with_paths(to))
        for path, leaf in jax_leaves(jo).items():
            close(got[path], leaf, 1e-5)


def test_train_step_launches_each_scan_twice_a_block_under_remat(
        monkeypatch):
    """With ``remat`` each block's forward runs again in the backward, so
    one step calls ``ssd_chunked`` twice per Mamba layer and
    ``relu_attn_causal`` twice per shared-block call (zamba2 smoke: 4
    layers, 2 groups: 8 and 4); without remat once each; serving
    (prefill) once each, with or without remat."""
    calls = {}
    for mod, name in ((relu_ops, "relu_attn_causal"),
                      (ssd_ops, "ssd_chunked")):
        kernel = getattr(mod, name)

        def count(*a, _kernel=kernel, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _kernel(*a, **kw)
        monkeypatch.setattr(mod, name, count)
    _, tc = configs("zamba2-relu")
    b = to_torch(batch_for(tc, B=2, S=32))
    for remat, per in ((True, 2), (False, 1)):
        cfg = tc.scaled(remat=remat)
        model = build_model(cfg)
        params = model.init(0, "cpu")
        calls.clear()
        tsteps.value_and_grad(model.loss)(params, b)
        assert calls == {"ssd_chunked": 4 * per, "relu_attn_causal": 2 * per}
        calls.clear()
        with torch.no_grad():
            model.prefill(params, {"tokens": b["tokens"]})
        assert calls == {"ssd_chunked": 4, "relu_attn_causal": 2}


def test_value_and_grad_leaves_params_untouched():
    """The params keep no grad and no ``requires_grad``; the gradient
    tree has the params' keys and dtypes."""
    _, tc = configs("mamba2")
    model = build_model(tc.scaled(param_dtype="bfloat16"))
    params = model.init(0, "cpu")
    loss, grads = tsteps.value_and_grad(model.loss)(
        params, to_torch(batch_for(tc, B=1, S=32)))
    flat_p = dict(flatten_with_paths(params))
    flat_g = dict(flatten_with_paths(grads))
    assert set(flat_p) == set(flat_g)
    for path, p in flat_p.items():
        assert not p.requires_grad and p.grad is None
        assert flat_g[path].dtype == p.dtype
    assert not loss.requires_grad
